// Plane-sweep variance cost volume for Hopper (sm_90a).
//
// Replaces the TPU kernel scene_3dreconstruction_mvsnet_tpu/ops/pallas/
// sweep_variance.py::sweep_variance_pallas (body _sweep_kernel). For every
// output (depth plane d, ref pixel y, x) and every source view it computes the
// homography sample coordinate, takes a zero-padded bilinear sample, and
// accumulates sum and sum of squares in f32 registers. The reference view
// enters unwarped. Only Var = E[x^2] - E[x]^2 is written, so no warped
// per-view volume ever reaches device memory.
//
// Bound on this card: at the headline shape (V=5, D=192, 216x288x32) the
// kernel writes 382 M outputs (764 MB in bf16) and gathers 4 source views x
// 4 taps per output from features that fit in the 50 MB L2 (about 4 MB per
// view in bf16). The write to device memory and the L2/L1 gather traffic are
// the limits; arithmetic is small.
//
// Design: one thread per (d, y, x, group of 8 channels). A group is 16 bytes
// in bf16 (one vector load per tap) and the 4 threads of a pixel read one
// contiguous 64-byte pixel, so a warp's taps and its stores are contiguous.
// A GPU thread can load from any address, so none of the TPU kernel's window
// planning, column-pair packing or row-skip is needed.
//
// Arithmetic order: the kernel evaluates the plain path's sequence of f32
// operations (ops/plane_sweep.py -> geometry/transforms.py::plane_sweep_coords,
// ops/sampling.py and F.grid_sample) as PyTorch's CUDA ops round them:
// R(x, y, 1) summed left to right, * d + t, the perspective divide, the
// reference's align_corners=True normalisation (PyTorch divides a tensor by a
// scalar as a multiply by the scalar's f32 reciprocal), then grid_sample's
// align_corners=False unnormalisation, whose (g + 1) * W - 1 nvcc contracts
// into one FMA. Each other step is rounded on its own (__f*_rn keeps nvcc
// from contracting them), so the kernel agrees with the plain path to the
// last bits of the sample coordinate. The TPU kernel's rearrangement of the
// same coordinate in 1/d (_sample_coord) rounds differently, and a coordinate
// one ulp off moves a sample by up to |grad f| * 3e-5 px at 288 columns.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;  // channels per thread
constexpr int kThreads = 256;

__device__ __forceinline__ void load_group(const float* p, float (&v)[kGroup]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_group(const __nv_bfloat16* p, float (&v)[kGroup]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kGroup / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_group(float* p, const float (&v)[kGroup]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_group(__nv_bfloat16* p, const float (&v)[kGroup]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kGroup / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// acc += w * img[yi, xi, group] where (yi, xi) lies inside the image
template <typename TIn>
__device__ __forceinline__ void add_tap(const TIn* img, int H, int W, int C, int xi, int yi,
                                        float w, float (&acc)[kGroup]) {
  if (xi < 0 || xi >= W || yi < 0 || yi >= H) return;
  float v[kGroup];
  load_group(img + (static_cast<int64_t>(yi) * W + xi) * C, v);
#pragma unroll
  for (int i = 0; i < kGroup; ++i) acc[i] = fmaf(v[i], w, acc[i]);
}

// features [V, H, W, C] (view 0 = reference), homography [V-1, 12] (R row-major,
// then t) of src_proj @ inv(ref_proj), depth [D] -> out [D, H, W, C].
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
sweep_variance_kernel(const TIn* __restrict__ features, const float* __restrict__ homography,
                      const float* __restrict__ depth, TOut* __restrict__ out, int V, int D,
                      int H, int W, int C) {
  const int groups = C / kGroup;
  const int64_t total = static_cast<int64_t>(D) * H * W * groups;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c0 = static_cast<int>(idx % groups) * kGroup;
  const int64_t pix = idx / groups;  // (d * H + y) * W + x
  const int x = static_cast<int>(pix % W);
  const int y = static_cast<int>((pix / W) % H);
  const int d = static_cast<int>(pix / (static_cast<int64_t>(W) * H));

  const int64_t view_stride = static_cast<int64_t>(H) * W * C;
  float s[kGroup], q[kGroup];
  load_group(features + (static_cast<int64_t>(y) * W + x) * C + c0, s);
#pragma unroll
  for (int i = 0; i < kGroup; ++i) q[i] = __fmul_rn(s[i], s[i]);

  const float dep = __ldg(depth + d);
  const float xf = static_cast<float>(x);
  const float yf = static_cast<float>(y);
  const float inv_half_w = __fdiv_rn(1.0f, 0.5f * static_cast<float>(W - 1));
  const float inv_half_h = __fdiv_rn(1.0f, 0.5f * static_cast<float>(H - 1));

  for (int v = 1; v < V; ++v) {
    const float* hm = homography + (v - 1) * 12;
    const float rx = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(hm + 0), xf), __fmul_rn(__ldg(hm + 1), yf)), __ldg(hm + 2));
    const float ry = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(hm + 3), xf), __fmul_rn(__ldg(hm + 4), yf)), __ldg(hm + 5));
    const float rz = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(hm + 6), xf), __fmul_rn(__ldg(hm + 7), yf)), __ldg(hm + 8));
    const float z = __fadd_rn(__fmul_rn(rz, dep), __ldg(hm + 11));
    const float px = __fdiv_rn(__fadd_rn(__fmul_rn(rx, dep), __ldg(hm + 9)), z);
    const float py = __fdiv_rn(__fadd_rn(__fmul_rn(ry, dep), __ldg(hm + 10)), z);
    // reference normalisation, then grid_sample's align_corners=False rule
    const float gx = __fsub_rn(__fmul_rn(px, inv_half_w), 1.0f);
    const float gy = __fsub_rn(__fmul_rn(py, inv_half_h), 1.0f);
    const float ix = 0.5f * __fmaf_rn(__fadd_rn(gx, 1.0f), static_cast<float>(W), -1.0f);
    const float iy = 0.5f * __fmaf_rn(__fadd_rn(gy, 1.0f), static_cast<float>(H), -1.0f);

    float acc[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) acc[i] = 0.0f;
    // every tap lies outside (or the coordinate is not finite): the view adds 0
    if (ix >= -1.0f && ix < static_cast<float>(W) && iy >= -1.0f && iy < static_cast<float>(H)) {
      const float fx0 = floorf(ix);
      const float fy0 = floorf(iy);
      const float fx1 = fx0 + 1.0f;
      const float fy1 = fy0 + 1.0f;
      // grid_sample's weight formulas
      const float w_nw = (fx1 - ix) * (fy1 - iy);
      const float w_ne = (ix - fx0) * (fy1 - iy);
      const float w_sw = (fx1 - ix) * (iy - fy0);
      const float w_se = (ix - fx0) * (iy - fy0);
      const int x0 = static_cast<int>(fx0);
      const int y0 = static_cast<int>(fy0);
      const TIn* img = features + v * view_stride + c0;
      add_tap(img, H, W, C, x0, y0, w_nw, acc);
      add_tap(img, H, W, C, x0 + 1, y0, w_ne, acc);
      add_tap(img, H, W, C, x0, y0 + 1, w_sw, acc);
      add_tap(img, H, W, C, x0 + 1, y0 + 1, w_se, acc);
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      s[i] = __fadd_rn(s[i], acc[i]);
      q[i] = __fadd_rn(q[i], __fmul_rn(acc[i], acc[i]));
    }
  }

  const float inv_v = 1.0f / static_cast<float>(V);
  float var[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const float mean = __fmul_rn(s[i], inv_v);
    var[i] = __fsub_rn(__fmul_rn(q[i], inv_v), __fmul_rn(mean, mean));
  }
  store_group(out + pix * C + c0, var);
}

template <typename TIn, typename TOut>
int launch(const void* features, const void* homography, const void* depth, void* out, int V,
           int D, int H, int W, int C, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(D) * H * W * (C / kGroup);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  sweep_variance_kernel<TIn, TOut><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const TIn*>(features), static_cast<const float*>(homography),
      static_cast<const float*>(depth), static_cast<TOut*>(out), V, D, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; the caller has
// checked shapes, dtypes, contiguity, 16-byte alignment and C % 8 == 0.
// in_bf16 / out_bf16 select bf16 (1) or f32 (0). Returns the cudaError_t of
// the launch (0 on success).
extern "C" int sweep_variance_launch(const void* features, int in_bf16, const void* homography,
                                     const void* depth, void* out, int out_bf16, int V, int D,
                                     int H, int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(features, homography, depth, out, V, D, H, W, C, s)
                    : launch<__nv_bfloat16, float>(features, homography, depth, out, V, D, H, W, C, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(features, homography, depth, out, V, D, H, W, C, s)
                  : launch<float, float>(features, homography, depth, out, V, D, H, W, C, s);
}

extern "C" const char* sweep_variance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
