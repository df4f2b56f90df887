// Plane-sweep variance cost volume for Hopper (sm_90a).
//
// Replaces the TPU kernel scene_3dreconstruction_mvsnet_tpu/ops/pallas/
// sweep_variance.py::sweep_variance_pallas (body _sweep_kernel). For every
// output (depth plane d, ref pixel y, x) and every source view it computes the
// homography sample coordinate, takes a zero-padded bilinear sample, and
// accumulates sum and sum of squares in f32 registers. The reference view
// enters unwarped. Without emit only Var = E[x^2] - E[x]^2 is written, so no
// warped per-view volume reaches device memory; with emit (the training
// forward, the TPU kernel's emit_warps=True) each source view's sample, which
// the thread already holds in registers, is also stored to a second output
// [V-1, D, H, W, C] in the output dtype, for the backward's (w_v - mean).
//
// Bound on this card: at the headline shape (V=5, D=192, 216x288x32) the
// kernel writes 382 M outputs (764 MB in bf16) and gathers 4 source views x
// 4 taps per output from features that fit in the 50 MB L2 (about 4 MB per
// view in bf16). The write to device memory and the L2/L1 gather traffic are
// the limits; arithmetic is small. Emit adds one more write of the output's
// size per source view (0.25 GB per view at the training recipe's
// 192x128x160x32 in bf16).
//
// Design: one thread per (d, y, x, group of 8 channels). A group is 16 bytes
// in bf16 (one vector load per tap) and the 4 threads of a pixel read one
// contiguous 64-byte pixel, so a warp's taps and its stores are contiguous.
// A GPU thread can load from any address, so none of the TPU kernel's window
// planning, column-pair packing or row-skip is needed. The coordinate
// arithmetic lives in sweep_coords.cuh, shared with the warp-backward kernel.

#include "sweep_coords.cuh"

namespace {

using sweep::kGroup;

constexpr int kThreads = 256;

// acc += w * img[yi, xi, group] where (yi, xi) lies inside the image
template <typename TIn>
__device__ __forceinline__ void add_tap(const TIn* img, int H, int W, int C, int xi, int yi,
                                        float w, float (&acc)[kGroup]) {
  if (!sweep::inside(xi, yi, W, H)) return;
  float v[kGroup];
  sweep::load_group(img + (static_cast<int64_t>(yi) * W + xi) * C, v);
#pragma unroll
  for (int i = 0; i < kGroup; ++i) acc[i] = fmaf(v[i], w, acc[i]);
}

// features [V, H, W, C] (view 0 = reference), homography [V-1, 12] (R row-major,
// then t) of src_proj @ inv(ref_proj), depth [D] -> out [D, H, W, C] and, when
// kEmit, warps [V-1, D, H, W, C].
template <typename TIn, typename TOut, bool kEmit>
__global__ void __launch_bounds__(kThreads)
sweep_variance_kernel(const TIn* __restrict__ features, const float* __restrict__ homography,
                      const float* __restrict__ depth, TOut* __restrict__ out,
                      TOut* __restrict__ warps, int V, int D, int H, int W, int C) {
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
  sweep::load_group(features + (static_cast<int64_t>(y) * W + x) * C + c0, s);
#pragma unroll
  for (int i = 0; i < kGroup; ++i) q[i] = __fmul_rn(s[i], s[i]);

  const float dep = __ldg(depth + d);
  const float inv_half_w = sweep::inv_half_extent(W);
  const float inv_half_h = sweep::inv_half_extent(H);

  for (int v = 1; v < V; ++v) {
    float ix, iy;
    sweep::sweep_sample_coord(homography + (v - 1) * 12, static_cast<float>(x), static_cast<float>(y),
                              dep, inv_half_w, inv_half_h, W, H, ix, iy);
    float acc[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) acc[i] = 0.0f;
    sweep::Taps t;
    if (sweep::bilinear_taps(ix, iy, W, H, t)) {
      const TIn* img = features + v * view_stride + c0;
      add_tap(img, H, W, C, t.x0, t.y0, t.w_nw, acc);
      add_tap(img, H, W, C, t.x0 + 1, t.y0, t.w_ne, acc);
      add_tap(img, H, W, C, t.x0, t.y0 + 1, t.w_sw, acc);
      add_tap(img, H, W, C, t.x0 + 1, t.y0 + 1, t.w_se, acc);
    }
    if constexpr (kEmit) {
      sweep::store_group(warps + ((v - 1) * static_cast<int64_t>(D) * H * W + pix) * C + c0, acc);
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
  sweep::store_group(out + pix * C + c0, var);
}

template <typename TIn, typename TOut>
int launch(const void* features, const void* homography, const void* depth, void* out, void* warps,
           int V, int D, int H, int W, int C, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(D) * H * W * (C / kGroup);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const TIn* f = static_cast<const TIn*>(features);
  const float* hm = static_cast<const float*>(homography);
  const float* dv = static_cast<const float*>(depth);
  TOut* o = static_cast<TOut*>(out);
  TOut* w = static_cast<TOut*>(warps);
  if (w != nullptr) {
    sweep_variance_kernel<TIn, TOut, true><<<blocks, kThreads, 0, stream>>>(f, hm, dv, o, w, V, D, H, W, C);
  } else {
    sweep_variance_kernel<TIn, TOut, false><<<blocks, kThreads, 0, stream>>>(f, hm, dv, o, w, V, D, H, W, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; the caller has
// checked shapes, dtypes, contiguity, 16-byte alignment and C % 8 == 0.
// in_bf16 / out_bf16 select bf16 (1) or f32 (0). warps is null, or a
// [V-1, D, H, W, C] output in the output dtype that receives each source
// view's samples. Returns the cudaError_t of the launch (0 on success).
extern "C" int sweep_variance_launch(const void* features, int in_bf16, const void* homography,
                                     const void* depth, void* out, int out_bf16, void* warps, int V,
                                     int D, int H, int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return out_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(features, homography, depth, out, warps, V, D, H, W, C, s)
        : launch<__nv_bfloat16, float>(features, homography, depth, out, warps, V, D, H, W, C, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(features, homography, depth, out, warps, V, D, H, W, C, s)
                  : launch<float, float>(features, homography, depth, out, warps, V, D, H, W, C, s);
}

extern "C" const char* sweep_variance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
