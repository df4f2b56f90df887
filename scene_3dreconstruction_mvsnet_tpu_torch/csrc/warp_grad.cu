// Gradient of the plane-sweep warp with respect to the source features, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel scene_3dreconstruction_mvsnet_tpu/ops/pallas/
// warp_grad.py::warp_grad_pallas (body _grad_kernel). The warp samples the
// source map [H, W, C] bilinearly at one coordinate per (depth plane d, ref
// pixel y, x); its transpose adds each cotangent g[d, y, x, :] times the tap
// weight into the four source pixels it was sampled from. The coordinates are
// constants: no gradient reaches the cameras or the depth hypotheses.
//
// Bound on this card: at the training recipe (D=192, 128x160x32) one launch
// reads the f32 cotangent once (503 MB, 0.15 ms at 3.35 TB/s) and issues up to
// 4 taps x 2 vector atomics per thread, 126 M red operations, into a 2.6 MB
// accumulator that stays in L2. The atomics are the limit, and they contend:
// the D planes of a reference pixel land on neighbouring source pixels.
//
// Design: one thread per (d, y, x, group of 8 channels), the forward kernel's
// layout, so a warp reads the cotangent contiguously. Each thread recomputes
// its coordinate with sweep_coords.cuh, the same device code the sweep
// kernel gathers with, so both kernels see the same f32 coordinate bit for bit;
// it then adds w * g into the f32 accumulator with 16-byte atomics
// (atomicAdd on float4, Hopper's vector reduction). Taps outside the image add
// nothing. The TPU kernel's inverse-homography gather form, GradPlan window
// planner, pair-parity split and validity flag answer Mosaic's 128-lane
// gather; a GPU thread writes to any address, so none of them is ported.
// f32 atomics make the order of the sums vary from run to run.

#include "sweep_coords.cuh"

namespace {

using sweep::kGroup;

constexpr int kThreads = 256;

// dsrc[yi, xi, group] += w * t where (yi, xi) lies inside the image
__device__ __forceinline__ void scatter_tap(float* dsrc, int H, int W, int C, int xi, int yi, float w,
                                            const float (&t)[kGroup]) {
  if (!sweep::inside(xi, yi, W, H)) return;
  float4* p = reinterpret_cast<float4*>(dsrc + (static_cast<int64_t>(yi) * W + xi) * C);
  atomicAdd(p, make_float4(w * t[0], w * t[1], w * t[2], w * t[3]));
  atomicAdd(p + 1, make_float4(w * t[4], w * t[5], w * t[6], w * t[7]));
}

// g [D, H, W, C] f32 cotangent of one source view's warped volume, homography
// [12] (R row-major, then t) of src_proj @ inv(ref_proj), depth [D]
// -> dsrc [H, W, C] f32, accumulated (the caller zeroes it).
__global__ void __launch_bounds__(kThreads)
warp_grad_kernel(const float* __restrict__ g, const float* __restrict__ homography,
                 const float* __restrict__ depth, float* __restrict__ dsrc, int D, int H, int W, int C) {
  const int groups = C / kGroup;
  const int64_t total = static_cast<int64_t>(D) * H * W * groups;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c0 = static_cast<int>(idx % groups) * kGroup;
  const int64_t pix = idx / groups;  // (d * H + y) * W + x
  const int x = static_cast<int>(pix % W);
  const int y = static_cast<int>((pix / W) % H);
  const int d = static_cast<int>(pix / (static_cast<int64_t>(W) * H));

  float ix, iy;
  sweep::sweep_sample_coord(homography, static_cast<float>(x), static_cast<float>(y), __ldg(depth + d),
                            sweep::inv_half_extent(W), sweep::inv_half_extent(H), W, H, ix, iy);
  sweep::Taps tp;
  if (!sweep::bilinear_taps(ix, iy, W, H, tp)) return;
  float t[kGroup];
  sweep::load_group(g + pix * C + c0, t);
  float* img = dsrc + c0;
  scatter_tap(img, H, W, C, tp.x0, tp.y0, tp.w_nw, t);
  scatter_tap(img, H, W, C, tp.x0 + 1, tp.y0, tp.w_ne, t);
  scatter_tap(img, H, W, C, tp.x0, tp.y0 + 1, tp.w_sw, t);
  scatter_tap(img, H, W, C, tp.x0 + 1, tp.y0 + 1, tp.w_se, t);
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; the caller has
// checked shapes, dtypes, contiguity, 16-byte alignment and C % 8 == 0, and
// zeroed dsrc. Returns the cudaError_t of the launch (0 on success).
extern "C" int warp_grad_launch(const void* g, const void* homography, const void* depth, void* dsrc,
                                int D, int H, int W, int C, void* stream) {
  const int64_t total = static_cast<int64_t>(D) * H * W * (C / kGroup);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  warp_grad_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(homography), static_cast<const float*>(depth),
      static_cast<float*>(dsrc), D, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* warp_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
