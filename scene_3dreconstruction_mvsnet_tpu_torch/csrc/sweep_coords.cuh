// Device code shared by the plane-sweep kernels: the source-view sample
// coordinate of a (depth plane, reference pixel) and its bilinear taps, plus
// the 8-channel vector loads and stores.
//
// The sweep-variance kernel (sweep_variance.cu) and the warp-backward kernel
// (warp_grad.cu) both take their coordinates from sweep_sample_coord, so the
// backward scatters to exactly the taps, with exactly the weights, that the
// forward gathered from.
//
// Arithmetic order: the plain path's sequence of f32 operations
// (ops/plane_sweep.py -> geometry/transforms.py::plane_sweep_coords,
// ops/sampling.py and F.grid_sample) as PyTorch's CUDA ops round them:
// R(x, y, 1) summed left to right, * d + t, the perspective divide, the
// reference's align_corners=True normalisation (PyTorch divides a tensor by a
// scalar as a multiply by the scalar's f32 reciprocal), then grid_sample's
// align_corners=False unnormalisation, whose (g + 1) * W - 1 nvcc contracts
// into one FMA. Each other step is rounded on its own (__f*_rn keeps nvcc
// from contracting them), so the kernels agree with the plain path to the
// last bit of the sample coordinate. The TPU kernels' rearrangement of the
// same coordinate in 1/d rounds differently, and a coordinate one ulp off
// moves a sample by up to |grad f| * 3e-5 px at 288 columns.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sweep {

constexpr int kGroup = 8;  // channels per thread

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

// 1 / ((n - 1) / 2) as the plain path rounds it: the reference's
// align_corners=True normalisation divides by (n - 1) / 2.
__device__ __forceinline__ float inv_half_extent(int n) {
  return __fdiv_rn(1.0f, 0.5f * static_cast<float>(n - 1));
}

// grid_sample's unnormalised source coordinate (ix, iy) of reference pixel
// (xf, yf) on the plane at depth dep. hm: the 12 floats of
// src_proj @ inv(ref_proj), R row-major then t.
__device__ __forceinline__ void sweep_sample_coord(const float* __restrict__ hm, float xf, float yf,
                                                   float dep, float inv_half_w, float inv_half_h,
                                                   int W, int H, float& ix, float& iy) {
  const float rx = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(hm + 0), xf), __fmul_rn(__ldg(hm + 1), yf)), __ldg(hm + 2));
  const float ry = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(hm + 3), xf), __fmul_rn(__ldg(hm + 4), yf)), __ldg(hm + 5));
  const float rz = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(hm + 6), xf), __fmul_rn(__ldg(hm + 7), yf)), __ldg(hm + 8));
  const float z = __fadd_rn(__fmul_rn(rz, dep), __ldg(hm + 11));
  const float px = __fdiv_rn(__fadd_rn(__fmul_rn(rx, dep), __ldg(hm + 9)), z);
  const float py = __fdiv_rn(__fadd_rn(__fmul_rn(ry, dep), __ldg(hm + 10)), z);
  // reference normalisation, then grid_sample's align_corners=False rule
  const float gx = __fsub_rn(__fmul_rn(px, inv_half_w), 1.0f);
  const float gy = __fsub_rn(__fmul_rn(py, inv_half_h), 1.0f);
  ix = 0.5f * __fmaf_rn(__fadd_rn(gx, 1.0f), static_cast<float>(W), -1.0f);
  iy = 0.5f * __fmaf_rn(__fadd_rn(gy, 1.0f), static_cast<float>(H), -1.0f);
}

// The four bilinear taps of (ix, iy): the north-west tap (x0, y0) and
// grid_sample's weights. Taps outside the image are left to the caller,
// which skips them (zeros padding).
struct Taps {
  int x0, y0;
  float w_nw, w_ne, w_sw, w_se;
};

// False when every tap lies outside the image or the coordinate is not
// finite: the sample is 0 and takes no gradient.
__device__ __forceinline__ bool bilinear_taps(float ix, float iy, int W, int H, Taps& t) {
  if (!(ix >= -1.0f && ix < static_cast<float>(W) && iy >= -1.0f && iy < static_cast<float>(H))) {
    return false;
  }
  const float fx0 = floorf(ix);
  const float fy0 = floorf(iy);
  const float fx1 = fx0 + 1.0f;
  const float fy1 = fy0 + 1.0f;
  // grid_sample's weight formulas
  t.w_nw = (fx1 - ix) * (fy1 - iy);
  t.w_ne = (ix - fx0) * (fy1 - iy);
  t.w_sw = (fx1 - ix) * (iy - fy0);
  t.w_se = (ix - fx0) * (iy - fy0);
  t.x0 = static_cast<int>(fx0);
  t.y0 = static_cast<int>(fy0);
  return true;
}

__device__ __forceinline__ bool inside(int xi, int yi, int W, int H) {
  return xi >= 0 && xi < W && yi >= 0 && yi < H;
}

}  // namespace sweep
