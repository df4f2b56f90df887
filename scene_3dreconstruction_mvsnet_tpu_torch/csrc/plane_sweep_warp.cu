// Single-view plane-sweep homography warp for Hopper (sm_90a).
//
// Replaces the TPU kernel scene_3dreconstruction_mvsnet_tpu/ops/pallas/
// plane_sweep_warp.py::warp_src_feature_pallas (body _warp_kernel): one source
// view's feature map [H, W, C] sampled at the homography coordinate of every
// (depth plane d, reference pixel y, x), bilinearly with zeros padding, into
// the warped volume [D, H, W, C] in the feature dtype (samples in f32).
//
// Bound on this card: at the inference headline (D=192, 216x288x32) one launch
// writes 382 M samples (764 MB in bf16, 0.23 ms at 3.35 TB/s) and gathers 4
// taps per sample from a 4 MB source map that stays in L2; the write and the
// per-sample instructions and tap loads are the limits, as in the
// sweep-variance kernel's emit mode, which writes the same kind of volume.
//
// Design: the sweep-variance kernel's plane-walking layout. One thread per
// (ref pixel, group of 8 channels) walks a chunk of depth planes (blockIdx.y;
// the chunk comes from the wrapper's launch geometry), so loads and stores are
// 16 bytes and contiguous across a warp, and what depends on the pixel alone
// is done once per chunk: the pixel's index in 32-bit arithmetic and its ray
// R (x, y, 1), kept in registers. Per plane only the plane's part of the
// coordinate runs (z, the two divides, the normalisations). With C = 32 the 4
// lanes of a pixel split that work: in each step of 4 planes lane g computes
// plane d + g's coordinate and hands it to the other three by shuffle, so
// each divide runs once per (pixel, plane). Any other C takes the general
// build, in which each lane computes every plane's coordinate itself. Walking
// planes moves the footprint by well under a pixel per plane, so consecutive
// planes' taps hit lines already in L1. The volume is stored with the
// evict-first hint, so it does not push the source map out of L2. Every
// coordinate and weight comes from sweep_coords.cuh (pixel_ray, plane_coord,
// sample_at), which keeps the plain path's roundings, so this kernel's volume
// equals the plain warp and the sweep-variance kernel's emitted warps of the
// same view bit for bit. The TPU kernel's window planner, patch DMA and
// validity flag answer Mosaic's 128-lane gather; a GPU thread loads from any
// address, so the kernel returns the volume only.

#include "sweep_coords.cuh"

namespace {

using sweep::kGroup;

constexpr int kThreads = 256;
// Measured on the card (PERF.md, section 6): ptxas gives the kernel 48-56
// registers and no spills without a cap, so a cap of 64 does not bind; caps
// of 40 and 32 spill and run 4-7 % slower, and two planes per lane per step,
// or other plane chunks, move it by under 2 %.
constexpr int kMinBlocks = 4;  // blocks per SM: caps the registers at 64
constexpr int kLanes = 4;      // lanes of a pixel that share the coordinates (C = 32)

// src [H, W, C], homography [12] (R row-major, then t) of src_proj @
// inv(ref_proj), depth [D] -> out [D, H, W, C] in the source dtype. Block
// (x, y): 256 (pixel, group) threads, planes [y * d_chunk, (y + 1) * d_chunk).
template <typename T, bool kShare>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
plane_sweep_warp_kernel(const T* __restrict__ src, const float* __restrict__ homography,
                        const float* __restrict__ depth, T* __restrict__ out, int D, int H, int W, int C,
                        int d_chunk) {
  __shared__ float hm_s[12];
  if (threadIdx.x < 12) hm_s[threadIdx.x] = __ldg(homography + threadIdx.x);
  __syncthreads();

  const int groups = C / kGroup;
  const int plane = H * W;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  // kShare: groups == 4 and kThreads % 4 == 0, so a pixel's 4 lanes leave together
  if (idx >= plane * groups) return;
  const int c0 = (idx % groups) * kGroup;
  const int pix = idx / groups;  // y * W + x
  const sweep::Ray ray = sweep::pixel_ray(hm_s, static_cast<float>(pix % W), static_cast<float>(pix / W));
  const float inv_half_w = sweep::inv_half_extent(W);
  const float inv_half_h = sweep::inv_half_extent(H);
  const T* img = src + c0;
  const int d0 = blockIdx.y * d_chunk;
  const int d1 = min(D, d0 + d_chunk);
  T* o = out + (static_cast<int64_t>(d0) * plane + pix) * C + c0;
  const int64_t o_step = static_cast<int64_t>(plane) * C;

  if constexpr (kShare) {
    const unsigned quad = 0xFu << (threadIdx.x & 28);
    const int g = threadIdx.x & (kLanes - 1);
    for (int d = d0; d < d1; d += kLanes) {
      float own_ix = 0.0f, own_iy = 0.0f;  // plane d + g
      if (d + g < d1) {
        sweep::plane_coord(ray, hm_s, __ldg(depth + d + g), inv_half_w, inv_half_h, W, H, own_ix, own_iy);
      }
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        const float ix = __shfl_sync(quad, own_ix, k, kLanes);
        const float iy = __shfl_sync(quad, own_iy, k, kLanes);
        if (d + k < d1) {
          float acc[kGroup];
          sweep::sample_at(img, ix, iy, H, W, C, acc);
          sweep::store_group_stream(o, acc);
          o += o_step;
        }
      }
    }
  } else {
    for (int d = d0; d < d1; ++d, o += o_step) {
      float ix, iy;
      sweep::plane_coord(ray, hm_s, __ldg(depth + d), inv_half_w, inv_half_h, W, H, ix, iy);
      float acc[kGroup];
      sweep::sample_at(img, ix, iy, H, W, C, acc);
      sweep::store_group_stream(o, acc);
    }
  }
}

template <typename T>
int launch(const void* src, const void* homography, const void* depth, void* out, int D, int H, int W, int C,
           int d_chunk, cudaStream_t stream) {
  const int threads = H * W * (C / kGroup);
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>((D + d_chunk - 1) / d_chunk));
  const T* s = static_cast<const T*>(src);
  const float* hm = static_cast<const float*>(homography);
  const float* dv = static_cast<const float*>(depth);
  T* o = static_cast<T*>(out);
  if (C == kLanes * kGroup) {
    plane_sweep_warp_kernel<T, true><<<grid, kThreads, 0, stream>>>(s, hm, dv, o, D, H, W, C, d_chunk);
  } else {
    plane_sweep_warp_kernel<T, false><<<grid, kThreads, 0, stream>>>(s, hm, dv, o, D, H, W, C, d_chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; the caller has
// checked shapes, dtypes, contiguity, 16-byte alignment, C % 8 == 0 and
// H * W * C < 2^31 (launch_geometry in ops/kernels/plane_sweep_warp.py). bf16
// selects bf16 (1) or f32 (0) for both the source and the output. d_chunk:
// planes per block. C = 32 takes the build whose lanes share the coordinates.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int plane_sweep_warp_launch(const void* src, int bf16, const void* homography, const void* depth,
                                       void* out, int D, int H, int W, int C, int d_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(src, homography, depth, out, D, H, W, C, d_chunk, s)
              : launch<float>(src, homography, depth, out, D, H, W, C, d_chunk, s);
}

extern "C" const char* plane_sweep_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
