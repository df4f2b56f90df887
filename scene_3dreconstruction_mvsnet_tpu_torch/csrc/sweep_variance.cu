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
// Bound on this card, counted from the shapes: at the inference headline
// (V=5, D=192, 216x288x32, bf16 in and out) the kernel writes 382 M outputs
// (764 MB, 0.23 ms at 3.35 TB/s) and reads 20 MB of features; it does about
// 49 f32 operations per output (4 views x (4 tap FMAs + 3 for the moments),
// then the variance), 18 GFLOP, 0.27 ms at 67 TFLOP/s. The gather is not in
// that count: 4 views x 4 taps x 16 B = 256 B through L1/L2 for every 16 B
// written, from features that fit in the 50 MB L2. Measured on an H100 with
// throwaway probes (PERF.md, section 6), the store alone takes 0.24 ms and
// the coordinates, taps and sums without it take nearly all the rest: the
// per-output instructions and the tap loads bound the kernel, not memory.
// Emit adds one more write of the output's size per source view (0.25 GB per
// view at the training recipe's 192x128x160x32 in bf16).
//
// Design: one thread per (ref pixel, group of 8 channels) walks a chunk of
// depth planes (blockIdx.y; the chunk comes from the wrapper's launch
// geometry), so the work that depends on the pixel alone is done once per
// chunk: the reference group is loaded once, the homography terms sit in
// shared memory, and on the model's paths (C = 32, at most 4 source views)
// lane g of a pixel's 4 lanes keeps source view g's R (x, y, 1) in registers,
// computes only z, the two divides and the normalisation per plane, and hands
// the coordinate to the other three by shuffle. Any other shape takes the
// general build, which recomputes each view's R (x, y, 1) on every plane and
// so takes any number of views. A group is 16 bytes in bf16 and the 4
// threads of a pixel read one contiguous 64-byte pixel, so a warp's taps and
// its stores are contiguous; walking
// planes moves each view's footprint by well under a pixel per plane, so
// consecutive planes' taps hit lines already in L1. The volume and the warps
// are stored with the evict-first hint. What the probes measured decided the
// rest: 80 registers for 3 blocks of 256 threads per SM, and one plane per
// step (two planes' taps in flight need more registers, and the occupancy
// lost costs more than the loads gained). The coordinate arithmetic and the
// bilinear sample live in sweep_coords.cuh, shared with the single-view warp
// and warp-backward kernels; every f32 operation is rounded in the plain
// path's order, so the output equals the plain path's bit for bit. A GPU
// thread can load from any address, so none of the TPU kernel's window
// planning, column-pair packing or row-skip is needed.
//
// Per-pixel planes (kPerPixel; CasMVSNet's stages 2 and 3): depth [D, H, W]
// in place of depth [D], each (plane, pixel) its own depth, read once by the
// thread that walks the pixel's planes (the 4 lanes of a pixel read the same
// value). Only the load of the plane's depth differs; the per-plane
// instantiation is the code it was. No emit: the per-pixel sweep has no
// training path.

#include "sweep_coords.cuh"

namespace {

using sweep::kGroup;

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;  // blocks per SM: caps the registers at 80
constexpr int kShareViews = 4;  // source views whose coordinates a pixel's 4 lanes share

// kShare (C = 32, at most kShareViews source views): the 4 lanes of a pixel
// hold channel groups 0-3, and lane g keeps source view g's ray and computes
// its coordinate on each plane for all four. Otherwise each lane computes
// every view's ray and coordinate on every plane.
template <typename TIn, typename TOut, bool kEmit, bool kShare, bool kPerPixel>
struct Sweep {
  const TIn* features;  // [V, H, W, C]
  const float* hm_s;    // [V-1, 12] in shared memory
  const float* depth;   // [D], or [D, H, W] when kPerPixel
  TOut* out;            // [D, H, W, C]
  TOut* warps;          // [V-1, D, H, W, C] when kEmit
  int nsrc, D, H, W, C, c0;
  int64_t pix;          // y * W + x
  float xf, yf, inv_half_w, inv_half_h;
  float ref[kGroup];
  sweep::Ray ray;       // kShare: this lane's view's ray

  __device__ __forceinline__ void plane(int d) {
    const int64_t plane = static_cast<int64_t>(H) * W;
    const int64_t view_stride = plane * C;
    float dep;
    if constexpr (kPerPixel) {
      dep = __ldg(depth + d * plane + pix);
    } else {
      dep = __ldg(depth + d);
    }
    float s[kGroup], q[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      s[i] = ref[i];
      q[i] = __fmul_rn(ref[i], ref[i]);
    }
    float own_ix = 0.0f, own_iy = 0.0f;  // kShare: this lane's view's coordinate
    if constexpr (kShare) {
      const int g = c0 / kGroup;
      if (g < nsrc) sweep::plane_coord(ray, hm_s + g * 12, dep, inv_half_w, inv_half_h, W, H, own_ix, own_iy);
    }
    const unsigned quad = 0xFu << (threadIdx.x & 28);
    const int views = kShare ? kShareViews : nsrc;
#pragma unroll
    for (int v = 0; v < views; ++v) {
      if (v >= nsrc) break;
      float ix, iy;
      if constexpr (kShare) {
        ix = __shfl_sync(quad, own_ix, v, 4);
        iy = __shfl_sync(quad, own_iy, v, 4);
      } else {
        sweep::sweep_sample_coord(hm_s + v * 12, xf, yf, dep, inv_half_w, inv_half_h, W, H, ix, iy);
      }
      float acc[kGroup];
      sweep::sample_at(features + (v + 1) * view_stride + c0, ix, iy, H, W, C, acc);
      if constexpr (kEmit) {
        sweep::store_group_stream(warps + ((static_cast<int64_t>(v) * D + d) * plane + pix) * C + c0, acc);
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        s[i] = __fadd_rn(s[i], acc[i]);
        q[i] = __fadd_rn(q[i], __fmul_rn(acc[i], acc[i]));
      }
    }
    const float inv_v = 1.0f / static_cast<float>(nsrc + 1);
    float var[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float mean = __fmul_rn(s[i], inv_v);
      var[i] = __fsub_rn(__fmul_rn(q[i], inv_v), __fmul_rn(mean, mean));
    }
    sweep::store_group_stream(out + (d * plane + pix) * C + c0, var);
  }
};

// features [V, H, W, C] (view 0 = reference), homography [V-1, 12] (R
// row-major, then t) of src_proj @ inv(ref_proj), depth [D] (or [D, H, W]
// when kPerPixel) -> out
// [D, H, W, C] and, when kEmit, warps [V-1, D, H, W, C]. Block (x, y): 256
// (pixel, group) threads, planes [y * d_chunk, (y + 1) * d_chunk); dynamic
// shared memory: the (V-1) x 12 homography terms.
template <typename TIn, typename TOut, bool kEmit, bool kShare, bool kPerPixel>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sweep_variance_kernel(const TIn* __restrict__ features, const float* __restrict__ homography,
                      const float* __restrict__ depth, TOut* __restrict__ out, TOut* __restrict__ warps, int V,
                      int D, int H, int W, int C, int d_chunk) {
  extern __shared__ float hm_s[];
  const int nsrc = V - 1;
  for (int i = threadIdx.x; i < nsrc * 12; i += kThreads) hm_s[i] = __ldg(homography + i);
  __syncthreads();

  const int groups = C / kGroup;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(H) * W * groups) return;

  Sweep<TIn, TOut, kEmit, kShare, kPerPixel> k;
  k.features = features;
  k.hm_s = hm_s;
  k.depth = depth;
  k.out = out;
  k.warps = warps;
  k.nsrc = nsrc;
  k.D = D;
  k.H = H;
  k.W = W;
  k.C = C;
  k.c0 = static_cast<int>(idx % groups) * kGroup;
  k.pix = idx / groups;
  k.xf = static_cast<float>(static_cast<int>(k.pix % W));
  k.yf = static_cast<float>(static_cast<int>(k.pix / W));
  k.inv_half_w = sweep::inv_half_extent(W);
  k.inv_half_h = sweep::inv_half_extent(H);
  sweep::load_group(features + k.pix * C + k.c0, k.ref);
  if constexpr (kShare) {
    const int g = k.c0 / kGroup;
    if (g < nsrc) k.ray = sweep::pixel_ray(hm_s + g * 12, k.xf, k.yf);
  }

  const int d1 = min(D, (blockIdx.y + 1) * d_chunk);
  for (int d = blockIdx.y * d_chunk; d < d1; ++d) k.plane(d);
}

template <typename TIn, typename TOut, bool kShare>
int launch(const void* features, const void* homography, const void* depth, void* out, void* warps, int V,
           int D, int H, int W, int C, int d_chunk, int per_pixel, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(H) * W * (C / kGroup);
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>((D + d_chunk - 1) / d_chunk));
  const size_t smem = static_cast<size_t>(V - 1) * 12 * sizeof(float);
  const TIn* f = static_cast<const TIn*>(features);
  const float* hm = static_cast<const float*>(homography);
  const float* dv = static_cast<const float*>(depth);
  TOut* o = static_cast<TOut*>(out);
  TOut* w = static_cast<TOut*>(warps);
  if (per_pixel) {
    if (w != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    sweep_variance_kernel<TIn, TOut, false, kShare, true><<<grid, kThreads, smem, stream>>>(f, hm, dv, o, w, V, D, H,
                                                                                             W, C, d_chunk);
  } else if (w != nullptr) {
    sweep_variance_kernel<TIn, TOut, true, kShare, false><<<grid, kThreads, smem, stream>>>(f, hm, dv, o, w, V, D, H,
                                                                                             W, C, d_chunk);
  } else {
    sweep_variance_kernel<TIn, TOut, false, kShare, false><<<grid, kThreads, smem, stream>>>(f, hm, dv, o, w, V, D,
                                                                                              H, W, C, d_chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// share: the build whose lanes share the coordinates (C = 32, V <= 5);
// otherwise the general build.
template <typename TIn, typename TOut>
int launch_views(const void* features, const void* homography, const void* depth, void* out, void* warps,
                 int V, int D, int H, int W, int C, int d_chunk, int share, int per_pixel, cudaStream_t stream) {
  if (share) {
    return launch<TIn, TOut, true>(features, homography, depth, out, warps, V, D, H, W, C, d_chunk, per_pixel,
                                   stream);
  }
  return launch<TIn, TOut, false>(features, homography, depth, out, warps, V, D, H, W, C, d_chunk, per_pixel,
                                  stream);
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; the caller has
// checked shapes, dtypes, contiguity, 16-byte alignment and C % 8 == 0, and
// sets share only for C = 32 and V <= 5 (launch_geometry in
// ops/kernels/sweep_variance.py). in_bf16 / out_bf16 select bf16 (1) or f32
// (0). warps is null, or a [V-1, D, H, W, C] output in the output dtype that
// receives each source view's samples. d_chunk: planes per block. per_pixel:
// depth is [D, H, W] (one depth per plane and pixel) instead of [D]; it takes
// no warps (cudaErrorInvalidValue). Returns the cudaError_t of the launch (0
// on success).
extern "C" int sweep_variance_launch(const void* features, int in_bf16, const void* homography,
                                     const void* depth, void* out, int out_bf16, void* warps, int V,
                                     int D, int H, int W, int C, int d_chunk, int share, int per_pixel,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return out_bf16 ? launch_views<__nv_bfloat16, __nv_bfloat16>(features, homography, depth, out, warps, V, D, H,
                                                                 W, C, d_chunk, share, per_pixel, s)
                    : launch_views<__nv_bfloat16, float>(features, homography, depth, out, warps, V, D, H, W, C,
                                                         d_chunk, share, per_pixel, s);
  }
  return out_bf16 ? launch_views<float, __nv_bfloat16>(features, homography, depth, out, warps, V, D, H, W, C,
                                                       d_chunk, share, per_pixel, s)
                  : launch_views<float, float>(features, homography, depth, out, warps, V, D, H, W, C, d_chunk, share,
                                               per_pixel, s);
}

extern "C" const char* sweep_variance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
