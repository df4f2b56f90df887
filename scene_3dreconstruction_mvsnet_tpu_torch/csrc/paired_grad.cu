// The paired variance sweep's backward terms for Hopper (sm_90a).
//
// Replaces the elementwise volume that XLA fuses in the JAX package's paired
// sweep (scene_3dreconstruction_mvsnet_tpu/ops/paired_sweep.py, bwd): the
// variance Var = E[x^2] - E[x]^2 over V views has, with respect to view v's
// warped value w_v, the cotangent (2/V) g (w_v - mean). For every sample b,
// plane d, ref pixel and channel it computes, in the plain path's roundings,
//
//   g32  = g * (2/V)
//   mean = (ref + sum_v w_v) * (1/V)
//   t_v  = g32 * (w_v - mean)          for each source view v
//   dref = sum_d g32 * (ref - mean)    the reference view's feature gradient
//
// and writes t [B, V-1, D, H, W, C] in f32 (the warp-backward kernel's input)
// and dref [B, H, W, C] once.
//
// Bound on this card: at the training recipe (V=3, D=192, 128x160x32, bf16
// volume) a sample reads 756 MB (g, the two emitted warps, ref) and writes
// 1,009 MB (t in f32, dref), 0.53 ms at 3.35 TB/s; about 6 f32 operations per
// value, far below the memory time. Memory bounds it.
//
// Design: K1's layout, a thread per (ref pixel, group of 8 channels), so the
// warps, ref and t move in 16- and 32-byte vectors and a pixel's 4 lanes touch
// one contiguous run. The reference group stays in registers. The D planes are
// cut into kSlices fixed chunks, one per threadIdx.y, so a block of 64 pixel
// lanes has 4 times the loads in flight and the grid fills the card in many
// small waves; each slice sums dref over its planes in registers, and slice 0
// adds the other slices' partial sums from shared memory in slice order. No
// atomics: dref is the same bit for bit from run to run. The volume's
// cotangent g may come in any strides (the train step hands it over in the
// conv's NCDHW layout, channels DHW apart): with unit channel stride it is
// read as vectors, otherwise channel by channel. Every operation is rounded on
// its own (__f*_rn, so nvcc contracts nothing), in the plain path's order, so
// t equals the plain path's bit for bit when the view sum has two terms
// (V = 3); dref sums over the planes in another order.

#include "sweep_coords.cuh"

namespace {

using sweep::kGroup;

constexpr int kPixelLanes = 64;  // (pixel, group) lanes per block: threadIdx.x
constexpr int kSlices = 4;       // plane chunks per block: threadIdx.y
constexpr int kMinBlocks = 3;    // blocks per SM: caps the registers at 85

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// the group of 8 channels at p, c_stride elements apart; vec: one 16- or
// 32-byte vector (unit stride, aligned)
template <typename T>
__device__ __forceinline__ void load_strided(const T* p, bool vec, int64_t c_stride, float (&v)[kGroup]) {
  if (vec) {
    sweep::load_group(p, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < kGroup; ++i) v[i] = to_float(__ldg(p + i * c_stride));
}

// g: [B, D, H, W, C] at element strides gs; warps [B, V-1, D, H, W, C] and
// features [B, V, H, W, C] contiguous -> t [B, V-1, D, H, W, C] f32, dref
// [B, H, W, C] (sample stride dref_stride, the rest contiguous). Block
// (kPixelLanes, kSlices), grid (pixel blocks, B).
template <typename TG, typename TF, typename TO>
__global__ void __launch_bounds__(kPixelLanes * kSlices, kMinBlocks)
paired_grad_kernel(const TG* __restrict__ g, bool g_vec, int64_t gs_b, int64_t gs_d, int64_t gs_y, int64_t gs_x,
                   int64_t gs_c, const TG* __restrict__ warps, const TF* __restrict__ features, float* __restrict__ t,
                   TO* __restrict__ dref, int64_t dref_stride, int V, int D, int H, int W, int C, float coeff,
                   float inv_v) {
  __shared__ float partial[kSlices - 1][kPixelLanes][kGroup];
  const int b = blockIdx.y;
  const int groups = C / kGroup;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kPixelLanes + threadIdx.x;
  const bool active = idx < plane * groups;
  const int nsrc = V - 1;
  float acc[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) acc[i] = 0.0f;
  int64_t pix = 0;
  int c0 = 0;
  if (active) {
    c0 = static_cast<int>(idx % groups) * kGroup;
    pix = idx / groups;
    const int x = static_cast<int>(pix % W);
    const int y = static_cast<int>(pix / W);
    float ref[kGroup];
    sweep::load_group(features + (static_cast<int64_t>(b) * V * plane + pix) * C + c0, ref);
    const int chunk = (D + kSlices - 1) / kSlices;
    const int d0 = threadIdx.y * chunk;
    const int d1 = min(D, d0 + chunk);
    const TG* g_px = g + b * gs_b + y * gs_y + x * gs_x + c0 * gs_c;
    const TG* w_px = warps + static_cast<int64_t>(b) * nsrc * D * plane * C + pix * C + c0;
    float* t_px = t + static_cast<int64_t>(b) * nsrc * D * plane * C + pix * C + c0;
    for (int d = d0; d < d1; ++d) {
      float g32[kGroup], mean[kGroup], w[kGroup];
      load_strided(g_px + d * gs_d, g_vec, gs_c, g32);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) g32[i] = __fmul_rn(g32[i], coeff);
      // the view sum in view order, then the mean
      sweep::load_group(w_px + static_cast<int64_t>(d) * plane * C, mean);
      for (int v = 1; v < nsrc; ++v) {
        sweep::load_group(w_px + (static_cast<int64_t>(v) * D + d) * plane * C, w);
#pragma unroll
        for (int i = 0; i < kGroup; ++i) mean[i] = __fadd_rn(mean[i], w[i]);
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        mean[i] = __fmul_rn(__fadd_rn(ref[i], mean[i]), inv_v);
        acc[i] = __fadd_rn(acc[i], __fmul_rn(g32[i], __fsub_rn(ref[i], mean[i])));
      }
      for (int v = 0; v < nsrc; ++v) {
        const int64_t off = (static_cast<int64_t>(v) * D + d) * plane * C;
        sweep::load_group(w_px + off, w);  // again: an L1 hit
#pragma unroll
        for (int i = 0; i < kGroup; ++i) w[i] = __fmul_rn(g32[i], __fsub_rn(w[i], mean[i]));
        sweep::store_group_stream(t_px + off, w);
      }
    }
    if (threadIdx.y > 0) {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) partial[threadIdx.y - 1][threadIdx.x][i] = acc[i];
    }
  }
  __syncthreads();
  if (!active || threadIdx.y > 0) return;
  for (int s = 0; s < kSlices - 1; ++s) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) acc[i] = __fadd_rn(acc[i], partial[s][threadIdx.x][i]);
  }
  sweep::store_group(dref + b * dref_stride + pix * C + c0, acc);
}

template <typename TG, typename TF, typename TO>
int launch(const void* g, bool g_vec, const int64_t* gs, const void* warps, const void* features, void* t,
           void* dref, int64_t dref_stride, int B, int V, int D, int H, int W, int C, float coeff, float inv_v,
           cudaStream_t stream) {
  const int64_t lanes = static_cast<int64_t>(H) * W * (C / kGroup);
  const dim3 grid(static_cast<unsigned>((lanes + kPixelLanes - 1) / kPixelLanes), static_cast<unsigned>(B));
  paired_grad_kernel<TG, TF, TO><<<grid, dim3(kPixelLanes, kSlices), 0, stream>>>(
      static_cast<const TG*>(g), g_vec, gs[0], gs[1], gs[2], gs[3], gs[4], static_cast<const TG*>(warps),
      static_cast<const TF*>(features), static_cast<float*>(t), static_cast<TO*>(dref), dref_stride, V, D, H, W, C,
      coeff, inv_v);
  return static_cast<int>(cudaGetLastError());
}

template <typename TG, typename TF>
int launch_out(int dref_bf16, const void* g, bool g_vec, const int64_t* gs, const void* warps, const void* features,
               void* t, void* dref, int64_t dref_stride, int B, int V, int D, int H, int W, int C, float coeff,
               float inv_v, cudaStream_t stream) {
  if (dref_bf16) {
    return launch<TG, TF, __nv_bfloat16>(g, g_vec, gs, warps, features, t, dref, dref_stride, B, V, D, H, W, C,
                                         coeff, inv_v, stream);
  }
  return launch<TG, TF, float>(g, g_vec, gs, warps, features, t, dref, dref_stride, B, V, D, H, W, C, coeff, inv_v,
                               stream);
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; the caller has
// checked shapes, dtypes, contiguity and 16-byte alignment of warps, features,
// t and dref, and C % 8 == 0. gs is a host array of g's 5 strides, in
// elements; g_vec says that g's channels are contiguous and every group
// 16-byte aligned. g and warps share one dtype (vol_bf16), the features have
// theirs (feat_bf16), dref is f32 or bf16 (dref_bf16). coeff = 2/V and inv_v = 1/V as f32. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int paired_grad_launch(const void* g, int g_vec, const int64_t* gs, const void* warps, int vol_bf16,
                                  const void* features, int feat_bf16, void* t, void* dref, int dref_bf16,
                                  int64_t dref_stride, int B, int V, int D, int H, int W, int C, float coeff,
                                  float inv_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = g_vec != 0;
  if (vol_bf16 && feat_bf16) {
    return launch_out<__nv_bfloat16, __nv_bfloat16>(dref_bf16, g, vec, gs, warps, features, t, dref, dref_stride, B,
                                                     V, D, H, W, C, coeff, inv_v, s);
  }
  if (vol_bf16) {
    return launch_out<__nv_bfloat16, float>(dref_bf16, g, vec, gs, warps, features, t, dref, dref_stride, B, V, D, H,
                                            W, C, coeff, inv_v, s);
  }
  if (feat_bf16) {
    return launch_out<float, __nv_bfloat16>(dref_bf16, g, vec, gs, warps, features, t, dref, dref_stride, B, V, D, H,
                                            W, C, coeff, inv_v, s);
  }
  return launch_out<float, float>(dref_bf16, g, vec, gs, warps, features, t, dref, dref_stride, B, V, D, H, W, C,
                                  coeff, inv_v, s);
}

extern "C" const char* paired_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
