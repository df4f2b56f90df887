// Fused softmax regression and photometric confidence for Hopper (sm_90a).
//
// Replaces the TPU kernel scene_3dreconstruction_mvsnet_tpu/ops/pallas/
// softmax_regression.py::fused_softmax_regression (body _kernel). Per pixel of
// the logits [B, D, H*W] (bf16 or f32, converted to f32 in registers, as the
// TPU kernel converts each plane): the max over the D planes, e = exp(x - max)
// once per plane, the sum, depth = sum(e * depth_value) / sum, the expected
// plane index sum(e * d) / sum, idx = trunc(clip(index, 0, D - 1)), and
// confidence = the mass e of the planes [idx - 1, idx + 2] inside [0, D) over
// the sum. Outputs depth and confidence [B, H*W] in f32.
//
// Bound on this card: reading the logits once (at the inference headline
// 192 x 62,208 values: 24 MB in bf16, 7.2 us at 3.35 TB/s; 48 MB in f32);
// about 5 f32 operations per value, and no reuse across pixels.
//
// Design: a block stages the [D x 32 pixels] tile of its logits in shared
// memory with cp.async (16-byte copies where the rows are aligned; element
// copies otherwise, e.g. for odd H*W), so the logits cross the memory bus
// once and every copy of the block is in flight together. The headline has
// 62,208 pixels, fewer than a quarter of the card's thread slots, so one
// thread per pixel walking all D planes would leave most of the card idle:
// the 128 threads of a block are 4 slices of D times 32 pixels (a warp is
// the 32 neighbouring pixels of one slice, so its shared-memory reads hit 32
// distinct banks), 1,944 blocks at the headline. Each slice takes the max
// over its planes, the slices' maxima meet in shared memory, then each slice
// sums e, e * depth_value and e * d over its planes; slice 0's threads add
// the 4 slices' sums in slice order and take the window's 4 planes from the
// tile. The order of every sum is fixed by the tile geometry alone, which is
// the same for both input dtypes, so bf16 logits give the same bits as the
// same values in f32. D is not padded. The plain path's order and exp stay:
// the max first, then expf(x - max). The tile and slice counts were chosen by
// measuring on the card (PERF.md, section 6).
//
// Per-pixel planes (kPerPixel; CasMVSNet's stages 2 and 3): depth_values
// [B, D, HW] in place of [B, D], so the expectation reads pixel p's own depth
// of each plane (a warp's 32 pixels read 32 neighbouring floats of a plane).
// Only that load differs; the per-plane instantiation is the code it was.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPixels = 32;  // pixels of a block
constexpr int kSlices = 4;   // slices of D, each walked by one thread per pixel
constexpr int kThreads = kPixels * kSlices;
constexpr int kChunk = 16;   // bytes of one cp.async

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// cost [B, D, HW] with strides (stride_b, stride_d, 1) in elements,
// depth_values [B, D] (kPerPixel: [B, D, HW]) -> depth, conf [B, HW]. Block
// (x, y): pixels [x * kPixels, (x + 1) * kPixels) of sample y; dynamic shared
// memory: the [D, kPixels] tile of T. kVec: the rows of every block start
// 16-byte aligned.
template <typename T, bool kVec, bool kPerPixel>
__global__ void __launch_bounds__(kThreads)
softmax_regression_kernel(const T* __restrict__ cost, int64_t stride_b, int64_t stride_d,
                          const float* __restrict__ depth_values, float* __restrict__ depth,
                          float* __restrict__ conf, int D, int HW) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);  // [D][kPixels]
  __shared__ float part[4][kSlices][kPixels];  // per slice: max, then sum e, e * depth, e * d

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kPixels;
  const int np = min(kPixels, HW - p0);
  const T* src = cost + b * stride_b + p0;
  if constexpr (kVec) {
    constexpr int kPer = kChunk / sizeof(T);
    constexpr int kRow = kPixels / kPer;  // chunks of a row
    for (int i = threadIdx.x; i < D * kRow; i += kThreads) {
      const int d = i / kRow;
      const int c = (i % kRow) * kPer;
      if (c + kPer <= np) {
        cp_async16(tile + d * kPixels + c, src + d * stride_d + c);
      } else {
        for (int j = c; j < np; ++j) tile[d * kPixels + j] = src[d * stride_d + j];
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < D * kPixels; i += kThreads) {
      const int d = i / kPixels;
      const int p = i % kPixels;
      if (p < np) tile[i] = src[d * stride_d + p];
    }
  }
  __syncthreads();

  const int p = threadIdx.x % kPixels;
  const int s = threadIdx.x / kPixels;
  const int per = (D + kSlices - 1) / kSlices;
  const int d0 = min(D, s * per);
  const int d1 = min(D, d0 + per);
  const T* col = tile + p;
  float m = -__int_as_float(0x7f800000);
  for (int d = d0; d < d1; ++d) m = fmaxf(m, to_f32(col[d * kPixels]));
  part[0][s][p] = m;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSlices; ++k) m = fmaxf(m, part[0][k][p]);

  // the plane's depth is dv[d * dv_stride]; a per-pixel thread past the
  // sample's last pixel reads that pixel's (its results are not stored)
  const float* dv;
  int64_t dv_stride;
  if constexpr (kPerPixel) {
    dv = depth_values + static_cast<int64_t>(b) * D * HW + p0 + min(p, np - 1);
    dv_stride = HW;
  } else {
    dv = depth_values + static_cast<int64_t>(b) * D;
    dv_stride = 1;
  }
  float se = 0.0f, sd = 0.0f, si = 0.0f;
  for (int d = d0; d < d1; ++d) {
    const float e = expf(to_f32(col[d * kPixels]) - m);
    se += e;
    sd = fmaf(e, __ldg(dv + d * dv_stride), sd);
    si = fmaf(e, static_cast<float>(d), si);
  }
  part[1][s][p] = se;
  part[2][s][p] = sd;
  part[3][s][p] = si;
  __syncthreads();
  if (s != 0 || p >= np) return;

  float sum = 0.0f, sum_d = 0.0f, sum_i = 0.0f;
#pragma unroll
  for (int k = 0; k < kSlices; ++k) {
    sum += part[1][k][p];
    sum_d += part[2][k][p];
    sum_i += part[3][k][p];
  }
  // truncation of the clipped expected index, as the plain path's .long()
  const int idx = static_cast<int>(fminf(fmaxf(sum_i / sum, 0.0f), static_cast<float>(D - 1)));
  float mass = 0.0f;
  for (int d = max(idx - 1, 0); d <= min(idx + 2, D - 1); ++d) mass += expf(to_f32(col[d * kPixels]) - m);
  const int64_t out = static_cast<int64_t>(b) * HW + p0 + p;
  depth[out] = sum_d / sum;
  conf[out] = mass / sum;
}

template <typename T, bool kVec, bool kPerPixel>
int launch(const void* cost, int64_t stride_b, int64_t stride_d, const void* depth_values, void* depth, void* conf,
           int B, int D, int HW, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(D) * kPixels * sizeof(T);
  if (smem + sizeof(float) * 4 * kSlices * kPixels > 48 * 1024) {  // above the default, on the current device
    const cudaError_t err = cudaFuncSetAttribute(softmax_regression_kernel<T, kVec, kPerPixel>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((HW + kPixels - 1) / kPixels), static_cast<unsigned>(B));
  softmax_regression_kernel<T, kVec, kPerPixel><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(cost), stride_b, stride_d, static_cast<const float*>(depth_values),
      static_cast<float*>(depth), static_cast<float*>(conf), D, HW);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kPerPixel>
int launch_vec(const void* cost, int64_t stride_b, int64_t stride_d, const void* depth_values, void* depth,
               void* conf, int B, int D, int HW, int vec, cudaStream_t stream) {
  return vec ? launch<T, true, kPerPixel>(cost, stride_b, stride_d, depth_values, depth, conf, B, D, HW, stream)
             : launch<T, false, kPerPixel>(cost, stride_b, stride_d, depth_values, depth, conf, B, D, HW, stream);
}

template <typename T>
int launch_planes(const void* cost, int64_t stride_b, int64_t stride_d, const void* depth_values, void* depth,
                  void* conf, int B, int D, int HW, int vec, int per_pixel, cudaStream_t stream) {
  return per_pixel
             ? launch_vec<T, true>(cost, stride_b, stride_d, depth_values, depth, conf, B, D, HW, vec, stream)
             : launch_vec<T, false>(cost, stride_b, stride_d, depth_values, depth, conf, B, D, HW, vec, stream);
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; the caller has
// checked shapes and dtypes, that the pixels of a plane are contiguous
// (stride 1 over H*W), that D * kPixels (32) * sizeof(element) bytes fit in a
// block's shared memory (MAX_PLANES in ops/kernels/softmax_regression.py), and sets
// vec only where the logits' address and both strides are multiples of 16
// bytes. bf16 selects bf16 (1) or f32 (0) logits; per_pixel, depth_values
// [B, D, HW] (contiguous) in place of [B, D]. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int softmax_regression_launch(const void* cost, int bf16, int64_t stride_b, int64_t stride_d,
                                         const void* depth_values, void* depth, void* conf, int B, int D, int HW,
                                         int vec, int per_pixel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_planes<__nv_bfloat16>(cost, stride_b, stride_d, depth_values, depth, conf, B, D, HW, vec,
                                             per_pixel, s)
              : launch_planes<float>(cost, stride_b, stride_d, depth_values, depth, conf, B, D, HW, vec, per_pixel,
                                     s);
}

extern "C" const char* softmax_regression_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
