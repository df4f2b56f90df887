// BatchNorm3d with the ReLU that follows it, for Hopper (sm_90a): CostRegNet's
// normalisation in eval, in training and in the backward.
//
// Replaces no TPU kernel: the JAX package's BatchNorm was flax's, which XLA
// compiled. It is added because PyTorch's NCDHW BatchNorm kernels give one
// block to each channel (the eval transform a (C, ceil(N / tb)) grid, the
// statistics and the backward one block per channel for a contiguous input),
// so at CostRegNet's 8 to 64 channels and batch 1 to 4 a handful of the
// card's 132 SMs carry the network's largest passes.
//
// Bound on this card: bytes. Per value the transform reads x and writes y,
// the statistics read x, the backward reads x and dy and writes dx (2 bytes
// each in bf16, 4 in f32); a few f32 operations per value.
//
// Design: every pass is one grid over (spatial tile, channel, sample) of the
// contiguous volume [N, C, S = D*H*W]. A block owns kTile consecutive values
// of one (sample, channel) row, kItems a thread, loaded and stored 16 bytes a
// thread where every row starts 16-byte aligned (S * itemsize a multiple of
// 16 and the pointers aligned), one value at a time otherwise; the tile at
// the row's end is masked. The tile count follows from S, so an 8-channel
// full-resolution layer fills every SM and a 64-channel deepest level
// launches no mostly empty blocks. A per-channel reduction takes two launches
// and no float atomics: each block reduces its tile (a butterfly in each
// warp, then the warps in order) into one scratch entry, then one block per
// channel combines the channel's entries in a fixed order, in f64. So a
// launch repeats its bits from run to run. Values are f32 in registers and
// rounded once to the output type.
//
// The passes (the ReLU, where the block has one, is a template argument):
//  - eval (batch_norm_eval_launch): one launch, y = relu(x * scale + shift)
//    with scale = gamma / sqrt(running_var + eps) and shift = beta -
//    running_mean * scale worked out in each block's prologue
//    (ops/kernels/conv0_fused.py::fold_bn's formula);
//  - training (batch_norm_train_launch): each tile's mean and its M2 about
//    that mean (two passes over the tile in registers, so a large mean costs
//    no precision); Chan's combine per channel, which writes mean, invstd,
//    scale and shift and, unless the forward is a recompute, updates the
//    running mean, the running variance with the biased batch variance
//    (flax's rule, momentum 0.1) and num_batches_tracked; then the transform
//    with the batch's scale and shift;
//  - backward (batch_norm_backward_launch): per tile, the sums of g and of
//    g * xhat, where g = dy where the ReLU passed, recomputed as x * scale +
//    shift > 0 from the saved x (the forward's output is not kept); per
//    channel, dgamma = sum g * xhat and dbeta = sum g; then dx = scale * (g -
//    sum g / n - xhat * sum(g * xhat) / n) in training, scale * g in eval.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;               // values of one (sample, channel) row a block owns
constexpr int kItems = kTile / kThreads;  // values a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float& out) { out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16& out) { out = __float2bfloat16_rn(v); }

// kVec values that move as one load or store: 16 bytes, or one value.
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

// Offset in its tile of this thread's pack j: neighbouring threads take
// neighbouring packs. A pack lies wholly inside the tile's n values or wholly
// outside (n is a multiple of kVec).
template <int kVec>
__device__ __forceinline__ int pack_offset(int j) {
  return (j * kThreads + static_cast<int>(threadIdx.x)) * kVec;
}

// This thread's kItems values of the tile at src with n values; 0 outside.
template <typename T, int kVec>
__device__ __forceinline__ void load(const T* __restrict__ src, int n, float (&v)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems / kVec; ++j) {
    const int e = pack_offset<kVec>(j);
    Pack<T, kVec> p;
    if (e < n) {
      p = *reinterpret_cast<const Pack<T, kVec>*>(src + e);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) p.v[k] = T(0.0f);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[j * kVec + k] = to_f32(p.v[k]);
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store(T* __restrict__ dst, int n, const float (&v)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems / kVec; ++j) {
    const int e = pack_offset<kVec>(j);
    if (e < n) {
      Pack<T, kVec> p;
#pragma unroll
      for (int k = 0; k < kVec; ++k) from_f32(v[j * kVec + k], p.v[k]);
      *reinterpret_cast<Pack<T, kVec>*>(dst + e) = p;
    }
  }
}

// Each of s[0..kN) summed over the block, in a fixed order; every thread
// gets the same bits (the butterfly's partners add the same two values).
template <int kN>
__device__ __forceinline__ void block_sum(float (&s)[kN]) {
  __shared__ float warp_sums[kN][kWarps];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
  }
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) warp_sums[i][threadIdx.x / 32] = s[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float t = warp_sums[i][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += warp_sums[i][w];
    s[i] = t;
  }
  __syncthreads();  // warp_sums may be written again by the next call
}

// The block's row (blockIdx.z, blockIdx.y) and the first value and count of
// its tile blockIdx.x.
struct Tile {
  int64_t start;  // of the tile, from the start of the volume
  int n;
};

__device__ __forceinline__ Tile block_tile(int C, int64_t S) {
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  return {(static_cast<int64_t>(blockIdx.z) * C + blockIdx.y) * S + t0,
          static_cast<int>(S - t0 < kTile ? S - t0 : kTile)};
}

// Per-channel coefficients, [4][C]: mean, invstd, scale, shift.
enum { kMean = 0, kInvstd = 1, kScale = 2, kShift = 3 };

// y = relu(x * scale + shift) on the block's tile. kEval: scale and shift
// from the running statistics (written to coef, when given, by one block of
// the channel for the backward); else read from coef (the training
// finalize's).
template <typename T, int kVec, bool kRelu, bool kEval>
__global__ void __launch_bounds__(kThreads)
bn_transform_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ running_mean,
                    const float* __restrict__ running_var, const float* __restrict__ weight,
                    const float* __restrict__ bias, float eps, float* __restrict__ coef, int C, int64_t S) {
  const int c = blockIdx.y;
  float scale, shift;
  if constexpr (kEval) {
    const float invstd = 1.0f / sqrtf(running_var[c] + eps);
    scale = weight[c] * invstd;
    shift = bias[c] - running_mean[c] * scale;
    if (coef != nullptr && blockIdx.x == 0 && blockIdx.z == 0 && threadIdx.x == 0) {
      coef[kMean * C + c] = running_mean[c];
      coef[kInvstd * C + c] = invstd;
      coef[kScale * C + c] = scale;
      coef[kShift * C + c] = shift;
    }
  } else {
    scale = coef[kScale * C + c];
    shift = coef[kShift * C + c];
  }
  const Tile tile = block_tile(C, S);
  float v[kItems];
  load<T, kVec>(x + tile.start, tile.n, v);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const float r = fmaf(v[i], scale, shift);
    v[i] = kRelu && r < 0.0f ? 0.0f : r;
  }
  store<T, kVec>(y + tile.start, tile.n, v);
}

// The tile's mean and M2 about it: part[(c * N + sample) * tiles + tile].
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial_kernel(const T* __restrict__ x, float2* __restrict__ part, int N, int C, int64_t S) {
  const Tile tile = block_tile(C, S);
  float v[kItems];
  load<T, kVec>(x + tile.start, tile.n, v);
  float sum[1] = {0.0f};
#pragma unroll
  for (int i = 0; i < kItems; ++i) sum[0] += v[i];  // the masked values are 0
  block_sum(sum);
  const float mean = sum[0] / tile.n;
  float m2[1] = {0.0f};
#pragma unroll
  for (int j = 0; j < kItems / kVec; ++j) {
    if (pack_offset<kVec>(j) < tile.n) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float d = v[j * kVec + k] - mean;
        m2[0] = fmaf(d, d, m2[0]);
      }
    }
  }
  block_sum(m2);
  if (threadIdx.x == 0) {
    part[(static_cast<int64_t>(blockIdx.y) * N + blockIdx.z) * gridDim.x + blockIdx.x] = make_float2(mean, m2[0]);
  }
}

// (n, mean, M2) of a set of values, then of its union with (nb, mb, qb):
// Chan's parallel formula.
__device__ __forceinline__ void chan_combine(double& n, double& mean, double& m2, double nb, double mb, double qb) {
  if (nb == 0.0) return;
  const double total = n + nb, d = mb - mean;
  mean += d * (nb / total);
  m2 += qb + d * d * (n * nb / total);
  n = total;
}

// One block per channel: the channel's N * tiles entries of part combined in
// f64 (thread i takes entries i, i + kThreads, ... in turn, then a tree over
// the threads); writes the batch's mean, invstd, scale and shift to coef
// and, with update, moves the running statistics (the biased variance) and
// counts the batch.
__global__ void __launch_bounds__(kThreads)
bn_stats_finalize_kernel(const float2* __restrict__ part, int entries, int tiles, int64_t S,
                         const float* __restrict__ weight, const float* __restrict__ bias,
                         float* __restrict__ running_mean, float* __restrict__ running_var,
                         int64_t* __restrict__ num_batches_tracked, float momentum, float eps, int update,
                         float* __restrict__ coef, int C) {
  __shared__ double count[kThreads], mean[kThreads], m2[kThreads];
  const int c = blockIdx.x, i = threadIdx.x;
  double n = 0.0, m = 0.0, q = 0.0;
  for (int e = i; e < entries; e += kThreads) {
    const float2 p = part[static_cast<int64_t>(c) * entries + e];
    const int64_t t0 = static_cast<int64_t>(e % tiles) * kTile;
    chan_combine(n, m, q, static_cast<double>(S - t0 < kTile ? S - t0 : kTile), p.x, p.y);
  }
  count[i] = n;
  mean[i] = m;
  m2[i] = q;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (i < s) chan_combine(count[i], mean[i], m2[i], count[i + s], mean[i + s], m2[i + s]);
    __syncthreads();
  }
  if (i == 0) {
    const double mu = mean[0], var = m2[0] / count[0];
    const double invstd = 1.0 / sqrt(var + static_cast<double>(eps));
    const float scale = static_cast<float>(weight[c] * invstd);
    coef[kMean * C + c] = static_cast<float>(mu);
    coef[kInvstd * C + c] = static_cast<float>(invstd);
    coef[kScale * C + c] = scale;
    coef[kShift * C + c] = static_cast<float>(bias[c] - mu * scale);
    if (update) {
      const double keep = 1.0 - static_cast<double>(momentum);
      running_mean[c] = static_cast<float>(keep * running_mean[c] + momentum * mu);
      running_var[c] = static_cast<float>(keep * running_var[c] + momentum * var);
      if (c == 0) *num_batches_tracked += 1;
    }
  }
}

// The tile's sums of g and g * xhat: part[(c * N + sample) * tiles + tile].
template <typename T, int kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_backward_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ coef,
                           float2* __restrict__ part, int N, int C, int64_t S) {
  const int c = blockIdx.y;
  const float mean = coef[kMean * C + c], invstd = coef[kInvstd * C + c];
  const float scale = coef[kScale * C + c], shift = coef[kShift * C + c];
  const Tile tile = block_tile(C, S);
  float xv[kItems], g[kItems];
  load<T, kVec>(x + tile.start, tile.n, xv);
  load<T, kVec>(dy + tile.start, tile.n, g);
  float s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kItems; ++i) {  // a masked value has g = 0 and adds nothing
    const float gi = kRelu && fmaf(xv[i], scale, shift) <= 0.0f ? 0.0f : g[i];
    s[0] += gi;
    s[1] = fmaf(gi, (xv[i] - mean) * invstd, s[1]);
  }
  block_sum(s);
  if (threadIdx.x == 0) {
    part[(static_cast<int64_t>(c) * N + blockIdx.z) * gridDim.x + blockIdx.x] = make_float2(s[0], s[1]);
  }
}

// One block per channel: the sums over the channel's entries in f64 (the
// finalize's order) -> dbias, dweight, and sum g / n, sum(g * xhat) / n in
// dcoef [2][C].
__global__ void __launch_bounds__(kThreads)
bn_backward_finalize_kernel(const float2* __restrict__ part, int entries, int64_t n, float* __restrict__ dweight,
                            float* __restrict__ dbias, float* __restrict__ dcoef, int C) {
  __shared__ double sg[kThreads], sgx[kThreads];
  const int c = blockIdx.x, i = threadIdx.x;
  double a = 0.0, b = 0.0;
  for (int e = i; e < entries; e += kThreads) {
    const float2 p = part[static_cast<int64_t>(c) * entries + e];
    a += p.x;
    b += p.y;
  }
  sg[i] = a;
  sgx[i] = b;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (i < s) {
      sg[i] += sg[i + s];
      sgx[i] += sgx[i + s];
    }
    __syncthreads();
  }
  if (i == 0) {
    dbias[c] = static_cast<float>(sg[0]);
    dweight[c] = static_cast<float>(sgx[0]);
    dcoef[c] = static_cast<float>(sg[0] / n);
    dcoef[C + c] = static_cast<float>(sgx[0] / n);
  }
}

// dx on the block's tile: scale * (g - sum g / n - xhat * sum(g * xhat) / n)
// with batch statistics (kTrain), scale * g with running ones.
template <typename T, int kVec, bool kRelu, bool kTrain>
__global__ void __launch_bounds__(kThreads)
bn_backward_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ coef,
                      const float* __restrict__ dcoef, T* __restrict__ dx, int C, int64_t S) {
  const int c = blockIdx.y;
  const float mean = coef[kMean * C + c], invstd = coef[kInvstd * C + c];
  const float scale = coef[kScale * C + c], shift = coef[kShift * C + c];
  const float mean_g = kTrain ? dcoef[c] : 0.0f, mean_gx = kTrain ? dcoef[C + c] : 0.0f;
  const Tile tile = block_tile(C, S);
  float xv[kItems], g[kItems];
  if constexpr (kRelu || kTrain) load<T, kVec>(x + tile.start, tile.n, xv);
  load<T, kVec>(dy + tile.start, tile.n, g);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    float gi = g[i];
    if constexpr (kRelu) gi = fmaf(xv[i], scale, shift) <= 0.0f ? 0.0f : gi;
    if constexpr (kTrain) gi = fmaf(-(xv[i] - mean) * invstd, mean_gx, gi - mean_g);
    g[i] = scale * gi;
  }
  store<T, kVec>(dx + tile.start, tile.n, g);
}

dim3 tile_grid(int N, int C, int64_t S) {
  return dim3(static_cast<unsigned>((S + kTile - 1) / kTile), static_cast<unsigned>(C), static_cast<unsigned>(N));
}

template <typename T, int kVec>
int eval_launch(const void* x, void* y, int relu, int N, int C, int64_t S, const void* running_mean,
                const void* running_var, const void* weight, const void* bias, float eps, void* coef,
                cudaStream_t s) {
  auto kernel = relu ? bn_transform_kernel<T, kVec, true, true> : bn_transform_kernel<T, kVec, false, true>;
  kernel<<<tile_grid(N, C, S), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const float*>(running_mean),
      static_cast<const float*>(running_var), static_cast<const float*>(weight), static_cast<const float*>(bias), eps,
      static_cast<float*>(coef), C, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec>
int train_launch(const void* x, void* y, int relu, int N, int C, int64_t S, void* part, const void* weight,
                 const void* bias, void* running_mean, void* running_var, void* num_batches_tracked, float momentum,
                 float eps, int update, void* coef, cudaStream_t s) {
  const dim3 grid = tile_grid(N, C, S);
  bn_stats_partial_kernel<T, kVec><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<float2*>(part),
                                                              N, C, S);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bn_stats_finalize_kernel<<<C, kThreads, 0, s>>>(
      static_cast<const float2*>(part), N * static_cast<int>(grid.x), static_cast<int>(grid.x), S,
      static_cast<const float*>(weight), static_cast<const float*>(bias), static_cast<float*>(running_mean),
      static_cast<float*>(running_var), static_cast<int64_t*>(num_batches_tracked), momentum, eps, update,
      static_cast<float*>(coef), C);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  auto kernel = relu ? bn_transform_kernel<T, kVec, true, false> : bn_transform_kernel<T, kVec, false, false>;
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(y), nullptr, nullptr, nullptr, nullptr,
                                   eps, static_cast<float*>(coef), C, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec>
int backward_launch(const void* x, const void* dy, void* dx, int relu, int train, int N, int C, int64_t S,
                    const void* coef, void* part, void* dweight, void* dbias, void* dcoef, cudaStream_t s) {
  const dim3 grid = tile_grid(N, C, S);
  auto partial = relu ? bn_backward_partial_kernel<T, kVec, true> : bn_backward_partial_kernel<T, kVec, false>;
  partial<<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                    static_cast<const float*>(coef), static_cast<float2*>(part), N, C, S);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bn_backward_finalize_kernel<<<C, kThreads, 0, s>>>(static_cast<const float2*>(part), N * static_cast<int>(grid.x),
                                                     static_cast<int64_t>(N) * S, static_cast<float*>(dweight),
                                                     static_cast<float*>(dbias), static_cast<float*>(dcoef), C);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  auto dx_kernel = relu ? (train ? bn_backward_dx_kernel<T, kVec, true, true>
                               : bn_backward_dx_kernel<T, kVec, true, false>)
                        : (train ? bn_backward_dx_kernel<T, kVec, false, true>
                                 : bn_backward_dx_kernel<T, kVec, false, false>);
  dx_kernel<<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                      static_cast<const float*>(coef), static_cast<const float*>(dcoef),
                                      static_cast<T*>(dx), C, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// FN<element type, values a load>(...): bf16 or f32, 16-byte or one-value loads.
#define BN_DISPATCH(bf16, vec, FN, ...)                                                                    \
  ((bf16) ? ((vec) ? FN<__nv_bfloat16, 8>(__VA_ARGS__) : FN<__nv_bfloat16, 1>(__VA_ARGS__))                  \
          : ((vec) ? FN<float, 4>(__VA_ARGS__) : FN<float, 1>(__VA_ARGS__)))

// Plain C interface for ctypes. Pointers are device pointers; the caller has
// checked that x (and y, dy, dx) are contiguous [N, C, S] of one dtype (bf16
// = 1: bf16, else f32), that the per-channel tensors are f32 [C], and sets
// vec only where S * itemsize is a multiple of 16 and every volume's address
// is 16-byte aligned. Each returns the first failed launch's cudaError_t (0
// on success).

extern "C" int batch_norm_tile() { return kTile; }

// coef: [4][C] f32 receiving mean, invstd, scale, shift, or null. One launch.
extern "C" int batch_norm_eval_launch(const void* x, void* y, int bf16, int vec, int relu, int N, int C, int64_t S,
                                      const void* running_mean, const void* running_var, const void* weight,
                                      const void* bias, float eps, void* coef, void* stream) {
  return BN_DISPATCH(bf16, vec, eval_launch, x, y, relu, N, C, S, running_mean, running_var, weight, bias, eps, coef,
                     static_cast<cudaStream_t>(stream));
}

// part: N * C * tiles float2 of scratch; coef: [4][C] f32, written. Three
// launches: the tiles' statistics, the per-channel combine (with update,
// the running statistics and num_batches_tracked move), the transform.
extern "C" int batch_norm_train_launch(const void* x, void* y, int bf16, int vec, int relu, int N, int C, int64_t S,
                                       void* part, const void* weight, const void* bias, void* running_mean,
                                       void* running_var, void* num_batches_tracked, float momentum, float eps,
                                       int update, void* coef, void* stream) {
  return BN_DISPATCH(bf16, vec, train_launch, x, y, relu, N, C, S, part, weight, bias, running_mean, running_var,
                     num_batches_tracked, momentum, eps, update, coef, static_cast<cudaStream_t>(stream));
}

// coef: the forward's [4][C]; part: N * C * tiles float2 of scratch;
// dweight, dbias: [C] f32, written; dcoef: [2][C] f32 of scratch. train: the
// forward used batch statistics. Three launches: the tiles' sums, the
// per-channel finalize, dx.
extern "C" int batch_norm_backward_launch(const void* x, const void* dy, void* dx, int bf16, int vec, int relu,
                                          int train, int N, int C, int64_t S, const void* coef, void* part,
                                          void* dweight, void* dbias, void* dcoef, void* stream) {
  return BN_DISPATCH(bf16, vec, backward_launch, x, dy, dx, relu, train, N, C, S, coef, part, dweight, dbias, dcoef,
                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* batch_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
