// BatchNorm3d with the ReLU that follows it, for Hopper (sm_90a): CostRegNet's
// normalisation in eval, in training and in the backward, on NDHWC volumes.
//
// Replaces no TPU kernel: the JAX package's BatchNorm was flax's, which XLA
// compiled. It is added because PyTorch's BatchNorm kernels give one block to
// each channel (the eval transform a (C, ceil(N / tb)) grid, the statistics
// and the backward one block per channel for a contiguous input), so at
// CostRegNet's 8 to 64 channels and batch 1 to 4 a handful of the card's 132
// SMs carry the network's largest passes.
//
// Bound on this card: bytes. Per value the transform reads x and writes y,
// the statistics read x, the backward reads x and dy and writes dx (2 bytes
// each in bf16, 4 in f32); a few f32 operations per value.
//
// Layout: the volume is [V = N*D*H*W voxels][C channels], channels innermost
// (torch.channels_last_3d), the layout cuDNN's NHWC engines write. A voxel's
// C values are C / kVec packs of kVec channels, each pack one 16-byte load or
// store (8 bf16 or 4 f32 channels) where C * itemsize is a multiple of 16 and
// the volumes are 16-byte aligned, one value otherwise.
//
// Design: every pass is one grid over chunks of voxels with all C channels. A
// block's threads form rows of Gp lanes, Gp the packs of a voxel rounded up to
// a power of two (lanes past the packs idle): lane g of a row owns channels
// g * kVec .. g * kVec + kVec - 1 and row r voxels r, r + rows, ... of the
// chunk, kItems values a thread (a chunk holds 4096 values where Gp = C /
// kVec), so a warp reads whole voxels at consecutive addresses and a thread's
// channels, and with them its scale and shift, stay in registers. A transform
// gives each chunk a block, so an 8-channel full-resolution layer fills every
// SM and a 64-channel deepest level launches no mostly empty blocks; a
// reduction launches about as many blocks as the card holds at once (the
// wrapper's `blocks`), block b taking chunks b, b + blocks, ... and summing
// them as they arrive. A thread loads its channels' coefficients with 16-byte
// loads (the eval pass works them out once a block, into shared memory). A
// per-channel reduction takes two launches and no float atomics: each block
// reduces its sums over the threads of each channel in a fixed order
// (lane_sum) into one scratch entry per channel, then one block per channel
// combines the channel's entries in a fixed order, in f64. So a launch
// repeats its bits from run to run on one card. Values are f32 in registers
// and rounded once to the output type.
//
// The passes (the ReLU, where the block has one, is a template argument):
//  - eval (batch_norm_eval_launch): one launch, y = relu(x * scale + shift)
//    with scale = gamma / sqrt(running_var + eps) and shift = beta -
//    running_mean * scale worked out once a block
//    (ops/kernels/conv0_fused.py::fold_bn's formula);
//  - training (batch_norm_train_launch): each reduction block's per-channel
//    mean and its M2 about that mean (one pass over the values shifted by the
//    block's first voxel, so a large mean costs no precision); Chan's combine
//    per channel, which writes mean, invstd, scale and shift and, unless the
//    forward is a recompute, updates the running mean, the running variance
//    with the biased batch variance (flax's rule, momentum 0.1) and
//    num_batches_tracked; then the transform with the batch's scale and
//    shift;
//  - backward (batch_norm_backward_launch): per reduction block, the sums of
//    g and of g * xhat per channel, where g = dy where the ReLU passed,
//    recomputed as x * scale + shift > 0 from the saved x (the forward's
//    output is not kept); per channel, dgamma = sum g * xhat and dbeta = sum
//    g; then dx = scale * (g - sum g / n - xhat * sum(g * xhat) / n) in
//    training, scale * g in eval.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                // values a thread in a chunk
constexpr int kTile = kItems * kThreads;  // values a chunk holds where Gp = C / kVec
constexpr int kFinalThreads = 1024;       // a finalize block's threads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float& out) { out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16& out) { out = __float2bfloat16_rn(v); }

// kVec channels of one voxel that move as one load or store: 16 bytes, or one value.
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

// The block's shape over a chunk: rows of gp lanes (gp a power of two, at
// most kThreads), lane g owning pack g of a voxel (active where g < packs),
// row r the chunk's voxels r + j * rows, j < kItems / vec.
struct Lanes {
  int packs, gp, rows, g, r;
  int64_t chunk_voxels;

  __device__ __forceinline__ Lanes(int C, int vec, int gp_) {
    packs = C / vec;
    gp = gp_;
    rows = kThreads / gp;
    g = static_cast<int>(threadIdx.x) % gp;
    r = static_cast<int>(threadIdx.x) / gp;
    chunk_voxels = static_cast<int64_t>(kItems / vec) * rows;
  }
  __device__ __forceinline__ bool active() const { return g < packs; }
};

// A chunk's first voxel and its voxel count (the last chunk is ragged).
struct Tile {
  int64_t start;
  int n;
};

__device__ __forceinline__ Tile chunk_tile(int64_t chunk, int64_t V, int64_t chunk_voxels) {
  const int64_t v0 = chunk * chunk_voxels;
  return {v0, static_cast<int>(V - v0 < chunk_voxels ? V - v0 : chunk_voxels)};
}

// This thread's kN values of the tile (pack j: voxel r + j * rows of it,
// channels g * kVec ..); 0 past the tile's end and on an idle lane.
template <typename T, int kVec, int kN>
__device__ __forceinline__ void load(const T* __restrict__ src, const Lanes& l, const Tile& t, int C,
                                     float (&v)[kN]) {
#pragma unroll
  for (int j = 0; j < kN / kVec; ++j) {
    const int voxel = l.r + j * l.rows;
    Pack<T, kVec> p;
    if (l.active() && voxel < t.n) {
      p = *reinterpret_cast<const Pack<T, kVec>*>(src + (t.start + voxel) * C + l.g * kVec);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) p.v[k] = T(0.0f);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[j * kVec + k] = to_f32(p.v[k]);
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store(T* __restrict__ dst, const Lanes& l, const Tile& t, int C,
                                      const float (&v)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems / kVec; ++j) {
    const int voxel = l.r + j * l.rows;
    if (l.active() && voxel < t.n) {
      Pack<T, kVec> p;
#pragma unroll
      for (int k = 0; k < kVec; ++k) from_f32(v[j * kVec + k], p.v[k]);
      *reinterpret_cast<Pack<T, kVec>*>(dst + (t.start + voxel) * C + l.g * kVec) = p;
    }
  }
}

// Each of s[0..kN) summed over the block's threads of lane g, in a fixed
// order; the lane's sums end in its first row's thread (r == 0) and, with
// kBroadcast, in every thread of the lane. Where a voxel takes at most 4
// lanes (CostRegNet's 8 to 32 bf16 channels) every row is in shared memory
// and warp w adds the columns (lane, sum) w, w + kWarps, ...: its lanes a
// share of the rows each, then a butterfly. Above that a butterfly over each
// warp's threads of a lane (offsets gp .. 16), then the lane's representatives
// (thread k * stride + g, stride = max(gp, 32)) in turn, added by thread g.
template <bool kBroadcast, int kN>
__device__ __forceinline__ void lane_sum(float (&s)[kN], const Lanes& l) {
  constexpr int kWarps = kThreads / 32, kColumnLanes = 4;
  __shared__ float part[kThreads][kN | 1];  // an odd row pitch: the threads' writes fall on distinct banks
  __shared__ float total[kColumnLanes][kN];
  if (l.gp <= kColumnLanes) {
#pragma unroll
    for (int i = 0; i < kN; ++i) part[threadIdx.x][i] = s[i];
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int col = warp; col < l.gp * kN; col += kWarps) {
      const int g = col / kN, i = col - g * kN;
      float t = 0.0f;
      for (int r = lane; r < l.rows; r += 32) t += part[r * l.gp + g][i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (lane == 0) total[g][i] = t;
    }
    __syncthreads();
    if (kBroadcast || l.r == 0) {
#pragma unroll
      for (int i = 0; i < kN; ++i) s[i] = total[l.g][i];
    }
    __syncthreads();  // part and total may be written again by the next call
    return;
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    for (int o = l.gp; o < 32; o <<= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
    part[threadIdx.x][i] = s[i];
  }
  __syncthreads();
  const int stride = l.gp < 32 ? 32 : l.gp;
  if (l.r == 0) {  // thread g: rows k * stride + g are read by it alone, so its own row takes the total
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      float t = s[i];
      for (int k = 1; k < kThreads / stride; ++k) t += part[k * stride + l.g][i];
      s[i] = t;
      if (kBroadcast) part[l.g][i] = t;
    }
  }
  __syncthreads();  // part may be written again by the next call
  if (kBroadcast) {
#pragma unroll
    for (int i = 0; i < kN; ++i) s[i] = part[l.g][i];
    __syncthreads();
  }
}

// kVec consecutive floats at p (16-byte loads where kVec is a multiple of 4:
// p is then 16-byte aligned).
template <int kVec>
__device__ __forceinline__ void load_floats(const float* p, float (&out)[kVec]) {
  if constexpr (kVec % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(p + 4 * j);
      out[4 * j] = v.x;
      out[4 * j + 1] = v.y;
      out[4 * j + 2] = v.z;
      out[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) out[k] = p[k];
  }
}

// Per-channel coefficients, [4][C]: mean, invstd, scale, shift.
enum { kMean = 0, kInvstd = 1, kScale = 2, kShift = 3 };

// y = relu(x * scale + shift) on the block's tile. kEval: scale and shift
// from the running statistics, worked out once a block per channel into
// shared memory (and written to coef, when given, by block 0 for the
// backward); else read from coef (the training finalize's).
template <typename T, int kVec, bool kRelu, bool kEval>
__global__ void __launch_bounds__(kThreads)
bn_transform_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ running_mean,
                    const float* __restrict__ running_var, const float* __restrict__ weight,
                    const float* __restrict__ bias, float eps, float* __restrict__ coef, int C, int gp, int64_t V) {
  extern __shared__ __align__(16) float table[];  // kEval: [2][C], scale then shift
  const Lanes l(C, kVec, gp);
  float scale[kVec], shift[kVec];
  if constexpr (kEval) {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float invstd = 1.0f / sqrtf(running_var[c] + eps);
      const float sc = weight[c] * invstd, sh = bias[c] - running_mean[c] * sc;
      table[c] = sc;
      table[C + c] = sh;
      if (coef != nullptr && blockIdx.x == 0) {
        coef[kMean * C + c] = running_mean[c];
        coef[kInvstd * C + c] = invstd;
        coef[kScale * C + c] = sc;
        coef[kShift * C + c] = sh;
      }
    }
    __syncthreads();
    if (!l.active()) return;
    load_floats<kVec>(table + l.g * kVec, scale);
    load_floats<kVec>(table + C + l.g * kVec, shift);
  } else {
    if (!l.active()) return;
    load_floats<kVec>(coef + kScale * C + l.g * kVec, scale);
    load_floats<kVec>(coef + kShift * C + l.g * kVec, shift);
  }
  const Tile t = chunk_tile(blockIdx.x, V, l.chunk_voxels);
  float v[kItems];
  load<T, kVec>(x, l, t, C, v);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const float r = fmaf(v[i], scale[i % kVec], shift[i % kVec]);
    v[i] = kRelu && r < 0.0f ? 0.0f : r;
  }
  store<T, kVec>(y, l, t, C, v);
}

// Pack j of a thread holds voxel r + j * rows: whether it lies in the tile.
__device__ __forceinline__ bool in_tile(const Lanes& l, const Tile& t, int j) {
  return l.active() && l.r + j * l.rows < t.n;
}

// Block b's per-channel mean and M2, in f64, over the chunks b, b + blocks,
// ...: part[c * blocks + b]. One pass over shifted values: with K the first
// voxel of the block's first chunk, the f32 sums S1 of d = x - K and S2 of
// d * d give mean = K + S1 / n and M2 = S2 - S1^2 / n. K is one of the
// channel's own values, so a mean far from 0 costs no precision (a mean of
// 1000 standard deviations keeps the variance to 1e-5).
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial_kernel(const T* __restrict__ x, double2* __restrict__ part, int C, int gp, int64_t V) {
  const Lanes l(C, kVec, gp);
  float shift[kVec] = {};  // K, this thread's channels (one load the block's rows share)
  if (l.active()) {
    const Pack<T, kVec> p =
        *reinterpret_cast<const Pack<T, kVec>*>(x + blockIdx.x * l.chunk_voxels * C + l.g * kVec);
#pragma unroll
    for (int k = 0; k < kVec; ++k) shift[k] = to_f32(p.v[k]);
  }
  float sums[2 * kVec] = {};  // each channel's S1, then S2
  int64_t n = 0;
  for (int64_t chunk = blockIdx.x; chunk * l.chunk_voxels < V; chunk += gridDim.x) {
    const Tile t = chunk_tile(chunk, V, l.chunk_voxels);
    n += t.n;
    float v[kItems];
    load<T, kVec>(x, l, t, C, v);
#pragma unroll
    for (int j = 0; j < kItems / kVec; ++j) {
      if (in_tile(l, t, j)) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float d = v[j * kVec + k] - shift[k];
          sums[k] += d;
          sums[kVec + k] = fmaf(d, d, sums[kVec + k]);
        }
      }
    }
  }
  lane_sum<false>(sums, l);
  if (l.active() && l.r == 0) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const double s1 = sums[k], mean_d = s1 / n;
      part[static_cast<int64_t>(l.g * kVec + k) * gridDim.x + blockIdx.x] =
          make_double2(shift[k] + mean_d, sums[kVec + k] - s1 * mean_d);
    }
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

// Voxels block b of `blocks` reduces: its chunks b, b + blocks, ... of the
// T chunks, all full but the last chunk of the volume.
__device__ __forceinline__ int64_t block_voxels(int b, int blocks, int64_t chunk_voxels, int64_t V) {
  const int64_t chunks = (V + chunk_voxels - 1) / chunk_voxels;
  const int64_t mine = (chunks - b + blocks - 1) / blocks;
  return mine * chunk_voxels - ((chunks - 1) % blocks == b ? chunks * chunk_voxels - V : 0);
}

// One block per channel: the channel's entries of part (one a reduction
// block) combined in f64 (thread i takes entries i, i + kFinalThreads, ...
// in turn, then a tree over the threads); writes the batch's mean, invstd,
// scale and shift to coef and, with update, moves the running statistics
// (the biased variance) and counts the batch.
__global__ void __launch_bounds__(kFinalThreads)
bn_stats_finalize_kernel(const double2* __restrict__ part, int blocks, int64_t chunk_voxels, int64_t V,
                         const float* __restrict__ weight, const float* __restrict__ bias,
                         float* __restrict__ running_mean, float* __restrict__ running_var,
                         int64_t* __restrict__ num_batches_tracked, float momentum, float eps, int update,
                         float* __restrict__ coef, int C) {
  __shared__ double count[kFinalThreads], mean[kFinalThreads], m2[kFinalThreads];
  const int c = blockIdx.x, i = threadIdx.x;
  double n = 0.0, m = 0.0, q = 0.0;
  for (int e = i; e < blocks; e += kFinalThreads) {
    const double2 p = part[static_cast<int64_t>(c) * blocks + e];
    chan_combine(n, m, q, static_cast<double>(block_voxels(e, blocks, chunk_voxels, V)), p.x, p.y);
  }
  count[i] = n;
  mean[i] = m;
  m2[i] = q;
  __syncthreads();
  for (int s = kFinalThreads / 2; s > 0; s >>= 1) {
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

// This thread's channels' coefficients from coef [4][C] (an idle lane's are
// channel 0's).
template <int kVec>
__device__ __forceinline__ void thread_coef(const float* __restrict__ coef, int C, const Lanes& l, float (&mean)[kVec],
                                            float (&invstd)[kVec], float (&scale)[kVec], float (&shift)[kVec]) {
  const int c0 = l.active() ? l.g * kVec : 0;
  load_floats<kVec>(coef + kMean * C + c0, mean);
  load_floats<kVec>(coef + kInvstd * C + c0, invstd);
  load_floats<kVec>(coef + kScale * C + c0, scale);
  load_floats<kVec>(coef + kShift * C + c0, shift);
}

// Block b's per-channel sums of g and g * xhat over the chunks b, b +
// blocks, ...: part[c * blocks + b]. The values are summed as they arrive.
template <typename T, int kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_backward_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ coef,
                           float2* __restrict__ part, int C, int gp, int64_t V) {
  const Lanes l(C, kVec, gp);
  float mean[kVec], invstd[kVec], scale[kVec], shift[kVec];
  thread_coef<kVec>(coef, C, l, mean, invstd, scale, shift);
  float s[2 * kVec] = {};  // sum g of each channel, then sum g * xhat
  for (int64_t chunk = blockIdx.x; chunk * l.chunk_voxels < V; chunk += gridDim.x) {
    const Tile t = chunk_tile(chunk, V, l.chunk_voxels);
    float xv[kItems], g[kItems];
    load<T, kVec>(x, l, t, C, xv);
    load<T, kVec>(dy, l, t, C, g);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {  // a masked value has g = 0 and adds nothing
      const int k = i % kVec;
      const float gi = kRelu && fmaf(xv[i], scale[k], shift[k]) <= 0.0f ? 0.0f : g[i];
      s[k] += gi;
      s[kVec + k] = fmaf(gi, (xv[i] - mean[k]) * invstd[k], s[kVec + k]);
    }
  }
  lane_sum<false>(s, l);
  if (l.active() && l.r == 0) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      part[static_cast<int64_t>(l.g * kVec + k) * gridDim.x + blockIdx.x] = make_float2(s[k], s[kVec + k]);
    }
  }
}

// One block per channel: the sums over the channel's entries in f64 (the
// finalize's order) -> dbias, dweight, and sum g / n, sum(g * xhat) / n in
// dcoef [2][C].
__global__ void __launch_bounds__(kFinalThreads)
bn_backward_finalize_kernel(const float2* __restrict__ part, int blocks, int64_t n, float* __restrict__ dweight,
                            float* __restrict__ dbias, float* __restrict__ dcoef, int C) {
  __shared__ double sg[kFinalThreads], sgx[kFinalThreads];
  const int c = blockIdx.x, i = threadIdx.x;
  double a = 0.0, b = 0.0;
  for (int e = i; e < blocks; e += kFinalThreads) {
    const float2 p = part[static_cast<int64_t>(c) * blocks + e];
    a += p.x;
    b += p.y;
  }
  sg[i] = a;
  sgx[i] = b;
  __syncthreads();
  for (int s = kFinalThreads / 2; s > 0; s >>= 1) {
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
                      const float* __restrict__ dcoef, T* __restrict__ dx, int C, int gp, int64_t V) {
  const Lanes l(C, kVec, gp);
  if (!l.active()) return;
  float mean[kVec], invstd[kVec], scale[kVec], shift[kVec], mean_g[kVec] = {}, mean_gx[kVec] = {};
  thread_coef<kVec>(coef, C, l, mean, invstd, scale, shift);
  if constexpr (kTrain) {
    load_floats<kVec>(dcoef + l.g * kVec, mean_g);
    load_floats<kVec>(dcoef + C + l.g * kVec, mean_gx);
  }
  const Tile t = chunk_tile(blockIdx.x, V, l.chunk_voxels);
  float xv[kItems], g[kItems];
  if constexpr (kRelu || kTrain) load<T, kVec>(x, l, t, C, xv);
  load<T, kVec>(dy, l, t, C, g);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i % kVec;
    float gi = g[i];
    if constexpr (kRelu) gi = fmaf(xv[i], scale[k], shift[k]) <= 0.0f ? 0.0f : gi;
    if constexpr (kTrain) gi = fmaf(-(xv[i] - mean[k]) * invstd[k], mean_gx[k], gi - mean_g[k]);
    g[i] = scale[k] * gi;
  }
  store<T, kVec>(dx, l, t, C, g);
}

// Voxels of a chunk, kItems / vec * kThreads / gp = kTile / (vec * gp), and
// the chunks of V voxels: a transform's grid.
int64_t chunk_voxels(int vec, int gp) { return static_cast<int64_t>(kItems / vec) * (kThreads / gp); }
unsigned chunk_count(int64_t V, int vec, int gp) {
  return static_cast<unsigned>((V + chunk_voxels(vec, gp) - 1) / chunk_voxels(vec, gp));
}

template <typename T, int kVec>
int eval_launch(const void* x, void* y, int relu, int C, int gp, int64_t V, const void* running_mean,
                const void* running_var, const void* weight, const void* bias, float eps, void* coef,
                cudaStream_t s) {
  auto kernel = relu ? bn_transform_kernel<T, kVec, true, true> : bn_transform_kernel<T, kVec, false, true>;
  const size_t table = 2 * static_cast<size_t>(C) * sizeof(float);  // the per-channel scale and shift
  kernel<<<chunk_count(V, kVec, gp), kThreads, table, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const float*>(running_mean),
      static_cast<const float*>(running_var), static_cast<const float*>(weight), static_cast<const float*>(bias), eps,
      static_cast<float*>(coef), C, gp, V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec>
int train_launch(const void* x, void* y, int relu, int C, int gp, int64_t V, int blocks, void* part,
                 const void* weight, const void* bias, void* running_mean, void* running_var, void* num_batches_tracked,
                 float momentum, float eps, int update, void* coef, cudaStream_t s) {
  bn_stats_partial_kernel<T, kVec><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x),
                                                                static_cast<double2*>(part), C, gp, V);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bn_stats_finalize_kernel<<<C, kFinalThreads, 0, s>>>(
      static_cast<const double2*>(part), blocks, chunk_voxels(kVec, gp), V,
      static_cast<const float*>(weight), static_cast<const float*>(bias), static_cast<float*>(running_mean),
      static_cast<float*>(running_var), static_cast<int64_t*>(num_batches_tracked), momentum, eps, update,
      static_cast<float*>(coef), C);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  auto kernel = relu ? bn_transform_kernel<T, kVec, true, false> : bn_transform_kernel<T, kVec, false, false>;
  kernel<<<chunk_count(V, kVec, gp), kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(y), nullptr,
                                                        nullptr, nullptr, nullptr, eps, static_cast<float*>(coef), C,
                                                        gp, V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec>
int backward_launch(const void* x, const void* dy, void* dx, int relu, int train, int C, int gp, int64_t V,
                    int blocks, const void* coef, void* part, void* dweight, void* dbias, void* dcoef,
                    cudaStream_t s) {
  auto partial = relu ? bn_backward_partial_kernel<T, kVec, true> : bn_backward_partial_kernel<T, kVec, false>;
  partial<<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                     static_cast<const float*>(coef), static_cast<float2*>(part), C, gp, V);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bn_backward_finalize_kernel<<<C, kFinalThreads, 0, s>>>(static_cast<const float2*>(part), blocks, V,
                                                          static_cast<float*>(dweight), static_cast<float*>(dbias),
                                                          static_cast<float*>(dcoef), C);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  auto dx_kernel = relu ? (train ? bn_backward_dx_kernel<T, kVec, true, true>
                               : bn_backward_dx_kernel<T, kVec, true, false>)
                        : (train ? bn_backward_dx_kernel<T, kVec, false, true>
                                 : bn_backward_dx_kernel<T, kVec, false, false>);
  dx_kernel<<<chunk_count(V, kVec, gp), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(coef),
      static_cast<const float*>(dcoef), static_cast<T*>(dx), C, gp, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// FN<element type, channels a load>(...): bf16 or f32, 16-byte or one-value loads.
#define BN_DISPATCH(bf16, vec, FN, ...)                                                                    \
  ((bf16) ? ((vec) ? FN<__nv_bfloat16, 8>(__VA_ARGS__) : FN<__nv_bfloat16, 1>(__VA_ARGS__))                  \
          : ((vec) ? FN<float, 4>(__VA_ARGS__) : FN<float, 1>(__VA_ARGS__)))

// Plain C interface for ctypes. Pointers are device pointers; the caller has
// checked that x (and y, dy, dx) are NDHWC volumes of V voxels of C channels
// of one dtype (bf16 = 1: bf16, else f32), that the per-channel tensors are
// f32 [C], and sets vec only where C * itemsize is a multiple of 16 and every
// volume's address is 16-byte aligned; gp is the packs of a voxel (C / 8 or C
// / 4 with vec, else C) rounded up to a power of two, at most 256; blocks,
// the reductions' grid, is at most the volume's chunks. Each returns the
// first failed launch's cudaError_t (0 on success).

extern "C" int batch_norm_tile() { return kTile; }

// coef: [4][C] f32 receiving mean, invstd, scale, shift, or null. One launch.
extern "C" int batch_norm_eval_launch(const void* x, void* y, int bf16, int vec, int relu, int C, int gp, int64_t V,
                                      const void* running_mean, const void* running_var, const void* weight,
                                      const void* bias, float eps, void* coef, void* stream) {
  return BN_DISPATCH(bf16, vec, eval_launch, x, y, relu, C, gp, V, running_mean, running_var, weight, bias, eps, coef,
                     static_cast<cudaStream_t>(stream));
}

// part: C * blocks double2 of scratch; coef: [4][C] f32, written. Three
// launches: the blocks' statistics, the per-channel combine (with update, the
// running statistics and num_batches_tracked move), the transform.
extern "C" int batch_norm_train_launch(const void* x, void* y, int bf16, int vec, int relu, int C, int gp, int64_t V,
                                       int blocks, void* part, const void* weight, const void* bias,
                                       void* running_mean, void* running_var, void* num_batches_tracked,
                                       float momentum, float eps, int update, void* coef, void* stream) {
  return BN_DISPATCH(bf16, vec, train_launch, x, y, relu, C, gp, V, blocks, part, weight, bias, running_mean,
                     running_var, num_batches_tracked, momentum, eps, update, coef, static_cast<cudaStream_t>(stream));
}

// coef: the forward's [4][C]; part: C * blocks float2 of scratch; dweight,
// dbias: [C] f32, written; dcoef: [2][C] f32 of scratch. train: the forward
// used batch statistics. Three launches: the blocks' sums, the per-channel
// finalize, dx.
extern "C" int batch_norm_backward_launch(const void* x, const void* dy, void* dx, int bf16, int vec, int relu,
                                          int train, int C, int gp, int64_t V, int blocks, const void* coef,
                                          void* part, void* dweight, void* dbias, void* dcoef, void* stream) {
  return BN_DISPATCH(bf16, vec, backward_launch, x, dy, dx, relu, train, C, gp, V, blocks, coef, part, dweight, dbias,
                     dcoef, static_cast<cudaStream_t>(stream));
}

extern "C" const char* batch_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
