// CostRegNet's last conv, `prob` (3x3x3, 8 -> 1 channel, stride 1, padding 1 on
// H and W), for Hopper (sm_90a): the forward, the input gradient (dgrad) and the
// weight and bias gradient (wgrad), on NDHWC volumes.
//
// Replaces no TPU kernel: the JAX package left this conv to XLA. It is added
// because cuDNN runs it, with its one output channel, on an f32 NCHW engine
// (sm80_xmma_fprop_implicit_gemm_indexed_f32f32) after converting the bf16
// input to f32, at about 120x this card's bound, the largest device operation
// of a request.
//
// Bound on this card: per output voxel the forward reads 8 input values and
// writes one (18 bytes in bf16) and does 216 multiply-adds, which sits at the
// ridge between bytes (3.35 TB/s) and f32 FMAs outside the tensor cores
// (67 TFLOP/s); the operations bound it by a little. The dgrad (one value in,
// 8 out) and the wgrad (216 + 1 sums over every voxel) do the same work.
//
// Layout: x and gx are [B, D, H, W, 8] (CostRegNet's NDHWC activation), y and
// g [B, D, H, W]. A voxel's 8 channels are 16 bytes in bf16 (32 in f32).
//
// Design: CUDA-core FMAs, f32 in registers, each output rounded once; f32 runs
// in f32 (no TF32), so the arithmetic is the plain conv's and only the order of
// the f32 sums differs. A block owns a tile of 32 columns of a sample's H x W
// plane and a chunk of D (the wrapper's launch plan, about two waves of warps
// on the card): the forward 8 warps over 16 rows, the dgrad 4 over 4, the
// wgrad 4 over 8; a warp owns 8 columns of kNH rows, its lanes 4 to a column,
// lane p of a column the channel pair 2p, 2p + 1. The planes the block needs
// stream through a ring of shared-memory slots, each the tile with a one-voxel
// halo as raw input values, filled by 16-byte cp.async whose zero fill is the
// conv's padding: a voxel's 8 channels one copy (two in f32), a single-channel
// plane 16 bytes of a row a copy (one value at a time where the rows or the
// volumes are not 16-byte aligned). A lane reads its channel pair of a voxel
// as one 4-byte word (8 in f32): the warp's 8 neighbouring voxels are 32
// neighbouring words, one wavefront. A lane's 54 weights (its pair's 27 taps)
// stay in registers, so every value read feeds 9 or 18 FMAs from registers.
// The D loops carry no branch per plane: a chunk's first and last planes also
// feed accumulators of planes outside the chunk, which are never stored (the
// forward, the dgrad) or meet zero gradients (the wgrad).
//  - forward: input plane p is multiplied by the three kd slices of the taps
//    into three rolling accumulators (output planes p, p - 1, p - 2 of the
//    chunk); after input plane p, output plane p - 2 is complete, the 4 lanes
//    of a column add their pairs' sums (a fixed butterfly), the bias is added
//    and one lane stores each row.
//  - dgrad: the forward's stencil transposed, a correlation of the gradient
//    with the taps flipped and D padded by 2 - pad_d, the same rolling
//    accumulators over the gradient's planes; the 4 lanes of a column trade
//    words so each stores whole voxels: 8 channels one 16-byte store (two in
//    f32).
//  - wgrad: each lane keeps its pair's 27 sums; the gradient planes roll
//    through registers as the forward's accumulators do, and the lanes of
//    pair 0 also sum the gradient for the bias. The block adds its lanes' sums
//    in a fixed order and writes them to scratch, and a second launch adds the
//    blocks' entries in a fixed order in f64 (no float atomics), so the result
//    repeats its bits from run to run.
// A pad_d of 1 is the conv's zero padding on D; 0 is the sweep split's input,
// whose first and last planes are the neighbours' (D + 2 planes in, D out).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCin = 8;              // prob's input channels
constexpr int kWeights = kCin * 27;  // 216
constexpr int kSums = kWeights + 1;  // the wgrad's sums: the weights', then the bias'
constexpr int kPairs = kCin / 2;     // lanes of a column, one channel pair each
constexpr int kCols = 32 / kPairs;   // columns of a warp: 8
constexpr int kWarpsW = 4;               // warps across a tile
constexpr int kTileW = kCols * kWarpsW;  // output columns of every kernel's tile: 32
// forward: 2 x 4 warps, 8 rows a thread; dgrad and wgrad: 1 x 4 warps, 4 and 8 rows a thread
constexpr int kFwdWarps = 8, kFwdNH = 8, kFwdRows = kFwdNH * kFwdWarps / kWarpsW, kFwdStages = 4;
constexpr int kDgWarps = 4, kDgNH = 4, kDgRows = kDgNH * kDgWarps / kWarpsW, kDgStages = 6;
constexpr int kWgWarps = 4, kWgNH = 8, kWgRows = kWgNH * kWgWarps / kWarpsW, kWgStages = 3;
constexpr int kFinalThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float& out) { out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16& out) { out = __float2bfloat16_rn(v); }
__device__ __forceinline__ void from_f64(double v, float& out) { out = static_cast<float>(v); }
// One rounding of v to bf16: to f32 toward zero with an inexact result's last
// bit set (round to odd), then to nearest bf16, which is v's own rounding.
__device__ __forceinline__ void from_f64(double v, __nv_bfloat16& out) {
  float f = __double2float_rz(v);
  if (static_cast<double>(f) != v) f = __uint_as_float(__float_as_uint(f) | 1u);
  out = __float2bfloat16_rn(f);
}

// A plane of voxels over a tile of kRows x kTileW outputs with a one-voxel
// halo: rows h0 - 1 .. h0 + kRows, columns w0 - 1 .. w0 + kTileW, kChannels raw
// T a voxel.
template <typename T, int kRows, int kChannels>
struct Plane {
  static constexpr int kHaloRows = kRows + 2;
  static constexpr int kVoxels = kTileW + 2;  // a row's
  static constexpr int kElems = kHaloRows * kVoxels * kChannels;
  static constexpr int kBytes = (kElems * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
};

// A single-channel plane over the same halo tile, its columns led by one
// 16-byte chunk on each side so that column w0 (a multiple of 32) starts a
// chunk: columns w0 - kLead .. w0 + kTileW + kLead - 1, column w0 at kLead.
template <typename T, int kRows>
struct Slice {
  static constexpr int kLead = 16 / static_cast<int>(sizeof(T));
  static constexpr int kHaloRows = kRows + 2;
  static constexpr int kPitch = kTileW + 2 * kLead;
  static constexpr int kElems = kHaloRows * kPitch;
  static constexpr int kBytes = kElems * static_cast<int>(sizeof(T));
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start the copy of `plane` (a sample's H x W voxels of kCin channels; null
// where the plane is D's padding) over the tile at (h0, w0) into dst: 16 bytes
// a copy where the volume is 16-byte aligned (a voxel is one or two copies),
// else one value at a time, by the block's kBlock threads. `any` is a valid,
// aligned address for the copies that read nothing.
template <typename T, bool kAligned, class P, int kBlock>
__device__ __forceinline__ void fill_plane(T* dst, const T* __restrict__ plane, const T* any, int h0, int w0, int H,
                                           int W) {
  constexpr int kPerCopy = kAligned ? 16 / static_cast<int>(sizeof(T)) : 1;  // values a copy
  constexpr int kCopies = kCin / kPerCopy;                                   // copies a voxel
  for (int i = threadIdx.x; i < P::kHaloRows * P::kVoxels * kCopies; i += kBlock) {
    const int v = i / kCopies, k = i - v * kCopies, r = v / P::kVoxels;
    const int h = h0 - 1 + r, w = w0 - 1 + (v - r * P::kVoxels);
    const bool ok = plane != nullptr && h >= 0 && h < H && w >= 0 && w < W;
    const int64_t src = (static_cast<int64_t>(h) * W + w) * kCin + k * kPerCopy;
    if constexpr (kAligned) {
      cp_async16(dst + i * kPerCopy, ok ? plane + src : any, ok);
    } else {
      dst[i] = ok ? plane[src] : T(0.0f);
    }
  }
}

// The same for a single-channel plane into a Slice: 16 bytes a copy where the
// rows are 16-byte aligned (W a multiple of kLead and the tensor aligned, so a
// chunk lies wholly inside the plane or outside), else one value at a time.
template <typename T, bool kAligned, class S, int kBlock>
__device__ __forceinline__ void fill_slice(T* dst, const T* __restrict__ plane, const T* any, int h0, int w0, int H,
                                           int W) {
  if constexpr (kAligned) {
    constexpr int kChunks = S::kPitch / S::kLead;
    for (int i = threadIdx.x; i < S::kHaloRows * kChunks; i += kBlock) {
      const int r = i / kChunks, k = i - r * kChunks;
      const int h = h0 - 1 + r, w = w0 - S::kLead + k * S::kLead;
      const bool ok = plane != nullptr && h >= 0 && h < H && w >= 0 && w < W;
      cp_async16(dst + r * S::kPitch + k * S::kLead, ok ? plane + static_cast<int64_t>(h) * W + w : any, ok);
    }
  } else {
    for (int i = threadIdx.x; i < S::kElems; i += kBlock) {
      const int r = i / S::kPitch, k = i - r * S::kPitch;
      const int h = h0 - 1 + r, w = w0 - S::kLead + k;
      const bool ok = plane != nullptr && h >= 0 && h < H && w >= 0 && w < W;
      dst[i] = ok ? plane[static_cast<int64_t>(h) * W + w] : T(0.0f);
    }
  }
}

// Channels 2p and 2p + 1 of the voxel at (halo row r, halo column c) of a
// Plane: one 4-byte (bf16) or 8-byte (f32) load.
template <class P>
__device__ __forceinline__ void load_pair(const __nv_bfloat16* plane, int r, int c, int p, float (&v)[2]) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(plane + (r * P::kVoxels + c) * kCin + 2 * p);
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}

template <class P>
__device__ __forceinline__ void load_pair(const float* plane, int r, int c, int p, float (&v)[2]) {
  const float2 u = *reinterpret_cast<const float2*>(plane + (r * P::kVoxels + c) * kCin + 2 * p);
  v[0] = u.x;
  v[1] = u.y;
}

// The lane's place: its channel pair p, its column in the tile (0 .. 31) and
// its first row in the tile.
struct Lane {
  int p, col, row0;
  __device__ __forceinline__ explicit Lane(int nh) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    p = lane % kPairs;
    col = warp % kWarpsW * kCols + lane / kPairs;
    row0 = warp / kWarpsW * nh;
  }
};

// The lane's 54 taps: its two channels' 27, flipped (tap k -> 26 - k) for the
// dgrad.
template <typename T, bool kFlip>
__device__ __forceinline__ void lane_taps(const T* __restrict__ weight, int p, float (&t)[2][27]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int k = 0; k < 27; ++k) t[c][k] = to_f32(weight[(2 * p + c) * 27 + (kFlip ? 26 - k : k)]);
  }
}

template <int kNH>
__device__ __forceinline__ void roll(float (&acc)[3][kNH]) {
#pragma unroll
  for (int i = 0; i < kNH; ++i) {
    acc[2][i] = acc[1][i];
    acc[1][i] = acc[0][i];
    acc[0][i] = 0.0f;
  }
}

// Let kKernel take kBytes of dynamic shared memory where that is above the
// default 48 KB; once per kernel.
template <auto kKernel, int kBytes>
int allow_smem() {
  static const int err = kBytes > 48 * 1024 ? static_cast<int>(cudaFuncSetAttribute(
                                                  kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes))
                                            : 0;
  return err;
}

// y[n, o, h, w] = bias + sum over (c, kd, kh, kw) of w[c, kd, kh, kw] x[n, o +
// kd - pad, h + kh - 1, w + kw - 1, c]. Block: tile (blockIdx.x, blockIdx.y),
// sample and D chunk blockIdx.z; input planes in turn.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kFwdWarps * 32, 2)
prob_forward_kernel(const T* __restrict__ x, const T* __restrict__ weight, const T* __restrict__ bias,
                    T* __restrict__ y, int D_in, int D_out, int H, int W, int pad, int chunk, int chunks) {
  using P = Plane<T, kFwdRows, kCin>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int n = blockIdx.z / chunks, o0 = blockIdx.z % chunks * chunk;
  const int outs = min(chunk, D_out - o0), planes = outs + 2;  // input planes o0 - pad .. o0 - pad + outs + 1
  const int h0 = blockIdx.y * kFwdRows, w0 = blockIdx.x * kTileW;
  const int64_t hw = static_cast<int64_t>(H) * W;
  const T* xn = x + static_cast<int64_t>(n) * D_in * hw * kCin;

  auto fill = [&](int s) {
    if (s < planes) {
      const int q = o0 - pad + s;
      fill_plane<T, kAligned, P, kFwdWarps * 32>(ring + s % kFwdStages * P::kBytes / static_cast<int>(sizeof(T)),
                                                 q >= 0 && q < D_in ? xn + q * hw * kCin : nullptr, x, h0, w0, H, W);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kFwdStages - 1; ++s) fill(s);

  const Lane l(kFwdNH);
  float taps[2][27];
  lane_taps<T, false>(weight, l.p, taps);
  const float b = bias == nullptr ? 0.0f : to_f32(bias[0]);
  const int w = w0 + l.col;
  float acc[3][kFwdNH] = {};  // output planes s (kd 0), s - 1 (kd 1), s - 2 (kd 2) of the chunk
  for (int s = 0; s < planes; ++s) {
    const int q = o0 - pad + s;
    cp_async_wait<kFwdStages - 2>();  // plane s has landed
    __syncthreads();                  // for every thread, and plane s - 1's slot is free
    fill(s + kFwdStages - 1);
    if (q >= 0 && q < D_in) {  // a padding plane adds nothing
      const T* plane = ring + s % kFwdStages * P::kBytes / static_cast<int>(sizeof(T));
#pragma unroll
      for (int i = 0; i < kFwdNH + 2; ++i) {
        float v[3][2];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) load_pair<P>(plane, l.row0 + i, l.col + kw, l.p, v[kw]);
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const int oi = i - kh;
          if (oi < 0 || oi >= kFwdNH) continue;
#pragma unroll
          for (int kd = 0; kd < 3; ++kd) {  // a plane outside the chunk is rolled out unstored
            float a = acc[kd][oi];
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
              a = fmaf(taps[0][kd * 9 + kh * 3 + kw], v[kw][0], a);
              a = fmaf(taps[1][kd * 9 + kh * 3 + kw], v[kw][1], a);
            }
            acc[kd][oi] = a;
          }
        }
      }
    }
    if (s >= 2) {  // output plane o0 + s - 2: the column's 4 pairs added, then the bias; lane p stores rows p, p + 4
      T* out = y + (static_cast<int64_t>(n) * D_out + o0 + s - 2) * hw;
#pragma unroll
      for (int i = 0; i < kFwdNH; ++i) {
        float t = acc[2][i];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        const int h = h0 + l.row0 + i;
        if (i % kPairs == l.p && h < H && w < W) from_f32(t + b, out[static_cast<int64_t>(h) * W + w]);
      }
    }
    roll(acc);
  }
  cp_async_wait<0>();
}

// The dgrad's store of one row of the lane's column: the 4 lanes of the column
// hold channel pairs 0..3 of rows 4k .. 4k + 3 as `words` (kWords 32-bit words
// a pair: 1 in bf16, 2 in f32); after three exchanges lane p holds all 8
// channels of row 4k + p, which it stores as one voxel.
template <typename T, int kWords>
__device__ __forceinline__ void store_voxel(T* dst, const uint32_t (&words)[4][kWords], int p, bool ok) {
  uint32_t voxel[4][kWords];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int send_row = p ^ m, slot = p ^ m;  // send row (p ^ m) to lane p ^ m; receive its pair for row p
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      uint32_t u = words[0][k];
#pragma unroll
      for (int r = 1; r < 4; ++r) u = send_row == r ? words[r][k] : u;
      if (m != 0) u = __shfl_xor_sync(0xffffffffu, u, m);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j == slot) voxel[j][k] = u;
      }
    }
  }
  if (ok) {
    uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      // 16-byte store k of the voxel: words 4k .. 4k + 3 in channel order
      uint32_t q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = voxel[(4 * k + j) / kWords][(4 * k + j) % kWords];
      out[k] = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
}

__device__ __forceinline__ void pack_pair(float a, float b, uint32_t (&w)[1]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  w[0] = *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void pack_pair(float a, float b, uint32_t (&w)[2]) {
  w[0] = __float_as_uint(a);
  w[1] = __float_as_uint(b);
}

// gx[n, q, h, w, c] = sum over (a, b, e) of g[n, q + a - 2 + pad, h + b - 1, w +
// e - 1] w[c, 2 - a, 2 - b, 2 - e]: the gradient planes q0 - 2 + pad + s in
// turn, each into output planes s - a of the chunk.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kDgWarps * 32, 4)
prob_dgrad_kernel(const T* __restrict__ g, const T* __restrict__ weight, T* __restrict__ gx, int D_in, int D_out,
                  int H, int W, int pad, int chunk, int chunks) {
  using S = Slice<T, kDgRows>;
  constexpr int kWords = static_cast<int>(sizeof(T)) / 2;
  static_assert(kDgNH == kPairs, "a column's 4 lanes store one row each");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int n = blockIdx.z / chunks, q0 = blockIdx.z % chunks * chunk;
  const int outs = min(chunk, D_in - q0), planes = outs + 2;  // gradient planes q0 - 2 + pad + s
  const int h0 = blockIdx.y * kDgRows, w0 = blockIdx.x * kTileW;
  const int64_t hw = static_cast<int64_t>(H) * W;
  const T* gn = g + static_cast<int64_t>(n) * D_out * hw;

  auto fill = [&](int s) {
    if (s < planes) {
      const int o = q0 - 2 + pad + s;
      fill_slice<T, kAligned, S, kDgWarps * 32>(ring + s % kDgStages * S::kElems,
                                                o >= 0 && o < D_out ? gn + o * hw : nullptr, g, h0, w0, H, W);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kDgStages - 1; ++s) fill(s);

  const Lane l(kDgNH);
  float taps[2][27];  // [c][a * 9 + b * 3 + e] = w[c, 2 - a, 2 - b, 2 - e]
  lane_taps<T, true>(weight, l.p, taps);
  const int w = w0 + l.col;
  float acc[3][kDgNH][2] = {};  // output planes s (a 0), s - 1 (a 1), s - 2 (a 2) of the chunk, the lane's pair
  for (int s = 0; s < planes; ++s) {
    const int o = q0 - 2 + pad + s;
    cp_async_wait<kDgStages - 2>();
    __syncthreads();
    fill(s + kDgStages - 1);
    if (o >= 0 && o < D_out) {  // a padding plane adds nothing
      const T* rows = ring + s % kDgStages * S::kElems + S::kLead - 1 + l.col;
#pragma unroll
      for (int i = 0; i < kDgNH + 2; ++i) {
        float v[3];
#pragma unroll
        for (int e = 0; e < 3; ++e) v[e] = to_f32(rows[(l.row0 + i) * S::kPitch + e]);
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int oi = i - b;
          if (oi < 0 || oi >= kDgNH) continue;
#pragma unroll
          for (int a = 0; a < 3; ++a) {  // a plane outside the chunk is rolled out unstored
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float t = acc[a][oi][c];
#pragma unroll
              for (int e = 0; e < 3; ++e) t = fmaf(taps[c][a * 9 + b * 3 + e], v[e], t);
              acc[a][oi][c] = t;
            }
          }
        }
      }
    }
    if (s >= 2) {  // output plane q0 + s - 2
      T* out = gx + (static_cast<int64_t>(n) * D_in + q0 + s - 2) * hw * kCin;
      if constexpr (kAligned) {
        uint32_t words[kDgNH][kWords];
#pragma unroll
        for (int i = 0; i < kDgNH; ++i) pack_pair(acc[2][i][0], acc[2][i][1], words[i]);
        const int h = h0 + l.row0 + l.p;
        store_voxel<T, kWords>(out + (static_cast<int64_t>(h) * W + w) * kCin, words, l.p, h < H && w < W);
      } else {
#pragma unroll
        for (int i = 0; i < kDgNH; ++i) {
          const int h = h0 + l.row0 + i;
          if (h < H && w < W) {
            T* dst = out + (static_cast<int64_t>(h) * W + w) * kCin + 2 * l.p;
            from_f32(acc[2][i][0], dst[0]);
            from_f32(acc[2][i][1], dst[1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kDgNH; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        acc[2][i][c] = acc[1][i][c];
        acc[1][i][c] = acc[0][i][c];
        acc[0][i][c] = 0.0f;
      }
    }
  }
  cp_async_wait<0>();
}

// The block's share of dw[c, kd, kh, kw] = sum of g[n, o, h, w] x[n, o + kd -
// pad, h + kh - 1, w + kw - 1, c] and of dbias = sum of g, over its tile and D
// chunk: part[k * blocks + block]. Stage s holds input plane o0 - pad + s and
// gradient plane o0 + s (zeros past the chunk).
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kWgWarps * 32, 4)
prob_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part, int D_in, int D_out,
                  int H, int W, int pad, int chunk, int chunks) {
  using P = Plane<T, kWgRows, kCin>;
  using S = Slice<T, kWgRows>;
  constexpr int kStage = (P::kBytes + S::kBytes) / static_cast<int>(sizeof(T));  // elements of a stage
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int n = blockIdx.z / chunks, o0 = blockIdx.z % chunks * chunk;
  const int outs = min(chunk, D_out - o0), planes = outs + 2;
  const int h0 = blockIdx.y * kWgRows, w0 = blockIdx.x * kTileW;
  const int64_t hw = static_cast<int64_t>(H) * W;
  const T* xn = x + static_cast<int64_t>(n) * D_in * hw * kCin;
  const T* gn = g + static_cast<int64_t>(n) * D_out * hw;

  auto fill = [&](int s) {
    if (s < planes) {
      T* stage = ring + s % kWgStages * kStage;
      const int q = o0 - pad + s;
      fill_plane<T, kAligned, P, kWgWarps * 32>(stage, q >= 0 && q < D_in ? xn + q * hw * kCin : nullptr, x, h0, w0,
                                                H, W);
      fill_slice<T, kAligned, S, kWgWarps * 32>(stage + P::kBytes / static_cast<int>(sizeof(T)),
                                                s < outs ? gn + (o0 + s) * hw : nullptr, g, h0, w0, H, W);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) fill(s);

  const Lane l(kWgNH);
  float sums[2][27] = {}, bsum = 0.0f;
  float gr[3][kWgNH] = {};  // gradient planes s (kd 0), s - 1 (kd 1), s - 2 (kd 2) of the chunk
  for (int s = 0; s < planes; ++s) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();
    fill(s + kWgStages - 1);
    const T* stage = ring + s % kWgStages * kStage;
    const T* grow = stage + P::kBytes / static_cast<int>(sizeof(T)) + S::kLead + l.col;
    roll(gr);
#pragma unroll
    for (int i = 0; i < kWgNH; ++i) gr[0][i] = to_f32(grow[(l.row0 + 1 + i) * S::kPitch]);  // 0 past the chunk
    if (l.p == 0) {
#pragma unroll
      for (int i = 0; i < kWgNH; ++i) bsum += gr[0][i];
    }
    const int q = o0 - pad + s;
    if (q < 0 || q >= D_in) continue;  // a padding plane adds nothing
#pragma unroll
    for (int i = 0; i < kWgNH + 2; ++i) {
      float v[3][2];
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) load_pair<P>(stage, l.row0 + i, l.col + kw, l.p, v[kw]);
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int oi = i - kh;
        if (oi < 0 || oi >= kWgNH) continue;
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {  // gradient planes outside the chunk are zeros
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              sums[c][kd * 9 + kh * 3 + kw] = fmaf(gr[kd][oi], v[kw][c], sums[c][kd * 9 + kh * 3 + kw]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' sums

  // the warp's columns added (lanes of one pair: offsets 4, 8, 16), then the warps in order
  float* warp_sums = reinterpret_cast<float*>(smem);  // [kWgWarps][kSums]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int k = 0; k < 27; ++k) {
      float t = sums[c][k];
#pragma unroll
      for (int off = kPairs; off < 32; off <<= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
      if (lane < kPairs) warp_sums[warp * kSums + (2 * l.p + c) * 27 + k] = t;
    }
  }
#pragma unroll
  for (int off = kPairs; off < 32; off <<= 1) bsum += __shfl_xor_sync(0xffffffffu, bsum, off);
  if (lane == 0) warp_sums[warp * kSums + kWeights] = bsum;
  __syncthreads();
  const int64_t blocks = static_cast<int64_t>(gridDim.x) * gridDim.y * gridDim.z;
  const int64_t block = (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  for (int k = threadIdx.x; k < kSums; k += kWgWarps * 32) {
    float t = warp_sums[k];
#pragma unroll
    for (int wi = 1; wi < kWgWarps; ++wi) t += warp_sums[wi * kSums + k];
    part[k * blocks + block] = t;
  }
}

// One block per sum k: part[k * blocks ..] added in f64 in a fixed order (a
// strided sum per thread, then a tree), rounded once to T.
template <typename T>
__global__ void __launch_bounds__(kFinalThreads)
prob_wgrad_finalize_kernel(const float* __restrict__ part, int64_t blocks, T* __restrict__ dweight,
                           T* __restrict__ dbias) {
  __shared__ double sums[kFinalThreads];
  const int k = blockIdx.x;
  double s = 0.0;
  for (int64_t i = threadIdx.x; i < blocks; i += kFinalThreads) s += part[k * blocks + i];
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int h = kFinalThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) sums[threadIdx.x] += sums[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) from_f64(sums[0], k < kWeights ? dweight[k] : dbias[0]);
}

template <typename T, bool kAligned>
int forward_launch(const void* x, const void* weight, const void* bias, void* y, int B, int D_in, int D_out, int H,
                   int W, int pad, int tiles_w, int tiles_h, int chunk, int chunks, cudaStream_t s) {
  constexpr int kSmem = kFwdStages * Plane<T, kFwdRows, kCin>::kBytes;
  const int err = allow_smem<prob_forward_kernel<T, kAligned>, kSmem>();
  if (err != 0) return err;
  prob_forward_kernel<T, kAligned><<<dim3(tiles_w, tiles_h, B * chunks), kFwdWarps * 32, kSmem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(weight), static_cast<const T*>(bias), static_cast<T*>(y), D_in,
      D_out, H, W, pad, chunk, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kAligned>
int backward_launch(const void* x, const void* weight, const void* g, void* gx, void* part, void* dweight,
                    void* dbias, int B, int D_in, int D_out, int H, int W, int pad, const int* dplan,
                    const int* wplan, cudaStream_t s) {
  if (gx != nullptr) {
    constexpr int kSmem = kDgStages * Slice<T, kDgRows>::kBytes;
    static_assert(kSmem <= 48 * 1024, "the dgrad's ring must fit the default shared memory");
    prob_dgrad_kernel<T, kAligned><<<dim3(dplan[0], dplan[1], B * dplan[3]), kDgWarps * 32, kSmem, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(weight), static_cast<T*>(gx), D_in, D_out, H, W, pad,
        dplan[2], dplan[3]);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (dweight != nullptr) {
    constexpr int kSmem = kWgStages * (Plane<T, kWgRows, kCin>::kBytes + Slice<T, kWgRows>::kBytes);
    static_assert(kSmem >= kWgWarps * kSums * 4, "the wgrad's ring must hold the warps' sums");
    int err = allow_smem<prob_wgrad_kernel<T, kAligned>, kSmem>();
    if (err != 0) return err;
    const dim3 grid(wplan[0], wplan[1], B * wplan[3]);
    prob_wgrad_kernel<T, kAligned><<<grid, kWgWarps * 32, kSmem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<float*>(part), D_in, D_out, H, W, pad,
        wplan[2], wplan[3]);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    prob_wgrad_finalize_kernel<T><<<dbias != nullptr ? kSums : kWeights, kFinalThreads, 0, s>>>(
        static_cast<const float*>(part), static_cast<int64_t>(grid.x) * grid.y * grid.z, static_cast<T*>(dweight),
        static_cast<T*>(dbias));
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

// FN<element type, 16-byte copies>(...): bf16 or f32, aligned or not.
#define PROB_DISPATCH(bf16, aligned, FN, ...)                                                                   \
  ((bf16) ? ((aligned) ? FN<__nv_bfloat16, true>(__VA_ARGS__) : FN<__nv_bfloat16, false>(__VA_ARGS__))            \
          : ((aligned) ? FN<float, true>(__VA_ARGS__) : FN<float, false>(__VA_ARGS__)))

// Plain C interface for ctypes. Pointers are device pointers; the caller has
// checked that x [B, D_in, H, W, 8] (NDHWC), y and g [B, D_out, H, W], gx
// (x's shape), the weight [1, 8, 3, 3, 3] and the bias [1] (or null) are
// contiguous and of one dtype (bf16 = 1: bf16, else f32), that D_out = D_in +
// 2 pad - 2 >= 1 with pad 0 or 1, and sets aligned only where every volume's
// address is 16-byte aligned and, in the backward (whose single-channel
// gradient is copied 16 bytes of a row at a time), W is a multiple of 16
// bytes' values. A plan is
// (tiles along W, tiles along H, planes a chunk, chunks) of the kernel's tile
// (prob_conv_tile_rows x prob_conv_tile_cols). Each returns the first failed
// launch's cudaError_t (0 on success).

// Rows of kernel k's tile (0 forward, 1 dgrad, 2 wgrad).
extern "C" int prob_conv_tile_rows(int k) { return k == 0 ? kFwdRows : k == 1 ? kDgRows : kWgRows; }
extern "C" int prob_conv_tile_cols() { return kTileW; }

// One launch.
extern "C" int prob_conv_forward_launch(const void* x, const void* weight, const void* bias, void* y, int bf16,
                                        int aligned, int B, int D_in, int D_out, int H, int W, int pad, int tiles_w,
                                        int tiles_h, int chunk, int chunks, void* stream) {
  return PROB_DISPATCH(bf16, aligned, forward_launch, x, weight, bias, y, B, D_in, D_out, H, W, pad, tiles_w,
                       tiles_h, chunk, chunks, static_cast<cudaStream_t>(stream));
}

// gx, or null for no input gradient: the dgrad's launch (plan dplan). dweight
// [216], or null for no weight gradient: the wgrad's two launches (plan
// wplan), with part 217 x its blocks f32 of scratch and dbias [1] (or null).
extern "C" int prob_conv_backward_launch(const void* x, const void* weight, const void* g, void* gx, void* part,
                                         void* dweight, void* dbias, int bf16, int aligned, int B, int D_in,
                                         int D_out, int H, int W, int pad, int dtiles_w, int dtiles_h, int dchunk,
                                         int dchunks, int wtiles_w, int wtiles_h, int wchunk, int wchunks,
                                         void* stream) {
  const int dplan[4] = {dtiles_w, dtiles_h, dchunk, dchunks}, wplan[4] = {wtiles_w, wtiles_h, wchunk, wchunks};
  return PROB_DISPATCH(bf16, aligned, backward_launch, x, weight, g, gx, part, dweight, dbias, B, D_in, D_out, H, W,
                       pad, dplan, wplan, static_cast<cudaStream_t>(stream));
}

extern "C" const char* prob_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
