// CostRegNet's last conv, `prob` (3x3x3, 8 -> 1 channel, stride 1, padding 1 on
// H and W), for Hopper (sm_90a): the forward, the input gradient (dgrad) and the
// weight and bias gradient (wgrad).
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
// Design: CUDA-core FMAs, f32 in registers, each output rounded once; f32 runs
// in f32 (no TF32), so the arithmetic is the plain conv's and only the order of
// the f32 sums differs. Each kernel's block owns a tile of 32 columns and 16
// (forward, one warp), 32 (dgrad, 4 warps) or 8 rows (wgrad, 4 warps) of a
// sample's H x W plane and a chunk of D (the wrapper's launch plan, about two
// waves of warps on the card), and streams the (plane, channel) slices it needs
// through a ring of shared-memory slots, each the tile with a one-voxel halo as
// raw input values, filled by 16-byte cp.async whose zero fill is the conv's
// padding (one value at a time where the rows are not 16-byte aligned). A
// thread owns 4 consecutive columns of 2 or 4 rows and reads its window of a
// slice (the rows and columns around them) into registers once for all the
// taps that use it; the rows' pitch puts the 4 thread rows of a warp on
// different banks. One-warp forward blocks leave few idle warps at a ragged
// edge (H = 144, W = 200). The weights sit in shared memory as f32.
//  - forward: each input slice is multiplied once by the three kd slices of
//    its channel's weights into three rolling accumulators (output planes
//    p + 1, p, p - 1); after input plane p, output plane p - 1 is complete,
//    gets the bias and is stored. Window reuse is 27 FMAs per value read.
//  - dgrad: the forward's stencil transposed, a correlation of the gradient
//    with the taps flipped and D padded by 2 - pad_d: one output plane at a
//    time from a ring of gradient planes, all 8 channels in registers.
//  - wgrad: each warp takes two input channels over the same tile: the
//    gradient planes roll through registers as in the forward, and each
//    thread keeps its channels' 27 sums; warp 0 also sums the gradient for
//    the bias. Each
//    block writes its sums to scratch, and a second launch adds the blocks'
//    entries in a fixed order in f64 (no float atomics), so the result repeats
//    its bits from run to run.
// A pad_d of 1 is the conv's zero padding on D; 0 is the sweep split's input,
// whose first and last planes are the neighbours' (D + 2 planes in, D out).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCin = 8;                 // prob's input channels
constexpr int kWeights = kCin * 27;     // 216
constexpr int kSums = kWeights + 1;     // the wgrad's sums: the weights', then the bias'
constexpr int kTileW = 32;              // output columns of every kernel's tile
constexpr int kNW = 4;                  // consecutive columns a thread owns
constexpr int kTX = kTileW / kNW;       // threads across the tile: 8
constexpr int kTY = 32 / kTX;           // thread rows a warp: 4
constexpr int kWeightBytes = kCin * 3 * 12 * 4;  // f32 [8][3][12]: 9 taps padded to 12 per (channel, kd)

// forward: one warp a block, 4 rows a thread
constexpr int kFwdWarps = 1, kFwdNH = 4, kFwdRows = kFwdWarps * kTY * kFwdNH, kFwdStages = 4;
// dgrad: 4 warps stacked in H, 2 rows a thread, 8 channels each
constexpr int kDgWarps = 4, kDgNH = 2, kDgRows = kDgWarps * kTY * kDgNH, kDgStages = 6;
// wgrad: 4 warps over one tile, 2 input channels each, 2 rows a thread
constexpr int kWgWarps = 4, kWgChannels = kCin / kWgWarps, kWgNH = 2, kWgRows = kTY * kWgNH, kWgStages = 3;
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

// Words of a slice row: at least `bytes`, a multiple of 16 bytes, and such
// that nh rows (one warp's next thread row) fall 16 banks further on.
constexpr int pitch_words(int bytes, int nh) {
  int w = (bytes + 15) / 16 * 4;
  while (nh * w % 32 != 16) w += 4;
  return w;
}

// A slice: one (plane, channel) of the input over a tile of kRows x kTileW
// outputs with a one-voxel halo, rows h0 - 1 .. h0 + kRows and columns
// w0 - kLead .. w0 + kTileW + kLead - 1 (one 16-byte chunk each side) as raw
// T, kPitch elements a row; column w0 sits kLead elements into its row.
template <typename T, int kRows, int kNH>
struct Slice {
  static constexpr int kLead = 16 / static_cast<int>(sizeof(T));
  static constexpr int kHaloRows = kRows + 2;
  static constexpr int kCopyCols = kTileW + 2 * kLead;
  static constexpr int kPitch = pitch_words(kCopyCols * static_cast<int>(sizeof(T)), kNH) * 4 /
                                static_cast<int>(sizeof(T));
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

// Start the copy of `plane` (a sample's channel's H x W values; null where the
// plane is D's padding) over the tile at (h0, w0) into the slice at dst: 16
// bytes a copy where the rows are 16-byte aligned (W a multiple of kLead and
// the tensor aligned, so a chunk lies wholly inside the plane or outside),
// else one value at a time. `any` is a valid, aligned address for the copies
// that read nothing.
template <typename T, bool kAligned, class S>
__device__ __forceinline__ void fill_slice(T* dst, const T* __restrict__ plane, const T* any, int h0, int w0, int H,
                                           int W) {
  if constexpr (kAligned) {
    constexpr int kChunks = S::kCopyCols / S::kLead;
    for (int i = threadIdx.x; i < S::kHaloRows * kChunks; i += blockDim.x) {
      const int r = i / kChunks, k = i - r * kChunks;
      const int h = h0 - 1 + r, w = w0 - S::kLead + k * S::kLead;
      const bool ok = plane != nullptr && h >= 0 && h < H && w >= 0 && w < W;
      cp_async16(dst + r * S::kPitch + k * S::kLead, ok ? plane + static_cast<int64_t>(h) * W + w : any, ok);
    }
  } else {
    for (int i = threadIdx.x; i < S::kHaloRows * S::kCopyCols; i += blockDim.x) {
      const int r = i / S::kCopyCols, k = i - r * S::kCopyCols;
      const int h = h0 - 1 + r, w = w0 - S::kLead + k;
      const bool ok = plane != nullptr && h >= 0 && h < H && w >= 0 && w < W;
      dst[r * S::kPitch + k] = ok ? plane[static_cast<int64_t>(h) * W + w] : T(0.0f);
    }
  }
}

// Columns c0 - 1 .. c0 + 4 of a slice row (`row` at the tile's first column)
// as f32: one 16-byte or 8-byte load for the thread's own 4 columns, one load
// for each neighbour.
__device__ __forceinline__ void load_row(const float* row, int c0, float (&v)[6]) {
  const float4 m = *reinterpret_cast<const float4*>(row + c0);
  v[0] = row[c0 - 1];
  v[1] = m.x;
  v[2] = m.y;
  v[3] = m.z;
  v[4] = m.w;
  v[5] = row[c0 + 4];
}

__device__ __forceinline__ float low_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float high_bf16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void load_row(const __nv_bfloat16* row, int c0, float (&v)[6]) {
  const uint2 m = *reinterpret_cast<const uint2*>(row + c0);
  const uint32_t l = *reinterpret_cast<const uint32_t*>(row + c0 - 2);
  const uint32_t r = *reinterpret_cast<const uint32_t*>(row + c0 + 4);
  v[0] = high_bf16(l);
  v[1] = low_bf16(m.x);
  v[2] = high_bf16(m.x);
  v[3] = low_bf16(m.y);
  v[4] = high_bf16(m.y);
  v[5] = low_bf16(r);
}

// The 9 (kh, kw) taps of one (channel, kd): 12 floats apart, 16-byte aligned.
__device__ __forceinline__ void load_taps(const float* p, float (&t)[9]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  t[0] = a.x;
  t[1] = a.y;
  t[2] = a.z;
  t[3] = a.w;
  t[4] = b.x;
  t[5] = b.y;
  t[6] = b.z;
  t[7] = b.w;
  t[8] = p[8];
}

// acc[i][j] += the taps' correlation with the window at output (i, j).
template <int kNH>
__device__ __forceinline__ void stencil(const float (&t)[9], const float (&win)[kNH + 2][6], float (&acc)[kNH][kNW]) {
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
      for (int i = 0; i < kNH; ++i) {
#pragma unroll
        for (int j = 0; j < kNW; ++j) acc[i][j] = fmaf(t[kh * 3 + kw], win[i + kh][j + kw], acc[i][j]);
      }
    }
  }
}

template <typename T, int kN>
struct alignas(sizeof(T) * kN) Pack {
  T v[kN];
};

// The thread's kNH x 4 outputs at (h, w) of an H x W output plane, plus `add`,
// each rounded once; rows and columns outside the plane are not stored.
template <typename T, bool kAligned, int kNH>
__device__ __forceinline__ void store_rows(T* __restrict__ plane, int h, int w, int H, int W,
                                           const float (&v)[kNH][kNW], float add) {
#pragma unroll
  for (int i = 0; i < kNH; ++i) {
    if (h + i >= H) break;
    T* p = plane + static_cast<int64_t>(h + i) * W + w;
    if constexpr (kAligned) {  // W is a multiple of 4: the 4 columns are all inside or all outside
      if (w < W) {
        Pack<T, kNW> out;
#pragma unroll
        for (int j = 0; j < kNW; ++j) from_f32(v[i][j] + add, out.v[j]);
        *reinterpret_cast<Pack<T, kNW>*>(p) = out;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNW; ++j) {
        if (w + j < W) from_f32(v[i][j] + add, p[j]);
      }
    }
  }
}

// y[n, 0, o] = bias + sum over (c, kd, kh, kw) of w[c, kd, kh, kw] x[n, c, o +
// kd - pad, h + kh - 1, w + kw - 1]. Block: tile (blockIdx.x, blockIdx.y),
// sample and D chunk blockIdx.z; slices (input plane p, channel c) in turn.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kFwdWarps * 32, 16)
prob_forward_kernel(const T* __restrict__ x, const T* __restrict__ weight, const T* __restrict__ bias,
                    T* __restrict__ y, int D_in, int D_out, int H, int W, int pad, int chunk, int chunks) {
  using S = Slice<T, kFwdRows, kFwdNH>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* taps = reinterpret_cast<float*>(smem);
  T* ring = reinterpret_cast<T*>(smem + kWeightBytes);
  const int n = blockIdx.z / chunks, o0 = blockIdx.z % chunks * chunk;
  const int outs = min(chunk, D_out - o0), planes = outs + 2;  // input planes o0 - pad .. o0 - pad + outs + 1
  const int h0 = blockIdx.y * kFwdRows, w0 = blockIdx.x * kTileW;
  const int64_t hw = static_cast<int64_t>(H) * W;
  const T* xn = x + static_cast<int64_t>(n) * kCin * D_in * hw;
  for (int i = threadIdx.x; i < kWeights; i += blockDim.x) taps[i / 9 * 12 + i % 9] = to_f32(weight[i]);
  const float b = bias == nullptr ? 0.0f : to_f32(bias[0]);

  auto fill = [&](int s) {  // slice s = (input plane s / 8, channel s % 8)
    if (s < planes * kCin) {
      const int q = o0 - pad + s / kCin, c = s % kCin;
      fill_slice<T, kAligned, S>(ring + s % kFwdStages * S::kElems,
                                 q >= 0 && q < D_in ? xn + (static_cast<int64_t>(c) * D_in + q) * hw : nullptr, x,
                                 h0, w0, H, W);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kFwdStages - 1; ++s) fill(s);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp * kTY + lane / kTX) * kFwdNH, c0 = lane % kTX * kNW;  // the thread's outputs in the tile
  const bool active = h0 + r0 < H && w0 + c0 < W;
  float acc[3][kFwdNH][kNW] = {};  // output planes p (kd 0), p - 1 (kd 1), p - 2 (kd 2) of the chunk
  for (int p = 0; p < planes; ++p) {
    const int q = o0 - pad + p;
    for (int c = 0; c < kCin; ++c) {
      const int s = p * kCin + c;
      cp_async_wait<kFwdStages - 2>();  // slice s has landed
      __syncthreads();                  // for every thread, and slice s - 1's slot is free
      fill(s + kFwdStages - 1);
      if (!active || q < 0 || q >= D_in) continue;  // a padding plane adds nothing
      const T* rows = ring + s % kFwdStages * S::kElems + r0 * S::kPitch + S::kLead;
      float win[kFwdNH + 2][6];
#pragma unroll
      for (int i = 0; i < kFwdNH + 2; ++i) load_row(rows + i * S::kPitch, c0, win[i]);
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        if (p - kd < 0 || p - kd >= outs) continue;  // an output plane outside the chunk
        float t[9];
        load_taps(taps + (c * 3 + kd) * 12, t);
        stencil<kFwdNH>(t, win, acc[kd]);
      }
    }
    if (active && p >= 2) {
      store_rows<T, kAligned, kFwdNH>(y + (static_cast<int64_t>(n) * D_out + o0 + p - 2) * hw, h0 + r0, w0 + c0, H,
                                      W, acc[2], b);
    }
#pragma unroll
    for (int i = 0; i < kFwdNH; ++i) {
#pragma unroll
      for (int j = 0; j < kNW; ++j) {
        acc[2][i][j] = acc[1][i][j];
        acc[1][i][j] = acc[0][i][j];
        acc[0][i][j] = 0.0f;
      }
    }
  }
  cp_async_wait<0>();
}

// gx[n, c, q] = sum over (a, b, e) of g[n, 0, q + a - 2 + pad, h + b - 1, w + e
// - 1] w[c, 2 - a, 2 - b, 2 - e]: one output plane q at a time from the
// gradient planes q - 2 + pad .. q + pad, all 8 channels in registers.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kDgWarps * 32, 4)
prob_dgrad_kernel(const T* __restrict__ g, const T* __restrict__ weight, T* __restrict__ gx, int D_in, int D_out,
                  int H, int W, int pad, int chunk, int chunks) {
  using S = Slice<T, kDgRows, kDgNH>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* taps = reinterpret_cast<float*>(smem);  // [a][c][12], the taps flipped
  T* ring = reinterpret_cast<T*>(smem + kWeightBytes);
  const int n = blockIdx.z / chunks, q0 = blockIdx.z % chunks * chunk;
  const int outs = min(chunk, D_in - q0), planes = outs + 2;  // gradient planes q0 - 2 + pad + s
  const int h0 = blockIdx.y * kDgRows, w0 = blockIdx.x * kTileW;
  const int64_t hw = static_cast<int64_t>(H) * W;
  const T* gn = g + static_cast<int64_t>(n) * D_out * hw;
  for (int i = threadIdx.x; i < kWeights; i += blockDim.x) {
    const int c = i / 27, k = i % 27;
    taps[((2 - k / 9) * kCin + c) * 12 + 8 - k % 9] = to_f32(weight[i]);
  }

  auto fill = [&](int s) {
    if (s < planes) {
      const int o = q0 - 2 + pad + s;
      fill_slice<T, kAligned, S>(ring + s % kDgStages * S::kElems, o >= 0 && o < D_out ? gn + o * hw : nullptr, g,
                                 h0, w0, H, W);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kDgStages - 1; ++s) fill(s);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp * kTY + lane / kTX) * kDgNH, c0 = lane % kTX * kNW;
  const bool active = h0 + r0 < H && w0 + c0 < W;
  for (int qi = 0; qi < outs; ++qi) {
    cp_async_wait<kDgStages - 4>();  // slices qi .. qi + 2 have landed
    __syncthreads();                 // for every thread, and slice qi - 1's slot is free
    fill(qi + kDgStages - 1);
    if (!active) continue;
    float acc[kCin][kDgNH][kNW] = {};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int o = q0 - 2 + pad + qi + a;
      if (o < 0 || o >= D_out) continue;  // a padding plane adds nothing
      const T* rows = ring + (qi + a) % kDgStages * S::kElems + r0 * S::kPitch + S::kLead;
      float win[kDgNH + 2][6];
#pragma unroll
      for (int i = 0; i < kDgNH + 2; ++i) load_row(rows + i * S::kPitch, c0, win[i]);
#pragma unroll
      for (int c = 0; c < kCin; ++c) {
        float t[9];
        load_taps(taps + (a * kCin + c) * 12, t);
        stencil<kDgNH>(t, win, acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kCin; ++c) {
      store_rows<T, kAligned, kDgNH>(gx + ((static_cast<int64_t>(n) * kCin + c) * D_in + q0 + qi) * hw, h0 + r0,
                                     w0 + c0, H, W, acc[c], 0.0f);
    }
  }
  cp_async_wait<0>();
}

// The block's share of dw[c, kd, kh, kw] = sum of g[n, 0, o, h, w] x[n, c, o +
// kd - pad, h + kh - 1, w + kw - 1] and of dbias = sum of g, over its tile and
// D chunk: warp w computes the 27 sums of channels 2w and 2w + 1;
// part[k * blocks + block].
// Stage p holds input plane o0 - pad + p (8 slices) and gradient plane o0 + p.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kWgWarps * 32, 4)
prob_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part, int D_in, int D_out,
                  int H, int W, int pad, int chunk, int chunks) {
  using S = Slice<T, kWgRows, kWgNH>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int n = blockIdx.z / chunks, o0 = blockIdx.z % chunks * chunk;
  const int outs = min(chunk, D_out - o0), planes = outs + 2;
  const int h0 = blockIdx.y * kWgRows, w0 = blockIdx.x * kTileW;
  const int64_t hw = static_cast<int64_t>(H) * W;
  const T* xn = x + static_cast<int64_t>(n) * kCin * D_in * hw;
  const T* gn = g + static_cast<int64_t>(n) * D_out * hw;

  auto fill = [&](int p) {
    if (p < planes) {
      T* stage = ring + p % kWgStages * (kCin + 1) * S::kElems;
      const int q = o0 - pad + p;
      for (int c = 0; c < kCin; ++c) {
        fill_slice<T, kAligned, S>(stage + c * S::kElems,
                                   q >= 0 && q < D_in ? xn + (static_cast<int64_t>(c) * D_in + q) * hw : nullptr, x,
                                   h0, w0, H, W);
      }
      fill_slice<T, kAligned, S>(stage + kCin * S::kElems, p < outs ? gn + (o0 + p) * hw : nullptr, g, h0, w0, H, W);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p < kWgStages - 1; ++p) fill(p);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = lane / kTX * kWgNH, c0 = lane % kTX * kNW;
  float sums[kWgChannels][27] = {}, bsum = 0.0f;
  float gr[3][kWgNH][kNW] = {};  // gradient planes p (kd 0), p - 1 (kd 1), p - 2 (kd 2) of the chunk
  for (int p = 0; p < planes; ++p) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();
    fill(p + kWgStages - 1);
    const T* stage = ring + p % kWgStages * (kCin + 1) * S::kElems;
#pragma unroll
    for (int i = 0; i < kWgNH; ++i) {
      float v[6];
      load_row(stage + kCin * S::kElems + (r0 + 1 + i) * S::kPitch + S::kLead, c0, v);
#pragma unroll
      for (int j = 0; j < kNW; ++j) {
        gr[2][i][j] = gr[1][i][j];
        gr[1][i][j] = gr[0][i][j];
        gr[0][i][j] = v[j + 1];  // 0 past the chunk's last output plane (the slice is zero filled)
      }
    }
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < kWgNH; ++i) {
#pragma unroll
        for (int j = 0; j < kNW; ++j) bsum += gr[0][i][j];
      }
    }
    const int q = o0 - pad + p;
    if (q < 0 || q >= D_in) continue;  // a padding plane adds nothing
#pragma unroll
    for (int cc = 0; cc < kWgChannels; ++cc) {
      const T* rows = stage + (warp * kWgChannels + cc) * S::kElems + r0 * S::kPitch + S::kLead;
      float win[kWgNH + 2][6];
#pragma unroll
      for (int i = 0; i < kWgNH + 2; ++i) load_row(rows + i * S::kPitch, c0, win[i]);
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        if (p - kd < 0 || p - kd >= outs) continue;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            float s = sums[cc][kd * 9 + kh * 3 + kw];
#pragma unroll
            for (int i = 0; i < kWgNH; ++i) {
#pragma unroll
              for (int j = 0; j < kNW; ++j) s = fmaf(gr[kd][i][j], win[i + kh][j + kw], s);
            }
            sums[cc][kd * 9 + kh * 3 + kw] = s;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) bsum += __shfl_xor_sync(0xffffffffu, bsum, off);
  const int64_t blocks = static_cast<int64_t>(gridDim.x) * gridDim.y * gridDim.z;
  const int64_t block = (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
#pragma unroll
  for (int cc = 0; cc < kWgChannels; ++cc) {
    float mine = 0.0f;  // lane k keeps sum k
#pragma unroll
    for (int k = 0; k < 27; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sums[cc][k] += __shfl_xor_sync(0xffffffffu, sums[cc][k], off);
      mine = lane == k ? sums[cc][k] : mine;
    }
    if (lane < 27) part[((warp * kWgChannels + cc) * 27 + lane) * blocks + block] = mine;
  }
  if (warp == 0 && lane == 27) part[kWeights * blocks + block] = bsum;
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
  constexpr int kSmem = kWeightBytes + kFwdStages * Slice<T, kFwdRows, kFwdNH>::kBytes;
  static_assert(kSmem <= 48 * 1024, "the forward's ring must fit the default shared memory");
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
    constexpr int kSmem = kWeightBytes + kDgStages * Slice<T, kDgRows, kDgNH>::kBytes;
    static_assert(kSmem <= 48 * 1024, "the dgrad's ring must fit the default shared memory");
    prob_dgrad_kernel<T, kAligned><<<dim3(dplan[0], dplan[1], B * dplan[3]), kDgWarps * 32, kSmem, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(weight), static_cast<T*>(gx), D_in, D_out, H, W, pad,
        dplan[2], dplan[3]);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (dweight != nullptr) {
    constexpr int kSmem = kWgStages * (kCin + 1) * Slice<T, kWgRows, kWgNH>::kBytes;
    static_assert(kSmem <= 48 * 1024, "the wgrad's ring must fit the default shared memory");
    const dim3 grid(wplan[0], wplan[1], B * wplan[3]);
    prob_wgrad_kernel<T, kAligned><<<grid, kWgWarps * 32, kSmem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<float*>(part), D_in, D_out, H, W, pad,
        wplan[2], wplan[3]);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    prob_wgrad_finalize_kernel<T><<<dbias != nullptr ? kSums : kWeights, kFinalThreads, 0, s>>>(
        static_cast<const float*>(part), static_cast<int64_t>(grid.x) * grid.y * grid.z, static_cast<T*>(dweight),
        static_cast<T*>(dbias));
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

// FN<element type, 16-byte rows>(...): bf16 or f32, aligned or not.
#define PROB_DISPATCH(bf16, aligned, FN, ...)                                                                   \
  ((bf16) ? ((aligned) ? FN<__nv_bfloat16, true>(__VA_ARGS__) : FN<__nv_bfloat16, false>(__VA_ARGS__))            \
          : ((aligned) ? FN<float, true>(__VA_ARGS__) : FN<float, false>(__VA_ARGS__)))

// Plain C interface for ctypes. Pointers are device pointers; the caller has
// checked that x [B, 8, D_in, H, W], y and g [B, 1, D_out, H, W], gx (x's
// shape), the weight [1, 8, 3, 3, 3] and the bias [1] (or null) are
// contiguous and of one dtype (bf16 = 1: bf16, else f32), that D_out = D_in +
// 2 pad - 2 >= 1 with pad 0 or 1, and sets aligned only where W is a multiple
// of 16 bytes' values and every volume's address is 16-byte aligned. A plan is
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
