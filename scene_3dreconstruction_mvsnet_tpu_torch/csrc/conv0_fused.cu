// CostRegNet conv0 (3x3x3, 32 -> 8 channels, stride 1, zero padding 1) with
// eval-mode BatchNorm folded to a per-channel scale and bias, and ReLU, for
// Hopper (sm_90a): an implicit GEMM on the tensor cores that streams along D.
//
// Replaces the TPU kernel scene_3dreconstruction_mvsnet_tpu/ops/pallas/
// conv0_fused.py::conv0_bn_relu_fused (body _kernel). It reads the
// channels-last bf16 cost volume [B, D, H, W, 32] that the sweep-variance
// kernel writes and writes conv0's activation channels-last too, [B, D, H, W,
// 8] in bf16 (NDHWC, the layout CostRegNet's conv1 and its decoder's last skip
// take), so the cost volume is never permuted and the conv result never
// round-trips to device memory before BatchNorm and ReLU.
//
// Bound on this card, counted from the shapes: at the inference headline
// ([1, 192, 216, 288, 32]) the kernel must read 764 MB and write 191 MB
// (0.29 ms at 3.35 TB/s) and does 27 x 32 x 8 = 6912 multiply-adds per output
// voxel, 165 GFLOP in all (0.17 ms at the tensor cores' 989 TFLOP/s in bf16),
// so memory bounds it. Outside the tensor cores the same multiply-adds would
// take at least 2.5 ms at the card's 67 TFLOP/s in f32.
//
// Design: the GEMM is M = output voxels, N = 8 output channels, K = 27 taps x
// 32 input channels = 864, on mma.sync.m16n8k16 (bf16 in, f32 sums). A block
// owns an 8 x 32 (y, x) tile of output voxels with all 8 channels and a chunk
// of depth planes (blockIdx.y; the chunk comes from the wrapper's launch
// geometry). It streams the input planes d0-1 .. d1 once each through a ring
// of three shared-memory slots, each the tile with its one-voxel halo
// (10 x 34 x 32 bf16, 21.8 KB), filled by 16-byte cp.async whose zero fill
// is the conv's zero padding; the next plane's copy overlaps the current
// plane's products. Each input plane is multiplied once by the three kd
// slices of the weights into three rolling accumulators (output planes p+1,
// p, p-1), so an A fragment is loaded once for three products; output plane
// p-1 is complete after input plane p and goes to the epilogue. Warp w
// computes output row w of the tile, two m16 fragments of 16 voxels, A
// fragments by ldmatrix.x4 straight from the halo tile at the tap's shift.
// Voxel rows are 64 bytes, so 16-byte chunk c of voxel v sits at chunk
// c ^ ((v >> 1) & 3): any 8 consecutive voxels then fall on 8 distinct bank
// quads and ldmatrix runs without conflicts. The weights sit once per block
// in shared memory as bf16 B fragments in the order the mma reads them
// (13.8 KB, one 8-byte load per lane and k-step). Epilogue: the folded
// BatchNorm as one multiply and one add, each rounded as the plain version
// rounds them, ReLU (NaN stays NaN, as torch.relu), one bf16 rounding, then a
// pass through shared memory that gathers each voxel's 8 channels, stored as
// one 16-byte store a voxel. The products are exact in f32; only the order of the f32 sums
// differs from the plain version's. The TPU kernel's band-Toeplitz weights,
// wide lane packing and D-streaming carry buffers answer the MXU's
// 128 x 128 tiles and its sequential grid; none of them is ported.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCi = 32;
constexpr int kCo = 8;
constexpr int kTileH = 8;   // output rows of a block, one warp each
constexpr int kTileW = 32;  // output voxels of a row, two m16 fragments
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloVoxels = (kTileH + 2) * kHaloW;
constexpr int kPlaneBytes = kHaloVoxels * kCi * 2;  // one ring slot
constexpr int kSlots = 3;
constexpr int kKSteps = 27 * 2;  // (tap, half of the input channels)
constexpr int kWeightBytes = kKSteps * 32 * 8;
constexpr int kStageBytes = kTileH * kCo * kTileW * 2;  // the epilogue's transpose
constexpr int kSmemBytes = kSlots * kPlaneBytes + kWeightBytes + kStageBytes;
constexpr int kThreads = kTileH * 32;

// byte offset of 16-byte chunk c (channels 8c .. 8c+7) of halo voxel v
__device__ __forceinline__ uint32_t voxel_chunk(int v, int c) {
  return static_cast<uint32_t>(v * 64 + ((c ^ ((v >> 1) & 3)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 products summed in f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

struct Conv0 {
  const __nv_bfloat16* xb;  // this sample's [D, H, W, 32]
  __nv_bfloat16* out;       // [B, D, H, W, 8]
  const uint2* w_s;         // [27 taps][2 halves][32 lanes] B fragments
  __nv_bfloat16* stage;     // this warp's [32][8] epilogue tile: the row's voxels
  uint32_t ring;            // shared address of slot 0
  int b, D, H, W, ty0, tx0, d0, d1, warp, lane;
  float scale[2], bias[2];  // of output channels 2 (lane % 4) and + 1

  // start the copy of input plane p (halo tile) into ring slot `slot`
  __device__ __forceinline__ void load_plane(int slot, int p) const {
    if (p < 0 || p >= D) return;
    const uint32_t base = ring + slot * kPlaneBytes;
    for (int i = threadIdx.x; i < kHaloVoxels * 4; i += kThreads) {
      const int v = i >> 2, c = i & 3;
      const int hy = v / kHaloW;
      const int y = ty0 + hy - 1, x = tx0 + (v - hy * kHaloW) - 1;
      const bool ok = y >= 0 && y < H && x >= 0 && x < W;
      const __nv_bfloat16* src = ok ? xb + ((static_cast<int64_t>(p) * H + y) * W + x) * kCi + c * 8 : xb;
      cp_async16(base + voxel_chunk(v, c), src, ok);
    }
  }

  // input plane p in ring slot `slot` times the kd slices of the weights, into
  // the accumulators of output planes p+1 (kd 0), p (kd 1) and p-1 (kd 2)
  __device__ __forceinline__ void multiply(int slot, float (&acc0)[2][4], float (&acc1)[2][4],
                                           float (&acc2)[2][4], bool use0, bool use1, bool use2) const {
    const uint32_t base = ring + slot * kPlaneBytes;
    const int row = (lane & 7) + ((lane >> 3) & 1) * 8;  // the A row this lane addresses
    const int half_k = lane >> 4;                        // and its 8-channel half of k
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int v = (warp + kh) * kHaloW + mt * 16 + row + kw;
            ldmatrix_x4(a[mt], base + voxel_chunk(v, 2 * h + half_k));
          }
          const int ks = (kh * 3 + kw) * 2 + h;
          if (use0) {
            const uint2 bw = w_s[ks * 32 + lane];
            mma_bf16(acc0[0], a[0], bw);
            mma_bf16(acc0[1], a[1], bw);
          }
          if (use1) {
            const uint2 bw = w_s[(18 + ks) * 32 + lane];
            mma_bf16(acc1[0], a[0], bw);
            mma_bf16(acc1[1], a[1], bw);
          }
          if (use2) {
            const uint2 bw = w_s[(36 + ks) * 32 + lane];
            mma_bf16(acc2[0], a[0], bw);
            mma_bf16(acc2[1], a[1], bw);
          }
        }
      }
    }
  }

  // BN, ReLU and bf16 of output plane q's row ty0 + warp; zeroes acc
  __device__ __forceinline__ void store_plane(float (&acc)[2][4], int q) const {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = i & 1;
        const int x = mt * 16 + (lane >> 2) + (i >> 1) * 8;
        float v = __fadd_rn(__fmul_rn(acc[mt][i], scale[j]), bias[j]);
        v = v < 0.0f ? 0.0f : v;
        stage[x * kCo + (lane & 3) * 2 + j] = __float2bfloat16_rn(v);
        acc[mt][i] = 0.0f;
      }
    }
    __syncwarp();
    const int y = ty0 + warp, x = tx0 + lane;  // lane x stores voxel x's 8 channels, one 16-byte store
    if (y < H && x < W) {
      __nv_bfloat16* dst = out + (((static_cast<int64_t>(b) * D + q) * H + y) * W + x) * kCo;
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(stage + lane * kCo);
    }
    __syncwarp();
  }

  // input plane p = d0 - 1 + r, ring slot r % 3 == J; acc[s] holds output
  // plane d0 - 1 + s' with s' % 3 == s
  template <int J>
  __device__ __forceinline__ void step(int r, float (&acc)[3][2][4]) const {
    cp_async_wait<1>();  // plane r has landed (plane r + 1 may be in flight)
    __syncthreads();     // ... for every thread, and slot (r + 2) % 3 is free
    if (r + 2 < d1 - d0 + 2) load_plane((J + 2) % 3, d0 + 1 + r);
    cp_async_commit();
    const int p = d0 - 1 + r;
    if (p >= 0 && p < D) {
      multiply(J, acc[(J + 1) % 3], acc[J], acc[(J + 2) % 3], p + 1 >= d0 && p + 1 < d1, p >= d0 && p < d1,
               p - 1 >= d0 && p - 1 < d1);
    }
    if (p - 1 >= d0 && p - 1 < d1) store_plane(acc[(J + 2) % 3], p - 1);
  }
};

// x [B, D, H, W, 32] bf16, weight: [27 taps][2 halves][32 lanes] mma B
// fragments (uint2 of 4 bf16; tap = (kd * 3 + kh) * 3 + kw), scale/bias [8]
// f32 (folded BatchNorm) -> out [B, D, H, W, 8] bf16. blockIdx.x: (b, tile y,
// tile x); blockIdx.y: chunk of d_chunk output planes.
__global__ void __launch_bounds__(kThreads, 2)
conv0_fused_kernel(const __nv_bfloat16* __restrict__ x, const uint2* __restrict__ weight,
                   const float* __restrict__ scale, const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                   int D, int H, int W, int tiles_x, int tiles_y, int d_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  Conv0 k;
  k.warp = threadIdx.x >> 5;
  k.lane = threadIdx.x & 31;
  uint2* w_s = reinterpret_cast<uint2*>(smem + kSlots * kPlaneBytes);
  for (int i = threadIdx.x; i < kKSteps * 32; i += kThreads) w_s[i] = __ldg(weight + i);
  k.w_s = w_s;
  k.stage = reinterpret_cast<__nv_bfloat16*>(smem + kSlots * kPlaneBytes + kWeightBytes) + k.warp * kCo * kTileW;
  k.ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    k.scale[j] = __ldg(scale + (k.lane & 3) * 2 + j);
    k.bias[j] = __ldg(bias + (k.lane & 3) * 2 + j);
  }
  int t = blockIdx.x;
  k.tx0 = (t % tiles_x) * kTileW;
  t /= tiles_x;
  k.ty0 = (t % tiles_y) * kTileH;
  k.b = t / tiles_y;
  k.D = D;
  k.H = H;
  k.W = W;
  k.d0 = blockIdx.y * d_chunk;
  k.d1 = min(D, k.d0 + d_chunk);
  k.xb = x + static_cast<int64_t>(k.b) * D * H * W * kCi;
  k.out = out;

  // input planes d0 - 1 .. d1: two in flight before the first product
  k.load_plane(0, k.d0 - 1);
  cp_async_commit();
  k.load_plane(1, k.d0);
  cp_async_commit();
  float acc[3][2][4];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][mt][i] = 0.0f;
  const int n_in = k.d1 - k.d0 + 2;
  for (int r = 0; r < n_in; r += 3) {
    k.step<0>(r, acc);
    if (r + 1 < n_in) k.step<1>(r + 1, acc);
    if (r + 2 < n_in) k.step<2>(r + 2, acc);
  }
  cp_async_wait<0>();
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; the caller has
// checked shapes, dtypes, contiguity and 16-byte alignment, and laid the
// weights out as mma fragments. tiles_x, tiles_y, d_chunk: the launch
// geometry (ops/kernels/conv0_fused.py::launch_geometry). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int conv0_fused_launch(const void* x, const void* weight, const void* scale, const void* bias,
                                  void* out, int B, int D, int H, int W, int tiles_x, int tiles_y, int d_chunk,
                                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(conv0_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * tiles_y * tiles_x), static_cast<unsigned>((D + d_chunk - 1) / d_chunk));
  conv0_fused_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint2*>(weight), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), D, H, W, tiles_x, tiles_y, d_chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conv0_fused_smem_bytes() { return kSmemBytes; }

extern "C" const char* conv0_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
