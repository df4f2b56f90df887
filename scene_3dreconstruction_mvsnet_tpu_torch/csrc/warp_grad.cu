// Gradient of the plane-sweep warp with respect to the source features, for
// Hopper (sm_90a), as a gather.
//
// Replaces the TPU kernel scene_3dreconstruction_mvsnet_tpu/ops/pallas/
// warp_grad.py::warp_grad_pallas (body _grad_kernel). The warp samples the
// source map [H, W, C] bilinearly at one coordinate per (depth plane d, ref
// pixel y, x); its transpose gives each source pixel (q, p) the sum, over the
// planes and the ref pixels whose sample has a tap on (q, p), of that tap's
// weight times the cotangent t[d, y, x, :]. The coordinates are constants: no
// gradient reaches the cameras or the depth hypotheses.
//
// Bound on this card: at the training recipe (D=192, 128x160x32) one (sample,
// source view) reads the f32 cotangent once (503 MB, 0.15 ms at 3.35 TB/s)
// and writes 2.6 MB; each sample is read by the up to 4 source pixels it taps,
// which sit side by side, so the rereads come from L1/L2.
//
// Design: the TPU kernel's gather form. One thread per (source pixel, group
// of 8 channels) keeps its sum in registers and writes it once with a plain
// store: no zeroing, no atomics, so the result is the same bit for bit from
// run to run. For each plane the thread maps the four corners (q +- 1,
// p +- 1) back through the plane's inverse pixel homography; the ref pixels
// whose sample has a tap on (q, p) are those whose coordinate lies in
// [q-1, q+1) x [p-1, p+1), and while the plane's map keeps the sign of its
// denominators (the wrapper's per-plane flag) they lie inside the corners'
// bounding box, here widened by a margin of one pixel against the rounding of
// the f32 maps (the JAX package's _support_bounds argument). For each
// candidate in the box it screens the coordinate with fast divides and, where
// it may hit, recomputes the forward coordinate with sweep_coords.cuh
// (pixel_ray, plane_coord, bilinear_taps: the code the sweep kernel gathered
// with) and adds only the weight of the tap that lands on (q, p), the
// forward's weight bit for bit. A plane whose flag is clear walks
// every ref pixel: slow, exact, and on no rig of this repository. On the
// model's width (C = 32) the 4 lanes of a pixel share the work: lane k maps
// corner k and tests every 4th candidate, the box passes by shuffle, and a
// ballot names each round's hits, whose weight and pixel pass by shuffle.
// The D planes are cut into kSlices fixed chunks, one per threadIdx.y, whose
// partial sums slice 0 adds in slice order; the grid takes every (sample,
// source view) pair of a step in one launch. The TPU
// kernel's GradPlan windows, pair-parity split, static envelopes and validity
// output answer Mosaic's 128-lane gather; a GPU thread loads from any address,
// so none of them is ported.

#include "sweep_coords.cuh"

namespace {

using sweep::kGroup;

constexpr int kPixelLanes = 64;  // (source pixel, group) lanes per block: threadIdx.x
constexpr int kSlices = 4;       // plane chunks per block: threadIdx.y

struct Box {
  int x0, x1, y0, y1;  // inclusive ref-pixel ranges
};

// The ref pixels that may sample (q, p) on a plane with inverse pixel
// homography m [9] (ref (x, y) = m (q', p', 1), source coordinates in
// grid_sample's pixel units): the bounding box of the four corners' images,
// widened by margin and cut to the image; the whole image when the plane's
// flag is clear or a corner's image is not finite. kLanes = 4: lane k maps
// corner k and the quad reduces by shuffle.
template <int kLanes>
__device__ __forceinline__ Box candidate_box(const float* m, bool ok, int q, int p, int W, int H, float margin,
                                             int lane, unsigned quad) {
  Box full{0, W - 1, 0, H - 1};
  if (!ok) return full;
  const float inf = __int_as_float(0x7f800000);
  float xmin = inf, xmax = -inf, ymin = inf, ymax = -inf;
  bool finite = true;
#pragma unroll
  for (int k = (kLanes == 4 ? lane : 0); k < 4; k += kLanes) {
    const float qc = static_cast<float>(q + ((k & 1) ? 1 : -1));
    const float pc = static_cast<float>(p + ((k & 2) ? 1 : -1));
    const float den = m[6] * qc + m[7] * pc + m[8];
    const float x = __fdividef(m[0] * qc + m[1] * pc + m[2], den);
    const float y = __fdividef(m[3] * qc + m[4] * pc + m[5], den);
    finite = finite && fabsf(x) < inf && fabsf(y) < inf;  // false for inf and NaN
    xmin = fminf(xmin, x);
    xmax = fmaxf(xmax, x);
    ymin = fminf(ymin, y);
    ymax = fmaxf(ymax, y);
  }
  if constexpr (kLanes == 4) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      xmin = fminf(xmin, __shfl_xor_sync(quad, xmin, off, 4));
      xmax = fmaxf(xmax, __shfl_xor_sync(quad, xmax, off, 4));
      ymin = fminf(ymin, __shfl_xor_sync(quad, ymin, off, 4));
      ymax = fmaxf(ymax, __shfl_xor_sync(quad, ymax, off, 4));
      finite = __shfl_xor_sync(quad, static_cast<int>(finite), off, 4) && finite;
    }
  }
  if (!finite) return full;
  Box box;
  box.x0 = static_cast<int>(ceilf(fmaxf(xmin - margin, 0.0f)));
  box.x1 = static_cast<int>(floorf(fminf(xmax + margin, static_cast<float>(W - 1))));
  box.y0 = static_cast<int>(ceilf(fmaxf(ymin - margin, 0.0f)));
  box.y1 = static_cast<int>(floorf(fminf(ymax + margin, static_cast<float>(H - 1))));
  return box;
}

// The weight of the forward's tap on (q, p) for ref pixel (x, y) on the plane
// at depth dep, or -1 when none of its taps lands there. A screen with fast
// divides (within a few ulps of the exact coordinate, far inside kScreenSlack)
// first drops the candidates whose coordinate misses [q-1, q+1) x [p-1, p+1);
// the others take the exact coordinate, and so the forward's weight.
constexpr float kScreenSlack = 1.0f / 16.0f;  // px

__device__ __forceinline__ float tap_weight(const float* hm, int x, int y, float dep, float inv_half_w,
                                            float inv_half_h, int W, int H, int q, int p) {
  const sweep::Ray ray = sweep::pixel_ray(hm, static_cast<float>(x), static_cast<float>(y));
  const float z = __fadd_rn(__fmul_rn(ray.z, dep), hm[11]);
  const float ax = __fdividef(__fadd_rn(__fmul_rn(ray.x, dep), hm[9]), z) * (0.5f * inv_half_w * W) - 0.5f;
  const float ay = __fdividef(__fadd_rn(__fmul_rn(ray.y, dep), hm[10]), z) * (0.5f * inv_half_h * H) - 0.5f;
  if (ax < q - 1 - kScreenSlack || ax >= q + 1 + kScreenSlack || ay < p - 1 - kScreenSlack ||
      ay >= p + 1 + kScreenSlack) {
    return -1.0f;  // a NaN coordinate passes, and bilinear_taps refuses it below
  }
  float ix, iy;
  sweep::plane_coord(ray, hm, dep, inv_half_w, inv_half_h, W, H, ix, iy);
  sweep::Taps tp;
  if (!sweep::bilinear_taps(ix, iy, W, H, tp)) return -1.0f;
  const int dx = q - tp.x0;
  const int dy = p - tp.y0;
  if ((dx != 0 && dx != 1) || (dy != 0 && dy != 1)) return -1.0f;
  return dy == 0 ? (dx == 0 ? tp.w_nw : tp.w_ne) : (dx == 0 ? tp.w_sw : tp.w_se);
}

__device__ __forceinline__ void add_weighted(const float* p, float w, float (&acc)[kGroup]) {
  float v[kGroup];
  sweep::load_group(p, v);
#pragma unroll
  for (int i = 0; i < kGroup; ++i) acc[i] = fmaf(v[i], w, acc[i]);
}

// t [N, D, H, W, C] f32 cotangents of N (sample, source view) pairs' warped
// volumes; homography [N, 12] (R row-major, then t, of src_proj @
// inv(ref_proj)); inv_maps [N, D, 9] and ok [N, D] from the wrapper; depth
// [N, D] -> out: pair n's dsrc [H, W, C] at out + (n / pairs) * group_stride +
// (n % pairs) * pair_stride. Block (kPixelLanes, kSlices), grid (pixel
// blocks, N).
template <typename TO, int kLanes>
__global__ void __launch_bounds__(kPixelLanes * kSlices)
warp_grad_kernel(const float* __restrict__ t, const float* __restrict__ homography,
                 const float* __restrict__ inv_maps, const unsigned char* __restrict__ ok,
                 const float* __restrict__ depth, TO* __restrict__ out, int pairs, int64_t group_stride,
                 int64_t pair_stride, int D, int H, int W, int C, float margin) {
  __shared__ float hm[12];
  __shared__ float partial[kSlices - 1][kPixelLanes][kGroup];
  const int n = blockIdx.y;
  const int tid = threadIdx.y * kPixelLanes + threadIdx.x;
  if (tid < 12) hm[tid] = __ldg(homography + n * 12 + tid);
  __syncthreads();

  const int groups = C / kGroup;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kPixelLanes + threadIdx.x;
  const bool active = idx < plane * groups;  // with kLanes = 4, a pixel's quad is active or not as one
  float acc[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) acc[i] = 0.0f;
  int64_t pix = 0;
  int c0 = 0;
  if (active) {
    c0 = static_cast<int>(idx % groups) * kGroup;
    pix = idx / groups;
    const int q = static_cast<int>(pix % W);
    const int p = static_cast<int>(pix / W);
    const int lane = kLanes == 4 ? (threadIdx.x & 3) : 0;
    const unsigned quad = 0xFu << (threadIdx.x & 28);
    const float inv_half_w = sweep::inv_half_extent(W);
    const float inv_half_h = sweep::inv_half_extent(H);
    const int chunk = (D + kSlices - 1) / kSlices;
    const int d0 = threadIdx.y * chunk;
    const int d1 = min(D, d0 + chunk);
    for (int d = d0; d < d1; ++d) {
      const int64_t nd = static_cast<int64_t>(n) * D + d;
      float m[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) m[i] = __ldg(inv_maps + nd * 9 + i);
      const Box box = candidate_box<kLanes>(m, __ldg(ok + nd) != 0, q, p, W, H, margin, lane, quad);
      const int nx = box.x1 - box.x0 + 1;
      const int ncand = nx * (box.y1 - box.y0 + 1);
      if (box.x1 < box.x0 || ncand <= 0) continue;
      const float dep = __ldg(depth + nd);
      const float* t_plane = t + nd * plane * C + c0;
      // this lane's candidate: the lane-th of the box in row-major order, then every kLanes-th
      int cx = box.x0 + lane, cy = box.y0;
      while (cx > box.x1) {
        cx -= nx;
        ++cy;
      }
      for (int base = 0; base < ncand; base += kLanes) {
        float w = -1.0f;
        int off = 0;
        if (base + lane < ncand) {
          w = tap_weight(hm, cx, cy, dep, inv_half_w, inv_half_h, W, H, q, p);
          off = cy * W + cx;
        }
        cx += kLanes;
        while (cx > box.x1) {
          cx -= nx;
          ++cy;
        }
        if constexpr (kLanes == 4) {
          // the quad's hits of this round, then each hit's weight and pixel from its lane
          unsigned hits = (__ballot_sync(quad, w >= 0.0f) >> (threadIdx.x & 28)) & 0xFu;
          while (hits) {
            const int j = __ffs(hits) - 1;
            hits &= hits - 1;
            const float wj = __shfl_sync(quad, w, j, 4);
            const int oj = __shfl_sync(quad, off, j, 4);
            add_weighted(t_plane + static_cast<int64_t>(oj) * C, wj, acc);
          }
        } else if (w >= 0.0f) {
          add_weighted(t_plane + static_cast<int64_t>(off) * C, w, acc);
        }
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
  sweep::store_group(out + (n / pairs) * group_stride + (n % pairs) * pair_stride + pix * C + c0, acc);
}

template <typename TO>
int launch(const void* t, const void* homography, const void* inv_maps, const void* ok, const void* depth,
           void* out, int pairs, int64_t group_stride, int64_t pair_stride, int N, int D, int H, int W, int C,
           float margin, cudaStream_t stream) {
  const int64_t lanes = static_cast<int64_t>(H) * W * (C / kGroup);
  const dim3 grid(static_cast<unsigned>((lanes + kPixelLanes - 1) / kPixelLanes), static_cast<unsigned>(N));
  const dim3 block(kPixelLanes, kSlices);
  const float* tp = static_cast<const float*>(t);
  const float* hm = static_cast<const float*>(homography);
  const float* im = static_cast<const float*>(inv_maps);
  const unsigned char* okp = static_cast<const unsigned char*>(ok);
  const float* dv = static_cast<const float*>(depth);
  TO* o = static_cast<TO*>(out);
  if (C == 4 * kGroup) {
    warp_grad_kernel<TO, 4><<<grid, block, 0, stream>>>(tp, hm, im, okp, dv, o, pairs, group_stride, pair_stride, D,
                                                        H, W, C, margin);
  } else {
    warp_grad_kernel<TO, 1><<<grid, block, 0, stream>>>(tp, hm, im, okp, dv, o, pairs, group_stride, pair_stride, D,
                                                        H, W, C, margin);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; the caller has
// checked shapes, dtypes, contiguity, 16-byte alignment and C % 8 == 0. out
// is f32 or bf16 (out_bf16) and receives every element of every pair's dsrc.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int warp_grad_launch(const void* t, const void* homography, const void* inv_maps, const void* ok,
                                const void* depth, void* out, int out_bf16, int pairs, int64_t group_stride,
                                int64_t pair_stride, int N, int D, int H, int W, int C, float margin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(t, homography, inv_maps, ok, depth, out, pairs, group_stride, pair_stride,
                                          N, D, H, W, C, margin, s)
                  : launch<float>(t, homography, inv_maps, ok, depth, out, pairs, group_stride, pair_stride, N, D,
                                  H, W, C, margin, s);
}

extern "C" const char* warp_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
