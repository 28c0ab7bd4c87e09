// Multilevel ROIAlignV2 backward (feature gradient) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// omni3d_tpu/ops/roi_align_bwd_pallas.py::roi_align_bwd_pallas, which
// computes the same function: the transpose of the forward pooling
// (roi_align_fwd.cu) for given per-box levels. Per box it is separable,
// dF = Ay^T G Ax (roi_align_common.cuh), and the TPU kernel's one idea that
// carries over is that the gradient is accumulated resident in fast memory
// and written once, never read-modify-written in device memory. The TPU did
// that with one sequential grid per image over a VMEM plane of the whole
// image; here blocks run in parallel, so a block owns one tile of one
// image-level's gradient and walks the boxes that touch it.
//
// What bounds it on the H100: bytes, g read once and the pyramid gradient
// written once. The first port splatted every sample's four taps into a
// zeroed float32 accumulator with 128-bit atomicAdd (~1e9 vector atomics at
// 32 x 640 RoIs x 256 channels, resolved in L2), and its wrapper zeroed that
// 715 MB accumulator and cast it to bf16 afterwards: two passes over the
// pyramid that alone cost about the kernel's whole bound, and sums in a
// different order on every run.
//
// The design: output-stationary tiles, no atomics. One block per (image,
// level, 16 x 16 cell tile, 64-channel tile); thread (x, group) owns tile
// column x for 4 channels, its 16 float32 cells in registers.
//   1. The block scans its image's boxes (contiguous in the flat layout) 256
//      at a time: a box routed to another level, or whose extent surely
//      misses the tile (may_touch), is dropped; the rest are compacted in box
//      order with warp ballots into a list in shared memory, with their
//      coordinates.
//   2. The list is a three-stage pipeline, one barrier per box: while box k
//      is added, box k + 1's tile windows Ay, Ax are summed from its sample
//      taps (one thread per window cell) and box k + 2's g slice (P x P bins
//      x 64 channels) is copied into shared memory with cp.async and its
//      taps computed (one thread per sample).
//   3. Adding box k: each thread forms T[py, x] = sum_px Ax[px, x] g[py, px]
//      over the bins whose band reaches its column, in registers, then
//      acc[y, x] += Ay[py, y] T[py, x] over the rows of Ay[py] in the tile.
//   4. The tile is written once, in the features' dtype; a tile no box
//      touches is written as zeros.
// Every gradient cell is written exactly once, by one block, which adds its
// boxes in index order: the result is the same bit for bit on every run. The
// wrapper allocates the outputs with torch.empty: no zeroing, no cast pass.
// What it pays instead: g is read once per tile and channel tile a box
// touches, and per-box work (taps, windows, a barrier) repeats in each.
// Tensor cores do not pay here: the contraction depth is P = 7, and the
// bands are sparse.
//
// The kernel allocates nothing and does not synchronise. The C entry point
// returns the first CUDA error of the launch.

#include "roi_align_common.cuh"

namespace {

using namespace roi_align;

constexpr int kTile = 16;        // cells per axis of a gradient tile (GRAD_TILE)
constexpr int kBlock = 256;      // threads per block: one per (tile column, channel group)
constexpr int kCT = 64;          // channels per block
constexpr int kCG = kCT / 4;     // 4-channel groups
constexpr int kWarps = kBlock / 32;
constexpr int kRing = 3;         // g slices staged: the box being added and two ahead
static_assert(kBlock == kCG * kTile, "a thread per (tile column, channel group)");
static_assert(kBlock >= 2 * kMaxBins * kTile, "a thread per (axis, bin, window cell)");
static_assert(kBlock >= kTapThreads, "a thread per (axis, bin, sample)");

// 16-byte copy from global to shared memory that does not wait (cp.async).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 4 channels between shared memory and float registers.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}

struct Grid {
  void* out[kMaxLevels];         // (B, H_l, W_l, C) gradient of level l
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];       // 1 / stride
  int tiles_x[kMaxLevels];       // tiles per row of level l
  int tile_start[kMaxLevels];    // first tile of level l within an image
  int n_levels;
  int tiles_per_image;
};

size_t bwd_smem(int P, size_t elem) {
  return kRing * static_cast<size_t>(P) * P * kCT * elem;   // g slices [ring][bin][kCT]
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 2)
roi_align_bwd_kernel(Grid gd, const float* __restrict__ boxes, const int* __restrict__ levels,
                     int n_per_image, const T* __restrict__ grad, int C, int P, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* gs = reinterpret_cast<T*>(smem);              // [ring][P * P][kCT]
  __shared__ BoxTaps taps[2];                      // by parity of the box in the list
  __shared__ float aw[2][2][kMaxBins][kTile];       // [parity][axis][bin][tile cell]
  __shared__ int rng[2][2][kMaxBins][2];           // nonzero cells of each row in the tile
  __shared__ int cand[kBlock];
  __shared__ float4 cand_box[kBlock];
  __shared__ int warp_n[kWarps];

  const int tid = threadIdx.x;
  int r = blockIdx.x;
  const int b = r / gd.tiles_per_image;
  r -= b * gd.tiles_per_image;
  int l = 0;
  while (l + 1 < gd.n_levels && r >= gd.tile_start[l + 1]) ++l;
  r -= gd.tile_start[l];
  const int H = gd.h[l], W = gd.w[l];
  const int ty0 = (r / gd.tiles_x[l]) * kTile, tx0 = (r % gd.tiles_x[l]) * kTile;
  const float scale = gd.scale[l];
  const int c_base = blockIdx.y * kCT;
  const int x = tid / kCG, cg = tid % kCG;     // this thread's tile column and channels
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int E = 16 / sizeof(T);            // channels per 16-byte vector
  constexpr int kVec = kCT / E;                // 16-byte vectors of g per bin
  const int vec_valid = min(kCT, C - c_base) / E;

  // Box k of the list is prepared over two iterations: fetch copies its g
  // slice (cp.async into buffer k % kRing, waited for later) and computes
  // its sample taps into taps[k & 1]; after the next barrier, windows turns
  // those taps into its tile windows aw[k & 1] and their spans rng[k & 1].
  auto fetch = [&](int k) {
    const T* gp = grad + static_cast<size_t>(cand[k]) * P * P * C + c_base;
    T* dst = gs + (k % kRing) * P * P * kCT;
    for (int v = tid; v < P * P * kVec; v += kBlock) {
      const int j = v % kVec, bin = v / kVec;
      if (j < vec_valid) cp_async16(dst + bin * kCT + j * E, gp + static_cast<size_t>(bin) * C + j * E);
    }
    cp_async_commit();
    sample_taps(reinterpret_cast<const float*>(&cand_box[k]), scale, P, S, H, W, tid, taps[k & 1]);
  };
  auto windows = [&](int k) {
    if (tid < 2 * kMaxBins * kTile) {
      const int axis = tid / (kMaxBins * kTile), p = tid / kTile % kMaxBins, j = tid % kTile;
      aw[k & 1][axis][p][j] = cell_weight(taps[k & 1][axis][p], (axis ? tx0 : ty0) + j);
    }
    if (tid < 2 * kMaxBins) {
      const int ax = tid / kMaxBins, q = tid % kMaxBins;
      row_span(taps[k & 1][ax][q], ax ? tx0 : ty0, kTile, &rng[k & 1][ax][q][0],
               &rng[k & 1][ax][q][1]);
    }
  };

  float acc[kTile][4];
#pragma unroll
  for (int y = 0; y < kTile; ++y)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[y][j] = 0.0f;

  for (int base = 0; base < n_per_image; base += kBlock) {
    const int i = base + tid;
    const int bi = b * n_per_image + i;
    bool hit = false;
    float4 bx = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < n_per_image && levels[bi] == l) {
      bx = *reinterpret_cast<const float4*>(boxes + 4 * bi);
      const float* bp = reinterpret_cast<const float*>(&bx);
      hit = may_touch(box_axis(bp, scale, P, S, 0), ty0, kTile) &&
            may_touch(box_axis(bp, scale, P, S, 1), tx0, kTile);
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (hit) {
      off += __popc(m & ((1u << lane) - 1u));
      cand[off] = bi;
      cand_box[off] = bx;
    }
    __syncthreads();

    // Pipeline: while box k is added, box k + 1's windows are built and box
    // k + 2's g slice and taps are fetched.
    for (int k = 0; k < min(total, 2); ++k) fetch(k);
    __syncthreads();
    if (total > 0) windows(0);
    for (int k = 0; k < total; ++k) {
      if (k + 1 < total) {
        cp_async_wait_one();      // box k's g slice copied; box k + 1's may still fly
      } else {
        cp_async_wait_all();
      }
      __syncthreads();            // box k ready; every thread done with box k - 1
      if (k + 2 < total) fetch(k + 2);
      if (k + 1 < total) windows(k + 1);
      // dF[y][x] += sum_py Ay[py][y] sum_px Ax[px][x] g[py][px], for this
      // thread's column x: T[py][x] in registers, then the rows of Ay[py].
      const int wb = k & 1;
      int pa = P, pb = -1;        // the bins whose x band reaches column x
      for (int q = 0; q < P; ++q) {
        if (rng[wb][1][q][0] <= x && x <= rng[wb][1][q][1]) {
          pa = min(pa, q);
          pb = q;
        }
      }
      const T* g = gs + (k % kRing) * P * P * kCT + cg * 4;
      for (int py = 0; py < P && pa <= pb; ++py) {
        const int ya = rng[wb][0][py][0], yb = rng[wb][0][py][1];
        if (ya > yb) continue;
        float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int px = pa; px <= pb; ++px) {
          const float w = aw[wb][1][px][x];
          float v[4];
          load4(g + (py * P + px) * kCT, v);
#pragma unroll
          for (int j = 0; j < 4; ++j) t[j] = fmaf(w, v[j], t[j]);
        }
#pragma unroll
        for (int y4 = 0; y4 < kTile; y4 += 4) {   // skip the quarters the rows miss
          if (y4 > yb || y4 + 3 < ya) continue;
#pragma unroll
          for (int y = y4; y < y4 + 4; ++y) {
            if (y >= ya && y <= yb) {
              const float w = aw[wb][0][py][y];
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[y][j] = fmaf(w, t[j], acc[y][j]);
            }
          }
        }
      }
    }
    __syncthreads();              // the list and the buffers are free again
  }

  if (tx0 + x < W && c_base + cg * 4 < C) {
    T* op = static_cast<T*>(gd.out[l])
            + ((static_cast<size_t>(b) * H + ty0) * W + tx0 + x) * C + c_base + cg * 4;
#pragma unroll
    for (int y = 0; y < kTile; ++y) {
      if (ty0 + y < H) store4(op + static_cast<size_t>(y) * W * C, acc[y]);
    }
  }
}

template <typename T>
cudaError_t launch(const Grid& gd, int n_images, const float* boxes, const int* levels,
                   int n_per_image, const void* grad, int C, int P, int S, cudaStream_t s) {
  const size_t smem = bwd_smem(P, sizeof(T));
  const cudaError_t err = allow_smem(roi_align_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_images * gd.tiles_per_image, (C + kCT - 1) / kCT);
  roi_align_bwd_kernel<T><<<grid, kBlock, smem, s>>>(
      gd, boxes, levels, n_per_image, static_cast<const T*>(grad), C, P, S);
  return cudaGetLastError();
}

}  // namespace

// Writes the feature gradient of n_images x n_per_image pooled boxes (image
// b's boxes at flat rows [b * n_per_image, (b + 1) * n_per_image)) into
// level_out[l], every level's (n_images, H_l, W_l, C) gradient in the dtype
// of grad, each element exactly once. grad is (boxes, P, P, C) float32 or
// bfloat16; boxes (boxes, 4) f32 and levels (boxes,) int32 are device
// pointers; level_out/level_h/level_w/level_scale are host arrays of
// n_levels entries. C must be a multiple of 4 (f32) or 8 (bf16), every
// pointer 16-byte aligned, 1 <= P <= 8 and 0 <= S <= 9; the Python
// wrapper checks all four.
extern "C" int roi_align_bwd(void* const* level_out, const int* level_h, const int* level_w,
                             const float* level_scale, int n_levels, const float* boxes,
                             const int* levels, int n_images, int n_per_image,
                             const void* grad, int channels, int out_size,
                             int sampling_ratio, int is_bf16, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_images < 1 || n_per_image < 1 ||
      out_size < 1 || out_size > kMaxBins || sampling_ratio < 0 || sampling_ratio > kSmax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Grid gd = {};
  gd.n_levels = n_levels;
  int tiles = 0;
  for (int i = 0; i < n_levels; ++i) {
    gd.out[i] = level_out[i];
    gd.h[i] = level_h[i];
    gd.w[i] = level_w[i];
    gd.scale[i] = level_scale[i];
    gd.tiles_x[i] = (level_w[i] + kTile - 1) / kTile;
    gd.tile_start[i] = tiles;
    tiles += gd.tiles_x[i] * ((level_h[i] + kTile - 1) / kTile);
  }
  gd.tiles_per_image = tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(gd, n_images, boxes, levels, n_per_image, grad,
                                      channels, out_size, sampling_ratio, s)
              : launch<float>(gd, n_images, boxes, levels, n_per_image, grad, channels,
                              out_size, sampling_ratio, s);
  return static_cast<int>(err);
}
