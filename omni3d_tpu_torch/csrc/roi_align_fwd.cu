// Multilevel ROIAlignV2 forward (aligned=True) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernels
// omni3d_tpu/ops/roi_align_pallas.py::_pool_resident and ::_pool_dma, which
// compute the same function: each box is pooled from one FPN level by
// bilinear sampling on a P x P grid of bins with S x S samples per bin
// (S fixed, or adaptive ceil(extent / P) per axis clamped to SMAX = 9), a bin
// being the mean of its samples. The level of each box is an input: the
// caller routes boxes (canonical detectron2 levels, or the TPU kernel's
// bumped "fit" levels). Semantics follow omni3d_tpu/ops/roi_align.py, the
// XLA oracle, and the plain PyTorch version in ops/roi_align.py.
//
// What bounds it on the H100: bytes. The function must read the pyramid
// cells the boxes touch and write the pooled bins, a few operations per
// byte. The first port read four taps per sample (some 1,800 16-byte rows
// per box at the training batch's boxes, against ~400 distinct cells) and
// recomputed the sample geometry in every thread.
//
// The design: one block per (box, 32 16-byte channel vectors: 256 bf16 or
// 128 f32 channels), box-stationary.
//   1. The block builds the box's per-axis bands once, in parallel
//      (roi_align_common.cuh): one thread per sample computes its taps, one
//      thread per band cell sums its weight into Ay or Ax in shared memory.
//   2. Warps take bins, lanes take 16-byte channel vectors. For bin (py, px)
//      a lane runs the two banded passes over the rows of Ay[py]:
//      T[y, px] = sum_x Ax[px, x] F[y, x] over the bin's band columns, two
//      loads in flight, then out[py, px] += Ay[py, y] T[y, px], in float32
//      registers, and rounds the bin once to the features' dtype. Each bin
//      reads each cell of its band product once (~16 rows per bin at
//      canonical routing, against ~36 taps), and no thread computes geometry.
//   3. A grid of fewer than four waves of 8-warp blocks (the cube pooler's
//      100 boxes per image, a batch-1 box pooler) lasts about as long as its
//      slowest box, so there a block spreads its box's bins over 16 warps.
// A variant that copied each box's footprint into shared memory with
// cp.async (in windows, a block barrier per window) and pooled it from
// there measured slower on the H100 than this barrier-free form: its
// barriers and copy round trips cost more than the L1 hits it replaced.
// Tensor cores do not pay: a bin's contraction depth is 2-4 cells per axis.
//
// The kernel allocates nothing and does not synchronise. The C entry point
// returns the first CUDA error of the launch.

#include "roi_align_common.cuh"

namespace {

using namespace roi_align;

constexpr int kLanes = 32;       // threads over 16-byte channel vectors
constexpr int kBlocksPerSm = 4;      // 8-warp blocks resident per SM at 64 registers
constexpr int kSmallGridWaves = 4;   // grids shorter than this many waves take 16 warps a box

struct Levels {
  const void* ptr[kMaxLevels];   // (B, H_l, W_l, C) contiguous, one per level
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];       // 1 / stride
};

size_t fwd_smem(int P, int band_cells) {
  return static_cast<size_t>(P) * band_cells * sizeof(float);      // Ay, Ax
}

__device__ __forceinline__ void ld16(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void st16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = t;
}

template <typename T, int kBinWarps>
__global__ void __launch_bounds__(kLanes * kBinWarps, 32 / kBinWarps)   // 64 registers
roi_align_fwd_kernel(Levels lv, const float* __restrict__ boxes,
                     const int* __restrict__ levels, const int* __restrict__ images,
                     int C, int P, int S, T* __restrict__ out) {
  constexpr int kBlock = kLanes * kBinWarps;
  static_assert(kBlock >= kTapThreads, "a thread per (axis, bin, sample)");
  extern __shared__ __align__(16) float bw[];     // Ay [P][cy], then Ax [P][cx]
  __shared__ BoxTaps taps;
  __shared__ int ext[2][kMaxBins][2];   // band extent of each bin row, level cells

  constexpr int E = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int box = blockIdx.x;
  const int lane = tid % kLanes, warp = tid / kLanes;
  const int c = (blockIdx.y * kLanes + lane) * E;
  const int l = levels[box];
  const int H = lv.h[l], W = lv.w[l];

  sample_taps(boxes + 4 * box, lv.scale[l], P, S, H, W, tid, taps);
  __syncthreads();
  if (tid < 2 * kMaxBins) {
    const int axis = tid / kMaxBins, p = tid % kMaxBins;
    row_span(taps[axis][p], 0, axis ? W : H, &ext[axis][p][0], &ext[axis][p][1]);
  }
  __syncthreads();
  int first[2] = {H, W}, last[2] = {-1, -1};
#pragma unroll
  for (int q = 0; q < kMaxBins; ++q) {
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      first[d] = min(first[d], ext[d][q][0]);
      last[d] = max(last[d], ext[d][q][1]);
    }
  }
  const bool empty = first[0] > last[0] || first[1] > last[1];
  const int cy = empty ? 0 : last[0] - first[0] + 1, cx = empty ? 0 : last[1] - first[1] + 1;
  for (int i = tid; i < P * (cy + cx); i += kBlock) {
    const int axis = i >= P * cy;
    const int n = axis ? cx : cy, r = axis ? i - P * cy : i;
    bw[i] = cell_weight(taps[axis][r / n], first[axis] + r % n);
  }
  __syncthreads();
  if (c >= C) return;
  const float* ay = bw;
  const float* ax = bw + P * cy;
  const T* band = static_cast<const T*>(lv.ptr[l])
                  + (static_cast<size_t>(images[box]) * H * W + static_cast<size_t>(first[0]) * W
                     + first[1]) * C + c;
  for (int bin = warp; bin < P * P; bin += kBinWarps) {
    const int py = bin / P, px = bin - py * P;
    float acc[E];
#pragma unroll
    for (int j = 0; j < E; ++j) acc[j] = 0.0f;
    if (!empty) {
      const int y0 = ext[0][py][0] - first[0], y1 = ext[0][py][1] - first[0];
      const int x0 = ext[1][px][0] - first[1], x1 = ext[1][px][1] - first[1];
      for (int y = y0; y <= y1; ++y) {
        // T[y][px] = sum_x Ax[px][x] F[y][x], then out[py][px] += Ay[py][y] T[y][px]
        float t[E];
#pragma unroll
        for (int j = 0; j < E; ++j) t[j] = 0.0f;
        const T* row = band + static_cast<size_t>(y) * W * C;
#pragma unroll 2   // two loads in flight per lane
        for (int x = x0; x <= x1; ++x) {
          const float w = ax[px * cx + x];
          float v[E];
          ld16(row + static_cast<size_t>(x) * C, v);
#pragma unroll
          for (int j = 0; j < E; ++j) t[j] = fmaf(w, v[j], t[j]);
        }
        const float w = ay[py * cy + y];
#pragma unroll
        for (int j = 0; j < E; ++j) acc[j] = fmaf(w, t[j], acc[j]);
      }
    }
    st16(out + (static_cast<size_t>(box) * P * P + bin) * C + c, acc);
  }
}

template <typename T, int kBinWarps>
cudaError_t launch_with(const Levels& lv, const float* boxes, const int* levels,
                        const int* images, dim3 grid, size_t smem, int C, int P, int S,
                        void* out, cudaStream_t s) {
  const cudaError_t err = allow_smem(roi_align_fwd_kernel<T, kBinWarps>, smem);
  if (err != cudaSuccess) return err;
  roi_align_fwd_kernel<T, kBinWarps><<<grid, kLanes * kBinWarps, smem, s>>>(
      lv, boxes, levels, images, C, P, S, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Levels& lv, int n_levels, const float* boxes, const int* levels,
                   const int* images, int n_boxes, int C, int P, int S, void* out,
                   cudaStream_t s) {
  int band_cells = 0;   // a box's bands span at most its level's height + width
  for (int i = 0; i < n_levels; ++i) band_cells = max(band_cells, lv.h[i] + lv.w[i]);
  const size_t smem = fwd_smem(P, band_cells);
  const int per_block = kLanes * 16 / static_cast<int>(sizeof(T));
  const dim3 grid(n_boxes, (C + per_block - 1) / per_block);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(grid.x) * grid.y;
  if (blocks < static_cast<long long>(kSmallGridWaves) * kBlocksPerSm * sms)   // 16 warps a box
    return launch_with<T, 16>(lv, boxes, levels, images, grid, smem, C, P, S, out, s);
  return launch_with<T, 8>(lv, boxes, levels, images, grid, smem, C, P, S, out, s);
}

}  // namespace

// Pools n_boxes boxes into out (n_boxes, P, P, C) of the features' dtype.
// level_ptrs/level_h/level_w/level_scale are host arrays of n_levels
// entries; boxes (n_boxes, 4) f32, levels and images (n_boxes,) int32 are
// device pointers. C must be a multiple of 4 (f32) or 8 (bf16), every
// pointer 16-byte aligned, 1 <= P <= 8 and 0 <= S <= 9; the Python
// wrapper checks all four.
extern "C" int roi_align_fwd(const void* const* level_ptrs, const int* level_h,
                             const int* level_w, const float* level_scale,
                             int n_levels, const float* boxes, const int* levels,
                             const int* images, int n_boxes, int channels,
                             int out_size, int sampling_ratio, int is_bf16,
                             void* out, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_boxes < 1 || out_size < 1 ||
      out_size > kMaxBins || sampling_ratio < 0 || sampling_ratio > kSmax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv = {};
  for (int i = 0; i < n_levels; ++i) {
    lv.ptr[i] = level_ptrs[i];
    lv.h[i] = level_h[i];
    lv.w[i] = level_w[i];
    lv.scale[i] = level_scale[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(lv, n_levels, boxes, levels, images, n_boxes, channels,
                                      out_size, sampling_ratio, out, s)
              : launch<float>(lv, n_levels, boxes, levels, images, n_boxes, channels, out_size,
                              sampling_ratio, out, s);
  return static_cast<int>(err);
}
