// Greedy non-maximum suppression over score-sorted rows, for Hopper, sm_90a.
//
// Replaces the JAX package's device-resident NMS loop,
// omni3d_tpu/ops/nms.py::nms_mask (its lax.while_loop fixpoint
// _fixpoint_keep and the blocked lax.fori_loop over 256-box blocks), which
// the port ran from the host as a fixpoint over a dense (..., N, N) float
// matrix with one host sync per iteration. Both compute sequential greedy
// NMS: box i (in score order) is kept iff it is valid and no kept box
// j < i has IoU(j, i) > t; the fixpoint's unique solution is that set. Here
// it is computed in two kernels over R independent rows of N boxes that the
// caller has already sorted (the rows are the (image, level) pairs of the
// RPN and the images of the class-aware NMS, whose boxes the caller has
// shifted by class):
//
//  (a) nms_words_kernel: one 64-thread block per (row, 64-box row tile rt,
//      64-box column tile ct >= rt). The block stages the column tile's
//      boxes and areas in shared memory; thread i writes the 64-bit word
//      words[r, i, ct] whose bit b is set iff valid_i, j = 64 ct + b > i,
//      j < N and IoU(box_i, box_j) > t. Words with ct < rt are never
//      written (the output comes from torch.empty) and never read.
//  (b) nms_greedy_kernel: one warp per row walks the 64-box tiles in order
//      with the removed bits of the row in shared memory. In tile w it
//      reads the tile's diagonal words (64 x 8 bytes), resolves the tile's
//      keep bits serially in registers (each kept box ORs its diagonal word
//      into the removed bits of the tile, skipping straight to the next
//      valid box not yet removed), writes the tile's keep flags through the
//      sort order into input order, then the lanes OR the kept boxes' words
//      of every later tile into the removed bits, one later tile per lane.
//
// What bounds it on the H100. (a) computes N(N-1)/2 IoUs per row, 13
// float32 operations each (3.7e9 at the training shape, 32 x 5 rows of
// 2000 boxes: 0.056 ms at 67 TFLOP/s), and writes about N(N+64)/128 words
// of 8 bytes per row (43 MB there, 0.013 ms at 3.35 TB/s): the operations
// set its bound, and nothing but the words leaves the block. (b) reads the
// diagonal words and the kept boxes' later words, at most the same 43 MB,
// but its floor is the serial chain: N dependent steps per row. The design
// keeps that chain out of device memory: a step is a few register
// operations on the tile's removed word and a shared-memory read of a
// diagonal word; the loads of device memory are issued per tile, 64
// diagonal words in one coalesced read and the later words by 32 lanes at
// once, so a row waits on memory about twice per 64 boxes, not once per
// box. Rows run in parallel, one warp each. The 64 x 64 tiles are the
// width of a 64-bit word; the JAX package's 256-box blocks were the TPU's
// matrix unit and are not kept.
//
// The IoU is computed operation for operation as the plain PyTorch version
// (ops/nms.py::nms_mask_plain through utils/boxes.py::pairwise_iou) does,
// so the keep masks are bit-equal: widths clamp(x2 - x1, 0), inter = w * h,
// union = (area_i + area_j) - inter, iou = union > 0 ? inter / union : 0,
// and the test iou > t. Each step is an explicitly rounded intrinsic, so no
// product fuses into an FMA, the division is IEEE, and max / min / clamp
// propagate NaN as torch.maximum, torch.minimum and clamp do (fmaxf and
// fminf would drop it).
//
// The kernels allocate nothing and do not synchronise. Each C entry point
// returns the CUDA error of its launch (cudaGetLastError).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kTile = 64;          // boxes per tile: the bits of a word
constexpr int kMaxBoxes = 16384;   // N bound: 256 words per box, 32,896 tiles per row
constexpr int kMaxRows = 65535;    // grid.y of the words kernel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// torch.maximum / torch.minimum: NaN if either side is NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_f() : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_f() : fminf(a, b);
}
// clamp(x, min=0): NaN stays NaN
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(clamp0(__fsub_rn(b.z, b.x)), clamp0(__fsub_rn(b.w, b.y)));
}

__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b, float area_b,
                                          float t) {
  const float iw = clamp0(__fsub_rn(tmin(a.z, b.z), tmax(a.x, b.x)));
  const float ih = clamp0(__fsub_rn(tmin(a.w, b.w), tmax(a.y, b.y)));
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
  return iou > t;
}

__global__ void __launch_bounds__(kTile)
nms_words_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid, int n,
                 int n_words, float t, u64* __restrict__ words) {
  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  // blockIdx.x enumerates the tiles (rt, ct >= rt) row tile by row tile
  int k = blockIdx.x, rt = 0;
  while (k >= n_words - rt) {
    k -= n_words - rt;
    ++rt;
  }
  const int ct = rt + k;
  const int r = blockIdx.y, tid = threadIdx.x;
  const float4* rb = boxes + static_cast<size_t>(r) * n;
  const int j = ct * kTile + tid;
  if (j < n) {
    const float4 b = rb[j];
    cbox[tid] = b;
    carea[tid] = box_area(b);
  }
  __syncthreads();
  const int i = rt * kTile + tid;
  if (i >= n) return;
  u64 bits = 0;
  if (valid[static_cast<size_t>(r) * n + i]) {
    const float4 a = rb[i];
    const float area_a = box_area(a);
    const int end = min(kTile, n - ct * kTile);
    for (int b = ct == rt ? tid + 1 : 0; b < end; ++b) {
      if (iou_above(a, area_a, cbox[b], carea[b], t)) bits |= 1ull << b;
    }
  }
  words[(static_cast<size_t>(r) * n + i) * n_words + ct] = bits;
}

__global__ void __launch_bounds__(32)
nms_greedy_kernel(const u64* __restrict__ words, const uint8_t* __restrict__ valid,
                  const int64_t* __restrict__ order, int n, int n_words,
                  uint8_t* __restrict__ keep) {
  extern __shared__ u64 removed[];   // n_words: the row's removed bits
  __shared__ u64 diag[kTile];
  const int r = blockIdx.x, lane = threadIdx.x;
  const size_t row = static_cast<size_t>(r) * n;
  const u64* rw = words + row * n_words;
  const uint8_t* rv = valid + row;
  for (int w = lane; w < n_words; w += 32) removed[w] = 0;
  __syncwarp();
  for (int w = 0; w < n_words; ++w) {
    const int base = w * kTile;
    const int nb = min(kTile, n - base);
    for (int b = lane; b < nb; b += 32) diag[b] = rw[static_cast<size_t>(base + b) * n_words + w];
    const unsigned lo = __ballot_sync(kFull, lane < nb && rv[base + lane]);
    const unsigned hi = __ballot_sync(kFull, lane + 32 < nb && rv[base + lane + 32]);
    const u64 vbits = (static_cast<u64>(hi) << 32) | lo;
    __syncwarp();
    // the serial chain: every lane resolves the tile alike, in registers
    u64 rem = removed[w], kept = 0;
    u64 avail = vbits & ~rem;
    while (avail) {
      const int b = __ffsll(static_cast<long long>(avail)) - 1;
      kept |= 1ull << b;
      rem |= diag[b];
      avail = b == kTile - 1 ? 0 : vbits & ~rem & (~0ull << (b + 1));
    }
    for (int b = lane; b < nb; b += 32) {
      const int64_t dst = order ? order[row + base + b] : base + b;
      keep[row + dst] = static_cast<uint8_t>((kept >> b) & 1);
    }
    // the kept boxes suppress in the later tiles: one later word per lane
    for (int w2 = w + 1 + lane; w2 < n_words; w2 += 32) {
      u64 acc = removed[w2];
      const u64* col = rw + static_cast<size_t>(base) * n_words + w2;
#pragma unroll 16
      for (int b = 0; b < kTile; ++b) {
        if ((kept >> b) & 1) acc |= col[static_cast<size_t>(b) * n_words];
      }
      removed[w2] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int nms_suppression_words(const float* boxes, const uint8_t* valid, int rows, int n,
                                     float threshold, u64* words, void* stream) {
  if (rows < 1 || rows > kMaxRows || n < 1 || n > kMaxBoxes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_words = (n + kTile - 1) / kTile;
  const dim3 grid(n_words * (n_words + 1) / 2, rows);
  nms_words_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(boxes), valid, n, n_words, threshold, words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nms_greedy_keep(const u64* words, const uint8_t* valid, const int64_t* order,
                               int rows, int n, uint8_t* keep, void* stream) {
  if (rows < 1 || n < 1 || n > kMaxBoxes) return static_cast<int>(cudaErrorInvalidValue);
  const int n_words = (n + kTile - 1) / kTile;
  nms_greedy_kernel<<<rows, 32, n_words * sizeof(u64), static_cast<cudaStream_t>(stream)>>>(
      words, valid, order, n, n_words, keep);
  return static_cast<int>(cudaGetLastError());
}
