// Sample geometry shared by the multilevel ROIAlignV2 forward
// (roi_align_fwd.cu) and backward (roi_align_bwd.cu) kernels, and the
// per-axis banded weights both kernels pool through.
//
// Positions are formed with explicitly rounded operations in the plain
// PyTorch version's order (ops/roi_align.py::_sample_grid_1d), so that a
// sample sits exactly where the plain version puts it: the inside test at -1
// and at the axis length is a step, and one ulp of a position moves a
// bilinear value by ulp x the feature step between cells.
//
// Pooling is separable. Along one axis, bin p of a box reads cell f with
// weight A[p, f] = sum over the samples i of bin p of (sample weight x
// inside flag x bilinear tap weight at f), so a pooled bin is
// out[py, px] = sum_{y, x} Ay[py, y] Ax[px, x] F[y, x] and the feature
// gradient is dF = Ay^T G Ax (the A matrices of the JAX package's
// roi_align_pallas.py::_axis_weights). The cells with a nonzero weight form
// the box's band along that axis, [first, last]: its smallest and largest
// tap of nonzero weight, so a box of negative width (which samples
// backwards) and an axis whose taps are all clamped to the last cell (a band
// of one cell) need no special case, and a NaN box, whose weights are all
// zero, has an empty band. A block builds a box's bands in two parallel
// steps: one thread per (axis, bin, sample) computes the sample's taps
// (sample_taps), then one thread per (axis, bin, cell) sums the weights
// landing on its cell (cell_weight); a band of any width is built whole
// (the forward) or cut to a gradient tile (the backward), never truncated.
// ops/roi_align.py::axis_bands builds the same bands on the CPU.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace roi_align {

constexpr int kMaxLevels = 8;
constexpr int kSmax = 9;         // ADAPTIVE_SMAX of omni3d_tpu/ops/roi_align.py
constexpr int kMaxBins = 8;      // out_size bound (the configs pool 7 x 7)

// Sample grid of one box along one axis (_sample_grid_1d).
struct Axis {
  float lo;     // box start in level cells, after the -0.5 shift
  float size;   // box extent in level cells (negative for a reversed box)
  float bin;    // bin extent
  float step;   // sample spacing inside a bin
  float w;      // per-sample weight (1 / samples per bin)
  int count;    // samples per bin with nonzero weight
};

__device__ __forceinline__ Axis make_axis(float lo, float size, int P, int S) {
  Axis a;
  a.lo = lo;
  a.size = size;
  a.bin = __fdiv_rn(size, static_cast<float>(P));
  if (S > 0) {
    a.step = __fdiv_rn(a.bin, static_cast<float>(S));
    a.w = __fdiv_rn(1.0f, static_cast<float>(S));
    a.count = S;
  } else {
    const float g = ceilf(a.bin);                       // ceil(size / P)
    const float gc = fminf(fmaxf(g, 1.0f), static_cast<float>(kSmax));
    a.step = __fdiv_rn(a.bin, gc);
    a.w = __fdiv_rn(1.0f, gc);
    a.count = g >= kSmax ? kSmax : (g > 0.0f ? static_cast<int>(g) : 0);
  }
  return a;
}

// The y (axis 0) or x (axis 1) sample grid of one XYXY box (image
// coordinates) pooled from a level of the given 1/stride scale.
__device__ __forceinline__ Axis box_axis(const float* box, float scale, int P, int S,
                                         int axis) {
  const float a = __fsub_rn(__fmul_rn(box[1 - axis], scale), 0.5f);
  const float b = __fsub_rn(__fmul_rn(box[3 - axis], scale), 0.5f);
  return make_axis(a, __fsub_rn(b, a), P, S);
}

// True unless the taps of the axis surely miss the cells [c0, c0 + n): every
// sample lies in [lo, lo + size] up to rounding, and its taps within a cell
// of it; the margin covers both. False for a NaN box. Used to skip boxes
// cheaply before their band is built.
__device__ __forceinline__ bool may_touch(const Axis& a, int c0, int n) {
  const float e = a.lo + a.size;
  const float mn = fminf(a.lo, e), mx = fmaxf(a.lo, e);
  const float m = 2.0f + 1e-5f * (fabsf(a.lo) + fabsf(e));
  return mx + m >= static_cast<float>(c0) && mn - m < static_cast<float>(c0 + n);
}

__device__ __forceinline__ float sample_pos(const Axis& a, int bin, int i) {
  const float start = __fadd_rn(a.lo, __fmul_rn(static_cast<float>(bin), a.bin));
  return __fadd_rn(start, __fmul_rn(static_cast<float>(i) + 0.5f, a.step));
}

// Bilinear taps of one position with torchvision's boundary rules: zero
// outside [-1, limit], clamped to the last cell at and past limit - 1.
struct Tap {
  int lo, hi;
  float w_lo, w_hi;   // tap weights, already multiplied by the inside flag
};

__device__ __forceinline__ Tap make_tap(float pos, int limit) {
  const bool inside = pos >= -1.0f && pos <= static_cast<float>(limit);
  const float p = fmaxf(pos, 0.0f);
  const float fl = floorf(p);
  Tap t;
  float frac;
  if (fl >= static_cast<float>(limit - 1)) {
    t.lo = t.hi = limit - 1;
    frac = 0.0f;
  } else {
    t.lo = static_cast<int>(fl);
    t.hi = t.lo + 1;
    frac = __fsub_rn(p, fl);
  }
  const float in = inside ? 1.0f : 0.0f;
  t.w_lo = (1.0f - frac) * in;
  t.w_hi = frac * in;
  return t;
}

// The taps of one sample along one axis, its sample weight folded into both
// tap weights (zero for a sample the axis does not take).
struct SampleTaps {
  int lo, hi;
  float w_lo, w_hi;
};

// A box's taps: [axis][bin][sample], axis 0 = y, 1 = x.
using BoxTaps = SampleTaps[2][kMaxBins][kSmax];

// Thread t < kTapThreads of a block computes one sample's taps of the box
// (XYXY, image coordinates) pooled from a level of 1/stride `scale` and
// size H x W, so the block builds the box's geometry in one step instead of
// one thread walking every sample.
constexpr int kTapThreads = 2 * kMaxBins * kSmax;

__device__ __forceinline__ void sample_taps(const float* box, float scale, int P, int S, int H,
                                            int W, int t, BoxTaps& taps) {
  if (t >= kTapThreads) return;
  const int axis = t / (kMaxBins * kSmax), r = t % (kMaxBins * kSmax);
  const int p = r / kSmax, i = r % kSmax;
  SampleTaps st = {0, 0, 0.0f, 0.0f};
  if (p < P) {
    const Axis a = box_axis(box, scale, P, S, axis);
    if (i < a.count) {
      const Tap tp = make_tap(sample_pos(a, p, i), axis ? W : H);
      st.lo = tp.lo;
      st.hi = tp.hi;
      st.w_lo = a.w * tp.w_lo;
      st.w_hi = a.w * tp.w_hi;
    }
  }
  taps[axis][p][i] = st;
}

// A[p, c] of one bin row: its samples' tap weights at cell c, summed in
// sample order (lo tap, then hi tap).
__device__ __forceinline__ float cell_weight(const SampleTaps (&row)[kSmax], int c) {
  float w = 0.0f;
#pragma unroll
  for (int i = 0; i < kSmax; ++i) {
    if (row[i].lo == c) w += row[i].w_lo;
    if (row[i].hi == c) w += row[i].w_hi;
  }
  return w;
}

// The range [*first, *last] (relative to c0) of one bin row's taps of
// nonzero weight inside the cells [c0, c0 + n); first > last when none.
__device__ __forceinline__ void row_span(const SampleTaps (&row)[kSmax], int c0, int n,
                                         int* first, int* last) {
  int f = n, l = -1;
#pragma unroll
  for (int i = 0; i < kSmax; ++i) {
    const int j0 = row[i].lo - c0, j1 = row[i].hi - c0;
    if (row[i].w_lo != 0.0f && j0 >= 0 && j0 < n) { f = min(f, j0); l = max(l, j0); }
    if (row[i].w_hi != 0.0f && j1 >= 0 && j1 < n) { f = min(f, j1); l = max(l, j1); }
  }
  *first = f;
  *last = l;
}

// Dynamic shared memory that takes a block past 48 KB with its static
// shared memory needs an opt-in per kernel.
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace roi_align
