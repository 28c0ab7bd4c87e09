// Sample geometry shared by the multilevel ROIAlignV2 forward
// (roi_align_fwd.cu) and backward (roi_align_bwd.cu) kernels.
//
// Both kernels form sample positions, tap indices and bilinear weights with
// this one piece of code, so the backward applies exactly the transpose of
// the linear map the forward applies. Positions are formed with explicitly
// rounded operations in the plain PyTorch version's order
// (ops/roi_align.py::_sample_grid_1d), so that a sample sits exactly where
// the plain version puts it: the inside test at -1 and at the axis length is
// a step, and one ulp of a position moves a bilinear value by ulp x the
// feature step between cells.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace roi_align {

constexpr int kMaxLevels = 8;
constexpr int kSmax = 9;         // ADAPTIVE_SMAX of omni3d_tpu/ops/roi_align.py
constexpr int kLanes = 32;       // threads over channel vectors
constexpr int kBinLanes = 8;     // warps over bins

// 16-byte vectors: 4 float32 or 8 bfloat16 channels per thread.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// Sample grid of one box along one axis (_sample_grid_1d).
struct Axis {
  float lo;     // box start in level cells, after the -0.5 shift
  float bin;    // bin extent
  float step;   // sample spacing inside a bin
  float w;      // per-sample weight (1 / samples per bin)
  int count;    // samples per bin with nonzero weight
};

__device__ __forceinline__ Axis make_axis(float lo, float size, int P, int S) {
  Axis a;
  a.lo = lo;
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

// The y and x sample grids of one XYXY box (image coordinates) pooled from
// a level of the given 1/stride scale.
__device__ __forceinline__ void box_axes(const float* box, float scale, int P, int S,
                                         Axis& ay, Axis& ax) {
  const float x1 = __fsub_rn(__fmul_rn(box[0], scale), 0.5f);
  const float y1 = __fsub_rn(__fmul_rn(box[1], scale), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(box[2], scale), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(box[3], scale), 0.5f);
  ay = make_axis(y1, __fsub_rn(y2, y1), P, S);
  ax = make_axis(x1, __fsub_rn(x2, x1), P, S);
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

}  // namespace roi_align
