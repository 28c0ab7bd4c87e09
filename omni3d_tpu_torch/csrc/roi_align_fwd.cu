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
// What bounds it on the H100: the bytes of the tap reads. Every sample reads
// four NHWC rows of C channels; with C = 256 a 512 px bf16 pyramid is about
// 11 MB per image, so a batch of a few images stays resident in the 50 MB L2
// and most tap reads are L2 (or L1) hits, the rest HBM. The FLOPs are a few
// per byte read, far below the tensor-core line.
//
// What this first design does about it: one thread block per (box, channel
// tile). A warp spans 32 x 16 bytes of one row, so each tap read is one
// contiguous 512-byte segment (256 bf16 channels, or 128 f32 channels) and
// neighbouring warps of the block work on other bins of the same box, whose
// taps overlap in L1. Loads and stores are 16 bytes per thread; samples
// accumulate in float32 registers; the output is rounded once to the feature
// dtype. Left for later work: staging a box's tap footprint in shared memory,
// skipping taps shared between neighbouring samples, and one launch for both
// poolers.
//
// The kernel allocates nothing and does not synchronise. The C entry point
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kSmax = 9;         // ADAPTIVE_SMAX of omni3d_tpu/ops/roi_align.py
constexpr int kLanes = 32;       // threads over channel vectors
constexpr int kBinLanes = 8;     // warps over bins

struct Levels {
  const void* ptr[kMaxLevels];   // (B, H_l, W_l, C) contiguous, one per level
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];       // 1 / stride
};

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

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = t;
}

// Sample grid of one box along one axis (_sample_grid_1d). Positions are
// formed with explicitly rounded operations in the plain version's order,
// so that a sample sits exactly where the plain version puts it: the
// inside test at -1 and at the axis length is a step.
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

template <typename T>
__global__ void __launch_bounds__(kLanes * kBinLanes)
roi_align_fwd_kernel(Levels lv, const float* __restrict__ boxes,
                     const int* __restrict__ levels, const int* __restrict__ images,
                     int C, int P, int S, T* __restrict__ out) {
  constexpr int V = Vec<T>::N;
  const int box = blockIdx.x;
  const int c0 = (blockIdx.y * kLanes + threadIdx.x) * V;
  if (c0 >= C) return;

  const int l = levels[box];
  const int H = lv.h[l];
  const int W = lv.w[l];
  const float scale = lv.scale[l];
  const T* plane = static_cast<const T*>(lv.ptr[l])
                   + static_cast<size_t>(images[box]) * H * W * C + c0;
  const size_t row = static_cast<size_t>(W) * C;

  const float x1 = __fsub_rn(__fmul_rn(boxes[4 * box + 0], scale), 0.5f);
  const float y1 = __fsub_rn(__fmul_rn(boxes[4 * box + 1], scale), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(boxes[4 * box + 2], scale), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(boxes[4 * box + 3], scale), 0.5f);
  const Axis ay = make_axis(y1, __fsub_rn(y2, y1), P, S);
  const Axis ax = make_axis(x1, __fsub_rn(x2, x1), P, S);

  for (int bin = threadIdx.y; bin < P * P; bin += kBinLanes) {
    const int py = bin / P;
    const int px = bin - py * P;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;

    for (int iy = 0; iy < ay.count; ++iy) {
      const Tap ty = make_tap(sample_pos(ay, py, iy), H);
      const T* r0 = plane + ty.lo * row;
      const T* r1 = plane + ty.hi * row;
      for (int ix = 0; ix < ax.count; ++ix) {
        const Tap tx = make_tap(sample_pos(ax, px, ix), W);
        const float w00 = ty.w_lo * tx.w_lo, w01 = ty.w_lo * tx.w_hi;
        const float w10 = ty.w_hi * tx.w_lo, w11 = ty.w_hi * tx.w_hi;
        const float ws = ay.w * ax.w;
        float f00[V], f01[V], f10[V], f11[V];
        load_vec(r0 + static_cast<size_t>(tx.lo) * C, f00);
        load_vec(r0 + static_cast<size_t>(tx.hi) * C, f01);
        load_vec(r1 + static_cast<size_t>(tx.lo) * C, f10);
        load_vec(r1 + static_cast<size_t>(tx.hi) * C, f11);
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc[k] += (f00[k] * w00 + f01[k] * w01 + f10[k] * w10 + f11[k] * w11) * ws;
      }
    }
    store_vec(out + (static_cast<size_t>(box) * P * P + bin) * C + c0, acc);
  }
}

}  // namespace

// Pools n_boxes boxes into out (n_boxes, P, P, C) of the features' dtype.
// level_ptrs/level_h/level_w/level_scale are host arrays of n_levels
// entries; boxes (n_boxes, 4) f32, levels and images (n_boxes,) int32 are
// device pointers. C must be a multiple of 4 (f32) or 8 (bf16) and every
// pointer 16-byte aligned; the Python wrapper checks both.
extern "C" int roi_align_fwd(const void* const* level_ptrs, const int* level_h,
                             const int* level_w, const float* level_scale,
                             int n_levels, const float* boxes, const int* levels,
                             const int* images, int n_boxes, int channels,
                             int out_size, int sampling_ratio, int is_bf16,
                             void* out, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_boxes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv = {};
  for (int i = 0; i < n_levels; ++i) {
    lv.ptr[i] = level_ptrs[i];
    lv.h[i] = level_h[i];
    lv.w[i] = level_w[i];
    lv.scale[i] = level_scale[i];
  }
  const int vec = is_bf16 ? 8 : 4;
  const dim3 block(kLanes, kBinLanes);
  const dim3 grid(n_boxes, (channels / vec + kLanes - 1) / kLanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        lv, boxes, levels, images, channels, out_size, sampling_ratio,
        static_cast<__nv_bfloat16*>(out));
  } else {
    roi_align_fwd_kernel<float><<<grid, block, 0, s>>>(
        lv, boxes, levels, images, channels, out_size, sampling_ratio,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
