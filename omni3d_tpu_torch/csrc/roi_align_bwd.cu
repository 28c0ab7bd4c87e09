// Multilevel ROIAlignV2 backward (feature gradient) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// omni3d_tpu/ops/roi_align_bwd_pallas.py::roi_align_bwd_pallas, which
// computes the same function: the transpose of the forward pooling
// (roi_align_fwd.cu) for given per-box levels. Every sample of every bin of
// a box adds g(bin) x (sample weight) x (bilinear tap weight) to the four
// cells it read in the forward, in float32, into one accumulator covering
// every level and image; the caller casts it to the features' dtype. The
// TPU kernel's one-hot/A-matrix machinery (windowed matmuls into a VMEM
// plane revisited by a sequential grid) is a TPU workaround and does not
// come over: on Hopper the blocks run in parallel and in no order, so the
// scatter is made race-free with atomics instead.
//
// Sample positions, taps and weights come from roi_align_common.cuh, the
// code the forward kernel uses, so the pair is an exact transpose up to the
// order of float32 additions.
//
// What bounds it on the H100: the atomic adds to L2, not HBM bytes. Each
// sample adds four taps of C channels; at canonical routing most boxes span
// 7-14 cells, 1-2 samples per bin axis, so a box-channel makes some 200-800
// atomic adds, about 10^9-10^10 per training step at batch 32 x 640 RoIs x
// 256 channels. The f32 gradient planes (4 B per cell and channel: ~22 MB
// per image at 512 px) stay partly resident in the 50 MB L2, where the
// atomics resolve; the bytes the function must move (g read once, the
// gradient written once) take a fraction of that time.
//
// What this first design does about it: one thread block per (box, channel
// tile), threads over 16-byte channel vectors, warps over bins, exactly as
// the forward, so a warp's atomics to one tap hit one contiguous 512-byte
// row segment; each thread adds 4 channels with one 128-bit float4
// atomicAdd (sm_90 has vector atomics on global memory); samples with zero
// weight (outside [-1, H]) and zero-weight taps issue no atomic at all.
// Left for later work: staging a box's tap footprint in shared memory and
// adding it to global memory once, which cuts the atomics by the taps
// shared between samples and bins.
//
// The kernel allocates nothing and does not synchronise; the wrapper zeroes
// the accumulator. The C entry point returns cudaGetLastError() after the
// launch.

#include "roi_align_common.cuh"

namespace {

using namespace roi_align;

struct LevelGeom {
  long long offset[kMaxLevels];  // start of level l in the accumulator, elements
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];       // 1 / stride
};

__device__ __forceinline__ void atomic_add4(float* p, const float* g, float w) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float4*>(p),
            make_float4(g[0] * w, g[1] * w, g[2] * w, g[3] * w));
#else
#pragma unroll
  for (int k = 0; k < 4; ++k) atomicAdd(p + k, g[k] * w);
#endif
}

template <int V>
__device__ __forceinline__ void add_tap(float* p, const float (&g)[V], float w) {
  if (w == 0.0f) return;
#pragma unroll
  for (int k = 0; k < V; k += 4) atomic_add4(p + k, g + k, w);
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kBinLanes)
roi_align_bwd_kernel(LevelGeom lg, const float* __restrict__ boxes,
                     const int* __restrict__ levels, const int* __restrict__ images,
                     const T* __restrict__ grad, int C, int P, int S,
                     float* __restrict__ acc) {
  constexpr int V = Vec<T>::N;
  const int box = blockIdx.x;
  const int c0 = (blockIdx.y * kLanes + threadIdx.x) * V;
  if (c0 >= C) return;

  const int l = levels[box];
  const int H = lg.h[l];
  const int W = lg.w[l];
  float* plane = acc + lg.offset[l] + static_cast<size_t>(images[box]) * H * W * C + c0;
  const size_t row = static_cast<size_t>(W) * C;

  Axis ay, ax;
  box_axes(boxes + 4 * box, lg.scale[l], P, S, ay, ax);
  const float ws = ay.w * ax.w;

  for (int bin = threadIdx.y; bin < P * P; bin += kBinLanes) {
    const int py = bin / P;
    const int px = bin - py * P;
    float g[V];
    load_vec(grad + (static_cast<size_t>(box) * P * P + bin) * C + c0, g);
#pragma unroll
    for (int k = 0; k < V; ++k) g[k] *= ws;

    for (int iy = 0; iy < ay.count; ++iy) {
      const Tap ty = make_tap(sample_pos(ay, py, iy), H);
      if (ty.w_lo == 0.0f && ty.w_hi == 0.0f) continue;   // outside [-1, H]
      float* r0 = plane + ty.lo * row;
      float* r1 = plane + ty.hi * row;
      for (int ix = 0; ix < ax.count; ++ix) {
        const Tap tx = make_tap(sample_pos(ax, px, ix), W);
        add_tap(r0 + static_cast<size_t>(tx.lo) * C, g, ty.w_lo * tx.w_lo);
        add_tap(r0 + static_cast<size_t>(tx.hi) * C, g, ty.w_lo * tx.w_hi);
        add_tap(r1 + static_cast<size_t>(tx.lo) * C, g, ty.w_hi * tx.w_lo);
        add_tap(r1 + static_cast<size_t>(tx.hi) * C, g, ty.w_hi * tx.w_hi);
      }
    }
  }
}

}  // namespace

// Adds the feature gradient of n_boxes pooled boxes into acc, a zeroed
// float32 buffer holding every level's (B, H_l, W_l, C) gradient back to
// back, level l starting at element level_offset[l]. grad is
// (n_boxes, P, P, C) float32 or bfloat16; boxes (n_boxes, 4) f32, levels and
// images (n_boxes,) int32 are device pointers; level_offset/level_h/level_w/
// level_scale are host arrays of n_levels entries. C must be a multiple of 4
// (f32) or 8 (bf16) and every pointer 16-byte aligned; the Python wrapper
// checks both.
extern "C" int roi_align_bwd(const long long* level_offset, const int* level_h,
                             const int* level_w, const float* level_scale,
                             int n_levels, const float* boxes, const int* levels,
                             const int* images, int n_boxes, const void* grad,
                             int channels, int out_size, int sampling_ratio,
                             int is_bf16, float* acc, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_boxes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelGeom lg = {};
  for (int i = 0; i < n_levels; ++i) {
    lg.offset[i] = level_offset[i];
    lg.h[i] = level_h[i];
    lg.w[i] = level_w[i];
    lg.scale[i] = level_scale[i];
  }
  const int vec = is_bf16 ? 8 : 4;
  const dim3 block(kLanes, kBinLanes);
  const dim3 grid(n_boxes, (channels / vec + kLanes - 1) / kLanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        lg, boxes, levels, images, static_cast<const __nv_bfloat16*>(grad), channels,
        out_size, sampling_ratio, acc);
  } else {
    roi_align_bwd_kernel<float><<<grid, block, 0, s>>>(
        lg, boxes, levels, images, static_cast<const float*>(grad), channels,
        out_size, sampling_ratio, acc);
  }
  return static_cast<int>(cudaGetLastError());
}
