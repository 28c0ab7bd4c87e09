// Train-mode BatchNorm of the trunk for Hopper, sm_90a: batch statistics,
// running update and affine forward, and the matching backward, on
// channels-last activations (bf16 or float32) viewed as M = N H W rows of C
// contiguous channels.
//
// Replaces no TPU kernel: the JAX package leaves train-mode BN to XLA,
// which fuses it (its space-to-depth `_TrainPackedBN`, models/layers.py, is
// a TPU layout, not a kernel). In plain PyTorch the formula
// (models/layers.py, the CPU path) takes ~10 passes forward and ~25
// backward per layer through float32 copies of the activation. The work
// is elementwise and reductions: bound by device memory. Forward reads x
// twice and writes y once, backward reads x and dy twice and writes dx
// once; at DLA-34's 1.30 G normalised activations a step (bf16, 512 x 768,
// batch 32) that is 20.7 GB, 6.2 ms at 3.35 TB/s.
//
// Each direction is three launches on the caller's stream:
//  (1) omni3d_bn_reduce: a block takes `rows` consecutive rows (grid x) of
//      one slab of tx x V channels (grid y); thread (i, j) holds channel
//      group i (V channels, one vector load of up to 16 bytes) and reads
//      rows j, j + ty, ... of the block's span, kUnroll loads in flight,
//      accumulating per channel in float32: forward the sums of d and d^2
//      with d = x - x[row 0] (shifted sums: no cancellation when the mean
//      is large against the spread), backward the sums of dy and
//      dy (x - mean). The block's ty row lanes are then summed by a tree in
//      shared memory, and one float32 partial per channel and block is
//      written: part[block][2][C].
//  (2) omni3d_bn_merge_fwd / _bwd: a block of 32 x 8 threads per 8
//      channels; lane j sums partial rows j, j + 32, ... in float64, then a
//      tree over the 32 lanes. Forward: mean = x[row 0] + S1 / M and the
//      biased variance S2 / M - (S1 / M)^2 clamped at 0, in float64, each
//      rounded to float32; rstd = 1 / sqrt(var + eps); a = weight rstd,
//      b = bias - mean a (float32, as the plain formula); the running
//      statistics updated in place, 0.9 r + 0.1 s in float32, when asked;
//      stats[4][C] = a, b, mean, rstd kept for the backward. Backward:
//      grad_bias = S_dy, grad_weight = S_dy(x - mean) rstd, and the
//      coefficients c0 = a S_dy / M, k = a rstd grad_weight / M.
//  (3) omni3d_bn_apply: the same tiling; forward y = x a + b, backward
//      dx = a dy - c0 - k (x - mean), in float32 with one rounding to the
//      activation's dtype, vector loads and stores.
//
// No float atomics: every sum is taken in a fixed order set by the launch
// geometry alone (the wrapper's `tiles`, from M, C, the dtype and the
// pointers' alignment), so two calls are bit-equal. Every float operation
// is an explicitly rounded intrinsic (no FMA contraction), so
// ops/batch_norm_cuda.py's plain-PyTorch mirror of this arithmetic
// reproduces it bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

constexpr int kThreads = 256;       // threads of a reduce or apply block (tx * ty <= kThreads)
constexpr int kUnroll = 4;          // rows a thread has in flight
constexpr int kLanes = 32;          // partial rows a merge block sums per channel at once
constexpr int kMergeChannels = 8;   // channels of a merge block
constexpr float kEps = 1e-5f;
constexpr float kMomentum = 0.1f;
constexpr float kKeep = 0.9f;       // 1 - momentum, as PyTorch's scalar becomes a float

// The launch geometry (ops/batch_norm_cuda.py `tiles`): m rows of c
// channels, blocks of `rows` rows, tx channel groups by ty row lanes, typ
// the power of two at or above ty.
struct Tiles {
  long long m, rows;
  int c, tx, ty, typ;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// A pack moves as one load or store of its width (16 bytes at most).
template <int Bytes>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<2> { using type = unsigned short; };

template <typename P>
static __device__ __forceinline__ P load(const P* p) {
  const auto r = *reinterpret_cast<const typename Raw<sizeof(P)>::type*>(p);
  P out;
  memcpy(&out, &r, sizeof(P));
  return out;
}

template <typename P>
static __device__ __forceinline__ void store(P* p, const P& v) {
  typename Raw<sizeof(P)>::type r;
  memcpy(&r, &v, sizeof(P));
  *reinterpret_cast<decltype(r)*>(p) = r;
}

static __device__ __forceinline__ float to_f(float v) { return v; }
static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
static __device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V, bool kBackward>
static __device__ __forceinline__ void accumulate(const Pack<T, V>& x, const Pack<T, V>& g,
                                                  const float* centre, float* s1, float* s2) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float d = __fsub_rn(to_f(x.v[k]), centre[k]);
    if constexpr (kBackward) {
      const float dy = to_f(g.v[k]);
      s1[k] = __fadd_rn(s1[k], dy);
      s2[k] = __fadd_rn(s2[k], __fmul_rn(dy, d));
    } else {
      s1[k] = __fadd_rn(s1[k], d);
      s2[k] = __fadd_rn(s2[k], __fmul_rn(d, d));
    }
  }
}

// (1) Per-block partial sums: forward of x - x[row 0] and its square,
// backward of dy and dy (x - mean).
template <typename T, int V, bool kBackward>
__global__ void __launch_bounds__(kThreads)
omni3d_bn_reduce(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ stats, float* __restrict__ part, Tiles t) {
  extern __shared__ float lanes[];  // [2][typ][tx * V]
  using P = Pack<T, V>;
  const int i = threadIdx.x % t.tx, j = threadIdx.x / t.tx;
  const int groups = t.c / V;
  const int g = blockIdx.y * t.tx + i;  // channels g V .. g V + V - 1
  const int width = t.tx * V;
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
  if (j < t.ty && g < groups) {
    const P* xp = reinterpret_cast<const P*>(x) + g;
    const P* gp = reinterpret_cast<const P*>(dy) + g;
    float centre[V];
    if constexpr (kBackward) {
#pragma unroll
      for (int k = 0; k < V; ++k) centre[k] = stats[2 * t.c + g * V + k];  // the mean
    } else {
      const P first = load(xp);
#pragma unroll
      for (int k = 0; k < V; ++k) centre[k] = to_f(first.v[k]);
    }
    const long long r0 = static_cast<long long>(blockIdx.x) * t.rows;
    const long long r1 = min(t.m, r0 + t.rows);
    long long r = r0 + j;
    for (; r + (kUnroll - 1) * t.ty < r1; r += kUnroll * t.ty) {
      P a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        a[u] = load(xp + (r + u * t.ty) * groups);
        if constexpr (kBackward) b[u] = load(gp + (r + u * t.ty) * groups);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate<T, V, kBackward>(a[u], b[u], centre, s1, s2);
    }
    for (; r < r1; r += t.ty) {
      P a = load(xp + r * groups), b;
      if constexpr (kBackward) b = load(gp + r * groups);
      accumulate<T, V, kBackward>(a, b, centre, s1, s2);
    }
  }
  // the block's row lanes, summed by a tree: lane j takes lane j + stride
  // while both exist (lanes ty .. typ - 1 are never written or read)
  float* h1 = lanes;
  float* h2 = lanes + t.typ * width;
  if (j < t.ty) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      h1[j * width + i * V + k] = s1[k];
      h2[j * width + i * V + k] = s2[k];
    }
  }
  __syncthreads();
  for (int stride = t.typ >> 1; stride > 0; stride >>= 1) {
    if (j < stride && j + stride < t.ty) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int at = j * width + i * V + k, from = at + stride * width;
        h1[at] = __fadd_rn(h1[at], h1[from]);
        h2[at] = __fadd_rn(h2[at], h2[from]);
      }
    }
    __syncthreads();
  }
  if (j == 0 && g < groups) {
    float* out = part + static_cast<long long>(blockIdx.x) * 2 * t.c + g * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      out[k] = h1[i * V + k];
      out[t.c + k] = h2[i * V + k];
    }
  }
}

// The two sums of channel ch over the partial rows, in float64: lane j
// sums rows j, j + kLanes, ..., then a tree over the lanes. Every thread of
// the block calls it; the sums are valid in lane 0.
static __device__ void merge_partials(const float* __restrict__ part, int blocks, int c, int ch,
                                      double& s1, double& s2) {
  __shared__ double sums[2][kLanes][kMergeChannels];
  const int i = threadIdx.x % kMergeChannels, j = threadIdx.x / kMergeChannels;
  double a1 = 0.0, a2 = 0.0;
  if (ch < c) {
    for (int p = j; p < blocks; p += kLanes) {
      const float* row = part + static_cast<long long>(p) * 2 * c;
      a1 = __dadd_rn(a1, static_cast<double>(row[ch]));
      a2 = __dadd_rn(a2, static_cast<double>(row[c + ch]));
    }
  }
  sums[0][j][i] = a1;
  sums[1][j][i] = a2;
  __syncthreads();
  for (int stride = kLanes / 2; stride > 0; stride >>= 1) {
    if (j < stride) {
      sums[0][j][i] = __dadd_rn(sums[0][j][i], sums[0][j + stride][i]);
      sums[1][j][i] = __dadd_rn(sums[1][j][i], sums[1][j + stride][i]);
    }
    __syncthreads();
  }
  s1 = sums[0][0][i];
  s2 = sums[1][0][i];
}

// (2) forward: the batch statistics, the affine, the running update.
template <typename T>
__global__ void __launch_bounds__(kLanes * kMergeChannels)
omni3d_bn_merge_fwd(const T* __restrict__ x, const float* __restrict__ part, int blocks,
                    long long m, int c, const float* __restrict__ weight,
                    const float* __restrict__ bias, float* __restrict__ running_mean,
                    float* __restrict__ running_var, int update, float* __restrict__ stats) {
  const int ch = blockIdx.x * kMergeChannels + threadIdx.x % kMergeChannels;
  double s1, s2;
  merge_partials(part, blocks, c, ch, s1, s2);
  if (threadIdx.x >= kMergeChannels || ch >= c) return;
  const double n = static_cast<double>(m);
  const double shift = __ddiv_rn(s1, n);
  double var_d = __dsub_rn(__ddiv_rn(s2, n), __dmul_rn(shift, shift));
  var_d = var_d < 0.0 ? 0.0 : var_d;  // a NaN stays NaN, as torch's clamp keeps it
  const float mean = __double2float_rn(__dadd_rn(static_cast<double>(to_f(x[ch])), shift));
  const float var = __double2float_rn(var_d);
  const float rstd = __double2float_rn(
      __ddiv_rn(1.0, __dsqrt_rn(static_cast<double>(__fadd_rn(var, kEps)))));
  const float a = __fmul_rn(weight[ch], rstd);
  stats[ch] = a;
  stats[c + ch] = __fsub_rn(bias[ch], __fmul_rn(mean, a));
  stats[2 * c + ch] = mean;
  stats[3 * c + ch] = rstd;
  if (update) {
    running_mean[ch] = __fadd_rn(__fmul_rn(kKeep, running_mean[ch]), __fmul_rn(kMomentum, mean));
    running_var[ch] = __fadd_rn(__fmul_rn(kKeep, running_var[ch]), __fmul_rn(kMomentum, var));
  }
}

// (2) backward: the parameters' gradients and dx's coefficients.
__global__ void __launch_bounds__(kLanes * kMergeChannels)
omni3d_bn_merge_bwd(const float* __restrict__ part, int blocks, long long m, int c,
                    const float* __restrict__ stats, float* __restrict__ grad_weight,
                    float* __restrict__ grad_bias, float* __restrict__ coef) {
  const int ch = blockIdx.x * kMergeChannels + threadIdx.x % kMergeChannels;
  double s1, s2;
  merge_partials(part, blocks, c, ch, s1, s2);
  if (threadIdx.x >= kMergeChannels || ch >= c) return;
  const double n = static_cast<double>(m);
  const double a = stats[ch], rstd = stats[3 * c + ch];
  const double sdx = __dmul_rn(s2, rstd);  // the sum of dy x-hat
  grad_weight[ch] = __double2float_rn(sdx);
  grad_bias[ch] = __double2float_rn(s1);
  coef[ch] = __double2float_rn(__ddiv_rn(__dmul_rn(a, s1), n));
  coef[c + ch] = __double2float_rn(__ddiv_rn(__dmul_rn(__dmul_rn(a, rstd), sdx), n));
}

// One pack of (3): forward y = x a + b; backward dx = a dy - b - k (x - mu)
// with b = c0.
template <typename T, int V, bool kBackward>
static __device__ __forceinline__ Pack<T, V> affine(const Pack<T, V>& x, const Pack<T, V>& g,
                                                    const float* a, const float* b,
                                                    const float* k0, const float* mu) {
  Pack<T, V> o;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float xf = to_f(x.v[k]);
    if constexpr (kBackward) {
      const float d = __fsub_rn(xf, mu[k]);
      o.v[k] = from_f<T>(
          __fsub_rn(__fsub_rn(__fmul_rn(a[k], to_f(g.v[k])), b[k]), __fmul_rn(k0[k], d)));
    } else {
      o.v[k] = from_f<T>(__fadd_rn(__fmul_rn(xf, a[k]), b[k]));
    }
  }
  return o;
}

// (3) forward y = x a + b; backward dx = a dy - c0 - k (x - mean).
template <typename T, int V, bool kBackward>
__global__ void __launch_bounds__(kThreads)
omni3d_bn_apply(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ stats, const float* __restrict__ coef,
                T* __restrict__ out, Tiles t) {
  using P = Pack<T, V>;
  const int i = threadIdx.x % t.tx, j = threadIdx.x / t.tx;
  const int groups = t.c / V;
  const int g = blockIdx.y * t.tx + i;
  if (j >= t.ty || g >= groups) return;
  float a[V], b[V], k0[V], mu[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = g * V + k;
    a[k] = stats[ch];
    if constexpr (kBackward) {
      b[k] = coef[ch];           // c0
      k0[k] = coef[t.c + ch];    // k
      mu[k] = stats[2 * t.c + ch];
    } else {
      b[k] = stats[t.c + ch];
    }
  }
  const P* xp = reinterpret_cast<const P*>(x) + g;
  const P* gp = reinterpret_cast<const P*>(dy) + g;
  P* op = reinterpret_cast<P*>(out) + g;
  const long long r0 = static_cast<long long>(blockIdx.x) * t.rows;
  const long long r1 = min(t.m, r0 + t.rows);
  long long r = r0 + j;
  for (; r + (kUnroll - 1) * t.ty < r1; r += kUnroll * t.ty) {
    P xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xv[u] = load(xp + (r + u * t.ty) * groups);
      if constexpr (kBackward) gv[u] = load(gp + (r + u * t.ty) * groups);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      store(op + (r + u * t.ty) * groups, affine<T, V, kBackward>(xv[u], gv[u], a, b, k0, mu));
    }
  }
  for (; r < r1; r += t.ty) {
    P xv = load(xp + r * groups), gv;
    if constexpr (kBackward) gv = load(gp + r * groups);
    store(op + r * groups, affine<T, V, kBackward>(xv, gv, a, b, k0, mu));
  }
}

// One call's pointers and geometry.
struct Call {
  const void* x;
  const void* dy;
  void* out;
  const float* weight;
  const float* bias;
  float* running_mean;
  float* running_var;
  int update;
  float* part;
  const float* stats;  // written by the forward's merge, read by every other kernel
  float* coef;
  float* grad_weight;
  float* grad_bias;
  Tiles t;
  int blocks, slabs;
  cudaStream_t stream;
};

template <typename T, int V, bool kBackward>
static cudaError_t launch(const Call& k) {
  const dim3 grid(k.blocks, k.slabs);
  const size_t shared = 2 * sizeof(float) * k.t.typ * k.t.tx * V;
  const T* x = static_cast<const T*>(k.x);
  const T* dy = static_cast<const T*>(k.dy);
  omni3d_bn_reduce<T, V, kBackward><<<grid, kThreads, shared, k.stream>>>(x, dy, k.stats, k.part,
                                                                           k.t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_blocks = (k.t.c + kMergeChannels - 1) / kMergeChannels;
  if constexpr (kBackward) {
    omni3d_bn_merge_bwd<<<merge_blocks, kLanes * kMergeChannels, 0, k.stream>>>(
        k.part, k.blocks, k.t.m, k.t.c, k.stats, k.grad_weight, k.grad_bias, k.coef);
  } else {
    omni3d_bn_merge_fwd<T><<<merge_blocks, kLanes * kMergeChannels, 0, k.stream>>>(
        x, k.part, k.blocks, k.t.m, k.t.c, k.weight, k.bias, k.running_mean, k.running_var,
        k.update, const_cast<float*>(k.stats));
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  omni3d_bn_apply<T, V, kBackward><<<grid, kThreads, 0, k.stream>>>(
      x, dy, k.stats, k.coef, static_cast<T*>(k.out), k.t);
  return cudaGetLastError();
}

template <bool kBackward>
static int dispatch(int bf16, int vec, const Call& k) {
  const Tiles& t = k.t;
  const int size = bf16 ? 2 : 4;
  const bool ok = t.m >= 1 && t.c >= 1 && vec >= 1 && vec * size <= 16 && t.c % vec == 0 &&
                  t.tx >= 1 && t.ty >= 1 && t.tx * t.ty <= kThreads && t.typ >= t.ty &&
                  t.typ < 2 * t.ty && (t.typ & (t.typ - 1)) == 0 && k.blocks >= 1 &&
                  k.slabs >= 1 && k.slabs <= 65535 && t.rows >= 1 &&
                  static_cast<long long>(k.blocks) * t.rows >= t.m &&
                  static_cast<long long>(k.slabs) * t.tx * vec >= t.c;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (bf16) {
    switch (vec) {
      case 1: err = launch<__nv_bfloat16, 1, kBackward>(k); break;
      case 2: err = launch<__nv_bfloat16, 2, kBackward>(k); break;
      case 4: err = launch<__nv_bfloat16, 4, kBackward>(k); break;
      case 8: err = launch<__nv_bfloat16, 8, kBackward>(k); break;
    }
  } else {
    switch (vec) {
      case 1: err = launch<float, 1, kBackward>(k); break;
      case 2: err = launch<float, 2, kBackward>(k); break;
      case 4: err = launch<float, 4, kBackward>(k); break;
    }
  }
  return static_cast<int>(err);
}

// Forward: y (channels-last, x's dtype), stats[4][c] = a, b, mean, rstd,
// and the running statistics updated in place when `update`. part holds
// blocks x 2 x c floats of scratch.
extern "C" int bn_forward(int bf16, int vec, const void* x, const float* weight,
                          const float* bias, float* running_mean, float* running_var, int update,
                          long long m, int c, int tx, int ty, int typ, long long rows, int blocks,
                          int slabs, float* part, float* stats, void* y, void* stream) {
  Call k{};
  k.x = x;
  k.out = y;
  k.weight = weight;
  k.bias = bias;
  k.running_mean = running_mean;
  k.running_var = running_var;
  k.update = update;
  k.part = part;
  k.stats = stats;
  k.t = Tiles{m, rows, c, tx, ty, typ};
  k.blocks = blocks;
  k.slabs = slabs;
  k.stream = static_cast<cudaStream_t>(stream);
  return dispatch<false>(bf16, vec, k);
}

// Backward: dx (channels-last, x's dtype) and the float32 gradients of
// weight and bias from x, dy and the forward's stats. part holds blocks x
// 2 x c floats of scratch, coef 2 x c.
extern "C" int bn_backward(int bf16, int vec, const void* x, const void* dy, const float* stats,
                           long long m, int c, int tx, int ty, int typ, long long rows,
                           int blocks, int slabs, float* part, float* coef, float* grad_weight,
                           float* grad_bias, void* dx, void* stream) {
  Call k{};
  k.x = x;
  k.dy = dy;
  k.out = dx;
  k.part = part;
  k.stats = stats;
  k.coef = coef;
  k.grad_weight = grad_weight;
  k.grad_bias = grad_bias;
  k.t = Tiles{m, rows, c, tx, ty, typ};
  k.blocks = blocks;
  k.slabs = slabs;
  k.stream = static_cast<cudaStream_t>(stream);
  return dispatch<true>(bf16, vec, k);
}
