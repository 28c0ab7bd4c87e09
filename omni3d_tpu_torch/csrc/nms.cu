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
// shifted by class). Boxes are cut into W = ceil(N / 64) tiles of 64, the
// width of a 64-bit word.
//
// The words. words[r, w, i] (R x W x 64W, uint64) holds, in bit b, whether
// box i suppresses box j = 64 w + b: valid_i, valid_j, j > i, j < N and
// IoU(box_i, box_j) > t. A block of the layout, words[r, w, 64 v .. 64 v +
// 63] for w >= v, is the pair tile (row tile v, column tile w): 512
// contiguous bytes. Blocks with w < v are never written and never read.
//
//  (a) nms_words_kernel: one warp per pair tile, eight per 256-thread
//      block. The tile index within a row is decoded in closed form from
//      the triangular number k = w (w + 1) / 2 + v. A tile whose row or
//      column tile holds no valid box (ballots over `valid`, tested per
//      tile: the valid boxes need not be a prefix, since a +NaN score sorts
//      first) writes zero words and tests nothing; select_proposals pads
//      its small levels with such tiles. Otherwise the warp stages the 64
//      column boxes and their areas in shared memory, each lane holds two
//      row boxes (v 64 + lane and + 32) in registers and tests them against
//      the 64 column boxes, and the warp stores its 64 words as two
//      coalesced 256-byte rows.
//  (b) nms_greedy_kernel: one 128-thread block per row, in lockstep over
//      the W tiles (one __syncthreads per tile). Warp 0 walks the serial
//      chain: for tile w it reads the tile's removed bits and its 64
//      diagonal words from shared memory, resolves the keep bits in
//      registers (64 steps of two instructions each, see resolve_tile),
//      then ORs the kept boxes' words of tile w + 1 (a lane per box, a warp
//      OR-reduction) into the bits that the next step starts from. Warps
//      1-3 meanwhile stage the words of later row tiles into a ring of 5
//      slots of shared memory with cp.async, three tiles ahead of the
//      chain, and fold the previous tile's kept boxes into the removed bits
//      of the tiles after the next (a lane per target tile, one load per
//      kept box), so the chain never waits on device memory. A slot holds
//      the blocks (s, s + k) of row tile s for k < 64: the diagonal block,
//      the next one, and the fold's targets; a fold target 64 or more tiles
//      ahead (N > 4096) is read from device memory by its folding lane, 62
//      tiles ahead of its need. Validity bits are taken once per row, and
//      the keep flags go through the sort order into input order after the
//      walk.
//
// The IoU test is bit-exact against torch. The intersection, union and
// areas are computed operation for operation as the plain PyTorch version
// (ops/nms.py::nms_mask_plain through utils/boxes.py::pairwise_iou) does:
// widths clamp(x2 - x1, 0), inter = w * h, union = (area_i + area_j) -
// inter, each step an explicitly rounded intrinsic (no FMA contraction),
// max / min propagating NaN as torch.maximum / torch.minimum do (fmaxf and
// fminf would drop it) and the clamp keeping NaN. Then iou = union > 0 ?
// inter / union : 0 and the bit is iou > t, decided per launch in one of
// two ways:
//  - t < 0 or NaN: every pair through the IEEE division __fdiv_rn.
//  - t >= 0: a pair can only pass if inter > 0 and union > 0 (inter = +-0,
//    inter = NaN or union <= 0 / NaN all give iou <= 0 or a false
//    comparison), so most pairs, which do not overlap, stop there. Else
//    the exact quotient q = inter / union decides: fl(q) > t iff q > m,
//    where m is the midpoint of t and the next float t+ (q = m exactly
//    cannot happen: m's significand is 25 bits with the last one set, and
//    inter = m * union would need that odd part to fit in inter's 24
//    bits). The wrapper passes hi >= m (1 + 2^-23) and lo <= m (1 -
//    2^-23) (float32, rounded outward, from exact double arithmetic; with
//    t in [2^-30, 2^30], else lo = -inf, hi = +inf). With inter >= 2^-60,
//    union >= inter (each area is at least inter, and rounding is
//    monotonic) unless union is NaN, so the products below are normal or
//    overflow to +inf:
//      inter > fl(hi * union) >= hi union (1 - 2^-24) > m union  -> set;
//      inter < fl(lo * union) <= lo union (1 + 2^-24) < m union  -> clear
//    (an overflow to +inf decides nothing on the first line and is exact
//    on the second: inter is finite). Only inside that band, about two
//    ULP of t on either side of m, at a NaN union or at 0 < inter < 2^-60
//    does the pair take __fdiv_rn(inter, union) > t: the slow path, run
//    for a warp's 16 columns only when one of its pairs needs it, and
//    counted when the caller asks (chip_smoke phase 12 prints the share).
//
// What bounds it on the H100. (a) tests N(N-1)/2 pairs per row at most
// (the bound counts the pairs of valid boxes, 13 float32 operations each)
// and writes 64 W (W + 1) / 2 words of 8 bytes per row; the operations set
// its bound (0.0113 ms for the RPN rows of a bf16 batch-32 inference call,
// chip_smoke phase 12). Without a branch in the pair loop a pair is about
// 21 instructions (6 max / min, 4 add, 3 multiply, the predicates and the
// bit), against the IEEE division's subroutine on every pair before; the
// loop interleaves 32 independent pairs per lane, and the max / min and
// compares, not the FMA pipe, set its pace. (b) moves about 17 bytes per
// box plus the kept boxes' later words (a few microseconds), but its floor
// is the serial chain: 64 dependent steps per tile, W tiles per row, plus
// the next tile's OR-reduction and one barrier per tile (0.95 us a tile
// for those rows, tools/profile_nms.py). Everything else stays off that
// chain: the staging runs ahead of it, the folds beside it. Rows run in
// parallel, one block each.
//
// The kernels allocate nothing and do not synchronise. Each C entry point
// returns the CUDA error of its launch (cudaGetLastError).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
using u32 = unsigned;

constexpr int kTile = 64;          // boxes per tile: the bits of a word
constexpr int kMaxBoxes = 16384;   // N bound: 256 tiles per row
constexpr int kMaxRows = 65535;    // grid.y of the words kernel
constexpr u32 kFull = 0xffffffffu;
constexpr int kWordsWarps = 8;     // (a): one pair tile per warp
constexpr int kGreedyWarps = 4;    // (b): warp 0 walks the chain, 1-3 fold and stage
constexpr int kRing = 5;           // (b): slots of staged row tiles
constexpr int kAhead = kRing - 3;  // (b): cp.async groups in flight past the current tile
constexpr int kStaged = 64;        // (b): blocks (s, s + k), k < kStaged, staged per slot
constexpr int kStride = kTile + 2; // (b): words per staged block: 16-byte aligned, and the
                                   // fold's lanes (one block each) spread over the banks

// torch.maximum / torch.minimum: NaN if either side is NaN
__device__ __forceinline__ float tmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float tmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
// clamp(x, min=0) with NaN kept: one max.NaN. It may return +0 where torch
// keeps -0; the sign of a zero changes no comparison below (inter > 0,
// union > 0, and a zero quotient against t all decide alike).
__device__ __forceinline__ float clamp0(float x) { return tmax(x, 0.f); }

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(clamp0(__fsub_rn(b.z, b.x)), clamp0(__fsub_rn(b.w, b.y)));
}

// The intersection and union of two boxes, rounded as torch rounds them.
__device__ __forceinline__ void inter_union(float4 a, float area_a, float4 b, float area_b,
                                            float& inter, float& uni) {
  const float iw = clamp0(__fsub_rn(tmin(a.z, b.z), tmax(a.x, b.x)));
  const float ih = clamp0(__fsub_rn(tmin(a.w, b.w), tmax(a.y, b.y)));
  inter = __fmul_rn(iw, ih);
  uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
}

// IoU(a, b) > t by the IEEE division, as torch decides it.
__device__ __forceinline__ bool iou_above_exact(float4 a, float area_a, float4 b, float area_b,
                                                float t) {
  float inter, uni;
  inter_union(a, area_a, b, area_b, inter, uni);
  return (uni > 0.f ? __fdiv_rn(inter, uni) : 0.f) > t;
}

// The fast test for t >= 0 (see the note above), without a branch: bit q of
// `set` if the products decide IoU > t; `unsure` if only the division can
// decide this pair (inter > 0 inside the band, a NaN union, or inter below
// 2^-60, where the products could be subnormal). inter > 0 implies union >=
// inter: each area is at least inter (rounding is monotonic), so fl(fl(a +
// b) - inter) >= fl(2 inter - inter) = inter, unless a NaN union fails
// every comparison and leaves the pair unsure.
__device__ __forceinline__ void iou_fast(float4 a, float area_a, float4 b, float area_b,
                                         float lo, float hi, int q, u32& set, bool& unsure) {
  float inter, uni;
  inter_union(a, area_a, b, area_b, inter, uni);
  const bool big = inter >= 0x1p-60f;
  const bool above = inter > __fmul_rn(hi, uni);
  const bool below = inter < __fmul_rn(lo, uni);
  set |= static_cast<u32>(big && above) << q;
  unsure |= inter > 0.f && !(big && (above || below));
}

// The same test for one pair, telling apart the pairs it leaves to the
// division.
__device__ __forceinline__ bool iou_unsure(float4 a, float area_a, float4 b, float area_b,
                                           float lo, float hi) {
  u32 set = 0;
  bool unsure = false;
  iou_fast(a, area_a, b, area_b, lo, hi, 0, set, unsure);
  return unsure;
}

template <bool kFast>
__global__ void __launch_bounds__(kWordsWarps * 32, 2)
nms_words_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid, int n,
                 int n_words, float t, float lo, float hi, u64* __restrict__ words,
                 u64* __restrict__ slow_pairs) {
  __shared__ float4 cbox[kWordsWarps][kTile];
  __shared__ float carea[kWordsWarps][kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWordsWarps + warp;
  if (k >= n_words * (n_words + 1) / 2) return;
  // k = ct (ct + 1) / 2 + rt with 0 <= rt <= ct: the float root, then one
  // integer correction either way
  int ct = static_cast<int>((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
  if ((ct + 1) * (ct + 2) / 2 <= k) ++ct;
  if (ct * (ct + 1) / 2 > k) --ct;
  const int rt = k - ct * (ct + 1) / 2;
  const size_t r = blockIdx.y;
  const float4* rb = boxes + r * n;
  const uint8_t* rv = valid + r * n;
  // every load issued before the first use
  const int i0 = rt * kTile + lane, j0 = ct * kTile + lane;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 a0 = i0 < n ? rb[i0] : zero, a1 = i0 + 32 < n ? rb[i0 + 32] : zero;
  const float4 c0 = j0 < n ? rb[j0] : zero, c1 = j0 + 32 < n ? rb[j0 + 32] : zero;
  const bool vi0 = i0 < n && rv[i0], vi1 = i0 + 32 < n && rv[i0 + 32];
  const bool vj0 = j0 < n && rv[j0], vj1 = j0 + 32 < n && rv[j0 + 32];
  const u64 rvalid = __ballot_sync(kFull, vi0) | static_cast<u64>(__ballot_sync(kFull, vi1)) << 32;
  const u64 cvalid = __ballot_sync(kFull, vj0) | static_cast<u64>(__ballot_sync(kFull, vj1)) << 32;
  u64* out = words + (r * n_words + ct) * (static_cast<size_t>(n_words) * kTile) + rt * kTile;
  if (rvalid == 0 || cvalid == 0) {
    out[lane] = 0;
    out[lane + 32] = 0;
    return;
  }
  cbox[warp][lane] = c0;
  cbox[warp][lane + 32] = c1;
  carea[warp][lane] = box_area(c0);
  carea[warp][lane + 32] = box_area(c1);
  const float area0 = box_area(a0), area1 = box_area(a1);
  // the bits each row box may set: valid columns, and j > i on the diagonal
  u64 need0 = vi0 ? cvalid : 0, need1 = vi1 ? cvalid : 0;
  if (ct == rt) {
    need0 &= ~0ull << (lane + 1);
    need1 &= lane == 31 ? 0 : ~0ull << (lane + 33);
  }
  __syncwarp();
  u64 bits0 = 0, bits1 = 0;
  u32 slow = 0;
#pragma unroll 1
  for (int b0 = 0; b0 < kTile; b0 += 16) {
    u32 m0 = 0, m1 = 0;
    bool unsure = !kFast;
    if (kFast) {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float4 c = cbox[warp][b0 + q];
        const float ac = carea[warp][b0 + q];
        iou_fast(a0, area0, c, ac, lo, hi, q, m0, unsure);
        iou_fast(a1, area1, c, ac, lo, hi, q, m1, unsure);
      }
    }
    // the pairs left to the division: rare for t >= 0, all of them else
    if (__any_sync(kFull, unsure)) {
      const u32 n0 = static_cast<u32>(need0 >> b0), n1 = static_cast<u32>(need1 >> b0);
      for (int q = 0; q < 16; ++q) {
        const float4 c = cbox[warp][b0 + q];
        const float ac = carea[warp][b0 + q];
        if (!kFast || iou_unsure(a0, area0, c, ac, lo, hi)) {
          m0 = (m0 & ~(1u << q)) | static_cast<u32>(iou_above_exact(a0, area0, c, ac, t)) << q;
          slow += (n0 >> q) & 1;
        }
        if (!kFast || iou_unsure(a1, area1, c, ac, lo, hi)) {
          m1 = (m1 & ~(1u << q)) | static_cast<u32>(iou_above_exact(a1, area1, c, ac, t)) << q;
          slow += (n1 >> q) & 1;
        }
      }
    }
    bits0 |= static_cast<u64>(m0) << b0;
    bits1 |= static_cast<u64>(m1) << b0;
  }
  out[lane] = bits0 & need0;
  out[lane + 32] = bits1 & need1;
  if (slow_pairs != nullptr) {
    slow = __reduce_add_sync(kFull, slow);
    if (lane == 0 && slow != 0) atomicAdd(slow_pairs, static_cast<u64>(slow));
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const u32 s = static_cast<u32>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// OR of the words of the kept boxes (bits of `kept`) in one 64-word block,
// a lane per box: every lane gets the result
__device__ __forceinline__ u64 fold_block(const u64* blk, u64 kept, int lane) {
  const u64 v = (((kept >> lane) & 1) ? blk[lane] : 0ull) |
                (((kept >> (lane + 32)) & 1) ? blk[lane + 32] : 0ull);
  return __reduce_or_sync(kFull, static_cast<u32>(v)) |
         static_cast<u64>(__reduce_or_sync(kFull, static_cast<u32>(v >> 32))) << 32;
}

// OR of the words of the kept boxes in one block, by one lane: one load per
// kept box, independent of each other
__device__ __forceinline__ u64 fold_words(const u64* blk, u64 kept) {
  u64 acc0 = 0, acc1 = 0;
#pragma unroll
  for (int b = 0; b < kTile; b += 2) {
    if ((kept >> b) & 1) acc0 |= blk[b];
    if ((kept >> (b + 1)) & 1) acc1 |= blk[b + 1];
  }
  return acc0 | acc1;
}

// Bit n - 1 of a replicated over bits n - 1 .. 31, the bits below kept: one
// szext (SGXT), no predicate.
__device__ __forceinline__ u32 sign_from(u32 a, u32 n) {
  u32 r;
  asm("szext.clamp.s32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(n));
  return r;
}

// The greedy keep bits of one tile from its available bits (valid, not
// removed by earlier tiles) and its diagonal words d: box b is kept iff its
// bit is still set when the walk reaches it, and a kept box clears the bits
// of the boxes it suppresses. d[b] has bits above b only, so with m = bit b
// of the available bits replicated from b upwards, d[b] & m is d[b] if box
// b is kept and 0 if not: a step of the chain is two instructions (szext,
// then an AND-NOT), with no predicate and no branch. The low half's kept
// boxes clear the high half through `hrem`, off the low half's chain. The
// 64 words are read from shared memory ahead of the chain, which runs on
// registers.
__device__ __forceinline__ u64 resolve_tile(u64 avail, const u64* d) {
  u32 alo = static_cast<u32>(avail), ahi = static_cast<u32>(avail >> 32), hrem = 0;
  if (alo != 0) {
    u64 x[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) x[b] = d[b];
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const u32 m = sign_from(alo, b + 1);
      alo &= ~(static_cast<u32>(x[b]) & m);
      hrem |= static_cast<u32>(x[b] >> 32) & static_cast<u32>(static_cast<int>(m) >> 31);
    }
  }
  ahi &= ~hrem;
  if (ahi != 0) {
    u32 x[31];
#pragma unroll
    for (int b = 0; b < 31; ++b) x[b] = static_cast<u32>(d[32 + b] >> 32);
#pragma unroll
    for (int b = 0; b < 31; ++b) ahi &= ~(x[b] & sign_from(ahi, b + 1));   // box 63 clears nothing
  }
  return alo | static_cast<u64>(ahi) << 32;
}

__global__ void __launch_bounds__(kGreedyWarps * 32)
nms_greedy_kernel(const u64* __restrict__ words, const uint8_t* __restrict__ valid,
                  const int64_t* __restrict__ order, int n, int n_words, int staged,
                  uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) u64 smem[];
  u64* ring = smem;                                  // kRing slots of staged x kStride words
  u64* removed = ring + kRing * staged * kStride;    // n_words: removals folded by warps 1-3
  u64* vbits = removed + n_words;                    // n_words: validity bits per tile
  u64* kept = vbits + n_words;                       // n_words: keep bits per tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row = blockIdx.x;
  const size_t np = static_cast<size_t>(n_words) * kTile;
  const u64* rw = words + row * n_words * np;
  const uint8_t* rv = valid + row * n;

  // row tile s's blocks (s, s + k), k < staged, into slot s % kRing, by
  // warps 1-3 (the chain warp copies nothing); one commit group per call,
  // empty past the last tile
  auto stage = [&](int s) {
    if (s < n_words) {
      const int nb = min(staged, n_words - s);
      u64* dst = ring + (s % kRing) * staged * kStride;
      for (int c = tid - 32; c < nb * 32; c += (kGreedyWarps - 1) * 32) {
        const int k = c >> 5, q = (c & 31) * 2;
        cp_async16(dst + k * kStride + q, rw + (s + k) * np + s * kTile + q);
      }
    }
    cp_async_commit();
  };
  if (warp != 0) {
    for (int s = 0; s <= kAhead; ++s) stage(s);
  }
  for (int w = tid; w < n_words; w += kGreedyWarps * 32) removed[w] = 0;
  for (int w = warp; w < n_words; w += kGreedyWarps) {
    const int i = w * kTile + lane;
    const u32 lo = __ballot_sync(kFull, i < n && rv[i]);
    const u32 hi = __ballot_sync(kFull, i + 32 < n && rv[i + 32]);
    if (lane == 0) vbits[w] = lo | static_cast<u64>(hi) << 32;
  }

  u64 next = 0;   // warp 0: the removals of tile w by tile w - 1's kept boxes
  for (int w = 0; w < n_words; ++w) {
    cp_async_wait<kAhead>();   // this thread's copies of tile w have landed
    __syncthreads();           // everyone's have; kept[w - 1] and removed[w] are final
    if (warp == 0) {
      const u64* slot = ring + (w % kRing) * staged * kStride;
      const u64 kw = resolve_tile(vbits[w] & ~(removed[w] | next), slot);
      next = w + 1 < n_words ? fold_block(slot + kStride, kw, lane) : 0;
      if (lane == 0) kept[w] = kw;
    } else {
      stage(w + kAhead + 1);   // into the slot of tile w - 2, read by nobody now
      if (w == 0) continue;
      // fold tile s = w - 1's kept boxes into the tiles after w, a lane per
      // target tile
      const int s = w - 1;
      const u64 ks = kept[s];
      if (ks != 0) {
        const u64* slot = ring + (s % kRing) * staged * kStride;
        for (int tgt = w + tid - 31; tgt < n_words; tgt += (kGreedyWarps - 1) * 32) {
          const int k = tgt - s;
          removed[tgt] |= fold_words(k < staged ? slot + k * kStride : rw + tgt * np + s * kTile,
                                     ks);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < n; i += kGreedyWarps * 32) {
    const int64_t dst = order ? order[row * n + i] : i;
    keep[row * n + dst] = static_cast<uint8_t>((kept[i / kTile] >> (i % kTile)) & 1);
  }
}

int n_tiles(int n) { return (n + kTile - 1) / kTile; }
int greedy_staged(int n) { return n_tiles(n) < kStaged ? n_tiles(n) : kStaged; }
size_t greedy_shared_bytes(int n) {
  return (static_cast<size_t>(kRing) * greedy_staged(n) * kStride + 3 * n_tiles(n)) * sizeof(u64);
}

}  // namespace

extern "C" int nms_suppression_words(const float* boxes, const uint8_t* valid, int rows, int n,
                                     float threshold, int fast, float lo, float hi, u64* words,
                                     u64* slow_pairs, void* stream) {
  if (rows < 1 || rows > kMaxRows || n < 1 || n > kMaxBoxes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int w = n_tiles(n);
  const dim3 grid((w * (w + 1) / 2 + kWordsWarps - 1) / kWordsWarps, rows);
  const auto* b = reinterpret_cast<const float4*>(boxes);
  auto* s = static_cast<cudaStream_t>(stream);
  if (fast) {
    nms_words_kernel<true><<<grid, kWordsWarps * 32, 0, s>>>(b, valid, n, w, threshold, lo, hi,
                                                               words, slow_pairs);
  } else {
    nms_words_kernel<false><<<grid, kWordsWarps * 32, 0, s>>>(b, valid, n, w, threshold, lo, hi,
                                                                words, slow_pairs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nms_greedy_keep(const u64* words, const uint8_t* valid, const int64_t* order,
                               int rows, int n, uint8_t* keep, void* stream) {
  if (rows < 1 || n < 1 || n > kMaxBoxes) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = greedy_shared_bytes(n);
  static size_t allowed = 48 * 1024;
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = bytes;
  }
  nms_greedy_kernel<<<rows, kGreedyWarps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      words, valid, order, n, n_tiles(n), greedy_staged(n), keep);
  return static_cast<int>(cudaGetLastError());
}

// The launch configuration for R rows of N boxes: out = {words grid.x,
// grid.y, block; greedy grid, block, dynamic shared bytes}.
extern "C" void nms_launch_shapes(int rows, int n, int* out) {
  const int w = n_tiles(n);
  out[0] = (w * (w + 1) / 2 + kWordsWarps - 1) / kWordsWarps;
  out[1] = rows;
  out[2] = kWordsWarps * 32;
  out[3] = rows;
  out[4] = kGreedyWarps * 32;
  out[5] = static_cast<int>(greedy_shared_bytes(n));
}
