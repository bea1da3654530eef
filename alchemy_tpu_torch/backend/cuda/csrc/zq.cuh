// Exact mod-q device arithmetic on uint32 residues, q < 2^31.
//
// Replaces the TPU helpers of alchemy_tpu/backend/pallas/ntt_pallas.py:31-209
// (_mulhi, _shoup, _reduce_u32, the bf16 digit-plane matmul recombination)
// and mul_relin_pallas.py:95-133 (_mulmod_gen, _addmod, _submod, _dft4).
// The TPU has no 64-bit lanes and no mulhi, so it splits words into 16-bit
// halves and multiplies through bf16 planes; Hopper has __umulhi and a
// native 32x32->64 product, so each of these is a few instructions.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace zq {

// Per-limb constants, packed by the host as 8 uint32 words:
// q, n^-1 mod q, its Shoup companion, floor(2^32/q), floor(2^64/q) (lo, hi).
struct Limb {
  uint32_t q, n_inv, n_inv_s, one_s;
  uint64_t barrett;
};
constexpr int kLimbWords = 8;

__device__ __forceinline__ Limb load_limb(const uint32_t* __restrict__ c) {
  Limb k;
  k.q = c[0];
  k.n_inv = c[1];
  k.n_inv_s = c[2];
  k.one_s = c[3];
  k.barrett = (static_cast<uint64_t>(c[5]) << 32) | c[4];
  return k;
}

// a + b mod q and a - b mod q for canonical a, b < q < 2^31.
__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// a*w mod q for a constant w < q with Shoup companion ws = floor(w*2^32/q):
// exact and canonical for ANY uint32 a (the quotient estimate is off by at
// most one, so the wrapped difference lies in [0, 2q)).
__device__ __forceinline__ uint32_t mulmod_shoup(uint32_t a, uint32_t w, uint32_t ws,
                                                 uint32_t q) {
  const uint32_t hi = __umulhi(a, ws);
  const uint32_t r = a * w - hi * q;
  return r >= q ? r - q : r;
}

// x mod q for any uint32 x: the Shoup product by w = 1.
__device__ __forceinline__ uint32_t reduce(uint32_t x, const Limb& k) {
  return mulmod_shoup(x, 1u, k.one_s, k.q);
}

// a*b mod q for variable a, b < 2^32 (Barrett on the 64-bit product with
// m = floor(2^64/q): the quotient estimate is off by at most one).
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b, const Limb& k) {
  const uint64_t x = static_cast<uint64_t>(a) * b;
  const uint64_t r = x - __umul64hi(x, k.barrett) * k.q;
  return static_cast<uint32_t>(r >= k.q ? r - k.q : r);
}

// Word i of the row a forward pass loads (x_i, any uint32): the row in device
// memory (kernels B, 6 and 8), or a callable that returns the kernel's
// prologue for coefficient i (kernel 7's correction and division by P;
// kernel 4's base extension), which never goes to device memory. (A plain
// pointer keeps the register count of 6 and 8: read through a callable, B
// once spilled under a 32-register cap.)
__device__ __forceinline__ uint32_t elem(const uint32_t* __restrict__ x, int i) { return x[i]; }
template <typename F>
__device__ __forceinline__ uint32_t elem(const F& f, int i) { return f(i); }

// ---------------------------------------------------------------------------
// The negacyclic NTT of every kernel here (Cooley-Tukey forward, natural
// order in): afterwards word i holds x(psi^(2*bitrev(i)+1)), and the host's
// slot tables map each radix-2 index i to its slot. tw/tws hold psi^bitrev(k)
// (psi^-bitrev(k) for the Gentleman-Sande inverse, which takes that order
// back to natural order) and their Shoup companions. A limb is split over
// two blocks (or four): block `part` holds half `part` of it, word j of the
// half being index part*n/2 + j of the whole. Only the first forward stage
// (and the last inverse one) pairs words of different halves; the forward
// kernels fuse it into their load, the inverse ones end with it across a
// cluster (inverse_last_stage).
//
// The forward NTT is register-blocked (kernels B, 4, 6, 7 and 8). Each
// thread holds R = 2^RL words of its half in registers and runs RL
// butterfly stages on them with no barrier between: a pass. One exchange
// through shared memory and one __syncthreads separate passes, so with
// passes of up to 4 stages a half of 2^14 words (n = 2^15) takes passes of
// 4, 4, 4 and 2 stages instead of 14 barrier-separated ones, and 2^15 words
// 4, 4, 4, 3. The widest pass (kMaxRL) is each launch shape's (Shape in
// mul_relin.cu, GridShape below): the values, twiddles and loads in flight
// of a pass must fit the registers.
//
// A pass whose stages have local strides 2^(lo_b + RL - 1) ... 2^lo_b gives
// group g = hi*2^lo_b + lo (lo < 2^lo_b) the words
// j = hi*2^(lo_b + RL) + r*2^lo_b + lo, r < R; its stage u (u < RL) pairs r
// with r + R/2^(u+1) under the twiddle
// m + part*m/2 + (hi << u) + (r >> (RL - u)), m = 2^(log_n - 1 - log_t) the
// stage's groups in the whole transform: 2^u (value, companion) pairs,
// read once per group. Shared memory holds the half with one spare word
// after every 32 (pad): a pass whose groups are contiguous (lo_b = 0) then
// stores, and the slot-order gathers load, without bank conflicts.
// tests/test_torch_mul_relin.py emulates this schedule in numpy.

// Shared-memory position of word j of a half, and the words of the padded half.
__device__ __forceinline__ int pad(int j) { return j + (j >> 5); }
__host__ __device__ constexpr int padded_words(int half) { return half + (half >> 5); }

// kCount consecutive words from p, a multiple of kCount words into a 16-byte
// aligned table, in accesses of up to 16 bytes.
template <int kCount>
__device__ __forceinline__ void load_words(uint32_t (&d)[kCount], const uint32_t* __restrict__ p) {
  if constexpr (kCount >= 4) {
#pragma unroll
    for (int i = 0; i < kCount / 4; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      d[4 * i] = v.x, d[4 * i + 1] = v.y, d[4 * i + 2] = v.z, d[4 * i + 3] = v.w;
    }
  } else if constexpr (kCount == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    d[0] = v.x, d[1] = v.y;
  } else {
    d[0] = __ldg(p);
  }
}

// Stage u of a pass: r pairs with r + R/2^(u+1) under twiddle
// w0 + (r >> (RL - u)), w0 = m + part*m/2 + (hi << u) a multiple of 2^u, so
// the stage's 2^u (value, companion) pairs are two aligned runs of the
// tables, read 4 pairs at a time. kSplit = 2 (a limb over four blocks, part
// < 4 a quarter): m + part*m/4 + (hi << u).
template <int RL, int U, int kSplit = 1>
__device__ __forceinline__ void pass_stage(uint32_t (&v)[1 << RL], int log_n, int part, int lo_b,
                                           int hi, const uint32_t* __restrict__ tw,
                                           const uint32_t* __restrict__ tws, uint32_t q) {
  constexpr int kTw = 1 << U, kChunk = kTw < 4 ? kTw : 4, t = (1 << RL) >> (U + 1);
  const int m = 1 << (log_n - lo_b - RL + U);   // log_t = lo_b + RL - 1 - U
  const int w0 = m + part * (m >> kSplit) + (hi << U);
#pragma unroll
  for (int c0 = 0; c0 < kTw; c0 += kChunk) {
    uint32_t w[kChunk], ws[kChunk];
    load_words<kChunk>(w, tw + w0 + c0);
    load_words<kChunk>(ws, tws + w0 + c0);
#pragma unroll
    for (int blk = 0; blk < kChunk; ++blk) {
#pragma unroll
      for (int c = 0; c < t; ++c) {
        const int r = 2 * t * (c0 + blk) + c;
        const uint32_t a = v[r];
        const uint32_t b = mulmod_shoup(v[r + t], w[blk], ws[blk], q);
        v[r] = add_mod(a, b, q);
        v[r + t] = sub_mod(a, b, q);
      }
    }
  }
}

template <int RL, int kSplit = 1>
__device__ __forceinline__ void pass_butterflies(uint32_t (&v)[1 << RL], int log_n, int part,
                                                 int lo_b, int hi,
                                                 const uint32_t* __restrict__ tw,
                                                 const uint32_t* __restrict__ tws, uint32_t q) {
  pass_stage<RL, 0, kSplit>(v, log_n, part, lo_b, hi, tw, tws, q);
  if constexpr (RL > 1) pass_stage<RL, 1, kSplit>(v, log_n, part, lo_b, hi, tw, tws, q);
  if constexpr (RL > 2) pass_stage<RL, 2, kSplit>(v, log_n, part, lo_b, hi, tw, tws, q);
  if constexpr (RL > 3) pass_stage<RL, 3, kSplit>(v, log_n, part, lo_b, hi, tw, tws, q);
  static_assert(RL <= 4, "passes of up to 4 stages");
}

// The two halves of a cluster barrier: arrive (release) after this thread's
// last read of the partner's shared memory, wait (acquire) before writing
// what the partner may still be reading. Every thread of both blocks
// arrives, then waits, once per barrier.
__device__ __forceinline__ void cluster_arrive() {
  cooperative_groups::this_cluster().barrier_arrive();
}
__device__ __forceinline__ void cluster_wait() {
  cooperative_groups::this_cluster().barrier_wait();
}

// Where a pass takes its words: shared memory (rewritten in place: each
// group's words are its own thread's); device memory, with the stage that
// crosses the halves fused into the load (block `part` keeps x_j + w*x_{j +
// n/2}, part 0, or x_j - w*x_{j + n/2}, part 1, w the stage's one twiddle,
// x_i = elem(load, i)); or the pair of shared halves of a cluster of two
// (ntt_forward_pair below), with that stage done in the read.
enum PassFrom { kFromShared, kFromLoad, kFromPair };

// The two stages that cross the quarters of a limb split over four blocks,
// fused into a load from device memory (kernels 6 and 8 on small grids):
// word j of quarter part from x_{j + c*n/4} = elem(load, j + c*n/4), any
// uint32: a = x_0 +- w1*x_2, b = x_1 +- w1*x_3 (- for the second half),
// then a +- w_{2+half}*b (- for the odd quarters).
struct QuarterTwiddles {
  uint32_t w1, w1s, w2, w2s;
};

__device__ __forceinline__ QuarterTwiddles quarter_twiddles(const uint32_t* __restrict__ tw,
                                                            const uint32_t* __restrict__ tws,
                                                            int part) {
  return {__ldg(tw + 1), __ldg(tws + 1), __ldg(tw + 2 + (part >> 1)), __ldg(tws + 2 + (part >> 1))};
}

template <typename Load>
__device__ __forceinline__ uint32_t quarter_load(Load load, int j, int quarter, int part,
                                                 const QuarterTwiddles& w, const Limb& k) {
  const uint32_t x0 = reduce(elem(load, j), k), x1 = reduce(elem(load, j + quarter), k);
  const uint32_t y2 = mulmod_shoup(elem(load, j + 2 * quarter), w.w1, w.w1s, k.q);
  const uint32_t y3 = mulmod_shoup(elem(load, j + 3 * quarter), w.w1, w.w1s, k.q);
  const bool upper = part >> 1;
  const uint32_t a = upper ? sub_mod(x0, y2, k.q) : add_mod(x0, y2, k.q);
  const uint32_t b = upper ? sub_mod(x1, y3, k.q) : add_mod(x1, y3, k.q);
  const uint32_t c = mulmod_shoup(b, w.w2, w.w2s, k.q);
  return part & 1 ? sub_mod(a, c, k.q) : add_mod(a, c, k.q);
}

// One pass over the groups of the half (group g on thread g mod blockDim,
// hi = g >> lo_b; the first pass has hi = 0). kFromPair: both blocks of the
// cluster read both halves, so every thread runs the same number of groups
// and the stores wait for a cluster barrier after the reads. kSplit = 2: the
// limb is split over four blocks and a holds quarter part (kFromLoad fuses
// the two cross-quarter stages into the load, quarter_load).
template <int RL, int kFrom, int kSplit = 1, typename Load>
__device__ __forceinline__ void forward_pass(uint32_t* a, Load load, int log_n, int part, int lo_b,
                                             const uint32_t* __restrict__ tw,
                                             const uint32_t* __restrict__ tws, const Limb& k) {
  static_assert(kSplit == 1 || kFrom != kFromPair, "the pair form splits a limb in two");
  const int half = 1 << (log_n - kSplit), groups = half >> RL;
  const int bd = static_cast<int>(blockDim.x);
  const int end = kFrom == kFromPair ? (groups + bd - 1) / bd * bd : groups;
  const uint32_t* other = a;
  if constexpr (kFrom == kFromPair) {
    other = cooperative_groups::this_cluster().map_shared_rank(a, static_cast<unsigned>(part ^ 1));
  }
  for (int g = threadIdx.x; g < end; g += bd) {
    const bool active = g < groups;
    const int hi = g >> lo_b;
    const int base = (hi << (lo_b + RL)) | (g & ((1 << lo_b) - 1));
    uint32_t v[1 << RL];
    if (active) {
      if constexpr (kFrom == kFromLoad && kSplit == 2) {
        const QuarterTwiddles w = quarter_twiddles(tw, tws, part);
#pragma unroll
        for (int r = 0; r < (1 << RL); ++r) v[r] = quarter_load(load, base + (r << lo_b), half, part, w, k);
      } else if constexpr (kFrom == kFromLoad) {
        const uint32_t w = __ldg(tw + 1), ws = __ldg(tws + 1);
#pragma unroll
        for (int r = 0; r < (1 << RL); ++r) {
          const int j = base + (r << lo_b);
          const uint32_t x = reduce(elem(load, j), k);
          const uint32_t y = mulmod_shoup(elem(load, j + half), w, ws, k.q);
          v[r] = part ? sub_mod(x, y, k.q) : add_mod(x, y, k.q);
        }
      } else if constexpr (kFrom == kFromPair) {
        // half 0 holds x_j, half 1 w*x_{j + n/2} (forward_pair)
#pragma unroll
        for (int r = 0; r < (1 << RL); ++r) {
          const int j = pad(base + (r << lo_b));
          v[r] = part ? sub_mod(other[j], a[j], k.q) : add_mod(a[j], other[j], k.q);
        }
      } else {
#pragma unroll
        for (int r = 0; r < (1 << RL); ++r) v[r] = a[pad(base + (r << lo_b))];
      }
    }
    if constexpr (kFrom == kFromPair) cluster_arrive();  // done reading the partner's half
    if (active) pass_butterflies<RL, kSplit>(v, log_n, part, lo_b, hi, tw, tws, k.q);
    if constexpr (kFrom == kFromPair) cluster_wait();    // the partner is done reading ours
    if (active) {
#pragma unroll
      for (int r = 0; r < (1 << RL); ++r) a[pad(base + (r << lo_b))] = v[r];
    }
  }
}

// forward_pass<rl, kFrom, kSplit> for a runtime rl in [1, RL].
template <int RL, int kFrom, int kSplit = 1, typename Load>
__device__ __forceinline__ void forward_pass_of(int rl, uint32_t* a, Load load, int log_n,
                                                int part, int lo_b,
                                                const uint32_t* __restrict__ tw,
                                                const uint32_t* __restrict__ tws, const Limb& k) {
  if constexpr (RL > 1) {
    if (rl < RL) {
      forward_pass_of<RL - 1, kFrom, kSplit>(rl, a, load, log_n, part, lo_b, tw, tws, k);
      return;
    }
  }
  forward_pass<RL, kFrom, kSplit>(a, load, log_n, part, lo_b, tw, tws, k);
}

// The forward NTT of half `part` of a split limb, register-blocked: a first
// pass of kFirstRL stages, which takes the words from `load` (kFromLoad) or
// from the cluster's two halves (kFromPair), then passes of kMaxRL stages
// from shared memory, the last one shorter (n >= 4). Leaves the padded half
// in a (word j at pad(j)) in bit-reversed evaluation order; every
// thread calls it, and it returns synchronised. The caller synchronises
// before it if a is still being read. kSplit = 2: quarter part of a limb
// split over four blocks (n >= 8), the two cross-quarter stages in the load.
template <int kMaxRL, int kFirstRL, int kFrom = kFromLoad, int kSplit = 1, typename Load>
__device__ __forceinline__ void ntt_forward_passes(uint32_t* a, Load load, int log_n, int part,
                                                   const uint32_t* __restrict__ tw,
                                                   const uint32_t* __restrict__ tws,
                                                   const Limb& k) {
  const int log_h = log_n - kSplit;
  int lo_b = log_h > kFirstRL ? log_h - kFirstRL : 0;
  forward_pass_of<kFirstRL, kFrom, kSplit>(log_h - lo_b, a, load, log_n, part, lo_b, tw, tws, k);
  __syncthreads();
  while (lo_b > 0) {
    const int rl = lo_b > kMaxRL ? kMaxRL : lo_b;
    lo_b -= rl;
    forward_pass_of<kMaxRL, kFromShared, kSplit>(rl, a, load, log_n, part, lo_b, tw, tws, k);
    __syncthreads();
  }
}

// ntt_forward_passes for the two blocks of a cluster (rank = part), when the
// load is dear (kernel 4's base extension, kernel 7's prologue): each block
// evaluates the load only on its own half, x_j in half 0 and w*x_{j + n/2}
// in half 1 (w the cross-half stage's twiddle), and the first pass reads the
// partner's half through distributed shared memory. The caller synchronises
// before it if a is still being read.
template <int kMaxRL, int kFirstRL, typename Load>
__device__ __forceinline__ void ntt_forward_pair(uint32_t* a, Load load, int log_n, int part,
                                                 const uint32_t* __restrict__ tw,
                                                 const uint32_t* __restrict__ tws,
                                                 const Limb& k) {
  const int half = 1 << (log_n - 1);
  const uint32_t w = __ldg(tw + 1), ws = __ldg(tws + 1);
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    const uint32_t x = elem(load, part * half + j);
    a[pad(j)] = part ? mulmod_shoup(x, w, ws, k.q) : reduce(x, k);
  }
  cooperative_groups::this_cluster().sync();
  ntt_forward_passes<kMaxRL, kFirstRL, kFromPair>(a, load, log_n, part, tw, tws, k);
}

// ---------------------------------------------------------------------------
// The register-blocked inverse NTT of kernels A, 5 and 9: the Gentleman-Sande
// mirror of ntt_forward_passes on the padded half in shared memory, passes
// of up to kMaxRL stages from the smallest stride up, one barrier between
// passes. A pass whose stages have local strides 2^lo_b ... 2^(lo_b + RL - 1)
// gives group g = hi*2^lo_b + lo the words j = hi*2^(lo_b + RL) + r*2^lo_b +
// lo, r < R, as in the forward passes; its stage u pairs r with r + 2^u (bit
// u of r clear) under the twiddle h + part*h/2 + (hi << (RL - 1 - u)) +
// (r >> (u + 1)), h = 2^(log_n - 1 - lo_b - u) the stage's groups in the
// whole transform: 2^(RL - 1 - u) (value, companion) pairs a group, two
// aligned runs of the tables read 4 pairs at a time. The stage that crosses
// the halves is inverse_last_stage's. tests/test_torch_rescale.py emulates
// this schedule in numpy. kSplit = 2: quarter part of a limb split over four
// blocks, twiddles h + part*h/4 + ..., and the two cross-quarter stages are
// inverse_last_stages4's.
template <int RL, int U, int kSplit = 1>
__device__ __forceinline__ void inverse_pass_stage(uint32_t (&v)[1 << RL], int log_n, int part,
                                                   int lo_b, int hi,
                                                   const uint32_t* __restrict__ tw,
                                                   const uint32_t* __restrict__ tws, uint32_t q) {
  constexpr int kTw = 1 << (RL - 1 - U), kChunk = kTw < 4 ? kTw : 4, s = 1 << U;
  const int h = 1 << (log_n - 1 - lo_b - U);   // log_t = lo_b + U
  const int w0 = h + part * (h >> kSplit) + (hi << (RL - 1 - U));
#pragma unroll
  for (int c0 = 0; c0 < kTw; c0 += kChunk) {
    uint32_t w[kChunk], ws[kChunk];
    load_words<kChunk>(w, tw + w0 + c0);
    load_words<kChunk>(ws, tws + w0 + c0);
#pragma unroll
    for (int blk = 0; blk < kChunk; ++blk) {
#pragma unroll
      for (int c = 0; c < s; ++c) {
        const int r = 2 * s * (c0 + blk) + c;
        const uint32_t a = v[r], b = v[r + s];
        v[r] = add_mod(a, b, q);
        v[r + s] = mulmod_shoup(sub_mod(a, b, q), w[blk], ws[blk], q);
      }
    }
  }
}

// One inverse pass of RL stages over the groups of the half (quarter), in place.
template <int RL, int kSplit = 1>
__device__ __forceinline__ void inverse_pass(uint32_t* a, int log_n, int part, int lo_b,
                                             const uint32_t* __restrict__ tw,
                                             const uint32_t* __restrict__ tws, uint32_t q) {
  const int groups = (1 << (log_n - kSplit)) >> RL;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int hi = g >> lo_b;
    const int base = (hi << (lo_b + RL)) | (g & ((1 << lo_b) - 1));
    uint32_t v[1 << RL];
#pragma unroll
    for (int r = 0; r < (1 << RL); ++r) v[r] = a[pad(base + (r << lo_b))];
    inverse_pass_stage<RL, 0, kSplit>(v, log_n, part, lo_b, hi, tw, tws, q);
    if constexpr (RL > 1) inverse_pass_stage<RL, 1, kSplit>(v, log_n, part, lo_b, hi, tw, tws, q);
    if constexpr (RL > 2) inverse_pass_stage<RL, 2, kSplit>(v, log_n, part, lo_b, hi, tw, tws, q);
    if constexpr (RL > 3) inverse_pass_stage<RL, 3, kSplit>(v, log_n, part, lo_b, hi, tw, tws, q);
    static_assert(RL <= 4, "passes of up to 4 stages");
#pragma unroll
    for (int r = 0; r < (1 << RL); ++r) a[pad(base + (r << lo_b))] = v[r];
  }
}

// inverse_pass<rl, kSplit> for a runtime rl in [1, RL].
template <int RL, int kSplit = 1>
__device__ __forceinline__ void inverse_pass_of(int rl, uint32_t* a, int log_n, int part,
                                                int lo_b, const uint32_t* __restrict__ tw,
                                                const uint32_t* __restrict__ tws, uint32_t q) {
  if constexpr (RL > 1) {
    if (rl < RL) {
      inverse_pass_of<RL - 1, kSplit>(rl, a, log_n, part, lo_b, tw, tws, q);
      return;
    }
  }
  inverse_pass<RL, kSplit>(a, log_n, part, lo_b, tw, tws, q);
}

// The stages of the inverse NTT inside half `part` (kSplit = 2: quarter
// part) on the padded half a (word j at pad(j)), register-blocked:
// passes of kMaxRL stages, the last one shorter. The caller synchronises
// before it; it returns synchronised.
template <int kMaxRL, int kSplit = 1>
__device__ __forceinline__ void ntt_inverse_passes(uint32_t* a, int log_n, int part,
                                                   const uint32_t* __restrict__ tw,
                                                   const uint32_t* __restrict__ tws, uint32_t q) {
  const int log_h = log_n - kSplit;
  for (int lo_b = 0; lo_b < log_h;) {
    const int rl = log_h - lo_b > kMaxRL ? kMaxRL : log_h - lo_b;
    inverse_pass_of<kMaxRL, kSplit>(rl, a, log_n, part, lo_b, tw, tws, q);
    __syncthreads();
    lo_b += rl;
  }
}

// Four consecutive words from a 16-byte boundary, in one access.
__device__ __forceinline__ void load4(uint32_t (&d)[4], const uint32_t* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
}

__device__ __forceinline__ void store4(uint32_t* p, const uint32_t (&d)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(d[0], d[1], d[2], d[3]);
}

// Whether the quads of a block's slot_own table (its slots in slot order,
// each packed with its radix-2 index in the half: s | x << 16) are four
// consecutive slots from a 16-byte boundary: exactly when the first one is
// (each half owns every other row of the slot order, and all its rows have
// one power-of-two length; rows of fewer than 4 words, below n = 2^9 in the
// 2-factor order, are not).
__device__ __forceinline__ bool vector_quads(const uint32_t* __restrict__ own) {
  const uint32_t s0 = __ldg(own) & 0xFFFFu, s3 = __ldg(own + 3) & 0xFFFFu;
  return s3 == s0 + 3 && (s0 & 3) == 0;
}

// The last stage of the inverse NTT for a limb split over a thread block
// cluster of two (block `part` of the pair holds half `part` padded, after
// ntt_inverse_passes), scaled by n^-1:
// out[j] = (u + v)*n^-1 from block 0 and out[n/2 + j] = (u - v)*w*n^-1 from
// block 1, with u = half 0's word j and v = half 1's, each block reading its
// partner's half through distributed shared memory. Every thread of both
// blocks calls it; it returns once both blocks are done reading, so neither
// exits while the other reads its a.
__device__ __forceinline__ void inverse_last_stage(uint32_t* a, uint32_t* __restrict__ out,
                                                   int log_n, int part,
                                                   const uint32_t* __restrict__ tw,
                                                   const uint32_t* __restrict__ tws,
                                                   const Limb& k) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int half = 1 << (log_n - 1);
  cluster.sync();  // both halves have run their stages
  const uint32_t* other = cluster.map_shared_rank(a, static_cast<unsigned>(part ^ 1));
  const uint32_t w = __ldg(tw + 1), ws = __ldg(tws + 1);
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    const uint32_t mine = a[pad(j)], theirs = other[pad(j)];
    const uint32_t r = part ? mulmod_shoup(sub_mod(theirs, mine, k.q), w, ws, k.q)
                            : add_mod(mine, theirs, k.q);
    out[part * half + j] = mulmod_shoup(r, k.n_inv, k.n_inv_s, k.q);
  }
  cluster.sync();
}

// The two stages of the inverse NTT that cross the quarters of a limb split
// over a thread block cluster of four (block `part` holds quarter `part` padded,
// after ntt_inverse_passes<., 2>), scaled by n^-1: with a_c word j of
// quarter c, b0 = a0 + a1, b1 = (a0 - a1)*w2, b2 = a2 + a3,
// b3 = (a2 - a3)*w3, then out[j] = b0 + b2, out[n/4 + j] = b1 + b3,
// out[n/2 + j] = (b0 - b2)*w1, out[3n/4 + j] = (b1 - b3)*w1, block part
// writing quarter part of out and reading the other three quarters through
// distributed shared memory. Every thread of the four blocks calls it; it
// returns once all are done reading.
__device__ __forceinline__ void inverse_last_stages4(uint32_t* a, uint32_t* __restrict__ out,
                                                     int log_n, int part,
                                                     const uint32_t* __restrict__ tw,
                                                     const uint32_t* __restrict__ tws,
                                                     const Limb& k) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int quarter = 1 << (log_n - 2);
  cluster.sync();  // every quarter has run its stages
  const uint32_t* q4[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) q4[c] = cluster.map_shared_rank(a, static_cast<unsigned>(c));
  const bool odd = part & 1, upper = part >> 1;
  const uint32_t w1 = __ldg(tw + 1), w1s = __ldg(tws + 1);
  const uint32_t w2 = __ldg(tw + 2), w2s = __ldg(tws + 2), w3 = __ldg(tw + 3), w3s = __ldg(tws + 3);
  for (int j = threadIdx.x; j < quarter; j += blockDim.x) {
    const int at = pad(j);
    const uint32_t a0 = q4[0][at], a1 = q4[1][at], a2 = q4[2][at], a3 = q4[3][at];
    // the pair of b this quarter's output takes: sums (even) or differences (odd)
    const uint32_t lo = odd ? mulmod_shoup(sub_mod(a0, a1, k.q), w2, w2s, k.q) : add_mod(a0, a1, k.q);
    const uint32_t hi = odd ? mulmod_shoup(sub_mod(a2, a3, k.q), w3, w3s, k.q) : add_mod(a2, a3, k.q);
    const uint32_t r = upper ? mulmod_shoup(sub_mod(lo, hi, k.q), w1, w1s, k.q) : add_mod(lo, hi, k.q);
    out[part * quarter + j] = mulmod_shoup(r, k.n_inv, k.n_inv_s, k.q);
  }
  cluster.sync();
}

// Launches a kernel that keeps part of one limb in shared memory, blocks of
// a limb consecutive along x, on `stream`, with `threads` a block and
// `smem_words` words opted in as dynamic shared memory. With cluster > 1,
// each run of `cluster` blocks along x is a thread block cluster, for the
// kernels whose last stages cross the parts. Returns a cudaError_t (0 on
// success): a refused launch or cluster shape is an error, never a fallback.
template <typename... Params, typename... Args>
int launch_blocks(void (*kernel)(Params...), dim3 grid, int threads, int smem_words, int cluster,
                  void* stream, Args... args) {
  const size_t smem = static_cast<size_t>(smem_words) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Block `part`'s slots in slot order, own[e] = s | x << 16 (e < words: n/2,
// or n/4 for a quarter; x the radix-2 index in its part: kernel_tables'
// slot_own, slot_own4), walked as B's hint loop walks them: thread t takes
// the four elements e = 4*(t + c*blockDim.x) + 0..3, with vec four
// consecutive slots from a 16-byte boundary of the row, one 16-byte access
// (each part owns whole rows of the slot order), else word accesses:
// word(s, x) for each slot, or quad(s, x[4]) for the slots s .. s + 3.
template <typename Word, typename Quad>
__device__ __forceinline__ void walk_slots(const uint32_t* __restrict__ own, int words, bool vec,
                                           Word word, Quad quad) {
  vec = vec && words >= 4;
  for (int e = 4 * threadIdx.x; e < words; e += 4 * blockDim.x) {
    if (vec) {
      const uint4 o = __ldg(reinterpret_cast<const uint4*>(own + e));
      const int x[4] = {static_cast<int>(o.x >> 16), static_cast<int>(o.y >> 16),
                        static_cast<int>(o.z >> 16), static_cast<int>(o.w >> 16)};
      quad(static_cast<int>(o.x & 0xFFFFu), x);
    } else {
      for (int u = 0; u < 4 && e + u < words; ++u) {
        const uint32_t o = __ldg(own + e + u);
        word(static_cast<int>(o & 0xFFFFu), static_cast<int>(o >> 16));
      }
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The slot tables of the kernels launched by launch_grid (A, 5, 6, 8, 9),
// [2n]: slot_own (halves), then slot_own4 (quarters); block part of a limb
// split over 2^kSplit blocks owns the n/2^kSplit entries from
// own_of<kSplit>(table, part, n).
template <int kSplit>
__device__ __forceinline__ const uint32_t* own_of(const uint32_t* table, int part, int n) {
  return table + (kSplit - 1) * n + part * (n >> kSplit);
}

// Launch shape of the kernels launched by launch_grid (A, 5, 6, 8, 9):
// threads a block and the blocks an SM it is built for (shared memory
// allowing: n/2 + n/64 words a block, 66 KB at n = 2^15, 132 KB at 2^16), so
// registers a thread; kMaxRL, the stages of a pass (R = 2^kMaxRL words a
// thread).
template <int kThreads_, int kBlocks_, int kMaxRL_>
struct GridShape {
  static constexpr int kThreads = kThreads_, kBlocks = kBlocks_, kMaxRL = kMaxRL_;
};

// Each the fastest without spills of the shapes measured on the H100
// (PERF.md): one 1024-thread block an SM (64 registers, passes of 4 stages)
// at n = 2^16, where a block's half takes 132 KB, and for grids of at most
// one such wave at n <= 2^15; two 512-thread blocks an SM (64 registers,
// passes of 4) for larger grids at n <= 2^15; with a limb over four blocks,
// 1024 threads with passes of 3 stages at n <= 2^15 (a quarter of 2^13
// words: one group of 8 a thread), else GridOne.
using GridOne = GridShape<1024, 1, 4>;
using GridTwo = GridShape<512, 2, 4>;
using GridFour = GridShape<1024, 1, 3>;

// The card's SMs, read once (a process is taken to use one model of card).
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      cudaGetLastError();
      return 0;  // then every grid takes halves in GridTwo
    }
    return count;
  }();
  return sms;
}

// The clusters of four blocks of `kernel` the card runs at once, at n =
// 2^log_n: a cluster needs four SMs of one GPC, so this is fewer than a
// quarter of the SMs (measured on the H100: [2, 16, n], 32 clusters, took
// two waves, PERF.md). Read once per kernel and ring size; 0 if the query
// fails.
template <typename... Params>
int quarter_clusters(void (*kernel)(Params...), int threads, int log_n) {
  static int count[17];
  static std::once_flag once[17];
  std::call_once(once[log_n], [&] {
    const size_t smem = padded_words(1 << (log_n - 2)) * sizeof(uint32_t);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 4;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(4);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&count[log_n], kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();
      count[log_n] = 0;
    }
  });
  return count[log_n];
}

// The launch of a kernel that keeps part of each of the T limbs of G rows in
// shared memory (A, 5, 6, 8, 9), built as `one` (GridOne, halves), `two`
// (GridTwo, halves), `four15` (GridFour, quarters) and `four16` (GridOne,
// quarters), on [G, T, n] (n >= 2^10 for quarters): a limb over four
// blocks where the grid still fits one wave, so that small grids ([1, L, n]:
// 2L blocks of halves) spread over more SMs: one block an SM for the
// forward kernels, and for the inverse ones (cluster: the last stages cross
// the parts through distributed shared memory) no more clusters of four
// than the card runs at once. Else over two, GridOne at n = 2^16 and for at
// most one wave, GridTwo beyond. args are the kernel's.
template <typename... Params, typename... Args>
int launch_grid(void (*one)(Params...), void (*two)(Params...), void (*four15)(Params...),
                void (*four16)(Params...), bool cluster, int G, int T, int log_n, void* stream,
                Args... args) {
  const int sms = sm_count();
  void (*four)(Params...) = log_n > 15 ? four16 : four15;
  const int four_threads = log_n > 15 ? GridOne::kThreads : GridFour::kThreads;
  const int split = log_n >= 10 && 4 * T * G <= sms &&
                            (!cluster || T * G <= quarter_clusters(four, four_threads, log_n))
                        ? 2
                        : 1;
  void (*kernel)(Params...) = two;
  int threads = GridTwo::kThreads;
  if (split == 2) {
    kernel = four;
    threads = four_threads;
  } else if (log_n > 15 || 2 * T * G <= sms) {
    kernel = one;
    threads = GridOne::kThreads;
  }
  return launch_blocks(kernel, dim3(T << split, G), threads, padded_words(1 << (log_n - split)),
                       cluster ? 1 << split : 0, stream, args...);
}

}  // namespace zq
