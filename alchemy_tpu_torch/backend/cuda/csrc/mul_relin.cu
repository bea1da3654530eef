// Kernels A, B and 4 of BGV ciphertext multiply + relinearize, and the
// Garner digits between A and 4, for sm_90a, with a plain C interface loaded
// through ctypes.
//
// Kernel A, tensor_intt, replaces alchemy_tpu/backend/pallas/
// mul_relin_pallas.py:232 _tensor_intt_kernel. Kernel B, digit_relin (CRT
// gadget), replaces mul_relin_pallas.py:439 _digit_relin_ctmajor_kernel and
// :319 _digit_relin_kernel (raw or Shoup hints; the limb-major variant the
// TPU runs at n = 2^16). Kernel 4, hybrid_digit_relin (hybrid
// key-switching), replaces :807 _hybrid_digit_relin_kernel. garner_pack
// replaces no TPU kernel: the JAX package computes c2's Garner digits in XLA
// (alchemy_tpu/she/hybrid.py:446-451).
//
// Layouts (uint32 residues, canonical, at the boundaries in the slot order
// of the tables the host passes: the 3-factor order of backend/ntt3.py or
// the 2-factor order of backend/ntt2.py):
//   ct_a, ct_b  [Bt, 2, L, n]   NTT domain
//   c0, c1      [Bt, L, n]      NTT domain
//   c2c         [Bt, L, n]      coefficients of c2 (natural order)
//   hints (B)   [L, L, n]       hint_b and hint_a, indexed [digit i, limb l];
//                               raw values or (values, companions) pairs
//   out (B)     [Bt, 2, L, n]   NTT domain
//   hints (B over tenants) [T, L, L, n] Shoup values and companions of T
//               tenants' hints; tenant [Bt] int32, each row's tenant
//   x (4)       [Bt, L, n]      Garner digits of c2c per limb group,
//                               group-major (natural order): garner_pack's
//                               output
//   consts (gp) [L, kGarnerWords] each limb's Garner row within its group
//   ext (4)     [T, 2, L]       [pi_k]_{q_t} and Shoup companions
//   hints (4)   [dnum, T, n]    over the extended chain of T = L + K limbs
//   out (4)     [2, Bt, T, n]   NTT domain, before the rescale by P
//
// The TPU's matmul-shaped 3-factor NTT is replaced by a register-blocked
// radix-2 NTT (zq.cuh) with native 64-bit products and Shoup twiddles in
// shared memory. Inside a kernel the NTT works in bit-reversed evaluation
// order; host tables map each radix-2 index to its slot (any permutation:
// the kernels are the same for both slot orders). Every kernel splits each
// limb over two blocks (a limb of 2^16 words, 256 KB, exceeds the 227 KB of
// shared memory a block can have), kernel A on small grids over four and B
// in its quarter form (with_b_shape); block `part` holds its part and owns the slots whose radix-2 index lies there.
// Only the first stage of a forward NTT (the first two for quarters) crosses
// the parts, and the last of an inverse one: A finishes its inverse NTT with
// it across a thread block cluster (distributed shared memory); B and 4
// start their forward NTTs with it.
//
// Kernel A reads 4 and writes 3 words a coefficient and is bound by those
// bytes. It walks each block's slots in slot order (slot_own), 16 bytes of
// every row at a time (by radix-2 index, a warp's reads in the 2-factor
// order would touch a sector a word), and runs the inverse NTT of c2 as
// kernel 5 does: the passes of zq::ntt_inverse_passes and the cluster's last
// stage, a limb over four blocks where the grid fits one wave of the card
// (zq::launch_grid).
//
// Kernels B and 4, per (limb, ciphertext), run a loop of digit forward NTTs,
// each followed by two hint products added into running sums. What bounds
// them on the H100, and what their design does:
// - The NTT chain. As a radix-2 chain of log2(n) barrier-separated stages
//   in shared memory it holds B to 5-9% of its multiply bound, so they run
//   the register-blocked passes of zq::ntt_forward_passes: each thread
//   holds 8 or 16 words in registers and runs 3 or 4 stages on them between
//   barriers, reading each stage's twiddles 16 bytes at a time, so a digit
//   takes 4-5 barriers, not 14-15. The blocks are built for 56 or 64
//   registers a thread (Shape), not 32. B's transforms, still 74% of it at
//   n = 2^15 and waiting on latency more than on issue, run lazy
//   butterflies for limbs below 2^30 (zq::pass_stage: words in [0, 4q),
//   fewer reductions; 0.375 -> 0.340 ms at [16, 8, 2^15]).
// - The hint loop. It reads each hint row once per ciphertext, and the
//   running sums at every digit; walked by radix-2 index, a warp's accesses
//   would touch 16-32 sectors. Each block walks its own slots in slot order
//   instead (kernel_tables' slot_own, slot_own4): a thread takes four
//   consecutive slots, 16 bytes of every row at a time, and the values come
//   from the shared part by a gather. B keeps its sums in shared memory
//   until the last digit at n <= 2^15. With one key's hints warm in L2 the
//   loop takes 28% of B, with the tenant form's cold hint rows 39%.
// - Overlapping the two. A block of B that transforms, then multiplies,
//   leaves its SM to one of them at a time. B's quarter form runs a limb
//   over four blocks of 512 threads, two an SM, so that one block's hint
//   loop waits while the other transforms. Its first pass reads the digit
//   row four times and computes five products a word, and the two blocks
//   mostly run in step, so with one key's hints warm in L2 it loses to the
//   halves on a full card. It wins for the tenant form's cold hint rows,
//   and where a limb's four blocks fit one wave, which a single product's
//   halves would leave mostly idle. B takes its form by its grid
//   (with_b_shape); PERF.md has the times.
// - Kernel 4's base extension (alpha Shoup products a coefficient and group)
//   is the load of its first pass. At n <= 2^15 the two blocks of a limb are
//   a cluster and each extends only its own half (zq::ntt_forward_pair); at
//   2^16, where a pair costs more than the doubled extension, each block
//   extends the whole row. It never goes to device memory.
// PERF.md has the time of each part on the H100 and the launch shapes
// measured against each other.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "zq.cuh"

namespace {

using zq::aligned16;
using zq::GridFour;
using zq::GridOne;
using zq::GridTwo;
using zq::kLimbWords;
using zq::load4;
using zq::own_of;
using zq::store4;
using zq::vector_quads;
using zq::walk_slots;

// Kernel A. A cluster of 2^kSplit blocks per (limb l, ciphertext b), each
// with a half (kSplit = 1) or a quarter of the limb: block `part` walks its
// slots in slot order (slot_own, four consecutive slots a thread, 16 bytes
// of each of a0, a1, b0, b1, c0 and c1 at a time), computes the Karatsuba
// tensor product c0 = a0*b0, c2 = a1*b1, c1 = (a0+a1)(b0+b1) - c0 - c2 of
// each slot, writes c0 and c1 and places c2 at its radix-2 index in the
// padded part (kernel 5's gather with the product in it); then the
// register-blocked inverse passes inside the part, and the stages that
// cross the parts across the cluster, scaled by n^-1 -> c2c in natural order.
template <class S, int kSplit>
__global__ void __launch_bounds__(S::kThreads, S::kBlocks)
tensor_intt_kernel(const uint32_t* __restrict__ ct_a, const uint32_t* __restrict__ ct_b,
                   uint32_t* __restrict__ c0, uint32_t* __restrict__ c1,
                   uint32_t* __restrict__ c2c, const uint32_t* __restrict__ limbs,
                   const uint32_t* __restrict__ inv_tw, const uint32_t* __restrict__ slot_own,
                   int L, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, words = n >> kSplit;
  const int l = blockIdx.x >> kSplit, part = blockIdx.x & ((1 << kSplit) - 1);
  const size_t b = blockIdx.y;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * l);
  const size_t limb_off = static_cast<size_t>(l) * n;
  const uint32_t* a0 = ct_a + b * 2 * L * n + limb_off;
  const uint32_t* a1 = a0 + static_cast<size_t>(L) * n;
  const uint32_t* b0 = ct_b + b * 2 * L * n + limb_off;
  const uint32_t* b1 = b0 + static_cast<size_t>(L) * n;
  const size_t out_off = b * L * n + limb_off;
  uint32_t* o0 = c0 + out_off;
  uint32_t* o1 = c1 + out_off;
  // c0 and c1 of one slot into p0, p1; returns its c2
  auto tensor = [&](uint32_t x0, uint32_t x1, uint32_t y0, uint32_t y1, uint32_t& p0,
                    uint32_t& p1) {
    p0 = zq::mulmod(x0, y0, k);
    const uint32_t p2 = zq::mulmod(x1, y1, k);
    const uint32_t cross = zq::mulmod(zq::add_mod(x0, x1, k.q), zq::add_mod(y0, y1, k.q), k);
    p1 = zq::sub_mod(cross, zq::add_mod(p0, p2, k.q), k.q);
    return p2;
  };
  const uint32_t* own = own_of<kSplit>(slot_own, part, n);
  walk_slots(
      own, words,
      vector_quads(own) && aligned16(ct_a) && aligned16(ct_b) && aligned16(c0) && aligned16(c1),
      [&](int s, int x) {
        uint32_t p0, p1;
        buf[zq::pad(x)] = tensor(a0[s], a1[s], b0[s], b1[s], p0, p1);
        o0[s] = p0;
        o1[s] = p1;
      },
      [&](int s, const int (&x)[4]) {
        uint32_t va0[4], va1[4], vb0[4], vb1[4], p0[4], p1[4];
        load4(va0, a0 + s);
        load4(va1, a1 + s);
        load4(vb0, b0 + s);
        load4(vb1, b1 + s);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          buf[zq::pad(x[u])] = tensor(va0[u], va1[u], vb0[u], vb1[u], p0[u], p1[u]);
        }
        store4(o0 + s, p0);
        store4(o1 + s, p1);
      });
  __syncthreads();
  const uint32_t* tw = inv_tw + 2 * limb_off;
  zq::ntt_inverse_passes<S::kMaxRL, kSplit>(buf, log_n, part, tw, tw + n, k.q);
  if constexpr (kSplit == 2) {
    zq::inverse_last_stages4(buf, c2c + out_off, log_n, part, tw, tw + n, k);
  } else {
    zq::inverse_last_stage(buf, c2c + out_off, log_n, part, tw, tw + n, k);
  }
}

// Launch shape of kernels B and 4: threads a block and the blocks an SM it
// is built for (shared memory allowing: a part of n/2^kSplit words padded,
// 66 KB for a half at n = 2^15, 132 KB at 2^16, 33 KB for a quarter at
// 2^15, and two parts' words more with kSums), so registers a thread;
// kMaxRL, the stages of a pass (R = 2^kMaxRL words a thread). kSums: the
// running sums stay in shared memory behind the part until the last digit.
// kPair (kernel 4): the two blocks of a limb are a cluster and each computes
// the base extension of its own half only (zq::ntt_forward_pair). kSplit: a
// limb over 2^kSplit blocks, halves (1) or quarters (2, kernel B), whose
// first pass fuses the stages that cross the parts into its load.
// kLazy (kernel B): the transforms' lazy butterflies (zq::pass_stage) for
// limbs below 2^30.
template <int kThreads_, int kBlocks_, int kMaxRL_, bool kSums_ = false, bool kPair_ = false,
          int kSplit_ = 1, bool kLazy_ = false>
struct Shape {
  static constexpr int kThreads = kThreads_, kBlocks = kBlocks_, kMaxRL = kMaxRL_;
  static constexpr bool kSums = kSums_, kPair = kPair_, kLazy = kLazy_;
  static constexpr int kSplit = kSplit_;
  static_assert(!kPair || kSplit == 1, "the pair form splits a limb in two");
  // stages of kernel 4's first pass, whose load is the base extension: 2 in
  // the pair form (its values wait for a cluster barrier), else 3
  static constexpr int kExtFirstRL = kPair ? 2 : 3;
};

// Each the fastest without spills of the shapes measured on the H100
// (PERF.md; B at n <= 2^15 by CUDA events at [16, 8, 2^15] and
// [1, 8, 2^15]). B at n <= 2^15, chosen by with_b_shape: halves, 1024 x 1,
// for one key's grids of more than a wave of quarters (0.340 ms at
// [16, 8]; quarters 0.362 there: their load reads the digit row four times
// and takes five products a word); quarters 512 x 2 for one key's smaller
// grids (0.122 against 0.160 ms at [1, 8]) and for the tenant form, whose
// hint rows come cold from device memory when a launch gathers several
// tenants, and one block's waits overlap the other's transforms (0.392
// against 0.411 ms in halves at [16, 8] over 64 tenants; with one tenant a
// launch, as for one key, the halves would win). 64 registers each;
// passes of 4 stages spilled. Kernel 4: 384 x 3 (56 registers), whose 640
// blocks at n = 2^15, L = 16 fill 396 slots in 1.6 waves, and 1024 x 1 at
// 2^16.
using BSmall = Shape<1024, 1, 3, true, false, 1, true>;    // B, halves, n <= 2^15
using BQuarter = Shape<512, 2, 3, true, false, 2, true>;   // B, quarters, 2^10 <= n <= 2^15
using BLarge = Shape<1024, 1, 3>;                          // B, n = 2^16
using ExtSmall = Shape<384, 3, 3, false, true>;            // 4, n <= 2^15
using ExtLarge = Shape<1024, 1, 4>;                        // 4, n = 2^16

// Word offset of the sums in shared memory (after the padded part of
// `words`, on a 16-byte boundary), and the words of shared memory a block
// asks for.
__host__ __device__ constexpr int sums_offset(int words) {
  return (zq::padded_words(words) + 3) & ~3;
}

template <class S>
int shared_words(int log_n) {
  const int words = 1 << (log_n - S::kSplit);
  return S::kSums ? sums_offset(words) + 2 * words : zq::padded_words(words);
}

// p += c[0..4) mod q.
__device__ __forceinline__ void add4(uint32_t (&p)[4], const uint32_t* c, uint32_t q) {
  uint32_t d[4];
  load4(d, c);
#pragma unroll
  for (int u = 0; u < 4; ++u) p[u] = zq::add_mod(d[u], p[u], q);
}

// p = v * hint words h[at .. at + 4) (with companions hs[...] when kShoup)
// mod q.
template <bool kShoup>
__device__ __forceinline__ void products4(uint32_t (&p)[4], const uint32_t (&v)[4],
                                          const uint32_t* __restrict__ h,
                                          const uint32_t* __restrict__ hs, size_t at,
                                          const zq::Limb& k) {
  uint32_t w[4], ws[4];
  load4(w, h + at);
  if constexpr (kShoup) load4(ws, hs + at);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    p[u] = kShoup ? zq::mulmod_shoup(v[u], w[u], ws[u], k.q) : zq::mulmod(v[u], w[u], k);
  }
}

// The hint products of one digit (B) or digit group (4) and their running
// sums, for the slots the calling thread owns. Block `part`'s slots, in
// slot order, are own[e] = s | x << 16 (e < words, the n/2 of a half or
// n/4 of a quarter; x = slot_ct[s] - part*words, the radix-2 index in its
// part: kernel_tables' slot_own, slot_own4). Thread t takes the four
// elements e = 4*(t + c*blockDim.x) + 0..3, the same at every digit, so
// the sums read back only what the thread wrote.
// Each part owns whole rows of the slot order (rows of n2 or B*r words: 128
// or more from n = 2^14), so with kVec four elements are four consecutive
// slots on a 16-byte boundary, and a warp reads hints and writes sums 512
// bytes at a time; rows of fewer than 4 words (below n = 2^9 in the
// 2-factor order) take word accesses (vector_quads). The NTT's values come
// from the padded shared part (a gather: zq::pad keeps it free of bank
// conflicts). The sums so far come from src0/src1 (device memory; null:
// none) or, with from_sums, from sums (shared memory, [2][words] by element
// e); they go to out0/out1, or to sums when out0 is null. kShoup: hints are
// (values, companions) pairs, multiplied with mulmod_shoup; otherwise raw values
// (hbs, has unused), multiplied with the Barrett mulmod. Device rows start
// on 16-byte boundaries (the wrappers check it).
template <bool kShoup, bool kVec>
__device__ __forceinline__ void accumulate(const uint32_t* buf, const uint32_t* __restrict__ own,
                                           int words, size_t h, const uint32_t* __restrict__ hb,
                                           const uint32_t* __restrict__ hbs,
                                           const uint32_t* __restrict__ ha,
                                           const uint32_t* __restrict__ has, const uint32_t* src0,
                                           const uint32_t* src1, uint32_t* sums, bool from_sums,
                                           uint32_t* out0, uint32_t* out1, const zq::Limb& k) {
  for (int e = 4 * threadIdx.x; e < words; e += 4 * blockDim.x) {
    if constexpr (kVec) {
      const uint4 o = __ldg(reinterpret_cast<const uint4*>(own + e));
      const uint32_t oo[4] = {o.x, o.y, o.z, o.w};
      const int s = static_cast<int>(o.x & 0xFFFFu);  // the quad's slots are s .. s + 3
      uint32_t v[4], p0[4], p1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = buf[zq::pad(static_cast<int>(oo[u] >> 16))];
      products4<kShoup>(p0, v, hb, hbs, h + s, k);
      products4<kShoup>(p1, v, ha, has, h + s, k);
      // shared and device memory on separate paths: no generic accesses
      if (from_sums) {
        add4(p0, sums + e, k.q);
        add4(p1, sums + words + e, k.q);
      } else if (src0 != nullptr) {
        add4(p0, src0 + s, k.q);
        add4(p1, src1 + s, k.q);
      }
      if (out0 != nullptr) {
        store4(out0 + s, p0);
        store4(out1 + s, p1);
      } else {
        store4(sums + e, p0);
        store4(sums + words + e, p1);
      }
    } else {
      for (int u = 0; u < 4; ++u) {
        const uint32_t o = __ldg(own + e + u);
        const int s = static_cast<int>(o & 0xFFFFu);
        const uint32_t v = buf[zq::pad(static_cast<int>(o >> 16))];
        const size_t at = h + s;
        uint32_t p0 = kShoup ? zq::mulmod_shoup(v, hb[at], hbs[at], k.q) : zq::mulmod(v, hb[at], k);
        uint32_t p1 = kShoup ? zq::mulmod_shoup(v, ha[at], has[at], k.q) : zq::mulmod(v, ha[at], k);
        if (from_sums) {
          p0 = zq::add_mod(sums[e + u], p0, k.q);
          p1 = zq::add_mod(sums[words + e + u], p1, k.q);
        } else if (src0 != nullptr) {
          p0 = zq::add_mod(src0[s], p0, k.q);
          p1 = zq::add_mod(src1[s], p1, k.q);
        }
        if (out0 != nullptr) {
          out0[s] = p0;
          out1[s] = p1;
        } else {
          sums[e + u] = p0;
          sums[words + e + u] = p1;
        }
      }
    }
  }
}

// Kernel B's block. 2^kSplit blocks per (output limb l, ciphertext b), block
// `part` with a half or a quarter of the limb; the gadget digits i loop
// inside: digit i = c2c[b, i] (a residue mod q_i) is reduced mod q_l,
// transformed (the register-blocked passes of the part, the stages that
// cross the parts fused into the first pass's load; lazily, words in
// [0, 4q_l), with S::kLazy and q_l < 2^30), and its products with hint row
// (i, l) at the part's slots are added to the sums, which start from c0/c1
// at digit 0. The sums live in the output buffer, or with kSums in shared
// memory behind the part until the last digit. slot_own is the [2n] table
// of launch_grid's kernels (slot_own, then slot_own4).
template <bool kShoup, class S>
__device__ __forceinline__ void digit_relin_block(
    const uint32_t* __restrict__ c2c, const uint32_t* c0, const uint32_t* c1,
    const uint32_t* __restrict__ hb, const uint32_t* __restrict__ hbs,
    const uint32_t* __restrict__ ha, const uint32_t* __restrict__ has, uint32_t* out,
    const uint32_t* __restrict__ limbs, const uint32_t* __restrict__ fwd_tw,
    const uint32_t* __restrict__ slot_own, int L, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, words = n >> S::kSplit;
  const int l = blockIdx.x >> S::kSplit, part = blockIdx.x & ((1 << S::kSplit) - 1);
  const size_t b = blockIdx.y;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * l);
  const size_t limb_off = static_cast<size_t>(l) * n;
  const uint32_t* digits = c2c + b * L * n;
  const uint32_t* in0 = c0 + b * L * n + limb_off;
  const uint32_t* in1 = c1 + b * L * n + limb_off;
  uint32_t* out0 = out + b * 2 * L * n + limb_off;
  uint32_t* out1 = out0 + static_cast<size_t>(L) * n;
  const uint32_t* tw = fwd_tw + 2 * limb_off;
  const uint32_t* own = own_of<S::kSplit>(slot_own, part, n);
  uint32_t* sums = S::kSums ? buf + sums_offset(words) : nullptr;
  const bool vec = vector_quads(own);
  auto digits_loop = [&](auto lazy) {
    for (int i = 0; i < L; ++i) {
      zq::ntt_forward_passes<S::kMaxRL, S::kMaxRL, zq::kFromLoad, S::kSplit,
                             decltype(lazy)::value>(buf, digits + static_cast<size_t>(i) * n,
                                                    log_n, part, tw, tw + n, k);
      const bool last = !S::kSums || i == L - 1;
      const size_t h = (static_cast<size_t>(i) * L + l) * n;
      const uint32_t* src0 = i == 0 ? in0 : out0;
      const uint32_t* src1 = i == 0 ? in1 : out1;
      uint32_t* dst0 = last ? out0 : nullptr;
      uint32_t* dst1 = last ? out1 : nullptr;
      if (vec) {
        accumulate<kShoup, true>(buf, own, words, h, hb, hbs, ha, has, src0, src1, sums,
                                 S::kSums && i > 0, dst0, dst1, k);
      } else {
        accumulate<kShoup, false>(buf, own, words, h, hb, hbs, ha, has, src0, src1, sums,
                                  S::kSums && i > 0, dst0, dst1, k);
      }
      __syncthreads();  // buf is rewritten by the next digit
    }
  };
  if (S::kLazy && k.q < (1u << 30)) {
    digits_loop(std::integral_constant<bool, S::kLazy>());
  } else {
    digits_loop(std::false_type());
  }
}

// Kernel B: one key's hints [L, L, n] for every ciphertext.
template <bool kShoup, class S>
__global__ void __launch_bounds__(S::kThreads, S::kBlocks)
digit_relin_kernel(const uint32_t* __restrict__ c2c, const uint32_t* c0,
                   const uint32_t* c1, const uint32_t* __restrict__ hb,
                   const uint32_t* __restrict__ hbs, const uint32_t* __restrict__ ha,
                   const uint32_t* __restrict__ has, uint32_t* out,
                   const uint32_t* __restrict__ limbs, const uint32_t* __restrict__ fwd_tw,
                   const uint32_t* __restrict__ slot_own, int L, int log_n) {
  digit_relin_block<kShoup, S>(c2c, c0, c1, hb, hbs, ha, has, out, limbs, fwd_tw, slot_own, L,
                               log_n);
}

// Kernel B over many keys: the Shoup hint tables [T, L, L, n] of T tenants,
// and ciphertext b relinearized under tenant[b]'s hints; a tenant outside
// [0, T) traps, which the host sees as a CUDA error at its next synchronize.
// The rows of one tenant read the same hint rows, shared through L2 as in
// digit_relin_kernel; each further tenant of a launch adds its L x L hint
// rows to the bytes read.
template <class S>
__global__ void __launch_bounds__(S::kThreads, S::kBlocks)
digit_relin_tenants_kernel(const uint32_t* __restrict__ c2c, const uint32_t* c0,
                           const uint32_t* c1, const uint32_t* __restrict__ hb,
                           const uint32_t* __restrict__ hbs, const uint32_t* __restrict__ ha,
                           const uint32_t* __restrict__ has, uint32_t* out,
                           const uint32_t* __restrict__ limbs,
                           const uint32_t* __restrict__ fwd_tw,
                           const uint32_t* __restrict__ slot_own,
                           const int32_t* __restrict__ tenant, int T, int L, int log_n) {
  const int32_t t = __ldg(tenant + blockIdx.y);
  if (static_cast<uint32_t>(t) >= static_cast<uint32_t>(T)) __trap();
  const size_t at = static_cast<size_t>(t) * L * L << log_n;
  digit_relin_block<true, S>(c2c, c0, c1, hb + at, hbs + at, ha + at, has + at, out, limbs,
                             fwd_tw, slot_own, L, log_n);
}

// Kernel B's launch shape for bt ciphertexts of L limbs at n = 2^log_n, of
// its tenant form with tenants: f(S()) for S = BLarge at 2^16; BSmall below
// 2^10, where zq::launch_grid does not split a limb in quarters either;
// BQuarter for the tenant form, taken to gather several tenants' hint rows
// a launch, and for one key where a limb over four blocks fits one wave of
// the card (4*L*bt <= SMs: a single product's 2L halves would leave most
// SMs idle); else BSmall.
template <typename F>
int with_b_shape(bool tenants, int bt, int L, int log_n, F f) {
  if (log_n > 15) return f(BLarge());
  if (log_n >= 10 && (tenants || 4 * L * bt <= zq::sm_count())) return f(BQuarter());
  return f(BSmall());
}

// digit_relin_form of one of kernel B's instantiations, launched in shape S.
template <class S, typename Kernel>
int b_form(Kernel kernel, int log_n, int* parts, int* blocks) {
  *parts = 1 << S::kSplit;
  const size_t smem = static_cast<size_t>(shared_words<S>(log_n)) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, S::kThreads, smem);
  }
  return static_cast<int>(e);
}

// Kernel 4. Two blocks per (extended limb t, ciphertext b); the dnum digit
// groups j loop inside. Group j covers Garner digit rows [j*alpha,
// min((j+1)*alpha, L)) of x[b]; its digit residue mod q_t at coefficient i
// is sum_k x[b, k, i] * [pi_k]_{q_t} (Shoup constants ext[t]), computed in
// the load of the first pass, then transformed as in kernel B, and the slots
// block `part` owns are multiplied by hint row (j, t). The sums start from
// zero (c0 and c1 join after the rescale by P) and live as in kernel B.
template <bool kShoup, class S>
__global__ void __launch_bounds__(S::kThreads, S::kBlocks)
hybrid_digit_relin_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ ext,
                          const uint32_t* __restrict__ hb, const uint32_t* __restrict__ hbs,
                          const uint32_t* __restrict__ ha, const uint32_t* __restrict__ has,
                          uint32_t* out, const uint32_t* __restrict__ limbs,
                          const uint32_t* __restrict__ fwd_tw,
                          const uint32_t* __restrict__ slot_own, int L, int T, int dnum, int alpha,
                          int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, half = n >> 1;
  const int t = blockIdx.x >> 1, part = blockIdx.x & 1;
  const size_t b = blockIdx.y;
  const size_t bt = gridDim.y;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * t);
  const uint32_t* xb = x + b * L * n;
  const uint32_t* w = ext + 2 * static_cast<size_t>(t) * L;  // [pi_k]_{q_t}, then companions
  uint32_t* out0 = out + (b * T + t) * n;
  uint32_t* out1 = out + ((bt + b) * T + t) * n;
  const uint32_t* tw = fwd_tw + 2 * static_cast<size_t>(t) * n;
  const uint32_t* own = slot_own + part * half;
  uint32_t* sums = S::kSums ? buf + sums_offset(half) : nullptr;
  const bool vec = vector_quads(own);

  for (int j = 0; j < dnum; ++j) {
    const int k0 = j * alpha;
    const int k1 = k0 + alpha < L ? k0 + alpha : L;
    const uint32_t q = k.q;
    auto digit = [=](int i) {
      uint32_t acc = 0;
      for (int r = k0; r < k1; ++r) {
        acc = zq::add_mod(acc, zq::mulmod_shoup(__ldg(xb + static_cast<size_t>(r) * n + i),
                                                __ldg(w + r), __ldg(w + L + r), q), q);
      }
      return acc;
    };
    if constexpr (S::kPair) {
      zq::ntt_forward_pair<S::kMaxRL, S::kExtFirstRL>(buf, digit, log_n, part, tw, tw + n, k);
    } else {
      zq::ntt_forward_passes<S::kMaxRL, S::kExtFirstRL>(buf, digit, log_n, part, tw, tw + n, k);
    }
    const bool last = !S::kSums || j == dnum - 1;
    const size_t h = (static_cast<size_t>(j) * T + t) * n;
    const uint32_t* src0 = j == 0 ? nullptr : out0;
    const uint32_t* src1 = j == 0 ? nullptr : out1;
    uint32_t* dst0 = last ? out0 : nullptr;
    uint32_t* dst1 = last ? out1 : nullptr;
    if (vec) {
      accumulate<kShoup, true>(buf, own, half, h, hb, hbs, ha, has, src0, src1, sums,
                               S::kSums && j > 0, dst0, dst1, k);
    } else {
      accumulate<kShoup, false>(buf, own, half, h, hb, hbs, ha, has, src0, src1, sums,
                                S::kSums && j > 0, dst0, dst1, k);
    }
    __syncthreads();  // buf is rewritten by the next group
  }
}

// garner_pack: the Garner digits of c2c within each digit group of alpha
// limbs (the last may be shorter), kernel 4's input x. A thread takes one
// coefficient of one (ciphertext, group): its count residues in, its digits
// computed in registers (zq::garner, the group's rows of consts), written
// out. It reads and writes each word once, so bytes bound it (32 MiB each
// way at Bt = 16, L = 16, n = 2^15); a warp's accesses are 128 consecutive
// bytes of a row. Folded into kernel 4's load it would be recomputed by
// each of 4's 2T blocks of a ciphertext.
constexpr int kGarnerThreads = 256;

__global__ void __launch_bounds__(kGarnerThreads)
garner_pack_kernel(const uint32_t* __restrict__ c2c, uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ consts, int L, int alpha, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k0 = blockIdx.y * alpha;
  const int count = alpha < L - k0 ? alpha : L - k0;
  const size_t at = (static_cast<size_t>(blockIdx.z) * L + k0) * n + i;
  uint32_t r[zq::kMaxDigits] = {}, d[zq::kMaxDigits];
#pragma unroll
  for (int k = 0; k < zq::kMaxDigits; ++k) {
    if (k < count) r[k] = __ldg(c2c + at + static_cast<size_t>(k) * n);
  }
  const uint32_t* rows = consts + static_cast<size_t>(k0) * zq::kGarnerWords;
  zq::garner(d, r, count, [&](int k, int w) { return __ldg(rows + k * zq::kGarnerWords + w); });
#pragma unroll
  for (int k = 0; k < zq::kMaxDigits; ++k) {
    if (k < count) x[at + static_cast<size_t>(k) * n] = d[k];
  }
}

}  // namespace

extern "C" {

const char* zq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel A; slot_own is the [2n] table of launch_grid's kernels (slot_own,
// then slot_own4). Returns a cudaError_t (0 on success).
int tensor_intt(const void* ct_a, const void* ct_b, void* c0, void* c1, void* c2c,
                const void* limbs, const void* inv_tw, const void* slot_own, int bt, int L,
                int log_n, void* stream) {
  return zq::launch_grid(tensor_intt_kernel<GridOne, 1>, tensor_intt_kernel<GridTwo, 1>,
                         tensor_intt_kernel<GridFour, 2>, tensor_intt_kernel<GridOne, 2>, true,
                         bt, L, log_n, stream, static_cast<const uint32_t*>(ct_a),
                         static_cast<const uint32_t*>(ct_b), static_cast<uint32_t*>(c0),
                         static_cast<uint32_t*>(c1), static_cast<uint32_t*>(c2c),
                         static_cast<const uint32_t*>(limbs),
                         static_cast<const uint32_t*>(inv_tw),
                         static_cast<const uint32_t*>(slot_own), L, log_n);
}

// Kernel B; hbs and has are ignored unless shoup != 0; slot_own is the [2n]
// table of launch_grid's kernels. Returns a cudaError_t.
int digit_relin(const void* c2c, const void* c0, const void* c1, const void* hb,
                const void* hbs, const void* ha, const void* has, void* out,
                const void* limbs, const void* fwd_tw, const void* slot_own, int shoup, int bt,
                int L, int log_n, void* stream) {
  return with_b_shape(false, bt, L, log_n, [&](auto s) {
    using S = decltype(s);
    return zq::launch_blocks(
        shoup ? digit_relin_kernel<true, S> : digit_relin_kernel<false, S>,
        dim3(L << S::kSplit, bt), S::kThreads, shared_words<S>(log_n), 0, stream,
        static_cast<const uint32_t*>(c2c), static_cast<const uint32_t*>(c0),
        static_cast<const uint32_t*>(c1), static_cast<const uint32_t*>(hb),
        static_cast<const uint32_t*>(hbs), static_cast<const uint32_t*>(ha),
        static_cast<const uint32_t*>(has), static_cast<uint32_t*>(out),
        static_cast<const uint32_t*>(limbs), static_cast<const uint32_t*>(fwd_tw),
        static_cast<const uint32_t*>(slot_own), L, log_n);
  });
}

// Kernel B over T tenants' Shoup hint tables [T, L, L, n], ciphertext b
// under tenant[b]'s ([bt] int32, each in [0, T): the kernel traps on any
// other); slot_own as for digit_relin. Returns a cudaError_t.
int digit_relin_tenants(const void* c2c, const void* c0, const void* c1, const void* hb,
                        const void* hbs, const void* ha, const void* has, void* out,
                        const void* limbs, const void* fwd_tw, const void* slot_own,
                        const void* tenant, int T, int bt, int L, int log_n, void* stream) {
  return with_b_shape(true, bt, L, log_n, [&](auto s) {
    using S = decltype(s);
    return zq::launch_blocks(
        digit_relin_tenants_kernel<S>, dim3(L << S::kSplit, bt), S::kThreads,
        shared_words<S>(log_n), 0, stream, static_cast<const uint32_t*>(c2c),
        static_cast<const uint32_t*>(c0), static_cast<const uint32_t*>(c1),
        static_cast<const uint32_t*>(hb), static_cast<const uint32_t*>(hbs),
        static_cast<const uint32_t*>(ha), static_cast<const uint32_t*>(has),
        static_cast<uint32_t*>(out), static_cast<const uint32_t*>(limbs),
        static_cast<const uint32_t*>(fwd_tw), static_cast<const uint32_t*>(slot_own),
        static_cast<const int32_t*>(tenant), T, L, log_n);
  });
}

// The form kernel B takes for bt ciphertexts of L limbs at n = 2^log_n (the
// tenant-indexed kernel with tenants != 0, else the Shoup one): the blocks
// it splits a limb over (*parts) and the blocks of it an SM holds at once
// (*blocks). Returns a cudaError_t.
int digit_relin_form(int log_n, int tenants, int bt, int L, int* parts, int* blocks) {
  if (tenants) {
    return with_b_shape(true, bt, L, log_n, [&](auto s) {
      using S = decltype(s);
      return b_form<S>(digit_relin_tenants_kernel<S>, log_n, parts, blocks);
    });
  }
  return with_b_shape(false, bt, L, log_n, [&](auto s) {
    using S = decltype(s);
    return b_form<S>(digit_relin_kernel<true, S>, log_n, parts, blocks);
  });
}

// Kernel 4; hbs and has are ignored unless shoup != 0. Returns a cudaError_t.
int hybrid_digit_relin(const void* x, const void* ext, const void* hb, const void* hbs,
                       const void* ha, const void* has, void* out, const void* limbs,
                       const void* fwd_tw, const void* slot_own, int shoup, int bt, int L, int T,
                       int dnum, int alpha, int log_n, void* stream) {
  const bool small = log_n <= 15;
  const auto kernel = small ? (shoup ? hybrid_digit_relin_kernel<true, ExtSmall>
                                     : hybrid_digit_relin_kernel<false, ExtSmall>)
                            : (shoup ? hybrid_digit_relin_kernel<true, ExtLarge>
                                     : hybrid_digit_relin_kernel<false, ExtLarge>);
  return zq::launch_blocks(
      kernel, dim3(2 * T, bt), small ? ExtSmall::kThreads : ExtLarge::kThreads,
      small ? shared_words<ExtSmall>(log_n) : shared_words<ExtLarge>(log_n),
      (small ? ExtSmall::kPair : ExtLarge::kPair) ? 2 : 0, stream,
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(ext),
      static_cast<const uint32_t*>(hb), static_cast<const uint32_t*>(hbs),
      static_cast<const uint32_t*>(ha), static_cast<const uint32_t*>(has),
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(limbs),
      static_cast<const uint32_t*>(fwd_tw), static_cast<const uint32_t*>(slot_own), L, T, dnum,
      alpha, log_n);
}

// garner_pack on c2c [bt, L, n] -> x [bt, L, n], groups of alpha <=
// zq::kMaxDigits limbs. Returns a cudaError_t (0 on success).
int garner_pack(const void* c2c, void* x, const void* consts, int bt, int L, int alpha,
                int log_n, void* stream) {
  if (alpha < 1 || alpha > zq::kMaxDigits) return static_cast<int>(cudaErrorInvalidValue);
  const int n = 1 << log_n;
  const int threads = n < kGarnerThreads ? n : kGarnerThreads;
  return zq::launch_blocks(garner_pack_kernel, dim3(n / threads, (L + alpha - 1) / alpha, bt),
                           threads, 0, 0, stream, static_cast<const uint32_t*>(c2c),
                           static_cast<uint32_t*>(x), static_cast<const uint32_t*>(consts), L,
                           alpha, n);
}

}  // extern "C"
