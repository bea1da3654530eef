// Kernels 5-9: the standalone per-limb NTTs and the forward half of the
// joint rescale by P of hybrid key-switching, for sm_90a, with a plain C
// interface loaded through ctypes.
//
// Kernel 5, intt_grid, replaces alchemy_tpu/backend/pallas/rescale_pallas.py:52
// _intt_grid_kernel ("kernel C"); kernel 6, ntt_grid, replaces :142
// _ntt_grid_kernel; kernel 7, rescale_fwd, replaces :206 _rescale_fwd_kernel
// ("kernel D"). Kernels 8 and 9 replace alchemy_tpu/backend/pallas/
// ntt_pallas.py:211 _fwd_kernel and :232 _inv_kernel, the 4-step NTT of the
// 2-factor slot order: they are ntt_grid and intt_grid launched with that
// order's slot tables (the host's ntt2_grid and intt2_grid). The TPU
// kernels compute the 4-step form as bf16 digit-plane matmuls on its matrix
// unit; the values, and the slots they land in, are the same.
//
// Layouts (uint32 residues, at the boundaries in the slot order of the
// tables the host passes: 3-factor, backend/ntt3.py, or 2-factor,
// backend/ntt2.py; slot_own and slot_own4 for 5/6/8/9, slot_own for 7):
//   intt_grid   x [G, T, n] NTT domain (any uint32) -> [G, T, n] coefficients
//   ntt_grid    x [G, T, n] coefficients (any uint32) -> [G, T, n] NTT domain
//   rescale_fwd coeff [G, T, n] coefficients over keep + drop limbs (rows
//               j < L read), xs [G, K, n] Garner digits of the K dropped
//               rows, is_neg/t/t_neg [G, n] the sign terms of the rescale,
//               consts [L, 4 + 2K] (P mod q_j, companion, P^-1 mod q_j,
//               companion, [pi_k]_{q_j} x K, companions x K)
//               -> [G, L, n] NTT domain over the L keep limbs
//
// What bounds them on the H100: every kernel here splits each limb over two
// blocks (5/6/8/9 on small grids over four), each with its part in shared
// memory (64 KB a half at n = 2^15; 128 KB at 2^16), so a call has 2*G*T
// blocks; the forward kernels fuse the stages that cross the parts into the
// load, the inverse ones finish them across a cluster through distributed
// shared memory. Each block reads and writes its words once.
//
// All of them run the register-blocked passes of zq.cuh (B's forward
// ntt_forward_passes, and its Gentleman-Sande mirror ntt_inverse_passes): 3
// or 4 stages in registers between barriers, twiddles 16 bytes at a time;
// and they write (6/7/8) or gather (5/9) each block's slots in slot order
// through slot_own, four consecutive slots a thread in one 16-byte access.
// As a radix-2 chain (one stage a barrier, twiddles read 4 bytes at a time,
// slot-order stores and gathers by radix-2 index: a warp's words 8 or more
// words apart in the 2-factor order) they ran at 6-15% of their bound.
// Large grids ([2*Bt, L, n]) are then bound by the passes' issue and
// shared-memory traffic; small ones ([1, L, n]: 2L blocks on the H100's 132
// SMs) by one block's latency, so where a grid fits one wave 5/6/8/9 take a
// limb over four blocks (a quarter each, the two cross-quarter stages in the
// forward load and across a cluster of four in the inverse). The launch
// shape is chosen per ring size and grid size (zq.cuh GridShape,
// launch_grid; RescaleSmall and RescaleLarge for 7); PERF.md has the measurements.
//
// Kernel 7's prologue (the base extension of the K dropped limbs' Garner
// digits, the sign corrections, the division by P: K + 3 Shoup products and
// K + 4 words read a coefficient) is the load of its first pass and never
// goes to device memory. The two blocks of a limb are a cluster and each
// evaluates it only on its own half (zq::ntt_forward_pair), so each block
// reads its inputs once: evaluated on the whole row by each block, as the
// first pass's load, it took 31-34% longer and spilled.
#include <cuda_runtime.h>

#include <cstdint>

#include "zq.cuh"

namespace {

using zq::aligned16;
using zq::GridFour;
using zq::GridOne;
using zq::GridTwo;
using zq::kLimbWords;
using zq::own_of;
using zq::walk_slots;

// Kernels 5 and 9. A cluster of 2^kSplit blocks per (limb t, row g), each
// with a half (kSplit = 1) or a quarter of the limb: block `part` gathers
// its slots from the row in slot order (16 bytes a thread where the row
// starts on a 16-byte boundary), reduces each and places it at its radix-2
// index in the padded part; then the register-blocked inverse passes inside
// the part, and the stages that cross the parts across the cluster, scaled
// by n^-1, to natural order.
template <class S, int kSplit>
__global__ void __launch_bounds__(S::kThreads, S::kBlocks)
intt_grid_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ limbs, const uint32_t* __restrict__ inv_tw,
                 const uint32_t* __restrict__ slot_own, int T, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, words = n >> kSplit;
  const int t = blockIdx.x >> kSplit, part = blockIdx.x & ((1 << kSplit) - 1);
  const size_t row = (static_cast<size_t>(blockIdx.y) * T + t) * n;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * t);
  const uint32_t* own = own_of<kSplit>(slot_own, part, n);
  const uint32_t* xr = x + row;
  walk_slots(
      own, words, zq::vector_quads(own) && aligned16(x),
      [&](int s, int j) { buf[zq::pad(j)] = zq::reduce(xr[s], k); },
      [&](int s, const int (&j)[4]) {
        uint32_t v[4];
        zq::load4(v, xr + s);
#pragma unroll
        for (int u = 0; u < 4; ++u) buf[zq::pad(j[u])] = zq::reduce(v[u], k);
      });
  __syncthreads();
  const uint32_t* tw = inv_tw + 2 * static_cast<size_t>(t) * n;
  zq::ntt_inverse_passes<S::kMaxRL, kSplit>(buf, log_n, part, tw, tw + n, k.q);
  if constexpr (kSplit == 2) {
    zq::inverse_last_stages4(buf, out + row, log_n, part, tw, tw + n, k);
  } else {
    zq::inverse_last_stage(buf, out + row, log_n, part, tw, tw + n, k);
  }
}

// Kernels 6 and 8. 2^kSplit blocks per (limb t, row g), each with a half
// (kSplit = 1) or a quarter of the limb: block `part` runs the
// register-blocked forward passes of its part, the first fusing the stages
// that cross the parts into its load from the row (reducing any uint32),
// then writes its slots in slot order, four consecutive slots a thread in
// one 16-byte store.
template <class S, int kSplit>
__global__ void __launch_bounds__(S::kThreads, S::kBlocks)
ntt_grid_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                const uint32_t* __restrict__ limbs, const uint32_t* __restrict__ fwd_tw,
                const uint32_t* __restrict__ slot_own, int T, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, words = n >> kSplit;
  const int t = blockIdx.x >> kSplit, part = blockIdx.x & ((1 << kSplit) - 1);
  const size_t row = (static_cast<size_t>(blockIdx.y) * T + t) * n;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * t);
  const uint32_t* tw = fwd_tw + 2 * static_cast<size_t>(t) * n;
  zq::ntt_forward_passes<S::kMaxRL, S::kMaxRL, zq::kFromLoad, kSplit>(buf, x + row, log_n, part,
                                                                      tw, tw + n, k);
  const uint32_t* own = own_of<kSplit>(slot_own, part, n);
  uint32_t* o = out + row;
  walk_slots(
      own, words, zq::vector_quads(own) && aligned16(out),
      [&](int s, int j) { o[s] = buf[zq::pad(j)]; },
      [&](int s, const int (&j)[4]) {
        const uint32_t v[4] = {buf[zq::pad(j[0])], buf[zq::pad(j[1])], buf[zq::pad(j[2])],
                               buf[zq::pad(j[3])]};
        zq::store4(o + s, v);
      });
}

// Launch shapes of kernel 7 (zq::GridShape): the pair with passes of 3
// stages, two 512-thread blocks an SM at n <= 2^15 (62 registers) and one
// 1024-thread block at 2^16. The fastest of the shapes measured on the H100
// (PERF.md), and the only ones without a spill: passes of 4 stages spilled
// 12-112 bytes at 64 registers.
using RescaleSmall = zq::GridShape<512, 2, 3>;   // n <= 2^15
using RescaleLarge = zq::GridShape<1024, 1, 3>;  // n = 2^16

// Kernel 7. Two blocks per (keep limb j, row g). Per coefficient i, as
// she/hybrid.py _rescale_joint_jnp:189-209 computes it: v =
// sum_k xs[k]*[pi_k]_{q_j} (the dropped part V mod q_j, k ascending), minus
// P if V is negative (is_neg); the centered correction t (t_neg: t - zp);
// delta = v + t*P; (coeff - delta)*P^-1. That prologue is the load of the
// register-blocked forward passes: the two blocks of a limb are a cluster,
// each evaluates it on its own half, and the first pass reads the partner's
// half through distributed shared memory; block `part` then writes its
// slots in slot order, four consecutive slots a thread in one 16-byte
// store.
template <class S>
__global__ void __launch_bounds__(S::kThreads, S::kBlocks)
rescale_fwd_kernel(const uint32_t* __restrict__ coeff, const uint32_t* __restrict__ xs,
                   const uint32_t* __restrict__ is_neg, const uint32_t* __restrict__ tz,
                   const uint32_t* __restrict__ t_neg, const uint32_t* __restrict__ consts,
                   uint32_t* __restrict__ out, const uint32_t* __restrict__ limbs,
                   const uint32_t* __restrict__ fwd_tw, const uint32_t* __restrict__ slot_own,
                   int L, int K, uint32_t zp, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, half = n >> 1;
  const int j = blockIdx.x >> 1, part = blockIdx.x & 1;
  const size_t g = blockIdx.y;
  const int T = L + K;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * j);
  const uint32_t q = k.q;
  const uint32_t* c = consts + static_cast<size_t>(j) * (4 + 2 * K);
  const uint32_t p_mod = c[0], p_mod_s = c[1], p_inv = c[2], p_inv_s = c[3];
  const uint32_t* cj = coeff + (g * T + j) * n;
  const uint32_t* xg = xs + g * K * n;
  const uint32_t* neg = is_neg + g * n;
  const uint32_t* tg = tz + g * n;
  const uint32_t* tn = t_neg + g * n;
  auto rescaled = [=](int i) {
    uint32_t v = 0;
    for (int r = 0; r < K; ++r) {
      v = zq::add_mod(v, zq::mulmod_shoup(xg[static_cast<size_t>(r) * n + i], c[4 + r],
                                          c[4 + K + r], q), q);
    }
    if (neg[i]) v = zq::sub_mod(v, p_mod, q);
    const uint32_t tc = tn[i] ? q - (zp - tg[i]) : tg[i];
    const uint32_t delta = zq::add_mod(v, zq::mulmod_shoup(tc, p_mod, p_mod_s, q), q);
    return zq::mulmod_shoup(zq::sub_mod(cj[i], delta, q), p_inv, p_inv_s, q);
  };
  const uint32_t* tw = fwd_tw + 2 * static_cast<size_t>(j) * n;
  zq::ntt_forward_pair<S::kMaxRL, S::kMaxRL>(buf, rescaled, log_n, part, tw, tw + n, k);
  const uint32_t* own = slot_own + part * half;
  uint32_t* o = out + (g * L + j) * n;
  walk_slots(
      own, half, zq::vector_quads(own) && aligned16(out),
      [&](int s, int x) { o[s] = buf[zq::pad(x)]; },
      [&](int s, const int (&x)[4]) {
        const uint32_t v[4] = {buf[zq::pad(x[0])], buf[zq::pad(x[1])], buf[zq::pad(x[2])],
                               buf[zq::pad(x[3])]};
        zq::store4(o + s, v);
      });
}

}  // namespace

extern "C" {

// Kernel 5, and kernel 9 with the 2-factor slot table. Returns a
// cudaError_t (0 on success).
int intt_grid(const void* x, void* out, const void* limbs, const void* inv_tw,
              const void* slot_own, int G, int T, int log_n, void* stream) {
  return zq::launch_grid(intt_grid_kernel<GridOne, 1>, intt_grid_kernel<GridTwo, 1>,
                         intt_grid_kernel<GridFour, 2>, intt_grid_kernel<GridOne, 2>, true, G, T,
                         log_n, stream, static_cast<const uint32_t*>(x),
                         static_cast<uint32_t*>(out), static_cast<const uint32_t*>(limbs),
                         static_cast<const uint32_t*>(inv_tw),
                         static_cast<const uint32_t*>(slot_own), T, log_n);
}

// Kernel 6, and kernel 8 with the 2-factor slot table. Returns a
// cudaError_t (0 on success).
int ntt_grid(const void* x, void* out, const void* limbs, const void* fwd_tw,
             const void* slot_own, int G, int T, int log_n, void* stream) {
  return zq::launch_grid(ntt_grid_kernel<GridOne, 1>, ntt_grid_kernel<GridTwo, 1>,
                         ntt_grid_kernel<GridFour, 2>, ntt_grid_kernel<GridOne, 2>, false, G, T,
                         log_n, stream, static_cast<const uint32_t*>(x),
                         static_cast<uint32_t*>(out), static_cast<const uint32_t*>(limbs),
                         static_cast<const uint32_t*>(fwd_tw),
                         static_cast<const uint32_t*>(slot_own), T, log_n);
}

// Kernel 7. Returns a cudaError_t (0 on success).
int rescale_fwd(const void* coeff, const void* xs, const void* is_neg, const void* t,
                const void* t_neg, const void* consts, void* out, const void* limbs,
                const void* fwd_tw, const void* slot_own, int G, int L, int K, int zp, int log_n,
                void* stream) {
  const bool small = log_n <= 15;
  return zq::launch_blocks(
      small ? rescale_fwd_kernel<RescaleSmall> : rescale_fwd_kernel<RescaleLarge>, dim3(2 * L, G),
      small ? RescaleSmall::kThreads : RescaleLarge::kThreads,
      zq::padded_words(1 << (log_n - 1)), 2, stream,
      static_cast<const uint32_t*>(coeff), static_cast<const uint32_t*>(xs),
      static_cast<const uint32_t*>(is_neg), static_cast<const uint32_t*>(t),
      static_cast<const uint32_t*>(t_neg), static_cast<const uint32_t*>(consts),
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(limbs),
      static_cast<const uint32_t*>(fwd_tw), static_cast<const uint32_t*>(slot_own), L, K,
      static_cast<uint32_t>(zp), log_n);
}

}  // extern "C"
