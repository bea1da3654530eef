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
//   intt_grid   x [G, S, n] NTT domain (any uint32), S >= T: the T rows of
//               each group of S that x points at -> [G, T, n] coefficients
//   ntt_grid    x [G, S, n] coefficients (any uint32), S >= T, the same
//               window -> [G, T, n] NTT domain
//   rescale_fwd ntt [G, T, n] NTT domain over keep + drop limbs (T = L + K,
//               K <= zq::kMaxDigits; the L keep rows read, any uint32),
//               dropped [G, K, n] canonical coefficients of the K drop
//               limbs, consts [L, 4 + 2K] (P mod q_j, companion, P^-1 mod
//               q_j, companion, [pi_k]_{q_j} x K, companions x K),
//               DropConsts by value
//               -> [G, L, n] NTT domain over the L keep limbs; or, given
//               c0, c1 [G/2, L, n] (NTT domain), -> [G/2, 2, L, n] with row
//               g < G/2 plus c0 at [g, 0] and row G/2 + g plus c1 at [g, 1]
//
// The joint rescale by P inverts only the K dropped rows (intt_grid on the
// window of the last K rows of each group of T) and hands kernel 7 the
// keep rows as they are, in the NTT domain: 7 transforms only the
// correction, and multiplies each keep slot by P^-1 as it stores.
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
// Kernel 7's prologue (the Garner digits of the K dropped limbs' residues,
// V > P//2 and the centered t = (-V)*P^-1 mod zp, the base extension of the
// digits, the sign corrections, the correction's division by P: K(K+1)/2 +
// K + 2 Shoup products and K words read a coefficient) is the load of its
// first pass and never goes to device memory; its store reads the keep
// row's slot, multiplies it by P^-1 and adds it, and c0 or c1 where the
// hybrid product wants them. The two blocks of a limb are a cluster and
// each evaluates the prologue only on its own half (zq::ntt_forward_pair),
// so each block reads its inputs once: evaluated on the whole row by each
// block, as the first pass's load, it took 31-34% longer and spilled.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

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
// by n^-1, to natural order. Row (g, t) is read at g*stride + t and written
// at g*T + t: stride > T inverts a window of T rows of each group.
template <class S, int kSplit>
__global__ void __launch_bounds__(S::kThreads, S::kBlocks)
intt_grid_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ limbs, const uint32_t* __restrict__ inv_tw,
                 const uint32_t* __restrict__ slot_own, int T, int stride, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, words = n >> kSplit;
  const int t = blockIdx.x >> kSplit, part = blockIdx.x & ((1 << kSplit) - 1);
  const size_t row = (static_cast<size_t>(blockIdx.y) * T + t) * n;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * t);
  const uint32_t* own = own_of<kSplit>(slot_own, part, n);
  const uint32_t* xr = x + (static_cast<size_t>(blockIdx.y) * stride + t) * n;
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
// one 16-byte store. Rows are read and written as in kernels 5 and 9.
template <class S, int kSplit>
__global__ void __launch_bounds__(S::kThreads, S::kBlocks)
ntt_grid_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                const uint32_t* __restrict__ limbs, const uint32_t* __restrict__ fwd_tw,
                const uint32_t* __restrict__ slot_own, int T, int stride, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, words = n >> kSplit;
  const int t = blockIdx.x >> kSplit, part = blockIdx.x & ((1 << kSplit) - 1);
  const size_t row = (static_cast<size_t>(blockIdx.y) * T + t) * n;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * t);
  const uint32_t* tw = fwd_tw + 2 * static_cast<size_t>(t) * n;
  const uint32_t* xr = x + (static_cast<size_t>(blockIdx.y) * stride + t) * n;
  zq::ntt_forward_passes<S::kMaxRL, S::kMaxRL, zq::kFromLoad, kSplit>(buf, xr, log_n, part, tw,
                                                                      tw + n, k);
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

// The constants of kernel 7 that every block shares, passed by value and
// read from the parameter space (constant cache): the Garner rows of the K
// dropped limbs (zq::garner), the mixed-radix digits of P//2, [pi_k]_zp for
// the K digits, zp (a power of two <= 2^16), P mod zp and P^-1 mod zp. The
// host packs the same words (rescale.py drop_consts).
struct DropConsts {
  uint32_t rows[zq::kMaxDigits][zq::kGarnerWords];
  uint32_t half[zq::kMaxDigits];
  uint32_t pi_zp[zq::kMaxDigits];
  uint32_t zp, p_zp, p_inv_zp;
};

// Kernel 7. Two blocks per (keep limb j, row g). The NTT is linear mod q_j,
// so NTT((c_j - delta)*P^-1) = NTT(c_j)*P^-1 + NTT((q_j - delta)*P^-1)
// residue for residue: the kept rows stay in the NTT domain, and only the
// correction is transformed. Per coefficient i, as alchemy_tpu/she/hybrid.py
// _rescale_joint_jnp:173-210 computes delta: the Garner digits x_k of the K
// dropped residues (the dropped part V = sum_k x_k*pi_k); V > P//2 (V
// negative: its digits against those of P//2, ascending k, so the highest
// digit that differs decides); V mod zp and the centered t = (-V)*P^-1 mod
// zp (t - zp above zp/2); v = sum_k x_k*[pi_k]_{q_j} (V mod q_j, k
// ascending), minus P if V is negative; delta = v + t*P; (q_j - delta)*P^-1.
// mask = zp - 1 keeps the mod-zp terms below 2^16, so their products fit 32
// bits. That prologue is the load of the register-blocked forward passes:
// the two blocks of a limb are a cluster, each evaluates it on its own half,
// and the first pass reads the partner's half through distributed shared
// memory; block `part` then writes its slots in slot order, four
// consecutive slots a thread in one 16-byte access, adding the kept row's
// slot times P^-1 (one Shoup product, exact for any uint32) and c0 (rows g <
// G/2) or c1 (the rest) when given.
// Built for each K <= 4 (kK = K: the prologue's loops unroll to exactly K
// digits) and for up to zq::kMaxDigits guarded by the runtime K, whose
// absent digits' products are issued all the same: built that way for
// K = 4 it took 0.465 ms at [32, 16, K = 4] on the H100, against 0.306
// (PERF.md).
template <class S, int kK>
__global__ void __launch_bounds__(S::kThreads, S::kBlocks)
rescale_fwd_kernel(const uint32_t* __restrict__ ntt, const uint32_t* __restrict__ dropped,
                   const uint32_t* __restrict__ c0, const uint32_t* __restrict__ c1,
                   const uint32_t* __restrict__ consts, const __grid_constant__ DropConsts dc,
                   uint32_t* __restrict__ out, const uint32_t* __restrict__ limbs,
                   const uint32_t* __restrict__ fwd_tw, const uint32_t* __restrict__ slot_own,
                   int L, int K, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, half = n >> 1;
  const int j = blockIdx.x >> 1, part = blockIdx.x & 1;
  const size_t g = blockIdx.y;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * j);
  const uint32_t q = k.q;
  const uint32_t* c = consts + static_cast<size_t>(j) * (4 + 2 * K);
  const uint32_t p_mod = c[0], p_mod_s = c[1], p_inv = c[2], p_inv_s = c[3];
  const uint32_t* dr = dropped + g * K * n;
  const uint32_t mask = dc.zp - 1;
  const int count = kK < zq::kMaxDigits ? kK : K;
  auto correction = [&](int i) {
    uint32_t r[kK] = {}, x[kK];
#pragma unroll
    for (int d = 0; d < kK; ++d) {
      if (d < count) r[d] = dr[static_cast<size_t>(d) * n + i];
    }
    zq::garner(x, r, count, [&](int d, int w) { return dc.rows[d][w]; });
    bool neg = false;
    uint32_t vz = 0, v = 0;
#pragma unroll
    for (int d = 0; d < kK; ++d) {
      if (d < count) {
        neg = x[d] != dc.half[d] ? x[d] > dc.half[d] : neg;
        vz = (vz + (x[d] & mask) * dc.pi_zp[d]) & mask;
        v = zq::add_mod(v, zq::mulmod_shoup(x[d], c[4 + d], c[4 + K + d], q), q);
      }
    }
    if (neg) {
      v = zq::sub_mod(v, p_mod, q);
      vz = (vz + dc.zp - dc.p_zp) & mask;
    }
    const uint32_t t = ((dc.zp - vz) & mask) * dc.p_inv_zp & mask;
    const uint32_t tc = t > (dc.zp >> 1) ? q - (dc.zp - t) : t;
    const uint32_t delta = zq::add_mod(v, zq::mulmod_shoup(tc, p_mod, p_mod_s, q), q);
    return zq::mulmod_shoup(zq::sub_mod(0, delta, q), p_inv, p_inv_s, q);
  };
  const uint32_t* tw = fwd_tw + 2 * static_cast<size_t>(j) * n;
  zq::ntt_forward_pair<S::kMaxRL, S::kMaxRL>(buf, correction, log_n, part, tw, tw + n, k);
  const uint32_t* own = slot_own + part * half;
  const uint32_t* kept = ntt + (g * (L + K) + j) * n;
  uint32_t* o = out + (g * L + j) * n;
  const uint32_t* add = nullptr;
  if (c0 != nullptr) {
    const size_t bt = gridDim.y >> 1, b = g % bt, w = g / bt;
    o = out + ((b * 2 + w) * L + j) * n;
    add = (w ? c1 : c0) + (b * L + j) * n;
  }
  walk_slots(
      own, half,
      zq::vector_quads(own) && aligned16(o) && aligned16(kept) &&
          (add == nullptr || aligned16(add)),
      [&](int s, int i) {
        uint32_t v = zq::add_mod(buf[zq::pad(i)], zq::mulmod_shoup(kept[s], p_inv, p_inv_s, q), q);
        o[s] = add != nullptr ? zq::add_mod(v, add[s], q) : v;
      },
      [&](int s, const int (&i)[4]) {
        uint32_t v[4];
        zq::load4(v, kept + s);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = zq::add_mod(buf[zq::pad(i[u])], zq::mulmod_shoup(v[u], p_inv, p_inv_s, q), q);
        }
        if (add != nullptr) {
          uint32_t a[4];
          zq::load4(a, add + s);
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = zq::add_mod(v[u], a[u], q);
        }
        zq::store4(o + s, v);
      });
}

// Kernel 7 built for K dropped limbs in launch shape S.
template <class S>
auto rescale_kernel(int K) {
  switch (K) {
    case 1: return rescale_fwd_kernel<S, 1>;
    case 2: return rescale_fwd_kernel<S, 2>;
    case 3: return rescale_fwd_kernel<S, 3>;
    case 4: return rescale_fwd_kernel<S, 4>;
    default: return rescale_fwd_kernel<S, zq::kMaxDigits>;
  }
}

}  // namespace

extern "C" {

// Kernel 5, and kernel 9 with the 2-factor slot table. Returns a
// cudaError_t (0 on success).
int intt_grid(const void* x, void* out, const void* limbs, const void* inv_tw,
              const void* slot_own, int G, int T, int stride, int log_n, void* stream) {
  return zq::launch_grid(intt_grid_kernel<GridOne, 1>, intt_grid_kernel<GridTwo, 1>,
                         intt_grid_kernel<GridFour, 2>, intt_grid_kernel<GridOne, 2>, true, G, T,
                         log_n, stream, static_cast<const uint32_t*>(x),
                         static_cast<uint32_t*>(out), static_cast<const uint32_t*>(limbs),
                         static_cast<const uint32_t*>(inv_tw),
                         static_cast<const uint32_t*>(slot_own), T, stride, log_n);
}

// Kernel 6, and kernel 8 with the 2-factor slot table. Returns a
// cudaError_t (0 on success).
int ntt_grid(const void* x, void* out, const void* limbs, const void* fwd_tw,
             const void* slot_own, int G, int T, int stride, int log_n, void* stream) {
  return zq::launch_grid(ntt_grid_kernel<GridOne, 1>, ntt_grid_kernel<GridTwo, 1>,
                         ntt_grid_kernel<GridFour, 2>, ntt_grid_kernel<GridOne, 2>, false, G, T,
                         log_n, stream, static_cast<const uint32_t*>(x),
                         static_cast<uint32_t*>(out), static_cast<const uint32_t*>(limbs),
                         static_cast<const uint32_t*>(fwd_tw),
                         static_cast<const uint32_t*>(slot_own), T, stride, log_n);
}

// Kernel 7; drop points to the words of a DropConsts in host memory, c0
// and c1 are both null (-> [G, L, n]) or both given (-> [G/2, 2, L, n]).
// Returns a cudaError_t (0 on success).
int rescale_fwd(const void* ntt, const void* dropped, const void* c0, const void* c1,
                const void* consts, const void* drop, void* out, const void* limbs,
                const void* fwd_tw, const void* slot_own, int G, int L, int K, int log_n,
                void* stream) {
  if (K < 1 || K > zq::kMaxDigits || (c0 != nullptr && G % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DropConsts dc;
  std::memcpy(&dc, drop, sizeof dc);
  const bool small = log_n <= 15;
  return zq::launch_blocks(
      small ? rescale_kernel<RescaleSmall>(K) : rescale_kernel<RescaleLarge>(K), dim3(2 * L, G),
      small ? RescaleSmall::kThreads : RescaleLarge::kThreads,
      zq::padded_words(1 << (log_n - 1)), 2, stream, static_cast<const uint32_t*>(ntt),
      static_cast<const uint32_t*>(dropped), static_cast<const uint32_t*>(c0),
      static_cast<const uint32_t*>(c1), static_cast<const uint32_t*>(consts), dc,
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(limbs),
      static_cast<const uint32_t*>(fwd_tw), static_cast<const uint32_t*>(slot_own), L, K, log_n);
}

}  // extern "C"
