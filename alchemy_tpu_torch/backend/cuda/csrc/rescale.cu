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
// order's slot_inv table (the host's ntt2_grid and intt2_grid). The TPU
// kernels compute the 4-step form as bf16 digit-plane matmuls on its matrix
// unit; the values, and the slots they land in, are the same.
//
// Layouts (uint32 residues, at the boundaries in the slot order of the
// slot_inv table the host passes: 3-factor, backend/ntt3.py, or 2-factor,
// backend/ntt2.py):
//   intt_grid   x [G, T, n] NTT domain (any uint32) -> [G, T, n] coefficients
//   ntt_grid    x [G, T, n] coefficients (any uint32) -> [G, T, n] NTT domain
//   rescale_fwd coeff [G, T, n] coefficients over keep + drop limbs (rows
//               j < L read), xs [G, K, n] Garner digits of the K dropped
//               rows, is_neg/t/t_neg [G, n] the sign terms of the rescale,
//               consts [L, 4 + 2K] (P mod q_j, companion, P^-1 mod q_j,
//               companion, [pi_k]_{q_j} x K, companions x K)
//               -> [G, L, n] NTT domain over the L keep limbs
//
// What bounds them on the H100: as kernels A and B (mul_relin.cu), every
// kernel here splits each limb over two blocks, each with half of it in
// shared memory (64 KB at n = 2^15, two blocks per SM; 128 KB at 2^16), so
// a call has 2*G*T blocks; the forward kernels fuse their first stage into
// the load (kernel 7 its whole prologue, computed by both blocks for the
// whole row), the inverse one finishes its last stage across a cluster of
// two through distributed shared memory. Each block reads and writes its
// words once (kernel 7 reads its inputs twice, the second time from L2);
// the TPU kernels batch rows into wide matmuls, here the rows are separate
// blocks.
#include <cuda_runtime.h>

#include <cstdint>

#include "zq.cuh"

namespace {

using zq::kLimbWords;

// A cluster of two blocks per (limb t, row g): block `part` gathers the
// slots whose radix-2 index lies in its half (reduced), runs the inverse
// stages inside it, and the pair finishes the last stage, scaled by n^-1.
// Registers as in mul_relin.cu's tensor_intt_kernel.
__global__ void __launch_bounds__(1024, 2)
intt_grid_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ limbs, const uint32_t* __restrict__ inv_tw,
                 const int32_t* __restrict__ slot_inv, int T, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, half = n >> 1;
  const int t = blockIdx.x >> 1, part = blockIdx.x & 1;
  const size_t row = (static_cast<size_t>(blockIdx.y) * T + t) * n;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * t);
  const int32_t* own = slot_inv + part * half;
  for (int j = threadIdx.x; j < half; j += blockDim.x) buf[j] = zq::reduce(x[row + own[j]], k);
  __syncthreads();
  const uint32_t* tw = inv_tw + 2 * static_cast<size_t>(t) * n;
  zq::ntt_inverse(buf, log_n, tw, tw + n, k.q, 1, part);
  zq::inverse_last_stage(buf, out + row, log_n, part, tw, tw + n, k);
}

// Two blocks per (limb t, row g): block `part` runs the first stage in its
// load (reducing any uint32), the forward stages inside its half, and writes
// the slots whose radix-2 index lies there.
__global__ void __launch_bounds__(1024, 2)
ntt_grid_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                const uint32_t* __restrict__ limbs, const uint32_t* __restrict__ fwd_tw,
                const int32_t* __restrict__ slot_inv, int T, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, half = n >> 1;
  const int t = blockIdx.x >> 1, part = blockIdx.x & 1;
  const size_t row = (static_cast<size_t>(blockIdx.y) * T + t) * n;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * t);
  const uint32_t* tw = fwd_tw + 2 * static_cast<size_t>(t) * n;
  zq::forward_first_stage(buf, x + row, log_n, part, tw, tw + n, k);
  __syncthreads();
  zq::ntt_forward(buf, log_n, tw, tw + n, k.q, 1, part);
  const int32_t* own = slot_inv + part * half;
  for (int j = threadIdx.x; j < half; j += blockDim.x) out[row + own[j]] = buf[j];
}

// Two blocks per (keep limb j, row g). Per coefficient i, as
// she/hybrid.py _rescale_joint_jnp:189-209 computes it: v =
// sum_k xs[k]*[pi_k]_{q_j} (the dropped part V mod q_j), minus P if V is
// negative (is_neg); the centered correction t (t_neg: t - zp); delta =
// v + t*P; (coeff - delta)*P^-1. That prologue is the load of the first
// forward stage; block `part` then runs the stages inside its half and
// writes the slots whose radix-2 index lies there. Registers as in
// intt_grid_kernel.
__global__ void __launch_bounds__(1024, 2)
rescale_fwd_kernel(const uint32_t* __restrict__ coeff, const uint32_t* __restrict__ xs,
                   const uint32_t* __restrict__ is_neg, const uint32_t* __restrict__ tz,
                   const uint32_t* __restrict__ t_neg, const uint32_t* __restrict__ consts,
                   uint32_t* __restrict__ out, const uint32_t* __restrict__ limbs,
                   const uint32_t* __restrict__ fwd_tw, const int32_t* __restrict__ slot_inv,
                   int L, int K, uint32_t zp, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, half = n >> 1;
  const int j = blockIdx.x >> 1, part = blockIdx.x & 1;
  const size_t g = blockIdx.y;
  const int T = L + K;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * j);
  const uint32_t* c = consts + static_cast<size_t>(j) * (4 + 2 * K);
  const uint32_t p_mod = c[0], p_mod_s = c[1], p_inv = c[2], p_inv_s = c[3];
  const uint32_t* cj = coeff + (g * T + j) * n;
  const uint32_t* xg = xs + g * K * n;
  const size_t fg = g * n;
  auto rescaled = [&](int i) {
    uint32_t v = 0;
    for (int r = 0; r < K; ++r) {
      v = zq::add_mod(v, zq::mulmod_shoup(xg[static_cast<size_t>(r) * n + i], c[4 + r],
                                          c[4 + K + r], k.q), k.q);
    }
    if (is_neg[fg + i]) v = zq::sub_mod(v, p_mod, k.q);
    const uint32_t tv = tz[fg + i];
    const uint32_t tc = t_neg[fg + i] ? k.q - (zp - tv) : tv;
    const uint32_t delta = zq::add_mod(v, zq::mulmod_shoup(tc, p_mod, p_mod_s, k.q), k.q);
    return zq::mulmod_shoup(zq::sub_mod(cj[i], delta, k.q), p_inv, p_inv_s, k.q);
  };
  const uint32_t* tw = fwd_tw + 2 * static_cast<size_t>(j) * n;
  zq::forward_first_stage(buf, rescaled, log_n, part, tw, tw + n, k);
  __syncthreads();
  zq::ntt_forward(buf, log_n, tw, tw + n, k.q, 1, part);
  uint32_t* o = out + (g * L + j) * n;
  const int32_t* own = slot_inv + part * half;
  for (int e = threadIdx.x; e < half; e += blockDim.x) o[own[e]] = buf[e];
}

}  // namespace

extern "C" {

// Kernel 5, and kernel 9 with the 2-factor slot table. Returns a
// cudaError_t (0 on success).
int intt_grid(const void* x, void* out, const void* limbs, const void* inv_tw,
              const void* slot_inv, int G, int T, int log_n, void* stream) {
  return zq::launch_split(intt_grid_kernel, dim3(2 * T, G), true, log_n, stream,
                          static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
                          static_cast<const uint32_t*>(limbs), static_cast<const uint32_t*>(inv_tw),
                          static_cast<const int32_t*>(slot_inv), T, log_n);
}

// Kernel 6, and kernel 8 with the 2-factor slot table. Returns a
// cudaError_t (0 on success).
int ntt_grid(const void* x, void* out, const void* limbs, const void* fwd_tw,
             const void* slot_inv, int G, int T, int log_n, void* stream) {
  return zq::launch_split(ntt_grid_kernel, dim3(2 * T, G), false, log_n, stream,
                          static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
                          static_cast<const uint32_t*>(limbs), static_cast<const uint32_t*>(fwd_tw),
                          static_cast<const int32_t*>(slot_inv), T, log_n);
}

// Kernel 7. Returns a cudaError_t (0 on success).
int rescale_fwd(const void* coeff, const void* xs, const void* is_neg, const void* t,
                const void* t_neg, const void* consts, void* out, const void* limbs,
                const void* fwd_tw, const void* slot_inv, int G, int L, int K, int zp, int log_n,
                void* stream) {
  return zq::launch_split(rescale_fwd_kernel, dim3(2 * L, G), false, log_n, stream,
                          static_cast<const uint32_t*>(coeff), static_cast<const uint32_t*>(xs),
                          static_cast<const uint32_t*>(is_neg), static_cast<const uint32_t*>(t),
                          static_cast<const uint32_t*>(t_neg), static_cast<const uint32_t*>(consts),
                          static_cast<uint32_t*>(out), static_cast<const uint32_t*>(limbs),
                          static_cast<const uint32_t*>(fwd_tw),
                          static_cast<const int32_t*>(slot_inv), L, K, static_cast<uint32_t>(zp),
                          log_n);
}

}  // extern "C"
