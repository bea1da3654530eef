// Exact mod-q device arithmetic on uint32 residues, q < 2^31.
//
// Replaces the TPU helpers of alchemy_tpu/backend/pallas/ntt_pallas.py:31-209
// (_mulhi, _shoup, _reduce_u32, the bf16 digit-plane matmul recombination)
// and mul_relin_pallas.py:95-133 (_mulmod_gen, _addmod, _submod, _dft4).
// The TPU has no 64-bit lanes and no mulhi, so it splits words into 16-bit
// halves and multiplies through bf16 planes; Hopper has __umulhi and a
// native 32x32->64 product, so each of these is a few instructions.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

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

// Forward negacyclic NTT of a[0, n) in shared memory (Cooley-Tukey, natural
// order in): afterwards a[i] holds x(psi^(2*bitrev(i)+1)). tw/tws hold
// psi^bitrev(k) and its Shoup companions. Every thread of the block calls
// this; the caller synchronises before it, and it returns synchronised.
__device__ __forceinline__ void ntt_forward(uint32_t* a, int log_n,
                                            const uint32_t* __restrict__ tw,
                                            const uint32_t* __restrict__ tws,
                                            uint32_t q) {
  const int half = 1 << (log_n - 1);
  for (int m = 1, log_t = log_n - 1; log_t >= 0; m <<= 1, --log_t) {
    const int t = 1 << log_t;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> log_t;
      const int j = (i << (log_t + 1)) + (k & (t - 1));
      const uint32_t u = a[j];
      const uint32_t v = mulmod_shoup(a[j + t], __ldg(tw + m + i), __ldg(tws + m + i), q);
      a[j] = add_mod(u, v, q);
      a[j + t] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

// Inverse of ntt_forward without the n^-1 scale (Gentleman-Sande,
// bit-reversed evaluation order in, natural order out). tw/tws hold
// psi^-bitrev(k) and companions.
__device__ __forceinline__ void ntt_inverse(uint32_t* a, int log_n,
                                            const uint32_t* __restrict__ tw,
                                            const uint32_t* __restrict__ tws,
                                            uint32_t q) {
  const int half = 1 << (log_n - 1);
  for (int h = half, log_t = 0; h >= 1; h >>= 1, ++log_t) {
    const int t = 1 << log_t;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> log_t;
      const int j = (i << (log_t + 1)) + (k & (t - 1));
      const uint32_t u = a[j];
      const uint32_t v = a[j + t];
      a[j] = add_mod(u, v, q);
      a[j + t] = mulmod_shoup(sub_mod(u, v, q), __ldg(tw + h + i), __ldg(tws + h + i), q);
    }
    __syncthreads();
  }
}

// Launches a kernel that keeps one limb in shared memory (n words, opted in
// as dynamic shared memory; n/2 threads up to 1024, one butterfly each per
// stage) on `stream`. Returns a cudaError_t (0 on success).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, int log_n, void* stream, Args... args) {
  const int n = 1 << log_n;
  const dim3 block(n / 2 < 1024 ? n / 2 : 1024);
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace zq
