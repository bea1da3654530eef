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
//
// split = 1: the limb is split over two blocks (kernels A, B, 5, 6), and a
// holds only its half `part` (a[x] is index part*n/2 + x of the whole). Only the first
// stage (m = 1) pairs j with j + n/2; the caller fuses it into its load
// (forward_first_stage), and this runs the log2(n) - 1 stages that stay
// inside the half, with the whole transform's twiddles m + part*m/2 + i.
__device__ __forceinline__ void ntt_forward(uint32_t* a, int log_n,
                                            const uint32_t* __restrict__ tw,
                                            const uint32_t* __restrict__ tws,
                                            uint32_t q, int split = 0, int part = 0) {
  const int bfly = 1 << (log_n - split - 1);
  for (int m = 1 << split, log_t = log_n - split - 1; log_t >= 0; m <<= 1, --log_t) {
    const int t = 1 << log_t;
    const int w0 = m + part * (m >> split);
    for (int k = threadIdx.x; k < bfly; k += blockDim.x) {
      const int i = k >> log_t;
      const int j = (i << (log_t + 1)) + (k & (t - 1));
      const uint32_t u = a[j];
      const uint32_t v = mulmod_shoup(a[j + t], __ldg(tw + w0 + i), __ldg(tws + w0 + i), q);
      a[j] = add_mod(u, v, q);
      a[j + t] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

// Inverse of ntt_forward without the n^-1 scale (Gentleman-Sande,
// bit-reversed evaluation order in, natural order out). tw/tws hold
// psi^-bitrev(k) and companions. split = 1: a holds half `part` of the limb
// and this runs the log2(n) - 1 stages that stay inside it; the last stage,
// which pairs j with j + n/2, is inverse_last_stage's.
__device__ __forceinline__ void ntt_inverse(uint32_t* a, int log_n,
                                            const uint32_t* __restrict__ tw,
                                            const uint32_t* __restrict__ tws,
                                            uint32_t q, int split = 0, int part = 0) {
  const int bfly = 1 << (log_n - split - 1);
  for (int h = 1 << (log_n - 1), log_t = 0; log_t < log_n - split; h >>= 1, ++log_t) {
    const int t = 1 << log_t;
    const int w0 = h + part * (h >> split);
    for (int k = threadIdx.x; k < bfly; k += blockDim.x) {
      const int i = k >> log_t;
      const int j = (i << (log_t + 1)) + (k & (t - 1));
      const uint32_t u = a[j];
      const uint32_t v = a[j + t];
      a[j] = add_mod(u, v, q);
      a[j + t] = mulmod_shoup(sub_mod(u, v, q), __ldg(tw + w0 + i), __ldg(tws + w0 + i), q);
    }
    __syncthreads();
  }
}

// The first stage of ntt_forward for a limb split over two blocks, fused
// into the load from device memory: block `part` keeps x[j] + w*x[j + n/2]
// (part 0) or x[j] - w*x[j + n/2] (part 1) in a[j], j < n/2, with w the
// stage's one twiddle; x may hold any uint32. Both blocks read all of x (the
// second read comes from L2), so no block needs the other's shared memory.
// The caller synchronises after it.
__device__ __forceinline__ void forward_first_stage(uint32_t* a, const uint32_t* __restrict__ x,
                                                    int log_n, int part,
                                                    const uint32_t* __restrict__ tw,
                                                    const uint32_t* __restrict__ tws,
                                                    const Limb& k) {
  const int half = 1 << (log_n - 1);
  const uint32_t w = __ldg(tw + 1), ws = __ldg(tws + 1);
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    const uint32_t u = reduce(x[j], k);
    const uint32_t v = mulmod_shoup(x[j + half], w, ws, k.q);
    a[j] = part ? sub_mod(u, v, k.q) : add_mod(u, v, k.q);
  }
}

// The last stage of ntt_inverse for a limb split over a thread block cluster
// of two (block `part` of the pair holds half `part`, after ntt_inverse with
// split = 1), scaled by n^-1: out[j] = (u + v)*n^-1 from block 0 and
// out[n/2 + j] = (u - v)*w*n^-1 from block 1, with u = half 0's a[j] and
// v = half 1's, each block reading its partner's half through distributed
// shared memory. Every thread of both blocks calls it; it returns once both
// blocks are done reading, so neither exits while the other reads its a.
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
    const uint32_t mine = a[j], theirs = other[j];
    const uint32_t r = part ? mulmod_shoup(sub_mod(theirs, mine, k.q), w, ws, k.q)
                            : add_mod(mine, theirs, k.q);
    out[part * half + j] = mulmod_shoup(r, k.n_inv, k.n_inv_s, k.q);
  }
  cluster.sync();
}

// Launches a kernel that keeps one limb in shared memory (n words, opted in
// as dynamic shared memory; n/2 threads up to 1024, one butterfly each per
// stage) on `stream`: kernels 4 and 7. Returns a cudaError_t (0 on success).
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

// Launches a kernel that keeps half of one limb in shared memory, two blocks
// per limb along x (n/2 words opted in as dynamic shared memory; n/4
// threads up to 1024, one butterfly each per stage), on `stream`: kernels
// A, B, 5 and 6 at every n. With cluster, each pair of blocks along x is a
// thread block cluster of two, for the kernels whose last stage crosses the
// halves. Returns a cudaError_t (0 on success): a refused launch or cluster
// shape is an error, never a fallback.
template <typename... Params, typename... Args>
int launch_split(void (*kernel)(Params...), dim3 grid, bool cluster, int log_n, void* stream,
                 Args... args) {
  const int n = 1 << log_n;
  const size_t smem = static_cast<size_t>(n / 2) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(n / 4 < 1024 ? n / 4 : 1024);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace zq
