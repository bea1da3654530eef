// The general path's mod-q kernels (backend/torch_backend.py TorchBackend),
// for sm_90a, with a plain C interface loaded through ctypes.
//
// They replace no Pallas kernel: the JAX package's XlaBackend
// (alchemy_tpu/backend/xla.py) leaves this arithmetic to XLA, which fuses
// each chain of elementwise ops into one loop. Eager PyTorch launches one
// kernel a torch op instead: a float64 contraction of _matmul_mod was 15
// int64/float64 ops around its GEMM, an elementwise method two (the op,
// then % q), a rescale step 14. Each works on rows of a few limbs of
// 10^3-10^4 int64 residues (a few hundred KB), so each launch is bound by
// one small kernel's latency on the H100 (about 2 us a graph node), not by
// its bytes; only the largest split and recombine (tens of MB) reach the
// card's bandwidth. The design answers with one launch a chain, each a
// single pass over its operands, one thread an output word, no shared
// memory: what is left is one node's latency, then the bytes.
//
// Layouts (int64 canonical residues in [0, q), q < 2^31; strides in
// elements, any, so views are read in place). Each kernel takes one table of
// zq::Limb rows, 8 uint32 words a limb (launch.limb_words): q, a constant w
// and its Shoup companion in n^-1's pair (words 1, 2), floor(2^32/q),
// floor(2^64/q) (words 4, 5), a second constant w2 and its companion (words
// 6, 7); w, w2 below:
//   gp_split16      x [L, A, K, B] -> xs [L, K, 2R] float64, R = A*B,
//                   r = a*B + b: xs[l, k, r] = x & 0xFFFF, xs[l, k, R + r] =
//                   x >> 16 (the GEMM's operand [x_lo | x_hi])
//   gp_recombine    p [L, 2D, 2R] float64, the GEMM [W_lo; W_hi] [x_lo | x_hi]
//                   -> out [L, A, D, B]: lo + (lh + hl)*2^16 + hh*2^32 mod q,
//                   each partial sum an exact integer below 2^53 (w = 2^16,
//                   w2 = 2^32 mod q)
//   gp_binop        a, b [L, n] -> out [L, n] contiguous: a + b, a - b, -a or
//                   a*b mod q (the table of gp_recombine; q and floor(2^64/q))
//   gp_scale_pad    x [>= L0, n], the first L0 rows' table (w the scale) ->
//                   out [L1, n], L1 >= L0: rows l < L0 x*w mod q, the rest 0
//   gp_rescale_step x [L + 1, n] over qs + (q_k,), the kept limbs' table (w =
//                   q_k^-1 mod q) -> out [L, n]: (x - delta)*q_k^-1 mod q
//                   with delta = x_L mod q_k centred, plus q_k*t, t centred
//                   mod zp, so that delta = 0 mod zp (she/bgv rescale; any zp
//                   in [2, 2^33))
//
// Each C entry returns a cudaError_t (0 on success). The kernels index in
// 32 bits: the host refuses a launch of more than 2^30 words (modq.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "zq.cuh"

namespace modq {

constexpr int kThreads = 256;
using zq::kLimbWords;

// x mod q for any uint64 x (zq::reduce64 with the limb's floor(2^64/q)).
__device__ __forceinline__ uint32_t reduce(uint64_t x, const zq::Limb& k) {
  return zq::reduce64(x, k.q, k.barrett);
}

__device__ __forceinline__ int index() { return blockIdx.x * kThreads + threadIdx.x; }

__global__ void gp_split16(const int64_t* __restrict__ x, double* __restrict__ xs, int K, int A,
                           int B, long long sL, long long sA, long long sK, long long sB,
                           int total) {
  const int i = index();
  if (i >= total) return;
  const int R = A * B;
  const int r = i % R, t = i / R;
  const int k = t % K, l = t / K;
  const uint64_t v = static_cast<uint64_t>(x[l * sL + (r / B) * sA + k * sK + (r % B) * sB]);
  double* row = xs + static_cast<long long>(t) * 2 * R;
  row[r] = static_cast<double>(v & 0xFFFF);
  row[R + r] = static_cast<double>(v >> 16);
}

__global__ void gp_recombine(const double* __restrict__ p, int64_t* __restrict__ out,
                             const uint32_t* __restrict__ limbs, int D, int A, int B, long long oL,
                             long long oA, long long oD, long long oB, int total) {
  const int i = index();
  if (i >= total) return;
  const int R = A * B;
  const int r = i % R, t = i / R;
  const int o = t % D, l = t / D;
  const uint32_t* c = limbs + l * kLimbWords;
  const zq::Limb k = zq::load_limb(c);
  const double* top = p + (static_cast<long long>(l) * 2 * D + o) * 2 * R;
  const double* bot = top + static_cast<long long>(D) * 2 * R;
  const uint32_t lo = reduce(static_cast<uint64_t>(top[r]), k);
  const uint32_t lh = reduce(static_cast<uint64_t>(top[R + r]), k);
  const uint32_t hl = reduce(static_cast<uint64_t>(bot[r]), k);
  const uint32_t hh = reduce(static_cast<uint64_t>(bot[R + r]), k);
  uint32_t s = zq::add_mod(lo, zq::mulmod_shoup(zq::add_mod(lh, hl, k.q), c[1], c[2], k.q), k.q);
  s = zq::add_mod(s, zq::mulmod_shoup(hh, c[6], c[7], k.q), k.q);
  out[l * oL + (r / B) * oA + o * oD + (r % B) * oB] = s;
}

enum Op { kAdd = 0, kSub = 1, kNeg = 2, kMul = 3 };

template <int kOp>
__global__ void gp_binop(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                         int64_t* __restrict__ out, const uint32_t* __restrict__ limbs, int n,
                         long long a0, long long a1, long long b0, long long b1, int total) {
  const int i = index();
  if (i >= total) return;
  const int l = i / n, j = i % n;
  const zq::Limb k = zq::load_limb(limbs + l * kLimbWords);
  const uint64_t x = static_cast<uint64_t>(a[l * a0 + j * a1]);
  uint64_t y = 0;
  if constexpr (kOp != kNeg) y = static_cast<uint64_t>(b[l * b0 + j * b1]);
  uint64_t s;
  if constexpr (kOp == kAdd) {
    s = zq::add_mod(static_cast<uint32_t>(x), static_cast<uint32_t>(y), k.q);
  } else if constexpr (kOp == kSub) {
    s = zq::sub_mod(static_cast<uint32_t>(x), static_cast<uint32_t>(y), k.q);
  } else if constexpr (kOp == kNeg) {
    s = x == 0 ? 0 : k.q - x;
  } else {
    s = zq::mulmod(static_cast<uint32_t>(x), static_cast<uint32_t>(y), k);
  }
  out[i] = static_cast<int64_t>(s);
}

__global__ void gp_scale_pad(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                             const uint32_t* __restrict__ scale, int L0, int n, long long x0,
                             long long x1, int total) {
  const int i = index();
  if (i >= total) return;
  const int l = i / n, j = i % n;
  uint32_t s = 0;
  if (l < L0) {
    const uint32_t* c = scale + kLimbWords * l;
    s = zq::mulmod_shoup(static_cast<uint32_t>(x[l * x0 + j * x1]), c[1], c[2], c[0]);
  }
  out[i] = s;
}

// a*b mod m for a, b < m < 2^62, by doubling (once a column, not a word).
__device__ __forceinline__ uint64_t mulmod_slow(uint64_t a, uint64_t b, uint64_t m) {
  uint64_t r = 0;
  for (; b; b >>= 1) {
    if (b & 1) r = r + a >= m ? r + a - m : r + a;
    a = a + a >= m ? a + a - m : a + a;
  }
  return r;
}

// One thread a column: the dropped word once, delta once, then every kept limb.
__global__ void gp_rescale_step(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                                const uint32_t* __restrict__ consts, int L, int n, long long x0,
                                long long x1, long long qk, long long zp, long long qk_inv_zp) {
  const int j = index();
  if (j >= n) return;
  long long r = x[L * x0 + j * x1];
  if (r > qk / 2) r -= qk;
  long long u = (-r) % zp;
  if (u < 0) u += zp;
  long long t = static_cast<long long>(mulmod_slow(u, qk_inv_zp, zp));
  if (t > zp / 2) t -= zp;
  const long long delta = r + qk * t;
  const uint64_t mag = static_cast<uint64_t>(delta < 0 ? -delta : delta);
  for (int l = 0; l < L; ++l) {
    const uint32_t* c = consts + kLimbWords * l;
    const zq::Limb k = zq::load_limb(c);
    uint32_t dm = reduce(mag, k);
    if (delta < 0 && dm) dm = k.q - dm;
    const uint32_t v = zq::sub_mod(static_cast<uint32_t>(x[l * x0 + j * x1]), dm, k.q);
    out[static_cast<long long>(l) * n + j] = zq::mulmod_shoup(v, c[1], c[2], k.q);  // w = q_k^-1
  }
}

inline dim3 blocks(int total) { return dim3((total + kThreads - 1) / kThreads); }

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

template <int kOp>
int binop(const int64_t* a, const int64_t* b, int64_t* out, const uint32_t* limbs, int L, int n,
          long long a0, long long a1, long long b0, long long b1, cudaStream_t stream) {
  gp_binop<kOp><<<blocks(L * n), kThreads, 0, stream>>>(a, b, out, limbs, n, a0, a1, b0, b1, L * n);
  return last_error();
}

}  // namespace modq

extern "C" {

int gp_split16(const void* x, void* xs, int L, int A, int K, int B, long long sL, long long sA,
               long long sK, long long sB, void* stream) {
  const int total = L * A * K * B;
  modq::gp_split16<<<modq::blocks(total), modq::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<double*>(xs), K, A, B, sL, sA, sK, sB, total);
  return modq::last_error();
}

int gp_recombine(const void* p, void* out, const void* limbs, int L, int A, int D, int B,
                 long long oL, long long oA, long long oD, long long oB, void* stream) {
  const int total = L * A * D * B;
  modq::gp_recombine<<<modq::blocks(total), modq::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(p), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(limbs), D, A, B, oL, oA, oD, oB, total);
  return modq::last_error();
}

// op: 0 a + b, 1 a - b, 2 -a (b unread), 3 a*b.
int gp_binop(const void* a, const void* b, void* out, const void* limbs, int op, int L, int n,
             long long a0, long long a1, long long b0, long long b1, void* stream) {
  const auto x = static_cast<const int64_t*>(a), y = static_cast<const int64_t*>(b);
  const auto o = static_cast<int64_t*>(out);
  const auto c = static_cast<const uint32_t*>(limbs);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case modq::kAdd: return modq::binop<modq::kAdd>(x, y, o, c, L, n, a0, a1, b0, b1, s);
    case modq::kSub: return modq::binop<modq::kSub>(x, y, o, c, L, n, a0, a1, b0, b1, s);
    case modq::kNeg: return modq::binop<modq::kNeg>(x, y, o, c, L, n, a0, a1, b0, b1, s);
    case modq::kMul: return modq::binop<modq::kMul>(x, y, o, c, L, n, a0, a1, b0, b1, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int gp_scale_pad(const void* x, void* out, const void* scale, int L0, int L1, int n, long long x0,
                 long long x1, void* stream) {
  const int total = L1 * n;
  modq::gp_scale_pad<<<modq::blocks(total), modq::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(scale), L0, n, x0, x1, total);
  return modq::last_error();
}

int gp_rescale_step(const void* x, void* out, const void* consts, int L, int n, long long x0,
                    long long x1, long long qk, long long zp, long long qk_inv_zp, void* stream) {
  modq::gp_rescale_step<<<modq::blocks(n), modq::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(consts), L, n, x0, x1, qk, zp, qk_inv_zp);
  return modq::last_error();
}

}  // extern "C"
