// Native (C++) Zq/NTT kernels — the rebuild's counterpart of the reference's
// lol-cpp tensor backend (SURVEY.md §2.3 "Native layer"). On TPU the compute
// path is XLA/Pallas; this library is the *host-native* bit-exact model used
// for checked-mode verification at sizes the numpy golden model cannot reach,
// and as a fast CPU reference for benchmarks.
//
// The negacyclic NTT mirrors backend/ntt.py exactly (radix-2 DIF forward,
// natural -> bit-reversed, DIT inverse; psi-twist pre/post vectors), so
// outputs are limb-for-limb identical to the JAX VPU path.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t addmod(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t s = a + b;
  return s >= q ? s - q : s;
}

inline uint32_t submod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

inline uint32_t mulmod(uint32_t a, uint32_t b, uint32_t q) {
  return (uint32_t)((uint64_t)a * b % q);
}

inline uint32_t powmod(uint32_t a, uint64_t e, uint32_t q) {
  uint64_t r = 1, x = a % q;
  while (e) {
    if (e & 1) r = r * x % q;
    x = x * x % q;
    e >>= 1;
  }
  return (uint32_t)r;
}

}  // namespace

extern "C" {

void zq_add(const uint32_t* a, const uint32_t* b, uint32_t* out, uint64_t n,
            uint32_t q) {
  for (uint64_t i = 0; i < n; ++i) out[i] = addmod(a[i], b[i], q);
}

void zq_sub(const uint32_t* a, const uint32_t* b, uint32_t* out, uint64_t n,
            uint32_t q) {
  for (uint64_t i = 0; i < n; ++i) out[i] = submod(a[i], b[i], q);
}

void zq_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, uint64_t n,
            uint32_t q) {
  for (uint64_t i = 0; i < n; ++i) out[i] = mulmod(a[i], b[i], q);
}

// Forward negacyclic NTT, in place on x[n]; psi is a primitive 2n-th root of
// unity mod q (the caller supplies the same root the JAX tables use).
// Layout identical to backend/ntt.py: pre-twist by psi^j, then radix-2 DIF
// stages with twiddles w^(j*2^s), natural order in, bit-reversed out.
void ntt_negacyclic(uint32_t* x, uint64_t n, uint32_t q, uint32_t psi) {
  std::vector<uint32_t> tmp(n);
  uint32_t w = mulmod(psi, psi, q);
  // pre-twist
  uint32_t p = 1;
  for (uint64_t j = 0; j < n; ++j) {
    x[j] = mulmod(x[j], p, q);
    p = mulmod(p, psi, q);
  }
  uint64_t k = 0;
  for (uint64_t t = n; t > 1; t >>= 1) ++k;
  for (uint64_t s = 0; s < k; ++s) {
    uint64_t m = n >> (s + 1);
    uint64_t blocks = 1ull << s;
    uint32_t step = powmod(w, 1ull << s, q);
    for (uint64_t blk = 0; blk < blocks; ++blk) {
      uint32_t tw = 1;
      uint32_t* base = x + blk * 2 * m;
      for (uint64_t j = 0; j < m; ++j) {
        uint32_t a = base[j];
        uint32_t b = base[j + m];
        base[j] = addmod(a, b, q);
        base[j + m] = mulmod(submod(a, b, q), tw, q);
        tw = mulmod(tw, step, q);
      }
    }
  }
  (void)tmp;
}

// Inverse negacyclic NTT (bit-reversed in, natural out), matching
// backend/ntt.py intt_negacyclic.
void intt_negacyclic(uint32_t* x, uint64_t n, uint32_t q, uint32_t psi) {
  uint32_t w = mulmod(psi, psi, q);
  uint32_t winv = powmod(w, q - 2, q);
  uint64_t k = 0;
  for (uint64_t t = n; t > 1; t >>= 1) ++k;
  for (int64_t s = (int64_t)k - 1; s >= 0; --s) {
    uint64_t m = n >> (s + 1);
    uint64_t blocks = 1ull << s;
    uint32_t step = powmod(winv, 1ull << s, q);
    for (uint64_t blk = 0; blk < blocks; ++blk) {
      uint32_t tw = 1;
      uint32_t* base = x + blk * 2 * m;
      for (uint64_t j = 0; j < m; ++j) {
        uint32_t A = base[j];
        uint32_t B = mulmod(base[j + m], tw, q);
        base[j] = addmod(A, B, q);
        base[j + m] = submod(A, B, q);
        tw = mulmod(tw, step, q);
      }
    }
  }
  // post-twist by psi^{-j} * n^{-1}
  uint32_t psi_inv = powmod(psi, q - 2, q);
  uint32_t n_inv = powmod((uint32_t)(n % q), q - 2, q);
  uint32_t p = n_inv;
  for (uint64_t j = 0; j < n; ++j) {
    x[j] = mulmod(x[j], p, q);
    p = mulmod(p, psi_inv, q);
  }
}

// Fused ciphertext multiply + CRT-gadget relinearization on one limb set —
// the reference workload's inner loop in portable native code. Layout:
// ct = [2, L, n] row-major, hints hb/ha = [L, L, n]. All arrays in the
// NTT domain except the internal digit pass.
void bgv_mul_relin(const uint32_t* ct_a, const uint32_t* ct_b,
                   const uint32_t* hb, const uint32_t* ha, uint32_t* out,
                   uint64_t L, uint64_t n, const uint32_t* qs,
                   const uint32_t* psis) {
  const uint64_t ln = L * n;
  std::vector<uint32_t> c2(ln);
  // pointwise products
  for (uint64_t l = 0; l < L; ++l) {
    uint32_t q = qs[l];
    const uint32_t* a0 = ct_a + l * n;
    const uint32_t* a1 = ct_a + ln + l * n;
    const uint32_t* b0 = ct_b + l * n;
    const uint32_t* b1 = ct_b + ln + l * n;
    uint32_t* o0 = out + l * n;
    uint32_t* o1 = out + ln + l * n;
    uint32_t* c2l = c2.data() + l * n;
    for (uint64_t i = 0; i < n; ++i) {
      o0[i] = mulmod(a0[i], b0[i], q);
      o1[i] = addmod(mulmod(a0[i], b1[i], q), mulmod(a1[i], b0[i], q), q);
      c2l[i] = mulmod(a1[i], b1[i], q);
    }
  }
  // digits: INTT per limb, broadcast rows, NTT per (digit, limb)
  for (uint64_t l = 0; l < L; ++l)
    intt_negacyclic(c2.data() + l * n, n, qs[l], psis[l]);
  std::vector<uint32_t> dig(n);
  for (uint64_t i = 0; i < L; ++i) {
    const uint32_t* row = c2.data() + i * n;
    for (uint64_t l = 0; l < L; ++l) {
      uint32_t q = qs[l];
      for (uint64_t t = 0; t < n; ++t) dig[t] = row[t] % q;
      ntt_negacyclic(dig.data(), n, q, psis[l]);
      const uint32_t* hbr = hb + (i * L + l) * n;
      const uint32_t* har = ha + (i * L + l) * n;
      uint32_t* o0 = out + l * n;
      uint32_t* o1 = out + ln + l * n;
      for (uint64_t t = 0; t < n; ++t) {
        o0[t] = addmod(o0[t], mulmod(dig[t], hbr[t], q), q);
        o1[t] = addmod(o1[t], mulmod(dig[t], har[t], q), q);
      }
    }
  }
}

}  // extern "C"
