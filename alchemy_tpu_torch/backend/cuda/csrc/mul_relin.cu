// Kernels A, B and 4 of BGV ciphertext multiply + relinearize, for sm_90a,
// with a plain C interface loaded through ctypes.
//
// Kernel A, tensor_intt, replaces alchemy_tpu/backend/pallas/
// mul_relin_pallas.py:232 _tensor_intt_kernel. Kernel B, digit_relin (CRT
// gadget), replaces mul_relin_pallas.py:439 _digit_relin_ctmajor_kernel and
// :319 _digit_relin_kernel (raw or Shoup hints; the limb-major variant the
// TPU runs at n = 2^16). Kernel 4, hybrid_digit_relin (hybrid
// key-switching), replaces :807 _hybrid_digit_relin_kernel.
//
// Layouts (uint32 residues, canonical, the 3-factor NTT slot order of
// backend/ntt3.py at the boundaries):
//   ct_a, ct_b  [Bt, 2, L, n]   NTT domain
//   c0, c1      [Bt, L, n]      NTT domain
//   c2c         [Bt, L, n]      coefficients of c2 (natural order)
//   hints (B)   [L, L, n]       hint_b and hint_a, indexed [digit i, limb l];
//                               raw values or (values, companions) pairs
//   out (B)     [Bt, 2, L, n]   NTT domain
//   x (4)       [Bt, L, n]      Garner digits of c2c per limb group,
//                               group-major (natural order)
//   ext (4)     [T, 2, L]       [pi_k]_{q_t} and Shoup companions
//   hints (4)   [dnum, T, n]    over the extended chain of T = L + K limbs
//   out (4)     [2, Bt, T, n]   NTT domain, before the rescale by P
//
// What bounds them on the H100: the TPU's matmul-shaped 3-factor NTT is
// replaced by a radix-2 NTT with native 64-bit products and Shoup twiddles,
// run in shared memory, its log2(n) butterfly stages separated by block
// barriers. Inside a kernel the NTT works in bit-reversed evaluation order;
// the host tables slot_ct[s] = bitrev(K(s)) and its inverse slot_inv map
// each slot s of the 3-factor order to it and back.
//
// Kernels A and B split each limb over two blocks (a limb of 2^16 words,
// 256 KB, exceeds the 227 KB of shared memory a block can have): each block
// holds half of it (64 KB at n = 2^15, so two blocks share an SM; 128 KB at
// 2^16) and owns the slots whose radix-2 index lies in its half
// (slot_inv[part*n/2 + j]). Only one stage of each NTT crosses the halves.
// B's forward NTTs fuse it, their first, into the load (both blocks read the
// whole digit row, the second time from L2); A's inverse NTT finishes it,
// its last, across a thread block cluster of two through distributed shared
// memory. Measured on the H100 (PERF.md), B at n = 2^15 takes 34% less time
// this way than with one block per whole limb.
//
// Kernel B streams every hint row once per ciphertext (Bt*4*L^2*n words,
// L2-resident when the hints fit the 50 MB L2) and keeps its running sums in
// the output buffer, since two accumulators per slot do not fit the
// registers. Its unique bytes would take ~1/30 of its time at full
// bandwidth: the serial chain of L*log2(n) barrier-separated stages of each
// block bounds it (PERF.md). Kernel 4 still keeps one whole limb per block
// (n words, one block per SM at 2^15, none at 2^16) and runs dnum transforms
// per block over T blocks per ciphertext; its base extension (alpha Shoup
// products per slot and group) is built in shared memory, never in device
// memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "zq.cuh"

namespace {

using zq::kLimbWords;

// Two blocks per (limb l, ciphertext b), a cluster of two: block `part`
// does the Karatsuba tensor product c0 = a0*b0, c2 = a1*b1,
// c1 = (a0+a1)(b0+b1) - c0 - c2 of the slots whose radix-2 index lies in its
// half and keeps c2 there; then the inverse NTT's stages inside the half,
// and the last stage across the pair. At most 32 registers a thread, so that
// two 1024-thread blocks share an SM where their halves fit (n <= 2^15).
__global__ void __launch_bounds__(1024, 2)
tensor_intt_kernel(const uint32_t* __restrict__ ct_a, const uint32_t* __restrict__ ct_b,
                   uint32_t* __restrict__ c0, uint32_t* __restrict__ c1,
                   uint32_t* __restrict__ c2c, const uint32_t* __restrict__ limbs,
                   const uint32_t* __restrict__ inv_tw,
                   const int32_t* __restrict__ slot_inv, int L, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, half = n >> 1;
  const int l = blockIdx.x >> 1, part = blockIdx.x & 1;
  const size_t b = blockIdx.y;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * l);
  const size_t limb_off = static_cast<size_t>(l) * n;
  const uint32_t* a0 = ct_a + b * 2 * L * n + limb_off;
  const uint32_t* a1 = a0 + static_cast<size_t>(L) * n;
  const uint32_t* b0 = ct_b + b * 2 * L * n + limb_off;
  const uint32_t* b1 = b0 + static_cast<size_t>(L) * n;
  const size_t out_off = b * L * n + limb_off;
  const int32_t* own = slot_inv + part * half;

  for (int x = threadIdx.x; x < half; x += blockDim.x) {
    const int s = own[x];
    const uint32_t x0 = a0[s], x1 = a1[s], y0 = b0[s], y1 = b1[s];
    const uint32_t p0 = zq::mulmod(x0, y0, k);
    const uint32_t p2 = zq::mulmod(x1, y1, k);
    const uint32_t cross = zq::mulmod(zq::add_mod(x0, x1, k.q), zq::add_mod(y0, y1, k.q), k);
    c0[out_off + s] = p0;
    c1[out_off + s] = zq::sub_mod(cross, zq::add_mod(p0, p2, k.q), k.q);
    buf[x] = p2;
  }
  __syncthreads();
  const uint32_t* tw = inv_tw + 2 * limb_off;
  zq::ntt_inverse(buf, log_n, tw, tw + n, k.q, 1, part);
  zq::inverse_last_stage(buf, c2c + out_off, log_n, part, tw, tw + n, k);
}

// Two blocks per (output limb l, ciphertext b); the gadget digits i loop
// inside: digit i = c2c[b, i] (a residue mod q_i) is reduced mod q_l,
// transformed, and its products with hint row (i, l) are added to the sums.
// Block `part` runs each digit's forward NTT on its half (first stage fused
// into the load) and accumulates the slots whose radix-2 index lies there,
// so every slot has one owner. kShoup: the hints are (values, companions)
// pairs, multiplied with mulmod_shoup; otherwise raw values (hbs, has
// unused), multiplied with the Barrett mulmod. Registers as in
// tensor_intt_kernel.
template <bool kShoup>
__global__ void __launch_bounds__(1024, 2)
digit_relin_kernel(const uint32_t* __restrict__ c2c, const uint32_t* c0,
                   const uint32_t* c1, const uint32_t* __restrict__ hb,
                   const uint32_t* __restrict__ hbs, const uint32_t* __restrict__ ha,
                   const uint32_t* __restrict__ has, uint32_t* out,
                   const uint32_t* __restrict__ limbs, const uint32_t* __restrict__ fwd_tw,
                   const int32_t* __restrict__ slot_inv, int L, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n, half = n >> 1;
  const int l = blockIdx.x >> 1, part = blockIdx.x & 1;
  const size_t b = blockIdx.y;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * l);
  const size_t limb_off = static_cast<size_t>(l) * n;
  const uint32_t* digits = c2c + b * L * n;
  const uint32_t* in0 = c0 + b * L * n + limb_off;
  const uint32_t* in1 = c1 + b * L * n + limb_off;
  uint32_t* out0 = out + b * 2 * L * n + limb_off;
  uint32_t* out1 = out0 + static_cast<size_t>(L) * n;
  const uint32_t* tw = fwd_tw + 2 * limb_off;
  const int32_t* own = slot_inv + part * half;

  for (int i = 0; i < L; ++i) {
    zq::forward_first_stage(buf, digits + static_cast<size_t>(i) * n, log_n, part, tw, tw + n, k);
    __syncthreads();
    zq::ntt_forward(buf, log_n, tw, tw + n, k.q, 1, part);
    const size_t h = (static_cast<size_t>(i) * L + l) * n;
    // Each thread reads back only the slots it wrote at digit i - 1 (out
    // and c0/c1 are not __restrict__: src0 aliases out0 from i = 1 on).
    const uint32_t* src0 = i == 0 ? in0 : out0;
    const uint32_t* src1 = i == 0 ? in1 : out1;
    for (int x = threadIdx.x; x < half; x += blockDim.x) {
      const int s = own[x];
      const uint32_t v = buf[x];
      const uint32_t p0 = kShoup ? zq::mulmod_shoup(v, hb[h + s], hbs[h + s], k.q)
                                 : zq::mulmod(v, hb[h + s], k);
      const uint32_t p1 = kShoup ? zq::mulmod_shoup(v, ha[h + s], has[h + s], k.q)
                                 : zq::mulmod(v, ha[h + s], k);
      out0[s] = zq::add_mod(src0[s], p0, k.q);
      out1[s] = zq::add_mod(src1[s], p1, k.q);
    }
    __syncthreads();  // buf is rewritten by the next digit
  }
}

// Kernel 4. One block per (extended limb t, ciphertext b); the dnum digit
// groups j loop inside. Group j covers Garner digit rows [j*alpha,
// min((j+1)*alpha, L)) of x[b]; its digit residue mod q_t is
// sum_k x[b, k] * [pi_k]_{q_t} (Shoup constants ext[t]), which is
// transformed and multiplied by hint row (j, t). The sums start from zero
// (c0 and c1 join after the rescale by P) and live in the output buffer as
// in digit_relin_kernel. One block holds the whole limb (n <= 2^15).
template <bool kShoup>
__global__ void __launch_bounds__(1024)
hybrid_digit_relin_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ ext,
                          const uint32_t* __restrict__ hb, const uint32_t* __restrict__ hbs,
                          const uint32_t* __restrict__ ha, const uint32_t* __restrict__ has,
                          uint32_t* out, const uint32_t* __restrict__ limbs,
                          const uint32_t* __restrict__ fwd_tw, const int32_t* __restrict__ slot_ct,
                          int L, int T, int dnum, int alpha, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n;
  const int t = blockIdx.x;
  const size_t b = blockIdx.y;
  const size_t bt = gridDim.y;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * t);
  const uint32_t* xb = x + b * L * n;
  const uint32_t* w = ext + 2 * static_cast<size_t>(t) * L;  // [pi_k]_{q_t}, then companions
  uint32_t* out0 = out + (b * T + t) * n;
  uint32_t* out1 = out + ((bt + b) * T + t) * n;
  const uint32_t* tw = fwd_tw + 2 * static_cast<size_t>(t) * n;

  for (int j = 0; j < dnum; ++j) {
    const int k0 = j * alpha;
    const int k1 = k0 + alpha < L ? k0 + alpha : L;
    for (int s = threadIdx.x; s < n; s += blockDim.x) {
      uint32_t acc = 0;
      for (int i = k0; i < k1; ++i) {
        acc = zq::add_mod(acc, zq::mulmod_shoup(xb[static_cast<size_t>(i) * n + s], w[i],
                                                w[L + i], k.q), k.q);
      }
      buf[s] = acc;
    }
    __syncthreads();
    zq::ntt_forward(buf, log_n, tw, tw + n, k.q);
    const size_t h = (static_cast<size_t>(j) * T + t) * n;
    for (int s = threadIdx.x; s < n; s += blockDim.x) {
      const uint32_t v = buf[slot_ct[s]];
      const uint32_t p0 = kShoup ? zq::mulmod_shoup(v, hb[h + s], hbs[h + s], k.q)
                                 : zq::mulmod(v, hb[h + s], k);
      const uint32_t p1 = kShoup ? zq::mulmod_shoup(v, ha[h + s], has[h + s], k.q)
                                 : zq::mulmod(v, ha[h + s], k);
      out0[s] = j == 0 ? p0 : zq::add_mod(out0[s], p0, k.q);
      out1[s] = j == 0 ? p1 : zq::add_mod(out1[s], p1, k.q);
    }
    __syncthreads();  // buf is rewritten by the next group
  }
}

}  // namespace

extern "C" {

const char* zq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel A. Returns a cudaError_t (0 on success).
int tensor_intt(const void* ct_a, const void* ct_b, void* c0, void* c1, void* c2c,
                const void* limbs, const void* inv_tw, const void* slot_inv, int bt, int L,
                int log_n, void* stream) {
  return zq::launch_split(tensor_intt_kernel, dim3(2 * L, bt), true, log_n, stream,
                          static_cast<const uint32_t*>(ct_a), static_cast<const uint32_t*>(ct_b),
                          static_cast<uint32_t*>(c0), static_cast<uint32_t*>(c1),
                          static_cast<uint32_t*>(c2c), static_cast<const uint32_t*>(limbs),
                          static_cast<const uint32_t*>(inv_tw),
                          static_cast<const int32_t*>(slot_inv), L, log_n);
}

// Kernel B; hbs and has are ignored unless shoup != 0. Returns a cudaError_t.
int digit_relin(const void* c2c, const void* c0, const void* c1, const void* hb,
                const void* hbs, const void* ha, const void* has, void* out,
                const void* limbs, const void* fwd_tw, const void* slot_inv, int shoup, int bt,
                int L, int log_n, void* stream) {
  return zq::launch_split(shoup ? digit_relin_kernel<true> : digit_relin_kernel<false>,
                          dim3(2 * L, bt), false, log_n, stream, static_cast<const uint32_t*>(c2c),
                          static_cast<const uint32_t*>(c0), static_cast<const uint32_t*>(c1),
                          static_cast<const uint32_t*>(hb), static_cast<const uint32_t*>(hbs),
                          static_cast<const uint32_t*>(ha), static_cast<const uint32_t*>(has),
                          static_cast<uint32_t*>(out), static_cast<const uint32_t*>(limbs),
                          static_cast<const uint32_t*>(fwd_tw),
                          static_cast<const int32_t*>(slot_inv), L, log_n);
}

// Kernel 4; hbs and has are ignored unless shoup != 0. Returns a cudaError_t.
int hybrid_digit_relin(const void* x, const void* ext, const void* hb, const void* hbs,
                       const void* ha, const void* has, void* out, const void* limbs,
                       const void* fwd_tw, const void* slot_ct, int shoup, int bt, int L, int T,
                       int dnum, int alpha, int log_n, void* stream) {
  return zq::launch(shoup ? hybrid_digit_relin_kernel<true> : hybrid_digit_relin_kernel<false>,
                    dim3(T, bt), log_n, stream, static_cast<const uint32_t*>(x),
                    static_cast<const uint32_t*>(ext), static_cast<const uint32_t*>(hb),
                    static_cast<const uint32_t*>(hbs), static_cast<const uint32_t*>(ha),
                    static_cast<const uint32_t*>(has), static_cast<uint32_t*>(out),
                    static_cast<const uint32_t*>(limbs), static_cast<const uint32_t*>(fwd_tw),
                    static_cast<const int32_t*>(slot_ct), L, T, dnum, alpha, log_n);
}

}  // extern "C"
