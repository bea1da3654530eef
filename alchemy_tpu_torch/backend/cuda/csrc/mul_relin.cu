// Kernels A and B of BGV ciphertext multiply + relinearize (CRT gadget),
// for sm_90a, with a plain C interface loaded through ctypes.
//
// Kernel A, tensor_intt, replaces alchemy_tpu/backend/pallas/
// mul_relin_pallas.py:232 _tensor_intt_kernel. Kernel B, digit_relin,
// replaces mul_relin_pallas.py:439 _digit_relin_ctmajor_kernel.
//
// Layouts (uint32 residues, canonical, the 3-factor NTT slot order of
// backend/ntt3.py at the boundaries):
//   ct_a, ct_b  [Bt, 2, L, n]   NTT domain
//   c0, c1      [Bt, L, n]      NTT domain
//   c2c         [Bt, L, n]      coefficients of c2 (natural order)
//   hints       [L, L, n] x 4   (values, companions) of hint_b and hint_a,
//                               indexed [digit i, limb l]
//   out         [Bt, 2, L, n]   NTT domain
//
// What bounds them on the H100: each block keeps one limb of one
// ciphertext (n words: 128 KB at n = 2^15) in shared memory for its NTT, so
// one block runs per SM and the log2(n) butterfly stages are separated by
// block barriers; the TPU's matmul-shaped 3-factor NTT is replaced by a
// radix-2 NTT with native 64-bit products and Shoup twiddles. Inside a
// kernel the NTT works in bit-reversed evaluation order; a host table
// slot_ct[s] = bitrev(K(s)) maps each slot s of the 3-factor order to it.
// Kernel B streams every hint row once per ciphertext (Bt*4*L^2*n words,
// L2-resident when the hints fit the 50 MB L2) and keeps its running sums in
// the output buffer, since two accumulators per slot do not fit the
// registers of a 1024-thread block. Measured on the H100 (PERF.md): kernel B
// with 8 blocks (Bt = 1) takes 70% of its time with 128 blocks (Bt = 16), and
// its unique bytes would take ~1/30 of its time at full bandwidth, so one
// block's serial chain of L*log2(n) barrier-separated stages bounds it.
#include <cuda_runtime.h>

#include <cstdint>

#include "zq.cuh"

namespace {

constexpr int kLimbWords = 8;

// One block per (limb l, ciphertext b).
__global__ void __launch_bounds__(1024)
tensor_intt_kernel(const uint32_t* __restrict__ ct_a, const uint32_t* __restrict__ ct_b,
                   uint32_t* __restrict__ c0, uint32_t* __restrict__ c1,
                   uint32_t* __restrict__ c2c, const uint32_t* __restrict__ limbs,
                   const uint32_t* __restrict__ inv_tw, const int32_t* __restrict__ slot_ct,
                   int L, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n;
  const int l = blockIdx.x;
  const size_t b = blockIdx.y;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * l);
  const size_t limb_off = static_cast<size_t>(l) * n;
  const uint32_t* a0 = ct_a + b * 2 * L * n + limb_off;
  const uint32_t* a1 = a0 + static_cast<size_t>(L) * n;
  const uint32_t* b0 = ct_b + b * 2 * L * n + limb_off;
  const uint32_t* b1 = b0 + static_cast<size_t>(L) * n;
  const size_t out_off = b * L * n + limb_off;

  // Karatsuba: c0 = a0*b0, c2 = a1*b1, c1 = (a0+a1)(b0+b1) - c0 - c2.
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const uint32_t x0 = a0[s], x1 = a1[s], y0 = b0[s], y1 = b1[s];
    const uint32_t p0 = zq::mulmod(x0, y0, k);
    const uint32_t p2 = zq::mulmod(x1, y1, k);
    const uint32_t cross = zq::mulmod(zq::add_mod(x0, x1, k.q), zq::add_mod(y0, y1, k.q), k);
    c0[out_off + s] = p0;
    c1[out_off + s] = zq::sub_mod(cross, zq::add_mod(p0, p2, k.q), k.q);
    buf[slot_ct[s]] = p2;
  }
  __syncthreads();
  const uint32_t* tw = inv_tw + 2 * limb_off;
  zq::ntt_inverse(buf, log_n, tw, tw + n, k.q);
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    c2c[out_off + s] = zq::mulmod_shoup(buf[s], k.n_inv, k.n_inv_s, k.q);
  }
}

// One block per (output limb l, ciphertext b); the gadget digits i loop
// inside: digit i = c2c[b, i] (a residue mod q_i) is reduced mod q_l,
// transformed, and its products with hint row (i, l) are added to the sums.
__global__ void __launch_bounds__(1024)
digit_relin_kernel(const uint32_t* __restrict__ c2c, const uint32_t* c0, const uint32_t* c1,
                   const uint32_t* __restrict__ hb, const uint32_t* __restrict__ hbs,
                   const uint32_t* __restrict__ ha, const uint32_t* __restrict__ has,
                   uint32_t* out,
                   const uint32_t* __restrict__ limbs, const uint32_t* __restrict__ fwd_tw,
                   const int32_t* __restrict__ slot_ct, int L, int log_n) {
  extern __shared__ uint32_t buf[];
  const int n = 1 << log_n;
  const int l = blockIdx.x;
  const size_t b = blockIdx.y;
  const zq::Limb k = zq::load_limb(limbs + kLimbWords * l);
  const size_t limb_off = static_cast<size_t>(l) * n;
  const uint32_t* digits = c2c + b * L * n;
  const uint32_t* in0 = c0 + b * L * n + limb_off;
  const uint32_t* in1 = c1 + b * L * n + limb_off;
  uint32_t* out0 = out + b * 2 * L * n + limb_off;
  uint32_t* out1 = out0 + static_cast<size_t>(L) * n;
  const uint32_t* tw = fwd_tw + 2 * limb_off;

  for (int i = 0; i < L; ++i) {
    const uint32_t* d = digits + static_cast<size_t>(i) * n;
    for (int s = threadIdx.x; s < n; s += blockDim.x) buf[s] = zq::reduce(d[s], k);
    __syncthreads();
    zq::ntt_forward(buf, log_n, tw, tw + n, k.q);
    const size_t h = (static_cast<size_t>(i) * L + l) * n;
    // Each thread reads back only the slots it wrote at digit i - 1 (out
    // and c0/c1 are not __restrict__: src0 aliases out0 from i = 1 on).
    const uint32_t* src0 = i == 0 ? in0 : out0;
    const uint32_t* src1 = i == 0 ? in1 : out1;
    for (int s = threadIdx.x; s < n; s += blockDim.x) {
      const uint32_t v = buf[slot_ct[s]];
      out0[s] = zq::add_mod(src0[s], zq::mulmod_shoup(v, hb[h + s], hbs[h + s], k.q), k.q);
      out1[s] = zq::add_mod(src1[s], zq::mulmod_shoup(v, ha[h + s], has[h + s], k.q), k.q);
    }
    __syncthreads();  // buf is rewritten by the next digit
  }
}

void launch_shape(int log_n, dim3* block, size_t* smem) {
  const int n = 1 << log_n;
  *block = dim3(n / 2 < 1024 ? n / 2 : 1024);
  *smem = static_cast<size_t>(n) * sizeof(uint32_t);
}

}  // namespace

extern "C" {

const char* zq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel A. Returns a cudaError_t (0 on success).
int tensor_intt(const void* ct_a, const void* ct_b, void* c0, void* c1, void* c2c,
                const void* limbs, const void* inv_tw, const void* slot_ct, int bt, int L,
                int log_n, void* stream) {
  dim3 block;
  size_t smem;
  launch_shape(log_n, &block, &smem);
  cudaError_t e = cudaFuncSetAttribute(tensor_intt_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  tensor_intt_kernel<<<dim3(L, bt), block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ct_a), static_cast<const uint32_t*>(ct_b),
      static_cast<uint32_t*>(c0), static_cast<uint32_t*>(c1), static_cast<uint32_t*>(c2c),
      static_cast<const uint32_t*>(limbs), static_cast<const uint32_t*>(inv_tw),
      static_cast<const int32_t*>(slot_ct), L, log_n);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B (Shoup hint pairs). Returns a cudaError_t (0 on success).
int digit_relin(const void* c2c, const void* c0, const void* c1, const void* hb,
                const void* hbs, const void* ha, const void* has, void* out,
                const void* limbs, const void* fwd_tw, const void* slot_ct, int bt, int L,
                int log_n, void* stream) {
  dim3 block;
  size_t smem;
  launch_shape(log_n, &block, &smem);
  cudaError_t e = cudaFuncSetAttribute(digit_relin_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  digit_relin_kernel<<<dim3(L, bt), block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(c2c), static_cast<const uint32_t*>(c0),
      static_cast<const uint32_t*>(c1), static_cast<const uint32_t*>(hb),
      static_cast<const uint32_t*>(hbs), static_cast<const uint32_t*>(ha),
      static_cast<const uint32_t*>(has), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(limbs), static_cast<const uint32_t*>(fwd_tw),
      static_cast<const int32_t*>(slot_ct), L, log_n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
