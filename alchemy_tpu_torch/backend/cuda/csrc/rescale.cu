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
// backend/ntt2.py; slot_own and slot_own4 for 5/6/8/9, slot_inv for 7):
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
// load (kernel 7 its whole prologue, computed by both blocks for the whole
// row), the inverse ones finish them across a cluster through distributed
// shared memory. Each block reads and writes its words once (kernel 7 reads
// its inputs twice, the second time from L2).
//
// Kernels 5, 6, 8 and 9 (redesigned for Hopper). Run as one radix-2 stage a
// barrier, twiddles read 4 bytes at a time, and slot-order stores and
// gathers by radix-2 index (a warp's words 8 or more words apart in the
// 2-factor order), they ran at 6-15% of their bound. They now run the
// register-blocked passes of zq.cuh (B's forward ntt_forward_passes, and its
// Gentleman-Sande mirror ntt_inverse_passes): 3 or 4 stages in registers
// between barriers, twiddles 16 bytes at a time; and they write (6/8) or
// gather (5/9) each block's slots in slot order through slot_own, four
// consecutive slots a thread in one 16-byte access. Large grids ([2*Bt, L,
// n]) are then bound by the passes' issue and shared-memory traffic; small
// ones ([1, L, n]: 2L blocks on the H100's 132 SMs) by one block's latency, so
// where a grid fits one wave a limb goes over four blocks (a quarter each, the two
// cross-quarter stages in the forward load and across a cluster of four in
// the inverse). The launch shape is chosen per ring size and grid size
// (GridShape, launch_grid); PERF.md has the measurements.
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "zq.cuh"

namespace {

using zq::kLimbWords;

// Launch shape of kernels 5, 6, 8 and 9: threads a block and the blocks an
// SM it is built for (shared memory allowing: n/2 + n/64 words a block, 66 KB
// at n = 2^15, 132 KB at 2^16), so registers a thread; kMaxRL, the stages of
// a pass (R = 2^kMaxRL words a thread).
template <int kThreads_, int kBlocks_, int kMaxRL_>
struct GridShape {
  static constexpr int kThreads = kThreads_, kBlocks = kBlocks_, kMaxRL = kMaxRL_;
};

// Each the fastest without spills of the shapes measured on the H100
// (PERF.md): one 1024-thread block an SM (64 registers, passes of 4 stages)
// at n = 2^16, where a block's half takes 132 KB, and for grids of at most
// one such wave at n <= 2^15; two 512-thread blocks an SM (64 registers,
// passes of 4) for larger grids at n <= 2^15; with a limb over four blocks,
// 1024 threads with passes of 3 stages at n <= 2^15 (a quarter of 2^13
// words: one group of 8 a thread), else GridOne.
using GridOne = GridShape<1024, 1, 4>;
using GridTwo = GridShape<512, 2, 4>;
using GridFour = GridShape<1024, 1, 3>;

// Block `part`'s slots in slot order, own[e] = s | x << 16 (e < n/2, or
// n/4 for a quarter; x the radix-2 index in its part: kernel_tables'
// slot_own, slot_own4), walked as B's hint loop walks them: thread t takes
// the four elements e = 4*(t + c*blockDim.x) + 0..3, with vec four
// consecutive slots from a 16-byte boundary of the row, one 16-byte access
// (each part owns whole rows of the slot order), else word accesses:
// word(s, x) for each slot, or quad(s, x[4]) for the slots s .. s + 3.
template <typename Word, typename Quad>
__device__ __forceinline__ void walk_slots(const uint32_t* __restrict__ own, int words, bool vec,
                                           Word word, Quad quad) {
  vec = vec && words >= 4;
  for (int e = 4 * threadIdx.x; e < words; e += 4 * blockDim.x) {
    if (vec) {
      const uint4 o = __ldg(reinterpret_cast<const uint4*>(own + e));
      const int x[4] = {static_cast<int>(o.x >> 16), static_cast<int>(o.y >> 16),
                        static_cast<int>(o.z >> 16), static_cast<int>(o.w >> 16)};
      quad(static_cast<int>(o.x & 0xFFFFu), x);
    } else {
      for (int u = 0; u < 4 && e + u < words; ++u) {
        const uint32_t o = __ldg(own + e + u);
        word(static_cast<int>(o & 0xFFFFu), static_cast<int>(o >> 16));
      }
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The slot tables of the grid kernels, [2n]: slot_own (halves), then
// slot_own4 (quarters); block part of a limb split over 2^kSplit blocks owns
// the n/2^kSplit entries from own_of<kSplit>(table, part, n).
template <int kSplit>
__device__ __forceinline__ const uint32_t* own_of(const uint32_t* table, int part, int n) {
  return table + (kSplit - 1) * n + part * (n >> kSplit);
}

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
    zq::inverse_last_stage<true>(buf, out + row, log_n, part, tw, tw + n, k);
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

// The card's SMs, read once (a process is taken to use one model of card).
int sm_count() {
  static const int sms = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      cudaGetLastError();
      return 0;  // then every grid takes halves in GridTwo
    }
    return count;
  }();
  return sms;
}

// The clusters of four blocks of `kernel` the card runs at once, at n =
// 2^log_n: a cluster needs four SMs of one GPC, so this is fewer than a
// quarter of the SMs (measured on the H100: [2, 16, n], 32 clusters, took
// two waves, PERF.md). Read once per ring size; 0 if the query fails.
template <typename Kernel>
int quarter_clusters(Kernel kernel, int threads, int log_n) {
  static int count[17];
  static std::once_flag once[17];
  std::call_once(once[log_n], [&] {
    const size_t smem = zq::padded_words(1 << (log_n - 2)) * sizeof(uint32_t);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 4;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(4);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&count[log_n], kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();
      count[log_n] = 0;
    }
  });
  return count[log_n];
}

// The launch of kernels 5, 6, 8 and 9 on [G, T, n] (n >= 2^10 for
// quarters): a limb over four blocks (GridFour at n <= 2^15, GridOne at
// 2^16) where the grid still fits one wave, so that small grids ([1, L, n]:
// 2L blocks of halves) spread over more SMs: one block an SM for the
// forward kernels, and for the inverse ones no more clusters of four than
// the card runs at once. Else over two, GridOne at n = 2^16 and for at most
// one wave, GridTwo beyond.
template <typename Kernel>
int launch_grid(Kernel one, Kernel two, Kernel four15, Kernel four16, bool cluster, const void* x,
                void* out, const void* limbs, const void* tw, const void* slot_own, int G, int T,
                int log_n, void* stream) {
  const int sms = sm_count();
  const Kernel four = log_n > 15 ? four16 : four15;
  const int four_threads = log_n > 15 ? GridOne::kThreads : GridFour::kThreads;
  const int split = log_n >= 10 && 4 * T * G <= sms &&
                            (!cluster || T * G <= quarter_clusters(four, four_threads, log_n))
                        ? 2
                        : 1;
  Kernel kernel = two;
  int threads = GridTwo::kThreads;
  if (split == 2) {
    kernel = four;
    threads = four_threads;
  } else if (log_n > 15 || 2 * T * G <= sms) {
    kernel = one;
    threads = GridOne::kThreads;
  }
  return zq::launch_blocks(kernel, dim3(T << split, G), threads,
                           zq::padded_words(1 << (log_n - split)),
                           cluster ? 1 << split : 0, stream, static_cast<const uint32_t*>(x),
                           static_cast<uint32_t*>(out), static_cast<const uint32_t*>(limbs),
                           static_cast<const uint32_t*>(tw),
                           static_cast<const uint32_t*>(slot_own), T, log_n);
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
              const void* slot_own, int G, int T, int log_n, void* stream) {
  return launch_grid(intt_grid_kernel<GridOne, 1>, intt_grid_kernel<GridTwo, 1>,
                     intt_grid_kernel<GridFour, 2>, intt_grid_kernel<GridOne, 2>, true, x, out,
                     limbs, inv_tw, slot_own, G, T, log_n, stream);
}

// Kernel 6, and kernel 8 with the 2-factor slot table. Returns a
// cudaError_t (0 on success).
int ntt_grid(const void* x, void* out, const void* limbs, const void* fwd_tw,
             const void* slot_own, int G, int T, int log_n, void* stream) {
  return launch_grid(ntt_grid_kernel<GridOne, 1>, ntt_grid_kernel<GridTwo, 1>,
                     ntt_grid_kernel<GridFour, 2>, ntt_grid_kernel<GridOne, 2>, false, x, out,
                     limbs, fwd_tw, slot_own, G, T, log_n, stream);
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
