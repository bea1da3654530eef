#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (alchemy_tpu_torch) on one GPU.

Builds the CUDA kernels from the sources in the checkout and holds each
against its plain PyTorch version on the card: A (tensor_intt) and B
(digit_relin, Shoup and raw hints) at n = 2^15 in both slot orders, 4
(hybrid_digit_relin, raw and Shoup), 5 (intt_grid), 6 (ntt_grid) and 7
(rescale_fwd) at n = 2^15; 8 (ntt2_grid)
and 9 (intt2_grid), the standalone transforms of the 2-factor slot order
(impl="mxu"), at n = 2^15 and 2^16, with 4 and 7 in that order; A, B, 4, 5,
6 and 7 again at n = 2^16. Every kernel splits a limb over two blocks. Then
it drives six paths through them, each with the launch counters set to 0
just before it:

  [main]    BGV multiply + relinearize with the CRT gadget at the headline
            configuration (n = 2^15, L = 8 limbs of ~30 bits, zp = 2, Shoup
            hint pairs, 16 ciphertexts): keygen, relin_hint, encrypt,
            mul_relin, decrypt, rescale;
  [n2e16]   the same at the top of bench.py's ring sweep, n = 2^16 (L = 8,
            zp = 2, Shoup hints, 16 ciphertexts);
  [hybrid]  hybrid key-switching at the deep configuration (n = 2^15,
            L = 16, dnum = 4, K = 4, raw hints, 16 ciphertexts):
            hybrid_keygen_hint, encrypt, mul_relin_hybrid, decrypt; then
            Shoup hints, and TrivGad mul_relin at the same L for comparison;
  [deep]    the depth-16 squaring chain at n = 2^15 (18 limbs) with hybrid
            key-switching per level, decrypted against the Frobenius chain;
  [mxu]     [main] in the JAX package's default slot order, impl="mxu"
            (kernels A, B, 8, 9), then [deep] in that order (A, 4, 7, 8, 9);
  [hybrid16] [hybrid] at n = 2^16 (L = 16, dnum = 4, K = 4, raw then Shoup
            hints, 16 ciphertexts).

After them, two more phases with no CUDA kernel of their own:

  [she]     HomomRLWR's ciphertext work through the general SHE layer
            (`she/bgv.py`, `she/tunnel.py` on `backend/torch_backend.py`):
            five ring tunnels H0′→…→H5′ with TrivGad at 6 and 5 limbs, then
            at H5′ mul_public, mul, key_switch_quad with TrivGad and
            HybridGad, mod_switch to 2 limbs, mod_switch_pt; every decryption
            against the plaintext on the golden backend. Once on the checked
            backend (each torch op on the card against golden numpy), once on
            the torch backend for host ms and counts by op, and the device
            time of one tunnel and one key switch (CUDA events, profiler).
  [examples] the three shipped examples (Arithmetic, Tunnel, HomomRLWR)
            through the port's DSL and interpreters: `all_main` on the
            checked backend and on the torch backend; each example's
            keygen + pt2ct + encrypt, encrypted evaluation and decrypt timed
            on the torch backend with its counts; the strict error-rate logs
            of Arithmetic and Tunnel equal between the two backends (device
            probe against host probe on every probed ciphertext); one warm
            HomomRLWR evaluation timed (host, CUDA events, profiler).

Then [resume] (after [hybrid16]), and [jit] and [checkpoint] (after
[examples]):

  [resume]  the depth-16 chain of [deep] in the JAX package's test order,
            impl="vpu" (the radix-2 order of `backend/ntt.py`: kernels A, 4,
            7, and 5 and 6 with the vpu tables): a process stops before level
            8, saves its state (`examples/deep_circuit.py` `save_state`) and
            dies by SIGKILL; a fresh process resumes it on the card and
            decrypts the whole chain; then one uninterrupted run, per-level ms.
            Before the paths, [vpu] holds A, B, 4, 7 and the transforms in that
            order against their plain versions (4 and 7 timed at DEEP).
  [jit]     Arithmetic, Tunnel (strict ERW) and HomomRLWR from [examples]
            through `interp/jit_exec.py`, one CUDA graph each: build s,
            replay ms per call (host clock and CUDA events), launches, the
            eager ms beside it; bit-identical to eager evaluation, equal logs,
            no copy in a call, outputs not aliased, a strict overflow raising.
  [checkpoint] HomomRLWR's compiled program saved (`she/serialize.py`),
            loaded in a fresh process on the card, evaluated eagerly and as a
            graph, decrypted against the plaintext; bytes, save and load s.
  [jitmesh] (after [pipeline]) [jit]'s three programs through
            `jit_compile(..., mesh=)` (`parallel/spmd.py`): on [pipeline]'s
            two gloo ranks sharing the card, meshes (1, 2) and (2, 1), eager
            (Tunnel's 1-limb hints and HomomRLWR's 5-limb argument padded on
            (2, 1)), each rank's blocks equal to the blocks of [jit]'s output;
            then on the script's NCCL rank, mesh ('limb' 1, 'coeff' 1), a
            CUDA graph bit-identical to [jit]'s; the gathered results
            decrypt; collectives by (op, axis), bytes per rank against
            single-device, call ms.
  [native]  (after [resume]) the C++ oracle `alchemy_tpu_torch/native`
            (built with g++ under build/native/) against the card in the vpu
            order at n = 2^15, L = 8: `native.mul_relin` against
            `fast.mul_relin(impl="vpu")` (kernels A, B) on two ciphertext
            pairs, `native.ntt`/`intt` against kernels 6/5 on [1, 8, n];
            exact; the oracle's CPU ms beside the card's. Its result joins the
            vpu entries of A, 5 and 6 in the `kernels` line ("oracle").
  [scaling] (with [jitmesh]) `parallel/bench_scaling.sweep` at the JAX
            package's defaults (log_n 12, 4 limbs, batch 2) on the two gloo
            ranks and on the one NCCL rank, its anchors measured on the card;
            one JSON line each before the `kernels` line.

Then the mesh path (`parallel/`; the world's ranks are processes, the
local stages of the distributed NTT are torch ops, no kernel of their own):

  [dist]    one NCCL rank, mesh (1, 1, 1), at the headline width (n = 2^15,
            L = 8, Bt = 16, n1 = 2^7): make_dist_ntt (a2a and ring, round
            trips), make_dist_mul_relin (digit and row hint placements, a2a
            and ring), make_dist_rescale, and make_dist_mul_relin_hybrid at
            L = 16 (dnum = 4, K = 4), each through the layout bridge
            (single-chip inverse NTT, the (j2, j1) storage order, the dist
            forward NTT) bit-identical to fast.mul_relin, fast.rescale and
            hybrid.mul_relin_hybrid, the products decrypted; host ms a call
            and collectives a call by group.
  [dist2]   two gloo ranks sharing the card (NCCL refuses two ranks on one
            GPU): make_dist_mul_relin on [dist]'s inputs with the mesh
            (1, 1, 2), then (1, 2, 1), bit-identical to [dist]; the bytes the
            comm helpers stage through host memory for gloo are printed.
  [pipeline] make_pipeline_chain at n = 2^15, depth 16, L0 = 18, 4
            micro-batches of 2: S = 1 on the one-rank world in the "pallas"
            order (kernels A, B, 5, 6) and in the "mxu" order (A, B, 8, 9),
            S = 2 on two gloo ranks sharing the card ("mxu"); each
            bit-identical to the sequential chain of fast.mul_relin +
            fast.rescale (S = 2 also to S = 1), the last level decrypted.
            Kernel B is checked and timed at the pipeline's shape
            [2, 18, n] in both orders; A and 5/6/8/9 join the by-shape
            reports with the path tags "pipeline" and "pipeline S=2".

The first four run at impl="pallas", the 3-factor slot order. Kernels 5,
6, 8 and 9 then run again, checked and timed, at every [G, T, n] a path
launched them with (rescale.LAUNCHES_BY_SHAPE, read per path) and at
GRID_SHAPES in both orders: one `[grid]` line each with the launches, device
ms and bound by shape. Kernels A (by [Bt, L, n], mul_relin.LAUNCHES_BY_SHAPE)
and 7 (by [G, L, K, n]) follow, at every shape a path launched them with and
at FUSED_SHAPES, both orders, 2^15 and 2^16: one `[fused]` line each.

Every check is exact equality. Any failure exits non-zero; the last line of
a passing run is one JSON object naming the device. The line before the
card's name lists every kernel with its ring size, slot order, launches on
the paths, device and plain ms, and its bound: the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its 32-bit integer multiplies
over 132 SMs x 64 per clock at the card's maximum SM clock. Kernels 5, 6, 8,
9, A and 7 also have one entry per (ring size, slot order, shape) that a path
launched, with `graph_ms`, the device time of the launches captured in a CUDA
graph, `launches_by_path`, each path's own count, and `path`, the path whose
count `launches` is (the one that launched the shape most).

    python3 chip_smoke.py        # from the root of a checkout, one GPU

On a host with four cards, `python3 chip_smoke.py --cards 4` runs only the
mesh checks across them, on four NCCL ranks, one a card: [dist4] ([dist]'s
checks on the mesh (1, 2, 2)), [pipeline4] (the chain with S = 4),
[jitmesh4] (HomomRLWR through `jit_compile(..., mesh=)` on the mesh (2, 2),
one CUDA graph a rank, blocks bit-identical to the single-device graph,
under half its bytes a rank) and [scaling] (the sweep's points on 1, 2
and 4 ranks).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
HEADLINE = (15, 8, 16)            # log2 n, limbs, ciphertexts per batch
SMALL = (14, 4, 4)
N2E16 = (16, 8, 16)               # bench.py's ring sweep at n = 2^16
SMALL_N2E16 = (16, 3, 2)
DEEP = (15, 16, 16)               # hybrid: dnum = 4, K = 4, T = 20
SMALL_HYBRID = (14, 5, 2)         # uneven digit groups (3, 2), K = 3
HYBRID16 = (16, 16, 16)           # hybrid at n = 2^16: dnum = 4, K = 4, T = 20
SMALL_HYBRID16 = (16, 5, 2)
DEEP_DEPTH = 16
# [she]: HomomRLWR's six moduli (alchemy_tpu/examples/homomrlwr.py:37-43), its
# plaintext modulus Z_32 and Gaussian parameter 5.0
SHE_ZQS = (1543651201, 689270401, 718099201, 720720001, 1556755201, 1567238401)
SHE_ZP, SHE_R = 32, 5.0
# [examples]: the seed each example's `run` defaults to
EXAMPLE_SEEDS = {"Arithmetic": 42, "Tunnel": 0, "HomomRLWR": 0}
# (G, T) of the standalone transforms on [G, T, n] at the shapes the paths give
# them. Forward (6/8): keygen, hints and encrypt at L = 8; the hybrid hint over
# T = 20 limbs; the deep chain's rescale of one ciphertext; fast.rescale of a
# Bt = 16 batch. Inverse (5/9): decrypt; the deep chain's rescales; fast.rescale
# of the batch; rescale_joint of the hybrid op at Bt = 16.
GRID_SHAPES = {"forward": ((1, 8), (1, 20), (2, 16), (32, 7)),
               "inverse": ((1, 8), (2, 16), (32, 8), (32, 20))}
# the slot orders of `FastParams.order`: 3-factor, 2-factor, radix-2
ORDERS = ("pallas", "mxu", "vpu")
# [resume]: the depth-16 chain at DEEP's ring stops before this level, dies by
# SIGKILL, and a fresh process finishes it
RESUME_STOP = 8
# [jit]: calls timed per example
JIT_CALLS = 20
# state files of [resume] and [checkpoint], inside the checkout (build/ is git-ignored)
WORK = Path(__file__).resolve().parent / "build" / "chip_smoke"
MUL_RELIN_TPU = "alchemy_tpu/backend/pallas/mul_relin_pallas.py"
RESCALE_TPU = "alchemy_tpu/backend/pallas/rescale_pallas.py"
NTT_TPU = "alchemy_tpu/backend/pallas/ntt_pallas.py"
VPU_NTT = "alchemy_tpu/backend/ntt.py"       # ntt_negacyclic :149, intt_negacyclic :173 (jnp)
MUL_RELIN_CU = "alchemy_tpu_torch/backend/cuda/csrc/mul_relin.cu"
RESCALE_CU = "alchemy_tpu_torch/backend/cuda/csrc/rescale.cu"
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
SMS, IMUL_PER_SM_CLOCK = 132, 64  # 32-bit integer multiplies per SM and clock, cc 9.0
# The fewest 32-bit multiplies each modular operation needs, whatever the
# kernels' own instructions: a product of two variable residues (the low and
# high words of the product, the quotient estimate, the estimate times q), a
# product by a constant with its Shoup companion, a reduction of any uint32
# (the quotient estimate and the estimate times q).
MUL_VAR, MUL_CONST, REDUCE = 4, 3, 2


def ntt_muls(n: int) -> int:
    """32-bit multiplies of one radix-2 NTT: one product by a constant twiddle
    a butterfly."""
    return MUL_CONST * (n // 2) * (n.bit_length() - 1)


def tensor_cost(Bt: int, L: int, n: int) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of kernel A on [Bt, L, n]: four rows in,
    three out, twiddles and companions, the slot table; per word three
    products of the tensor, the inverse NTT and its scale by n^-1."""
    return (4 * (7 * Bt * L * n + 2 * L * n + n),
            Bt * L * ((3 * MUL_VAR + MUL_CONST) * n + ntt_muls(n)))


def rescale_cost(G: int, L: int, K: int, n: int) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of kernel 7 on [G, L, n] with K dropped
    limbs: the L coefficient rows, the K Garner digit rows and the three
    sign rows in, L rows out, twiddles, the slot table and the constants;
    per word K + 2 Shoup products and the forward NTT."""
    return (4 * (G * (2 * L + K + 3) * n + 2 * L * n + n + L * (4 + 2 * K)),
            G * L * (MUL_CONST * (K + 2) * n + ntt_muls(n)))


def bound(nbytes: float, muls: float, clock_hz: float) -> tuple[float, str]:
    """(the least ms the card could take, what sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, muls / (SMS * IMUL_PER_SM_CLOCK * clock_hz)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def device_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over reps launches (after one warm-up)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over reps launches captured in one
    CUDA graph and replayed (after one warm-up call and one replay): the
    kernels back to back, without the host's time between launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item())


def reset_launches() -> None:
    from alchemy_tpu_torch.backend.cuda import mul_relin as mr
    from alchemy_tpu_torch.backend.cuda import rescale as rk

    mr.reset_launches()
    rk.reset_launches()


def launches() -> dict:
    from alchemy_tpu_torch.backend.cuda import mul_relin as mr
    from alchemy_tpu_torch.backend.cuda import rescale as rk

    return {**mr.LAUNCHES, **rk.LAUNCHES}


def shape_launches() -> dict:
    """Launches by shape since the reset: kernels 5, 6, 8, 9 by (name, G, T,
    n), A by ("tensor_intt", Bt, L, n), 7 by ("rescale_fwd", G, L, K, n)."""
    from alchemy_tpu_torch.backend.cuda import mul_relin as mr
    from alchemy_tpu_torch.backend.cuda import rescale as rk

    return {**mr.LAUNCHES_BY_SHAPE, **rk.LAUNCHES_BY_SHAPE}


def host_ms(fn):
    """(fn(), its host-clock ms ended by a synchronize)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rate(step, Bt: int, iters: int) -> tuple[float, float]:
    """(host-clock ops/s, device µs per ciphertext) of step() on Bt ciphertexts."""
    import torch

    dev_ms = device_ms(step, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    return Bt * iters / (time.perf_counter() - t0), dev_ms / Bt * 1000


def negacyclic_mod2(m1, m2):
    import numpy as np
    from scipy.signal import fftconvolve

    n = len(m1)
    c = np.rint(fftconvolve(m1.astype(np.float64), m2.astype(np.float64))).astype(np.int64)
    return (c[:n] - np.concatenate([c[n:], [0]])) % 2


def random_residues(rng, qs, shape):
    import numpy as np
    import torch

    q = np.array(qs, dtype=np.int64)[:, None]
    return torch.from_numpy((rng.integers(0, 1 << 62, shape) % q).astype(np.int32))


def kernel_phase(log_n: int, L: int, Bt: int, rng, timed: bool, order: str = "pallas") -> dict:
    """Kernels A and B against their plain versions on random canonical
    inputs at one shape and slot order; returns, per kernel, the error,
    device times and the bytes and multiplies of its bound."""
    import torch

    from alchemy_tpu_torch.backend.cuda import mul_relin as mr
    from alchemy_tpu_torch.she import fast

    p = fast.FastParams.make(log_n, L)
    n, qs = p.n, p.qs
    ct_a = random_residues(rng, qs, (Bt, 2, L, n)).cuda()
    ct_b = random_residues(rng, qs, (Bt, 2, L, n)).cuda()
    hints = [fast.shoup_precompute(random_residues(rng, qs, (L, L, n)).cuda(), qs)
             for _ in range(2)]
    ka = mr.tensor_intt(n, qs, ct_a, ct_b, order)
    torch.cuda.synchronize()
    pa = mr.tensor_intt_plain(n, qs, ct_a, ct_b, order)
    torch.cuda.synchronize()
    err_a = max(max_abs_err(x, y) for x, y in zip(ka, pa))
    check(err_a == 0, f"kernel A != plain at n=2^{log_n} L={L} Bt={Bt} (max abs err {err_a})")
    kb = mr.digit_relin(n, qs, *ka, *hints, order)
    torch.cuda.synchronize()
    pb = mr.digit_relin_plain(n, qs, *ka, *hints, order)
    torch.cuda.synchronize()
    raw = [h[0] for h in hints]
    kr = mr.digit_relin(n, qs, *ka, *raw, order)
    torch.cuda.synchronize()
    err_b = max(max_abs_err(kb, pb),
                max_abs_err(kr, mr.digit_relin_plain(n, qs, *ka, *raw, order)))
    check(err_b == 0, f"kernel B != plain at n=2^{log_n} L={L} Bt={Bt} (max abs err {err_b})")
    tables = 4 * (2 * L * n + n)              # twiddles and companions, slot map
    a_bytes, a_muls = tensor_cost(Bt, L, n)
    res = {
        "tensor_intt": {"err": err_a, "bytes": a_bytes, "muls": a_muls},
        "digit_relin": {"err": err_b},
        "digit_relin_raw": {"err": err_b},
    }
    # per (ciphertext, limb, digit): the digit's reduction, its NTT, two hint products
    for name, hint_words, hint_mul in (("digit_relin", 4, MUL_CONST),
                                       ("digit_relin_raw", 2, MUL_VAR)):
        res[name].update(bytes=4 * (5 * Bt * L * n + hint_words * L * L * n) + tables,
                         muls=Bt * L * L * ((REDUCE + 2 * hint_mul) * n + ntt_muls(n)))
    if timed:
        a_args, b_args, r_args = (n, qs, ct_a, ct_b, order), (n, qs, *ka, *hints, order), \
            (n, qs, *ka, *raw, order)
        res["tensor_intt"].update(ms=device_ms(lambda: mr.tensor_intt(*a_args), 20),
                                  plain_ms=device_ms(lambda: mr.tensor_intt_plain(*a_args), 3))
        res["digit_relin"].update(ms=device_ms(lambda: mr.digit_relin(*b_args), 20),
                                  plain_ms=device_ms(lambda: mr.digit_relin_plain(*b_args), 3))
        res["digit_relin_raw"].update(ms=device_ms(lambda: mr.digit_relin(*r_args), 20),
                                      plain_ms=device_ms(lambda: mr.digit_relin_plain(*r_args), 3))
    print(f"[kernels] n=2^{log_n} L={L} Bt={Bt} order={order}: A and B (Shoup and raw hints) "
          "bit-identical to plain " + fmt(res), flush=True)
    return res


def fmt(res: dict) -> str:
    return " ".join(f"{k}:" + ",".join(f"{a}={b:.4f}" if isinstance(b, float) else f"{a}={b}"
                                       for a, b in v.items()) for k, v in res.items())


def grid_names(order: str) -> tuple[str, str]:
    """Launch counters of the (inverse, forward) standalone transforms of a
    slot order: kernels 5 and 6, 9 and 8, or 5 and 6 with the vpu tables."""
    return {"mxu": ("intt2_grid", "ntt2_grid"), "vpu": ("intt_vpu_grid", "ntt_vpu_grid"),
            "pallas": ("intt_grid", "ntt_grid")}[order]


def grid_kernel_phase(log_n: int, L: int, Bt: int, rng, order: str = "pallas") -> dict:
    """The standalone transforms of a slot order (kernels 5 and 6, or 9 and
    8) against their plain versions on any uint32 rows at every shape the
    TrivGad path gives them: the inverse on [2·Bt, L, n] (the rescale of a
    batch) and [1, L, n] (decrypt), the forward on [2·Bt, L − 1, n] over the
    first L − 1 limbs (the rescale) and [1, L, n] (keygen, hints, encrypt).
    Returns each kernel's largest error (grid_report times them)."""
    import torch

    from alchemy_tpu_torch.backend.cuda import rescale as rk
    from alchemy_tpu_torch.she import fast

    p = fast.FastParams.make(log_n, L)
    n, qs = p.n, p.qs
    u32 = lambda shape: torch.from_numpy(rng.integers(0, 1 << 32, shape, dtype="uint64")
                                         .astype("uint32").view("int32")).cuda()
    (fwd, inv), (fwd_plain, inv_plain) = rk.grid_transforms(order), rk.grid_transforms(order, True)
    inv_name, fwd_name = grid_names(order)
    # name: (kernel, plain, [(rows, limbs), ...])
    calls = {inv_name: (inv, inv_plain, [(2 * Bt, qs), (1, qs)]),
             fwd_name: (fwd, fwd_plain, [(2 * Bt, qs[:-1]), (1, qs)])}
    res = {}
    for name, (kern, plain, shapes) in calls.items():
        errs = []
        for G, limbs in shapes:
            x = u32((G, len(limbs), n))
            got = kern(n, limbs, x)
            torch.cuda.synchronize()
            errs.append(max_abs_err(got, plain(n, limbs, x)))
            check(errs[-1] == 0, f"{name} != plain at n=2^{log_n} on [{G}, {len(limbs)}, n] "
                                 f"(max abs err {errs[-1]})")
        res[name] = {"err": max(errs)}
    print(f"[kernels] n=2^{log_n} L={L} order={order}: {inv_name} on [{2 * Bt}, {L}, n] and "
          f"[1, {L}, n], {fwd_name} on [{2 * Bt}, {L - 1}, n] and [1, {L}, n] bit-identical to "
          "plain " + fmt(res), flush=True)
    return res


def grid_cost(inverse: bool, G: int, T: int, n: int) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of a standalone transform on [G, T, n]:
    rows in and out, twiddles and companions, the slot table; per word its
    reduction (and the inverse's scale by n^-1), and the NTT."""
    return (4 * (2 * G * T * n + 2 * T * n + n),
            G * T * ((REDUCE + (MUL_CONST if inverse else 0)) * n + ntt_muls(n)))


def grid_shape_phase(log_n: int, order: str, shapes, rng, reps: int = 20) -> dict:
    """The standalone transforms of a slot order (kernels 5 and 6, or 9 and
    8) against their plain versions on any uint32 rows at each (name, G, T)
    of shapes, over the first T limbs of one chain; with reps > 0 each is
    timed, launched one by one (ms) and from a CUDA graph (graph_ms), and so
    is its plain version (plain_ms). Returns {(name, G, T): {"err", "bytes",
    "muls"[, "ms", "graph_ms", "plain_ms"]}}."""
    import torch

    from alchemy_tpu_torch.backend.cuda import rescale as rk
    from alchemy_tpu_torch.she import fast

    n = 1 << log_n
    qs = fast.FastParams.make(log_n, max(T for _, _, T in shapes)).qs
    inv_name = grid_names(order)[0]
    (fwd, inv), (fwd_plain, inv_plain) = rk.grid_transforms(order), rk.grid_transforms(order, True)
    res = {}
    for name, G, T in sorted(shapes):
        kern, plain = (inv, inv_plain) if name == inv_name else (fwd, fwd_plain)
        x = torch.from_numpy(rng.integers(0, 1 << 32, (G, T, n), dtype="uint64")
                             .astype("uint32").view("int32")).cuda()
        got = kern(n, qs[:T], x)
        torch.cuda.synchronize()
        err = max_abs_err(got, plain(n, qs[:T], x))
        check(err == 0, f"{name} != plain at n=2^{log_n} on [{G}, {T}, n] (max abs err {err})")
        nbytes, muls = grid_cost(name == inv_name, G, T, n)
        r = res[name, G, T] = {"err": err, "bytes": nbytes, "muls": muls}
        if reps:
            r["ms"] = device_ms(lambda: kern(n, qs[:T], x), reps)
            r["graph_ms"] = graph_ms(lambda: kern(n, qs[:T], x), reps)
            r["plain_ms"] = device_ms(lambda: plain(n, qs[:T], x), 3)
        del x, got
    return res


def representative_shapes(order: str) -> set:
    """(name, G, T) of GRID_SHAPES in a slot order's kernel names."""
    inv_name, fwd_name = grid_names(order)
    return {(name, G, T) for name, key in ((inv_name, "inverse"), (fwd_name, "forward"))
            for G, T in GRID_SHAPES[key]}


def hybrid_kernel_phase(log_n: int, L: int, Bt: int, rng, timed: bool,
                        order: str = "pallas") -> dict:
    """Kernels 4 (raw and Shoup hints) and 7 in a slot order, and that
    order's standalone transforms (5 and 6, or 9 and 8), against their plain
    versions on the card at the shapes of the hybrid path; returns the
    errors, and with timed the device times of 4 and 7 (grid_report times
    the transforms)."""
    import torch

    from alchemy_tpu_torch.backend.cuda import mul_relin as mr
    from alchemy_tpu_torch.backend.cuda import rescale as rk
    from alchemy_tpu_torch.backend.modarith import garner_digits, narrow, widen
    from alchemy_tpu_torch.she import fast, hybrid

    hk = hybrid.HybridKS.make(fast.FastParams.make(log_n, L))
    pe, n, K = hk.pe, 1 << log_n, len(hk.ps)
    T, keep, drop = len(pe.qs), hk.p.qs, hk.ps
    x = hybrid.garner_pack(hk, random_residues(rng, hk.p.qs, (Bt, L, n)).cuda())
    raw = [random_residues(rng, pe.qs, (hk.dnum, T, n)).cuda() for _ in range(2)]
    shoup = [fast.shoup_precompute(h, pe.qs) for h in raw]
    # kernel 5 on any uint32, kernel 6 at the chain's rescale shape [2, L, n]
    rows5 = torch.from_numpy(rng.integers(0, 1 << 32, (2 * Bt, T, n), dtype="uint64")
                             .astype("uint32").view("int32")).cuda()
    rows6 = torch.from_numpy(rng.integers(0, 1 << 32, (2, L, n), dtype="uint64")
                             .astype("uint32").view("int32")).cuda()
    # kernel 7 inputs as rescale_joint makes them from canonical coefficients
    coeff = random_residues(rng, pe.qs, (2 * Bt, T, n)).cuda()
    xs = garner_digits(widen(coeff[:, L:]), drop)
    is_neg, t, t_neg = hybrid._sign_terms(xs, drop, pe.zp)
    args7 = (n, keep, drop, pe.zp, coeff, narrow(torch.stack(xs, dim=1)),
             is_neg.to(torch.int32), narrow(t), t_neg.to(torch.int32), order)
    ntt = ntt_muls(n)
    (fwd, inv), (fwd_plain, inv_plain) = rk.grid_transforms(order), rk.grid_transforms(order, True)
    inv_name, fwd_name = grid_names(order)
    groups = hk.groups

    def k4_cost(hint_words, hint_mul):
        return (4 * (Bt * L * n + 2 * T * L + hint_words * hk.dnum * T * n + 2 * T * n + n
                     + 2 * Bt * T * n),
                Bt * T * (MUL_CONST * L * n + hk.dnum * (ntt + 2 * hint_mul * n)))

    G7 = 2 * Bt
    calls = {
        "hybrid_digit_relin": (lambda: mr.hybrid_digit_stage(n, pe.qs, groups, x, *raw, order),
                               lambda: mr.hybrid_digit_stage_plain(n, pe.qs, groups, x, *raw,
                                                                   order),
                               k4_cost(2, MUL_VAR)),
        "hybrid_digit_relin_shoup": (
            lambda: mr.hybrid_digit_stage(n, pe.qs, groups, x, *shoup, order),
            lambda: mr.hybrid_digit_stage_plain(n, pe.qs, groups, x, *shoup, order),
            k4_cost(4, MUL_CONST)),
        inv_name: (lambda: inv(n, pe.qs, rows5), lambda: inv_plain(n, pe.qs, rows5), None),
        fwd_name: (lambda: fwd(n, keep, rows6), lambda: fwd_plain(n, keep, rows6), None),
        "rescale_fwd": (lambda: rk.rescale_fwd(*args7), lambda: rk.rescale_fwd_plain(*args7),
                        rescale_cost(G7, L, K, n)),
    }
    res = {}
    for name, (kern, plain, cost) in calls.items():
        got = kern()
        torch.cuda.synchronize()
        err = max_abs_err(got, plain())
        check(err == 0, f"{name} != plain at n=2^{log_n} L={L} Bt={Bt} (max abs err {err})")
        res[name] = {"err": err}
        if timed and cost:
            res[name].update(bytes=cost[0], muls=cost[1], ms=device_ms(kern, 20),
                             plain_ms=device_ms(plain, 3))
    print(f"[kernels] n=2^{log_n} L={L} dnum={hk.dnum} K={K} T={T} Bt={Bt} order={order}: "
          f"kernels 4 (raw, Shoup), {inv_name}, {fwd_name}, 7 bit-identical to plain " + fmt(res),
          flush=True)
    return res


def main_path(rng, card: str, config: tuple[int, int, int], tag: str, impl: str) -> dict:
    """The port's main path, TrivGad multiply + relinearize with Shoup hints,
    at one configuration (log2 n, L, Bt) and slot order: keygen, relin_hint,
    encrypt, mul_relin, decrypt, rescale, with the launch counters set to 0
    before keygen and read after the rescale."""
    from dataclasses import replace

    import numpy as np
    import torch

    from alchemy_tpu_torch.backend.cuda import mul_relin as mr
    from alchemy_tpu_torch.she import fast

    log_n, L, Bt = config
    p = fast.FastParams.make(log_n, L, zp=2, impl=impl)
    setup = {}
    reset_launches()
    s, setup["keygen"] = host_ms(lambda: fast.keygen(p, rng, device="cuda"))
    (hb, ha), setup["relin_hint"] = host_ms(lambda: fast.relin_hint(p, s, rng, shoup=True))
    m1 = rng.integers(0, p.zp, (Bt, p.n))
    m2 = rng.integers(0, p.zp, (Bt, p.n))
    cts, ms = host_ms(lambda: [fast.encrypt(p, s, m, rng) for m in [*m1, *m2]])
    setup["encrypt_per_ct"] = ms / (2 * Bt)
    ct_a, ct_b = torch.stack(cts[:Bt]), torch.stack(cts[Bt:])
    print(f"[setup] n=2^{log_n} L={L} host ms: "
          + " ".join(f"{k}={v:.3f}" for k, v in setup.items()), flush=True)

    out = fast.mul_relin(p, ct_a, ct_b, hb, ha)
    torch.cuda.synchronize()
    check(tuple(out.shape) == (Bt, 2, L, p.n), f"mul_relin shape {tuple(out.shape)}")
    ref = mr.digit_relin_plain(p.n, p.qs, *mr.tensor_intt_plain(p.n, p.qs, ct_a, ct_b, impl),
                               hb, ha, impl)
    check(torch.equal(out, ref), "mul_relin through the kernels != plain path")
    print(f"[{tag}] mul_relin n=2^{log_n} L={L} Bt={Bt} impl={impl}: bit-identical to the plain "
          "path", flush=True)

    want = [negacyclic_mod2(a, b) for a, b in zip(m1, m2)]
    dec, dec_ms = host_ms(lambda: [fast.decrypt(p, s, out[i]) for i in range(Bt)])
    dec_ms /= Bt
    for i in range(Bt):
        check(np.array_equal(dec[i], want[i]), f"decrypt of product {i}")
    down, resc_first_ms = host_ms(lambda: fast.rescale(p, out, 1))
    p7 = replace(p, qs=p.qs[:-1])
    for i in range(Bt):
        check(np.array_equal(fast.decrypt(p7, s[:-1], down[i]), want[i]),
              f"decrypt of rescaled product {i}")
    torch.cuda.synchronize()
    seen, by_shape = launches(), shape_launches()
    inv_name, fwd_name = grid_names(impl)
    check(all(seen[k] > 0 for k in ("tensor_intt", "digit_relin", inv_name, fwd_name))
          and sum(seen[k] for order in ORDERS for k in grid_names(order)) ==
          seen[inv_name] + seen[fwd_name], f"kernel launches on the {tag} path: {seen}")
    # the first call also pays the caching allocator's cudaMalloc of its int64 temporaries
    _, resc_ms = host_ms(lambda: fast.rescale(p, out, 1))
    print(f"[{tag}] {Bt} products decrypt to the negacyclic products mod 2; "
          f"rescale to L={L - 1} decrypts the same; host ms: decrypt_per_ct={dec_ms:.3f} "
          f"rescale_{Bt}ct={resc_ms:.3f} (first call {resc_first_ms:.3f}); launches {seen}",
          flush=True)

    ops, us = rate(lambda: fast.mul_relin(p, ct_a, ct_b, hb, ha), Bt, 50)
    print(f"[perf] mul_relin n=2^{log_n} L={L} Bt={Bt} impl={impl}: {ops:.1f} ops/s (host clock), "
          f"device {us:.2f} us/ct ({us * Bt / 1000:.4f} ms/batch) on {card}", flush=True)
    return {"launches": seen, "by_shape": by_shape, "ops_per_s": ops, "device_us_per_ct": us}


def hybrid_path(rng, card: str, config: tuple[int, int, int], tag: str, trivgad: bool) -> dict:
    """Hybrid key-switching at one configuration (log2 n, L, Bt), slot order
    "pallas": raw hints (as bench.py runs it) then Shoup pairs, and with
    trivgad, TrivGad at the same L."""
    import numpy as np
    import torch

    from alchemy_tpu_torch.backend.cuda import mul_relin as mr
    from alchemy_tpu_torch.she import fast, hybrid

    log_n, L, Bt = config
    hk = hybrid.HybridKS.make(fast.FastParams.make(log_n, L, zp=2, impl="pallas"))
    p, pe = hk.p, hk.pe
    setup = {}
    (s, (hb, ha)), setup["hybrid_keygen_hint"] = host_ms(
        lambda: hybrid.hybrid_keygen_hint(hk, rng, device="cuda"))
    m1 = rng.integers(0, p.zp, (Bt, p.n))
    m2 = rng.integers(0, p.zp, (Bt, p.n))
    cts, ms = host_ms(lambda: [fast.encrypt(p, s, m, rng) for m in [*m1, *m2]])
    setup["encrypt_per_ct"] = ms / (2 * Bt)
    ct_a, ct_b = torch.stack(cts[:Bt]), torch.stack(cts[Bt:])
    print(f"[setup] n=2^{log_n} L={L} dnum={hk.dnum} K={len(hk.ps)} host ms: "
          + " ".join(f"{k}={v:.3f}" for k, v in setup.items()), flush=True)

    reset_launches()
    out = hybrid.mul_relin_hybrid(hk, ct_a, ct_b, hb, ha)
    torch.cuda.synchronize()
    seen, by_shape = launches(), shape_launches()
    check(all(seen[k] > 0 for k in ("tensor_intt", "hybrid_digit_relin", "intt_grid",
                                    "rescale_fwd")), f"kernel launches on the hybrid path: {seen}")
    check(tuple(out.shape) == (Bt, 2, L, p.n), f"mul_relin_hybrid shape {tuple(out.shape)}")
    check(torch.equal(out, hybrid.mul_relin_hybrid_plain(hk, ct_a, ct_b, hb, ha)),
          "mul_relin_hybrid through the kernels != plain path (raw hints)")
    want = [negacyclic_mod2(a, b) for a, b in zip(m1, m2)]
    for i in range(Bt):
        check(np.array_equal(fast.decrypt(p, s, out[i]), want[i]), f"decrypt of hybrid product {i}")
    hs = [fast.shoup_precompute(h, pe.qs) for h in (hb, ha)]
    out_s = hybrid.mul_relin_hybrid(hk, ct_a, ct_b, *hs)
    check(torch.equal(out_s, out), "mul_relin_hybrid with Shoup hints != raw hints")
    check(torch.equal(out_s, hybrid.mul_relin_hybrid_plain(hk, ct_a, ct_b, *hs)),
          "mul_relin_hybrid through the kernels != plain path (Shoup hints)")
    print(f"[{tag}] mul_relin_hybrid n=2^{log_n} L={L} Bt={Bt}: launches {seen}, bit-identical "
          f"to the plain path (raw and Shoup hints); {Bt} products decrypt to the negacyclic "
          "products mod 2", flush=True)

    res = {"launches": seen, "by_shape": by_shape}
    for name, hints in (("raw", (hb, ha)), ("shoup", hs)):
        res[name] = rate(lambda: hybrid.mul_relin_hybrid(hk, ct_a, ct_b, *hints), Bt, 20)
    # where the device time of one raw-hint call goes
    c = mr.tensor_intt(p.n, p.qs, ct_a, ct_b)
    x = hybrid.garner_pack(hk, c[2])
    t01 = mr.hybrid_digit_stage(p.n, pe.qs, hk.groups, x, hb, ha)
    stages = {
        "tensor_intt": device_ms(lambda: mr.tensor_intt(p.n, p.qs, ct_a, ct_b), 10),
        "garner_pack": device_ms(lambda: hybrid.garner_pack(hk, c[2]), 10),
        "hybrid_digit_relin": device_ms(
            lambda: mr.hybrid_digit_stage(p.n, pe.qs, hk.groups, x, hb, ha), 10),
        "rescale_joint": device_ms(lambda: hybrid.rescale_joint(pe, t01, len(hk.ps)), 10),
    }
    hint_note = ""
    if trivgad:
        (tb, ta), hint_ms = host_ms(lambda: fast.relin_hint(p, s, rng, shoup=True))
        product = fast.mul_relin(p, ct_a, ct_b, tb, ta)
        check(np.array_equal(fast.decrypt(p, s, product[0]), want[0]), "decrypt of TrivGad product")
        res["trivgad"] = rate(lambda: fast.mul_relin(p, ct_a, ct_b, tb, ta), Bt, 20)
        hint_note = f"; TrivGad relin_hint at L={L}: {hint_ms:.1f} ms host"
    for name in ("raw", "shoup", "trivgad")[:3 if trivgad else 2]:
        ops, us = res[name]
        print(f"[perf] {'mul_relin_hybrid ' + name if name != 'trivgad' else 'mul_relin TrivGad'}"
              f" n=2^{log_n} L={L} Bt={Bt}: {ops:.1f} ops/s (host clock), device {us:.2f} us/ct"
              f" on {card}", flush=True)
    print(f"[perf] {tag} raw-hint call n=2^{log_n}, device ms by stage: "
          + " ".join(f"{k}={v:.4f}" for k, v in stages.items()) + hint_note, flush=True)
    return res


def deep_path(card: str, tag: str, impl: str) -> dict:
    """The depth-16 squaring chain at n = 2^15 (18 limbs) with hybrid
    key-switching, in slot order impl."""
    from alchemy_tpu_torch.examples.deep_circuit import run

    reset_launches()
    t0 = time.perf_counter()
    ok, ct, level_ms = run(log_n=DEEP[0], depth=DEEP_DEPTH, impl=impl, ks="hybrid",
                           device="cuda", verbose=False)
    wall = time.perf_counter() - t0
    seen, by_shape = launches(), shape_launches()
    inv_name, fwd_name = grid_names(impl)
    check(ok, f"deep circuit impl={impl}: decrypt != the squaring chain")
    check(all(seen[k] > 0 for k in ("tensor_intt", "hybrid_digit_relin", inv_name, fwd_name,
                                    "rescale_fwd")),
          f"kernel launches on the deep circuit: {seen}")
    print(f"[{tag}] deep circuit n=2^{DEEP[0]} depth={DEEP_DEPTH} hybrid impl={impl}: PASS in "
          f"{wall:.2f} s (host clock) on {card}; launches {seen}", flush=True)
    print(f"[{tag}] per-level ms (hint + mul_relin_hybrid + rescale): "
          + " ".join(f"{v:.1f}" for v in level_ms), flush=True)
    return {"launches": seen, "by_shape": by_shape, "level_ms": level_ms, "wall_s": wall}


def she_run(bk) -> dict:
    """HomomRLWR's ciphertext work through the port's general SHE layer on
    backend bk: keys with variance 5.0/√φ(m′) per ring, a Z_32 plaintext of
    R_{H0} encrypted at H0′ under SHE_ZQS, the five tunnels of `switch5`
    along H0′→…→H5′ (the `dec_to_crt` maps, TrivGad; four at 6 limbs, the
    fifth at 5 after a `mod_switch`), then at H5′ and 4 limbs `mul_public`
    by an even plaintext, `mul`, `key_switch_quad` with TrivGad and again with
    HybridGad, `mod_switch` to 2 limbs, `mod_switch_pt` and decrypt; one
    more decryption at H4′ and 6 limbs after the fourth tunnel, whose error
    term is past 2^63 (the JAX package's int64 twace overflows there).
    Each decryption is held against the plaintext evaluation on the port's
    golden backend. Returns the host ms and the backend's counts by op, the
    checks, and the last tunnel's and the TrivGad switch's inputs."""
    import math
    from collections import Counter

    import numpy as np

    from alchemy_tpu_torch.backend import golden_backend
    from alchemy_tpu_torch.core.cyc import Cyc
    from alchemy_tpu_torch.examples.common import TOWER, TOWER_P, dec_to_crt
    from alchemy_tpu_torch.nt.factor import totient
    from alchemy_tpu_torch.she import bgv
    from alchemy_tpu_torch.she.gadget import HybridGad, TrivGad
    from alchemy_tpu_torch.she.keys import SK
    from alchemy_tpu_torch.she.tunnel import tunnel, tunnel_hint

    gb = golden_backend()
    tb = getattr(bk, "fast", bk)       # the TorchBackend (of a checked pair) with the counts
    rng = np.random.default_rng(SEED)
    qs, zp = SHE_ZQS, SHE_ZP
    ops, ok = [], {}

    def run(label, fn):
        before = Counter(tb.counts)
        out, ms = host_ms(fn)
        ops.append((label, ms, dict(Counter(tb.counts) - before)))
        return out

    keys = {mp: SK.generate(mp, SHE_R / math.sqrt(totient(mp)), rng) for mp in TOWER_P}
    coeffs = rng.integers(0, zp, totient(TOWER[0]))
    pt = Cyc.from_coeffs(TOWER[0], (zp,), coeffs, gb)
    ct = run("encrypt H0' L=6", lambda: bgv.encrypt(
        keys[TOWER_P[0]], Cyc.from_coeffs(TOWER[0], (zp,), coeffs, bk), TOWER_P[0], qs, rng))
    for i in range(5):
        f = dec_to_crt(TOWER[i], TOWER[i + 1], zp)
        if i == 4:
            ct = run("mod_switch L=6→5", lambda: bgv.mod_switch(ct, qs[:5]))
        ring = f"H{i}'→H{i + 1}' L={len(ct.qs)}"
        hint = run(f"tunnel_hint {ring}", lambda: tunnel_hint(
            f, keys[TOWER_P[i + 1]], keys[TOWER_P[i]], TrivGad(), ct.qs, zp, rng, bk))
        ct_in = ct
        ct = run(f"tunnel {ring}", lambda: tunnel(hint, ct_in))
        pt = f.eval(pt)
        if i == 3:     # H4' at 6 limbs: the error term passes 2^63 here
            bits = max(abs(int(v)) for v in bgv.error_term_int(keys[TOWER_P[4]], ct)).bit_length()
            check(bits > 63, f"[she] the error term at H4' L=6 has {bits} bits, not past 2^63")
            ok["decrypt L=6"] = run("decrypt H4' L=6", lambda: bgv.decrypt(
                keys[TOWER_P[4]], ct)).equals(pt)
    sk = keys[TOWER_P[5]]
    ct4 = run("mod_switch L=5→4", lambda: bgv.mod_switch(ct, qs[:4]))
    ok["tunnels"] = run("decrypt H5' L=4", lambda: bgv.decrypt(sk, ct4)).equals(pt)
    kc = 2 * rng.integers(0, zp // 2, totient(TOWER[5]))
    k = Cyc.from_coeffs(TOWER[5], (zp,), kc, gb)
    y = run("mul_public H5' L=4", lambda: bgv.mul_public(Cyc.from_coeffs(TOWER[5], (zp,), kc, bk), ct4))
    prod = run("mul H5' L=4", lambda: bgv.mul(ct4, y))
    want = pt * (k * pt)
    hints, outs = {}, {}
    for name, gad in (("TrivGad", TrivGad()), ("HybridGad", HybridGad())):
        hints[name] = run(f"ks_hint {name} H5' L=4",
                          lambda: bgv.ks_quad_circ_hint(sk, gad, qs[:4], zp, rng, bk))
        outs[name] = run(f"key_switch_quad {name} H5' L=4",
                         lambda: bgv.key_switch_quad(hints[name], prod))
        ok[name] = bgv.decrypt(sk, outs[name]).equals(want)
    down = run("mod_switch L=4→2", lambda: bgv.mod_switch(outs["TrivGad"], qs[:2]))
    half = run("mod_switch_pt H5' L=2", lambda: bgv.mod_switch_pt(down))
    wc = gb.to_numpy(want.to_pow().data)[0]
    check(bool((wc % 2 == 0).all()), "[she] the product by an even plaintext is even")
    want_half = Cyc.from_coeffs(TOWER[5], (zp // 2,), wc // 2, gb)
    ok["mod_switch_pt"] = run("decrypt H5' L=2", lambda: bgv.decrypt(sk, half)).equals(want_half)
    return {"ops": ops, "ok": ok, "tunnel": (hint, ct_in), "ks": (hints["TrivGad"], prod)}


def profile_op(fn, calls: int) -> dict:
    """Device launches, busy and span µs per call of fn() and its three
    costliest kernels, over `calls` warm calls under torch.profiler."""
    import torch

    from alchemy_tpu_torch.examples.profile_mul_relin import _busy_us

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), "the profiler saw device time")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_kernel: dict = {}
    for e in kernels:
        by_kernel[e.name[:48]] = by_kernel.get(e.name[:48], 0.0) + e.time_range.end - e.time_range.start
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:3]
    span = max(b for _, b in spans) - min(a for a, _ in spans)
    return {"launches": len(kernels) / calls, "busy_us": _busy_us(spans) / calls,
            "span_us": span / calls, "top_us": [(k, v / calls) for k, v in top]}


def she_phase(checked_bk, torch_bk, card: str) -> dict:
    """[she]: she_run once on the checked backend (every TorchBackend op on
    the card held bit for bit against golden numpy; a divergence raises),
    then once on the torch backend alone for the times, counts and the
    device time of one tunnel and one TrivGad key switch."""
    from alchemy_tpu_torch.she import bgv
    from alchemy_tpu_torch.she.tunnel import tunnel

    t0 = time.perf_counter()
    chk = she_run(checked_bk)
    checked_s = time.perf_counter() - t0
    check(all(chk["ok"].values()), f"[she] checked run: decryptions {chk['ok']}")
    print(f"[she] checked run (torch on {card} against golden numpy, op by op): no divergence, "
          f"decryptions {chk['ok']}, {checked_s:.2f} s wall", flush=True)
    torch_bk.counts.clear()
    t0 = time.perf_counter()
    res = she_run(torch_bk)
    torch_s = time.perf_counter() - t0
    check(all(res["ok"].values()), f"[she] torch run: decryptions {res['ok']}")
    print(f"[she] torch run: decryptions {res['ok']}, {torch_s:.2f} s wall; host ms and counts "
          "by op (first call: matrix uploads included)", flush=True)
    for label, ms, counts in res["ops"]:
        print(f"[she]   {label}: {ms:.2f} ms, axis_matmul {counts.get('axis_matmul', 0)}, "
              f"to_host {counts.get('to_host', 0)}, to_device {counts.get('to_device', 0)}, "
              f"mat_upload {counts.get('mat_upload', 0)}", flush=True)
    hint, ct_in = res["tunnel"]
    hk, prod = res["ks"]
    timed = {}
    for name, fn in (("tunnel H4'→H5' L=5", lambda: tunnel(hint, ct_in)),
                     ("key_switch_quad TrivGad H5' L=4", lambda: bgv.key_switch_quad(hk, prod))):
        warm = [host_ms(fn)[1] for _ in range(3)]
        timed[name] = {"host_ms": sum(warm) / 3, "event_ms": device_ms(fn, 5),
                       **profile_op(fn, 3)}
        t = timed[name]
        print(f"[she] {name} warm: host {t['host_ms']:.3f} ms, CUDA events {t['event_ms']:.3f} ms, "
              f"{t['launches']:.0f} launches, device busy {t['busy_us']:.1f} µs of a "
              f"{t['span_us']:.1f} µs span; top kernels "
              + ", ".join(f"{k} {v:.1f} µs" for k, v in t["top_us"]), flush=True)
    return {"checked_s": checked_s, "torch_s": torch_s, "ops": res["ops"], "timed": timed}


def example_steps(name: str, bk) -> dict:
    """One example's run (`alchemy_tpu_torch/examples/`, at the seed its
    `run` defaults to) on backend bk, split into its phases: "compile"
    (KeysHints keygen, pt2ct with its hints, encrypting the arguments: the
    examples' "Generating function" phase), "eval" (the encrypted
    evaluation: strict `eval_with_error_rates` for Arithmetic and Tunnel,
    `mul_public` then `eval_ir` for HomomRLWR, as its `run` does) and
    "decrypt", each in host ms; the backend's counts during the evaluation;
    the error-rate log; whether the decryption equals the plaintext
    evaluation; and what a warm rerun needs."""
    from collections import Counter

    import numpy as np

    from alchemy_tpu_torch.core.cyc import Cyc
    from alchemy_tpu_torch.examples import arithmetic, common, homomrlwr, tunnel
    from alchemy_tpu_torch.interp.error_writer import eval_with_error_rates
    from alchemy_tpu_torch.interp.eval import eval_ir
    from alchemy_tpu_torch.interp.keys_hints import KeysHints
    from alchemy_tpu_torch.interp.pt2ct import pt2ct
    from alchemy_tpu_torch.nt.factor import totient
    from alchemy_tpu_torch.she import bgv
    from alchemy_tpu_torch.she.gadget import BaseBGad, TrivGad

    tb = getattr(bk, "fast", bk)
    seed = EXAMPLE_SEEDS[name]
    rng = np.random.default_rng(seed)

    def rand_pt(m, zp):
        return Cyc.from_coeffs(m, (zp,), rng.integers(0, zp, totient(m)), bk)

    if name == "Arithmetic":
        mod, expr, r, gad = arithmetic, arithmetic.addMul, 3.0, TrivGad()
        pts = [rand_pt(mod.M, mod.ZP), rand_pt(mod.M, mod.ZP)]
        want = eval_ir(expr, *pts)
    elif name == "Tunnel":
        mod, expr, r, gad = tunnel, common.switch(3, tunnel.ZP, bk), 3.0, BaseBGad(2)
        pts = [rand_pt(common.H0, mod.ZP)]
        want = eval_ir(expr, *pts)
    else:
        mod, expr, r, gad = homomrlwr, homomrlwr.ring_round(bk), 5.0, TrivGad()
        pts = [rand_pt(common.H0, mod.ZP_IN)]
        a = rand_pt(common.H0, mod.ZP_IN)
        want = eval_ir(expr, pts[0] * a)

    def compile_():
        ctx = KeysHints(r, seed=seed, bk=bk)
        compiled = pt2ct(expr, res_ty=mod.PT, m_map=mod.M_MAP if name == "Arithmetic"
                         else common.M_MAP, zqs=mod.ZQS, gad=gad, ctx=ctx)
        return ctx, compiled, [compiled.encrypt_arg(pt, i) for i, pt in enumerate(pts)]

    (ctx, compiled, args), compile_ms = host_ms(compile_)
    # the compiled program's own arguments: HomomRLWR's is mul_public(a, enc s)
    inputs = [bgv.mul_public(a, args[0])] if name == "HomomRLWR" else args
    if name == "HomomRLWR":
        def evaluate():
            return eval_ir(compiled.ir, bgv.mul_public(a, args[0])), []
    else:
        def evaluate():
            return eval_with_error_rates(compiled.ir, ctx, *args, strict=True)
    before = Counter(tb.counts)
    (result, log), eval_ms = host_ms(evaluate)
    counts = dict(Counter(tb.counts) - before)
    dec, decrypt_ms = host_ms(lambda: compiled.decrypt(result))
    return {"compile_ms": compile_ms, "eval_ms": eval_ms, "decrypt_ms": decrypt_ms,
            "counts": counts, "log": log, "ok": dec.equals(want), "evaluate": evaluate,
            "ctx": ctx, "args": args, "result": result, "compiled": compiled,
            "inputs": inputs, "want": want}


def op_times(fn) -> dict:
    """{primitive: [calls, host ms]} of one call of fn(), which evaluates a
    compiled program with `interp/eval.py`: each primitive's value is
    wrapped for the call so that its last application is timed, ended by a
    synchronize (the op's device work counts to the op)."""
    import importlib

    ev = importlib.import_module("alchemy_tpu_torch.interp.eval")   # the package exports `eval`
    plain = ev._prim_value
    arity = {"add_": 2, "mul_": 2, "cons_": 2, "pair_": 2}
    out: dict = {}

    def timed(name, f, left):
        def call(x):
            if left > 1:
                return timed(name, f(x), left - 1)
            y, ms = host_ms(lambda: f(x))
            rec = out.setdefault(name, [0, 0.0])
            rec[0] += 1
            rec[1] += ms
            return y
        return call

    def prim_value(name, payload):
        v = plain(name, payload)
        return timed(name, v, arity.get(name, 1)) if callable(v) else v

    ev._prim_value = prim_value
    try:
        fn()
    finally:
        ev._prim_value = plain
    return out


def examples_phase(checked_bk, torch_bk, card: str) -> dict:
    """[examples]: `all_main` on the checked backend (every TorchBackend op on
    the card against golden numpy) and on the torch backend; each example's
    phases on the torch backend (example_steps); Arithmetic's and Tunnel's
    strict error-rate logs on both backends, which must be equal: the torch
    run probes on the device (she/noise_probe.py), the checked run on the
    host (bgv.error_rate), on the same ciphertexts; the device probe against
    the host probe on Tunnel's argument and result; one warm HomomRLWR
    evaluation timed."""
    from alchemy_tpu_torch.examples import all_main
    from alchemy_tpu_torch.she import bgv, noise_probe

    t0 = time.perf_counter()
    check(all_main.main(checked_bk), "[examples] all_main on the checked backend")
    print(f"[examples] checked run: all_main (torch on {card} against golden numpy, op by op): "
          f"3 PASS, no divergence, {time.perf_counter() - t0:.2f} s wall", flush=True)
    t0 = time.perf_counter()
    check(all_main.main(torch_bk), "[examples] all_main on the torch backend")
    print(f"[examples] torch run: all_main: 3 PASS, {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    checked = {name: example_steps(name, checked_bk) for name in ("Arithmetic", "Tunnel")}
    runs = {}
    for name in EXAMPLE_SEEDS:
        st = runs[name] = example_steps(name, torch_bk)
        check(st["ok"], f"[examples] {name} on the torch backend decrypts to the plaintext")
        c = st["counts"]
        print(f"[examples] {name} on torch: PASS; keygen + pt2ct + encrypt "
              f"{st['compile_ms']:.2f} ms, encrypted evaluation {st['eval_ms']:.2f} ms, decrypt "
              f"{st['decrypt_ms']:.2f} ms; evaluation counts: axis_matmul "
              f"{c.get('axis_matmul', 0)}, to_host {c.get('to_host', 0)}, to_device "
              f"{c.get('to_device', 0)}, mat_upload {c.get('mat_upload', 0)}", flush=True)
    for name, chk in checked.items():
        check(chk["ok"], f"[examples] {name} on the checked backend decrypts to the plaintext")
        log = runs[name]["log"]
        check(log == chk["log"], f"[examples] {name}: torch log {log} != checked log {chk['log']}")
        print(f"[examples] {name} strict error-rate log: {len(log)} entries, equal on the torch "
              f"(device probe) and checked (host probe) runs; max rate "
              f"{max(rate for _, rate in log):.3g}", flush=True)
    check(all(rate < 0.01 for _, rate in runs["Tunnel"]["log"]),
          "[examples] every rate of Tunnel's log is below 0.01")
    tun = runs["Tunnel"]
    for ct in (*tun["args"], tun["result"]):
        sk = tun["ctx"].lookup_key(ct.m_prime)
        check(noise_probe.error_rate_device(sk, ct) == bgv.error_rate(sk, ct),
              f"[examples] device probe = host probe at m'={ct.m_prime}")
    print("[examples] device probe = host probe on Tunnel's argument and result (phi up to "
          "11520) and, through the logs, on every probed ciphertext", flush=True)
    fn = runs["HomomRLWR"]["evaluate"]
    warm = [host_ms(fn)[1] for _ in range(3)]
    t = {"host_ms": sum(warm) / 3, "event_ms": device_ms(fn, 3), **profile_op(fn, 2),
         "by_op": op_times(fn)}
    print(f"[examples] HomomRLWR encrypted evaluation warm ({card}): host {t['host_ms']:.3f} ms, "
          f"CUDA events {t['event_ms']:.3f} ms, {t['launches']:.0f} launches, device busy "
          f"{t['busy_us']:.1f} µs of a {t['span_us']:.1f} µs span; top kernels "
          + ", ".join(f"{k} {v:.1f} µs" for k, v in t["top_us"]), flush=True)
    print("[examples] HomomRLWR evaluation by op (host ms, a synchronize after each op): "
          + ", ".join(f"{k} {n}x {ms:.2f}" for k, (n, ms) in
                      sorted(t["by_op"].items(), key=lambda kv: -kv[1][1])), flush=True)
    return {"runs": {k: {f: v[f] for f in ("compile_ms", "eval_ms", "decrypt_ms", "counts")}
                     for k, v in runs.items()}, "warm": t, "steps": runs}


def copies(tb) -> dict:
    """The copies between host and device a TorchBackend counted so far."""
    return {k: tb.counts[k] for k in ("to_host", "to_device", "mat_upload")}


def child(code: str, timeout: float = 600) -> subprocess.CompletedProcess:
    """Run `code` in a fresh Python process at the root of the checkout."""
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=WORK.parents[1], timeout=timeout)


def last_json(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def vpu_checks(rng) -> dict:
    """[vpu]: kernels A and B, the standalone transforms (5 and 6 with the
    vpu tables), 4 and 7 in the vpu order against their plain versions at
    the small shapes, then 4 and 7 timed at DEEP."""
    res = {"small": kernel_phase(*SMALL, rng, timed=False, order="vpu"),
           "grid16": grid_kernel_phase(*SMALL_N2E16, rng, order="vpu"),
           "hybrid_small": hybrid_kernel_phase(*SMALL_HYBRID, rng, timed=False, order="vpu"),
           "deep": hybrid_kernel_phase(*DEEP, rng, timed=True, order="vpu")}
    print("[vpu] A, B, 4, 7 and the standalone transforms in the vpu order bit-identical to "
          "plain", flush=True)
    return res


#: the C++ oracle's full-width check: log2 n, limbs, zp, ciphertext pairs
NATIVE = (15, 8, 2, 2)
NATIVE_CPP = "alchemy_tpu_torch/native/zq_kernels.cpp"


def native_phase(rng, sizes: tuple = NATIVE, device: str = "cuda") -> dict:
    """[native]: the C++ oracle (`alchemy_tpu_torch/native`, built with g++
    under build/native/) against the card in the vpu order at NATIVE:
    `native.mul_relin` against `fast.mul_relin(impl="vpu")` (kernels A and
    B) on NATIVE[3] ciphertext pairs, and `native.ntt`/`intt` against the
    standalone transforms (kernels 6 and 5 with the vpu tables) on
    [1, L, n]; every check exact. Returns, per kernel counter, the largest
    error against the oracle, the oracle's CPU ms and the card's ms."""
    import numpy as np
    import torch

    from alchemy_tpu_torch import native
    from alchemy_tpu_torch.backend.cuda import rescale as rk
    from alchemy_tpu_torch.nt.primes import root_of_unity
    from alchemy_tpu_torch.she import fast

    t0 = time.perf_counter()
    so = native.library_path()
    build_s = time.perf_counter() - t0
    log_n, L, zp, pairs = sizes
    p = fast.FastParams.make(log_n, L, zp=zp, impl="vpu")
    psis = [root_of_unity(2 * p.n, q) for q in p.qs]
    s = fast.keygen(p, rng, device=device)
    hb, ha = fast.relin_hint(p, s, rng)
    cts = torch.stack([fast.encrypt(p, s, rng.integers(0, zp, p.n), rng)
                       for _ in range(2 * pairs)])
    a, b = cts[:pairs], cts[pairs:]

    def u32(t):
        return t.cpu().numpy().view(np.uint32)

    reset_launches()
    out = fast.mul_relin(p, a, b, hb, ha)
    sync()
    ran = launches()
    check(ran.get("tensor_intt", 0) > 0 and ran.get("digit_relin", 0) > 0,
          f"[native] fast.mul_relin(impl='vpu') launched {ran}")
    hbn, han = u32(hb), u32(ha)
    t0 = time.perf_counter()
    want = np.stack([native.mul_relin(u32(a[i]), u32(b[i]), hbn, han, p.qs, psis)
                     for i in range(pairs)])
    oracle_ms = (time.perf_counter() - t0) * 1e3 / pairs
    err = int(np.abs(u32(out).astype(np.int64) - want.astype(np.int64)).max())
    check(err == 0, f"[native] fast.mul_relin(impl='vpu') != native.mul_relin (max abs err {err})")
    res = {"mul_relin": {"err": err, "cpu_ms": oracle_ms, "shape": [pairs, L, p.n],
                         "ms": device_ms(lambda: fast.mul_relin(p, a, b, hb, ha), 10) / pairs}}
    fwd, inv = rk.grid_transforms("vpu")
    x = fast._uniform(rng, p.qs, p.n, device)[None]
    y = fwd(p.n, p.qs, x)
    z = inv(p.n, p.qs, y)
    xn, yn = u32(x[0]), u32(y[0])
    t0 = time.perf_counter()
    ny = np.stack([native.ntt(xn[l], q, psi) for l, (q, psi) in enumerate(zip(p.qs, psis))])
    ntt_cpu = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    nz = np.stack([native.intt(yn[l], q, psi) for l, (q, psi) in enumerate(zip(p.qs, psis))])
    intt_cpu = (time.perf_counter() - t0) * 1e3
    for name, got, ref, cpu_ms, fn in (
            ("ntt_vpu_grid", yn, ny, ntt_cpu, lambda: fwd(p.n, p.qs, x)),
            ("intt_vpu_grid", u32(z[0]), nz, intt_cpu, lambda: inv(p.n, p.qs, y))):
        e = int(np.abs(got.astype(np.int64) - ref.astype(np.int64)).max())
        check(e == 0, f"[native] {name} != native on [1, {L}, n] (max abs err {e})")
        res[name] = {"err": e, "cpu_ms": cpu_ms, "ms": device_ms(fn, 20), "shape": [1, L, p.n]}
    check(np.array_equal(nz, xn), "[native] native.intt(native.ntt(x)) != x")
    print(f"[native] {so.name} (g++, {build_s:.2f} s): at n=2^{log_n}, L={L}, zp={zp} in the "
          f"vpu order, bit-identical to the card: fast.mul_relin (A, B) on {pairs} pairs "
          f"{res['mul_relin']['ms']:.4f} ms a ciphertext against the oracle's "
          f"{oracle_ms:.1f} ms on the CPU; kernel 6 (ntt_vpu_grid) on [1, {L}, n] "
          f"{res['ntt_vpu_grid']['ms']:.4f} ms against {ntt_cpu:.1f} ms, kernel 5 "
          f"(intt_vpu_grid) {res['intt_vpu_grid']['ms']:.4f} ms against {intt_cpu:.1f} ms",
          flush=True)
    return res


RESUME_STOP_CHILD = """
import os, sys
from alchemy_tpu_torch.examples.deep_circuit import run
out = run(log_n={log_n}, depth={depth}, impl="vpu", ks="hybrid", device={device!r},
          verbose=False, stop_at_level={stop}, state_path={path!r})
assert out == (None, {stop}), out
sys.stdout.flush()
os.kill(os.getpid(), 9)
"""

RESUME_CHILD = """
import json, time
from alchemy_tpu_torch.backend.cuda import mul_relin as mr, rescale as rk
from alchemy_tpu_torch.examples.deep_circuit import run
t0 = time.perf_counter()
ok, ct, level_ms = run(resume=True, state_path={path!r}, device={device!r}, verbose=False)
print(json.dumps({{"ok": ok, "levels": len(level_ms), "wall_s": time.perf_counter() - t0,
                  "device": str(ct.device), "launches": {{**mr.LAUNCHES, **rk.LAUNCHES}}}}))
"""


def resume_phase(card: str, device: str = "cuda") -> dict:
    """[resume]: the depth-16 chain at n = 2^15 (18 limbs, hybrid, impl
    "vpu") stops before level RESUME_STOP in one process, which saves its
    state and dies by SIGKILL; a fresh process resumes it on the card and
    decrypts the whole chain; then one uninterrupted run in this process
    (deep_path, the launch counts of the path)."""
    WORK.mkdir(parents=True, exist_ok=True)
    path = WORK / "deep_state.npz"
    path.unlink(missing_ok=True)
    args = dict(log_n=DEEP[0], depth=DEEP_DEPTH, stop=RESUME_STOP, path=str(path),
                device=device)
    t0 = time.perf_counter()
    first = child(RESUME_STOP_CHILD.format(**args))
    stop_s = time.perf_counter() - t0
    check(first.returncode == -9 and path.exists(),
          f"[resume] the stopped run: rc {first.returncode}, state file {path.exists()}: "
          f"{first.stderr[-2000:]}")
    t0 = time.perf_counter()
    second = child(RESUME_CHILD.format(**args))
    resume_s = time.perf_counter() - t0
    check(second.returncode == 0, f"[resume] the resumed run: {second.stderr[-2000:]}")
    got = last_json(second.stdout)
    want_launched = ("tensor_intt", "hybrid_digit_relin", *grid_names("vpu"), "rescale_fwd")
    check(got["ok"] and got["levels"] == DEEP_DEPTH - RESUME_STOP
          and got["device"].startswith(device)
          and all(got["launches"][k] > 0 for k in want_launched),
          f"[resume] the resumed chain: {got}")
    print(f"[resume] n=2^{DEEP[0]} depth={DEEP_DEPTH} hybrid impl=vpu: stopped before level "
          f"{RESUME_STOP} and killed (rc {first.returncode}, {stop_s:.2f} s, state "
          f"{path.stat().st_size} bytes), resumed in a fresh process on {got['device']}: PASS "
          f"({got['levels']} levels in {got['wall_s']:.2f} s, {resume_s:.2f} s with the "
          f"process); launches {got['launches']}", flush=True)
    path.unlink()
    res = deep_path(card, "resume", "vpu")
    res.update(stop_s=stop_s, resume_s=resume_s, resumed=got)
    return res


def jit_phase(steps: dict, tb, card: str, device: str = "cuda") -> dict:
    """[jit]: each example's compiled program (from [examples]: the same
    keys, hints and arguments) through `jit_compile`, a CUDA graph, with the
    strict ERW probe for Arithmetic and Tunnel: the build's host s; every
    output component and the error-rate log equal to eager evaluation; the
    decryption equal to the plaintext; no copy between host and device in a
    call; a second call on other inputs (the first negated) leaves the first
    output as it was;
    a ciphertext whose c0 is uniform raises NoiseOverflowError in a strict
    program; then JIT_CALLS calls timed on the host clock and between CUDA
    events, the launches per call (profiler), and the same program's warm
    eager evaluation on the host clock."""
    import numpy as np
    import torch

    from alchemy_tpu_torch.core.cyc import Cyc
    from alchemy_tpu_torch.interp.error_writer import NoiseOverflowError, eval_with_error_rates
    from alchemy_tpu_torch.interp.eval import eval_ir
    from alchemy_tpu_torch.interp.jit_exec import jit_compile
    from alchemy_tpu_torch.she import bgv
    from alchemy_tpu_torch.she.keys import uniform_residues

    rng = np.random.default_rng(SEED)
    res = {}
    for name, st in steps.items():
        compiled, ctx, inputs = st["compiled"], st["ctx"], st["inputs"]
        probe = name != "HomomRLWR"

        def eager():
            if probe:
                return eval_with_error_rates(compiled.ir, ctx, *inputs, strict=True)
            return eval_ir(compiled.ir, *inputs), []

        def split(r):
            return r if probe else (r, [])

        j, build_ms = host_ms(lambda: jit_compile(
            compiled, inputs, **({"noise_probe": ctx, "strict": True} if probe else {})))
        check(device != "cuda" or j.graph is not None, f"[jit] {name}: no CUDA graph")
        ref, ref_log = eager()
        got, log = split(j(*inputs))
        check([(c.m, c.qs, c.basis) for c in got.comps] == [(c.m, c.qs, c.basis)
                                                            for c in ref.comps]
              and all(torch.equal(a.data, b.data) for a, b in zip(got.comps, ref.comps)),
              f"[jit] {name}: the replay != eager eval_ir")
        check(log == ref_log, f"[jit] {name}: log {log} != eager {ref_log}")
        check(compiled.decrypt(got).equals(st["want"]), f"[jit] {name}: decrypt != plaintext")
        kept = [c.data.clone() for c in got.comps]
        negated = [bgv.neg(inputs[0]), *inputs[1:]]
        before = copies(tb)
        other, _ = split(j(*negated))
        check(copies(tb) == before, f"[jit] {name}: a call copied: {before} -> {copies(tb)}")
        check(all(torch.equal(c.data, k) for c, k in zip(got.comps, kept))
              and not all(torch.equal(a.data, b.data) for a, b in zip(got.comps, other.comps)),
              f"[jit] {name}: a second call changed the first output")
        drill = "no strict probe"
        if probe:
            c0 = inputs[0].comps[0]
            bad0 = Cyc.from_coeffs(c0.m, c0.qs, uniform_residues(rng, c0.qs, c0.ring.phi),
                                   tb).to_basis(c0.basis)
            try:
                j(inputs[0].with_comps((bad0, *inputs[0].comps[1:])), *inputs[1:])
                drill = None
            except NoiseOverflowError as e:
                drill = f"raised ({str(e)[:60]}...)"
            check(drill is not None, f"[jit] {name}: uniform c0 returned a ciphertext")
        fn = lambda: j(*inputs)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(JIT_CALLS):
            fn()
        torch.cuda.synchronize()
        r = res[name] = {"build_ms": build_ms,
                         "host_ms": (time.perf_counter() - t0) * 1e3 / JIT_CALLS,
                         "event_ms": device_ms(fn, JIT_CALLS), **profile_op(fn, 3),
                         "eager_ms": sum(host_ms(eager)[1] for _ in range(3)) / 3,
                         "out": got, "log": log, "bytes": j.arg_bytes()}
        print(f"[jit] {name} ({card}): CUDA graph built in {build_ms / 1e3:.3f} s (warm-up + "
              f"capture); bit-identical to eager eval_ir, log equal ({len(log)} entries), "
              f"decrypts to the plaintext, no copy in a call, outputs not aliased, strict drill "
              f"{drill}; per call over {JIT_CALLS}: host {r['host_ms']:.3f} ms, CUDA events "
              f"{r['event_ms']:.3f} ms, {r['launches']:.0f} launches, busy {r['busy_us']:.1f} µs "
              f"of {r['span_us']:.1f}; eager warm host {r['eager_ms']:.3f} ms", flush=True)
    return res


CHECKPOINT_CHILD = """
import json, time
import numpy as np
import torch
from alchemy_tpu_torch.backend.torch_backend import TorchBackend
from alchemy_tpu_torch.interp.eval import eval_ir
from alchemy_tpu_torch.interp.jit_exec import jit_compile
from alchemy_tpu_torch.she.serialize import load_checkpoint
t0 = time.perf_counter()
compiled, cts = load_checkpoint({path!r}{bk})
if {device!r} == "cuda":
    torch.cuda.synchronize()
load_s = time.perf_counter() - t0
arg, saved = cts["arg"], cts["result"]
eager = eval_ir(compiled.ir, arg)
j = jit_compile(compiled, [arg])
got = j(arg)
want = np.load({want!r})
same = all(torch.equal(a.data, b.data) for x in (eager, got) for a, b in zip(x.comps, saved.comps))
decs = [compiled.decrypt(x) for x in (saved, eager, got)]
print(json.dumps({{"load_s": load_s, "device": str(arg.comps[0].data.device),
                  "graph": j.graph is not None, "same": same,
                  "ok": [bool(np.array_equal(d.bk.to_numpy(d.to_pow().data), want)) for d in decs]}}))
"""


def checkpoint_phase(st: dict, tb, device: str = "cuda") -> dict:
    """[checkpoint]: HomomRLWR's compiled program (keys, hints, schedule)
    saved with its argument and eager result (`she/serialize.py`), loaded in
    a fresh process on the card, evaluated eagerly and through jit_compile:
    both equal the saved result, and the three decrypt to the plaintext."""
    import numpy as np

    from alchemy_tpu_torch.she.serialize import save_checkpoint

    WORK.mkdir(parents=True, exist_ok=True)
    path, want = WORK / "homomrlwr_ckpt.npz", WORK / "homomrlwr_want.npy"
    _, save_ms = host_ms(lambda: save_checkpoint(
        st["compiled"], path, cts={"arg": st["inputs"][0], "result": st["result"]}))
    np.save(want, tb.to_numpy(st["want"].to_pow().data))
    nbytes = path.stat().st_size
    t0 = time.perf_counter()
    out = child(CHECKPOINT_CHILD.format(
        path=str(path), want=str(want), device=device,
        bk="" if device == "cuda" else f", bk=TorchBackend({device!r})"))
    child_s = time.perf_counter() - t0
    check(out.returncode == 0, f"[checkpoint] the loading process: {out.stderr[-2000:]}")
    got = last_json(out.stdout)
    check(got["device"].startswith(device) and got["same"] and all(got["ok"])
          and (got["graph"] or device != "cuda"), f"[checkpoint] {got}")
    print(f"[checkpoint] HomomRLWR's compiled program: {nbytes} bytes, saved in "
          f"{save_ms / 1e3:.2f} s, loaded in a fresh process on {got['device']} in "
          f"{got['load_s']:.2f} s ({child_s:.2f} s with the process, its eager run and its "
          "CUDA graph): eager and graph results equal the saved one, all three decrypt to the "
          "plaintext", flush=True)
    path.unlink()
    want.unlink()
    return {"bytes": nbytes, "save_s": save_ms / 1e3, "load_s": got["load_s"],
            "child_s": child_s}


JITMESH_CALLS = 3
#: the ranks' example programs, built once per rank process (example_steps)
_RANK_STEPS: dict = {}


def mesh_block(t, shape, li: int, ci: int):
    """The block of a whole [L, n] tensor that the rank at (li, ci) of a
    ('limb', 'coeff') mesh of `shape` holds (`parallel/spmd.py`'s layout):
    rows [li·b, (li + 1)·b) with b = ⌈L / limb⌉, zero-padded past L, and the
    ci-th of `coeff` column blocks (all columns when they do not split)."""
    import torch

    LS, C = shape
    L, n = t.shape
    b = -(-L // LS)
    rows = t[li * b:(li + 1) * b]
    rows = torch.cat((rows, rows.new_zeros((b - rows.shape[0], n))))
    return rows[:, ci * (n // C):(ci + 1) * (n // C)] if n % C == 0 else rows


def jit_kwargs(name: str, ctx) -> dict:
    """[jit]'s options: the strict noise probe for Arithmetic and Tunnel."""
    return {} if name == "HomomRLWR" else {"noise_probe": ctx, "strict": True}


def jitmesh_phase(steps: dict, jit: dict, card: str, device: str = "cuda") -> dict:
    """[jitmesh], one rank: in the one-rank world of the script's process
    (NCCL on the card; initialised here if [dist] has not) compiles each
    example's program from [examples] with `jit_compile(..., mesh=)` on the
    ('limb', 'coeff') mesh (1, 1): a CUDA graph, bit-identical to [jit]'s
    single-device graph (components and log), decrypting to the plaintext
    after `gather`, no copy in a call; replay ms (host clock and CUDA
    events) beside [jit]'s."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from alchemy_tpu_torch.interp.jit_exec import jit_compile
    from alchemy_tpu_torch.parallel.multihost import init_multihost

    init_multihost(backend="nccl" if device == "cuda" else "gloo")
    mesh = init_device_mesh(device, (1, 1), mesh_dim_names=("limb", "coeff"))
    res = {}
    for name, st in steps.items():
        compiled, ctx, inputs = st["compiled"], st["ctx"], st["inputs"]
        kw = jit_kwargs(name, ctx)
        j, build_ms = host_ms(lambda: jit_compile(compiled, inputs, mesh=mesh, **kw))
        check(device != "cuda" or j.graph is not None, f"[jitmesh] {name}: no CUDA graph")
        fn = lambda: j(*inputs)
        got, log = fn() if kw else (fn(), [])
        ref = jit[name]
        check(all(torch.equal(c.data.local, r.data) for c, r in zip(got.comps, ref["out"].comps))
              and log == ref["log"], f"[jitmesh] {name}: mesh (1, 1) != [jit]'s graph")
        check(compiled.decrypt(j.gather(got)).equals(st["want"]),
              f"[jitmesh] {name}: decrypt != plaintext")
        before = j._copies()
        fn()
        check(j._copies() == before, f"[jitmesh] {name}: a call copied")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(JIT_CALLS):
            fn()
        torch.cuda.synchronize()
        r = res[name] = {"build_ms": build_ms,
                         "host_ms": (time.perf_counter() - t0) * 1e3 / JIT_CALLS,
                         "event_ms": device_ms(fn, JIT_CALLS),
                         "collectives": dict(j.collectives), "bytes": j.arg_bytes()}
        print(f"[jitmesh] {name} ({card}), one NCCL rank, mesh (1, 1): CUDA graph built in "
              f"{build_ms / 1e3:.3f} s, bit-identical to [jit]'s graph, log equal, decrypts to "
              f"the plaintext, no copy in a call; per call over {JIT_CALLS}: host "
              f"{r['host_ms']:.3f} ms, CUDA events {r['event_ms']:.3f} ms against [jit]'s "
              f"{ref['host_ms']:.3f} / {ref['event_ms']:.3f} ms; collectives "
              f"{r['collectives']}; bytes {r['bytes']}", flush=True)
    return res


def jitmesh2_rank(shapes, singles: dict, device: str = "cuda") -> dict:
    """One of the two gloo ranks of [jitmesh]: each example's program
    (built once in this process at EXAMPLE_SEEDS, the programs of
    [examples]) through `jit_compile(..., mesh=)` on each ('limb', 'coeff')
    mesh of `shapes`, eager; against `singles` ({name: (the single-device
    [jit] output's components on the CPU, its log)}): whether this rank's
    blocks equal the single-device blocks, whether the logs are equal and
    the gathered result decrypts to the plaintext; its collectives by (op,
    axis), bytes of arguments and hints, and host ms per call."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from alchemy_tpu_torch.backend.torch_backend import TorchBackend
    from alchemy_tpu_torch.interp.jit_exec import jit_compile

    if device == "cuda":
        torch.cuda.set_device(0)
    if not _RANK_STEPS:
        tb = TorchBackend(device)
        _RANK_STEPS.update({name: example_steps(name, tb) for name in singles})
    res = {}
    for shape in shapes:
        mesh = init_device_mesh(device, tuple(shape), mesh_dim_names=("limb", "coeff"))
        li, ci = mesh.get_local_rank("limb"), mesh.get_local_rank("coeff")
        for name, (single, single_log) in singles.items():
            st = _RANK_STEPS[name]
            compiled, inputs = st["compiled"], st["inputs"]
            kw = jit_kwargs(name, st["ctx"])
            j = jit_compile(compiled, inputs, mesh=mesh, **kw)
            fn = lambda: j(*inputs)
            got, log = fn() if kw else (fn(), [])
            ok = all(torch.equal(c.data.local.cpu(), mesh_block(s, shape, li, ci))
                     for c, s in zip(got.comps, single))
            decrypts = compiled.decrypt(j.gather(got)).equals(st["want"])
            sync()
            t0 = time.perf_counter()
            for _ in range(JITMESH_CALLS):
                fn()
            sync()
            res[str(tuple(shape)), name] = {
                "blocks_equal": ok, "logs_equal": log == single_log, "decrypts": decrypts,
                "collectives": {f"{op}@{axis}": c for (op, axis), c in j.collectives.items()},
                "bytes": j.arg_bytes(), "graph": j.graph is not None,
                "ms": (time.perf_counter() - t0) * 1e3 / JITMESH_CALLS}
    return res


def jitmesh2_phase(jit: dict, card: str, world, device: str = "cuda") -> dict:
    """[jitmesh], two gloo ranks sharing the card (`world`): the meshes
    (1, 2) and (2, 1), eager (`jitmesh2_rank`); Tunnel's 1-limb hint chains
    and HomomRLWR's 5-limb argument are padded on (2, 1). Each rank's blocks
    equal the blocks of [jit]'s single-device output, the gathered results
    decrypt; collectives, bytes per rank against single-device, call ms."""
    singles = {name: ([c.data.cpu() for c in r["out"].comps], r["log"])
               for name, r in jit.items()}
    shapes = ((1, 2), (2, 1))
    ranks = world.run(jitmesh2_rank, shapes, singles, device)
    for key in ranks[0]:
        rs = [r[key] for r in ranks]
        check(all(r["blocks_equal"] and r["logs_equal"] and r["decrypts"] and not r["graph"]
                  for r in rs), f"[jitmesh] {key}: {rs}")
        check(any(r["collectives"] for r in rs), f"[jitmesh] {key}: no collective")
        single = jit[key[1]]["bytes"]
        print(f"[jitmesh] {key[1]} ({card}), two gloo ranks, mesh {key[0]}, eager: each rank's "
              f"blocks bit-identical to [jit]'s output, logs equal, gathered result decrypts; "
              f"collectives per call {rs[0]['collectives']}; bytes (args + hints) per rank "
              f"{[r['bytes']['args'] + r['bytes']['hints'] for r in rs]} against "
              f"{single['args'] + single['hints']} single-device; host ms per call "
              f"{[round(r['ms'], 3) for r in rs]} ({JITMESH_CALLS} calls)", flush=True)
    return {key: [r[key] for r in ranks] for key in ranks[0]}


# [dist], [dist2], [pipeline]: the mesh path (parallel/). [dist] and [dist2]
# run at HEADLINE with the 4-step NTT split n = n1·n2, n1 = 2^(log2 n // 2),
# the hybrid op at DEEP; [pipeline] is the deep chain of PIPE
PIPE = (15, 18, 16, 4, 2)         # log2 n, L0, depth, micro-batches M, mb
PIPE_SEED = 11
DIST_CALLS = 3
# a hang or a dead rank of [dist2] or [pipeline] S=2 fails the script
RANK_TIMEOUT_S = 600
DIST_TPU = "alchemy_tpu/parallel/dist.py"


def dist_layout(cfg):
    """(to, back): index maps from coefficient order to the 4-step NTT's
    (j2, j1) storage order and back."""
    import numpy as np

    j2, j1 = np.divmod(np.arange(cfg.p.n), cfg.n1)
    to = j1 * cfg.n2 + j2
    back = np.empty_like(to)
    back[to] = np.arange(cfg.p.n)
    return to, back


def dist_bridge(p, cfg, mesh, fwd, x):
    """int32 [..., L, n] in p's NTT slot order → the dist NTT domain: the
    single-chip inverse NTT, the (j2, j1) storage order, the dist forward NTT
    on the one-rank mesh."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from alchemy_tpu_torch.parallel.dist import NTT_PLACEMENTS
    from alchemy_tpu_torch.she import fast

    to, _ = dist_layout(cfg)
    stored = fast._intt_p(p, x)[..., torch.from_numpy(to).to(x.device)]
    rows = distribute_tensor(stored.reshape(-1, *x.shape[-2:]).contiguous(), mesh,
                             NTT_PLACEMENTS, src_data_rank=None)
    return fwd(rows).full_tensor().reshape(x.shape)


def dist_unbridge(p, cfg, mesh, inv, x):
    """The dist NTT domain → int32 coefficients [..., L, n] (natural order)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from alchemy_tpu_torch.parallel.dist import NTT_PLACEMENTS

    _, back = dist_layout(cfg)
    rows = distribute_tensor(x.reshape(-1, *x.shape[-2:]).contiguous(), mesh, NTT_PLACEMENTS,
                             src_data_rank=None)
    return inv(rows).full_tensor().reshape(x.shape)[..., torch.from_numpy(back).to(x.device)]


def sync() -> None:
    """Wait for the card where there is one (the ranks of [dist2] and
    [pipeline] also run on the CPU, in a rehearsal)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def dist_calls(fn, calls: int) -> tuple[float, dict, dict]:
    """(host ms per call over `calls` calls after one warm-up, collective
    calls per call by (op, axis), bytes staged through host per call)."""
    from alchemy_tpu_torch.parallel import dist as D

    fn()
    sync()
    D.reset_collectives()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    per = {f"{op}@{axis}": c // calls for (op, axis), c in D.COLLECTIVES.items()}
    staged = {f"{op}@{axis}": c // calls for (op, axis), c in D.STAGED_BYTES.items()}
    return ms, per, staged


def dist_phase(rng, card: str, device: str = "cuda") -> dict:
    """[dist]: the mesh path on one rank (NCCL on the card), mesh (1, 1, 1),
    at HEADLINE and DEEP (`dist_checks`). Leaves the one-rank world
    initialised for [pipeline]."""
    from alchemy_tpu_torch.parallel.mesh import make_mesh
    from alchemy_tpu_torch.parallel.multihost import init_multihost

    init_multihost(backend="nccl" if device == "cuda" else "gloo")
    return dist_checks(rng, card, make_mesh((1, 1, 1), device), device, "[dist]", HEADLINE, DEEP)


def dist_checks(rng, card: str, mesh, device: str, tag: str, headline: tuple, deep: tuple) -> dict:
    """The mesh path on `mesh` (run on every rank of it) at `headline` in
    the "pallas" order: make_dist_ntt (a2a and ring, round trip),
    make_dist_mul_relin (digit and row placements, a2a and ring),
    make_dist_rescale, and make_dist_mul_relin_hybrid at `deep`'s chain,
    each through the layout bridge bit-identical to the single-chip
    fast.mul_relin / fast.rescale / hybrid.mul_relin_hybrid, the products
    decrypted; host ms a call after. The dist ops launch no kernel of the
    port (their local stages are torch ops): the counters are read around
    them. Rank 0 prints."""
    from dataclasses import replace

    import numpy as np
    import torch
    import torch.distributed
    from torch.distributed.tensor import distribute_tensor

    from alchemy_tpu_torch.parallel import dist as D
    from alchemy_tpu_torch.she import fast, hybrid

    say = print if torch.distributed.get_rank() == 0 else (lambda *a, **k: None)
    log_n, L, Bt = headline
    p = fast.FastParams.make(log_n, L, zp=2, impl="pallas")
    n1 = 1 << (log_n // 2)
    cfg = D.DistConfig(p=p, n1=n1, n2=p.n // n1)
    t0 = time.perf_counter()
    D.dist_tables(cfg)
    tables_s = time.perf_counter() - t0
    fwd, inv = D.make_dist_ntt(cfg, mesh)
    fwd_r, inv_r = D.make_dist_ntt(cfg, mesh, strategy="ring")

    s = fast.keygen(p, rng, device=device)
    hb, ha = fast.relin_hint(p, s, rng)
    m1, m2 = rng.integers(0, p.zp, (Bt, p.n)), rng.integers(0, p.zp, (Bt, p.n))
    ct_a = torch.stack([fast.encrypt(p, s, m, rng) for m in m1])
    ct_b = torch.stack([fast.encrypt(p, s, m, rng) for m in m2])
    want = fast.mul_relin(p, ct_a, ct_b, hb, ha)
    want_down = fast.rescale(p, want, 1)
    d_a, d_b, d_hb, d_ha = (dist_bridge(p, cfg, mesh, fwd, x) for x in (ct_a, ct_b, hb, ha))

    def dt(x, placements=D.CT_PLACEMENTS):
        return distribute_tensor(x.contiguous(), mesh, placements, src_data_rank=None)

    rows = dt(d_a.reshape(-1, L, p.n), D.NTT_PLACEMENTS)
    reset_launches()
    y, y_r = fwd(rows), fwd_r(rows)
    check(torch.equal(y.to_local(), y_r.to_local()), f"{tag} ring forward NTT != a2a")
    for f_inv in (inv, inv_r):
        check(torch.equal(f_inv(y).to_local(), rows.to_local()), f"{tag} NTT round trip")
    hints = {"digit": (dt(d_hb, D.HINT_PLACEMENTS), dt(d_ha, D.HINT_PLACEMENTS)),
             "row": (dt(d_hb, D.ROW_HINT_PLACEMENTS), dt(d_ha, D.ROW_HINT_PLACEMENTS))}
    runs = {f"{placement} {strategy}": (D.make_dist_mul_relin(cfg, mesh, strategy, placement),
                                        hints[placement])
            for placement in ("digit", "row") for strategy in ("a2a", "ring")}
    cta, ctb = dt(d_a), dt(d_b)
    outs = {k: run(cta, ctb, *h).full_tensor() for k, (run, h) in runs.items()}
    out = outs["digit a2a"]
    check(all(torch.equal(o, out) for o in outs.values()), f"{tag} placements/strategies differ")
    rescale = D.make_dist_rescale(cfg, mesh, active=L)
    down = rescale(dt(out)).full_tensor()
    sync()
    seen = launches()
    check(not any(seen.values()), f"{tag} the dist ops launched kernels: {seen}")

    coeff = dist_unbridge(p, cfg, mesh, inv, out)
    check(torch.equal(coeff, fast._intt_p(p, want)),
          f"{tag} make_dist_mul_relin != fast.mul_relin through the bridge")
    p7 = replace(p, qs=p.qs[:-1])
    coeff_down = dist_unbridge(p, cfg, mesh, inv, down)
    check(torch.equal(coeff_down[..., :L - 1, :], fast._intt_p(p7, want_down))
          and not coeff_down[..., L - 1, :].any(),
          f"{tag} make_dist_rescale != fast.rescale through the bridge")
    prods = fast._ntt_p(p, coeff)
    downs = fast._ntt_p(p7, coeff_down[..., :L - 1, :].contiguous())
    for i in range(Bt):
        w = negacyclic_mod2(m1[i], m2[i])
        check(np.array_equal(fast.decrypt(p, s, prods[i]), w), f"{tag} decrypt of product {i}")
        check(np.array_equal(fast.decrypt(p7, s[:-1], downs[i]), w),
              f"{tag} decrypt of rescaled product {i}")

    # hybrid key-switching at DEEP's chain (L = 16, dnum = 4, K = 4, T = 20)
    hk = hybrid.HybridKS.make(fast.FastParams.make(deep[0], deep[1], zp=2, impl="pallas"))
    ph, pe = hk.p, hk.pe
    cfg_h = D.DistConfig(p=ph, n1=n1, n2=ph.n // n1)
    cfg_e = D.DistConfig(p=pe, n1=n1, n2=ph.n // n1)
    fwd_h, inv_h = D.make_dist_ntt(cfg_h, mesh)
    fwd_e, _ = D.make_dist_ntt(cfg_e, mesh)
    sh, (hhb, hha) = hybrid.hybrid_keygen_hint(hk, rng, device=device)
    h1, h2 = rng.integers(0, ph.zp, (Bt, ph.n)), rng.integers(0, ph.zp, (Bt, ph.n))
    hct_a = torch.stack([fast.encrypt(ph, sh, m, rng) for m in h1])
    hct_b = torch.stack([fast.encrypt(ph, sh, m, rng) for m in h2])
    want_h = hybrid.mul_relin_hybrid(hk, hct_a, hct_b, hhb, hha)
    dh_a, dh_b = (dist_bridge(ph, cfg_h, mesh, fwd_h, x) for x in (hct_a, hct_b))
    dh_hb, dh_ha = (dist_bridge(pe, cfg_e, mesh, fwd_e, x) for x in (hhb, hha))
    run_h = D.make_dist_mul_relin_hybrid(hk, cfg_h, mesh)
    hargs = (dt(dh_a), dt(dh_b), dt(dh_hb, D.HINT_PLACEMENTS), dt(dh_ha, D.HINT_PLACEMENTS))
    reset_launches()
    out_h = run_h(*hargs).full_tensor()
    sync()
    seen_h = launches()
    check(not any(seen_h.values()), f"{tag} the hybrid dist op launched kernels: {seen_h}")
    coeff_h = dist_unbridge(ph, cfg_h, mesh, inv_h, out_h)
    check(torch.equal(coeff_h, fast._intt_p(ph, want_h)),
          f"{tag} make_dist_mul_relin_hybrid != hybrid.mul_relin_hybrid through the bridge")
    prods_h = fast._ntt_p(ph, coeff_h)
    for i in range(Bt):
        check(np.array_equal(fast.decrypt(ph, sh, prods_h[i]), negacyclic_mod2(h1[i], h2[i])),
              f"{tag} decrypt of hybrid product {i}")
    say(f"{tag} {mesh.size()} rank(s), {torch.distributed.get_backend()}, mesh "
        f"{tuple(mesh.shape)}, n=2^{log_n} n1={n1} L={L} Bt={Bt}: NTT a2a = ring, round trips "
        "exact; make_dist_mul_relin (digit/row x a2a/ring) and make_dist_rescale bit-identical "
        "to fast.mul_relin / fast.rescale through the bridge; make_dist_mul_relin_hybrid at "
        f"L={deep[1]} dnum={hk.dnum} K={len(hk.ps)} bit-identical to hybrid.mul_relin_hybrid; "
        f"{Bt} products of each decrypt; kernel launches in the dist ops "
        f"{sum(seen.values()) + sum(seen_h.values())} (local stages are torch ops); "
        f"dist_tables {tables_s:.3f} s", flush=True)

    res = {"tables_s": tables_s, "inputs": [x.cpu() for x in (d_a, d_b, d_hb, d_ha)],
           "out": out.cpu(), "cfg": (p.n, p.qs, p.impl, n1)}
    timed = {"ntt fwd a2a": lambda: fwd(rows), "ntt fwd ring": lambda: fwd_r(rows),
             **{f"mul_relin {k}": (lambda r=run, h=h: r(cta, ctb, *h)) for k, (run, h) in runs.items()},
             "rescale": lambda: rescale(dt(out)),
             "mul_relin_hybrid": lambda: run_h(*hargs)}
    for name, fn in timed.items():
        ms, per, staged = dist_calls(fn, DIST_CALLS)
        res[name] = {"ms": ms, "collectives": per, "staged": staged}
        rate = "" if name.startswith("ntt") or name == "rescale" else f" = {Bt * 1e3 / ms:.1f} ops/s"
        say(f"{tag} {name}: {ms:.2f} ms per call of {Bt} ciphertexts{rate} (host clock, "
            f"{DIST_CALLS} calls) on {card}; collectives per call {per}", flush=True)
    return res


def dist2_rank(shape, cfg_args, d_a, d_b, d_hb, d_ha, calls: int, device: str = "cuda"):
    """One of the two ranks of [dist2]: make_dist_mul_relin (digit, a2a) on
    the mesh `shape` on the card over the world's gloo group; returns the
    full product (read back through a CPU mesh of the same ranks), host ms
    per call, collectives and staged bytes per call, on rank 0."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from alchemy_tpu_torch.parallel import dist as D
    from alchemy_tpu_torch.parallel.mesh import make_mesh
    from alchemy_tpu_torch.she import fast

    if device == "cuda":
        torch.cuda.set_device(0)
    mesh, cpu_mesh = make_mesh(shape, device), make_mesh(shape, "cpu")
    n, qs, impl, n1 = cfg_args
    cfg = D.DistConfig(p=fast.FastParams(n=n, qs=qs, zp=2, impl=impl), n1=n1, n2=n // n1)
    run = D.make_dist_mul_relin(cfg, mesh)

    def dt(x, placements):
        return distribute_tensor(x.to(device), mesh, placements, src_data_rank=None)

    args = (dt(d_a, D.CT_PLACEMENTS), dt(d_b, D.CT_PLACEMENTS), dt(d_hb, D.HINT_PLACEMENTS),
            dt(d_ha, D.HINT_PLACEMENTS))
    out = run(*args)
    full = DTensor.from_local(out.to_local().cpu(), cpu_mesh, D.CT_PLACEMENTS,
                              run_check=False).full_tensor()
    ms, per, staged = dist_calls(lambda: run(*args), calls)
    return (full, ms, per, staged) if dist.get_rank() == 0 else None


def dist2_phase(dp: dict, card: str, world, device: str = "cuda") -> dict:
    """[dist2]: the two ranks of `world` sharing the card in one gloo world
    (NCCL refuses two ranks on one GPU), make_dist_mul_relin on [dist]'s
    inputs with the mesh (1, 1, 2) ('coeff' across the ranks) and then
    (1, 2, 1) ('limb' across them); each product bit-identical to
    [dist]'s. The comm helpers stage each CUDA tensor a gloo collective
    moves through host memory, and the bytes are printed."""
    import torch

    res = {}
    for shape in ((1, 1, 2), (1, 2, 1)):
        full, ms, per, staged = world.run(dist2_rank, shape, dp["cfg"], *dp["inputs"],
                                          DIST_CALLS, device)[0]
        check(torch.equal(full, dp["out"]), f"[dist2] mesh {shape} != [dist]")
        Bt = full.shape[0]
        res[str(shape)] = {"ms": ms, "collectives": per, "staged": staged}
        print(f"[dist2] two gloo ranks on one card, mesh {shape}: make_dist_mul_relin "
              f"bit-identical to [dist]; {ms:.2f} ms per call of {Bt} ciphertexts = "
              f"{Bt * 1e3 / ms:.1f} ops/s (host clock, {DIST_CALLS} calls) on {card}; "
              f"collectives per call {per}; host staging by the comm helpers (gloo moves "
              f"CUDA tensors through host memory) {staged} bytes per call", flush=True)
    return res


def pipeline_inputs(pipe: tuple, device: str) -> dict:
    """The inputs of the chain `pipe` (PIPE) from PIPE_SEED, in the "pallas"
    order: params p, the padded hints per level on device, the sequential
    reference's (params, hb, ha) per level, ciphertexts [M·mb, 2, L0, n],
    messages, secret key coefficients."""
    from dataclasses import replace

    import numpy as np
    import torch

    from alchemy_tpu_torch.she import fast
    from alchemy_tpu_torch.she.keys import gaussian_coeffs

    log_n, L0, depth, M, mb = pipe
    p = fast.FastParams.make(log_n, L0, zp=2, impl="pallas")
    rng = np.random.default_rng(PIPE_SEED)
    s_int = gaussian_coeffs(rng, 1.0, p.n)

    def key_at(pp):
        return fast._ntt_p(pp, fast._residues(s_int, pp.qs, device))

    hints, ref = [], []
    cur = p
    for level in range(depth):
        act = L0 - level
        hb, ha = fast.relin_hint(cur, key_at(cur), rng)
        pad = []
        for h in (hb, ha):
            full = torch.zeros((L0, L0, p.n), dtype=torch.int32, device=device)
            full[:act, :act] = h
            pad.append(full)
        hints.append(tuple(pad))
        ref.append((cur, hb, ha))
        cur = replace(cur, qs=cur.qs[:-1])
    msgs = rng.integers(0, 2, (M * mb, p.n))
    cts = torch.stack([fast.encrypt(p, key_at(p), m, rng) for m in msgs])
    return {"p": p, "hints": hints, "ref": ref, "cts": cts, "msgs": msgs, "s_int": s_int}


def in_order(inp: dict, impl: str) -> dict:
    """pipeline_inputs carried into the slot order of impl (inverse NTT in
    the "pallas" order, forward NTT in impl's: the same ring elements)."""
    from dataclasses import replace

    from alchemy_tpu_torch.she import fast

    def conv(pp, x):
        return fast._ntt_p(replace(pp, impl=impl), fast._intt_p(pp, x))

    p = inp["p"]
    return {**inp, "p": replace(p, impl=impl),
            "hints": [(conv(p, hb), conv(p, ha)) for hb, ha in inp["hints"]],
            "ref": [(replace(pp, impl=impl), conv(pp, hb), conv(pp, ha))
                    for pp, hb, ha in inp["ref"]],
            "cts": conv(p, inp["cts"])}


def pipeline_run(mesh, p, hints, cts, pipe: tuple) -> dict:
    """make_pipeline_chain of `pipe` on `mesh` (axis 'stage'): this rank's
    launches and by-shape launches of one run after a warm-up, host s of
    the chain, hint bytes, and the chain's result on the last stage."""
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor

    from alchemy_tpu_torch.parallel import dist as D
    from alchemy_tpu_torch.parallel.mesh import check_device_type
    from alchemy_tpu_torch.parallel.pipeline import make_pipeline_chain

    check_device_type(mesh.device_type)
    run = make_pipeline_chain(p, mesh, hints, mb=pipe[4], n_micro=pipe[3])
    x = distribute_tensor(cts.to(mesh.device_type), mesh, [Shard(0)], src_data_rank=None)
    run(x)                                                  # warm-up
    sync()
    reset_launches()
    D.reset_collectives()
    t0 = time.perf_counter()
    out = run(x)
    sync()
    wall = time.perf_counter() - t0
    hb, ha, _ = run._hint_args
    last = mesh.get_local_rank() == mesh.size() - 1
    return {"launches": launches(), "by_shape": shape_launches(), "wall_s": wall,
            "collectives": {f"{op}@{a}": c for (op, a), c in D.COLLECTIVES.items()},
            "staged": sum(D.STAGED_BYTES.values()),
            "hint_bytes": hb.numel() * 4 + ha.numel() * 4,
            "out": out.to_local()[0].cpu() if last else None}


def pipeline2_rank(pipe: tuple, qs, impl: str, hints, cts, device: str = "cuda") -> dict:
    """A rank of [pipeline] S=2: the stage mesh (2,) on the card over the
    world's gloo group; hints and ciphertexts come from the script's
    process (CPU tensors; each stage uploads its own levels)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from alchemy_tpu_torch.she import fast

    if device == "cuda":
        torch.cuda.set_device(0)
    p = fast.FastParams(n=1 << pipe[0], qs=tuple(qs), zp=2, impl=impl)
    mesh = init_device_mesh(device, (2,), mesh_dim_names=("stage",))
    return pipeline_run(mesh, p, hints, cts, pipe)


def pipeline_phase(card: str, world, device: str = "cuda") -> dict:
    """[pipeline]: make_pipeline_chain of PIPE (log2 n, L0 limbs, depth, M
    micro-batches of mb ciphertexts): S = 1 on the one-rank world of
    [dist] in the "pallas" order (kernels A, B, 5, 6) and in the "mxu"
    order (A, B, 8, 9), then S = 2 in the "mxu" order on the two gloo ranks
    of `world`, sharing the card. Each is bit-identical to the sequential
    chain of fast.mul_relin + fast.rescale (S = 2 also to S = 1), the
    padded rows stay zero, and the last level decrypts to the squaring
    chain."""
    from dataclasses import replace

    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from alchemy_tpu_torch.examples.deep_circuit import expected_square_chain_mod2
    from alchemy_tpu_torch.she import fast

    log_n, L0, depth, M, mb = PIPE
    stage = init_device_mesh(device, (1,), mesh_dim_names=("stage",))
    act = L0 - depth
    res = {}
    t0 = time.perf_counter()
    base = pipeline_inputs(PIPE, device)
    inputs_s = time.perf_counter() - t0
    for impl in ("pallas", "mxu"):
        inp = in_order(base, impl)
        p, cts = inp["p"], inp["cts"]
        t0 = time.perf_counter()
        cur = cts
        for pp, hb, ha in inp["ref"]:
            cur = fast.rescale(pp, fast.mul_relin(pp, cur, cur, hb, ha), 1)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        final = replace(inp["ref"][-1][0], qs=inp["ref"][-1][0].qs[:-1])
        key = fast._ntt_p(final, fast._residues(inp["s_int"], final.qs, device))
        for i, m in enumerate(inp["msgs"]):
            check(np.array_equal(fast.decrypt(final, key, cur[i]),
                                 expected_square_chain_mod2(m, p.n, depth)),
                  f"[pipeline] sequential chain decrypt {i}")
        r = pipeline_run(stage, p, inp["hints"], cts, PIPE)
        out = r["out"].to(cur.device)
        check(torch.equal(out[:, :, :act], cur) and not out[:, :, act:].any(),
              f"[pipeline] S=1 impl={impl} != the sequential chain")
        grid = grid_names(impl)
        check(all(r["launches"][k] > 0 for k in ("tensor_intt", "digit_relin", *grid)),
              f"[pipeline] S=1 impl={impl} launches {r['launches']}")
        r.update(seq_s=seq_s, out=out.cpu())
        res[f"S1 {impl}"] = r
        print(f"[pipeline] S=1 impl={impl} n=2^{log_n} depth={depth} L0={L0} "
              f"M={M} mb={mb}: bit-identical to the sequential chain ({seq_s:.2f} s), "
              f"{M * mb} products decrypt to the squaring chain; {r['wall_s']:.3f} s "
              f"per chain (host clock) on {card}; launches {r['launches']}", flush=True)
    t0 = time.perf_counter()
    hints_cpu = [(hb.cpu(), ha.cpu()) for hb, ha in inp["hints"]]
    ranks = world.run(pipeline2_rank, PIPE, p.qs, "mxu", hints_cpu, cts.cpu(), device)
    s2_s = time.perf_counter() - t0
    out2 = ranks[1]["out"]
    check(torch.equal(out2, res["S1 mxu"]["out"]), "[pipeline] S=2 != S=1")
    tot = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    by_shape = {}
    for r in ranks:
        for k, c in r["by_shape"].items():
            by_shape[k] = by_shape.get(k, 0) + c
    check(all(r["launches"]["tensor_intt"] > 0 and r["launches"]["digit_relin"] > 0
              for r in ranks), f"[pipeline] S=2 launches {[r['launches'] for r in ranks]}")
    res["S2 mxu"] = {"launches": tot, "by_shape": by_shape, "ranks": ranks, "call_s": s2_s,
                     "wall_s": max(r["wall_s"] for r in ranks)}
    print(f"[pipeline] S=2 impl=mxu, two gloo ranks on one card: bit-identical to S=1; "
          f"{res['S2 mxu']['wall_s']:.3f} s per chain (host clock, slower stage) on {card}; "
          f"hint bytes per rank {[r['hint_bytes'] for r in ranks]} (S=1: "
          f"{res['S1 mxu']['hint_bytes']}); collectives per rank "
          f"{[r['collectives'] for r in ranks]}; host staging by the comm helpers "
          f"{[r['staged'] for r in ranks]} bytes; launches per rank "
          f"{[r['launches'] for r in ranks]}; inputs {inputs_s:.1f} s, S=2 call {s2_s:.1f} s",
          flush=True)
    return res


def scaling_rank(anchors, device: str = "cuda"):
    """`bench_scaling.sweep` at the JAX package's defaults (log_n 12, 4
    limbs, batch 2) on the ranks of the running world: its JSON dict on rank
    0, None elsewhere. anchors None: rank 0 measures them on its card."""
    import torch
    import torch.distributed as dist

    from alchemy_tpu_torch.parallel import bench_scaling

    if device == "cuda" and dist.get_backend() == "gloo":
        torch.cuda.set_device(0)
    out = bench_scaling.sweep(device_type=device, anchors=anchors)
    return out if dist.get_rank() == 0 else None


def print_scaling(tag: str, out: dict) -> None:
    """One [scaling] line: the sweep's JSON dict."""
    print(f"[scaling] {tag}: {json.dumps(out)}", flush=True)


def jitmesh4_rank(device: str = "cuda") -> dict:
    """A rank of `--cards 4`, [jitmesh4]: HomomRLWR's program (built on this
    rank's card at EXAMPLE_SEEDS) through `jit_compile` single-device and on
    the ('limb', 'coeff') mesh (2, 2) over NCCL, one CUDA graph per rank:
    whether this rank's blocks equal the single-device result's, the
    gathered result decrypts, the bytes of both, the collectives and the
    call's host and event ms."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from alchemy_tpu_torch.backend.torch_backend import TorchBackend
    from alchemy_tpu_torch.interp.jit_exec import jit_compile

    st = example_steps("HomomRLWR", TorchBackend(device))
    compiled, inputs = st["compiled"], st["inputs"]
    single = jit_compile(compiled, inputs)
    ref = single(*inputs)
    mesh = init_device_mesh(device, (2, 2), mesh_dim_names=("limb", "coeff"))
    j, build_ms = host_ms(lambda: jit_compile(compiled, inputs, mesh=mesh))
    got = j(*inputs)
    li, ci = mesh.get_local_rank("limb"), mesh.get_local_rank("coeff")
    ok = all(torch.equal(c.data.local, mesh_block(r.data, (2, 2), li, ci))
             for c, r in zip(got.comps, ref.comps))
    decrypts = compiled.decrypt(j.gather(got)).equals(st["want"])
    fn = lambda: j(*inputs)
    sync()
    t0 = time.perf_counter()
    for _ in range(JIT_CALLS):
        fn()
    sync()
    return {"graph": j.graph is not None, "blocks_equal": ok, "decrypts": decrypts,
            "bytes": j.arg_bytes(), "single_bytes": single.arg_bytes(), "build_ms": build_ms,
            "collectives": {f"{op}@{axis}": c for (op, axis), c in j.collectives.items()},
            "host_ms": (time.perf_counter() - t0) * 1e3 / JIT_CALLS,
            "event_ms": device_ms(fn, JIT_CALLS) if device == "cuda" else 0.0}


def cards4_rank(headline: tuple, deep: tuple, pipe: tuple, device: str = "cuda") -> dict:
    """A rank of `--cards 4`: `dist_checks` on the mesh (1, 2, 2) ('limb'
    and 'coeff' across cards), then the pipelined chain of `pipe` with
    S = 4 in the "mxu" order; the last stage holds it against the
    sequential chain and decrypts it. Returns this rank's readings."""
    from dataclasses import replace

    import numpy as np
    import torch
    import torch.distributed
    from torch.distributed.device_mesh import init_device_mesh

    from alchemy_tpu_torch.examples.deep_circuit import expected_square_chain_mod2
    from alchemy_tpu_torch.parallel.mesh import make_mesh
    from alchemy_tpu_torch.she import fast

    card = torch.cuda.get_device_name() if device == "cuda" else "cpu"
    rank = torch.distributed.get_rank()
    d = dist_checks(np.random.default_rng(SEED), card, make_mesh((1, 2, 2), device), device,
                    "[dist4]", headline, deep)
    inp = in_order(pipeline_inputs(pipe, device), "mxu")
    r = pipeline_run(init_device_mesh(device, (4,), mesh_dim_names=("stage",)), inp["p"],
                     inp["hints"], inp["cts"], pipe)
    if rank == 3:
        cur = inp["cts"]
        for pp, hb, ha in inp["ref"]:
            cur = fast.rescale(pp, fast.mul_relin(pp, cur, cur, hb, ha), 1)
        act = pipe[1] - pipe[2]
        out = r["out"].to(cur.device)
        check(torch.equal(out[:, :, :act], cur) and not out[:, :, act:].any(),
              "[pipeline4] S=4 != the sequential chain")
        final = replace(inp["ref"][-1][0], qs=inp["ref"][-1][0].qs[:-1])
        key = fast._ntt_p(final, fast._residues(inp["s_int"], final.qs, device))
        for i, m in enumerate(inp["msgs"]):
            check(np.array_equal(fast.decrypt(final, key, cur[i]),
                                 expected_square_chain_mod2(m, inp["p"].n, pipe[2])),
                  f"[pipeline4] decrypt {i}")
    r.pop("out")
    r.pop("by_shape")
    return {"card": card, "dist": {k: v for k, v in d.items() if isinstance(v, dict)},
            "pipeline": r}


def cards4() -> int:
    """`python3 chip_smoke.py --cards 4`, on a host with four cards: four
    NCCL ranks, one a card, run [dist4] (the [dist] checks on the mesh
    (1, 2, 2)) and [pipeline4] (PIPE with S = 4, "mxu"); prints the readings
    and the contract's last line with count 4."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("chip_smoke --cards 4: needs four CUDA devices", file=sys.stderr)
        return 1
    from alchemy_tpu_torch.backend.cuda import build
    from alchemy_tpu_torch.parallel.multihost import LocalWorld

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.library()
    t0 = time.perf_counter()
    with LocalWorld(4, backend="nccl", timeout=RANK_TIMEOUT_S) as world:
        ranks = world.run(cards4_rank, HEADLINE, DEEP, PIPE)
        jm = world.run(jitmesh4_rank)
        scaling = world.run(scaling_rank, None)[0]
    for i, r in enumerate(jm):
        check(r["graph"] and r["blocks_equal"] and r["decrypts"] and r["collectives"],
              f"[jitmesh4] rank {i}: {r}")
        held, single = r["bytes"], r["single_bytes"]
        check(held["args"] + held["hints"] < (single["args"] + single["hints"]) / 2,
              f"[jitmesh4] rank {i} holds {held} of {single}")
    print(f"[jitmesh4] HomomRLWR on the mesh (2, 2), four NCCL ranks, one CUDA graph each "
          f"(built in {[round(r['build_ms'] / 1e3, 3) for r in jm]} s): every rank's blocks "
          f"bit-identical to the single-device graph's output, the gathered result decrypts to "
          f"the plaintext; bytes (args + hints) per rank "
          f"{[r['bytes']['args'] + r['bytes']['hints'] for r in jm]} against "
          f"{jm[0]['single_bytes']['args'] + jm[0]['single_bytes']['hints']} single-device; "
          f"collectives per call {jm[0]['collectives']}; per call over {JIT_CALLS}: host ms "
          f"{[round(r['host_ms'], 3) for r in jm]}, CUDA events ms "
          f"{[round(r['event_ms'], 3) for r in jm]}", flush=True)
    print_scaling("four NCCL ranks, one a card (points on 1, 2 and 4)", scaling)
    Bt = HEADLINE[2]
    d = ranks[0]["dist"]
    print(f"[summary] four NCCL ranks, one a card, {time.perf_counter() - t0:.1f} s: [dist4] mesh "
          f"(1, 2, 2) ops/s (host clock): mul_relin digit a2a "
          f"{Bt * 1e3 / d['mul_relin digit a2a']['ms']:.1f}, ring "
          f"{Bt * 1e3 / d['mul_relin digit ring']['ms']:.1f}, row a2a "
          f"{Bt * 1e3 / d['mul_relin row a2a']['ms']:.1f}, hybrid "
          f"{Bt * 1e3 / d['mul_relin_hybrid']['ms']:.1f}, rescale {d['rescale']['ms']:.2f} ms; "
          f"[pipeline4] S=4 mxu {max(r['pipeline']['wall_s'] for r in ranks):.3f} s per chain, "
          f"hint bytes per rank {[r['pipeline']['hint_bytes'] for r in ranks]}, launches per rank "
          f"{[r['pipeline']['launches'] for r in ranks]}, collectives per rank "
          f"{[r['pipeline']['collectives'] for r in ranks]}; cards {[r['card'] for r in ranks]}",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": ranks[0]["card"],
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def shape_report(tag: str, runs: dict, rng, clock_hz: float, names, phase, extra) -> dict:
    """Kernels names(order) at every shape a path launched them with and at
    extra(order), per (log2 n, order) of runs ({tag: result} of the paths
    that ran there), checked and timed by phase(log2 n, order, shapes, rng),
    with each path's launches by shape ("by_path") and bound. Prints each
    kernel's shapes and its ranking, launches x (ms - bound) summed over its
    shapes and the paths. Returns {(log2 n, order): {key: record}}, keys
    (name, *shape without n)."""
    out = {}
    for (log_n, order), paths in runs.items():
        by_path = {}
        for path, r in paths.items():
            for key, c in r["by_shape"].items():
                if key[-1] == 1 << log_n and key[0] in names(order):
                    by_path.setdefault(key[:-1], {})[path] = c
        res = phase(log_n, order, extra(order) | set(by_path), rng)
        for key, r in res.items():
            r["by_path"] = by_path.get(key, {})
            r["launches"] = sum(r["by_path"].values())
            r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["muls"], clock_hz)
        out[log_n, order] = res
        for name in names(order):
            mine = sorted((k, r) for k, r in res.items() if k[0] == name)
            loss, graph_loss = (sum(r["launches"] * (r[key] - r["bound_ms"]) for _, r in mine)
                                for key in ("ms", "graph_ms"))
            print(f"[{tag}] n=2^{log_n} order={order} {name}: errors 0 at {len(mine)} shapes; "
                  f"launches over the paths {sum(r['launches'] for _, r in mine)}, sum of "
                  f"launches x (ms - bound) {loss:.4f} ms, x (graph_ms - bound) "
                  f"{graph_loss:.4f} ms; shape:launches@ms/graph_ms/bound_ms " + " ".join(
                      f"{list(k[1:])}:{r['launches']}@{r['ms']:.4f}/{r['graph_ms']:.4f}/"
                      f"{r['bound_ms']:.4f}" for k, r in mine), flush=True)
    return out


def grid_report(runs: dict, rng, clock_hz: float) -> dict:
    """Kernels 5, 6, 8 and 9 at every shape a path launched them with and at
    GRID_SHAPES (shape_report, `[grid]` lines); also checks GRID_SHAPES at
    n = 2^14."""
    for order in ORDERS:
        grid_shape_phase(SMALL[0], order, representative_shapes(order), rng, reps=0)
    grid = shape_report("grid", runs, rng, clock_hz, grid_names, grid_shape_phase,
                        representative_shapes)
    print(f"[grid] GRID_SHAPES at n=2^{SMALL[0]} in every order: errors 0", flush=True)
    return grid


# (Bt, L) of kernel A and (G, L, K) of kernel 7 at the shapes the paths give
# them besides the deep chain's: mul_relin at the headline and at L = 16 (the
# hybrid op), the hybrid op's joint rescale of its 16 products
FUSED_SHAPES = {("tensor_intt", 16, 8), ("tensor_intt", 16, 16), ("rescale_fwd", 32, 16, 4)}


def fused_inputs(log_n: int, key: tuple, rng, order: str):
    """(kernel call, plain call) of kernel A ("tensor_intt", Bt, L) or 7
    ("rescale_fwd", G, L, K) on random canonical inputs at n = 2^log_n, in a
    slot order; 7's inputs are made as rescale_joint makes them."""
    import torch

    from alchemy_tpu_torch.backend.cuda import mul_relin as mr
    from alchemy_tpu_torch.backend.cuda import rescale as rk
    from alchemy_tpu_torch.backend.modarith import garner_digits, narrow, widen
    from alchemy_tpu_torch.she import fast, hybrid

    n = 1 << log_n
    if key[0] == "tensor_intt":
        _, Bt, L = key
        qs = fast.FastParams.make(log_n, L).qs
        args = (n, qs, random_residues(rng, qs, (Bt, 2, L, n)).cuda(),
                random_residues(rng, qs, (Bt, 2, L, n)).cuda(), order)
        return lambda: mr.tensor_intt(*args), lambda: mr.tensor_intt_plain(*args)
    _, G, L, K = key
    chain = fast.FastParams.make(log_n, L + K).qs
    coeff = random_residues(rng, chain, (G, L + K, n)).cuda()
    xs = garner_digits(widen(coeff[:, L:]), chain[L:])
    is_neg, t, t_neg = hybrid._sign_terms(xs, chain[L:], 2)
    args = (n, chain[:L], chain[L:], 2, coeff, narrow(torch.stack(xs, dim=1)),
            is_neg.to(torch.int32), narrow(t), t_neg.to(torch.int32), order)
    return lambda: rk.rescale_fwd(*args), lambda: rk.rescale_fwd_plain(*args)


def fused_shape_phase(log_n: int, order: str, shapes, rng, reps: int = 20) -> dict:
    """Kernels A and 7 against their plain versions at each shape of shapes
    (("tensor_intt", Bt, L) or ("rescale_fwd", G, L, K)) in a slot order;
    with reps > 0 each is timed, launched one by one (ms) and from a CUDA
    graph (graph_ms), and so is its plain version (plain_ms). Returns {key:
    {"err", "bytes", "muls"[, "ms", "graph_ms", "plain_ms"]}}."""
    import torch

    n = 1 << log_n
    res = {}
    for key in sorted(shapes):
        kern, plain = fused_inputs(log_n, key, rng, order)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            err = max(max_abs_err(a, b) for a, b in zip(got, want))
        else:
            err = max_abs_err(got, want)
        check(err == 0, f"{key[0]} != plain at n=2^{log_n} order={order} on {list(key[1:])} "
                        f"(max abs err {err})")
        cost = tensor_cost(*key[1:], n) if key[0] == "tensor_intt" else rescale_cost(*key[1:], n)
        r = res[key] = {"err": err, "bytes": cost[0], "muls": cost[1]}
        if reps:
            r["ms"] = device_ms(kern, reps)
            r["graph_ms"] = graph_ms(kern, reps)
            r["plain_ms"] = device_ms(plain, 3)
        del got, want, kern, plain
    return res


def fused_report(runs: dict, rng, clock_hz: float) -> dict:
    """Kernels A and 7 at every shape a path launched them with and at
    FUSED_SHAPES (shape_report, `[fused]` lines); also checks them at
    n = 2^14 in both orders."""
    small = {("tensor_intt", 4, 4), ("tensor_intt", 1, 5), ("rescale_fwd", 2, 5, 3),
             ("rescale_fwd", 4, 4, 2)}
    for order in ORDERS:
        fused_shape_phase(SMALL[0], order, small, rng, reps=0)
    fused = shape_report("fused", runs, rng, clock_hz, lambda order: ("tensor_intt", "rescale_fwd"),
                         fused_shape_phase, lambda order: FUSED_SHAPES)
    print(f"[fused] A and 7 at n=2^{SMALL[0]} in every order: errors 0", flush=True)
    return fused


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from alchemy_tpu_torch.backend.cuda import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    card = torch.cuda.get_device_name(0)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    clock_hz = clock_mhz * 1e6
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {card}; "
          f"bounds at {clock_mhz:.0f} MHz (max SM clock), {HBM_BYTES_PER_S / 1e12} TB/s",
          flush=True)
    t0 = time.perf_counter()
    so = build.library_path()
    build.library()
    print(f"[build] {so.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}", flush=True)

    rng = np.random.default_rng(SEED)
    head = kernel_phase(*HEADLINE, rng, timed=True)
    head_mxu = kernel_phase(*HEADLINE, rng, timed=True, order="mxu")   # A and B in the 2-factor order
    small = kernel_phase(*SMALL, rng, timed=False)
    deep_k = hybrid_kernel_phase(*DEEP, rng, timed=True)
    small_k = hybrid_kernel_phase(*SMALL_HYBRID, rng, timed=False)
    big = kernel_phase(*N2E16, rng, timed=True)
    # 5/6/8/9 at the paths' shapes: checked and timed by grid_report
    big_small = {**kernel_phase(*SMALL_N2E16, rng, timed=False),
                 **grid_kernel_phase(*SMALL_N2E16, rng)}
    mxu_small = {**grid_kernel_phase(*SMALL_N2E16, rng, order="mxu"),
                 **hybrid_kernel_phase(*SMALL_HYBRID, rng, timed=False, order="mxu")}
    h16_k = hybrid_kernel_phase(*HYBRID16, rng, timed=True)
    h16_small = hybrid_kernel_phase(*SMALL_HYBRID16, rng, timed=False)
    vpu = vpu_checks(rng)
    mp = main_path(rng, card, HEADLINE, "main", "pallas")
    mp16 = main_path(rng, card, N2E16, "n2e16", "pallas")
    hy = hybrid_path(rng, card, DEEP, "hybrid", trivgad=True)
    dp = deep_path(card, "deep", "pallas")
    mx = main_path(rng, card, HEADLINE, "mxu", "mxu")
    mxd = deep_path(card, "mxu", "mxu")
    h16 = hybrid_path(rng, card, HYBRID16, "hybrid16", trivgad=False)
    rs = resume_phase(card)
    print(f"[resume] uninterrupted depth-{DEEP_DEPTH} chain in the vpu order: {rs['wall_s']:.2f} s "
          f"(host clock) against [deep] pallas {dp['wall_s']:.2f} s and mxu {mxd['wall_s']:.2f} s",
          flush=True)
    # after the paths: run before them, it slowed their host-bound
    # readings ([main], [deep]; PERF.md)
    nat = native_phase(rng)
    from alchemy_tpu_torch.backend import get_backend

    she_bk = get_backend("torch")
    check(she_bk.device.type == "cuda", f"[she] the torch backend is on {she_bk.device}")
    she_phase(get_backend("checked"), she_bk, card)
    ex = examples_phase(get_backend("checked"), she_bk, card)
    jit = jit_phase(ex["steps"], she_bk, card)
    checkpoint_phase(ex["steps"]["HomomRLWR"], she_bk)
    dist = dist_phase(rng, card)
    from alchemy_tpu_torch.parallel import bench_scaling
    from alchemy_tpu_torch.parallel.multihost import LocalWorld

    t0 = time.perf_counter()
    with LocalWorld(2, backend="gloo", timeout=RANK_TIMEOUT_S) as pair:
        print(f"[dist2] two gloo ranks started in {time.perf_counter() - t0:.1f} s", flush=True)
        dist2 = dist2_phase(dist, card, pair)
        pl = pipeline_phase(card, pair)
        # the mesh half of jit_compile and the scaling sweep run after the
        # mesh path's phases, so that [dist] meets the process as it did
        # before them (one NCCL group, made by dist_phase)
        jm2 = jitmesh2_phase(jit, card, pair)
        anchors = bench_scaling.measure_anchors()
        scaling = {"two gloo ranks sharing the card": pair.run(scaling_rank, anchors)[0]}
    jm = jitmesh_phase(ex["steps"], jit, card)
    scaling["one NCCL rank"] = scaling_rank(anchors)
    import torch.distributed

    torch.distributed.destroy_process_group()
    # kernels A and B at the pipeline's shape [mb, L0, n] in both orders
    pipe_k = {order: kernel_phase(PIPE[0], PIPE[1], PIPE[4], rng, timed=True, order=order)
              for order in ("pallas", "mxu")}
    runs = {(HEADLINE[0], "pallas"): {"main": mp, "hybrid": hy, "deep": dp,
                                      "pipeline": pl["S1 pallas"]},
            (N2E16[0], "pallas"): {"n2e16": mp16, "hybrid16": h16},
            (HEADLINE[0], "mxu"): {"mxu": mx, "mxu deep": mxd, "pipeline": pl["S1 mxu"],
                                   "pipeline S=2": pl["S2 mxu"]},
            (N2E16[0], "mxu"): {}, (HEADLINE[0], "vpu"): {"resume": rs}}
    grid = grid_report(runs, rng, clock_hz)
    fused = fused_report(runs, rng, clock_hz)

    def entry(name, n, replaces, source, launched, timed, *checked, order="pallas"):
        """One kernel's line at one slot order: times and bound from the
        timed phase's dict, the largest error over every phase that checked
        it."""
        ms_bound, by = bound(timed["bytes"], timed["muls"], clock_hz)
        errs = [r[k]["err"] for r in checked for k in r if k.startswith(name)]
        return {"name": name, "n": n, "order": order, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched, "max_abs_err": max(errs),
                "ms": timed["ms"], "plain_ms": timed["plain_ms"], "bound_ms": ms_bound,
                "bound_by": by, "library_ms": None}

    n15, n16 = 1 << HEADLINE[0], 1 << N2E16[0]
    mr_tpu, rs_tpu, ntt_tpu = MUL_RELIN_TPU + ":", RESCALE_TPU + ":", NTT_TPU + ":"
    by_shape_tpu = {"intt_grid": (rs_tpu + "52", RESCALE_CU),
                    "ntt_grid": (rs_tpu + "142", RESCALE_CU),
                    "ntt2_grid": (ntt_tpu + "211", RESCALE_CU),
                    "intt2_grid": (ntt_tpu + "232", RESCALE_CU),
                    "tensor_intt": (mr_tpu + "232", MUL_RELIN_CU),
                    "rescale_fwd": (rs_tpu + "206", RESCALE_CU),
                    "ntt_vpu_grid": (VPU_NTT + ":149", RESCALE_CU),
                    "intt_vpu_grid": (VPU_NTT + ":173", RESCALE_CU)}
    # kernels 5, 6, 8, 9, A and 7: one entry per shape a path launched (5, 6,
    # 8, 9 [G, T, n]; A [Bt, L, n]; 7 [G, L, K, n]); `launches` is the count
    # of the path that launched it most
    shape_entries = [
        {"name": key[0], "n": 1 << log_n, "order": order, "shape": [*key[1:], 1 << log_n],
         "route": "cuda", "source": by_shape_tpu[key[0]][1],
         "replaces": by_shape_tpu[key[0]][0], "path": top, "launches": r["by_path"][top],
         "launches_by_path": r["by_path"], "max_abs_err": r["err"], "ms": r["ms"],
         "graph_ms": r["graph_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None}
        for table in (grid, fused) for (log_n, order), res in table.items()
        for key, r in sorted(res.items())
        if r["by_path"] for top in [max(r["by_path"], key=r["by_path"].get)]]
    kernels = [
        entry("tensor_intt", n15, mr_tpu + "232", MUL_RELIN_CU, mp["launches"]["tensor_intt"],
              head["tensor_intt"], head, small),
        entry("tensor_intt", n15, mr_tpu + "232", MUL_RELIN_CU, mx["launches"]["tensor_intt"],
              head_mxu["tensor_intt"], head_mxu, order="mxu"),
        entry("digit_relin", n15, mr_tpu + "439", MUL_RELIN_CU, mp["launches"]["digit_relin"],
              head["digit_relin"], head, small),
        entry("digit_relin", n15, mr_tpu + "439", MUL_RELIN_CU, mx["launches"]["digit_relin"],
              head_mxu["digit_relin"], head_mxu, order="mxu"),
        entry("hybrid_digit_relin", n15, mr_tpu + "807", MUL_RELIN_CU,
              hy["launches"]["hybrid_digit_relin"], deep_k["hybrid_digit_relin"], deep_k, small_k,
              mxu_small),
        entry("rescale_fwd", n15, rs_tpu + "206", RESCALE_CU, hy["launches"]["rescale_fwd"],
              deep_k["rescale_fwd"], deep_k, small_k, mxu_small),
        entry("tensor_intt", n16, mr_tpu + "232", MUL_RELIN_CU, mp16["launches"]["tensor_intt"],
              big["tensor_intt"], big, big_small),
        entry("digit_relin", n16, mr_tpu + "319", MUL_RELIN_CU, mp16["launches"]["digit_relin"],
              big["digit_relin"], big, big_small),
        entry("hybrid_digit_relin", n16, mr_tpu + "807", MUL_RELIN_CU,
              h16["launches"]["hybrid_digit_relin"], h16_k["hybrid_digit_relin"], h16_k, h16_small),
        entry("rescale_fwd", n16, rs_tpu + "206", RESCALE_CU, h16["launches"]["rescale_fwd"],
              h16_k["rescale_fwd"], h16_k, h16_small),
        entry("hybrid_digit_relin", n15, mr_tpu + "807", MUL_RELIN_CU,
              rs["launches"]["hybrid_digit_relin"], vpu["deep"]["hybrid_digit_relin"],
              vpu["deep"], vpu["hybrid_small"], order="vpu"),
        entry("rescale_fwd", n15, rs_tpu + "206", RESCALE_CU, rs["launches"]["rescale_fwd"],
              vpu["deep"]["rescale_fwd"], vpu["deep"], vpu["hybrid_small"], order="vpu"),
        *shape_entries,
        *[{**entry("digit_relin", 1 << PIPE[0], mr_tpu + "439", MUL_RELIN_CU,
                   by_path["pipeline"], pipe_k[order]["digit_relin_raw"], pipe_k[order],
                   order=order),
           "shape": [PIPE[4], PIPE[1], 1 << PIPE[0]], "path": "pipeline",
           "launches_by_path": by_path}
          for order, by_path in (
              ("pallas", {"pipeline": pl["S1 pallas"]["launches"]["digit_relin"]}),
              ("mxu", {"pipeline": pl["S1 mxu"]["launches"]["digit_relin"],
                       "pipeline S=2": pl["S2 mxu"]["launches"]["digit_relin"]}))],
    ]
    # the C++ oracle's check of A, B, 5 and 6 in the vpu order ([native])
    oracle = {"tensor_intt": nat["mul_relin"], "digit_relin": nat["mul_relin"],
              "ntt_vpu_grid": nat["ntt_vpu_grid"], "intt_vpu_grid": nat["intt_vpu_grid"]}
    for k in kernels:
        if k["order"] == "vpu" and k["name"] in oracle:
            o = oracle[k["name"]]
            k["oracle"] = {"source": NATIVE_CPP, "checked_shape": o["shape"],
                           "max_abs_err": o["err"], "cpu_ms": o["cpu_ms"], "card_ms": o["ms"]}
    for tag, out in scaling.items():
        print_scaling(tag, out)
    h2 = jm2["(2, 1)", "HomomRLWR"]
    print(f"[summary] mul_relin ops/s (host clock): main {mp['ops_per_s']:.1f}, "
          f"n2e16 {mp16['ops_per_s']:.1f}, mxu {mx['ops_per_s']:.1f}; mul_relin_hybrid raw: "
          f"hybrid {hy['raw'][0]:.1f}, hybrid16 {h16['raw'][0]:.1f}; deep circuit s: pallas "
          f"{dp['wall_s']:.2f}, mxu {mxd['wall_s']:.2f}, vpu {rs['wall_s']:.2f}; [resume] after "
          f"SIGKILL: PASS; [jit] HomomRLWR replay {jit['HomomRLWR']['host_ms']:.3f} ms host, "
          f"{jit['HomomRLWR']['event_ms']:.3f} ms events against eager "
          f"{jit['HomomRLWR']['eager_ms']:.3f} ms host; [jitmesh] HomomRLWR mesh (1, 1) "
          f"{jm['HomomRLWR']['host_ms']:.3f} ms host, {jm['HomomRLWR']['event_ms']:.3f} ms "
          f"events, two gloo ranks mesh (2, 1) {max(r['ms'] for r in h2):.1f} ms host; "
          f"[dist] one NCCL rank ops/s (host "
          f"clock): mul_relin digit a2a {HEADLINE[2] * 1e3 / dist['mul_relin digit a2a']['ms']:.1f}, "
          f"row a2a {HEADLINE[2] * 1e3 / dist['mul_relin row a2a']['ms']:.1f}, hybrid "
          f"{HEADLINE[2] * 1e3 / dist['mul_relin_hybrid']['ms']:.1f}, rescale "
          f"{dist['rescale']['ms']:.2f} ms; [dist2] two gloo ranks, mul_relin ops/s: mesh (1, 1, 2) "
          f"{HEADLINE[2] * 1e3 / dist2['(1, 1, 2)']['ms']:.1f}, (1, 2, 1) "
          f"{HEADLINE[2] * 1e3 / dist2['(1, 2, 1)']['ms']:.1f}; [pipeline] s per depth-"
          f"{PIPE[2]} chain of {PIPE[3] * PIPE[4]} ciphertexts: S=1 pallas "
          f"{pl['S1 pallas']['wall_s']:.3f}, S=1 mxu {pl['S1 mxu']['wall_s']:.3f}, S=2 mxu "
          f"{pl['S2 mxu']['wall_s']:.3f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(cards4() if sys.argv[1:] == ["--cards", "4"] else main())
