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
                         "eager_ms": sum(host_ms(eager)[1] for _ in range(3)) / 3}
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
    from alchemy_tpu_torch.backend import get_backend

    she_bk = get_backend("torch")
    check(she_bk.device.type == "cuda", f"[she] the torch backend is on {she_bk.device}")
    she_phase(get_backend("checked"), she_bk, card)
    ex = examples_phase(get_backend("checked"), she_bk, card)
    jit = jit_phase(ex["steps"], she_bk, card)
    checkpoint_phase(ex["steps"]["HomomRLWR"], she_bk)
    runs = {(HEADLINE[0], "pallas"): {"main": mp, "hybrid": hy, "deep": dp},
            (N2E16[0], "pallas"): {"n2e16": mp16, "hybrid16": h16},
            (HEADLINE[0], "mxu"): {"mxu": mx, "mxu deep": mxd},
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
    ]
    print(f"[summary] mul_relin ops/s (host clock): main {mp['ops_per_s']:.1f}, "
          f"n2e16 {mp16['ops_per_s']:.1f}, mxu {mx['ops_per_s']:.1f}; mul_relin_hybrid raw: "
          f"hybrid {hy['raw'][0]:.1f}, hybrid16 {h16['raw'][0]:.1f}; deep circuit s: pallas "
          f"{dp['wall_s']:.2f}, mxu {mxd['wall_s']:.2f}, vpu {rs['wall_s']:.2f}; [resume] after "
          f"SIGKILL: PASS; [jit] HomomRLWR replay {jit['HomomRLWR']['host_ms']:.3f} ms host, "
          f"{jit['HomomRLWR']['event_ms']:.3f} ms events against eager "
          f"{jit['HomomRLWR']['eager_ms']:.3f} ms host", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
