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
# (G, T) of the standalone transforms on [G, T, n] at the shapes the paths give
# them. Forward (6/8): keygen, hints and encrypt at L = 8; the hybrid hint over
# T = 20 limbs; the deep chain's rescale of one ciphertext; fast.rescale of a
# Bt = 16 batch. Inverse (5/9): decrypt; the deep chain's rescales; fast.rescale
# of the batch; rescale_joint of the hybrid op at Bt = 16.
GRID_SHAPES = {"forward": ((1, 8), (1, 20), (2, 16), (32, 7)),
               "inverse": ((1, 8), (2, 16), (32, 8), (32, 20))}
MUL_RELIN_TPU = "alchemy_tpu/backend/pallas/mul_relin_pallas.py"
RESCALE_TPU = "alchemy_tpu/backend/pallas/rescale_pallas.py"
NTT_TPU = "alchemy_tpu/backend/pallas/ntt_pallas.py"
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
    slot order: kernels 5 and 6, or 9 and 8."""
    return ("intt2_grid", "ntt2_grid") if order == "mxu" else ("intt_grid", "ntt_grid")


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
          and sum(seen[k] for k in (*grid_names("mxu"), *grid_names("pallas"))) ==
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
    for order in ("pallas", "mxu"):
        grid_shape_phase(SMALL[0], order, representative_shapes(order), rng, reps=0)
    grid = shape_report("grid", runs, rng, clock_hz, grid_names, grid_shape_phase,
                        representative_shapes)
    print(f"[grid] GRID_SHAPES at n=2^{SMALL[0]} in both orders: errors 0", flush=True)
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
    for order in ("pallas", "mxu"):
        fused_shape_phase(SMALL[0], order, small, rng, reps=0)
    fused = shape_report("fused", runs, rng, clock_hz, lambda order: ("tensor_intt", "rescale_fwd"),
                         fused_shape_phase, lambda order: FUSED_SHAPES)
    print(f"[fused] A and 7 at n=2^{SMALL[0]} in both orders: errors 0", flush=True)
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
    mp = main_path(rng, card, HEADLINE, "main", "pallas")
    mp16 = main_path(rng, card, N2E16, "n2e16", "pallas")
    hy = hybrid_path(rng, card, DEEP, "hybrid", trivgad=True)
    dp = deep_path(card, "deep", "pallas")
    mx = main_path(rng, card, HEADLINE, "mxu", "mxu")
    mxd = deep_path(card, "mxu", "mxu")
    h16 = hybrid_path(rng, card, HYBRID16, "hybrid16", trivgad=False)
    grid = grid_report({(HEADLINE[0], "pallas"): {"main": mp, "hybrid": hy, "deep": dp},
                        (N2E16[0], "pallas"): {"n2e16": mp16, "hybrid16": h16},
                        (HEADLINE[0], "mxu"): {"mxu": mx, "mxu deep": mxd},
                        (N2E16[0], "mxu"): {}}, rng, clock_hz)
    fused = fused_report({(HEADLINE[0], "pallas"): {"main": mp, "hybrid": hy, "deep": dp},
                          (N2E16[0], "pallas"): {"n2e16": mp16, "hybrid16": h16},
                          (HEADLINE[0], "mxu"): {"mxu": mx, "mxu deep": mxd},
                          (N2E16[0], "mxu"): {}}, rng, clock_hz)

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
                    "rescale_fwd": (rs_tpu + "206", RESCALE_CU)}
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
        *shape_entries,
    ]
    print(f"[summary] mul_relin ops/s (host clock): main {mp['ops_per_s']:.1f}, "
          f"n2e16 {mp16['ops_per_s']:.1f}, mxu {mx['ops_per_s']:.1f}; mul_relin_hybrid raw: "
          f"hybrid {hy['raw'][0]:.1f}, hybrid16 {h16['raw'][0]:.1f}; deep circuit s: pallas "
          f"{dp['wall_s']:.2f}, mxu {mxd['wall_s']:.2f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
