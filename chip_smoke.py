#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (alchemy_tpu_torch) on one GPU.

Builds CUDA kernels A (tensor_intt) and B (digit_relin) from the sources in
the checkout, holds each against its plain PyTorch version on the card, and
drives BGV multiply + relinearize at the headline configuration (n = 2^15,
L = 8 limbs of ~30 bits, zp = 2, Shoup hint pairs, batches of 16
ciphertexts) through them: keygen, relin_hint, encrypt, mul_relin, decrypt
and rescale. Every check is exact equality. Any failure exits non-zero; the
last line of a passing run is one JSON object naming the device.

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
TPU_KERNEL_FILE = "alchemy_tpu/backend/pallas/mul_relin_pallas.py"
KERNEL_SOURCE = "alchemy_tpu_torch/backend/cuda/csrc/mul_relin.cu"


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


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item())


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


def kernel_phase(log_n: int, L: int, Bt: int, rng, timed: bool) -> dict:
    """Kernels A and B against their plain versions on random canonical
    inputs at one shape; returns the errors and device times."""
    import torch

    from alchemy_tpu_torch.backend.cuda import mul_relin as mr
    from alchemy_tpu_torch.she import fast

    p = fast.FastParams.make(log_n, L)
    n, qs = p.n, p.qs
    ct_a = random_residues(rng, qs, (Bt, 2, L, n)).cuda()
    ct_b = random_residues(rng, qs, (Bt, 2, L, n)).cuda()
    hints = [fast.shoup_precompute(random_residues(rng, qs, (L, L, n)).cuda(), qs)
             for _ in range(2)]
    ka = mr.tensor_intt(n, qs, ct_a, ct_b)
    torch.cuda.synchronize()
    pa = mr.tensor_intt_plain(n, qs, ct_a, ct_b)
    torch.cuda.synchronize()
    err_a = max(max_abs_err(x, y) for x, y in zip(ka, pa))
    check(err_a == 0, f"kernel A != plain at n=2^{log_n} L={L} Bt={Bt} (max abs err {err_a})")
    kb = mr.digit_relin(n, qs, *ka, *hints)
    torch.cuda.synchronize()
    pb = mr.digit_relin_plain(n, qs, *ka, *hints)
    torch.cuda.synchronize()
    err_b = max_abs_err(kb, pb)
    check(err_b == 0, f"kernel B != plain at n=2^{log_n} L={L} Bt={Bt} (max abs err {err_b})")
    res = {"err_a": err_a, "err_b": err_b}
    if timed:
        res["ms_a"] = device_ms(lambda: mr.tensor_intt(n, qs, ct_a, ct_b), 20)
        res["plain_ms_a"] = device_ms(lambda: mr.tensor_intt_plain(n, qs, ct_a, ct_b), 3)
        res["ms_b"] = device_ms(lambda: mr.digit_relin(n, qs, *ka, *hints), 20)
        res["plain_ms_b"] = device_ms(lambda: mr.digit_relin_plain(n, qs, *ka, *hints), 3)
    print(f"[kernels] n=2^{log_n} L={L} Bt={Bt}: A and B bit-identical to plain "
          + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in res.items()), flush=True)
    return res


def main_path(rng, card: str) -> dict:
    """The port's main path at the headline configuration."""
    import numpy as np
    import torch

    from alchemy_tpu_torch.backend.cuda import mul_relin as mr
    from alchemy_tpu_torch.she import fast

    log_n, L, Bt = HEADLINE
    t0 = time.perf_counter()
    p = fast.FastParams.make(log_n, L, zp=2)
    s = fast.keygen(p, rng, device="cuda")
    hb, ha = fast.relin_hint(p, s, rng, shoup=True)
    m1 = rng.integers(0, p.zp, (Bt, p.n))
    m2 = rng.integers(0, p.zp, (Bt, p.n))
    ct_a = torch.stack([fast.encrypt(p, s, m, rng) for m in m1])
    ct_b = torch.stack([fast.encrypt(p, s, m, rng) for m in m2])
    torch.cuda.synchronize()
    print(f"[setup] keygen + relin_hint + {2 * Bt} encrypts: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    mr.reset_launches()
    out = fast.mul_relin(p, ct_a, ct_b, hb, ha)
    torch.cuda.synchronize()
    launches = dict(mr.LAUNCHES)
    check(all(v > 0 for v in launches.values()), f"kernel launches on the main path: {launches}")
    check(tuple(out.shape) == (Bt, 2, L, p.n), f"mul_relin shape {tuple(out.shape)}")
    ref = mr.digit_relin_plain(p.n, p.qs, *mr.tensor_intt_plain(p.n, p.qs, ct_a, ct_b), hb, ha)
    check(torch.equal(out, ref), "mul_relin through the kernels != plain path")
    print(f"[main] mul_relin Bt={Bt}: launches {launches}, bit-identical to the plain path",
          flush=True)

    want = [negacyclic_mod2(a, b) for a, b in zip(m1, m2)]
    for i in range(Bt):
        check(np.array_equal(fast.decrypt(p, s, out[i]), want[i]), f"decrypt of product {i}")
    down = fast.rescale(p, out, 1)
    p7 = fast.FastParams(n=p.n, qs=p.qs[:-1], zp=p.zp)
    for i in range(Bt):
        check(np.array_equal(fast.decrypt(p7, s[:-1], down[i]), want[i]),
              f"decrypt of rescaled product {i}")
    print(f"[main] {Bt} products decrypt to the negacyclic products mod 2; "
          f"rescale to L={L - 1} decrypts the same", flush=True)

    iters = 50
    step = lambda: fast.mul_relin(p, ct_a, ct_b, hb, ha)
    dev_ms = device_ms(step, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ops = Bt * iters / wall
    print(f"[perf] mul_relin n=2^{log_n} L={L} Bt={Bt}: {ops:.1f} ops/s (host clock), "
          f"device {dev_ms / Bt * 1000:.2f} us/ct ({dev_ms:.4f} ms/batch) on {card}", flush=True)
    return {"launches": launches, "ops_per_s": ops, "device_us_per_ct": dev_ms / Bt * 1000}


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
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {card}", flush=True)
    t0 = time.perf_counter()
    so = build.library_path()
    build.library()
    print(f"[build] {so.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    rng = np.random.default_rng(SEED)
    head = kernel_phase(*HEADLINE, rng, timed=True)
    kernel_phase(*SMALL, rng, timed=False)
    mp = main_path(rng, card)

    kernels = [
        {"name": "tensor_intt", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": f"{TPU_KERNEL_FILE}:232", "launches": mp["launches"]["tensor_intt"],
         "max_abs_err": head["err_a"], "ms": head["ms_a"], "plain_ms": head["plain_ms_a"]},
        {"name": "digit_relin", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": f"{TPU_KERNEL_FILE}:439", "launches": mp["launches"]["digit_relin"],
         "max_abs_err": head["err_b"], "ms": head["ms_b"], "plain_ms": head["plain_ms_b"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
