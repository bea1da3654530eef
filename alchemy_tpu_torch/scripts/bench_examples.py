"""Wall-clock of the shipped example workloads as whole programs — port of
`scripts/bench_examples.py`.

Tunnel (3 ring tunnels, BaseBGad 2) and HomomRLWR (5 tunnels + depth-5
rescale tree, TrivGad) compiled (`pt2ct`), then prepared by
`interp/jit_exec.py` `jit_compile` (one CUDA graph on the card; the
prepared program run eagerly on `TorchBackend("cpu")`), with the reference's
phase split: keygen + compile against the encrypted evaluation. Arithmetic
(`EX_ONLY=arithmetic`, not in the JAX script) is the small one. Knobs as in
the JAX script: EX_SECONDS (2.0, the measure window), EX_ONLY (tunnel |
homomrlwr; both by default).

    python -m alchemy_tpu_torch.scripts.bench_examples [--device cpu]

Prints the JAX script's lines on stderr and one JSON record a workload on
stdout (`workload`, `keygen_compile_s`, `build_s` — the JAX script's "jit_exec
build+lower" —, `ms_per_run`, `platform`, `pass`, plus `backend`, `card`).
Exits 1 when a decryption differs from the plaintext evaluation. Writes no
file.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

#: the workloads' seeds: (the messages' rng, KeysHints) as in the JAX script
SEEDS = {"arithmetic": 1, "tunnel": 1, "homomrlwr": 0}


def build(name: str, bk, seed: int) -> dict:
    """One workload as the JAX scripts build it on backend bk: messages from
    default_rng(seed), keys from KeysHints(seed=seed of the script), the
    compiled program and its ciphertext arguments ("cts"; HomomRLWR's is
    mul_public(a, enc s)), the context, and the plaintext result ("want")."""
    from alchemy_tpu_torch.core.cyc import Cyc
    from alchemy_tpu_torch.examples import arithmetic, common, homomrlwr, tunnel
    from alchemy_tpu_torch.interp.eval import eval_ir
    from alchemy_tpu_torch.interp.keys_hints import KeysHints
    from alchemy_tpu_torch.interp.pt2ct import pt2ct
    from alchemy_tpu_torch.nt.factor import totient
    from alchemy_tpu_torch.she import bgv
    from alchemy_tpu_torch.she.gadget import BaseBGad, TrivGad

    rng = np.random.default_rng(seed)

    def rand(m, zp):
        return Cyc.from_coeffs(m, (zp,), rng.integers(0, zp, totient(m)), bk)

    if name == "arithmetic":
        expr = arithmetic.addMul
        ctx = KeysHints(3.0, seed=1, bk=bk)
        compiled = pt2ct(expr, res_ty=arithmetic.PT, m_map=arithmetic.M_MAP,
                         zqs=arithmetic.ZQS, gad=TrivGad(), ctx=ctx)
        xs = [rand(arithmetic.M, arithmetic.ZP) for _ in range(2)]
        cts = [compiled.encrypt_arg(x, i) for i, x in enumerate(xs)]
        want = eval_ir(expr, *xs)
    elif name == "tunnel":
        expr = common.switch(3, tunnel.ZP, bk)
        ctx = KeysHints(3.0, seed=1, bk=bk)
        compiled = pt2ct(expr, res_ty=tunnel.PT, m_map=common.M_MAP, zqs=tunnel.ZQS,
                         gad=BaseBGad(2), ctx=ctx)
        x = rand(common.H0, tunnel.ZP)
        cts = [compiled.encrypt_arg(x, 0)]
        want = eval_ir(expr, x)
    elif name == "homomrlwr":
        expr = homomrlwr.ring_round(bk)
        ctx = KeysHints(5.0, seed=0, bk=bk)
        compiled = pt2ct(expr, res_ty=homomrlwr.PT, m_map=common.M_MAP, zqs=homomrlwr.ZQS,
                         gad=TrivGad(), ctx=ctx)
        s = rand(common.H0, homomrlwr.ZP_IN)
        a = rand(common.H0, homomrlwr.ZP_IN)
        cts = [bgv.mul_public(a, compiled.encrypt_arg(s, 0))]
        want = eval_ir(expr, s * a)
    else:
        raise ValueError(f"workload {name!r}: want arithmetic, tunnel or homomrlwr")
    return {"expr": expr, "ctx": ctx, "compiled": compiled, "cts": cts, "want": want}


def measure(jfn, args, min_seconds, device):
    """s per call of jfn(*args) over a doubling loop from 2 calls, after one
    warm call, and that call's output."""
    from alchemy_tpu_torch.bench import _timed_loop, sync

    out = jfn(*args)
    sync(device)
    return _timed_loop(lambda _: jfn(*args), None, min_seconds, 1, 2, device)[1], out


def run(name: str, secs: float, device: str) -> dict:
    from alchemy_tpu_torch.backend.torch_backend import TorchBackend
    from alchemy_tpu_torch.bench import backend, card, log, sync
    from alchemy_tpu_torch.interp.jit_exec import jit_compile

    bk = TorchBackend(device)
    t0 = time.perf_counter()
    w = build(name, bk, SEEDS[name])
    sync(device)
    keygen_s = time.perf_counter() - t0
    log(f"{name}: keygen+compile {keygen_s:.2f}s")
    t0 = time.perf_counter()
    jfn = jit_compile(w["compiled"], w["cts"])
    sync(device)
    build_s = time.perf_counter() - t0
    log(f"{name}: jit_exec build {build_s:.2f}s")
    per, out = measure(jfn, w["cts"], secs, device)
    dec = w["compiled"].decrypt(out)
    ok = dec is not None and dec.equals(w["want"])
    log(f"{name}: {per*1e3:.2f} ms/run on {device} ({'PASS' if ok else 'FAIL'})")
    return {"workload": name, "keygen_compile_s": keygen_s, "build_s": build_s,
            "ms_per_run": per * 1e3, "platform": device, "pass": bool(ok),
            "backend": backend(device), "card": card(device)}


def main(device: str | None = None, argv=None) -> int:
    from alchemy_tpu_torch.bench import run_args

    device = run_args("alchemy_tpu_torch.scripts.bench_examples", device, argv).device
    secs = float(os.environ.get("EX_SECONDS", "2.0"))
    only = os.environ.get("EX_ONLY", "")
    names = [only] if only else ["tunnel", "homomrlwr"]
    ok = True
    for name in names:
        rec = run(name, secs, device)
        print(json.dumps(rec), flush=True)
        ok &= rec["pass"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(argv=sys.argv[1:]))
