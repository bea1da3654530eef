"""The Tunnel example (reference examples/Tunnel.hs): a 3-hop ring-tunneling
chain H0→H1→H2→H3 under encryption, gadget BaseBGad 2, plaintext Z_8
(Tunnel.hs:24,41), five ~30-bit moduli (Tunnel.hs:34-39).

As committed the reference's `tunnel = tunnel3` cannot compile (`tunnel3` is
undefined; SURVEY.md §2.1) — the evident intent is `switch3` (Common.hs:86),
which is the workload here. The reference main prints params and per-op error
rates with no decrypt check (Tunnel.hs:47-76); we additionally verify the
decryption against the plaintext evaluation (the stronger oracle).

A copy of `alchemy_tpu/examples/tunnel.py`, except that `run` runs on the
card by default; `backend` may be a name or a backend object
(`TorchBackend("cpu")` runs it on the CPU).
"""

from __future__ import annotations

import numpy as np

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.core.params import RnsChain
from alchemy_tpu_torch.examples.common import H3, M_MAP, as_backend, switch
from alchemy_tpu_torch.interp import dup, pprint
from alchemy_tpu_torch.interp.error_writer import eval_with_error_rates
from alchemy_tpu_torch.interp.eval import eval_ir
from alchemy_tpu_torch.interp.keys_hints import KeysHints
from alchemy_tpu_torch.interp.noise import PtTy
from alchemy_tpu_torch.interp.params_print import params
from alchemy_tpu_torch.interp.pt2ct import pt2ct
from alchemy_tpu_torch.nt.factor import totient
from alchemy_tpu_torch.she.gadget import BaseBGad

ZP = 8  # Zq PP8 (Tunnel.hs:41)
ZQS = RnsChain([537264001, 539884801, 555609601, 560851201, 566092801])  # Tunnel.hs:34-39
PT = PtTy(pnoise=0, m=H3, zp=ZP)


def run(seed: int = 0, backend="torch", verbose: bool = True):
    bk = as_backend(backend)
    rng = np.random.default_rng(seed)

    def say(*a):
        if verbose:
            print(*a)

    tunnel_expr = switch(3, ZP, bk)
    say(pprint(tunnel_expr))

    from alchemy_tpu_torch.examples.common import H0

    x = Cyc.from_coeffs(H0, (ZP,), rng.integers(0, ZP, totient(H0)), bk)
    pt_result = eval_ir(tunnel_expr, x)
    say("PT evaluation done (ring", pt_result.m, ")")
    say("PT expression params:")
    say(params(tunnel_expr, res_ty=PT, zqs=ZQS))

    ctx = KeysHints(3.0, seed=seed, bk=bk)  # evalKeysHints 3.0 (Tunnel.hs:59)
    compiled = pt2ct(
        tunnel_expr, res_ty=PT, m_map=M_MAP, zqs=ZQS, gad=BaseBGad(2), ctx=ctx
    )
    t1, tmp = dup(compiled.ir)
    t2, t3 = dup(tmp)
    say(pprint(t2))
    say("CT expression params:")
    say(params(t3))

    ct1 = compiled.encrypt_arg(x, 0)
    result, errors = eval_with_error_rates(t1, ctx, ct1)
    say("Error rates: ")
    for entry in errors:
        say(" ", entry)

    dec = compiled.decrypt(result)
    ok = dec is not None and dec.equals(pt_result)
    say("PASS" if ok else "FAIL")
    return ok


if __name__ == "__main__":
    import sys

    sys.exit(0 if run() else 1)
