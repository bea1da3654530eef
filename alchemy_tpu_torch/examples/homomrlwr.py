"""The HomomRLWR example (reference examples/HomomRLWR.hs): homomorphic
ring rounding / RLWR evaluation — the deep workload exercising every SHE op.

ringRound = rescaleTreePow2 @P5 ∘ switch5 (HomomRLWR.hs:49-50): five ring
tunnels H0→…→H5 at plaintext Z_32, then the depth-5 rescale tree down to
Z_2. Gadget TrivGad, Gaussian parameter 5.0, the reference's six moduli with
their purpose comments (HomomRLWR.hs:37-43). The homomorphic function is
f = evalCT(ringRound) ∘ (mulPublic a · encrypt s); the check is
decrypt(f(a)) == ringRound(s·a) (HomomRLWR.hs:54-71).

A copy of `alchemy_tpu/examples/homomrlwr.py`, except that `run` and
`ring_round` run on the card by default; `backend` may be a name or a
backend object (`TorchBackend("cpu")` runs it on the CPU).
"""

from __future__ import annotations

import numpy as np

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.core.params import RnsChain
from alchemy_tpu_torch.examples.common import H0, H5, M_MAP, as_backend, switch, timed
from alchemy_tpu_torch.interp.eval import eval_ir
from alchemy_tpu_torch.interp.keys_hints import KeysHints
from alchemy_tpu_torch.interp.noise import PtTy
from alchemy_tpu_torch.interp.pt2ct import pt2ct
from alchemy_tpu_torch.lang.dsl import compose
from alchemy_tpu_torch.lang.rescale_tree import rescale_tree_pow2
from alchemy_tpu_torch.nt.factor import totient
from alchemy_tpu_torch.she import bgv
from alchemy_tpu_torch.she.gadget import TrivGad

K = 5           # Pos K = P5 (HomomRLWR.hs:45)
ZP_IN = 1 << K  # rescale-tree input modulus Z_32
ZP_OUT = 2      # PT = Zq PP2 (HomomRLWR.hs:47)
ZQS = RnsChain(
    [1543651201,  # last mul: > 2^30.5
     689270401,   # 3 rounding muls: > 2^29 (larger than strictly needed,
     718099201,   # to account for the mulPublic)
     720720001,
     1556755201,  # fit 5 hops: > (last mul)
     1567238401]  # extra for KS: big
)  # HomomRLWR.hs:37-43
PT = PtTy(pnoise=0, m=H5, zp=ZP_OUT)


def ring_round(backend="torch"):
    """rescaleTreePow2 @K ∘ switch5 (HomomRLWR.hs:49-50)."""
    return compose(rescale_tree_pow2(K), switch(5, ZP_IN, backend))


def run(seed: int = 0, backend="torch", verbose: bool = True):
    bk = as_backend(backend)
    rng = np.random.default_rng(seed)

    def say(*a):
        if verbose:
            print(*a)

    expr = ring_round(bk)
    s = Cyc.from_coeffs(H0, (ZP_IN,), rng.integers(0, ZP_IN, totient(H0)), bk)

    with timed("Generating function... ", verbose):
        ctx = KeysHints(5.0, seed=seed, bk=bk)  # runKeysHints 5.0
        compiled = pt2ct(
            expr, res_ty=PT, m_map=M_MAP, zqs=ZQS, gad=TrivGad(), ctx=ctx
        )
        enc_s = compiled.encrypt_arg(s, 0)

    a = Cyc.from_coeffs(H0, (ZP_IN,), rng.integers(0, ZP_IN, totient(H0)), bk)

    with timed("Computing plaintext result... ", verbose):
        pt_result = eval_ir(expr, s * a)

    with timed("Computing encrypted result... ", verbose):
        ct_sa = bgv.mul_public(a, enc_s)  # f = evalCT ∘ (flip mulPublic · enc s)
        enc_result = eval_ir(compiled.ir, ct_sa)

    dec = compiled.decrypt(enc_result)
    ok = dec is not None and dec.equals(pt_result)
    say("PASS" if ok else "FAIL")
    return ok


if __name__ == "__main__":
    import sys

    sys.exit(0 if run() else 1)
