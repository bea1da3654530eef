"""The Arithmetic example (reference examples/Arithmetic.hs): the smallest
end-to-end compile+run. PT = PNoiseCyc PNZ CT F4 (Zq 7); the term is
`addMul = λx y. (x+y)·y` (Arithmetic.hs:23-27); m'-map F4→F512 and the same
three RNS moduli (Arithmetic.hs:29-34); gadget TrivGad, Gaussian param 3.0.

Flow (Arithmetic.hs:36-75): print/size/eval the PT term; params; compile with
pt2ct; dup into print/params/size/eval copies; encrypt two random arguments;
evaluate with error-rate logging; decrypt and compare against the plaintext
result (PASS/FAIL).

A copy of `alchemy_tpu/examples/arithmetic.py`, except that `run` runs on
the card by default; `backend` may be a name or a backend object
(`TorchBackend("cpu")` runs it on the CPU).
"""

from __future__ import annotations

import numpy as np

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.core.params import RnsChain
from alchemy_tpu_torch.examples.common import as_backend
from alchemy_tpu_torch.interp import dup, pprint, size
from alchemy_tpu_torch.interp.error_writer import eval_with_error_rates
from alchemy_tpu_torch.interp.eval import eval_ir
from alchemy_tpu_torch.interp.keys_hints import KeysHints
from alchemy_tpu_torch.interp.noise import PtTy
from alchemy_tpu_torch.interp.params_print import params
from alchemy_tpu_torch.interp.pt2ct import pt2ct
from alchemy_tpu_torch.lang.dsl import lam2
from alchemy_tpu_torch.nt.factor import totient
from alchemy_tpu_torch.she.gadget import TrivGad

M, M_PRIME, ZP = 4, 512, 7
M_MAP = {M: M_PRIME}
ZQS = RnsChain([268440577, 8392193, 1073750017])  # Arithmetic.hs:31-34
PT = PtTy(pnoise=0, m=M, zp=ZP)

#: addMul = lam2 $ \x y -> (x +: y) *: y (Arithmetic.hs:26-27)
addMul = lam2(lambda x, y: (x + y) * y)


def run(seed: int = 42, backend="torch", verbose: bool = True):
    bk = as_backend(backend)
    rng = np.random.default_rng(seed)

    def say(*a):
        if verbose:
            print(*a)

    say("PT expression:", pprint(addMul))
    say("PT expression size:", size(addMul))

    pt1 = Cyc.from_coeffs(M, (ZP,), rng.integers(0, ZP, totient(M)), bk)
    pt2 = Cyc.from_coeffs(M, (ZP,), rng.integers(0, ZP, totient(M)), bk)
    ptresult = eval_ir(addMul, pt1, pt2)
    say("PT evaluation result:", bk.to_numpy(ptresult.data)[0].tolist())
    say("PT expression params:\n" + params(addMul, res_ty=PT, zqs=ZQS))

    ctx = KeysHints(3.0, seed=seed, bk=bk)  # evalKeysHints 3.0 (Arithmetic.hs:50)
    compiled = pt2ct(addMul, res_ty=PT, m_map=M_MAP, zqs=ZQS, gad=TrivGad(), ctx=ctx)
    ct1, tmp = dup(compiled.ir)
    ct2, ct3 = dup(tmp)

    arg1 = compiled.encrypt_arg(pt1, 0)
    arg2 = compiled.encrypt_arg(pt2, 1)

    say("CT expression:", pprint(ct2))
    say("CT expression params:\n" + params(ct3))
    say("CT expression size:", size(compiled.ir))

    result, errors = eval_with_error_rates(ct1, ctx, arg1, arg2)
    say("Error rates: ")
    for entry in errors:
        say(" ", entry)

    dec = compiled.decrypt(result)
    ok = dec is not None and dec.equals(ptresult)
    say("Decrypted evaluation result:", bk.to_numpy(dec.data)[0].tolist())
    say("PASS" if ok else "FAIL")
    return ok


if __name__ == "__main__":
    import sys

    sys.exit(0 if run() else 1)
