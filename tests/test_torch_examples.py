"""The port's three shipped examples (`alchemy_tpu_torch/examples/`
arithmetic, tunnel, homomrlwr, all_main): each `run` PASSes on
`TorchBackend(device="cpu")`; Arithmetic's and Tunnel's programs, compiled
programs and strict error-rate logs equal the JAX package's at the same
seed (the JAX package on its golden backend, whose host probe the port's
device probe must match); `all_main` PASSes on the port's golden backend;
the entry points default to the card."""

import inspect
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import alchemy_tpu.examples.arithmetic as jarith
import alchemy_tpu.examples.common as jcommon
import alchemy_tpu.examples.tunnel as jtunnel
from alchemy_tpu.backend import golden_backend as jgolden
from alchemy_tpu.core.cyc import Cyc as JCyc
from alchemy_tpu.interp import pprint as jpprint
from alchemy_tpu.interp.error_writer import eval_with_error_rates as jerw
from alchemy_tpu.interp.eval import eval_ir as jeval_ir
from alchemy_tpu.interp.keys_hints import KeysHints as JKeysHints
from alchemy_tpu.interp.params_print import params as jparams
from alchemy_tpu.interp.pt2ct import pt2ct as jpt2ct
from alchemy_tpu.she import gadget as jgad
import alchemy_tpu_torch.examples.all_main as tall_main
import alchemy_tpu_torch.examples.arithmetic as tarith
import alchemy_tpu_torch.examples.common as tcommon
import alchemy_tpu_torch.examples.homomrlwr as thomom
import alchemy_tpu_torch.examples.tunnel as ttunnel
from alchemy_tpu_torch.backend import golden_backend as tgolden
from alchemy_tpu_torch.backend.torch_backend import TorchBackend
from alchemy_tpu_torch.core.cyc import Cyc as TCyc
from alchemy_tpu_torch.interp import pprint as tpprint
from alchemy_tpu_torch.interp.error_writer import eval_with_error_rates as terw
from alchemy_tpu_torch.interp.eval import eval_ir as teval_ir
from alchemy_tpu_torch.interp.keys_hints import KeysHints as TKeysHints
from alchemy_tpu_torch.interp.params_print import params as tparams
from alchemy_tpu_torch.interp.pt2ct import pt2ct as tpt2ct
from alchemy_tpu_torch.nt.factor import totient
from alchemy_tpu_torch.she import gadget as tgad

JAX = SimpleNamespace(arith=jarith, tunnel=jtunnel, common=jcommon, Cyc=JCyc, pprint=jpprint,
                      erw=jerw, eval_ir=jeval_ir, KeysHints=JKeysHints, params=jparams,
                      pt2ct=jpt2ct, gad=jgad)
PORT = SimpleNamespace(arith=tarith, tunnel=ttunnel, common=tcommon, Cyc=TCyc, pprint=tpprint,
                       erw=terw, eval_ir=teval_ir, KeysHints=TKeysHints, params=tparams,
                       pt2ct=tpt2ct, gad=tgad)
EXAMPLES = {"arithmetic": tarith, "tunnel": ttunnel, "homomrlwr": thomom}


def arithmetic_script(ns, bk, seed=42):
    """Arithmetic's run (examples/arithmetic.py) up to its strict log."""
    a = ns.arith
    rng = np.random.default_rng(seed)
    pts = [ns.Cyc.from_coeffs(a.M, (a.ZP,), rng.integers(0, a.ZP, totient(a.M)), bk)
           for _ in range(2)]
    want = ns.eval_ir(a.addMul, *pts)
    ctx = ns.KeysHints(3.0, seed=seed, bk=bk)
    compiled = ns.pt2ct(a.addMul, res_ty=a.PT, m_map=a.M_MAP, zqs=a.ZQS, gad=ns.gad.TrivGad(),
                        ctx=ctx)
    args = [compiled.encrypt_arg(pt, i) for i, pt in enumerate(pts)]
    result, log = ns.erw(compiled.ir, ctx, *args, strict=True)
    return (ns.pprint(a.addMul), ns.params(a.addMul, res_ty=a.PT, zqs=a.ZQS),
            ns.pprint(compiled.ir), ns.params(compiled.ir), log,
            compiled.decrypt(result).equals(want))


def tunnel_script(ns, bk, seed=0):
    """Tunnel's run (examples/tunnel.py) up to its strict log."""
    t = ns.tunnel
    expr = ns.common.switch(3, t.ZP, bk if ns is PORT else "golden")
    rng = np.random.default_rng(seed)
    H0 = ns.common.H0
    x = ns.Cyc.from_coeffs(H0, (t.ZP,), rng.integers(0, t.ZP, totient(H0)), bk)
    want = ns.eval_ir(expr, x)
    ctx = ns.KeysHints(3.0, seed=seed, bk=bk)
    compiled = ns.pt2ct(expr, res_ty=t.PT, m_map=ns.common.M_MAP, zqs=t.ZQS,
                        gad=ns.gad.BaseBGad(2), ctx=ctx)
    result, log = ns.erw(compiled.ir, ctx, compiled.encrypt_arg(x, 0), strict=True)
    return (ns.pprint(expr), ns.params(expr, res_ty=t.PT, zqs=t.ZQS), ns.pprint(compiled.ir),
            ns.params(compiled.ir), log, compiled.decrypt(result).equals(want))


SCRIPTS = {"arithmetic": arithmetic_script, "tunnel": tunnel_script}


def _compare(name, bk):
    want = SCRIPTS[name](JAX, jgolden())
    got = SCRIPTS[name](PORT, bk)
    assert got == want
    log = got[4]
    assert got[-1] and len(log) >= 5 and all(isinstance(r, float) for _, r in log)
    if name == "tunnel":
        assert "tunnel <HINT>" in got[2] and all(r < 0.01 for _, r in log), log
    return got


@pytest.mark.parametrize("name", SCRIPTS)
def test_programs_and_logs_match_jax(name):
    _compare(name, TorchBackend(device="cpu"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_passes_on_torch_cpu(name):
    assert EXAMPLES[name].run(backend=TorchBackend(device="cpu"), verbose=False)


def test_arithmetic_prints_its_programs(capsys):
    assert tarith.run(seed=1, backend=tgolden())
    out = capsys.readouterr().out
    assert "PT expression: (\\v0 -> (\\v1 -> ((mul ((add v0) v1)) v1)))" in out
    assert "Error rates:" in out and out.rstrip().endswith("PASS")


def test_all_main_passes_on_golden(capsys):
    assert tall_main.main(tgolden())
    assert capsys.readouterr().out.splitlines() == [
        "Arithmetic: PASS", "Tunnel: PASS", "HomomRLWR: PASS"]


def test_switch_and_dec_to_crt_take_a_backend_object():
    """`switch` and `dec_to_crt` take a backend object as well as a name;
    `dec_to_crt` caches by the object."""
    tb = TorchBackend(device="cpu")
    f = tcommon.dec_to_crt(128, 448, 8, tb)
    assert tcommon.dec_to_crt(128, 448, 8, tb) is f and all(c.bk is tb for c in f.images)
    g = tcommon.dec_to_crt(128, 448, 8)
    assert [tb.to_numpy(c.data).tolist() for c in f.images] == \
        [c.bk.to_numpy(c.data).tolist() for c in g.images]
    assert tpprint(tcommon.switch(2, 8, tb)) == jpprint(jcommon.switch(2, 8))


def test_entry_points_default_to_the_card():
    """`run`, `ring_round` and `all_main.main` default to `backend="torch"`,
    the card; without a card they raise as `TorchBackend()` does."""
    for fn in (*[m.run for m in EXAMPLES.values()], thomom.ring_round, tall_main.main):
        assert inspect.signature(fn).parameters["backend"].default == "torch"
    if torch.cuda.is_available():
        assert tcommon.as_backend("torch").device.type == "cuda"
        return
    for call in (lambda: tarith.run(verbose=False), lambda: thomom.ring_round(),
                 lambda: tall_main.main()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCRIPTS)
def test_programs_and_logs_checked_on_the_card(name):
    """Arithmetic and Tunnel on the checked backend (every torch op on the
    card against golden numpy) against the JAX package."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from alchemy_tpu_torch.backend import get_backend

    _compare(name, get_backend("checked"))
