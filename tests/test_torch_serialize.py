"""alchemy_tpu_torch.she.serialize: keys and full checkpoints (keys, hints,
the compiled schedule, named ciphertexts) round-trip in the port, in a fresh
process and across packages: a file written by the JAX package loads in the
port and one written by the port loads in the JAX package, with equal
residues and decryptions (the round trips of tests/test_checkpoint.py)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import alchemy_tpu.examples.arithmetic as jarith
from alchemy_tpu.backend import golden_backend as jgolden
from alchemy_tpu.core.cyc import Cyc as JCyc
from alchemy_tpu.interp.eval import eval_ir as jeval_ir
from alchemy_tpu.interp.keys_hints import KeysHints as JKeysHints
from alchemy_tpu.interp.pt2ct import pt2ct as jpt2ct
from alchemy_tpu.she import serialize as jser
from alchemy_tpu.she.gadget import TrivGad as JTrivGad
import alchemy_tpu_torch.examples.arithmetic as tarith
from alchemy_tpu_torch.backend import golden_backend as tgolden
from alchemy_tpu_torch.backend.torch_backend import TorchBackend
from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.core.params import RnsChain
from alchemy_tpu_torch.interp.eval import eval_ir
from alchemy_tpu_torch.interp.keys_hints import KeysHints
from alchemy_tpu_torch.interp.noise import PtTy
from alchemy_tpu_torch.interp.pt2ct import pt2ct
from alchemy_tpu_torch.lang import dsl
from alchemy_tpu_torch.lang.ir import App
from alchemy_tpu_torch.nt.factor import totient
from alchemy_tpu_torch.nt.primes import find_ntt_prime
from alchemy_tpu_torch.she import serialize as tser
from alchemy_tpu_torch.she.gadget import BaseBGad, HybridGad, TrivGad
from alchemy_tpu_torch.she.linear import LinearMap

REPO = Path(__file__).resolve().parents[1]
BK = TorchBackend(device="cpu")


def _pt(rng, bk, Cyc_=Cyc, arith=tarith):
    return Cyc_.from_coeffs(arith.M, (arith.ZP,), rng.integers(0, arith.ZP, totient(arith.M)), bk)


def _compile_addmul(gad, seed=7, bk=BK):
    rng = np.random.default_rng(seed)
    compiled = pt2ct(tarith.addMul, res_ty=tarith.PT, m_map=tarith.M_MAP, zqs=tarith.ZQS,
                     gad=gad, ctx=KeysHints(3.0, seed=seed, bk=bk))
    pt1, pt2 = _pt(rng, bk), _pt(rng, bk)
    a1, a2 = compiled.encrypt_arg(pt1, 0), compiled.encrypt_arg(pt2, 1)
    return compiled, a1, a2, eval_ir(compiled.ir, a1, a2), eval_ir(tarith.addMul, pt1, pt2)


def _residues(ct):
    return [c.bk.to_numpy(c.to_pow().data) for c in ct.comps]


def _same_ct(a, b):
    return (a.m, a.zp, a.scale, a.qs) == (b.m, b.zp, b.scale, b.qs) and all(
        np.array_equal(x, y) for x, y in zip(_residues(a), _residues(b)))


@pytest.mark.parametrize("gad", [TrivGad(), HybridGad(dnum=2)], ids=["triv", "hybrid2"])
def test_checkpoint_roundtrip_quad_hints(tmp_path, gad):
    compiled, a1, a2, result, want = _compile_addmul(gad)
    path = tmp_path / "ckpt.npz"
    tser.save_checkpoint(compiled, path, cts={"result": result, "a1": a1, "a2": a2})
    loaded, cts = tser.load_checkpoint(path, bk=BK)
    assert loaded.decrypt(cts["result"]).equals(want)
    res2 = eval_ir(loaded.ir, cts["a1"], cts["a2"])
    assert _same_ct(res2, result) and loaded.decrypt(res2).equals(want)
    rng = np.random.default_rng(99)
    p1, p2 = _pt(rng, BK), _pt(rng, BK)
    out = eval_ir(loaded.ir, loaded.encrypt_arg(p1, 0), loaded.encrypt_arg(p2, 1))
    assert loaded.decrypt(out).equals(eval_ir(tarith.addMul, p1, p2))
    assert set(loaded.ctx.hints) == set(compiled.ctx.hints)


def test_checkpoint_roundtrip_tunnel_hint(tmp_path):
    """One linearCyc hop r = 8 → s = 4 over e = 4 at m′ = 24, compiled so
    that the IR carries a TunnelHint (test_checkpoint.py:78)."""
    r, s, e, p = 8, 4, 4, 8
    gb = tgolden()
    rng = np.random.default_rng(5)
    zqs = RnsChain([find_ntt_prime(24, b) for b in (30, 29, 28)])
    images = tuple(Cyc.from_coeffs(s, (p,), rng.integers(0, p, size=totient(s)), gb)
                   for _ in range(totient(r) // totient(e)))
    expr = dsl.lam(lambda x: App(dsl.linear_cyc(LinearMap(e=e, r=r, s=s, images=images)), x))
    compiled = pt2ct(expr, res_ty=PtTy(pnoise=0, m=s, zp=p), m_map={r: 24, s: 24}, zqs=zqs,
                     gad=BaseBGad(2), ctx=KeysHints(1.0, seed=5, bk=gb))
    x = Cyc.from_coeffs(r, (p,), rng.integers(0, p, size=totient(r)), gb)
    ct = compiled.encrypt_arg(x, 0)
    result = eval_ir(compiled.ir, ct)
    tser.save_checkpoint(compiled, tmp_path / "tunnel_ckpt.npz", cts={"arg": ct, "result": result})
    loaded, cts = tser.load_checkpoint(tmp_path / "tunnel_ckpt.npz", bk=BK)
    want = eval_ir(expr, x)
    assert loaded.decrypt(cts["result"]).equals(want)
    res2 = eval_ir(loaded.ir, cts["arg"])
    assert _same_ct(res2, result) and loaded.decrypt(res2).equals(want)


def test_checkpoint_fresh_process(tmp_path):
    """compile → save → a fresh process loads, re-evaluates, decrypts."""
    compiled, a1, a2, result, want = _compile_addmul(TrivGad())
    path = str(tmp_path / "ckpt.npz")
    tser.save_checkpoint(compiled, path, cts={"result": result, "a1": a1, "a2": a2})
    script = (
        "from alchemy_tpu_torch.backend.torch_backend import TorchBackend\n"
        "from alchemy_tpu_torch.interp.eval import eval_ir\n"
        "from alchemy_tpu_torch.she.serialize import load_checkpoint\n"
        f"loaded, cts = load_checkpoint({path!r}, bk=TorchBackend('cpu'))\n"
        "dec = loaded.decrypt(cts['result'])\n"
        "assert loaded.decrypt(eval_ir(loaded.ir, cts['a1'], cts['a2'])).equals(dec)\n"
        "print('COEFFS', loaded.ctx.bk.to_numpy(dec.data)[0].tolist())\n"
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("COEFFS")][0]
    assert eval(line.split(" ", 1)[1]) == BK.to_numpy(want.data)[0].tolist()


def test_resumed_contexts_never_reuse_encryption_randomness(tmp_path):
    compiled = pt2ct(tarith.addMul, res_ty=tarith.PT, m_map=tarith.M_MAP, zqs=tarith.ZQS,
                     gad=TrivGad(), ctx=KeysHints(3.0, seed=0, bk=BK))
    path = tmp_path / "ck.npz"
    tser.save_checkpoint(compiled, path)
    worker1, _ = tser.load_checkpoint(path, bk=BK)
    worker2, _ = tser.load_checkpoint(path, bk=BK)
    pt = Cyc.from_coeffs(tarith.M, (tarith.ZP,), np.zeros(totient(tarith.M), dtype=np.int64), BK)
    c1, c2 = worker1.encrypt_arg(pt, 0), worker2.encrypt_arg(pt, 0)
    assert not np.array_equal(BK.to_numpy(c1.comps[1].data), BK.to_numpy(c2.comps[1].data))


def test_save_and_load_keys_in_both_packages(tmp_path):
    ctx = KeysHints(3.0, seed=3, bk=BK)
    for m in (16, 32):
        ctx.get_key(m)
    tser.save_keys(ctx, tmp_path / "keys")
    jctx = JKeysHints(3.0, seed=3)
    for m in (16, 32):
        jctx.get_key(m)
    jser.save_keys(jctx, str(tmp_path / "jkeys.npz"))
    for path, src in ((tmp_path / "keys", ctx), (tmp_path / "jkeys", jctx)):
        got = tser.load_keys(path, bk=BK)
        assert got.r == 3.0 and got.bk is BK and set(got.keys) == {16, 32}
        for m in (16, 32):
            assert np.array_equal(got.keys[m].coeffs, src.keys[m].coeffs)
            assert got.keys[m].variance == src.keys[m].variance
    got = jser.load_keys(str(tmp_path / "keys.npz"))
    for m in (16, 32):
        assert np.array_equal(got.keys[m].coeffs, ctx.keys[m].coeffs)
    # the JAX package's keys equal the port's from the same seed
    assert all(np.array_equal(ctx.keys[m].coeffs, jctx.keys[m].coeffs) for m in (16, 32))
    fresh = [tser.load_keys(tmp_path / "keys", bk=BK).rng.integers(0, 1 << 62) for _ in range(2)]
    assert fresh[0] != fresh[1]                      # every load reseeds from OS entropy


def _jax_addmul(seed=7):
    bk = jgolden()
    rng = np.random.default_rng(seed)
    compiled = jpt2ct(jarith.addMul, res_ty=jarith.PT, m_map=jarith.M_MAP, zqs=jarith.ZQS,
                      gad=JTrivGad(), ctx=JKeysHints(3.0, seed=seed, bk=bk))
    pts = [_pt(rng, bk, JCyc, jarith) for _ in range(2)]
    args = [compiled.encrypt_arg(pt, i) for i, pt in enumerate(pts)]
    return compiled, args, jeval_ir(compiled.ir, *args), jeval_ir(jarith.addMul, *pts)


def _jnp(ct):
    return [np.asarray(c.bk.to_numpy(c.to_pow().data)) for c in ct.comps]


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """A JAX checkpoint (saved without the suffix: the JAX package writes
    "jax_ck.npz") loads in the port; the port's evaluation of the loaded
    program equals the JAX package's residue for residue, and decrypts."""
    compiled, args, result, want = _jax_addmul()
    jser.save_checkpoint(compiled, str(tmp_path / "jax_ck"),
                         cts={"a1": args[0], "a2": args[1], "result": result})
    assert (tmp_path / "jax_ck.npz").exists() and not (tmp_path / "jax_ck").exists()
    for bk in (BK, tgolden()):
        loaded, cts = tser.load_checkpoint(tmp_path / "jax_ck", bk=bk)
        assert all(np.array_equal(a, b) for a, b in zip(_residues(cts["result"]), _jnp(result)))
        out = eval_ir(loaded.ir, cts["a1"], cts["a2"])
        assert all(np.array_equal(a, b) for a, b in zip(_residues(out), _jnp(result)))
        dec = loaded.decrypt(out)
        assert np.array_equal(bk.to_numpy(dec.data), np.asarray(want.bk.to_numpy(want.data)))
        assert set(map(repr, loaded.ctx.hints)) == set(map(repr, compiled.ctx.hints))


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port's checkpoint loads in the JAX package (golden), whose
    evaluation equals the port's residue for residue and decrypts to the
    plaintext result."""
    compiled, a1, a2, result, want = _compile_addmul(TrivGad(), seed=9)
    tser.save_checkpoint(compiled, tmp_path / "port_ck", cts={"a1": a1, "a2": a2})
    assert (tmp_path / "port_ck.npz").exists() and not (tmp_path / "port_ck").exists()
    loaded, cts = jser.load_checkpoint(str(tmp_path / "port_ck.npz"))
    out = jeval_ir(loaded.ir, cts["a1"], cts["a2"])
    assert all(np.array_equal(a, b) for a, b in zip(_jnp(out), _residues(result)))
    dec = loaded.decrypt(out)
    assert np.array_equal(np.asarray(dec.bk.to_numpy(dec.data)), BK.to_numpy(want.data))


def test_npz_suffix_on_save_and_load(tmp_path):
    """Both spellings of a path name the same file on save and on load."""
    assert tser.npz_path("a/b") == "a/b.npz" == tser.npz_path("a/b.npz")
    compiled, *_ = _compile_addmul(TrivGad())
    tser.save_checkpoint(compiled, tmp_path / "x.npz")
    tser.save_checkpoint(compiled, str(tmp_path / "y"))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["x.npz", "y.npz"]
    for name in ("x", "x.npz", "y", "y.npz"):
        loaded, _ = tser.load_checkpoint(tmp_path / name, bk=BK)
        assert set(loaded.ctx.keys) == set(compiled.ctx.keys)
    with pytest.raises(FileNotFoundError):
        tser.load_checkpoint(tmp_path / "z", bk=BK)


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    """Without bk, keys and checkpoints load onto `get_backend("torch")`,
    the card (here a stand-in that records the call)."""
    import alchemy_tpu_torch.backend as backend

    asked = []
    monkeypatch.setattr(backend, "get_backend", lambda name: asked.append(name) or BK)
    compiled, *_ = _compile_addmul(TrivGad())
    tser.save_checkpoint(compiled, tmp_path / "c")
    tser.save_keys(compiled.ctx, tmp_path / "k")
    assert tser.load_checkpoint(tmp_path / "c")[0].ctx.bk is BK
    assert tser.load_keys(tmp_path / "k").bk is BK
    assert asked == ["torch", "torch"]
    assert os.path.exists(tmp_path / "c.npz")
