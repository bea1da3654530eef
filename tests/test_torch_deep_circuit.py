"""alchemy_tpu_torch.examples.deep_circuit: the depth-D squaring chain
passes, and its final ciphertext equals the same chain run through the JAX
package's functions from the same seed (exact equality); its checkpoint
survives a SIGKILL and resumes in a fresh process, and a state file written
by either package resumes in the other."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alchemy_tpu.examples import deep_circuit as jdeep
from alchemy_tpu.she import fast as jfast
from alchemy_tpu.she import hybrid as jhyb
from alchemy_tpu.she.keys import gaussian_coeffs
from alchemy_tpu_torch.convert import to_numpy
from alchemy_tpu_torch.examples import deep_circuit as tdeep

REPO = Path(__file__).resolve().parents[1]


def _jax_chain(log_n, depth, ks, seed=0, impl="pallas"):
    """`alchemy_tpu.examples.deep_circuit.run`'s loop at `impl`, returning
    the final ciphertext."""
    p = jfast.FastParams.make(log_n, depth + 2, zp=2, impl=impl)
    rng = np.random.default_rng(seed)
    s_int = gaussian_coeffs(rng, 1.0, p.n)

    def key_at(pp):
        return jfast._ntt_p(pp, jnp.asarray(np.stack([s_int % q for q in pp.qs]).astype(np.uint32)))

    s = key_at(p)
    ct = jfast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    cur = p
    for _ in range(depth):
        if ks == "hybrid":
            hk = jhyb.HybridKS.make(cur)
            ct = jhyb.mul_relin_hybrid(hk, ct, ct, *jhyb.hybrid_relin_hint(hk, s_int, rng))
        else:
            hb, ha = jfast.relin_hint(cur, key_at(cur), rng, shoup=True)
            ct = jfast.mul_relin(cur, ct, ct, hb, ha)
        ct = jfast.rescale(cur, ct, 1)
        cur = jfast.FastParams(n=cur.n, qs=cur.qs[:-1], zp=cur.zp, impl=cur.impl)
    return ct


@pytest.mark.parametrize("ks", ["hybrid", "trivgad"])
def test_deep_circuit_passes_and_matches_jax(ks):
    ok, ct, level_ms = tdeep.run(log_n=5, depth=4, verbose=False, impl="pallas", ks=ks,
                                 device="cpu")
    assert ok and len(level_ms) == 4 and ct.shape == (2, 2, 32)
    assert np.array_equal(to_numpy(ct), np.asarray(_jax_chain(5, 4, ks)))


@pytest.mark.parametrize("ks", ["hybrid", "trivgad"])
def test_deep_circuit_mxu_passes_and_matches_jax(ks):
    """The default slot order (impl="mxu", n2 = 1 at n = 2^5) against the
    JAX package's chain at impl="mxu"."""
    ok, ct, _ = tdeep.run(log_n=5, depth=4, verbose=False, ks=ks, device="cpu")
    assert ok and np.array_equal(to_numpy(ct), np.asarray(_jax_chain(5, 4, ks, impl="mxu")))


def test_square_chain_oracle_matches_jax():
    rng = np.random.default_rng(0)
    for n, depth in ((32, 4), (64, 7)):
        msg = rng.integers(0, 2, n)
        assert np.array_equal(tdeep.expected_square_chain_mod2(msg, n, depth),
                              jdeep.expected_square_chain_mod2(msg, n, depth))
    with pytest.raises(ValueError):
        tdeep.run(log_n=5, depth=1, verbose=False, ks="bgv")


def test_deep_circuit_kill_and_resume(tmp_path):
    """The recovery drill of tests/test_checkpoint.py:156 in the port: a
    process checkpoints the chain before level 3 and dies by SIGKILL; a
    fresh process resumes from the state file (given without its suffix),
    runs the remaining levels and decrypts the whole chain."""
    state = str(tmp_path / "deep_state")
    phase1 = (
        "import os\n"
        "from alchemy_tpu_torch.examples.deep_circuit import run\n"
        "out = run(log_n=7, depth=6, impl='vpu', verbose=False, device='cpu',"
        f" stop_at_level=3, state_path={state!r})\n"
        "assert out == (None, 3), out\n"
        "os.kill(os.getpid(), 9)\n"
    )
    out1 = subprocess.run([sys.executable, "-c", phase1], capture_output=True, text=True,
                          cwd=REPO, timeout=300)
    assert out1.returncode == -9, (out1.returncode, out1.stderr)
    assert os.path.exists(state + ".npz")
    phase2 = (
        "from alchemy_tpu_torch.examples.deep_circuit import run\n"
        f"ok, ct, level_ms = run(resume=True, state_path={state!r}, verbose=False, device='cpu')\n"
        "assert ok and len(level_ms) == 3 and tuple(ct.shape) == (2, 2, 128), (ok, level_ms)\n"
        "print('RESUME_PASS')\n"
    )
    out2 = subprocess.run([sys.executable, "-c", phase2], capture_output=True, text=True,
                          cwd=REPO, timeout=300)
    assert out2.returncode == 0, out2.stderr
    assert "RESUME_PASS" in out2.stdout


@pytest.mark.parametrize("impl,ks", [("vpu", "hybrid"), ("mxu", "trivgad")])
def test_state_files_resume_across_packages(tmp_path, impl, ks):
    """From one seed both packages save the same state before level 2 (the
    same keys, equal arrays); the JAX package's file resumes in the port and
    the port's in the JAX package, each to PASS."""
    jst, tst = str(tmp_path / "jax_state.npz"), str(tmp_path / "port_state")
    assert jdeep.run(log_n=5, depth=4, impl=impl, ks=ks, verbose=False, stop_at_level=2,
                     state_path=jst) == (None, 2)
    assert tdeep.run(log_n=5, depth=4, impl=impl, ks=ks, verbose=False, device="cpu",
                     stop_at_level=2, state_path=tst) == (None, 2)
    a, b = np.load(jst), np.load(tst + ".npz")
    assert set(a.files) == set(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    ok, ct, level_ms = tdeep.run(resume=True, state_path=jst, verbose=False, device="cpu")
    assert ok and len(level_ms) == 2 and ct.shape == (2, 2, 32)
    assert jdeep.run(resume=True, state_path=tst + ".npz", verbose=False) == (True, 4)


def test_jax_state_file_without_impl_resumes_in_its_order(tmp_path, monkeypatch):
    """A JAX state file saved by `run(impl=None)` holds impl "" and its slot
    order is its process's ALCHEMY_NTT_IMPL (here "vpu"): the port resumes it
    the way the JAX package does, from that variable, to PASS; an explicit
    impl overrides it; an impl that names another order than a non-empty
    stored one raises."""
    jst = str(tmp_path / "jax_state.npz")
    save = ("from alchemy_tpu.examples.deep_circuit import run\n"
            f"assert run(log_n=5, depth=4, ks='trivgad', verbose=False, stop_at_level=2, "
            f"state_path={jst!r}) == (None, 2)\n")
    env = {**os.environ, "ALCHEMY_NTT_IMPL": "vpu", "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", save], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert str(np.load(jst)["impl"]) == ""
    monkeypatch.setenv("ALCHEMY_NTT_IMPL", "vpu")
    assert jdeep.run(resume=True, state_path=jst, verbose=False) == (True, 4)
    ok, ct, level_ms = tdeep.run(resume=True, state_path=jst, verbose=False, device="cpu")
    assert ok and len(level_ms) == 2 and ct.shape == (2, 2, 32)
    monkeypatch.delenv("ALCHEMY_NTT_IMPL")
    ok, _, _ = tdeep.run(resume=True, state_path=jst, impl="vpu", verbose=False, device="cpu")
    assert ok
    assert tdeep.resume_impl("") == "mxu" and tdeep.resume_impl("", "pallas") == "pallas"
    tst = str(tmp_path / "port_state")
    tdeep.run(log_n=5, depth=4, impl="vpu", verbose=False, device="cpu", stop_at_level=2,
              state_path=tst)
    assert str(np.load(tst + ".npz")["impl"]) == "vpu"
    with pytest.raises(ValueError, match="saved in impl='vpu'"):
        tdeep.run(resume=True, state_path=tst, impl="pallas", verbose=False, device="cpu")
    assert tdeep.resume_impl("mxu8", "mxu") == "mxu8"


def test_checkpoint_arguments_are_checked(tmp_path):
    with pytest.raises(ValueError, match="state_path"):
        tdeep.run(log_n=5, depth=2, verbose=False, device="cpu", stop_at_level=1)
    with pytest.raises(ValueError, match="state_path"):
        tdeep.run(resume=True, verbose=False, device="cpu")
    tdeep.run(log_n=5, depth=3, verbose=False, device="cpu", stop_at_level=1,
              state_path=tmp_path / "s.npz")
    st = dict(np.load(tmp_path / "s.npz"))
    st["ct"] = st["ct"][:, :1]
    np.savez(tmp_path / "bad.npz", **st)
    with pytest.raises(ValueError, match="state ct"):
        tdeep.run(resume=True, state_path=tmp_path / "bad", verbose=False, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("ks", ["hybrid", "trivgad"])
def test_deep_circuit_on_the_card(ks):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ok, ct, _ = tdeep.run(log_n=14, depth=4, verbose=False, ks=ks, device="cuda")
    assert ok and ct.is_cuda
