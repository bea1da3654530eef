"""alchemy_tpu_torch.native, the C++ oracle the port carries (a copy of
alchemy_tpu/native): the counterpart of tests/test_native.py. The
elementwise ops exact; `ntt`/`intt` equal to the port's radix-2
`backend/ntt.py` (the vpu order) and to the JAX `ntt_negacyclic`/
`intt_negacyclic`; `mul_relin` equal to the port's `fast.mul_relin` at
impl="vpu" on the CPU and to the JAX one (tolerance 0). The library is
built under build/native/, and the build writes nothing into either
package's directory."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alchemy_tpu.backend.ntt import intt_negacyclic, ntt_negacyclic
from alchemy_tpu.she import fast as jfast
from alchemy_tpu_torch import native
from alchemy_tpu_torch.backend import ntt as tntt
from alchemy_tpu_torch.nt.primes import root_of_unity
from alchemy_tpu_torch.she import fast
from alchemy_tpu_torch.she.fast import FastParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_source_is_the_jax_packages():
    with open(os.path.join(ROOT, "alchemy_tpu", "native", "zq_kernels.cpp"), "rb") as f:
        assert native.SRC.read_bytes() == f.read()


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_native_elemwise(op):
    q = 268440577
    rng = np.random.default_rng(0)
    a = rng.integers(0, q, 1000).astype(np.uint32)
    b = rng.integers(0, q, 1000).astype(np.uint32)
    x, y = a.astype(object), b.astype(object)
    want = {"add": (x + y) % q, "sub": (x - y) % q, "mul": x * y % q}[op]
    assert np.array_equal(native.zq_elemwise(op, a, b, q), want.astype(np.int64))


@pytest.mark.parametrize("log_n", [3, 10])
def test_native_ntt_matches_the_vpu_order_and_jax(log_n):
    p = FastParams.make(log_n, 2, impl="vpu")
    rng = np.random.default_rng(1)
    for q in p.qs:
        psi = root_of_unity(2 * p.n, q)
        x = rng.integers(0, q, p.n).astype(np.uint32)
        got = native.ntt(x, q, psi)
        port = tntt.ntt_vpu(torch.from_numpy(x[None].astype(np.int64)), p.n, (q,))
        assert np.array_equal(got, port.numpy()[0])
        assert np.array_equal(got, np.asarray(ntt_negacyclic(jnp.asarray(x[None]), p.n, (q,)))[0])
        back = native.intt(got, q, psi)
        assert np.array_equal(back, x)
        port_i = tntt.intt_vpu(torch.from_numpy(got[None].astype(np.int64)), p.n, (q,))
        assert np.array_equal(back, port_i.numpy()[0])
        assert np.array_equal(
            back, np.asarray(intt_negacyclic(jnp.asarray(got[None]), p.n, (q,)))[0])


def test_native_mul_relin_matches_fast_vpu_and_jax():
    p = FastParams.make(8, 3, impl="vpu")
    rng = np.random.default_rng(2)
    s = fast.keygen(p, rng, device="cpu")
    hb, ha = fast.relin_hint(p, s, rng)
    cts = [fast.encrypt(p, s, rng.integers(0, 2, p.n), rng) for _ in range(2)]
    want = fast.mul_relin(p, *cts, hb, ha).numpy().view(np.uint32)
    psis = [root_of_unity(2 * p.n, q) for q in p.qs]
    u32 = [t.numpy().view(np.uint32) for t in (*cts, hb, ha)]
    got = native.mul_relin(*u32, p.qs, psis)
    assert np.array_equal(got, want)
    jp = jfast.FastParams.make(8, 3, impl="vpu")
    jwant = np.asarray(jfast.mul_relin(jp, *(jnp.asarray(a) for a in u32)))
    assert np.array_equal(got, jwant)


def test_library_is_built_under_build_not_in_a_package(tmp_path, monkeypatch):
    """A fresh build (the build directory pointed at an empty one) lands
    there; neither package's directory gains a file."""
    def listing():
        return {os.path.join(d, f) for pkg in ("alchemy_tpu", "alchemy_tpu_torch")
                for d, dirs, files in os.walk(os.path.join(ROOT, pkg))
                if "__pycache__" not in d for f in files
                # the JAX package's own test builds its library beside its source
                if not f.startswith("_zq_kernels_")}

    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR == type(native.BUILD_DIR)(ROOT) / "build" / "native"
    before = listing()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    so = native.library_path()
    assert so.parent == tmp_path / "native" and so.exists()
    assert sorted(p.name for p in so.parent.iterdir()) == [so.name]
    assert listing() == before
