"""alchemy_tpu_torch.examples.deep_circuit: the depth-D squaring chain
passes, and its final ciphertext equals the same chain run through the JAX
package's functions from the same seed (exact equality)."""

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


def _jax_chain(log_n, depth, ks, seed=0):
    """`alchemy_tpu.examples.deep_circuit.run`'s loop at impl="pallas" (the
    port's slot order), returning the final ciphertext."""
    p = jfast.FastParams.make(log_n, depth + 2, zp=2, impl="pallas")
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
    ok, ct, level_ms = tdeep.run(log_n=5, depth=4, verbose=False, ks=ks, device="cpu")
    assert ok and len(level_ms) == 4 and ct.shape == (2, 2, 32)
    assert np.array_equal(to_numpy(ct), np.asarray(_jax_chain(5, 4, ks)))


def test_square_chain_oracle_matches_jax():
    rng = np.random.default_rng(0)
    for n, depth in ((32, 4), (64, 7)):
        msg = rng.integers(0, 2, n)
        assert np.array_equal(tdeep.expected_square_chain_mod2(msg, n, depth),
                              jdeep.expected_square_chain_mod2(msg, n, depth))
    with pytest.raises(ValueError):
        tdeep.run(log_n=5, depth=1, verbose=False, ks="bgv")


@pytest.mark.cuda
@pytest.mark.parametrize("ks", ["hybrid", "trivgad"])
def test_deep_circuit_on_the_card(ks):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ok, ct, _ = tdeep.run(log_n=14, depth=4, verbose=False, ks=ks, device="cuda")
    assert ok and ct.is_cuda
