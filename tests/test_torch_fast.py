"""alchemy_tpu_torch.she.fast, the slice as a whole: keygen, relin_hint,
encrypt, mul_relin and rescale bit-identical to the JAX package from the
same seed, and the decrypt oracles (exact equality)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alchemy_tpu.she import fast as jfast
from alchemy_tpu_torch.convert import to_numpy, to_torch
from alchemy_tpu_torch.she import fast as tfast


def _params(log_n, L, zp=2):
    jp = jfast.FastParams.make(log_n, L, zp=zp, impl="pallas")
    tp = tfast.FastParams.make(log_n, L, zp=zp)
    assert (tp.n, tp.qs, tp.zp) == (jp.n, jp.qs, jp.zp)
    return jp, tp


def _negacyclic(m1, m2, zp):
    n = len(m1)
    c = np.convolve(m1.astype(np.int64), m2.astype(np.int64))
    return (c[:n] - np.concatenate([c[n:], [0]])) % zp


def _eq(jax_arr, port):
    return np.array_equal(np.asarray(jax_arr), to_numpy(port))


@pytest.mark.parametrize("log_n,L", [(10, 3), (11, 4)])
def test_keygen_hints_encrypt_match_jax(log_n, L):
    jp, tp = _params(log_n, L)
    rj, rt = np.random.default_rng(21), np.random.default_rng(21)
    sj, st = jfast.keygen(jp, rj), tfast.keygen(tp, rt)
    assert st.dtype == torch.int32 and _eq(sj, st)
    for shoup in (False, True):
        hj = jfast.relin_hint(jp, sj, rj, shoup=shoup)
        ht = tfast.relin_hint(tp, st, rt, shoup=shoup)
        if shoup:
            # companions reach 2^32 − 1: carried as their int32 bit pattern
            assert int(to_numpy(ht[0][1]).max()) >= 1 << 31
            hj, ht = [*hj[0], *hj[1]], [*ht[0], *ht[1]]
        assert all(_eq(a, b) for a, b in zip(hj, ht))
    msg = rj.integers(0, jp.zp, jp.n)
    rt.integers(0, jp.zp, jp.n)
    assert _eq(jfast.encrypt(jp, sj, msg, rj), tfast.encrypt(tp, st, msg, rt))


def test_shoup_precompute_matches_jax():
    jp, tp = _params(10, 3)
    rng = np.random.default_rng(4)
    x = np.stack([rng.integers(0, q, (3, jp.n)) for q in jp.qs], axis=1).astype(np.uint32)
    vj, cj = jfast.shoup_precompute(jnp.asarray(x), jp.qs)
    vt, ct = tfast.shoup_precompute(to_torch(x), tp.qs)
    assert _eq(vj, vt) and _eq(cj, ct)


@pytest.mark.parametrize("log_n,L,k_drop", [(10, 3, 1), (11, 4, 2)])
def test_rescale_matches_jax(log_n, L, k_drop):
    jp, tp = _params(log_n, L)
    rng = np.random.default_rng(log_n)
    ct = np.stack([[rng.integers(0, q, jp.n) for q in jp.qs] for _ in range(2)]).astype(np.uint32)
    assert _eq(jfast.rescale(jp, jnp.asarray(ct), k_drop), tfast.rescale(tp, to_torch(ct), k_drop))


def test_mul_relin_from_converted_jax_state_matches_jax():
    """Keys, Shoup hints and ciphertexts made by the JAX package, carried
    over by the converter: the port's mul_relin gives the same residues."""
    jp, tp = _params(11, 3)
    rng = np.random.default_rng(8)
    s = jfast.keygen(jp, rng)
    hb, ha = jfast.relin_hint(jp, s, rng, shoup=True)
    ct_a = jnp.stack([jfast.encrypt(jp, s, rng.integers(0, 2, jp.n), rng) for _ in range(2)])
    ct_b = jnp.stack([jfast.encrypt(jp, s, rng.integers(0, 2, jp.n), rng) for _ in range(2)])
    ref = jfast._mul_relin_jnp(jp, ct_a, ct_b, hb, ha)
    hb_t, ha_t = to_torch(tuple(map(np.asarray, hb))), to_torch(tuple(map(np.asarray, ha)))
    out = tfast.mul_relin(tp, to_torch(ct_a), to_torch(ct_b), hb_t, ha_t)
    assert _eq(ref, out)
    # the converter carries the port's state back unchanged
    assert np.array_equal(to_numpy(hb_t)[1], np.asarray(hb[1]))


@pytest.mark.parametrize("shoup", [False, True], ids=["raw", "shoup"])
def test_mul_relin_decrypts_to_negacyclic_product(shoup):
    tp = tfast.FastParams.make(10, 3, zp=2)
    rng = np.random.default_rng(30)
    s = tfast.keygen(tp, rng)
    hb, ha = tfast.relin_hint(tp, s, rng, shoup=shoup)
    m1 = rng.integers(0, 2, (2, 3, tp.n))
    m2 = rng.integers(0, 2, (2, 3, tp.n))
    enc = lambda ms: torch.stack([torch.stack([tfast.encrypt(tp, s, m, rng) for m in row])
                                  for row in ms])
    out = tfast.mul_relin(tp, enc(m1), enc(m2), hb, ha)       # leading dims [2, 3]
    assert out.shape == (2, 3, 2, 3, tp.n)
    for i in range(2):
        for j in range(3):
            want = _negacyclic(m1[i, j], m2[i, j], 2)
            assert np.array_equal(tfast.decrypt(tp, s, out[i, j]), want)
    one = tfast.mul_relin(tp, enc(m1)[0, 0], enc(m2)[0, 0], hb, ha)    # a single ct
    assert one.shape == (2, 3, tp.n)


def test_decrypt_after_rescale_gives_the_message():
    """The oracle of tests/test_fast.py:75-94 on the port."""
    tp = tfast.FastParams.make(10, 3, zp=2)
    rng = np.random.default_rng(4)
    s = tfast.keygen(tp, rng)
    msg = rng.integers(0, 2, tp.n)
    ct = tfast.encrypt(tp, s, msg, rng)
    assert np.array_equal(tfast.decrypt(tp, s, ct), msg)
    down = tfast.rescale(tp, ct, 1)
    p_down = tfast.FastParams(n=tp.n, qs=tp.qs[:-1], zp=tp.zp)
    assert np.array_equal(tfast.decrypt(p_down, s[:-1], down), msg % 2)
