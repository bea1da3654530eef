"""The general-cyclotomic ring layer of the port: every method of
`TorchBackend` (on the CPU, the same float64 `axis_matmul` route the card
runs) and of the port's golden backend against the JAX package's golden
and XLA backends on the same numpy inputs, `axis_matmul` at the edge of its
exactness bound, and the `Cyc` transforms against the JAX package's golden
results (exact equality throughout)."""

import numpy as np
import pytest
import torch

from alchemy_tpu.backend import golden_backend as jgolden
from alchemy_tpu.backend import xla_backend as jxla
from alchemy_tpu.core.cyc import Cyc as JCyc
from alchemy_tpu.core.ring import crt_factor_matrix, get_ring, twace_factor_matrix
from alchemy_tpu.nt.factor import totient
from alchemy_tpu.nt.primes import find_ntt_prime
from alchemy_tpu_torch.backend import golden_backend as tgolden
from alchemy_tpu_torch.backend.checked import CheckedBackend
from alchemy_tpu_torch.backend.torch_backend import TorchBackend
from alchemy_tpu_torch.core.cyc import Cyc as TCyc

JG, JX, TG = jgolden(), jxla(), tgolden()
TB = TorchBackend(device="cpu")


def chain(m):
    return (find_ntt_prime(m, 30), find_ntt_prime(m, 29))


def _np(bk, a):
    return np.asarray(bk.to_numpy(a), dtype=np.int64)


def _backend_results(bk, m, qs, x, y, row, signed):
    """Every protocol method of `bk` on the same numpy inputs → numpy."""
    ring = get_ring(m)
    n = ring.phi
    a, b = bk.asarray(x, qs), bk.asarray(y, qs)
    crt = [[crt_factor_matrix(f.pe, q) for q in qs] for f in ring.factors]
    sub = get_ring(m // ring.factors[-1].p)
    tw = [twace_factor_matrix(f.p, f.e, sub.factor_exponent(f.p)) for f in ring.factors]
    grp = ((qs[0],), (qs[1],)) if len(qs) == 2 else ((qs[0], qs[1]), qs[2:])
    ext = qs + (find_ntt_prime(m, 28),)
    out = {
        "asarray": bk.asarray(x[0], qs),
        "zeros": bk.zeros(len(qs), n),
        "add": bk.add(a, b, qs),
        "sub": bk.sub(a, b, qs),
        "neg": bk.neg(a, qs),
        "mul": bk.mul(a, b, qs),
        "mul_const": bk.mul_const(a, [123456789, -5], qs),
        "sum_terms": bk.sum_terms([a, b, a], qs),
        "axis_matmul_crt": bk.axis_matmul(a, crt, ring.shape, qs),
        "axis_matmul_twace": bk.axis_matmul(a, tw, ring.shape, qs),
        "reduce_signed": bk.reduce_signed(signed, qs),
        "broadcast_row": bk.broadcast_row(row, len(qs), qs),
        "stack_rows": bk.stack_rows([a, b]),
        "rescale_step": bk.rescale_step(a, qs, 8),
        "modswitch_up": bk.modswitch_up(a, qs[:1], qs),
        "hybrid_digit_rows": bk.hybrid_digit_rows(a, qs, grp, ext),
        "gadget_digit_rows_triv": bk.gadget_digit_rows(a, qs, None),
        "gadget_digit_rows_base2": bk.gadget_digit_rows(a, qs, 2),
    }
    res = {k: _np(bk, v) for k, v in out.items()}
    res["lift_centered"] = np.asarray(bk.lift_centered(a, qs), dtype=np.int64)
    res["to_numpy"] = _np(bk, a)
    return res


@pytest.mark.parametrize("m", [8, 512, 91, 4095])
def test_backend_methods_match_jax(m):
    """TorchBackend, the port's golden backend and the checked pair of the
    two give the JAX golden and XLA backends' results for every protocol
    method."""
    qs = chain(m)
    n = totient(m)
    rng = np.random.default_rng(m)
    x = rng.integers(0, min(qs), size=(2, n))
    y = rng.integers(0, min(qs), size=(2, n))
    row = rng.integers(-(1 << 40), 1 << 40, size=n)
    signed = rng.integers(-(1 << 62), 1 << 62, size=(2, n))
    want = _backend_results(JG, m, qs, x, y, row, signed)
    for bk in (JX, TG, TB, CheckedBackend(device="cpu")):
        got = _backend_results(bk, m, qs, x, y, row, signed)
        bad = [k for k in want if not np.array_equal(want[k], got[k])]
        assert not bad, (bk.name, bad)


@pytest.mark.parametrize("shape", [(256,), (8, 16)], ids=["K256", "kron128"])
def test_axis_matmul_at_the_bound(shape):
    """q = 2^31 − 1 with every matrix and operand entry q − 1: the largest
    16-bit halves at a K = 256 axis and at two axes merged into one
    Kronecker axis of 128 (ones ⊗ (q − 1))."""
    q = (1 << 31) - 1
    mats = [np.ones((d, d), dtype=np.int64) for d in shape[:-1]]
    mats.append(np.full((shape[-1], shape[-1]), q - 1, dtype=np.int64))
    x = np.full((1, int(np.prod(shape))), q - 1, dtype=np.int64)
    want = JG.to_numpy(JG.axis_matmul(JG.asarray(x, (q,)), mats, shape, (q,)))
    got = TB.to_numpy(TB.axis_matmul(TB.asarray(x, (q,)), mats, shape, (q,)))
    assert len(TB._merge_axis_mats(mats, list(shape), (q,))) == 1
    # every output is (q − 1)^2 · K mod q = K mod q
    assert np.array_equal(want, got) and (got == x.shape[1] % q).all()


def test_axis_matmul_refuses_an_inexact_contraction():
    from alchemy_tpu_torch.backend.torch_backend import _MAX_K, _matmul_mod

    W = torch.zeros((1, 2, _MAX_K + 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="not exact"):
        _matmul_mod(W, torch.zeros((1, 1, _MAX_K + 1, 1), dtype=torch.int64), (17,))


def _pair(m, qs, coeffs, basis="POW"):
    return (JCyc.from_coeffs(m, qs, coeffs, JG, basis),
            TCyc.from_coeffs(m, qs, coeffs, TB, basis))


def _same(jc, tc):
    return (jc.m, jc.qs, jc.basis) == (tc.m, tc.qs, tc.basis) and np.array_equal(
        JG.to_numpy(jc.data), TB.to_numpy(tc.data))


def _rand(m, qs, seed):
    return np.random.default_rng(seed).integers(0, min(qs), size=(len(qs), totient(m)))


# one limb at m = 512: each modulus costs an exact 256 × 256 inversion on the
# host in each package
@pytest.mark.parametrize("m,nlimb", [(8, 2), (512, 1), (7, 2), (9, 2), (35, 2), (91, 2), (128, 2)])
def test_crt_pow_match_jax(m, nlimb):
    qs = chain(m)[:nlimb]
    jc, tc = _pair(m, qs, _rand(m, qs, m))
    assert _same(jc.to_crt(), tc.to_crt())
    assert _same(jc.to_crt().to_pow(), tc.to_crt().to_pow())
    jb, tb = _pair(m, qs, _rand(m, qs, m + 1))
    assert _same((jc * jb).to_pow(), (tc * tb).to_pow())


def test_batched_transforms_match_jax():
    m, m_tgt = 91, 455
    qs = (find_ntt_prime(m_tgt, 30), find_ntt_prime(m_tgt, 29))
    pairs = [_pair(m, qs, _rand(m, qs, s)) for s in range(3)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    for jo, to in zip(JCyc.batched_to_basis(js, "CRT"), TCyc.batched_to_basis(ts, "CRT")):
        assert _same(jo, to)
    crt = JCyc.batched_to_basis(js, "CRT"), TCyc.batched_to_basis(ts, "CRT")
    for jo, to in zip(JCyc.batched_to_basis(crt[0], "POW"), TCyc.batched_to_basis(crt[1], "POW")):
        assert _same(jo, to)
    for jo, to in zip(JCyc.batched_embed_crt(js, m_tgt), TCyc.batched_embed_crt(ts, m_tgt)):
        assert _same(jo, to)


@pytest.mark.parametrize("m_sub,m", [(4, 512), (64, 128), (7, 91), (1365, 4095)])
def test_embed_twace_match_jax(m_sub, m):
    q = find_ntt_prime(m, 30)
    jc, tc = _pair(m_sub, (q,), _rand(m_sub, (q,), m))
    for basis in ("POW", "CRT"):
        je, te = jc.to_basis(basis).embed(m), tc.to_basis(basis).embed(m)
        assert _same(je, te)
        assert _same(je.twace(m_sub), te.twace(m_sub))


@pytest.mark.parametrize("m_sub,m,basis", [
    (64, 128, "pow"), (224, 448, "pow"), (7, 91, "pow"), (728, 2912, "pow"),
    (3, 63, "dec"), (9, 63, "dec"), (7, 63, "dec"), (8, 56, "dec"), (4, 84, "dec")])
def test_rel_coeffs_match_jax(m_sub, m, basis):
    qs = chain(m)
    jc, tc = _pair(m, qs, _rand(m, qs, m_sub))
    jr, tr = jc.rel_coeffs(m_sub, basis=basis), tc.rel_coeffs(m_sub, basis=basis)
    assert len(jr) == len(tr) and all(_same(a, b) for a, b in zip(jr, tr))
    back = TCyc.from_rel_coeffs(m, m_sub, tr, qs, TB, basis=basis)
    assert _same(JCyc.from_rel_coeffs(m, m_sub, jr, qs, JG, basis=basis), back)
    assert _same(jc, back)


def test_plaintext_mul_matches_jax():
    """Ring product over a non-NTT modulus (scratch primes, host CRT)."""
    m, p = 35, (1 << 20) + 7
    jc, tc = _pair(m, (p,), _rand(m, (p,), 1))
    jb, tb = _pair(m, (p,), _rand(m, (p,), 2))
    assert _same(jc * jb, tc * tb)


def test_checked_backend_catches_a_divergence():
    """The checked backend's pair runs both backends; a wrong torch result
    fails at the op that produced it."""
    cb = CheckedBackend(device="cpu")
    m = 91
    qs = chain(m)
    c = TCyc.from_coeffs(m, qs, _rand(m, qs, 3), cb)
    jc = JCyc.from_coeffs(m, qs, _rand(m, qs, 3), JG)
    assert np.array_equal(cb.to_numpy(c.to_crt().data), JG.to_numpy(jc.to_crt().data))
    bad = c.data._replace(dev=c.data.dev + 1)
    with pytest.raises(AssertionError, match="'add' diverged"):
        cb.add(bad, c.data, qs)
