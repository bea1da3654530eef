"""The plain reference against the port at tiny sizes on the CPU: its
transforms against the port's "mxu" slot order, its keys, hints and
ciphertexts against what the port derives from the same streams, and its
multiply + relinearize against the port's plain path, for TrivGad and for
hybrid key switching; its control differs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import inputs, reference

SEED = 2**31 + 977


def test_transforms_match_the_port_slot_order():
    from alchemy_tpu_torch.backend.ntt2 import intt2, ntt2
    from alchemy_tpu_torch.nt.primes import root_of_unity
    from alchemy_tpu_torch.she import fast

    for log_n in (10, 11):
        p = fast.FastParams.make(log_n, 3)
        ring = reference.Ring(p.n, p.qs, "mxu", "cpu")
        for q in p.qs:
            assert reference.root_2n(q, p.n) == root_of_unity(2 * p.n, q)
        rng = np.random.default_rng(log_n)
        x = torch.from_numpy(reference.uniform(rng, p.qs, p.n)[None])
        assert torch.equal(ring.ntt(x), ntt2(x, p.n, p.qs))
        assert torch.equal(ring.intt(ring.ntt(x)), x)
        assert torch.equal(ring.intt(x), intt2(x, p.n, p.qs))


def test_other_slot_orders_are_refused():
    with pytest.raises(ValueError):
        reference.Ring(1024, (12289,), "pallas", "cpu")


def _port_side(cfg):
    """The port's keys, hints and two pairs of ciphertexts from the seed's
    streams, and its entry."""
    from alchemy_tpu_torch.she import fast, hybrid

    p = fast.FastParams(n=cfg["n"], qs=tuple(cfg["qs"]), zp=cfg["zp"], impl="mxu")
    var = cfg["variance"]
    if cfg["key_switching"] == "trivgad":
        s = fast.keygen(p, inputs.stream(SEED, inputs.KEY), var, device="cpu")
        hints = fast.relin_hint(p, s, inputs.stream(SEED, inputs.HINT), var, shoup=True)

        def entry(a, b):
            return fast.mul_relin(p, a, b, *hints)
    else:
        hk = hybrid.HybridKS(p=p, dnum=cfg["dnum"], ps=tuple(cfg["special_primes"]))
        s, hints = hybrid.hybrid_keygen_hint(hk, inputs.stream(SEED, inputs.KEY), var, var,
                                             device="cpu")

        def entry(a, b):
            return hybrid.mul_relin_hybrid(hk, a, b, *hints)
    cts = []
    for i in range(4):
        rng = inputs.stream(SEED, inputs.CIPHERTEXT, i)
        cts.append(fast.encrypt(p, s, inputs.message(rng, cfg["zp"], p.n), rng, var))
    return p, s, hints, torch.stack(cts[:2]), torch.stack(cts[2:]), entry


def _wide(t):
    return t.to(torch.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("key_switching", ["trivgad", "hybrid"])
def test_reference_matches_the_port(tiny, key_switching):
    from alchemy_tpu_torch.she import fast

    cfg = tiny.config(key_switching)
    p, s, hints, ct_a, ct_b, entry = _port_side(cfg)
    keys = reference.Keys(cfg, SEED, "cpu")
    assert torch.equal(keys.s, _wide(s))
    hb = hints[0][0] if isinstance(hints[0], tuple) else hints[0]
    ha = hints[1][0] if isinstance(hints[1], tuple) else hints[1]
    assert torch.equal(keys.hb, _wide(hb)) and torch.equal(keys.ha, _wide(ha))
    ra, lift_a = keys.encrypt(cfg, SEED, [0, 1])
    rb, lift_b = keys.encrypt(cfg, SEED, [2, 3])
    assert torch.equal(ra, _wide(ct_a)) and torch.equal(rb, _wide(ct_b))
    out = _wide(entry(ct_a, ct_b))
    assert torch.equal(keys.mul_relin(cfg, ra, rb), out)
    want = reference.negacyclic_mod(lift_a, lift_b, cfg["qs"][0], cfg["zp"], "cpu")
    assert torch.equal(keys.decrypt(out, cfg["zp"]), want)
    assert np.array_equal(fast.decrypt(p, s, out[1].to(torch.int32)), want[1].numpy())


@pytest.mark.parametrize("key_switching", ["trivgad", "hybrid"])
def test_control_differs(tiny, key_switching):
    cfg = tiny.config(key_switching)
    keys = reference.Keys(cfg, SEED, "cpu")
    ctl = reference.Keys(cfg, SEED, "cpu", reference.float64_mul)
    ra, _ = keys.encrypt(cfg, SEED, [0])
    rb, _ = keys.encrypt(cfg, SEED, [1])
    want = keys.mul_relin(cfg, ra, rb)
    got = ctl.mul_relin(cfg, ra, rb)
    assert (got != want).float().mean() > 0.9


def test_streams_take_any_seed():
    a = inputs.message(inputs.stream(-5, inputs.CIPHERTEXT, 3), 2, 64)
    b = inputs.message(inputs.stream(2**64 - 5, inputs.CIPHERTEXT, 3), 2, 64)
    c = inputs.message(inputs.stream(2**40 + 1, inputs.CIPHERTEXT, 3), 2, 64)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
