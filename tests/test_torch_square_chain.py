"""The depth-D squaring chain from prepared levels
(`examples.deep_circuit.chain_keys` and `square_chain`) at n = 2^10, depth 4
(6 → 2 limbs: hybrid key switching at dnum 2 and 1, K = 3 and 4): equal to
`deep_circuit.run`'s final ciphertext for the seed; the benchmark's chain
system equal to the plain reference (`benchmark/reference_chain.py`)
residue for residue and decrypting to the message's 2^depth-th power; the
chain judge failing a broken chain and the float64 control; the chain's
spans and the rescale counters."""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from alchemy_tpu_torch.examples import deep_circuit
from alchemy_tpu_torch.she import fast, hybrid
from alchemy_tpu_torch.she.keys import gaussian_coeffs
from alchemy_tpu_torch.utils import profiling
from benchmark import readings, readings_chain, reference_chain
from benchmark.run import run
from benchmark.systems import bgv_square_chain

LOG_N, DEPTH = 10, 4
SEED = 2**31 + 4242


def tiny_chain_config(log_n: int = LOG_N, depth: int = DEPTH) -> dict:
    """A chain configuration of the benchmark's kind at a tiny ring, each
    level's dnum and special primes as `HybridKS.make` finds them."""
    p = fast.FastParams.make(log_n, depth + 2)
    levels = []
    for i in range(depth):
        hk = hybrid.HybridKS.make(replace(p, qs=p.qs[:len(p.qs) - i]))
        levels.append({"L": len(p.qs) - i, "dnum": hk.dnum, "special_primes": list(hk.ps)})
    return {"name": "tiny_chain", "system": "bgv_square_chain", "n": p.n, "qs": list(p.qs),
            "zp": 2, "order": "mxu", "key_switching": "hybrid", "shoup_hints": False,
            "variance": 10.24, "depth": depth, "levels": levels,
            "limits": {"mismatch": 0, "bad_slots": 0}}


TRAFFIC = {"loop": "closed", "callers": 1, "batch": 1, "sync_each_call": True,
           "pool_min_bytes": 0, "warmup_calls": 1, "kept_calls": 2, "trace_calls": 2,
           "end_to_end": ["call_p95_ms"]}


def test_tiny_config_covers_both_group_widths_and_two_dnums():
    levels = tiny_chain_config()["levels"]
    assert [lv["L"] for lv in levels] == [6, 5, 4, 3]
    assert {lv["dnum"] for lv in levels} == {1, 2}
    assert {len(lv["special_primes"]) for lv in levels} == {3, 4}


@pytest.mark.parametrize("impl", ["mxu", "vpu"])
@pytest.mark.parametrize("ks", ["hybrid", "trivgad"])
def test_square_chain_equals_run(ks, impl):
    """From run's own draws (key, message, encryption, then each level's
    hint), the prepared chain gives run's final ciphertext bit for bit."""
    seed = 7
    ok, want, _ = deep_circuit.run(log_n=LOG_N, depth=DEPTH, seed=seed, verbose=False,
                                   impl=impl, ks=ks, device="cpu")
    assert ok
    rng = np.random.default_rng(seed)
    p = fast.FastParams.make(LOG_N, DEPTH + 2, zp=2, impl=impl)
    s_int = gaussian_coeffs(rng, 1.0, p.n)
    ct = fast.encrypt(p, deep_circuit.key_at(p, s_int, "cpu"), rng.integers(0, 2, p.n), rng)
    levels = deep_circuit.chain_keys(p, DEPTH, s_int, rng, ks, "cpu")
    assert [len(lv.p.qs) for lv in levels] == [6, 5, 4, 3]
    assert all((lv.hk is None) == (ks == "trivgad") for lv in levels)
    got = deep_circuit.square_chain(levels, ct)
    assert got.shape == (2, 2, p.n) and torch.equal(got, want)


@pytest.mark.parametrize("seed", [SEED, 2**64 + 99])
def test_chain_system_equals_the_reference(seed):
    """The benchmark's chain system (the port) against the plain reference
    on the seed's key, hints and ciphertexts: every residue equal, and the
    reference's decryption is the message's 2^depth-th power."""
    cfg = tiny_chain_config()
    traffic = {**TRAFFIC, "pool_min_bytes": 3 * 2 * len(cfg["qs"]) * cfg["n"] * 4}
    system = bgv_square_chain.System(cfg, traffic, seed, torch.device("cpu"))
    assert system.slots == 3
    outs = torch.stack([system.call(k) for k in range(system.slots)])   # [3, 1, 2, 2, n]
    chain = reference_chain.Chain(cfg, seed, "cpu")
    ct, lifts = chain.encrypt(seed, range(3))
    want = chain.run(ct)
    assert torch.equal(outs[:, 0].to(torch.int64) & 0xFFFFFFFF, want)
    msg = reference_chain.expected_power(lifts, DEPTH)
    assert torch.equal(chain.bottom.decrypt(want, 2), msg)
    assert torch.equal(msg[0], torch.from_numpy(
        deep_circuit.expected_square_chain_mod2(lifts[0], cfg["n"], DEPTH)))
    system.close()


def test_chain_system_runs_correct_through_the_harness():
    res = run(tiny_chain_config(), TRAFFIC, SEED, 0.2, False, "cpu")
    assert res["correct"] and res["compared_calls"] >= 1
    assert res["checks"] == {"mismatch": {"value": 0, "limit": 0},
                             "bad_slots": {"value": 0, "limit": 0}}


def test_chain_system_refuses_levels_that_differ_from_hybridks():
    cfg = tiny_chain_config()
    cfg["levels"][2]["dnum"] = 2
    with pytest.raises(ValueError, match="L = 4"):
        bgv_square_chain.System(cfg, TRAFFIC, SEED, torch.device("cpu"))


@pytest.mark.parametrize("side", ["altered", "unchanged", "control"])
def test_chain_judge_fails_a_wrong_chain(side):
    """One residue altered at every level's product, a product that returns
    its operand, and the reference in float64 products in place of the
    chain: each run comes out not correct, with residues that differ."""
    cfg = tiny_chain_config()
    if side == "control":
        ctx = readings_chain.chain_replaced(
            lambda _entry: readings_chain.control_chain(cfg, SEED, "cpu"))
    else:
        ctx = readings.entry_replaced(cfg, readings.FAULTS[side])
    with ctx:
        res = run(cfg, TRAFFIC, SEED, 0.2, False, "cpu")
    assert not res["correct"]
    assert res["checks"]["mismatch"]["value"] > 0


def test_traced_chain_has_its_span_tree_and_counts_its_rescales():
    """One `square_chain` root; `depth` `chain.level` spans under it, each
    over one `mul_relin_hybrid` and one `rescale` holding one
    `rescale_joint` over its two launch spans (the inverse transform's, then
    kernel 7's), and no span of any other name; the `rescale` spans count
    one rescale a level, by L."""
    cfg = tiny_chain_config()
    system = bgv_square_chain.System(cfg, TRAFFIC, SEED, torch.device("cpu"))
    profiling.reset()
    with profiling.tracing():
        out = system.call(0)
    buf = profiling.spans()
    profiling.reset()
    roots = [s for s in buf if s.parent is None]
    assert [r.name for r in roots] == ["square_chain"]
    root = roots[0]
    assert root.attrs == {"batch": 1, "L": 6, "depth": DEPTH, "n": cfg["n"]}

    def children(span, name=None):
        return [s for s in buf if s.parent == span.index and name in (None, s.name)]
    levels = children(root)
    assert [(s.name, s.attrs) for s in levels] == [
        ("chain.level", {"level": i, "L": 6 - i}) for i in range(DEPTH)]
    rescales = []
    for lv in levels:
        assert [s.name for s in children(lv)] == ["mul_relin_hybrid", "rescale"]
        rs = children(lv, "rescale")[0]
        assert rs.attrs == {"L": lv.attrs["L"], "k_drop": 1}
        assert [s.name for s in children(rs)] == ["rescale_joint"]
        assert [s.name for s in children(children(rs)[0])] == ["launch.intt2_grid",
                                                               "launch.rescale_fwd"]
        rescales.append(rs)
    product = {"mul_relin_hybrid", "rescale_joint", "launch.tensor_intt", "launch.garner_pack",
               "launch.hybrid_digit_relin", "launch.intt2_grid", "launch.rescale_fwd"}
    assert {s.name for s in buf} == {"square_chain", "chain.level", "rescale"} | product
    assert sorted(s.attrs["L"] for s in buf if s.name == "rescale") == [3, 4, 5, 6]
    assert len([s for s in buf if s.name == "rescale"]) == len(rescales) == DEPTH
    assert torch.equal(out, system.call(0)) and not profiling.spans()
    system.close()
