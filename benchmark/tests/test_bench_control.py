"""`correct` catches a wrong program: whole runs on the CPU at a tiny size,
past the harness's look for a card, with the port's entry replaced by the
control (the reference with float64 products) or broken underneath by each
fault a cell of these configurations can have. Each run must come out not
correct, as the program's own runs come out correct
(test_bench_harness.py)."""

from __future__ import annotations

import pytest

from benchmark import readings
from benchmark.run import run

SEED = 2**31 + 4242


@pytest.mark.parametrize("key_switching", ["trivgad", "hybrid"])
@pytest.mark.parametrize("batch", [1, 2])
def test_control_is_not_correct(tiny, key_switching, batch):
    cfg, traffic = tiny.config(key_switching), tiny.traffic(batch)
    with readings.entry_replaced(cfg, lambda _e: readings.control_entry(cfg, "cpu")):
        res = run(cfg, traffic, SEED, 0.2, False, "cpu")
    assert not res["correct"]
    assert res["checks"]["mismatch"]["value"] > 0
    assert res["checks"]["bad_slots"]["value"] > 0


@pytest.mark.parametrize("key_switching", ["trivgad", "hybrid"])
@pytest.mark.parametrize("fault,batch", [("unchanged", 1), ("unchanged", 2),
                                         ("half_batch", 2), ("altered", 1), ("altered", 2)])
def test_fault_is_not_correct(tiny, key_switching, fault, batch):
    cfg, traffic = tiny.config(key_switching), tiny.traffic(batch)
    with readings.entry_replaced(cfg, readings.FAULTS[fault]):
        res = run(cfg, traffic, SEED, 0.2, False, "cpu")
    assert not res["correct"]
    assert res["checks"]["mismatch"]["value"] > 0


def test_a_call_that_raises_is_not_correct(tiny):
    cfg, traffic = tiny.config("trivgad"), tiny.traffic(2)
    calls = []

    def flaky(entry):
        def f(*args):
            calls.append(1)
            if len(calls) % 2 == 0:
                raise RuntimeError("a failed launch")
            return entry(*args)
        return f
    with readings.entry_replaced(cfg, flaky):
        res = run(cfg, traffic, SEED, 0.2, False, "cpu")
    assert not res["correct"] and res["failed"] > 0
