"""The readers of the chain cell (`rescale_glue_ms.chain`,
`rescale_glue_share.chain`, and `benchmark/chain_spans.py` beneath the first)
on span buffers recorded through the port's recorder on a scripted clock and
on known trace summaries, against values worked out by hand; nothing in the
contexts of the other four cells, without a trace, or from a short buffer."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from alchemy_tpu_torch.utils import profiling
from benchmark import chain_spans, trace
from benchmark import run as bench_run

NEW = ("rescale_glue_ms.chain", "rescale_glue_share.chain")
OTHER_CELLS = ("trivgad.batch16", "hybrid.batch16", "trivgad.single", "hybrid.single")


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def clock(monkeypatch):
    """The recorder's clock, set by hand: spans read `clock.now`."""
    c = SimpleNamespace(now=0, perf_counter=time.perf_counter)
    c.time_ns = lambda: c.now
    monkeypatch.setattr(profiling, "time", c)
    return c


def play(clock, node) -> None:
    """Record (name, start, end, attrs, children) and its children."""
    name, start, end, attrs, children = node
    clock.now = start
    with profiling.tracing(), profiling.span(name, **attrs):
        for child in children:
            play(clock, child)
        clock.now = end


def chain_call(t: int, glue: list[int], shape: dict) -> tuple:
    """One chain from t, a level every 1000 ns: a product span, then a
    rescale whose `glue.rescale` lasts glue[i] ns between two launch spans."""
    levels = []
    for i, g in enumerate(glue):
        a = t + 1000 * i
        levels.append(("chain.level", a, a + 900, {"level": i, "L": shape["L"] - i}, [
            ("mul_relin_hybrid", a + 10, a + 400, {"batch": 1, "L": shape["L"] - i, "n": 8},
             [("launch.tensor_intt", a + 20, a + 60, {"entry": "tensor_intt"}, [])]),
            ("rescale", a + 410, a + 890, {"L": shape["L"] - i, "k_drop": 1}, [
                ("launch.intt2_grid", a + 420, a + 450, {"entry": "intt_grid"}, []),
                ("glue.rescale", a + 450, a + 450 + g, {}, []),
                ("launch.ntt2_grid", a + 460 + g, a + 480 + g, {"entry": "ntt_grid"}, [])])]))
    return ("square_chain", t, t + 1000 * len(glue), shape, levels)


def chain_cfg(depth: int = 3) -> dict:
    return {"qs": [17] * (depth + 2), "n": 8, "depth": depth, "key_switching": "hybrid"}


def ctx_of(cfg: dict, traffic: dict, summary) -> dict:
    return {"cfg": cfg, "traffic": traffic, "trace": summary, "window": {"host_s": [0.001]},
            "card": {"name": "card", "power_limit_w": 700.0, "clock_max_mhz": 1980.0},
            "notes": {}}


def summary(calls: int = 2) -> dict:
    """Port kernels 10 + 20 ns, `garner_pack_kernel` 5 ns, two torch ops
    6 + 4 ns (one overlapping a port kernel), over 100 ns of wall time."""
    events = [("void tensor_intt_kernel<S>(unsigned*)", 0, 10),
              ("garner_pack_kernel(unsigned const*, unsigned*)", 10, 15),
              ("void rescale_fwd_kernel<S>(unsigned*)", 20, 40),
              ("void at::native::elementwise_kernel<128, 2>(int)", 38, 42),
              ("void at::native::vectorized_elementwise_kernel<4, "
               "at::native::remainder_kernel_cuda(at::TensorIteratorBase&)>(int)", 40, 46)]
    return trace.summarize(events, 100e-9, calls)


TRAFFIC = {"batch": 1, "sync_each_call": True}


def test_rescale_glue_ms_is_the_median_chain_sum(clock):
    cfg = chain_cfg()
    shape = {"batch": 1, "L": 5, "depth": 3, "n": 8}
    for i, glue in enumerate(([100, 100, 100], [10, 20, 30], [40, 50, 60], [5, 5, 5])):
        play(clock, chain_call(10_000 * i, glue, shape))
    # a chain at another depth and a lone product are not the cell's
    play(clock, chain_call(50_000, [1, 1], {**shape, "depth": 2}))
    play(clock, ("mul_relin_hybrid", 60_000, 60_100, {"batch": 1, "L": 5, "n": 8}, []))
    ctx = ctx_of(cfg, TRAFFIC, summary(calls=3))
    got = bench_run.readers()["rescale_glue_ms.chain"].read(ctx)
    assert got == pytest.approx(60 / 1e6)          # median of 60, 150, 15 ns
    note = ctx["notes"]["rescale_glue_ms.chain"]
    assert note["calls"] == 3 and note["rescale_spans_per_call"] == 3.0
    assert note["root_ms_median"] == pytest.approx(3000 / 1e6)
    calls = chain_spans.slice_calls(ctx)
    assert [len(c) for c in calls] == [1 + 3 * 7] * 3
    assert [chain_spans.summed_ns(c, "glue.rescale") for c in calls] == [60, 150, 15]


def test_rescale_glue_ms_needs_enough_chains(clock):
    play(clock, chain_call(0, [10, 10, 10], {"batch": 1, "L": 5, "depth": 3, "n": 8}))
    reader = bench_run.readers()["rescale_glue_ms.chain"]
    assert reader.read(ctx_of(chain_cfg(), TRAFFIC, summary(calls=2))) is None
    assert reader.read(ctx_of(chain_cfg(), TRAFFIC, None)) is None
    assert reader.read(ctx_of(chain_cfg(), TRAFFIC, summary(calls=1))) == pytest.approx(30e-6)


def test_rescale_glue_share_counts_what_is_neither_a_port_kernel_nor_garner():
    s = summary()
    assert s["busy_s"] == pytest.approx(41e-9)      # [0, 15] + [20, 46]
    got = bench_run.readers()["rescale_glue_share.chain"].read(ctx_of(chain_cfg(), TRAFFIC, s))
    assert got == pytest.approx(100 * 10 / 41)


@pytest.mark.parametrize("cell", OTHER_CELLS)
def test_new_readers_read_nothing_in_the_other_cells(clock, cell):
    """The other cells' configurations, a summary holding glue, and a
    buffer of their own entry's roots: the chain readers give nothing."""
    _, cfg, traffic = bench_run.load_cell(cell)
    for i in range(3):
        play(clock, ("mul_relin_hybrid", 1000 * i, 1000 * i + 500,
                     {"batch": traffic["batch"], "L": len(cfg["qs"]), "n": cfg["n"]},
                     [("glue.rescale", 1000 * i + 10, 1000 * i + 20, {}, [])]))
    ctx = ctx_of(cfg, traffic, summary())
    readers = bench_run.readers()
    assert {name: readers[name].read(ctx) for name in NEW} == dict.fromkeys(NEW)


def test_chain_cell_reads_the_single_cells_device_metrics(clock):
    """In the chain cell's own context every reader that lists it reads, and
    the single-product span readers give nothing (their roots are children
    of `square_chain` there)."""
    _, cfg, traffic = bench_run.load_cell("deep16.chain")
    shape = {"batch": 1, "L": 18, "depth": 16, "n": cfg["n"]}
    for i in range(2):
        play(clock, chain_call(100_000 * i, [10] * 16, shape))
    ctx = ctx_of(cfg, traffic, summary(calls=2))
    got = {k: m.read(ctx) for k, m in bench_run.readers().items()}
    read = {k for k, v in got.items() if v is not None}
    assert {"idle.single", "launches_per_call.single", *NEW} <= read
    assert not read & {"glue_host_ms.hybrid", "launch_host_ms.single", "entry_self_ms.single",
                       "glue_share.hybrid", "hybrid_digit_relin_roofline", "idle.batch"}
    assert got["rescale_glue_ms.chain"] == pytest.approx(160e-6)


def test_chain_profile_splits_device_time_by_level():
    """Two chains of two levels: each level from its kernel A; the torch ops
    after a level's second inverse transform are its rescale's glue."""
    from benchmark import chain_profile

    level = [("void tensor_intt_kernel<S>()", 10), ("garner_pack_kernel()", 2),
             ("void hybrid_digit_relin_kernel<S>()", 40), ("void intt_grid_kernel<S>()", 6),
             ("void rescale_fwd_kernel<S>()", 8), ("void intt_grid_kernel<S>()", 4),
             ("void at::native::vectorized_elementwise_kernel<4>(int)", 3),
             ("void at::native::elementwise_kernel<128, 2>(int)", 5),
             ("void ntt_grid_kernel<S>()", 4)]
    events, t = [], 0
    for _ in range(4):
        for name, d in level:
            events.append((name, t, t + d * 1000))
            t += d * 1000
    got = chain_profile.by_level(events, depth=2, calls=2)
    want = {"tensor_intt": 0.01, "garner_pack_kernel": 0.002, "hybrid_digit_relin": 0.04,
            "intt_grid": 0.01, "rescale_fwd": 0.008, "rescale_glue": 0.008, "ntt_grid": 0.004}
    assert len(got) == 2
    for lv in got:
        assert lv.keys() == want.keys()
        assert all(lv[k] == pytest.approx(v) for k, v in want.items())
