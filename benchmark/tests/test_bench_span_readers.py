"""The readers of the program's spans (`benchmark/spans.py` and the metrics
`glue_host_ms.hybrid`, `glue_host_ms.hybrid_batch`, `launch_host_ms.single`,
`entry_self_ms.single`) on span buffers built by hand through the port's
recorder on a scripted clock, against values worked out by hand; nothing
from an empty or short buffer, without a trace, or in cells they do not
apply to; `idle_by_span` on known intervals."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from alchemy_tpu_torch.utils import profiling
from benchmark import run as bench_run
from benchmark import spans

NEW = ("glue_host_ms.hybrid", "glue_host_ms.hybrid_batch", "launch_host_ms.single",
       "entry_self_ms.single")


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
    """Record (name, start, end, attrs, children) and its children, the
    clock at each span's start when it opens and at its end when it closes."""
    name, start, end, attrs, children = node
    clock.now = start
    with profiling.tracing(), profiling.span(name, **attrs):
        for child in children:
            play(clock, child)
        clock.now = end


def hybrid_call(t: int, garner: int, shape: dict) -> tuple:
    """One hybrid call from t: glue = garner + 300 + 80 ns, launches
    50 + 50 + 30 + 40 = 170 ns, self 150 ns, root garner + 700 ns."""
    g = garner - 300
    return ("mul_relin_hybrid", t, t + 1000 + g, shape, [
        ("launch.tensor_intt", t + 10, t + 60, {"entry": "tensor_intt"}, []),
        ("glue.garner_pack", t + 60, t + 360 + g, {}, []),
        ("launch.hybrid_digit_relin", t + 370 + g, t + 420 + g, {"entry": "hybrid_digit_relin"},
         []),
        ("rescale_joint", t + 430 + g, t + 900 + g, {}, [
            ("launch.intt2_grid", t + 440 + g, t + 470 + g, {"entry": "intt_grid"}, []),
            ("glue.rescale_digits", t + 470 + g, t + 770 + g, {}, []),
            ("launch.rescale_fwd", t + 780 + g, t + 820 + g, {"entry": "rescale_fwd"}, [])]),
        ("glue.add_back", t + 900 + g, t + 980 + g, {}, [])])


def trivgad_call(t: int, b: int, shape: dict) -> tuple:
    """One TrivGad call from t: launches 40 + b ns, self 30 ns."""
    return ("mul_relin", t, t + 70 + b, shape, [
        ("launch.tensor_intt", t + 10, t + 30, {"entry": "tensor_intt"}, []),
        ("launch.digit_relin", t + 40, t + 60 + b, {"entry": "digit_relin"}, [])])


def ctx_of(tiny, ks: str, batch: int, calls: int = 3) -> dict:
    cfg, traffic = tiny.config(ks), tiny.traffic(batch)
    return {"cfg": cfg, "traffic": traffic, "trace": {"calls": calls}, "card": None,
            "notes": {}, "window": {"host_s": [0.001]}}


def shape_of(ctx: dict) -> dict:
    return {"batch": ctx["traffic"]["batch"], "L": len(ctx["cfg"]["qs"]), "n": ctx["cfg"]["n"]}


def read_all(ctx: dict) -> dict:
    readers = bench_run.readers()
    return {name: readers[name].read(ctx) for name in NEW}


@pytest.mark.parametrize("batch", [1, 2])
def test_readers_on_hand_built_hybrid_calls(tiny, clock, batch):
    ctx = ctx_of(tiny, "hybrid", batch)
    shape = shape_of(ctx)
    play(clock, hybrid_call(0, 900, shape))                     # before the slice: not read
    play(clock, hybrid_call(5000, 300, {**shape, "n": 2048}))   # another shape: not read
    for k, garner in enumerate((300, 500, 100)):
        play(clock, hybrid_call(10_000 + 2000 * k, garner, shape))
    got = read_all(ctx)
    glue_ms = 680 / 1e6                                          # median of 680, 880, 480 ns
    if batch == 1:
        assert got == {"glue_host_ms.hybrid": pytest.approx(glue_ms),
                       "glue_host_ms.hybrid_batch": None,
                       "launch_host_ms.single": pytest.approx(170 / 4 / 1e6),
                       "entry_self_ms.single": pytest.approx(150 / 1e6)}
        assert ctx["notes"]["entry_self_ms.single"] == {
            "calls": 3, "root_ms_median": pytest.approx(1000 / 1e6),
            "launch_spans_per_call": 4.0}
    else:
        assert got == {"glue_host_ms.hybrid": None,
                       "glue_host_ms.hybrid_batch": pytest.approx(glue_ms),
                       "launch_host_ms.single": None, "entry_self_ms.single": None}
        assert ctx["notes"]["glue_host_ms.hybrid_batch"]["launch_spans_per_call"] == 4.0


def test_readers_on_hand_built_trivgad_calls(tiny, clock):
    ctx = ctx_of(tiny, "trivgad", 1, calls=4)
    for k, b in enumerate((0, 10, 20, 30)):
        play(clock, trivgad_call(1000 * k, b, shape_of(ctx)))
    calls = spans.slice_calls(ctx)
    assert [[s.name for s in c] for c in calls] == [
        ["mul_relin", "launch.tensor_intt", "launch.digit_relin"]] * 4
    assert read_all(ctx) == {"glue_host_ms.hybrid": None, "glue_host_ms.hybrid_batch": None,
                             "launch_host_ms.single": pytest.approx((4 * 40 + 60) / 8 / 1e6),
                             "entry_self_ms.single": pytest.approx(30 / 1e6)}
    assert ctx["notes"]["launch_host_ms.single"]["root_ms_median"] == pytest.approx(85 / 1e6)


def test_readers_give_nothing_without_enough_spans(tiny, clock):
    ctx = ctx_of(tiny, "hybrid", 1)
    assert set(read_all(ctx).values()) == {None}                 # empty buffer
    for k in range(2):
        play(clock, hybrid_call(2000 * k, 300, shape_of(ctx)))
    assert set(read_all(ctx).values()) == {None}                 # 2 roots, 3 calls traced
    play(clock, hybrid_call(4000, 300, shape_of(ctx)))
    assert read_all(ctx)["glue_host_ms.hybrid"] == pytest.approx(680 / 1e6)
    assert set(read_all({**ctx, "trace": None}).values()) == {None}
    other = ctx_of(tiny, "trivgad", 1)                          # no TrivGad root in the buffer
    assert set(read_all(other).values()) == {None}
    assert not other["notes"]


def test_idle_by_span_on_known_intervals(clock):
    play(clock, ("root", 100, 400, {}, [("launch.a", 120, 150, {}, []),
                                        ("glue.b", 200, 300, {}, [])]))
    ops = [("a_kernel", 160, 260), ("glue_op", 250, 320), ("late", 500, 520)]
    got = spans.idle_by_span(ops, profiling.spans(), 0, 600)
    # idle [0, 160): outside 100, root 20 + 10, launch.a 30; [320, 500): glue none, root 80,
    # outside 100; [520, 600): outside 80
    assert got == {"outside": pytest.approx(280e-9), "root": pytest.approx(110e-9),
                   "launch.a": pytest.approx(30e-9)}
    assert sum(got.values()) == pytest.approx((600 - 160 - 20) * 1e-9)   # all but busy time


def test_span_profile_runs_on_the_cpu(tiny, monkeypatch):
    from benchmark import span_profile

    cfg, traffic = tiny.config("hybrid"), tiny.traffic(1)
    monkeypatch.setattr(span_profile, "load_cell", lambda name: ({}, cfg, traffic))
    out = span_profile.profile("tiny", 2**31 + 11, 0.05, 2, device="cpu")
    assert [w["spans"] for w in out["windows"]] == [False, True, True, False]
    assert all(w["calls"] >= 1 and w["call_p95_ms"] > 0 for w in out["windows"])
    assert set(out["span_cost_ns"]) == {"empty_loop", "off", "on"}
    assert all(s["launch_spans_per_call"] == 4.0 for s in out["on_window_split"])
    sl = out["slice"]
    assert sl["split"]["calls"] == 2 and sl["split"]["launch_spans_per_call"] == 4.0
    assert sl["busy_s"] == 0 and sum(sl["idle_s_by_span"].values()) == pytest.approx(
        sl["window_s"])
    assert sl["launch_margins"]["spans"]["intt_grid"] == 2 and "min_us" not in sl["launch_margins"]
