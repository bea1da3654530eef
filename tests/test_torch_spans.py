"""Spans of the port's multiply-relinearize entries and of its compiled
programs (`jit_call` › `jit.eager` › `ir.<prim>`, `JitCompiled.prims`)
(`utils.profiling`):
off by default; under `tracing()` and under a `torch.profiler` session one
root a call over the tree of layer spans, children nested in their parents,
entry self time + glue + launches equal to the root; outputs unchanged by
tracing; the buffer's bound, `reset` and the error flag; the spans as
ranges of an exported trace, on the profiler's clock. On the card: one
launch span per counted launch, and every port kernel's device operation
after its launch span and before the synchronize of its call.

Imports no JAX: the card tests compare the port with itself."""

from __future__ import annotations

import json
import multiprocessing
import re
import statistics
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alchemy_tpu_torch.backend.cuda import launch
from alchemy_tpu_torch.backend.cuda import mul_relin as mr
from alchemy_tpu_torch.backend.cuda import rescale as rk
from alchemy_tpu_torch.she import fast, hybrid
from alchemy_tpu_torch.utils import profiling

#: the inverse transform's launch span of `rescale_joint` in each slot order
INVERSE = {"mxu": "launch.intt2_grid", "pallas": "launch.intt_grid", "vpu": "launch.intt_vpu_grid"}


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.reset()
    yield
    profiling.reset()


def _trivgad(log_n: int, L: int, device: str, order: str = "mxu", seed: int = 3):
    """(call, expected tree) of `fast.mul_relin` on two ciphertext pairs."""
    p = fast.FastParams.make(log_n, L, impl=order)
    rng = np.random.default_rng(seed)
    s = fast.keygen(p, rng, device=device)
    hints = fast.relin_hint(p, s, rng, shoup=True)
    cts = torch.stack([fast.encrypt(p, s, rng.integers(0, 2, p.n), rng) for _ in range(4)])
    tree = [("mul_relin", None), ("launch.tensor_intt", "mul_relin"),
            ("launch.digit_relin", "mul_relin")]
    return (lambda: fast.mul_relin(p, cts[:2], cts[2:], *hints)), tree, (2, L, p.n)


def _hybrid(log_n: int, L: int, device: str, order: str = "mxu", dnum: int = 2, seed: int = 4,
            plain: bool = False):
    """(call, expected tree) of `hybrid.mul_relin_hybrid` (or its plain
    version) on two ciphertext pairs."""
    p = fast.FastParams.make(log_n, L, impl=order)
    hk = hybrid.HybridKS.make(p, dnum=dnum)
    rng = np.random.default_rng(seed)
    s, hints = hybrid.hybrid_keygen_hint(hk, rng, device=device)
    cts = torch.stack([fast.encrypt(p, s, rng.integers(0, 2, p.n), rng) for _ in range(4)])
    root = "mul_relin_hybrid"
    tree = [(root, None), ("launch.tensor_intt", root), ("launch.garner_pack", root),
            ("launch.hybrid_digit_relin", root), ("rescale_joint", root),
            (INVERSE[order], "rescale_joint"), ("launch.rescale_fwd", "rescale_joint")]
    entry = hybrid.mul_relin_hybrid_plain if plain else hybrid.mul_relin_hybrid
    if plain:
        tree = [t for t in tree if not t[0].startswith("launch.")]
    return (lambda: entry(hk, cts[:2], cts[2:], *hints)), tree, (2, L, p.n)


CASES = {"trivgad": lambda: _trivgad(10, 3, "cpu"),
         "hybrid": lambda: _hybrid(10, 5, "cpu"),
         "hybrid-pallas": lambda: _hybrid(10, 5, "cpu", order="pallas"),
         "hybrid-plain": lambda: _hybrid(10, 4, "cpu", plain=True)}


def _calls(spans: list) -> list[list]:
    """The spans grouped by call, each group in the order its spans opened."""
    groups: dict[int, list] = {}
    for s in spans:
        groups.setdefault(s.call, []).append(s)
    return list(groups.values())


def _check_call(call: list, tree: list, batch_L_n: tuple) -> None:
    """One call's spans against the expected tree: names and parents in
    order, each child inside its parent, siblings one after another, no
    error, the root's attributes, and root = entry self + glue + launches."""
    root = call[0]
    by_index = {s.index: s for s in call}
    assert [(s.name, None if s.parent is None else by_index[s.parent].name)
            for s in call] == tree
    assert root.parent is None and all(s.call == root.index for s in call)
    assert (root.attrs["batch"], root.attrs["L"], root.attrs["n"]) == batch_L_n
    last_end: dict = {}
    for s in call:
        assert s.start_ns <= s.end_ns and not s.error
        if s.parent is not None:
            parent = by_index[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
            assert s.start_ns >= last_end.get(s.parent, parent.start_ns)
            last_end[s.parent] = s.end_ns
    glue = sum(s.duration_ns for s in call if s.name.startswith("glue."))
    launch = sum(s.duration_ns for s in call if s.name.startswith("launch."))
    entries = [s for s in call if s.name in (root.name, "rescale_joint")]
    own = sum(s.duration_ns - sum(c.duration_ns for c in call if c.parent == s.index)
              for s in entries)
    assert root.duration_ns == own + glue + launch
    assert own >= 0


def test_no_span_is_recorded_by_default():
    for make in (CASES["trivgad"], CASES["hybrid"]):
        call, _, _ = make()
        call()
    assert profiling.spans() == []


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", ["tracing", "profiler"])
def test_each_call_records_one_root_over_the_span_tree(case, mode):
    call, tree, batch_L_n = CASES[case]()
    off = call()
    assert profiling.spans() == []
    on = profiling.tracing() if mode == "tracing" else profile(activities=[ProfilerActivity.CPU])
    with on:
        outs = [call(), call()]
    calls = _calls(profiling.spans())
    assert len(calls) == 2
    for c in calls:
        _check_call(c, tree, batch_L_n)
    assert calls[0][0].end_ns <= calls[1][0].start_ns
    assert all(torch.equal(out, off) for out in outs)


def test_tracing_leaves_the_outputs_bit_identical():
    call, _, _ = _hybrid(10, 5, "cpu", order="vpu")
    off = call()
    with profiling.tracing():
        on = call()
    assert torch.equal(on, off) and len(_calls(profiling.spans())) == 1
    with profiling.tracing(), profiling.tracing():
        pass
    call()
    assert len(_calls(profiling.spans())) == 1        # off again after nested blocks


def test_the_buffer_keeps_the_newest_spans_up_to_its_limit(monkeypatch):
    call, tree, _ = CASES["hybrid"]()
    monkeypatch.setattr(profiling, "LIMIT", 5)
    profiling.reset()
    with profiling.tracing():
        call()
    kept = profiling.spans()
    newest = list(range(len(tree) - 5, len(tree)))
    assert [s.name for s in kept] == [name for name, _ in tree[-5:]]
    assert [s.index for s in kept] == newest
    profiling.reset()
    assert profiling.spans() == []
    with profiling.tracing():
        call()
    assert [s.index for s in profiling.spans()] == newest               # indices restart
    monkeypatch.undo()
    profiling.reset()
    with profiling.tracing():
        call()
        call()
    assert len(profiling.spans()) == 2 * len(tree)


def test_a_block_that_raises_is_flagged():
    p = fast.FastParams.make(10, 3, zp=3)
    ct = torch.zeros((2, 3, p.n), dtype=torch.int32)
    with profiling.tracing(), pytest.raises(ValueError, match="power-of-two zp"):
        with profiling.span("outer", k=1) as outer:
            hybrid.rescale_joint(p, ct, 1)
    outer_s, inner = profiling.spans()
    assert outer_s is outer and outer.attrs == {"k": 1}
    assert (inner.name, inner.parent, inner.call) == ("rescale_joint", outer.index, outer.index)
    assert inner.error and outer.error and inner.end_ns <= outer.end_ns
    with profiling.tracing():
        with profiling.span("fine"):
            pass
    assert not profiling.spans()[-1].error
    assert profiling.span("off") is profiling.span("off again")    # the shared no-op


def test_every_wrapper_opens_a_launch_span_its_counter_names():
    """Each kernel wrapper, run once on tiny CPU tensors (its plain
    version), opens one span `launch.<name>`: its names are the keys of the
    one `launch.LAUNCHES`, all 11 of them, and each span's `entry` is the C
    entry point its kernel's counter names. The CPU counts no launch."""
    chain = fast.FastParams.make(6, 4).qs
    n, qs, groups = 1 << 6, chain[:3], ((chain[0], chain[1]), (chain[2],))
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    before = dict(launch.LAUNCHES)
    with profiling.tracing():
        c0, c1, c2c = mr.tensor_intt(n, qs, z(1, 2, 3, n), z(1, 2, 3, n))
        mr.digit_relin(n, qs, c0, c1, c2c, z(3, 3, n), z(3, 3, n))
        x = mr.garner_pack(n, groups, c2c)
        mr.hybrid_digit_stage(n, chain, groups, x, (z(2, 4, n),) * 2, (z(2, 4, n),) * 2)
        for order in launch.ORDERS:
            for transform in rk.grid_transforms(order):
                transform(n, qs, z(1, 3, n))
        rk.rescale_fwd(n, qs[:2], qs[2:], 2, z(2, 3, n), z(2, 1, n))
    names = [s.name.removeprefix("launch.") for s in profiling.spans()]
    assert sorted(names) == sorted(launch.LAUNCHES)
    assert [s.attrs for s in profiling.spans()] == [{"entry": launch.ENTRIES[k]} for k in names]
    assert launch.LAUNCHES == before


def test_exported_trace_holds_the_spans_as_ranges_on_the_profilers_clock(tmp_path):
    call, tree, _ = CASES["trivgad"]()
    with profiling.trace(str(tmp_path)):
        call()
    (path,) = tmp_path.glob("*.pt.trace.json")
    data = json.loads(path.read_text())
    base = data.get("baseTimeNanoseconds", 0)
    events = [e for e in data["traceEvents"] if e.get("ph") == "X"]

    def interval(e):
        start = base + round(e["ts"] * 1000)
        return start, start + round(e["dur"] * 1000)

    spans = profiling.spans()
    assert [s.name for s in spans] == [name for name, _ in tree]
    for s in spans:
        (rng,) = [e for e in events if e["name"] == s.name]
        r0, r1 = interval(rng)
        assert s.start_ns <= r0 + 1 and r1 <= s.end_ns + 1    # the range inside the span
        if s.name.startswith("launch."):
            aten = [interval(e) for e in events if e["name"].startswith("aten::")
                    and s.start_ns <= interval(e)[0] <= s.end_ns]
            assert aten, s.name
            assert all(r0 <= a0 and a1 <= r1 for a0, a1 in aten), s.name


def _compiled_arithmetic():
    """(program, its arguments, the ciphertext prims' spans' names in order)
    of Arithmetic's addMul compiled and prepared with `jit_compile` on
    `TorchBackend("cpu")`, where a call runs the prepared program eagerly."""
    from alchemy_tpu_torch.backend.torch_backend import TorchBackend
    from alchemy_tpu_torch.core.cyc import Cyc
    from alchemy_tpu_torch.examples import arithmetic as a
    from alchemy_tpu_torch.interp.jit_exec import jit_compile
    from alchemy_tpu_torch.interp.keys_hints import KeysHints
    from alchemy_tpu_torch.interp.pt2ct import pt2ct
    from alchemy_tpu_torch.she.gadget import TrivGad

    bk, rng = TorchBackend("cpu"), np.random.default_rng(8)
    ctx = KeysHints(3.0, seed=8, bk=bk)
    compiled = pt2ct(a.addMul, res_ty=a.PT, m_map=a.M_MAP, zqs=a.ZQS, gad=TrivGad(), ctx=ctx)
    cts = [compiled.encrypt_arg(Cyc.from_coeffs(a.M, (a.ZP,), rng.integers(0, a.ZP, 2), bk), i)
           for i in range(2)]
    prims = ["ir.add_", "ir.mul_", "ir.modSwitch_", "ir.keySwitchQuad_", "ir.modSwitch_"]
    return jit_compile(compiled, cts), cts, prims


@pytest.mark.parametrize("mode", ["tracing", "profiler"])
def test_a_compiled_programs_call_records_its_root_and_one_span_a_prim(mode):
    """`JitCompiled.__call__` opens `jit_call` (prims, output ring, the
    first argument's limbs, graph) over `jit.eager` on the CPU, inside which
    the evaluator opens one `ir.<prim>` span a prim evaluated (limbs and
    ring of its argument): as many of each as `JitCompiled.prims` counts.
    Nothing is recorded by default; the output is the same either way."""
    program, cts, names = _compiled_arithmetic()
    off = program(*cts)
    assert profiling.spans() == []
    on = profiling.tracing() if mode == "tracing" else profile(activities=[ProfilerActivity.CPU])
    with on:
        out = program(*cts)
    assert all(torch.equal(x.data, y.data) for x, y in zip(off.comps, out.comps))
    root, eager, *prims = profiling.spans()
    assert (root.name, root.parent) == ("jit_call", None)
    assert root.attrs == {"prims": 5, "m": out.m_prime, "L": len(cts[0].qs), "graph": False}
    assert (eager.name, eager.parent, eager.call) == ("jit.eager", root.index, root.index)
    assert [s.name for s in prims] == names
    assert all(s.parent == eager.index and s.call == root.index for s in prims)
    assert all(s.attrs == {"L": 2, "m": 512} for s in prims[:4])
    assert program.prims == {"add_": 1, "mul_": 1, "modSwitch_": 2, "keySwitchQuad_": 1}
    assert sum(program.prims.values()) == len(prims)
    assert root.start_ns <= eager.start_ns and eager.end_ns <= root.end_ns


def test_the_plaintext_evaluator_opens_a_span_a_ring_operation():
    """The eager evaluator on plaintexts: one `ir.*` span a prim with the
    ring element's limbs and ring index; a monad prim opens none."""
    from alchemy_tpu_torch.backend import golden_backend
    from alchemy_tpu_torch.core.cyc import Cyc
    from alchemy_tpu_torch.examples import arithmetic as a
    from alchemy_tpu_torch.interp.eval import eval_ir
    from alchemy_tpu_torch.lang import dsl

    x, y = (Cyc.from_coeffs(a.M, (a.ZP,), [i, 2], golden_backend()) for i in (1, 3))
    with profiling.tracing():
        eval_ir(a.addMul, x, y)
        assert eval_ir(dsl.pure_("writer"), x) == (x, [])
    assert [(s.name, s.attrs) for s in profiling.spans()] == [
        ("ir.add_", {"L": 1, "m": 4}), ("ir.mul_", {"L": 1, "m": 4})]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _cell_call(name: str, device: str):
    """One ciphertext pair a call at a benchmark cell's shape: TrivGad at
    n = 2^15, L = 8 with Shoup hints; hybrid at L = 16, dnum = 4, raw hints."""
    rng = np.random.default_rng(15)
    if name == "trivgad":
        p = fast.FastParams.make(15, 8, impl="mxu")
        s = fast.keygen(p, rng, device=device)
        hints = fast.relin_hint(p, s, rng, shoup=True)
        cts = torch.stack([fast.encrypt(p, s, rng.integers(0, 2, p.n), rng) for _ in range(2)])
        return lambda: fast.mul_relin(p, cts[:1], cts[1:], *hints)
    p = fast.FastParams.make(15, 16, impl="mxu")
    hk = hybrid.HybridKS.make(p, dnum=4)
    s, hints = hybrid.hybrid_keygen_hint(hk, rng, device=device)
    cts = torch.stack([fast.encrypt(p, s, rng.integers(0, 2, p.n), rng) for _ in range(2)])
    return lambda: hybrid.mul_relin_hybrid(hk, cts[:1], cts[1:], *hints)


def _launches() -> int:
    return sum(launch.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["trivgad", "hybrid"])
def test_launch_spans_equal_the_launch_counters_on_the_card(card, name):
    call = _cell_call(name, card)
    call()
    launch.reset_launches()
    before = _launches()
    with profiling.tracing():
        call()
    torch.cuda.synchronize()
    launch_spans = [s for s in profiling.spans() if s.name.startswith("launch.")]
    assert len(launch_spans) == _launches() - before == (2 if name == "trivgad" else 5)
    if name == "trivgad":
        assert launch.LAUNCHES_BY_SHAPE[("digit_relin", 1, 8, 1 << 15)] == 1
    else:
        assert launch.LAUNCHES_BY_SHAPE[("hybrid_digit_relin", 1, 16, 20, 4, 1 << 15)] == 1
        assert launch.LAUNCHES_BY_SHAPE[("garner_pack", 1, 16, 4, 1 << 15)] == 1
        assert launch.LAUNCHES_BY_SHAPE[("intt2_grid", 2, 4, 1 << 15)] == 1


#: how far the profiler's device timestamps may stray from the host's
#: Unix-epoch clock: on an H100 they drifted against it by up to 200 µs over
#: a 130 ms session and stepped by 300 µs within one (a kernel read up to
#: 150 µs before its launch span, an operation's end up to 41 µs after the
#: synchronize its host had returned from)
CLOCK_NS = 1_000_000


def _device_ops(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device operation, in start order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
            dur = e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)
            out.append((e.name(), start, start + dur))
    return sorted(out, key=lambda o: o[1])


def _alignment(name: str, calls: int = 20) -> dict:
    """`calls` calls, each followed by a synchronize, under a profile of CUDA
    activity alone, in a process that has run no other profiler session (as
    the benchmark's traced run): the launch spans and port kernels counted by
    C entry; for each port kernel's k-th device operation its start less the
    start of the k-th launch span of its entry (ns); for each call the
    synchronize's return less the end of the call's last device operation."""
    call = _cell_call(name, "cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        call()
        torch.cuda.synchronize()
    profiling.reset()
    synced = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(calls):
            call()
            torch.cuda.synchronize()
            synced.append(time.time_ns())
    ops, spans = _device_ops(prof), profiling.spans()
    starts = [s.start_ns for s in spans if s.parent is None]
    last_end = [0] * len(starts)
    for _, s0, s1 in ops:
        k = int(np.searchsorted(starts, s0, side="right")) - 1
        last_end[max(k, 0)] = max(last_end[max(k, 0)], s1)
    launches: dict[str, list] = {}
    for s in spans:
        if s.name.startswith("launch."):
            launches.setdefault(s.attrs["entry"], []).append(s.start_ns)
    kernels = {e: [s0 for n, s0, _ in ops if re.search(rf"\b{e}_kernel\b", n)] for e in launches}
    return {"card": torch.cuda.get_device_name(), "roots": len(starts), "ops": len(ops),
            "spans": {e: len(v) for e, v in launches.items()},
            "kernels": {e: len(v) for e, v in kernels.items()},
            "launch_margins": [k0 - s0 for e in launches
                               for s0, k0 in zip(launches[e], kernels[e])],
            "sync_margins": [t - e for t, e in zip(synced, last_end)]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["trivgad", "hybrid"])
def test_port_kernels_follow_their_launch_spans_on_the_card(card, name):
    """In a fresh process, 20 calls of the entry at the cell's shape: each
    port kernel's device operations match its launch spans one for one, and
    on the profiler's clock the k-th starts after the k-th launch span of its
    entry and every call's operations end before its synchronize returns, to
    within how far that clock strays from the host's (`CLOCK_NS`)."""
    calls = 20
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        r = pool.submit(_alignment, name, calls).result(timeout=600)
    per_call = 2 if name == "trivgad" else 5
    assert r["roots"] == calls and sum(r["spans"].values()) == calls * per_call
    assert r["kernels"] == r["spans"] and r["ops"] == calls * per_call    # no torch op
    launch, sync = min(r["launch_margins"]), min(r["sync_margins"])
    print(f"[spans] {name} on {r['card']}: {r['ops']} device operations in {calls} calls; "
          f"launch span start -> its kernel's start min {launch / 1e3:.3f} us, median "
          f"{statistics.median(r['launch_margins']) / 1e3:.3f} us; device end -> synchronize "
          f"return min {sync / 1e3:.3f} us, median "
          f"{statistics.median(r['sync_margins']) / 1e3:.3f} us")
    assert launch > -CLOCK_NS and sync > -CLOCK_NS
