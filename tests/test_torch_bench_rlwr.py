"""The benchmark's HomomRLWR configuration (`benchmark/configs/homomrlwr_jit.json`,
`benchmark/systems/homomrlwr_jit.py`) and its plain reference
(`benchmark/reference_rlwr.py`): the reference's ring pieces against the
port's `Cyc` on seeded elements (products, basis changes, embeddings, twaces,
relative decoding coefficients, a `LinearMap`); its clear ringRound against
the port's plaintext evaluation at ALCHEMY's tower; its decryption of port
ciphertexts; a small program (one tunnel, then the rescale tree at K = 2)
through `jit_compile` on `TorchBackend("cpu")`, decrypted by the reference
to its clear result; the configuration's maps against `dec_to_crt`; the
readers on a context of the configuration. On the card: the cell's system
for a few calls, judged, with its replay spans.

Imports no JAX: the reference is held against the port."""

from __future__ import annotations

import ast
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from alchemy_tpu_torch.backend import golden_backend
from alchemy_tpu_torch.backend.torch_backend import TorchBackend
from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.core.params import RnsChain
from alchemy_tpu_torch.examples import common, homomrlwr
from alchemy_tpu_torch.interp.eval import eval_ir
from alchemy_tpu_torch.interp.jit_exec import jit_compile
from alchemy_tpu_torch.interp.keys_hints import KeysHints
from alchemy_tpu_torch.interp.noise import PtTy
from alchemy_tpu_torch.interp.pt2ct import pt2ct
from alchemy_tpu_torch.lang.dsl import compose
from alchemy_tpu_torch.lang.rescale_tree import rescale_tree_pow2
from alchemy_tpu_torch.nt.primes import find_ntt_prime
from alchemy_tpu_torch.she import bgv
from alchemy_tpu_torch.she.gadget import TrivGad
from alchemy_tpu_torch.she.keys import SK
from alchemy_tpu_torch.utils import profiling
from benchmark import reference_rlwr as R
from benchmark import run as bench_run
from benchmark import trace
from benchmark.systems import homomrlwr_jit

ROOT = Path(__file__).resolve().parents[1]
CFG = bench_run.load("configs", "homomrlwr_jit")
TRAFFIC = bench_run.load("traffic", "evaluate")
OLD_CELLS = ("trivgad.batch16", "hybrid.batch16", "trivgad.single", "hybrid.single",
             "deep16.chain")
NEW = ("gemm_share.rlwr", "modq_share.rlwr", "jit_host_ms.rlwr")
#: the prims of the compiled HomomRLWR program
CFG_PRIMS = {"modSwitch_": 26, "modSwitchPT_": 15, "addPublic_": 9, "keySwitchQuad_": 8,
             "mul_": 8, "tunnel_": 5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the reference's many small int64 ops run several
    times faster so on a shared host than spread over its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pow(c: Cyc) -> torch.Tensor:
    return torch.from_numpy(c.bk.to_numpy(c.to_pow().data)[0].astype(np.int64))


# ---------------------------------------------------------------------------
# the reference's rings against the port's Cyc
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [8, 45, 91, 896, 4095])
def test_products_and_decoding_basis_match_the_port(m):
    bk, ring, rng = golden_backend(), R.Ring(m), np.random.default_rng(m)
    for q in (find_ntt_prime(m, 30), 32):
        a, b = rng.integers(0, q, ring.phi), rng.integers(0, q, ring.phi)
        ca, cb = Cyc.from_coeffs(m, (q,), a, bk), Cyc.from_coeffs(m, (q,), b, bk)
        assert torch.equal(R.mul(ring, torch.from_numpy(a), torch.from_numpy(b), q),
                           _pow(ca * cb))
        dec = R.to_dec(ring, torch.from_numpy(a), q)
        want = ca._pow_dec_convert(frozenset(), invert=False)[0].astype(np.int64) % q
        assert torch.equal(dec, torch.from_numpy(want))
        assert torch.equal(R.from_dec(ring, dec, q), torch.from_numpy(a))


@pytest.mark.parametrize("small,big", [(8, 24), (9, 45), (5, 45), (128, 896), (1365, 5460),
                                       (4095, 20475)])
def test_embed_twace_and_relative_coefficients_match_the_port(small, big):
    bk, rng = golden_backend(), np.random.default_rng(small)
    rs, rb = R.Ring(small), R.Ring(big)
    q = find_ntt_prime(big, 30)
    x, y = rng.integers(0, q, rs.phi), rng.integers(0, q, rb.phi)
    cx, cy = Cyc.from_coeffs(small, (q,), x, bk), Cyc.from_coeffs(big, (q,), y, bk)
    assert torch.equal(R.embed(rs, rb, torch.from_numpy(x)), _pow(cx.embed(big)))
    assert torch.equal(R.twace(rb, rs, torch.from_numpy(y), q), _pow(cy.twace(small)))
    want = torch.stack([_pow(c) for c in cy.rel_coeffs(small, basis="dec")])
    assert torch.equal(R.rel_coeffs(rb, rs, torch.from_numpy(y), q), want)


def test_linear_map_matches_the_port():
    bk, rng = golden_backend(), np.random.default_rng(5)
    hop = CFG["maps"][0]
    f = common.dec_to_crt(hop["r"], hop["s"], CFG["zp_in"], bk)
    x = rng.integers(0, 32, (3, R.Ring(hop["r"]).phi))
    got = R.linear(hop, torch.from_numpy(x), 32)
    for row, g in zip(x, got):
        assert torch.equal(g, _pow(f.eval(Cyc.from_coeffs(hop["r"], (32,), row, bk))))


# ---------------------------------------------------------------------------
# ringRound in the clear, decryption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 2**40 + 17])
def test_clear_ring_round_matches_the_port_at_alchemys_tower(seed):
    bk = TorchBackend("cpu")
    s, a = R.secret(CFG, seed), R.public(CFG, seed, 11)
    sa = Cyc.from_coeffs(128, (32,), s, bk) * Cyc.from_coeffs(128, (32,), a, bk)
    port = eval_ir(homomrlwr.ring_round(bk), sa)
    got = R.ring_round(CFG, torch.from_numpy(s), torch.from_numpy(a)[None])
    assert got.shape == (1, 1728) and torch.equal(got[0], _pow(port))


def _ct(ct) -> torch.Tensor:
    return torch.stack([c.to_pow().data for c in ct.comps])


@pytest.mark.parametrize("zp", [4, 5])
def test_decrypt_matches_the_port(zp):
    """A fresh ciphertext of R_128 in R_896 over three moduli, and the same
    switched down one modulus (at zp = 5 the scale moves)."""
    bk, rng = TorchBackend("cpu"), np.random.default_rng(zp)
    qs = []
    for _ in range(3):
        qs.append(find_ntt_prime(896, 30, avoid=tuple(qs)))
    sk = SK.generate(896, 5.0 / math.sqrt(384), rng)
    x = Cyc.from_coeffs(128, (zp,), rng.integers(0, zp, 64), bk)
    ct = bgv.encrypt(sk, x, 896, tuple(qs), rng)
    down = bgv.mod_switch(ct, tuple(qs[:2]))
    assert (zp == 5) == (down.scale != 1)
    for c in (ct, down):
        got = R.decrypt(R.Ring(896), R.Ring(128), _ct(c), c.qs, sk.coeffs, zp, c.scale)
        assert torch.equal(got, _pow(bgv.decrypt(sk, c))) and torch.equal(got, _pow(x))


def _small_program(seed: int):
    """One tunnel R_128 → R_448 at Z_4 (ciphertext rings 896, 448), then the
    rescale tree at K = 2, compiled on `TorchBackend("cpu")`; the input has
    constant relative coefficients over R_64, so that each CRT slot the map
    fills holds a scalar of Z_4 (what the tree needs)."""
    bk, rng = TorchBackend("cpu"), np.random.default_rng(seed)
    qs = []
    for _ in range(5):
        qs.append(find_ntt_prime(896, 30, avoid=tuple(qs)))
    expr = compose(rescale_tree_pow2(2), common.switch(1, 4, bk))
    ctx = KeysHints(5.0, seed=seed, bk=bk)
    compiled = pt2ct(expr, res_ty=PtTy(pnoise=0, m=448, zp=2), m_map={128: 896, 448: 448},
                     zqs=RnsChain(qs), gad=TrivGad(), ctx=ctx)
    x = np.zeros(64, dtype=np.int64)
    x[:2] = rng.integers(0, 4, 2)
    ct = compiled.encrypt_arg(Cyc.from_coeffs(128, (4,), x, bk), 0)
    gb = golden_backend()
    f = common.dec_to_crt(128, 448, 4, gb)
    cfg = {"tower": [128, 448], "zp_in": 4, "zp_out": 2, "tree_depth": 2,
           "maps": [{"e": f.e, "r": f.r, "s": f.s,
                     "images": [gb.to_numpy(y.to_pow().data)[0].tolist() for y in f.images]}]}
    return SimpleNamespace(bk=bk, ctx=ctx, compiled=compiled, expr=expr, x=x, ct=ct, cfg=cfg)


@pytest.mark.parametrize("seed", [1, 2])
def test_small_program_through_jit_compile_decrypts_to_the_clear_result(seed):
    p = _small_program(seed)
    program = jit_compile(p.compiled, [p.ct])
    out = program(p.ct)
    assert (out.m, out.m_prime) == (448, 448) and all(c.basis == "POW" for c in out.comps)
    want = R.clear(p.cfg, torch.from_numpy(p.x))
    got = R.decrypt(R.Ring(448), R.Ring(448), _ct(out), out.qs, p.ctx.keys[448].coeffs,
                    out.zp, out.scale)
    assert torch.equal(got, want)
    port = eval_ir(p.expr, Cyc.from_coeffs(128, (4,), p.x, p.bk))
    assert torch.equal(want, _pow(port)) and p.compiled.decrypt(out).equals(port)


# ---------------------------------------------------------------------------
# the configuration and the system
# ---------------------------------------------------------------------------


def test_configuration_is_the_ports_homomrlwr():
    homomrlwr_jit.check(CFG)
    sizes = [(h["e"], h["r"], h["s"], len(h["images"])) for h in CFG["maps"]]
    assert sizes == [(64, 128, 448, 2), (224, 448, 2912, 2), (728, 2912, 3640, 4),
                     (1820, 3640, 5460, 2), (1365, 5460, 4095, 2)]
    assert sum(len(im) for h in CFG["maps"] for im in h["images"]) == 13056
    assert not {"key_switching", "depth", "n"} & set(CFG)
    assert homomrlwr_jit.pool_slots(CFG, TRAFFIC) == 729
    for key, value in (("qs", CFG["qs"][:5] + [7]), ("tower", CFG["tower"][::-1])):
        with pytest.raises(ValueError, match=key):
            homomrlwr_jit.check({**CFG, key: value})
    maps = json.loads(json.dumps(CFG["maps"]))
    maps[2]["images"][1][5] = (maps[2]["images"][1][5] + 1) % 32
    with pytest.raises(ValueError, match="2912 -> 3640"):
        homomrlwr_jit.check({**CFG, "maps": maps})


def test_the_system_draws_the_keys_the_reference_draws(monkeypatch):
    """Set-up puts each ciphertext ring's key, drawn from its own stream, in
    the context before compiling: the reference's key of the output ring is
    the one the program's output is under."""
    seen = {}

    def stop(*_a, ctx, **_k):
        seen.update(ctx.keys)
        raise RuntimeError("stop")

    monkeypatch.setattr(homomrlwr_jit, "pt2ct", stop)
    with pytest.raises(RuntimeError, match="stop"):
        homomrlwr_jit.System(CFG, TRAFFIC, 2**33 + 5, torch.device("cpu"))
    assert sorted(seen) == sorted(CFG["tower_ct"])
    for m in CFG["tower_ct"][-1:] + CFG["tower_ct"][:1]:
        assert np.array_equal(seen[m].coeffs, R.key(CFG, 2**33 + 5, m))


def test_reference_imports_nothing_of_the_port():
    names = set()
    for node in ast.walk(ast.parse((ROOT / "benchmark" / "reference_rlwr.py").read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "alchemy_tpu", "alchemy_tpu_torch"}
    code = ("import sys, benchmark.reference_rlwr; print(sorted({m.split('.')[0] for m in "
            "sys.modules} & {'jax', 'alchemy_tpu', 'alchemy_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------


@pytest.fixture
def clock(monkeypatch):
    """The recorder's clock, set by hand: spans read `clock.now`."""
    c = SimpleNamespace(now=0, perf_counter=time.perf_counter)
    c.time_ns = lambda: c.now
    monkeypatch.setattr(profiling, "time", c)
    profiling.reset()
    yield c
    profiling.reset()


def _calls(clock, replays: list[int], attrs: dict) -> None:
    """One `jit_call` root a replay time, 1000 ns apart: 30 ns of checks and
    copies, the replay, 20 ns of clones."""
    for i, r in enumerate(replays):
        clock.now = 1000 * i
        with profiling.tracing(), profiling.span("jit_call") as root:
            root.attrs.update(attrs)
            clock.now += 30
            with profiling.span("jit.replay"):
                clock.now += r
            clock.now += 20


#: gemm 10 + 5 ns, mod-q 20 + 4 + 6 ns, other 5 ns: 50 ns busy of 100 ns of wall time
EVENTS = [
    ("void cutlass::Kernel2<cutlass_80_tensorop_d884gemm_64x32_16x4_nn_align1>(P)", 0, 10),
    ("sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize64x64x16_kernel", 10, 15),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::remainder_kernel_cuda(at::TensorIteratorBase&)>(int)", 20, 40),
    ("void at::native::reduce_kernel<512, 1>(int)", 40, 44),
    ("Memcpy DtoD (Device -> Device)", 44, 50),
    ("void at::native::triu_tril_kernel<long, int, false, 4, true>(int)", 60, 65)]


def _ctx(cell: str, summary) -> dict:
    _, cfg, traffic = bench_run.load_cell(cell)
    return {"cfg": cfg, "traffic": traffic, "trace": summary, "window": {"host_s": [0.02]},
            "card": {"name": "card", "power_limit_w": 700.0, "clock_max_mhz": 1980.0},
            "notes": {}}


def test_readers_on_a_context_of_the_new_configuration(clock):
    """Every reader gives a number or nothing; those that list the cell read,
    with the values the synthetic trace and spans give."""
    _calls(clock, [400, 100, 300, 200], {"prims": 71, "m": 20475, "L": 5, "graph": True})
    _calls(clock, [1], {"prims": 71, "m": 4095, "L": 5, "graph": True})    # another program
    summary = trace.summarize(EVENTS, 100e-9, 3)
    ctx = _ctx("homomrlwr.call", summary)
    got = {name: mod.read(ctx) for name, mod in bench_run.readers().items()}
    assert all(v is None or isinstance(v, (int, float)) for v in got.values())
    read = {k for k, v in got.items() if v is not None}
    assert read == {"idle.single", "launches_per_call.single", "host_ms_per_call.single", *NEW}
    assert got["gemm_share.rlwr"] == pytest.approx(100 * 15 / 50)
    assert got["modq_share.rlwr"] == pytest.approx(100 * 30 / 50)
    assert got["idle.single"] == pytest.approx(50.0)
    # the last three calls of the program at H5': 50 ns of own time each
    assert got["jit_host_ms.rlwr"] == pytest.approx(50e-6)
    assert ctx["notes"]["jit_host_ms.rlwr"] == {
        "calls": 3, "root_ms_median": pytest.approx(250e-6), "replay_ms_median": 200e-6,
        "graph": True, "prims": 71}


def test_jit_host_ms_reads_nothing_without_the_programs_spans(clock):
    summary = trace.summarize(EVENTS, 100e-9, 3)
    reader = bench_run.readers()["jit_host_ms.rlwr"]
    assert reader.read(_ctx("homomrlwr.call", summary)) is None
    _calls(clock, [10, 10], {"prims": 71, "m": 20475, "L": 5, "graph": True})
    assert reader.read(_ctx("homomrlwr.call", summary)) is None     # fewer roots than calls
    assert reader.read(_ctx("homomrlwr.call", None)) is None


@pytest.mark.parametrize("cell", OLD_CELLS)
def test_new_readers_read_nothing_in_the_other_cells(clock, cell):
    _calls(clock, [10] * 4, {"prims": 71, "m": 20475, "L": 5, "graph": True})
    ctx = _ctx(cell, trace.summarize(EVENTS, 100e-9, 3))
    readers = bench_run.readers()
    assert {name: readers[name].read(ctx) for name in NEW} == dict.fromkeys(NEW)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_cell_on_the_card(card):
    """The cell's system for a few calls: a CUDA graph; the judge reads no
    bad slot; a profiled call records its `jit_call` root over one
    `jit.replay` and no `ir.*` span."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.systems.homomrlwr_jit import System, judge

    seed = 2**35 + 19
    system = System(CFG, TRAFFIC, seed, card)
    assert system.program.graph is not None and system.slots == 729
    kept = {k: system.call(k) for k in (0, 1, 730)}
    profiling.reset()
    times = []
    with profile(activities=[ProfilerActivity.CUDA]):
        for k in range(3):
            t0 = time.perf_counter()
            system.call(k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    recorded = profiling.spans()
    system.close()
    roots = [s for s in recorded if s.parent is None]
    assert [s.name for s in roots] == ["jit_call"] * 3
    assert all(s.attrs == {"prims": sum(CFG_PRIMS.values()), "m": 20475, "L": 5, "graph": True}
               for s in roots)
    assert sorted(s.name for s in recorded if s.parent is not None) == ["jit.replay"] * 3
    checks = judge(CFG, TRAFFIC, seed, kept, card)
    print(f"[homomrlwr.call] {torch.cuda.get_device_name()}: calls under the profiler "
          f"{statistics.median(times) * 1e3:.3f} ms median; {checks}")
    assert checks == {"bad_slots": 0, "compared_calls": 3}
