"""The general path's mod-q kernels (`backend/cuda/modq.py`, `csrc/modq.cu`).

On the CPU: each plain form (what `TorchBackend` runs on CPU tensors)
against the JAX package's golden backend (`alchemy_tpu.backend.golden`,
numpy) at the shapes HomomRLWR gives them, the kernels' Barrett and Shoup
arithmetic from their constant tables at the edges of its range, and the
contract the kernels rest on: the small HomomRLWR program hands every
mod-q method canonical residues. On the card (`-m cuda`): each kernel
against its plain form and against the JAX package's golden backend on
the same numpy arrays, through strided views, at residues 0, 1 and q − 1,
at products near 2^62 and partial sums near 2^53, `rescale_step` at zp 2,
3, 32 and 2^16, inside a captured CUDA graph, and an `axis_matmul` that
launches the split and recombine kernels and no `%`.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from alchemy_tpu.backend import golden_backend as jgolden
from alchemy_tpu_torch.backend.cuda import launch, modq
from alchemy_tpu_torch.backend.torch_backend import _MAX_K, TorchBackend, _matmul_mod
from alchemy_tpu_torch.examples import homomrlwr
from alchemy_tpu_torch.interp.jit_exec import jit_compile
from alchemy_tpu_torch.scripts.verify_device import MODQ_MATMULS as MATMUL_SHAPES
from alchemy_tpu_torch.scripts.verify_device import MODQ_ROWS as ROWS

QS = tuple(homomrlwr.ZQS.qs)                 # the six HomomRLWR moduli, 30–31 bits
JG = jgolden()
RESCALE_ZPS = [2, 3, 32, 1 << 16]


def _rows(rng, qs, n) -> np.ndarray:
    return np.stack([rng.integers(0, q, n) for q in qs]).astype(np.int64)


def _mats(rng, qs, d_out, K) -> list[np.ndarray]:
    return [rng.integers(0, q, (d_out, K)).astype(np.int64) for q in qs]


def _golden_matmul(mats, x: np.ndarray, qs) -> np.ndarray:
    L, A, K, B = x.shape
    out = JG.axis_matmul(x.reshape(L, -1), [None, mats, None], (A, K, B), qs)
    return out.reshape(L, A, mats[0].shape[0], B)


# ---------------------------------------------------------------------------
# plain forms against golden (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,d_out,K,A,B", MATMUL_SHAPES)
def test_matmul_mod_plain_matches_golden(L, d_out, K, A, B):
    rng = np.random.default_rng(d_out * K + A)
    qs = QS[:L]
    mats, x = _mats(rng, qs, d_out, K), rng.integers(0, min(qs), (L, A, K, B))
    W = TorchBackend("cpu")._mat_halves(mats, qs)
    got = _matmul_mod(W, torch.from_numpy(x), qs)
    assert got.shape == (L, A, d_out, B)
    assert np.array_equal(got.numpy(), _golden_matmul(mats, x, qs))


@pytest.mark.parametrize("L,n", ROWS)
def test_elementwise_plain_forms_match_golden(L, n):
    rng = np.random.default_rng(L * n)
    qs, tb = QS[:L], TorchBackend("cpu")
    a, b, c = (_rows(rng, qs, n) for _ in range(3))
    q = np.array(qs)[:, None]
    a[:, :3] = np.concatenate([0 * q, 0 * q + 1, q - 1], axis=1)        # 0, 1, q − 1
    b[:, :3] = q - 1
    ta, tb_, tc = map(torch.from_numpy, (a, b, c))
    consts = [int(v) for v in rng.integers(-(1 << 40), 1 << 40, L)]
    checks = {
        "add": (tb.add(ta, tb_, qs), JG.add(a, b, qs)),
        "sub": (tb.sub(ta, tb_, qs), JG.sub(a, b, qs)),
        "neg": (tb.neg(ta, qs), JG.neg(a, qs)),
        "mul": (tb.mul(ta, tb_, qs), JG.mul(a, b, qs)),
        "mul_const": (tb.mul_const(ta, consts, qs), JG.mul_const(a, consts, qs)),
        "sum_terms": (tb.sum_terms([ta, tb_, tc] * 4, qs), JG.sum_terms([a, b, c] * 4, qs)),
        "modswitch_up": (tb.modswitch_up(ta[:L - 1], qs[:L - 1], qs),
                         JG.modswitch_up(a[:L - 1], qs[:L - 1], qs)),
    }
    for zp in RESCALE_ZPS:
        checks[f"rescale_step zp={zp}"] = (tb.rescale_step(ta, qs, zp), JG.rescale_step(a, qs, zp))
    for name, (got, want) in checks.items():
        assert np.array_equal(got.numpy(), want), name


def test_axis_matmul_on_the_cpu_takes_no_launch():
    """The plain forms run on CPU tensors: the counters stay put."""
    before = dict(launch.LAUNCHES)
    tb, rng = TorchBackend("cpu"), np.random.default_rng(3)
    a = tb.asarray(_rows(rng, QS[:2], 6 * 12), QS[:2])
    tb.axis_matmul(a, [rng.integers(0, 9, (6, 6)), None], (6, 12), QS[:2])
    tb.add(a, a, QS[:2])
    assert launch.LAUNCHES == before


# ---------------------------------------------------------------------------
# the kernels' arithmetic from their tables (CPU, Python integers)
# ---------------------------------------------------------------------------


def _barrett(x: int, row) -> int:
    """zq.cuh `reduce64` with a `Limb` row's q and ⌊2^64/q⌋ (words 0, 4, 5):
    x − ⌊x·m/2^64⌋·q, then one conditional subtraction (the estimate is off
    by at most one)."""
    q, m = int(row[0]), int(row[4]) | int(row[5]) << 32
    r = x - (x * m >> 64) * q
    assert 0 <= r < 2 * q
    return r - q if r >= q else r


def _shoup(a: int, w: int, ws: int, q: int) -> int:
    r = (a * w - (a * ws >> 32) * q) & 0xFFFFFFFF
    return r - q if r >= q else r


@pytest.mark.parametrize("q", [QS[0], (1 << 31) - 1, 3, 65537])
def test_kernel_arithmetic_from_the_tables_at_the_edges(q):
    """Barrett on products of residues up to (q − 1)^2 < 2^62 and on exact
    partial sums up to _MAX_K·(2^16 − 1)^2 < 2^53; the recombination with
    2^16 and 2^32 mod q; the Shoup constants of `gp_scale_pad` and
    `gp_rescale_step`."""
    row = modq.modq_limbs((q,))[0]
    for x in (0, 1, (q - 1) ** 2, (q - 1) * (q - 2), _MAX_K * 0xFFFF ** 2,
              _MAX_K * 0xFFFF ** 2 - 1, (1 << 64) - 1, q * q, q * q - 1):
        assert _barrett(x, row) == x % q
    for lo, lh, hl, hh in ((0, 0, 0, 0), (q - 1, q - 1, q - 1, q - 1), (1, q - 1, 1, q - 2)):
        s = (lo + _shoup((lh + hl) % q, int(row[1]), int(row[2]), q)) % q
        s = (s + _shoup(hh, int(row[6]), int(row[7]), q)) % q
        assert s == (lo + (lh + hl) * (1 << 16) + hh * (1 << 32)) % q
    c, w = modq.scale_table(((q - 1) % q,), (q,))[0], (q - 1) % q
    for a in (0, 1, q - 1):
        assert _shoup(a, int(c[1]), int(c[2]), int(c[0])) == a * w % q
    if q > 3:
        k = modq.rescale_step_consts((q, 3))[0]
        assert int(k[1]) == pow(3, -1, q)
        assert _shoup(q - 1, int(k[1]), int(k[2]), q) == (q - 1) * pow(3, -1, q) % q
    with pytest.raises(ValueError, match="1 < q"):
        modq.modq_limbs((1,))


# ---------------------------------------------------------------------------
# the contract: canonical residues in, canonical residues out (CPU)
# ---------------------------------------------------------------------------


def test_the_small_homomrlwr_program_hands_every_mod_q_method_canonical_residues():
    """The small HomomRLWR program (one tunnel, the rescale tree at K = 2)
    through `jit_compile` on `TorchBackend("cpu")`, with every method that
    runs a mod-q kernel on the card (`add`, `sub`, `neg`, `mul`,
    `mul_const`, `sum_terms`, `rescale_step`, `modswitch_up`) wrapped to
    assert that every residue it takes and gives lies in [0, q)."""
    from test_torch_bench_rlwr import _small_program

    p = _small_program(1)
    seen = Counter()

    def canonical(t, qs, what):
        q = torch.tensor(qs, dtype=torch.int64)[:, None]
        assert t.dtype == torch.int64 and bool(((t >= 0) & (t < q)).all()), what

    # each method: (its residue arguments as (position, position of their
    # moduli), the position of its result's moduli, whether that drops the
    # last limb)
    specs = {"add": (((0, 2), (1, 2)), 2, False), "sub": (((0, 2), (1, 2)), 2, False),
             "neg": (((0, 1),), 1, False), "mul": (((0, 2), (1, 2)), 2, False),
             "mul_const": (((0, 2),), 2, False), "sum_terms": (((0, 1),), 1, False),
             "rescale_step": (((0, 1),), 1, True), "modswitch_up": (((0, 1),), 2, False)}

    def wrap(name, residues, out_at, drops):
        method = getattr(p.bk, name)

        def checked(*args):
            for i, at in residues:
                for t in args[i] if name == "sum_terms" else (args[i],):
                    canonical(t, tuple(args[at]), f"{name} argument {i}")
            out = method(*args)
            qs = tuple(args[out_at])
            canonical(out, qs[:-1] if drops else qs, f"{name} result")
            seen[name] += 1
            return out
        setattr(p.bk, name, checked)

    for name, spec in specs.items():
        wrap(name, *spec)
    jit_compile(p.compiled, [p.ct])(p.ct)
    assert {k for k, v in seen.items() if v} >= {"add", "mul", "mul_const", "rescale_step",
                                                 "modswitch_up"}


# ---------------------------------------------------------------------------
# the kernels against their plain forms (card)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _strided(x: np.ndarray, card) -> torch.Tensor:
    """x on the card as a view with non-unit strides: its two last axes
    swapped in memory, then swapped back."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, -1, -2))).to(card).transpose(-1, -2)


@pytest.mark.cuda
@pytest.mark.parametrize("L,d_out,K,A,B", MATMUL_SHAPES)
def test_matmul_mod_kernels_match_the_plain_form(card, L, d_out, K, A, B):
    """The split and recombine kernels around the GEMM, reading x through
    `movedim`'s strides, against the plain form and the JAX package's
    golden `axis_matmul` on the same arrays."""
    rng = np.random.default_rng(d_out + K * A)
    qs = QS[:L]
    mats = _mats(rng, qs, d_out, K)
    base = rng.integers(0, min(qs), (L, K, A, B))
    base[:, :, 0, 0] = np.array(qs)[:, None] - 1
    base[:, 0, :, 0] = 0
    W = TorchBackend("cpu")._mat_halves(mats, qs)
    want = _matmul_mod(W, torch.from_numpy(base).movedim(1, 2), qs)
    x = torch.from_numpy(base).to(card).movedim(1, 2)          # [L, A, K, B], non-unit strides
    before = dict(launch.LAUNCHES)
    got = _matmul_mod(W.to(card), x, qs)
    assert launch.LAUNCHES["gp_split16"] == before["gp_split16"] + 1
    assert launch.LAUNCHES["gp_recombine"] == before["gp_recombine"] + 1
    assert got.is_contiguous() and torch.equal(got.cpu(), want)
    jax_golden = _golden_matmul(mats, np.ascontiguousarray(np.moveaxis(base, 1, 2)), qs)
    assert np.array_equal(got.cpu().numpy(), jax_golden)


@pytest.mark.cuda
def test_recombine_takes_partial_sums_near_2_53(card):
    """K = _MAX_K, every entry q − 1 with q = 2^31 − 1: each partial sum is
    K·(2^16 − 1)^2 or near it, just below 2^53; the card against the plain
    form and the JAX package's golden `axis_matmul`."""
    q = (1 << 31) - 1
    mats = [np.full((1, _MAX_K), q - 1, dtype=np.int64)]
    W = TorchBackend("cpu")._mat_halves(mats, (q,))
    x = np.full((1, 1, _MAX_K, 2), q - 1, dtype=np.int64)
    want = _matmul_mod(W, torch.from_numpy(x), (q,))
    got = _matmul_mod(W.to(card), torch.from_numpy(x).to(card), (q,))
    assert torch.equal(got.cpu(), want) and int(want[0, 0, 0, 0]) == _MAX_K * (q - 1) ** 2 % q
    assert np.array_equal(got.cpu().numpy(), _golden_matmul(mats, x, (q,)))


@pytest.mark.cuda
@pytest.mark.parametrize("L,n", ROWS)
def test_elementwise_kernels_match_the_plain_forms(card, L, n):
    """Each elementwise method on the card, on strided views, against its
    plain form and the JAX package's golden backend on the same arrays."""
    rng = np.random.default_rng(n + L)
    qs = QS[:L]
    rows = []
    for _ in range(3):
        r = _rows(rng, qs, n)
        r[:, 0], r[:, 1], r[:, 2] = np.array(qs) - 1, 1, 0          # q − 1, 1, 0
        rows.append(r)
    a, b, c = rows
    cpu = TorchBackend("cpu")
    tb = TorchBackend(card)
    consts = [int(v) for v in rng.integers(-(1 << 40), 1 << 40, L)]
    before = dict(launch.LAUNCHES)
    A, Bc, C = (_strided(r, card) for r in rows)
    ca, cb, cc = map(torch.from_numpy, rows)
    cases = {
        "add": (tb.add(A, Bc, qs), cpu.add(ca, cb, qs), JG.add(a, b, qs)),
        "sub": (tb.sub(A, Bc, qs), cpu.sub(ca, cb, qs), JG.sub(a, b, qs)),
        "neg": (tb.neg(A, qs), cpu.neg(ca, qs), JG.neg(a, qs)),
        "mul": (tb.mul(A, Bc, qs), cpu.mul(ca, cb, qs), JG.mul(a, b, qs)),
        "mul_const": (tb.mul_const(A, consts, qs), cpu.mul_const(ca, consts, qs),
                      JG.mul_const(a, consts, qs)),
        "sum_terms": (tb.sum_terms([A, Bc, C] * 4, qs), cpu.sum_terms([ca, cb, cc] * 4, qs),
                      JG.sum_terms([a, b, c] * 4, qs)),
        "modswitch_up": (tb.modswitch_up(A[:L - 1], qs[:L - 1], qs),
                         cpu.modswitch_up(ca[:L - 1], qs[:L - 1], qs),
                         JG.modswitch_up(a[:L - 1], qs[:L - 1], qs)),
    }
    for zp in RESCALE_ZPS + [(1 << 32) + 15]:
        cases[f"rescale_step zp={zp}"] = (tb.rescale_step(A, qs, zp),
                                          cpu.rescale_step(ca, qs, zp),
                                          JG.rescale_step(a, qs, zp))
    for name, (got, want, jax_golden) in cases.items():
        assert torch.equal(got.cpu(), want), name
        assert np.array_equal(got.cpu().numpy(), jax_golden), name
    moved = {k: launch.LAUNCHES[k] - before[k] for k in launch.MODQ_NAMES}
    # add, sub, neg, mul one launch each; the 12 terms' sum a launch a term after the first
    assert moved == {"gp_split16": 0, "gp_recombine": 0, "gp_binop": 4 + 11,
                     "gp_scale_pad": 2, "gp_rescale_step": len(RESCALE_ZPS) + 1}
    # the products of the largest residues, (q − 1)^2 near 2^62
    assert int(cases["mul"][1][0, 0]) == (qs[0] - 1) ** 2 % qs[0]


@pytest.mark.cuda
def test_binop_refuses_a_second_operand_it_cannot_read(card):
    """`b` is checked as `a` is: int64, [L, n] after the broadcast, on a's
    device."""
    qs, rng = QS[:2], np.random.default_rng(11)
    a = torch.from_numpy(_rows(rng, qs, 64)).to(card)
    for b in (a.to(torch.int32), a.cpu(), a[:1, :32]):
        with pytest.raises((ValueError, RuntimeError)):
            modq.binop("add", a, b, qs)


@pytest.mark.cuda
def test_the_kernels_in_a_captured_cuda_graph(card):
    """An axis_matmul, a product and a rescale step captured once and
    replayed on new inputs copied into the captured ones, against the plain
    forms and the JAX package's golden backend."""
    tb, cpu, rng = TorchBackend(card), TorchBackend("cpu"), np.random.default_rng(7)
    qs, shape = QS[:4], (6, 20, 6, 12)
    mats = [None, _mats(rng, qs, 20, 20), None, [rng.integers(0, 9, (12, 12))] * 4]
    n = int(np.prod(shape))

    def step(bk, x, y):
        return bk.rescale_step(bk.mul(bk.axis_matmul(x, mats, shape, qs), y, qs), qs, 32)

    x, y = (torch.from_numpy(_rows(rng, qs, n)).to(card) for _ in range(2))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(tb, x, y)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = step(tb, x, y)
    for _ in range(2):
        nx, ny = (_rows(rng, qs, n) for _ in range(2))
        x.copy_(torch.from_numpy(nx))
        y.copy_(torch.from_numpy(ny))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), step(cpu, torch.from_numpy(nx), torch.from_numpy(ny)))
        assert np.array_equal(out.cpu().numpy(), step(JG, nx, ny))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
def test_axis_matmul_on_the_card_launches_the_kernels_and_no_remainder(card):
    tb, rng = TorchBackend(card), np.random.default_rng(5)
    qs, shape = QS[:3], (6, 20, 6, 12)
    a = tb.asarray(_rows(rng, qs, int(np.prod(shape))), qs)
    mats = [_mats(rng, qs, 6, 6), _mats(rng, qs, 20, 20), None, _mats(rng, qs, 12, 12)]
    groups = [g for g in tb._merge_axis_mats(mats, list(shape), qs) if g[1] is not None]
    before = dict(launch.LAUNCHES)
    with _Ops() as mode:
        out = tb.axis_matmul(a, mats, shape, qs)
    assert launch.LAUNCHES["gp_split16"] - before["gp_split16"] == len(groups)
    assert launch.LAUNCHES["gp_recombine"] - before["gp_recombine"] == len(groups)
    assert mode.ops["aten.remainder"] == 0 and mode.ops["aten.clone"] == 0
    assert mode.ops["aten.bmm"] + mode.ops["aten.matmul"] >= len(groups)
    want = TorchBackend("cpu").axis_matmul(a.cpu(), mats, shape, qs)
    assert torch.equal(out.cpu(), want)
    assert np.array_equal(out.cpu().numpy(), JG.axis_matmul(a.cpu().numpy(), mats, shape, qs))
