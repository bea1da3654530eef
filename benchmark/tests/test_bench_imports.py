"""What the benchmark may import, and its frozen yardstick: no module of the
benchmark imports JAX or the JAX package (top-level names compared whole),
the reference's files import nothing of the port, and the copied cost
functions equal `chip_smoke.py`'s at the four cells' shapes."""

from __future__ import annotations

import ast
import inspect
import re
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import roofline

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "alchemy_tpu"}
#: the files of the yardstick, which may not import the port either
REFERENCE_FILES = ("inputs.py", "reference.py", "roofline.py")


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE_FILES)
def test_reference_imports_nothing_of_the_port(name):
    assert "alchemy_tpu_torch" not in top_level_imports(BENCH / name)


def test_reference_loads_nothing_of_the_port():
    code = ("import sys, benchmark.reference, benchmark.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'alchemy_tpu', 'alchemy_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"


SHAPES = [(16, 8, 32768), (1, 8, 32768), (16, 16, 32768), (1, 16, 32768)]


@pytest.mark.parametrize("Bt,L,n", SHAPES)
def test_costs_equal_chip_smoke(Bt, L, n):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    assert (cs.HBM_BYTES_PER_S, cs.SMS, cs.IMUL_PER_SM_CLOCK) == (
        roofline.HBM_BYTES_PER_S, roofline.SMS, roofline.IMUL_PER_SM_CLOCK)
    assert (cs.MUL_VAR, cs.MUL_CONST, cs.REDUCE) == (
        roofline.MUL_VAR, roofline.MUL_CONST, roofline.REDUCE)
    assert cs.ntt_muls(n) == roofline.ntt_muls(n)
    assert cs.tensor_cost(Bt, L, n) == roofline.tensor_cost(Bt, L, n)
    assert cs.rescale_cost(2 * Bt, L, 4, n) == roofline.rescale_cost(2 * Bt, L, 4, n)
    for inverse in (False, True):
        assert cs.grid_cost(inverse, 2 * Bt, L + 4, n) == roofline.grid_cost(inverse, 2 * Bt,
                                                                              L + 4, n)
    assert cs.bound(1e9, 1e12, 1.98e9) == roofline.bound(1e9, 1e12, 1.98e9)
    # kernel B's counts are inline in kernel_phase, kernel 4's a nested
    # function of hybrid_kernel_phase: evaluate their source
    src = inspect.getsource(cs.kernel_phase)
    scope = {"Bt": Bt, "L": L, "n": n, "ntt_muls": cs.ntt_muls, "REDUCE": cs.REDUCE}
    scope["tables"] = eval(re.search(r"tables = (.+?)\s+#", src).group(1), {}, scope)
    for shoup, hint_words, hint_mul in ((True, 4, cs.MUL_CONST), (False, 2, cs.MUL_VAR)):
        env = {**scope, "hint_words": hint_words, "hint_mul": hint_mul}
        nbytes = eval(re.search(r"update\(bytes=(.+?),\n", src).group(1), {}, env)
        muls = eval(re.search(r"muls=(Bt \* L \* L .+?)\)\n", src).group(1), {}, env)
        assert (nbytes, muls) == roofline.digit_relin_cost(Bt, L, n, shoup)
    src = inspect.getsource(cs.hybrid_kernel_phase)
    k4 = textwrap.dedent(re.search(r"( +def k4_cost.*?\n\n)", src, re.S).group(1))
    env = {"Bt": Bt, "L": L, "n": n, "T": L + 4, "hk": SimpleNamespace(dnum=4),
           "ntt": cs.ntt_muls(n), "MUL_CONST": cs.MUL_CONST}
    exec(k4, env)
    assert env["k4_cost"](2, cs.MUL_VAR) == roofline.hybrid_digit_relin_cost(Bt, L, L + 4, 4, n,
                                                                             False)
    assert env["k4_cost"](4, cs.MUL_CONST) == roofline.hybrid_digit_relin_cost(Bt, L, L + 4, 4,
                                                                               n, True)
