"""alchemy_tpu_torch.utils.profiling against alchemy_tpu.utils.profiling:
`cost_table` equal to the JAX one on `addMul` (as tests/test_fast.py:183)
and on the compiled Arithmetic program of both packages from one seed;
`phase` is the examples' wall-clock harness; `trace` writes a
torch.profiler trace TensorBoard reads, on the CPU."""

import json

import numpy as np
import torch

from alchemy_tpu.utils import profiling as jprof
from alchemy_tpu_torch.examples.common import timed
from alchemy_tpu_torch.utils import profiling as tprof


def test_cost_table_on_the_dsl_matches_jax():
    from alchemy_tpu.examples.arithmetic import addMul as jaddMul
    from alchemy_tpu_torch.examples.arithmetic import addMul

    table = tprof.cost_table(addMul)
    assert table == jprof.cost_table(jaddMul)
    assert dict(table)["add_"] == 1 and dict(table)["mul_"] == 1


def _compiled(ex, Cyc, KeysHints, pt2ct, TrivGad, totient, bk):
    rng = np.random.default_rng(4)
    pts = [Cyc.from_coeffs(ex.M, (ex.ZP,), rng.integers(0, ex.ZP, totient(ex.M)), bk)
           for _ in range(2)]
    compiled = pt2ct(ex.addMul, res_ty=ex.PT, m_map=ex.M_MAP, zqs=ex.ZQS, gad=TrivGad(),
                     ctx=KeysHints(3.0, seed=4, bk=bk))
    return compiled, pts


def test_cost_table_of_a_compiled_program_matches_jax():
    import alchemy_tpu.examples.arithmetic as jex
    import alchemy_tpu_torch.examples.arithmetic as tex
    from alchemy_tpu.backend import golden_backend as jgolden
    from alchemy_tpu.core.cyc import Cyc as JCyc
    from alchemy_tpu.interp.keys_hints import KeysHints as JKeysHints
    from alchemy_tpu.interp.pt2ct import pt2ct as jpt2ct
    from alchemy_tpu.nt.factor import totient
    from alchemy_tpu.she.gadget import TrivGad as JTrivGad
    from alchemy_tpu_torch.backend import golden_backend
    from alchemy_tpu_torch.core.cyc import Cyc
    from alchemy_tpu_torch.interp.keys_hints import KeysHints
    from alchemy_tpu_torch.interp.pt2ct import pt2ct
    from alchemy_tpu_torch.she.gadget import TrivGad

    port, _ = _compiled(tex, Cyc, KeysHints, pt2ct, TrivGad, totient, golden_backend())
    ref, _ = _compiled(jex, JCyc, JKeysHints, jpt2ct, JTrivGad, totient, jgolden())
    table = tprof.cost_table(port.ir)
    assert table == jprof.cost_table(ref.ir)
    assert any(" @ " in op for op, _ in table)


def test_phase_is_the_examples_timer(capsys):
    assert tprof.phase is timed
    with tprof.phase("step "):
        pass
    assert "step Wall time: " in capsys.readouterr().out


def test_trace_writes_a_tensorboard_trace(tmp_path):
    x = torch.arange(1 << 12, dtype=torch.int64)
    with tprof.trace(str(tmp_path)) as prof:
        y = (x * x) % 65537
    assert int(y[3]) == 9 and prof is not None
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mul" in e.get("name", "") or "remainder" in e.get("name", "") for e in events)
