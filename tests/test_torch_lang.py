"""The port's DSL and interpreters (`alchemy_tpu_torch/lang/`, `interp/`)
against the JAX package, mirroring tests/test_lang.py: each program is
built once in each package from the same Python source, and the printed
strings, sizes, `params` listings, inference results and plaintext
evaluations must be equal, as must the errors `pt2ct` raises (type and
message). The port's plaintext values live on its golden backend and on
`TorchBackend(device="cpu")`."""

from types import SimpleNamespace

import numpy as np
import pytest

import alchemy_tpu.examples.arithmetic as jarith
import alchemy_tpu.examples.homomrlwr as jhomom
import alchemy_tpu.interp as jinterp
import alchemy_tpu.interp.accumulator as jacc
from alchemy_tpu.interp.eval import eval_ir as jeval_ir
import alchemy_tpu.interp.infer as jinfer
import alchemy_tpu.interp.keys_hints as jkh
import alchemy_tpu.interp.noise as jnoise
import alchemy_tpu.interp.params_print as jparams
import alchemy_tpu.interp.pt2ct as jpt2ct
import alchemy_tpu.lang.dsl as jdsl
import alchemy_tpu.lang.ir as jir
from alchemy_tpu.backend import golden_backend as jgolden
from alchemy_tpu.core.cyc import Cyc as JCyc
from alchemy_tpu.core.params import RnsChain as JRnsChain
from alchemy_tpu.she.gadget import TrivGad as JTrivGad
import alchemy_tpu_torch.examples.arithmetic as tarith
import alchemy_tpu_torch.examples.homomrlwr as thomom
import alchemy_tpu_torch.interp as tinterp
import alchemy_tpu_torch.interp.accumulator as tacc
from alchemy_tpu_torch.interp.eval import eval_ir as teval_ir
import alchemy_tpu_torch.interp.infer as tinfer
import alchemy_tpu_torch.interp.keys_hints as tkh
import alchemy_tpu_torch.interp.noise as tnoise
import alchemy_tpu_torch.interp.params_print as tparams
import alchemy_tpu_torch.interp.pt2ct as tpt2ct
import alchemy_tpu_torch.lang.dsl as tdsl
import alchemy_tpu_torch.lang.ir as tir
from alchemy_tpu_torch.backend import golden_backend as tgolden
from alchemy_tpu_torch.backend.torch_backend import TorchBackend
from alchemy_tpu_torch.core.cyc import Cyc as TCyc
from alchemy_tpu_torch.core.params import RnsChain as TRnsChain
from alchemy_tpu_torch.she.gadget import TrivGad as TTrivGad

JAX = SimpleNamespace(dsl=jdsl, ir=jir, interp=jinterp, eval_ir=jeval_ir, infer=jinfer, noise=jnoise,
                      params=jparams, pt2ct=jpt2ct, kh=jkh, acc=jacc, arith=jarith, homom=jhomom,
                      Cyc=JCyc, RnsChain=JRnsChain, TrivGad=JTrivGad, golden=jgolden)
PORT = SimpleNamespace(dsl=tdsl, ir=tir, interp=tinterp, eval_ir=teval_ir, infer=tinfer, noise=tnoise,
                       params=tparams, pt2ct=tpt2ct, kh=tkh, acc=tacc, arith=tarith, homom=thomom,
                       Cyc=TCyc, RnsChain=TRnsChain, TrivGad=TTrivGad, golden=tgolden)
ARITH_QS = [268440577, 8392193, 1073750017]   # Arithmetic.hs:31-34


def _ty(t):
    return (t.pnoise, t.m, t.zp)


def add_mul(ns):
    return ns.dsl.lam2(lambda x, y: (x + y) * y)


def let_square(ns):
    return ns.dsl.lam(lambda x: ns.dsl.let_(x + x, lambda y: y * y))


def half(ns):
    return ns.dsl.lam(lambda x: ns.dsl.div2(x))


def lit_ops(ns):
    return ns.dsl.lam(lambda x: -ns.dsl.mul_lit_n(3, ns.dsl.add_lit_n(2, x)) - x)


# (program, result type (pnoise, m, zp), printed form, size, params listing)
PROGRAMS = {
    "addMul": (add_mul, (0, 4, 7), "(\\v0 -> (\\v1 -> ((mul ((add v0) v1)) v1)))", 7,
               ["mul 0", "add 5"]),
    "let": (let_square, (0, 4, 7), None, None, None),
    "div2": (half, (0, 4, 8), None, None, None),
    "lits": (lit_ops, (0, 4, 7), None, None, None),
}


@pytest.mark.parametrize("name", PROGRAMS)
def test_interpreters_print_the_same(name):
    """pprint, size, dup and params of one program in both packages."""
    build, res, text, n, lines = PROGRAMS[name]
    got = {}
    for tag, ns in (("jax", JAX), ("port", PORT)):
        e = build(ns)
        a, b = ns.interp.dup(e)
        assert a is b
        got[tag] = (ns.interp.pprint(e), ns.interp.size(e),
                    ns.params.params(e, res_ty=ns.noise.PtTy(*res), zqs=ns.RnsChain(ARITH_QS)))
    assert got["jax"] == got["port"]
    if text is not None:
        assert got["port"][:2] == (text, n) and got["port"][2].splitlines() == lines


@pytest.mark.parametrize("name", PROGRAMS)
def test_inference_matches(name):
    """The inferred argument type of each program (test_lang.py:55-74)."""
    build, res, *_ = PROGRAMS[name]
    got = []
    for ns in (JAX, PORT):
        e = build(ns)
        inf = ns.infer.Inference(ns.noise.NoiseLedger(ns.RnsChain(ARITH_QS)))
        inf.run(e, ns.noise.PtTy(*res))
        t = inf.tref(e).ty
        assert isinstance(t, ns.noise.FunTy)
        got.append(_ty(inf.resolved_pt(t.arg)))
    assert got[0] == got[1]
    if name == "addMul":
        assert got[1] == (5, 4, 7)
    if name == "div2":
        assert got[1] == (0, 4, 16)


@pytest.mark.parametrize("bk", ["golden", "torch-cpu"])
@pytest.mark.parametrize("name", ["addMul", "let", "lits"])
def test_plaintext_eval_matches(name, bk):
    """The E interpreter on plaintexts: the port on `bk` against the JAX
    package on golden, and against the metalanguage expression."""
    build = PROGRAMS[name][0]
    tb = tgolden() if bk == "golden" else TorchBackend(device="cpu")
    p, rng = 7, np.random.default_rng(3)
    vals = [rng.integers(0, p, 2) for _ in range(2)]
    argc = 2 if name == "addMul" else 1
    want = JAX.eval_ir(build(JAX), *[JCyc.from_coeffs(4, (p,), v, jgolden())
                                          for v in vals[:argc]])
    args = [TCyc.from_coeffs(4, (p,), v, tb) for v in vals[:argc]]
    got = PORT.eval_ir(build(PORT), *args)
    assert tb.to_numpy(got.data).tolist() == jgolden().to_numpy(want.data).tolist()
    if name == "addMul":
        assert got.equals((args[0] + args[1]) * args[1])
    if name == "let":
        assert got.equals((args[0] + args[0]) * (args[0] + args[0]))


def test_plaintext_div2_matches():
    p, vals = 8, np.array([2, 6])
    want = JAX.eval_ir(half(JAX), JCyc.from_coeffs(4, (p,), vals, jgolden()))
    for tb in (tgolden(), TorchBackend(device="cpu")):
        got = PORT.eval_ir(half(PORT), TCyc.from_coeffs(4, (p,), vals, tb))
        assert got.qs == want.qs == (4,)
        assert tb.to_numpy(got.data).tolist() == jgolden().to_numpy(want.data).tolist() == [[1, 3]]


def test_noise_ledger_constants_match():
    for name in ("MIN_UNITS", "MUL_PNOISE", "KS_ACCUM_PNOISE", "MAX_32BIT_UNITS",
                 "TUNNEL_PNOISE", "PNOISE_UNIT"):
        assert getattr(tnoise, name) == getattr(jnoise, name), name
    assert (tnoise.MIN_UNITS, tnoise.MUL_PNOISE, tnoise.KS_ACCUM_PNOISE,
            tnoise.MAX_32BIT_UNITS, tnoise.TUNNEL_PNOISE) == (2, 3, 2, 5, 1)


@pytest.mark.parametrize("ns", [JAX, PORT], ids=["jax", "port"])
def test_ledger_insufficient_moduli_error(ns):
    led = ns.noise.NoiseLedger(ns.RnsChain([268440577]))
    with pytest.raises(ValueError, match="more/bigger moduli"):
        led.prefix_len(20)


def test_ledger_queries_match():
    chains = ([268440577, 8392193, 1073750017],
              [537264001, 539884801, 555609601, 560851201, 566092801])
    for qs in chains:
        jl, tl = jnoise.NoiseLedger(JRnsChain(qs)), tnoise.NoiseLedger(TRnsChain(qs))
        for p in range(0, 12):
            for f in ("qs_for_pnoise", "mul_output_pnoise"):
                try:
                    want = getattr(jl, f)(p)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)[:20]):
                        getattr(tl, f)(p)
                    continue
                assert getattr(tl, f)(p) == want, (f, p)


def test_params_on_rescale_tree_program():
    """Inference over HomomRLWR's plaintext program (test_lang.py:162-175):
    the same params listing in both packages."""
    want = jparams.params(jhomom.ring_round("golden"), res_ty=jhomom.PT, zqs=jhomom.ZQS)
    got = tparams.params(thomom.ring_round("golden"), res_ty=thomom.PT, zqs=thomom.ZQS)
    assert got == want
    lines = got.splitlines()
    assert sum(1 for line in lines if line.startswith("linear")) == 5
    assert sum(1 for line in lines if line.startswith("mul")) == 8
    assert sum(1 for line in lines if line.startswith("div2")) == 15
    assert [int(line.split()[1]) for line in lines if line.startswith("linear")] == [15, 16, 17, 18, 19]


def _compile_arith(ns, bk, seed=0):
    ctx = ns.kh.KeysHints(3.0, seed=seed, bk=bk)
    a = ns.arith
    return ns.pt2ct.pt2ct(a.addMul, res_ty=a.PT, m_map=a.M_MAP, zqs=a.ZQS, gad=ns.TrivGad(),
                          ctx=ctx)


def test_compiled_arithmetic_prints_the_same():
    """The compiled Arithmetic program (test_lang.py:177-190): printed form,
    size and params in both packages."""
    jc = _compile_arith(JAX, jgolden())
    tc = _compile_arith(PORT, tgolden())
    assert tinterp.pprint(tc.ir) == jinterp.pprint(jc.ir) == (
        "(\\v0 -> (\\v1 -> (((\\v2 -> (\\v3 -> (modSwitch (keySwitchQuad <HINT> "
        "(modSwitch ((mul v2) v3)))))) ((add v0) v1)) v1)))"
    )
    assert tinterp.size(tc.ir) == jinterp.size(jc.ir)
    assert tparams.params(tc.ir) == jparams.params(jc.ir)
    assert [_ty(t) for t in tc.arg_tys] == [_ty(t) for t in jc.arg_tys]
    assert [tc.arg_qs(i) for i in range(2)] == [jc.arg_qs(i) for i in range(2)]


def _pt2ct_error(ns, bk, case):
    a = ns.arith
    kw = dict(res_ty=a.PT, m_map=a.M_MAP, zqs=a.ZQS, gad=ns.TrivGad(),
              ctx=ns.kh.KeysHints(3.0, bk=bk))
    if case == "divide":
        kw["m_map"] = {4: 511}
    elif case == "ntt":
        kw["zqs"] = ns.RnsChain([1000003, 1000033])   # primes but ≢ 1 mod 512
    elif case == "small":
        kw["zqs"] = ns.RnsChain([7681])                # ≡ 1 mod 512 but ≤ 2^16
    elif case == "lookup":
        kw["m_map"] = {8: 512}                         # no entry for F4
    try:
        ns.pt2ct.pt2ct(a.addMul, **kw)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case,match", [("divide", "divide"), ("ntt", "NTT-friendly"),
                                        ("small", "too small"), ("lookup", "Could not find")])
def test_pt2ct_errors_match(case, match):
    """The errors of pt2ct (test_lang.py:192-213): the same exception type
    and message in both packages."""
    want = _pt2ct_error(JAX, jgolden(), case)
    got = _pt2ct_error(PORT, tgolden(), case)
    assert got == want
    assert got[0] == "ValueError" and match in got[1]


def test_object_language_monads():
    """Writer, reader and list monads of the object language
    (test_lang.py:119-131), in both packages."""
    for ns in (JAX, PORT):
        d, App = ns.dsl, ns.ir.App
        prog = App(
            App(d.bind_("writer"), App(d.tell_(), App(App(d.cons_(), d.string_("log")), d.nil_()))),
            d.lam(lambda _x: App(d.pure_("writer"), d.string_("done"))),
        )
        assert ns.eval_ir(prog) == ("done", ["log"])
        prog2 = App(App(d.bind_("reader"), d.ask_()), d.lam(lambda x: App(d.pure_("reader"), x)))
        assert ns.eval_ir(prog2)(42) == 42
        lst = App(App(d.bind_("list"), App(App(d.cons_(), d.string_("a")),
                                            App(App(d.cons_(), d.string_("b")), d.nil_()))),
                  d.lam(lambda x: App(App(d.cons_(), x), App(App(d.cons_(), x), d.nil_()))))
        assert ns.eval_ir(lst) == ["a", "a", "b", "b"]
        pair = App(d.fst_(), App(App(d.pair_(), d.string_("x")), d.string_("y")))
        assert ns.eval_ir(pair) == "x"


def test_monad_accumulator_surface():
    """MonadAccumulator (test_lang.py:222-257) in both packages."""
    for ns in (JAX, PORT):
        acc = ns.acc.Accumulator([], lambda a, b: a + (b or []))
        acc.append([1])
        assert acc.accumulate(lambda w: (sum(w), [2])) == 1 and acc.value == [1, 2]
        assert acc.reader(lambda w: len(w)) == 2 and acc.value == [1, 2]
        res, state = ns.acc.run_accumulator(
            lambda a: (a.append([7]), a.value[-1])[1], [], lambda x, y: x + (y or []))
        assert res == 7 and state == [7]
        assert ns.acc.eval_accumulator(lambda a: 42, [], lambda x, y: x) == 42
        d = ns.acc.DictAccumulator()
        d["k"] = 1
        d.append({"j": 2})
        assert dict(d.items()) == {"k": 1, "j": 2} and d.get("x") is None
        with pytest.raises(ValueError):
            d["k"] = 99


def test_keys_hints_append_only():
    """Keys are memoized and never rebound (test_lang.py:260-272); the port
    samples the same key as the JAX package from the same seed."""
    jctx, tctx = jkh.KeysHints(1.0, seed=3, bk=jgolden()), tkh.KeysHints(1.0, seed=3, bk=tgolden())
    sk = tctx.get_key(16)
    assert tctx.get_key(16) is sk
    assert np.array_equal(sk.coeffs, jctx.get_key(16).coeffs) and sk.variance == jctx.svar(16)
    with pytest.raises(ValueError):
        tctx.keys[16] = "other"


@pytest.mark.parametrize("bk", ["golden", "torch-cpu"])
def test_error_rate_prim(bk):
    """The object-language errorRate_ op (test_lang.py:144-160): the same
    rate in both packages."""
    tb = tgolden() if bk == "golden" else TorchBackend(device="cpu")
    rates = []
    for ns, b in ((JAX, jgolden()), (PORT, tb)):
        c = _compile_arith(ns, b, seed=3)
        rng = np.random.default_rng(3)
        pt = ns.Cyc.from_coeffs(4, (7,), rng.integers(0, 7, 2), b)
        ct = c.encrypt_arg(pt, 0)
        sk = c.ctx.get_key(512)
        rates.append(ns.eval_ir(ns.dsl.error_rate_(sk))(ct))
    assert rates[0] == rates[1] and 0 < rates[1] < 1e-4
