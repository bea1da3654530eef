"""The general SHE layer of the port (`she/bgv.py`, `she/tunnel.py`,
gadgets, keys) against the JAX package's golden backend, mirroring
tests/test_bgv.py: the same seeded script runs in both packages and every
ciphertext, decryption and error rate must be equal (exact equality). The
port runs on `TorchBackend(device="cpu")` — the float64 `axis_matmul` route
the card runs — and, under the `cuda` marker, on the checked backend on
the card. Also: JAX-made hints and ciphertexts carried into the port, and
the entry points' default device."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from alchemy_tpu.backend import golden_backend as jgolden
from alchemy_tpu.core.cyc import Cyc as JCyc
from alchemy_tpu.examples import common as jcommon
from alchemy_tpu.she import bgv as jbgv
from alchemy_tpu.she import gadget as jgad
from alchemy_tpu.she import tunnel as jtun
from alchemy_tpu.she.keys import SK as JSK
from alchemy_tpu.she.linear import LinearMap as JLinearMap
from alchemy_tpu_torch import convert
from alchemy_tpu_torch.backend import golden_backend as tgolden
from alchemy_tpu_torch.backend.torch_backend import TorchBackend
from alchemy_tpu_torch.core.cyc import Cyc as TCyc
from alchemy_tpu_torch.examples import common as tcommon
from alchemy_tpu_torch.nt.factor import totient
from alchemy_tpu_torch.nt.primes import find_ntt_prime
from alchemy_tpu_torch.she import bgv as tbgv
from alchemy_tpu_torch.she import gadget as tgad
from alchemy_tpu_torch.she import tunnel as ttun
from alchemy_tpu_torch.she.keys import SK as TSK
from alchemy_tpu_torch.she.linear import LinearMap as TLinearMap

JAX = SimpleNamespace(Cyc=JCyc, bgv=jbgv, gad=jgad, tun=jtun, SK=JSK, LinearMap=JLinearMap,
                      common=jcommon)
PORT = SimpleNamespace(Cyc=TCyc, bgv=tbgv, gad=tgad, tun=ttun, SK=TSK, LinearMap=TLinearMap,
                       common=tcommon)

M, MP = 4, 32  # plaintext ring F4, ciphertext ring F32
P = 8          # plaintext modulus 2^3
GADGETS = {"triv": lambda g: g.TrivGad(), "base2": lambda g: g.BaseBGad(2),
           "hybrid": lambda g: g.HybridGad()}


def chain(m_prime, n=3, bits=(30, 29, 28)):
    return tuple(find_ntt_prime(m_prime, b) for b in bits[:n])


def _state(x):
    """A CT or Cyc → comparable numpy state (metadata and residues)."""
    if hasattr(x, "comps"):
        return (x.m, x.zp, x.scale, x.m_prime, x.qs,
                [(c.basis, c.bk.to_numpy(c.data).tolist()) for c in x.comps])
    return (x.m, x.qs, x.basis, x.bk.to_numpy(x.data).tolist())


def _both(scenario, bk, *args):
    """Run scenario(ns, bk, ...) in the JAX package on its golden backend
    and in the port on bk; assert every recorded value is equal."""
    want = scenario(JAX, jgolden(), *args)
    got = scenario(PORT, bk, *args)
    assert [k for k, _ in want] == [k for k, _ in got]
    for (k, w), (_, g) in zip(want, got):
        if isinstance(w, (bool, float)):
            assert w == g, k
        else:
            assert _state(w) == _state(g), k
    return got


def _setup(ns, bk, m_prime=MP, nlimb=3, var=1.0, seed=7):
    rng = np.random.default_rng(seed)
    qs = chain(m_prime, nlimb)
    sk = ns.SK.generate(m_prime, var, rng)
    return rng, qs, sk


def _rand_pt(ns, bk, rng, m=M, p=P):
    return ns.Cyc.from_coeffs(m, (p,), rng.integers(0, p, size=totient(m)), bk)


def linear_ops(ns, bk):
    rng, qs, sk = _setup(ns, bk)
    a, b, k = (_rand_pt(ns, bk, rng) for _ in range(3))
    ca = ns.bgv.encrypt(sk, a, MP, qs, rng)
    cb = ns.bgv.encrypt(sk, b, MP, qs, rng)
    out = [("enc a", ca), ("enc b", cb), ("dec a", ns.bgv.decrypt(sk, ca)),
           ("rate a", ns.bgv.error_rate(sk, ca))]
    for name, ct, want in (("add", ns.bgv.add(ca, cb), a + b), ("neg", ns.bgv.neg(ca), -a),
                           ("add_public", ns.bgv.add_public(k, ca), a + k),
                           ("mul_public", ns.bgv.mul_public(k, ca), a * k)):
        dec = ns.bgv.decrypt(sk, ct)
        out += [(name, ct), (name + " dec", dec), (name + " ok", dec.equals(want))]
    return out


def mul_keyswitch_modswitch(ns, bk, gad):
    rng, qs, sk = _setup(ns, bk)
    a, b = _rand_pt(ns, bk, rng), _rand_pt(ns, bk, rng)
    ca = ns.bgv.encrypt(sk, a, MP, qs, rng)
    cb = ns.bgv.encrypt(sk, b, MP, qs, rng)
    prod = ns.bgv.mul(ca, cb)
    hint = ns.bgv.ks_quad_circ_hint(sk, GADGETS[gad](ns.gad), qs, P, rng, bk)
    lin = ns.bgv.key_switch_quad(hint, prod)
    down = ns.bgv.mod_switch(lin, qs[:2])
    down2 = ns.bgv.mod_switch(down, qs[:1])
    out = [("prod", prod), ("prod ok", ns.bgv.decrypt(sk, prod).equals(a * b))]
    out += [(f"hint {j} {i}", c) for j, row in enumerate(hint.rows) for i, c in enumerate(row)]
    for name, ct in (("lin", lin), ("down", down), ("down2", down2)):
        out += [(name, ct), (name + " ok", ns.bgv.decrypt(sk, ct).equals(a * b)),
                (name + " rate", ns.bgv.error_rate(sk, ct))]
    return out


def mod_switch_up_down_pt(ns, bk):
    rng, qs, sk = _setup(ns, bk)
    a = _rand_pt(ns, bk, rng)
    ca = ns.bgv.encrypt(sk, a, MP, qs[:2], rng)
    up = ns.bgv.mod_switch(ca, qs)
    down = ns.bgv.mod_switch(up, qs[:2])
    # plaintext 2x mod 2^3, homomorphic div2 → x mod 2^2
    x = _rand_pt(ns, bk, rng)
    half = ns.bgv.mod_switch_pt(ns.bgv.encrypt(sk, x.scalar_mul(2), MP, qs, rng))
    x4 = ns.Cyc.from_coeffs(M, (P // 2,), bk.to_numpy(x.data)[0] % (P // 2), bk)
    return [("up", up), ("up ok", ns.bgv.decrypt(sk, up).equals(a)), ("down", down),
            ("down ok", ns.bgv.decrypt(sk, down).equals(a)), ("half", half),
            ("half ok", ns.bgv.decrypt(sk, half).equals(x4))]


def scale_tracking(ns, bk):
    # a chain whose primes are ≢ 1 mod p exercises the scale factor
    rng = np.random.default_rng(3)
    m_prime, p = 32, 7
    qs = tuple(find_ntt_prime(m_prime, b) for b in (29, 27))
    sk = ns.SK.generate(m_prime, 1.0, rng)
    a = ns.Cyc.from_coeffs(4, (p,), rng.integers(0, p, size=2), bk)
    down = ns.bgv.mod_switch(ns.bgv.encrypt(sk, a, m_prime, qs, rng), qs[:1])
    return [("down", down), ("scale moved", down.scale != 1),
            ("down ok", ns.bgv.decrypt(sk, down).equals(a))]


def tunnel_small(ns, bk, gad):
    # r=8 → s=4 over e=4; r'=24, s'=24
    r, s, e = 8, 4, 4
    r_p = s_p = 24
    p = 8
    rng = np.random.default_rng(11)
    qs = tuple(find_ntt_prime(24, b) for b in (30, 29))
    sk_in = ns.SK.generate(r_p, 1.0, rng)
    sk_out = ns.SK.generate(s_p, 1.0, rng)
    dim = totient(r) // totient(e)
    images = tuple(
        ns.Cyc.from_coeffs(s, (p,), rng.integers(0, p, size=totient(s)), bk)
        for _ in range(dim))
    f = ns.LinearMap(e=e, r=r, s=s, images=images)
    x = ns.Cyc.from_coeffs(r, (p,), rng.integers(0, p, size=totient(r)), bk)
    ct = ns.bgv.encrypt(sk_in, x, r_p, qs, rng)
    hint = ns.tun.tunnel_hint(f, sk_out, sk_in, GADGETS[gad](ns.gad), qs, p, rng, bk)
    out = ns.tun.tunnel(hint, ct)
    return [("ct", ct), ("out", out),
            ("out ok", ns.bgv.decrypt(sk_out, out).equals(f.eval(x))),
            ("out rate", ns.bgv.error_rate(sk_out, out))]


CASES = [(linear_ops, ()), (mod_switch_up_down_pt, ()), (scale_tracking, ()),
         *[(mul_keyswitch_modswitch, (g,)) for g in GADGETS],
         *[(tunnel_small, (g,)) for g in ("triv", "base2")]]
IDS = [c.__name__ + "".join(f"-{a}" for a in args) for c, args in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bgv_matches_jax(case):
    scenario, args = case
    got = _both(scenario, TorchBackend(device="cpu"), *args)
    assert all(v for k, v in got if k.endswith(" ok"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bgv_checked_on_the_card(case):
    """The same scripts on the checked backend: every TorchBackend op on the
    card held against golden numpy op by op, and the results against the
    JAX package."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from alchemy_tpu_torch.backend import get_backend

    scenario, args = case
    bk = get_backend("checked")
    assert bk.fast.device.type == "cuda"
    got = _both(scenario, bk, *args)
    assert all(v for k, v in got if k.endswith(" ok"))


def full_width_tunnel(ns, bk):
    """H0′ → H1′ at the examples' rings under HomomRLWR's six moduli
    (examples/homomrlwr.py:37-43), TrivGad, plaintexts mod 32."""
    import math

    rng = np.random.default_rng(0)
    qs = (1543651201, 689270401, 718099201, 720720001, 1556755201, 1567238401)
    sk_in, sk_out = (ns.SK.generate(m, 5.0 / math.sqrt(totient(m)), rng) for m in (11648, 29120))
    f = ns.common.dec_to_crt(128, 448, 32)
    x = ns.Cyc.from_coeffs(128, (32,), rng.integers(0, 32, totient(128)), bk)
    ct = ns.bgv.encrypt(sk_in, x, 11648, qs, rng)
    hint = ns.tun.tunnel_hint(f, sk_out, sk_in, ns.gad.TrivGad(), qs, 32, rng, bk)
    out = ns.tun.tunnel(hint, ct)
    return [("ct", ct), ("out", out), ("out ok", ns.bgv.decrypt(sk_out, out).equals(f.eval(x)))]


@pytest.mark.slow
def test_full_width_tunnel_matches_jax():
    got = _both(full_width_tunnel, TorchBackend(device="cpu"))
    assert all(v for k, v in got if k.endswith(" ok"))


@pytest.mark.parametrize("gad", ["triv", "hybrid"])
def test_jax_made_hint_and_ciphertext_run_through_the_port(gad):
    """A key-switch hint, a tunnel hint and ciphertexts made by the JAX
    package, carried into the port with `convert`, give the JAX results."""
    jb, tb = jgolden(), TorchBackend(device="cpu")
    rng, qs, sk = _setup(JAX, jb)
    a, b = _rand_pt(JAX, jb, rng), _rand_pt(JAX, jb, rng)
    prod = jbgv.mul(jbgv.encrypt(sk, a, MP, qs, rng), jbgv.encrypt(sk, b, MP, qs, rng))
    hint = jbgv.ks_quad_circ_hint(sk, GADGETS[gad](jgad), qs, P, rng, jb)
    want = jbgv.key_switch_quad(hint, prod)
    got = tbgv.key_switch_quad(convert.ks_hint_from(hint, tb), convert.ct_from(prod, tb))
    assert _state(want) == _state(got)
    tsk = convert.sk_from(sk)
    assert np.array_equal(tsk.coeffs, sk.coeffs) and tsk.variance == sk.variance
    assert tbgv.decrypt(tsk, got).equals(convert.cyc_from(a * b, tb))

    p = 8
    qs24 = tuple(find_ntt_prime(24, bits) for bits in (30, 29))
    sk_in, sk_out = JSK.generate(24, 1.0, rng), JSK.generate(24, 1.0, rng)
    images = tuple(JCyc.from_coeffs(4, (p,), rng.integers(0, p, size=2), jb) for _ in range(2))
    f = JLinearMap(e=4, r=8, s=4, images=images)
    x = JCyc.from_coeffs(8, (p,), rng.integers(0, p, size=4), jb)
    ct = jbgv.encrypt(sk_in, x, 24, qs24, rng)
    th = jtun.tunnel_hint(f, sk_out, sk_in, jgad.TrivGad(), qs24, p, rng, jb)
    got = ttun.tunnel(convert.tunnel_hint_from(th, tb), convert.ct_from(ct, tb))
    assert _state(jtun.tunnel(th, ct)) == _state(got)
    assert tbgv.decrypt(convert.sk_from(sk_out), got).equals(convert.cyc_from(f.eval(x), tb))


@pytest.mark.parametrize("gad", ["triv", "hybrid"])
def test_to_backend_rehomes_a_hint(gad):
    """A hint made on the golden backend, moved wholesale to the torch
    backend by `she.convert.to_backend`, switches a product as it does on
    golden."""
    from alchemy_tpu_torch.backend import golden_backend
    from alchemy_tpu_torch.she.convert import to_backend

    gb, tb = golden_backend(), TorchBackend(device="cpu")
    rng, qs, sk = _setup(PORT, gb)
    a, b = _rand_pt(PORT, gb, rng), _rand_pt(PORT, gb, rng)
    prod = tbgv.mul(tbgv.encrypt(sk, a, MP, qs, rng), tbgv.encrypt(sk, b, MP, qs, rng))
    hint = tbgv.ks_quad_circ_hint(sk, GADGETS[gad](tgad), qs, P, rng, gb)
    moved, prod_t = to_backend(hint, tb), to_backend(prod, tb)
    assert all(c.bk is tb for row in moved.rows for c in row) and moved.ext_qs == hint.ext_qs
    got = tbgv.key_switch_quad(moved, prod_t)
    assert _state(got) == _state(tbgv.key_switch_quad(hint, prod))
    assert tbgv.decrypt(sk, got).equals(a * b)


def test_backend_entry_points_default_to_the_card():
    """`get_backend("torch")`, `get_backend("checked")` and `TorchBackend()`
    put their tensors on the card; with no card they raise instead of
    running on the CPU."""
    from alchemy_tpu_torch.backend import get_backend
    from alchemy_tpu_torch.backend.checked import CheckedBackend

    calls = (lambda: get_backend("torch").zeros(1, 4),
             lambda: get_backend("checked").zeros(1, 4).dev,
             lambda: TorchBackend().asarray(np.zeros(4), (17,)),
             lambda: CheckedBackend().fast.zeros(1, 4))
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
                call()


def _with_big_error(ns, bk, k_coeffs, seed):
    """A ciphertext of a random plaintext whose error term has p·k_coeffs
    added (c0 += p·k, the plaintext unchanged), with its key and plaintext."""
    rng, qs, sk = _setup(ns, bk, seed=seed)
    a = _rand_pt(ns, bk, rng)
    ct = ns.bgv.encrypt(sk, a, MP, qs, rng)
    lift = np.stack([np.array([P * k % q for k in k_coeffs], dtype=np.int64) for q in qs])
    c0 = ct.comps[0] + ns.Cyc.from_coeffs(MP, qs, lift, bk)
    return sk, ct.with_comps((c0, ct.comps[1])), a


def test_decrypt_past_2_63_returns_the_plaintext():
    """An error term with coefficients above 2^63 (and below Q/2 ≈ 2^86) at
    m = 4, m′ = 32 and 3 limbs: the port's `decrypt` reduces the twaced
    integers mod p before any int64 cast and returns the plaintext, where
    the JAX package's `twace_int_host` raises OverflowError."""
    big = [(1 << 63) // P + 12345 * (i + 1) for i in range(totient(MP))]
    jsk, jct, _ = _with_big_error(JAX, jgolden(), big, seed=21)
    with pytest.raises(OverflowError):
        jbgv.decrypt(jsk, jct)
    for bk in (TorchBackend(device="cpu"), tgolden()):
        sk, ct, a = _with_big_error(PORT, bk, big, seed=21)
        assert _state(ct) == _state(jct)
        assert max(abs(int(v)) for v in tbgv.error_term_int(sk, ct)) > 1 << 63
        assert tbgv.decrypt(sk, ct).equals(a)


@pytest.mark.parametrize("seed", range(4))
def test_decrypt_below_2_63_matches_jax(seed):
    """Seeded random error terms below 2^63: both packages decrypt equally."""
    rng = np.random.default_rng(100 + seed)
    k = [int(v) for v in rng.integers(-(1 << 59), 1 << 59, totient(MP))]
    jsk, jct, ja = _with_big_error(JAX, jgolden(), k, seed=seed)
    sk, ct, a = _with_big_error(PORT, TorchBackend(device="cpu"), k, seed=seed)
    want, got = jbgv.decrypt(jsk, jct), tbgv.decrypt(sk, ct)
    assert _state(got) == _state(want) and got.equals(a) and want.equals(ja)
