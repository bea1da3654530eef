"""alchemy_tpu_torch.she.fast, the slice as a whole: keygen, relin_hint,
encrypt, mul_relin and rescale bit-identical to the JAX package from the
same seed at impl="pallas" and at impl="mxu" (the default of both
packages), and the decrypt oracles (exact equality)."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alchemy_tpu.she import fast as jfast
from alchemy_tpu_torch.convert import to_numpy, to_torch
from alchemy_tpu_torch.she import fast as tfast


def _params(log_n, L, zp=2):
    jp = jfast.FastParams.make(log_n, L, zp=zp, impl="pallas")
    tp = tfast.FastParams.make(log_n, L, zp=zp, impl="pallas")
    assert (tp.n, tp.qs, tp.zp, tp.impl) == (jp.n, jp.qs, jp.zp, jp.impl)
    return jp, tp


def _negacyclic(m1, m2, zp):
    n = len(m1)
    c = np.convolve(m1.astype(np.int64), m2.astype(np.int64))
    return (c[:n] - np.concatenate([c[n:], [0]])) % zp


def _eq(jax_arr, port):
    return np.array_equal(np.asarray(jax_arr), to_numpy(port))


@pytest.mark.parametrize("log_n,L", [(10, 3), (11, 4)])
def test_keygen_hints_encrypt_match_jax(log_n, L):
    jp, tp = _params(log_n, L)
    rj, rt = np.random.default_rng(21), np.random.default_rng(21)
    sj, st = jfast.keygen(jp, rj), tfast.keygen(tp, rt, device="cpu")
    assert st.dtype == torch.int32 and _eq(sj, st)
    for shoup in (False, True):
        hj = jfast.relin_hint(jp, sj, rj, shoup=shoup)
        ht = tfast.relin_hint(tp, st, rt, shoup=shoup)
        if shoup:
            # companions reach 2^32 − 1: carried as their int32 bit pattern
            assert int(to_numpy(ht[0][1]).max()) >= 1 << 31
            hj, ht = [*hj[0], *hj[1]], [*ht[0], *ht[1]]
        assert all(_eq(a, b) for a, b in zip(hj, ht))
    msg = rj.integers(0, jp.zp, jp.n)
    rt.integers(0, jp.zp, jp.n)
    assert _eq(jfast.encrypt(jp, sj, msg, rj), tfast.encrypt(tp, st, msg, rt))


def test_entry_points_default_to_the_card():
    """Without device="cpu" the port's entry points put their tensors on the
    card; with no card they raise torch's CUDA error instead of running on
    the CPU."""
    from alchemy_tpu_torch.convert import to_torch as convert
    from alchemy_tpu_torch.examples import deep_circuit
    from alchemy_tpu_torch.she import hybrid as thyb

    tp = tfast.FastParams.make(10, 3)
    thk = thyb.HybridKS.make(tp)
    # each call → one tensor it made
    calls = (lambda: tfast.keygen(tp, np.random.default_rng(0)),
             lambda: thyb.hybrid_keygen_hint(thk, np.random.default_rng(0))[0],
             lambda: thyb.hybrid_relin_hint(thk, np.zeros(tp.n, dtype=np.int64),
                                            np.random.default_rng(0))[0],
             lambda: deep_circuit.run(log_n=5, depth=1, verbose=False)[1],
             lambda: convert(np.zeros(4, dtype=np.uint32)))
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            # CPU-only torch: "Torch not compiled with CUDA enabled"; a CUDA
            # build with no card names CUDA or NVIDIA in its error
            with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
                call()


def test_shoup_precompute_matches_jax():
    jp, tp = _params(10, 3)
    rng = np.random.default_rng(4)
    x = np.stack([rng.integers(0, q, (3, jp.n)) for q in jp.qs], axis=1).astype(np.uint32)
    vj, cj = jfast.shoup_precompute(jnp.asarray(x), jp.qs)
    vt, ct = tfast.shoup_precompute(to_torch(x, "cpu"), tp.qs)
    assert _eq(vj, vt) and _eq(cj, ct)


@pytest.mark.parametrize("log_n,L,k_drop", [(10, 3, 1), (11, 4, 2)])
def test_rescale_matches_jax(log_n, L, k_drop):
    jp, tp = _params(log_n, L)
    rng = np.random.default_rng(log_n)
    ct = np.stack([[rng.integers(0, q, jp.n) for q in jp.qs] for _ in range(2)]).astype(np.uint32)
    assert _eq(jfast.rescale(jp, jnp.asarray(ct), k_drop),
               tfast.rescale(tp, to_torch(ct, "cpu"), k_drop))


def test_mul_relin_from_converted_jax_state_matches_jax():
    """Keys, Shoup hints and ciphertexts made by the JAX package, carried
    over by the converter: the port's mul_relin gives the same residues."""
    jp, tp = _params(11, 3)
    rng = np.random.default_rng(8)
    s = jfast.keygen(jp, rng)
    hb, ha = jfast.relin_hint(jp, s, rng, shoup=True)
    ct_a = jnp.stack([jfast.encrypt(jp, s, rng.integers(0, 2, jp.n), rng) for _ in range(2)])
    ct_b = jnp.stack([jfast.encrypt(jp, s, rng.integers(0, 2, jp.n), rng) for _ in range(2)])
    ref = jfast._mul_relin_jnp(jp, ct_a, ct_b, hb, ha)
    hb_t, ha_t = (to_torch(tuple(map(np.asarray, h)), "cpu") for h in (hb, ha))
    out = tfast.mul_relin(tp, to_torch(ct_a, "cpu"), to_torch(ct_b, "cpu"), hb_t, ha_t)
    assert _eq(ref, out)
    # the converter carries the port's state back unchanged
    assert np.array_equal(to_numpy(hb_t)[1], np.asarray(hb[1]))


@pytest.mark.parametrize("shoup", [False, True], ids=["raw", "shoup"])
def test_mul_relin_decrypts_to_negacyclic_product(shoup):
    tp = tfast.FastParams.make(10, 3, zp=2)
    rng = np.random.default_rng(30)
    s = tfast.keygen(tp, rng, device="cpu")
    hb, ha = tfast.relin_hint(tp, s, rng, shoup=shoup)
    m1 = rng.integers(0, 2, (2, 3, tp.n))
    m2 = rng.integers(0, 2, (2, 3, tp.n))
    enc = lambda ms: torch.stack([torch.stack([tfast.encrypt(tp, s, m, rng) for m in row])
                                  for row in ms])
    out = tfast.mul_relin(tp, enc(m1), enc(m2), hb, ha)       # leading dims [2, 3]
    assert out.shape == (2, 3, 2, 3, tp.n)
    for i in range(2):
        for j in range(3):
            want = _negacyclic(m1[i, j], m2[i, j], 2)
            assert np.array_equal(tfast.decrypt(tp, s, out[i, j]), want)
    one = tfast.mul_relin(tp, enc(m1)[0, 0], enc(m2)[0, 0], hb, ha)    # a single ct
    assert one.shape == (2, 3, tp.n)


def _flat(h):
    return [*h[0], *h[1]] if isinstance(h[0], (tuple, list)) else list(h)


@pytest.mark.parametrize("shoup", [False, True], ids=["raw", "shoup"])
def test_mxu_slice_matches_jax(shoup):
    """impl="mxu" from one seed: keygen, relin_hint, encrypt, mul_relin,
    decrypt and rescale equal the JAX package's (its `ntt_mxu` path)."""
    jp = jfast.FastParams.make(10, 3, impl="mxu")
    tp = tfast.FastParams.make(10, 3)
    assert tp.impl == "mxu" and tp.qs == jp.qs
    rj, rt = np.random.default_rng(40), np.random.default_rng(40)
    sj, st = jfast.keygen(jp, rj), tfast.keygen(tp, rt, device="cpu")
    assert _eq(sj, st)
    hj = jfast.relin_hint(jp, sj, rj, shoup=shoup)
    ht = tfast.relin_hint(tp, st, rt, shoup=shoup)
    assert all(_eq(a, b) for a, b in zip(_flat(hj), _flat(ht)))
    msgs = rj.integers(0, 2, (4, jp.n))
    rt.integers(0, 2, (4, jp.n))
    cj = jnp.stack([jfast.encrypt(jp, sj, m, rj) for m in msgs])
    ct = torch.stack([tfast.encrypt(tp, st, m, rt) for m in msgs])
    assert _eq(cj, ct)
    ref = jfast.mul_relin(jp, cj[:2], cj[2:], *hj)
    out = tfast.mul_relin(tp, ct[:2], ct[2:], *ht)
    assert _eq(ref, out)
    down_j, down_t = jfast.rescale(jp, ref, 1), tfast.rescale(tp, out, 1)
    assert _eq(down_j, down_t)
    jdown = jfast.FastParams(n=jp.n, qs=jp.qs[:-1], zp=2, impl="mxu")
    tdown = tfast.FastParams(n=tp.n, qs=tp.qs[:-1], zp=2)
    for i in range(2):
        want = _negacyclic(msgs[i], msgs[2 + i], 2)
        assert np.array_equal(jfast.decrypt(jp, sj, ref[i]), tfast.decrypt(tp, st, out[i]))
        assert np.array_equal(tfast.decrypt(tp, st, out[i]), want)
        assert np.array_equal(tfast.decrypt(tdown, st[:-1], down_t[i]), want)
        assert np.array_equal(jfast.decrypt(jdown, sj[:-1], down_j[i]), want)


def _strided(h):
    """The same values in a non-contiguous layout (a transposed-and-back view)."""
    if isinstance(h, (tuple, list)):
        return tuple(map(_strided, h))
    out = h.transpose(0, 1).contiguous().transpose(0, 1)
    assert not out.is_contiguous() and torch.equal(out, h)
    return out


def _grid_shaped(h, n):
    """The kernel-grid shape [L, L, A, B·r] of the JAX package's
    `prep_pallas_hints`, as a non-contiguous view."""
    from alchemy_tpu_torch.backend.ntt3 import _split3

    if isinstance(h, (tuple, list)):
        return tuple(_grid_shaped(x, n) for x in h)
    A, B, r = _split3(n)
    return _strided(h).reshape(*h.shape[:2], A, B * r)


@pytest.mark.parametrize("layout", ["strided", "grid"])
@pytest.mark.parametrize("shoup", [False, True], ids=["raw", "shoup"])
def test_mul_relin_takes_any_hint_layout(layout, shoup):
    """Hints that are views (non-contiguous) or in the kernel-grid shape
    give the same product as contiguous [L, L, n] hints, and the JAX
    package's `_mul_relin_jnp` on the same values, at n = 2^6."""
    jp = jfast.FastParams.make(6, 3, impl="mxu")
    tp = tfast.FastParams.make(6, 3)
    rng = np.random.default_rng(60)
    s = tfast.keygen(tp, rng, device="cpu")
    hints = tfast.relin_hint(tp, s, rng, shoup=shoup)
    cts = torch.stack([tfast.encrypt(tp, s, rng.integers(0, 2, tp.n), rng) for _ in range(4)])
    want = tfast.mul_relin(tp, cts[:2], cts[2:], *hints)
    views = [_strided(h) if layout == "strided" else _grid_shaped(h, tp.n) for h in hints]
    out = tfast.mul_relin(tp, cts[:2], cts[2:], *views)
    assert torch.equal(out, want)
    # the JAX package is given the same views (its `_flat` takes the grid shape)
    to_jax = lambda h: tuple(map(jnp.asarray, to_numpy(h))) if isinstance(h, tuple) \
        else jnp.asarray(to_numpy(h))
    cj = jnp.asarray(to_numpy(cts))
    assert _eq(jfast._mul_relin_jnp(jp, cj[:2], cj[2:], *map(to_jax, views)), out)


@pytest.mark.cuda
@pytest.mark.parametrize("shoup", [False, True], ids=["raw", "shoup"])
def test_mul_relin_takes_misaligned_hints_on_the_card(shoup):
    """A hint at storage offset 1 (off the 16-byte boundary kernels B and 4
    read from) is copied by the op entry points, TrivGad and hybrid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from alchemy_tpu_torch.she import hybrid as thyb

    def misaligned(h):
        if isinstance(h, (tuple, list)):
            return tuple(map(misaligned, h))
        out = torch.empty(h.numel() + 1, dtype=h.dtype, device=h.device)[1:].view(h.shape)
        out.copy_(h)
        assert out.data_ptr() % 16
        return out

    tp = tfast.FastParams.make(14, 3)
    rng = np.random.default_rng(14)
    s = tfast.keygen(tp, rng, device="cuda")
    hints = tfast.relin_hint(tp, s, rng, shoup=shoup)
    cts = torch.stack([tfast.encrypt(tp, s, rng.integers(0, 2, tp.n), rng) for _ in range(4)])
    want = tfast.mul_relin(tp, cts[:2], cts[2:], *hints)
    assert torch.equal(tfast.mul_relin(tp, cts[:2], cts[2:], *map(misaligned, hints)), want)
    hk = thyb.HybridKS.make(tp)
    s_h, hh = thyb.hybrid_keygen_hint(hk, rng, device="cuda")
    if shoup:
        hh = tuple(tfast.shoup_precompute(h, hk.pe.qs) for h in hh)
    cts = torch.stack([tfast.encrypt(tp, s_h, rng.integers(0, 2, tp.n), rng) for _ in range(4)])
    want = thyb.mul_relin_hybrid(hk, cts[:2], cts[2:], *hh)
    assert torch.equal(thyb.mul_relin_hybrid(hk, cts[:2], cts[2:], *map(misaligned, hh)), want)


def test_rescale_matches_jax_mxu():
    jp = jfast.FastParams.make(11, 4, impl="mxu")
    tp = tfast.FastParams.make(11, 4, impl="mxu")
    rng = np.random.default_rng(11)
    ct = np.stack([[rng.integers(0, q, jp.n) for q in jp.qs] for _ in range(2)]).astype(np.uint32)
    assert _eq(jfast.rescale(jp, jnp.asarray(ct), 2), tfast.rescale(tp, to_torch(ct, "cpu"), 2))


@pytest.mark.parametrize("impl", ["mxu", "pallas"])
@pytest.mark.parametrize("k_drop", [1, 2, 3])
@pytest.mark.parametrize("zp", [2, 4, 1 << 16, 1 << 17])
def test_rescale_paths_match_the_loop(zp, k_drop, impl):
    """`rescale` on ciphertexts [3, 2, L, n]: at a power-of-two zp ≤ 2^16
    the joint-rescale path, one limb at a time, equal to the limb-by-limb
    loop bit for bit; above 2^16 the loop, equal to the JAX package's
    rescale. `RESCALES_BY_PATH` counts one rescale a limb on the path
    taken."""
    log_n, L = 10, 5
    tp = tfast.FastParams.make(log_n, L, zp=zp, impl=impl)
    rng = np.random.default_rng(zp + 10 * k_drop)
    ct = np.stack([[[rng.integers(0, q, tp.n) for q in tp.qs] for _ in range(2)]
                   for _ in range(3)]).astype(np.uint32)
    tfast.reset_rescales()
    got = tfast.rescale(tp, to_torch(ct, "cpu"), k_drop)
    path = "kernel" if zp <= 1 << 16 else "loop"
    assert tfast.RESCALES_BY_PATH == {path: k_drop}
    assert tfast.RESCALES_BY_L == {L - i: 1 for i in range(k_drop)}
    assert got.shape == (3, 2, L - k_drop, tp.n) and got.dtype == torch.int32
    if path == "kernel":
        assert torch.equal(got, tfast._rescale_loop(tp, to_torch(ct, "cpu"), k_drop))
    else:
        jp = jfast.FastParams.make(log_n, L, zp=zp, impl=impl)
        assert _eq(jfast.rescale(jp, jnp.asarray(ct), k_drop), got)
    tfast.reset_rescales()
    assert tfast.RESCALES_BY_PATH == {} and tfast.RESCALES_BY_L == {}


def test_impl_is_checked():
    """Every impl of the JAX package's FastParams is accepted, with the slot
    order the kernels take; anything else raises."""
    for impl, order in (("pallas", "pallas"), ("mxu", "mxu"), ("mxu8", "mxu"), ("vpu", "vpu")):
        p = tfast.FastParams.make(10, 3, impl=impl)
        assert (p.impl, p.order) == (impl, order)
    for impl in ("radix4", "MXU"):
        with pytest.raises(ValueError, match="impl"):
            tfast.FastParams.make(10, 3, impl=impl)


def test_default_impl_is_mxu_in_both_packages():
    """Run where ALCHEMY_NTT_IMPL is unset (tests/conftest.py sets it for the
    JAX package's own tests): `FastParams.make(10, 3)` has impl "mxu" in
    both packages, and `keygen` with defaults on both sides agrees."""
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import numpy as np\n"
        "from alchemy_tpu.she import fast as jfast\n"
        "from alchemy_tpu_torch.she import fast as tfast\n"
        "jp, tp = jfast.FastParams.make(10, 3), tfast.FastParams.make(10, 3)\n"
        "assert jp.impl == tp.impl == 'mxu', (jp.impl, tp.impl)\n"
        "sj = np.asarray(jfast.keygen(jp, np.random.default_rng(0)))\n"
        "st = tfast.keygen(tp, np.random.default_rng(0), device='cpu')\n"
        "assert np.array_equal(sj, st.numpy().view(np.uint32))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "ALCHEMY_NTT_IMPL"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_decrypt_after_rescale_gives_the_message():
    """The oracle of tests/test_fast.py:75-94 on the port."""
    tp = tfast.FastParams.make(10, 3, zp=2)
    rng = np.random.default_rng(4)
    s = tfast.keygen(tp, rng, device="cpu")
    msg = rng.integers(0, 2, tp.n)
    ct = tfast.encrypt(tp, s, msg, rng)
    assert np.array_equal(tfast.decrypt(tp, s, ct), msg)
    down = tfast.rescale(tp, ct, 1)
    p_down = tfast.FastParams(n=tp.n, qs=tp.qs[:-1], zp=tp.zp)
    assert np.array_equal(tfast.decrypt(p_down, s[:-1], down), msg % 2)


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [14, 16])
def test_mxu_mul_relin_on_the_card_matches_jax(log_n):
    """TrivGad at impl="mxu" on the card (kernels 8 for the set-up, A and B
    in the 2-factor order) against the JAX package's jnp path on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jp = jfast.FastParams.make(log_n, 3, impl="mxu")
    tp = tfast.FastParams.make(log_n, 3, impl="mxu")
    rj, rt = np.random.default_rng(log_n), np.random.default_rng(log_n)
    sj, st = jfast.keygen(jp, rj), tfast.keygen(tp, rt, device="cuda")
    hj, ht = jfast.relin_hint(jp, sj, rj, shoup=True), tfast.relin_hint(tp, st, rt, shoup=True)
    msgs = rj.integers(0, 2, (4, jp.n))
    rt.integers(0, 2, (4, jp.n))
    cj = jnp.stack([jfast.encrypt(jp, sj, m, rj) for m in msgs])
    ct = torch.stack([tfast.encrypt(tp, st, m, rt) for m in msgs])
    out = tfast.mul_relin(tp, ct[:2], ct[2:], *ht)
    assert out.is_cuda and _eq(jfast.mul_relin(jp, cj[:2], cj[2:], *hj), out)
    assert np.array_equal(tfast.decrypt(tp, st, out[0]), _negacyclic(msgs[0], msgs[2], 2))
