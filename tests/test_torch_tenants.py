"""alchemy_tpu_torch.she.tenants and kernel B's tenant-indexed form: a batch
of products gathered across tenants (`fast.mul_relin(p, a, b,
keys.batch(ids))`) gives, row for row and bit for bit, the single-tenant
product under each row's tenant's hints, in the port and in the JAX package;
each row decrypts under its own tenant's key and not under another's; the
key store's checks; the root span's count of distinct tenants. On the card:
kernel B's tenant form (`digit_relin_tenants`) against its plain form, and
an index outside the tables stopping it with a CUDA error.

The JAX package is imported inside the one test that compares with it, so
the card's test runs without it."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from alchemy_tpu_torch.backend.cuda import launch
from alchemy_tpu_torch.backend.cuda import mul_relin as mr
from alchemy_tpu_torch.she import fast, tenants
from alchemy_tpu_torch.utils import profiling

#: the tenant of each row of the tests' batches: every tenant, repeated, mixed
IDS = (2, 0, 0, 1, 2, 0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the small int64 ops run many times faster so on a
    shared host than spread over its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _negacyclic(m1, m2, zp):
    n = len(m1)
    c = np.convolve(m1.astype(np.int64), m2.astype(np.int64))
    return (c[:n] - np.concatenate([c[n:], [0]])) % zp


def _tenant(p, t, device="cpu"):
    """Tenant t's key and Shoup hints, from a seed of its own."""
    rng = np.random.default_rng(100 + t)
    s = fast.keygen(p, rng, device=device)
    return s, fast.relin_hint(p, s, rng, shoup=True)


def _state(log_n=10, L=3, impl="mxu", T=3, ids=IDS, device="cpu"):
    """(p, keys, secrets, hints, ct_a, ct_b, messages) of a batch whose row r
    is encrypted under tenant ids[r]'s key."""
    p = fast.FastParams.make(log_n, L, impl=impl)
    keys = tenants.TenantKeys(p, T, device=device)
    secrets, hints = zip(*(_tenant(p, t, device) for t in range(T)))
    for t, h in enumerate(hints):
        keys.add(t, h)
    rng = np.random.default_rng(7)
    msgs = rng.integers(0, p.zp, (2, len(ids), p.n))
    enc = lambda ms: torch.stack([fast.encrypt(p, secrets[t], m, rng) for t, m in zip(ids, ms)])
    return p, keys, secrets, hints, enc(msgs[0]), enc(msgs[1]), msgs


@pytest.mark.parametrize("impl", ["mxu", "pallas"])
def test_tenant_rows_equal_single_tenant_products(impl):
    p, keys, _, hints, ct_a, ct_b, _ = _state(impl=impl)
    out = fast.mul_relin(p, ct_a, ct_b, keys.batch(IDS))
    assert out.shape == ct_a.shape and out.dtype == torch.int32
    for r, t in enumerate(IDS):
        one = fast.mul_relin(p, ct_a[r:r + 1], ct_b[r:r + 1], *hints[t])
        assert torch.equal(out[r], one[0]), r
    # leading dims flatten to rows, as with one hint pair
    two = fast.mul_relin(p, ct_a.reshape(2, 3, *ct_a.shape[1:]),
                         ct_b.reshape(2, 3, *ct_b.shape[1:]), keys.batch(IDS))
    assert torch.equal(two.reshape(out.shape), out)


def test_tenant_rows_equal_jax_mul_relin():
    """The JAX package's keys, hints and ciphertexts from the same seeds, and
    its mul_relin on each tenant's rows with that tenant's hints."""
    import jax.numpy as jnp

    from alchemy_tpu.she import fast as jfast
    from alchemy_tpu_torch.convert import to_numpy

    p, keys, _, _, ct_a, ct_b, msgs = _state()
    jp = jfast.FastParams.make(10, 3, impl="mxu")
    assert (jp.n, jp.qs) == (p.n, p.qs)
    out = to_numpy(fast.mul_relin(p, ct_a, ct_b, keys.batch(IDS)))
    jkeys = []
    for t in range(3):
        rng = np.random.default_rng(100 + t)
        s = jfast.keygen(jp, rng)
        jkeys.append((s, jfast.relin_hint(jp, s, rng, shoup=True)))
    rng = np.random.default_rng(7)
    rng.integers(0, p.zp, msgs.shape)
    enc = lambda ms: jnp.stack([jfast.encrypt(jp, jkeys[t][0], m, rng) for t, m in zip(IDS, ms)])
    ja, jb = enc(msgs[0]), enc(msgs[1])
    for t in range(3):                  # every row under tenant t's hints: one shape, one compile
        rows = [r for r, u in enumerate(IDS) if u == t]
        ref = np.asarray(jfast._mul_relin_jnp(jp, ja, jb, *jkeys[t][1]))
        assert np.array_equal(out[rows], ref[rows]), t


def test_tenant_rows_decrypt_under_their_own_keys():
    """Each row decrypts under its tenant's key to the negacyclic product; a
    batch whose index names the next tenant fails to decrypt."""
    p, keys, secrets, _, ct_a, ct_b, msgs = _state()
    out = fast.mul_relin(p, ct_a, ct_b, keys.batch(IDS))
    shifted = fast.mul_relin(p, ct_a, ct_b, keys.batch((t + 1) % 3 for t in IDS))
    for r, t in enumerate(IDS):
        want = _negacyclic(msgs[0, r], msgs[1, r], p.zp)
        assert np.array_equal(fast.decrypt(p, secrets[t], out[r]), want), r
        wrong = fast.decrypt(p, secrets[t], shifted[r]) != want
        assert wrong.mean() > 0.25, r


def test_tenant_keys_check_what_they_take():
    p, keys, _, hints, ct_a, ct_b, _ = _state(T=3)
    L = len(p.qs)
    assert keys.nbytes == 2 * 2 * 3 * L * L * p.n * 4 == keys.table.numel() * 4
    assert keys.tenants == 3
    fresh = tenants.TenantKeys(p, 4, device="cpu")
    fresh.add(1, hints[1])
    with pytest.raises(ValueError, match="no hints"):
        fresh.batch([1, 0])                                  # tenant 0 never added
    for bad in (4, -1, 1.0, "1"):
        with pytest.raises(ValueError, match="integer"):
            fresh.batch([bad])
        with pytest.raises(ValueError, match="integer"):
            fresh.add(bad, hints[1])
    (hb, hbs), (ha, has) = hints[0]
    wrong = [(hb, ha),                                       # raw hints
             ((hb, hbs), (ha[:, :1].contiguous(), has)),     # a row short
             ((hb.long(), hbs), (ha, has)),                  # not int32
             ((hb, hbs),)]
    for h in wrong:
        with pytest.raises(ValueError, match="Shoup pair"):
            fresh.add(2, h)
    assert fresh.present == [False, True, False, False]
    # the kernel-grid layout of a hint is taken, as kernel_hint takes it
    fresh.add(3, tuple(tuple(x.reshape(L, L, 8, p.n // 8) for x in pair) for pair in hints[0]))
    assert torch.equal(fresh.table[:, :, 3], keys.table[:, :, 0])
    batch = keys.batch(np.array(IDS))                        # numpy ids are integers
    assert batch.index.tolist() == list(IDS) and batch.index.dtype == torch.int32
    assert batch.tenants == 3
    with pytest.raises(ValueError):                          # one row short
        fast.mul_relin(p, ct_a, ct_b, keys.batch(IDS[:-1]))
    other = fast.FastParams.make(10, 4)
    with pytest.raises(ValueError, match="TenantBatch"):     # keys of another chain
        fast.mul_relin(other, ct_a, ct_b, batch)
    with pytest.raises(ValueError, match="TenantBatch"):
        fast.mul_relin(p, ct_a, ct_b, hints[0][0])


def test_root_span_counts_distinct_tenants():
    p, keys, _, hints, ct_a, ct_b, _ = _state()
    profiling.reset()
    try:
        with profiling.tracing():
            fast.mul_relin(p, ct_a, ct_b, keys.batch(IDS))
            fast.mul_relin(p, ct_a[:3], ct_b[:3], keys.batch(IDS[:3]))
            fast.mul_relin(p, ct_a, ct_b, *hints[0])
        got = [(s.name, s.attrs, s.parent is None) for s in profiling.spans()]
    finally:
        profiling.reset()
    root = {"batch": 6, "L": 3, "n": p.n}
    assert got == [
        ("mul_relin", {**root, "tenants": 3}, True),
        ("launch.tensor_intt", {"entry": "tensor_intt"}, False),
        ("launch.digit_relin_tenants", {"entry": "digit_relin_tenants"}, False),
        ("mul_relin", {**root, "batch": 3, "tenants": 2}, True),
        ("launch.tensor_intt", {"entry": "tensor_intt"}, False),
        ("launch.digit_relin_tenants", {"entry": "digit_relin_tenants"}, False),
        ("mul_relin", root, True),
        ("launch.tensor_intt", {"entry": "tensor_intt"}, False),
        ("launch.digit_relin", {"entry": "digit_relin"}, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("log_n,Bt", [(15, 16), (16, 4)])
def test_digit_relin_tenants_matches_plain_on_the_card(log_n, Bt):
    """[16, 8, 2^15] (and [4, 8, 2^16], B's large shape) over 3 tenants' hint
    tables, rows of every tenant: the kernel against its plain form, and
    each row against kernel B with that tenant's hints alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, T = fast.FastParams.make(log_n, 8), 3
    rng = np.random.default_rng(log_n)
    q = np.array(p.qs, dtype=np.int64)[:, None]
    res = lambda shape: torch.from_numpy(rng.integers(0, 1 << 62, shape) % q).to(
        torch.int32).cuda()
    ct_a, ct_b = res((Bt, 2, 8, p.n)), res((Bt, 2, 8, p.n))
    keys = tenants.TenantKeys(p, T)
    for t in range(T):
        keys.add(t, tuple(fast.shoup_precompute(res((8, 8, p.n)), p.qs) for _ in range(2)))
    ids = [int(t) for t in rng.integers(0, T, Bt)]
    ids[:3] = [0, 1, 2]
    batch = keys.batch(ids)
    c = mr.tensor_intt(p.n, p.qs, ct_a, ct_b, "mxu")
    before = launch.LAUNCHES_BY_SHAPE.get(("digit_relin_tenants", Bt, 8, T, p.n), 0)
    out = mr.digit_relin(p.n, p.qs, *c, *keys.hints, "mxu", batch.index)
    assert launch.LAUNCHES_BY_SHAPE[("digit_relin_tenants", Bt, 8, T, p.n)] == before + 1
    plain = mr.digit_relin_plain(p.n, p.qs, *c, *keys.hints, "mxu", batch.index)
    assert torch.equal(out, plain)
    for t in range(T):
        rows = [r for r, u in enumerate(ids) if u == t]
        hb, ha = (tuple(x[t] for x in pair) for pair in keys.hints)
        one = mr.digit_relin(p.n, p.qs, *(x[rows].contiguous() for x in c), hb, ha, "mxu")
        assert torch.equal(out[rows], one), t


#: a process that launches kernel B's tenant form over 2 tenants at n = 2^15
#: on 2 rows, first with the index in range and then with sys.argv[1] as the
#: second row's tenant, synchronizing after each
_OUT_OF_RANGE = """
import sys, torch
from alchemy_tpu_torch.backend.cuda import mul_relin as mr
from alchemy_tpu_torch.she import fast
p = fast.FastParams.make(15, 2)
z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device="cuda")
c = [z(2, 2, p.n) for _ in range(3)]
hints = [(z(2, 2, 2, p.n), z(2, 2, 2, p.n)) for _ in range(2)]
for second in (1, int(sys.argv[1])):
    index = torch.tensor([0, second], dtype=torch.int32, device="cuda")
    mr.digit_relin(p.n, p.qs, *c, *hints, "mxu", index)
    torch.cuda.synchronize()
    print("ran", second, flush=True)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [2, -1])
def test_tenant_index_out_of_range_stops_the_kernel(bad):
    """An index of T or a negative one (which `TenantKeys.batch` refuses,
    but a caller's own index tensor may hold) traps in the kernel, a CUDA
    error at the next synchronize, in place of reading past the tables. It
    runs in a process of its own: the error leaves that process's CUDA
    context unusable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = Path(__file__).resolve().parents[1]
    got = subprocess.run([sys.executable, "-c", _OUT_OF_RANGE, str(bad)], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert got.stdout.split("\n")[0] == "ran 1", got.stderr[-2000:]
    assert f"ran {bad}" not in got.stdout
    assert got.returncode != 0 and "CUDA error" in got.stderr, got.stderr[-2000:]
