"""alchemy_tpu_torch.interp.jit_exec.jit_compile(..., mesh=) on 8 gloo ranks
on the CPU, mesh ('limb' 2, 'coeff' 4): the counterparts of
tests/test_jit_exec.py's sharded cases (:81-199). For Arithmetic and
Tunnel (whose 1-limb hint chains are padded to 2 on the 'limb' axis; the
5-limb argument of HomomRLWR is padded to 6 in
test_torch_jit_mesh_homomrlwr.py): each rank's blocks of
the result equal the blocks of the port's single-device `jit_compile`
result, the gathered result decrypts to the plaintext, collectives ran,
and each rank holds under half of the single-device bytes of arguments and
hints. Also: the noise-probe log equals the single-device log, a program of
additions runs with no collective, `_auto_sharding` places and warns as
the JAX package's does, each method of `ShardedTorchBackend` equals
`TorchBackend` and communicates over the axis it must, and the sharded
Arithmetic result equals the JAX package's on its 8-device CPU mesh
(tests/conftest.py), bit for bit (tolerance 0 throughout). The ranks run
tests/torch_rank_cases.py; HomomRLWR has its own file
(test_torch_jit_mesh_homomrlwr.py)."""

import numpy as np
import pytest

import torch_rank_cases as R
from alchemy_tpu_torch.parallel.multihost import LocalWorld

MESH = (2, 4)
#: a hang or a dead rank fails the case instead of running out the clock
CALL_S = 240
_RUNS: dict = {}


@pytest.fixture(scope="module")
def world():
    with LocalWorld(MESH[0] * MESH[1], backend="gloo", timeout=CALL_S) as w:
        yield w


def jax_mesh():
    """The JAX package's ('limb' 2, 'coeff' 4) mesh on its 8 CPU devices
    (tests/test_jit_exec.py `_mesh_2d`)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:8]).reshape(MESH), ("limb", "coeff"))


def run(world, name, probe=False):
    """jit_mesh on every rank, once per (name, probe) in this module."""
    if (name, probe) not in _RUNS:
        _RUNS[name, probe] = world.run(R.jit_mesh, name, MESH, probe)[0]
    return _RUNS[name, probe]


def check_partition(ranks):
    for r in ranks:
        assert r["blocks_equal"] and r["whole_equal"] and r["decrypts"] and r["logs_equal"], r
        assert sum(r["collectives"].values()) > 0, r["collectives"]
        held, single = r["bytes"], r["single_bytes"]
        assert held["args"] + held["hints"] < (single["args"] + single["hints"]) / 2, r


@pytest.mark.parametrize("name", ["Arithmetic", "Tunnel"])
def test_sharded_program_matches_single_device(world, name):
    ranks, _ = run(world, name)
    check_partition(ranks)
    assert all(r["meta"] == ranks[0]["meta"] for r in ranks)


def test_tunnel_hint_chains_of_one_are_padded_to_the_limb_axis(world):
    """Tunnel's hints are 1-limb chains: one row a rank (the second block
    is padding) and a quarter of the coefficients, so a quarter of the
    single-device hint bytes; its 2-limb argument splits, an eighth."""
    ranks, _ = run(world, "Tunnel")
    for r in ranks:
        assert r["bytes"]["hints"] * 4 == r["single_bytes"]["hints"]
        assert r["bytes"]["args"] * 8 == r["single_bytes"]["args"]


def test_noise_probe_log_matches_single_device(world):
    ranks, _ = run(world, "Arithmetic", probe=True)
    check_partition(ranks)


def test_additions_only_run_without_collectives(world):
    ranks, _ = run(world, "addOnly")
    for r in ranks:
        assert r["blocks_equal"] and r["whole_equal"] and r["decrypts"]
        assert r["collectives"] == {}, r["collectives"]


@pytest.mark.parametrize("shape", [(5, 64), (4, 66)])
def test_sharding_fallback_warns_like_jax(world, shape):
    """tests/test_jit_exec.py:186-199: a chain of 5 on 'limb' 2 and 66
    coefficients on 'coeff' 4 are replicated with a ShardingFallbackWarning;
    the placements spell the JAX PartitionSpec."""
    import jax.numpy as jnp

    from alchemy_tpu.interp.jit_exec import ShardingFallbackWarning as JWarn
    from alchemy_tpu.interp.jit_exec import _auto_sharding as jauto

    with pytest.warns(JWarn):
        spec = jauto(jnp.zeros(shape, jnp.uint32), jax_mesh()).spec
    names, warned = world.run(R.sharding_fallback, shape, MESH)[0]
    want = ["Shard(dim=0)" if spec[0] == "limb" else "Replicate()",
            "Shard(dim=1)" if spec[1] == "coeff" else "Replicate()"]
    assert names == want
    assert warned == ["ShardingFallbackWarning"]


@pytest.fixture(scope="module")
def ops(world):
    return world.run(R.spmd_ops, MESH, 3)[0]


LOCAL = ["add", "sub", "neg", "scalar_mul", "sum_terms", "zeros", "broadcast_row",
         "reduce_signed", "to_crt_odd_ring"]
COEFF = ["to_crt", "crt_mul", "embed", "twace", "rel_coeffs_dec", "from_rel_coeffs",
         "batched_to_basis", "batched_embed_crt"]
LIMB = ["trivgad_digits", "basebgad_digits", "hybridgad_digits", "rescale_6_to_5",
        "rescale_5_to_4", "modswitch_3_to_5"]


@pytest.mark.parametrize("op", LOCAL + COEFF + LIMB + ["lift_centered"])
def test_backend_op_matches_torch_backend(ops, op):
    """Each op of ShardedTorchBackend, through the Cyc/SHE code that calls
    it, equals TorchBackend("cpu") on every rank; elementwise ops (and a
    ring whose coefficients do not split) make no collective, transforms
    only 'coeff' ones, limb-crossing ops only 'limb' ones."""
    same, calls = ops[op]
    assert same
    axes = {axis for _, axis in calls}
    if op in LOCAL:
        assert calls == {}
    elif op in COEFF:
        assert axes == {"coeff"}
    elif op in LIMB:
        assert axes == {"limb"}
    else:
        assert axes == {"limb", "coeff"}


def test_sharded_arithmetic_matches_the_jax_mesh(world, monkeypatch):
    """The JAX package's Arithmetic, compiled with its mesh ('limb' 2,
    'coeff' 4) on the 8 virtual CPU devices, and the port's gathered
    result on 8 ranks: the same residues in the same bases."""
    monkeypatch.setenv("ALCHEMY_AOT_CACHE", "0")
    from alchemy_tpu.backend import xla_backend
    from alchemy_tpu.core.cyc import Cyc
    from alchemy_tpu.examples.arithmetic import M, M_MAP, PT, ZP, ZQS, addMul
    from alchemy_tpu.interp.jit_exec import jit_compile
    from alchemy_tpu.interp.keys_hints import KeysHints
    from alchemy_tpu.interp.pt2ct import pt2ct
    from alchemy_tpu.nt.factor import totient
    from alchemy_tpu.she.gadget import TrivGad

    bk = xla_backend()
    rng = np.random.default_rng(4)
    pts = [Cyc.from_coeffs(M, (ZP,), rng.integers(0, ZP, totient(M)), bk) for _ in range(2)]
    compiled = pt2ct(addMul, res_ty=PT, m_map=M_MAP, zqs=ZQS, gad=TrivGad(),
                     ctx=KeysHints(3.0, seed=4, bk=bk))
    args = [compiled.encrypt_arg(pt, i) for i, pt in enumerate(pts)]
    ref = jit_compile(compiled, args, mesh=jax_mesh())(*args)
    ranks, whole = run(world, "Arithmetic")
    m, zp, scale, qs, bases = ranks[0]["meta"]
    assert (m, zp, scale, qs) == (ref.m, ref.zp, ref.scale, ref.qs)
    assert bases == [c.basis for c in ref.comps]
    for got, c in zip(whole, ref.comps):
        assert np.array_equal(got, np.asarray(c.data).astype(np.int64))
