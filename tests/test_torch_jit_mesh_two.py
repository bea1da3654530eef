"""The port's whole compiled program across a process boundary: the
counterpart of tests/multihost_worker2.py's first half (:40-79,
tests/test_multihost.py:47). Two gloo rank processes on the CPU run
Arithmetic through `jit_compile(..., mesh=)` with the 'coeff' axis across
them, then Tunnel (its 1-limb hint chains padded) with the 'limb' axis
across them: each rank's blocks equal the single-device result's, the gathered
result decrypts to the plaintext, and collectives ran (tolerance 0)."""

import pytest

import torch_rank_cases as R
from alchemy_tpu_torch.parallel.multihost import LocalWorld
from test_torch_jit_mesh import CALL_S


@pytest.fixture(scope="module")
def world():
    with LocalWorld(2, backend="gloo", timeout=CALL_S) as w:
        yield w


@pytest.mark.parametrize("name,shape,axis", [("Arithmetic", (1, 2), "coeff"),
                                             ("Tunnel", (2, 1), "limb")])
def test_whole_program_across_two_processes(world, name, shape, axis):
    ranks, _ = world.run(R.jit_mesh, name, shape)[0]
    for r in ranks:
        assert r["blocks_equal"] and r["whole_equal"] and r["decrypts"], r
        assert {a for _, a in r["collectives"]} == {axis}, r["collectives"]
