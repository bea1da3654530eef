"""The compiled HomomRLWR program (five ring tunnels and the depth-5
rescale tree, a chain that shrinks from 6 limbs to 1; its argument is a
5-limb chain, padded to 6 on the 'limb' axis) through the port's
`jit_compile(..., mesh=)` on 8 gloo ranks on the CPU, mesh ('limb' 2,
'coeff' 4): the counterpart of tests/test_jit_exec.py:146-183. Each rank's
blocks equal the blocks of the single-device result, the gathered result
decrypts to the plaintext ring rounding, collectives ran, and each rank
holds under half of the single-device bytes of arguments and hints
(tolerance 0). Its own file, so that xdist runs it beside the other mesh
cases (test_torch_jit_mesh.py)."""

import torch_rank_cases as R
from alchemy_tpu_torch.parallel.multihost import LocalWorld
from test_torch_jit_mesh import CALL_S, MESH, check_partition


def test_sharded_homomrlwr_matches_single_device():
    with LocalWorld(MESH[0] * MESH[1], backend="gloo", timeout=CALL_S) as world:
        ranks, whole = world.run(R.jit_mesh, "HomomRLWR", MESH)[0]
    check_partition(ranks)
    assert ranks[0]["meta"][3] == (1543651201,) and whole[0].shape == (1, 8640)
    # the 5-limb argument: 3 rows a rank and a quarter of the coefficients
    assert all(r["bytes"]["args"] * 20 == r["single_bytes"]["args"] * 3 for r in ranks)
    # the rescale tree's limb-crossing steps: every one gathered over 'limb'
    assert all(r["comm_ops"]["rescale_step"] > 0 and r["comm_ops"]["modswitch_up"] > 0
               for r in ranks)
