"""PyTorch port: tiled full SLAM with optimizer="schur_sharded" on a
world of 4 gloo ranks on the CPU, against the JAX package's run with the
same optimizer on a 4-device mesh (4 blocks both), held as
tests/test_torch_sharded_tiled_slam.py holds 2 ranks: the same keyframes
and loops, keyframe poses and the trajectory within 5e-3 m / rad, chi2
within 0.1%, every rank the same result.
"""

import torch

from test_torch_sharded_tiled_slam import held, jax_ref, port_run

torch.set_num_threads(1)


def test_schur_sharded_tiled_full_slam_4_ranks_matches_jax():
    ref = jax_ref(4)
    res = port_run(4)
    held(res[0], ref, res[1:])
