"""slam2d_tpu_torch — the scan-matching frontend (on a fixed grid and on
the tiled, unbounded world), localization on a fixed map with global
relocalization, FastSLAM, and full SLAM with loop closure and a pose
graph (dense or block-Schur) on a bounded grid and on the tiled world, of
slam2d_tpu in PyTorch, with hand-written CUDA kernels for the NVIDIA H100
(sm_90a).

The JAX package `slam2d_tpu` is the reference this package is tested
against; its layout is mirrored here (config, core/se2, data/synth,
graph/schur, graph/se2_graph, grid/occupancy, grid/tiles, grid/window,
match/correlative, match/global_loc, metrics, pf/fastslam,
pf/shared_refine, pf/shared_update, run/frontend, run/frontend_tiled,
run/fastslam_run, run/full_slam, run/full_slam_tiled) so
each module's counterpart is easy to find. This package imports nothing
of JAX and nothing of `slam2d_tpu`: it keeps its own copies of the
configs, the log simulator and the trajectory metrics.

Every function takes tensors and works on their device: a CUDA tensor
goes through the kernels in `slam2d_tpu_torch/csrc/` (built on first use
by `ops/_build.py`), a CPU tensor through each kernel's plain PyTorch
version in the same module. The entry points (`run_frontend`,
`run_frontend_offline`, `run_localization`, `frontend_init`,
`run_tiled_frontend`, `tiled_frontend_init`, `global_localize` given
numpy arrays, `run_fastslam`, `fastslam_init`, `run_full_slam`,
`run_full_slam_tiled`, `graph_init`) run on the card unless the caller
passes another device.
"""

from slam2d_tpu_torch.config import (  # noqa: F401
    FrontendConfig,
    GraphConfig,
    GridConfig,
    MatcherConfig,
    PFConfig,
    SensorConfig,
)

__version__ = "0.1.0"
