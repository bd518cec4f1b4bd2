"""slam2d_tpu_torch — the scan-matching frontend of slam2d_tpu in PyTorch,
with hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

The JAX package `slam2d_tpu` is the reference this package is tested
against; its layout is mirrored here (core/se2, grid/occupancy,
grid/window, match/correlative, run/frontend) so each module's
counterpart is easy to find. The configs are shared with the JAX package
(`slam2d_tpu.config` imports no JAX). Nothing in this package imports JAX.

Every function takes tensors and works on their device: a CUDA tensor
goes through the kernels in `slam2d_tpu_torch/csrc/` (built on first use
by `ops/_build.py`), a CPU tensor through each kernel's plain PyTorch
version in the same module.
"""

from slam2d_tpu.config import (  # noqa: F401
    FrontendConfig,
    GridConfig,
    MatcherConfig,
    SensorConfig,
)

__version__ = "0.1.0"
