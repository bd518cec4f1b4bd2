"""The program's configuration objects of a config file: the one place
the harness builds them (the systems' drivers call these)."""

from __future__ import annotations


def program_config(cfg: dict):
    """slam2d_tpu_torch's FrontendConfig of a config file's blocks."""
    from slam2d_tpu_torch.config import (
        FrontendConfig,
        GridConfig,
        MatcherConfig,
        SensorConfig,
    )
    return FrontendConfig(
        sensor=SensorConfig(**cfg["sensor"]), grid=GridConfig(**cfg["grid"]),
        matcher=MatcherConfig(**cfg["matcher"]), **cfg["frontend"])


def pf_config(cfg: dict):
    """slam2d_tpu_torch's PFConfig of a config file's `pf` block."""
    from slam2d_tpu_torch.config import PFConfig
    return PFConfig(**cfg["pf"])
