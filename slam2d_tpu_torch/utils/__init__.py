from slam2d_tpu_torch.utils.profiling import PhaseTimer  # noqa: F401
