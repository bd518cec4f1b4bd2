from slam2d_tpu_torch.utils.profiling import PhaseTimer, Throughput  # noqa: F401
