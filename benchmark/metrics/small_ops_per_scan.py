"""step: device kernels a scan that are neither the port's hand kernels
(csrc/) nor cuBLAS's: PyTorch's small ops."""

from benchmark.layers import per_scan


def read(ctx):
    if ctx.timeline is None:
        return None
    return per_scan(ctx, len(ctx.timeline.kernels("small")))
