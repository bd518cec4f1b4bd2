"""step: the device time a scan of PyTorch's small ops (the kernels that
are neither the port's hand kernels nor cuBLAS's), in microseconds."""

from benchmark.layers import device_s, per_scan


def read(ctx):
    if ctx.timeline is None:
        return None
    return per_scan(ctx, device_s(ctx.timeline.kernels("small")) * 1e6)
