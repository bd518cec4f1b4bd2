"""PF refine: the device time a scan of the shared refine's float32
product (cuBLAS's kernels, the step's only library GEMM), in
microseconds."""

from benchmark.layers import device_s, per_scan


def read(ctx):
    if ctx.timeline is None:
        return None
    ops = ctx.timeline.kernels("blas")
    if not ops:
        return None
    return per_scan(ctx, device_s(ops) * 1e6)
