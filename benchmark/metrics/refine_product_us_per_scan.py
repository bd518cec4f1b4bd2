"""PF refine: the device time a scan of the shared refine's bf16 product
(csrc/refine_product.cu: its mask pass, its slices' pass and its
reduction, matched by name), in microseconds; None where the program has
no such kernel."""

from benchmark.layers import device_s, per_scan


def read(ctx):
    if ctx.timeline is None:
        return None
    ops = ctx.timeline.named(r"::refine_product\w*_kernel\b")
    if not ops:
        return None
    return per_scan(ctx, device_s(ops) * 1e6)
