"""driver: the device's idle time between one call's last mark (`cloned`)
and the next call's first (`load`), over consecutive unprofiled calls of
one session after the first session; the median. It holds the host's
read of the poses, the next call's staging and, on the chunks the check
keeps, the harness's copies of the state."""

from benchmark import spans


def read(ctx):
    cs = spans.calls()
    if cs is None:
        return None
    return spans.median(spans.handoffs(cs))
