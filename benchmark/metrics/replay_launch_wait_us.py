"""driver: the device's wait for a chunk graph's submission, from the
program's marks (`copied`, after the inputs' copies, to the `head` mark
the graph records at its start); the median over the unprofiled replays
after the first session."""

from benchmark import spans


def read(ctx):
    cs = spans.calls()
    if cs is None:
        return None
    return spans.median([head - copied for c in cs
                         for _, copied, head, _ in c.replays()])
