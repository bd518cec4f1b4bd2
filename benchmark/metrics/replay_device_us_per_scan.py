"""step: the chunk graph's own device time a scan, from the program's
marks (the `head` mark the graph records at its start to the `replayed`
mark after it), over the replay's scans; the median over the unprofiled
replays after the first session."""

from benchmark import spans


def read(ctx):
    cs = spans.calls()
    if cs is None:
        return None
    return spans.median([(done - head) / k for c in cs
                         for k, _, head, done in c.replays()])
