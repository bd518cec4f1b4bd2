"""driver: host time of `session.init`, a fresh state built at a session's
start; the median over the unprofiled sessions after the first."""

from benchmark import spans


def read(ctx):
    cs = spans.calls()
    if cs is None:
        return None
    return spans.median([c.init_ns() / 1e3 for c in cs
                         if c.named("session.init")])
