"""device: the share of the device span of the unprofiled calls (from
each run of consecutive calls' first mark to its last) in which the
program left the card waiting, in percent: the hand-offs between calls,
sessions' starts included, and each replay's wait for its graph's
submission."""

from benchmark import spans


def read(ctx):
    cs = spans.calls()
    if cs is None:
        return None
    span = sum(run[-1].last - run[0].first for run in spans.runs(cs))
    if span <= 0:
        return None
    idle = sum(spans.handoffs(cs, same_session=False)) + sum(
        head - copied for c in cs for _, copied, head, _ in c.replays())
    return 100.0 * idle / span
