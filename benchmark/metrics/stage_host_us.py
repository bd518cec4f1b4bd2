"""driver: host time from an entry call's start to the start of its first
graph replay (the log staged, the output buffer, the state's load and
the inputs' copies enqueued), `session.init` left out; the median over
the unprofiled calls after the first session."""

from benchmark import spans


def read(ctx):
    cs = spans.calls()
    if cs is None:
        return None
    out = []
    for c in cs:
        heads = [s["marks"]["head"][0] for s in c.named("chunk.replay")
                 if "head" in s["marks"]]
        if heads:
            out.append((min(heads) - c.root["start_ns"] - c.init_ns()) / 1e3)
    return spans.median(out)
