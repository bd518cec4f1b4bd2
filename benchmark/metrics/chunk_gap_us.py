"""driver: the mean device idle time between one chunk's last device
operation and the next chunk's first, over the traced span's consecutive
chunks (the host's read of the poses, the next call's set-up and copies
in)."""


def read(ctx):
    tl = ctx.timeline
    if tl is None:
        return None
    per = [ops for ops in tl.chunk_ops() if ops]
    if len(per) < 2:
        return None
    gaps = [max(0.0, b[0][1] - max(e for _, _, e in a))
            for a, b in zip(per[:-1], per[1:])]
    return sum(gaps) / len(gaps)
