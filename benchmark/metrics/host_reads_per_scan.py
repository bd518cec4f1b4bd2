"""driver: host reads a scan over the whole window, from the step's own
counter (frontend_step.host_syncs / fastslam_step.host_syncs) read before
and after the window."""


def read(ctx):
    if ctx.scans_window == 0:
        return None
    return ctx.window["host_reads"] / ctx.scans_window
