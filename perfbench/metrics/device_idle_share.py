"""Share of the profiled window in which no device operation ran: 1 - the
union of the kernels', copies' and fills' intervals / the window, in %."""


def read(ctx):
    if ctx.profile is None or not ctx.profile.device:
        return None
    return 100.0 * (1.0 - ctx.profile.busy_s / ctx.profile.window_s)
