"""Device operations (kernels, copies, fills) per step in the profiled
window of single, unsynchronised steps."""


def read(ctx):
    if ctx.profile is None or not ctx.profile.device:
        return None
    return len(ctx.profile.device) / ctx.profile.steps
