"""Multichain ESS of the window's log-posterior trace per 1000 steps: the
mixing of the schedule, apart from the speed of a step."""
from perfbench.yardstick import multichain_ess


def read(ctx):
    if ctx.trace is None:
        return None
    return multichain_ess(ctx.trace) / (ctx.steps / 1000.0)
