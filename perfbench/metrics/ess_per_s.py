"""Multichain ESS of the window's (chains x steps) log-posterior trace per
second of the window (cells whose window returns a trace)."""
from perfbench.yardstick import multichain_ess


def read(ctx):
    if ctx.trace is None:
        return None
    return multichain_ess(ctx.trace) / ctx.window_s
