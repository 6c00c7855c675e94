"""Seconds from the start of the process to the first step of the window:
imports, data, model, init, every operator once, warm-up."""


def read(ctx):
    return ctx.setup_s
