"""Chain-steps completed in the window per second of it (all rungs of a
ladder): chains x steps / window seconds, the last chunk included."""


def read(ctx):
    return ctx.chains * ctx.steps / ctx.window_s
