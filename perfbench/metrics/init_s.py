"""Host clock around ``SamplerRuntime.init_chains`` and a synchronisation:
the initializer's share of the set-up."""


def read(ctx):
    return ctx.init_s
