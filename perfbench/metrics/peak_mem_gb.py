"""torch.cuda.max_memory_allocated() over the whole run, set-up included
(read before the reference runs), in GB (1e9 bytes)."""


def read(ctx):
    return ctx.memory_peak_bytes / 1e9
