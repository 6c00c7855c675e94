"""The marginal kernel's share of its roofline in the profiled window: the
sum over its launches of the least time the card could take (the larger of
bytes / 3.35 TB/s and operations / 67 TFLOP/s f32, counted by the
yardstick at the launch's variant, read from the kernel's name, and the
cell's chains) / the sum of their device times, in %."""
import numpy as np

from perfbench.tracing import marginal_variant
from perfbench.yardstick import (effect_cells_read, marginal_bytes, marginal_operations,
                                 roofline_s)


def read(ctx):
    if ctx.profile is None:
        return None
    launches = [(marginal_variant(e["name"]), float(e["dur"]) * 1e-6)
                for e in ctx.profile.kernels("marginal_kernel")]
    launches = [(v, t) for v, t in launches if v is not None]
    if not launches:
        return None
    values = ctx.arrays["values"]
    N, F, _ = values.shape
    fam = ctx.arrays["families"]
    group_of = np.stack([np.zeros(N, int), np.where(fam.any(0), fam.argmax(0), -1)])
    cells = effect_cells_read(values, group_of)
    C = 1 + len(ctx.config["model"]["confounders"])
    bound = sum(roofline_s(marginal_bytes(cells, N, F, C, ctx.chains, r, two, heat),
                           marginal_operations(N, F, C, ctx.chains, r, two, heat))
                for (r, heat, two), _ in launches)
    return 100.0 * bound / sum(t for _, t in launches)
