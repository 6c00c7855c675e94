"""The whole step's share of the card's memory bandwidth: chain-steps per
second x the bytes of one chain's state as the configuration's shapes fix
them (yardstick.state_bytes_per_chain) / 3.35 TB/s, in %. It bounds any
kernel's share, whichever kernels a later program runs."""
from perfbench.yardstick import PEAK_BYTES_PER_S, state_bytes_per_chain


def read(ctx):
    values = ctx.arrays["values"]
    N, F, S = values.shape
    K = int(ctx.config["model"]["clusters"])
    n_groups = 1 + ctx.arrays["families"].shape[0]
    C = 1 + len(ctx.config["model"]["confounders"])
    per_chain = state_bytes_per_chain(K, N, F, S, C, n_groups)
    return 100.0 * ctx.chains * ctx.steps / ctx.window_s * per_chain / PEAK_BYTES_PER_S
