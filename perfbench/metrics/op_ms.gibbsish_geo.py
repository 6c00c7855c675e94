"""Mean host-clock ms of one synchronised step of ``cluster_gibbsish_geo``,
the most drawn cluster operator (under a cost-based geo prior with the
geo prior's update, the batched Prim)."""


def read(ctx):
    return ctx.op_ms.get("cluster_gibbsish_geo")
