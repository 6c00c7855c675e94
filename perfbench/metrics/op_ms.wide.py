"""Mean host-clock ms of one synchronised step of the wide operator
(``gibbsish_sample_cluster_wide_geo``) over the run's timed single steps."""


def read(ctx):
    return ctx.op_ms.get("gibbsish_sample_cluster_wide_geo")
