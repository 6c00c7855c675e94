"""Host seconds of the initializer's EM in the run's ``init_chains``: the
annealed EM over the clusters and every confounder group, and its
discretization, synchronised at its end (``record.em_s`` of
``sbayes_tpu_torch/sampling/initializer.py``). None where the program
keeps no such record."""


def read(ctx):
    from sbayes_tpu_torch.sampling import initializer

    record = getattr(initializer, "record", None)
    return None if record is None else record.em_s
