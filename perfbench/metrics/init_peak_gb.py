"""torch.cuda.max_memory_allocated() at the end of the run's
``init_chains``, in GB (1e9 bytes): the peak of data, model and init,
counted by the program (``record.peak_bytes`` of
``sbayes_tpu_torch/sampling/initializer.py``, read without a reset). None
where the program keeps no such record."""


def read(ctx):
    from sbayes_tpu_torch.sampling import initializer

    record = getattr(initializer, "record", None)
    if record is None or record.peak_bytes is None:
        return None
    return record.peak_bytes / 1e9
