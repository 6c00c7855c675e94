"""The share of the run's MH steps that the program replayed from a CUDA
graph, in %: ``record.replayed / record.steps`` of
``sbayes_tpu_torch/sampling/graphs.py``, the program's own count of the
steps of ``run_ops`` over the whole run (set-up, window and traced part).
None where the program keeps no such record."""


def read(ctx):
    try:
        from sbayes_tpu_torch.sampling import graphs
    except ImportError:
        return None
    record = getattr(graphs, "record", None)
    if record is None or not record.steps:
        return None
    return 100.0 * record.replayed / record.steps
