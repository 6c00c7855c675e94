"""Effect-table megabytes (10^6 bytes) the marginal kernel staged into
shared memory per MH step of the profiled chunk:
``profiled.marginal_staged_bytes / profiled.steps`` of
``sbayes_tpu_torch/tracing.py``, the program's count
(``ops/marginal.py::staged_bytes``, reckoned on the host from the kernel's
object layout, a replayed CUDA graph counting its capture's bytes) over
the steps that ``run_ops`` ran while the profiler recorded. None where the
program keeps no such count, or recorded no step."""


def read(ctx):
    try:
        from sbayes_tpu_torch import tracing
    except ImportError:
        return None
    record = getattr(tracing, "profiled", None)
    staged = getattr(record, "marginal_staged_bytes", None)
    if staged is None or not record.steps:
        return None
    return staged / record.steps / 1e6
