"""Feature tiles walked per MH step of the profiled chunk:
``profiled.tile_passes / profiled.steps`` of ``sbayes_tpu_torch/
tracing.py``, the program's count (``model/math.py::tile_passes``, a
replayed CUDA graph counting its capture's passes) over the steps that
``run_ops`` ran while the profiler recorded. None where the program keeps
no such record, or recorded no step."""


def read(ctx):
    try:
        from sbayes_tpu_torch import tracing
    except ImportError:
        return None
    record = getattr(tracing, "profiled", None)
    if record is None or not record.steps:
        return None
    return record.tile_passes / record.steps
