"""Named spans of the sampling loop, on the profiler's clock.

``span(name)`` opens ``torch.profiler.record_function(name)`` while a
``torch.profiler`` records, so that its events land in the profiler's
trace beside the kernels, on one clock; otherwise it returns one shared
no-op context. The check costs about 0.2 us and a ``record_function``
about 12 us on a CPU core, so a span never opens without a profiler.
Nothing else turns the spans on: run any entry point inside a
``torch.profiler.profile`` to see them.

The spans, and what reads them (``perfbench/metrics/<name>.py``):

- ``sbt.chunk``: each public chunk entry of ``SamplerRuntime``
  (``run_chunk``, ``run_ops``, ``run_mc3_chunk``; they nest, readers take
  the union): ``dispatch_ms_per_step``, ``idle_outside_program_share``.
- ``sbt.op/<operator name>``: one eager MH step of an operator
  (``sampling/kernel.py``), in ``run_ops``, ``op_steps`` and the warm-ups.
  They name the idle gaps of the benchmark's breakdown.
- ``sbt.graph``: one MH step replayed from its operator's CUDA graph
  (``sampling/graphs.py``), in ``run_ops`` on the card, where no
  ``sbt.op`` span opens. It names the idle gaps too; the share of the steps
  replayed is a counter (``graphs.record``): ``graph_step_share``.
- ``sbt.sweep``: one MH step of a source operator that runs the exact
  sequential sweep (``sampling/operators.py::op_rows_sweep``, F >= 512;
  ``OperatorSpec.sweep``), around its ``sbt.op`` span when eager and its
  ``sbt.graph`` span when replayed: ``sweep_ms_per_step`` (the device time
  of the kernels launched inside it, matched by correlation id).
- ``sbt.prim``: the batched Prim (``ops/mst.py``: ``cluster_mst_stats``,
  ``update_mst_stats``): on the card the kernel's launch, on the CPU the
  plain loop with its size read: ``prim_ms_per_step``.
- ``sbt.draw``: one source draw's inverse CDF (``ops/draw.py::onehot``): on
  the card the kernel's launch, on the CPU the plain version. No metric
  reads it yet.
- ``sbt.swap_phase``: one MC3 swap phase in ``sampling/runner.py::mc3_chunk``
  (the proposals, the read of the ladder's log-posterior parts, the phase,
  the permutation): ``swap_phase_ms``.
- ``sbt.init/em``, ``sbt.init/refine``: the initializer's EM with its
  discretization, and its source passes, ML cluster steps and best of
  attempts (``sampling/initializer.py``, which keeps the EM's seconds and
  the init's peak memory in ``record``: ``init_em_s``, ``init_peak_gb``).
- ``sbt.sync/<place>``: one host-device synchronisation on the sampling path,
  where the host waits for the card: ``host_syncs_per_step``,
  ``sync_wait_ms_per_step``; ``dispatch_ms_per_step`` leaves them out.

The places of ``sbt.sync/``, each around one read of the device:

- ``mst.size``: the batch's largest cluster, the loop length of the plain
  Prim (``ops/mst.py::_prim``, CPU tensors; the kernel reads nothing back).
- ``wide.redraw``: whether a chain of the wide operator still redraws.
- ``run_ops.trace``: the chunk's log-posterior trace to the host.
- ``mc3.temps``, ``mc3.prior_temps``: the ladder's temperatures to the host,
  once a ``run_mc3_chunk``.
- ``mc3.log_lh_prior``: the ladder's log-likelihoods and log-priors, once a
  swap phase.
- ``mc3.permute``: the rungs' new order to the device, once a swap phase
  that accepted a swap (``parallel/mesh.py::place_chains``; more where a
  split ladder moves chains between shards).
- ``geo.delaunay`` (``model/posterior.py``): the masks to the host and the
  triples back under the ``delaunay`` skeleton.

A copy from host memory to the card that is not pinned waits for the
card like a read does (PyTorch synchronises the stream after it), so
those copies are syncs too.

The program's count of kernel launches is ``ops/_cuda.py::LaunchCounter``;
``model/math.py::tile_passes``, one count for each feature tile a tiled
computation walks, is kept in the same way (a replayed CUDA graph counts
its capture's passes). ``profiled`` keeps the MH steps ``run_ops`` ran
while a profiler recorded and the tile passes they made:
``tile_passes_per_step``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

_OFF = contextlib.nullcontext()
recording = torch._C._autograd._profiler_enabled


def span(name: Optional[str]):
    """A context that records ``name`` as a span while a profiler records,
    else (and for a ``name`` of None) the shared no-op context."""
    return torch.profiler.record_function(name) if name is not None and recording() else _OFF


@dataclasses.dataclass
class ProfiledRecord:
    """The MH steps of ``SamplerRuntime.run_ops`` that ran while a profiler
    recorded (``steps``), and the feature tiles they walked
    (``tile_passes``, ``model/math.py::tile_passes``)."""

    steps: int = 0
    tile_passes: int = 0


profiled = ProfiledRecord()
