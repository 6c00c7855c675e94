"""CUDA graphs of the MH step: each operator's step captured once, then replayed.

On the card, ``SamplerRuntime.run_ops`` steps a batch through
``StepGraphs``: one CUDA graph per operator holds the operator's whole MH
step (``kernel.mh_step``: the proposal, the acceptance and the statistics),
so that a step is one graph launch in place of some 470 kernel launches
from Python, each of which costs the host more than the card spends on it.
The graphs engage where the code sees that they can: the runtime's device
is CUDA, its objects are not split (a grid row's blocks run on streams of
their own) and the operator reads nothing from the host
(``OperatorSpec.graphable``: not the wide operator, whose redraw loop reads
the card). Everything else, the CPU included, takes the eager step; both
run the same operator code.

A graph reads and writes fixed addresses. One set of buffers a (runtime,
generator, layout of the batch, kind of temperatures) holds the chain
state, the ``OperatorStats`` and, on a ladder, the temperatures and their
inverses (``Conditionals.load_temperatures``). Each graph copies its new
state and statistics back into the set before it ends, so replays follow
one another with no copy on the host; an eager step reads the set, and its
result is copied in before the next replay. ``run_ops`` copies a chunk's
state in once and returns clones of what the set holds, once a chunk.

An operator's first use in a set warms its step up on copies of the state,
with a generator of its own (the lazy set-up of PyTorch and of the kernels
happens there, outside a capture), then captures the step and replays it.
The chains' generator is registered with each graph, so that each replay
advances its Philox offset as the eager step does: the chains are
bit-equal to the eager path's. The graphs of a set share one memory pool
and keep nothing of their captures alive but the buffers. A capture's
kernel launches are taken back out of the launch counters
(``ops/check.py::COUNTERS``) and added again at each replay.

``record`` counts the MH steps that ``run_ops`` ran in this process, those
replayed from a graph and the graphs captured (read by
``perfbench/metrics/graph_step_share.py``). A replay runs in the span
``sbt.graph``, a sweep operator's also in ``sbt.sweep``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sbayes_tpu_torch.ops.check import COUNTERS
from sbayes_tpu_torch.sampling.kernel import OperatorStats, mh_step
from sbayes_tpu_torch.sampling.state import ChainState
from sbayes_tpu_torch.tracing import span


@dataclasses.dataclass
class GraphRecord:
    """The MH steps of ``SamplerRuntime.run_ops`` in this process
    (``steps``), of them those replayed from a CUDA graph (``replayed``),
    and the graphs captured (``captures``)."""

    steps: int = 0
    replayed: int = 0
    captures: int = 0


record = GraphRecord()


def _layout(tensors) -> tuple:
    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device) for t in tensors)


def _storages(tensors) -> set:
    return {t.untyped_storage().data_ptr() for t in tensors if t is not None}


def _copy_into(dsts, srcs):
    """Each of ``srcs`` into its buffer of ``dsts`` (the buffer itself: left
    as it is); a source that shares memory with any buffer is cloned
    before the first copy."""
    pairs = [(d, s) for d, s in zip(dsts, srcs) if d is not None and s is not d]
    if pairs:
        held = _storages(dsts)
        pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in held else s)
                 for d, s in pairs]
        for d, s in pairs:
            d.copy_(s)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    launches: list          # [(counter, {variant: launches})] of one replay


class StepGraphs:
    """The step graphs of one ``SamplerRuntime`` for one batch: its buffers,
    one graph per operator used so far, and the schedule's MH step over the
    buffers (at unit temperatures the runtime's own)."""

    def __init__(self, rt, gen, states: ChainState, stats: OperatorStats, temps, prior_temps):
        self.gen = gen
        self.layout = _layout((*states, *stats, temps, prior_temps))
        self.device = states.clusters.device
        self.state = ChainState(*(None if x is None else torch.empty_like(x) for x in states))
        self.stats = OperatorStats(*(torch.empty_like(x) for x in stats))
        self.cond = None
        if temps is not None or prior_temps is not None:
            self.cond = type(rt.cond)(rt.post, *(
                1.0 if t is None else torch.empty(t.shape, device=self.device)
                for t in (temps, prior_temps)))
        self.apply = rt.apply_fn(cond=self.cond)
        self.graphable = [spec.graphable for spec in rt._op_specs]
        self.sweep_spans = ["sbt.sweep" if spec.sweep else None for spec in rt._op_specs]
        self.graphs: dict = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.warm_gen = torch.Generator(device=self.device)

    def fits(self, gen, states, stats, temps, prior_temps) -> bool:
        return gen is self.gen and self.layout == _layout((*states, *stats, temps, prior_temps))

    def load_temperatures(self, temps, prior_temps):
        if self.cond is not None:
            self.cond.load_temperatures(temps, prior_temps)

    def step(self, op_idx: int, states: ChainState, stats: OperatorStats) -> tuple:
        """One MH step of ``op_idx``: replayed from its graph (captured at
        its first use), or, for an operator no graph replays, eager."""
        if not self.graphable[op_idx]:
            return mh_step(self.apply, self.gen, op_idx, states, stats)
        _copy_into((*self.state, *self.stats), (*states, *stats))
        graph = self.graphs.get(op_idx)
        if graph is None:
            graph = self.graphs[op_idx] = self._capture(op_idx)
        with span(self.sweep_spans[op_idx]), span("sbt.graph"), torch.cuda.device(self.device):
            graph.graph.replay()
            place = (self.device.index, torch.cuda.current_stream(self.device).cuda_stream)
        for counter, launched in graph.launches:
            for variant, n in launched.items():
                counter.add(variant, place, n)
        record.replayed += 1
        return self.state, self.stats

    def release(self, states: ChainState, stats: OperatorStats) -> tuple:
        """``states`` and ``stats`` with what the buffers hold cloned: what
        ``run_ops`` returns outlives the next replays."""
        held = _storages((*self.state, *self.stats))

        def own(x):
            return x.clone() if x is not None and x.untyped_storage().data_ptr() in held else x

        return ChainState(*map(own, states)), OperatorStats(*map(own, stats))

    def _capture(self, op_idx: int) -> _Graph:
        """Warm the step of ``op_idx`` up on copies of the buffers, then
        capture it into a graph that ends by copying its results into them.
        cuBLAS keeps a workspace for each stream it ran on: dropped before
        and after the capture, the capture's own is made in the graphs' pool,
        whose memory is scratch between replays, and the card never holds a
        second one beside the eager steps'."""
        mh_step(self.apply, self.warm_gen, op_idx,
                ChainState(*(None if x is None else x.clone() for x in self.state)),
                OperatorStats(*(x.clone() for x in self.stats)))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            graph.register_generator_state(self.gen)
        marks = [(c, c.state()) for c in COUNTERS]
        torch._C._cuda_clearCublasWorkspaces()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            state, stats = mh_step(self.apply, self.gen, op_idx, self.state, self.stats)
            _copy_into((*self.state, *self.stats), (*state, *stats))
        torch._C._cuda_clearCublasWorkspaces()
        launches = [(c, c.rewind(m)) for c, m in marks]
        record.captures += 1
        return _Graph(graph, [(c, n) for c, n in launches if n])
