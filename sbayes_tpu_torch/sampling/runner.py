"""Host-level MCMC orchestration: warm-up, sampling loops, MC3, resume, logging.

Port of ``sbayes_tpu/sampling/runner.py``. All chains (the warm-up race, the
runs of an ensemble, the rungs of an MC3 ladder) are one chain axis of the
batched operators. One operator per step is drawn for the whole batch on the
host, from a CPU ``torch.Generator``, so dispatch never waits on the device;
the per-chain randomness comes from a generator on the model's device. On
the card ``run_ops`` replays each step from its operator's CUDA graph
(``sampling/graphs.py``), bit-equal to the eager step it holds. The
temperatures are Python floats at 1 (plain runs and ensembles) or (B,)
tensors, one per chain (MC3). The MC3 swap phase runs on the host, on the
ladder's carried log-likelihoods and log-priors (one device read per
phase), with its draws from the operator generator. The carried invariants
are recomputed exactly every ``REFRESH_EVERY_CHUNKS`` chunks. The STEP-TIME
column of the operator statistics comes from a per-operator timing probe,
run at start-up and at the run's midpoint. Resume reads the state pickle,
else the clusters and stats files with a source imputed by one Gibbs pass.
``run_chunk(..., trace=True)`` also returns the per-step log-posterior trace
(the input of ``results/ess.py``), and ``cluster_contribution`` scores each
cluster in isolation for the ``log_contribution_per_cluster`` columns.

The counterpart of the JAX package's ``shard_ensemble`` is
``ShardedRuntime``: wherever the JAX runner splits the chain axis over
devices (the warm-up races, the ensemble, the MC3 ladder, the timing probe,
the refresh), the port splits the batch over the mesh of
``parallel/mesh.py::auto_chain_mesh`` (``SamplerRuntime.shard``) and steps
shard 0 in the calling process and each other shard in a process of its
own (``parallel/processes.py``); the workers end with the run. Where there
is no mesh the batch is one shard, stepped by its ``SamplerRuntime``. The
MC3 chunk (``mc3_chunk``) and the timing probe (``time_op_steps``) are
written once, for a ``SamplerRuntime`` on its batch and for a
``ShardedRuntime`` on its shards.

``grid_runtime`` runs a chain batch on a chains x objects grid
(``parallel/mesh.py::data_mesh``): each chain shard is a local shard whose
``SamplerRuntime`` splits its objects (``SamplerRuntime.split_objects``);
the rows are stepped in turn from the calling thread, each row's object
blocks on CUDA streams of their own (``ObjectSplit.run``). As in the JAX
package, where the runner never reaches ``data_mesh``, neither the CLI nor
``auto_chain_mesh`` builds a grid; its states are initialised unsplit and
then split (``ShardedRuntime.split``), and it runs ``run_chunk`` and
``refresh`` (no MC3 ladder, no logging).
"""
from __future__ import annotations

import functools
import itertools
import math
import pickle
import time
import weakref
from datetime import timedelta
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sbayes_tpu_torch.data.loader import Data
from sbayes_tpu_torch.model.math import normalize_weights, sample_categorical_onehot, tile_passes
from sbayes_tpu_torch.model.model import Model
from sbayes_tpu_torch.model.posterior import ObjectSplitPosterior, Posterior
from sbayes_tpu_torch.ops import _cuda, marginal
from sbayes_tpu_torch.ops.check import launch_counts, reset_launches
from sbayes_tpu_torch.parallel.mesh import (
    ObjectSplit,
    ShardGenerators,
    auto_chain_mesh,
    canonical,
    chain_block,
    gather,
    give_chains,
    permute_chains,
    place_chains,
    replicate,
    shard_objects,
    shard_state,
    unshard_state,
)
from sbayes_tpu_torch.parallel.processes import GenRef, Remote, ShardProcesses
from sbayes_tpu_torch.results.loggers import (
    ClustersLogger,
    LikelihoodLogger,
    OperatorStatsLogger,
    OperatorView,
    ParametersCSVLogger,
    ResultsLogger,
    SampleRecord,
    StateDumper,
)
from sbayes_tpu_torch.sampling import graphs
from sbayes_tpu_torch.sampling.conditionals import Conditionals, ObjectSplitConditionals
from sbayes_tpu_torch.sampling.initializer import Initializer
from sbayes_tpu_torch.sampling.kernel import OperatorStats, make_mh_apply_fn, mh_step
from sbayes_tpu_torch.sampling.operators import get_operator_schedule
from sbayes_tpu_torch.sampling.state import ChainState
from sbayes_tpu_torch.tracing import profiled, recording, span

# Chunk cadence of the exact carried-invariant refresh in the sampling loops.
REFRESH_EVERY_CHUNKS = 64


def make_generators(seed: int, device) -> tuple[torch.Generator, torch.Generator]:
    """(per-chain generator on ``device``, CPU generator of the operator draws)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    op_gen = torch.Generator()
    op_gen.manual_seed(seed + 0x5BA135)
    return gen, op_gen


def _host(x):
    return x.detach().cpu().numpy()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def temperature_ladder(mc3) -> tuple[np.ndarray, np.ndarray]:
    """(likelihood, prior) temperatures of the MC3 rungs, the cold rung
    first: linear ``1 + diff * i`` or exponential ``(1 + diff) ** i``."""
    idx = np.arange(mc3.chains)
    if mc3.exponential_temperatures:
        return (1 + mc3.temperature_diff) ** idx, (1 + mc3.prior_temperature_diff) ** idx
    return 1 + mc3.temperature_diff * idx, 1 + mc3.prior_temperature_diff * idx


def swap_pairs(n_chains: int, only_adjacent: bool) -> np.ndarray:
    """(n_pairs, 2) rung pairs a < b that a swap may propose."""
    if only_adjacent:
        return np.array([(i, i + 1) for i in range(n_chains - 1)])
    return np.array([(i, j) for i in range(n_chains - 1) for j in range(i + 1, n_chains)])


def swap_phase(ll, lp, temps, prior_temps, pairs, order, log_u, swap_matrix):
    """One MC3 swap phase: the proposals ``pairs[order]`` in turn on the
    running (already swapped) log-likelihoods ``ll`` and log-priors ``lp``,
    each accepted when ``log_u[t]`` is below -((lp[a] - lp[b]) (1/Tp[a] -
    1/Tp[b]) + (ll[a] - ll[b]) (1/T[a] - 1/T[b])). Adds the accepts and the
    attempts of each pair to ``swap_matrix`` (2, n, n) in place. Returns
    (perm, ll, lp, n_accepted): rung r takes the state of chain ``perm[r]``."""
    perm = np.arange(len(ll))
    ll = np.array(ll, dtype=np.float64)
    lp = np.array(lp, dtype=np.float64)
    n_acc = 0
    for t, i_pair in enumerate(order):
        a, b = pairs[i_pair]
        prior_exp_diff = 1.0 / prior_temps[a] - 1.0 / prior_temps[b]
        lh_exp_diff = 1.0 / temps[a] - 1.0 / temps[b]
        mh = -((lp[a] - lp[b]) * prior_exp_diff + (ll[a] - ll[b]) * lh_exp_diff)
        accept = bool(log_u[t] < mh)
        if accept:
            for x in (perm, ll, lp):
                x[[a, b]] = x[[b, a]]
            n_acc += 1
        swap_matrix[0, a, b] += accept
        swap_matrix[1, a, b] += 1
    return perm, ll, lp, n_acc


def draw_swap_proposals(op_gen, n_pairs: int, attempts: int) -> tuple:
    """(order, log_u) of one swap phase: ``attempts`` distinct pairs in a
    random order and one log-uniform per proposal."""
    order = torch.randperm(n_pairs, generator=op_gen)[:attempts].numpy()
    log_u = torch.log(torch.rand(attempts, generator=op_gen, dtype=torch.float64)).numpy()
    return order, log_u


def mc3_chunk(rt, gen, op_gen, states, stats, temps, prior_temps, swap_matrix: np.ndarray,
              step0: int, n_steps: int, swap_interval: int, attempts: int, only_adjacent: bool):
    """``n_steps`` MH steps of an MC3 ladder (one chain per rung, per-chain
    temperatures) with a swap phase after every step whose global index
    ``step0 + i + 1`` is a multiple of ``swap_interval``, so that the
    cadence holds across chunks: one operator draw a segment; at each phase
    (``sbt.swap_phase``) one read of the log-likelihoods and log-priors,
    ``min(attempts, n_pairs)`` sequential proposals (``swap_phase``) and one
    permutation of the states; statistics and temperatures stay with the
    rung. ``swap_matrix`` (2, n, n) counts in place. ``rt``: a
    ``SamplerRuntime`` on its batch or a ``ShardedRuntime`` on its shards
    (``draw_ops``, ``run_ops``, ``values``, ``log_lh_prior``, ``permute``).
    Returns (states, stats, n_accepted, n_attempted)."""
    with span("sbt.sync/mc3.temps"):
        t_host = rt.values(temps).astype(np.float64)
    with span("sbt.sync/mc3.prior_temps"):
        tp_host = rt.values(prior_temps).astype(np.float64)
    pairs = swap_pairs(len(t_host), only_adjacent)
    attempts = min(attempts, len(pairs))
    n_acc = n_att = done = 0
    while done < n_steps:
        seg = min(swap_interval - (step0 + done) % swap_interval, n_steps - done)
        states, stats = rt.run_ops(gen, rt.draw_ops(op_gen, seg), states, stats, temps,
                                   prior_temps)
        done += seg
        if (step0 + done) % swap_interval:
            continue
        with span("sbt.swap_phase"):
            order, log_u = draw_swap_proposals(op_gen, len(pairs), attempts)
            with span("sbt.sync/mc3.log_lh_prior"):
                ll, lp = rt.log_lh_prior(states)
            perm, _, _, acc = swap_phase(ll, lp, t_host, tp_host, pairs, order, log_u,
                                         swap_matrix)
            if acc:
                states = rt.permute(states, perm)
        n_acc += acc
        n_att += attempts
    return states, stats, n_acc, n_att


def time_op_steps(rt, gen, states, temps=None, prior_temps=None,
                  n_steps: int = 20) -> np.ndarray:
    """Wall time [s] of one step of the whole batch for each operator: the
    operator alone on ``states`` at its temperatures, one warm-up step, then
    ``n_steps`` timed steps (synchronised). ``rt``: a ``SamplerRuntime`` on
    its batch or a ``ShardedRuntime`` on its shards (every shard at once),
    of which this takes ``n_ops``, ``op_steps`` and ``synchronize``."""
    times = np.zeros(rt.n_ops)
    for i_op in range(rt.n_ops):
        warm = rt.op_steps(gen, states, temps, prior_temps, i_op=i_op, n_steps=1)
        rt.synchronize()
        t0 = time.perf_counter()
        rt.op_steps(gen, warm, temps, prior_temps, i_op=i_op, n_steps=n_steps)
        rt.synchronize()
        times[i_op] = (time.perf_counter() - t0) / n_steps
    return times


class SamplerRuntime:
    """The batched sampling programs of one model."""

    def __init__(self, model: Model, mcmc_config, sample_from_prior: bool = False,
                 consts=None, split: Optional[ObjectSplit] = None):
        self.model = model
        self.split = split
        self.consts = (model.consts if consts is None else consts) if split is None else split.head
        self.device = self.consts.device
        self.mcmc_config = mcmc_config
        self.sample_from_prior = sample_from_prior
        self.p_grow = 0.5
        if split is None:
            self.cond = Conditionals(Posterior(self.consts, sample_from_prior), 1.0, 1.0)
        else:
            self.cond = ObjectSplitConditionals(ObjectSplitPosterior(split, sample_from_prior))
        self.post = self.cond.post
        self._op_specs = get_operator_schedule(self.cond, mcmc_config.operators, self.p_grow)
        self.op_names = [o.name for o in self._op_specs]
        self.n_ops = len(self.op_names)
        self.op_weights = torch.tensor([o.weight for o in self._op_specs], dtype=torch.float64)
        self._apply = make_mh_apply_fn(self.cond, self._op_specs)
        self._shards: dict = {}
        self._graphs: Optional[graphs.StepGraphs] = None
        self._eager = False        # tests only: the eager step on the card too

    def replica(self, consts) -> "SamplerRuntime":
        """The same sampler over ``consts`` (the model constants on another
        device)."""
        return SamplerRuntime(self.model, self.mcmc_config, self.sample_from_prior, consts)

    def split_objects(self, split: ObjectSplit) -> "SamplerRuntime":
        """The same sampler with its objects split as ``split`` splits them
        (a row of ``data_mesh``, ``parallel.mesh.shard_objects``): its states
        hold a ``SplitSource`` (``parallel.mesh.shard_state``)."""
        return SamplerRuntime(self.model, self.mcmc_config, self.sample_from_prior,
                              split=split)

    def split_mesh(self, n_chains: int):
        """The mesh a batch of ``n_chains`` splits over (``auto_chain_mesh``),
        or None. A model on a device with an index (``cuda:1``, a ``-t``
        worker's card) never splits: only a bare ``cuda`` (or ``cpu``) model
        takes the mesh."""
        if self.device.index is not None:
            return None
        return auto_chain_mesh(n_chains, device_type=self.device.type)

    def shard(self, n_chains: int, logger=None) -> "ShardedRuntime":
        """The runtime of a batch of ``n_chains`` split over ``split_mesh``,
        one worker process per shard but the first (kept until ``close``),
        or of the batch as one shard where it gives no mesh."""
        mesh = self.split_mesh(n_chains)
        if mesh is not None and logger is not None:
            logger.info(f"Splitting {n_chains} chains over {len(mesh)} shards "
                        f"({n_chains // len(mesh)} each, one process each) on "
                        f"{[str(d) for d in mesh]}.")
        if mesh not in self._shards:
            self._shards[mesh] = ShardedRuntime(self, mesh)
        return self._shards[mesh]

    def close(self):
        """End the worker processes of every split ``shard`` made, and free
        the step graphs."""
        for sh in self._shards.values():
            sh.close()
        self._shards.clear()
        self._graphs = None

    # -------------------- batched programs --------------------

    def new_stats(self, n_chains: int) -> OperatorStats:
        return OperatorStats.zeros(n_chains, self.n_ops, self.device)

    def apply_fn(self, temps=None, prior_temps=None, cond=None):
        """The MH step ``apply(op_idx, gen, states)`` of the schedule: at unit
        temperatures (None) or at the per-chain (B,) ``temps`` /
        ``prior_temps`` on the model's device, or over the conditionals
        ``cond``."""
        if cond is None:
            if temps is None and prior_temps is None:
                return self._apply
            cond = type(self.cond)(self.post, 1.0 if temps is None else temps,
                                   1.0 if prior_temps is None else prior_temps)
        return make_mh_apply_fn(cond, get_operator_schedule(cond, self.mcmc_config.operators,
                                                            self.p_grow))

    def init_chains(self, gen, n_chains: int) -> ChainState:
        """``n_chains`` initial states (best of the configured attempts each),
        with every carried invariant filled."""
        if self.split is not None:
            raise NotImplementedError("states of a chains x objects grid are initialised "
                                      "unsplit, then split (grid_runtime)")
        init_cfg = self.mcmc_config.initialization
        initializer = Initializer(
            self.cond, initial_size=init_cfg.objects_per_cluster, attempts=init_cfg.attempts,
            initial_cluster_steps=init_cfg.initial_cluster_steps, n_em_steps=init_cfg.em_steps,
            method=init_cfg.method)
        return self.post.fill_state(initializer.generate_sample(gen, n_chains))

    def run_chunk(self, gen, op_gen, states: ChainState, stats: OperatorStats, n_steps: int,
                  temps=None, prior_temps=None, trace: bool = False):
        """``n_steps`` MH steps of every chain; one operator per step. ``temps``
        / ``prior_temps``: None for unit temperatures, else (B,) tensors.
        Returns (states, stats), and with ``trace`` also the (n_steps, B)
        log-posterior ``log_lh + log_prior`` after each step as a numpy array:
        one launch per step into a tensor on the device, one read per chunk."""
        with span("sbt.chunk"):
            return self.run_ops(gen, self.draw_ops(op_gen, n_steps), states, stats, temps,
                                prior_temps, trace)

    def draw_ops(self, op_gen, n_steps: int) -> list:
        """The operator of each of ``n_steps`` steps, one draw for the batch."""
        return torch.multinomial(self.op_weights, n_steps, replacement=True,
                                 generator=op_gen).tolist()

    def run_ops(self, gen, ops: list, states: ChainState, stats: OperatorStats, temps=None,
                prior_temps=None, trace: bool = False):
        """``run_chunk`` on the drawn operators ``ops``, one a step; on the
        card each step replayed from its operator's CUDA graph where one can
        hold it (``sampling/graphs.py``). Steps run under a profiler are
        kept in ``tracing.profiled`` with the feature tiles they walked and
        the bytes the marginal staged."""
        with span("sbt.chunk"):
            passes, staged = tile_passes.count, marginal.staged_bytes.count
            step_graphs = self._step_graphs(gen, states, stats, temps, prior_temps)
            if step_graphs is None:
                step = functools.partial(mh_step, self.apply_fn(temps, prior_temps), gen)
            else:
                step = step_graphs.step
            log_post = (torch.empty((len(ops), states.n_chains), device=self.device) if trace
                        else None)
            for i, op_idx in enumerate(ops):
                states, stats = step(op_idx, states, stats)
                if trace:
                    torch.add(states.log_lh, states.log_prior, out=log_post[i])
            graphs.record.steps += len(ops)
            if recording():
                profiled.steps += len(ops)
                profiled.tile_passes += tile_passes.count - passes
                profiled.marginal_staged_bytes += marginal.staged_bytes.count - staged
            if step_graphs is not None:
                states, stats = step_graphs.release(states, stats)
            if trace:
                with span("sbt.sync/run_ops.trace"):
                    return states, stats, _host(log_post)
            return states, stats

    def _step_graphs(self, gen, states, stats, temps, prior_temps):
        """The step graphs of this batch, or None where the eager step runs:
        off the card, on a grid row (``split``) and under the tests' switch.
        One set at a time: a batch of another layout, generator or kind of
        temperatures replaces it."""
        if self.device.type != "cuda" or self.split is not None or self._eager:
            return None
        if self._graphs is None or not self._graphs.fits(gen, states, stats, temps,
                                                         prior_temps):
            self._graphs = None               # the old set's memory goes first
            self._graphs = graphs.StepGraphs(self, gen, states, stats, temps, prior_temps)
        self._graphs.load_temperatures(temps, prior_temps)
        return self._graphs

    def run_mc3_chunk(self, gen, op_gen, states: ChainState, stats: OperatorStats, temps,
                      prior_temps, swap_matrix: np.ndarray, step0: int, n_steps: int,
                      swap_interval: int, attempts: int, only_adjacent: bool):
        """``mc3_chunk`` of this batch, a ladder of one chain per rung at (B,)
        temperatures: (states, stats, n_accepted, n_attempted)."""
        with span("sbt.chunk"):
            return mc3_chunk(self, gen, op_gen, states, stats, temps, prior_temps, swap_matrix,
                             step0, n_steps, swap_interval, attempts, only_adjacent)

    def refresh(self, states: ChainState) -> ChainState:
        """Exact recompute of every carried invariant."""
        return self.post.fill_state(states)

    def op_steps(self, gen, states: ChainState, temps=None, prior_temps=None, *, i_op: int,
                 n_steps: int) -> ChainState:
        """``n_steps`` MH steps of the operator ``i_op`` alone (the timing
        probe, ``measure_op_step_times``)."""
        apply = self.apply_fn(temps, prior_temps)
        for _ in range(n_steps):
            states = apply(i_op, gen, states)[0]
        return states

    def records(self, states: ChainState, stats: OperatorStats, requests: list) -> list:
        """For each (chain k, ``make_record`` keywords) of ``requests``: (the
        record of chain k of ``states``, its (accepts, rejects,
        step_size_sum) of ``stats`` on the host)."""
        return [(self.make_record(states.select(slice(k, k + 1)), **kw),
                 tuple(_host(x[k]) for x in stats[:3])) for k, kw in requests]

    measure_op_step_times = time_op_steps

    def synchronize(self):
        _sync(self.device)

    def values(self, x) -> np.ndarray:
        """The (B,) tensor ``x`` on the host."""
        return _host(x)

    def log_lh_prior(self, states: ChainState) -> tuple:
        """(log_lh, log_prior) of the batch on the host: one read."""
        both = _host(torch.stack([states.log_lh, states.log_prior]))
        return both[0], both[1]

    def permute(self, states: ChainState, perm) -> ChainState:
        """The states after an MC3 swap: rung r takes chain ``perm[r]``
        (``parallel.mesh.permute_chains`` of one shard)."""
        return permute_chains([states], perm)[0]

    def sample_view(self, state: ChainState, with_likelihood: bool = True):
        """Posterior parts, counts and (optionally) the per-observation
        likelihood of a batch of states, as the loggers read them."""
        parts = self.post.parts(state)
        cl_counts, conf_counts = self.post.feature_counts(state.clusters, state.source)
        obs_lh = None
        if with_likelihood:
            lh_exact = self.cond.likelihood_per_component_exact(state.clusters, state.source)
            w = normalize_weights(state.weights, self.post.has_components(state.clusters))
            obs_lh = (w * lh_exact).sum(-1)
        return parts, cl_counts, conf_counts, obs_lh

    def cluster_contribution(self, states: ChainState) -> tuple:
        """(B, K) log-likelihood and (B, K) log-prior of each cluster in
        isolation: the source-marginalised mixture likelihood with
        posterior-mean effects when the other clusters are emptied, and the
        single-cluster size prior plus that cluster's geo prior plus the
        weights prior (the source prior needs a source and is left out)."""
        c = self.consts
        B, K, N = states.clusters.shape
        cl_counts, conf_counts = self.post.feature_counts(states.clusters, states.source)
        only = torch.eye(K, dtype=torch.bool, device=self.device)            # (K, K)
        clusters_i = (states.clusters[:, None] & only[None, :, :, None]).reshape(B * K, K, N)
        counts_i = (cl_counts[:, None] * only[None, :, :, None, None]).reshape(
            B * K, K, *cl_counts.shape[2:])
        lh_pc = self.cond.likelihood_per_component(clusters_i, counts_i,
                                                   conf_counts.repeat_interleave(K, 0))
        w = normalize_weights(states.weights.repeat_interleave(K, 0),
                              self.post.has_components(clusters_i))
        obs = (w * lh_pc).sum(-1)
        lh = torch.where(~c.na[None], torch.log(torch.clamp(obs, min=1e-35)),
                         torch.zeros((), device=self.device)).sum((-1, -2)).view(B, K)

        size = states.clusters.sum(-1).float()                                 # (B, K)
        if c.size_prior_type == "uniform_size":
            n = torch.tensor(float(c.N), device=self.device)
            size_prior = -(torch.lgamma(n + 1.0) - torch.lgamma(size + 1.0)
                           - torch.lgamma(n - size + 1.0))
        elif c.size_prior_type == "quadratic":
            size_prior = -torch.log(size ** 2)
        else:  # uniform_area
            size_prior = torch.zeros_like(size)
        prior = (size_prior + self.post.geo_prior_per_cluster(states.clusters)
                 + self.post.weights_prior(states.weights)[:, None])
        return lh, prior

    def make_record(self, state_c: ChainState, i_step: int, chain: int = 0,
                    with_likelihood: bool = True,
                    with_cluster_contribution: bool = False) -> SampleRecord:
        """The logged sample of ONE chain (``state_c``: a batch of one)."""
        parts, cl_counts, conf_counts, obs_lh = self.sample_view(state_c, with_likelihood)
        contrib_lh = contrib_prior = None
        if with_cluster_contribution:
            contrib_lh, contrib_prior = (_host(x[0]) for x in self.cluster_contribution(state_c))
        return SampleRecord(
            i_step=i_step,
            clusters=_host(state_c.clusters[0]),
            weights=_host(state_c.weights[0]),
            source=_host(state_c.source[0]),
            log_lh=float(parts.log_lh[0]),
            log_prior=float(parts.log_prior[0]),
            size_prior=float(parts.size_prior[0]),
            geo_prior=float(parts.geo_prior[0]),
            weights_prior=float(parts.weights_prior[0]),
            source_prior=float(parts.source_prior[0]),
            cluster_counts=_host(cl_counts[0]),
            conf_counts=_host(conf_counts[0]),
            observation_lh=_host(obs_lh[0]) if obs_lh is not None else None,
            cluster_contribution_lh=contrib_lh,
            cluster_contribution_prior=contrib_prior,
            chain=chain,
        )

    def warmup(self, gen, op_gen, n_chains: int, n_steps: int, logger=None) -> ChainState:
        """Warm-up race: run ``n_chains`` and keep the best by likelihood (a
        batch of one). ``gen``: a generator or the run's ``ShardGenerators``;
        the race is split over ``auto_chain_mesh``."""
        gens = ShardGenerators.of(gen)
        sh = self.shard(n_chains, logger)
        states = sh.init_chains(gens, n_chains)
        if n_steps > 0:
            states, _ = sh.run_chunk(gens, op_gen, states, sh.new_stats(n_chains), n_steps)
            states = sh.refresh(states)
        states = sh.gather(states)
        best = int(torch.argmax(states.log_lh))
        if logger:
            logger.info(
                f"Starting state taken from warmup chain {best} with log-likelihood "
                f"{float(states.log_lh[best]):.2f} (all chains: "
                f"{_host(states.log_lh).round(2).tolist()}).")
        return states.select(slice(best, best + 1))

    def warmup_ladder(self, gen, op_gen, n_chains: int, warmup_chains: int, temps, prior_temps,
                      n_steps: int, logger=None) -> ChainState:
        """Best-of-W warm-up race per MC3 rung: ``n_chains x W`` warm-ups as
        one batch, each at its rung's temperatures (``temps`` /
        ``prior_temps`` (n_chains,) repeated W times), an exact refresh, then
        per rung the warm-up with the highest log-likelihood. ``gen`` and the
        split as in ``warmup``."""
        W = max(1, int(warmup_chains))
        gens = ShardGenerators.of(gen)
        sh = self.shard(n_chains * W, logger)
        states = sh.init_chains(gens, n_chains * W)
        if n_steps > 0:
            states, _ = sh.run_chunk(gens, op_gen, states, sh.new_stats(n_chains * W), n_steps,
                                     sh.split(temps.repeat_interleave(W)),
                                     sh.split(prior_temps.repeat_interleave(W)))
            states = sh.refresh(states)
        states = sh.gather(states)
        ll = _host(states.log_lh).reshape(n_chains, W)
        sel = torch.as_tensor(ll.argmax(axis=1) + np.arange(n_chains) * W, device=self.device)
        if logger and W > 1:
            logger.info(f"MC3 warm-up: best of {W} per rung; selected log-likelihoods "
                        f"{ll.max(axis=1).round(2).tolist()}")
        return states.select(sel)


class ShardedRuntime:
    """A chain batch in shards over ``mesh`` (``parallel/mesh.py``), the
    counterpart of the JAX package's ``shard_ensemble``. A shard is local
    (a ``SamplerRuntime`` of this process, ``rts``) or held by a worker
    process (``parallel/processes.py``). The batch unsplit is one local
    shard, ``rt``; the chain split of ``SamplerRuntime.shard`` holds shard
    0 here on ``mesh[0]`` and shard j in a worker on ``mesh[j]``, so that no
    two shards share an interpreter lock; a grid (``grid_runtime``) is
    every row local. Every call sends each worker its command, steps the
    local shards one after another here, then collects the replies. The
    shards share one operator sequence, drawn here once a chunk, as the
    JAX program draws one operator per step for the whole batch; each
    draws from a per-chain generator of its own (``ShardGenerators``),
    which a worker keeps across calls. A worker's shard is a
    ``processes.Remote`` whose log-likelihoods and log-priors come with it,
    so an MC3 swap phase reads nothing more, and moves only the chains
    whose rung changed. The workers start at the first call (``start``)
    and end with ``close`` (``SamplerRuntime.close`` at the end of a run),
    at an error in any shard (raised here with the worker's traceback,
    once every process has stopped), when this object is collected, and at
    exit."""

    def __init__(self, rt: SamplerRuntime, mesh=None, rts=None):
        self.rt = rt
        if rts is None:
            self.mesh = tuple(canonical(d) for d in mesh) if mesh else (rt.device,)
            consts = replicate(rt.consts, self.mesh[:1])[0]
            rts = [rt if consts is rt.consts else rt.replica(consts)]
        else:
            self.mesh = tuple(canonical(r.device) for r in rts)
        self.rts = list(rts)
        self.n_shards = len(self.mesh)
        self.n_local = len(self.rts)
        self.n_ops, self.draw_ops = rt.n_ops, rt.draw_ops
        # the object split of each shard (grid_runtime), else None
        self.splits = [r.split for r in self.rts] if self.rts[0].split is not None else None
        self.processes: Optional[ShardProcesses] = None
        self._gen_keys = weakref.WeakKeyDictionary()
        self._next_gen_key = itertools.count()

    # -------------------- dispatch --------------------

    def start(self) -> Optional[ShardProcesses]:
        """The workers (None where every shard is local), spawned at the first
        call: the kernel library is built here first, so that the workers
        only load it."""
        if self.n_local == self.n_shards:
            return None
        if self.processes is None:
            if any(d.type == "cuda" for d in self.mesh):
                _cuda.build()
            self.processes = ShardProcesses(self.mesh, (self.rt.consts, self.rt.mcmc_config,
                                                        self.rt.sample_from_prior))
        if self.processes.closed:
            raise RuntimeError("the worker processes of this split have ended")
        return self.processes

    def close(self):
        if self.processes is not None:
            self.processes.close()

    def _dispatch(self, cmd: str, per_worker: list, local) -> list:
        """``cmd`` sent to the workers (worker i's arguments ``per_worker[i]``),
        ``local()`` run here meanwhile (if it raises, the workers are stopped
        first), then its results and the workers' replies in shard order."""
        procs = self.start()
        if procs is not None:
            procs.send(cmd, per_worker)
        try:
            out = local()
        except BaseException:
            self.close()
            raise
        return out + (procs.replies() if procs is not None else [])

    def _each(self, method: str, common: dict = None, **per_shard) -> list:
        """``<runtime of shard j>.<method>(**common, **{name: a[j] for each
        per_shard name a})`` for every shard j."""
        kws = [{**(common or {}), **{k: v[j] for k, v in per_shard.items()}}
               for j in range(self.n_shards)]
        return self._dispatch("call", [(method, kw) for kw in kws[self.n_local:]],
                              lambda: [getattr(r, method)(**kw) for r, kw in zip(self.rts, kws)])

    def _gens(self, gens: ShardGenerators) -> list:
        """Each shard's generator of the split batch's ``gens``: a worker's
        is made there from the seed (``GenRef``) and kept."""
        if self.n_shards == 1:
            return [gens.gen]
        local = [gens.shard(j, d) for j, d in enumerate(self.mesh[:self.n_local])]
        if gens not in self._gen_keys:
            self._gen_keys[gens] = next(self._next_gen_key)
        ref = GenRef(self._gen_keys[gens], gens.gen.initial_seed())
        return local + [ref] * (self.n_shards - self.n_local)

    def on_shard(self, j: int, fn, **kw):
        """``fn(runtime of shard j, **kw)`` where shard ``j`` is stepped, ``fn``
        a function of the package (a worker imports nothing else); a chain
        batch it returns stays there."""
        if j < self.n_local:
            return fn(self.rts[j], **kw)
        return self.start().one(j, "call", fn, kw)

    def _get(self, remote: Remote, idx=None):
        """The chains ``idx`` (all: None) of a worker's batch, on the CPU."""
        return self.start().one(remote.worker.j, "get", remote, idx)

    def synchronize(self):
        """Wait for the local shards' devices (a worker's reply waits for its)."""
        for dev in dict.fromkeys(self.mesh[:self.n_local]):
            _sync(dev)

    def launch_counts(self) -> list:
        """The kernel launches (``ops.check.launch_counts``) of this process,
        then of each worker: entry j is shard j's of a chain split."""
        procs = self.start()
        return [launch_counts()] + (procs.each("launches", [()] * len(procs.workers))
                                    if procs is not None else [])

    def reset_launches(self):
        reset_launches()
        procs = self.start()
        if procs is not None:
            procs.each("reset_launches", [()] * len(procs.workers))

    # -------------------- layout --------------------

    def split(self, x) -> list:
        """The shards of a chain batch (ChainState, OperatorStats, (B, ...)
        tensor or None): contiguous, equal chain blocks, block j on
        ``mesh[j]``; on a grid a ChainState's source is split over each
        row's object blocks too (``shard_state``)."""
        if x is None:
            return [None] * self.n_shards
        blocks = [chain_block(x, j, self.n_shards) for j in range(self.n_shards)]

        def local():
            shards = [b.to(d) for b, d in zip(blocks, self.mesh[:self.n_local])]
            if self.splits and isinstance(x, ChainState):
                shards = [shard_state(st, sp) for st, sp in zip(shards, self.splits)]
            return shards

        return self._dispatch("put", [(b,) for b in blocks[self.n_local:]], local)

    def gather(self, shards: list):
        """The chains of every shard as one batch on the model's device (on a
        grid, each source joined whole: for checks and checkpoints)."""
        if shards[0] is None:
            return None
        local = shards[:self.n_local]
        if self.splits and isinstance(local[0], ChainState):
            local = [unshard_state(st, self.rt.device) for st in local]
        parts = self._dispatch("get", [(r, None) for r in shards[self.n_local:]], lambda: local)
        return parts[0] if self.n_shards == 1 else gather(parts, self.rt.device)

    # -------------------- batched programs --------------------

    def new_stats(self, n_chains: int) -> list:
        return self._each("new_stats", {"n_chains": n_chains // self.n_shards})

    def init_chains(self, gens: ShardGenerators, n_chains: int) -> list:
        return self._each("init_chains", {"n_chains": n_chains // self.n_shards},
                          gen=self._gens(gens))

    def refresh(self, shards: list) -> list:
        return self._each("refresh", states=shards)

    def run_chunk(self, gens: ShardGenerators, op_gen, shards: list, stats: list, n_steps: int,
                  temps=None, prior_temps=None) -> tuple:
        """``SamplerRuntime.run_chunk`` of every shard on one operator
        sequence; ``temps`` / ``prior_temps``: None or per-shard (b,) tensors."""
        return self.run_ops(gens, self.draw_ops(op_gen, n_steps), shards, stats, temps,
                            prior_temps)

    def run_ops(self, gens: ShardGenerators, ops: list, shards: list, stats: list, temps=None,
                prior_temps=None) -> tuple:
        """``SamplerRuntime.run_ops`` of every shard on the operators ``ops``."""
        none = [None] * self.n_shards
        out = self._each("run_ops", {"ops": ops}, gen=self._gens(gens), states=shards,
                         stats=stats, temps=temps or none, prior_temps=prior_temps or none)
        return [o[0] for o in out], [o[1] for o in out]

    def op_steps(self, gens: ShardGenerators, shards: list, temps=None, prior_temps=None, *,
                 i_op: int, n_steps: int) -> list:
        """``SamplerRuntime.op_steps`` of every shard."""
        none = [None] * self.n_shards
        return self._each("op_steps", {"i_op": i_op, "n_steps": n_steps}, gen=self._gens(gens),
                          states=shards, temps=temps or none, prior_temps=prior_temps or none)

    def values(self, shards: list) -> np.ndarray:
        """The per-shard (b,) tensors ``shards`` as one array on the host."""
        return np.concatenate([_host(t) for t in shards[:self.n_local]]
                              + [self._get(r).numpy() for r in shards[self.n_local:]])

    def log_lh_prior(self, shards: list) -> tuple:
        """(log_lh, log_prior) of the whole batch on the host: one read per
        local shard, a worker's read with its shard."""
        both = np.concatenate([_host(torch.stack([s.log_lh, s.log_prior]))
                               for s in shards[:self.n_local]]
                              + [np.stack([r.log_lh, r.log_prior])
                                 for r in shards[self.n_local:]], axis=1)
        return both[0], both[1]

    def _give(self, shard, idx):
        return self._get(shard, idx) if isinstance(shard, Remote) else give_chains(shard, idx)

    def _take(self, shard, local, moved):
        if isinstance(shard, Remote):
            return self.start().one(shard.worker.j, "take", shard, local, moved)
        return place_chains(shard, local, moved)

    def permute(self, shards: list, perm) -> list:
        """The states after an MC3 swap: rung r takes chain ``perm[r]``
        (``parallel.mesh.permute_chains``); a chain that moves to or from a
        worker goes through host memory."""
        return permute_chains(shards, perm, give=self._give, take=self._take)

    def records(self, shards: list, stats: list, requests: list) -> list:
        """``SamplerRuntime.records`` of the chains ``requests`` asks for (chain
        of the whole batch, ``make_record`` keywords), each made where its
        shard is stepped, in the order asked."""
        by_shard = [[] for _ in range(self.n_shards)]
        where = []
        for chain, kw in requests:
            j, k = divmod(chain, shards[0].n_chains)
            where.append((j, len(by_shard[j])))
            by_shard[j].append((k, kw))
        made = self._each("records", states=shards, stats=stats, requests=by_shard)
        return [made[j][i] for j, i in where]

    # a ladder whose rungs are split over the shards (per-shard temperatures)
    run_mc3_chunk = mc3_chunk
    measure_op_step_times = time_op_steps

    def non_finite(self, stats: list) -> int:
        return (sum(int(s.non_finite.sum()) for s in stats[:self.n_local])
                + sum(r.non_finite for r in stats[self.n_local:]))


def grid_runtime(rt: SamplerRuntime, grid) -> ShardedRuntime:
    """The runtime of a chain batch on a chains x objects ``grid``
    (``parallel.mesh.data_mesh``): row i is chain shard i, a local shard
    whose objects split over the row's devices (``SamplerRuntime.
    split_objects``). The rows are stepped in turn from the calling thread,
    the blocks of a row on their streams (``ObjectSplit.run``)."""
    return ShardedRuntime(rt, rts=[rt.split_objects(sp) for sp in shard_objects(rt.consts, grid)])


def _ends_workers(method):
    """An ``MCMCSetup`` method that samples, then ends the worker processes of
    the runtime's splits (``SamplerRuntime.close``), also on an exception:
    the workers live as long as the run."""
    @functools.wraps(method)
    def run(self, *args, **kw):
        try:
            return method(self, *args, **kw)
        finally:
            self.runtime.close()
    return run


class MCMCSetup:
    """Per-(K, run) sampling orchestration and results files."""

    def __init__(self, data: Data, experiment, device="cuda"):
        self.data = data
        self.config = experiment.config
        n_clusters = self.config.model.clusters
        if not isinstance(n_clusters, int):
            raise ValueError("MCMCSetup needs an integer cluster count (CLI resolves lists).")
        self.model = Model(data, self.config.model, device=device)
        self.path_results: Path = experiment.path_results / f"K{self.model.n_clusters}"
        self.path_results.mkdir(exist_ok=True, parents=True)
        self.logger = experiment.logger
        self.runtime = SamplerRuntime(self.model, self.config.mcmc,
                                      sample_from_prior=self.config.mcmc.sample_from_prior)
        self.swap_attempts = 0
        self.swap_accepts = 0
        self.swap_matrix: Optional[np.ndarray] = None
        self.last_swap_matrix_save = 0
        self.t_start = None
        self._op_step_times: Optional[np.ndarray] = None

    # -------------------- paths / loggers --------------------

    def get_results_file_path(self, prefix: str, run: int, chain: int = 0,
                              suffix: str = "txt") -> Path:
        """``K{k}/{prefix}_K{k}_{run}.{suffix}``; MC3 rungs above the cold one
        under ``hot_chains/``, with ``.chain{chain}`` before the suffix."""
        k = self.model.n_clusters
        if chain == 0:
            base_dir, chain_str = self.path_results, ""
        else:
            base_dir, chain_str = self.path_results / "hot_chains", f".chain{chain}"
            base_dir.mkdir(exist_ok=True)
        return base_dir / f"{prefix}_K{k}_{run}{chain_str}.{suffix}"

    def get_sample_loggers(self, run: int, resume: bool = False,
                           chain: int = 0) -> list[ResultsLogger]:
        """The loggers of one chain: the state pickle always; the stats,
        clusters and operator-stats files for the cold chain, and for the hot
        ones with ``log_hot_chains``; the likelihood file for the cold chain."""
        consts = self.model.consts
        results = self.config.results
        loggers: list[ResultsLogger] = [
            StateDumper(self.get_results_file_path("state", run, chain, "pickle"), consts,
                        self.data, resume=resume)]
        if chain > 0 and not results.log_hot_chains:
            return loggers
        loggers += [
            ParametersCSVLogger(
                self.get_results_file_path("stats", run, chain), consts, self.data,
                resume=resume, log_source=results.log_source,
                log_contribution_per_cluster=results.log_contribution_per_cluster,
                float_format=f"%.{results.float_precision}g"),
            ClustersLogger(self.get_results_file_path("clusters", run, chain), consts, self.data,
                           resume=resume),
            OperatorStatsLogger(self.get_results_file_path("operator_stats", run, chain), consts,
                                self.data, resume=resume),
        ]
        if self._with_likelihood() and chain == 0:
            loggers.append(LikelihoodLogger(
                self.get_results_file_path("likelihood", run, chain, "h5"), consts, self.data,
                resume=resume))
        return loggers

    def _with_likelihood(self) -> bool:
        return not self.config.mcmc.sample_from_prior and self.config.results.log_likelihood

    def log_setup(self):
        cfg = self.config.mcmc
        self.logger.info(self.model.get_setup_message())
        self.logger.info(
            f"\nMCMC SETUP\n##########################################\n"
            f"MCMC with {cfg.steps} steps and {cfg.samples} samples\n"
            f"Warm-up: {cfg.warmup.warmup_chains} chains exploring the parameter space in "
            f"{cfg.warmup.warmup_steps} steps\n"
            f"Ratio of cluster steps: {cfg.operators.clusters}\n"
            f"Ratio of weight steps: {cfg.operators.weights}\n"
            f"Ratio of source steps: {cfg.operators.source}")

    # -------------------- resume --------------------

    def _load_state_pickle(self, path: Path) -> tuple[ChainState, int]:
        """The checkpointed state (a batch of one, its source converted to
        the model's form in either direction, every carried invariant
        recomputed) and the step it was written at."""
        with open(path, "rb") as f:
            d = pickle.load(f)
        state = ChainState.from_numpy(d, device=self.runtime.device)
        state = state._replace(source=self.runtime.post.source_form(state.source))
        return self.runtime.refresh(state), int(d.get("i_step", 0))

    def _resume_from_results(self, run: int, chain: int = 0) -> tuple[ChainState, int]:
        """The last logged sample of the clusters and stats files (no pickle):
        its clusters and weights, a source drawn from the weights and then
        one Gibbs pass from its posterior, stored in the model's form; the
        step after the last sample."""
        from sbayes_tpu_torch.results.results import Results

        results = Results.from_csv_files(self.get_results_file_path("clusters", run, chain),
                                         self.get_results_file_path("stats", run, chain))
        rt = self.runtime
        na = self.model.consts.na[None, :, :, None]
        clusters = torch.as_tensor(results.clusters[:, -1, :], dtype=torch.bool,
                                   device=rt.device)[None]
        weights = torch.as_tensor(
            np.stack([results.weights[f][-1] for f in self.data.features.names]),
            dtype=torch.float32, device=rt.device)[None]
        gen = torch.Generator(device=rt.device)
        gen.manual_seed(run)
        w = normalize_weights(weights, rt.post.has_components(clusters))
        source = sample_categorical_onehot(gen, w) & ~na
        minus_inf = torch.full((1,), float("-inf"), device=rt.device)
        state = ChainState(clusters, weights, source, minus_inf, minus_inf,
                           torch.full((1, 4), float("-inf"), device=rt.device))
        p = rt.cond.source_posterior(clusters, weights, source)
        state = state._replace(source=rt.post.source_form(sample_categorical_onehot(gen, p) & ~na))
        return rt.refresh(state), int(results.sample_id[-1] + 1)

    def _resume_state(self, run: int, chain: int = 0) -> tuple[ChainState, int]:
        path = self.get_results_file_path("state", run, chain, "pickle")
        if path.exists():
            return self._load_state_pickle(path)
        return self._resume_from_results(run, chain)

    # -------------------- single-run sampling --------------------

    @_ends_workers
    def sample(self, initial_sample: Optional[ChainState] = None, resume: bool = False,
               run: int = 1, seed: int = 0):
        cfg = self.config.mcmc
        rt = self.runtime
        gen, op_gen = make_generators(seed + 1000003 * run, rt.device)
        sample_loggers = self.get_sample_loggers(run, resume)
        i_step_start = 0
        if initial_sample is not None:
            state = initial_sample
        elif resume:
            state, i_step_start = self._resume_state(run)
        else:
            t0 = time.time()
            state = rt.warmup(gen, op_gen, cfg.warmup.warmup_chains, cfg.warmup.warmup_steps,
                              self.logger)
            self.logger.info(f"Initialization and warm-up finished after "
                             f"{time.time() - t0:.1f} seconds")
        self._sample_loop(state, [sample_loggers], [run], gen, op_gen, i_step_start)

    # -------------------- ensemble sampling (several runs at once) --------------------

    @_ends_workers
    def sample_ensemble(self, run_ids, resume: bool = False, seed: int = 0):
        """All ``run_ids`` as ONE chain batch: one warm-up race of W chains
        per run, then one chain per run; each run keeps its own results
        files. The operator draw is shared across runs (state-independent,
        so each run remains a valid sampler). One run, or a resume (the runs
        may resume at different steps), samples the runs one after another."""
        run_ids = list(run_ids)
        cfg = self.config.mcmc
        rt = self.runtime
        R = len(run_ids)
        if R == 1 or resume:
            for r in run_ids:
                self.sample(resume=resume, run=r, seed=seed)
            return
        loggers_by_run = [self.get_sample_loggers(r, resume) for r in run_ids]
        gen, op_gen = make_generators(seed + 101, rt.device)
        gens = ShardGenerators(gen)

        W = cfg.warmup.warmup_chains
        t0 = time.time()
        sh = rt.shard(R * W, self.logger)
        states_rw = sh.init_chains(gens, R * W)
        if cfg.warmup.warmup_steps > 0:
            states_rw, _ = sh.run_chunk(gens, op_gen, states_rw, sh.new_stats(R * W),
                                        cfg.warmup.warmup_steps)
            states_rw = sh.refresh(states_rw)
        states_rw = sh.gather(states_rw)
        ll_rw = _host(states_rw.log_lh).reshape(R, W)
        sel = torch.as_tensor(ll_rw.argmax(axis=1) + np.arange(R) * W, device=rt.device)
        states = states_rw.select(sel)
        self.logger.info(
            f"Warm-up for {R} runs ({R * W} chains) finished after {time.time() - t0:.1f}s; "
            f"best warm-up log-likelihoods: {ll_rw.max(axis=1).round(2).tolist()}")
        self._sample_loop(states, loggers_by_run, run_ids, gens, op_gen)

    def _sample_loop(self, states: ChainState, loggers_by_run, run_ids, gen, op_gen,
                     i_step_start: int = 0):
        """The chunked sampling loop of a batch with one chain per run, from
        step ``i_step_start`` (a resumed run) to ``mcmc.steps``, split over
        ``auto_chain_mesh``; ``gen``: a generator or the ``ShardGenerators``
        of the warm-up race."""
        rt = self.runtime
        cfg = self.config.mcmc
        gens = ShardGenerators.of(gen)
        sh = rt.shard(states.n_chains, self.logger)
        states = sh.split(states)
        steps_per_sample = int(math.ceil(cfg.steps / cfg.samples))
        stats = sh.new_stats(len(run_ids))
        with_lh = self._with_likelihood()
        with_contrib = self.config.results.log_contribution_per_cluster
        self._maybe_measure_op_times(sh, states)
        self.t_start = time.time()
        self.logger.info(f"Sampling from posterior ({len(run_ids)} run(s) as one batch)...")
        log_every = max(1, int(round(cfg.screen_log_interval / steps_per_sample)))
        i_step = i_step_start
        for i_sample in range(i_step_start // steps_per_sample, cfg.samples):
            states, stats = sh.run_chunk(gens, op_gen, states, stats, steps_per_sample)
            i_step += steps_per_sample
            if (i_sample + 1) % REFRESH_EVERY_CHUNKS == 0:
                states = sh.refresh(states)
            if i_sample + 1 == max(1, cfg.samples // 2):
                self._maybe_measure_op_times(sh, states, force=True)
            if sh.non_finite(stats) > 0:
                raise ValueError("Non-finite log-posterior was accepted during MCMC.")
            kw = dict(i_step=i_step, with_likelihood=with_lh,
                      with_cluster_contribution=with_contrib)
            made = sh.records(states, stats, [(i_r, kw) for i_r in range(len(run_ids))])
            for (record, op_row), run_loggers in zip(made, loggers_by_run):
                self._push_operator_stats(run_loggers, op_row, elapsed=time.time() - self.t_start,
                                          steps_done=i_step - i_step_start)
                for logger in run_loggers:
                    logger.write_sample(record)
            if (i_sample + 1) % log_every == 0:
                self._print_screen_log(i_step, float(states[0].log_lh[0]), i_step_start)
        for run_loggers in loggers_by_run:
            for logger in run_loggers:
                logger.close()
        self.logger.info(f"MCMC of {len(run_ids)} run(s) finished after "
                         f"{time.time() - self.t_start:.1f} seconds")

    def _maybe_measure_op_times(self, sh: ShardedRuntime, states: list, temps=None,
                                prior_temps=None, force: bool = False):
        """The per-operator timing probe (``results.log_operator_step_times``),
        at start-up and again at the run's midpoint (``force``), on the
        equilibrated states of every shard (``sh``, ``states``: shards);
        its own generator leaves the sampling streams untouched."""
        if not self.config.results.log_operator_step_times:
            return
        if self._op_step_times is not None and not force:
            return
        t0 = time.time()
        gen = torch.Generator(device=self.runtime.device)
        gen.manual_seed(0x0B5E)
        self._op_step_times = sh.measure_op_step_times(ShardGenerators(gen), states, temps,
                                                       prior_temps)
        self.logger.info(
            "Per-operator step times [ms]: "
            + ", ".join(f"{n}={1e3 * t:.2f}"
                        for n, t in zip(self.runtime.op_names, self._op_step_times))
            + f" (probe took {time.time() - t0:.1f}s)")

    def _push_operator_stats(self, sample_loggers, op_row: tuple, elapsed: float,
                             steps_done: int):
        """``op_row``: one chain's (accepts, rejects, step_size_sum) by
        operator (``SamplerRuntime.records``)."""
        accepts, rejects, sss = op_row
        op_times = self._op_step_times
        mean_step_time = elapsed / max(steps_done, 1)
        views = [
            OperatorView(name=self.runtime.op_names[i], accepts=int(accepts[i]),
                         rejects=int(rejects[i]), step_size_sum=float(sss[i]),
                         mean_step_time_s=(float(op_times[i]) if op_times is not None
                                           else mean_step_time),
                         parameters=self.runtime._op_specs[i].parameters)
            for i in range(self.runtime.n_ops)
        ]
        for logger in sample_loggers:
            if isinstance(logger, OperatorStatsLogger):
                logger.operators = views
                logger.probed = op_times is not None

    def _print_screen_log(self, i_step: int, likelihood: float, i_step_start: int = 0):
        time_per_million = ((time.time() - self.t_start) / max(i_step - i_step_start, 1)
                            * 1_000_000)
        self.logger.info(
            f"{i_step:<12}log-likelihood:  {likelihood:<19.2f}"
            f"{timedelta(seconds=int(time_per_million))} / million steps")

    # -------------------- MC3 --------------------

    @_ends_workers
    def sample_mc3(self, resume: bool = False, run: int = 1, seed: int = 0):
        """Metropolis-coupled MCMC: a ladder of ``mc3.chains`` rungs at the
        temperatures of ``temperature_ladder`` as one chain batch, with a
        swap phase every ``swap_interval`` steps. Rung 0 (T = 1) writes the
        run's files, the hot rungs theirs under ``hot_chains/``. Under
        ``resume`` every rung continues from its own pickle (or its files)."""
        cfg = self.config.mcmc
        mc3 = cfg.mc3
        rt = self.runtime
        n_chains = mc3.chains
        logging_interval = int(math.ceil(cfg.steps / cfg.samples))
        temps_np, prior_temps_np = temperature_ladder(mc3)
        temps = torch.as_tensor(temps_np, dtype=torch.float32, device=rt.device)
        prior_temps = torch.as_tensor(prior_temps_np, dtype=torch.float32, device=rt.device)
        gen, op_gen = make_generators(seed + 7000003 * run, rt.device)
        gens = ShardGenerators(gen)

        t_pre_init = time.time()
        loggers_by_chain = [self.get_sample_loggers(run, resume, chain=c)
                            for c in range(n_chains)]
        i_step_start = 0
        if resume:
            resumed = [self._resume_state(run, chain=c) for c in range(n_chains)]
            states = ChainState.concat([st for st, _ in resumed])
            # The rungs checkpoint together; min() is conservative if they disagree.
            i_step_start = min(i0 for _, i0 in resumed)
        else:
            states = rt.warmup_ladder(gens, op_gen, n_chains, cfg.warmup.warmup_chains, temps,
                                      prior_temps, cfg.warmup.warmup_steps, logger=self.logger)
        # The ladder's rungs split over the mesh; swaps move chains across shards.
        sh = rt.shard(n_chains, self.logger)
        states, temps, prior_temps = sh.split(states), sh.split(temps), sh.split(prior_temps)
        stats = sh.new_stats(n_chains)
        with_lh = self._with_likelihood()
        self._maybe_measure_op_times(sh, states, temps, prior_temps)
        self.swap_attempts = 0
        self.swap_accepts = 0
        self.swap_matrix = np.zeros((n_chains, n_chains), dtype=int)
        swap_counts = np.zeros((2, n_chains, n_chains), dtype=np.int64)
        self.t_start = time.time()
        self.logger.info(f"Initialization and warm-up time: "
                         f"{timedelta(seconds=int(self.t_start - t_pre_init))}")
        self.logger.info("Sampling from posterior...")

        i_step = i_step_start
        for i_outer in range(i_step_start // logging_interval, cfg.samples):
            n_steps_chunk = min(logging_interval, cfg.steps - i_outer * logging_interval)
            if n_steps_chunk <= 0:
                break
            states, stats, n_acc, n_att = sh.run_mc3_chunk(
                gens, op_gen, states, stats, temps, prior_temps, swap_counts, i_step,
                n_steps_chunk, mc3.swap_interval, int(mc3.swap_attempts),
                bool(mc3.only_swap_adjacent_chains))
            i_step += n_steps_chunk
            self.swap_accepts += n_acc
            self.swap_attempts += n_att
            if (i_outer + 1) % REFRESH_EVERY_CHUNKS == 0:
                states = sh.refresh(states)
            if i_outer + 1 == max(1, cfg.samples // 2):
                self._maybe_measure_op_times(sh, states, temps, prior_temps, force=True)
            if sh.non_finite(stats) > 0:
                raise ValueError("Non-finite log-posterior was accepted during MCMC.")

            # The swap matrix is saved only when new attempts happened since
            # the last save.
            if mc3.log_swap_matrix and self.last_swap_matrix_save < self.swap_attempts:
                self.swap_matrix = swap_counts[0].copy()
                path = self.path_results / f"mc3_swaps_K{self.model.n_clusters}_{run}.txt"
                np.savetxt(path, self.swap_matrix, fmt="%i")
                self.last_swap_matrix_save = self.swap_attempts

            with_contrib = self.config.results.log_contribution_per_cluster
            made = sh.records(states, stats, [
                (c, dict(i_step=i_step, chain=c, with_likelihood=with_lh and c == 0,
                         with_cluster_contribution=with_contrib)) for c in range(n_chains)])
            for c, (record, op_row) in enumerate(made):
                self._push_operator_stats(loggers_by_chain[c], op_row,
                                          elapsed=time.time() - self.t_start,
                                          steps_done=i_step - i_step_start)
                for logger in loggers_by_chain[c]:
                    logger.write_sample(record)
            self.logger.info(
                f"swap accept-rate={self.swap_accepts / max(self.swap_attempts, 1):.3f} "
                f"({self.swap_attempts} attempts)")
            # Per-rung (adjacent-pair) acceptance, for tuning temperature_diff.
            rung_rates = " ".join(
                f"{i}<->{i + 1}:{swap_counts[0, i, i + 1] / max(swap_counts[1, i, i + 1], 1):.2f}"
                for i in range(n_chains - 1))
            self.logger.info(f"swap accept-rate per rung: {rung_rates}")
            self._print_screen_log(i_step, float(states[0].log_lh[0]), i_step_start)

        for chain_loggers in loggers_by_chain:
            for logger in chain_loggers:
                logger.close()
        self.logger.info(f"MCMC run finished after "
                         f"{timedelta(seconds=int(time.time() - self.t_start))}")
