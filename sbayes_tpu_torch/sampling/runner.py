"""Host-level MCMC orchestration: warm-up, sampling loop, logging.

Port of the default sampling path of ``sbayes_tpu/sampling/runner.py``. All chains (the
warm-up race and the runs of an ensemble) are one chain axis of the batched
operators. One operator per step is drawn for the whole batch on the host,
from a CPU ``torch.Generator``, so dispatch never waits on the device; the
per-chain randomness comes from a generator on the model's device. The
carried invariants are recomputed exactly every ``REFRESH_EVERY_CHUNKS``
chunks.

Not ported here: MC3 (``sample_mc3``), resume, multi-device sharding and the
per-operator timing probe (the operator-stats STEP-TIME column holds the
run's mean wall time per step instead).
"""
from __future__ import annotations

import math
import time
from datetime import timedelta
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sbayes_tpu_torch.data.loader import Data
from sbayes_tpu_torch.model.math import normalize_weights
from sbayes_tpu_torch.model.model import Model
from sbayes_tpu_torch.model.posterior import Posterior
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
from sbayes_tpu_torch.sampling.conditionals import Conditionals
from sbayes_tpu_torch.sampling.initializer import Initializer
from sbayes_tpu_torch.sampling.kernel import OperatorStats, make_mh_apply_fn
from sbayes_tpu_torch.sampling.operators import get_operator_schedule
from sbayes_tpu_torch.sampling.state import ChainState

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


class SamplerRuntime:
    """The batched sampling programs of one model (unit temperatures)."""

    def __init__(self, model: Model, mcmc_config, sample_from_prior: bool = False):
        self.model = model
        self.consts = model.consts
        self.device = model.consts.device
        self.mcmc_config = mcmc_config
        self.sample_from_prior = sample_from_prior
        self.p_grow = 0.5
        self.cond = Conditionals(Posterior(self.consts, sample_from_prior), 1.0, 1.0)
        self.post = self.cond.post
        self._op_specs = get_operator_schedule(self.cond, mcmc_config.operators, self.p_grow)
        self.op_names = [o.name for o in self._op_specs]
        self.n_ops = len(self.op_names)
        self.op_weights = torch.tensor([o.weight for o in self._op_specs], dtype=torch.float64)
        self._apply = make_mh_apply_fn(self.cond, self._op_specs)

    # -------------------- batched programs --------------------

    def new_stats(self, n_chains: int) -> OperatorStats:
        return OperatorStats.zeros(n_chains, self.n_ops, self.device)

    def init_chains(self, gen, n_chains: int) -> ChainState:
        """``n_chains`` initial states (best of the configured attempts each),
        with every carried invariant filled."""
        init_cfg = self.mcmc_config.initialization
        initializer = Initializer(
            self.cond, initial_size=init_cfg.objects_per_cluster, attempts=init_cfg.attempts,
            initial_cluster_steps=init_cfg.initial_cluster_steps, n_em_steps=init_cfg.em_steps,
            method=init_cfg.method)
        return self.post.fill_state(initializer.generate_sample(gen, n_chains))

    def run_chunk(self, gen, op_gen, states: ChainState, stats: OperatorStats, n_steps: int):
        """``n_steps`` MH steps of every chain; one operator per step."""
        ops = torch.multinomial(self.op_weights, n_steps, replacement=True, generator=op_gen)
        for op_idx in ops.tolist():
            states, accept, step_size, nf = self._apply(op_idx, gen, states)
            stats = stats.record(op_idx, accept, step_size, nf)
        return states, stats

    def refresh(self, states: ChainState) -> ChainState:
        """Exact recompute of every carried invariant."""
        return self.post.fill_state(states)

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

    def make_record(self, state_c: ChainState, i_step: int, chain: int = 0,
                    with_likelihood: bool = True) -> SampleRecord:
        """The logged sample of ONE chain (``state_c``: a batch of one)."""
        parts, cl_counts, conf_counts, obs_lh = self.sample_view(state_c, with_likelihood)
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
            chain=chain,
        )

    def warmup(self, gen, op_gen, n_chains: int, n_steps: int, logger=None) -> ChainState:
        """Warm-up race: run ``n_chains`` and keep the best by likelihood (a batch of one)."""
        states = self.init_chains(gen, n_chains)
        if n_steps > 0:
            states, _ = self.run_chunk(gen, op_gen, states, self.new_stats(n_chains), n_steps)
            states = self.refresh(states)
        best = int(torch.argmax(states.log_lh))
        if logger:
            logger.info(
                f"Starting state taken from warmup chain {best} with log-likelihood "
                f"{float(states.log_lh[best]):.2f} (all chains: "
                f"{_host(states.log_lh).round(2).tolist()}).")
        return states.select(slice(best, best + 1))


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
        self.t_start = None

    # -------------------- paths / loggers --------------------

    def get_results_file_path(self, prefix: str, run: int, suffix: str = "txt") -> Path:
        return self.path_results / f"{prefix}_K{self.model.n_clusters}_{run}.{suffix}"

    def get_sample_loggers(self, run: int, resume: bool = False) -> list[ResultsLogger]:
        consts = self.model.consts
        results = self.config.results
        loggers: list[ResultsLogger] = [
            StateDumper(self.get_results_file_path("state", run, "pickle"), consts, self.data,
                        resume=resume),
            ParametersCSVLogger(
                self.get_results_file_path("stats", run), consts, self.data, resume=resume,
                log_source=results.log_source,
                log_contribution_per_cluster=results.log_contribution_per_cluster,
                float_format=f"%.{results.float_precision}g"),
            ClustersLogger(self.get_results_file_path("clusters", run), consts, self.data,
                           resume=resume),
            OperatorStatsLogger(self.get_results_file_path("operator_stats", run), consts,
                                self.data, resume=resume),
        ]
        if not self.config.mcmc.sample_from_prior and results.log_likelihood:
            loggers.append(LikelihoodLogger(self.get_results_file_path("likelihood", run, "h5"),
                                            consts, self.data, resume=resume))
        return loggers

    def _with_likelihood(self) -> bool:
        return not self.config.mcmc.sample_from_prior and self.config.results.log_likelihood

    def _check_supported(self, resume: bool):
        if resume:
            raise NotImplementedError("resume is not ported yet (resume slice)")
        if self.config.results.log_contribution_per_cluster:
            raise NotImplementedError("log_contribution_per_cluster is not ported yet")

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

    # -------------------- single-run sampling --------------------

    def sample(self, initial_sample: Optional[ChainState] = None, resume: bool = False,
               run: int = 1, seed: int = 0):
        self._check_supported(resume)
        cfg = self.config.mcmc
        rt = self.runtime
        gen, op_gen = make_generators(seed + 1000003 * run, rt.device)
        sample_loggers = self.get_sample_loggers(run, resume)
        if initial_sample is not None:
            state = initial_sample
        else:
            t0 = time.time()
            state = rt.warmup(gen, op_gen, cfg.warmup.warmup_chains, cfg.warmup.warmup_steps,
                              self.logger)
            self.logger.info(f"Initialization and warm-up finished after "
                             f"{time.time() - t0:.1f} seconds")
        self._sample_loop(state, [sample_loggers], [run], gen, op_gen)

    # -------------------- ensemble sampling (several runs at once) --------------------

    def sample_ensemble(self, run_ids, resume: bool = False, seed: int = 0):
        """All ``run_ids`` as ONE chain batch: one warm-up race of W chains
        per run, then one chain per run; each run keeps its own results
        files. The operator draw is shared across runs (state-independent,
        so each run remains a valid sampler)."""
        run_ids = list(run_ids)
        self._check_supported(resume)
        cfg = self.config.mcmc
        rt = self.runtime
        R = len(run_ids)
        if R == 1:
            self.sample(run=run_ids[0], seed=seed)
            return
        loggers_by_run = [self.get_sample_loggers(r, resume) for r in run_ids]
        gen, op_gen = make_generators(seed + 101, rt.device)

        W = cfg.warmup.warmup_chains
        t0 = time.time()
        states_rw = rt.init_chains(gen, R * W)
        if cfg.warmup.warmup_steps > 0:
            states_rw, _ = rt.run_chunk(gen, op_gen, states_rw, rt.new_stats(R * W),
                                        cfg.warmup.warmup_steps)
            states_rw = rt.refresh(states_rw)
        ll_rw = _host(states_rw.log_lh).reshape(R, W)
        sel = torch.as_tensor(ll_rw.argmax(axis=1) + np.arange(R) * W, device=rt.device)
        states = states_rw.select(sel)
        self.logger.info(
            f"Warm-up for {R} runs ({R * W} chains) finished after {time.time() - t0:.1f}s; "
            f"best warm-up log-likelihoods: {ll_rw.max(axis=1).round(2).tolist()}")
        self._sample_loop(states, loggers_by_run, run_ids, gen, op_gen)

    def _sample_loop(self, states: ChainState, loggers_by_run, run_ids, gen, op_gen):
        """The chunked sampling loop of a batch with one chain per run."""
        rt = self.runtime
        cfg = self.config.mcmc
        steps_per_sample = int(math.ceil(cfg.steps / cfg.samples))
        stats = rt.new_stats(states.n_chains)
        with_lh = self._with_likelihood()
        self.t_start = time.time()
        self.logger.info(f"Sampling from posterior ({len(run_ids)} run(s) as one batch)...")
        log_every = max(1, int(round(cfg.screen_log_interval / steps_per_sample)))
        i_step = 0
        for i_sample in range(cfg.samples):
            states, stats = rt.run_chunk(gen, op_gen, states, stats, steps_per_sample)
            i_step += steps_per_sample
            if (i_sample + 1) % REFRESH_EVERY_CHUNKS == 0:
                states = rt.refresh(states)
            if int(stats.non_finite.sum()) > 0:
                raise ValueError("Non-finite log-posterior was accepted during MCMC.")
            for i_r, run_loggers in enumerate(loggers_by_run):
                record = rt.make_record(states.select(slice(i_r, i_r + 1)), i_step=i_step,
                                        with_likelihood=with_lh)
                self._push_operator_stats(run_loggers, stats, i_r,
                                          elapsed=time.time() - self.t_start, steps_done=i_step)
                for logger in run_loggers:
                    logger.write_sample(record)
            if (i_sample + 1) % log_every == 0:
                self._print_screen_log(i_step, float(states.log_lh[0]))
        for run_loggers in loggers_by_run:
            for logger in run_loggers:
                logger.close()
        self.logger.info(f"MCMC of {len(run_ids)} run(s) finished after "
                         f"{time.time() - self.t_start:.1f} seconds")

    def _push_operator_stats(self, sample_loggers, stats, chain_idx: int, elapsed: float,
                             steps_done: int):
        accepts = _host(stats.accepts[chain_idx])
        rejects = _host(stats.rejects[chain_idx])
        sss = _host(stats.step_size_sum[chain_idx])
        mean_step_time = elapsed / max(steps_done, 1)
        views = [
            OperatorView(name=self.runtime.op_names[i], accepts=int(accepts[i]),
                         rejects=int(rejects[i]), step_size_sum=float(sss[i]),
                         mean_step_time_s=mean_step_time,
                         parameters=self.runtime._op_specs[i].parameters)
            for i in range(self.runtime.n_ops)
        ]
        for logger in sample_loggers:
            if isinstance(logger, OperatorStatsLogger):
                logger.operators = views

    def _print_screen_log(self, i_step: int, likelihood: float):
        time_per_million = (time.time() - self.t_start) / max(i_step, 1) * 1_000_000
        self.logger.info(
            f"{i_step:<12}log-likelihood:  {likelihood:<19.2f}"
            f"{timedelta(seconds=int(time_per_million))} / million steps")

    def sample_mc3(self, resume: bool = False, run: int = 1, seed: int = 0):
        raise NotImplementedError("MC3 is not ported yet (MC3 slice)")
