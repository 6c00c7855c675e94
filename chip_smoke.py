"""Chip smoke test of the PyTorch port (``sbayes_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py revision <root> <out.npz>   # one revision's kernel outputs
    python3 chip_smoke.py compare <a.npz> <b.npz>      # two revisions' bits

The last two hold both kernels of two revisions of the port against each
other: ``revision`` imports ``sbayes_tpu_torch`` from ``<root>`` (a ``git
archive`` of the revision), draws the inputs of the likelihood and of every
marginal variant from a seed at REVISION_SHAPES, saves the outputs and
prints the device time per launch and the time per eager call, then the
chain-steps/s of REVISION_STEPS steps of CHAINS chains (K = 1 uniform, K
= 3 cost-based) through that revision's ``run_chunk`` after as many
unmeasured ones; ``compare`` fails unless the main shapes' outputs are
bit-equal (elsewhere it reports the differences). Run the revisions in
turns in one call (a, b, b, a).

1. prints the card's name and power limit, builds every CUDA kernel of
   ``sbayes_tpu_torch/csrc`` (one nvcc per source, all started together);
2. main path: ``MCMCSetup.sample_ensemble`` over 8 runs of the default model
   configuration (K = 1, uniform geo prior) on a synthetic dataset of the
   south_america shape (100 objects x 36 features x 6 states, universal + 6
   families), into a temporary directory; every results file must exist and
   both kernels must have been launched. Then ``main_path_k3``: the same
   through K = 3 with the cost-based geo prior (mean, rate 1e6): results
   under ``K3/``, three cluster columns, a geo-prior column that is not all
   zero, and the absolute marginal (the jump) launched. Then
   ``main_path_mc3``: ``cli.main`` with MC3 on (8 rungs, ``MC3_LADDER``, a
   swap phase every 50 steps, best of 10 warm-ups per rung) at K = 3: the
   cold rung's files, ``hot_chains/`` for rungs 1..7, the swap matrix, the
   heat variant of the marginal launched, the swap acceptance overall
   (strictly between 0 and 1) and per rung, the ladder's carried state after
   the last swap against its recompute. Then ``resume``: ``cli.main`` for
   500 steps, then ``cli.main(..., resume=True)`` for 1000, of one chain
   and of an MC3 ladder of four rungs: continuous sample ids in every
   rung's stats file and the resumed run's carried state equal to its
   recompute; then one chain once more with its state pickle deleted, so
   that it resumes from its clusters and stats files at the last sample +
   1, with pandas unimportable. These two phases run the CLI on JSON configs;
   its data load returns ``synthetic_data()``;
3. full width: ``SamplerRuntime.init_chains(CHAINS)``, STEPS steps in chunks of 200,
   an exact refresh; the carried log-likelihood / log-prior / counts must
   equal the recompute; one JSON line with the steps per second; then the
   wall time per step of each operator and, from torch.profiler, the
   device-busy share and kernels per step of the schedule. Then
   ``full_width_k3``: the same at K = 3 with the cost-based geo prior and the
   ten-operator schedule, STEPS_K3 steps; besides the K = 1 checks the
   carried skeleton aggregates must equal their recompute, no object may be
   in two clusters, every size must lie within its bounds and the jump must
   be accepted sometimes and not always; its time breakdown also holds one
   ``_update_geo`` (the batched Prim): launches and wall time. Then
   ``full_width_mc3``: the K = 3 phase again with the 8 temperatures of
   ``MC3_LADDER``, each on an eighth of the chains (no swaps): per-chain
   temperatures, the wide operator through the heat variant, with
   ``full_width_k3``'s steps/s, kernels per step and busy share beside its
   own. Then ``jump_512``:
   64 chains, 512 features, K = 2, the jump alone for 50 MH steps, so that
   the two-effect ratio marginal (the log-space jump) is launched by an
   operator; the same invariants. Then ``ess``: CHAINS chains at K = 3, with
   the uniform geo prior and again with ``GEO_K3``, ESS_WARMUP steps and a
   trace window of ESS_STEPS steps in chunks of 200 (``run_chunk(...,
   trace=True)``): steps per second, the multichain ESS of the log-posterior,
   ESS per second and split-R-hat, the trace's last row against the carried
   log-posterior, CUDA kernels per step with and without the trace (same
   draws; the median of three 20-step windows), and steps per second of
   100-step windows
   without, with, with and without it. ``alt_operators``: on the
   ``full_width_k3`` states each of the wide operator with the residual and
   the residual-counts effect, with the EM proposal, and ``alter_weights``
   alone for ALT_STEPS MH steps (ms per step, launches, the carried state
   against its recompute), the residual-counts wide also at the
   ``full_width_mc3`` temperatures (the heat variant on residual rows).
   ``prior_samples``: PRIOR_SAMPLES samples from the prior at K = 3, their
   ``log_lh`` (the likelihood kernel) against the plain likelihood.
   ``scale``: ``benchmarks/scale10k.py``'s workload (10,000 objects x 5,000
   features x 5 states, K = 5, uniform geo prior, sizes 10-3000), packed
   source and feature tiles asserted, SCALE_CHAINS chains from the EM
   initializer, SCALE_CHUNKS chunks of SCALE_CHUNK steps of the full
   schedule: steps per second, peak device memory, ms per step of each
   operator alone, the source sweep always accepted, the wide operator's
   moves above its rows cap, the carried state against its recompute; the
   same once more from an in-bounds start (``in_bounds``: K random disjoint
   clusters of the EM's target size, 200 objects, a source pass over all
   objects), with sizes held strictly within the bounds; both kernels
   against their plain versions on SCALE_KERNEL_CHAINS chains. Then
   ``scale_geo``: the same workload and data under ``GEO_K3`` (cost-based,
   mean, rate 1e6), from the EM start (the EM's geo term, the ML steps that
   weigh membership by the geo prior) and from an in-bounds start: the
   carried state (skeleton aggregates included) against its recompute, a
   finite, non-zero geo-prior part of every chain's log-prior, sizes within
   bounds, both kernels against their plain versions; peak memory, steps
   per second, ms per step of each operator, one ``_update_geo`` at the
   batch's sizes (launches, wall ms, Prim iterations), one tiled against
   one untiled ``geo_prior_costs_per_object`` (bit-equal, the tiled peak
   under 1 GB). Then ``scale_mc3``: ``benchmarks/mc3_scale.py``'s ladder
   (SCALE_MC3: 4 rungs, T = 1 + 0.02 i, a swap phase every 10 steps) from
   the first 4 in-bounds states of ``scale`` through ``run_mc3_chunk``,
   then the plain ensemble from the same start: chain-steps per second of
   both, the MC3 overhead, swap acceptance per rung pair, the heat variant
   launched (and against its plain version on the two hottest rungs), each
   run's carried state against its recompute. In the
   CLI block, ``init_methods``: ``cli.main`` at K = 3 with the
   ``seed_points`` initializer, then with ``random_growth`` and
   ``log_contribution_per_cluster``; then ``workflow``: a user's workflow
   with its data in CSV files that the loader reads (no patch of the data
   load): a canvas of 100 sites and three true clusters, the simulation
   (36 features), the universal prior counts extracted from the simulated
   CSVs, ``cli.main`` at K = 1 and 3 (main_path's runs and steps, the
   cost-based geo prior on the simulated locations, the extracted counts as
   the universal prior, ``log_likelihood: false``): the results files and
   stats rows, ``loglh`` and ``marginal`` launched at both K and
   ``marginal_abs`` at K = 3, each true cluster's best F1 against run 0's
   clusters at K = 3 (at least one at 0.5 or above), the thinned stats and
   clusters files, and the config template's top-level sections. Then
   ``mesh``, the parallel layer, over every visible card or, on a one-card
   machine, two shards on cuda:0 (``mesh_devices``; ``split_over`` makes
   ``auto_chain_mesh`` see them): (a) the K = 3 ensemble of CHAINS chains
   (``full_width_k3``'s states) split, a split init, then alternating
   windows split / unsplit and one window of both shards dispatched from
   one thread; (b) ``full_width_mc3``'s chains as one MC3 ladder split
   across the shards, swaps counted across the shard boundary; (c)
   ``scale``'s in-bounds states split 2 x 8, on drawn steps and on a fixed
   sequence of wide steps; each with every shard's
   carried state against its recompute, the launches on shard 1's stream
   and both kernels against their plain versions on shard 1's chains; (d)
   ``cli.main`` on the fixture config (JSON) with 2 runs as one ensemble,
   as ``-t 2`` (spawned processes) and as ``-i 0; -i 1``: wall times, every
   run's files complete with finite likelihoods (MESH: the step counts).
   Then ``data_mesh``, the object-axis split: ``scale``'s in-bounds states
   on a 1 x 2 chains x objects grid (``data_mesh``; one object shard per
   card, or both on cuda:0), DATA_MESH["steps"] drawn steps of ``run_chunk``
   and the refresh, split and unsplit, then DATA_MESH["wide_steps"] steps
   of the wide operator: steps/s of each, kernels per step split and
   unsplit, bytes copied between the shards per step, the bytes each
   shard holds and the peak a card of a two-card split would hold; the
   carried state against the split recompute, the counts against the
   unsplit recompute (bit-equal), the split log-likelihood against the
   fused kernel (bit-equal), the counts entry and the marginal launched on
   each block's stream;
4. kernels: each kernel (and each variant of the marginal) against its plain
   PyTorch version at the shapes of phase 3, timed beside the plain version,
   the memory/compute bound and an empty kernel launched the same way
   (``launch_floor_ms``); then both kernels once more at 400 features,
   where they walk the features in shared-memory tiles, at an odd shape
   (37 objects x 7 features x 5 states, 3 chains, some objects in no
   family), where no table is 16-byte aligned and the kernels load with
   plain loads, and with 1, 3 and 4 confounders, so that every component
   count the kernels are compiled for is launched, and with 1100 families,
   where one feature's rows need more shared memory than a block gets by
   default; the absolute and two-effect variants are timed on the inputs
   the jump gives them at K = 3 (two clusters' effects, ``hc_flip = hc``,
   ``incl = 1``), the likelihood also on the K = 3 states, the two-effect
   variant also at ``jump_512``'s shapes, the heat variant also on the
   ``full_width_mc3`` states at their per-chain temperatures (``"mc3"``);
   one ``kernels`` JSON line, ``launches`` summed over the driven paths
   (``launches_by_path``), with rows at the scale shape (``"inputs":
   "scale"``: SCALE_KERNEL_CHAINS chains, all SCALE_CHAINS under
   ``all_chains``; their launches from ``scale``, ``scale_geo`` and
   ``scale_mc3`` and the split at scale as ``mesh``, the heat row also
   timed on the ladder's two hottest rungs under ``mc3``; the other rows
   count the mesh phase's launches as ``mesh`` and ``mesh_scale``); the ratio and heat variants once more on the
   residual-counts effect rows of ``alt_operators`` (``"inputs":
   "residual"``, launches: that path's); the likelihood kernel's two
   entries of the object split, ``loglh_counts`` and ``loglh_from_counts``,
   at the scale shape (``data_mesh``'s launches), each against its plain
   version.
   ``ms``, ``plain_ms`` and ``launch_floor_ms`` time eager calls with
   CUDA events; ``device_ms`` and ``device_floor_ms`` time the same launches
   replayed from a CUDA graph, where the host dispatches nothing;
5. last line: ``{"ok": true, "device": {...}}``. Every phase line carries
   ``elapsed_s``, the seconds since the script started.

Any failed phase raises, so the script exits non-zero and prints no result
line. It needs a CUDA card and the repository beside it.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12       # float32 outside the tensor cores
DEVICE = "cuda"
CHAINS = 1024                    # bench.py's chain count
STEPS = 1000
STEPS_K3 = 600
GEO_K3 = {"type": "cost_based", "rate": 1e6, "aggregation": "mean"}   # bench.py's geo model
MC3_LADDER = {"chains": 8, "temperature_diff": 0.1}                    # rungs of the MC3 phases
ESS_WARMUP, ESS_STEPS = 200, 1000
ALT_STEPS = 50
PRIOR_SAMPLES = 4096
# benchmarks/scale10k.py's workload (BASELINE.json configs[4]); steps cut, not width
SCALE_SHAPE = {"n_objects": 10_000, "n_features": 5_000, "n_states": 5, "n_families": 10}
SCALE_CHAINS, SCALE_CHUNK, SCALE_CHUNKS = 16, 20, 3
SCALE_KERNEL_CHAINS = 2          # the plain marginal's (B, N, F, S) temporaries stay 2 GB
# benchmarks/mc3_scale.py's ladder at the scale shape: 4 rungs, T = 1 + 0.02 i,
# prior temperatures 1, a swap phase every 10 steps of 1 attempt between
# adjacent rungs; 3 chunks of 40 steps, then the plain ensemble the same
SCALE_MC3 = {"rungs": 4, "temperature_diff": 0.02, "swap_interval": 10, "attempts": 1,
             "chunk": 40, "chunks": 3}
# The workflow phase: a 100-site canvas of three true clusters of 10 sites,
# 36 simulated features of at most 6 states, sampled at K = 1 and 3; at this
# cluster intensity a CPU run of the phase recovers all three clusters
WORKFLOW = {"sites": 100, "cluster_size": 10, "centres": [(2.0, 2.0), (8.0, 2.5), (5.0, 8.0)],
            "families": 6, "features": 36, "seed": 12,
            "n_states": {"2": 0.25, "3": 0.25, "4": 0.2, "5": 0.15, "6": 0.15},
            "cluster_effect": {"intensity": 10.0, "concentration": 0.25},
            "confounding_effects": {"universal": {"intensity": 1.0, "concentration": 1.0},
                                    "family": {"intensity": 1.0, "concentration": 0.5}}}
# The mesh phase: the chain split over every visible card (two shards on
# cuda:0 where there is one card) and the CLI's run pool, within 60 s: (a)
# three alternating pairs of 50-step windows of the split and the unsplit
# K = 3 ensemble (cut from 100), then one window of both shards dispatched
# from one thread; (b) the MC3 ladder of full_width_mc3's 1024 rungs, 105
# steps (cut from 300) with a swap phase every 5 steps (21 phases), split
# and unsplit; (c) the scale states 2 x 8, 20 steps, then 3 steps of each
# wide operator split and unsplit; (d) cli.main on the
# fixture config with 2 runs of 200 steps (cut from the fixture's 400), -t
# 1, -t 2 and -i 0; -i 1. The phase took 51 and 65 s on two hosts before
# the cuts of (b) and (d)
MESH = {"window": 50, "pairs": 3, "mc3_steps": 105, "mc3_plain_steps": 105,
        "swap_interval": 5, "scale_steps": 20, "scale_wide_steps": 3, "pool_steps": 200,
        "pool_samples": 10}
# The data_mesh phase: the object-axis split (a 1 x 2 chains x objects grid,
# one object shard per card, or two on cuda:0 on a one-card machine) of
# scale's 16 in-bounds states (no second init), 20 drawn steps and 3 steps of
# the wide operator, split and unsplit; profiled windows of 5 steps; within 60 s
DATA_MESH = {"shards": 2, "steps": 20, "wide_steps": 3, "profile_steps": 5}
# tests/fixtures/config.yaml as JSON (the card's machine has no PyYAML); the
# data paths are filled in with the fixture's CSV files
FIXTURE_CONFIG = {
    "mcmc": {"steps": 400, "samples": 20, "runs": 1, "screen_log_interval": 200,
             "operators": {"clusters": 40, "weights": 10, "source": 10},
             "initialization": {"objects_per_cluster": 1, "attempts": 2, "em_steps": 10},
             "warmup": {"warmup_steps": 50, "warmup_chains": 2}, "sample_from_prior": False},
    "model": {"clusters": 1, "confounders": ["universal", "family"], "prior": {
        "objects_per_cluster": {"type": "uniform_area", "min": 1, "max": 100},
        "geo": {"type": "cost_based", "aggregation": "sum", "rate": 50000.0},
        "weights": {"type": "uniform"}, "cluster_effect": {"type": "uniform"},
        "confounding_effects": {
            "universal": {"<ALL>": {"type": "uniform"}},
            "family": {"famA": {"type": "dirichlet", "parameters": {
                "F1": {"A": 8.0, "B": 2.0, "C": 1.0}, "F2": {"X": 2.0, "Y": 3.0}}},
                "famB": {"type": "uniform"}}}}}}
LOGLH_TOL_REL = 1e-5             # lgammaf vs torch.lgamma, summation order (of the total)
MARGINAL_TOL_ABS = 1e-4          # 36 logs summed in another order (per object)
MARGINAL_TOL_FEATURES = 36       # wider data: the tolerance grows with the logs summed


def stop_resource_tracker():
    """Stop multiprocessing's resource tracker and wait for it. The spawn
    pool of ``-t 2`` starts it in this process, and it would outlive the
    script: Python 3.12.3 gives it no finalizer (3.12.12 does), so it ends
    only once this process is gone, as an orphan. The pool's semaphores are
    collected first, so that none of them starts it again when finalized."""
    from multiprocessing import resource_tracker

    gc.collect()
    resource_tracker._resource_tracker._stop()


def child_processes() -> list:
    """This process's child processes, zombies included, as (pid, command)."""
    me, out = os.getpid(), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            stat = Path(f"/proc/{pid}/stat").read_text()
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ").decode()
        except OSError:                               # ended while being read
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            out.append((int(pid), cmd.strip() or stat.split()[1]))
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def smoke_config(path: Path, results: Path, n_clusters: int = 1, geo: dict = None,
                 mcmc: dict = None, name: str = None, results_cfg: dict = None,
                 data: dict = None) -> Path:
    """A model configuration as a JSON config file (default: K = 1, uniform
    geo; ``mcmc`` updates the MCMC section, ``results_cfg`` the results
    section); without ``data`` (the data section) the data come from
    ``synthetic_data`` and the data paths are placeholders, never read."""
    if data is None:
        placeholder = path / "features.csv"
        placeholder.write_text("id\n")
        data = {"features": str(placeholder), "feature_states": str(placeholder)}
    cfg = {
        "data": data,
        "model": {
            "clusters": n_clusters,
            "confounders": ["universal", "family"],
            "prior": {
                "objects_per_cluster": {"type": "uniform_area", "min": 2, "max": 50},
                "geo": geo or {"type": "uniform"},
                "weights": {"type": "uniform"},
                "cluster_effect": {"type": "uniform"},
                "confounding_effects": {
                    "universal": {"<ALL>": {"type": "uniform"}},
                    "family": {"<DEFAULT>": {"type": "uniform"}},
                },
            },
        },
        "mcmc": {
            "steps": 2000, "samples": 20, "runs": 8, "screen_log_interval": 1000,
            "warmup": {"warmup_steps": 200, "warmup_chains": 4},
        },
        "results": {"path": str(results), "log_likelihood": False, "log_file": False},
    }
    cfg["mcmc"].update(mcmc or {})
    cfg["results"].update(results_cfg or {})
    cfg_path = path / f"{name or f'config_K{n_clusters}'}.json"
    cfg_path.write_text(json.dumps(cfg))
    return cfg_path


def reset_counters():
    from sbayes_tpu_torch.ops import loglh, marginal

    for counter in (loglh.launches, loglh.counts_launches, loglh.from_counts_launches,
                    marginal.launches):
        counter.reset()


def counters() -> dict:
    from sbayes_tpu_torch.ops import loglh, marginal

    out = {"loglh": loglh.launches.count}
    if loglh.launches.variants.get("packed"):
        out["loglh_packed"] = loglh.launches.variants["packed"]
    # the object split's two entries of the likelihood kernel (data_mesh)
    for name, counter in (("loglh_counts", loglh.counts_launches),
                          ("loglh_from_counts", loglh.from_counts_launches)):
        if counter.count:
            out[name] = counter.count
    for key, n in marginal.launches.variants.items():
        out[marginal.variant_name(*key)] = n
    return out


def phase_main_path(tmp: Path, n_clusters: int = 1, geo: dict = None) -> dict:
    """sample_ensemble over 8 runs, as ``cli.main`` runs ``mcmc.runs > 1``."""
    from sbayes_tpu_torch.experiment import Experiment
    from sbayes_tpu_torch.sampling.runner import MCMCSetup
    from sbayes_tpu_torch.testing import synthetic_data

    cfg_path = smoke_config(tmp, tmp / "results", n_clusters, geo)
    experiment = Experiment(config_file=cfg_path, experiment_name=f"smoke_K{n_clusters}",
                            log=True)
    data = synthetic_data()
    mcmc = MCMCSetup(data=data, experiment=experiment, device=DEVICE)
    runs = list(range(experiment.config.mcmc.runs))
    reset_counters()
    t0 = time.perf_counter()
    mcmc.sample_ensemble(run_ids=runs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    n_samples = experiment.config.mcmc.samples
    for r in runs:
        for prefix, suffix in [("stats", "txt"), ("clusters", "txt"),
                               ("operator_stats", "txt"), ("state", "pickle")]:
            f = mcmc.get_results_file_path(prefix, r, suffix=suffix)
            if not f.is_file():
                raise AssertionError(f"missing results file {f}")
        lines = mcmc.get_results_file_path("stats", r).read_text().splitlines()
        if len(lines) != n_samples + 1:
            raise AssertionError(f"stats file of run {r}: {len(lines)} lines")
        header = lines[0].split("\t")
        last = dict(zip(header, lines[-1].split("\t")))
        for col in ("posterior", "likelihood", "prior"):
            v = float(last[col])
            if v != v or abs(v) == float("inf"):
                raise AssertionError(f"run {r}: non-finite {col} {v}")
        stats_file = mcmc.get_results_file_path("stats", r)
        if stats_file.parent.name != f"K{n_clusters}":
            raise AssertionError(f"results of K = {n_clusters} under {stats_file.parent}")
        if [c for c in header if c.startswith("size_a")] != [f"size_a{i}"
                                                             for i in range(n_clusters)]:
            raise AssertionError(f"run {r}: cluster size columns of {header[:8]}")
        geo_col = [float(line.split("\t")[header.index("geo_prior")]) for line in lines[1:]]
        if (geo is not None) != any(v != 0.0 for v in geo_col):
            raise AssertionError(f"run {r}: geo_prior column {geo_col[:3]}... under {geo}")
        for row in mcmc.get_results_file_path("clusters", r).read_text().splitlines():
            cols = row.split("\t")
            if len(cols) != n_clusters or any(set(c) - {"0", "1"} for c in cols):
                raise AssertionError(f"run {r}: clusters row with {len(cols)} columns")
    need = ["loglh", "marginal"] + (["marginal_abs"] if n_clusters > 1 else [])
    if any(launches.get(k, 0) == 0 for k in need):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    return {"runs": len(runs), "K": n_clusters, "geo": geo or {"type": "uniform"},
            "wall_s": wall, "launches": launches}


@contextmanager
def synthetic_data_for_cli():
    """``cli.main`` loads the data files its config names; for the phases
    that sample ``synthetic_data()``'s arrays (the same data as the
    ``full_width`` phases) they stay placeholders, and the data come from
    ``synthetic_data`` instead. The ``workflow`` phase reads CSV files."""
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.testing import synthetic_data

    saved = Data.__dict__["from_experiment"]
    Data.from_experiment = classmethod(lambda cls, experiment: synthetic_data())
    try:
        yield
    finally:
        Data.from_experiment = saved


@contextmanager
def last_call(cls, name: str):
    """Record the arguments and the result of the last call of method
    ``name`` of ``cls`` (with its instance) in the yielded dict."""
    orig = getattr(cls, name)
    seen = {}

    def wrapped(self, *args, **kw):
        out = orig(self, *args, **kw)
        seen.update(runtime=self, args=args, out=out)
        return out

    setattr(cls, name, wrapped)
    try:
        yield seen
    finally:
        setattr(cls, name, orig)


def stats_column(path: Path, col: str) -> list:
    lines = path.read_text().splitlines()
    i = lines[0].split("\t").index(col)
    return [line.split("\t")[i] for line in lines[1:]]


def ladder_temperatures(n_chains: int):
    """The temperatures of ``MC3_LADDER``'s rungs, each repeated for
    ``n_chains / rungs`` consecutive chains, on the card."""
    from sbayes_tpu_torch.config.schema import MC3Config
    from sbayes_tpu_torch.sampling.runner import temperature_ladder

    temps, _ = temperature_ladder(MC3Config.from_dict({"activate": True, **MC3_LADDER}))
    return torch.as_tensor(temps, dtype=torch.float32, device=DEVICE).repeat_interleave(
        n_chains // MC3_LADDER["chains"])


def phase_main_path_mc3(tmp: Path) -> dict:
    """``cli.main`` with ``mcmc.mc3.activate`` at K = 3, cost-based geo: the
    cold rung's files, ``hot_chains/`` for rungs 1..7 and the swap matrix;
    the heat variant of the marginal launched; the swap acceptance overall
    (strictly between 0 and 1) and per rung; the ladder's carried state after
    the last swap phase against its recompute."""
    from sbayes_tpu_torch import cli
    from sbayes_tpu_torch.sampling.runner import ShardedRuntime

    n_rungs = MC3_LADDER["chains"]
    mc3 = {"activate": True, "swap_interval": 50, **MC3_LADDER}
    cfg_path = smoke_config(tmp, tmp / "results", 3, GEO_K3, name="config_mc3", mcmc={
        "runs": 1, "mc3": mc3, "warmup": {"warmup_steps": 200, "warmup_chains": 10}})
    reset_counters()
    t0 = time.perf_counter()
    with synthetic_data_for_cli(), last_call(ShardedRuntime, "run_mc3_chunk") as seen:
        cli.main(cfg_path, experiment_name="smoke_mc3", device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    out = tmp / "results" / "smoke_mc3" / "K3"
    files = [out / "stats_K3_0.txt"] + [out / "hot_chains" / f"stats_K3_0.chain{c}.txt"
                                       for c in range(1, n_rungs)]
    for f in files:
        if len(f.read_text().splitlines()) != 21:
            raise AssertionError(f"{f.name}: not 20 samples")
    if any(float(v) == 0.0 for v in stats_column(files[0], "geo_prior")):
        raise AssertionError("MC3 cold rung: a geo_prior of 0 under the cost-based prior")
    swaps = np.loadtxt(out / "mc3_swaps_K3_0.txt")
    counts = seen["args"][6]                      # (2, n, n) accepts and attempts, cumulative
    if swaps.shape != (n_rungs, n_rungs) or not swaps.sum() > 0 or (swaps != counts[0]).any():
        raise AssertionError(f"swap matrix {swaps.shape}, sum {swaps.sum()}")
    rate = float(counts[0].sum() / counts[1].sum())
    if not 0.0 < rate < 1.0:
        raise AssertionError(f"swap acceptance {rate}")
    need = ["loglh", "marginal", "marginal_heat", "marginal_abs"]
    if any(launches.get(k, 0) == 0 for k in need):
        raise AssertionError(f"a kernel of the MC3 path never launched: {launches}")
    sh = seen["runtime"]
    errs = check_shards(sh, *seen["out"][:2], sh.rt.op_names.index("cluster_jump_gibbsish"))
    return {"K": 3, "rungs": n_rungs, "mc3": mc3, "wall_s": wall, "launches": launches,
            "swap_accept_rate": rate, "swap_attempts": int(counts[1].sum()),
            "swap_accept_rate_by_rung": {
                f"{i}<->{i + 1}": float(counts[0, i, i + 1] / max(counts[1, i, i + 1], 1))
                for i in range(n_rungs - 1)},
            "carried_vs_recompute_max_abs": errs}


def phase_resume(tmp: Path) -> dict:
    """K = 3, cost-based geo: ``cli.main`` for 500 steps / 10 samples, then
    ``cli.main(..., resume=True)`` for 1000 / 20: 20 rows with continuous
    sample ids and the resumed run's carried state equal to its recompute;
    the same for an MC3 ladder of four rungs, each resuming from its pickle."""
    from sbayes_tpu_torch import cli
    from sbayes_tpu_torch.sampling.runner import ShardedRuntime

    out = {}
    for label, method, mc3 in (("single", "run_chunk", None),
                               ("mc3", "run_mc3_chunk", {"activate": True, "chains": 4,
                                                         "swap_interval": 50,
                                                         "temperature_diff": 0.1})):
        mcmc = {"runs": 1, "warmup": {"warmup_steps": 100, "warmup_chains": 4}}
        if mc3:
            mcmc["mc3"] = mc3
        name = f"resume_{label}"
        first = smoke_config(tmp, tmp / "results", 3, GEO_K3, name=f"{name}_first",
                             mcmc={**mcmc, "steps": 500, "samples": 10})
        second = smoke_config(tmp, tmp / "results", 3, GEO_K3, name=f"{name}_second",
                              mcmc={**mcmc, "steps": 1000, "samples": 20})
        t0 = time.perf_counter()
        with synthetic_data_for_cli():
            cli.main(first, experiment_name=name, device=DEVICE)
            with last_call(ShardedRuntime, method) as seen:
                cli.main(second, experiment_name=name, resume=True, device=DEVICE)
        torch.cuda.synchronize()
        res = tmp / "results" / name / "K3"
        files = [res / "stats_K3_0.txt"] + ([res / "hot_chains" / f"stats_K3_0.chain{c}.txt"
                                             for c in range(1, mc3["chains"])] if mc3 else [])
        for f in files:
            ids = [int(v) for v in stats_column(f, "Sample")]
            if ids != list(range(50, 1001, 50)):
                raise AssertionError(f"{name}: {f.name} has samples {ids}")
        out[label] = {"wall_s": time.perf_counter() - t0, "rows": len(files) * 20,
                      "carried_vs_recompute_max_abs": check_shards(seen["runtime"],
                                                                   *seen["out"][:2])}
    # Without the pickle (deleted, as when a run wrote none) the run resumes
    # from its clusters and stats files at the last sample + 1, as the JAX
    # package does; pandas is made unimportable for it (as it is on a
    # machine without pandas).
    name = "resume_no_pickle"
    mcmc = {"runs": 1, "warmup": {"warmup_steps": 100, "warmup_chains": 4}}
    first = smoke_config(tmp, tmp / "results", 3, GEO_K3, name=f"{name}_first",
                         mcmc={**mcmc, "steps": 500, "samples": 10})
    second = smoke_config(tmp, tmp / "results", 3, GEO_K3, name=f"{name}_second",
                          mcmc={**mcmc, "steps": 1000, "samples": 20})
    res = tmp / "results" / name / "K3"
    t0 = time.perf_counter()
    with synthetic_data_for_cli():
        cli.main(first, experiment_name=name, device=DEVICE)
        (res / "state_K3_0.pickle").unlink()
        with last_call(ShardedRuntime, "run_chunk") as seen, without_module("pandas"):
            cli.main(second, experiment_name=name, resume=True, device=DEVICE)
    torch.cuda.synchronize()
    ids = [int(v) for v in stats_column(res / "stats_K3_0.txt", "Sample")]
    if ids != list(range(50, 501, 50)) + list(range(551, 1002, 50)):
        raise AssertionError(f"{name}: samples {ids}")
    if not (res / "state_K3_0.pickle").exists():
        raise AssertionError(f"{name}: the resumed run wrote no pickle")
    out["no_pickle"] = {"wall_s": time.perf_counter() - t0, "rows": len(ids),
                        "pandas_blocked": True,
                        "carried_vs_recompute_max_abs": check_shards(seen["runtime"],
                                                                     *seen["out"][:2])}
    return out


@contextmanager
def without_module(name: str):
    """``import name`` raises ImportError inside the block."""
    saved = sys.modules.get(name)
    sys.modules[name] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules[name]
        else:
            sys.modules[name] = saved


def phase_init_methods(tmp: Path) -> dict:
    """``cli.main`` at K = 3 (cost-based geo, 2 runs as one ensemble) with the
    ``seed_points`` initializer, then with ``random_growth`` and
    ``log_contribution_per_cluster``: the results files, cluster sizes
    within their bounds, the likelihood kernel launched (the initializer's
    best of attempts), and with the contribution ``post_a* = lh_a* +
    prior_a*`` in every row."""
    from sbayes_tpu_torch import cli

    out = {}
    for method, contrib in (("seed_points", False), ("random_growth", True)):
        name = f"init_{method}"
        cfg_path = smoke_config(tmp, tmp / "results", 3, GEO_K3, name=name, mcmc={
            "runs": 2, "steps": 500, "samples": 10,
            "initialization": {"method": method},
            "warmup": {"warmup_steps": 100, "warmup_chains": 4}},
            results_cfg={"log_contribution_per_cluster": contrib})
        reset_counters()
        t0 = time.perf_counter()
        with synthetic_data_for_cli():
            cli.main(cfg_path, experiment_name=name, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters()
        if launches.get("loglh", 0) == 0:
            raise AssertionError(f"{method}: the likelihood kernel never launched: {launches}")
        res = tmp / "results" / name / "K3"
        for run in (0, 1):
            lines = (res / f"stats_K3_{run}.txt").read_text().splitlines()
            header = lines[0].split("\t")
            if len(lines) != 11:
                raise AssertionError(f"{method}: stats file of run {run} has {len(lines)} lines")
            for line in lines[1:]:
                row = dict(zip(header, line.split("\t")))
                sizes = [int(row[f"size_a{i}"]) for i in range(3)]
                if min(sizes) < 2 or max(sizes) > 50:
                    raise AssertionError(f"{method}: cluster sizes {sizes}")
                if not contrib:
                    continue
                for i in range(3):
                    lh, prior, post = (float(row[f"{k}_a{i}"]) for k in ("lh", "prior", "post"))
                    if not (lh < 0 and abs(post - (lh + prior)) <= 1e-4 + 1e-5 * abs(post)):
                        raise AssertionError(f"contribution of cluster {i}: {lh}, {prior}, {post}")
        out[method] = {"wall_s": wall, "launches": launches,
                       "contribution_columns": [c for c in header if c.rsplit("_a", 1)[0] in
                                                ("post", "lh", "prior") and "_a" in c]}
    return out


def workflow_canvas(path: Path) -> np.ndarray:
    """A canvas of WORKFLOW's sites (x, y uniform in [0, 10] with two
    decimals, as ``tests/test_tools.py::test_simulation_roundtrip`` writes
    them; longitude and latitude in degrees under the config's
    ``epsg:4326``): each true cluster the sites nearest one of
    WORKFLOW's centres, a ``family`` column of ``families`` groups with
    every seventh site in none, and the ``universal`` column the
    simulation's universal effect needs (one group, ``<ALL>``). Returns the
    (clusters, sites) truth."""
    w = WORKFLOW
    rng = np.random.default_rng(w["seed"])
    xy = rng.uniform(0, 10, (w["sites"], 2)).round(2)
    label = np.zeros(w["sites"], dtype=int)
    for c, centre in enumerate(w["centres"], start=1):
        free = np.flatnonzero(label == 0)
        near = free[np.argsort(np.linalg.norm(xy[free] - centre, axis=1))[:w["cluster_size"]]]
        label[near] = c
    family = [("" if i % 7 == 0 else f"fam{rng.integers(w['families'])}")
              for i in range(w["sites"])]
    rows = ["id,x,y,cluster,universal,family"] + [
        f"s{i},{xy[i, 0]:.2f},{xy[i, 1]:.2f},{label[i]},<ALL>,{family[i]}"
        for i in range(w["sites"])]
    path.write_text("\n".join(rows) + "\n")
    return np.stack([label == c for c in range(1, len(w["centres"]) + 1)])


def best_f1(truth: np.ndarray, clusters_file: Path) -> list:
    """For each true cluster, the best F1 against the run's clusters: each
    inferred cluster's members are the objects in it in at least half of
    the second half of the samples."""
    from sbayes_tpu_torch.utils import parse_cluster_columns

    rows = clusters_file.read_text().splitlines()
    samples = np.stack([parse_cluster_columns(r) for r in rows[len(rows) // 2:]])
    inferred = samples.mean(axis=0) >= 0.5                    # (K, N)
    hits = truth.astype(int) @ inferred.T.astype(int)       # (true, inferred)
    f1 = 2 * hits / (truth.sum(1)[:, None] + inferred.sum(1)[None, :]).clip(min=1)
    return f1.max(axis=1).round(4).tolist()


@contextmanager
def launches_per_k():
    """The launch counts of each ``MCMCSetup.sample_ensemble`` call, by its
    K, in the yielded dict (the counts are not reset)."""
    from sbayes_tpu_torch.sampling.runner import MCMCSetup

    orig = MCMCSetup.sample_ensemble
    by_k = {}

    def wrapped(self, *args, **kw):
        before = counters()
        out = orig(self, *args, **kw)
        after = counters()
        by_k[f"K{self.model.n_clusters}"] = {k: n - before.get(k, 0) for k, n in after.items()}
        return out

    MCMCSetup.sample_ensemble = wrapped
    try:
        yield by_k
    finally:
        MCMCSetup.sample_ensemble = orig


def phase_workflow(tmp: Path) -> dict:
    """A user's workflow through the port's entry points, its data as CSV
    files read by the loader (no patch of the data load): a canvas, the
    simulation, the universal prior counts extracted from the simulated
    CSVs, ``cli.main`` at K = 1 and 3 (main_path's runs and steps, the
    cost-based geo prior on the simulated locations, the extracted counts as
    the universal prior), recovery of the true clusters at K = 3, thinning,
    and the config template."""
    from dataclasses import fields

    from sbayes_tpu_torch import cli, simulation
    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.config.template import generate_template
    from sbayes_tpu_torch.tools.extract_prior_counts import extract_universal
    from sbayes_tpu_torch.tools.subsample import subsample_file

    w = WORKFLOW
    d = tmp / "workflow"
    d.mkdir()
    wall = {}
    t0 = time.perf_counter()
    truth = workflow_canvas(d / "canvas.csv")
    (d / "sim_config.json").write_text(json.dumps({
        "canvas": "canvas.csv", "results": {"path": "sim"}, "n_features": w["features"],
        "n_states": w["n_states"], "cluster_effect": w["cluster_effect"],
        "confounding_effects": w["confounding_effects"], "seed": w["seed"]}))
    with np.errstate(invalid="ignore"):     # sites in no family and no cluster: 0 / 0
        simulation.main(d / "sim_config.json")
    sim = d / "sim"
    if not np.array_equal(np.loadtxt(sim / "ground_truth_clusters.txt").astype(bool), truth):
        raise AssertionError("the simulation's ground truth is not the canvas's clusters")
    wall["simulate_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    extract_universal(sim / "simulated_features.csv", sim / "simulated_feature_states.csv",
                      d / "universal.json")
    wall["extract_prior_counts_s"] = time.perf_counter() - t0

    # no per-operator timing probe (two per K): it keeps the phase under 60 s
    cfg_path = smoke_config(d, d / "results", geo=GEO_K3, name="config", data={
        "features": "sim/simulated_features.csv",
        "feature_states": "sim/simulated_feature_states.csv", "projection": "epsg:4326"},
        results_cfg={"log_operator_step_times": False})
    cfg = json.loads(cfg_path.read_text())
    cfg["model"]["prior"]["confounding_effects"]["universal"]["<ALL>"] = {
        "type": "dirichlet", "file": "universal.json"}
    cfg_path.write_text(json.dumps(cfg))
    reset_counters()
    t0 = time.perf_counter()
    with launches_per_k() as by_k:
        cli.main(cfg_path, experiment_name="workflow", n_clusters=[1, 3],
                 device=DEVICE)
    torch.cuda.synchronize()
    wall["cli_s"] = time.perf_counter() - t0
    launches = counters()
    runs, n_samples = cfg["mcmc"]["runs"], cfg["mcmc"]["samples"]
    res = d / "results" / "workflow"
    for k in (1, 3):
        need = ["loglh", "marginal"] + (["marginal_abs"] if k == 3 else [])
        if any(by_k.get(f"K{k}", {}).get(name, 0) == 0 for name in need):
            raise AssertionError(f"a kernel of the workflow never launched at K = {k}: {by_k}")
        for r in range(runs):
            lines = (res / f"K{k}" / f"stats_K{k}_{r}.txt").read_text().splitlines()
            if len(lines) != n_samples + 1:
                raise AssertionError(f"K = {k}, run {r}: {len(lines)} lines in the stats file")
            header = lines[0].split("\t")
            if [c for c in header if c.startswith("size_a")] != [f"size_a{i}" for i in range(k)]:
                raise AssertionError(f"K = {k}, run {r}: cluster size columns of {header[:8]}")
            for line in lines[1:]:
                row = dict(zip(header, line.split("\t")))
                values = [float(row[c]) for c in ("posterior", "likelihood", "prior",
                                                  "geo_prior")]
                if not np.all(np.isfinite(values)) or values[3] == 0.0:
                    raise AssertionError(f"K = {k}, run {r}: posterior, likelihood, prior, "
                                         f"geo prior {values}")
            cols = (res / f"K{k}" / f"clusters_K{k}_{r}.txt").read_text().splitlines()
            if len(cols) != n_samples or any(len(c.split("\t")) != k for c in cols):
                raise AssertionError(f"K = {k}, run {r}: clusters file of {len(cols)} rows")

    f1_runs = [best_f1(truth, res / "K3" / f"clusters_K3_{r}.txt") for r in range(runs)]
    if max(f1_runs[0]) < 0.5:
        raise AssertionError(f"no true cluster recovered at F1 >= 0.5 by run 0: {f1_runs}")

    t0 = time.perf_counter()
    thinned = [subsample_file(res / "K3" / f"{p}_K3_0.txt", 2) for p in ("stats", "clusters")]
    n_rows = [len(f.read_text().splitlines()) for f in thinned]
    if n_rows != [1 + (n_samples + 1) // 2, (n_samples + 1) // 2]:
        raise AssertionError(f"thinned stats and clusters files of {n_rows} rows")
    wall["subsample_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    template = generate_template().splitlines()
    sections = [f.name for f in fields(SBayesConfig)]
    if [line[:-1] for line in template if line.endswith(":") and not line[0] in " #"] != sections:
        raise AssertionError(f"the template's top-level sections are not {sections}")
    wall["template_s"] = time.perf_counter() - t0
    return {"sites": w["sites"], "features": w["features"], "K": [1, 3], "runs": runs,
            "steps": cfg["mcmc"]["steps"], "wall": wall, "launches": launches,
            "launches_by_k": by_k, "f1_run0": f1_runs[0],
            "f1_best_over_runs": np.max(f1_runs, axis=0).tolist(),
            "thinned_rows": n_rows, "template_lines": len(template)}


def check_carried_state(consts, states, ref, stats, jump_idx=None, init_sizes=None) -> dict:
    """The carried invariants of ``states`` against the exact recompute
    ``ref``; raises on a violation, returns the largest differences.
    ``init_sizes`` (B, K): the sizes the run started from; a cluster that
    the EM initializer left out of its bounds (both packages, ROADMAP C.4)
    may only have moved towards them."""
    # (absolute, relative) tolerance: the counts are exact integers; the f32
    # running totals take one rounding per accepted move.
    tol = {"log_lh": (1e-3, 1e-4), "log_prior": (1e-3, 1e-4), "cl_counts": (0.0, 0.0),
           "conf_counts": (0.0, 0.0), "pat_counts": (0.0, 0.0)}
    errs = {}
    for key, (atol, rtol) in tol.items():
        a, b = getattr(states, key), getattr(ref, key)
        err = float((a - b).abs().max())
        errs[key] = err
        limit = atol + rtol * float(b.abs().max())
        if not err <= limit:
            raise AssertionError(f"carried {key} differs from the recompute by {err} > {limit}")
    if ref.geo_agg is not None:
        # The skeleton aggregates [total, n_edges, max_edge] are re-derived per
        # changed cluster (sums in another order): each entry within 1e-3 of
        # its own recompute, the edge counts exactly.
        a, b = states.geo_agg, ref.geo_agg
        if not torch.equal(a[..., 1], b[..., 1]):
            raise AssertionError("carried geo_agg: an edge count differs from the recompute")
        rel = ((a - b).abs() / b.abs().clamp(min=1e-30)).max()
        errs["geo_agg"], errs["geo_agg_rel"] = float((a - b).abs().max()), float(rel)
        if not bool(((a - b).abs() <= 1e-3 * b.abs()).all()):
            raise AssertionError(f"carried geo_agg differs from the recompute by {float(rel)} "
                                 "relative > 1e-3")
    if int(stats.non_finite.sum()) != 0:
        raise AssertionError("non-finite posterior accepted")
    if int((states.clusters.sum(1) > 1).sum()) != 0:
        raise AssertionError("an object is in two clusters")
    sizes = states.clusters.sum(-1)
    low, high = consts.min_size, consts.max_size
    if init_sizes is not None:
        low = torch.clamp(init_sizes, max=low)
        high = torch.clamp(init_sizes, min=high)
    if bool((sizes < low).any()) or bool((sizes > high).any()):
        raise AssertionError(f"cluster sizes {int(sizes.min())}..{int(sizes.max())} leave "
                             f"[{consts.min_size}, {consts.max_size}]")
    errs["size_min"], errs["size_max"] = int(sizes.min()), int(sizes.max())
    if jump_idx is not None:
        acc = float(stats.accepts[:, jump_idx].sum())
        rate = acc / float((stats.accepts + stats.rejects)[:, jump_idx].sum())
        if not 0.0 < rate < 1.0:
            raise AssertionError(f"jump acceptance rate {rate}")
        errs["jump_accept_rate"] = rate
    return errs


def full_width_runtime(n_clusters: int, geo_prior: str):
    """The sampler of the south_america-shaped synthetic model at K =
    ``n_clusters`` with the uniform or the ``GEO_K3`` geo prior."""
    from sbayes_tpu_torch.config.schema import MCMCConfig
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    cfg = synthetic_config(n_clusters=n_clusters, geo_prior=geo_prior, **(
        {"rate": GEO_K3["rate"], "aggregation": GEO_K3["aggregation"]}
        if geo_prior == "cost_based" else {}))
    model = Model(synthetic_data(), cfg.model, device=DEVICE)
    return SamplerRuntime(model, MCMCConfig.from_dict({"steps": 1000, "samples": 5}))


def phase_full_width(n_chains: int, n_steps: int, n_clusters: int = 1,
                     geo_prior: str = "uniform", temps=None) -> tuple:
    """init_chains(n) + n_steps steps in chunks of 200 + an exact refresh;
    ``temps`` (n,): per-chain likelihood and prior temperatures (an MC3
    ladder's, without swaps), else unit temperatures."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = full_width_runtime(n_clusters, geo_prior)
    model = rt.model
    gen, op_gen = make_generators(7, DEVICE)
    reset_counters()
    t0 = time.perf_counter()
    states = rt.init_chains(gen, n_chains)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    stats = rt.new_stats(n_chains)
    chunk = 200
    t0 = time.perf_counter()
    for _ in range(n_steps // chunk):
        states, stats = rt.run_chunk(gen, op_gen, states, stats, chunk, temps, temps)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = counters()
    ref = rt.refresh(states)
    torch.cuda.synchronize()
    c = model.consts
    jump_idx = rt.op_names.index("cluster_jump_gibbsish") if n_clusters > 1 else None
    errs = check_carried_state(c, states, ref, stats, jump_idx)
    need = (["loglh", "marginal"] + (["marginal_abs"] if n_clusters > 1 else [])
            + (["marginal_heat"] if temps is not None else []))
    if any(launches.get(k, 0) == 0 for k in need):
        raise AssertionError(f"a kernel was not launched at full width: {launches}")
    accepts, total = stats.accepts.sum(0).float(), (stats.accepts + stats.rejects).sum(0).float()
    info = {"chains": n_chains, "N": c.N, "F": c.F, "S": c.S, "C": c.C, "Gmax": c.Gmax,
            "K": c.K, "geo": geo_prior, "operators": rt.op_names,
            "temperatures": None if temps is None else sorted(set(temps.tolist())),
            "accept_rate_by_operator": dict(zip(rt.op_names, (accepts / total).tolist())),
            "steps": n_steps, "init_s": t_init, "run_s": t_run,
            "steps_per_s": n_steps / t_run, "chain_steps_per_s": n_chains * n_steps / t_run,
            "launches": launches, "launches_per_step": {k: v / n_steps for k, v in
                                                        launches.items()},
            "carried_vs_recompute_max_abs": errs,
            "accept_rate": float(stats.accepts.sum()) / float(
                (stats.accepts + stats.rejects).sum())}
    return rt, ref, info


def phase_where_time_goes(rt, states, reps: int = 10, temps=None) -> dict:
    """Per-operator wall time of one MH step of the whole batch (each
    operator alone, synchronised), and over a 50-step window of the schedule
    the device-busy share and CUDA kernels per step from torch.profiler;
    ``temps``: per-chain temperatures, as in ``phase_full_width``."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    gen, op_gen = make_generators(11, DEVICE)
    apply = rt.apply_fn(temps, temps)
    op_ms = {}
    for i, name in enumerate(rt.op_names):
        st = apply(i, gen, states)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            st = apply(i, gen, st)[0]
        torch.cuda.synchronize()
        op_ms[name] = (time.perf_counter() - t0) / reps * 1e3
    n_steps = 50
    stats = rt.new_stats(states.n_chains)
    rt.run_chunk(gen, op_gen, states, stats, 5, temps, temps)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rt.run_chunk(gen, op_gen, states, stats, n_steps, temps, temps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0 and e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    prim = update_geo_cost(rt, states) if states.geo_agg is not None else None
    return {"op_ms_per_step": op_ms, "schedule_weights": rt.op_weights.tolist(),
            "update_geo": prim,
            "window_steps": n_steps, "window_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms if busy_ms else None,
            "kernels_per_step": sum(e.count for e in kernels) / n_steps,
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top}}


def update_geo_cost(rt, states, reps: int = 10) -> dict:
    """Launches and wall time of one ``_update_geo`` of one cluster per chain
    (the batched Prim of ``ops/mst.py`` on the chains' own clusters), with
    the whole update beside the Prim alone."""
    from sbayes_tpu_torch.ops.mst import cluster_mst_stats
    from sbayes_tpu_torch.sampling.operators import OperatorFactory

    c = rt.consts
    factory = OperatorFactory(rt.cond)
    i_cluster = torch.zeros(states.n_chains, dtype=torch.long, device=states.clusters.device)
    masks = states.clusters[:, 0]
    forms = {"update_geo": lambda: factory._update_geo(states.geo_agg, states.clusters,
                                                       i_cluster),
             "prim": lambda: cluster_mst_stats(c.cost_matrix, masks)}
    out = {"batch_max_size": int(masks.sum(-1).max()),
           "prim_iterations": max(int(masks.sum(-1).max()) - 1, 0)}
    for name, fn in forms.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        out[name] = {"wall_ms": wall_ms, "launches": sum(e.count for e in events),
                     "device_ms": sum(e.self_device_time_total for e in events) / 1e3}
    return out


def phase_jump_512(n_chains: int = 64, n_steps: int = 50) -> dict:
    """The jump alone at 512 features (K = 2, cost-based geo prior), where it
    takes its log-space form: two random clusters of 10 objects per chain
    with a Gibbs-sampled source, then ``n_steps`` MH steps of the one operator; the two-effect ratio marginal
    must have been launched, and the carried state must equal its recompute."""
    from sbayes_tpu_torch.model.math import normalize_weights, sample_categorical_onehot
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.conditionals import Conditionals
    from sbayes_tpu_torch.sampling.kernel import OperatorStats, make_mh_apply_fn
    from sbayes_tpu_torch.sampling.operators import OperatorFactory, OperatorSpec
    from sbayes_tpu_torch.sampling.runner import make_generators
    from sbayes_tpu_torch.sampling.state import ChainState
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    cfg = synthetic_config(n_clusters=2, geo_prior="cost_based", rate=GEO_K3["rate"],
                           aggregation=GEO_K3["aggregation"])
    model = Model(synthetic_data(n_features=512), cfg.model, device=DEVICE)
    c = model.consts
    cond = Conditionals(model.posterior)
    factory = OperatorFactory(cond)
    gen, _ = make_generators(13, DEVICE)
    # Start: two random disjoint clusters of 10 objects per chain, uniform
    # weights, a source drawn from the prior and one full Gibbs pass over it.
    # (At this width the initializer's EM puts up to 72 of the 100 objects
    # into one cluster, beyond max_size = 50, and no jump repairs that.)
    order = torch.argsort(torch.rand((n_chains, c.N), generator=gen, device=c.device), dim=-1)
    clusters = torch.stack([(order < 10), (order >= 10) & (order < 20)], dim=1)
    weights = torch.full((n_chains, c.F, c.C), 1.0 / c.C, device=c.device)
    source = sample_categorical_onehot(
        gen, normalize_weights(weights, cond.post.has_components(clusters))
    ) & ~c.na[None, :, :, None]
    minus_inf = torch.full((n_chains,), float("-inf"), device=c.device)
    states = ChainState(clusters, weights, source, minus_inf, minus_inf,
                        torch.full((n_chains, 4), float("-inf"), device=c.device))
    states = factory.make_gibbs_sample_source("all", max_size=c.N)(gen, states).state
    states = cond.post.fill_state(states)
    spec = OperatorSpec("cluster_jump_gibbsish", 1.0, factory.make_cluster_jump(), "clusters")
    apply = make_mh_apply_fn(cond, [spec])
    stats = OperatorStats.zeros(n_chains, 1, c.device)
    reset_counters()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        states, accept, step_size, nf = apply(0, gen, states)
        stats = stats.record(0, accept, step_size, nf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    if launches.get("marginal_two_eff", 0) != 2 * n_steps or launches.get("marginal_abs", 0):
        raise AssertionError(f"the jump at {c.F} features launched {launches}")
    errs = check_carried_state(c, states, cond.post.fill_state(states), stats, jump_idx=0)
    inputs = jump_kernel_inputs(cond, states)
    kernel_errs = compare_with_plain(c, inputs)
    return {"chains": n_chains, "N": c.N, "F": c.F, "K": c.K, "steps": n_steps, "wall_s": wall,
            "launches": launches, "carried_vs_recompute_max_abs": errs,
            "kernels_vs_plain": kernel_errs, "two_eff": time_marginal_variant(
                c, inputs, (True, False, True), n_chains)}


def scale_runtime(data=None, geo_prior: str = "uniform"):
    """The scale workload of ``benchmarks/scale10k.py``: 10,000 objects x 5,000
    features x 5 states, universal + 10 families, K = 5, uniform geo prior
    (or ``GEO_K3`` with ``geo_prior="cost_based"``), sizes 10-3000, EM
    initialization (1 attempt, 3 EM steps, 200 objects per cluster), on
    ``data`` (None: drawn here); (runtime, data seconds, model seconds)."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime
    from sbayes_tpu_torch.testing import synthetic_config
    from sbayes_tpu_torch.testing_scale import synthetic_data_large

    t0 = time.perf_counter()
    if data is None:
        data = synthetic_data_large(**SCALE_SHAPE, seed=0)
    t_data = time.perf_counter() - t0
    cfg = synthetic_config(n_clusters=5, geo_prior=geo_prior, **(
        {"rate": GEO_K3["rate"], "aggregation": GEO_K3["aggregation"]}
        if geo_prior == "cost_based" else {}))
    cfg.model.prior.objects_per_cluster.min = 10
    cfg.model.prior.objects_per_cluster.max = 3000
    init = cfg.mcmc.initialization
    init.attempts, init.em_steps, init.objects_per_cluster = 1, 3, 200
    t0 = time.perf_counter()
    model = Model(data, cfg.model, device=DEVICE)
    torch.cuda.synchronize()
    return SamplerRuntime(model, cfg.mcmc), t_data, time.perf_counter() - t0


def scale_operator_times(rt, states, cap: int, reps: int = 3) -> dict:
    """Each operator alone for ``reps`` MH steps of the whole batch: ms per
    step; the sweep's acceptance (always) and the wide operator's moves
    above the rows cap (rejected: step_size is their flip count)."""
    from sbayes_tpu_torch.sampling.operators import OperatorFactory
    from sbayes_tpu_torch.sampling.runner import make_generators

    if not OperatorFactory(rt.cond).source_sweep:
        raise AssertionError(f"no source sweep at {rt.consts.F} features")
    gen, _ = make_generators(31, DEVICE)
    apply = rt.apply_fn()
    out, over_cap, sweep = {}, 0, {"tries": 0, "accepts": 0}
    for i, name in enumerate(rt.op_names):
        st = apply(i, gen, states)[0]
        torch.cuda.synchronize()
        steps = []
        t0 = time.perf_counter()
        for _ in range(reps):
            st, accept, step_size, _ = apply(i, gen, st)
            steps.append((accept, step_size))
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / reps * 1e3
        if name.startswith("gibbs_sample_sources"):
            sweep["tries"] += sum(a.numel() for a, _ in steps)
            sweep["accepts"] += sum(int(a.sum()) for a, _ in steps)
        if name == "gibbsish_sample_cluster_wide_geo":
            over_cap = sum(int((ss > cap).sum()) for _, ss in steps)
            wide_tries = sum(ss.numel() for _, ss in steps)
    if sweep["tries"] == 0 or sweep["accepts"] != sweep["tries"]:
        raise AssertionError(f"the source sweep was not always accepted: {sweep}")
    return {"op_ms_per_step": out, "reps": reps, "sweep_accepts": sweep,
            "wide_rows_cap": cap, "wide_over_cap": over_cap, "wide_tries": wide_tries}


def in_bounds_start(rt, states, gen, size: int):
    """From ``states``: K random disjoint clusters of ``size`` objects per
    chain, the source of the objects that left every cluster moved from the
    cluster component to their first confounder's, then one Gibbs pass over
    every object's source; every carried invariant recomputed."""
    from sbayes_tpu_torch.sampling.operators import OperatorFactory

    c = rt.consts
    if not bool(c.hc_conf.any(-1).all()):
        raise AssertionError("an object has no confounder component")
    order = torch.argsort(torch.rand((states.n_chains, c.N), generator=gen, device=c.device),
                          dim=-1)
    clusters = torch.stack([(order >= k * size) & (order < (k + 1) * size)
                            for k in range(c.K)], dim=1)
    fallback = (1 + c.hc_conf.to(torch.uint8).argmax(-1)).to(states.source.dtype)  # (N,)
    stray = (states.source == 0) & ~clusters.any(1)[:, :, None]
    source = torch.where(stray, fallback[None, :, None], states.source)
    states = rt.refresh(states._replace(clusters=clusters, source=source))
    states = OperatorFactory(rt.cond).make_gibbs_sample_source("all", max_size=c.N)(
        gen, states).state
    return rt.refresh(states)


def wide_cap_check(rt, states, cap: int = 1, n_steps: int = 3) -> dict:
    """The wide operator alone with a rows cap of ``cap`` for ``n_steps`` MH
    steps: every move that changes more rows is rejected (its step_size is
    its flip count), there is at least one, and the carried state equals
    its recompute."""
    from sbayes_tpu_torch.sampling.kernel import OperatorStats, make_mh_apply_fn
    from sbayes_tpu_torch.sampling.operators import OperatorFactory, OperatorSpec
    from sbayes_tpu_torch.sampling.runner import make_generators

    wide = OperatorFactory(rt.cond, wide_rows_cap=cap).make_alter_cluster_wide(
        consider_geo=False)
    apply = make_mh_apply_fn(rt.cond, [OperatorSpec("wide_capped", 1.0, wide)])
    gen, _ = make_generators(37, DEVICE)
    stats = OperatorStats.zeros(states.n_chains, 1, rt.consts.device)
    over = accepted_over = 0
    for _ in range(n_steps):
        states, accept, step_size, nf = apply(0, gen, states)
        stats = stats.record(0, accept, step_size, nf)
        over += int((step_size > cap).sum())
        accepted_over += int((accept & (step_size > cap)).sum())
    if over == 0 or accepted_over:
        raise AssertionError(f"rows cap {cap}: {over} moves above it, {accepted_over} accepted")
    errs = check_carried_state(rt.consts, states, rt.refresh(states), stats)
    return {"cap": cap, "steps": n_steps, "moves_above_cap": over,
            "tries": n_steps * states.n_chains, "carried_vs_recompute_max_abs": errs}


def scale_run(rt, gen, op_gen, states, init_sizes=None) -> tuple:
    """SCALE_CHUNKS chunks of SCALE_CHUNK steps of the full schedule from
    ``states`` and the exact refresh a logged sample takes (from the carried
    counts: the likelihood kernel runs at init); the carried state against
    it (sizes within the bounds, or moved towards them from ``init_sizes``),
    the sweep never rejected: (states, summary, launches of the steps and
    the refresh)."""
    c = rt.consts
    torch.cuda.reset_peak_memory_stats()
    stats = rt.new_stats(states.n_chains)
    reset_counters()
    t0 = time.perf_counter()
    for _ in range(SCALE_CHUNKS):
        states, stats = rt.run_chunk(gen, op_gen, states, stats, SCALE_CHUNK)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    ref = rt.refresh(states)                    # what a logged sample takes
    launches = counters()
    peak_run = torch.cuda.max_memory_allocated()
    if not launches.get("marginal"):
        raise AssertionError(f"the marginal was not launched at the scale shape: {launches}")
    errs = check_carried_state(c, states, ref, stats, init_sizes=init_sizes)
    tries = (stats.accepts + stats.rejects).sum(0)
    for i, name in enumerate(rt.op_names):
        if name.startswith("gibbs_sample_sources") and int(stats.rejects[:, i].sum()):
            raise AssertionError(f"{name} rejected a sweep")
    n_steps = SCALE_CHUNK * SCALE_CHUNKS
    return states, {
        "steps": n_steps, "run_s": t_run, "steps_per_s": n_steps / t_run,
        "chain_steps_per_s": states.n_chains * n_steps / t_run, "peak_run_gb": peak_run / 1e9,
        "launches": launches, "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "operator_draws": dict(zip(rt.op_names, tries.tolist())),
        "accept_rate_by_operator": dict(zip(rt.op_names, (
            stats.accepts.sum(0).float() / tries.clamp(min=1).float()).tolist())),
        "sizes": states.clusters.sum(-1).tolist(), "carried_vs_recompute_max_abs": errs}, launches


def phase_scale() -> tuple:
    """The scale workload on SCALE_CHAINS chains: init, SCALE_CHUNKS chunks of
    SCALE_CHUNK steps of the full schedule (``run_chunk``), an exact refresh;
    the carried state against it (counts exactly), the sweep always
    accepted, sizes within bounds (a cluster the EM initializer left out of
    them may only move towards them), no object in two clusters; steps/s, peak
    device memory, ms per step of each operator, both kernels' launches.
    Then the same from an in-bounds start (``in_bounds_start``), where the
    sizes must stay within the bounds. Then both kernels against their plain
    versions on SCALE_KERNEL_CHAINS of the chains (both starts). Returns
    (phase info, kernel rows, runtime, the in-bounds run's end states:
    ``phase_scale_mc3`` starts from the first SCALE_MC3 rungs, the ``mesh``
    phase splits all of them)."""
    from sbayes_tpu_torch.ops import marginal
    from sbayes_tpu_torch.sampling.operators import OperatorFactory
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt, t_data, t_model = scale_runtime()
    c = rt.consts
    if not c.source_packed or c.feature_chunk != 500:
        raise AssertionError(f"scale layout: packed {c.source_packed}, chunk {c.feature_chunk}")
    cap = OperatorFactory(rt.cond).wide_rows_cap
    gen, op_gen = make_generators(29, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    states = rt.init_chains(gen, SCALE_CHAINS)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    peak_init = torch.cuda.max_memory_allocated()
    init_launches = counters()
    init_sizes = states.clusters.sum(-1)
    em_states = states
    states, run, launches = scale_run(rt, gen, op_gen, states, init_sizes=init_sizes)
    launches = add_launches(init_launches, launches)
    if not launches.get("loglh_packed"):                # the initializer's likelihoods
        raise AssertionError(f"the packed likelihood was not launched at init: {launches}")
    peak_run = run.pop("peak_run_gb")
    info = {"chains": SCALE_CHAINS, "N": c.N, "F": c.F, "S": c.S, "C": c.C, "K": c.K,
            "Gmax": c.Gmax, "source_packed": c.source_packed, "feature_chunk": c.feature_chunk,
            "data_s": t_data, "model_s": t_model, "init_s": t_init, **run,
            "peak_memory_gb": {"init": peak_init / 1e9, "run": peak_run},
            "launches": launches, "init_sizes": init_sizes.tolist(),
            **scale_operator_times(rt, states, cap)}

    # The same from an in-bounds start: the jump, the wide operator (and its
    # rows cap) and grow/shrink move clusters of the size the EM aims at,
    # and the sizes stay strictly within the bounds.
    size = rt.mcmc_config.initialization.objects_per_cluster
    start = in_bounds_start(rt, em_states, gen, size)
    del em_states
    states_ib, run_ib, launches_ib = scale_run(rt, gen, op_gen, start)
    info["in_bounds"] = {"objects_per_cluster": size, **run_ib,
                         **scale_operator_times(rt, states_ib, cap),
                         "wide_cap_check": wide_cap_check(rt, states_ib)}
    few_ib = states_ib.select(torch.arange(SCALE_KERNEL_CHAINS, device=c.device))
    info["in_bounds"]["kernels_vs_plain"] = compare_with_plain(c, path_kernel_inputs(rt, few_ib))
    del start, few_ib

    # Both kernels at the scale shape: against their plain versions on a few
    # chains, and timed there and on all of them.
    few = states.select(torch.arange(SCALE_KERNEL_CHAINS, device=states.clusters.device))
    inputs = path_kernel_inputs(rt, few)
    info["kernels_vs_plain"] = compare_with_plain(c, inputs)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = [{"name": "loglh", "route": "cuda", "source": "sbayes_tpu_torch/csrc/loglh.cu",
             "replaces": "sbayes_tpu/ops/pallas_kernels.py:82", "inputs": "scale",
             "launches": launches["loglh"] + launches_ib["loglh"],
             "launches_by_path": {"scale": launches["loglh"],
                                  "scale_in_bounds": launches_ib["loglh"]},
             "max_abs_err": max(info["kernels_vs_plain"]["loglh_abs"],
                                info["in_bounds"]["kernels_vs_plain"]["loglh_abs"]),
             "max_rel_err": max(info["kernels_vs_plain"]["loglh_rel"],
                                info["in_bounds"]["kernels_vs_plain"]["loglh_rel"]),
             **time_loglh(c, few, reps=3, launches=2),
             "all_chains": time_loglh(c, states, reps=3, launches=2)}]
    all_inputs = path_kernel_inputs(rt, states)
    for variant in marginal.VARIANTS:
        name = marginal.variant_name(*variant)
        timed = time_marginal_variant(c, inputs, variant, SCALE_KERNEL_CHAINS, reps=5)
        args, kw = marginal_variant_args(all_inputs, *variant)
        n_bytes = marginal.bytes_moved(c, SCALE_CHAINS, variant[0], variant[2], variant[1])
        b_ms, b_by = bound_ms(n_bytes, marginal.operations(c, SCALE_CHAINS, variant[0],
                                                           variant[2], variant[1]))
        run = lambda: marginal.marginal(c, *args, **kw)  # noqa: E731
        rows.append({"name": name, "route": "cuda",
                     "source": "sbayes_tpu_torch/csrc/marginal.cu",
                     "replaces": "sbayes_tpu/ops/pallas_marginal.py:178", "inputs": "scale",
                     "launches": launches.get(name, 0) + launches_ib.get(name, 0),
                     "launches_by_path": {"scale": launches.get(name, 0),
                                          "scale_in_bounds": launches_ib.get(name, 0)},
                     **timed,
                     "max_abs_err": max(timed["max_abs_err"], info["kernels_vs_plain"][name],
                                        info["in_bounds"]["kernels_vs_plain"][name]),
                     "object_tile": marginal.object_tile(SCALE_KERNEL_CHAINS, c.N, n_sm),
                     "all_chains": {"chains": SCALE_CHAINS, "ms": cuda_time_ms(run, 5),
                                    "device_ms": device_time_ms(run, 5, 5),
                                    "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
                                    "object_tile": marginal.object_tile(SCALE_CHAINS, c.N,
                                                                        n_sm)}})
    return info, rows, rt, states_ib


def geo_costs_memory(rt, states) -> dict:
    """One ``geo_prior_costs_per_object`` of cluster 0 of every chain (from
    the carried aggregates) over tiles of ``auto_cost_row_tile`` rows and in
    one tile of all N rows: the peak device memory each call adds above
    what is allocated before it, and its wall time (second call of each).
    Raises unless the two are bit-equal and the tiled peak stays under
    1 GB."""
    from sbayes_tpu_torch.model.constants import auto_cost_row_tile

    c = rt.consts
    B = states.n_chains
    i_cluster = torch.zeros(B, dtype=torch.long, device=c.device)
    out, res = {}, {}
    for name, tile in (("tiled", auto_cost_row_tile(B, c.N)), ("untiled", c.N)):
        for _ in range(2):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res[name] = rt.post.geo_prior_costs_per_object(states.clusters, i_cluster,
                                                           geo_agg=states.geo_agg, row_tile=tile)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[name] = {"row_tile": tile, "wall_ms": wall * 1e3,
                     "peak_above_state_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    torch.cuda.empty_cache()
    if not torch.equal(res["tiled"], res["untiled"]):
        raise AssertionError("tiled geo costs per object differ from the untiled ones")
    if not out["tiled"]["peak_above_state_gb"] < 1.0:
        raise AssertionError(f"tiled geo costs per object: {out['tiled']} (1 GB or more)")
    return {"chains": B, "N": c.N, **out}


def geo_prior_check(states) -> list:
    """The carried geo-prior part of every chain's log-prior; raises unless
    each is finite and non-zero."""
    from sbayes_tpu_torch.sampling.state import PRIOR_GEO

    geo = states.prior_parts[:, PRIOR_GEO]
    if not bool(torch.isfinite(geo).all()) or bool((geo == 0).any()):
        raise AssertionError(f"geo prior parts {geo.tolist()}: not all finite and non-zero")
    return geo.tolist()


def phase_scale_geo(data) -> tuple:
    """The scale workload of ``phase_scale`` on the same data under the
    cost-based geo prior ``GEO_K3`` (bench.py's geo model), SCALE_CHAINS
    chains: from the EM start (the EM's geo term, the ML steps that weigh
    membership by the geo prior) and again from an in-bounds start, each
    SCALE_CHUNKS chunks of SCALE_CHUNK steps of the full schedule, in which
    the geo-weighted Gibbsish and wide operators weigh their proposals by
    the geo prior. Checks, each fatal, after each run: the carried state
    against its exact recompute (``check_carried_state``: counts exactly,
    the carried skeleton aggregates' edge counts exactly and each entry
    within 1e-3 relative, see there), a finite, non-zero geo-prior part of
    every chain's log-prior, sizes within bounds as in ``scale``, both
    kernels against their plain versions on SCALE_KERNEL_CHAINS chains.
    Prints peak device memory, steps/s, ms per step of each operator, one
    ``_update_geo`` (launches, wall ms, Prim iterations) and one tiled
    against one untiled ``geo_prior_costs_per_object``. Returns (phase
    info, launches by start)."""
    from sbayes_tpu_torch.sampling.operators import OperatorFactory
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt, _, t_model = scale_runtime(data, "cost_based")
    c = rt.consts
    if c.geo.prior_type != "cost_based" or tuple(c.cost_matrix.shape) != (c.N, c.N):
        raise AssertionError(f"scale_geo: geo prior {c.geo.prior_type}, cost matrix "
                             f"{tuple(c.cost_matrix.shape)}")
    cap = OperatorFactory(rt.cond).wide_rows_cap
    gen, op_gen = make_generators(47, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    states = rt.init_chains(gen, SCALE_CHAINS)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    peak_init = torch.cuda.max_memory_allocated()
    init_launches = counters()
    if not init_launches.get("loglh_packed"):
        raise AssertionError(f"the packed likelihood was not launched at init: {init_launches}")
    init_sizes = states.clusters.sum(-1)
    em_states = states
    info = {"chains": SCALE_CHAINS, "N": c.N, "F": c.F, "K": c.K, "geo": GEO_K3,
            "model_s": t_model, "init_s": t_init, "peak_init_gb": peak_init / 1e9,
            "init_launches": init_launches, "init_sizes": init_sizes.tolist()}
    size = rt.mcmc_config.initialization.objects_per_cluster
    launches_by_start = {}
    for name in ("em_start", "in_bounds"):
        if name == "em_start":
            start, bounds = em_states, init_sizes
        else:
            start, bounds = in_bounds_start(rt, em_states, gen, size), None
        states, run, launches = scale_run(rt, gen, op_gen, start, init_sizes=bounds)
        if not launches.get("marginal"):
            raise AssertionError(f"scale_geo {name}: the marginal was not launched: {launches}")
        few = states.select(torch.arange(SCALE_KERNEL_CHAINS, device=c.device))
        info[name] = {**run, "geo_prior_parts": geo_prior_check(states),
                      **scale_operator_times(rt, states, cap),
                      "update_geo": update_geo_cost(rt, states, reps=2),
                      "kernels_vs_plain": compare_with_plain(c, path_kernel_inputs(rt, few))}
        if name == "em_start":
            info[name]["geo_costs_per_object"] = geo_costs_memory(rt, states)
        launches_by_start["scale_geo" if name == "em_start" else "scale_geo_in_bounds"] = (
            add_launches(init_launches, launches) if name == "em_start" else launches)
        del start, states, few
    both = add_launches(*launches_by_start.values())
    if not both.get("marginal_two_eff"):
        raise AssertionError(f"scale_geo: the jump's two-effect marginal was not launched: {both}")
    info["launches"] = launches_by_start
    return info, launches_by_start


def phase_scale_mc3(rt, start) -> tuple:
    """``benchmarks/mc3_scale.py``'s ladder at the scale shape: ``start`` (the
    first SCALE_MC3 rungs of ``phase_scale``'s in-bounds states, with its
    runtime ``rt``) at T = 1 + 0.02 i and prior temperatures 1, SCALE_MC3
    chunks of ``run_mc3_chunk`` with a swap phase every 10 steps (1 attempt,
    adjacent rungs), then the plain ``run_chunk`` from a copy of the same
    start at unit temperatures. Checks, each fatal: the heat variant of the
    marginal launched on the ladder, each run's carried state equal to its
    recompute (sizes strictly within the bounds), every marginal variant and
    the likelihood against their plain versions on the ladder's
    SCALE_KERNEL_CHAINS hottest rungs at their own temperatures. Returns
    (phase info, the ladder's launches, the heat variant timed on those
    rungs' inputs)."""
    from sbayes_tpu_torch.sampling.runner import make_generators
    from sbayes_tpu_torch.sampling.state import ChainState

    c = rt.consts
    n = start.n_chains
    chunk, chunks = SCALE_MC3["chunk"], SCALE_MC3["chunks"]
    temps = 1.0 + SCALE_MC3["temperature_diff"] * torch.arange(n, dtype=torch.float32,
                                                               device=c.device)
    prior_temps = torch.ones(n, device=c.device)
    plain_start = ChainState(*(None if x is None else x.clone() for x in start))
    swap_matrix = np.zeros((2, n, n), dtype=np.int64)
    gen, op_gen = make_generators(41, DEVICE)
    stats = rt.new_stats(n)
    states, n_acc, n_att = start, 0, 0
    reset_counters()
    t0 = time.perf_counter()
    for i in range(chunks):
        states, stats, acc, att = rt.run_mc3_chunk(
            gen, op_gen, states, stats, temps, prior_temps, swap_matrix, i * chunk, chunk,
            SCALE_MC3["swap_interval"], SCALE_MC3["attempts"], True)
        n_acc, n_att = n_acc + acc, n_att + att
    torch.cuda.synchronize()
    t_mc3 = time.perf_counter() - t0
    launches = counters()
    if not launches.get("marginal_heat"):
        raise AssertionError(f"scale_mc3: the heat variant was not launched: {launches}")
    errs = check_carried_state(c, states, rt.refresh(states), stats)

    gen, op_gen = make_generators(41, DEVICE)
    plain, stats_plain = plain_start, rt.new_stats(n)
    reset_counters()
    t0 = time.perf_counter()
    for _ in range(chunks):
        plain, stats_plain = rt.run_chunk(gen, op_gen, plain, stats_plain, chunk)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    launches_plain = counters()
    errs_plain = check_carried_state(c, plain, rt.refresh(plain), stats_plain)

    hot = torch.arange(n - SCALE_KERNEL_CHAINS, n, device=c.device)
    inputs = mc3_kernel_inputs(rt, states.select(hot), temps[hot], prior_temps[hot])
    kernels_vs_plain = compare_with_plain(c, inputs)
    heat = {**time_marginal_variant(c, inputs, (True, True, False), SCALE_KERNEL_CHAINS, reps=5),
            "inputs": "scale_mc3", "temperatures": temps[hot].tolist()}
    steps = chunk * chunks
    rate, rate_plain = n * steps / t_mc3, n * steps / t_plain
    pairs = {f"{a}-{a + 1}": {"accepted": int(swap_matrix[0, a, a + 1]),
                              "attempted": int(swap_matrix[1, a, a + 1])} for a in range(n - 1)}
    for p in pairs.values():
        p["rate"] = p["accepted"] / p["attempted"] if p["attempted"] else None
    info = {"rungs": n, "temperatures": temps.tolist(), "prior_temperatures": prior_temps.tolist(),
            **{k: SCALE_MC3[k] for k in ("swap_interval", "attempts")}, "only_adjacent": True,
            "steps": steps, "mc3_s": t_mc3, "plain_s": t_plain,
            "chain_steps_per_s": rate, "plain_chain_steps_per_s": rate_plain,
            "mc3_overhead": 1.0 - rate / rate_plain, "swaps_accepted": n_acc,
            "swaps_attempted": n_att, "swap_acceptance_by_pair": pairs,
            "launches": launches, "launches_plain": launches_plain,
            "heat_launches": launches["marginal_heat"],
            "sizes": states.clusters.sum(-1).tolist(),
            "carried_vs_recompute_max_abs": errs, "plain_carried_vs_recompute_max_abs": errs_plain,
            "kernels_vs_plain": kernels_vs_plain}
    return info, launches, heat


def add_scale_paths(rows: list, launches_by_path: dict, heat_mc3: dict) -> None:
    """The scale kernel rows with the launches of the later scale paths
    (``launches_by_path``: path -> launch counts) added, and the heat
    variant's row with its timing on the MC3 ladder's inputs."""
    for row in rows:
        for path, counts in launches_by_path.items():
            n = counts.get(row["name"], 0)
            row["launches_by_path"][path] = n
            row["launches"] += n
        if row["name"] == "marginal_heat":
            row["mc3"] = heat_mc3


def schedule_window(rt, states, n_steps: int, trace: bool, profile: bool = False) -> tuple:
    """``n_steps`` steps of the schedule from ``states``, the generators seeded
    the same on every call, so two calls draw the same operators: with
    ``profile`` the CUDA kernels (memory copies included) per step from
    torch.profiler, else the steps per second; and the end states."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    gen, op_gen = make_generators(23, DEVICE)
    stats = rt.new_stats(states.n_chains)
    torch.cuda.synchronize()
    if not profile:
        t0 = time.perf_counter()
        end = rt.run_chunk(gen, op_gen, states, stats, n_steps, trace=trace)[0]
        torch.cuda.synchronize()
        return n_steps / (time.perf_counter() - t0), end
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        end = rt.run_chunk(gen, op_gen, states, stats, n_steps, trace=trace)[0]
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return sum(e.count for e in events) / n_steps, end


def same_states(a, b) -> bool:
    """Bit-equal chain states (every tensor field)."""
    return all(torch.equal(x, y) for x, y in zip(a, b) if isinstance(x, torch.Tensor))


def phase_ess(geo_prior: str) -> dict:
    """K = 3, CHAINS chains: ESS_WARMUP steps, then a trace window of
    ESS_STEPS steps in chunks of 200 with ``trace=True``; the multichain ESS
    of the log-posterior trace (chains x steps), ESS per second of the
    window and split-R-hat; the trace's last row equal to the carried
    ``log_lh + log_prior``, the carried state equal to its recompute; kernels
    per step of a 50-step window with and without the trace (each profiled
    twice), and steps per second of 200-step windows without, with, with and
    without the trace (the same draws in each)."""
    from sbayes_tpu_torch.results.ess import multichain_ess, split_rhat
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = full_width_runtime(3, geo_prior)
    gen, op_gen = make_generators(17, DEVICE)
    states = rt.init_chains(gen, CHAINS)
    stats = rt.new_stats(CHAINS)
    states, stats = rt.run_chunk(gen, op_gen, states, stats, ESS_WARMUP)
    torch.cuda.synchronize()
    reset_counters()
    chunk, parts = 200, []
    t0 = time.perf_counter()
    for _ in range(ESS_STEPS // chunk):
        states, stats, trace = rt.run_chunk(gen, op_gen, states, stats, chunk, trace=True)
        parts.append(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    x = np.concatenate(parts).T.astype(np.float64)                  # (chains, steps)
    last = (states.log_lh + states.log_prior).cpu().numpy()
    if not np.array_equal(parts[-1][-1], last):
        raise AssertionError("the trace's last row differs from the carried log-posterior")
    if not np.isfinite(x).all():
        raise AssertionError("non-finite log-posterior in the trace")
    ess = multichain_ess(x)
    if not 0 < ess <= x.size:
        raise AssertionError(f"multichain ESS {ess} outside (0, {x.size}]")
    errs = check_carried_state(rt.consts, states, rt.refresh(states), stats,
                               rt.op_names.index("cluster_jump_gibbsish"))
    # Kernels per step of the same 50 steps with and without the trace. Each
    # window is profiled twice: the draws repeat bit for bit (the end states
    # are compared), so the kernels do too, and a count below the other is a
    # window whose records the profiler lost (PERF.md, section 7). The larger
    # count of each pair is the window's; both are reported.
    window = 50
    rt.run_chunk(gen, op_gen, states, stats, 5)                     # warm the profiler path
    profiled, ends = {}, {}
    for on in (True, False):
        runs = [schedule_window(rt, states, window, trace=on, profile=True) for _ in range(2)]
        if not same_states(runs[0][1], runs[1][1]):
            raise AssertionError(f"two {window}-step windows with the same draws ended apart "
                                 f"(trace {on})")
        profiled[on] = [k for k, _ in runs]
        ends[on] = runs[0][1]
    if not same_states(ends[True], ends[False]):
        raise AssertionError("the trace changed the states of a window")
    with_trace, without = max(profiled[True]), max(profiled[False])
    if not 0 < with_trace - without <= 2:
        raise AssertionError(f"the trace adds {with_trace - without} kernels per step "
                             f"(windows: {profiled})")
    rates = {"with_trace": [], "without_trace": []}
    for on in (False, True, True, False):
        rates["with_trace" if on else "without_trace"].append(
            schedule_window(rt, states, 200, trace=on)[0])
    return {"geo": geo_prior, "K": 3, "chains": CHAINS, "warmup_steps": ESS_WARMUP,
            "steps": ESS_STEPS, "run_s": wall, "steps_per_s": ESS_STEPS / wall,
            "multichain_ess": ess, "ess_per_s": ess / wall, "split_rhat": split_rhat(x),
            "trace_mean": float(x.mean()), "trace_last_row_equal": True,
            "kernels_per_step": {"with_trace": with_trace, "without_trace": without,
                                 "windows": {"with_trace": profiled[True],
                                             "without_trace": profiled[False]}},
            "window_steps_per_s": rates, "launches": launches, "carried_vs_recompute_max_abs": errs}


def alt_operator_specs(cond):
    """The operators no schedule draws, each as a one-operator schedule, at
    the temperatures of the conditionals ``cond``."""
    from sbayes_tpu_torch.sampling.operators import OperatorFactory, OperatorSpec

    geo_on = cond.consts.geo.prior_type == "cost_based"
    factory = OperatorFactory(cond)
    return {
        "wide_residual": OperatorSpec("wide_residual", 1.0, factory.make_alter_cluster_wide(
            geo_on, effect_proposal="residual")),
        "wide_residual_counts": OperatorSpec(
            "wide_residual_counts", 1.0, factory.make_alter_cluster_wide(
                geo_on, effect_proposal="residual_counts")),
        "wide_em": OperatorSpec("wide_em", 1.0, factory.make_alter_cluster_wide(
            geo_on, em_proposal=True)),
        "alter_weights": OperatorSpec("alter_weights", 1.0, factory.make_alter_weights(),
                                      "weights"),
    }


def run_operator(cond, spec, states, n_steps: int) -> dict:
    """``n_steps`` MH steps of the one operator ``spec`` from ``states``:
    ms per step, launches, acceptance and the carried state against its
    recompute."""
    from sbayes_tpu_torch.sampling.kernel import OperatorStats, make_mh_apply_fn
    from sbayes_tpu_torch.sampling.runner import make_generators

    apply = make_mh_apply_fn(cond, [spec])
    gen, _ = make_generators(29, DEVICE)
    stats = OperatorStats.zeros(states.n_chains, 1, DEVICE)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        states, accept, step_size, nf = apply(0, gen, states)
        stats = stats.record(0, accept, step_size, nf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    errs = check_carried_state(cond.consts, states, cond.post.fill_state(states), stats)
    accept_rate = float(stats.accepts.sum()) / float((stats.accepts + stats.rejects).sum())
    return {"steps": n_steps, "ms_per_step": wall / n_steps * 1e3, "launches": launches,
            "accept_rate": accept_rate, "carried_vs_recompute_max_abs": errs}


def phase_alt_operators(rt_k3, states_k3, rt_mc3, states_mc3, temps) -> dict:
    """Each non-scheduled operator alone for ALT_STEPS steps on the
    ``full_width_k3`` states; the residual-counts wide operator also on the
    ``full_width_mc3`` states at their per-chain temperatures. The residual
    wide steps launch the ratio marginal (heat at per-chain T) twice a step,
    forward and backward proposal."""
    from sbayes_tpu_torch.sampling.conditionals import Conditionals

    out = {}
    for name, spec in alt_operator_specs(rt_k3.cond).items():
        out[name] = run_operator(rt_k3.cond, spec, states_k3, ALT_STEPS)
    cond_mc3 = Conditionals(rt_mc3.post, temps, temps)
    spec = alt_operator_specs(cond_mc3)["wide_residual_counts"]
    out["wide_residual_counts_mc3"] = run_operator(cond_mc3, spec, states_mc3, ALT_STEPS)
    need = {"wide_residual": "marginal", "wide_residual_counts": "marginal",
            "wide_residual_counts_mc3": "marginal_heat"}
    for name, variant in need.items():
        if out[name]["launches"].get(variant, 0) != 2 * ALT_STEPS:
            raise AssertionError(f"{name}: {out[name]['launches']}, expected {2 * ALT_STEPS} "
                                 f"launches of {variant}")
    return out


def phase_prior_samples(rt) -> dict:
    """PRIOR_SAMPLES samples from the prior of ``rt``'s model: sizes within
    the bounds, weights on the simplex, ``log_lh`` (the likelihood kernel)
    against the plain likelihood of the same samples."""
    from sbayes_tpu_torch.ops import loglh
    from sbayes_tpu_torch.sampling.prior_sampling import generate_prior_samples
    from sbayes_tpu_torch.sampling.runner import make_generators

    c = rt.consts
    gen, _ = make_generators(31, DEVICE)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    samples = generate_prior_samples(gen, rt.cond, PRIOR_SAMPLES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    if launches.get("loglh", 0) != 1:
        raise AssertionError(f"prior samples: {launches}")
    sizes = samples.clusters.sum(-1)
    if int(sizes.min()) < c.min_size or int(sizes.max()) > c.max_size:
        raise AssertionError(f"prior sample sizes {int(sizes.min())}..{int(sizes.max())}")
    if not bool(((samples.weights.sum(-1) - 1).abs() < 1e-5).all()):
        raise AssertionError("prior weights off the simplex")
    want = loglh.log_likelihood_plain(c, samples.clusters, samples.source)
    rel = float(((samples.log_lh - want).abs() / want.abs()).max())
    if not rel <= LOGLH_TOL_REL:
        raise AssertionError(f"prior samples: log_lh vs plain relative error {rel}")
    return {"samples": PRIOR_SAMPLES, "K": c.K, "wall_s": wall, "launches": launches,
            "log_lh_max_rel_err": rel, "mean_size": float(sizes.float().mean()),
            "mean_log_lh": float(samples.log_lh.mean())}


def cuda_time_ms(fn, reps: int = 50) -> float:
    """Milliseconds per eager call: CUDA events around ``reps`` calls, so host
    dispatch counts where it is slower than the device."""
    for _ in range(min(reps, 5)):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_ms(fn, launches: int = 20, reps: int = 20) -> float:
    """Milliseconds per call on the device alone: ``launches`` calls captured
    into one CUDA graph, CUDA events around ``reps`` replays. The host
    dispatches nothing inside a replay, so short kernels are not hidden
    behind the Python wrapper; the graph still pays each launch."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * launches)


def launch_floor() -> dict:
    """An empty kernel through the same ctypes launch path, timed both ways:
    the floor under ``ms`` and under ``device_ms`` of the ``kernels`` line."""
    from sbayes_tpu_torch.ops import _cuda

    lib = _cuda.library()
    stream = torch.cuda.current_stream

    def empty():
        _cuda.check(lib.sbt_empty(stream().cuda_stream), "empty")

    return {"launch_floor_ms": cuda_time_ms(empty), "device_floor_ms": device_time_ms(empty)}


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def marginal_variant_args(inputs: dict, ratio: bool, heat: bool, two_eff: bool) -> tuple:
    """Positional arguments after ``consts`` and the keywords of
    ``marginal`` / ``marginal_plain`` for one variant."""
    rows = (inputs["p_eff"][:, None] if (ratio and not two_eff)
            else torch.stack([inputs["p_eff"], inputs["p_other"]], 1)).contiguous()
    args = (rows, inputs["conf_eff"], inputs["wh"], inputs["hc"], inputs["hc_flip"],
            inputs["incl"], inputs["inv_t"] if heat else None)
    return args, dict(ratio=ratio, two_eff=two_eff)


def path_kernel_inputs(rt, states) -> dict:
    """The inputs both kernels get on the main path, from the chains' own
    state: memberships and sources, and the effects, weights and
    availabilities the Gibbsish operators hand to the marginal."""
    from sbayes_tpu_torch.model.math import normalize
    from sbayes_tpu_torch.sampling.conditionals import _pick_cluster

    c = rt.consts
    B = states.n_chains
    dev = states.clusters.device
    hc = rt.post.has_components(states.clusters)
    hc_flip = hc.clone()
    hc_flip[..., 0] = ~hc[..., 0]
    i_cluster = torch.zeros(B, dtype=torch.long, device=dev)
    p_eff = normalize(_pick_cluster(states.cl_counts, i_cluster) + c.conc_cluster[None])
    return {"clusters": states.clusters, "source": states.source, "p_eff": p_eff,
            "p_other": normalize(torch.roll(p_eff, 1, dims=0) + 0.1),
            "conf_eff": normalize(states.conf_counts + c.conc_conf[None]),
            "wh": states.weights.contiguous(), "hc": hc.float(), "hc_flip": hc_flip.float(),
            "incl": hc[..., 0].float(), "inv_t": torch.full((B,), 1.0 / 1.3, device=dev)}


def jump_kernel_inputs(cond, states) -> dict:
    """The inputs the jump operator gives both kernels, from the chains' own
    state: the effects of clusters 0 (source) and 1 (target) as the two
    effect rows, ``hc_flip = hc`` and ``incl = 1``."""
    from sbayes_tpu_torch.model.math import normalize

    c = cond.consts
    B = states.n_chains
    hc = cond.post.has_components(states.clusters).float()
    effects = normalize(states.cl_counts[:, :2] + c.conc_cluster[None, None])
    return {"clusters": states.clusters, "source": states.source, "p_eff": effects[:, 0],
            "p_other": effects[:, 1],
            "conf_eff": normalize(states.conf_counts + c.conc_conf[None]),
            "wh": states.weights.contiguous(), "hc": hc, "hc_flip": hc,
            "incl": torch.ones((B, c.N), device=hc.device),
            "inv_t": torch.full((B,), 1.0 / 1.3, device=hc.device)}


def mc3_kernel_inputs(rt, states, temps, prior_temps=None) -> dict:
    """The inputs the wide operator gives the heat variant under per-chain
    likelihood temperatures ``temps`` and prior temperatures
    ``prior_temps`` (None: ``temps``), from the chains' own state: the
    heated effect of cluster 0 (counts over T, concentration over Tp), the
    weights to the power 1/Tp and ``inv_t = 1/T`` per chain."""
    from sbayes_tpu_torch.model.math import conditional_effect_mean, normalize, per_chain

    c = rt.consts
    if prior_temps is None:
        prior_temps = temps
    hc = rt.post.has_components(states.clusters)
    hc_flip = hc.clone()
    hc_flip[..., 0] = ~hc[..., 0]
    p_eff = conditional_effect_mean(c.conc_cluster[None], states.cl_counts[:, 0],
                                    c.unif_conc[None], prior_temps, temps)
    inv_t = 1.0 / temps
    inv_tp = 1.0 / prior_temps
    return {"clusters": states.clusters, "source": states.source, "p_eff": p_eff,
            "p_other": normalize(torch.roll(p_eff, 1, dims=0) + 0.1),
            "conf_eff": normalize(states.conf_counts + c.conc_conf[None]),
            "wh": (states.weights ** per_chain(inv_tp, states.weights)).contiguous(),
            "hc": hc.float(), "hc_flip": hc_flip.float(), "incl": hc[..., 0].float(),
            "inv_t": inv_t}


def residual_kernel_inputs(cond, states) -> dict:
    """The inputs the residual-counts wide operator gives the marginal at the
    temperatures of ``cond``: the residual-counts effect of cluster 0, the
    weights to the power 1/Tp and ``inv_t = 1/T`` per chain (1/1.3 at unit
    temperature, as ``path_kernel_inputs``)."""
    from sbayes_tpu_torch.model.math import normalize
    from sbayes_tpu_torch.sampling.operators import OperatorFactory

    c = cond.consts
    B = states.n_chains
    hc = cond.post.has_components(states.clusters)
    hc_flip = hc.clone()
    hc_flip[..., 0] = ~hc[..., 0]
    i_cluster = torch.zeros(B, dtype=torch.long, device=DEVICE)
    p_eff = OperatorFactory(cond).cluster_effect_proposal_residual_counts(
        states, states.cl_counts, states.conf_counts, i_cluster)
    inv_t = (cond.inv_T if isinstance(cond.T, torch.Tensor)
             else torch.full((B,), 1.0 / 1.3, device=DEVICE))
    return {"clusters": states.clusters, "source": states.source, "p_eff": p_eff,
            "p_other": normalize(torch.roll(p_eff, 1, dims=0) + 0.1),
            "conf_eff": normalize(states.conf_counts + c.conc_conf[None]),
            "wh": cond.heat_prior(states.weights).contiguous(), "hc": hc.float(),
            "hc_flip": hc_flip.float(), "incl": hc[..., 0].float(), "inv_t": inv_t}


def time_marginal_variant(c, inputs: dict, variant: tuple, n_chains: int,
                          reps: int = 50) -> dict:
    """One marginal variant on ``inputs``: its error against the plain
    version, eager and device time, the plain version's time and the bound."""
    from sbayes_tpu_torch.ops import marginal

    args, kw = marginal_variant_args(inputs, *variant)

    def run():
        return marginal.marginal(c, *args, **kw)

    err = float((run() - marginal.marginal_plain(c, *args, **kw)).abs().max())
    ratio, heat, two_eff = variant
    n_bytes = marginal.bytes_moved(c, n_chains, ratio, two_eff, heat)
    b_ms, b_by = bound_ms(n_bytes, marginal.operations(c, n_chains, ratio, two_eff, heat))
    return {"max_abs_err": err, "ms": cuda_time_ms(run, reps),
            "device_ms": device_time_ms(run, min(reps, 20), min(reps, 20)),
            "plain_ms": cuda_time_ms(lambda: marginal.marginal_plain(c, *args, **kw),
                                     reps=min(reps, 10)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "bytes": n_bytes,
            "chains": n_chains, "F": c.F}


def random_kernel_inputs(c, n_chains: int, seed: int) -> dict:
    """Random valid inputs of both kernels for the model constants ``c``:
    memberships, one-hot sources among the available components, normalised
    effects and weights."""
    from sbayes_tpu_torch.model.math import normalize

    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=DEVICE)

    B = n_chains
    clusters = rand(B, c.K, c.N) < 0.3
    hc = torch.cat([clusters.any(1)[..., None], c.hc_conf[None].expand(B, -1, -1)], dim=-1)
    comp = (rand(B, c.N, c.F, c.C) * hc[:, :, None]).argmax(-1)
    source = torch.nn.functional.one_hot(comp, c.C).bool() & ~c.na[None, :, :, None]
    hc_flip = hc.clone()
    hc_flip[..., 0] = ~hc[..., 0]
    app = c.applicable.float()
    return {"clusters": clusters, "source": source,
            "p_eff": normalize((rand(B, c.F, c.S) + 0.05) * app),
            "p_other": normalize((rand(B, c.F, c.S) + 0.05) * app),
            "conf_eff": normalize((rand(B, c.C - 1, c.Gmax, c.F, c.S) + 0.05) * app),
            "wh": normalize(rand(B, c.F, c.C) + 0.05), "hc": hc.float(),
            "hc_flip": hc_flip.float(), "incl": hc[..., 0].float(),
            "inv_t": 0.5 + rand(B)}


def compare_with_plain(c, inputs: dict) -> dict:
    """Both kernels and every marginal variant against their plain versions
    on ``inputs``; the likelihood on both source forms (the packed kernel
    bit-equal to the bool one: the same terms in fixed point); raises beyond
    a tolerance, returns the largest errors."""
    from sbayes_tpu_torch.model.math import pack_source, source_is_packed, source_onehot
    from sbayes_tpu_torch.ops import loglh, marginal

    src = inputs["source"]
    forms = {"packed": src if source_is_packed(src) else pack_source(src),
             "bool": source_onehot(src, c.C)}
    got = {k: loglh.log_likelihood(c, inputs["clusters"], v) for k, v in forms.items()}
    want = loglh.log_likelihood_plain(c, inputs["clusters"], src)
    again = [loglh.log_likelihood(c, inputs["clusters"], forms["packed"]) for _ in range(4)]
    torch.cuda.synchronize()
    if not all(torch.equal(got["packed"], other) for other in again + [got["bool"]]):
        raise AssertionError("loglh kernel: launches on the same inputs (either source form) "
                             "differ in bits")
    got = got["bool"]
    errs = {"loglh_abs": float((got - want).abs().max()),
            "loglh_rel": float(((got - want).abs() / want.abs()).max()),
            "loglh_packed_equals_bool": True}
    if not errs["loglh_rel"] <= LOGLH_TOL_REL:
        raise AssertionError(f"loglh kernel vs plain (N, F, S = {c.N, c.F, c.S}): relative "
                             f"error {errs['loglh_rel']} > {LOGLH_TOL_REL}")
    for variant in marginal.VARIANTS:
        args, kw = marginal_variant_args(inputs, *variant)
        got = marginal.marginal(c, *args, **kw)
        want = marginal.marginal_plain(c, *args, **kw)
        torch.cuda.synchronize()
        name = marginal.variant_name(*variant)
        errs[name] = float((got - want).abs().max())
        tol = MARGINAL_TOL_ABS * max(1.0, c.F / MARGINAL_TOL_FEATURES)
        if not errs[name] <= tol:
            raise AssertionError(f"{name} kernel vs plain (N, F, S = {c.N, c.F, c.S}): "
                                 f"{errs[name]} > {tol}")
    return errs


def tiled_check(n_features: int = 400, n_chains: int = 64) -> dict:
    """Both kernels against their plain versions on data wide enough that
    their tables pass the shared-memory budget, so each walks the features
    in tiles; random memberships, valid sources, random effects."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.ops import loglh, marginal
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    c = Model(synthetic_data(n_features=n_features), synthetic_config(n_clusters=1).model,
              device=DEVICE).consts
    tiles = {"loglh": loglh.feature_tile(c), "marginal": marginal.feature_tile(c)}
    for name, f_tile in tiles.items():
        if f_tile >= c.F:
            raise AssertionError(f"{name}: {c.F} features fit one tile: no tiling to check")
    errs = compare_with_plain(c, random_kernel_inputs(c, n_chains, seed=3))
    return {"F": c.F, "f_tile": tiles["loglh"], "marginal_f_tile": tiles["marginal"],
            "chains": n_chains, "max_rel_err": errs["loglh_rel"], "errors": errs}


def odd_shape_check(n_chains: int = 3) -> dict:
    """Both kernels against their plain versions where nothing is aligned:
    37 objects (no multiple of 32) x 7 features x 5 states, 5 families, a
    fifth of the objects in no family, K = 2 clusters. No per-chain table is
    a multiple of 16 bytes, so every table takes the kernels' plain-load
    path, and the ragged edges of every loop are exercised."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=37, n_features=7, n_states=5, n_families=5,
                          no_family_share=0.2, seed=1)
    c = Model(data, synthetic_config(n_clusters=2).model, device=DEVICE).consts
    n_out = int((c.group_idx < 0).sum())
    if n_out == 0:
        raise AssertionError("the odd-shape data left no object out of every family")
    slabs = {"p_eff": 4 * c.F * c.S, "conf_eff": 4 * (c.C - 1) * c.Gmax * c.F * c.S,
             "wh": 4 * c.F * c.C, "source": c.N * c.F * c.C}
    aligned = [k for k, v in slabs.items() if v % 16 == 0]
    if aligned:
        raise AssertionError(f"odd-shape tables {aligned} are multiples of 16 bytes")
    errs = compare_with_plain(c, random_kernel_inputs(c, n_chains, seed=5))
    return {"N": c.N, "F": c.F, "S": c.S, "K": c.K, "Gmax": c.Gmax, "chains": n_chains,
            "objects_in_no_family": n_out, "errors": errs}


def components_check(n_chains: int = 5) -> dict:
    """Both kernels against their plain versions with 2, 4 and 5 components
    (the cluster effect plus 1, 3 and 4 confounders; every other check has
    3), on 50 objects x 12 features x 4 states with K = 2 clusters. The
    kernels are compiled for 2, 3, 4 and for any other number of components:
    this launches each of those."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    out = {}
    for names in (("family",), ("universal", "family", "area"),
                  ("universal", "family", "area", "script")):
        data = synthetic_data(n_objects=50, n_features=12, n_states=4, n_families=3,
                              no_family_share=0.2, seed=2, confounders=names)
        c = Model(data, synthetic_config(n_clusters=2, confounders=names).model,
                  device=DEVICE).consts
        if c.C != len(names) + 1:
            raise AssertionError(f"{names}: the model has {c.C} components")
        out[f"C{c.C}"] = compare_with_plain(c, random_kernel_inputs(c, n_chains, seed=7 + c.C))
    return out


def many_groups_check(n_chains: int = 2) -> dict:
    """Both kernels against their plain versions where one feature's rows
    alone pass the 48 KB of shared memory a block gets by default: 1200
    objects in 1100 families, 3 features. Each kernel then asks for a larger
    block (up to 227 KB) and walks the features one at a time."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.ops import loglh, marginal
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=1200, n_features=3, n_states=6, n_families=1100, seed=3)
    c = Model(data, synthetic_config(n_clusters=1).model, device=DEVICE).consts
    rows = c.K + (c.C - 1) * c.Gmax
    if 4 * rows * c.S <= 48 * 1024:
        raise AssertionError(f"{rows} rows of one feature fit the default shared memory")
    tiles = {"loglh": loglh.feature_tile(c), "marginal": marginal.feature_tile(c)}
    if tiles != {"loglh": 1, "marginal": 1}:
        raise AssertionError(f"expected tiles of one feature, got {tiles}")
    return {"N": c.N, "F": c.F, "Gmax": c.Gmax, "rows": rows, "chains": n_chains,
            "errors": compare_with_plain(c, random_kernel_inputs(c, n_chains, seed=9))}


def time_loglh(c, states, reps: int = 50, launches: int = 20) -> dict:
    """The likelihood kernel on ``states`` (either source form): eager and
    device time, the plain version's time, the bound."""
    from sbayes_tpu_torch.model.math import source_is_packed
    from sbayes_tpu_torch.ops import loglh

    def run():
        return loglh.log_likelihood(c, states.clusters, states.source)

    packed = source_is_packed(states.source)
    n_bytes = loglh.bytes_moved(c, states.n_chains, packed)
    b_ms, b_by = bound_ms(n_bytes, loglh.operations(c, states.n_chains, packed))
    return {"ms": cuda_time_ms(run, reps), "device_ms": device_time_ms(run, launches,
                                                                     min(reps, 20)),
            "plain_ms": cuda_time_ms(lambda: loglh.log_likelihood_plain(
                c, states.clusters, states.source), reps=min(reps, 10)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "bytes": n_bytes,
            "source_form": "packed" if packed else "bool", "chains": states.n_chains}


def phase_kernels(rt, states, rt_k3, states_k3, rt_mc3, states_mc3, temps_mc3,
                  launches_by_path: dict, jump_512: dict, residual_launches: dict) -> list:
    """Each kernel and marginal variant against its plain version, at the
    K = 1 path's shapes and inputs; the likelihood also on the K = 3 states,
    the absolute and two-effect variants on the inputs the K = 3 jump gives
    them, the heat variant also on an MC3 batch's own states at its per-chain
    ``temps_mc3``. ``launches_by_path``: the launch counts of each driven
    path; ``jump_512``: the two-effect variant's timing at
    ``phase_jump_512``'s shapes. Then the ratio and heat variants again on
    the residual-counts effect rows (K = 3 states; MC3 states at
    ``temps_mc3``), with ``residual_launches``: the residual wide operators'
    launches in ``alt_operators``."""
    from sbayes_tpu_torch.ops import marginal
    from sbayes_tpu_torch.sampling.conditionals import Conditionals

    c = rt.consts
    B = states.n_chains
    inputs = path_kernel_inputs(rt, states)
    errs = compare_with_plain(c, inputs)
    floor = launch_floor()
    paths = {name: {path: n.get(name, 0) for path, n in launches_by_path.items()}
             for name in ["loglh"] + [marginal.variant_name(*v) for v in marginal.VARIANTS]}
    inputs_k3 = jump_kernel_inputs(rt_k3.cond, states_k3)
    errs_k3 = compare_with_plain(rt_k3.consts, inputs_k3)
    inputs_mc3 = mc3_kernel_inputs(rt_mc3, states_mc3, temps_mc3)
    errs_mc3 = compare_with_plain(rt_mc3.consts, inputs_mc3)

    # Kernel 1: collapsed likelihood.
    entry = {"name": "loglh", "route": "cuda", "source": "sbayes_tpu_torch/csrc/loglh.cu",
             "replaces": "sbayes_tpu/ops/pallas_kernels.py:82",
             "launches": sum(paths["loglh"].values()), "launches_by_path": paths["loglh"],
             "max_abs_err": errs["loglh_abs"], "max_rel_err": errs["loglh_rel"],
             **time_loglh(c, states), **floor, "feature_tiled": tiled_check(),
             "odd_shape": odd_shape_check(), "components": components_check(),
             "many_groups": many_groups_check(),
             "k3": {"K": rt_k3.consts.K, "max_abs_err": errs_k3["loglh_abs"],
                    "max_rel_err": errs_k3["loglh_rel"],
                    **time_loglh(rt_k3.consts, states_k3)}}
    out = [entry]

    # Kernel 2: membership marginal, all variants: the Gibbsish forms on the
    # K = 1 states' own effects, the jump's forms on the K = 3 jump's inputs.
    for variant in marginal.VARIANTS:
        name = marginal.variant_name(*variant)
        of_jump = variant[2] or not variant[0]
        timed = (time_marginal_variant(rt_k3.consts, inputs_k3, variant, states_k3.n_chains)
                 if of_jump else time_marginal_variant(c, inputs, variant, B))
        entry = {"name": name, "route": "cuda", "source": "sbayes_tpu_torch/csrc/marginal.cu",
                 "replaces": "sbayes_tpu/ops/pallas_marginal.py:178",
                 "launches": sum(paths[name].values()), "launches_by_path": paths[name],
                 **timed, "inputs": "k3_jump" if of_jump else "k1_gibbsish", **floor}
        entry["max_abs_err"] = max(entry["max_abs_err"], errs[name], errs_k3[name],
                                   errs_mc3[name])
        if variant == (True, False, True):
            entry["jump_512"] = jump_512
        if variant == (True, True, False):
            entry["mc3"] = {**time_marginal_variant(rt_mc3.consts, inputs_mc3, variant,
                                                    states_mc3.n_chains),
                            "inputs": "mc3", "K": rt_mc3.consts.K,
                            "temperatures": sorted(set(temps_mc3.tolist())), **floor}
        out.append(entry)

    # The wide operator's residual-counts effect rows through the same kernel.
    cond_mc3 = Conditionals(rt_mc3.post, temps_mc3, temps_mc3)
    for variant, cond, st in (((True, False, False), rt_k3.cond, states_k3),
                              ((True, True, False), cond_mc3, states_mc3)):
        name = marginal.variant_name(*variant)
        inputs_res = residual_kernel_inputs(cond, st)
        errs_res = compare_with_plain(cond.consts, inputs_res)
        timed = time_marginal_variant(cond.consts, inputs_res, variant, st.n_chains)
        n = residual_launches.get(name, 0)
        out.append({"name": name, "route": "cuda", "source": "sbayes_tpu_torch/csrc/marginal.cu",
                    "replaces": "sbayes_tpu/ops/pallas_marginal.py:178", "launches": n,
                    # the mesh path draws no residual-effect operator
                    "launches_by_path": {"alt_operators_residual": n, "mesh": 0}, **timed,
                    "max_abs_err": max(timed["max_abs_err"], errs_res[name]),
                    "inputs": "residual", "K": cond.consts.K,
                    "temperatures": (sorted(set(temps_mc3.tolist())) if variant[1] else [1.0]),
                    **floor})
    return out


def mesh_devices() -> tuple:
    """The devices of the mesh phase: every visible card where the machine
    has more than one, else two shards on cuda:0."""
    n = torch.cuda.device_count()
    return tuple(f"cuda:{i}" for i in range(n)) if n > 1 else ("cuda:0", "cuda:0")


@contextmanager
def split_over(devices):
    """``auto_chain_mesh`` sees ``devices`` as the visible cards."""
    import sbayes_tpu_torch.parallel.mesh as mesh

    saved = mesh.visible_devices
    mesh.visible_devices = lambda device_type="cuda": list(devices)
    try:
        yield
    finally:
        mesh.visible_devices = saved


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def shard_launches(sh, j: int) -> dict:
    """The launches counted on shard ``j``'s device and stream, by variant."""
    from sbayes_tpu_torch.ops import loglh, marginal

    place = (sh.mesh[j].index, sh.streams[j].cuda_stream)
    out = {"loglh": sum(loglh.launches.by_place.get(place, {}).values())}
    for key, n in marginal.launches.by_place.get(place, {}).items():
        out[marginal.variant_name(*key)] = n
    return out


def split_runtime(rt, n_chains: int, devices):
    """``rt.shard(n_chains)`` as ``auto_chain_mesh`` splits it over ``devices``."""
    with split_over(devices):
        sh = rt.shard(n_chains)
    if sh.n_shards != len(devices):
        raise AssertionError(f"{n_chains} chains split into {sh.n_shards} shards, "
                             f"not {len(devices)}")
    return sh


def check_shards(sh, shards, stats, jump_idx=None) -> list:
    """Every shard's carried state against its own exact recompute."""
    refs = sh.refresh(shards)
    return [check_carried_state(sh.rts[j].consts, shards[j], refs[j], stats[j], jump_idx)
            for j in range(sh.n_shards)]


def mesh_ensemble(rt, states, devices) -> dict:
    """(a) The K = 3 ensemble split over ``devices``: the split init of a
    warm-up race, then MESH["pairs"] alternating pairs of
    MESH["window"]-step windows from ``states``, split then unsplit
    (``run_chunk`` of the whole batch), chain-steps/s of each, and one
    window of the shards dispatched one after the other from the calling
    thread (``split_one_thread``, not counted in the launches); every shard's
    carried counts and ``geo_agg`` against the recompute; the launches on
    shard 1's device and stream; both kernels against their plain versions
    on shard 1's chains (from its device, whatever the current device)."""
    from sbayes_tpu_torch.parallel.mesh import ShardGenerators
    from sbayes_tpu_torch.sampling.runner import make_generators

    n, w = states.n_chains, MESH["window"]
    sh = split_runtime(rt, n, devices)
    gen, op_gen = make_generators(43, DEVICE)
    gens = ShardGenerators(gen)
    # The split init of a warm-up race (its likelihoods: the loglh kernel);
    # the windows then start from ``states``, equilibrated as the unsplit.
    reset_counters()
    sync_all()
    t0 = time.perf_counter()
    init = sh.init_chains(gens, n)
    sync_all()
    t_init = time.perf_counter() - t0
    launches, shard1 = counters(), shard_launches(sh, 1)
    init_sizes = [int(s.clusters.sum(-1).max()) for s in init]
    del init
    split, split_stats = sh.split(states), sh.new_stats(n)
    plain_gen, plain_op_gen = make_generators(44, DEVICE)
    plain, plain_stats = states, rt.new_stats(n)
    rates = {"split": [], "unsplit": []}
    for _ in range(MESH["pairs"]):
        reset_counters()
        sync_all()
        t0 = time.perf_counter()
        split, split_stats = sh.run_chunk(gens, op_gen, split, split_stats, w)
        sync_all()
        rates["split"].append(n * w / (time.perf_counter() - t0))
        launches = add_launches(launches, counters())
        shard1 = add_launches(shard1, shard_launches(sh, 1))
        t0 = time.perf_counter()
        plain, plain_stats = rt.run_chunk(plain_gen, plain_op_gen, plain, plain_stats, w)
        sync_all()
        rates["unsplit"].append(n * w / (time.perf_counter() - t0))
    # The same shards dispatched one after the other from this thread: what
    # the shards' threads win or lose against the GIL.
    sync_all()
    t0 = time.perf_counter()
    ops = rt.draw_ops(op_gen, w)
    g = gens.for_mesh(sh.mesh)
    for j in range(sh.n_shards):
        split[j], split_stats[j] = sh.rts[j].run_ops(g[j], ops, split[j], split_stats[j])
    sync_all()
    rates["split_one_thread"] = n * w / (time.perf_counter() - t0)
    reset_counters()
    errs = check_shards(sh, split, split_stats, rt.op_names.index("cluster_jump_gibbsish"))
    launches = add_launches(launches, counters())
    shard1 = add_launches(shard1, shard_launches(sh, 1))
    for name in ("loglh", "marginal", "marginal_abs"):
        if not shard1.get(name):
            raise AssertionError(f"mesh: {name} never launched on shard 1: {shard1}")
    rt1 = sh.rts[1]
    kernels = {"path": compare_with_plain(rt1.consts, path_kernel_inputs(rt1, split[1])),
               "jump": compare_with_plain(rt1.consts, jump_kernel_inputs(rt1.cond, split[1]))}
    ratio = [a / b for a, b in zip(rates["split"], rates["unsplit"])]
    return {"K": rt.consts.K, "geo": "cost_based", "chains": n, "shards": sh.n_shards,
            "chains_per_shard": n // sh.n_shards, "split_init_s": t_init,
            "split_init_max_size": init_sizes, "steps": w * MESH["pairs"],
            "window_steps": w, "chain_steps_per_s": rates, "split_over_unsplit": ratio,
            "launches": launches, "launches_shard1": shard1,
            "carried_vs_recompute_max_abs": errs, "shard1_kernels_vs_plain": kernels}


def mesh_mc3(rt, states, temps, devices) -> dict:
    """(b) ``full_width_mc3``'s 1024 chains as one MC3 ladder of 1024 rungs
    at their per-chain temperatures, split over ``devices``:
    MESH["mc3_steps"] steps of ``run_mc3_chunk`` with a swap phase every
    MESH["swap_interval"] steps (every adjacent pair proposed), then the
    unsplit ladder from the same start: chain-steps/s of both, swaps
    accepted overall and across the shard boundary, every shard's carried
    state against the recompute, the heat variant launched on shard 1 and
    held against its plain version on shard 1's rungs."""
    from sbayes_tpu_torch.parallel.mesh import ShardGenerators
    from sbayes_tpu_torch.sampling.runner import make_generators

    n, steps, interval = states.n_chains, MESH["mc3_steps"], MESH["swap_interval"]
    sh = split_runtime(rt, n, devices)
    t_split = sh.split(temps)
    gen, op_gen = make_generators(47, DEVICE)
    swaps = np.zeros((2, n, n), dtype=np.int64)
    reset_counters()
    sync_all()
    t0 = time.perf_counter()
    shards, stats, n_acc, n_att = sh.run_mc3_chunk(
        ShardGenerators(gen), op_gen, sh.split(states), sh.new_stats(n), t_split, t_split, swaps,
        0, steps, interval, n - 1, True)
    sync_all()
    t_mc3 = time.perf_counter() - t0
    launches, shard1 = counters(), shard_launches(sh, 1)
    if not shard1.get("marginal_heat"):
        raise AssertionError(f"mesh MC3: the heat variant never launched on shard 1: {shard1}")
    b = n // sh.n_shards
    errs = check_shards(sh, shards, stats, rt.op_names.index("cluster_jump_gibbsish"))
    rt1 = sh.rts[1]
    kernels = compare_with_plain(rt1.consts, mc3_kernel_inputs(rt1, shards[1], t_split[1]))

    gen, op_gen = make_generators(47, DEVICE)
    plain_swaps = np.zeros_like(swaps)
    sync_all()
    t0 = time.perf_counter()
    rt.run_mc3_chunk(gen, op_gen, states, rt.new_stats(n), temps, temps, plain_swaps, 0,
                     MESH["mc3_plain_steps"], interval, n - 1, True)
    sync_all()
    t_plain = time.perf_counter() - t0
    return {"rungs": n, "shards": sh.n_shards, "steps": steps, "swap_interval": interval,
            "swap_phases": steps // interval, "attempts_per_phase": n - 1,
            "swaps_accepted": n_acc, "swaps_attempted": n_att,
            "boundary_pair": [b - 1, b],
            "boundary_accepted": int(swaps[0, b - 1, b]),
            "boundary_attempted": int(swaps[1, b - 1, b]),
            "boundary_temperatures": [float(temps[b - 1]), float(temps[b])],
            "chain_steps_per_s": n * steps / t_mc3,
            "unsplit_steps": MESH["mc3_plain_steps"],
            "unsplit_chain_steps_per_s": n * MESH["mc3_plain_steps"] / t_plain,
            "unsplit_swaps_accepted": int(plain_swaps[0].sum()),
            "launches": launches, "launches_shard1": shard1,
            "carried_vs_recompute_max_abs": errs, "shard1_kernels_vs_plain": kernels}


def mesh_scale(rt, states, devices) -> dict:
    """(c) ``scale``'s 16 in-bounds states split 2 x 8 (no second init):
    MESH["scale_steps"] steps of the full schedule split, then unsplit from
    the same start; steps/s of both, peak device memory of the split run,
    every shard's carried state against the recompute. The draws of so few
    steps may hold no wide step, and then time the host alone; so
    MESH["scale_wide_steps"] steps of each wide operator of the schedule
    (``run_ops`` on that fixed sequence, the step whose time is the
    device's) are timed split and unsplit from the same start too."""
    from sbayes_tpu_torch.parallel.mesh import ShardGenerators
    from sbayes_tpu_torch.sampling.runner import make_generators

    n, steps = states.n_chains, MESH["scale_steps"]
    sh = split_runtime(rt, n, devices)
    gen, op_gen = make_generators(53, DEVICE)
    for dev in set(devices):
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    sync_all()
    t0 = time.perf_counter()
    shards, stats = sh.run_chunk(ShardGenerators(gen), op_gen, sh.split(states),
                                 sh.new_stats(n), steps)
    sync_all()
    t_split = time.perf_counter() - t0
    peak = {dev: torch.cuda.max_memory_allocated(dev) / 1e9 for dev in sorted(set(devices))}
    launches, shard1 = counters(), shard_launches(sh, 1)
    if not shard1.get("marginal"):
        raise AssertionError(f"mesh scale: the marginal never launched on shard 1: {shard1}")
    errs = check_shards(sh, shards, stats)
    del shards
    gen, op_gen = make_generators(53, DEVICE)
    sync_all()
    t0 = time.perf_counter()
    rt.run_chunk(gen, op_gen, states, rt.new_stats(n), steps)
    sync_all()
    t_plain = time.perf_counter() - t0
    wide = [i for i, name in enumerate(rt.op_names) if "wide" in name]
    ops = [i for i in wide for _ in range(MESH["scale_wide_steps"])]
    gen, _ = make_generators(59, DEVICE)
    reset_counters()
    sync_all()
    t0 = time.perf_counter()
    sh.run_ops(ShardGenerators(gen), ops, sh.split(states), sh.new_stats(n))
    sync_all()
    t_wide_split = time.perf_counter() - t0
    launches = add_launches(launches, counters())
    gen, _ = make_generators(59, DEVICE)
    sync_all()
    t0 = time.perf_counter()
    rt.run_ops(gen, ops, states, rt.new_stats(n))
    sync_all()
    t_wide_plain = time.perf_counter() - t0
    return {"chains": n, "shards": sh.n_shards, "steps": steps,
            "steps_per_s": steps / t_split, "unsplit_steps_per_s": steps / t_plain,
            "split_over_unsplit": t_plain / t_split, "peak_memory_gb": peak,
            "wide": {"operators": [rt.op_names[i] for i in wide], "steps": len(ops),
                     "steps_per_s": len(ops) / t_wide_split,
                     "unsplit_steps_per_s": len(ops) / t_wide_plain,
                     "split_over_unsplit": t_wide_plain / t_wide_split},
            "launches": launches, "launches_shard1": shard1,
            "carried_vs_recompute_max_abs": errs}


def mesh_pool(tmp: Path) -> dict:
    """(d) The CLI's run pool: ``cli.main`` on the fixture's config (as
    JSON, its CSV files) with 2 runs and MESH["pool_steps"] steps, three
    ways: one process (the runs as one ensemble), two spawned processes
    (``-t 2``, each run alone on the card) and ``-i 0; -i 1`` one after the
    other; the wall time of each, and each run's stats and clusters files
    complete with finite likelihoods."""
    from sbayes_tpu_torch import cli

    fixtures = Path(__file__).resolve().parent / "tests" / "fixtures"
    cfg = json.loads(json.dumps(FIXTURE_CONFIG))
    cfg["data"] = {"features": str(fixtures / "features.csv"),
                   "feature_states": str(fixtures / "feature_states.csv")}
    samples = MESH["pool_samples"]
    cfg["mcmc"].update(runs=2, steps=MESH["pool_steps"], samples=samples)
    cfg["results"] = {"path": str(tmp / "pool"), "log_likelihood": False, "log_file": False,
                      "log_operator_step_times": False}
    path = tmp / "pool_config.json"
    path.write_text(json.dumps(cfg))
    wall = {}
    reset_counters()
    for name, kw in (("t1", {"processes": 1}), ("t2", {"processes": 2})):
        t0 = time.perf_counter()
        cli.main(path, experiment_name=f"pool_{name}", device=DEVICE, **kw)
        wall[name] = time.perf_counter() - t0
    stop_resource_tracker()
    t0 = time.perf_counter()
    for r in (0, 1):
        cli.main(path, experiment_name="pool_i0_i1", device=DEVICE, i_run=r)
    wall["i0_i1"] = time.perf_counter() - t0
    launches = counters()              # the runs in this process (t1, i0_i1)
    for name in ("t1", "t2", "i0_i1"):
        for r in (0, 1):
            out = tmp / "pool" / f"pool_{name}" / "K1"
            lh = [float(v) for v in stats_column(out / f"stats_K1_{r}.txt", "likelihood")]
            rows = (out / f"clusters_K1_{r}.txt").read_text().split()
            if len(lh) != samples or len(rows) != samples or not np.isfinite(lh).all():
                raise AssertionError(f"pool {name}, run {r}: {len(lh)} stats rows, "
                                     f"{len(rows)} cluster rows, finite {np.isfinite(lh).all()}")
    return {"runs": 2, "steps": MESH["pool_steps"], "samples": samples, "wall_s": wall,
            "t2_over_sequential": wall["t2"] / wall["i0_i1"],
            "t2_over_ensemble": wall["t2"] / wall["t1"], "launches_in_process": launches}


def phase_mesh(rt_k3, states_k3, rt_mc3, states_mc3, temps, rt_scale, states_scale,
               tmp: Path) -> tuple:
    """The chain split and the run pool, (a)-(d). Returns (phase info, the
    launches of (a), (b) and (d) in this process, the launches of (c))."""
    devices = mesh_devices()
    t0 = time.perf_counter()
    info = {"devices": list(devices),
            "split": ("every visible card" if torch.cuda.device_count() > 1
                      else "two shards on cuda:0 (one card)")}
    info["ensemble"] = mesh_ensemble(rt_k3, states_k3, devices)
    info["mc3"] = mesh_mc3(rt_mc3, states_mc3, temps, devices)
    info["scale"] = mesh_scale(rt_scale, states_scale, devices)
    info["pool"] = mesh_pool(tmp)
    info["phase_s"] = time.perf_counter() - t0
    launches = add_launches(info["ensemble"]["launches"], info["mc3"]["launches"],
                            info["pool"]["launches_in_process"])
    return info, launches, info["scale"]["launches"]


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def object_split_bytes(sp, state) -> dict:
    """Bytes each shard of the object split ``sp`` holds for ``state`` (a
    split chain batch): per block its constants' object-axis arrays and its
    block of the source; the head (with block 0) the head's constants and
    every other field of the chain state."""
    import dataclasses

    from sbayes_tpu_torch.parallel.mesh import OBJECT_ARRAYS

    blocks = [{"constants": tensor_bytes(*(getattr(blk, k) for k in OBJECT_ARRAYS)),
               "source": tensor_bytes(src)}
              for blk, src in zip(sp.blocks, state.source.blocks)]
    head = {"constants": tensor_bytes(*(getattr(sp.head, f.name)
                                        for f in dataclasses.fields(sp.head))),
            "state": tensor_bytes(*(x for x in state._replace(source=None)))}
    return {"blocks": blocks, "head": head}


def block_launches(sp, j: int) -> dict:
    """The kernel launches counted on object block ``j``'s device and stream."""
    from sbayes_tpu_torch.ops import loglh, marginal

    place = (sp.devices[j].index, sp.streams[j].cuda_stream)
    out = {"loglh_counts": sum(loglh.counts_launches.by_place.get(place, {}).values())}
    for key, n in marginal.launches.by_place.get(place, {}).items():
        out[marginal.variant_name(*key)] = n
    return out


def profiled_kernels(run, n_steps: int) -> float:
    """CUDA kernels (memory copies included) per step of ``run()`` (``n_steps``
    steps), from torch.profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        sync_all()
    return sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA") / n_steps


def loglh_split_rows(rt, sp, states, launches: dict, bit_equal: bool) -> list:
    """The ``kernels`` rows of the likelihood kernel's two split entries at
    the scale shape: ``loglh_counts`` on block 0's objects, ``loglh_from_counts``
    on the summed counts; each against its plain version on
    SCALE_KERNEL_CHAINS chains and timed there and on all chains."""
    from sbayes_tpu_torch.ops import loglh
    from sbayes_tpu_torch.parallel.mesh import shard_state

    few = shard_state(states.select(torch.arange(SCALE_KERNEL_CHAINS, device=DEVICE)), sp)
    whole = shard_state(states, sp)
    blk, lo_hi = sp.blocks[0], sp.bounds[0]

    def counts_of(st):
        return lambda: loglh.loglh_counts(blk, st.clusters[:, :, lo_hi[0]:lo_hi[1]],
                                          st.source.blocks[0])

    def from_counts_of(counts):
        return lambda: loglh.loglh_from_counts(rt.consts, *counts)

    got = counts_of(few)()
    want = loglh.loglh_counts_plain(blk, few.clusters[:, :, lo_hi[0]:lo_hi[1]],
                                    few.source.blocks[0])
    counts_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if counts_err != 0.0:
        raise AssertionError(f"loglh_counts differs from its plain version by {counts_err}")
    summed = sp.reduce(lambda j: loglh.loglh_counts(
        sp.blocks[j], sp.cols(j, few.clusters), few.source.blocks[j]))
    lh = from_counts_of(summed)()
    plain = loglh.loglh_from_counts_plain(rt.consts, *summed)
    fc_abs = float((lh - plain).abs().max())
    fc_rel = fc_abs / float(plain.abs().max())
    if not fc_rel <= LOGLH_TOL_REL:
        raise AssertionError(f"loglh_from_counts differs from its plain version by {fc_rel} "
                             f"relative")
    packed = whole.source.dtype == torch.int8
    rows = []
    for name, run_few, run_all, plain_fn, n_bytes, n_ops, err in (
            ("loglh_counts", counts_of(few), counts_of(whole),
             lambda: loglh.loglh_counts_plain(blk, few.clusters[:, :, lo_hi[0]:lo_hi[1]],
                                              few.source.blocks[0]),
             loglh.counts_bytes_moved(blk, SCALE_KERNEL_CHAINS, packed),
             loglh.counts_operations(blk, SCALE_KERNEL_CHAINS, packed), counts_err),
            ("loglh_from_counts", from_counts_of(summed), None,
             lambda: loglh.loglh_from_counts_plain(rt.consts, *summed),
             loglh.from_counts_bytes_moved(rt.consts, SCALE_KERNEL_CHAINS),
             loglh.from_counts_operations(*summed), fc_abs)):
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        row = {"name": name, "route": "cuda", "source": "sbayes_tpu_torch/csrc/loglh.cu",
               "replaces": "sbayes_tpu/ops/pallas_kernels.py:82", "inputs": "scale",
               "chains": SCALE_KERNEL_CHAINS, "launches": launches.get(name, 0),
               "launches_by_path": {"data_mesh": launches.get(name, 0)},
               "max_abs_err": err, "ms": cuda_time_ms(run_few, 5),
               "device_ms": device_time_ms(run_few, 2, 3),
               "plain_ms": cuda_time_ms(plain_fn, 3), "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None, "bytes": n_bytes, "operations": n_ops}
        if name == "loglh_counts":
            row["block_objects"] = lo_hi[1] - lo_hi[0]
            row["all_chains"] = {"chains": states.n_chains, "ms": cuda_time_ms(run_all, 3),
                                 "device_ms": device_time_ms(run_all, 2, 3)}
        else:
            row["max_rel_err"] = fc_rel
            row["equals_fused_kernel_bits"] = bit_equal
        rows.append(row)
    return rows


def phase_data_mesh(rt, states) -> tuple:
    """The object-axis split at the scale shape: ``scale``'s in-bounds states
    on a 1 x 2 chains x objects grid (``data_mesh``; ``mesh_devices``' first
    two: one card each, or both on cuda:0), DATA_MESH["steps"] drawn steps of
    ``run_chunk`` and the exact ``refresh``, then the unsplit run from the same
    start and generators; then DATA_MESH["wide_steps"] steps of the wide
    operator split and unsplit. Checks: the carried state against the split
    recompute, the counts of the gathered states against the unsplit
    recompute (bit-equal), the split log-likelihood (``loglh_from_counts``
    of the summed block counts) against the fused kernel on the whole state
    (bit-equal) and against the unsplit recompute (tolerance), the counts
    entry and the marginal launched on each block's stream. Numbers:
    steps/s split and unsplit, kernels per step of each (profiled windows),
    bytes copied between the shards per step, the bytes each shard holds
    and the peak a card of a two-card split would hold. Returns (phase
    info, the launches of the split steps and refresh, the kernel rows)."""
    from sbayes_tpu_torch.ops import loglh
    from sbayes_tpu_torch.parallel.mesh import ShardGenerators, data_mesh
    from sbayes_tpu_torch.sampling.runner import grid_runtime, make_generators

    t_phase = time.perf_counter()
    devices = list(mesh_devices()[:DATA_MESH["shards"]])
    grid = data_mesh(1, DATA_MESH["shards"], devices)
    n, steps = states.n_chains, DATA_MESH["steps"]
    t0 = time.perf_counter()
    sh = grid_runtime(rt, grid)
    sp = sh.splits[0]
    split = sh.split(states)
    sync_all()
    t_setup = time.perf_counter() - t0
    held = object_split_bytes(sp, split[0])

    cards = sorted(set(devices))
    base = {d: torch.cuda.memory_allocated(d) for d in cards}
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    gen, op_gen = make_generators(61, DEVICE)
    reset_counters()
    sp.traffic.reset()
    sync_all()
    t0 = time.perf_counter()
    shards, stats = sh.run_chunk(ShardGenerators(gen), op_gen, split, sh.new_stats(n), steps)
    sync_all()
    t_split = time.perf_counter() - t0
    traffic_steps = dict(sp.traffic.bytes)
    sp.traffic.reset()
    refs = sh.refresh(shards)
    sync_all()
    traffic_refresh = dict(sp.traffic.bytes)
    transient = {d: (torch.cuda.max_memory_allocated(d) - base[d]) / 1e9 for d in cards}
    launches = counters()
    per_block = [block_launches(sp, j) for j in range(sp.n_blocks)]
    for j, counts in enumerate(per_block):
        if not counts.get("loglh_counts") or not counts.get("marginal"):
            raise AssertionError(f"data_mesh: block {j} launched {counts}")
    if not launches.get("loglh_from_counts"):
        raise AssertionError(f"data_mesh: loglh_from_counts never launched: {launches}")
    errs = check_carried_state(sp.head, shards[0], refs[0], stats[0])

    whole = sh.gather(shards)
    ref_unsplit = rt.refresh(whole)
    for key in ("cl_counts", "conf_counts", "pat_counts"):
        if not torch.equal(getattr(refs[0], key), getattr(ref_unsplit, key)):
            raise AssertionError(f"data_mesh: split {key} differ from the unsplit recompute")
    fused = loglh.log_likelihood(rt.consts, whole.clusters, whole.source)
    bit_equal = bool(torch.equal(refs[0].log_lh, fused))
    if not bit_equal:
        raise AssertionError("data_mesh: loglh_from_counts of the summed block counts differs "
                             "from the fused kernel")
    lh_rel = float((refs[0].log_lh - ref_unsplit.log_lh).abs().max()
                   / ref_unsplit.log_lh.abs().max())
    if not lh_rel <= LOGLH_TOL_REL:
        raise AssertionError(f"data_mesh: split log-likelihood vs unsplit recompute {lh_rel}")
    del whole, ref_unsplit, refs, fused

    gen, op_gen = make_generators(61, DEVICE)
    sync_all()
    t0 = time.perf_counter()
    plain, _ = rt.run_chunk(gen, op_gen, states, rt.new_stats(n), steps)
    sync_all()
    t_plain = time.perf_counter() - t0
    del plain

    wide = [i for i, name in enumerate(rt.op_names) if "wide" in name]
    ops = [i for i in wide for _ in range(DATA_MESH["wide_steps"])]
    gen, _ = make_generators(67, DEVICE)
    sp.traffic.reset()
    sync_all()
    t0 = time.perf_counter()
    sh.run_ops(ShardGenerators(gen), ops, sh.split(states), sh.new_stats(n))
    sync_all()
    t_wide_split = time.perf_counter() - t0
    traffic_wide = dict(sp.traffic.bytes)
    gen, _ = make_generators(67, DEVICE)
    sync_all()
    t0 = time.perf_counter()
    rt.run_ops(gen, ops, states, rt.new_stats(n))
    sync_all()
    t_wide_plain = time.perf_counter() - t0

    k = DATA_MESH["profile_steps"]
    prof_ops = rt.draw_ops(make_generators(71, DEVICE)[1], k)
    kernels_split = profiled_kernels(lambda: sh.run_ops(
        ShardGenerators(make_generators(73, DEVICE)[0]), prof_ops, sh.split(states),
        sh.new_stats(n)), k)
    kernels_plain = profiled_kernels(lambda: rt.run_ops(
        make_generators(73, DEVICE)[0], prof_ops, states, rt.new_stats(n)), k)

    rows = loglh_split_rows(rt, sp, states, launches, bit_equal)
    gb = 1e9
    resident = [(b["constants"] + b["source"]) / gb for b in held["blocks"]]
    resident[0] += (held["head"]["constants"] + held["head"]["state"]) / gb
    one_card = len(cards) == 1
    info = {"grid": [[str(d) for d in row] for row in grid],
            "split": "two object shards on cuda:0 (one card)" if one_card
            else "one object shard per card",
            "chains": n, "N": rt.consts.N, "F": rt.consts.F, "bounds": list(sp.bounds),
            "setup_s": t_setup, "steps": steps,
            "steps_per_s": steps / t_split, "unsplit_steps_per_s": steps / t_plain,
            "split_over_unsplit": t_plain / t_split,
            "wide": {"operators": [rt.op_names[i] for i in wide], "steps": len(ops),
                     "steps_per_s": len(ops) / t_wide_split,
                     "unsplit_steps_per_s": len(ops) / t_wide_plain,
                     "split_over_unsplit": t_wide_plain / t_wide_split,
                     "bytes_copied_per_step": {kk: v / len(ops)
                                               for kk, v in traffic_wide.items()}},
            "kernels_per_step": {"split": kernels_split, "unsplit": kernels_plain,
                                 "added": kernels_split - kernels_plain,
                                 "profiled_steps": k},
            "bytes_copied_per_step": {kk: v / steps for kk, v in traffic_steps.items()},
            "bytes_copied_refresh": traffic_refresh,
            "bytes_held": held, "resident_gb": resident,
            "step_transient_gb": transient,
            # One card holds both shards here: a card of a two-card split
            # would hold its shard's tensors plus at most the whole step's
            # transient (both shards' work landed on this card).
            "card_estimate_gb": ([r + transient[cards[0]] for r in resident] if one_card
                                 else {str(d): torch.cuda.max_memory_allocated(d) / gb
                                       for d in cards}),
            "launches": launches, "launches_per_block": per_block,
            "launches_per_step": {kk: v / steps for kk, v in launches.items()},
            "carried_vs_recompute_max_abs": errs, "loglh_vs_unsplit_rel": lh_rel,
            "loglh_from_counts_equals_fused": bit_equal}
    del sh, sp, split, shards
    info["phase_s"] = time.perf_counter() - t_phase
    return info, launches, rows


def add_launches(*launch_counts) -> dict:
    """The sum of several launch-count dicts."""
    out = {}
    for counts in launch_counts:
        for k, v in counts.items():
            out[k] = out.get(k, 0) + v
    return out


# Shapes of the revision check: the main path's, and two where the kernels
# tile (jump_512's marginal, the likelihood's feature tiles at 400 features).
REVISION_SHAPES = {"main": dict(n_chains=1024, n_features=36, n_clusters=1),
                   "jump_512": dict(n_chains=64, n_features=512, n_clusters=2),
                   "tiled_400": dict(n_chains=64, n_features=400, n_clusters=1)}
REVISION_STEPS = 200


def revision_outputs(root: str, out: str) -> None:
    """Both kernels of the ``sbayes_tpu_torch`` under ``root`` (a ``git
    archive`` of a revision, or this one) on inputs drawn from a seed at
    REVISION_SHAPES: every output saved to ``out`` (.npz), the device time
    per launch and the time per eager call printed, with the chain-steps/s
    of that revision's full-width ``run_chunk`` at K = 1 and 3."""
    sys.path.insert(0, str(Path(root).resolve()))
    import sbayes_tpu_torch
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.ops import loglh, marginal
    from sbayes_tpu_torch.sampling.runner import make_generators
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    saved, times, eager = {}, {}, {}
    for shape, kw in REVISION_SHAPES.items():
        c = Model(synthetic_data(n_features=kw["n_features"]),
                  synthetic_config(n_clusters=kw["n_clusters"]).model, device=DEVICE).consts
        inputs = random_kernel_inputs(c, kw["n_chains"], seed=3)
        calls = {"loglh": lambda: loglh.log_likelihood(c, inputs["clusters"], inputs["source"])}
        for variant in marginal.VARIANTS:
            args, vkw = marginal_variant_args(inputs, *variant)
            calls[marginal.variant_name(*variant)] = (
                lambda args=args, vkw=vkw: marginal.marginal(c, *args, **vkw))
        for name, call in calls.items():
            saved[f"{shape}:{name}"] = call().cpu().numpy()
            times[f"{shape}:{name}"] = device_time_ms(call)
            eager[f"{shape}:{name}"] = cuda_time_ms(call)
    np.savez(out, **saved)
    rates = {}
    for k, geo in ((1, "uniform"), (3, "cost_based")):
        rt = full_width_runtime(k, geo)
        gen, op_gen = make_generators(7, DEVICE)
        states, stats = rt.init_chains(gen, CHAINS), rt.new_stats(CHAINS)
        states, stats = rt.run_chunk(gen, op_gen, states, stats, REVISION_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.run_chunk(gen, op_gen, states, stats, REVISION_STEPS)
        torch.cuda.synchronize()
        rates[f"K{k}_{geo}"] = CHAINS * REVISION_STEPS / (time.perf_counter() - t0)
    print(json.dumps({"package": sbayes_tpu_torch.__file__, "device_ms": times,
                      "eager_ms": eager, "chain_steps_per_s": rates, "card": card_line()}),
          flush=True)


def compare_revisions(a: str, b: str) -> int:
    """Bit equality of two ``revision_outputs`` files; non-zero unless every
    output at the main shapes is bit-equal."""
    xa, xb = np.load(a), np.load(b)
    if set(xa.files) != set(xb.files):
        raise SystemExit(f"different outputs: {sorted(xa.files)} / {sorted(xb.files)}")
    equal = {k: bool(np.array_equal(xa[k], xb[k])) for k in sorted(xa.files)}
    diff = {k: float(np.abs(xa[k] - xb[k]).max()) for k in sorted(xa.files)}
    print(json.dumps({"bit_equal": equal, "max_abs_diff": diff}), flush=True)
    return 0 if all(v for k, v in equal.items() if k.startswith("main:")) else 1


T_START = time.perf_counter()


def phase_line(info: dict) -> str:
    """One phase's JSON line, with the seconds since the script started."""
    return json.dumps({**info, "elapsed_s": time.perf_counter() - T_START})


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "compare":
        return compare_revisions(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    warnings.simplefilter("ignore")
    if len(sys.argv) == 4 and sys.argv[1] == "revision":
        revision_outputs(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    from sbayes_tpu_torch.ops import _cuda

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    lib_path = _cuda.build(verbose=True)
    _cuda.library()
    print(phase_line({"phase": "build", "library": str(lib_path),
                      "build_s": time.perf_counter() - t0}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        main_path = phase_main_path(Path(tmp))
        print(phase_line({"phase": "main_path", **main_path}), flush=True)
        main_path_k3 = phase_main_path(Path(tmp), n_clusters=3, geo=GEO_K3)
        print(phase_line({"phase": "main_path_k3", **main_path_k3}), flush=True)
        main_path_mc3 = phase_main_path_mc3(Path(tmp))
        print(phase_line({"phase": "main_path_mc3", **main_path_mc3}), flush=True)
        print(phase_line({"phase": "resume", **phase_resume(Path(tmp))}), flush=True)
        init_methods = phase_init_methods(Path(tmp))
        print(phase_line({"phase": "init_methods", **init_methods}), flush=True)
        workflow = phase_workflow(Path(tmp))
        print(phase_line({"phase": "workflow", "card": card, **workflow}), flush=True)

    rt, states, full = phase_full_width(CHAINS, STEPS)
    full.update({"device": torch.cuda.get_device_name(0), "card": card})
    print(phase_line({"phase": "full_width", **full}), flush=True)
    print(phase_line({"phase": "where_time_goes", "card": card,
                      **phase_where_time_goes(rt, states)}), flush=True)

    rt_k3, states_k3, full_k3 = phase_full_width(CHAINS, STEPS_K3, n_clusters=3,
                                                 geo_prior="cost_based")
    time_k3 = phase_where_time_goes(rt_k3, states_k3)
    full_k3.update({"device": torch.cuda.get_device_name(0), "card": card,
                    "kernels_per_step": time_k3["kernels_per_step"],
                    "device_busy_share": time_k3["device_busy_share"]})
    print(phase_line({"phase": "full_width_k3", **full_k3}), flush=True)
    print(phase_line({"phase": "where_time_goes_k3", "card": card, **time_k3}), flush=True)

    temps = ladder_temperatures(CHAINS)
    rt_mc3, states_mc3, full_mc3 = phase_full_width(CHAINS, STEPS_K3, n_clusters=3,
                                                    geo_prior="cost_based", temps=temps)
    time_mc3 = phase_where_time_goes(rt_mc3, states_mc3, temps=temps)
    full_mc3.update({"device": torch.cuda.get_device_name(0), "card": card,
                     "kernels_per_step": time_mc3["kernels_per_step"],
                     "device_busy_share": time_mc3["device_busy_share"],
                     "op_ms_per_step": time_mc3["op_ms_per_step"],
                     "update_geo": time_mc3["update_geo"],
                     "full_width_k3": {k: full_k3[k] for k in (
                         "steps_per_s", "kernels_per_step", "device_busy_share")}})
    print(phase_line({"phase": "full_width_mc3", **full_mc3}), flush=True)

    jump_512 = phase_jump_512()
    print(phase_line({"phase": "jump_512", "card": card, **jump_512}), flush=True)

    ess = {}
    for geo_prior in ("uniform", "cost_based"):
        ess[geo_prior] = phase_ess(geo_prior)
        print(phase_line({"phase": "ess", "card": card, **ess[geo_prior]}), flush=True)
    alt = phase_alt_operators(rt_k3, states_k3, rt_mc3, states_mc3, temps)
    print(phase_line({"phase": "alt_operators", "card": card, **alt}), flush=True)
    prior = phase_prior_samples(rt_k3)
    print(phase_line({"phase": "prior_samples", "card": card, **prior}), flush=True)
    scale, scale_rows, rt_scale, states_scale = phase_scale()
    mc3_start = states_scale.select(torch.arange(SCALE_MC3["rungs"], device=DEVICE))
    print(phase_line({"phase": "scale", "card": card, **scale}), flush=True)
    torch.cuda.empty_cache()
    scale_geo, geo_launches = phase_scale_geo(rt_scale.model.data)
    print(phase_line({"phase": "scale_geo", "card": card, **scale_geo}), flush=True)
    torch.cuda.empty_cache()
    scale_mc3, mc3_launches, heat_mc3 = phase_scale_mc3(rt_scale, mc3_start)
    print(phase_line({"phase": "scale_mc3", "card": card, **scale_mc3}), flush=True)
    del mc3_start
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mesh, mesh_launches, mesh_scale_launches = phase_mesh(
            rt_k3, states_k3, rt_mc3, states_mc3, temps, rt_scale, states_scale, Path(tmp))
    print(phase_line({"phase": "mesh", "card": card, **mesh}), flush=True)
    torch.cuda.empty_cache()
    data_mesh, data_mesh_launches, data_mesh_rows = phase_data_mesh(rt_scale, states_scale)
    print(phase_line({"phase": "data_mesh", "card": card, **data_mesh}), flush=True)
    del rt_scale, states_scale
    torch.cuda.empty_cache()
    later_scale = {**geo_launches, "scale_mc3": mc3_launches}
    # The scale rows' "mesh" path is the split at scale; the other rows have
    # it as "mesh_scale" beside their own "mesh".
    add_scale_paths(scale_rows, {**later_scale, "mesh": mesh_scale_launches,
                                 "data_mesh": data_mesh_launches}, heat_mc3)

    by_path = {"main_path": main_path["launches"], "main_path_k3": main_path_k3["launches"],
               "main_path_mc3": main_path_mc3["launches"], "jump_512": jump_512["launches"],
               "ess_uniform": ess["uniform"]["launches"],
               "ess_cost_based": ess["cost_based"]["launches"],
               "init_seed_points": init_methods["seed_points"]["launches"],
               "init_random_growth": init_methods["random_growth"]["launches"],
               "workflow": workflow["launches"],
               "alt_operators": add_launches(*(a["launches"] for a in alt.values())),
               "prior_samples": prior["launches"], "scale": scale["launches"],
               "scale_in_bounds": scale["in_bounds"]["launches"], **later_scale,
               "mesh": mesh_launches, "mesh_scale": mesh_scale_launches,
               "data_mesh": data_mesh_launches}
    residual_launches = add_launches(*(alt[k]["launches"] for k in (
        "wide_residual", "wide_residual_counts", "wide_residual_counts_mc3")))
    kernels = phase_kernels(rt, states, rt_k3, states_k3, rt_mc3, states_mc3, temps, by_path,
                            jump_512["two_eff"], residual_launches) + scale_rows + data_mesh_rows
    left = child_processes()
    if left:
        raise RuntimeError(f"processes started by the script still run: {left}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
