"""Chip smoke test of the PyTorch port (``sbayes_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds every CUDA kernel of
   ``sbayes_tpu_torch/csrc`` (one nvcc per source, all started together);
2. main path: ``MCMCSetup.sample_ensemble`` over 8 runs of the default model
   configuration (K = 1, uniform geo prior) on a synthetic dataset of the
   south_america shape (100 objects x 36 features x 6 states, universal + 6
   families), into a temporary directory; every results file must exist and
   both kernels must have been launched;
3. full width: ``SamplerRuntime.init_chains(CHAINS)``, STEPS steps in chunks of 200,
   an exact refresh; the carried log-likelihood / log-prior / counts must
   equal the recompute; one JSON line with the steps per second; then the
   wall time per step of each operator and, from torch.profiler, the
   device-busy share and kernels per step of the schedule;
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
   default; one ``kernels`` JSON
   line. ``ms``, ``plain_ms`` and ``launch_floor_ms`` time eager calls with
   CUDA events; ``device_ms`` and ``device_floor_ms`` time the same launches
   replayed from a CUDA graph, where the host dispatches nothing;
5. last line: ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero and prints no result
line. It needs a CUDA card and the repository beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12       # float32 outside the tensor cores
DEVICE = "cuda"
CHAINS = 1024                    # bench.py's chain count
STEPS = 1000
LOGLH_TOL_REL = 1e-5             # lgammaf vs torch.lgamma, summation order (of the total)
MARGINAL_TOL_ABS = 1e-4          # 36 logs summed in another order (per object)
MARGINAL_TOL_FEATURES = 36       # wider data: the tolerance grows with the logs summed


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def smoke_config(path: Path, results: Path) -> Path:
    """The default model configuration (K = 1, uniform geo) as a JSON config
    file; the data come from ``synthetic_data`` (the data paths are not read)."""
    placeholder = path / "features.csv"
    placeholder.write_text("id\n")
    cfg = {
        "data": {"features": str(placeholder), "feature_states": str(placeholder)},
        "model": {
            "clusters": 1,
            "confounders": ["universal", "family"],
            "prior": {
                "objects_per_cluster": {"type": "uniform_area", "min": 2, "max": 50},
                "geo": {"type": "uniform"},
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
    cfg_path = path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    return cfg_path


def reset_counters():
    from sbayes_tpu_torch.ops import loglh, marginal

    loglh.launches.count = 0
    marginal.launches.count = 0
    marginal.launches.variants.clear()


def counters() -> dict:
    from sbayes_tpu_torch.ops import loglh, marginal

    out = {"loglh": loglh.launches.count}
    for key, n in marginal.launches.variants.items():
        out[marginal.variant_name(*key)] = n
    return out


def phase_main_path(tmp: Path) -> dict:
    """sample_ensemble over 8 runs, as ``cli.main`` runs ``mcmc.runs > 1``."""
    from sbayes_tpu_torch.experiment import Experiment
    from sbayes_tpu_torch.sampling.runner import MCMCSetup
    from sbayes_tpu_torch.testing import synthetic_data

    cfg_path = smoke_config(tmp, tmp / "results")
    experiment = Experiment(config_file=cfg_path, experiment_name="smoke", log=True)
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
            f = mcmc.get_results_file_path(prefix, r, suffix)
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
    if launches["loglh"] == 0 or launches.get("marginal", 0) == 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    return {"runs": len(runs), "wall_s": wall, "launches": launches}


def phase_full_width(n_chains: int, n_steps: int) -> tuple:
    """init_chains(n) + n_steps steps in chunks of 200 + an exact refresh."""
    from sbayes_tpu_torch.config.schema import MCMCConfig
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    data = synthetic_data()
    cfg = synthetic_config(n_clusters=1)
    model = Model(data, cfg.model, device=DEVICE)
    rt = SamplerRuntime(model, MCMCConfig.from_dict({"steps": 1000, "samples": 5}))
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
        states, stats = rt.run_chunk(gen, op_gen, states, stats, chunk)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = counters()
    ref = rt.refresh(states)
    torch.cuda.synchronize()
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
    if int(stats.non_finite.sum()) != 0:
        raise AssertionError("non-finite posterior accepted")
    if launches["loglh"] == 0 or launches.get("marginal", 0) == 0:
        raise AssertionError(f"a kernel was not launched at full width: {launches}")
    c = model.consts
    info = {"chains": n_chains, "N": c.N, "F": c.F, "S": c.S, "C": c.C, "Gmax": c.Gmax,
            "K": c.K, "steps": n_steps, "init_s": t_init, "run_s": t_run,
            "steps_per_s": n_steps / t_run, "chain_steps_per_s": n_chains * n_steps / t_run,
            "launches": launches, "launches_per_step": {k: v / n_steps for k, v in
                                                        launches.items()},
            "carried_vs_recompute_max_abs": errs,
            "accept_rate": float(stats.accepts.sum()) / float(
                (stats.accepts + stats.rejects).sum())}
    return rt, ref, info


def phase_where_time_goes(rt, states, reps: int = 10) -> dict:
    """Per-operator wall time of one MH step of the whole batch (each
    operator alone, synchronised), and over a 50-step window of the schedule
    the device-busy share and CUDA kernels per step from torch.profiler."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    gen, op_gen = make_generators(11, "cuda")
    op_ms = {}
    for i, name in enumerate(rt.op_names):
        st = rt._apply(i, gen, states)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            st = rt._apply(i, gen, st)[0]
        torch.cuda.synchronize()
        op_ms[name] = (time.perf_counter() - t0) / reps * 1e3
    n_steps = 50
    stats = rt.new_stats(states.n_chains)
    rt.run_chunk(gen, op_gen, states, stats, 5)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rt.run_chunk(gen, op_gen, states, stats, n_steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0 and e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"op_ms_per_step": op_ms, "schedule_weights": rt.op_weights.tolist(),
            "window_steps": n_steps, "window_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms if busy_ms else None,
            "kernels_per_step": sum(e.count for e in kernels) / n_steps,
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top}}


def cuda_time_ms(fn, reps: int = 50) -> float:
    """Milliseconds per eager call: CUDA events around ``reps`` calls, so host
    dispatch counts where it is slower than the device."""
    for _ in range(5):
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
    on ``inputs``; raises beyond a tolerance, returns the largest errors."""
    from sbayes_tpu_torch.ops import loglh, marginal

    got = loglh.log_likelihood(c, inputs["clusters"], inputs["source"])
    want = loglh.log_likelihood_plain(c, inputs["clusters"], inputs["source"])
    again = [loglh.log_likelihood(c, inputs["clusters"], inputs["source"]) for _ in range(4)]
    torch.cuda.synchronize()
    if not all(torch.equal(got, other) for other in again):
        raise AssertionError("loglh kernel: launches on the same inputs differ in bits")
    errs = {"loglh_abs": float((got - want).abs().max()),
            "loglh_rel": float(((got - want).abs() / want.abs()).max())}
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


def phase_kernels(rt, states, launches: dict) -> list:
    """Each kernel and marginal variant against its plain version."""
    from sbayes_tpu_torch.ops import loglh, marginal

    c = rt.consts
    B = states.n_chains
    inputs = path_kernel_inputs(rt, states)
    errs = compare_with_plain(c, inputs)
    floor = launch_floor()
    out = []

    # Kernel 1: collapsed likelihood.
    def run_loglh():
        return loglh.log_likelihood(c, states.clusters, states.source)

    plain_ms = cuda_time_ms(lambda: loglh.log_likelihood_plain(c, states.clusters, states.source),
                            reps=10)
    n_bytes = loglh.bytes_moved(c, B)
    b_ms, b_by = bound_ms(n_bytes, loglh.operations(c, B))
    out.append({"name": "loglh", "route": "cuda", "source": "sbayes_tpu_torch/csrc/loglh.cu",
                "replaces": "sbayes_tpu/ops/pallas_kernels.py:82", "launches": launches["loglh"],
                "max_abs_err": errs["loglh_abs"], "max_rel_err": errs["loglh_rel"],
                "ms": cuda_time_ms(run_loglh), "device_ms": device_time_ms(run_loglh),
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "bytes": n_bytes, **floor, "feature_tiled": tiled_check(),
                "odd_shape": odd_shape_check(), "components": components_check(), "many_groups": many_groups_check()})

    # Kernel 2: membership marginal, all variants, on the states' own effects.
    for variant in marginal.VARIANTS:
        args, kw = marginal_variant_args(inputs, *variant)

        def run_marginal():
            return marginal.marginal(c, *args, **kw)

        plain_ms = cuda_time_ms(lambda: marginal.marginal_plain(c, *args, **kw), reps=10)
        ratio, heat, two_eff = variant
        n_bytes = marginal.bytes_moved(c, B, ratio, two_eff, heat)
        b_ms, b_by = bound_ms(n_bytes, marginal.operations(c, B, ratio, two_eff, heat))
        name = marginal.variant_name(*variant)
        out.append({"name": name, "route": "cuda", "source": "sbayes_tpu_torch/csrc/marginal.cu",
                    "replaces": "sbayes_tpu/ops/pallas_marginal.py:178",
                    "launches": launches.get(name, 0), "max_abs_err": errs[name],
                    "ms": cuda_time_ms(run_marginal), "device_ms": device_time_ms(run_marginal),
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None, "bytes": n_bytes, **floor})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    warnings.simplefilter("ignore")
    from sbayes_tpu_torch.ops import _cuda

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    lib_path = _cuda.build(verbose=True)
    _cuda.library()
    print(json.dumps({"phase": "build", "library": str(lib_path),
                      "build_s": time.perf_counter() - t0}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        main_path = phase_main_path(Path(tmp))
    print(json.dumps({"phase": "main_path", **main_path}), flush=True)

    rt, states, full = phase_full_width(CHAINS, STEPS)
    full.update({"device": torch.cuda.get_device_name(0), "card": card})
    print(json.dumps({"phase": "full_width", **full}), flush=True)

    print(json.dumps({"phase": "where_time_goes", "card": card,
                      **phase_where_time_goes(rt, states)}), flush=True)

    kernels = phase_kernels(rt, states, main_path["launches"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
