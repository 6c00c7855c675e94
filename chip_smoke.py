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
   PyTorch version at the shapes of phase 3, timed with CUDA events beside
   the plain version and the memory/compute bound, and the likelihood kernel
   once more at 400 features, where its count table is walked in feature
   tiles; one ``kernels`` JSON line;
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
LOGLH_SMEM_BUDGET = 48 * 1024    # csrc/loglh.cu: kSmemBudget
LOGLH_TOL_REL = 1e-5             # lgammaf vs torch.lgamma, summation order (of the total)
MARGINAL_TOL_ABS = 1e-4          # 36 logs summed in another order (per object)


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


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def loglh_tiled_check(n_features: int = 400, n_chains: int = 64) -> dict:
    """The likelihood kernel against its plain version on data wide enough
    that its count table passes the shared-memory budget, so the kernel
    walks the features in tiles; random memberships and valid sources."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.ops import loglh
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    c = Model(synthetic_data(n_features=n_features), synthetic_config(n_clusters=1).model,
              device=DEVICE).consts
    row_bytes = (c.K + (c.C - 1) * c.Gmax) * c.S * 4
    f_tile = min(LOGLH_SMEM_BUDGET // row_bytes, c.F)
    if f_tile >= c.F:
        raise AssertionError(f"{c.F} features fit one tile of {f_tile}: no tiling to check")
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    clusters = torch.rand((n_chains, c.K, c.N), generator=gen, device=DEVICE) < 0.3
    avail = torch.cat([clusters.any(1)[..., None],
                       c.hc_conf[None].expand(n_chains, -1, -1).bool()], dim=-1)   # (B, N, C)
    score = torch.rand((n_chains, c.N, c.F, c.C), generator=gen, device=DEVICE)
    comp = (score * avail[:, :, None]).argmax(-1)
    source = torch.nn.functional.one_hot(comp, c.C).bool() & ~c.na[None, :, :, None]
    got = loglh.log_likelihood(c, clusters, source)
    want = loglh.log_likelihood_plain(c, clusters, source)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs()).max())
    if not rel <= LOGLH_TOL_REL:
        raise AssertionError(f"loglh kernel vs plain at F = {c.F} (tiles of {f_tile}): "
                             f"relative error {rel} > {LOGLH_TOL_REL}")
    return {"F": c.F, "f_tile": f_tile, "chains": n_chains, "max_rel_err": rel}


def phase_kernels(rt, states, launches: dict) -> list:
    """Each kernel and marginal variant against its plain version."""
    from sbayes_tpu_torch.ops import loglh, marginal
    from sbayes_tpu_torch.sampling.conditionals import _pick_cluster
    from sbayes_tpu_torch.model.math import normalize

    c = rt.consts
    B = states.n_chains
    out = []

    # Kernel 1: collapsed likelihood.
    got = loglh.log_likelihood(c, states.clusters, states.source)
    want = loglh.log_likelihood_plain(c, states.clusters, states.source)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs()).max())
    if not rel <= LOGLH_TOL_REL:
        raise AssertionError(f"loglh kernel vs plain: relative error {rel} > {LOGLH_TOL_REL}")
    ms = cuda_time_ms(lambda: loglh.log_likelihood(c, states.clusters, states.source))
    plain_ms = cuda_time_ms(lambda: loglh.log_likelihood_plain(c, states.clusters, states.source),
                            reps=10)
    # Count adds and lgamma calls, each lgamma as one operation: a lower bound.
    rows = c.K + (c.C - 1) * c.Gmax
    ops = B * (c.N * c.F * c.C + rows * c.F * (3 * c.S + 4))
    b_ms, b_by = bound_ms(loglh.bytes_moved(c, B), ops)
    out.append({"name": "loglh", "route": "cuda", "source": "sbayes_tpu_torch/csrc/loglh.cu",
                "replaces": "sbayes_tpu/ops/pallas_kernels.py:82", "launches": launches["loglh"],
                "max_abs_err": err, "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "bytes": loglh.bytes_moved(c, B), "feature_tiled": loglh_tiled_check()})

    # Kernel 2: membership marginal, all variants, on the states' own effects.
    ar = torch.arange(B, device=states.clusters.device)
    i_cluster = torch.zeros(B, dtype=torch.long, device=ar.device)
    hc = rt.post.has_components(states.clusters)
    hc_flip = hc.clone()
    hc_flip[..., 0] = ~hc[..., 0]
    p_eff = normalize(_pick_cluster(states.cl_counts, i_cluster) + c.conc_cluster[None])
    p_other = normalize(torch.roll(p_eff, 1, dims=0) + 0.1)
    conf_eff = normalize(states.conf_counts + c.conc_conf[None])
    wh = states.weights.contiguous()
    inv_t = torch.full((B,), 1.0 / 1.3, device=ar.device)
    args = (conf_eff, wh, hc.float(), hc_flip.float(), hc[..., 0].float())
    for ratio, heat, two_eff in marginal.VARIANTS:
        rows_e = p_eff[:, None] if (ratio and not two_eff) else torch.stack([p_eff, p_other], 1)
        it = inv_t if heat else None
        kw = dict(ratio=ratio, two_eff=two_eff)
        got = marginal.marginal(c, rows_e.contiguous(), *args, it, **kw)
        want = marginal.marginal_plain(c, rows_e, *args, it, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= MARGINAL_TOL_ABS:
            raise AssertionError(f"marginal {ratio, heat, two_eff} vs plain: {err}")
        ms = cuda_time_ms(lambda: marginal.marginal(c, rows_e.contiguous(), *args, it, **kw))
        plain_ms = cuda_time_ms(lambda: marginal.marginal_plain(c, rows_e, *args, it, **kw),
                                reps=10)
        n_bytes = marginal.bytes_moved(c, B, ratio, two_eff, heat)
        b_ms, b_by = bound_ms(n_bytes, marginal.operations(c, B, ratio, two_eff, heat))
        name = marginal.variant_name(ratio, heat, two_eff)
        out.append({"name": name, "route": "cuda", "source": "sbayes_tpu_torch/csrc/marginal.cu",
                    "replaces": "sbayes_tpu/ops/pallas_marginal.py:178",
                    "launches": launches.get(name, 0), "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None, "bytes": n_bytes})
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
