"""One run of one cell: set-up, the measured window, the traced part and
the comparison with the plain reference; prints the result line.

A cell is ``workloads/<cell>.json``: its configuration (``configs/
<config>.json``), its traffic (``kind``: ``ensemble`` or ``mc3``, the
chains, the chunk, the warm-up, the ladder) and the limits of its
comparison. The metrics that ``BENCHMARK.json`` lists for the cell are read
by ``metrics/<name>.py``, each from the run's ``Context``.

Set-up (``setup_s``, from the start of the process): the data from
``--seed`` (``datagen.py``), the model on the card, ``init_chains``
(``init_s``), every operator once, then ``warmup_steps`` steps as the window
takes them. The window: whole chunks until ``--seconds`` have passed, an
ensemble's through ``run_chunk``, a ladder's through ``run_mc3_chunk``, the
operators drawn by the program from the seed. With ``--trace 1`` one more
chunk of the same entry runs under the profiler (a ladder's spanning a swap
phase), then each operator a few times as single synchronised steps through
``run_ops``. Then the program's outputs go to the host, the program's state
is freed, and the reference judges them.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NOT_ALLOWED = ("jax", "jaxlib", "flax", "sbayes_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> tuple:
    """(cell, config) of the cell ``name``, found by name."""
    cell = load_json(HERE / "workloads" / f"{name}.json")
    return cell, load_json(HERE / "configs" / f"{cell['config']}.json")


def cell_metrics(cell: str, trace: bool, benchmark: dict) -> list:
    """The ``BENCHMARK.json`` metrics this cell reports: its end-to-end
    metrics, or with ``trace`` its per-layer ones. A metric with a
    ``workloads`` list belongs to those cells; an end-to-end metric without
    one to every cell; a per-layer metric without one to every cell that
    reports the end-to-end metric it moves."""
    e2e = [m for m in benchmark["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in benchmark["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------- the program


def port_data(arrays: dict):
    """The port's ``Data`` of the drawn arrays (universal + family)."""
    from sbayes_tpu_torch.data.loader import Confounder, Data, Features, Objects

    values = arrays["values"]
    N, F, _ = values.shape
    ids = [f"o{i}" for i in range(N)]
    applicable = arrays["applicable"]
    features = Features(
        values=values, names=np.asarray([f"f{j}" for j in range(F)]), states=applicable,
        state_names=[[f"s{j}" for j in range(int(applicable[f].sum()))] for f in range(F)],
        na_number=int((~values.any(-1)).sum()))
    families = arrays["families"]
    confounders = OrderedDict(
        universal=Confounder("universal", np.ones((1, N), bool), ["<ALL>"]),
        family=Confounder("family", families, [f"fam{i}" for i in range(len(families))]))
    return Data(objects=Objects(id=ids, locations=arrays["locations"], names=list(ids)),
                features=features, confounders=confounders,
                projection="epsg:4326" if arrays["geodesic"] else None, geo_costs="from_data")


def build_runtime(arrays: dict, config: dict, device):
    from sbayes_tpu_torch.config.schema import MCMCConfig, ModelConfig
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime

    model = Model(port_data(arrays), ModelConfig.from_dict(config["model"]), device=device)
    return SamplerRuntime(model, MCMCConfig.from_dict(config["mcmc"]))


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Snapshots:
    """The states of a sample of chains at the end of each chunk, copied to
    pinned host memory without waiting for the device."""

    FIELDS = ("clusters", "weights", "source", "log_lh", "log_prior")

    def __init__(self, idx, device):
        import torch

        self.idx = torch.as_tensor(idx, dtype=torch.long, device=device)
        self.pin = torch.device(device).type == "cuda"
        self.items: list = []

    def copy(self, states) -> dict:
        import torch

        snap = {}
        for k in self.FIELDS:
            x = getattr(states, k).index_select(0, self.idx)
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=self.pin)
            host.copy_(x, non_blocking=self.pin)
            snap[k] = host
        return snap

    def take(self, states, reported=None):
        self.items.append(dict(self.copy(states), reported=reported))

    def unmoved(self, start: dict) -> int:
        """(chain, chunk) pairs in which a checked chain's clusters, weights
        and source stayed exactly as at the end of the chunk before
        (``start`` before the first)."""
        import torch

        n, before = 0, start
        for snap in self.items:
            same = torch.ones(len(self.idx), dtype=torch.bool)
            for k in ("clusters", "weights", "source"):
                same &= (snap[k] == before[k]).flatten(1).all(1)
            n += int(same.sum())
            before = snap
        return n


class Context:
    """What a run measured, for the metric readers (``metrics/*.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run(cell_name: str, cell: dict, config: dict, seed: int, seconds: float, trace: bool,
        device, t_process: float, faults=None) -> dict:
    """One run; returns the parts of the result line and the comparison.
    ``faults`` (tests only) wraps the runtime to break the timed path."""
    import torch

    from sbayes_tpu_torch.ops import marginal as port_marginal
    from sbayes_tpu_torch.sampling.runner import make_generators

    from perfbench import datagen
    from perfbench.reference.posterior import Reference

    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    start_s = time.perf_counter() - t_process
    t0 = time.perf_counter()
    arrays = datagen.draw(config["data"], seed)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt = build_runtime(arrays, config, device)
    sync(device)
    model_s = time.perf_counter() - t0
    if faults is not None:
        faults(rt)
    B = int(cell["chains"])
    gen, op_gen = make_generators(seed, device)
    sync(device)
    t0 = time.perf_counter()
    states = rt.init_chains(gen, B)
    sync(device)
    init_s = time.perf_counter() - t0
    stats = rt.new_stats(B)
    mc3 = cell["kind"] == "mc3"
    temps = prior_temps = None
    if mc3:
        ladder = cell["ladder"]
        idx = np.arange(B)
        temps = torch.as_tensor(1 + ladder["temperature_diff"] * idx, dtype=torch.float32,
                                device=device)
        prior_temps = torch.as_tensor(1 + ladder["prior_temperature_diff"] * idx,
                                      dtype=torch.float32, device=device)
        n_pairs = B * (B - 1) // 2 if not ladder["only_adjacent"] else B - 1
        attempts = min(int(ladder["swap_attempts"]), n_pairs)
        swap_matrix = np.zeros((2, B, B), dtype=np.int64)
    chunk = int(cell["chunk"])
    step_index = int(cell.get("first_step", 0))

    def window_chunk(states, stats, n, step0=None):
        """One chunk as the window takes it (a ladder's from the global step
        ``step0``, by default the next): (states, stats, reported, proposals)."""
        nonlocal step_index
        if step0 is not None:
            step_index = step0
        if mc3:
            states, stats, _, att = rt.run_mc3_chunk(
                gen, op_gen, states, stats, temps, prior_temps, swap_matrix, step_index, n,
                int(ladder["swap_interval"]), attempts, bool(ladder["only_adjacent"]))
            step_index += n
            return states, stats, None, att
        states, stats, tr = rt.run_chunk(gen, op_gen, states, stats, n, trace=True)
        step_index += n
        return states, stats, tr, 0

    # Set-up: every operator once (at the cell's temperatures), then the warm-up.
    t0 = time.perf_counter()
    states, stats = rt.run_ops(gen, list(range(rt.n_ops)), states, stats, temps, prior_temps)
    sync(device)
    first_ops_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = step_index + int(cell["warmup_steps"])
    while step_index < warm:
        states, stats, _, _ = window_chunk(states, stats, min(chunk, warm - step_index))
    sync(device)
    warmup_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_process

    # The window.
    rng = np.random.default_rng(seed + 1)
    check_idx = np.sort(rng.choice(B, size=min(B, int(cell["check_chains"])), replace=False))
    snaps = Snapshots(check_idx, device)
    start_clusters, start_weights = states.clusters.clone(), states.weights.clone()
    start = snaps.copy(states)
    nonfinite0 = int(stats.non_finite.sum())
    step0 = step_index
    traces, proposals = [], 0
    t0 = time.perf_counter()
    while True:
        states, stats, tr, att = window_chunk(states, stats, chunk)
        proposals += att
        if tr is not None:
            traces.append(tr)
        snaps.take(states, None if tr is None else tr[-1][check_idx])
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    steps = step_index - step0
    trace_x = np.concatenate(traces).T.astype(np.float64) if traces else None

    ctx = Context(cell=cell_name, config=config, arrays=arrays, chains=B, steps=steps,
                  window_s=window_s, setup_s=setup_s, start_s=start_s, data_s=data_s,
                  model_s=model_s, init_s=init_s, first_ops_s=first_ops_s,
                  warmup_s=warmup_s, trace=trace_x, profile=None, op_ms={})
    if trace:
        next_swap = None
        if mc3:
            # The profiled chunk spans a swap phase: it starts half a chunk
            # before the next multiple of the swap interval.
            interval = int(ladder["swap_interval"])
            next_swap = -(-(step_index + chunk // 2) // interval) * interval - chunk // 2
        states, stats = traced_part(
            ctx, rt, lambda st, sa: window_chunk(st, sa, chunk, next_swap)[:2], chunk,
            int(cell["op_time_rounds"]), gen, states, stats, temps, prior_temps, device)

    # The program's outputs on the host: the end states, and the marginal
    # kernel on them (the whole batch, as the window launches it).
    in_conf = np.stack([np.ones(arrays["values"].shape[0], bool),
                        arrays["families"].any(0)], -1)
    ref_inputs = marginal_inputs(states, rt.consts.applicable, in_conf, temps)
    out = port_marginal.marginal(rt.consts, *[torch.as_tensor(x, device=device)
                                              for x in ref_inputs[:6]],
                                 None if ref_inputs[6] is None
                                 else torch.as_tensor(ref_inputs[6], device=device),
                                 ratio=True)
    sync(device)
    peak = int(torch.cuda.max_memory_allocated()) if is_cuda else 0
    program = {k: (None if getattr(states, k) is None else getattr(states, k).cpu().numpy())
               for k in ("clusters", "weights", "source", "log_lh", "log_prior", "prior_parts",
                         "cl_counts", "conf_counts", "pat_counts", "geo_agg")}
    program["marginal"] = out.cpu().numpy()
    # Unmoved chains: in an ensemble, chains whose clusters and weights the
    # window left as they were; on a ladder, whose swaps move states between
    # rungs at chunk ends, (checked chain, chunk) pairs without a change.
    moved = ((states.clusters != start_clusters).flatten(1).any(1)
             | (states.weights != start_weights).flatten(1).any(1))
    unmoved = snaps.unmoved(start) if mc3 else int((~moved).sum())
    failed = int(stats.non_finite.sum()) - nonfinite0
    rt.close()
    del rt, states, stats, start_clusters, start_weights, out
    if is_cuda:
        torch.cuda.empty_cache()
    ctx.memory_peak_bytes = peak

    # The reference judges them.
    t0 = time.perf_counter()
    ref = Reference(arrays, config["model"], device=device)
    numbers = judge(ref, program, snaps, ref_inputs)
    numbers["unmoved_chains"] = unmoved
    if mc3:
        interval = int(ladder["swap_interval"])
        due = (step0 + steps) // interval - step0 // interval
        numbers["swap_attempt_gap"] = abs(proposals - due * attempts)
    reference_s = time.perf_counter() - t0
    from perfbench.compare import decide

    correct, rows = decide(numbers, cell["limits"])
    ctx.reference_s = reference_s
    return {"ctx": ctx, "correct": correct, "rows": rows, "failed": failed,
            "attempted": B * steps, "numbers": numbers,
            "outputs": (program, snaps, ref_inputs)}


def marginal_inputs(states, applicable, in_conf, temps) -> tuple:
    """The marginal's inputs on ``states``, made by the benchmark and handed
    to the kernel and the reference alike (numpy, float32): the posterior
    mean effects of cluster 0 and of every confounder group from the carried
    counts, the weights, the components available to each object (``in_conf``
    (N, C-1): its confounders) with and without cluster 0, cluster 0's
    members and, on a ladder, 1 / T."""
    import torch

    a = applicable.float()
    p_eff = states.cl_counts[:, 0] + a
    conf_eff = states.conf_counts + a
    in_cluster = states.clusters.any(1)
    conf = torch.as_tensor(in_conf, device=in_cluster.device)[None].expand(
        in_cluster.shape[0], -1, -1)
    return tuple(None if x is None else x.detach().float().cpu().numpy() for x in (
        (p_eff / p_eff.sum(-1, keepdim=True))[:, None],
        conf_eff / conf_eff.sum(-1, keepdim=True), states.weights,
        torch.cat([in_cluster[..., None], conf], -1),
        torch.cat([~in_cluster[..., None], conf], -1), states.clusters[:, 0],
        None if temps is None else 1.0 / temps))


def judge(ref, program: dict, snaps: Snapshots, inputs: tuple) -> dict:
    """The numbers of ``compare.py`` for the program's outputs."""
    from perfbench.compare import rel_gap, state_numbers

    end = ref.evaluate(program["clusters"], program["weights"], program["source"])
    numbers = state_numbers(program, end, ref.min_size, ref.max_size)
    gaps = []
    for snap in snaps.items:
        s = ref.evaluate(*(snap[k].numpy() for k in ("clusters", "weights", "source")))
        reported = (snap["reported"] if snap["reported"] is not None
                    else snap["log_lh"].numpy().astype(np.float64) + snap["log_prior"].numpy())
        gaps.append(rel_gap(reported, s["log_lh"] + s["log_prior"]))
    numbers["chunk_end_gap"] = max(gaps) if gaps else math.inf
    idx = snaps.idx.cpu().numpy()
    sample = [None if x is None else x[idx] for x in inputs]
    numbers["marginal_gap"] = rel_gap(program["marginal"][idx], ref.marginal(*sample))
    return numbers


def traced_part(ctx, rt, take_chunk, steps, rounds, gen, states, stats, temps, prior_temps,
                device) -> tuple:
    """After the window: one more chunk of ``steps`` steps through the
    window's own entry (``take_chunk(states, stats)``) under the profiler,
    in the benchmark's span; the profiler's marginal launches are held
    against the program's own count, and a chunk that lost records is
    profiled again. Then each
    operator ``rounds`` times as a single synchronised step through
    ``run_ops``, timed on the host clock (``op_ms``). Returns (states,
    stats)."""
    import torch

    from sbayes_tpu_torch.ops.marginal import launches

    from perfbench.tracing import WINDOW, Window, read_chrome_trace

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    best = None
    for attempt in range(2):
        sync(device)
        before = launches.count
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                states, stats = take_chunk(states, stats)
                sync(device)
        counted = launches.count - before
        win = Window(read_chrome_trace(prof), steps)
        seen = len(win.kernels("marginal_kernel"))
        if best is None or seen > best[1]:
            best = (win, seen, counted)
        if seen == counted:
            break
        print(f"perfbench: the profiler saw {seen} of {counted} marginal launches in chunk "
              f"{attempt + 1}; profiling another", file=sys.stderr)
    win, seen, counted = best
    if seen != counted:
        print(f"perfbench: keeping the fuller chunk ({seen} of {counted} marginal launches)",
              file=sys.stderr)
    ctx.profile = win
    times: dict = {}
    for _ in range(rounds):
        for op in range(rt.n_ops):
            sync(device)
            t0 = time.perf_counter()
            states, stats = rt.run_ops(gen, [op], states, stats, temps, prior_temps)
            sync(device)
            times.setdefault(rt.op_names[op], []).append(time.perf_counter() - t0)
    ctx.op_ms = {k: 1e3 * float(np.mean(v)) for k, v in times.items()}
    return states, stats


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(NOT_ALLOWED))


def main(argv, t_process: float) -> int:
    parser = argparse.ArgumentParser(prog="perfbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("perfbench: no CUDA card; the benchmark does not run on the CPU",
              file=sys.stderr)
        return 2
    benchmark = load_json(ROOT / "BENCHMARK.json")
    cell, config = load_cell(args.workload)
    print(f"perfbench: {args.workload} seed {args.seed} on {card_line()}", file=sys.stderr)
    torch.set_num_threads(4)
    res = run(args.workload, cell, config, args.seed, args.seconds, bool(args.trace), "cuda",
              t_process)
    ctx = res["ctx"]
    metrics = {}
    for m in cell_metrics(args.workload, bool(args.trace), benchmark):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": ctx.memory_peak_bytes}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"], device["window_s"] = ctx.profile.busy_s, ctx.profile.window_s
        line["breakdown"] = {"device_ops": ctx.profile.top_device_ops(),
                             "idle_gaps": ctx.profile.idle_gaps()}
    line["run"] = {k: getattr(ctx, k) for k in (
        "steps", "window_s", "start_s", "data_s", "model_s", "init_s", "first_ops_s",
        "warmup_s", "reference_s")}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in res["rows"]}
    found = loaded_forbidden()
    if found:
        print(f"perfbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    for name, value, limit in res["rows"]:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    print(json.dumps(line))
    return 0
