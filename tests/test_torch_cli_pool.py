"""The port's CLI run pool (``-t/--threads``) and its config file dialog, on
the CPU: ``-t 2`` writes what ``-i r`` writes alone, in spawned processes;
a task's exception ends the CLI with a non-zero exit; under a CUDA device
the tasks take the cards in turn; with one process the runs stay one
ensemble; without a config and a display the CLI errors as the JAX CLI
does."""
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

ROOT = Path(__file__).parent.parent
FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture
def fixture_dir(tmp_path):
    for f in ("config.yaml", "features.csv", "feature_states.csv"):
        shutil.copy(FIXTURES / f, tmp_path / f)
    return tmp_path


def _columns(path: Path, names: tuple) -> dict:
    lines = path.read_text().splitlines()
    header = lines[0].split("\t")
    rows = [line.split("\t") for line in lines[1:]]
    return {n: [r[header.index(n)] for r in rows] for n in names}


def test_pool_writes_what_each_run_writes_alone(fixture_dir):
    """``-t 2 --device cpu`` with ``runs: 2``: for each run the same clusters
    file, bit for bit, and the same likelihood, prior and posterior columns
    as ``-i r`` alone; the pool ran in two spawned processes."""
    import json

    import yaml

    from sbayes_tpu_torch import cli
    from sbayes_tpu_torch.utils import update_recursive

    cfg = fixture_dir / "config.json"
    settings = yaml.safe_load((fixture_dir / "config.yaml").read_text())
    update_recursive(settings, {"mcmc": {"runs": 2, "steps": 200, "samples": 10},
                                "results": {"path": str(fixture_dir / "results"),
                                            "log_likelihood": False,
                                            "log_operator_step_times": False}})
    cfg.write_text(json.dumps(settings))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.cli([str(cfg), "-n", "pool", "-t", "2", "--device", "cpu"])
        for r in (0, 1):
            cli.cli([str(cfg), "-n", f"alone{r}", "-i", str(r), "--device", "cpu"])
    logs = sorted((fixture_dir / "results" / "pool").glob("experiment_K1_*.log"))
    assert [p.name for p in logs] == ["experiment_K1_0.log", "experiment_K1_1.log"]
    cols = ("Sample", "posterior", "likelihood", "prior")
    for r in (0, 1):
        pool = fixture_dir / "results" / "pool" / "K1"
        alone = fixture_dir / "results" / f"alone{r}" / "K1"
        assert (pool / f"clusters_K1_{r}.txt").read_text() == \
            (alone / f"clusters_K1_{r}.txt").read_text()
        got = _columns(pool / f"stats_K1_{r}.txt", cols)
        assert got == _columns(alone / f"stats_K1_{r}.txt", cols)
        assert len(got["likelihood"]) == 10
    # the runs differ: each task ran its own run id
    assert (fixture_dir / "results" / "pool" / "K1" / "clusters_K1_0.txt").read_text() != \
        (fixture_dir / "results" / "pool" / "K1" / "clusters_K1_1.txt").read_text()


def test_a_failed_task_ends_the_cli_non_zero(fixture_dir):
    """A data file the spawned task cannot read (a row longer than the
    header): the task's ValueError reaches the parent, and ``python -m
    sbayes_tpu_torch ... -t 2`` exits non-zero naming it."""
    features = fixture_dir / "features.csv"
    lines = features.read_text().splitlines()
    features.write_text("\n".join(lines[:2] + [lines[2] + ",extra"] + lines[3:]) + "\n")
    out = subprocess.run(
        [sys.executable, "-m", "sbayes_tpu_torch", str(fixture_dir / "config.yaml"),
         "-n", "broken", "-t", "2", "-K", "1", "2", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "ValueError" in out.stderr and "the header has" in out.stderr, out.stderr[-2000:]


def test_pool_tasks_take_the_cards_in_turn(monkeypatch, fixture_dir):
    """Under ``--device cuda`` task i runs on ``cuda:{i % device_count}``
    (an explicit index or the CPU stays as given); each (run, K) task runs
    alone (``mcmc.runs: 1``) in a pool of spawned processes; with one
    process the runs of one K stay one ensemble."""
    import torch

    from sbayes_tpu_torch import cli
    from sbayes_tpu_torch.sampling import runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [cli.pool_device("cuda", i) for i in range(3)] == ["cuda:0", "cuda:1", "cuda:0"]
    assert cli.pool_device("cuda:1", 0) == "cuda:1" and cli.pool_device("cpu", 1) == "cpu"

    seen = {}

    class FakePool:
        def __init__(self, max_workers, mp_context):
            seen["workers"], seen["method"] = max_workers, mp_context.get_start_method()

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def map(self, fn, tasks):
            seen["fn"], seen["tasks"] = fn, list(tasks)
            return []

    monkeypatch.setattr(cli, "ProcessPoolExecutor", FakePool)
    settings = {"mcmc": {"runs": 2}, "results": {"path": str(fixture_dir / "results")}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(fixture_dir / "config.yaml", custom_settings=settings, processes=3,
                 n_clusters=[1, 2])
    assert seen["workers"] == 3 and seen["method"] == "spawn" and seen["fn"] is cli.runner
    assert [(t[0], t[1], t[-1]) for t in seen["tasks"]] == [
        (0, 1, "cuda:0"), (0, 2, "cuda:1"), (1, 1, "cuda:0"), (1, 2, "cuda:1")]

    batches = []
    monkeypatch.setattr(runner.MCMCSetup, "sample_ensemble",
                        lambda self, run_ids, resume=False, seed=0: batches.append(run_ids))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(fixture_dir / "config.yaml", custom_settings=settings, processes=1,
                 device="cpu")
    assert batches == [[0, 1]]


def test_headless_cli_without_config_errors_as_jax(monkeypatch, capsys):
    """No config argument and no display: both CLIs exit with argparse's
    code 2 and the same message."""
    from sbayes_tpu.cli import cli as jax_cli

    from sbayes_tpu_torch.cli import cli

    monkeypatch.delenv("DISPLAY", raising=False)
    errors = []
    for fn in (jax_cli, cli):
        with pytest.raises(SystemExit) as exc:
            fn([])
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[1])
    assert errors[0] == errors[1] and "A config file is required" in errors[0]
