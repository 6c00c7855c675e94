"""The reference's own entry point on the port, on the CPU: ``cli.run_experiment``
against the JAX package's on ``tests/fixtures/config.yaml`` (K = 1, then
``resume=True``): the same signature plus ``device``, the same file set and
stats headers, the likelihood file's ``na_values`` equal and its
``likelihood`` of the same shape; then the whole entry point as a user runs
it where PyYAML, h5py, pandas and JAX are not installed (a child process in
which importing them fails): ``python -m sbayes_tpu_torch config.yaml``
with the default ``results.log_likelihood: true``, ``-r True`` with more
steps (the earlier rows stay bit for bit), and ``python -m
sbayes_tpu_torch.tools.elpd``, whose ELPD equals the JAX tool's over the
same file within 1e-12 relative."""
import inspect
import os
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import h5py
import numpy as np
import pytest

import jax  # noqa: F401  (JAX stays on the CPU, see conftest)
import torch

ROOT = Path(__file__).parent.parent
FIXTURES = Path(__file__).parent / "fixtures"
REL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fixture_dir(tmp_path):
    for f in ("config.yaml", "features.csv", "feature_states.csv"):
        shutil.copy(FIXTURES / f, tmp_path / f)
    return tmp_path


def test_run_experiment_has_the_jax_signature_plus_device():
    from sbayes_tpu.cli import run_experiment as jax_run_experiment
    from sbayes_tpu_torch.cli import run_experiment

    want = list(inspect.signature(jax_run_experiment).parameters.values())
    got = list(inspect.signature(run_experiment).parameters.values())
    assert [(p.name, p.default) for p in got[:-1]] == [(p.name, p.default) for p in want]
    assert (got[-1].name, got[-1].default) == ("device", "cuda")


def _files(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _header(path: Path) -> str:
    return path.read_text().splitlines()[0]


def test_run_experiment_and_resume_equal_jax(fixture_dir):
    """Both packages' ``run_experiment`` at K = 1 (one warm-up chain of as
    many steps as a sample interval: one JAX program), then ``resume=True``
    with twice the steps: the same files, stats headers and row counts, the
    likelihood file's ``na_values`` equal and ``likelihood`` of the same
    shape, the port's first rows unchanged by the resume."""
    from sbayes_tpu.cli import run_experiment as jax_run_experiment
    from sbayes_tpu_torch.cli import run_experiment

    def settings(steps, samples, package):
        return {"mcmc": {"steps": steps, "samples": samples,
                         "warmup": {"warmup_steps": 20, "warmup_chains": 1}},
                "results": {"path": str(fixture_dir / package),
                            "log_operator_step_times": False}}

    lh_rows = {}
    for steps, samples, resume in ((40, 2, False), (80, 4, True)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jax_run_experiment(fixture_dir / "config.yaml", "exp",
                               settings(steps, samples, "jax"), resume=resume, i_run=0)
            run_experiment(fixture_dir / "config.yaml", "exp", settings(steps, samples, "port"),
                           resume=resume, i_run=0, device="cpu")
        jax_out, port_out = fixture_dir / "jax" / "exp", fixture_dir / "port" / "exp"
        assert _files(port_out) == _files(jax_out)
        assert "K1/likelihood_K1_0.h5" in _files(port_out)
        for name in ("stats", "clusters"):
            jax_lines = (jax_out / "K1" / f"{name}_K1_0.txt").read_text().splitlines()
            port_lines = (port_out / "K1" / f"{name}_K1_0.txt").read_text().splitlines()
            assert len(port_lines) == len(jax_lines) == samples + (name == "stats")
        assert _header(port_out / "K1" / "stats_K1_0.txt") == _header(
            jax_out / "K1" / "stats_K1_0.txt")
        with h5py.File(jax_out / "K1" / "likelihood_K1_0.h5", "r") as fj, \
                h5py.File(port_out / "K1" / "likelihood_K1_0.h5", "r") as fp:
            assert fp["likelihood"].shape == fj["likelihood"].shape == (samples, 10)
            assert fp["likelihood"].dtype == fj["likelihood"].dtype
            assert fp["na_values"].dtype == fj["na_values"].dtype == np.dtype(bool)
            np.testing.assert_array_equal(fp["na_values"][()], fj["na_values"][()])
            lh_rows[samples] = fp["likelihood"][()]
    np.testing.assert_array_equal(lh_rows[4][:2].view(np.uint32), lh_rows[2].view(np.uint32))


# Runs a module as ``python -m`` does, with PyYAML, h5py, pandas and JAX
# uninstalled in effect: importing them fails as for a missing package
# (not ``sys.modules[name] = None``, which libraries that look modules up in
# ``sys.modules``, as scipy does for ``jax``, take for an installed one).
BLOCKED_MAIN = r"""
import runpy, sys
BLOCKED = {"yaml", "h5py", "pandas", "jax", "jaxlib"}
class NotInstalled:
    @staticmethod
    def find_spec(name, path=None, target=None):
        if name.partition(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
sys.meta_path.insert(0, NotInstalled)
module = sys.argv.pop(1)
runpy.run_module(module, run_name="__main__", alter_sys=True)
assert not BLOCKED & set(sys.modules), BLOCKED & set(sys.modules)
"""


def _blocked(cwd: Path, *args) -> str:
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", BLOCKED_MAIN, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_the_entry_point_without_yaml_h5py_pandas_jax(fixture_dir):
    from sbayes_tpu.tools.elpd import sbayes_psis_loo as jax_psis_loo
    from sbayes_tpu_torch.data.loader import read_features_from_csv

    _blocked(fixture_dir, "sbayes_tpu_torch", "config.yaml", "-n", "x", "--device", "cpu")
    out = fixture_dir / "results" / "x" / "K1"
    path = out / "likelihood_K1_0.h5"
    _, features, _ = read_features_from_csv(fixture_dir / "features.csv",
                                            fixture_dir / "feature_states.csv",
                                            ["universal", "family"])
    with h5py.File(path, "r") as f:
        assert f["likelihood"].dtype == np.dtype("<f4") and f["likelihood"].shape == (20, 10)
        assert f["na_values"].dtype == np.dtype(bool)
        np.testing.assert_array_equal(f["na_values"][()], features.na_values.ravel())
        first = f["likelihood"][()]
    assert np.all(np.isfinite(first) & (first > 0))

    config = fixture_dir / "config.yaml"
    config.write_text(config.read_text().replace("steps: 400", "steps: 800")
                      .replace("samples: 20", "samples: 40"))
    _blocked(fixture_dir, "sbayes_tpu_torch", "config.yaml", "-n", "x", "-r", "True",
             "--device", "cpu")
    with h5py.File(path, "r") as f:
        resumed = f["likelihood"][()]
    assert resumed.shape == (40, 10)
    np.testing.assert_array_equal(resumed[:20].view(np.uint32), first.view(np.uint32))
    ids = [int(line.split("\t")[0]) for line in
           (out / "stats_K1_0.txt").read_text().splitlines()[1:]]
    assert ids == list(range(20, 801, 20))

    stdout = _blocked(fixture_dir, "sbayes_tpu_torch.tools.elpd", "results")
    line = [ln for ln in stdout.splitlines() if ln.startswith("ELPD-LOO for ('x', 1, 0)")]
    assert len(line) == 1, stdout
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_psis_loo(path, 0.1)
    # PSIS-LOO can give NaN on this little data (ROADMAP C.11): then both do
    np.testing.assert_allclose(float(line[0].rsplit(":", 1)[1]), want, rtol=REL)
