"""Rules of the port, checked on its source: no module of
``sbayes_tpu_torch`` and not ``chip_smoke.py`` imports JAX or the JAX package
(the card's machine has neither), nor PyYAML, nor h5py outside the ELPD
tool's fallback; and every entry point defaults to the CUDA device and
raises without a card instead of falling back to the CPU."""
import ast
import inspect
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).parent.parent
PORT_FILES = sorted((ROOT / "sbayes_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_jax_import():
    """Every import statement of every file (module level or inside a
    function)."""
    assert len(PORT_FILES) > 30
    banned = {str(p.relative_to(ROOT)): m for p in PORT_FILES for m in _imported_modules(p)
              if m.split(".")[0] in ("jax", "jaxlib", "sbayes_tpu")}
    assert not banned, banned


def _import_sites(path: Path, package: str) -> list:
    """The functions (None: module level) whose body imports ``package``."""
    sites = []

    def visit(node, function):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            names = ([a.name for a in child.names] if isinstance(child, ast.Import) else
                     [child.module] if isinstance(child, ast.ImportFrom) and child.module else [])
            if any(n.split(".")[0] == package for n in names):
                sites.append(function)
            visit(child, function)

    visit(ast.parse(path.read_text()), None)
    return sites


def test_no_yaml_and_h5py_only_in_the_elpd_fallback():
    """The card's machine has neither PyYAML nor h5py: no file of the port
    imports ``yaml`` (YAML goes through ``config/yaml_reader.py``), and
    ``h5py`` is imported at one place only, ``tools/elpd.py``'s reader of a
    file in a layout only h5py reads (the likelihood files go through
    ``results/hdf5.py``)."""
    sites = {package: {str(p.relative_to(ROOT)): _import_sites(p, package)
                       for p in PORT_FILES if _import_sites(p, package)}
             for package in ("yaml", "h5py")}
    assert sites == {"yaml": {},
                     "h5py": {"sbayes_tpu_torch/tools/elpd.py": ["_read_with_h5py"]}}


def test_the_workflow_modules_are_scanned():
    """The simulation, every tool and the config template are among the
    files both scans above read, and each has its JAX counterpart."""
    workflow = ["simulation.py", "config/template.py"] + [
        f"tools/{p.name}" for p in sorted((ROOT / "sbayes_tpu" / "tools").glob("*.py"))]
    assert len(workflow) == 16          # 13 tools and the package's __init__.py
    for rel in workflow:
        assert ROOT / "sbayes_tpu_torch" / rel in PORT_FILES, rel


def test_the_parallel_layer_is_scanned():
    """The chain split over devices (``parallel/``: the mesh and the worker
    processes of the process split, which import whatever a worker runs),
    the kernels' checks a worker runs (``ops/check.py``) and the CLI's run
    pool are among the files both scans read."""
    parallel = sorted((ROOT / "sbayes_tpu_torch" / "parallel").glob("*.py"))
    assert [p.name for p in parallel] == ["__init__.py", "mesh.py", "processes.py"]
    for p in parallel + [ROOT / "sbayes_tpu_torch" / "ops" / "check.py",
                         ROOT / "sbayes_tpu_torch" / "cli.py"]:
        assert p in PORT_FILES, p


def test_the_package_imports_without_jax():
    """Every module of the port imports with ``jax`` unimportable, and no
    module of the JAX package gets loaded."""
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in PORT_FILES if p.parent.name != "__pycache__" and p.stem != "__main__"
               and p.name != "chip_smoke.py"]
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib'):\n"
            "    sys.modules[name] = None\n"
            f"for name in {modules!r}:\n"
            "    __import__(name)\n"
            "loaded = [m for m in sys.modules if m == 'sbayes_tpu' or m.startswith('sbayes_tpu.')]\n"
            "assert not loaded, loaded\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]


def test_entry_points_default_to_cuda():
    """``cli.main`` and its ``--device`` option, ``Model``, ``MCMCSetup`` and
    ``build_model_constants`` default to ``cuda``; without a card the
    default raises (``resolve_device``)."""
    from sbayes_tpu_torch import cli
    from sbayes_tpu_torch.model.constants import build_model_constants, resolve_device
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import MCMCSetup

    for fn in (cli.main, Model.__init__, MCMCSetup.__init__, build_model_constants):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert "default=\"cuda\"" in inspect.getsource(cli)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(synthetic_data(n_objects=10, n_features=3), synthetic_config(n_clusters=1).model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
