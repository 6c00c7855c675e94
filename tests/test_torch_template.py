"""The port's config template (``sbayes_tpu_torch/config/template.py``, a walk
of the dataclass schema) against the JAX package's (a walk of the pydantic
models): the same text line for line apart from the header line that names
the package; the schemas carry the same field docstrings, and a field
without a default is required in both."""
import ast
import copy
import json
import shutil
from pathlib import Path

import pytest
import yaml

import jax  # noqa: F401  (JAX stays on the CPU, see conftest)

ROOT = Path(__file__).parent.parent
FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture
def base_dirs():
    """Both schemas' default results path resolves against ``BASE_DIR``,
    which a config load sets: the template is compared from the same one."""
    from sbayes_tpu.config.schema import RelativePath as JaxRelativePath
    from sbayes_tpu_torch.config.schema import RelativePath

    saved = JaxRelativePath.BASE_DIR, RelativePath.BASE_DIR
    JaxRelativePath.BASE_DIR = RelativePath.BASE_DIR = "."
    yield
    JaxRelativePath.BASE_DIR, RelativePath.BASE_DIR = saved


def test_template_equals_jax(base_dirs, tmp_path):
    from sbayes_tpu.config.template import generate_template as jax_template
    from sbayes_tpu_torch.config.template import generate_template, main

    got, want = generate_template().splitlines(), jax_template().splitlines()
    assert got[0] == "# Auto-generated configuration template for sbayes_tpu_torch."
    assert want[0] == "# Auto-generated configuration template for sbayes_tpu."
    assert got[1:] == want[1:]
    assert [line.split(":")[0] for line in got if not line.startswith((" ", "#"))] == [
        "data", "model", "mcmc", "results"]
    assert "  features: <REQUIRED>" in got and "      type: <REQUIRED>" in got
    main(["--output", str(tmp_path / "template.yaml")])
    assert (tmp_path / "template.yaml").read_text() == generate_template()


def _field_docs(path: Path) -> dict:
    """{(class, field): docstring} of the fields followed by one."""
    docs = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ClassDef):
            for stmt, nxt in zip(node.body, node.body[1:]):
                if (isinstance(stmt, ast.AnnAssign) and isinstance(nxt, ast.Expr)
                        and isinstance(nxt.value, ast.Constant)
                        and isinstance(nxt.value.value, str)):
                    docs[node.name, stmt.target.id] = nxt.value.value
    return docs


def test_schema_field_docstrings_equal_jax():
    got = _field_docs(ROOT / "sbayes_tpu_torch" / "config" / "schema.py")
    want = _field_docs(ROOT / "sbayes_tpu" / "config" / "schema.py")
    assert len(want) == 54
    assert got == want


@pytest.mark.parametrize("path", [
    ("data", "features"),
    ("model", "prior", "objects_per_cluster", "type"),
    ("model", "prior", "geo"),
    ("mcmc",),
], ids=lambda p: ".".join(p))
def test_a_missing_required_field_raises_like_jax(tmp_path, path):
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu_torch.config.schema import SBayesConfig

    for f in ("features.csv", "feature_states.csv"):
        shutil.copy(FIXTURES / f, tmp_path / f)
    cfg = copy.deepcopy(yaml.safe_load((FIXTURES / "config.yaml").read_text()))
    section = cfg
    for key in path[:-1]:
        section = section[key]
    del section[path[-1]]
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(Exception, match=path[-1]):
        JaxConfig.from_config_file(tmp_path / "config.json")
    with pytest.raises(ValueError, match=rf"missing required fields \['{path[-1]}'\]"):
        SBayesConfig.from_config_file(tmp_path / "config.json")
