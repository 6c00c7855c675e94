"""The port's YAML reader (``sbayes_tpu_torch/config/yaml_reader.py``, no
PyYAML) against ``yaml.safe_load``: every YAML file in the repository, the
port's config template, a corpus of scalars (the YAML 1.1 traps among them)
and of block and flow collections, all equal (exactly, NaN equal to NaN,
types included); every construct outside the subset raises a ``ValueError``
that names its line; and the fixture config read with PyYAML unimportable
equals the JAX package's."""
import math
import sys
import warnings
from enum import Enum
from pathlib import Path

import pytest
import yaml

import jax  # noqa: F401  (JAX stays on the CPU, see conftest)

ROOT = Path(__file__).parent.parent
FIXTURES = Path(__file__).parent / "fixtures"


def _same(a, b) -> bool:
    """Equal values of equal types, keys in the same order, NaN equal to NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict):
        return _same(list(a), list(b)) and _same(list(a.values()), list(b.values()))
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _plain(v):
    """Config values in comparable form: enums by value, paths as str."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, Enum):
        return v.value
    if isinstance(v, Path):
        return str(v)
    return v


def _check(text: str):
    from sbayes_tpu_torch.config.yaml_reader import loads

    want, got = yaml.safe_load(text), loads(text)
    assert _same(got, want), (text, got, want)


def _repo_yaml_files() -> list:
    """The YAML files at the top of the repository and in its source, test
    and benchmark directories (not in results or hidden directories)."""
    found = list(ROOT.glob("*.yaml")) + list(ROOT.glob("*.yml"))
    for d in ("sbayes_tpu", "sbayes_tpu_torch", "tests", "benchmarks"):
        found += [p for p in (ROOT / d).rglob("*") if p.suffix in (".yaml", ".yml")
                  and not any(part.startswith(".") or part == "results"
                              for part in p.relative_to(ROOT).parts)]
    return sorted(found)


def test_every_yaml_file_of_the_repository():
    files = _repo_yaml_files()
    assert ROOT / "config_template.yaml" in files and FIXTURES / "config.yaml" in files
    for path in files:
        _check(path.read_text(encoding="utf-8"))


def test_the_port_template():
    from sbayes_tpu_torch.config.template import generate_template

    _check(generate_template())


# plain scalars: each resolves as safe_load resolves it (YAML 1.1)
SCALARS = [
    # null
    "null", "Null", "NULL", "~", "", "nULL", "nul",
    # bools in their three cases; y / n and mixed case stay strings
    "true", "True", "TRUE", "false", "False", "FALSE", "yes", "Yes", "YES", "no", "No", "NO",
    "on", "On", "ON", "off", "Off", "OFF", "y", "n", "Y", "tRUE", "oN",
    # ints: hex, octal by a leading 0, binary, underscores, base 60, signs
    "0", "-0", "+0", "7", "-17", "+17", "0x1F", "0x_1F", "-0x1f", "017", "-017", "0o17", "08",
    "0b101", "0b", "1_000", "1__0", "0_", "1:30", "-1:30", "190:20:30", "0:30", "1:60",
    # floats need a dot or are .inf / .nan; the exponent needs its sign
    "1e6", "1.0e6", "1.0e+6", "1.0E+6", "1.0e-3", "1e-3", "50000.0", "1.", "1.e+5", ".5",
    "-.5", "+0.5e-3", "09.5", "1_0.5_0", "1:30.5", ".inf", ".Inf", ".INF", "-.inf", "+.inf",
    ".nan", ".NaN", ".NAN", "-.nan", ".", "1.2.3", "0.",
    # strings
    "epsg:4326", "<ALL>", "<REQUIRED>", "<DEFAULT>", "uniform_area", "a b  c", "x#y",
    "http://x.org/a?b=c", ":x", "?x", "-x", "a,b", "a]", "12:30:45x", "é😀", "1_", "_1",
]


@pytest.mark.parametrize("scalar", SCALARS)
def test_plain_scalar_as_value_and_key(scalar):
    _check(f"key: {scalar}\n")
    _check(f"- {scalar}\n")
    if scalar and scalar != "~" and not scalar.startswith("?"):
        _check(f"{scalar}: value\n")


QUOTED = ["'x'", "'it''s'", "' a  b '", "''", '""', '"#x"', "'#x'", '"a\\tb\\u00e9\\x41\\\\"',
          '"\\"q\\""', '"1"', "'1.0e+6'", "'true'", '"null"', "'<ALL>'", '"\\U0001F600"',
          '"\\/\\0\\a\\b\\e\\f\\n\\r\\v\\N\\_\\L\\P\\ "']


@pytest.mark.parametrize("scalar", QUOTED)
def test_quoted_scalar(scalar):
    """As a value (then with a comment, with and without a space before it)
    and as a key."""
    for text in (f"key: {scalar}", f"key: {scalar} # c", f"key: {scalar}#c",
                 f"{scalar}: v", f"- {scalar}"):
        _check(text)


COLLECTIONS = {
    "flow_seq": "a: [1, 3]",
    "flow_empty": "a: []\nb: {}\nc: [ ]\nd: { }",
    "flow_map": "a: {b: 1, c: x, 'd': [1, 2], e: }",
    "flow_nested": "a: [1, [2, 3], {b: [c, d]}, []]",
    "flow_trailing_comma": "a: [a, b,]\nb: {a: 1,}",
    "flow_json": 'a: {"x":1, "y": [true, null, 1.5]}',
    "flow_plain_colon": "a: [a:b, http://x]\nb: {url: http://x, c: d:e}",
    "flow_key_only": "a: {x, y: 1}",
    "flow_comment": "a: [1, 2] # c\nb: {x: 1}# c",
    "flow_top": "[1, {a: b}]",
    "block": "a:\n  b: 1\n  c:\n    d: x\n  e: 2\nf: 3",
    "block_seq_indented": "a:\n    - x\n    - y\nb: 1",
    "block_seq_at_key_indent": "a:\n- 1\n- 2\nb: 3",
    "seq_of_maps": "- a: 1\n  b: 2\n- c: 3\n  d:\n    - e\n-\n  f: 4",
    "seq_of_seqs": "- - a\n  - b\n- c\n- - - d",
    "seq_empty_entries": "-\n- a\n-\n- -\n- -\n  - b",
    "map_in_seq_deep": "a:\n  - x: 1\n    y: [1, 2]\n    z:\n      w: 3\n  - z",
    "empty_values": "a:\nb: ~\nc:   # comment\nd: ''",
    "comments": "# head\n\na: 1 # c\n  # indented comment\n\n#\nb:   2   \n# tail",
    "key_spaces": "a b: 1\n'c d' : 2\n\"e\": 3\na : 4",
    "duplicate_keys": "a: 1\nb: 2\na: 3",
    "typed_keys": "1: a\n1.5: b\nyes: c\n~: d\n0x10: e",
    "indented_top": "  a: 1\n  b:\n    - 2",
    "crlf": "a: 1\r\nb:\r\n  - x\r\n",
    "bom": "\ufeffa: 1",
    "top_scalar": "x",
    "top_empty": "",
    "top_comments": "# c\n\n",
    "sbayes_prior": ("prior:\n  confounding_effects:\n    universal:\n      \"<ALL>\":\n"
                     "        type: dirichlet\n        file: prior.yaml\n    family:\n"
                     "      \"<DEFAULT>\":\n        type: jeffreys\n"
                     "  objects_per_cluster: {type: uniform_size, min: 3, max: 50}"),
}


@pytest.mark.parametrize("text", COLLECTIONS.values(), ids=COLLECTIONS.keys())
def test_collections(text):
    _check(text)


# constructs outside the subset: (text, the line named, words of the message)
REFUSED = {
    "anchor": ("a: 1\nb: &x 2", 2, "anchor"),
    "alias": ("a: &x 1\nb: *x", 1, "anchor"),
    "alias_only": ("a: 1\nb: *x", 2, "alias"),
    "tag": ("a: !!str 1", 1, "tag"),
    "local_tag": ("a:\n  b: !x y", 2, "tag"),
    "literal_block": ("a: |\n  x\n  y", 1, "block scalar"),
    "folded_block": ("a: >-\n  x", 1, "block scalar"),
    "document_start": ("a: 1\n---\nb: 2", 2, "document marker"),
    "leading_document_start": ("---\na: 1", 1, "document marker"),
    "document_end": ("a: 1\n...", 2, "document marker"),
    "directive": ("%YAML 1.1\na: 1", 1, "directive"),
    "complex_key": ("? a\n: b", 1, "complex key"),
    "complex_key_in_seq": ("- ? x", 1, "complex key"),
    "tab_indent": ("a:\n\tb: 1", 2, "tab"),
    "tab_separator": ("a:\tb", 1, "tab"),
    "tab_after_value": ("a: 1\t", 1, "tab"),
    "multiline_plain": ("a:\n  b\n  c", 3, "several lines"),
    "multiline_plain_inline": ("a: b\n  c", 2, "several lines"),
    "multiline_single": ("a: 'b\n  c'", 1, "several lines"),
    "multiline_double": ('a: "b\n  c"', 1, "several lines"),
    "multiline_flow": ("a: [1,\n  2]", 1, "several lines"),
    "merge_key": ("a: {x: 1}\nb:\n  <<: x", 3, "merge key"),
    "value_key": ("a: =", 1, "value key"),
    "timestamp": ("a: 2001-12-14", 1, "timestamp"),
    "single_pair_in_flow_seq": ("a: [b: 1]", 1, "single-pair mapping"),
    "reserved_at": ("a: @x", 1, "reserved"),
    "reserved_backtick": ("a: `x`", 1, "reserved"),
    "two_values": ("a: b: c", 1, "mapping value"),
    "entry_after_key": ("a: - 1", 1, "sequence entry"),
    "bad_indent": ("a:\n    b: 1\n  c: 2", 3, "indentation"),
    "seq_then_key_deeper": ("a:\n  - x\n  b: 1", 3, "indentation"),
    "content_after_seq": ("- a\nb: 1", 2, "content after"),
    "quoted_then_more": ("a: 'x' y", 1, "followed by"),
    "flow_then_more": ("a: [1] x", 1, "followed by"),
    "flow_comma_start": ("a: ,x", 1, "starting with ','"),
    "flow_empty_entry": ("a: [a, , b]", 1, "starting with ','"),
    "flow_comment_inside": ("a: [x # c]", 1, "in a flow collection"),
    "unknown_escape": ('a: "\\q"', 1, "escape"),
    "line_separator": ("a: 1\nb: x\u2028y", 2, "character"),
    "control_character": ("a: \x01", 1, "character"),
    "empty_key": ("a: 1\n: x", 2, "empty key"),
}


@pytest.mark.parametrize("case", REFUSED.values(), ids=REFUSED.keys())
def test_refused_constructs_name_their_line(case):
    from sbayes_tpu_torch.config.yaml_reader import loads

    text, line, words = case
    with pytest.raises(ValueError, match=rf"^YAML line {line}: .*{words}"):
        loads(text)


def test_fixture_config_without_pyyaml_equals_jax(monkeypatch):
    """``SBayesConfig.from_config_file`` on the fixture YAML, with ``yaml``
    unimportable, equals the JAX package's config read with PyYAML."""
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu_torch.config.schema import SBayesConfig

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JaxConfig.from_config_file(FIXTURES / "config.yaml")
        monkeypatch.setitem(sys.modules, "yaml", None)
        got = SBayesConfig.from_config_file(FIXTURES / "config.yaml")
    assert _plain(got.model_dump()) == _plain(want.model_dump())


def test_prior_file_in_yaml_without_pyyaml(tmp_path, monkeypatch):
    """A Dirichlet prior file in YAML (``_load_concentration_dict``) reads
    the same counts with PyYAML unimportable as ``yaml.safe_load`` gives."""
    from sbayes_tpu_torch.model.constants import _load_concentration_dict

    path = tmp_path / "prior.yaml"
    path.write_text("F1:\n  A: 8.0\n  B: 2\n  C: 1.0e+0\nF2: {X: 2.0, Y: 3}\n")
    want = yaml.safe_load(path.read_text())
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert _same(_load_concentration_dict(path), want)
