"""Auto-generate a commented YAML config template from the schema.

Counterpart of the reference's template generator
(sbayes/config/generate_template.py) and copy of
``sbayes_tpu/config/template.py`` for the PyTorch port: walks the port's
dataclass schema (``fields()``, a field's ``required`` metadata for a field
without a default), harvests the per-field docstrings from the schema
source via ``ast`` introspection and emits a commented
``config_template.yaml`` with defaults.
"""
from __future__ import annotations

import ast
import inspect
from dataclasses import MISSING, fields
from enum import Enum
from pathlib import Path
from typing import Union, get_args, get_origin, get_type_hints

from sbayes_tpu_torch.config import schema
from sbayes_tpu_torch.config.schema import BaseConfig, SBayesConfig

REQUIRED = "<REQUIRED>"


def harvest_attr_docs() -> dict:
    """{class_name: {field: docstring}} from the schema source."""
    src = inspect.getsource(schema)
    tree = ast.parse(src)
    docs: dict = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        class_docs: dict = {}
        body = node.body
        for i, stmt in enumerate(body):
            if isinstance(stmt, (ast.AnnAssign, ast.Assign)) and i + 1 < len(body):
                nxt = body[i + 1]
                if (
                    isinstance(nxt, ast.Expr)
                    and isinstance(nxt.value, ast.Constant)
                    and isinstance(nxt.value.value, str)
                ):
                    if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
                        class_docs[stmt.target.id] = " ".join(nxt.value.value.split())
        docs[node.name] = class_docs
    return docs


def _default_repr(value):
    if value is REQUIRED:
        return REQUIRED
    if value is None:
        return "null"
    if isinstance(value, Enum):
        return value.value
    if isinstance(value, bool):
        return str(value).lower()
    if isinstance(value, Path):
        return str(value)
    return value


def _is_config_model(tp) -> bool:
    return isinstance(tp, type) and issubclass(tp, BaseConfig)


def _default(field):
    """A field's default: ``REQUIRED`` for a field without one, else its
    value or what its factory makes."""
    if field.metadata.get("required"):
        return REQUIRED
    if field.default_factory is not MISSING:
        return field.default_factory()
    return field.default


def generate_template_lines(model: type, docs: dict, indent: int = 0) -> list:
    lines = []
    pad = "  " * indent
    class_doc_chain = [c.__name__ for c in model.__mro__ if _is_config_model(c)]
    hints = get_type_hints(model, vars(schema))
    for field in fields(model):
        name = field.name
        doc = None
        for cls_name in class_doc_chain:
            doc = docs.get(cls_name, {}).get(name)
            if doc:
                break

        annotation = hints[name]
        origin = get_origin(annotation)
        if origin is Union:
            args = [a for a in get_args(annotation) if a is not type(None)]
            annotation = args[0] if args else annotation

        if doc:
            lines.append(f"{pad}# {doc}")
        if _is_config_model(annotation):
            lines.append(f"{pad}{name}:")
            lines.extend(generate_template_lines(annotation, docs, indent + 1))
        elif origin is dict or annotation is dict:
            lines.append(f"{pad}{name}: {{}}")
        else:
            lines.append(f"{pad}{name}: {_default_repr(_default(field))}")
    return lines


def generate_template() -> str:
    docs = harvest_attr_docs()
    header = (
        "# Auto-generated configuration template for sbayes_tpu_torch.\n"
        "# Fields marked <REQUIRED> must be provided; all others show their defaults.\n"
    )
    return header + "\n".join(generate_template_lines(SBayesConfig, docs)) + "\n"


def main(args=None):
    import argparse

    parser = argparse.ArgumentParser(description="Generate a commented YAML config template.")
    parser.add_argument("--output", type=Path, default=Path("config_template.yaml"))
    ns = parser.parse_args(args)
    ns.output.write_text(generate_template())
    print(f"Template written to {ns.output}")


if __name__ == "__main__":
    main()
