"""The PyTorch port stands alone: importing it and every module in it
loads neither JAX/flax nor anything of the JAX package, and no import
statement in its sources names them."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = "news_recommendation_mind_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "news_recommendation_mind_tpu")


def _modules():
    return sorted(
        ".".join((PKG,) + p.relative_to(ROOT / PKG).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / PKG).rglob("*.py"))


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _loaded_after(imports):
    code = ("import importlib, json, sys\n"
            f"for m in {imports!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ), capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_import_loads_no_jax_and_no_jax_package():
    modules = _modules()
    assert {f"{PKG}.{m}" for m in (
        "serving", "ops.short_mhsa", "ops.fused_adam", "ops.dropout_bits",
        "models.two_tower", "train.state", "train.step", "train.loop",
    )} <= set(modules)
    # a site hook may preload modules: compare with a bare interpreter
    baseline = _loaded_after([])
    loaded = _loaded_after(modules)
    assert set(modules) <= loaded
    extra = sorted(m for m in loaded - baseline if _forbidden(m))
    assert extra == []


def test_sources_import_no_jax_and_no_jax_package():
    offenders = []
    for path in sorted((ROOT / PKG).rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert offenders == []
