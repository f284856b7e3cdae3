"""Nothing under portbench/ imports JAX or the JAX package, by the
top-level name of each import; the reference imports nothing of the
program either."""
import ast
import os

import pytest

from conftest import ROOT

PORTBENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "binder_tpu",
                       "__graft_entry__"})


def imported(source: str):
    """The top-level name of every module ``source`` imports."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def forbidden(path: str, source: str):
    banned = set(FORBIDDEN)
    if os.sep + "reference" + os.sep in path:
        banned.add("binder_torch")
    return sorted(set(imported(source)) & banned)


def modules():
    out = []
    for dirpath, _, files in os.walk(PORTBENCH):
        if "_build" in dirpath or "__pycache__" in dirpath:
            continue
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, ROOT) for p in out)


@pytest.mark.parametrize("path", modules())
def test_imports_nothing_of_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        assert forbidden(os.path.join(ROOT, path), f.read()) == []


@pytest.mark.parametrize("source, bad", [
    ("import jax.numpy as jnp", ["jax"]),
    ("from jaxlib import xla_client", ["jaxlib"]),
    ("import binder_tpu.server", ["binder_tpu"]),
    ("from __graft_entry__ import entry", ["__graft_entry__"]),
    ("import binder_torch.dns", []),
    ("import jaxtyping", []),
])
def test_the_check_compares_whole_top_level_names(source, bad):
    assert forbidden(os.path.join(PORTBENCH, "harness", "x.py"),
                     source) == bad


def test_the_reference_may_not_import_the_program():
    path = os.path.join(PORTBENCH, "reference", "x.py")
    assert forbidden(path, "from binder_torch.dns import wire") == [
        "binder_torch"]
    assert forbidden(path, "import binder_torchx") == []
