"""The import rule: nothing under qbench/ imports JAX or the JAX package
(top-level names compared whole), and the reference imports nothing of
the program."""

from __future__ import annotations

import ast
import os

import pytest

from conftest import REPO

QBENCH = os.path.join(REPO, "qbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "salmon_tpu"}


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(QBENCH, sub)):
        if ".cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_names(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("sub, banned", [
    ("", FORBIDDEN),
    ("reference", FORBIDDEN | {"salmon_tpu_torch"}),
])
def test_imports(sub, banned):
    seen = 0
    for path in _sources(sub):
        seen += 1
        bad = set(_top_names(path)) & banned
        assert not bad, f"{path} imports {bad}"
    assert seen
