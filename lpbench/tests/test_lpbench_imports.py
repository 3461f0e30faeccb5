"""Nothing under ``lpbench/`` imports JAX or the JAX package, and the
reference imports nothing of the port.  Top-level names are compared
whole: the port's name begins with the JAX package's."""
import ast
import os

import pytest

from lpbench import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "simplex_tpu"}


def _modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _files(sub=""):
    for d, _, names in os.walk(os.path.join(registry.ROOT, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


@pytest.mark.parametrize("path", sorted(_files()),
                         ids=lambda p: os.path.relpath(p, registry.ROOT))
def test_no_jax(path):
    tops = {m.split(".")[0] for m in _modules(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_files("reference")),
                         ids=lambda p: os.path.relpath(p, registry.ROOT))
def test_reference_imports_nothing_of_the_port(path):
    tops = {m.split(".")[0] for m in _modules(path)}
    assert "simplex_tpu_torch" not in tops
    assert not tops & FORBIDDEN


def test_the_scan_sees_a_whole_name():
    from lpbench.run import FORBIDDEN as RUN_FORBIDDEN

    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert "simplex_tpu_torch".split(".")[0] not in FORBIDDEN
