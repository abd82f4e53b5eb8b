"""Nothing under benchmark/ imports JAX, the JAX package or the repository's
TPU-era benchmark programs, and the plain reference imports nothing of the
port. Names are compared by their whole top-level part: ``zeggs_tpu_torch``
begins with ``zeggs_tpu`` and is allowed where the port is."""

import ast
from pathlib import Path

import pytest

from benchmark.common import FORBIDDEN, forbidden_modules

HERE = Path(__file__).resolve().parents[1]
BANNED_TOP = {"jax", "jaxlib", "flax", "zeggs_tpu", "__graft_entry__", "bench", "scripts"}
BANNED_PREFIX = ("zeggs_tpu_torch.bench", "zeggs_tpu_torch.profilers")


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_forbidden_imports(path):
    for name in imports_of(path):
        assert name.split(".")[0] not in BANNED_TOP, f"{path} imports {name}"
        assert not any(name == b or name.startswith(b + ".") for b in BANNED_PREFIX), name
        if "reference" in path.parts:
            assert name.split(".")[0] != "zeggs_tpu_torch", f"{path} imports {name}"


def test_whole_name_comparison():
    assert forbidden_modules({"zeggs_tpu_torch": 1, "zeggs_tpu_torch.infer": 1}) == []
    assert forbidden_modules({"zeggs_tpu.ops": 1, "jaxlib": 1}) == ["jaxlib", "zeggs_tpu"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "zeggs_tpu"}
