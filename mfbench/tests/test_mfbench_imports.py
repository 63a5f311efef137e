"""Nothing under ``mfbench/`` imports JAX or the JAX package, and the
reference imports nothing of the port: each import's top-level name is
compared whole (the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "morefusion_tpu", "bench",
          "chip_smoke"}
FILES = sorted(PACKAGE.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "mfbench"
            elif node.module:
                yield node.module.split(".")[0]


def test_the_check_sees_every_file():
    assert len(FILES) > 20
    assert "morefusion_tpu_torch" in set(
        top_level_imports(PACKAGE / "drivers" / "train_step.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(PACKAGE)))
def test_no_jax_and_no_port_in_the_reference(path):
    names = set(top_level_imports(path))
    assert not names & BANNED, (path, names & BANNED)
    if "reference" in path.relative_to(PACKAGE).parts:
        assert "morefusion_tpu_torch" not in names
        assert not any("morefusion_tpu" in line and "import" in line
                       for line in path.read_text().splitlines()), path
