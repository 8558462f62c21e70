"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program either. Compared by the whole
top-level name of each module: ``deepfake_vit_tpu_torch`` begins with
``deepfake_vit_tpu`` and is another package."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "deepfake_vit_tpu"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_files_found():
    assert len(FILES) > 20
    assert any(p.parent.name == "reference" for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name == "reference"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (BANNED | {"deepfake_vit_tpu_torch", "benchmark"})


def test_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import deepfake_vit_tpu_torch.e2e\nfrom jax.numpy import ones\n")
    assert top_level_imports(f) == {"deepfake_vit_tpu_torch", "jax"}
    assert top_level_imports(f) & BANNED == {"jax"}
