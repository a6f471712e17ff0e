"""No module of the benchmark imports JAX, the JAX package or the smoke
script, and the reference imports nothing of the port: each import's
top-level name (before the first dot) is compared whole, since the
port's name begins with the JAX package's."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "truely_tpu", "chip_smoke"}


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def modules(root):
    return sorted(os.path.join(d, f) for d, _, files in os.walk(root)
                  for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", modules(BENCH), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", modules(os.path.join(BENCH, "reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    assert "truely_tpu_torch" not in top_level_imports(path)
    assert "benchmark" not in top_level_imports(path)  # its own modules, relatively


def test_scan_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import truely_tpu_torch.ops\nfrom truely_tpu.ops import yuv\nimport jaxtyping\n")
    assert top_level_imports(str(p)) & FORBIDDEN == {"truely_tpu"}
