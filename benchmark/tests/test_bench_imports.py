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


# Drives ``run.main`` on the CPU (the look for a card answered yes, the run
# on the CPU at the tiny size): the plain cell, then the cell whose reader
# imports ``jax``; the exit code of each after its lines.
MAIN = '''
import sys
import torch
from benchmark import closed_loop, run, spec
from benchmark.tests.conftest import tiny

load, loop, available = spec.load, closed_loop.run, torch.cuda.is_available


def on_cpu(*a, **kw):
    torch.cuda.is_available = available
    return loop(*a, device=torch.device("cpu"), **kw)


spec.load = lambda name: tiny(load(name))
closed_loop.run = on_cpu
torch.cuda.get_device_name = lambda *a: "cpu"
for name in sys.argv[1:]:
    torch.cuda.is_available, torch.cuda.device_count = (lambda: True), (lambda: 1)
    rc = run.main(["--workload", name, "--seed", str(2**32 + 5), "--seconds", "0.5",
                   "--trace", "0"])
    print("rc", name, rc, flush=True)
'''


def test_a_module_a_reader_loads_stops_the_result(tmp_path):
    """A JAX module loaded after the window, here by a metric's reader, is
    found before the result is printed: the run exits 3 with no result
    line, and names the module on standard error."""
    import json
    import shutil
    import subprocess
    import sys

    root = os.path.dirname(BENCH)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark" / "metrics" / "loads_jax.py").write_text(
        "def read(cell, out):\n    import jax  # noqa: F401\n    return 1.0\n")
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        registry = json.load(f)
    plain = {w["name"]: w for w in registry["workloads"]}["single_1080p_i420"]
    registry["workloads"].append(dict(plain, name="jax_reader"))
    registry["end_to_end"].append({"name": "loads_jax", "unit": "count", "better": "lower",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": ["jax_reader"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(registry))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(tmp_path / "stub"),
                                                       root]),
               PYTHONDONTWRITEBYTECODE="1", OMP_NUM_THREADS="2", TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", MAIN, "single_1080p_i420", "jax_reader"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "rc jax_reader 3" and lines[-2] == "rc single_1080p_i420 0", lines
    assert json.loads(lines[-3])["correct"] is True
    assert "loaded in the result's process: jax" in proc.stderr
