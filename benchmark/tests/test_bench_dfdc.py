"""The ``dfdc_b7`` model (the DFDC winner's classifier on the multi-face
detector) and its cell ``dfdc_b7_1080p_k4``, added as new files:

- the cell runs from a copy of ``benchmark/`` at a tiny size on the CPU
  (120x160 frames, 64x64 crops, two members, the classifier in float32:
  at 64x64 a random B7's logits have tails on which bf16 moves them by
  more than the limit that the card's 380x380 readings set) and comes out
  correct; with
  one member's logits altered in the timed path, or the program's crop
  margin changed, it comes out not correct, by the classifier's numbers
  while the tracks still agree;
- each new reader returns None on an empty run;
- the seeded members' logits spread by about 1 on fresh crops;
- no benchmark file that the FaceNet cells use changed: their digests are
  pinned here.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.outcome import Outcome

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELL = "dfdc_b7_1080p_k4"
METRICS = ["classifier_device_ms.batch", "classifier_mfu", "crop380_roofline",
           "classifier_idle.batch", "dfdc_step_mfu"]

SCRIPT = '''
import json, os, time
import torch
from benchmark import check, closed_loop, spec
from benchmark.tests.conftest import tiny

cell = tiny(spec.load("dfdc_b7_1080p_k4"))
cell.traffic["lengths"].update(low=24, high=24, strata=1)
cell.config["classifier"].update(input_size=64, ensemble=2, compute_dtype="float32")
model = spec.model(cell.config)
entry, detector = model.entry, model.detector


def member_shifted(program, config):
    run = entry(program, config)

    def analyze(packed, fps):
        result = run(packed, fps)
        logits = result[3].logits.copy()
        logits[1] += 0.5
        return tuple(result[:3]) + (result[3]._replace(logits=logits),)

    return analyze


def margin_changed(config, trees, device, mesh):
    changed = dict(config, classifier=dict(config["classifier"], margin=4))
    return detector(changed, trees, device, mesh)


for fault in ("none", "member", "margin"):
    model.entry = member_shifted if fault == "member" else entry
    model.detector = margin_changed if fault == "margin" else detector
    out = closed_loop.run(cell, 2**32 + 17, 0.5, False, time.perf_counter(), os.devnull,
                          device=torch.device("cpu"))
    crops = sum(int(u.result[3].mask.sum()) for u in out.units)
    print(json.dumps({"fault": fault, "correct": check.judge(out.numbers, out.limits),
                      "numbers": out.numbers, "checked": out.checked, "crops": crops,
                      "files": [model.__file__]}))
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    top = tmp_path_factory.mktemp("copy")
    shutil.copytree(BENCH, top / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), top / "BENCHMARK.json")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(top), ROOT]),
               PYTHONDONTWRITEBYTECODE="1", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=top, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            r = json.loads(line)
            got[r["fault"]] = r
    return top, got


def test_cell_runs_from_the_copy_and_is_correct(runs):
    top, got = runs
    sound = got["none"]
    assert sound["files"][0].startswith(str(top))
    assert sound["correct"] and sound["checked"] >= 1 and sound["crops"] > 0, sound
    assert set(sound["numbers"]) == {"score_gap", "track_mismatch", "embedding_gap",
                                     "logit_gap", "video_prob_gap"}


@pytest.mark.parametrize("fault", ["member", "margin"])
def test_a_fault_in_the_classifier_is_not_correct(runs, fault):
    limits = spec.load(CELL).config["limits"]
    bad = runs[1][fault]
    assert not bad["correct"] and bad["numbers"]["logit_gap"] > limits["logit_gap"], bad
    assert bad["numbers"]["track_mismatch"] == 0.0


@pytest.mark.parametrize("name", METRICS)
def test_new_reader_reads_nothing_from_an_empty_run(name):
    out = Outcome(setup_s=1.0, window_s=10.0, units=[], traced_units=0, host_from=0.0,
                  launches={}, spans={}, trace_summary=None, numbers={}, limits={},
                  attempted=0, failed=0, memory_peak_bytes=0, cards=1, checked=0)
    assert spec.metric_reader(name)(spec.load(CELL), out) is None


def test_cell_reports_its_metrics():
    cell = spec.load(CELL)
    assert [m["name"] for m in cell.end_to_end] == ["sampled_fps", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == METRICS
    assert cell.config["detector"] == spec.load("multiface_1080p_k4").config["detector"]


def test_seeded_members_spread_by_about_one():
    import torch

    from benchmark.reference.dfdc import net_from_tree

    model = spec.model({"model": "dfdc_b7"})
    config = spec.load(CELL).config
    config = dict(config, classifier=dict(config["classifier"], input_size=64))
    net = net_from_tree(model.member_tree(2**31 + 3, 0, torch.device("cpu"), config))
    crops = model.calibration_crops(torch.Generator().manual_seed(5), 12, 64, "cpu")
    with torch.inference_mode():
        logits = net(crops)
    assert 0.3 <= float(logits.std()) <= 3.0 and float(logits.abs().max()) < 8.0


def test_no_earlier_benchmark_file_changed():
    """``dfdc_before.json``: the sha256 of every benchmark file that existed
    before the DFDC model was added."""
    with open(os.path.join(os.path.dirname(__file__), "dfdc_before.json")) as f:
        before = json.load(f)
    for rel, digest in before.items():
        with open(os.path.join(BENCH, rel), "rb") as fh:
            assert hashlib.sha256(fh.read()).hexdigest() == digest, rel


def test_classifier_readers_read_a_traced_run():
    """On a traced run whose table holds ``classifier.net`` and K7: the
    share of the peak from the answers' valid crops, and K7's roofline."""
    from types import SimpleNamespace

    import numpy as np

    from benchmark.closed_loop import Unit
    from benchmark.counts import BF16_FLOPS_PER_S, HBM_BYTES_PER_S
    from benchmark.counts.dfdc import crop_flops, k7_bytes
    from benchmark.program_spans import Range, Table
    from benchmark.trace import TraceSummary

    cell = spec.load(CELL)
    mask = np.zeros((70, 4), bool)
    mask[:, :3] = True
    boxes = np.tile(np.float32([800, 400, 1000, 600]), (70, 4, 1))
    result = (0, None, None, SimpleNamespace(mask=mask, boxes=boxes))
    unit = Unit(0, 70, 0.0, 3.0, 0, {}, result)
    table = Table(window_s=3.0, idle_s=0.1,
                  ranges={"classifier.net": Range(2.0, 100, 0.0, 3)})
    summary = TraceSummary(window_s=3.0, busy_s=2.9, cards=1,
                           device_ops=[("crop_classifier_kernel", 0.004, 3)], idle_gaps=[],
                           ranges=table)
    out = Outcome(setup_s=1.0, window_s=10.0, units=[unit], traced_units=1, host_from=3.0,
                  launches={}, spans={}, trace_summary=summary, numbers={}, limits={},
                  attempted=1, failed=0, memory_peak_bytes=0, cards=1, checked=0)
    mfu = spec.metric_reader("classifier_mfu")(cell, out)
    assert mfu == pytest.approx(100 * 210 * crop_flops(380) * 7 / 2.0 / BF16_FLOPS_PER_S)
    roof = spec.metric_reader("crop380_roofline")(cell, out)
    nbytes = sum(k7_bytes(result, 70, 32, cell.config["classifier"], 1080, 1920))
    assert roof == pytest.approx(100 * nbytes / HBM_BYTES_PER_S / 0.004)
    # three launches of 32, 32 and 6 rows; every valid crop's 332 x 332 rectangle
    assert nbytes == 70 * 4 * 380 * 380 * 3 * 2 + 3 * 210 * 332 * 332
    assert spec.metric_reader("classifier_device_ms.batch")(cell, out) == pytest.approx(
        1e3 * 2.0 / 70)
