"""The model seam: a configuration names its model (``models/<model>.py``),
and the harness reaches the model's program, weights, reference, check and
counts only through that module.

- A toy model, a configuration and a cell added as new files to a copy of
  the benchmark, with no file of the copy edited, run a tiny CPU cell
  through ``closed_loop.run``: sound, it comes out correct; with the toy
  net's output altered in the timed path, not correct.
- The FaceNet model's counts at 1080p are the numbers the harness gave
  before the seam (pinned), and each cell reports the metrics it did,
  with the program's span readings added.
- No harness module outside ``models/`` names a net or a check kind.
"""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.outcome import Outcome

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TOY_MODEL = '''"""A toy model: the FaceNet detector's multi-face tracks, then one seeded
dense layer over each track's held embedding, one logit a track."""

import numpy as np
import torch

from benchmark import spec

facenet = spec.model({"model": "facenet"})
SHIFT = 0.0  # added to the program's logits (a planted fault when not 0)


def seeded_trees(seed, device, config):
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    head = torch.randn(config["head_width"], generator=gen, device=device)
    return {"nets": facenet.seeded_trees(seed, device, config), "head": head}


def detector(config, trees, device, mesh):
    det = facenet.detector(config, trees["nets"], device, mesh)
    det.head = trees["head"]
    return det


def entry(program, config):
    tracks = facenet.entry(program, config)

    def analyze(packed, fps):
        score, per_track, state = tracks(packed, fps)
        return score, per_track, state, state.embedding.float() @ program.head + SHIFT

    return analyze


def reference(config, trees, device, fps, rows):
    tracks = facenet.reference(config, trees["nets"], device, fps, rows)
    head = trees["head"].cpu().double()

    def run(frames):
        r = tracks(frames)
        return r, (torch.from_numpy(r.state["embedding"]).double() @ head).numpy()

    return run


def answer(result):
    score, per_track, state, logits = result
    return facenet.answer((score, per_track, state)), logits.cpu().double().numpy()


def check(config, got, want):
    out = facenet.check(config, [g for g, _ in got], [w for w, _ in want])
    gap = 0.0
    for (g, g_logits), (w, w_logits) in zip(got, want):
        both = g.state["has_prev"] & w.state["has_prev"]
        if both.any():
            gap = max(gap, float(np.abs(g_logits[both] - w_logits[both]).max()))
    out["head_gap"] = gap
    return out


row_flops = facenet.row_flops
step_forms = facenet.step_forms
'''

# Runs the toy cell twice in the copy: sound, then with the toy net's
# output altered; one JSON line each.
SCRIPT = '''
import json, os, time
import torch
from benchmark import check, closed_loop, spec
from benchmark.tests.conftest import tiny

cell = tiny(spec.load("toy_1080p_k4"))
cell.traffic["lengths"].update(low=24, high=24, strata=1)
model = spec.model(cell.config)
for shift in (0.0, 1.0):
    model.SHIFT = shift
    out = closed_loop.run(cell, 2**32 + 11, 0.5, False, time.perf_counter(), os.devnull,
                          device=torch.device("cpu"))
    print(json.dumps({"shift": shift, "correct": check.judge(out.numbers, out.limits),
                      "numbers": out.numbers, "checked": out.checked,
                      "files": [model.__file__, closed_loop.__file__]}))
'''


def digests(root):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A copy of the benchmark with the toy model, its configuration and its
    cell added as new files and entries; the copy's digests before the
    additions and after the runs, its BENCHMARK.json, and the runs."""
    top = tmp_path_factory.mktemp("copy")
    bench = top / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(bench)
    (bench / "models" / "toy_tracks.py").write_text(TOY_MODEL)
    with open(bench / "configs" / "facenet_multiface_k4.json") as f:
        conf = json.load(f)
    conf.update(name="toy_tracks_k4", model="toy_tracks", head_width=512)
    conf["limits"]["head_gap"] = 1e-3
    (bench / "configs" / "toy_tracks_k4.json").write_text(json.dumps(conf, indent=2))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        registry = json.load(f)
    registry["configs"].append({
        "name": "toy_tracks_k4", "source": "https://github.com/timesler/facenet-pytorch",
        "file": "benchmark/configs/toy_tracks_k4.json", "reduced": [],
        "why": "the multi-face detector and one dense layer over each held embedding"})
    registry["workloads"].append({
        "name": "toy_1080p_k4", "config": "toy_tracks_k4", "traffic": "i420_1080p_stable",
        "chips": 1, "why": "the toy model's tracks and logits"})
    (top / "BENCHMARK.json").write_text(json.dumps(registry, indent=2))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(top), ROOT]),
               PYTHONDONTWRITEBYTECODE="1", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=top, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    after = digests(bench)
    return {"top": top, "before": before, "after": after, "registry": registry, "runs": runs}


def test_toy_files_are_new_and_no_file_is_edited(toy):
    before, after = toy["before"], toy["after"]
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {os.path.join("models", "toy_tracks.py"),
                                        os.path.join("configs", "toy_tracks_k4.json")}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        original = json.load(f)
    for key, entries in original.items():  # the copy's registry only gained entries
        got = toy["registry"][key]
        assert got[:len(entries)] == entries if isinstance(entries, list) else got == entries


def test_toy_cell_runs_from_the_copy_and_is_correct(toy):
    sound = toy["runs"][0]
    assert all(f.startswith(str(toy["top"])) for f in sound["files"])
    assert sound["correct"] and sound["checked"] >= 1, sound
    assert set(sound["numbers"]) == {"score_gap", "track_mismatch", "embedding_gap",
                                     "head_gap"}


def test_toy_net_altered_is_not_correct(toy):
    altered = toy["runs"][1]
    assert not altered["correct"] and altered["numbers"]["head_gap"] >= 1.0, altered
    # the tracks themselves still agree: only the toy net's check caught it
    assert altered["numbers"]["track_mismatch"] == 0.0


def test_a_configuration_without_a_model_does_not_load(tmp_path):
    with open(os.path.join(BENCH, "configs", "facenet_single.json")) as f:
        conf = json.load(f)
    del conf["model"]
    path = tmp_path / "no_model.json"
    path.write_text(json.dumps(conf))
    with pytest.raises(KeyError):
        spec.make("x", 1, path, "i420_1080p_pool", [], [])


# The FaceNet model's counts at 1080p, as the harness gave them before the
# model seam (``counts.nets.row_flops``; ``counts.kernels.step_forms`` at 32
# rows, I420): (kernel, bytes, operations) of each launch.
ROW_FLOPS = {
    "single_1080p_i420": {"full": 6920369647, "detect": 6288575279, "propagate": 747320128},
    "multiface_1080p_k4": {"full": 8155084335, "detect": 6288575279, "propagate": 2328612096},
}
K1 = ("i420_to_bgr", 298598400, 796262400)
CASCADE = [("nms_masked_batch", 212992, 0.0), ("nms_masked_batch", 180224, 0.0),
           ("crop_resize_area", 14188544, 3538944), ("nms_masked_batch", 45056, 0.0),
           ("crop_resize_area", 28327936, 7077888), ("nms_masked_batch", 22528, 0.0)]
FACE_CROP = {"single_1080p_i420": ("crop_resize_bilinear", 2458112, 5529600),
             "multiface_1080p_k4": ("crop_resize_bilinear", 9832448, 22118400)}
REFINE = {"single_1080p_i420": [("crop_resize_area", 886784, 221184),
                                ("nms_masked_batch", 2816, 0.0),
                                ("crop_resize_area", 3540992, 884736),
                                ("nms_masked_batch", 2816, 0.0)],
          "multiface_1080p_k4": [("crop_resize_area", 3547136, 884736),
                                 ("nms_masked_batch", 11264, 0.0),
                                 ("crop_resize_area", 14163968, 3538944),
                                 ("nms_masked_batch", 11264, 0.0)]}


def step_forms_before(cell, kind):
    if kind == "detect":
        return [K1] + CASCADE
    if kind == "full":
        return [K1] + CASCADE + [FACE_CROP[cell]]
    return [K1] + REFINE[cell] + [FACE_CROP[cell]]


CELLS = ["single_1080p_i420", "multiface_1080p_k4"]


@pytest.mark.parametrize("name", CELLS)
def test_row_flops_as_before(name):
    cell = spec.load(name)
    det = cell.config["detector"]
    assert spec.model(cell.config).row_flops(det, 1080, 1920) == ROW_FLOPS[name]


@pytest.mark.parametrize("kind", ["full", "detect", "propagate"])
@pytest.mark.parametrize("name", CELLS)
def test_step_forms_as_before(name, kind):
    cell = spec.load(name)
    forms = spec.model(cell.config).step_forms(cell.config["detector"], kind, 32, 1080, 1920)
    assert [tuple(f) for f in forms] == step_forms_before(name, kind)


BEFORE = ["device_idle.batch", "step_mfu", "kernels_roofline", "upload_ms.batch"]
SPANS = ["stage_host_ms.batch", "stage_idle.batch", "pyramid_device_ms.batch",
         "cascade_device_ms.batch", "embed_device_ms.batch"]
METRICS = {
    "single_1080p_i420": BEFORE + SPANS,
    "multiface_1080p_k4": BEFORE + ["fold_host_ms", "fallback_share"] + SPANS
    + ["sync_host_ms.batch", "fold_launches", "fold_idle.batch"],
}


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_its_metrics(name):
    cell = spec.load(name)
    assert [m["name"] for m in cell.end_to_end] == ["sampled_fps", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == METRICS[name]


@pytest.mark.parametrize("name", METRICS["multiface_1080p_k4"])
def test_per_layer_reader_reads_nothing_from_an_empty_run(name):
    """A reader that finds nothing to read returns None, and the metric is
    left out of the line."""
    out = Outcome(setup_s=1.0, window_s=10.0, units=[], traced_units=0, host_from=0.0,
                  launches={}, spans={}, trace_summary=None, numbers={}, limits={},
                  attempted=0, failed=0, memory_peak_bytes=0, cards=1, checked=0)
    assert spec.metric_reader(name)(spec.load("multiface_1080p_k4"), out) is None


NETS = re.compile(r"pnet|rnet|onet|facenet|landmark|inception", re.IGNORECASE)
KINDS = re.compile(r"""["'](records|tracks)["']""")
EXEMPT = ("models", "reference", "counts", "tests", "check.py", "weights.py")


def harness_modules():
    return sorted(os.path.relpath(os.path.join(d, f), BENCH)
                  for d, _, files in os.walk(BENCH) for f in files if f.endswith(".py")
                  and os.path.relpath(os.path.join(d, f), BENCH).split(os.sep)[0] not in EXEMPT)


@pytest.mark.parametrize("path", harness_modules())
def test_harness_names_no_net_and_no_check_kind(path):
    with open(os.path.join(BENCH, path)) as f:
        text = f.read()
    assert not NETS.search(text) and not KINDS.search(text)
