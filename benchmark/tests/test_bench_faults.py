"""Runs of the tiny cells with the timed path broken underneath come out
not correct: for each cell, an answer altered where it is produced and
half of the batch left out; on a mesh, the exchange between the cards
(the gather of the shards' outputs) left out.  Sound runs of the
same cells come out correct.  The runs skip the look for a card (the
CPU stands in for it) and drive everything else of a run."""

import copy
import os
import time

import pytest
import torch

from benchmark import check, closed_loop, spec
from benchmark.tests.conftest import tiny

CPU = torch.device("cpu")


def cell_of(name):
    """A cell of ``BENCHMARK.json``; ``mesh``: the first cell's
    configuration on a data mesh of 4 cards, which the harness runs from
    a configuration's ``dp`` though no cell asks for it yet (PERF.md)."""
    if name != "mesh":
        return spec.load(name)
    cell = spec.load("single_1080p_i420")
    conf = copy.deepcopy(cell.config)
    conf["dp"] = 4
    return cell._replace(name=name, chips=4, config=conf)


def run_closed(name, seconds=1.0):
    cell = tiny(cell_of(name))
    out = closed_loop.run(cell, 2**32 + 3, seconds, False, time.perf_counter(),
                          os.devnull, device=CPU)
    return check.judge(out.numbers, out.limits), out


def half_left_out(step):
    """``step`` with the second half of every batch's found faces dropped."""

    def broken(nets, packed, cfg, dtype, *a, **kw):
        out = step(nets, packed, cfg, dtype, *a, **kw)
        half = packed.shape[0] // 2
        if hasattr(out, "has_face"):
            has_face = out.has_face.clone()
            has_face[half:] = False
            return out._replace(has_face=has_face)
        boxes, valid, emb = out
        valid = valid.clone()
        valid[half:] = False
        return boxes, valid, emb

    return broken


@pytest.mark.parametrize("name", ["single_1080p_i420", "multiface_1080p_k4", "mesh"])
def test_sound_runs_are_correct(name):
    ok, out = run_closed(name)
    assert ok, out.numbers
    assert out.checked >= 1 and out.attempted >= out.checked


def test_single_altered_score(monkeypatch):
    from truely_tpu_torch.pipeline import detector

    real = detector.weighted_score
    monkeypatch.setattr(detector, "weighted_score", lambda *a, **kw: (real(*a, **kw) + 1) % 101)
    ok, out = run_closed("single_1080p_i420")
    assert not ok and out.numbers["score_gap"] >= 1


def test_single_half_the_batch_left_out(monkeypatch):
    from truely_tpu_torch.pipeline import detector

    monkeypatch.setattr(detector, "frame_step_yuv", half_left_out(detector.frame_step_yuv))
    ok, out = run_closed("single_1080p_i420")
    assert not ok and out.numbers["record_mismatch"] > 0


def test_multiface_altered_track_scores(monkeypatch):
    from truely_tpu_torch.pipeline import detector

    real = detector.track_scores
    monkeypatch.setattr(detector, "track_scores", lambda *a, **kw: real(*a, **kw) + 1)
    ok, out = run_closed("multiface_1080p_k4")
    assert not ok and out.numbers["score_gap"] >= 1


def test_multiface_half_the_batch_left_out(monkeypatch):
    from truely_tpu_torch.pipeline import detector

    monkeypatch.setattr(detector, "multiface_step_propagate_yuv",
                        half_left_out(detector.multiface_step_propagate_yuv))
    ok, out = run_closed("multiface_1080p_k4")
    assert not ok


def test_mesh_exchange_left_out(monkeypatch):
    from truely_tpu_torch.parallel import sharding

    real = sharding.DataSpec.gather

    def first_shard_only(self, parts):
        first = parts[0]
        if isinstance(first, torch.Tensor):
            return real(self, [first] + [torch.zeros_like(p) for p in parts[1:]])
        return real(self, parts)

    monkeypatch.setattr(sharding.DataSpec, "gather", first_shard_only)
    ok, out = run_closed("mesh")
    assert not ok and out.numbers["record_mismatch"] > 0
