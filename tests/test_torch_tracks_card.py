"""Kernel K6 (``csrc/tracks.cu``: the multi-face track fold of a batch in
one launch) on the card, against its plain version
(``pipeline/tracks.py:track_timeline_plain``) on the CPU.

Every test is marked ``card`` and skips without a CUDA device.  The file
imports no JAX, which the port's machines need not have: its oracle is the
plain version, which ``test_torch_tracks.py`` holds to the JAX package on
the same inputs, test for test (the cell's shape, the S = 3 fold with an
(S,) tensor of n_valid, more than 32 tracks and detections).  Boxes, embeddings, the discrete state and the counters
are copies, selects and integer updates, so they are compared exactly;
``track_sim`` within 1e-6, since K6 sums its dot product and norms in
another order than ATen.
"""

import dataclasses

import numpy as np
import pytest
import torch

# by its own name (pytest puts tests/ on the path): a machine may have
# another package named ``tests`` installed, which hides this directory's
from track_scenarios import D, EXACT, KW, crowd, retire_then_spawn_steps, sequence
from truely_tpu_torch.pipeline import tracks
from truely_tpu_torch.pipeline.tracks import TrackFrameOut, TrackState

pytestmark = pytest.mark.card

OUTS = ("track_flagged", "track_box", "track_active", "track_updated")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K6 runs only on the card")
    return torch.device("cuda")


def on(device, *xs):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in xs]


def assert_fold_equal(got, want, prefix=""):
    """(state, outputs) of K6 against those of the plain version."""
    (gs, go), (ws, wo) = got, want
    for name in EXACT:
        a, b = getattr(gs, name).cpu(), getattr(ws, name).cpu()
        assert a.dtype == b.dtype and torch.equal(a, b), prefix + name
    if go is None:
        return
    for name in OUTS:
        a, b = getattr(go, name).cpu(), getattr(wo, name).cpu()
        assert a.dtype == b.dtype and torch.equal(a, b), prefix + name
    np.testing.assert_allclose(go.track_sim.cpu().numpy(), wo.track_sim.cpu().numpy(),
                               atol=1e-6, rtol=0, err_msg=prefix + "track_sim")


@pytest.mark.parametrize("scenario, seed", [("random", 0), ("random", 1), ("ties", 2),
                                            ("retire", 3)])
def test_k6_steps_match_plain(card, scenario, seed):
    """``test_track_step_matches_jax``'s sequences folded a frame a call."""
    boxes, valid, emb = sequence(seed, scenario=scenario)
    state = tracks.init_track_state(3, D, device=card)
    want = tracks.init_track_state(3, D)
    flagged = updated = 0
    for i in range(boxes.shape[0]):
        b, v, e = on(card, boxes[None, i:i + 1], valid[None, i:i + 1], emb[None, i:i + 1])
        state, out = tracks.track_timeline(state, b, v, e, 1, **KW)
        want, want_out = tracks.track_timeline_plain(want, *(x.cpu() for x in (b, v, e)), 1,
                                                     **KW)
        assert_fold_equal((state, out), (want, want_out), f"frame {i} ")
        flagged += int(out.track_flagged.sum())
        updated += int(out.track_updated.sum())
    assert flagged > 0 and updated > 10


@pytest.mark.parametrize("n_valid", [24, 17])
def test_k6_timeline_matches_plain(card, n_valid):
    """``test_track_timeline_matches_jax``'s batch, padding frames past
    n_valid inert."""
    boxes, valid, emb = sequence(5)
    args = (boxes[None], valid[None], emb[None])
    got = tracks.track_timeline(tracks.init_track_state(3, D, device=card), *on(card, *args),
                                n_valid, **KW)
    want = tracks.track_timeline_plain(tracks.init_track_state(3, D), *on("cpu", *args),
                                       n_valid, **KW)
    assert_fold_equal(got, want)


def test_k6_batched_fold_matches_plain(card):
    """``test_batched_fold_equals_solo_folds``: S = 3 streams over two
    batches with an (S,) device tensor of n_valid, equal to the plain
    batched fold and to each stream folded alone by K6."""
    seqs = [sequence(10 + s, scenario=sc) for s, sc in enumerate(("random", "ties", "retire"))]
    n_valid = [24, 9, 16]
    stacked = [np.stack([q[j] for q in seqs]) for j in range(3)]
    state = tracks.init_track_state(3, D, streams=3, device=card)
    want = tracks.init_track_state(3, D, streams=3)
    for half in (slice(0, 12), slice(12, 24)):
        nv = [max(0, min(n, half.stop) - half.start) for n in n_valid]
        b, v, e = (x[:, half] for x in stacked)
        got = tracks.track_timeline(state, *on(card, b, v, e), torch.tensor(nv, device=card),
                                    **KW)
        ref = tracks.track_timeline_plain(want, *on("cpu", b, v, e), torch.tensor(nv), **KW)
        assert_fold_equal(got, ref, f"{half} ")
        state, want = got[0], ref[0]
    for s, (boxes, valid, emb) in enumerate(seqs):
        solo, _ = tracks.track_timeline(tracks.init_track_state(3, D, device=card),
                                        *on(card, boxes[None], valid[None], emb[None]),
                                        n_valid[s], **KW)
        assert_fold_equal((tracks.stream_state(state, s), None),
                          (tracks.stream_state(solo, 0), None), f"stream {s} ")


def test_k6_retire_then_spawn(card):
    """``test_retire_then_spawn_resets_the_slot`` folded by K6 a frame a
    call: the face that comes back elsewhere takes slot 0 with its counts
    reset."""
    state = tracks.init_track_state(2, D, device=card)
    want = tracks.init_track_state(2, D)
    for i, (box, v, emb) in enumerate(retire_then_spawn_steps()):
        args = (box[None, None], v[None, None], emb[None, None])
        state, out = tracks.track_timeline(state, *on(card, *args), 1, **KW)
        want, want_out = tracks.track_timeline_plain(want, *on("cpu", *args), 1, **KW)
        assert_fold_equal((state, out), (want, want_out), f"frame {i} ")
        if i == 8:
            assert not bool(state.active[0, 0])
    assert bool(state.active[0, 0]) and int(state.processed[0, 0]) == 1


@pytest.mark.parametrize("emb_dtype", [torch.float32, torch.bfloat16])
def test_k6_cell_shape_matches_plain(card, emb_dtype):
    """The multi-face benchmark cell's fold: S = 1, F = 32, T = K = 4,
    512-d embeddings, in float32 and in bf16 (the wrapper hands K6
    ``emb.float()``, as the plain version computes on it)."""
    boxes, valid, emb = sequence(21, f=32, d=512)
    b, v, e = on(card, boxes[None], valid[None], emb[None])
    e = e.to(emb_dtype)
    got = tracks.track_timeline(tracks.init_track_state(4, 512, device=card), b, v, e, 29, **KW)
    want = tracks.track_timeline_plain(tracks.init_track_state(4, 512), b.cpu(), v.cpu(),
                                       e.cpu(), 29, **KW)
    assert_fold_equal(got, want)
    assert int(got[1].track_updated.sum()) > 20


def test_k6_leaves_the_input_state(card):
    """The fold returns new tensors; the state it was given is unchanged
    (``StreamScheduler.reset_stream`` and the callers rely on it)."""
    boxes, valid, emb = sequence(5)
    state, _ = tracks.track_timeline(tracks.init_track_state(3, D, device=card),
                                     *on(card, boxes[None, :12], valid[None, :12],
                                         emb[None, :12]), 12, **KW)
    before = TrackState(*(x.clone() for x in state))
    new, _ = tracks.track_timeline(state, *on(card, boxes[None, 12:], valid[None, 12:],
                                              emb[None, 12:]), 12, **KW)
    torch.cuda.synchronize()
    for name, a, b in zip(EXACT, state, before):
        assert torch.equal(a, b), name
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(new, state))
    assert not torch.equal(new.processed, state.processed)


@pytest.mark.parametrize("t, k, d", [(36, 48, 64), (40, 48, 64), (33, 33, D), (4, 4, 2049)])
def test_k6_any_shape_matches_plain(card, t, k, d):
    """K6 takes every shape: more tracks or detections than a warp has
    lanes (``test_crowd_timeline_matches_jax``'s crowds, where some
    detections find no free slot or returning faces spawn) and a large
    T * D, in one launch."""
    boxes, valid, emb = crowd(6, k=k, faces=min(40, k - 1), d=d)
    args = (boxes[None], valid[None], emb[None])
    launches = tracks.track_timeline.launches
    got = tracks.track_timeline(tracks.init_track_state(t, d, device=card), *on(card, *args), 21,
                                **KW)
    assert tracks.track_timeline.launches == launches + 1
    want = tracks.track_timeline_plain(tracks.init_track_state(t, d), *on("cpu", *args), 21,
                                       **KW)
    assert_fold_equal(got, want)
    assert int(got[1].track_updated.sum()) > 0


def test_k6_launch_counters(card):
    """One K6 launch a fold, with an int or an (S,) tensor of n_valid."""
    boxes, valid, emb = sequence(5)
    launches = tracks.track_timeline.launches
    for n, n_valid in enumerate((24, torch.tensor([17], device=card), 24), start=1):
        tracks.track_timeline(tracks.init_track_state(3, D, device=card),
                              *on(card, boxes[None], valid[None], emb[None]), n_valid, **KW)
        assert tracks.track_timeline.launches == launches + n


# ---------------------------------------------------------------------------
# End to end: the detector and the stream scheduler, K6 against the plain
# fold forced by moving the fold's tensors to the CPU.


def plain_fold(det, card):
    """``det.track_fold`` with its tensors moved to the CPU, so that it
    takes the plain version, and its results moved back to the card."""
    def fold(state, boxes, valid, emb, n_valid):
        if isinstance(n_valid, torch.Tensor):
            n_valid = n_valid.cpu()
        new, out = type(det).track_fold(det, TrackState(*(x.cpu() for x in state)),
                                        boxes.cpu(), valid.cpu(), emb.cpu(), n_valid)
        return (TrackState(*(x.to(card) for x in new)),
                TrackFrameOut(*(x.to(card) for x in out)))
    return fold


def multiface_detector(card):
    import chip_smoke
    from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
    from truely_tpu_torch.pipeline.detector import Detector

    cfg = DetectorConfig(multi_face=True, max_tracks=4, detect_interval=4,
                         similarity_threshold=0.9999, run_length_threshold=3,
                         mtcnn=MTCNNConfig(thresholds=chip_smoke.PROP_THRESHOLDS))
    return chip_smoke.steady_regression(Detector(cfg, device=card))


def test_analyze_i420_tracks_k6_equals_plain_fold(card):
    """``analyze_i420_tracks`` at K=4 on 70 frames (three folds): the same
    aggregate, per-track scores and final state with K6 as with the plain
    fold, and every fold went through K6."""
    import chip_smoke

    det = multiface_detector(card)
    packed = chip_smoke.stable_i420(70, 240, 320, seed=33)
    launches = tracks.track_timeline.launches
    got = det.analyze_i420_tracks(packed, fps=chip_smoke.FPS)
    assert tracks.track_timeline.launches == launches + 3
    det.track_fold = plain_fold(det, card)
    want = det.analyze_i420_tracks(packed, fps=chip_smoke.FPS)
    assert tracks.track_timeline.launches == launches + 3
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert_fold_equal((got[2], None), (want[2], None))
    assert int(got[2].processed.sum()) > 0


def test_stream_scheduler_multiface_k6_equals_plain_fold(card):
    """A multi-face ``StreamScheduler`` at K=4 (3 streams of 4 frames a
    step, I420): the same events, per-track scores and states with K6 as
    with the plain fold."""
    import chip_smoke
    from truely_tpu_torch.pipeline.streaming import StreamScheduler

    det = multiface_detector(card)
    content = [chip_smoke.stable_i420(24 - i % 3, 240, 320, seed=41 + i, n_base=1)
               for i in range(3)]
    runs = []
    for fold in (None, plain_fold(det, card)):
        if fold is not None:
            det.track_fold = fold
        launches = tracks.track_timeline.launches
        sched = StreamScheduler(det, 3, frames_per_stream=4, fps=chip_smoke.FPS, yuv=True)
        events, _ = chip_smoke.feed_streams(sched, content)
        runs.append((events, [sched.track_scores_for(i) for i in range(3)], sched._states,
                     tracks.track_timeline.launches - launches, sched.steps_run))
    (got, got_scores, got_state, k6, steps), (want, want_scores, want_state, plain, _) = runs
    assert k6 == steps and plain == 0 and steps > 0
    assert len(got) == len(want) == sum(len(c) for c in content)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.track_sim, b.track_sim, atol=1e-6, rtol=0)
        assert dataclasses.replace(a, track_sim=()) == dataclasses.replace(b, track_sim=())
    for a, b in zip(got_scores, want_scores):
        np.testing.assert_array_equal(a, b)
    assert_fold_equal((got_state, None), (want_state, None))
    assert any(any(e.track_updated) for e in got)
