"""The port's multi-face tracker (``truely_tpu_torch/pipeline/tracks.py``)
against ``truely_tpu.pipeline.tracks`` on seeded numpy detections.

Boxes and embeddings are moved, never computed, so they are compared
exactly; the similarities within 1e-5; every decision (active, misses,
counters, flags, processed, scores) is equal.  The port folds a leading
stream axis: a solo JAX fold is the port's S = 1, and S streams folded
together equal S solo folds.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from truely_tpu.ops.boxes import iou_matrix as j_iou_matrix
from truely_tpu.pipeline import tracks as jtracks
from truely_tpu_torch.ops.boxes import iou_matrix
from truely_tpu_torch.pipeline import tracks
from tests.track_scenarios import D, EXACT, KW, crowd, retire_then_spawn_steps, sequence

torch.set_num_threads(2)

def jax_fold_steps(boxes, valid, emb, t=3):
    state = jtracks.init_track_state(t, D)
    outs = []
    for i in range(boxes.shape[0]):
        state, out = jtracks.track_step(state, jnp.asarray(boxes[i]), jnp.asarray(valid[i]),
                                        jnp.asarray(emb[i]), **KW)
        outs.append(out)
    return state, outs


def assert_state_equal(got, ref, prefix=""):
    """got: the port's state of one stream ((T, ...) tensors); ref: JAX."""
    for name in EXACT:
        a, b = getattr(got, name).cpu().numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(a, b, err_msg=prefix + name)


@pytest.mark.parametrize("scenario, seed", [("random", 0), ("random", 1), ("ties", 2),
                                            ("retire", 3)])
def test_track_step_matches_jax(scenario, seed):
    boxes, valid, emb = sequence(seed, scenario=scenario)
    ref_state, ref_outs = jax_fold_steps(boxes, valid, emb)
    state = tracks.init_track_state(3, D)
    flagged = updated = 0
    for i in range(boxes.shape[0]):
        state, out = tracks.track_step(state, torch.from_numpy(boxes[i])[None],
                                       torch.from_numpy(valid[i])[None],
                                       torch.from_numpy(emb[i])[None], **KW)
        ref = ref_outs[i]
        for name in ("track_flagged", "track_box", "track_active", "track_updated"):
            np.testing.assert_array_equal(getattr(out, name)[0].numpy(),
                                          np.asarray(getattr(ref, name)), err_msg=f"{i} {name}")
        np.testing.assert_allclose(out.track_sim[0].numpy(), np.asarray(ref.track_sim),
                                   atol=1e-5)
        flagged += int(out.track_flagged.sum())
        updated += int(out.track_updated.sum())
    assert_state_equal(tracks.stream_state(state, 0), ref_state)
    assert flagged > 0 and updated > 10                # the sequences exercise the counters
    if scenario == "retire":
        # face 2's track retired and a new face spawned into a vacated slot
        assert int(np.asarray(ref_state.processed).min()) < boxes.shape[0] - 12


def test_retire_then_spawn_resets_the_slot():
    """One face for 6 frames, gone for 3 (> max_misses 2: retired), then a
    face elsewhere: it takes slot 0 with its counts reset."""
    state = tracks.init_track_state(2, D)
    jstate = jtracks.init_track_state(2, D)
    for i, (box, v, emb) in enumerate(retire_then_spawn_steps()):
        state, _ = tracks.track_step(state, torch.from_numpy(box)[None],
                                     torch.from_numpy(v)[None], torch.from_numpy(emb)[None], **KW)
        jstate, _ = jtracks.track_step(jstate, jnp.asarray(box), jnp.asarray(v),
                                       jnp.asarray(emb), **KW)
        if i == 5:
            assert int(state.processed[0, 0]) == 5
        if i == 8:
            assert not bool(state.active[0, 0])
    assert_state_equal(tracks.stream_state(state, 0), jstate)
    assert bool(state.active[0, 0]) and int(state.processed[0, 0]) == 1
    np.testing.assert_array_equal(state.box[0, 0].numpy(), np.float32([310, 310, 350, 350]))


@pytest.mark.parametrize("n_valid", [24, 17])
def test_track_timeline_matches_jax(n_valid):
    """The fold over a batch, with inert padding frames past n_valid."""
    boxes, valid, emb = sequence(5)
    ref_state, ref_outs = jtracks.track_timeline(
        jtracks.init_track_state(3, D), jnp.asarray(boxes), jnp.asarray(valid),
        jnp.asarray(emb), jnp.int32(n_valid), **KW)
    state, outs = tracks.track_timeline(
        tracks.init_track_state(3, D), torch.from_numpy(boxes)[None],
        torch.from_numpy(valid)[None], torch.from_numpy(emb)[None], n_valid, **KW)
    assert_state_equal(tracks.stream_state(state, 0), ref_state)
    for name in ("track_flagged", "track_box", "track_active", "track_updated"):
        np.testing.assert_array_equal(getattr(outs, name)[0].numpy(),
                                      np.asarray(getattr(ref_outs, name)), err_msg=name)
    np.testing.assert_allclose(outs.track_sim[0].numpy(), np.asarray(ref_outs.track_sim),
                               atol=1e-5)
    if n_valid < 24:  # padding frames are inert: the state is the fold of the first n_valid
        short, _ = tracks.track_timeline(
            tracks.init_track_state(3, D), torch.from_numpy(boxes[:n_valid])[None],
            torch.from_numpy(valid[:n_valid])[None], torch.from_numpy(emb[:n_valid])[None],
            n_valid, **KW)
        for a, b in zip(short, state):
            assert torch.equal(a, b)


def test_batched_fold_equals_solo_folds():
    """S = 3 streams of different content and lengths folded together, over
    two batches, equal each stream folded alone."""
    seqs = [sequence(10 + s, scenario=sc) for s, sc in enumerate(("random", "ties", "retire"))]
    n_valid = [24, 9, 16]
    stacked = [torch.from_numpy(np.stack([q[j] for q in seqs])) for j in range(3)]
    state = tracks.init_track_state(3, D, streams=3)
    for half in (slice(0, 12), slice(12, 24)):
        nv = torch.tensor([max(0, min(n, half.stop) - half.start) for n in n_valid])
        state, _ = tracks.track_timeline(state, stacked[0][:, half], stacked[1][:, half],
                                         stacked[2][:, half], nv, **KW)
    for s, (boxes, valid, emb) in enumerate(seqs):
        solo, _ = tracks.track_timeline(
            tracks.init_track_state(3, D), torch.from_numpy(boxes)[None],
            torch.from_numpy(valid)[None], torch.from_numpy(emb)[None], n_valid[s], **KW)
        for name, a, b in zip(EXACT, tracks.stream_state(state, s), tracks.stream_state(solo, 0)):
            assert torch.equal(a, b), (s, name)


def assert_fold_matches_jax(state, outs, ref_state, ref_outs, prefix=""):
    """A solo fold of the port's (S = 1 tensors) against JAX's."""
    assert_state_equal(tracks.stream_state(state, 0), ref_state, prefix)
    for name in ("track_flagged", "track_box", "track_active", "track_updated"):
        np.testing.assert_array_equal(getattr(outs, name)[0].numpy(),
                                      np.asarray(getattr(ref_outs, name)), err_msg=prefix + name)
    np.testing.assert_allclose(outs.track_sim[0].numpy(), np.asarray(ref_outs.track_sim),
                               atol=1e-5, err_msg=prefix + "track_sim")


@pytest.mark.parametrize("emb_dtype", [torch.float32, torch.bfloat16])
def test_cell_shape_timeline_matches_jax(emb_dtype):
    """The multi-face benchmark cell's fold (S = 1, F = 32, T = K = 4,
    512-d embeddings, 29 valid frames) on the inputs of the card's
    ``test_k6_cell_shape_matches_plain``: bf16 embeddings are folded as
    their float32 values, in both packages."""
    boxes, valid, emb = sequence(21, f=32, d=512)
    emb = torch.from_numpy(emb).to(emb_dtype)
    ref_state, ref_outs = jtracks.track_timeline(
        jtracks.init_track_state(4, 512), jnp.asarray(boxes), jnp.asarray(valid),
        jnp.asarray(emb.float().numpy()), jnp.int32(29), **KW)
    state, outs = tracks.track_timeline(
        tracks.init_track_state(4, 512), torch.from_numpy(boxes)[None],
        torch.from_numpy(valid)[None], emb[None], 29, **KW)
    assert_fold_matches_jax(state, outs, ref_state, ref_outs)
    assert int(outs.track_updated.sum()) > 20


def test_batched_fold_matches_jax():
    """``test_batched_fold_equals_solo_folds``' S = 3 fold, over two
    batches with an (S,) tensor of n_valid (the card's
    ``test_k6_batched_fold_matches_plain``), against a JAX fold of each
    stream over the same two batches."""
    seqs = [sequence(10 + s, scenario=sc) for s, sc in enumerate(("random", "ties", "retire"))]
    n_valid = [24, 9, 16]
    stacked = [torch.from_numpy(np.stack([q[j] for q in seqs])) for j in range(3)]
    state = tracks.init_track_state(3, D, streams=3)
    ref = [jtracks.init_track_state(3, D) for _ in seqs]
    for half in (slice(0, 12), slice(12, 24)):
        nv = [max(0, min(n, half.stop) - half.start) for n in n_valid]
        state, outs = tracks.track_timeline(state, *(x[:, half] for x in stacked),
                                            torch.tensor(nv), **KW)
        for s, (boxes, valid, emb) in enumerate(seqs):
            ref[s], ref_outs = jtracks.track_timeline(
                ref[s], jnp.asarray(boxes[half]), jnp.asarray(valid[half]),
                jnp.asarray(emb[half]), jnp.int32(nv[s]), **KW)
            assert_fold_matches_jax(tracks.TrackState(*(x[s:s + 1] for x in state)),
                                    tracks.TrackFrameOut(*(x[s:s + 1] for x in outs)),
                                    ref[s], ref_outs, f"{half} stream {s} ")


@pytest.mark.parametrize("t, k, d", [(36, 48, 64), (40, 48, 64)])
def test_crowd_timeline_matches_jax(t, k, d):
    """More than 32 tracks and detections (the card's
    ``test_k6_any_shape_matches_plain``): with 36 slots for 40 faces some
    detections find no free slot; with 40 the returning faces spawn."""
    boxes, valid, emb = crowd(6, k=k, d=d)
    ref_state, ref_outs = jtracks.track_timeline(
        jtracks.init_track_state(t, d), jnp.asarray(boxes), jnp.asarray(valid),
        jnp.asarray(emb), jnp.int32(21), **KW)
    state, outs = tracks.track_timeline(
        tracks.init_track_state(t, d), torch.from_numpy(boxes)[None],
        torch.from_numpy(valid)[None], torch.from_numpy(emb)[None], 21, **KW)
    assert_fold_matches_jax(state, outs, ref_state, ref_outs)
    assert int(outs.track_flagged.sum()) > 0 and int(state.active.sum()) > 30


@pytest.mark.parametrize("t, k, d, device", [
    (3, 4, D, "cpu"),
    (33, 4, D, "meta"),      # more tracks than a warp has lanes
    (3, 33, D, "meta"),      # more detections
    (4, 4, 2049, "meta"),    # a large T * D
])
def test_track_timeline_takes_the_plain_version(t, k, d, device):
    """CPU tensors take the plain version at every shape, uncounted; off
    the CPU no shape does: every fold goes to K6, which takes only CUDA
    tensors (on the meta device it raises, launching nothing)."""
    launches = tracks.track_timeline.launches
    boxes, valid, emb = (torch.from_numpy(x)[None] for x in sequence(5, k=max(k, 4), d=d))
    boxes, valid, emb = boxes[:, :, :k], valid[:, :, :k], emb[:, :, :k]
    want_state, want = tracks.track_timeline_plain(tracks.init_track_state(t, d), boxes, valid,
                                                   emb, 17, **KW)
    got_state, got = tracks.track_timeline(tracks.init_track_state(t, d), boxes, valid, emb, 17,
                                           **KW)
    for a, b in zip((*got_state, *got), (*want_state, *want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if device != "cpu":
        with pytest.raises(ValueError, match="CUDA"):
            tracks.track_timeline(tracks.init_track_state(t, d, device=device),
                                  *(x.to(device) for x in (boxes, valid, emb)), 17, **KW)
    assert tracks.track_timeline.launches == launches


def test_track_timeline_k6_refuses_tensors_off_cuda():
    """A fold off the CPU goes to K6, which takes only CUDA tensors: on
    another device, with an int or an (S,) tensor of n_valid, it raises,
    launching nothing."""
    launches = tracks.track_timeline.launches
    boxes, valid, emb = (torch.from_numpy(x)[None].to("meta") for x in sequence(5))
    for n_valid in (17, torch.tensor([17], device="meta")):
        with pytest.raises(ValueError, match="CUDA"):
            tracks.track_timeline(tracks.init_track_state(3, D, device="meta"), boxes, valid,
                                  emb, n_valid, **KW)
    assert tracks.track_timeline.launches == launches


def test_track_scores_match_jax():
    rng = np.random.default_rng(7)
    processed = rng.integers(0, 40, (2, 6)).astype(np.int32)
    processed[0, 0] = 0
    flagged = np.minimum(rng.integers(0, 30, (2, 6)), processed).astype(np.int32)
    final = rng.integers(0, 25, (2, 6)).astype(np.int32)
    state = tracks.init_track_state(6, D, streams=2)._replace(
        processed=torch.from_numpy(processed), flagged_count=torch.from_numpy(flagged),
        final_counter=torch.from_numpy(final))
    for frames, fps in ((300, 30), (2000, 30), (50, 7)):
        got = tracks.track_scores(state, frames, fps)
        for s in range(2):
            jstate = jtracks.init_track_state(6, D)._replace(
                processed=jnp.asarray(processed[s]), flagged_count=jnp.asarray(flagged[s]),
                final_counter=jnp.asarray(final[s]))
            ref = np.asarray(jtracks.track_scores(jstate, jnp.int32(frames), jnp.int32(fps)))
            np.testing.assert_array_equal(got[s], ref)
        assert got[0, 0] == 0 and got.max() > 0


@pytest.mark.parametrize("plus_one", [False, True])
def test_iou_matrix_plus_one_matches_jax(plus_one):
    rng = np.random.default_rng(9)
    boxes = rng.uniform(0, 100, (12, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2] * 0.5
    boxes[3] = boxes[2]                         # a duplicate
    boxes[4, 2:] = boxes[4, :2]                 # an empty box
    for method in ("union", "min"):
        ref = np.asarray(j_iou_matrix(jnp.asarray(boxes), method=method, plus_one=plus_one))
        got = iou_matrix(torch.from_numpy(boxes), method=method, plus_one=plus_one).numpy()
        np.testing.assert_array_equal(got, ref)
