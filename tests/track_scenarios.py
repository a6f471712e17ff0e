"""Seeded track-fold scenarios shared by the tracker's tests: the CPU tests
against the JAX package (``test_torch_tracks.py``) and kernel K6's tests on
the card (``test_torch_tracks_card.py``), which import no JAX.  Each test
of K6 has a CPU test of the plain version against JAX on the same inputs."""

import numpy as np

D = 8
KW = dict(similarity_threshold=0.99, run_length_threshold=3, max_misses=2)
EXACT = ("active", "box", "embedding", "has_prev", "counter", "flagged_count", "processed",
         "misses", "final_counter")


def unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def sequence(seed, f=24, k=4, scenario="random", d=D):
    """(boxes (F, K, 4), valid (F, K), emb (F, K, d)): three faces that
    drift a few px a frame, listed in a shuffled order with dropouts.
    "ties": faces 0 and 1 share one box (equal IoUs across tracks and
    detections).  "retire": face 2 leaves for 4 frames (more than
    max_misses) and a new face takes its slot when it comes back."""
    rng = np.random.default_rng(seed)
    base = np.array([[10, 10, 50, 50], [120, 20, 170, 80], [60, 90, 100, 140]], np.float32)
    if scenario == "ties":
        base[1] = base[0]
    ident = unit(rng.normal(size=(3, d)))
    boxes = np.zeros((f, k, 4), np.float32)
    valid = np.zeros((f, k), bool)
    emb = np.zeros((f, k, d), np.float32)
    for i in range(f):
        order = rng.permutation(3)
        for slot, face in enumerate(order):
            boxes[i, slot] = base[face] + rng.integers(-3, 4, 4) + i
            emb[i, slot] = unit(ident[face] + rng.normal(size=d) * 0.08)
            gone = scenario == "retire" and face == 2 and 8 <= i < 12
            valid[i, slot] = not gone and rng.random() > 0.15
            if scenario == "retire" and face == 2 and i >= 12:
                boxes[i, slot] += 200          # a new face elsewhere
        # slot 3: noise, valid now and then (the cascade's weakest detection)
        boxes[i, 3] = rng.uniform(0, 300, 4)
        boxes[i, 3, 2:] += boxes[i, 3, :2]
        emb[i, 3] = unit(rng.normal(size=d))
        valid[i, 3] = rng.random() > 0.7
    return boxes, valid, emb


def crowd(seed, f=24, k=48, faces=40, d=D):
    """(boxes (F, K, 4), valid (F, K), emb (F, K, d)): ``faces`` faces on a
    grid of 40 px boxes 60 px apart, drifting a few px a frame, listed in a
    shuffled order over the K slots, the other slots noise (valid now and
    then); a face is missed a seventh of the time.  Faces 0-7 leave for 4
    frames (more than max_misses 2) and come back elsewhere, so new tracks
    spawn into the vacated slots.  Past 32 tracks or detections it takes
    more than one warp's lanes in kernel K6."""
    rng = np.random.default_rng(seed)
    at = np.arange(faces)
    corner = np.stack([at % 8 * 60, at // 8 * 60], -1).astype(np.float32)
    base = np.concatenate([corner, corner + 40], -1)
    ident = unit(rng.normal(size=(faces, d)))
    boxes = rng.uniform(0, 500, (f, k, 4)).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2] * 0.2 + 10
    valid = rng.random((f, k)) > 0.7
    emb = unit(rng.normal(size=(f, k, d)))
    for i in range(f):
        slots = rng.permutation(k)[:faces]
        for face, slot in enumerate(slots):
            boxes[i, slot] = base[face] + rng.integers(-3, 4, 4) + i
            if face < 8 and i >= 12:
                boxes[i, slot] += 1000             # back, elsewhere
            emb[i, slot] = unit(ident[face] + rng.normal(size=d) * 0.08)
            valid[i, slot] = not (face < 8 and 8 <= i < 12) and rng.random() > 1 / 7
    return boxes, valid, emb


def retire_then_spawn_steps():
    """[(box (1, 4), valid (1,), emb (1, D)), ...]: one face for 6 frames,
    gone for 3 (more than max_misses 2: retired), then a face elsewhere."""
    b = np.array([[10, 10, 50, 50]], np.float32)
    e = unit(np.ones((1, D)))
    steps = [(b, True)] * 6 + [(b, False)] * 3 + [(b + 300, True)] * 2
    return [(box, np.array([ok]), unit(e + np.float32(0.2) * i))
            for i, (box, ok) in enumerate(steps)]
