"""One pass of every sharded program over an explicit device list (the
counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m truely_tpu_torch.parallel.dryrun [N]

runs it on N positions of CUDA device 0 (default 2), or with ``--cpu`` on
the CPU.  The positions may repeat one device: the mesh is a single-process
one (``parallel/mesh.py``), so every split, replica, gather, stage hand-off
and gradient sum runs for real.  Unlike the JAX function it never re-runs
itself elsewhere: the caller names the devices.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence

import numpy as np
import torch


def dryrun_multichip(devices: Sequence, *, height: int = 360, width: int = 640) -> dict:
    """On a mesh over ``devices`` ((N/2, 2) of ('data', 'model') when N is
    even, else (N, 1)), one step each of: (1) the DP/TP training step of
    the learnable heads; (2) the DP detector steps at the production config
    (bf16 defaults) on ``height`` x ``width`` frames: BGR, packed I420, the
    propagate step, the scheduler's refine step, and the multi-face full,
    propagate and refine steps; (3) the SP temporal pass; (4) the DP x PP
    Block17 chain (2 blocks a stage).  Returns a summary and prints it as
    one line."""
    from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
    from truely_tpu_torch.models.weights import params_to_numpy
    from truely_tpu_torch.parallel.mesh import make_mesh
    from truely_tpu_torch.parallel.pipeline import pipeline_block17
    from truely_tpu_torch.parallel.sharding import (
        replicate, shard_frame_step, sharded_temporal, tp_shard_facenet,
    )
    from truely_tpu_torch.parallel.train import (
        make_train_step, numpy_batch, train_params_from_numpy,
    )
    from truely_tpu_torch.pipeline.detector import Detector

    devices = list(devices)
    n = len(devices)
    model_par = 2 if n % 2 == 0 else 1
    dp = n // model_par
    mesh = make_mesh((dp, model_par), ("data", "model"), devices=devices)
    config = DetectorConfig(
        frame_batch=2 * dp, compute_dtype="float32",
        mtcnn=MTCNNConfig(pnet_topk_total=32, rnet_capacity=8, onet_capacity=4))
    det = Detector(config, device=mesh.first_device)
    nets = replicate(mesh, tp_shard_facenet(mesh, det.nets))
    rng = np.random.default_rng(0)
    b = 2 * dp

    # 1) the training step, DP batch and TP embedder
    tree = {"facenet": params_to_numpy(det.nets.facenet),
            "landmark": params_to_numpy(det.nets.landmark)}
    init_fn, step_fn = make_train_step(mesh)
    state = init_fn(tp_shard_facenet(mesh, train_params_from_numpy(tree)))
    state, metrics = step_fn(state, numpy_batch(rng, b))

    # 2) the DP detector steps at the production config
    prod = DetectorConfig(frame_batch=b)
    dev0 = mesh.first_device
    frames = torch.from_numpy(rng.integers(0, 256, (b, height, width, 3), dtype=np.uint8)).to(dev0)
    out = shard_frame_step(mesh, prod)(nets, frames)
    packed = torch.from_numpy(
        rng.integers(0, 256, (b, height * 3 // 2, width), dtype=np.uint8)).to(dev0)
    out_yuv = shard_frame_step(mesh, prod, yuv=True)(nets, packed)
    seeds = torch.from_numpy(rng.uniform(10, 100, (b // 2, 4)).astype(np.float32)).to(dev0)
    valid = torch.ones((b // 2,), dtype=torch.bool, device=dev0)
    prop = DetectorConfig(frame_batch=b, detect_interval=2)
    shard_frame_step(mesh, prop, propagate=True)(nets, frames, seeds, valid)
    shard_frame_step(mesh, prod, refine_rows=2)(nets, frames, seeds, valid)
    mf = DetectorConfig(frame_batch=b, multi_face=True, detect_interval=2)
    mf_boxes, mf_valid, _ = shard_frame_step(mesh, mf, multiface=True)(nets, frames)
    t = mf.max_tracks
    mf_seeds = torch.from_numpy(
        rng.uniform(10, 100, (b // 2, t, 4)).astype(np.float32)).to(dev0)
    mf_sv = torch.ones((b // 2, t), dtype=torch.bool, device=dev0)
    shard_frame_step(mesh, mf, multiface=True, propagate=True)(nets, frames, mf_seeds, mf_sv)
    shard_frame_step(mesh, mf, multiface=True, refine_rows=2)(nets, frames, mf_seeds, mf_sv)

    # 3) the sequence-parallel temporal pass
    t_len = 8 * dp
    emb = torch.from_numpy(rng.normal(size=(t_len, 512)).astype(np.float32)).to(dev0)
    res = sharded_temporal(mesh, config)(emb, torch.ones(t_len, dtype=torch.bool, device=dev0),
                                         t_len)

    # 4) the pipeline-parallel Block17 chain, DP x PP
    summary = {"mesh": dict(mesh.shape), "devices": [str(d) for d in devices],
               "train_loss": float(metrics["loss"]),
               "faces": int(out.has_face.sum()), "faces_i420": int(out_yuv.has_face.sum()),
               "multiface_slots": int(mf_valid.sum()), "final_counter": int(res.final_counter)}
    if model_par > 1:
        mesh_pp = make_mesh((dp, model_par), ("data", "stage"), devices=devices)
        blocks = list(det.nets.facenet.repeat_2[:2 * model_par])
        n_micro = 2
        x = torch.from_numpy(
            rng.normal(size=(2 * dp * n_micro, 4, 4, 896)).astype(np.float32)).to(dev0)
        stages, pp_fn = pipeline_block17(mesh_pp, blocks, n_microbatches=n_micro,
                                         data_axis="data")
        with torch.inference_mode():
            summary["pp_out_norm"] = float(torch.linalg.vector_norm(pp_fn(stages, x)))
    else:
        summary["pp_out_norm"] = None
    print("dryrun_multichip ok: " + json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one pass of every sharded program")
    ap.add_argument("n", nargs="?", type=int, default=2, help="mesh positions (default 2)")
    ap.add_argument("--cpu", action="store_true", help="positions on the CPU, not CUDA device 0")
    ap.add_argument("--size", default="360x640", help="HxW of the detector steps' frames")
    args = ap.parse_args(argv)
    h, w = map(int, args.size.split("x"))
    if not args.cpu and not torch.cuda.is_available():
        print("error: no CUDA device; pass --cpu", file=sys.stderr)
        return 1
    device = "cpu" if args.cpu else "cuda:0"
    dryrun_multichip([device] * args.n, height=h, width=w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
