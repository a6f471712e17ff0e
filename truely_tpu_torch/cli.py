"""Command-line interface (counterpart of ``truely_tpu/cli.py``).

``python -m truely_tpu_torch analyze <video>`` prints the fake score, the
suspicious frames and the per-stage timings of one video as JSON, and
writes the annotated video with ``-o``.  ``stream`` runs N video files as
concurrent streams through shared device batches.  ``serve`` starts the API
server (``serve/app.py``).  All three run on the CUDA device unless
``--device cpu`` asks for the CPU, and ``--dp N`` splits every frame batch
over the first N CUDA devices (with ``--device cpu``: N positions on the
CPU).  Without cv2 only uncompressed I420 AVI files are read, and only
``.avi`` outputs written.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def _interval_divisor(detect_interval) -> int:
    """What --batch must divide by for a --detect-interval value ("auto"
    ladders up to auto_interval_max, 8, so the cap is the divisor)."""
    return 8 if detect_interval == "auto" else max(1, detect_interval)


def _interval_arg(value: str):
    if value == "auto":
        return "auto"
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f'expected an integer or "auto", got {value!r}')


def _resolution(value: str) -> str:
    """An ``HxW`` warmup bucket, checked at parse time (a malformed one
    would otherwise show only as a warning of the warmup thread)."""
    try:
        h, w = map(int, value.lower().split("x"))
        if h <= 0 or w <= 0:
            raise ValueError
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected HxW (e.g. 1080x1920), got {value!r}")
    return value


def _check_batch(args) -> bool:
    if args.batch % _interval_divisor(args.detect_interval):
        print(f"error: --batch {args.batch} must be divisible by --detect-interval "
              f"{args.detect_interval} (auto: by its interval cap, 8)", file=sys.stderr)
        return False
    return True


def _dp_mesh(args):
    """(ok, mesh): the ``--dp N`` data mesh over the first N CUDA devices
    (``--device cpu``: N positions on the CPU), None for N = 1; not ok
    after printing why (too few devices, a batch that does not divide)."""
    if args.dp <= 1:
        return True, None
    import torch

    from truely_tpu_torch.parallel.mesh import make_mesh

    if torch.device(args.device).type == "cpu":
        devices = ["cpu"] * args.dp
    else:
        n = torch.cuda.device_count()
        if n < args.dp:
            print(f"error: --dp {args.dp} needs {args.dp} devices, have {n}", file=sys.stderr)
            return False, None
        devices = [torch.device("cuda", i) for i in range(args.dp)]
    if args.batch % args.dp:
        print(f"error: --batch {args.batch} must be divisible by --dp {args.dp}",
              file=sys.stderr)
        return False, None
    return True, make_mesh((args.dp, 1), ("data", "model"), devices=devices)


def _detector(config, args):
    """The detector on ``--device`` (over the ``--dp`` mesh), or None after
    printing why not."""
    from truely_tpu_torch.pipeline.detector import Detector

    ok, mesh = _dp_mesh(args)
    if not ok:
        return None
    try:
        return Detector(config, weights_dir=args.weights,
                        device=None if mesh is not None else args.device, mesh=mesh)
    except RuntimeError as e:  # no CUDA device
        print(f"error: {e}", file=sys.stderr)
        return None


def _warn_if_seeded(detector) -> None:
    if not detector.facenet_pretrained:
        print("warning: no converted FaceNet weights found (set TRUELY_TPU_WEIGHTS); "
              "running with seeded random weights — scores are not meaningful", file=sys.stderr)


def _classifier(args):
    """The ``--classifier`` option's ``ClassifierConfig`` (None without it),
    or False after printing why it cannot run."""
    from truely_tpu_torch.config import ClassifierConfig

    if not args.classifier:
        return None
    if not args.multi_face:
        print("error: --classifier runs on the multi-face path: add --multi-face",
              file=sys.stderr)
        return False
    return ClassifierConfig()


def cmd_analyze(args) -> int:
    from truely_tpu_torch.config import DetectorConfig, MTCNNConfig

    if not os.path.isfile(args.video):
        # Fail before paying model init and device attach.
        print(f"error: could not open video: {args.video}", file=sys.stderr)
        return 1
    classifier = _classifier(args)
    if not _check_batch(args) or classifier is False:
        return 1
    config = DetectorConfig(
        frame_batch=args.batch,
        reference_compat=not args.corrected,
        multi_face=args.multi_face,
        classifier=classifier,
        yuv_ingest=not args.no_yuv,
        detect_interval=args.detect_interval,
        propagate_fallback=not args.no_propagate_fallback,
        draw_mode=args.draw,
        mtcnn=MTCNNConfig(pyramid_cascade=not args.exact_pyramid,
                          stage_crop_quant=args.crop_quant),
    )
    detector = _detector(config, args)
    if detector is None:
        return 1
    _warn_if_seeded(detector)
    if args.multi_face:
        # Per-track scoring; the aggregate is the max over tracks.
        try:
            result = detector.analyze_video_multiface(args.video, args.output)
        except (IOError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        score, per_track = result[:2]
        payload = {"fakeScore": int(score), "trackScores": [int(s) for s in per_track]}
        if classifier is not None:
            got = result[3]
            payload["classifierScore"] = float(got.score)
            payload["classifierMemberScores"] = [float(s) for s in got.member_scores]
            payload["classifiedCrops"] = int(got.mask.sum())
        if args.output:
            payload["outputPath"] = args.output
        print(json.dumps(payload, indent=None if args.compact else 2))
        return 0
    try:
        result = detector.analyze_video(args.video, args.output)
    except (IOError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    payload = {
        "fakeScore": result.fake_score,
        "frameCount": result.frame_count,
        "fps": result.fps,
        "processedFrames": result.total_processed,
        "flaggedFrames": result.flagged_count,
        "suspiciousFrames": result.suspicious_frames,
        "timings": {k: round(v, 4) for k, v in result.timings.items()},
    }
    if args.output:
        payload["outputPath"] = args.output
    print(json.dumps(payload, indent=None if args.compact else 2))
    return 0


def cmd_stream(args) -> int:
    """N video files as concurrent streams through one shared device batch:
    per-stream events as JSON lines with --events, then the end-of-stream
    summaries with sampled frames/s and lag statistics."""
    from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
    from truely_tpu_torch.pipeline.stream_files import stream_videos

    for p in args.videos:
        if not os.path.isfile(p):
            print(f"error: could not open video: {p}", file=sys.stderr)
            return 1
    if not _check_batch(args):
        return 1
    config = DetectorConfig(
        frame_batch=args.batch,
        reference_compat=not args.corrected,
        yuv_ingest=not args.no_yuv,
        sample_hz=args.sample_hz,
        detect_interval=args.detect_interval,
        multi_face=args.multi_face,
        mtcnn=MTCNNConfig(pyramid_cascade=not args.exact_pyramid,
                          stage_crop_quant=args.crop_quant),
    )
    detector = _detector(config, args)
    if detector is None:
        return 1

    def emit(e):
        if args.multi_face:
            print(json.dumps({
                "stream": e.stream_id,
                "frame": e.frame_index,
                "flagged": e.flagged,
                "tracks": [
                    {
                        "updated": bool(e.track_updated[t]),
                        "flagged": bool(e.track_flagged[t]),
                        "similarity": round(float(e.track_sim[t]), 6),
                        "box": [round(float(v), 1) for v in e.track_boxes[t]],
                    }
                    for t in range(len(e.track_updated))
                    if e.track_active[t]
                ],
            }), flush=True)
            return
        print(json.dumps({
            "stream": e.stream_id,
            "frame": e.frame_index,
            "hasFace": e.has_face,
            "flagged": e.flagged,
            "similarity": round(e.similarity, 6),
            "counter": e.counter,
        }), flush=True)

    sched_stats: dict = {}
    try:
        summaries = stream_videos(
            detector, args.videos,
            frames_per_stream=args.frames_per_stream,
            realtime=args.realtime,
            partial_step_budget=args.partial_budget,
            on_event=emit if args.events else None,
            scheduler_stats=sched_stats,
        )
    except (IOError, OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if sched_stats:  # diagnostics on stderr; stdout stays the summary list
        print(json.dumps({"schedulerEfficiency": {
            "steps": sched_stats["steps"],
            "framesScored": sched_stats["frames_scored"],
            "framesPadded": sched_stats["frames_padded"],
            "batchUtilization": round(sched_stats["batch_utilization"], 4),
        }}), file=sys.stderr)
    payload = [
        {
            "path": s.path,
            "fakeScore": s.fake_score,
            **({"trackScores": s.track_scores} if s.track_scores is not None else {}),
            "frameCount": s.frame_count,
            "fps": s.fps,
            "processedFrames": s.processed,
            "flaggedFrames": s.flagged_count,
            "suspiciousFrames": s.suspicious_frames,
            "sampledFps": round(s.sampled_fps, 2),
            "meanLagMs": round(s.mean_lag_s * 1000, 1),
            "p50LagMs": round(s.p50_lag_s * 1000, 1),
            "p95LagMs": round(s.p95_lag_s * 1000, 1),
            "maxLagMs": round(s.max_lag_s * 1000, 1),
            "wallSeconds": round(s.wall_s, 3),
            "yuvIngest": s.yuv_ingest,
        }
        for s in summaries
    ]
    print(json.dumps(payload, indent=None if args.compact else 2))
    return 0


def cmd_serve(args) -> int:
    """The API server on the port's detector.  The detector is built before
    the socket opens, so a missing CUDA device fails at start-up."""
    from truely_tpu_torch.config import DetectorConfig, MTCNNConfig, ServerConfig
    from truely_tpu_torch.serve import app as serve_app

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    classifier = _classifier(args)
    if not _check_batch(args) or classifier is False:
        return 1
    config = DetectorConfig(
        frame_batch=args.batch,
        multi_face=args.multi_face,
        classifier=classifier,
        detect_interval=args.detect_interval,
        mtcnn=MTCNNConfig(stage_crop_quant=args.crop_quant),
    )
    detector = _detector(config, args)
    if detector is None:
        return 1
    _warn_if_seeded(detector)
    app = serve_app.create_app(
        config=ServerConfig(host=args.host, port=args.port,
                            warmup_resolutions=tuple(args.warmup or ())),
        detector=detector,
    )
    app.serve()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="truely_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("analyze", help="analyze a video file")
    p.add_argument("video")
    p.add_argument("-o", "--output",
                   help="write the annotated video here (.avi: uncompressed I420; other "
                        "containers need cv2)")
    p.add_argument("--batch", type=int, default=32, help="device frame batch")
    p.add_argument("--weights", help="directory of converted .npz weights")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the plain versions "
                        "of the kernels)")
    p.add_argument("--corrected", action="store_true",
                   help="RGB + corrected semantics instead of reference compat")
    p.add_argument("--compact", action="store_true", help="one-line JSON")
    p.add_argument("--no-yuv", action="store_true",
                   help="decode I420 AVI files to BGR on the host instead of converting on "
                        "the device (results are identical either way)")
    p.add_argument("--exact-pyramid", action="store_true",
                   help="resample every pyramid level from the full frame (exact area "
                        "semantics) instead of the cascaded resample")
    p.add_argument("--crop-quant", type=int, default=4,
                   help="snap R-Net/O-Net crop boxes to an N-px grid (bf16 only); 1 = exact "
                        "full-resolution crops")
    p.add_argument("--multi-face", action="store_true",
                   help="score every tracked face (aggregate = max over tracks) instead of "
                        "the reference's first face only; prints per-track scores")
    p.add_argument("--classifier", action="store_true",
                   help="with --multi-face: also score every face crop with the DFDC winner's "
                        "classifier (seven EfficientNet-B7 nets, the confident strategy; "
                        "seeded weights)")
    p.add_argument("--draw", choices=("all", "flagged-only"), default="all",
                   help="annotated-output draw policy: 'all' = the reference contract "
                        "(red/green box on every sampled frame with a face); 'flagged-only' "
                        "= red boxes on flagged frames only, so clean frames re-encode "
                        "straight from the decoded I420 planes (decisions identical)")
    p.add_argument("--detect-interval", type=_interval_arg, default=1,
                   help="track-propagated detection: run the full pyramid+P-Net cascade only "
                        "every K-th sampled frame and refine the frames between from the "
                        "keyframe box through R-Net/O-Net (1 = off; batch must divide by K; "
                        '"auto" ladders K up to 8)')
    p.add_argument("--no-propagate-fallback", action="store_true",
                   help="with --detect-interval: never re-run full detection on segments "
                        "whose refinement collapsed")
    p.add_argument("--dp", type=int, default=1,
                   help="shard each frame batch over the first N devices (data-parallel "
                        "mesh); batch must divide by N")
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("stream",
                       help="analyze N video files as concurrent live streams (shared device "
                            "batches; per-stream events + lag stats)")
    p.add_argument("videos", nargs="+", help="same-resolution video files")
    p.add_argument("--batch", type=int, default=32,
                   help="total device frame batch shared by all streams")
    p.add_argument("--frames-per-stream", type=int, default=None,
                   help="sampled frames per stream per step (default: batch // n_streams)")
    p.add_argument("--weights", help="directory of converted .npz weights")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--corrected", action="store_true",
                   help="RGB + corrected semantics instead of reference compat")
    p.add_argument("--events", action="store_true",
                   help="print one JSON line per sampled frame as its device step completes")
    p.add_argument("--realtime", action="store_true",
                   help="pace each stream at its fps (live-feed simulation; lag stats then "
                        "reflect steady-state latency)")
    p.add_argument("--detect-interval", type=_interval_arg, default=1,
                   help="track-propagated streaming: full cascade every K-th scheduler step, "
                        "per-stream seeded refinement between")
    p.add_argument("--multi-face", action="store_true",
                   help="per-track scoring for every stream: events carry per-track "
                        "boxes/flags, summaries per-track scores")
    p.add_argument("--partial-budget", type=float, default=0.0,
                   help="realtime only: defer a partial batch until its oldest queued frame "
                        "is this many seconds old")
    p.add_argument("--sample-hz", type=int, default=7,
                   help="sampling rate law: analyze every max(1, int(fps/sample_hz))-th frame")
    p.add_argument("--no-yuv", action="store_true",
                   help="decode I420 AVI files to BGR on the host")
    p.add_argument("--compact", action="store_true", help="one-line JSON")
    p.add_argument("--exact-pyramid", action="store_true",
                   help="exact full-frame pyramid resample (see analyze)")
    p.add_argument("--crop-quant", type=int, default=4,
                   help="stage-crop box grid (1 = exact; see analyze)")
    p.add_argument("--dp", type=int, default=1,
                   help="shard the shared batch over the first N devices")
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("serve", help="start the API server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5001)
    p.add_argument("--batch", type=int, default=32,
                   help="device frame batch for the server's detector")
    p.add_argument("--weights", help="directory of converted .npz weights")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--multi-face", action="store_true",
                   help="per-track scoring for /analyze-* (aggregate = max over tracks)")
    p.add_argument("--classifier", action="store_true",
                   help="with --multi-face: /analyze-video also returns the DFDC winner's "
                        "classifier score (classifierScore)")
    p.add_argument("--crop-quant", type=int, default=4,
                   help="stage-crop box grid (1 = exact; see analyze)")
    p.add_argument("--detect-interval", type=_interval_arg, default=1,
                   help="track-propagated detection for the server's analyses (see analyze). "
                        "At K>1 grouped jobs score under the stream scheduler's cadence, so "
                        "their decisions may differ from a solo run at the same K")
    p.add_argument("--warmup", action="append", metavar="HxW", type=_resolution,
                   help="warm this resolution bucket at start-up: build the kernels and run "
                        "one step of each path (repeatable, e.g. --warmup 1080x1920); "
                        "progress shows in /health")
    p.add_argument("--dp", type=int, default=1,
                   help="shard the server's frame batches over the first N devices")
    p.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
