#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``truely_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit, as nvidia-smi reports them;
2. the build of every CUDA kernel of the score path (one nvcc per source,
   all started together);
3. kernels: K1-K4 at the shapes of one production step (1080p,
   frame_batch 32) on seeded random inputs, each held with ``torch.equal``
   to its plain PyTorch version run on the same CUDA tensors, and timed with
   CUDA events beside the plain version, a PyTorch library call where one
   computes the same function, and its bound;
4. end to end: ``Detector`` at the bf16 defaults with its own seeded weights
   runs ``analyze_i420`` on seeded synthetic 1080p I420 frames, one warm-up
   batch and then four batches of 32 sampled frames.  Every launch count is
   set to 0 just before that run and read just after it, and every kernel
   must have launched;
5. a float32 cross-check: GOLDEN_CONFIG (frame_batch 16, float32, TF32 off)
   on the card and on the CPU over the same 16 synthetic 640x360 frames.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits non-zero and prints no result.  ``--profile DIR`` also
traces one end-to-end batch with ``torch.profiler`` and writes the kernel
table and a Chrome trace into DIR.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM3 bandwidth and float32 rate outside the tensor cores.  The bound of a
# kernel is the larger of bytes / HBM_BYTES_PER_S and ops / F32_OPS_PER_S.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PEAKS = "H100 SXM peaks: 3.35 TB/s HBM, 67 TFLOP/s float32 (700 W)"

STEP_B, STEP_H, STEP_W = 32, 1080, 1920
E2E_BATCHES = 4
FPS = 7  # sample_interval(7) == 1: every frame is a sampled frame
# The seeded random nets are no face detectors: at the default thresholds
# they pass nothing on synthetic content.  The float32 cross-check lowers
# the R-Net and O-Net thresholds so that some frames carry a face and the
# boxes, crops, embeddings and similarities are compared too.
XCHECK_THRESHOLDS = (0.5, 0.1, 0.3)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    """A check that stays under ``python -O`` (unlike ``assert``)."""
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn: Callable[[], object], window_ms: float = 100.0) -> float:
    """Mean milliseconds of ``fn`` from CUDA events over back-to-back calls
    that fill about ``window_ms`` (3 to 1000 calls), after a warm-up call
    and a 3-call estimate: a 30 us kernel timed over 20 calls reads the
    clocks' ramp as much as the kernel."""
    def mean_ms(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    fn()
    torch.cuda.synchronize()
    estimate = mean_ms(3)
    return mean_ms(min(1000, max(3, int(window_ms / max(estimate, 1e-3)))))


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_i420(n: int, h: int, w: int, seed: int, block: int = 20) -> np.ndarray:
    """Packed I420 (n, 3h/2, w) uint8: block x block flat patches of seeded
    random luma and chroma (the pyramid keeps structure at every level)."""
    rng = np.random.default_rng(seed)

    def plane(ph, pw):
        small = rng.integers(16, 236, (n, -(-ph // block), -(-pw // block)), np.uint8)
        return np.repeat(np.repeat(small, block, axis=1), block, axis=2)[:, :ph, :pw]

    y = plane(h, w)
    u = plane(h // 2, w // 2).reshape(n, h // 4, w)
    v = plane(h // 2, w // 2).reshape(n, h // 4, w)
    return np.ascontiguousarray(np.concatenate([y, u, v], axis=1))


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------


class Form(NamedTuple):
    """One call form of a kernel at the shapes the main path gives it."""

    kernel: str
    label: str
    main: bool                      # on the bf16 default path
    run: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    library: Optional[Callable[[], object]]
    nbytes: float
    ops: float


def random_boxes(g, b, k, h, w, device, clusters=8):
    """(b, k, 4) float32 boxes of 12..800 px sides, clustered around a few
    centres per frame as cascade candidates are around faces."""
    def u(*shape, lo=0.0, hi=1.0):
        return torch.empty(shape, device=device).uniform_(lo, hi, generator=g)

    cid = torch.randint(0, clusters, (b, k), generator=g, device=device)
    cx = torch.gather(u(b, clusters, lo=0, hi=w), 1, cid)
    cy = torch.gather(u(b, clusters, lo=0, hi=h), 1, cid)
    side = torch.exp(torch.gather(u(b, clusters, lo=math.log(12), hi=math.log(800)), 1, cid))
    side = side * u(b, k, lo=0.8, hi=1.25)
    cx = cx + side * u(b, k, lo=-0.3, hi=0.3)
    cy = cy + side * u(b, k, lo=-0.3, hi=0.3)
    return torch.stack([cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2], -1)


def covered_pixels(x0, y0, x1, y1, h, w) -> int:
    """Pixels of (b, h, w) frames inside the union of each frame's
    half-open rectangles (b, k), by a 2-D difference array."""
    b = x0.shape[0]
    diff = torch.zeros((b, h + 1, w + 1), dtype=torch.int32, device=x0.device)
    nonempty = (x1 > x0) & (y1 > y0)
    bi = torch.arange(b, device=x0.device)[:, None].expand_as(x0)[nonempty]
    for ys, xs, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
        vals = torch.full((int(nonempty.sum()),), sign, dtype=torch.int32, device=x0.device)
        diff.index_put_((bi, ys[nonempty], xs[nonempty]), vals, accumulate=True)
    cover = diff.cumsum(1, dtype=torch.int32).cumsum(2, dtype=torch.int32)[:, :h, :w]
    return int((cover > 0).sum())


def kernel_forms(device) -> List[Form]:
    from truely_tpu_torch.ops import nms, resize, yuv
    from truely_tpu_torch.ops.boxes import pad_crop_bounds, rerec

    g = torch.Generator(device=device).manual_seed(1234)
    b, h, w = STEP_B, STEP_H, STEP_W
    forms: List[Form] = []

    # K1: one packed I420 batch -> BGR; per output byte an integer
    # multiply-add, a shift, an add and a clip.
    packed = torch.randint(0, 256, (b, h * 3 // 2, w), generator=g, device=device,
                           dtype=torch.uint8)
    forms.append(Form(
        "i420_to_bgr", f"({b},{h * 3 // 2},{w}) u8", True,
        lambda: yuv.i420_to_bgr(packed), lambda: yuv.i420_to_bgr_plain(packed), None,
        nbytes=packed.numel() + b * h * w * 3, ops=b * h * w * 3 * 4))

    # K2: the cascade's four NMS calls, on clustered candidates with tied
    # scores (multiples of 1/64) and a fifth of the slots invalid.
    for k, thr, method, grouped in ((256, 0.5, "union", True), (256, 0.7, "union", False),
                                    (64, 0.7, "union", False), (32, 0.7, "min", False)):
        boxes = random_boxes(g, b, k, h, w, device)
        scores = torch.floor(torch.empty((b, k), device=device).uniform_(
            0.6, 1.0, generator=g) * 64) / 64
        valid = torch.rand((b, k), generator=g, device=device) > 0.2
        groups = (torch.randint(0, 12, (b, k), generator=g, device=device, dtype=torch.int32)
                  if grouped else None)
        kw = dict(iou_threshold=thr, method=method, max_rounds=64, groups=groups)
        idx = torch.arange(k, device=device)
        outranks = (scores[:, :, None] > scores[:, None, :]) | (
            (scores[:, :, None] == scores[:, None, :]) & (idx[:, None] < idx[None, :]))
        pairs = outranks & valid[:, :, None] & valid[:, None, :]
        if grouped:
            pairs &= groups[:, :, None] == groups[:, None, :]
        # 14 float operations per IoU test of a valid pair (2 min, 2 max,
        # 4 add/sub, 2 clamps, 1 mul, 2 for the denominator, 1 div).
        forms.append(Form(
            "nms_masked_batch", f"K={k} {method} iou={thr}{' grouped' if grouped else ''}", True,
            lambda bx=boxes, s=scores, v=valid, kw=kw: nms.nms_masked_batch(bx, s, v, **kw),
            lambda bx=boxes, s=scores, v=valid, kw=kw: nms.nms_masked_batch_plain(bx, s, v, **kw),
            None, nbytes=b * k * (16 + 4 + 1 + 1 + (4 if grouped else 0)),
            ops=14 * int(pairs.sum())))

    frames = torch.randint(0, 256, (b, h, w, 3), generator=g, device=device, dtype=torch.uint8)

    # K3: stage crops, R-Net (K=64, 24x24) and O-Net (K=32, 48x48), at the
    # bf16 default's q=4 and at GOLDEN_CONFIG's exact q=1.
    for quant in (4, 1):
        for k, o in ((64, 24), (32, 48)):
            bounds = pad_crop_bounds(rerec(random_boxes(g, b, k, h, w, device)), w, h)
            x0, y0, x1, y1 = resize.snapped_bounds(bounds, quant)
            sy, ey = resize.bin_edges(y0, y1 - y0, o)
            sx, ex = resize.bin_edges(x0, x1 - x0, o)
            summed = (ey - sy).sum(-1) * (ex - sx).sum(-1) * quant * quant  # pixels added
            cover = covered_pixels(x0 * quant, y0 * quant, x1 * quant, y1 * quant, h, w)
            forms.append(Form(
                "crop_resize_area", f"K={k} O={o} q={quant}", quant == 4,
                lambda f=frames, bd=bounds, o=o, q=quant: resize.crop_resize_area(f, bd, o, quant=q),
                lambda f=frames, bd=bounds, o=o, q=quant: resize.crop_resize_area_plain(
                    f, bd, o, quant=q),
                None, nbytes=cover * 3 + bounds.numel() * 4 + b * k * o * o * 3 * 4,
                ops=int(summed.sum()) * 3 + b * k * o * o * 3))

    # K4: the 80x80 face crop, one box per frame, clamped as the embed tail
    # clamps it; three lerps of three operations per output value.  Library
    # yardstick: grid_sample over float frames at the same sample positions
    # (bilinear, border padding).
    o = 80
    bi = random_boxes(g, b, 1, h, w, device, clusters=1).to(torch.int32)
    bounds = torch.stack([bi[..., 0].clamp_min(0), bi[..., 1].clamp_min(0),
                          bi[..., 2].clamp_max(w), bi[..., 3].clamp_max(h)], -1)
    i = torch.arange(o, device=device, dtype=torch.float32)

    def positions(lo, hi):  # (b, o) sample coordinates in the frame
        n = (hi - lo).float()[:, None]
        s = torch.minimum(((i + 0.5) * n / o - 0.5).clamp_min(0), (n - 1).clamp_min(0))
        return lo.float()[:, None] + s

    def distinct(a, size):  # per frame, the source rows (or columns) read
        idx = torch.cat([a.floor(), a.floor() + 1], 1).clamp(0, size - 1)
        return [torch.unique(r).numel() for r in idx]

    ax = positions(bounds[:, 0, 0], bounds[:, 0, 2])
    ay = positions(bounds[:, 0, 1], bounds[:, 0, 3])
    pixels_read = sum(r * c for r, c in zip(distinct(ay, h), distinct(ax, w)))
    grid = torch.stack([((ax + 0.5) * 2 / w - 1)[:, None, :].expand(b, o, o),
                        ((ay + 0.5) * 2 / h - 1)[:, :, None].expand(b, o, o)], -1)
    frames_f = frames.permute(0, 3, 1, 2).float()
    forms.append(Form(
        "crop_resize_bilinear", f"K=1 O={o}", True,
        lambda: resize.crop_resize_bilinear(frames, bounds, o),
        lambda: resize.crop_resize_bilinear_plain(frames, bounds, o),
        lambda: torch.nn.functional.grid_sample(frames_f, grid, mode="bilinear",
                                                padding_mode="border", align_corners=False),
        nbytes=pixels_read * 3 + bounds.numel() * 4 + b * o * o * 3 * 4, ops=b * o * o * 3 * 9))
    return forms


SOURCES = {
    "i420_to_bgr": ("truely_tpu_torch/csrc/yuv.cu", "truely_tpu/ops/yuv.py:190"),
    "nms_masked_batch": ("truely_tpu_torch/csrc/nms.cu", "truely_tpu/ops/nms_pallas.py:124"),
    "crop_resize_area": ("truely_tpu_torch/csrc/crop_area.cu",
                         "truely_tpu/ops/crop_fused2.py:166"),
    "crop_resize_bilinear": ("truely_tpu_torch/csrc/crop_bilinear.cu",
                             "truely_tpu/ops/crop_pallas.py:188"),
}


def kernel_phase(device) -> dict:
    """Every form checked and timed; returns kernel name -> summary, whose
    times are per production step (the sum over the main-path forms)."""
    forms = kernel_forms(device)
    rows, failures = [], []
    for f in forms:
        got, want = f.run(), f.plain()
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = float((got.double() - want.double()).abs().max()) if got.shape == want.shape else math.inf
        ms = cuda_ms(f.run)
        plain_ms = cuda_ms(f.plain)
        lib_ms = cuda_ms(f.library) if f.library else None
        b_ms, by = bound_ms(f.nbytes, f.ops)
        rows.append(dict(kernel=f.kernel, form=f.label, main=f.main, equal=equal,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=by, bytes=f.nbytes, ops=f.ops))
        log(f"kernel {f.kernel} [{f.label}]{'' if f.main else ' (GOLDEN_CONFIG form)'}: "
            f"equal={equal} max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"bound_ms={b_ms:.5f} ({by}: {f.nbytes:.3e} B, {f.ops:.3e} ops)")
        if not equal:
            failures.append(f"{f.kernel} [{f.label}] differs from its plain version (max {err})")
    require(not failures, "; ".join(failures))
    log(f"kernels: all {len(rows)} forms equal to their plain versions; bounds from {PEAKS}")

    summary = {}
    for name in SOURCES:
        main = [r for r in rows if r["kernel"] == name and r["main"]]
        libs = [r["library_ms"] for r in main]
        b_ms = sum(r["bound_ms"] for r in main)
        summary[name] = dict(
            max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            ms=sum(r["ms"] for r in main), plain_ms=sum(r["plain_ms"] for r in main),
            bound_ms=b_ms,
            bound_by=max(main, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=None if None in libs else sum(libs),
            forms=[{k: r[k] for k in ("form", "main", "ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by")} for r in rows
                   if r["kernel"] == name])
    return summary


# ---------------------------------------------------------------------------
# End-to-end phase
# ---------------------------------------------------------------------------


def launch_counters():
    from truely_tpu_torch.ops import nms, resize, yuv

    return {"i420_to_bgr": yuv.i420_to_bgr, "nms_masked_batch": nms.nms_masked_batch,
            "crop_resize_area": resize.crop_resize_area,
            "crop_resize_bilinear": resize.crop_resize_bilinear}


def stage_times(det, packed: torch.Tensor) -> dict:
    """Milliseconds of each stage of one frame step, synchronised around
    each stage (so the stages do not overlap as they do in a plain run)."""
    from truely_tpu_torch.ops.temporal import init_temporal_state
    from truely_tpu_torch.ops.yuv import i420_to_bgr
    from truely_tpu_torch.pipeline import mtcnn
    from truely_tpu_torch.pipeline.detector import embed_tail

    cfg, dtype = det.config, det.dtype
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.inference_mode():
        frames = timed("i420_to_bgr", lambda: i420_to_bgr(packed))
        boxes, scores, valid = timed("stage1 (pyramid, P-Net, top-k, NMS x2)",
                                     lambda: mtcnn._stage1(det.nets.mtcnn, frames, cfg.mtcnn, dtype))
        k2 = min(cfg.mtcnn.rnet_capacity, boxes.shape[1])
        dets = timed("stages 2-3 (crops, R-Net, O-Net, NMS x2)", lambda: mtcnn._stages23(
            det.nets.mtcnn, frames, boxes, scores, valid, cfg.mtcnn, k2=k2,
            k3=min(cfg.mtcnn.onet_capacity, k2), dtype=dtype))
        box, _score, has_face = mtcnn.select_primary_face(dets)
        out = timed("embed (face crop, FaceNet, landmarks)", lambda: embed_tail(
            det.nets, frames, box, has_face, cfg, dtype))
        timed("temporal", lambda: det.temporal(
            out, packed.shape[0], init_temporal_state(det.embedding_dim, det.device)))
    return times


def profile_batch(det, packed: np.ndarray, out_dir: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.analyze_i420(packed, fps=FPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    # Time of every device kernel (the attribute's name changed across
    # PyTorch versions).
    device_us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                    for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA"))
    log(f"profile: one batch {wall * 1e3:.2f} ms wall, {device_us / 1e3:.2f} ms of device "
        f"kernels (idle share {1 - device_us / 1e6 / wall:.3f}); table in {out_dir}/profile.txt")
    log("\n".join(table.splitlines()[:30]))


def e2e_phase(profile_dir: Optional[str]) -> dict:
    """Returns each kernel's launch count over the timed batches."""
    from truely_tpu_torch.config import DetectorConfig
    from truely_tpu_torch.pipeline.detector import Detector

    cfg = DetectorConfig()  # the bf16 defaults
    b = cfg.frame_batch
    t0 = time.perf_counter()
    det = Detector(cfg)
    packed = synthetic_i420(b * (1 + E2E_BATCHES), STEP_H, STEP_W, seed=7)
    log(f"e2e: Detector({cfg.compute_dtype}, frame_batch {b}) and {packed.shape[0]} frames "
        f"of {STEP_W}x{STEP_H} I420 ready in {time.perf_counter() - t0:.1f} s")

    det.analyze_i420(packed[:b], fps=FPS)  # warm-up batch
    torch.cuda.synchronize()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = det.analyze_i420(packed[b:], fps=FPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    n = res.total_processed
    require(n == b * E2E_BATCHES == len(res.records), f"{n} sampled, {len(res.records)} records")
    sims = np.array([r.similarity for r in res.records])
    require(bool(np.isfinite(sims).all() and (np.abs(sims) <= 1.0 + 1e-5).all()),
            f"similarities out of range: {sims}")
    require(0 <= res.fake_score <= 100, f"fake_score {res.fake_score}")
    faces = sum(r.has_face for r in res.records)
    log(f"e2e: {n} sampled frames in {wall:.4f} s = {n / wall:.2f} sampled frames/s "
        f"({E2E_BATCHES} batches of {b}); frames with a face: {faces}; "
        f"fake_score {res.fake_score}; host timings {json.dumps(res.timings)}")
    log(json.dumps({"launches": launches}))
    missing = [k for k, v in launches.items() if v <= 0]
    require(not missing, f"kernels not launched on the main path: {missing}")

    step = torch.from_numpy(packed[b:2 * b]).to(det.device)
    stage_times(det, step)  # warm
    times = stage_times(det, step)
    log("e2e stages (ms, one batch of 32, synchronised per stage): "
        + json.dumps({k: round(v, 3) for k, v in times.items()}))
    if profile_dir:
        profile_batch(det, packed[b:2 * b], profile_dir)
    return launches


# ---------------------------------------------------------------------------
# float32 cross-check
# ---------------------------------------------------------------------------


def xcheck_phase() -> None:
    from truely_tpu_torch.config import DetectorConfig, MTCNNConfig
    from truely_tpu_torch.pipeline.detector import Detector

    cfg = DetectorConfig(frame_batch=16, compute_dtype="float32",
                         mtcnn=MTCNNConfig(thresholds=XCHECK_THRESHOLDS))
    packed = synthetic_i420(16, 360, 640, seed=12)
    gpu = Detector(cfg).analyze_i420(packed, fps=FPS)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cpu = Detector(cfg, device="cpu").analyze_i420(packed, fps=FPS)
    hf_g = [r.has_face for r in gpu.records]
    hf_c = [r.has_face for r in cpu.records]
    require(hf_g == hf_c, f"has_face differs: card {hf_g}, CPU {hf_c}")
    require(sum(hf_c) >= 2, f"cross-check needs face frames, got {sum(hf_c)}")
    box_err = float(np.abs(np.array([r.box for r in gpu.records])
                           - np.array([r.box for r in cpu.records])).max())
    sim_err = float(np.abs(np.array([r.similarity for r in gpu.records])
                           - np.array([r.similarity for r in cpu.records])).max())
    log(f"xcheck float32 (GOLDEN_CONFIG, thresholds {XCHECK_THRESHOLDS}, TF32 off): "
        f"{sum(hf_c)}/16 frames with a face on both; max box err {box_err} px, "
        f"max sim err {sim_err:.3e}; scores {gpu.fake_score} / {cpu.fake_score}")
    require(box_err <= 1.0 and sim_err <= 2e-4, f"box err {box_err} px, sim err {sim_err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also trace one end-to-end batch into DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from truely_tpu_torch.ops import cuda_build

    log(card_line())
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    cuda_build.build()
    log(f"build: {len(cuda_build.SOURCES)} kernel sources (nvcc {' '.join(cuda_build.NVCC_FLAGS[:4])}) "
        f"in {time.perf_counter() - t0:.1f} s")
    for src, report in sorted(cuda_build.build_log.items()):
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
        log(f"build {src}: {'; '.join(regs)}")

    summary = kernel_phase("cuda")
    launches = e2e_phase(args.profile)
    xcheck_phase()

    kernels = []
    for kname, (source, replaces) in SOURCES.items():
        s = summary[kname]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname], max_abs_err=s["max_abs_err"], ms=s["ms"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"], bound_by=s["bound_by"],
            library_ms=s["library_ms"], forms=s["forms"]))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
