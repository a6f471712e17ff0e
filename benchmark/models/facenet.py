"""The model of the ``facenet_*`` configurations: facenet-pytorch's MTCNN
cascade (P-, R-, O-Net), Inception-ResNet-v1 and landmark68, as the port's
``Detector`` runs them.

A configuration file names its model by ``"model"``, and the harness finds
``models/<model>.py`` by that name (``spec.model``).  What the harness asks
of a model module, with this model's answer:

- ``seeded_trees(seed, device, config)``: the weights, drawn from the
  seed on the device (``weights.seeded_trees``: one draw over the five
  nets, scaled as the configuration's ``assumed`` says);
- ``detector(config, trees, device, mesh)``: the program, an object with
  ``warmup(h, w)``, ``device``, ``fallback_segments`` and, where the
  configuration is multi-face, ``track_fold`` (the port's ``Detector``);
- ``entry(program, config)``: the call that the window times, from a
  clip's packed I420 frames and their rate to the program's result
  (``analyze_i420``, or ``analyze_i420_tracks`` multi-face);
- ``reference(config, trees, device, fps, rows)``: a function from a
  clip's packed I420 frames to the plain reference's answer, computed
  through ``reference/layers.py`` so that ``fp8_matmuls()`` makes it the
  control (``rows``: the rows of a batch on one card);
- ``answer(result)``: the program's result for a clip in the
  reference's form;
- ``check(config, got, want)``: the numbers that the configuration's
  ``limits`` hold (``check.py``: records single-face, tracks multi-face);
- ``row_flops(detector, h, w)``: operations of one sampled frame by kind
  of frame step, for ``step_mfu`` (``counts/nets.py``);
- ``step_forms(detector, kind, rows, h, w)``: (kernel, bytes, operations)
  of each K1-K4 launch of one frame step, for ``kernels_roofline``
  (``counts/kernels.py``; a clip's frames come as I420).
"""

from __future__ import annotations

from typing import Dict, Mapping

from benchmark import weights
from benchmark.check import numbers, records_of, tracks_of
from benchmark.counts import kernels
from benchmark.reference import analysis as ref


def seeded_trees(seed: int, device, config: Mapping):
    return weights.seeded_trees(seed, device, config["assumed"])


def detector_kwargs(detector: Mapping, reference: bool = False) -> Dict:
    """A configuration file's ``detector`` object as the keyword arguments
    of the port's ``DetectorConfig`` (``reference``: of the reference's
    copy), its ``mtcnn`` object made that package's ``MTCNNConfig`` and
    lists made tuples."""
    if reference:
        from benchmark.reference.config import MTCNNConfig
    else:
        from truely_tpu_torch.config import MTCNNConfig

    def tup(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    kw = tup({k: v for k, v in detector.items() if k != "mtcnn"})
    kw["mtcnn"] = MTCNNConfig(**tup(detector["mtcnn"]))
    return kw


def detector(config: Mapping, trees, device, mesh):
    from truely_tpu_torch.config import DetectorConfig
    from truely_tpu_torch.pipeline.detector import Detector

    return Detector(DetectorConfig(**detector_kwargs(config["detector"])), params=trees,
                    device=device, mesh=mesh)


def entry(program, config: Mapping):
    multi = config["detector"]["multi_face"]
    return program.analyze_i420_tracks if multi else program.analyze_i420


def reference(config: Mapping, trees, device, fps: int, rows: int):
    from benchmark.reference.config import DetectorConfig as RefConfig

    ref_cfg = RefConfig(**detector_kwargs(config["detector"], reference=True))
    built = ref.build_nets(trees, device)
    if config["detector"]["multi_face"]:
        return lambda frames: ref.analyze_tracks(built, frames, fps, ref_cfg, yuv=True,
                                                 device=device)
    return lambda frames: ref.analyze(built, frames, fps, ref_cfg, yuv=True, device=device,
                                      rows=rows)


def answer(result):
    """``analyze_i420_tracks``'s (score, per-track scores, state), or
    ``analyze_i420``'s ``VideoAnalysis``."""
    return tracks_of(result) if isinstance(result, tuple) else records_of(result)


def check(config: Mapping, got, want) -> Dict[str, float]:
    kind = "tracks" if config["detector"]["multi_face"] else "records"
    return numbers(kind, got, want)


def row_flops(detector: Mapping, h: int, w: int) -> Dict[str, int]:
    # Imported here: ``counts.nets`` loads ``torch.utils.flop_counter``, which a
    # ``--trace 0`` run, whose readers count no operations, then never loads.
    from benchmark.counts import nets

    return nets.row_flops(detector, h, w)


def step_forms(detector: Mapping, kind: str, rows: int, h: int, w: int):
    return kernels.step_forms(detector, kind, rows, h, w, yuv=True)
