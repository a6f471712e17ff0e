"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so
``nvcc`` builds it in seconds; the sources compile in parallel, one
process each.  The libraries go to ``truely_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, the shared header and the
flags, so a changed source rebuilds and an unchanged one is reused: the
build cache of ``media/host_build.py``, which builds the host C++.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so no multiply and
add fuse into an FMA: the kernels must be bit-equal to their plain PyTorch
versions, which round after every operation.  No ``--use_fast_math``:
division stays IEEE round-to-nearest.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

import torch

from truely_tpu_torch.media.host_build import compile_all, library_path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("yuv", "nms", "crop_area", "crop_bilinear", "crop_area_fused", "tracks",
           "crop_classifier")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output (the ptxas report) of builds made by this process
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _target(name: str) -> Path:
    return library_path(name, (CSRC / f"{name}.cu", CSRC / "common.cuh"), NVCC_FLAGS)


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source whose library is missing, all in
    parallel.  Raises with nvcc's output if any build fails."""
    jobs = {}
    nvcc = None
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        nvcc = nvcc or _nvcc()
        jobs[name] = (target, lambda tmp, name=name: [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                                                      str(CSRC / f"{name}.cu")])
    build_log.update(compile_all(jobs, "nvcc"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            lib.tt_error_string.argtypes = [ctypes.c_int]
            lib.tt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


P = ctypes.c_void_p  # a device pointer (tensor.data_ptr()) or a stream
I = ctypes.c_int

# (library, symbol) -> the ctypes function with its argtypes and restype set,
# so a launch neither looks the symbol up nor rebuilds ctypes' converters.
_fns: Dict[Tuple[str, str], Callable[..., int]] = {}
# The raw cudaStream_t of a device's current stream, read without building a
# torch.cuda.Stream object per call (PyTorch's own Triton launcher reads it
# so); a build of PyTorch without the binding reads the Stream object.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)
# The current device's index, without torch.cuda.current_device()'s lazy
# initialisation check (a tensor on the card means CUDA is initialised).
_current_device = getattr(torch._C, "_cuda_getDevice", None) or torch.cuda.current_device


def launch(name: str, symbol: str, argtypes, *args, device) -> None:
    """Call ``symbol`` of ``csrc/<name>.cu`` with ``args`` and the current
    stream of ``device`` appended, and raise if the launch failed (the C
    side returns ``cudaGetLastError()`` right after the launch).  The
    symbol is resolved, and its ``argtypes`` (plus the stream) and int
    return set, once per process.  A device guard is entered only when
    ``device`` is not the current device."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = [*argtypes, P]
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    current = _current_device()
    index = current if device.index is None else device.index
    if index == current:
        code = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*args, _raw_stream(index))
    if code != 0:
        raise RuntimeError(f"{symbol}: CUDA error {code}: {load(name).tt_error_string(code).decode()}")


def require_cuda(what: str, *tensors) -> None:
    """Raise unless every tensor lies on one CUDA device: a kernel takes
    raw device pointers, so a tensor elsewhere would be read as garbage."""
    first = tensors[0]
    if not first.is_cuda or any(t is not None and t.device != first.device for t in tensors[1:]):
        raise ValueError(f"{what}: the kernel needs tensors on one CUDA device, got "
                         f"{[None if t is None else str(t.device) for t in tensors]}")
