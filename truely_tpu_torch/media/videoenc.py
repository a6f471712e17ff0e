"""libx264 H.264 MP4 writer (``csrc/videoenc.cpp``), with the module
interface of the JAX package's ``videoenc`` extension:

    handle = open(path, width, height, fps_num, fps_den, preset="ultrafast",
                  crf=23, threads=0, slices=0)
    write(handle, frame)        # (H, W, 3) uint8 BGR, through swscale
    write_i420(handle, packed)  # (H*3//2, W) uint8 I420, no conversion
    close(handle)               # flush and write the MP4 trailer

``available()`` says whether the library could be built here (it needs
the libav headers, ``media/host_build.py``); ``has_x264()`` whether the
linked libavcodec can encode H.264.  Bad arguments raise ValueError,
errors of libav IOError, as the extension's do.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from truely_tpu_torch.media import host_build

_P, _I, _L, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_char_p
_ERR_LEN = 512
_lib = None


def _load():
    """The bound library, or None where it cannot be built (no libav
    headers)."""
    global _lib
    if _lib is None:
        lib = host_build.load("videoenc")
        if lib is None:
            return None
        host_build.bind(lib, "tt_ve_open", [_S, _I, _I, _I, _I, _S, _I, _I, _I, _P, _I], _P)
        host_build.bind(lib, "tt_ve_write", [_P, _P, _L, _P, _I])
        host_build.bind(lib, "tt_ve_write_i420", [_P, _P, _L, _P, _I])
        host_build.bind(lib, "tt_ve_close", [_P, _P, _I])
        host_build.bind(lib, "tt_ve_has_x264", [])
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the writer library is built (or can be, on first use)."""
    return _load() is not None


def has_x264() -> bool:
    lib = _load()
    return lib is not None and bool(lib.tt_ve_has_x264())


class Handle:
    """An open writer of (height, width) frames.  :func:`close` finishes
    the file; a handle collected unclosed is closed then."""

    def __init__(self, ptr: int, width: int, height: int):
        self._ptr: Optional[int] = ptr
        self.width, self.height = width, height

    def ptr(self) -> int:
        if self._ptr is None:
            raise ValueError("videoenc: writer already closed")
        return self._ptr

    def __del__(self):
        if getattr(self, "_ptr", None) is not None and _lib is not None:
            close(self)


def _call(fn, *args) -> None:
    err = ctypes.create_string_buffer(_ERR_LEN)
    if fn(*args, err, _ERR_LEN) != 0:
        msg = err.value.decode(errors="replace")
        raise (ValueError if "bytes" in msg else IOError)(msg)


def open(path: str, width: int, height: int, fps_num: int, fps_den: int,
         preset: str = "ultrafast", crf: int = 23, threads: int = 0, slices: int = 0) -> Handle:
    lib = _load()
    if lib is None:
        raise RuntimeError("videoenc is not built: " + host_build.status()["videoenc"])
    if width <= 0 or height <= 0 or width % 2 or height % 2 or fps_num <= 0 or fps_den <= 0:
        raise ValueError("videoenc: even positive dims and positive fps required")
    if not 0 <= crf <= 51 or threads < 0 or slices < 0:
        raise ValueError("videoenc: crf in [0,51], threads/slices >= 0")
    err = ctypes.create_string_buffer(_ERR_LEN)
    ptr = lib.tt_ve_open(path.encode(), width, height, fps_num, fps_den, preset.encode(),
                         int(crf), int(threads), int(slices), err, _ERR_LEN)
    if not ptr:
        raise IOError(err.value.decode(errors="replace"))
    return Handle(ptr, width, height)


def write(handle: Handle, frame: np.ndarray) -> None:
    """Encode one (H, W, 3) uint8 BGR frame."""
    if frame.shape != (handle.height, handle.width, 3) or frame.dtype != np.uint8:
        raise ValueError(f"videoenc: frame {frame.shape} {frame.dtype}, want "
                         f"({handle.height}, {handle.width}, 3) uint8")
    frame = np.ascontiguousarray(frame)
    _call(_lib.tt_ve_write, handle.ptr(), frame.ctypes.data, frame.nbytes)


def write_i420(handle: Handle, packed: np.ndarray) -> None:
    """Encode one packed (H*3//2, W) uint8 I420 picture, planes copied
    straight into the encoder's frame."""
    want = (handle.height * 3 // 2, handle.width)
    if packed.shape != want or packed.dtype != np.uint8:
        raise ValueError(f"videoenc: I420 picture shape {packed.shape} {packed.dtype} != "
                         f"{want} uint8")
    packed = np.ascontiguousarray(packed)
    _call(_lib.tt_ve_write_i420, handle.ptr(), packed.ctypes.data, packed.nbytes)


def close(handle: Handle) -> None:
    """Flush, write the trailer and free the writer; a second close does
    nothing."""
    ptr, handle._ptr = handle._ptr, None
    if ptr is not None:
        _call(_lib.tt_ve_close, ptr)
