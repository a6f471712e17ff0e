"""libav demux and decode to packed I420 (``csrc/videodec.cpp``), with the
module interface of the JAX package's ``videodec`` extension:

    handle, width, height, fps_num, fps_den, nb_frames = open(path)
    read(handle, dst)   # -> True, or False at the end; dst (H*3//2, W) uint8
    skip(handle)        # decode the next frame without exporting it
    pixfmt(handle), codec(handle), colorinfo(handle), close(handle)

``available()`` says whether the library could be built here (it needs
the libav headers, ``media/host_build.py``).  A handle that is closed, or
garbage-collected, frees its decoder; calls on a closed handle raise
ValueError.  Errors of libav raise IOError, as the extension's do.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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
        lib = host_build.load("videodec")
        if lib is None:
            return None
        host_build.bind(lib, "tt_vd_open", [_S, _I, _P, _P, _P, _I], _P)
        host_build.bind(lib, "tt_vd_read", [_P, _P, _L, _P, _I])
        host_build.bind(lib, "tt_vd_skip", [_P, _P, _I])
        for sym in ("tt_vd_pixfmt", "tt_vd_codec", "tt_vd_colorspace", "tt_vd_colorrange"):
            host_build.bind(lib, sym, [_P], _S)
        host_build.bind(lib, "tt_vd_close", [_P], None)
        host_build.bind(lib, "tt_vd_avcodec_version", [], ctypes.c_uint)
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the decoder library is built (or can be, on first use)."""
    return _load() is not None


def avcodec_version() -> Optional[str]:
    """The linked libavcodec's version as "major.minor.micro", or None."""
    lib = _load()
    if lib is None:
        return None
    v = lib.tt_vd_avcodec_version()
    return f"{v >> 16}.{(v >> 8) & 0xFF}.{v & 0xFF}"


class Handle:
    """An open decoder.  Freed by :func:`close` or when collected."""

    def __init__(self, ptr: int):
        self._ptr: Optional[int] = ptr

    def ptr(self) -> int:
        if self._ptr is None:
            raise ValueError("invalid or closed decoder handle")
        return self._ptr

    def close(self) -> None:
        ptr, self._ptr = self._ptr, None
        if ptr is not None:
            _lib.tt_vd_close(ptr)

    def __del__(self):
        if getattr(self, "_ptr", None) is not None and _lib is not None:
            self.close()


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("videodec is not built: " + host_build.status()["videodec"])
    return lib


def open(path: str, skip_nonref: int = 0) -> Tuple[Handle, int, int, int, int, int]:
    """Open the best video stream of ``path``.  Returns (handle, width,
    height, fps_num, fps_den, nb_frames)."""
    lib = _require()
    info = (ctypes.c_int * 4)()
    nb = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_LEN)
    ptr = lib.tt_vd_open(path.encode(), int(skip_nonref), info, ctypes.byref(nb), err, _ERR_LEN)
    if not ptr:
        raise IOError(err.value.decode(errors="replace"))
    return (Handle(ptr), info[0], info[1], info[2], info[3], nb.value)


def read(handle: Handle, dst: np.ndarray) -> bool:
    """Decode the next frame into ``dst``, a writable C-contiguous uint8
    buffer of at least W*H*3/2 bytes (Y rows, then U, then V).  False at the
    end of the stream; raises ValueError for a stream that is not 8-bit
    yuv420p or a ``dst`` too small."""
    if dst.dtype != np.uint8 or not dst.flags["C_CONTIGUOUS"] or not dst.flags["WRITEABLE"]:
        raise TypeError("dst must be a writable contiguous uint8 buffer")
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = _lib.tt_vd_read(handle.ptr(), dst.ctypes.data, dst.nbytes, err, _ERR_LEN)
    if rc < 0:
        msg = err.value.decode(errors="replace")
        raise (IOError if "decode error" in msg else ValueError)(msg)
    return rc == 1


def skip(handle: Handle) -> bool:
    """Decode the next frame without exporting its planes.  False at the
    end of the stream."""
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = _lib.tt_vd_skip(handle.ptr(), err, _ERR_LEN)
    if rc < 0:
        raise IOError(err.value.decode(errors="replace"))
    return rc == 1


def pixfmt(handle: Handle) -> str:
    return _lib.tt_vd_pixfmt(handle.ptr()).decode()


def codec(handle: Handle) -> str:
    """The stream's codec name, e.g. "h264" (this module's addition to
    the extension's interface)."""
    return _lib.tt_vd_codec(handle.ptr()).decode()


def colorinfo(handle: Handle) -> Tuple[str, str]:
    """(colour space, colour range) tag names, e.g. ("unknown", "tv")."""
    ptr = handle.ptr()
    return _lib.tt_vd_colorspace(ptr).decode(), _lib.tt_vd_colorrange(ptr).decode()


def close(handle: Handle) -> None:
    handle.close()
