"""Build the package's host C++ with the system compiler at first use and
load it with ctypes (the counterpart of the JAX package's setuptools
extensions, ``native/setup.py``).

Three libraries, each from one ``csrc/<name>.cpp`` with a plain C
interface and no Python headers:

- ``framepack``: frame packing, the exact I420->BGR conversion, box
  drawing and the channel swap (``media/native.py``); needs only the
  compiler, so a failed build always raises;
- ``videodec``: libav demux and decode to packed I420 (``media/videodec.py``);
- ``videoenc``: the libx264 H.264 MP4 writer (``media/videoenc.py``).

The last two need the libav development headers.  They are looked for as
``native/setup.py`` looks for them; where they are absent the library is
unavailable (``load`` returns None, ``status`` says why) and the readers
and writers take cv2, as the JAX package does without its extensions.
Where the headers are present and a build fails, ``load`` raises with the
compiler's output.

Flags: ``-O3 -march=native -std=c++17 -fPIC -shared``.  The libraries go to
the git-ignored ``truely_tpu_torch/_build/``, named by a hash of the
source, the flags, the linked libraries and the host's CPU model; each is
compiled under a temporary name and moved into place with ``os.replace``,
so processes that build at once never load a half-written file.  The same
build cache serves the CUDA kernels (``ops/cuda_build.py``).  A foreign
call through ctypes releases the GIL, as the JAX extensions do around
their loops.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-Wall")
SOURCES = ("framepack", "videodec", "videoenc")
# name -> (headers it needs, libraries it links), as native/setup.py links
LIBAV = {
    "videodec": (("libavcodec/avcodec.h",), ("avformat", "avcodec", "avutil")),
    "videoenc": (("libavcodec/avcodec.h", "libswscale/swscale.h"),
                 ("avformat", "avcodec", "avutil", "swscale")),
}
INCLUDE_ROOTS = ("/usr/include/x86_64-linux-gnu", "/usr/include")

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}
_status: Dict[str, str] = {}


# ---------------------------------------------------------------------------
# The build cache, shared with ops/cuda_build.py
# ---------------------------------------------------------------------------


def library_path(name: str, files: Sequence[Path], flags: Sequence[str]) -> Path:
    """``_build/<name>-<hash>.so``: the hash covers every file's bytes and
    the flags, so a changed source or flag builds anew."""
    h = hashlib.sha256()
    for f in files:
        h.update(Path(f).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def compile_all(jobs: Dict[str, Tuple[Path, Callable[[Path], List[str]]]],
                compiler: str) -> Dict[str, str]:
    """Build each library of ``jobs`` (name -> (target, the command that
    writes a given output path)) whose target is missing, all compilers
    started together.  Each writes a temporary file that ``os.replace``
    moves into place.  Returns name -> the compiler's output of the builds
    made; raises with the output of every failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (target, command) in jobs.items():
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        procs[name] = (subprocess.Popen(command(tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} ---\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)  # atomic: a reader never sees half a library
        logs[name] = out
    if failed:
        raise RuntimeError(f"{compiler} failed:\n" + "\n".join(failed))
    return logs


# ---------------------------------------------------------------------------
# The host libraries
# ---------------------------------------------------------------------------


def compiler() -> str:
    """The system C++ compiler: ``$CXX``, else g++, else c++."""
    found = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler found: set CXX or put g++ on PATH")
    return found


def _cpu_model() -> str:
    """The host's CPU model, part of the hash because of -march=native."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def missing_headers(name: str) -> List[str]:
    """The libav headers ``name`` needs that are found under no include
    root (empty for framepack)."""
    headers = LIBAV.get(name, ((), ()))[0]
    return [h for h in headers
            if not any(os.path.exists(os.path.join(root, h)) for root in INCLUDE_ROOTS)]


def _target(name: str) -> Tuple[Path, List[str]]:
    libs = [f"-l{lib}" for lib in LIBAV.get(name, ((), ()))[1]]
    return library_path(name, [CSRC / f"{name}.cpp"],
                        [*CXX_FLAGS, *libs, _cpu_model()]), libs


def load(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library of ``csrc/<name>.cpp``, built on first use; None
    where it needs libav headers that are absent (``status`` says which).
    Raises with the compiler's output if the build fails."""
    with _lock:
        if name in _libs:
            return _libs[name]
        missing = missing_headers(name)
        if missing:
            _status[name] = (f"unavailable: libav headers not found ({', '.join(missing)} "
                             f"under {' or '.join(INCLUDE_ROOTS)})")
            _libs[name] = None
            return None
        target, libs = _target(name)
        if not target.exists():
            cxx = compiler()
            compile_all({name: (target, lambda tmp: [
                cxx, *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp"), *libs])}, cxx)
        _libs[name] = ctypes.CDLL(str(target))
        _status[name] = f"built: {target.name}"
        return _libs[name]


def status() -> Dict[str, str]:
    """Each host library's state: built (with its file), unavailable and
    why, or not loaded yet."""
    with _lock:
        return {name: _status.get(name, "not loaded yet") for name in SOURCES}


def bind(lib: ctypes.CDLL, symbol: str, argtypes, restype=ctypes.c_int):
    """``lib.symbol`` with its argument and result types set."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn
