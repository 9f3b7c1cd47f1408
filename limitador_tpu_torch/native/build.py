"""Build and load the port's C++ host lane.

Counterpart of ``limitador_tpu/native/build.py`` for the one library the
port needs: ``library()`` compiles ``limitador_tpu_torch/csrc/hostpath.cc``
(the port's own copy of ``native/hostpath.cc``) with
``g++ -std=c++17 -O2 -shared -fPIC -pthread`` the first time it is asked
for, and loads it with ``ctypes``. Importing this module builds nothing.

The library lands in ``limitador_tpu_torch/_build/`` (ignored by git)
under a name keyed on the sha256 of the source and the flags, as
``ops/build.py`` keys the CUDA kernels: an edited source builds anew, an
unchanged one loads the file already there. A missing compiler or a
failed build raises ``BuildError``; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..ops.build import BuildError

__all__ = [
    "BuildError", "library", "loaded", "build", "build_info", "build_status",
    "SOURCE",
]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "hostpath.cc"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-pthread")

#: what the last build or load did: path, seconds, built
build_info: dict = {}

_lock = threading.Lock()
_lib = None
_build_error = None


def _compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise BuildError(
            "g++ not found; the port's C++ host lane cannot be built"
        )
    return found


def source_key(source: Path) -> str:
    digest = hashlib.sha256()
    digest.update(source.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return digest.hexdigest()[:16]


def build(source: Path = None) -> Path:
    """Compile the host lane unless a library for this source key exists;
    returns its path."""
    source = Path(source or SOURCE)
    try:
        key = source_key(source)
    except OSError as exc:
        raise BuildError(f"host lane source unreadable: {exc}") from exc
    target = BUILD_DIR / f"libhostpath-{key}.so"
    if target.exists():
        build_info.update(path=str(target), seconds=0.0, built=False)
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(
            f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)
    build_info.update(path=str(target), seconds=seconds, built=True)
    return target


def library() -> ctypes.CDLL:
    """The loaded host-lane library, built at first use. The caller binds
    the signatures (``native/__init__.py``)."""
    global _lib, _build_error
    with _lock:
        if _lib is None:
            try:
                _lib = ctypes.CDLL(str(build()))
            except (BuildError, OSError) as exc:
                _build_error = str(exc)
                raise
        return _lib


def loaded():
    """The library when it is already loaded, else None (builds
    nothing)."""
    return _lib


def build_status() -> dict:
    """The host lane's load state for ``GET /debug/stats``
    (``native_build``, the JAX package's per-library shape; this port has
    no sanitizer builds); reporting builds nothing."""
    return {
        "hostpath": {
            "attempted": _lib is not None or _build_error is not None,
            "loaded": _lib is not None,
            "build_error": _build_error,
            "sanitizer": None,
        },
    }
