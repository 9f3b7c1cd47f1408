"""Build and load the port's C++ host libraries.

Counterpart of ``limitador_tpu/native/build.py`` for the two libraries
the port needs, each compiled with ``g++ -std=c++17 -O2 -shared -fPIC
-pthread`` the first time it is asked for and loaded with ``ctypes``:

* ``library()``: the host lane, ``limitador_tpu_torch/csrc/hostpath.cc``
  (the port's own copy of ``native/hostpath.cc``);
* ``ingress_library()``: the HTTP/2 ingress,
  ``limitador_tpu_torch/csrc/h2ingress.cc`` with the HPACK tables it
  includes, ``csrc/h2_hpack_tables.h`` (the port's own copies of
  ``native/h2ingress.cc`` and ``native/h2_hpack_tables.h``).

Importing this module builds nothing. Each library lands in
``limitador_tpu_torch/_build/`` (ignored by git) under a name keyed on
the sha256 of every file it is built from and the flags, as
``ops/build.py`` keys the CUDA kernels: an edited source or header
builds anew, an unchanged one loads the file already there. A missing
compiler or a failed build raises ``BuildError``; nothing falls back.
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
from typing import Sequence

from ..ops.build import BuildError

__all__ = [
    "BuildError", "library", "loaded", "build", "build_info", "build_status",
    "SOURCE", "INGRESS_SOURCES", "ingress_library", "ingress_loaded",
    "ingress_build_info",
]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "hostpath.cc"
#: the ingress's translation unit first, then the header it includes
INGRESS_SOURCES = (_PKG / "csrc" / "h2ingress.cc",
                   _PKG / "csrc" / "h2_hpack_tables.h")
BUILD_DIR = _PKG / "_build"
FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-pthread")

#: what the last host-lane build or load did: path, seconds, built
build_info: dict = {}
#: the same for the ingress
ingress_build_info: dict = {}

_lock = threading.Lock()
_lib = None
_build_error = None
_ingress_lock = threading.Lock()
_ingress_lib = None
_ingress_error = None


def _compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise BuildError(
            "g++ not found; the port's C++ host libraries cannot be built"
        )
    return found


def source_key(*sources: Path) -> str:
    """sha256 over every file a library is built from, then the flags."""
    digest = hashlib.sha256()
    for source in sources:
        digest.update(Path(source).read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return digest.hexdigest()[:16]


def _build(name: str, sources: Sequence[Path], info: dict) -> Path:
    """Compile ``sources[0]`` (the others are the headers it includes)
    into ``lib<name>-<key>.so`` unless that file exists; returns its
    path and records what happened in ``info``."""
    try:
        key = source_key(*sources)
    except OSError as exc:
        raise BuildError(f"{name} source unreadable: {exc}") from exc
    target = BUILD_DIR / f"lib{name}-{key}.so"
    if target.exists():
        info.update(path=str(target), seconds=0.0, built=False)
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *FLAGS, "-o", str(tmp), str(sources[0])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(
            f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)
    info.update(path=str(target), seconds=seconds, built=True)
    return target


def build(source: Path = None) -> Path:
    """Compile the host lane unless a library for this source key exists;
    returns its path."""
    return _build("hostpath", [Path(source or SOURCE)], build_info)


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
    """The host lane when it is already loaded, else None (builds
    nothing)."""
    return _lib


def ingress_library() -> ctypes.CDLL:
    """The loaded ingress library, built at first use. The caller binds
    the signatures (``native/ingress.py``)."""
    global _ingress_lib, _ingress_error
    with _ingress_lock:
        if _ingress_lib is None:
            try:
                _ingress_lib = ctypes.CDLL(str(_build(
                    "h2ingress", INGRESS_SOURCES, ingress_build_info)))
            except (BuildError, OSError) as exc:
                _ingress_error = str(exc)
                raise
            _ingress_error = None
        return _ingress_lib


def ingress_loaded():
    """The ingress library when it is already loaded, else None (builds
    nothing)."""
    return _ingress_lib


def build_status() -> dict:
    """The host libraries' load state for ``GET /debug/stats``
    (``native_build``, the JAX package's per-library shape; this port has
    no sanitizer builds). The ingress appears once it was asked for;
    reporting builds nothing."""
    out = {
        "hostpath": {
            "attempted": _lib is not None or _build_error is not None,
            "loaded": _lib is not None,
            "build_error": _build_error,
            "sanitizer": None,
        },
    }
    if _ingress_lib is not None or _ingress_error is not None:
        out["h2ingress"] = {
            "attempted": True,
            "loaded": _ingress_lib is not None,
            "build_error": _ingress_error,
            "sanitizer": None,
        }
    return out
