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

Sanitizer variants, as in ``limitador_tpu/native/build.py``:
``SANITIZER_FLAGS`` (tsan, asan, ubsan) replace ``-O2``. A process with
``TPU_NATIVE_SANITIZE`` set (``sanitizer_variant()``) builds both
libraries instrumented, under their own key, and ``build_status()``
reports the variant; loading one into a plain CPython needs the runtime
preloaded (``LD_PRELOAD=libtsan.so``). The race hunts therefore build
standalone executables instead: ``build_tool()`` compiles a driver
(``csrc/race_hunt_hostpath.cc``, ``csrc/race_hunt_h2i.cc``, each
``#include``-ing its library's translation unit) into the same build
directory, and ``sanitizer_probe()`` says whether this machine's g++ can
link a variant's runtime at all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..ops.build import BuildError

__all__ = [
    "BuildError", "library", "loaded", "build", "build_info", "build_status",
    "SOURCE", "INGRESS_SOURCES", "ingress_library", "ingress_loaded",
    "ingress_build_info", "set_build_dir",
    "SANITIZER_FLAGS", "sanitizer_variant", "sanitizer_probe", "build_tool",
    "RACE_HUNT_SOURCES",
]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "hostpath.cc"
#: the ingress's translation unit first, then the header it includes
INGRESS_SOURCES = (_PKG / "csrc" / "h2ingress.cc",
                   _PKG / "csrc" / "h2_hpack_tables.h")
BUILD_DIR = _PKG / "_build"
FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-pthread")

#: variant -> compile flags replacing ``-O2`` (the JAX package's): -O1
#: keeps the instrumented binaries debuggable and fast enough for the
#: race-hunt drives; frame pointers keep the reports readable
SANITIZER_FLAGS: Dict[str, List[str]] = {
    "tsan": ["-fsanitize=thread", "-O1", "-g", "-fno-omit-frame-pointer"],
    "asan": ["-fsanitize=address", "-O1", "-g", "-fno-omit-frame-pointer"],
    "ubsan": ["-fsanitize=undefined", "-fno-sanitize-recover=undefined",
              "-O1", "-g"],
}

#: race-hunt driver -> its translation unit first, then the files it
#: includes (they fold into the build key)
RACE_HUNT_SOURCES = {
    "hostpath": (_PKG / "csrc" / "race_hunt_hostpath.cc", SOURCE),
    "h2i": (_PKG / "csrc" / "race_hunt_h2i.cc", *INGRESS_SOURCES),
}

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


def sanitizer_variant() -> Optional[str]:
    """The process-wide sanitizer variant from ``TPU_NATIVE_SANITIZE``
    (tsan, asan or ubsan; empty, unset or unknown -> None): the host
    libraries built from now on are instrumented with it."""
    raw = os.environ.get("TPU_NATIVE_SANITIZE", "").strip().lower()
    return raw if raw in SANITIZER_FLAGS else None


def _flags(base: Sequence[str], variant: Optional[str]) -> List[str]:
    """``base`` with ``-O2`` replaced by a variant's sanitizer flags."""
    if variant is None:
        return list(base)
    out: List[str] = []
    for flag in base:
        out.extend(SANITIZER_FLAGS[variant] if flag == "-O2" else [flag])
    return out


def source_key(*sources: Path, flags: Sequence[str] = FLAGS) -> str:
    """sha256 over every file a library is built from, then the flags."""
    digest = hashlib.sha256()
    for source in sources:
        digest.update(Path(source).read_bytes())
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:16]


def set_build_dir(path) -> None:
    """Build into, and load from, ``path`` from now on (the server's
    ``--kernel-cache-dir``, set before any build)."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def _compile(target: Path, sources: Sequence[Path], flags: Sequence[str],
             info: dict) -> Path:
    """Compile ``sources[0]`` into ``target`` unless that file exists;
    returns its path and records what happened in ``info``."""
    if target.exists():
        info.update(path=str(target), seconds=0.0, built=False)
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_compiler(), *flags, "-o", str(tmp), str(sources[0])]
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


def _build(name: str, sources: Sequence[Path], info: dict) -> Path:
    """Compile a library into ``lib<name>[.<variant>]-<key>.so`` (the
    variant of ``sanitizer_variant()``); returns its path and records
    what happened, the variant included, in ``info``."""
    variant = sanitizer_variant()
    flags = _flags(FLAGS, variant)
    try:
        key = source_key(*sources, flags=flags)
    except OSError as exc:
        raise BuildError(f"{name} source unreadable: {exc}") from exc
    suffix = f".{variant}" if variant else ""
    info["sanitizer"] = variant
    return _compile(BUILD_DIR / f"lib{name}{suffix}-{key}.so", sources,
                    flags, info)


def sanitizer_probe(variant: str) -> Optional[str]:
    """None when this machine's g++ builds and links a two-line program
    under ``variant``; else why not (the compiler's last words). Builds
    into a temporary directory of its own."""
    try:
        cxx = _compiler()
    except BuildError as exc:
        return str(exc)
    with tempfile.TemporaryDirectory(prefix="sanitizer-probe-") as tmp:
        src = Path(tmp) / "probe.cc"
        src.write_text("#include <thread>\n"
                       "int main() { std::thread([] {}).join(); }\n")
        cmd = [cxx, "-std=c++17", *SANITIZER_FLAGS[variant], "-pthread",
               "-o", str(Path(tmp) / "probe"), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            return (proc.stderr or proc.stdout).strip()[-600:]
        run = subprocess.run([str(Path(tmp) / "probe")],
                             capture_output=True, text=True)
        if run.returncode != 0:
            return f"probe exited {run.returncode}: {run.stderr[-600:]}"
    return None


def build_tool(name: str, sources: Sequence[Path],
               extra_flags: Sequence[str] = ("-pthread",),
               variant: Optional[str] = None,
               info: Optional[dict] = None) -> Path:
    """Compile an executable (a race-hunt driver) from ``sources[0]``
    (the others fold into the key: the files it includes) with a
    sanitizer variant's flags (``-O2`` without one), into
    ``<name>[.<variant>]-<key>`` in the build directory; returns its
    path. A failed build raises ``BuildError``."""
    if variant is not None and variant not in SANITIZER_FLAGS:
        raise BuildError(f"no sanitizer variant {variant!r}")
    flags = ["-std=c++17", *_flags(["-O2"], variant), *extra_flags]
    sources = [Path(s) for s in sources]
    try:
        key = source_key(*sources, flags=flags)
    except OSError as exc:
        raise BuildError(f"{name} source unreadable: {exc}") from exc
    suffix = f".{variant}" if variant else ""
    return _compile(BUILD_DIR / f"{name}{suffix}-{key}", sources, flags,
                    {} if info is None else info)


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
    (``native_build``, the JAX package's per-library shape, with the
    sanitizer variant a library was built with, None for the plain
    build). The ingress appears once it was asked for; reporting builds
    nothing."""
    out = {
        "hostpath": {
            "attempted": _lib is not None or _build_error is not None,
            "loaded": _lib is not None,
            "build_error": _build_error,
            "sanitizer": build_info.get("sanitizer"),
        },
    }
    if _ingress_lib is not None or _ingress_error is not None:
        out["h2ingress"] = {
            "attempted": True,
            "loaded": _ingress_lib is not None,
            "build_error": _ingress_error,
            "sanitizer": ingress_build_info.get("sanitizer"),
        }
    return out
