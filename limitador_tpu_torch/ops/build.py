"""Build and load the port's CUDA kernels.

The JAX package leaves compilation to XLA (``jax.jit`` in
``limitador_tpu/ops/kernel.py``); the port compiles its hand-written
kernels itself. ``library()`` runs ``nvcc`` for ``sm_90a`` on
``limitador_tpu_torch/csrc/counter_table.cu`` into a shared library with a
plain C interface, the first time a kernel is launched, and loads it with
``ctypes``. The source includes no PyTorch header, so the build takes
seconds.

The library lands in ``limitador_tpu_torch/_build/`` (ignored by git)
under a name keyed on the sha256 of the source and the flags: an edited
source builds anew, an unchanged one loads the file already there. A
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

__all__ = [
    "BuildError", "library", "build", "check", "build_info", "build_status",
    "set_build_dir",
]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "counter_table.cu",)
BUILD_DIR = _PKG / "_build"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ct_check_workspace_bytes": (_I, [_I]),
    "ct_update_workspace_bytes": (_I, [_I]),
    "ct_check_and_update": (
        _I, [_P] * 10 + [_I, _I, _I] + [_P] * 6,
    ),
    "ct_check_and_update_cluster": (
        _I, [_P] * 10 + [_I, _I, _I] + [_P] * 5,
    ),
    "ct_update": (_I, [_P] * 8 + [_I, _I, _I] + [_P] * 2),
    "ct_check_and_update_replicated": (
        _I, [_P] * 12 + [_I, _I, _I] + [_P] * 6,
    ),
    "ct_check_and_update_replicated_cluster": (
        _I, [_P] * 12 + [_I, _I, _I] + [_P] * 5,
    ),
    "ct_update_replicated": (_I, [_P] * 9 + [_I, _I, _I] + [_P] * 2),
    "ct_apply_remote": (_I, [_P] * 5 + [_I, _P]),
    "ct_read_slots": (_I, [_P, _P, _P, _I, _I, _P, _P, _P]),
    "ct_clear_slots": (_I, [_P, _P, _P, _P, _I, _P]),
    "ct_rebase_expiry": (_I, [_P, _I, _I, _P]),
    "ct_rebase_epoch": (_I, [_P, _I, _P, _P]),
    "ct_seed_slots": (_I, [_P] * 6 + [_I, _I, _P]),
    "ct_credit": (_I, [_P] * 6 + [_I, _I, _I, _P]),
    "ct_topk_workspace_bytes": (ctypes.c_longlong, [_I, _I]),
    "ct_drain_top_hits": (_I, [_P, _I, _I, _P, _P, _P, _P]),
    "ct_error_string": (ctypes.c_char_p, [_I]),
    "ct_sharded_check_workspace_bytes": (ctypes.c_longlong, [_I, _I, _I]),
    "ct_sharded_coupled_capacity": (_I, [_I, _I]),
    "ct_sharded_check_and_update": (
        _I, [_P] * 11 + [_I] * 7 + [_P] * 6,
    ),
    "ct_sharded_check_and_update_cluster": (
        _I, [_P] * 11 + [_I] * 7 + [_P] * 5,
    ),
    "ct_sharded_update_workspace_bytes": (ctypes.c_longlong, [_I, _I]),
    "ct_sharded_update": (_I, [_P] * 8 + [_I] * 4 + [_P] * 2),
    "ct_sharded_clear": (_I, [_P] * 4 + [_I] * 3 + [_P]),
    "ct_sharded_topk_workspace_bytes": (ctypes.c_longlong, [_I] * 4),
    "ct_sharded_drain_top_hits": (_I, [_P] + [_I] * 4 + [_P] * 4),
    # host lists by value through a context bound once per table
    "ct_ctx_create": (_P, [_P, _P, _P, _I, _I, _P]),
    "ct_ctx_destroy": (None, [_P]),
    "ct_host_list_capacity": (_I, [_I]),
    "ct_sharded_clear_host": (_I, [_P, _P, _I, _I]),
    "ct_seed_slots_host": (_I, [_P] * 4 + [_I, _I]),
    "ct_ctx_results": (_P, [_P, _I]),
    "ct_read_slots_host": (_I, [_P, _P, _I, _I]),
    "ct_apply_remote_host": (_I, [_P] * 4 + [_I]),
    "ct_apply_remote_staged": (_I, [_P] * 4 + [_I]),
    "ct_clear_slots_host": (_I, [_P, _P, _I]),
    "ct_drain_top_hits_host": (_I, [_P, _I]),
    "ct_sharded_update_host": (_I, [_P, _P, _I, _I]),
    "ct_update_replicated_host": (_I, [_P, _P, _P, _I, _I]),
    "ct_update_host": (_I, [_P, _P, _I, _I]),
    "ct_credit_host": (_I, [_P, _P, _I, _I]),
}

#: what the last build or load did: path, seconds, ptxas resource lines
build_info: dict = {}

_lock = threading.Lock()
_lib = None
_build_error = None


class BuildError(RuntimeError):
    """nvcc is missing or refused the source."""


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise BuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels cannot be built"
    )


def source_key() -> str:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return digest.hexdigest()[:16]


def set_build_dir(path) -> None:
    """Build into, and load from, ``path`` from now on: the server's
    ``--kernel-cache-dir``, set before any build, so that a restarted
    process (a warm standby's among them) loads the library an earlier
    one built there instead of running ``nvcc`` again."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def build() -> Path:
    """Compile the kernels unless a library for this source key exists;
    returns its path. Records timing and ptxas output in build_info."""
    target = BUILD_DIR / f"libcounter_table-{source_key()}.so"
    if target.exists():
        build_info.update(path=str(target), seconds=0.0, built=False,
                          ptxas=[])
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)
    ptxas = [
        line.strip() for line in (proc.stdout + proc.stderr).splitlines()
        if "ptxas" in line
    ]
    build_info.update(path=str(target), seconds=seconds, built=True,
                      ptxas=ptxas)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use (later calls take no
    lock)."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (BuildError, OSError) as exc:
                _build_error = str(exc)
                raise
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def build_status() -> dict:
    """The kernel library's load state for ``GET /debug/stats``
    (``native_build``); reporting builds nothing."""
    return {
        "counter_table": {
            "attempted": _lib is not None or _build_error is not None,
            "loaded": _lib is not None,
            "build_error": _build_error,
            "sanitizer": None,
        },
    }


def check(rc: int, name: str) -> None:
    """Raise unless a launch returned cudaSuccess."""
    if rc != 0:
        message = library().ct_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {rc}: {message}")
