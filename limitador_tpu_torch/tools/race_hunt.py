"""Sanitizer race hunts of the port's C++ host lanes.

Builds the standalone drivers ``csrc/race_hunt_hostpath.cc`` and
``csrc/race_hunt_h2i.cc`` (each ``#include``-s its library's
translation unit) under a sanitizer variant with ``native/build.py``
``build_tool``, runs each for ``RACE_HUNT_MS`` milliseconds, and reads
the verdict: the exit code, the sanitizer's report markers in the output,
the driver's ``RACE_HUNT_OK`` line and, for the host lane, the call count
of every export in ``HOSTPATH_EXPORTS`` and the rows the begins split
foreign (each must be above 0, or the hunt never drove that code).

Counterpart of the JAX package's ``tests/test_race_hunt.py`` harness;
``tests/test_torch_race_hunt.py`` (slow tier) and ``chip_smoke.py``
phase 21 both run it.
"""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import time
from typing import Dict, List, Tuple

from ..native import build as host_build

__all__ = [
    "HUNTS", "HOSTPATH_EXPORTS", "REPORT_MARKERS", "HuntResult", "hunt",
]

#: (driver, variant) in the order they run: tsan on both drivers, asan
#: and ubsan on the host lane (the ingress's io thread is covered by
#: tsan; the JAX hunt runs the same set)
HUNTS: Tuple[Tuple[str, str], ...] = (
    ("hostpath", "tsan"),
    ("h2i", "tsan"),
    ("hostpath", "asan"),
    ("hostpath", "ubsan"),
)

#: the host-lane exports the hostpath driver counts (its kExportNames):
#: the pod ownership mirror, the plan export and invalidation, the
#: buffer begin, the interner and slot map, and the port's
#: hp_tel_enabled
HOSTPATH_EXPORTS = (
    "hp_pod_config", "hp_pod_owner", "hp_pod_hash", "hp_plan_set_owner",
    "hp_plan_stamp_owner", "hp_plan_export", "hp_plan_invalidate_slot",
    "hp_hot_begin_buf", "hp_intern", "hp_slots_insert", "hp_slots_lookup",
    "hp_slots_remove", "hp_tel_enabled",
)

#: substrings whose presence in a driver's output means a sanitizer
#: reported: checked besides the exit code, so that a runtime which
#: exits 0 after a report still fails the hunt
REPORT_MARKERS = (
    "WARNING: ThreadSanitizer",
    "ERROR: AddressSanitizer",
    "ERROR: LeakSanitizer",
    "runtime error:",
)

_OK_LINE = re.compile(r"^RACE_HUNT_OK (.*)$", re.MULTILINE)


@dataclasses.dataclass
class HuntResult:
    driver: str
    variant: str
    build_s: float
    run_s: float
    returncode: int
    output: str
    #: ops (hostpath: serving batches) or reqs (h2i: requests taken)
    operations: int = 0
    foreign_rows: int = 0
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    def failures(self) -> List[str]:
        """Why this hunt failed; empty when it ran clean and drove every
        counted export."""
        out = []
        if self.returncode != 0:
            out.append(f"exit code {self.returncode}")
        out += [f"sanitizer report ({marker})"
                for marker in REPORT_MARKERS if marker in self.output]
        if _OK_LINE.search(self.output) is None:
            out.append("no RACE_HUNT_OK line")
        if self.driver == "hostpath":
            out += [f"{name} never called" for name in HOSTPATH_EXPORTS
                    if self.calls.get(name, 0) <= 0]
            if self.foreign_rows <= 0:
                out.append("no begin split a foreign row")
        return out

    def summary(self) -> dict:
        return {
            "driver": self.driver, "variant": self.variant,
            "build_s": round(self.build_s, 3), "run_s": round(self.run_s, 3),
            "operations": self.operations,
            "foreign_rows": self.foreign_rows, "calls": self.calls,
            "failures": self.failures(),
        }


def _parse(result: HuntResult) -> None:
    match = _OK_LINE.search(result.output)
    if match is None:
        return
    for field in match.group(1).split():
        key, _sep, value = field.partition("=")
        if key in ("ops", "reqs"):
            result.operations = int(value)
        elif key == "foreign_rows":
            result.foreign_rows = int(value)
        elif key == "calls":
            for item in value.split(","):
                name, _sep, count = item.partition(":")
                result.calls[name] = int(count)


def hunt(driver: str, variant: str, run_ms: int = 2000,
         timeout: float = 180.0) -> HuntResult:
    """Build one driver under one variant and run it. A failed build
    raises ``BuildError``; a sanitizer report or a missing export shows
    in ``failures()``."""
    sources = host_build.RACE_HUNT_SOURCES[driver]
    info: dict = {}
    path = host_build.build_tool(f"race_hunt_{driver}", sources,
                                 variant=variant, info=info)
    env = dict(os.environ)
    env["RACE_HUNT_MS"] = str(int(run_ms))
    # exitcode makes any report fail the process without halt_on_error;
    # leak detection is off for asan (the worker pool and its contexts
    # are left to the exit by design: an atexit join would deadlock)
    env["TSAN_OPTIONS"] = "exitcode=66"
    env["ASAN_OPTIONS"] = "detect_leaks=0"
    t0 = time.perf_counter()
    proc = subprocess.run([str(path)], capture_output=True, text=True,
                          timeout=timeout, env=env)
    result = HuntResult(
        driver, variant, float(info.get("seconds", 0.0)),
        time.perf_counter() - t0, proc.returncode,
        proc.stdout + proc.stderr,
    )
    _parse(result)
    return result
