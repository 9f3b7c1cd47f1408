"""Sanitizer race hunts of the port's C++ host lanes (slow tier).

Counterpart of ``tests/test_race_hunt.py``: builds the standalone
drivers ``csrc/race_hunt_hostpath.cc`` and ``csrc/race_hunt_h2i.cc``
(each ``#include``-s its library's translation unit) under TSAN, ASAN
and UBSAN with ``native/build.py`` ``build_tool``, runs each for 2 s
through ``tools/race_hunt.py``, and asserts a clean report: exit 0, no
sanitizer marker in the output, the driver's ``RACE_HUNT_OK`` line, and
for the host lane every export of ``race_hunt.HOSTPATH_EXPORTS`` (the
pod ownership mirror, the plan export and invalidation, the buffer
begin, the interner and slot map, ``hp_tel_enabled``) called at least
once, with foreign rows split by the begins.

A variant whose runtime this machine's g++ lacks is skipped with the
probe's reason. ``chip_smoke.py`` phase 21 runs the same hunts on the
card's machine. Run: ``pytest tests/test_torch_race_hunt.py -m slow``.
The tier-1 contract of the drivers (the lane-stats buffer length, the
declared variants, the counted exports) is
``tests/test_torch_race_hunt_contract.py``.
"""

import pytest

from limitador_tpu_torch.native import build as host_build
from limitador_tpu_torch.tools import race_hunt as RH

pytestmark = pytest.mark.slow


def _hunt(driver: str, variant: str) -> RH.HuntResult:
    missing = host_build.sanitizer_probe(variant)
    if missing is not None:
        pytest.skip(f"this g++ cannot build {variant}: {missing[:300]}")
    return RH.hunt(driver, variant, run_ms=2000)


@pytest.mark.parametrize("driver", ["hostpath", "h2i"])
def test_tsan_race_hunt_is_clean(driver):
    """Hot begins and finishes, lease traffic, context swaps, the pod
    mirror's re-arms and stamps, telemetry drains (hostpath); take,
    respond and coded respond against the io thread and a chaos client
    (h2i): zero ThreadSanitizer reports."""
    result = _hunt(driver, "tsan")
    assert result.failures() == [], result.output[-4000:]
    assert result.operations > 0


@pytest.mark.parametrize("variant", ["asan", "ubsan"])
def test_memory_and_ub_hunt_is_clean(variant):
    """The host-lane drive under ASAN and UBSAN: no heap or stack misuse
    (the JAX driver's lane-stats buffer overflow among them), no
    undefined behaviour under concurrency."""
    result = _hunt("hostpath", variant)
    assert result.failures() == [], result.output[-4000:]


def test_every_counted_export_is_called():
    """Each export the pod slices made live is driven, and the begins
    split foreign rows, in one tsan run."""
    result = _hunt("hostpath", "tsan")
    assert set(result.calls) == set(RH.HOSTPATH_EXPORTS)
    assert all(result.calls[name] >= 1 for name in RH.HOSTPATH_EXPORTS), (
        result.calls)
    assert result.foreign_rows > 0
