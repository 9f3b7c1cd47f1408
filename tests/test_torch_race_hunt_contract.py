"""The race hunt's contract, in tier 1 (the hunts themselves are slow:
``tests/test_torch_race_hunt.py``).

- The sanitizer variants are declared: every ``TPU_NATIVE_SANITIZE``
  value maps to ``-fsanitize=`` flags (a mistyped variant silently
  building plain -O2 would fake a clean hunt), ``sanitizer_variant()``
  reads the environment, and ``build_status()`` reports the variant.
- The lane-stats buffer has one length: ``HP_LANE_STATS`` in
  ``csrc/hostpath.cc`` equals the entries ``hp_lane_stats`` writes, the
  binding's ``LANE_STATS`` (what ``HostPath.lane_stats`` allocates) and
  the driver's buffer. The JAX driver's ``int64_t lane[8]`` against a
  function that writes nine entries is the fault that rotted the JAX
  hunt unseen.
- The exports the hostpath driver counts are ``race_hunt``'s.
- ``TPU_NATIVE_SANITIZE=ubsan`` builds the host lane instrumented under
  its own name, loads it into a plain interpreter (UBSAN needs no
  preloaded runtime) and ``build_status()`` reports the variant.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from limitador_tpu_torch import native
from limitador_tpu_torch.native import build as host_build
from limitador_tpu_torch.tools import race_hunt as RH

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "limitador_tpu_torch" / "csrc"


def test_sanitizer_variants_are_declared(monkeypatch):
    assert set(host_build.SANITIZER_FLAGS) == {"tsan", "asan", "ubsan"}
    for flags in host_build.SANITIZER_FLAGS.values():
        assert any(f.startswith("-fsanitize=") for f in flags)
        assert "-O2" not in flags
    assert {v for _d, v in RH.HUNTS} == set(host_build.SANITIZER_FLAGS)
    for raw, want in (("tsan", "tsan"), (" ASan ", "asan"), ("", None),
                      ("msan", None)):
        monkeypatch.setenv("TPU_NATIVE_SANITIZE", raw)
        assert host_build.sanitizer_variant() == want
    monkeypatch.delenv("TPU_NATIVE_SANITIZE")
    assert host_build.sanitizer_variant() is None
    assert set(host_build.build_status()["hostpath"]) == {
        "attempted", "loaded", "build_error", "sanitizer"}


def test_the_lane_stats_buffer_has_one_length():
    source = (CSRC / "hostpath.cc").read_text()
    declared = int(re.search(
        r"constexpr int HP_LANE_STATS = (\d+);", source).group(1))
    body = source[source.index("void hp_lane_stats(void* c, int64_t* out)"):]
    body = body[:body.index("\n}\n")]
    written = sorted(int(i) for i in re.findall(r"out\[(\d+)\] =", body))
    assert written == list(range(declared))
    assert native.LANE_STATS == declared
    driver = (CSRC / "race_hunt_hostpath.cc").read_text()
    assert "int64_t lane[HP_LANE_STATS];" in driver
    assert re.search(r"int64_t lane\[\d+\]", driver) is None
    # the binding allocates it: every entry comes back, foreign last
    stats = native.HostPath().lane_stats()
    assert len(stats) == declared and list(stats)[-1] == "foreign"


def test_the_driver_counts_the_exports_race_hunt_checks():
    driver = (CSRC / "race_hunt_hostpath.cc").read_text()
    table = driver[driver.index("kExportNames[E_COUNT] = {"):]
    table = table[:table.index("};")]
    assert tuple(re.findall(r'"(hp_[a-z_]+)"', table)) == \
        RH.HOSTPATH_EXPORTS
    for name in RH.HOSTPATH_EXPORTS:
        assert f"{name}(" in driver, name


@pytest.mark.parametrize("driver", sorted(host_build.RACE_HUNT_SOURCES))
def test_each_driver_includes_the_ports_own_source(driver):
    main, *included = host_build.RACE_HUNT_SOURCES[driver]
    text = main.read_text()
    assert main.parent == CSRC
    assert f'#include "{included[0].name}"' in text


def test_an_instrumented_host_lane_reports_its_variant():
    code = (
        "import json\n"
        "from limitador_tpu_torch import native\n"
        "from limitador_tpu_torch.native import build\n"
        "stats = native.HostPath().lane_stats()\n"
        "print(json.dumps([len(stats), build.build_status()['hostpath'],\n"
        "                  build.build_info['path']]))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "TPU_NATIVE_SANITIZE": "ubsan"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n, status, path = json.loads(proc.stdout.splitlines()[-1])
    assert n == native.LANE_STATS
    assert status["loaded"] and status["sanitizer"] == "ubsan"
    assert Path(path).name.startswith("libhostpath.ubsan-")
