"""The port's static-analysis registry
(``limitador_tpu_torch.tools.analysis``).

Counterpart of ``tests/test_analysis.py`` and ``tests/test_lint.py``:

- the port's tree is clean under every pass at HEAD, with an empty
  baseline, and the observatory drain's lock holds show as allowlisted
  findings, not as silence;
- every pass is proven on fixture trees under ``tmp_path``: one case of
  one parametrised test a rule, flagging the bad tree and passing the
  good one;
- the ctypes ABI pass sees every CUDA entry point of
  ``csrc/counter_table.cu`` (``ct_error_string``'s two-word return type
  among them) and finds each declared in ``ops/build.py``'s
  ``_SIGNATURES``;
- the CLI's flags and exit codes, the baseline's reasons and finding
  keys without line numbers, the ``tools/lint.py`` shim;
- parity: for the passes both packages share, the JAX registry on the
  JAX layout and the port's on the port's give the same findings on one
  fixture tree.
"""

import json
import re
from pathlib import Path

import pytest

from limitador_tpu_torch.tools import analysis as A
from limitador_tpu_torch.tools.analysis import (
    BASELINE_REL, PASSES, RepoContext, finding_key, load_baseline,
    run_passes,
)

REPO_ROOT = Path(__file__).resolve().parent.parent
PKG = "limitador_tpu_torch"

PASS_NAMES = (
    "style", "metric-registry", "native-phases", "debug-sections",
    "docs-sync", "ctypes-abi", "buffer-safety", "lock-order",
    "tracing-safety",
)


def _write(root: Path, rel: str, text: str) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def _tree(root: Path, files: dict) -> Path:
    for rel, text in files.items():
        _write(root, rel, text)
    return root


# ---------------------------------------------------------------------------
# the gate at HEAD
# ---------------------------------------------------------------------------

def test_port_tree_is_clean_under_every_pass_at_head():
    """``python -m limitador_tpu_torch.tools.analysis --all`` is green."""
    active, _suppressed = run_passes(REPO_ROOT)
    assert not active, "\n".join(f.render() for f in active)


def test_baseline_is_empty_at_head():
    assert load_baseline(REPO_ROOT) == {}


def test_drain_thread_findings_are_allowlisted_not_silent():
    _active, suppressed = run_passes(REPO_ROOT, names=["lock-order"])
    drain = [f for f in suppressed if "drain thread" in f.message]
    domains = {d.message.split("'")[1] for d in drain}
    assert {"storage", "native"} <= domains, drain
    assert all(d.path == f"{PKG}/observability/usage.py" for d in drain)
    assert all("USAGE_DRAIN_BUDGET_MS" in (d.suppressed_by or "")
               for d in drain if "'storage'" in d.message)


def test_every_lock_entry_names_a_lock_of_the_tree():
    """Each LEAF_LOCKS and OUTER_LOCKS entry names a threading lock its
    module assigns, and each OUTER_LOCKS hold is a domain or an entry."""
    from limitador_tpu_torch.tools.analysis import lock_order as L

    ctx = RepoContext(REPO_ROOT)
    for module, attr in [*L.LEAF_LOCKS, *L.OUTER_LOCKS]:
        sites = L._thread_lock_sites(ctx.nodes(ctx.path(module)))
        assert attr in sites, (module, attr)
    for _reason, holds in L.OUTER_LOCKS.values():
        for name in holds:
            module, _sep, attr = name.rpartition(":")
            assert (name in L.TRACKED_DOMAINS if not module
                    else (module, attr) in L.LEAF_LOCKS), name


def test_every_registered_pass_has_description_and_runs():
    assert tuple(PASSES) == PASS_NAMES
    ctx = RepoContext(REPO_ROOT)
    for name, p in PASSES.items():
        assert p.description and p.fast
        assert isinstance(p.run(ctx), list), name


def test_ctypes_abi_sees_every_cuda_entry_point():
    """Every ``ct_`` export of counter_table.cu, those with two-word
    return types included, is seen and declared in ``_SIGNATURES``; the
    host lane's and the ingress's exports in their bindings."""
    from limitador_tpu_torch.ops.build import _SIGNATURES
    from limitador_tpu_torch.tools.analysis.native_abi import (
        abi_findings, declared_ctypes_signatures, exported_c_symbols,
    )

    src = (REPO_ROOT / PKG / "csrc" / "counter_table.cu").read_text()
    exported = {name: ret for name, ret, _ in exported_c_symbols(src)}
    assert set(exported) == set(_SIGNATURES)
    assert len(exported) == src.count("\nint ct_") + src.count(
        "\nlong long ct_") + src.count("\nvoid* ct_") + src.count(
        "\nvoid ct_") + src.count("\nconst char* ct_")
    assert exported["ct_error_string"] == "const char*"
    assert exported["ct_topk_workspace_bytes"] == "long long"
    assert exported["ct_ctx_destroy"] == "void"
    declared = declared_ctypes_signatures(
        (REPO_ROOT / PKG / "ops" / "build.py").read_text())
    assert all(declared[n] == {"restype", "argtypes"} for n in exported)
    for source, prefix in (("hostpath.cc", "hp_"), ("h2ingress.cc", "h2i_")):
        names = [n for n, _r, _p in exported_c_symbols(
            (REPO_ROOT / PKG / "csrc" / source).read_text())]
        assert names and all(n.startswith(prefix) for n in names)
    assert abi_findings(RepoContext(REPO_ROOT)) == []


# ---------------------------------------------------------------------------
# each pass on fixture trees: the bad tree flagged, the good one passed
# ---------------------------------------------------------------------------

_BUILD_BINDING = (
    "import ctypes\n"
    "_P = ctypes.c_void_p\n"
    "_I = ctypes.c_int\n"
    "_SIGNATURES = {{\n{entries}}}\n"
)
_CU = (
    'extern "C" {{\n'
    "int ct_update(void* values, const void* slots,\n"
    "              int n) {{\n"
    "  return 0;\n"
    "}}\n"
    "{extra}"
    "}}  // extern \"C\"\n"
)


def _signatures(*entries):
    return _BUILD_BINDING.format(entries="".join(
        f'    "{e}": (_I, [_P, _P, _I]),\n' for e in entries))


_STORAGE_CLS = (
    "import threading\n"
    "class TorchStorage:\n"
    "    def __init__(self, cache):\n"
    "        self._lock = threading.RLock()\n"
    "        self.cache = cache\n"
)

CASES = {
    # ctypes-abi -------------------------------------------------------------
    "ct_export_missing_from_signatures": (
        "ctypes-abi",
        "exported symbol 'ct_read_slots' has no ctypes declaration",
        {f"{PKG}/csrc/counter_table.cu": _CU.format(
            extra="int ct_read_slots(const void* values, int n) {\n"
                  "  return 0;\n}\n"),
         f"{PKG}/ops/build.py": _signatures("ct_update")},
        {f"{PKG}/csrc/counter_table.cu": _CU.format(
            extra="int ct_read_slots(const void* values, int n) {\n"
                  "  return 0;\n}\n"),
         f"{PKG}/ops/build.py": _signatures("ct_update", "ct_read_slots")},
    ),
    "signatures_key_without_export": (
        "ctypes-abi", "binding declares 'ct_gone'",
        {f"{PKG}/csrc/counter_table.cu": _CU.format(extra=""),
         f"{PKG}/ops/build.py": _signatures("ct_update", "ct_gone")},
        {f"{PKG}/csrc/counter_table.cu": _CU.format(extra=""),
         f"{PKG}/ops/build.py": _signatures("ct_update")},
    ),
    "const_char_export_without_restype": (
        "ctypes-abi",
        "'ct_error_string' returns const char* but the binding declares "
        "no restype",
        {f"{PKG}/csrc/counter_table.cu": _CU.format(
            extra="const char* ct_error_string(int code) {\n"
                  "  return \"\";\n}\n"),
         f"{PKG}/ops/build.py": _signatures("ct_update") + (
             "def bind(lib):\n"
             "    lib.ct_error_string.argtypes = [_I]\n")},
        {f"{PKG}/csrc/counter_table.cu": _CU.format(
            extra="const char* ct_error_string(int code) {\n"
                  "  return \"\";\n}\n"),
         f"{PKG}/ops/build.py": _signatures("ct_update") + (
             "def bind(lib):\n"
             "    lib.ct_error_string.argtypes = [_I]\n"
             "    lib.ct_error_string.restype = ctypes.c_char_p\n")},
    ),
    # buffer-safety ----------------------------------------------------------
    "contiguous_data_ptr_into_a_ct_call": (
        "buffer-safety",
        "'ct_update' is handed a pointer into a temporary buffer "
        "(.data_ptr()",
        {f"{PKG}/ops/kernel.py":
            "def update(lib, x, n):\n"
            "    return lib.ct_update(x.contiguous().data_ptr(), n)\n"},
        {f"{PKG}/ops/kernel.py":
            "def update(lib, x, state, n):\n"
            "    y = x.contiguous()\n"
            "    lib.ct_ctx_create(*(t.data_ptr() for t in state), n)\n"
            "    return lib.ct_update(y.data_ptr(), state.values.data_ptr(),"
            " n)\n"},
    ),
    "pointer_kept_from_a_temporary": (
        "buffer-safety", "kept in 'ptr' from line 2",
        {f"{PKG}/ops/kernel.py":
            "def update(lib, x, n):\n"
            "    ptr = x.to(dtype=None).data_ptr()\n"
            "    return lib.ct_update(ptr, n)\n"},
        {f"{PKG}/ops/kernel.py":
            "def update(lib, x, n):\n"
            "    y = x.to(dtype=None)\n"
            "    ptr = y.data_ptr()\n"
            "    return lib.ct_update(ptr, n)\n"},
    ),
    "numpy_temporary_through_an_alias": (
        "buffer-safety", "'ct_read_slots_host' is handed a pointer",
        {f"{PKG}/ops/kernel.py":
            "import numpy as np\n"
            "class Ctx:\n"
            "    def __init__(self, lib):\n"
            "        self.read_fn = lib.ct_read_slots_host\n"
            "    def read(self, cols):\n"
            "        return self.read_fn(0, np.stack(cols).ctypes.data, 1)\n"},
        {f"{PKG}/ops/kernel.py":
            "import numpy as np\n"
            "class Ctx:\n"
            "    def __init__(self, lib):\n"
            "        self.read_fn = lib.ct_read_slots_host\n"
            "    def read(self, cols):\n"
            "        buf = np.stack(cols)\n"
            "        return self.read_fn(0, buf.ctypes.data, 1)\n"},
    ),
    # lock-order -------------------------------------------------------------
    "cycle_between_two_port_domains": (
        "lock-order", "lock acquisition cycle: plan_cache -> storage",
        {f"{PKG}/device/storage.py": _STORAGE_CLS + (
            "    def outer(self):\n"
            "        with self._lock:\n"
            "            self.cache.touch_plans()\n"
            "    def release_hook(self):\n"
            "        with self._lock:\n"
            "            pass\n"),
         f"{PKG}/device/plan_cache.py":
            "import threading\n"
            "class DecisionPlanCache:\n"
            "    def __init__(self, storage):\n"
            "        self._lock = threading.Lock()\n"
            "        self.storage = storage\n"
            "    def touch_plans(self):\n"
            "        with self._lock:\n"
            "            pass\n"
            "    def evict(self):\n"
            "        with self._lock:\n"
            "            self.storage.release_hook()\n"},
        {f"{PKG}/device/storage.py": _STORAGE_CLS + (
            "    def outer(self):\n"
            "        with self._lock:\n"
            "            self.cache.touch_plans()\n"
            "    def release_hook(self):\n"
            "        with self._lock:\n"
            "            pass\n"),
         f"{PKG}/device/plan_cache.py":
            "import threading\n"
            "class DecisionPlanCache:\n"
            "    def __init__(self, storage):\n"
            "        self._lock = threading.Lock()\n"
            "        self.storage = storage\n"
            "    def touch_plans(self):\n"
            "        with self._lock:\n"
            "            pass\n"
            "    def evict(self):\n"
            "        with self._lock:\n"
            "            pass\n"
            "        self.storage.release_hook()\n"},
    ),
    "await_under_a_port_lock": (
        "lock-order", "await while holding threading lock(s) 'native'",
        {f"{PKG}/device/native_pipeline.py":
            "import threading\n"
            "class NativeRlsPipeline:\n"
            "    def __init__(self):\n"
            "        self._native_lock = threading.Lock()\n"
            "    async def submit(self):\n"
            "        with self._native_lock:\n"
            "            await self._flush()\n"},
        {f"{PKG}/device/native_pipeline.py":
            "import threading\n"
            "class NativeRlsPipeline:\n"
            "    def __init__(self):\n"
            "        self._native_lock = threading.Lock()\n"
            "    async def submit(self):\n"
            "        with self._native_lock:\n"
            "            batch = 1\n"
            "        await self._flush(batch)\n"},
    ),
    "leaf_lock_held_across_another": (
        "lock-order", "leaf lock '_lock' of "
        f"{PKG}/admission/breaker.py is held across 'storage'",
        {f"{PKG}/admission/breaker.py":
            "import threading\n"
            "class CircuitBreaker:\n"
            "    def __init__(self, storage):\n"
            "        self._lock = threading.Lock()\n"
            "        self.storage = storage\n"
            "    def trip(self):\n"
            "        with self._lock:\n"
            "            self.storage.flush_table()\n",
         f"{PKG}/device/storage.py": _STORAGE_CLS + (
            "    def flush_table(self):\n"
            "        with self._lock:\n"
            "            pass\n")},
        {f"{PKG}/admission/breaker.py":
            "import threading\n"
            "class CircuitBreaker:\n"
            "    def __init__(self, storage):\n"
            "        self._lock = threading.Lock()\n"
            "        self.storage = storage\n"
            "    def trip(self):\n"
            "        with self._lock:\n"
            "            state = 1\n"
            "        self.storage.flush_table()\n"
            "        return state\n",
         f"{PKG}/device/storage.py": _STORAGE_CLS + (
            "    def flush_table(self):\n"
            "        with self._lock:\n"
            "            pass\n")},
    ),
    "lock_without_a_place": (
        "lock-order", "threading lock '_guard' has no domain",
        {f"{PKG}/newplane.py":
            "import threading\n"
            "class Plane:\n"
            "    def __init__(self):\n"
            "        self._guard = threading.Lock()\n"},
        {f"{PKG}/newplane.py":
            "import asyncio\n"
            "class Plane:\n"
            "    def __init__(self):\n"
            "        self._guard = asyncio.Lock()\n"},
    ),
    # tracing-safety ---------------------------------------------------------
    "item_in_a_begin_of_a_hot_module": (
        "tracing-safety", "host sync .item() on the decision path "
        "('begin_check_columnar')",
        {f"{PKG}/device/storage.py":
            "def begin_check_columnar(storage, cols):\n"
            "    return int(cols.max().item())\n"},
        {f"{PKG}/device/storage.py":
            "def begin_check_columnar(storage, cols):\n"
            "    return cols.max()\n"
            "def finish_check_columnar(storage, handle):\n"
            "    return int(handle.item())\n"},
    ),
    "synchronize_in_a_submit": (
        "tracing-safety", "host sync torch.cuda.synchronize",
        {f"{PKG}/device/native_pipeline.py":
            "import torch\n"
            "async def submit(pipeline, blob):\n"
            "    torch.cuda.synchronize()\n"
            "    return blob\n"},
        {f"{PKG}/device/native_pipeline.py":
            "import torch\n"
            "async def submit(pipeline, blob):\n"
            "    return blob\n"
            "def _collect(pipeline, event):\n"
            "    event.synchronize()\n"},
    ),
    "lib_ct_update_called_outside_ops": (
        "tracing-safety", "CUDA entry point 'ct_update' called outside",
        {f"{PKG}/lease/broker.py":
            "from ..ops import build\n"
            "def settle(ptrs, n):\n"
            "    return build.library().ct_update(*ptrs, n)\n"},
        {f"{PKG}/ops/kernel.py":
            "from . import build\n"
            "def update_batch(ptrs, n):\n"
            "    return build.library().ct_update(*ptrs, n)\n"},
    ),
    "kernel_wrapper_called_outside_its_owners": (
        "tracing-safety", "direct kernel launch 'update_batch'",
        {f"{PKG}/ops/kernel.py":
            "CLUSTER_MIN_HITS = 1024\n"
            "def update_batch(state, hits):\n"
            "    return state\n",
         f"{PKG}/lease/broker.py":
            "from ..ops import kernel as K\n"
            "def settle(state, hits):\n"
            "    return K.update_batch(state, hits), K.CLUSTER_MIN_HITS\n"},
        {f"{PKG}/ops/kernel.py":
            "CLUSTER_MIN_HITS = 1024\n"
            "def update_batch(state, hits):\n"
            "    return state\n",
         f"{PKG}/device/storage.py":
            "from ..ops import kernel as K\n"
            "def settle(state, hits):\n"
            "    return K.update_batch(state, hits), K.CLUSTER_MIN_HITS\n"},
    ),
    # style and the registries -----------------------------------------------
    "import_redefined_in_one_function": (
        "style", "import 'DiskStorage' redefines line 3",
        {f"{PKG}/server/main.py":
            "def build(kind):\n"
            "    if kind == 'disk':\n"
            "        from .disk import DiskStorage\n"
            "        return DiskStorage()\n"
            "    from .disk import DiskStorage\n"
            "    return DiskStorage()\n"},
        {f"{PKG}/server/main.py":
            "def build(kind):\n"
            "    if kind in ('disk', 'cached'):\n"
            "        from .disk import DiskStorage\n"
            "    if kind == 'disk':\n"
            "        return DiskStorage()\n"
            "    return DiskStorage()\n"},
    ),
    "family_registered_but_not_declared": (
        "metric-registry", "'lease_ghost' is registered but not declared",
        {f"{PKG}/observability/metrics.py":
            "from prometheus_client import Gauge\n"
            "def families(r):\n"
            "    return Gauge('lease_active', 'x', registry=r)\n",
         f"{PKG}/lease/__init__.py":
            "METRIC_FAMILIES = ('lease_active', 'lease_ghost')\n"},
        {f"{PKG}/observability/metrics.py":
            "from prometheus_client import Gauge\n"
            "def families(r):\n"
            "    return Gauge('lease_active', 'x', registry=r)\n",
         f"{PKG}/lease/__init__.py":
            "METRIC_FAMILIES = ('lease_active',)\n"},
    ),
    "nonempty_section_not_registered": (
        "debug-sections",
        "/debug/stats section 'lease' is served but missing",
        {f"{PKG}/server/http_api.py":
            "DEBUG_NONEMPTY_SECTIONS = (('lease', 'lease_stats'),)\n"
            "DEBUG_STATS_SECTIONS = ()\n"},
        {f"{PKG}/server/http_api.py":
            "DEBUG_NONEMPTY_SECTIONS = (('lease', 'lease_stats'),)\n"
            "DEBUG_STATS_SECTIONS = ('lease',)\n"},
    ),
    "port_only_route_documented_in_the_readme": (
        "docs-sync", "debug endpoint '/debug/profile' is not documented",
        {"docs/observability.md": "`GET /debug/stats`\n",
         "README.md": "# x\n\n## PyTorch/CUDA port (`x`)\n\nnothing\n",
         f"{PKG}/server/http_api.py":
            "def routes(app, api):\n"
            "    app.router.add_get('/debug/stats', api.s)\n"
            "    app.router.add_post('/debug/profile', api.p)\n"},
        {"docs/observability.md": "`GET /debug/stats`\n",
         "README.md": "# x\n\n## PyTorch/CUDA port (`x`)\n\n"
                      "POST /debug/profile starts a torch.profiler "
                      "capture\n\n## Other\n",
         f"{PKG}/server/http_api.py":
            "def routes(app, api):\n"
            "    app.router.add_get('/debug/stats', api.s)\n"
            "    app.router.add_post('/debug/profile', api.p)\n"},
    ),
    "phase_without_its_family": (
        "native-phases", "'native_phase_h2i_respond' histogram family",
        {f"{PKG}/observability/metrics.py":
            "from prometheus_client import Histogram\n"
            "def families(r):\n"
            "    return Histogram('native_phase_hot_lookup', 'x')\n",
         f"{PKG}/observability/native_plane.py":
            "PHASES = ('hot_lookup', 'h2i_respond')\n"
            "METRIC_FAMILIES = ('native_phase_hot_lookup',\n"
            "                   'native_phase_h2i_respond')\n"},
        {f"{PKG}/observability/metrics.py":
            "from prometheus_client import Histogram\n"
            "def families(r):\n"
            "    return Histogram('native_phase_hot_lookup', 'x')\n",
         f"{PKG}/observability/native_plane.py":
            "PHASES = ('hot_lookup',)\n"
            "METRIC_FAMILIES = ('native_phase_hot_lookup',)\n"},
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pass_flags_the_bad_tree_and_passes_the_good(tmp_path, case):
    pass_name, needle, bad, good = CASES[case]
    targets = (PKG,)
    active, _ = run_passes(_tree(tmp_path / "bad", bad), names=[pass_name],
                           targets=targets, use_baseline=False)
    assert any(needle in f.message for f in active), (
        [f.render() for f in active])
    assert all(f.pass_name == pass_name for f in active)
    active, _ = run_passes(_tree(tmp_path / "good", good),
                           names=[pass_name], targets=targets,
                           use_baseline=False)
    assert active == [], [f.render() for f in active]


# ---------------------------------------------------------------------------
# framework mechanics
# ---------------------------------------------------------------------------

def test_baseline_suppresses_with_its_reason(tmp_path):
    _write(tmp_path, f"{PKG}/x.py", "import os\n")
    _write(tmp_path, BASELINE_REL,
           "# parked\n"
           f"style|{PKG}/x.py|unused import 'os' -- migration FOO\n")
    active, suppressed = run_passes(tmp_path, names=["style"],
                                    targets=(PKG,))
    assert active == []
    assert len(suppressed) == 1
    assert suppressed[0].suppressed_by == "baseline: migration FOO"


def test_finding_keys_do_not_depend_on_line_numbers(tmp_path):
    keys = []
    for lead in ("", "\n\n\n"):
        root = tmp_path / str(len(lead))
        _write(root, f"{PKG}/x.py", lead + "import os\n")
        active, _ = run_passes(root, names=["style"], targets=(PKG,),
                               use_baseline=False)
        assert [f.line for f in active] == [1 + len(lead)]
        keys.append(finding_key(active[0]))
    assert keys[0] == keys[1] == f"style|{PKG}/x.py|unused import 'os'"


def test_unknown_pass_raises():
    with pytest.raises(KeyError):
        run_passes(REPO_ROOT, names=["bogus-pass"])


def test_cli_flags_and_exit_codes(tmp_path, capsys, monkeypatch):
    from limitador_tpu_torch.tools.analysis import __main__ as cli

    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in PASS_NAMES)

    assert cli.main(["--only", "bogus"]) == 2
    assert "unknown pass" in capsys.readouterr().err
    assert cli.main(["no_such_file.py"]) == 2
    assert "no such lint target" in capsys.readouterr().err

    assert cli.main(["--all", "--only", "ctypes-abi,native-phases",
                     "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["passes"] == ["ctypes-abi", "native-phases"]
    assert payload["active"] == [] and payload["baseline_entries"] == 0

    # a tree of its own: a finding exits 1, the baseline parks it with
    # its reason, --no-baseline brings it back, --show-suppressed prints
    _write(tmp_path, f"{PKG}/x.py", "import os\n")
    _write(tmp_path, BASELINE_REL, "")
    monkeypatch.setattr(cli, "repo_root", lambda: tmp_path)
    assert cli.main(["--only", "style", PKG]) == 1
    assert "unused import 'os'" in capsys.readouterr().out
    assert cli.main(["--only", "style", "--write-baseline", PKG]) == 0
    capsys.readouterr()
    assert list(load_baseline(tmp_path).values()) == [
        "parked by --write-baseline"]
    assert cli.main(["--only", "style", PKG]) == 0
    assert "1 suppressed" in capsys.readouterr().err
    assert cli.main(["--only", "style", "--show-suppressed", PKG]) == 0
    assert "suppressed: baseline: parked" in capsys.readouterr().out
    assert cli.main(["--only", "style", "--no-baseline", PKG]) == 1


def test_lint_shim_matches_the_registry(tmp_path):
    from limitador_tpu_torch.tools import lint
    from limitador_tpu_torch.tools.analysis.registries import (
        metric_registry_findings,
    )

    _tree(tmp_path, {
        f"{PKG}/observability/metrics.py":
            "from prometheus_client import Gauge\n"
            "def families(r):\n"
            "    return Gauge('admission_declared_only', 'x', registry=r)\n",
        f"{PKG}/admission/__init__.py":
            "METRIC_FAMILIES = ('admission_registered_only',)\n",
    })
    legacy = lint.lint_metric_registry(tmp_path)
    registry = metric_registry_findings(RepoContext(tmp_path))
    assert len(legacy) == len(registry) == 2
    for finding in registry:
        assert any(finding.message in line for line in legacy)
    assert lint.lint_metric_registry(REPO_ROOT) == []
    assert lint.lint_paths([REPO_ROOT / t for t in A.DEFAULT_TARGETS]) == []
    assert lint.main(["--only", "style"]) == 0


# ---------------------------------------------------------------------------
# parity with the JAX package's registry
# ---------------------------------------------------------------------------

#: one fixture a shared pass, written in the JAX layout (package-relative
#: paths under ``limitador_tpu/``, ``tpu/`` for the device modules, the
#: host lane's source at ``native/hostpath.cc``); the port's copy lands
#: at the port's paths
PARITY = {
    "style": {
        "pkg:x.py":
            "import os\n"
            "import json, sys\n"
            "def f(x={}):\n"
            "    try:\n"
            "        pass\n"
            "    except:\n"
            "        pass\n"
            "    if x == None:\n"
            "        return {'a': 1, 'a': 2}\n"
            "    return json.dumps(sys.path) \n",
    },
    "metric-registry": {
        "pkg:observability/metrics.py":
            "from prometheus_client import Counter, Gauge\n"
            "def families(r):\n"
            "    return (Gauge('admission_declared_only', 'x', registry=r),\n"
            "            Counter('plan_cache_hits', 'x', registry=r))\n",
        "pkg:admission/__init__.py":
            "METRIC_FAMILIES = ('admission_registered_only',)\n",
        "pkg:tpu/plan_cache.py": "METRIC_FAMILIES = ('plan_cache_hits',)\n",
    },
    "native-phases": {
        "pkg:observability/metrics.py":
            "from prometheus_client import Histogram\n"
            "def families(r):\n"
            "    return Histogram('native_phase_a', 'x')\n",
        "pkg:observability/native_plane.py":
            "PHASES = ('a', 'b', 'c')\n"
            "METRIC_FAMILIES = ('native_phase_a', 'native_phase_c')\n",
    },
    "debug-sections": {
        "pkg:server/http_api.py":
            "DEBUG_SOURCE_SECTIONS = (('slo', 'slo_status'),)\n"
            "DEBUG_STATS_SECTIONS = ('slo', 'registered_only')\n"
            "def get_debug_stats(stats):\n"
            "    stats['served_only'] = 1\n"
            "    stats['slo'] = 2\n",
    },
    "docs-sync": {
        "docs/observability.md":
            "`peer_up`, the `flight_taps` family and `GET /debug/stats`.\n",
        "pkg:observability/events.py":
            "EVENT_KINDS = ('peer_up', 'undocumented_kind')\n",
        "pkg:observability/flight.py":
            "METRIC_FAMILIES = ('flight_taps', 'flight_undocumented')\n",
        "pkg:server/http_api.py":
            "def make_app(app, api):\n"
            "    app.router.add_get('/debug/stats', api.s)\n"
            "    app.router.add_post('/debug/undocumented', api.u)\n",
    },
    "ctypes-abi": {
        "src:hostpath.cc":
            'extern "C" {\n'
            "int32_t hp_declared(void* c, int32_t n) { return n; }\n"
            "void hp_undeclared(void* c) {}\n"
            "int64_t hp_no_restype(void* c,\n"
            "                      int64_t n) { return n; }\n"
            "void* hp_new() { return nullptr; }\n"
            "}\n",
        "pkg:native/__init__.py":
            "def bind(lib):\n"
            "    lib.hp_declared.restype = ctypes.c_int32\n"
            "    lib.hp_declared.argtypes = [ctypes.c_void_p, "
            "ctypes.c_int32]\n"
            "    lib.hp_no_restype.argtypes = [ctypes.c_void_p, "
            "ctypes.c_int64]\n"
            "    lib.hp_new.restype = ctypes.c_void_p\n"
            "    lib.hp_new.argtypes = []\n"
            "    lib.hp_gone.argtypes = []\n",
    },
    "buffer-safety": {
        "pkg:native/use.py":
            "import numpy as np\n"
            "def bad(lib, n):\n"
            "    return lib.hp_tel_drain(np.empty(n).ctypes.data, n)\n"
            "def bad_astype(lib, arr):\n"
            "    lib.h2i_tel_drain(arr.astype(np.int64).ctypes.data, 8)\n"
            "def good(lib, n):\n"
            "    out = np.empty(n)\n"
            "    return lib.hp_tel_drain(out.ctypes.data, n)\n"
            "def good_slice(lib, buf, used):\n"
            "    lib.hp_tel_drain(buf[:used].ctypes.data, used)\n",
    },
    "lock-order": {
        "pkg:tpu/storage.py":
            "import threading\n"
            "import time\n"
            "class TpuStorage:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.RLock()\n"
            "    def bad(self, pipeline):\n"
            "        with self._lock:\n"
            "            with pipeline._native_lock:\n"
            "                pass\n"
            "    def slow(self):\n"
            "        with self._lock:\n"
            "            time.sleep(0.1)\n"
            "    async def parked(self):\n"
            "        with self._lock:\n"
            "            await self.flush_all()\n",
        "pkg:tpu/native_pipeline.py":
            "import threading\n"
            "class Pipe:\n"
            "    def __init__(self, storage):\n"
            "        self._native_lock = threading.Lock()\n"
            "        self.storage = storage\n"
            "    def ok(self):\n"
            "        with self._native_lock:\n"
            "            with self.storage._lock:\n"
            "                pass\n",
    },
}


def _layout(key: str, port: bool) -> str:
    kind, _sep, rel = key.partition(":")
    if kind == "pkg":
        return (f"{PKG}/{rel.replace('tpu/', 'device/', 1)}" if port
                else f"limitador_tpu/{rel}")
    if kind == "src":
        return f"{PKG}/csrc/{rel}" if port else f"native/{rel}"
    return key


def _normal(text: str) -> str:
    """A message with the package's paths spelled alike; the port's
    docs-sync also reads README's port section, which its messages
    name."""
    text = re.sub(r"\blimitador_tpu(_torch)?/(tpu|device)/", "PKG/tpu/",
                  text)
    return text.replace(f"{PKG}/", "PKG/").replace(
        "limitador_tpu/", "PKG/").replace(" or README.md", "")


@pytest.mark.parametrize("pass_name", sorted(PARITY))
def test_shared_passes_agree_with_the_jax_registry(tmp_path, pass_name):
    from limitador_tpu.tools.analysis import run_passes as jax_run_passes

    files = PARITY[pass_name]
    jax_root = _tree(tmp_path / "jax", {
        _layout(k, False): v for k, v in files.items()})
    port_root = _tree(tmp_path / "port", {
        _layout(k, True): v for k, v in files.items()})
    jax_found, _ = jax_run_passes(jax_root, names=[pass_name],
                                  targets=("limitador_tpu",),
                                  use_baseline=False)
    port_found, _ = run_passes(port_root, names=[pass_name],
                               targets=(PKG,), use_baseline=False)
    assert jax_found, pass_name  # the fixture has something to find
    assert sorted((f.line, _normal(f.message)) for f in port_found) == \
        sorted((f.line, _normal(f.message)) for f in jax_found)
