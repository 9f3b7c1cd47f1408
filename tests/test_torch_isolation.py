"""The port stands alone: no JAX, nothing of limitador_tpu.

- A subprocess that refuses to import ``jax`` and ``limitador_tpu``
  imports every module of ``limitador_tpu_torch`` (which leaves
  ``opentelemetry`` unimported: only span export imports it, and
  ``msgpack``: only the shared authority's path imports it), builds a
  ``TorchStorage(device="cpu")`` and decides a request, decides a
  cold counter through ``tier.TieredStorage``, decides a request
  whose counters span rows of ``TorchShardedStorage(n_shards=4)``, and
  decides on the host storages: ``disk``, ``distributed`` and a
  ``cached`` replica flushing to a torch table served as the shared
  authority.
- An AST scan of the port's sources finds no such import.
- A server with ``--native-ingress`` (``native/ingress.py`` over the
  native pipeline, the server's ingress path) starts, answers
  ShouldRateLimit on its port and stops in such a subprocess.
- A server imports the admission package only when
  ``--admission-mode`` is not ``off``, or when it is a pod member with
  ``--pod-degraded-mode on`` (the default: the per-peer failover breaker
  is the admission plane's ``CircuitBreaker``). The pod's modules
  (``server/peering.py``, ``parallel/pod.py``, which uses
  ``torch.distributed``'s TCPStore) are imported in pod mode only.
  (``import torch`` loads ``torch.distributed`` itself, so the pin is on
  the port's modules that use it.) The elastic pod's coordinator
  (``server/resize.py``) is imported only with ``--pod-resize on`` or
  ``--standby on``, and the warm standby (``server/standby.py``) only
  with ``--standby on``.
- A server imports the capacity controller's package
  (``limitador_tpu_torch.control``) only when ``--capacity-controller``
  is not ``off``, in a process that refuses ``jax`` and
  ``limitador_tpu``; the tools (``limitador_tpu_torch.tools``) are
  never imported by a server. The server's argparse destinations are
  the JAX server's but ``tpu_capacity`` and ``xla_cache_dir``, plus
  ``capacity``, ``device`` and ``kernel_cache_dir``.
- A 2-process pod of port servers forms, decides and stops with both
  processes refusing to import ``jax`` and ``limitador_tpu``, routed and
  with ``--pipeline native --native-ingress`` (the native pod fast
  path).
- The port's analysis tooling (``limitador_tpu_torch.tools.analysis``,
  ``tools/lint.py``, ``tools/race_hunt.py``) imports and runs its passes
  in a process that refuses ``jax`` and ``limitador_tpu``.
- The port's protobuf message classes are its own even when both
  packages are loaded in one process (the JAX package registers the same
  ``.proto`` files and puts its proto directory on ``sys.path``).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "limitador_tpu_torch"

_GUARDED = r'''
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "limitador_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import limitador_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    limitador_tpu_torch.__path__, "limitador_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# span export imports the opentelemetry API only when it is configured
assert not any(m.split(".")[0] == "opentelemetry" for m in sys.modules)
# the shared authority's wire imports msgpack only on its own path
assert "msgpack" not in sys.modules

from limitador_tpu_torch import Context, Limit, RateLimiter
from limitador_tpu_torch.device import TorchStorage

limiter = RateLimiter(TorchStorage(capacity=64, device="cpu"))
limiter.add_limit(Limit("ns", 1, 60, [], ["descriptors[0].u"]))
ctx = Context()
ctx.list_binding("descriptors", [{"u": "x"}])
first = limiter.check_rate_limited_and_update("ns", ctx, 1)
second = limiter.check_rate_limited_and_update("ns", ctx, 1)
assert not first.limited and second.limited

# the tiers too: a cold counter keeps deciding exactly
from limitador_tpu_torch.tier import TieredStorage

tiered = RateLimiter(TieredStorage(capacity=64, cache_size=2, device="cpu"))
tiered.add_limit(Limit("ns", 2, 60, [], ["u"]))
tiered.update_counters("ns", Context({"u": "cold"}), 1)
for u in range(4):
    tiered.update_counters("ns", Context({"u": str(u)}), 1)
assert tiered.storage.counters._cold.cells
assert not tiered.check_rate_limited_and_update(
    "ns", Context({"u": "cold"}), 1).limited
assert tiered.check_rate_limited_and_update(
    "ns", Context({"u": "cold"}), 1).limited

# the sharded table: a request whose two counters sit on different rows
# is decided by the coupled launch, all or nothing
from limitador_tpu_torch.device.sharded import TorchShardedStorage

sharded = TorchShardedStorage(n_shards=4, local_capacity=64,
                              global_region=8, device="cpu")
spanning = RateLimiter(sharded)
spanning.add_limit(Limit("sp", 1, 60, [], ["u"], name="tight"))
spanning.add_limit(Limit("sp", 5, 3600, [], ["u"], name="loose"))
for i in range(64):
    ctx = Context({"u": f"u{i}"})
    before = sharded.launch_stats()["sharded_launches"]["coupled"]
    assert not spanning.check_rate_limited_and_update("sp", ctx, 1).limited
    if sharded.launch_stats()["sharded_launches"]["coupled"] > before:
        break
else:
    raise AssertionError("no user's counters span rows")
again = spanning.check_rate_limited_and_update("sp", ctx, 1)
assert again.limited and again.limit_name == "tight"
loose = {c.limit.name: c.remaining for c in spanning.get_counters("sp")
         if c.set_variables == {"u": f"u{i}"}}
assert loose["loose"] == 4, loose

# the host storages, and a cached replica over a served torch table
import asyncio, os, tempfile
from limitador_tpu_torch import AsyncRateLimiter
from limitador_tpu_torch.storage.authority import (
    RemoteAuthority, serve_authority)
from limitador_tpu_torch.storage.cached import CachedCounterStorage
from limitador_tpu_torch.storage.disk import DiskStorage
from limitador_tpu_torch.storage.distributed import CrInMemoryStorage

with tempfile.TemporaryDirectory() as tmp:
    disk = DiskStorage(os.path.join(tmp, "c.db"))
    for storage in (disk, CrInMemoryStorage.standalone("n")):
        host = RateLimiter(storage)
        host.add_limit(Limit("ns", 1, 60, [], ["u"]))
        assert not host.check_rate_limited_and_update(
            "ns", Context({"u": "x"}), 1).limited
        assert host.check_rate_limited_and_update(
            "ns", Context({"u": "x"}), 1).limited
        storage.close()
table = TorchStorage(capacity=64, device="cpu")
authority = serve_authority(table, "127.0.0.1:0")

async def replica():
    cached = CachedCounterStorage(
        RemoteAuthority(f"127.0.0.1:{authority.port}"), flush_period=3600)
    limiter = AsyncRateLimiter(cached)
    limit = Limit("ns", 5, 60, [], ["u"])
    limiter.add_limit(limit)
    await limiter.check_rate_limited_and_update("ns", Context({"u": "y"}), 3)
    await cached.flush()
    await cached.close()
    return limit

limit = asyncio.run(replica())
authority.stop()
assert [c.remaining for c in table.get_counters({limit})] == [2]
assert not any(m.split(".")[0] in ("jax", "limitador_tpu")
               for m in sys.modules)
print("imported", len(names), "modules")
'''


def test_port_imports_and_decides_without_jax_or_the_jax_package():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _GUARDED], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout


_GUARDED_INGRESS = r'''
import asyncio, importlib.abc, os, socket, sys, tempfile

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "limitador_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import grpc
from limitador_tpu_torch.server import __main__ as m
from limitador_tpu_torch.server.proto import rls_pb2

def free():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]

def free_pair():
    """A free port whose next port is free too: --native-ingress serves
    the ingress on --rls-port and grpc.aio on --rls-port + 1."""
    for _ in range(100):
        port = free()
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port + 1))
            except OSError:
                continue
        return port
    raise RuntimeError("no free pair of local ports")

def bind_failure(exc):
    text = str(exc).lower()
    return (isinstance(exc, OSError) or "bind" in text
            or "address already in use" in text)

async def start(limits, tmp):
    """Start the server; a pair picked free can still be taken before
    the server binds it, so a bind failure starts it again on a fresh
    pair (start() stops what it brought up before it raises)."""
    for attempt in range(5):
        port = free_pair()
        try:
            return port, await m.start(m.build_parser().parse_args([
                limits, "torch", "--device", "cpu", "--capacity", "64",
                "--pipeline", "native", "--native-ingress", "--rls-host",
                "127.0.0.1", "--rls-port", str(port), "--http-host",
                "127.0.0.1", "--http-port", str(free()),
                "--flight-spool-dir", os.path.join(tmp, "flight")]))
        except (OSError, RuntimeError, ValueError) as exc:
            if attempt == 4 or not bind_failure(exc):
                raise

async def main(tmp):
    limits = os.path.join(tmp, "limits.yaml")
    with open(limits, "w") as f:
        f.write("- namespace: ns\n  max_value: 1\n  seconds: 60\n"
                '  variables: ["descriptors[0].u"]\n')
    port, server = await start(limits, tmp)
    req = rls_pb2.RateLimitRequest(domain="ns")
    req.descriptors.add().entries.add(key="u", value="x")

    def calls():
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            call = ch.unary_unary(
                "/envoy.service.ratelimit.v3.RateLimitService/"
                "ShouldRateLimit")
            return [rls_pb2.RateLimitResponse.FromString(
                call(req.SerializeToString(), timeout=30)).overall_code
                for _ in range(2)]

    try:
        assert server.native_ingress.port == port
        codes = await asyncio.get_running_loop().run_in_executor(None, calls)
    finally:
        await server.stop()
    assert codes == [rls_pb2.RateLimitResponse.OK,
                     rls_pb2.RateLimitResponse.OVER_LIMIT], codes

with tempfile.TemporaryDirectory() as tmp:
    asyncio.run(main(tmp))
assert not any(m.split(".")[0] in ("jax", "limitador_tpu")
               for m in sys.modules)
print("served")
'''


def test_native_ingress_server_runs_without_jax_or_the_jax_package():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _GUARDED_INGRESS], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "served" in proc.stdout


_GUARDED_TOOLS = r'''
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "limitador_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
from limitador_tpu_torch.tools import analysis, lint, race_hunt
from limitador_tpu_torch.tools.analysis import __main__ as cli

active, suppressed = analysis.run_passes()
assert active == [], [f.render() for f in active]
assert cli.main(["--list"]) == 0
assert not any(m.split(".")[0] in ("jax", "jaxlib", "limitador_tpu")
               for m in sys.modules)
print("analysed", len(analysis.PASSES), "passes")
'''


def test_the_analysis_tooling_runs_without_jax_or_the_jax_package():
    """The port's analysis registry, its lint shim and the race-hunt
    harness import neither JAX nor ``limitador_tpu`` (chip_smoke.py runs
    the registry on the card's machine, which has no JAX)."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _GUARDED_TOOLS], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "analysed 9 passes" in proc.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_or_jax_package_import(path):
    for lineno, name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "limitador_tpu"), (
            f"{path.relative_to(REPO)}:{lineno} imports {name}")


def test_proto_classes_are_the_ports_own_beside_the_jax_package():
    import limitador_tpu.server.proto as jax_proto
    from limitador_tpu_torch.server.proto import (
        base_pb2,
        kuadrant_rls_pb2,
        ratelimit_pb2,
        rls_pb2,
    )

    for module in (base_pb2, kuadrant_rls_pb2, ratelimit_pb2, rls_pb2):
        assert Path(module.__file__).parent == PORT / "server" / "proto"
    assert rls_pb2.RateLimitRequest is not jax_proto.rls_pb2.RateLimitRequest
    assert rls_pb2.RateLimitRequest.__module__.startswith(
        "limitador_tpu_torch.")
    # the wire format is the same
    req = rls_pb2.RateLimitRequest(domain="d", hits_addend=3)
    req.descriptors.add().entries.add(key="k", value="v")
    again = jax_proto.rls_pb2.RateLimitRequest.FromString(
        req.SerializeToString())
    assert again.domain == "d" and again.hits_addend == 3
    services = kuadrant_rls_pb2.DESCRIPTOR.services_by_name
    assert set(services["RateLimitService"].methods_by_name) == {
        "CheckRateLimit", "Report"}


def test_importing_the_port_builds_nothing():
    """Every module imports without compiling the CUDA kernels or the C++
    host lane: both build at first use."""
    code = (
        "import importlib, pkgutil, limitador_tpu_torch\n"
        "for m in pkgutil.walk_packages(limitador_tpu_torch.__path__,\n"
        "                               'limitador_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from limitador_tpu_torch.native import build as nb\n"
        "from limitador_tpu_torch.ops import build as ob\n"
        "assert nb._lib is None and ob._lib is None\n"
        "assert not nb.build_info and not ob.build_info\n"
        "print('nothing built')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "nothing built" in proc.stdout


def _profiler_imports(path: Path):
    """(qualified name of the enclosing function or class chain, line) of
    every import of ``torch.profiler`` in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                visit(child, scope + (child.name,))
                continue
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                names = [child.module or ""]
            if any(n == "torch.profiler" or n.startswith("torch.profiler.")
                   for n in names):
                out.append((".".join(scope), child.lineno))
            visit(child, scope)

    visit(tree, ())
    return out


def test_torch_profiler_is_imported_only_in_the_capture_start():
    """``torch.profiler`` is imported by the capture's start
    (``TorchProfiler._start``, which ``start`` runs on the server's loop
    thread) and nowhere else in the port (no module imports it at its
    top)."""
    found = [
        (str(path.relative_to(REPO)), scope, line)
        for path in sorted(PORT.rglob("*.py"))
        for scope, line in _profiler_imports(path)
    ]
    assert [(p, s) for p, s, _l in found] == [
        ("limitador_tpu_torch/observability/device_plane.py",
         "TorchProfiler._start")], found


_IMPORTS = r'''
import asyncio, sys
from limitador_tpu_torch.server import __main__ as m

async def main(argv):
    server = await m.start(m.build_parser().parse_args(argv))
    try:
        return ("limitador_tpu_torch.admission" in sys.modules,
                server.admission is not None,
                "limitador_tpu_torch.server.peering" in sys.modules,
                "limitador_tpu_torch.parallel.pod" in sys.modules)
    finally:
        await server.stop()

print(asyncio.run(main(sys.argv[1:])))
'''


@pytest.mark.parametrize("mode", ["off", "enforce"])
def test_the_admission_package_is_imported_only_when_asked_for(tmp_path,
                                                               mode):
    """A server started with ``--admission-mode off`` (the default)
    never imports ``limitador_tpu_torch.admission``; with ``enforce`` it
    builds the controller. Neither imports the pod's modules."""
    from .torch_http import LIMITS, free_port, port_argv

    limits = tmp_path / "limits.yaml"
    limits.write_text(LIMITS)
    argv = port_argv(limits, "torch", free_port(), "--admission-mode", mode)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", _IMPORTS, *argv], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    on = mode != "off"
    assert proc.stdout.strip().splitlines()[-1] == str(
        (on, on, False, False))


_CONTROL = r'''
import asyncio, importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "limitador_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
from limitador_tpu_torch.server import __main__ as m

async def main(argv):
    server = await m.start(m.build_parser().parse_args(argv))
    try:
        await asyncio.sleep(0.3)
        controller = server.controller
        return ("limitador_tpu_torch.control" in sys.modules,
                controller is not None,
                controller.stats()["ctl_ticks"] > 0
                if controller is not None else None,
                any(k.startswith("limitador_tpu_torch.tools")
                    for k in sys.modules))
    finally:
        await server.stop()

print(asyncio.run(main(sys.argv[1:])))
'''


@pytest.mark.parametrize("mode", ["off", "observe", "on"])
def test_the_control_package_is_imported_only_when_asked_for(tmp_path,
                                                             mode):
    """``--capacity-controller off`` (the default) builds nothing and
    never imports ``limitador_tpu_torch.control``; ``observe`` and
    ``on`` build the controller, which ticks. No server imports the
    tools, and none imports ``jax`` or ``limitador_tpu``."""
    from .torch_http import LIMITS, free_port, port_argv

    limits = tmp_path / "limits.yaml"
    limits.write_text(LIMITS)
    argv = port_argv(limits, "torch", free_port(), "--pipeline", "native",
                     "--capacity-controller", mode, "--ctl-interval", "0.05")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", _CONTROL, *argv], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    on = mode != "off"
    assert proc.stdout.strip().splitlines()[-1] == str(
        (on, on, True if on else None, False))


def test_the_server_options_are_the_jax_ones():
    """The port's server takes the JAX server's options (the capacity
    controller's nine among them) but the two of the XLA runtime, and
    adds its own three."""
    from limitador_tpu.server.__main__ import build_parser as j_parser
    from limitador_tpu_torch.server.__main__ import build_parser

    port = set(vars(build_parser().parse_args(["x.yaml", "torch"])))
    jax = set(vars(j_parser().parse_args(["x.yaml", "tpu"])))
    assert port == (jax - {"tpu_capacity", "xla_cache_dir"}) | {
        "capacity", "device", "kernel_cache_dir"}
    assert {"capacity_controller", "ctl_interval", "ctl_sustain",
            "ctl_dwell", "ctl_standby", "ctl_min_hosts", "ctl_max_hosts",
            "ctl_grow_headroom", "ctl_shrink_headroom"} <= port


_GUARDED_POD = r'''
import importlib.abc, runpy, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "limitador_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
'''


def test_a_pod_member_imports_the_breaker_and_the_pod_modules(tmp_path):
    """Two port servers form a pod over a TCPStore and run the routed
    drive in processes that refuse ``jax`` and ``limitador_tpu``; each
    member imported the pod's modules and, with ``--pod-degraded-mode
    on`` (the default) and ``--admission-mode off``, the admission
    package, for the failover breaker alone (no admission controller)."""
    from .torch_pod_worker import spawn_pod

    results = spawn_pod(tmp_path, "memory", prefix=["-c", _GUARDED_POD])
    for result in results:
        assert result["modules"] == [
            "limitador_tpu_torch.admission",
            "limitador_tpu_torch.parallel.pod",
            "limitador_tpu_torch.server.peering",
        ]
        assert result["lane"]["pod_peer_errors"] == 0
        assert "admission" not in result["http"]["/debug/stats"]["body"]


def test_a_resize_armed_pod_member_imports_the_coordinator_alone(
        tmp_path):
    """With ``--pod-resize on`` a member imports ``server/resize.py``
    and not ``server/standby.py``, decides the routed drive as without
    it, and neither member imports ``jax`` or ``limitador_tpu``."""
    from .torch_pod_worker import drive_oracle, merge, spawn_pod

    results = spawn_pod(tmp_path, "memory", prefix=["-c", _GUARDED_POD],
                        pod_resize="on")
    merged, _counters, _routed = merge(results)
    want, _want_counters = drive_oracle()
    assert merged == want
    for result in results:
        assert result["modules"] == [
            "limitador_tpu_torch.admission",
            "limitador_tpu_torch.parallel.pod",
            "limitador_tpu_torch.server.peering",
            "limitador_tpu_torch.server.resize",
        ]
        assert result["lane"]["pod_peer_errors"] == 0
        assert result["lane"]["pod_resize_stale_rejects"] == 0


_STANDBY = r'''
import asyncio, importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "limitador_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
from limitador_tpu_torch.server import __main__ as m

async def main(argv):
    server = await m.start(m.build_parser().parse_args(argv))
    try:
        standby = server.pod.standby
        return (sorted(k for k in sys.modules
                       if k.startswith("limitador_tpu_torch.server.")
                       and k.rsplit(".", 1)[1] in ("peering", "resize",
                                                   "standby")),
                standby.ready, server.pod.lane.port > 0,
                server.pod.router.topology.hosts)
    finally:
        await server.stop()

print(asyncio.run(main(sys.argv[1:])))
'''


def test_a_standby_imports_the_coordinator_and_the_standby(tmp_path):
    """``--standby on`` boots a memberless warm standby (host 0 of 1,
    its peer lane serving) that imports ``server/resize.py`` and
    ``server/standby.py``, in a process that refuses ``jax`` and
    ``limitador_tpu``."""
    from .torch_http import LIMITS, free_port, port_argv

    limits = tmp_path / "limits.yaml"
    limits.write_text(LIMITS)
    argv = port_argv(limits, "memory", free_port(), "--standby", "on",
                     "--pod-peer-listen", "127.0.0.1:0")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", _STANDBY, *argv], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == str((
        ["limitador_tpu_torch.server.peering",
         "limitador_tpu_torch.server.resize",
         "limitador_tpu_torch.server.standby"], True, True, 1))


def test_a_native_ingress_pod_runs_without_jax_or_the_jax_package(
        tmp_path):
    """A 2-process pod serving ``--pipeline native --native-ingress``
    (the C hot lane's split by owner and the bulk forwards between the
    members) forms, answers the drive as the single-process table does
    and stops, in processes that refuse ``jax`` and ``limitador_tpu``."""
    from .torch_pod_worker import drive_oracle, merge, spawn_pod

    results = spawn_pod(tmp_path, "torch", prefix=["-c", _GUARDED_POD],
                        mode="ingress", timeout=180)
    merged, counters, _routed = merge(results)
    want, want_counters = drive_oracle(native=True)
    assert merged == want
    assert counters == want_counters
    for result in results:
        assert result["native_ingress"] and result["native_pipeline"]
        assert result["lane"]["pod_peer_errors"] == 0
        assert "limitador_tpu_torch.server.peering" in result["modules"]
        assert not [m for m in result["modules"]
                    if m.split(".")[0] in ("jax", "jaxlib",
                                           "limitador_tpu")]
    assert sum(r["lane"]["pod_bulk_forward_rows"] for r in results) > 0
