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
  ``--admission-mode`` is not ``off``.
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

async def main(tmp):
    limits = os.path.join(tmp, "limits.yaml")
    with open(limits, "w") as f:
        f.write("- namespace: ns\n  max_value: 1\n  seconds: 60\n"
                '  variables: ["descriptors[0].u"]\n')
    port = free()
    server = await m.start(m.build_parser().parse_args([
        limits, "torch", "--device", "cpu", "--capacity", "64",
        "--pipeline", "native", "--native-ingress", "--rls-host",
        "127.0.0.1", "--rls-port", str(port), "--http-host", "127.0.0.1",
        "--http-port", str(free()), "--flight-spool-dir",
        os.path.join(tmp, "flight")]))
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
                server.admission is not None)
    finally:
        await server.stop()

print(asyncio.run(main(sys.argv[1:])))
'''


@pytest.mark.parametrize("mode", ["off", "enforce"])
def test_the_admission_package_is_imported_only_when_asked_for(tmp_path,
                                                               mode):
    """A server started with ``--admission-mode off`` (the default)
    never imports ``limitador_tpu_torch.admission``; with ``enforce`` it
    builds the controller."""
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
    assert proc.stdout.strip().splitlines()[-1] == str((on, on))
