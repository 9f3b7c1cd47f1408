"""The port's gRPC server against the JAX package's, over real channels.

One request sequence goes, as raw protobuf bytes, to two servers running
in this process on free ports and one fake clock: the JAX package's
``serve_rls`` over ``AsyncTpuStorage``, and the port's server started
through its own entry point (``limitador_tpu_torch.server.__main__``,
storage ``torch`` with ``--device cpu``), both with draft-03 headers so
the responses carry remaining counts and resets. The serialized responses
must be byte-identical, and so must the final counters. The sequence has
ShouldRateLimit with ``hits_addend``, multi-descriptor requests, a token
bucket, Kuadrant CheckRateLimit and Report, and a hot reload through the
port's limits-file watcher.

A last test boots the CLI as a subprocess on the CPU and drives it past a
limit.
"""

import asyncio
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import grpc
import pytest

from limitador_tpu.core.limiter import AsyncRateLimiter as JAsyncRateLimiter
from limitador_tpu.server.limits_file import load_limits_file as j_load
from limitador_tpu.server.rls import serve_rls as j_serve_rls
from limitador_tpu.tpu.batcher import AsyncTpuStorage
from limitador_tpu.tpu.storage import TpuStorage
from limitador_tpu_torch.server import __main__ as port_main
from limitador_tpu_torch.server.proto import rls_pb2
from tests.torch_http import flight_spool  # noqa: F401 (autouse)
from tests.torch_http import reload_limits_file

REPO = Path(__file__).resolve().parent.parent
ENVOY = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
KUADRANT = "/kuadrant.service.ratelimit.v1.RateLimitService/"

LIMITS = """\
- namespace: api
  max_value: 5
  seconds: 60
  conditions: ["descriptors[0].method == 'GET'"]
  variables: ["descriptors[0].user"]
  name: per-user-get
- namespace: api
  max_value: 9
  seconds: 3600
  name: api-total
- namespace: api
  max_value: 6
  seconds: 30
  variables: ["descriptors[1].tenant"]
  name: per-tenant
- namespace: tb
  max_value: 4
  seconds: 2
  variables: ["descriptors[0].user"]
  policy: token_bucket
  name: bucket
"""

RELOADED = """\
- namespace: api
  max_value: 7
  seconds: 60
  conditions: ["descriptors[0].method == 'GET'"]
  variables: ["descriptors[0].user"]
  name: per-user-get
- namespace: api
  max_value: 6
  seconds: 30
  variables: ["descriptors[1].tenant"]
  name: per-tenant
- namespace: tb
  max_value: 4
  seconds: 2
  variables: ["descriptors[0].user"]
  policy: token_bucket
  name: bucket
- namespace: tb
  max_value: 2
  seconds: 10
  name: tb-total
"""


class FakeClock:
    def __init__(self):
        self.now = 1_700_000_000.0

    def __call__(self):
        return self.now


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(domain, descriptors, hits_addend=0) -> bytes:
    req = rls_pb2.RateLimitRequest(domain=domain, hits_addend=hits_addend)
    for entries in descriptors:
        d = req.descriptors.add()
        for k, v in entries.items():
            d.entries.add(key=k, value=v)
    return req.SerializeToString()


def _sequence():
    """(method, request bytes, clock advance before it) steps."""
    get_a = [{"method": "GET", "user": "a"}, {"tenant": "t1"}]
    get_b = [{"method": "GET", "user": "b"}, {"tenant": "t1"}]
    post_a = [{"method": "POST", "user": "a"}, {"tenant": "t2"}]
    steps = []
    for i in range(7):
        steps.append(("ShouldRateLimit", _request("api", get_a), 0.0))
    steps.append(("ShouldRateLimit", _request("api", get_b, 3), 0.25))
    steps.append(("ShouldRateLimit", _request("api", post_a, 2), 0.0))
    steps.append((KUADRANT + "CheckRateLimit", _request("api", get_b), 0.0))
    steps.append((KUADRANT + "Report", _request("api", get_b, 2), 0.0))
    steps.append((KUADRANT + "CheckRateLimit", _request("api", get_b), 0.1))
    steps.append(("ShouldRateLimit", _request("", get_a), 0.0))  # UNKNOWN
    for i in range(6):
        steps.append(("ShouldRateLimit",
                      _request("tb", [{"user": "u"}], 1 + i % 2), 0.3))
    steps.append((KUADRANT + "Report", _request("tb", [{"user": "u"}], 3),
                  0.0))
    steps.append((KUADRANT + "CheckRateLimit",
                  _request("tb", [{"user": "u"}]), 0.0))
    steps.append(("ShouldRateLimit", _request("api", get_a), 31.0))
    return steps


async def _call(channel, method, blob):
    path = ENVOY if method == "ShouldRateLimit" else method
    return await channel.unary_unary(path)(blob, timeout=30)


async def _counters(limiter, namespaces):
    out = {}
    for ns in namespaces:
        for c in await limiter.get_counters(ns):
            out[(ns, c.limit.name, tuple(c.set_variables.items()))] = (
                c.remaining, c.expires_in)
    return out


async def _wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "timed out"
        await asyncio.sleep(0.05)


async def _parity(tmp_path):
    clock = FakeClock()
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(LIMITS)

    j_limiter = JAsyncRateLimiter(
        AsyncTpuStorage(TpuStorage(capacity=1 << 12, clock=clock))
    )
    await j_limiter.configure_with(j_load(str(limits_path)))
    j_port = _free_port()
    j_server = await j_serve_rls(
        j_limiter, f"127.0.0.1:{j_port}",
        rate_limit_headers="DRAFT_VERSION_03",
    )
    p_port = _free_port()
    args = port_main.build_parser().parse_args([
        str(limits_path), "torch", "--device", "cpu", "--capacity",
        str(1 << 12), "--rls-host", "127.0.0.1", "--rls-port", str(p_port),
        "--http-port", str(_free_port()),
        "--rate-limit-headers", "DRAFT_VERSION_03",
    ])
    p_server = await port_main.start(args, clock=clock)
    try:
        async with grpc.aio.insecure_channel(f"127.0.0.1:{j_port}") as jc, \
                grpc.aio.insecure_channel(f"127.0.0.1:{p_port}") as pc:
            for phase in ("before", "after"):
                for i, (method, blob, advance) in enumerate(_sequence()):
                    clock.now += advance
                    want = await _call(jc, method, blob)
                    got = await _call(pc, method, blob)
                    assert got == want, (
                        phase, i, method,
                        rls_pb2.RateLimitResponse.FromString(got),
                        rls_pb2.RateLimitResponse.FromString(want))
                if phase == "before":
                    # Hot reload: the port through its file watcher, the
                    # reference through configure_with.
                    reload_limits_file(limits_path, RELOADED)
                    await j_limiter.configure_with(j_load(str(limits_path)))
                    await _wait_for(
                        lambda: p_server.status["limits_file_version"] == 2
                        and any(l.name == "tb-total" for l in
                                p_server.limiter.get_limits("tb")))
            namespaces = ("api", "tb")
            assert await _counters(p_server.limiter, namespaces) == \
                await _counters(j_limiter, namespaces)
    finally:
        await p_server.stop()
        await j_server.stop(grace=None)
        await j_limiter.storage.counters.close()


def test_port_server_answers_byte_identically_to_the_jax_server(tmp_path):
    asyncio.run(_parity(tmp_path))


def test_cli_serves_on_the_cpu_and_limits(tmp_path):
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(LIMITS)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "limitador_tpu_torch.server",
         str(limits_path), "torch", "--device", "cpu", "--capacity", "1024",
         "--rls-host", "127.0.0.1",
         "--http-port", str(_free_port()), "--rls-port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        grpc.channel_ready_future(channel).result(timeout=60)
        call = channel.unary_unary(ENVOY)
        blob = _request("api", [{"method": "GET", "user": "z"},
                                {"tenant": "t9"}])
        codes = [
            rls_pb2.RateLimitResponse.FromString(
                call(blob, timeout=30)).overall_code
            for _ in range(7)
        ]
        ok, over = rls_pb2.RateLimitResponse.OK, \
            rls_pb2.RateLimitResponse.OVER_LIMIT
        assert codes == [ok] * 5 + [over] * 2
        channel.close()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out.decode(errors="replace")


def test_cli_refuses_the_card_without_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(LIMITS)
    proc = subprocess.run(
        [sys.executable, "-m", "limitador_tpu_torch.server",
         str(limits_path), "torch", "--http-port", str(_free_port()),
         "--rls-port", str(_free_port())],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2
    assert "CUDA" in proc.stderr


# -- the native pipeline (C++ host lane) --------------------------------------


NATIVE_LIMITS = LIMITS + """\
- namespace: nat
  max_value: 5
  seconds: 60
  conditions: ["descriptors[0].method == 'GET'"]
  variables: ["descriptors[0].user"]
  name: nat-per-user
- namespace: nat
  max_value: 12
  seconds: 600
  name: nat-total
"""


def _native_sequence():
    """ShouldRateLimit steps the native lanes take (one descriptor on a
    vectorizable namespace: the hot lane and the miss lane), steps they
    hand to the exact path (two descriptors, or a namespace with a
    ``descriptors[1]`` variable), and Kuadrant steps, which stay on the
    standard handlers."""
    steps = []
    for i in range(8):
        for user in ("n1", "n2"):
            steps.append(("ShouldRateLimit", _request(
                "nat", [{"method": "GET", "user": user}]), 0.0))
    steps.extend(_sequence())
    for i in range(6):
        steps.append(("ShouldRateLimit",
                      _request("tb", [{"user": "v"}], 1 + i % 2), 0.3))
    return steps


async def _native_vs_oracle(tmp_path, extra):
    clock = FakeClock()
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(NATIVE_LIMITS)
    ports = (_free_port(), _free_port())
    parse = port_main.build_parser().parse_args
    common = ["--rls-host", "127.0.0.1"]
    native = await port_main.start(parse(
        [str(limits_path), "torch", "--device", "cpu", "--capacity", "1024",
         "--pipeline", "native", "--http-port", str(_free_port()),
         "--rls-port", str(ports[0]), *common, *extra]), clock=clock)
    oracle = await port_main.start(parse(
        [str(limits_path), "memory", "--http-port", str(_free_port()),
         "--rls-port", str(ports[1]), *common]),
        clock=clock)
    try:
        assert native.native_pipeline is not None
        assert native.native_pipeline.hot_lane_active
        async with grpc.aio.insecure_channel(f"127.0.0.1:{ports[0]}") as nc, \
                grpc.aio.insecure_channel(f"127.0.0.1:{ports[1]}") as oc:
            for i, (method, blob, advance) in enumerate(_native_sequence()):
                clock.now += advance
                got = await _call(nc, method, blob)
                want = await _call(oc, method, blob)
                assert got == want, (i, method)
        namespaces = ("api", "tb", "nat")
        got = await _counters(native.limiter, namespaces)
        want = {}
        for ns in namespaces:
            for c in oracle.limiter.get_counters(ns):
                want[(ns, c.limit.name, tuple(c.set_variables.items()))] = (
                    c.remaining, c.expires_in)
        assert got.keys() == want.keys()
        for key in got:
            assert got[key][0] == want[key][0], key
            assert abs(got[key][1] - want[key][1]) <= 0.002, key
        assert native.native_pipeline.lane_stats()["hits"] > 0
        return native
    finally:
        await native.stop()
        await oracle.stop()


def test_native_pipeline_server_answers_like_the_oracle(tmp_path):
    server = asyncio.run(_native_vs_oracle(
        tmp_path, ["--usage-topk", "64", "--usage-drain-interval", "0.05"]))
    assert server.observatory is not None
    assert server.native_pipeline.lease_broker is None


def test_native_pipeline_server_with_leases_answers_like_the_oracle(tmp_path):
    """The server comes up with its lease broker running and answers
    exactly: a grant is pre-debited, so within a window leased answers
    equal the oracle's (the grants themselves are driven by
    test_torch_lease.py)."""
    server = asyncio.run(_native_vs_oracle(
        tmp_path, ["--lease-mode", "on", "--native-hot-lane", "on"]))
    assert server.native_pipeline.lease_broker is not None


def test_native_pipeline_with_a_broken_host_lane_exits(tmp_path,
                                                       monkeypatch):
    """A host lane that does not build stops the server: it does not
    serve the compiled pipeline instead."""
    from limitador_tpu_torch.native import build

    broken = tmp_path / "hostpath.cc"
    broken.write_text("not C++\n")
    monkeypatch.setattr(build, "SOURCE", broken)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_lib", None)
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(LIMITS)
    argv = [str(limits_path), "torch", "--device", "cpu", "--capacity",
            "1024", "--pipeline", "native", "--rls-host", "127.0.0.1",
            "--http-port", str(_free_port()), "--rls-port", str(_free_port())]
    with pytest.raises(build.BuildError):
        asyncio.run(port_main.start(port_main.build_parser().parse_args(
            argv)))
    assert port_main.main(argv) == 2


@pytest.mark.parametrize("argv", [
    ["torch", "--device", "cpu", "--lease-mode", "on"],
    ["torch", "--device", "cpu", "--pipeline", "native", "--lease-mode",
     "on", "--native-hot-lane", "off"],
    ["torch", "--device", "cpu", "--pipeline", "native",
     "--plan-cache-size", "0"],
    ["memory", "--pipeline", "native"],
    ["memory", "--pipeline", "compiled"],
    ["torch", "--device", "cpu", "--pipeline", "native",
     "--rate-limit-headers", "DRAFT_VERSION_03"],
    # a replicated node refuses the paths that launch the plain check
    ["torch", "--device", "cpu", "--pipeline", "native", "--peer",
     "127.0.0.1:9"],
    ["torch", "--device", "cpu", "--pipeline", "native",
     "--listen-address", "127.0.0.1:0"],
    ["torch", "--device", "cpu", "--pipeline", "native", "--lease-mode",
     "on", "--listen-address", "127.0.0.1:0"],
    ["memory", "--peer", "127.0.0.1:9"],
    ["memory", "--snapshot-path", "never-written.ckpt"],
    # sharded storage refuses what the JAX server degrades there
    ["sharded", "--device", "cpu", "--pipeline", "native"],
    ["sharded", "--device", "cpu", "--tier-mode", "on"],
    ["sharded", "--device", "cpu", "--lease-mode", "on"],
    ["sharded", "--device", "cpu", "--peer", "127.0.0.1:9"],
    ["sharded", "--device", "cpu", "--listen-address", "127.0.0.1:0"],
    # span export without the opentelemetry API, an HTTP port already
    # bound, a label map that is not a map or a labels file not there
    ["memory", "--tracing-endpoint", "http://127.0.0.1:4318"],
    ["torch", "--device", "cpu", "--http-port", "BOUND"],
    ["memory", "--http-port", "BOUND"],
    ["memory", "--metric-labels", "descriptors[0].user"],
    ["memory", "--metric-labels-file", "no-such-labels.cel"],
    # the write-behind options on the wrong storage, an authority over a
    # storage without apply_deltas, a disk file that cannot be opened
    ["memory", "--authority-url", "127.0.0.1:9"],
    ["disk", "--disk-path", "MISSING", "--authority-url", "127.0.0.1:9"],
    ["torch", "--device", "cpu", "--authority-url", "127.0.0.1:9"],
    ["distributed", "--authority-url", "127.0.0.1:9"],
    ["distributed", "--listen-address", "127.0.0.1:0", "--authority-listen",
     "127.0.0.1:0"],
    ["cached", "--disk-path", "MISSING", "--authority-listen",
     "127.0.0.1:0"],
    ["disk", "--disk-path", "MISSING"],
    ["cached", "--disk-path", "MISSING"],
    # the host storages refuse what needs a device table
    ["disk", "--disk-path", "MISSING", "--pipeline", "compiled"],
    ["cached", "--disk-path", "MISSING", "--tier-mode", "on"],
    ["distributed", "--listen-address", "127.0.0.1:0", "--pipeline",
     "native"],
    ["disk", "--disk-path", "MISSING", "--peer", "127.0.0.1:9"],
    ["cached", "--disk-path", "MISSING", "--snapshot-path",
     "never-written.ckpt"],
])
def test_modes_that_cannot_come_up_exit(tmp_path, monkeypatch, argv):
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(LIMITS)
    # an import of opentelemetry raises ImportError
    monkeypatch.setitem(sys.modules, "opentelemetry", None)
    missing = str(tmp_path / "no-such-dir" / "counters.db")
    with socket.socket() as bound:
        bound.bind(("127.0.0.1", 0))
        bound.listen()
        argv = [str(bound.getsockname()[1]) if a == "BOUND" else
                missing if a == "MISSING" else a for a in argv]
        if "--http-port" not in argv:
            argv += ["--http-port", str(_free_port())]
        assert port_main.main([str(limits_path), *argv, "--rls-host",
                               "127.0.0.1", "--http-host", "127.0.0.1",
                               "--rls-port", str(_free_port())]) == 2


@pytest.mark.parametrize("tier", ["usage", "lease"])
def test_a_failing_background_tier_stops_the_server(tmp_path, monkeypatch,
                                                    tier):
    """A usage drain or lease refresh that fails while serving stops the
    server with exit code 1 instead of serving on without it."""
    from limitador_tpu_torch.device.storage import TorchStorage
    from limitador_tpu_torch.lease.broker import LeaseBroker

    def broken(*_args, **_kwargs):
        raise RuntimeError("kernel failed to launch")

    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(LIMITS)
    argv = [str(limits_path), "torch", "--device", "cpu", "--capacity",
            "1024", "--pipeline", "native", "--rls-host", "127.0.0.1",
            "--http-port", str(_free_port()), "--rls-port", str(_free_port())]
    if tier == "usage":
        monkeypatch.setattr(TorchStorage, "drain_hot_slots", broken)
        argv += ["--usage-drain-interval", "0.05"]
    else:
        monkeypatch.setattr(LeaseBroker, "refresh", broken)
        argv += ["--lease-mode", "on", "--usage-topk", "0"]
    args = port_main.build_parser().parse_args(argv)
    assert asyncio.run(asyncio.wait_for(port_main._amain(args), 30)) == 1


# -- replication and snapshots -------------------------------------------------

REPLICATED_LIMITS = """\
- namespace: rep
  max_value: 4
  seconds: 3600
  variables: ["descriptors[0].user"]
  name: per-user
"""


def _response_code(blob):
    return rls_pb2.RateLimitResponse.FromString(blob).overall_code


async def _replicated_pair(tmp_path, extra=()):
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(REPLICATED_LIMITS)
    gossip = [_free_port(), _free_port()]
    servers = []
    for i, name in enumerate("ab"):
        argv = [str(limits_path), "torch", "--device", "cpu", "--capacity",
                "1024", "--rls-host", "127.0.0.1",
                "--http-port", str(_free_port()), "--rls-port",
                str(_free_port()), "--node-id", name, "--listen-address",
                f"127.0.0.1:{gossip[i]}", "--peer",
                f"127.0.0.1:{gossip[1 - i]}", *extra]
        servers.append((await port_main.start(
            port_main.build_parser().parse_args(argv)), argv))
    return servers


def _serve_a_converging_pair(tmp_path, limiter_type, extra=()):
    """Hits and a Kuadrant Report served by either node of a replicated
    pair reach the other through the gossip broker."""
    from limitador_tpu_torch.device.replicated import TorchReplicatedStorage

    async def drive():
        servers = await _replicated_pair(tmp_path, extra)
        try:
            for server, _argv in servers:
                assert isinstance(server.limiter, limiter_type)
                assert isinstance(server.storage, TorchReplicatedStorage)
                assert server.storage.broker is not None
            ports = [argv[argv.index("--rls-port") + 1]
                     for _s, argv in servers]
            chans = [grpc.aio.insecure_channel(f"127.0.0.1:{p}")
                     for p in ports]
            hit = _request("rep", [{"user": "u"}])
            report = _request("rep", [{"user": "u"}], 1)
            ok = rls_pb2.RateLimitResponse.OK
            over = rls_pb2.RateLimitResponse.OVER_LIMIT
            assert _response_code(await _call(chans[0], "ShouldRateLimit",
                                              hit)) == ok
            await _call(chans[1], KUADRANT + "Report", report)
            # 2 of 4 spent across the nodes: both views say 2 remain
            deadline = time.monotonic() + 10
            while True:
                counters = [await _counters(s.limiter, ["rep"])
                            for s, _a in servers]
                if all(c and next(iter(c.values()))[0] == 2
                       for c in counters):
                    break
                assert time.monotonic() < deadline, counters
                await asyncio.sleep(0.05)
            assert _response_code(await _call(chans[1], "ShouldRateLimit",
                                              hit)) == ok
            assert _response_code(await _call(chans[0], "ShouldRateLimit",
                                              hit)) == ok
            deadline = time.monotonic() + 10
            while True:
                codes = [_response_code(await _call(
                    c, KUADRANT + "CheckRateLimit", hit)) for c in chans]
                if codes == [over, over]:
                    break
                assert time.monotonic() < deadline, codes
                await asyncio.sleep(0.05)
            for chan in chans:
                await chan.close()
        finally:
            for server, _argv in servers:
                await server.stop()

    asyncio.run(drive())


def test_peer_options_build_a_replicated_node_that_converges(tmp_path):
    """--listen-address/--peer build TorchReplicatedStorage behind the
    standard pipeline; the nodes converge."""
    from limitador_tpu_torch.core.limiter import AsyncRateLimiter

    _serve_a_converging_pair(tmp_path, AsyncRateLimiter)


def test_the_compiled_pipeline_serves_a_replicated_node(tmp_path):
    """--pipeline compiled launches through the storage's check dispatch,
    so on a replicated node it admits against the remote share and its
    admitted counters gossip: the pair converges as on the standard
    pipeline."""
    from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter

    _serve_a_converging_pair(tmp_path, CompiledTorchLimiter,
                             ["--pipeline", "compiled"])


@pytest.mark.parametrize("replicated", [False, True],
                         ids=["table", "replicated"])
def test_snapshot_restores_the_counters_after_a_restart(tmp_path,
                                                        replicated):
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(REPLICATED_LIMITS)
    path = tmp_path / "counters.ckpt"
    argv = [str(limits_path), "torch", "--device", "cpu", "--capacity",
            "1024", "--rls-host", "127.0.0.1", "--snapshot-path", str(path),
            "--snapshot-period", "0.05"]
    if replicated:
        argv += ["--node-id", "a", "--listen-address",
                 f"127.0.0.1:{_free_port()}"]

    async def serve(hits):
        rls_port = _free_port()
        server = await port_main.start(port_main.build_parser().parse_args(
            argv + ["--http-port", str(_free_port()),
                    "--rls-port", str(rls_port)]))
        try:
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{rls_port}") as chan:
                for _ in range(hits):
                    await _call(chan, "ShouldRateLimit",
                                _request("rep", [{"user": "s"}]))
                await asyncio.sleep(0.2)  # a periodic checkpoint or two
                assert path.exists()
            return await _counters(server.limiter, ["rep"])
        finally:
            await server.stop()

    first = asyncio.run(serve(3))
    assert [v[0] for v in first.values()] == [1]
    again = asyncio.run(serve(0))
    assert [v[0] for v in again.values()] == [1]


def test_a_restarted_node_loads_its_snapshot_before_it_gossips(
        tmp_path, monkeypatch):
    """On a restart with --snapshot-path and a live peer, the checkpoint
    loads before the broker starts, so the peer's re-sync merges into
    the loaded slot table: both nodes count the restored hits and the
    peer's."""
    from limitador_tpu_torch.device.replicated import TorchReplicatedStorage

    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(REPLICATED_LIMITS)
    path = tmp_path / "a.ckpt"
    gossip = [_free_port(), _free_port()]

    def argv(i, *extra):
        return [str(limits_path), "torch", "--device", "cpu", "--capacity",
                "1024", "--rls-host", "127.0.0.1",
                "--http-port", str(_free_port()), "--rls-port",
                str(_free_port()), "--node-id", "ab"[i], "--listen-address",
                f"127.0.0.1:{gossip[i]}", *extra]

    async def boot(args):
        server = await port_main.start(port_main.build_parser().parse_args(
            args))
        return server, args[args.index("--rls-port") + 1]

    async def hit(port, user, n):
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as chan:
            for _ in range(n):
                await _call(chan, "ShouldRateLimit",
                            _request("rep", [{"user": user}]))

    def remaining(counters):
        return {k[2][0][1]: v[0] for k, v in counters.items()}

    loaded_before_start = []
    load = TorchReplicatedStorage.load_snapshot

    def spy(self, snapshot_path):
        loaded_before_start.append(self._gossip_thread is None)
        return load(self, snapshot_path)

    monkeypatch.setattr(TorchReplicatedStorage, "load_snapshot", spy)

    async def drive():
        snap = ["--snapshot-path", str(path), "--snapshot-period", "0.05"]
        a, a_port = await boot(argv(0, *snap))
        try:
            await hit(a_port, "s", 3)
        finally:
            await a.stop()
        assert path.exists() and loaded_before_start == []
        b, b_port = await boot(argv(1))
        a = None
        try:
            await hit(b_port, "p", 2)
            a, _ = await boot(argv(0, *snap, "--peer",
                                    f"127.0.0.1:{gossip[1]}"))
            assert loaded_before_start == [True]
            want = {"s": 1, "p": 2}
            deadline = time.monotonic() + 10
            while True:
                views = [remaining(await _counters(n.limiter, ["rep"]))
                         for n in (a, b)]
                if views == [want, want]:
                    break
                assert time.monotonic() < deadline, views
                await asyncio.sleep(0.05)
        finally:
            if a is not None:
                await a.stop()
            await b.stop()

    asyncio.run(drive())


def test_an_unreadable_snapshot_is_moved_aside(tmp_path):
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(REPLICATED_LIMITS)
    path = tmp_path / "counters.ckpt"
    path.write_bytes(b"not a checkpoint")
    args = port_main.build_parser().parse_args([
        str(limits_path), "torch", "--device", "cpu", "--capacity", "1024",
        "--rls-host", "127.0.0.1",
        "--http-port", str(_free_port()), "--rls-port", str(_free_port()),
        "--snapshot-path", str(path)])

    async def boot():
        server = await port_main.start(args)
        await server.stop()

    asyncio.run(boot())
    assert (tmp_path / "counters.ckpt.rejected").read_bytes() == \
        b"not a checkpoint"
    assert path.exists()  # the final checkpoint of the fresh table


# -- sharded storage ----------------------------------------------------------


async def _sharded_vs_memory(tmp_path, extra):
    """A ``sharded --device cpu`` server (one row on the CPU, ``api`` a
    global namespace) and a memory server on one clock: the same
    sequence, a hot reload and the reloaded sequence give byte-identical
    answers and the same counters."""
    clock = FakeClock()
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(LIMITS)
    ports = (_free_port(), _free_port())
    parse = port_main.build_parser().parse_args
    common = ["--rls-host", "127.0.0.1"]
    sharded = await port_main.start(parse(
        [str(limits_path), "sharded", "--device", "cpu", "--capacity",
         "1024", "--global-namespaces", "api", "--global-region", "64",
         "--usage-drain-interval", "0.05",
         "--http-port", str(_free_port()), "--rls-port", str(ports[0]),
         *common, *extra]), clock=clock)
    oracle = await port_main.start(parse(
        [str(limits_path), "memory", "--http-port", str(_free_port()),
         "--rls-port", str(ports[1]), *common]),
        clock=clock)
    try:
        storage = sharded.storage
        assert type(storage).__name__ == "TorchShardedStorage"
        assert storage.n_shards == 1
        async with grpc.aio.insecure_channel(f"127.0.0.1:{ports[0]}") as sc, \
                grpc.aio.insecure_channel(f"127.0.0.1:{ports[1]}") as oc:
            for phase in ("before", "after"):
                for i, (method, blob, advance) in enumerate(_sequence()):
                    clock.now += advance
                    got = await _call(sc, method, blob)
                    want = await _call(oc, method, blob)
                    assert got == want, (phase, i, method)
                if phase == "before":
                    reload_limits_file(limits_path, RELOADED)
                    await _wait_for(
                        lambda: sharded.status["limits_file_version"] == 2
                        and oracle.status["limits_file_version"] == 2)
        namespaces = ("api", "tb")
        got = await _counters(sharded.limiter, namespaces)
        want = {}
        for ns in namespaces:
            for c in oracle.limiter.get_counters(ns):
                want[(ns, c.limit.name, tuple(c.set_variables.items()))] = (
                    c.remaining, c.expires_in)
        assert got.keys() == want.keys()
        for key in got:
            assert got[key][0] == want[key][0], key
            assert abs(got[key][1] - want[key][1]) <= 0.002, key
        launches = storage.launch_stats()["sharded_launches"]
        assert launches["global"] > 0
        await _wait_for(lambda: sharded.observatory.tenant_usage()["drains"]
                        > 0)
        return sharded
    finally:
        await sharded.stop()
        await oracle.stop()


@pytest.mark.parametrize("pipeline", ["standard", "compiled"])
def test_sharded_server_answers_like_a_memory_server(tmp_path, pipeline):
    server = asyncio.run(_sharded_vs_memory(tmp_path,
                                            ["--pipeline", pipeline]))
    assert server.observatory is not None
    assert server.native_pipeline is None


def test_a_sharded_snapshot_overrides_the_command_line_with_warnings(
        tmp_path, caplog):
    from limitador_tpu_torch import Context, Limit, RateLimiter
    from limitador_tpu_torch.device.sharded import TorchShardedStorage

    clock = FakeClock()
    path = str(tmp_path / "sharded.ckpt")
    saved = TorchShardedStorage(n_shards=1, local_capacity=512,
                                global_region=16, global_namespaces=["g"],
                                clock=clock, device="cpu")
    limiter = RateLimiter(saved)
    limiter.add_limit(Limit("g", 5, 60, [], ["u"]))
    for _ in range(3):
        limiter.check_rate_limited_and_update("g", Context({"u": "a"}), 1)
    saved.snapshot(path)
    args = port_main.build_parser().parse_args([
        str(tmp_path / "limits.yaml"), "sharded", "--device", "cpu",
        "--capacity", "1024", "--global-region", "32",
        "--global-namespaces", "h", "--snapshot-path", path])
    with caplog.at_level("WARNING", logger="limitador_tpu_torch"):
        storage = port_main.build_sharded_storage(args, clock)
    warned = [r.getMessage() for r in caplog.records
              if "overrides the command line" in r.getMessage()]
    assert len(warned) == 3, warned
    for flag in ("--capacity", "--global-region", "--global-namespaces"):
        assert any(flag in w for w in warned), flag
    assert (storage._local_capacity, storage._global_region,
            storage._global_ns) == (512, 16, {"g"})
    restored = RateLimiter(storage)
    restored.add_limit(Limit("g", 5, 60, [], ["u"]))
    assert [c.remaining for c in restored.get_counters("g")] == [2]


def test_validate_checks_the_limits_file_and_exits(tmp_path, capsys):
    good = tmp_path / "limits.yaml"
    good.write_text(LIMITS)
    assert port_main.main([str(good), "--validate"]) == 0
    assert capsys.readouterr().out == "OK: 4 limits\n"
    bad = tmp_path / "bad.yaml"
    bad.write_text("- namespace: api\n  max_value: nope\n")
    assert port_main.main([str(bad), "--validate"]) == 1
