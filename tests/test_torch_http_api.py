"""The port's HTTP API against the JAX package's, over real sockets.

One request sequence (``tests/torch_http.py``: check-and-report with and
without draft-03 headers, check, report, fixed windows and token
buckets, clock steps past a window, bad bodies, a negative delta and a
hot reload) goes to servers in this process on free ports and one fake
clock:

- the JAX package's ``run_http_server`` over
  ``AsyncRateLimiter(AsyncTpuStorage(TpuStorage))`` against the port's
  server from ``server.start`` (``torch --device cpu``);
- the same on memory storage;
- the port's sharded (``--global-namespaces``) and tiered servers
  against a memory server of the port.

Statuses, ``X-RateLimit-*`` headers and answer bodies must be equal at
every step, and so must the JSON bodies of ``/limits``, ``/counters``
and ``/status``. The cases of the JAX package's ``TestHttpApi`` and its
request-id tests run against the port, and ``/debug/stats`` and
``/debug/tiering`` carry the JAX package's keys for the sections the
port serves.
"""

import asyncio
import json

import grpc
import pytest

from limitador_tpu.core.limiter import AsyncRateLimiter as JAsyncRateLimiter
from limitador_tpu.core.limiter import RateLimiter as JRateLimiter
from limitador_tpu.observability.device_plane import (
    collect_debug_stats as j_collect_debug_stats,
)
from limitador_tpu.observability.usage import (
    TenantUsageObservatory as JObservatory,
)
from limitador_tpu.server.http_api import run_http_server as j_run_http
from limitador_tpu.server.limits_file import load_limits_file as j_load
from limitador_tpu.storage.in_memory import InMemoryStorage as JInMemory
from limitador_tpu.tier import TieredStorage as JTieredStorage
from limitador_tpu.tier import TierManager as JTierManager
from limitador_tpu.tpu.batcher import AsyncTpuStorage
from limitador_tpu.tpu.storage import TpuStorage
from limitador_tpu_torch.server import __main__ as port_main
from limitador_tpu_torch.server.http_api import DEBUG_STATS_SECTIONS
from limitador_tpu_torch.server.proto import rls_pb2
from tests import torch_http as H

parse = port_main.build_parser().parse_args


async def _pair(tmp_path, storage):
    """The JAX server and the port's, both on ``storage`` (torch/tpu or
    memory), through the whole sequence."""
    clock = H.FakeClock()
    limits_path = tmp_path / f"{storage}.yaml"
    limits_path.write_text(H.LIMITS)
    if storage == "torch":
        j_limiter = JAsyncRateLimiter(
            AsyncTpuStorage(TpuStorage(capacity=4096, clock=clock)))
        await j_limiter.configure_with(j_load(str(limits_path)))
    else:
        j_limiter = JRateLimiter(JInMemory(clock=clock))
        j_limiter.configure_with(j_load(str(limits_path)))
    j_status = {"limits_file_version": 1, "limits_file_errors": 0}
    j_port, p_port = H.free_port(), H.free_port()
    j_runner = await j_run_http(j_limiter, "127.0.0.1", j_port, None,
                                j_status)
    server = await port_main.start(
        parse(H.port_argv(limits_path, storage, p_port)), clock=clock)

    async def reload():
        H.reload_limits_file(limits_path)
        applied = j_limiter.configure_with(j_load(str(limits_path)))
        if asyncio.iscoroutine(applied):
            await applied
        j_status["limits_file_version"] += 1
        await H.wait_for(lambda: server.status["limits_file_version"] == 2
                         and any(l.name == "tb-total" for l in
                                 server.limiter.get_limits("tb")))

    try:
        return await H.drive(clock, {
            "jax": f"http://127.0.0.1:{j_port}",
            "port": f"http://127.0.0.1:{p_port}",
        }, reload)
    finally:
        await server.stop()
        await j_runner.cleanup()
        if storage == "torch":
            await j_limiter.storage.counters.close()


@pytest.fixture(scope="module", params=["torch", "memory"])
def pair(request, tmp_path_factory):
    return asyncio.run(_pair(tmp_path_factory.mktemp("pair"), request.param))


async def _topologies(tmp_path):
    """A memory server, a sharded server and a tiered server of the port,
    plus what /debug/stats and /debug/tiering answer on the last two."""
    clock = H.FakeClock()
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(H.LIMITS)
    argv = {
        "memory": ("memory",),
        "sharded": ("sharded", "--global-namespaces", "tb",
                    "--global-region", "64"),
        "tiered": ("torch", "--tier-mode", "on", "--cache-size", "3",
                   "--tier-migrate-interval", "0.05"),
    }
    ports = {name: H.free_port() for name in argv}
    servers = {}
    debug = {}
    try:
        for name, (storage, *extra) in argv.items():
            servers[name] = await port_main.start(parse(H.port_argv(
                limits_path, storage, ports[name], *extra)), clock=clock)

        async def reload():
            H.reload_limits_file(limits_path)
            await H.wait_for(lambda: all(
                s.status["limits_file_version"] == 2
                and any(l.name == "tb-total" for l in
                        s.limiter.get_limits("tb"))
                for s in servers.values()))

        async def extra(session, name, base):
            for path in ("/debug/stats", "/debug/tiering", "/debug/top"):
                async with session.get(base + path) as resp:
                    debug[name, path] = (resp.status, await resp.json())

        out = await H.drive(clock, {
            name: f"http://127.0.0.1:{port}" for name, port in ports.items()
        }, reload, extra)
        out["debug"] = debug
        return out
    finally:
        for server in servers.values():
            await server.stop()


@pytest.fixture(scope="module")
def topologies(tmp_path_factory):
    return asyncio.run(_topologies(tmp_path_factory.mktemp("topologies")))


# -- the port against the JAX package ---------------------------------------


def test_answers_equal_the_jax_server(pair):
    jax, port = pair["jax"]["steps"], pair["port"]["steps"]
    assert len(jax) == len(port) == 2 * len(H.sequence())
    for i, (want, got) in enumerate(zip(jax, port)):
        assert got == want, (i, got, want)


def test_sequence_covers_limits_headers_and_bad_bodies(pair):
    statuses = [status for status, _h, _b in pair["port"]["steps"]]
    assert {200, 429, 400} <= set(statuses)
    assert statuses.count(400) == 8
    assert any("X-RateLimit-Remaining" in h
               for _s, h, _b in pair["port"]["steps"])


def test_limits_bodies_equal(pair):
    assert pair["port"]["limits"] == pair["jax"]["limits"]
    names = {l["name"] for l in pair["port"]["limits"]["tb"]}
    assert names == {"bucket", "tb-total"}


def test_counters_bodies_equal(pair):
    assert pair["port"]["counters"] == pair["jax"]["counters"]
    assert pair["port"]["counters"]["api"] and pair["port"]["counters"]["tb"]


def test_status_bodies_equal(pair):
    assert pair["port"]["status"] == pair["jax"]["status"] == {
        "status": "ok", "limits_file_version": 2, "limits_file_errors": 0}


# -- the port's topologies against its memory server -------------------------


def _reset_departures(memory_steps, tiered_steps):
    """Steps where the two answers differ only in ``X-RateLimit-Reset``,
    the memory server answering 0 and the tiered one a whole window."""
    out = []
    for i, (want, got) in enumerate(zip(memory_steps, tiered_steps)):
        if got == want:
            continue
        (ws, wh, wb), (gs, gh, gb) = want, got
        assert (ws, wb) == (gs, gb), (i, got, want)
        assert {k: v for k, v in wh.items() if k != "X-RateLimit-Reset"} \
            == {k: v for k, v in gh.items() if k != "X-RateLimit-Reset"}, i
        assert wh["X-RateLimit-Reset"] == "0", (i, got, want)
        assert gh["X-RateLimit-Reset"] in ("30", "60"), (i, got, want)
        out.append(i)
    return out


def test_sharded_answers_equal_the_memory_server(topologies):
    memory, sharded = topologies["memory"], topologies["sharded"]
    for i, (want, got) in enumerate(zip(memory["steps"], sharded["steps"])):
        assert got == want, (i, got, want)
    for key in ("limits", "counters", "status"):
        assert sharded[key] == memory[key], key


def test_tiered_answers_equal_the_memory_server_but_one_reset(topologies):
    """Cold counters decide on the host's big-limit lane, which answers a
    counter whose window expired before the hit with the new window's
    reset, where the memory storage (and the device kernel) answer the
    old window's 0. The JAX package's lane does the same
    (``tpu/storage.py`` ``_eval_big_hits``; ROADMAP Queue C). Everything
    else is equal; the departure shows on the draft-03 answers to hits
    on cold counters past their window."""
    memory, tiered = topologies["memory"], topologies["tiered"]
    assert len(tiered["steps"]) == len(memory["steps"])
    departures = _reset_departures(memory["steps"], tiered["steps"])
    steps = H.sequence() * 2
    assert departures and all(
        steps[i][0] == "/check_and_report" and "response_headers" in
        steps[i][1] for i in departures)
    for key in ("limits", "counters", "status"):
        assert tiered[key] == memory[key], key


def test_debug_tiering_carries_the_jax_keys(topologies):
    status, body = topologies["debug"]["tiered", "/debug/tiering"]
    assert status == 200
    j_manager = JTierManager(JTieredStorage(capacity=64, cache_size=3))
    assert set(body) == set(j_manager.tiering_debug())
    assert body["device_resident"] <= 3
    assert topologies["debug"]["memory", "/debug/tiering"][0] == 404
    assert topologies["debug"]["sharded", "/debug/tiering"][0] == 404


@pytest.mark.parametrize("name", ["sharded", "tiered"])
def test_debug_stats_carries_the_jax_keys(topologies, name):
    status, body = topologies["debug"][name, "/debug/stats"]
    assert status == 200
    j_storage = TpuStorage(capacity=64)
    j_limiter = JAsyncRateLimiter(AsyncTpuStorage(j_storage))
    want = j_collect_debug_stats(j_limiter)
    assert set(want) <= set(body)
    assert set(body) - set(want) <= set(DEBUG_STATS_SECTIONS)
    assert {q["queue"] for q in body["queues"]} == {
        q["queue"] for q in want["queues"]}
    for shard in body["shards"]:
        assert set(shard) == set(want["shards"][0])
    assert set(body["tenant_usage"]) == set(
        JObservatory(j_storage).tenant_usage())
    assert set(body["native_build"]) == {"hostpath", "counter_table"}
    for lib in body["native_build"].values():
        assert set(lib) == {"attempted", "loaded", "build_error",
                            "sanitizer"}
    if name == "tiered":
        assert set(body["tiering"]) == set(
            topologies["debug"]["tiered", "/debug/tiering"][1])


def test_debug_top_answers_on_device_storages(topologies):
    for name in ("sharded", "tiered"):
        status, body = topologies["debug"][name, "/debug/top"]
        assert status == 200 and body["top"], name
        assert set(body) == {"k", "top", "pressure"}
    assert topologies["debug"]["memory", "/debug/top"][0] == 404


# -- the JAX package's TestHttpApi cases against the port -------------------

HTTP_LIMITS = """\
- namespace: test_namespace
  max_value: 2
  seconds: 60
  conditions: ["descriptors[0]['req_method'] == 'GET'"]
  variables: ["descriptors[0].user"]
"""


@pytest.fixture(scope="module")
def http_server(tmp_path_factory):
    """A port memory server on its own loop thread, as the JAX package's
    ``http_server`` fixture runs its server."""
    import threading

    path = tmp_path_factory.mktemp("http") / "limits.yaml"
    path.write_text(HTTP_LIMITS)
    http_port, rls_port = H.free_port(), H.free_port()
    argv = H.port_argv(path, "memory", http_port)
    argv[argv.index("--rls-port") + 1] = str(rls_port)
    loop = asyncio.new_event_loop()
    server = loop.run_until_complete(port_main.start(parse(argv)))
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    yield http_port, rls_port
    asyncio.run_coroutine_threadsafe(server.stop(), loop).result(timeout=10)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=5)
    assert not thread.is_alive()


def _post(port, path, body):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers)


def _get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as resp:
        return resp.status, resp.read()


class TestHttpApi:
    def test_status(self, http_server):
        status, body = _get(http_server[0], "/status")
        assert status == 200
        assert json.loads(body)["limits_file_version"] == 1

    def test_limits_endpoint(self, http_server):
        status, body = _get(http_server[0], "/limits/test_namespace")
        assert status == 200
        limits = json.loads(body)
        assert len(limits) == 1
        assert limits[0]["max_value"] == 2

    def test_check_and_report_flow(self, http_server):
        port = http_server[0]
        body = {
            "namespace": "test_namespace",
            "values": {"req_method": "GET", "user": "u1"},
            "delta": 1,
            "response_headers": "DRAFT_VERSION_03",
        }
        st, headers = _post(port, "/check_and_report", body)
        assert st == 200
        assert headers["X-RateLimit-Remaining"] == "1"
        st, _ = _post(port, "/check_and_report", body)
        assert st == 200
        st, headers = _post(port, "/check_and_report", body)
        assert st == 429
        assert headers["X-RateLimit-Remaining"] == "0"

    def test_check_report_split(self, http_server):
        port = http_server[0]
        body = {
            "namespace": "test_namespace",
            "values": {"req_method": "GET", "user": "u2"},
            "delta": 1,
        }
        assert _post(port, "/check", body)[0] == 200
        assert _post(port, "/report", body)[0] == 200
        assert _post(port, "/report", body)[0] == 200
        assert _post(port, "/check", body)[0] == 429

    def test_counters_endpoint(self, http_server):
        port = http_server[0]
        _post(port, "/report", {
            "namespace": "test_namespace",
            "values": {"req_method": "GET", "user": "u3"},
            "delta": 1,
        })
        status, body = _get(port, "/counters/test_namespace")
        assert status == 200
        counters = [c for c in json.loads(body)
                    if c["set_variables"] == {"descriptors[0].user": "u3"}]
        assert len(counters) == 1
        assert counters[0]["remaining"] == 1

    def test_bad_request(self, http_server):
        st, _ = _post(http_server[0], "/check", {"nope": 1})
        assert st == 400

    def test_metrics_endpoint(self, http_server):
        status, body = _get(http_server[0], "/metrics")
        assert status == 200
        assert b"limitador_up 1.0" in body

    def test_api_spec_served(self, http_server):
        status, body = _get(http_server[0], "/api/spec")
        assert status == 200
        spec = json.loads(body)
        assert spec["openapi"].startswith("3.")
        for path in ("/status", "/metrics", "/limits/{namespace}",
                     "/counters/{namespace}", "/check", "/report",
                     "/check_and_report", "/debug/stats", "/debug/top"):
            assert path in spec["paths"], path

    @pytest.mark.parametrize("path", [
        "/debug/signals", "/debug/pod", "/debug/events", "/debug/capacity",
        "/debug/profile", "/debug/flight",
    ])
    def test_unported_debug_routes_are_not_served(self, http_server, path):
        """The debug routes of the pod, not ported yet, answer 404. The
        others are served on this memory server as the JAX server serves
        them there: ``/debug/profile`` the idle capture status,
        ``/debug/flight`` the (empty) bundle spool (the flight recorder
        runs on every storage), and ``/debug/signals`` and
        ``/debug/capacity`` the JAX server's 404 bodies (the signal bus
        runs with the usage observatory and the serving-model fit with a
        device recorder, neither of which a memory server has)."""
        import urllib.request

        url = f"http://127.0.0.1:{http_server[0]}{path}"
        served = {
            "/debug/profile": {"active": False, "trace_dir": None,
                               "started_at": None},
            "/debug/flight": {"bundles": []},
        }
        if path in served:
            with urllib.request.urlopen(url) as resp:
                assert resp.status == 200
                assert len(resp.headers["x-request-id"]) == 32
                assert json.loads(resp.read()) == served[path]
            return
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(url)
        assert exc.value.code == 404
        assert len(exc.value.headers["x-request-id"]) == 32
        unserved = {
            "/debug/signals": {"error": "signal bus not running"},
            "/debug/capacity": {
                "error": "serving-model fit not running (--model-fit off "
                         "or host-only storage)"},
        }
        if path in unserved:
            assert json.loads(exc.value.read()) == unserved[path]

    def test_http_request_id_echo(self, http_server):
        import urllib.request

        port = http_server[0]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/status",
            headers={"x-request-id": "abc-123"},
        )
        with urllib.request.urlopen(req) as resp:
            assert resp.headers["x-request-id"] == "abc-123"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/status") as resp:
            assert len(resp.headers["x-request-id"]) == 32  # generated

    def test_grpc_request_id_metadata(self, http_server):
        rls_port = http_server[1]
        req = rls_pb2.RateLimitRequest(domain="test_namespace")
        d = req.descriptors.add()
        d.entries.add(key="req_method", value="GET")
        d.entries.add(key="user", value="rid")
        with grpc.insecure_channel(f"127.0.0.1:{rls_port}") as channel:
            fn = channel.unary_unary(
                "/envoy.service.ratelimit.v3.RateLimitService/"
                "ShouldRateLimit",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=rls_pb2.RateLimitResponse.FromString,
            )
            _resp, call = fn.with_call(
                req, metadata=(("x-request-id", "rid-42"),), timeout=5)
            assert dict(call.initial_metadata())["x-request-id"] == "rid-42"
            _resp, call = fn.with_call(req, timeout=5)
            assert len(dict(call.initial_metadata())["x-request-id"]) == 32


@pytest.mark.parametrize("delay", [0.0, 0.002], ids=["at-once", "later"])
def test_grpc_storage_error_answers_unavailable_with_the_request_id(delay):
    """A storage error aborts with UNAVAILABLE, and the answer still
    carries the call's x-request-id, whether the error comes before or
    after the interceptor's initial metadata went out."""
    from limitador_tpu_torch.core.limiter import AsyncRateLimiter
    from limitador_tpu_torch.server.rls import serve_rls
    from limitador_tpu_torch.storage.base import StorageError

    class Down(AsyncRateLimiter):
        def __init__(self):
            pass

        async def check_rate_limited_and_update(self, *_args):
            await asyncio.sleep(delay)
            raise StorageError("down")

    async def drive():
        port = H.free_port()
        server = await serve_rls(Down(), f"127.0.0.1:{port}")
        req = rls_pb2.RateLimitRequest(domain="ns")
        req.descriptors.add().entries.add(key="user", value="u")
        out = []
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                fn = ch.unary_unary(
                    "/envoy.service.ratelimit.v3.RateLimitService/"
                    "ShouldRateLimit")
                for i in range(20):
                    call = fn(req.SerializeToString(), timeout=5,
                              metadata=(("x-request-id", f"rid-{i}"),))
                    with pytest.raises(grpc.aio.AioRpcError) as err:
                        await call
                    initial = await call.initial_metadata()
                    out.append((err.value.code(), [
                        value for key, value in initial
                        if key == "x-request-id"]))
        finally:
            await server.stop(None)
        return out

    for i, (code, ids) in enumerate(asyncio.run(drive())):
        assert code == grpc.StatusCode.UNAVAILABLE
        assert ids == [f"rid-{i}"]

