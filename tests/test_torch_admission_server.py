"""The admission plane on the port's server, on the CPU.

- The nine admission options parse to the JAX server's defaults.
- ``--admission-mode monitor|enforce`` on a host storage exits 2 (the
  JAX server warns and serves without the plane), and so does a bad
  ``--priority`` mapping.
- With ``--admission-mode off`` (the default) nothing is built: no
  controller on the server, the storage or its batchers, no ``admission``
  section in ``/debug/stats`` (``test_torch_isolation.py`` shows the
  package is not even imported).
- ``enforce`` and ``monitor`` servers answer the HTTP and gRPC drives
  byte for byte like an ``off`` one, on torch, sharded and the native
  pipeline; ``/debug/stats`` carries an ``admission`` section with the
  JAX ``admission_debug()`` keys, ``/metrics`` declares exactly
  ``admission.METRIC_FAMILIES`` among the ``admission_*`` families and the
  signal bus reads the breaker and the sheds.
- ``POST /check_and_report`` answers 503, or 429 under ``--shed-response
  overlimit``, on a shed, and the shed takes no batch slot.
- The limits file's ``priority:`` annotations reach the resolver on
  every load.
"""

import asyncio
import json

import aiohttp
import grpc
import pytest
from prometheus_client.parser import text_string_to_metric_families

from limitador_tpu_torch.admission import METRIC_FAMILIES
from limitador_tpu_torch.server import __main__ as port_main
from limitador_tpu_torch.server.proto import rls_pb2

from . import torch_http as H
from .torch_steady import steady

ENVOY = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
OPTIONS = ("admission_mode", "breaker_failures", "breaker_stall_ms",
           "breaker_reset_ms", "max_inflight", "admission_target_queue_ms",
           "shed_response", "priority_key", "priority")

ANNOTATED = """\
- namespace: api
  max_value: 5
  seconds: 60
  conditions: ["descriptors[0].method == 'GET'"]
  variables: ["descriptors[0].user"]
  name: per-user-get
  priority: high
- namespace: tb
  max_value: 4
  seconds: 2
  variables: ["descriptors[0].user"]
  policy: token_bucket
  name: bucket
  priority: low
"""


@pytest.fixture(scope="module", autouse=True)
def _grpc_aio_poller():
    """One grpc.aio channel for the module's length, so that grpc.aio's
    poller thread predates every test's thread count (``steady``)."""

    async def open_channel():
        return grpc.aio.insecure_channel("127.0.0.1:9")

    loop = asyncio.new_event_loop()
    channel = loop.run_until_complete(open_channel())
    try:
        yield
    finally:
        loop.run_until_complete(channel.close())
        loop.close()


@pytest.fixture(autouse=True)
def _steady(_grpc_aio_poller):
    with steady():
        yield


def parse(argv):
    return port_main.build_parser().parse_args(argv)


def _limits(tmp_path, text=H.LIMITS):
    path = tmp_path / "limits.yaml"
    path.write_text(text)
    return path


# -- options and refusals ----------------------------------------------------


@pytest.mark.parametrize("dest", OPTIONS)
def test_admission_options_default_like_the_jax_server(dest, tmp_path,
                                                       monkeypatch):
    from limitador_tpu.server import __main__ as jax_main

    for name in ("ADMISSION_MODE", "BREAKER_FAILURES", "BREAKER_STALL_MS",
                 "BREAKER_RESET_MS", "ADMISSION_MAX_INFLIGHT",
                 "ADMISSION_TARGET_QUEUE_MS", "SHED_RESPONSE",
                 "PRIORITY_KEY"):
        monkeypatch.delenv(name, raising=False)
    limits = str(_limits(tmp_path))
    port = vars(port_main.build_parser().parse_args([limits, "torch"]))
    jax = vars(jax_main.build_parser().parse_args([limits, "tpu"]))
    assert port[dest] == jax[dest]
    actions = {a.dest: a for a in port_main.build_parser()._actions}
    j_actions = {a.dest: a for a in jax_main.build_parser()._actions}
    assert actions[dest].choices == j_actions[dest].choices
    assert actions[dest].option_strings == j_actions[dest].option_strings


@pytest.mark.parametrize("storage", [
    ["memory"], ["disk", "--disk-path", "DB"], ["cached", "--disk-path", "DB"],
    ["distributed", "--listen-address", "127.0.0.1:0"],
])
@pytest.mark.parametrize("mode", ["monitor", "enforce"])
def test_admission_on_a_host_storage_exits_2(tmp_path, storage, mode,
                                             capfd):
    argv = [str(_limits(tmp_path)),
            *[str(tmp_path / "c.db") if a == "DB" else a for a in storage],
            "--admission-mode", mode, "--rls-host", "127.0.0.1",
            "--rls-port", str(H.free_port()), "--http-host", "127.0.0.1",
            "--http-port", str(H.free_port()),
            "--flight-spool-dir", str(tmp_path / "flight")]
    assert port_main.main(argv) == 2
    assert "needs torch or sharded storage" in capfd.readouterr().err


def test_a_bad_priority_mapping_exits_2(tmp_path):
    argv = H.port_argv(_limits(tmp_path), "torch", H.free_port(),
                       "--admission-mode", "enforce", "--priority",
                       "api=urgent")
    assert port_main.main(argv) == 2


# -- served ------------------------------------------------------------------


def _grpc_blobs():
    out = []
    for i in range(30):
        req = rls_pb2.RateLimitRequest(
            domain=("api", "tb")[i % 2], hits_addend=1 + i % 3)
        d = req.descriptors.add()
        for key, value in (("method", "GET"), ("user", f"u{i % 4}"),
                           ("tenant", "t")):
            d.entries.add(key=key, value=value)
        out.append(req.SerializeToString())
    return out


async def _served(tmp_path, storage, modes, extra=()):
    """One server per mode on one fake clock; the gRPC blobs and the HTTP
    drive to each. Returns mode -> drive record (+ "grpc", "debug",
    "server" facts)."""
    clock = H.FakeClock()
    limits_path = _limits(tmp_path)
    http = {mode: H.free_port() for mode in modes}
    servers, rls = {}, {}
    try:
        for mode in modes:
            args = parse(H.port_argv(limits_path, storage, http[mode],
                                     "--admission-mode", mode, *extra))
            rls[mode] = args.rls_port
            servers[mode] = await port_main.start(args, clock=clock)
        grpc_answers = {mode: [] for mode in modes}
        for blob in _grpc_blobs():
            for mode in servers:
                port = rls[mode]
                async with grpc.aio.insecure_channel(
                        f"127.0.0.1:{port}") as chan:
                    grpc_answers[mode].append(
                        await chan.unary_unary(ENVOY)(blob, timeout=30))

        async def reload():
            H.reload_limits_file(limits_path)
            await H.wait_for(lambda: all(
                s.status["limits_file_version"] == 2
                for s in servers.values()))

        async def extra_calls(session, name, base):
            async with session.get(base + "/debug/stats") as resp:
                out[name]["debug"] = await resp.json()

        out = {mode: {} for mode in modes}
        drive = await H.drive(clock, {
            mode: f"http://127.0.0.1:{http[mode]}" for mode in modes
        }, reload, extra_calls)
        for mode in modes:
            out[mode].update(drive[mode])
            out[mode]["grpc"] = grpc_answers[mode]
            server = servers[mode]
            counters = server.limiter.storage.counters
            adm = server.admission
            out[mode]["facts"] = {
                "admission": adm is not None,
                "storage": getattr(counters, "admission", None) is adm,
                "batchers": all(
                    b.admission is adm
                    for pair in counters._batcher_pairs() for b in pair),
                "drainables": None if adm is None else sorted(
                    type(d).__name__ for d in adm._drainables),
                "state": None if adm is None else adm.breaker.state,
                "failover": None if adm is None
                else adm.failover.decisions,
                "signals": None if server.signal_bus is None else
                server.signal_bus.snapshot().breaker_state,
            }
        return out
    finally:
        for server in servers.values():
            await server.stop()


def _admission_families(text):
    return sorted(f.name for f in text_string_to_metric_families(text)
                  if f.name.startswith("admission_")
                  and not f.name.endswith("_created"))


@pytest.mark.parametrize("case", [
    ("torch", ()),
    ("torch", ("--pipeline", "native")),
    ("sharded", ("--pipeline", "compiled")),
], ids=["torch", "native", "sharded"])
def test_served_answers_equal_with_the_plane_on_and_off(tmp_path, case):
    storage, extra = case
    if extra == ("--pipeline", "native"):
        # the native pipeline answers without headers
        extra = extra + ("--rate-limit-headers", "NONE")
    out = asyncio.run(_served(tmp_path, storage,
                              ("off", "enforce", "monitor"), extra))
    off = out["off"]
    for mode in ("enforce", "monitor"):
        got = out[mode]
        assert got["steps"] == off["steps"]
        assert got["grpc"] == off["grpc"]
        assert got["counters"] == off["counters"]
        assert got["limits"] == off["limits"]
        facts = got["facts"]
        assert facts["admission"] and facts["storage"] and facts["batchers"]
        assert facts["state"] == "closed" and facts["failover"] == 0
        assert got["debug"]["admission"]["mode"] == mode
        assert got["debug"]["admission"]["breaker"]["state"] == "closed"
        assert got["debug"]["admission"]["failover"]["decisions"] == 0
        want = ["AsyncTorchStorage"]
        if storage == "sharded" or "native" in extra:
            want.append("CompiledTorchLimiter")
        if "native" in extra:
            want.append("NativeRlsPipeline")
        assert facts["drainables"] == sorted(want)
        if facts["signals"] is not None:
            assert facts["signals"] == 0
    facts = off["facts"]
    assert not facts["admission"] and facts["storage"] \
        and facts["batchers"]  # None everywhere
    assert "admission" not in off["debug"]
    for mode in out:
        # declared on every server, as in the JAX package
        assert _admission_families(out[mode]["metrics"]) == sorted(
            METRIC_FAMILIES)


def test_debug_section_has_the_jax_controllers_keys(tmp_path):
    from limitador_tpu.admission import AdmissionController as J

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) and k != "sheds" else None
                for k, v in d.items()}

    out = asyncio.run(_served(tmp_path, "torch", ("enforce",)))
    section = out["enforce"]["debug"]["admission"]
    assert keys(section) == keys(J(mode="enforce").admission_debug())


async def _shed_over_http(tmp_path, shed_response):
    limits_path = _limits(tmp_path)
    http = H.free_port()
    server = await port_main.start(parse(H.port_argv(
        limits_path, "torch", http, "--admission-mode", "enforce",
        "--max-inflight", "1", "--shed-response", shed_response)))
    base = f"http://127.0.0.1:{http}"
    body = json.dumps({"namespace": "api", "values": {
        "method": "GET", "user": "a", "tenant": "t"}, "delta": 1})
    try:
        async with aiohttp.ClientSession() as session:
            async def post():
                async with session.post(base + "/check_and_report",
                                        data=body) as resp:
                    return resp.status, await resp.text()

            first = await post()
            adm = server.admission
            held = []
            while adm.overload.try_acquire(3):  # saturate the plane
                held.append(1)
            batches_before = server.limiter.storage.counters.library_stats()
            shed = await post()
            pending = list(server.limiter.storage.counters.batcher._pending)
            for _ in held:
                adm.overload.release()
            after = await post()
            async with session.get(base + "/metrics") as resp:
                metrics = await resp.text()
            counters = await server.limiter.get_counters("api")
        return {"first": first, "shed": shed, "after": after,
                "pending": pending,
                "queue": batches_before["queue_depth"],
                "debug": adm.admission_debug(), "metrics": metrics,
                "spent": sorted(c.limit.max_value - c.remaining
                                for c in counters)}
    finally:
        await server.stop()


@pytest.mark.parametrize("shed_response,status", [
    ("unavailable", 503), ("overlimit", 429)])
def test_check_and_report_sheds_with_503_or_429(tmp_path, shed_response,
                                                status):
    out = asyncio.run(_shed_over_http(tmp_path, shed_response))
    assert out["first"][0] == 200 and out["after"][0] == 200
    assert out["shed"][0] == status
    if status == 503:
        assert "admission shed" in out["shed"][1]
    assert out["pending"] == [] and out["queue"] == 0
    # the shed decided nothing: two hits on each counter, not three
    assert out["spent"] == [2, 2]
    assert out["debug"]["sheds"] == {"overload:normal": 1}
    families = {f.name: f for f in
                text_string_to_metric_families(out["metrics"])}
    sheds = {s.labels["reason"] + ":" + s.labels["priority"]: s.value
             for s in families["admission_sheds"].samples
             if s.name == "admission_sheds_total"}
    assert sheds["overload:normal"] == 1
    assert len(sheds) == 12  # every (reason, priority) pre-seeded


def test_limits_file_priorities_reach_the_resolver(tmp_path):
    async def main():
        limits_path = _limits(tmp_path, ANNOTATED)
        server = await port_main.start(parse(H.port_argv(
            limits_path, "torch", H.free_port(), "--admission-mode",
            "enforce", "--priority", "other=critical")))
        try:
            resolve = server.admission.priorities.resolve
            first = (resolve("api"), resolve("tb"), resolve("other"),
                     resolve("api", {"priority": "low"}))
            H.reload_limits_file(limits_path, H.LIMITS)
            await H.wait_for(
                lambda: server.status["limits_file_version"] == 2)
            return first, (resolve("api"), resolve("tb"))
        finally:
            await server.stop()

    first, reloaded = asyncio.run(main())
    assert first == (2, 0, 3, 0)
    assert reloaded == (1, 1)
