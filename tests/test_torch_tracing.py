"""The port's MetricsLayer, tracing and OTLP span export.

- The cases of the JAX package's ``tests/test_metrics_layer.py`` that
  need no cached storage or pod, on the port's ``metrics_layer``,
  limiter and batcher (the reference's unit suite, metrics.rs:213-293,
  and the instrumented paths).
- W3C ``traceparent`` adoption and head sampling.
- The vendored OTLP/HTTP+JSON pipeline against a local collector, as the
  JAX package's ``tests/test_otlp.py`` drives its own.
- ``--tracing-endpoint`` exits 2 where ``opentelemetry`` cannot be
  imported, and a span-exporting server subprocess sends a decision's
  spans, parented on the caller's traceparent.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from limitador_tpu_torch.observability import tracing
from limitador_tpu_torch.observability.metrics_layer import (
    MetricsLayer,
    SpanState,
    Timings,
    install,
    installed,
    metrics_span,
)
from limitador_tpu_torch.observability.otlp import BatchExporter, make_provider
from tests.torch_http import flight_spool  # noqa: F401 (autouse)
from tests.torch_steady import otel_provider_kept

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _uninstall():
    """Each test starts without a layer (a server started earlier in the
    process installs one) and leaves the process as it found it: the
    layer, the tracing module's pipeline and OpenTelemetry's global
    tracer provider, which a later test in the same worker (the JAX
    package's ``tests/test_otlp.py``) must be able to set."""
    prior = installed()
    pipeline = (tracing._trace, tracing._provider, tracing._tracer,
                tracing._enabled)
    install(None)
    with otel_provider_kept():
        yield
    (tracing._trace, tracing._provider, tracing._tracer,
     tracing._enabled) = pipeline
    install(prior)


# -- Timings / SpanState units (metrics.rs:218-285) ------------------------


def test_timings_add():
    t1 = Timings(idle=5, busy=5, last=100)
    t2 = Timings(idle=3, busy=5, last=100)
    t3 = t1 + t2
    assert t3 == Timings(idle=8, busy=10, last=100, updated=False)


def test_timings_add_keeps_max_last_and_updated():
    t1 = Timings(idle=1, busy=1, last=50, updated=True)
    t2 = Timings(idle=1, busy=1, last=80)
    t3 = t1 + t2
    assert t3.last == 80
    assert t3.updated is True


def test_timings_duration_is_idle_plus_busy():
    assert Timings(idle=1_500_000_000, busy=500_000_000, last=0).duration == 2.0


def test_span_state_increment():
    state = SpanState("group")
    t1 = Timings(idle=5, busy=5, last=7, updated=True)
    state.increment("group", t1)
    got = state.group_times["group"]
    assert got.idle == 5
    assert got.busy == 5
    assert got.updated is True


def test_metrics_layer_gather_registers_records():
    ml = MetricsLayer().gather("group", lambda t: None, ["record"])
    assert ml.groups["group"].records == ["record"]


def test_gather_does_not_overwrite_existing_aggregate():
    first = lambda t: None  # noqa: E731
    ml = (
        MetricsLayer()
        .gather("group", first, ["a"])
        .gather("group", lambda t: None, ["b"])
    )
    assert ml.groups["group"].consumer is first
    assert ml.groups["group"].records == ["a"]


# -- span-tree lifecycle ----------------------------------------------------


def test_aggregator_with_one_record_child():
    out = []
    ml = MetricsLayer().gather("root", out.append, ["datastore"])
    root = ml.new_span("root")
    with root:
        with ml.new_span("datastore", parent=root):
            pass
    assert len(out) == 1
    t = out[0]
    assert t.updated is True
    assert t.busy >= 0 and t.idle >= 0


def test_sibling_records_accumulate():
    out = []
    ml = MetricsLayer().gather("root", out.append, ["datastore"])
    with ml.new_span("root") as root:
        with ml.new_span("datastore", parent=root):
            pass
        with ml.new_span("datastore", parent=root):
            pass
    assert len(out) == 1
    # two records folded into one group total: busy includes both spans
    assert out[0].updated is True


def test_record_under_intermediate_span_still_aggregates():
    out = []
    ml = MetricsLayer().gather("root", out.append, ["datastore"])
    with ml.new_span("root") as root:
        with ml.new_span("handler", parent=root) as mid:
            with ml.new_span("datastore", parent=mid):
                pass
    assert len(out) == 1


def test_record_without_aggregator_is_ignored():
    out = []
    ml = MetricsLayer().gather("root", out.append, ["datastore"])
    with ml.new_span("datastore"):  # no root above it
        pass
    assert out == []


def test_aggregator_without_updated_records_does_not_fire():
    out = []
    ml = MetricsLayer().gather("root", out.append, ["datastore"])
    with ml.new_span("root"):
        with ml.new_span("unrelated"):
            pass
    assert out == []


def test_nonrecord_spans_carry_no_timings():
    ml = MetricsLayer().gather("root", lambda t: None, ["datastore"])
    with ml.new_span("root") as root:
        mid = ml.new_span("handler", parent=root)
        assert mid.timings is None
        rec = ml.new_span("datastore", parent=mid)
        assert rec.timings is not None
        rec.close()
        mid.close()


def test_two_groups_one_record_name():
    """A record name shared by two groups increments both aggregates
    (metrics.rs:186-195 iterates every group of the span state)."""
    a_out, b_out = [], []
    ml = (
        MetricsLayer()
        .gather("a", a_out.append, ["datastore"])
        .gather("b", b_out.append, ["datastore"])
    )
    with ml.new_span("a") as a:
        with ml.new_span("b", parent=a) as b:  # second-level aggregator
            with ml.new_span("datastore", parent=b):
                pass
    assert len(a_out) == 1
    assert len(b_out) == 1


def test_second_level_aggregator_keeps_parent_group():
    """A nested aggregator appends itself to the inherited state
    (metrics.rs:119-127) instead of replacing it."""
    ml = (
        MetricsLayer()
        .gather("outer", lambda t: None, ["x"])
        .gather("inner", lambda t: None, ["y"])
    )
    with ml.new_span("outer") as outer:
        inner = ml.new_span("inner", parent=outer)
        assert set(inner.state.group_times) == {"outer", "inner"}
        inner.close()


def test_multiple_enter_exit_cycles_split_busy_and_idle():
    out = []
    ml = MetricsLayer().gather("root", out.append, ["datastore"])
    with ml.new_span("root") as root:
        rec = ml.new_span("datastore", parent=root)
        rec.enter()
        rec.exit()
        rec.enter()
        rec.exit()
        rec.close()
    assert len(out) == 1
    assert out[0].updated is True
    # both busy (entered twice) and idle (created->entered, exited->closed)
    # accumulated something
    assert out[0].busy > 0
    assert out[0].idle > 0


def test_consumer_receives_copy_not_live_state():
    out = []
    ml = MetricsLayer().gather("root", out.append, ["datastore"])
    with ml.new_span("root") as root:
        with ml.new_span("datastore", parent=root):
            pass
    before = (out[0].idle, out[0].busy)
    out[0].idle += 999
    assert (out[0].idle - 999, out[0].busy) == before


# -- contextvar parenting (async handler -> storage spans) ------------------


def test_metrics_span_contextvar_parenting():
    out = []
    install(MetricsLayer().gather("root", out.append, ["datastore"]))
    with metrics_span("root"):
        with metrics_span("datastore"):  # parent discovered via contextvar
            pass
    assert len(out) == 1


def test_metrics_span_noop_without_installed_layer():
    assert installed() is None
    with metrics_span("root") as span:
        assert span is None


def test_async_tasks_do_not_cross_parent():
    """Two concurrent request handlers each see only their own root."""
    out = []
    install(MetricsLayer().gather("root", out.append, ["datastore"]))

    async def handler():
        with metrics_span("root"):
            with metrics_span("datastore"):
                await asyncio.sleep(0)

    async def main():
        await asyncio.gather(*(handler() for _ in range(4)))

    asyncio.run(main())
    assert len(out) == 4


def test_await_time_counts_into_duration():
    """The datastore span is open across the await: queue/await time is
    idle, not lost — duration covers the full storage wait."""
    out = []
    install(MetricsLayer().gather("root", out.append, ["datastore"]))

    async def handler():
        with metrics_span("root"):
            with metrics_span("datastore"):
                await asyncio.sleep(0.02)

    asyncio.run(handler())
    assert out[0].duration >= 0.02


# -- instrumented code paths ------------------------------------------------


def test_limiter_datastore_spans_feed_aggregate():
    from limitador_tpu_torch import Context, Limit, RateLimiter
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    out = []
    install(
        MetricsLayer().gather("should_rate_limit", out.append, ["datastore"])
    )
    limiter = RateLimiter(InMemoryStorage())
    limiter.add_limit(Limit("ns", 10, 60, [], ["user"]))
    from limitador_tpu_torch.observability.tracing import should_rate_limit_span

    with should_rate_limit_span("ns", 1) as record:
        result = limiter.check_rate_limited_and_update(
            "ns", Context({"user": "u1"}), 1, False
        )
        record(result.limited, result.limit_name)
    assert len(out) == 1
    assert out[0].updated is True


def test_batcher_feeds_only_the_device_latency():
    """The batched storage observes each decided request's device round
    trip into datastore_device_latency and leaves datastore_latency to
    the MetricsLayer, with or without a layer installed."""
    from limitador_tpu_torch import AsyncRateLimiter, Context, Limit
    from limitador_tpu_torch.device.batcher import AsyncTorchStorage
    from limitador_tpu_torch.device.storage import TorchStorage
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics

    def count(body, family):
        return float(body.split(f"\n{family}_count ")[1].split()[0])

    async def drive():
        storage = AsyncTorchStorage(TorchStorage(capacity=64, device="cpu"))
        m = PrometheusMetrics()
        storage.set_metrics(m)
        limiter = AsyncRateLimiter(storage)
        limiter.add_limit(Limit("ns", 10, 60, [], ["user"]))
        for user in ("u1", "u2", "u1"):
            await limiter.check_rate_limited_and_update(
                "ns", Context({"user": user}), 1, False
            )
        await limiter.update_counters("ns", Context({"user": "u3"}), 1)
        await storage.close()
        return m.render().decode()

    assert installed() is None
    body = asyncio.run(drive())
    assert count(body, "datastore_device_latency") == 4
    assert count(body, "datastore_latency") == 0


def test_prometheus_record_datastore_latency():
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics

    m = PrometheusMetrics()
    m.record_datastore_latency(
        Timings(idle=1_000_000, busy=1_000_000, last=0, updated=True)
    )
    body = m.render().decode()
    assert "datastore_latency_count 1.0" in body
    assert "datastore_latency_sum 0.002" in body


def test_detached_spawn_does_not_inherit_request_span():
    """Background tasks spawned from under a request span (the native
    pipeline's flush loop and slow-path decides) must run in a fresh
    context — inheriting would parent them under one arbitrary request's
    aggregate."""
    from limitador_tpu_torch.device.native_pipeline import _spawn_detached
    from limitador_tpu_torch.observability.metrics_layer import current_span

    install(MetricsLayer().gather("root", lambda t: None, ["datastore"]))
    seen = []

    async def background():
        seen.append(current_span())

    async def main():
        with metrics_span("root") as span:
            assert current_span() is span
            task = _spawn_detached(background())
            await task

    asyncio.run(main())
    assert seen == [None]


def test_should_rate_limit_span_accepts_carrier_without_tracing():
    """The W3C carrier argument must be inert when no exporter is
    installed (the server only materializes it when tracing_enabled)."""
    from limitador_tpu_torch.observability.tracing import (
        should_rate_limit_span,
        tracing_enabled,
    )

    assert tracing_enabled() is False
    carrier = {"traceparent":
               "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"}
    with should_rate_limit_span("ns", 1, carrier) as record:
        record(False, None)


# -- traceparent adoption and head sampling ----------------------------------


def test_adopt_traceparent_takes_the_callers_trace_id():
    from contextvars import copy_context

    def adopt(header):
        return tracing.adopt_traceparent(header), tracing.current_trace_id()

    trace_id = "0af7651916cd43dd8448eb211c80319c"
    got = copy_context().run(adopt, f"00-{trace_id.upper()}-b7ad6b7169203331-01")
    assert got == (trace_id, trace_id)
    for bad in (None, "", "00-short-b7ad6b7169203331-01", "garbage",
                "00-" + "0" * 32 + "-b7ad6b7169203331-01"):
        assert copy_context().run(adopt, bad) == (None, None), bad


def test_head_sampling_keeps_one_in_n_roots():
    prior = tracing.sample_rate()
    try:
        tracing.set_sample_rate(0.25)
        decisions = [tracing._head_decision() for _ in range(400)]
        assert sum(decisions) == 100
        tracing.set_sample_rate(0.0)
        assert not any(tracing._head_decision() for _ in range(10))
        tracing.set_sample_rate(7.0)
        assert tracing.sample_rate() == 1.0
        assert all(tracing._head_decision() for _ in range(10))
    finally:
        tracing.set_sample_rate(prior)


def test_spans_without_an_exporter_are_shared_noops():
    assert tracing.tracing_enabled() is False
    install(None)
    assert tracing.datastore_span("x") is tracing.datastore_span("y")
    with tracing.should_rate_limit_span("ns", 1) as record:
        assert record is tracing._noop_record


# -- the vendored OTLP pipeline against a local collector -------------------


class _Collector:
    """Minimal OTLP/HTTP trace collector: records every POST body."""

    def __init__(self):
        self.requests = []
        self.lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with outer.lock:
                    outer.requests.append((self.path, json.loads(body)))
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self.thread.start()

    def spans(self):
        with self.lock:
            out = []
            for _path, body in self.requests:
                for rs in body.get("resourceSpans", []):
                    for ss in rs.get("scopeSpans", []):
                        out.extend(ss.get("spans", []))
            return out

    def wait_spans(self, n, timeout=10.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            got = self.spans()
            if len(got) >= n:
                return got
            time.sleep(0.05)
        raise AssertionError(
            f"collector got {len(self.spans())} spans, wanted {n}"
        )

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def collector():
    c = _Collector()
    yield c
    c.close()


def _attr(span, key):
    for kv in span.get("attributes", []):
        if kv["key"] == key:
            return kv["value"]
    return None


def test_nested_spans_export_with_parentage(collector):
    provider = make_provider(
        BatchExporter(f"http://127.0.0.1:{collector.port}",
                      flush_interval_s=0.1)
    )
    tracer = provider.get_tracer("test")
    with tracer.start_as_current_span("root") as root:
        root.set_attribute("ratelimit.namespace", "ns")
        root.set_attribute("ratelimit.hits_addend", 2)
        root.set_attribute("ratelimit.limited", True)
        with tracer.start_as_current_span("datastore") as child:
            child.set_attribute("datastore.operation", "check_and_update")
    provider.force_flush()
    spans = collector.wait_spans(2)
    by_name = {s["name"]: s for s in spans}
    root_s, child_s = by_name["root"], by_name["datastore"]
    assert child_s["traceId"] == root_s["traceId"]
    assert len(root_s["traceId"]) == 32 and len(root_s["spanId"]) == 16
    assert child_s["parentSpanId"] == root_s["spanId"]
    assert "parentSpanId" not in root_s
    assert _attr(root_s, "ratelimit.namespace") == {"stringValue": "ns"}
    assert _attr(root_s, "ratelimit.hits_addend") == {"intValue": "2"}
    assert _attr(root_s, "ratelimit.limited") == {"boolValue": True}
    assert _attr(child_s, "datastore.operation") == {
        "stringValue": "check_and_update"
    }
    assert int(child_s["startTimeUnixNano"]) >= int(
        root_s["startTimeUnixNano"]
    )
    assert int(child_s["endTimeUnixNano"]) <= int(root_s["endTimeUnixNano"])
    provider.shutdown()


def test_resource_carries_service_name(collector):
    provider = make_provider(
        BatchExporter(f"http://127.0.0.1:{collector.port}",
                      flush_interval_s=0.1)
    )
    with provider.get_tracer("t").start_as_current_span("s"):
        pass
    provider.force_flush()
    collector.wait_spans(1)
    path, body = collector.requests[0]
    assert path == "/v1/traces"
    res_attrs = body["resourceSpans"][0]["resource"]["attributes"]
    assert {"key": "service.name",
            "value": {"stringValue": "limitador"}} in res_attrs
    provider.shutdown()


def test_unreachable_collector_never_blocks():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    exporter = BatchExporter(
        f"http://127.0.0.1:{dead_port}", flush_interval_s=0.05,
        timeout_s=0.5,
    )
    provider = make_provider(exporter)
    tracer = provider.get_tracer("t")
    start = time.monotonic()
    for _ in range(50):
        with tracer.start_as_current_span("s"):
            pass
    assert time.monotonic() - start < 1.0
    deadline = time.monotonic() + 5.0
    while exporter.export_errors == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert exporter.export_errors > 0
    provider.shutdown()


def test_queue_overflow_drops_not_blocks():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    exporter = BatchExporter(
        f"http://127.0.0.1:{dead_port}", max_queue=8, flush_interval_s=30,
        timeout_s=0.2,
    )
    provider = make_provider(exporter)
    tracer = provider.get_tracer("t")
    for _ in range(64):
        with tracer.start_as_current_span("s"):
            pass
    assert exporter.dropped > 0
    provider.shutdown()


def test_tracing_module_spans_with_w3c_parent(collector):
    """configure_tracing installs the vendored pipeline, and the
    server's span helpers parent on an incoming traceparent."""
    msg = tracing.configure_tracing(f"http://127.0.0.1:{collector.port}")
    try:
        assert tracing.tracing_enabled()
        assert "OTLP/HTTP+JSON" in msg
        trace_id = "0af7651916cd43dd8448eb211c80319c"
        parent_id = "b7ad6b7169203331"
        carrier = {"traceparent": f"00-{trace_id}-{parent_id}-01"}
        with tracing.should_rate_limit_span("ns", 1, carrier) as record:
            with tracing.datastore_span("check_and_update"):
                assert tracing.current_trace_id() == trace_id
            record(True, "my-limit")
        tracing._provider.force_flush()
        spans = collector.wait_spans(2)
        by_name = {s["name"]: s for s in spans}
        root = by_name["should_rate_limit"]
        child = by_name["datastore"]
        assert root["traceId"] == trace_id
        assert root["parentSpanId"] == parent_id
        assert child["traceId"] == trace_id
        assert child["parentSpanId"] == root["spanId"]
        assert _attr(root, "ratelimit.limited") == {"boolValue": True}
        assert _attr(root, "ratelimit.limit_name") == {
            "stringValue": "my-limit"
        }
        assert _attr(child, "datastore.operation") == {
            "stringValue": "check_and_update"
        }
    finally:
        tracing._provider.shutdown()
        tracing._enabled = False


# -- the server with --tracing-endpoint -------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_tracing_endpoint_without_opentelemetry_exits_2(tmp_path,
                                                        monkeypatch):
    from limitador_tpu_torch.server import __main__ as port_main

    limits = tmp_path / "limits.yaml"
    limits.write_text("- namespace: ns\n  max_value: 1\n  seconds: 60\n")
    args = port_main.build_parser().parse_args([
        str(limits), "memory", "--http-host", "127.0.0.1",
        "--http-port", str(_free_port()), "--rls-host", "127.0.0.1",
        "--rls-port", str(_free_port()),
        "--tracing-endpoint", "http://127.0.0.1:4318"])
    # an import of opentelemetry now raises ImportError
    monkeypatch.setitem(sys.modules, "opentelemetry", None)
    with pytest.raises(tracing.TracingError, match="cannot be imported"):
        asyncio.run(port_main.start(args))
    assert not tracing.tracing_enabled()
    assert port_main.main([
        str(limits), "memory", "--http-port", str(_free_port()),
        "--rls-port", str(_free_port()),
        "--tracing-endpoint", "http://127.0.0.1:4318"]) == 2


def test_server_subprocess_exports_decision_spans(collector, tmp_path):
    import grpc

    from limitador_tpu_torch.server.proto import rls_pb2

    limits = tmp_path / "limits.yaml"
    limits.write_text("- namespace: ns\n  max_value: 5\n  seconds: 60\n"
                      "  variables: [\"descriptors[0].u\"]\n")
    rls_port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "limitador_tpu_torch.server", str(limits),
         "memory", "--http-host", "127.0.0.1",
         "--http-port", str(_free_port()), "--rls-host", "127.0.0.1",
         "--rls-port", str(rls_port), "--tracing-endpoint",
         f"http://127.0.0.1:{collector.port}"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )
    try:
        req = rls_pb2.RateLimitRequest(domain="ns")
        req.descriptors.add().entries.add(key="u", value="x")
        trace_id = "4bf92f3577b34da6a3ce929d0e0e4736"
        metadata = (("traceparent", f"00-{trace_id}-00f067aa0ba902b7-01"),)
        deadline = time.monotonic() + 30
        while True:
            try:
                with grpc.insecure_channel(f"127.0.0.1:{rls_port}") as ch:
                    fn = ch.unary_unary(
                        "/envoy.service.ratelimit.v3.RateLimitService/"
                        "ShouldRateLimit",
                        request_serializer=lambda m: m.SerializeToString(),
                        response_deserializer=(
                            rls_pb2.RateLimitResponse.FromString),
                    )
                    fn(req, metadata=metadata, timeout=5)
                break
            except grpc.RpcError:
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.monotonic() < deadline, "server did not start"
                time.sleep(0.2)
        spans = collector.wait_spans(2, timeout=15)
        root = [s for s in spans if s["name"] == "should_rate_limit"][0]
        child = [s for s in spans if s["name"] == "datastore"][0]
        assert root["traceId"] == trace_id == child["traceId"]
        assert child["parentSpanId"] == root["spanId"]
        assert _attr(root, "ratelimit.namespace") == {"stringValue": "ns"}
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_device_batch_spans_export_batch_id_and_phases(collector):
    """With an exporter and a recorder attached, every batch the
    MicroBatcher and the native pipeline decide exports a ``datastore``
    span (``device_batch``) with its batch id, request count and
    ``batch.phase.*_ms``; a hot-lane batch the native telemetry plane
    sampled also carries its native trace id and splits."""
    from limitador_tpu_torch import AsyncRateLimiter, Context, Limit, native
    from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage
    from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
    from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics
    from limitador_tpu_torch.server.proto import rls_pb2

    prior = (tracing._trace, tracing._provider, tracing._tracer,
             tracing._enabled)
    tracing.configure_tracing(f"http://127.0.0.1:{collector.port}")

    def blob(user):
        req = rls_pb2.RateLimitRequest(domain="nat")
        req.descriptors.add().entries.add(key="u", value=user)
        return req.SerializeToString()

    async def main():
        storage = AsyncTorchStorage(
            TorchStorage(capacity=256, device="cpu"), max_delay=0.001)
        limiter = AsyncRateLimiter(storage)
        limiter.add_limit(Limit("ns", 100, 60, [], ["u"]))
        storage.set_metrics(PrometheusMetrics())
        for i in range(3):
            await limiter.check_rate_limited_and_update(
                "ns", Context({"u": f"u{i}"}), 1)
        await storage.close()
        nat_storage = AsyncTorchStorage(
            TorchStorage(capacity=256, device="cpu"), max_delay=0.001)
        compiled = CompiledTorchLimiter(nat_storage)
        compiled.add_limit(Limit("nat", 100, 60, [], ["descriptors[0].u"]))
        compiled.set_metrics(PrometheusMetrics())
        pipeline = NativeRlsPipeline(compiled, max_delay=0.001)
        native.tel_config(True, 0, 1)  # stamp every begin
        try:
            await pipeline.submit(blob("a"))  # miss lane: mirrors the plan
            await pipeline.submit(blob("a"))  # hot lane
        finally:
            native.tel_config(False)
            await pipeline.close()
            await compiled.close()
            await nat_storage.close()

    try:
        asyncio.run(main())
        tracing._provider.force_flush()
        spans = [s for s in collector.wait_spans(5)
                 if _attr(s, "datastore.operation") == {
                     "stringValue": "device_batch"}]
    finally:
        tracing._provider.shutdown()
        (tracing._trace, tracing._provider, tracing._tracer,
         tracing._enabled) = prior
    assert len(spans) == 5
    ids = [int(_attr(s, "batch.id")["intValue"]) for s in spans]
    assert sorted(ids[:3]) == [1, 2, 3]
    for span in spans:
        assert span["name"] == "datastore"
        assert _attr(span, "batch.requests") == {"intValue": "1"}
        for phase in ("dispatch", "host_stage", "device_sync", "unpack"):
            assert "doubleValue" in _attr(span, f"batch.phase.{phase}_ms")
    native_spans = [s for s in spans[3:]
                    if _attr(s, "batch.phase.native_lane_ms") is not None]
    assert len(native_spans) == 2
    sampled = [s for s in native_spans
               if _attr(s, "native.trace_id") is not None]
    assert len(sampled) == 1  # the hot-lane begin; the miss lane has none
    assert "doubleValue" in _attr(sampled[0], "native.hot_lookup_ms")
