"""The port's device plane against the JAX package's, on the CPU.

- ``FlightRecorder`` and ``DeviceStatsRecorder`` (the cases of
  ``tests/test_device_plane.py``) get the same inputs in both packages:
  equal snapshots, tallies and metric samples; ``record_batch`` on one
  injected clock gives equal flight recorders and SLO feeds.
- ``collect_debug_stats`` carries the JAX walk's keys.
- A batcher without a recorder touches no observability object.
- With a recorder attached, the MicroBatcher, UpdateBatcher, compiled
  pipeline and native pipeline record what was driven: flushes by
  reason, one queue wait per request, one ``device_phase_latency``
  observation per phase per batch, and a flight recorder of at most 32
  entries, slowest first, whose request ids were sent.
- ``TorchProfiler``'s state machine, and ``/debug/profile`` and the
  ``/debug/stats`` sections on a CPU server.

Counts, keys and equality are asserted; no wall-clock duration is.
"""

import asyncio
import json
import os
import types

import aiohttp
import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from limitador_tpu.core.limiter import AsyncRateLimiter as JAsyncRateLimiter
from limitador_tpu.observability import device_plane as jdp
from limitador_tpu.observability.metrics import (
    PrometheusMetrics as JPrometheusMetrics,
)
from limitador_tpu.observability.native_plane import SloWatchdog as JSlo
from limitador_tpu.tpu.batcher import AsyncTpuStorage
from limitador_tpu.tpu.storage import TpuStorage
from limitador_tpu_torch import AsyncRateLimiter, Context, Limit
from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage
from limitador_tpu_torch.device import batcher as batcher_mod
from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
from limitador_tpu_torch.observability import device_plane as pdp
from limitador_tpu_torch.observability.metrics import PrometheusMetrics
from limitador_tpu_torch.observability.native_plane import SloWatchdog
from limitador_tpu_torch.server import __main__ as port_main
from limitador_tpu_torch.server.http_api import DEBUG_STATS_SECTIONS
from limitador_tpu_torch.server.proto import rls_pb2
from tests import torch_http as H
from tests.torch_steady import steady

parse = port_main.build_parser().parse_args
ROUTE_PHASES = ("dispatch", "host_stage", "device_sync", "unpack")
NATIVE_PHASES = ("dispatch", "host_cache", "native_lane", "host_stage",
                 "device_sync", "unpack")


@pytest.fixture(autouse=True)
def _steady():
    with steady():
        yield


class FakeClock:
    def __init__(self, now=100.0):
        self.now = now

    def __call__(self):
        return self.now


def _samples(metrics, family):
    """{(sample name, labels): value} of one family of a render."""
    text = metrics.render().decode()
    for fam in text_string_to_metric_families(text):
        if fam.name == family:
            return {(s.name, tuple(sorted(s.labels.items()))): s.value
                    for s in fam.samples}
    raise KeyError(family)


# -- the flight recorder and the recorder, both packages ----------------------


def _slowest_n(cls):
    fr = cls(capacity=3)
    for ms in (5, 1, 9, 3, 7):
        fr.offer(ms / 1e3, {"tag": ms})
    return fr.snapshot(), None


def _eviction_order(cls):
    fr = cls(capacity=2)
    fr.offer(0.010, {"tag": "a"})
    fr.offer(0.020, {"tag": "b"})
    admits = [fr.would_admit(0.005)]
    fr.offer(0.005, {"tag": "c"})
    admits.append(fr.would_admit(0.015))
    fr.offer(0.015, {"tag": "d"})
    return fr.snapshot(), admits


def _ties(cls):
    fr = cls(capacity=4)
    for tag in ("x", "y", "z"):
        fr.offer(0.004, {"tag": tag})
    return fr.snapshot(), None


def _clear(cls):
    fr = cls(capacity=2)
    fr.offer(0.001, {})
    fr.clear()
    return fr.snapshot(), None


@pytest.mark.parametrize("case", [_slowest_n, _eviction_order, _ties,
                                  _clear])
def test_flight_recorder_equals_jax(case):
    assert case(pdp.FlightRecorder) == case(jdp.FlightRecorder)


def test_flush_tallies_and_batch_ids_equal_jax():
    recs = (pdp.DeviceStatsRecorder(), jdp.DeviceStatsRecorder())
    for rec in recs:
        rec.record_flush("deadline", 0.5, [0.001])
        rec.record_flush("deadline", 0.25, [])
        rec.record_flush("size", 1.0, [0.002, 0.003])
        rec.record_phases({"dispatch": 0.1})
    assert recs[0].flush_reasons == recs[1].flush_reasons == {
        "size": 1, "deadline": 2, "shutdown": 0}
    assert [[r.next_batch_id() for _ in range(3)] for r in recs] == [
        [1, 2, 3]] * 2
    assert pdp.PHASES == jdp.PHASES
    assert pdp.FLUSH_REASONS == jdp.FLUSH_REASONS
    assert pdp.BATCHERS == jdp.BATCHERS


def test_recorder_families_equal_jax():
    metrics = (PrometheusMetrics(), JPrometheusMetrics())
    for m, cls in zip(metrics, (pdp.DeviceStatsRecorder,
                                jdp.DeviceStatsRecorder)):
        rec = cls(m)
        rec.record_flush("size", 2.0, [0.001, 0.002])  # ratio clamps to 1
        rec.record_flush("deadline", 0.5, [0.001], batcher="update")
        rec.record_phases({p: 0.001 for p in jdp.PHASES})
        rec.record_chunks([512, 512, 300])
    for family in ("batcher_flushes", "batcher_queue_wait",
                   "batcher_batch_fill_ratio", "device_phase_latency",
                   "dispatch_chunk_hits", "dispatch_chunk_splits"):
        port, jax = (_samples(m, family) for m in metrics)
        assert port == jax, family
    flushes = _samples(metrics[0], "batcher_flushes")
    assert flushes[("batcher_flushes_total",
                    (("batcher", "check"), ("reason", "size")))] == 1.0


def test_recorder_observes_at_once():
    """Each record reaches its family at once, as in the JAX recorder: a
    render shows every observation without a poll."""
    metrics = PrometheusMetrics()
    rec = pdp.DeviceStatsRecorder(metrics)
    rec.record_flush("deadline", 0.5, [0.001, 0.002])
    rec.record_phases({"dispatch": 0.001})
    rec.record_chunks([3])
    assert _samples(metrics, "batcher_queue_wait")[
        ("batcher_queue_wait_count", (("batcher", "check"),))] == 2.0
    assert _samples(metrics, "dispatch_chunk_splits")[
        ("dispatch_chunk_splits_count", ())] == 1.0
    for _ in range(100):
        rec.record_phases({"unpack": 0.0001})
    assert _samples(metrics, "device_phase_latency")[
        ("device_phase_latency_count", (("phase", "unpack"),))] == 100.0


def test_request_id_contextvar_roundtrip():
    pdp.set_request_id("rid-1")
    assert pdp.current_request_id() == "rid-1"
    pdp.set_request_id(None)
    assert pdp.current_request_id() is None


def test_record_batch_on_one_clock_equals_jax(monkeypatch):
    """The same batches, on one injected clock, give both packages'
    recorders equal flight recorders, and their watchdogs equal
    statuses."""
    clock = FakeClock(1000.0)
    monkeypatch.setattr(jdp, "time", types.SimpleNamespace(
        perf_counter=clock))
    port = pdp.DeviceStatsRecorder(flight_capacity=4, clock=clock)
    jax = jdp.DeviceStatsRecorder(flight_capacity=4)
    port.slo = SloWatchdog(budget_ms=2.0, clock=clock)
    jax.slo = JSlo(budget_ms=2.0, clock=clock)
    jax.model = None
    rng = np.random.default_rng(5)
    for batch_id in range(1, 7):
        clock.now += 0.01
        t_flush = clock.now - 0.0005
        entries = [(clock.now - float(w), f"r{batch_id}-{i}", f"ns{i % 2}")
                   for i, w in enumerate(rng.uniform(1e-4, 6e-3, 5))]
        phases = {p: float(v) for p, v in zip(
            ROUTE_PHASES, rng.uniform(1e-5, 1e-3, 4))}
        for rec in (port, jax):
            rec.record_batch(entries, batch_id, t_flush, phases)
    assert port.flight.snapshot() == jax.flight.snapshot()
    assert len(port.flight.snapshot()) == 4
    assert port.slo.status() == jax.slo.status()
    assert port.slo.status()["samples_5m"] == 30


def test_debug_stats_walk_carries_the_jax_keys():
    async def main():
        port = AsyncTorchStorage(TorchStorage(capacity=64, device="cpu"))
        jax = AsyncTpuStorage(TpuStorage(capacity=64))
        for storage in (port, jax):
            storage.set_metrics(None)
        got = pdp.collect_debug_stats(AsyncRateLimiter(port))
        want = jdp.collect_debug_stats(JAsyncRateLimiter(jax))
        await port.close()
        await jax.close()
        return got, want

    got, want = asyncio.run(main())
    assert set(got) == set(want)
    assert got["flush_reasons"] == want["flush_reasons"]
    assert [q["queue"] for q in got["queues"]] == [
        q["queue"] for q in want["queues"]]
    assert set(got["shards"][0]) == set(want["shards"][0])


# -- the batchers and pipelines, detached and attached ----------------------


def test_detached_batchers_touch_no_observability_objects(monkeypatch):
    def trip(*_a, **_k):
        raise AssertionError("observability object touched while detached")

    monkeypatch.setattr(batcher_mod, "current_request_id", trip)
    for name in ("record_flush", "record_phases", "record_batch",
                 "record_chunks", "record_decision", "next_batch_id"):
        monkeypatch.setattr(pdp.DeviceStatsRecorder, name, trip)
    monkeypatch.setattr(pdp.FlightRecorder, "offer", trip)

    async def main():
        storage, limiter = _standard(dispatch_chunk=0)
        for i in range(20):
            r = await limiter.check_rate_limited_and_update(
                "ns", Context({"u": f"u{i % 3}"}), 1)
            assert not r.limited
        await limiter.update_counters("ns", Context({"u": "x"}), 1)
        assert storage.recorder is None
        await storage.close()

    asyncio.run(main())


def _standard(dispatch_chunk=None, max_delay=0.002):
    storage = AsyncTorchStorage(
        TorchStorage(capacity=1 << 10, device="cpu"), max_delay=max_delay,
        dispatch_chunk=dispatch_chunk,
    )
    limiter = AsyncRateLimiter(storage)
    limiter.add_limit(Limit("ns", 1000, 60, [], ["u"]))
    return storage, limiter


def _spy(obj, name, calls):
    fn = getattr(obj, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    setattr(obj, name, counted)


def _count(metrics, family, sample, **labels):
    values = _samples(metrics, family)
    return values.get((sample, tuple(sorted(labels.items()))), 0.0)


def _assert_flight(rec, sent):
    flight = rec.flight.snapshot()
    assert 0 < len(flight) <= 32
    durations = [e["duration_ms"] for e in flight]
    assert durations == sorted(durations, reverse=True)
    assert {e["request_id"] for e in flight} <= sent
    return flight


def test_attached_micro_and_update_batchers_record_what_was_driven():
    """Sequential checks (one flush each), a burst in one flush and
    sequential reports: the recorder's tallies and families equal the
    flushes, requests and launches the storage saw."""
    async def main():
        storage, limiter = _standard(dispatch_chunk=0)
        metrics = PrometheusMetrics()
        storage.set_metrics(metrics)
        begins, applies = [], []
        _spy(storage.inner, "begin_check_many", begins)
        _spy(storage.inner, "apply_deltas", applies)
        sent = set()

        async def check(i):
            rid = f"rid-{i}"
            sent.add(rid)
            pdp.set_request_id(rid)
            return await limiter.check_rate_limited_and_update(
                "ns", Context({"u": f"u{i % 5}"}), 1)

        for i in range(12):
            await check(i)
        await asyncio.gather(*[check(100 + i) for i in range(40)])
        for i in range(6):
            await limiter.update_counters("ns", Context({"u": "r"}), 1)
        rec = storage.recorder
        result = (rec, metrics, len(begins), len(applies), sent)
        await storage.close()
        return result

    rec, metrics, n_begins, n_applies, sent = asyncio.run(main())
    assert n_begins >= 13 and n_applies == 6
    flushes = sum(_count(metrics, "batcher_flushes", "batcher_flushes_total",
                         batcher="check", reason=r) for r in pdp.FLUSH_REASONS)
    assert flushes == n_begins  # dispatch_chunk=0: one launch a flush
    assert _count(metrics, "batcher_flushes", "batcher_flushes_total",
                  batcher="update", reason="deadline") == n_applies
    assert rec.flush_reasons["deadline"] + rec.flush_reasons["size"] == (
        n_begins + n_applies)
    assert _count(metrics, "batcher_queue_wait", "batcher_queue_wait_count",
                  batcher="check") == 52
    assert _count(metrics, "batcher_queue_wait", "batcher_queue_wait_count",
                  batcher="update") == 6
    for phase in ROUTE_PHASES:
        assert _count(metrics, "device_phase_latency",
                      "device_phase_latency_count", phase=phase) == n_begins
    assert _count(metrics, "dispatch_chunk_splits",
                  "dispatch_chunk_splits_count") == n_begins
    flight = _assert_flight(rec, sent)
    assert len(flight) == 32 and {e["namespace"] for e in flight} == {"ns"}


def test_attached_compiled_pipeline_records_what_was_driven():
    async def main():
        storage = AsyncTorchStorage(
            TorchStorage(capacity=1 << 10, device="cpu"), max_delay=0.002)
        limiter = CompiledTorchLimiter(storage, dispatch_chunk=0)
        limiter.add_limit(Limit("ns", 1000, 60, [], ["descriptors[0].u"]))
        metrics = PrometheusMetrics()
        limiter.set_metrics(metrics)
        assert limiter.recorder is storage.recorder is not None
        begins = []
        _spy(storage.inner, "begin_check_many", begins)
        sent = set()

        async def check(i):
            rid = f"c-{i}"
            sent.add(rid)
            pdp.set_request_id(rid)
            return await limiter.check_rate_limited_and_update(
                "ns", {"u": f"u{i % 4}"}, 1)

        for i in range(8):
            await check(i)
        await asyncio.gather(*[check(50 + i) for i in range(30)])
        await limiter.close()
        await storage.close()
        return limiter.recorder, metrics, len(begins), sent

    rec, metrics, n_begins, sent = asyncio.run(main())
    flushes = sum(_count(metrics, "batcher_flushes", "batcher_flushes_total",
                         batcher="check", reason=r) for r in pdp.FLUSH_REASONS)
    assert flushes == n_begins >= 9
    assert _count(metrics, "batcher_queue_wait", "batcher_queue_wait_count",
                  batcher="check") == 38
    for phase in ROUTE_PHASES:
        assert _count(metrics, "device_phase_latency",
                      "device_phase_latency_count", phase=phase) == n_begins
    flight = _assert_flight(rec, sent)
    assert len(flight) == 32


def _blob(user, domain="nat"):
    req = rls_pb2.RateLimitRequest(domain=domain)
    req.descriptors.add().entries.add(key="u", value=user)
    return req.SerializeToString()


def test_attached_native_pipeline_records_what_was_driven():
    """Hot-lane traffic through ``submit``: every chunk records the six
    pipeline phases once, every decided row one queue wait."""
    async def main():
        storage = AsyncTorchStorage(
            TorchStorage(capacity=1 << 10, device="cpu"), max_delay=0.001)
        limiter = CompiledTorchLimiter(storage)
        limiter.add_limit(Limit("nat", 1000, 60, [], ["descriptors[0].u"]))
        pipeline = NativeRlsPipeline(limiter, max_delay=0.001,
                                     dispatch_chunk=0)
        metrics = PrometheusMetrics()
        limiter.set_metrics(metrics)
        assert pipeline.recorder is storage.recorder
        begins = []
        _spy(pipeline, "_timed_begin_batch", begins)
        sent = set()

        async def one(i):
            rid = f"n-{i}"
            sent.add(rid)
            pdp.set_request_id(rid)
            return await pipeline.submit(_blob(f"u{i % 3}"))

        for i in range(10):
            await one(i)
        outs = await asyncio.gather(*[one(40 + i) for i in range(30)])
        assert all(
            rls_pb2.RateLimitResponse.FromString(o).overall_code
            == rls_pb2.RateLimitResponse.OK for o in outs)
        await pipeline.close()
        await storage.close()
        return storage.recorder, metrics, len(begins), sent, pipeline

    rec, metrics, n_begins, sent, pipeline = asyncio.run(main())
    assert pipeline.lane_stats()["hits"] > 0
    flushes = sum(_count(metrics, "batcher_flushes", "batcher_flushes_total",
                         batcher="check", reason=r) for r in pdp.FLUSH_REASONS)
    assert flushes == n_begins >= 11
    assert _count(metrics, "batcher_queue_wait", "batcher_queue_wait_count",
                  batcher="check") == 40
    for phase in NATIVE_PHASES:
        assert _count(metrics, "device_phase_latency",
                      "device_phase_latency_count", phase=phase) == n_begins
    flight = _assert_flight(rec, sent)
    assert len(flight) == 32


# -- torch.profiler captures -------------------------------------------------


def test_torch_profiler_state_machine(tmp_path):
    profiler = pdp.TorchProfiler(str(tmp_path / "default"))
    assert profiler.status() == {
        "active": False, "trace_dir": None, "started_at": None}
    with pytest.raises(pdp.ProfilerStateError):
        profiler.stop()
    target = profiler.start()
    assert target == str(tmp_path / "default")
    status = profiler.status()
    assert status["active"] and status["trace_dir"] == target
    # one capture per process: a second profiler sees it too
    other = pdp.TorchProfiler(str(tmp_path / "other"))
    assert other.status()["active"]
    with pytest.raises(pdp.ProfilerStateError):
        other.start()
    assert other.stop() == target
    traces = list((tmp_path / "default").glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    assert not profiler.status()["active"]
    with pytest.raises(pdp.ProfilerStateError):
        profiler.stop()
    # a directory that cannot be created fails the start, leaves it idle
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.raises(OSError):
        profiler.start(str(blocker / "sub"))
    assert not profiler.status()["active"]


def test_profile_dir_option_and_default():
    args = parse(["limits.yaml"])
    assert args.profile_dir == pdp.default_profile_dir()
    assert os.path.basename(args.profile_dir) == "limitador-tpu-profile"
    assert parse(["limits.yaml", "--profile-dir", "/x"]).profile_dir == "/x"


def test_debug_profile_and_stats_on_a_cpu_server(tmp_path):
    """A ``torch --device cpu`` server with the standard pipeline:
    ``/debug/profile`` start, status, stop and 409s; ``/debug/stats``
    serves the device-plane sections with the JAX keys."""
    limits = tmp_path / "limits.yaml"
    limits.write_text(H.LIMITS)
    http_port = H.free_port()
    argv = H.port_argv(limits, "torch", http_port, "--profile-dir",
                       str(tmp_path / "prof"), "--usage-topk", "0")

    async def main():
        server = await port_main.start(parse(argv))
        base = f"http://127.0.0.1:{http_port}"
        out = {}
        try:
            async with aiohttp.ClientSession() as session:
                async def call(method, path, body=None):
                    async with session.request(method, base + path,
                                               json=body) as resp:
                        raw = await resp.read()
                        return resp.status, json.loads(raw) if raw else None

                for i in range(5):
                    await call("POST", "/check_and_report", {
                        "namespace": "api",
                        "values": {"method": "GET", "user": f"u{i}",
                                   "tenant": "t"}})
                out["idle"] = await call("GET", "/debug/profile")
                out["start"] = await call("POST", "/debug/profile",
                                          {"action": "start"})
                out["status"] = await call("GET", "/debug/profile")
                out["again"] = await call("POST", "/debug/profile",
                                          {"action": "start"})
                await call("POST", "/check_and_report", {
                    "namespace": "api",
                    "values": {"method": "GET", "user": "p", "tenant": "t"}})
                out["stop"] = await call("POST", "/debug/profile",
                                         {"action": "stop"})
                out["stop_again"] = await call("POST", "/debug/profile",
                                               {"action": "stop"})
                out["bad"] = await call("POST", "/debug/profile",
                                        {"action": "pause"})
                out["stats"] = await call("GET", "/debug/stats")
                out["spec"] = await call("GET", "/api/spec")
        finally:
            await server.stop()
        return out

    out = asyncio.run(main())
    prof = str(tmp_path / "prof")
    assert out["idle"] == (200, {"active": False, "trace_dir": None,
                                 "started_at": None})
    assert out["start"] == (200, {"status": "started", "trace_dir": prof})
    assert out["status"][1]["active"] and out["status"][1]["trace_dir"] == prof
    assert out["again"][0] == 409
    assert out["stop"] == (200, {"status": "stopped", "trace_dir": prof})
    assert out["stop_again"][0] == 409
    assert out["bad"][0] == 400
    assert len(list((tmp_path / "prof").glob("*.pt.trace.json"))) == 1
    status, stats = out["stats"]
    assert status == 200
    for key in ("profiler", "flush_reasons", "flight_recorder",
                "native_telemetry", "slo", "device_backed"):
        assert key in stats, key
    assert set(stats) - {"queues", "shards", "flush_reasons",
                         "flight_recorder", "plan_cache"} <= set(
        DEBUG_STATS_SECTIONS)
    assert stats["profiler"] == {"active": False, "trace_dir": None,
                                 "started_at": None}
    assert set(stats["flush_reasons"]) == set(jdp.FLUSH_REASONS)
    assert sum(stats["flush_reasons"].values()) >= 6
    assert {e["namespace"] for e in stats["flight_recorder"]} <= {"api"}
    assert stats["device_backed"] is False
    assert set(stats["slo"]) == set(JSlo().status()) | {
        "device_backed", "actionable"}
    assert stats["slo"]["samples_5m"] == 6
    assert "/debug/profile" in out["spec"][1]["paths"]
    assert "ProfileAction" in out["spec"][1]["components"]["schemas"]
