"""The port's process flight recorder and event log against the JAX
package's.

- A ``FlightRecorder`` of each package, on one clock, takes the same taps
  (numpy-seeded durations across the lanes, providers for trace ids and
  epochs, signal snapshots): equal ``flight_debug()``, ``contribute()``
  (windowed and whole) and worst-K tails, and equal ``flight_*``
  samples from ``poll``.
- ``BundleSpool`` retention by count and by bytes on ``tmp_path``, names
  with path separators refused, foreign files ignored.
- The ``TriggerEngine`` fires ``manual``, ``slo_burn``, ``drift`` and
  ``device_probe`` from a stub bus through ``tick()`` (no thread
  started), with the JAX engine's counts, names and bundles; the bundle's
  schema keys are the JAX ones; a bundle's ``torch.profiler`` capture
  names an exported Chrome trace; a capture stops only on the thread
  that started it.
- The recorder's ``lean`` tap, the native plane's ``native_hot`` tap and
  the tiers' ``cold_tier`` tap.
- ``PodEventLog`` and ``merge_events`` equal the JAX ones.

Every test runs inside ``torch_steady.steady()``.
"""

import json
import os
import threading

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from limitador_tpu.observability import events as j_events
from limitador_tpu.observability import flight as j_flight
from limitador_tpu.observability import signals as j_signals
from limitador_tpu.observability.metrics import (
    PrometheusMetrics as JPrometheusMetrics,
)
from limitador_tpu_torch import Context, Limit, RateLimiter
from limitador_tpu_torch.observability import (
    device_plane,
    events,
    flight,
    signals,
)
from limitador_tpu_torch.observability.metrics import PrometheusMetrics
from limitador_tpu_torch.tier import TieredStorage
from tests.torch_steady import steady


class Clock:
    def __init__(self, now=2000.0):
        self.now = now

    def __call__(self):
        return self.now


def _taps(rng, n):
    lanes = flight.FLIGHT_LANES
    return [
        dict(duration_s=float(rng.lognormal(-7, 1.2)),
             lane=lanes[int(rng.integers(0, len(lanes)))],
             request_id=f"r{i}" if i % 3 else None,
             namespace=("api", "tb", None)[i % 3],
             phases_ms={"device_sync": round(float(rng.uniform(0, 2)), 3)}
             if i % 2 else None,
             key=f"k{int(rng.integers(0, 50))}" if i % 5 else None)
        for i in range(n)
    ]


def _recorders(clock, **kw):
    out = []
    for mod in (flight, j_flight):
        rec = mod.FlightRecorder(clock=clock, **kw)
        rec.epoch_provider = lambda: 7
        rec.trace_provider = lambda: "ab" * 16
        out.append(rec)
    return out


def test_recorders_equal_jax():
    with steady():
        clock = Clock()
        port, jax = _recorders(clock, capacity=64, worst_k=8,
                               sample_stride=5)
        rng = np.random.default_rng(16)
        for i, tap in enumerate(_taps(rng, 900)):
            clock.now += 0.01
            for rec in (port, jax):
                rec.tap(**tap)
            if i % 100 == 0:
                vec = dict(ts=clock.now, slo_burn_5m=i / 100.0)
                port.note_signals(signals.ControlSignals(**vec))
                jax.note_signals(j_signals.ControlSignals(**vec))
        assert port.flight_debug() == jax.flight_debug()
        assert port.taps() == jax.taps() == 900
        for window in ((None, None), (2003.0, 2006.5), (2008.9, None)):
            assert port.contribute(*window) == jax.contribute(*window)
        tails = port.contribute()["worst"]
        assert set(tails) == set(flight.FLIGHT_LANES)
        assert all(len(t) == 8 for t in tails.values())
        for lane, tail in tails.items():
            durations = [e["duration_ms"] for e in tail]
            assert durations == sorted(durations, reverse=True), lane
        metrics, j_metrics = PrometheusMetrics(), JPrometheusMetrics()
        for _ in range(2):
            port.poll(metrics)
            jax.poll(j_metrics)
        assert _flight_samples(metrics) == _flight_samples(j_metrics)


def _flight_samples(metrics):
    return {
        (s.name, tuple(sorted(s.labels.items()))): s.value
        for family in text_string_to_metric_families(
            metrics.render().decode())
        if family.name.startswith("flight_")
        for s in family.samples if not s.name.endswith("_created")
    }


def test_constants_and_families_equal_jax():
    with steady():
        assert flight.FLIGHT_LANES == j_flight.FLIGHT_LANES
        assert flight.TRIGGER_REASONS == j_flight.TRIGGER_REASONS
        assert flight.FLIGHT_BUNDLE_SCHEMA == j_flight.FLIGHT_BUNDLE_SCHEMA
        assert flight.METRIC_FAMILIES == j_flight.METRIC_FAMILIES
        assert flight.DEFAULT_SAMPLE_STRIDE == j_flight.DEFAULT_SAMPLE_STRIDE
        for key, ns in ((None, None), ("k", None), (None, "api"),
                        (("a", 1), "x")):
            assert flight._key_hash(key, ns) == j_flight._key_hash(key, ns)
        declared = {f.name for f in text_string_to_metric_families(
            PrometheusMetrics().render().decode())}
        assert set(flight.METRIC_FAMILIES) <= declared


def test_spool_retention_and_reads(tmp_path):
    with steady():
        spool = flight.BundleSpool(tmp_path / "count", max_bundles=3)
        names = [f"flight-{1000 + i}-manual-h0.json" for i in range(5)]
        for name in names:
            spool.write(name, {"n": name})
        assert [b["name"] for b in spool.list()] == names[:1:-1]
        assert spool.read(names[0]) is None
        assert spool.read(names[4]) == {"n": names[4]}
        (tmp_path / "count" / "notes.txt").write_text("x" * 4096)
        assert len(spool.list()) == 3  # foreign files are not bundles
        for bad in ("../" + names[4], "a/" + names[4], "notes.txt"):
            assert spool.read(bad) is None
        by_bytes = flight.BundleSpool(tmp_path / "bytes", max_bytes=2500)
        for i in range(6):
            by_bytes.write(f"flight-{i + 1}-drift-h0.json",
                           {"pad": "y" * 1000})
        kept = by_bytes.list()
        assert [b["name"] for b in kept] == [
            "flight-6-drift-h0.json", "flight-5-drift-h0.json"]
        assert by_bytes.total_bytes() == sum(b["bytes"] for b in kept)
        assert {b["reason"] for b in kept} == {"drift"}
        j_spool = j_flight.BundleSpool(tmp_path / "bytes")
        assert j_spool.list() == kept


class Bus:
    def __init__(self, mod):
        self.mod = mod
        self.sig = mod.ControlSignals(ts=0.0)

    def set(self, **kw):
        self.sig = self.mod.ControlSignals(**kw)

    def snapshot(self):
        return self.sig


def _engines(tmp_path, clock):
    out = []
    for mod, smod, name in ((flight, signals, "port"),
                            (j_flight, j_signals, "jax")):
        rec = mod.FlightRecorder(sample_stride=1, clock=clock)
        bus = Bus(smod)
        engine = mod.TriggerEngine(
            rec, mod.BundleSpool(tmp_path / name), signals=bus,
            cooldown_s=0.0, clock=clock)
        out.append((engine, bus, rec))
    return out


def test_trigger_engine_fires_like_jax_through_tick(tmp_path):
    with steady():
        clock = Clock(5000.0)
        engines = _engines(tmp_path, clock)
        steps = [
            dict(slo_burn_5m=5.0, device_backed=1),  # primes: no fire
            dict(slo_burn_5m=5.0, device_backed=1),  # no new edge
            dict(slo_burn_5m=0.5, device_backed=1),
            dict(slo_burn_5m=3.0, device_backed=1),  # slo_burn
            dict(model_drift=1, device_backed=1),  # drift
            dict(device_backed=0),  # device_probe
        ]
        for i, kw in enumerate(steps):
            clock.now += 1.0
            for engine, bus, rec in engines:
                rec.tap(0.001 * (i + 1), "lean", request_id=f"r{i}")
                bus.set(ts=clock.now, **kw)
                engine.tick()
        clock.now += 1.0
        manual = [engine.flight_trigger(note="by hand")
                  for engine, _bus, _rec in engines]
        assert manual[0] == manual[1] and manual[0]["fired"]
        (port, _, _), (jax, _, _) = engines
        assert port.trigger_counts == jax.trigger_counts
        assert {r: n for r, n in port.trigger_counts.items() if n} == {
            "slo_burn": 1, "drift": 1, "device_probe": 1, "manual": 1}
        assert port.flight_bundles() == jax.flight_bundles()
        for entry in port.flight_bundles():
            got = port.flight_bundle(entry["name"])
            want = jax.flight_bundle(entry["name"])
            assert got == want
            assert set(got) == {
                "schema", "host", "reason", "note", "ts", "window",
                "tepoch", "signal_fields", "local", "events", "profile",
                "peers"}
            assert got["signal_fields"] == list(
                signals.ControlSignals.FIELDS)
        debug = port.flight_debug()
        assert debug == jax.flight_debug()
        assert debug["bundles"] == 4 and debug["recorder"]["taps"] == 6
        metrics, j_metrics = PrometheusMetrics(), JPrometheusMetrics()
        engines[0][2].poll(metrics)
        engines[1][2].poll(j_metrics)
        assert _flight_samples(metrics) == _flight_samples(j_metrics)


def test_bundle_profile_names_the_chrome_trace(tmp_path):
    """``--flight-profile-s`` > 0: the bundle carries a bounded
    ``torch.profiler`` capture, started and stopped on the firing
    thread, naming its exported trace; a capture already running leaves
    an ``{"error": ...}`` entry, as in the JAX package."""
    with steady():
        clock = Clock()
        profiler = device_plane.TorchProfiler(str(tmp_path / "prof"))
        engine = flight.TriggerEngine(
            flight.FlightRecorder(clock=clock),
            flight.BundleSpool(tmp_path / "spool"), profiler=profiler,
            profile_s=0.1, clock=clock)
        name = engine.flight_trigger(note="p", profile=True)["bundle"]
        entry = engine.flight_bundle(name)["profile"]
        assert set(entry) == {"trace_dir", "seconds", "trace"}
        assert entry["seconds"] == 0.1
        assert os.path.dirname(entry["trace"]) == str(tmp_path / "prof")
        with open(entry["trace"]) as f:
            assert "traceEvents" in json.load(f)
        profiler.start(str(tmp_path / "busy"))
        try:
            clock.now += 1.0
            name = engine.fire("slo_burn")
            assert "error" in engine.flight_bundle(name)["profile"]
        finally:
            profiler.stop()


def test_a_capture_stops_only_on_its_own_thread(tmp_path):
    with steady():
        profiler = device_plane.TorchProfiler(str(tmp_path))
        started = threading.Event()
        stop = threading.Event()
        out = {}

        def owner():
            profiler.start()
            started.set()
            stop.wait(10)
            out["dir"] = profiler.stop()

        thread = threading.Thread(target=owner)
        thread.start()
        try:
            assert started.wait(10)
            with pytest.raises(device_plane.ProfilerStateError):
                profiler.stop()
            assert profiler.status()["active"]
        finally:
            stop.set()
            thread.join(10)
        assert out["dir"] == str(tmp_path)
        assert os.path.exists(profiler.last_trace)
        assert not profiler.status()["active"]


def test_a_profiler_with_a_loop_captures_on_the_loop_thread(tmp_path):
    """The server's profiler runs a capture that another thread asks
    for (a flight bundle's) on its loop's thread, where /debug/profile
    runs its own."""
    import asyncio

    with steady():
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_forever)
        thread.start()
        try:
            profiler = device_plane.TorchProfiler(str(tmp_path), loop=loop)
            assert profiler.start() == str(tmp_path)
            assert device_plane._capture["thread"] == thread.ident
            assert profiler.stop() == str(tmp_path)
            assert os.path.exists(profiler.last_trace)
        finally:
            loop.call_soon_threadsafe(loop.stop)
            thread.join(10)
            loop.close()


def test_recorder_taps_the_lean_lane():
    with steady():
        t = [10.0]
        recorder = device_plane.DeviceStatsRecorder(clock=lambda: t[0])
        port, jax = _recorders(Clock(), sample_stride=2)
        recorder.flight_tap = port
        entries = [(9.99, "a", "api"), (9.98, None, "tb"), (9.5, "c", None)]
        recorder.record_batch(entries, 1, 9.995, {"device_sync": 0.002})
        phases_ms = recorder.phases_ms({"device_sync": 0.002})
        for t_enq, rid, ns in entries:
            jax.tap(t[0] - t_enq, "lean", request_id=rid, namespace=ns,
                    phases_ms=phases_ms)
        assert port.contribute() == jax.contribute()
        assert port.flight_debug()["tail_depth"]["lean"] == 3


def test_native_plane_taps_the_native_hot_lane():
    from limitador_tpu.observability.native_plane import (
        NativePlane as JNativePlane,
    )
    from limitador_tpu_torch.observability.native_plane import NativePlane

    exemplars = [
        {"total_ns": 80_000 * (i + 1), "lookup_ns": 30_000, "stage_ns": 9_000,
         "rows": 4, "kernel_rows": 3, "staged_hits": 3, "miss_rows": 1,
         "leased_rows": i % 2, "blob_digest": -12345 * (i + 1),
         "blob_len": 40, "plan_kind": 1, "lease_tokens": 2 * i}
        for i in range(5)
    ]
    with steady():
        plane = NativePlane(device_backed=False)
        try:
            recorder = device_plane.DeviceStatsRecorder()
            port, jax = _recorders(Clock(), sample_stride=3)
            recorder.flight_tap = port
            plane.attach_recorder(recorder)
            plane.drain_exemplars = lambda: list(exemplars)
            plane._offer_exemplars()
            j_recorder = type("R", (), {})()
            j_recorder.flight_tap = jax
            j_recorder.flight = device_plane.FlightRecorder(32)
            j_plane = JNativePlane.__new__(JNativePlane)
            j_plane.recorder = j_recorder
            j_plane.drain_exemplars = lambda: list(exemplars)
            j_plane._offer_exemplars()
            assert port.contribute() == jax.contribute()
            assert port.flight_debug()["tail_depth"]["native_hot"] == 5
            assert len(recorder.flight.snapshot()) == 5
        finally:
            plane.close()


def test_tiers_tap_the_cold_tier_lane():
    with steady():
        rec = flight.FlightRecorder(sample_stride=1)
        storage = TieredStorage(capacity=64, cache_size=2, device="cpu")
        storage.flight_tap = rec
        limiter = RateLimiter(storage)
        limiter.add_limit(Limit("ns", 10, 60, [], ["u"]))
        for u in ("a", "b", "c", "a", "d", "a"):
            limiter.check_rate_limited_and_update("ns", Context({"u": u}), 1)
        cold = storage.tier_stats()["cold"]["decisions"]
        assert cold > 0
        tail = rec.contribute()["worst"]["cold_tier"]
        assert rec.taps() == cold
        assert {e["namespace"] for e in tail} == {"ns"}


def test_event_logs_equal_jax():
    with steady():
        clock = Clock(100.0)
        logs = [(events.PodEventLog(host_id=h, capacity=6, clock=clock),
                 j_events.PodEventLog(host_id=h, capacity=6, clock=clock))
                for h in (0, 1)]
        assert events.EVENT_KINDS == j_events.EVENT_KINDS
        rng = np.random.default_rng(12)
        for i in range(30):
            # a clock that steps back: ts stays non-decreasing per host
            clock.now += float(rng.choice([0.5, -0.2, 0.0, 1.0]))
            host = int(rng.integers(0, 2))
            kind = events.EVENT_KINDS[int(rng.integers(
                0, len(events.EVENT_KINDS)))] if i % 7 else "made_up"
            detail = {"i": i} if i % 2 else {}
            got = [log.emit(kind, **detail) for log in logs[host]]
            assert got[0] == got[1]
        for port, jax in logs:
            assert port.events_debug() == jax.events_debug()
            assert port.events_debug(n=2, kind="made_up") == \
                jax.events_debug(n=2, kind="made_up")
            assert port.snapshot(0) == jax.snapshot(0) == []
            assert port.last_seq == jax.last_seq
        merged = events.merge_events(*(p.snapshot() for p, _ in logs))
        assert merged == j_events.merge_events(
            *(j.snapshot() for _, j in logs))
        keys = [(e["ts"], e["host"], e["seq"]) for e in merged]
        assert keys == sorted(keys)
        logs[0][0].clear()
        assert logs[0][0].snapshot() == []


def test_two_fires_within_a_millisecond_keep_two_bundles(tmp_path):
    """Two manual triggers at one clock reading (the control planes'
    served test sends two in a row, often 1-2 ms apart): the port's
    engine names the second past the first's millisecond and its spool
    keeps both; the JAX engine gives both one name, and its spool keeps
    the second alone."""
    with steady():
        clock = Clock(7000.0)
        engines = _engines(tmp_path, clock)
        for engine, _bus, _rec in engines:
            engine.tick()
        names = [[engine.flight_trigger(note=n)["bundle"]
                  for n in ("one", "two")] for engine, _bus, _rec in engines]
        (port, _, _), (jax, _, _) = engines
        assert names[0] == ["flight-7000000-manual-h0.json",
                            "flight-7000001-manual-h0.json"]
        assert names[1] == ["flight-7000000-manual-h0.json"] * 2
        assert port.trigger_counts["manual"] == jax.trigger_counts[
            "manual"] == 2
        assert [port.flight_bundle(n)["note"] for n in names[0]] == [
            "one", "two"]
        assert port.flight_debug()["bundles"] == 2
        assert jax.flight_debug()["bundles"] == 1
