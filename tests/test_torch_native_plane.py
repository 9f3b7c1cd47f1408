"""The port's native telemetry plane and SLO watchdog, on the CPU.

- ``NATIVE_PHASE_BUCKETS``, ``_prom_bucket_index``, ``PHASES`` and
  ``METRIC_FAMILIES`` equal the JAX package's (the host lane's phases and
  the native ingress's ``h2i_respond``).
- A ``SloWatchdog`` of each package on one injected clock, fed the same
  latencies, gives equal ``status()`` through firing and recovery; the
  recorder feeds the watchdog per batch; a breach is actionable only on
  the card.
- The C plane of the port's host lane (``hp_tel_*``): one observation per
  phase per begin and per finish, buckets that bracket the exact C sums,
  C time within the Python wall clock around the same calls, the begin's
  meta tail equal to what the plane recorded, every Nth begin stamped
  with a trace id, slow-row exemplars landing in the flight recorder.
- ``device_backed_runtime``: False for ``--device cpu``, None without a
  device storage.
- The ``/debug/stats`` sections under mixed traffic (hot, cold, unknown,
  multi-descriptor, leased rows) and after an interner-recycle context
  swap.

No test asserts a wall-clock duration or a ratio of two timings.
"""

import asyncio
import json
import time

import numpy as np
import pytest

from limitador_tpu.observability import native_plane as jnp_mod
from limitador_tpu_torch import Limit, native
from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage
from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
from limitador_tpu_torch.observability import native_plane as np_mod
from limitador_tpu_torch.observability.device_plane import (
    DeviceStatsRecorder,
)
from limitador_tpu_torch.observability.metrics import PrometheusMetrics
from limitador_tpu_torch.observability.native_plane import (
    NativePlane,
    SloWatchdog,
    device_backed_runtime,
)
from limitador_tpu_torch.server.proto import rls_pb2
from limitador_tpu_torch.storage.in_memory import InMemoryStorage
from tests.torch_steady import steady

D = "descriptors[0]"


@pytest.fixture(autouse=True)
def _steady():
    with steady():
        yield


def _blobs(n, users=256, domain="api"):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        req = rls_pb2.RateLimitRequest(domain=domain)
        d = req.descriptors.add()
        d.entries.add(key="m", value="GET")
        d.entries.add(key="u", value=f"user-{int(rng.integers(0, users))}")
        out.append(req.SerializeToString())
    return out


def _multi_descriptor_blob():
    req = rls_pb2.RateLimitRequest(domain="api")
    for val in ("a", "b"):
        req.descriptors.add().entries.add(key="u", value=val)
    return req.SerializeToString()


def _build_pipeline(metrics=None):
    storage = AsyncTorchStorage(
        TorchStorage(capacity=1 << 14, device="cpu"), max_delay=0.0005)
    limiter = CompiledTorchLimiter(storage)
    limiter.add_limit(
        Limit("api", 10**6, 60, [f"{D}.m == 'GET'"], [f"{D}.u"])
    )
    if metrics is not None:
        limiter.set_metrics(metrics)
    return NativeRlsPipeline(limiter, metrics, max_delay=0.0005,
                             max_batch=4096), limiter


async def _close(p, limiter):
    await p.close()
    await limiter.close()
    await limiter.storage.counters.close()


@pytest.fixture
def pipeline():
    p, limiter = _build_pipeline()
    yield p, limiter
    native.tel_config(False)
    asyncio.run(_close(p, limiter))


def _warm(p, blobs):
    """Derive and mirror the plans; returns the epoch to begin under."""
    p.decide_many(blobs, chunk=len(blobs))
    return p.plan_cache.epoch


# -- constants ---------------------------------------------------------------


def test_bucket_mapping_equals_jax():
    assert np_mod.NATIVE_PHASE_BUCKETS == jnp_mod.NATIVE_PHASE_BUCKETS
    for b in range(native.TEL_BUCKETS + 2):
        assert np_mod._prom_bucket_index(b) == jnp_mod._prom_bucket_index(b)
    assert np_mod.PHASES == jnp_mod.PHASES
    assert np_mod.METRIC_FAMILIES == jnp_mod.METRIC_FAMILIES
    assert native.TEL_PHASES + ("h2i_respond",) == np_mod.PHASES


# -- the SLO watchdog ----------------------------------------------------------


def test_slo_watchdogs_fire_and_recover_alike():
    """Healthy traffic, a sustained burn (5% at 5 ms against a 1% error
    budget) across both windows, then recovery: both packages' statuses
    are equal at every step, the watchdog fires under the burn and the
    short window clears first."""
    clock = [0.0]
    pair = (SloWatchdog(budget_ms=2.0, clock=lambda: clock[0]),
            jnp_mod.SloWatchdog(budget_ms=2.0, clock=lambda: clock[0]))
    statuses = []
    for healthy, steps in ((True, 30), (False, 31), (True, 31)):
        for _ in range(steps):
            batch = ([0.0001] * 200 if healthy
                     else [0.0001] * 190 + [0.005] * 10)
            for wd in pair:
                wd.observe_many(batch)
            clock[0] += 10.0
            port, jax = (wd.status() for wd in pair)
            assert port == jax
        statuses.append(port)
    calm, burning, recovered = statuses
    assert not calm["breached"] and calm["burn_rate_5m"] == 0.0
    assert burning["breached"] and burning["burn_rate_1h"] > 1.0
    assert not recovered["breached"] and recovered["burn_rate_5m"] == 0.0
    assert recovered["burn_rate_1h"] > 0.0


def test_slo_p99_within_bucket_resolution_alike():
    pair = (SloWatchdog(clock=lambda: 0.0),
            jnp_mod.SloWatchdog(clock=lambda: 0.0))
    for wd in pair:
        wd.observe_many([0.001] * 1000)
    port, jax = (wd.status() for wd in pair)
    assert port == jax
    assert 1.0 <= port["p99_ms_5m"] <= 2.048 and port["samples_5m"] == 1000


def test_slo_small_batches_bucket_like_jax():
    """Batches of one to 40 decisions give the same buckets, over-budget
    counts and statuses as the JAX package's watchdog, powers of two
    included."""
    rng = np.random.default_rng(1)
    clock = [0.0]
    port = SloWatchdog(clock=lambda: clock[0])
    jax = jnp_mod.SloWatchdog(clock=lambda: clock[0])
    for i in range(600):
        n = int(rng.integers(1, 41))
        values = (10 ** rng.uniform(-7, 1, n)).tolist()
        if i % 5 == 0:
            values = [2 ** int(rng.integers(0, 24)) / 1e6 for _ in range(n)]
        for wd in (port, jax):
            wd.observe_many(values)
        clock[0] += 0.5
        if i % 50 == 0:
            assert port.status() == jax.status()
    assert (port._counts == jax._counts).all()
    assert (port._over == jax._over).all()
    assert (port._total == jax._total).all()



@pytest.mark.parametrize("n", [1, 3, 8, 9, 300])
def test_slo_paths_bucket_alike(n):
    """The watchdog buckets batches of every size as the JAX watchdog
    does (one numpy path, as there), below 1 µs, at powers of two and
    past the top bucket included."""
    rng = np.random.default_rng(n)
    values = (10 ** rng.uniform(-8, 7, n)).tolist()
    values[: n // 3] = [2 ** int(rng.integers(0, 40)) / 1e6
                        for _ in range(n // 3)]
    pair = [SloWatchdog(clock=lambda: 5.0),
            jnp_mod.SloWatchdog(clock=lambda: 5.0)]
    for wd in pair:
        wd.observe_many(values)
    for name in ("_counts", "_total", "_over"):
        assert (getattr(pair[0], name) == getattr(pair[1], name)).all()
    assert pair[0]._total.sum() == n
    assert pair[0].status() == pair[1].status()

def test_recorder_feeds_the_watchdog_per_batch():
    now = [50.0]
    recorder = DeviceStatsRecorder(PrometheusMetrics(), clock=lambda: now[0])
    plane_wd = SloWatchdog(budget_ms=2.0, clock=lambda: now[0])
    recorder.slo = plane_wd
    recorder.record_batch(
        [(now[0] - 0.005, None, None), (now[0] - 0.0001, None, None)],
        batch_id=1, t_flush=now[0], phases={"device_sync": 0.001},
    )
    status = plane_wd.status()
    assert status["samples_5m"] == 2
    assert status["burn_rate_5m"] == 50.0  # 1 of 2 over budget / 0.01


@pytest.mark.parametrize("backed", [False, True, None])
def test_slo_breach_is_actionable_only_on_the_card(backed):
    clock = [0.0]
    wd = SloWatchdog(budget_ms=2.0, clock=lambda: clock[0])
    for _ in range(31):
        wd.observe_many([0.0001] * 190 + [0.005] * 10)
        clock[0] += 10.0
    plane = NativePlane(watchdog=wd, device_backed=backed)
    try:
        metrics = PrometheusMetrics()
        plane.poll(metrics)
        text = metrics.render().decode()
        assert "slo_breached 1.0" in text
        assert f"slo_breached_actionable {1.0 if backed else 0.0}" in text
        want_backed = {False: "0.0", True: "1.0", None: "-1.0"}[backed]
        assert f"device_backed {want_backed}" in text
        status = plane.slo_status()
        assert status["device_backed"] is backed
        assert status["actionable"] is bool(backed)
        assert plane.device_backed() is backed
    finally:
        plane.close()


def test_device_backed_runtime():
    storage = TorchStorage(capacity=64, device="cpu")
    assert device_backed_runtime(storage) is False
    assert device_backed_runtime(None) is None
    assert device_backed_runtime(InMemoryStorage(16)) is None


def test_planes_share_the_c_plane_until_the_last_closes():
    first, second = NativePlane(), NativePlane()
    assert native.tel_enabled()
    first.close()
    assert native.tel_enabled()
    second.close()
    second.close()
    assert not native.tel_enabled()


# -- the C plane -----------------------------------------------------------------


def test_native_drain_counts_every_begin_and_brackets_the_sums(pipeline):
    """N begins count exactly N observations in each begin phase, the
    log2 buckets bracket the exact C sums, and the C time lies within the
    Python wall clock around the same calls."""
    p, _limiter = pipeline
    lane = p._hot_lane
    blobs = _blobs(2048)
    epoch = _warm(p, blobs)
    native.tel_config(True)
    base = native.tel_drain()
    passes = 20
    t0 = time.perf_counter()
    for _ in range(passes):
        with p._native_lock:
            staged = lane.begin(blobs, epoch)
    py_ns = (time.perf_counter() - t0) * 1e9
    assert staged.k == len(blobs), "plans must serve from the mirror"
    snap = native.tel_drain()
    c_total = 0
    for phase in ("hot_lookup", "hot_stage"):
        assert snap[phase]["count"] - base[phase]["count"] == passes
        delta_sum = snap[phase]["sum_ns"] - base[phase]["sum_ns"]
        c_total += delta_sum
        buckets = np.asarray(snap[phase]["buckets"]) - np.asarray(
            base[phase]["buckets"])
        assert int(buckets.sum()) == passes
        lo = sum(c * 2.0**b for b, c in enumerate(buckets.tolist()))
        hi = sum(c * 2.0 ** (b + 1) for b, c in enumerate(buckets.tolist()))
        assert lo <= delta_sum <= hi
    for phase in ("lease_hit", "hot_finish"):
        assert snap[phase]["count"] == base[phase]["count"]
    assert c_total <= py_ns


def test_finish_phase_and_meta_tail(pipeline):
    p, _limiter = pipeline
    lane = p._hot_lane
    blobs = _blobs(512)
    epoch = _warm(p, blobs)
    native.tel_config(True)
    base = native.tel_drain()
    with p._native_lock:
        staged = lane.begin(blobs, epoch)
    mid = native.tel_drain()
    # the begin's meta tail is what the plane recorded for it
    assert staged.lookup_ns == (mid["hot_lookup"]["sum_ns"]
                                - base["hot_lookup"]["sum_ns"])
    assert staged.stage_ns == (mid["hot_stage"]["sum_ns"]
                               - base["hot_stage"]["sum_ns"])
    assert staged.leased_rows == 0 and staged.trace_id == 0
    lane.finish(staged, np.ones(len(blobs), bool), np.ones(lane.cap, bool))
    snap = native.tel_drain()
    assert snap["hot_finish"]["count"] - base["hot_finish"]["count"] == 1
    # disarmed: begins and finishes record nothing, the tail is zero
    native.tel_config(False)
    with p._native_lock:
        quiet = lane.begin(blobs, epoch)
    lane.finish(quiet, np.ones(len(blobs), bool), np.ones(lane.cap, bool))
    after = native.tel_drain()
    assert all(after[ph]["count"] == snap[ph]["count"] for ph in after)
    assert (quiet.lookup_ns, quiet.stage_ns, quiet.trace_id) == (0, 0, 0)


def test_trace_sampling_stamps_every_nth_begin(pipeline):
    p, _limiter = pipeline
    lane = p._hot_lane
    blobs = _blobs(128)
    epoch = _warm(p, blobs)
    native.tel_config(True, 0, 2)
    ids = []
    for _ in range(6):
        with p._native_lock:
            ids.append(lane.begin(blobs, epoch).trace_id)
    sampled = [t for t in ids if t]
    assert len(sampled) == 3, ids
    assert sampled == sorted(sampled) and len(set(sampled)) == 3
    assert all(t % 2 == 0 for t in sampled)


def test_exemplars_drain_into_the_flight_recorder(pipeline):
    p, _limiter = pipeline
    lane = p._hot_lane
    metrics = PrometheusMetrics()
    recorder = DeviceStatsRecorder(metrics)
    plane = NativePlane(slow_row_us=0.001, recorder=recorder)  # 1 ns/row
    try:
        blobs = _blobs(512)
        epoch = _warm(p, blobs)
        native.tel_exemplars()  # what the warm-up and earlier begins left
        with p._native_lock:
            lane.begin(blobs, epoch)
        plane.poll(metrics)
        entries = [e for e in recorder.flight.snapshot() if "native" in e]
        assert entries, "no exemplar reached the flight recorder"
        nat = entries[-1]["native"]
        assert nat["rows"] == 512 and nat["kernel_rows"] == 512
        assert nat["miss_rows"] == 0 and nat["leased_rows"] == 0
        assert len(nat["blob_digest"]) == 16
        assert set(entries[-1]["phases_ms"]) == {"native_lane"}
        text = metrics.render().decode()
        assert "native_phase_hot_lookup_count" in text
    finally:
        plane.close()


def test_poll_merges_bucket_increments_into_prometheus(pipeline):
    """Two renders: each adds exactly the begins since the last one to
    the native_phase_* counts (per-bucket baselines across drains)."""
    from prometheus_client.parser import text_string_to_metric_families

    p, _limiter = pipeline
    lane = p._hot_lane
    blobs = _blobs(64)
    epoch = _warm(p, blobs)
    metrics = PrometheusMetrics()
    plane = NativePlane()
    metrics.attach_native_plane(plane)
    try:
        def counts():
            out = {}
            for fam in text_string_to_metric_families(
                    metrics.render().decode()):
                for s in fam.samples:
                    if s.name.startswith("native_phase_") and \
                            s.name.endswith("_count"):
                        out[s.name] = s.value
            return out

        first = counts()
        for _ in range(3):
            with p._native_lock:
                lane.begin(blobs, epoch)
        second = counts()
        with p._native_lock:
            lane.begin(blobs, epoch)
        third = counts()
        for phase in ("hot_lookup", "hot_stage"):
            name = f"native_phase_{phase}_count"
            assert second[name] - first[name] == 3
            assert third[name] - second[name] == 1
    finally:
        plane.close()


# -- /debug/stats under live traffic ---------------------------------------------


def test_debug_stats_schema_under_mixed_traffic_and_recycle():
    from aiohttp.test_utils import TestClient, TestServer

    from limitador_tpu_torch.lease import LeaseConfig
    from limitador_tpu_torch.server.http_api import make_http_app

    metrics = PrometheusMetrics()
    p, limiter = _build_pipeline(metrics)
    storage = limiter.storage.counters
    plane = NativePlane(slow_row_us=0.001, trace_sample=4,
                        device_backed=device_backed_runtime(storage.inner))
    plane.attach_recorder(limiter.recorder)
    metrics.attach_native_plane(plane)
    broker = p.attach_lease(
        LeaseConfig(max_tokens=32, hot_threshold=2), autostart=False)

    def drive_mixed():
        hot = _blobs(512, users=32)
        cold = _blobs(64, users=10_000)
        unknown = _blobs(8, domain="elsewhere")
        mixed = hot + cold + unknown + [_multi_descriptor_blob()]
        for _ in range(3):
            p.decide_many(mixed, chunk=len(mixed))
        broker.refresh()  # grant leases to the hot plans
        p.decide_many(hot, chunk=len(hot))  # leased admissions

    async def fetch():
        app = make_http_app(limiter, metrics, {},
                            debug_sources=[storage, p, plane])
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            # a render drains the exemplar ring into the flight recorder
            assert (await client.get("/metrics")).status == 200
            resp = await client.get("/debug/stats")
            return resp.status, await resp.text()
        finally:
            await client.close()

    def check():
        status, body = asyncio.run(fetch())
        assert status == 200
        stats = json.loads(body)
        for section in ("queues", "shards", "flush_reasons",
                        "flight_recorder", "plan_cache", "native_build",
                        "native_hot_lane", "lease", "native_telemetry",
                        "slo", "device_backed", "profiler"):
            assert section in stats, section
        tel = stats["native_telemetry"]
        assert set(tel) == set(np_mod.PHASES)
        assert tel["hot_lookup"]["count"] > 0
        assert tel["lease_hit"]["count"] > 0
        assert set(tel["hot_lookup"]) == {"count", "mean_us", "p50_us",
                                          "p99_us"}
        assert set(stats["slo"]) == set(jnp_mod.SloWatchdog().status()) | {
            "device_backed", "actionable"}
        assert stats["slo"]["budget_ms"] == 2.0
        assert stats["device_backed"] is False
        assert stats["native_hot_lane"]["hits"] > 0
        assert stats["lease"]["lease_grants"] > 0
        return stats

    try:
        drive_mixed()
        first = check()
        # an interner-recycle context swap: the next begin swaps in a
        # fresh native context; every section survives it and the
        # process-global plane keeps counting
        p.max_interned = 0
        drive_mixed()
        second = check()
        assert (second["native_telemetry"]["hot_lookup"]["count"]
                > first["native_telemetry"]["hot_lookup"]["count"])
        assert any("native" in e for e in second["flight_recorder"])
    finally:
        plane.close()
        asyncio.run(_close(p, limiter))
