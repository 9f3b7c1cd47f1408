"""The port's native pod fast path against the JAX package, in process.

- The C ownership mirror of ``csrc/hostpath.cc``: ``hp_pod_hash`` equals
  the JAX library's and ``zlib.crc32``; ``pod_owner`` equals the JAX
  lane's and both packages' ``PodTopology`` verdicts for 2 to 120 hosts;
  ``pod_config`` takes ``128 - LANE_FOREIGN_BASE`` hosts and refuses one
  more; the same plans, mirrored and stamped in both libraries, give the
  same code column (``LANE_FOREIGN_BASE + owner`` included), the same
  ``foreign_rows`` and the same lane counts from a begin; ``plan_export``
  gives the JAX export's bytes; ``partition_positions`` equals the JAX C
  pass and the numpy route on both sides of the threshold.
- Two in-process hosts over a real gRPC hop (each a ``TorchStorage(
  device="cpu")`` behind a ``PodFrontend`` whose ``attach_pipeline`` arms
  the split), fed the native-lane fuzz corpus (seeds 21 and 22) round
  robin: every decision equals the JAX package's single-process
  ``RateLimiter(InMemoryStorage)`` on the same clock, and the union of
  the hosts' counters equals its counters.
- The bulk hop carries the request id and the hop breakdown as the JAX
  lane's does; a dead owner's rows are answered with no error; a psum
  namespace takes the exact path; the ``pod_hot_*``/``pod_bulk_*``
  families have the JAX names, types and help; a triggered flight
  engine's bundle holds the peer's rings, as the JAX engine's does.

Every comparison is exact (decisions and counts are integers). Every
test runs inside ``torch_steady.steady()``: the lanes, pipelines and
engines it starts are stopped, and their threads checked, in teardown.
"""

import asyncio
import ctypes
import threading
import zlib

import numpy as np
import pytest

from limitador_tpu import Limit as JLimit
from limitador_tpu import native as jnative
from limitador_tpu import routing as jrouting
from limitador_tpu_torch import Limit as TLimit
from limitador_tpu_torch import native
from limitador_tpu_torch import routing as prouting
from limitador_tpu_torch.server.proto import rls_pb2

from .torch_native_corpus import FROZEN_NOW, corpus, limits
from .test_torch_pod import _adversarial_keys
from .torch_pod_pair import (
    bound_lanes,
    close_pair,
    counter_state,
    pod_pair,
    port_state,
)
from .torch_reference import jax_reference_lane  # noqa: F401 (autouse)
from .torch_steady import steady


@pytest.fixture(scope="module")
def _grpc_poller():
    """grpc's asyncio poller thread comes up with the process's first
    asyncio server and may outlive its stop: one lane serves for the
    whole module, so that the thread starts before any test's thread
    census and stays one thread."""
    from limitador_tpu_torch.server.peering import PeerLane

    lane = PeerLane(0, "127.0.0.1:0", {}, None)
    lane.start()
    yield
    lane.stop()


@pytest.fixture(autouse=True)
def _steady(_grpc_poller):
    with steady():
        yield


# -- the C ownership mirror ----------------------------------------------------


def _random_keys(rng, n=200):
    """Counter keys of random namespaces, limits and values."""
    keys = []
    for i in range(n):
        ns = f"ns-{int(rng.integers(0, 50))}"
        value = "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, 12))
        keys.append(((ns, f"limit-{i % 7}", int(rng.integers(1, 100)), 60),
                     (("descriptors[0].u", value),)))
    return keys


def test_pod_hash_equals_the_jax_hash_and_zlib():
    rng = np.random.default_rng(23)
    for n in (0, 1, 7, 64, 1024, 9000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert native.pod_hash(data) == jnative.pod_hash(data) == (
            zlib.crc32(data))
    for key in _adversarial_keys():
        data = repr(key).encode()
        assert native.pod_hash(data) == prouting.stable_hash(key) == (
            jrouting.stable_hash(key))


@pytest.mark.parametrize("hosts,sph", [
    (2, 1), (2, 4), (3, 2), (7, 8), (64, 1), (119, 2), (120, 1)])
def test_pod_owner_equals_the_jax_lane_and_both_topologies(hosts, sph):
    rng = np.random.default_rng(hosts * 31 + sph)
    hp, jhp = native.HostPath(), jnative.HostPath()
    try:
        for host_id in (0, hosts - 1):
            hp.pod_config(hosts, host_id, sph)
            jhp.pod_config(hosts, host_id, sph)
            topo = prouting.PodTopology(hosts, host_id, sph)
            jtopo = jrouting.PodTopology(hosts, host_id, sph)
            for key in _adversarial_keys() + _random_keys(rng):
                data = repr(key).encode()
                owner = hp.pod_owner(data)
                assert owner == jhp.pod_owner(data), key
                assert owner == topo.owner_host(key) == jtopo.owner_host(
                    key), key
        # one host: every key answers this host, in both libraries
        hp.pod_config(1, 0, 4)
        jhp.pod_config(1, 0, 4)
        for key in _adversarial_keys()[:8]:
            data = repr(key).encode()
            assert hp.pod_owner(data) == jhp.pod_owner(data) == 0
    finally:
        hp.close()
        jhp.close()


def test_pod_config_holds_the_int8_owner_code():
    assert native.LANE_FOREIGN == jnative.LANE_FOREIGN
    assert native.LANE_FOREIGN_BASE == jnative.LANE_FOREIGN_BASE
    cap = 128 - native.LANE_FOREIGN_BASE
    hp, jhp = native.HostPath(), jnative.HostPath()
    try:
        for lane in (hp, jhp):
            lane.pod_config(cap, 0, 1)
            with pytest.raises(RuntimeError, match="int8 owner encoding"):
                lane.pod_config(cap + 1, 0, 1)
    finally:
        hp.close()
        jhp.close()


def _mirror_plans(pkg, rng, hosts, host_id, sph):
    """A HostPath and hot lane of ``pkg`` with 60 plans of every kind
    mirrored and stamped (single-key owners through the C crc32, pinned
    owners set), in the order the seed gives; the same calls for both
    packages."""
    hp = pkg.HostPath()
    hp.pod_config(hosts, host_id, sph)
    lane = hp.hot_lane(4095, cap=1 << 12, max_rows=1 << 10)
    ns_tokens = [hp.intern(f"ns-{i}") for i in range(3)]
    name_tokens = [hp.intern(f"limit-{i}") for i in range(3)]
    blobs = []
    for i in range(60):
        blob = f"plan-{i}".encode() + bytes(int(b) for b in rng.integers(
            0, 256, int(rng.integers(0, 40))))
        kind = [pkg.LANE_KERNEL, pkg.LANE_KERNEL, pkg.LANE_OK,
                pkg.LANE_UNKNOWN, pkg.LANE_FOREIGN][i % 5]
        ns = int(rng.integers(0, 3))
        delta = int(rng.integers(1, 4))
        rec = None
        if kind == pkg.LANE_KERNEL:
            nh = int(rng.integers(1, 4))
            rec = np.stack([
                rng.integers(0, 4000, nh), np.full(nh, 10),
                np.full(nh, 60_000), rng.integers(0, 2, nh),
                np.asarray(name_tokens)[rng.integers(0, 3, nh)],
            ], axis=1).astype(np.int32)
        lane.plan_put(blob, 0, kind, ns_tokens[ns], delta, delta, rec,
                      ns=f"ns-{ns}")
        stamp = i % 3
        if stamp == 0:
            key = ((f"ns-{ns}", "limit", 5, 60), (("u", f"user-{i}"),))
            lane.plan_stamp_owner(blob, 0, repr(key).encode())
        elif stamp == 1:
            lane.plan_set_owner(blob, 0, int(rng.integers(-1, hosts)))
        blobs.append(blob)
    return hp, lane, blobs


def test_begin_answers_foreign_rows_as_the_jax_lane():
    hosts, host_id, sph = 4, 1, 2
    port = _mirror_plans(native, np.random.default_rng(5), hosts, host_id,
                         sph)
    jax = _mirror_plans(jnative, np.random.default_rng(5), hosts, host_id,
                        sph)
    try:
        rng = np.random.default_rng(6)
        blobs = port[2]
        for _batch in range(4):
            rows = [blobs[int(i)] for i in rng.integers(0, len(blobs), 96)]
            rows += [b"never-mirrored-%d" % i for i in range(5)]
            got = port[1].begin(rows, 0)
            want = jax[1].begin(rows, 0)
            np.testing.assert_array_equal(got.codes, want.codes)
            assert got.foreign_rows == want.foreign_rows
            assert got.foreign_rows == int(
                (got.codes >= native.LANE_FOREIGN_BASE).sum())
            assert (got.k, got.nhits, got.H) == (want.k, want.nhits, want.H)
            np.testing.assert_array_equal(got.rows, want.rows)
            for mine, theirs in zip(port[1].kernel_columns(got.H),
                                    jax[1].kernel_columns(want.H)):
                np.testing.assert_array_equal(mine, theirs)
        stats = port[0].lane_stats()
        assert stats == jax[0].lane_stats()
        assert stats["foreign"] > 0
        assert stats["hits"] > 0 and stats["misses"] > 0
        codes = set(got.codes.tolist())
        assert native.LANE_MISS in codes and native.LANE_KERNEL in codes
        assert any(c >= native.LANE_FOREIGN_BASE for c in codes)
    finally:
        port[0].close()
        jax[0].close()


def test_plan_export_is_the_jax_export():
    hp, _lane, _blobs = _mirror_plans(native, np.random.default_rng(7),
                                      3, 0, 1)
    jhp, _jlane, _jblobs = _mirror_plans(jnative,
                                         np.random.default_rng(7), 3, 0, 1)
    try:
        need = jhp._lib.hp_plan_export(jhp._ctx, None, 0)
        buf = (ctypes.c_uint8 * need)()
        assert jhp._lib.hp_plan_export(jhp._ctx, buf, need) == need
        raw = hp.plan_export_bytes()
        assert raw == bytes(buf)
        assert int.from_bytes(raw[:8], "little") == 60  # live entries
        # the JAX parse of the same bytes reads every owner stamped
        owners = {e["owner"] for e in jhp.plan_export()}
        assert len(owners) > 1 and -1 in owners
    finally:
        hp.close()
        jhp.close()


@pytest.mark.parametrize("m", [0, 1, 100, 2047, 2048, 5000])
def test_partition_positions_equal_the_jax_routes(m, monkeypatch):
    from limitador_tpu.tpu.storage import _partition_positions as jpart

    from limitador_tpu_torch.device import storage as tstorage

    rng = np.random.default_rng(m)
    ids = rng.integers(0, 8, m).astype(np.int32)
    # the numpy route, written out
    counts = np.bincount(ids, minlength=8)
    pos = np.empty(m, np.int64)
    seen = np.zeros(8, np.int64)
    for i, g in enumerate(ids.tolist()):
        pos[i] = seen[g]
        seen[g] += 1
    c_counts, c_pos = native.partition_positions(ids, 8)
    j_counts, j_pos = jnative.partition_positions(ids, 8)
    calls = []
    real = native.partition_positions
    monkeypatch.setattr(native, "partition_positions",
                        lambda *a: calls.append(1) or real(*a))
    t_counts, t_pos = tstorage._partition_positions(ids, 8)
    jc, jp = jpart(ids, 8)
    for got_counts, got_pos in ((c_counts, c_pos), (j_counts, j_pos),
                                (t_counts, t_pos), (jc, jp)):
        np.testing.assert_array_equal(got_counts, counts)
        np.testing.assert_array_equal(got_pos, pos)
    # the C pass from the JAX package's threshold on, numpy below it
    assert bool(calls) == (m >= tstorage.PARTITION_C_ROWS == 2048)


# -- two in-process hosts over a real gRPC hop --------------------------------


def _oracle():
    from limitador_tpu import RateLimiter
    from limitador_tpu.storage.in_memory import InMemoryStorage

    oracle = RateLimiter(InMemoryStorage(1 << 14, clock=lambda: FROZEN_NOW))
    oracle.configure_with(limits(JLimit))
    return oracle


def _oracle_code(oracle, blob):
    """The JAX single-process answer to one raw request, or None for a
    request the columnar lanes leave to the exact path."""
    from limitador_tpu.server.rls import _context_from_request, _hits_addend

    req = rls_pb2.RateLimitRequest.FromString(blob)
    if not req.domain:
        return rls_pb2.RateLimitResponse.UNKNOWN
    if req.domain == "slowns" or len(req.descriptors) > 1:
        return None
    result = oracle.check_rate_limited_and_update(
        req.domain, _context_from_request(req), _hits_addend(req), False)
    return (rls_pb2.RateLimitResponse.OVER_LIMIT if result.limited
            else rls_pb2.RateLimitResponse.OK)


@pytest.mark.parametrize("seed", [21, 22])
def test_two_hosts_decide_as_the_single_process_oracle(seed):
    """The fuzz corpus arrives round robin at a 2-host pod whose hot
    lanes split by owner: local rows stage for B1 on the arrival's
    table, foreign rows bulk-forward one RPC an owner a chunk, pinned
    namespaces funnel whole. Every answer equals the JAX single-process
    oracle's, rows the columnar lanes leave to the exact path are None on
    both sides, and the union of the hosts' counters is the oracle's
    (each counter on one host only)."""
    blobs = corpus(seed, n=260)
    pipelines, frontends, lanes, limiters = pod_pair()
    oracle = _oracle()
    try:
        decided = 0
        for _pass in range(2):  # the second pass rides the owner stamps
            for step, ofs in enumerate(range(0, len(blobs), 48)):
                batch = blobs[ofs:ofs + 48]
                out = pipelines[step % 2].decide_many(batch, chunk=16)
                for blob, got in zip(batch, out):
                    want = _oracle_code(oracle, blob)
                    if want is None:
                        assert got is None
                        continue
                    assert got is not None and got is not (
                        pipelines[0].STORAGE_ERROR)
                    code = rls_pb2.RateLimitResponse.FromString(
                        got).overall_code
                    assert code == want, (_pass, ofs, blob)
                    decided += 1
        assert decided > 300
        states = [port_state(limiter) for limiter in limiters]
        assert not states[0] & states[1]  # no counter on both hosts
        # A table keeps the fresh counters a denied request's other
        # limits allocated (value 0, never spent), as a single process's
        # table does; the in-memory oracle makes none.
        maxes = {(str(l.namespace), l.name): l.max_value
                 for l in limits(TLimit)}
        spent = {c for c in states[0] | states[1]
                 if c[3] < maxes[c[0], c[1]]}
        assert spent == counter_state(oracle.get_counters)
        # the split engaged on both sides of the lane
        assert all(p.lane_stats()["foreign"] > 0 for p in pipelines)
        batches = sum(lane.bulk_forwards for lane in lanes)
        rows = sum(lane.bulk_forward_rows for lane in lanes)
        assert 0 < batches < rows
        assert sum(lane.bulk_served_rows for lane in lanes) == rows
        stats = frontends[0].library_stats()
        assert stats["pod_hot_foreign_rows"] == pipelines[0].lane_stats()[
            "foreign"]
        # the serving model's context reads the split off the pod
        from limitador_tpu_torch.observability.model import pipeline_context

        lane = pipelines[0].lane_stats()
        share = pipeline_context(pipeline=pipelines[0], pod=frontends[0])()
        assert share["pod_share"] == lane["foreign"] / (
            lane["hits"] + lane["foreign"])
        assert stats["pod_bulk_forward_rows"] == lanes[0].bulk_forward_rows
        assert frontends[0].routing_debug()["native_hot_lane"] is True
    finally:
        close_pair(pipelines, lanes, limiters)


def test_an_owners_foreign_verdict_comes_back_none():
    """``decide_many(forward=False)``, the owner's side of a bulk hop,
    answers a row it also thinks foreign None (no second hop)."""
    pipelines, frontends, lanes, limiters = pod_pair()
    try:
        pin = prouting.PodRouter.pin_host("api", 2)
        blob = _api_blob("skewed")
        other = pipelines[1 - pin]
        assert other.decide_many([blob], forward=False) == [None]
        assert sum(lane.bulk_forwards for lane in lanes) == 0
        assert other.lane_stats()["insertions"] == 1  # memoized foreign
        assert other.decide_many([blob], forward=False) == [None]
        assert other.lane_stats()["foreign"] == 1
    finally:
        close_pair(pipelines, lanes, limiters)


def _module(pkg_name, name):
    """A module of the JAX package (``"jax"``) or of the port."""
    import importlib

    root = "limitador_tpu" if pkg_name == "jax" else "limitador_tpu_torch"
    return importlib.import_module(f"{root}.{name}")


def _lane_scenario(pkg_name):
    """The JAX bulk-hop contract (``tests/test_pod.py``) on either
    package's lanes: what the origin and owner observe."""
    device_plane = _module(pkg_name, "observability.device_plane")
    current_request_id = device_plane.current_request_id
    set_request_id = device_plane.set_request_id
    lanes = bound_lanes(_module(pkg_name, "server.peering").PeerLane)
    out = {}
    try:
        seen = {}

        async def bulk_handler(blobs):
            seen["rid"] = current_request_id()
            seen["n"] = len(blobs)
            return [b"ok:" + b for b in blobs]

        lanes[1].bulk_cb = bulk_handler
        hops = []
        lanes[0].on_hop = (
            lambda host, rid, ns, total, phases:
            hops.append((host, rid, ns, sorted(phases), total > 0)))

        async def scenario(blobs):
            set_request_id("bulk-rid-7")
            return await lanes[0].forward_bulk(1, blobs)

        out["payloads"] = asyncio.run(scenario([b"a", b"bb", b"ccc"]))
        out["seen"] = dict(seen)
        out["counts"] = (lanes[0].bulk_forwards, lanes[0].bulk_forward_rows,
                         lanes[1].bulk_served_rows)
        stats = lanes[0].stats()
        out["stats"] = {k: stats[k] for k in (
            "pod_bulk_forward_batches", "pod_bulk_forward_rows",
            "pod_bulk_served_rows", "pod_peer_errors")}
        out["hops"] = hops

        async def none_handler(blobs):
            return [None for _ in blobs]

        lanes[1].bulk_cb = none_handler
        out["none"] = asyncio.run(scenario([b"x", b"y"]))
        lanes[1].bulk_cb = None
        try:
            asyncio.run(scenario([b"z"]))
            out["refused"] = False
        except Exception:
            out["refused"] = True
        out["errors"] = lanes[0].stats()["pod_peer_errors"]
    finally:
        for lane in lanes:
            lane.stop()
    return out


def test_bulk_forward_carries_request_id_and_hop_breakdown():
    got = _lane_scenario("port")
    assert got == _lane_scenario("jax")
    assert got["payloads"] == [b"ok:a", b"ok:bb", b"ok:ccc"]
    assert got["seen"] == {"rid": "bulk-rid-7", "n": 3}
    assert got["counts"] == (1, 3, 3)
    # one breakdown a completed hop (the refused one records none)
    assert got["hops"] == [(1, "bulk-rid-7", "_bulk",
                            ["queue", "remote_decide", "serialize", "wire"],
                            True)] * 2
    assert got["none"] == [None, None]
    assert got["refused"] and got["errors"] == 1


def _api_blob(user):
    req = rls_pb2.RateLimitRequest(domain="api")
    d = req.descriptors.add()
    d.entries.add(key="m", value="GET")
    d.entries.add(key="u", value=user)
    return req.SerializeToString()


def _submit_all(pipeline, blobs):
    """Submit one blob at a time on a loop thread of its own and wait
    for each answer (the serving loop's path: flush, split, hop)."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    async def drive():
        return [await pipeline.submit(b) for b in blobs]

    try:
        return asyncio.run_coroutine_threadsafe(drive(), loop).result(60)
    finally:
        asyncio.run_coroutine_threadsafe(pipeline.close(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()


def test_a_dead_owners_rows_are_answered_with_no_error():
    """The pin host of ``api`` (three limits, pinned whole) stops; six
    calls for one user at the other host all answer, through the
    frontend's degraded stand-in, as the single-process oracle does (3
    OK, then OVER_LIMIT past per-get's 3); a bulk hop to the dead owner
    answers every row None instead of raising."""
    from limitador_tpu_torch.server.peering import PodResilience

    pipelines, frontends, lanes, limiters = pod_pair(
        resilience=PodResilience(probe_interval_s=0.1))
    oracle = _oracle()
    pin = prouting.PodRouter.pin_host("api", 2)
    origin = 1 - pin
    try:
        lanes[pin].stop()
        blob = _api_blob("degraded-user")
        got = _submit_all(pipelines[origin], [blob] * 6)
        want = [_oracle_code(oracle, blob) for _ in range(6)]
        assert [rls_pb2.RateLimitResponse.FromString(g).overall_code
                for g in got] == want
        assert want[:3] == [rls_pb2.RateLimitResponse.OK] * 3
        stats = frontends[origin].library_stats()
        assert stats["pod_failover_degraded_decisions"] >= 1
        fut = frontends[origin].forward_bulk_submit(pin, [blob, blob])
        assert frontends[origin].forward_bulk_collect(fut, 2) == [None,
                                                                  None]
    finally:
        close_pair(pipelines, lanes, limiters)


def test_a_psum_namespace_takes_the_exact_path():
    """A namespace the pod's psum lane serves never rides the columnar
    lanes (the device table would count it a second time): its rows
    answer None from the engine path, the others keep the fast path."""
    from limitador_tpu_torch.parallel.pod import PodPsumLane

    pipelines, frontends, lanes, limiters = pod_pair()
    try:
        for host, frontend in enumerate(frontends):
            frontend.attach_psum_lane(PodPsumLane(
                2, host, clock=lambda: FROZEN_NOW))
            frontend._global_ns = {"shared"}
            asyncio.run(frontend.configure_with(limits(TLimit)))
            pipelines[host].invalidate()
        assert frontends[0].psum_lane.namespaces == {"shared"}
        req = rls_pb2.RateLimitRequest(domain="shared")
        req.descriptors.add().entries.add(key="u", value="x")
        out = pipelines[0].decide_many([req.SerializeToString(),
                                        _api_blob("fast")])
        assert out[0] is None and out[1] is not None
    finally:
        for frontend in frontends:
            frontend.psum_lane.close()
        close_pair(pipelines, lanes, limiters)


# -- families and the flight collection ---------------------------------------


POD_FAMILIES = ("pod_hot_local_rows", "pod_hot_foreign_rows",
                "pod_bulk_forward_batches", "pod_bulk_forward_rows",
                "pod_bulk_served_rows")


def _family(metrics, name):
    for family in metrics.registry.collect():
        if family.name == name:
            return family.type, family.documentation
    raise AssertionError(f"no family {name}")


@pytest.mark.parametrize("name", POD_FAMILIES)
def test_pod_families_are_the_jax_families(name):
    from limitador_tpu.observability.metrics import (
        PrometheusMetrics as JaxMetrics,
    )
    from limitador_tpu.server import peering as jpeering

    from limitador_tpu_torch.observability.metrics import PrometheusMetrics
    from limitador_tpu_torch.server import peering as ppeering

    assert _family(PrometheusMetrics(), name) == _family(JaxMetrics(), name)
    if name.startswith("pod_bulk"):
        assert name in ppeering.METRIC_FAMILIES
        assert name in jpeering.METRIC_FAMILIES


def test_pod_families_count_once_a_render():
    """The frontend reports the pipeline's split and the lane's bulk
    counts; a render beside the pipeline's own source counts each once."""
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics

    class Source:
        def __init__(self, stats):
            self.stats = stats

        def library_stats(self):
            return dict(self.stats)

    frontend = Source({"pod_hot_local_rows": 7, "pod_hot_foreign_rows": 5,
                       "pod_bulk_forward_batches": 2,
                       "pod_bulk_forward_rows": 5,
                       "pod_bulk_served_rows": 4})
    pipeline = Source({"native_lane_rows": 12})
    metrics = PrometheusMetrics()
    metrics.attach_library_source(frontend)
    metrics.attach_library_source(pipeline)
    for _render in range(2):
        text = metrics.render().decode()
        for key, value in frontend.stats.items():
            assert f"{key}_total {float(value)}" in text


def _flight_scenario(pkg_name, tmp_path):
    """Host 1's recorder holds a forwarded decision's entry; host 0's
    engine fires and asks the peer for its rings over the window."""
    flight = _module(pkg_name, "observability.flight")
    clock = lambda: FROZEN_NOW  # noqa: E731
    lanes = bound_lanes(_module(pkg_name, "server.peering").PeerLane)
    try:
        recorders = [flight.FlightRecorder(sample_stride=1, host_id=host,
                                           clock=clock) for host in range(2)]
        for lane, recorder in zip(lanes, recorders):
            lane.flight = recorder
        recorders[0].tap(0.004, "pod_forward", request_id="hop-1",
                         namespace="_bulk")
        recorders[1].tap(0.002, "pod_forward", request_id="hop-1",
                         namespace="_bulk")
        spool = flight.BundleSpool(str(tmp_path / pkg_name))
        engine = flight.TriggerEngine(recorders[0], spool, lane=lanes[0],
                                      clock=clock, peer_retry_s=0.0)
        name = engine.fire("manual", note="pod", force=True)
        bundle = spool.read(name)
    finally:
        for lane in lanes:
            lane.stop()
    peer = bundle["peers"]["1"]
    return {
        "peers": sorted(bundle["peers"]),
        "peer_ids": sorted(e["request_id"] for e in peer["exemplars"]),
        "local_ids": sorted(e["request_id"]
                            for e in bundle["local"]["exemplars"]),
        "peer_lanes": sorted(e["lane"] for e in peer["exemplars"]),
        "peer_rings": engine.peer_rings,
    }


def test_a_triggered_bundle_holds_the_peers_rings(tmp_path):
    got = _flight_scenario("port", tmp_path)
    assert got == _flight_scenario("jax", tmp_path)
    assert got["peers"] == ["1"]
    assert got["peer_ids"] == got["local_ids"] == ["hop-1"]
    assert got["peer_lanes"] == ["pod_forward"]
    assert got["peer_rings"] == 1


@pytest.mark.parametrize("case", ["lane-off", "no-plan-cache", "too-many"])
def test_a_pod_member_warns_where_the_jax_server_warns(case, caplog):
    """Where a pod member cannot arm the split, the port's server warns
    with the JAX server's message and serves the routed compiled
    pipeline (``_pod_native_capable`` answers False in both)."""
    import logging
    from types import SimpleNamespace

    from limitador_tpu.server.__main__ import (
        _pod_native_capable as jax_capable,
    )

    from limitador_tpu_torch.server.__main__ import _pod_native_capable

    args = SimpleNamespace(native_hot_lane="on", plan_cache_size=1 << 16,
                           pod_processes=2)
    if case == "lane-off":
        args.native_hot_lane = "off"
    elif case == "no-plan-cache":
        args.plan_cache_size = 0
    else:
        args.pod_processes = 129 - native.LANE_FOREIGN_BASE
    jax_log = logging.getLogger("jax-server-under-test")
    with caplog.at_level(logging.WARNING):
        assert jax_capable(args, jax_log) is False
        assert _pod_native_capable(args) is False
    # the two servers' loggers only: under load another test's grpc.aio
    # poller thread can log into the same capture while this one runs
    messages = [r.getMessage() for r in caplog.records
                if r.name in (jax_log.name, "limitador_tpu_torch")]
    assert len(messages) == 2 and messages[0] == messages[1]
    args = SimpleNamespace(native_hot_lane="on", plan_cache_size=1 << 16,
                           pod_processes=128 - native.LANE_FOREIGN_BASE)
    assert _pod_native_capable(args) is jax_capable(args, jax_log) is True


def _fnv1a(data: bytes) -> int:
    """The mirror's blob hash (64-bit FNV-1a, ``Interner::fnv1a``)."""
    h = 1469598103934665603
    for b in data:
        h = ((h ^ b) * 1099511628211) & (2 ** 64 - 1)
    return h


def _same_bucket_blobs():
    """Two blobs whose hashes land in one bucket of a fresh mirror (4,096
    buckets): the second takes the first's slot once it is a
    tombstone."""
    first = b"plan-a"
    want = _fnv1a(first) & 4095
    i = 0
    while _fnv1a(b"plan-b-%d" % i) & 4095 != want:
        i += 1
    return first, b"plan-b-%d" % i


def test_a_reused_mirror_slot_starts_unstamped_unlike_the_jax_mirror():
    """A fault of the JAX mirror, fixed in the port: ``PlanMirror::put``
    reuses a tombstoned slot without clearing its owner stamp. Plan A,
    stamped with host 1 on host 0, loses its device slot (a tombstone);
    plan B, put into the same bucket and never stamped (a plan of a
    namespace pinned to host 0 is not), is answered foreign to host 1 by
    the JAX lane and staged by the port's."""
    first, second = _same_bucket_blobs()
    rec = np.array([[7, 10, 60_000, 0, -1]], np.int32)
    codes = {}
    for name, pkg in (("port", native), ("jax", jnative)):
        hp = pkg.HostPath()
        try:
            hp.pod_config(2, 0, 1)
            lane = hp.hot_lane(4095, cap=1 << 10, max_rows=64)
            lane.plan_put(first, 0, pkg.LANE_KERNEL, -1, 1, 1, rec)
            assert lane.plan_set_owner(first, 0, 1)
            lane.invalidate_slot(7)
            lane.plan_put(second, 0, pkg.LANE_KERNEL, -1, 1, 1, rec)
            codes[name] = int(lane.begin([second], 0).codes[0])
        finally:
            hp.close()
    assert codes["port"] == native.LANE_KERNEL
    assert codes["jax"] == jnative.LANE_FOREIGN_BASE + 1
