"""The port's warm standby and fast join (``server/standby.py``, the join
half of ``server/resize.py``, the plan-seed wire of
``device/plan_cache.py``) against the JAX package's, on the CPU.

The scenarios of ``tests/test_standby.py`` (the fast ones) run on both
packages' in-process standby pods (``tests/torch_elastic.py``
``standby_pod``: members and one memberless warm standby on lanes bound
to ports the kernel chose) and are held equal: the join's outcome, the
adopted topology and epochs, the answers the joiner gives, the order of
the join events and the ``join_*``/``standby_*`` values but the seconds.
Two departures, recorded in ROADMAP Queue C: the port's warm-up makes one
more kernel call than the JAX one (B1 on the cluster route at 1,024
hits), and it raises where a kernel cannot build or launch, where the JAX
warm-up logs the failure and stays joinable. A native standby joins too:
its hot lane splits by the shipped topology, and a member's plan seed
lands in its cache before the flip.

Every test runs inside ``torch_steady.steady()``.
"""

import asyncio

import pytest

from . import torch_elastic as E
from .torch_steady import steady

PKGS = ("jax", "port")
_TIMED = {"join_seconds", "join_ttfd_seconds", "pod_resize_seconds",
          "standby_warm_seconds"}


@pytest.fixture(scope="module")
def _grpc_poller():
    """grpc's asyncio poller thread starts with the process's first
    asyncio server and may outlive its stop: one lane serves for the
    whole module, so that it starts before any test's thread census."""
    from limitador_tpu_torch.server.peering import PeerLane

    lane = PeerLane(0, "127.0.0.1:0", {}, None)
    lane.start()
    yield
    lane.stop()


@pytest.fixture(autouse=True)
def _steady(_grpc_poller):
    with steady():
        yield


def _both(scenario, **kwargs):
    out = {pkg: scenario(pkg, **kwargs) for pkg in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


def _owned_users(front, owner, limits, n=3):
    out, i = [], 0
    while len(out) < n:
        user = f"owned-{owner}-{i}"
        key = (limits[0]._identity, (("u", user),))
        if front.router.topology.owner_host(key) == owner:
            out.append(user)
        i += 1
    return out


def _values(stats):
    return {k: v for k, v in stats.items()
            if k.startswith(("join_", "standby_", "pod_resize_"))
            and k not in _TIMED}


# -- the warm standby --------------------------------------------------------------


def _warm(pkg):
    lanes, fronts, standby, _addrs, _limits = E.standby_pod(pkg, 2)
    try:
        before = standby.ready
        out = standby.warm()
        lib = fronts[-1].library_stats()
        status = standby.status()
        return {
            "before": before, "ready": out["ready"] and standby.ready,
            "kernels": standby.warm_kernels,
            "stats_kernels": standby.stats()["standby_warm_kernels"],
            "seconds": standby.stats()["standby_warm_seconds"] > 0,
            "lib_ready": lib["standby_ready"],
            "buckets": status["buckets"],
            "capacity": status["table_capacity"] > 0,
            "ttfd": status["join_ttfd_seconds"],
            "ready_event": "standby_ready" in E.event_kinds(fronts[-1]),
            "armed": fronts[-1].standby_debug()["armed"],
            "member": fronts[0].standby_debug(),
        }
    finally:
        E.stop(lanes)


def test_warm_standby_runs_the_kernels_and_reports():
    out = {pkg: _warm(pkg) for pkg in PKGS}
    jax, port = out["jax"], out["port"]
    # two kernels a bucket in both; the port adds B1 on the cluster route
    assert jax["kernels"] == 2 * len(jax["buckets"])
    assert port["kernels"] == jax["kernels"] + 1
    for got in (jax, port):
        got.pop("kernels")
        got.pop("stats_kernels")
    assert port == jax
    assert port["ready"] and port["seconds"] and port["lib_ready"] == 1
    assert port["member"] == {"armed": False}


def test_warm_standby_counts_its_kernel_calls():
    """One warm-up call a kernel: B1 and B2's host form at each bucket,
    then B1 at 1,024 hits (each a launch on the card; on the CPU each
    runs its plain version, so no launch is counted here)."""
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server import standby as S

    lanes, fronts, standby, _addrs, _limits = E.standby_pod("port", 1)
    try:
        standby.warm_buckets = (8, 16, 32)
        before = dict(K.launches)
        standby.warm()
        assert standby.warm_kernels == 2 * 3 + 1
        assert dict(K.launches) == before
        assert S.CLUSTER_WARM_HITS == K.CLUSTER_MIN_HITS
        assert K.check_route(S.CLUSTER_WARM_HITS) == "cluster"
    finally:
        E.stop(lanes)


def test_warm_failure_raises_where_the_jax_warm_up_stays_joinable(
        monkeypatch):
    out = {}
    for pkg in PKGS:
        lanes, _fronts, standby, _addrs, _limits = E.standby_pod(pkg, 2)
        try:
            name = ("_compile_buckets" if pkg == "jax"
                    else "_warm_buckets")

            def boom():
                raise RuntimeError("no backend")

            monkeypatch.setattr(standby, name, boom)
            try:
                got = standby.warm()
                out[pkg] = ("ready", got["ready"], standby.warm_kernels)
            except RuntimeError as exc:
                out[pkg] = ("raised", str(exc), standby.ready)
        finally:
            E.stop(lanes)
    assert out == {"jax": ("ready", True, 0),
                   "port": ("raised", "no backend", False)}


# -- joins ---------------------------------------------------------------------------


def _join_grow(pkg):
    lanes, fronts, standby, addrs, limits = E.standby_pod(pkg, 2,
                                                          warm=True)
    try:
        for i in range(8):
            E.check(pkg, fronts[i % 2], f"pre-{i}", ns="join")
        out = fronts[0].resize.join_host(addrs[-1])
        assert out["ok"], out
        assert out["join_seconds"] > 0
        answers = [bool(E.check(pkg, fronts[0], u, ns="join").limited)
                   for u in _owned_users(fronts[0], 2, limits)]
        ttfd = fronts[-1].resize.stats()["join_ttfd_seconds"]
        seq = {}
        for event in fronts[0].events_debug()["events"]:
            seq.setdefault(event["kind"], event["seq"])
        assert seq["join_begin"] < seq["epoch_bump"] < seq["join_end"], seq
        return {
            "mode": out["mode"], "joiner": out["joiner"],
            "topology": (fronts[-1].router.topology.hosts,
                         fronts[-1].router.topology.host_id),
            "epochs": sorted({f.router.topology_epoch for f in fronts}),
            "answers": answers, "ttfd": ttfd > 0,
            "initiator": _values(fronts[0].resize.stats()),
            "counts": [E.counters_of(f, "join") for f in fronts],
        }
    finally:
        E.stop(lanes)


def test_join_grow_answers_forwards_with_causal_chain():
    got = _both(_join_grow)
    assert (got["mode"], got["joiner"], got["topology"]) == ("grow", 2,
                                                             (3, 2))
    assert got["epochs"] == [1] and got["ttfd"]
    assert got["initiator"]["join_completed"] == 1
    assert got["initiator"]["join_aborted"] == 0


def _join_replace(pkg):
    lanes, fronts, _standby, addrs, limits = E.standby_pod(pkg, 3,
                                                           warm=True)
    try:
        for i in range(8):
            E.check(pkg, fronts[i % 3], f"pre-{i}", ns="join")
        before = fronts[0].router.topology_epoch
        lanes[1].stop()
        out = fronts[0].resize.join_host(addrs[-1], replace=1)
        assert out["ok"], out
        answers = [E.check(pkg, fronts[0], u, ns="join") is not None
                   for u in _owned_users(fronts[0], 1, limits)]
        seq = {}
        for event in fronts[0].events_debug()["events"]:
            seq.setdefault(event["kind"], event["seq"])
        assert seq["join_begin"] < seq["epoch_bump"] < seq["join_end"]
        return {
            "mode": out["mode"], "joiner": out["joiner"],
            "moved": out["transition"]["moved_slices"],
            "hosts": fronts[0].router.topology.hosts,
            "epoch": fronts[0].router.topology_epoch - before,
            "host_id": fronts[-1].router.topology.host_id,
            "answers": answers, "migrate": "migrate_begin" in seq,
            "completed": fronts[0].resize.stats()["join_completed"],
        }
    finally:
        E.stop(lanes)


def test_join_replace_dead_member_zero_slices_moved():
    got = _both(_join_replace)
    assert (got["mode"], got["joiner"], got["moved"]) == ("replace", 1, 0)
    assert got["hosts"] == 3 and got["epoch"] == 1 and got["host_id"] == 1
    assert all(got["answers"]) and not got["migrate"]
    assert got["completed"] == 1


def _join_validates(pkg):
    lanes, fronts, _standby, addrs, _limits = E.standby_pod(pkg, 2)
    try:
        errors = []
        for replace in (5, 0):
            with pytest.raises(ValueError) as exc:
                fronts[0].resize.join_host(addrs[-1], replace=replace)
            errors.append(str(exc.value))
        return errors, fronts[0].resize.stats()["join_completed"]
    finally:
        E.stop(lanes)


def test_join_validates_replace_target():
    errors, completed = _both(_join_validates)
    assert "outside" in errors[0] and "itself" in errors[1]
    assert completed == 0


# -- the shipped plan seed -------------------------------------------------------------


def _wire_round_trip(pkg):
    pc = E.mod(pkg, "device.plan_cache" if pkg == "port"
               else "tpu.plan_cache")
    Limit = E.mod(pkg, "").Limit
    Counter = E.mod(pkg, "core.counter").Counter
    counter = Counter(Limit("seed", 9, 60, [], ["u"], name="per_u"),
                      {"u": "alice"})
    blob, rebuilt = pc.plan_from_wire(pc.plan_to_wire(
        b"blob-ok", pc.DecisionPlan(pc.PLAN_OK, namespace="seed", delta=2)))
    out = [blob, rebuilt.kind, rebuilt.namespace, rebuilt.delta]
    kernel = pc.DecisionPlan(
        pc.PLAN_KERNEL, namespace="seed", delta=1,
        record=(7, 9, 60000, 0), limit_names=("per_u",), slots=(7,))
    wire = pc.plan_to_wire(b"blob-k", kernel, counter_of_slot={7: counter}.get)
    blob, rebuilt = pc.plan_from_wire(wire, slot_of_counter=lambda c: 7)
    out += [wire, blob, rebuilt.record, rebuilt.slots, rebuilt.limit_names,
            pc.plan_to_wire(b"blob-k", kernel, counter_of_slot={}.get),
            pc.plan_from_wire(wire, slot_of_counter=lambda c: None)]
    return out


def test_plan_wire_round_trip_byte_identical():
    got = _both(_wire_round_trip)
    assert got[0] == b"blob-ok" and got[6] == (7, 9, 60000, 0)
    assert got[-2] is None and got[-1] is None


def _seed_round_trip(pkg):
    pc = E.mod(pkg, "device.plan_cache" if pkg == "port"
               else "tpu.plan_cache")
    donor = pc.DecisionPlanCache(64)
    for i in range(5):
        donor.put(f"blob-{i}".encode(),
                  pc.DecisionPlan(pc.PLAN_OK, namespace=f"ns{i}",
                                  delta=i + 1))
    seed = donor.export_seed()
    joiner = pc.DecisionPlanCache(64)
    seeded = joiner.import_seed(seed)
    entries = sorted((b, p.namespace, p.delta)
                     for b, p in joiner.entries.items())
    racing = pc.DecisionPlanCache(64)
    shipped = racing.epoch
    racing.bump_epoch()
    return seed, seeded, entries, racing.import_seed(seed, epoch=shipped), \
        len(racing)


def test_plan_seed_export_import_round_trip_and_stale_epoch():
    seed, seeded, entries, raced, left = _both(_seed_round_trip)
    assert len(seed) == seeded == len(entries) == 5
    assert (raced, left) == (0, 0)


def _fingerprints(pkg):
    Limit = E.mod(pkg, "").Limit
    lanes, fronts, _standby, _addrs, _limits = E.standby_pod(pkg, 2)
    try:
        seed = fronts[0].plan_seed_export()
        same = seed["limits_fp"] == fronts[1]._limits_fingerprint()
        refused = fronts[1].plan_seed_import(seed)
        asyncio.run(fronts[1].configure_with(
            [Limit("join", 99, 300, [], ["u"], name="per_u")]))
        return (seed, same, refused,
                seed["limits_fp"] != fronts[1]._limits_fingerprint())
    finally:
        E.stop(lanes)


def test_plan_seed_stale_limits_fingerprint_discards_whole_seed():
    seed, same, refused, moved = _both(_fingerprints)
    assert seed["entries"] == [] and same and moved
    assert not refused["ok"] and "no plan cache" in refused["error"]


def test_plan_seed_stale_fingerprint_on_real_cache(monkeypatch):
    def scenario(pkg):
        pc = E.mod(pkg, "device.plan_cache" if pkg == "port"
                   else "tpu.plan_cache")
        lanes, fronts, _standby, _addrs, _limits = E.standby_pod(pkg, 2)
        try:
            class _Pipe:
                plan_cache = pc.DecisionPlanCache(16)
                storage = None

            monkeypatch.setattr(fronts[1], "pipeline", _Pipe())
            out = fronts[1].plan_seed_import(
                {"entries": [{"bad": 1}], "limits_fp": "0" * 16})
            return (out, len(_Pipe.plan_cache),
                    "plan_seeded" in E.event_kinds(fronts[1]))
        finally:
            E.stop(lanes)

    out, left, event = _both(scenario)
    assert out == {"ok": True, "seeded": 0, "stale_limits": True}
    assert left == 0 and event


# -- the off-by-default pin and the registries ---------------------------------------


def test_standby_off_default_and_unarmed_pin():
    from limitador_tpu_torch import Limit
    from limitador_tpu_torch.routing import PodRouter, PodTopology
    from limitador_tpu_torch.server.__main__ import build_parser
    from limitador_tpu_torch.server.peering import PeerLane, PodFrontend

    default = build_parser().parse_args(["limits.yaml", "memory"])
    assert default.standby == "off" and default.kernel_cache_dir == ""
    lane = PeerLane(0, "127.0.0.1:0", {}, None)
    front = PodFrontend(E.make_limiter("port", "memory"),
                        PodRouter(PodTopology(1, 0, 1)), lane)
    assert front.standby is None and front.resize is None
    assert lane.join_cb is None and lane.plan_seed_cb is None
    assert lane.epoch_provider is None
    assert front.standby_debug() == {"armed": False}
    asyncio.run(front.configure_with([Limit("pin", 5, 60, [], ["u"],
                                            name="n")]))
    stats = front.library_stats()
    assert "standby_ready" not in stats and "join_completed" not in stats


def test_join_kinds_answer_as_the_jax_lane_when_unarmed():
    """A lane with nothing attached answers the elastic kinds as the JAX
    lane does."""
    import json

    def scenario(pkg):
        lanes, _addrs = E.bound_lanes(pkg, 1, None)
        try:
            async def ask(kind):
                raw = await lanes[0]._serve_decide(
                    json.dumps({"kind": kind, "from": 9}).encode(), None)
                return json.loads(raw.decode())

            return [asyncio.run(ask(kind)) for kind in (
                "resize_admin", "migrate", "join_admin", "plan_seed",
                "psum_share")]
        finally:
            E.stop(lanes)

    got = _both(scenario)
    assert got[0] == {"ok": False, "error": "pod resize not armed"}


def test_join_event_kinds_families_and_flight_lane_equal_the_jax_ones():
    from limitador_tpu.observability.events import EVENT_KINDS as JKINDS
    from limitador_tpu.observability.flight import FLIGHT_LANES as JLANES
    from limitador_tpu.server.standby import (
        DEFAULT_WARM_BUCKETS as JBUCKETS,
        METRIC_FAMILIES as JFAM,
    )
    from limitador_tpu_torch.observability.events import EVENT_KINDS
    from limitador_tpu_torch.observability.flight import FLIGHT_LANES
    from limitador_tpu_torch.server.standby import (
        DEFAULT_WARM_BUCKETS,
        METRIC_FAMILIES,
    )

    for kind in ("join_begin", "join_end", "standby_ready", "plan_seeded"):
        assert kind in EVENT_KINDS and kind in JKINDS
    assert METRIC_FAMILIES == JFAM and DEFAULT_WARM_BUCKETS == JBUCKETS
    assert "join" in FLIGHT_LANES and "join" in JLANES


def test_join_metric_families_render_as_the_jax_ones():
    from limitador_tpu.observability import PrometheusMetrics as JMetrics
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics

    class Source:
        def library_stats(self):
            return {
                "join_completed": 2, "join_aborted": 1,
                "join_seconds": 0.42, "join_seed_entries": 17,
                "join_ttfd_seconds": 0.031,
                "standby_ready": 1, "standby_warm_kernels": 14,
                "standby_warm_seconds": 1.9,
            }

    def lines(metrics):
        metrics.attach_library_source(Source())
        return sorted(
            line for line in metrics.render().decode().splitlines()
            if line.startswith(("join_", "standby_"))
            and "_created" not in line)

    got = lines(PrometheusMetrics())
    assert got == lines(JMetrics())
    assert "join_ttfd_seconds 0.031" in got and "standby_ready 1.0" in got


def test_kernel_cache_dir_moves_both_builds(tmp_path):
    """``--kernel-cache-dir`` points the CUDA kernels' and the C++ host
    libraries' builds at the directory before any build."""
    from limitador_tpu_torch.native import build as native_build
    from limitador_tpu_torch.ops import build as kernel_build
    from limitador_tpu_torch.server import __main__ as port_main

    before = (kernel_build.BUILD_DIR, native_build.BUILD_DIR)
    target = tmp_path / "kernels"
    try:
        args = port_main.build_parser().parse_args(
            ["l.yaml", "--kernel-cache-dir", str(target)])
        port_main.arm_kernel_cache(args)
        assert target.is_dir()
        assert kernel_build.BUILD_DIR == native_build.BUILD_DIR == target
    finally:
        kernel_build.set_build_dir(before[0])
        native_build.set_build_dir(before[1])


# -- a native standby joins a native pod -------------------------------------------------


def test_a_native_standby_joins_with_the_plan_seed_and_splits_by_the_new_topology():
    """Two native-pipeline members on ``TorchStorage(device="cpu")`` and a
    native warm standby: the join ships the member's plan seed into the
    standby's cache (its slots resolved against its own table) before
    the flip, re-arms its hot lane for host 2 of 3, and every answer
    through either member's pipeline equals the single-process oracle's."""
    from limitador_tpu_torch import Context, Limit
    from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage
    from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
    from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
    from limitador_tpu_torch.routing import PodRouter, PodTopology
    from limitador_tpu_torch.server.peering import PodFrontend
    from limitador_tpu_torch.server.proto import rls_pb2
    from limitador_tpu_torch.server.resize import PodResizeCoordinator
    from limitador_tpu_torch.server.standby import WarmStandby

    limits = [Limit("nat", 3, 300, ["descriptors[0].m == 'GET'"],
                    ["descriptors[0].u"], name="per_u")]
    cfg = E.resilience("port")
    lanes, addrs = E.bound_lanes("port", 3, cfg)
    pipelines, fronts, limiters = [], [], []
    try:
        for host in range(3):
            member = host < 2
            if member:
                lanes[host].set_peers({o: addrs[o] for o in range(2)
                                       if o != host})
            else:
                lanes[host].host_id = 0
            limiter = CompiledTorchLimiter(AsyncTorchStorage(
                TorchStorage(capacity=1 << 10, device="cpu",
                             clock=lambda: E.FROZEN_NOW), max_delay=0.001))
            front = PodFrontend(
                limiter, PodRouter(PodTopology(2 if member else 1,
                                               host if member else 0, 1)),
                lanes[host], resilience=cfg)
            front.attach_resize(PodResizeCoordinator(
                front, peers=({h: addrs[h] for h in range(2)}
                              if member else {}),
                listen_address=addrs[host]))
            if member:
                asyncio.run(front.configure_with(limits))
            pipeline = NativeRlsPipeline(front, max_delay=0.001,
                                         hot_lane=True)
            front.attach_pipeline(pipeline)
            pipelines.append(pipeline)
            fronts.append(front)
            limiters.append(limiter)
        standby = WarmStandby(fronts[2], fronts[2].resize,
                              warm_buckets=(8,), table_capacity=1 << 10)
        standby.warm()
        oracle = E.make_limiter("port", "memory", clock=lambda: E.FROZEN_NOW)
        oracle.configure_with(limits)

        def ctx(u):
            c = Context()
            c.list_binding("descriptors", [{"m": "GET", "u": u}])
            return c

        def blob(u):
            req = rls_pb2.RateLimitRequest(domain="nat")
            d = req.descriptors.add()
            d.entries.add(key="m", value="GET")
            d.entries.add(key="u", value=u)
            return req.SerializeToString()

        async def submit(host, data):
            return await pipelines[host].submit(data)

        def decide(host, users):
            out = pipelines[host].decide_many([blob(u) for u in users])
            for u, raw in zip(users, out):
                if raw is None:
                    raw = asyncio.run(submit(host, blob(u)))
                code = rls_pb2.RateLimitResponse.FromString(raw).overall_code
                want = oracle.check_rate_limited_and_update(
                    "nat", ctx(u), 1, False)
                assert (code == 2) == bool(want.limited), u

        users = [f"user-{i}" for i in range(24)]
        decide(0, users)
        out = fronts[0].resize.join_host(addrs[2])
        assert out["ok"], out
        # the seed lands before the flip; the commit then orphans every
        # plan (owner stamps of the old topology), as the JAX joiner's
        assert out["seeded"] > 0
        assert fronts[0].resize.stats()["join_seed_entries"] == out["seeded"]
        assert pipelines[2]._pod is fronts[2]
        assert fronts[2].router.topology.host_id == 2
        decide(1, users)
        decide(0, users)
        decide(1, users)
        assert E.counters_of(fronts[2], "nat")
        assert fronts[2].resize.stats()["join_ttfd_seconds"] > 0
    finally:
        E.stop(lanes)

        async def close():
            for pipeline, limiter in zip(pipelines, limiters):
                await pipeline.close()
                await limiter.storage.counters.close()

        asyncio.run(close())
