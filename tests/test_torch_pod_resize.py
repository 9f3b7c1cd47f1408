"""The port's elastic pod (``server/resize.py`` and the topology-epoch
gate of ``server/peering.py``) against the JAX package's, on the CPU.

Each scenario runs on the JAX package's in-process miniature pod
(``tests/test_pod_resize.py``'s ``_elastic_pod``) and on the port's,
built alike by ``tests/torch_elastic.py`` (lanes bound to ports the
kernel chose), and the two are held equal: every decision, each host's
counters, the topology epochs, the order of the resize events and the
``pod_resize_*`` values but the seconds. Covered: the cases of
``tests/test_pod_resize.py`` and the fast cases of
``tests/test_pod_resize_chaos.py`` and ``tests/test_pod_join_drill.py``;
the plan-seed wire bytes; ``--pod-resize off`` payloads without a
``tepoch``; ``PeerPsumTransport`` under one injected clock; the C
mirror's re-stamp after a commit on a native pod; and the two faults of
the JAX coordinator on device tables (ROADMAP Queue C), each shown on
the JAX package and held exact on the port.

Every test runs inside ``torch_steady.steady()``.
"""

import asyncio
import json
import threading

import pytest

from . import torch_elastic as E
from .torch_steady import steady

PKGS = ("jax", "port")
#: the pod_resize_*/join_* values compared (the seconds are timings)
_TIMED = {"pod_resize_seconds", "join_seconds", "join_ttfd_seconds"}
#: the event kinds of a membership change
_RESIZE_KINDS = {"resize_begin", "epoch_bump", "migrate_begin",
                 "migrate_end", "resize_end", "resize_abort",
                 "join_begin", "join_end", "plan_seeded"}


@pytest.fixture(scope="module")
def _grpc_poller():
    """grpc's asyncio poller thread comes up with the process's first
    asyncio server and may outlive its stop: one lane serves for the
    whole module, so that the thread starts before any test's thread
    census."""
    from limitador_tpu_torch.server.peering import PeerLane

    lane = PeerLane(0, "127.0.0.1:0", {}, None)
    lane.start()
    yield
    lane.stop()


@pytest.fixture(autouse=True)
def _steady(_grpc_poller):
    with steady():
        yield


def _resize_stats(front):
    return {k: v for k, v in front.library_stats().items()
            if k.startswith(("pod_resize_", "join_")) and k not in _TIMED}


def _kinds(front):
    return [k for k in E.event_kinds(front) if k in _RESIZE_KINDS]


def _both(scenario, **kwargs):
    """Run ``scenario(pkg, ...)`` on each package; assert the two
    summaries equal and return the port's."""
    out = {pkg: scenario(pkg, **kwargs) for pkg in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


# -- router retargeting ----------------------------------------------------------


def test_retarget_bumps_topology_epoch_and_repins():
    def scenario(pkg):
        routing = E.mod(pkg, "routing")
        Limit = E.mod(pkg, "").Limit
        router = routing.PodRouter(routing.PodTopology(2, 0, 2))
        limits = [Limit("multi", 2, 60, [], ["u"], name="a"),
                  Limit("multi", 30, 60, [], [], name="b"),
                  Limit("solo", 5, 60, [], ["u"], name="c")]
        router.configure(limits, global_namespaces=["g"])
        out = [router.topology_epoch, router.pinned_map()]
        out.append(router.retarget(routing.PodTopology(3, 0, 2)))
        out += [router.topology.hosts, router.pinned_map()]
        out.append(router.retarget(routing.PodTopology(2, 0, 2), epoch=7))
        out.append(router.ownership_map()["topology_epoch"])
        router.configure(limits, global_namespaces=["g"])
        out.append(router.topology_epoch)
        return out

    got = _both(scenario)
    assert got[0] == 0 and got[2] == 1 and got[5] == got[6] == got[7] == 7


# -- live resize and drain -------------------------------------------------------


def _drive(pkg, fronts, users, hosts, rounds, oracle):
    decisions = []
    for _ in range(rounds):
        for i, u in enumerate(users):
            got = bool(E.check(pkg, fronts[i % hosts], u).limited)
            want = bool(E.check(pkg, oracle, u).limited)
            assert got == want, u
            decisions.append(got)
    return decisions


def _oracle(pkg, limits):
    return E.make_limiter(pkg, "memory")


def _topology_owners(pkg, fronts, ns):
    """Each host's counters are its own under the current topology."""
    counter_key = E.mod(pkg, "routing").counter_key
    topo = fronts[0].router.topology
    for host, front in enumerate(fronts):
        got = front.get_counters(ns)
        if asyncio.iscoroutine(got):
            got = asyncio.run(got)
        for counter in got:
            assert topo.owner_host(counter_key(counter)) == host


def _live_resize(pkg):
    lanes, fronts, coords, addrs, limits = E.elastic_pod(pkg, 2, n_total=3)
    try:
        oracle = _oracle(pkg, limits)
        oracle.configure_with(limits)
        users = [f"user-{i}" for i in range(40)]
        decisions = _drive(pkg, fronts, users, 2, 3, oracle)
        out = coords[0].resize(3, peers={2: addrs[2]})
        assert out["ok"] and out["transition"]["state"] == "complete", out
        decisions += _drive(pkg, fronts, users, 3, 3, oracle)
        counts = [E.counters_of(f, "elastic") for f in fronts]
        assert sum(len(c) for c in counts) == len(users)
        assert counts[2]
        _topology_owners(pkg, fronts, "elastic")
        for front in fronts[:2]:
            seq = {}
            for event in front.events_debug()["events"]:
                seq.setdefault(event["kind"], event["seq"])
            assert (seq["resize_begin"] < seq["epoch_bump"]
                    < seq["migrate_begin"] <= seq["migrate_end"]
                    < seq["resize_end"]), seq
        stats = fronts[0].library_stats()
        assert stats["pod_resize_seconds"] > 0
        return {
            "decisions": decisions, "counts": counts,
            "epochs": [f.router.topology_epoch for f in fronts],
            "kinds": [_kinds(f) for f in fronts],
            "stats": [_resize_stats(f) for f in fronts],
            "moved": (out["transition"]["moved_slices"],
                      out["transition"]["moved_counters"]),
        }
    finally:
        E.stop(lanes)


def test_live_resize_2_to_3_zero_lost_updates():
    got = _both(_live_resize)
    assert got["epochs"] == [1, 1, 1]
    assert got["stats"][0]["pod_resize_completed"] == 1
    assert got["stats"][0]["pod_resize_active"] == 0


def _drain(pkg):
    lanes, fronts, coords, addrs, limits = E.elastic_pod(pkg, 3)
    try:
        oracle = _oracle(pkg, limits)
        oracle.configure_with(limits)
        users = [f"user-{i}" for i in range(30)]
        decisions = _drive(pkg, fronts, users, 3, 1, oracle)
        assert E.counters_of(fronts[2], "elastic")
        out = coords[0].drain_host()
        assert out["ok"], out
        counts = [E.counters_of(f, "elastic") for f in fronts]
        assert not counts[2] and sum(len(c) for c in counts) == len(users)
        decisions += _drive(pkg, fronts, users, 2, 1, oracle)
        return {"decisions": decisions, "counts": counts,
                "kinds": [_kinds(f) for f in fronts],
                "stats": [_resize_stats(f) for f in fronts]}
    finally:
        E.stop(lanes)


def _epoch_in_band_first(pkg):
    """A grow 2 -> 3 where host 1 meets the initiator's new epoch in band
    (a stale_epoch reply carrying host 0's committed topology) just
    before host 1's commit RPC arrives, as a forward racing the commit
    broadcast does; then every user on every host against the oracle."""
    lanes, fronts, coords, addrs, limits = E.elastic_pod(pkg, 2, n_total=3)
    try:
        oracle = _oracle(pkg, limits)
        oracle.configure_with(limits)
        users = [f"user-{i}" for i in range(40)]
        _drive(pkg, fronts, users, 2, 2, oracle)
        real = coords[1]._handle_commit

        def commit_after_the_stale_reply(payload):
            coords[1].adopt_remote({
                "tepoch": fronts[0].router.topology_epoch,
                **coords[0].stale_info(),
            })
            return real(payload)

        coords[1]._handle_commit = commit_after_the_stale_reply
        out = coords[0].resize(3, peers={2: addrs[2]})
        assert E.wait_for(lambda: not any(c.active for c in coords), 10.0)
        views = [(f.router.topology.hosts, f.router.topology_epoch)
                 for f in fronts[:2]]
        hosts = fronts[0].router.topology.hosts
        exact = True
        for i, u in enumerate(users):
            got = bool(E.check(pkg, fronts[i % hosts], u).limited)
            exact &= got == bool(E.check(pkg, oracle, u).limited)
        spent = {}
        for front in fronts:
            for key, value in E.counters_of(front, "elastic").items():
                spent[key] = spent.get(key, 0) + value
        return {"ok": bool(out["ok"]), "views": views, "exact": exact,
                "spent": spent == E.counters_of(oracle, "elastic")}
    finally:
        E.cancel_watchdogs(coords)
        E.stop(lanes)


def test_a_member_meeting_the_new_epoch_in_band_commits_it():
    """The initiator commits first, so a member's forward can meet the
    new epoch before the member's commit RPC: the port's member commits
    the transition it prepared and the grow completes, exact. The JAX
    member adopts the geometry bare and refuses the commit ("topology
    epoch moved between prepare and commit"): the grow aborts, host 0
    reverts to 2 hosts at epoch 2 and host 1 stays on the aborted 3-host
    epoch 1 (ROADMAP Queue C)."""
    port = _epoch_in_band_first("port")
    assert port == {"ok": True, "views": [(3, 1), (3, 1)], "exact": True,
                    "spent": True}
    jax = _epoch_in_band_first("jax")
    assert not jax["ok"] and jax["views"] == [(2, 2), (3, 1)]


def test_drain_host_migrates_slices_to_survivors():
    got = _both(_drain)
    assert got["stats"][2]["pod_resize_released_counters"] > 0


def _validates(pkg):
    lanes, fronts, coords, _addrs, _limits = E.elastic_pod(pkg, 2)
    try:
        errors = []
        for host, hosts in ((0, 0), (1, 1), (0, 4)):
            with pytest.raises(ValueError) as exc:
                coords[host].resize(hosts)
            errors.append(str(exc.value))
        noop = coords[0].resize(2)
        return errors, bool(noop["ok"]), noop.get("noop")
    finally:
        E.stop(lanes)


def test_resize_validates_proposals():
    errors, ok, noop = _both(_validates)
    assert "hosts >= 1" in errors[0] and "surviving host" in errors[1]
    assert "peer address" in errors[2] and ok and noop


# -- the stale-epoch gate --------------------------------------------------------


def _forwarded_user(pkg, front, owner, ns="elastic"):
    Context = E.mod(pkg, "").Context
    FORWARD = E.mod(pkg, "routing").FORWARD
    for i in range(400):
        if front._plan(ns, Context({"u": f"user-{i}"})) == (FORWARD, owner):
            return f"user-{i}"
    raise AssertionError("no forwarded key found")


def _stale_unary(pkg):
    routing = E.mod(pkg, "routing")
    lanes, fronts, _coords, _addrs, _limits = E.elastic_pod(pkg, 2)
    try:
        user = _forwarded_user(pkg, fronts[0], owner=1)
        fronts[1].router.retarget(routing.PodTopology(2, 1, 1), epoch=1)
        limited = bool(E.check(pkg, fronts[0], user).limited)
        return {
            "limited": limited,
            "rejects": lanes[1].stale_rejects,
            "replans": fronts[0].stale_replans,
            "epoch": fronts[0].router.topology_epoch,
            "owner_counts": E.counters_of(fronts[1], "elastic"),
            "stats": [_resize_stats(f) for f in fronts],
        }
    finally:
        E.stop(lanes)


def test_stale_epoch_unary_rejected_and_replanned():
    got = _both(_stale_unary)
    assert not got["limited"] and got["rejects"] >= 1
    assert got["replans"] >= 1 and got["epoch"] == 1
    assert len(got["owner_counts"]) == 1


def _stale_pinned(pkg):
    routing = E.mod(pkg, "routing")
    Limit = E.mod(pkg, "").Limit
    limits = [Limit("pinned", 10, 300, [], ["u"], name="a"),
              Limit("pinned", 100, 300, [], [], name="b")]
    lanes, fronts, _coords, _addrs, _limits = E.elastic_pod(
        pkg, 2, limits=limits)
    try:
        pin = routing.PodRouter.pin_host("pinned", 2)
        origin = 1 - pin
        fronts[pin].router.retarget(routing.PodTopology(2, pin, 1), epoch=1)
        limited = bool(E.check(pkg, fronts[origin], "alice",
                               ns="pinned").limited)
        return (limited, lanes[pin].stale_rejects,
                fronts[origin].stale_replans,
                E.counters_of(fronts[pin], "pinned"))
    finally:
        E.stop(lanes)


def test_stale_epoch_pinned_namespace_replans():
    limited, rejects, replans, counts = _both(_stale_pinned)
    assert not limited and rejects >= 1 and replans >= 1
    assert len(counts) == 2


def _stale_bulk(pkg):
    routing = E.mod(pkg, "routing")
    lanes, fronts, _coords, _addrs, _limits = E.elastic_pod(pkg, 2)
    try:
        served = []

        async def bulk_handler(blobs):
            served.append(len(blobs))
            return [b"ok" for _ in blobs]

        lanes[1].bulk_cb = bulk_handler
        fronts[1].router.retarget(routing.PodTopology(2, 1, 1), epoch=3)
        out = asyncio.run(fronts[0].lane.forward_bulk(1, [b"r1", b"r2",
                                                          b"r3"]))
        return (out, served, lanes[1].stale_rejects,
                fronts[0].router.topology_epoch)
    finally:
        E.stop(lanes)


def test_stale_epoch_bulk_answers_all_none_and_adopts():
    assert _both(_stale_bulk) == ([None, None, None], [], 1, 3)


def _resize_off_payloads(pkg):
    """Unary and bulk payloads of a pod without a coordinator, and a
    resize-armed owner serving an unstamped forward."""
    peering = E.mod(pkg, "server.peering")
    routing = E.mod(pkg, "routing")
    Limit = E.mod(pkg, "").Limit
    Coordinator = E.mod(pkg, "server.resize").PodResizeCoordinator
    limits = [Limit("fwd", 3, 60, [], ["u"], name="per_u")]
    captured = []
    lanes, addrs = E.bound_lanes(pkg, 2, None, E.capturing(captured))
    try:
        fronts = []
        for host, lane in enumerate(lanes):
            lane.set_peers({1 - host: addrs[1 - host]})
            front = peering.PodFrontend(
                E.make_limiter(pkg, "memory"),
                routing.PodRouter(routing.PodTopology(2, host, 1)), lane)
            asyncio.run(front.configure_with(limits))
            fronts.append(front)
        user = _forwarded_user(pkg, fronts[0], owner=1, ns="fwd")
        first = bool(E.check(pkg, fronts[0], user, ns="fwd").limited)
        lanes[1].bulk_cb = None
        try:
            asyncio.run(lanes[0].forward_bulk(1, [b"x"]))
        except Exception:
            pass  # no bulk handler here: only the payload is compared
        keys = [sorted(p) for p in captured]
        coordinator = Coordinator(fronts[1], peers={1: addrs[1]},
                                  listen_address=addrs[1])
        fronts[1].attach_resize(coordinator)
        second = bool(E.check(pkg, fronts[0], user, ns="fwd").limited)
        return keys, first, second, lanes[1].stale_rejects
    finally:
        E.stop(lanes)


def test_resize_off_wire_format_byte_identical():
    keys, first, second, rejects = _both(_resize_off_payloads)
    assert keys[0] == ["ctx", "delta", "from", "kind", "load", "ns"]
    assert keys[-1] == ["blobs", "from", "kind"]
    assert not first and not second and rejects == 0


def test_armed_payloads_carry_the_topology_epoch():
    """With the plane armed, a unary forward and a bulk hop carry
    ``tepoch``, in both packages."""
    def scenario(pkg):
        captured = []
        lanes, fronts, _coords, _addrs, _limits = E.elastic_pod(
            pkg, 2, prepare=E.capturing(captured))
        try:
            user = _forwarded_user(pkg, fronts[0], owner=1)
            E.check(pkg, fronts[0], user)

            async def bulk(blobs):
                return [None for _ in blobs]

            lanes[1].bulk_cb = bulk
            asyncio.run(lanes[0].forward_bulk(1, [b"x"]))
            return [sorted(p) for p in captured]
        finally:
            E.stop(lanes)

    keys = _both(scenario)
    assert "tepoch" in keys[0] and "tepoch" in keys[1]


# -- the migrate ledger ------------------------------------------------------------


def _ledger(pkg):
    lanes, fronts, coords, _addrs, limits = E.elastic_pod(pkg, 1)
    try:
        peering = E.mod(pkg, "server.peering")
        Counter = E.mod(pkg, "core.counter").Counter
        Context = E.mod(pkg, "").Context
        counter = Counter.new(limits[0], Context({"u": "alice"}))

        def migrate(value, final=False):
            return coords[0].handle_migrate({
                "slice": 0, "from": 9, "final": final,
                "rows": [peering._counter_to_wire(counter, value)],
            })["applied"]

        applied = [migrate(v) for v in (5, 5, 8, 3, 8)]
        return applied, E.counters_of(fronts[0], "elastic")
    finally:
        E.stop(lanes)


def test_migrate_ledger_applies_diffs_idempotently():
    applied, counts = _both(_ledger)
    assert applied == [1, 0, 1, 0, 0]
    assert list(counts.values()) == [8]


# -- surfaces ----------------------------------------------------------------------


def test_server_resize_flags_parse_with_off_defaults():
    from limitador_tpu.server.__main__ import build_parser as jparser
    from limitador_tpu_torch.server.__main__ import build_parser

    for parser in (build_parser, jparser):
        default = parser().parse_args(["limits.yaml", "memory"])
        assert default.pod_resize == "off" and default.standby == "off"
        on = parser().parse_args(["limits.yaml", "sharded", "--pod-resize",
                                  "on", "--standby", "on"])
        assert on.pod_resize == "on" and on.standby == "on"
    port = build_parser().parse_args(["l.yaml", "--kernel-cache-dir", "/x"])
    assert port.kernel_cache_dir == "/x"
    assert build_parser().parse_args(["l.yaml"]).kernel_cache_dir == ""


@pytest.mark.parametrize("argv,message", [
    (["--pod-resize", "on"], "--pod-resize on needs a pod"),
    (["--standby", "on", "--pod-processes", "2", "--pod-coordinator",
      "127.0.0.1:1", "--pod-peer", "a:1", "--pod-peer", "b:2"],
     "already formed a pod"),
    (["--standby", "on", "--authority-url", "127.0.0.1:1"],
     "cannot serve a pod"),
])
def test_resize_option_checks_exit_2(argv, message, tmp_path):
    from limitador_tpu_torch.server import __main__ as port_main

    limits = tmp_path / "limits.yaml"
    limits.write_text("[]\n")
    storage = "cached" if "--authority-url" in argv else "memory"
    args = port_main.build_parser().parse_args(
        [str(limits), storage, *argv])
    with pytest.raises(ValueError, match=message):
        port_main._pod_refusals(args)
    assert port_main.main([str(limits), storage, *argv]) == 2


def _debug_surface(pkg):
    StorageError = E.mod(pkg, "storage.base").StorageError
    lanes, fronts, coords, _addrs, _limits = E.elastic_pod(pkg, 2)
    try:
        out = fronts[0].resize_debug()
        noop = fronts[0].pod_resize_admin(2)
        fronts[1].resize = None
        unarmed = fronts[1].resize_debug()
        with pytest.raises(StorageError) as exc:
            fronts[1].pod_resize_admin(3)
        return (out["armed"], out["hosts"], out["topology_epoch"],
                out["transition"], bool(noop["ok"]), noop.get("noop"),
                unarmed, str(exc.value))
    finally:
        E.stop(lanes)


def test_resize_debug_surface_and_admin():
    got = _both(_debug_surface)
    assert got[:6] == (True, 2, 0, None, True, True)
    assert got[6] == {"armed": False} and "not armed" in got[7]


def test_resize_event_kinds_and_families_equal_the_jax_ones():
    from limitador_tpu.observability.events import EVENT_KINDS as JKINDS
    from limitador_tpu.server.resize import METRIC_FAMILIES as JFAM
    from limitador_tpu_torch.observability.events import EVENT_KINDS
    from limitador_tpu_torch.observability.flight import TRIGGER_REASONS
    from limitador_tpu_torch.server.resize import METRIC_FAMILIES

    for kind in ("resize_begin", "epoch_bump", "migrate_begin",
                 "migrate_end", "resize_end", "resize_abort"):
        assert kind in EVENT_KINDS and kind in JKINDS
    assert METRIC_FAMILIES == JFAM
    assert "resize_abort" in TRIGGER_REASONS


def test_resize_metric_families_render_as_the_jax_ones():
    from limitador_tpu.observability import PrometheusMetrics as JMetrics
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics

    class Source:
        def library_stats(self):
            return {
                "pod_resize_epoch": 3, "pod_resize_active": 1,
                "pod_resize_completed": 2, "pod_resize_aborted": 1,
                "pod_resize_slices_moved": 7,
                "pod_resize_moved_deltas": 120,
                "pod_resize_released_counters": 64,
                "pod_resize_seconds": 1.25, "pod_resize_stale_rejects": 4,
                "pod_resize_replans": 3,
            }

    def lines(metrics):
        metrics.attach_library_source(Source())
        return sorted(
            line for line in metrics.render().decode().splitlines()
            if line.startswith("pod_resize_") and "_created" not in line)

    got = lines(PrometheusMetrics())
    assert got == lines(JMetrics())
    assert "pod_resize_epoch 3.0" in got
    assert "pod_resize_seconds_total 1.25" in got


def test_epoch_gate_is_one_compare_per_payload():
    from limitador_tpu_torch.server.peering import PeerLane

    lane = PeerLane.__new__(PeerLane)
    calls = []
    lane.epoch_provider = lambda: calls.append(1) or 5
    payload = {"tepoch": 5, "blobs": ["x"] * 4096}
    assert lane._epoch_mismatch(payload) is False and len(calls) == 1
    payload["tepoch"] = 4
    assert lane._epoch_mismatch(payload) is True and len(calls) == 2
    assert lane._epoch_mismatch({"blobs": []}) is False and len(calls) == 2
    lane.epoch_provider = None
    assert lane._epoch_mismatch({"tepoch": 9}) is False


def test_debug_pod_resize_endpoints_answer_as_the_jax_server():
    """GET/POST /debug/pod/resize: 200 with the state, POST driving the
    admin surface, 400 on a malformed proposal, 409 on a refused one, and
    404 without a pod, with the JAX server's statuses and bodies."""
    from aiohttp.test_utils import TestClient, TestServer

    def run(pkg):
        core = E.mod(pkg, "")
        make_http_app = E.mod(pkg, "server.http_api").make_http_app

        class ResizeLimiter(core.RateLimiter):
            def __init__(self):
                super().__init__()
                self.calls = []

            def resize_debug(self):
                return {"armed": True, "active": False, "hosts": 2,
                        "topology_epoch": 1, "transition": None}

            def pod_resize_admin(self, hosts, peers=None):
                self.calls.append((hosts, peers))
                if hosts == 9:
                    raise ValueError("a pod resize is already in flight")
                return {"ok": True, "hosts": hosts}

        async def main(limiter, sources):
            app = make_http_app(limiter, None, {}, debug_sources=sources)
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                out = []
                for method, body in (("get", None),
                                     ("post", {"hosts": 3,
                                               "peers": {"2": "h:1"}}),
                                     ("post", {"peers": {}}),
                                     ("post", {"hosts": 9})):
                    resp = await getattr(client, method)(
                        "/debug/pod/resize", json=body)
                    out.append((resp.status, await resp.json()))
                return out
            finally:
                await client.close()

        limiter = ResizeLimiter()
        armed = asyncio.run(main(limiter, [limiter]))
        plain = asyncio.run(main(core.RateLimiter(), []))
        return armed, plain[:2], limiter.calls

    got = _both_plain(run)
    armed, plain, calls = got
    assert [s for s, _b in armed] == [200, 200, 400, 409]
    assert calls[0] == (3, {2: "h:1"})
    assert [s for s, _b in plain] == [404, 404]


def _both_plain(run):
    out = {pkg: run(pkg) for pkg in PKGS}
    jax_armed, jax_plain, jax_calls = out["jax"]
    armed, plain, calls = out["port"]
    assert [s for s, _b in armed] == [s for s, _b in jax_armed]
    assert armed[0][1] == jax_armed[0][1] and armed[1][1] == jax_armed[1][1]
    assert armed[3][1] == jax_armed[3][1]
    assert plain == jax_plain and calls == jax_calls
    return out["port"]


# -- sharded checkpoints across a membership change --------------------------------


def _sharded_spends(tmp_path):
    from limitador_tpu_torch import Context, Limit
    from limitador_tpu_torch.core.counter import Counter
    from limitador_tpu_torch.device.sharded import TorchShardedStorage
    from limitador_tpu_torch.routing import counter_key

    limit = Limit("elastic", 50, 300, [], ["u"], name="per_u")
    bucket = Limit("elastic", 20, 100, [], ["u"], name="bucket",
                   policy="token_bucket")
    storage = TorchShardedStorage(n_shards=2, local_capacity=64,
                                  cache_size=256, global_region=8,
                                  device="cpu")
    spends = {}
    for i in range(12):
        counter = Counter.new(limit, Context({"u": f"user-{i}"}))
        storage.apply_deltas([(counter, 1 + i % 3)])
        spends[counter_key(counter)] = 1 + i % 3
    bucket_counter = Counter.new(bucket, Context({"u": "bob"}))
    storage.apply_deltas([(bucket_counter, 4)])
    spends[counter_key(bucket_counter)] = 4
    return storage, spends, (limit, bucket)


def test_sharded_snapshot_manifest_and_slice_rekey(tmp_path):
    """A member's checkpoint carries its shard range, and a member that
    owns another range after a membership change seeds only its own
    counters from its siblings' checkpoints (B7c's host form)."""
    from limitador_tpu_torch.device.sharded import (
        TorchShardedStorage,
        snapshot_items,
        snapshot_manifest,
    )
    from limitador_tpu_torch.routing import counter_key, stable_hash
    from limitador_tpu_torch.server.__main__ import (
        _seed_from_sibling_snapshots,
    )

    storage, spends, limits = _sharded_spends(tmp_path)
    base = str(tmp_path / "snap")
    storage.snapshot_meta = {
        "owned_shards": [0, 2],
        "topology": {"hosts": 1, "host_id": 0, "shards_per_host": 2,
                     "total_shards": 2},
    }
    storage.snapshot(base + ".shards0-2")
    manifest = snapshot_manifest(base + ".shards0-2")["manifest"]
    assert manifest["owned_shards"] == [0, 2]
    items = snapshot_items(base + ".shards0-2")
    assert {counter_key(c): v for c, v in items} == spends
    total, lo, hi = 6, 0, 3
    mine = {k: v for k, v in spends.items()
            if lo <= stable_hash(k) % total < hi}
    assert 0 < len(mine) < len(spends)
    fresh = TorchShardedStorage(n_shards=2, local_capacity=64,
                                cache_size=256, global_region=8,
                                device="cpu")
    assert _seed_from_sibling_snapshots(fresh, base, (lo, hi), total) == \
        len(mine)
    seeded = {counter_key(c): c.max_value - c.remaining
              for c in fresh.get_counters(set(limits))}
    assert seeded == mine


def test_sharded_snapshot_without_meta_has_no_manifest(tmp_path):
    from limitador_tpu_torch.device.sharded import (
        TorchShardedStorage,
        snapshot_manifest,
    )

    storage = TorchShardedStorage(n_shards=2, local_capacity=64,
                                  cache_size=256, global_region=8,
                                  device="cpu")
    path = str(tmp_path / "snap")
    storage.snapshot(path)
    assert snapshot_manifest(path)["manifest"] == {}
    assert TorchShardedStorage.restore(
        path, device="cpu")._local_capacity == 64


# -- the failover journal under a resize ---------------------------------------------


class _FlakyChunkSink:
    """apply_deltas_acked sink that dies after ``fail_after`` chunks."""

    def __init__(self, chunk=2, fail_after=None):
        self.chunk = chunk
        self.fail_after = fail_after
        self.applied = {}

    def apply_deltas_acked(self, items, ack):
        done = 0
        for start in range(0, len(items), self.chunk):
            if self.fail_after is not None and done >= self.fail_after:
                raise ConnectionError("peer died mid-replay")
            chunk = items[start:start + self.chunk]
            for counter, delta in chunk:
                key = (counter.limit.name,
                       tuple(sorted(counter.set_variables.items())))
                self.applied[key] = self.applied.get(key, 0) + delta
            done += 1
            ack(start + len(chunk))


def _journaled_store(pkg, n=6):
    Limit, Context = E.mod(pkg, "").Limit, E.mod(pkg, "").Context
    Counter = E.mod(pkg, "core.counter").Counter
    FailoverStore = E.mod(pkg, "storage.failover").FailoverStore
    limit = Limit("chaos", 100, 300, [], ["u"], name="per_u")
    store = FailoverStore()
    for i in range(n):
        counter = Counter.new(limit, Context({"u": f"u{i}"}))
        store.check_and_update([counter], 1 + i, False)
    return store


def _redrive(pkg):
    store = _journaled_store(pkg)
    sink = _FlakyChunkSink(chunk=2, fail_after=1)
    with pytest.raises(ConnectionError):
        store.reconcile_into(sink)
    first = (store.drained_high_water, store.journal_size(),
             dict(sink.applied))
    sink.fail_after = None
    replayed = store.reconcile_into(sink)
    return first, replayed, store.journal_size(), \
        store.drained_high_water, sorted(sink.applied.items())


def test_failover_reconcile_redrive_never_double_applies():
    first, replayed, journal, high, applied = _both(_redrive)
    assert first[:2] == (2, 4) and replayed == 4 and journal == 0
    assert high == 6 and [v for _k, v in applied] == [1, 2, 3, 4, 5, 6]


def _all_or_nothing(pkg):
    store = _journaled_store(pkg, 4)

    class Sink:
        def apply_deltas(self, items):
            raise RuntimeError("device busy")

    with pytest.raises(RuntimeError):
        store.reconcile_into(Sink())
    first = (store.journal_size(), store.drained_high_water)

    class OkSink:
        def __init__(self):
            self.items = []

        def apply_deltas(self, items):
            self.items.extend(items)

    return first, store.reconcile_into(OkSink()), store.drained_high_water


def test_failover_reconcile_allornothing_sink_keeps_restore_semantics():
    assert _both(_all_or_nothing) == ((4, 0), 4, 4)


def test_failover_rejournal_and_reset_oracle_equal_the_jax_store():
    def scenario(pkg):
        store = _journaled_store(pkg, 3)
        items = store.drain()
        store.rejournal(items[:2])
        store.rejournal(items[:1])
        size = store.journal_size()
        again = sorted(d for _c, d in store.drain())
        store.reset_oracle()
        Limit, Context = E.mod(pkg, "").Limit, E.mod(pkg, "").Context
        Counter = E.mod(pkg, "core.counter").Counter
        counter = Counter.new(Limit("chaos", 100, 300, [], ["u"],
                                    name="per_u"), Context({"u": "u2"}))
        # the oracle forgot u2's window: 100 more fit
        return size, again, store.check_and_update([counter], 100,
                                                   False).limited

    assert _both(scenario) == (2, [2, 2], False)


def _delta_sink(pkg):
    Limit, Context = E.mod(pkg, "").Limit, E.mod(pkg, "").Context
    Counter = E.mod(pkg, "core.counter").Counter
    sink_cls = E.mod(pkg, "server.peering")._PeerDeltaSink

    class Lane:
        def __init__(self):
            self.batches = []

        def replay_deltas(self, owner, deltas, timeout=None):
            self.batches.append(len(deltas))
            return len(deltas)

    lane = Lane()
    sink = sink_cls(lane, owner=1)
    sink.CHUNK = 2
    limit = Limit("chaos", 100, 300, [], ["u"], name="per_u")
    items = [(Counter.new(limit, Context({"u": f"u{i}"})), 1)
             for i in range(5)]
    acks = []
    sink.apply_deltas_acked(items, acks.append)
    return lane.batches, acks


def test_peer_delta_sink_acks_per_chunk():
    assert _both(_delta_sink) == ([2, 2, 1], [2, 4, 5])


def _abort(pkg, spool):
    flight = E.mod(pkg, "observability.flight")
    # slice_pause_s (the chaos hook of TPU_POD_RESIZE_SLICE_PAUSE_MS)
    # holds each member's first copy to host 2 for a second after
    # migrate_begin: the stop below lands inside that window however
    # loaded the machine, where without it a fast migration could
    # complete the resize before the stop
    lanes, fronts, coords, addrs, limits = E.elastic_pod(
        pkg, 2, n_total=3,
        resize_kwargs={"migrate_timeout_s": 0.5,
                       "transition_timeout_s": 6.0,
                       "slice_pause_s": 1.0})
    # host 0's flight trigger plane over its pod event log
    engine = flight.TriggerEngine(
        flight.FlightRecorder(sample_stride=1),
        flight.BundleSpool(spool / pkg), events=fronts[0].events,
        cooldown_s=0.0)
    engine.tick()
    try:
        oracle = _oracle(pkg, limits)
        oracle.configure_with(limits)
        users = [f"user-{i}" for i in range(24)]
        decisions = _drive(pkg, fronts[:2], users, 2, 1, oracle)
        # a proposal to an unreachable host changes nothing
        dead_lanes, dead = E.bound_lanes(pkg, 1, None)
        dead_lanes[0].stop()
        with pytest.raises(ValueError, match="unreachable at prepare"):
            coords[0].resize(3, peers={2: dead[0]})
        unchanged = (fronts[0].router.topology.hosts,
                     fronts[0].router.topology_epoch)
        # the new host dies right after its commit: stop its lane once
        # its epoch_bump is on its timeline
        stopped = {}

        def stop_host2_after_commit():
            if E.wait_for(lambda: "epoch_bump" in E.event_kinds(fronts[2]),
                          timeout=5.0, interval=0.005):
                lanes[2].stop()
                stopped["yes"] = True

        t = threading.Thread(target=stop_host2_after_commit, daemon=True)
        t.start()
        out = coords[0].resize(3, peers={2: addrs[2]})
        t.join(timeout=6)
        assert stopped.get("yes"), "host 2 never committed"
        assert not out["ok"] and out.get("aborted"), out
        kinds0 = E.event_kinds(fronts[0])
        assert kinds0.index("resize_begin") < kinds0.index("resize_abort")
        # the push-back lands off the abort's thread
        E.wait_for(lambda: sum(
            len(E.counters_of(f, "elastic")) for f in fronts[:2]
        ) == len(users), timeout=5.0)
        decisions += _drive(pkg, fronts[:2], users, 2, 1, oracle)
        engine.tick()
        return {
            "triggers": {r: n for r, n in engine.trigger_counts.items()
                         if n},
            "unchanged": unchanged, "decisions": decisions,
            "hosts": fronts[0].router.topology.hosts,
            "epochs": [f.router.topology_epoch for f in fronts[:2]],
            "aborted": fronts[0].library_stats()["pod_resize_aborted"],
        }
    finally:
        E.cancel_watchdogs(coords)
        E.stop(lanes)


def test_resize_abort_to_old_topology_with_nothing_lost(tmp_path):
    """A proposal to an unreachable host changes nothing; a new host
    that dies after its commit aborts the resize back to two hosts at a
    new epoch with every answer equal to the oracle's, and host 0's
    flight plane fires the ``resize_abort`` trigger. (Where a counter
    sits afterwards depends on how far a copy got before the death, in
    both packages: a slice the dead host acknowledged is the degraded
    window's loss, which the answers here never reach.)"""
    got = _both(_abort, spool=tmp_path)
    assert got["unchanged"] == (2, 0) and got["hosts"] == 2
    assert got["epochs"] == [2, 2] and got["aborted"] == 1
    assert got["triggers"] == {"resize_abort": 1}


def _orphan_sweep(pkg):
    Counter = E.mod(pkg, "core.counter").Counter
    Context = E.mod(pkg, "core.cel").Context
    OwnerGuard = E.mod(pkg, "server.peering")._OwnerGuard
    lanes, fronts, coords, _addrs, limits = E.elastic_pod(pkg, 1)
    try:
        front, coord = fronts[0], coords[0]
        guard = OwnerGuard(5, front._resilience)
        front._guards[5] = guard
        for i in range(2):
            counter = Counter.new(limits[0], Context({"u": f"j{i}"}))
            guard.store.check_and_update([counter], 1, False)
        storage = coord._storage()

        def boom(items):
            raise RuntimeError("storage down")

        real = storage.apply_deltas
        storage.apply_deltas = boom
        try:
            failed = (coord.sweep_orphan_journals(),
                      guard.store.journal_size())
        finally:
            storage.apply_deltas = real
        return failed, coord.sweep_orphan_journals(), \
            guard.store.journal_size(), E.counters_of(front, "elastic")
    finally:
        E.stop(lanes)


def test_sweep_orphan_journals_restores_on_failed_redistribute():
    failed, moved, journal, counts = _both(_orphan_sweep)
    assert failed == (0, 2) and moved == 2 and journal == 0
    assert len(counts) == 2


# -- the join drill's fast cases ------------------------------------------------------


def _owned_users(pkg, front, owner, limits, n=3, ns="join"):
    out, i = [], 0
    while len(out) < n:
        user = f"owned-{owner}-{i}"
        key = (limits[0]._identity, (("u", user),))
        if front.router.topology.owner_host(key) == owner:
            out.append(user)
        i += 1
    return out


def _join_ships_limits(pkg):
    Limit = E.mod(pkg, "").Limit
    limits = [Limit("join", 3, 300, [], ["u"], name="per_u")]
    lanes, fronts, _standby, addrs, limits = E.standby_pod(
        pkg, 2, limits=limits, warm=True)
    try:
        cold = list(fronts[-1]._last_limits)
        out = fronts[0].resize.join_host(addrs[-1])
        assert out["ok"], out
        oracle = _oracle(pkg, limits)
        oracle.configure_with(limits)
        user = _owned_users(pkg, fronts[0], 2, limits, n=1)[0]
        decisions = []
        for _ in range(6):
            got = bool(E.check(pkg, fronts[0], user, ns="join").limited)
            want = bool(E.check(pkg, oracle, user, ns="join").limited)
            assert got == want
            decisions.append(got)
        return cold, len(fronts[-1]._last_limits), decisions
    finally:
        E.stop(lanes)


def test_join_ships_limits_that_enforce_on_the_adoptee():
    cold, shipped, decisions = _both(_join_ships_limits)
    assert cold == [] and shipped == 1
    assert decisions == [False, False, False, True, True, True]


def _replace_join_journal(pkg):
    lanes, fronts, _standby, addrs, limits = E.standby_pod(pkg, 2,
                                                          warm=True)
    try:
        users = _owned_users(pkg, fronts[0], 1, limits, n=4)
        lanes[1].stop()

        def journaled():
            for u in users:
                assert E.check(pkg, fronts[0], u, ns="join") is not None
            return fronts[0].library_stats()["pod_failover_journal_depth"]

        assert E.wait_for(lambda: journaled() > 0, timeout=10.0)
        out = fronts[0].resize.join_host(addrs[-1], replace=1)
        assert out["ok"], out

        def replayed():
            if (fronts[0].library_stats()["pod_failover_journal_depth"] == 0
                    and E.counters_of(fronts[-1], "join")):
                return True
            for u in users:
                E.check(pkg, fronts[0], u, ns="join")
            return False

        assert E.wait_for(replayed, timeout=15.0, interval=0.1)
        return (out["mode"], out["joiner"],
                out["transition"]["moved_slices"],
                sorted(E.counters_of(fronts[-1], "join")))
    finally:
        E.stop(lanes)


def test_replace_join_hands_journal_to_the_adoptee():
    mode, joiner, moved, keys = _both(_replace_join_journal)
    assert (mode, joiner, moved) == ("replace", 1, 0) and keys


# -- the plan-seed wire, the psum transport ------------------------------------------


def test_plan_to_wire_bytes_equal_the_jax_function():
    from limitador_tpu import Limit as JLimit
    from limitador_tpu.core.counter import Counter as JCounter
    from limitador_tpu.tpu import plan_cache as jpc
    from limitador_tpu_torch import Limit
    from limitador_tpu_torch.core.counter import Counter
    from limitador_tpu_torch.device import plan_cache as pc

    def rows(mod, LimitCls, CounterCls):
        limit = LimitCls("seed", 9, 60, ["descriptors[0].m == 'GET'"],
                         ["u"], name="per_u", policy="token_bucket")
        counter = CounterCls(limit, {"u": "alice"})
        plans = [
            (b"ok", mod.DecisionPlan(mod.PLAN_OK, namespace="seed",
                                     delta=2)),
            (b"unknown", mod.DecisionPlan(mod.PLAN_UNKNOWN)),
            (b"k", mod.DecisionPlan(
                mod.PLAN_KERNEL, namespace="seed", delta=3, delta_capped=3,
                record=(7, 9, 60000, 1), limit_names=("per_u",),
                slots=(7,), owner=1)),
        ]
        return [json.dumps(mod.plan_to_wire(b, p, {7: counter}.get),
                           sort_keys=False).encode() for b, p in plans]

    assert rows(pc, Limit, Counter) == rows(jpc, JLimit, JCounter)
    # and the rebuilt plan of the port equals the JAX one's fields
    wire = json.loads(rows(pc, Limit, Counter)[2])
    blob, plan = pc.plan_from_wire(wire, lambda c: 7)
    jblob, jplan = jpc.plan_from_wire(wire, lambda c: 7)
    fields = ("kind", "namespace", "delta", "delta_capped", "record",
              "limit_names", "slots", "owner")
    assert blob == jblob
    assert [getattr(plan, f) for f in fields] == \
        [getattr(jplan, f) for f in fields]


def test_peer_psum_transport_equals_the_jax_transport():
    from limitador_tpu.parallel.mesh import PeerPsumTransport as JT
    from limitador_tpu_torch.parallel.pod import PeerPsumTransport as PT

    def run(cls):
        now = [100.0]
        sent = []

        def send(host, payload):
            if host == 2:
                raise ConnectionError("down")
            sent.append((host, payload))

        t = cls(0, send, hosts=3, stale_after_s=2.0, dead_after_rounds=3,
                clock=lambda: now[0])
        out = [t(0, b"a")]
        t.receive(1, b"p1")
        out.append(t(1, b"b"))
        now[0] += 1.5
        t.receive(2, b"p2")
        out.append(t(2, b"c"))
        now[0] += 1.0   # host 1's payload is now stale
        out.append(t(3, b"d"))
        t.attach(2)
        now[0] += 5.0
        for r in range(4, 7):
            try:
                out.append(t(r, b"e"))
            except RuntimeError as exc:
                out.append(str(exc))
        return out, sent, t.published, t.send_errors

    assert run(PT) == run(JT)


# -- the two faults of the JAX coordinator on device tables ---------------------------


def _fault_migrate_into_device(pkg):
    """Each user spends 2 of a limit of 2 on a two-host pod of served
    device tables; after a grow to 3 (which moves keys between every pair
    of hosts), every user asks again."""
    Limit = E.mod(pkg, "").Limit
    limits = [Limit("elastic", 2, 300, [], ["u"], name="per_u")]
    lanes, fronts, coords, addrs, limits = E.elastic_pod(
        pkg, 2, n_total=3, limits=limits, storage="device",
        clock=lambda: E.FROZEN_NOW)
    loop = asyncio.new_event_loop()
    try:
        users = [f"user-{i}" for i in range(16)]
        for _ in range(2):
            for i, u in enumerate(users):
                E.check(pkg, fronts[i % 2], u, loop=loop)
        out = coords[0].resize(3, peers={2: addrs[2]})
        counts = [E.counters_of(f, "elastic", loop) for f in fronts]
        again = [bool(E.check(pkg, fronts[0], u, loop=loop).limited)
                 for u in users]
        return {
            "ok": bool(out["ok"]),
            "moved": sum(c._transition.moved_counters for c in coords[:2]),
            "cells": sum(len(c) for c in counts),
            "on_new_owner": len(counts[2]),
            "values": sorted({v for c in counts for v in c.values()}),
            "limited_again": again,
        }
    finally:
        E.stop(lanes)
        E.close_limiters(fronts, loop)


def test_a_migration_into_a_served_device_owner_lands_where_the_jax_one_is_lost():
    """JAX: the receiver's ledger records a row before its apply, which
    raises on the batched device storage (no ``apply_deltas``), so the
    sender's retry is answered "applied 0" and the resize completes with
    the moved counters lost on their new owners (their users admitted
    again, past their limit) and kept on the old ones. Port: the moved
    counters land in the table behind the batcher (B2's host form) and
    are released at the source (B3b's host form); every user stays
    limited."""
    jax = _fault_migrate_into_device("jax")
    port = _fault_migrate_into_device("port")
    assert jax["ok"] and port["ok"]
    assert jax["moved"] == port["moved"] > 0
    assert jax["on_new_owner"] == 0 and jax["cells"] == 16
    assert not all(jax["limited_again"])
    assert port["cells"] == 16 and port["on_new_owner"] > 0
    assert port["values"] == [2] and all(port["limited_again"])


def _fault_release(pkg):
    """A grow 2 -> 3 then a drain 3 -> 2 within the window, on device
    tables the limiter reaches without a batcher (where the JAX
    migration applies)."""
    lanes, fronts, coords, addrs, limits = E.elastic_pod(
        pkg, 2, n_total=3, storage="device_sync",
        clock=lambda: E.FROZEN_NOW)
    try:
        oracle = _oracle(pkg, limits)
        oracle.configure_with(limits)
        users = [f"user-{i}" for i in range(20)]
        _drive(pkg, fronts[:2], users, 2, 1, oracle)
        assert coords[0].resize(3, peers={2: addrs[2]})["ok"]
        _drive(pkg, fronts, users, 3, 1, oracle)
        assert coords[0].resize(2)["ok"]
        union = {}
        for front in fronts[:2]:
            for key, value in E.counters_of(front, "elastic").items():
                union[key] = union.get(key, 0) + value
        return union, E.counters_of(oracle, "elastic")
    finally:
        E.stop(lanes)


def test_a_counter_moving_back_within_its_window_stays_exact_unlike_the_jax_one():
    """JAX: the old owner keeps the moved cells of a device table (only
    its in-memory storage can drop one), so a counter that returns within
    its window lands on its stale cell and reads too high. Port: the
    source released each moved cell (B3b's host form), so every counter
    equals the oracle's."""
    jax_union, jax_oracle = _fault_release("jax")
    port_union, port_oracle = _fault_release("port")
    assert port_union == port_oracle == jax_oracle
    too_high = [k for k in jax_union if jax_union[k] > jax_oracle[k]]
    assert too_high and all(jax_union[k] >= jax_oracle[k]
                            for k in jax_union)


def test_a_migrate_that_cannot_apply_fails_and_aborts_the_transition():
    """A receiver whose apply raises answers every retry with the error
    (its ledger records nothing), so the sender's transition fails and
    the pod aborts back to two hosts with every counter in place."""
    lanes, fronts, coords, addrs, limits = E.elastic_pod(
        "port", 2, n_total=3,
        resize_kwargs={"migrate_timeout_s": 1.0,
                       "transition_timeout_s": 8.0})
    try:
        users = [f"user-{i}" for i in range(20)]
        for i, u in enumerate(users):
            E.check("port", fronts[i % 2], u)
        before = [E.counters_of(f, "elastic") for f in fronts[:2]]
        storage = coords[2]._storage()

        def refuse(items):
            raise RuntimeError("table unavailable")

        storage.apply_deltas = refuse
        out = coords[0].resize(3, peers={2: addrs[2]})
        assert not out["ok"] and out.get("aborted"), out
        assert coords[2]._received == {}
        assert fronts[0].router.topology.hosts == 2
        assert E.wait_for(lambda: [
            E.counters_of(f, "elastic") for f in fronts[:2]] == before)
    finally:
        E.stop(lanes)


# -- the native pod: the C mirror follows a commit ------------------------------------


def test_native_pod_restamps_the_c_mirror_at_commit():
    """Two native-pipeline members and a third host grow to three. At
    the commit each member's C mirror takes the new topology
    (``hp_pod_config``) and its plans are orphaned; a row the C lane
    forwards on the old stamp is answered ``stale_epoch`` and re-planned.
    Every decision equals the JAX single-process oracle's."""
    from limitador_tpu_torch import Context, Limit
    from limitador_tpu_torch.core.counter import Counter
    from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage
    from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
    from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
    from limitador_tpu_torch.routing import PodRouter, PodTopology, counter_key
    from limitador_tpu_torch.server.peering import PodFrontend
    from limitador_tpu_torch.server.proto import rls_pb2
    from limitador_tpu_torch.server.resize import PodResizeCoordinator

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
            limiter = CompiledTorchLimiter(AsyncTorchStorage(
                TorchStorage(capacity=1 << 10, device="cpu",
                             clock=lambda: E.FROZEN_NOW), max_delay=0.001))
            front = PodFrontend(
                limiter, PodRouter(PodTopology(2 if member else 3, host, 1)),
                lanes[host], resilience=cfg)
            front.attach_resize(PodResizeCoordinator(
                front, peers={h: addrs[h]
                              for h in (range(2) if member else (host,))},
                listen_address=addrs[host]))
            asyncio.run(front.configure_with(limits))
            pipeline = NativeRlsPipeline(front, max_delay=0.001,
                                         hot_lane=True)
            front.attach_pipeline(pipeline)
            pipelines.append(pipeline)
            fronts.append(front)
            limiters.append(limiter)
        oracle = E.make_limiter("port", "memory", clock=lambda: E.FROZEN_NOW)
        oracle.configure_with(limits)

        def blob(u):
            req = rls_pb2.RateLimitRequest(domain="nat")
            d = req.descriptors.add()
            d.entries.add(key="m", value="GET")
            d.entries.add(key="u", value=u)
            return req.SerializeToString()

        def ctx(u):
            c = Context()
            c.list_binding("descriptors", [{"m": "GET", "u": u}])
            return c

        async def submit(host, data):
            return await pipelines[host].submit(data)

        def decide(host, users):
            out = pipelines[host].decide_many([blob(u) for u in users])
            got = []
            for u, raw in zip(users, out):
                if raw is None:
                    raw = asyncio.run(submit(host, blob(u)))
                resp = rls_pb2.RateLimitResponse.FromString(raw)
                got.append(resp.overall_code)
                want = oracle.check_rate_limited_and_update(
                    "nat", ctx(u), 1, False)
                assert (resp.overall_code == 2) == bool(want.limited), u
            return got

        def key_of(u):
            return counter_key(Counter.new(limits[0], ctx(u)))

        users = [f"user-{i}" for i in range(24)]
        decide(0, users)
        decide(0, users)  # repeats ride the C mirror's stamps
        hp_before = [p.hp for p in pipelines[:2]]
        out = fronts[0].resize.resize(3, peers={2: addrs[2]})
        assert out["ok"], out
        moved = [u for u in users
                 if fronts[0].router.topology.owner_host(key_of(u)) == 2]
        assert moved
        for host in range(2):
            hp = pipelines[host].hp
            assert hp is hp_before[host]
            assert hp.pod_owner(repr(key_of(moved[0])).encode()) == 2
        decide(0, users)   # the moved users' third hit: still admitted
        decide(1, users)   # the fourth: limited on every owner
        assert E.counters_of(fronts[2], "nat")
        _topology_owners("port", fronts, "nat")
    finally:
        E.stop(lanes)

        async def close():
            for pipeline, limiter in zip(pipelines, limiters):
                await pipeline.close()
                await limiter.storage.counters.close()

        asyncio.run(close())
