"""The port's pod (``routing.py``, ``server/peering.py``,
``parallel/pod.py``) against the JAX package's, on the CPU.

- Routing: the route memo, the topology, the router's verdicts, pins,
  plans and ownership map, and the owner of every key of an adversarial
  corpus, each equal to the JAX ``PodTopology``/``PodRouter`` on the same
  keys (the unit tier of ``tests/test_pod.py``).
- The server's ``--pod-*`` options parse with the JAX names, environment
  variables and defaults, and the option checks stop the port's server
  (exit 2) with the JAX server's messages.
- Two in-process hosts over a real gRPC hop (the miniature pod of
  ``tests/test_pod.py``'s ``_two_host_frontends``): the port's frontends
  over its memory storage and over ``TorchStorage(device="cpu")`` answer
  every request as the JAX frontends do, forwarded ``load_counters``
  headers included, and the origin's request id reaches the owner.
- The lockstep psum lane against the JAX lane under one injected clock
  and transport.
- A real 2-process pod of port servers (``tests/torch_pod_worker.py``),
  formed over a TCPStore: its merged answers and the union of both
  hosts' counters equal a single-process 2-row ``TorchShardedStorage``
  fed the same drive (the counterpart of the JAX package's slow
  ``test_pod_routed_drive_matches_single_process``).
"""

import asyncio
import json
import socket
import time

import pytest

from limitador_tpu import routing as jrouting
from limitador_tpu_torch import routing as prouting

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- routing ------------------------------------------------------------------


def _adversarial_keys():
    """Every repr shape the ownership hash must agree on (the corpus of
    ``tests/test_pod.py``'s crc32 fuzz)."""
    keys = []
    idents = [
        ("ns", "limit"),
        ("ns", "limit", 5, 60),
        ("", ""),
        ("näme-spaçe", "límît"),
        ("ns'quoted\"", "back\\slash"),
        ("\U0001f680pod", "astral"),
    ]
    values = [
        "", "plain", "x" * 500, "non-ascii-é-ü-ß", "线程-池",
        "it's \"quoted\"", "tab\tnewline\n", "\U0001f680",
    ]
    for ident in idents:
        for v in values:
            keys.append((ident, (("u", v),)))
            keys.append((ident, (("a", v), ("b", v + "2"))))
        keys.append((ident, ()))
    return keys


def test_route_memo_is_the_jax_memo():
    memos = [pkg.RouteMemo(16) for pkg in (jrouting, prouting)]
    got = []
    for memo in memos:
        seen = []
        for i in range(2_000):
            key = (i % 37,)
            shard = memo.get(key)
            if shard is None:
                memo.put(key, i % 8)
            seen.append(shard)
        got.append((seen, memo.stats(), len(memo)))
    assert got[0] == got[1]


@pytest.mark.parametrize("hosts,sph", [(2, 1), (2, 4), (3, 2), (7, 8)])
def test_owners_equal_the_jax_topology_on_adversarial_keys(hosts, sph):
    for host_id in range(hosts):
        jt = jrouting.PodTopology(hosts=hosts, host_id=host_id,
                                  shards_per_host=sph)
        pt = prouting.PodTopology(hosts=hosts, host_id=host_id,
                                  shards_per_host=sph)
        assert pt.total_shards == jt.total_shards
        for key in _adversarial_keys():
            assert prouting.stable_hash(key) == jrouting.stable_hash(key)
            assert (pt.owner_shard(key), pt.owner_host(key),
                    pt.local_shard(key)) == (
                jt.owner_shard(key), jt.owner_host(key),
                jt.local_shard(key)), key


def test_topology_recomposes_the_single_process_shard():
    topo = prouting.PodTopology(hosts=2, host_id=0, shards_per_host=4)
    for i in range(200):
        key = (("ns", f"limit-{i}"), (("user", f"u{i}"),))
        g = prouting.stable_hash(key) % topo.total_shards
        assert topo.owner_shard(key) == g
        assert topo.owner_host(key) == g // 4
        assert topo.local_shard(key) == g % 4
        assert prouting.stable_hash(key) % 4 == topo.local_shard(key)


def _limits(pkg):
    Limit = pkg.Limit
    return [
        Limit("solo", 5, 60, [], ["u"], name="a"),
        Limit("both", 5, 60, [], ["u"], name="b"),
        Limit("both", 50, 60, [], [], name="c"),
        Limit("glob", 5, 60, [], ["u"], name="d"),
    ]


def _routers(hosts=2, host_id=0, sph=2):
    import limitador_tpu as jpkg

    import limitador_tpu_torch as ppkg

    out = []
    for pkg, routing in ((jpkg, jrouting), (ppkg, prouting)):
        router = routing.PodRouter(routing.PodTopology(
            hosts=hosts, host_id=host_id, shards_per_host=sph))
        router.configure(_limits(pkg), global_namespaces=["glob"])
        out.append(router)
    return out


@pytest.mark.parametrize("host_id", [0, 1])
def test_router_verdicts_plans_and_pins_equal_the_jax_router(host_id):
    jr, pr = _routers(host_id=host_id)
    keys = [(("solo", f"{i}"), ()) for i in range(60)]
    keys += [(("solo", "x"), (("u", f"v{i}"),)) for i in range(60)]
    for ns in ("solo", "both", "glob", "unknown"):
        for k in keys:
            assert pr.verdict(ns, [k]) == jr.verdict(ns, [k])
            assert pr.plan(ns, [k]) == jr.plan(ns, [k])
        # spanning keys of an unpinned namespace fall back to its pin
        assert pr.plan(ns, keys[:8]) == jr.plan(ns, keys[:8])
    assert pr.stats() == jr.stats()
    assert pr.pinned_map() == jr.pinned_map()
    for ns in ("solo", "both", "glob"):
        assert pr.pinned_host(ns) == jr.pinned_host(ns)
    for n in (1, 2, 3, 7):
        for ns in ("both", "glob", "", "näme"):
            assert (prouting.PodRouter.pin_host(ns, n)
                    == jrouting.PodRouter.pin_host(ns, n))
    assert {prouting.LOCAL, prouting.FORWARD, prouting.PINNED} == {
        jrouting.LOCAL, jrouting.FORWARD, jrouting.PINNED}


def test_router_verdict_is_pure_and_plan_counts():
    topo = prouting.PodTopology(hosts=2, host_id=0, shards_per_host=2)
    router = prouting.PodRouter(topo)
    keys = [(("solo", f"{i}"), ()) for i in range(40)]
    before = router.stats()
    verdicts = [router.verdict("solo", [k]) for k in keys]
    assert router.stats() == before
    assert [router.plan("solo", [k]) for k in keys] == verdicts
    after = router.stats()
    assert (after["pod_routed_local"] + after["pod_routed_forwarded"]
            == before["pod_routed_local"] + before["pod_routed_forwarded"]
            + len(keys))


def test_ownership_map_and_retarget_equal_the_jax_router():
    jr, pr = _routers(hosts=2, host_id=1, sph=4)
    assert pr.ownership_map() == jr.ownership_map()
    m = pr.ownership_map()
    assert m["shard_blocks"] == {"0": [0, 4], "1": [4, 8]}
    for router, routing in ((jr, jrouting), (pr, prouting)):
        assert router.retarget(routing.PodTopology(3, 1, 4)) == 1
        assert router.retarget(routing.PodTopology(3, 2, 4), epoch=9) == 9
    assert pr.ownership_map() == jr.ownership_map()
    assert pr.pinned_map() == jr.pinned_map()


# -- the server's options -----------------------------------------------------


POD_ARGV = [
    "limits.yaml", "sharded", "--serving-shards", "3",
    "--pod-coordinator", "127.0.0.1:7777", "--pod-processes", "2",
    "--pod-process-id", "1", "--pod-peer", "127.0.0.1:8083",
    "--pod-peer", "127.0.0.2:8083", "--pod-peer-listen", "0.0.0.0:9",
    "--pod-degraded-mode", "off", "--pod-hedge-ms", "3.5",
    "--pod-peer-breaker-failures", "5", "--pod-peer-breaker-reset-ms",
    "750", "--pod-events", "64", "--pod-psum-lane", "on",
    "--pod-psum-interval-ms", "125",
]

POD_DESTS = (
    "serving_shards", "pod_coordinator", "pod_processes", "pod_process_id",
    "pod_peer", "pod_peer_listen", "pod_degraded_mode", "pod_hedge_ms",
    "pod_peer_breaker_failures", "pod_peer_breaker_reset_ms",
    "pod_events", "pod_psum_lane", "pod_psum_interval_ms",
)

POD_ENV = {
    "SERVING_SHARDS": "4", "TPU_POD_COORDINATOR": "10.0.0.1:1",
    "TPU_POD_PROCESSES": "3", "TPU_POD_PROCESS_ID": "2",
    "TPU_POD_PEER_LISTEN": "1.2.3.4:5", "TPU_POD_DEGRADED_MODE": "off",
    "TPU_POD_HEDGE_MS": "2.5", "TPU_POD_PEER_BREAKER_FAILURES": "7",
    "TPU_POD_PEER_BREAKER_RESET_MS": "300", "TPU_POD_EVENTS": "9",
    "TPU_POD_PSUM_LANE": "on", "TPU_POD_PSUM_INTERVAL_MS": "40",
}


def _parsers():
    from limitador_tpu.server.__main__ import build_parser as jax_parser

    from limitador_tpu_torch.server.__main__ import build_parser

    return jax_parser, build_parser


@pytest.mark.parametrize("source", ["argv", "defaults", "environment"])
def test_pod_options_parse_as_the_jax_server_parses_them(source,
                                                         monkeypatch):
    if source == "environment":
        for key, value in POD_ENV.items():
            monkeypatch.setenv(key, value)
    argv = POD_ARGV if source == "argv" else ["limits.yaml", "sharded"]
    jax_parser, port_parser = _parsers()
    jargs = jax_parser().parse_args(argv)
    pargs = port_parser().parse_args(argv)
    for dest in POD_DESTS:
        assert getattr(pargs, dest) == getattr(jargs, dest), dest


@pytest.mark.parametrize("argv", [
    ["limits.yaml", "sharded", "--pod-processes", "2"],
    ["limits.yaml", "sharded", "--pod-coordinator", "127.0.0.1:7777",
     "--pod-processes", "2", "--pod-process-id", "2"],
    ["limits.yaml", "sharded", "--pod-coordinator", "127.0.0.1:7777",
     "--pod-processes", "2", "--pod-peer", "127.0.0.1:1"],
], ids=["no-coordinator", "bad-id", "peers"])
def test_pod_option_checks_stop_with_the_jax_messages(argv, tmp_path,
                                                      caplog):
    """The port's server stops with exit 2 before any store is formed
    or storage built, with the message the JAX server raises (the JAX
    server's SystemExit is checked after it forms its pod, so the peer
    count is held to its message text)."""
    from limitador_tpu_torch.server.__main__ import _pod_refusals, main

    jax_messages = {
        "--pod-processes": "--pod-processes > 1 requires --pod-coordinator "
                           "(env TPU_POD_COORDINATOR)",
        "bad-id": "--pod-process-id 2 outside [0, 2)",
        "peers": "pod: need one --pod-peer per process (2), got 1",
    }
    if "--pod-peer" in argv:
        want = jax_messages["peers"]
    elif "--pod-process-id" in argv:
        want = jax_messages["bad-id"]
    else:
        from limitador_tpu.server.__main__ import _amain

        jax_parser, _ = _parsers()
        with pytest.raises(SystemExit) as exc:
            asyncio.run(_amain(jax_parser().parse_args(argv)))
        want = str(exc.value)
        assert want == jax_messages["--pod-processes"]
    _, port_parser = _parsers()
    with pytest.raises(ValueError) as exc:
        _pod_refusals(port_parser().parse_args(argv))
    assert str(exc.value) == want
    limits = tmp_path / "limits.yaml"
    limits.write_text("[]\n")
    assert main([str(limits)] + argv[1:]) == 2


@pytest.mark.parametrize("extra", [
    ["cached"],
    ["distributed"],
], ids=["cached", "distributed"])
def test_a_pod_refuses_what_it_cannot_serve(extra, tmp_path):
    from limitador_tpu_torch.server.__main__ import main

    limits = tmp_path / "limits.yaml"
    limits.write_text("[]\n")
    argv = [str(limits), *extra, "--device", "cpu",
            "--pod-coordinator", f"127.0.0.1:{_free_port()}",
            "--pod-processes", "2", "--pod-peer", "127.0.0.1:1",
            "--pod-peer", "127.0.0.1:2"]
    assert main(argv) == 2


# -- two in-process hosts over a real gRPC hop --------------------------------


class _Clock:
    def __init__(self):
        self.now = 1_700_000_000.0

    def __call__(self):
        return self.now


def _storage(pkg_name, kind, clock):
    from limitador_tpu.storage.in_memory import InMemoryStorage as JMemory

    from limitador_tpu_torch.device import TorchStorage
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    if pkg_name == "jax":
        return JMemory(1024, clock=clock)
    if kind == "torch":
        return TorchStorage(capacity=1024, device="cpu", clock=clock)
    return InMemoryStorage(1024, clock=clock)


def _bound_lanes(PeerLane, resilience=None):
    """Two started lanes, each bound to a port the kernel chose and told
    the other's: a port picked free beforehand can be picked by another
    test at the same moment, and gRPC binds with SO_REUSEPORT."""
    lanes = [PeerLane(host, "127.0.0.1:0", {1 - host: "127.0.0.1:0"}, None,
                      resilience=resilience if host == 0 else None)
             for host in range(2)]
    for lane in lanes:
        lane.start()
    for host, lane in enumerate(lanes):
        lane.peers[1 - host] = f"127.0.0.1:{lanes[1 - host].port}"
    return lanes


def _two_hosts(pkg_name, kind, clock):
    """Two limiters behind two peer lanes on localhost, with no
    formation: the miniature pod of tests/test_pod.py."""
    import limitador_tpu as jpkg
    from limitador_tpu.server import peering as jpeering

    import limitador_tpu_torch as ppkg
    from limitador_tpu_torch.server import peering as ppeering

    pkg, peering, routing = (
        (jpkg, jpeering, jrouting) if pkg_name == "jax"
        else (ppkg, ppeering, prouting))
    RateLimiter = pkg.RateLimiter
    PeerLane, PodFrontend = peering.PeerLane, peering.PodFrontend
    lanes = _bound_lanes(PeerLane)
    frontends = []
    for host, lane in enumerate(lanes):
        frontends.append(PodFrontend(
            RateLimiter(_storage(pkg_name, kind, clock)),
            routing.PodRouter(routing.PodTopology(
                hosts=2, host_id=host, shards_per_host=1)),
            lane,
        ))
    return frontends, lanes


def _pod_limits(pkg):
    Limit = pkg.Limit
    return [
        Limit("fwd", 3, 60, [], ["u"], name="per_u"),
        Limit("multi", 2, 60, [], ["u"], name="multi_u"),
        Limit("multi", 9, 60, [], [], name="multi_total"),
        Limit("tb", 4, 2, [], ["u"], name="bucket", policy="token_bucket"),
    ]


def _script():
    """(arrival host, kind, namespace, user, delta, load, clock step)."""
    out = []
    kinds = ("check", "check", "check_load", "is_limited", "update")
    for i in range(90):
        ns = ("fwd", "multi", "tb")[i % 3]
        out.append((i % 2, kinds[i % 5], ns, f"user-{i % 5}",
                    1 + (i % 4 == 3), 0.25 * (i % 7 == 6)))
    return out


async def _drive(frontends, pkg, clock):
    from_ctx = pkg.Context
    answers = []
    for f in frontends:
        await f.configure_with(_pod_limits(pkg))
    for arrival, kind, ns, user, delta, step in _script():
        clock.now += step
        ctx = from_ctx({"u": user})
        f = frontends[arrival]
        if kind == "update":
            await f.update_counters(ns, ctx, delta)
            answers.append(("update",))
            continue
        if kind == "is_limited":
            r = await f.is_rate_limited(ns, ctx, delta)
        else:
            r = await f.check_rate_limited_and_update(
                ns, ctx, delta, kind == "check_load")
        answers.append((bool(r.limited), r.limit_name,
                        r.response_header()))
    counters = []
    for f in frontends:
        for ns in ("fwd", "multi", "tb"):
            for c in f.get_counters(ns):
                counters.append((ns, c.limit.name,
                                 tuple(sorted(c.set_variables.items())),
                                 c.remaining))
    return answers, sorted(counters), [f.router.stats() for f in frontends]


def _run_pair(pkg_name, kind):
    if pkg_name == "jax":
        import limitador_tpu as pkg
    else:
        import limitador_tpu_torch as pkg
    clock = _Clock()
    frontends, lanes = _two_hosts(pkg_name, kind, clock)
    try:
        return asyncio.run(_drive(frontends, pkg, clock))
    finally:
        for lane in lanes:
            lane.stop()


@pytest.mark.parametrize("kind", ["memory", "torch"])
def test_two_host_frontends_answer_as_the_jax_frontends(kind):
    """Every answer (headers of forwarded loads included: remaining,
    reset and the limit names), the union of the hosts' counters and the
    routing tallies equal the JAX pod's on the same requests and clock."""
    want = _run_pair("jax", "memory")
    got = _run_pair("port", kind)
    assert got[2] == want[2]
    assert got[2][0]["pod_routed_forwarded"] > 0
    assert got[2][1]["pod_routed_pinned"] + got[2][0][
        "pod_routed_pinned"] > 0
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_forwarded_request_id_and_hop_reach_the_owner():
    """The origin's x-request-id crosses the hop and is adopted on the
    owner, whose device-plane flight recorder keeps it with the remote
    decide time; the origin records the four-phase hop."""
    import limitador_tpu_torch as pkg
    from limitador_tpu_torch.observability.device_plane import (
        DeviceStatsRecorder,
        current_request_id,
        set_request_id,
    )

    clock = _Clock()
    frontends, lanes = _two_hosts("port", "memory", clock)
    seen = []
    inner = frontends[1].lane.decide_cb

    async def capture(ns, ctx, delta, load, kind):
        seen.append(current_request_id())
        return await inner(ns, ctx, delta, load, kind)

    frontends[1].lane.decide_cb = capture
    recorder = DeviceStatsRecorder()
    frontends[1].attach_flight(recorder)
    try:
        async def scenario():
            for f in frontends:
                await f.configure_with(_pod_limits(pkg))
            sent = []
            for i in range(200):
                ctx = pkg.Context({"u": f"user-{i}"})
                if frontends[0]._plan("fwd", ctx) != (prouting.FORWARD, 1):
                    continue
                set_request_id(f"trace-{i}")
                await frontends[0].check_rate_limited_and_update(
                    "fwd", ctx, 1, False)
                sent.append(f"trace-{i}")
                if len(sent) == 3:
                    return sent
            raise AssertionError("no forwarded key found")

        sent = asyncio.run(scenario())
    finally:
        for lane in lanes:
            lane.stop()
    assert seen == sent
    entries = recorder.flight.snapshot()
    assert {e["request_id"] for e in entries} >= set(sent)
    assert all("pod_remote_decide" in e["phases_ms"] for e in entries)
    hops = frontends[0].hops.hop_debug()
    assert hops["forwards_recorded"] == 3
    assert set(hops["phases"]) == {"queue", "serialize", "wire",
                                   "remote_decide"}


def test_dead_peer_maps_to_storage_error():
    import limitador_tpu_torch as pkg
    from limitador_tpu_torch.server.peering import PeerLane, PodFrontend
    from limitador_tpu_torch.storage.base import StorageError
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    lane = PeerLane(0, "127.0.0.1:0", {1: f"127.0.0.1:{_free_port()}"},
                    None)
    lane.start()
    try:
        frontend = PodFrontend(
            pkg.RateLimiter(InMemoryStorage(64)),
            prouting.PodRouter(prouting.PodTopology(2, 0, 1)), lane)

        async def scenario():
            await frontend.configure_with(_pod_limits(pkg))
            for i in range(100):
                ctx = pkg.Context({"u": f"user-{i}"})
                if frontend._plan("fwd", ctx)[0] == prouting.FORWARD:
                    await frontend.check_rate_limited_and_update(
                        "fwd", ctx, 1, False)
                    return
            raise AssertionError("no forwarded key found")

        with pytest.raises(StorageError, match="pod peer host 1"):
            asyncio.run(scenario())
        assert lane.stats()["pod_peer_errors"] == 1
    finally:
        lane.stop()


@pytest.mark.parametrize("kind", ["resize_admin", "join_admin", "plan_seed",
                                  "psum_share", "migrate", "flight",
                                  "bulk_decide", "ping"])
def test_later_kinds_answer_as_the_jax_lane_without_a_handler(kind):
    """The request kinds of the layers not ported yet answer as the JAX
    lane answers them with no handler attached."""
    import grpc

    from limitador_tpu.server.peering import PEER_METHOD as JAX_METHOD
    from limitador_tpu.server.peering import PeerLane as JaxLane

    from limitador_tpu_torch.server.peering import PEER_METHOD, PeerLane

    assert PEER_METHOD == JAX_METHOD
    answers = []
    for cls in (JaxLane, PeerLane):
        lane = cls(0, "127.0.0.1:0", {}, None)
        lane.start()
        try:
            with grpc.insecure_channel(f"127.0.0.1:{lane.port}") as ch:
                call = ch.unary_unary(PEER_METHOD)
                try:
                    answers.append(json.loads(call(
                        json.dumps({"kind": kind, "from": 1}).encode(),
                        timeout=5)))
                except grpc.RpcError as exc:
                    answers.append(exc.code())
        finally:
            lane.stop()
    assert answers[0] == answers[1]


# -- the lockstep psum lane ---------------------------------------------------


def _psum_pairs(clock):
    """Both packages' lanes, two hosts each, glued by an in-process
    lockstep transport that folds the other lane's live partials packed
    at the same clock."""
    from limitador_tpu.parallel.mesh import PodPsumLane as JaxLane

    from limitador_tpu_torch.parallel.pod import PodPsumLane

    pairs = []
    for cls in (JaxLane, PodPsumLane):
        lanes = [cls(2, 0, clock=clock), cls(2, 1, clock=clock)]

        def transport_for(me, lanes=lanes):
            def transport(round_idx, payload):
                out = [None, None]
                out[me] = payload
                out[1 - me] = lanes[1 - me]._pack(clock())
                return out
            return transport

        for host, lane in enumerate(lanes):
            lane._transport = transport_for(host)
        pairs.append(lanes)
    return pairs


def test_psum_lane_configure_claims_fixed_window_only():
    import limitador_tpu as jpkg
    from limitador_tpu.parallel.mesh import PodPsumLane as JaxLane

    import limitador_tpu_torch as ppkg
    from limitador_tpu_torch.parallel.pod import PodPsumLane

    got = []
    for pkg, cls in ((jpkg, JaxLane), (ppkg, PodPsumLane)):
        lane = cls(2, 0)
        limits = [
            pkg.Limit("gfw", 5, 60, [], ["u"], name="a"),
            pkg.Limit("gtb", 5, 60, [], ["u"], name="b",
                      policy="token_bucket"),
            pkg.Limit("gmix", 5, 60, [], ["u"], name="c"),
            pkg.Limit("gmix", 9, 60, [], [], name="d",
                      policy="token_bucket"),
        ]
        got.append(lane.configure(limits, {"gfw", "gtb", "gmix", "gmiss"}))
    assert got[0] == got[1] == frozenset({"gfw"})


def test_psum_lane_decides_as_the_jax_lane():
    """Admissions on both hosts, exchanges, window expiry, load_counters
    and Reports: every answer and every stats dict equal the JAX lane's
    under one clock."""
    import limitador_tpu as jpkg
    from limitador_tpu.core.counter import Counter as JCounter

    import limitador_tpu_torch as ppkg
    from limitador_tpu_torch.core.counter import Counter as PCounter

    now = {"t": 1_700_000_000.0}
    clock = lambda: now["t"]  # noqa: E731
    pairs = _psum_pairs(clock)
    trace = [[], []]
    for side, (pkg, Counter, lanes) in enumerate((
            (jpkg, JCounter, pairs[0]), (ppkg, PCounter, pairs[1]))):
        now["t"] = 1_700_000_000.0
        limit = pkg.Limit("gfw", 6, 60, [], ["u"], name="a")
        for lane in lanes:
            lane.configure([limit], {"gfw"})
        users = [f"u{i}" for i in range(4)]
        for step in range(120):
            now["t"] += 1.7 if step % 9 == 8 else 0.05
            lane = lanes[step % 2]
            c = Counter.new(limit, pkg.Context({"u": users[step % 4]}))
            op = step % 6
            if op == 5:
                for ln in lanes:
                    ln.exchange()
                trace[side].append(("x", ln.rounds))
                continue
            if op == 4:
                lane.update_counters([c], 2)
                trace[side].append(("u",))
                continue
            if op == 3:
                r = lane.is_rate_limited([c], 1)
            else:
                r = lane.check_and_update([c], 1, load_counters=op == 2)
            trace[side].append((
                bool(r.limited), r.limit_name,
                [(x.remaining, x.expires_in) for x in r.counters]))
        trace[side].append([ln.stats() for ln in lanes])
    assert trace[1] == trace[0]


def test_psum_lane_over_the_pod_store_unclaims_on_a_dead_exchange():
    """The default transport over a TCPStore: two lanes in threads of one
    process fold each other's partials round after round and delete the
    rounds behind them; when one host stops exchanging, the other's
    barrier times out and its pacer unclaims every namespace (they go
    back to the pinned path) and stays unclaimed across a reload."""
    import threading
    from datetime import timedelta

    from torch.distributed import TCPStore

    import limitador_tpu_torch as pkg
    from limitador_tpu_torch.core.counter import Counter
    from limitador_tpu_torch.parallel.pod import PodPsumLane

    port = _free_port()
    stores = [None, None]

    def connect(i):
        stores[i] = TCPStore("127.0.0.1", port, 2, is_master=i == 0,
                             timeout=timedelta(seconds=30))

    threads = [threading.Thread(target=connect, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    lanes = [PodPsumLane(2, i, store=stores[i], barrier_timeout_ms=1500)
             for i in (0, 1)]
    limit = pkg.Limit("gfw", 5, 60, [], ["u"], name="a")
    for lane in lanes:
        assert lane.configure([limit], {"gfw"}) == frozenset({"gfw"})
    c = Counter.new(limit, pkg.Context({"u": "zoe"}))
    for _ in range(3):
        assert not lanes[0].check_and_update([c], 1).limited
    for _ in range(2):
        assert not lanes[1].check_and_update([c], 1).limited
    for _round in range(3):
        workers = [threading.Thread(target=lane.exchange) for lane in lanes]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=10)
    assert [lane.rounds for lane in lanes] == [3, 3]
    assert lanes[0].check_and_update([c], 1).limited
    assert lanes[1].is_rate_limited([c], 1).limited
    # rounds 0 and 1 are gone from the store; round 2 is still readable
    assert not stores[0].check(["psum-lane/0/0", "psum-lane/1/1"])
    assert stores[0].check(["psum-lane/2/0", "psum-lane/2/1"])
    lanes[0].start(interval_s=0.02)
    deadline = time.time() + 10
    while lanes[0].namespaces and time.time() < deadline:
        time.sleep(0.05)
    lanes[0].close()
    assert lanes[0].namespaces == frozenset()
    assert lanes[0].configure([limit], {"gfw"}) == frozenset()


def test_frontend_routes_psum_namespaces_locally():
    import limitador_tpu_torch as pkg
    from limitador_tpu_torch.parallel.pod import PodPsumLane
    from limitador_tpu_torch.server.peering import PeerLane, PodFrontend
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    now = {"t": 1_700_000_000.0}
    lane = PodPsumLane(2, 0, clock=lambda: now["t"])
    peer = PeerLane(0, "127.0.0.1:0", {}, None)
    router = prouting.PodRouter(prouting.PodTopology(2, 0, 1))
    frontend = PodFrontend(pkg.RateLimiter(InMemoryStorage(1024)), router,
                           peer, global_namespaces={"gfw", "gtb"})
    frontend.attach_psum_lane(lane)
    limits = [
        pkg.Limit("gfw", 5, 60, [], ["u"], name="a"),
        pkg.Limit("gtb", 5, 60, [], ["u"], name="b", policy="token_bucket"),
    ]

    async def scenario():
        await frontend.configure_with(limits)
        r1 = await frontend.check_rate_limited_and_update(
            "gfw", pkg.Context({"u": "zoe"}), 1, False)
        await frontend.update_counters("gfw", pkg.Context({"u": "zoe"}), 2)
        r2 = await frontend.is_rate_limited("gfw", pkg.Context({"u": "zoe"}),
                                            3)
        return r1, r2

    r1, r2 = asyncio.run(scenario())
    assert not r1.limited and r2.limited
    assert router.ownership_map()["pinned_namespaces"] == {
        "gtb": prouting.PodRouter.pin_host("gtb", 2)}
    assert frontend.library_stats()["pod_psum_namespaces"] == 1
    assert frontend.routing_debug()["psum_lane_namespaces"] == ["gfw"]


# -- a real 2-process pod of port servers -------------------------------------


@pytest.mark.parametrize("storage", ["sharded", "torch"])
def test_pod_of_port_servers_matches_a_single_process_table(tmp_path,
                                                            storage):
    from tests import torch_pod_worker as W

    results = W.spawn_pod(tmp_path, storage)
    want, want_counters = W.drive_oracle()
    merged, counters, routed = W.merge(results)
    assert merged == want
    assert counters == want_counters
    assert routed["pod_routed_forwarded"] > 0
    assert routed["pod_routed_pinned"] > 0
    for result in results:
        assert result["lane"]["pod_peer_errors"] == 0
        http = result["http"]
        assert {p: h["status"] for p, h in http.items()} == dict.fromkeys(
            http, 200)
        routing = http["/debug/pod/routing"]["body"]
        assert routing["hosts"] == 2
        assert routing["host_id"] == result["process_id"]
        assert routing["pinned_namespaces"] == {
            "multi": prouting.PodRouter.pin_host("multi", 2)}
        assert set(http["/debug/pod"]["body"]["hosts"]) == {"0", "1"}
        events = http["/debug/events"]["body"]
        assert events["counts"]["routing_epoch"] >= 1
        stats = http["/debug/stats"]["body"]
        assert {"pod", "pod_events", "pod_routing"} <= set(stats)
        local = result["router"]["pod_routed_local"]
        assert f"pod_routed_local_total {float(local)}" in http[
            "/metrics"]["body"]
        # the pod imports its modules, the breaker of --pod-degraded-mode
        # on among them, and nothing of the JAX package
        assert result["modules"] == [
            "limitador_tpu_torch.admission",
            "limitador_tpu_torch.parallel.pod",
            "limitador_tpu_torch.server.peering",
        ]


def test_pod_membership_equals_the_jax_record():
    from limitador_tpu.parallel.mesh import PodMembership as JaxMembership

    from limitador_tpu_torch.parallel.pod import PodMembership, pod_info

    seen = []
    out = []
    for cls in (JaxMembership, PodMembership):
        m = cls(hosts=2, host_id=1, peers=("a", "b"))
        m.subscribe(lambda mm: seen.append(mm.snapshot()))
        m.subscribe(lambda mm: 1 / 0)  # a failing listener is skipped
        out.append([m.snapshot(), m.multi_host, m.apply(3, 2, ("a",)),
                    m.apply(1, 0, epoch=7), m.multi_host])
    assert out[0] == out[1]
    assert seen[:2] == seen[2:]
    # without a pod, this process alone
    assert tuple(pod_info(local_device_count=2)) == (0, 1, 2, 2)
