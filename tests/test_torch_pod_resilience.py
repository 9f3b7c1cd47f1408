"""The port's pod resilience plane (``server/peering.py``) against the
JAX package's, on the CPU (the fast tier of ``tests/test_pod_chaos.py``).

- The fault injector, the peer health state machine, the resilience
  postures and the journal's wire form, each against the JAX classes on
  the same inputs.
- Over real gRPC hops between two in-process hosts: the re-dial after a
  peer restarts on the same address, a retry of a transient error, a
  hedge that beats a stalled attempt, degraded mode off, the failover
  round trip (breaker trip, exact stand-in, journal replay into the
  restarted owner, events in causal order) run on both packages with
  equal outcomes, the breaker reset by a successful forward, a journal
  left below the threshold, and a failed replay that restores the
  journal.
- The kill-and-restart drill with a subprocess owner host
  (``tests/torch_pod_worker.py owner``): killed mid-drive, its keys keep
  answering through the stand-in, a flight bundle fires on
  ``breaker_open``, it restarts on the same address with an empty
  store, the journal replays, and its counters for keys born in the
  partition equal the oracle's.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from limitador_tpu import routing as jrouting
from limitador_tpu.server import peering as jpeering
from limitador_tpu_torch import routing as prouting
from limitador_tpu_torch.server import peering as ppeering

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).parent / "torch_pod_worker.py"

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _peering(name):
    return jpeering if name == "jax" else ppeering


# -- the fault injector, peer health, postures, the journal's wire ------------


def _injector_trace(mod):
    injector = mod.FaultInjector()
    out = []
    injector.set_fault(1, "drop")
    out += [injector.verdict(1), injector.verdict(0)]
    injector.set_fault(1, "error", times=2)
    out += [injector.verdict(1) for _ in range(4)]
    injector.clear(1)
    out.append(injector.verdict(1))
    with pytest.raises(ValueError) as exc:
        injector.set_fault(1, "explode")
    out.append(str(exc.value))
    for seed in (7, 8):
        seeded = mod.FaultInjector(seed=seed)
        seeded.set_fault(1, "delay", p=0.5)
        out.append([seeded.verdict(1) for _ in range(64)])
    out.append(injector.injected)
    return out


def test_fault_injector_verdicts_and_seeding_equal_the_jax_injector():
    want = _injector_trace(jpeering)
    assert _injector_trace(ppeering) == want
    assert want[-3] != want[-2]  # two seeds, two drills
    assert 0 < len([v for v in want[-3] if v is not None]) < 64


@pytest.mark.parametrize("spec", [
    "1:drop, 0:delay:0.25:3", "", "0:blackhole:1:1,1:error:0.5",
    "nonsense", "1:explode",
])
def test_fault_injector_env_spec_equals_the_jax_parse(spec):
    env = {"TPU_POD_FAULTS": spec, "TPU_POD_FAULT_SEED": "42",
           "TPU_POD_FAULT_DELAY_MS": "5"}
    out = []
    for mod in (jpeering, ppeering):
        try:
            injector = mod.FaultInjector.from_env(env)
        except ValueError as exc:
            out.append(("error", str(exc)))
            continue
        out.append((injector.delay_ms, injector._rules,
                    [injector.verdict(p) for p in (0, 1, 0, 1)]))
    assert out[0] == out[1]


def test_fault_injector_apply_failure_modes():
    injector = ppeering.FaultInjector(delay_ms=10.0)

    async def attempt(mode, timeout=0.05):
        injector.set_fault(1, mode, times=1)
        t0 = time.perf_counter()
        await injector.apply(1, timeout)
        return time.perf_counter() - t0

    with pytest.raises(ConnectionError, match="injected drop"):
        asyncio.run(attempt("drop"))
    with pytest.raises(RuntimeError, match="injected error"):
        asyncio.run(attempt("error"))
    with pytest.raises(TimeoutError, match="injected blackhole"):
        asyncio.run(attempt("blackhole"))
    assert asyncio.run(attempt("delay")) >= 0.01


def _health_trace(mod):
    health = mod.PeerHealth([1, 2], suspect_after=1, down_after=3)
    out = [health.state(1)]
    out += [health.record_failure(1), health.record_failure(1),
            health.record_failure(1, deadline_miss=True), health.state(1),
            health.state(2), health.deadline_misses,
            health.record_success(1), health.record_success(1),
            health.transitions, health.states(), health.record_failure(9),
            health.states()]
    return out


def test_peer_health_equals_the_jax_state_machine():
    want = _health_trace(jpeering)
    assert _health_trace(ppeering) == want
    assert want[1:4] == ["suspect", None, "down"]


def test_resilience_postures_equal_the_jax_postures():
    for make in (lambda mod: mod.PodResilience.legacy(),
                 lambda mod: mod.PodResilience(),
                 lambda mod: mod.PodResilience(breaker_failures=0,
                                               down_after=0, hedge_ms=3)):
        assert vars(make(ppeering)) == vars(make(jpeering))
    assert ppeering.PeerState.GAUGE == jpeering.PeerState.GAUGE
    assert ppeering.RETRYABLE_KINDS == jpeering.RETRYABLE_KINDS
    assert ppeering.FORWARD_TIMEOUT_SECONDS == \
        jpeering.FORWARD_TIMEOUT_SECONDS


@pytest.mark.parametrize("policy", ["fixed_window", "token_bucket"])
def test_journal_wire_equals_the_jax_wire(policy):
    """A journaled delta's wire form is the JAX package's, and it rebuilds
    a counter with the same identity (the policy included)."""
    import limitador_tpu as jpkg
    from limitador_tpu.core.counter import Counter as JCounter

    import limitador_tpu_torch as ppkg
    from limitador_tpu_torch.core.counter import Counter as PCounter

    wires = []
    for pkg, Counter, mod in ((jpkg, JCounter, jpeering),
                              (ppkg, PCounter, ppeering)):
        limit = pkg.Limit("chaos", 4, 120, ["descriptors[0].m == 'GET'"],
                          ["u"], name="per_u", policy=policy)
        counter = Counter.new(limit, pkg.Context({"u": "alice", "m": "x"}))
        wire = mod._counter_to_wire(counter, 3)
        rebuilt, delta = mod._counter_from_wire(json.loads(json.dumps(wire)))
        assert delta == 3 and rebuilt == counter
        assert hash(rebuilt) == hash(counter)
        assert rebuilt.limit.policy == policy
        wires.append(wire)
    assert wires[0] == wires[1]


def test_resilience_families_render_from_library_stats():
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics

    class Source:
        def library_stats(self):
            return {
                "peer_health_state": {1: 2, 3: 0},
                "peer_health_retries": 4,
                "peer_health_hedges_won": 1,
                "peer_health_hedges_lost": 2,
                "peer_health_redials": 3,
                "peer_health_probes": 9,
                "pod_failover_degraded_decisions": 7,
                "pod_failover_journal_depth": 5,
                "pod_failover_breaker_open": 1,
                "pod_failover_reconciles": 2,
                "pod_failover_replayed_deltas": 11,
                "pod_failover_reconcile_seconds": 0.25,
                "pod_failover_seconds": 1.5,
            }

    metrics = PrometheusMetrics()
    metrics.attach_library_source(Source())
    text = metrics.render().decode()
    assert ppeering.METRIC_FAMILIES == jpeering.METRIC_FAMILIES
    for family in ppeering.METRIC_FAMILIES:
        assert family in text, family
    assert 'peer_health_state{peer="1"} 2.0' in text
    assert "pod_failover_journal_depth 5.0" in text
    assert "pod_failover_seconds_total 1.5" in text
    assert "pod_failover_degraded_decisions_total 7.0" in text
    # a second render must not count the cumulative values twice
    assert "pod_failover_seconds_total 1.5" in metrics.render().decode()


# -- in-process resilience over real gRPC hops --------------------------------


def _pkg(name):
    import limitador_tpu as jpkg
    from limitador_tpu.storage.in_memory import InMemoryStorage as JMemory

    import limitador_tpu_torch as ppkg
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    if name == "jax":
        return jpkg, jrouting, JMemory
    return ppkg, prouting, InMemoryStorage


def _lane_pair(name="port", resilience=None):
    """Host 0 (with the resilience under test) and host 1 (a plain
    owner): a miniature 2-host pod over in-memory storages."""
    pkg, routing, InMemoryStorage = _pkg(name)
    mod = _peering(name)
    limits = [pkg.Limit("fwd", 3, 60, [], ["u"], name="per_u")]
    # each lane on a port the kernel chose, then told the other's: a port
    # picked free beforehand can be picked by another test at the same
    # moment, and gRPC binds with SO_REUSEPORT
    lanes = [mod.PeerLane(host, "127.0.0.1:0", {1 - host: "127.0.0.1:0"},
                          None, resilience=resilience if host == 0 else None)
             for host in range(2)]
    for lane in lanes:
        lane.start()
    for host, lane in enumerate(lanes):
        lane.peers[1 - host] = f"127.0.0.1:{lanes[1 - host].port}"
    ports = [lane.port for lane in lanes]
    frontends = []
    for host, lane in enumerate(lanes):
        frontends.append(mod.PodFrontend(
            pkg.RateLimiter(InMemoryStorage(1024)),
            routing.PodRouter(routing.PodTopology(2, host, 1)),
            lane, resilience=resilience if host == 0 else None,
        ))
    for f in frontends:
        asyncio.run(f.configure_with(limits))
    return frontends, lanes, ports


def _forwarded_user(name, frontend, ns="fwd"):
    pkg, routing, _ = _pkg(name)
    for i in range(200):
        if frontend._plan(ns, pkg.Context({"u": f"user-{i}"})) == (
                routing.FORWARD, 1):
            return f"user-{i}"
    raise AssertionError("no forwarded key found")


def _check(name, frontend, user, ns="fwd"):
    pkg, _, _ = _pkg(name)
    return asyncio.run(frontend.check_rate_limited_and_update(
        ns, pkg.Context({"u": user}), 1, False))


def _restart_owner(name, port, limiter=None):
    pkg, routing, InMemoryStorage = _pkg(name)
    mod = _peering(name)
    lane = mod.PeerLane(1, f"127.0.0.1:{port}", {}, None)
    lane.start()
    frontend = mod.PodFrontend(
        limiter or pkg.RateLimiter(InMemoryStorage(1024)),
        routing.PodRouter(routing.PodTopology(2, 1, 1)), lane)
    asyncio.run(frontend.configure_with(
        [pkg.Limit("fwd", 3, 60, [], ["u"], name="per_u")]))
    return lane


def _wait(predicate, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return predicate()


def test_redial_after_peer_restart_on_same_address():
    from limitador_tpu_torch.storage.base import StorageError

    frontends, lanes, ports = _lane_pair()
    restarted = []
    try:
        user = _forwarded_user("port", frontends[0])
        assert not _check("port", frontends[0], user).limited
        lanes[1].stop()
        with pytest.raises(StorageError, match="pod peer host 1"):
            _check("port", frontends[0], user)
        assert lanes[0].stats()["peer_health_redials"] >= 1
        restarted.append(_restart_owner("port", ports[1]))
        assert _check("port", frontends[0], user).limited is False
        assert lanes[0].health.state(1) == ppeering.PeerState.UP
    finally:
        for lane in lanes[:1] + restarted:
            lane.stop()


def test_retry_recovers_a_transient_peer_error():
    cfg = ppeering.PodResilience(degraded=False, retry=True,
                                 retry_backoff_ms=1.0)
    frontends, lanes, _ports = _lane_pair(resilience=cfg)
    try:
        user = _forwarded_user("port", frontends[0])
        lanes[0].faults.set_fault(1, "error", times=1)
        assert _check("port", frontends[0], user).limited is False
        stats = lanes[0].stats()
        assert stats["peer_health_retries"] == 1
        assert stats["pod_peer_errors"] == 0
        assert lanes[0].health.state(1) == ppeering.PeerState.UP
    finally:
        for lane in lanes:
            lane.stop()


def test_hedged_forward_wins_when_the_first_attempt_stalls():
    cfg = ppeering.PodResilience(degraded=False, retry=False, hedge_ms=30.0)
    frontends, lanes, _ports = _lane_pair(resilience=cfg)
    try:
        user = _forwarded_user("port", frontends[0])
        lanes[0].faults.delay_ms = 400.0
        lanes[0].faults.set_fault(1, "delay", times=1)
        t0 = time.perf_counter()
        assert _check("port", frontends[0], user).limited is False
        assert time.perf_counter() - t0 < 0.35
        assert lanes[0].stats()["peer_health_hedges_won"] == 1
        assert frontends[0].events.counts()["hedge_won"] == 1
    finally:
        for lane in lanes:
            lane.stop()


def test_degraded_mode_off_fails_the_request():
    from limitador_tpu_torch.storage.base import StorageError

    frontends, lanes, _ports = _lane_pair(
        resilience=ppeering.PodResilience.legacy())
    try:
        user = _forwarded_user("port", frontends[0])
        lanes[1].stop()
        with pytest.raises(StorageError, match="pod peer host 1"):
            _check("port", frontends[0], user)
        assert frontends[0].resilience_stats()[
            "pod_failover_degraded_decisions"] == 0
    finally:
        lanes[0].stop()


def _failover_round_trip(name):
    """The in-process round trip of tests/test_pod_chaos.py: the owner
    stops, the breaker trips, its traffic is decided by the stand-in and
    journaled, the owner restarts on the same address with its storage,
    the probe replays the journal and routing flips back."""
    mod = _peering(name)
    cfg = mod.PodResilience(
        degraded=True, retry=True, breaker_failures=2,
        breaker_reset_s=0.2, probe_interval_s=0.05, retry_backoff_ms=1.0,
    )
    frontends, lanes, ports = _lane_pair(name, resilience=cfg)
    restarted = []
    try:
        user = _forwarded_user(name, frontends[0])
        before = [_check(name, frontends[0], user).limited for _ in range(2)]
        lanes[1].stop()
        degraded = [_check(name, frontends[0], user).limited
                    for _ in range(4)]
        during = dict(frontends[0].resilience_stats())
        restarted.append(_restart_owner(name, ports[1],
                                        frontends[1]._limiter))
        assert _wait(lambda: (
            frontends[0].resilience_stats()["pod_failover_journal_depth"]
            == 0 and frontends[0].resilience_stats()[
                "pod_failover_reconciles"] >= 1))
        after_stats = dict(frontends[0].resilience_stats())
        after = _check(name, frontends[0], user).limited
        events = frontends[0].events_debug()["events"]
        first = {}
        for event in events:
            first.setdefault(event["kind"], event)
        order = sorted(
            ("degraded_enter", "journal_replay_begin", "breaker_closed",
             "journal_replay_end", "degraded_exit"),
            key=lambda k: first[k]["seq"])
        return {
            "before": before, "degraded": degraded, "after": after,
            "during": {k: during[k] for k in (
                "pod_failover_degraded_decisions",
                "pod_failover_journal_depth", "pod_failover_breaker_open")},
            "replayed": after_stats["pod_failover_replayed_deltas"],
            "failover_s": after_stats["pod_failover_seconds"] > 0,
            "order": order,
            "begin": first["journal_replay_begin"]["detail"],
            "end": first["journal_replay_end"]["detail"],
            "counts": {k: frontends[0].events.counts()[k] for k in (
                "degraded_enter", "degraded_exit", "breaker_open")},
            "health": lanes[0].health.state(1),
            "last_degraded": frontends[0].resilience_stats()[
                "pod_failover_degraded_decisions"],
        }
    finally:
        for lane in lanes[:1] + restarted:
            lane.stop()


def test_degraded_failover_round_trip_equals_the_jax_pod():
    want = _failover_round_trip("jax")
    got = _failover_round_trip("port")
    assert got == want
    # the stand-in starts empty: a fresh window of 3, the 4th limited;
    # the owner then holds 2 + 3 replayed and limits the next forward
    assert got["degraded"] == [False, False, False, True]
    assert got["after"] is True
    assert got["replayed"] == 1 and got["last_degraded"] == 4
    assert got["order"] == ["degraded_enter", "journal_replay_begin",
                            "breaker_closed", "journal_replay_end",
                            "degraded_exit"]


def test_successful_forwards_reset_the_peer_breaker():
    cfg = ppeering.PodResilience(
        degraded=True, retry=False, breaker_failures=2,
        breaker_reset_s=60.0, probe_interval_s=60.0,
    )
    frontends, lanes, _ports = _lane_pair(resilience=cfg)
    try:
        user = _forwarded_user("port", frontends[0])
        lanes[0].faults.set_fault(1, "error", times=1)
        assert not _check("port", frontends[0], user).limited
        assert not _check("port", frontends[0], user).limited
        lanes[0].faults.set_fault(1, "error", times=1)
        assert not _check("port", frontends[0], user).limited
        stats = frontends[0].resilience_stats()
        assert stats["pod_failover_breaker_open"] == 0
        assert stats["pod_failover_degraded_decisions"] == 2
    finally:
        for lane in lanes:
            lane.stop()


def test_subthreshold_journal_drains_while_peer_is_up():
    cfg = ppeering.PodResilience(
        degraded=True, retry=False, breaker_failures=3,
        breaker_reset_s=0.2, probe_interval_s=0.3,
    )
    frontends, lanes, _ports = _lane_pair(resilience=cfg)
    try:
        user = _forwarded_user("port", frontends[0])
        lanes[0].faults.set_fault(1, "error", times=1)
        assert not _check("port", frontends[0], user).limited
        assert not _check("port", frontends[0], user).limited
        assert lanes[0].health.state(1) == ppeering.PeerState.UP
        assert frontends[0].resilience_stats()[
            "pod_failover_journal_depth"] == 1
        assert _wait(lambda: (
            frontends[0].resilience_stats()["pod_failover_journal_depth"]
            == 0 and frontends[0].resilience_stats()[
                "pod_failover_reconciles"] >= 1))
        # replayed 1 + forwarded 1 of 3: one more admits, then limited
        assert _check("port", frontends[0], user).limited is False
        assert _check("port", frontends[0], user).limited is True
    finally:
        for lane in lanes:
            lane.stop()


def test_failed_journal_replay_restores_the_journal():
    cfg = ppeering.PodResilience(
        degraded=True, retry=False, breaker_failures=1,
        breaker_reset_s=60.0, probe_interval_s=60.0,
    )
    frontends, lanes, _ports = _lane_pair(resilience=cfg)
    try:
        user = _forwarded_user("port", frontends[0])
        lanes[1].stop()
        assert not _check("port", frontends[0], user).limited
        assert frontends[0].resilience_stats()[
            "pod_failover_journal_depth"] == 1
        assert frontends[0]._peer_recovered(1) is False
        stats = frontends[0].resilience_stats()
        assert stats["pod_failover_journal_depth"] == 1
        assert stats["pod_failover_reconciles"] == 0
        assert stats["pod_failover_breaker_open"] == 1
        events = frontends[0].events_debug(kind="journal_replay_end")
        assert [e["detail"]["ok"] for e in events["events"]] == [False]
    finally:
        lanes[0].stop()


# -- the kill-and-restart drill with a subprocess owner host -------------------


def _spawn_owner(tmp_path, port, tag):
    ready, stop = tmp_path / f"ready-{tag}", tmp_path / f"stop-{tag}"
    out = tmp_path / f"out-{tag}.json"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_POD_")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, str(WORKER), "owner", "--listen",
         f"127.0.0.1:{port}", "--ready", str(ready), "--stop", str(stop),
         "--out", str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    deadline = time.time() + 30
    while not ready.exists():
        if proc.poll() is not None:
            raise AssertionError(proc.communicate()[1][-4000:])
        assert time.time() < deadline, "the owner did not come up"
        time.sleep(0.05)
    return proc, stop, out


def test_kill_and_restart_drill(tmp_path):
    """Host 1 (a subprocess) is killed mid-drive: every call for its keys
    is answered, none with an error; the breaker's opening fires a flight
    bundle holding the degraded and forwarded exemplars; host 1 restarts
    on the same address with an empty store, the journal replays, and
    its counters equal the oracle for the keys born in the partition
    (the older key within one extra window)."""
    import limitador_tpu_torch as pkg
    from limitador_tpu_torch.observability.flight import (
        BundleSpool,
        FlightRecorder,
        TriggerEngine,
    )
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    from tests.torch_pod_worker import (
        CHAOS_MAX,
        CHAOS_NAMESPACE,
        chaos_limits,
    )

    port = _free_port()
    proc, _stop, _out = _spawn_owner(tmp_path, port, "a")
    procs = [proc]
    cfg = ppeering.PodResilience(
        degraded=True, retry=True, breaker_failures=2,
        breaker_reset_s=0.2, probe_interval_s=0.1, retry_backoff_ms=1.0,
    )
    lane = ppeering.PeerLane(0, "127.0.0.1:0", {1: f"127.0.0.1:{port}"},
                             None, resilience=cfg)
    lane.start()
    frontend = ppeering.PodFrontend(
        pkg.RateLimiter(InMemoryStorage(4096)),
        prouting.PodRouter(prouting.PodTopology(2, 0, 1)), lane,
        resilience=cfg)
    asyncio.run(frontend.configure_with(chaos_limits()))
    flight = FlightRecorder(sample_stride=1, host_id=0)
    frontend.attach_flight_recorder(flight)
    spool = BundleSpool(str(tmp_path / "flight-spool"))
    engine = TriggerEngine(flight, spool, events=frontend.events,
                           window_s=120.0, cooldown_s=0.0)
    engine.tick()  # the priming tick baselines the event counts

    def check(user):
        return asyncio.run(frontend.check_rate_limited_and_update(
            CHAOS_NAMESPACE, pkg.Context({"u": user}), 1, False))

    try:
        owned = [
            f"w{i}" for i in range(400)
            if frontend._plan(CHAOS_NAMESPACE, pkg.Context({"u": f"w{i}"}))
            == (prouting.FORWARD, 1)
        ][:5]
        assert len(owned) == 5
        pre_user, fresh_users = owned[0], owned[1:]
        for _ in range(2):
            assert not check(pre_user).limited
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        admitted = {u: 0 for u in owned}
        for _round in range(CHAOS_MAX + 1):
            for user in owned:
                if not check(user).limited:  # an error fails the drill
                    admitted[user] += 1
        stats = frontend.resilience_stats()
        assert stats["pod_failover_breaker_open"] == 1
        assert stats["pod_failover_journal_depth"] == len(owned)
        assert all(n == CHAOS_MAX for n in admitted.values())
        engine.tick()
        assert engine.trigger_counts["breaker_open"] == 1
        bundle = spool.read(engine.last_bundle)
        assert bundle["reason"] == "breaker_open"
        lanes_seen = {e["lane"] for e in bundle["local"]["exemplars"]}
        assert {"degraded", "pod_forward"} <= lanes_seen
        assert any(e["kind"] == "breaker_open" for e in bundle["events"])

        proc2, stop2, out2 = _spawn_owner(tmp_path, port, "b")
        procs.append(proc2)
        assert _wait(lambda: (
            frontend.resilience_stats()["pod_failover_journal_depth"] == 0
            and frontend.resilience_stats()["pod_failover_reconciles"] >= 1),
            timeout=30)
        stats = frontend.resilience_stats()
        assert stats["pod_failover_replayed_deltas"] == len(owned)
        degraded_before = stats["pod_failover_degraded_decisions"]
        for user in owned:  # the owner enforces the replayed window
            assert check(user).limited
        assert frontend.resilience_stats()[
            "pod_failover_degraded_decisions"] == degraded_before
        stop2.write_text("")
        proc2.wait(timeout=15)
        by_user = {c["u"]: c for c in json.loads(out2.read_text())[
            "counters"]}
        oracle = pkg.RateLimiter(InMemoryStorage(4096))
        oracle.configure_with(chaos_limits())
        for user in owned:
            for _ in range(admitted[user]):
                oracle.check_rate_limited_and_update(
                    CHAOS_NAMESPACE, pkg.Context({"u": user}), 1, False)
        want = {c.set_variables["u"]: c.remaining
                for c in oracle.get_counters(CHAOS_NAMESPACE)}
        for user in fresh_users:
            assert by_user[user]["remaining"] == want[user], user
        # the older key lost its 2 pre-kill admissions with the owner's
        # store: the replayed window is exact, the total within two
        # window budgets
        assert by_user[pre_user]["remaining"] == want[pre_user]
        assert 2 + admitted[pre_user] <= 2 * CHAOS_MAX
    finally:
        lane.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_a_replay_lands_in_a_served_device_owner_where_the_jax_one_fails():
    """A journal replay into an owner served as the server builds it (an
    AsyncRateLimiter over the batched device storage): the port applies
    it to the table behind the batcher (B2's host form on the card); the
    JAX frontend asks the batched storage itself for ``apply_deltas``,
    which it lacks (ROADMAP Queue C)."""
    import limitador_tpu as jpkg
    from limitador_tpu.core.counter import Counter as JCounter
    from limitador_tpu.core.limiter import AsyncRateLimiter as JAsync
    from limitador_tpu.tpu.batcher import AsyncTpuStorage
    from limitador_tpu.tpu.storage import TpuStorage

    import limitador_tpu_torch as ppkg
    from limitador_tpu_torch.core.counter import Counter as PCounter
    from limitador_tpu_torch.core.limiter import AsyncRateLimiter as PAsync
    from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage

    owners = {
        "jax": (jpkg, JCounter, jpeering, jrouting,
                JAsync(AsyncTpuStorage(TpuStorage(capacity=64)))),
        "port": (ppkg, PCounter, ppeering, prouting,
                 PAsync(AsyncTorchStorage(TorchStorage(capacity=64,
                                                       device="cpu")))),
    }
    outcome = {}
    for name, (pkg, Counter, mod, routing, limiter) in owners.items():
        lane = mod.PeerLane(1, "127.0.0.1:0", {}, None)
        frontend = mod.PodFrontend(
            limiter, routing.PodRouter(routing.PodTopology(2, 1, 1)), lane)
        limit = pkg.Limit("drill", 4, 120, [], ["u"], name="d")
        asyncio.run(frontend.configure_with([limit]))
        counter = Counter.new(limit, pkg.Context({"u": "x"}))
        try:
            outcome[name] = frontend._apply_from_peer(
                [mod._counter_to_wire(counter, 3)])
        except AttributeError as exc:
            outcome[name] = str(exc)
            continue
        table = limiter.storage.counters.inner
        got, = table.get_counters({limit})
        outcome["remaining"] = got.remaining
    assert outcome == {
        "jax": "'AsyncTpuStorage' object has no attribute 'apply_deltas'",
        "port": 1, "remaining": 1}
