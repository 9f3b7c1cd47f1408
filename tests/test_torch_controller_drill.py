"""The capacity controller's autoscale drill, in process, on both packages.

The JAX package's ``tests/test_controller_drill.py`` (a live pod soaked
with calls while the controller runs ``on``), over ``tests/torch_elastic``'s
``standby_pod``: two members and a warm standby on real gRPC peer lanes
in this process, the controller bound to host 0's coordinator through
``ServerActuator(standby_addresses=[standby], min_hosts=2, max_hosts=3)``
and ticked on an injected clock with injected snapshots (calm, burn,
ramp noise, idle), a round of calls through host 0 after every tick:

- sustained burn grows the pod 2 -> 3 once, through ``join_host``;
  ramp noise inside the dwell moves nothing; sustained idle drains it
  back to 2 once, and the standby's address returns to the pool;
- no call fails; every answer equals an in-memory oracle's, and every
  spent counter sits on its owner, equal to the oracle's;
- the timeline reads ``controller_actuation < join_begin < epoch_bump <
  join_end``;
- the two packages' decision records, answers, counters, events and
  stats are equal.

Each phase has a deadline and the drill as a whole one of its own
(``DRILL_S``), so that a controller that never converges fails the test
instead of holding its worker.
"""

import time

from tests import torch_elastic as E

#: the drill's own time limit, per package (a run takes a few seconds)
DRILL_S = 90.0
#: each phase's deadline
PHASE_S = 30.0
MAX = 20
USERS = [f"ctl-{i}" for i in range(24)]


class Clock:
    def __init__(self, t=5000.0):
        self.t = t

    def __call__(self):
        return self.t


def _drill(pkg):
    started = time.monotonic()
    C = E.mod(pkg, "control")
    signals = E.mod(pkg, "observability.signals")
    Limit = E.mod(pkg, "").Limit
    FORWARD = E.mod(pkg, "routing").FORWARD
    Context = E.mod(pkg, "").Context
    limits = [Limit("join", MAX, 3600, [], ["u"], name="per_u")]
    lanes, fronts, _standby, addrs, _limits = E.standby_pod(
        pkg, 2, limits=limits)
    coords = [f.resize for f in fronts]
    try:
        actuator = C.ServerActuator(
            coordinator=coords[0], standby_addresses=[addrs[2]],
            min_hosts=2, max_hosts=3)
        clock = Clock()
        controller = C.CapacityController(
            actuator, events=fronts[0].events, mode="on", interval_s=0.1,
            sustain_s=0.4, dwell_s=2.0, clock=clock)
        burn = signals.ControlSignals(capacity_headroom_ratio=1.0)
        hold = signals.ControlSignals(capacity_headroom_ratio=2.0)
        idle = signals.ControlSignals(capacity_headroom_ratio=4.0)
        answers, failed, calls = [], [], {u: 0 for u in USERS}
        hosts_seen = []

        def soak(tag):
            for u in USERS:
                try:
                    got = E.check(pkg, fronts[0], u, ns="join")
                except Exception as exc:  # a failed call fails the drill
                    failed.append((tag, u, repr(exc)))
                    continue
                if got is None:
                    failed.append((tag, u, "no answer"))
                    continue
                calls[u] += 1
                answers.append((tag, u, bool(got.limited),
                                calls[u] > MAX))

        def step(snapshot, tag):
            assert time.monotonic() - started < DRILL_S, (
                f"{pkg} drill past {DRILL_S} s in {tag}")
            clock.t += 0.1
            controller.tick(snapshot)
            hosts_seen.append(actuator.hosts())
            soak(tag)

        def drive(snapshot, tag, until):
            deadline = time.monotonic() + PHASE_S
            while not until():
                assert time.monotonic() < deadline, (
                    f"{pkg} {tag}: never converged "
                    f"({controller.controller_debug()})")
                step(snapshot, tag)

        # calm: the dead band never actuates
        for _ in range(6):
            step(hold, "calm")
        calm = (actuator.hosts(), controller.stats()["ctl_hosts_added"])
        # sustained burn: the warm standby joins (2 -> 3)
        drive(burn, "grow", lambda: actuator.hosts() == 3)
        grown = (controller.stats()["ctl_hosts_added"],
                 actuator.standby_pool(), coords[0].stats()["join_completed"],
                 coords[0].stats()["join_aborted"])
        # ramp noise inside the dwell: no flap
        for _ in range(2):
            for snapshot in (burn, burn, hold, hold):
                step(snapshot, "ramp")
        ramped = (actuator.hosts(), controller.stats()["ctl_hosts_drained"])
        # sustained idle: the tail host drains once the dwell is over
        drive(idle, "shrink", lambda: actuator.hosts() == 2)
        pool = [addrs.index(a) for a in actuator.standby_pool()]
        for _ in range(3):
            step(idle, "after")

        # every spent counter on its owner, as the oracle spent it
        owners = {}
        for u in USERS:
            plan = fronts[0]._plan("join", Context({"u": u}))
            owners[u] = plan[1] if plan[0] == FORWARD else 0
        spent = [E.counters_of(front, "join") for front in fronts]
        placed = {}
        for host, counters in enumerate(spent):
            for (_name, variables), value in counters.items():
                if value:
                    placed.setdefault(dict(variables)["u"], []).append(
                        (host, value))
        kinds = E.event_kinds(fronts[0])
        seq = {}
        for event in fronts[0].events_debug()["events"]:
            seq.setdefault(event["kind"], event["seq"])
        return {
            "calm": calm, "grown": grown, "ramped": ramped, "pool": pool,
            "hosts_seen": hosts_seen, "failed": failed, "answers": answers,
            "placed": placed, "owners": owners, "calls": calls,
            "stats": controller.stats(),
            "decisions": [(d["proposal"], d["applied"], d["membership"],
                           d["held"]) for d in controller._ring],
            "actuations": [e["detail"] for e in fronts[0].events.snapshot(
                kind="controller_actuation")],
            "chain": [seq.get(k) for k in ("controller_actuation",
                                           "join_begin", "epoch_bump",
                                           "join_end")],
            "kinds": [k for k in kinds if k in (
                "controller_actuation", "join_begin", "join_end")],
        }
    finally:
        E.cancel_watchdogs(coords)
        E.stop(lanes)


def test_controller_drill_grows_and_shrinks_a_live_pod():
    out = {pkg: _drill(pkg) for pkg in ("jax", "port")}
    port = out["port"]
    for key in ("calm", "grown", "ramped", "pool", "hosts_seen", "failed",
                "answers", "placed", "owners", "calls", "stats",
                "decisions", "actuations", "chain", "kinds"):
        assert port[key] == out["jax"][key], key
    assert port["calm"] == (2, 0)
    assert port["grown"] == (1, [], 1, 0)
    assert port["ramped"] == (3, 0)
    assert port["pool"] == [2]
    assert port["hosts_seen"][-1] == 2 and max(port["hosts_seen"]) == 3
    # zero failed calls, every answer the oracle's
    assert not port["failed"]
    assert all(limited == over for _t, _u, limited, over in port["answers"])
    assert any(limited for _t, _u, limited, _o in port["answers"])
    # exactly one grow and one drain: zero flaps
    stats = port["stats"]
    assert (stats["ctl_hosts_added"], stats["ctl_hosts_drained"]) == (1, 1)
    assert [a["action"] for a in port["actuations"]] == [
        "add_host", "drain_host"]
    assert [a["reason"] for a in port["actuations"]] == [
        "headroom_burn", "headroom_idle"]
    # each spent counter once, on its owner, as the oracle spent it
    for u in USERS:
        assert port["placed"][u] == [
            (port["owners"][u], min(port["calls"][u], MAX))], u
    # the causal chain
    chain = port["chain"]
    assert None not in chain and chain == sorted(chain), chain
    assert port["kinds"][:3] == [
        "controller_actuation", "join_begin", "join_end"]
