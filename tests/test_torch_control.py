"""The port's capacity controller against the JAX package's, on the CPU.

Every case of the JAX ``tests/test_controller.py`` runs on both packages
(each over its own actuator, event log, signal bus, metrics and
subsystems) and the two must agree exactly:

- the observation tail of ``ControlSignals`` and the bus's controller
  join; the knob envelopes (``KnobSpec`` over a seeded grid);
- ``ServerActuator`` over live port subsystems (``AdaptiveLimiter``,
  ``AdmissionController``, every ``ChunkPlanner``, a ``LeaseBroker``),
  the ceiling that only tightens, the planner retarget's clamp, sheds
  with the controller's reason;
- off as the default (the nine options with the JAX defaults), observe
  mode, the interlock, the drift gate, the up-down-up ramp changing
  membership at most once, feasibility, the event chain, the shed-floor
  event, the flight trigger firing a bundle, the ``ctl_*`` families and
  the ``controller`` section;
- ``ModelPolicy`` over a seeded grid of numpy-made snapshots (equal
  proposals: targets, membership, reason, objective, pressure), and the
  controller's decision records over injected sequences in ``observe``
  and ``on``;
- the lease broker's ``grant_scale`` (sizes equal to the JAX broker's,
  byte-identical at 1.0), a retargeted planner's chunk split staying
  exact, the standby pool across an aborted join, a tick during a
  transition;
- served: an ``observe`` server answers byte-equal with an ``off`` one,
  an ``on`` server serves the ``controller`` section with the JAX keys
  and renders the ``ctl_*`` families, and a controller that cannot come
  up as asked stops ``start`` (the binary exits 2).
"""

import asyncio
import importlib
import tempfile
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from tests import torch_elastic as E
from tests import torch_http as H
from tests.torch_steady import steady

PKGS = ("jax", "port")


def mod(pkg, name):
    return E.mod(pkg, name)


def control(pkg):
    return mod(pkg, "control")


def both(scenario, *args, **kwargs):
    """Run ``scenario(pkg, ...)`` on each package; the two results must
    be equal. Returns the port's."""
    out = {pkg: scenario(pkg, *args, **kwargs) for pkg in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def fake_actuator(pkg, knobs=None, hosts=2, events=None):
    """The JAX test's recording actuator, subclassing ``pkg``'s
    ``Actuator``."""
    C = control(pkg)
    Actuator = mod(pkg, "control.actuator").Actuator

    class FakeActuator(Actuator):
        def __init__(self):
            self._specs = tuple(knobs if knobs is not None else C.KNOBS)
            self.values = {s.name: s.neutral for s in self._specs}
            self.applied = []
            self.membership = []
            self.n_hosts = hosts
            self.grow_ok = True
            self.shrink_ok = True
            self.transition = False
            self.events = events

        def specs(self):
            return self._specs

        def read(self):
            return dict(self.values)

        def apply(self, name, value):
            self.values[name] = value
            self.applied.append((name, value))
            return value

        def hosts(self):
            return self.n_hosts

        def transition_active(self):
            return self.transition

        def can_grow(self):
            return self.grow_ok

        def can_shrink(self):
            return self.shrink_ok

        def add_host(self):
            if self.events is not None:
                self.events.emit("join_begin", host=self.n_hosts)
            self.n_hosts += 1
            self.membership.append("add_host")
            return {"ok": True}

        def drain_host(self):
            self.n_hosts -= 1
            self.membership.append("drain_host")
            return {"ok": True}

    return FakeActuator()


def controller(pkg, act, clock, mode="on", **kw):
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("sustain_s", 5.0)
    kw.setdefault("dwell_s", 30.0)
    return control(pkg).CapacityController(act, mode=mode, clock=clock, **kw)


def signals(pkg, **kw):
    return mod(pkg, "observability.signals").ControlSignals(**kw)


def tick(ctl, clock, snap, n=1):
    last = None
    for _ in range(n):
        clock.advance(1.0)
        last = ctl.tick(snap)
    return last


# pressure fallback snapshots (model in warmup: headroom 0)
BURN = dict(slo_burn_5m=2.0, queue_wait_ms=10.0)
# headroom-band snapshots (model fitted)
GROW = dict(capacity_headroom_ratio=1.0)
HOLD = dict(capacity_headroom_ratio=2.0)
IDLE = dict(capacity_headroom_ratio=4.0)


# -- the observation contract ---------------------------------------------------


def test_controller_signal_tail_order_is_pinned():
    def scenario(pkg):
        CS = mod(pkg, "observability.signals").ControlSignals
        s = CS(ctl_admission_ceiling=512.0, ctl_shed_floor=2.0,
               ctl_chunk_target_ms=1.5, ctl_lease_scale=0.5,
               ctl_last_reason="headroom_burn")
        return (CS.FIELDS[-5:], s.vector()[-4:], CS().vector()[-4:],
                CS().ctl_last_reason)

    tail, vec, neutral, reason = both(scenario)
    assert tail == ("ctl_admission_ceiling", "ctl_shed_floor",
                    "ctl_chunk_target_ms", "ctl_lease_scale",
                    "ctl_last_reason")
    assert vec == [512.0, 2.0, 1.5, 0.5]
    assert neutral == [0.0, 0.0, 0.0, 0.0] and reason == ""


def test_signal_bus_joins_controller_fields():
    def scenario(pkg):
        act = fake_actuator(pkg)
        act.values["admission_ceiling"] = 256.0
        act.values["shed_floor"] = 1.0
        ctl = controller(pkg, act, Clock(), mode="observe")
        Bus = mod(pkg, "observability.signals").SignalBus
        bus = Bus()
        bus.attach_controller(ctl)
        snap = bus.snapshot()
        bare = Bus().snapshot()
        return ([getattr(snap, f) for f in snap.FIELDS[-5:]],
                [getattr(bare, f) for f in bare.FIELDS[-5:]])

    with steady():
        joined, bare = both(scenario)
    assert joined == [256.0, 1.0, 2.0, 1.0, ""]
    assert bare == [0.0, 0.0, 0.0, 0.0, ""]


# -- the knob envelopes ---------------------------------------------------------


def test_knobspec_slew_envelope():
    def scenario(pkg):
        KnobSpec = control(pkg).KnobSpec
        chunk = KnobSpec("chunk_target_ms", lo=0.5, hi=8.0, slew=0.25,
                         neutral=2.0)
        floor = KnobSpec("shed_floor", lo=0, hi=3, slew=1.0, neutral=0,
                         integer=True, additive=True)
        return [chunk.slewed(2.0, 8.0), chunk.slewed(2.0, 0.5),
                chunk.slewed(2.0, 8.0, scale=0.25), chunk.slewed(0.6, 0.1),
                floor.slewed(0, 3), floor.slewed(3, 0), floor.slewed(3, 9)]

    assert both(scenario) == [2.5, 1.5, 2.125, 0.5, 1.0, 2.0, 3.0]


def test_knobspec_envelopes_equal_over_a_seeded_grid():
    rng = np.random.default_rng(25)
    rows = rng.uniform(-2.0, 6000.0, size=(400, 3)).tolist()

    def scenario(pkg):
        out = []
        for spec in control(pkg).KNOBS:
            for cur, want, scale in rows:
                scale = scale / 3000.0
                out.append((spec.name, spec.clamp(want),
                            spec.max_step(cur),
                            spec.slewed(cur, want, scale=scale)))
            out.append(spec.to_dict())
        return out

    both(scenario)


def _live_subsystems(pkg):
    """The live admission plane, two planners and a lease broker of
    ``pkg`` (the port's broker over a CPU table)."""
    overload_mod = mod(pkg, "admission.overload")
    controller_mod = mod(pkg, "admission.controller")
    batcher = mod(pkg, "tpu.batcher" if pkg == "jax" else "device.batcher")
    overload = overload_mod.AdaptiveLimiter(max_inflight=1024)
    admission = controller_mod.AdmissionController(mode="monitor",
                                                   overload=overload)
    planners = [batcher.ChunkPlanner(), batcher.ChunkPlanner()]
    if pkg == "jax":
        broker = SimpleNamespace(grant_scale=1.0)
    else:
        from limitador_tpu_torch.device import TorchStorage
        from limitador_tpu_torch.lease.broker import LeaseBroker

        broker = LeaseBroker(SimpleNamespace(
            storage=TorchStorage(capacity=64, device="cpu")))
    return overload, admission, planners, broker


def test_server_actuator_binds_live_subsystems():
    def scenario(pkg):
        overload, admission, planners, broker = _live_subsystems(pkg)
        act = control(pkg).ServerActuator(
            overload=overload, admission=admission, planners=planners,
            broker=broker)
        out = {
            "specs": [s.to_dict() for s in act.specs()],
            "read": act.read(),
            "applied": [act.apply("admission_ceiling", 256),
                        act.apply("shed_floor", 2),
                        act.apply("chunk_target_ms", 1.0),
                        act.apply("lease_scale", 2.0),
                        act.apply("no_such_knob", 7.0)],
        }
        out["subsystems"] = (overload.max_inflight, admission.shed_floor,
                             [p.target_s for p in planners],
                             broker.grant_scale)
        out["membership"] = (act.hosts(), act.can_grow(), act.can_shrink(),
                             act.add_host(), act.drain_host(),
                             act.transition_active())
        return out

    got = both(scenario)
    assert [s["name"] for s in got["specs"]] == [
        "admission_ceiling", "shed_floor", "chunk_target_ms", "lease_scale"]
    assert got["specs"][0]["hi"] == 1024.0
    assert got["read"] == {"admission_ceiling": 1024.0, "shed_floor": 0.0,
                           "chunk_target_ms": 2.0, "lease_scale": 1.0}
    assert got["applied"] == [256.0, 2.0, 1.0, 2.0, 7.0]
    assert got["subsystems"] == (256, 2, [0.001, 0.001], 2.0)
    assert got["membership"] == (0, False, False, None, None, False)


def test_server_actuator_retargets_planners_from_a_live_source():
    """The server hands the actuator a callable over its batcher pairs:
    a planner that appears after the actuator was built is retargeted at
    the next apply, and one a storage makes for a new serving loop starts
    at the target applied so far."""
    from limitador_tpu_torch.control import ServerActuator
    from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage

    storage = AsyncTorchStorage(TorchStorage(capacity=64, device="cpu"),
                                max_delay=0.001)
    live = []

    def planners():
        return [mb.chunk_planner for mb, _ub in storage._batcher_pairs()
                ] + live

    act = ServerActuator(planners=planners)
    assert [s.name for s in act.specs()] == ["chunk_target_ms"]
    assert act.apply("chunk_target_ms", 1.5) == 1.5
    late = mod("port", "device.batcher").ChunkPlanner()
    live.append(late)
    assert act.apply("chunk_target_ms", 1.25) == 1.25
    assert late.target_s == 0.00125

    async def bind_two_loops():
        await asyncio.get_running_loop().run_in_executor(None, lambda: 0)
        return storage._batchers_for_loop()

    first = asyncio.run(bind_two_loops())
    second = asyncio.run(bind_two_loops())
    assert first[0] is storage.batcher and second[0] is not first[0]
    assert second[0].chunk_planner.target_s == 0.00125
    for mb, ub in storage._batcher_pairs():
        if mb is not storage.batcher:
            mb._dispatch_pool.shutdown(wait=False)
            mb._collect_pool.shutdown(wait=False)
            ub._pool.shutdown(wait=False)
    asyncio.run(storage.close())


def test_adaptive_limiter_ceiling_only_tightens():
    def scenario(pkg):
        overload = mod(pkg, "admission.overload").AdaptiveLimiter(
            max_inflight=1024)
        first = overload.set_ceiling(100)
        state = (overload.max_inflight, overload.limit)
        return first, state, overload.set_ceiling(999_999), overload.hard_max

    first, state, raised, hard = both(scenario)
    assert first == 100 and state[0] == 100 and state[1] <= 100
    assert raised == 1024 and hard == 1024


def test_chunk_planner_retarget_is_clamped():
    def scenario(pkg):
        batcher = mod(pkg, "tpu.batcher" if pkg == "jax"
                      else "device.batcher")
        planner = batcher.ChunkPlanner()
        return (planner.retarget(0.004), planner.retarget(0.0),
                planner.retarget(1.0), batcher.ChunkPlanner.MIN_TARGET_S,
                batcher.ChunkPlanner.MAX_TARGET_S)

    assert both(scenario) == (0.004, 0.0005, 0.008, 0.0005, 0.008)


def test_admission_shed_floor_sheds_with_controller_reason():
    def scenario(pkg):
        adm_pkg = mod(pkg, "admission")
        ctl_mod = mod(pkg, "admission.controller")
        Resolver = mod(pkg, "admission.priority").PriorityResolver
        adm = ctl_mod.AdmissionController(
            mode="enforce",
            priorities=Resolver(namespace_map={"bulk": 0}))
        adm.admit("bulk").release()
        adm.shed_floor = 1
        with pytest.raises(ctl_mod.AdmissionShed) as exc:
            adm.admit("bulk")
        adm.admit("api").release()
        mon = ctl_mod.AdmissionController(
            mode="monitor",
            priorities=Resolver(namespace_map={"bulk": 0}))
        mon.shed_floor = 1
        ticket = mon.admit("bulk")
        holds = ticket.holds_slot
        ticket.release()
        return ("controller" in adm_pkg.SHED_REASONS, exc.value.reason,
                holds, mon.overload.inflight,
                mon._shed_counts[("controller", "low")])

    assert both(scenario) == (True, "controller", True, 0, 1)


# -- modes ----------------------------------------------------------------------

CTL_ENV = ("TPU_CTL_MODE", "TPU_CTL_INTERVAL_S", "TPU_CTL_SUSTAIN_S",
           "TPU_CTL_DWELL_S", "TPU_CTL_STANDBY", "TPU_CTL_MIN_HOSTS",
           "TPU_CTL_MAX_HOSTS", "TPU_CTL_GROW_HEADROOM",
           "TPU_CTL_SHRINK_HEADROOM")
CTL_DESTS = ("capacity_controller", "ctl_interval", "ctl_sustain",
             "ctl_dwell", "ctl_standby", "ctl_min_hosts", "ctl_max_hosts",
             "ctl_grow_headroom", "ctl_shrink_headroom")


def test_off_is_the_default_and_never_constructs(monkeypatch):
    for var in CTL_ENV:
        monkeypatch.delenv(var, raising=False)

    def scenario(pkg):
        main = mod(pkg, "server.__main__")
        storage = "tpu" if pkg == "jax" else "torch"
        args = main.build_parser().parse_args(["x.yaml", storage])
        with pytest.raises(ValueError):
            control(pkg).CapacityController(fake_actuator(pkg), mode="off")
        return {d: getattr(args, d) for d in CTL_DESTS}, \
            control(pkg).CTL_MODES

    defaults, modes = both(scenario)
    assert defaults["capacity_controller"] == "off"
    assert modes == ("off", "observe", "on")


def test_ctl_environment_defaults_are_the_jax_ones(monkeypatch):
    values = ("observe", "0.25", "2.5", "12", "127.0.0.1:1,127.0.0.1:2",
              "2", "5", "1.1", "2.9")
    for var, value in zip(CTL_ENV, values):
        monkeypatch.setenv(var, value)

    def scenario(pkg):
        main = mod(pkg, "server.__main__")
        storage = "tpu" if pkg == "jax" else "torch"
        args = main.build_parser().parse_args(["x.yaml", storage])
        return {d: getattr(args, d) for d in CTL_DESTS}

    assert both(scenario)["ctl_min_hosts"] == 2


def test_observe_mode_computes_but_never_actuates():
    def scenario(pkg):
        act = fake_actuator(pkg)
        clock = Clock()
        ctl = controller(pkg, act, clock, mode="observe", sustain_s=2.0)
        before = act.read()
        last = tick(ctl, clock, signals(pkg, **BURN), n=8)
        assert act.applied == [] and act.membership == []
        assert act.read() == before
        return last, ctl.stats()

    last, stats = both(scenario)
    assert last["would"]
    assert last["membership"]["would"] == "add_host"
    assert stats["ctl_ticks"] == 8 and stats["ctl_knob_actuations"] == 0


# -- the guard stack ------------------------------------------------------------


def test_interlock_freezes_actuation_during_transition():
    def scenario(pkg):
        act = fake_actuator(pkg)
        act.transition = True
        clock = Clock()
        ctl = controller(pkg, act, clock, sustain_s=0.0)
        held = tick(ctl, clock, signals(pkg, **BURN), n=3)
        frozen = (list(act.applied), list(act.membership),
                  ctl.stats()["ctl_interlock_holds"])
        act.transition = False
        released = tick(ctl, clock, signals(pkg, **BURN))
        return held, frozen, released, act.membership

    held, frozen, released, membership = both(scenario)
    assert held["held"] == "interlock"
    assert held["applied"] == {} and held["membership"] is None
    assert frozen == ([], [], 3)
    assert released["held"] != "interlock"
    assert membership == ["add_host"]


def test_drift_gate_damps_slews_and_freezes_membership():
    def scenario(pkg):
        act = fake_actuator(pkg)
        clock = Clock()
        ctl = controller(pkg, act, clock, sustain_s=0.0, drift_damp=0.25)
        d = tick(ctl, clock, signals(pkg, model_drift=1, **GROW), n=10)
        return d, act.membership, act.applied

    d, membership, applied = both(scenario)
    assert d["held"] == "drift_damped"
    assert membership == []
    assert next(v for name, v in applied if name == "chunk_target_ms") \
        == 1.875


def test_membership_hysteresis_up_down_up_ramp_flaps_at_most_once():
    def scenario(pkg):
        act = fake_actuator(pkg)
        clock = Clock()
        ctl = controller(pkg, act, clock, sustain_s=5.0, dwell_s=30.0)
        grow, hold, idle = (signals(pkg, **GROW), signals(pkg, **HOLD),
                            signals(pkg, **IDLE))
        steps = []
        for snap, n in ((grow, 4), (hold, 2), (grow, 4), (hold, 2)):
            tick(ctl, clock, snap, n=n)
        steps.append(list(act.membership))
        tick(ctl, clock, grow, n=6)
        steps.append(list(act.membership))
        d = tick(ctl, clock, idle, n=8)
        steps.append((list(act.membership), d["membership"]))
        clock.advance(30.0)
        tick(ctl, clock, idle, n=7)
        steps.append(list(act.membership))
        return steps, list(ctl._ring)

    steps, _ring = both(scenario)
    assert steps[0] == []
    assert steps[1] == ["add_host"]
    assert steps[2][0] == ["add_host"] and steps[2][1]["held"] == "dwell"
    assert steps[3] == ["add_host", "drain_host"]


def test_membership_respects_feasibility():
    def scenario(pkg):
        act = fake_actuator(pkg)
        act.grow_ok = False
        clock = Clock()
        ctl = controller(pkg, act, clock, sustain_s=1.0)
        d = tick(ctl, clock, signals(pkg, **GROW), n=4)
        return act.membership, d["membership"]

    membership, last = both(scenario)
    assert membership == [] and last["held"] == "infeasible"


# -- events and metrics ---------------------------------------------------------


def _events(pkg):
    return mod(pkg, "observability.events").PodEventLog(host_id=0)


def test_membership_event_precedes_the_join_chain():
    def scenario(pkg):
        events = _events(pkg)
        act = fake_actuator(pkg, events=events)
        clock = Clock()
        ctl = controller(pkg, act, clock, sustain_s=0.0, events=events)
        tick(ctl, clock, signals(pkg, **GROW))
        seq = {e["kind"]: e["seq"] for e in events.snapshot()}
        detail = events.snapshot(kind="controller_actuation")[0]["detail"]
        return seq["controller_actuation"] < seq["join_begin"], detail

    before, detail = both(scenario)
    assert before
    assert detail["action"] == "add_host"
    assert detail["reason"] == "headroom_burn"


def test_shed_floor_jump_emits_controller_actuation():
    def scenario(pkg):
        events = _events(pkg)
        act = fake_actuator(pkg)
        clock = Clock()
        ctl = controller(pkg, act, clock, events=events)
        tick(ctl, clock, signals(pkg, slo_burn_5m=1.5,
                                 capacity_headroom_ratio=2.0))
        return [e["detail"] for e in
                events.snapshot(kind="controller_actuation")]

    assert both(scenario) == [{
        "action": "shed_floor", "from_floor": 0.0, "to_floor": 1.0,
        "reason": "slo_burn",
    }]


def test_trigger_engine_fires_on_controller_actuation():
    def scenario(pkg):
        flight = mod(pkg, "observability.flight")
        events = _events(pkg)
        with tempfile.TemporaryDirectory() as spool_dir:
            rec = flight.FlightRecorder(sample_stride=1)
            eng = flight.TriggerEngine(rec, flight.BundleSpool(spool_dir),
                                       events=events)
            eng.tick()
            events.emit("controller_actuation", action="add_host",
                        hosts=2, reason="headroom_burn")
            eng.tick()
            bundles = eng.spool.list()
            reason = eng.spool.read(bundles[0]["name"])["reason"]
        return ("controller_actuation" in flight.TRIGGER_REASONS,
                flight.TriggerEngine.EVENT_TRIGGERS["controller_actuation"],
                eng.trigger_counts["controller_actuation"], len(bundles),
                reason)

    assert both(scenario) == (True, "controller_actuation", 1, 1,
                              "controller_actuation")


def _ctl_lines(text):
    return sorted(line for line in text.splitlines()
                  if line.startswith("ctl_") and "_created" not in line)


def test_controller_metrics_and_debug_surfaces():
    def scenario(pkg):
        act = fake_actuator(pkg)
        clock = Clock()
        ctl = controller(pkg, act, clock, sustain_s=0.0)
        tick(ctl, clock, signals(pkg, **BURN), n=2)
        metrics = mod(pkg, "observability.metrics").PrometheusMetrics()
        metrics.attach_render_hook(ctl)
        first = _ctl_lines(metrics.render().decode())
        second = _ctl_lines(metrics.render().decode())
        return first, second, ctl.controller_debug(), \
            [s.name for s in control(pkg).KNOBS]

    first, second, dbg, knobs = both(scenario)
    assert "ctl_mode 2.0" in first
    assert 'ctl_knob{knob="shed_floor"} 2.0' in first
    assert 'ctl_actuations_total{knob="shed_floor"} 2.0' in first
    assert 'ctl_membership_actions_total{action="add_host"} 1.0' in first
    assert "ctl_pressure 5.0" in first
    # the delta-synced counters do not double-count on a second render
    assert second == first
    assert dbg["mode"] == "on" and dbg["hosts"] == 3
    assert dbg["membership_actions"]["add_host"] == 1
    assert dbg["decisions"] and dbg["last_proposal"]
    assert [s["name"] for s in dbg["specs"]] == knobs


def test_ctl_families_declared_on_every_server():
    from prometheus_client.parser import text_string_to_metric_families

    from limitador_tpu.control import METRIC_FAMILIES as J_FAMILIES
    from limitador_tpu_torch.control import METRIC_FAMILIES
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics

    assert METRIC_FAMILIES == J_FAMILIES
    names = {f.name for f in text_string_to_metric_families(
        PrometheusMetrics().render().decode())}
    assert set(METRIC_FAMILIES) <= names
    assert both(lambda pkg: _ctl_lines(
        mod(pkg, "observability.metrics").PrometheusMetrics().render()
        .decode()))


# -- the policy and the controller over seeded inputs ---------------------------


class Estimator:
    """A serving model's forecast: ``what_if`` and ``budget_ms``."""

    def __init__(self, view, budget_ms=2.0, fails=False):
        self.view = view
        self.budget_ms = budget_ms
        self.fails = fails

    def what_if(self):
        if self.fails:
            raise RuntimeError("no fit")
        return dict(self.view)


def _snapshot_kwargs(rng, i):
    priorities = ("low", "normal", "high", "critical")
    return dict(
        ts=float(1000 + i),
        queue_wait_ms=float(rng.choice([0.0, rng.uniform(0.0, 6.0)])),
        slo_burn_5m=float(rng.choice([0.0, 0.2, 1.0,
                                      rng.uniform(0.0, 3.0)])),
        slo_breached=int(rng.integers(0, 2)),
        capacity_headroom_ratio=float(rng.choice(
            [0.0, 1.0, 2.0, 4.0, rng.uniform(0.0, 5.0)])),
        model_r2=float(rng.choice([0.0, rng.uniform(0.0, 1.0)])),
        model_drift=int(rng.random() < 0.15),
        near_exhaustion=int(rng.integers(0, 3)),
        shed_rate_by_priority={
            p: float(rng.choice([0.0, rng.uniform(0.0, 20.0)]))
            for p in priorities},
    )


def _estimator_kwargs(rng):
    choice = int(rng.integers(0, 4))
    if choice == 0:
        return None
    view = {
        "max_decisions_per_sec": float(rng.choice(
            [0.0, rng.uniform(1e3, 1e6)])),
        "predicted_decisions_per_sec": float(rng.uniform(0.0, 1e6)),
        "predicted_latency_ms": float(rng.choice(
            [0.0, rng.uniform(0.1, 8.0)])),
    }
    return dict(view=view, budget_ms=float(rng.uniform(0.5, 5.0)),
                fails=choice == 3)


def _specs_and_current(pkg, rng):
    KnobSpec = control(pkg).KnobSpec
    hard = float(rng.choice([64.0, 1024.0, 4096.0]))
    specs = [
        KnobSpec("admission_ceiling", lo=min(64.0, hard), hi=hard,
                 slew=0.25, neutral=hard, integer=True),
        *control(pkg).KNOBS[1:],
    ]
    keep = rng.random(4) < 0.85
    specs = [s for s, k in zip(specs, keep) if k]
    current = {
        "admission_ceiling": float(rng.uniform(64.0, hard)),
        "shed_floor": float(rng.integers(0, 4)),
        "chunk_target_ms": float(rng.uniform(0.5, 8.0)),
        "lease_scale": float(rng.uniform(0.25, 4.0)),
    }
    return specs, current


def test_policy_proposals_equal_over_a_seeded_grid():
    def scenario(pkg):
        rng = np.random.default_rng(20250)
        Policy = control(pkg).ModelPolicy
        policies = [Policy(), Policy(budget_ms=0.5, grow_headroom=1.5,
                                     shrink_headroom=2.5,
                                     idle_pressure=0.2,
                                     ceiling_margin=2.0)]
        out = []
        for i in range(600):
            snap = signals(pkg, **_snapshot_kwargs(rng, i))
            est_kw = _estimator_kwargs(rng)
            est = Estimator(**est_kw) if est_kw is not None else None
            specs, current = _specs_and_current(pkg, rng)
            proposal = policies[i % 2].propose(snap, est, current, specs)
            out.append((proposal.targets, proposal.membership,
                        proposal.reason, proposal.objective,
                        proposal.pressure, proposal.to_dict()))
        return out

    got = both(scenario)
    reasons = {row[2] for row in got}
    # the grid reaches every membership band and both fallbacks
    assert {"headroom_burn", "headroom_idle", "pressure_burn",
            "pressure_idle", "steady"} <= reasons
    assert any(row[3] > 0.0 for row in got)


@pytest.mark.parametrize("mode", ["observe", "on"])
def test_controller_decisions_equal_over_injected_sequences(mode):
    def scenario(pkg):
        rng = np.random.default_rng(7 if mode == "on" else 8)
        events = _events(pkg)
        act = fake_actuator(pkg, events=events)
        clock = Clock()
        est = Estimator(view={"max_decisions_per_sec": 2.0e5,
                              "predicted_decisions_per_sec": 1.5e5,
                              "predicted_latency_ms": 2.5})
        ctl = controller(pkg, act, clock, mode=mode, sustain_s=3.0,
                         dwell_s=8.0, estimator=est, events=events,
                         history=512)
        for i in range(300):
            act.transition = bool(rng.random() < 0.05)
            act.grow_ok = bool(rng.random() < 0.9)
            clock.advance(float(rng.uniform(0.2, 1.8)))
            ctl.tick(signals(pkg, **_snapshot_kwargs(rng, i)))
        return (list(ctl._ring), ctl.stats(), act.applied, act.membership,
                [(e["kind"], e["detail"]) for e in events.snapshot()],
                ctl.signal_fields())

    ring, stats, applied, membership, events, fields = both(scenario)
    assert len(ring) == 300 and stats["ctl_ticks"] == 300
    assert stats["ctl_interlock_holds"] > 0
    if mode == "on":
        assert applied and membership
        assert any(kind == "controller_actuation" for kind, _d in events)
    else:
        assert not applied and not membership and not events
        assert any(d["would"] for d in ring)


# -- the lease broker's grant_scale ---------------------------------------------


class _Plan:
    def __init__(self, delta, capped, record):
        self.delta = delta
        self.delta_capped = capped
        self.record = record


def test_grant_scale_sizes_equal_the_jax_broker():
    rng = np.random.default_rng(31)
    cases = []
    for _ in range(300):
        delta = int(rng.choice([0, 1, 2, 5, 40]))
        capped = delta if rng.random() < 0.9 else max(delta - 1, 0)
        record = []
        for _k in range(int(rng.integers(1, 4))):
            record += [0, int(rng.choice([1, 3, 10, 1000, 10**6])), 60, 0]
        blob = bytes([int(rng.integers(0, 4))])
        sized = int(rng.integers(0, 3000)) if rng.random() < 0.5 else None
        cases.append((delta, capped, record, blob, sized,
                      int(rng.integers(0, 5000)),
                      float(rng.choice([0.25, 0.5, 1.0, 2.0, 4.0]))))

    def scenario(pkg):
        Broker = mod(pkg, "lease.broker").LeaseBroker
        if pkg == "jax":
            broker = Broker(SimpleNamespace(storage=SimpleNamespace(
                credit_columnar=None)))
        else:
            from limitador_tpu_torch.device import TorchStorage

            broker = Broker(SimpleNamespace(
                storage=TorchStorage(capacity=64, device="cpu")))
        assert broker.grant_scale == 1.0
        out = []
        for delta, capped, record, blob, sized, count, scale in cases:
            broker._sizes.clear()
            if sized is not None:
                broker._sizes[blob] = sized
            broker.grant_scale = scale
            out.append(broker._size_for(blob, count,
                                        _Plan(delta, capped, record)))
        return out

    sizes = both(scenario)
    assert any(sizes)


def test_grant_scale_at_one_keeps_the_sizing():
    """At 1.0 the broker sizes every grant as before the knob: the
    scaled path is skipped, so sizes equal the JAX broker's at 1.0 and
    its unscaled formula."""
    from limitador_tpu_torch.device import TorchStorage
    from limitador_tpu_torch.lease.broker import LeaseBroker
    from limitador_tpu_torch.ops import kernel as K

    broker = LeaseBroker(SimpleNamespace(
        storage=TorchStorage(capacity=64, device="cpu")))
    for count in (0, 1, 7, 5000):
        for mx in (1, 9, 1000):
            plan = _Plan(2, 2, [0, mx, 60, 0])
            want = max(min(max(count, 1), broker.config.max_tokens,
                           K.MAX_DELTA_CAP // 2, mx // 4), 0)
            assert broker._size_for(b"x", count, plan) == want


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_lease_corpus_under_a_grant_scale_matches_jax(scale):
    """The lease corpus of ``test_torch_lease.py`` with both brokers'
    ``grant_scale`` moved: every row's answer, the broker's tallies after
    every refresh and the tables after a forced settle equal the JAX
    package's, and the tokens are conserved."""
    from limitador_tpu import Limit as JLimit
    from limitador_tpu_torch import Limit
    from limitador_tpu_torch.ops import kernel as K

    from .test_torch_lease import _Clock, _jax_leased, _port_leased
    from .test_torch_lease import _tables_equal
    from .torch_native_corpus import corpus, decide_cached, limits
    from .torch_reference import jax_host_lane

    jax_host_lane()
    config = dict(max_tokens=64, hot_threshold=2, ttl_s=30.0)
    jclock, tclock = _Clock(), _Clock()
    jp, _jl, jb = _jax_leased(jclock, limits(JLimit), **config)
    tp, _tl, tb = _port_leased(tclock, limits(Limit), **config)
    jb.grant_scale = tb.grant_scale = scale
    K.reset_launches()
    blobs = corpus(6)
    for _pass in range(3):
        for ofs in range(0, len(blobs), 64):
            part = blobs[ofs:ofs + 64]
            assert decide_cached(tp, part) == decide_cached(jp, part), ofs
            assert tb.refresh()["grants"] == jb.refresh()["grants"], ofs
            stats = tb.stats()
            assert stats == jb.stats(), ofs
            assert stats["lease_granted_tokens"] == (
                stats["lease_admissions"] + stats["lease_returned_tokens"]
                + stats["lease_outstanding_tokens"]), stats
        jclock.now += 121.0
        tclock.now += 121.0
    assert tb.stats()["lease_admissions"] > 0, "leases never engaged"
    for pipeline, clock, broker in ((jp, jclock, jb), (tp, tclock, tb)):
        pipeline.invalidate()
        decide_cached(pipeline, blobs[:8])
        clock.now += 10_000.0
        broker.refresh()
    stats = tb.stats()
    assert stats == jb.stats()
    assert stats["lease_outstanding_tokens"] == 0
    assert stats["lease_granted_tokens"] == (
        stats["lease_admissions"] + stats["lease_returned_tokens"])
    _tables_equal(jp, tp)


# -- a retargeted planner's split stays exact -----------------------------------


def test_a_retargeted_split_decides_as_one_launch():
    """The card test's drive on the CPU's table: one flush of 6,000 hits
    through a planner retargeted to 1 ms splits into 512-hit chunks (the
    flush waited past the target, which the planner halves), each
    checked-all-then-updated-all in turn; the answers, the counters and
    the final table equal an unsplit table's (``--dispatch-chunk off``)
    and a default planner's, which keeps the flush whole."""
    from limitador_tpu_torch import Limit

    from .test_torch_gpu import _retargeted_drive

    limits = [Limit("rt", 3, 60, [], ["u"], name="per_u"),
              Limit("rt", 2000, 60, [], [], name="all")]
    users = [f"u{i % 997}" for i in range(3000)]
    split = _retargeted_drive("cpu", 0.001, users, limits)
    default = _retargeted_drive("cpu", 0.008, users, limits)
    whole = _retargeted_drive("cpu", None, users, limits)
    assert split[3] == [11] and default[3] == [1] and whole[3] == [1]
    for got in (split, default):
        assert got[:2] == whole[:2]
        assert all(a.equal(b) for a, b in zip(got[2], whole[2]))
    assert sum(not limited for limited, _n in split[0]) == 2000


# -- membership over a live in-process pod ----------------------------------------


@pytest.mark.parametrize("how", ["ship_fails", "transition_aborts"])
def test_standby_pool_across_an_aborted_join(how):
    """A join that fails (the standby's lane gone before the state ship)
    or aborts (the transition's watchdog fires mid-migration) hands the
    standby's address back to the pool; the drain that follows reads the
    tail host's address from the coordinator's restored peer map and
    adds it to the pool. Both packages agree on every step."""
    def scenario(pkg):
        lanes, fronts, _standby, addrs, _limits = E.standby_pod(pkg, 2)
        coords = [f.resize for f in fronts]
        try:
            for u in range(20):
                E.check(pkg, fronts[0], f"user-{u}", ns="join")
            if how == "ship_fails":
                lanes[-1].stop()
            else:
                for coord in coords[:2]:
                    coord.slice_pause_s = 0.6
                    coord.transition_timeout_s = 0.2
            act = control(pkg).ServerActuator(
                coordinator=coords[0], standby_addresses=[addrs[2]],
                min_hosts=1, max_hosts=3)
            out = act.add_host()
            assert E.wait_for(lambda: not coords[0].busy, 15.0)
            for coord in coords[:2]:
                coord.slice_pause_s = 0.0
                coord.transition_timeout_s = 60.0
            def pool():
                return [addrs.index(a) for a in act.standby_pool()]

            joined = (out["ok"], sorted(out), pool(), act.hosts(),
                      sorted(coords[0]._peers), act.can_grow(),
                      act.can_shrink())
            drained = act.drain_host()
            return joined, (drained["ok"], pool(), act.hosts(),
                            act.can_shrink())
        finally:
            E.cancel_watchdogs(coords)
            E.stop(lanes)

    joined, drained = both(scenario)
    assert joined[0] is False and joined[2] == [2] and joined[3] == 2
    assert drained == (True, [2, 1], 1, False)


def test_a_tick_during_a_transition_holds_everything():
    """A controller bound to a live coordinator ticks while a join is in
    flight (its slices paused): the interlock holds the whole tick, no
    knob moves, and the coordinator's lock is never taken inside the
    controller's."""
    def scenario(pkg):
        lanes, fronts, _standby, addrs, _limits = E.standby_pod(pkg, 2)
        coords = [f.resize for f in fronts]
        overload = mod(pkg, "admission.overload").AdaptiveLimiter(
            max_inflight=1024)
        try:
            for coord in coords[:2]:
                coord.slice_pause_s = 0.5
            act = control(pkg).ServerActuator(
                overload=overload, coordinator=coords[0],
                standby_addresses=[addrs[2]], min_hosts=2, max_hosts=3)
            clock = Clock()
            ctl = controller(pkg, act, clock, sustain_s=0.0, dwell_s=0.0,
                             events=fronts[0].events)
            joiner = threading.Thread(target=act.add_host)
            joiner.start()
            assert E.wait_for(lambda: coords[0].busy, 10.0)
            clock.advance(1.0)
            held = ctl.tick(signals(pkg, **BURN))
            ceiling = overload.max_inflight
            joiner.join(30.0)
            assert not joiner.is_alive()
            clock.advance(1.0)
            after = ctl.tick(signals(pkg, **BURN))
            return (held["held"], held["applied"], held["membership"],
                    ctl.stats(), ceiling, act.hosts(),
                    after["held"], sorted(after["applied"]))
        finally:
            E.cancel_watchdogs(coords)
            E.stop(lanes)

    got = both(scenario)
    assert got[:3] == ("interlock", {}, None)
    assert got[3]["ctl_interlock_holds"] == 1
    assert got[4] == 1024 and got[5] == 3
    assert got[6] is None and "admission_ceiling" in got[7]


# -- served -----------------------------------------------------------------------

#: off and observe: every knob's subsystem (admission, leases, chunking);
#: on: chunking alone, the one knob that cannot change an answer
SERVED = {
    "off": ("--pipeline", "native", "--lease-mode", "on",
            "--admission-mode", "enforce"),
    "observe": ("--pipeline", "native", "--lease-mode", "on",
                "--admission-mode", "enforce", "--capacity-controller",
                "observe", "--ctl-interval", "0.05"),
    "on": ("--pipeline", "native", "--capacity-controller", "on",
           "--ctl-interval", "0.05"),
}


async def _served(tmp_path):
    port_main = importlib.import_module("limitador_tpu_torch.server.__main__")
    parse = port_main.build_parser().parse_args
    clock = H.FakeClock()
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(H.LIMITS)
    ports = {name: H.free_port() for name in SERVED}
    servers = {}
    try:
        for name, extra in SERVED.items():
            servers[name] = await port_main.start(
                parse(H.port_argv(limits_path, "torch", ports[name],
                                  *extra)), clock=clock)

        async def reload():
            H.reload_limits_file(limits_path)
            await H.wait_for(lambda: all(
                s.status["limits_file_version"] == 2
                for s in servers.values()))

        debug = {}

        async def extra(session, name, base):
            async with session.get(base + "/debug/stats") as resp:
                debug[name] = await resp.json()

        out = await H.drive(clock, {
            name: f"http://127.0.0.1:{port}" for name, port in ports.items()
        }, reload, extra)
        for name, server in servers.items():
            out[name]["debug"] = debug[name]
            ctl = server.controller
            out[name]["stats"] = ctl.stats() if ctl is not None else None
            out[name]["broker"] = getattr(
                server.native_pipeline.lease_broker, "grant_scale", None)
        return out
    finally:
        for server in servers.values():
            await server.stop()
        out["stopped"] = {name: s.controller._thread
                          for name, s in servers.items()
                          if s.controller is not None}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    with steady():
        return asyncio.run(_served(tmp_path_factory.mktemp("ctl")))


def _reference_samples(text):
    from prometheus_client.parser import text_string_to_metric_families

    return sorted(
        (s.name, tuple(sorted(s.labels.items())), s.value)
        for f in text_string_to_metric_families(text)
        if f.name in ("authorized_calls", "authorized_hits", "limited_calls")
        for s in f.samples if not s.name.endswith("_created"))


def test_observe_and_on_servers_answer_as_an_off_server(served):
    off = served["off"]
    for name in ("observe", "on"):
        got = served[name]
        assert got["steps"] == off["steps"], name
        assert got["counters"] == off["counters"], name
        assert got["limits"] == off["limits"], name
        assert _reference_samples(got["metrics"]) == \
            _reference_samples(off["metrics"]), name
    # observe moved nothing it could have moved
    assert served["observe"]["stats"]["ctl_knob_actuations"] == 0
    assert served["observe"]["broker"] == 1.0
    assert served["observe"]["stats"]["ctl_ticks"] > 0
    assert served["on"]["stats"]["ctl_ticks"] > 0
    assert not any(t is not None for t in served["stopped"].values())


def test_served_controller_section_has_the_jax_keys(served):
    from limitador_tpu.control import CapacityController as JController
    from limitador_tpu.control import ServerActuator as JActuator
    from limitador_tpu.tpu.batcher import ChunkPlanner as JPlanner

    jax = JController(JActuator(planners=[JPlanner()]),
                      mode="on").controller_debug()
    assert "controller" not in served["off"]["debug"]
    for name in ("observe", "on"):
        section = served[name]["debug"]["controller"]
        assert set(section) == set(jax), name
        assert section["mode"] == name
        assert section["ticks"] > 0
        assert section["decisions"]
    observe = served["observe"]["debug"]["controller"]
    assert [s["name"] for s in observe["specs"]] == [
        "admission_ceiling", "shed_floor", "chunk_target_ms", "lease_scale"]
    on = served["on"]["debug"]["controller"]
    assert [s["name"] for s in on["specs"]] == ["chunk_target_ms"]
    assert on["hosts"] == 0


def test_served_ctl_families_render(served):
    from prometheus_client.parser import text_string_to_metric_families

    from limitador_tpu_torch.control import METRIC_FAMILIES

    for name, mode in (("off", 0.0), ("observe", 1.0), ("on", 2.0)):
        families = {f.name: f for f in text_string_to_metric_families(
            served[name]["metrics"])}
        assert set(METRIC_FAMILIES) <= set(families), name
        assert families["ctl_mode"].samples[0].value == (
            mode if name != "off" else 0.0)
    knobs = {s.labels["knob"]: s.value for f in text_string_to_metric_families(
        served["on"]["metrics"]) if f.name == "ctl_knob" for s in f.samples}
    on = served["on"]["debug"]["controller"]["knobs"]
    assert knobs["chunk_target_ms"] == pytest.approx(on["chunk_target_ms"])


@pytest.mark.parametrize("extra,message", [
    (("--ctl-min-hosts", "4", "--ctl-max-hosts", "2"), "--ctl-min-hosts"),
    (("--ctl-standby", "127.0.0.1:9"), "--ctl-standby"),
    (("--ctl-interval", "0"), "--ctl-interval"),
])
def test_a_controller_that_cannot_come_up_stops_start(tmp_path, extra,
                                                      message):
    port_main = importlib.import_module("limitador_tpu_torch.server.__main__")
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(H.LIMITS)
    argv = H.port_argv(limits_path, "torch", H.free_port(),
                       "--capacity-controller", "on", *extra)
    with steady():
        with pytest.raises(ValueError, match=message):
            asyncio.run(port_main.start(port_main.build_parser()
                                        .parse_args(argv)))
    # the binary exits 2
    assert port_main.main(argv) == 2
