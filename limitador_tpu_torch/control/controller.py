"""The capacity controller: one cadence loop closing the admission
and membership loops.

Port counterpart of ``limitador_tpu/control/controller.py``. Each tick:
snapshot the signal bus, ask the policy for a proposed operating point,
then actuate under four nested guards, in order:

1. **Interlock**: never actuate (knobs or membership) while a
   resize/join transition is active or proposing; the tick is counted
   and recorded, nothing moves.
2. **Drift gate**: the serving model's CUSUM drift flag tightens every
   slew envelope to ``drift_damp`` (default 1/4) and freezes
   membership: a model that just stopped predicting must not steer
   topology.
3. **Per-knob slew limits**: every applied value is clamped to the
   knob's envelope around its current value (``KnobSpec.slewed``).
4. **Membership dwell + hysteresis**: a membership proposal must
   sustain for ``sustain_s`` (resetting whenever the proposal leaves
   its band) and the pod must have dwelt ``dwell_s`` since the last
   membership change; an up-down-up ramp changes membership at most
   once.

Modes: ``observe`` computes, records and logs every decision but
applies nothing (the ``would`` field of the decision record shows what
``on`` would have done); ``on`` actuates. ``off`` never constructs the
controller at all.

Membership actuations and shed-floor changes emit a
``controller_actuation`` pod event, before the resize drives, so that
the timeline reads ``controller_actuation < join_begin < epoch_bump <
join_end``; the flight recorder's ``TriggerEngine`` watches that kind,
so every autoscale decision leaves an incident bundle. Routine knob
slews do not emit; they are visible in the decision ring
(``/debug/stats`` ``controller``), the ``ctl_*`` families and the
signal tail.

Actuator calls, which take subsystem locks, run outside the
controller's own lock. A tick that raises is logged and the cadence
thread goes on, as in the JAX package: the controller only moves knobs
and membership, and a transient failure (a peer unreachable during a
join) must not stop it.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, Optional

from .policy import ModelPolicy, Proposal

__all__ = ["CTL_MODES", "CapacityController"]

log = logging.getLogger("limitador.control")

#: --capacity-controller values; off = not constructed.
CTL_MODES = ("off", "observe", "on")


class CapacityController:
    def __init__(
        self,
        actuator,
        policy: Optional[ModelPolicy] = None,
        signals=None,            # observability.signals.SignalBus
        estimator=None,          # observability.model.ServingModelEstimator
        events=None,             # observability.events.PodEventLog
        mode: str = "observe",
        interval_s: float = 1.0,
        sustain_s: float = 5.0,
        dwell_s: float = 30.0,
        drift_damp: float = 0.25,
        history: int = 128,
        clock=time.monotonic,
    ):
        if mode not in ("observe", "on"):
            raise ValueError(
                f"controller mode {mode!r} (use off|observe|on)"
            )
        self.actuator = actuator
        self.policy = policy or ModelPolicy()
        self.mode = mode
        self.interval_s = float(interval_s)
        self.sustain_s = float(sustain_s)
        self.dwell_s = float(dwell_s)
        self.drift_damp = float(drift_damp)
        self._signals = signals
        self._estimator = estimator
        self._events = events
        self._clock = clock
        # _lock guards only the decision ring and counters (read by
        # /debug/stats and the metrics poll); actuator calls, which
        # take subsystem locks, always happen outside it.
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(history), 1))
        self._ticks = 0
        self._interlock_holds = 0
        self._actuations: Dict[str, int] = {}
        self._membership_actions: Dict[str, int] = {
            "add_host": 0, "drain_host": 0,
        }
        self._last_proposal: Optional[Proposal] = None
        self._last_reason = ""
        # metric-sync baselines (poll() increments counters by delta)
        self._reported: Dict[str, float] = {}
        # membership clocks
        self._grow_sustain = 0.0
        self._shrink_sustain = 0.0
        self._last_membership_at: Optional[float] = None
        self._last_tick_at: Optional[float] = None
        # cadence thread
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- cadence -------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="capacity-controller",
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as exc:  # the loop must never die
                log.warning("capacity controller tick failed: %s", exc)

    # -- one control step ----------------------------------------------------

    def tick(self, snapshot=None) -> dict:
        """One control step (the cadence thread's body; tests call it
        inline with injected snapshots/clocks). Returns the decision
        record appended to the ring."""
        now = self._clock()
        dt = (
            now - self._last_tick_at
            if self._last_tick_at is not None else self.interval_s
        )
        self._last_tick_at = now
        snap = snapshot
        if snap is None:
            if self._signals is not None:
                snap = self._signals.snapshot()
            else:
                from ..observability.signals import ControlSignals

                snap = ControlSignals()
        current = self.actuator.read()
        specs = self.actuator.specs()
        proposal = self.policy.propose(
            snap, self._estimator, current, specs
        )
        decision: dict = {
            "ts": round(float(getattr(snap, "ts", 0.0)), 3),
            "mode": self.mode,
            "proposal": proposal.to_dict(),
            "current": {k: round(v, 4) for k, v in current.items()},
            "applied": {},
            "would": {},
            "membership": None,
            "held": None,
        }

        # 1. the global interlock: a transition in flight freezes
        # everything (its own epoch bumps are already re-steering load)
        if self.actuator.transition_active():
            decision["held"] = "interlock"
            self._finish(decision, proposal, interlock=True)
            return decision

        # 2. the drift gate: an untrusted model tightens slews and
        # freezes membership
        drifted = int(getattr(snap, "model_drift", 0)) == 1
        slew_scale = self.drift_damp if drifted else 1.0
        if drifted:
            decision["held"] = "drift_damped"

        # 3. knobs, each inside its slew envelope
        shed_floor_jump = None
        for spec in specs:
            cur = current.get(spec.name)
            want = proposal.targets.get(spec.name)
            if cur is None or want is None:
                continue
            nxt = spec.slewed(cur, want, scale=slew_scale)
            if nxt == cur:
                continue
            if self.mode == "on":
                applied = self.actuator.apply(spec.name, nxt)
                decision["applied"][spec.name] = round(applied, 4)
                if spec.name == "shed_floor" and applied != cur:
                    shed_floor_jump = (cur, applied)
                with self._lock:
                    self._actuations[spec.name] = (
                        self._actuations.get(spec.name, 0) + 1
                    )
            else:
                decision["would"][spec.name] = round(nxt, 4)
        if shed_floor_jump is not None and self._events is not None:
            # a shed-threshold jump is an SLO-protection action worth
            # an autopsy: emit the trigger-watched event kind
            self._events.emit(
                "controller_actuation", action="shed_floor",
                from_floor=shed_floor_jump[0], to_floor=shed_floor_jump[1],
                reason=proposal.reason,
            )

        # 4. membership: sustain + dwell on the policy's band proposal
        decision["membership"] = self._membership_step(
            proposal, now, dt, drifted
        )
        self._finish(decision, proposal)
        return decision

    def _membership_step(self, proposal: Proposal, now: float,
                         dt: float, drifted: bool) -> Optional[dict]:
        desire = proposal.membership
        if drifted:
            desire = 0  # the drift gate freezes topology
        if desire > 0:
            self._grow_sustain += dt
            self._shrink_sustain = 0.0
        elif desire < 0:
            self._shrink_sustain += dt
            self._grow_sustain = 0.0
        else:
            # the dead band resets both clocks — this is the
            # hysteresis that absorbs diurnal ramps
            self._grow_sustain = 0.0
            self._shrink_sustain = 0.0
            return None
        sustain = (
            self._grow_sustain if desire > 0 else self._shrink_sustain
        )
        if sustain < self.sustain_s:
            return {"desire": desire, "sustain_s": round(sustain, 3)}
        if (
            self._last_membership_at is not None
            and now - self._last_membership_at < self.dwell_s
        ):
            return {
                "desire": desire, "held": "dwell",
                "since_last_s": round(now - self._last_membership_at, 3),
            }
        feasible = (
            self.actuator.can_grow() if desire > 0
            else self.actuator.can_shrink()
        )
        if not feasible:
            return {"desire": desire, "held": "infeasible"}
        action = "add_host" if desire > 0 else "drain_host"
        if self.mode != "on":
            return {"desire": desire, "would": action}
        hosts_before = self.actuator.hosts()
        if self._events is not None:
            # emitted BEFORE the resize drives so the causal chain on
            # the timeline reads controller_actuation < join_begin/
            # resize_begin < epoch_bump < join_end/resize_end
            self._events.emit(
                "controller_actuation", action=action,
                hosts=hosts_before, reason=proposal.reason,
                pressure=round(proposal.pressure, 4),
            )
        out = (
            self.actuator.add_host() if desire > 0
            else self.actuator.drain_host()
        )
        ok = bool(out and out.get("ok"))
        self._last_membership_at = now
        self._grow_sustain = 0.0
        self._shrink_sustain = 0.0
        with self._lock:
            self._membership_actions[action] += 1
        log.warning(
            "capacity controller %s (%s): hosts %d -> %d%s",
            action, proposal.reason, hosts_before,
            self.actuator.hosts(),
            "" if ok else f" FAILED: {out}",
        )
        return {"desire": desire, "action": action, "ok": ok,
                "hosts": self.actuator.hosts()}

    def _finish(self, decision: dict, proposal: Proposal,
                interlock: bool = False) -> None:
        with self._lock:
            self._ticks += 1
            if interlock:
                self._interlock_holds += 1
            self._last_proposal = proposal
            self._last_reason = proposal.reason
            self._ring.append(decision)
        if self.mode != "on" and (
            decision["would"] or (decision["membership"] or {}).get("would")
        ):
            log.info("capacity controller (observe): %s", decision)

    # -- surfaces ------------------------------------------------------------

    def signal_fields(self) -> dict:
        """The controller tail of ``ControlSignals``: active knob values
        and the last actuation reason, appended at the end of FIELDS so
        the observation vector only grows."""
        cur = self.actuator.read()
        with self._lock:
            reason = self._last_reason
        return {
            "ctl_admission_ceiling": float(
                cur.get("admission_ceiling", 0.0)
            ),
            "ctl_shed_floor": float(cur.get("shed_floor", 0.0)),
            "ctl_chunk_target_ms": float(
                cur.get("chunk_target_ms", 0.0)
            ),
            "ctl_lease_scale": float(cur.get("lease_scale", 0.0)),
            "ctl_last_reason": reason,
        }

    def controller_debug(self) -> dict:
        """The ``controller`` section of ``/debug/stats``."""
        with self._lock:
            ring = list(self._ring)
            last = (
                self._last_proposal.to_dict()
                if self._last_proposal is not None else None
            )
            out = {
                "mode": self.mode,
                "interval_s": self.interval_s,
                "sustain_s": self.sustain_s,
                "dwell_s": self.dwell_s,
                "ticks": self._ticks,
                "interlock_holds": self._interlock_holds,
                "actuations": dict(self._actuations),
                "membership_actions": dict(self._membership_actions),
                "grow_sustain_s": round(self._grow_sustain, 3),
                "shrink_sustain_s": round(self._shrink_sustain, 3),
            }
        out["knobs"] = {
            k: round(v, 4) for k, v in self.actuator.read().items()
        }
        out["specs"] = [s.to_dict() for s in self.actuator.specs()]
        out["hosts"] = self.actuator.hosts()
        out["last_proposal"] = last
        out["decisions"] = ring[-16:]
        return out

    def stats(self) -> dict:
        """Flat counters (library_stats-style)."""
        with self._lock:
            return {
                "ctl_ticks": self._ticks,
                "ctl_interlock_holds": self._interlock_holds,
                "ctl_knob_actuations": sum(self._actuations.values()),
                "ctl_hosts_added":
                    self._membership_actions["add_host"],
                "ctl_hosts_drained":
                    self._membership_actions["drain_host"],
            }

    def poll(self, metrics) -> None:
        """Render-time hook (``PrometheusMetrics.attach_render_hook``):
        refresh the ``ctl_*`` families. Counters sync by delta against
        the internal counts so a render never double-increments."""
        metrics.ctl_mode.set(CTL_MODES.index(self.mode))
        for name, value in self.actuator.read().items():
            metrics.ctl_knob.labels(name).set(value)
        with self._lock:
            holds = self._interlock_holds
            actuations = dict(self._actuations)
            membership = dict(self._membership_actions)
            last = self._last_proposal
            reported = self._reported
        d = holds - reported.get("interlock", 0)
        if d > 0:
            metrics.ctl_interlock_holds.inc(d)
            reported["interlock"] = holds
        for name, count in actuations.items():
            d = count - reported.get(f"knob:{name}", 0)
            if d > 0:
                metrics.ctl_actuations.labels(name).inc(d)
                reported[f"knob:{name}"] = count
        for action, count in membership.items():
            d = count - reported.get(f"member:{action}", 0)
            if d > 0:
                metrics.ctl_membership_actions.labels(action).inc(d)
                reported[f"member:{action}"] = count
        if last is not None:
            metrics.ctl_objective.set(last.objective)
            metrics.ctl_pressure.set(last.pressure)
