"""The typed actuation surface between a capacity policy and the
serving subsystems.

Port counterpart of ``limitador_tpu/control/actuator.py``. A policy never
touches a subsystem directly: it reads knob values and writes knob
targets through :class:`Actuator`, and the controller is the only caller
of :meth:`Actuator.apply`. :class:`KnobSpec` carries the bounds, slew
limit and neutral value per knob, so any policy is clamped to the same
safe envelope, and a test can substitute a recording actuator without
constructing any subsystem.

The four knobs plus one membership axis:

==================  ======================================  =========
knob                subsystem surface                        neutral
==================  ======================================  =========
admission_ceiling   ``AdaptiveLimiter.set_ceiling``          hard max
shed_floor          ``AdmissionController.shed_floor``       0
chunk_target_ms     ``ChunkPlanner.retarget`` (all lanes)    2.0
lease_scale         ``LeaseBroker.grant_scale``              1.0
membership          ``PodResizeCoordinator`` join/drain      hold
==================  ======================================  =========

Membership grows promote a warm standby over ``join_host`` when a
standby address is available; shrinks always use ``drain_host`` (the
tail host drains its slices to the survivors).

``planners`` may be a callable returning the live planners: the server
passes one over its batcher pairs, so that a pair bound to a serving
loop after the controller started is retargeted too (the JAX server
binds the pairs that exist when it starts).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["KNOBS", "Actuator", "KnobSpec", "ServerActuator"]


class KnobSpec:
    """One knob's safe envelope: bounds, per-tick slew and neutral.

    ``slew`` is the max relative change per controller tick for
    multiplicative knobs (``additive=False``): the value may move at
    most ``slew * max(|current|, lo)`` per tick. Additive knobs (the
    shed floor, an integer priority level) move at most ``slew``
    absolute per tick."""

    __slots__ = ("name", "lo", "hi", "slew", "neutral", "integer",
                 "additive")

    def __init__(self, name: str, lo: float, hi: float, slew: float,
                 neutral: float, integer: bool = False,
                 additive: bool = False):
        self.name = name
        self.lo = float(lo)
        self.hi = float(hi)
        self.slew = float(slew)
        self.neutral = float(neutral)
        self.integer = bool(integer)
        self.additive = bool(additive)

    def clamp(self, value: float) -> float:
        v = min(max(float(value), self.lo), self.hi)
        return float(int(round(v))) if self.integer else v

    def max_step(self, current: float) -> float:
        """The largest move allowed from ``current`` in one tick."""
        if self.additive:
            return self.slew
        return self.slew * max(abs(float(current)), self.lo, 1e-9)

    def slewed(self, current: float, target: float,
               scale: float = 1.0) -> float:
        """``target`` clamped to the slew envelope around ``current``
        (``scale`` < 1, the drift gate, tightens the envelope)."""
        step = self.max_step(current) * max(float(scale), 0.0)
        lo, hi = float(current) - step, float(current) + step
        return self.clamp(min(max(float(target), lo), hi))

    def to_dict(self) -> dict:
        return {
            "name": self.name, "lo": self.lo, "hi": self.hi,
            "slew": self.slew, "neutral": self.neutral,
            "integer": self.integer, "additive": self.additive,
        }


#: The default knob envelopes. ``admission_ceiling`` bounds are
#: refined per server by :class:`ServerActuator` (hi = the configured
#: --max-inflight hard cap, which the controller may only tighten).
KNOBS = (
    KnobSpec("admission_ceiling", lo=64, hi=4096, slew=0.25,
             neutral=4096, integer=True),
    KnobSpec("shed_floor", lo=0, hi=3, slew=1.0, neutral=0,
             integer=True, additive=True),
    KnobSpec("chunk_target_ms", lo=0.5, hi=8.0, slew=0.25, neutral=2.0),
    KnobSpec("lease_scale", lo=0.25, hi=4.0, slew=0.25, neutral=1.0),
)


class Actuator:
    """The surface a capacity policy actuates through. Implementations
    expose only the knobs whose subsystems exist (``specs()`` is the
    contract); membership methods are no-ops returning ``None`` when
    no resize coordinator is bound."""

    def specs(self) -> Tuple[KnobSpec, ...]:
        raise NotImplementedError

    def read(self) -> Dict[str, float]:
        """Live value of every knob in ``specs()``."""
        raise NotImplementedError

    def apply(self, name: str, value: float) -> float:
        """Write one knob (already slew-limited by the controller);
        returns the value actually applied after subsystem clamps."""
        raise NotImplementedError

    # -- membership axis -----------------------------------------------------

    def hosts(self) -> int:
        return 0

    def transition_active(self) -> bool:
        """True while a resize/join transition is in flight: the
        controller's global actuation interlock."""
        return False

    def can_grow(self) -> bool:
        return False

    def can_shrink(self) -> bool:
        return False

    def add_host(self) -> Optional[dict]:
        return None

    def drain_host(self) -> Optional[dict]:
        return None


class ServerActuator(Actuator):
    """Binds the live subsystems. Every constructor argument is
    optional: a missing subsystem drops its knob from ``specs()`` (a
    server without leases gets no lease knob; a server without a pod
    gets no membership axis)."""

    def __init__(
        self,
        overload=None,           # admission.overload.AdaptiveLimiter
        admission=None,          # admission.AdmissionController
        planners=(),             # device.batcher.ChunkPlanner instances
        broker=None,             # lease.broker.LeaseBroker
        coordinator=None,        # server.resize.PodResizeCoordinator
        standby_addresses=(),    # warm-standby peer-lane addresses
        min_hosts: int = 1,
        max_hosts: int = 8,
    ):
        self._overload = overload
        self._admission = admission
        if not callable(planners):
            planners = (lambda fixed=tuple(planners): fixed)
        self._planner_source = planners
        self._broker = broker
        self._coordinator = coordinator
        self._standbys: List[str] = [str(a) for a in standby_addresses
                                     if a]
        self.min_hosts = max(int(min_hosts), 1)
        self.max_hosts = max(int(max_hosts), self.min_hosts)
        self._lock = threading.Lock()  # guards the standby pool
        specs = []
        if overload is not None:
            hard = float(getattr(overload, "hard_max", overload.max_inflight))
            specs.append(KnobSpec(
                "admission_ceiling",
                lo=min(64.0, hard), hi=hard, slew=0.25, neutral=hard,
                integer=True,
            ))
        if admission is not None:
            specs.append(KnobSpec(
                "shed_floor", lo=0, hi=3, slew=1.0, neutral=0,
                integer=True, additive=True,
            ))
        planners_now = self._planners()
        if planners_now:
            specs.append(KnobSpec(
                "chunk_target_ms", lo=0.5, hi=8.0, slew=0.25,
                neutral=planners_now[0].target_s * 1e3,
            ))
        if broker is not None:
            specs.append(KnobSpec(
                "lease_scale", lo=0.25, hi=4.0, slew=0.25, neutral=1.0,
            ))
        self._specs = tuple(specs)

    def _planners(self) -> list:
        return [p for p in self._planner_source() if p is not None]

    def specs(self) -> Tuple[KnobSpec, ...]:
        return self._specs

    def read(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self._overload is not None:
            out["admission_ceiling"] = float(self._overload.max_inflight)
        if self._admission is not None:
            out["shed_floor"] = float(self._admission.shed_floor)
        planners = self._planners()
        if planners:
            out["chunk_target_ms"] = float(planners[0].target_s * 1e3)
        if self._broker is not None:
            out["lease_scale"] = float(self._broker.grant_scale)
        return out

    def apply(self, name: str, value: float) -> float:
        if name == "admission_ceiling" and self._overload is not None:
            return float(self._overload.set_ceiling(int(value)))
        if name == "shed_floor" and self._admission is not None:
            floor = max(0, min(int(value), 3))
            self._admission.shed_floor = floor
            return float(floor)
        planners = self._planners() if name == "chunk_target_ms" else ()
        if planners:
            applied = 0.0
            for planner in planners:
                applied = planner.retarget(float(value) / 1e3) * 1e3
            return applied
        if name == "lease_scale" and self._broker is not None:
            scale = min(max(float(value), 0.25), 4.0)
            self._broker.grant_scale = scale
            return scale
        return float(value)  # unknown knob: inert (policy bug, not a crash)

    # -- membership axis -----------------------------------------------------

    def hosts(self) -> int:
        coord = self._coordinator
        if coord is None:
            return 0
        return int(coord.router.topology.hosts)

    def transition_active(self) -> bool:
        coord = self._coordinator
        return bool(coord is not None and coord.busy)

    def can_grow(self) -> bool:
        with self._lock:
            has_standby = bool(self._standbys)
        return (
            self._coordinator is not None
            and has_standby
            and self.hosts() < self.max_hosts
        )

    def can_shrink(self) -> bool:
        return (
            self._coordinator is not None
            and self.hosts() > self.min_hosts
        )

    def add_host(self) -> Optional[dict]:
        """Grow by one: promote the next warm standby over the join
        path. The address is only consumed on success: a failed join
        returns it to the pool so the next tick can retry."""
        coord = self._coordinator
        with self._lock:
            if coord is None or not self._standbys:
                return None
            address = self._standbys.pop(0)
        try:
            out = coord.join_host(address)
        except Exception as exc:
            with self._lock:
                self._standbys.insert(0, address)
            return {"ok": False, "error": str(exc), "address": address}
        if not out.get("ok"):
            with self._lock:
                self._standbys.insert(0, address)
        return out

    def drain_host(self) -> Optional[dict]:
        """Shrink by one: the tail host drains its slices to the
        survivors. Its address returns to the standby pool: the drained
        process keeps serving its lane, so a later grow can re-join it
        warm."""
        coord = self._coordinator
        if coord is None:
            return None
        hosts = self.hosts()
        address = coord._peers.get(hosts - 1)
        try:
            out = coord.drain_host()
        except Exception as exc:
            return {"ok": False, "error": str(exc)}
        if out.get("ok") and address:
            with self._lock:
                self._standbys.append(address)
        return out

    def standby_pool(self) -> List[str]:
        with self._lock:
            return list(self._standbys)
