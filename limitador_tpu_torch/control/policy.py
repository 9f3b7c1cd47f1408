"""The first capacity policy: model-based joint optimization.

Port counterpart of ``limitador_tpu/control/policy.py``, in the same
plain float arithmetic, so that both packages propose equal targets and
objectives from equal snapshots. ``ModelPolicy`` proposes one operating
point per tick: a desired value per knob plus a membership direction,
chosen to maximize

    J = predicted_throughput x p99_compliance x fairness

against the serving model: ``predicted_throughput`` and the p99
forecast come from ``ServingModelEstimator.what_if`` (the fitted
latency/throughput coefficients), ``p99_compliance`` is
``min(1, budget / predicted_p99)``, and ``fairness`` discounts the
objective by the priority-weighted shed rate (shedding critical
traffic costs 8x what shedding low does).

While the model is in warmup (R^2 = 0, headroom unknown) every term
falls back to a rule driven by the raw signals (queue-wait ratio and
SLO burn), so a cold server is steered conservatively rather than not
at all. The policy only proposes: the controller owns slew limits,
the drift gate, membership dwell/hysteresis and the interlock.

The surface is ``propose(snapshot, estimator, current, specs) ->
Proposal``: the observation is ``ControlSignals``, the action space the
knob targets plus a membership direction.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

__all__ = ["ModelPolicy", "Proposal"]

#: fairness weights per priority class (low..critical): the objective
#: discount for one shed/second of each class.
_FAIRNESS_WEIGHTS = (1.0, 2.0, 4.0, 8.0)

_PRIORITY_ORDER = ("low", "normal", "high", "critical")


class Proposal:
    """One tick's proposed operating point.

    ``targets`` — desired value per knob (pre-slew; the controller
    clamps). ``membership`` — desired direction: +1 grow, -1 shrink,
    0 hold. ``reason`` — the dominant driver, for the decision log and
    the ``ctl_last_reason`` signal field. ``objective`` — J evaluated
    at the proposed point (0.0 while the model is in warmup).
    ``pressure`` — the scalar overload signal the membership bands
    compare against."""

    __slots__ = ("targets", "membership", "reason", "objective",
                 "pressure", "terms")

    def __init__(self, targets: Dict[str, float], membership: int = 0,
                 reason: str = "steady", objective: float = 0.0,
                 pressure: float = 0.0,
                 terms: Optional[dict] = None):
        self.targets = dict(targets)
        self.membership = int(membership)
        self.reason = reason
        self.objective = float(objective)
        self.pressure = float(pressure)
        self.terms = dict(terms or {})

    def to_dict(self) -> dict:
        return {
            "targets": {k: round(v, 4) for k, v in self.targets.items()},
            "membership": self.membership,
            "reason": self.reason,
            "objective": round(self.objective, 4),
            "pressure": round(self.pressure, 4),
            "terms": self.terms,
        }


class ModelPolicy:
    def __init__(
        self,
        budget_ms: float = 2.0,
        grow_headroom: float = 1.2,
        shrink_headroom: float = 3.0,
        idle_pressure: float = 0.05,
        ceiling_margin: float = 1.5,
    ):
        #: the p99 budget compliance is judged against (the estimator's
        #: own budget when one is attached overrides this default)
        self.budget_ms = float(budget_ms)
        #: membership hysteresis bands on capacity headroom: sustained
        #: headroom BELOW grow_headroom proposes +1, sustained headroom
        #: ABOVE shrink_headroom proposes -1; the dead band between
        #: them absorbs diurnal ramps.
        self.grow_headroom = float(grow_headroom)
        self.shrink_headroom = float(shrink_headroom)
        #: warmup fallback: pressure below this proposes shrink,
        #: pressure >= 1.0 proposes grow.
        self.idle_pressure = float(idle_pressure)
        #: admission ceiling target = sustainable concurrency ×
        #: this margin (Little's law headroom for burst absorption)
        self.ceiling_margin = float(ceiling_margin)

    # -- signal digestion ----------------------------------------------------

    def _budget(self, estimator) -> float:
        if estimator is not None:
            try:
                return float(estimator.budget_ms)
            except Exception:
                pass
        return self.budget_ms

    def _pressure(self, snap, budget_ms: float) -> Tuple[float, dict]:
        """One scalar overload signal in [0, inf): 1.0 = at capacity.
        The max of SLO burn, queue-wait/budget, and inverse model
        headroom — whichever subsystem sees saturation first wins."""
        burn = max(float(snap.slo_burn_5m), 0.0)
        queue_ratio = (
            float(snap.queue_wait_ms) / budget_ms if budget_ms > 0
            else 0.0
        )
        headroom = float(snap.capacity_headroom_ratio)
        inv_headroom = 1.0 / headroom if headroom > 0 else 0.0
        terms = {
            "burn": round(burn, 4),
            "queue_ratio": round(queue_ratio, 4),
            "headroom": round(headroom, 4),
        }
        return max(burn, queue_ratio, inv_headroom), terms

    def _fairness(self, snap) -> float:
        """1 / (1 + priority-weighted shed rate): shedding at all
        discounts the objective, shedding high classes discounts it
        hardest."""
        weighted = 0.0
        for i, pname in enumerate(_PRIORITY_ORDER):
            weighted += _FAIRNESS_WEIGHTS[i] * float(
                snap.shed_rate_by_priority.get(pname, 0.0)
            )
        return 1.0 / (1.0 + weighted)

    def _model_view(self, snap, estimator) -> Optional[dict]:
        """The fitted forecast at the current operating point, or None
        while the model can't be trusted (absent / warmup / R² = 0)."""
        if estimator is None or float(snap.model_r2) <= 0.0:
            return None
        try:
            view = estimator.what_if()
        except Exception:
            return None
        if not view or not view.get("max_decisions_per_sec"):
            return None
        return view

    def objective(self, snap, rate: float, p99_ms: float,
                  budget_ms: float) -> float:
        """J = rate × min(1, budget/p99) × fairness."""
        compliance = (
            min(1.0, budget_ms / p99_ms) if p99_ms > 0 else 1.0
        )
        return float(rate) * compliance * self._fairness(snap)

    # -- the proposal --------------------------------------------------------

    def propose(self, snap, estimator, current: Dict[str, float],
                specs) -> Proposal:
        budget_ms = self._budget(estimator)
        pressure, terms = self._pressure(snap, budget_ms)
        view = self._model_view(snap, estimator)
        by_name = {spec.name: spec for spec in specs}
        targets: Dict[str, float] = {}

        if "admission_ceiling" in by_name:
            targets["admission_ceiling"] = self._ceiling_target(
                snap, view, by_name["admission_ceiling"],
                current.get("admission_ceiling", 0.0),
                pressure, budget_ms,
            )
        if "shed_floor" in by_name:
            targets["shed_floor"] = self._shed_floor_target(
                snap, current.get("shed_floor", 0.0)
            )
        if "chunk_target_ms" in by_name:
            targets["chunk_target_ms"] = self._chunk_target(
                snap, by_name["chunk_target_ms"], pressure, budget_ms
            )
        if "lease_scale" in by_name:
            targets["lease_scale"] = self._lease_target(
                snap, by_name["lease_scale"], pressure
            )

        membership, reason = self._membership(snap, pressure, terms)
        objective = 0.0
        if view is not None:
            objective = self.objective(
                snap,
                float(view.get("predicted_decisions_per_sec", 0.0)),
                float(view.get("predicted_latency_ms", 0.0)),
                budget_ms,
            )
        return Proposal(
            targets, membership=membership, reason=reason,
            objective=objective, pressure=pressure, terms=terms,
        )

    # -- per-knob desired values ---------------------------------------------

    def _ceiling_target(self, snap, view, spec, current, pressure,
                        budget_ms) -> float:
        if view is not None:
            # Little's law: sustainable in-flight = rate × latency
            # budget; the margin leaves burst headroom. The fitted
            # max rate already reflects the box (calibration-normed).
            max_rate = float(view.get("max_decisions_per_sec", 0.0))
            little = max_rate * (budget_ms / 1e3) * self.ceiling_margin
            target = little if little > 0 else spec.neutral
            if float(snap.slo_burn_5m) >= 1.0:
                # burning the SLO overrides the forecast: tighten
                target = min(target, current * 0.75)
            return spec.clamp(target)
        # warmup rules: queue eating the budget -> tighten; calm and
        # no burn -> relax toward the hard max.
        if pressure >= 1.0:
            return spec.clamp(current * 0.75)
        if pressure <= 0.5:
            return spec.clamp(current * 1.25)
        return spec.clamp(current)

    def _shed_floor_target(self, snap, current) -> float:
        burn = float(snap.slo_burn_5m)
        if burn >= 1.0 or int(snap.slo_breached):
            return min(current + 1.0, 3.0)  # shed the next class up
        if burn <= 0.25:
            return max(current - 1.0, 0.0)  # recover toward shed-nothing
        return current

    def _chunk_target(self, snap, spec, pressure, budget_ms) -> float:
        # Queueing has eaten the budget: tighten the device slice so
        # decisions start flowing (the ChunkPlanner halves internally
        # too — this moves the baseline the halving applies to). Calm:
        # a full-budget slice minimizes launch count.
        if pressure >= 1.0:
            return spec.clamp(budget_ms / 2.0)
        if pressure <= 0.5:
            return spec.clamp(budget_ms)
        return spec.clamp(spec.neutral)

    def _lease_target(self, snap, spec, pressure) -> float:
        if int(snap.near_exhaustion) > 0:
            # tenants near their limit: leased headroom trades
            # exactness exactly where it hurts — shrink grants
            return spec.clamp(0.5)
        if pressure >= 1.0:
            # saturated: bigger grants amortize more device work into
            # the native lease lane
            return spec.clamp(2.0)
        return spec.clamp(spec.neutral)

    # -- membership direction ------------------------------------------------

    def _membership(self, snap, pressure, terms) -> Tuple[int, str]:
        headroom = float(snap.capacity_headroom_ratio)
        if headroom > 0:
            # model-known bands (the controller adds dwell + sustain)
            if headroom < self.grow_headroom:
                return 1, "headroom_burn"
            if headroom > self.shrink_headroom:
                return -1, "headroom_idle"
        else:
            # warmup fallback: the raw pressure signal
            if pressure >= 1.0:
                return 1, "pressure_burn"
            if pressure <= self.idle_pressure:
                return -1, "pressure_idle"
        if pressure >= 1.0:
            return 0, "slo_burn" if terms["burn"] >= 1.0 else "queue_wait"
        return 0, "steady"
