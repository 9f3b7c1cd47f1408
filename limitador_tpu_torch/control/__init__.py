"""Self-driving capacity: the model-based controller closing the
admission and membership loops.

Port counterpart of ``limitador_tpu/control/``. Four controllers steer
the same p99 budget blind to each other (the AIMD admission limit,
deadline shedding, the ChunkPlanner's EWMA and lease grant sizing), and
pod membership is operator-triggered although live ``join_host`` and
``drain_host`` make topology a cheap actuator. This package is one
control loop over all of them:

* :mod:`actuator`: :class:`KnobSpec` and the typed :class:`Actuator`
  surface (read / apply / membership) every policy talks through, and
  :class:`ServerActuator` binding the live subsystems.
* :mod:`policy`: :class:`ModelPolicy`, the model-based policy: maximize
  predicted throughput x p99-compliance x per-tenant fairness against
  the serving model's fitted coefficients, with rule-based fallbacks
  while the model is in warmup.
* :mod:`controller`: :class:`CapacityController`, the cadence thread
  (inline-tickable for tests) that snapshots the signal bus, asks the
  policy, then actuates under per-knob slew limits, the drift gate,
  membership dwell and hysteresis, and the global "never actuate while
  a resize/join transition is active" interlock.

The controller moves knobs and membership and computes nothing on the
counter table: no kernel of its own. ``--capacity-controller`` defaults
to ``off`` (nothing constructed, and the server does not import this
package); ``observe`` computes and logs every decision without
actuating; ``on`` closes the loops.
"""

from .actuator import KNOBS, Actuator, KnobSpec, ServerActuator
from .controller import CTL_MODES, CapacityController
from .policy import ModelPolicy, Proposal

__all__ = [
    "CTL_MODES",
    "KNOBS",
    "METRIC_FAMILIES",
    "Actuator",
    "CapacityController",
    "KnobSpec",
    "ModelPolicy",
    "Proposal",
    "ServerActuator",
]

#: Prometheus families this subsystem writes (observability/metrics.py
#: declares them on every server)
METRIC_FAMILIES = (
    "ctl_mode",
    "ctl_knob",
    "ctl_actuations",
    "ctl_membership_actions",
    "ctl_interlock_holds",
    "ctl_objective",
    "ctl_pressure",
)
