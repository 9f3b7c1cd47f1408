"""Admission plane: overload control, priority shedding, device failover.

Port counterpart of ``limitador_tpu/admission/``. The decision-path
guardian between the serving plane (gRPC/HTTP handlers) and the storage
with its table on the card. Three cooperating pieces:

* :mod:`breaker`: a device-plane health monitor + circuit breaker
  (closed/open/half-open) fed by batch outcomes and a stalled-batch
  watch. On trip the check path fails over to the exact host oracle
  (:mod:`limitador_tpu_torch.storage.failover`); on recovery the
  host-journaled deltas reconcile back into the card's table through the
  storage's ``apply_deltas``.
* :mod:`overload`: an AIMD adaptive concurrency limit driven by the
  queue-wait signal of the device-plane recorder, plus a queue-wait
  estimate for deadline-aware shedding: a request whose gRPC deadline
  cannot survive the current queue wait is rejected before it occupies a
  batch slot.
* :mod:`priority`: request priority classes resolved from descriptor
  entries and limits-file annotations, so sheds take low-priority traffic
  first.

:class:`AdmissionController` (:mod:`controller`) ties them together and
is what the serving plane talks to. The server imports this package only
when ``--admission-mode`` is not ``off``.
"""

from .breaker import BreakerState, CircuitBreaker
from .controller import AdmissionController, AdmissionShed
from .overload import AdaptiveLimiter
from .priority import (
    DEFAULT_PRIORITY,
    PRIORITIES,
    PriorityResolver,
    priority_level,
)

__all__ = [
    "ADMISSION_MODES",
    "METRIC_FAMILIES",
    "SHED_REASONS",
    "AdmissionController",
    "AdmissionShed",
    "AdaptiveLimiter",
    "BreakerState",
    "CircuitBreaker",
    "DEFAULT_PRIORITY",
    "PRIORITIES",
    "PriorityResolver",
    "priority_level",
]

#: --admission-mode values: off = plane not constructed; monitor =
#: breaker/failover active, sheds COUNTED but not enforced; enforce =
#: sheds enforced too.
ADMISSION_MODES = ("off", "monitor", "enforce")

#: Why a request was shed before batch admission. ``controller`` = the
#: controller's shed floor put this request's priority class below the
#: line.
SHED_REASONS = ("deadline", "overload", "controller")

#: Prometheus families this plane writes (declared in
#: observability/metrics.py; tests pin the two in sync)
METRIC_FAMILIES = (
    "admission_inflight",
    "admission_limit",
    "admission_sheds",
    "admission_breaker_state",
    "admission_breaker_transitions",
    "admission_failover_decisions",
    "admission_failover_seconds",
    "admission_reconciled_deltas",
)
