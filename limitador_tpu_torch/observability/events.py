"""Typed, sequenced event log.

Counterpart of ``limitador_tpu/observability/events.py``:

* :data:`EVENT_KINDS`: the closed set of typed events, the JAX package's
  whole tuple (a bounded label set: the pod's ``pod_events`` family
  pre-seeds its ``kind`` label from it).
* :class:`PodEventLog`: a bounded, thread-safe ring of monotonically
  sequenced events; emission is a lock and a deque append.
* :func:`merge_events`: the merge of several hosts' logs by
  ``(ts, host, seq)``, which keeps every host's own order.

In the port the ``tier_migration`` events of ``tier/manager.py`` and the
``model_drift`` events of ``observability/model.py`` go to a log handed
to them. ``GET /debug/events``, the ``pod_events`` section and the
``pod_events``/``pod_event_seq`` families belong to the multi-process
pod and come with it (ROADMAP Queue A item 7); a server without a pod
hands its tier manager and model no log, as the JAX server does.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

__all__ = [
    "EVENT_KINDS",
    "PodEventLog",
    "merge_events",
    "METRIC_FAMILIES",
]

#: the event timeline's families, as the JAX package
#: registers them (the analysis gate holds them to
#: observability/metrics.py)
METRIC_FAMILIES = (
    "pod_events",
    "pod_event_seq",
)

#: the closed set of typed pod events: peer health
#: transitions, per-owner breaker transitions, degraded-window
#: boundaries, journal replay boundaries (with delta counts), routing
#: generation bumps, channel re-dials and hedge outcomes.
EVENT_KINDS = (
    "peer_up",
    "peer_suspect",
    "peer_down",
    "breaker_open",
    "breaker_half_open",
    "breaker_closed",
    "degraded_enter",
    "degraded_exit",
    "journal_replay_begin",
    "journal_replay_end",
    "routing_epoch",
    "channel_redial",
    "hedge_fired",
    "hedge_won",
    # serving-model observatory: the residual drift detector
    # confirmed a code/config regression (calibration flat, residuals
    # up) — box phase changes classify as calibration_shift and do NOT
    # emit
    "model_drift",
    # elastic pod: the live-resize state machine. Causal
    # chain per transition: resize_begin < epoch_bump < migrate_begin/
    # migrate_end per moving slice < resize_end (or resize_abort when
    # the transition reverts to the old topology).
    "resize_begin",
    "epoch_bump",
    "migrate_begin",
    "migrate_end",
    "resize_end",
    "resize_abort",
    # tiered storage: one TierManager migration round moved
    # counters between the device hot set and the host cold tier
    # (detail carries promoted/demoted counts, backlog and the
    # model-priced benefit of the round)
    "tier_migration",
    # fast join: a warm standby's promotion into the pod.
    # Causal chain per join: join_begin < epoch_bump < join_end (the
    # drill asserts it on the merged timeline); standby_ready marks
    # the standby's warm-up complete (mesh formed, kernels compiled),
    # plan_seeded one shipped plan-cache seed applied (or discarded
    # stale) on the joiner.
    "join_begin",
    "join_end",
    "standby_ready",
    "plan_seeded",
    # capacity controller: one autoscale/protection action —
    # a membership actuation (detail: action=add_host/drain_host,
    # hosts, reason, pressure; emitted BEFORE the resize drives, so
    # the chain reads controller_actuation < join_begin/resize_begin <
    # epoch_bump < join_end/resize_end) or a shed-floor jump (detail:
    # action=shed_floor, from_floor, to_floor). Routine knob slews do
    # NOT emit — they live in the controller's decision ring. The
    # flight recorder triggers a bundle on this kind.
    "controller_actuation",
)


class PodEventLog:
    """Bounded ring of typed, monotonically sequenced pod events.

    Thread-safe: the lane loop, recovery threads and serving event
    loops all emit. ``seq`` is per-host monotonic (the within-host
    causal order); ``ts`` is stamped non-decreasing per host so the
    pod-wide ``(ts, host, seq)`` merge can never reorder one host's
    events against its own sequence."""

    def __init__(
        self,
        host_id: int = 0,
        capacity: int = 512,
        clock=time.time,
    ):
        self.host_id = int(host_id)
        self.capacity = max(int(capacity), 1)
        self._clock = clock
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._last_ts = 0.0
        self._counts: Dict[str, int] = dict.fromkeys(EVENT_KINDS, 0)

    def emit(self, kind: str, **detail) -> int:
        """Append one event; returns its sequence number. Unknown kinds
        are recorded too (a forward-compatible consumer problem, not an
        emission-time crash) but count under their own key."""
        with self._lock:
            self._seq += 1
            ts = max(float(self._clock()), self._last_ts)
            self._last_ts = ts
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._ring.append({
                "host": self.host_id,
                "seq": self._seq,
                "ts": round(ts, 6),
                "kind": kind,
                **({"detail": detail} if detail else {}),
            })
            return self._seq

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def counts(self) -> Dict[str, int]:
        """Cumulative per-kind emission counts (the ``pod_events``
        family source — counts survive ring eviction)."""
        with self._lock:
            return dict(self._counts)

    def snapshot(
        self, n: Optional[int] = None, kind: Optional[str] = None
    ) -> List[dict]:
        """Oldest-first ring contents; ``n`` trims to the most recent,
        ``kind`` filters."""
        with self._lock:
            items = list(self._ring)
        if kind is not None:
            items = [e for e in items if e["kind"] == kind]
        if n is not None:
            n = max(int(n), 0)
            # explicit: items[-0:] would be the WHOLE ring, not zero
            items = items[-n:] if n else []
        return items

    def events_debug(
        self, n: Optional[int] = None, kind: Optional[str] = None
    ) -> dict:
        """The ``GET /debug/events`` payload."""
        return {
            "host": self.host_id,
            "last_seq": self.last_seq,
            "capacity": self.capacity,
            "counts": self.counts(),
            "events": self.snapshot(n=n, kind=kind),
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


def merge_events(*event_lists: Iterable[dict]) -> List[dict]:
    """Merge per-host event lists into one pod-wide timeline ordered by
    ``(ts, host, seq)``. Within a host ``seq`` is authoritative and the
    per-host non-decreasing ``ts`` stamp guarantees the merge preserves
    it; across hosts wall clocks interleave (they are NTP-close, not
    synchronized — a cross-host tie is broken by host id for
    determinism, not causality)."""
    merged: List[dict] = []
    for events in event_lists:
        merged.extend(events)
    merged.sort(key=lambda e: (
        e.get("ts", 0.0), e.get("host", 0), e.get("seq", 0)
    ))
    return merged
