"""Pod observability plane: the per-hop breakdown of a forwarded
decision and the federated signal view.

Counterpart of ``limitador_tpu/observability/pod_plane.py``, the same
code (numpy, no device):

* :class:`PodHopRecorder` — the per-hop latency breakdown of a
  forwarded decision. The origin measures the whole forward wall clock
  and splits it into :data:`HOP_PHASES`: ``queue`` (serving loop ->
  lane loop handoff), ``serialize`` (payload encode), ``remote_decide``
  (the owner's reported decide time, shipped back in the response) and
  ``wire`` (everything else: channel, retries, hedges, the network).
  Phases accumulate into log2-µs buckets (render-time per-bucket delta
  feed into the ``pod_hop_phase_ms`` Prometheus histogram, as the
  native telemetry plane feeds its families) and each recorded hop is
  offered to the process flight recorder, so a slow forwarded decision
  shows up next to slow local ones, request id and phase split
  included.
* :class:`PodSignalAggregator` — the federated control-signal view.
  Each host's ``ControlSignals`` vector (observability/signals.py, pod
  fields included) is exchanged over the peer lane on the health-probe
  cadence — never on the decision path — and joined here into a pod
  snapshot: per-host columns plus min/max/sum/mean rollups
  (``pod_routed_share``, degraded share, peer health counts), served at
  ``GET /debug/pod`` with its own ring timeline.

Both halves are wired by ``server/peering.py``'s ``PodFrontend``; the
aggregation work runs on the lane loop and render threads only.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "HOP_PHASES",
    "POD_HOP_BUCKETS_MS",
    "PodHopRecorder",
    "PodSignalAggregator",
    "METRIC_FAMILIES",
]

#: Prometheus families owned by this module (cross-checked against the
#: declarations in observability/metrics.py by the analysis registry
#: pass).
METRIC_FAMILIES = (
    "pod_hop_phase_ms",
    "pod_signal_hosts",
    "pod_signal_exchanges",
    "pod_signal_age_s",
    "pod_signal_routed_share",
    "pod_signal_degraded_share",
)

#: the per-hop phases of one forwarded decision, in breakdown order.
#: ``queue + serialize + wire + remote_decide == total`` by
#: construction (wire is the derived remainder, clamped at zero when
#: clocks disagree).
HOP_PHASES = ("queue", "serialize", "wire", "remote_decide")

#: log2-µs bucket count: bucket b holds [2^b, 2^{b+1}) µs, so the span
#: is 1 µs .. ~4.5 min — a forward outlasting that already failed its
#: deadline several times over.
_N_BUCKETS = 28

#: Prometheus bucket edges (milliseconds): the upper edge of each
#: log2-µs bucket, so a drained bucket maps into exactly one histogram
#: bucket and merging is integer adds.
POD_HOP_BUCKETS_MS = tuple(
    2.0 ** (b + 1) / 1e3 for b in range(_N_BUCKETS)
)


def _bucket_of(seconds: float) -> int:
    us = max(seconds * 1e6, 1.0)
    return min(max(int(math.log2(us)), 0), _N_BUCKETS - 1)


class PodHopRecorder:
    """Per-hop breakdown accumulator for forwarded decisions.

    ``record`` runs once per FORWARDED decision (the network already
    dominates that path; the accounting is a lock + four bucket
    increments). ``poll`` is the
    ``PrometheusMetrics.attach_render_hook`` protocol: per-bucket
    deltas against kept baselines feed the ``pod_hop_phase_ms``
    histogram directly, exactly like the native telemetry plane."""

    def __init__(self, host_id: int = 0):
        self.host_id = int(host_id)
        self._lock = threading.Lock()
        self._counts = np.zeros((len(HOP_PHASES), _N_BUCKETS), np.int64)
        self._sums_s = np.zeros(len(HOP_PHASES), np.float64)
        self._base_counts = np.zeros_like(self._counts)
        self._base_sums = np.zeros_like(self._sums_s)
        self.forwards_recorded = 0
        # The process flight recorder (DeviceStatsRecorder.flight or a
        # bare FlightRecorder): forwarded decisions are offered under
        # pod_* phase keys so the slowest-N view spans both planes.
        self._flight = None
        # the always-on sampled-exemplar tap (a
        # flight.FlightRecorder) — forwarded decisions ride the
        # pod_forward lane with their hop phase breakdown attached.
        self.tap = None

    def attach_flight(self, recorder) -> None:
        self._flight = getattr(recorder, "flight", recorder)

    # -- the per-forward record ----------------------------------------------

    def record(
        self,
        request_id: Optional[str],
        owner: int,
        namespace: Optional[str],
        total_s: float,
        phases_s: Dict[str, float],
    ) -> None:
        with self._lock:
            self.forwards_recorded += 1
            for i, phase in enumerate(HOP_PHASES):
                seconds = float(phases_s.get(phase, 0.0))
                self._counts[i, _bucket_of(seconds)] += 1
                self._sums_s[i] += max(seconds, 0.0)
        tap = self.tap
        if tap is not None:
            tap.tap(
                total_s, "pod_forward", request_id=request_id,
                namespace=(
                    None if namespace is None else str(namespace)
                ),
                phases_ms={
                    phase: round(
                        float(phases_s.get(phase, 0.0)) * 1e3, 4
                    )
                    for phase in HOP_PHASES
                },
            )
        flight = self._flight
        if flight is not None and flight.would_admit(total_s):
            flight.offer(total_s, {
                "request_id": request_id,
                "namespace": (
                    None if namespace is None else str(namespace)
                ),
                "batch_id": None,
                "queue_wait_ms": round(
                    float(phases_s.get("queue", 0.0)) * 1e3, 3
                ),
                "phases_ms": {
                    f"pod_{phase}": round(
                        float(phases_s.get(phase, 0.0)) * 1e3, 4
                    )
                    for phase in HOP_PHASES
                },
                "pod_hop": {"owner": int(owner), "host": self.host_id},
            })

    # -- render-time feed ----------------------------------------------------

    def poll(self, metrics) -> None:
        """Feed per-bucket deltas into ``pod_hop_phase_ms{phase}``."""
        hist = getattr(metrics, "pod_hop_phase_ms", None)
        if hist is None:
            return
        with self._lock:
            delta = self._counts - self._base_counts
            if int(delta.sum()) <= 0:
                return
            sums = self._sums_s - self._base_sums
            self._base_counts = self._counts.copy()
            self._base_sums = self._sums_s.copy()
        for i, phase in enumerate(HOP_PHASES):
            child = hist.labels(phase)
            row = delta[i]
            for b in np.nonzero(row)[0].tolist():
                child._buckets[b].inc(int(row[b]))
            child._sum.inc(max(float(sums[i]) * 1e3, 0.0))

    # -- debug surface -------------------------------------------------------

    def hop_debug(self) -> dict:
        """Per-phase count/mean/p50/p99 (ms) from the cumulative
        buckets — the ``pod`` debug section's hop half."""
        with self._lock:
            counts = self._counts.copy()
            sums = self._sums_s.copy()
            forwards = self.forwards_recorded
        out: dict = {"forwards_recorded": forwards}
        phases: dict = {}
        for i, phase in enumerate(HOP_PHASES):
            row = counts[i]
            n = int(row.sum())
            entry: dict = {"count": n}
            if n:
                # float(): np.float64 would break json_response
                entry["mean_ms"] = round(float(sums[i]) / n * 1e3, 4)
                cum = np.cumsum(row)
                for q, name in ((0.5, "p50_ms"), (0.99, "p99_ms")):
                    b = min(
                        int(np.searchsorted(cum, q * n)), _N_BUCKETS - 1
                    )
                    entry[name] = round(2.0 ** (b + 1) / 1e3, 4)
            phases[phase] = entry
        out["phases"] = phases
        return out


#: per-host signal columns older than this are still served (staleness
#: is itself a signal) but drop out of the ``pod_signal_hosts`` count
_FRESH_S = 10.0

#: minimum seconds between timeline appends: the exchange cadence is
#: per-peer, and one rollup per round is plenty
_TIMELINE_MIN_S = 0.25

#: local-column cache lifetime: an exchange round touches every peer
#: (and answers every peer's push) within one probe cadence — building
#: the column ONCE per round keeps the SignalBus snapshot cost (and
#: its ring-timeline appends) independent of pod size
_PAYLOAD_CACHE_S = 0.25

#: the ControlSignals pod fields the rollups and the timeline center on
_POD_FIELDS = (
    "pod_routed_share", "peers_up", "peers_suspect", "peers_down",
    "pod_degraded_share",
    # elastic pod: the sum rollup counts hosts currently
    # inside a membership transition — a resize stuck on one host
    # shows as a persistent nonzero on the pod-wide timeline
    "pod_resize_active",
)


class PodSignalAggregator:
    """Joins per-host ``ControlSignals`` payloads into the pod view.

    ``local_payload`` builds this host's column (the full SignalBus
    snapshot when one is attached, always at least the frontend's pod
    fields); the peer lane exchanges payloads on its probe cadence and
    calls ``ingest`` with each peer's. ``pod_debug`` serves the joined
    snapshot: per-host columns, column ages, min/max/sum/mean rollups
    over every numeric field, and the ring timeline of pod-field
    rollups."""

    def __init__(
        self,
        host_id: int = 0,
        clock=time.time,
        timeline: int = 128,
    ):
        self.host_id = int(host_id)
        self._clock = clock
        self._lock = threading.Lock()
        # peer host -> (payload, received_at)
        self._peers: Dict[int, tuple] = {}
        self._timeline: deque = deque(maxlen=max(int(timeline), 1))
        self._last_timeline = 0.0
        self._payload_cache: Optional[dict] = None
        self._payload_cached_at = 0.0
        self.exchanges = 0
        #: callable() -> ControlSignals (or a dict): the full local
        #: signal snapshot (SignalBus.snapshot when a bus is attached)
        self.local_signals: Optional[Callable] = None
        #: callable() -> dict: the frontend's pod fields (routed share,
        #: peer health counts, degraded share) — always present so the
        #: pod view works without a SignalBus
        self.local_fields: Optional[Callable] = None

    # -- the exchanged payload -----------------------------------------------

    def local_payload(self) -> dict:
        """This host's signal column, as shipped to peers (lane loop /
        debug threads only — never the decision path). Cached for one
        cadence round: a SignalBus snapshot sweeps every source and
        appends to the bus ring, so its cost (and the ring's cadence)
        must not scale with pod size or exchange direction."""
        now = float(self._clock())
        with self._lock:
            cached = self._payload_cache
            if (
                cached is not None
                and now - self._payload_cached_at < _PAYLOAD_CACHE_S
            ):
                return cached
        fields: dict = {}
        sig = self.local_signals
        if sig is not None:
            try:
                snap = sig()
                fields = (
                    snap.to_dict() if hasattr(snap, "to_dict")
                    else dict(snap)
                )
            except Exception:
                fields = {}
        local = self.local_fields
        # the bus snapshot already joins the pod fields (attach_pod);
        # recompute them only when the column lacks them
        if local is not None and "pod_routed_share" not in fields:
            try:
                fields.update(local())
            except Exception:
                pass
        payload = {
            "host": self.host_id,
            "ts": round(now, 3),
            "signals": fields,
        }
        with self._lock:
            self._payload_cache = payload
            self._payload_cached_at = now
        return payload

    def ingest(self, host: int, payload: dict) -> None:
        """One peer's column arrived over the lane (lane loop)."""
        if not isinstance(payload, dict):
            return
        now = float(self._clock())
        with self._lock:
            self._peers[int(host)] = (payload, now)
            self.exchanges += 1
            if now - self._last_timeline >= _TIMELINE_MIN_S:
                self._last_timeline = now
                self._timeline.append(self._tick_locked(now))

    def peer_hosts(self) -> List[int]:
        with self._lock:
            return sorted(self._peers)

    # -- the joined pod view -------------------------------------------------

    def _columns_locked(self, now: float):
        """(columns, ages) including the local host. Caller holds the
        lock; the local column is built WITHOUT it (local_payload reads
        foreign locks)."""
        columns: Dict[str, dict] = {}
        ages: Dict[str, float] = {}
        for host, (payload, received) in self._peers.items():
            columns[str(host)] = dict(payload.get("signals") or {})
            ages[str(host)] = round(max(now - received, 0.0), 3)
        return columns, ages

    @staticmethod
    def _rollup(columns: Dict[str, dict]) -> dict:
        """min/max/sum/mean over every numeric field present in any
        column (strings — top_namespace — are dropped)."""
        acc: Dict[str, List[float]] = {}
        for signals in columns.values():
            for key, value in signals.items():
                if isinstance(value, bool) or not isinstance(
                    value, (int, float)
                ):
                    continue
                acc.setdefault(key, []).append(float(value))
        out = {}
        for key, values in acc.items():
            out[key] = {
                "min": round(min(values), 6),
                "max": round(max(values), 6),
                "sum": round(sum(values), 6),
                "mean": round(sum(values) / len(values), 6),
            }
        return out

    def _tick_locked(self, now: float) -> dict:
        """One timeline entry: the pod-field rollups at ``now`` (peer
        columns only under the lock; the local fields join in
        pod_debug, which is allowed to call out)."""
        columns, _ages = self._columns_locked(now)
        rollups = self._rollup(columns)
        entry = {"ts": round(now, 3), "hosts": 1 + len(columns)}
        for field in _POD_FIELDS:
            roll = rollups.get(field)
            if roll is not None:
                entry[field] = roll["mean"] if field.endswith(
                    "share"
                ) else roll["sum"]
        return entry

    def pod_debug(self) -> dict:
        """The ``GET /debug/pod`` payload."""
        local = self.local_payload()
        now = float(self._clock())
        with self._lock:
            columns, ages = self._columns_locked(now)
            exchanges = self.exchanges
            timeline = list(self._timeline)
        columns[str(self.host_id)] = dict(local.get("signals") or {})
        ages[str(self.host_id)] = 0.0
        return {
            "host": self.host_id,
            "hosts": columns,
            "ages_s": ages,
            "rollups": self._rollup(columns),
            "exchanges": exchanges,
            "timeline": timeline,
        }

    def stats(self) -> dict:
        """The ``pod_signal_*`` family feed (library_stats keys)."""
        now = float(self._clock())
        with self._lock:
            ages = [
                max(now - received, 0.0)
                for _payload, received in self._peers.values()
            ]
            exchanges = self.exchanges
        fields: dict = {}
        local = self.local_fields
        if local is not None:
            try:
                fields = local()
            except Exception:
                fields = {}
        return {
            "pod_signal_hosts": 1 + sum(
                1 for age in ages if age <= _FRESH_S
            ),
            "pod_signal_exchanges": exchanges,
            "pod_signal_age_s": round(max(ages, default=0.0), 3),
            "pod_signal_routed_share": float(
                fields.get("pod_routed_share", 0.0)
            ),
            "pod_signal_degraded_share": float(
                fields.get("pod_degraded_share", 0.0)
            ),
        }
