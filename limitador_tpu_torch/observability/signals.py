"""Control-signal bus: one timestamped observation vector.

Counterpart of ``limitador_tpu/observability/signals.py``.
:class:`ControlSignals` joins the signals the planes compute (the check
batcher's queue wait and fill, the admission breaker and shed rates,
lease outstanding tokens, the native phases' p99s, SLO burn, the box
calibration score, ``device_backed``, the usage observatory's pressure,
the pod's and the serving model's fields and the capacity controller's
knobs) into one snapshot with the JAX fields, defaults and ``vector()``
order. :class:`SignalBus` owns the sources, computes snapshots on
demand, keeps a ring-buffered timeline (``GET /debug/signals`` serves
both) and exports every scalar as a ``signal_*`` Prometheus family at
render time.

Sources attach getattr-style and every field keeps its neutral default
while its source is absent. The port's server attaches the recorder, the
native pipeline, the native plane, the usage observatory, the serving
model and, with ``--admission-mode`` monitor or enforce, the admission
controller (``breaker_state``, ``shed_rate_by_priority``);
``attach_pod`` and ``attach_controller`` have no caller until the pod and
the capacity controller are ported (ROADMAP Queue A items 7 and 8), so
their fields hold the JAX defaults, as on a JAX server without those
planes.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "ControlSignals",
    "SignalBus",
    "METRIC_FAMILIES",
    "box_calibration_score",
]

#: Prometheus families owned by this module (declared in metrics.py)
METRIC_FAMILIES = (
    "signal_queue_wait_ms",
    "signal_batch_fill",
    "signal_breaker_state",
    "signal_shed_rate",
    "signal_lease_outstanding_tokens",
    "signal_native_p99_us",
    "signal_slo_burn_5m",
    "signal_box_calibration",
    "signal_device_backed",
)

#: priority classes, in the admission plane's order (inlined so a
#: host-only server never imports the admission package for a schema;
#: tests pin the two in sync)
_PRIORITIES = ("low", "normal", "high", "critical")

#: native phases, in the JAX ``native_plane.PHASES`` order (the native
#: plane's ``PHASES``; ``h2i_respond`` is the native ingress's coded
#: respond, 0.0 on a server without ``--native-ingress``)
_PHASES = ("hot_lookup", "hot_stage", "lease_hit", "hot_finish",
           "h2i_respond")


#: the admission breaker's gauge encoding, by state (inlined so that a
#: host-only server never imports the admission package for a schema;
#: ``admission.BreakerState.GAUGE``, tests pin the two in sync)
_BREAKER_GAUGE = {"closed": 0, "half_open": 1, "open": 2}


_BOX_CALIBRATION: Optional[float] = None
_BOX_LOCK = threading.Lock()


def box_calibration_score(cached: bool = True) -> float:
    """The JAX bench's fixed spin+memcpy box score (``bench.py``
    ``box_calibration_score``), computed in-process so that signal
    snapshots carry the normalizer bench rows carry. Same constants on
    purpose: the scores must be comparable.
    ~100-400 ms once; cached for the process (SignalBus computes it on a
    background thread at start so no snapshot ever pays it inline)."""
    global _BOX_CALIBRATION
    if cached and _BOX_CALIBRATION is not None:
        return _BOX_CALIBRATION
    with _BOX_LOCK:
        if cached and _BOX_CALIBRATION is not None:
            return _BOX_CALIBRATION
        src = bytes(4 << 20)
        dst = bytearray(4 << 20)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            acc = 0
            for i in range(200_000):  # fixed Python-interpreter spin
                acc += i ^ (acc & 0xFF)
            for _ in range(24):  # 96 MB of memcpy
                dst[:] = src
            best = min(best, time.perf_counter() - t0)
        _BOX_CALIBRATION = round(1.0 / best, 3)
    return _BOX_CALIBRATION


class ControlSignals:
    """One timestamped observation vector. Every field is always
    present; a field whose source is absent holds its neutral default
    (0/0.0/empty map, ``device_backed`` -1 for unknown) so consumers
    never branch on schema."""

    FIELDS = (
        "ts",
        "queue_wait_ms",
        "batch_fill",
        "breaker_state",
        "shed_rate_by_priority",
        "lease_outstanding_tokens",
        "native_phase_p99_us",
        "slo_burn_5m",
        "slo_burn_1h",
        "slo_breached",
        "box_calibration_score",
        "device_backed",
        "top_namespace",
        "near_exhaustion",
        # pod fields, appended at the END so that the controller's
        # observation vector only ever grows; the order must not
        # reshuffle.
        "pod_routed_share",
        "peers_up",
        "peers_suspect",
        "peers_down",
        "pod_degraded_share",
        # serving-model tail, same append-only contract: a controller
        # consumes these as pure observations.
        "model_r2",
        "capacity_headroom_ratio",
        "model_drift",
        # capacity-controller tail — the active knob values
        # + last actuation reason, appended at the END so the
        # observation vector only ever grows.
        "ctl_admission_ceiling",
        "ctl_shed_floor",
        "ctl_chunk_target_ms",
        "ctl_lease_scale",
        "ctl_last_reason",
    )

    __slots__ = FIELDS

    def __init__(self, **kw):
        self.ts = kw.get("ts", 0.0)
        self.queue_wait_ms = kw.get("queue_wait_ms", 0.0)
        self.batch_fill = kw.get("batch_fill", 0.0)
        self.breaker_state = kw.get("breaker_state", 0)
        self.shed_rate_by_priority = kw.get(
            "shed_rate_by_priority"
        ) or {p: 0.0 for p in _PRIORITIES}
        self.lease_outstanding_tokens = kw.get(
            "lease_outstanding_tokens", 0
        )
        self.native_phase_p99_us = kw.get(
            "native_phase_p99_us"
        ) or {p: 0.0 for p in _PHASES}
        self.slo_burn_5m = kw.get("slo_burn_5m", 0.0)
        self.slo_burn_1h = kw.get("slo_burn_1h", 0.0)
        self.slo_breached = kw.get("slo_breached", 0)
        self.box_calibration_score = kw.get("box_calibration_score", 0.0)
        self.device_backed = kw.get("device_backed", -1)
        self.top_namespace = kw.get("top_namespace", "")
        self.near_exhaustion = kw.get("near_exhaustion", 0)
        self.pod_routed_share = kw.get("pod_routed_share", 0.0)
        self.peers_up = kw.get("peers_up", 0)
        self.peers_suspect = kw.get("peers_suspect", 0)
        self.peers_down = kw.get("peers_down", 0)
        self.pod_degraded_share = kw.get("pod_degraded_share", 0.0)
        self.model_r2 = kw.get("model_r2", 0.0)
        self.capacity_headroom_ratio = kw.get(
            "capacity_headroom_ratio", 0.0
        )
        self.model_drift = kw.get("model_drift", 0)
        self.ctl_admission_ceiling = kw.get("ctl_admission_ceiling", 0.0)
        self.ctl_shed_floor = kw.get("ctl_shed_floor", 0.0)
        self.ctl_chunk_target_ms = kw.get("ctl_chunk_target_ms", 0.0)
        self.ctl_lease_scale = kw.get("ctl_lease_scale", 0.0)
        self.ctl_last_reason = kw.get("ctl_last_reason", "")

    def to_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}

    def vector(self) -> List[float]:
        """Fixed-order numeric flattening — the adaptive controller's
        observation. Maps expand in declaration order (_PRIORITIES,
        _PHASES); strings are dropped."""
        out = [
            float(self.ts),
            float(self.queue_wait_ms),
            float(self.batch_fill),
            float(self.breaker_state),
        ]
        out.extend(
            float(self.shed_rate_by_priority.get(p, 0.0))
            for p in _PRIORITIES
        )
        out.append(float(self.lease_outstanding_tokens))
        out.extend(
            float(self.native_phase_p99_us.get(p, 0.0)) for p in _PHASES
        )
        out.extend([
            float(self.slo_burn_5m),
            float(self.slo_burn_1h),
            float(self.slo_breached),
            float(self.box_calibration_score),
            float(self.device_backed),
            float(self.near_exhaustion),
            # pod tail: appended, never reordered — the
            # controller's input shape only grows.
            float(self.pod_routed_share),
            float(self.peers_up),
            float(self.peers_suspect),
            float(self.peers_down),
            float(self.pod_degraded_share),
            # serving-model tail: same append-only contract.
            float(self.model_r2),
            float(self.capacity_headroom_ratio),
            float(self.model_drift),
            # capacity-controller tail: the active knob
            # values; ctl_last_reason is a string and drops here like
            # top_namespace does.
            float(self.ctl_admission_ceiling),
            float(self.ctl_shed_floor),
            float(self.ctl_chunk_target_ms),
            float(self.ctl_lease_scale),
        ])
        return out


class SignalBus:
    """Joins the attached sources into :class:`ControlSignals`
    snapshots and keeps a bounded timeline.

    Attach points (all optional; each enriches the snapshot):

    * ``attach_recorder`` — a DeviceStatsRecorder: per-flush queue-wait
      / batch-fill EWMAs (``signal_queue_wait_s`` taps fed by
      ``record_flush``).
    * ``attach_admission`` — the AdmissionController: breaker state and
      the per-priority shed counters the rates derive from.
    * ``attach_pipeline`` — a NativeRlsPipeline: lease outstanding
      tokens via ``library_stats``.
    * ``attach_native_plane`` — the NativePlane: per-phase p99s + SLO
      burn + runtime ``device_backed``.
    * ``attach_observatory`` — the TenantUsageObservatory: hottest
      namespace + near-exhaustion count.

    ``snapshot()`` computes a fresh vector and appends it to the ring;
    the usage observatory's drain thread ticks it so the timeline has a
    steady cadence even when nobody scrapes. Shed RATES are per-second
    deltas between consecutive snapshots (counters are cumulative)."""

    #: minimum wall-time between shed-rate baselines (seconds)
    MIN_RATE_WINDOW_S = 0.5

    def __init__(self, timeline: int = 256, clock=time.time):
        self._clock = clock
        self._ring: deque = deque(maxlen=max(int(timeline), 1))
        self._lock = threading.Lock()
        self._recorder = None
        self._admission = None
        self._pipeline = None
        self._native_plane = None
        self._observatory = None
        self._pod = None
        self._model = None
        self._controller = None
        # previous cumulative shed counts + timestamp, for the rates;
        # baselines only advance once per MIN_RATE_WINDOW_S so the four
        # independent snapshot triggers (drain tick, renders, the two
        # debug endpoints) can't shrink the window to milliseconds and
        # quantize the rate into 0-or-spike noise — snapshots inside
        # the window reuse the last computed rates.
        self._prev_sheds: Dict[str, int] = {}
        self._prev_ts: Optional[float] = None
        self._last_rates: Dict[str, float] = {p: 0.0 for p in _PRIORITIES}

    # -- attachment ----------------------------------------------------------

    def attach_recorder(self, recorder) -> None:
        self._recorder = recorder

    def attach_admission(self, admission) -> None:
        self._admission = admission

    def attach_pipeline(self, pipeline) -> None:
        self._pipeline = pipeline

    def attach_native_plane(self, plane) -> None:
        self._native_plane = plane

    def attach_observatory(self, observatory) -> None:
        self._observatory = observatory

    def attach_pod(self, pod) -> None:
        """Attach the pod frontend (or anything exposing
        ``pod_signal_fields() -> dict``): routed share, peer health
        counts and degraded share join every snapshot —
        the controller's observation matches the unit of serving."""
        self._pod = pod

    def attach_model(self, model) -> None:
        """Attach the serving-model estimator (or anything exposing
        ``signal_fields() -> dict``): the fitted R², capacity headroom
        and drift bit join every snapshot — the tail
        direction 4's controller consumes without touching the fit."""
        self._model = model

    def attach_controller(self, controller) -> None:
        """Attach the capacity controller (or anything exposing
        ``signal_fields() -> dict``): active knob values + last
        actuation reason join every snapshot — the
        controller's ACTIONS become part of the observation a future
        policy (or an operator) learns from."""
        self._controller = controller

    def warm(self) -> None:
        """Pre-compute the box calibration score off-thread so the
        first snapshot doesn't pay the ~100-400 ms probe inline."""
        threading.Thread(
            target=box_calibration_score, daemon=True,
            name="signal-calibration",
        ).start()

    # -- snapshot ------------------------------------------------------------

    def snapshot(self) -> ControlSignals:
        """Compute one ControlSignals vector from the live sources and
        append it to the timeline. Every source read is exception-
        guarded: a failing subsystem costs its field, never the bus."""
        now = self._clock()
        kw: dict = {"ts": round(now, 3)}
        rec = self._recorder
        if rec is not None:
            kw["queue_wait_ms"] = round(
                getattr(rec, "signal_queue_wait_s", 0.0) * 1e3, 4
            )
            kw["batch_fill"] = round(
                getattr(rec, "signal_batch_fill", 0.0), 4
            )
        adm = self._admission
        sheds: Dict[str, int] = {}
        if adm is not None:
            try:
                kw["breaker_state"] = _BREAKER_GAUGE[adm.breaker.state]
                with adm._shed_lock:
                    for (_reason, pname), count in adm._shed_counts.items():
                        sheds[pname] = sheds.get(pname, 0) + count
            except Exception:
                pass
        pipe = self._pipeline
        if pipe is not None:
            try:
                kw["lease_outstanding_tokens"] = int(
                    pipe.library_stats().get("lease_outstanding_tokens", 0)
                )
            except Exception:
                pass
        plane = self._native_plane
        if plane is not None:
            try:
                tel = plane.native_telemetry()
                kw["native_phase_p99_us"] = {
                    phase: float(tel.get(phase, {}).get("p99_us", 0.0))
                    for phase in _PHASES
                }
                slo = plane.slo_status()
                kw["slo_burn_5m"] = slo.get("burn_rate_5m", 0.0)
                kw["slo_burn_1h"] = slo.get("burn_rate_1h", 0.0)
                kw["slo_breached"] = 1 if slo.get("breached") else 0
                backed = plane.device_backed()
                if backed is not None:
                    kw["device_backed"] = 1 if backed else 0
            except Exception:
                pass
        obs = self._observatory
        if obs is not None:
            try:
                pressure = obs.pressure()
                kw["top_namespace"] = pressure.get("top_namespace", "")
                kw["near_exhaustion"] = int(
                    pressure.get("near_exhaustion", 0)
                )
            except Exception:
                pass
        pod = self._pod
        if pod is not None:
            try:
                kw.update(pod.pod_signal_fields())
            except Exception:
                pass
        model = self._model
        if model is not None:
            try:
                kw.update(model.signal_fields())
            except Exception:
                pass
        controller = self._controller
        if controller is not None:
            try:
                kw.update(controller.signal_fields())
            except Exception:
                pass
        if _BOX_CALIBRATION is not None:
            kw["box_calibration_score"] = _BOX_CALIBRATION
        with self._lock:
            # per-priority shed rates: cumulative-count deltas over at
            # least MIN_RATE_WINDOW_S of wall time; in-window snapshots
            # reuse the last computed rates instead of re-baselining.
            if self._prev_ts is None:
                self._prev_sheds = dict(sheds)
                self._prev_ts = now
            elif now - self._prev_ts >= self.MIN_RATE_WINDOW_S:
                dt = now - self._prev_ts
                rates = {p: 0.0 for p in _PRIORITIES}
                for pname, count in sheds.items():
                    d = count - self._prev_sheds.get(pname, 0)
                    if d > 0:
                        rates[pname] = round(d / dt, 4)
                self._last_rates = rates
                self._prev_sheds = dict(sheds)
                self._prev_ts = now
            kw["shed_rate_by_priority"] = dict(self._last_rates)
            signals = ControlSignals(**kw)
            self._ring.append(signals)
        return signals

    def timeline(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            items = list(self._ring)
        if n is not None:
            items = items[-int(n):]
        return [s.to_dict() for s in items]

    # -- surfaces ------------------------------------------------------------

    def signals_debug(self) -> dict:
        """The ``GET /debug/signals`` payload (also the ``signals``
        section of /debug/stats): a fresh snapshot, its flattened
        vector, and the ring timeline."""
        current = self.snapshot()
        return {
            "current": current.to_dict(),
            "vector": current.vector(),
            "fields": list(ControlSignals.FIELDS),
            "timeline": self.timeline(),
        }

    def poll(self, metrics) -> None:
        """Render-time hook (``PrometheusMetrics.attach_render_hook``):
        refresh the ``signal_*`` gauge families from a fresh
        snapshot."""
        s = self.snapshot()
        metrics.signal_queue_wait_ms.set(s.queue_wait_ms)
        metrics.signal_batch_fill.set(s.batch_fill)
        metrics.signal_breaker_state.set(s.breaker_state)
        for pname, rate in s.shed_rate_by_priority.items():
            metrics.signal_shed_rate.labels(pname).set(rate)
        metrics.signal_lease_outstanding_tokens.set(
            s.lease_outstanding_tokens
        )
        for phase, p99 in s.native_phase_p99_us.items():
            metrics.signal_native_p99_us.labels(phase).set(p99)
        metrics.signal_slo_burn_5m.set(s.slo_burn_5m)
        metrics.signal_box_calibration.set(s.box_calibration_score)
        metrics.signal_device_backed.set(s.device_backed)
