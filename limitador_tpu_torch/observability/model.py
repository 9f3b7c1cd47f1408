"""Online serving-model fit: coefficients, drift and headroom.

Counterpart of ``limitador_tpu/observability/model.py``. The serving
model (the host and device cost of a launch as a linear function of its
rows and traffic mix) becomes a live, continuously fitted object:

* :class:`ServingModelEstimator` ingests the per-launch observations the
  device-plane recorder already has in hand
  (``DeviceStatsRecorder.record_batch``: rows, host work phases, device
  sync, queue wait) and fits the serving-model terms by exponentially
  weighted recursive least squares over per-refit BUCKET MEDIANS
  (launches grouped by row count; singleton buckets never update: the
  first flush of a new batch size is where a compile or warm-up stall
  lands). Every observation is normalized by a live box-calibration
  probe, so that a box running 2x slower leaves the normalized target
  flat.
* Residual drift detection: each refit's prequential residuals (every
  bucket predicted before it updates the fit) split into level and
  shape. A one-sided CUSUM watches the level; a trip is classified
  against the calibration track: the raw probe moved ->
  ``calibration_shift`` (box phase change), probe flat -> ``drifted``
  (a code or configuration regression; the ``model_drift`` gauge rises
  and a ``model_drift`` event goes to an attached event log).
* Headroom forecasting: the fitted model inverted against the
  ``--slo-budget-ms`` budget (grid search of the batch size whose
  predicted latency fits, throughput ``B / max(host(B), device(B))``),
  ``capacity_headroom_ratio`` against the current rate, and the share of
  predicted latency each stage owns.
* ``GET /debug/capacity`` (``server/http_api.py``) serves the
  coefficients, R², drift state, headroom and what-if queries
  (``?batch=``, ``?lease_share=``, ``?procs=``), and the tier manager
  prices migrations with the fitted ``row`` coefficients.

The fit never runs on the decision path: ``ingest`` is a lock and a
bounded append, called once per finished device batch on the collect
thread; ``refit`` drains the buffer on the usage observatory's drain
thread (or a metrics render). The same math, constants and defaults as
the JAX module; ``pipeline_context`` reads the port's stats names.

Coefficient names (``MODEL_TERMS``): ``launch`` (per-launch fixed
overhead), ``row`` (per-row marginal cost; host target: the host lane's
per-row cost, device target: the kernel's per-row share), ``lease_row``
(the per-row adjustment at lease coverage L), ``pod_row`` (per-row
adjustment for foreign-owned rows) and ``collective_row`` (per-row
adjustment when launches ride the coupled/global sharded variants).
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np

__all__ = [
    "MODEL_TERMS",
    "MODEL_TARGETS",
    "ATTRIBUTION_STAGES",
    "METRIC_FAMILIES",
    "ServingModelEstimator",
    "pipeline_context",
    "model_fit_enabled",
    "set_model_fit_enabled",
    "process_estimator",
]

#: the fitted terms, in feature order (the module docstring names each)
MODEL_TERMS = ("launch", "row", "lease_row", "pod_row", "collective_row")

#: the two fitted targets: host phase time and device sync time per
#: launch — kept apart because the serving bound is max(host, device)
#: (the overlap), not their sum
MODEL_TARGETS = ("host", "device")

#: per-stage latency attribution keys (capacity_stage_share{stage}):
#: the predicted-latency share each term owns at the operating point —
#: where the next millisecond of p99 comes from
ATTRIBUTION_STAGES = (
    "host_launch", "host_rows", "device_launch", "device_rows",
    "lease_rows", "pod_rows", "collective_rows", "queue",
)

#: Prometheus families owned by this module (declared in metrics.py)
METRIC_FAMILIES = (
    "model_r2",
    "model_observations",
    "model_drift",
    "model_drift_cusum",
    "model_coefficient",
    "capacity_headroom_ratio",
    "capacity_max_decisions_per_sec",
    "capacity_stage_share",
)

#: drift-state machine values served at /debug/capacity
DRIFT_STATES = ("warmup", "ok", "drifted", "calibration_shift")

#: CUSUM slack (allowance) and trip threshold, in residual std units —
#: the classic k=0.5/h=8 one-sided detector: ~0.5σ of sustained slowdown
#: accumulates, anything faster-than-model drains the statistic
_CUSUM_K = 0.5
_CUSUM_H = 8.0

#: relative calibration movement (vs the EW baseline) beyond which a
#: CUSUM trip is classified as a box phase change, not a regression
_CAL_SHIFT = 0.25

#: RLS updates before r2/drift/headroom report non-defaults (the fit
#: needs a few dozen bucket-median updates to leave its prior)
_WARMUP_UPDATES = 24

#: updates before the prequential stats (y-mean/var, sse) accumulate:
#: the first few residuals only measure the zero prior — and on a live
#: pipeline they catch the first-compile stalls (100-600 ms on a
#: handful of launches), which would poison the EW accumulators for
#: hundreds of updates
_STATS_SKIP = 8

#: winsorization bound (residual std units): innovations beyond this
#: are clipped before they touch the RLS weights OR the stats — one
#: compile stall / scheduler storm gets bounded influence, while a
#: SUSTAINED shift still trips the CUSUM (clipped z ≫ k) and still
#: adapts the fit (the clip loosens as the residual std grows)
_CLIP_SIGMA = 8.0


class _Ewrls:
    """Exponentially-weighted recursive least squares, multiple targets
    sharing one feature stream (so one precision matrix P serves every
    target — the per-observation cost is paid once, not per target).

    Standard form: gain k = Px/(λ + xᵀPx); W += (y − Wx)·kᵀ;
    P = (P − k xᵀP)/λ. λ slightly under 1 forgets old box phases at
    roughly a 1/(1−λ)-observation horizon."""

    def __init__(self, dim: int, targets: int, forgetting: float = 0.995):
        self.dim = dim
        self.lam = float(forgetting)
        self.W = np.zeros((targets, dim), np.float64)
        self.P = np.eye(dim, dtype=np.float64) * 1e6

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Per-target predictions, shape ``(targets,)``."""
        return self.W @ x

    def update(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """One observation of every target; returns the pre-update
        (prequential) prediction vector."""
        pred = self.W @ x
        Px = self.P @ x
        k = Px / (self.lam + float(x @ Px))
        self.W += np.outer(y - pred, k)
        self.P = (self.P - np.outer(k, Px)) / self.lam
        return pred


def _quick_calibration() -> float:
    """A miniaturized box-calibration probe (~1-5 ms): fixed Python
    spin + 4 MB of memcpy, reciprocal of the wall time. Proportional to
    ``signals.box_calibration_score`` (same workload shape, smaller
    constants) — the model only needs PROPORTIONALITY across refits,
    so the small probe's different absolute scale is fine. Runs on the
    observatory drain thread at the refit cadence, never the decision
    path."""
    src = bytes(2 << 20)
    dst = bytearray(2 << 20)
    t0 = time.perf_counter()
    acc = 0
    for i in range(10_000):
        acc += i ^ (acc & 0xFF)
    for _ in range(2):
        dst[:] = src
    return 1.0 / max(time.perf_counter() - t0, 1e-9)


class ServingModelEstimator:
    """The online serving-model fit + drift detector + headroom
    forecaster.

    ``ingest`` is the hot-adjacent half (collect threads, lock+append
    only); everything else runs on drain/render threads. ``context``
    (attach_context) supplies the traffic-mix shares the per-launch
    record cannot carry — lease coverage, pod foreign share, collective
    launch share — sampled once per refit. ``calibration`` is
    injectable for tests; production uses the quick probe above,
    EW-smoothed."""

    #: bounded ingest buffer: at the observatory's 1 s drain cadence
    #: even a 32k-launch/s storm cannot grow memory — excess launches
    #: drop oldest (the fit wants a sample, not a ledger)
    INGEST_CAP = 4096

    #: max observations one refit feeds through the RLS: bigger drains
    #: stride-subsample evenly (the rate/throughput stats still read
    #: the WHOLE batch). Keeps a full-buffer refit to a few ms on the
    #: drain thread.
    REFIT_SAMPLE = 1024

    def __init__(
        self,
        budget_ms: float = 2.0,
        forgetting: float = 0.99,
        min_refit_s: float = 0.5,
        max_batch: int = 32768,
        calibration: Optional[Callable[[], float]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.budget_ms = float(budget_ms)
        self.max_batch = int(max_batch)
        self.min_refit_s = float(min_refit_s)
        self._clock = clock
        self._calibration = calibration or _quick_calibration
        self._ingest_lock = threading.Lock()
        self._pending: deque = deque(maxlen=self.INGEST_CAP)
        self._fit_lock = threading.Lock()
        self._rls = _Ewrls(
            len(MODEL_TERMS), len(MODEL_TARGETS), forgetting
        )
        self.observations = 0
        self.updates = 0
        self.dropped = 0
        self._last_refit = 0.0
        # context shares sampled per refit (attach_context)
        self._context_fn: Optional[Callable[[], dict]] = None
        self._mix = {
            "lease_share": 0.0, "pod_share": 0.0, "collective_share": 0.0,
        }
        # EW residual-power accumulator (prequential: every residual
        # is predicted BEFORE its update) — standardizes the CUSUM.
        # R² is NOT derived from this: it's computed per refit over
        # that refit's buckets (within one box-phase window, so
        # phase-correlated noise hits residual and spread alike) and
        # EW-smoothed across refits.
        self._g = 0.99  # per-update decay
        self._sse = 0.0
        self._stat_weight = 0.0
        # EW operating point
        self._rows_mean = 0.0
        self._queue_wait_s = 0.0
        self._rate = 0.0  # decisions/s, from ingest timestamps
        self._last_obs_ts: Optional[float] = None
        # calibration track: raw last probe, current (EW-fast — the
        # normalization basis) and baseline (EW-slow — what the drift
        # classifier compares the raw probe against)
        self._cal_raw = 0.0
        self._cal = 0.0
        self._cal_ref = 0.0
        # drift state machine
        self._cusum = 0.0
        self.drift_state = "warmup"
        self._drift_events = 0
        self._event_log = None
        # forecaster outputs (recomputed per refit)
        self._r2 = 0.0
        self._r2_n = 0
        self._headroom = 0.0
        self._max_rate = 0.0
        self._attribution: Dict[str, float] = dict.fromkeys(
            ATTRIBUTION_STAGES, 0.0
        )

    # -- attachment ----------------------------------------------------------

    def attach_context(self, fn: Callable[[], dict]) -> None:
        """``fn() -> {"lease_share", "pod_share", "collective_share"}``
        (any subset), sampled once per refit — never per decision."""
        self._context_fn = fn

    def attach_event_log(self, log) -> None:
        """A PodEventLog (observability/events.py); drift transitions
        emit typed ``model_drift`` events onto it."""
        self._event_log = log

    # -- the ingest tap (collect threads; lock + append ONLY) ----------------

    def ingest(
        self,
        rows: int,
        host_s: float,
        device_s: float,
        queue_wait_s: float = 0.0,
    ) -> None:
        """One finished device launch. Called by
        ``DeviceStatsRecorder.record_batch`` once per batch — the cost
        is a lock and a deque append; the fit happens elsewhere."""
        ts = self._clock()
        with self._ingest_lock:
            if len(self._pending) == self._pending.maxlen:
                self.dropped += 1
            self._pending.append(
                (ts, int(rows), float(host_s), float(device_s),
                 float(queue_wait_s))
            )

    # -- the fit (observatory drain thread / render threads) -----------------

    def _features(
        self, rows: float, lease: float, pod: float, coll: float
    ) -> np.ndarray:
        return np.array(
            [1.0, rows, rows * lease, rows * pod, rows * coll],
            np.float64,
        )

    def refit(self, force: bool = False) -> int:
        """Drain pending observations into the RLS fits; update the
        prequential R², the CUSUM drift state and the headroom
        forecast. Throttled to ``min_refit_s`` unless forced; returns
        observations consumed."""
        now = self._clock()
        with self._fit_lock:
            if not force and now - self._last_refit < self.min_refit_s:
                return 0
            self._last_refit = now
            with self._ingest_lock:
                batch = list(self._pending)
                self._pending.clear()
            if not batch:
                return 0
            drained = len(batch)
            try:
                cal = float(self._calibration())
            except Exception:
                cal = self._cal
            if cal <= 0.0:
                cal = self._cal or 1.0
            # fast EW for "current" calibration, slow EW for the
            # baseline the drift classifier compares against
            self._cal_raw = cal
            self._cal = cal if self._cal == 0.0 else (
                self._cal + 0.5 * (cal - self._cal)
            )
            self._cal_ref = self._cal if self._cal_ref == 0.0 else (
                self._cal_ref + 0.02 * (self._cal - self._cal_ref)
            )
            if self._context_fn is not None:
                try:
                    ctx = self._context_fn() or {}
                    for key in self._mix:
                        if key in ctx:
                            self._mix[key] = min(
                                max(float(ctx[key]), 0.0), 1.0
                            )
                except Exception:
                    pass
            lease = self._mix["lease_share"]
            pod = self._mix["pod_share"]
            coll = self._mix["collective_share"]
            g = self._g
            # throughput stats read the WHOLE batch (cheap) before the
            # fit stride-subsamples it: decisions/s from total rows
            # over the observed span, so subsampling never skews rate
            first_ts = batch[0][0]
            total_rows = sum(b[1] for b in batch)
            if self._last_obs_ts is not None:
                span = batch[-1][0] - min(self._last_obs_ts, first_ts)
                if span > 1e-6:
                    inst = total_rows / span
                    self._rate += 0.5 * (inst - self._rate)
            self._last_obs_ts = batch[-1][0]
            # stride-subsample large drains: the RLS wants coverage of
            # the batch, not every launch
            if len(batch) > self.REFIT_SAMPLE:
                stride = -(-len(batch) // self.REFIT_SAMPLE)
                batch = batch[::stride]
            # group the sampled launches by row count: the estimand is
            # E[time | rows], and per-flush times on a contended box
            # carry multi-ms scheduler tails that would drown the fit
            # (measured OLS R² ~0.01 on raw flushes vs the same traffic
            # fit on bucket medians). The per-bucket MEDIAN is the
            # robust sufficient statistic for the linear model; one RLS
            # update per (refit, bucket).
            groups: Dict[int, list] = {}
            for _ts, rows, host_s, device_s, queue_wait_s in batch:
                if rows > 0:
                    groups.setdefault(rows, []).append(
                        (host_s, device_s, queue_wait_s)
                    )
            y = np.empty(2, np.float64)
            refit_ys: list = []
            refit_errs: list = []
            for rows, members in sorted(groups.items()):
                if len(members) < 2:
                    # a singleton bucket has NO robustness: the first
                    # flush of a new batch size is exactly where a
                    # compile stall lands (hundreds of ms), and one
                    # poisoned update against the high-trust prior can
                    # take hundreds of clean updates to forget. Skip
                    # it — the median needs company to mean anything.
                    continue
                med = np.median(
                    np.asarray(members, np.float64), axis=0
                )
                x = self._features(float(rows), lease, pod, coll)
                # normalized targets: seconds × calibration score — a
                # box running 2x slower doubles raw seconds and halves
                # the score, so the target (and the fit) stays put
                y[0] = med[0] * self._cal
                y[1] = med[1] * self._cal
                # prequential residual: predicted BEFORE the update,
                # so the stream is honestly held-out
                pred = self._rls.predict(x)
                err = float(y[0] + y[1] - (pred[0] + pred[1]))
                # winsorize: bound the influence of a gross outlier
                # (an first-compile stall, a scheduler storm) on
                # the weights and the drift statistic alike — c scales
                # the whole innovation, floored so learning can never
                # freeze on a small residual-power seed
                c = 1.0
                if (
                    self.updates >= _STATS_SKIP
                    and self._stat_weight >= 4.0
                    and self._sse > 0
                ):
                    lim = _CLIP_SIGMA * math.sqrt(self._sse)
                    if abs(err) > lim:
                        c = max(lim / abs(err), 0.05)
                self._rls.update(x, pred + (y - pred) * c)
                refit_ys.append(float(y[0] + y[1]))
                refit_errs.append(err * c)
                self.observations += len(members)
                self.updates += 1
                self._queue_wait_s += 0.1 * (
                    float(med[2]) - self._queue_wait_s
                )
            self._rows_mean += 0.2 * (
                total_rows / drained - self._rows_mean
            )
            # The refit's residual vector decomposes into LEVEL (mean
            # residual — the whole curve moved: contention phase the
            # probe missed, or a real regression) and SHAPE (centered
            # residuals — does the model capture how cost scales with
            # rows/mix?). The CUSUM watches the level: one sustained
            # shift is exactly what a code/config regression looks
            # like. R² judges the shape — the part that prices
            # capacity inversion and stage attribution — so a box
            # phase the calibration probe undershoots cannot convict
            # the model of not knowing its own curve.
            if refit_errs and self.updates > _STATS_SKIP:
                mean_err = sum(refit_errs) / len(refit_errs)
                # EW residual-level power, winsorized trip statistic
                self._stat_weight = g * self._stat_weight + 1.0
                a = 1.0 / self._stat_weight
                self._sse = (
                    (1 - a) * self._sse + a * mean_err * mean_err
                )
                if self.updates >= _WARMUP_UPDATES:
                    std = math.sqrt(max(self._sse, 1e-18))
                    z = min(mean_err / std, _CLIP_SIGMA)
                    # capped at 2h: the statistic must trip decisively
                    # but still DRAIN within a bounded number of quiet
                    # refits once the forgetting re-converges the fit
                    self._cusum = min(
                        max(0.0, self._cusum + z - _CUSUM_K),
                        2.0 * _CUSUM_H,
                    )
            if len(refit_ys) >= 3 and self.updates > _STATS_SKIP:
                mean_y = sum(refit_ys) / len(refit_ys)
                mean_err = sum(refit_errs) / len(refit_errs)
                ss_tot = sum((v - mean_y) ** 2 for v in refit_ys)
                ss_err = sum(
                    (e - mean_err) ** 2 for e in refit_errs
                )
                if ss_tot > 0:
                    r2_now = max(0.0, min(1.0, 1.0 - ss_err / ss_tot))
                    # adaptive gain: plain average over the first few
                    # refits (no cold-start drag from the zero init),
                    # EW once enough refits have reported
                    self._r2_n += 1
                    self._r2 += max(0.15, 1.0 / self._r2_n) * (
                        r2_now - self._r2
                    )
            self._advance_drift_locked()
            self._forecast_locked()
            return drained

    def _advance_drift_locked(self) -> None:
        if self.updates < _WARMUP_UPDATES:
            self.drift_state = "warmup"
            return
        if self._cusum >= _CUSUM_H:
            # classify against the RAW probe, not the EW track: a
            # sudden box throttle moves the raw score immediately while
            # the EW normalization basis lags (the lag IS what tripped
            # the CUSUM on a matched throttle)
            raw = self._cal_raw or self._cal
            cal_moved = (
                self._cal_ref > 0.0
                and abs(raw - self._cal_ref) / self._cal_ref
                > _CAL_SHIFT
            )
            if cal_moved:
                # box phase change: snap the normalization basis to the
                # new phase (don't wait out the EW lag — every launch
                # normalized with the stale basis feeds bogus residuals)
                self.drift_state = "calibration_shift"
                self._cal = raw
                self._cal_ref = raw
                self._cusum = 0.0
            elif self.drift_state != "drifted":
                self.drift_state = "drifted"
                self._drift_events += 1
                log = self._event_log
                if log is not None:
                    try:
                        log.emit(
                            "model_drift",
                            cusum=round(self._cusum, 3),
                            r2=round(self._r2, 4),
                            calibration=round(self._cal, 3),
                            observations=self.observations,
                        )
                    except Exception:
                        pass
        elif self._cusum < 1.0 and self.drift_state != "ok":
            self.drift_state = "ok"

    # -- the forecaster ------------------------------------------------------

    def _predict_seconds(
        self, rows: float, lease: float, pod: float, coll: float
    ):
        """(host_s, device_s) at the CURRENT calibration — the fit is
        normalized, so de-normalizing divides by the live score."""
        cal = self._cal or 1.0
        pred = self._rls.predict(self._features(rows, lease, pod, coll))
        return (
            max(float(pred[0]), 0.0) / cal,
            max(float(pred[1]), 0.0) / cal,
        )

    def _capacity(
        self,
        lease: float,
        pod: float,
        coll: float,
        budget_s: Optional[float] = None,
    ):
        """(max dec/s, best batch, latency at best batch): grid-search
        batch sizes whose predicted latency fits the budget, rate bound
        per the overlap model B / max(host, device)."""
        budget = (
            budget_s if budget_s is not None else self.budget_ms / 1e3
        )
        best_rate, best_b, best_lat = 0.0, 0, 0.0
        b = 1.0
        while b <= self.max_batch:
            host_s, device_s = self._predict_seconds(b, lease, pod, coll)
            lat = host_s + device_s + max(self._queue_wait_s, 0.0)
            if lat <= budget:
                rate = b / max(host_s, device_s, 1e-9)
                if rate > best_rate:
                    best_rate, best_b, best_lat = rate, int(b), lat
            b *= 2.0
        return best_rate, best_b, best_lat

    def _forecast_locked(self) -> None:
        if self.updates < _WARMUP_UPDATES:
            return
        lease = self._mix["lease_share"]
        pod = self._mix["pod_share"]
        coll = self._mix["collective_share"]
        self._max_rate, _b, _lat = self._capacity(lease, pod, coll)
        self._headroom = (
            self._max_rate / self._rate if self._rate > 1e-9 else 0.0
        )
        # per-stage latency attribution at the operating point: the
        # share of predicted latency each term owns — where the next
        # millisecond of p99 comes from as load grows
        cal = self._cal or 1.0
        rows = max(self._rows_mean, 1.0)
        wh, wd = self._rls.W[0], self._rls.W[1]
        parts = {
            "host_launch": wh[0] / cal,
            "host_rows": wh[1] * rows / cal,
            "device_launch": wd[0] / cal,
            "device_rows": wd[1] * rows / cal,
            "lease_rows": (wh[2] + wd[2]) * rows * lease / cal,
            "pod_rows": (wh[3] + wd[3]) * rows * pod / cal,
            "collective_rows": (wh[4] + wd[4]) * rows * coll / cal,
            "queue": max(self._queue_wait_s, 0.0),
        }
        total = sum(max(v, 0.0) for v in parts.values())
        if total > 0:
            self._attribution = {
                k: round(float(max(v, 0.0)) / total, 4)
                for k, v in parts.items()
            }

    # -- surfaces ------------------------------------------------------------

    def coefficients(self) -> Dict[str, Dict[str, float]]:
        """Fitted coefficients in NORMALIZED units (seconds × box
        score), keyed target -> term."""
        with self._fit_lock:
            return {
                target: {
                    t: round(float(w), 9)
                    for t, w in zip(MODEL_TERMS, row)
                }
                for target, row in zip(MODEL_TARGETS, self._rls.W)
            }

    def signal_fields(self) -> dict:
        """The ControlSignals tail (observability/signals.py): cheap
        cached reads, no refit, no probe."""
        return {
            "model_r2": round(self._r2, 4),
            "capacity_headroom_ratio": round(self._headroom, 4),
            "model_drift": 1 if self.drift_state == "drifted" else 0,
        }

    def what_if(
        self,
        batch: Optional[int] = None,
        lease_share: Optional[float] = None,
        procs: Optional[int] = None,
    ) -> dict:
        """Forecast under an overridden operating point: ``batch``
        overrides the EW batch size, ``lease_share`` the lease
        coverage, ``procs`` scales the pod-linear local term (the
        serving model's host-linear H·R_local — forwarded traffic stays
        bounded by the bulk lane, so this is the model's optimistic
        L→1 bound)."""
        with self._fit_lock:
            lease = (
                min(max(float(lease_share), 0.0), 1.0)
                if lease_share is not None
                else self._mix["lease_share"]
            )
            pod = self._mix["pod_share"]
            coll = self._mix["collective_share"]
            rows = (
                float(batch) if batch is not None
                else max(self._rows_mean, 1.0)
            )
            host_s, device_s = self._predict_seconds(
                rows, lease, pod, coll
            )
            latency_s = host_s + device_s + max(self._queue_wait_s, 0.0)
            rate = rows / max(host_s, device_s, 1e-9)
            max_rate, best_b, _lat = self._capacity(lease, pod, coll)
            n_hosts = max(int(procs), 1) if procs is not None else 1
            return {
                "batch": int(rows),
                "lease_share": round(lease, 4),
                "procs": n_hosts,
                "predicted_host_ms": round(host_s * 1e3, 4),
                "predicted_device_ms": round(device_s * 1e3, 4),
                "predicted_latency_ms": round(latency_s * 1e3, 4),
                "predicted_decisions_per_sec": round(rate * n_hosts, 1),
                "max_decisions_per_sec": round(max_rate * n_hosts, 1),
                "best_batch": best_b,
            }

    def capacity_debug(
        self,
        batch: Optional[int] = None,
        lease_share: Optional[float] = None,
        procs: Optional[int] = None,
    ) -> dict:
        """The ``GET /debug/capacity`` payload (and the ``capacity``
        section of /debug/stats when called bare). What-if params
        overlay a forecast without touching the fit."""
        self.refit()  # throttled; freshens from the pending buffer
        with self._fit_lock:
            out = {
                "r2": round(self._r2, 4),
                "observations": self.observations,
                "dropped": self.dropped,
                "budget_ms": self.budget_ms,
                "calibration": round(self._cal, 3),
                "calibration_baseline": round(self._cal_ref, 3),
                "drift": {
                    "state": self.drift_state,
                    "cusum": round(self._cusum, 3),
                    "events": self._drift_events,
                },
                "mix": {
                    "rows_per_launch": round(self._rows_mean, 1),
                    "decisions_per_sec": round(self._rate, 1),
                    "queue_wait_ms": round(self._queue_wait_s * 1e3, 4),
                    **{k: round(v, 4) for k, v in self._mix.items()},
                },
                "headroom": {
                    "capacity_headroom_ratio": round(self._headroom, 4),
                    "max_decisions_per_sec": round(self._max_rate, 1),
                },
                "attribution": dict(self._attribution),
            }
        out["coefficients"] = self.coefficients()
        if batch is not None or lease_share is not None \
                or procs is not None:
            out["what_if"] = self.what_if(
                batch=batch, lease_share=lease_share, procs=procs
            )
        return out

    def poll(self, metrics) -> None:
        """Render-time hook (``PrometheusMetrics.attach_render_hook``):
        refresh the ``model_*`` / ``capacity_*`` families. Duck-typed
        sinks may carry a subset — every set is getattr-guarded."""
        self.refit()  # throttled
        fields = self.signal_fields()
        for name, value in (
            ("model_r2", fields["model_r2"]),
            ("model_observations", self.observations),
            ("model_drift", fields["model_drift"]),
            ("model_drift_cusum", round(self._cusum, 3)),
            ("capacity_headroom_ratio",
             fields["capacity_headroom_ratio"]),
            ("capacity_max_decisions_per_sec", round(self._max_rate, 1)),
        ):
            gauge = getattr(metrics, name, None)
            if gauge is not None:
                gauge.set(value)
        coeff = getattr(metrics, "model_coefficient", None)
        if coeff is not None:
            for target, terms in self.coefficients().items():
                for term, value in terms.items():
                    coeff.labels(target, term).set(value)
        share = getattr(metrics, "capacity_stage_share", None)
        if share is not None:
            for stage, value in self._attribution.items():
                share.labels(stage).set(value)


def pipeline_context(
    pipeline=None, pod=None, storage=None
) -> Callable[[], dict]:
    """Build a refit-time context sampler over the live cumulative
    counters: lease coverage (leased admissions / lane decisions), pod
    foreign share (foreign / classified hot rows) and collective launch
    share (coupled+global / all sharded launches), each as an
    inter-refit DELTA share so the mix tracks the current traffic, not
    the process lifetime.

    The port's names: ``pipeline`` is a ``NativeRlsPipeline``, whose
    ``library_stats`` carries ``native_lane_rows``,
    ``native_lane_misses`` and, with leases, the broker's
    ``lease_admissions``; ``pod`` is a pod member's ``PodFrontend``, whose
    ``library_stats`` carries the native pod fast path's
    ``pod_hot_local_rows`` and ``pod_hot_foreign_rows``; ``storage`` is
    the device storage itself, whose
    ``launch_stats()["sharded_launches"]`` counts the sharded variants
    (``TorchShardedStorage``; a storage without ``launch_stats`` has no
    collective launches). The JAX context reads ``sharded_launches`` off
    the batched storage's ``library_stats``, which in the port drains
    the flush sizes the metrics render reads, so it is not called
    here."""
    base: Dict[str, float] = {}

    def _delta(key: str, seen: float) -> float:
        prev = base.get(key, 0.0)
        base[key] = seen
        return max(seen - prev, 0.0)

    def _stats_of(source) -> dict:
        if source is None:
            return {}
        try:
            return source.library_stats() or {}
        except Exception:
            return {}

    def _launches_of(source) -> dict:
        launch_stats = getattr(source, "launch_stats", None)
        if not callable(launch_stats):
            return {}
        try:
            return launch_stats().get("sharded_launches") or {}
        except Exception:
            return {}

    def sample() -> dict:
        out: dict = {}
        stats = _stats_of(pipeline)
        if stats:
            leased = _delta(
                "lease", float(stats.get("lease_admissions", 0))
            )
            # leased rows are a SUBSET of the lane rows counter (the C
            # lane counts the hit before the leased branch), so the
            # decision denominator is rows + misses — adding leased on
            # top would halve a fully-leased workload's share
            decided = _delta(
                "rows", float(stats.get("native_lane_rows", 0))
            ) + _delta(
                "misses", float(stats.get("native_lane_misses", 0))
            )
            if decided > 0:
                out["lease_share"] = min(leased / decided, 1.0)
        launches = _launches_of(storage)
        lean = _delta("lean", float(launches.get("lean", 0)))
        coupled = _delta(
            "coupled", float(launches.get("coupled", 0))
        )
        glob = _delta("global", float(launches.get("global", 0)))
        total = lean + coupled + glob
        if total > 0:
            out["collective_share"] = (coupled + glob) / total
        if pod is not None:
            try:
                pstats = pod.library_stats() or {}
            except Exception:
                pstats = {}
            local = _delta(
                "pod_local", float(pstats.get("pod_hot_local_rows", 0))
            )
            foreign = _delta(
                "pod_foreign",
                float(pstats.get("pod_hot_foreign_rows", 0)),
            )
            if local + foreign > 0:
                out["pod_share"] = foreign / (local + foreign)
        return out

    return sample


# -- process wiring -----------------------------------------------------------

_PROCESS: Optional[ServingModelEstimator] = None
_PROCESS_LOCK = threading.Lock()
_ENABLED: Optional[bool] = None


def model_fit_enabled() -> bool:
    """Is the online fit armed for this process? Env ``TPU_MODEL_FIT``
    (off/0/false disables), overridden by the server's ``--model-fit``
    flag via :func:`set_model_fit_enabled`."""
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = os.environ.get(
            "TPU_MODEL_FIT", "on"
        ).strip().lower() not in ("off", "0", "false")
    return _ENABLED


def set_model_fit_enabled(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = bool(enabled)


def process_estimator() -> ServingModelEstimator:
    """The process-wide estimator every DeviceStatsRecorder feeds (the
    same one-singleton discipline as the box calibration score): every
    server and drive of the process shares it."""
    global _PROCESS
    if _PROCESS is None:
        with _PROCESS_LOCK:
            if _PROCESS is None:
                _PROCESS = ServingModelEstimator()
    return _PROCESS
