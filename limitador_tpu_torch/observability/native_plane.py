"""Native telemetry plane and SLO burn-rate watchdog.

Counterpart of ``limitador_tpu/observability/native_plane.py``. A repeat
or leased descriptor runs no Python between the gRPC handler's bytes and
its answer, so the flight recorder and the per-phase histograms never see
the rows that matter most. The port's C++ host lane measures its own
phases (wait-free log2-ns histograms and a slow-row exemplar ring,
``hp_tel_*`` in ``csrc/hostpath.cc``); this module is the Python half:

* :data:`PHASES`: the native phases, the host lane's ``hot_lookup``,
  ``hot_stage``, ``lease_hit`` and ``hot_finish`` and the native
  ingress's ``h2i_respond`` (its coded respond, ``csrc/h2ingress.cc``),
  each with a ``native_phase_<phase>`` histogram family in
  ``metrics.py``. The ingress's histogram is drained only where its
  library is already loaded (a server without ``--native-ingress``
  never builds it); the phase then counts 0.
* :class:`NativePlane`: drains the cumulative C histograms on every
  metrics render and adds the per-bucket increments to the
  ``native_phase_*`` families (the C plane is process-global and never
  resets, so the Python side keeps per-bucket baselines, taken when the
  plane arms: a second server of the process counts from its own start,
  where the JAX plane counts from the process's), drains slow-row
  exemplars into the flight recorder under the ``native_lane``/``lease``
  phases (and into the process flight recorder's ``native_hot`` lane
  when the recorder carries a ``flight_tap``), and exports the watchdog
  as ``slo_*`` gauges and ``/debug/stats`` sections.
* :class:`SloWatchdog`: multi-window (5 m / 1 h) burn-rate tracking of
  the p99 <= budget SLO over the decision latency the device-plane
  recorder has in hand per batch. Burn rate is the share of decisions
  over budget divided by the error budget (1 - quantile); the watchdog
  fires only when both windows burn.
* :func:`device_backed_runtime`: whether the serving table is on the
  card, read from the storage's torch device (the ``device_backed``
  gauge and ``/debug/stats`` field).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "PHASES",
    "METRIC_FAMILIES",
    "NATIVE_PHASE_BUCKETS",
    "NativePlane",
    "SloWatchdog",
    "device_backed_runtime",
]

#: every native phase the plane measures, one ``native_phase_<entry>``
#: histogram family each
PHASES = ("hot_lookup", "hot_stage", "lease_hit", "hot_finish",
          "h2i_respond")

#: Prometheus families this module feeds (declared in metrics.py)
METRIC_FAMILIES = (
    "native_phase_hot_lookup",
    "native_phase_hot_stage",
    "native_phase_lease_hit",
    "native_phase_hot_finish",
    "native_phase_h2i_respond",
    "slo_p99_ms_5m",
    "slo_p99_ms_1h",
    "slo_burn_rate_5m",
    "slo_burn_rate_1h",
    "slo_budget_ms",
    "slo_breached",
    "slo_breached_actionable",
    "device_backed",
)

# The C histograms are log2-ns: bucket b holds [2^b, 2^{b+1}) ns. The
# Prometheus families use a trimmed slice of the same pow2 edges (in
# seconds), so every C bucket maps into exactly one Prometheus bucket
# and merging a drain is per-bucket integer adds.
_BUCKET_LO = 7   # C buckets below 2^8 ns collapse into the first edge
_BUCKET_HI = 33  # C buckets above 2^34 ns (~17 s) go to +Inf
#: Prometheus bucket edges (seconds): 2^{b+1} ns for b in [LO, HI]
NATIVE_PHASE_BUCKETS = tuple(
    2.0 ** (b + 1) / 1e9 for b in range(_BUCKET_LO, _BUCKET_HI + 1)
)


def _prom_bucket_index(c_bucket: int) -> int:
    """C log2 bucket -> index into a native_phase histogram's
    ``_buckets`` list (the +Inf slot is the last index)."""
    if c_bucket < _BUCKET_LO:
        return 0
    if c_bucket > _BUCKET_HI:
        return _BUCKET_HI - _BUCKET_LO + 1  # +Inf
    return c_bucket - _BUCKET_LO


def device_backed_runtime(storage) -> Optional[bool]:
    """Is the serving table on the card? None for a server without a
    device storage (``storage`` None or without a torch ``device``),
    True when the table is on ``cuda``, False on ``--device cpu``."""
    device = getattr(storage, "device", None)
    if device is None:
        return None
    return device.type == "cuda"


class SloWatchdog:
    """Multi-window burn-rate watchdog for the p99 <= budget SLO.

    Decision latencies land in a ring of 10 s slices, each a log2-µs
    histogram plus over-budget/total counters; the 5 m and 1 h windows
    merge the live slices. ``burn_rate`` is (share over budget) /
    (1 - quantile): 1.0 spends the error budget exactly as fast as the
    SLO allows. ``breached`` needs both windows to burn. Thread-safe;
    ``observe_many`` takes the lock once per batch. Every slice is keyed
    on ``clock``."""

    SLICE_S = 10.0
    _N_BUCKETS = 40  # log2 µs

    def __init__(
        self,
        budget_ms: float = 2.0,
        quantile: float = 0.99,
        short_s: float = 300.0,
        long_s: float = 3600.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.budget_ms = float(budget_ms)
        self.quantile = float(quantile)
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self._clock = clock
        self._n_slices = max(int(long_s / self.SLICE_S), 1)
        self._short_slices = max(int(short_s / self.SLICE_S), 1)
        self._counts = np.zeros(
            (self._n_slices, self._N_BUCKETS), np.int64
        )
        self._total = np.zeros(self._n_slices, np.int64)
        self._over = np.zeros(self._n_slices, np.int64)
        self._cur_abs = None  # absolute slice id the ring head holds
        self._lock = threading.Lock()

    def _sync(self, now: float) -> int:
        """Advance the ring to ``now``'s slice, zeroing skipped slices;
        returns the ring row of the current slice. Caller holds the
        lock."""
        cur = int(now // self.SLICE_S)
        if self._cur_abs is None:
            self._cur_abs = cur
        elif cur > self._cur_abs:
            step = min(cur - self._cur_abs, self._n_slices)
            for i in range(1, step + 1):
                row = (self._cur_abs + i) % self._n_slices
                self._counts[row] = 0
                self._total[row] = 0
                self._over[row] = 0
            self._cur_abs = cur
        return self._cur_abs % self._n_slices

    def observe_many(self, seconds: List[float]) -> None:
        """Count one batch of decision latencies into the current slice,
        bucketed as the JAX watchdog does: ``log2`` of the µs,
        truncated."""
        if not seconds:
            return
        us = np.maximum(np.asarray(seconds, np.float64) * 1e6, 1.0)
        buckets = np.clip(
            np.log2(us).astype(np.int64), 0, self._N_BUCKETS - 1
        )
        over = int((us > self.budget_ms * 1e3).sum())
        with self._lock:
            row = self._sync(self._clock())
            np.add.at(self._counts[row], buckets, 1)
            self._total[row] += us.shape[0]
            self._over[row] += over

    def observe(self, seconds: float) -> None:
        self.observe_many([seconds])

    def _window_rows(self, n_slices: int) -> np.ndarray:
        """Ring rows of the most recent ``n_slices`` slices (current
        included). Caller holds the lock."""
        head = self._cur_abs % self._n_slices
        return (head - np.arange(n_slices)) % self._n_slices

    def _window_stats(self, n_slices: int):
        rows = self._window_rows(n_slices)
        total = int(self._total[rows].sum())
        over = int(self._over[rows].sum())
        if total == 0:
            return 0, 0, 0.0
        counts = self._counts[rows].sum(axis=0)
        rank = self.quantile * total
        cum = np.cumsum(counts)
        b = min(int(np.searchsorted(cum, rank)), self._N_BUCKETS - 1)
        p_ms = 2.0 ** (b + 1) / 1e3  # bucket upper edge, µs -> ms
        return total, over, p_ms

    def status(self) -> dict:
        with self._lock:
            self._sync(self._clock())
            short_t, short_o, short_p = self._window_stats(
                self._short_slices
            )
            long_t, long_o, long_p = self._window_stats(self._n_slices)
        err_budget = max(1.0 - self.quantile, 1e-9)
        burn_short = (short_o / short_t / err_budget) if short_t else 0.0
        burn_long = (long_o / long_t / err_budget) if long_t else 0.0
        return {
            "budget_ms": self.budget_ms,
            "quantile": self.quantile,
            "p99_ms_5m": round(short_p, 4),
            "p99_ms_1h": round(long_p, 4),
            "burn_rate_5m": round(burn_short, 4),
            "burn_rate_1h": round(burn_long, 4),
            "samples_5m": short_t,
            "samples_1h": long_t,
            "breached": bool(burn_short >= 1.0 and burn_long >= 1.0),
        }


# Planes armed in this process: the C plane is process-global, so the
# last plane to close disarms it.
_armed_lock = threading.Lock()
_armed = 0


class NativePlane:
    """The Python half of the native telemetry plane: drains the C
    histograms and exemplars, merges them into Prometheus, and owns the
    SLO watchdog and the ``device_backed`` answer.

    Constructing one arms the C plane (building the host lane at first
    use: ``BuildError`` when it cannot); ``close`` disarms it once no
    other plane of the process is armed. Attach with
    ``metrics.attach_native_plane(plane)`` (polled on every render) and
    pass it among the HTTP API's ``debug_sources`` (its
    ``native_telemetry``, ``slo_status`` and ``device_backed`` become
    ``/debug/stats`` sections). ``attach_recorder`` feeds the watchdog
    from the device-plane recorder and gives exemplars a flight recorder
    to land in."""

    def __init__(
        self,
        budget_ms: float = 2.0,
        slow_row_us: float = 0.0,
        trace_sample: int = 0,
        recorder=None,
        watchdog: Optional[SloWatchdog] = None,
        device_backed: Optional[bool] = None,
    ):
        self.watchdog = watchdog or SloWatchdog(budget_ms=budget_ms)
        self.recorder = None
        self.attach_recorder(recorder)
        self.slow_row_us = float(slow_row_us)
        self.trace_sample = int(trace_sample)
        self._device_backed = device_backed
        self._lock = threading.Lock()
        self._armed = False
        self.configure()
        # per-phase cumulative baselines for increment conversion, taken
        # when the plane arms: a plane counts the begins after it, not
        # those an earlier plane of the process saw
        self._origin = self.snapshots()
        self._base_buckets: Dict[str, np.ndarray] = {
            phase: np.asarray(snap["buckets"], np.int64)
            for phase, snap in self._origin.items()
        }
        self._base_sum: Dict[str, int] = {
            phase: snap["sum_ns"] for phase, snap in self._origin.items()
        }

    # -- configuration -------------------------------------------------------

    def configure(self) -> bool:
        """Arm the C planes: the host lane's with this plane's exemplar
        threshold and trace sampling, and the ingress's respond histogram
        (taken by the ingress library when it loads, if it is not loaded
        yet). Raises when the host lane cannot be built."""
        global _armed
        from .. import native
        from ..native.ingress import ingress_tel_config

        native.tel_config(
            True, int(self.slow_row_us * 1000.0), self.trace_sample
        )
        ingress_tel_config(True)
        with _armed_lock:
            if not self._armed:
                self._armed = True
                _armed += 1
        return True

    def close(self) -> None:
        """Disarm the C plane unless another plane of the process is
        still armed."""
        global _armed
        from .. import native
        from ..native.ingress import ingress_tel_config

        with _armed_lock:
            if not self._armed:
                return
            self._armed = False
            _armed -= 1
            if _armed == 0:
                native.tel_config(False, 0, 0)
                ingress_tel_config(False)

    def attach_recorder(self, recorder) -> None:
        self.recorder = recorder
        if recorder is not None:
            recorder.slo = self.watchdog

    # -- drains --------------------------------------------------------------

    def snapshots(self) -> Dict[str, dict]:
        """Cumulative per-phase snapshots of both C planes, every phase
        of ``PHASES`` present: ``h2i_respond`` counts 0 while the ingress
        library is not loaded."""
        from .. import native
        from ..native.ingress import ingress_tel_drain

        snap = dict(native.tel_drain())
        snap["h2i_respond"] = ingress_tel_drain() or {
            "count": 0, "sum_ns": 0, "buckets": [0] * native.TEL_BUCKETS,
        }
        return snap

    def drain_exemplars(self) -> List[dict]:
        from .. import native

        return native.tel_exemplars()

    # -- the render-time poll ------------------------------------------------

    def poll(self, metrics) -> None:
        """Called by ``PrometheusMetrics`` on every render: merge the
        drained histogram deltas into the ``native_phase_*`` families,
        land slow-row exemplars in the flight recorder, and refresh the
        ``slo_*`` and ``device_backed`` gauges."""
        with self._lock:
            for phase, snap in self.snapshots().items():
                hist = getattr(metrics, f"native_phase_{phase}", None)
                if hist is None:
                    continue
                buckets = np.asarray(snap["buckets"], np.int64)
                base = self._base_buckets.get(phase)
                if base is None:
                    base = np.zeros_like(buckets)
                delta = buckets - base
                if int(delta.sum()) <= 0:
                    continue
                self._base_buckets[phase] = buckets
                sum_s = (
                    snap["sum_ns"] - self._base_sum.get(phase, 0)
                ) / 1e9
                self._base_sum[phase] = snap["sum_ns"]
                # The bucket counts are the histogram: add them directly
                # (the render cumulates buckets and derives _count).
                for b in np.nonzero(delta)[0].tolist():
                    hist._buckets[_prom_bucket_index(b)].inc(
                        int(delta[b])
                    )
                hist._sum.inc(max(sum_s, 0.0))
        self._offer_exemplars()
        wd = self.watchdog.status()
        for gauge, key in (
            (metrics.slo_p99_ms_5m, "p99_ms_5m"),
            (metrics.slo_p99_ms_1h, "p99_ms_1h"),
            (metrics.slo_burn_rate_5m, "burn_rate_5m"),
            (metrics.slo_burn_rate_1h, "burn_rate_1h"),
            (metrics.slo_budget_ms, "budget_ms"),
        ):
            gauge.set(wd[key])
        metrics.slo_breached.set(1 if wd["breached"] else 0)
        backed = self._device_backed
        if backed is not None:
            metrics.device_backed.set(1 if backed else 0)
        # The pageable breach: a breach on a table off the card is real
        # but no operator action on the card fixes it.
        metrics.slo_breached_actionable.set(
            1 if (wd["breached"] and backed) else 0
        )

    def _offer_exemplars(self) -> None:
        rec = self.recorder
        if rec is None:
            # No flight recorder to land in yet: the C ring keeps the
            # latest 64 slow rows until a consumer attaches.
            return
        tap = rec.flight_tap
        for ex in self.drain_exemplars():
            phases_ms = {
                "native_lane": round(
                    (ex["lookup_ns"] + ex["stage_ns"]) / 1e6, 4
                ),
            }
            if ex["leased_rows"] > 0:
                phases_ms["lease"] = round(ex["total_ns"] / 1e6, 4)
            if tap is not None:
                # The C ring is the sample: every drained slow row taps
                # the process flight recorder's native_hot lane.
                tap.tap(
                    ex["total_ns"] / 1e9, "native_hot",
                    phases_ms=phases_ms,
                    key=format(
                        ex["blob_digest"] & 0xFFFFFFFFFFFFFFFF, "016x"
                    ),
                )
            rec.flight.offer(ex["total_ns"] / 1e9, {
                "request_id": None,
                "namespace": None,
                "batch_id": None,
                "queue_wait_ms": 0.0,
                "phases_ms": phases_ms,
                "native": {
                    "rows": ex["rows"],
                    "kernel_rows": ex["kernel_rows"],
                    "staged_hits": ex["staged_hits"],
                    "miss_rows": ex["miss_rows"],
                    "leased_rows": ex["leased_rows"],
                    "blob_digest": format(
                        ex["blob_digest"] & 0xFFFFFFFFFFFFFFFF, "016x"
                    ),
                    "blob_len": ex["blob_len"],
                    "plan_kind": ex["plan_kind"],
                    "lease_tokens": ex["lease_tokens"],
                },
            })

    # -- /debug/stats sections -----------------------------------------------

    def native_telemetry(self) -> dict:
        """Per phase since the plane armed: count, mean and p50/p99 µs
        from the log2 buckets."""
        out: dict = {}
        for phase, snap in self.snapshots().items():
            origin = self._origin[phase]
            count = snap["count"] - origin["count"]
            entry = {"count": count}
            if count:
                entry["mean_us"] = round(
                    (snap["sum_ns"] - origin["sum_ns"]) / count / 1e3, 3)
                buckets = np.asarray(snap["buckets"], np.int64) - np.asarray(
                    origin["buckets"], np.int64)
                cum = np.cumsum(buckets)
                for q, name in ((0.5, "p50_us"), (0.99, "p99_us")):
                    b = int(np.searchsorted(cum, q * count))
                    b = min(b, buckets.shape[0] - 1)
                    entry[name] = round(2.0 ** (b + 1) / 1e3, 3)
            out[phase] = entry
        return out

    def slo_status(self) -> dict:
        """Watchdog status with the device_backed companion: breached and
        device-backed is the actionable combination."""
        status = self.watchdog.status()
        backed = self._device_backed
        status["device_backed"] = backed
        status["actionable"] = bool(status["breached"] and backed)
        return status

    def device_backed(self) -> Optional[bool]:
        return self._device_backed
