"""Tenant usage observatory: device-fed heavy hitters and quota pressure.

Port counterpart of ``limitador_tpu/observability/usage.py``
(``TenantUsageObservatory``).

* The device kernels accumulate a per-slot hit count inside the
  check/update scatters they already run (the ``hits`` column; no extra
  launch on the decision path). The observatory drains that accumulator
  periodically through ``TorchStorage.drain_hot_slots`` (one B5 top-k
  launch, one B3a read: only 2K ints and K cells cross to the host) and
  folds the records into a host-side top-K table with full slot->counter
  attribution: namespace, limit, key values, utilization sample, and,
  with the lease tier on, the native lane's per-plan leased-admission
  counts (``drain_leased_usage`` -> ``attribute_slots``), so hits that
  never touch the device still attribute.
* Quota pressure: each drain samples value/max_value per hot counter
  into per-namespace near-exhaustion counts.

Accounting contract: with leasing off, the merged counts equal a host
oracle's per-counter hit counts EXACTLY (every kernel hit, admitted or
rejected, counts once; padding and credit settlements don't). With
leasing on, leased admissions merge in from the native counts; a plan
invalidated between drains can strand at most one drain interval's
leased counts. Slot recycling inside one drain interval attributes the
old occupant's counts to the current occupant (or drops them when the
slot is free).

``poll(metrics)`` feeds the ``tenant_*`` Prometheus families at render
time (``PrometheusMetrics.attach_render_hook``).

The drain thread also ticks the control-signal bus (``signal_bus``: one
snapshot a drain, so that its timeline has a steady cadence) and refits
the serving model (``model``, assigned by the server), as the JAX
observatory's thread does.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["TenantUsageObservatory"]

log = logging.getLogger(__name__)


def _identity(record: dict) -> Optional[Tuple]:
    """Stable counter identity of an attributed drain record; None for
    unattributed slots (recycled/freed before the drain resolved)."""
    ns = record.get("namespace")
    if ns is None:
        return None
    return (
        ns,
        record.get("limit_name"),
        record.get("max_value"),
        record.get("seconds"),
        tuple(sorted((record.get("key") or {}).items())),
    )


class TenantUsageObservatory:
    """Periodic drains -> cumulative host-side top-K with attribution.

    ``storage`` must expose ``drain_hot_slots(k)`` (TorchStorage);
    ``pipeline`` optionally adds the native lane's
    leased-admission counts (``drain_leased_usage`` +
    ``attribute_slots``). The tracked-identity map is bounded by
    ``max_tracked``: overflowing evicts the coldest half — the top-K
    remains exact as long as distinct live identities stay under the
    cap (sized for that; the default holds 64k tenants)."""

    def __init__(
        self,
        storage,
        pipeline=None,
        top_k: int = 64,
        interval_s: float = 1.0,
        near_threshold: float = 0.9,
        max_tracked: int = 1 << 16,
        signal_bus=None,
        clock=time.monotonic,
    ):
        self.storage = storage
        self.pipeline = pipeline
        self.top_k = max(int(top_k), 1)
        self.interval_s = float(interval_s)
        self.near_threshold = float(near_threshold)
        self.max_tracked = max(int(max_tracked), 2)
        self.signal_bus = signal_bus
        # serving-model estimator (observability/model.py) whose refit
        # rides this drain thread; assigned by the server wiring
        self.model = None
        self._clock = clock
        self._lock = threading.Lock()
        # identity -> [cumulative hits, last attributed record]
        self._counts: Dict[Tuple, list] = {}
        # per-namespace aggregates
        self._ns_hits: Dict[str, int] = {}          # cumulative
        self._ns_last: Dict[str, dict] = {}         # last-drain pressure
        self._util_samples: List[Tuple[str, float]] = []  # since last poll
        self._drains = 0
        self._unattributed = 0
        self._evicted = 0
        self._last_drain_ts: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: the exception that stopped the drain thread, if one did
        self.error: Optional[BaseException] = None
        #: called with that exception from the drain thread
        self.on_error = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="tenant-usage", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.drain()
                bus = self.signal_bus
                if bus is not None:
                    bus.snapshot()
                model = self.model
                if model is not None:
                    model.refit()
            except Exception as exc:
                # A drain that fails (a kernel that does not build or
                # launch) stops the observatory and reports; it is not
                # retried in silence. So does a bus tick or a refit that
                # raises (neither does by design: each guards its
                # sources as the JAX planes do).
                log.exception("usage drain failed; the observatory stops")
                self.error = exc
                if self.on_error is not None:
                    self.on_error(exc)
                return

    # -- the drain -----------------------------------------------------------

    def drain(self) -> int:
        """One accumulate pass: device top-k + native leased counts ->
        the cumulative table + per-namespace pressure. Returns records
        merged."""
        records = list(self.storage.drain_hot_slots(self.top_k))
        pipeline = self.pipeline
        if pipeline is not None:
            leased = pipeline.drain_leased_usage()
            if leased:
                records.extend(self.storage.attribute_slots(leased))
        with self._lock:
            self._drains += 1
            self._last_drain_ts = self._clock()
            # Per-IDENTITY utilization within this pass: with leasing on
            # the same counter arrives twice (device drain + leased
            # attribution); counts merge additively but pressure must
            # sample each counter once, not once per record.
            pass_util: Dict[Tuple, float] = {}
            for record in records:
                key = _identity(record)
                count = int(record.get("count", 0))
                if key is None:
                    self._unattributed += count
                    continue
                row = self._counts.get(key)
                if row is None:
                    self._counts[key] = [count, record]
                else:
                    row[0] += count
                    row[1] = record
                ns = record["namespace"]
                self._ns_hits[ns] = self._ns_hits.get(ns, 0) + count
                util = float(record.get("utilization", 0.0))
                prev = pass_util.get(key)
                if prev is None or util > prev:
                    pass_util[key] = util
            ns_pressure: Dict[str, dict] = {}
            for (ns, *_rest), util in pass_util.items():
                self._util_samples.append((ns, util))
                agg = ns_pressure.setdefault(
                    ns, {"max_utilization": 0.0, "near_exhaustion": 0,
                         "sampled": 0}
                )
                agg["sampled"] += 1
                if util > agg["max_utilization"]:
                    agg["max_utilization"] = util
                if util >= self.near_threshold:
                    agg["near_exhaustion"] += 1
            if ns_pressure:
                self._ns_last = ns_pressure
            if len(self._counts) > self.max_tracked:
                # Evict the coldest half wholesale: the hot tail the
                # top-K serves is orders of magnitude above the floor.
                keep = sorted(
                    self._counts.items(), key=lambda kv: -kv[1][0]
                )[: self.max_tracked // 2]
                self._evicted += len(self._counts) - len(keep)
                self._counts = dict(keep)
        return len(records)

    # -- read surfaces -------------------------------------------------------

    def top(self, k: Optional[int] = None) -> List[dict]:
        """The K hottest counters by cumulative hits, attribution
        included (last drain's utilization sample rides along)."""
        k = self.top_k if k is None else max(int(k), 1)
        with self._lock:
            rows = sorted(
                self._counts.items(), key=lambda kv: -kv[1][0]
            )[:k]
            return [
                dict(record, hits=count)
                for _key, (count, record) in rows
            ]

    def pressure(self) -> dict:
        """Per-namespace quota pressure from the last drain plus the
        hottest namespace overall (SignalBus fields)."""
        with self._lock:
            top_ns = ""
            if self._ns_hits:
                top_ns = max(self._ns_hits.items(), key=lambda kv: kv[1])[0]
            return {
                "top_namespace": top_ns,
                "near_exhaustion": sum(
                    agg["near_exhaustion"] for agg in self._ns_last.values()
                ),
                "namespaces": {
                    ns: dict(agg) for ns, agg in self._ns_last.items()
                },
            }

    def tenant_usage(self) -> dict:
        """Summary of the observatory's state."""
        with self._lock:
            drains = self._drains
            tracked = len(self._counts)
            unattributed = self._unattributed
            evicted = self._evicted
        return {
            "drains": drains,
            "tracked_counters": tracked,
            "unattributed_hits": unattributed,
            "evicted_identities": evicted,
            "top": self.top(10),
            "pressure": self.pressure(),
        }

    def top_counters(self, k: Optional[int] = None) -> dict:
        """Drain first so no counts sit in the device accumulator, then
        the true top-K. With the lease
        tier on, each record carries its counter's live leased debit
        (``lease_outstanding`` — the broker-ledger tokens×delta still
        consumable with zero device work): the per-counter over-
        admission context next to the utilization sample."""
        self.drain()
        top = self.top(k)
        pipeline = self.pipeline
        if pipeline is not None:
            debit = pipeline.outstanding_lease_debit()
            if debit:
                for record in top:
                    outstanding = debit.get(record.get("slot"))
                    if outstanding:
                        record["lease_outstanding"] = outstanding
        return {
            "k": self.top_k if k is None else int(k),
            "top": top,
            "pressure": self.pressure(),
        }

    # -- render-time metrics poll --------------------------------------------

    def poll(self, metrics) -> None:
        """``PrometheusMetrics.attach_render_hook`` target: feed the
        ``tenant_*`` families. Hit counters are cumulative-converted per
        namespace; utilization samples drained since the last render
        feed the histogram."""
        with self._lock:
            ns_hits = dict(self._ns_hits)
            samples, self._util_samples = self._util_samples, []
            ns_last = {ns: dict(agg) for ns, agg in self._ns_last.items()}
            tracked = len(self._counts)
            top_count = max(
                (row[0] for row in self._counts.values()), default=0
            )
        for ns, seen in ns_hits.items():
            baseline_key = ("tenant_hits", ns)
            baseline = metrics._counter_baselines.get(baseline_key, 0)
            if seen > baseline:
                metrics.tenant_hits.labels(ns).inc(seen - baseline)
                metrics._counter_baselines[baseline_key] = seen
        for ns, util in samples:
            metrics.tenant_utilization.labels(ns).observe(
                min(max(util, 0.0), 2.0)
            )
        for ns, agg in ns_last.items():
            metrics.tenant_max_utilization.labels(ns).set(
                agg["max_utilization"]
            )
            metrics.tenant_near_exhaustion.labels(ns).set(
                agg["near_exhaustion"]
            )
        metrics.tenant_top_hit_count.set(top_count)
        metrics.tenant_tracked_counters.set(tracked)
