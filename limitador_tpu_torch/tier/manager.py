"""TierManager: the heat-driven migration thread.

Port counterpart of ``limitador_tpu/tier/manager.py``. One daemon thread
owns all tier movement. Each round it:

1. Drains the cold tier's touch accumulator (the host-side mirror of
   the device table's per-slot ``hits`` column) for promotion
   candidates, hottest first.
2. Walks the device LRU from its demand-free front for demotion
   candidates when resident occupancy crosses the high watermark.
   Demand-driven eviction (TieredStorage._evict_one) still demotes
   exactly when the table fills between rounds, but a manager demotion
   settles outstanding lease tokens through the broker's floor-guarded
   credit lane (``reclaim_slots``, the B4c kernel) before the slot is
   released, so a demoted counter never strands quota or pays a dead
   debit to its slot's next tenant. The usage observatory's hot set
   (``top()``) steers demotion away from slots with live demand; the
   veto is a preference, never a block: the observatory ranks by
   cumulative hits, so on a long-lived server its top-K covers every
   slot, and the watermark must still drain from the LRU front.
3. Prices each move against the fitted serving model
   (``observability/model.py``, the ``estimator``): a cold decide costs
   one host ``row`` coefficient of wall time, a device-resident decide
   one device ``row``; promotion buys ``heat x (host_row - device_row)``
   seconds per interval. Until the model has fitted a positive ``row``,
   the measured cold-decide p50 (or a static prior) and a static device
   prior stand in, as in the JAX package.
4. Runs the two-phase moves (TieredStorage promote/demote begin/finish;
   promotions launch B4d, demotions B3a) and drains the cold write
   journal to the append-log spill OFF the storage lock, and emits a
   ``tier_migration`` event onto ``events`` (an ``events.PodEventLog``)
   when the round moved counters.

Failures are not swallowed. A round that raises after phase A pushes
both ledgers back (``migrate_abort``) and re-raises. The thread then
logs the failure with its traceback, sets ``.error``, calls
``on_error`` (the server exits 1) and stops: a failed B4c settle or B4d
seed never vanishes into a retry.

Lock order: the manager's own ``_lock`` is the outermost of everything
it touches: tier -> broker -> native -> storage. With leases, phase B
runs under the pipeline's native lock (the JAX manager releases slots
under the storage lock alone while the broker drains the lease ring
under the native lock alone). A round never holds ``_lock`` across its
interval wait, and the decision path never takes it.

The injectable ``kill_hook`` fires between phase A and phase B of each
round: raising there aborts the round with full ledger push-back
(nothing doubled, nothing lost) and returns ``aborted``; it is a test
lever, not a failure.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Callable, List, Optional

__all__ = ["TierManager"]

log = logging.getLogger(__name__)

#: static priors (seconds) for the two per-decision costs: a host
#: dict-lane decide is ~tens of µs of Python (until a cold-decide latency
#: is measured); a device-resident decide's marginal row cost is ~1 µs
#: (overlapped under the launch).
_HOST_ROW_PRIOR_S = 20e-6
_DEVICE_ROW_PRIOR_S = 1e-6

#: demote from the LRU front when qualified occupancy crosses the high
#: watermark, down to the low watermark: the headroom keeps demand-path
#: evictions (which cannot settle leases) rare.
_HIGH_WATERMARK = 0.90
_LOW_WATERMARK = 0.80


class TierManager:
    """Migration policy + thread over a :class:`TieredStorage`."""

    def __init__(
        self,
        storage,
        broker=None,
        estimator=None,
        events=None,
        observatory=None,
        interval_s: float = 2.0,
        batch: int = 256,
    ):
        self.storage = storage
        self.broker = broker
        self.estimator = estimator
        self.events = events
        self.observatory = observatory
        self.interval_s = max(float(interval_s), 0.05)
        self.batch = max(int(batch), 1)
        self._lock = threading.Lock()  # domain: tier
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # round accounting (tier_* families / tiering_debug)
        self.rounds = 0
        self.promoted = 0
        self.demoted = 0
        self.aborted = 0
        self.last_benefit_s = 0.0
        self.backlog = 0
        self._prom_base: dict = {}
        #: test lever: called between phase A and phase B of each round;
        #: raising simulates a mid-migration death (the round aborts and
        #: the ledgers push back).
        self.kill_hook: Optional[Callable[[], None]] = None
        #: the exception that stopped the migration thread, if one did
        self.error: Optional[BaseException] = None
        #: called with that exception from the migration thread
        self.on_error = None

    # -- pricing -----------------------------------------------------------

    def _row_costs(self) -> tuple:
        """(host_row_s, device_row_s): the fitted ``row`` coefficients
        where the model has them positive, else the measured
        cold-decide p50 (or its prior) and the device prior."""
        host_s = device_s = 0.0
        est = self.estimator
        if est is not None:
            coeff = est.coefficients()
            host_s = float(coeff["host"]["row"])
            device_s = float(coeff["device"]["row"])
        if host_s <= 0.0:
            p50_ms = self.storage.tier_stats()["cold_decide_p50_ms"]
            host_s = (p50_ms / 1000.0) if p50_ms > 0 else _HOST_ROW_PRIOR_S
        if device_s <= 0.0:
            device_s = _DEVICE_ROW_PRIOR_S
        return host_s, device_s

    # -- one migration round -----------------------------------------------

    def run_once(self) -> dict:
        """One migration round (also the test and drive entry point:
        drive it inline with no thread). Returns the round's
        accounting."""
        with self._lock:
            return self._round()

    def _candidates(self, storage, resident: int, cap: int):
        """(promo_keys, benefit_s, demo_keys, want_out) for one round."""
        host_row_s, device_row_s = self._row_costs()
        margin_s = host_row_s - device_row_s

        # Promotion candidates: hottest cold keys since the last round,
        # bounded by free device headroom: a promotion that forces an
        # eviction just churns the LRU, so a full table promotes nothing
        # until demotions (below) open room. The drain is read-and-reset,
        # so skipped candidates re-accumulate heat and return next round.
        headroom = max(int(cap * _HIGH_WATERMARK) - resident, 0)
        hot = storage.cold_hot_candidates(min(self.batch, headroom))
        promo_keys = [key for key, heat in hot if heat * margin_s > 0.0]
        benefit_s = sum(heat for _k, heat in hot) * margin_s

        # Demotion candidates: LRU front, only above the high watermark,
        # minus the observatory's live hot set.
        demo_keys: List[tuple] = []
        want_out = 0
        if resident > cap * _HIGH_WATERMARK:
            want_out = min(
                resident - int(cap * _LOW_WATERMARK), self.batch
            )
        if want_out > 0:
            obs = self.observatory
            hot_slots = (
                {r.get("slot") for r in obs.top(self.batch)}
                if obs is not None else set()
            )
            vetoed: List[tuple] = []
            for key in storage.demotion_candidates(want_out + len(hot_slots)):
                if storage.slot_of(key) in hot_slots:
                    vetoed.append(key)
                    continue
                demo_keys.append(key)
                if len(demo_keys) >= want_out:
                    break
            # The veto is a preference, not a block: fill the shortfall
            # from the vetoed LRU front (a key sits at the front
            # precisely because it is not live, whatever its lifetime hit
            # count says).
            if len(demo_keys) < want_out:
                demo_keys.extend(vetoed[: want_out - len(demo_keys)])
        return promo_keys, benefit_s, demo_keys, want_out

    def _round(self) -> dict:
        storage = self.storage
        stats = storage.tier_stats()
        cap = max(storage._cache_size, 1)
        promo_keys, benefit_s, demo_keys, want_out = self._candidates(
            storage, stats["device_resident"], cap
        )

        # Phase A: ledger both directions.
        promo_accepted = storage.promote_begin(promo_keys)
        demo_accepted = storage.demote_begin(demo_keys)

        kill = self.kill_hook
        if kill is not None:
            try:
                kill()
            except Exception:
                storage.migrate_abort()
                self.aborted += 1
                self.rounds += 1
                self.backlog = len(promo_keys) + len(demo_keys)
                return {"aborted": True, "promoted": 0, "demoted": 0}

        try:
            # Demotions settle outstanding lease tokens BEFORE the slot
            # is released: broker credits flow through the floor-guarded
            # columnar lane while the slot identity still matches.
            if demo_accepted and self.broker is not None:
                slots = [
                    s for s in (storage.slot_of(k) for k in demo_accepted)
                    if s is not None
                ]
                if slots:
                    self.broker.reclaim_slots(slots)

            # Phase B: re-read absolute state, move, flip residency. A
            # released slot drops its mirrored plans, and a dropped plan
            # returns its lease tokens to the C lane's ring, which the
            # broker drains under the pipeline's native lock only: phase
            # B takes that lock too (native -> storage, the begins'
            # order), after the reclaim has released the broker's.
            with self._native_lock():
                promoted = storage.promote_finish(promo_accepted)
                demoted = storage.demote_finish(demo_accepted)
        except BaseException:
            # Whatever phase B did not reach stays in its source tier.
            storage.migrate_abort()
            raise

        # Spill the cold write journal (serialization off the lock).
        rows = storage.drain_cold_journal()
        if rows:
            storage.spill_cold_rows(rows)

        self.rounds += 1
        self.promoted += promoted
        self.demoted += demoted
        self.last_benefit_s = round(benefit_s, 9)
        self.backlog = max(
            len(promo_keys) - promoted, 0
        ) + max(want_out - demoted, 0)
        events = self.events
        if events is not None and (promoted or demoted):
            events.emit(
                "tier_migration",
                promoted=promoted,
                demoted=demoted,
                backlog=self.backlog,
                benefit_s=self.last_benefit_s,
            )
        return {"aborted": False, "promoted": promoted, "demoted": demoted}

    def _native_lock(self):
        """The lease broker's pipeline lock, or no lock without leases."""
        broker = self.broker
        if broker is None:
            return contextlib.nullcontext()
        return broker.pipeline._native_lock

    # -- thread ------------------------------------------------------------

    def start(self) -> "TierManager":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="tier-manager", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval_s)  # no lock held across the wait
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.run_once()
            except Exception as exc:
                # A failed round (a B4c settle or a B4d seed that did not
                # launch) stops the tier instead of retrying silently.
                log.exception("tier migration round failed; the tier "
                              "manager stops")
                self.error = exc
                if self.on_error is not None:
                    self.on_error(exc)
                return

    def poke(self) -> None:
        self._wake.set()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "rounds": self.rounds,
                "promoted": self.promoted,
                "demoted": self.demoted,
                "aborted": self.aborted,
                "backlog": self.backlog,
                "last_benefit_s": self.last_benefit_s,
                "interval_s": self.interval_s,
            }

    def tiering_debug(self) -> dict:
        """Manager accounting + the storage's per-tier residency and
        latency stats + the live pricing terms (the JAX server's
        ``/debug/tiering`` body; the port's HTTP API is a later slice)."""
        out = self.stats()
        out.update(self.storage.tier_stats())
        host_row_s, device_row_s = self._row_costs()
        out["host_row_s"] = round(host_row_s, 9)
        out["device_row_s"] = round(device_row_s, 9)
        return out

    def _increment(self, family, name: str, value: int, *labels) -> None:
        """Feed a cumulative count to a Prometheus counter as the
        increment since the last render."""
        prev = self._prom_base.get(name, 0)
        if value > prev:
            target = family.labels(*labels) if labels else family
            target.inc(value - prev)
            self._prom_base[name] = value

    def poll(self, metrics) -> None:
        """Render-hook protocol (duck-typed: any object with the
        ``tier_*`` families as prometheus_client-style attributes):
        feed the gauges, the counters as increments against kept
        baselines, and the cold-decide histogram. Families the object
        lacks are skipped."""
        stats = self.storage.tier_stats()
        resident = getattr(metrics, "tier_resident", None)
        if resident is not None:
            resident.labels("device").set(stats["device_resident"])
            resident.labels("cold").set(stats["cold"]["resident"])
        backlog = getattr(metrics, "tier_migration_backlog", None)
        if backlog is not None:
            backlog.set(self.backlog)
        benefit = getattr(metrics, "tier_decision_benefit", None)
        if benefit is not None:
            benefit.set(self.last_benefit_s)
        migrations = getattr(metrics, "tier_migrations", None)
        if migrations is not None:
            self._increment(migrations, "promote", self.promoted, "promote")
            self._increment(migrations, "demote", self.demoted, "demote")
        spilled = getattr(metrics, "tier_cold_spilled", None)
        if spilled is not None:
            self._increment(spilled, "spilled", stats["cold"]["spilled"])
        decide = getattr(metrics, "tier_cold_decide_seconds", None)
        if decide is not None:
            for dt in self.storage.drain_cold_decide_samples():
                decide.observe(dt)
