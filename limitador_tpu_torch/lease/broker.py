"""LeaseBroker: sizes, grants, reclaims and settles quota leases.

Port counterpart of ``limitador_tpu/lease/broker.py``. Credits go through
``TorchStorage.credit_columnar``, B4c's host form on the card.

One broker per native pipeline (the mirror it feeds is per pipeline
context). The hot path never sees this module: token consumption runs
inside the C hot lane's begin (csrc/hostpath.cc) with the GIL released; the
broker only runs the REFRESH pass — on its own thread at
``refresh_interval_s``, or synchronously via :meth:`refresh` (tests,
bench) — which does, in order:

1. **Drain the return ring**: tokens stranded by plan invalidation
   (slot recycling, limits-epoch bumps, size-cap clears) come back as
   ``(lease_id, tokens)``; the ledger maps them to their counters.
2. **Expiry sweep**: leases past their deadline are revoked in place
   (``hp_lease_revoke``) and their balance joins the credit batch.
3. **Credit**: one floor-guarded scatter kernel returns the unused
   debit (``TorchStorage.credit_columnar``), skipping any slot whose
   slot->counter identity changed since grant (a recycled slot's debit
   died with the cell; crediting it would pay a stranger).
4. **Grant**: candidates drained from the mirror's demand queue are
   sized (adaptive: start at observed demand, double on renewal, halve
   on denial) and debited in ONE batched device check — the same
   check-all-then-update-all kernel live traffic rides, so a grant
   past the remaining window headroom is refused atomically. Admitted
   rows attach to the mirrored plan (``hp_lease_grant``); a row whose
   plan vanished in between is credited straight back.

Lock discipline matches the begins: the native lock serializes every
mirror mutation, the storage lock spans plan-fetch -> launch (slot
liveness) and every credit's identity check. The broker never holds
both in the inverted order.

The tier demotion pre-pass (``reclaim_slots``) revokes every lease
touching the slots a TierManager round is about to demote and settles
them through the same credit lane.

A refresh pass that credited or granted anything records its duration
as the device-plane recorder's ``lease`` phase (and offers it to the
flight recorder as a ``lease-refresh`` entry).

Left out of the port for now (``ROADMAP.md``): the capacity controller's
``grant_scale`` knob.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import kernel as K
from ..device.plan_cache import PLAN_KERNEL

__all__ = ["LeaseBroker", "LeaseConfig"]

log = logging.getLogger(__name__)


class LeaseConfig:
    """Tunables of the lease tier (server flags map onto these)."""

    __slots__ = (
        "max_tokens", "hot_threshold", "ttl_s", "refresh_interval_s",
        "max_leases",
    )

    def __init__(
        self,
        max_tokens: int = 1024,
        hot_threshold: int = 8,
        ttl_s: float = 0.25,
        refresh_interval_s: float = 0.02,
        max_leases: int = 4096,
    ):
        self.max_tokens = int(max_tokens)
        self.hot_threshold = int(hot_threshold)
        self.ttl_s = float(ttl_s)
        self.refresh_interval_s = float(refresh_interval_s)
        self.max_leases = int(max_leases)


class _Lease:
    """Ledger entry: everything the credit path needs to settle unused
    tokens — per hit, the slot AND its key identity at grant time (the
    liveness check), the per-token delta, and the window/bucket shape
    the credit kernel wants."""

    __slots__ = ("lease_id", "blob", "tokens", "deadline", "hits")

    def __init__(self, lease_id: int, blob: bytes, tokens: int,
                 deadline: float, hits: Tuple):
        self.lease_id = lease_id
        self.blob = blob
        self.tokens = tokens
        self.deadline = deadline
        # hits: ((slot, key, delta_per_token, window_ms, bucket), ...)
        self.hits = hits


class LeaseBroker:
    def __init__(self, pipeline, config: Optional[LeaseConfig] = None,
                 clock=time.monotonic):
        self.pipeline = pipeline
        self.storage = pipeline.storage
        self.config = config or LeaseConfig()
        self._clock = clock
        self._leases: Dict[int, _Lease] = {}
        self._ids = itertools.count(1)
        # adaptive per-blob grant sizing + denial backoff
        self._sizes: Dict[bytes, int] = {}
        self._denied_until: Dict[bytes, float] = {}
        # cumulative Python-side counters (grant/settle live here; the
        # consume counter lives in C and is carried across context
        # swaps via _lane_base)
        self.grants = 0
        self.denials = 0
        self.granted_tokens = 0
        self.returned_tokens = 0
        self._lane_base: Dict[str, int] = {}
        self._lock = threading.Lock()  # serializes refresh passes
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: the exception that stopped the refresh thread, if one did
        self.error: Optional[BaseException] = None
        #: called with that exception from the refresh thread
        self.on_error = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Run the refresh pass on a daemon thread. ``poke`` (wired to
        the plan cache's epoch-bump hook) wakes it early so a limits
        reload's stranded tokens settle promptly."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="lease-broker", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)

    def poke(self) -> None:
        """Wake the refresh thread out of its interval sleep (epoch
        bumps route here through DecisionPlanCache.on_epoch_bump)."""
        self._wake.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.config.refresh_interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.refresh()
            except Exception as exc:
                # A failed pass (a credit kernel that does not build or
                # launch) may have revoked balances it never credited:
                # the tier stops and reports instead of serving on.
                log.exception("lease refresh failed; the lease tier stops")
                self.error = exc
                if self.on_error is not None:
                    self.on_error(exc)
                return

    # -- the refresh pass ----------------------------------------------------

    def refresh(self) -> dict:
        """One full settle+grant cycle; returns a summary (tests/bench).
        Safe to call concurrently with serving traffic — and from tests
        with the thread never started."""
        pipeline = self.pipeline
        lane = pipeline._hot_lane
        if lane is None:
            return {}
        with self._lock:
            t0 = time.perf_counter()
            now = self._clock()
            with pipeline._native_lock:
                if pipeline._hot_lane is not lane:
                    return {}  # context swapped under us; next pass
                returns: List[Tuple[int, int]] = []
                while True:
                    part = lane.lease_drain_returns()
                    returns.extend(part)
                    if len(part) < 4096:
                        break
                drained = {i for i, _t in returns}
                # Expiry sweep AFTER the full drain: a revoke that
                # returns -1 now provably means "already settled". The
                # id match keeps an expired ledger entry from revoking
                # its blob's RENEWAL lease.
                for lease_id, lease in list(self._leases.items()):
                    if lease.deadline > now:
                        continue
                    remaining = lane.lease_revoke(lease.blob, lease_id)
                    if remaining > 0:
                        returns.append((lease_id, remaining))
                    elif lease_id not in drained:
                        # consumed to zero (or settled earlier): done
                        self._leases.pop(lease_id, None)
                candidates = (
                    lane.lease_candidates()
                    if len(self._leases) < self.config.max_leases else []
                )
                epoch = (
                    pipeline.plan_cache.epoch
                    if pipeline.plan_cache is not None else 0
                )
            credited = self._settle(returns)
            granted = self._grant(lane, candidates, epoch, now)
            dt = time.perf_counter() - t0
            self._record(dt, credited, granted)
            return {
                "returns": len(returns),
                "credited_tokens": credited,
                "grants": granted,
                "duration_s": dt,
            }

    def _record(self, dt: float, credited: int, granted: int) -> None:
        """The refresh pass's ``lease`` phase: a slow settle/grant cycle
        shows beside the slow batches in ``/debug/stats``."""
        rec = self.pipeline.recorder
        if rec is None or (credited == 0 and granted == 0):
            return
        phases = {"lease": dt}
        rec.record_phases(phases)
        if rec.flight.would_admit(dt):
            rec.record_decision(
                dt, None, "lease-refresh", 0, 0.0, rec.phases_ms(phases),
            )

    def _settle(self, returns: List[Tuple[int, int]]) -> int:
        """Credit stranded/expired tokens back to their counters."""
        credits: List[Tuple[int, tuple, int, int, bool]] = []
        total = 0
        for lease_id, tokens in returns:
            lease = self._leases.pop(lease_id, None)
            if lease is None or tokens <= 0:
                continue
            total += int(tokens)
            for slot, key, d, win, bucket in lease.hits:
                credits.append((slot, key, int(tokens) * d, win, bucket))
        if total:
            self.returned_tokens += total
            self._apply_credits(credits)
        return total

    def _apply_credits(self, credits) -> None:
        if not credits:
            return
        storage = self.storage
        with storage._lock:
            # Identity check under the lock that serializes releases: a
            # slot whose key moved on since grant gets NO credit (the
            # debit died with the cell — or the slot belongs to a
            # different counter now).
            info = storage._table.info
            agg: Dict[int, list] = {}
            for slot, key, amount, win, bucket in credits:
                cur = info.get(slot)
                if cur is None or cur[0] != key:
                    continue
                row = agg.get(slot)
                if row is None:
                    agg[slot] = [amount, win, bucket]
                else:
                    row[0] += amount
            if agg:
                slots = np.fromiter(agg.keys(), np.int32, count=len(agg))
                rows = list(agg.values())
                storage.credit_columnar(
                    slots,
                    np.asarray(
                        [min(r[0], K.MAX_DELTA_CAP) for r in rows],
                        np.int32,
                    ),
                    np.asarray([r[1] for r in rows], np.int32),
                    np.asarray([r[2] for r in rows], bool),
                )

    # -- grants --------------------------------------------------------------

    def _size_for(self, blob: bytes, count: int, plan) -> int:
        cfg = self.config
        d = int(plan.delta_capped)
        if d <= 0 or plan.delta != plan.delta_capped:
            return 0  # capped addends stay exact
        target = self._sizes.get(blob)
        if target is None:
            target = max(int(count), 1)
        target = min(target, cfg.max_tokens, K.MAX_DELTA_CAP // d)
        # Tiny limits: leasing more than half the tightest max_value
        # trades too much exactness for too little speed; a zero here
        # means "this key stays exact".
        min_max = min(plan.record[1::4])
        return max(min(target, min_max // (2 * d)), 0)

    def _grant(self, lane, candidates, epoch: int, now: float) -> int:
        if not candidates:
            return 0
        pipeline = self.pipeline
        cache = pipeline.plan_cache
        storage = self.storage
        if cache is None:
            return 0
        rows: List[Tuple[bytes, object, int]] = []
        seen = set()
        for blob, count in candidates:
            if blob in seen:
                continue
            seen.add(blob)
            until = self._denied_until.get(blob)
            if until is not None and now < until:
                continue
            plan = cache.entries.get(blob)
            if plan is None or plan.kind != PLAN_KERNEL or not plan.nhits:
                continue
            tokens = self._size_for(blob, count, plan)
            if tokens > 0:
                rows.append((blob, plan, tokens))
        if not rows:
            return 0

        # One batched debit launch for every candidate — the shared
        # columnar check lane enforces the headroom bound atomically.
        slots_l: List[int] = []
        deltas_l: List[int] = []
        maxes_l: List[int] = []
        windows_l: List[int] = []
        req_l: List[int] = []
        bucket_l: List[bool] = []
        live: List[Tuple[bytes, object, int, tuple, float]] = []
        with storage._lock:
            info = storage._table.info
            for blob, plan, tokens in rows:
                if cache.entries.get(blob) is not plan:
                    continue  # invalidated since the fetch
                rec = plan.record
                d = int(plan.delta_capped)
                hits = []
                window_floor: Optional[float] = None
                for i in range(plan.nhits):
                    slot = rec[4 * i]
                    win = rec[4 * i + 2]
                    bucket = bool(rec[4 * i + 3])
                    entry = info.get(slot)
                    if entry is None:
                        break  # raced a release; skip this candidate
                    hits.append((slot, entry[0], d, win, bucket))
                    if not bucket:
                        window_floor = (
                            win / 1000.0 if window_floor is None
                            else min(window_floor, win / 1000.0)
                        )
                if len(hits) != plan.nhits:
                    continue
                r = len(live)
                for i in range(plan.nhits):
                    slots_l.append(rec[4 * i])
                    deltas_l.append(tokens * d)
                    maxes_l.append(rec[4 * i + 1])
                    windows_l.append(rec[4 * i + 2])
                    req_l.append(r)
                    bucket_l.append(bool(rec[4 * i + 3]))
                ttl = self.config.ttl_s
                if window_floor is not None:
                    ttl = min(ttl, window_floor)
                live.append((blob, plan, tokens, tuple(hits), now + ttl))
            if not live:
                return 0
            arrays = storage.pad_hits(
                (
                    np.asarray(slots_l, np.int32),
                    np.asarray(deltas_l, np.int32),
                    np.asarray(maxes_l, np.int32),
                    np.asarray(windows_l, np.int32),
                    np.asarray(req_l, np.int32),
                    np.zeros(len(slots_l), bool),  # leased slots are live
                    np.asarray(bucket_l, bool),
                ),
                len(slots_l),
            )
            inflight = storage.begin_check_columnar(*arrays)
        admitted, _hok, _rem, _ttl = storage.finish_check_columnar(
            inflight, with_remaining=False
        )

        granted = 0
        refunds: List[Tuple[int, tuple, int, int, bool]] = []
        with pipeline._native_lock:
            lane_now = pipeline._hot_lane
            for i, (blob, plan, tokens, hits, deadline) in enumerate(live):
                if not admitted[i]:
                    # No headroom: remember to try half next time, and
                    # back off this key for one ttl.
                    self.denials += 1
                    self._sizes[blob] = max(tokens // 2, 1)
                    self._denied_until[blob] = now + self.config.ttl_s
                    continue
                lease_id = next(self._ids)
                if lane_now is lane and lane.lease_grant(
                    blob, epoch, lease_id, tokens
                ):
                    self._leases[lease_id] = _Lease(
                        lease_id, blob, tokens, deadline, hits
                    )
                    self.grants += 1
                    self.granted_tokens += tokens
                    granted += 1
                    # Renewal doubles: demand that drains a lease before
                    # its ttl earns a bigger one next time.
                    self._sizes[blob] = min(
                        tokens * 2, self.config.max_tokens
                    )
                else:
                    # Plan vanished (epoch bump / eviction) between the
                    # debit and the attach: credit it straight back.
                    for slot, key, d, win, bucket in hits:
                        refunds.append((slot, key, tokens * d, win, bucket))
        if refunds:
            self._apply_credits(refunds)
        if len(self._denied_until) > 4096:
            self._denied_until.clear()
        if len(self._sizes) > (1 << 16):
            # The adaptive-sizing memo is keyed by blob BYTES: churning
            # key spaces (per-user/per-IP descriptors) would grow it
            # without bound. Restarting loses only the doubling history
            # — the next grant re-sizes from observed demand.
            self._sizes.clear()
        return granted

    # -- context swap / observability ---------------------------------------

    def on_context_swap(self, old_lane) -> None:
        """The pipeline is recycling its native context (interner cap):
        every lease dies with the old mirror — reclaim and credit them
        now, and fold the old lane's consume counter into the carried
        base. Called under the storage lock + native lock, before the
        old context is freed — deliberately NOT under the broker lock
        (refresh acquires broker -> native; taking broker here would
        invert). A refresh racing the swap is safe: ledger pops are
        atomic (no double credit), and a grant that lands after the
        swap refunds itself via the ``lane_now is lane`` check."""
        stats = old_lane.lease_stats()
        base = self._lane_base
        for key in ("leased", "grants", "granted_tokens", "ring_tokens"):
            base[key] = base.get(key, 0) + stats[key]
        returns: List[Tuple[int, int]] = list(old_lane.lease_drain_returns())
        for lease_id, lease in list(self._leases.items()):
            remaining = old_lane.lease_revoke(lease.blob, lease_id)
            if remaining > 0:
                returns.append((lease_id, remaining))
        self._settle(returns)
        self._leases.clear()

    def attach_lane(self, lane) -> None:
        """(Re-)arm a lane's consume path with this broker's config.
        Called under the native lock."""
        lane.lease_config(True, self.config.hot_threshold)

    def outstanding_by_slot(self) -> Dict[int, int]:
        """Per-slot outstanding leased DEBIT (tokens x per-token delta)
        — the over-admission bound the oracle tests assert against.
        Reads the C balances so consumption since grant is reflected."""
        pipeline = self.pipeline
        out: Dict[int, int] = {}
        with pipeline._native_lock:
            lane = pipeline._hot_lane
            if lane is None:
                return out
            for lease in self._leases.values():
                tokens = lane.lease_tokens(lease.blob, lease.lease_id)
                if tokens <= 0:
                    continue
                for slot, _key, d, _win, _bucket in lease.hits:
                    out[slot] = out.get(slot, 0) + tokens * d
        return out

    def reclaim_slots(self, slots) -> int:
        """Revoke every lease touching ``slots`` and credit the
        unconsumed tokens back through the floor-guarded columnar lane
        (B4c): the tier demotion pre-pass (tier/manager.py). Settling
        while the slot identity still matches means a demoted counter
        strands no quota and its slot's next tenant pays no dead debit.
        Returns the tokens settled. Lock order broker -> native ->
        storage, as in refresh."""
        doomed = set(slots)
        pipeline = self.pipeline
        with self._lock:
            returns: List[Tuple[int, int]] = []
            with pipeline._native_lock:
                lane = pipeline._hot_lane
                if lane is None:
                    return 0
                for lease_id, lease in list(self._leases.items()):
                    if not any(h[0] in doomed for h in lease.hits):
                        continue
                    remaining = lane.lease_revoke(lease.blob, lease_id)
                    if remaining > 0:
                        returns.append((lease_id, remaining))
                    else:
                        # consumed to zero or settled by a racing drain
                        self._leases.pop(lease_id, None)
            return self._settle(returns)

    def stats(self) -> dict:
        """Cumulative lease-tier stats: C consume counters (carried
        across context swaps) + Python grant/settle counters. Shaped
        for library_stats (metric families) and /debug/stats."""
        pipeline = self.pipeline
        with pipeline._native_lock:
            lane = pipeline._hot_lane
            lane_stats = (
                lane.lease_stats() if lane is not None else {}
            )
        base = self._lane_base
        return {
            "lease_admissions": (
                lane_stats.get("leased", 0) + base.get("leased", 0)
            ),
            "lease_grants": self.grants,
            "lease_grant_denials": self.denials,
            "lease_granted_tokens": self.granted_tokens,
            "lease_returned_tokens": self.returned_tokens,
            "lease_active": lane_stats.get("active", 0),
            "lease_outstanding_tokens": lane_stats.get("outstanding", 0),
        }
