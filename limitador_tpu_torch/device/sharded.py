"""TorchShardedStorage: the sharded counter table of the port.

Counterpart of ``limitador_tpu/tpu/sharded.py`` (``TpuShardedStorage``).
The JAX storage splits its table over the devices of a mesh; here the n
shards are the rows of one int32[n, L+1] tensor per column on one card
(``parallel/mesh.py``), and every program the JAX storage runs under
``shard_map`` is one hand-written kernel over all rows:

- the host routes each counter to its owner shard by
  ``crc32(repr(counter_key)) % n`` (``routing.py``, byte-identical with
  the JAX package's routing), through a bounded memo;
- namespaces in ``global_namespaces`` live in the global region: one slot
  below ``global_region`` on every row, each row a partial count, the
  admission base the sum of the live partials (a delta lands on one row,
  round-robin). Over-admission for those is bounded by one in-flight
  batch per other row, the JAX storage's contract;
- each ``check_many`` batch is one B7a launch over [n, H] hit columns,
  in one of four variants the staging pass picks: *lean* (every
  request's device hits on one row, row-local request ids, no coupling),
  *coupled* (some request spans rows: a grid-wide AND of the rows' votes
  in every sweep), and either with the global pre-pass when a global hit
  is in the batch (counted as ``global``). ``launch_stats`` counts them.
- Reports and ``apply_deltas`` are one B7c host-form launch (the
  storage's list of entries by value, sorted by cell in the kernel) and
  one B3a host-form read of the touched cells through a second context
  over the flattened table, and the usage observatory's
  ``drain_hot_slots`` one B7d host-form launch (the answers in the
  context's mapped buffer) plus cell reads.
- Cell clears (a recycled or deleted local cell, an evicted or released
  global slot on every row) are decided in the JAX storage's order but
  staged, and launched as one B7b from the host list (the kernel's
  parameter block, through the table's bound context) before anything
  next touches the table: every device access enters ``_on_device``,
  which launches them first, and every public call ends by launching
  what it staged (``_ClearingLock``). A staging pass that evicts a
  thousand global slots makes one B7b, where the JAX storage makes a
  thousand; clears commute and are idempotent, so every launch and read
  sees the table the JAX storage's order leaves.

Host reads of single cells and of the global columns (``get_counters``,
``is_within_limits``, the drain's attribution) are plain tensor
indexing, as the JAX storage's ``np.asarray(state.values[sh, sl])``
outside any jit; so is the checkpoint restore's scatter.

Device and streams follow ``TorchStorage``: ``device=None`` is the card
and raises without CUDA, ``device="cpu"`` runs the kernels' plain
versions, and on the card every upload, launch and download goes on the
storage's own stream. ``begin_check_many``/``finish_check_many`` split a
launch from its download, so the micro-batcher pipelines sharded batches
as it does single-table ones. Each batch uploads two pinned host buffers
(the five int32 [n, H] columns, the three bool ones).
"""

from __future__ import annotations

import time
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core.counter import Counter
from ..core.limit import Limit
from ..ops import kernel as K
from ..parallel import mesh as M
from ..routing import RouteMemo, counter_key, stable_hash
from ..storage.base import (
    Authorization,
    CounterStorage,
    StorageError,
    require_nonnegative_delta,
)
from ..storage.gcra import GcraValue, restore_cell, spent_tokens
from .storage import (
    TorchStorage,
    _BigLimitMixin,
    _bucket,
    _partition_positions,
    _Request,
    _scatter_rows,
    _SlotTable,
    cell_rows,
    hot_attribution,
    resolve_device,
)

__all__ = [
    "TorchShardedStorage",
    "LAUNCH_VARIANTS",
    "snapshot_manifest",
    "snapshot_items",
    "METRIC_FAMILIES",
]

#: the sharded table's families, as the JAX package
#: registers them (the analysis gate holds them to
#: observability/metrics.py)
METRIC_FAMILIES = (
    "sharded_launches",
    "sharded_route_memo_hits",
    "sharded_route_memo_misses",
    "sharded_route_memo_evictions",
    "sharded_route_memo_size",
)

#: ``launch_stats()["sharded_launches"]`` keys: lean = no coupling and no
#: global region, coupled = rows coupled by the vote AND, global = the
#: global region's pre-pass in the launch (coupled or not).
LAUNCH_VARIANTS = ("lean", "coupled", "global")

_INT32_MAX = int(np.iinfo(np.int32).max)


class _ShardedHandle:
    """In-flight sharded batch: launched, its results on their way to the
    host. Carries the flat staging columns so that the decode is a
    vectorized gather."""

    __slots__ = (
        "requests", "host", "ready", "coupled", "seq", "now", "shard_ids",
        "pos", "slot_col", "glob_col", "j_l", "starts", "adjust_by_req",
        "home", "local_ids", "fresh_by_req", "big_by_req", "big_projected",
        "watch_touches",
    )

    def __init__(self, requests, host, ready, coupled, seq, now, shard_ids,
                 pos, slot_col, glob_col, j_l, starts, adjust_by_req, home,
                 local_ids, fresh_by_req, big_by_req, big_projected,
                 watch_touches):
        self.requests = requests
        # (admitted, hit_ok, remaining, ttl_ms), pinned on the card
        self.host = host
        self.ready = ready          # CUDA event after the copies, or None
        self.coupled = coupled
        self.seq = seq
        self.now = now
        self.shard_ids = shard_ids
        self.pos = pos
        self.slot_col = slot_col
        self.glob_col = glob_col
        self.j_l = j_l
        self.starts = starts
        self.adjust_by_req = adjust_by_req
        self.home = home            # lean: owner row per request
        self.local_ids = local_ids  # lean: row-local request id
        self.fresh_by_req = fresh_by_req
        self.big_by_req = big_by_req
        self.big_projected = big_projected
        self.watch_touches = watch_touches


class _ClearingLock:
    """The storage's re-entrant lock. Leaving its outermost hold launches
    the clears the call staged (``owner._flush_clears``), so that every
    public call leaves the table as the JAX storage's calls leave
    theirs."""

    __slots__ = ("_lock", "_depth", "_owner")

    def __init__(self, owner):
        self._lock = threading.RLock()
        self._depth = 0
        self._owner = owner

    def __enter__(self):
        self._lock.acquire()
        self._depth += 1
        return self

    def __exit__(self, *exc):
        try:
            if self._depth == 1:
                self._owner._flush_clears()
        finally:
            self._depth -= 1
            self._lock.release()


class TorchShardedStorage(_BigLimitMixin, CounterStorage):
    supports_token_bucket = True  # device bucket lane / exact host path

    SNAPSHOT_FORMAT = "limitador_tpu_torch/sharded/1"

    # The storage stream discipline and the checkpoint reader are
    # TorchStorage's.
    _upload = TorchStorage._upload
    _download = TorchStorage._download
    _start_download = TorchStorage._start_download
    read_snapshot = classmethod(TorchStorage.read_snapshot.__func__)

    def _is_big(self, counter: Counter) -> bool:
        # A TAT cell cannot be a summed partial: token buckets in global
        # namespaces stay on the exact host path.
        if (
            counter.limit.policy == "token_bucket"
            and counter.namespace in self._global_ns
        ):
            return True
        return _BigLimitMixin._is_big(self, counter)

    def __init__(
        self,
        n_shards: Optional[int] = None,
        local_capacity: int = 1 << 17,
        cache_size: Optional[int] = None,
        global_namespaces: Sequence[str] = (),
        global_region: int = 1024,
        clock=time.time,
        device=None,
    ):
        """``n_shards`` rows (default: one per visible card, 1 on the
        CPU) of ``local_capacity`` cells each (12 bytes a cell); slots
        below ``global_region`` are the global region. ``cache_size`` caps
        qualified counters over all rows. ``device`` is the card unless
        "cpu" is asked for."""
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = (
            torch.cuda.Stream(self._device) if self._cuda else None
        )
        if n_shards is None:
            n_shards = torch.cuda.device_count() if self._cuda else 1
        self._n = int(n_shards)
        if self._n < 1:
            raise ValueError("n_shards must be >= 1")
        if global_region >= local_capacity:
            raise ValueError("global_region must be < local_capacity")
        self._lock = _ClearingLock(self)
        # Clears decided and not launched yet (insertion-ordered sets):
        # (row, slot) pairs, and slots of every row.
        self._clear_pairs: Dict[Tuple[int, int], None] = {}
        self._clear_all: Dict[int, None] = {}
        self._clock = clock
        self._local_capacity = int(local_capacity)
        self._global_region = int(global_region)
        self._global_ns = set(global_namespaces)
        total_local = self._n * (local_capacity - global_region)
        self._cache_size = int(cache_size) if cache_size else total_local
        self._per_shard_cache = max(self._cache_size // self._n, 1)
        self._scratch = self._local_capacity  # padding slot (column L)
        self._tables: List[_SlotTable] = []
        self._gtable = _SlotTable(self._global_region)
        self._rr = 0  # round-robin row for global-counter deltas
        self._shard_memo = RouteMemo(4 * self._cache_size)
        # Pipelining bookkeeping: batch seq and last-touch seq of watched
        # slots, keyed (shard, slot), (-1, slot) for the global region.
        self._seq = 0
        self._watched: Dict[Tuple[int, int], int] = {}
        self._launches: Dict[str, int] = dict.fromkeys(LAUNCH_VARIANTS, 0)
        self._init_big(self._cache_size)
        self._reset_tables()
        with self._on_device():
            self._state = M.make_sharded_table(
                self._n, self._local_capacity, self._device)
        self._epoch = clock()
        #: the checkpoint manifest a pod sets (owned shard range and
        #: topology); None on one process
        self.snapshot_meta: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def _state(self):
        """The table. Every assignment binds TorchStorage's launch
        context (``_ctx``, the [n, L+1] columns: B7b, B7c) and a second
        one over the same columns flattened to one row of n * (L + 1)
        cells (``_flat_ctx``: B3a's host form reads any cell by its flat
        index, row * (L + 1) + slot), and closes the ones it replaces."""
        return self._ctx.state

    @_state.setter
    def _state(self, state) -> None:
        TorchStorage._state.fset(self, state)
        old = self.__dict__.get("_flat_ctx")
        self._flat_ctx = K.TableContext(
            K.CounterTableState(*(t.view(-1) for t in state)), self._stream)
        if old is not None:
            old.close()

    @property
    def n_shards(self) -> int:
        return self._n

    def _reset_tables(self) -> None:
        self._tables = []
        for _ in range(self._n):
            t = _SlotTable(self._local_capacity)
            # Shard-local slots live in [global_region, local_capacity).
            t.free = list(
                range(self._local_capacity - 1, self._global_region - 1, -1)
            )
            self._tables.append(t)
        self._gtable = _SlotTable(self._global_region)

    # -- time ---------------------------------------------------------------

    def _now_ms(self) -> int:
        now = int((self._clock() - self._epoch) * 1000)
        if now > (1 << 30):
            # Rebase before now_ms + WINDOW_MS_CAP could overflow int32:
            # B4a over the whole [n, L+1] expiry, flattened.
            shift = now - 1000
            with self._on_device():
                K.rebase_epoch_chunked(self._state.expiry_ms.view(-1), shift)
            self._epoch += shift / 1000.0
            now -= shift
        return now

    # -- device access (caller holds the lock) ------------------------------

    def _on_device(self):
        """TorchStorage's device context, entered after the staged clears
        are launched: every device access of this storage comes here
        first, so no launch or read sees a cell a clear is owed to."""
        self._flush_clears()
        return TorchStorage._stream_scope(self)

    def _flush_clears(self) -> None:
        """Launch the staged clears as one B7b from the host list (more
        launches only past one parameter block): the all-rows form when
        only global slots are staged, (row, slot) pairs otherwise."""
        if not (self._clear_pairs or self._clear_all):
            return
        if self._clear_pairs:
            pairs = list(self._clear_pairs)
            pairs += [(r, s) for s in self._clear_all for r in range(self._n)]
            entries = np.asarray(pairs, np.int32).reshape(-1)
            all_rows = False
        else:
            entries = np.fromiter(self._clear_all, np.int32,
                                  len(self._clear_all))
            all_rows = True
        M.sharded_clear_cells_host(self._ctx, entries, all_rows)
        self._clear_pairs.clear()
        self._clear_all.clear()

    def _read_cells(self, shards, slots) -> Tuple[np.ndarray, np.ndarray]:
        """(values, expiry) host arrays of the cells (shards[i],
        slots[i])."""
        with self._on_device():
            sh, sl = self._upload(np.asarray(shards, np.int64),
                                  np.asarray(slots, np.int64))
            return tuple(self._download(self._state.values[sh, sl],
                                        self._state.expiry_ms[sh, sl]))

    def _read_columns(self, slots) -> Tuple[np.ndarray, np.ndarray]:
        """(values, expiry) host arrays [n, m] of columns ``slots`` on
        every row (the global region's partials)."""
        with self._on_device():
            (sl,) = self._upload(np.asarray(slots, np.int64))
            return tuple(self._download(self._state.values[:, sl],
                                        self._state.expiry_ms[:, sl]))

    # -- slot routing -------------------------------------------------------

    _key_of = staticmethod(counter_key)

    def _is_global(self, counter: Counter) -> bool:
        return counter.namespace in self._global_ns

    def _zero_global_slots(self, slots: List[int]) -> None:
        """A recycled global slot must not inherit stale partials on any
        row (the pre-pass sums the whole global region): staged for the
        next B7b."""
        self._clear_all.update(dict.fromkeys(slots))

    def _evict_local(self, table: _SlotTable) -> None:
        if not table.qualified:
            raise StorageError("shard table full (no evictable slots)")
        key, slot = next(iter(table.qualified.items()))
        table.release(slot, key, qualified=True)
        table.evictions += 1

    def _evict_global(self) -> None:
        if not self._gtable.qualified:
            raise StorageError("global region full (no evictable slots)")
        key, slot = next(iter(self._gtable.qualified.items()))
        self._gtable.release(slot, key, qualified=True)
        self._gtable.evictions += 1
        self._zero_global_slots([slot])

    def _slot_for(
        self, counter: Counter, create: bool
    ) -> Tuple[Optional[int], Optional[int], bool, bool]:
        """Return (shard, slot, fresh, is_global). Global counters return
        shard=None (the caller picks an application row)."""
        key = self._key_of(counter)
        qualified = counter.is_qualified()
        if self._is_global(counter):
            slot = self._gtable.lookup(key, qualified)
            if slot is not None:
                return None, slot, False, True
            if not create:
                return None, None, False, True
            full = len(self._gtable.qualified) >= self._global_region
            if qualified and full:
                self._evict_global()
            if not self._gtable.free:
                self._evict_global()
            slot = self._gtable.alloc()
            if qualified:
                self._gtable.qualified[key] = slot
            else:
                self._gtable.simple[key] = slot
            self._gtable.info[slot] = (key, counter.key())
            return None, slot, True, True
        shard = self._shard_memo.get(key)
        if shard is None:
            shard = stable_hash(key) % self._n
            self._shard_memo.put(key, shard)
        table = self._tables[shard]
        slot = table.lookup(key, qualified)
        if slot is not None:
            return shard, slot, False, False
        if not create:
            return shard, None, False, False
        if qualified:
            while len(table.qualified) >= self._per_shard_cache:
                self._evict_local(table)
        if not table.free:
            self._evict_local(table)
        slot = table.alloc()
        if qualified:
            table.qualified[key] = slot
        else:
            table.simple[key] = slot
        table.info[slot] = (key, counter.key())
        return shard, slot, True, False

    def _app_shard(self) -> int:
        """Application row of a global-counter delta (any row works, the
        read is the sum); round-robin spreads the partials."""
        s = self._rr
        self._rr = (self._rr + 1) % self._n
        return s

    def launch_stats(self) -> dict:
        """Cumulative launches per variant (``sharded_launches``) and the
        route memo's hit/miss/eviction/size counters."""
        with self._lock:
            stats = {"sharded_launches": dict(self._launches)}
            stats.update(self._shard_memo.stats())
            return stats

    def device_stats(self) -> dict:
        """Per-shard table stats: one entry per row (capacity = the
        row-local slot range) plus the global region."""
        with self._lock:
            shards = [{
                "shard": str(i),
                "occupied": len(t.info),
                "capacity": self._local_capacity - self._global_region,
                "evictions": t.evictions,
                "collisions": t.collisions,
            } for i, t in enumerate(self._tables)]
            if self._global_region:
                shards.append({
                    "shard": "global",
                    "occupied": len(self._gtable.info),
                    "capacity": self._global_region,
                    "evictions": self._gtable.evictions,
                    "collisions": self._gtable.collisions,
                })
            return {"shards": shards}

    def drain_hot_slots(self, k: int = 64) -> List[dict]:
        """Heavy-hitter drain (the usage observatory): one B7d host-form
        call (``sharded_drain_top_hits_host``: one launch over the rows,
        each row's top k answered into the bound context's mapped buffer,
        the hit accumulator zeroed), then attribution
        through the per-row slot tables. A global counter's traffic lands
        in each row it was applied on; those counts merge here by slot
        and are attributed with the summed value. Returns the merged
        records hottest first (at most k)."""
        if k <= 0:
            return []
        with self._lock:
            now_ms = self._now_ms()
            kk = min(int(k), self._local_capacity)
            with self._on_device():
                counts, slots = M.sharded_drain_top_hits_host(self._ctx, kk)
            out: List[dict] = []
            g_counts: Dict[int, int] = {}
            loc_sh: List[int] = []
            loc_sl: List[int] = []
            loc_count: List[int] = []
            for s in range(self._n):
                for j in range(counts.shape[1]):
                    c = int(counts[s, j])
                    if c <= 0:
                        continue
                    slot = int(slots[s, j])
                    if slot < self._global_region:
                        g_counts[slot] = g_counts.get(slot, 0) + c
                    else:
                        loc_sh.append(s)
                        loc_sl.append(slot)
                        loc_count.append(c)
            if loc_sl:
                vals, exps = self._read_cells(loc_sh, loc_sl)
                for i, (shard, slot) in enumerate(zip(loc_sh, loc_sl)):
                    record = {
                        "slot": slot, "shard": shard,
                        "count": loc_count[i],
                    }
                    entry = self._tables[shard].info.get(slot)
                    if entry is not None:
                        ttl = max(int(exps[i]) - now_ms, 0)
                        value = int(vals[i]) if ttl > 0 else 0
                        record.update(hot_attribution(entry[1], value, ttl))
                    out.append(record)
            if g_counts:
                gsl = np.asarray(sorted(g_counts), np.int32)
                gvals, gexps = self._read_columns(gsl)
                live = gexps > now_ms
                value_sum = (gvals * live).sum(axis=0)
                ttls = np.maximum(gexps.max(axis=0) - now_ms, 0)
                for i, slot in enumerate(gsl.tolist()):
                    record = {
                        "slot": int(slot), "shard": "global",
                        "count": g_counts[int(slot)],
                    }
                    entry = self._gtable.info.get(int(slot))
                    if entry is not None:
                        record.update(hot_attribution(
                            entry[1], int(value_sum[i]), int(ttls[i])
                        ))
                    out.append(record)
            out.sort(key=lambda r: -r["count"])
            return out[:kk]

    # -- the shared batched check path --------------------------------------

    def begin_check_many(self, requests: List[_Request]) -> _ShardedHandle:
        """Stage, partition per row and launch one batch without waiting
        for its results. Table mutations serialize under the lock in call
        order, which is also the order of the storage stream.

        Staging classifies the batch: ``coupled`` when some request's
        device hits span rows, ``has_global`` when a hit lands in the
        global region; otherwise it is the lean variant with row-local
        request ids. Counters whose max_value is beyond the device cap
        are decided on the host here, as in ``TorchStorage``."""
        for request in requests:
            require_nonnegative_delta(request.delta)
        n = self._n
        shard_l: List[int] = []
        slot_l: List[int] = []
        delta_l: List[int] = []
        max_l: List[int] = []
        win_l: List[int] = []
        req_l: List[int] = []
        fresh_l: List[bool] = []
        bucket_l: List[bool] = []
        glob_l: List[bool] = []
        j_l: List[int] = []
        with self._lock:
            now_ms = self._now_ms()
            now = self._clock()
            self._seq += 1
            seq = self._seq
            watched = self._watched
            watch_touches: List[Tuple[int, int]] = []
            fresh_by_req: List[List[Tuple[int, Counter, int, int, bool]]] = []
            big_by_req: List[list] = []
            big_projected: List[Tuple[tuple, int]] = []
            starts: List[int] = []      # flat-hit range start per request
            adjust_by_req: List[int] = []
            home_l: List[int] = []      # owner row per request (-1 none)
            coupled = False
            slot_for = self._slot_for
            lane_of = self._lane_of
            is_big = self._is_big
            for r, request in enumerate(requests):
                starts.append(len(slot_l))
                raw_delta = int(request.delta)
                delta = min(raw_delta, K.MAX_DELTA_CAP)
                bigs, big_failed, projected = self._eval_big_hits(
                    request.ordered, raw_delta, now
                )
                big_projected.extend(projected)
                dev_delta = 0 if big_failed else delta
                adjust_by_req.append(delta if big_failed else 0)
                home = -1
                fresh_hits: List[Tuple[int, Counter, int, int, bool]] = []
                for j, c in enumerate(request.ordered):
                    if is_big(c):
                        continue
                    shard, slot, is_fresh, is_g = slot_for(c, create=True)
                    if is_g:
                        shard = self._app_shard()
                    if home < 0:
                        home = shard
                    elif shard != home:
                        coupled = True
                    win, is_bucket = lane_of(c)
                    shard_l.append(shard)
                    slot_l.append(slot)
                    delta_l.append(dev_delta)
                    max_l.append(min(c.max_value, K.MAX_VALUE_CAP))
                    win_l.append(win)
                    req_l.append(r)
                    fresh_l.append(is_fresh)
                    bucket_l.append(is_bucket)
                    glob_l.append(is_g)
                    j_l.append(j)
                    wkey = (-1, slot) if is_g else (shard, slot)
                    if is_fresh:
                        fresh_hits.append((j, c, shard, slot, is_g))
                        watched[wkey] = seq
                        watch_touches.append(wkey)
                    elif wkey in watched:
                        # A later batch re-used a slot an earlier in-flight
                        # batch may want to release: the re-use wins.
                        watched[wkey] = seq
                        watch_touches.append(wkey)
                home_l.append(home)
                fresh_by_req.append(fresh_hits)
                big_by_req.append(bigs)
            starts.append(len(slot_l))

            R = len(requests)
            shard_ids = np.asarray(shard_l, np.int32)
            counts, pos = _partition_positions(shard_ids, n)
            max_count = int(counts.max(initial=0))
            if coupled:
                # n*H must cover every request id (big-only requests
                # still take an id, with no device hit).
                H = _bucket(max(max_count, (R + n - 1) // n, 1))
                req_col = np.asarray(req_l, np.int32)
                req_fill = n * H - 1
                home = local_ids = None
            else:
                H = _bucket(max(max_count, 1))
                # Row-local request ids, dense per row, in request order.
                home = np.asarray(home_l, np.int32)
                mask = home >= 0
                local_ids = np.full(R, H - 1, np.int32)
                if mask.any():
                    _lc, lpos = _partition_positions(home[mask], n)
                    local_ids[mask] = lpos.astype(np.int32)
                req_col = local_ids[np.asarray(req_l, np.intp)]
                req_fill = H - 1
            slot_col = np.asarray(slot_l, np.int32)
            glob_col = np.asarray(glob_l, bool)
            has_global = bool(glob_col.any())
            cols = _scatter_rows(shard_ids, pos, n, H, (
                (slot_col, self._scratch, np.int32),
                (delta_l, 0, np.int32),
                (max_l, _INT32_MAX, np.int32),
                (win_l, 0, np.int32),
                (req_col, req_fill, np.int32),
                (fresh_l, False, bool),
                (bucket_l, False, bool),
                (glob_col, False, bool),
            ))
            try:
                with self._on_device():
                    d_ints, d_flags = self._upload(np.stack(cols[:5]),
                                                   np.stack(cols[5:]))
                    _, result = M.sharded_check_and_update(
                        self._state, *d_ints, *d_flags, now_ms,
                        global_region=self._global_region,
                        coupled=coupled, has_global=has_global,
                    )
                    host, ready = self._start_download(*result)
            except BaseException:
                # Projection reservations must not leak on a failed launch.
                self._unproject_big(big_projected)
                raise
            self._launches[
                "global" if has_global
                else ("coupled" if coupled else "lean")
            ] += 1
        return _ShardedHandle(
            requests, host, ready, coupled, seq, now, shard_ids, pos,
            slot_col, glob_col, np.asarray(j_l, np.int32),
            np.asarray(starts, np.intp), adjust_by_req, home, local_ids,
            fresh_by_req, big_by_req, big_projected, watch_touches,
        )

    def finish_check_many(
        self, handle: _ShardedHandle
    ) -> List[Authorization]:
        """Wait for and decode one in-flight batch: load_counters side
        effects, first-limited naming, and the non-load early-return slot
        release (guarded by the watched-slot seq so that a later in-flight
        batch's re-use of the slot wins)."""
        try:
            if handle.ready is not None:
                handle.ready.synchronize()
            admitted, hit_ok, remaining, ttl_ms = (
                t.numpy() for t in handle.host)
        except BaseException:
            with self._lock:
                self._unproject_big(handle.big_projected)
                watched = self._watched
                for wkey in handle.watch_touches:
                    if watched.get(wkey) == handle.seq:
                        del watched[wkey]
            raise

        requests = handle.requests
        shard_ids, pos = handle.shard_ids, handle.pos
        starts = handle.starts
        j_l = handle.j_l
        R = len(requests)
        ok_flat = hit_ok[shard_ids, pos]
        rem_flat = ttl_flat = None
        if any(request.load for request in requests):
            rem_flat = remaining[shard_ids, pos]
            ttl_flat = ttl_ms[shard_ids, pos]
        if handle.coupled:
            adm_by_req = admitted[:R]
        else:
            adm_by_req = np.ones(R, bool)
            mask = handle.home >= 0
            if mask.any():
                adm_by_req[mask] = admitted[
                    handle.home[mask], handle.local_ids[mask]
                ]
        use_counts = None  # computed lazily, only when a release is due

        auths: List[Authorization] = []
        big_applies: List[Tuple[tuple, int, int]] = []
        releases: List[Tuple[Counter, int, int, bool]] = []
        for r, request in enumerate(requests):
            s0, s1 = int(starts[r]), int(starts[r + 1])
            bigs = handle.big_by_req[r]
            dev_ok = bool(adm_by_req[r]) if s1 > s0 else True
            big_ok = all(ok for _j, ok, *_rest in bigs)
            if request.load:
                adjust = handle.adjust_by_req[r]
                for i in range(s0, s1):
                    c = request.ordered[int(j_l[i])]
                    c.remaining = max(int(rem_flat[i]) - adjust, 0)
                    c.expires_in = float(ttl_flat[i]) / 1000.0
                for j, _ok, rem, ttl, _key, _c, _d in bigs:
                    c = request.ordered[j]
                    c.remaining = rem
                    c.expires_in = ttl
            if dev_ok and big_ok:
                auths.append(Authorization.OK)
                for _j, _ok, _rem, _ttl, key, c, d in bigs:
                    big_applies.append((key, d, c.window_seconds))
                continue
            oks_by_j = {
                int(j_l[i]): bool(ok_flat[i]) for i in range(s0, s1)
            }
            for j, ok, *_rest in bigs:
                oks_by_j[j] = ok
            limited_js = [j for j, ok in oks_by_j.items() if not ok]
            first = min(limited_js) if limited_js else 0
            auths.append(
                Authorization.limited_by(request.ordered[first].limit.name)
            )
            if not request.load:
                # Non-load early return (in_memory.rs:110-133): drop
                # qualified slots allocated past the first limited hit,
                # when no other hit in the batch shares them.
                for j, c, shard, slot, is_g in handle.fresh_by_req[r]:
                    if j <= first:
                        continue
                    if use_counts is None:
                        use_counts = self._slot_use_counts(
                            shard_ids, handle.slot_col, handle.glob_col
                        )
                    use = (-slot - 1) if is_g else (shard << 32) + slot
                    if use_counts.get(use) == 1:
                        releases.append((c, shard, slot, is_g))
        with self._lock:
            self._unproject_big(handle.big_projected)
            self._apply_big(big_applies, handle.now)
            watched = self._watched
            for c, shard, slot, is_g in releases:
                wkey = (-1, slot) if is_g else (shard, slot)
                if watched.get(wkey) != handle.seq:
                    continue
                # The table must still map this key to this slot: an
                # intervening delete/evict/clear already freed it.
                key = self._key_of(c)
                qualified = c.is_qualified()
                table = self._gtable if is_g else self._tables[shard]
                mapped = (
                    table.qualified.get(key) == slot
                    if qualified else table.simple.get(key) == slot
                )
                if mapped:
                    self._release(c, shard, slot, is_g)
            for wkey in handle.watch_touches:
                if watched.get(wkey) == handle.seq:
                    del watched[wkey]
        return auths

    @staticmethod
    def _slot_use_counts(shard_ids, slot_col, glob_col) -> Dict[int, int]:
        """Batch-wide use count per device cell, as a composite-int map
        (negative: a global slot)."""
        comp = np.where(
            glob_col,
            -(slot_col.astype(np.int64) + 1),
            shard_ids.astype(np.int64) * (1 << 32) + slot_col,
        )
        uniq, cnt = np.unique(comp, return_counts=True)
        return dict(zip(uniq.tolist(), cnt.tolist()))

    def check_many(self, requests: List[_Request]) -> List[Authorization]:
        """One launch deciding a batch of requests in list order (the
        exactness contract of ``TorchStorage.check_many``; requests that
        span rows couple through the vote AND)."""
        return self.finish_check_many(self.begin_check_many(requests))

    def _release(self, counter: Counter, shard: int, slot: int, is_g: bool):
        key = self._key_of(counter)
        if is_g:
            self._gtable.release(slot, key, counter.is_qualified())
            self._zero_global_slots([slot])
        else:
            self._tables[shard].release(slot, key, counter.is_qualified())

    # -- host reads ---------------------------------------------------------

    def _read_value(
        self, shard: Optional[int], slot: int, is_g: bool, now_ms: int
    ) -> Tuple[int, int]:
        """(live value, ttl_ms): the sum of live partials for a global
        slot."""
        if is_g:
            vals, exps = self._read_columns([slot])
            vals, exps = vals[:, 0], exps[:, 0]
            live = exps > now_ms
            value = int(vals[live].sum())
            ttl = int(exps.max() - now_ms) if live.any() else 0
            return value, max(ttl, 0)
        v, e = self._read_cells([shard], [slot])
        v, e = int(v[0]), int(e[0])
        if e <= now_ms:
            return 0, 0
        return v, e - now_ms

    # -- CounterStorage ------------------------------------------------------

    def is_within_limits(self, counter: Counter, delta: int) -> bool:
        with self._lock:
            now_ms = self._now_ms()
            if self._is_big(counter):
                entry = self._big.get(self._key_of(counter))
                value = (
                    entry[0].value_at(self._clock())
                    if entry is not None else 0
                )
                return value + delta <= counter.max_value
            shard, slot, _f, is_g = self._slot_for(counter, create=False)
            if slot is None:
                value = 0
            else:
                value, ttl = self._read_value(shard, slot, is_g, now_ms)
                if counter.limit.policy == "token_bucket":
                    # Bucket cells: ttl is max(TAT - now, 0), the spent
                    # tokens derive from it.
                    value = spent_tokens(
                        counter.max_value, counter.window_seconds, ttl
                    )
        return value + delta <= counter.max_value

    def add_counter(self, limit: Limit) -> None:
        if not limit.variables:
            with self._lock:
                counter = Counter(limit, {})
                if self._is_big(counter):
                    self._big_cell(counter, self._key_of(counter))
                else:
                    shard, slot, fresh, is_g = self._slot_for(
                        counter, create=True
                    )
                    if fresh and not is_g:
                        # No batch follows: clear a recycled local cell
                        # (global slots are zeroed at release).
                        self._clear_pairs[(shard, slot)] = None

    def update_counter(self, counter: Counter, delta: int) -> None:
        self.apply_deltas([(counter, delta)])

    def check_and_update(
        self, counters: List[Counter], delta: int, load_counters: bool
    ) -> Authorization:
        if not counters:
            return Authorization.OK
        return self.check_many([_Request(counters, delta, load_counters)])[0]

    def apply_deltas(self, items):
        """Unconditional batched increments (the Report path): one B7c
        host-form call (``sharded_update_host``: the list of (row, slot,
        delta, window, flags) entries by value, one launch, no padding
        and no upload), then one B3a host-form read (``read_slots_host``
        on the flattened table) of the touched local cells and of every
        row's partial of the touched global slots, answered in the
        context's mapped buffer. Returns (value, ttl_s) per item, in
        order."""
        for _counter, delta in items:
            require_nonnegative_delta(delta)
        with self._lock:
            now_ms = self._now_ms()
            now = self._clock()
            entries: List[Tuple[int, int, int, int, int]] = []
            # loc: (shard, slot, is_global, counter) or ("big", value, ttl)
            locs: List[tuple] = []
            for counter, delta in items:
                if self._is_big(counter):
                    cell = self._big_cell(counter, self._key_of(counter))
                    value = cell.update(
                        int(delta), counter.window_seconds, now
                    )
                    locs.append(("big", value, cell.ttl(now)))
                    continue
                shard, slot, is_fresh, is_g = self._slot_for(
                    counter, create=True
                )
                win, is_bucket = self._lane_of(counter)
                entries.append((
                    self._app_shard() if is_g else shard, slot,
                    min(int(delta), K.MAX_DELTA_CAP), win,
                    int(is_fresh) | int(is_bucket) << 1,
                ))
                locs.append((shard, slot, is_g, counter))
            if not entries:
                return [(loc[1], loc[2]) for loc in locs]
            self._flush_clears()
            M.sharded_update_host(self._ctx, np.asarray(entries, np.int32),
                                  now_ms)
            n, row_len = self._n, self._local_capacity + 1
            dev_locs = [loc for loc in locs if loc[0] != "big"]
            cells = [s * row_len + sl for s, sl, g, _c in dev_locs if not g]
            n_local = len(cells)
            gsl = sorted({sl for _s, sl, g, _c in dev_locs if g})
            cells += [r * row_len + sl for sl in gsl for r in range(n)]
            vals, ttls = K.read_slots_host(
                self._flat_ctx, np.asarray(cells, np.int32), now_ms)
            gpos = {sl: n_local + i * n for i, sl in enumerate(gsl)}
            out = []
            li = 0
            for loc in locs:
                if loc[0] == "big":
                    _tag, value, ttl_s = loc
                    out.append((value, ttl_s))
                    continue
                shard, slot, is_g, counter = loc
                if is_g:
                    # the live partials' sum; the latest live expiry
                    at = gpos[slot]
                    value = int(vals[at:at + n].sum())
                    ttl = int(ttls[at:at + n].max())
                else:
                    ttl = int(ttls[li])
                    if counter.limit.policy == "token_bucket":
                        value = spent_tokens(
                            counter.max_value, counter.window_seconds, ttl
                        )
                    else:
                        value = int(vals[li])
                    li += 1
                out.append((value, ttl / 1000.0))
        return out

    def warm_apply(self) -> None:
        """``TorchStorage.warm_apply`` for this table: B7c's and B3a's
        host forms once on a [1, 2] table of their own, bound to this
        storage's stream. Nothing to do on the CPU."""
        if not self._cuda:
            return
        with self._lock, self._on_device():
            state = M.make_sharded_table(1, 1, self._device)
            ctx = K.TableContext(state, self._stream)
            flat = K.TableContext(
                K.CounterTableState(*(t.view(-1) for t in state)),
                self._stream)
            try:
                M.sharded_update_host(
                    ctx, np.asarray([[0, 0, 1, 1000, 1]], np.int32), 0)
                K.read_slots_host(flat, np.zeros(1, np.int32), 0)
            finally:
                flat.close()
                ctx.close()

    def get_counters(self, limits: Set[Limit]) -> Set[Counter]:
        out: Set[Counter] = set()
        with self._lock:
            now_ms = self._now_ms()
            namespaces = {limit.namespace for limit in limits}
            g_matching = [
                (slot, counter)
                for slot, (_key, counter) in self._gtable.info.items()
                if counter.limit in limits or counter.namespace in namespaces
            ]
            l_matching = [
                (shard, slot, counter)
                for shard, table in enumerate(self._tables)
                for slot, (_key, counter) in table.info.items()
                if counter.limit in limits or counter.namespace in namespaces
            ]
            # Reads of only the matching cells, not the whole table.
            if g_matching:
                gv, ge = self._read_columns([s for s, _c in g_matching])
                for col, (_slot, counter) in enumerate(g_matching):
                    live = ge[:, col] > now_ms
                    if not live.any():
                        continue
                    c = counter.key()
                    c.remaining = c.max_value - int(gv[live, col].sum())
                    c.expires_in = (int(ge[:, col].max()) - now_ms) / 1000.0
                    out.add(c)
            if l_matching:
                lv, le = self._read_cells(
                    [s for s, _sl, _c in l_matching],
                    [sl for _s, sl, _c in l_matching])
                for i, (_shard, _slot, counter) in enumerate(l_matching):
                    ttl = int(le[i]) - now_ms
                    if ttl <= 0:
                        continue
                    c = counter.key()
                    if c.limit.policy == "token_bucket":
                        c.remaining = c.max_value - spent_tokens(
                            c.max_value, c.window_seconds, ttl
                        )
                    else:
                        c.remaining = c.max_value - int(lv[i])
                    c.expires_in = ttl / 1000.0
                    out.add(c)
            self._emit_big_counters(limits, namespaces, self._clock(), out)
        return out

    def delete_counters(self, limits: Set[Limit]) -> None:
        with self._lock:
            doomed_global: List[int] = []
            for slot, (key, counter) in list(self._gtable.info.items()):
                if counter.limit in limits:
                    self._gtable.release(slot, key, counter.is_qualified())
                    doomed_global.append(slot)
            for shard, table in enumerate(self._tables):
                for slot, (key, counter) in list(table.info.items()):
                    if counter.limit in limits:
                        table.release(slot, key, counter.is_qualified())
                        self._clear_pairs[(shard, slot)] = None
            self._zero_global_slots(doomed_global)
            self._delete_big(limits)

    def drop_counters(self, counters) -> int:
        """Release the cells of ``counters`` (the elastic pod's source,
        once the new owner acknowledged a moved slice): slots freed, cells
        zeroed by one B7b host-form launch ((row, slot) pairs, or every
        row of a global slot); a beyond-cap counter's host cell dropped.
        Returns the number of cells that existed."""
        released = 0
        with self._lock:
            for counter in counters:
                if self._is_big(counter):
                    if self._big.pop(self._key_of(counter), None) is not None:
                        released += 1
                    continue
                shard, slot, _fresh, is_g = self._slot_for(
                    counter, create=False)
                if slot is None:
                    continue
                self._release(counter, shard, slot, is_g)
                if not is_g:
                    self._clear_pairs[(shard, slot)] = None
                released += 1
            self._flush_clears()
        return released

    def clear(self) -> None:
        with self._lock:
            self._reset_tables()
            self._clear_big()
            self._watched.clear()
            # staged clears of the table this one replaces
            self._clear_pairs.clear()
            self._clear_all.clear()
            with self._on_device():
                self._state = M.make_sharded_table(
                    self._n, self._local_capacity, self._device)

    # -- checkpoint / resume -------------------------------------------------

    def snapshot(self, path: str) -> None:
        """Sparse checkpoint of the sharded table: the occupied row-local
        cells, the global region's per-row partials and the host key
        space (the JAX storage's payload, in the port's own pickle,
        ``SNAPSHOT_FORMAT``). With :attr:`snapshot_meta` set, it also
        carries that manifest."""
        import pickle

        with self._lock:
            locs = [
                (shard, slot)
                for shard, table in enumerate(self._tables)
                for slot in table.info
            ]
            gslots = np.asarray(sorted(self._gtable.info), np.int32)
            if locs:
                lvalues, lexpiry = self._read_cells(
                    [s for s, _ in locs], [sl for _, sl in locs])
            else:
                lvalues = lexpiry = np.zeros(0, np.int32)
            if gslots.size:
                gvalues, gexpiry = self._read_columns(gslots)
            else:
                gvalues = gexpiry = np.zeros((self._n, 0), np.int32)
            payload = {
                "format": self.SNAPSHOT_FORMAT,
                "n_shards": self._n,
                "local_capacity": self._local_capacity,
                "global_region": self._global_region,
                "global_namespaces": sorted(self._global_ns),
                "cache_size": self._cache_size,
                "epoch": self._epoch,
                "locs": locs,
                "lvalues": lvalues,
                "lexpiry": lexpiry,
                "gslots": gslots,
                "gvalues": gvalues,
                "gexpiry": gexpiry,
                "tables": [t.dump() for t in self._tables],
                "gtable": self._gtable.dump(),
                "big": cell_rows(self._big),
            }
            if self.snapshot_meta:
                payload["manifest"] = dict(self.snapshot_meta)
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    @classmethod
    def restore(
        cls, path: str, n_shards=None, cache_size=None, clock=time.time,
        device=None,
    ) -> "TorchShardedStorage":
        """A storage built from a checkpoint. ``cache_size`` may be
        overridden; the capacity, region and namespaces are the
        checkpoint's (they govern routing). ``n_shards`` defaults to the
        checkpoint's, and a different number raises."""
        return cls.from_snapshot(cls.read_snapshot(path), n_shards,
                                 cache_size, clock, device)

    @classmethod
    def from_snapshot(
        cls, data: dict, n_shards=None, cache_size=None, clock=time.time,
        device=None,
    ) -> "TorchShardedStorage":
        """``restore`` from ``read_snapshot``'s contents."""
        self = cls(
            n_shards=data["n_shards"] if n_shards is None else n_shards,
            local_capacity=data["local_capacity"],
            cache_size=cache_size or data["cache_size"],
            global_namespaces=data["global_namespaces"],
            global_region=data["global_region"],
            clock=clock,
            device=device,
        )
        if self._n != data["n_shards"]:
            raise StorageError(
                f"snapshot was taken on {data['n_shards']} shards, the "
                f"storage has {self._n} (key routing would change)"
            )
        self._epoch = data["epoch"]
        locs = data["locs"]
        gslots = np.asarray(data["gslots"], np.int32)
        with self._on_device():
            values, expiry = self._state.values, self._state.expiry_ms
            if locs:
                sh, sl, lv, le = self._upload(
                    np.asarray([s for s, _ in locs], np.int64),
                    np.asarray([s for _, s in locs], np.int64),
                    np.asarray(data["lvalues"], np.int32),
                    np.asarray(data["lexpiry"], np.int32),
                )
                values[sh, sl] = lv
                expiry[sh, sl] = le
            if gslots.size:
                gsl, gv, ge = self._upload(
                    gslots.astype(np.int64),
                    np.asarray(data["gvalues"], np.int32),
                    np.asarray(data["gexpiry"], np.int32),
                )
                values[:, gsl] = gv
                expiry[:, gsl] = ge
        # The hit accumulator is telemetry, not state: restores count
        # afresh.
        for table, dump in zip(self._tables, data["tables"]):
            table.load(dump, self._global_region, self._local_capacity)
        self._gtable.load(data["gtable"], 0, self._global_region)
        seed: List[Tuple[int, int, int]] = []
        for key, (value, exp, counter) in data.get("big", {}).items():
            cell = restore_cell(counter.limit, value, exp)
            if isinstance(cell, GcraValue) and not self._is_big(counter):
                # A device-eligible bucket held host-side (a checkpoint
                # whose cell was kept on the big map): seed its owner
                # row's TAT cell instead of orphaning the state.
                # Device-eligible buckets are never global.
                shard, slot, _fresh, _is_global = self._slot_for(
                    counter, create=True
                )
                seed.append((shard, slot, min(
                    max(int(cell.tat) - int(self._epoch * 1000), 0),
                    _INT32_MAX,
                )))
                continue
            self._big[key] = (cell, counter)
        if seed:
            with self._on_device():
                sh, sl, tat = self._upload(
                    np.asarray([s for s, _, _ in seed], np.int64),
                    np.asarray([s for _, s, _ in seed], np.int64),
                    np.asarray([t for _, _, t in seed], np.int32),
                )
                self._state.values[sh, sl] = 0
                self._state.expiry_ms[sh, sl] = tat
        return self

    def close(self) -> None:
        """Wait for every launch on the storage stream."""
        if self._cuda:
            self._stream.synchronize()


# -- slice-granular checkpoint decode ----------------------------------------


def snapshot_manifest(path: str) -> dict:
    """The shard-ownership manifest of a sharded checkpoint, without
    building a storage: which shard block the writing process owned and
    under which topology (empty when it carries none)."""
    data = TorchShardedStorage.read_snapshot(path)
    return {
        "format": data.get("format"),
        "n_shards": data.get("n_shards"),
        "manifest": dict(data.get("manifest") or {}),
    }


def _decoded_value(counter, value: int, expiry_ms: int, now_rel: int) -> int:
    """One device cell's host-visible spend at ``now_rel`` (ms since the
    checkpoint's epoch): fixed windows read the values lane gated on
    expiry; bucket cells derive spent tokens from the TAT lane."""
    if counter.limit.policy == "token_bucket":
        base_rel = max(int(expiry_ms) - now_rel, 0)
        return spent_tokens(
            counter.max_value, counter.limit.seconds, base_rel
        )
    if int(expiry_ms) <= now_rel:
        return 0
    return int(value)


def snapshot_items(path: str, clock=time.time):
    """Decode a sharded checkpoint into live ``(counter, spend)`` items on
    the host, for a restore that seeds only some of them through
    ``apply_deltas``. Expired cells decode to nothing."""
    data = TorchShardedStorage.read_snapshot(path)
    now = float(clock())
    now_rel = int((now - float(data["epoch"])) * 1000)
    items = []
    tables = [dict(d.get("info", {})) for d in data.get("tables", ())]
    lvalues = np.asarray(data.get("lvalues", ()))
    lexpiry = np.asarray(data.get("lexpiry", ()))
    for i, (shard, slot) in enumerate(data.get("locs", ())):
        entry = tables[shard].get(slot) if shard < len(tables) else None
        if entry is None:
            continue
        _key, counter = entry
        value = _decoded_value(
            counter, int(lvalues[i]), int(lexpiry[i]), now_rel
        )
        if value > 0:
            items.append((counter, value))
    # the global region: the sum of every row's partial
    ginfo = dict(data.get("gtable", {}).get("info", {}))
    gslots = np.asarray(data.get("gslots", ())).tolist()
    gvalues = np.asarray(data.get("gvalues", ()))
    gexpiry = np.asarray(data.get("gexpiry", ()))
    for j, slot in enumerate(gslots):
        entry = ginfo.get(int(slot))
        if entry is None:
            continue
        _key, counter = entry
        if counter.limit.policy == "token_bucket":
            continue  # _is_big keeps global-namespace buckets host-side
        if gexpiry.size and int(gexpiry[:, j].max()) <= now_rel:
            continue
        value = int(gvalues[:, j].sum()) if gvalues.size else 0
        if value > 0:
            items.append((counter, value))
    # host cells (over-cap limits and host buckets)
    for _key, (a, b, counter) in data.get("big", {}).items():
        cell = restore_cell(counter.limit, a, b)
        value = int(cell.value_at(now))
        if value > 0:
            items.append((counter, value))
    return items
