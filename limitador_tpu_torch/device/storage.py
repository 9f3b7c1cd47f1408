"""TorchStorage — the device-resident counter backend of the port.

Counterpart of ``limitador_tpu/tpu/storage.py`` (``TpuStorage``).
Implements the ``CounterStorage`` protocol over the counter-table kernels
of ``limitador_tpu_torch/ops/kernel.py``, with the same exactness as the
in-memory reference (never over-admits; check-all-then-update-all):

- The host owns the key space: counter identity -> slot index. Qualified
  slots are evicted LRU; simple-limit slots are pinned.
- The device owns the values: a dense int32 (value, expiry_ms, hits)
  table; every check and update is one kernel launch.
- ``check_many`` is the single implementation of hit-array construction,
  reference processing order, first-limited naming and the non-load
  early-return slot release; ``check_and_update`` and the async
  ``MicroBatcher`` (device/batcher.py) both go through it.

Documented representation limits (see ops/kernel.py): max_value clamps to
2**30, deltas to 2**30-1, windows to WINDOW_MS_CAP (~12.4 days). The epoch
rebases on long uptimes so expiries never overflow int32.

Device and streams. ``device=None`` means the card: without CUDA the
constructor raises rather than counting on the CPU. ``device="cpu"``
runs the kernels' plain versions (the tests ask for it). On the card the
storage owns one CUDA stream, and every upload, launch, download and
event goes on it: the batcher calls in from executor threads, and a
thread's current stream is its own, so only an explicit stream keeps the
program order the begin/finish pipelining relies on. ``jax.device_get``
becomes a non-blocking copy into pinned host memory and a CUDA event
that ``finish_check_many`` waits on.

The native serving path (``device/native_pipeline.py``) stages its own
kernel columns and enters through ``begin_check_columnar`` /
``finish_check_columnar``; the lease broker returns quota through
``credit_columnar`` (B4c's host form), and the usage observatory drains the
hit column through ``drain_hot_slots`` (B5 + B3a). The slot table fires
``on_native_release`` / ``on_slot_release`` on every slot release (LRU
eviction, delete) and ``on_clear`` on a wholesale table swap, exactly
where the JAX table does, so the native slot map and the plan caches
never keep a recycled slot.

Every check launches through ``_kernel_check`` and every unconditional
update (``update_counter``, the batched Report path ``apply_deltas``)
through ``_kernel_update``, the dispatch points the replicated subclass
(``device/replicated.py``) overrides. An update is a numpy list of
(row, slot, delta, window, flags) entries (``_update_row``), one launch
of B2's host form on the bound context: no padding, no upload, no
workspace. ``snapshot``, ``load_snapshot`` and
``restore`` checkpoint the table and key space in the port's own format.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core.counter import Counter
from ..core.limit import Limit
from ..ops import kernel as K
from ..storage.base import (
    Authorization,
    CounterStorage,
    StorageError,
    require_nonnegative_delta,
)
from ..storage.expiring_value import ExpiringValue
from ..storage.gcra import (
    GcraValue,
    cell_for_limit,
    device_eligible,
    emission_interval_ms,
    restore_cell,
    spent_tokens,
)

__all__ = ["TorchStorage", "resolve_device", "hot_attribution"]

_INT32_MAX = np.int32(np.iinfo(np.int32).max)
# top-level modules a snapshot may name (read_snapshot)
_SNAPSHOT_MODULES = frozenset(
    ("limitador_tpu_torch", "numpy", "collections", "builtins", "copyreg",
     "_codecs")
)


def resolve_device(device=None) -> torch.device:
    """The storage's device: the card unless the caller asks for the CPU.
    Raises when the card is asked for (explicitly or by default) and
    CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise StorageError(
                "TorchStorage needs a CUDA device, and torch.cuda is not "
                "available; pass device='cpu' to count on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise StorageError(f"TorchStorage runs on cuda or cpu, not {dev}")
    return dev


def _bucket(n: int, floor: int = 8) -> int:
    """Next power of two >= n (a handful of batch shapes)."""
    b = floor
    while b < n:
        b <<= 1
    return b


def _clamp_window_ms(seconds: int) -> int:
    return min(seconds * 1000, K.WINDOW_MS_CAP)


def _staged(values, H: int, fill, dtype) -> np.ndarray:
    """Right-sized staging array: prefix from a Python list, padding
    filled with the inert default."""
    arr = np.empty(H, dtype)
    n = len(values)
    if n:
        arr[:n] = values
    if n < H:
        arr[n:] = fill
    return arr


#: staged rows from which ``_partition_positions`` takes the C pass
PARTITION_C_ROWS = 2048


def _partition_positions(
    group_ids: np.ndarray, n_groups: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized grouped cumcount: for flat staged rows labeled with a
    group (a shard, a request's home shard), ``(counts[n_groups], pos)``
    where ``pos[i]`` is row i's index within its group, counted in input
    order. Two routes with identical outputs, split where the JAX
    package's ``_partition_positions`` splits them
    (``PARTITION_C_ROWS``): from 2048 rows one O(n) C pass of the host
    lane (``hp_partition_positions``, built at first use; a build that
    fails raises ``BuildError``), below it one argsort and two cumsums."""
    m = group_ids.shape[0]
    if m >= PARTITION_C_ROWS:
        from .. import native

        return native.partition_positions(group_ids, n_groups)
    counts = np.bincount(group_ids, minlength=n_groups)
    order = np.argsort(group_ids, kind="stable")
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    pos = np.empty(m, np.int64)
    pos[order] = np.arange(m, dtype=np.int64) - np.repeat(starts, counts)
    return counts, pos


def _scatter_rows(
    shard_ids: np.ndarray,
    pos: np.ndarray,
    n: int,
    H: int,
    columns: Sequence[Tuple[Sequence, object, type]],
) -> List[np.ndarray]:
    """Scatter flat hit columns into per-shard ``[n, H]`` staging arrays
    (``(values, fill, dtype)`` per column): one fancy-index store per
    column over pad rows pre-filled with the inert default. Flat order is
    request order and ``pos`` counts per shard in flat order, so each
    shard's rows stay in request order (the kernels' nondecreasing
    request-id contract)."""
    out = []
    for values, fill, dtype in columns:
        arr = np.full((n, H), fill, dtype)
        arr[shard_ids, pos] = values
        out.append(arr)
    return out


def cell_rows(cells) -> dict:
    """Checkpoint form of a host cell map (key -> (cell, counter)): key ->
    (a, b, counter), the cell's two scalars as ``restore_cell`` takes
    them, (tat, scale) for buckets and (value, expiry) for windows."""
    return {
        key: (
            (cell.tat, cell.scale, counter)
            if isinstance(cell, GcraValue)
            else (cell.value_raw, cell.expiry, counter)
        )
        for key, (cell, counter) in cells.items()
    }


def hot_attribution(counter: Counter, value: int, ttl_ms: int) -> dict:
    """Tenant-usage attribution fields for one drained heavy-hitter slot:
    the slot's counter identity plus the utilization sample read at drain
    time. ``value`` is the raw values-lane read; bucket counters derive
    spent tokens from the ttl lane instead (their values lane is
    unspecified)."""
    limit = counter.limit
    if limit.policy == "token_bucket":
        value = spent_tokens(
            counter.max_value, counter.window_seconds, ttl_ms
        )
    max_value = int(counter.max_value)
    util = value / max_value if max_value > 0 else 0.0
    return {
        "namespace": str(counter.namespace),
        "limit_name": limit.name,
        "policy": limit.policy,
        "max_value": max_value,
        "seconds": counter.window_seconds,
        "key": dict(counter.set_variables),
        "value": int(value),
        # Unclamped on purpose: >1.0 is real signal (Report-role
        # unconditional updates can push past max_value).
        "utilization": round(util, 4),
        "ttl_s": round(ttl_ms / 1000.0, 3),
    }


def _hit_lane(counter: Counter) -> Tuple[int, bool]:
    """Per-hit (windows_ms lane, bucket flag) for a device-eligible
    counter: the window for fixed windows, the GCRA emission interval
    for token buckets."""
    limit = counter.limit
    if limit.policy == "token_bucket":
        return emission_interval_ms(limit.max_value, limit.seconds), True
    return _clamp_window_ms(counter.window_seconds), False


class _SlotTable:
    """Host-side key space: counter identity -> device slot."""

    def __init__(self, capacity: int):
        self.free: List[int] = list(range(capacity - 1, -1, -1))
        # pinned (simple-limit) slots: key -> slot
        self.simple: Dict[tuple, int] = {}
        # LRU for qualified counters: key -> slot (front = oldest)
        self.qualified: "OrderedDict[tuple, int]" = OrderedDict()
        # slot -> (key, Counter identity object) for introspection
        self.info: Dict[int, Tuple[tuple, Counter]] = {}
        # slot -> native composite key + its removal hook (native path)
        self.native_keys: Dict[int, object] = {}
        self.on_native_release = None
        # Plan-cache coherence (device/plan_cache.py): every slot release
        # fires on_slot_release(slot) so cached plans pinning the slot are
        # dropped before it can be recycled; a wholesale table swap
        # (clear) fires on_clear instead.
        self.on_slot_release = None
        self.on_clear = None
        # Device-plane telemetry (the storages' device_stats):
        # LRU evictions, and fresh allocations that recycled a released
        # slot. Host bookkeeping only, never reset by dump/load.
        self.evictions = 0
        self.collisions = 0
        self._recycled: Set[int] = set()

    def lookup(self, key: tuple, qualified: bool) -> Optional[int]:
        if qualified:
            slot = self.qualified.get(key)
            if slot is not None:
                self.qualified.move_to_end(key)
            return slot
        return self.simple.get(key)

    def dump(self) -> dict:
        """Checkpoint form, the JAX table's: the free list is not kept
        (it would be O(capacity)); ``load`` derives it."""
        return {
            "simple": dict(self.simple),
            "qualified": list(self.qualified.items()),
            "info": dict(self.info),
        }

    def load(self, data: dict, lo: int, hi: int) -> None:
        """Restore from ``dump``'s form (the JAX package's too, through
        ``convert.py``); slots of this table live in [lo, hi). The free
        list derives from the occupied set."""
        self.simple = dict(data["simple"])
        self.qualified.update(data["qualified"])
        self.info = dict(data["info"])
        occupied = set(self.info)
        self.free = [
            s for s in range(hi - 1, lo - 1, -1) if s not in occupied
        ]

    def alloc(self) -> int:
        """Pop a free slot, counting a recycled one as a collision.
        Callers guarantee ``free`` is non-empty."""
        slot = self.free.pop()
        if slot in self._recycled:
            self._recycled.discard(slot)
            self.collisions += 1
        return slot

    def release(self, slot: int, key: tuple, qualified: bool) -> None:
        self.info.pop(slot, None)
        if qualified:
            self.qualified.pop(key, None)
        else:
            self.simple.pop(key, None)
        self.free.append(slot)
        self._recycled.add(slot)
        # A recycled slot must not stay reachable under its old native
        # key, nor through a cached plan.
        native_key = self.native_keys.pop(slot, None)
        if native_key is not None and self.on_native_release is not None:
            self.on_native_release(native_key)
        if self.on_slot_release is not None:
            self.on_slot_release(slot)


class _BigLimitMixin:
    """Host-side exact counters for limits whose max_value exceeds the
    int32 device cap (and token buckets too fine for the ms lane). Every
    method assumes the caller holds the storage lock.

    Admission projection (``_big_inflight``) spans in-flight batches: a
    hit admitted at begin time reserves its delta immediately, so a
    second pipelined batch can never over-admit against a stale value;
    the reservation is released (and the delta applied when the whole
    request was admitted) at finish."""

    def _init_big(self, cap: int) -> None:
        self._big: "OrderedDict[tuple, Tuple[ExpiringValue, Counter]]" = (
            OrderedDict()
        )
        self._big_inflight: Dict[tuple, int] = {}
        self._big_cap = max(int(cap), 1)
        # Per-(limit, max_value) memos of the big flag and the hit lane;
        # max_value is not part of Limit identity, so it rides in the key.
        self._big_flags: Dict[tuple, bool] = {}
        self._lanes: Dict[tuple, Tuple[int, bool]] = {}

    def _is_big(self, counter: Counter) -> bool:
        limit = counter.limit
        key = (limit, limit.max_value)
        flag = self._big_flags.get(key)
        if flag is None:
            if limit.policy == "token_bucket":
                flag = not device_eligible(
                    counter.max_value, counter.window_seconds,
                    K.MAX_VALUE_CAP, K.WINDOW_MS_CAP,
                )
            else:
                flag = counter.max_value > K.MAX_VALUE_CAP
            if len(self._big_flags) >= 4096:
                self._big_flags.clear()
            self._big_flags[key] = flag
        return flag

    def _lane_of(self, counter: Counter) -> Tuple[int, bool]:
        limit = counter.limit
        key = (limit, limit.max_value)
        lane = self._lanes.get(key)
        if lane is None:
            lane = _hit_lane(counter)
            if len(self._lanes) >= 4096:
                self._lanes.clear()
            self._lanes[key] = lane
        return lane

    def _big_cell(self, counter: Counter, key: tuple) -> ExpiringValue:
        entry = self._big.get(key)
        if entry is not None:
            self._big.move_to_end(key)
            return entry[0]
        cell = cell_for_limit(counter.limit)
        self._big[key] = (cell, counter.key())
        while len(self._big) > self._big_cap:
            evicted = False
            for k in self._big:
                if k != key and k not in self._big_inflight:
                    del self._big[k]
                    evicted = True
                    break
            if not evicted:
                break
        return cell

    def _big_remote_sum(self, key: tuple, now: float) -> int:
        """Live remote contribution to a big cell's admission base: 0
        here; the replicated topology overrides it with the gossiped
        per-actor sum (device/replicated.py)."""
        return 0

    def _on_big_write(self, key: tuple) -> None:
        """Hook: a big cell was locally incremented (caller holds the
        lock). The replicated topology queues it for gossip."""

    def _eval_big_hits(self, ordered, raw_delta: int, now: float):
        """First pass of a request: decide its big hits host-side.
        Returns (bigs, failed, projected) where each big is
        (j, ok, remaining, ttl_s, key, counter, delta) and projected lists
        (key, delta) reservations to release at finish."""
        bigs: list = []
        projected: List[Tuple[tuple, int]] = []
        failed = False
        for j, c in enumerate(ordered):
            if not self._is_big(c):
                continue
            key = self._key_of(c)
            cell = self._big_cell(c, key)
            value = (
                cell.value_at(now)
                + self._big_inflight.get(key, 0)
                + self._big_remote_sum(key, now)
            )
            ok = value + raw_delta <= c.max_value
            remaining = max(c.max_value - (value + raw_delta), 0)
            if isinstance(cell, GcraValue):
                # Token bucket: expires_in is time-to-full (0 = full).
                ttl = cell.ttl(now)
            else:
                ttl = (
                    float(c.window_seconds)
                    if cell.is_expired(now) else cell.ttl(now)
                )
            bigs.append((j, ok, remaining, ttl, key, c, raw_delta))
            if ok:
                self._big_inflight[key] = (
                    self._big_inflight.get(key, 0) + raw_delta
                )
                projected.append((key, raw_delta))
            else:
                failed = True
        return bigs, failed, projected

    def _unproject_big(self, projected) -> None:
        for key, delta in projected:
            cur = self._big_inflight.get(key, 0) - delta
            if cur > 0:
                self._big_inflight[key] = cur
            else:
                self._big_inflight.pop(key, None)

    def _apply_big(self, applies, now: float) -> None:
        for key, delta, window in applies:
            entry = self._big.get(key)
            if entry is not None:
                entry[0].update(delta, window, now)
                self._on_big_write(key)

    def _emit_big_counters(self, limits, namespaces, now: float, out) -> None:
        for _key, (cell, counter) in self._big.items():
            if (
                counter.limit in limits
                or counter.namespace in namespaces
            ) and not cell.is_expired(now):
                c = counter.key()
                c.remaining = c.max_value - cell.value_at(now)
                c.expires_in = cell.ttl(now)
                out.add(c)

    def _delete_big(self, limits) -> None:
        for key, (_cell, counter) in list(self._big.items()):
            if counter.limit in limits:
                del self._big[key]

    def _clear_big(self) -> None:
        self._big.clear()
        self._big_inflight.clear()


class _Request:
    """One logical check inside a ``check_many`` batch."""

    __slots__ = ("ordered", "delta", "load")

    def __init__(self, counters: Sequence[Counter], delta: int, load: bool):
        # Reference processing order: simple counters then qualified
        # (in_memory.rs:104-139) — drives first_limited naming.
        self.ordered = [c for c in counters if not c.is_qualified()] + [
            c for c in counters if c.is_qualified()
        ]
        self.delta = delta
        self.load = load


class _ColumnarHandle:
    """In-flight columnar launch: the decision columns on their way to
    host memory (pinned on the card), the event recorded after the
    copies, and the per-hit remaining/ttl still on the device (downloaded
    only when the finish asks for them)."""

    __slots__ = ("host", "ready", "remaining", "ttl_ms")

    def __init__(self, host, ready, remaining, ttl_ms):
        self.host = host
        self.ready = ready
        self.remaining = remaining
        self.ttl_ms = ttl_ms


class _CheckHandle:
    """In-flight batch: kernel launched, results not yet on the host.
    Produced by ``begin_check_many``, consumed by ``finish_check_many`` —
    the split lets the batcher launch batch N+1 while N's results are
    still coming back."""

    __slots__ = ("requests", "fresh_hits_by_req", "slot_use_count",
                 "host", "ready", "seq", "watch_touches", "big_by_req",
                 "dev_info_by_req", "now", "big_projected")

    def __init__(self, requests, fresh_hits_by_req, slot_use_count, host,
                 ready, seq, watch_touches, big_by_req, dev_info_by_req, now,
                 big_projected=()):
        self.requests = requests
        self.fresh_hits_by_req = fresh_hits_by_req
        self.slot_use_count = slot_use_count
        # (hit_ok, remaining, ttl_ms) host tensors (pinned on the card)
        self.host = host
        # CUDA event recorded after the copies (None on the CPU)
        self.ready = ready
        self.seq = seq
        # Every slot whose _watched_slots entry this batch wrote; the
        # finish pass deletes the ones still carrying this batch's seq so
        # the watch map stays bounded by in-flight work.
        self.watch_touches = watch_touches
        # Host-side (max_value > device cap) hits, per request:
        # (j, ok, remaining, ttl_s, key, counter, delta).
        self.big_by_req = big_by_req
        # Device hits per request: (j, delta_adjust) in device-array order.
        self.dev_info_by_req = dev_info_by_req
        self.now = now
        # (key, delta) reservations in _big_inflight, released at finish.
        self.big_projected = big_projected


class TorchStorage(_BigLimitMixin, CounterStorage):
    supports_token_bucket = True

    def __init__(
        self,
        capacity: int = 1 << 20,
        cache_size: Optional[int] = None,
        clock=time.time,
        device=None,
    ):
        """``capacity`` sizes the device table (12 bytes/counter);
        ``cache_size`` caps qualified counters (default: capacity);
        ``device`` is the card unless "cpu" is asked for."""
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = (
            torch.cuda.Stream(self._device) if self._cuda else None
        )
        self._lock = threading.RLock()
        self._clock = clock
        self._capacity = int(capacity)
        self._cache_size = int(cache_size) if cache_size else self._capacity
        self._table = _SlotTable(self._capacity)
        # Cells owed a clear (slot -> None, in staging order), launched as
        # one B3b host-form call before the table's next access
        # (_flush_clears).
        self._staged_clears: Dict[int, None] = {}
        with self._on_device():
            self._state = K.make_table(self._capacity, self._device)
        self._epoch = clock()  # device time 0 in host seconds
        self._scratch = self._capacity  # padding slot
        # Pipelining bookkeeping: batch sequence number + last-touch seq of
        # slots watched for deferred release (see finish_check_many).
        self._seq = 0
        self._watched_slots: Dict[int, int] = {}
        # Slots a native begin has staged for the launch it is building
        # (device/native_pipeline.py); _lru_victim skips them.
        self._pinned: Optional[Set[int]] = None
        self._init_big(self._cache_size)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def _state(self):
        """The table. Every assignment of it, whoever makes it, binds a
        new launch context (``_ctx``: the columns and the storage stream,
        checked once) and closes the old one, so a host-list launch can
        never reach a table the storage has let go."""
        return self._ctx.state

    @_state.setter
    def _state(self, state) -> None:
        old = self.__dict__.get("_ctx")
        self._ctx = K.TableContext(state, self._stream)
        if old is not None:
            old.close()

    def _on_device(self):
        """Context for every device access of the table: the storage's
        device and stream on the card, nothing on the CPU. The staged
        clears launch first (``_flush_clears``), so that no launch, copy
        or read inside sees a cell a clear is owed to. Caller holds the
        lock."""
        self._flush_clears()
        return self._stream_scope()

    def _stream_scope(self):
        """The storage's device and stream on the card, nothing on the
        CPU; no flush: for work that reads no cell of the table (a
        launch's results)."""
        if not self._cuda:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self._device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _upload(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Host arrays to device tensors; on the card through pinned
        memory, non-blocking on the storage stream. Caller is inside
        ``_on_device``."""
        if not self._cuda:
            return [torch.from_numpy(a) for a in arrays]
        return [
            torch.from_numpy(a).pin_memory().to(self._device,
                                                 non_blocking=True)
            for a in arrays
        ]

    def _download(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        """Device tensors to host arrays, waiting for them. Caller is
        inside ``_on_device``."""
        return [t.cpu().numpy() for t in tensors]

    # -- time --------------------------------------------------------------

    def _now_ms(self) -> int:
        now = int((self._clock() - self._epoch) * 1000)
        if now > (1 << 30):
            # Rebase before now_ms + WINDOW_MS_CAP could overflow int32.
            shift = now - 1000
            with self._on_device():
                K.rebase_epoch_chunked(self._state.expiry_ms, shift)
            self._epoch += shift / 1000.0
            now -= shift
        return now

    # -- slot management ---------------------------------------------------

    @staticmethod
    def _key_of(counter: Counter) -> tuple:
        return counter._key()

    @contextlib.contextmanager
    def pinning(self):
        """Pin the slots a launch under construction stages (add them to
        the yielded set) until the block ends: ``_lru_victim`` skips them.
        Caller holds the lock for the whole block."""
        pinned = self._pinned = set()
        try:
            yield pinned
        finally:
            self._pinned = None

    def _lru_victim(self) -> Tuple[tuple, int]:
        """The least-recently-used qualified (key, slot) that is not
        pinned. The native lanes find their hits in the C slot map without
        touching this LRU, so a slot one of their batches has staged can
        sit at its front; recycling it before that batch launches puts two
        counters in one cell. Outside a native begin nothing is pinned and
        this is the LRU front, as in the JAX package (whose native pipeline
        has that fault: ROADMAP Queue C)."""
        pinned = self._pinned
        for key, slot in self._table.qualified.items():
            if not pinned or slot not in pinned:
                return key, slot
        raise StorageError("device counter table full (no evictable slots)")

    def _evict_one(self) -> None:
        """Free the least-recently-used unpinned qualified slot. Pure host
        bookkeeping: the recycled slot's stale cell is overridden by the
        kernel's ``fresh`` flag on next allocation."""
        key, slot = self._lru_victim()
        self._table.release(slot, key, qualified=True)
        self._table.evictions += 1

    def device_stats(self) -> dict:
        """Device table stats for /debug/stats and the per-shard
        Prometheus families: occupancy as a level, evictions and
        collisions as cumulative counts."""
        with self._lock:
            t = self._table
            return {
                "shards": [{
                    "shard": "0",
                    "occupied": len(t.info),
                    "capacity": self._capacity,
                    "evictions": t.evictions,
                    "collisions": t.collisions,
                }],
            }

    def _slot_for(self, counter: Counter, create: bool) -> Tuple[Optional[int], bool]:
        """Return (slot, fresh). fresh=True when allocated/recycled now."""
        qualified = counter.is_qualified()
        key = self._key_of(counter)
        slot = self._table.lookup(key, qualified)
        if slot is not None:
            return slot, False
        if not create:
            return None, False
        if qualified:
            while len(self._table.qualified) >= self._cache_size:
                self._evict_one()
        if not self._table.free:
            self._evict_one()
        slot = self._table.alloc()
        if qualified:
            self._table.qualified[key] = slot
        else:
            self._table.simple[key] = slot
        self._table.info[slot] = (key, counter.key())
        return slot, True

    def drain_hot_slots(self, k: int = 64) -> List[dict]:
        """Heavy-hitter drain (the tenant usage observatory): read and
        reset the per-slot hit accumulator and attribute the K hottest
        slots through the slot table: namespace, limit, key values, hit
        count, plus a value/max_value utilization sample and ttl read at
        drain time. One B5 host-form call (``drain_top_hits_host``: one
        launch answering into the bound context's mapped buffer, after
        the staged clears) and one B3a read (``_read``, which overwrites
        that buffer: the drain's answers are copies), off the check path.
        A slot recycled within one drain interval attributes its counts
        to the current occupant (or drops them when the slot is free)."""
        if k <= 0:
            return []
        with self._lock:
            now_ms = self._now_ms()
            self._flush_clears()
            counts, slots = K.drain_top_hits_host(
                self._ctx, min(int(k), self._capacity))
            live = counts > 0
            if not live.any():
                return []
            slots = slots[live].astype(np.int32)
            counts = counts[live]
            values, ttls = self._read(slots, now_ms)
            out: List[dict] = []
            info = self._table.info
            for i, slot in enumerate(slots.tolist()):
                record = {"slot": int(slot), "count": int(counts[i])}
                entry = info.get(slot)
                if entry is not None:
                    record.update(hot_attribution(
                        entry[1], int(values[i]), int(ttls[i])
                    ))
                out.append(record)
            return out

    def attribute_slots(self, slot_counts: Dict[int, int]) -> List[dict]:
        """Attribution records for slot traffic counted elsewhere: the
        native lane's leased admissions never reach the device
        accumulator, so the observatory counts them C-side and resolves
        them here, in ``drain_hot_slots``'s record shape with the
        caller's counts. Slots released since the counts were taken are
        dropped (their debit died with the cell)."""
        if not slot_counts:
            return []
        with self._lock:
            now_ms = self._now_ms()
            info = self._table.info
            items = [
                (slot, count) for slot, count in slot_counts.items()
                if slot in info
            ]
            if not items:
                return []
            values, ttls = self._read([s for s, _ in items], now_ms)
            out: List[dict] = []
            for i, (slot, count) in enumerate(items):
                record = {
                    "slot": int(slot), "count": int(count),
                    "source": "lease",
                }
                record.update(hot_attribution(
                    info[slot][1], int(values[i]), int(ttls[i])
                ))
                out.append(record)
            return out

    # -- the shared batched check path -------------------------------------

    def _kernel_check(self, ints: np.ndarray, flags: np.ndarray,
                      now_ms: int) -> "K.BatchResult":
        """Kernel dispatch point of the check: uploads the staged hit
        columns (int32[5, H] slots, deltas, maxes, windows, request ids;
        bool[2, H] fresh, bucket) and launches B1. The replicated subclass
        swaps in B6a, which folds the gossiped remote counts into the
        admission base. Caller holds the lock, inside ``_on_device``."""
        d_ints, d_flags = self._upload(ints, flags)
        _, result = K.check_and_update_batch(
            self._state, *d_ints, *d_flags, now_ms,
        )
        return result

    def _update_row(self, counter: Counter,
                    delta: int) -> Tuple[int, int, int, int, int]:
        """``counter``'s entry of an update list, its slot allocated:
        (0, slot, delta capped at MAX_DELTA_CAP, window or emission
        interval, flags bit 0 fresh and bit 1 bucket). Caller holds the
        lock."""
        slot, is_fresh = self._slot_for(counter, create=True)
        win, is_bucket = self._lane_of(counter)
        return (0, slot, min(int(delta), K.MAX_DELTA_CAP), win,
                int(is_fresh) | int(is_bucket) << 1)

    def _kernel_update(self, entries: np.ndarray, now_ms: int) -> None:
        """Unconditional-update dispatch point (``update_counter``,
        ``apply_deltas``): one launch of B2's host form on the bound
        context (``K.update_host``), the numpy int32 [count, 5] list of
        ``_update_row`` entries in the order the JAX storage stages its
        columns (each cell's bucket interval is its last entry's). The
        replicated subclass swaps in B6b's host form, which folds the
        gossiped remote TAT floor into bucket advances. Caller holds the
        lock, inside ``_on_device``."""
        K.update_host(self._ctx, entries, now_ms)

    def begin_check_many(self, requests: List[_Request]) -> _CheckHandle:
        """Build hit arrays and launch the kernel WITHOUT waiting for its
        results. Table mutations are serialized under the lock in call
        order, which is also the order of the storage stream, so batch
        N+1 may begin while N's results are still in flight.

        Counters whose max_value exceeds the device cap are decided
        host-side here (exact Python ints): a failing big hit strips the
        request's device deltas before the launch, so admission stays
        all-or-nothing; passing big hits apply at finish only when the
        device also admits."""
        for request in requests:
            require_nonnegative_delta(request.delta)
        slots_l: List[int] = []
        deltas_l: List[int] = []
        maxes_l: List[int] = []
        windows_l: List[int] = []
        req_l: List[int] = []
        fresh_l: List[bool] = []
        bucket_l: List[bool] = []

        with self._lock:
            now_ms = self._now_ms()
            now = self._clock()
            self._seq += 1
            seq = self._seq
            watched = self._watched_slots
            fresh_hits_by_req: List[List[Tuple[int, Counter, int]]] = []
            big_by_req: List[list] = []
            dev_info_by_req: List[List[Tuple[int, int]]] = []
            big_projected: List[Tuple[tuple, int]] = []
            watch_touches: List[int] = []
            slot_use_count: Dict[int, int] = {}
            slot_for = self._slot_for
            for r, request in enumerate(requests):
                fresh_hits: List[Tuple[int, Counter, int]] = []
                dev_info: List[Tuple[int, int]] = []
                raw_delta = int(request.delta)
                delta = min(raw_delta, K.MAX_DELTA_CAP)
                bigs, big_failed, projected = self._eval_big_hits(
                    request.ordered, raw_delta, now
                )
                big_projected.extend(projected)
                dev_delta = 0 if big_failed else delta
                adjust = delta if big_failed else 0
                for j, c in enumerate(request.ordered):
                    if self._is_big(c):
                        continue
                    slot, is_fresh = slot_for(c, create=True)
                    win, is_bucket = self._lane_of(c)
                    slots_l.append(slot)
                    deltas_l.append(dev_delta)
                    maxes_l.append(min(c.max_value, K.MAX_VALUE_CAP))
                    windows_l.append(win)
                    req_l.append(r)
                    fresh_l.append(is_fresh)
                    bucket_l.append(is_bucket)
                    slot_use_count[slot] = slot_use_count.get(slot, 0) + 1
                    dev_info.append((j, adjust))
                    if is_fresh:
                        fresh_hits.append((j, c, slot))
                        watch_touches.append(slot)
                        watched[slot] = seq
                    elif slot in watched:
                        # A later batch re-used a slot an earlier in-flight
                        # batch may want to release: the re-use wins.
                        watched[slot] = seq
                        watch_touches.append(slot)
                fresh_hits_by_req.append(fresh_hits)
                big_by_req.append(bigs)
                dev_info_by_req.append(dev_info)

            nhits = len(slots_l)
            H = _bucket(max(nhits, len(requests), 1))
            ints = np.stack([
                _staged(slots_l, H, self._scratch, np.int32),
                _staged(deltas_l, H, 0, np.int32),
                _staged(maxes_l, H, int(_INT32_MAX), np.int32),
                _staged(windows_l, H, 0, np.int32),
                _staged(req_l, H, H - 1, np.int32),
            ])
            flags = np.stack([
                _staged(fresh_l, H, False, bool),
                _staged(bucket_l, H, False, bool),
            ])
            with self._on_device():
                result = self._kernel_check(ints, flags, now_ms)
                host, ready = self._start_download(
                    result.hit_ok, result.remaining, result.ttl_ms
                )
        return _CheckHandle(
            requests, fresh_hits_by_req, slot_use_count, host, ready, seq,
            watch_touches, big_by_req, dev_info_by_req, now, big_projected,
        )

    def _start_download(self, *tensors: torch.Tensor):
        """Start device->host copies of ``tensors``: on the card, into
        pinned memory on the storage stream, with an event recorded after
        them; on the CPU the tensors are already host memory. Caller is
        inside ``_on_device``."""
        if not self._cuda:
            return tensors, None
        host = []
        for t in tensors:
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            dst.copy_(t, non_blocking=True)
            host.append(dst)
        ready = torch.cuda.Event()
        ready.record(self._stream)
        return tuple(host), ready

    def finish_check_many(self, handle: _CheckHandle) -> List[Authorization]:
        """Wait for and decode one in-flight batch: load_counters side
        effects, first-limited naming, and the reference's non-load
        early-return semantics (a limited non-load request does not create
        qualified counters past its first limited hit, in_memory.rs:110-133
        — only safe to undo when no other request in the batch shares the
        freshly-allocated slot and no later batch has re-used it)."""
        try:
            if handle.ready is not None:
                handle.ready.synchronize()
            hit_ok, remaining, ttl_ms = (t.numpy() for t in handle.host)
        except BaseException:
            # The projection reservations must not leak when the wait
            # fails, else those big counters under-admit forever — and
            # neither may the watch entries.
            with self._lock:
                self._unproject_big(handle.big_projected)
                watched = self._watched_slots
                for slot in handle.watch_touches:
                    if watched.get(slot) == handle.seq:
                        del watched[slot]
            raise

        auths: List[Authorization] = []
        releases: List[Tuple[Counter, int]] = []
        big_applies: List[Tuple[tuple, int, int]] = []  # key, delta, window
        base = 0
        for r, request in enumerate(handle.requests):
            dev_info = handle.dev_info_by_req[r]
            bigs = handle.big_by_req[r]
            n_dev = len(dev_info)
            oks_by_j: Dict[int, bool] = {}
            for i, (j, _adjust) in enumerate(dev_info):
                oks_by_j[j] = bool(hit_ok[base + i])
            for j, ok, _rem, _ttl, _key, _c, _delta in bigs:
                oks_by_j[j] = ok
            all_ok = all(oks_by_j.values())
            if request.load:
                for i, (j, adjust) in enumerate(dev_info):
                    c = request.ordered[j]
                    c.remaining = max(int(remaining[base + i]) - adjust, 0)
                    c.expires_in = float(ttl_ms[base + i]) / 1000.0
                for j, _ok, rem, ttl, _key, _c, _delta in bigs:
                    c = request.ordered[j]
                    c.remaining = rem
                    c.expires_in = ttl
            if all_ok:
                auths.append(Authorization.OK)
                for _j, _ok, _rem, _ttl, key, c, delta in bigs:
                    big_applies.append((key, delta, c.window_seconds))
            else:
                first = min(j for j, ok in oks_by_j.items() if not ok)
                auths.append(
                    Authorization.limited_by(
                        request.ordered[first].limit.name
                    )
                )
                if not request.load:
                    for j, c, slot in handle.fresh_hits_by_req[r]:
                        if j > first and handle.slot_use_count.get(slot) == 1:
                            releases.append((c, slot))
            base += n_dev
        with self._lock:
            self._unproject_big(handle.big_projected)
            self._apply_big(big_applies, handle.now)
            watched = self._watched_slots
            for c, slot in releases:
                if watched.get(slot) != handle.seq:
                    continue
                # The table must still map this key to this slot — an
                # intervening delete/evict/clear means the slot was already
                # freed (releasing again would double-free it).
                key = self._key_of(c)
                qualified = c.is_qualified()
                mapped = (
                    self._table.qualified.get(key) == slot
                    if qualified
                    else self._table.simple.get(key) == slot
                )
                if mapped:
                    self._table.release(slot, key, qualified)
            for slot in handle.watch_touches:
                if watched.get(slot) == handle.seq:
                    del watched[slot]
        return auths

    def check_many(self, requests: List[_Request]) -> List[Authorization]:
        """Run a batch of check-all-then-update-all requests in one kernel
        launch, in list order (== serial order for exactness)."""
        return self.finish_check_many(self.begin_check_many(requests))

    # -- columnar entry point (native serving path) ------------------------

    def check_columnar(self, slots, deltas, maxes, windows_ms, req_ids,
                       fresh, bucket=None):
        """One kernel over pre-built, request-ordered hit arrays (no
        per-hit Python objects). Caller pads to a bucket (``pad_hits``);
        returns host arrays (admitted, hit_ok, remaining, ttl_ms)."""
        return self.finish_check_columnar(
            self.begin_check_columnar(
                slots, deltas, maxes, windows_ms, req_ids, fresh, bucket
            )
        )

    def begin_check_columnar(self, slots, deltas, maxes, windows_ms,
                             req_ids, fresh, bucket=None) -> _ColumnarHandle:
        """Launch B1 over staged columns and return without waiting;
        ``finish_check_columnar`` collects. Launches are ordered by the
        storage lock and the storage stream, so a later begin is correct
        while earlier results are still in flight.

        The columns may be views of a staging buffer their owner reuses
        at its next begin (the C hot lane's scratch): they are copied
        into fresh host arrays here, just before the lock is taken, on
        the caller's thread and before this call returns, so the copy
        is taken before the owner's next begin can rewrite the buffer.
        ``bucket`` marks GCRA hits (``windows_ms`` then
        carries the emission interval); None means all fixed-window."""
        if bucket is None:
            bucket = np.zeros(slots.shape, bool)
        ints = np.stack([slots, deltas, maxes, windows_ms, req_ids]).astype(
            np.int32, copy=False
        )
        flags = np.stack([fresh, bucket]).astype(bool, copy=False)
        with self._lock:
            now_ms = self._now_ms()
            with self._on_device():
                d_ints, d_flags = self._upload(ints, flags)
                _, result = K.check_and_update_batch(
                    self._state, *d_ints, *d_flags, now_ms,
                )
                host, ready = self._start_download(
                    result.admitted, result.hit_ok
                )
        return _ColumnarHandle(host, ready, result.remaining, result.ttl_ms)

    def finish_check_columnar(self, handle: _ColumnarHandle,
                              with_remaining: bool = True):
        """Wait for a ``begin_check_columnar`` launch; returns host arrays
        (admitted, hit_ok, remaining, ttl_ms). ``with_remaining=False``
        downloads only the decision columns (remaining and ttl come back
        as None)."""
        if handle.ready is not None:
            handle.ready.synchronize()
        admitted, hit_ok = (t.numpy() for t in handle.host)
        if not with_remaining:
            return admitted, hit_ok, None, None
        with self._stream_scope():
            remaining, ttl_ms = self._download(
                handle.remaining, handle.ttl_ms
            )
        return admitted, hit_ok, remaining, ttl_ms

    def credit_columnar(self, slots, credits, windows_ms, bucket) -> None:
        """Return unused leased quota to the table (the lease broker's
        credit lane): one launch of B4c's host form, floored so a credit
        never creates more headroom than a fresh cell. ``slots`` must be
        unique and LIVE: the caller verifies slot->counter identity under
        this same lock, because a recycled slot's credit would land on
        another counter. The columns become one (0, slot, credit,
        interval, bucket << 1) list, unpadded."""
        n = int(slots.shape[0])
        if n == 0:
            return
        entries = np.zeros((n, 5), np.int32)
        entries[:, 1] = slots
        entries[:, 2] = credits
        entries[:, 3] = windows_ms
        entries[:, 4] = np.asarray(bucket, np.int32) << 1
        with self._lock:
            now_ms = self._now_ms()
            with self._on_device():
                K.credit_host(self._ctx, entries, now_ms)

    def pad_hits(self, arrays: Tuple[np.ndarray, ...], nhits: int):
        """Pad (slots, deltas, maxes, windows, req_ids, fresh[, bucket])
        to the next bucket with inert scratch hits."""
        H = _bucket(max(nhits, 1))
        slots, deltas, maxes, windows, req, fresh = arrays[:6]
        padded = (
            _staged(slots, H, self._scratch, np.int32),
            _staged(deltas, H, 0, np.int32),
            _staged(maxes, H, int(_INT32_MAX), np.int32),
            _staged(windows, H, 0, np.int32),
            _staged(req, H, H - 1, np.int32),
            _staged(fresh, H, False, bool),
        )
        if len(arrays) > 6:
            padded += (_staged(arrays[6], H, False, bool),)
        return padded

    # -- tier migration primitives (tier/storage.py) -----------------------

    def peek_slots(self, slots) -> Tuple[np.ndarray, np.ndarray]:
        """(value, ttl_ms) host arrays for ``slots`` at the current clock,
        the read half of an exact demotion: one B3a host-form read
        (``_read``), after every launch before it on the storage stream.
        The JAX storage pads the list to the pow2 bucket with the scratch
        slot and drops those rows; a bare list gives the same answers.
        Caller holds the lock: the read must be atomic with the residency
        change it feeds."""
        now_ms = self._now_ms()
        return self._read(slots, now_ms)

    def seed_slot_values(self, slots, values, expiry_rel_ms) -> None:
        """Absolute cell write for ``slots`` (tier promotion): value and
        epoch-relative expiry land verbatim through one B4d launch, so the
        counter keeps its exact remaining window (the update lane's
        ``fresh`` flag would restart it). Caller holds the lock. The
        lists go by value through the bound context; the JAX storage's
        padding to the pow2 bucket is the ``padded`` flag."""
        n = len(slots)
        if n == 0:
            return
        self._flush_clears()
        K.seed_slots_host(
            self._ctx, np.asarray(slots, np.int32),
            np.asarray(values, np.int32),
            np.asarray(expiry_rel_ms, np.int32), _bucket(n) > n,
        )

    # -- CounterStorage ----------------------------------------------------

    def _read(self, slots: Sequence[int], now_ms: int):
        """(values, ttl_ms) host arrays for ``slots``: B3a's host form
        through the bound context (one C call, one launch per parameter
        block, no upload, no tensor), answered after the staged clears
        and every launch queued before it on the storage stream. Caller
        holds the lock."""
        self._flush_clears()
        return K.read_slots_host(self._ctx, np.asarray(slots, np.int32),
                                 now_ms)

    def is_within_limits(self, counter: Counter, delta: int) -> bool:
        with self._lock:
            now_ms = self._now_ms()
            if self._is_big(counter):
                key = self._key_of(counter)
                entry = self._big.get(key)
                value = (
                    entry[0].value_at(self._clock())
                    if entry is not None else 0
                ) + self._big_remote_sum(key, self._clock())
                return value + delta <= counter.max_value
            slot, _ = self._slot_for(counter, create=False)
            if slot is None:
                value = 0
            else:
                v, ttl = self._read([slot], now_ms)
                if counter.limit.policy == "token_bucket":
                    # Bucket cells: the ttl lane is base_rel = max(TAT-now,
                    # 0); spent tokens derive from it (values lane is
                    # unspecified for buckets).
                    value = spent_tokens(
                        counter.max_value, counter.window_seconds, int(ttl[0])
                    )
                else:
                    value = int(v[0])
        return value + delta <= counter.max_value

    def _clear(self, slots: Sequence[int]) -> None:
        """Zero the cells of ``slots`` now, with any staged clears: one
        B3b host-form call (``_flush_clears``). Caller holds the lock."""
        self._staged_clears.update(dict.fromkeys(map(int, slots)))
        self._flush_clears()

    def _stage_clear(self, slot: int) -> None:
        """Owe the cell of ``slot`` a clear, launched with every other
        staged clear before the table's next access: each device access
        of the table enters ``_on_device``, ``_read`` or
        ``seed_slot_values``, which flush first. Clears commute and are
        idempotent, so every launch and read sees the cells that clearing
        at once would leave, a slot recycled while staged included.
        Caller holds the lock."""
        self._staged_clears[slot] = None

    def _flush_clears(self) -> None:
        """Launch the staged clears: B3b's host form over the list (the
        kernel's parameter block through the bound context; one launch
        per 8,000 slots), no upload, no tensor. Caller holds the lock."""
        staged = self._staged_clears
        if not staged:
            return
        K.clear_slots_host(self._ctx,
                           np.fromiter(staged, np.int32, len(staged)))
        self._staged_clears = {}

    def add_counter(self, limit: Limit) -> None:
        if not limit.variables:
            with self._lock:
                counter = Counter(limit, {})
                if self._is_big(counter):
                    self._big_cell(counter, self._key_of(counter))
                else:
                    slot, fresh = self._slot_for(counter, create=True)
                    if fresh:
                        # No kernel batch follows this allocation, so the
                        # kernel's fresh-flag override can't clean a
                        # recycled slot — clear the cell now or the next
                        # (non-fresh) read/batch sees the old occupant.
                        self._clear([slot])

    def update_counter(self, counter: Counter, delta: int) -> None:
        require_nonnegative_delta(delta)
        with self._lock:
            now_ms = self._now_ms()
            if self._is_big(counter):
                key = self._key_of(counter)
                cell = self._big_cell(counter, key)
                cell.update(int(delta), counter.window_seconds, self._clock())
                self._on_big_write(key)
                return
            entries = np.asarray([self._update_row(counter, delta)],
                                 np.int32)
            with self._on_device():
                self._kernel_update(entries, now_ms)

    def check_and_update(
        self, counters: List[Counter], delta: int, load_counters: bool
    ) -> Authorization:
        if not counters:
            return Authorization.OK
        return self.check_many([_Request(counters, delta, load_counters)])[0]

    def get_counters(self, limits: Set[Limit]) -> Set[Counter]:
        out: Set[Counter] = set()
        with self._lock:
            now_ms = self._now_ms()
            now = self._clock()
            namespaces = {limit.namespace for limit in limits}
            # Gather only the matching live slots: O(matching counters)
            # read back, not O(capacity).
            matching: List[Tuple[int, Counter]] = [
                (slot, counter)
                for slot, (_key, counter) in self._table.info.items()
                if counter.limit in limits or counter.namespace in namespaces
            ]
            if matching:
                values, ttls = self._read([s for s, _c in matching], now_ms)
                for i, (_slot, counter) in enumerate(matching):
                    ttl_ms = int(ttls[i])
                    if ttl_ms <= 0:
                        # fixed window expired / bucket full: no live state
                        continue
                    c = counter.key()
                    if c.limit.policy == "token_bucket":
                        c.remaining = c.max_value - spent_tokens(
                            c.max_value, c.window_seconds, ttl_ms
                        )
                    else:
                        c.remaining = c.max_value - int(values[i])
                    c.expires_in = ttl_ms / 1000.0
                    out.add(c)
            self._emit_big_counters(limits, namespaces, now, out)
        return out

    def delete_counters(self, limits: Set[Limit]) -> None:
        with self._lock:
            doomed: List[int] = []
            for slot, (key, counter) in list(self._table.info.items()):
                if counter.limit in limits:
                    doomed.append(slot)
                    self._table.release(slot, key, counter.is_qualified())
            if doomed:
                self._clear(doomed)
            self._delete_big(limits)

    def drop_counters(self, counters) -> int:
        """Release the cells of ``counters`` (the elastic pod's source,
        once the new owner acknowledged a moved slice): their slots return
        to the free list and their cells are zeroed by one B3b host-form
        launch; a beyond-cap counter's host cell is dropped. Returns the
        number of cells that existed."""
        released = 0
        with self._lock:
            doomed: List[int] = []
            for counter in counters:
                key = self._key_of(counter)
                if self._is_big(counter):
                    if self._big.pop(key, None) is not None:
                        released += 1
                    continue
                qualified = counter.is_qualified()
                slot = self._table.lookup(key, qualified)
                if slot is None:
                    continue
                self._table.release(slot, key, qualified)
                doomed.append(slot)
            if doomed:
                self._clear(doomed)
        return released + len(doomed)

    def _replace_table(self) -> _SlotTable:
        """Swap in a fresh slot table, carrying the coherence hooks over
        and firing the wholesale invalidation (every slot index issued
        before is dead). Caller holds the lock."""
        old = self._table
        self._table = _SlotTable(self._capacity)
        self._table.on_native_release = old.on_native_release
        self._table.on_slot_release = old.on_slot_release
        self._table.on_clear = old.on_clear
        if old.on_clear is not None:
            old.on_clear()
        return self._table

    def clear(self) -> None:
        with self._lock:
            self._replace_table()
            with self._on_device():
                self._state = K.make_table(self._capacity, self._device)
            self._watched_slots.clear()
            self._clear_big()

    def apply_deltas(self, items):
        """Batched unconditional increments (the Report path through the
        ``UpdateBatcher``, and write-behind authorities): one B2 launch
        through ``_kernel_update`` and one B3a read (``_read``) for every
        device counter; beyond-cap counters update their host cells. Returns
        (value, ttl_s) per item, in order."""
        for _counter, delta in items:
            require_nonnegative_delta(delta)
        with self._lock:
            now_ms = self._now_ms()
            now = self._clock()
            dev_items: List[Tuple[int, Counter, int]] = []
            results: List[Optional[Tuple[int, float]]] = [None] * len(items)
            for i, (counter, delta) in enumerate(items):
                if self._is_big(counter):
                    key = self._key_of(counter)
                    cell = self._big_cell(counter, key)
                    value = cell.update(
                        int(delta), counter.window_seconds, now
                    )
                    self._on_big_write(key)
                    results[i] = (value, cell.ttl(now))
                else:
                    dev_items.append((i, counter, delta))
            if dev_items:
                entries = np.asarray(
                    [self._update_row(counter, delta)
                     for _i, counter, delta in dev_items], np.int32)
                with self._on_device():
                    self._kernel_update(entries, now_ms)
                values, ttls = self._read(entries[:, 1], now_ms)
                for k, (i, counter, _delta) in enumerate(dev_items):
                    if entries[k, 4] & 2:
                        value = spent_tokens(
                            counter.max_value, counter.window_seconds,
                            int(ttls[k]),
                        )
                    else:
                        value = int(values[k])
                    results[i] = (value, float(ttls[k]) / 1000.0)
        return results

    def warm_apply(self) -> None:
        """Launch ``apply_deltas``' kernels once on the card, on a table of
        one counter of their own bound to this storage's stream (the
        served table is not touched): a shared authority calls it before
        it serves, so that a replica's first flush to a fresh process
        does not pay the kernels' first load inside its response timeout.
        Nothing to do on the CPU."""
        if not self._cuda:
            return
        with self._lock, self._on_device():
            ctx = K.TableContext(K.make_table(1, self._device), self._stream)
            try:
                self._warm_update(ctx, np.asarray([[0, 0, 1, 1000, 1]],
                                                  np.int32))
                K.read_slots_host(ctx, np.zeros(1, np.int32), 0)
            finally:
                ctx.close()

    def _warm_update(self, ctx, entries: np.ndarray) -> None:
        """``warm_apply``'s update: ``_kernel_update``'s kernel on the
        warm-up table's context."""
        K.update_host(ctx, entries, 0)

    # -- checkpoint / resume ---------------------------------------------

    SNAPSHOT_FORMAT = "limitador_tpu_torch/1"

    def snapshot(self, path: str) -> None:
        """Persist the counter state (device cells of the occupied slots
        and the host key space) so that a restart resumes counting, as
        the JAX package's ``TpuStorage.snapshot`` does. Sparse: O(live
        counters), not O(capacity).

        The file is this package's own pickle (``SNAPSHOT_FORMAT``): it
        holds the port's ``Counter`` and ``Limit`` objects, so a JAX
        checkpoint, which pickles ``limitador_tpu`` classes, does not load
        here, nor does this one there. The hit accumulator is telemetry
        and is not kept. Host cells ride in the table: the big-limit map
        here, the cold tier too in ``TieredStorage``."""
        import pickle

        with self._lock:
            occupied = np.asarray(sorted(self._table.info), np.int32)
            if occupied.size:
                with self._on_device():
                    (idx,) = self._upload(occupied)
                    idx = idx.long()
                    values, expiry = self._download(
                        self._state.values[idx], self._state.expiry_ms[idx]
                    )
            else:
                values = np.zeros(0, np.int32)
                expiry = np.zeros(0, np.int32)
            table = self._snapshot_table()
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "format": self.SNAPSHOT_FORMAT,
                    "slots": occupied,
                    "values": values,
                    "expiry": expiry,
                    "table": table,
                },
                f,
            )

    def _snapshot_table(self) -> dict:
        """The key space and host cells of a checkpoint. Caller holds the
        lock."""
        return {
            "capacity": self._capacity,
            "cache_size": self._cache_size,
            "epoch": self._epoch,
            **self._table.dump(),
            "big": cell_rows(self._big),
        }

    def _load_cold(self, rows: dict) -> None:
        """A checkpoint's cold-tier cells: only ``TieredStorage`` holds
        them. Loading one here would drop those counters' spent quota, so
        a tiered checkpoint is refused."""
        if rows:
            raise StorageError(
                f"the checkpoint holds {len(rows)} cold-tier counters; "
                "restore it into TieredStorage (--tier-mode on)"
            )

    @classmethod
    def read_snapshot(cls, path: str) -> dict:
        """The contents of a ``snapshot`` file. Unpickling resolves only
        this package's classes, numpy's and the standard library's: a
        checkpoint of another package (the JAX package's pickles
        ``limitador_tpu`` classes) raises ``StorageError`` instead of
        importing that package."""
        import pickle

        class _Unpickler(pickle.Unpickler):
            def find_class(self, module, name):
                if module.split(".")[0] not in _SNAPSHOT_MODULES:
                    raise pickle.UnpicklingError(
                        f"{module}.{name} is not a class of this package"
                    )
                return super().find_class(module, name)

        try:
            with open(path, "rb") as f:
                data = _Unpickler(f).load()
        except pickle.UnpicklingError as exc:
            raise StorageError(f"{path}: {exc}") from exc
        if not isinstance(data, dict) or data.get("format") != \
                cls.SNAPSHOT_FORMAT:
            raise StorageError(
                f"{path} is not a {cls.SNAPSHOT_FORMAT} checkpoint"
            )
        return data

    def _apply_snapshot(self, data: dict) -> None:
        """Load checkpoint contents into this storage (capacities already
        verified to match). The saved cells scatter back by a plain index
        assignment, as the JAX package's ``.at[].set`` does."""
        table = data["table"]
        self._load_cold(table.get("cold", {}))
        with self._lock:
            # The saved epoch keeps absolute expiries right; _now_ms
            # rebases on its own schedule afterwards.
            self._epoch = table["epoch"]
            slots = np.asarray(data["slots"], np.int32)
            if slots.size:
                with self._on_device():
                    idx, values, expiry = self._upload(
                        slots, np.asarray(data["values"], np.int32),
                        np.asarray(data["expiry"], np.int32),
                    )
                    idx = idx.long()
                    self._state.values[idx] = values
                    self._state.expiry_ms[idx] = expiry
            self._replace_table()
            self._table.load(table, 0, self._capacity)
            for key, (a, b, counter) in table.get("big", {}).items():
                self._big[key] = (restore_cell(counter.limit, a, b), counter)

    def load_snapshot(self, path: str) -> None:
        """Restore a checkpoint into an already-built storage (the
        replicated subclass restores this way: its constructor owns the
        broker wiring, then the state loads in)."""
        data = self.read_snapshot(path)
        capacity = data["table"]["capacity"]
        if capacity != self._capacity:
            raise StorageError(
                f"snapshot capacity {capacity} != storage capacity "
                f"{self._capacity} (slot indices would shift)"
            )
        self._apply_snapshot(data)

    @classmethod
    def restore(cls, path: str, cache_size=None, clock=time.time,
                device=None, **kwargs) -> "TorchStorage":
        """A storage built from a checkpoint. ``cache_size`` may be
        overridden; the capacity is the checkpoint's (slot indices would
        shift otherwise). ``kwargs`` go to the constructor (a tiered
        storage's ``spill_path``)."""
        return cls.from_snapshot(cls.read_snapshot(path), cache_size,
                                 clock, device, **kwargs)

    @classmethod
    def from_snapshot(cls, data: dict, cache_size=None, clock=time.time,
                      device=None, **kwargs) -> "TorchStorage":
        """``restore`` from ``read_snapshot``'s contents."""
        table = data["table"]
        self = cls(
            capacity=table["capacity"],
            cache_size=cache_size or table["cache_size"],
            clock=clock, device=device, **kwargs,
        )
        self._apply_snapshot(data)
        return self

    def close(self) -> None:
        """Wait for every launch on the storage stream."""
        if self._cuda:
            self._stream.synchronize()
