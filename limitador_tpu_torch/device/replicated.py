"""Replicated device counter storage: device-resident counts gossiped
across nodes.

Counterpart of ``limitador_tpu/tpu/replicated.py`` (``TpuReplicatedStorage``
-> ``TorchReplicatedStorage``). Each node keeps its own hit counts in its
device table (exact local admission at device speed), while a CRDT gossip
layer (the ``Broker`` of ``storage/distributed/broker.py``, the JAX
package's wire protocol) replicates per-actor counts between nodes.
Admission sees

    value = own device count  +  sum of live remote actors' counts

the read-as-sum of upstream limitador's CRDT mode (cr_counter_value.rs:
38-46) with the local addend on the card. Remote shares sit in two more
int32[C+1] lanes on the storage's device: ``remote_vals`` (the live sum of
peers' window counts per slot) and ``remote_exp`` (their latest expiry for
windows, the max-merged remote TAT for token buckets), both relative to
the table's epoch. Gossip merges per actor by max on the host (idempotent,
commutative) and queues the refreshed shares; they scatter to the device
(B6c's host form, ``apply_remote_host``) before the next launch or read.
The two lanes are bound in a launch context of their own (``_remote_ctx``,
as ``CounterTableState(remote_vals, remote_exp, remote_exp)``), through
which the flushes write and ``_read_remote`` reads (B3a's host form).
Checks launch B6a (``replicated_check_batch``: window lanes add the live
remote sum, bucket lanes floor their TAT at the remote TAT),
unconditional updates B6b's host form (``replicated_update_host``: the
list by value, the TAT floor read from the remote context's expiry lane
before the advance).

Consistency contract: local decisions are exact against (own + last
gossiped remote) counts; cross-node over-admission is bounded by the
gossip period, the reference's documented distributed-mode behaviour.

Counters of limits whose max_value exceeds the int32 device cap (2^30)
live in the host-side big-limit cells (exact Python ints); their local
counts gossip through the same broker stream and the remote per-actor
sums fold into host-side admission via ``_big_remote_sum``.

The native columnar pipeline and the lease tier are refused on a
replicated node: they launch B1 directly (``begin_check_columnar``,
``credit_columnar``), where the remote share would not fold in and the
admitted counters would never gossip.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.counter import Counter
from ..ops import kernel as K
from ..storage.base import StorageError
from ..storage.gcra import GcraValue, spent_tokens
from ..storage.keys import (
    LimitKeyIndex,
    key_for_counter,
    partial_counter_from_key,
)
from .storage import TorchStorage

__all__ = ["TorchReplicatedStorage", "DEFAULT_GOSSIP_PERIOD"]

DEFAULT_GOSSIP_PERIOD = 0.1


class TorchReplicatedStorage(TorchStorage):
    # Token buckets replicate as a shared TAT max-merged per actor: the TAT
    # is monotone under both admission (max(TAT, now) + d*I) and merge
    # (max), so gossip is idempotent, commutative and associative. The wire
    # reuses the (count, expires_at) pair: count carries the TAT in the
    # limit's ticks, expires_at the TAT in absolute ms (a TAT in the past
    # is a full bucket, no state). Local admission checks against
    # max(local TAT, gossiped remote TAT) and persists the join; the
    # unconditional update path folds the same floor through B6b.
    supports_token_bucket = True

    def __init__(
        self,
        node_id: str,
        listen_address: Optional[str] = None,
        peers: Optional[List[str]] = None,
        capacity: int = 1 << 20,
        cache_size: Optional[int] = None,
        gossip_period: float = DEFAULT_GOSSIP_PERIOD,
        clock=time.time,
        advertise_address: Optional[str] = None,
        device=None,
        start: bool = True,
    ):
        """A node of the replicated topology. With ``listen_address`` it
        builds a ``Broker`` (gRPC on that address, dialing ``peers``) and
        a gossip thread publishing locally touched counters every
        ``gossip_period`` seconds, and starts both unless ``start`` is
        False (then ``start()`` does, e.g. after ``load_snapshot``);
        without one it gossips only through a ``broker`` attribute the
        caller sets. ``device`` is the card unless "cpu" is asked for."""
        super().__init__(capacity=capacity, cache_size=cache_size,
                         clock=clock, device=device)
        self.node_id = node_id
        self.gossip_period = gossip_period
        with self._on_device():
            self._remote_lanes = tuple(
                torch.zeros(capacity + 1, dtype=torch.int32,
                            device=self._device) for _ in range(2))
        # host-side per-actor remote state: key -> {actor: (count, exp_ms)}
        self._remote_actors: Dict[bytes, Dict[str, Tuple[int, int]]] = {}
        self._dirty_remote: Dict[int, Tuple[int, int]] = {}  # slot -> (sum, exp)
        self._touched: set = set()  # slots touched locally since last gossip
        # big-limit (host-side) cells: identity tuple <-> wire key, plus
        # the set touched locally since the last gossip tick
        self._big_wire: Dict[tuple, bytes] = {}
        self._touched_big: set = set()
        # wire keys whose limit wasn't configured when gossip arrived
        self._parked_wires: set = set()
        self.broker = None
        self._gossip_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if listen_address is not None:
            from ..storage.distributed.broker import Broker

            self.broker = Broker(
                peer_id=node_id,
                listen_address=listen_address,
                peer_urls=peers or [],
                on_update=self._on_remote_update,
                snapshot_provider=self._snapshot_for_peer,
                advertise_address=advertise_address,
            )
            if start:
                self.start()

    def start(self) -> None:
        """Start the broker and the gossip thread (once)."""
        if self.broker is None or self._gossip_thread is not None:
            return
        self.broker.start()
        self._gossip_thread = threading.Thread(
            target=self._gossip_loop, daemon=True,
            name=f"torch-gossip-{self.node_id}",
        )
        self._gossip_thread.start()

    # -- the remote lanes and their launch context --------------------------

    @property
    def _remote_lanes(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(remote_vals, remote_exp). Every assignment binds a new launch
        context over them (``_remote_ctx``; B3a reads only values and
        expiry, B6c writes only those, so ``hits`` aliases the expiry
        lane) and closes the old one, as ``_state`` does for the table."""
        state = self._remote_ctx.state
        return state.values, state.expiry_ms

    @_remote_lanes.setter
    def _remote_lanes(self, lanes) -> None:
        vals, exp = lanes
        old = self.__dict__.get("_remote_ctx")
        self._remote_ctx = K.TableContext(
            K.CounterTableState(vals, exp, exp), self._stream)
        if old is not None:
            old.close()

    @property
    def _remote_vals(self) -> torch.Tensor:
        return self._remote_ctx.state.values

    @property
    def _remote_exp(self) -> torch.Tensor:
        return self._remote_ctx.state.expiry_ms

    # -- kernel dispatch with the remote base ------------------------------

    def _kernel_check(self, ints, flags, now_ms):
        self._flush_dirty_remote()
        self._touched.update(
            int(s) for s in np.unique(ints[0]) if s != self._scratch
        )
        d_ints, d_flags = self._upload(ints, flags)
        _, result = K.replicated_check_batch(
            self._state, self._remote_vals, self._remote_exp,
            *d_ints, *d_flags, now_ms,
        )
        return result

    def _kernel_update(self, entries, now_ms):
        """B6b's host form on the storage's list of (0, slot, delta,
        window, flags) entries, through the table's and the remote lanes'
        current contexts, after the remote flush queued on the same
        stream."""
        self._flush_dirty_remote()
        K.replicated_update_host(self._ctx, self._remote_ctx, entries,
                                 now_ms)

    def _warm_update(self, ctx, entries):
        """B6b on the warm-up table, its own empty remote lanes beside."""
        remote = K.TableContext(K.make_table(1, self._device), self._stream)
        try:
            K.replicated_update_host(ctx, remote, entries, 0)
        finally:
            remote.close()

    def begin_check_columnar(self, *args, **kwargs):
        raise StorageError(
            "the columnar (native pipeline) check launches the plain "
            "check kernel: on a replicated node the gossiped remote counts "
            "would not fold into admission and admitted counters would "
            "not gossip"
        )

    def credit_columnar(self, *args, **kwargs):
        raise StorageError(
            "quota leases are not supported on a replicated node: their "
            "grants and credits bypass the gossiped remote counts"
        )

    def _slot_for(self, counter: Counter, create: bool):
        slot, fresh = super()._slot_for(counter, create)
        if fresh and slot is not None:
            # Remote updates that arrived before this counter's limit was
            # configured locally parked in _remote_actors; adopt them now.
            # Always queued (also when this key has no remote state): a
            # recycled slot's remote lane may still carry the previous
            # occupant's live remote entry.
            self._queue_remote_sum(
                key_for_counter(counter), slot, counter=counter
            )
        return slot, fresh

    def _clear_adopted_slot(self, slot: int) -> None:
        """Owe a freshly allocated slot's local device cell a clear (B3b).
        Adoption paths (gossip or re-sync for a counter this node never
        served) allocate without a following kernel batch, so the
        kernel's fresh-flag override never cleans a recycled slot. The
        JAX node clears each at once; here the clear is staged
        (``_stage_clear``), and a merge that adopts a thousand counters
        reaches the card as one B3b host-form call before the table's
        next access. Caller holds the lock."""
        self._stage_clear(slot)

    def _queue_remote_sum(
        self, key: bytes, slot: int, counter: Optional[Counter] = None
    ) -> None:
        """Recompute the live remote share for a key and queue the device
        scatter. Fixed windows: (sum of live counts, max expiry). Token
        buckets: (0, max live remote TAT), the TAT riding the expiry lane
        as the kernel's floor. Caller holds the lock."""
        actors = self._remote_actors.get(key, {})
        now_ms = self._now_ms()
        epoch_ms = self._epoch * 1000
        if counter is None:
            info = self._table.info.get(slot)
            counter = info[1] if info is not None else None
        is_bucket = (
            counter is not None
            and counter.limit.policy == "token_bucket"
        )
        # liveness: expires_at (windows) / TAT (buckets) still ahead
        live = [(c, e) for c, e in actors.values() if e - epoch_ms > now_ms]
        if is_bucket:
            # device-eligible buckets tick in ms, so the gossiped tick
            # count and the abs-ms lane agree; merge is max
            tat_rel = max((int(e - epoch_ms) for _c, e in live), default=0)
            self._dirty_remote[slot] = (
                0, max(0, min(tat_rel, (1 << 31) - 1))
            )
            return
        total = sum(c for c, _e in live)
        exp_rel = max((int(e - epoch_ms) for _c, e in live), default=0)
        self._dirty_remote[slot] = (
            min(total, K.MAX_VALUE_CAP),
            max(0, min(exp_rel, (1 << 31) - 1)),
        )

    def _on_big_write(self, key: tuple) -> None:
        # Caller holds the lock; the gossip tick publishes.
        self._touched_big.add(key)

    def _wire_for(self, key: tuple, counter: Counter) -> bytes:
        """Identity tuple -> wire key, filled on first use (the codec is
        deterministic, so a local wire key equals the bytes a peer
        gossips for the same counter). Caller holds the lock."""
        wire = self._big_wire.get(key)
        if wire is None:
            wire = key_for_counter(counter)
            self._big_wire[key] = wire
        return wire

    def _big_cell(self, counter: Counter, key: tuple):
        cell = super()._big_cell(counter, key)
        # The mapping doubles as adoption: per-actor state that gossiped
        # in before this limit was configured becomes visible now.
        self._wire_for(key, counter)
        return cell

    def _lift_big_bucket(self, key: tuple, cell: GcraValue) -> None:
        """Max-merge live remote TATs into the local host bucket cell
        (beyond-device buckets; peers gossip the TAT in the limit's own
        ticks, with the abs-ms TAT as the liveness lane). Caller holds
        the lock."""
        wire = self._big_wire.get(key)
        actors = self._remote_actors.get(wire) if wire is not None else None
        if not actors:
            return
        now_abs_ms = self._clock() * 1000
        for tat_ticks, exp_ms in actors.values():
            if exp_ms > now_abs_ms and tat_ticks > cell.tat:
                cell.tat = int(tat_ticks)

    def _big_remote(self, key: tuple, now: float):
        """(live remote sum, max live expiry abs-ms), one actors pass.
        Bucket cells fold the remote share into the cell (shared TAT), so
        their remote sum is 0."""
        entry = self._big.get(key)
        if entry is not None and isinstance(entry[0], GcraValue):
            self._lift_big_bucket(key, entry[0])
            return 0, 0
        wire = self._big_wire.get(key)
        actors = self._remote_actors.get(wire) if wire is not None else None
        if not actors:
            return 0, 0
        now_abs_ms = now * 1000
        total = 0
        max_exp = 0
        for count, exp in actors.values():
            if exp > now_abs_ms:
                total += count
                if exp > max_exp:
                    max_exp = exp
        return total, max_exp

    def _big_remote_sum(self, key: tuple, now: float) -> int:
        return self._big_remote(key, now)[0]

    def _adopt_parked(self) -> None:
        """Fold gossip that arrived before its limit was configured:
        decodable big counters get a host cell (and wire mapping), device
        counters a slot, so admission and the merged view see it
        regardless of arrival order. Caller holds the lock."""
        for wire in list(self._parked_wires):
            counter = self._decode_counter(wire)
            if counter is None:
                continue
            self._parked_wires.discard(wire)
            if self._is_big(counter):
                key_t = self._key_of(counter)
                self._big_wire[key_t] = wire
                self._big_cell(counter, key_t)
            else:
                slot, fresh = self._slot_for(counter, create=True)
                if fresh:
                    self._clear_adopted_slot(slot)
                self._queue_remote_sum(wire, slot)

    def _emit_big_counters(self, limits, namespaces, now, out) -> None:
        """Merged (local + live remote) view of big counters, including
        remote-only ones whose local cell never fired."""
        self._adopt_parked()
        for key, (cell, counter) in list(self._big.items()):
            if not (
                counter.limit in limits or counter.namespace in namespaces
            ):
                continue
            local = 0 if cell.is_expired(now) else cell.value_at(now)
            remote, remote_exp = self._big_remote(key, now)
            if cell.is_expired(now) and remote <= 0:
                continue
            ttl = cell.ttl(now) if not cell.is_expired(now) else 0.0
            if remote_exp:
                ttl = max(ttl, remote_exp / 1000.0 - now)
            c = counter.key()
            c.remaining = c.max_value - local - remote
            c.expires_in = ttl
            out.add(c)

    def _delete_big(self, limits) -> None:
        with self._lock:
            doomed = [
                key
                for key, (_cell, counter) in self._big.items()
                if counter.limit in limits
            ]
            for key in doomed:
                # Drop the mapping and pending publish but keep the
                # per-actor remote state, as the device delete path does:
                # a live peer's window is re-adopted at the next touch.
                self._big_wire.pop(key, None)
                self._touched_big.discard(key)
        super()._delete_big(limits)

    def update_counter(self, counter: Counter, delta: int) -> None:
        super().update_counter(counter, delta)
        if self._is_big(counter):
            return  # _on_big_write already queued the gossip
        # unconditional updates bypass _kernel_check; still gossip them
        with self._lock:
            slot, _ = self._slot_for(counter, create=False)
            if slot is not None:
                self._touched.add(slot)

    def apply_deltas(self, items):
        # The batched Report path (UpdateBatcher) lands here; like
        # update_counter, these increments must still gossip.
        out = super().apply_deltas(items)
        with self._lock:
            for counter, _delta in items:
                if self._is_big(counter):
                    continue  # _on_big_write already queued the gossip
                slot, _ = self._slot_for(counter, create=False)
                if slot is not None:
                    self._touched.add(slot)
        return out

    def _now_ms(self) -> int:
        # The parent rebases the table's epoch on long uptimes; the remote
        # expiry lane shares that epoch and shifts with it (B4a).
        prev_epoch = self._epoch
        now = super()._now_ms()
        if self._epoch != prev_epoch:
            shift = int((self._epoch - prev_epoch) * 1000)
            with self._on_device():
                K.rebase_epoch_chunked(self._remote_exp, shift)
        return now

    def _flush_dirty_remote(self) -> None:
        """Scatter the queued remote shares into the remote lanes: B6c's
        host form over the dirty slots, packed in one pass over the map
        (one C call and one launch on the storage stream). Caller holds
        the lock."""
        dirty = self._dirty_remote
        if not dirty:
            return
        self._dirty_remote = {}
        n = len(dirty)
        slots = np.fromiter(dirty, np.int32, n)
        shares = np.fromiter(itertools.chain.from_iterable(dirty.values()),
                             np.int32, 2 * n)
        K.apply_remote_host(self._remote_ctx, slots, shares[0::2],
                            shares[1::2])

    # -- reads include remote counts ----------------------------------------

    def _read_remote(self, slots, now_ms: int):
        """(live remote sum, remote ttl_ms) host arrays for ``slots``, after
        a flush: B3a's host form over the remote lanes' context, whose
        values and expiry stand in for a table's (B3a reads no other
        column). The sum is 0 unless ``now < remote_exp``; ttl is
        max(remote_exp - now, 0). Caller holds the lock."""
        self._flush_dirty_remote()
        return K.read_slots_host(self._remote_ctx,
                                 np.asarray(slots, np.int32), now_ms)

    def set_limits_provider(self, provider) -> None:
        """Wired by the Storage facade: lets wire-key decoding see limits
        configured locally before any counter touched them."""
        self._limits_provider = provider

    def is_within_limits(self, counter: Counter, delta: int) -> bool:
        if self._is_big(counter):
            # Host cell; the parent's big branch folds the gossiped remote
            # share via _big_remote_sum. Parked gossip for this counter is
            # adopted first.
            with self._lock:
                if key_for_counter(counter) in self._remote_actors:
                    self._big_cell(counter, self._key_of(counter))
            return super().is_within_limits(counter, delta)
        with self._lock:
            now_ms = self._now_ms()
            create = key_for_counter(counter) in self._remote_actors
            slot, fresh = self._slot_for(counter, create=create)
            if slot is None:
                return delta <= counter.max_value
            if fresh:
                self._clear_adopted_slot(slot)
            v, ttl = self._read([slot], now_ms)
            # A freshly allocated or recycled slot's cell is the previous
            # occupant's: local reads are 0 until the first write (the
            # remote lane was re-queued by _slot_for and flushes below).
            r, r_ttl = self._read_remote([slot], now_ms)
            if counter.limit.policy == "token_bucket":
                # merged spent derives from the max of local and remote TAT
                local_rel = 0 if fresh else int(ttl[0])
                value = spent_tokens(
                    counter.max_value, counter.window_seconds,
                    max(local_rel, int(r_ttl[0])),
                )
            else:
                local_v = 0 if fresh else int(v[0])
                value = local_v + int(r[0])
        return value + delta <= counter.max_value

    def get_counters(self, limits):
        out = super().get_counters(limits)
        with self._lock:
            now_ms = self._now_ms()
            self._flush_dirty_remote()
            merged = []
            for c in out:
                qualified_slot = self._table.qualified.get(self._key_of(c))
                slot = (
                    qualified_slot
                    if qualified_slot is not None
                    else self._table.simple.get(self._key_of(c))
                )
                if slot is not None and c.remaining is not None:
                    merged.append((slot, c))
            if merged:
                # one batched read of every local counter's remote share
                rvals, rttls = self._read_remote(
                    [s for s, _c in merged], now_ms)
                for i, (_slot, c) in enumerate(merged):
                    r_ttl = int(rttls[i])
                    if r_ttl <= 0:
                        continue
                    if c.limit.policy == "token_bucket":
                        # shared TAT: merged spent is the max, not a sum
                        r_spent = spent_tokens(
                            c.max_value, c.window_seconds, r_ttl
                        )
                        c.remaining = min(
                            c.remaining, c.max_value - r_spent
                        )
                        c.expires_in = max(c.expires_in, r_ttl / 1000.0)
                    else:
                        c.remaining -= int(rvals[i])
            # Remote-only counters: gossiped from peers, never hit here.
            # The local cell is expired so the base pass skipped them, but
            # the merged view lists them (the reference's distributed
            # get_counters reads the CRDT sum).
            seen = set(out)
            namespaces = {limit.namespace for limit in limits}
            candidates = []
            for slot, (_key, counter) in self._table.info.items():
                if (
                    counter.limit not in limits
                    and counter.namespace not in namespaces
                ):
                    continue
                probe = counter.key()
                if probe not in seen:
                    candidates.append((slot, probe))
            if candidates:
                rvals, rttls = self._read_remote(
                    [s for s, _p in candidates], now_ms)
                for i, (_slot, probe) in enumerate(candidates):
                    r, r_ttl = int(rvals[i]), int(rttls[i])
                    if r_ttl <= 0:
                        continue
                    if probe.limit.policy == "token_bucket":
                        # remote-only bucket: spent derives from the
                        # gossiped TAT (the count lane is unused)
                        r = spent_tokens(
                            probe.max_value, probe.window_seconds, r_ttl
                        )
                    if r <= 0:
                        continue
                    probe.remaining = probe.max_value - r
                    probe.expires_in = r_ttl / 1000.0
                    out.add(probe)
        return out

    # -- gossip plumbing ----------------------------------------------------

    def _on_remote_update(
        self, key: bytes, values: Dict[str, int], expires_at_ms: int
    ) -> None:
        """Merge a peer's snapshot: per-actor max (idempotent), recompute
        the slot's remote share, queue the device scatter."""
        now_abs_ms = self._clock() * 1000
        with self._lock:
            actors = self._remote_actors.setdefault(key, {})
            for actor, count in values.items():
                if actor == self.node_id:
                    continue
                old = actors.get(actor)
                if old is None or old[1] <= now_abs_ms:
                    # No live state (or the old window expired): adopt the
                    # incoming count wholesale; per-actor windows reset on
                    # expiry, max-merge applies only within a live window.
                    actors[actor] = (count, expires_at_ms)
                elif expires_at_ms > now_abs_ms:
                    actors[actor] = (
                        max(count, old[0]),
                        max(expires_at_ms, old[1]),
                    )
            counter = self._decode_counter(key)
            if counter is None:
                # Limit not configured here yet: the per-actor state stays
                # parked and is adopted at first local touch or by
                # _adopt_parked.
                self._parked_wires.add(key)
                return
            self._parked_wires.discard(key)
            if self._is_big(counter):
                key_t = self._key_of(counter)
                cell = self._big_cell(counter, key_t)
                self._big_wire[key_t] = key
                if isinstance(cell, GcraValue):
                    self._lift_big_bucket(key_t, cell)
                return
            slot, fresh = self._slot_for(counter, create=True)
            if fresh:
                self._clear_adopted_slot(slot)
            self._queue_remote_sum(key, slot)

    def _decode_counter(self, key: bytes) -> Optional[Counter]:
        # Counters decode against the configured limits (the registry's
        # provider); the info scan is the providerless fallback (bare
        # storages in tests). The LimitKeyIndex is cached until the
        # provider's limit set changes.
        try:
            limits = self._known_limits()
            if not limits:
                limits = {info[1].limit for info in self._table.info.values()}
            cached = self._decode_index
            if cached is None or cached[0] != limits:
                cached = (limits, LimitKeyIndex(limits))
                self._decode_index = cached
            return partial_counter_from_key(key, cached[1])
        except Exception:
            return None

    _limits_provider = None  # set by the facade: () -> iterable of limits
    _decode_index = None  # (limits set, LimitKeyIndex) decode cache

    def _known_limits(self):
        if self._limits_provider is None:
            return set()
        try:
            return set(self._limits_provider())
        except Exception:
            return set()

    def _snapshot_for_peer(self):
        """Re-sync: our own live counts for every live local counter (one
        B3a read over the occupied slots), then the live big cells."""
        out = []
        with self._lock:
            now_ms = self._now_ms()
            occupied = list(self._table.info.items())
            if occupied:
                values, ttls = self._read([s for s, _ in occupied], now_ms)
            for i, (_slot, (_key, counter)) in enumerate(occupied):
                ttl = int(ttls[i])
                if ttl <= 0:
                    continue
                # windows: the expiry lane; buckets: the TAT. Either way
                # "still ahead" means live state.
                expires_at = int(self._epoch * 1000 + (now_ms + ttl))
                if counter.limit.policy == "token_bucket":
                    payload = {self.node_id: expires_at}
                else:
                    payload = {self.node_id: int(values[i])}
                out.append((key_for_counter(counter), payload, expires_at))
            now = self._clock()
            for key, (cell, counter) in self._big.items():
                if cell.is_expired(now):
                    continue
                wire = self._wire_for(key, counter)
                if isinstance(cell, GcraValue):
                    # host buckets gossip their TAT in their own ticks
                    payload = {self.node_id: int(cell.tat)}
                else:
                    payload = {self.node_id: min(int(cell.value_at(now)),
                                                 (1 << 63) - 1)}
                out.append(
                    (wire, payload, int(now * 1000 + cell.ttl(now) * 1000))
                )
        return out

    def _gossip_loop(self) -> None:
        ticks = 0
        while not self._stop.wait(self.gossip_period):
            self._publish_touched()
            ticks += 1
            if ticks % 100 == 0:
                self._prune_remote_actors()

    def _prune_remote_actors(self) -> None:
        """Drop expired per-actor entries and empty keys, so that a
        long-running node with churning counters keeps host memory
        bounded."""
        now_abs_ms = self._clock() * 1000
        with self._lock:
            doomed_keys = []
            for key, actors in self._remote_actors.items():
                dead = [a for a, (_c, e) in actors.items() if e <= now_abs_ms]
                for a in dead:
                    del actors[a]
                if not actors:
                    doomed_keys.append(key)
            for key in doomed_keys:
                del self._remote_actors[key]
            self._parked_wires &= set(self._remote_actors)
            # a mapping is live while its cell exists or remote state does
            self._big_wire = {
                k: w
                for k, w in self._big_wire.items()
                if k in self._big or w in self._remote_actors
            }

    def _publish_touched(self) -> None:
        """Publish the live local state of every counter touched since the
        last tick (one B3a read), then the touched big cells."""
        if self.broker is None:
            return
        self._publish_touched_big()
        with self._lock:
            touched, self._touched = self._touched, set()
            if not touched:
                return
            now_ms = self._now_ms()
            slots = []
            wire_keys = []
            buckets = []
            for slot in touched:
                info = self._table.info.get(slot)
                if info is not None:
                    slots.append(slot)
                    wire_keys.append(key_for_counter(info[1]))
                    buckets.append(info[1].limit.policy == "token_bucket")
            if not slots:
                return
            v, ttl = self._read(slots, now_ms)
            epoch_ms = self._epoch * 1000
        for i, key in enumerate(wire_keys):
            if ttl[i] <= 0:
                continue  # expired window / full bucket: nothing live
            expires_at = int(epoch_ms + now_ms + int(ttl[i]))
            if buckets[i]:
                # a bucket's state is its TAT: the ttl lane is TAT - now
                # and the ticks are ms, so the count lane carries the same
                # abs-ms TAT as expires_at
                payload = {self.node_id: expires_at}
            else:
                payload = {self.node_id: int(v[i])}
            self.broker.publish(key, payload, expires_at)

    def _publish_touched_big(self) -> None:
        """Gossip locally written big cells: exact Python-int counts on
        the same stream (the proto carries u64; a count past it is
        clamped, beyond any expressible max_value)."""
        to_send = []
        with self._lock:
            touched, self._touched_big = self._touched_big, set()
            now = self._clock()
            for key in touched:
                entry = self._big.get(key)
                if entry is None:
                    continue
                cell, counter = entry
                if cell.is_expired(now):
                    continue
                wire = self._wire_for(key, counter)
                expires_at = int(now * 1000 + cell.ttl(now) * 1000)
                if isinstance(cell, GcraValue):
                    count = int(cell.tat)
                else:
                    count = min(int(cell.value_at(now)), (1 << 63) - 1)
                to_send.append((wire, count, expires_at))
        for wire, count, expires_at in to_send:
            self.broker.publish(wire, {self.node_id: count}, expires_at)

    # -- lifecycle -----------------------------------------------------------

    def _apply_snapshot(self, data: dict) -> None:
        """Load a checkpoint, then rebuild the remote lanes against the
        loaded slot table. Per-actor state that gossiped in earlier is
        keyed by wire key and stays; the lanes and queued scatters were
        indexed by the old slots, so they are zeroed and every remote key
        is re-queued at its new slot, or parked until its counter is
        touched again (``_adopt_parked``, ``_slot_for``)."""
        super()._apply_snapshot(data)
        with self._lock:
            with self._on_device():
                self._remote_vals.zero_()
                self._remote_exp.zero_()
            self._dirty_remote.clear()
            self._touched.clear()
            for wire in self._remote_actors:
                counter = self._decode_counter(wire)
                if counter is not None and self._is_big(counter):
                    continue  # host cells: their remote share is by wire key
                slot = None if counter is None else self._slot_for(
                    counter, create=False)[0]
                if slot is None:
                    self._parked_wires.add(wire)
                else:
                    self._queue_remote_sum(wire, slot)

    def clear(self) -> None:
        super().clear()
        with self._lock:
            with self._on_device():
                self._remote_vals.zero_()
                self._remote_exp.zero_()
            self._remote_actors.clear()
            self._dirty_remote.clear()
            self._touched.clear()
            self._big_wire.clear()
            self._touched_big.clear()
            self._parked_wires.clear()

    def close(self) -> None:
        self._stop.set()
        if self._gossip_thread is not None:
            self._gossip_thread.join(timeout=2)
        if self.broker is not None:
            self.broker.stop()
        super().close()
        self._remote_ctx.close()
