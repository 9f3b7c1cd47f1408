"""Persistent on-disk counter storage.

Port counterpart of ``limitador_tpu/storage/disk.py``, copied with its
imports kept package-relative. The table's schema and key bytes are the
JAX package's, so either package opens a file the other wrote.

The reference embeds RocksDB with an associative merge operator that sums
window values respecting expiry and a compaction filter that drops expired
entries (upstream limitador/src/storage/disk/rocksdb_storage.rs).
This implementation keeps those semantics over SQLite (stdlib, embedded,
WAL): counters persist across process restarts (reopen test parity,
rocksdb_storage.rs:237-287), updates apply the same window merge as
ExpiringValue.update (disk/expiring_value.rs:28-52), and expired rows are
swept opportunistically (the compaction-filter analogue,
rocksdb_storage.rs:160-169).

Keys use the binary versioned codec from keys.py (the reference's binary
v2, keys.rs:236-298); counters are re-attached to live limits on read via
``partial_counter_from_key``.

Token buckets: a GCRA cell's whole state is its TAT, so a bucket
row persists the TAT twice — EXACT integer ticks in the ``value``
column (the state of record; ticks follow the limit's ``unit_scale``)
and float seconds in the ``expiry`` column, which is purely the
liveness/sweep lane: a TAT in the past IS a full bucket, so the
fixed-window expiry filter and the opportunistic sweep cover both
policies unchanged. Reads hydrate a ``GcraValue`` from the ticks; the
float column's ~µs rounding never touches token arithmetic.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from typing import List, Optional, Set

from ..core.counter import Counter
from ..core.limit import Limit
from .base import Authorization, CounterStorage, StorageError
from .gcra import cell_for_limit
from .keys import LimitKeyIndex, key_for_counter, partial_counter_from_key

__all__ = ["DiskStorage"]

_SWEEP_EVERY = 1000  # ops between expired-row sweeps


class DiskStorage(CounterStorage):
    supports_token_bucket = True  # TAT rows, module docstring

    def __init__(self, path: str, clock=time.time):
        self._clock = clock
        self._lock = threading.RLock()
        self._path = path
        try:
            self._db = sqlite3.connect(path, check_same_thread=False)
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute("PRAGMA synchronous=NORMAL")
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS counters ("
                "  key BLOB PRIMARY KEY,"
                "  namespace TEXT NOT NULL,"
                "  value INTEGER NOT NULL,"
                "  expiry REAL NOT NULL)"
            )
            self._db.execute(
                "CREATE INDEX IF NOT EXISTS idx_counters_ns"
                " ON counters (namespace)"
            )
            self._db.commit()
        except sqlite3.Error as exc:
            raise StorageError(f"cannot open disk storage {path}: {exc}")
        self._ops = 0

    # -- helpers -----------------------------------------------------------

    def _maybe_sweep(self, now: float) -> None:
        self._ops += 1
        if self._ops % _SWEEP_EVERY == 0:
            self._db.execute("DELETE FROM counters WHERE expiry <= ?", (now,))

    def _read(self, key: bytes, now: float) -> tuple:
        row = self._db.execute(
            "SELECT value, expiry FROM counters WHERE key = ?", (key,)
        ).fetchone()
        if row is None or now >= row[1]:
            return 0, None
        return int(row[0]), float(row[1])

    def _merge(self, counter: Counter, key: bytes, delta: int, now: float) -> None:
        """ExpiringValue.update semantics: reset on expiry, else add.
        Bucket rows advance the TAT instead (GcraValue.update)."""
        if counter.limit.policy == "token_bucket":
            cell = cell_for_limit(counter.limit)
            tat, _expiry = self._read(key, now)
            cell.tat = tat  # 0 when missing/expired = full bucket
            cell.update(int(delta), counter.window_seconds, now)
            value = int(cell.tat)
            expiry = cell.tat / (1000.0 * cell.scale)
        else:
            value, expiry = self._read(key, now)
            if expiry is None:
                value, expiry = delta, now + counter.window_seconds
            else:
                value += delta
        self._db.execute(
            "INSERT INTO counters (key, namespace, value, expiry)"
            " VALUES (?, ?, ?, ?)"
            " ON CONFLICT(key) DO UPDATE SET value=excluded.value,"
            " expiry=excluded.expiry, namespace=excluded.namespace",
            (key, str(counter.namespace), value, expiry),
        )

    @staticmethod
    def _hydrate(counter: Counter, value: int, expiry, now: float):
        """THE row -> (admission value, expires_in) rule, one definition
        for the point reads and the namespace scan: spent tokens +
        time-to-full for buckets (value column = TAT ticks); accumulated
        count + window remainder (full window when no live row) for
        windows."""
        if counter.limit.policy == "token_bucket":
            cell = cell_for_limit(counter.limit)
            cell.tat = int(value)
            return cell.value_at(now), cell.ttl(now)
        return int(value), (
            (float(expiry) - now)
            if expiry is not None
            else float(counter.window_seconds)
        )

    def _value_and_ttl(self, counter: Counter, key: bytes, now: float):
        value, expiry = self._read(key, now)
        return self._hydrate(counter, value, expiry, now)

    # -- CounterStorage ----------------------------------------------------

    def is_within_limits(self, counter: Counter, delta: int) -> bool:
        now = self._clock()
        with self._lock:
            value, _ttl = self._value_and_ttl(
                counter, key_for_counter(counter), now
            )
        return value + delta <= counter.max_value

    def add_counter(self, limit: Limit) -> None:
        pass  # rows are created on first write (rocksdb parity)

    def _fail(self, exc: sqlite3.Error):
        """Roll back the open transaction so a partial batch merge can never
        be committed by a later, unrelated operation."""
        try:
            self._db.rollback()
        except sqlite3.Error:
            pass
        raise StorageError(str(exc), transient=True)

    def update_counter(self, counter: Counter, delta: int) -> None:
        now = self._clock()
        with self._lock:
            try:
                self._merge(counter, key_for_counter(counter), delta, now)
                self._maybe_sweep(now)
                self._db.commit()
            except sqlite3.Error as exc:
                self._fail(exc)

    def check_and_update(
        self, counters: List[Counter], delta: int, load_counters: bool
    ) -> Authorization:
        now = self._clock()
        with self._lock:
            try:
                first_limited: Optional[Authorization] = None
                keys = [key_for_counter(c) for c in counters]
                to_update = []
                for counter, key in zip(counters, keys):
                    value, ttl = self._value_and_ttl(counter, key, now)
                    if load_counters:
                        remaining = counter.max_value - (value + delta)
                        counter.remaining = max(remaining, 0)
                        # Windows: missing/expired row reports the full
                        # window (the write below opens one) — reference
                        # RocksDB / oracle parity. Buckets: time-to-full.
                        counter.expires_in = ttl
                        if first_limited is None and remaining < 0:
                            first_limited = Authorization.limited_by(
                                counter.limit.name
                            )
                    if value + delta > counter.max_value:
                        if not load_counters:
                            return Authorization.limited_by(counter.limit.name)
                    to_update.append((counter, key))
                if first_limited is not None:
                    return first_limited
                for counter, key in to_update:
                    self._merge(counter, key, delta, now)
                self._maybe_sweep(now)
                self._db.commit()
                return Authorization.OK
            except sqlite3.Error as exc:
                self._fail(exc)

    @staticmethod
    def _decode(key: bytes, index) -> Optional[Counter]:
        """Skip rows whose key this codec can't read (e.g. written by a
        pre-postcard build): they expire through the sweep; a scan must
        not crash on them (the distributed backend tolerates foreign keys
        the same way)."""
        try:
            return partial_counter_from_key(key, index)
        except Exception:
            return None

    def get_counters(self, limits: Set[Limit]) -> Set[Counter]:
        now = self._clock()
        out: Set[Counter] = set()
        namespaces = {str(limit.namespace) for limit in limits}
        with self._lock:
            rows = self._db.execute(
                "SELECT key, value, expiry FROM counters"
                f" WHERE namespace IN ({','.join('?' * len(namespaces))})"
                " AND expiry > ?",
                (*namespaces, now),
            ).fetchall()
        index = LimitKeyIndex(limits)  # O(1) re-attach per scanned key
        for key, value, expiry in rows:
            counter = self._decode(bytes(key), index)
            if counter is None:
                continue
            spent, ttl = self._hydrate(counter, value, expiry, now)
            counter.remaining = counter.max_value - spent
            counter.expires_in = ttl
            out.add(counter)
        return out

    def delete_counters(self, limits: Set[Limit]) -> None:
        now = self._clock()
        with self._lock:
            namespaces = {str(limit.namespace) for limit in limits}
            rows = self._db.execute(
                "SELECT key FROM counters"
                f" WHERE namespace IN ({','.join('?' * len(namespaces))})",
                tuple(namespaces),
            ).fetchall()
            doomed = []
            index = LimitKeyIndex(limits)
            for (key,) in rows:
                counter = self._decode(bytes(key), index)
                if counter is not None:
                    doomed.append(key)
            if doomed:
                self._db.executemany(
                    "DELETE FROM counters WHERE key = ?",
                    [(k,) for k in doomed],
                )
                self._db.commit()

    def clear(self) -> None:
        with self._lock:
            self._db.execute("DELETE FROM counters")
            self._db.commit()

    def apply_deltas(self, items):
        """Authority-side batch apply for write-behind caches (see
        in_memory.apply_deltas)."""
        now = self._clock()
        out = []
        with self._lock:
            try:
                for counter, delta in items:
                    key = key_for_counter(counter)
                    self._merge(counter, key, delta, now)
                    out.append(self._value_and_ttl(counter, key, now))
                self._db.commit()
            except sqlite3.Error as exc:
                self._fail(exc)
        return out

    def close(self) -> None:
        with self._lock:
            self._db.close()
