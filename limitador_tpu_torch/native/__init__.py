"""ctypes binding for the port's C++ host lane (``csrc/hostpath.cc``).

Counterpart of ``limitador_tpu/native/__init__.py``. ``native/build.py``
compiles the port's own copy of the source with g++ at first use; nothing
is built when this module is imported. A missing compiler or a failed
build raises ``BuildError`` from the first ``HostPath()``: the port keeps
no pure-Python stand-in for a lane that was asked for.

The binding exposes the interner, the RLS parser and the slot map, and
the **zero-Python hot lane**: a C-side mirror of the decision-plan cache
plus one begin call that covers plan lookup, columnar staging into
pre-allocated kernel staging buffers and begin-time response codes, and
one finish call that turns the device result columns into response codes
and aggregated metrics. ctypes releases the GIL around every call. The
quota-lease exports (``hp_lease_*``) and the usage drain
(``hp_usage_drain``) ride the same mirror. The native telemetry plane
(``hp_tel_*``: process-global log2-ns histograms of the hot lane's
phases and a slow-row exemplar ring) is armed by ``tel_config`` and read
by ``tel_drain`` and ``tel_exemplars``; ``observability/native_plane.py``
is its Python half.

Every pointer handed to the library is a host buffer (numpy arrays and
``bytes``): the C++ lane never sees a CUDA pointer. The staging columns
``NativeHotLane.kernel_columns`` returns are views of the lane's scratch,
which the next begin reuses; ``TorchStorage.begin_check_columnar`` copies
them before its storage lock is released.

The begin's meta is the JAX package's 12 slots wide; slot 7 (the pod
split's foreign rows) stays 0, as the port has no pod yet.

The pointer-table begin (``hp_hot_begin``, ``NativeHotLane.begin_ptrs``)
is the native ingress's entry: it stages a batch straight from the
ingress's take buffers (``native/ingress.py``), with no Python bytes per
row.

Not in the port yet (``ROADMAP.md``): the JAX package's pod ownership
mirror (``hp_pod_*``, plan stamps), plan-seed export and
``hp_partition_positions``; the port's copy of the source leaves them
out.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import build
from .build import BuildError

__all__ = [
    "BuildError",
    "available",
    "lane_available",
    "lease_available",
    "tel_available",
    "tel_config",
    "tel_enabled",
    "tel_drain",
    "tel_exemplars",
    "staged_trace_attrs",
    "build_error",
    "HostPath",
    "HotStaged",
    "NativeHotLane",
    "NativeInterner",
    "LANE_MISS",
    "LANE_KERNEL",
    "LANE_OK",
    "LANE_UNKNOWN",
    "LANE_OVER",
    "LANE_ERROR",
]

#: hot-lane outcome codes (mirror csrc/hostpath.cc LaneKind)
LANE_MISS = 0
LANE_KERNEL = 1
LANE_OK = 2
LANE_UNKNOWN = 3
LANE_OVER = 4
LANE_ERROR = 5

_INT32_MAX = (1 << 31) - 1

#: telemetry phases of the host lane, in the C TelPhase enum order
TEL_PHASES = ("hot_lookup", "hot_stage", "lease_hit", "hot_finish")
#: log2-ns histogram buckets per phase: bucket b holds [2^b, 2^{b+1}) ns
TEL_BUCKETS = 40
#: int64 fields per drained slow-row exemplar (hp_tel_exemplars)
TEL_EX_STRIDE = 12
#: int64 slots of the hot begin's meta (hp_hot_begin out_meta)
META_WIDTH = 12

_bind_lock = threading.Lock()
_bound = None


def _bind(lib) -> None:
    """ctypes signatures, the JAX binding's exactly for every export the
    port calls."""
    lib.hp_new.restype = ctypes.c_void_p
    lib.hp_free.argtypes = [ctypes.c_void_p]
    lib.hp_track_key.restype = ctypes.c_int32
    lib.hp_track_key.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    lib.hp_intern.restype = ctypes.c_int32
    lib.hp_intern.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    lib.hp_find.restype = ctypes.c_int32
    lib.hp_find.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    lib.hp_string.restype = ctypes.c_int32
    lib.hp_string.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.hp_interned_count.restype = ctypes.c_int64
    lib.hp_interned_count.argtypes = [ctypes.c_void_p]
    lib.hp_parse_batch.restype = ctypes.c_int32
    lib.hp_parse_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int32), ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
    ]
    lib.hp_slots_lookup.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.int32),
        ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64),
    ]
    lib.hp_slots_insert.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.int32),
        ctypes.c_int32, ctypes.c_int64,
    ]
    lib.hp_slots_remove.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.int32), ctypes.c_int32,
    ]
    lib.hp_slots_count.restype = ctypes.c_int64
    lib.hp_slots_count.argtypes = [ctypes.c_void_p]
    # -- hot lane (array params are raw host pointers) --------------------
    lib.hp_set_threads.argtypes = [ctypes.c_int32]
    lib.hp_plan_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.hp_plan_put.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.hp_plan_invalidate_slot.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.hp_plan_count.restype = ctypes.c_int64
    lib.hp_plan_count.argtypes = [ctypes.c_void_p]
    lib.hp_lane_stats.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    # -- quota leasing (lease/broker.py drives these under the native
    # lock; consume itself rides hp_hot_begin) -------------------------
    lib.hp_lease_config.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.hp_lease_grant.restype = ctypes.c_int32
    lib.hp_lease_grant.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.hp_lease_revoke.restype = ctypes.c_int64
    lib.hp_lease_revoke.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
    ]
    lib.hp_lease_tokens.restype = ctypes.c_int64
    lib.hp_lease_tokens.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
    ]
    lib.hp_lease_drain_returns.restype = ctypes.c_int32
    lib.hp_lease_drain_returns.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.hp_lease_candidates.restype = ctypes.c_int32
    lib.hp_lease_candidates.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.hp_lease_stats.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    # -- tenant usage observatory (per-plan leased-admission counts) -----
    lib.hp_usage_drain.restype = ctypes.c_int32
    lib.hp_usage_drain.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32,
    ]
    # -- native telemetry plane (process-global; observability/
    # native_plane.py drains it) ---------------------------------------
    lib.hp_tel_config.argtypes = [
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.hp_tel_enabled.restype = ctypes.c_int32
    lib.hp_tel_enabled.argtypes = []
    lib.hp_tel_drain.restype = ctypes.c_int32
    lib.hp_tel_drain.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.hp_tel_exemplars.restype = ctypes.c_int32
    lib.hp_tel_exemplars.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.hp_hot_begin.restype = ctypes.c_int32
    lib.hp_hot_begin.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.hp_hot_begin_buf.restype = ctypes.c_int32
    lib.hp_hot_begin_buf.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.hp_hot_finish.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]


def _load():
    """The bound library, built at first use; raises ``BuildError``."""
    global _bound
    lib = build.library()
    if _bound is not lib:
        with _bind_lock:
            if _bound is not lib:
                _bind(lib)
                _bound = lib
    return lib


def available() -> bool:
    """True when the host lane builds and loads."""
    try:
        _load()
    except BuildError:
        return False
    return True


def build_error() -> Optional[str]:
    """The build failure's message, None when the library loads."""
    try:
        _load()
    except BuildError as exc:
        return str(exc)
    return None


def lane_available() -> bool:
    """True when the loaded library exports the hot-lane symbols."""
    return hasattr(_load(), "hp_hot_begin_buf")


def lease_available() -> bool:
    """True when the loaded library exports the quota-lease symbols."""
    return hasattr(_load(), "hp_lease_grant")


def tel_available() -> bool:
    """True when the loaded library exports the telemetry plane (builds
    the library at first use; raises ``BuildError`` when it cannot)."""
    return hasattr(_load(), "hp_tel_drain")


def tel_config(enabled: bool, slow_row_ns: int = 0,
               trace_sample: int = 0) -> bool:
    """Arm (or disarm) the native telemetry plane: the histogram
    observes, the slow-row exemplar threshold (per-row average ns; 0 =
    exemplars off) and 1-in-N begin trace sampling (0 = off). Builds the
    library at first use; returns True once the plane is configured."""
    _load().hp_tel_config(1 if enabled else 0, int(slow_row_ns),
                          int(trace_sample))
    return True


def tel_enabled() -> bool:
    """True while the telemetry plane is armed. Reads the library only
    when it is already loaded (a process that never loaded it has the
    plane off)."""
    lib = build.loaded()
    if lib is None:
        return False
    return bool(_load().hp_tel_enabled())


def tel_drain() -> Dict[str, dict]:
    """Cumulative native phase histograms:
    ``{phase: {"count", "sum_ns", "buckets": [TEL_BUCKETS]}}`` in one C
    call. The C side echoes its layout size: a constants mismatch
    (binding against another build of the library) raises instead of
    misreading."""
    stride = 2 + TEL_BUCKETS
    out = np.zeros(len(TEL_PHASES) * stride, np.int64)
    need = _load().hp_tel_drain(out.ctypes.data, out.shape[0])
    if need != out.shape[0]:
        raise RuntimeError(
            f"hp_tel_drain layout mismatch: library says {need} int64s, "
            f"binding allocated {out.shape[0]}"
        )
    snap: Dict[str, dict] = {}
    for i, phase in enumerate(TEL_PHASES):
        rec = out[i * stride:(i + 1) * stride]
        snap[phase] = {
            "count": int(rec[0]),
            "sum_ns": int(rec[1]),
            "buckets": rec[2:].tolist(),
        }
    return snap


def tel_exemplars(cap: int = 64) -> List[dict]:
    """Drain (and clear) the slow-row exemplar ring: one dict per slow
    begin, oldest first."""
    out = np.zeros((max(int(cap), 1), TEL_EX_STRIDE), np.int64)
    n = _load().hp_tel_exemplars(out.ctypes.data, out.shape[0])
    keys = ("total_ns", "lookup_ns", "stage_ns", "rows", "kernel_rows",
            "staged_hits", "miss_rows", "leased_rows", "blob_digest",
            "blob_len", "plan_kind", "lease_tokens")
    return [dict(zip(keys, row)) for row in out[:n].tolist()]


class HostPath:
    """One native context: interner + tracked keys + slot map + plan
    mirror."""

    def __init__(self, tracked_keys: Sequence[str] = ()):
        lib = _load()
        self._lib = lib
        self._ctx = ctypes.c_void_p(lib.hp_new())
        self.tracked: List[str] = []
        for key in tracked_keys:
            self.track(key)

    def close(self) -> None:
        if self._ctx:
            self._lib.hp_free(self._ctx)
            self._ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def track(self, key: str) -> int:
        raw = key.encode()
        idx = self._lib.hp_track_key(self._ctx, raw, len(raw))
        self.tracked.append(key)
        return idx

    def intern(self, s: str) -> int:
        raw = s.encode()
        return self._lib.hp_intern(self._ctx, raw, len(raw))

    def find(self, s: str) -> int:
        raw = s.encode()
        return self._lib.hp_find(self._ctx, raw, len(raw))

    def string(self, token: int) -> str:
        if not self._ctx:
            raise KeyError(token)  # context closed (interner recycle)
        out = ctypes.c_char_p()
        n = self._lib.hp_string(self._ctx, token, ctypes.byref(out))
        if n < 0:
            raise KeyError(token)
        return ctypes.string_at(out, n).decode()

    def interned_count(self) -> int:
        return self._lib.hp_interned_count(self._ctx)

    def parse_batch(
        self, blobs: Sequence[bytes]
    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray], np.ndarray, np.ndarray]:
        """Parse serialized RateLimitRequest blobs into columns.

        Returns (domain_tokens, hits, columns{key->tokens}, ndesc_entries,
        extra_descriptors); -1 marks absent/failed."""
        n = len(blobs)
        # fromiter(map(len,...)) skips the intermediate list — this line
        # runs per batch on the serving hot path
        sizes = np.fromiter(map(len, blobs), np.int32, count=n)
        buf = b"".join(blobs)
        domains = np.empty(n, np.int32)
        hits = np.empty(n, np.int32)
        cols = np.empty((max(len(self.tracked), 1), n), np.int32)
        ndesc = np.empty(n, np.int32)
        extra = np.empty(n, np.int32)
        self._lib.hp_parse_batch(
            self._ctx, buf, sizes, n, domains, hits, cols, ndesc, extra
        )
        columns = {
            key: cols[i] for i, key in enumerate(self.tracked)
        }
        return domains, hits, columns, ndesc, extra

    def as_interner(self) -> "NativeInterner":
        return NativeInterner(self)

    def hot_lane(self, scratch_slot: int, cap: int = 1 << 16,
                 max_rows: int = 1 << 15) -> "NativeHotLane":
        return NativeHotLane(self, scratch_slot, cap, max_rows)

    # -- plan mirror ---------------------------------------------------------

    def plan_count(self) -> int:
        if not self._ctx:
            return 0  # context closed (interner recycle)
        return self._lib.hp_plan_count(self._ctx)

    def lane_stats(self) -> dict:
        out = np.zeros(8, np.int64)
        if self._ctx:  # zeros after close (interner recycle)
            self._lib.hp_lane_stats(self._ctx, out.ctypes.data)
        keys = ("hits", "misses", "staged_hits", "insertions",
                "invalidations", "overflows", "plans", "epoch")
        return dict(zip(keys, out.tolist()))

    # -- slot map -----------------------------------------------------------

    def slots_lookup(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, np.int32)
        n, k = keys.shape
        out = np.empty(n, np.int64)
        self._lib.hp_slots_lookup(self._ctx, keys, n, k, out)
        return out

    def slots_insert(self, key: np.ndarray, slot: int) -> None:
        key = np.ascontiguousarray(key, np.int32)
        self._lib.hp_slots_insert(self._ctx, key, key.shape[0], slot)

    def slots_remove(self, key: np.ndarray) -> None:
        key = np.ascontiguousarray(key, np.int32)
        self._lib.hp_slots_remove(self._ctx, key, key.shape[0])

    def slots_count(self) -> int:
        return self._lib.hp_slots_count(self._ctx)


class HotStaged:
    """One hot begin's outputs: the response-code column, the staged
    kernel geometry, and the per-kernel-row metadata the finish pass
    needs. ``codes`` / per-row arrays are owned copies (the lane's
    scratch is reused by the next begin); the staging column views are
    copied by ``begin_check_columnar`` before the caller releases the
    storage lock."""

    __slots__ = (
        "codes", "k", "nhits", "H", "rows", "row_nhits", "row_delta",
        "row_ns", "hit_names", "ok_aggr", "fill_results", "leased_rows",
        "lookup_ns", "stage_ns", "trace_id",
    )

    def __init__(self, codes, k, nhits, H, rows, row_nhits, row_delta,
                 row_ns, hit_names, ok_aggr, leased_rows=0, lookup_ns=0,
                 stage_ns=0, trace_id=0):
        self.codes = codes
        self.k = k
        self.nhits = nhits
        self.H = H
        self.rows = rows
        self.row_nhits = row_nhits
        self.row_delta = row_delta
        self.row_ns = row_ns
        self.hit_names = hit_names
        self.ok_aggr = ok_aggr  # [(ns_token, calls, hits)] at begin time
        self.fill_results = True
        # telemetry tail (zeros with the plane off): the begin's native
        # phase splits, leased-row count and the 1-in-N sampled trace id
        # (0 = unsampled) for OTLP span attachment
        self.leased_rows = leased_rows
        self.lookup_ns = lookup_ns
        self.stage_ns = stage_ns
        self.trace_id = trace_id


def staged_trace_attrs(staged: HotStaged) -> dict:
    """OTLP span attributes for a 1-in-N sampled hot-lane begin: the
    trace id the C side stamped and the native phase splits. Callers
    gate on ``staged.trace_id`` first."""
    return {
        "native.trace_id": int(staged.trace_id),
        "native.hot_lookup_ms": round(staged.lookup_ns / 1e6, 4),
        "native.hot_stage_ms": round(staged.stage_ns / 1e6, 4),
        "native.leased_rows": int(staged.leased_rows),
    }


class NativeHotLane:
    """Pre-allocated staging + scratch for the C hot lane of ONE
    HostPath context. Not thread-safe by itself: callers serialize
    begins under the pipeline's native lock (finish is stateless in C
    and touches only per-call copies)."""

    def __init__(self, hp: HostPath, scratch_slot: int, cap: int = 1 << 16,
                 max_rows: int = 1 << 15):
        self.hp = hp
        self._lib = hp._lib
        self._ctx = hp._ctx
        self.scratch_slot = int(scratch_slot)
        # pow2 capacity: the C side pads to the kernel's pow2 bucket in
        # place, so H <= cap must always hold
        c = 8
        while c < cap:
            c <<= 1
        self.cap = c
        # kernel staging columns (uploaded via begin_check_columnar)
        self.slots = np.empty(c, np.int32)
        self.deltas = np.empty(c, np.int32)
        self.maxes = np.empty(c, np.int32)
        self.windows = np.empty(c, np.int32)
        self.req = np.empty(c, np.int32)
        self.bucket = np.zeros(c, bool)
        # cached slots are live, never fresh: one immutable all-False
        # column shared by every launch
        self.fresh = np.zeros(c, bool)
        self._hit_names = np.empty(c, np.int32)
        self._resize_rows(max_rows)
        # the begin's meta: 7 geometry slots (k, nhits, H, hit/miss/
        # overflow rows, namespaces aggregated), the pod's foreign rows
        # (0 here) and the telemetry tail (lookup_ns, stage_ns,
        # leased_rows, trace_id)
        self._meta = np.zeros(META_WIDTH, np.int64)
        # token -> namespace / limit-name string memos (metrics apply)
        self._ns_strings: Dict[int, str] = {}
        self._name_strings: Dict[int, Optional[str]] = {}

    def _resize_rows(self, n: int) -> None:
        self.max_rows = n
        self._kind = np.empty(n, np.int8)
        self._rows = np.empty(n, np.int32)
        self._row_nhits = np.empty(n, np.int32)
        self._row_delta = np.empty(n, np.int32)
        self._row_ns = np.empty(n, np.int32)
        self._ok_ns = np.empty(n, np.int32)
        self._ok_calls = np.empty(n, np.int64)
        self._ok_hits = np.empty(n, np.int64)
        self._lim_ns = np.empty(n, np.int32)
        self._lim_name = np.empty(n, np.int32)
        self._lim_count = np.empty(n, np.int64)
        self._counts = np.zeros(2, np.int64)

    # -- mirror management ---------------------------------------------------

    def sync_epoch(self, epoch: int) -> None:
        self._lib.hp_plan_epoch(self._ctx, epoch)

    def invalidate_slot(self, slot: int) -> None:
        self._lib.hp_plan_invalidate_slot(self._ctx, slot)

    def plan_put(self, blob: bytes, epoch: int, kind: int, ns_token: int,
                 delta: int, delta_capped: int,
                 rec: Optional[np.ndarray] = None,
                 ns: Optional[str] = None, names=()) -> None:
        """Mirror one derived plan; ``rec`` is int32 (nhits, 5):
        slot, max, window_ms, bucket, name token. ``ns``/``names`` seed
        the token->string memos so the finish pass (metrics apply) never
        needs the interner — which may belong to an already-recycled
        context by then."""
        if ns is not None:
            self._ns_strings[ns_token] = ns
        for token, name in names:
            if token >= 0:
                self._name_strings[token] = name
        if rec is None:
            ptr, nhits = None, 0
        else:
            rec = np.ascontiguousarray(rec, np.int32)
            ptr, nhits = rec.ctypes.data, rec.shape[0]
        self._lib.hp_plan_put(
            self._ctx, blob, len(blob), epoch, kind, ns_token,
            min(int(delta), _INT32_MAX), int(delta_capped), ptr, nhits,
        )

    # -- quota leasing (lease/broker.py) -------------------------------------
    # All lease calls run under the pipeline's native lock, the same lock
    # serializing the begins that consume tokens.

    def lease_config(self, enabled: bool, hot_threshold: int = 8) -> None:
        self._lib.hp_lease_config(
            self._ctx, 1 if enabled else 0, int(hot_threshold)
        )

    def lease_grant(self, blob: bytes, epoch: int, lease_id: int,
                    tokens: int) -> bool:
        """Attach a pre-debited grant to the mirrored plan; False means
        the plan is gone / epoch moved / already leased — the caller
        must credit the debit straight back."""
        return bool(self._lib.hp_lease_grant(
            self._ctx, blob, len(blob), epoch, lease_id, int(tokens)
        ))

    def lease_revoke(self, blob: bytes, expect_id: int = -1) -> int:
        """Reclaim a lease synchronously; returns the remaining tokens,
        or -1 when there is nothing live to reclaim (the tokens already
        travelled through the return ring, the plan is gone, or the
        plan's live lease is a newer grant than ``expect_id``)."""
        return self._lib.hp_lease_revoke(
            self._ctx, blob, len(blob), expect_id
        )

    def lease_tokens(self, blob: bytes, expect_id: int = -1) -> int:
        return self._lib.hp_lease_tokens(
            self._ctx, blob, len(blob), expect_id
        )

    def lease_drain_returns(self, cap: int = 4096):
        """[(lease_id, stranded tokens)] pushed by invalidation/clear."""
        ids = np.empty(cap, np.int64)
        tokens = np.empty(cap, np.int64)
        n = self._lib.hp_lease_drain_returns(
            self._ctx, ids.ctypes.data, tokens.ctypes.data, cap
        )
        return list(zip(ids[:n].tolist(), tokens[:n].tolist()))

    def lease_candidates(self, cap: int = 256, blob_cap: int = 1 << 20):
        """[(blob bytes, observed demand)] for hot unleased kernel
        plans; draining resets their demand counts."""
        blobs = np.empty(blob_cap, np.uint8)
        lens = np.empty(cap, np.int32)
        counts = np.empty(cap, np.int64)
        n = self._lib.hp_lease_candidates(
            self._ctx, blobs.ctypes.data, blob_cap, lens.ctypes.data,
            counts.ctypes.data, cap,
        )
        if n == 0:
            return []
        used = int(lens[:n].sum())
        raw = blobs[:used].tobytes()  # copy only the written prefix
        out = []
        off = 0
        for i in range(n):
            ln = int(lens[i])
            out.append((raw[off:off + ln], int(counts[i])))
            off += ln
        return out

    def lease_stats(self) -> dict:
        out = np.zeros(8, np.int64)
        if self._ctx:
            self._lib.hp_lease_stats(self._ctx, out.ctypes.data)
        keys = ("leased", "grants", "granted_tokens", "ring_tokens",
                "active", "outstanding", "pending_candidates",
                "pending_returns")
        return dict(zip(keys, out.tolist()))

    def usage_drain(self, cap: int = 1024, blob_cap: int = 1 << 20):
        """[(blob bytes, leased admissions since last drain)] — the
        native half of the tenant usage observatory. Leased rows never
        reach the device's per-slot hit accumulator; the observatory
        resolves each blob to its plan's slots and merges these counts
        in. Draining resets the per-plan counts; plans that don't fit
        the buffers keep theirs for the next drain."""
        if not self._ctx:
            return []
        blobs = np.empty(blob_cap, np.uint8)
        lens = np.empty(cap, np.int32)
        counts = np.empty(cap, np.int64)
        n = self._lib.hp_usage_drain(
            self._ctx, blobs.ctypes.data, blob_cap, lens.ctypes.data,
            counts.ctypes.data, cap,
        )
        if n == 0:
            return []
        used = int(lens[:n].sum())
        raw = blobs[:used].tobytes()
        out = []
        off = 0
        for i in range(n):
            ln = int(lens[i])
            out.append((raw[off:off + ln], int(counts[i])))
            off += ln
        return out

    # -- begin / finish ------------------------------------------------------

    def begin_ptrs(self, ptrs, lens, n: int, epoch: int) -> HotStaged:
        """The zero-copy begin: ``ptrs``/``lens`` (ctypes arrays of
        ``c_void_p``/``c_uint32``, or their addresses) address the blobs
        in place, as the ingress's take buffers hold them. One GIL-free C
        call: plan lookup, columnar staging, padding, begin-time codes
        and the OK-metric aggregation, as ``begin``."""
        if n > self.max_rows:
            self._resize_rows(max(n, self.max_rows * 2))
        k = self._lib.hp_hot_begin(
            self._ctx,
            ptrs if isinstance(ptrs, int) else ctypes.addressof(ptrs),
            lens if isinstance(lens, int) else ctypes.addressof(lens),
            n, epoch,
            self._kind.ctypes.data, self.slots.ctypes.data,
            self.deltas.ctypes.data, self.maxes.ctypes.data,
            self.windows.ctypes.data, self.req.ctypes.data,
            self.bucket.ctypes.data, self.cap, self.scratch_slot,
            self._rows.ctypes.data, self._row_nhits.ctypes.data,
            self._row_delta.ctypes.data, self._row_ns.ctypes.data,
            self._hit_names.ctypes.data, self._ok_ns.ctypes.data,
            self._ok_calls.ctypes.data, self._ok_hits.ctypes.data,
            self._meta.ctypes.data,
        )
        return self._staged_from_scratch(n, k)

    def begin(self, blobs: Sequence[bytes], epoch: int) -> HotStaged:
        """Begin over a list of bytes objects, via one join (the
        pointer table is derived in C; building it through ctypes per
        row would cost several times the whole C pass)."""
        n = len(blobs)
        if n > self.max_rows:
            self._resize_rows(max(n, self.max_rows * 2))
        sizes = np.fromiter(map(len, blobs), np.int32, count=n)
        buf = b"".join(blobs)
        k = self._lib.hp_hot_begin_buf(
            self._ctx, buf, sizes.ctypes.data, n, epoch,
            self._kind.ctypes.data, self.slots.ctypes.data,
            self.deltas.ctypes.data, self.maxes.ctypes.data,
            self.windows.ctypes.data, self.req.ctypes.data,
            self.bucket.ctypes.data, self.cap, self.scratch_slot,
            self._rows.ctypes.data, self._row_nhits.ctypes.data,
            self._row_delta.ctypes.data, self._row_ns.ctypes.data,
            self._hit_names.ctypes.data, self._ok_ns.ctypes.data,
            self._ok_calls.ctypes.data, self._ok_hits.ctypes.data,
            self._meta.ctypes.data,
        )
        return self._staged_from_scratch(n, k)

    def _staged_from_scratch(self, n: int, k: int) -> HotStaged:
        meta = self._meta
        nhits, H = int(meta[1]), int(meta[2])
        n_ok = int(meta[6])
        ok_aggr = (
            list(zip(self._ok_ns[:n_ok].tolist(),
                     self._ok_calls[:n_ok].tolist(),
                     self._ok_hits[:n_ok].tolist()))
            if n_ok else []
        )
        return HotStaged(
            self._kind[:n].copy(), k, nhits, H,
            self._rows[:k].copy(), self._row_nhits[:k].copy(),
            self._row_delta[:k].copy(), self._row_ns[:k].copy(),
            self._hit_names[:nhits].copy(), ok_aggr,
            leased_rows=int(meta[10]), lookup_ns=int(meta[8]),
            stage_ns=int(meta[9]), trace_id=int(meta[11]),
        )

    def kernel_columns(self, H: int):
        """The staged column views for ``begin_check_columnar`` —
        consumed by the launch while the caller still holds the storage
        lock (the next begin reuses the buffers)."""
        return (
            self.slots[:H], self.deltas[:H], self.maxes[:H],
            self.windows[:H], self.req[:H], self.fresh[:H],
            self.bucket[:H],
        )

    def finish(self, staged: HotStaged, admitted, hit_ok):
        """Turn the device result columns into final response codes
        (in-place on ``staged.codes``) and return the batch's aggregated
        metrics: ([(ns, calls, hits)], [(ns, name|None, count)])."""
        k, nhits = staged.k, staged.nhits
        adm = np.ascontiguousarray(admitted[:k], np.uint8)
        hok = np.ascontiguousarray(hit_ok[:nhits], np.uint8)
        # Per-call scratch: finish runs on collect threads concurrently
        # with the next begin (which owns the lane's shared scratch) and
        # with other finishes. The C pass is context-free — NULL ctx, so
        # a pending that outlives an interner-recycle context swap (the
        # old HostPath is closed) still finishes safely.
        ok_ns = np.empty(max(k, 1), np.int32)
        ok_calls = np.empty(max(k, 1), np.int64)
        ok_hits = np.empty(max(k, 1), np.int64)
        lim_ns = np.empty(max(k, 1), np.int32)
        lim_name = np.empty(max(k, 1), np.int32)
        lim_count = np.empty(max(k, 1), np.int64)
        counts = np.zeros(2, np.int64)
        self._lib.hp_hot_finish(
            None, adm.ctypes.data, hok.ctypes.data, k,
            staged.rows.ctypes.data, staged.row_nhits.ctypes.data,
            staged.row_delta.ctypes.data, staged.row_ns.ctypes.data,
            staged.hit_names.ctypes.data, staged.codes.ctypes.data,
            ok_ns.ctypes.data, ok_calls.ctypes.data,
            ok_hits.ctypes.data, lim_ns.ctypes.data,
            lim_name.ctypes.data, lim_count.ctypes.data,
            counts.ctypes.data,
        )
        n_ok, n_lim = int(counts[0]), int(counts[1])
        ok = [
            (self._ns_string(ns), calls, hits)
            for ns, calls, hits in zip(
                ok_ns[:n_ok].tolist(), ok_calls[:n_ok].tolist(),
                ok_hits[:n_ok].tolist(),
            )
        ]
        limited = [
            (self._ns_string(ns), self._name_string(name), count)
            for ns, name, count in zip(
                lim_ns[:n_lim].tolist(), lim_name[:n_lim].tolist(),
                lim_count[:n_lim].tolist(),
            )
        ]
        return ok, limited

    def ok_aggr_strings(self, ok_aggr):
        """Begin-time OK aggregation with namespace tokens resolved."""
        return [
            (self._ns_string(ns), calls, hits)
            for ns, calls, hits in ok_aggr
        ]

    def _ns_string(self, token: int) -> str:
        s = self._ns_strings.get(token)
        if s is None:
            s = self.hp.string(token)
            self._ns_strings[token] = s
        return s

    def _name_string(self, token: int) -> Optional[str]:
        if token < 0:
            return None
        s = self._name_strings.get(token)
        if s is None:
            s = self.hp.string(token)
            self._name_strings[token] = s
        return s

    def stats(self) -> dict:
        return self.hp.lane_stats()


class _IdsView:
    """dict-like `.get` over the native interner (compiled-constant lookup
    interface the mask programs use)."""

    __slots__ = ("hp",)

    def __init__(self, hp: HostPath):
        self.hp = hp

    def get(self, s: str, default: int = -2) -> int:
        out = self.hp.find(s)
        return out if out != -2 else default


class _StringsView:
    __slots__ = ("hp",)

    def __init__(self, hp: HostPath):
        self.hp = hp

    def __getitem__(self, token: int) -> str:
        return self.hp.string(token)


class NativeInterner:
    """Drop-in for compiler.Interner backed by the C++ table, so compiled
    constants and natively-parsed columns share one id space."""

    __slots__ = ("hp", "_ids", "strings")

    def __init__(self, hp: HostPath):
        self.hp = hp
        self._ids = _IdsView(hp)
        self.strings = _StringsView(hp)

    def intern(self, s: str) -> int:
        return self.hp.intern(s)

    def __len__(self) -> int:
        return self.hp.interned_count()
