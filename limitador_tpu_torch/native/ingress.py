"""ctypes binding and batch pump for the port's HTTP/2 gRPC ingress
(``csrc/h2ingress.cc``).

Counterpart of ``limitador_tpu/native/ingress.py``. The C++ side owns
every socket: accept, HTTP/2 framing, HPACK, flow control and response
frames all happen on one epoll thread with no Python per request. Python
sees the ingress as a batch queue: the pump thread takes whole batches of
raw RateLimitRequest payloads, runs them through the native pipeline
(``device/native_pipeline.py``: hot lane -> miss lane -> B1 on the card)
and answers the batch in one call. Rows the columnar engine cannot take
(several descriptors, exact-path namespaces, every row while the
admission breaker is not closed) go to the pipeline's asyncio ``submit``
on the server's loop and are answered one by one as they resolve; other
registered methods (the Kuadrant check/report split, gRPC reflection's
stream) run their coroutine handlers on the same loop.

Three pumps, chosen per batch as the JAX package chooses them:

* coded (``_decide_coded``/``_finish_coded``): with the hot lane on, a
  batch of ShouldRateLimit rows stays in the take buffers end to end
  (``_begin_batch_coded_ptrs``) and is answered with ONE
  ``h2i_respond_coded`` call over the lane's outcome codes;
* pipelined (``_decide_pipelined``/``_finish_decided``): the bytes form
  of the same begin/finish split, for batches that carry other methods
  or a pipeline without outcome templates;
* serial (``_decide_serial``): ``decide_many``, for pipelines without the
  split.

Begin runs on the pump thread under the pipeline's native lock; the
collect runs on a pool of two threads, at most two batches in flight.
``TorchStorage.begin_check_columnar`` copies the hot lane's staging
columns (which the next begin reuses) before it launches, and each launch
downloads into its own pinned buffers behind its own event, so a collect
on a pool thread waits on the batch's event, never on its own current
stream. ``close()`` joins the pump and serialises every ``h2i_*`` call
under ``_ctx_lock``, so a slow-path answer that resolves after close
never reaches a freed context.

In a pod member the begin also answers foreign rows (codes from
``LANE_FOREIGN_BASE``, which have no coded template). The pump submits
each owner's foreign rows as ONE bulk hop (``PodFrontend.
forward_bulk_submit``) without waiting for it, and ``_foreign_done``
answers them from the hop's done-callback on the lane's loop, so that a
slow peer never holds the pump or the finish pool; a row the hop could
not decide (or every row of a failed hop) takes the asyncio exact path,
routed by the pod frontend.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional

import numpy as np

from . import build
from .build import BuildError

__all__ = [
    "ingress_available", "ingress_build_error", "NativeIngress",
    "GrpcHandlerError", "HpackDecoder",
    "ingress_tel_available", "ingress_tel_config", "ingress_tel_drain",
    "TARGET_PATH",
]

TARGET_PATH = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"

GRPC_UNAVAILABLE = 14
GRPC_INTERNAL = 13
GRPC_UNIMPLEMENTED = 12


class GrpcHandlerError(Exception):
    """Raised by a registered method handler to answer with a specific
    grpc status (the ``context.abort`` of this serving model)."""

    def __init__(self, status: int, message: bytes = b""):
        super().__init__(status, message)
        self.status = status
        self.message = message


_sigs_lock = threading.Lock()
_sigs_done = None


def _bind(lib) -> None:
    """ctypes signatures, the JAX binding's exactly."""
    lib.h2i_create.restype = ctypes.c_void_p
    lib.h2i_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.h2i_port.restype = ctypes.c_int
    lib.h2i_port.argtypes = [ctypes.c_void_p]
    lib.h2i_take.restype = ctypes.c_int
    lib.h2i_take.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.h2i_respond.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.h2i_stat.restype = ctypes.c_uint64
    lib.h2i_stat.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.h2i_stream_key.restype = ctypes.c_uint64
    lib.h2i_stream_key.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.h2i_close.argtypes = [ctypes.c_void_p]
    lib.h2i_hpack_decoder_new.restype = ctypes.c_void_p
    lib.h2i_hpack_decoder_free.argtypes = [ctypes.c_void_p]
    lib.h2i_hpack_dyn_size.restype = ctypes.c_uint64
    lib.h2i_hpack_dyn_size.argtypes = [ctypes.c_void_p]
    lib.h2i_hpack_decode_test.restype = ctypes.c_int
    lib.h2i_hpack_decode_test.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
    ]
    lib.h2i_set_code.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_uint32,
    ]
    lib.h2i_respond_coded.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.h2i_tel_config.argtypes = [ctypes.c_int32]
    lib.h2i_tel_drain.restype = ctypes.c_int32
    lib.h2i_tel_drain.argtypes = [ctypes.c_void_p, ctypes.c_int64]


def _bound(lib):
    global _sigs_done
    if _sigs_done is not lib:
        with _sigs_lock:
            if _sigs_done is not lib:
                _bind(lib)
                _sigs_done = lib
    return lib


def _load():
    """The bound ingress library, built at first use; raises
    ``BuildError``."""
    return _bound(build.ingress_library())


def ingress_available() -> bool:
    """True when the ingress builds and loads."""
    try:
        _load()
    except BuildError:
        return False
    return True


def ingress_build_error() -> Optional[str]:
    """The build failure's message, None when the library loads."""
    try:
        _load()
    except BuildError as exc:
        return str(exc)
    return None


# -- respond-path telemetry (the native telemetry plane) ----------------------
# Process-global in the C library, like the host lane's hp_tel_*: module
# functions, merged into the plane's PHASES under ``h2i_respond`` by
# observability/native_plane.py. They PEEK at the library instead of
# loading it: a metrics poll must never build the ingress (a server
# without --native-ingress never builds it). NativeIngress construction
# re-arms the state asked for before the library was loaded.

#: log2-ns buckets of the respond histogram (the host lane's layout)
TEL_BUCKETS = 40

_tel_desired = False


def _peek():
    lib = build.ingress_loaded()
    return None if lib is None else _bound(lib)


def ingress_tel_available() -> bool:
    lib = _peek()
    return lib is not None and hasattr(lib, "h2i_tel_drain")


def ingress_tel_config(enabled: bool) -> bool:
    """Arm or disarm the respond histogram; remembered for a library
    loaded later. True when a loaded library took it."""
    global _tel_desired
    _tel_desired = bool(enabled)
    if not ingress_tel_available():
        return False
    _peek().h2i_tel_config(1 if enabled else 0)
    return True


def ingress_tel_drain():
    """Cumulative ``h2i_respond_coded`` histogram in the host lane's
    drain shape ``{"count", "sum_ns", "buckets": [TEL_BUCKETS]}``; None
    when the library is not loaded."""
    if not ingress_tel_available():
        return None
    out = np.zeros(2 + TEL_BUCKETS, np.int64)
    need = _peek().h2i_tel_drain(out.ctypes.data, out.shape[0])
    if need != out.shape[0]:
        raise RuntimeError(
            f"h2i_tel_drain layout mismatch: library says {need} int64s, "
            f"binding allocated {out.shape[0]}"
        )
    return {
        "count": int(out[0]),
        "sum_ns": int(out[1]),
        "buckets": out[2:].tolist(),
    }


def _sampled_batch_span(pendings, n: int):
    """``device_batch_span`` for a 1-in-N sampled hot-lane batch on the
    ingress path; a no-op context unless an exporter is installed AND the
    C begin stamped this batch with a trace id."""
    from contextlib import nullcontext

    from ..observability.tracing import device_batch_span, tracing_enabled

    if not tracing_enabled():
        return nullcontext()
    for pending in pendings:
        staged = getattr(pending, "staged", None)
        if staged is not None and getattr(staged, "trace_id", 0):
            from . import staged_trace_attrs

            attrs = staged_trace_attrs(staged)
            attrs["native.ingress"] = True
            return device_batch_span(0, n, attrs)
    return nullcontext()


class HpackDecoder:
    """Test surface over the ingress's HPACK decoder: the dynamic table
    persists across ``decode`` calls, as on a connection (the RFC 7541
    Appendix C sequences exercise exactly that). Raises ``BuildError``
    when the library cannot be built."""

    def __init__(self):
        self._lib = _load()
        self._d = ctypes.c_void_p(self._lib.h2i_hpack_decoder_new())

    def decode(self, block: bytes):
        """Decode one header block; returns [(name, value)] byte pairs,
        raises ValueError on malformed input."""
        if self._d is None:
            raise ValueError("decoder is closed")
        out = (ctypes.c_uint8 * 65536)()
        n = self._lib.h2i_hpack_decode_test(
            self._d, block, len(block), out, len(out)
        )
        if n == -1:
            raise ValueError("malformed HPACK block")
        if n < 0:
            raise RuntimeError("decode buffer too small")
        # u32le length-prefixed fields (HPACK strings are arbitrary octet
        # strings: a separator byte would be ambiguous)
        buf = bytes(out[:n])
        fields, off = [], 0
        while off < len(buf):
            flen = int.from_bytes(buf[off:off + 4], "little")
            off += 4
            fields.append(buf[off:off + flen])
            off += flen
        return list(zip(fields[0::2], fields[1::2]))

    @property
    def dynamic_table_size(self) -> int:
        if self._d is None:
            raise ValueError("decoder is closed")
        return self._lib.h2i_hpack_dyn_size(self._d)

    def close(self):
        if self._d:
            self._lib.h2i_hpack_decoder_free(self._d)
            self._d = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeIngress:
    """Owns one C++ ingress context and its pump thread.

    ``loop`` (an asyncio loop running elsewhere) enables the exact path
    for rows the columnar engine cannot take; without one they answer
    UNIMPLEMENTED. ``handlers`` maps other method paths (the Kuadrant
    check/report split) to ``async (request_bytes) -> response_bytes``
    callables run on the same loop, which makes the ingress a complete
    single-port server; unregistered methods answer UNIMPLEMENTED.
    ``stream_path`` names one registered bidi-stream method (gRPC
    reflection). Raises ``BuildError`` when the library cannot be built
    and ``OSError`` when the address cannot be bound."""

    def __init__(
        self,
        pipeline,
        host: str = "0.0.0.0",
        port: int = 0,
        loop=None,
        max_batch: int = 8192,
        poll_ms: int = 20,
        handlers=None,
        stream_path: Optional[str] = None,
    ):
        lib = _load()
        self._lib = lib
        self.pipeline = pipeline
        self.loop = loop
        self.handlers = dict(handlers or {})
        # The C++ layer dispatches each message of the stream method on
        # arrival (path) and the client's half-close as path + "#eos";
        # answering the eos event with status -1 closes the stream.
        self.stream_path = stream_path
        # Answer COMPLETION on the stream method is serialised PER
        # STREAM: a message handler that awaits mid-body must answer
        # before a later message's answer or the eos close of its stream
        # (once the close answers, the C side drops any later answer).
        # Keyed by the C++ (conn, stream) key, so that a slow handler on
        # one stream cannot stall other streams. Entries are made on the
        # pump thread and removed when the eos close answers; streams torn
        # down without a half-close are pruned past a size threshold.
        self._stream_locks: dict = {}
        self.max_batch = max_batch
        self.poll_ms = poll_ms
        ctx = lib.h2i_create(
            host.encode(), port, TARGET_PATH.encode(),
            stream_path.encode() if stream_path else None,
        )
        if not ctx:
            raise OSError(f"could not bind native ingress to {host}:{port}")
        self._ctx = ctypes.c_void_p(ctx)
        self.port = lib.h2i_port(self._ctx)
        # Re-arm the respond-path telemetry a plane asked for before this
        # library was loaded (ingress_tel_config only peeks).
        if _tel_desired:
            lib.h2i_tel_config(1)
        # Hot-lane coded answers: the pipeline's outcome templates are
        # registered with the C layer once, and the pump answers whole
        # batches with ONE h2i_respond_coded call.
        self._coded = False
        templates = getattr(pipeline, "lane_code_templates", None)
        if callable(templates) and hasattr(
            pipeline, "_begin_batch_coded_ptrs"
        ):
            tmpl = templates()
            if tmpl:
                for code, (status, payload) in tmpl.items():
                    lib.h2i_set_code(
                        self._ctx, code, status, payload, len(payload)
                    )
                self._coded = True
        self._stopping = False
        # Serialises every h2i_* call against close(): slow-path done
        # callbacks fire on the server loop thread and must never reach a
        # freed context.
        self._ctx_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._pump, name="h2-ingress-pump", daemon=True
        )
        self._thread.start()

    # -- stats --------------------------------------------------------------

    def library_stats(self) -> dict:
        """Metrics poll surface (``metrics.attach_library_source``): the
        C++ counters under their exported ``ingress_*`` names."""
        s = self.stats()
        return {
            "ingress_connections": s["connections"],
            "ingress_requests": s["requests"],
            "ingress_responses": s["responses"],
            "ingress_protocol_errors": s["protocol_errors"],
            # Asyncio-side pipeline queue (exact-path rows the ingress
            # routed through submit); the C++ loop itself never queues.
            "queue_depth": len(getattr(self.pipeline, "_pending", ())),
        }

    def stats(self) -> dict:
        with self._ctx_lock:
            if self._ctx is None:
                return {
                    "connections": 0, "requests": 0, "responses": 0,
                    "protocol_errors": 0,
                }
            s = self._lib.h2i_stat
            return {
                "connections": s(self._ctx, 0),
                "requests": s(self._ctx, 1),
                "responses": s(self._ctx, 2),
                "protocol_errors": s(self._ctx, 3),
            }

    # -- pump ---------------------------------------------------------------

    def _pump(self) -> None:
        n_max = self.max_batch
        ids = (ctypes.c_uint64 * n_max)()
        ptrs = (ctypes.c_void_p * n_max)()
        lens = (ctypes.c_uint32 * n_max)()
        path_ptrs = (ctypes.c_void_p * n_max)()
        path_lens = (ctypes.c_uint32 * n_max)()
        # With the pipeline's begin/finish split, the pump begins batch
        # N+1 while batch N's device round trip is in flight (two at
        # most); pipelines without it take decide_many.
        pipelined = hasattr(self.pipeline, "_begin_batch") and hasattr(
            self.pipeline, "_finish_namespace"
        )
        finish_pool = None
        sem = None
        if pipelined:
            from concurrent.futures import ThreadPoolExecutor

            finish_pool = ThreadPoolExecutor(
                2, thread_name_prefix="h2-ingress-finish"
            )
            sem = threading.BoundedSemaphore(2)
        coded = self._coded and pipelined
        try:
            while not self._stopping:
                n = self._lib.h2i_take(
                    self._ctx, n_max, self.poll_ms,
                    ids,
                    ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
                    lens,
                    ctypes.cast(path_ptrs, ctypes.POINTER(ctypes.c_void_p)),
                    path_lens,
                )
                if n <= 0:
                    continue
                if coded and not np.frombuffer(
                    path_ptrs, dtype=np.uint64, count=n
                ).any():
                    # Only ShouldRateLimit rows (one vectorised scan of
                    # the path pointers): the batch stays in the take
                    # buffers end to end; only miss and slow rows become
                    # Python bytes.
                    self._decide_coded(ids, ptrs, lens, n, finish_pool, sem)
                    continue
                rids, blobs, unknown = [], [], []
                for i in range(n):
                    blob = ctypes.string_at(ptrs[i], lens[i])
                    if path_ptrs[i]:  # another method: route by path
                        path = ctypes.string_at(
                            path_ptrs[i], path_lens[i]
                        ).decode("utf-8", "replace")
                        if not self._dispatch_method(ids[i], path, blob):
                            unknown.append(
                                (ids[i], GRPC_UNIMPLEMENTED,
                                 b"unknown method")
                            )
                    else:
                        rids.append(ids[i])
                        blobs.append(blob)
                if unknown:
                    self._respond(unknown)
                if not rids:
                    continue
                if pipelined:
                    self._decide_pipelined(rids, blobs, finish_pool, sem)
                else:
                    self._decide_serial(rids, blobs)
        finally:
            if finish_pool is not None:
                finish_pool.shutdown(wait=True)

    def _map_results(self, rids, results, skip=frozenset()):
        """(rid, status, payload) for every decided row; rows in ``skip``
        (the slow path) are answered elsewhere."""
        out = []
        for i, (rid, res) in enumerate(zip(rids, results)):
            if i in skip or res is None:
                continue
            if res is self.pipeline.STORAGE_ERROR:
                out.append((rid, GRPC_UNAVAILABLE, b"storage unavailable"))
            else:
                out.append((rid, 0, res))
        return out

    def _decide_serial(self, rids, blobs) -> None:
        try:
            results = self.pipeline.decide_many(blobs, chunk=len(blobs))
        except Exception as exc:  # answer the batch, don't die
            self._respond(
                [(rid, GRPC_INTERNAL, str(exc).encode()[:100])
                 for rid in rids]
            )
            return
        for rid, blob, res in zip(rids, blobs, results):
            if res is None:
                self._submit_slow(rid, blob)
        self._respond(self._map_results(rids, results))

    def _decide_pipelined(self, rids, blobs, finish_pool, sem) -> None:
        sem.acquire()
        submitted = False
        slow: set = set()
        try:
            results, slow_rows, pendings, foreign = (
                self.pipeline._begin_batch(blobs)
            )
            slow = set(slow_rows)
            for r in slow_rows:
                self._submit_slow(rids[r], blobs[r])
            # foreign rows stay None in results: the finish skips them
            self._forward_foreign(foreign, rids, blobs)
            finish_pool.submit(
                self._finish_decided, rids, slow, results, pendings, sem
            )
            submitted = True
        except Exception as exc:
            # Slow rows already handed to the asyncio path answer through
            # it: answering them INTERNAL here would beat their real
            # decision (the C side keeps the first answer).
            self._respond(
                [(rid, GRPC_INTERNAL, str(exc).encode()[:100])
                 for i, rid in enumerate(rids) if i not in slow]
            )
        finally:
            if not submitted:
                sem.release()

    def _decide_coded(self, ids, ptrs, lens, n, finish_pool, sem) -> None:
        """Hot-lane batch: begin over the take buffers in place, hand the
        collect to the finish pool. Only the id column is copied: the
        next take reuses the buffers, but the begin consumed the payloads
        before it returned (miss and slow rows became bytes inside it)."""
        sem.acquire()
        submitted = False
        slow: set = set()
        try:
            ids_arr = np.frombuffer(ids, dtype=np.uint64, count=n).copy()
            codes, results, slow_rows, pendings = (
                self.pipeline._begin_batch_coded_ptrs(ptrs, lens, n)
            )
            slow = set(slow_rows)
            for r in slow_rows:
                self._submit_slow(
                    int(ids_arr[r]), ctypes.string_at(ptrs[r], lens[r])
                )
            if self.pipeline._pod is not None:
                from ..device.native_pipeline import foreign_groups

                foreign = foreign_groups(codes)
                if foreign:
                    # the coded respond skips these codes (no template);
                    # their bytes leave the take buffers before the next
                    # take reuses them
                    rows = [r for group in foreign.values() for r in group]
                    self._forward_foreign(
                        foreign, {r: int(ids_arr[r]) for r in rows},
                        {r: ctypes.string_at(ptrs[r], lens[r])
                         for r in rows},
                    )
            finish_pool.submit(
                self._finish_coded, ids_arr, codes, results, slow,
                pendings, sem,
            )
            submitted = True
        except Exception as exc:
            self._respond(
                [(int(rid), GRPC_INTERNAL, str(exc).encode()[:100])
                 for i, rid in enumerate(
                     np.frombuffer(ids, dtype=np.uint64, count=n).tolist()
                 ) if i not in slow]
            )
        finally:
            if not submitted:
                sem.release()

    def _finish_coded(self, ids_arr, codes, results, slow, pendings,
                      sem) -> None:
        """Collect a hot-lane batch: finish the launched lanes, then
        answer every coded row with ONE native call; miss rows (bytes the
        miss lane decided) answer through the per-row path. A 1-in-N
        sampled batch (``--native-trace-sample``) gets a
        ``device_batch_span`` with the begin's native splits."""
        try:
            with _sampled_batch_span(pendings, len(ids_arr)):
                for pending in pendings:
                    self.pipeline._finish_namespace(pending, results)
            if codes is not None:
                with self._ctx_lock:
                    if self._ctx is None:
                        return
                    self._lib.h2i_respond_coded(
                        self._ctx, len(ids_arr), ids_arr.ctypes.data,
                        codes.ctypes.data,
                    )
            items = []
            for i, res in enumerate(results):
                if res is None or i in slow:
                    continue
                if res is self.pipeline.STORAGE_ERROR:
                    items.append(
                        (int(ids_arr[i]), GRPC_UNAVAILABLE,
                         b"storage unavailable")
                    )
                else:
                    items.append((int(ids_arr[i]), 0, res))
            self._respond(items)
        except Exception as exc:
            self._respond(
                [(int(rid), GRPC_INTERNAL, str(exc).encode()[:100])
                 for i, rid in enumerate(ids_arr.tolist())
                 if i not in slow]
            )
        finally:
            sem.release()

    def _finish_decided(self, rids, slow, results, pendings, sem) -> None:
        """Collect one launched batch and answer it. Rows in ``slow``
        went to the asyncio exact path at begin; every other row is
        decided here."""
        try:
            for pending in pendings:
                self.pipeline._finish_namespace(pending, results)
            self._respond(self._map_results(rids, results, skip=slow))
        except Exception as exc:
            self._respond(
                [(rid, GRPC_INTERNAL, str(exc).encode()[:100])
                 for i, rid in enumerate(rids) if i not in slow]
            )
        finally:
            sem.release()

    def _forward_foreign(self, foreign, rids, blobs) -> None:
        """Submit each owner's foreign rows (``foreign``: owner -> batch
        rows) as ONE bulk hop from the pump thread, without waiting:
        ``_foreign_done`` answers them from the hop's done-callback, never
        from the finish pool, whose two threads gate the semaphore the
        pump blocks on. ``rids``/``blobs`` index by batch row."""
        if not foreign:
            return
        pod = self.pipeline._pod
        for owner, rows in foreign.items():
            fut = pod.forward_bulk_submit(owner, [blobs[r] for r in rows])
            if fut is None:  # the lane's loop is down: the exact path
                for r in rows:
                    self._submit_slow(rids[r], blobs[r])
                continue
            fut.add_done_callback(
                lambda f, rows=rows: self._foreign_done(f, rows, rids, blobs)
            )

    def _foreign_done(self, fut, rows, rids, blobs) -> None:
        """Answer one owner's bulk hop from its done-callback (on the
        lane's loop, the moment the RPC resolves; the lane's deadline,
        retry and hedge budget bound that). The payload rows answer in
        one respond; a failed hop, a payload column of the wrong length
        or a row the owner could not decide takes the exact per-request
        path, routed by the pod frontend (so its degraded-owner failover
        owns that failure). Every row is answered once from here."""
        try:
            payloads = fut.result()  # done: never blocks
        except Exception:
            payloads = None
        if payloads is None or len(payloads) != len(rows):
            payloads = [None] * len(rows)
        out = []
        for r, payload in zip(rows, payloads):
            if payload is None:
                try:
                    self._submit_slow(rids[r], blobs[r])
                except Exception:
                    out.append(
                        (rids[r], GRPC_INTERNAL, b"foreign hop failed")
                    )
            else:
                out.append((rids[r], 0, payload))
        if out:
            try:
                self._respond(out)
            except Exception:
                pass  # the ingress closed mid-answer: the streams are gone

    def _answer_from_loop(self, rid: int, coro, ok_status: int = 0) -> None:
        """Run a coroutine on the server loop and answer ``rid`` with its
        result, mapping GrpcHandlerError and StorageError to their
        statuses. Always answers, cancellation at shutdown included."""
        import asyncio

        from ..storage.base import StorageError

        def done(fut):
            try:
                self._respond([(rid, ok_status, fut.result())])
            except GrpcHandlerError as exc:
                self._respond([(rid, exc.status, exc.message)])
            except StorageError:
                self._respond(
                    [(rid, GRPC_UNAVAILABLE, b"Service unavailable")]
                )
            except BaseException as exc:  # CancelledError included
                self._respond([(rid, GRPC_INTERNAL, str(exc).encode()[:100])])

        try:
            cfut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        except RuntimeError as exc:  # loop closed
            coro.close()
            self._respond([(rid, GRPC_UNAVAILABLE, str(exc).encode()[:100])])
            return
        cfut.add_done_callback(done)

    def _stream_lock(self, rid: int):
        """(key, per-stream answer lock) for a taken stream item. Runs on
        the pump thread only (close() joins the pump before it frees the
        context, so the context is live here).

        Key 0 means the stream is already gone (answered or reset): a
        throwaway lock, so that unrelated dead streams share nothing.
        Past 4,096 entries the unlocked ones are pruned: an unlocked lock
        has no handler in flight, so dropping and remaking it cannot
        reorder that stream's answers."""
        import asyncio

        key = self._lib.h2i_stream_key(self._ctx, rid)
        if key == 0:
            return 0, asyncio.Lock()
        lock = self._stream_locks.get(key)
        if lock is None:
            if len(self._stream_locks) >= 4096:
                for k in [
                    k for k, held in self._stream_locks.items()
                    if not held.locked()
                ]:
                    del self._stream_locks[k]
            lock = asyncio.Lock()
            self._stream_locks[key] = lock
        return key, lock

    def _dispatch_method(self, rid: int, path: str, blob: bytes) -> bool:
        """Route a method other than ShouldRateLimit: a registered
        handler coroutine runs on the server loop. False when none is
        registered (the caller answers UNIMPLEMENTED)."""
        if self.stream_path is not None and path == self.stream_path + "#eos":
            # The client half-closed the stream: close it behind every
            # still-pending message handler of that stream (coroutine
            # start order alone does not bound completion order).
            if self.loop is not None:
                key, serial = self._stream_lock(rid)

                async def _close() -> bytes:
                    async with serial:
                        self._stream_locks.pop(key, None)
                        return b""

                self._answer_from_loop(rid, _close(), ok_status=-1)
            else:
                self._respond([(rid, -1, b"")])
            return True
        handler = self.handlers.get(path)
        if handler is None or self.loop is None:
            return False
        if self.stream_path is not None and path == self.stream_path:
            _key, serial = self._stream_lock(rid)

            async def _serialized(blob=blob) -> bytes:
                async with serial:
                    return await handler(blob)

            self._answer_from_loop(rid, _serialized())
        else:
            self._answer_from_loop(rid, handler(blob))
        return True

    def _submit_slow(self, rid: int, blob: bytes) -> None:
        """Exact-path row: the pipeline's asyncio ``submit`` on the
        server loop (it must run there: it enqueues on that loop's
        serving shard), answered when it resolves."""
        if self.loop is None:
            self._respond(
                [(rid, GRPC_UNIMPLEMENTED, b"method variant not supported")]
            )
            return
        submit = self.pipeline.submit

        async def _decide() -> bytes:
            return await submit(blob)

        self._answer_from_loop(rid, _decide())

    def _respond(self, items: List[tuple]) -> None:
        if not items:
            return
        n = len(items)
        ids = (ctypes.c_uint64 * n)(*[it[0] for it in items])
        statuses = (ctypes.c_int * n)(*[it[1] for it in items])
        payloads = (ctypes.c_char_p * n)(*[it[2] for it in items])
        lens = (ctypes.c_uint32 * n)(*[len(it[2]) for it in items])
        with self._ctx_lock:
            if self._ctx is None:  # closed: the peers are gone anyway
                return
            self._lib.h2i_respond(self._ctx, n, ids, statuses, payloads,
                                  lens)

    def close(self) -> None:
        """Stop the pump (after its batch in hand) and free the context.
        Idempotent."""
        if self._stopping:
            return
        self._stopping = True
        # No timeout: the pump may sit in a device round trip; freeing
        # the context under it would be a use after free. It re-checks
        # _stopping after every take.
        self._thread.join()
        with self._ctx_lock:
            self._lib.h2i_close(self._ctx)
            self._ctx = None
