"""Network shared-authority protocol — the out-of-process Redis role.

Port counterpart of ``limitador_tpu/storage/authority.py``. The service
name, the methods and the wire are the JAX package's, so a replica of
either package flushes to an authority of either package. ``msgpack``
is imported on the authority's path only (a client, a server, a call),
never when the module is imported.

The reference's topologies 2/3 let N limitador replicas share one counter
authority over the network (doc/topologies.md; the Redis transport:
redis_async.rs:67-147, Lua batch apply scripts.rs:28-45). Here the
authority is any of our own storages exposing ``apply_deltas`` — the
device table, the in-memory oracle, the disk store — served over a tiny gRPC
surface, so the write-behind ``CachedCounterStorage`` deploys across
processes:

    replica A ─┐
    replica B ─┼─ gRPC ApplyDeltas ──> authority process (card/memory/disk)
    replica C ─┘

Wire format: msgpack payloads over raw-bytes unary gRPC methods (no
protoc codegen needed; grpc_python_plugin is not available in this
image). Each item is self-contained — full limit identity + variables +
delta — exactly as Redis carries TTLs inline, so the authority needs no
shared limits registry. Transient network failures surface as
``StorageError(transient=True)``, driving the cached storage's
partition-revert machinery (redis_cached.rs:363-388).
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent import futures
from typing import Dict, List, Tuple

from ..core.counter import Counter
from ..core.limit import Limit
from .base import CounterStorage, StorageError

__all__ = ["RemoteAuthority", "AuthorityServer", "serve_authority"]

logger = logging.getLogger(__name__)

_SERVICE = "limitador.authority.v1.Authority"

_TRANSIENT_CODES = None  # populated lazily (grpc import deferred)

#: the stages of an ``ApplyDeltas`` call that ``AuthorityServer.stats``
#: times
_STAGES = ("decode", "intern", "apply", "encode")


def _limit_to_wire(limit: Limit) -> list:
    return [
        str(limit.namespace),
        limit.max_value,
        limit.seconds,
        sorted(c.source for c in limit.conditions),
        sorted(v.source for v in limit.variables),
        limit.name,
        limit.id,
    ]


def _limit_from_wire(data: list) -> Limit:
    namespace, max_value, seconds, conditions, variables, name, id_ = data
    return Limit(
        namespace, max_value, seconds, conditions, variables,
        name=name, id=id_,
    )


def _raw(x: bytes) -> bytes:
    return x


def _msgpack():
    import msgpack

    return msgpack


class RemoteAuthority(CounterStorage):
    """Client-side authority: a CounterStorage whose ``apply_deltas`` /
    ``delete_counters`` / ``clear`` execute on a remote authority server.
    Used as the ``authority`` of a CachedCounterStorage; called from the
    flush executor thread, so the channel is synchronous."""

    def __init__(self, target: str, timeout: float = 0.35):
        # 350ms: the reference's Redis response timeout (redis/mod.rs:13).
        import grpc

        self._grpc = grpc
        self._msgpack = _msgpack()
        self.target = target
        self.timeout = timeout
        self._channel = grpc.insecure_channel(target)
        self._apply = self._channel.unary_unary(
            f"/{_SERVICE}/ApplyDeltas",
            request_serializer=_raw,
            response_deserializer=_raw,
        )
        self._delete = self._channel.unary_unary(
            f"/{_SERVICE}/DeleteCounters",
            request_serializer=_raw,
            response_deserializer=_raw,
        )
        self._clear = self._channel.unary_unary(
            f"/{_SERVICE}/Clear",
            request_serializer=_raw,
            response_deserializer=_raw,
        )

    def _call(self, method, payload: bytes) -> dict:
        try:
            raw = method(payload, timeout=self.timeout)
        except self._grpc.RpcError as exc:
            code = exc.code()
            transient = code in (
                self._grpc.StatusCode.UNAVAILABLE,
                self._grpc.StatusCode.DEADLINE_EXCEEDED,
                self._grpc.StatusCode.RESOURCE_EXHAUSTED,
                self._grpc.StatusCode.ABORTED,
                self._grpc.StatusCode.CANCELLED,
            )
            raise StorageError(
                f"authority {self.target}: {code.name}: {exc.details()}",
                transient=transient,
            ) from None
        reply = self._msgpack.unpackb(raw, raw=False)
        if "err" in reply:
            raise StorageError(
                f"authority {self.target}: {reply['err']}",
                transient=bool(reply.get("transient")),
            )
        return reply

    # -- the authority surface ---------------------------------------------

    def apply_deltas(self, items: List[Tuple[Counter, int]]):
        payload = self._msgpack.packb(
            [
                [
                    _limit_to_wire(counter.limit),
                    sorted(counter.set_variables.items()),
                    int(delta),
                ]
                for counter, delta in items
            ],
            use_bin_type=True,
        )
        reply = self._call(self._apply, payload)
        return [(int(v), float(t)) for v, t in reply["ok"]]

    def delete_counters(self, limits) -> None:
        payload = self._msgpack.packb(
            [_limit_to_wire(limit) for limit in limits], use_bin_type=True
        )
        self._call(self._delete, payload)

    def clear(self) -> None:
        self._call(self._clear, self._msgpack.packb(None))

    def close(self) -> None:
        self._channel.close()

    # -- unused CounterStorage surface (reads stay replica-local in the
    # write-behind topology; the authority only applies deltas) ------------

    def is_within_limits(self, counter: Counter, delta: int) -> bool:
        raise StorageError(
            "RemoteAuthority is write-only (wrap it in a "
            "CachedCounterStorage)"
        )

    def add_counter(self, limit: Limit) -> None:
        pass

    def update_counter(self, counter: Counter, delta: int) -> None:
        self.apply_deltas([(counter, delta)])

    def check_and_update(self, counters, delta, load_counters):
        raise StorageError(
            "RemoteAuthority is write-only (wrap it in a "
            "CachedCounterStorage)"
        )

    def get_counters(self, limits) -> set:
        return set()


class AuthorityServer:
    """Server side: expose a local storage's ``apply_deltas`` (and
    delete/clear) to remote replicas. Runs a sync gRPC server on its own
    thread pool — storage implementations serialize internally, and the
    flush batches are coarse, so a small pool suffices.

    ``start`` first calls the storage's ``warm_apply`` where it has one
    (the device tables: ``apply_deltas``' kernels launched once on a
    table of their own), so that a replica's first flush does not pay
    their first load. ``stats()`` holds the RPCs served and where their
    time went (decode, limit interning, the storage call, encode), as
    ``/debug/stats`` shows it under ``authority``. ``stop`` waits until
    the server has stopped and its threads have ended."""

    def __init__(self, storage, address: str, max_workers: int = 8):
        import grpc

        msgpack = self._msgpack = _msgpack()
        self.storage = storage
        self._pool = futures.ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix="authority",
        )
        self._server = grpc.server(self._pool)
        self._lock = threading.Lock()
        self._limit_cache: Dict[bytes, Limit] = {}
        self._stats = {"apply_deltas": 0, "delete_counters": 0, "clear": 0,
                       "errors": 0, "items": 0, "slowest_ms": 0.0,
                       "largest": 0}
        self._ns = dict.fromkeys(_STAGES, 0)

        def apply_deltas(payload: bytes, _ctx) -> bytes:
            try:
                t0 = time.perf_counter_ns()
                entries = msgpack.unpackb(payload, raw=False)
                t1 = time.perf_counter_ns()
                items = []
                for limit_wire, vars_list, delta in entries:
                    items.append(
                        (Counter(self._limit_of(limit_wire),
                                 dict(vars_list)), delta)
                    )
                t2 = time.perf_counter_ns()
                out = self.storage.apply_deltas(items)
                t3 = time.perf_counter_ns()
                reply = msgpack.packb(
                    {"ok": [[int(v), float(t)] for v, t in out]},
                    use_bin_type=True,
                )
                self._count("apply_deltas", len(items),
                            (t1 - t0, t2 - t1, t3 - t2,
                             time.perf_counter_ns() - t3))
                return reply
            except StorageError as exc:
                self._count("errors")
                return msgpack.packb(
                    {"err": str(exc), "transient": exc.transient}
                )
            except Exception as exc:  # defensive: never kill the RPC thread
                self._count("errors")
                logger.exception("authority apply_deltas failed")
                return msgpack.packb({"err": str(exc), "transient": False})

        def delete_counters(payload: bytes, _ctx) -> bytes:
            try:
                limits = {
                    self._limit_of(w)
                    for w in msgpack.unpackb(payload, raw=False)
                }
                self.storage.delete_counters(limits)
                self._count("delete_counters")
                return msgpack.packb({"ok": []})
            except Exception as exc:
                self._count("errors")
                return msgpack.packb({"err": str(exc), "transient": False})

        def clear(_payload: bytes, _ctx) -> bytes:
            try:
                self.storage.clear()
                self._count("clear")
                return msgpack.packb({"ok": []})
            except Exception as exc:
                self._count("errors")
                return msgpack.packb({"err": str(exc), "transient": False})

        handlers = {
            "ApplyDeltas": grpc.unary_unary_rpc_method_handler(
                apply_deltas,
                request_deserializer=_raw,
                response_serializer=_raw,
            ),
            "DeleteCounters": grpc.unary_unary_rpc_method_handler(
                delete_counters,
                request_deserializer=_raw,
                response_serializer=_raw,
            ),
            "Clear": grpc.unary_unary_rpc_method_handler(
                clear,
                request_deserializer=_raw,
                response_serializer=_raw,
            ),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
        )
        try:
            self.port = self._server.add_insecure_port(address)
        except RuntimeError as exc:
            self.port = 0
            cause = f": {exc}"
        else:
            cause = ""
        if self.port == 0:
            self._pool.shutdown(wait=False)
            raise StorageError(f"cannot bind authority on {address}{cause}")

    def _count(self, key: str, items: int = 0, ns=None) -> None:
        with self._lock:
            stats = self._stats
            stats[key] += 1
            stats["items"] += items
            stats["largest"] = max(stats["largest"], items)
            if ns is not None:
                for stage, spent in zip(_STAGES, ns):
                    self._ns[stage] += spent
                stats["slowest_ms"] = max(stats["slowest_ms"], sum(ns) / 1e6)

    def stats(self) -> dict:
        """RPCs served by method, the counters they applied (and the most
        one RPC carried), failed RPCs, the slowest ``ApplyDeltas`` in
        milliseconds, and the milliseconds ``ApplyDeltas`` spent in each
        stage, summed over its calls: ``decode`` (msgpack), ``intern``
        (limits out of the cache, counters built), ``apply`` (the
        storage's ``apply_deltas``: on a device table its kernels and
        their read) and ``encode``."""
        with self._lock:
            out = dict(self._stats)
            out["ms"] = {k: v / 1e6 for k, v in self._ns.items()}
        return out

    def authority_stats(self) -> dict:
        """The ``/debug/stats`` section: ``stats()`` with the address."""
        return {"port": self.port, **self.stats()}

    def _limit_of(self, wire: list) -> Limit:
        """Intern decoded limits so hot counters share one Limit object
        (CEL re-parse per RPC would dominate otherwise)."""
        key = self._msgpack.packb(wire, use_bin_type=True)
        limit = self._limit_cache.get(key)
        if limit is None:
            limit = _limit_from_wire(wire)
            with self._lock:
                self._limit_cache[key] = limit
        return limit

    def start(self) -> "AuthorityServer":
        warm = getattr(self.storage, "warm_apply", None)
        if warm is not None:
            warm()
        self._server.start()
        return self

    def stop(self, grace: float = 1.0) -> None:
        self._server.stop(grace).wait()
        self._pool.shutdown(wait=True)


def serve_authority(storage, address: str) -> AuthorityServer:
    """Start serving ``storage`` as a shared authority on ``address``."""
    return AuthorityServer(storage, address).start()
