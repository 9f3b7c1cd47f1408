"""Device-plane observability: request ids and the ``/debug/stats`` walk.

Counterpart of part of ``limitador_tpu/observability/device_plane.py``:

* the request-id context variable (``current_request_id`` /
  ``set_request_id``), set per HTTP request and gRPC call by
  ``server/middleware.py`` and read by the exemplars of
  ``datastore_latency``;
* ``collect_debug_stats``, the ``GET /debug/stats`` walk over limiters,
  storages and pipelines: per-queue depths, per-shard table occupancy
  and the decision-plan caches;
* the label sets of the recorder's ``batcher_*`` families (``BATCHERS``,
  ``FLUSH_REASONS``), which ``metrics.py`` pre-seeds.

Left for a later slice (ROADMAP Queue A item 4): the
``DeviceStatsRecorder`` that the batchers write flush reasons, queue
waits, fill ratios and phase timings into, its slow-decision flight
recorder, and the profiler behind ``/debug/profile``. Until then
``flush_reasons`` and ``flight_recorder`` come back empty, as the JAX
walk gives them for a source without a recorder.
"""

from __future__ import annotations

from contextvars import ContextVar
from typing import Dict, List, Optional

__all__ = [
    "BATCHERS",
    "FLUSH_REASONS",
    "current_request_id",
    "set_request_id",
    "collect_debug_stats",
]

FLUSH_REASONS = ("size", "deadline", "shutdown")
# The two queues feeding the batcher_* families: the decision path's
# MicroBatcher and the write path's UpdateBatcher.
BATCHERS = ("check", "update")

_request_id: ContextVar[Optional[str]] = ContextVar(
    "limitador_tpu_torch_request_id", default=None
)


def current_request_id() -> Optional[str]:
    return _request_id.get()


def set_request_id(request_id: Optional[str]) -> None:
    _request_id.set(request_id)


# -- /debug/stats ------------------------------------------------------------

# The JAX package's queue names, so that dashboards read one key set.
_QUEUE_NAMES = {
    "MicroBatcher": "check_batcher",
    "UpdateBatcher": "update_batcher",
    "CompiledTorchLimiter": "compiled_pipeline",
    "NativeRlsPipeline": "native_pipeline",
}

#: attributes worth descending into when walking a limiter for
#: device-plane state (facade -> storage -> batchers -> device table)
_CHILD_ATTRS = (
    "storage", "counters", "batcher", "update_batcher", "inner", "_torch",
    "limiter",
)


def collect_debug_stats(*sources) -> dict:
    """Walk limiters/storages/pipelines for device-plane state and shape
    the ``GET /debug/stats`` payload: per-queue depths, per-shard table
    occupancy and the decision-plan caches. Everything is
    getattr-driven, so any storage topology reports what it has (an
    in-memory limiter reports empty lists)."""
    seen: set = set()
    queues: List[dict] = []
    shards: Dict[str, dict] = {}
    plan_caches: Dict[int, dict] = {}
    for source in sources:
        _walk(source, seen, queues, shards, plan_caches)
    out = {
        "queues": queues,
        "shards": list(shards.values()),
        "flush_reasons": {},
        "flight_recorder": [],
    }
    if plan_caches:
        # Per-pipeline decision-plan cache state (native blob cache
        # and/or compiled counter cache), keyed by type name.
        out["plan_cache"] = {
            name: stats for stats in plan_caches.values()
            for name in (stats.pop("_source"),)
        }
    return out


def _walk(source, seen, queues, shards, plan_caches) -> None:
    if source is None or id(source) in seen:
        return
    seen.add(id(source))
    cache_stats = getattr(source, "plan_cache_stats", None)
    if callable(cache_stats):
        stats = cache_stats()
        if stats:
            stats = dict(stats)
            stats["_source"] = type(source).__name__
            plan_caches[id(source)] = stats
    pending = getattr(source, "_pending", None)
    if hasattr(pending, "__len__"):
        name = type(source).__name__
        entry = {
            "queue": _QUEUE_NAMES.get(name, name),
            "depth": len(pending),
        }
        pending_hits = getattr(source, "_pending_hits", None)
        if pending_hits is not None:
            entry["pending_hits"] = int(pending_hits)
        queues.append(entry)
    device_stats = getattr(source, "device_stats", None)
    if callable(device_stats):
        # Keyed by shard label: a facade delegating to its inner storage
        # must not report the same table twice.
        for shard in device_stats().get("shards", ()):
            shards[str(shard.get("shard"))] = shard
    for attr in _CHILD_ATTRS:
        child = getattr(source, attr, None)
        if child is not None and not isinstance(
            child, (int, float, str, bytes, bool, dict, list, tuple, set)
        ):
            _walk(child, seen, queues, shards, plan_caches)
