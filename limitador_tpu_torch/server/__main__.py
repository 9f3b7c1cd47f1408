"""The port's server binary: Envoy RLS v3 + Kuadrant v1 over gRPC, and
the HTTP admin and check API with Prometheus metrics.

Counterpart of ``limitador_tpu/server/__main__.py``, cut to the options
of the slices ported so far:

    python -m limitador_tpu_torch.server LIMITS_FILE \\
        [torch|sharded|memory|disk|cached|distributed] \\
        [--rls-port P] [--http-host H --http-port P] [--device cuda|cpu] \\
        [--capacity N] [--kernel-cache-dir DIR] [--validate] \\
        [--limits-poll-interval S] \\
        [--log-level L] [--structured-logs] [--limit-name-in-labels] \\
        [--metric-labels CEL_MAP | --metric-labels-file FILE] \\
        [--metrics-exemplars on|off] [--tracing-endpoint URL] \\
        [--tracing-sample-rate F] [--grpc-reflection-service] \\
        [--global-namespaces NS,NS --global-region N] \\
        [--batch-delay-us U] [--dispatch-chunk auto|off|N] \\
        [--rate-limit-headers NONE|DRAFT_VERSION_03] \\
        [--pipeline standard|compiled|native] [--native-hot-lane on|off] \\
        [--plan-cache-size N] [--lease-mode on|off] [--lease-max-tokens N] \\
        [--usage-topk K] [--usage-drain-interval S] \\
        [--usage-near-threshold F] [--cache-size N] \\
        [--tier-mode on|off [--tier-cold FILE] [--tier-migrate-interval S]] \\
        [--node-id ID --listen-address HOST:PORT --peer HOST:PORT ... \\
         --advertise-address HOST:PORT] \\
        [--snapshot-path FILE --snapshot-period S] [--profile-dir DIR] \\
        [--native-trace-sample N] [--native-slow-row-us U] \\
        [--slo-budget-ms MS] [--model-fit on|off] [--flight on|off] \\
        [--flight-sample N] [--flight-spool-dir DIR] [--flight-window S] \\
        [--flight-profile-s S] [--disk-path FILE] \\
        [--authority-url HOST:PORT] [--authority-listen HOST:PORT] \\
        [--flush-period MS] [--batch-size N] [--max-cached N] \\
        [--response-timeout MS] [--serving-shards N] \\
        [--pod-coordinator HOST:PORT --pod-processes N --pod-process-id I \\
         --pod-peer HOST:PORT ... [--pod-peer-listen HOST:PORT] \\
         [--pod-degraded-mode on|off] [--pod-hedge-ms MS] \\
         [--pod-peer-breaker-failures N] [--pod-peer-breaker-reset-ms MS] \\
         [--pod-events N] [--pod-psum-lane on|off] \\
         [--pod-psum-interval-ms MS] [--pod-resize on|off]] \\
        [--standby on|off] \\
        [--capacity-controller off|observe|on [--ctl-interval S] \\
         [--ctl-sustain S] [--ctl-dwell S] [--ctl-standby HOST:PORT,...] \\
         [--ctl-min-hosts N] [--ctl-max-hosts N] [--ctl-grow-headroom F] \\
         [--ctl-shrink-headroom F]]

Storages: ``torch`` (default) keeps the counter table on the card
(``--device cuda``, the default) or, for tests, on the CPU
(``--device cpu``); ``sharded`` keeps a sharded table
(``device/sharded.py``): one row of ``--capacity`` cells per visible
card (``torch.cuda.device_count()``; 1 with ``--device cpu``), counters
routed to their owner row by key hash, and the namespaces of
``--global-namespaces`` counted as per-row partials in the first
``--global-region`` slots of every row; ``memory`` is the exact
host-side reference. The limits file is watched and hot-reloaded through
``configure_with`` (counters of surviving limits are kept).

Host-memory storages (``storage/``, the JAX server's defaults): ``disk``
keeps the counters in SQLite at ``--disk-path`` (default
``limitador_counters.db``); ``cached`` decides on a local write-behind
cache (at most ``--max-cached`` counters) and flushes its deltas every
``--flush-period`` ms, or at ``--batch-size`` pending counters, to an
authority: a disk store at ``--disk-path``, or with ``--authority-url``
another server's ``--authority-listen``, asked with a
``--response-timeout`` of 350 ms by default (a flush that fails sets
``datastore_partitioned`` and keeps the deltas for the next one);
``distributed`` is the CRDT gossip storage, a node ``--node-id`` whose
broker listens on ``--listen-address`` (default 0.0.0.0:5001) and dials
every ``--peer``. With ``--authority-listen HOST:PORT`` the server also
serves its storage as the shared authority of remote ``cached``
replicas (``storage/authority.py``; on ``torch`` and ``sharded`` storage
the table on the card, whose ``apply_deltas`` runs B2's host form, B7c's
on the sharded table, and B3a's read); the address's port 0 binds a free
one. The pipelines, tiers, snapshots, the usage observatory and the
device plane run on ``torch`` and ``sharded`` storage only.

Pipelines (torch and sharded storage): ``standard`` decides per request
through the micro-batcher; ``compiled`` batch-compiles CEL
(``device/pipeline.py``); torch storage only:
``native`` adds the C++ columnar host lane for ShouldRateLimit
(``device/native_pipeline.py``). ``--lease-mode on`` (native only) adds
the quota-lease tier, whose credits run the B4c kernel. With
``--usage-topk`` > 0 (default 64) the tenant usage observatory drains the
hit column through the B5 kernel (B7d on sharded storage) every
``--usage-drain-interval`` seconds, on every torch and sharded server, as
the JAX server does on tpu and sharded storage.
``--native-ingress`` (torch storage with ``--pipeline native`` and
``--rate-limit-headers NONE``) serves ShouldRateLimit on ``--rls-port``
through the port's C++ HTTP/2 ingress (``native/ingress.py``): one
epoll thread owns the sockets and a pump feeds whole batches to the
native pipeline's hot lane and B1, answering each with one native call;
the Kuadrant ``CheckRateLimit``/``Report`` and gRPC reflection are served
on the same port, and the Python gRPC server moves to ``--rls-port`` +
1. ``/metrics`` then counts ``ingress_*`` and
``native_phase_h2i_respond``.
Replication (torch storage): ``--peer`` (repeatable) or
``--listen-address`` makes the node a member of the replicated topology
(``device/replicated.py``): its own counts stay in its device table, a
CRDT gossip broker on ``--listen-address`` (default 0.0.0.0:5001)
replicates per-actor counts with its peers, and every check folds the
gossiped remote share into the kernel's base (B6a; Report through B6b).
The wire is the JAX package's, so port and JAX nodes mix in one cluster.
The native pipeline and quota leases launch the plain check kernel and
are refused on a replicated node (exit 2).

Tiers (torch storage, ``--tier-mode on``): the storage is a
``TieredStorage`` (``tier/``): the device table holds the hot set,
capped at ``--cache-size`` qualified counters, and an LRU eviction
demotes the counter's exact cell to a host cold tier (one B3a peek)
instead of dropping it. Cold keys decide exactly on the host big-limit
lane; a TierManager thread every ``--tier-migrate-interval`` seconds
promotes hot cold keys (B4d seeds) and demotes above the watermark,
settling the native pipeline's leases on the demoted slots first
(``reclaim_slots``, B4c), and spills the cold write journal to
``--tier-cold`` (JSON lines). ``--tier-mode on`` with memory storage or
on a replicated node exits 2 (the JAX server warns and serves
single-tier there).

Sharded storage refuses what the JAX server degrades there (exit 2):
``--pipeline native`` (the JAX server serves compiled), ``--tier-mode
on`` (it serves single-tier), ``--lease-mode on``, and ``--peer`` or
``--listen-address``. A sharded checkpoint's capacity, region and
namespaces override the command line's, with a warning (they govern
key routing).

Snapshots (torch and sharded storage): with ``--snapshot-path`` the
counter table is checkpointed every ``--snapshot-period`` seconds and at
shutdown, and restored at start: into the replicated storage on a
replicated node (``load_snapshot``, before its broker starts), else as a
new table (``TorchStorage.restore``, whose capacity is the checkpoint's;
a tiered storage's checkpoint carries its cold cells, and the restore
arms ``--tier-cold`` again). A checkpoint that cannot be restored
(unreadable, or tiered while ``--tier-mode`` is off) is moved aside to
``FILE.rejected`` and the server starts with a fresh table.

HTTP (``server/http_api.py``, every storage) on ``--http-host``:
``--http-port``: ``/status``, ``/api/spec``, ``/metrics``,
``/limits/{ns}``, ``/counters/{ns}``, ``POST /check``, ``/report`` and
``/check_and_report``, and ``/debug/stats``, ``/debug/top``,
``/debug/tiering`` and ``/debug/profile`` (``torch.profiler`` captures
into ``--profile-dir``, CUDA activity included on ``--device cuda``).
``/metrics`` carries the reference's families and those of the layers
the server runs (``observability/metrics.py``);
``datastore_latency`` reads the MetricsLayer's ``should_rate_limit``
aggregate. ``--metric-labels`` (or the watched ``--metric-labels-file``)
adds CEL-valued labels. gRPC server reflection is always on (the
reference's behaviour; ``--grpc-reflection-service`` is ignored and
accepted only so that the JAX server's command lines parse), and every
request carries an ``x-request-id``. ``--tracing-endpoint`` exports
spans over OTLP/HTTP+JSON.

Device plane (torch and sharded storage): the batchers and pipelines
write flush reasons, queue waits, fill ratios, chunk plans and per-batch
phase timings into one recorder (``/metrics`` ``batcher_*``,
``device_phase_latency``, ``dispatch_chunk_*``; ``/debug/stats``
``flush_reasons`` and the slowest-32 ``flight_recorder``). A flush is cut
into launches of ``--dispatch-chunk`` hits (auto by default: sized from
the observed device time per hit against 2 ms; ``off`` = one launch a
flush). Torch storage also arms the host lane's native telemetry plane
(``native_phase_*``; ``--native-slow-row-us`` exemplars into the flight
recorder; ``--native-trace-sample`` 1-in-N trace ids on the batch
spans) and an SLO burn-rate watchdog of ``--slo-budget-ms`` at p99
(``slo_*``, ``device_backed``; ``/debug/stats`` ``native_telemetry``,
``slo``, ``device_backed``).

Control planes (the JAX server's defaults): with the usage observatory
running, a control-signal bus joins the planes' signals into one
timestamped vector, ticked on the observatory's drain thread
(``/debug/signals``, ``signal_*``); ``--model-fit on`` (default) fits the
serving model from the recorder's per-batch observations, refits it on
the drain thread and lets the tier manager price migrations with it
(``/debug/capacity``, ``model_*``, ``capacity_*``; torch and sharded
storage); ``--flight on`` (default) taps a process flight recorder on
every decision lane the server runs (1 in ``--flight-sample`` decisions
sampled, the slowest kept per lane) and runs a trigger thread that
writes incident bundles of ``--flight-window`` seconds into
``--flight-spool-dir`` (``limitador-flight`` under ``TMPDIR`` by
default) on SLO burn, a drift flip, a ``device_backed`` fall or ``POST
/debug/flight/trigger``, with a ``torch.profiler`` capture of
``--flight-profile-s`` seconds when that is above 0 (``/debug/flight``,
``flight_*``).

Admission plane (torch and sharded storage, ``admission/``):
``--admission-mode monitor|enforce`` (default ``off``: nothing is built
and the admission package is not imported) puts a controller in front of
the batched storage: ShouldRateLimit (standard and native) and ``POST
/check_and_report`` shed before a request takes a batch slot when its
gRPC deadline cannot survive the queue-wait estimate or the AIMD
concurrency limit (``--max-inflight``, ``--admission-target-queue-ms``)
is reached, lower ``--priority`` classes first; a shed answers
UNAVAILABLE/503, or OVER_LIMIT/429 under ``--shed-response overlimit``
(``monitor`` counts sheds and admits). A circuit breaker over the card
(``--breaker-failures``, ``--breaker-stall-ms``, ``--breaker-reset-ms``)
fails the check path over to an exact host oracle while the card stalls
or fails, and on recovery a probe batch (B1, B6a or B7a) and a reconcile
of the failover journal through ``apply_deltas`` (B2, B6b or B7c) close
it. Every transition logs a warning; ``/metrics`` carries the
``admission_*`` families (declared on every server) and ``/debug/stats``
an ``admission`` section. The kernels are built and launched once
before the breaker watches its first batch.

Nothing falls back: ``--admission-mode monitor|enforce`` on a host
storage (the JAX server warns and serves without the plane),
``--authority-url`` on a storage other than ``cached``, ``--authority-listen`` on a storage without ``apply_deltas``
(``cached``, ``distributed``), a ``--disk-path`` that cannot be opened,
an authority address that cannot be bound, and a native pipeline or
lease tier that cannot come up
(the host lane does not build, the hot lane is unavailable, the storage
is not torch, rate-limit headers are asked for), a native telemetry plane
that cannot arm (the host lane does not build), an HTTP port that
cannot be bound, a ``--tracing-endpoint`` that cannot start, a
``--flight-spool-dir`` that cannot be created or written, and
``--native-ingress`` without ``--pipeline native`` on torch storage,
with rate-limit headers, or with an ingress library that does not build
or an address that cannot be bound (the JAX server warns and serves
Python gRPC alone) stop the server with an error (exit 2), and a lease refresh, usage drain or tier
migration round that fails while serving stops it too (exit 1).

Serving shards: ``--serving-shards N`` (default 1) adds N - 1 serving
loops, each a thread with its own event loop and a sync gRPC server on
the RLS address (SO_REUSEPORT; ``server/rls.py`` ``RlsServingShard``),
all deciding through the one limiter, whose batchers and pipelines keep
a shard a loop. A shard that cannot bind stops the server (exit 2; the
JAX server warns and serves with fewer shards).

The pod (``--pod-processes N`` > 1): N server processes, each with its
own table, form a pod over a ``torch.distributed.TCPStore`` at
``--pod-coordinator`` (process 0 serves it; ``parallel/pod.py``) before
any storage is built. Each owns a contiguous block of the pod's shards
(one a visible card) and routes each decision to the owner of its
counters (``routing.py``): decided here, or forwarded once over the
peer lane (``server/peering.py``, on ``--pod-peer-listen``, default
``--rls-host``:``--rls-port`` + 2, serving once the first limits are
loaded) to its owner among the ``--pod-peer`` addresses (one a process,
in process-id order); a namespace with more than one limit, or a
``--global-namespaces`` one, is pinned to one host, or, with
``--pod-psum-lane on``, decided on every host against the others'
partials exchanged every ``--pod-psum-interval-ms`` (fixed windows
only). With ``--pod-degraded-mode on`` (the default) a dead owner's
decisions fail over to an exact local stand-in behind a per-peer breaker
(``--pod-peer-breaker-failures``, ``--pod-peer-breaker-reset-ms``), and
its journal replays into the owner's ``apply_deltas`` when it answers
again; ``--pod-hedge-ms`` races a second attempt at a slow forward. A
member's ``--snapshot-path`` becomes ``PATH.shardsLO-HI`` (its shard
range). ``/debug/pod``, ``/debug/pod/routing`` and ``/debug/events``
(a ring of ``--pod-events``) serve the pod's view, ``/metrics`` its
``pod_*`` and ``peer_*`` families, and the pod's event log reaches the
serving-model fit, the tier manager and the flight trigger, whose
incident bundles hold the peers' rings (the lane's ``flight`` kind). A
pod member serves ``--pipeline native`` (and ``--native-ingress``) on
torch storage through the native pod fast path: its C hot lane stamps
each plan with its owner host, stages the local rows for B1 on its own
table, and sends each flush's foreign rows to their owner in one
``bulk_decide`` a peer (``pod_hot_*``, ``pod_bulk_*``); the owner
decides them on its own hot lane and table. ``--native-hot-lane off``,
``--plan-cache-size 0`` or a pod past the hot lane's int8 owner code
warn and serve through the routed compiled pipeline (and
``--native-ingress`` then exits 2). A pod refuses (exit 2) the
``cached`` and ``distributed`` storages (a member's storage must take a
peer's journal replay through ``apply_deltas``); the option checks exit
2 with the JAX server's messages.

The elastic pod (``server/resize.py``): with ``--pod-resize on`` a pod
member arms the topology-epoch gate (forwards carry the topology epoch,
and a wrong-epoch forward is rejected rerouteable and re-planned) and
``POST /debug/pod/resize`` ``{"hosts": N, "peers": {...}}`` resizes or
drains the running pod, migrating each moved slice into its new owner's
table (idempotent against a per-transition ledger) and releasing it on
the old owner; an abort reverts to the old topology with nothing lost.
``--standby on`` boots a memberless warm standby (``server/standby.py``):
it serves its peer lane as host 0 of 1, runs the decision kernels once at
each hit bucket on a scratch table of ``--capacity`` and waits for
``POST /debug/pod/join`` ``{"address": ...}`` on a member (grow; with
``"replace": ID`` it takes a dead member's id). The environment's
``TPU_POD_RESIZE_SLICE_PAUSE_MS`` pauses each slice (for drills) and
``TPU_POD_RESIZE_TIMEOUT_S`` bounds a transition. ``GET
/debug/pod/resize`` and ``/debug/pod/standby`` serve their state.
``--kernel-cache-dir`` (the port's stand-in for the JAX server's
``--xla-cache-dir``) builds the CUDA kernels and the C++ host libraries
into a directory that outlives the process, set before any build, so
that a restarted host or a standby loads them instead of compiling.

The capacity controller (``control/``): ``--capacity-controller
observe|on`` (default ``off``: nothing is built and the package is not
imported) ticks every ``--ctl-interval`` s over the signal bus and the
serving model, and (``on``) moves the admission ceiling and shed floor
(with ``--admission-mode``), every serving lane's chunk target, the
lease grant scale (with ``--lease-mode on``) and, on a resize-armed pod
member, the membership: a ``--ctl-standby`` warm standby joins on
sustained burn and the tail host drains on sustained idle, between
``--ctl-min-hosts`` and ``--ctl-max-hosts``. ``/debug/stats`` serves a
``controller`` section and ``/metrics`` the ``ctl_*`` families (on every
server). A non-positive interval, a minimum above the maximum and a
standby list on a server that is no resize-armed pod member exit 2.
"""

from __future__ import annotations

import argparse
import asyncio
import inspect
import json
import logging
import os
import signal
import sys
import tempfile
import threading
import time
from typing import Optional

from ..core.cel import CelError
from ..core.limiter import AsyncRateLimiter, RateLimiter
from ..observability import model as model_mod
from ..observability import tracing
from ..observability.device_plane import TorchProfiler, default_profile_dir
from ..observability.metrics import PrometheusMetrics, install_metrics_layer
from ..ops.build import BuildError
from ..storage.base import StorageError
from ..storage.in_memory import DEFAULT_CACHE_SIZE, InMemoryStorage
from .http_api import run_http_server
from .limits_file import LimitsFileError, LimitsFileWatcher, load_limits_file
from .rls import (
    RATE_LIMIT_HEADERS_DRAFT03,
    RATE_LIMIT_HEADERS_NONE,
    serve_rls,
)

__all__ = ["main", "build_parser", "build_storage", "start", "RunningServer"]

log = logging.getLogger("limitador_tpu_torch")


def _env(name, default=None):
    return os.environ.get(name, default)


class _JsonFormatter(logging.Formatter):
    """Structured JSON log lines, shaped like the reference's
    tracing_subscriber json layer (main.rs:922-957): timestamp, level,
    target, fields.message."""

    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "timestamp": self.formatTime(record, "%Y-%m-%dT%H:%M:%S%z"),
            "level": record.levelname,
            "target": record.name,
            "fields": {"message": record.getMessage()},
        }
        if record.exc_info:
            entry["fields"]["exception"] = self.formatException(
                record.exc_info
            )
        return json.dumps(entry)


_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def _setup_logging(structured: bool, level: str) -> None:
    handler = logging.StreamHandler(sys.stderr)
    if structured:
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: "
                              "%(message)s")
        )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(_LEVELS.get(level.lower(), logging.INFO))


def _positive_interval(value: str) -> float:
    interval = float(value)
    if interval <= 0:
        raise argparse.ArgumentTypeError("poll interval must be > 0 seconds")
    return interval


def _dispatch_chunk(value: str):
    if value in ("auto", ""):
        return None  # auto-sized from the observed device time per hit
    if value in ("off", "0"):
        return 0  # one launch a flush
    chunk = int(value)
    if chunk < 0:
        raise argparse.ArgumentTypeError(
            "dispatch chunk must be >= 0, 'off' or 'auto'"
        )
    return chunk


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="limitador-tpu-torch-server",
        description="Rate limiter with its counter table on an NVIDIA GPU "
        "(Envoy RLS v3 + Kuadrant v1 gRPC)",
    )
    p.add_argument("limits_file", help="YAML limits file (hot-reloaded)")
    p.add_argument(
        "storage", nargs="?", default="torch",
        choices=["torch", "sharded", "memory", "disk", "cached",
                 "distributed"],
        help="counter storage: torch (device table, default), sharded "
        "(one table row per visible card), memory, disk (SQLite), cached "
        "(write-behind over an authority) or distributed (CRDT gossip)",
    )
    p.add_argument("--rls-host", default="0.0.0.0")
    p.add_argument("--rls-port", type=int, default=8081)
    p.add_argument("--http-host", default=_env("HTTP_API_HOST", "0.0.0.0"))
    p.add_argument(
        "--http-port", type=int, default=int(_env("HTTP_API_PORT", "8080"))
    )
    p.add_argument(
        "--limit-name-in-labels", action="store_true",
        default=_env("LIMIT_NAME_IN_PROMETHEUS_LABELS") == "1",
        help="add limit names to prometheus labels",
    )
    p.add_argument(
        "--tracing-endpoint", default=_env("TRACING_ENDPOINT"),
        help="OTLP/HTTP endpoint for span export (the vendored "
        "OTLP/HTTP+JSON pipeline over the opentelemetry API; a pipeline "
        "that cannot start exits 2)",
    )
    p.add_argument(
        "--tracing-sample-rate", type=float,
        default=float(_env("TRACING_SAMPLE_RATE", "1.0")),
        help="head-sampling rate for exported spans: 1.0 records every "
        "request, 0.01 one in a hundred; the datastore_latency "
        "aggregation is never sampled",
    )
    p.add_argument(
        "--metric-labels", default=_env("METRIC_LABELS"),
        help="CEL map literal evaluated per request for extra prometheus "
        "labels, e.g. \"{'tenant': descriptors[0].tenant}\"",
    )
    p.add_argument(
        "--metric-labels-file", default=_env("METRIC_LABELS_FILE"),
        help="file holding the CEL label map; watched and hot-reloaded "
        "(label NAMES are fixed at startup, value expressions may change)",
    )
    p.add_argument(
        "--metrics-exemplars", choices=["on", "off"],
        default=_env("TPU_METRICS_EXEMPLARS", "off"),
        help="attach trace-id exemplars to tail-bucket datastore-latency "
        "observations and render /metrics in the OpenMetrics exposition; "
        "off keeps the text 0.0.4 exposition",
    )
    p.add_argument(
        "--grpc-reflection-service", action="store_true",
        help="ignored; reflection is always on (accepted so that the JAX "
        "server's command lines parse)",
    )
    p.add_argument(
        "--validate", action="store_true",
        help="validate the limits file and exit",
    )
    p.add_argument(
        "--structured-logs", action="store_true",
        default=_env("STRUCTURED_LOGS", "") == "1",
        help="emit structured JSON log lines",
    )
    p.add_argument(
        "--log-level",
        default=_env("LIMITADOR_LOG", _env("RUST_LOG", "info")),
        help="log level: trace|debug|info|warn|error",
    )
    p.add_argument(
        "--limits-poll-interval", type=_positive_interval,
        default=_positive_interval(_env("LIMITS_FILE_POLL_INTERVAL", "1.0")),
        help="limits/labels file change-poll interval in seconds, > 0",
    )
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the torch storage keeps its table (default: cuda)",
    )
    p.add_argument(
        "--capacity", type=int, default=1 << 20,
        help="device counter-table capacity (torch; sharded: per shard)",
    )
    p.add_argument(
        "--kernel-cache-dir", default=_env("TPU_KERNEL_CACHE_DIR", ""),
        help="directory the CUDA kernels and the C++ host libraries are "
        "built into and loaded from (the port's stand-in for "
        "--xla-cache-dir): builds outlive the process, so that a warm "
        "standby or any restarted host loads what an earlier process "
        "built; empty (default) = the package's own _build directory",
    )
    p.add_argument(
        "--global-namespaces", default=_env("GLOBAL_NAMESPACES"),
        help="sharded: comma-separated namespaces whose counters are "
        "counted as per-shard partials read as their sum (one budget "
        "over all shards)",
    )
    p.add_argument(
        "--global-region", type=int,
        default=int(_env("GLOBAL_REGION", "1024")),
        help="sharded: per-shard slots reserved for global counters",
    )
    p.add_argument(
        "--batch-delay-us", type=int, default=500,
        help="micro-batcher linger in microseconds (torch)",
    )
    p.add_argument(
        "--dispatch-chunk", type=_dispatch_chunk,
        default=_dispatch_chunk(_env("TPU_DISPATCH_CHUNK", "auto")),
        help="torch and sharded: hits per pipelined launch; a flush "
        "splits into chunks so that a request's device round trip is its "
        "chunk's, not the whole batch's. 'auto' (default) sizes chunks "
        "from the observed device time per hit against the 2ms budget; "
        "'off'/0 launches each flush whole; N pins the chunk size",
    )
    p.add_argument(
        "--rate-limit-headers", default=RATE_LIMIT_HEADERS_NONE,
        choices=[RATE_LIMIT_HEADERS_NONE, RATE_LIMIT_HEADERS_DRAFT03],
    )
    p.add_argument(
        "--pipeline", choices=["standard", "compiled", "native"],
        default="standard",
        help="torch request path: per-request CEL (standard), "
        "batch-compiled vectorized masks (compiled), or the C++ columnar "
        "host lane for ShouldRateLimit (native)",
    )
    p.add_argument(
        "--plan-cache-size", type=int, default=1 << 16,
        help="hot-descriptor decision-plan cache entries per pipeline "
        "(0 disables; the native hot lane needs it)",
    )
    p.add_argument(
        "--native-hot-lane", choices=["on", "off"], default="on",
        help="zero-Python hot lane for the native pipeline (C-side mirror "
        "of the decision-plan cache); 'off' serves the pure-Python cached "
        "lane, byte-identical decisions",
    )
    p.add_argument(
        "--native-ingress",
        action="store_true",
        default=_env("TPU_NATIVE_INGRESS", "") == "1",
        help="serve ShouldRateLimit through the vendored C++ HTTP/2 "
        "ingress on --rls-port (requires torch storage, --pipeline "
        "native, headers NONE); the Python gRPC server (Kuadrant + Envoy "
        "with headers) moves to --rls-port + 1",
    )
    p.add_argument(
        "--lease-mode", choices=["on", "off"], default="off",
        help="quota-leasing edge tier (needs --pipeline native with the "
        "hot lane); credits settle through the B4c kernel",
    )
    p.add_argument(
        "--lease-max-tokens", type=int, default=1024,
        help="per-lease token cap",
    )
    p.add_argument(
        "--usage-topk", type=int, default=64,
        help="heavy-hitter slots drained per pass by the tenant usage "
        "observatory (torch storage; 0 disables it)",
    )
    p.add_argument(
        "--usage-drain-interval", type=float, default=1.0,
        help="seconds between heavy-hitter accumulator drains",
    )
    p.add_argument(
        "--usage-near-threshold", type=float, default=0.9,
        help="value/max_value utilization at which a sampled counter "
        "counts as near exhaustion",
    )
    p.add_argument(
        "--cache-size", type=int, default=None,
        help="qualified-counter cache cap (memory and torch; with "
        "--tier-mode on, the device hot set's size)",
    )
    p.add_argument(
        "--tier-mode", choices=["on", "off"],
        default=_env("TPU_TIER_MODE", "off"),
        help="torch: on = tiered counter storage: the device table "
        "serves the resident hot set, LRU evictions demote their exact "
        "cell to a host cold tier, cold keys decide exactly on the host, "
        "and a TierManager thread migrates counters on observed heat. "
        "off (default) = single-tier",
    )
    p.add_argument(
        "--tier-cold", default=_env("TPU_TIER_COLD", ""),
        help="tiered: path of the cold tier's append-log disk spill "
        "(JSON lines, absolute cell state, last-row-wins; empty = no "
        "disk spill)",
    )
    p.add_argument(
        "--tier-migrate-interval", type=float,
        default=float(_env("TPU_TIER_MIGRATE_INTERVAL", "2.0")),
        help="tiered: seconds between TierManager migration rounds",
    )
    p.add_argument(
        "--snapshot-path", default=_env("TPU_SNAPSHOT_PATH"),
        help="torch: periodically checkpoint the counter table here and "
        "restore from it on startup",
    )
    p.add_argument(
        "--snapshot-period", type=float,
        default=float(_env("TPU_SNAPSHOT_PERIOD", "30")),
        help="torch: seconds between counter-table checkpoints",
    )
    p.add_argument(
        "--peer", action="append", default=None,
        help="torch: peer replication address (repeatable); enables the "
        "replicated device-table topology. distributed: a peer the "
        "gossip broker dials",
    )
    p.add_argument("--node-id", default=_env("NODE_ID"))
    p.add_argument(
        "--listen-address", default=_env("LISTEN_ADDRESS"),
        help="torch: replication listen address (enables the replicated "
        "topology; default 0.0.0.0:5001 when only --peer is given). "
        "distributed: the gossip broker's address (default 0.0.0.0:5001)",
    )
    p.add_argument(
        "--profile-dir",
        default=_env("TPU_PROFILE_DIR", default_profile_dir()),
        help="default directory of on-demand torch.profiler captures "
        "(POST /debug/profile may name another per capture); a directory "
        "that cannot be written fails the capture's start",
    )
    p.add_argument(
        "--native-trace-sample", type=int,
        default=int(_env("TPU_NATIVE_TRACE_SAMPLE", "0")),
        help="torch: stamp 1 in N hot-lane begins with a native trace id "
        "so that OTLP device batch spans carry the C-side phase splits "
        "(0 = off, the default)",
    )
    p.add_argument(
        "--native-slow-row-us", type=float,
        default=float(_env("TPU_NATIVE_SLOW_ROW_US", "50")),
        help="torch: slow-row exemplar threshold of the native telemetry "
        "plane: a hot-lane begin averaging more than this many "
        "microseconds a row records its native phase split and "
        "descriptor digest into the flight recorder (0 disables "
        "exemplars; histograms stay on)",
    )
    p.add_argument(
        "--slo-budget-ms", type=float,
        default=float(_env("TPU_SLO_BUDGET_MS", "2.0")),
        help="torch: decision-latency SLO budget the burn-rate watchdog "
        "tracks at p99 over 5m/1h windows (slo_* gauges, /debug/stats "
        "slo section)",
    )
    p.add_argument(
        "--model-fit", choices=["on", "off"],
        default=_env("TPU_MODEL_FIT", "on"),
        help="online serving-model fit from the recorder's per-batch "
        "telemetry (model_*/capacity_* gauges, GET /debug/capacity, the "
        "model_r2/capacity_headroom_ratio/model_drift signals, the tier "
        "manager's pricing); 'off' detaches the ingest tap",
    )
    p.add_argument(
        "--flight", choices=["on", "off"],
        default=_env("TPU_FLIGHT", "on"),
        help="process flight recorder: sampled decision exemplars and "
        "worst-K tails per lane, and a trigger thread (SLO burn, drift, "
        "device_backed falling, manual POST /debug/flight/trigger) "
        "writing incident bundles (GET /debug/flight)",
    )
    p.add_argument(
        "--flight-sample", type=int,
        default=int(_env("TPU_FLIGHT_SAMPLE", "64")),
        help="flight recorder exemplar sampling stride: 1 in N decisions "
        "rings its stage breakdown (worst-K tails are kept regardless; 1 "
        "records every decision)",
    )
    p.add_argument(
        "--flight-spool-dir",
        default=_env("TPU_FLIGHT_SPOOL",
                     os.path.join(tempfile.gettempdir(), "limitador-flight")),
        help="retention-capped directory incident bundles are written to "
        "(self-contained JSON, served back at GET /debug/flight); one "
        "that cannot be created or written exits 2",
    )
    p.add_argument(
        "--flight-window", type=float,
        default=float(_env("TPU_FLIGHT_WINDOW_S", "10.0")),
        help="seconds of exemplar and signal history a bundle freezes",
    )
    p.add_argument(
        "--flight-profile-s", type=float,
        default=float(_env("TPU_FLIGHT_PROFILE_S", "0.0")),
        help="bounded torch.profiler capture a bundle carries, in seconds "
        "(0 = off for automatic fires; a manual trigger asks for one per "
        "request and gets one only when this is above 0)",
    )
    p.add_argument(
        "--authority-listen", default=_env("AUTHORITY_LISTEN"),
        help="serve this process's counter storage as a shared authority "
        "for remote write-behind replicas (the out-of-process Redis role), "
        "e.g. 0.0.0.0:5101; a storage without apply_deltas (cached, "
        "distributed) exits 2",
    )
    p.add_argument(
        "--authority-url", default=_env("AUTHORITY_URL"),
        help="cached: flush write-behind deltas to a remote authority "
        "(host:port of another server's --authority-listen) instead of a "
        "local disk store; any other storage exits 2",
    )
    p.add_argument(
        "--batch-size", type=int,
        default=int(_env("REDIS_LOCAL_CACHE_BATCH_SIZE", "100")),
        help="cached: max deltas per authority flush (default 100)",
    )
    p.add_argument(
        "--flush-period", type=float,
        default=float(_env("REDIS_LOCAL_CACHE_FLUSHING_PERIOD_MS", "1000")),
        help="cached: write-behind flush period in MILLISECONDS, the unit "
        "of the flag's env var (default 1000)",
    )
    p.add_argument(
        "--max-cached", type=int, default=int(_env("MAX_CACHED", "10000")),
        help="cached: max locally cached counters (default 10000)",
    )
    p.add_argument(
        "--response-timeout", type=float,
        default=float(_env("RESPONSE_TIMEOUT", "350")),
        help="cached: remote-authority response timeout in MILLISECONDS "
        "(default 350); applies with --authority-url",
    )
    p.add_argument(
        "--disk-path", default=_env("DISK_PATH"),
        help="disk, and cached without --authority-url: the SQLite file "
        "(default limitador_counters.db); one that cannot be opened "
        "exits 2",
    )
    p.add_argument(
        "--advertise-address", default=_env("ADVERTISE_ADDRESS"),
        help="address advertised to peers in gossip Hello/Membership "
        "packets (defaults to --listen-address; set it when binding "
        "0.0.0.0 so that peers learn a dialable URL)",
    )
    # admission plane (admission/controller.py)
    p.add_argument(
        "--admission-mode",
        choices=["off", "monitor", "enforce"],
        default=_env("ADMISSION_MODE", "off"),
        help="admission plane: off (default), monitor (breaker/failover "
        "active, sheds counted but not enforced), enforce (deadline/"
        "overload sheds enforced); needs torch or sharded storage (a "
        "host storage exits 2)",
    )
    p.add_argument(
        "--breaker-failures", type=int,
        default=int(_env("BREAKER_FAILURES", "3")),
        help="consecutive device-batch failures that open the "
        "device-plane circuit breaker",
    )
    p.add_argument(
        "--breaker-stall-ms", type=float,
        default=float(_env("BREAKER_STALL_MS", "2000")),
        help="an in-flight device batch older than this trips the "
        "breaker (the hung device-sync failure mode)",
    )
    p.add_argument(
        "--breaker-reset-ms", type=float,
        default=float(_env("BREAKER_RESET_MS", "5000")),
        help="open-state dwell before a half-open device probe",
    )
    p.add_argument(
        "--max-inflight", type=int,
        default=int(_env("ADMISSION_MAX_INFLIGHT", "4096")),
        help="hard ceiling of the adaptive (AIMD) concurrency limit",
    )
    p.add_argument(
        "--admission-target-queue-ms", type=float,
        default=float(_env("ADMISSION_TARGET_QUEUE_MS", "20")),
        help="queue-wait target the AIMD limit steers toward; also the "
        "basis of deadline-aware shedding",
    )
    p.add_argument(
        "--shed-response",
        choices=["unavailable", "overlimit"],
        default=_env("SHED_RESPONSE", "unavailable"),
        help="RLS semantics of a shed: unavailable (gRPC UNAVAILABLE / "
        "HTTP 503, Envoy failure-mode decides) or overlimit "
        "(OVER_LIMIT / 429)",
    )
    p.add_argument(
        "--priority-key", default=_env("PRIORITY_KEY", "priority"),
        help="descriptor entry key carrying a request's priority class "
        "(low|normal|high|critical)",
    )
    p.add_argument(
        "--priority", action="append", default=None,
        help="namespace priority mapping NS=CLASS (repeatable); limits-"
        "file `priority:` annotations and the descriptor entry override "
        "per request",
    )
    # the capacity controller (control/): one model-based loop over
    # admission, shedding, chunking, lease sizing and pod membership
    p.add_argument(
        "--capacity-controller", choices=["on", "off", "observe"],
        default=_env("TPU_CTL_MODE", "off"),
        help="self-driving capacity: one model-based controller jointly "
        "actuates the admission AIMD ceiling, the shed priority floor, "
        "the ChunkPlanner target, the lease grant scale and pod "
        "membership (warm-standby join on sustained burn, tail-host "
        "drain on sustained idle). observe = compute and log every "
        "decision without actuating; off (default) = controller not "
        "constructed",
    )
    p.add_argument(
        "--ctl-interval", type=float,
        default=float(_env("TPU_CTL_INTERVAL_S", "1.0")),
        help="controller: seconds between control ticks",
    )
    p.add_argument(
        "--ctl-sustain", type=float,
        default=float(_env("TPU_CTL_SUSTAIN_S", "5.0")),
        help="controller: a membership proposal must hold its "
        "hysteresis band this long before actuating (leaving the "
        "band resets the clock)",
    )
    p.add_argument(
        "--ctl-dwell", type=float,
        default=float(_env("TPU_CTL_DWELL_S", "30.0")),
        help="controller: minimum seconds between membership "
        "actuations (with --ctl-sustain, what keeps diurnal ramps "
        "from flapping topology)",
    )
    p.add_argument(
        "--ctl-standby", default=_env("TPU_CTL_STANDBY", ""),
        help="controller: comma-separated peer-lane addresses of warm "
        "standbys (--standby on processes) the controller may promote "
        "on sustained burn; empty = membership grows unavailable; needs "
        "a resize-armed pod member (exits 2 otherwise)",
    )
    p.add_argument(
        "--ctl-min-hosts", type=int,
        default=int(_env("TPU_CTL_MIN_HOSTS", "1")),
        help="controller: never drain the pod below this many hosts",
    )
    p.add_argument(
        "--ctl-max-hosts", type=int,
        default=int(_env("TPU_CTL_MAX_HOSTS", "8")),
        help="controller: never grow the pod above this many hosts "
        "(below --ctl-min-hosts exits 2)",
    )
    p.add_argument(
        "--ctl-grow-headroom", type=float,
        default=float(_env("TPU_CTL_GROW_HEADROOM", "1.2")),
        help="controller: propose add_host while the model's capacity "
        "headroom ratio stays below this band",
    )
    p.add_argument(
        "--ctl-shrink-headroom", type=float,
        default=float(_env("TPU_CTL_SHRINK_HEADROOM", "3.0")),
        help="controller: propose drain_host while the headroom ratio "
        "stays above this band (the dead band between the two absorbs "
        "ramps)",
    )
    p.add_argument(
        "--serving-shards", type=int,
        default=int(_env("SERVING_SHARDS", "1")),
        help="number of RLS gRPC serving loops: each extra shard is a "
        "thread with its own event loop and its own server on the SAME "
        "port (SO_REUSEPORT), all feeding the shared device table "
        "(1 = single loop; a shard that cannot bind exits 2)",
    )
    # the pod: TCPStore formation + shard-aware routed serving
    p.add_argument(
        "--pod-coordinator", default=_env("TPU_POD_COORDINATOR"),
        help="pod: TCPStore coordinator address (host:port) served by "
        "process 0; required when --pod-processes > 1",
    )
    p.add_argument(
        "--pod-processes", type=int,
        default=int(_env("TPU_POD_PROCESSES", "1")),
        help="pod: total number of pod processes (hosts); 1 = no pod "
        "(the default single-host topology)",
    )
    p.add_argument(
        "--pod-process-id", type=int,
        default=int(_env("TPU_POD_PROCESS_ID", "0")),
        help="pod: this process's id in [0, --pod-processes)",
    )
    p.add_argument(
        "--pod-peer", action="append", default=None,
        help="pod: peer-lane address of each pod process in process-id "
        "order, repeatable (env TPU_POD_PEERS, comma separated); a "
        "descriptor owned by another host is forwarded once over this "
        "lane",
    )
    p.add_argument(
        "--pod-peer-listen", default=_env("TPU_POD_PEER_LISTEN"),
        help="pod: bind address of this host's peer lane "
        "(default --rls-host:<rls-port + 2>)",
    )
    p.add_argument(
        "--pod-degraded-mode", choices=["on", "off"],
        default=_env("TPU_POD_DEGRADED_MODE", "on"),
        help="pod: on (default) = forward failures feed a per-peer "
        "breaker and fail over to a local exact stand-in that journals "
        "deltas for replay on recovery (plus one jittered retry for "
        "suspect peers); off = a peer failure fails that request "
        "(UNAVAILABLE/500)",
    )
    p.add_argument(
        "--pod-hedge-ms", type=float,
        default=float(_env("TPU_POD_HEDGE_MS", "0")),
        help="pod: >0 enables hedged forwards: when an in-flight "
        "forward outlasts max(this floor, the tracked peer p99) a "
        "second attempt races it on a fresh channel; 0 (default) "
        "disables hedging",
    )
    p.add_argument(
        "--pod-peer-breaker-failures", type=int,
        default=int(_env("TPU_POD_PEER_BREAKER_FAILURES", "3")),
        help="pod: consecutive forward failures that open a peer's "
        "failover breaker",
    )
    p.add_argument(
        "--pod-peer-breaker-reset-ms", type=float,
        default=float(_env("TPU_POD_PEER_BREAKER_RESET_MS", "2000")),
        help="pod: ms an open peer breaker dwells before recovery "
        "probes may close it",
    )
    p.add_argument(
        "--pod-events", type=int,
        default=int(_env("TPU_POD_EVENTS", "512")),
        help="pod: capacity of the typed pod event ring served at "
        "GET /debug/events (per-kind counts export as "
        "pod_events_total regardless of ring size)",
    )
    p.add_argument(
        "--pod-psum-lane", choices=["on", "off"],
        default=_env("TPU_POD_PSUM_LANE", "off"),
        help="pod: on = fixed-window --global-namespaces limits are "
        "decided LOCALLY on every host against lockstep-exchanged "
        "remote partials instead of pinning the whole namespace to one "
        "host; over-admission is bounded by one exchange interval per "
        "remote host. off (default) = exact namespace pinning. Every "
        "pod host must agree on this flag (the exchange is collective)",
    )
    p.add_argument(
        "--pod-psum-interval-ms", type=float,
        default=float(_env("TPU_POD_PSUM_INTERVAL_MS", "250")),
        help="pod: pacing of the lockstep psum exchange rounds (also "
        "the over-admission bound's time constant)",
    )
    p.add_argument(
        "--pod-resize", choices=["on", "off"],
        default=_env("TPU_POD_RESIZE", "off"),
        help="pod: on = arm the elastic-membership plane: forwards carry "
        "the topology epoch (wrong-epoch forwards are rejected "
        "rerouteable), the migrate and resize lane kinds serve, and "
        "POST /debug/pod/resize drives a live resize or drain with "
        "slice-by-slice migration and no lost update (an abort reverts "
        "to the old topology). off (default) = no epoch on the wire",
    )
    p.add_argument(
        "--standby", choices=["on", "off"],
        default=_env("TPU_POD_STANDBY", "off"),
        help="pod: on = boot as a warm standby: serve the peer lane "
        "memberless, run the decision kernels once at each hit bucket, "
        "and wait for a coordinator's join (POST /debug/pod/join on any "
        "member promotes this host). off (default) = no join kinds armed",
    )
    return p


#: the storages that keep their counters on the card (torch, sharded);
#: the rest keep them in host memory
DEVICE_STORAGES = ("torch", "sharded")

#: the host storages that can serve --authority-listen (apply_deltas)
_AUTHORITY_HOSTS = ("memory", "disk")


def _replicated(args) -> bool:
    """A replicated device-table node: ``--peer``/``--listen-address`` on
    torch storage (on ``distributed`` they belong to its broker)."""
    return args.storage != "distributed" and bool(
        args.peer or args.listen_address)


def _preserve_rejected_snapshot(path: str) -> None:
    """A checkpoint that could not be restored is moved aside, not left
    in place: the fresh table's periodic snapshot would overwrite it."""
    rejected = path + ".rejected"
    try:
        os.replace(path, rejected)
        log.warning(f"preserved rejected snapshot as {rejected}")
    except OSError as exc:
        log.warning(f"could not preserve rejected snapshot: {exc}")


def _read_checkpoint(cls, path: str, tiers: bool) -> Optional[dict]:
    """The checkpoint at ``path``, or None when it cannot be read (then
    it is moved aside and the server starts with a fresh table). A tiered
    checkpoint without ``--tier-mode on`` raises ValueError and stays
    where it is: loading it would drop its cold counters' spent quota."""
    try:
        data = cls.read_snapshot(path)
    except Exception as exc:
        log.warning(f"snapshot {path} unreadable ({exc}); starting with a "
                    f"fresh counter table")
        _preserve_rejected_snapshot(path)
        return None
    cold = data.get("table", {}).get("cold")
    if cold and not tiers:
        raise ValueError(
            f"snapshot {path} holds {len(cold)} cold-tier counters: "
            "restore it with --tier-mode on on a single node (the file "
            "is left in place)"
        )
    return data


def build_storage(args, clock=time.time):
    """The torch counter storage the options ask for: a replicated node
    (``--peer``/``--listen-address``, with a snapshot loaded into it
    before its broker starts), a table restored from ``--snapshot-path``,
    or a fresh ``TorchStorage`` (a ``TieredStorage`` with ``--tier-mode
    on``). Refuses the native pipeline, leases and tiers on a replicated
    node before anything starts."""
    from ..device import TorchStorage

    if _replicated(args):
        if args.tier_mode == "on":
            raise ValueError(
                "--tier-mode on needs a single-node torch storage: a "
                "replicated node (--peer/--listen-address) has no cold tier"
            )
        if args.pipeline == "native" or args.lease_mode == "on":
            raise ValueError(
                "--pipeline native and --lease-mode on launch the plain "
                "check kernel, which does not fold the gossiped remote "
                "counts into admission: they cannot run on a replicated "
                "node (--peer/--listen-address)"
            )
        from ..device.replicated import TorchReplicatedStorage

        # The constructor owns the broker wiring, so the checkpoint loads
        # into the instance (restoring a plain TorchStorage would drop the
        # node out of the gossip mesh), and before the broker starts, so
        # that peers' re-syncs merge into the loaded slot table.
        storage = TorchReplicatedStorage(
            node_id=args.node_id or "node",
            listen_address=args.listen_address or "0.0.0.0:5001",
            advertise_address=args.advertise_address,
            peers=args.peer or [],
            capacity=args.capacity,
            cache_size=args.cache_size,
            clock=clock,
            device=args.device,
            start=False,
        )
        path = args.snapshot_path
        if path and os.path.exists(path) and \
                _read_checkpoint(TorchStorage, path, tiers=False) is not None:
            try:
                storage.load_snapshot(path)
            except StorageError as exc:
                log.warning(f"snapshot {path} not restored ({exc}); "
                            f"starting with a fresh replicated table")
                _preserve_rejected_snapshot(path)
            else:
                log.info(f"restored replicated counter table from {path}")
        storage.start()
        return storage
    cls, extra = TorchStorage, {}
    if args.tier_mode == "on":
        from ..tier import TieredStorage

        cls, extra = TieredStorage, {"spill_path": args.tier_cold or None}
    path = args.snapshot_path
    data = None
    if path and os.path.exists(path):
        data = _read_checkpoint(cls, path, tiers=args.tier_mode == "on")
    if data is not None:
        # Outside the reader's guard: a device that fails while the
        # checkpoint loads stops the server instead of dropping the counts.
        storage = cls.from_snapshot(data, cache_size=args.cache_size,
                                    clock=clock, device=args.device, **extra)
        log.info(f"restored counter table from {path}")
        if storage._capacity != args.capacity:
            log.warning(f"snapshot capacity {storage._capacity} "
                        f"overrides --capacity {args.capacity}")
        return storage
    return cls(capacity=args.capacity, cache_size=args.cache_size,
               clock=clock, device=args.device, **extra)


def _sharded_refusals(args) -> None:
    """What sharded storage cannot run: the JAX server warns and serves
    something else for each of these; the port exits 2."""
    if args.pipeline == "native":
        raise ValueError(
            "--pipeline native needs torch storage: the C++ hot lane stages "
            "one table, not the sharded rows (use --pipeline compiled)")
    if args.tier_mode == "on":
        raise ValueError("--tier-mode on needs torch storage: the sharded "
                         "table has no cold tier")
    if args.lease_mode == "on":
        raise ValueError("--lease-mode on needs torch storage with "
                         "--pipeline native")
    if _replicated(args):
        raise ValueError("--peer and --listen-address need torch storage: "
                         "a sharded table is not a replicated node")


def build_sharded_storage(args, clock=time.time):
    """The ``TorchShardedStorage`` the options ask for: one row per
    visible card (one on the CPU), restored from ``--snapshot-path``
    when a checkpoint is there (its capacity, region and namespaces
    override the command line's, with a warning)."""
    import torch

    from ..device.sharded import TorchShardedStorage

    n_shards = torch.cuda.device_count() if args.device == "cuda" else 1
    cli_ns = {ns for ns in (args.global_namespaces or "").split(",") if ns}
    path = args.snapshot_path
    data = None
    if path and os.path.exists(path):
        data = _read_checkpoint(TorchShardedStorage, path, tiers=False)
    if data is None:
        storage = TorchShardedStorage(
            n_shards=n_shards, local_capacity=args.capacity,
            cache_size=args.cache_size, global_namespaces=sorted(cli_ns),
            global_region=args.global_region, clock=clock,
            device=args.device,
        )
        if getattr(args, "_pod_snapshot_base", None):
            # no checkpoint of this member's current shard range (a first
            # start, or the membership changed since): seed what it owns
            # now from its siblings' checkpoints
            _seed_from_sibling_snapshots(
                storage, args._pod_snapshot_base, args._pod_owned_shards,
                args._pod_total_shards, clock)
    else:
        storage = TorchShardedStorage.from_snapshot(
            data, n_shards=n_shards, cache_size=args.cache_size,
            clock=clock, device=args.device)
        log.info(f"restored sharded counter table from {path}")
        for name, cli, snap in (
                ("--capacity", args.capacity, storage._local_capacity),
                ("--global-region", args.global_region,
                 storage._global_region),
                ("--global-namespaces", cli_ns, storage._global_ns)):
            if cli != snap:
                log.warning(f"warning: snapshot {name}={snap!r} overrides "
                            f"the command line's {cli!r} (key routing "
                            "must match the checkpoint)")
    if getattr(args, "_pod_snapshot_meta", None):
        storage.snapshot_meta = args._pod_snapshot_meta
    return storage


def _seed_from_sibling_snapshots(storage, base, owned, total_shards,
                                 clock=time.time) -> int:
    """The slice-mapped restore after a membership change: decode every
    sibling checkpoint (``BASE.shards<lo>-<hi>`` and the legacy
    ``BASE.host<id>``) and seed only the counters this host owns under
    the current topology through ``apply_deltas`` (B7c's host form):
    fresh windows, exact spends. Each counter seeds from one file, the
    newest that holds it. Returns the number of counters seeded."""
    import glob

    from ..device.sharded import snapshot_items
    from ..routing import counter_key, stable_hash

    lo, hi = owned
    files = sorted(
        set(glob.glob(base + ".shards*") + glob.glob(base + ".host*"))
    )
    files = [f for f in files
             if not (f.endswith(".rejected") or f.endswith(".tmp"))]
    files.sort(key=lambda f: os.path.getmtime(f), reverse=True)
    seeded = 0
    seen = set()
    for path in files:
        try:
            items = snapshot_items(path, clock=clock)
        except Exception as exc:
            log.warning(f"pod: sibling snapshot {path} undecodable "
                        f"({exc}); skipped")
            continue
        mine = []
        for counter, value in items:
            key = counter_key(counter)
            if key in seen:
                continue
            if lo <= stable_hash(key) % total_shards < hi:
                seen.add(key)
                mine.append((counter, value))
        if not mine:
            continue
        try:
            storage.apply_deltas(mine)
            seeded += len(mine)
        except Exception as exc:
            log.warning(f"pod: seeding from {path} failed: {exc}")
    if seeded:
        log.info(f"pod: slice-mapped restore seeded {seeded} owned "
                 f"counters from {len(files)} sibling checkpoint(s)")
    return seeded


def _host_refusals(args) -> None:
    """What the host-memory storages cannot run (exit 2): the device
    pipelines, tiers, snapshots and a replicated node; and the
    write-behind options on the wrong storage."""
    if args.authority_url and args.storage != "cached":
        raise ValueError(
            f"--authority-url only applies to the 'cached' storage (got "
            f"{args.storage!r}); run the replica as: ... cached "
            "--authority-url HOST:PORT")
    if args.authority_listen and args.storage not in (
            DEVICE_STORAGES + _AUTHORITY_HOSTS):
        raise ValueError(
            f"--authority-listen: storage {args.storage!r} cannot act as "
            "a shared authority (no apply_deltas)")
    if args.storage in DEVICE_STORAGES:
        return
    if args.admission_mode != "off":
        raise ValueError(
            f"--admission-mode {args.admission_mode} needs torch or "
            f"sharded storage (got {args.storage!r}): a host storage has "
            "no device plane to guard or fail over from")
    if args.pipeline != "standard":
        raise ValueError(f"--pipeline {args.pipeline} needs torch storage")
    if _replicated(args) or args.snapshot_path:
        raise ValueError(
            "--peer, --listen-address and --snapshot-path need torch "
            "storage (--peer and --listen-address also serve distributed)"
        )
    if args.tier_mode == "on":
        raise ValueError("--tier-mode on needs torch storage")


def build_host_storage(args, clock=time.time, on_partitioned=None):
    """The host-memory counter storage the options ask for (memory,
    disk, cached or distributed), as the JAX server builds it. A
    ``--disk-path`` that cannot be opened raises StorageError."""
    if args.storage == "memory":
        return InMemoryStorage(args.cache_size or DEFAULT_CACHE_SIZE,
                               clock=clock)
    if args.storage in ("disk", "cached"):
        from ..storage.disk import DiskStorage
    if args.storage == "disk":
        return DiskStorage(args.disk_path or "limitador_counters.db",
                           clock=clock)
    if args.storage == "cached":
        from ..storage.cached import CachedCounterStorage

        if args.authority_url:
            from ..storage.authority import RemoteAuthority

            authority = RemoteAuthority(
                args.authority_url, timeout=args.response_timeout / 1000.0)
        else:
            authority = DiskStorage(args.disk_path or "limitador_counters.db",
                                    clock=clock)
        return CachedCounterStorage(
            authority,
            flush_period=args.flush_period / 1000.0,
            batch_size=args.batch_size,
            max_cached=args.max_cached,
            clock=clock,
            on_partitioned=on_partitioned,
        )
    from ..storage.distributed import CrInMemoryStorage

    return CrInMemoryStorage(
        node_id=args.node_id or "node",
        listen_address=args.listen_address or "0.0.0.0:5001",
        advertise_address=args.advertise_address,
        peers=args.peer or [],
        clock=clock,
    )


def build_limiter(args, clock=time.time, on_partitioned=None):
    """The limiter the server decides with. ``on_partitioned`` reaches a
    cached storage (the ``datastore_partitioned`` gauge)."""
    _host_refusals(args)
    if args.storage not in DEVICE_STORAGES:
        storage = build_host_storage(args, clock, on_partitioned)
        if args.storage == "cached":
            return AsyncRateLimiter(storage)
        return RateLimiter(storage)
    from ..device import AsyncTorchStorage

    if args.storage == "sharded":
        _sharded_refusals(args)
        storage = build_sharded_storage(args, clock)
    else:
        storage = build_storage(args, clock)
    async_storage = AsyncTorchStorage(
        storage, max_delay=args.batch_delay_us / 1e6,
        dispatch_chunk=args.dispatch_chunk,
    )
    if args.pipeline in ("compiled", "native"):
        from ..device.pipeline import CompiledTorchLimiter

        return CompiledTorchLimiter(
            async_storage, plan_cache_size=args.plan_cache_size,
            dispatch_chunk=args.dispatch_chunk,
        )
    return AsyncRateLimiter(async_storage)


def _pod_peers(args) -> list:
    return args.pod_peer or [
        u for u in (_env("TPU_POD_PEERS") or "").split(",") if u
    ]


def _pod_refusals(args) -> None:
    """Check the pod options with the JAX server's messages, and refuse
    what a pod member cannot serve; raises ValueError (exit 2) before
    any store is formed or storage built."""
    if args.pod_processes > 1 and not args.pod_coordinator:
        raise ValueError(
            "--pod-processes > 1 requires --pod-coordinator "
            "(env TPU_POD_COORDINATOR)"
        )
    if not (0 <= args.pod_process_id < args.pod_processes):
        raise ValueError(
            f"--pod-process-id {args.pod_process_id} outside "
            f"[0, {args.pod_processes})"
        )
    if args.standby == "on":
        if args.pod_processes > 1:
            raise ValueError(
                "--standby on: this process already formed a pod (a "
                "member is not a standby)"
            )
        if args.storage in ("cached", "distributed"):
            raise ValueError(
                f"storage {args.storage!r} cannot serve a pod: a member's "
                "storage must take a peer's journal replay (apply_deltas)"
            )
    elif args.pod_resize == "on" and args.pod_processes <= 1:
        raise ValueError(
            "--pod-resize on needs a pod (--pod-processes > 1) or "
            "--standby on"
        )
    if args.pod_processes <= 1:
        return
    peers = _pod_peers(args)
    if len(peers) != args.pod_processes:
        raise ValueError(
            f"pod: need one --pod-peer per process "
            f"({args.pod_processes}), got {len(peers)}"
        )
    if args.storage in ("cached", "distributed"):
        raise ValueError(
            f"storage {args.storage!r} cannot serve a pod: a member's "
            "storage must take a peer's journal replay (apply_deltas)"
        )


def form_pod(args):
    """Form the pod the options ask for over a TCPStore at
    ``--pod-coordinator`` (``parallel/pod.py``), before any storage is
    built, and give a member its per-shard-range snapshot path; returns
    its ``PodInfo``, or None without pod options. Each process owns one
    shard a visible card (one on the CPU)."""
    if not (args.pod_processes > 1 or args.pod_coordinator):
        return None
    import torch

    from ..parallel.pod import initialize_pod

    local = (max(torch.cuda.device_count(), 1)
             if args.device == "cuda" else 1)
    pod = initialize_pod(
        args.pod_coordinator, args.pod_processes, args.pod_process_id,
        local_device_count=local,
    )
    log.info(
        f"pod formed: process {pod.process_id}/{pod.num_processes}, "
        f"{pod.local_device_count} local of {pod.global_device_count} "
        "global shards")
    if args.snapshot_path:
        # A member checkpoints its own shard range and restores only it;
        # after a membership change that file is missing, and a sharded
        # member seeds what it owns now from its siblings' checkpoints
        # (``_seed_from_sibling_snapshots``).
        sph = max(pod.local_device_count, 1)
        lo = pod.process_id * sph
        args._pod_snapshot_base = args.snapshot_path
        args._pod_owned_shards = (lo, lo + sph)
        args._pod_total_shards = pod.num_processes * sph
        args._pod_snapshot_meta = {
            "owned_shards": [lo, lo + sph],
            "topology": {
                "hosts": pod.num_processes,
                "host_id": pod.process_id,
                "shards_per_host": sph,
                "total_shards": pod.num_processes * sph,
            },
        }
        args.snapshot_path = f"{args.snapshot_path}.shards{lo}-{lo + sph}"
        log.info(f"pod: per-shard-range snapshot path {args.snapshot_path}")
    return pod


def build_pod_frontend(args, pod, limiter):
    """Wrap ``limiter`` in the pod's routed frontend (and attach the
    psum lane with ``--pod-psum-lane on``) for a pod of more than one
    process, else None. The peer lane is started by the caller once the
    first limits are loaded."""
    if pod is None or pod.num_processes <= 1:
        return None
    from ..routing import PodRouter, PodTopology
    from .peering import PeerLane, PodFrontend, PodResilience

    peer_urls = _pod_peers(args)
    # --pod-degraded-mode off: no retry, no breaker or failover (a peer
    # failure fails that request); hedging stays its own option.
    degraded = args.pod_degraded_mode == "on"
    resilience = PodResilience(
        degraded=degraded,
        retry=degraded,
        hedge_ms=max(args.pod_hedge_ms, 0.0),
        breaker_failures=args.pod_peer_breaker_failures,
        breaker_reset_s=args.pod_peer_breaker_reset_ms / 1e3,
        probe_interval_s=float(_env("TPU_POD_PROBE_MS", "500")) / 1e3,
    )
    lane = PeerLane(
        pod.process_id,
        args.pod_peer_listen or f"{args.rls_host}:{args.rls_port + 2}",
        {i: url for i, url in enumerate(peer_urls)
         if i != pod.process_id},
        None,
        resilience=resilience,
    )
    router = PodRouter(PodTopology(
        hosts=pod.num_processes,
        host_id=pod.process_id,
        shards_per_host=max(pod.local_device_count, 1),
    ))
    global_ns = {
        ns for ns in (args.global_namespaces or "").split(",") if ns
    }
    frontend = PodFrontend(
        limiter, router, lane, global_namespaces=global_ns,
        resilience=resilience, events_capacity=max(args.pod_events, 1),
    )
    sph = router.topology.shards_per_host
    log.info(
        f"pod routed ingress: host {pod.process_id} owns global shards "
        f"[{pod.process_id * sph}, {(pod.process_id + 1) * sph}); "
        f"degraded-owner failover {'on' if degraded else 'off'}, hedge "
        f"{resilience.hedge_ms:.0f}ms, breaker "
        f"{resilience.breaker_failures} failures / "
        f"{resilience.breaker_reset_s * 1e3:.0f}ms reset")
    if args.pod_psum_lane == "on" and global_ns:
        # Attached before the first limits load, so that configure_with
        # claims the namespaces on the first apply.
        from ..parallel.pod import PodPsumLane

        psum_lane = PodPsumLane(pod.num_processes, pod.process_id)
        frontend.attach_psum_lane(psum_lane)
        interval_ms = max(args.pod_psum_interval_ms, 10.0)
        psum_lane.start(interval_s=interval_ms / 1e3)
        log.info(f"pod psum lane: lockstep exchange every "
                 f"{interval_ms:.0f}ms (global namespaces: "
                 f"{sorted(global_ns)})")
    if args.pod_resize == "on":
        # Inert until POST /debug/pod/resize (or a peer's proposal)
        # drives a transition, but forwards carry the topology epoch and
        # the wrong-owner gate serves from now on.
        from .resize import PodResizeCoordinator

        coordinator = PodResizeCoordinator(
            frontend,
            peers={i: url for i, url in enumerate(peer_urls)},
            listen_address=peer_urls[pod.process_id],
            slice_pause_s=float(
                _env("TPU_POD_RESIZE_SLICE_PAUSE_MS", "0") or 0) / 1e3,
            transition_timeout_s=float(
                _env("TPU_POD_RESIZE_TIMEOUT_S", "60") or 60),
        )
        frontend.attach_resize(coordinator)
        log.info("elastic pod armed: POST /debug/pod/resize drives a live "
                 "resize or drain (topology epoch "
                 f"{frontend.router.topology_epoch})")
    return frontend


def build_standby_frontend(args, limiter):
    """With ``--standby on``: wrap ``limiter`` in a memberless pod
    frontend (host 0 of a provisional pod of one, its peer lane on
    ``--pod-peer-listen``, default ``--rls-host``:``--rls-port`` + 2) with
    a resize coordinator and the WarmStandby that arms the join kinds;
    the caller warms it. Else None."""
    if args.standby != "on":
        return None
    from ..routing import PodRouter, PodTopology
    from .peering import PeerLane, PodFrontend, PodResilience
    from .resize import PodResizeCoordinator
    from .standby import WarmStandby

    degraded = args.pod_degraded_mode == "on"
    resilience = PodResilience(
        degraded=degraded,
        retry=degraded,
        hedge_ms=max(args.pod_hedge_ms, 0.0),
        breaker_failures=args.pod_peer_breaker_failures,
        breaker_reset_s=args.pod_peer_breaker_reset_ms / 1e3,
        probe_interval_s=float(_env("TPU_POD_PROBE_MS", "500")) / 1e3,
    )
    listen = args.pod_peer_listen or f"{args.rls_host}:{args.rls_port + 2}"
    lane = PeerLane(0, listen, {}, None, resilience=resilience)
    frontend = PodFrontend(
        limiter, PodRouter(PodTopology(hosts=1, host_id=0,
                                       shards_per_host=1)),
        lane,
        global_namespaces={
            ns for ns in (args.global_namespaces or "").split(",") if ns},
        resilience=resilience, events_capacity=max(args.pod_events, 1),
    )
    coordinator = PodResizeCoordinator(
        frontend, peers={}, listen_address=listen,
        transition_timeout_s=float(
            _env("TPU_POD_RESIZE_TIMEOUT_S", "60") or 60),
    )
    frontend.attach_resize(coordinator)
    WarmStandby(
        frontend, coordinator,
        table_capacity=(args.capacity if args.storage in DEVICE_STORAGES
                        else None),
        device=args.device if args.storage in DEVICE_STORAGES else "cpu",
    )
    return frontend


def arm_kernel_cache(args) -> None:
    """``--kernel-cache-dir``: build the CUDA kernels and the C++ host
    libraries into (and load them from) the directory, before any build.
    Raises ValueError where it cannot be created."""
    if not args.kernel_cache_dir:
        return
    from ..native import build as native_build
    from ..ops import build as kernel_build

    try:
        os.makedirs(args.kernel_cache_dir, exist_ok=True)
    except OSError as exc:
        raise ValueError(
            f"--kernel-cache-dir {args.kernel_cache_dir}: {exc}") from exc
    kernel_build.set_build_dir(args.kernel_cache_dir)
    native_build.set_build_dir(args.kernel_cache_dir)
    log.info(f"kernel build cache: {args.kernel_cache_dir}")


def serve_shards(args, limiter, metrics, native_pipeline, admission,
                 port: int) -> list:
    """The ``--serving-shards`` - 1 extra serving loops on
    ``--rls-host:port``. Raises ValueError (after stopping the shards
    already up) when one cannot bind."""
    from .rls import RlsServingShard

    shards = []
    for i in range(1, args.serving_shards):
        try:
            shards.append(RlsServingShard(
                i, limiter, f"{args.rls_host}:{port}", metrics,
                args.rate_limit_headers, native_pipeline=native_pipeline,
                admission=admission,
            ))
        except RuntimeError as exc:
            for shard in shards:
                shard.stop(0.0)
            raise ValueError(
                f"--serving-shards {args.serving_shards}: {exc}"
            ) from exc
    if shards:
        log.info(f"serving shards: {1 + len(shards)} event loops on port "
                 f"{port}")
    return shards


def _pod_native_capable(args) -> bool:
    """Whether a pod member can serve ``--pipeline native``: the
    shard-aware hot lane is the only native plane that classifies
    foreign-owned keys, so it needs ``--native-hot-lane on``, the plan
    cache the lane mirrors, and a pod the int8 owner encoding holds.
    Anything less warns and serves through the routed compiled
    pipeline, with the JAX server's messages. (A host lane that does not
    build raises where the pipeline is built: no hidden CPU path.)"""
    from .. import native as native_mod

    if args.native_hot_lane != "on":
        log.warning(
            "pod mode: --native-hot-lane off leaves the native pipeline "
            "without the shard-aware lane; serving through the routed "
            "compiled pipeline")
        return False
    if args.plan_cache_size <= 0:
        log.warning(
            "pod mode: --plan-cache-size 0 disables the plan mirror "
            "the shard-aware lane rides; serving through the routed "
            "compiled pipeline")
        return False
    if args.pod_processes - 1 > 127 - native_mod.LANE_FOREIGN_BASE:
        log.warning(
            f"pod mode: {args.pod_processes} hosts exceed the native "
            "lane's int8 owner encoding (max "
            f"{128 - native_mod.LANE_FOREIGN_BASE}); serving through "
            "the routed compiled pipeline")
        return False
    return True


async def _discard_pipeline(pipeline):
    """Dispose of a built native pipeline a pod member will not serve:
    its constructor wired eviction hooks on the live table (left
    attached they would call an abandoned native context on every slot
    release) and started its thread pools. Returns None."""
    table = pipeline.storage._table
    table.on_native_release = None
    table.on_slot_release = None
    table.on_clear = None
    await pipeline.close()
    return None


async def attach_pod_pipeline(frontend, pipeline):
    """Arm the native pod fast path (``PodFrontend.attach_pipeline``):
    the pipeline, or None where it cannot split (the JAX server's warning;
    the member serves through the routed compiled pipeline, which still
    decides on the card)."""
    try:
        frontend.attach_pipeline(pipeline)
    except RuntimeError as exc:
        log.warning(f"pod mode: cannot arm the hot lane ({exc}); serving "
                    "through the routed compiled pipeline")
        return await _discard_pipeline(pipeline)
    log.info("pod fast path: shard-aware native hot lane on "
             "(foreign-owned rows bulk-forward per flush)")
    return pipeline


def build_native(args, limiter, metrics=None, pod=None):
    """The native pipeline (with its lease tier) when asked for, counting
    its rows into ``metrics``, else None; a pod member (``pod``, its
    frontend) that cannot serve it gets None (``_pod_native_capable``).
    Raises when what was asked for cannot come up."""
    if args.lease_mode == "on" and (
        args.pipeline != "native" or args.native_hot_lane != "on"
    ):
        raise ValueError(
            "--lease-mode on needs --pipeline native --native-hot-lane on"
        )
    if args.pipeline != "native":
        return None
    if pod is not None and not _pod_native_capable(args):
        return None
    if args.rate_limit_headers != RATE_LIMIT_HEADERS_NONE:
        raise ValueError(
            "--pipeline native answers ShouldRateLimit without headers: "
            "it needs --rate-limit-headers NONE"
        )
    if args.native_hot_lane == "on" and args.plan_cache_size <= 0:
        raise ValueError(
            "--native-hot-lane on mirrors the plan cache: "
            "--plan-cache-size must be > 0"
        )
    from ..device.native_pipeline import NativeRlsPipeline

    pipeline = NativeRlsPipeline(
        limiter, metrics, max_delay=args.batch_delay_us / 1e6,
        plan_cache_size=args.plan_cache_size,
        hot_lane=args.native_hot_lane == "on",
        dispatch_chunk=args.dispatch_chunk,
    )
    if args.lease_mode == "on":
        from ..lease import LeaseConfig

        pipeline.attach_lease(
            LeaseConfig(max_tokens=args.lease_max_tokens), autostart=False
        )
    return pipeline


class Checkpointer:
    """Periodic counter-table checkpoints (``--snapshot-path``): every
    ``period`` seconds on an executor thread, and once more at shutdown.
    Each write goes to ``path + ".tmp"`` and replaces ``path``; a mutex
    keeps a periodic and the final write from sharing the tmp file. A
    failed checkpoint is logged and the next period tries again."""

    def __init__(self, storage, path: str, period: float):
        self.storage = storage
        self.path = path
        self.period = period
        self._mutex = threading.Lock()
        self._task = None

    def take(self) -> None:
        with self._mutex:
            tmp = self.path + ".tmp"
            self.storage.snapshot(tmp)
            os.replace(tmp, self.path)

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.period)
            try:
                await loop.run_in_executor(None, self.take)
            except Exception as exc:
                log.warning(f"snapshot failed: {exc}")

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        """Cancel the loop, wait out an in-flight write, take the final
        checkpoint."""
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        try:
            await asyncio.get_running_loop().run_in_executor(None, self.take)
        except Exception as exc:
            log.warning(f"final snapshot failed: {exc}")


class RunningServer:
    """A started server: its limiter, gRPC and HTTP servers, metrics and
    limits watcher, and the native pipeline, usage observatory, tier
    manager, checkpointer, labels watcher, native telemetry plane and
    control planes when they run."""

    def __init__(self, limiter, rls_server, watcher, status,
                 native_pipeline=None, observatory=None, checkpointer=None,
                 tier_manager=None, http_runner=None, metrics=None,
                 labels_watcher=None, native_plane=None, profiler=None,
                 planes=None, authority=None, admission=None,
                 native_ingress=None, pod=None, serving_shards=(),
                 controller=None):
        self.limiter = limiter
        self.rls_server = rls_server
        self.watcher = watcher
        #: limits_file_version / limits_file_errors
        self.status = status
        self.native_pipeline = native_pipeline
        self.observatory = observatory
        self.checkpointer = checkpointer
        self.tier_manager = tier_manager
        #: the HTTP API's aiohttp runner
        self.http_runner = http_runner
        #: the PrometheusMetrics behind /metrics
        self.metrics = metrics
        self.labels_watcher = labels_watcher
        #: the NativePlane (native telemetry and the SLO watchdog; torch
        #: storage only)
        self.native_plane = native_plane
        #: the TorchProfiler behind /debug/profile
        self.profiler = profiler
        #: the control planes (signal bus, serving-model estimator,
        #: flight trigger engine) and what they are attached to
        self.planes = planes or ControlPlanes()
        #: the AuthorityServer of ``--authority-listen``, or None
        self.authority = authority
        #: the AdmissionController (``--admission-mode`` monitor or
        #: enforce), or None
        self.admission = admission
        #: the NativeIngress of ``--native-ingress`` on ``--rls-port``
        #: (the gRPC server is then on ``--rls-port`` + 1), or None
        self.native_ingress = native_ingress
        #: the PodFrontend of a pod member (also ``limiter``), or None
        self.pod = pod
        #: the RlsServingShards of ``--serving-shards``
        self.serving_shards = list(serving_shards)
        #: the CapacityController of ``--capacity-controller`` observe or
        #: on, or None
        self.controller = controller

    @property
    def signal_bus(self):
        return self.planes.signal_bus

    @property
    def model_estimator(self):
        return self.planes.estimator

    @property
    def flight_engine(self):
        return self.planes.engine

    @property
    def storage(self):
        """The device counter storage (``TorchStorage``,
        ``TorchReplicatedStorage`` or ``TorchShardedStorage``), or None on
        a host storage."""
        counters = self.limiter.storage.counters
        return getattr(counters, "inner", None)

    async def stop(self) -> None:
        if self.controller is not None:
            # First: nothing may actuate (or propose a resize) into the
            # subsystems that stop behind it. Off the loop: the close
            # joins the cadence thread.
            await asyncio.get_running_loop().run_in_executor(
                None, self.controller.close)
        self.watcher.stop()
        if self.labels_watcher is not None:
            self.labels_watcher.stop()
        if self.tier_manager is not None:
            self.tier_manager.close()
        # Off the loop: a bundle being written may wait on the loop for
        # its profiler capture to stop.
        await asyncio.get_running_loop().run_in_executor(
            None, self.planes.stop)
        if self.native_ingress is not None:
            # Off the loop: close joins the pump, whose slow rows and
            # handlers may still be answering through the loop.
            await asyncio.get_running_loop().run_in_executor(
                None, self.native_ingress.close)
        for shard in self.serving_shards:
            # Off the loop: a shard's stop waits for its sync server and
            # joins its loop thread.
            await asyncio.get_running_loop().run_in_executor(
                None, shard.stop, 1.0)
        await self.rls_server.stop(grace=1.0)
        await self.http_runner.cleanup()
        if self.authority is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self.authority.stop)
        if self.checkpointer is not None:
            await self.checkpointer.stop()
        await _close(self.limiter, self.native_pipeline, self.observatory,
                     self.native_plane, self.admission)


class ControlPlanes:
    """The control planes a server wires: the signal bus (with the usage
    observatory), the process serving-model estimator (``--model-fit``)
    and the flight recorder with its trigger engine (``--flight``).
    ``build`` makes them and hangs their taps on the recorder, the tiered
    storage and the observatory, ``start`` starts the trigger thread, and
    ``stop`` stops it and takes every tap off again (the estimator is
    process-wide and outlives the server)."""

    def __init__(self):
        self.signal_bus = None
        self.estimator = None
        self.engine = None
        self._context = None
        self._recorder = None
        self._tiers = None
        self._observatory = None
        self._pod = None

    def debug_sources(self) -> list:
        return [x for x in (self.signal_bus, self.estimator, self.engine)
                if x is not None]

    def build(self, args, limiter, native_pipeline, observatory,
              native_plane, metrics, profiler, admission=None,
              pod=None) -> None:
        """Make the planes the options ask for and attach their taps;
        on a pod member (``pod``, its PodFrontend) the pod's event log
        reaches the estimator and the trigger engine, the flight
        recorder taps the pod's lanes and the signal bus joins the
        federated view. Raises ValueError where ``--flight-spool-dir``
        cannot be created or written."""
        from ..observability.flight import (
            BundleSpool,
            FlightRecorder,
            TriggerEngine,
        )
        from ..observability.signals import SignalBus

        counters = limiter.storage.counters
        recorder = (getattr(limiter, "recorder", None)
                    or getattr(counters, "recorder", None))
        self._recorder = recorder
        self._observatory = observatory
        self._pod = pod
        if observatory is not None:
            bus = self.signal_bus = SignalBus()
            bus.warm()  # the calibration probe, off the serving threads
            if recorder is not None:
                bus.attach_recorder(recorder)
            if native_pipeline is not None:
                bus.attach_pipeline(native_pipeline)
            if native_plane is not None:
                bus.attach_native_plane(native_plane)
            if admission is not None:
                bus.attach_admission(admission)
            bus.attach_observatory(observatory)
            observatory.signal_bus = bus
            metrics.attach_render_hook(bus)
            if pod is not None:
                pod.attach_signal_bus(bus)
        if args.model_fit == "on" and recorder is not None:
            est = self.estimator = model_mod.process_estimator()
            est.budget_ms = args.slo_budget_ms
            recorder.model = est
            self._context = model_mod.pipeline_context(
                pipeline=native_pipeline, pod=pod, storage=counters.inner)
            est.attach_context(self._context)
            if pod is not None:
                est.attach_event_log(pod.events)
            if self.signal_bus is not None:
                self.signal_bus.attach_model(est)
            if observatory is not None:
                observatory.model = est
            metrics.attach_render_hook(est)
        if args.flight == "on":
            spool_dir = args.flight_spool_dir
            try:
                spool = BundleSpool(spool_dir)
            except OSError as exc:
                raise ValueError(
                    f"cannot use --flight-spool-dir {spool_dir}: {exc}"
                ) from exc
            if not os.access(spool_dir, os.W_OK | os.X_OK):
                raise ValueError(
                    f"--flight-spool-dir {spool_dir} is not writable")
            flight = FlightRecorder(sample_stride=max(args.flight_sample, 1))
            flight.trace_provider = tracing.current_trace_id
            if recorder is not None:
                recorder.flight_tap = flight
            if args.tier_mode == "on":  # a TieredStorage
                self._tiers = counters.inner
                self._tiers.flight_tap = flight
            if pod is not None:
                pod.attach_flight_recorder(flight)
            self.engine = TriggerEngine(
                flight, spool, signals=self.signal_bus,
                events=pod.events if pod is not None else None,
                lane=pod.lane if pod is not None else None,
                profiler=profiler if args.flight_profile_s > 0 else None,
                window_s=args.flight_window,
                profile_s=args.flight_profile_s,
            )
            metrics.attach_render_hook(flight)

    def start(self) -> None:
        if self.engine is not None:
            self.engine.start()

    def stop(self) -> None:
        engine = self.engine
        if engine is not None:
            engine.stop()
            if engine.is_alive():
                engine.join(timeout=15.0)
        rec = self._recorder
        if rec is not None:
            if engine is not None and rec.flight_tap is engine.recorder:
                rec.flight_tap = None
            if self.estimator is not None and rec.model is self.estimator:
                rec.model = None
        if self._tiers is not None:
            self._tiers.flight_tap = None
        obs = self._observatory
        if obs is not None:
            obs.signal_bus = None
            obs.model = None
        est = self.estimator
        if est is not None and est._context_fn is self._context:
            est.attach_context(None)
        if (est is not None and self._pod is not None
                and est._event_log is self._pod.events):
            est.attach_event_log(None)


async def _close(limiter, native_pipeline, observatory,
                 native_plane=None, admission=None) -> None:
    close_pod = getattr(limiter, "close_pod", None)  # a pod's frontend
    if close_pod is not None:
        # Off the loop: stopping the peer lane joins its thread.
        await asyncio.get_running_loop().run_in_executor(None, close_pod)
        limiter = limiter.wrapped
    if native_plane is not None:
        native_plane.close()
    if observatory is not None:
        observatory.close()
    if admission is not None:
        await admission.close()
    if native_pipeline is not None:
        await native_pipeline.close()
    if isinstance(limiter, AsyncRateLimiter):
        close = getattr(limiter, "close", None)
        if close is not None:
            await close()
        await limiter.storage.counters.close()
    else:
        # a disk file, a gossip broker
        limiter.storage.counters.close()


def build_metrics(args) -> PrometheusMetrics:
    """The server's metrics: limit names in the labels, the CEL label map
    (``--metric-labels-file``'s content, when not empty, wins over
    ``--metric-labels``) and exemplars as asked. A labels file that
    cannot be read or a map that does not parse raises ValueError."""
    labels = args.metric_labels
    if args.metric_labels_file:
        try:
            with open(args.metric_labels_file) as f:
                labels = f.read().strip() or labels
        except OSError as exc:
            raise ValueError(
                f"cannot read --metric-labels-file: {exc}"
            ) from exc
    metrics = PrometheusMetrics(
        use_limit_name_label=args.limit_name_in_labels,
        metric_labels=labels,
    )
    if args.metrics_exemplars == "on":
        metrics.enable_exemplars()
        # The OpenMetrics exposition must render before serving starts.
        metrics.render()
    return metrics


def _labels_watcher(args, metrics) -> Optional[LimitsFileWatcher]:
    """Watch ``--metric-labels-file`` and hot-swap the label values;
    a rejected map is logged and the previous one kept."""
    if not args.metric_labels_file:
        return None

    def load(path):
        with open(path) as f:
            return f.read().strip()

    def changed(content):
        if content:
            try:
                metrics.reload_labels(content)
            except (ValueError, CelError) as exc:
                log.warning(f"metric labels reload rejected: {exc}")
            else:
                log.info("metric labels reloaded")

    watcher = LimitsFileWatcher(
        args.metric_labels_file, changed,
        on_error=lambda exc: log.warning(
            f"metric labels file reload failed: {exc}"),
        poll_interval=args.limits_poll_interval, loader=load,
    )
    watcher.start()
    return watcher


def _wire_metrics(metrics, limiter, native_pipeline, observatory) -> None:
    """Attach the library sources and render hooks the server runs, and
    let the batched storage (or the compiled pipeline) time its own
    device round trips."""
    counters = limiter.storage.counters
    # The compiled pipeline aggregates its storage's stats and adds the
    # compiler's; otherwise the storage itself. A pod frontend adds the
    # pod's families to its limiter's stats, so the storage's are
    # attached beside it where that limiter has none.
    inner = getattr(limiter, "wrapped", limiter)
    if hasattr(limiter, "library_stats"):
        metrics.attach_library_source(limiter)
    if not hasattr(inner, "library_stats") and hasattr(
            counters, "library_stats"):
        metrics.attach_library_source(counters)
    for target in (limiter, counters):
        if hasattr(target, "set_metrics"):
            target.set_metrics(metrics)
            break
    if native_pipeline is not None:
        metrics.attach_library_source(native_pipeline)
    if observatory is not None:
        metrics.attach_render_hook(observatory)


def _native_plane(args, limiter, metrics):
    """Torch storage: arm the host lane's native telemetry plane and the
    SLO watchdog, feed the watchdog from the device-plane recorder (the
    compiled limiter's, else the storage's) and poll the plane on every
    metrics render. Raises when the host lane cannot be built."""
    if args.storage != "torch":
        return None
    from ..observability.native_plane import (
        NativePlane,
        device_backed_runtime,
    )

    counters = limiter.storage.counters
    plane = NativePlane(
        budget_ms=args.slo_budget_ms,
        slow_row_us=args.native_slow_row_us,
        trace_sample=args.native_trace_sample,
        recorder=(getattr(limiter, "recorder", None)
                  or getattr(counters, "recorder", None)),
        device_backed=device_backed_runtime(counters.inner),
    )
    metrics.attach_native_plane(plane)
    return plane


def _ingress_refusals(args) -> None:
    """What ``--native-ingress`` cannot run on (exit 2; the JAX server
    warns and serves Python gRPC alone)."""
    if not args.native_ingress:
        return
    if args.storage != "torch" or args.pipeline != "native":
        raise ValueError(
            "--native-ingress feeds the native pipeline: it needs torch "
            "storage with --pipeline native"
        )
    if args.rate_limit_headers != RATE_LIMIT_HEADERS_NONE:
        raise ValueError(
            "--native-ingress answers ShouldRateLimit without headers: it "
            "needs --rate-limit-headers NONE"
        )


async def serve_native_ingress(args, limiter, metrics, native_pipeline):
    """The native HTTP/2 ingress on ``--rls-host:--rls-port``: Envoy's
    ShouldRateLimit into the native pipeline, the Kuadrant methods and
    the reflection stream through the same ``RlsService`` and responder
    the gRPC server uses, its ``ingress_*`` counts polled by ``metrics``.
    Raises ``BuildError`` when the library does not build and
    ValueError when the address cannot be bound."""
    from ..native.ingress import NativeIngress, ingress_build_error
    from .reflection import REFLECTION_METHOD, native_reflection_handler
    from .rls import (
        _ENVOY_SERVICE,
        _KUADRANT_SERVICE,
        RlsService,
        make_native_method_handlers,
    )

    loop = asyncio.get_running_loop()
    error = await loop.run_in_executor(None, ingress_build_error)
    if error is not None:
        raise BuildError(f"--native-ingress: the ingress does not build: "
                         f"{error}")
    handlers = make_native_method_handlers(
        RlsService(limiter, metrics, args.rate_limit_headers))
    handlers[REFLECTION_METHOD] = native_reflection_handler(
        (_ENVOY_SERVICE, _KUADRANT_SERVICE))
    try:
        ingress = NativeIngress(
            native_pipeline, host=args.rls_host, port=args.rls_port,
            loop=loop, handlers=handlers, stream_path=REFLECTION_METHOD,
        )
    except OSError as exc:
        raise ValueError(
            f"cannot serve the native ingress on "
            f"{args.rls_host}:{args.rls_port}: {exc}"
        ) from exc
    metrics.attach_library_source(ingress)
    return ingress


def _warm_device(storage) -> float:
    """Build the storage's kernels and launch its check kernel once (one
    empty batch, as the breaker's probe does), so that neither the build
    nor the first load rides a batch the breaker watches. Returns the
    seconds it took."""
    from ..device.storage import _Request

    t0 = time.perf_counter()
    storage.check_many([_Request([], 0, False)])
    return time.perf_counter() - t0


def _controller_refusals(args) -> None:
    """Refuse a ``--capacity-controller`` that cannot come up as asked
    (ValueError, exit 2), before anything is built. The JAX server
    starts these and lets them do nothing (the host bounds widen to the
    minimum, a standby list without a resize coordinator is never
    read)."""
    if args.capacity_controller == "off":
        return
    if args.ctl_interval <= 0:
        raise ValueError(
            f"--ctl-interval {args.ctl_interval:g}: must be > 0")
    if args.ctl_min_hosts > args.ctl_max_hosts:
        raise ValueError(
            f"--ctl-min-hosts {args.ctl_min_hosts} above --ctl-max-hosts "
            f"{args.ctl_max_hosts}")
    if args.ctl_standby.strip() and not (
            args.pod_processes > 1 and args.pod_resize == "on"):
        raise ValueError(
            "--ctl-standby: only a resize-armed pod member "
            "(--pod-processes > 1 --pod-resize on) can promote a warm "
            "standby")


def build_controller(args, limiter, native_pipeline, admission, planes,
                     pod, metrics):
    """The capacity controller ``--capacity-controller`` asks for (not
    started), bound to every planner of the serving lanes (each batcher
    pair's, the compiled and the native pipeline's), the lease broker,
    the admission plane and a resize-armed pod's coordinator; None with
    ``off``, which imports nothing of ``control/``."""
    if args.capacity_controller == "off":
        return None
    from ..control import CapacityController, ModelPolicy, ServerActuator

    counters = limiter.storage.counters
    served = getattr(limiter, "wrapped", limiter)  # under a pod frontend

    def planners():
        out = []
        pairs = getattr(counters, "_batcher_pairs", None)
        if pairs is not None:
            out.extend(mb.chunk_planner for mb, _ub in pairs())
        for owner in (served, native_pipeline):
            planner = getattr(owner, "chunk_planner", None)
            if planner is not None:
                out.append(planner)
        return out

    coordinator = getattr(pod, "resize", None) if pod is not None else None
    actuator = ServerActuator(
        overload=admission.overload if admission is not None else None,
        admission=admission,
        planners=planners,
        broker=getattr(native_pipeline, "lease_broker", None),
        coordinator=coordinator,
        standby_addresses=[a.strip() for a in args.ctl_standby.split(",")
                           if a.strip()],
        min_hosts=args.ctl_min_hosts,
        max_hosts=args.ctl_max_hosts,
    )
    controller = CapacityController(
        actuator,
        policy=ModelPolicy(
            budget_ms=args.slo_budget_ms,
            grow_headroom=args.ctl_grow_headroom,
            shrink_headroom=args.ctl_shrink_headroom,
        ),
        signals=planes.signal_bus,
        estimator=planes.estimator,
        events=pod.events if pod is not None else None,
        mode=args.capacity_controller,
        interval_s=args.ctl_interval,
        sustain_s=args.ctl_sustain,
        dwell_s=args.ctl_dwell,
    )
    if planes.signal_bus is not None:
        planes.signal_bus.attach_controller(controller)
    metrics.attach_render_hook(controller)
    log.info(
        f"capacity controller "
        f"{'ON' if args.capacity_controller == 'on' else 'observing'}: "
        f"{len(actuator.specs())} knobs, membership "
        f"{'armed' if coordinator is not None else 'unavailable'}, "
        f"tick {args.ctl_interval:.1f}s, sustain {args.ctl_sustain:.0f}s, "
        f"dwell {args.ctl_dwell:.0f}s")
    return controller


async def build_admission(args, limiter, native_pipeline, metrics):
    """The admission controller ``--admission-mode`` asks for, bound to
    the batched storage with the pipelines as drainables and its watchdog
    started on the running loop, or None with ``off`` (the admission
    package is then not imported). The kernels are warmed first. A bad
    ``--priority`` mapping raises ValueError."""
    if args.admission_mode == "off":
        return None
    from ..admission import (
        AdaptiveLimiter,
        AdmissionController,
        CircuitBreaker,
        PriorityResolver,
    )

    priorities = PriorityResolver(
        descriptor_key=args.priority_key,
        namespace_map=PriorityResolver.parse_namespace_map(
            args.priority or ()),
    )
    counters = limiter.storage.counters
    loop = asyncio.get_running_loop()
    warm_s = await loop.run_in_executor(None, _warm_device, counters.inner)
    admission = AdmissionController(
        mode=args.admission_mode,
        metrics=metrics,
        breaker=CircuitBreaker(
            failure_threshold=args.breaker_failures,
            stall_timeout=args.breaker_stall_ms / 1000.0,
            reset_timeout=args.breaker_reset_ms / 1000.0,
        ),
        overload=AdaptiveLimiter(
            max_inflight=args.max_inflight,
            target_queue_wait=args.admission_target_queue_ms / 1000.0,
        ),
        priorities=priorities,
        shed_response=args.shed_response,
    )
    counters.set_admission(admission)
    for drainable in (limiter, native_pipeline):
        if hasattr(drainable, "fail_over_queued"):
            admission.add_drainable(drainable)
    admission.start(loop)
    log.info(
        f"admission plane: mode={args.admission_mode}, "
        f"max-inflight={args.max_inflight}, breaker "
        f"stall={args.breaker_stall_ms:.0f}ms/"
        f"reset={args.breaker_reset_ms:.0f}ms, "
        f"shed-response={args.shed_response}; kernels warmed in "
        f"{warm_s:.3f}s")
    return admission


async def start(args, clock=time.time, on_failure=None) -> RunningServer:
    """Configure span export, build the metrics and the limiter (and the
    native pipeline, lease tier, usage observatory and tier manager the
    options ask for), load the limits file, start watching it and start
    serving gRPC on ``--rls-host:--rls-port`` and HTTP on
    ``--http-host:--http-port``. A lease refresh, usage drain or
    migration round that fails stops its thread, which then calls
    ``on_failure(exc)``."""
    _ingress_refusals(args)
    _pod_refusals(args)
    _controller_refusals(args)
    arm_kernel_cache(args)
    tracing.configure_tracing(args.tracing_endpoint)
    tracing.set_sample_rate(args.tracing_sample_rate)
    # Before any recorder is made: a recorder arms its serving-model tap
    # at construction (set_metrics), so the flag wins over TPU_MODEL_FIT.
    model_mod.set_model_fit_enabled(args.model_fit == "on")
    metrics = build_metrics(args)
    install_metrics_layer()
    # The pod forms before any storage is built; its frontend wraps the
    # limiter before any consumer takes it, so that the RLS and HTTP
    # planes, the serving shards and the metrics see the routed surface.
    pod = await asyncio.get_running_loop().run_in_executor(
        None, form_pod, args)
    limiter = build_limiter(
        args, clock,
        on_partitioned=lambda v: metrics.datastore_partitioned.set(
            1 if v else 0))
    device = args.storage in DEVICE_STORAGES
    native_pipeline = observatory = native_plane = admission = None
    planes = ControlPlanes()
    profiler = TorchProfiler(
        args.profile_dir,
        cuda=device and args.device == "cuda",
        loop=asyncio.get_running_loop(),
    )
    pod_frontend = None
    try:
        pod_frontend = (build_pod_frontend(args, pod, limiter)
                        or build_standby_frontend(args, limiter))
        if pod_frontend is not None:
            limiter = pod_frontend
        native_pipeline = build_native(args, limiter, metrics,
                                       pod=pod_frontend)
        if pod_frontend is not None and native_pipeline is not None:
            native_pipeline = await attach_pod_pipeline(
                pod_frontend, native_pipeline)
        if pod_frontend is not None and pod_frontend.standby is not None:
            # the kernels' build and first launches, before the lane
            # serves: raises where a kernel cannot build or launch
            await asyncio.get_running_loop().run_in_executor(
                None, pod_frontend.standby.warm)
        if device and args.usage_topk > 0:
            from ..observability.usage import TenantUsageObservatory

            observatory = TenantUsageObservatory(
                limiter.storage.counters.inner,
                pipeline=native_pipeline,
                top_k=args.usage_topk,
                interval_s=args.usage_drain_interval,
                near_threshold=args.usage_near_threshold,
            )
        _wire_metrics(metrics, limiter, native_pipeline, observatory)
        native_plane = _native_plane(args, limiter, metrics)
        admission = await build_admission(args, limiter, native_pipeline,
                                          metrics)
        planes.build(args, limiter, native_pipeline, observatory,
                     native_plane, metrics, profiler, admission,
                     pod=pod_frontend)
        if pod_frontend is not None:
            counters = limiter.storage.counters
            recorder = (getattr(limiter, "recorder", None)
                        or getattr(counters, "recorder", None))
            if recorder is not None:
                pod_frontend.attach_flight(recorder)
            metrics.attach_render_hook(pod_frontend.hops)
    except BaseException:
        planes.stop()
        await _close(limiter, native_pipeline, observatory, native_plane,
                     admission)
        raise
    loop = asyncio.get_running_loop()
    status = {"limits_file_version": 0, "limits_file_errors": 0}

    async def apply_limits(limits):
        applied = limiter.configure_with(limits)
        if inspect.isawaitable(applied):
            await applied
        if native_pipeline is not None:
            native_pipeline.invalidate()
        if admission is not None:
            # namespace priorities from the limits' `priority:` entries
            admission.priorities.refresh(limits)

    def on_change(limits):
        status["limits_file_version"] += 1
        fut = asyncio.run_coroutine_threadsafe(apply_limits(limits), loop)

        def _applied(f):
            exc = f.exception()
            if exc is not None:
                # keep serving the previous config, count the error
                status["limits_file_errors"] += 1
                log.warning(f"limits reload rejected: {exc}")

        fut.add_done_callback(_applied)

    def on_error(exc):
        status["limits_file_errors"] += 1
        log.warning(f"limits file reload failed: {exc}")

    # The watcher captures its baseline stamp BEFORE the initial load, so
    # a file replaced between load and watch still triggers a reload.
    watcher = LimitsFileWatcher(args.limits_file, on_change, on_error,
                                poll_interval=args.limits_poll_interval)
    labels_watcher = rls_server = native_ingress = None
    serving_shards = []
    rls_grpc_port = args.rls_port
    try:
        await apply_limits(load_limits_file(args.limits_file))
        status["limits_file_version"] = 1
        watcher.start()
        if pod_frontend is not None:
            # Limits are loaded and the router configured: only now may
            # the lane answer forwarded decisions (until then a peer's
            # forward fails fast instead of deciding on no limits).
            lane = pod_frontend.lane
            try:
                await loop.run_in_executor(None, lane.start)
            except RuntimeError as exc:
                raise ValueError(
                    f"cannot serve the pod peer lane on "
                    f"{lane.listen_address}: {exc}") from exc
            log.info(f"pod peer lane serving on {lane.listen_address} "
                     f"(port {lane.port})")
        labels_watcher = _labels_watcher(args, metrics)
        if args.native_ingress:
            if native_pipeline is None:
                raise ValueError(
                    "--native-ingress feeds the native pipeline, which "
                    "this pod member does not serve (see the warning "
                    "above)")
            native_ingress = await serve_native_ingress(
                args, limiter, metrics, native_pipeline)
            rls_grpc_port = args.rls_port + 1
        rls_server = await serve_rls(
            limiter, f"{args.rls_host}:{rls_grpc_port}",
            args.rate_limit_headers, native_pipeline=native_pipeline,
            metrics=metrics, admission=admission,
        )
        serving_shards = await loop.run_in_executor(
            None, serve_shards, args, limiter, metrics, native_pipeline,
            admission, rls_grpc_port)
    except BaseException:
        if rls_server is not None:
            await rls_server.stop(grace=None)
        if native_ingress is not None:
            native_ingress.close()
        watcher.stop()
        if labels_watcher is not None:
            labels_watcher.stop()
        planes.stop()
        await _close(limiter, native_pipeline, observatory, native_plane,
                     admission)
        raise
    broker = getattr(native_pipeline, "lease_broker", None)
    tier_manager = None
    if args.storage == "torch" and args.tier_mode == "on":
        from ..tier import TierManager

        # Wired late so that it sees the lease broker (demotions settle
        # outstanding tokens first), the observatory (the demotion veto
        # of live slots) and the serving-model estimator (the pricing).
        # A pod member hands it the pod's event log; a server without
        # a pod hands it none, as the JAX server does.
        tier_manager = TierManager(
            limiter.storage.counters.inner, broker=broker,
            estimator=planes.estimator, observatory=observatory,
            events=pod_frontend.events if pod_frontend else None,
            interval_s=args.tier_migrate_interval,
        )
        metrics.attach_render_hook(tier_manager)
    # Wired last so that its actuator binds every live subsystem; started
    # once the HTTP API serves.
    controller = build_controller(args, limiter, native_pipeline, admission,
                                  planes, pod_frontend, metrics)
    authority = None
    try:
        if args.authority_listen:
            authority = _serve_authority(args, limiter)
        http_runner = await run_http_server(
            limiter, args.http_host, args.http_port, metrics, status,
            debug_sources=[s for s in (native_pipeline, native_plane,
                                       observatory)
                           if s is not None] + planes.debug_sources()
            + ([tier_manager] if tier_manager is not None else [])
            + ([controller] if controller is not None else [])
            + ([authority] if authority is not None else []),
            profiler=profiler, admission=admission,
        )
    except BaseException as exc:
        if authority is not None:
            authority.stop()
        for shard in serving_shards:
            shard.stop(0.0)
        if native_ingress is not None:
            native_ingress.close()
        watcher.stop()
        if labels_watcher is not None:
            labels_watcher.stop()
        planes.stop()
        await rls_server.stop(grace=None)
        await _close(limiter, native_pipeline, observatory, native_plane,
                     admission)
        if isinstance(exc, OSError):
            raise ValueError(
                f"cannot serve HTTP on {args.http_host}:{args.http_port}: "
                f"{exc}"
            ) from exc
        raise
    for tier in (broker, observatory, tier_manager):
        if tier is not None:
            tier.on_error = on_failure
            tier.start()
    planes.start()
    if controller is not None:
        controller.start()
    checkpointer = None
    if device and args.snapshot_path:
        checkpointer = Checkpointer(limiter.storage.counters.inner,
                                    args.snapshot_path, args.snapshot_period)
        checkpointer.start()
    return RunningServer(limiter, rls_server, watcher, status,
                         native_pipeline, observatory, checkpointer,
                         tier_manager, http_runner, metrics, labels_watcher,
                         native_plane, profiler, planes, authority,
                         admission, native_ingress, pod_frontend,
                         serving_shards, controller)


def _serve_authority(args, limiter):
    """Serve the limiter's counter storage (the table under the
    batcher on torch and sharded storage) as the shared authority on
    ``--authority-listen``. Raises StorageError where the address cannot
    be bound."""
    from ..storage.authority import serve_authority

    storage = limiter.storage.counters
    storage = getattr(storage, "inner", storage)
    authority = serve_authority(storage, args.authority_listen)
    log.info(f"shared authority on {args.authority_listen} (port "
             f"{authority.port})")
    return authority


async def _amain(args) -> int:
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    failures = []

    def on_failure(exc):
        failures.append(exc)
        loop.call_soon_threadsafe(stop.set)

    server = await start(args, on_failure=on_failure)
    ingress = server.native_ingress
    log.info(f"serving RLS gRPC on {args.rls_host}:"
             f"{args.rls_port + (1 if ingress is not None else 0)}"
             + (f", native HTTP/2 ingress on {args.rls_host}:{ingress.port}"
                if ingress is not None else "")
             + f" and HTTP on {args.http_host}:{args.http_port} "
             f"({args.storage} storage, {args.pipeline} pipeline"
             + (f", replicated node {args.node_id or 'node'} gossiping on "
                f"{args.listen_address or '0.0.0.0:5001'}"
                if args.storage == "torch" and _replicated(args) else "")
             + (", quota leases on" if args.lease_mode == "on" else "")
             + (f", tiered: device hot set over an exact host cold tier, "
                f"migration every {args.tier_migrate_interval:g}s"
                if server.tier_manager is not None else "")
             + (f", usage top-{args.usage_topk}"
                if server.observatory is not None else "")
             + (f", admission {args.admission_mode}"
                if server.admission is not None else "")
             + (f", capacity controller {args.capacity_controller}"
                if server.controller is not None else "")
             + (f", {args.serving_shards} serving loops"
                if server.serving_shards else "")
             + (f", warm standby, peer lane on port "
                f"{server.pod.lane.port}"
                if server.pod is not None and args.standby == "on"
                else f", pod host {args.pod_process_id} of "
                f"{args.pod_processes}, peer lane on port "
                f"{server.pod.lane.port}"
                if server.pod is not None else "")
             + ")")
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await server.stop()
    if failures:
        log.error(f"stopped: a background tier failed: {failures[0]!r}")
        return 1
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _setup_logging(args.structured_logs, args.log_level)
    if args.validate:
        try:
            limits = load_limits_file(args.limits_file)
        except LimitsFileError as exc:
            log.error(f"INVALID: {exc}")
            return 1
        # Success goes to stdout (a script-parseable contract, whatever
        # the log format); diagnostics go to the stderr log handler.
        print(f"OK: {len(limits)} limits")
        return 0
    if args.grpc_reflection_service:
        log.info("gRPC reflection is always served; "
                 "--grpc-reflection-service changes nothing")
    try:
        return asyncio.run(_amain(args))
    except KeyboardInterrupt:
        return 0
    except (ValueError, LimitsFileError, CelError, StorageError,
            BuildError, tracing.TracingError) as exc:
        log.error(f"configuration error: {exc}")
        return 2


if __name__ == "__main__":
    sys.exit(main())
