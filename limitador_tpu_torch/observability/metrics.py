"""Prometheus metrics.

Counterpart of ``limitador_tpu/observability/metrics.py`` (the
reference's prometheus_metrics.rs): counters ``authorized_calls`` /
``authorized_hits`` / ``limited_calls`` labeled by
``limitador_namespace`` (plus ``limitador_limit_name`` when enabled, and
the custom CEL labels of ``--metric-labels``), gauges ``limitador_up`` /
``datastore_partitioned``, histograms ``datastore_latency`` (the
MetricsLayer's span aggregate, seconds) and ``datastore_device_latency``
(the queue-excluded device batch round trip).

Families, names, help texts, types and buckets are the JAX package's.
Besides the reference families, this module declares those of the layers
the port has: the batchers and caches, CEL evaluation, the plan caches,
the native hot lane, quota leases, the per-shard device tables, the
usage observatory (``tenant_*``), the sharded table, the tiers, the
device-plane recorder (``batcher_queue_wait``,
``batcher_batch_fill_ratio``, ``batcher_flushes``,
``device_phase_latency``, ``dispatch_chunk_*``), the native telemetry
plane (``native_phase_*``), the SLO watchdog (``slo_*``,
``device_backed``), the control-signal bus (``signal_*``), the process
flight recorder (``flight_*``), the serving-model fit (``model_*``,
``capacity_*``) and the admission plane (``admission_*``, declared on
every server as in the JAX package, whatever ``--admission-mode``), and
the pod's (``pod_routed_*``, ``pod_peer_*``, ``peer_health_*``,
``pod_failover_*``, ``pod_hop_phase_ms``, ``pod_events``,
``pod_signal_*``, ``pod_psum_*``, and the native pod fast path's
``pod_hot_*`` and ``pod_bulk_*``, polled off the pod frontend's
``library_stats``; declared on every server as in the JAX package), the
elastic pod's (``pod_resize_*``, ``join_*``, ``standby_*``) and the
capacity controller's (``ctl_*``, fed by its render hook; declared on
every server as in the JAX package, whatever ``--capacity-controller``).
The native ingress's families (``ingress_*``, fed by its ``library_stats``
through ``attach_library_source``, and ``native_phase_h2i_respond``, fed
by the native plane) are declared on every server, as in the JAX
package.

``datastore_latency`` reads the MetricsLayer's two aggregates, as the JAX
server wires them (main.rs:908-917): ``install_metrics_layer`` installs
one process-wide layer whose consumer hands each aggregate to the
metrics of the server that handled the request (``bind_request_metrics``,
called by the gRPC service per request), so that several servers in one
process keep their own histograms.
"""

from __future__ import annotations

from contextvars import ContextVar
from typing import Optional

from prometheus_client import (
    CONTENT_TYPE_LATEST,
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)
from prometheus_client.openmetrics.exposition import (
    CONTENT_TYPE_LATEST as OPENMETRICS_CONTENT_TYPE,
)
from prometheus_client.openmetrics.exposition import (
    generate_latest as openmetrics_latest,
)

from .device_plane import BATCHERS, FLUSH_REASONS, PHASES, current_request_id
from .events import EVENT_KINDS
from .pod_plane import HOP_PHASES, POD_HOP_BUCKETS_MS
from .flight import TRIGGER_REASONS
from .metrics_layer import MetricsLayer, install, installed
from .model import ATTRIBUTION_STAGES, MODEL_TARGETS, MODEL_TERMS
from .native_plane import NATIVE_PHASE_BUCKETS
from .signals import _BREAKER_GAUGE, _PRIORITIES
from .signals import _PHASES as _SIGNAL_PHASES
from .tracing import current_trace_id

#: the admission plane's shed reasons, inlined (with the priority classes
#: and breaker states of ``signals``) so that a server without the plane
#: never imports the admission package for a schema; tests pin them to
#: ``admission.SHED_REASONS``
_SHED_REASONS = ("deadline", "overload", "controller")

__all__ = [
    "PrometheusMetrics",
    "bind_request_metrics",
    "install_metrics_layer",
]

#: the PrometheusMetrics of the server handling the current request
_request_metrics: ContextVar = ContextVar(
    "limitador_tpu_torch_request_metrics", default=None
)


def bind_request_metrics(metrics) -> None:
    """Route the MetricsLayer aggregates of the current request context
    to ``metrics``."""
    _request_metrics.set(metrics)


def _record_request_datastore_latency(timings) -> None:
    metrics = _request_metrics.get()
    if metrics is not None:
        metrics.record_datastore_latency(timings)


def install_metrics_layer() -> None:
    """Install the process-wide span-tree aggregation once: request-path
    ``datastore`` spans roll up under ``should_rate_limit``, write-behind
    I/O under ``flush_batcher_and_update_counters``, and each aggregate
    goes to the request's bound metrics."""
    if installed() is None:
        install(
            MetricsLayer()
            .gather("should_rate_limit", _record_request_datastore_latency,
                    ["datastore"])
            .gather("flush_batcher_and_update_counters",
                    _record_request_datastore_latency, ["datastore"])
        )


NAMESPACE_LABEL = "limitador_namespace"
LIMIT_NAME_LABEL = "limitador_limit_name"

#: cumulative library_stats counts fed to same-named counters as the
#: increment since the last render
_CUMULATIVE_KEYS = (
    "counter_overshoot",
    "evicted_pending_writes",
    "cel_vectorized_evals",
    "cel_fallback_evals",
    "plan_cache_hits",
    "plan_cache_misses",
    "plan_cache_evictions",
    "plan_cache_invalidations",
    "native_lane_rows",
    "native_lane_misses",
    "native_lane_staged_hits",
    "native_lane_invalidations",
    "native_lane_overflows",
    "lease_admissions",
    "lease_grants",
    "lease_grant_denials",
    "lease_granted_tokens",
    "lease_returned_tokens",
    "sharded_route_memo_hits",
    "sharded_route_memo_misses",
    "sharded_route_memo_evictions",
    "ingress_connections",
    "ingress_requests",
    "ingress_responses",
    "ingress_protocol_errors",
    "pod_routed_local",
    "pod_routed_forwarded",
    "pod_routed_pinned",
    "pod_peer_errors",
    "peer_health_retries",
    "peer_health_hedges_won",
    "peer_health_hedges_lost",
    "peer_health_redials",
    "peer_health_probes",
    "pod_failover_degraded_decisions",
    "pod_failover_reconciles",
    "pod_failover_replayed_deltas",
    "pod_signal_exchanges",
    "pod_psum_decisions",
    "pod_psum_limited",
    "pod_psum_exchanges",
    "pod_hot_local_rows",
    "pod_hot_foreign_rows",
    "pod_bulk_forward_batches",
    "pod_bulk_forward_rows",
    "pod_bulk_served_rows",
    "pod_resize_completed",
    "pod_resize_aborted",
    "pod_resize_slices_moved",
    "pod_resize_moved_deltas",
    "pod_resize_released_counters",
    "pod_resize_stale_rejects",
    "pod_resize_replans",
    "join_completed",
    "join_aborted",
    "join_seed_entries",
)

#: cumulative library_stats seconds fed to same-named counters as the
#: increment since the last render (no int truncation)
_CUMULATIVE_SECONDS = (
    "pod_failover_reconcile_seconds",
    "pod_failover_seconds",
    "pod_resize_seconds",
    "join_seconds",
)

#: the elastic pod's and the warm standby's levels, set as they are
_POD_GAUGES = (
    "pod_resize_epoch", "pod_resize_active", "join_ttfd_seconds",
    "standby_ready", "standby_warm_kernels", "standby_warm_seconds",
)

#: pod levels a render sums over sources, and those it takes the largest
#: of (the JAX render's aggregation)
_POD_SUMS = (
    "pod_failover_journal_depth", "pod_failover_breaker_open",
    "pod_psum_cells", "pod_psum_remote_slots",
)
_POD_MAXES = (
    "pod_peer_p99_ms", "pod_event_seq", "pod_signal_hosts",
    "pod_signal_age_s", "pod_psum_namespaces",
)


class PrometheusMetrics:
    def __init__(
        self,
        use_limit_name_label: bool = False,
        registry: Optional[CollectorRegistry] = None,
        metric_labels: Optional[str] = None,
    ):
        """``metric_labels`` is a CEL map expression evaluated against each
        request context to produce extra label values (the reference's
        --metric-labels-default, prometheus_metrics.rs:135-167). Label
        NAMES must be literal map keys (prometheus requires fixed names);
        values may be any CEL expression over the request."""
        self.registry = registry or CollectorRegistry()
        self.use_limit_name_label = use_limit_name_label
        self.labels_expr = None
        self.custom_label_names: list = []
        if metric_labels:
            self.labels_expr, self.custom_label_names = self._parse_labels(
                metric_labels
            )
        labels = [NAMESPACE_LABEL] + self.custom_label_names
        limited_labels = (
            [NAMESPACE_LABEL, LIMIT_NAME_LABEL]
            if use_limit_name_label
            else [NAMESPACE_LABEL]
        ) + self.custom_label_names
        self.authorized_calls = Counter(
            "authorized_calls", "Authorized calls", labels,
            registry=self.registry,
        )
        self.authorized_hits = Counter(
            "authorized_hits", "Authorized hits", labels,
            registry=self.registry,
        )
        self.limited_calls = Counter(
            "limited_calls", "Limited calls", limited_labels,
            registry=self.registry,
        )
        self.limitador_up = Gauge(
            "limitador_up", "Limitador is running", registry=self.registry
        )
        self.limitador_up.set(1)
        self.datastore_partitioned = Gauge(
            "datastore_partitioned",
            "Limitador is partitioned from backing datastore",
            registry=self.registry,
        )
        self.datastore_partitioned.set(0)
        self.datastore_latency = Histogram(
            "datastore_latency",
            "Latency to the underlying counter datastore",
            registry=self.registry,
            buckets=(
                0.0001, 0.00025, 0.0005, 0.001, 0.002, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
            ),
        )
        # Queue-excluded device batch round trip: the slice of
        # datastore_latency each batched request spent on the device.
        self.datastore_device_latency = Histogram(
            "datastore_device_latency",
            "Device batch round-trip latency (queue excluded)",
            registry=self.registry,
            buckets=(
                0.0001, 0.00025, 0.0005, 0.001, 0.002, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
            ),
        )
        # Library-side operational metrics (the reference's metrics-facade
        # gauges): polled from attached sources at render time.
        self.batcher_size = Gauge(
            "batcher_size", "Pending counter updates in the batcher",
            registry=self.registry,
        )
        self.cache_size = Gauge(
            "cache_size", "Locally cached counters",
            registry=self.registry,
        )
        self.batcher_flush_size = Histogram(
            "batcher_flush_size", "Counters per batcher flush",
            registry=self.registry,
            buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 10000),
        )
        # The write-behind cache's (storage/cached.py), from its
        # library_stats.
        self.counter_overshoot = Counter(
            "counter_overshoot",
            "Amount admitted beyond a limit due to write-behind staleness",
            registry=self.registry,
        )
        self.evicted_pending_writes = Counter(
            "evicted_pending_writes",
            "Counters evicted from the cache while holding unflushed deltas",
            registry=self.registry,
        )
        # The native C++ HTTP/2 ingress's health (cumulative in the C++
        # layer), from its library_stats.
        self.ingress_connections = Counter(
            "ingress_connections",
            "Connections accepted by the native C++ HTTP/2 ingress",
            registry=self.registry,
        )
        self.ingress_requests = Counter(
            "ingress_requests",
            "Requests taken off the native ingress",
            registry=self.registry,
        )
        self.ingress_responses = Counter(
            "ingress_responses",
            "Responses written by the native ingress",
            registry=self.registry,
        )
        self.ingress_protocol_errors = Counter(
            "ingress_protocol_errors",
            "HTTP/2 / gRPC framing errors on the native ingress",
            registry=self.registry,
        )
        self.cel_vectorized_evals = Counter(
            "cel_vectorized_evals",
            "(request, limit) evaluations served by the vectorized "
            "compiler",
            registry=self.registry,
        )
        self.cel_fallback_evals = Counter(
            "cel_fallback_evals",
            "(request, limit) evaluations that fell back to the CEL "
            "interpreter",
            registry=self.registry,
        )
        # -- device plane: the batchers' queues and the recorder's
        # families (device_plane.DeviceStatsRecorder), and the per-shard
        # device tables, polled from device_stats() sources at render
        # time.
        self.batcher_queue_depth = Gauge(
            "batcher_queue_depth",
            "Requests currently waiting in the micro-batcher queues",
            registry=self.registry,
        )
        self.batcher_queue_wait = Histogram(
            "batcher_queue_wait",
            "Seconds a request waited in the batcher queue before its "
            "batch flushed (linger included, device time excluded); "
            "batcher=check is the decision path, batcher=update the "
            "write-behind path",
            ["batcher"],
            registry=self.registry,
            buckets=(
                0.0001, 0.00025, 0.0005, 0.001, 0.002, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
            ),
        )
        self.batcher_batch_fill_ratio = Histogram(
            "batcher_batch_fill_ratio",
            "Flush occupancy as a fraction of the configured max batch "
            "(1.0 = size-triggered full batch), per batcher "
            "(check = decision path, update = write-behind path)",
            ["batcher"],
            registry=self.registry,
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
        )
        self.batcher_flushes = Counter(
            "batcher_flushes",
            "Batcher flushes by trigger: size (batch full), deadline "
            "(linger expired), shutdown (close drain); per batcher "
            "(check = decision path, update = write-behind path)",
            ["batcher", "reason"],
            registry=self.registry,
        )
        self.device_phase_latency = Histogram(
            "device_phase_latency",
            "Per-phase device batch breakdown: dispatch (executor "
            "handoff), host_stage (array build + kernel launch), "
            "device_sync (device round trip), unpack (decode + resolve)",
            ["phase"],
            registry=self.registry,
            buckets=(
                0.0001, 0.00025, 0.0005, 0.001, 0.002, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
            ),
        )
        # -- chunked dispatch (device/batcher.py ChunkPlanner): how
        # flushes split into pipelined launches.
        self.dispatch_chunk_hits = Histogram(
            "dispatch_chunk_hits",
            "Hits per dispatched sub-batch chunk (one kernel launch); "
            "monolithic flushes observe their full size once",
            registry=self.registry,
            buckets=(256, 512, 1024, 2048, 4096, 8192, 16384, 32768),
        )
        self.dispatch_chunk_splits = Histogram(
            "dispatch_chunk_splits",
            "Chunks a flush was split into (1 = monolithic dispatch)",
            registry=self.registry,
            buckets=(1, 2, 3, 4, 6, 8, 12, 16),
        )
        # -- admission plane (admission/): shed, breaker and failover
        # families, named in admission.METRIC_FAMILIES
        self.admission_inflight = Gauge(
            "admission_inflight",
            "Decisions currently holding an admission-plane slot",
            registry=self.registry,
        )
        self.admission_limit = Gauge(
            "admission_limit",
            "Current adaptive (AIMD) concurrency limit of the "
            "admission plane",
            registry=self.registry,
        )
        self.admission_sheds = Counter(
            "admission_sheds",
            "Requests shed before batch admission, by reason (deadline "
            "= request cannot survive the queue-wait estimate, overload "
            "= adaptive concurrency limit reached) and priority class",
            ["reason", "priority"],
            registry=self.registry,
        )
        self.admission_breaker_state = Gauge(
            "admission_breaker_state",
            "Device-plane circuit breaker state: 0 closed, 1 half-open, "
            "2 open (failed over to the host oracle)",
            registry=self.registry,
        )
        self.admission_breaker_transitions = Counter(
            "admission_breaker_transitions",
            "Device-plane breaker transitions, labeled by the state "
            "entered",
            ["state"],
            registry=self.registry,
        )
        self.admission_failover_decisions = Counter(
            "admission_failover_decisions",
            "Check-path decisions served by the host failover oracle "
            "while the device-plane breaker was open",
            registry=self.registry,
        )
        self.admission_failover_seconds = Counter(
            "admission_failover_seconds",
            "Cumulative seconds the device-plane breaker has spent "
            "away from closed (open + half-open)",
            registry=self.registry,
        )
        self.admission_reconciled_deltas = Counter(
            "admission_reconciled_deltas",
            "Host-journaled counter deltas replayed into the device "
            "table on breaker recovery (apply_deltas reconcile)",
            registry=self.registry,
        )
        self.counter_slots_used = Gauge(
            "counter_slots_used",
            "Occupied device counter-table slots, per shard",
            ["shard"],
            registry=self.registry,
        )
        self.counter_slots_capacity = Gauge(
            "counter_slots_capacity",
            "Device counter-table slot capacity, per shard",
            ["shard"],
            registry=self.registry,
        )
        self.counter_slot_evictions = Counter(
            "counter_slot_evictions",
            "Counters evicted from a full device table to make room, "
            "per shard",
            ["shard"],
            registry=self.registry,
        )
        self.counter_slot_collisions = Counter(
            "counter_slot_collisions",
            "Fresh allocations that recycled a previously-occupied "
            "device slot (stale cell overridden by the kernel's fresh "
            "flag), per shard",
            ["shard"],
            registry=self.registry,
        )
        # -- decision-plan caches (device/plan_cache.py): cumulative
        # counts from the pipelines' library_stats; size is a level.
        self.plan_cache_hits = Counter(
            "plan_cache_hits",
            "Requests served from a memoized decision plan (parse/CEL/"
            "slot hashing skipped)",
            registry=self.registry,
        )
        self.plan_cache_misses = Counter(
            "plan_cache_misses",
            "Requests that derived (and memoized) a fresh decision plan",
            registry=self.registry,
        )
        self.plan_cache_evictions = Counter(
            "plan_cache_evictions",
            "Decision plans evicted by the cache's LRU size cap",
            registry=self.registry,
        )
        self.plan_cache_invalidations = Counter(
            "plan_cache_invalidations",
            "Decision plans dropped for coherence: limits-epoch bumps "
            "(reload/add/update/delete) and device-slot recycling",
            registry=self.registry,
        )
        self.plan_cache_size = Gauge(
            "plan_cache_size",
            "Decision plans currently cached",
            registry=self.registry,
        )
        # -- the native hot lane (device/native_pipeline.py +
        # csrc/hostpath.cc), from the pipeline's library_stats.
        self.native_lane_rows = Counter(
            "native_lane_rows",
            "Requests decided by the GIL-free native hot lane (plan "
            "lookup, staging and response build with zero per-row "
            "Python)",
            registry=self.registry,
        )
        self.native_lane_misses = Counter(
            "native_lane_misses",
            "Requests the hot lane missed on (decided by the Python "
            "miss lane, then mirrored)",
            registry=self.registry,
        )
        self.native_lane_staged_hits = Counter(
            "native_lane_staged_hits",
            "Device hits staged natively into the pre-allocated upload "
            "buffers by the hot lane",
            registry=self.registry,
        )
        self.native_lane_invalidations = Counter(
            "native_lane_invalidations",
            "C plan-mirror entries dropped for coherence (slot "
            "recycling, limits-epoch bumps, size-cap clears)",
            registry=self.registry,
        )
        self.native_lane_overflows = Counter(
            "native_lane_overflows",
            "Hot-lane rows demoted to the Python miss lane because the "
            "staging buffers were full (undersized hot-lane cap)",
            registry=self.registry,
        )
        self.native_lane_plans = Gauge(
            "native_lane_plans",
            "Decision plans live in the C-side plan mirror",
            registry=self.registry,
        )
        # -- native telemetry plane (native_plane.py + csrc/hostpath.cc
        # hp_tel_*): per-phase latency of the zero-Python hot lane,
        # measured inside the C library and merged bucket for bucket at
        # render time (the pow2 edges match the C log2-ns buckets).
        self.native_phase_hot_lookup = Histogram(
            "native_phase_hot_lookup",
            "Hot-begin plan-mirror lookup pass latency (per begin call, "
            "measured natively)",
            registry=self.registry,
            buckets=NATIVE_PHASE_BUCKETS,
        )
        self.native_phase_hot_stage = Histogram(
            "native_phase_hot_stage",
            "Hot-begin columnar staging latency: scatter into the "
            "pre-allocated upload buffers, pow2 padding and lease "
            "consume (per begin call, measured natively)",
            registry=self.registry,
            buckets=NATIVE_PHASE_BUCKETS,
        )
        self.native_phase_lease_hit = Histogram(
            "native_phase_lease_hit",
            "Full begin latency of calls that admitted at least one row "
            "from a live quota lease (measured natively)",
            registry=self.registry,
            buckets=NATIVE_PHASE_BUCKETS,
        )
        self.native_phase_hot_finish = Histogram(
            "native_phase_hot_finish",
            "Hot-finish latency: device result columns to response "
            "codes + metric aggregation (per finish call, measured "
            "natively)",
            registry=self.registry,
            buckets=NATIVE_PHASE_BUCKETS,
        )
        self.native_phase_h2i_respond = Histogram(
            "native_phase_h2i_respond",
            "Native ingress batch-coded respond latency "
            "(h2i_respond_coded, per respond call, measured natively)",
            registry=self.registry,
            buckets=NATIVE_PHASE_BUCKETS,
        )
        # -- SLO burn-rate watchdog (native_plane.SloWatchdog): the
        # p99 budget tracked over 5m/1h windows of decision latency.
        self.slo_p99_ms_5m = Gauge(
            "slo_p99_ms_5m",
            "Observed p99 decision latency (ms) over the trailing 5m "
            "window (bucket upper edge)",
            registry=self.registry,
        )
        self.slo_p99_ms_1h = Gauge(
            "slo_p99_ms_1h",
            "Observed p99 decision latency (ms) over the trailing 1h "
            "window (bucket upper edge)",
            registry=self.registry,
        )
        self.slo_burn_rate_5m = Gauge(
            "slo_burn_rate_5m",
            "SLO error-budget burn rate over 5m: share of decisions "
            "over budget / (1 - target quantile); >1 = p99 breach pace",
            registry=self.registry,
        )
        self.slo_burn_rate_1h = Gauge(
            "slo_burn_rate_1h",
            "SLO error-budget burn rate over 1h",
            registry=self.registry,
        )
        self.slo_budget_ms = Gauge(
            "slo_budget_ms",
            "Configured decision-latency SLO budget (ms) the watchdog "
            "tracks at its target quantile",
            registry=self.registry,
        )
        self.slo_breached = Gauge(
            "slo_breached",
            "1 while BOTH burn-rate windows exceed 1.0 (sustained p99 "
            "budget breach), else 0",
            registry=self.registry,
        )
        self.slo_breached_actionable = Gauge(
            "slo_breached_actionable",
            "1 while the SLO is breached AND a non-CPU device backs "
            "this process — the pageable combination (a CPU-fallback "
            "breach is real but not operator-fixable; alert on THIS, "
            "graph slo_breached)",
            registry=self.registry,
        )
        # The JAX package's help text, kept for one exposition; the
        # port answers it from the serving table's torch device.
        self.device_backed = Gauge(
            "device_backed",
            "1 when a non-CPU jax backend serves this process, 0 on "
            "CPU fallback, -1 before the backend is known",
            registry=self.registry,
        )
        self.device_backed.set(-1)
        # -- quota leases (lease/broker.py): the outstanding-token level
        # is the over-admission bound.
        self.lease_admissions = Counter(
            "lease_admissions",
            "Requests admitted from a live quota lease in the C hot "
            "lane (zero Python, zero device work)",
            registry=self.registry,
        )
        self.lease_grants = Counter(
            "lease_grants",
            "Quota leases granted (pre-debited through the columnar "
            "check lane, headroom-checked atomically)",
            registry=self.registry,
        )
        self.lease_grant_denials = Counter(
            "lease_grant_denials",
            "Lease grants refused by the device for lack of window "
            "headroom (the broker halves and backs off)",
            registry=self.registry,
        )
        self.lease_granted_tokens = Counter(
            "lease_granted_tokens",
            "Tokens granted across all leases",
            registry=self.registry,
        )
        self.lease_returned_tokens = Counter(
            "lease_returned_tokens",
            "Unused lease tokens reclaimed (expiry, plan invalidation, "
            "limits reload, context swap) and credited back",
            registry=self.registry,
        )
        self.lease_active = Gauge(
            "lease_active",
            "Live leases (mirrored plans holding tokens)",
            registry=self.registry,
        )
        self.lease_outstanding_tokens = Gauge(
            "lease_outstanding_tokens",
            "Outstanding (granted-but-unconsumed) lease tokens — the "
            "enforced over-admission bound",
            registry=self.registry,
        )
        # -- the tenant usage observatory (observability/usage.py), fed
        # by its render hook.
        self.tenant_hits = Counter(
            "tenant_hits",
            "Counter hits attributed per namespace by the usage "
            "observatory (device accumulator drains + native leased "
            "admissions)",
            [NAMESPACE_LABEL],
            registry=self.registry,
        )
        self.tenant_utilization = Histogram(
            "tenant_utilization",
            "value/max_value utilization sampled per hot counter at "
            "each heavy-hitter drain, per namespace (>1.0 = Report-role "
            "overflow past the limit)",
            [NAMESPACE_LABEL],
            registry=self.registry,
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0, 1.5),
        )
        self.tenant_max_utilization = Gauge(
            "tenant_max_utilization",
            "Highest sampled counter utilization per namespace at the "
            "last heavy-hitter drain",
            [NAMESPACE_LABEL],
            registry=self.registry,
        )
        self.tenant_near_exhaustion = Gauge(
            "tenant_near_exhaustion",
            "Sampled counters at or past the near-exhaustion threshold "
            "(default 90% of max_value) per namespace at the last drain",
            [NAMESPACE_LABEL],
            registry=self.registry,
        )
        self.tenant_top_hit_count = Gauge(
            "tenant_top_hit_count",
            "Cumulative hit count of the single hottest tracked counter",
            registry=self.registry,
        )
        self.tenant_tracked_counters = Gauge(
            "tenant_tracked_counters",
            "Counter identities tracked in the host-side heavy-hitter "
            "table",
            registry=self.registry,
        )
        # -- the sharded table (device/sharded.py): launches per variant
        # and the route memo, from launch_stats() via library_stats.
        self.sharded_launches = Counter(
            "sharded_launches",
            "Multi-chip kernel launches by collective variant: lean (no "
            "collective), coupled (cross-shard pmin request coupling), "
            "global (psum global-counter region present)",
            ["variant"],
            registry=self.registry,
        )
        self.sharded_route_memo_hits = Counter(
            "sharded_route_memo_hits",
            "Key->owner-shard route memo hits (LRU-bounded, "
            "tpu/sharded.py)",
            registry=self.registry,
        )
        self.sharded_route_memo_misses = Counter(
            "sharded_route_memo_misses",
            "Route memo misses (key re-hashed; miss-heavy means the "
            "LRU cap thrashes under the live key cardinality)",
            registry=self.registry,
        )
        self.sharded_route_memo_evictions = Counter(
            "sharded_route_memo_evictions",
            "Route memo LRU evictions",
            registry=self.registry,
        )
        self.sharded_route_memo_size = Gauge(
            "sharded_route_memo_size",
            "Resident route-memo entries (capped at 4x the qualified-"
            "counter cache size)",
            registry=self.registry,
        )
        # -- tiers (tier/): fed by the TierManager's render hook.
        self.tier_resident = Gauge(
            "tier_resident",
            "Counters resident per storage tier (device = slot-table "
            "occupancy, cold = exact host cells)",
            ["tier"],
            registry=self.registry,
        )
        self.tier_migrations = Counter(
            "tier_migrations",
            "Counters moved between tiers by the TierManager, by "
            "direction (promote = cold->device, demote = device->cold; "
            "demand-path evictions also demote but settle no leases)",
            ["direction"],
            registry=self.registry,
        )
        self.tier_migration_backlog = Gauge(
            "tier_migration_backlog",
            "Migration candidates the last TierManager round priced in "
            "but could not move (headroom, in-flight guards)",
            registry=self.registry,
        )
        self.tier_cold_decide_seconds = Histogram(
            "tier_cold_decide_seconds",
            "Host evaluation latency of decisions served by the cold "
            "tier (the exact dict-lane decide, device untouched)",
            registry=self.registry,
            buckets=(
                0.000005, 0.00001, 0.000025, 0.00005, 0.0001, 0.00025,
                0.0005, 0.001, 0.0025, 0.005, 0.01,
            ),
        )
        self.tier_decision_benefit = Gauge(
            "tier_decision_benefit",
            "Model-priced benefit (seconds of host decide time per "
            "interval) of the last TierManager migration decision",
            registry=self.registry,
        )
        self.tier_cold_spilled = Counter(
            "tier_cold_spilled",
            "Cold-tier journal rows appended to the disk spill log",
            registry=self.registry,
        )
        # -- control-signal bus (signals.py): the joined observation
        # vector served at /debug/signals, mirrored as gauges.
        self.signal_queue_wait_ms = Gauge(
            "signal_queue_wait_ms",
            "Control signal: EWMA of per-flush worst batcher queue "
            "wait (ms, check path)",
            registry=self.registry,
        )
        self.signal_batch_fill = Gauge(
            "signal_batch_fill",
            "Control signal: EWMA of check-batcher flush fill ratio",
            registry=self.registry,
        )
        self.signal_breaker_state = Gauge(
            "signal_breaker_state",
            "Control signal: device-plane breaker state (0 closed, 1 "
            "half-open, 2 open)",
            registry=self.registry,
        )
        self.signal_shed_rate = Gauge(
            "signal_shed_rate",
            "Control signal: admission sheds per second between signal "
            "snapshots, per priority class",
            ["priority"],
            registry=self.registry,
        )
        self.signal_lease_outstanding_tokens = Gauge(
            "signal_lease_outstanding_tokens",
            "Control signal: outstanding quota-lease tokens (the live "
            "over-admission bound)",
            registry=self.registry,
        )
        self.signal_native_p99_us = Gauge(
            "signal_native_p99_us",
            "Control signal: native-plane per-phase p99 (µs), per phase",
            ["phase"],
            registry=self.registry,
        )
        self.signal_slo_burn_5m = Gauge(
            "signal_slo_burn_5m",
            "Control signal: SLO error-budget burn rate over the 5m "
            "window",
            registry=self.registry,
        )
        self.signal_box_calibration = Gauge(
            "signal_box_calibration",
            "Control signal: runtime box calibration score (the bench's "
            "fixed spin+memcpy normalizer, computed in-process)",
            registry=self.registry,
        )
        self.signal_device_backed = Gauge(
            "signal_device_backed",
            "Control signal: device_backed as seen by the signal bus "
            "(1 device, 0 CPU fallback, -1 unknown)",
            registry=self.registry,
        )
        self.signal_device_backed.set(-1)
        # -- process flight recorder (flight.py): exemplar rings and
        # triggered incident bundles, fed by the recorder's render hook.
        self.flight_taps = Gauge(
            "flight_taps",
            "Decisions observed by the flight recorder's hot-path tap "
            "(all lanes, cumulative)",
            registry=self.registry,
        )
        self.flight_exemplars = Counter(
            "flight_exemplars",
            "Sampled decision exemplars admitted into the flight "
            "recorder ring (1-in-N head sampling)",
            registry=self.registry,
        )
        self.flight_tail_retained = Counter(
            "flight_tail_retained",
            "Decisions retained by a per-lane worst-K tail reservoir "
            "(kept regardless of sample rate)",
            registry=self.registry,
        )
        self.flight_triggers = Counter(
            "flight_triggers",
            "Incident bundles fired, by trigger reason (slo_burn, "
            "breaker_open, resize_abort, drift, device_probe, manual)",
            ["reason"],
            registry=self.registry,
        )
        self.flight_bundles = Gauge(
            "flight_bundles",
            "Incident bundles currently retained in the flight spool",
            registry=self.registry,
        )
        self.flight_spool_bytes = Gauge(
            "flight_spool_bytes",
            "Total bytes of the retention-capped flight bundle spool",
            registry=self.registry,
        )
        self.flight_peer_rings = Counter(
            "flight_peer_rings",
            "Peer ring contributions merged into incident bundles "
            "(pod-correlated autopsies over the peer lane)",
            registry=self.registry,
        )
        # -- serving-model fit (model.py): coefficients, drift and the
        # SLO-headroom forecast, refreshed by the estimator's render hook.
        self.model_r2 = Gauge(
            "model_r2",
            "Prequential (held-out) R² of the online serving-model fit "
            "over recent launches",
            registry=self.registry,
        )
        self.model_observations = Gauge(
            "model_observations",
            "Device-launch observations the online fit has consumed",
            registry=self.registry,
        )
        self.model_drift = Gauge(
            "model_drift",
            "1 while the residual drift detector holds a confirmed "
            "code/config regression (calibration flat, residuals up); "
            "box phase changes classify as calibration shifts and stay 0",
            registry=self.registry,
        )
        self.model_drift_cusum = Gauge(
            "model_drift_cusum",
            "One-sided CUSUM statistic over standardized prediction "
            "residuals (trips at 8; slower-than-model only)",
            registry=self.registry,
        )
        self.model_coefficient = Gauge(
            "model_coefficient",
            "Fitted serving-model coefficients in normalized units "
            "(seconds × box calibration score), per target (host/"
            "device) and term (launch/row/lease_row/pod_row/"
            "collective_row)",
            ["target", "term"],
            registry=self.registry,
        )
        self.capacity_headroom_ratio = Gauge(
            "capacity_headroom_ratio",
            "Max sustainable decisions/s at the current traffic mix "
            "(fitted model inverted against the SLO budget) divided by "
            "the current rate — <1 means the SLO is already paying",
            registry=self.registry,
        )
        self.capacity_max_decisions_per_sec = Gauge(
            "capacity_max_decisions_per_sec",
            "Max sustainable decisions/s under the SLO budget at the "
            "current traffic mix, per the fitted serving model",
            registry=self.registry,
        )
        self.capacity_stage_share = Gauge(
            "capacity_stage_share",
            "Share of predicted decision latency each serving-model "
            "stage owns at the operating point — where the next "
            "millisecond of p99 comes from",
            ["stage"],
            registry=self.registry,
        )
        # Pre-seed the bounded label sets so the families render (and
        # dashboards see zeros) before the first sample.
        # -- the pod (routing.py, server/peering.py, parallel/pod.py),
        # polled off the pod frontend's library_stats: routing verdicts
        # and the peer lane
        self.pod_routed_local = Counter(
            "pod_routed_local",
            "Decisions owned by this host (the collective-free lean "
            "path; zero cross-host traffic)",
            registry=self.registry,
        )
        self.pod_routed_forwarded = Counter(
            "pod_routed_forwarded",
            "Decisions forwarded once over the peer lane to their "
            "owner host",
            registry=self.registry,
        )
        self.pod_routed_pinned = Counter(
            "pod_routed_pinned",
            "Decisions routed by namespace pin (multi-limit or global "
            "namespaces, whole namespace owned by one host)",
            registry=self.registry,
        )
        self.pod_peer_errors = Counter(
            "pod_peer_errors",
            "Peer-lane forward failures (dead/slow owner host; the "
            "request fails with the shed semantics)",
            registry=self.registry,
        )
        self.pod_peer_p99_ms = Gauge(
            "pod_peer_p99_ms",
            "p99 peer-lane forward latency (ms) over the recent "
            "forward window — the pod's one-hop cost",
            registry=self.registry,
        )
        # -- the pod's resilience plane (server/peering.py)
        self.peer_health_state = Gauge(
            "peer_health_state",
            "Peer health state per pod peer: 0 up, 1 suspect "
            "(consecutive failures/deadline misses), 2 down (probed "
            "until it answers again)",
            ["peer"],
            registry=self.registry,
        )
        self.peer_health_retries = Counter(
            "peer_health_retries",
            "Jittered-backoff forward retries against suspect peers "
            "(idempotent check kinds only, deadline-budgeted)",
            registry=self.registry,
        )
        self.peer_health_hedges_won = Counter(
            "peer_health_hedges_won",
            "Hedged forwards where the raced second attempt answered "
            "first (the original was stalled)",
            registry=self.registry,
        )
        self.peer_health_hedges_lost = Counter(
            "peer_health_hedges_lost",
            "Hedged forwards where the original attempt still won "
            "(the hedge was wasted work)",
            registry=self.registry,
        )
        self.peer_health_redials = Counter(
            "peer_health_redials",
            "Cached peer channels dropped on a health trip so a "
            "restarted peer gets a fresh dial instead of the stale "
            "channel's backoff state",
            registry=self.registry,
        )
        self.peer_health_probes = Counter(
            "peer_health_probes",
            "Background ping probes sent to non-up peers from the "
            "lane's daemon loop (recovery detection)",
            registry=self.registry,
        )
        self.pod_failover_degraded_decisions = Counter(
            "pod_failover_degraded_decisions",
            "Forwarded decisions served by a local per-owner stand-in "
            "(exact oracle + delta journal) while the owner's breaker "
            "was away from closed",
            registry=self.registry,
        )
        self.pod_failover_journal_depth = Gauge(
            "pod_failover_journal_depth",
            "Counter deltas journaled against down owners, awaiting "
            "replay — the live zero-lost-updates backlog",
            registry=self.registry,
        )
        self.pod_failover_breaker_open = Gauge(
            "pod_failover_breaker_open",
            "Pod peers whose per-owner breaker is away from closed "
            "(their forwarded traffic is failing over locally)",
            registry=self.registry,
        )
        self.pod_failover_reconciles = Counter(
            "pod_failover_reconciles",
            "Journal replays completed into recovered owners "
            "(apply_deltas over the peer lane)",
            registry=self.registry,
        )
        self.pod_failover_replayed_deltas = Counter(
            "pod_failover_replayed_deltas",
            "Journaled counter deltas replayed into recovered owners",
            registry=self.registry,
        )
        self.pod_failover_reconcile_seconds = Counter(
            "pod_failover_reconcile_seconds",
            "Cumulative seconds spent replaying failover journals to "
            "recovered owners",
            registry=self.registry,
        )
        self.pod_failover_seconds = Counter(
            "pod_failover_seconds",
            "Cumulative seconds pod peer breakers have spent away "
            "from closed (the degraded-window clock)",
            registry=self.registry,
        )
        # -- the pod's observability plane (observability/pod_plane.py,
        # observability/events.py); the hop histogram is fed a bucket at
        # a time by PodHopRecorder.poll (attach_render_hook)
        self.pod_hop_phase_ms = Histogram(
            "pod_hop_phase_ms",
            "Per-hop breakdown of one forwarded pod decision (ms): "
            "queue (serving loop -> lane loop handoff), serialize "
            "(payload encode), wire (channel/network/retries — the "
            "derived remainder), remote_decide (the owner's reported "
            "decide time)",
            ["phase"],
            registry=self.registry,
            buckets=POD_HOP_BUCKETS_MS,
        )
        self.pod_events = Counter(
            "pod_events",
            "Typed pod timeline events by kind: peer health "
            "transitions, breaker transitions, degraded enter/exit, "
            "journal replay begin/end, routing-epoch bumps, channel "
            "re-dials, hedge outcomes (GET /debug/events serves the "
            "ordered ring)",
            ["kind"],
            registry=self.registry,
        )
        self.pod_event_seq = Gauge(
            "pod_event_seq",
            "Last pod event sequence number emitted by this host "
            "(monotonic; the pod-wide merge key is (host, seq))",
            registry=self.registry,
        )
        self.pod_signal_hosts = Gauge(
            "pod_signal_hosts",
            "Pod hosts contributing a fresh federated signal column "
            "(self included; a stale peer drops out after 10s)",
            registry=self.registry,
        )
        self.pod_signal_exchanges = Counter(
            "pod_signal_exchanges",
            "Peer signal columns ingested (piggybacked on the health-"
            "probe cadence, never the decision path)",
            registry=self.registry,
        )
        self.pod_signal_age_s = Gauge(
            "pod_signal_age_s",
            "Age of the OLDEST peer signal column (s) — staleness of "
            "the federated view",
            registry=self.registry,
        )
        self.pod_signal_routed_share = Gauge(
            "pod_signal_routed_share",
            "This host's locally-owned decision share as joined into "
            "the federated ControlSignals pod tail",
            registry=self.registry,
        )
        self.pod_signal_degraded_share = Gauge(
            "pod_signal_degraded_share",
            "Share of this host's routed decisions served by degraded-"
            "owner stand-ins (the federated degraded share column)",
            registry=self.registry,
        )
        # -- the native pod fast path: the C lane's local/foreign split
        # (device/native_pipeline.py pod_stats) and the bulk-forward lane
        # (server/peering.py), polled off the pod frontend's
        # library_stats
        self.pod_hot_local_rows = Counter(
            "pod_hot_local_rows",
            "Hot-lane rows the C ownership pass classified locally "
            "owned (staged zero-Python; pod_hot_local_share = "
            "local / (local + foreign))",
            registry=self.registry,
        )
        self.pod_hot_foreign_rows = Counter(
            "pod_hot_foreign_rows",
            "Hot-lane rows the C ownership pass classified foreign-"
            "owned (bulk-forwarded to their owner, one RPC per owner "
            "per flush)",
            registry=self.registry,
        )
        self.pod_bulk_forward_batches = Counter(
            "pod_bulk_forward_batches",
            "Bulk forwards sent: one peer-lane RPC carrying a whole "
            "flush's foreign-owned rows for one owner host",
            registry=self.registry,
        )
        self.pod_bulk_forward_rows = Counter(
            "pod_bulk_forward_rows",
            "Rows carried by outgoing bulk forwards (rows / batches = "
            "the mean bulk batch size)",
            registry=self.registry,
        )
        self.pod_bulk_served_rows = Counter(
            "pod_bulk_served_rows",
            "Rows this host decided for peers' bulk forwards (the "
            "owner side, one local decide_many pass per batch)",
            registry=self.registry,
        )
        self.pod_psum_namespaces = Gauge(
            "pod_psum_namespaces",
            "Global namespaces the lockstep psum lane serves locally "
            "on every host (fixed-window only; the rest stay pinned)",
            registry=self.registry,
        )
        self.pod_psum_decisions = Counter(
            "pod_psum_decisions",
            "Decisions answered by the psum lane (local partial + "
            "folded remote base; never a peer hop)",
            registry=self.registry,
        )
        self.pod_psum_limited = Counter(
            "pod_psum_limited",
            "Psum-lane decisions answered over-limit",
            registry=self.registry,
        )
        self.pod_psum_exchanges = Counter(
            "pod_psum_exchanges",
            "Lockstep exchange rounds completed (each folds every "
            "other host's live partials into the remote base)",
            registry=self.registry,
        )
        self.pod_psum_cells = Gauge(
            "pod_psum_cells",
            "Live local partial cells held by the psum lane "
            "(LRU-bounded)",
            registry=self.registry,
        )
        # -- the elastic pod (server/resize.py): the membership
        # transitions, polled off the pod frontend's library_stats
        self.pod_resize_epoch = Gauge(
            "pod_resize_epoch",
            "Current pod topology epoch (bumped by every membership "
            "transition commit/revert; forwards are stamped with it "
            "and wrong-epoch forwards rejected rerouteable)",
            registry=self.registry,
        )
        self.pod_resize_active = Gauge(
            "pod_resize_active",
            "1 while a membership transition is in flight on this "
            "host (armed or migrating)",
            registry=self.registry,
        )
        self.pod_resize_completed = Counter(
            "pod_resize_completed",
            "Membership transitions completed on this host",
            registry=self.registry,
        )
        self.pod_resize_aborted = Counter(
            "pod_resize_aborted",
            "Membership transitions aborted (reverted to the old "
            "topology with received slices pushed back)",
            registry=self.registry,
        )
        self.pod_resize_slices_moved = Counter(
            "pod_resize_slices_moved",
            "Table slices this host migrated out (snapshot + "
            "convergence sweeps + release)",
            registry=self.registry,
        )
        self.pod_resize_moved_deltas = Counter(
            "pod_resize_moved_deltas",
            "Counter rows shipped over the migrate lane (outbound "
            "sweeps plus inbound ledger applies)",
            registry=self.registry,
        )
        self.pod_resize_released_counters = Counter(
            "pod_resize_released_counters",
            "Old-owner counter cells released after their slice's "
            "final marker was acknowledged by the new owner",
            registry=self.registry,
        )
        self.pod_resize_seconds = Counter(
            "pod_resize_seconds",
            "Cumulative seconds spent inside membership transitions "
            "(resize_begin to resize_end/resize_abort)",
            registry=self.registry,
        )
        self.pod_resize_stale_rejects = Counter(
            "pod_resize_stale_rejects",
            "Forwards rejected by the owner-side topology-epoch gate "
            "(stamped with an epoch this host is not on; the origin "
            "re-plans)",
            registry=self.registry,
        )
        self.pod_resize_replans = Counter(
            "pod_resize_replans",
            "Forwards that came back stale_epoch and were re-planned "
            "in-band under the adopted topology",
            registry=self.registry,
        )
        # -- the fast join (server/resize.py): warm-standby promotions
        self.join_completed = Counter(
            "join_completed",
            "Warm-standby joins this host initiated that completed "
            "(grow or replace mode)",
            registry=self.registry,
        )
        self.join_aborted = Counter(
            "join_aborted",
            "Warm-standby joins that failed at the state ship or "
            "whose membership transition aborted",
            registry=self.registry,
        )
        self.join_seconds = Counter(
            "join_seconds",
            "Cumulative seconds spent driving warm-standby joins "
            "(join_begin to join_end, state ship included)",
            registry=self.registry,
        )
        self.join_seed_entries = Counter(
            "join_seed_entries",
            "Plan-cache seed entries joiners applied from this "
            "host's shipped decision-plan exports",
            registry=self.registry,
        )
        self.join_ttfd_seconds = Gauge(
            "join_ttfd_seconds",
            "Time from this host's join adopt to its first answered "
            "decision (the joiner-side time-to-first-decision; 0 = "
            "never joined)",
            registry=self.registry,
        )
        # -- the warm standby (server/standby.py): its warm-up, with
        # the JAX package's help text (the metrics parity holds it)
        self.standby_ready = Gauge(
            "standby_ready",
            "1 once this standby's warm-up finished (host mesh "
            "formed, pow2 hit-bucket kernels compiled) and the join "
            "callbacks are armed",
            registry=self.registry,
        )
        self.standby_warm_kernels = Gauge(
            "standby_warm_kernels",
            "Decision kernels pre-compiled during standby warm-up "
            "(check+update per pow2 hit bucket)",
            registry=self.registry,
        )
        self.standby_warm_seconds = Gauge(
            "standby_warm_seconds",
            "Seconds the standby's kernel warm-up took (served from "
            "the persistent XLA cache on a re-boot when "
            "--xla-cache-dir is set)",
            registry=self.registry,
        )
        self.pod_psum_remote_slots = Gauge(
            "pod_psum_remote_slots",
            "Folded remote-base slots currently live (non-zero and "
            "unexpired)",
            registry=self.registry,
        )
        # -- the capacity controller (control/): fed by its render hook
        # (CapacityController.poll)
        self.ctl_mode = Gauge(
            "ctl_mode",
            "Capacity controller mode (0=off, 1=observe, 2=on)",
            registry=self.registry,
        )
        self.ctl_knob = Gauge(
            "ctl_knob",
            "Live value of each capacity-controller knob "
            "(admission_ceiling, shed_floor, chunk_target_ms, "
            "lease_scale)",
            ["knob"],
            registry=self.registry,
        )
        self.ctl_actuations = Counter(
            "ctl_actuations",
            "Slew-limited knob writes applied by the capacity "
            "controller, by knob",
            ["knob"],
            registry=self.registry,
        )
        self.ctl_membership_actions = Counter(
            "ctl_membership_actions",
            "Pod membership actuations driven by the capacity "
            "controller (add_host = warm-standby join, drain_host = "
            "tail-host drain)",
            ["action"],
            registry=self.registry,
        )
        self.ctl_interlock_holds = Counter(
            "ctl_interlock_holds",
            "Controller ticks skipped whole because a resize/join "
            "transition was active (the global actuation interlock)",
            registry=self.registry,
        )
        self.ctl_objective = Gauge(
            "ctl_objective",
            "Last proposal's objective J = predicted throughput x "
            "p99-compliance x fairness (0 while the model is in "
            "warmup)",
            registry=self.registry,
        )
        self.ctl_pressure = Gauge(
            "ctl_pressure",
            "Last proposal's scalar overload signal (max of SLO burn, "
            "queue-wait/budget, inverse model headroom; 1.0 = at "
            "capacity)",
            registry=self.registry,
        )
        for knob in (
            "admission_ceiling", "shed_floor", "chunk_target_ms",
            "lease_scale",
        ):
            self.ctl_knob.labels(knob)
            self.ctl_actuations.labels(knob)
        for action in ("add_host", "drain_host"):
            self.ctl_membership_actions.labels(action)
        for reason in _SHED_REASONS:
            for priority in _PRIORITIES:
                self.admission_sheds.labels(reason, priority)
        for state in _BREAKER_GAUGE:
            self.admission_breaker_transitions.labels(state)
        for priority in _PRIORITIES:
            self.signal_shed_rate.labels(priority)
        for phase in _SIGNAL_PHASES:
            self.signal_native_p99_us.labels(phase)
        for reason in TRIGGER_REASONS:
            self.flight_triggers.labels(reason)
        for target in MODEL_TARGETS:
            for term in MODEL_TERMS:
                self.model_coefficient.labels(target, term)
        for stage in ATTRIBUTION_STAGES:
            self.capacity_stage_share.labels(stage)
        for tier in ("device", "cold"):
            self.tier_resident.labels(tier)
        for direction in ("promote", "demote"):
            self.tier_migrations.labels(direction)
        for batcher in BATCHERS:
            self.batcher_queue_wait.labels(batcher)
            self.batcher_batch_fill_ratio.labels(batcher)
            for reason in FLUSH_REASONS:
                self.batcher_flushes.labels(batcher, reason)
        for phase in PHASES:
            self.device_phase_latency.labels(phase)
        for variant in ("lean", "coupled", "global"):
            self.sharded_launches.labels(variant)
        for phase in HOP_PHASES:
            self.pod_hop_phase_ms.labels(phase)
        for kind in EVENT_KINDS:
            self.pod_events.labels(kind)
        self._library_sources: list = []
        self._counter_baselines: dict = {}
        self._native_planes: list = []
        self._render_hooks: list = []
        # OpenMetrics exemplar rendering: off by default; enable_exemplars
        # arms trace-id exemplars on the decision-latency tail buckets
        # and the OpenMetrics exposition.
        self.exemplars_enabled = False
        self._exemplar_min_s = 0.025

    def attach_native_plane(self, plane) -> None:
        """Attach a ``native_plane.NativePlane``; its ``poll(self)`` runs
        on every render (native phase histogram merge, slow-row exemplar
        drain, slo_* and device_backed gauges)."""
        self._native_planes.append(plane)

    def attach_render_hook(self, hook) -> None:
        """Attach any object exposing ``poll(metrics)``; called on every
        render (the tenant usage observatory, the tier manager, the
        signal bus, the serving-model estimator and the process flight
        recorder ride this)."""
        self._render_hooks.append(hook)

    def attach_library_source(self, source) -> None:
        """Attach an object exposing ``library_stats() -> dict``; polled
        on every render. Recognized keys: ``batcher_size`` /
        ``cache_size`` / ``queue_depth`` / ``plan_cache_size`` /
        ``native_lane_plans`` / ``lease_active`` /
        ``lease_outstanding_tokens`` / ``sharded_route_memo_size``
        (levels, summed over sources); the ``_CUMULATIVE_KEYS`` (counts,
        converted to increments per source); ``flush_sizes`` (a list
        drained into the histogram); ``sharded_launches`` (variant ->
        cumulative count, converted to labeled increments). A source
        with ``device_stats()`` also feeds the per-shard table
        families."""
        self._library_sources.append(source)

    def _poll_library_sources(self) -> None:
        for plane in self._native_planes:
            plane.poll(self)
        for hook in self._render_hooks:
            hook.poll(self)
        levels = dict.fromkeys((
            "batcher_size", "cache_size", "queue_depth", "plan_cache_size",
            "native_lane_plans", "lease_active", "lease_outstanding_tokens",
            "sharded_route_memo_size",
        ), 0)
        pod_levels = dict.fromkeys(_POD_SUMS + _POD_MAXES, 0)
        for i, source in enumerate(self._library_sources):
            self._poll_device_stats(i, source)
            stats = source.library_stats()
            for key in levels:
                levels[key] += int(stats.get(key, 0))
            self._poll_pod_stats(i, stats, pod_levels)
            for key in _CUMULATIVE_KEYS:
                if key in stats:
                    seen = int(stats[key])
                    baseline = self._counter_baselines.get((i, key), 0)
                    if seen > baseline:
                        getattr(self, key).inc(seen - baseline)
                        self._counter_baselines[(i, key)] = seen
            for size in stats.get("flush_sizes", ()):
                self.batcher_flush_size.observe(size)
            for variant, seen in stats.get("sharded_launches", {}).items():
                seen = int(seen)
                baseline_key = (i, "sharded_launches", variant)
                baseline = self._counter_baselines.get(baseline_key, 0)
                if seen > baseline:
                    self.sharded_launches.labels(variant).inc(
                        seen - baseline
                    )
                    self._counter_baselines[baseline_key] = seen
        self.batcher_size.set(levels["batcher_size"])
        self.cache_size.set(levels["cache_size"])
        self.batcher_queue_depth.set(levels["queue_depth"])
        self.plan_cache_size.set(levels["plan_cache_size"])
        self.native_lane_plans.set(levels["native_lane_plans"])
        self.lease_active.set(levels["lease_active"])
        self.lease_outstanding_tokens.set(levels["lease_outstanding_tokens"])
        self.sharded_route_memo_size.set(levels["sharded_route_memo_size"])
        for key, value in pod_levels.items():
            getattr(self, key).set(value)

    def _poll_pod_stats(self, i: int, stats: dict, levels: dict) -> None:
        """The pod frontend's families from one source's library_stats:
        levels summed or maxed into ``levels``, the peer states and
        routed and degraded shares set, the event kinds and the seconds
        counted as increments."""
        for key in _POD_SUMS:
            levels[key] += stats.get(key, 0)
        for key in _POD_MAXES:
            levels[key] = max(levels[key], stats.get(key, 0))
        for peer, state in stats.get("peer_health_state", {}).items():
            self.peer_health_state.labels(str(peer)).set(int(state))
        for key in ("pod_signal_routed_share", "pod_signal_degraded_share"):
            if key in stats:
                getattr(self, key).set(float(stats[key]))
        for key in _POD_GAUGES:
            if key in stats:
                getattr(self, key).set(float(stats[key]))
        for kind, seen in stats.get("pod_events", {}).items():
            seen = int(seen)
            baseline_key = (i, "pod_events", kind)
            baseline = self._counter_baselines.get(baseline_key, 0)
            if seen > baseline:
                self.pod_events.labels(str(kind)).inc(seen - baseline)
                self._counter_baselines[baseline_key] = seen
        for key in _CUMULATIVE_SECONDS:
            if key in stats:
                seen_f = float(stats[key])
                baseline_f = self._counter_baselines.get((i, key), 0.0)
                if seen_f > baseline_f:
                    getattr(self, key).inc(seen_f - baseline_f)
                    self._counter_baselines[(i, key)] = seen_f

    def _poll_device_stats(self, i: int, source) -> None:
        """Per-shard device-table stats from a ``device_stats()`` source:
        occupancy/capacity as levels, evictions/collisions as cumulative
        counts converted to increments."""
        device_stats = getattr(source, "device_stats", None)
        if not callable(device_stats):
            return
        for shard in device_stats().get("shards", ()):
            label = str(shard.get("shard"))
            self.counter_slots_used.labels(label).set(
                int(shard.get("occupied", 0))
            )
            self.counter_slots_capacity.labels(label).set(
                int(shard.get("capacity", 0))
            )
            for key, metric in (
                ("evictions", self.counter_slot_evictions),
                ("collisions", self.counter_slot_collisions),
            ):
                seen = int(shard.get(key, 0))
                baseline_key = (i, label, key)
                baseline = self._counter_baselines.get(baseline_key, 0)
                if seen > baseline:
                    metric.labels(label).inc(seen - baseline)
                    self._counter_baselines[baseline_key] = seen

    @staticmethod
    def _parse_labels(metric_labels: str):
        """Parse a CEL map literal into (expr, [label names])."""
        from ..core.cel import Expression, Literal, MapExpr

        expr = Expression.parse(metric_labels)
        if not isinstance(expr.ast, MapExpr):
            raise ValueError("metric labels must be a CEL map literal")
        names = []
        for k, _v in expr.ast.entries:
            if not (isinstance(k, Literal) and isinstance(k.value, str)):
                raise ValueError("metric label names must be string literals")
            names.append(k.value)
        return expr, names

    def reload_labels(self, metric_labels: str) -> None:
        """Hot-swap the label VALUE expressions (the reference's watched
        labels file). Prometheus label NAMES are fixed per metric at
        startup, so new names require a restart; expressions for a
        subset of the configured names are fine (absent names render
        empty)."""
        expr, names = self._parse_labels(metric_labels)
        unknown = [n for n in names if n not in self.custom_label_names]
        if unknown:
            raise ValueError(
                f"metric label names {unknown} were not configured at "
                f"startup (configured: {self.custom_label_names}); label "
                "names are fixed per process"
            )
        self.labels_expr = expr

    def custom_labels(self, ctx) -> list:
        """Evaluate the CEL label map against a request context; absent
        or failing values become empty labels (the reference's
        behaviour: a label never errors the request)."""
        if self.labels_expr is None or ctx is None:
            return [""] * len(self.custom_label_names)
        try:
            values = self.labels_expr.eval_map(ctx)
        except Exception:
            values = {}
        return [values.get(name, "") for name in self.custom_label_names]

    def incr_authorized_calls(
        self, namespace: str, ctx=None, n: int = 1, labels=None
    ) -> None:
        extra = labels if labels is not None else self.custom_labels(ctx)
        self.authorized_calls.labels(namespace, *extra).inc(n)

    def incr_authorized_hits(
        self, namespace: str, hits: int, ctx=None, labels=None
    ) -> None:
        extra = labels if labels is not None else self.custom_labels(ctx)
        self.authorized_hits.labels(namespace, *extra).inc(hits)

    def incr_limited_calls(
        self, namespace: str, limit_name: Optional[str] = None, ctx=None,
        labels=None, n: int = 1,
    ) -> None:
        extra = labels if labels is not None else self.custom_labels(ctx)
        if self.use_limit_name_label:
            self.limited_calls.labels(
                namespace, limit_name or "", *extra
            ).inc(n)
        else:
            self.limited_calls.labels(namespace, *extra).inc(n)

    def enable_exemplars(self, min_seconds: float = 0.025) -> None:
        """Arm OpenMetrics exemplar rendering: decision-latency
        observations landing in the tail buckets (>= ``min_seconds``)
        carry a ``trace_id`` exemplar, and ``render`` switches to the
        OpenMetrics exposition (the only format that serializes
        exemplars). Off by default: the text 0.0.4 exposition."""
        self.exemplars_enabled = True
        self._exemplar_min_s = float(min_seconds)

    def _latency_exemplar(self, seconds: float) -> Optional[dict]:
        if not self.exemplars_enabled or seconds < self._exemplar_min_s:
            return None
        trace_id = current_trace_id() or current_request_id()
        if not trace_id:
            return None
        return {"trace_id": str(trace_id)[:64]}

    def record_datastore_latency(self, timings) -> None:
        """MetricsLayer consumer (prometheus_metrics.rs:131-133): the
        aggregated busy+idle duration of all ``datastore`` child spans
        under one aggregate root."""
        seconds = timings.duration
        self.datastore_latency.observe(
            seconds, exemplar=self._latency_exemplar(seconds)
        )

    @property
    def content_type(self) -> str:
        """The exposition content type ``render`` currently emits."""
        if self.exemplars_enabled:
            return OPENMETRICS_CONTENT_TYPE
        return CONTENT_TYPE_LATEST

    def render(self) -> bytes:
        self._poll_library_sources()
        if self.exemplars_enabled:
            return openmetrics_latest(self.registry)
        return generate_latest(self.registry)
