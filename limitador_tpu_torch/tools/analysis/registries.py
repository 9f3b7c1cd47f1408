"""Registry cross-check passes: metric families, native phases, debug
sections, and the docs that name them.

Four passes of one shape, the JAX package's
(``limitador_tpu/tools/analysis/registries.py``) over the port's
modules: a subsystem declares a module-level registry tuple, another
module consumes it, and drift in either direction (a family that never
renders, a registration nothing serves) fails the gate instead of
vanishing from dashboards.

``docs-sync`` reads ``docs/observability.md`` (the JAX package's
reference, read only) and README's port section, where a telemetry
surface only the port has (the ``torch.profiler`` capture behind
``/debug/profile``) is documented.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List

from . import PACKAGE, Finding, RepoContext, register_pass

__all__ = [
    "REGISTRY_OWNED_PREFIXES", "NATIVE_PLANE_MODULE", "HTTP_API_MODULE",
    "DEBUG_PAIR_TABLES",
    "OBSERVABILITY_DOC", "PORT_DOC", "PORT_DOC_SECTION", "EVENTS_MODULE",
    "declared_metric_families", "registered_metric_families",
    "metric_registry_findings", "native_phase_findings",
    "debug_section_findings", "docs_sync_findings",
]

#: metric prefixes whose declarations must be covered by a subsystem's
#: METRIC_FAMILIES registry (prefix -> registry module, repo-relative):
#: the JAX package's map with ``tpu/`` read as the port's ``device/``
REGISTRY_OWNED_PREFIXES = {
    "admission_": f"{PACKAGE}/admission/__init__.py",
    "plan_cache_": f"{PACKAGE}/device/plan_cache.py",
    "peer_health_": f"{PACKAGE}/server/peering.py",
    "pod_": f"{PACKAGE}/routing.py",
    # the pod plane: hop breakdown and federated signals; the event
    # timeline owns pod_event (pod_events and pod_event_seq)
    "pod_hop_": f"{PACKAGE}/observability/pod_plane.py",
    "pod_signal_": f"{PACKAGE}/observability/pod_plane.py",
    "pod_event": f"{PACKAGE}/observability/events.py",
    # the elastic pod's membership-transition plane
    "pod_resize_": f"{PACKAGE}/server/resize.py",
    "sharded_": f"{PACKAGE}/device/sharded.py",
    "dispatch_chunk_": f"{PACKAGE}/device/batcher.py",
    "native_lane_": f"{PACKAGE}/device/native_pipeline.py",
    "lease_": f"{PACKAGE}/lease/__init__.py",
    "native_phase_": f"{PACKAGE}/observability/native_plane.py",
    "slo_": f"{PACKAGE}/observability/native_plane.py",
    "tenant_": f"{PACKAGE}/observability/usage.py",
    "signal_": f"{PACKAGE}/observability/signals.py",
    # the serving-model fit's model_* gauges and capacity_* forecast
    "model_": f"{PACKAGE}/observability/model.py",
    "capacity_": f"{PACKAGE}/observability/model.py",
    # the flight recorder: exemplar rings, trigger tallies, the spool
    "flight_": f"{PACKAGE}/observability/flight.py",
    # tiers: residency, migration rates, the cold tier's decide latency
    "tier_": f"{PACKAGE}/tier/__init__.py",
    # the join counters live on the resize coordinator (one membership
    # plane); the warm-up plane owns standby_*
    "join_": f"{PACKAGE}/server/resize.py",
    "standby_": f"{PACKAGE}/server/standby.py",
    # the capacity controller's knobs, actuations and interlocks
    "ctl_": f"{PACKAGE}/control/__init__.py",
}

#: the native telemetry plane's phase registry module
NATIVE_PLANE_MODULE = f"{PACKAGE}/observability/native_plane.py"

#: the HTTP API module whose /debug/stats sections must be registered
#: in its DEBUG_STATS_SECTIONS tuple
HTTP_API_MODULE = f"{PACKAGE}/server/http_api.py"

#: the HTTP API's tables of (section key, source attribute) pairs that
#: get_debug_stats serves in a loop: the JAX package's
#: DEBUG_SOURCE_SECTIONS, and the port's DEBUG_NONEMPTY_SECTIONS
#: (served only when the source returns a non-empty section)
DEBUG_PAIR_TABLES = ("DEBUG_SOURCE_SECTIONS", "DEBUG_NONEMPTY_SECTIONS")

METRICS_MODULE = f"{PACKAGE}/observability/metrics.py"

#: the observability reference every telemetry surface must appear in
OBSERVABILITY_DOC = "docs/observability.md"

#: where surfaces only the port has are documented: README's section
#: whose heading starts with PORT_DOC_SECTION
PORT_DOC = "README.md"
PORT_DOC_SECTION = "## PyTorch/CUDA port"

#: the typed pod event registry whose kinds the doc must enumerate
EVENTS_MODULE = f"{PACKAGE}/observability/events.py"


def port_doc_section(text: str) -> str:
    """README's port section: from its heading to the next ``## ``."""
    start = text.find("\n" + PORT_DOC_SECTION)
    if start < 0:
        return ""
    end = text.find("\n## ", start + 1)
    return text[start:] if end < 0 else text[start:end]


def declared_metric_families(ctx: RepoContext):
    """Family names declared in observability/metrics.py: the first
    string-literal argument of every Counter/Gauge/Histogram call."""
    path = ctx.path(METRICS_MODULE)
    names = set()
    if ctx.tree(path) is None:
        return names
    for node in ctx.nodes(path):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        fname = (
            fn.id if isinstance(fn, ast.Name)
            else fn.attr if isinstance(fn, ast.Attribute) else None
        )
        if fname in ("Counter", "Gauge", "Histogram") and node.args:
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(
                first.value, str
            ):
                names.add(first.value)
    return names


def registered_metric_families(ctx: RepoContext):
    """(path, lineno, name) for every entry of a module-level
    ``METRIC_FAMILIES`` tuple/list under the package."""
    out = []
    for path in ctx.package_files():
        tree = ctx.tree(path)
        if tree is None:
            continue  # reported by the style pass
        for node in tree.body:
            if not (
                isinstance(node, ast.Assign)
                and any(
                    isinstance(t, ast.Name) and t.id == "METRIC_FAMILIES"
                    for t in node.targets
                )
                and isinstance(node.value, (ast.Tuple, ast.List))
            ):
                continue
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(
                    elt.value, str
                ):
                    out.append((path, elt.lineno, elt.value))
    return out


def metric_registry_findings(ctx: RepoContext) -> List[Finding]:
    if not ctx.path(METRICS_MODULE).exists():
        return []
    declared = declared_metric_families(ctx)
    registered = registered_metric_families(ctx)
    findings = []
    for path, lineno, name in registered:
        if name not in declared:
            findings.append(Finding(
                "metric-registry", ctx.rel(path), lineno,
                f"metric family '{name}' is registered but not declared "
                "in observability/metrics.py",
                hint="declare the Counter/Gauge/Histogram in "
                     "PrometheusMetrics, or drop the registry entry",
            ))
    registered_names = {name for _p, _l, name in registered}
    for prefix, registry in sorted(REGISTRY_OWNED_PREFIXES.items()):
        for name in sorted(declared):
            if name.startswith(prefix) and name not in registered_names:
                findings.append(Finding(
                    "metric-registry", METRICS_MODULE, 0,
                    f"metric family '{name}' is declared but missing "
                    f"from {registry}'s METRIC_FAMILIES registry",
                    hint=f"add '{name}' to METRIC_FAMILIES in {registry}",
                ))
    return findings


def native_phase_findings(ctx: RepoContext) -> List[Finding]:
    plane = ctx.path(NATIVE_PLANE_MODULE)
    if not plane.exists() or not ctx.path(METRICS_MODULE).exists():
        return []
    phases = ctx.module_string_tuple(plane, "PHASES")
    registered = set(ctx.module_string_tuple(plane, "METRIC_FAMILIES"))
    declared = declared_metric_families(ctx)
    findings = []
    for phase in phases:
        family = f"native_phase_{phase}"
        if family not in declared:
            findings.append(Finding(
                "native-phases", NATIVE_PLANE_MODULE, 0,
                f"PHASES entry '{phase}' has no '{family}' histogram "
                "family declared in observability/metrics.py",
                hint="a phase without its family silently drops that "
                     "phase's drain — declare the histogram",
            ))
        if family not in registered:
            findings.append(Finding(
                "native-phases", NATIVE_PLANE_MODULE, 0,
                f"PHASES entry '{phase}' has no '{family}' entry in "
                "METRIC_FAMILIES",
                hint=f"register '{family}' in native_plane's "
                     "METRIC_FAMILIES",
            ))
    return findings


def _debug_section_pairs(ctx: RepoContext, path: Path, name: str):
    """First elements of a module-level ``NAME = (("k", "attr"), ...)``
    tuple-of-pairs assignment."""
    tree = ctx.tree(path)
    if tree is None:
        return []
    out: List[str] = []
    for node in tree.body:
        if not (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets
            )
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            continue
        for elt in node.value.elts:
            if (
                isinstance(elt, (ast.Tuple, ast.List)) and elt.elts
                and isinstance(elt.elts[0], ast.Constant)
                and isinstance(elt.elts[0].value, str)
            ):
                out.append(elt.elts[0].value)
    return out


def debug_section_findings(ctx: RepoContext) -> List[Finding]:
    api_path = ctx.path(HTTP_API_MODULE)
    if not api_path.exists():
        return []
    registered = set(
        ctx.module_string_tuple(api_path, "DEBUG_STATS_SECTIONS")
    )
    served: dict = {}  # name -> lineno
    for table in DEBUG_PAIR_TABLES:
        for name in _debug_section_pairs(ctx, api_path, table):
            served.setdefault(name, 0)
    tree = ctx.tree(api_path)
    if tree is None:
        return []
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Subscript)
        ):
            continue
        target = node.targets[0]
        if not (
            isinstance(target.value, ast.Name)
            and target.value.id == "stats"
        ):
            continue
        sl = target.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
            served.setdefault(sl.value, node.lineno)
    findings = []
    for name, lineno in sorted(served.items()):
        if name not in registered:
            findings.append(Finding(
                "debug-sections", HTTP_API_MODULE, lineno,
                f"/debug/stats section '{name}' is served but missing "
                "from DEBUG_STATS_SECTIONS",
                hint="register it so dashboards and benches can rely "
                     "on the section set",
            ))
    for name in sorted(registered - set(served)):
        findings.append(Finding(
            "debug-sections", HTTP_API_MODULE, 0,
            f"DEBUG_STATS_SECTIONS entry '{name}' is registered but "
            "never served by get_debug_stats",
            hint="serve the section or drop the registration",
        ))
    return findings


def _debug_routes(ctx: RepoContext, path: Path):
    """(route, lineno) for every ``/debug/*`` string literal passed to
    ``router.add_get``/``add_post`` in the HTTP API module."""
    tree = ctx.tree(path)
    out = []
    if tree is None:
        return out
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("add_get", "add_post")
            and node.args
        ):
            continue
        first = node.args[0]
        if (
            isinstance(first, ast.Constant)
            and isinstance(first.value, str)
            and first.value.startswith("/debug")
        ):
            out.append((first.value, node.lineno))
    return out


def docs_sync_findings(ctx: RepoContext) -> List[Finding]:
    """Every telemetry surface must appear in docs/observability.md or
    in README's port section: each EVENT_KINDS entry, each registered
    METRIC_FAMILIES family, and each /debug route the HTTP API serves. A
    surface shipped without its doc line is invisible to the operator
    who needs it during an incident. Trees without the doc (synthetic
    fixtures) are exempt."""
    doc_path = ctx.path(OBSERVABILITY_DOC)
    if not doc_path.exists():
        return []
    doc = ctx.source(doc_path) + port_doc_section(
        ctx.source(ctx.path(PORT_DOC)))
    findings = []
    events_path = ctx.path(EVENTS_MODULE)
    if events_path.exists():
        for kind in ctx.module_string_tuple(events_path, "EVENT_KINDS"):
            if f"`{kind}`" not in doc and kind not in doc:
                findings.append(Finding(
                    "docs-sync", EVENTS_MODULE, 0,
                    f"event kind '{kind}' is not documented in "
                    f"{OBSERVABILITY_DOC} or {PORT_DOC}",
                    hint="add it to the event-kind enumeration",
                ))
    for path, lineno, family in registered_metric_families(ctx):
        if family not in doc:
            findings.append(Finding(
                "docs-sync", ctx.rel(path), lineno,
                f"metric family '{family}' is not documented in "
                f"{OBSERVABILITY_DOC} or {PORT_DOC}",
                hint="name the family in the doc's metrics coverage",
            ))
    api_path = ctx.path(HTTP_API_MODULE)
    if api_path.exists():
        for route, lineno in _debug_routes(ctx, api_path):
            if route not in doc:
                findings.append(Finding(
                    "docs-sync", HTTP_API_MODULE, lineno,
                    f"debug endpoint '{route}' is not documented in "
                    f"{OBSERVABILITY_DOC} or {PORT_DOC}",
                    hint="add an endpoint row to README's port section",
                ))
    return findings


@register_pass(
    "metric-registry",
    "subsystem METRIC_FAMILIES registries vs PrometheusMetrics "
    "declarations, both directions",
)
def run_metric_registry(ctx: RepoContext) -> List[Finding]:
    return metric_registry_findings(ctx)


@register_pass(
    "native-phases",
    "native telemetry PHASES entries each need a declared + registered "
    "native_phase_* family",
)
def run_native_phases(ctx: RepoContext) -> List[Finding]:
    return native_phase_findings(ctx)


@register_pass(
    "debug-sections",
    "/debug/stats served sections vs the DEBUG_STATS_SECTIONS registry, "
    "both directions",
)
def run_debug_sections(ctx: RepoContext) -> List[Finding]:
    return debug_section_findings(ctx)


@register_pass(
    "docs-sync",
    "every event kind, registered metric family and /debug endpoint "
    "must appear in docs/observability.md or README's port section",
)
def run_docs_sync(ctx: RepoContext) -> List[Finding]:
    return docs_sync_findings(ctx)
