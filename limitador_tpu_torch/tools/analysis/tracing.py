"""Tracing-safety pass for the port's hot modules.

One stray host sync on the decision path costs a served p99. The JAX
package's pass (``limitador_tpu/tools/analysis/tracing.py``) guards the
``jax.jit`` idiom: ``block_until_ready``, an implicit ``np.asarray`` of
a device array, un-padded launches that recompile, ``shard_map`` sites
without donation. The port has no ``jax.jit``, no recompiles and no
donation, so ``donation.py`` and the ``shard_map`` rule have no
counterpart here; their place is taken by two rules in the port's
idiom:

* **no-host-sync**: a function of a hot module whose name starts with a
  decision prefix (the begin or submit side; the finish side owns the
  wait by definition) may not call ``torch.cuda.synchronize``,
  ``.synchronize()`` (a stream's or an event's), ``.item()`` or
  ``.cpu()``: each blocks the calling thread until the card has run
  everything queued before it.
* **kernel-launch-locality**: a CUDA entry point (``lib.ct_*``, or any
  ``.ct_*`` attribute call) is called only in the modules that bind and
  wrap them (``LAUNCH_MODULES``: ``ops/build.py``, ``ops/kernel.py``,
  and ``parallel/mesh.py`` for B7's wrappers), and the wrappers of
  ``ops/kernel.py`` only from their owner modules
  (``KERNEL_OWNER_MODULES``, the counterparts of the JAX package's):
  every launch counts in ``K.launches`` and runs on the stream its
  storage owns (``TorchStorage._on_device``), which a launch from
  anywhere else would bypass. Reading a kernel constant
  (``K.CLUSTER_MIN_HITS``) or a class (``K.TableContext``) is fine;
  only calls of module functions are flagged.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from . import PACKAGE, Finding, RepoContext, register_pass
from .lock_order import _dotted

__all__ = [
    "HOT_MODULES", "DECISION_PREFIXES", "HOST_SYNC_ATTRS",
    "LAUNCH_MODULES", "KERNEL_OWNER_MODULES", "tracing_findings",
]

_P = PACKAGE

#: modules on the serving hot path (the no-host-sync rule applies): the
#: JAX package's HOT_MODULES at the port's paths (``tpu/`` is the port's
#: ``device/``), with the replicated storage and the native pod's
#: frontend, which the port's decisions also run through
HOT_MODULES = (
    f"{_P}/device/native_pipeline.py",
    f"{_P}/device/storage.py",
    f"{_P}/device/sharded.py",
    f"{_P}/device/batcher.py",
    f"{_P}/device/plan_cache.py",
    f"{_P}/device/pipeline.py",
    f"{_P}/device/replicated.py",
    f"{_P}/native/ingress.py",
    f"{_P}/routing.py",
    f"{_P}/server/peering.py",
    f"{_P}/parallel/pod.py",
    f"{_P}/parallel/mesh.py",
    # the pod plane's hop recording and event emission run per
    # forwarded decision; aggregation stays off the decision path
    f"{_P}/observability/pod_plane.py",
    f"{_P}/observability/events.py",
    # the serving-model fit's ingest rides every batch collect
    f"{_P}/observability/model.py",
    # the coordinator's decision-path surface is the epoch check per
    # forward; migration runs on its own threads
    f"{_P}/server/resize.py",
    # the joiner's surface is one attribute read per forwarded decision
    f"{_P}/server/standby.py",
    # cold-tier decisions ride the big-limit host lane per batch
    f"{_P}/tier/storage.py",
    f"{_P}/tier/manager.py",
    f"{_P}/tier/cold.py",
    # knob writes land on the subsystems' hot paths
    f"{_P}/control/controller.py",
    f"{_P}/control/actuator.py",
    f"{_P}/control/policy.py",
)

#: function-name prefixes that mark the decision path, the JAX package's
#: (``limitador_tpu/tools/analysis/tracing.py``)
DECISION_PREFIXES = (
    "decide", "submit", "begin_", "_begin", "pad_hits",
    "forward", "_forward", "_remote", "_degraded",
    "check_and_update", "is_rate_limited", "update_counters",
)

#: method names that wait for the card from the host
HOST_SYNC_ATTRS = ("synchronize", "item", "cpu")

#: the modules that may call a CUDA entry point: the binder and the
#: wrappers (B7's live in parallel/mesh.py, as the JAX package's B7
#: programs do)
LAUNCH_MODULES = (
    f"{_P}/ops/build.py",
    f"{_P}/ops/kernel.py",
    f"{_P}/parallel/mesh.py",
)

#: modules allowed to call ops/kernel.py's wrappers: the JAX package's
#: KERNEL_OWNER_MODULES at the port's paths, and ``ops/ab.py``, the
#: two-tree timing tool, which times the wrappers themselves
KERNEL_OWNER_MODULES = (
    f"{_P}/ops/kernel.py",
    f"{_P}/ops/ab.py",
    f"{_P}/device/storage.py",
    f"{_P}/device/sharded.py",
    f"{_P}/device/replicated.py",
    f"{_P}/parallel/mesh.py",
    f"{_P}/server/standby.py",
)

KERNEL_MODULE = f"{_P}/ops/kernel.py"


def _kernel_function_names(ctx: RepoContext) -> Set[str]:
    """The public module-level functions of ops/kernel.py."""
    tree = ctx.tree(ctx.path(KERNEL_MODULE))
    if tree is None:
        return set()
    return {
        node.name for node in tree.body
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        and not node.name.startswith("_")
    }


def _kernel_aliases(nodes) -> Set[str]:
    """Names the module binds to ops.kernel (``from ..ops import kernel
    as K`` / ``import ...ops.kernel as kernel``)."""
    out: Set[str] = set()
    for node in nodes:
        if isinstance(node, ast.ImportFrom) and node.module and (
            node.module.endswith("ops") or node.module.endswith("ops.kernel")
        ):
            for alias in node.names:
                if alias.name == "kernel" or node.module.endswith(
                    "ops.kernel"
                ):
                    out.add(alias.asname or alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.endswith("ops.kernel"):
                    out.add(alias.asname or alias.name.split(".")[0])
    return out


def _host_sync(node: ast.Call) -> Optional[str]:
    """The spelling of a host sync, or None."""
    fn = node.func
    if not isinstance(fn, ast.Attribute) or fn.attr not in HOST_SYNC_ATTRS:
        return None
    if fn.attr == "synchronize":
        return _dotted(fn) or ".synchronize()"
    if node.args or node.keywords:
        return None  # .item(x) / .cpu(x) are not the tensor methods
    return f".{fn.attr}()"


def _sync_findings(ctx: RepoContext) -> List[Finding]:
    findings: List[Finding] = []
    for rel in HOT_MODULES:
        path = ctx.path(rel)
        if ctx.tree(path) is None:
            continue
        spans = []
        for node in ctx.nodes(path):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) and node.name.startswith(DECISION_PREFIXES):
                end = getattr(node, "end_lineno", node.lineno)
                spans.append((node.lineno, end, node.name))

        def decision_fn(lineno: int) -> Optional[str]:
            inner = None
            for lo, hi, name in spans:
                if lo <= lineno <= hi and (inner is None or lo > inner[0]):
                    inner = (lo, name)
            return None if inner is None else inner[1]

        for node in ctx.nodes(path):
            if not isinstance(node, ast.Call):
                continue
            spelling = _host_sync(node)
            if spelling is None:
                continue
            where = decision_fn(node.lineno)
            if where is None or ctx.noqa(path, node.lineno):
                continue
            findings.append(Finding(
                "tracing-safety", rel, node.lineno,
                f"host sync {spelling} on the decision path ('{where}'): "
                "the thread waits for everything queued on the card",
                hint="move the wait to the finish side (an event the "
                     "collect waits on), or read the value from a host "
                     "copy the begin already holds",
            ))
    return findings


def _launch_findings(ctx: RepoContext) -> List[Finding]:
    findings: List[Finding] = []
    kernel_fns = _kernel_function_names(ctx)
    for path in ctx.package_files():
        rel = ctx.rel(path)
        if rel.startswith(f"{_P}/tools/") or ctx.tree(path) is None:
            continue
        aliases = (
            _kernel_aliases(ctx.nodes(path))
            if kernel_fns and rel not in KERNEL_OWNER_MODULES else set()
        )
        for node in ctx.nodes(path):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr.startswith("ct_") and rel not in LAUNCH_MODULES:
                if ctx.noqa(path, node.lineno):
                    continue
                findings.append(Finding(
                    "tracing-safety", rel, node.lineno,
                    f"CUDA entry point '{attr}' called outside the kernel "
                    "wrappers: the launch bypasses K.launches and the "
                    "storage's stream",
                    hint="call the wrapper in ops/kernel.py (or "
                         "parallel/mesh.py) that counts and launches it",
                ))
                continue
            if (
                aliases
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in aliases
                and attr in kernel_fns
                and not ctx.noqa(path, node.lineno)
            ):
                findings.append(Finding(
                    "tracing-safety", rel, node.lineno,
                    f"direct kernel launch '{attr}' outside the owner "
                    "modules: the storage that owns the table owns its "
                    "stream, its lock and its launch counts",
                    hint="route the launch through TorchStorage/"
                         "TorchShardedStorage/TorchReplicatedStorage",
                ))
    return findings


def tracing_findings(ctx: RepoContext) -> List[Finding]:
    return _sync_findings(ctx) + _launch_findings(ctx)


@register_pass(
    "tracing-safety",
    "no torch host syncs (.item/.cpu/synchronize) on the decision path, "
    "CUDA entry points and kernel wrappers called only from their owners",
)
def run(ctx: RepoContext) -> List[Finding]:
    return tracing_findings(ctx)
