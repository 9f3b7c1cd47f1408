"""Lock-order and blocking-in-async analyzer over the port's locks.

The port's serving path spans named threading-lock domains: the storage
lock (``device/storage.py`` / ``device/sharded.py`` ``_lock``, the
tiered facade's inherited one), the native-lane lock
(``_native_lock``), the lease broker's, the observatory's, the plan
cache's, the tier manager's, the membership coordinator's
(``server/resize.py``), the peer-health lock, the capacity
controller's. Their canonical order is a
convention, the JAX package's::

    control -> peering -> join -> tier -> broker -> native -> storage
        -> plan_cache

This pass extracts the acquisition graph from the AST (nested ``with``
statements, plus interprocedural propagation through same-class method
calls and package-unique function names) and:

* **rejects cycles** between the named domains, and edges that invert
  the canonical order (a cycle waiting for its second half);
* flags **``await`` while holding a threading lock** (the coroutine
  parks with the lock held; ``asyncio.Lock`` is excluded by
  construction: only attributes assigned ``threading.Lock()`` /
  ``threading.RLock()`` count);
* flags **blocking calls while holding a lock** (``time.sleep``,
  ``.wait()``, ``.wait_for()``, ``.result()``, the blocking
  ``h2i_take``) outside the explicit allowlist;
* holds every **leaf lock** (``LEAF_LOCKS``: a lock that guards its own
  object's state and is never held across another lock) to that, and
  every **outer lock** (``OUTER_LOCKS``) to the locks its entry names:
  any other acquisition under one, direct or through a call, is a
  finding, and the cycle check runs over them as over the domains;
* flags a threading-lock attribute of the package that has no domain
  and no leaf or outer entry (**unclassified lock**): a new lock states
  its place before it ships;
* reports the **observatory drain thread's lock holds**: its drain runs
  B5 and the slot attribution under the storage lock by design, so the
  finding exists and is suppressed by an allowlist entry that names the
  test bounding the hold, never passed silently.

Allowlisted findings carry ``suppressed_by`` (visible in ``--json`` and
``--show-suppressed``). Counterpart of
``limitador_tpu/tools/analysis/lock_order.py``: the same domains and
order, and the same drain allowlist, at the port's paths. The port's
other locks (the admission plane's, the serving shards' registries, the
pod's, the peer lane's latency and degraded ledgers, the ingress's
context lock, ...) are leaves, or outer locks that name what they hold
(the compiled pipeline's evaluation lock, the serving-model fit's, the
checkpointer's, the coordinator's apply lock).
"""

from __future__ import annotations

import ast
import builtins
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import PACKAGE, Finding, RepoContext, register_pass

__all__ = [
    "TRACKED_DOMAINS", "CANONICAL_ORDER", "ALLOWLIST", "LockAllow",
    "MODULE_SELF_DOMAINS", "LEAF_LOCKS", "OUTER_LOCKS", "DRAIN_ENTRY",
    "lock_order_findings",
]

_P = PACKAGE

#: the named lock domains the acquisition graph is built over.
#: ``peering`` is the pod's peer-health lock: on the forwarded-decision
#: path, an outermost hold with no sync waits and no storage-plane
#: acquisitions under it.
TRACKED_DOMAINS = (
    "control", "peering", "join", "tier", "broker", "native", "storage",
    "plan_cache", "observatory",
)

#: the canonical acquisition order (outermost first); the graph may use
#: any order-compatible subset, never the reverse. ``control`` (the
#: capacity controller's ring lock) is outermost by construction and a
#: leaf in practice: the tick calls every actuator (which take the join,
#: broker and storage locks) outside it.
CANONICAL_ORDER = (
    "control", "peering", "join", "tier", "broker", "native", "storage",
    "plan_cache",
)

#: attribute name -> domain, whatever the receiver (``_native_lock`` is
#: the native pipeline's alone)
ATTR_DOMAINS = {
    "_native_lock": "native",
}

#: (module relpath, ``self`` attr) -> domain for the generically named
#: ``self._lock`` attributes
MODULE_SELF_DOMAINS = {
    (f"{_P}/device/storage.py", "_lock"): "storage",
    (f"{_P}/device/sharded.py", "_lock"): "storage",
    (f"{_P}/lease/broker.py", "_lock"): "broker",
    (f"{_P}/observability/usage.py", "_lock"): "observatory",
    (f"{_P}/device/plan_cache.py", "_lock"): "plan_cache",
    (f"{_P}/server/peering.py", "_health_lock"): "peering",
    # tiers: the facade's inherited storage lock guards both tiers; only
    # the migration thread owns the tier lock
    (f"{_P}/tier/storage.py", "_lock"): "storage",
    (f"{_P}/tier/manager.py", "_lock"): "tier",
    # the membership plane's coordinator lock (resize and join share
    # one state machine); held for state flips only: the ship and
    # migrate RPCs, the kernel warm-up and every admin call run outside
    (f"{_P}/server/resize.py", "_lock"): "join",
    # the capacity controller: the decision ring and counters; actuator
    # calls run outside it (see CANONICAL_ORDER)
    (f"{_P}/control/controller.py", "_lock"): "control",
    (f"{_P}/control/actuator.py", "_lock"): "control",
}

#: receiver NAME -> domain for cross-object acquisitions
#: (``storage._lock`` / ``self.storage._lock`` from the pipeline, broker
#: and lease modules all mean the device table's lock)
OWNER_NAME_DOMAINS = {
    "storage": "storage",
}

#: (module relpath, ``self`` attr) -> why the lock is a leaf: it guards
#: its own object's state and is never held across another lock of the
#: port (the pass checks that no acquisition happens under it, directly
#: or through a call it can resolve; a library's internal locks, the C
#: lanes' mutexes among them, are not the port's). A cross-object use
#: (``guard._degraded_lock``) is recognised by its attribute name when
#: that name belongs to one entry alone.
LEAF_LOCKS: Dict[Tuple[str, str], str] = {
    (f"{_P}/admission/breaker.py", "_lock"):
        "the breaker's state machine and its window counters; "
        "transition callbacks run after the release",
    (f"{_P}/admission/controller.py", "_shed_lock"):
        "the shed tallies and the recent-shed ring (read by the signal "
        "bus, signals.py, under nothing else)",
    (f"{_P}/admission/overload.py", "_lock"):
        "the overload limiter's in-flight count and adaptive limit",
    (f"{_P}/device/batcher.py", "_shards_lock"):
        "the serving loops' shard registry (one MicroBatcher a loop)",
    (f"{_P}/device/native_pipeline.py", "_shards_lock"):
        "the serving loops' shard registry of the native pipeline",
    (f"{_P}/device/pipeline.py", "_shards_lock"):
        "the serving loops' shard registry of the compiled pipeline",
    (f"{_P}/native/ingress.py", "_ctx_lock"):
        "the ingress's C context pointer against its close: the pump "
        "and the stats readers take it for one C call each",
    (f"{_P}/observability/device_plane.py", "_lock"):
        "the flight recorder's ring and tallies",
    (f"{_P}/observability/events.py", "_lock"):
        "the pod event ring and its sequence number",
    (f"{_P}/observability/flight.py", "_fire_lock"):
        "the trigger's last-fire clock a rule (the debounce)",
    (f"{_P}/observability/flight.py", "_lock"):
        "a flight ring's deque, or the spool directory's listing",
    (f"{_P}/observability/model.py", "_ingest_lock"):
        "the serving-model fit's pending-batch queue (ingest is a "
        "bounded append)",
    (f"{_P}/observability/native_plane.py", "_lock"):
        "the native plane's slice ring and its C histogram baselines",
    (f"{_P}/observability/otlp.py", "_count_lock"):
        "the OTLP exporter's accepted/dropped counters",
    (f"{_P}/observability/otlp.py", "_lock"):
        "one span's attributes and end state",
    (f"{_P}/observability/pod_plane.py", "_lock"):
        "the hop-phase histograms and the federated signal cache",
    (f"{_P}/observability/signals.py", "_lock"):
        "the signal bus's timeline ring and its recorder binding",
    (f"{_P}/parallel/pod.py", "_lock"):
        "the pod's formation info, the peer channel cache, or the psum "
        "lane's exchange state (one per class)",
    (f"{_P}/routing.py", "_lock"):
        "the router's pinned namespaces and its routing tallies",
    (f"{_P}/server/peering.py", "_degraded_lock"):
        "the degraded stand-in's journal of deltas for a dead owner",
    (f"{_P}/server/peering.py", "_latency_lock"):
        "the peer lane's latency window (the render thread sorts a "
        "copy)",
    (f"{_P}/storage/authority.py", "_lock"):
        "the authority's decoded-limit cache and its RPC stats",
    (f"{_P}/storage/base.py", "_lock"):
        "the limits registry of a storage (add, remove, reads)",
    (f"{_P}/storage/disk.py", "_lock"):
        "the SQLite connection and its transaction",
    (f"{_P}/storage/distributed/__init__.py", "_lock"):
        "the CRDT node's counter maps",
    (f"{_P}/storage/failover.py", "_lock"):
        "the failover ledger (deltas journaled while the oracle "
        "decides)",
    (f"{_P}/storage/in_memory.py", "_lock"):
        "the in-memory storage's counter maps",
}

#: (module relpath, ``self`` attr) -> (why, the locks it may hold): a
#: lock that is not a leaf because it holds the named locks, and only
#: those, under it by design (a domain name or ``module:attr`` of a
#: leaf). The pass checks every acquisition under it against the list,
#: and the cycle check runs over these locks and the leaves as well as
#: the domains.
OUTER_LOCKS: Dict[Tuple[str, str], Tuple[str, Tuple[str, ...]]] = {
    (f"{_P}/device/pipeline.py", "_eval_lock"): (
        "serializes the compilers' cache and the columnar CEL "
        "evaluation; a limits change bumps the counter-plan cache's "
        "epoch under it, so that no batch files a plan under the new "
        "epoch from the old compiler",
        ("plan_cache",),
    ),
    (f"{_P}/observability/model.py", "_fit_lock"): (
        "the fit's coefficients; a refit drains the ingest queue and "
        "emits the drift event under it, so that readers see one fit",
        (f"{_P}/observability/model.py:_ingest_lock",
         f"{_P}/observability/events.py:_lock"),
    ),
    (f"{_P}/server/__main__.py", "_mutex"): (
        "the checkpointer's tmp file: a periodic and the final write "
        "never share it; the snapshot takes the storage lock under it",
        ("storage",),
    ),
    (f"{_P}/server/resize.py", "_apply_lock"): (
        "serializes a migrated slice's ledger diff, apply and record; "
        "the ledger itself is the coordinator's, under the join lock",
        ("join",),
    ),
}

#: blocking call detection while a lock is held: exact dotted names and
#: method-attribute names, the JAX package's, kept narrow (false
#: positives train people to allowlist by reflex)
BLOCKING_DOTTED = {"time.sleep"}
BLOCKING_ATTRS = {"wait", "wait_for", "result", "h2i_take"}

#: the observatory drain's entry point: (module relpath, class, method).
#: Everything its call graph acquires is reported (rule
#: "drain-thread-lock"), so a drain that starts holding a new lock
#: surfaces at once.
DRAIN_ENTRY = (
    f"{_P}/observability/usage.py",
    "TenantUsageObservatory",
    "drain",
)


@dataclasses.dataclass(frozen=True)
class LockAllow:
    """One explicit allowlist entry: rule, place, and why the pattern is
    sound (with the test that bounds it)."""

    rule: str       #: "blocking-under-lock" | "drain-thread-lock"
    module: str     #: repo-relative module the finding lands in
    qualname: str   #: enclosing function qualname ("" = any in module)
    needle: str     #: substring of the finding message ("" = any)
    reason: str


ALLOWLIST: Tuple[LockAllow, ...] = (
    # The usage drain holds the storage lock by design: B5's top-k drain
    # and the slot attribution need slot identity, and the leased-usage
    # merge resolves plans under the native lock. The hold is bounded:
    # tests/test_torch_usage.py holds the drain to the JAX observatory's
    # answers drain by drain, and the JAX package's perf smoke holds the
    # same design to USAGE_DRAIN_BUDGET_MS = 50.0.
    LockAllow(
        rule="drain-thread-lock",
        module=f"{_P}/observability/usage.py",
        qualname="TenantUsageObservatory.drain",
        needle="'storage'",
        reason="by design: B5 and the slot attribution need slot "
               "identity under the storage lock; the drain is held to "
               "the JAX observatory by tests/test_torch_usage.py, whose "
               "design the JAX perf smoke bounds by "
               "USAGE_DRAIN_BUDGET_MS=50.0",
    ),
    LockAllow(
        rule="drain-thread-lock",
        module=f"{_P}/observability/usage.py",
        qualname="TenantUsageObservatory.drain",
        needle="'native'",
        reason="by design: the leased-usage merge resolves plans under "
               "the native lock; the same USAGE_DRAIN_BUDGET_MS=50.0 "
               "bound",
    ),
    LockAllow(
        rule="drain-thread-lock",
        module=f"{_P}/observability/usage.py",
        qualname="TenantUsageObservatory.drain",
        needle="'plan_cache'",
        reason="plan-cache stats and invalidations reached through the "
               "storage hooks; bounded by the same drain budget",
    ),
)


def _lock_id(module: str, attr: str) -> str:
    """The graph node of a leaf or outer lock."""
    kind = "outer" if (module, attr) in OUTER_LOCKS else "leaf"
    return f"{kind}:{module}:{attr}"


def _holds_ids(holds: Sequence[str]) -> Set[str]:
    """Graph nodes of an OUTER_LOCKS entry's ``holds``."""
    out = set()
    for name in holds:
        module, sep, attr = name.rpartition(":")
        out.add(_lock_id(module, attr) if sep else name)
    return out


def _leaf_by_attr() -> Dict[str, str]:
    """Attribute name -> node, for the names that belong to one leaf or
    outer entry alone (a cross-object hold is recognised by its name)."""
    owners: Dict[str, List[Tuple[str, str]]] = {}
    for module, attr in [*LEAF_LOCKS, *OUTER_LOCKS, *MODULE_SELF_DOMAINS]:
        owners.setdefault(attr, []).append((module, attr))
    return {
        attr: _lock_id(*keys[0]) for attr, keys in owners.items()
        if len(keys) == 1 and keys[0] not in MODULE_SELF_DOMAINS
    }


_LEAF_BY_ATTR = _leaf_by_attr()


def _allow_reason(
    rule: str, module: str, qualname: str, message: str
) -> Optional[str]:
    for entry in ALLOWLIST:
        if entry.rule != rule or entry.module != module:
            continue
        if entry.qualname and entry.qualname != qualname:
            continue
        if entry.needle and entry.needle not in message:
            continue
        return entry.reason
    return None


# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FuncInfo:
    module: str
    qualname: str
    name: str
    cls: Optional[str]
    node: ast.AST
    is_async: bool
    #: domains acquired directly in this function's body
    acquires: Set[str] = dataclasses.field(default_factory=set)
    #: (held domain, acquired domain, lineno) direct nesting edges
    edges: List[Tuple[str, str, int]] = dataclasses.field(
        default_factory=list
    )
    #: (held domains snapshot, callee ref, lineno) calls under a lock
    locked_calls: List[Tuple[Tuple[str, ...], "CallRef", int]] = (
        dataclasses.field(default_factory=list)
    )
    #: (held domains, kind, detail, lineno) direct blocking findings
    blocking: List[Tuple[Tuple[str, ...], str, str, int]] = (
        dataclasses.field(default_factory=list)
    )
    #: every callee referenced anywhere in the body (for closures)
    calls: List["CallRef"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class CallRef:
    name: str          #: bare callee name (method or function)
    on_self: bool      #: ``self.name(...)``


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Collector(ast.NodeVisitor):
    """One module walk: find threading-lock attributes per class, then
    per-function acquisition/blocking facts."""

    def __init__(self, ctx: RepoContext, path, rel: str,
                 thread_lock_attrs: Set[str]):
        self.ctx = ctx
        self.path = path
        self.rel = rel
        self.thread_lock_attrs = thread_lock_attrs
        self.external = _external_names(ctx.nodes(path))
        self.funcs: Dict[str, FuncInfo] = {}
        self._cls_stack: List[str] = []
        self._fn_stack: List[FuncInfo] = []
        self._held: List[str] = []

    # -- structure -----------------------------------------------------------

    def visit_ClassDef(self, node):
        self._cls_stack.append(node.name)
        self.generic_visit(node)
        self._cls_stack.pop()

    def _visit_func(self, node, is_async: bool):
        cls = self._cls_stack[-1] if self._cls_stack else None
        qual = f"{cls}.{node.name}" if cls else node.name
        info = FuncInfo(
            module=self.rel, qualname=qual, name=node.name, cls=cls,
            node=node, is_async=is_async,
        )
        # nested defs fold into their parent's qualname slot only if
        # unique; last-in wins is fine for this analysis
        self.funcs[qual] = info
        self._fn_stack.append(info)
        held, self._held = self._held, []
        self.generic_visit(node)
        self._held = held
        self._fn_stack.pop()

    def visit_FunctionDef(self, node):
        self._visit_func(node, False)

    def visit_AsyncFunctionDef(self, node):
        self._visit_func(node, True)

    # -- lock classification -------------------------------------------------

    def _classify(self, expr: ast.AST) -> Optional[str]:
        """Domain name for a with-item context expression, or None when
        it is not a tracked threading lock."""
        if not isinstance(expr, ast.Attribute):
            return None
        attr = expr.attr
        if attr in ATTR_DOMAINS:
            return ATTR_DOMAINS[attr]
        owner = expr.value
        if isinstance(owner, ast.Name):
            if owner.id == "self":
                dom = MODULE_SELF_DOMAINS.get((self.rel, attr))
                if dom:
                    return dom
                if (self.rel, attr) in LEAF_LOCKS or (
                    self.rel, attr
                ) in OUTER_LOCKS:
                    return _lock_id(self.rel, attr)
                if attr in self.thread_lock_attrs:
                    return f"local:{self.rel}:{attr}"
                return None
            if attr == "_lock" and owner.id in OWNER_NAME_DOMAINS:
                return OWNER_NAME_DOMAINS[owner.id]
            return _LEAF_BY_ATTR.get(attr)
        if isinstance(owner, ast.Attribute):
            # self.storage._lock / pipeline.storage._lock
            if attr == "_lock" and owner.attr in OWNER_NAME_DOMAINS:
                return OWNER_NAME_DOMAINS[owner.attr]
            return _LEAF_BY_ATTR.get(attr)
        return None

    # -- acquisition ---------------------------------------------------------

    def _enter_with(self, node):
        acquired: List[str] = []
        for item in node.items:
            dom = self._classify(item.context_expr)
            if dom is None:
                continue
            fn = self._fn_stack[-1] if self._fn_stack else None
            if fn is not None:
                fn.acquires.add(dom)
                for held in self._held:
                    if held != dom:
                        fn.edges.append((held, dom, node.lineno))
            acquired.append(dom)
        return acquired

    def visit_With(self, node):
        acquired = self._enter_with(node)
        self._held.extend(acquired)
        self.generic_visit(node)
        for _ in acquired:
            self._held.pop()

    # async-with on a threading lock is nonsensical and would fail at
    # runtime; asyncio locks are untracked — just recurse
    visit_AsyncWith = visit_With

    # -- blocking ------------------------------------------------------------

    def visit_Await(self, node):
        fn = self._fn_stack[-1] if self._fn_stack else None
        if fn is not None and self._held:
            fn.blocking.append(
                (tuple(self._held), "await", "", node.lineno)
            )
        self.generic_visit(node)

    def visit_Call(self, node):
        fn = self._fn_stack[-1] if self._fn_stack else None
        if fn is not None:
            ref = None
            if isinstance(node.func, ast.Name):
                if node.func.id not in self.external:
                    ref = CallRef(node.func.id, False)
            elif isinstance(node.func, ast.Attribute) and not (
                isinstance(node.func.value, ast.Name)
                and node.func.value.id in self.external
            ):
                # ``os.replace(...)`` is the library's, never a package
                # method of that name; ``out.add(x)`` on another receiver
                # than self is taken for the container's own method
                on_self = (
                    isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"
                )
                if on_self or node.func.attr not in _CONTAINER_METHODS:
                    ref = CallRef(node.func.attr, on_self)
            if ref is not None:
                fn.calls.append(ref)
                if self._held:
                    fn.locked_calls.append(
                        (tuple(self._held), ref, node.lineno)
                    )
            if self._held:
                dotted = _dotted(node.func)
                attr = (
                    node.func.attr
                    if isinstance(node.func, ast.Attribute) else None
                )
                if dotted in BLOCKING_DOTTED:
                    fn.blocking.append(
                        (tuple(self._held), "call", dotted, node.lineno)
                    )
                elif attr in BLOCKING_ATTRS:
                    # str.join-style false positives don't apply: these
                    # attr names are sync primitives / futures only
                    fn.blocking.append(
                        (tuple(self._held), "call", attr, node.lineno)
                    )
        self.generic_visit(node)


#: method names of the builtin containers and strings: a call of one on
#: a receiver other than ``self`` is not resolved to a package function
#: of that name (``out.add(counter)`` is a set's, not a registry's)
_CONTAINER_METHODS = frozenset(
    name for kind in (set, dict, list, str, bytes, bytearray, tuple)
    for name in dir(kind) if not name.startswith("_")
)


def _external_names(nodes) -> Set[str]:
    """Names a module binds to code outside the package (absolute
    imports of other packages) and the builtins: a call through one
    never resolves to a package function of the same name."""
    out: Set[str] = set(dir(builtins))
    for node in nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] != PACKAGE:
                    out.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and (
            node.module or ""
        ).split(".")[0] != PACKAGE:
            for alias in node.names:
                out.add(alias.asname or alias.name)
    return out


def _thread_lock_sites(nodes) -> Dict[str, int]:
    """self.<attr> names assigned ``threading.Lock()`` / ``RLock()``
    anywhere in the module, each with the line of its first assignment
    (asyncio.Lock is deliberately excluded: it is awaited by design)."""
    out: Dict[str, int] = {}
    for node in nodes:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target = node.targets[0]
        value = node.value
        if not (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
            and isinstance(value, ast.Call)
        ):
            continue
        dotted = _dotted(value.func)
        if dotted in ("threading.Lock", "threading.RLock"):
            out.setdefault(target.attr, node.lineno)
    return out


# ---------------------------------------------------------------------------
# resolution + graph
# ---------------------------------------------------------------------------

def _closure(
    info: FuncInfo,
    by_class: Dict[Tuple[str, str], FuncInfo],
    by_name: Dict[str, List[FuncInfo]],
    memo: Dict[Tuple[str, str], Set[str]],
    stack: Set[Tuple[str, str]],
    union_ambiguous: bool,
) -> Set[str]:
    """Transitively-acquired domains of ``info``. Callee resolution is
    conservative-by-omission for the EDGE graph (self-calls resolve in
    the same class; other names only when package-unique) and
    conservative-by-union for the drain rule (``union_ambiguous``)."""
    key = (info.module, info.qualname)
    if key in memo:
        return memo[key]
    if key in stack:
        return set(info.acquires)  # recursion: direct only
    stack.add(key)
    out: Set[str] = set(info.acquires)
    for ref in info.calls:
        targets: List[FuncInfo] = []
        if ref.on_self and info.cls is not None:
            hit = by_class.get((info.cls, ref.name))
            if hit is not None:
                targets = [hit]
        if not targets:
            cands = by_name.get(ref.name, [])
            if len(cands) == 1:
                targets = cands
            elif union_ambiguous and 1 < len(cands) <= 8:
                targets = cands
        for t in targets:
            out |= _closure(
                t, by_class, by_name, memo, stack, union_ambiguous
            )
    stack.discard(key)
    memo[key] = out
    return out


def _find_cycles(edges: Dict[str, Set[str]]) -> List[List[str]]:
    cycles: List[List[str]] = []
    seen_cycles: Set[Tuple[str, ...]] = set()

    def dfs(start: str, node: str, path: List[str], visited: Set[str]):
        for nxt in sorted(edges.get(node, ())):
            if nxt == start:
                cyc = path + [start]
                key = tuple(sorted(cyc[:-1]))
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cycles.append(cyc)
            elif nxt not in visited:
                visited.add(nxt)
                dfs(start, nxt, path + [nxt], visited)
                visited.discard(nxt)

    for start in sorted(edges):
        dfs(start, start, [start], {start})
    return cycles


def lock_order_findings(
    ctx: RepoContext, modules: Optional[Sequence[str]] = None
) -> List[Finding]:
    files = (
        [ctx.path(m) for m in modules] if modules
        else ctx.package_files()
    )
    all_funcs: List[FuncInfo] = []
    lock_sites: Dict[str, Dict[str, int]] = {}
    for path in files:
        tree = ctx.tree(path)
        if tree is None:
            continue
        rel = ctx.rel(path)
        if rel.startswith(f"{_P}/tools/"):
            continue  # the analyzers themselves
        sites = _thread_lock_sites(ctx.nodes(path))
        lock_sites[rel] = sites
        collector = _Collector(ctx, path, rel, set(sites))
        collector.visit(tree)
        all_funcs.extend(collector.funcs.values())

    by_class: Dict[Tuple[str, str], FuncInfo] = {}
    by_name: Dict[str, List[FuncInfo]] = {}
    for info in all_funcs:
        if info.cls is not None:
            by_class[(info.cls, info.name)] = info
        by_name.setdefault(info.name, []).append(info)

    findings: List[Finding] = []
    edge_sites: Dict[Tuple[str, str], Tuple[str, int]] = {}
    edges: Dict[str, Set[str]] = {}

    def add_edge(a: str, b: str, module: str, lineno: int) -> None:
        if a == b:
            return
        edges.setdefault(a, set()).add(b)
        edge_sites.setdefault((a, b), (module, lineno))

    memo: Dict[Tuple[str, str], Set[str]] = {}
    for info in all_funcs:
        for held, acquired, lineno in info.edges:
            add_edge(held, acquired, info.module, lineno)
        for held_stack, ref, lineno in info.locked_calls:
            # propagate: calling f while holding L implies L -> every
            # domain f's closure acquires (strict resolution)
            targets: List[FuncInfo] = []
            if ref.on_self and info.cls is not None:
                hit = by_class.get((info.cls, ref.name))
                if hit is not None:
                    targets = [hit]
            else:
                cands = by_name.get(ref.name, [])
                if len(cands) == 1:
                    targets = cands
            for t in targets:
                acq = _closure(t, by_class, by_name, memo, set(), False)
                for dom in acq:
                    for held in held_stack:
                        add_edge(held, dom, info.module, lineno)

    # R1: cycles between tracked domains, leaves and outer locks
    def named(node: str) -> bool:
        return node in TRACKED_DOMAINS or node.startswith(
            ("leaf:", "outer:"))

    tracked_edges = {
        a: {b for b in bs if b in TRACKED_DOMAINS}
        for a, bs in edges.items() if a in TRACKED_DOMAINS
    }
    named_edges = {
        a: {b for b in bs if named(b)}
        for a, bs in edges.items() if named(a)
    }
    for cycle in _find_cycles(named_edges):
        first_site = edge_sites.get(
            (cycle[0], cycle[1]), (_P, 0)
        )
        findings.append(Finding(
            "lock-order", first_site[0], first_site[1],
            "lock acquisition cycle: " + " -> ".join(cycle)
            + f" (canonical order is {' -> '.join(CANONICAL_ORDER)})",
            hint="re-nest so every path acquires along the canonical "
                 "order; if a new pairing is needed, re-derive the "
                 "order and update CANONICAL_ORDER",
        ))

    # R1b: tracked edges that invert the canonical order (a cycle
    # waiting for its second half)
    rank = {d: i for i, d in enumerate(CANONICAL_ORDER)}
    for a, bs in sorted(tracked_edges.items()):
        for b in sorted(bs):
            if a in rank and b in rank and rank[a] > rank[b]:
                mod, lineno = edge_sites[(a, b)]
                msg = (
                    f"acquisition edge '{a}' -> '{b}' inverts the "
                    f"canonical order {' -> '.join(CANONICAL_ORDER)}"
                )
                findings.append(Finding(
                    "lock-order", mod, lineno, msg,
                    hint="take the outer lock first or split the "
                         "critical section",
                ))

    # R2/R3: await / blocking calls while holding a threading lock
    for info in all_funcs:
        for held_stack, kind, detail, lineno in info.blocking:
            if ctx.noqa(ctx.path(info.module), lineno):
                continue
            held_desc = ", ".join(f"'{h}'" for h in held_stack)
            if kind == "await":
                msg = (
                    f"await while holding threading lock(s) "
                    f"{held_desc} in {info.qualname}: the coroutine "
                    "parks with the lock held and every thread on it "
                    "stalls for the suspension"
                )
                hint = ("release the lock before awaiting, or make the "
                        "guarded state loop-local")
            else:
                msg = (
                    f"blocking call '{detail}' while holding "
                    f"{held_desc} in {info.qualname}"
                )
                hint = ("move the blocking call outside the critical "
                        "section, or add an explicit LockAllow entry "
                        "citing the budget that bounds the hold")
            reason = _allow_reason(
                "blocking-under-lock", info.module, info.qualname, msg
            )
            findings.append(Finding(
                "lock-order", info.module, lineno, msg, hint=hint,
                suppressed_by=(
                    f"allowlist: {reason}" if reason else None
                ),
            ))

    # R4: the observatory drain thread's lock holds — explicit, never
    # silent. Union-resolution: ambiguous callees (drain_hot_slots is
    # defined per storage flavor) conservatively merge.
    drain_mod, drain_cls, drain_name = DRAIN_ENTRY
    entry = next(
        (f for f in all_funcs
         if f.module == drain_mod and f.cls == drain_cls
         and f.name == drain_name),
        None,
    )
    if entry is not None:
        union_memo: Dict[Tuple[str, str], Set[str]] = {}
        acq = _closure(entry, by_class, by_name, union_memo, set(), True)
        # the observatory's own lock is the drain's to hold; the rule
        # is about the SHARED serving-path locks it reaches out to
        for dom in sorted(acq & set(TRACKED_DOMAINS) - {"observatory"}):
            msg = (
                f"observatory drain thread acquires '{dom}' (via "
                f"{entry.qualname}): the flush path serializes behind "
                "every drain pass"
            )
            reason = _allow_reason(
                "drain-thread-lock", drain_mod, entry.qualname, msg
            )
            findings.append(Finding(
                "lock-order", drain_mod, entry.node.lineno, msg,
                hint="keep the hold inside the perf-smoke drain "
                     "budget, or move the work off the lock",
                suppressed_by=(
                    f"allowlist: {reason}" if reason else None
                ),
            ))

    # R5: a leaf held across any other acquisition, an outer lock
    # across one its entry does not name (directly or through a call)
    for a, bs in sorted(edges.items()):
        kind, _sep, rest = a.partition(":")
        if kind not in ("leaf", "outer"):
            continue
        module, _sep, attr = rest.rpartition(":")
        allowed = (
            _holds_ids(OUTER_LOCKS[(module, attr)][1])
            if kind == "outer" else set()
        )
        for b in sorted(bs - allowed):
            mod, lineno = edge_sites[(a, b)]
            if ctx.noqa(ctx.path(mod), lineno):
                continue
            what = (
                "a leaf guards its own state and takes no other lock"
                if kind == "leaf" else
                "its OUTER_LOCKS entry does not name that lock"
            )
            findings.append(Finding(
                "lock-order", mod, lineno,
                f"{kind} lock '{attr}' of {module} is held across "
                f"'{b}': {what}",
                hint="release the lock before the call, or state the "
                     "nesting in OUTER_LOCKS (or a domain in "
                     "MODULE_SELF_DOMAINS with its place in "
                     "CANONICAL_ORDER)",
            ))

    # R6: every threading lock of the package states its place
    for rel, sites in sorted(lock_sites.items()):
        for attr, lineno in sorted(sites.items()):
            if attr in ATTR_DOMAINS or (rel, attr) in MODULE_SELF_DOMAINS \
                    or (rel, attr) in LEAF_LOCKS \
                    or (rel, attr) in OUTER_LOCKS:
                continue
            if ctx.noqa(ctx.path(rel), lineno):
                continue
            findings.append(Finding(
                "lock-order", rel, lineno,
                f"threading lock '{attr}' has no domain and is not a "
                "declared leaf or outer lock",
                hint="add it to lock_order.LEAF_LOCKS with the reason it "
                     "is a leaf (or OUTER_LOCKS with what it holds), or to "
                     "MODULE_SELF_DOMAINS with its place in "
                     "CANONICAL_ORDER",
            ))
    return findings


@register_pass(
    "lock-order",
    "acquisition-graph cycles, canonical-order inversions, await/"
    "blocking calls under threading locks, leaf locks held across "
    "another, unclassified locks, drain-thread lock holds",
)
def run(ctx: RepoContext) -> List[Finding]:
    return lock_order_findings(ctx)
