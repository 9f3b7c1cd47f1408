"""Limit compiler: CEL predicates -> vectorized masks over interned tokens.

Port counterpart of ``limitador_tpu/tpu/compiler.py``, copied with its
imports kept package-relative.

The reference interprets CEL per limit per request on the hot path
(upstream limitador/src/limit.rs:157-174, limit/cel.rs:321-339). At
high decision rates that is the bottleneck, so the common predicate
shapes compile to columnar operations over a whole micro-batch
(SURVEY.md §7 "hard parts"):

- string values intern to int32 ids once per distinct string;
- a batch of requests becomes a column per referenced descriptor key
  (token id, or -1 when the key is absent);
- compiled predicate forms evaluate as numpy mask ops over those columns.
  Each node compiles to an (ok, val) pair replicating CEL's short-circuit
  error semantics exactly (a missing key is an evaluation error that
  propagates unless short-circuited; Predicate.test maps an errored
  predicate to False, cel.rs:321-339):
    descriptors[0].k == 'v' / != / in      -> ok = key present, val = compare
    p && q   -> ok = p.ok & (~p.val | q.ok);   val = p.val & q.val
    p || q   -> ok = p.ok & (p.val | q.ok);    val = p.val | (p.ok & q.val)
    !p       -> ok = p.ok;                     val = p.ok & ~p.val
    true/false -> constant
  and the predicate's verdict is `val` (an error anywhere -> False).
- limits whose conditions don't fit these shapes (regexes, arithmetic,
  cross-key comparisons, the `limit` scope, ...) fall back to the exact
  host CEL interpreter per request — semantics never change, only speed.

Variables restricted to plain descriptor lookups (``descriptors[0].k`` or a
bare root variable) also vectorize: the counter key for a request is the
tuple of its variables' token ids, which the batch pipeline maps to device
slots. Missing-key semantics match the interpreter: predicate False /
variable unresolvable -> the limit contributes no counter
(limit.rs:133-174).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import cel as C
from ..core.cel import (
    Binary,
    Expr,
    Ident,
    Index,
    ListExpr,
    Literal,
    Select,
    Unary,
)
from ..core.limit import Limit

__all__ = ["Interner", "CompiledLimit", "NamespaceCompiler"]

MISSING = -1


class Interner:
    """String -> dense int32 id. Ids never recycle; lookups of unseen
    strings during *evaluation* get a fresh id (equality with any compiled
    constant is then correctly false). ``strings[id]`` is the reverse map."""

    def __init__(self):
        self._ids: Dict[str, int] = {}
        self.strings: List[str] = []

    def intern(self, s: str) -> int:
        out = self._ids.get(s)
        if out is None:
            out = len(self.strings)
            self._ids[s] = out
            self.strings.append(s)
        return out

    def __len__(self) -> int:
        return len(self.strings)


def _descriptor_key(node: Expr) -> Optional[str]:
    """The descriptor key of a `descriptors[0].k` / `descriptors[0]['k']`
    access, or None if the node is not that shape."""
    if isinstance(node, Select):
        base = node.operand
        field = node.field
    elif isinstance(node, Index) and isinstance(node.index, Literal) and isinstance(node.index.value, str):
        base = node.operand
        field = node.index.value
    else:
        return None
    if (
        isinstance(base, Index)
        and isinstance(base.operand, Ident)
        and base.operand.name == "descriptors"
        and isinstance(base.index, Literal)
        and base.index.value == 0
    ):
        return field
    return None


class _Mask:
    """A compiled boolean column program returning (ok, val) arrays:
    ``ok`` = evaluated without error, ``val`` = result where ok."""

    def __init__(self, fn, keys: frozenset):
        self.fn = fn  # (cols, interner, n) -> (ok: bool[n], val: bool[n])
        self.keys = keys

    def verdict(self, cols, interner, n) -> np.ndarray:
        ok, val = self.fn(cols, interner, n)
        return ok & val


def _compile_predicate(node: Expr) -> Optional[_Mask]:
    if isinstance(node, Literal):
        if node.value is True:
            return _Mask(
                lambda cols, it, n: (np.ones(n, bool), np.ones(n, bool)),
                frozenset(),
            )
        if node.value is False:
            return _Mask(
                lambda cols, it, n: (np.ones(n, bool), np.zeros(n, bool)),
                frozenset(),
            )
        return None
    if isinstance(node, Binary):
        if node.op in ("==", "!="):
            key, lit = None, None
            for a, b in ((node.left, node.right), (node.right, node.left)):
                k = _descriptor_key(a)
                if k is not None and isinstance(b, Literal) and isinstance(b.value, str):
                    key, lit = k, b.value
                    break
            if key is None:
                return None
            eq = node.op == "=="

            def fn(cols, it, n, key=key, lit=lit, eq=eq):
                col = cols[key]
                want = it._ids.get(lit, -2)  # unseen const matches nothing
                ok = col != MISSING
                val = (col == want) if eq else (col != want)
                return ok, val

            return _Mask(fn, frozenset([key]))
        if node.op == "in":
            key = _descriptor_key(node.left)
            if (
                key is None
                or not isinstance(node.right, ListExpr)
                or not all(
                    isinstance(i, Literal) and isinstance(i.value, str)
                    for i in node.right.items
                )
            ):
                return None
            values = [i.value for i in node.right.items]

            def fn(cols, it, n, key=key, values=values):
                col = cols[key]
                ids = np.asarray(
                    [it._ids.get(v, -2) for v in values], np.int64
                )
                return col != MISSING, np.isin(col, ids)

            return _Mask(fn, frozenset([key]))
        if node.op in ("&&", "||"):
            left = _compile_predicate(node.left)
            right = _compile_predicate(node.right)
            if left is None or right is None:
                return None
            conj = node.op == "&&"

            def fn(cols, it, n, l=left, r=right, conj=conj):
                lok, lval = l.fn(cols, it, n)
                rok, rval = r.fn(cols, it, n)
                lval = lval & lok
                rval = rval & rok
                if conj:
                    # false left short-circuits; true left needs right ok
                    ok = lok & (~lval | rok)
                    return ok, lval & rval
                # true left short-circuits; false left needs right ok
                ok = lok & (lval | rok)
                return ok, lval | rval

            return _Mask(fn, left.keys | right.keys)
        return None
    if isinstance(node, Unary) and node.op == "!":
        inner = _compile_predicate(node.operand)
        if inner is None:
            return None

        def fn(cols, it, n, inner=inner):
            ok, val = inner.fn(cols, it, n)
            return ok, ~(val & ok)

        return _Mask(fn, inner.keys)
    return None


def _compile_variable(node: Expr) -> Optional[str]:
    """Variables must be plain descriptor lookups to vectorize."""
    return _descriptor_key(node)


class CompiledLimit:
    __slots__ = ("limit", "index", "mask", "var_keys", "vectorized")

    def __init__(self, limit: Limit, index: int):
        self.limit = limit
        self.index = index
        masks = [_compile_predicate(p.expression.ast) for p in limit.conditions]
        var_keys = [_compile_variable(v.ast) for v in limit.variables]
        self.vectorized = all(m is not None for m in masks) and all(
            k is not None for k in var_keys
        )
        self.mask = masks if self.vectorized else None
        self.var_keys: List[str] = var_keys if self.vectorized else []


class NamespaceCompiler:
    """Compiles a namespace's limits; evaluates whole batches.

    ``evaluate(batch)`` returns, per request, the list of
    (limit, var token-id tuple) counters that apply — vectorized for
    compiled limits, interpreter fallback for the rest.
    """

    #: Interner reset threshold: high-cardinality variables (user ids, IPs)
    #: would otherwise grow the table without bound over a server's life.
    MAX_INTERNED = 1 << 20

    def __init__(self, limits: Sequence[Limit], interner=None):
        # Pluggable interner: the native host path shares its C++ interner
        # so compiled constants and parsed columns agree on token ids.
        self.interner = interner if interner is not None else Interner()
        # Unqualified limits first (then by identity): the storage processes
        # simple counters before qualified ones (in_memory.rs:104-139), and
        # first-limited naming follows that order.
        ordered = sorted(limits, key=lambda l: (bool(l.variables),) + l._identity)
        self.limits = [CompiledLimit(l, i) for i, l in enumerate(ordered)]
        self.vectorized_evals = 0
        self.fallback_evals = 0
        self.columns_needed: set = set()
        for cl in self.limits:
            if cl.vectorized:
                for m in cl.mask:
                    self.columns_needed |= m.keys
                self.columns_needed |= set(cl.var_keys)
        # Pre-intern every constant appearing in conditions so compiled
        # comparisons see stable ids.
        for cl in self.limits:
            if cl.vectorized:
                for p in cl.limit.conditions:
                    self._intern_constants(p.expression.ast)

    def _intern_constants(self, node: Expr) -> None:
        if isinstance(node, Literal) and isinstance(node.value, str):
            self.interner.intern(node.value)
        for attr in ("left", "right", "operand", "index"):
            child = getattr(node, attr, None)
            if isinstance(child, Expr):
                self._intern_constants(child)
        if isinstance(node, ListExpr):
            for item in node.items:
                self._intern_constants(item)

    def build_columns(
        self, batch: Sequence[Dict[str, str]]
    ) -> Dict[str, np.ndarray]:
        n = len(batch)
        cols: Dict[str, np.ndarray] = {}
        intern = self.interner.intern
        for key in self.columns_needed:
            col = np.full(n, MISSING, np.int64)
            for r, values in enumerate(batch):
                v = values.get(key)
                if v is not None:
                    col[r] = intern(v)
            cols[key] = col
        return cols

    @property
    def fully_vectorized(self) -> bool:
        return all(cl.vectorized for cl in self.limits)

    def _reintern_constants(self) -> None:
        self.interner = Interner()
        for cl in self.limits:
            if cl.vectorized:
                for p in cl.limit.conditions:
                    self._intern_constants(p.expression.ast)

    def evaluate_columns(self, cols: Dict[str, np.ndarray], n: int):
        """Lower-level columnar evaluation for pre-built columns (native
        parse path): yields (CompiledLimit, applies_mask, var_cols) per
        vectorized limit — no per-request Python objects."""
        for cl in self.limits:
            if not cl.vectorized:
                continue
            applies = np.ones(n, bool)
            for m in cl.mask:
                applies &= m.verdict(cols, self.interner, n)
            var_cols = [cols[k] for k in cl.var_keys]
            for vc in var_cols:
                applies &= vc != MISSING
            yield cl, applies, var_cols

    def evaluate(
        self, batch: Sequence[Dict[str, str]]
    ) -> List[List[Tuple[Limit, Tuple[int, ...]]]]:
        if (
            isinstance(self.interner, Interner)
            and len(self.interner) > self.MAX_INTERNED
        ):
            # Token ids only live within one evaluate() call (counters carry
            # strings), so resetting between batches is safe. A shared
            # (native) interner manages its own lifetime.
            self._reintern_constants()
        n = len(batch)
        out: List[List[Tuple[Limit, Tuple[int, ...]]]] = [[] for _ in range(n)]
        cols = self.build_columns(batch)
        for cl in self.limits:
            if cl.vectorized:
                self.vectorized_evals += n
                applies = np.ones(n, bool)
                for m in cl.mask:
                    applies &= m.verdict(cols, self.interner, n)
                var_cols = [cols[k] for k in cl.var_keys]
                for vc in var_cols:
                    applies &= vc != MISSING  # unresolvable -> no counter
                for r in np.nonzero(applies)[0]:
                    out[r].append(
                        (cl.limit, tuple(int(vc[r]) for vc in var_cols))
                    )
            else:
                # Exact interpreter fallback, one request at a time.
                self.fallback_evals += n
                for r, values in enumerate(batch):
                    ctx = C.Context()
                    ctx.list_binding("descriptors", [values])
                    if cl.limit.applies(ctx):
                        resolved = cl.limit.resolve_variables(ctx)
                        if resolved is not None:
                            out[r].append(
                                (
                                    cl.limit,
                                    tuple(
                                        self.interner.intern(v)
                                        for _k, v in sorted(resolved.items())
                                    ),
                                )
                            )
        return out

    def stats(self) -> Dict[str, int]:
        vec = sum(1 for cl in self.limits if cl.vectorized)
        return {
            "limits": len(self.limits),
            "vectorized": vec,
            "fallback": len(self.limits) - vec,
            # Runtime counts: (request, limit) evaluations served by each
            # path — exported as metrics so a production namespace that
            # silently drops limits to the interpreter is visible.
            "vectorized_evals": self.vectorized_evals,
            "fallback_evals": self.fallback_evals,
        }
