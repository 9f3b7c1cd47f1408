"""GIL-release buffer-safety pass over the port's native calls.

ctypes releases the GIL around every call into a native library, so the
C side reads its pointer arguments while Python runs on: a buffer must
stay referenced from Python for the whole call. The classic bug:
``lib.hp_tel_drain(np.empty(n).ctypes.data, n)``. ``.ctypes.data``
extracts a raw integer address; the temporary array's refcount reaches
zero as soon as the argument expression is evaluated, before the C call
runs, and its memory may be reused under the call. The port adds the
CUDA entry points (``ct_``) and PyTorch's ``tensor.data_ptr()``: in
``lib.ct_update(x.contiguous().data_ptr(), ...)`` the caching allocator
may hand the temporary's block to the next allocation, on the same
stream, while the launch that reads it is still queued.

What the pass allows, and why:

* ``buf.ctypes.data`` / ``t.data_ptr()`` where ``buf``/``t`` is a local
  or an attribute binding: the binding outlives the call statement;
* ``buf[a:b].ctypes.data``: the view is a temporary, but the address
  belongs to ``buf``, which the named base keeps alive (a chain of
  attributes and subscripts that ends at a name is accepted);
* ``*(t.data_ptr() for t in state)`` over named tensors: each ``t`` is
  a name bound to a tensor the tuple keeps alive;
* an array or ``bytes`` object passed directly as the argument: the
  argument tuple keeps it referenced for the call.

Flagged: a pointer extraction (``.ctypes.data``, ``.ctypes.data_as(..)``,
``.data_ptr()``) whose ownership chain ends in a call, an operator or a
comprehension, that is, a value no name keeps alive, inside the
arguments of a ``hp_``/``h2i_``/``ct_`` call, or stored in a local that
such a call is handed later in the same function. A call through an
alias (``self.read_fn = lib.ct_read_slots_host``; ``ctx.read_fn(...)``)
counts as a call of the symbol.

Counterpart of ``limitador_tpu/tools/analysis/buffer_safety.py``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from . import Finding, RepoContext, register_pass

__all__ = ["NATIVE_SYMBOL_PREFIXES", "buffer_findings"]

NATIVE_SYMBOL_PREFIXES = ("hp_", "h2i_", "ct_")


def _callee_name(fn: ast.AST) -> Optional[str]:
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _aliases(nodes) -> Dict[str, str]:
    """name -> symbol for every ``x.name = lib.ct_y`` / ``name =
    lib.hp_y`` binding in a module (the kernel contexts keep their entry
    points as attributes)."""
    out: Dict[str, str] = {}
    for node in nodes:
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if not (isinstance(value, ast.Attribute)
                and value.attr.startswith(NATIVE_SYMBOL_PREFIXES)):
            continue
        for target in node.targets:
            name = _callee_name(target)
            if name is not None:
                out[name] = value.attr
    return out


def _native_symbol(node: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
    """The native symbol a call reaches: any receiver of an
    ``hp_``/``h2i_``/``ct_`` name (``lib.hp_x``, ``self._lib.h2i_y``,
    bare ``ct_z``), or an alias of one."""
    name = _callee_name(node.func)
    if name is None:
        return None
    if name.startswith(NATIVE_SYMBOL_PREFIXES):
        return name
    return aliases.get(name)


def _chain_root(node: ast.AST) -> ast.AST:
    """Walk an attribute/subscript ownership chain to its root: the
    object whose lifetime owns the pointed-at buffer."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    return node


def _pointer_extractions(expr: ast.AST):
    """(node, base, spelling) for every ``X.ctypes.data``,
    ``X.ctypes.data_as(..)`` and ``X.data_ptr()`` inside an expression."""
    out = []
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr == "data":
            inner = node.value
            if isinstance(inner, ast.Attribute) and inner.attr == "ctypes":
                out.append((node, inner.value, ".ctypes.data"))
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
        ):
            attr = node.func.attr
            inner = node.func.value
            if attr == "data_as" and isinstance(
                inner, ast.Attribute
            ) and inner.attr == "ctypes":
                out.append((node, inner.value, ".ctypes.data_as()"))
            elif attr == "data_ptr" and not node.args:
                out.append((node, inner, ".data_ptr()"))
    return out


def _temporary_extractions(expr: ast.AST):
    """The extractions in ``expr`` whose buffer no name keeps alive."""
    return [
        (node, spelling)
        for node, base, spelling in _pointer_extractions(expr)
        if not isinstance(_chain_root(base), ast.Name)
    ]


def _functions(tree: ast.AST):
    """Each function body, and the module's own statements, as one scope
    for the local-flow rule."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _scope_nodes(scope: ast.AST):
    """The nodes of one scope, nested functions excluded."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _finding(rel: str, lineno: int, symbol: str, spelling: str,
             via: str = "") -> Finding:
    return Finding(
        "buffer-safety", rel, lineno,
        f"'{symbol}' is handed a pointer into a temporary buffer "
        f"({spelling} on an unnamed value{via}): the temporary dies "
        "before the GIL-released native call completes",
        hint="bind the array or tensor to a local first (buf = ...; "
             "lib.call(buf.data_ptr(), ...)) so that the binding outlives "
             "the call",
    )


def buffer_findings(ctx: RepoContext) -> List[Finding]:
    findings: List[Finding] = []
    for path in ctx.iter_files():
        tree = ctx.tree(path)
        if tree is None:
            continue
        rel = ctx.rel(path)
        aliases = _aliases(ctx.nodes(path))
        for scope in _functions(tree):
            nodes = list(_scope_nodes(scope))
            # locals that hold a pointer into a temporary
            tainted: Dict[str, tuple] = {}
            for node in nodes:
                if isinstance(node, ast.Assign):
                    temps = _temporary_extractions(node.value)
                    if temps:
                        for target in node.targets:
                            if isinstance(target, ast.Name):
                                tainted[target.id] = (
                                    temps[0][0].lineno, temps[0][1])
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                symbol = _native_symbol(node, aliases)
                if symbol is None:
                    continue
                args = list(node.args) + [k.value for k in node.keywords]
                for arg in args:
                    for ptr_node, spelling in _temporary_extractions(arg):
                        if ctx.noqa(path, ptr_node.lineno):
                            continue
                        findings.append(
                            _finding(rel, ptr_node.lineno, symbol, spelling))
                    root = _chain_root(arg)
                    if isinstance(root, ast.Name) and root.id in tainted:
                        lineno, spelling = tainted[root.id]
                        if ctx.noqa(path, lineno) or ctx.noqa(
                            path, node.lineno
                        ):
                            continue
                        findings.append(_finding(
                            rel, node.lineno, symbol, spelling,
                            f", kept in '{root.id}' from line {lineno}"))
    return findings


@register_pass(
    "buffer-safety",
    "numpy buffers and tensors handed to GIL-released hp_*/h2i_*/ct_* "
    "calls must be kept alive by a name, not a temporary",
)
def run(ctx: RepoContext) -> List[Finding]:
    return buffer_findings(ctx)
