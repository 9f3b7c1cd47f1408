"""ctypes ABI drift pass: the C exports against their Python bindings.

Every function exported from the port's native sources must have a
ctypes ``argtypes`` declaration on the Python side (and a ``restype``
when it returns anything), and every declaration must name a symbol
that still exists: a renamed or removed export fails the gate instead
of corrupting arguments, or failing at its first call on the card.

The JAX package's pass (``limitador_tpu/tools/analysis/native_abi.py``)
knows the ``hp_`` and ``h2i_`` exports and the ``lib.x.argtypes =``
form. The port adds the CUDA entry points of ``csrc/counter_table.cu``
(``ct_``), which ``ops/build.py`` declares in its ``_SIGNATURES`` dict
(``"ct_x": (restype, [argtypes])``, applied in a loop), and return
types of more than one word (``const char* ct_error_string``,
``long long ct_topk_workspace_bytes``).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from . import PACKAGE, Finding, RepoContext, register_pass

__all__ = [
    "CTYPES_SOURCES", "CTYPES_BINDINGS", "CTYPES_SYMBOL_PREFIXES",
    "SIGNATURES_NAME", "exported_c_symbols", "declared_ctypes_signatures",
    "abi_findings",
]

#: native sources whose extern "C" exports must carry ctypes
#: declarations in the binding modules (the prefixes filter the internal
#: helpers out)
CTYPES_SOURCES = (
    f"{PACKAGE}/csrc/hostpath.cc",
    f"{PACKAGE}/csrc/h2ingress.cc",
    f"{PACKAGE}/csrc/counter_table.cu",
)
CTYPES_BINDINGS = (
    f"{PACKAGE}/native/__init__.py",
    f"{PACKAGE}/native/ingress.py",
    f"{PACKAGE}/ops/build.py",
)
CTYPES_SYMBOL_PREFIXES = ("hp_", "h2i_", "ct_")

#: the module-level dict of ``symbol -> (restype, argtypes)`` a binding
#: module may declare its signatures in
SIGNATURES_NAME = "_SIGNATURES"

_IDENT = r"[A-Za-z_][A-Za-z0-9_]*"
#: a return type at column 0: one or more words (``const char``,
#: ``long long``, ``int32_t``) and any stars, then the exported name
_EXPORT = re.compile(
    rf"^((?:{_IDENT}[ \t]+)*{_IDENT}[ \t]*\**)[ \t]*("
    + "|".join(p + r"[a-z0-9_]+" for p in CTYPES_SYMBOL_PREFIXES)
    + r")\s*\(([^)]*)",
    re.MULTILINE,
)


def exported_c_symbols(source: str) -> List[Tuple[str, str, bool]]:
    """(name, return_type, has_params) for every exported C function of
    a translation unit (the extern "C" definitions of the port's sources
    all start at column 0 with the return type on the name's line; the
    parameter list may run over several lines). The return type is
    spelled with single spaces and its stars joined (``const char*``,
    ``long long``, ``void*``)."""
    out = []
    for match in _EXPORT.finditer(source):
        ret = re.sub(r"\s+", " ", match.group(1)).replace(" *", "*").strip()
        if ret in ("return", "else"):
            continue  # a statement at column 0, not a definition
        params = " ".join(match.group(3).split())
        out.append((match.group(2), ret, params not in ("", "void")))
    return out


def _signatures_dict(source: str) -> Dict[str, Set[str]]:
    """``{symbol: {"restype", "argtypes"}}`` from a module-level
    ``_SIGNATURES = {"sym": (restype, [argtypes...]), ...}``. A
    ``None`` restype declares a void return; either way both are
    declared, as the loop that applies the dict sets both."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return {}
    out: Dict[str, Set[str]] = {}
    for node in tree.body:
        if not (
            isinstance(node, (ast.Assign, ast.AnnAssign))
            and any(
                isinstance(t, ast.Name) and t.id == SIGNATURES_NAME
                for t in (node.targets if isinstance(node, ast.Assign)
                          else [node.target])
            )
            and isinstance(node.value, ast.Dict)
        ):
            continue
        for key, value in zip(node.value.keys, node.value.values):
            if not (isinstance(key, ast.Constant)
                    and isinstance(key.value, str)):
                continue
            kinds: Set[str] = set()
            if isinstance(value, (ast.Tuple, ast.List)) and len(
                value.elts
            ) == 2:
                kinds = {"restype", "argtypes"}
            out[key.value] = kinds
    return out


def declared_ctypes_signatures(source: str) -> Dict[str, Set[str]]:
    """``{symbol: {"restype", "argtypes"}}`` declared in a binding
    module, in either form: ``lib.<symbol>.restype = ...`` /
    ``.argtypes = ...`` lines, or the ``_SIGNATURES`` dict."""
    out: Dict[str, Set[str]] = {}
    for match in re.finditer(
        r"lib\.([A-Za-z_][A-Za-z0-9_]*)\.(restype|argtypes)\s*=", source
    ):
        out.setdefault(match.group(1), set()).add(match.group(2))
    for name, kinds in _signatures_dict(source).items():
        out.setdefault(name, set()).update(kinds)
    return out


def abi_findings(ctx: RepoContext) -> List[Finding]:
    findings: List[Finding] = []
    exported: dict = {}
    for rel in CTYPES_SOURCES:
        path = ctx.path(rel)
        if not path.exists():
            continue
        for name, ret, has_params in exported_c_symbols(ctx.source(path)):
            exported[name] = (rel, ret, has_params)
    declared: dict = {}
    declared_in: dict = {}
    for rel in CTYPES_BINDINGS:
        path = ctx.path(rel)
        if not path.exists():
            continue
        for name, kinds in declared_ctypes_signatures(
            ctx.source(path)
        ).items():
            declared.setdefault(name, set()).update(kinds)
            declared_in.setdefault(name, rel)
    if not exported or not declared:
        return findings
    for name, (rel, ret, has_params) in sorted(exported.items()):
        kinds = declared.get(name)
        if kinds is None:
            findings.append(Finding(
                "ctypes-abi", rel, 0,
                f"exported symbol '{name}' has no ctypes declaration in "
                "the binding modules (drift: a call through the default "
                "int-sized signature corrupts arguments silently)",
                hint="declare lib.<symbol>.argtypes (and restype when "
                     "non-void) in the binding module, or add the symbol "
                     f"to {SIGNATURES_NAME} in ops/build.py",
            ))
            continue
        if has_params and "argtypes" not in kinds:
            findings.append(Finding(
                "ctypes-abi", rel, 0,
                f"exported symbol '{name}' takes parameters but the "
                "binding declares no argtypes",
            ))
        if ret != "void" and "restype" not in kinds:
            findings.append(Finding(
                "ctypes-abi", rel, 0,
                f"exported symbol '{name}' returns {ret} but the "
                "binding declares no restype (ctypes truncates to int)",
            ))
    for name in sorted(declared):
        if not name.startswith(CTYPES_SYMBOL_PREFIXES):
            continue
        if name not in exported:
            findings.append(Finding(
                "ctypes-abi", declared_in[name], 0,
                f"binding declares '{name}' but no native source "
                "exports it (renamed or removed symbol)",
                hint="rename the binding to match the export, or drop "
                     "the dead declaration",
            ))
    return findings


@register_pass(
    "ctypes-abi",
    "hp_/h2i_/ct_ extern-C exports vs ctypes argtypes/restype "
    "declarations and ops/build.py's _SIGNATURES, both directions",
)
def run(ctx: RepoContext) -> List[Finding]:
    return abi_findings(ctx)
