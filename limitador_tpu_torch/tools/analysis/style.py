"""Style pass: the per-file AST linter (pyflakes/clippy classes).

The JAX package's style pass (``limitador_tpu/tools/analysis/style.py``)
over the port's targets: syntax errors, unused and redefined imports,
bare ``except:``, mutable default arguments, ``==``/``!=`` against
True/False/None, duplicate dict keys, tabs in indentation and trailing
whitespace. ``# noqa`` anywhere on the offending line suppresses that
finding.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Tuple

from . import Finding, RepoContext, _generated, register_pass

__all__ = ["lint_file", "lint_paths", "run"]


def _imported_bindings(tree: ast.AST):
    """(lineno, bound_name, scope_id) for every import; scope_id keys
    the nearest enclosing function/class/module, so a deliberate lazy
    re-import inside a function never collides with the module scope
    (pyflakes F811 is same-scope only too)."""
    out = []

    class V(ast.NodeVisitor):
        def __init__(self):
            self.scope = [id(tree)]

        def visit_Import(self, node):
            for alias in node.names:
                bound = alias.asname or alias.name.split(".")[0]
                # redef key keeps the dotted path: `import urllib.request`
                # and `import urllib.error` both bind 'urllib' on purpose
                out.append(
                    (node.lineno, bound, alias.name, self.scope[-1])
                )

        def visit_ImportFrom(self, node):
            if node.module == "__future__":
                return  # compiler directive, not a binding
            for alias in node.names:
                if alias.name == "*":
                    continue
                bound = alias.asname or alias.name
                out.append(
                    (node.lineno, bound, bound, self.scope[-1])
                )

        def _scoped(self, node):
            self.scope.append(id(node))
            self.generic_visit(node)
            self.scope.pop()

        visit_FunctionDef = _scoped
        visit_AsyncFunctionDef = _scoped
        visit_ClassDef = _scoped
        visit_Lambda = _scoped

    V().visit(tree)
    return out


def _used_names(tree: ast.AST, nodes=None):
    used = set()
    for node in (nodes if nodes is not None else ast.walk(tree)):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            # "a.b.c" usage roots at the Name, already collected
            pass
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if (
                    isinstance(target, ast.Name)
                    and target.id == "__all__"
                    and isinstance(node.value, (ast.List, ast.Tuple))
                ):
                    for elt in node.value.elts:
                        if isinstance(elt, ast.Constant) and isinstance(
                            elt.value, str
                        ):
                            used.add(elt.value)
    return used


def lint_file(path: Path) -> List[Tuple[int, str]]:
    """(lineno, message) findings for one file (the per-file entry
    point ``tools/lint.py`` re-exports)."""
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as exc:
        return [(exc.lineno or 0, f"syntax error: {exc.msg}")]
    return _lint_source(src, tree)


def _lint_source(src: str, tree: ast.AST, nodes=None) -> List[Tuple[int, str]]:
    lines = src.splitlines()

    def suppressed(lineno: int) -> bool:
        return (
            0 < lineno <= len(lines) and "# noqa" in lines[lineno - 1]
        )

    findings: List[Tuple[int, str]] = []

    # unused + same-scope-redefined imports
    bindings = _imported_bindings(tree)
    used = _used_names(tree, nodes)
    seen: dict = {}
    for lineno, name, full, scope in bindings:
        key = (full, scope)
        if key in seen and not suppressed(lineno):
            findings.append(
                (lineno, f"import '{name}' redefines line {seen[key]}")
            )
        seen.setdefault(key, lineno)
    for lineno, name, _full, _scope in bindings:
        if name not in used and not suppressed(lineno):
            findings.append((lineno, f"unused import '{name}'"))

    for node in (nodes if nodes is not None else ast.walk(tree)):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            if not suppressed(node.lineno):
                findings.append(
                    (node.lineno, "bare 'except:' swallows everything")
                )
        elif isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            for default in (
                list(node.args.defaults) + list(node.args.kw_defaults)
            ):
                if isinstance(
                    default, (ast.List, ast.Dict, ast.Set)
                ) and not suppressed(default.lineno):
                    findings.append((
                        default.lineno,
                        f"mutable default argument in '{node.name}'",
                    ))
        elif isinstance(node, ast.Compare):
            for op, comp in zip(node.ops, node.comparators):
                if (
                    isinstance(op, (ast.Eq, ast.NotEq))
                    and isinstance(comp, ast.Constant)
                    and (comp.value is None or comp.value is True
                         or comp.value is False)
                    and not suppressed(node.lineno)
                ):
                    findings.append((
                        node.lineno,
                        f"comparison to {comp.value!r} with ==/!= "
                        "(use is/is not or truthiness)",
                    ))
        elif isinstance(node, ast.Dict):
            keys = [
                k.value
                for k in node.keys
                if isinstance(k, ast.Constant)
                and isinstance(k.value, (str, int))
            ]
            dupes = {k for k in keys if keys.count(k) > 1}
            if dupes and not suppressed(node.lineno):
                findings.append((
                    node.lineno,
                    f"duplicate dict keys: {sorted(map(repr, dupes))}",
                ))

    for i, line in enumerate(lines, 1):
        if "# noqa" in line:
            continue
        stripped = line.rstrip("\n")
        if stripped != stripped.rstrip():
            findings.append((i, "trailing whitespace"))
        indent = stripped[: len(stripped) - len(stripped.lstrip())]
        if "\t" in indent:
            findings.append((i, "tab in indentation"))

    return sorted(findings)


def lint_paths(targets) -> List[str]:
    """``path:lineno: message`` findings over explicit targets."""
    out = []
    files = []
    for target in targets:
        p = Path(target)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    files = [f for f in files if not _generated(f)]
    for f in files:
        for lineno, msg in lint_file(f):
            out.append(f"{f}:{lineno}: {msg}")
    return out


@register_pass(
    "style",
    "per-file AST lint: syntax, imports, bare except, mutable defaults, "
    "True/None comparisons, duplicate keys, whitespace",
)
def run(ctx: RepoContext) -> List[Finding]:
    findings: List[Finding] = []
    for path in ctx.iter_files():
        rel = ctx.rel(path)
        tree = ctx.tree(path)  # shared parse cache across passes
        if tree is None:
            src = ctx.source(path)
            try:
                ast.parse(src, filename=str(path))
            except SyntaxError as exc:
                findings.append(Finding(
                    "style", rel, exc.lineno or 0,
                    f"syntax error: {exc.msg}",
                ))
            continue
        for lineno, msg in _lint_source(
            ctx.source(path), tree, ctx.nodes(path)
        ):
            findings.append(Finding("style", rel, lineno, msg))
    return findings
