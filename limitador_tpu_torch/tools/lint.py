"""Thin shim over ``limitador_tpu_torch.tools.analysis``.

Counterpart of ``limitador_tpu/tools/lint.py``: the historical entry
points, ``python -m limitador_tpu_torch.tools.lint`` and the function
API, delegating to the pass registry with the ``path:lineno: message``
rendering. The JAX shim's ``lint_donation`` has no counterpart: the
port has no ``jax.jit`` and donates nothing (see ``analysis/tracing.py``).

New passes register in ``tools/analysis/``.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List

from .analysis import DEFAULT_TARGETS, RepoContext
from .analysis.native_abi import (        # noqa: re-exported API
    CTYPES_BINDINGS, CTYPES_SOURCES, CTYPES_SYMBOL_PREFIXES,
    abi_findings, declared_ctypes_signatures, exported_c_symbols,
)
from .analysis.registries import (        # noqa: re-exported API
    HTTP_API_MODULE, NATIVE_PLANE_MODULE, OBSERVABILITY_DOC,
    REGISTRY_OWNED_PREFIXES, debug_section_findings, docs_sync_findings,
    metric_registry_findings, native_phase_findings,
)
from .analysis.style import lint_file, lint_paths  # noqa: re-exported

__all__ = [
    "lint_file", "lint_paths", "lint_metric_registry",
    "lint_ctypes_signatures", "lint_native_phases",
    "lint_debug_sections", "lint_docs_sync", "main", "DEFAULT_TARGETS",
]


def _legacy(ctx: RepoContext, findings) -> List[str]:
    """Render registry findings as ``path:lineno: message``."""
    out = []
    for f in findings:
        path = f.path
        if not Path(path).is_absolute():
            path = str(ctx.root / path)
        out.append(f"{path}:{f.line}: {f.message}")
    return out


def lint_metric_registry(repo_root) -> List[str]:
    ctx = RepoContext(repo_root)
    return _legacy(ctx, metric_registry_findings(ctx))


def lint_native_phases(repo_root) -> List[str]:
    ctx = RepoContext(repo_root)
    return _legacy(ctx, native_phase_findings(ctx))


def lint_debug_sections(repo_root) -> List[str]:
    ctx = RepoContext(repo_root)
    return _legacy(ctx, debug_section_findings(ctx))


def lint_docs_sync(repo_root) -> List[str]:
    ctx = RepoContext(repo_root)
    return _legacy(ctx, docs_sync_findings(ctx))


def lint_ctypes_signatures(repo_root) -> List[str]:
    # this pass renders without a line: "csrc/hostpath.cc: exported ..."
    ctx = RepoContext(repo_root)
    return [f"{f.path}: {f.message}" for f in abi_findings(ctx)]


def main(argv=None) -> int:
    """The full analysis gate (every registered pass, baseline applied);
    ``python -m limitador_tpu_torch.tools.analysis`` is the first-class
    interface with --list/--only/--json."""
    from .analysis.__main__ import main as analysis_main

    argv = list(sys.argv[1:] if argv is None else argv)
    return analysis_main(argv)


if __name__ == "__main__":
    sys.exit(main())
