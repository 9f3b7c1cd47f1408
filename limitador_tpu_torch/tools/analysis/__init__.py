"""The port's static-analysis registry.

Counterpart of ``limitador_tpu/tools/analysis/``, pointed at the port's
own code: ``limitador_tpu_torch/``, ``chip_smoke.py`` and
``served_ab.py``. The port spans three concurrency domains with no
compiler help: relaxed-atomics C++ in ``csrc/`` (the host lane, the
HTTP/2 ingress), CUDA entry points bound through ctypes
(``csrc/counter_table.cu``), and multi-loop async Python where one
stray host sync costs a served p99. The passes:

* ``style``: the per-file AST lint (syntax, imports, bare ``except:``,
  mutable defaults, ``== None``, duplicate keys, whitespace);
* ``metric-registry``, ``native-phases``, ``debug-sections``,
  ``docs-sync``: each subsystem's registry tuple against its consumer;
* ``ctypes-abi``: the ``hp_``, ``h2i_`` and ``ct_`` exports of
  ``csrc/`` against their ctypes declarations, both directions, in
  either declaration form (``lib.x.argtypes =`` lines or the kernels'
  ``_SIGNATURES`` dict);
* ``buffer-safety``: a pointer into an unnamed temporary
  (``.ctypes.data``, ``.ctypes.data_as(...)``, ``.data_ptr()``) handed
  to a GIL-released ``hp_``/``h2i_``/``ct_`` call;
* ``lock-order``: the acquisition graph over the port's named lock
  domains (cycles, inversions of the canonical order, ``await`` or
  blocking calls under a threading lock, leaf locks held across
  another, the observatory drain's holds, allowlisted with reasons);
* ``tracing-safety``: no host sync (``torch.cuda.synchronize``,
  ``.synchronize()``, ``.item()``, ``.cpu()``) on the decision path of
  a hot module, and kernel launches only from their owner modules.

Each pass is a function ``run(ctx) -> List[Finding]`` registered under
a name. ``python -m limitador_tpu_torch.tools.analysis`` runs them all
and exits 1 on any active finding. ``baseline.txt`` (empty at a healthy
HEAD) parks known findings during a migration; suppressed findings stay
visible in ``--json`` and ``--show-suppressed``. ``# noqa`` on the
offending line suppresses a single finding.

The package imports neither JAX nor ``limitador_tpu``: it runs on the
card's machine, which has no JAX.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "AnalysisPass",
    "PASSES",
    "RepoContext",
    "register_pass",
    "run_passes",
    "load_baseline",
    "finding_key",
    "repo_root",
    "DEFAULT_TARGETS",
    "BASELINE_REL",
    "PACKAGE",
]

#: the package every package-wide pass walks
PACKAGE = "limitador_tpu_torch"

#: the file walks of style, buffer-safety and tracing-safety; ``tests/``
#: stays with the JAX package's gate, which covers ``tests/test_torch_*``
DEFAULT_TARGETS = (PACKAGE, "chip_smoke.py", "served_ab.py")

#: the checked-in baseline, repo-relative; empty at HEAD
#: (tests/test_torch_analysis.py asserts it)
BASELINE_REL = f"{PACKAGE}/tools/analysis/baseline.txt"


@dataclasses.dataclass
class Finding:
    """One analyzer finding: where, what, and how to fix it."""

    pass_name: str
    path: str       #: repo-relative posix path (absolute when outside)
    line: int
    message: str
    hint: str = ""
    #: set when a baseline entry or a pass allowlist suppressed it; it
    #: carries the reason, so a suppression is never silent
    suppressed_by: Optional[str] = None

    def render(self) -> str:
        out = f"{self.path}:{self.line}: [{self.pass_name}] {self.message}"
        if self.hint:
            out += f"\n    fix: {self.hint}"
        if self.suppressed_by:
            out += f"\n    suppressed: {self.suppressed_by}"
        return out

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def finding_key(finding: Finding) -> str:
    """Baseline key, without the line number, so that edits above a
    parked finding do not bring it back."""
    return f"{finding.pass_name}|{finding.path}|{finding.message}"


@dataclasses.dataclass(frozen=True)
class AnalysisPass:
    name: str
    description: str
    run: Callable[["RepoContext"], List[Finding]]
    #: every pass is fast today; the sanitizer race hunts are drivers
    #: built and run by ``native/build.py`` (pytest's slow tier and
    #: ``chip_smoke.py``), not passes
    fast: bool = True


#: name -> pass, in registration order (the run and report order)
PASSES: Dict[str, AnalysisPass] = {}


def register_pass(name: str, description: str, fast: bool = True):
    def wrap(fn):
        PASSES[name] = AnalysisPass(name, description, fn, fast)
        return fn
    return wrap


def repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def _generated(path: Path) -> bool:
    """protoc's output (the port's flat ``server/proto/*_pb2.py`` among
    it): its style, not ours."""
    return path.name.endswith(("_pb2.py", "_pb2_grpc.py"))


class RepoContext:
    """Shared walkers for every pass: one parse per file per run,
    repo-relative paths, target iteration and ``# noqa``."""

    def __init__(self, root, targets: Optional[Sequence] = None):
        self.root = Path(root).resolve()
        self.targets = tuple(str(t) for t in (targets or DEFAULT_TARGETS))
        self._sources: Dict[Path, str] = {}
        self._trees: Dict[Path, Optional[ast.AST]] = {}
        self._nodes: Dict[Path, List[ast.AST]] = {}
        self._files: Optional[List[Path]] = None

    # -- paths ---------------------------------------------------------------

    def rel(self, path) -> str:
        path = Path(path)
        try:
            return path.resolve().relative_to(self.root).as_posix()
        except ValueError:
            return str(path)

    def path(self, rel: str) -> Path:
        return self.root / rel

    # -- cached reads --------------------------------------------------------

    def source(self, path) -> str:
        path = Path(path)
        if path not in self._sources:
            try:
                self._sources[path] = path.read_text()
            except OSError:
                self._sources[path] = ""
        return self._sources[path]

    def lines(self, path) -> List[str]:
        return self.source(path).splitlines()

    def tree(self, path) -> Optional[ast.AST]:
        """Parsed AST, or None on a syntax error or a missing file (the
        style pass reports syntax errors; every other pass skips)."""
        path = Path(path)
        if path not in self._trees:
            try:
                self._trees[path] = ast.parse(
                    self.source(path), filename=str(path))
            except SyntaxError:
                self._trees[path] = None
        return self._trees[path]

    def nodes(self, path) -> List[ast.AST]:
        """Flattened node list of ``tree(path)``, cached: nine passes
        walk the same files."""
        path = Path(path)
        if path not in self._nodes:
            tree = self.tree(path)
            self._nodes[path] = [] if tree is None else list(ast.walk(tree))
        return self._nodes[path]

    def noqa(self, path, lineno: int) -> bool:
        lines = self.lines(path)
        return 0 < lineno <= len(lines) and "# noqa" in lines[lineno - 1]

    # -- iteration -----------------------------------------------------------

    def iter_files(self) -> List[Path]:
        """The lint targets' Python files, generated protobuf excluded."""
        if self._files is None:
            files: List[Path] = []
            for target in self.targets:
                p = Path(target)
                if not p.is_absolute():
                    p = self.root / target
                if p.is_dir():
                    files.extend(sorted(p.rglob("*.py")))
                elif p.suffix == ".py" and p.exists():
                    files.append(p)
            self._files = [f for f in files if not _generated(f)]
        return self._files

    def package_files(self, rel_prefix: str = PACKAGE) -> List[Path]:
        pkg = self.root / rel_prefix
        if not pkg.is_dir():
            return []
        return [f for f in sorted(pkg.rglob("*.py")) if not _generated(f)]

    # -- shared AST helpers ---------------------------------------------------

    def module_string_tuple(self, path, name: str) -> List[str]:
        """Entries of a module-level ``NAME = ("a", "b", ...)`` tuple or
        list (string constants only)."""
        tree = self.tree(path)
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
                if isinstance(elt, ast.Constant) and isinstance(
                    elt.value, str
                ):
                    out.append(elt.value)
        return out


# -- baseline ----------------------------------------------------------------

def load_baseline(root: Path) -> Dict[str, str]:
    """key -> reason from the checked-in baseline. One finding key a line
    (``pass|path|message``), ``#`` comments; a trailing `` -- reason``
    says why it is parked."""
    path = Path(root) / BASELINE_REL
    out: Dict[str, str] = {}
    try:
        text = path.read_text()
    except OSError:
        return out
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        key, _sep, reason = line.partition(" -- ")
        out[key.strip()] = reason.strip() or "baselined"
    return out


def run_passes(
    root=None,
    names: Optional[Sequence[str]] = None,
    targets: Optional[Sequence] = None,
    use_baseline: bool = True,
) -> Tuple[List[Finding], List[Finding]]:
    """Run the selected passes (every registered one when ``names`` is
    None) and split the findings into (active, suppressed). An unknown
    pass name raises KeyError (the CLI maps it to exit 2)."""
    root = Path(root) if root is not None else repo_root()
    ctx = RepoContext(root, targets)
    selected = list(names) if names else list(PASSES)
    findings: List[Finding] = []
    for name in selected:
        findings.extend(PASSES[name].run(ctx))
    baseline = load_baseline(root) if use_baseline else {}
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        if f.suppressed_by is None and baseline:
            reason = baseline.get(finding_key(f))
            if reason is not None:
                f.suppressed_by = f"baseline: {reason}"
        (suppressed if f.suppressed_by else active).append(f)
    return active, suppressed


# Pass modules register themselves on import; this order is the report
# order (cheap structural passes first, the graph analyzers last).
from . import style           # noqa: E402  (registration import)
from . import registries      # noqa: E402
from . import native_abi      # noqa: E402
from . import buffer_safety   # noqa: E402
from . import lock_order      # noqa: E402
from . import tracing         # noqa: E402
