"""CLI for the static-analysis framework.

Usage::

    python -m limitador_tpu_torch.tools.analysis [--all] [paths...]
    python -m limitador_tpu_torch.tools.analysis --list
    python -m limitador_tpu_torch.tools.analysis --only lock-order,style
    python -m limitador_tpu_torch.tools.analysis --json
    python -m limitador_tpu_torch.tools.analysis --write-baseline

Exit codes: 0 clean, 1 active findings, 2 usage error — CI gates on
them (the tier-1 suite and ``chip_smoke.py`` run ``--all``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import (
    BASELINE_REL, PASSES, finding_key, load_baseline, repo_root,
    run_passes,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m limitador_tpu_torch.tools.analysis",
        description="the port's pass-registry static analysis",
    )
    parser.add_argument(
        "--all", action="store_true",
        help="run every registered pass (the default; spelled out for "
             "CI readability)",
    )
    parser.add_argument(
        "--list", action="store_true", help="list passes and exit",
    )
    parser.add_argument(
        "--only", action="append", default=[],
        help="comma-separated pass names (repeatable)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="machine-readable output",
    )
    parser.add_argument(
        "--show-suppressed", action="store_true",
        help="print baseline/allowlist-suppressed findings too",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help=f"write current active findings to {BASELINE_REL}",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline file (report everything)",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="override the default lint targets (style/buffer/tracing "
             "file walks)",
    )
    args = parser.parse_args(argv)

    if args.list:
        width = max(len(name) for name in PASSES)
        for name, p in PASSES.items():
            speed = "fast" if p.fast else "slow"
            print(f"{name:<{width}}  [{speed}] {p.description}")
        return 0

    names = []
    for chunk in args.only:
        names.extend(n.strip() for n in chunk.split(",") if n.strip())
    unknown = [n for n in names if n not in PASSES]
    if unknown:
        print(
            f"unknown pass(es): {', '.join(unknown)} "
            f"(use --list)", file=sys.stderr,
        )
        return 2

    root = repo_root()
    for target in args.paths:
        if not Path(target).exists() and not (root / target).exists():
            # a typo'd target silently shrinking the walked set would
            # turn the gate into a false green
            print(f"no such lint target: {target}", file=sys.stderr)
            return 2
    try:
        active, suppressed = run_passes(
            root,
            names=names or None,
            targets=args.paths or None,
            # regeneration must see EVERYTHING, or still-live parked
            # entries (suppressed by the very file being rewritten)
            # would be dropped along with their reasons
            use_baseline=not args.no_baseline and not args.write_baseline,
        )
    except KeyError as exc:  # defensive: unknown name via API
        print(f"unknown pass: {exc}", file=sys.stderr)
        return 2

    if args.write_baseline:
        path = root / BASELINE_REL
        existing = load_baseline(root)
        lines = [
            "# Static-analysis baseline of the port "
            "(limitador_tpu_torch.tools.analysis).",
            "# EMPTY at a healthy HEAD: tests/test_torch_analysis.py asserts "
            "it. Entries",
            "# park known findings during a migration: "
            "'pass|path|message -- reason'.",
        ]
        written = 0
        if names:
            # --only rewrite: entries owned by unselected passes were
            # not re-checked this run — keep them verbatim
            for key, reason in existing.items():
                if key.split("|", 1)[0] not in names:
                    lines.append(f"{key} -- {reason}")
                    written += 1
        for f in active:
            key = finding_key(f)
            reason = existing.get(key, "parked by --write-baseline")
            lines.append(f"{key} -- {reason}")
            written += 1
        path.write_text("\n".join(lines) + "\n")
        print(f"wrote {written} entries to {BASELINE_REL}")
        return 0

    if args.as_json:
        print(json.dumps({
            "passes": names or list(PASSES),
            "active": [f.as_dict() for f in active],
            "suppressed": [f.as_dict() for f in suppressed],
            "baseline_entries": len(load_baseline(root)),
        }, indent=2))
    else:
        for f in active:
            print(f.render())
        if args.show_suppressed:
            for f in suppressed:
                print(f.render())
        if active:
            print(f"{len(active)} finding(s)", file=sys.stderr)
        if suppressed:
            print(
                f"{len(suppressed)} suppressed "
                "(--show-suppressed to print)", file=sys.stderr,
            )
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
