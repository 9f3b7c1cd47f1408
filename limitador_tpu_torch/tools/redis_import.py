"""One-shot migration of a reference (limitador) Redis keyspace into a
running server of this package.

Port counterpart of ``limitador_tpu/tools/redis_import.py``. No RESP
client: the shared-authority role Redis plays in the reference is the
native authority protocol here (``storage/authority.py``), and what a
migrating fleet needs is its live counters moved over. This tool is
that path.

The reference stores one Redis string per counter: key =
``key_for_counter`` (version-prefixed postcard bytes), value = the
accumulated count, TTL = the window remainder. ``storage/keys.py`` is
byte-identical to that codec, so every key decodes against the same
limits YAML the fleet already ships, and the counts replay into a live
server through ``POST /report`` (any storage, any topology, no
downtime; on ``torch`` storage each report lands through the update
kernel's host form).

Export on the Redis side with a client that hands back raw bytes, and
base64-wrap the keys before they touch the text dump::

    python - <<'PY' > counters.dump
    import base64, redis
    r = redis.Redis()          # or redis.Redis.from_url("redis://...")
    for key in r.scan_iter(count=1000):
        value, pttl = r.get(key), r.pttl(key)
        if value is None or pttl is None or pttl <= 0:
            continue           # expired between SCAN and GET
        print(base64.b64encode(key).decode(), int(value), int(pttl))
    PY

Import here::

    python -m limitador_tpu_torch.tools.redis_import \\
        limits.yaml counters.dump --target http://127.0.0.1:8080

Semantics:

* entries whose PTTL is <= 0 (expired / no TTL) or whose value field is
  ``nil`` (the key expired mid-export) are skipped and counted;
* keys that do not decode against the limits file are counted and
  reported, not fatal;
* windows restart at import time with the full window length: the count
  carries over, the remaining TTL does not (errs strict, never
  over-admits during the cutover);
* an entry whose limit has conditions on descriptor fields that are not
  among the counter's variables (the ``kubernetes/`` configmap's
  ``descriptors[0].method == 'GET'`` over a counter keyed by user) is
  unreplayable: a ``/report`` built from the counter's variables would
  not select that limit, so it is counted and not sent;
* ``/report`` is a delta-add, not idempotent: on the first send failure
  the tool stops and writes every not-yet-sent entry (the failed one
  included) to ``<dump>.remaining`` in dump format; re-run on that file
  and nothing double-counts.
"""

from __future__ import annotations

import argparse
import base64
import binascii
import json
import re
import sys
import urllib.request
from typing import Dict, Iterable, List, Optional, Tuple

from ..core.counter import Counter
from ..server.limits_file import load_limits_file
from ..storage.keys import (
    LimitKeyIndex,
    key_for_counter,
    partial_counter_from_key,
)

__all__ = [
    "decode_entries",
    "dump_line",
    "main",
    "parse_dump",
    "replay",
    "unreplayable_reason",
    "values_for_replay",
]


def parse_dump(
    lines: Iterable[str],
) -> Tuple[List[Tuple[bytes, int, int]], int]:
    """((key_bytes, value, pttl_ms) triples, nil_skipped) from export
    lines. Blank/comment lines are ignored; a line whose value field is
    ``nil`` or missing (key expired between SCAN and GET in a
    hand-rolled export) is SKIPPED and counted, not fatal; genuinely
    malformed lines raise with the line number."""
    out = []
    nil_skipped = 0
    for n, line in enumerate(lines, 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) == 3 and parts[1] == "nil":
            nil_skipped += 1
            continue
        if len(parts) != 3:
            # A 2-field line is ambiguous: "key pttl" (nil value from a
            # hand-rolled export) is indistinguishable from a TRUNCATED
            # "key value" whose counter would silently vanish — refuse
            # and make the operator look (only an explicit 'nil' value
            # field takes the skip path).
            raise ValueError(f"line {n}: expected 'key value pttl'")
        try:
            key = base64.b64decode(parts[0], validate=True)
        except (binascii.Error, ValueError) as exc:
            raise ValueError(f"line {n}: bad base64 key: {exc}") from None
        try:
            value, pttl = int(parts[1]), int(parts[2])
        except ValueError:
            raise ValueError(
                f"line {n}: value/pttl not integers"
            ) from None
        out.append((key, value, pttl))
    return out, nil_skipped


def decode_entries(
    entries: Iterable[Tuple[bytes, int, int]], limits
) -> Tuple[List[Tuple[Counter, int]], int, int]:
    """Decode dump triples against the configured limits. Returns
    (importable (counter, value) pairs, skipped_expired,
    skipped_unknown)."""
    index = LimitKeyIndex(limits)
    importable: List[Tuple[Counter, int]] = []
    expired = unknown = 0
    for key, value, pttl in entries:
        if pttl <= 0 or value <= 0:
            expired += 1
            continue
        counter = partial_counter_from_key(key, index)
        if counter is None:
            unknown += 1
            continue
        importable.append((counter, value))
    return importable, expired, unknown


# The HTTP API binds the request's values map as ``descriptors[0]``
# (server/http_api.py), so a counter keyed by the canonical
# ``descriptors[0].key`` variable forms replays as {key: value}. Other
# CEL shapes have no HTTP representation and are reported, not sent.
_DESC_VAR = re.compile(
    r"^descriptors\[0\]\.([A-Za-z_][\w]*)$"
    r"|^descriptors\[0\]\['([^']+)'\]$"
    r"|^descriptors\[0\]\[\"([^\"]+)\"\]$"
)


def values_for_replay(counter: Counter) -> Optional[Dict[str, str]]:
    """The /report ``values`` map reproducing this counter's variable
    bindings, or None when a variable expression has no HTTP form."""
    values: Dict[str, str] = {}
    for expr, value in counter.set_variables.items():
        m = _DESC_VAR.match(expr)
        if m is None:
            return None
        values[next(g for g in m.groups() if g is not None)] = value
    return values


def unreplayable_reason(
    counter: Counter, namespace_limits
) -> Tuple[Optional[str], int]:
    """Classify one (counter, limits) pair for replay through /report.

    The server re-selects limits by evaluating conditions against a
    context built ONLY from the counter's variable bindings — so a
    limit whose conditions reference descriptor fields absent from
    those bindings (e.g. ``descriptors[0].method == 'GET'`` on a
    counter keyed only by user) never matches during replay: its count
    would be silently dropped while OTHER limits in the namespace that
    happen to match the synthesized values got spuriously credited.
    Simulate the server's selection here and refuse to send entries it
    would mis-credit.

    Returns ``(reason, extra_limits)``: reason is None (replayable),
    ``"shape"`` (a variable expression has no HTTP form) or
    ``"conditions"`` (the owning limit would not re-select, or would
    bind different variables); extra_limits counts OTHER limits the
    replayed report would also credit (a multi-credit warning, not a
    refusal — those limits would see this traffic in production too).
    """
    from ..core.cel import Context

    values = values_for_replay(counter)
    if values is None:
        return "shape", 0
    ctx = Context()
    ctx.list_binding("descriptors", [dict(values)])
    limit = counter.limit
    if not limit.applies(ctx):
        return "conditions", 0
    resolved = limit.resolve_variables(ctx)
    if resolved != dict(counter.set_variables):
        return "conditions", 0
    extra = 0
    for other in namespace_limits:
        if other == limit:
            continue
        if other.applies(ctx) and other.resolve_variables(ctx) is not None:
            extra += 1
    return None, extra


def dump_line(counter: Counter, value: int, pttl_ms: int = 1) -> str:
    """One dump-format line for (counter, value) — used to write the
    resumable remainder file."""
    return (
        base64.b64encode(key_for_counter(counter)).decode()
        + f" {int(value)} {int(pttl_ms)}"
    )


def replay(
    pairs: List[Tuple[Counter, int]],
    target: str,
    opener=None,
    limits=None,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[int, int, List[Tuple[Counter, int]], Optional[str]]:
    """POST each (counter, value) as a /report to the live server —
    counts land through the normal write path on any storage/topology.

    With ``limits`` (the fleet's configured limits), each entry is
    pre-flighted through :func:`unreplayable_reason`: entries whose
    owning limit would not be re-selected from the synthesized values
    (conditions over non-variable descriptor fields) are classified
    unreplayable — counted, warned about, NOT sent — instead of being
    silently dropped server-side while crediting the wrong limits.
    ``stats`` (optional dict) receives the breakdown: ``shape``,
    ``conditions``, ``multi_credit``.

    /report is a delta-add (NOT idempotent), so on the first send
    failure this STOPS and returns the unsent remainder instead of
    risking double-counts on a blind retry. Returns
    (sent, unreplayable, remaining_pairs, error)."""
    opener = opener or urllib.request.urlopen
    if stats is None:
        stats = {}
    stats.setdefault("shape", 0)
    stats.setdefault("conditions", 0)
    stats.setdefault("multi_credit", 0)
    by_ns: Dict[str, list] = {}
    for limit in limits or ():
        by_ns.setdefault(str(limit.namespace), []).append(limit)
    sent = unreplayable = 0
    for i, (counter, value) in enumerate(pairs):
        if limits is not None:
            reason, extra = unreplayable_reason(
                counter, by_ns.get(str(counter.namespace), ())
            )
            if reason is not None:
                unreplayable += 1
                stats[reason] += 1
                print(
                    f"unreplayable ({reason}): {counter.namespace} "
                    f"{dict(counter.set_variables)} +{value} — a /report "
                    "from these variable bindings would not re-select "
                    "this counter's limit",
                    file=sys.stderr,
                )
                continue
            if extra:
                stats["multi_credit"] += 1
                print(
                    f"warning: replaying {counter.namespace} "
                    f"{dict(counter.set_variables)} also credits "
                    f"{extra} other limit(s) in the namespace",
                    file=sys.stderr,
                )
        values = values_for_replay(counter)
        if values is None:
            unreplayable += 1
            stats["shape"] += 1
            continue
        body = json.dumps({
            "namespace": str(counter.namespace),
            "values": values,
            "delta": int(value),
        }).encode()
        req = urllib.request.Request(
            target.rstrip("/") + "/report",
            data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            with opener(req, timeout=30):
                sent += 1
        except Exception as exc:  # noqa: BLE001 — any transport failure
            return sent, unreplayable, list(pairs[i:]), repr(exc)
    return sent, unreplayable, [], None


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="limitador_tpu_torch.tools.redis_import",
        description=(
            "Replay a reference-limitador Redis counter dump into a "
            "live server of this package (see the module docstring for "
            "the export script)."
        ),
    )
    parser.add_argument("limits_file", help="the fleet's limits YAML")
    parser.add_argument("dump", help="export file: base64key value pttl")
    parser.add_argument(
        "--target", default="http://127.0.0.1:8080",
        help="HTTP API base of the live server (default %(default)s)",
    )
    parser.add_argument(
        "--dry-run", action="store_true",
        help="decode and summarize, send nothing",
    )
    args = parser.parse_args(argv)

    limits = load_limits_file(args.limits_file)
    with open(args.dump) as f:
        entries, nil_skipped = parse_dump(f)
    pairs, expired, unknown = decode_entries(entries, limits)
    print(
        f"decoded {len(pairs)} live counters "
        f"({expired} expired skipped, {nil_skipped} nil-value skipped, "
        f"{unknown} unknown-key skipped)",
        file=sys.stderr,
    )
    if args.dry_run:
        for counter, value in pairs:
            print(f"{counter.namespace} {dict(counter.set_variables)} "
                  f"+{value}")
        return 0
    stats: Dict[str, int] = {}
    sent, unreplayable, remaining, error = replay(
        pairs, args.target, limits=limits, stats=stats
    )
    print(
        f"replayed {sent} counters into {args.target}"
        + (
            f" ({unreplayable} unreplayable NOT sent: "
            f"{stats.get('shape', 0)} with no HTTP variable form, "
            f"{stats.get('conditions', 0)} whose limit conditions "
            "reference descriptor fields absent from the counter's "
            "bindings; "
            f"{stats.get('multi_credit', 0)} sent with a multi-credit "
            "warning)"
            if unreplayable or stats.get("multi_credit")
            else ""
        ),
        file=sys.stderr,
    )
    if remaining:
        # /report deltas are not idempotent: save the unsent tail so the
        # operator re-runs on it without double-counting what landed.
        remainder_path = args.dump + ".remaining"
        with open(remainder_path, "w") as f:
            for counter, value in remaining:
                f.write(dump_line(counter, value) + "\n")
        print(
            f"send failed after {sent} counters ({error}); "
            f"{len(remaining)} unsent entries written to "
            f"{remainder_path} — fix the target and re-run on that file",
            file=sys.stderr,
        )
        return 1
    return 0 if not unreplayable else 2


if __name__ == "__main__":
    sys.exit(main())
