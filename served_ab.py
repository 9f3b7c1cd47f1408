"""Served latency of two checkouts of the port, on one card.

Runs the served phases of each checkout's own ``chip_smoke.py`` in a
process of its own: 4 (standard pipeline, draft-03 headers), 6 (native
pipeline), 7 (the native drive, decisions/s, leases off and on), 8b
(three replicated nodes), 9b (the three tiered servers), 10b (sharded)
and, where the checkout has it, 11 (the HTTP API). The checkouts run in
the order A B B A, so that a drift of the machine over the call shows as
a difference between a checkout's two runs. ``C`` in ``--order`` is
checkout B served without its gRPC ``x-request-id`` interceptor, which
sends each call's initial metadata as a grpc.aio operation of its own:
the layer's share of the served latency. Each run's output goes to
``chiprun_out/served_ab_<i>_<A|B>.log``; the script prints every run's
p50/p99 by phase, and one JSON line with all of them last.

    python3 served_ab.py PARENT_ROOT CHANGE_ROOT [--order ABCCBA]

Each checkout builds its kernels on its first run. Needs one card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import re
import subprocess
import sys
import tempfile
import time

_LATENCY = re.compile(r"p50 ([\d.]+) ms, p99 ([\d.]+) ms")
_RATE = re.compile(r"^(native drive[^:]*): .* = (\d+) decisions/s")


def _child(root: str, without_request_id: bool) -> int:
    """Run the served phases of the ``chip_smoke.py`` at ``root``."""
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if without_request_id:
        from limitador_tpu_torch.server import middleware

        async def passthrough(self, continuation, details):
            return await continuation(details)

        middleware.GrpcRequestIdInterceptor.intercept_service = passthrough

    dev = torch.device("cuda", 0)
    _name, card = cs.phase_card()
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        asyncio.run(cs._main_path(tmp, dev))
    with tempfile.TemporaryDirectory() as tmp:
        asyncio.run(cs._main_path(tmp, dev, native=True))
    for leases in (False, True):
        cs.phase_native_drive(dev, card, cs.NATIVE_BATCHES, leases=leases)
    with tempfile.TemporaryDirectory() as tmp:
        asyncio.run(cs._served_replication(tmp, dev, card))
    with tempfile.TemporaryDirectory() as tmp:
        asyncio.run(cs._served_tiers(tmp, dev, card, leases=False))
    with tempfile.TemporaryDirectory() as tmp:
        asyncio.run(cs._served_tiers(tmp, dev, card, leases=True,
                                     extra=("--usage-topk", "0")))
    with tempfile.TemporaryDirectory() as tmp:
        asyncio.run(cs._served_tiers(
            tmp, dev, card, leases=True,
            label="served tiers (leases on, observatory on)",
            need_reclaim=False))
    with tempfile.TemporaryDirectory() as tmp:
        asyncio.run(cs._served_sharded(tmp, dev, card))
    if hasattr(cs, "_http_api"):
        with tempfile.TemporaryDirectory() as tmp:
            asyncio.run(cs._http_api(tmp, dev, card))
    return 0


def _parse(text: str) -> dict:
    """Phase label -> [p50 ms, p99 ms], or decisions/s for the drives."""
    out = {}
    for line in text.splitlines():
        rate = _RATE.match(line)
        if rate:
            out[rate.group(1)] = int(rate.group(2))
            continue
        lat = _LATENCY.search(line)
        if lat:
            # drop a trailing "(..., cuda)" or "(cuda; card)" note
            label = re.sub(r"\s*\([^()]*\b(cuda|cpu)\b[^()]*\)$", "",
                           line.split(":")[0])
            out[label] = [float(lat.group(1)), float(lat.group(2))]
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("a", nargs="?", help="checkout A (the parent)")
    p.add_argument("b", nargs="?", help="checkout B (the change)")
    p.add_argument("--order", default="ABBA",
                   help="A, B, or C (B without the request-id "
                   "interceptor), one letter a run")
    p.add_argument("--child", help=argparse.SUPPRESS)
    p.add_argument("--without-request-id", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        return _child(args.child, args.without_request_id)
    if not (args.a and args.b):
        p.error("give the two checkouts")
    roots = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b),
             "C": os.path.abspath(args.b)}
    os.makedirs("chiprun_out", exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}")
    runs = []
    for i, which in enumerate(args.order):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             roots[which]] + ["--without-request-id"] * (which == "C"),
            capture_output=True, text=True, timeout=1500)
        log = os.path.join("chiprun_out", f"served_ab_{i}_{which}.log")
        with open(log, "w") as f:
            f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        if proc.returncode != 0:
            print(f"run {i} ({which}) exited {proc.returncode}; see {log}")
            print(proc.stdout[-2000:] + proc.stderr[-2000:])
            return 1
        got = _parse(proc.stdout)
        runs.append({"run": i, "checkout": which, "root": roots[which],
                     "without_request_id": which == "C",
                     "seconds": time.perf_counter() - t0, "phases": got})
        print(f"run {i} ({which}, {time.perf_counter() - t0:.0f} s):")
        for label, value in got.items():
            print(f"  {label}: {value}")
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
