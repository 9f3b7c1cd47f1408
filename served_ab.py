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
the layer's share of the served latency. ``D`` is checkout B with the
device plane detached: no recorder on the batchers and pipelines and no
native telemetry plane (the C histograms stay off), so B against D is
the plane's own cost in one tree. ``--phases 4,6`` runs only the served
phases 4 and 6 (each about 10 s) instead of all of them.
``--plane-pairs N`` instead runs phases 4 and 6 of checkout B in ONE
process N rounds, each round once in every mode of ``--plane-modes``
(default ``BD``), the order rotating by round (B D, D B, ...), so that
the plane's cost is read without a process or a machine drift between
the modes. The modes split the plane by piece: ``B`` all of it, ``D``
none, ``R`` the batchers' recorder only (no native telemetry plane),
``P`` the native telemetry plane only (no recorder, so no SLO feed),
``E`` all of it with slow-row exemplars off (``--native-slow-row-us
0``), ``S`` all of it without the recorder's SLO feed, ``F`` all of it
with the control planes off (``--flight off --model-fit off``: no
flight tap, no serving-model ingest; the signal bus stays, off the
decision path). Each run's
output goes to ``chiprun_out/served_ab_<i>_<letter>.log``; the script
prints every run's p50/p99 by phase, and one JSON line with all of them
last. Whole drives of a few seconds each drift by more than the plane
costs, so ``--plane-interleave N`` runs three servers of checkout B in
one process at once, B, D and R, and sends N rounds of one sequential
ShouldRateLimit call to each (the order rotating by round), on phase
4's and phase 6's pipelines: each mode's p50/p99/mean, the median of
the per-round differences against the second mode (D), and the
recorder's own wall time a call by method, where it runs.
``--interleave-modes BF`` interleaves B with F instead: the control
planes' cost (the flight tap and the serving-model ingest on the
recorder's path) against the same tree without them.

    python3 served_ab.py PARENT_ROOT CHANGE_ROOT [--order ABCCBA] \
        [--phases 4,6]
    python3 served_ab.py - CHANGE_ROOT --plane-pairs 6 [--plane-modes BDRPES]
    python3 served_ab.py - CHANGE_ROOT --plane-interleave 1000 [--repeats 2] \
        [--interleave-modes BDR|BF]

Each checkout builds its kernels on its first run. Needs one card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time

_LATENCY = re.compile(r"p50 ([\d.]+) ms, p99 ([\d.]+) ms")
_MEAN = re.compile(r"\(mean ([\d.]+) ms\)")
_RATE = re.compile(r"^(native drive[^:]*): .* = (\d+) decisions/s")


PLANE_MODES = "BDRPESF"
#: the control planes' switches, defaults of the server's --flight and
#: --model-fit (mode F turns both off)
PLANES_ENV = ("TPU_FLIGHT", "TPU_MODEL_FIT")


def _own_spool() -> None:
    """Every server of this process writes its flight bundles under a
    temporary directory of its own, never into the default spool."""
    os.environ.setdefault("TPU_FLIGHT_SPOOL",
                          tempfile.mkdtemp(prefix="served-ab-flight-"))


def _plane_mode(mode: str):
    """Serve with the device plane's pieces of ``mode`` (one of
    ``PLANE_MODES``): patches the storages' ``set_metrics`` (which
    attaches the recorder) and the server's ``_native_plane`` (which arms
    the native telemetry plane and feeds its watchdog from the
    recorder), and for F sets the defaults of ``--flight`` and
    ``--model-fit`` (read when a server's parser is built) to off.
    Returns the function that puts all of it back."""
    from limitador_tpu_torch.device import batcher
    from limitador_tpu_torch.server import __main__ as server

    set_metrics = batcher.AsyncTorchStorage.set_metrics
    native_plane = server._native_plane
    environ = {key: os.environ.get(key) for key in PLANES_ENV}

    def restore():
        batcher.AsyncTorchStorage.set_metrics = set_metrics
        server._native_plane = native_plane
        for key, value in environ.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value

    def without_recorder(self, metrics):
        set_metrics(self, metrics)
        self.recorder = None
        for mb, ub in self._batcher_pairs():
            mb.recorder = ub.recorder = None

    def without_exemplars(args, limiter, metrics):
        args.native_slow_row_us = 0.0
        return native_plane(args, limiter, metrics)

    def without_slo_feed(args, limiter, metrics):
        plane = native_plane(args, limiter, metrics)
        if plane is not None and plane.recorder is not None:
            plane.recorder.slo = None
        return plane

    if mode in "DP":
        batcher.AsyncTorchStorage.set_metrics = without_recorder
    if mode in "DR":
        server._native_plane = lambda args, limiter, metrics: None
    elif mode == "E":
        server._native_plane = without_exemplars
    elif mode == "S":
        server._native_plane = without_slo_feed
    if mode == "F":
        os.environ.update(dict.fromkeys(PLANES_ENV, "off"))
    return restore


def _plane_pairs(root: str, pairs: int, modes: str = "BD") -> int:
    """Phases 4 and 6 of the ``chip_smoke.py`` at ``root``, ``pairs``
    rounds of every mode in ``modes``, in one process; each drive's lines
    are prefixed ``pair <i> <mode>:``."""
    _own_spool()
    os.chdir(root)
    sys.path.insert(0, root)
    import contextlib
    import io

    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    cs.phase_card()
    cs.phase_build()
    for i in range(pairs):
        shift = i % len(modes)
        for mode in modes[shift:] + modes[:shift]:
            restore = _plane_mode(mode)
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    for native in (False, True):
                        with tempfile.TemporaryDirectory() as tmp:
                            asyncio.run(cs._main_path(tmp, dev,
                                                      native=native))
            finally:
                restore()
            for line in out.getvalue().splitlines():
                print(f"pair {i} {mode}: {line}", flush=True)
    return 0


async def _interleaved(cs, dev, native: bool, modes: str, rounds: int,
                       tmp: str) -> dict:
    """One server per mode of ``modes`` (the standard pipeline of phase
    4, or with ``native`` the native one of phase 6), all in this
    process; ``rounds`` rounds of one sequential ShouldRateLimit call to
    each, the order rotating by round, so that the machine's drift lands
    on every mode alike. Returns mode -> per-round latencies (s) and, by
    recorder method, its wall time per call where it runs (s)."""
    import grpc

    from limitador_tpu_torch.observability import device_plane
    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.proto import rls_pb2

    limits = os.path.join(tmp, "limits.yaml")
    with open(limits, "w") as f:
        f.write(cs.LIMITS_YAML + (cs.NATIVE_NS_YAML if native else ""))
    options = ["--rls-host", "127.0.0.1", "--rate-limit-headers",
               "NONE" if native else "DRAFT_VERSION_03", "--device", dev.type]
    if native:
        options += ["--pipeline", "native", "--native-hot-lane", "on",
                    "--lease-mode", "off", "--usage-topk", "64",
                    "--usage-drain-interval", "0.25"]
    from limitador_tpu_torch.observability import native_plane

    # the recorder's own time: every DeviceStatsRecorder method a batch
    # calls, timed where it runs (a batch holds one call here), and the
    # SLO watchdog's share of record_batch
    pieces = (("record_flush", device_plane.DeviceStatsRecorder),
              ("record_chunks", device_plane.DeviceStatsRecorder),
              ("record_batch", device_plane.DeviceStatsRecorder),
              ("next_batch_id", device_plane.DeviceStatsRecorder),
              ("observe_many", native_plane.SloWatchdog))
    spent = dict.fromkeys((name for name, _cls in pieces), 0.0)
    saved = []
    for name, cls in pieces:
        fn = getattr(cls, name)
        saved.append((cls, name, fn))

        def timed(self, *args, _fn=fn, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(self, *args, **kwargs)
            finally:
                spent[_name] += time.perf_counter() - t0

        setattr(cls, name, timed)
    servers, ports = {}, {}
    try:
        for mode in modes:
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                ports[mode] = sock.getsockname()[1]
            restore = _plane_mode(mode)
            try:
                servers[mode] = await server.start(
                    server.build_parser().parse_args(
                        [limits, "torch", *options, *cs._http_options()[0],
                         "--rls-port", str(ports[mode])]),
                    clock=cs.ManualClock())
            finally:
                restore()
        envoy = ("/envoy.service.ratelimit.v3.RateLimitService/"
                 "ShouldRateLimit")
        lat = {m: [] for m in modes}
        own = {m: {name: [] for name in spent} for m in modes}
        channels = {m: grpc.aio.insecure_channel(f"127.0.0.1:{ports[m]}")
                    for m in modes}
        try:
            for i in range(rounds + 50):  # the first 50 rounds warm up
                shift = i % len(modes)
                blob = cs._lat_blob(rls_pb2, i, native)
                for mode in modes[shift:] + modes[:shift]:
                    call = channels[mode].unary_unary(envoy)
                    for name in spent:
                        spent[name] = 0.0
                    t0 = time.perf_counter()
                    await call(blob, timeout=60)
                    if i >= 50:
                        lat[mode].append(time.perf_counter() - t0)
                        for name, seconds in spent.items():
                            own[mode][name].append(seconds)
        finally:
            for ch in channels.values():
                await ch.close()
    finally:
        for srv in servers.values():
            await srv.stop()
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    return {m: {"lat": lat[m], "own": own[m]} for m in modes}


def _summarize(got: dict, base_mode: str = "D") -> dict:
    """Mode -> p50/p99/mean latency (ms), the recorder's time per call
    (µs, p50, all methods and each) and, against ``base_mode``, the
    median and mean of the per-round differences and the share of rounds
    it was slower."""
    import numpy as np

    base = np.asarray(got[base_mode]["lat"]) * 1e3
    out = {}
    for mode, v in got.items():
        ms = np.asarray(v["lat"]) * 1e3
        entry = {
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(ms.mean()),
        }
        total = sum(np.asarray(x) for name, x in v["own"].items()
                    if name != "observe_many") * 1e6
        entry["recorder_us_p50"] = float(np.percentile(total, 50))
        for name, x in v["own"].items():
            entry[f"{name}_us_p50"] = float(
                np.percentile(np.asarray(x) * 1e6, 50))
        if mode != base_mode:
            diff = ms - base
            entry[f"minus_{base_mode.lower()}_median_ms"] = float(
                np.median(diff))
            entry[f"minus_{base_mode.lower()}_mean_ms"] = float(diff.mean())
            entry["slower_share"] = float((diff > 0).mean())
        out[mode] = entry
    return out


def _plane_interleave(root: str, rounds: int, repeats: int,
                      modes: str = "BDR") -> int:
    """``_interleaved`` on phases 4 and 6, ``repeats`` times, in this
    process; prints each mode's p50/mean and, against the second mode of
    ``modes``, the median of the per-round differences and the share of
    rounds the mode was slower."""
    _own_spool()
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    cs.phase_card()
    cs.phase_build()
    out = []
    for rep in range(repeats):
        for native in (False, True):
            label = "native (6)" if native else "standard (4)"
            with tempfile.TemporaryDirectory() as tmp:
                got = asyncio.run(_interleaved(cs, dev, native, modes,
                                               rounds, tmp))
            row = {"repeat": rep, "phase": label,
                   **_summarize(got, modes[1])}
            for mode in got:
                print(f"interleave {rep} {label} {mode}: " + ", ".join(
                    f"{k} {x:.4f}" for k, x in row[mode].items()),
                    flush=True)
            out.append(row)
    print(json.dumps({"modes": modes, "interleave": out}))
    return 0


def _child(root: str, without_request_id: bool, phases, detach) -> int:
    """Run the served phases of the ``chip_smoke.py`` at ``root``."""
    _own_spool()
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if detach:
        _plane_mode("D")
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
    if phases == {"4", "6"}:
        return 0
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
    """Phase label -> [p50 ms, p99 ms] (and the mean where the checkout
    prints it), or decisions/s for the drives."""
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
            mean = _MEAN.search(line)
            if mean:  # a checkout that prints it
                out[label].append(float(mean.group(1)))
    return out


def _run_pairs(root: str, pairs: int, modes: str) -> int:
    """The ``--plane-pairs`` child, its log and every drive's p50/p99."""
    os.makedirs("chiprun_out", exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, served_ab; sys.exit(served_ab._plane_pairs("
         f"{root!r}, {pairs}, {modes!r}))"],
        capture_output=True, text=True, timeout=3000,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    log = os.path.join("chiprun_out", "served_ab_pairs.log")
    with open(log, "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        print(f"pairs exited {proc.returncode}; see {log}")
        print(proc.stdout[-2000:] + proc.stderr[-2000:])
        return 1
    runs = {}
    for line in proc.stdout.splitlines():
        head, _, rest = line.partition(": ")
        if not head.startswith("pair "):
            continue
        got = _parse(rest)
        if got:
            runs.setdefault(head, {}).update(got)
    for head, got in runs.items():
        print(f"{head}: " + ", ".join(f"{k} {v}" for k, v in got.items()))
    # the median of each statistic per mode and drive, and its
    # difference from D's
    medians: dict = {}
    for head, got in runs.items():
        mode = head.split()[-1]
        for label, value in got.items():
            for i, stat in enumerate(("p50", "p99", "mean")[:len(value)]):
                medians.setdefault((label, stat), {}).setdefault(
                    mode, []).append(value[i])
    for (label, stat), by_mode in medians.items():
        base = statistics.median(by_mode["D"]) if "D" in by_mode else None
        print(f"{label} median {stat} ms: " + ", ".join(
            f"{mode} {statistics.median(v):.3f}"
            + ("" if base is None or mode == "D"
               else f" ({statistics.median(v) - base:+.3f})")
            for mode, v in sorted(by_mode.items())))
    print(json.dumps({"card": smi, "pairs": runs}))
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("a", nargs="?", help="checkout A (the parent)")
    p.add_argument("b", nargs="?", help="checkout B (the change)")
    p.add_argument("--order", default="ABBA",
                   help="A, B, C (B without the request-id interceptor) "
                   "or D (B without the device plane), one letter a run")
    p.add_argument("--phases", default="all",
                   help="'4,6' runs the served phases 4 and 6 only")
    p.add_argument("--plane-pairs", type=int, default=0,
                   help="N: phases 4 and 6 of checkout B, N times with the "
                   "device plane attached and detached in one process")
    p.add_argument("--plane-modes", default="BD",
                   help=f"letters of {PLANE_MODES} for --plane-pairs (see "
                   "above)")
    p.add_argument("--plane-interleave", type=int, default=0,
                   help="N: phases 4 and 6 of checkout B, one server per "
                   "mode B, D and R in one process, N rounds of one call "
                   "to each")
    p.add_argument("--repeats", type=int, default=1,
                   help="repeats of --plane-interleave")
    p.add_argument("--interleave-modes", default="BDR",
                   help="letters of the modes --plane-interleave serves "
                   "side by side; the second is the baseline (BDR: the "
                   "device plane's cost; BF: the control planes')")
    p.add_argument("--child", help=argparse.SUPPRESS)
    p.add_argument("--without-request-id", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--without-device-plane", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args()
    phases = set(args.phases.split(","))
    if phases not in ({"all"}, {"4", "6"}):
        p.error("--phases is 'all' or '4,6'")
    if args.child:
        return _child(args.child, args.without_request_id, phases,
                      args.without_device_plane)
    if args.plane_interleave:
        if not args.b:
            p.error("give the checkout (B) to interleave")
        modes = args.interleave_modes
        if len(modes) < 2 or set(modes) - set(PLANE_MODES):
            p.error(f"--interleave-modes takes two or more letters of "
                    f"{PLANE_MODES}")
        return _plane_interleave(os.path.abspath(args.b),
                                 args.plane_interleave, args.repeats, modes)
    if args.plane_pairs:
        if not args.b:
            p.error("give the checkout (B) to pair")
        if not args.plane_modes or set(args.plane_modes) - set(PLANE_MODES):
            p.error(f"--plane-modes takes letters of {PLANE_MODES}")
        return _run_pairs(os.path.abspath(args.b), args.plane_pairs,
                          args.plane_modes)
    if not (args.a and args.b):
        p.error("give the two checkouts")
    roots = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b),
             "C": os.path.abspath(args.b), "D": os.path.abspath(args.b)}
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
             roots[which], "--phases", args.phases]
            + ["--without-request-id"] * (which == "C")
            + ["--without-device-plane"] * (which == "D"),
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
                     "without_device_plane": which == "D",
                     "seconds": time.perf_counter() - t0, "phases": got})
        print(f"run {i} ({which}, {time.perf_counter() - t0:.0f} s):")
        for label, value in got.items():
            print(f"  {label}: {value}")
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
