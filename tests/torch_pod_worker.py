"""One process of the port's CPU pod harness (not a pytest module).

It imports the port only (nothing of ``limitador_tpu`` and no JAX), and
runs in one of two modes:

``server``: one member of a real pod of port servers.

    python tests/torch_pod_worker.py server --process-id I \\
        --num-processes N --coordinator 127.0.0.1:PORT \\
        --peer-ports P0,P1 --storage sharded|torch|memory \\
        [--device cpu|cuda] [--mode routed|native|ingress|lane-off] \\
        --dir DIR --out OUT.json

The worker starts the port's server (``server.__main__.start``) with the
``--pod-*`` options (on ``--device cpu`` unless asked) and a fake clock, so the pod
forms over a TCPStore, and runs the drive of ``tests/pod_worker.py``
(the limits and requests are copied here): each step is decided by the
host it arrives at, and the hosts meet at a ``pod_barrier`` before and
after every step. ``--mode routed`` (the default) decides each step
through the server's limiter (the pod frontend); the other modes serve
``--pipeline native`` with the descriptor-keyed limits and send each step
as a ShouldRateLimit call to the member's own RLS port: ``native``
(grpc.aio into the native pipeline and its pod fast path), ``ingress``
(``--native-ingress``) and ``lane-off`` (``--native-hot-lane off``: the
member warns and serves through the routed compiled pipeline). It writes
its decisions, the counters it holds, its router, lane and pod views,
the pipeline's pod split, the warnings it logged, the HTTP debug bodies,
some ``/metrics`` samples and which port modules it imported.

``owner``: the owner host of the kill-and-restart drill: a peer lane and
a pod frontend (host 1 of 2) over an in-memory storage on ``--listen``,
which touches ``--ready`` once serving and, when ``--stop`` appears,
writes its counters to ``--out`` and exits.
"""

import argparse
import asyncio
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The drive both the workers and the parent's oracle run: the JAX pod
# harness's (tests/pod_worker.py), copied so that this process needs
# nothing of the JAX package.
DRIVE_REQUESTS = 48
DRIVE_USERS = 7
DRIVE_T0 = 1_700_000_000.0
DRIVE_STEP_S = 0.05

DRIVE_LIMITS_YAML = """\
- namespace: pods
  max_value: 3
  seconds: 60
  variables: ["user"]
  name: per_user
- namespace: multi
  max_value: 2
  seconds: 60
  variables: ["user"]
  name: multi_user
- namespace: multi
  max_value: 30
  seconds: 60
  name: multi_total
"""

#: the same namespaces and limits keyed on the RLS descriptor, for the
#: modes that send ShouldRateLimit calls
NATIVE_LIMITS_YAML = DRIVE_LIMITS_YAML.replace(
    '["user"]', '["descriptors[0].user"]')

NAMESPACES = ("pods", "multi")

#: the modes that serve --pipeline native, and their extra options
NATIVE_MODES = {
    "native": [],
    "ingress": ["--native-ingress"],
    "lane-off": ["--native-hot-lane", "off"],
}

RLS_METHOD = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"

#: the drill's limit (one namespace, one limit: it routes per key)
CHAOS_NAMESPACE = "chaos"
CHAOS_MAX = 4


def drive_limits(native=False):
    from limitador_tpu_torch import Limit

    user = "descriptors[0].user" if native else "user"
    return [
        Limit("pods", 3, 60, [], [user], name="per_user"),
        Limit("multi", 2, 60, [], [user], name="multi_user"),
        Limit("multi", 30, 60, [], [], name="multi_total"),
    ]


def drive_context(user, native=False):
    """The context a drive step's request decides under: the user as a
    variable, or (the native modes) as the entry of one RLS descriptor."""
    from limitador_tpu_torch import Context

    if not native:
        return Context({"user": user})
    ctx = Context()
    ctx.list_binding("descriptors", [{"user": user}])
    return ctx


def chaos_limits():
    from limitador_tpu_torch import Limit

    return [Limit(CHAOS_NAMESPACE, CHAOS_MAX, 120, [], ["u"], name="per_u")]


def drive_request(i: int):
    """(namespace, user, arrival_host) of drive step i."""
    ns = "pods" if i % 3 else "multi"
    return ns, f"u{i % DRIVE_USERS}", i % 2


def step_time(i: int) -> float:
    return DRIVE_T0 + i * DRIVE_STEP_S


class Clock:
    def __init__(self):
        self.now = DRIVE_T0

    def __call__(self):
        return self.now


def counter_rows(counters, ns):
    return [{
        "ns": ns,
        "limit": c.limit.name,
        # lists, not tuples: equal before and after the JSON round trip
        "vars": [list(kv) for kv in sorted(c.set_variables.items())],
        "remaining": c.remaining,
        "expires_ms": int(round((c.expires_in or 0) * 1000)),
    } for c in counters]


def sort_rows(rows):
    return sorted(rows, key=lambda r: (r["ns"], r["limit"], r["vars"]))


async def _http_json(port, path):
    import aiohttp

    async with aiohttp.ClientSession() as session:
        async with session.get(f"http://127.0.0.1:{port}{path}") as resp:
            return resp.status, await resp.text()


class _Warnings:
    """The warnings the port's logger emits while the worker runs."""

    def __init__(self):
        import logging

        self.messages = []
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda record: self.messages.append(
            record.getMessage())
        logging.getLogger("limitador_tpu_torch").addHandler(self.handler)


async def _rls_calls(port):
    """An async ShouldRateLimit caller on the member's own RLS port, and
    its channel."""
    import grpc

    from limitador_tpu_torch.server.proto import rls_pb2

    channel = grpc.aio.insecure_channel(f"127.0.0.1:{port}")
    call = channel.unary_unary(RLS_METHOD)

    async def decide(i, ns, user):
        req = rls_pb2.RateLimitRequest(domain=ns)
        req.descriptors.add().entries.add(key="user", value=user)
        raw = await call(req.SerializeToString(), timeout=30,
                         metadata=(("x-request-id", f"drive-{i}"),))
        code = rls_pb2.RateLimitResponse.FromString(raw).overall_code
        return {"limited": code == rls_pb2.RateLimitResponse.OVER_LIMIT}

    return decide, channel


async def serve_and_drive(args) -> dict:
    from limitador_tpu_torch.observability.device_plane import set_request_id
    from limitador_tpu_torch.parallel.pod import pod_barrier
    from limitador_tpu_torch.server import __main__ as server_main

    me = args.process_id
    native = args.mode in NATIVE_MODES
    warnings = _Warnings()
    limits_path = os.path.join(args.dir, f"limits-{me}.yaml")
    with open(limits_path, "w") as f:
        f.write(NATIVE_LIMITS_YAML if native else DRIVE_LIMITS_YAML)
    peer_ports = [int(p) for p in args.peer_ports.split(",")]
    argv = [
        limits_path, args.storage, "--device", args.device,
        "--capacity", "4096",
        "--http-host", "127.0.0.1", "--http-port", str(args.http_port),
        "--rls-host", "127.0.0.1", "--rls-port", str(args.rls_port),
        "--flight-spool-dir", os.path.join(args.dir, f"flight-{me}"),
        "--pod-coordinator", args.coordinator,
        "--pod-processes", str(args.num_processes),
        "--pod-process-id", str(me),
        "--pod-peer-listen", f"127.0.0.1:{peer_ports[me]}",
    ]
    for port in peer_ports:
        argv += ["--pod-peer", f"127.0.0.1:{port}"]
    if native:
        argv += ["--pipeline", "native", "--rate-limit-headers", "NONE",
                 *NATIVE_MODES[args.mode]]
    if args.pod_resize == "on":
        argv += ["--pod-resize", "on"]
    clock = Clock()
    server = await server_main.start(
        server_main.build_parser().parse_args(argv), clock=clock)
    loop = asyncio.get_running_loop()
    channel = None
    if native:
        rls_decide, channel = await _rls_calls(args.rls_port)

    async def barrier(tag):
        await loop.run_in_executor(None, pod_barrier, tag, 60_000)

    try:
        frontend = server.limiter
        await barrier("drive-ready")
        decisions = {}
        for i in range(DRIVE_REQUESTS):
            # Every clock reads step i's time before any host decides
            # step i, and stays there until every host has decided it:
            # a forward is decided at the same time on its owner as on
            # the oracle.
            clock.now = step_time(i)
            await barrier(f"clock-{i}")
            ns, user, arrival = drive_request(i)
            if arrival == me and native:
                decisions[i] = await rls_decide(i, ns, user)
            elif arrival == me:
                set_request_id(f"drive-{i}")
                result = await frontend.check_rate_limited_and_update(
                    ns, drive_context(user), 1, False)
                decisions[i] = {"limited": bool(result.limited),
                                "name": result.limit_name}
            await barrier(f"drive-{i}")
        counters = []
        for ns in NAMESPACES:
            got = frontend.get_counters(ns)
            if asyncio.iscoroutine(got):  # an async limiter's
                got = await got
            counters += counter_rows(got, ns)
        # the peers' signals ride the lane's probes: wait for them as
        # long as for a barrier (a loaded machine delays the probes)
        deadline = time.time() + 60
        while (len(frontend.aggregator.peer_hosts())
               < args.num_processes - 1 and time.time() < deadline):
            await asyncio.sleep(0.05)
        http = {}
        for path in ("/debug/pod", "/debug/pod/routing",
                     "/debug/events", "/debug/stats", "/metrics"):
            status, text = await _http_json(args.http_port, path)
            http[path] = {"status": status,
                          "body": text if path == "/metrics"
                          else json.loads(text)}
        await barrier("drive-reported")
        pipeline = server.native_pipeline
        return {
            "process_id": me,
            "native_pipeline": pipeline is not None,
            "native_ingress": server.native_ingress is not None,
            "pod_stats": pipeline.pod_stats() if pipeline else {},
            "warnings": warnings.messages,
            "decisions": decisions,
            "counters": sort_rows(counters),
            "router": frontend.router.stats(),
            "lane": frontend.lane.stats(),
            "events": frontend.events_debug(),
            "pod_debug": frontend.pod_debug(),
            "http": http,
            "modules": sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "limitador_tpu")
                or m in ("limitador_tpu_torch.admission",
                         "limitador_tpu_torch.server.peering",
                         "limitador_tpu_torch.server.resize",
                         "limitador_tpu_torch.server.standby",
                         "limitador_tpu_torch.parallel.pod")),
        }
    finally:
        if channel is not None:
            await channel.close()
        await server.stop()


async def serve_owner(args) -> None:
    from limitador_tpu_torch import RateLimiter
    from limitador_tpu_torch.routing import PodRouter, PodTopology
    from limitador_tpu_torch.server.peering import PeerLane, PodFrontend
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    lane = PeerLane(1, args.listen, {}, None)
    frontend = PodFrontend(
        RateLimiter(InMemoryStorage(4096)),
        PodRouter(PodTopology(hosts=2, host_id=1, shards_per_host=1)),
        lane,
    )
    await frontend.configure_with(chaos_limits())
    lane.start()
    with open(args.ready, "w") as f:
        f.write(str(lane.port))
    while not os.path.exists(args.stop):
        await asyncio.sleep(0.05)
    counters = frontend.get_counters(CHAOS_NAMESPACE)
    with open(args.out, "w") as f:
        json.dump({"counters": [
            {"u": c.set_variables["u"], "remaining": c.remaining}
            for c in counters
        ]}, f)
    lane.stop()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def free_port_pair() -> int:
    """A port p with p + 1 free too (the native ingress's pair)."""
    for _ in range(100):
        port = free_port()
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port + 1))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port pair")


#: stderr text of a member that could not bind a port picked free (another
#: process took it between the pick and the bind)
_BIND_FAILURES = ("Address already in use", "Failed to bind",
                  "could not bind", "cannot bind", "EADDRINUSE")

#: fresh ports a spawn may take after a bind failure
SPAWN_ATTEMPTS = 3


def _run_members(cmds, logs, timeout):
    """Run the members together until every one has exited: None when
    all exited 0, else the first failure's report. A member that fails
    stops the others at once (they would wait out their barriers for a
    peer that is gone). Every member gets ``timeout`` seconds of its own
    after the one before it, as one ``communicate`` each would."""
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as err:
            procs.append(subprocess.Popen(
                cmd["argv"], cwd=cmd["cwd"], env=cmd["env"],
                stdout=subprocess.DEVNULL, stderr=err, text=True))
    t0 = time.monotonic()
    deadline = t0 + timeout * len(procs)
    try:
        while True:
            codes = [proc.poll() for proc in procs]
            for pid, code in enumerate(codes):
                if code not in (None, 0):
                    return (f"pod worker {pid} failed (exit {code}, after "
                            f"{time.monotonic() - t0:.1f} s):\n"
                            f"{Path(logs[pid]).read_text()[-4000:]}")
            if all(code == 0 for code in codes):
                return None
            if time.monotonic() > deadline:
                waiting = [pid for pid, code in enumerate(codes)
                           if code is None]
                return (f"pod workers {waiting} still running after "
                        f"{time.monotonic() - t0:.1f} s:\n" + "\n".join(
                            Path(logs[pid]).read_text()[-2000:]
                            for pid in waiting))
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def spawn_pod(tmp_path, storage, device="cpu", timeout=90, prefix=(),
              mode="routed", pod_resize="off"):
    """Run the two members of a pod (this file's ``server`` mode) and
    return their reports; ``prefix`` goes between the interpreter and
    this file's path. Every wait has a deadline (``timeout`` seconds a
    member), and a member still running at the end is killed. The ports
    are picked free just before the members bind them, so another
    process may take one in between: a member that fails to bind starts
    the pod again on fresh ports (``SPAWN_ATTEMPTS`` in all)."""
    repo = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_POD_")}
    env["PYTHONPATH"] = str(repo)
    for attempt in range(SPAWN_ATTEMPTS):
        coordinator = f"127.0.0.1:{free_port()}"
        peer_ports = ",".join(str(free_port()) for _ in range(2))
        cmds, logs, outs = [], [], []
        for pid in range(2):
            out = Path(tmp_path) / f"pod-{storage}-{pid}.json"
            outs.append(out)
            logs.append(Path(tmp_path) / f"pod-{storage}-{pid}-{attempt}.err")
            cmds.append({"cwd": repo, "env": env, "argv": [
                sys.executable, *prefix, os.path.abspath(__file__),
                "server", "--process-id", str(pid), "--num-processes", "2",
                "--coordinator", coordinator, "--peer-ports", peer_ports,
                "--rls-port", str(free_port_pair()), "--http-port",
                str(free_port()), "--storage", storage, "--device", device,
                "--mode", mode, "--pod-resize", pod_resize,
                "--dir", str(tmp_path), "--out", str(out)]})
        failure = _run_members(cmds, logs, timeout)
        if failure is None:
            return [json.loads(out.read_text()) for out in outs]
        bind = any(marker in Path(log).read_text()
                   for log in logs for marker in _BIND_FAILURES)
        if not bind or attempt == SPAWN_ATTEMPTS - 1:
            raise AssertionError(failure)
    raise AssertionError("unreachable")


def drive_oracle(device="cpu", native=False):
    """The drive's answers and counters on a single-process 2-row
    TorchShardedStorage; ``native``: with the descriptor-keyed limits,
    the answers without a limit name (a ShouldRateLimit answer without
    headers carries none)."""
    from limitador_tpu_torch import RateLimiter
    from limitador_tpu_torch.device.sharded import TorchShardedStorage

    clock = Clock()
    oracle = RateLimiter(TorchShardedStorage(
        n_shards=2, local_capacity=4096, clock=clock, device=device))
    oracle.configure_with(drive_limits(native))
    want = {}
    for i in range(DRIVE_REQUESTS):
        clock.now = step_time(i)
        ns, user, _arrival = drive_request(i)
        r = oracle.check_rate_limited_and_update(
            ns, drive_context(user, native), 1, False)
        want[i] = {"limited": bool(r.limited)}
        if not native:
            want[i]["name"] = r.limit_name
    rows = []
    for ns in NAMESPACES:
        rows += counter_rows(oracle.get_counters(ns), ns)
    return want, sort_rows(rows)


def merge(results):
    """The pod's merged decisions, its sorted counter union and its
    routing tallies."""
    merged, counters, routed = {}, [], {}
    for result in results:
        for i, decision in result["decisions"].items():
            if int(i) in merged:
                raise AssertionError(f"drive step {i} decided twice")
            merged[int(i)] = decision
        counters += result["counters"]
        for key, value in result["router"].items():
            routed[key] = routed.get(key, 0) + value
    return merged, sort_rows(counters), routed


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=["server", "owner"])
    parser.add_argument("--process-id", type=int, default=0)
    parser.add_argument("--num-processes", type=int, default=2)
    parser.add_argument("--coordinator")
    parser.add_argument("--peer-ports")
    parser.add_argument("--rls-port", type=int)
    parser.add_argument("--http-port", type=int)
    parser.add_argument("--storage", default="sharded")
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--mode", default="routed",
                        choices=["routed", *NATIVE_MODES])
    parser.add_argument("--pod-resize", default="off",
                        choices=["on", "off"])
    parser.add_argument("--dir")
    parser.add_argument("--listen")
    parser.add_argument("--ready")
    parser.add_argument("--stop")
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    if args.mode == "owner":
        asyncio.run(serve_owner(args))
        return 0
    out = asyncio.run(serve_and_drive(args))
    with open(args.out, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
