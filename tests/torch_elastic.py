"""In-process elastic pods of either package (not a pytest module).

``elastic_pod`` builds the miniature pod of the JAX package's
``tests/test_pod_resize.py`` (``_elastic_pod``) and ``standby_pod`` the
one of ``tests/test_standby.py`` (``_standby_pod``), for the JAX package
(``"jax"``) or the port (``"port"``), on real gRPC peer lanes bound to
ports the kernel chose (a port picked free beforehand can be taken by
another test at the same moment): every lane starts with no peers, and
the members learn each other's addresses once all are bound.

``storage`` picks each host's limiter: ``"memory"`` (the JAX tests'
``RateLimiter(InMemoryStorage(4096))``), ``"device"`` (the server's
served build: an ``AsyncRateLimiter`` over the batched device storage,
``TorchStorage(device="cpu")`` in the port and ``TpuStorage`` in the JAX
package) or ``"device_sync"`` (a ``RateLimiter`` straight over the device
storage).
"""

import asyncio
import importlib
import json
import time

FROZEN_NOW = 1_700_000_000.0


def mod(pkg: str, name: str):
    root = "limitador_tpu" if pkg == "jax" else "limitador_tpu_torch"
    return importlib.import_module(f"{root}.{name}" if name else root)


def resilience(pkg: str):
    return mod(pkg, "server.peering").PodResilience(
        degraded=True, retry=True, breaker_failures=2,
        breaker_reset_s=0.2, probe_interval_s=0.1, retry_backoff_ms=1.0,
    )


def make_limiter(pkg: str, storage: str, clock=None):
    """One host's limiter (see the module docstring)."""
    core = mod(pkg, "")
    if storage == "memory":
        InMemory = mod(pkg, "storage.in_memory").InMemoryStorage
        kwargs = {} if clock is None else {"clock": clock}
        return core.RateLimiter(InMemory(4096, **kwargs))
    kwargs = {} if clock is None else {"clock": clock}
    if pkg == "jax":
        tpu = mod(pkg, "tpu")
        table = tpu.TpuStorage(capacity=256, **kwargs)
        if storage == "device_sync":
            return core.RateLimiter(table)
        return core.AsyncRateLimiter(tpu.AsyncTpuStorage(table,
                                                         max_delay=0.001))
    device = mod(pkg, "device")
    table = device.TorchStorage(capacity=256, device="cpu", **kwargs)
    if storage == "device_sync":
        return core.RateLimiter(table)
    return core.AsyncRateLimiter(device.AsyncTorchStorage(table,
                                                          max_delay=0.001))


def bound_lanes(pkg: str, n: int, cfg, prepare=None):
    """``n`` started lanes of ``pkg`` with no peers, each bound to a port
    the kernel chose (``prepare(lane)`` runs on each before it starts);
    returns (lanes, addresses)."""
    PeerLane = mod(pkg, "server.peering").PeerLane
    lanes = [PeerLane(h, "127.0.0.1:0", {}, None, resilience=cfg)
             for h in range(n)]
    for lane in lanes:
        if prepare is not None:
            prepare(lane)
        lane.start()
    return lanes, {h: f"127.0.0.1:{lane.port}" for h, lane in enumerate(lanes)}


def elastic_pod(pkg, n_members, n_total=None, limits=None,
                resize_kwargs=None, storage="memory", clock=None,
                prepare=None):
    """``n_members`` pod members plus idle running hosts up to
    ``n_total`` (each a pod of its own, the add_host targets), every host
    resize-armed. Returns (lanes, fronts, coords, addrs, limits)."""
    peering = mod(pkg, "server.peering")
    routing = mod(pkg, "routing")
    Coordinator = mod(pkg, "server.resize").PodResizeCoordinator
    Limit = mod(pkg, "").Limit
    n_total = n_total or n_members
    limits = limits or [Limit("elastic", 50, 300, [], ["u"], name="per_u")]
    cfg = resilience(pkg)
    lanes, addrs = bound_lanes(pkg, n_total, cfg, prepare)
    fronts, coords = [], []
    for host in range(n_total):
        member = host < n_members
        lane = lanes[host]
        if member:
            lane.set_peers({o: addrs[o] for o in range(n_members)
                            if o != host})
        front = peering.PodFrontend(
            make_limiter(pkg, storage, clock),
            routing.PodRouter(routing.PodTopology(
                hosts=n_members if member else n_total,
                host_id=host, shards_per_host=1,
            )),
            lane, resilience=cfg,
        )
        coordinator = Coordinator(
            front,
            peers={h: addrs[h]
                   for h in (range(n_members) if member else (host,))},
            listen_address=addrs[host],
            **(resize_kwargs or {}),
        )
        front.attach_resize(coordinator)
        asyncio.run(front.configure_with(limits))
        fronts.append(front)
        coords.append(coordinator)
    return lanes, fronts, coords, addrs, limits


def standby_pod(pkg, n_members, limits=None, warm=False, storage="memory",
                clock=None):
    """``n_members`` pod members and one memberless warm standby (the
    last of every list): the ``--standby on`` boot without the server.
    Returns (lanes, fronts, standby, addrs, limits)."""
    peering = mod(pkg, "server.peering")
    routing = mod(pkg, "routing")
    Coordinator = mod(pkg, "server.resize").PodResizeCoordinator
    WarmStandby = mod(pkg, "server.standby").WarmStandby
    Limit = mod(pkg, "").Limit
    limits = limits or [Limit("join", 50, 300, [], ["u"], name="per_u")]
    n_total = n_members + 1
    cfg = resilience(pkg)
    lanes, addrs = bound_lanes(pkg, n_total, cfg)
    fronts = []
    for host in range(n_total):
        member = host < n_members
        lane = lanes[host]
        if member:
            lane.set_peers({o: addrs[o] for o in range(n_members)
                            if o != host})
        else:
            lane.host_id = 0
        front = peering.PodFrontend(
            make_limiter(pkg, storage, clock),
            routing.PodRouter(routing.PodTopology(
                hosts=n_members if member else 1,
                host_id=host if member else 0, shards_per_host=1,
            )),
            lane, resilience=cfg,
        )
        coordinator = Coordinator(
            front,
            peers=({h: addrs[h] for h in range(n_members)}
                   if member else {}),
            listen_address=addrs[host],
        )
        front.attach_resize(coordinator)
        if member:
            asyncio.run(front.configure_with(limits))
        fronts.append(front)
    addr_list = [addrs[h] for h in range(n_total)]
    standby = WarmStandby(fronts[-1], fronts[-1].resize, warm_buckets=(8,))
    if warm:
        standby.warm()
    return lanes, fronts, standby, addr_list, limits


def check(pkg, front, user, ns="elastic", delta=1, loop=None):
    """One decision; a coroutine runs on ``loop`` (a device pod's one
    driving loop, so that its batchers bind once) or a fresh one."""
    Context = mod(pkg, "").Context
    out = front.check_rate_limited_and_update(
        ns, Context({"u": user}), delta, False)
    if not asyncio.iscoroutine(out):
        return out
    if loop is not None:
        return loop.run_until_complete(out)
    return asyncio.run(out)


def stop(lanes):
    """Stop the lanes and the executor threads their loops ran blocking
    handlers on (a migrate, a replay, a plan seed)."""
    for lane in lanes:
        lane.stop()
    for lane in lanes:
        executor = getattr(lane._loop, "_default_executor", None)
        if executor is not None:
            executor.shutdown(wait=True)


def close_limiters(fronts, loop):
    """Close the batched storages (their pools and threads) of a pod
    built with ``storage="device"`` on its driving ``loop``, then the
    loop."""
    async def close():
        for front in fronts:
            counters = front._limiter.storage.counters
            closer = getattr(counters, "close", None)
            if closer is not None:
                out = closer()
                if asyncio.iscoroutine(out):
                    await out

    loop.run_until_complete(close())
    loop.run_until_complete(loop.shutdown_default_executor())
    loop.close()
    # the pairs bound to a lane's loop, stopped before the close, keep
    # their pools: shut them
    for front in fronts:
        counters = front._limiter.storage.counters
        pairs = list(getattr(counters, "_loop_batchers", {}).values())
        pairs.append((counters.batcher, counters.update_batcher))
        for check_batcher, update_batcher in pairs:
            check_batcher._dispatch_pool.shutdown(wait=False)
            check_batcher._collect_pool.shutdown(wait=False)
            update_batcher._pool.shutdown(wait=False)


def cancel_watchdogs(coords):
    """Cancel the transition watchdogs a test left armed (a host whose
    lane the test stopped mid-transition never hears the abort)."""
    for coordinator in coords:
        watchdog = coordinator._watchdog
        if watchdog is not None:
            watchdog.cancel()


def counters_of(front, ns, loop=None):
    """{(limit name, variables): spent} of one host's counters."""
    got = front.get_counters(ns)
    if asyncio.iscoroutine(got):
        got = (loop.run_until_complete(got) if loop is not None
               else asyncio.run(got))
    return {(c.limit.name, tuple(sorted(c.set_variables.items()))):
            int(c.max_value) - int(c.remaining) for c in got}


def event_kinds(front):
    return [e["kind"] for e in front.events_debug()["events"]]


def wait_for(predicate, timeout=10.0, interval=0.02):
    """Wait until ``predicate()`` is true; returns whether it became so."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return bool(predicate())


def capturing(captured, host=1):
    """A ``prepare`` for ``bound_lanes``: host ``host``'s lane records
    every payload it serves (as JSON) in ``captured``, but the peers'
    federated-signal exchanges (``kind: "signals"``): a lane sends those
    on its own probe cadence once a peer has answered, not for the
    scenario, so a slow scenario would find one among its payloads."""
    def prepare(lane):
        if lane.host_id != host:
            return
        real = lane._serve_decide

        async def serve(blob, context):
            payload = json.loads(blob.decode())
            if payload.get("kind") != "signals":
                captured.append(payload)
            return await real(blob, context)

        lane._serve_decide = serve

    return prepare
