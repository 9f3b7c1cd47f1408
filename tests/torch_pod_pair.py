"""Two in-process hosts of the native pod fast path (not a pytest module).

``pod_pair`` builds two hosts over real gRPC peer lanes bound to ports
the kernel chose: each a ``TorchStorage`` on ``device``, a compiled
limiter behind a ``PodFrontend``, and a native pipeline wrapping the
frontend (so that its exact path keeps the routed semantics), armed by
``attach_pipeline``. It imports the port and numpy only, so the card's
machine, which has no JAX, runs it too (``test_torch_gpu.py``);
``test_torch_pod_native.py`` holds it against the JAX package on the CPU.
The limits are the native-lane fuzz corpus's
(``tests/torch_native_corpus.py``).
"""

import asyncio

from limitador_tpu_torch import Limit
from limitador_tpu_torch import routing as prouting

from .torch_native_corpus import FROZEN_NOW, NAMESPACES, limits


def bound_lanes(PeerLane, resilience=None):
    """Two started lanes of either package (``PeerLane``), each bound to
    a port the kernel chose and told the other's: a port picked free
    beforehand can be picked by another test at the same moment, and
    gRPC binds with SO_REUSEPORT."""
    lanes = [PeerLane(host, "127.0.0.1:0", {1 - host: "127.0.0.1:0"}, None,
                      resilience=resilience) for host in range(2)]
    for lane in lanes:
        lane.start()
    for host, lane in enumerate(lanes):
        lane.peers[1 - host] = f"127.0.0.1:{lanes[1 - host].port}"
    return lanes


def pod_pair(device="cpu", resilience=None, clock=lambda: FROZEN_NOW):
    """(pipelines, frontends, lanes, limiters) of hosts 0 and 1."""
    from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage
    from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
    from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
    from limitador_tpu_torch.server.peering import PeerLane, PodFrontend

    lanes = bound_lanes(PeerLane, resilience)
    pipelines, frontends, limiters = [], [], []
    for host, lane in enumerate(lanes):
        limiter = CompiledTorchLimiter(AsyncTorchStorage(
            TorchStorage(capacity=1 << 12, clock=clock, device=device),
            max_delay=0.001))
        frontend = PodFrontend(
            limiter, prouting.PodRouter(prouting.PodTopology(2, host, 1)),
            lane, resilience=resilience)
        asyncio.run(frontend.configure_with(limits(Limit)))
        pipeline = NativeRlsPipeline(frontend, max_delay=0.001,
                                     hot_lane=True)
        frontend.attach_pipeline(pipeline)
        pipelines.append(pipeline)
        frontends.append(frontend)
        limiters.append(limiter)
    return pipelines, frontends, lanes, limiters


def close_pair(pipelines, lanes, limiters):
    """Stop the lanes, then close the pipelines and the batched storages
    (their pools and threads)."""
    for lane in lanes:
        lane.stop()

    async def close():
        for pipeline, limiter in zip(pipelines, limiters):
            await pipeline.close()
            await limiter.storage.counters.close()

    asyncio.run(close())


def counter_state(counters_of):
    """Comparable counters of the corpus's namespaces: (namespace, limit
    name, variables, remaining, expires_in to the ms)."""
    out = set()
    for ns in NAMESPACES:
        for c in counters_of(ns):
            out.add((str(c.namespace), c.limit.name,
                     tuple(sorted((c.set_variables or {}).items())),
                     c.remaining, round(c.expires_in or 0.0, 3)))
    return out


def port_state(limiter):
    """``counter_state`` of a compiled (async) limiter."""
    async def collect(ns):
        return await limiter.get_counters(ns)

    loop = asyncio.new_event_loop()
    try:
        return counter_state(lambda ns: loop.run_until_complete(collect(ns)))
    finally:
        loop.close()
