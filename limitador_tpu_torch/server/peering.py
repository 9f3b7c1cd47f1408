"""The pod's peer lane and the shard-aware routed frontend.

Counterpart of ``limitador_tpu/server/peering.py`` (``PeerLane``,
``PodFrontend`` and the resilience plane). Each pod process runs its own
complete serving stack; a decision whose counters another host owns is
forwarded once over a gRPC lane to that owner, which decides it on its
own table (B1 on ``torch`` storage, B7a on ``sharded``). Locally owned
traffic never touches this module's network code.

The lane follows the replication broker's plumbing: a daemon thread
owning its own asyncio loop, a ``grpc.aio`` server registered through a
generic handler (the payload is a self-describing JSON blob), a channel
a peer with lazy dial and per-call deadlines, and every failure a
counted verdict (a dead peer fails that request; it never wedges the
serving loop).

``PodFrontend`` wraps the process's limiter with the routing verdict
(``routing.PodRouter``): LOCAL decides through the wrapped limiter;
FORWARD and PINNED send (namespace, context bindings, delta) to the
owner host and adopt its CheckResult. Attribute access delegates to
the wrapped limiter, so the RLS and HTTP planes and the metrics see the
frontend as the limiter itself (``is_async_limiter``);
``library_stats`` adds the ``pod_*`` families.

Resilience, so that a dead owner degrades instead of failing its keys:

* **Peer health** (:class:`PeerHealth`): per-peer up/suspect/down from
  consecutive forward failures and deadline misses, background probes
  on the lane's loop, and a channel re-dial on every trip, so that a
  peer restarted on the same address gets a fresh dial.
* **Retry and hedging**: one jittered-backoff retry for idempotent
  check forwards once a peer is suspect, and an opt-in hedge
  (``--pod-hedge-ms``) that races a second attempt on a fresh channel,
  both inside the forward deadline.
* **Degraded-owner failover** (``--pod-degraded-mode``): forward
  failures feed a per-peer circuit breaker (the admission plane's
  ``CircuitBreaker``); while it is away from closed, that owner's
  forwarded traffic is decided on a local exact stand-in
  (``storage/failover.py``) that journals every admitted delta. When the
  probe finds the peer serving again, the journal replays through the
  lane into the owner's ``apply_deltas`` (B2's host form on ``torch``,
  B7c's on ``sharded``), the stand-in drains and routing flips back.

Observability: a forward carries the origin's ``x-request-id`` and W3C
trace context in its gRPC metadata; the owner adopts the id, opens a
``pod_peer_decide`` span linked to the origin's and reports its decide
time back, and the origin records the hop's breakdown (queue /
serialize / wire / remote_decide) into ``pod_hop_phase_ms`` and the
flight recorder (``observability/pod_plane.py``). Each host's
ControlSignals column is exchanged on the probe cadence (``kind:
"signals"``) into ``GET /debug/pod``, and every health, breaker,
degraded, replay and routing-epoch transition lands in the
``PodEventLog`` (``GET /debug/events``).

The native pod fast path: ``PodFrontend.attach_pipeline`` arms the
native pipeline's foreign split (``attach_pod``) and serves the lane's
``bulk_decide`` kind with the pipeline's ``decide_blobs_for_peer``. A
flush sends each owner's foreign rows in one ``forward_bulk`` (an open
breaker refuses it before it is sent; a failed hop answers every row
None, and the pipeline decides each through the frontend's exact path),
counted in ``pod_bulk_forward_batches``/``pod_bulk_forward_rows`` and,
on the owner, ``pod_bulk_served_rows``. The ``flight`` kind answers a
triggered peer's flight engine with this host's rings over its incident
window (``admin_call`` is the engine's blocking client).

The elastic pod (``server/resize.py``): ``PodFrontend.attach_resize``
arms the topology-epoch gate. Forwards, bulk hops and their flight
entries then carry the topology epoch (``tepoch``), and an owner on
another epoch answers the typed rerouteable ``stale_epoch`` instead of
deciding a key it does not own; the origin adopts the newer topology the
rejection carries and re-plans in band (a bulk hop answers all-None, so
that each row takes its per-request path). The lane kinds
``resize_admin``, ``migrate``, ``join_admin``, ``plan_seed`` and
``psum_share`` go to the coordinator, the frontend's plan seed and the
psum transport once each is attached; unattached, they answer as the JAX
lane answers them. Without a coordinator the wire carries no ``tepoch``
and every forward serves.
"""

from __future__ import annotations

import asyncio
import base64
import collections
import hashlib
import inspect
import json
import logging
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..admission.breaker import BreakerState, CircuitBreaker
from ..core.cel import Context
from ..core.counter import Counter
from ..core.limit import Limit, Namespace
from ..core.limiter import (
    AsyncRateLimiter,
    CheckResult,
    _counters_that_apply,
)
from ..observability.device_plane import (
    current_request_id,
    set_request_id,
)
from ..observability.events import PodEventLog
from ..observability.pod_plane import PodHopRecorder, PodSignalAggregator
from ..observability.tracing import hop_trace_metadata, peer_decide_span
from ..routing import LOCAL, PodRouter, counter_key
from ..storage.base import StorageError
from ..storage.failover import FailoverStore

__all__ = [
    "PeerLane",
    "PodFrontend",
    "PodResilience",
    "PeerHealth",
    "PeerState",
    "FaultInjector",
    "PEER_SERVICE",
    "PEER_METHOD",
    "METRIC_FAMILIES",
    "STALE_EPOCH",
    "psum_share_sender",
]

log = logging.getLogger("limitador_tpu_torch.pod")

PEER_SERVICE = "limitador.service.pod.v1.PodPeer"
PEER_METHOD = f"/{PEER_SERVICE}/Decide"

#: per-forward deadline: a peer slower than this fails the forward.
#: Generous enough for an owner's first launch on a cold kernel build.
FORWARD_TIMEOUT_SECONDS = 10.0

#: forward-latency reservoir size for the pod_peer_p99_ms gauge
_LATENCY_WINDOW = 2048

#: forward kinds safe to retry or hedge: a duplicated check at worst
#: counts one delta twice (a limiter can then only under-admit);
#: update_counters and apply_deltas carry their own replay semantics and
#: are never retried by the lane.
RETRYABLE_KINDS = frozenset({
    "check_and_update", "is_rate_limited", "ping", "bulk_decide",
})

#: families of the resilience plane (polled off library_stats): peer
#: health and retry/hedge traffic from the lane, degraded-owner failover
#: from the frontend
METRIC_FAMILIES = (
    "peer_health_state",
    "peer_health_retries",
    "peer_health_hedges_won",
    "peer_health_hedges_lost",
    "peer_health_redials",
    "peer_health_probes",
    "pod_failover_degraded_decisions",
    "pod_failover_journal_depth",
    "pod_failover_breaker_open",
    "pod_failover_reconciles",
    "pod_failover_replayed_deltas",
    "pod_failover_reconcile_seconds",
    "pod_failover_seconds",
    # the bulk-forward lane of the native pod fast path: a flush's
    # foreign rows ride ONE RPC an owner; rows / batches = the mean
    # bulk batch
    "pod_bulk_forward_batches",
    "pod_bulk_forward_rows",
    "pod_bulk_served_rows",
)

#: the typed rerouteable status of a wrong-epoch forward: the owner's
#: gate answers it instead of deciding a key it does not (or does not
#: yet) own; the origin adopts the newer topology and re-plans
STALE_EPOCH = "stale_epoch"

#: what the lane answers for the request kinds of the elastic pod with
#: no handler attached, as the JAX lane answers them
_UNARMED = {
    "resize_admin": {"ok": False, "error": "pod resize not armed"},
    "migrate": {"ok": False, "error": "pod resize not armed"},
    "join_admin": {"ok": False, "error": "fast join not armed"},
    "plan_seed": {"ok": False, "error": "fast join not armed"},
    "psum_share": {"ok": True},
}


def _encode_context(ctx: Context) -> dict:
    return {
        "variables": sorted(ctx.variables),
        "bindings": ctx._bindings,
    }


def _decode_context(blob: dict) -> Context:
    ctx = Context()
    ctx.variables = set(blob.get("variables", ()))
    ctx._bindings = dict(blob.get("bindings", {}))
    return ctx


def _counter_to_wire(counter: Counter, delta: int) -> dict:
    """JSON-safe identity of a journaled counter delta, so that the
    owner rebuilds a Counter that hashes identically in its own storage.
    ``policy`` is part of the identity (a fixed-window and a token-bucket
    limit with equal parameters are different limits)."""
    limit = counter.limit
    return {
        "ns": str(limit.namespace),
        "max": limit.max_value,
        "seconds": limit.seconds,
        "conditions": sorted(c.source for c in limit.conditions),
        "variables": sorted(v.source for v in limit.variables),
        "name": limit.name,
        "id": limit.id,
        "policy": limit.policy,
        "vars": sorted(counter.set_variables.items()),
        "delta": int(delta),
    }


def _counter_from_wire(blob: dict) -> Tuple[Counter, int]:
    limit = Limit(
        blob["ns"], blob["max"], blob["seconds"],
        blob.get("conditions", ()), blob.get("variables", ()),
        name=blob.get("name"), id=blob.get("id"),
        policy=blob.get("policy", "fixed_window"),
    )
    return Counter(limit, dict(blob.get("vars", ()))), int(blob["delta"])


def _wire_request_id(request_id: Optional[str]) -> Optional[str]:
    """The id as it may ride gRPC metadata. The id comes from an
    unvalidated client header, and gRPC rejects non-printable or
    non-ASCII metadata at call time, which would fail the forward and
    mark a healthy peer suspect: such characters are dropped, and an id
    left empty stays off the wire."""
    if not request_id:
        return None
    rid = str(request_id)[:128]
    if not (rid.isascii() and rid.isprintable()):
        rid = "".join(
            c for c in rid if c.isascii() and c.isprintable()
        )[:128]
    return rid or None


def _is_deadline_miss(exc: BaseException) -> bool:
    if isinstance(exc, (TimeoutError, asyncio.TimeoutError)):
        return True
    return "DEADLINE_EXCEEDED" in f"{exc}"


class PodResilience:
    """Pod resilience knobs (``--pod-hedge-ms``, ``--pod-peer-breaker-*``,
    ``--pod-degraded-mode``). :meth:`legacy` is the posture every direct
    construction defaults to: no retry, no hedge, no breaker or failover
    (a peer failure fails that request)."""

    def __init__(
        self,
        degraded: bool = True,
        retry: bool = True,
        hedge_ms: float = 0.0,
        retry_backoff_ms: float = 1.0,
        breaker_failures: int = 3,
        breaker_reset_s: float = 2.0,
        suspect_after: int = 1,
        down_after: int = 3,
        probe_interval_s: float = 0.5,
        probe_timeout_s: float = 1.0,
        deadline_s: float = FORWARD_TIMEOUT_SECONDS,
        journal_cache: int = 100_000,
    ):
        self.degraded = bool(degraded)
        self.retry = bool(retry)
        self.hedge_ms = float(hedge_ms)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.breaker_failures = max(int(breaker_failures), 1)
        self.breaker_reset_s = float(breaker_reset_s)
        self.suspect_after = max(int(suspect_after), 1)
        self.down_after = max(int(down_after), self.suspect_after)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.deadline_s = float(deadline_s)
        self.journal_cache = int(journal_cache)

    @classmethod
    def legacy(cls) -> "PodResilience":
        return cls(degraded=False, retry=False, hedge_ms=0.0)


class PeerState:
    UP = "up"
    SUSPECT = "suspect"
    DOWN = "down"

    #: gauge encoding for peer_health_state
    GAUGE = {UP: 0, SUSPECT: 1, DOWN: 2}


class PeerHealth:
    """Per-peer up/suspect/down from consecutive failures. Thread-safe:
    forwards fail from serving loops, probes succeed on the lane loop,
    recovery completes on its own thread. Transitions are returned to
    the caller (never called back under the lock), so that the lane
    re-dials exactly once a trip."""

    def __init__(
        self, peers, suspect_after: int = 1, down_after: int = 3
    ):
        self.suspect_after = max(int(suspect_after), 1)
        self.down_after = max(int(down_after), self.suspect_after)
        self._health_lock = threading.Lock()
        self._state: Dict[int, str] = {p: PeerState.UP for p in peers}
        self._failures: Dict[int, int] = {p: 0 for p in peers}
        self.transitions = 0
        self.deadline_misses = 0

    def state(self, peer: int) -> str:
        with self._health_lock:
            return self._state.get(peer, PeerState.UP)

    def states(self) -> Dict[int, int]:
        """peer -> gauge encoding (rendered as peer_health_state)."""
        with self._health_lock:
            return {
                p: PeerState.GAUGE[s] for p, s in self._state.items()
            }

    def record_failure(
        self, peer: int, deadline_miss: bool = False
    ) -> Optional[str]:
        """Count one failed forward or probe; returns the new state when
        this call moved the peer (the lane re-dials on it)."""
        with self._health_lock:
            if peer not in self._state:
                return None
            if deadline_miss:
                self.deadline_misses += 1
            self._failures[peer] = self._failures.get(peer, 0) + 1
            fails = self._failures[peer]
            new = (
                PeerState.DOWN if fails >= self.down_after
                else PeerState.SUSPECT if fails >= self.suspect_after
                else PeerState.UP
            )
            if new == self._state[peer]:
                return None
            self._state[peer] = new
            self.transitions += 1
            return new

    def set_peers(self, peers) -> None:
        """Adopt a new peer set (a membership change): new peers start up
        with a clean failure count, departed peers drop out."""
        with self._health_lock:
            peers = set(peers)
            for peer in peers - set(self._state):
                self._state[peer] = PeerState.UP
                self._failures[peer] = 0
            for peer in set(self._state) - peers:
                self._state.pop(peer, None)
                self._failures.pop(peer, None)

    def record_success(self, peer: int) -> Optional[str]:
        with self._health_lock:
            if peer not in self._state:
                return None
            self._failures[peer] = 0
            if self._state[peer] == PeerState.UP:
                return None
            self._state[peer] = PeerState.UP
            self.transitions += 1
            return PeerState.UP


class FaultInjector:
    """Deterministic per-peer fault shim for pod drills.

    Applied on the lane loop just before a forward or probe attempt
    dials its peer, so that every failure mode runs the real resilience
    path (health trips, retries, breaker, failover). Modes:

    * ``drop``      — the dial fails at once (ConnectionError);
    * ``error``     — the call fails at once (RuntimeError);
    * ``delay``     — the call waits ``delay_ms``, then proceeds;
    * ``blackhole`` — the call takes its whole deadline and times out.

    Seeded from the environment for subprocess drills: ``TPU_POD_FAULTS``
    is a comma-separated list of ``peer:mode[:probability[:times]]``
    rules (``1:drop``, ``1:error:0.5``, ``0:delay:1:3``),
    ``TPU_POD_FAULT_SEED`` seeds the probability draws so that a drill
    replays identically, and ``TPU_POD_FAULT_DELAY_MS`` sets the delay."""

    MODES = ("drop", "delay", "error", "blackhole")

    def __init__(self, seed: int = 0, delay_ms: float = 100.0):
        self._rng = random.Random(seed)
        self.delay_ms = float(delay_ms)
        # peer -> [mode, probability, remaining_times (None = forever)]
        self._rules: Dict[int, list] = {}
        self.injected = 0

    @classmethod
    def from_env(cls, env=None) -> "FaultInjector":
        env = os.environ if env is None else env
        injector = cls(
            seed=int(env.get("TPU_POD_FAULT_SEED", "0") or 0),
            delay_ms=float(env.get("TPU_POD_FAULT_DELAY_MS", "100") or 100),
        )
        spec = env.get("TPU_POD_FAULTS", "")
        for rule in spec.split(","):
            rule = rule.strip()
            if not rule:
                continue
            parts = rule.split(":")
            if len(parts) < 2 or parts[1] not in cls.MODES:
                raise ValueError(
                    f"TPU_POD_FAULTS rule '{rule}' is not "
                    "peer:mode[:probability[:times]] with mode in "
                    f"{cls.MODES}"
                )
            injector.set_fault(
                int(parts[0]), parts[1],
                p=float(parts[2]) if len(parts) > 2 else 1.0,
                times=int(parts[3]) if len(parts) > 3 else None,
            )
        return injector

    def set_fault(
        self, peer: int, mode: str, p: float = 1.0,
        times: Optional[int] = None,
    ) -> None:
        if mode not in self.MODES:
            raise ValueError(f"unknown fault mode '{mode}'")
        self._rules[int(peer)] = [mode, float(p), times]

    def clear(self, peer: Optional[int] = None) -> None:
        if peer is None:
            self._rules.clear()
        else:
            self._rules.pop(int(peer), None)

    def verdict(self, peer: int) -> Optional[str]:
        """The fault (or None) this attempt draws: deterministic under a
        fixed seed and call sequence."""
        rule = self._rules.get(int(peer))
        if rule is None:
            return None
        mode, p, times = rule
        if times is not None and times <= 0:
            return None
        if p < 1.0 and self._rng.random() >= p:
            return None
        if times is not None:
            rule[2] = times - 1
        self.injected += 1
        return mode

    async def apply(self, peer: int, timeout: float) -> None:
        """Raise or delay per the drawn verdict (lane loop only)."""
        mode = self.verdict(peer)
        if mode is None:
            return
        if mode == "drop":
            raise ConnectionError(f"injected drop for peer {peer}")
        if mode == "error":
            raise RuntimeError(f"injected error for peer {peer}")
        if mode == "delay":
            await asyncio.sleep(self.delay_ms / 1e3)
            return
        # blackhole: the peer never answers, the deadline is spent
        await asyncio.sleep(max(float(timeout), 0.0))
        raise TimeoutError(f"injected blackhole for peer {peer}")


class PeerLane:
    """The host-to-host forwarding lane: serves ``Decide`` for peers and
    dials peers for this host's forwards. ``decide_cb`` is an async
    callable ``(namespace, ctx, delta, load, kind) -> CheckResult or
    None`` run on the lane loop: the owner-side local decision.
    ``apply_cb`` (set by the frontend) applies a recovered peer's
    journal replay through the local storage's ``apply_deltas``."""

    def __init__(
        self,
        host_id: int,
        listen_address: str,
        peers: Dict[int, str],
        decide_cb,
        resilience: Optional[PodResilience] = None,
    ):
        self.host_id = host_id
        self.listen_address = listen_address
        self.peers = dict(peers)
        self.decide_cb = decide_cb
        self.apply_cb: Optional[Callable[[list], int]] = None
        #: async callable (blobs) -> [payload or None]: the owner's side
        #: of a bulk forward (the native pipeline's
        #: ``decide_blobs_for_peer``, set by ``attach_pipeline``)
        self.bulk_cb = None
        #: elastic pod attach points, wired by ``attach_resize`` (None:
        #: no epoch on the wire, every forward serves).
        #: ``epoch_provider`` -> the topology epoch (stamped on
        #: forwards, gated on serves); ``stale_info_provider`` -> the
        #: topology and peers a stale rejection carries;
        #: ``migrate_cb(payload) -> dict`` applies one migrated slice
        #: batch (blocking, run off the loop); ``resize_cb(payload) ->
        #: dict`` answers the resize control ops (fast, on the loop)
        self.epoch_provider: Optional[Callable[[], int]] = None
        self.stale_info_provider: Optional[Callable[[], dict]] = None
        self.migrate_cb = None
        self.resize_cb = None
        #: the fast join's attach points: ``plan_seed_cb(payload) ->
        #: dict`` imports a shipped plan seed (off the loop);
        #: ``join_cb(payload)`` answers the join ops (a dict, or a
        #: coroutine the loop awaits); ``psum_share_cb(host, raw)``
        #: delivers a peer's psum partials to the PeerPsumTransport
        self.plan_seed_cb = None
        self.join_cb = None
        self.psum_share_cb = None
        #: callable(resp dict): a forward came back stale_epoch (the
        #: origin's adoption, ``PodResizeCoordinator.adopt_remote``)
        self.on_stale = None
        self.stale_rejects = 0
        #: sync callable (host) -> bool run on a recovery thread when a
        #: probe finds a non-up peer answering again; True marks the
        #: peer up (the frontend replays its journal first)
        self.on_peer_recovered: Optional[Callable[[int], bool]] = None
        #: optional (host) -> bool: True while the host still needs
        #: recovery work (breaker away from closed, or a journal awaiting
        #: replay) even though its health is up: a failure below the
        #: threshold journals a delta without downing the peer
        self.probe_needed: Optional[Callable[[int], bool]] = None
        self.cfg = resilience or PodResilience.legacy()
        self.health = PeerHealth(
            self.peers,
            suspect_after=self.cfg.suspect_after,
            down_after=self.cfg.down_after,
        )
        # Armed fault rules are loud (a TPU_POD_FAULTS left in the
        # environment would otherwise degrade live traffic quietly), and
        # a malformed spec does not stop a pod host's start.
        try:
            self.faults = FaultInjector.from_env()
        except ValueError as exc:
            log.warning(f"ignoring malformed TPU_POD_FAULTS: {exc}")
            self.faults = FaultInjector()
        if self.faults._rules:
            log.warning(
                "pod fault injection ARMED (TPU_POD_FAULTS): "
                f"{self.faults._rules}"
            )
        self.forwards = 0
        self.served = 0
        self.errors = 0
        self.retries = 0
        self.hedges_won = 0
        self.hedges_lost = 0
        self.redials = 0
        self.probes = 0
        self.bulk_forwards = 0
        self.bulk_forward_rows = 0
        self.bulk_served_rows = 0
        # Observability attach points (None = no cost), wired by the
        # frontend.
        #: PodEventLog: typed lane events (health trips, redials, hedges)
        self.events: Optional[PodEventLog] = None
        #: callable(host, request_id, namespace, total_s, phases_s): the
        #: per-hop breakdown of one completed forward
        self.on_hop = None
        #: callable() -> dict: this host's signal column, exchanged with
        #: every peer on the probe cadence
        self.signals_provider = None
        #: callable(host, payload): a peer's signal column arrived
        self.on_peer_signals = None
        #: DeviceStatsRecorder (or a bare device-plane FlightRecorder):
        #: decisions this host decides for peers land here with the
        #: origin's request id
        self.recorder = None
        #: flight.FlightRecorder: owner-side decides tap its
        #: ``pod_forward`` lane
        self.flight = None
        self.signal_exchanges = 0
        self.signal_exchange_failures = 0
        self._signal_inflight: set = set()
        # Guards the latency reservoir: forwards append from serving
        # loops while the render thread sorts a copy.
        self._latency_lock = threading.Lock()
        self._latencies_ms = collections.deque(maxlen=_LATENCY_WINDOW)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server = None
        self._channels: dict = {}
        self._recovering: set = set()
        self._probing: set = set()
        self._stopping = threading.Event()
        self._started = threading.Event()
        self.port: Optional[int] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._thread_main,
            name=f"pod-peer-{self.host_id}",
            daemon=True,
        )
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("pod peer lane failed to start")

    def _thread_main(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self._amain())

    async def _amain(self) -> None:
        import grpc

        self._server = grpc.aio.server()
        handler = grpc.method_handlers_generic_handler(
            PEER_SERVICE,
            {
                "Decide": grpc.unary_unary_rpc_method_handler(
                    self._serve_decide,
                    request_deserializer=bytes,
                    response_serializer=bytes,
                )
            },
        )
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(self.listen_address)
        await self._server.start()
        self._started.set()
        # Probes ride this loop: while the frontend degrades a down
        # owner's traffic, they are the only path that notices the owner
        # serving again and starts the journal replay (recovery never
        # depends on live traffic).
        next_probe = self._loop.time()
        while not self._stopping.is_set():
            await asyncio.sleep(0.1)
            if not self.peers:
                continue
            now = self._loop.time()
            if now < next_probe:
                continue
            next_probe = now + self.cfg.probe_interval_s
            if self.cfg.degraded:
                for host in list(self.peers):
                    if self.health.state(host) != PeerState.UP or (
                        self.probe_needed is not None
                        and self.probe_needed(host)
                    ):
                        asyncio.ensure_future(self._probe(host))
            # The federated signal exchange rides the same cadence, with
            # peers believed up only (a down peer's column goes stale,
            # which is itself the signal).
            if self.signals_provider is not None:
                for host in list(self.peers):
                    if self.health.state(host) == PeerState.UP:
                        asyncio.ensure_future(
                            self._exchange_signals(host)
                        )
        for channel, _call in self._channels.values():
            await channel.close()
        await self._server.stop(grace=0.5)
        # the threads that ran blocking handlers (a replay, a migrate, a
        # plan seed) end with the lane
        await self._loop.shutdown_default_executor()

    def stop(self) -> None:
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def set_peers(self, peers: Dict[int, str]) -> None:
        """Adopt a new peer map on a running lane (a membership change),
        from any thread: the dict swap is atomic, health adds and removes
        under its own lock, and the cached channels of departed peers (or
        of a host id whose address moved, a standby taking a dead
        member's id) are closed on the lane loop."""
        peers = {int(h): str(addr) for h, addr in peers.items()}
        peers.pop(self.host_id, None)
        old = self.peers
        self.peers = peers
        self.health.set_peers(peers)
        stale = [h for h in old if h not in peers] + [
            h for h, addr in peers.items()
            if h in old and old[h] != addr
        ]
        loop = self._loop
        if stale and loop is not None and loop.is_running():
            def _close_stale():
                for host in stale:
                    entry = self._channels.pop(host, None)
                    if entry is not None:
                        asyncio.ensure_future(entry[0].close())
            loop.call_soon_threadsafe(_close_stale)

    # -- server side ---------------------------------------------------------

    def _stale_response(self) -> bytes:
        """The typed rerouteable rejection of a wrong-epoch forward: this
        host's topology epoch and, with the resize plane armed, its
        topology and peers, so that a behind origin adopts and re-plans."""
        self.stale_rejects += 1
        provider = self.epoch_provider
        out = {
            "ok": False,
            STALE_EPOCH: True,
            "tepoch": int(provider()) if provider is not None else 0,
        }
        info_provider = self.stale_info_provider
        if info_provider is not None:
            try:
                out.update(info_provider() or {})
            except Exception:
                pass
        return json.dumps(out).encode()

    def _epoch_mismatch(self, payload: dict) -> bool:
        """The owner's epoch gate: one int compare a payload (a batch on
        the bulk path, never a row), and only with the resize plane
        armed here; an unstamped payload serves."""
        provider = self.epoch_provider
        if provider is None or "tepoch" not in payload:
            return False
        return int(payload["tepoch"]) != int(provider())

    async def _serve_elastic(self, kind: str, payload: dict) -> bytes:
        """The elastic pod's kinds: the resize and join control ops on
        the loop (a lock and a state flip), a migrate batch and a plan
        seed off it (blocking table work), a psum share inline."""
        if kind == "resize_admin" or kind == "join_admin":
            handler = self.resize_cb if kind == "resize_admin" \
                else self.join_cb
            if handler is None:
                return json.dumps(_UNARMED[kind]).encode()
            try:
                out = handler(payload)
                if inspect.isawaitable(out):
                    # the joiner's "limits" op runs configure_with, a
                    # coroutine on this loop
                    out = await out
                out = out or {}
            except Exception as exc:
                out = {"ok": False, "error": f"{exc}"[:200]}
            return json.dumps(out).encode()
        if kind == "psum_share":
            hook = self.psum_share_cb
            if hook is not None:
                try:
                    hook(
                        int(payload.get("from", -1)),
                        base64.b64decode(payload.get("payload") or b""),
                    )
                except Exception:
                    pass
            return json.dumps({"ok": True}).encode()
        # plan_seed is not epoch-gated: it lands on a joiner mid-adoption,
        # and the cache's put() discards rows whose limits epoch moved.
        # A migrate stamped for a transition this host has left must not
        # seed counters it does not own.
        handler = self.migrate_cb if kind == "migrate" \
            else self.plan_seed_cb
        if handler is None:
            return json.dumps(_UNARMED[kind]).encode()
        if kind == "migrate" and self._epoch_mismatch(payload):
            return self._stale_response()
        out = await asyncio.get_running_loop().run_in_executor(
            None, handler, payload
        )
        return json.dumps(out or {"ok": True}).encode()

    async def _serve_decide(self, blob: bytes, context) -> bytes:
        payload = json.loads(blob.decode())
        kind = payload.get("kind", "check_and_update")
        if kind == "ping":
            return json.dumps({"ok": True, "pong": True}).encode()
        if kind in _UNARMED:
            return await self._serve_elastic(kind, payload)
        if kind == "flight":
            # A triggered peer asks for this host's rings over its
            # incident window; contribute() is one lock and list copies,
            # fine inline on the lane loop.
            flight = self.flight
            if flight is None:
                return json.dumps({
                    "ok": False, "error": "no flight recorder attached",
                }).encode()
            return json.dumps({
                "ok": True,
                "flight": flight.contribute(
                    payload.get("t0"), payload.get("t1")
                ),
            }).encode()
        if kind == "bulk_decide":
            if self._epoch_mismatch(payload):
                # a whole batch routed by a dead topology: one rejection
                # (one compare a batch); the origin re-plans every row
                return self._stale_response()
            return await self._serve_bulk(payload, context)
        if kind == "signals":
            # Ingest the caller's column, answer with ours: one RPC a
            # pair a cadence, never on the decision path.
            hook = self.on_peer_signals
            if hook is not None:
                try:
                    hook(
                        int(payload.get("from", -1)),
                        payload.get("signals") or {},
                    )
                except Exception:
                    pass  # a bad column must not fail the exchange
            mine: dict = {}
            provider = self.signals_provider
            if provider is not None:
                try:
                    mine = provider()
                except Exception:
                    mine = {}
            return json.dumps({"ok": True, "signals": mine}).encode()
        if kind == "apply_deltas":
            if self.apply_cb is None:
                raise RuntimeError(
                    "pod peer lane has no apply_deltas handler"
                )
            # Off the loop: a replay into a device table is a blocking,
            # lock-taking apply, and inline it would stall every peer's
            # forwards (and this host's probes) behind the catch-up.
            applied = await asyncio.get_running_loop().run_in_executor(
                None, self.apply_cb, payload.get("deltas", [])
            )
            return json.dumps({"ok": True, "applied": int(applied)}).encode()
        if self._epoch_mismatch(payload):
            # a unary forward (FORWARD and PINNED alike) stamped with an
            # epoch this host is not on would be decided by a wrong owner
            return self._stale_response()
        self.served += 1
        # Adopt the origin's request id for this task's context, so that
        # this host's flight entries and spans correlate with the hop's
        # originating request.
        meta: dict = {}
        try:
            meta = dict(context.invocation_metadata() or ())
        except Exception:
            meta = {}
        rid = meta.get("x-request-id")
        if rid is not None:
            set_request_id(str(rid))
        t_decide = time.perf_counter()
        with peer_decide_span(payload["ns"], rid, meta):
            result = await self.decide_cb(
                payload["ns"],
                _decode_context(payload["ctx"]),
                int(payload["delta"]),
                bool(payload.get("load", False)),
                kind,
            )
        decide_s = time.perf_counter() - t_decide
        tap = self.flight
        if tap is not None:
            # Owner-side exemplar of a forwarded decision, with the
            # origin's request id, so that one bundle shows both sides.
            tap.tap(
                decide_s, "pod_forward",
                request_id=str(rid) if rid is not None else None,
                namespace=str(payload["ns"]),
                phases_ms={
                    "pod_remote_decide": round(decide_s * 1e3, 4),
                },
            )
        recorder = self.recorder
        if recorder is not None:
            flight = getattr(recorder, "flight", recorder)
            if flight.would_admit(decide_s):
                # The owner-side record of a forwarded decision, for
                # every storage (the batched ones also record through
                # the request-id contextvar).
                flight.offer(decide_s, {
                    "request_id": str(rid) if rid is not None else None,
                    "namespace": str(payload["ns"]),
                    "batch_id": None,
                    "queue_wait_ms": 0.0,
                    "phases_ms": {
                        "pod_remote_decide": round(decide_s * 1e3, 4),
                    },
                    "pod_hop": {
                        "origin": int(payload.get("from", -1)),
                        "host": self.host_id,
                    },
                })
        out: dict = {"ok": True, "decide_ns": int(decide_s * 1e9)}
        if isinstance(result, CheckResult):
            out["limited"] = bool(result.limited)
            out["name"] = result.limit_name
            out["counters"] = [
                {
                    "max": c.max_value,
                    "remaining": c.remaining,
                    "expires_in": c.expires_in,
                    "window": c.window_seconds,
                    "name": c.limit.name if c.limit is not None else None,
                }
                for c in result.counters
            ]
        return json.dumps(out).encode()

    # -- client side ---------------------------------------------------------

    async def _serve_bulk(self, payload: dict, context) -> bytes:
        """A peer's flush of foreign raw request blobs, decided here in
        one local bulk pass. The hop's metadata rides as a single
        forward's does: the origin's request id is adopted, so that this
        host's flight entries and spans correlate with the origin's."""
        handler = self.bulk_cb
        if handler is None:
            raise RuntimeError(
                "pod peer lane has no bulk_decide handler (native "
                "pipeline not attached)"
            )
        meta: dict = {}
        try:
            meta = dict(context.invocation_metadata() or ())
        except Exception:
            meta = {}
        rid = meta.get("x-request-id")
        if rid is not None:
            set_request_id(str(rid))
        blobs = [base64.b64decode(b) for b in payload.get("blobs", ())]
        self.bulk_served_rows += len(blobs)
        self.served += 1
        t_decide = time.perf_counter()
        with peer_decide_span("_bulk", rid, meta):
            payloads = await handler(blobs)
        decide_s = time.perf_counter() - t_decide
        tap = self.flight
        if tap is not None:
            # the owner's exemplar of a bulk hop, under the origin's id
            tap.tap(
                decide_s, "pod_forward",
                request_id=str(rid) if rid is not None else None,
                namespace="_bulk",
                phases_ms={
                    "pod_remote_decide": round(decide_s * 1e3, 4),
                },
            )
        return json.dumps({
            "ok": True,
            "decide_ns": int(decide_s * 1e9),
            "payloads": [
                None if p is None else base64.b64encode(p).decode()
                for p in payloads
            ],
        }).encode()

    def _emit(self, kind: str, **detail) -> None:
        """A typed pod event, when a log is attached; called with no
        lane or health lock held (the log takes its own)."""
        events = self.events
        if events is not None:
            events.emit(kind, **detail)

    def _redial(self, host: int) -> None:
        """Drop the cached channel so that the next attempt dials fresh
        (lane loop only): a peer restarted on the same address must not
        keep failing on the stale channel's backoff state."""
        entry = self._channels.pop(host, None)
        if entry is not None:
            self.redials += 1
            self._emit("channel_redial", peer=host)
            asyncio.ensure_future(entry[0].close())

    def _dial(self, host: int):
        """A genuinely fresh channel. gRPC shares subchannels globally by
        target, so without a local subchannel pool a re-dialed channel
        would inherit the dead subchannel's connect backoff and keep
        refusing a peer that already restarted on the same address."""
        import grpc

        channel = grpc.aio.insecure_channel(
            self.peers[host],
            options=(("grpc.use_local_subchannel_pool", 1),),
        )
        call = channel.unary_unary(
            PEER_METHOD,
            request_serializer=bytes,
            response_deserializer=bytes,
        )
        return channel, call

    async def _attempt(
        self, host: int, blob: bytes, timeout: float, fresh: bool = False,
        metadata=None,
    ) -> bytes:
        await self.faults.apply(host, timeout)
        if fresh:
            # Hedge and retry attempts dial their own channel, to escape
            # whatever the cached one is stuck on.
            channel, call = self._dial(host)
            try:
                return await self._call(host, call, blob, timeout, metadata)
            finally:
                asyncio.ensure_future(channel.close())
        entry = self._channels.get(host)
        if entry is None:
            entry = self._channels[host] = self._dial(host)
        _channel, call = entry
        return await self._call(host, call, blob, timeout, metadata)

    @staticmethod
    async def _call(
        host: int, call, blob: bytes, timeout: float, metadata=None
    ) -> bytes:
        try:
            return await call(blob, timeout=timeout, metadata=metadata)
        except asyncio.CancelledError as exc:
            # A health trip re-dialed (closed) this channel under the
            # call, which gRPC surfaces as a cancellation; as a
            # BaseException it would pass every failure handler, so it
            # becomes the connection failure it is.
            raise ConnectionError(
                f"peer {host} channel closed mid-call"
            ) from exc

    def _note_failure(self, host: int, exc: BaseException) -> None:
        """Health accounting and a re-dial on a trip (lane loop only)."""
        tripped = self.health.record_failure(
            host, deadline_miss=_is_deadline_miss(exc)
        )
        if tripped is not None:
            self._emit(
                f"peer_{tripped}", peer=host, error=f"{exc}"[:200]
            )
            self._redial(host)

    def _note_success(self, host: int) -> None:
        if self.health.record_success(host) is not None:
            self._emit("peer_up", peer=host)

    async def _forward_on_loop(
        self, host: int, blob: bytes, kind: str, metadata=None,
        t_submit: Optional[float] = None,
    ):
        """One forward with the lane's resilience inside
        ``cfg.deadline_s``: an optional hedge race, then at most one
        jittered-backoff retry for retryable kinds once the peer is
        suspect. Runs on the lane loop; returns ``(raw, queue_s)``, the
        serving loop to lane loop handoff being the hop's ``queue``
        phase."""
        queue_s = (
            max(time.perf_counter() - t_submit, 0.0)
            if t_submit is not None else 0.0
        )
        cfg = self.cfg
        deadline = self._loop.time() + cfg.deadline_s
        retryable = cfg.retry and kind in RETRYABLE_KINDS

        async def one_attempt(fresh: bool = False) -> bytes:
            remaining = deadline - self._loop.time()
            if remaining <= 0:
                raise TimeoutError(
                    f"forward deadline exhausted for peer {host}"
                )
            return await self._attempt(
                host, blob, remaining, fresh=fresh, metadata=metadata
            )

        try:
            if cfg.hedge_ms > 0 and kind in RETRYABLE_KINDS:
                raw = await self._hedged(host, one_attempt, deadline)
            else:
                raw = await one_attempt()
        except Exception as exc:
            self._note_failure(host, exc)
            remaining = deadline - self._loop.time()
            backoff = (cfg.retry_backoff_ms / 1e3) * (
                0.5 + random.random()
            )
            if not (
                retryable
                and self.health.state(host) != PeerState.UP
                and remaining > backoff
            ):
                raise
            self.retries += 1
            await asyncio.sleep(backoff)
            try:
                raw = await one_attempt(fresh=True)
            except Exception as retry_exc:
                self._note_failure(host, retry_exc)
                raise
        self._note_success(host)
        return raw, queue_s

    async def _hedged(self, host: int, one_attempt, deadline) -> bytes:
        """Race a second attempt on a fresh channel when the first
        outlasts max(hedge floor, tracked peer p99): the stall signature
        of a wedged channel, not of a slow decision."""
        cfg = self.cfg
        first = asyncio.ensure_future(one_attempt())
        hedge_after = max(cfg.hedge_ms, self.peer_p99_ms()) / 1e3
        done, _pending = await asyncio.wait({first}, timeout=hedge_after)
        if first in done:
            return first.result()
        if deadline - self._loop.time() <= 0.001:
            return await first  # no budget left to hedge with
        self._emit("hedge_fired", peer=host)
        second = asyncio.ensure_future(one_attempt(fresh=True))
        pending = {first, second}
        last_exc: Optional[BaseException] = None
        while pending:
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED
            )
            for task in done:
                exc = task.exception()
                if exc is not None:
                    last_exc = exc
                    continue
                for other in pending:
                    other.cancel()
                if task is second:
                    self.hedges_won += 1
                    self._emit("hedge_won", peer=host)
                else:
                    self.hedges_lost += 1
                return task.result()
        assert last_exc is not None
        raise last_exc

    async def _probe(self, host: int) -> None:
        """Ping a non-up peer (lane loop). Success hands off to the
        recovery thread, so that a journal replay never blocks this
        loop."""
        if host in self._probing:
            return  # a slow probe is still in flight for this peer
        self._probing.add(host)
        self.probes += 1
        blob = json.dumps({"kind": "ping", "from": self.host_id}).encode()
        try:
            # A fresh channel every probe: the cached channel's connect
            # backoff grows toward minutes on a long outage, and only a
            # fresh dial notices the instant a peer restarts on the same
            # address.
            await self._attempt(
                host, blob, self.cfg.probe_timeout_s, fresh=True
            )
        except Exception as exc:
            self._note_failure(host, exc)
            return
        finally:
            self._probing.discard(host)
        if host in self._recovering:
            return
        self._recovering.add(host)
        threading.Thread(
            target=self._run_recovery,
            args=(host,),
            name=f"pod-recover-{host}",
            daemon=True,
        ).start()

    def _run_recovery(self, host: int) -> None:
        """Recovery thread: let the frontend replay its journal to the
        recovered owner, then mark the peer up. A failed replay leaves
        the peer non-up, so that the next probe retries."""
        try:
            hook = self.on_peer_recovered
            ok = True if hook is None else bool(hook(host))
            if ok:
                self._note_success(host)
        except Exception as exc:
            log.warning(
                f"pod peer {host} recovery failed (stays degraded): {exc}"
            )
        finally:
            self._recovering.discard(host)

    async def _exchange_signals(self, host: int) -> None:
        """One federated-signal exchange with an up peer (lane loop,
        probe cadence). Failures are counted but not fed into peer
        health: a refused diagnostics exchange must never down a peer
        that serves traffic."""
        if host in self._signal_inflight:
            return  # a slow exchange is still in flight for this peer
        provider = self.signals_provider
        if provider is None:
            return
        self._signal_inflight.add(host)
        try:
            payload = provider()
            blob = json.dumps({
                "kind": "signals",
                "from": self.host_id,
                "signals": payload,
            }).encode()
            raw = await self._attempt(
                host, blob, self.cfg.probe_timeout_s
            )
            self.signal_exchanges += 1
            hook = self.on_peer_signals
            theirs = json.loads(raw.decode()).get("signals") or {}
            if hook is not None and theirs:
                hook(host, theirs)
        except Exception:
            self.signal_exchange_failures += 1
        finally:
            self._signal_inflight.discard(host)

    def replay_deltas(
        self, host: int, deltas: List[dict],
        timeout: float = FORWARD_TIMEOUT_SECONDS,
    ) -> int:
        """Blocking journal replay to a recovered owner (recovery thread
        only, never the serving path). Raises on peer failure, so that
        the caller's journal restore fires."""
        blob = json.dumps({
            "kind": "apply_deltas",
            "deltas": deltas,
            "from": self.host_id,
        }).encode()
        fut = asyncio.run_coroutine_threadsafe(
            self._attempt(host, blob, timeout), self._loop
        )
        raw = fut.result(timeout + 1.0)
        return int(json.loads(raw.decode()).get("applied", 0))

    def admin_call(
        self, host: int, payload: dict, timeout: float = 5.0
    ) -> dict:
        """One blocking control-plane RPC to a peer (the flight engine's
        peer collection; a trigger or recovery thread, never a serving
        loop). Raises on peer failure; the caller owns the retries."""
        blob = json.dumps(payload).encode()
        fut = asyncio.run_coroutine_threadsafe(
            self._attempt(host, blob, timeout), self._loop
        )
        return json.loads(fut.result(timeout + 1.0).decode())

    async def forward(
        self,
        host: int,
        namespace: str,
        ctx: Context,
        delta: int,
        load: bool,
        kind: str = "check_and_update",
    ) -> dict:
        """Forward one decision to its owner host (from any serving
        loop; the channel work runs on the lane loop). Raises on peer
        failure after counting it."""
        resp = await self._hop(host, kind, namespace, lambda: {
            "ns": str(namespace),
            "ctx": _encode_context(ctx),
            "delta": int(delta),
            "load": bool(load),
            "kind": kind,
            "from": self.host_id,
        })
        self.forwards += 1
        return resp

    async def forward_bulk(
        self, host: int, blobs: List[bytes]
    ) -> List[Optional[bytes]]:
        """One bulk forward of foreign raw request blobs to their owner
        host: the whole flush group rides ONE lane RPC with the lane's
        resilience (retry while suspect, hedging, health accounting).
        Returns one response payload a blob; a None row is one the owner
        could not decide, and the caller decides it through its exact
        path. Raises on peer failure after counting it. The hop's
        breakdown is recorded as a single forward's, under the ``_bulk``
        namespace."""
        resp = await self._hop(host, "bulk_decide", "_bulk", lambda: {
            "kind": "bulk_decide",
            "from": self.host_id,
            "blobs": [base64.b64encode(b).decode() for b in blobs],
        })
        self.bulk_forwards += 1
        self.bulk_forward_rows += len(blobs)
        if resp.get(STALE_EPOCH):
            # the batch was routed by a dead topology: every row takes
            # its per-request path, which re-plans under the adopted one
            return [None] * len(blobs)
        return [
            None if p is None else base64.b64decode(p)
            for p in resp.get("payloads", ())
        ]

    async def _hop(self, host: int, kind: str, namespace, build) -> dict:
        """One hop to ``host`` of the request ``build()`` makes, with the
        origin's request id and (with an exporter) its W3C trace context
        as gRPC metadata and the lane's resilience; records the latency
        and the hop's breakdown (``on_hop``) and returns the owner's
        answer. Raises on peer failure, or with the lane's loop not
        running, after counting it."""
        loop = self._loop
        if host not in self.peers or loop is None or not loop.is_running():
            self.errors += 1
            if host not in self.peers:
                raise RuntimeError(f"no peer lane for pod host {host}")
            raise RuntimeError("pod peer lane is not running")
        request_id = _wire_request_id(current_request_id())
        t0 = time.perf_counter()
        wire = build()
        provider = self.epoch_provider
        if provider is not None:
            # resize armed: the topology epoch the routing verdict was
            # computed under (one int a payload)
            wire["tepoch"] = int(provider())
        blob = json.dumps(wire).encode()
        serialize_s = time.perf_counter() - t0
        metadata = None
        pairs = hop_trace_metadata()
        if request_id is not None:
            pairs.append(("x-request-id", request_id))
        if pairs:
            metadata = tuple(pairs)
        fut = asyncio.run_coroutine_threadsafe(
            self._forward_on_loop(
                host, blob, kind, metadata=metadata,
                t_submit=time.perf_counter(),
            ),
            loop,
        )
        try:
            raw, queue_s = await asyncio.wrap_future(fut)
        except Exception:
            self.errors += 1
            raise
        total_s = time.perf_counter() - t0
        with self._latency_lock:
            self._latencies_ms.append(total_s * 1e3)
        resp = json.loads(raw.decode())
        if resp.get(STALE_EPOCH):
            # adopt the rejection's (possibly newer) topology before the
            # caller re-plans, so that the re-plan routes by it
            hook = self.on_stale
            if hook is not None:
                try:
                    hook(resp)
                except Exception:
                    pass
            return resp
        hook = self.on_hop
        if hook is not None:
            # The owner reports its decide time; wire is the remainder
            # (channel, network, retries, hedges, response parse).
            remote_s = max(float(resp.get("decide_ns", 0)) / 1e9, 0.0)
            hook(host, request_id, namespace, total_s, {
                "queue": queue_s,
                "serialize": serialize_s,
                "wire": max(
                    total_s - queue_s - serialize_s - remote_s, 0.0
                ),
                "remote_decide": remote_s,
            })
        return resp

    # -- telemetry -----------------------------------------------------------

    def peer_p99_ms(self) -> float:
        with self._latency_lock:
            lat = sorted(self._latencies_ms)
        if not lat:
            return 0.0
        return lat[min(int(0.99 * len(lat)), len(lat) - 1)]

    def stats(self) -> dict:
        return {
            "pod_peer_forwards": self.forwards,
            "pod_peer_served": self.served,
            "pod_peer_errors": self.errors,
            "pod_bulk_forward_batches": self.bulk_forwards,
            "pod_bulk_forward_rows": self.bulk_forward_rows,
            "pod_bulk_served_rows": self.bulk_served_rows,
            "pod_peer_p99_ms": round(self.peer_p99_ms(), 3),
            # the owner's wrong-epoch rejections (a pod_resize_* family,
            # counted at the lane's gate)
            "pod_resize_stale_rejects": self.stale_rejects,
            "peer_health_state": self.health.states(),
            "peer_health_retries": self.retries,
            "peer_health_hedges_won": self.hedges_won,
            "peer_health_hedges_lost": self.hedges_lost,
            "peer_health_redials": self.redials,
            "peer_health_probes": self.probes,
            # client-side exchange outcomes (the aggregator counts the
            # columns ingested, pod_signal_exchanges)
            "pod_signal_sent": self.signal_exchanges,
            "pod_signal_send_failures": self.signal_exchange_failures,
        }


class _OwnerGuard:
    """Per-owner failover state: the admission plane's breaker gating a
    local exact stand-in (FailoverStore) whose journal replays to the
    owner on recovery. The breaker's stall watch is disarmed: peer
    failures arrive as recorded exceptions, not stalled batches."""

    def __init__(self, owner: int, cfg: PodResilience):
        self.owner = owner
        self.breaker = CircuitBreaker(
            failure_threshold=cfg.breaker_failures,
            stall_timeout=1e9,
            reset_timeout=cfg.breaker_reset_s,
            warmup_stall_timeout=1e9,
        )
        self.store = FailoverStore(cache_size=cfg.journal_cache)
        self.degraded_decisions = 0
        self.reconciles = 0
        self.replayed_deltas = 0
        self.reconcile_seconds = 0.0
        # wall clock of the current degraded window's first stand-in
        # decision (None = not degraded), bracketed on the timeline by
        # degraded_enter/exit; guarded, since degraded decisions race in
        # from every serving loop while the recovery thread clears it
        self.degraded_since: Optional[float] = None
        self._degraded_lock = threading.Lock()


class _PeerDeltaSink:
    """``apply_deltas`` over the peer lane, so that FailoverStore's
    ``reconcile_into`` (journal restore on failure, oracle clear on
    success) replays to a remote owner as the admission plane replays to
    the local table. Chunked, since a long partition can journal more
    counters than one gRPC message carries; ``apply_deltas_acked`` lets
    the reconcile restore only the unacknowledged tail after a failure
    mid-replay."""

    CHUNK = 1000

    def __init__(self, lane: PeerLane, owner: int):
        self._lane = lane
        self._owner = owner

    def apply_deltas_acked(self, items, ack) -> None:
        deltas = [
            _counter_to_wire(counter, delta) for counter, delta in items
        ]
        for start in range(0, len(deltas), self.CHUNK):
            chunk = deltas[start:start + self.CHUNK]
            self._lane.replay_deltas(self._owner, chunk)
            ack(start + len(chunk))

    def apply_deltas(self, items) -> None:
        self.apply_deltas_acked(items, lambda _n: None)


class PodFrontend:
    """Shard-aware routed frontend over a limiter: decide locally when
    this host owns every counter the request touches, else one peer-lane
    hop to the owner. Used by the RLS and HTTP planes exactly as the
    limiter it wraps (attribute delegation).

    With ``resilience.degraded`` on, a failed forward is not the
    request's failure: the owner's traffic fails over to a per-owner
    exact stand-in behind a circuit breaker, every admitted delta is
    journaled, and the lane's probe replays the journal to the owner
    once it answers again."""

    #: the RLS service and the HTTP API await the decision calls when
    #: this is set, although the frontend is no AsyncRateLimiter
    is_async_limiter = True

    def __init__(
        self,
        limiter,
        router: PodRouter,
        lane: PeerLane,
        global_namespaces=(),
        resilience: Optional[PodResilience] = None,
        events_capacity: int = 512,
    ):
        self._limiter = limiter
        self.router = router
        self.lane = lane
        self._global_ns = {str(ns) for ns in global_namespaces}
        self._inner_async = isinstance(limiter, AsyncRateLimiter)
        self._resilience = resilience or lane.cfg
        self._guards: Dict[int, _OwnerGuard] = {}
        #: the lockstep psum lane (parallel/pod.py PodPsumLane): global
        #: namespaces it serves decide locally through it instead of on
        #: their pin host
        self.psum_lane = None
        #: the native pipeline of the pod fast path (``attach_pipeline``)
        self.pipeline = None
        #: PodResizeCoordinator (``server/resize.py``); None: no epoch on
        #: the wire, no gate
        self.resize = None
        #: WarmStandby (``server/standby.py``); None: not a standby, the
        #: join kinds unarmed
        self.standby = None
        #: forwards answered stale_epoch and re-planned in band
        self.stale_replans = 0
        #: the last applied limits generation: the resize coordinator
        #: finds the counters to migrate from it
        self._last_limits: List = []
        # The pod's typed event timeline, the per-hop recorder and the
        # federated signal aggregator: always on (bounded rings, off the
        # decision path); the lane emits through the hooks below.
        self.events = PodEventLog(
            host_id=lane.host_id, capacity=events_capacity
        )
        #: flight.FlightRecorder: taps the pod_forward and degraded lanes
        #: once attach_flight_recorder arms it
        self.flight = None
        self.hops = PodHopRecorder(host_id=lane.host_id)
        self.aggregator = PodSignalAggregator(host_id=lane.host_id)
        self.aggregator.local_fields = self.pod_signal_fields
        lane.events = self.events
        lane.on_hop = self._record_hop
        lane.signals_provider = self.aggregator.local_payload
        lane.on_peer_signals = self.aggregator.ingest
        if self._resilience.degraded:
            self._guards = {
                owner: _OwnerGuard(owner, self._resilience)
                for owner in lane.peers
            }
            lane.on_peer_recovered = self._peer_recovered
            lane.probe_needed = self._needs_recovery
            for owner, guard in self._guards.items():
                guard.breaker.listeners.append(
                    self._breaker_listener(owner)
                )
        lane.decide_cb = self._decide_for_peer
        # The owner side of a journal replay is unconditional: a
        # recovered host accepts its peers' journals even when its own
        # degraded mode is off.
        lane.apply_cb = self._apply_from_peer

    def __getattr__(self, name):
        return getattr(self._limiter, name)

    @property
    def wrapped(self):
        """The limiter this frontend routes for."""
        return self._limiter

    # -- configuration -------------------------------------------------------

    async def configure_with(self, limits) -> None:
        limits = list(limits)
        # The psum lane claims the global namespaces it can serve first:
        # the router must not pin what every host decides locally.
        pinned_global = self._global_ns
        if self.psum_lane is not None:
            served = self.psum_lane.configure(limits, self._global_ns)
            pinned_global = self._global_ns - served
        self._last_limits = limits
        self.router.configure(limits, pinned_global)
        self.events.emit(
            "routing_epoch", epoch=self.router.epoch, limits=len(limits)
        )
        res = self._limiter.configure_with(limits)
        if inspect.isawaitable(res):
            await res

    def attach_psum_lane(self, lane) -> None:
        """Attach the lockstep psum lane: the global-namespace limits it
        can serve stop pinning to one host, and every host decides them
        locally against the pod-wide sum."""
        self.psum_lane = lane

    # -- the native pod fast path --------------------------------------------

    def attach_pipeline(self, pipeline) -> None:
        """Wire the native pipeline into the pod: its C hot lane learns
        the topology and stamps each plan's owner (``attach_pod``), and
        this lane's ``bulk_decide`` decides peers' forwarded blob batches
        on the local table. Raises RuntimeError where the pipeline cannot
        split (no hot lane, a pod past the int8 owner encoding)."""
        pipeline.attach_pod(self)
        self.pipeline = pipeline
        self.lane.bulk_cb = self._decide_blobs_for_peer

    async def _decide_blobs_for_peer(self, blobs):
        """The owner's side of a bulk hop: the pipeline's bulk pass, with
        a just-promoted joiner's first answer stamped as for a unary
        forward (``_joined``)."""
        rz = self.resize
        if rz is not None and rz._join_adopted_at is not None:
            return await self._joined(
                "_bulk", self.pipeline.decide_blobs_for_peer(blobs))
        return await self.pipeline.decide_blobs_for_peer(blobs)

    def attach_psum_transport(self, transport) -> None:
        """Wire a ``parallel.pod.PeerPsumTransport`` into this lane: the
        peers' published partials arrive through the ``psum_share`` kind,
        and this host's ride ``psum_share_sender`` from the psum pacer."""
        self.lane.psum_share_cb = transport.receive

    # -- the fast join: shipped plan caches ----------------------------------

    def _limits_fingerprint(self) -> str:
        """A digest of the applied limits generation: a plan seed carries
        it, so that a seed derived under one limits file never lands on a
        joiner that applied another."""
        from ..device.plan_cache import _limit_identity_to_wire

        idents = sorted(
            json.dumps(_limit_identity_to_wire(lim), sort_keys=True)
            for lim in self._last_limits
        )
        return hashlib.sha256(
            "\n".join(idents).encode()
        ).hexdigest()[:16]

    def plan_seed_export(self, max_entries: int = 4096) -> dict:
        """This host's decision-plan cache as one seed payload (sent to a
        joiner over the ``plan_seed`` kind). Kernel plans carry counter
        identities, not slots: the importer resolves its own."""
        cache = (
            getattr(self.pipeline, "plan_cache", None)
            if self.pipeline is not None else None
        )
        if cache is None:
            return {"entries": [], "limits_fp": self._limits_fingerprint()}
        table = self.pipeline.storage._table

        def counter_of_slot(slot):
            entry = table.info.get(slot)
            return entry[1] if entry is not None else None

        return {
            "entries": cache.export_seed(
                counter_of_slot, max_entries=max_entries
            ),
            "limits_fp": self._limits_fingerprint(),
        }

    def plan_seed_import(self, payload: dict) -> dict:
        """The joiner's side of a shipped seed: each entry rebuilt
        against this host's slot table through the cache's put(), so that
        a limits reload racing the ship discards it. A seed of another
        limits generation (fingerprint) is discarded whole. A slot the
        import allocates has its cell cleared before the table's next
        access (B3b's host form), as any fresh slot."""
        cache = (
            getattr(self.pipeline, "plan_cache", None)
            if self.pipeline is not None else None
        )
        if cache is None:
            return {"ok": False, "error": "no plan cache attached"}
        fp = payload.get("limits_fp")
        if fp is not None and fp != self._limits_fingerprint():
            self.events.emit("plan_seeded", seeded=0, stale=True)
            return {"ok": True, "seeded": 0, "stale_limits": True}
        storage = self.pipeline.storage

        def slot_of_counter(counter):
            with storage._lock:
                slot, fresh = storage._slot_for(counter, create=True)
                if fresh and slot is not None:
                    storage._stage_clear(slot)
            return slot

        entries = payload.get("entries") or ()
        seeded = cache.import_seed(
            entries, slot_of_counter, epoch=cache.epoch
        )
        self.events.emit(
            "plan_seeded", entries=len(entries), seeded=seeded
        )
        return {"ok": True, "seeded": seeded}

    # -- the elastic pod -----------------------------------------------------

    def attach_resize(self, coordinator) -> None:
        """Arm the elastic-membership plane: forwards carry the topology
        epoch, the owner's gate rejects a wrong-epoch forward
        rerouteable, and the lane's ``migrate``/``resize_admin`` kinds go
        to the coordinator. Without this call nothing of the wire
        changes."""
        self.resize = coordinator
        self.lane.epoch_provider = (
            lambda: self.router.topology_epoch
        )
        self.lane.stale_info_provider = coordinator.stale_info
        self.lane.migrate_cb = coordinator.handle_migrate
        self.lane.resize_cb = coordinator.handle_admin
        self.lane.on_stale = coordinator.adopt_remote

    def ensure_guards(self) -> None:
        """Degraded-owner guards for peers that joined after construction
        (a membership change): every owner keeps the failover net."""
        if not self._resilience.degraded:
            return
        for owner in self.lane.peers:
            if owner not in self._guards:
                guard = _OwnerGuard(owner, self._resilience)
                guard.breaker.listeners.append(
                    self._breaker_listener(owner)
                )
                self._guards[owner] = guard

    async def _stale_replan(self, namespace, ctx, delta, load, kind):
        """A forward was rejected stale_epoch: the topology moved under
        the request. Re-plan under the current (maybe just adopted)
        topology, at most three times with short waits (the commit
        broadcast lands within milliseconds); the degraded stand-in is the
        last resort, so that a membership change never fails a request
        the failover can answer."""
        self.stale_replans += 1
        owner = None
        counters: List[Counter] = []
        for attempt in range(3):
            verdict, owner, counters = self._route(namespace, ctx)
            if verdict == LOCAL:
                if kind == "is_rate_limited":
                    return await self._local_is_limited(
                        namespace, ctx, delta, counters
                    )
                if kind == "update_counters":
                    await self._local_update(
                        namespace, ctx, delta, counters
                    )
                    return None
                return await self._local_check(
                    namespace, ctx, delta, load, counters
                )
            guard = self._guards.get(owner)
            if guard is not None and guard.breaker.is_open():
                return self._degraded_decide(
                    guard, counters, delta, load, kind
                )
            try:
                resp = await self.lane.forward(
                    owner, namespace, ctx, delta, load, kind=kind
                )
            except Exception as exc:
                err = StorageError(
                    f"pod peer host {owner} unavailable: {exc}"
                )
                if guard is not None:
                    guard.breaker.record_failure(err)
                    return self._degraded_decide(
                        guard, counters, delta, load, kind
                    )
                raise err from exc
            if isinstance(resp, dict) and resp.get(STALE_EPOCH):
                # either side may still be mid-commit
                await asyncio.sleep(0.02 * (attempt + 1))
                continue
            if guard is not None:
                guard.breaker.record_success()
            if kind == "update_counters":
                return None
            return self._adopt(resp)
        guard = self._guards.get(owner)
        if guard is not None:
            return self._degraded_decide(guard, counters, delta, load, kind)
        raise StorageError(
            f"pod topology epoch disagreement with host {owner} "
            "(resize in flight, no degraded fallback)"
        )

    def resize_debug(self) -> dict:
        """``GET /debug/pod/resize`` and the ``pod_resize`` section of
        ``/debug/stats``: the transition state machine."""
        if self.resize is None:
            return {"armed": False}
        out = self.resize.status()
        out["armed"] = True
        return out

    def pod_resize_admin(self, hosts: int, peers=None) -> dict:
        """The admin surface behind ``POST /debug/pod/resize`` (blocking;
        the HTTP handler runs it in an executor)."""
        if self.resize is None:
            raise StorageError("pod resize not armed (--pod-resize off)")
        return self.resize.resize(int(hosts), peers=peers)

    def standby_debug(self) -> dict:
        """``GET /debug/pod/standby`` and the ``standby`` section of
        ``/debug/stats``: the warm-up and join readiness."""
        if self.standby is None:
            return {"armed": False}
        out = self.standby.status()
        out["armed"] = True
        return out

    def pod_join_admin(
        self, address: str, replace=None, seed_plans: bool = True
    ) -> dict:
        """The admin surface behind ``POST /debug/pod/join``: promote the
        warm standby at ``address`` into the pod (blocking; the HTTP
        handler runs it in an executor)."""
        if self.resize is None:
            raise StorageError("pod resize not armed (--pod-resize off)")
        return self.resize.join_host(
            address, replace=replace, seed_plans=seed_plans
        )

    async def forward_bulk(
        self, owner: int, blobs: List[bytes]
    ) -> List[Optional[bytes]]:
        """One bulk forward with the degraded-owner machinery applied to
        the whole batch: an open breaker refuses the hop before it is
        sent (the pipeline then decides each row through this frontend's
        exact path, the stand-in included), and a failed hop feeds the
        same breaker single forwards feed."""
        guard = self._guards.get(owner)
        if guard is not None and guard.breaker.is_open():
            raise StorageError(
                f"pod peer host {owner} degraded (breaker open)"
            )
        try:
            payloads = await self.lane.forward_bulk(owner, blobs)
        except Exception as exc:
            if guard is not None:
                guard.breaker.record_failure(exc)
            raise
        if guard is not None:
            guard.breaker.record_success()
        return payloads

    def forward_bulk_submit(self, owner: int, blobs: List[bytes]):
        """Submit a bulk hop without blocking: the concurrent future of
        ``forward_bulk`` on the lane's loop, or None when that loop is
        down. A caller with several owners submits every hop before it
        collects any, so that it waits for the slowest, not their sum."""
        loop = self.lane._loop
        if loop is None or not loop.is_running():
            return None
        return asyncio.run_coroutine_threadsafe(
            self.forward_bulk(owner, blobs), loop
        )

    def forward_bulk_collect(self, fut, n: int) -> List[Optional[bytes]]:
        """Resolve a ``forward_bulk_submit`` handle; a failure answers
        all-None, so that every row takes its per-request path instead
        of failing the chunk."""
        if fut is None:
            return [None] * n
        try:
            payloads = fut.result(self.lane.cfg.deadline_s + 1.0)
        except Exception:
            return [None] * n
        if len(payloads) != n:
            return [None] * n
        return payloads

    def routing_debug(self) -> dict:
        """``GET /debug/pod/routing``: the ownership map an upstream
        load balancer can learn, the peers, and what the pod serves
        with (``native_hot_lane``: the native pod fast path is on)."""
        out = self.router.ownership_map()
        out["peers"] = {
            str(h): addr for h, addr in self.lane.peers.items()
        }
        out["native_hot_lane"] = self.pipeline is not None
        out["psum_lane_namespaces"] = (
            sorted(self.psum_lane.namespaces)
            if self.psum_lane is not None else []
        )
        return out

    # -- observability -------------------------------------------------------

    def _breaker_listener(self, owner: int):
        """Per-owner breaker transition -> typed timeline event (the
        breaker calls listeners outside its lock)."""
        kinds = {
            BreakerState.OPEN: "breaker_open",
            BreakerState.HALF_OPEN: "breaker_half_open",
            BreakerState.CLOSED: "breaker_closed",
        }

        def on_transition(state: str) -> None:
            kind = kinds.get(state)
            if kind is not None:
                self.events.emit(kind, owner=owner)

        return on_transition

    def _record_hop(
        self, host, request_id, namespace, total_s, phases_s
    ) -> None:
        self.hops.record(request_id, host, namespace, total_s, phases_s)

    def attach_flight(self, recorder) -> None:
        """Wire the device-plane flight recorder into both hop
        directions: the origin's per-hop breakdown entries and the
        owner's forwarded-decide entries."""
        self.hops.attach_flight(recorder)
        self.lane.recorder = recorder

    def attach_flight_recorder(self, flight) -> None:
        """Arm the process flight recorder on the pod lanes: origin-side
        forwards and owner-side decides (``pod_forward``), the degraded
        stand-in (``degraded``), and the topology epoch stamped into
        every exemplar."""
        self.flight = flight
        self.lane.flight = flight
        self.hops.tap = flight
        flight.epoch_provider = lambda: self.router.topology_epoch

    def attach_signal_bus(self, bus) -> None:
        """Join the local ControlSignals bus into the federated view,
        and the pod fields into the bus."""
        self.aggregator.local_signals = bus.snapshot
        attach = getattr(bus, "attach_pod", None)
        if callable(attach):
            attach(self)

    def pod_signal_fields(self) -> dict:
        """The ControlSignals pod tail: this host's routed share, peer
        health counts and degraded share (reads of existing counters,
        safe from any thread)."""
        routed = self.router.stats()
        total = (
            routed["pod_routed_local"]
            + routed["pod_routed_forwarded"]
            + routed["pod_routed_pinned"]
        )
        states = self.lane.health.states()
        degraded = sum(
            guard.degraded_decisions for guard in self._guards.values()
        )
        gauge_counts = {0: 0, 1: 0, 2: 0}
        for state in states.values():
            gauge_counts[state] = gauge_counts.get(state, 0) + 1
        return {
            "pod_routed_share": round(
                routed["pod_routed_local"] / total, 6
            ) if total else 0.0,
            "peers_up": gauge_counts[0],
            "peers_suspect": gauge_counts[1],
            "peers_down": gauge_counts[2],
            "pod_degraded_share": round(
                degraded / total, 6
            ) if total else 0.0,
            # the federated view: a stuck resize shows pod-wide
            "pod_resize_active": (
                1 if self.resize is not None and self.resize.active
                else 0
            ),
            "tepoch": self.router.topology_epoch,
        }

    def pod_debug(self) -> dict:
        """``GET /debug/pod``: per-host signal columns and rollups, plus
        this host's hop breakdown."""
        out = self.aggregator.pod_debug()
        out["hops"] = self.hops.hop_debug()
        return out

    def events_debug(self, n=None, kind=None) -> dict:
        """``GET /debug/events``: the typed pod event timeline."""
        return self.events.events_debug(n=n, kind=kind)

    # -- routing helpers -----------------------------------------------------

    def _route(self, namespace, ctx) -> Tuple[str, int, List[Counter]]:
        # Matching runs once a decision: the counters resolved here feed
        # the wrapped limiter's ``counters=`` entry point on the local
        # path, the degraded stand-in and the psum lane.
        counters = _counters_that_apply(
            self._limiter.storage, Namespace.of(namespace), ctx
        )
        keys = [counter_key(c) for c in counters]
        verdict, owner = self.router.plan(str(namespace), keys)
        return verdict, owner, counters

    def _plan(self, namespace, ctx) -> Tuple[str, int]:
        verdict, owner, _counters = self._route(namespace, ctx)
        return verdict, owner

    async def _local_check(
        self, namespace, ctx, delta, load, counters=None
    ) -> CheckResult:
        if self._inner_async:
            return await self._limiter.check_rate_limited_and_update(
                namespace, ctx, delta, load, counters=counters
            )
        return self._limiter.check_rate_limited_and_update(
            namespace, ctx, delta, load, counters=counters
        )

    async def _local_is_limited(
        self, namespace, ctx, delta, counters=None
    ) -> CheckResult:
        if self._inner_async:
            return await self._limiter.is_rate_limited(
                namespace, ctx, delta, counters=counters
            )
        return self._limiter.is_rate_limited(
            namespace, ctx, delta, counters=counters
        )

    async def _local_update(
        self, namespace, ctx, delta, counters=None
    ) -> None:
        if self._inner_async:
            await self._limiter.update_counters(
                namespace, ctx, delta, counters=counters
            )
        else:
            self._limiter.update_counters(
                namespace, ctx, delta, counters=counters
            )

    async def _decide_for_peer(
        self, namespace, ctx, delta, load, kind
    ) -> Optional[CheckResult]:
        """Owner-side handler of a forwarded decision: this host owns
        it, so it runs the local path directly (a forward is always
        terminal, one hop by construction)."""
        rz = self.resize
        if rz is not None and rz._join_adopted_at is not None:
            return await self._joined(namespace, self._decide_for_peer_inner(
                namespace, ctx, delta, load, kind))
        return await self._decide_for_peer_inner(
            namespace, ctx, delta, load, kind)

    async def _joined(self, namespace, decision):
        """Await a just-promoted joiner's first answered decision: stamp
        its time to first decision (``join_ttfd_seconds``) and leave an
        exemplar in the flight recorder's ``join`` lane. One attribute
        read a forward once stamped."""
        t0 = time.perf_counter()
        try:
            return await decision
        finally:
            self.resize.note_first_decision()
            if self.flight is not None:
                self.flight.tap(
                    time.perf_counter() - t0, "join",
                    request_id=current_request_id(),
                    namespace=namespace,
                )

    async def _decide_for_peer_inner(
        self, namespace, ctx, delta, load, kind
    ) -> Optional[CheckResult]:
        counters = _counters_that_apply(
            self._limiter.storage, Namespace.of(namespace), ctx
        )
        if kind == "is_rate_limited":
            return await self._local_is_limited(
                namespace, ctx, delta, counters
            )
        if kind == "update_counters":
            await self._local_update(namespace, ctx, delta, counters)
            return None
        return await self._local_check(namespace, ctx, delta, load, counters)

    def _apply_from_peer(self, deltas: List[dict]) -> int:
        """Owner-side journal replay: a peer that failed over while this
        host was down hands over the deltas it admitted on its behalf;
        they land through the storage's ``apply_deltas`` (B2's host form
        on a torch table, B7c's on the sharded one). Behind the batcher
        of a served device storage that is its table's (``inner``), as
        for the shared authority: the JAX frontend stops at the batched
        storage, which has no ``apply_deltas``, so a replay into a served
        device owner fails there (ROADMAP Queue C)."""
        items = [_counter_from_wire(blob) for blob in deltas]
        if not items:
            return 0
        storage = self._limiter.storage
        storage = getattr(storage, "counters", storage)
        storage = getattr(storage, "inner", storage)
        storage.apply_deltas(items)
        return len(items)

    @staticmethod
    def _adopt(resp: dict) -> CheckResult:
        """A forwarded decision's CheckResult, the owner's loaded
        counters rebuilt as header stand-ins."""
        counters = []
        for c in resp.get("counters", ()):
            counters.append(_ForwardedCounter(
                c.get("max"), c.get("remaining"), c.get("expires_in"),
                c.get("window"), c.get("name"),
            ))
        return CheckResult(
            bool(resp.get("limited", False)), counters, resp.get("name")
        )

    # -- degraded-owner failover ---------------------------------------------

    def _degraded_decide(
        self, guard: _OwnerGuard, counters: List[Counter],
        delta: int, load: bool, kind: str,
    ) -> Optional[CheckResult]:
        """Decide on the owner's local stand-in (exact oracle + delta
        journal), in RateLimiter's CheckResult shape, so that a serving
        plane cannot tell a degraded answer apart."""
        tap = self.flight
        if tap is None:
            return self._degraded_decide_inner(
                guard, counters, delta, load, kind
            )
        t0 = time.perf_counter()
        try:
            return self._degraded_decide_inner(
                guard, counters, delta, load, kind
            )
        finally:
            namespace = None
            if counters:
                limit = getattr(counters[0], "limit", None)
                namespace = getattr(limit, "namespace", None)
            tap.tap(
                time.perf_counter() - t0, "degraded",
                request_id=current_request_id(),
                namespace=namespace,
                phases_ms=None,
            )

    def _degraded_decide_inner(
        self, guard: _OwnerGuard, counters: List[Counter],
        delta: int, load: bool, kind: str,
    ) -> Optional[CheckResult]:
        entered = False
        with guard._degraded_lock:
            if guard.degraded_since is None:
                guard.degraded_since = time.time()
                entered = True
        if entered:  # emitted outside the lock
            self.events.emit("degraded_enter", owner=guard.owner)
        guard.degraded_decisions += 1
        if kind == "is_rate_limited":
            for counter in counters:
                if not guard.store.is_within_limits(counter, delta):
                    return CheckResult(True, [], counter.limit.name)
            return CheckResult(False, [], None)
        if kind == "update_counters":
            for counter in counters:
                guard.store.update_counter(counter, delta)
            return None
        if not counters:
            return CheckResult(False, [], None)
        auth = guard.store.check_and_update(counters, delta, load)
        loaded = counters if load else []
        if auth.limited:
            return CheckResult(True, loaded, auth.limit_name)
        return CheckResult(False, loaded, None)

    def _needs_recovery(self, owner: int) -> bool:
        """Probe gate beyond peer health: a failure below the threshold
        journals a delta while the peer stays up, and a breaker can open
        without downing the peer; probes keep firing until the journal
        drains and the breaker closes."""
        guard = self._guards.get(owner)
        if guard is None:
            return False
        return (
            guard.breaker.state != BreakerState.CLOSED
            or guard.store.journal_size() > 0
        )

    def _peer_recovered(self, owner: int) -> bool:
        """Recovery-thread hook: replay the owner's journal through the
        lane into its ``apply_deltas``, drain the stand-in, close the
        breaker. Degraded decisions racing the replay land in a fresh
        journal, which the drains after it empty."""
        guard = self._guards.get(owner)
        if guard is None:
            return True
        sink = _PeerDeltaSink(self.lane, owner)
        t0 = time.perf_counter()
        self.events.emit(
            "journal_replay_begin", owner=owner,
            journal=guard.store.journal_size(),
        )
        try:
            replayed = guard.store.reconcile_into(sink)
            # Decisions that went degraded between the drain and the
            # breaker closing journal afresh: bounded re-drains chase
            # the tail down to empty.
            for _ in range(4):
                if guard.store.journal_size() == 0:
                    break
                replayed += guard.store.reconcile_into(sink)
        except Exception as exc:
            guard.reconcile_seconds += time.perf_counter() - t0
            self.events.emit(
                "journal_replay_end", owner=owner, ok=False,
                replayed=0, error=f"{exc}"[:200],
            )
            log.warning(
                f"pod host {owner}: journal replay failed, staying "
                f"degraded: {exc}"
            )
            return False
        guard.breaker.probe_succeeded()
        if guard.store.journal_size():
            try:
                replayed += guard.store.reconcile_into(sink)
            except Exception:
                pass  # the residue replays on the next recovery
        guard.reconcile_seconds += time.perf_counter() - t0
        guard.reconciles += 1
        guard.replayed_deltas += replayed
        self.events.emit(
            "journal_replay_end", owner=owner, ok=True, replayed=replayed
        )
        with guard._degraded_lock:
            since, guard.degraded_since = guard.degraded_since, None
        if since is not None:
            self.events.emit(
                "degraded_exit", owner=owner,
                degraded_s=round(time.time() - since, 6),
                decisions=guard.degraded_decisions,
            )
        log.info(
            f"pod host {owner} recovered: replayed {replayed} journaled "
            "deltas, routing restored"
        )
        return True

    async def _remote(
        self, owner, namespace, ctx, counters, delta, load, kind
    ) -> Optional[CheckResult]:
        """One peer hop, its failures mapped to StorageError (the RLS
        service answers UNAVAILABLE, the HTTP API 500). With degraded
        mode on, the failure instead feeds the owner's breaker and the
        decision fails over to the local stand-in: the request never
        sees the dead peer."""
        guard = self._guards.get(owner)
        if guard is not None and guard.breaker.is_open():
            return self._degraded_decide(guard, counters, delta, load, kind)
        try:
            resp = await self.lane.forward(
                owner, namespace, ctx, delta, load, kind=kind
            )
        except Exception as exc:
            err = StorageError(f"pod peer host {owner} unavailable: {exc}")
            if guard is not None:
                guard.breaker.record_failure(err)
                return self._degraded_decide(
                    guard, counters, delta, load, kind
                )
            raise err from exc
        if isinstance(resp, dict) and resp.get(STALE_EPOCH):
            # rejected by an owner on another epoch: the lane ran the
            # adoption hook; re-plan under the current topology
            return await self._stale_replan(
                namespace, ctx, delta, load, kind
            )
        if guard is not None:
            # A successful forward resets the consecutive-failure count,
            # so that transient failures hours apart never add up to a
            # trip.
            guard.breaker.record_success()
        if kind == "update_counters":
            return None
        return self._adopt(resp)

    # -- the limiter surface -------------------------------------------------

    def _psum_serves(self, namespace) -> bool:
        lane = self.psum_lane
        return lane is not None and str(namespace) in lane.namespaces

    async def check_rate_limited_and_update(
        self, namespace, ctx, delta: int, load_counters: bool = False
    ) -> CheckResult:
        if self._psum_serves(namespace):
            counters = _counters_that_apply(
                self._limiter.storage, Namespace.of(namespace), ctx
            )
            return self.psum_lane.check_and_update(
                counters, delta, load_counters
            )
        verdict, owner, counters = self._route(namespace, ctx)
        if verdict == LOCAL:
            return await self._local_check(
                namespace, ctx, delta, load_counters, counters
            )
        return await self._remote(
            owner, namespace, ctx, counters, delta, load_counters,
            "check_and_update",
        )

    async def is_rate_limited(self, namespace, ctx, delta: int) -> CheckResult:
        if self._psum_serves(namespace):
            counters = _counters_that_apply(
                self._limiter.storage, Namespace.of(namespace), ctx
            )
            return self.psum_lane.is_rate_limited(counters, delta)
        verdict, owner, counters = self._route(namespace, ctx)
        if verdict == LOCAL:
            return await self._local_is_limited(
                namespace, ctx, delta, counters
            )
        return await self._remote(
            owner, namespace, ctx, counters, delta, False,
            "is_rate_limited",
        )

    async def update_counters(self, namespace, ctx, delta: int) -> None:
        if self._psum_serves(namespace):
            counters = _counters_that_apply(
                self._limiter.storage, Namespace.of(namespace), ctx
            )
            self.psum_lane.update_counters(counters, delta)
            return
        verdict, owner, counters = self._route(namespace, ctx)
        if verdict == LOCAL:
            await self._local_update(namespace, ctx, delta, counters)
            return
        await self._remote(
            owner, namespace, ctx, counters, delta, False,
            "update_counters",
        )

    # -- telemetry -----------------------------------------------------------

    def resilience_stats(self) -> dict:
        degraded = journal = reconciles = replayed = open_count = 0
        reconcile_s = failover_s = 0.0
        for guard in self._guards.values():
            degraded += guard.degraded_decisions
            journal += guard.store.journal_size()
            reconciles += guard.reconciles
            replayed += guard.replayed_deltas
            reconcile_s += guard.reconcile_seconds
            failover_s += guard.breaker.open_seconds_total()
            if guard.breaker.state != BreakerState.CLOSED:
                open_count += 1
        return {
            "pod_failover_degraded_decisions": degraded,
            "pod_failover_journal_depth": journal,
            "pod_failover_breaker_open": open_count,
            "pod_failover_reconciles": reconciles,
            "pod_failover_replayed_deltas": replayed,
            "pod_failover_reconcile_seconds": round(reconcile_s, 6),
            "pod_failover_seconds": round(failover_s, 6),
        }

    def library_stats(self) -> dict:
        inner = getattr(self._limiter, "library_stats", None)
        stats = dict(inner()) if callable(inner) else {}
        stats.update(self.router.stats())
        stats.update(self.lane.stats())
        stats.update(self.resilience_stats())
        stats["pod_events"] = self.events.counts()
        stats["pod_event_seq"] = self.events.last_seq
        stats.update(self.aggregator.stats())
        if self.psum_lane is not None:
            stats.update(self.psum_lane.stats())
        if self.resize is not None:
            stats.update(self.resize.stats())
            stats["pod_resize_replans"] = self.stale_replans
        if self.standby is not None:
            stats.update(self.standby.stats())
        if self.pipeline is not None:
            # the C lane's local/foreign split (pod_hot_*): reported
            # here, beside the pod's other families, and not by the
            # pipeline's own source, so that a render counts it once
            stats.update(self.pipeline.pod_stats())
        return stats

    def close_pod(self) -> None:
        if self.psum_lane is not None:
            self.psum_lane.close()
        self.lane.stop()


class _ForwardedLimit:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name


class _ForwardedCounter:
    """Header stand-in for a counter loaded on the owner host (the
    fields CheckResult.response_header reads)."""

    __slots__ = (
        "max_value", "remaining", "expires_in", "window_seconds", "limit",
    )

    def __init__(self, max_value, remaining, expires_in, window, name):
        self.max_value = max_value
        self.remaining = remaining
        self.expires_in = expires_in
        self.window_seconds = window
        self.limit = _ForwardedLimit(name)


def psum_share_sender(lane: PeerLane, timeout: float = 2.0):
    """The publish half of ``parallel.pod.PeerPsumTransport`` over this
    lane: a ``send(host, payload)`` for the transport's constructor. It
    runs on the psum pacer's thread, where ``admin_call``'s blocking RPC
    never touches a serving loop."""

    def send(host: int, payload: bytes) -> None:
        lane.admin_call(host, {
            "kind": "psum_share",
            "from": lane.host_id,
            "payload": base64.b64encode(payload).decode(),
        }, timeout=timeout)

    return send
