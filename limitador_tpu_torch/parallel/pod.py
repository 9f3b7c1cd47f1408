"""Pod formation over a TCPStore, the pod's barrier, its membership
record and the lockstep psum lane of global namespaces.

Counterpart of the serving pod's parts of
``limitador_tpu/parallel/mesh.py`` (``PodInfo``, ``initialize_pod``,
``pod_info``, ``PodMembership``, ``pod_barrier``, ``PodPsumLane``,
``:171-283``, ``:359-377``, ``:640-1006``). The JAX package forms its pod
with ``jax.distributed``; the port forms it over a
``torch.distributed.TCPStore``: process 0 is the store's master at the
coordinator address, every other process connects to it (retrying until
the timeout), and a barrier is a store counter plus a wait on its done
key. No process group is formed: the serving pod needs no collective
(each host decides on its own table, and cross-host reads go over the
peer lane and the psum lane, as in the JAX serving pod with its per-host
meshes), and two pod processes on one card could not each hold it in an
NCCL group.

``PodPsumLane`` is the JAX lane's code: an exact local partial per
counter, and a remote base folded in by a lockstep exchange whose
default transport is the store's ``set``/``get`` under the JAX round keys
and barrier. The transport stays a parameter, so tests inject one.

``PeerPsumTransport`` (JAX ``parallel/mesh.py:1009-1096``) is the paced
transport over the pod's peer lane: each host pushes its newest partials
every round through the lane's ``psum_share`` kind and folds the newest
payload received from each peer, aging a silent peer out after
``stale_after_s`` and unclaiming after ``dead_after_rounds`` rounds in
which every peer was silent.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from datetime import timedelta
from typing import NamedTuple, Optional

import numpy as np

from ..core.limiter import CheckResult
from ..routing import counter_key, stable_hash
from ..storage.expiring_value import ExpiringValue

__all__ = [
    "PodInfo",
    "initialize_pod",
    "pod_info",
    "pod_store",
    "PodMembership",
    "pod_barrier",
    "PodPsumLane",
    "PeerPsumTransport",
    "METRIC_FAMILIES",
]

#: the psum lane's families, as the JAX package
#: registers them (the analysis gate holds them to
#: observability/metrics.py)
METRIC_FAMILIES = (
    "pod_psum_namespaces",
    "pod_psum_decisions",
    "pod_psum_limited",
    "pod_psum_exchanges",
    "pod_psum_cells",
    "pod_psum_remote_slots",
)

log = logging.getLogger("limitador_tpu_torch")


class PodInfo(NamedTuple):
    """The process's place in the pod (one process, its own devices,
    when no pod was formed)."""

    process_id: int
    num_processes: int
    local_device_count: int
    global_device_count: int

    @property
    def multi_host(self) -> bool:
        return self.num_processes > 1


# The formed pod of this process: its PodInfo and the store it formed
# over (None until initialize_pod).
_POD: dict = {"info": None, "store": None}


def initialize_pod(
    coordinator: str, num_processes: int, process_id: int,
    local_device_count: int = 1, timeout_s: float = 120.0,
) -> PodInfo:
    """Form the pod over a TCPStore at ``coordinator`` (host:port):
    process 0 serves the store there, the others connect to it, and
    every process publishes its ``local_device_count`` (the rows its
    sharded table takes) so that each knows the global count. Returns
    once every process has joined. Idempotent: a second call returns
    the pod already formed."""
    if _POD["info"] is not None:
        return _POD["info"]
    from torch.distributed import TCPStore

    host, _, port = str(coordinator).rpartition(":")
    num_processes = int(num_processes)
    process_id = int(process_id)
    store = TCPStore(
        host or "127.0.0.1", int(port), num_processes,
        is_master=process_id == 0,
        timeout=timedelta(seconds=timeout_s),
    )
    store.set(f"pod/devices/{process_id}", str(int(local_device_count)))
    total = sum(
        int(store.get(f"pod/devices/{pid}"))
        for pid in range(num_processes)
    )
    info = PodInfo(
        process_id=process_id,
        num_processes=num_processes,
        local_device_count=int(local_device_count),
        global_device_count=total,
    )
    _POD["store"] = store
    _POD["info"] = info
    pod_barrier("pod-formed", timeout_ms=int(timeout_s * 1e3))
    return info


def pod_info(local_device_count: int = 1) -> PodInfo:
    """The formed pod, or this process alone when none was formed."""
    info = _POD["info"]
    if info is not None:
        return info
    return PodInfo(0, 1, int(local_device_count), int(local_device_count))


def pod_store():
    """The TCPStore the pod formed over (None without a pod)."""
    return _POD["store"]


class PodMembership:
    """The pod's membership as a control-plane record: (hosts, host_id,
    peers, topology_epoch), flipped by a membership change under commit
    and observed by subscribers."""

    def __init__(self, hosts: int = 1, host_id: int = 0,
                 peers=(), epoch: int = 0):
        self._lock = threading.Lock()
        self.hosts = int(hosts)
        self.host_id = int(host_id)
        self.peers = tuple(peers)
        self.epoch = int(epoch)
        self._listeners = []

    def subscribe(self, fn) -> None:
        """fn(membership) after every apply(), called outside the lock
        (a listener may read snapshot())."""
        with self._lock:
            self._listeners.append(fn)

    def apply(self, hosts: int, host_id: int, peers=(),
              epoch: Optional[int] = None) -> dict:
        with self._lock:
            self.hosts = int(hosts)
            self.host_id = int(host_id)
            self.peers = tuple(peers)
            self.epoch = (
                self.epoch + 1 if epoch is None else int(epoch)
            )
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(self)
            except Exception:  # a bad listener must not fail a commit
                pass
        return self.snapshot()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "hosts": self.hosts,
                "host_id": self.host_id,
                "peers": list(self.peers),
                "epoch": self.epoch,
            }

    @property
    def multi_host(self) -> bool:
        return self.hosts > 1


def _barrier(store, tag: str, world: int, timeout_ms: int) -> None:
    """Arrive at barrier ``tag`` of ``world`` processes on ``store`` and
    wait for the last to arrive (raises when ``timeout_ms`` passes)."""
    if store.add(f"barrier/{tag}", 1) >= world:
        store.set(f"barrier/{tag}/done", b"1")
    store.wait([f"barrier/{tag}/done"], timedelta(milliseconds=timeout_ms))


def pod_barrier(tag: str, timeout_ms: int = 120_000) -> None:
    """Control-plane barrier across the pod's processes (no-op for one
    process): a store counter and a wait, touching no device, so that
    other threads keep deciding while this one waits. Each ``tag`` is
    used once."""
    info = _POD["info"]
    if info is None or info.num_processes <= 1:
        return
    _barrier(_POD["store"], tag, info.num_processes, int(timeout_ms))


# -- the lockstep pod psum lane ----------------------------------------------
#
# Without it, a global namespace is pinned whole to one host: exact, but
# its traffic funnels through that host. The psum lane keeps an exact
# local partial per counter on every host and decides against the other
# hosts' partials folded in by a lockstep exchange, so every host
# answers locally. Between rounds a host cannot see what was admitted
# elsewhere, so over-admission is bounded by one exchange interval of
# each other host's admissions (the reference's cached-Redis bound).


class PodPsumLane:
    """Host-local exact partials + lockstep-folded remote base for
    global-namespace limits.

    ``configure(limits, global_namespaces)`` claims the namespaces this
    lane can serve (fixed-window only: a GCRA TAT cell cannot be a
    summed partial); the pod frontend then stops pinning them. The
    decision surface (``check_and_update`` / ``is_rate_limited`` /
    ``update_counters``) is synchronous: one dict pass over local cells
    plus a read of the folded remote vector, never an RPC.

    ``exchange()`` runs one lockstep round: publish my live partials,
    fold everyone else's. Every pod host must call it the same number of
    times in the same order (the transport is collective); the pacing
    thread keeps the hosts in lockstep because each round's barrier
    waits for the slowest host.
    """

    #: remote partials fold into a fixed slot vector so that a payload is
    #: bounded; colliding keys merge their remote sums (a merged base can
    #: only under-admit)
    DEFAULT_SLOTS = 2048

    def __init__(
        self,
        hosts: int,
        host_id: int,
        clock=time.time,
        slots: int = DEFAULT_SLOTS,
        cell_cap: int = 1 << 16,
        transport=None,
        barrier_timeout_ms: int = 30_000,
        store=None,
    ):
        self.hosts = int(hosts)
        self.host_id = int(host_id)
        self._clock = clock
        self._slots = int(slots)
        self._cell_cap = int(cell_cap)
        self._barrier_timeout_ms = int(barrier_timeout_ms)
        #: namespaces (str) this lane serves; read lock-free by the
        #: frontend's ``_psum_serves`` (the set is replaced whole)
        self.namespaces: frozenset = frozenset()
        self._lock = threading.Lock()
        # counter key -> ExpiringValue (this host's partial), LRU-bounded
        self._cells: "OrderedDict" = OrderedDict()
        # key -> slot, filled when a cell is made and dropped with it, so
        # that neither a decision nor a pack hashes a key again
        self._slot_memo: dict = {}
        # the folded remote base (the other hosts' live partials at the
        # last round) per slot, with the latest expiry; an expired slot
        # reads as 0
        self._remote_vals = np.zeros(self._slots, np.int64)
        self._remote_exp = np.zeros(self._slots, np.float64)
        self._transport = transport
        self._store = store
        self.rounds = 0
        self.decisions = 0
        self.limited = 0
        self.exchanges = 0
        self._pacer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # set when the pacing thread dies on a failed exchange: a dead
        # lane stays unclaimed across limits reloads
        self._pacer_dead = False

    # -- configuration -------------------------------------------------------

    def configure(self, limits, global_namespaces) -> frozenset:
        """Claim the global namespaces every limit of which this lane
        can count (fixed-window policies only). Returns the served set;
        the caller pins the rest."""
        if self._pacer_dead:
            self.namespaces = frozenset()
            return self.namespaces
        by_ns: dict = {}
        for limit in limits:
            by_ns.setdefault(str(limit.namespace), []).append(limit)
        served = frozenset(
            ns for ns in (str(n) for n in global_namespaces)
            if ns in by_ns and all(
                lim.policy == "fixed_window" for lim in by_ns[ns]
            )
        )
        self.namespaces = served
        return served

    # -- internals -----------------------------------------------------------

    def _slot_of(self, key: tuple) -> int:
        s = self._slot_memo.get(key)
        if s is None:
            s = stable_hash(key) % self._slots
        return s

    def _cell(self, key: tuple, window_s: int, now: float):
        ev = self._cells.get(key)
        if ev is None:
            # a fresh window even on a pure check (the in-memory
            # oracle's semantics)
            ev = ExpiringValue(0, now + window_s)
            self._cells[key] = ev
            self._slot_memo[key] = stable_hash(key) % self._slots
            while len(self._cells) > self._cell_cap:
                evicted, _ = self._cells.popitem(last=False)
                self._slot_memo.pop(evicted, None)
        else:
            self._cells.move_to_end(key)
        return ev

    def _remote_live(self, key: tuple, now: float) -> int:
        s = self._slot_of(key)
        if now >= self._remote_exp[s]:
            return 0
        return int(self._remote_vals[s])

    # -- the decision surface (sync, called by PodFrontend) ------------------

    def check_and_update(
        self, counters, delta: int, load_counters: bool = False
    ):
        """Check-all-then-update-all over base + partial, the in-memory
        oracle's discipline (never over-admits locally; remote deltas
        since the last round are the bounded blind spot)."""
        now = self._clock()
        with self._lock:
            self.decisions += 1
            first_limited = None
            to_update = []
            # simple counters first, then qualified: the oracle's
            # first_limited order
            for qualified_pass in (False, True):
                for counter in counters:
                    if counter.is_qualified() is not qualified_pass:
                        continue
                    key = counter_key(counter)
                    ev = self._cell(key, counter.window_seconds, now)
                    value = ev.value_at(now) + self._remote_live(key, now)
                    over = value + delta > counter.max_value
                    if load_counters:
                        remaining = counter.max_value - (value + delta)
                        counter.remaining = max(remaining, 0)
                        counter.expires_in = ev.ttl(now)
                        if first_limited is None and remaining < 0:
                            first_limited = counter.limit.name
                    elif over:
                        self.limited += 1
                        return CheckResult(True, [], counter.limit.name)
                    to_update.append((ev, counter.window_seconds))
            if first_limited is not None:
                self.limited += 1
                return CheckResult(True, list(counters), first_limited)
            for ev, window in to_update:
                ev.update(delta, window, now)
        return CheckResult(False, list(counters) if load_counters else [],
                           None)

    def is_rate_limited(self, counters, delta: int):
        now = self._clock()
        with self._lock:
            self.decisions += 1
            for counter in counters:
                key = counter_key(counter)
                ev = self._cells.get(key)
                value = (ev.value_at(now) if ev is not None else 0) + \
                    self._remote_live(key, now)
                if value + delta > counter.max_value:
                    self.limited += 1
                    return CheckResult(True, [counter], counter.limit.name)
        return CheckResult(False, [], None)

    def update_counters(self, counters, delta: int) -> None:
        now = self._clock()
        with self._lock:
            for counter in counters:
                key = counter_key(counter)
                ev = self._cell(key, counter.window_seconds, now)
                ev.update(delta, counter.window_seconds, now)

    # -- the lockstep exchange -----------------------------------------------

    def _pack(self, now: float) -> bytes:
        vals = np.zeros(self._slots, np.int64)
        exps = np.zeros(self._slots, np.float64)
        for key, ev in self._cells.items():
            v = ev.value_at(now)
            if v <= 0:
                continue
            s = self._slot_of(key)
            vals[s] += v
            if ev.expiry > exps[s]:
                exps[s] = ev.expiry
        return vals.tobytes() + exps.tobytes()

    def _unpack(self, payload: bytes):
        n = self._slots
        vals = np.frombuffer(payload[: n * 8], np.int64)
        exps = np.frombuffer(payload[n * 8:], np.float64)
        return vals, exps

    def _store_transport(self, round_idx: int, payload: bytes):
        """The live pod's transport: the pod's TCPStore, under the round
        keys ``psum-lane/{round}/{host}`` and the barrier
        ``psum-lane-r{round}``. Without a store the round fails (a
        round that folded nothing would let every host admit the whole
        limit)."""
        store = self._store if self._store is not None else pod_store()
        if store is None:
            raise RuntimeError(
                "pod psum lane: no pod store for the exchange"
            )
        store.set(f"psum-lane/{round_idx}/{self.host_id}", payload)
        _barrier(store, f"psum-lane-r{round_idx}", self.hosts,
                 self._barrier_timeout_ms)
        # Passing round k's barrier means every host finished round k-1,
        # so its keys can never be read again: drop mine (and host 0 the
        # barrier's), or the store grows a payload a host a round.
        if round_idx > 0:
            prev = round_idx - 1
            store.delete_key(f"psum-lane/{prev}/{self.host_id}")
            if self.host_id == 0:
                store.delete_key(f"barrier/psum-lane-r{prev}")
                store.delete_key(f"barrier/psum-lane-r{prev}/done")
        out = []
        for h in range(self.hosts):
            if h == self.host_id:
                out.append(payload)
                continue
            out.append(store.get(f"psum-lane/{round_idx}/{h}"))
        return out

    def exchange(self) -> int:
        """One lockstep exchange round; returns the round count. Every
        pod host must call this the same number of times, in order.
        A one-host pod folds nothing and stays exact."""
        now = self._clock()
        with self._lock:
            payload = self._pack(now)
            round_idx = self.rounds
        transport = self._transport or self._store_transport
        payloads = transport(round_idx, payload)
        rv = np.zeros(self._slots, np.int64)
        re_ = np.zeros(self._slots, np.float64)
        for h, p in enumerate(payloads):
            if h == self.host_id or p is None:
                continue
            pv, pe = self._unpack(p)
            rv += pv
            np.maximum(re_, pe, out=re_)
        with self._lock:
            self._remote_vals = rv
            self._remote_exp = re_
            self.rounds = round_idx + 1
            self.exchanges += 1
        return self.rounds

    def start(self, interval_s: float = 0.25) -> None:
        """Pace lockstep rounds on a daemon thread: sleep, then
        exchange. A host that stops answering times every peer's barrier
        out; each pacer then unclaims its namespaces before it exits, so
        the frontend sends them back to the pinned (exact) path instead
        of letting every host admit against a stale base."""
        if self._pacer is not None or self.hosts <= 1:
            return

        def run():
            while not self._stop.wait(interval_s):
                try:
                    self.exchange()
                except Exception:
                    if not self._stop.is_set():
                        log.warning(
                            "pod psum lane: exchange failed at round "
                            f"{self.rounds} (barrier timeout or peer "
                            "loss); unclaiming "
                            f"{len(self.namespaces)} namespaces, which "
                            "go back to the pinned path",
                            exc_info=True,
                        )
                    self._pacer_dead = True
                    self.namespaces = frozenset()
                    return

        self._pacer = threading.Thread(
            target=run, name="pod-psum-lane", daemon=True
        )
        self._pacer.start()

    def close(self) -> None:
        self._stop.set()

    # -- telemetry -----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            live_remote = int(
                np.count_nonzero(
                    self._remote_vals
                    * (self._remote_exp > self._clock())
                )
            )
            return {
                "pod_psum_namespaces": len(self.namespaces),
                "pod_psum_decisions": self.decisions,
                "pod_psum_limited": self.limited,
                "pod_psum_exchanges": self.exchanges,
                "pod_psum_cells": len(self._cells),
                "pod_psum_remote_slots": live_remote,
            }


class PeerPsumTransport:
    """Peer-lane exchange for :class:`PodPsumLane`, paced instead of
    lockstep: each round publishes this host's newest partials to every
    peer (``send(host, payload)``, the lane's ``psum_share`` kind through
    ``server.peering.psum_share_sender``) and folds the newest payload
    received from each peer (``receive``, the lane handler's delivery).
    A missing peer contributes None (the fold skips it), so a dead host
    costs staleness bounded by the pacing, never a stalled barrier.

    A peer whose payloads stop arriving ages out after ``stale_after_s``
    (its partials fold as zero: bounded over-admission), and when every
    peer has been silent for ``dead_after_rounds`` rounds in a row the
    transport raises, which routes the lane through its unclaim path: N
    hosts must not each admit the full limit against a base that stays
    zero."""

    def __init__(self, host_id: int, send, hosts: int = 1,
                 stale_after_s: float = 2.0,
                 dead_after_rounds: int = 8, clock=time.time):
        self.host_id = int(host_id)
        self.hosts = int(hosts)
        self._send = send
        self._stale_after_s = float(stale_after_s)
        self._dead_after_rounds = int(dead_after_rounds)
        self._clock = clock
        self._lock = threading.Lock()
        self._rx: dict = {}  # host -> (received at, payload)
        self._silent_rounds = 0
        self.published = 0
        self.send_errors = 0

    def attach(self, hosts: int, host_id: Optional[int] = None) -> None:
        """A membership change (a resize's or a join's commit): widen or
        narrow the fold, keeping the payloads already received."""
        with self._lock:
            self.hosts = int(hosts)
            if host_id is not None:
                self.host_id = int(host_id)
            self._silent_rounds = 0

    def receive(self, host: int, payload: bytes) -> None:
        """The lane's delivery of a peer's published partials."""
        with self._lock:
            self._rx[int(host)] = (self._clock(), payload)

    def __call__(self, round_idx: int, payload: bytes):
        with self._lock:
            hosts, host_id = self.hosts, self.host_id
        for h in range(hosts):
            if h == host_id:
                continue
            try:
                self._send(h, payload)
            except Exception:
                self.send_errors += 1
        self.published += 1
        now = self._clock()
        out = []
        fresh_peers = 0
        with self._lock:
            for h in range(hosts):
                if h == host_id:
                    out.append(payload)
                    continue
                got = self._rx.get(h)
                if got is None or now - got[0] > self._stale_after_s:
                    out.append(None)
                else:
                    out.append(got[1])
                    fresh_peers += 1
            if hosts > 1 and fresh_peers == 0:
                self._silent_rounds += 1
            else:
                self._silent_rounds = 0
            if (hosts > 1
                    and self._silent_rounds >= self._dead_after_rounds):
                raise RuntimeError(
                    "peer psum transport: every peer silent for "
                    f"{self._silent_rounds} rounds; unclaiming"
                )
        return out
