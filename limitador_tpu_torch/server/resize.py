"""The elastic pod: live resize, drain and join of a running pod.

Counterpart of ``limitador_tpu/server/resize.py``
(``PodResizeCoordinator``). It composes the pod's routing epochs
(``PodRouter.retarget``), the failover journal with its ``apply_deltas``
reconcile, the peer lane's resilience and the pod's event timeline into a
live ``resize``/``add_host``/``drain_host``/``join_host``. The pod adds no
device program: the migration runs the ported kernels of each member's
own table (B3a's host form for the source's reads, B2's host form on
``torch`` and B7c's on ``sharded`` for the receiver's ``apply_deltas``,
B3b's host form and B7b's for the source's release).

The epoch-gated transition, on each member:

1. **prepare**: the initiator sends the proposed topology and the whole
   peer map; each member checks that it is on the FROM epoch, adopts the
   union of the peers (new hosts become dialable before any traffic
   moves) and arms degraded-owner guards for them.
2. **commit** (``resize_begin`` then ``epoch_bump``): each member
   retargets its router to the new topology at the agreed epoch. New
   arrivals route by it; a forward stamped with the old epoch is rejected
   with the rerouteable ``stale_epoch`` and the origin re-plans (never
   decided by a wrong owner). A native pipeline is re-armed here: the C
   mirror learns the new topology (``attach_pod``) and every plan is
   orphaned (``invalidate``), which re-stamps each plan's owner at its
   next derivation and recalls outstanding leases through the return
   ring.
3. **migrate** (``migrate_begin``/``migrate_end`` a slice): each host
   streams the counters it owned under FROM and not under TO, grouped by
   the key's global shard under TO, over the ``migrate`` lane kind. A
   batch carries absolute values; the receiver applies the difference
   against a per-transition ledger, so that a repeated delivery applies
   nothing. Up to four convergence sweeps ship what accrued during the
   copy, then a ``final`` marker; once the receiver acknowledged it, the
   source releases the slice's cells.
4. **complete** (``resize_end``): when every member reports its
   migration done, the initiator completes the transition and the
   receivers drop their ledgers.

**Abort** (``resize_abort``): every reachable member reverts its router
to FROM at a new epoch (epochs only move forward); receivers push back
what they received and admitted since (full values of final slices,
whose source released them, ``value - received`` of partial ones), and
the guards' journals against members the revert removed are
redistributed to their owners through ``apply_deltas``. The
degraded-owner failover answers during the window, so no admitted delta
is lost.

Two repairs of the JAX coordinator:

- ``_storage()`` returns the table behind a served device storage's
  batcher (``inner``), as the frontend's journal replay does: the JAX
  coordinator stops at the batched storage, which has no
  ``apply_deltas``, so its migration into a served device owner fails.
- The source releases each moved cell once the receiver acknowledged
  ``final`` (``drop_counters``: B3b's host form on ``torch``, B7b's on
  ``sharded``); the JAX source releases only on its in-memory storage,
  so a device owner keeps a stale cell that a counter moving back within
  its window lands on top of.

``--pod-resize off`` (the default) never imports this module or builds a
coordinator: forward payloads and every verdict stay as they were.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..core.limit import Namespace
from ..routing import PodTopology, counter_key

__all__ = ["PodResizeCoordinator", "METRIC_FAMILIES"]

log = logging.getLogger("limitador_tpu_torch.pod.resize")

#: metric families of the elastic pod, merged into the pod frontend's
#: library_stats: the coordinator counts the transitions, the lane the
#: wrong-epoch gate's rejections and the frontend the in-band re-plans
METRIC_FAMILIES = (
    "pod_resize_epoch",
    "pod_resize_active",
    "pod_resize_completed",
    "pod_resize_aborted",
    "pod_resize_slices_moved",
    "pod_resize_moved_deltas",
    "pod_resize_released_counters",
    "pod_resize_seconds",
    "pod_resize_stale_rejects",
    "pod_resize_replans",
    # the fast join (a warm standby's promotion): counts on the
    # initiator; the joiner stamps ttfd at its first answered decision
    "join_completed",
    "join_aborted",
    "join_seconds",
    "join_seed_entries",
    "join_ttfd_seconds",
)


def _owner_of(key: tuple, namespace: str, topology: PodTopology,
              pinned: Dict[str, int]) -> int:
    """Who serves this counter under a given (topology, pinned map):
    the pin host for pinned namespaces (their counters live there, not
    at their hash owner), the contiguous-block hash owner otherwise."""
    pin = pinned.get(namespace)
    return pin if pin is not None else topology.owner_host(key)


class _Transition:
    """One membership transition's per-host state machine:
    armed -> migrating -> done | failed | aborted | complete."""

    __slots__ = (
        "from_topology", "to_topology", "peers", "tepoch_from",
        "tepoch_to", "pinned_from", "pinned_to", "state", "error",
        "initiator", "started", "finished", "moved_slices",
        "moved_counters", "aborting",
    )

    def __init__(self, from_topology, to_topology, peers, tepoch_from,
                 tepoch_to, initiator):
        self.from_topology = from_topology
        self.to_topology = to_topology
        self.peers = dict(peers)
        self.tepoch_from = int(tepoch_from)
        self.tepoch_to = int(tepoch_to)
        self.pinned_from: Dict[str, int] = {}
        self.pinned_to: Dict[str, int] = {}
        self.state = "armed"
        self.error: Optional[str] = None
        self.initiator = int(initiator)
        self.started = time.time()
        self.finished: Optional[float] = None
        self.moved_slices = 0
        self.moved_counters = 0
        self.aborting = False

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "from_hosts": self.from_topology.hosts,
            "to_hosts": self.to_topology.hosts,
            "tepoch_from": self.tepoch_from,
            "tepoch_to": self.tepoch_to,
            "initiator": self.initiator,
            "moved_slices": self.moved_slices,
            "moved_counters": self.moved_counters,
            "error": self.error,
            "started": round(self.started, 3),
            "seconds": round(
                (self.finished or time.time()) - self.started, 6
            ),
        }


class PodResizeCoordinator:
    """Drives (and answers) the elastic-membership protocol on one pod
    host. Wire with ``frontend.attach_resize(coordinator)``; the
    initiating host's :meth:`resize` is what the admin endpoint
    (``POST /debug/pod/resize``) calls."""

    #: bounded convergence sweeps per slice: sweep 2+ only ships what
    #: accrued during sweep 1's copy (post-bump the source admits
    #: nothing new for a moving key, so this converges immediately in
    #: practice; in-flight stragglers get one more round)
    MAX_SWEEPS = 4
    #: migrate RPC attempts per slice before the transition fails
    MIGRATE_RETRIES = 3
    #: rows per migrate RPC (the lane runs the default 4MB receive cap)
    CHUNK = 500

    def __init__(
        self,
        frontend,
        peers: Optional[Dict[int, str]] = None,
        listen_address: Optional[str] = None,
        migrate_timeout_s: float = 10.0,
        poll_interval_s: float = 0.05,
        transition_timeout_s: float = 60.0,
        slice_pause_s: float = 0.0,
    ):
        self.frontend = frontend
        self.lane = frontend.lane
        self.router = frontend.router
        self.host_id = int(self.lane.host_id)
        # full member address map INCLUDING this host (broadcast to
        # members so each can derive its own peer set)
        self._peers: Dict[int, str] = {
            int(h): str(a) for h, a in (peers or self.lane.peers).items()
        }
        if listen_address:
            self._peers[self.host_id] = str(listen_address)
        self.migrate_timeout_s = float(migrate_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self.transition_timeout_s = float(transition_timeout_s)
        #: chaos hook (env TPU_POD_RESIZE_SLICE_PAUSE_MS): a pause
        #: between migrate_begin and the first copy of each slice, so a
        #: drill can SIGKILL a host deterministically mid-migration
        self.slice_pause_s = float(slice_pause_s)
        self._lock = threading.RLock()
        # serializes the receiver's ledger diff, apply and record
        self._apply_lock = threading.Lock()
        self._transition: Optional[_Transition] = None
        # True from resize() entry until its transition is installed
        # (or the proposal fails): self._transition only exists at
        # commit, so without this flag two concurrent resize() calls
        # would both pass the active check during the network-bound
        # prepare phase and race two transitions at colliding epochs.
        self._proposing = False
        # receiving-side ledger, per transition: slice -> {
        #   "rows": {key: (counter, received_value)}, "final": bool }
        self._received: Dict[int, dict] = {}
        self._watchdog: Optional[threading.Timer] = None
        # cumulative counters (the pod_resize_* family feed)
        self.completed = 0
        self.aborted = 0
        self.slices_moved = 0
        self.moved_deltas = 0
        self.released_counters = 0
        self.resize_seconds = 0.0
        # fast-join counters (the join_* families). The
        # initiator counts completions and shipped seed entries; the
        # joiner stamps join_ttfd_seconds when its first decision
        # answers after the adopt (0.0 = never joined / not a joiner).
        self.joins_completed = 0
        self.joins_aborted = 0
        self.join_seconds = 0.0
        self.join_seed_entries = 0
        self.join_ttfd_seconds = 0.0
        # set at join_admin "adopt" on the joiner; the first decision
        # after it resolves the ttfd gauge (frontend calls note_first_decision)
        self._join_adopted_at: Optional[float] = None
        # the transition this member prepared and has not committed, and
        # the newest TO epoch committed here (by the commit RPC or by an
        # in-band adoption of the prepared epoch): one commit a
        # transition, whichever arrives first
        self._prepared: Optional[_Transition] = None
        self._committed_epoch = -1

    # -- small accessors -------------------------------------------------------

    @property
    def active(self) -> bool:
        with self._lock:
            t = self._transition
            return t is not None and t.state in ("armed", "migrating")

    @property
    def busy(self) -> bool:
        """True from a resize/join proposal's entry until its
        transition commits or fails — the capacity controller's
        global actuation interlock: nothing may actuate
        while membership is in flight."""
        with self._lock:
            t = self._transition
            return self._proposing or (
                t is not None and t.state in ("armed", "migrating")
            )

    def _storage(self):
        """The counter table: behind the batcher of a served device
        storage, its table (``inner``), which has ``apply_deltas`` and
        ``drop_counters``; the JAX coordinator stops at the batcher."""
        storage = self.frontend._limiter.storage
        storage = getattr(storage, "counters", storage)
        return getattr(storage, "inner", storage)

    def _release(self, counters) -> int:
        """Release the cells of ``counters`` on this host's table: one
        clear of all of them on a device table (B3b's host form, B7b's on
        the sharded one), the in-memory storage's ``drop_counter``
        otherwise. Returns the number of cells that existed."""
        if not counters:
            return 0
        storage = self._storage()
        drop_many = getattr(storage, "drop_counters", None)
        if drop_many is not None:
            return int(drop_many(counters))
        drop = getattr(storage, "drop_counter", None)
        if drop is None:
            return 0
        return sum(1 for counter in counters if drop(counter))

    def stale_info(self) -> dict:
        """What a stale_epoch rejection carries so a behind origin can
        adopt: the current topology geometry and the member map."""
        topo = self.router.topology
        return {
            "topology": {
                "hosts": topo.hosts,
                "shards_per_host": topo.shards_per_host,
            },
            "peers": {str(h): a for h, a in self._peers.items()},
        }

    # -- the initiating host ---------------------------------------------------

    def resize(
        self, hosts: int, peers: Optional[Dict[int, str]] = None,
        shards_per_host: Optional[int] = None,
    ) -> dict:
        """Drive a live membership transition to ``hosts`` (blocking;
        admin endpoint / drill threads — never a serving loop). Returns
        the transition summary; raises ValueError on a bad proposal.
        ``peers`` must map EVERY member of the union membership (old
        and new hosts) to its lane address; omitted entries fall back
        to the map the coordinator already knows."""
        hosts = int(hosts)
        old = self.router.topology
        if hosts < 1:
            raise ValueError("resize needs hosts >= 1")
        if self.host_id >= hosts:
            raise ValueError(
                "initiate a drain from a surviving host (this host "
                f"{self.host_id} leaves the {hosts}-host topology)"
            )
        if hosts == old.hosts:
            return {"ok": True, "noop": True, **self.status()}
        member_map = dict(self._peers)
        for h, addr in (peers or {}).items():
            member_map[int(h)] = str(addr)
        union = range(max(old.hosts, hosts))
        missing = [h for h in union if h not in member_map]
        if missing:
            raise ValueError(
                f"resize to {hosts} hosts needs a peer address for "
                f"every member; missing {missing}"
            )
        with self._lock:
            if self.active or self._proposing:
                raise ValueError("a pod resize is already in flight")
            self._proposing = True
            to_topo = PodTopology(
                hosts=hosts, host_id=self.host_id,
                shards_per_host=int(
                    shards_per_host or old.shards_per_host
                ),
            )
            transition = _Transition(
                old, to_topo, member_map,
                tepoch_from=self.router.topology_epoch,
                tepoch_to=self.router.topology_epoch + 1,
                initiator=self.host_id,
            )
        try:
            return self._drive(transition, union, member_map)
        finally:
            with self._lock:
                self._proposing = False

    def _drive(self, transition: _Transition, union, member_map) -> dict:
        hosts = transition.to_topology.hosts
        members = [h for h in union if h != self.host_id]
        plan = {
            "hosts": hosts,
            "shards_per_host": transition.to_topology.shards_per_host,
            "peers": {str(h): a for h, a in member_map.items()},
            "tepoch_from": transition.tepoch_from,
            "tepoch_to": transition.tepoch_to,
            "from": self.host_id,
        }
        old_peers = dict(self._peers)
        self._peers = member_map
        self.lane.set_peers(
            {h: a for h, a in member_map.items() if h != self.host_id}
        )
        self.frontend.ensure_guards()
        # phase 1: prepare — every member must be reachable and on the
        # FROM epoch before any routing changes anywhere. A refused
        # proposal rolls the peer map back: nothing may keep probing a
        # typo'd address or advertising a map no transition installed.
        for host in members:
            try:
                resp = self.lane.admin_call(
                    host, {"kind": "resize_admin", "op": "prepare", **plan},
                    timeout=self.migrate_timeout_s,
                )
            except Exception as exc:
                self._restore_peers(old_peers)
                raise ValueError(
                    f"pod host {host} unreachable at prepare: {exc}"
                ) from exc
            if not resp.get("ok"):
                self._restore_peers(old_peers)
                raise ValueError(
                    f"pod host {host} refused the resize: "
                    f"{resp.get('error')}"
                )
        # phase 2: commit — this host first (the initiator is the
        # reference epoch; stragglers' forwards re-plan in-band). A
        # member that refuses OR is unreachable aborts the transition
        # immediately — without the refusal check the pod would run
        # split-topology until the deadline.
        self._commit(transition)
        for host in members:
            err = None
            try:
                resp = self.lane.admin_call(
                    host, {"kind": "resize_admin", "op": "commit", **plan},
                    timeout=self.migrate_timeout_s,
                )
                if not resp.get("ok"):
                    err = f"refused commit: {resp.get('error')}"
            except Exception as exc:
                err = f"commit failed: {exc}"
            if err is not None:
                log.warning(
                    f"pod resize: host {host} {err}; aborting the "
                    "transition"
                )
                self._broadcast_abort(
                    transition, f"host {host} {err}"
                )
                return {"ok": False, "aborted": True, **self.status()}
        # phase 3: poll members (and ourselves) until every migration
        # is done, a member fails, or the transition deadline passes
        deadline = time.time() + self.transition_timeout_s
        pending = set(union)
        while time.time() < deadline:
            with self._lock:
                mine = transition.state
            if mine == "done":
                pending.discard(self.host_id)
            elif mine in ("failed", "aborted"):
                self._broadcast_abort(
                    transition, transition.error or "local migration failed"
                )
                return {"ok": False, "aborted": True, **self.status()}
            for host in list(pending - {self.host_id}):
                try:
                    resp = self.lane.admin_call(
                        host,
                        {
                            "kind": "resize_admin", "op": "status",
                            "tepoch_to": transition.tepoch_to,
                            "from": self.host_id,
                        },
                        timeout=self.migrate_timeout_s,
                    )
                except Exception:
                    continue  # transient; the deadline bounds us
                state = resp.get("state")
                if state == "done":
                    pending.discard(host)
                elif state in ("failed", "aborted"):
                    self._broadcast_abort(
                        transition,
                        f"host {host} migration {state}: "
                        f"{resp.get('error')}",
                    )
                    return {"ok": False, "aborted": True, **self.status()}
            if not pending:
                break
            time.sleep(self.poll_interval_s)
        if pending:
            self._broadcast_abort(
                transition,
                f"transition deadline: hosts {sorted(pending)} not done",
            )
            return {"ok": False, "aborted": True, **self.status()}
        # phase 4: complete — receivers drop their ledgers, the new
        # owners are authoritative
        self._complete(transition)
        for host in [h for h in union if h != self.host_id]:
            try:
                self.lane.admin_call(
                    host,
                    {
                        "kind": "resize_admin", "op": "complete",
                        "tepoch_to": transition.tepoch_to,
                        "from": self.host_id,
                    },
                    timeout=self.migrate_timeout_s,
                )
            except Exception as exc:
                # the member self-completes on its watchdog; harmless
                log.warning(
                    f"pod resize: complete to host {host} failed: {exc}"
                )
        return {"ok": True, **self.status()}

    def _restore_peers(self, old_peers: Dict[int, str]) -> None:
        """Roll a failed proposal's peer-map adoption back (before any
        commit, so there is no transition to abort)."""
        self._peers = dict(old_peers)
        self.lane.set_peers({
            h: a for h, a in old_peers.items() if h != self.host_id
        })

    def add_host(self, address: str) -> dict:
        """Grow the pod by one host (the next host id) at ``address``."""
        hosts = self.router.topology.hosts
        return self.resize(hosts + 1, peers={hosts: address})

    def drain_host(self) -> dict:
        """Shrink the pod by one host: the highest host id drains its
        slices to the survivors and leaves the topology. (Host ids are
        contiguous block offsets — only the tail host can leave.)"""
        hosts = self.router.topology.hosts
        if hosts <= 1:
            raise ValueError("cannot drain a single-host pod")
        return self.resize(hosts - 1)

    # -- fast join: warm-standby promotion ------------------------------------

    def join_host(
        self,
        address: str,
        replace: Optional[int] = None,
        seed_plans: bool = True,
        max_seed_entries: int = 4096,
    ) -> dict:
        """Promote a warm standby at ``address`` into the pod, overlap
        its state ship with serving. Two modes:

        * grow (``replace=None``) — the standby becomes the next host
          id; after the ship this is exactly :meth:`add_host` (the
          migrate lane moves its shard slice, already overlapped with
          serving), so the joiner answers forwards the moment the
          commit broadcast lands — before its slice finishes copying.
        * replace (``replace=<dead id>``) — the standby takes over a
          dead member's host id at the SAME geometry: no slice moves,
          only an epoch bump re-points the dead id's address and
          re-plans in-flight forwards. The failover's journal replay
          back-fills whatever the survivors admitted on the dead id's
          behalf once their probes find the standby serving.

        The ship itself (``_ship_join_state``) runs BEFORE any routing
        changes: the standby adopts our CURRENT topology + epoch (so
        the subsequent prepare's FROM-epoch check passes), configures
        our limits generation, and imports the plan-cache seed — all
        while the pod keeps serving on the old membership."""
        started = time.time()
        old = self.router.topology
        if replace is None:
            new_id = old.hosts
            mode = "grow"
        else:
            new_id = int(replace)
            mode = "replace"
            if not (0 <= new_id < old.hosts):
                raise ValueError(
                    f"replace target {new_id} outside the "
                    f"{old.hosts}-host topology"
                )
            if new_id == self.host_id:
                raise ValueError("a host cannot replace itself")
        self.frontend.events.emit(
            "join_begin", mode=mode, joiner=new_id, address=address,
        )
        # the joiner must be dialable for the ship (and, in replace
        # mode, this overwrites the dead member's address)
        member_map = dict(self._peers)
        member_map[new_id] = str(address)
        self._peers = member_map
        self.lane.set_peers({
            h: a for h, a in member_map.items() if h != self.host_id
        })
        self.frontend.ensure_guards()
        try:
            seeded = self._ship_join_state(
                new_id, seed_plans, max_seed_entries
            )
            if mode == "grow":
                out = self.resize(
                    old.hosts + 1, peers={new_id: address}
                )
            else:
                out = self._drive_replace(new_id, member_map)
        except Exception:
            with self._lock:
                self.joins_aborted += 1
            self.frontend.events.emit(
                "join_end", mode=mode, joiner=new_id, ok=False,
            )
            raise
        seconds = time.time() - started
        with self._lock:
            if out.get("ok"):
                self.joins_completed += 1
            else:
                self.joins_aborted += 1
            self.join_seconds += seconds
            self.join_seed_entries += seeded
        self.frontend.events.emit(
            "join_end", mode=mode, joiner=new_id,
            ok=bool(out.get("ok")), seconds=round(seconds, 6),
            seeded=seeded,
        )
        return {
            **out, "mode": mode, "joiner": new_id,
            "join_seconds": round(seconds, 6), "seeded": seeded,
        }

    def _ship_join_state(
        self, host: int, seed_plans: bool, max_seed_entries: int
    ) -> int:
        """Ship the control-plane state a warm standby needs BEFORE the
        membership flip: adopt (topology + epoch + peers + its host
        id), limits (our applied generation, as identity wire), and —
        overlap, not critical path — the plan-cache seed. Returns the
        number of seed entries the joiner applied."""
        topo = self.router.topology
        resp = self.lane.admin_call(
            host,
            {
                "kind": "join_admin", "op": "adopt",
                "host_id": host,
                "hosts": topo.hosts,
                "shards_per_host": topo.shards_per_host,
                "tepoch": self.router.topology_epoch,
                "peers": {str(h): a for h, a in self._peers.items()},
                "from": self.host_id,
            },
            timeout=self.migrate_timeout_s,
        )
        if not resp.get("ok"):
            raise ValueError(
                f"joiner {host} refused adopt: {resp.get('error')}"
            )
        from ..device.plan_cache import _limit_identity_to_wire

        resp = self.lane.admin_call(
            host,
            {
                "kind": "join_admin", "op": "limits",
                "limits": [
                    _limit_identity_to_wire(lim)
                    for lim in self.frontend._last_limits
                ],
                "global_namespaces": sorted(self.frontend._global_ns),
                "from": self.host_id,
            },
            timeout=self.migrate_timeout_s,
        )
        if not resp.get("ok"):
            raise ValueError(
                f"joiner {host} refused limits: {resp.get('error')}"
            )
        if not seed_plans:
            return 0
        seed = self.frontend.plan_seed_export(
            max_entries=max_seed_entries
        )
        if not seed.get("entries"):
            return 0
        try:
            resp = self.lane.admin_call(
                host, {"kind": "plan_seed", **seed},
                timeout=self.migrate_timeout_s,
            )
        except Exception as exc:
            # the seed is an optimization, never a join blocker: a
            # joiner without it just compiles its plans on first miss
            log.warning(f"plan seed ship to joiner {host} failed: {exc}")
            return 0
        return int(resp.get("seeded", 0) or 0)

    def _drive_replace(self, new_id: int, member_map) -> dict:
        """Drive a same-geometry transition: the topology does not
        change shape, only the member map (a dead host id now answers
        at the standby's address) — so ``resize()``'s hosts==old noop
        shortcut cannot express it. Zero slices move; the epoch bump is
        what re-plans in-flight forwards stamped for the dead member
        and re-arms every member's guards at the new address."""
        old = self.router.topology
        with self._lock:
            if self.active or self._proposing:
                raise ValueError("a pod resize is already in flight")
            self._proposing = True
            transition = _Transition(
                old, old, member_map,
                tepoch_from=self.router.topology_epoch,
                tepoch_to=self.router.topology_epoch + 1,
                initiator=self.host_id,
            )
        try:
            return self._drive(
                transition, range(old.hosts), member_map
            )
        finally:
            with self._lock:
                self._proposing = False

    # -- member-side protocol handlers (lane loop — keep them fast) -----------

    def handle_admin(self, payload: dict) -> dict:
        op = payload.get("op")
        if op == "prepare":
            return self._handle_prepare(payload)
        if op == "commit":
            return self._handle_commit(payload)
        if op == "status":
            return self._handle_status(payload)
        if op == "abort":
            return self._handle_abort(payload)
        if op == "complete":
            return self._handle_complete(payload)
        return {"ok": False, "error": f"unknown resize op {op!r}"}

    def _plan_transition(self, payload: dict) -> _Transition:
        member_map = {
            int(h): str(a) for h, a in payload["peers"].items()
        }
        old = self.router.topology
        to_topo = PodTopology(
            hosts=int(payload["hosts"]), host_id=self.host_id,
            shards_per_host=int(payload["shards_per_host"]),
        )
        return _Transition(
            old, to_topo, member_map,
            tepoch_from=int(payload["tepoch_from"]),
            tepoch_to=int(payload["tepoch_to"]),
            initiator=int(payload.get("from", -1)),
        )

    def _handle_prepare(self, payload: dict) -> dict:
        with self._lock:
            if self.active:
                return {
                    "ok": False,
                    "error": "a pod resize is already in flight",
                }
            if int(payload["tepoch_from"]) != self.router.topology_epoch:
                return {
                    "ok": False,
                    "error": (
                        f"topology epoch mismatch: proposal from "
                        f"{payload['tepoch_from']}, host on "
                        f"{self.router.topology_epoch}"
                    ),
                }
            transition = self._plan_transition(payload)
            self._peers = transition.peers
            self._prepared = transition
        self.lane.set_peers({
            h: a for h, a in transition.peers.items()
            if h != self.host_id
        })
        self.frontend.ensure_guards()
        return {"ok": True, "tepoch": self.router.topology_epoch}

    def _handle_commit(self, payload: dict) -> dict:
        with self._lock:
            if int(payload["tepoch_to"]) == self._committed_epoch:
                # committed already: the prepared epoch reached this
                # member in band first (adopt_remote)
                return {"ok": True, "already": True}
            if self.active:
                t = self._transition
                if t is not None and t.tepoch_to == int(payload["tepoch_to"]):
                    return {"ok": True, "already": True}
                return {
                    "ok": False,
                    "error": "a different resize is already in flight",
                }
            if int(payload["tepoch_from"]) != self.router.topology_epoch:
                return {
                    "ok": False,
                    "error": "topology epoch moved between prepare and "
                             "commit",
                }
            transition = self._plan_transition(payload)
            self._committed_epoch = transition.tepoch_to
            self._prepared = None
        self._commit(transition)
        return {"ok": True, "tepoch": self.router.topology_epoch}

    def _handle_status(self, payload: dict) -> dict:
        with self._lock:
            t = self._transition
            if t is None or t.tepoch_to != int(payload.get("tepoch_to", -1)):
                return {
                    "ok": True, "state": "none",
                    "tepoch": self.router.topology_epoch,
                }
            return {"ok": True, **t.snapshot()}

    def _handle_abort(self, payload: dict) -> dict:
        with self._lock:
            t = self._transition
            if t is None or t.tepoch_to != int(payload.get("tepoch_to", -1)):
                return {"ok": True, "state": "none"}
        # off-loop: the revert reverse-migrates ledgers (blocking RPCs)
        threading.Thread(
            target=self._abort,
            args=(t, payload.get("reason", "peer abort")),
            name=f"pod-resize-abort-{self.host_id}",
            daemon=True,
        ).start()
        return {"ok": True}

    def _handle_complete(self, payload: dict) -> dict:
        with self._lock:
            t = self._transition
            if t is None or t.tepoch_to != int(payload.get("tepoch_to", -1)):
                return {"ok": True, "state": "none"}
        self._complete(t)
        return {"ok": True}

    # -- joiner-side fast-join handlers ---------------------------------------

    def handle_join(self, payload: dict):
        """The standby's side of the state ship (the ``join_admin`` lane
        kind; armed by WarmStandby, never by attach_resize). ``limits``
        returns a coroutine the lane dispatch awaits."""
        op = payload.get("op")
        if op == "adopt":
            return self._handle_join_adopt(payload)
        if op == "limits":
            return self._handle_join_limits(payload)
        if op == "status":
            return {
                "ok": True,
                "host": self.host_id,
                "tepoch": self.router.topology_epoch,
                "hosts": self.router.topology.hosts,
                "join_ttfd_seconds": self.join_ttfd_seconds,
            }
        return {"ok": False, "error": f"unknown join op {op!r}"}

    def _handle_join_adopt(self, payload: dict) -> dict:
        """Become host ``host_id`` of the shipped topology at its
        CURRENT epoch — the membership flip as a pure control-plane
        fact: no process restarts; the started table and warm kernels
        keep serving (the hot lane re-armed for the new id). After this the
        initiator's prepare passes our FROM-epoch check and, in grow
        mode, every key still routes away from us (our id is outside
        the pre-grow geometry) until the commit lands."""
        new_id = int(payload["host_id"])
        tepoch = int(payload["tepoch"])
        peers = {
            int(h): str(a)
            for h, a in (payload.get("peers") or {}).items()
        }
        with self._lock:
            if self.active or self._proposing:
                return {
                    "ok": False,
                    "error": "a pod resize is already in flight",
                }
            if tepoch < self.router.topology_epoch:
                return {
                    "ok": False,
                    "error": (
                        f"adopt would move the topology epoch backward "
                        f"({self.router.topology_epoch} -> {tepoch})"
                    ),
                }
            self.host_id = new_id
            self.lane.host_id = new_id
            fe = self.frontend
            fe.events.host_id = new_id
            fe.hops.host_id = new_id
            fe.aggregator.host_id = new_id
            if peers:
                self._peers = peers
            topo = PodTopology(
                hosts=int(payload["hosts"]),
                host_id=new_id,
                shards_per_host=int(payload["shards_per_host"]),
            )
            self.router.retarget(topo, epoch=tepoch)
            self._join_adopted_at = time.time()
        self.lane.set_peers({
            h: a for h, a in peers.items() if h != new_id
        })
        self.frontend.ensure_guards()
        # the standby's hot lane was armed as host 0 of 1: it must split
        # by the shipped topology before any forward reaches it
        self._rearm_pipeline()
        self.frontend.events.emit(
            "epoch_bump", tepoch=tepoch, hosts=int(payload["hosts"]),
            adopted=True, joiner=True,
        )
        return {"ok": True, "host": new_id, "tepoch": tepoch}

    def _handle_join_limits(self, payload: dict):
        """Configure the shipped limits generation (a coroutine — the
        lane loop awaits it; configure_with is async because the inner
        limiter may be). Limits arrive as identity wire dicts, the same
        portable form the plan-seed blobs carry."""
        from ..core.limit import Limit

        limits = []
        for ident in payload.get("limits") or ():
            limits.append(Limit(
                ident["ns"], ident["max"], ident["seconds"],
                list(ident.get("conditions") or ()),
                list(ident.get("variables") or ()),
                name=ident.get("name"), id=ident.get("id"),
                policy=ident.get("policy") or "fixed_window",
            ))
        self.frontend._global_ns = {
            str(ns) for ns in payload.get("global_namespaces") or ()
        }

        async def _apply():
            await self.frontend.configure_with(limits)
            pipeline = self.frontend.pipeline
            if pipeline is not None:
                # as a limits reload does: no plan of the standby's own
                # limits file may answer under the shipped ones
                pipeline.invalidate()
            return {"ok": True, "limits": len(limits)}

        return _apply()

    def note_first_decision(self) -> None:
        """Stamp time-to-first-decision on the joiner: called from the
        forwarded-decision path after a join adopt. Self-disarming —
        one unlocked read once stamped."""
        if self._join_adopted_at is None:
            return
        with self._lock:
            adopted = self._join_adopted_at
            if adopted is None:
                return
            self._join_adopted_at = None
            self.join_ttfd_seconds = round(time.time() - adopted, 6)

    # -- the transition machinery ----------------------------------------------

    def _commit(self, transition: _Transition) -> None:
        """Flip routing to the new topology at the agreed epoch and
        start migrating. Runs on the lane loop (member) or the
        initiator's own thread — fast: lock, retarget, the hot lane's
        re-arm and a thread spawn; the heavy lifting happens on the
        migration thread."""
        events = self.frontend.events
        with self._lock:
            self._transition = transition
            self._received = {}
            self._peers = transition.peers
            transition.pinned_from = self.router.pinned_map()
            events.emit(
                "resize_begin",
                from_hosts=transition.from_topology.hosts,
                to_hosts=transition.to_topology.hosts,
                tepoch=transition.tepoch_to,
                initiator=transition.initiator,
            )
            tepoch = self.router.retarget(
                transition.to_topology, epoch=transition.tepoch_to
            )
            transition.pinned_to = self.router.pinned_map()
            events.emit(
                "epoch_bump", tepoch=tepoch,
                hosts=transition.to_topology.hosts,
            )
            transition.state = "migrating"
            self._watchdog = threading.Timer(
                self.transition_timeout_s + 5.0,
                self._watchdog_fired, args=(transition,),
            )
            self._watchdog.daemon = True
            self._watchdog.start()
        try:
            self._rearm_pipeline()
        except Exception as exc:
            # a hot lane that cannot follow the new topology fails the
            # transition, which the initiator turns into an abort
            log.warning(f"pod resize: hot lane re-arm failed: {exc}")
            with self._lock:
                if transition.state == "migrating":
                    transition.state = "failed"
                    transition.error = f"hot lane re-arm: {exc}"[:300]
            return
        threading.Thread(
            target=self._migrate_out, args=(transition,),
            name=f"pod-resize-migrate-{self.host_id}",
            daemon=True,
        ).start()

    def _rearm_pipeline(self) -> None:
        """Re-arm a native pipeline's C hot lane for the router's current
        topology: ``attach_pod`` reconfigures the C mirror's ownership
        (``hp_pod_config``) and ``invalidate`` orphans every plan, so that
        each is re-stamped with its owner at its next derivation and the
        leases of orphaned plans return through the ring. A row the C lane
        forwards on a stamp of the old topology meanwhile is answered
        ``stale_epoch`` and re-planned, never decided by a wrong owner."""
        pipeline = self.frontend.pipeline
        if pipeline is not None:
            pipeline.attach_pod(self.frontend)
            pipeline.invalidate()

    def _watchdog_fired(self, transition: _Transition) -> None:
        """A transition the initiator never resolved (it may have died
        mid-protocol): self-abort so the host is not stuck in-flight
        forever. A completed-or-aborted transition is a no-op."""
        with self._lock:
            if self._transition is not transition:
                return
            if transition.state in ("aborted", "complete"):
                return
            if transition.state == "done":
                # everyone may be done and only the complete broadcast
                # was lost: completing is the safe self-resolution
                pass
        if transition.state == "done":
            self._complete(transition)
        else:
            self._abort(transition, "transition watchdog expired")

    def _complete(self, transition: _Transition) -> None:
        with self._lock:
            if self._transition is not transition:
                return
            if transition.state not in ("done", "migrating", "armed"):
                return
            transition.state = "complete"
            transition.finished = time.time()
            self._received = {}
            self.completed += 1
            self.resize_seconds += (
                transition.finished - transition.started
            )
            if self._watchdog is not None:
                self._watchdog.cancel()
                self._watchdog = None

    # -- outbound migration ------------------------------------------------------

    def _values_for(self, namespaces) -> Dict[tuple, Tuple[object, int]]:
        """key -> (counter, absolute value) for every live counter of the
        given namespaces: the migration source's view, read off this
        host's table (B3a's host form on a device table). Remaining is
        unclamped there, so value = max - remaining is exact."""
        registry = self.frontend._limiter.storage._registry
        storage = self._storage()
        out: Dict[tuple, Tuple[object, int]] = {}
        for ns in namespaces:
            limits = registry.get(Namespace.of(ns))
            if not limits:
                continue
            for counter in storage.get_counters(limits):
                value = int(counter.max_value) - int(counter.remaining)
                if value <= 0:
                    continue
                out[counter_key(counter)] = (counter, value)
        return out

    def _migrating_namespaces(self) -> List[str]:
        namespaces = sorted({
            str(limit.namespace)
            for limit in self.frontend._last_limits
        })
        psum = self.frontend.psum_lane
        if psum is not None:
            # psum-served namespaces decide read-as-sum locally on
            # every host — there is no slice to move
            namespaces = [
                ns for ns in namespaces if ns not in psum.namespaces
            ]
        return namespaces

    def _migrate_out(self, transition: _Transition) -> None:
        """The migration thread: stream every slice this host owned
        under FROM but not under TO to its new owner, convergence-swept
        and released. Failure marks the transition failed; the
        initiator's poll turns that into a pod-wide abort."""
        from .peering import _counter_to_wire

        try:
            me = self.host_id
            namespaces = self._migrating_namespaces()
            values = self._values_for(namespaces)
            # group moving keys into slices: slice id = the key's
            # global shard under the NEW topology
            slices: Dict[Tuple[int, int], List[tuple]] = {}
            for key, (counter, _value) in values.items():
                ns = str(counter.namespace)
                owner_from = _owner_of(
                    key, ns, transition.from_topology,
                    transition.pinned_from,
                )
                owner_to = _owner_of(
                    key, ns, transition.to_topology, transition.pinned_to,
                )
                if owner_from != me or owner_to == me:
                    continue
                slice_id = transition.to_topology.owner_shard(key)
                slices.setdefault((owner_to, slice_id), []).append(key)
            for (owner, slice_id), keys in sorted(slices.items()):
                if transition.aborting:
                    return
                self.frontend.events.emit(
                    "migrate_begin", slice=slice_id, owner=owner,
                    counters=len(keys),
                )
                if self.slice_pause_s > 0:
                    # chaos hook: a deterministic mid-migration window
                    time.sleep(self.slice_pause_s)
                ns_set = sorted({str(values[k][0].namespace) for k in keys})
                sent: Dict[tuple, int] = {}
                moved = 0
                for _sweep in range(self.MAX_SWEEPS):
                    if transition.aborting:
                        return
                    fresh = self._values_for(ns_set)
                    rows = []
                    for key in keys:
                        entry = fresh.get(key)
                        if entry is None:
                            continue
                        counter, value = entry
                        if value > sent.get(key, 0):
                            rows.append(_counter_to_wire(counter, value))
                            sent[key] = value
                    if not rows and _sweep > 0:
                        break  # converged: nothing accrued during copy
                    if rows:
                        moved += len(rows)
                        self._send_slice(
                            transition, owner, slice_id, rows, final=False
                        )
                # the final marker releases the slice at the receiver's
                # ledger; only then are this host's cells released
                self._send_slice(transition, owner, slice_id, [], final=True)
                released = self._release(
                    [values[key][0] for key in keys if key in values]
                )
                with self._lock:
                    transition.moved_slices += 1
                    transition.moved_counters += len(keys)
                    self.slices_moved += 1
                    self.moved_deltas += moved
                    self.released_counters += released
                self.frontend.events.emit(
                    "migrate_end", slice=slice_id, owner=owner,
                    counters=len(keys), released=released,
                )
            with self._lock:
                if transition.state == "migrating":
                    transition.state = "done"
            self.frontend.events.emit(
                "resize_end",
                tepoch=transition.tepoch_to,
                hosts=transition.to_topology.hosts,
                moved_slices=transition.moved_slices,
                moved_counters=transition.moved_counters,
            )
        except Exception as exc:
            log.warning(f"pod resize: migration failed: {exc}")
            with self._lock:
                if transition.state == "migrating":
                    transition.state = "failed"
                    transition.error = f"{exc}"[:300]

    def _send_slice(
        self, transition: _Transition, owner: int, slice_id: int,
        rows: List[dict], final: bool,
    ) -> None:
        """Ship one slice batch (chunked, retried; idempotent — the
        receiver diffs against its ledger). Raises when the owner stays
        unreachable or rejects the transition epoch."""
        chunks = [
            rows[i:i + self.CHUNK] for i in range(0, len(rows), self.CHUNK)
        ] or [[]]
        for idx, chunk in enumerate(chunks):
            payload = {
                "kind": "migrate",
                "tepoch": transition.tepoch_to,
                "slice": int(slice_id),
                "from": self.host_id,
                "rows": chunk,
                "final": bool(final and idx == len(chunks) - 1),
            }
            last: Optional[Exception] = None
            for attempt in range(self.MIGRATE_RETRIES):
                if transition.aborting:
                    raise RuntimeError("transition aborting")
                try:
                    resp = self.lane.admin_call(
                        owner, payload, timeout=self.migrate_timeout_s
                    )
                except Exception as exc:
                    last = exc
                    time.sleep(0.1 * (attempt + 1))
                    continue
                if resp.get("stale_epoch"):
                    # the receiver may simply not have committed yet
                    # (our migration thread races the initiator's
                    # commit broadcast): back off and retry before
                    # declaring the epoch disagreement terminal
                    last = RuntimeError(
                        f"owner {owner} rejected migrate for epoch "
                        f"{transition.tepoch_to} (on {resp.get('tepoch')})"
                    )
                    time.sleep(0.1 * (attempt + 1))
                    continue
                if not resp.get("ok"):
                    raise RuntimeError(
                        f"owner {owner} refused migrate: "
                        f"{resp.get('error')}"
                    )
                last = None
                break
            if last is not None:
                raise RuntimeError(
                    f"owner {owner} unreachable for slice {slice_id}: "
                    f"{last}"
                )

    # -- inbound migration (the receiving owner) --------------------------------

    def handle_migrate(self, payload: dict) -> dict:
        """Apply one migrated slice batch (lane executor thread). Rows
        carry absolute values; the per-transition ledger turns them into
        apply-once differences, so that retries and re-driven transitions
        never apply twice. The ledger records a row only once its apply
        landed: the JAX receiver records it first, so that a delivery
        whose apply raised is answered "applied 0" at the sender's retry
        and the slice is lost. Here the apply raises to the sender at
        every attempt, whose transition then fails and aborts."""
        from .peering import _counter_from_wire

        slice_id = int(payload.get("slice", -1))
        with self._apply_lock:
            items = []
            updates: Dict[tuple, Tuple[object, int]] = {}
            with self._lock:
                ledger = self._received.setdefault(
                    slice_id, {"rows": {}, "final": False}
                )
                for blob in payload.get("rows", ()):
                    counter, value = _counter_from_wire(blob)
                    value = max(int(value), 0)
                    key = counter_key(counter)
                    prev = updates.get(key) or ledger["rows"].get(key)
                    received = prev[1] if prev is not None else 0
                    diff = value - received
                    if diff > 0:
                        items.append((counter, diff))
                        updates[key] = (counter, value)
                    elif prev is None:
                        updates[key] = (counter, value)
                    # value < received: the window rolled at the source;
                    # keep the higher mark, nothing to apply
            if items:
                self._storage().apply_deltas(items)
            with self._lock:
                ledger["rows"].update(updates)
                if payload.get("final"):
                    ledger["final"] = True
                self.moved_deltas += len(items)
        return {"ok": True, "applied": len(items)}

    # -- abort: revert to the FROM topology with nothing lost -------------------

    def _broadcast_abort(self, transition: _Transition, reason: str) -> None:
        members = [
            h for h in transition.peers if h != self.host_id
        ]
        for host in members:
            try:
                self.lane.admin_call(
                    host,
                    {
                        "kind": "resize_admin", "op": "abort",
                        "tepoch_to": transition.tepoch_to,
                        "reason": reason, "from": self.host_id,
                    },
                    timeout=self.migrate_timeout_s,
                )
            except Exception:
                pass  # a dead member aborts via its own watchdog
        self._abort(transition, reason)

    def _abort(self, transition: _Transition, reason: str) -> None:
        """Revert this host to the FROM topology (at a new agreed
        epoch), push received slices back to their reverted owners and
        redistribute journals accrued against removed members. Safe to
        race: only the first caller flips the state."""
        from .peering import _counter_to_wire

        with self._lock:
            if self._transition is not transition:
                return
            if transition.state in ("aborted", "complete"):
                return
            transition.aborting = True
            transition.state = "aborted"
            transition.error = transition.error or reason
            transition.finished = time.time()
            received, self._received = self._received, {}
            self.aborted += 1
            self.resize_seconds += (
                transition.finished - transition.started
            )
            if self._watchdog is not None:
                self._watchdog.cancel()
                self._watchdog = None
            # every member reverts to the SAME post-abort epoch:
            # tepoch_to + 1 (epochs only move forward)
            self.router.retarget(
                transition.from_topology, epoch=transition.tepoch_to + 1
            )
        self.frontend.events.emit(
            "resize_abort", tepoch=transition.tepoch_to + 1,
            reason=str(reason)[:200],
        )
        try:
            self._rearm_pipeline()
        except Exception as exc:
            log.warning(f"pod resize abort: hot lane re-arm failed: {exc}")
        self.lane.set_peers({
            h: a for h, a in self._peers.items()
            if h != self.host_id and h < transition.from_topology.hosts
        })
        # 1) push back what we received (+ what we admitted meanwhile):
        # full values for finalized slices (the source released), the
        # value-minus-received delta for partial ones (the source kept
        # its copy). Ships over apply_deltas — deliberately NOT epoch
        # gated, so it lands regardless of commit/revert skew.
        values: Dict[tuple, Tuple[object, int]] = {}
        try:
            values = self._values_for(self._migrating_namespaces())
        except Exception as exc:
            log.warning(f"pod resize abort: value sweep failed: {exc}")
        send_back: Dict[int, List[dict]] = {}
        to_drop = []
        with self._lock:
            pinned = self.router.pinned_map()
            for slice_id, ledger in received.items():
                for key, (counter, received_val) in ledger["rows"].items():
                    ns = str(counter.namespace)
                    owner = _owner_of(
                        key, ns, transition.from_topology, pinned
                    )
                    if owner == self.host_id:
                        continue  # we own it under FROM too: keep it
                    entry = values.get(key)
                    value_now = entry[1] if entry is not None else 0
                    delta = (
                        value_now if ledger["final"]
                        else value_now - received_val
                    )
                    if delta > 0:
                        send_back.setdefault(owner, []).append(
                            _counter_to_wire(counter, delta)
                        )
                    to_drop.append(counter)
        for owner, deltas in send_back.items():
            try:
                for start in range(0, len(deltas), self.CHUNK):
                    self.lane.replay_deltas(
                        owner, deltas[start:start + self.CHUNK],
                        timeout=self.migrate_timeout_s,
                    )
            except Exception as exc:
                log.warning(
                    f"pod resize abort: push-back to host {owner} failed "
                    f"({exc}); its keys stay here until the next "
                    "transition"
                )
                # do NOT drop what we could not push back
                to_drop = [
                    c for c in to_drop
                    if _owner_of(
                        counter_key(c), str(c.namespace),
                        transition.from_topology, pinned,
                    ) != owner
                ]
        self._release(to_drop)
        # 2) journals accrued against members the revert removed (the
        # SIGKILLed new host of the drill): their keys' CURRENT owners
        # under FROM must absorb them — the normal probe-driven replay
        # would wait forever for a host that is no longer a member.
        # Swept twice: a decision already inside the degraded path when
        # the revert landed may journal between the sweeps.
        self.sweep_orphan_journals()
        time.sleep(0.05)
        self.sweep_orphan_journals()
        log.warning(
            f"pod resize aborted (reverted to "
            f"{transition.from_topology.hosts} hosts): {reason}"
        )

    def sweep_orphan_journals(self) -> int:
        """Drain journals accrued against hosts that are NOT members of
        the CURRENT topology into the keys' current owners (local
        apply or apply_deltas over the lane). Returns the number of
        counter deltas redistributed. Runs during an abort and is safe
        to call any time a transition removed members — the normal
        probe-driven replay only serves owners that are still members."""
        from .peering import _counter_to_wire

        guards = getattr(self.frontend, "_guards", {})
        with self._lock:
            topology = self.router.topology
            pinned = self.router.pinned_map()
        moved = 0
        for owner, guard in list(guards.items()):
            if owner < topology.hosts:
                continue  # still a member: normal recovery replays it
            if guard.store.journal_size() == 0:
                continue
            items = guard.store.drain()
            local_items = []
            remote: Dict[int, List[Tuple]] = {}
            for counter, delta in items:
                key = counter_key(counter)
                ns = str(counter.namespace)
                target = _owner_of(key, ns, topology, pinned)
                if target == self.host_id:
                    local_items.append((counter, delta))
                else:
                    remote.setdefault(target, []).append(
                        (counter, delta)
                    )
            # a delta is only GONE once some owner acknowledged it: any
            # slice of the drain that fails to land is re-journaled (the
            # reconcile_into un-acked-tail contract, out-of-band), and
            # the oracle's window state survives with it so the next
            # degraded decision stays consistent with the journal.
            failed: List[Tuple] = []
            if local_items:
                try:
                    self._storage().apply_deltas(local_items)
                    moved += len(local_items)
                except Exception as exc:
                    failed.extend(local_items)
                    log.warning(
                        "pod resize: local journal redistribute "
                        f"failed: {exc}"
                    )
            for target, pairs in remote.items():
                deltas = [
                    _counter_to_wire(counter, delta)
                    for counter, delta in pairs
                ]
                acked = 0
                try:
                    for start in range(0, len(deltas), self.CHUNK):
                        self.lane.replay_deltas(
                            target, deltas[start:start + self.CHUNK],
                            timeout=self.migrate_timeout_s,
                        )
                        acked = min(start + self.CHUNK, len(pairs))
                    moved += len(pairs)
                except Exception as exc:
                    moved += acked
                    failed.extend(pairs[acked:])
                    log.warning(
                        "pod resize: journal redistribute to host "
                        f"{target} failed after {acked} deltas: {exc}"
                    )
            if failed:
                guard.store.rejournal(failed)
            else:
                guard.store.reset_oracle()
        return moved

    # -- origin-side adoption ----------------------------------------------------

    def adopt_remote(self, resp: dict) -> None:
        """A stale_epoch rejection carried a NEWER topology than ours:
        adopt it (geometry + peers) so the re-plan routes correctly. A
        host that missed the commit broadcast catches up here; its own
        outbound migration is re-driven by the initiator's poll. Older
        or equal epochs are ignored — epochs only move forward.

        The epoch of a transition this member prepared commits it, as
        the commit RPC would (which then answers "already"): the
        initiator commits first, so a member's forward can meet the new
        epoch before the member's own commit arrives. The JAX
        coordinator adopts the geometry bare, refuses the commit that
        follows ("topology epoch moved") and the transition aborts with
        this member left on the aborted epoch, routing to the joiner."""
        tepoch = int(resp.get("tepoch", -1))
        topo = resp.get("topology") or {}
        if not topo:
            return
        with self._lock:
            # the epoch comparison must sit INSIDE the lock: an abort
            # racing this adoption bumps the epoch past tepoch, and a
            # stale outside-the-lock verdict would retarget BACKWARD
            # onto the aborted geometry
            if tepoch <= self.router.topology_epoch:
                return
            if self.active:
                return  # mid-transition: the protocol owns the epoch
            prepared = self._prepared
            if (prepared is not None
                    and tepoch == prepared.tepoch_to
                    and self.router.topology_epoch == prepared.tepoch_from
                    and int(topo["hosts"]) == prepared.to_topology.hosts
                    and int(topo["shards_per_host"])
                    == prepared.to_topology.shards_per_host
                    and self._committed_epoch != tepoch):
                self._committed_epoch = tepoch
                self._prepared = None
                commit = prepared
            else:
                commit = None
            peers = {
                int(h): str(a)
                for h, a in (resp.get("peers") or {}).items()
            }
            if commit is None:
                if peers:
                    self._peers = peers
                self.router.retarget(PodTopology(
                    hosts=int(topo["hosts"]),
                    host_id=self.host_id,
                    shards_per_host=int(topo["shards_per_host"]),
                ), epoch=tepoch)
        if commit is not None:
            self._commit(commit)
            return
        if peers:
            self.lane.set_peers({
                h: a for h, a in peers.items() if h != self.host_id
            })
            self.frontend.ensure_guards()
        self._rearm_pipeline()
        self.frontend.events.emit(
            "epoch_bump", tepoch=tepoch, hosts=int(topo["hosts"]),
            adopted=True,
        )

    # -- telemetry ---------------------------------------------------------------

    def status(self) -> dict:
        """The ``GET /debug/pod/resize`` payload (and the ``pod_resize``
        /debug/stats section body)."""
        with self._lock:
            t = self._transition
            received = {
                str(slice_id): {
                    "counters": len(ledger["rows"]),
                    "final": ledger["final"],
                }
                for slice_id, ledger in self._received.items()
            }
        return {
            "host": self.host_id,
            "topology_epoch": self.router.topology_epoch,
            "hosts": self.router.topology.hosts,
            "active": self.active,
            "transition": t.snapshot() if t is not None else None,
            "received_slices": received,
            "completed": self.completed,
            "aborted": self.aborted,
            "peers": {str(h): a for h, a in self._peers.items()},
        }

    def stats(self) -> dict:
        """The ``pod_resize_*`` family feed (library_stats keys; the
        lane adds pod_resize_stale_rejects, the frontend
        pod_resize_replans)."""
        return {
            "pod_resize_epoch": self.router.topology_epoch,
            "pod_resize_active": 1 if self.active else 0,
            "pod_resize_completed": self.completed,
            "pod_resize_aborted": self.aborted,
            "pod_resize_slices_moved": self.slices_moved,
            "pod_resize_moved_deltas": self.moved_deltas,
            "pod_resize_released_counters": self.released_counters,
            "pod_resize_seconds": round(self.resize_seconds, 6),
            "join_completed": self.joins_completed,
            "join_aborted": self.joins_aborted,
            "join_seconds": round(self.join_seconds, 6),
            "join_seed_entries": self.join_seed_entries,
            "join_ttfd_seconds": self.join_ttfd_seconds,
        }
