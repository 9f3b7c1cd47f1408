"""The replicated topology of the port against the JAX package's.

- The kernels: ``replicated_check_plain``, ``replicated_update_plain`` and
  ``apply_remote_plain`` (what the B6a/B6b/B6c wrappers run on CPU
  tensors) against the jitted ``_replicated_check``, ``_replicated_update``
  and ``_apply_remote`` of ``limitador_tpu/tpu/replicated.py``, on
  numpy-seeded inputs: window and bucket lanes, live, expired and fresh
  remote lanes, local + remote sums past 2**31.
- The storage: a JAX ``TpuReplicatedStorage`` pair and a port
  ``TorchReplicatedStorage(device="cpu")`` pair, each pair joined by a
  loopback broker, on frozen clocks, take one script of check batches,
  ``update_counter``, ``apply_deltas``, ``is_within_limits``, gossip
  ticks and injected peer updates, with wire keys parked before their
  limit exists, recycled slots, beyond-cap limits, buckets and an epoch
  rebase. Answers, loaded counters, ``get_counters``,
  ``_snapshot_for_peer()`` and all five device arrays must be equal.
- The port alone: the behaviours ``tests/test_tpu_replicated.py`` pins
  for the JAX package (convergence over real brokers, late-joiner
  re-sync, window reset, pruning, snapshots, the Report-path TAT floor,
  randomized gossip convergence).
- A mixed cluster: one JAX node and one port node gossiping over real
  gRPC brokers on localhost.

Every output compared is an integer or a count of integer milliseconds,
so the tolerance is exact equality.
"""

import random
import socket
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limitador_tpu as J
import limitador_tpu_torch as T
from limitador_tpu.core.counter import Counter as JCounter
from limitador_tpu.ops import kernel as JK
from limitador_tpu.storage.keys import key_for_counter as j_key
from limitador_tpu.tpu import replicated as JR
from limitador_tpu.tpu.storage import _Request as JRequest
from limitador_tpu_torch.core.counter import Counter as TCounter
from limitador_tpu_torch.device.replicated import TorchReplicatedStorage
from limitador_tpu_torch.device.storage import _Request as TRequest
from limitador_tpu_torch.ops import kernel as TK
from limitador_tpu_torch.storage.base import StorageError
from limitador_tpu_torch.storage.keys import key_for_counter as t_key

from .torch_batches import (
    C,
    NEVER,
    SpyContext,
    batch,
    fake_card,
    lanes,
    padded_update_columns,
    remote_lanes,
    remote_rows,
    table,
    update_entries,
)

# -- the kernels -------------------------------------------------------------


def _states(values, expiry, hits):
    return (
        JK.CounterTableState(*(jnp.asarray(a) for a in (values, expiry,
                                                         hits))),
        TK.CounterTableState(*(torch.from_numpy(a.copy())
                               for a in (values, expiry, hits))),
    )


def _same_table(jstate, tstate):
    for name, j, t in zip(TK.CounterTableState._fields, jstate, tstate):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


@pytest.mark.parametrize("H", [8, 64, 1024])
@pytest.mark.parametrize("seed", range(3))
def test_replicated_kernels_match_jax(H, seed):
    rng = np.random.default_rng(7000 + 100 * seed + H)
    now_ms = 5_000_000
    n_slots = 600
    slot_lanes = lanes(rng, n_slots)
    values, expiry, hits = table(rng, now_ms, slot_lanes)
    rv, re = remote_lanes(rng, now_ms, slot_lanes, values, n_slots)
    # the generator must reach every case the hooks distinguish
    window = np.asarray([not slot_lanes[s][0] for s in range(n_slots)])
    assert (window & (re[:n_slots] > now_ms) & (rv[:n_slots] > 0)).any()
    assert (window & (re[:n_slots] <= now_ms) & (rv[:n_slots] > 0)).any()
    assert (~window & (re[:n_slots] > now_ms)).any()
    assert (~window & (re[:n_slots] > 0) & (re[:n_slots] <= now_ms)).any()
    live_big = (values[:n_slots].astype(np.int64) + rv[:n_slots]) >= 1 << 31
    assert (window & live_big).any()
    jstate, tstate = _states(values, expiry, hits)
    jrem = (jnp.asarray(rv), jnp.asarray(re))
    trem = (torch.from_numpy(rv.copy()), torch.from_numpy(re.copy()))
    seen_fresh = seen_bucket = False
    for _round in range(3):
        arrays = batch(rng, H, slot_lanes, n_slots)
        seen_fresh |= bool(arrays[5].any())
        seen_bucket |= bool(arrays[6].any())
        jstate, jres = JR._replicated_check(
            jstate, *jrem, *arrays, np.int32(now_ms))
        tstate, tres = TK.replicated_check_batch(
            tstate, *trem, *(torch.from_numpy(a) for a in arrays), now_ms)
        for name, j, t in zip(TK.BatchResult._fields, jres, tres):
            np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                          err_msg=name)
        _same_table(jstate, tstate)
        slots, deltas, _m, wins, _r, fresh, bucket = batch(
            rng, H, slot_lanes, n_slots)
        deltas = np.where(rng.random(H) < 0.1, rng.integers(-5, 1 << 30, H),
                          deltas).astype(np.int32)
        upd = (slots, deltas, wins, fresh, bucket)
        jstate = JR._replicated_update(jstate, jrem[1], *upd,
                                       np.int32(now_ms))
        tstate = TK.replicated_update_batch(
            tstate, trem[1], *(torch.from_numpy(a) for a in upd), now_ms)
        _same_table(jstate, tstate)
        rows = remote_rows(rng, min(H, n_slots), n_slots)
        jrem = JR._apply_remote(*jrem, *rows)
        trem = TK.apply_remote(*trem, *(torch.from_numpy(a) for a in rows))
        for j, t in zip(jrem, trem):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
        now_ms += 900
    assert seen_bucket and (seen_fresh or H == 8)


def test_replicated_check_with_empty_remote_lanes_is_b1():
    rng = np.random.default_rng(5)
    now_ms = 5_000_000
    slot_lanes = lanes(rng, 300)
    tab = table(rng, now_ms, slot_lanes)
    a = TK.CounterTableState(*(torch.from_numpy(x.copy()) for x in tab))
    b = TK.CounterTableState(*(torch.from_numpy(x.copy()) for x in tab))
    zeros = torch.zeros(tab[0].shape[0], dtype=torch.int32)
    for _round in range(3):
        arrays = [torch.from_numpy(x) for x in batch(rng, 256, slot_lanes,
                                                     300)]
        _, ra = TK.replicated_check_batch(a, zeros, zeros, *arrays, now_ms)
        _, rb = TK.check_and_update_batch(b, *arrays, now_ms)
        for x, y in zip(list(ra) + list(a), list(rb) + list(b)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("H", [1024, 2048])
def test_replicated_check_matches_jax_at_the_cluster_shapes(H):
    """B6a's plain version against the JAX ``_replicated_check`` at the
    hit counts the cluster route takes (1,024 to 16,384), on batches that
    reach every hook: window hits on live and on expired remote sums,
    bucket hits floored by a remote TAT ahead of now and by one behind
    it, and hits whose local + live remote sum passes 2**31."""
    rng = np.random.default_rng(9100 + H)
    now_ms = 5_000_000
    n_slots = 1500
    slot_lanes = lanes(rng, n_slots)
    values, expiry, hits = table(rng, now_ms, slot_lanes)
    rv, re = remote_lanes(rng, now_ms, slot_lanes, values, n_slots)
    jstate, tstate = _states(values, expiry, hits)
    jrem = (jnp.asarray(rv), jnp.asarray(re))
    trem = (torch.from_numpy(rv.copy()), torch.from_numpy(re.copy()))
    reached = set()
    for _round in range(2):
        arrays = batch(rng, H, slot_lanes, n_slots)
        s, bucket = arrays[0], arrays[6]
        live = re[s] > now_ms
        window = ~bucket & (s < n_slots)
        reached |= {
            name for name, hit in (
                ("live sum", window & live & (rv[s] > 0)),
                ("expired sum", window & ~live & (rv[s] > 0)),
                ("floor ahead", bucket & live),
                ("floor behind", bucket & ~live & (re[s] > 0)),
                ("past 2**31", window & live & (
                    values[s].astype(np.int64) + rv[s] >= 1 << 31)),
            ) if hit.any()
        }
        jstate, jres = JR._replicated_check(
            jstate, *jrem, *arrays, np.int32(now_ms))
        tstate, tres = TK.replicated_check_batch(
            tstate, *trem, *(torch.from_numpy(a) for a in arrays), now_ms)
        for name, j, t in zip(TK.BatchResult._fields, jres, tres):
            np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                          err_msg=name)
        _same_table(jstate, tstate)
        now_ms += 900
    assert reached == {"live sum", "expired sum", "floor ahead",
                       "floor behind", "past 2**31"}


@pytest.mark.parametrize("H, route", [
    (1, "block"), (8, "block"), (1023, "block"), (1024, "cluster"),
    (8192, "cluster"), (16384, "cluster"), (16385, "block"),
])
def test_replicated_check_routes_by_hits_as_b1(monkeypatch, H, route):
    """B6a's card path takes B1's rule on H (``check_route``): the cluster
    kernel from 1,024 to 16,384 hits with no workspace, counted under
    ``replicated_check_cluster``, else the one block with its workspace;
    ``route=`` forces either, and an unknown route raises. The card is
    stood in for by a library that records its entry points."""
    lib = fake_card(monkeypatch)
    assert TK.check_route(H) == route
    state = TK.make_table(64, "cpu")
    lanes_ = (torch.zeros(65, dtype=torch.int32),) * 2
    cols = ([torch.zeros(H, dtype=torch.int32)] * 5
            + [torch.zeros(H, dtype=torch.bool)] * 2)
    entry = {"cluster": ["ct_check_and_update_replicated_cluster"],
             "block": ["ct_check_workspace_bytes",
                       "ct_check_and_update_replicated"]}
    key = {"cluster": "replicated_check_cluster",
           "block": "replicated_check"}
    for forced in (None, "block", "cluster"):
        taken = forced or route
        before = dict(TK.launches)
        lib.calls.clear()
        TK.replicated_check_batch(state, *lanes_, *cols, 1000, route=forced)
        assert lib.names() == entry[taken]
        assert {k: v - before[k] for k, v in TK.launches.items()
                if v != before[k]} == {key[taken]: 1}
    with pytest.raises(ValueError, match="no route"):
        TK.replicated_check_batch(state, *lanes_, *cols, 1000, route="grid")


# -- the storage, JAX against the port ---------------------------------------


class FakeClock:
    def __init__(self, now=1_700_000_000.0):
        self.now = now

    def __call__(self):
        return self.now


class Loopback:
    """Stands in for a broker: ``publish`` delivers to the other nodes'
    ``_on_remote_update`` at once; ``stop`` (called by ``close``) does
    nothing. Records every publish."""

    def __init__(self, peers):
        self.peers = peers
        self.sent = []

    def publish(self, key, values, expires_at):
        self.sent.append((bytes(key), dict(values), int(expires_at)))
        for peer in self.peers:
            peer._on_remote_update(key, dict(values), expires_at)

    def stop(self):
        pass


U = "descriptors[0].u"
SPECS = {
    "win": dict(namespace="w", max_value=8, seconds=60, variables=[U]),
    "total": dict(namespace="w", max_value=300, seconds=3600),
    "tb": dict(namespace="tb", max_value=6, seconds=60, variables=[U],
               policy="token_bucket"),
    "fast": dict(namespace="tb", max_value=5000, seconds=1, variables=[U],
                 policy="token_bucket"),
    "big": dict(namespace="big", max_value=3 << 30, seconds=60,
                variables=[U]),
    "late": dict(namespace="late", max_value=5, seconds=60, variables=[U]),
}
EARLY = ("win", "total", "tb", "fast", "big")


class Side:
    """One package's two replicated nodes, limiters and limits."""

    def __init__(self, pkg, make_storage, counter_cls, request_cls, key_fn,
                 clock, capacity, cache_size):
        self.pkg = pkg
        self.counter_cls = counter_cls
        self.request_cls = request_cls
        self.key_fn = key_fn
        self.nodes = [make_storage(name, capacity=capacity,
                                   cache_size=cache_size, clock=clock)
                      for name in "AB"]
        self.limiters = [pkg.RateLimiter(n) for n in self.nodes]
        self.limits = {name: pkg.Limit(name=name, **spec)
                       for name, spec in SPECS.items()}
        for name in EARLY:
            self.add_limit(name)
        self.nodes[0].broker = Loopback([self.nodes[1]])
        self.nodes[1].broker = Loopback([self.nodes[0]])

    def add_limit(self, name):
        for limiter in self.limiters:
            limiter.add_limit(self.limits[name])

    def counter(self, name, user):
        limit = self.limits[name]
        return self.counter_cls(limit, {U: user} if limit.variables else {})

    def close(self):
        for node in self.nodes:
            node.close()


def _sides(capacity, cache_size):
    jclock, tclock = FakeClock(), FakeClock()
    jside = Side(
        J, lambda name, **kw: JR.TpuReplicatedStorage(name, **kw),
        JCounter, JRequest, j_key, jclock, capacity, cache_size)
    tside = Side(
        T, lambda name, **kw: TorchReplicatedStorage(name, device="cpu",
                                                     **kw),
        TCounter, TRequest, t_key, tclock, capacity, cache_size)
    return (jclock, jside), (tclock, tside)


def _auth(a):
    return (a.limited, a.limit_name)


def _loaded(counters):
    return [(c.limit.name, dict(c.set_variables), c.remaining, c.expires_in)
            for c in counters]


def _view(counters):
    return sorted(
        (c.limit.name, tuple(sorted(c.set_variables.items())), c.remaining,
         c.expires_in)
        for c in counters
    )


def _assert_nodes_equal(jside, tside, where):
    for jn, tn, jl, tl in zip(jside.nodes, tside.nodes, jside.limiters,
                              tside.limiters):
        for ns in ("w", "tb", "big", "late"):
            assert _view(jl.get_counters(ns)) == _view(tl.get_counters(ns)), \
                (where, jn.node_id, ns)
        assert jn._snapshot_for_peer() == tn._snapshot_for_peer(), where
        arrays = [("values", jn._state.values, tn._state.values),
                  ("expiry_ms", jn._state.expiry_ms, tn._state.expiry_ms),
                  ("hits", jn._state.hits, tn._state.hits),
                  ("remote_vals", jn._remote_vals, tn._remote_vals),
                  ("remote_exp", jn._remote_exp, tn._remote_exp)]
        for name, j, t in arrays:
            np.testing.assert_array_equal(
                np.asarray(j), t.numpy(), err_msg=f"{where} {name}")
        assert jn._epoch == tn._epoch


def _script(seed, steps=260):
    """The op script: a list of (op, args) built from one rng, in terms of
    limit names and user strings only."""
    rng = random.Random(seed)
    users = [f"u{i}" for i in range(14)]
    ops = []
    for step in range(steps):
        if step == 90:
            ops.append(("add_limit", "late"))
        if step == 180:
            ops.append(("advance", 13 * 86400.0))  # the epoch rebases
        r = rng.random()
        node = rng.randrange(2)
        if r < 0.45:
            reqs = []
            for _ in range(rng.randint(1, 10)):
                ns = rng.choice(["w", "w", "tb", "big", "late"])
                names = {"w": ["win", "total"], "tb": ["tb", "fast"],
                         "big": ["big"], "late": ["late"]}[ns]
                if ns == "tb" and rng.random() < 0.5:
                    names = ["tb"]
                reqs.append((names, rng.choice(users), rng.randint(0, 3),
                             rng.random() < 0.5))
            ops.append(("check", node, reqs))
        elif r < 0.53:
            ops.append(("update", node, rng.choice(
                ["win", "tb", "big", "fast", "total"]),
                rng.choice(users), rng.randint(0, 4)))
        elif r < 0.60:
            ops.append(("apply", node, [
                (rng.choice(["win", "tb", "big", "total"]),
                 rng.choice(users), rng.randint(0, 3))
                for _ in range(rng.randint(1, 5))]))
        elif r < 0.66:
            ops.append(("within", node, rng.choice(
                ["win", "tb", "big", "late", "fast"]), rng.choice(users),
                rng.randint(0, 9)))
        elif r < 0.80:
            name = rng.choice(["win", "tb", "big", "late", "late", "fast"])
            # a peer's count; beyond-cap limits get counts near their max
            count = rng.randint(0, 30) if name != "big" else \
                (3 << 30) - rng.randint(0, 40)
            ops.append(("inject", node, name, rng.choice(users), count,
                        rng.randint(-2000, 90_000)))
        elif r < 0.92:
            ops.append(("publish", node))
        else:
            ops.append(("advance", rng.choice([0.001, 0.25, 1.0, 7.0, 61.0])))
    return ops


def _run(side, clock, op):
    kind = op[0]
    if kind == "add_limit":
        side.add_limit(op[1])
        return None
    if kind == "advance":
        clock.now += op[1]
        return None
    node = side.nodes[op[1]]
    if kind == "check":
        requests = [side.request_cls([side.counter(n, user) for n in names],
                                     delta, load)
                    for names, user, delta, load in op[2]]
        auths = node.check_many(requests)
        return ([_auth(a) for a in auths],
                [_loaded(r.ordered) if r.load else None for r in requests])
    if kind == "update":
        node.update_counter(side.counter(op[2], op[3]), op[4])
        return None
    if kind == "apply":
        return node.apply_deltas([(side.counter(n, u), d)
                                  for n, u, d in op[2]])
    if kind == "within":
        return node.is_within_limits(side.counter(op[2], op[3]), op[4])
    if kind == "inject":
        _kind, _node, name, user, count, ahead_ms = op
        counter = side.counter(name, user)
        now_abs = int(clock.now * 1000)
        limit = side.limits[name]
        if limit.policy == "token_bucket":
            tat = now_abs + ahead_ms // 20
            node._on_remote_update(side.key_fn(counter), {"Z": tat}, tat)
        else:
            node._on_remote_update(side.key_fn(counter), {"Z": count},
                                   now_abs + ahead_ms)
        return None
    if kind == "publish":
        node._publish_touched()
        return None
    raise AssertionError(kind)


@pytest.mark.parametrize("capacity,cache_size", [(64, 20), (1024, None)],
                         ids=["recycling", "roomy"])
@pytest.mark.parametrize("seed", [1, 2])
def test_replicated_storage_matches_jax(seed, capacity, cache_size):
    (jclock, jside), (tclock, tside) = _sides(capacity, cache_size)
    try:
        rebased = False
        for i, op in enumerate(_script(seed)):
            epoch = tside.nodes[0]._epoch
            assert _run(jside, jclock, op) == _run(tside, tclock, op), (i, op)
            rebased = rebased or tside.nodes[0]._epoch != epoch
            if i % 40 == 39:
                _assert_nodes_equal(jside, tside, i)
        for node in (0, 1):
            _run(jside, jclock, ("publish", node))
            _run(tside, tclock, ("publish", node))
        _assert_nodes_equal(jside, tside, "end")
        for jn, tn in zip(jside.nodes, tside.nodes):
            assert jn.broker.sent == tn.broker.sent
        assert rebased
        # the script reached what it is meant to exercise
        t0, t1 = tside.nodes
        assert any(n.broker.sent for n in (t0, t1))
        assert not t0._parked_wires and not t1._parked_wires
    finally:
        jside.close()
        tside.close()


def test_parked_wire_keys_are_adopted_once_the_limit_exists():
    (jclock, jside), (tclock, tside) = _sides(256, None)
    try:
        for side, clock in ((jside, jclock), (tside, tclock)):
            _run(side, clock, ("inject", 0, "late", "p", 3, 60_000))
        assert tside.nodes[0]._parked_wires == {
            t_key(tside.counter("late", "p"))}
        for side, clock in ((jside, jclock), (tside, tclock)):
            _run(side, clock, ("add_limit", "late"))
        ops = [("check", 0, [(["late"], "p", 1, True)])] * 3
        got = [[_run(side, clock, op) for op in ops]
               for side, clock in ((jside, jclock), (tside, tclock))]
        assert got[0] == got[1]
        assert [a for (auths, _l) in got[1] for a in auths] == [
            (False, None), (False, None), (True, "late")]
        _assert_nodes_equal(jside, tside, "adopted")
    finally:
        jside.close()
        tside.close()


def _resident(n, delta=2):
    """A check batch of n one-hit requests on "win", users r0..: n
    qualified counters with written cells (their slots recycle later)."""
    return ("check", 0, [(["win"], f"r{i}", delta, False) for i in range(n)])


def _injects(users, count=3):
    return [("inject", 0, "win", u, count, 30_000) for u in users]


# Gossip merges that adopt counters into recycled slots of a full table
# (cache_size 6), each adoption's clear staged on the port node; then the
# accesses that must see the clears. "within": is_within_limits re-adopts
# an evicted key and reads its cell at once (0 + 3 remote + 5 <= 8 only
# on a cleared cell). "merge_then_check": a check batch on adopted
# counters, not fresh (0 + 3 + 4 <= 8 only on a cleared cell).
# "recycled_while_staged": staged slots recycled before any access, by
# further adoptions and by a check batch's fresh allocation.
ADOPTION_CASES = {
    "within": [_resident(6)] + _injects([f"g{i}" for i in range(8)])
    + [("within", 0, "win", "g0", 5)],
    "merge_then_check": [_resident(6)]
    + _injects([f"g{i}" for i in range(6)])
    + [("check", 0, [(["win"], "g0", 4, True), (["win"], "g1", 4, True)])],
    "recycled_while_staged": [_resident(6)]
    + _injects([f"g{i}" for i in range(8)])
    + [("check", 0, [(["win"], "g7", 1, True), (["win"], "n0", 1, True),
                     (["win"], "n1", 5, True)])],
}


@pytest.mark.parametrize("case", sorted(ADOPTION_CASES))
def test_adopted_clears_are_staged_and_flushed_once(case):
    """The port node stages the clears of a merge's adoptions and
    launches them as one B3b host-form call at the next access of its
    table (a context emulating the C entry points records the calls);
    answers, merged views, gossip and all five arrays equal the JAX
    node's, which clears each adopted slot at once."""
    (jclock, jside), (tclock, tside) = _sides(64, 6)
    try:
        node = tside.nodes[0]
        spy = SpyContext(node._state)
        node._ctx = spy
        ops = ADOPTION_CASES[case]
        for op in ops[:-1]:
            assert _run(jside, jclock, op) == _run(tside, tclock, op), op
        staged = len(node._staged_clears)
        assert staged and not [c for c in spy.calls if c[0] == "clear"]
        spy.calls.clear()
        got = [_run(side, clock, ops[-1])
               for side, clock in ((jside, jclock), (tside, tclock))]
        assert got[0] == got[1]
        # the one clear came first, with every staged slot
        assert spy.calls[0] == ("clear", staged)
        assert [c for c in spy.calls if c[0] == "clear"] == [spy.calls[0]]
        assert not node._staged_clears
        if case == "within":
            assert got[1] is True and spy.calls[1:] == [("read", 1)]
        else:
            auths, _loaded_ = got[1]
            assert auths[:2] == [(False, None), (False, None)]
        for n in (0, 1):
            _run(jside, jclock, ("publish", n))
            _run(tside, tclock, ("publish", n))
        _assert_nodes_equal(jside, tside, case)
        for jn, tn in zip(jside.nodes, tside.nodes):
            assert jn.broker.sent == tn.broker.sent
    finally:
        jside.close()
        tside.close()


@pytest.mark.parametrize("seed", [3, 4])
def test_gossip_heavy_script_with_staged_clears_matches_jax(seed):
    """The JAX-versus-port script with most steps peer updates into a
    small, full table (cache_size 8), so most merges adopt into recycled
    slots and their clears stay staged across several merges before a
    check, an update, a read or a publish flushes them."""
    (jclock, jside), (tclock, tside) = _sides(64, 8)
    rng = random.Random(seed)
    try:
        flushed = 0
        for i, op in enumerate(_script(seed, steps=200)):
            if op[0] in ("check", "update", "apply", "within", "publish") \
                    and rng.random() < 0.6:
                # most accesses become further merges first
                node = op[1] if len(op) > 1 else 0
                for u in range(rng.randint(1, 6)):
                    extra = ("inject", node, "win", f"x{rng.randrange(30)}",
                             rng.randint(0, 5), rng.randint(-500, 20_000))
                    _run(jside, jclock, extra)
                    _run(tside, tclock, extra)
            flushed += bool(tside.nodes[0]._staged_clears)
            assert _run(jside, jclock, op) == _run(tside, tclock, op), (i, op)
            if i % 50 == 49:
                _assert_nodes_equal(jside, tside, i)
        _assert_nodes_equal(jside, tside, "end")
        assert flushed  # clears were staged across steps
    finally:
        jside.close()
        tside.close()


# -- the port alone: the JAX package's replication behaviours ----------------


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def eventually(cond, timeout=10.0, tick=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return False


TB = dict(conditions=[], variables=["u"], policy="token_bucket")


def _node(name, listen=None, peers=(), **kw):
    return TorchReplicatedStorage(
        name, listen_address=listen, peers=list(peers), capacity=256,
        gossip_period=kw.pop("gossip_period", 0.02), device="cpu", **kw)


@pytest.mark.parametrize("policy", ["window", "bucket", "big"])
def test_two_nodes_converge_over_brokers(policy):
    p0, p1 = free_port(), free_port()
    a = _node("A", f"127.0.0.1:{p0}", [f"127.0.0.1:{p1}"])
    b = _node("B", f"127.0.0.1:{p1}", [f"127.0.0.1:{p0}"])
    try:
        if policy == "window":
            limit = T.Limit("ns", 3, 60, ["m == 'GET'"], ["u"])
        elif policy == "bucket":
            limit = T.Limit("ns", 3, 600, **TB)  # I = 200 s: no refill
        else:
            limit = T.Limit("ns", (1 << 40) + 3, 60, [], ["u"])
        la, lb = T.RateLimiter(a), T.RateLimiter(b)
        la.add_limit(limit)
        lb.add_limit(limit)
        ctx = T.Context({"m": "GET", "u": "app"})
        if policy == "big":
            la.update_counters("ns", ctx, 1 << 40)
        # alternate hits across the nodes; each sees the other's spend
        for i in range(3):
            lim, other = ((la, lb), (lb, la))[i % 2]
            assert not lim.check_rate_limited_and_update(
                "ns", ctx, 1).limited, i
            assert eventually(lambda: other.is_rate_limited(
                "ns", ctx, 3 - i).limited), i
        assert eventually(lambda: la.is_rate_limited("ns", ctx, 1).limited)
        assert eventually(lambda: lb.is_rate_limited("ns", ctx, 1).limited)
        assert eventually(lambda: {c.remaining for c in la.get_counters(
            "ns")} == {0} and {c.remaining for c in lb.get_counters("ns")}
            == {0})
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("policy", ["window", "bucket", "big"])
def test_late_joiner_resyncs(policy):
    p0, p1 = free_port(), free_port()
    a = _node("A", f"127.0.0.1:{p0}", gossip_period=0.03)
    try:
        if policy == "window":
            limit, spend, left = T.Limit("ns", 10, 60, [], ["u"]), 7, 3
        elif policy == "bucket":
            limit, spend, left = T.Limit("ns", 5, 600, **TB), 4, 1
        else:
            limit, spend, left = T.Limit("ns", 1 << 40, 60, [], ["u"]), \
                (1 << 40) - 5, 5
        la = T.RateLimiter(a)
        la.add_limit(limit)
        ctx = T.Context({"u": "x"})
        if policy == "bucket":
            for _ in range(spend):
                la.check_rate_limited_and_update("ns", ctx, 1)
        else:
            la.update_counters("ns", ctx, spend)
        b = _node("B", f"127.0.0.1:{p1}", [f"127.0.0.1:{p0}"],
                  gossip_period=0.03)
        try:
            lb = T.RateLimiter(b)
            lb.add_limit(limit)
            assert eventually(
                lambda: not lb.is_rate_limited("ns", ctx, left).limited
                and lb.is_rate_limited("ns", ctx, left + 1).limited
            ), "the late joiner never absorbed A's counts"
        finally:
            b.close()
    finally:
        a.close()


def test_local_exactness_on_a_remote_base():
    clock = FakeClock()
    node = _node("me", clock=clock)
    try:
        limiter = T.RateLimiter(node)
        limit = T.Limit("ns", 5, 60, [], ["u"])
        limiter.add_limit(limit)
        key = t_key(TCounter(limit, {"u": "k"}))
        node._on_remote_update(key, {"peer": 3},
                               int(clock.now * 1000) + 60_000)
        ctx = T.Context({"u": "k"})
        outs = [limiter.check_rate_limited_and_update("ns", ctx, 1).limited
                for _ in range(3)]
        assert outs == [False, False, True]  # 5 - 3 remote
    finally:
        node.close()


def test_remote_actor_window_reset_and_pruning():
    clock = FakeClock()
    node = _node("me", clock=clock)
    try:
        limiter = T.RateLimiter(node)
        limit = T.Limit("ns", 10, 60, [], ["u"])
        limiter.add_limit(limit)
        key = t_key(TCounter(limit, {"u": "x"}))
        node._on_remote_update(key, {"peer": 100},
                               int(clock.now * 1000 + 60_000))
        assert node._remote_actors[key]["peer"][0] == 100
        clock.now += 61  # the window rolls: a fresh small count resets
        node._on_remote_update(key, {"peer": 1},
                               int(clock.now * 1000 + 60_000))
        assert node._remote_actors[key]["peer"][0] == 1
        ctx = T.Context({"u": "x"})
        outs = [limiter.check_rate_limited_and_update("ns", ctx, 1).limited
                for _ in range(10)]
        assert outs == [False] * 9 + [True]
        for i in range(20):
            node._on_remote_update(t_key(TCounter(limit, {"u": str(i)})),
                                   {"peer": 1},
                                   int(clock.now * 1000 + 60_000))
        assert len(node._remote_actors) == 21
        clock.now += 120
        node._prune_remote_actors()
        assert node._remote_actors == {}
    finally:
        node.close()


@pytest.mark.parametrize("path", ["update_counter", "apply_deltas"])
def test_report_path_folds_the_remote_tat_floor(path):
    clock = FakeClock()
    now_ms = int(clock.now * 1000)
    limit = T.Limit("tb", 5, 60, **TB)  # I = 12 s
    node = _node("me", clock=clock)
    try:
        limiter = T.RateLimiter(node)
        limiter.add_limit(limit)
        counter = TCounter(limit, {"u": "x"})
        tat = now_ms + 3 * 12_000  # a peer spent 3 of 5
        node._on_remote_update(t_key(counter), {"A": tat}, tat)
        launches = dict(TK.launches)
        if path == "update_counter":
            node.update_counter(counter, 1)
        else:
            node.apply_deltas([(counter, 1)])
        assert TK.launches == launches  # CPU: plain
        assert node._touched  # the Report-path write gossips
        ctx = T.Context({"u": "x"})
        outs = [limiter.check_rate_limited_and_update("tb", ctx, 1).limited
                for _ in range(2)]
        assert outs == [False, True]  # exactly 1 of 5 remained
        assert {c.remaining for c in limiter.get_counters("tb")} == {0}
    finally:
        node.close()


def test_snapshot_loads_into_a_replicated_node(tmp_path):
    path = str(tmp_path / "node.ckpt")
    a = _node("n1")
    try:
        limiter = T.RateLimiter(a)
        limiter.add_limit(T.Limit("ns", 10, 600, [], ["u"]))
        for _ in range(4):
            limiter.check_rate_limited_and_update("ns", T.Context(
                {"u": "snap"}), 1)
        a.snapshot(path)
    finally:
        a.close()
    b = _node("n1")
    try:
        b.load_snapshot(path)
        limiter = T.RateLimiter(b)
        limiter.add_limit(T.Limit("ns", 10, 600, [], ["u"]))
        assert {c.remaining for c in limiter.get_counters("ns")} == {6}
        assert not limiter.check_rate_limited_and_update(
            "ns", T.Context({"u": "snap"}), 6).limited
        assert limiter.check_rate_limited_and_update(
            "ns", T.Context({"u": "snap"}), 1).limited
    finally:
        b.close()
    c = TorchReplicatedStorage("n1", capacity=512, device="cpu")
    try:
        with pytest.raises(StorageError):
            c.load_snapshot(path)
    finally:
        c.close()


@pytest.mark.parametrize("flushed", [False, True],
                         ids=["queued", "scattered"])
def test_gossip_merged_before_a_snapshot_load_keeps_its_key(tmp_path,
                                                          flushed):
    """A peer's re-sync merges before the checkpoint loads and takes the
    slot that the checkpoint gives another counter. The loaded counter
    must not admit against the peer's share, and the peer's key must
    keep it, whether the share was still queued or already on the
    remote lanes."""
    clock = FakeClock()
    limit = T.Limit("ns", 10, 600, [], ["u"])
    path = str(tmp_path / "node.ckpt")
    a = _node("n1", clock=clock)
    try:
        limiter = T.RateLimiter(a)
        limiter.add_limit(limit)
        for _ in range(4):
            limiter.check_rate_limited_and_update(
                "ns", T.Context({"u": "snap"}), 1)
        a.snapshot(path)
        (snap_slot,) = a._table.info
    finally:
        a.close()
    b = _node("n1", clock=clock)
    try:
        limiter = T.RateLimiter(b)
        limiter.add_limit(limit)
        peer = TCounter(limit, {"u": "peer"})
        b._on_remote_update(t_key(peer), {"p": 7},
                            int(clock.now * 1000) + 60_000)
        assert b._slot_for(peer, create=False)[0] == snap_slot
        if flushed:
            with b._lock:
                b._flush_dirty_remote()
        b.load_snapshot(path)
        snap, other = T.Context({"u": "snap"}), T.Context({"u": "peer"})
        assert limiter.is_rate_limited("ns", other, 4).limited
        assert not limiter.is_rate_limited("ns", other, 3).limited
        assert not limiter.check_rate_limited_and_update(
            "ns", snap, 6).limited
        assert limiter.check_rate_limited_and_update("ns", snap, 1).limited
        assert sorted((c.set_variables["u"], c.remaining)
                      for c in limiter.get_counters("ns")) == [
            ("peer", 3), ("snap", 0)]
    finally:
        b.close()


def test_a_jax_checkpoint_is_refused_without_importing_it(tmp_path):
    path = str(tmp_path / "jax.ckpt")
    j = J.tpu.TpuStorage(capacity=256)
    limiter = J.RateLimiter(j)
    limiter.add_limit(J.Limit("ns", 3, 60, [], ["u"]))
    limiter.check_rate_limited_and_update("ns", J.Context({"u": "a"}), 1)
    j.snapshot(path)
    node = _node("n1")
    try:
        with pytest.raises(StorageError, match="not a class of this"):
            node.load_snapshot(path)
    finally:
        node.close()


def test_the_columnar_path_and_leases_are_refused():
    node = _node("n1")
    try:
        H = 8
        cols = (np.zeros(H, np.int32), np.ones(H, np.int32),
                np.full(H, 3, np.int32), np.full(H, 1000, np.int32),
                np.arange(H, dtype=np.int32), np.zeros(H, bool))
        launches = dict(TK.launches)
        with pytest.raises(StorageError, match="remote counts"):
            node.begin_check_columnar(*cols)
        with pytest.raises(StorageError, match="remote counts"):
            node.check_columnar(*cols)
        with pytest.raises(StorageError, match="leases"):
            node.credit_columnar(cols[0], cols[1], cols[3], cols[5])
        assert dict(TK.launches) == launches
        assert not node._state.values.any()
    finally:
        node.close()


@pytest.mark.parametrize("seed", range(3))
def test_randomized_gossip_convergence(seed):
    """Three nodes take random local traffic (both policies) while
    snapshots go between random pairs, duplicated and reordered; after a
    full exchange every view is the same and nothing is re-minted."""
    rng = random.Random(seed)
    clock = FakeClock()
    nodes = [_node(n, clock=clock) for n in "ABC"]
    limiters = [T.RateLimiter(s) for s in nodes]
    window = T.Limit("w", 40, 600, [], ["u"])
    bucket = T.Limit("tb", 30, 600, **TB)
    for lim in limiters:
        lim.add_limit(window)
        lim.add_limit(bucket)

    def deliver(src, dst):
        for key, values, expires_at in src._snapshot_for_peer():
            dst._on_remote_update(key, dict(values), expires_at)

    def view(lim, ns):
        return {tuple(sorted(c.set_variables.items())): c.remaining
                for c in lim.get_counters(ns)}

    try:
        admitted = 0
        for _step in range(120):
            node = rng.randrange(3)
            if rng.random() < 0.7:
                ns = "w" if rng.random() < 0.5 else "tb"
                ctx = T.Context({"u": rng.choice(["u1", "u2"])})
                if not limiters[node].check_rate_limited_and_update(
                        ns, ctx, 1).limited:
                    admitted += 1
            else:
                dst = rng.randrange(3)
                if dst != node:
                    deliver(nodes[node], nodes[dst])
                    if rng.random() < 0.3:
                        deliver(nodes[node], nodes[dst])
            if rng.random() < 0.1:
                clock.now += rng.random()
        pairs = [(i, j) for i in range(3) for j in range(3) if i != j]
        for _ in range(2):
            rng.shuffle(pairs)
            for i, j in pairs:
                deliver(nodes[i], nodes[j])
        for ns in ("w", "tb"):
            views = [view(lim, ns) for lim in limiters]
            assert views[0] == views[1] == views[2], (seed, ns, views)
        spent = sum(window.max_value - r
                    for r in view(limiters[0], "w").values()) + sum(
            bucket.max_value - r for r in view(limiters[0], "tb").values())
        assert spent <= admitted
    finally:
        for s in nodes:
            s.close()


# -- a mixed cluster: one JAX node, one port node ----------------------------


@pytest.mark.parametrize("policy", ["window", "bucket"])
def test_mixed_jax_and_port_nodes_converge(policy):
    pj, pt = free_port(), free_port()
    jnode = JR.TpuReplicatedStorage(
        "jax", f"127.0.0.1:{pj}", [f"127.0.0.1:{pt}"], capacity=256,
        gossip_period=0.02)
    tnode = _node("port", f"127.0.0.1:{pt}", [f"127.0.0.1:{pj}"])
    try:
        if policy == "window":
            spec = dict(namespace="ns", max_value=6, seconds=60,
                        variables=["u"])
        else:
            spec = dict(namespace="ns", max_value=6, seconds=600,
                        variables=["u"], policy="token_bucket")
        lj, lt = J.RateLimiter(jnode), T.RateLimiter(tnode)
        lj.add_limit(J.Limit(**spec))
        lt.add_limit(T.Limit(**spec))
        jctx, tctx = J.Context({"u": "m"}), T.Context({"u": "m"})
        # the JAX node spends 2, the port node sees them
        for _ in range(2):
            assert not lj.check_rate_limited_and_update("ns", jctx,
                                                        1).limited
        assert eventually(
            lambda: lt.is_rate_limited("ns", tctx, 5).limited
            and not lt.is_rate_limited("ns", tctx, 4).limited)
        # the port node spends 3, the JAX node sees 5 spent in all
        for _ in range(3):
            assert not lt.check_rate_limited_and_update("ns", tctx,
                                                        1).limited
        assert eventually(
            lambda: lj.is_rate_limited("ns", jctx, 2).limited
            and not lj.is_rate_limited("ns", jctx, 1).limited)
        assert eventually(lambda: {c.remaining for c in lj.get_counters(
            "ns")} == {1} and {c.remaining for c in lt.get_counters("ns")}
            == {1})
        assert not lt.check_rate_limited_and_update("ns", tctx, 1).limited
        assert lt.check_rate_limited_and_update("ns", tctx, 1).limited
        assert eventually(lambda: lj.is_rate_limited("ns", jctx, 1).limited)
    finally:
        jnode.close()
        tnode.close()


# -- B6c's and B3a's host forms on the remote lanes ----------------------------


@pytest.mark.parametrize("path", ["plain", "card"])
@pytest.mark.parametrize("n", [1, 8, 2666, 2667, 12288])
def test_apply_remote_host_form_matches_jax(n, path):
    """B6c from host rows, through a context over the remote lanes (hits
    aliasing the expiry lane), equals the jitted ``_apply_remote``: both
    lanes written at the unique slots, nothing else. On the card path
    (C emulated) the rows go in one call and one launch: in the
    parameter block up to one block's 2,666 rows, staged past it."""
    rng = np.random.default_rng(9300 + n)
    L = 1 << 15
    rv = rng.integers(0, 1000, L + 1).astype(np.int32)
    re = rng.integers(0, 1 << 31, L + 1).astype(np.int32)
    rows = remote_rows(rng, n, L)
    jrem = JR._apply_remote(jnp.asarray(rv), jnp.asarray(re), *rows)
    vals, exp = torch.from_numpy(rv.copy()), torch.from_numpy(re.copy())
    state = TK.CounterTableState(vals, exp, exp)
    ctx = TK.TableContext(state) if path == "plain" else SpyContext(state)
    before = dict(TK.launches)
    assert TK.apply_remote_host(ctx, *rows) is state
    if path == "plain":
        assert TK.launches == before
    else:
        assert ctx.calls == [("remote" if n <= 2666 else "staged", n)]
        assert TK.launches["apply_remote_host"] == \
            before["apply_remote_host"] + 1
    for j, t in zip(jrem, (vals, exp)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _flush_recorder(node, record, lanes_of):
    flush = node._flush_dirty_remote

    def recorded():
        rows = len(node._dirty_remote)
        flush()
        if rows:
            record.append((node.node_id, rows,
                           *(np.array(a, copy=True) for a in lanes_of(node))))
    node._flush_dirty_remote = recorded


def _lanes_of_port(node):
    return node._remote_vals.numpy(), node._remote_exp.numpy()


def _lanes_of_jax(node):
    return np.asarray(node._remote_vals), np.asarray(node._remote_exp)


@pytest.mark.parametrize("seed", [1, 2])
def test_three_nodes_keep_the_jax_remote_lanes_after_every_flush(seed):
    """Three port nodes and three JAX nodes, each trio joined by loopback
    gossip, take the same batches (windows and a bucket, recycled slots,
    an epoch rebase half way) with a gossip tick of every node after
    each batch, and every node's merged view now and then: the same
    answers and views, the same flushes in the same order with the same
    rows, and both remote lanes equal after every flush."""
    rng = np.random.default_rng(seed)
    packages = []
    for pkg, make, counter_cls, request_cls, lanes_of in (
            (J, lambda name, **kw: JR.TpuReplicatedStorage(name, **kw),
             JCounter, JRequest, _lanes_of_jax),
            (T, lambda name, **kw: TorchReplicatedStorage(
                name, device="cpu", **kw), TCounter, TRequest,
             _lanes_of_port)):
        clock = FakeClock()
        nodes = [make(name, capacity=96, cache_size=40, clock=clock)
                 for name in "abc"]
        limits = [pkg.Limit("w", 12, 60, [], ["u"], name="win"),
                  pkg.Limit("w", 5, 30, [], ["u"], name="tb",
                            policy="token_bucket")]
        record, limiters = [], []
        for i, node in enumerate(nodes):
            limiters.append(pkg.RateLimiter(node))
            for limit in limits:
                limiters[-1].add_limit(limit)
            node.broker = Loopback([n for j, n in enumerate(nodes) if j != i])
            _flush_recorder(node, record, lanes_of)
        packages.append((clock, nodes, limits, counter_cls, request_cls,
                         record, limiters))
    try:
        for b in range(24):
            users = rng.zipf(1.3, 48) % 70
            bucket = rng.random(48) < 0.3
            answers = []
            for clock, nodes, limits, counter_cls, request_cls, _r, lims \
                    in packages:
                node = nodes[b % 3]
                requests = [request_cls([counter_cls(limits[int(tb)],
                                                     {"u": f"u{u}"})],
                                        int(1 + u % 2), bool(u % 3 == 0))
                            for u, tb in zip(users.tolist(), bucket)]
                got = [(a.limited, a.limit_name)
                       for a in node.check_many(requests)]
                for n in nodes:
                    n._publish_touched()
                if b % 6 == 5:  # merged views: a flush, then remote reads
                    got.append([_view(lim.get_counters("w"))
                                for lim in lims])
                answers.append(got)
                clock.now += 13 * 86400.0 if b == 12 else 0.7
            assert answers[0] == answers[1], b
        jrec, trec = packages[0][5], packages[1][5]
        assert len(jrec) == len(trec) >= 24
        for i, (j, t) in enumerate(zip(jrec, trec)):
            assert j[:2] == t[:2], i
            for name, a, b in (("remote_vals", j[2], t[2]),
                               ("remote_exp", j[3], t[3])):
                np.testing.assert_array_equal(a, b, err_msg=f"{i} {name}")
        assert packages[1][1][0]._epoch != 1_700_000_000.0  # rebased
    finally:
        for pkg in packages:
            for node in pkg[1]:
                node.close()


def test_a_flush_and_a_remote_read_are_one_c_call_each():
    """Through a context that emulates the C entry points: a flush hands
    all its dirty rows to one call and one launch (staged past a block of
    3 rows here, by value within one), and a remote read hands its bare
    list (no padding row) to one call; the lanes and the answers are the
    plain versions'."""
    clock = FakeClock()
    node = _node("me", clock=clock)
    try:
        rng = np.random.default_rng(5)
        spy = SpyContext(node._remote_ctx.state, capacity=(8, 4, 3, 8, 3))
        node._remote_ctx = spy
        slots, sums, exps = remote_rows(rng, 10, 256)
        node._dirty_remote = {int(s): (int(v), int(e))
                              for s, v, e in zip(slots, sums, exps)}
        want_v, want_e = (a.numpy().copy() for a in node._remote_lanes)
        want_v[slots], want_e[slots] = sums, exps
        before = TK.launches["apply_remote_host"]
        with node._lock:
            node._flush_dirty_remote()
            node._flush_dirty_remote()  # nothing dirty: no call
        node._dirty_remote = {int(slots[0]): (1, 2)}
        with node._lock:
            node._flush_dirty_remote()
        want_v[slots[0]], want_e[slots[0]] = 1, 2
        assert spy.calls == [("staged", 10), ("remote", 1)]
        assert TK.launches["apply_remote_host"] == before + 2
        np.testing.assert_array_equal(node._remote_vals.numpy(), want_v)
        np.testing.assert_array_equal(node._remote_exp.numpy(), want_e)
        now_ms = node._now_ms()
        before = TK.launches["read_slots_host"]
        with node._lock:
            got = node._read_remote(slots[:5], now_ms)
        assert spy.calls[-1] == ("read", 5)
        assert TK.launches["read_slots_host"] == before + 1
        live = want_e[slots[:5]] > now_ms
        np.testing.assert_array_equal(got[0],
                                      np.where(live, want_v[slots[:5]], 0))
    finally:
        node.close()


def test_the_remote_lanes_bind_a_context_and_close_it():
    """The remote lanes live in a launch context of their own, the hits
    column aliasing the expiry lane; assigning new lanes binds a new
    context and closes the old one; ``close`` closes the last."""
    node = _node("me")
    ctx = node._remote_ctx
    assert ctx.state.values is node._remote_vals
    assert ctx.state.expiry_ms is node._remote_exp
    assert ctx.state.hits is node._remote_exp
    spy = SpyContext(ctx.state)
    node._remote_ctx = spy
    lanes_ = (torch.ones(257, dtype=torch.int32),
              torch.full((257,), 7, dtype=torch.int32))
    node._remote_lanes = lanes_
    assert spy.handle is None
    assert node._remote_vals is lanes_[0] and node._remote_exp is lanes_[1]
    assert node._remote_ctx.state.hits is lanes_[1]
    last = SpyContext(node._remote_ctx.state)
    node._remote_ctx = last
    node.close()
    assert last.handle is None


def test_an_epoch_rebase_leaves_the_remote_context_bound():
    """The epoch rebase shifts the remote expiry lane in place (B4a), so
    the context keeps its lanes: a gossiped share read back after the
    rebase equals the JAX node's."""
    answers = []
    for make, pkg, counter_cls in (
            (lambda clock: JR.TpuReplicatedStorage("me", capacity=64,
                                                   clock=clock), J,
             JCounter),
            (lambda clock: TorchReplicatedStorage("me", capacity=64,
                                                  clock=clock,
                                                  device="cpu"), T,
             TCounter)):
        clock = FakeClock()
        node = make(clock)
        limit = pkg.Limit("ns", 10, 60, [], ["u"])
        limiter = pkg.RateLimiter(node)
        limiter.add_limit(limit)
        counter = counter_cls(limit, {"u": "x"})
        ctx = getattr(node, "_remote_ctx", None)
        ptrs = None if ctx is None else (node._remote_vals.data_ptr(),
                                         node._remote_exp.data_ptr())
        node._on_remote_update(j_key(counter) if pkg is J else t_key(counter),
                               {"peer": 4}, int(clock.now * 1000) + 30_000)
        first = node.is_within_limits(counter, 6)
        epoch = node._epoch
        clock.now += 13 * 86400.0
        node._on_remote_update(j_key(counter) if pkg is J else t_key(counter),
                               {"peer": 3}, int(clock.now * 1000) + 20_000)
        second = [node.is_within_limits(counter, d) for d in (7, 8)]
        assert node._epoch != epoch
        if ctx is not None:
            assert node._remote_ctx is ctx
            assert ptrs == (node._remote_vals.data_ptr(),
                            node._remote_exp.data_ptr())
            lanes_ = [a.numpy().copy() for a in node._remote_lanes]
        else:
            lanes_ = [np.asarray(a) for a in (node._remote_vals,
                                               node._remote_exp)]
        answers.append((first, second, lanes_))
        node.close()
    assert answers[0][:2] == answers[1][:2] == (True, [True, False])
    for j, t in zip(answers[0][2], answers[1][2]):
        np.testing.assert_array_equal(j, t)



# -- B6b's host form and the Report path --------------------------------------

#: entries one B6b launch carries on the card (nvcc 12.1 or later)
UPDATE_CAPACITY = 2000


def _report_list(rng, count, slot_lanes):
    """A B6b host list over a single table of C + 1 cells: B7c's list
    generator on one row (Zipf slots, slot 0 a quarter of the time, so
    repeated cells; 3% of bucket flags flipped, so cells mixing buckets
    and windows; 10% fresh; deltas at and past the caps), entries
    capacity - 1 and capacity one cell, not fresh and then fresh."""
    return update_entries(rng, count, 1, C, 1, slot_lanes,
                          straddle=min(count - 1, UPDATE_CAPACITY))


def _jax_update(jstate, remote_exp, entries, now_ms):
    """The jitted ``_replicated_update`` on the list's padded columns."""
    cols = [c[0] for c in padded_update_columns(entries, 1, C)]
    return JR._replicated_update(jstate, jnp.asarray(remote_exp), *cols,
                                 np.int32(now_ms))


@pytest.mark.parametrize("path", ["plain", "card"])
@pytest.mark.parametrize("count", [1, 2, 8, UPDATE_CAPACITY,
                                   UPDATE_CAPACITY + 1])
def test_replicated_update_host_form_matches_jax(count, path):
    """B6b from a host list equals the jitted ``_replicated_update`` on
    the list's padded columns, three rounds over one table whose remote
    lanes hold bucket TATs ahead of and behind now and live and expired
    window expiries: through a CPU context (the plain twin, no launch)
    and through contexts that emulate the C entry point (one call with
    the list as bytes and both handles, one launch counted under the
    host form's key, never the device-tensor wrapper's)."""
    rng = np.random.default_rng(9500 + count)
    now_ms = 5_000_000
    slot_lanes = lanes(rng, C)
    values, expiry, hits = table(rng, now_ms, slot_lanes)
    _rv, re = remote_lanes(rng, now_ms, slot_lanes, values)
    jstate, tstate = _states(values, expiry, hits)
    rem = TK.CounterTableState(*(torch.from_numpy(a.copy())
                                 for a in (_rv, re, re)))
    if path == "plain":
        ctx, rctx = TK.TableContext(tstate), TK.TableContext(rem)
    else:
        ctx, rctx = SpyContext(tstate), SpyContext(rem)
    for _round in range(3):
        entries = _report_list(rng, count, slot_lanes)
        if count >= UPDATE_CAPACITY and _round == 0:  # every case
            slots, bucket = entries[:, 1], entries[:, 4] & 2 > 0
            floor = re[slots]
            assert (bucket & (floor > now_ms)).any()
            assert (bucket & (floor > 0) & (floor <= now_ms)).any()
            assert (bucket & (entries[:, 4] & 1 > 0) & (floor > now_ms)).any()
            assert (~bucket & (floor > now_ms)).any()
            assert np.intersect1d(slots[bucket], slots[~bucket]).size
        jstate = _jax_update(jstate, re, entries, now_ms)
        before = dict(TK.launches)
        assert TK.replicated_update_host(ctx, rctx, entries, now_ms) \
            is ctx.state
        moved = {key: TK.launches[key] - before[key] for key in before
                 if TK.launches[key] != before[key]}
        assert moved == ({} if path == "plain"
                         else {"replicated_update_host": 1})
        _same_table(jstate, ctx.state)
        now_ms += int(rng.choice([0, 500, 61_000]))
    if path == "card":
        assert ctx.calls == [("replicated_update", count)] * 3
    np.testing.assert_array_equal(rem.expiry_ms.numpy(), re)


def test_replicated_update_host_form_hand_cells():
    """Hand cells through the host form's twin and the JAX program: a
    bucket whose remote TAT is ahead of its own and of now (it advances
    from the floor), one whose floor is behind now (from max(own, now)),
    a fresh bucket with a floor ahead (its own TAT dropped, the floor
    kept), a window cell with a remote expiry set (never floored), a
    cell of a window entry then a fresh bucket entry (the last entry's
    bucket flag takes the floor) and one of a bucket then a window entry
    (no floor), deltas summing past MAX_VALUE_CAP, and a bucket whose
    floor sits near the int32 horizon (the advance clamps). An empty
    list changes nothing."""
    now_ms = 2_000_000
    I = 1000
    values = np.zeros(C + 1, np.int32)
    expiry = np.zeros(C + 1, np.int32)
    hits = np.full(C + 1, 3, np.int32)
    re = np.zeros(C + 1, np.int32)
    hits[C] = 0
    cells = {  # slot: (own TAT or window end, remote_exp)
        10: (now_ms + 2 * I, now_ms + 5 * I),  # floor ahead of own
        11: (now_ms + 3 * I, now_ms - 4 * I),  # floor behind now
        12: (now_ms + 6 * I, now_ms + 2 * I),  # fresh: own dropped
        13: (now_ms + 60_000, now_ms + 90_000),  # window
        14: (now_ms + 1 * I, now_ms + 7 * I),  # window then fresh bucket
        15: (now_ms + 1 * I, now_ms + 7 * I),  # bucket then window
        16: (now_ms + 60_000, 0),  # deltas past the cap
        17: (now_ms, NEVER - 10),  # floor at the horizon
    }
    for slot, (own, remote) in cells.items():
        expiry[slot], re[slot] = own, remote
    values[13], values[16] = 5, 7
    entries = np.asarray([
        [0, 10, 2, I, 2],
        [0, 11, 1, I, 2],
        [0, 12, 1, I, 3],
        [0, 13, 4, 60_000, 0],
        [0, 14, 1, 60_000, 0],
        [0, 14, 2, I, 3],
        [0, 15, 1, I, 2],
        [0, 15, 2, 60_000, 0],
        [0, 16, (1 << 30) - 1, 60_000, 0],
        [0, 16, NEVER, 60_000, 0],
        [0, 17, 5, I, 2],
    ], np.int32)
    jstate, tstate = _states(values, expiry, hits)
    jstate = _jax_update(jstate, re, entries, now_ms)
    rem = TK.CounterTableState(*(torch.from_numpy(a) for a in (
        np.zeros_like(re), re, re)))
    TK.replicated_update_host(TK.TableContext(tstate),
                              TK.TableContext(rem), entries, now_ms)
    _same_table(jstate, tstate)
    exp = tstate.expiry_ms
    assert int(exp[10]) == now_ms + 7 * I  # the floor, then 2 tokens
    assert int(exp[11]) == now_ms + 4 * I  # own TAT, then 1 token
    assert int(exp[12]) == now_ms + 3 * I  # the floor, not its own TAT
    assert int(exp[13]) == now_ms + 60_000  # a live window keeps its end
    assert int(tstate.values[13]) == 9
    assert int(exp[14]) == now_ms + 10 * I  # fresh: the floor, 3 tokens
    # a live window at its last entry: its end kept, no floor
    assert int(exp[15]) == now_ms + I and int(tstate.values[15]) == 3
    assert int(tstate.values[16]) == 1 << 30  # saturated at the cap
    assert int(exp[17]) > NEVER - 10 - I  # clamped below the horizon
    assert [int(tstate.hits[s]) for s in (12, 14)] == [1, 2]  # fresh
    before = [t.clone() for t in tstate]
    TK.replicated_update_host(TK.TableContext(tstate), TK.TableContext(rem),
                              np.zeros((0, 5), np.int32), now_ms)
    for t, b in zip(tstate, before):
        assert torch.equal(t, b)


@pytest.mark.parametrize("bad", [[0, C, 1, 1000, 0], [1, 3, 1, 1000, 0],
                                 [0, -1, 1, 1000, 0]])
def test_replicated_update_host_form_refuses_cells_past_the_table(bad):
    """The host form has no padding: an entry of the scratch slot, of a
    negative slot or of a row other than 0 raises; a list of the wrong
    shape or type too; the table is left as it was."""
    state = TK.make_table(C, "cpu")
    ctx = TK.TableContext(state)
    rctx = TK.TableContext(TK.make_table(C, "cpu"))
    with pytest.raises(ValueError):
        TK.replicated_update_host(ctx, rctx, np.asarray([bad], np.int32), 0)
    for wrong in (np.zeros((2, 4), np.int32), np.zeros((2, 5), np.int64)):
        with pytest.raises(ValueError):
            TK.replicated_update_host(ctx, rctx, wrong, 0)
    assert not any(t.any() for t in state)


@pytest.mark.parametrize("seed", [3])
def test_replicated_storage_through_the_host_forms_matches_jax(seed):
    """The JAX nodes' op script (checks, Reports through
    ``update_counter`` and ``apply_deltas``, gossip, an epoch rebase)
    with each port node's table and remote lanes behind contexts that
    emulate the C entry points: the same answers, views and arrays as
    the JAX nodes', and every Report one B6b host-form call carrying
    its device counters alone (no padding), counted under
    ``replicated_update_host`` and never under ``replicated_update``."""
    (jclock, jside), (tclock, tside) = _sides(64, 20)
    spies = []
    for node in tside.nodes:
        node._ctx = SpyContext(node._ctx.state)
        node._remote_ctx = SpyContext(node._remote_ctx.state)
        spies.append(node._ctx)
    try:
        before = dict(TK.launches)
        reports = 0
        for i, op in enumerate(_script(seed)):
            assert _run(jside, jclock, op) == _run(tside, tclock, op), (i, op)
            if op[0] in ("update", "apply"):
                reports += 1
            if i % 40 == 39:
                _assert_nodes_equal(jside, tside, i)
        _assert_nodes_equal(jside, tside, "end")
        calls = [c for spy in spies for c in spy.calls
                 if c[0] == "replicated_update"]
        assert 0 < len(calls) <= reports
        assert all(0 < n <= 5 for _name, n in calls)
        assert TK.launches["replicated_update_host"] == \
            before["replicated_update_host"] + len(calls)
        assert TK.launches["replicated_update"] == \
            before["replicated_update"]
    finally:
        jside.close()
        tside.close()
