"""The port's sharded table against the JAX package's, on the CPU.

Kernel level: the four B7 programs of ``limitador_tpu/parallel/mesh.py``
run on the 8 virtual CPU devices that ``tests/conftest.py`` sets up, as
the JAX package's own tests run them, and the port's wrappers run their
plain versions over an int32[8, L+1] table on CPU tensors. Every output
is an integer array, so the tolerance is exact equality: every output
and all three [8, L+1] arrays.

Storage level: every case of ``tests/test_sharded_storage.py`` (and the
sharded cases of ``test_token_bucket.py`` and ``test_big_limits.py``,
and the behaviour matrix's ``sharded`` backend) runs through
``TpuShardedStorage`` and ``TorchShardedStorage(device="cpu")``; the
answers, ``get_counters``, ``launch_stats`` and the three arrays must be
equal.
"""

import asyncio
import random
import time

import jax
import numpy as np
import pytest
import torch

from limitador_tpu import Context as JContext
from limitador_tpu import Limit as JLimit
from limitador_tpu import RateLimiter as JRateLimiter
from limitador_tpu.core.counter import Counter as JCounter
from limitador_tpu.parallel import mesh as JM
from limitador_tpu.tpu.sharded import TpuShardedStorage
from limitador_tpu.tpu.storage import _Request as JRequest
from limitador_tpu_torch import Context, Limit, RateLimiter
from limitador_tpu_torch.core.counter import Counter
from limitador_tpu_torch.device.sharded import TorchShardedStorage
from limitador_tpu_torch.device.storage import _Request
from limitador_tpu_torch.ops import kernel as TK
from limitador_tpu_torch.parallel import mesh as TM

from .torch_batches import (
    NEVER,
    SpyContext,
    divergent_lean_batch,
    fake_card,
    hits_column,
    padded_update_columns,
    sharded_batch,
    sharded_lanes,
    sharded_table,
    update_entries,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8 virtual CPU devices"
)

N = 8
L = 512
G = 16


def _mesh():
    return JM.make_mesh()


def _jax_state(mesh, table):
    sharding = JM.batch_sharding(mesh)
    return JM.ShardedCounterState(*(
        jax.device_put(np.asarray(a), sharding) for a in table
    ))


def _torch_state(table):
    return TM.ShardedCounterState(*(
        torch.from_numpy(np.array(a, np.int32)) for a in table
    ))


def _assert_tables(jstate, tstate):
    for name, j, t in zip(TM.ShardedCounterState._fields, jstate, tstate):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


def _both_check(mesh, jstate, tstate, cols, now_ms, coupled, has_global,
                global_region=G):
    jstate, jres = JM.sharded_check_and_update(
        mesh, jstate, *cols, np.int32(now_ms), global_region=global_region,
        coupled=coupled, has_global=has_global,
    )
    tstate, tres = TM.sharded_check_and_update(
        tstate, *(torch.from_numpy(c) for c in cols), now_ms,
        global_region=global_region, coupled=coupled, has_global=has_global,
    )
    for name, j, t in zip(TM.ShardedBatchResult._fields, jres, tres):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                      err_msg=name)
    _assert_tables(jstate, tstate)
    return jstate, tstate, tres


# -- kernel level ------------------------------------------------------------


@pytest.mark.parametrize("coupled", [False, True], ids=["lean", "coupled"])
@pytest.mark.parametrize("has_global", [False, True],
                         ids=["local", "global"])
@pytest.mark.parametrize("H", [8, 64])
@pytest.mark.parametrize("seed", range(2))
def test_sharded_check_matches_jax(coupled, has_global, H, seed):
    rng = np.random.default_rng(100 * seed + 10 * H + 2 * coupled
                                + has_global)
    mesh = _mesh()
    now_ms = 5_000_000
    lanes = sharded_lanes(rng, L, G)
    table = sharded_table(rng, N, L, now_ms, lanes, G)
    jstate, tstate = _jax_state(mesh, table), _torch_state(table)
    for round_i in range(3):
        cols = sharded_batch(rng, N, H, lanes, L, G, coupled, has_global)
        jstate, tstate, _ = _both_check(mesh, jstate, tstate, cols, now_ms,
                                        coupled, has_global)
        now_ms += int(rng.choice([0, 700, 61_000]))


def test_coupled_fixpoint_needs_more_than_one_sweep():
    """Request 0 spans rows 0 and 1 and fails on row 1; request 1 on
    row 0's slot sees request 0's delta pending in the first sweep and
    fails, and is admitted only in a later sweep."""
    mesh = _mesh()
    H = 4
    table = tuple(np.zeros((N, L + 1), np.int32) for _ in range(3))
    cols = [np.full((N, H), f, dt) for f, dt in (
        (L, np.int32), (0, np.int32), (NEVER, np.int32), (0, np.int32),
        (N * H - 1, np.int32), (False, bool), (False, bool), (False, bool))]
    slots, deltas, maxes, wins, req = cols[:5]
    for i, (row, r, mx) in enumerate(((0, 0, 1), (1, 0, 0), (0, 1, 1))):
        col = 0 if row == 1 else i // 2
        slots[row, col], deltas[row, col], maxes[row, col] = G + 5, 1, mx
        wins[row, col], req[row, col] = 60_000, r
    sweeps = []
    real_sweep = TK._check_sweep

    def counted(plan, admitted, num_req):
        sweeps.append(1)
        return real_sweep(plan, admitted, num_req)

    TK._check_sweep = counted
    try:
        _, _, tres = _both_check(mesh, _jax_state(mesh, table),
                                 _torch_state(table), tuple(cols), 1000,
                                 True, False)
    finally:
        TK._check_sweep = real_sweep
    assert tres.admitted[:2].tolist() == [False, True]
    assert len(sweeps) > N  # more than one sweep of the 8 rows


def test_global_partials_past_int32_wrap_like_psum():
    mesh = _mesh()
    H = 8
    now_ms = 1000
    values = np.zeros((N, L + 1), np.int32)
    expiry = np.zeros((N, L + 1), np.int32)
    values[:, 3] = 1 << 29  # 8 * 2**29 = 2**32: the psum wraps to 0
    expiry[:, 3] = now_ms + 60_000
    values[:, 4] = 1 << 30  # live on three rows: 3 * 2**30 wraps negative
    expiry[:3, 4] = now_ms + 60_000
    table = (values, expiry, np.zeros((N, L + 1), np.int32))
    cols = [np.full((N, H), f, dt) for f, dt in (
        (L, np.int32), (0, np.int32), (NEVER, np.int32), (0, np.int32),
        (H - 1, np.int32), (False, bool), (False, bool), (False, bool))]
    for row in range(N):
        for j, slot in enumerate((3, 4)):
            cols[0][row, j], cols[1][row, j] = slot, 1
            cols[2][row, j], cols[3][row, j] = 100, 60_000
            cols[4][row, j], cols[7][row, j] = j, True
    _, _, tres = _both_check(mesh, _jax_state(mesh, table),
                             _torch_state(table), tuple(cols), now_ms,
                             False, True)
    # the wrapped bases (0 and -2**30) admit, as XLA's wrapping psum does
    assert tres.hit_ok[:, :2].all()


@pytest.mark.parametrize("coupled", [False, True], ids=["lean", "coupled"])
@pytest.mark.parametrize("has_global", [False, True],
                         ids=["local", "global"])
def test_sharded_check_matches_jax_at_the_cluster_shapes(coupled,
                                                         has_global):
    """8 rows of 2048 hits, where the cluster route spans its 16 blocks
    (one cluster of 16,384 hits when coupled or global, 8 clusters of 2
    blocks when lean), over a table of 4096 cells a row: the plain
    version against the JAX program in all four variants."""
    rng = np.random.default_rng(2048 + 2 * coupled + has_global)
    mesh = _mesh()
    now_ms = 5_000_000
    L_, H = 4096, 2048
    lanes = sharded_lanes(rng, L_, G)
    table = sharded_table(rng, N, L_, now_ms, lanes, G)
    assert TM.sharded_check_route(N, H, coupled, has_global) == "cluster"
    cols = sharded_batch(rng, N, H, lanes, L_, G, coupled, has_global)
    _both_check(mesh, _jax_state(mesh, table), _torch_state(table), cols,
                now_ms, coupled, has_global)


@pytest.mark.parametrize("has_global", [False, True],
                         ids=["local", "global"])
def test_lean_rows_settle_after_their_own_sweeps(has_global):
    """A lean batch whose rows' fixpoints settle after different sweep
    counts, row 0 only at its cap of H sweeps (a request whose verdict
    flips every sweep): each row ends as its own loop would, as the JAX
    program's per-device while_loop does. The cluster route runs every
    row's sweeps in one loop, capped at H; this pins the plain version
    it is held against on the card."""
    rng = np.random.default_rng(11)
    mesh = _mesh()
    now_ms = 5_000_000
    H = 32
    lanes = sharded_lanes(rng, L, G)
    table = sharded_table(rng, N, L, now_ms, lanes, G)
    cols = divergent_lean_batch(rng, N, H, lanes, L, G, has_global)
    sweeps = {}
    real_sweep = TK._check_sweep

    def counted(plan, admitted, num_req):
        sweeps[id(plan)] = sweeps.get(id(plan), 0) + 1
        return real_sweep(plan, admitted, num_req)

    TK._check_sweep = counted
    try:
        _both_check(mesh, _jax_state(mesh, table), _torch_state(table),
                    cols, now_ms, False, has_global)
    finally:
        TK._check_sweep = real_sweep
    per_row = list(sweeps.values())  # rows in order
    assert len(per_row) == N
    assert per_row[0] == H and max(per_row[1:]) < H
    assert per_row[1] >= 9 and len(set(per_row)) >= 3


@pytest.mark.parametrize("n, H, coupled, has_global, route", [
    (8, 8, True, True, "cluster"),
    (8, 8, False, True, "cluster"),
    (8, 8, True, False, "cluster"),
    (8, 8, False, False, "rows"),
    (8, 127, False, False, "rows"),
    (8, 1024, False, False, "cluster"),
    (8, 1024, True, True, "cluster"),
    (8, 2048, True, False, "cluster"),
    (8, 2048, False, True, "cluster"),
    (8, 2048, False, False, "cluster"),
    (8, 2049, True, True, "rows"),
    (8, 4096, False, True, "rows"),
    (8, 16384, False, False, "cluster"),
    (8, 16385, False, False, "rows"),
    (16, 1024, True, False, "cluster"),
    (17, 1024, True, False, "rows"),
    (1, 16384, False, True, "cluster"),
    (132, 64, True, False, "cluster"),
    (132, 128, True, False, "rows"),
])
def test_sharded_check_route_rule(n, H, coupled, has_global, route):
    """B7a's route is a rule on the batch's shape: coupled and global
    batches take one cluster over their n*H hits up to the cluster's
    16,384, lean rows without a global hit a cluster each where B1 takes
    its cluster (1,024 to 16,384 hits), and the one-block-a-row kernel
    the rest."""
    assert TM.sharded_check_route(n, H, coupled, has_global) == route


@pytest.mark.parametrize("n, H, coupled, has_global", [
    (8, 8, True, True), (8, 8, False, False), (8, 1024, True, True),
    (8, 1024, False, False), (8, 2048, False, True), (8, 4096, True, False),
    (8, 4096, False, True),
])
def test_sharded_check_card_path_by_route(monkeypatch, n, H, coupled,
                                          has_global):
    """The card path of B7a: the cluster route makes one
    ``ct_sharded_check_and_update_cluster`` call with no workspace, no
    co-residency query and no pre-pass, counted under
    ``sharded_check_and_update_cluster``; the rows route sizes its
    workspace (and, coupled, asks the co-residency) before its launch,
    counted under ``sharded_check_and_update``. ``route=`` forces either;
    an unknown route raises. The card is stood in for by a library that
    records its entry points."""
    lib = fake_card(monkeypatch)
    state = TM.make_sharded_table(n, 64, "cpu")
    cols = ([torch.zeros((n, H), dtype=torch.int32)] * 5
            + [torch.zeros((n, H), dtype=torch.bool)] * 3)
    rows = (["ct_sharded_coupled_capacity"] if coupled else []) + [
        "ct_sharded_check_workspace_bytes", "ct_sharded_check_and_update"]
    entry = {"cluster": ["ct_sharded_check_and_update_cluster"],
             "rows": rows}
    key = {"cluster": "sharded_check_and_update_cluster",
           "rows": "sharded_check_and_update"}
    for forced in (None, "rows", "cluster"):
        taken = forced or TM.sharded_check_route(n, H, coupled, has_global)
        before = dict(TK.launches)
        lib.calls.clear()
        TM.sharded_check_and_update(state, *cols, 1000, global_region=16,
                                    coupled=coupled, has_global=has_global,
                                    route=forced)
        assert lib.names() == entry[taken]
        assert {k: v - before[k] for k, v in TK.launches.items()
                if v != before[k]} == {key[taken]: 1}
    with pytest.raises(ValueError, match="no route"):
        TM.sharded_check_and_update(state, *cols, 1000, global_region=16,
                                    coupled=coupled, has_global=has_global,
                                    route="grid")


# -- the cases of tests/test_sharded.py (its three HLO lints have no
# counterpart), each through both packages with the JAX defaults
# (coupled, has_global, global_region 1024)


def _empty_batch(n, h, scratch):
    return dict(
        slots=np.full((n, h), scratch, np.int32),
        deltas=np.zeros((n, h), np.int32),
        maxes=np.full((n, h), np.iinfo(np.int32).max, np.int32),
        windows_ms=np.zeros((n, h), np.int32),
        req_ids=np.full((n, h), n * h - 1, np.int32),
        fresh=np.zeros((n, h), bool),
        bucket=np.zeros((n, h), bool),
        is_global=np.zeros((n, h), bool),
    )


_COLS = ("slots", "deltas", "maxes", "windows_ms", "req_ids", "fresh",
         "bucket", "is_global")


def _pair(mesh, local_cap):
    table = tuple(np.zeros((N, local_cap + 1), np.int32) for _ in range(3))
    return _jax_state(mesh, table), _torch_state(table)


def _step(mesh, states, b, now_ms):
    jstate, tstate, tres = _both_check(
        mesh, *states, tuple(b[c] for c in _COLS), now_ms, True, True,
        global_region=1024)
    return (jstate, tstate), tres


def test_owner_sharded_exactness():
    mesh = _mesh()
    local_cap, H = 64, 16
    b = _empty_batch(N, H, local_cap)
    for d in range(N):
        for i in range(H):
            b["slots"][d, i] = 3
            b["deltas"][d, i] = 1
            b["maxes"][d, i] = 10
            b["windows_ms"][d, i] = 60_000
            b["req_ids"][d, i] = d * H + i
    _, res = _step(mesh, _pair(mesh, local_cap), b, 1000)
    admitted = res.admitted.numpy().reshape(N, H)
    assert (admitted.sum(axis=1) == 10).all()
    assert admitted[:, :10].all() and not admitted[:, 10:].any()


def test_cross_device_request_coupling():
    mesh = _mesh()
    local_cap, H = 64, 4
    b = _empty_batch(N, H, local_cap)
    b["slots"][0, 0], b["deltas"][0, 0], b["maxes"][0, 0] = 1, 1, 5
    b["windows_ms"][0, 0], b["req_ids"][0, 0] = 60_000, 0
    b["slots"][1, 0], b["deltas"][1, 0], b["maxes"][1, 0] = 1, 1, 0
    b["windows_ms"][1, 0], b["req_ids"][1, 0] = 60_000, 0
    b["slots"][0, 1], b["deltas"][0, 1], b["maxes"][0, 1] = 1, 1, 5
    b["windows_ms"][0, 1], b["req_ids"][0, 1] = 60_000, 1
    (_, tstate), res = _step(mesh, _pair(mesh, local_cap), b, 1000)
    assert not res.admitted[0] and res.admitted[1]
    assert tstate.values[0, 1] == 1 and tstate.values[1, 1] == 0


def test_global_counter_psum_read():
    mesh = _mesh()
    local_cap, H, slot = 32, 4, 7
    b = _empty_batch(N, H, local_cap)
    for d in range(N):
        for i in range(2):
            b["slots"][d, i], b["deltas"][d, i] = slot, 1
            b["maxes"][d, i], b["windows_ms"][d, i] = 100, 60_000
            b["req_ids"][d, i], b["is_global"][d, i] = d * H + i, True
    states, res = _step(mesh, _pair(mesh, local_cap), b, 1000)
    assert res.admitted.numpy().reshape(N, H)[:, :2].all()
    b2 = _empty_batch(N, H, local_cap)
    b2["slots"][0, 0], b2["deltas"][0, 0] = slot, 1
    b2["maxes"][0, 0], b2["windows_ms"][0, 0] = 2 * N, 60_000
    b2["req_ids"][0, 0], b2["is_global"][0, 0] = 0, True
    _, res2 = _step(mesh, states, b2, 1000)
    assert not res2.admitted[0]


def test_sharded_clear_cells_zeroes_rows_in_place():
    mesh = _mesh()
    local_cap = 32
    b = _empty_batch(N, 4, local_cap)
    b["slots"][:, 0], b["deltas"][:, 0] = 5, 3
    b["maxes"][:, 0], b["windows_ms"][:, 0] = 100, 60_000
    b["req_ids"][:, 0] = 0
    (jstate, tstate), _ = _step(mesh, _pair(mesh, local_cap), b, 1000)
    rows = np.full((N, 8), local_cap, np.int32)
    rows[0, 0] = 5
    jstate = JM.sharded_clear_cells(mesh, jstate, rows)
    tstate = TM.sharded_clear_cells(tstate, torch.from_numpy(rows))
    _assert_tables(jstate, tstate)
    assert tstate.values[0, 5] == 0
    assert (tstate.values[1:, 5] == 3).all()


def test_window_expiry_sharded():
    mesh = _mesh()
    b = _empty_batch(N, 4, 16)
    b["slots"][0, 0], b["deltas"][0, 0], b["maxes"][0, 0] = 2, 5, 5
    b["windows_ms"][0, 0], b["req_ids"][0, 0] = 1_000, 0
    states, res = _step(mesh, _pair(mesh, 16), b, 0)
    assert res.admitted[0]
    states, res = _step(mesh, states, b, 500)
    assert not res.admitted[0]
    _, res = _step(mesh, states, b, 1500)
    assert res.admitted[0]


@pytest.mark.parametrize("K_", [1, 8, 64])
def test_sharded_clear_cells_matches_jax(K_):
    rng = np.random.default_rng(K_)
    mesh = _mesh()
    lanes = sharded_lanes(rng, L, G)
    table = sharded_table(rng, N, L, 1_000_000, lanes, G)
    rows = rng.integers(0, L, (N, K_)).astype(np.int32)
    rows[rng.random((N, K_)) < 0.3] = L  # padding
    jstate = JM.sharded_clear_cells(mesh, _jax_state(mesh, table), rows)
    tstate = TM.sharded_clear_cells(_torch_state(table),
                                    torch.from_numpy(rows))
    _assert_tables(jstate, tstate)


@pytest.mark.parametrize("H", [8, 64])
@pytest.mark.parametrize("seed", range(2))
def test_sharded_update_matches_jax(H, seed):
    rng = np.random.default_rng(7000 + 100 * seed + H)
    mesh = _mesh()
    now_ms = 5_000_000
    lanes = sharded_lanes(rng, L, G)
    table = sharded_table(rng, N, L, now_ms, lanes, G)
    jstate, tstate = _jax_state(mesh, table), _torch_state(table)
    for _round in range(3):
        slots, deltas, _m, wins, _r, fresh, bucket, _g = sharded_batch(
            rng, N, H, lanes, L, G, False, True)
        big = rng.random((N, H)) < 0.1
        deltas = np.where(big, rng.integers(-5, 1 << 30, (N, H)),
                          deltas).astype(np.int32)
        args = (slots, deltas, wins, fresh, bucket)
        jstate = JM.sharded_update(mesh, jstate, *args, np.int32(now_ms))
        tstate = TM.sharded_update(
            tstate, *(torch.from_numpy(a) for a in args), now_ms)
        _assert_tables(jstate, tstate)
        now_ms += int(rng.choice([0, 500, 61_000]))


@pytest.mark.parametrize("k", [1, 8, 64, L])
@pytest.mark.parametrize("kind", ["zipf", "ties", "zero"])
def test_sharded_drain_matches_jax(k, kind):
    rng = np.random.default_rng(k)
    mesh = _mesh()
    hits = np.zeros((N, L + 1), np.int32)
    if kind == "zipf":
        for s in range(N):
            np.add.at(hits[s], np.minimum(rng.zipf(1.3, 4 * L) - 1, L - 1),
                      1)
    elif kind == "ties":
        hits[:, :L] = rng.choice([0, 1, 2, 2], (N, L))
    hits[:, L] = 3  # scratch garbage: zeroed, never reported
    sharding = JM.batch_sharding(mesh)
    jh, jc, js = JM.sharded_drain_top_hits(
        mesh, jax.device_put(hits, sharding), k)
    th, tc, ts = TM.sharded_drain_top_hits(torch.from_numpy(hits.copy()), k)
    for j, t in ((jh, th), (jc, tc), (js, ts)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert not th.any()


# -- storage level -----------------------------------------------------------
#
# Each scenario is the body of a JAX-package test, written once against a
# package namespace ``pkg`` and run through both packages: its own
# assertions hold for each, and what it records (answers, counters) must
# be equal, as must every storage's launch_stats and three [8, L+1]
# arrays at the end.


class FakeClock:
    def __init__(self, now=1_700_000_000.0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, seconds):
        self.now += seconds


def _jax_pkg():
    from limitador_tpu import AsyncRateLimiter
    from limitador_tpu.storage.in_memory import InMemoryStorage
    from limitador_tpu.tpu.batcher import AsyncTpuStorage

    return dict(
        name="jax", Limit=JLimit, Context=JContext, RateLimiter=JRateLimiter,
        Counter=JCounter, Request=JRequest, InMemoryStorage=InMemoryStorage,
        AsyncRateLimiter=AsyncRateLimiter, AsyncStorage=AsyncTpuStorage,
        storage=lambda **kw: TpuShardedStorage(**kw),
        restore=lambda path, **kw: TpuShardedStorage.restore(path, **kw),
    )


def _torch_pkg():
    from limitador_tpu_torch import AsyncRateLimiter, InMemoryStorage
    from limitador_tpu_torch.device import AsyncTorchStorage

    return dict(
        name="torch", Limit=Limit, Context=Context, RateLimiter=RateLimiter,
        Counter=Counter, Request=_Request, InMemoryStorage=InMemoryStorage,
        AsyncRateLimiter=AsyncRateLimiter, AsyncStorage=AsyncTorchStorage,
        storage=lambda **kw: TorchShardedStorage(n_shards=N, device="cpu",
                                                 **kw),
        restore=lambda path, **kw: TorchShardedStorage.restore(
            path, device="cpu", **kw),
    )


class _Pkg:
    """One package's classes, and the sharded storages a scenario built
    through it (compared across packages at the end)."""

    def __init__(self, items):
        self.__dict__.update(items)
        self.built = []
        # storages built without a clock of their own share a frozen one,
        # so that both packages' expiries land on the same milliseconds
        self.clock = FakeClock()
        make, restore = self.storage, self.restore
        self.storage = lambda **kw: self._keep(make(**kw))
        self.restore = lambda path, **kw: self._keep(restore(path, **kw))

    def _keep(self, storage):
        self.built.append(storage)
        return storage


def _arrays(storage):
    state = storage._state
    if isinstance(state.values, torch.Tensor):
        return [t.numpy() for t in state]
    return [np.asarray(t) for t in state]


def _counter_rows(counters):
    return sorted(
        (str(c.namespace), c.limit.name, tuple(sorted(
            c.set_variables.items())), c.remaining, c.expires_in)
        for c in counters
    )


def _run_both(scenario, tmp_path=None):
    """Run ``scenario(pkg, tmp)`` through both packages; its returned
    record, and each built storage's launch_stats and arrays, must be
    equal."""
    out = {}
    for make in (_jax_pkg, _torch_pkg):
        pkg = _Pkg(make())
        tmp = None
        if tmp_path is not None:
            tmp = tmp_path / pkg.name
            tmp.mkdir()
        record = scenario(pkg, tmp)
        out[pkg.name] = (record, pkg.built)
    (jrec, jbuilt), (trec, tbuilt) = out["jax"], out["torch"]
    assert jrec == trec
    assert len(jbuilt) == len(tbuilt)
    for js, ts in zip(jbuilt, tbuilt):
        assert js.launch_stats() == ts.launch_stats()
        assert js.device_stats() == ts.device_stats()
        for name, j, t in zip(("values", "expiry_ms", "hits"), _arrays(js),
                              _arrays(ts)):
            np.testing.assert_array_equal(j, t, err_msg=name)
    return jrec


def _make(pkg, **kw):
    kw.setdefault("local_capacity", 1024)
    kw.setdefault("global_region", 32)
    kw.setdefault("clock", pkg.clock)
    return pkg.storage(**kw)


def test_owner_shard_equals_the_jax_package_over_a_corpus():
    from limitador_tpu.routing import counter_key as jkey
    from limitador_tpu.routing import stable_hash as jhash
    from limitador_tpu_torch.routing import counter_key, stable_hash

    rng = random.Random(5)
    specs = [
        ("ns", 3, 60, [], ["u"], "fixed_window"),
        ("ns", 5, 1, [], ["u", "v"], "token_bucket"),
        ("api", 10, 3600, ["descriptors[0].m == 'GET'"],
         ["descriptors[0].u"], "fixed_window"),
        ("empty", 1, 5, [], [], "fixed_window"),
        ("üñí", 7, 30, ["x == 'ä'"], ["k"], "fixed_window"),
    ]
    n = 0
    for ns, mx, sec, conds, vars_, policy in specs:
        jl = JLimit(ns, mx, sec, conds, vars_, policy=policy)
        tl = Limit(ns, mx, sec, conds, vars_, policy=policy)
        assert repr(jl._identity) == repr(tl._identity)
        for _ in range(200):
            values = {v: rng.choice(["a", "ü", "x y", "1", "'q'",
                                     str(rng.random())]) for v in vars_}
            jk = jkey(JCounter(jl, values))
            tk = counter_key(Counter(tl, values))
            assert repr(jk) == repr(tk)
            assert jhash(jk) == stable_hash(tk)
            assert jhash(jk) % 8 == stable_hash(tk) % 8
            n += 1
    assert n == 1000


def test_partition_and_scatter_equal_the_jax_package():
    from limitador_tpu.tpu.storage import _partition_positions as jpart
    from limitador_tpu.tpu.storage import _scatter_rows as jscatter
    from limitador_tpu_torch.device.storage import (
        _partition_positions,
        _scatter_rows,
    )

    rng = np.random.default_rng(4)
    for m in (0, 1, 100, 2048, 5000):  # the JAX package's C pass >= 2048
        ids = rng.integers(0, 8, m).astype(np.int32)
        jc, jp = jpart(ids, 8)
        tc, tp = _partition_positions(ids, 8)
        np.testing.assert_array_equal(jc, tc)
        np.testing.assert_array_equal(jp, tp)
        H = max(int(tc.max(initial=0)), 1)
        vals = rng.integers(0, 100, m).astype(np.int32)
        cols = ((vals, -1, np.int32), (vals > 50, False, bool))
        for j, t in zip(jscatter(ids, jp, 8, H, cols),
                        _scatter_rows(ids, tp, 8, H, cols)):
            np.testing.assert_array_equal(j, t)


def _sc_exact_admission_across_many_keys(pkg, _tmp):
    storage = _make(pkg)
    limiter = pkg.RateLimiter(storage)
    limiter.add_limit(pkg.Limit("ns", 3, 60, [], ["u"]))
    rec = []
    for u in range(20):
        ctx = pkg.Context({"u": f"user-{u}"})
        outcomes = [
            limiter.check_rate_limited_and_update("ns", ctx, 1).limited
            for _ in range(5)
        ]
        assert outcomes == [False, False, False, True, True], u
        rec.append(outcomes)
    return rec


def _sc_keys_actually_spread_over_shards(pkg, _tmp):
    storage = _make(pkg)
    limiter = pkg.RateLimiter(storage)
    limiter.add_limit(pkg.Limit("ns", 100, 60, [], ["u"]))
    for u in range(64):
        limiter.check_rate_limited_and_update(
            "ns", pkg.Context({"u": str(u)}), 1)
    occupied = [sorted(t.qualified.values()) for t in storage._tables]
    assert sum(1 for o in occupied if o) >= storage._n // 2
    return occupied


def _sc_global_namespace_counts_across_shards(pkg, _tmp):
    storage = _make(pkg, global_namespaces=["global_ns"])
    limiter = pkg.RateLimiter(storage)
    limiter.add_limit(pkg.Limit("global_ns", 10, 60, [], ["api_key"]))
    ctx = pkg.Context({"api_key": "k1"})
    admitted = sum(
        not limiter.check_rate_limited_and_update("global_ns", ctx,
                                                  1).limited
        for _ in range(10)
    )
    assert admitted == 10
    assert limiter.check_rate_limited_and_update("global_ns", ctx, 1).limited
    slot = next(iter(storage._gtable.info))
    vals = _arrays(storage)[0][:, slot]
    assert (vals > 0).sum() >= 2
    return admitted, vals.tolist()


def _sc_global_counter_get_counters_reads_psum(pkg, _tmp):
    storage = _make(pkg, global_namespaces=["g"])
    limiter = pkg.RateLimiter(storage)
    limiter.add_limit(pkg.Limit("g", 100, 60, [], ["u"]))
    ctx = pkg.Context({"u": "x"})
    for _ in range(7):
        limiter.check_rate_limited_and_update("g", ctx, 1)
    counters = limiter.get_counters("g")
    assert len(counters) == 1
    assert next(iter(counters)).remaining == 93
    return [(c.remaining) for c in counters]


def _sc_global_slot_recycling_clears_stale_partials(pkg, _tmp):
    storage = _make(pkg, global_namespaces=["g"])
    limiter = pkg.RateLimiter(storage)
    limit = pkg.Limit("g", 5, 60, [], ["u"])
    limiter.add_limit(limit)
    ctx = pkg.Context({"u": "x"})
    rec = [limiter.check_rate_limited_and_update("g", ctx, 1).limited
           for _ in range(6)]
    assert rec == [False] * 5 + [True]
    limiter.delete_limit(limit)
    limiter.add_limit(pkg.Limit("g", 5, 60, [], ["u"]))
    again = limiter.check_rate_limited_and_update("g", ctx, 1).limited
    assert not again
    return rec + [again]


def _sc_cross_shard_multi_limit_request_is_all_or_nothing(pkg, _tmp):
    storage = _make(pkg)
    limiter = pkg.RateLimiter(storage)
    limiter.add_limit(pkg.Limit("ns", 100, 3600, [], ["u"], name="loose"))
    limiter.add_limit(pkg.Limit("ns", 2, 60, [], ["u"], name="tight"))
    ctx = pkg.Context({"u": "spanner"})
    for _ in range(2):
        assert not limiter.check_rate_limited_and_update("ns", ctx, 1).limited
    r = limiter.check_rate_limited_and_update("ns", ctx, 1)
    assert r.limited and r.limit_name == "tight"
    counters = {c.limit.name: c for c in limiter.get_counters("ns")}
    assert counters["loose"].remaining == 98
    return _counter_rows(limiter.get_counters("ns"))


def _sc_update_counter_and_apply_deltas(pkg, _tmp):
    storage = _make(pkg, global_namespaces=["g"])
    c1 = pkg.Counter(pkg.Limit("ns", 100, 60, [], ["u"]), {"u": "a"})
    c2 = pkg.Counter(pkg.Limit("g", 100, 60, [], ["u"]), {"u": "b"})
    storage.update_counter(c1, 4)
    out = storage.apply_deltas([(c1, 1), (c2, 9)])
    assert out[0][0] == 5
    assert out[1][0] == 9
    assert storage.is_within_limits(c1, 95)
    assert not storage.is_within_limits(c1, 96)
    return out


def _sc_served_through_micro_batcher(pkg, _tmp):
    async def main():
        storage = _make(pkg)
        async_storage = pkg.AsyncStorage(storage=storage, max_delay=0.001)
        limiter = pkg.AsyncRateLimiter(async_storage)
        limiter.add_limit(pkg.Limit("ns", 10, 60, [], ["u"]))
        ctx = pkg.Context({"u": "concurrent"})
        results = await asyncio.gather(*[
            limiter.check_rate_limited_and_update("ns", ctx, 1)
            for _ in range(15)
        ])
        await async_storage.close()
        return sum(1 for r in results if not r.limited)

    loop = asyncio.new_event_loop()
    try:
        admitted = loop.run_until_complete(main())
    finally:
        loop.close()
    assert admitted == 10
    return admitted


def _sc_randomized_op_stream_parity_vs_oracle(pkg, _tmp):
    clock = FakeClock()
    mem = pkg.RateLimiter(pkg.InMemoryStorage(10_000, clock=clock))
    sharded = pkg.RateLimiter(_make(pkg, clock=clock))
    limits = [
        pkg.Limit("ns", 5, 60, [], ["u"], name="l5"),
        pkg.Limit("ns", 12, 10, [], ["u"], name="l12"),
        pkg.Limit("ns", 30, 3600, [], [], name="l30"),
        pkg.Limit("big", 1 << 40, 60, [], ["u"]),
    ]
    for limiter in (mem, sharded):
        for lim in limits:
            limiter.add_limit(lim)
    rng = random.Random(7)
    users = [str(i) for i in range(8)]
    rec = []
    for step in range(300):
        op = rng.random()
        ns = rng.choice(["ns", "ns", "ns", "big"])
        ctx = pkg.Context({"u": rng.choice(users)})
        delta = rng.choice([1, 1, 2, 5])
        if op < 0.6:
            r1 = mem.check_rate_limited_and_update(ns, ctx, delta)
            r2 = sharded.check_rate_limited_and_update(ns, ctx, delta)
            assert (r1.limited, r1.limit_name) == (r2.limited,
                                                   r2.limit_name), step
            rec.append((r2.limited, r2.limit_name))
        elif op < 0.75:
            mem.update_counters(ns, ctx, delta)
            sharded.update_counters(ns, ctx, delta)
        elif op < 0.9:
            r1 = mem.is_rate_limited(ns, ctx, delta)
            r2 = sharded.is_rate_limited(ns, ctx, delta)
            assert r1.limited == r2.limited, step
            rec.append(r2.limited)
        else:
            clock.advance(rng.choice([0.3, 1.0, 5.0, 11.0]))
    for ns in ("ns", "big"):
        c1 = {(tuple(c.set_variables.items()), c.window_seconds): c.remaining
              for c in mem.get_counters(ns)}
        c2 = {(tuple(c.set_variables.items()), c.window_seconds): c.remaining
              for c in sharded.get_counters(ns)}
        assert c1 == c2, ns
        rec.append(_counter_rows(sharded.get_counters(ns)))
    return rec


def _sc_launch_variant_classification(pkg, _tmp):
    storage = _make(pkg, global_namespaces=["g"])
    limiter = pkg.RateLimiter(storage)
    limiter.add_limit(pkg.Limit("ns", 10, 60, [], ["u"]))
    limiter.add_limit(pkg.Limit("g", 10, 60, [], ["u"]))
    base = dict(storage._launches)
    limiter.check_rate_limited_and_update("ns", pkg.Context({"u": "a"}), 1)
    assert storage._launches["lean"] == base["lean"] + 1
    limiter.check_rate_limited_and_update("g", pkg.Context({"u": "a"}), 1)
    assert storage._launches["global"] == base["global"] + 1
    limiter2 = pkg.RateLimiter(_make(pkg))
    limiter2.add_limit(pkg.Limit("ns2", 100, 3600, [], ["u"], name="a"))
    limiter2.add_limit(pkg.Limit("ns2", 100, 60, [], ["u"], name="b"))
    st = limiter2.storage.counters
    for i in range(64):
        before = dict(st._launches)
        limiter2.check_rate_limited_and_update(
            "ns2", pkg.Context({"u": f"u{i}"}), 1)
        if st._launches["coupled"] == before["coupled"] + 1:
            break
    else:
        raise AssertionError("no user coupled across shards in 64 tries")
    stats = storage.launch_stats()
    assert stats["sharded_launches"]["lean"] >= 1
    return i, stats


def _sc_parity_vs_oracle_under_eviction_pressure(pkg, _tmp):
    clock = FakeClock()
    mem = pkg.RateLimiter(pkg.InMemoryStorage(10_000, clock=clock))
    sharded = pkg.RateLimiter(_make(pkg, cache_size=16, clock=clock))
    limit = pkg.Limit("ns", 3, 10, [], ["u"])
    for limiter in (mem, sharded):
        limiter.add_limit(limit)
    evicting = sharded.storage.counters
    rec = []
    for phase in range(4):
        for u in range(40):
            ctx = pkg.Context({"u": f"p{phase}-u{u}"})
            for delta in (1, 2, 1):
                r1 = mem.check_rate_limited_and_update("ns", ctx, delta)
                r2 = sharded.check_rate_limited_and_update("ns", ctx, delta)
                assert r1.limited == r2.limited, (phase, u, delta)
                rec.append(r2.limited)
        clock.advance(11.0)
    evictions = sum(t.evictions for t in evicting._tables)
    assert evictions > 0
    return rec, evictions


def _sc_apply_deltas_mixed_global_and_local_one_batch(pkg, _tmp):
    clock = FakeClock()
    mem = pkg.InMemoryStorage(10_000, clock=clock)
    storage = _make(pkg, global_namespaces=["g"], clock=clock)
    lim_l = pkg.Limit("ns", 10, 60, [], ["u"])
    lim_g = pkg.Limit("g", 20, 60, [], ["u"])
    C_ = pkg.Counter
    items = [
        (C_(lim_l, {"u": "a"}), 4), (C_(lim_g, {"u": "shared"}), 7),
        (C_(lim_l, {"u": "b"}), 2), (C_(lim_g, {"u": "shared"}), 5),
        (C_(lim_l, {"u": "a"}), 1),
    ]
    out = storage.apply_deltas(items)
    for counter, delta in items:
        mem.update_counter(counter, delta)
    assert out[3][0] == 12
    assert out[4][0] == 5
    rec = [out]
    for counter, delta in ((C_(lim_l, {"u": "a"}), 5),
                           (C_(lim_l, {"u": "a"}), 6),
                           (C_(lim_g, {"u": "shared"}), 8),
                           (C_(lim_g, {"u": "shared"}), 9)):
        got = storage.check_and_update([counter], delta, False).limited
        assert got == mem.check_and_update([counter], delta, False).limited
        rec.append(got)
    return rec


def _sc_parity_vs_oracle_across_snapshot_restore(pkg, tmp):
    clock = FakeClock()
    mem = pkg.RateLimiter(pkg.InMemoryStorage(10_000, clock=clock))
    sharded = pkg.RateLimiter(_make(pkg, global_namespaces=["g"],
                                    clock=clock))
    limits = [pkg.Limit("ns", 5, 60, [], ["u"]),
              pkg.Limit("g", 15, 60, [], ["u"])]
    for limiter in (mem, sharded):
        for lim in limits:
            limiter.add_limit(lim)
    rng = random.Random(11)
    users = [f"u{i}" for i in range(6)]
    rec = []

    def step(sh, n):
        for _ in range(n):
            ns = rng.choice(["ns", "g"])
            ctx = pkg.Context({"u": rng.choice(users)})
            delta = rng.choice([1, 2])
            r1 = mem.check_rate_limited_and_update(ns, ctx, delta)
            r2 = sh.check_rate_limited_and_update(ns, ctx, delta)
            assert (r1.limited, r1.limit_name) == (r2.limited,
                                                   r2.limit_name)
            rec.append((r2.limited, r2.limit_name))

    step(sharded, 80)
    path = str(tmp / "mid.ckpt")
    sharded.storage.counters.snapshot(path)
    restored = pkg.RateLimiter(pkg.restore(path, clock=clock))
    for lim in limits:
        restored.add_limit(lim)
    step(restored, 80)
    for ns in ("ns", "g"):
        c1 = {(tuple(c.set_variables.items())): c.remaining
              for c in mem.get_counters(ns)}
        c2 = {(tuple(c.set_variables.items())): c.remaining
              for c in restored.get_counters(ns)}
        assert c1 == c2, ns
        rec.append(_counter_rows(restored.get_counters(ns)))
    return rec


def _sc_begin_finish_pipelining_is_exact(pkg, _tmp):
    storage = _make(pkg)
    limiter = pkg.RateLimiter(storage)
    tight = pkg.Limit("ns", 1, 60, [], ["u"], name="tight")
    wide = pkg.Limit("ns", 100, 3600, [], ["u"], name="wide")
    limiter.add_limit(tight)
    limiter.add_limit(wide)

    def req(u, delta=1):
        return pkg.Request([pkg.Counter(tight, {"u": u}),
                            pkg.Counter(wide, {"u": u})], delta, False)

    h1 = storage.begin_check_many([req("hot"), req("hot")])
    h2 = storage.begin_check_many([req("hot")])
    a1 = storage.finish_check_many(h1)
    a2 = storage.finish_check_many(h2)
    assert [a.limited for a in a1] == [False, True]
    assert a1[1].limit_name == "tight"
    assert [a.limited for a in a2] == [True]
    counters = {c.limit.name: c for c in storage.get_counters({wide})}
    assert counters["wide"].remaining == 99
    return ([(a.limited, a.limit_name) for a in a1 + a2],
            _counter_rows(storage.get_counters({tight, wide})))


def _sc_chunked_dispatch_byte_identical_to_monolithic(pkg, _tmp):
    def drive(chunk_size):
        storage = _make(pkg)
        limiter = pkg.RateLimiter(storage)
        limit = pkg.Limit("ns", 7, 60, [], ["u"])
        limiter.add_limit(limit)
        requests = [
            pkg.Request([pkg.Counter(limit, {"u": f"u{i % 13}"})],
                        1 + i % 3, False)
            for i in range(96)
        ]
        auths = []
        if chunk_size:
            handles = [storage.begin_check_many(requests[lo:lo + chunk_size])
                       for lo in range(0, len(requests), chunk_size)]
            for handle in handles:
                auths.extend(storage.finish_check_many(handle))
        else:
            auths = storage.check_many(requests)
        state = sorted(
            (c.set_variables["u"], c.remaining)
            for c in storage.get_counters({limit})
        )
        return [(a.limited, a.limit_name) for a in auths], state

    mono = drive(0)
    for chunk_size in (16, 32):
        assert drive(chunk_size) == mono, chunk_size
    return mono


def _sc_epoch_rebase_survives_month_long_idle(pkg, _tmp):
    clock = FakeClock()
    storage = _make(pkg, clock=clock)
    c = pkg.Counter(pkg.Limit("ns", 10, 60, [], ["u"]), {"u": "a"})
    storage.update_counter(c, 3)
    clock.advance(40 * 24 * 3600)  # 40 days > 2^31 ms
    assert storage.is_within_limits(c, 10)
    out = storage.apply_deltas([(c, 2)])
    assert out[0][0] == 2
    return out, storage._epoch


def _sc_snapshot_restore_roundtrip(pkg, tmp):
    clock = FakeClock()
    storage = _make(pkg, global_namespaces=["g"], clock=clock)
    limiter = pkg.RateLimiter(storage)
    limit = pkg.Limit("ns", 10, 600, [], ["u"])
    glimit = pkg.Limit("g", 20, 600, [], [])
    limiter.add_limit(limit)
    limiter.add_limit(glimit)
    for u in ("a", "b"):
        for _ in range(3):
            limiter.check_rate_limited_and_update("ns", pkg.Context({"u": u}),
                                                  1)
    for _ in range(5):
        limiter.check_rate_limited_and_update("g", pkg.Context({}), 1)
    path = str(tmp / "sharded.ckpt")
    storage.snapshot(path)
    restored = pkg.restore(path, clock=clock)
    limiter2 = pkg.RateLimiter(restored)
    limiter2.add_limit(limit)
    limiter2.add_limit(glimit)
    counters = {
        (str(c.namespace), c.set_variables.get("u")): c.remaining
        for c in limiter2.get_counters("ns") | limiter2.get_counters("g")
    }
    assert counters[("ns", "a")] == 7
    assert counters[("ns", "b")] == 7
    assert counters[("g", None)] == 15
    rec = [limiter2.check_rate_limited_and_update("g", pkg.Context({}),
                                                  1).limited
           for _ in range(16)]
    assert rec == [False] * 15 + [True]
    return sorted(counters.items()), rec


def _sc_pre_r4_checkpoint_bucket_migrates_to_device(pkg, tmp):
    """A checkpoint whose device-eligible bucket sits in the big host
    map (the JAX package's pre-r4 layout; the port's reader keeps the
    same rule): the restore seeds the owner row's TAT cell."""
    import pickle

    TB = dict(conditions=[], variables=["u"], policy="token_bucket")
    clock = FakeClock()
    storage = _make(pkg, clock=clock)
    limiter = pkg.RateLimiter(storage)
    limiter.add_limit(pkg.Limit("tb", 5, 1, **TB))
    for _ in range(3):
        limiter.check_rate_limited_and_update("tb", pkg.Context({"u": "a"}),
                                              1)
    path = str(tmp / "sharded-tb.ckpt")
    storage.snapshot(path)
    with open(path, "rb") as f:
        data = pickle.load(f)
    epoch_ms = int(data["epoch"] * 1000)
    keep = []
    moved = 0
    for i, (shard, slot) in enumerate(data["locs"]):
        key, counter = data["tables"][shard]["info"][slot]
        if counter.limit.policy == "token_bucket":
            data["big"][key] = (
                int(data["lexpiry"][i]) + epoch_ms, None, counter
            )
            del data["tables"][shard]["info"][slot]
            data["tables"][shard]["simple"].pop(key, None)
            data["tables"][shard]["qualified"] = [
                (k, v) for k, v in data["tables"][shard]["qualified"]
                if k != key
            ]
            moved += 1
        else:
            keep.append(i)
    assert moved == 1
    data["locs"] = [data["locs"][i] for i in keep]
    data["lvalues"] = np.asarray([data["lvalues"][i] for i in keep],
                                 np.int32)
    data["lexpiry"] = np.asarray([data["lexpiry"][i] for i in keep],
                                 np.int32)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    restored = pkg.restore(path, clock=clock)
    assert not restored._big
    limiter2 = pkg.RateLimiter(restored)
    limiter2.add_limit(pkg.Limit("tb", 5, 1, **TB))
    got = [limiter2.check_rate_limited_and_update(
        "tb", pkg.Context({"u": "a"}), 1).limited for _ in range(3)]
    assert got == [False, False, True]
    return got


def _sc_qualified_eviction_and_revival(pkg, _tmp):
    storage = _make(pkg, cache_size=8)
    limiter = pkg.RateLimiter(storage)
    limiter.add_limit(pkg.Limit("ns", 10, 60, [], ["u"]))
    for u in range(32):
        assert not limiter.check_rate_limited_and_update(
            "ns", pkg.Context({"u": f"u{u}"}), 1).limited
    again = limiter.check_rate_limited_and_update(
        "ns", pkg.Context({"u": "u0"}), 1)
    assert not again.limited
    return [t.evictions for t in storage._tables]


def _sc_global_overadmission_bound_within_one_batch(pkg, _tmp):
    storage = _make(pkg, global_namespaces=["gns"])
    n = storage._n
    limiter = pkg.RateLimiter(storage)
    max_value = 50
    limit = pkg.Limit("gns", max_value, 60, [], ["u"])
    limiter.add_limit(limit)
    counter = pkg.Counter(limit, {"u": "g"})
    storage.update_counter(counter, 45)
    budget = max_value - 45
    auths = storage.check_many(
        [pkg.Request([counter.key()], 1, False) for _ in range(40)])
    admitted = sum(1 for a in auths if not a.limited)
    assert admitted >= budget
    assert admitted - budget <= (n - 1) * budget, (admitted, n)
    auths2 = storage.check_many(
        [pkg.Request([counter.key()], 1, False) for _ in range(8)])
    assert all(a.limited for a in auths2)
    value = max_value - next(iter(storage.get_counters({limit}))).remaining
    assert value == 45 + admitted
    return admitted, value


STORAGE_SCENARIOS = [
    _sc_exact_admission_across_many_keys,
    _sc_keys_actually_spread_over_shards,
    _sc_global_namespace_counts_across_shards,
    _sc_global_counter_get_counters_reads_psum,
    _sc_global_slot_recycling_clears_stale_partials,
    _sc_cross_shard_multi_limit_request_is_all_or_nothing,
    _sc_update_counter_and_apply_deltas,
    _sc_served_through_micro_batcher,
    _sc_randomized_op_stream_parity_vs_oracle,
    _sc_launch_variant_classification,
    _sc_parity_vs_oracle_under_eviction_pressure,
    _sc_apply_deltas_mixed_global_and_local_one_batch,
    _sc_parity_vs_oracle_across_snapshot_restore,
    _sc_begin_finish_pipelining_is_exact,
    _sc_chunked_dispatch_byte_identical_to_monolithic,
    _sc_epoch_rebase_survives_month_long_idle,
    _sc_snapshot_restore_roundtrip,
    _sc_pre_r4_checkpoint_bucket_migrates_to_device,
    _sc_qualified_eviction_and_revival,
    _sc_global_overadmission_bound_within_one_batch,
]


@pytest.mark.parametrize("scenario", STORAGE_SCENARIOS,
                         ids=lambda f: f.__name__[4:])
def test_sharded_storage_matches_jax(scenario, tmp_path):
    _run_both(scenario, tmp_path)


# -- the sharded cases of test_token_bucket.py and test_big_limits.py ---------

TB = dict(conditions=[], variables=["descriptors[0].u"],
          policy="token_bucket")


def _tb_ctx(pkg, user="a"):
    ctx = pkg.Context()
    ctx.list_binding("descriptors", [{"u": user}])
    return ctx


def _sc_tb_burst_refill_and_headers(pkg, _tmp):
    clk = FakeClock(1000.0)
    rl = pkg.RateLimiter(pkg.storage(local_capacity=1024, global_region=32,
                                     clock=clk))
    rl.add_limit(pkg.Limit("tb", 5, 1, **TB))  # I=200ms
    got = [rl.check_rate_limited_and_update("tb", _tb_ctx(pkg), 1).limited
           for _ in range(7)]
    assert got == [False] * 5 + [True] * 2
    clk.advance(0.45)  # exactly 2 tokens back
    got2 = [rl.check_rate_limited_and_update("tb", _tb_ctx(pkg), 1).limited
            for _ in range(3)]
    assert got2 == [False, False, True]
    clk.advance(60)
    res = rl.check_rate_limited_and_update("tb", _tb_ctx(pkg), 2,
                                           load_counters=True)
    headers = res.response_header()
    assert headers["X-RateLimit-Limit"].startswith("5")
    assert headers["X-RateLimit-Remaining"] == "3"
    return got + got2, headers


def _sc_tb_sharded_device_bucket_burst_and_refill(pkg, _tmp):
    clk = FakeClock(1000.0)
    storage = pkg.storage(local_capacity=1 << 10, global_region=16,
                          clock=clk)
    rl = pkg.RateLimiter(storage)
    rl.add_limit(pkg.Limit("tb", 3, 1, **TB))
    rec = []
    for user in ("a", "b"):
        got = [rl.check_rate_limited_and_update(
            "tb", _tb_ctx(pkg, user), 1).limited for _ in range(4)]
        assert got == [False, False, False, True], user
        rec.append(got)
    assert len(storage._big) == 0
    clk.advance(0.4)  # one token back (I=333ms)
    assert not rl.check_rate_limited_and_update("tb", _tb_ctx(pkg, "a"),
                                                1).limited
    assert rl.check_rate_limited_and_update("tb", _tb_ctx(pkg, "a"),
                                            1).limited
    return rec


def _sc_tb_sharded_global_namespace_bucket_stays_host_side(pkg, _tmp):
    clk = FakeClock(1000.0)
    storage = pkg.storage(local_capacity=1 << 10, global_region=16,
                          global_namespaces=["gtb"], clock=clk)
    rl = pkg.RateLimiter(storage)
    rl.add_limit(pkg.Limit("gtb", 2, 1, **TB))
    got = [rl.check_rate_limited_and_update("gtb", _tb_ctx(pkg), 1).limited
           for _ in range(3)]
    assert got == [False, False, True]
    assert len(storage._big) == 1  # exact host cell, not a device slot
    return got


BIG = 1 << 40


def _big_storage(pkg):
    return pkg.storage(local_capacity=512, global_region=16, clock=pkg.clock)


def _sc_big_limit_admits_and_reports_exactly(pkg, _tmp):
    limiter = pkg.RateLimiter(_big_storage(pkg))
    limiter.add_limit(pkg.Limit("ns", BIG, 60, [], ["u"]))
    ctx = pkg.Context({"u": "a"})
    rec = []
    for i in range(5):
        r = limiter.check_rate_limited_and_update("ns", ctx, 1,
                                                  load_counters=True)
        assert not r.limited
        assert r.counters[0].remaining == BIG - (i + 1)
        rec.append(r.counters[0].remaining)
    assert next(iter(limiter.get_counters("ns"))).remaining == BIG - 5
    return rec


def _sc_big_limit_enforces_at_the_real_boundary(pkg, _tmp):
    storage = _big_storage(pkg)
    limiter = pkg.RateLimiter(storage)
    limit = pkg.Limit("ns", BIG, 60, [], ["u"])
    limiter.add_limit(limit)
    counter = pkg.Counter(limit, {"u": "edge"})
    storage.update_counter(counter, BIG - 2)
    ctx = pkg.Context({"u": "edge"})
    rec = [limiter.check_rate_limited_and_update("ns", ctx, 1).limited
           for _ in range(3)]
    assert rec == [False, False, True]
    assert storage.is_within_limits(counter, 0)
    assert not storage.is_within_limits(counter, 1)
    return rec


def _sc_big_mixed_and_device_limits_all_or_nothing(pkg, _tmp):
    limiter = pkg.RateLimiter(_big_storage(pkg))
    limiter.add_limit(pkg.Limit("ns", BIG, 3600, [], ["u"], name="big"))
    limiter.add_limit(pkg.Limit("ns", 2, 60, [], ["u"], name="small"))
    ctx = pkg.Context({"u": "mix"})
    for _ in range(2):
        assert not limiter.check_rate_limited_and_update("ns", ctx, 1).limited
    r = limiter.check_rate_limited_and_update("ns", ctx, 1)
    assert r.limited and r.limit_name == "small"
    by_name = {c.limit.name: c for c in limiter.get_counters("ns")}
    assert by_name["big"].remaining == BIG - 2
    return _counter_rows(limiter.get_counters("ns"))


def _sc_big_reject_strips_device_delta(pkg, _tmp):
    storage = _big_storage(pkg)
    limiter = pkg.RateLimiter(storage)
    big = pkg.Limit("ns", BIG, 3600, [], ["u"], name="big")
    limiter.add_limit(big)
    limiter.add_limit(pkg.Limit("ns", 100, 60, [], ["u"], name="small"))
    storage.update_counter(pkg.Counter(big, {"u": "strip"}), BIG)
    r = limiter.check_rate_limited_and_update(
        "ns", pkg.Context({"u": "strip"}), 1)
    assert r.limited and r.limit_name == "big"
    by_name = {c.limit.name: c for c in limiter.get_counters("ns")}
    assert by_name.get("small") is None or by_name["small"].remaining == 100
    return _counter_rows(limiter.get_counters("ns"))


def _sc_big_window_expiry(pkg, _tmp):
    limiter = pkg.RateLimiter(_big_storage(pkg))
    limiter.add_limit(pkg.Limit("ns", BIG, 1, [], ["u"]))  # 1s window
    ctx = pkg.Context({"u": "w"})
    assert not limiter.check_rate_limited_and_update("ns", ctx, 1).limited
    pkg.clock.advance(1.1)
    r = limiter.check_rate_limited_and_update("ns", ctx, 1, True)
    assert not r.limited
    assert r.counters[0].remaining == BIG - 1  # fresh window
    return r.counters[0].remaining


def _sc_big_apply_deltas_and_delete(pkg, _tmp):
    storage = _big_storage(pkg)
    limit = pkg.Limit("ns", BIG, 60, [], ["u"])
    c = pkg.Counter(limit, {"u": "d"})
    out = storage.apply_deltas([(c, 7)])
    assert out[0][0] == 7
    storage.delete_counters({limit})
    assert storage.is_within_limits(c, BIG)
    return out


def _sc_negative_delta_rejected_sharded(pkg, _tmp):
    counter = pkg.Counter(pkg.Limit("ns", 1 << 40, 60, [], ["u"]),
                          {"u": "a"})
    sharded = pkg.storage(local_capacity=2048, clock=pkg.clock)
    with pytest.raises(ValueError):
        sharded.apply_deltas([(counter, -5)])
    with pytest.raises(ValueError):
        sharded.update_counter(counter, -1)
    small = pkg.Counter(pkg.Limit("ns", 10, 60, [], ["u"]), {"u": "a"})
    with pytest.raises(ValueError):
        sharded.check_and_update([small], -1, False)
    return True


POLICY_SCENARIOS = [
    _sc_tb_burst_refill_and_headers,
    _sc_tb_sharded_device_bucket_burst_and_refill,
    _sc_tb_sharded_global_namespace_bucket_stays_host_side,
    _sc_big_limit_admits_and_reports_exactly,
    _sc_big_limit_enforces_at_the_real_boundary,
    _sc_big_mixed_and_device_limits_all_or_nothing,
    _sc_big_reject_strips_device_delta,
    _sc_big_window_expiry,
    _sc_big_apply_deltas_and_delete,
    _sc_negative_delta_rejected_sharded,
]


@pytest.mark.parametrize("scenario", POLICY_SCENARIOS,
                         ids=lambda f: f.__name__[4:])
def test_sharded_bucket_and_big_limit_cases_match_jax(scenario):
    _run_both(scenario)


# -- the behaviour matrix's sharded backend (tests/backends.py:79) ------------


def _to_port(x):
    """A JAX-package argument as the port's: limits through their dict
    form, contexts by their bindings, containers element-wise."""
    if isinstance(x, JLimit):
        return Limit.from_dict(x.to_dict())
    if isinstance(x, JContext):
        ctx = Context()
        ctx.variables = set(x.variables)
        ctx._bindings = {k: (list(map(dict, v)) if isinstance(v, list)
                             else dict(v) if isinstance(v, dict) else v)
                         for k, v in x._bindings.items()}
        return ctx
    if isinstance(x, (set, frozenset)):
        return type(x)(_to_port(i) for i in x)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_port(i) for i in x)
    return x


def _norm(x):
    """A result of either package as plain values."""
    if isinstance(x, (set, frozenset)):
        return sorted((_norm(i) for i in x), key=repr)
    if isinstance(x, (list, tuple)):
        return [_norm(i) for i in x]
    if hasattr(x, "limited") and hasattr(x, "limit_name"):
        return ("result", bool(x.limited), x.limit_name,
                sorted((_norm(c) for c in x.counters), key=repr))
    if hasattr(x, "set_variables"):
        return ("counter", repr(x.limit._identity), x.limit.max_value,
                x.limit.name, sorted(x.set_variables.items()), x.remaining,
                x.expires_in)
    if hasattr(x, "_identity"):
        return ("limit", repr(x._identity), x.max_value, x.name)
    if isinstance(x, (bool, int, float, str, type(None))):
        return x
    return str(x)


class _Twin:
    """The behaviour tests' limiter: every call goes to a JAX sharded
    limiter and to a port sharded limiter on one clock, frozen for the
    call; the two answers must be equal, and the JAX one is returned for
    the test's own assertions."""

    def __init__(self):
        self.t = time.time()
        clock = lambda: self.t  # noqa: E731
        self.jstorage = TpuShardedStorage(local_capacity=2048,
                                          global_region=64, clock=clock)
        self.tstorage = TorchShardedStorage(
            n_shards=N, local_capacity=2048, global_region=64, clock=clock,
            device="cpu")
        self.jlim = JRateLimiter(self.jstorage)
        self.tlim = RateLimiter(self.tstorage)

    def __getattr__(self, name):
        jattr = getattr(self.jlim, name)
        tattr = getattr(self.tlim, name)

        def call(*args, **kwargs):
            self.t = time.time()
            got = jattr(*args, **kwargs)
            ported = tattr(*_to_port(args),
                           **{k: _to_port(v) for k, v in kwargs.items()})
            assert _norm(got) == _norm(ported), name
            return got

        return call

    def check_storages(self):
        assert self.jstorage.launch_stats() == self.tstorage.launch_stats()
        for j, t in zip(_arrays(self.jstorage), _arrays(self.tstorage)):
            np.testing.assert_array_equal(j, t)


def _behavior_tests():
    from . import test_behavior

    return sorted(name for name in vars(test_behavior)
                  if name.startswith("test_"))


@pytest.mark.parametrize("name", _behavior_tests())
def test_behavior_matrix_sharded_backend_matches_jax(name):
    from . import test_behavior

    twin = _Twin()
    getattr(test_behavior, name)(twin)
    twin.check_storages()


# -- snapshots and the carry-over --------------------------------------------


def test_each_package_restores_its_own_checkpoint(tmp_path):
    """A checkpoint of each package restores in the same package, and
    both restored storages decide the rest of the stream identically."""
    def scenario(pkg, tmp):
        clock = FakeClock()
        storage = _make(pkg, global_namespaces=["g"], clock=clock)
        limiter = pkg.RateLimiter(storage)
        limits = [pkg.Limit("ns", 4, 60, [], ["u"]),
                  pkg.Limit("g", 9, 60, [], ["u"]),
                  pkg.Limit("tb", 3, 2, [], ["u"], policy="token_bucket"),
                  pkg.Limit("big", BIG, 60, [], ["u"])]
        for lim in limits:
            limiter.add_limit(lim)
        rng = random.Random(3)
        rec = []
        for phase in range(2):
            for _ in range(60):
                ns = rng.choice(["ns", "g", "tb", "big"])
                r = limiter.check_rate_limited_and_update(
                    ns, pkg.Context({"u": rng.choice("abcd")}), 1)
                rec.append((r.limited, r.limit_name))
            path = str(tmp / f"p{phase}.ckpt")
            limiter.storage.counters.snapshot(path)
            clock.advance(0.5)
            limiter = pkg.RateLimiter(pkg.restore(path, clock=clock))
            for lim in limits:
                limiter.add_limit(lim)
        for ns in ("ns", "g", "tb", "big"):
            rec.append(_counter_rows(limiter.get_counters(ns)))
        return rec

    _run_both(scenario, tmp_path)


def test_snapshot_manifest_and_items_decode_like_the_jax_package(tmp_path):
    """The slice-granular decode of a checkpoint: the same manifest and
    the same live (counter, spend) items from each package's checkpoint
    of one stream, an hour later (bucket and window expiry included)."""
    from limitador_tpu.tpu.sharded import snapshot_items as jitems
    from limitador_tpu.tpu.sharded import snapshot_manifest as jmanifest
    from limitador_tpu_torch.device.sharded import (
        snapshot_items,
        snapshot_manifest,
    )

    def scenario(pkg, tmp):
        clock = FakeClock()
        storage = _make(pkg, global_namespaces=["g"], clock=clock)
        storage.snapshot_meta = {"owned_shards": [0, 8]}
        limiter = pkg.RateLimiter(storage)
        for lim in (pkg.Limit("ns", 40, 60, [], ["u"]),
                    pkg.Limit("g", 90, 7200, [], ["u"]),
                    pkg.Limit("tb", 9, 600, [], ["u"],
                              policy="token_bucket"),
                    pkg.Limit("big", BIG, 7200, [], ["u"])):
            limiter.add_limit(lim)
        rng = random.Random(12)
        for _ in range(150):
            limiter.check_rate_limited_and_update(
                rng.choice(["ns", "g", "tb", "big"]),
                pkg.Context({"u": rng.choice("abcdefg")}),
                rng.choice([1, 2]))
        path = str(tmp / "s.ckpt")
        storage.snapshot(path)
        reader = (jmanifest, jitems) if pkg.name == "jax" else (
            snapshot_manifest, snapshot_items)
        manifest = reader[0](path)
        manifest.pop("format")  # each package names its own
        later = FakeClock(clock.now + 300)
        items = sorted((str(c.namespace), c.limit.name,
                        tuple(sorted(c.set_variables.items())), v)
                       for c, v in reader[1](path, clock=later))
        assert len(items) > 10
        return manifest, items

    _run_both(scenario, tmp_path)


def test_a_jax_checkpoint_is_refused_not_imported(tmp_path):
    from limitador_tpu_torch.storage.base import StorageError

    jax_storage = TpuShardedStorage(local_capacity=64, global_region=8)
    path = str(tmp_path / "jax.ckpt")
    jax_storage.snapshot(path)
    with pytest.raises(StorageError):
        TorchShardedStorage.restore(path, device="cpu")


def test_convert_continues_from_a_mid_stream_jax_sharded_table():
    from limitador_tpu_torch.convert import sharded_storage_from_state

    clock = FakeClock()
    jstorage = TpuShardedStorage(local_capacity=1024, global_region=32,
                                 global_namespaces=["g"], clock=clock)
    jlim = JRateLimiter(jstorage)
    specs = [("ns", 5, 60, [], ["u"]), ("g", 12, 60, [], ["u"]),
             ("ns", 50, 3600, [], ["u"])]
    for spec in specs:
        jlim.add_limit(JLimit(*spec, name=f"{spec[0]}-{spec[1]}"))
    rng = random.Random(9)
    for _ in range(120):
        jlim.check_rate_limited_and_update(
            rng.choice(["ns", "g"]), JContext({"u": rng.choice("abcdef")}),
            rng.choice([1, 2]))
    state = jstorage._state
    tstorage = sharded_storage_from_state(
        [t.dump() for t in jstorage._tables], jstorage._gtable.dump(),
        np.asarray(state.values), np.asarray(state.expiry_ms),
        np.asarray(state.hits), jstorage._epoch,
        global_namespaces=["g"], global_region=32,
        next_app_shard=jstorage._rr, clock=clock, device="cpu",
    )
    tlim = RateLimiter(tstorage)
    for spec in specs:
        tlim.add_limit(Limit(*spec, name=f"{spec[0]}-{spec[1]}"))
    for step in range(120):
        ns = rng.choice(["ns", "g"])
        u = rng.choice("abcdefgh")
        d = rng.choice([1, 2])
        a = jlim.check_rate_limited_and_update(ns, JContext({"u": u}), d)
        b = tlim.check_rate_limited_and_update(ns, Context({"u": u}), d)
        assert (a.limited, a.limit_name) == (b.limited, b.limit_name), step
        if step % 40 == 39:
            clock.advance(30)
    for j, t in zip(_arrays(jstorage), _arrays(tstorage)):
        np.testing.assert_array_equal(j, t)
    for ns in ("ns", "g"):
        assert _counter_rows(jlim.get_counters(ns)) == _counter_rows(
            tlim.get_counters(ns))


# -- B7b's host form and the coalesced clears ---------------------------------


@pytest.mark.parametrize("K_", [1, 8, 64])
@pytest.mark.parametrize("form", ["pairs", "all_rows"])
def test_sharded_clear_host_form_matches_jax(form, K_):
    """B7b's host form (the list by value) equals the JAX call on the
    padded [n, K] list, with dirty column-L cells: a padding entry is an
    entry of slot L and clears that cell, as the JAX scatter does."""
    rng = np.random.default_rng(40 + K_)
    mesh = _mesh()
    lanes = sharded_lanes(rng, L, G)
    table = sharded_table(rng, N, L, 1_000_000, lanes, G)
    for a in table:
        a[:, L] = rng.integers(1, 1000, N)
    if form == "pairs":
        rows = rng.integers(0, L, (N, K_)).astype(np.int32)
        rows[rng.random((N, K_)) < 0.3] = L
        rows[0, -1] = rows[0, 0]  # a duplicate
        entries = np.stack([np.repeat(np.arange(N, dtype=np.int32), K_),
                            rows.reshape(-1)], axis=1)
    else:
        entries = np.full(K_, L, np.int32)  # padded to K_ with slot L
        real = rng.choice(L, max(K_ // 2, 1), replace=False)
        entries[:real.size] = real
        rows = np.broadcast_to(entries, (N, K_)).copy()
    jstate = JM.sharded_clear_cells(mesh, _jax_state(mesh, table), rows)
    ctx = TK.TableContext(_torch_state(table))
    before = dict(TK.launches)
    tstate = TM.sharded_clear_cells_host(ctx, entries, form == "all_rows")
    assert TK.launches == before  # the CPU runs the plain version
    assert tstate is ctx.state
    _assert_tables(jstate, tstate)


def _twins(**kw):
    """The JAX sharded storage and the port's on one frozen clock."""
    clock = FakeClock()
    kw = dict(dict(local_capacity=256, global_region=8,
                   global_namespaces=["g"]), **kw)
    return (clock, TpuShardedStorage(clock=clock, **kw),
            TorchShardedStorage(n_shards=N, device="cpu", clock=clock, **kw))


def _same_tables(js, ts):
    for name, j, t in zip(("values", "expiry_ms", "hits"), _arrays(js),
                          _arrays(ts)):
        np.testing.assert_array_equal(j, t, err_msg=name)


def _both_requests(specs, delta=1, load=False):
    """One batch for each package: specs are lists of (limit pair,
    variables) per request."""
    return tuple(
        [Req([Ctr(lims[i], dict(v)) for lims, v in spec], delta, load)
         for spec in specs]
        for i, (Req, Ctr) in enumerate(((JRequest, JCounter),
                                        (_Request, Counter))))


def _limit_pair(*args, **kw):
    return JLimit(*args, **kw), Limit(*args, **kw)


def _reads(storage, limits, probes):
    """What a read sees right after a call: get_counters and
    is_within_limits of each probe counter."""
    rows = _counter_rows(storage.get_counters(set(limits)))
    within = [storage.is_within_limits(c, 1) for c in probes]
    return rows, within


def test_coalesced_clears_leave_the_jax_tables_after_every_call():
    """Global-region evictions, releases at finish, add_counter,
    apply_deltas and delete_counters, each call's clears launched as one
    B7b: after every public call the three [n, L+1] arrays equal the JAX
    storage's, and the reads right after an eviction (get_counters,
    is_within_limits) see the cleared cells."""
    clock, js, ts = _twins(cache_size=64)
    g = _limit_pair("g", 5, 60, [], ["t"], name="per-tenant")
    one = _limit_pair("ns", 1, 60, [], ["u"], name="one")
    loose = _limit_pair("ns", 50, 60, [], ["u"], name="loose")
    bare = _limit_pair("ns", 3, 60, [], [], name="bare")
    rng = random.Random(17)

    def check(jv, tv):
        assert jv == tv
        _same_tables(js, ts)
        jprobe = [JCounter(g[0], {"t": str(t)}) for t in range(0, 40, 7)]
        tprobe = [Counter(g[1], {"t": str(t)}) for t in range(0, 40, 7)]
        assert _reads(js, [g[0], one[0], loose[0]], jprobe) == _reads(
            ts, [g[1], one[1], loose[1]], tprobe)

    evictions = 0
    for b in range(6):
        # 40 tenants over an 8-slot region: every pass evicts
        specs = [[(g, {"t": str(rng.randrange(40))})] for _ in range(24)]
        specs += [[(loose, {"u": str(rng.randrange(9))})] for _ in range(8)]
        # then a limited local hit first and a fresh global one: released
        # at finish, its global slot zeroed on every row
        release = [[(one, {"u": "a"}), (g, {"t": f"fresh{b}"})]]
        for batch in (specs, release):
            jreq, treq = _both_requests(batch)
            before = ts._gtable.evictions
            check([(a.limited, a.limit_name) for a in js.check_many(jreq)],
                  [(a.limited, a.limit_name) for a in ts.check_many(treq)])
            evictions += ts._gtable.evictions - before
        items = [(g, {"t": str(rng.randrange(60))}) for _ in range(12)]
        check(js.apply_deltas([(JCounter(p[0], dict(v)), 2)
                               for p, v in items]),
              ts.apply_deltas([(Counter(p[1], dict(v)), 2)
                               for p, v in items]))
        if b == 2:
            check(js.delete_counters({loose[0], g[0]}),
                  ts.delete_counters({loose[1], g[1]}))
            check(js.add_counter(bare[0]), ts.add_counter(bare[1]))
        clock.advance(7)
    assert evictions > 50


def test_one_clear_launch_per_staging_pass(monkeypatch):
    """A counting spy on B7b's host form: a staging pass that evicts
    dozens of global slots launches one B7b (before its B7a) carrying
    each evicted slot once, and finish at most one more (its releases)."""
    calls = []
    launch = TM.sharded_clear_cells_host

    def spy(ctx, entries, all_rows):
        calls.append((entries.copy(), all_rows))
        return launch(ctx, entries, all_rows)

    monkeypatch.setattr(TM, "sharded_clear_cells_host", spy)
    _clock, _js, ts = _twins()
    g, one = (_limit_pair("g", 5, 60, [], ["t"])[1],
              _limit_pair("ns", 1, 60, [], ["u"])[1])
    rng = random.Random(5)
    released = 0
    for b in range(8):
        reqs = [_Request([Counter(g, {"t": str(rng.randrange(40))})], 1,
                         False) for _ in range(32)]
        evictions = ts._gtable.evictions
        n_calls = len(calls)
        handle = ts.begin_check_many(reqs)
        evicted = ts._gtable.evictions - evictions
        assert evicted >= 8
        assert len(calls) - n_calls == 1
        entries, all_rows = calls[-1]
        assert all_rows and entries.size == len(set(entries.tolist()))
        ts.finish_check_many(handle)
        assert len(calls) - n_calls <= 2
        # a limited hit first, then a fresh global one: finish releases
        # the global slot, zeroed on every row by one B7b
        n_calls = len(calls)
        ts.check_many([_Request([Counter(one, {"u": "a"}),
                                 Counter(g, {"t": f"new{b}"})], 1, False)])
        assert len(calls) - n_calls <= 2
        released += len(calls) - n_calls - 1
    assert released == 7  # every pass but the first, whose hit is admitted


def _rebind_cases(tmp_path):
    """Each way a sharded storage takes a new table: the constructor,
    clear(), a checkpoint restore and the JAX-state carry-over."""
    from limitador_tpu_torch.convert import sharded_storage_from_state

    def build():
        return TorchShardedStorage(n_shards=N, local_capacity=64,
                                   global_region=8, global_namespaces=["g"],
                                   device="cpu")

    def cleared():
        storage = build()
        old = storage._ctx
        storage.clear()
        return storage, old

    def restored():
        storage = build()
        path = str(tmp_path / "s.ckpt")
        storage.snapshot(path)
        return TorchShardedStorage.restore(path, device="cpu"), None

    def converted():
        j = TpuShardedStorage(local_capacity=64, global_region=8,
                              global_namespaces=["g"])
        state = j._state
        storage = sharded_storage_from_state(
            [t.dump() for t in j._tables], j._gtable.dump(),
            np.asarray(state.values), np.asarray(state.expiry_ms),
            np.asarray(state.hits), j._epoch, global_namespaces=["g"],
            global_region=8, device="cpu")
        return storage, None

    return {"init": lambda: (build(), None), "clear": cleared,
            "restore": restored, "convert": converted}


@pytest.mark.parametrize("case", ["init", "clear", "restore", "convert"])
def test_every_new_table_rebinds_the_clear_context(case, tmp_path):
    """After each replacement of the table a staged clear lands in the
    new table, never in the one it replaced: the replacement bound a new
    context and left the old one on the old table."""
    storage, old_ctx = _rebind_cases(tmp_path)[case]()
    assert storage._ctx.state is storage._state
    old = None
    if old_ctx is not None:
        assert old_ctx is not storage._ctx
        old = old_ctx.state
        assert old is not storage._state
        old.values[:, 3] = 5
    storage._state.values[:, 3] = 5
    storage._state.hits[2, 40] = 9
    with storage._lock:
        storage._zero_global_slots([3])
        storage._clear_pairs[(2, 40)] = None
    assert not storage._state.values[:, 3].any()
    assert storage._state.hits[2, 40] == 0
    if old is not None:
        assert (old.values[:, 3] == 5).all()


# -- B7c's host form and the Report path --------------------------------------

#: entries one B7c launch carries on the card (nvcc 12.1 or later)
UPDATE_CAPACITY = 2000


@pytest.mark.parametrize("count", [8, 33, UPDATE_CAPACITY - 1,
                                   UPDATE_CAPACITY, UPDATE_CAPACITY + 1])
def test_sharded_update_host_form_matches_jax(count):
    """B7c's host form on a flat list equals the JAX ``sharded_update``
    on the list's padded [n, H] columns, three rounds over one table:
    through a CPU context (the plain twin, no launch) and through a
    context that emulates the C entry point (one call with the list as
    bytes, one launch). The lists hold repeated cells, buckets and
    windows mixed on one row, global slots on the rows they are applied
    to, deltas at and past the caps, and a cell whose fresh entry
    follows a non-fresh one at the boundary of one launch's capacity
    (entries capacity - 1 and capacity), or as the list's last two."""
    rng = np.random.default_rng(9100 + count)
    mesh = _mesh()
    now_ms = 5_000_000
    lanes = sharded_lanes(rng, L, G)
    table = sharded_table(rng, N, L, now_ms, lanes, G)
    jstate = _jax_state(mesh, table)
    ctx = TK.TableContext(_torch_state(table))
    spy = SpyContext(_torch_state(table))
    straddle = min(count - 1, UPDATE_CAPACITY)
    for _round in range(3):
        entries = update_entries(rng, count, N, L, G, lanes, straddle)
        cells = entries[:, 0] * (L + 1) + entries[:, 1]
        assert np.unique(cells).size < count  # repeated cells
        assert (entries[:, 1] < G).any()  # global slots
        a, b = entries[straddle - 1], entries[straddle]
        assert (a[:2] == b[:2]).all() and a[4] & 1 == 0 and b[4] & 1
        jstate = JM.sharded_update(mesh, jstate,
                                   *padded_update_columns(entries, N, L),
                                   np.int32(now_ms))
        before = dict(TK.launches)
        assert TM.sharded_update_host(ctx, entries, now_ms) is ctx.state
        assert TK.launches == before  # the CPU runs the plain twin
        TM.sharded_update_host(spy, entries, now_ms)
        assert spy.calls[-1] == ("update", count)
        assert TK.launches["sharded_update_host"] == \
            before["sharded_update_host"] + 1
        assert TK.launches["sharded_update"] == before["sharded_update"]
        _assert_tables(jstate, ctx.state)
        _assert_tables(jstate, spy.state)
        now_ms += int(rng.choice([0, 500, 61_000]))


def test_sharded_update_host_form_hand_cells():
    """Hand cells through the host form's twin and the JAX call: a
    window cell whose fresh entry follows a non-fresh one (it ends at the
    fresh entry's window alone, with both deltas), a bucket and a window
    on row 2, a global slot twice on its application row 5, a cell that
    turns from window to bucket at its last entry, and deltas past the
    cap and negative; an empty list changes nothing."""
    rng = np.random.default_rng(9200)
    mesh = _mesh()
    now_ms = 2_000_000
    lanes = sharded_lanes(rng, L, G)
    table = sharded_table(rng, N, L, now_ms, lanes, G)
    entries = np.asarray([
        [2, 100, 3, 60_000, 0],
        [2, 100, 5, 60_000, 1],
        [2, 101, 1, 500, 2],
        [2, 102, 2, 1000, 0],
        [5, 3, 4, 60_000, 0],
        [5, 3, (1 << 30) - 1, 60_000, 0],
        [5, 3, NEVER, 60_000, 0],
        [0, 200, -7, 1000, 0],
        [0, 201, 2, 1000, 0],
        [0, 201, 1, 250, 2],
    ], np.int32)
    jstate = JM.sharded_update(mesh, _jax_state(mesh, table),
                               *padded_update_columns(entries, N, L),
                               np.int32(now_ms))
    ctx = TK.TableContext(_torch_state(table))
    TM.sharded_update_host(ctx, entries, now_ms)
    _assert_tables(jstate, ctx.state)
    assert int(ctx.state.values[2, 100]) == 8
    assert int(ctx.state.expiry_ms[2, 100]) == now_ms + 60_000
    assert int(ctx.state.hits[2, 100]) == 2
    before = [t.clone() for t in ctx.state]
    TM.sharded_update_host(ctx, np.zeros((0, 5), np.int32), now_ms)
    for t, b in zip(ctx.state, before):
        assert torch.equal(t, b)


@pytest.mark.parametrize("bad", [[0, L, 1, 1000, 0], [N, 3, 1, 1000, 0],
                                 [-1, 3, 1, 1000, 0], [0, -1, 1, 1000, 0]])
def test_sharded_update_host_form_refuses_cells_past_the_table(bad):
    """The host form has no padding: an entry of slot L (the scratch
    cell), of a negative slot or of a row past the table raises, as the
    card's entry point refuses it; a list of the wrong shape or type
    too."""
    ctx = TK.TableContext(TM.make_sharded_table(N, L, "cpu"))
    with pytest.raises(ValueError):
        TM.sharded_update_host(ctx, np.asarray([bad], np.int32), 0)
    for wrong in (np.zeros((2, 4), np.int32), np.zeros((2, 5), np.int64)):
        with pytest.raises(ValueError):
            TM.sharded_update_host(ctx, wrong, 0)
    assert not any(t.any() for t in ctx.state)


def test_apply_deltas_is_one_update_launch_per_call(monkeypatch):
    """A counting spy on B7c's host form: every ``apply_deltas`` with a
    device counter is one call (one launch) carrying each device counter
    once, in item order, whatever the Report's size (1, 2, 8 counters:
    windows, buckets, global counters, recycled cells); a Report of host
    counters only launches nothing. Its answers and the three arrays
    equal the JAX sharded storage's after every call."""
    calls = []
    launch = TM.sharded_update_host

    def spy(ctx, entries, now_ms):
        calls.append(entries.copy())
        return launch(ctx, entries, now_ms)

    monkeypatch.setattr(TM, "sharded_update_host", spy)
    clock, js, ts = _twins(cache_size=24)
    g = _limit_pair("g", 50, 60, [], ["t"], name="per-tenant")
    win = _limit_pair("ns", 30, 60, [], ["u"], name="win")
    tb = _limit_pair("ns", 6, 60, [], ["u"], name="bucket",
                     policy="token_bucket")
    big = _limit_pair("ns", 1 << 40, 60, [], ["u"], name="big")
    rng = random.Random(23)
    for step in range(40):
        size = (1, 2, 8)[step % 3]
        items = []
        for _ in range(size):
            pair = rng.choice((g, win, tb, win))
            key = "t" if pair is g else "u"
            items.append((pair, {key: str(rng.randrange(30))}))
        deltas = [rng.randrange(4) for _ in items]
        n_calls = len(calls)
        jv = js.apply_deltas([(JCounter(p[0], dict(v)), d)
                              for (p, v), d in zip(items, deltas)])
        tv = ts.apply_deltas([(Counter(p[1], dict(v)), d)
                              for (p, v), d in zip(items, deltas)])
        assert tv == jv, step
        assert len(calls) == n_calls + 1
        assert calls[-1].shape == (size, 5)
        _same_tables(js, ts)
        clock.advance(rng.choice([0, 3, 61]))
    n_calls = len(calls)
    jv = js.apply_deltas([(JCounter(big[0], {"u": "a"}), 5)])
    assert ts.apply_deltas([(Counter(big[1], {"u": "a"}), 5)]) == jv
    assert len(calls) == n_calls


# -- B7d's host form and the sharded observatory's drain ----------------------

#: B7d's column kinds: traffic-shaped and adversarial (tied, rising with
#: the index, at INT_MIN/INT_MAX)
DRAIN_KINDS = ("zipf", "sparse", "zero", "equal", "ascending", "extremes",
               "wide")
DRAIN_L = 1 << 10


@pytest.mark.parametrize("k", [1, 7, 64, DRAIN_L])
@pytest.mark.parametrize("kind", DRAIN_KINDS)
def test_sharded_drain_host_form_matches_jax(kind, k):
    """B7d's host form equals the JAX ``sharded_drain_top_hits`` on the 8
    virtual devices, each row its own column of the kind (scratch cell
    dirty), at L = 1<<10: the same counts and slots per row, ties to the
    lowest slot, and every row zeroed. Through a CPU context (the plain
    twin, no launch) and through a context that emulates the C entry
    point (one call, one launch counted under the host form's key), two
    drains in a row on each (the second of an emptied table)."""
    rng = np.random.default_rng(9400 + k)
    mesh = _mesh()
    hits = np.stack([hits_column(rng, kind, DRAIN_L) for _ in range(N)])
    sharding = JM.batch_sharding(mesh)
    jh, jc, js = JM.sharded_drain_top_hits(
        mesh, jax.device_put(hits, sharding), k)
    zeroed = np.asarray(jh)
    _, jc2, js2 = JM.sharded_drain_top_hits(mesh, jh, k)  # donates jh
    zeros = np.zeros_like(hits)
    for form in ("plain", "card"):
        state = TM.ShardedCounterState(*(torch.from_numpy(a) for a in (
            zeros.copy(), zeros.copy(), hits.copy())))
        ctx = TK.TableContext(state) if form == "plain" else SpyContext(state)
        for want_c, want_s in ((jc, js), (jc2, js2)):
            before = dict(TK.launches)
            counts, slots = TM.sharded_drain_top_hits_host(ctx, k)
            assert counts.shape == slots.shape == (N, k)
            assert counts.dtype == slots.dtype == np.int32
            np.testing.assert_array_equal(counts, np.asarray(want_c))
            np.testing.assert_array_equal(slots, np.asarray(want_s))
            np.testing.assert_array_equal(state.hits.numpy(), zeroed)
            moved = {key: TK.launches[key] - before[key] for key in before
                     if TK.launches[key] != before[key]}
            assert moved == ({} if form == "plain"
                             else {"sharded_drain_top_hits_host": 1})
        if form == "card":
            assert ctx.calls == [("drain", k)] * 2


def test_sharded_drain_host_form_refuses_k_past_the_row():
    """k outside [1, L] raises on both paths; so does a closed context."""
    ctx = TK.TableContext(TM.make_sharded_table(N, 16, "cpu"))
    spy = SpyContext(TM.make_sharded_table(N, 16, "cpu"))
    for c in (ctx, spy):
        for k in (0, 17):
            with pytest.raises(ValueError):
                TM.sharded_drain_top_hits_host(c, k)
    spy.close()
    with pytest.raises(RuntimeError):
        TM.sharded_drain_top_hits_host(spy, 4)


@pytest.mark.parametrize("form", ["plain", "card"])
def test_sharded_drain_hot_slots_takes_the_host_form(form):
    """The sharded observatory's ``drain_hot_slots`` equals the JAX
    sharded storage's after every round of traffic (lean, coupled and
    global hits, Reports) at k = 64 and 3, and drains through B7d's host
    form only: on the CPU it moves no launch count; through a context
    that emulates the C entry point it is one call and one launch under
    ``sharded_drain_top_hits_host``, never the device-tensor wrapper."""
    clock, js, ts = _twins(cache_size=64)
    spy = None
    if form == "card":
        spy = SpyContext(ts._ctx.state)
        ts._ctx = spy
    g = _limit_pair("g", 50, 60, [], ["t"], name="per-tenant")
    loose = _limit_pair("ns", 40, 60, [], ["u"], name="loose")
    pair = _limit_pair("ns", 30, 60, [], ["u", "r"], name="route")
    rng = random.Random(31)
    drains = 0
    for b in range(4):
        specs = [[(loose, {"u": str(rng.randrange(20))}),
                  (pair, {"u": str(rng.randrange(20)),
                          "r": str(rng.randrange(4))})]
                 for _ in range(24)]
        specs += [[(g, {"t": str(rng.randrange(6))})] for _ in range(12)]
        jreq, treq = _both_requests(specs)
        assert [(a.limited, a.limit_name) for a in js.check_many(jreq)] == \
            [(a.limited, a.limit_name) for a in ts.check_many(treq)]
        items = [(loose, {"u": str(rng.randrange(30))}) for _ in range(5)]
        assert js.apply_deltas([(JCounter(p[0], dict(v)), 2)
                                for p, v in items]) == \
            ts.apply_deltas([(Counter(p[1], dict(v)), 2) for p, v in items])
        for k in (64, 3):
            before = dict(TK.launches)
            got = ts.drain_hot_slots(k)
            assert got == js.drain_hot_slots(k)
            assert got or k == 3
            moved = {key: TK.launches[key] - before[key] for key in before
                     if TK.launches[key] != before[key]}
            if form == "plain":
                assert moved == {}
            else:
                assert moved.get("sharded_drain_top_hits_host") == 1
                assert "sharded_drain_top_hits" not in moved
                drains += 1
        _same_tables(js, ts)
        clock.advance(11)
    if spy is not None:
        assert [c for c in spy.calls if c[0] == "drain"] == \
            [("drain", k) for _ in range(4) for k in (64, 3)]
        assert drains == 8
