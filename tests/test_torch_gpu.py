"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card, which
skips the test where there is none (a CUDA kernel has no CPU mode; the
plain versions are held against the JAX package on the CPU by
``test_torch_kernel.py``). On the card's machine, which has no JAX, run
them without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerance: exact equality of every output and of the final table.
"""

import numpy as np
import pytest
import torch

from limitador_tpu_torch import Context, Limit, RateLimiter
from limitador_tpu_torch.device.storage import TorchStorage
from limitador_tpu_torch.ops import kernel as K
from limitador_tpu_torch.parallel import mesh as M

from .torch_batches import (
    C,
    CHECK_KINDS,
    DRAIN_EDGE_KINDS,
    NEVER,
    batch,
    check_case,
    credit_batch,
    credit_list,
    dirty_scratch,
    divergent_lean_batch,
    hits_column,
    lanes,
    padded_update_columns,
    remote_lanes,
    remote_rows,
    seed_rows,
    sharded_batch,
    sharded_lanes,
    sharded_table,
    table,
    update_entries,
)
from .torch_native_corpus import FROZEN_NOW, corpus, limits

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _state(arrays, dev):
    return K.CounterTableState(*(torch.from_numpy(a.copy()).to(dev)
                                 for a in arrays))


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("H", [1, 8, 64, 1024, 20000])
def test_check_and_update_kernel_matches_plain(cuda, H):
    rng = np.random.default_rng(H)
    now_ms = 5_000_000
    n_slots = min(max(H // 2, 4), 4000)  # slots stay below C = 4096
    slot_lanes = lanes(rng, n_slots)
    tab = table(rng, now_ms, slot_lanes)
    ka, pb = _state(tab, cuda), _state(tab, cuda)
    # the route by H: the cluster from 1,024 to 16,384 hits, else one block
    key = ("check_and_update_cluster" if K.check_route(H) == "cluster"
           else "check_and_update")
    for _round in range(3):
        arrays = tuple(torch.from_numpy(a).to(cuda)
                       for a in batch(rng, H, slot_lanes, n_slots))
        before = K.launches[key]
        _, got = K.check_and_update_batch(ka, *arrays, now_ms)
        assert K.launches[key] == before + 1
        want = K.check_and_update_plain(pb, *arrays, now_ms)
        _equal(got, want)
        _equal(ka, pb)
        now_ms += 700


@pytest.mark.parametrize("kind", CHECK_KINDS)
@pytest.mark.parametrize("H", [1, 8, 1000, 1024, 8192, 16383, 16384, 16385])
def test_check_cluster_kernel_matches_plain(cuda, H, kind):
    """B1's two kernels (the cluster and the one block) against the plain
    version on the same batches: every output and the final table, two
    rounds on one table. The cluster route stops at 16,384 hits (one
    block of the largest cluster per 1024): past it the wrapper takes the
    one-block kernel, and forcing the cluster raises."""
    rng = np.random.default_rng(7000 + H + 13 * CHECK_KINDS.index(kind))
    now_ms = 5_000_000
    tab, arrays = check_case(rng, H, kind, now_ms)
    routes = ("cluster", "block") if H <= K.CLUSTER_MAX_HITS else ("block",)
    states = {route: _state(tab, cuda) for route in routes}
    want_state = _state(tab, cuda)
    for _round in range(2):
        dev_arrays = tuple(torch.from_numpy(a).to(cuda) for a in arrays)
        want = K.check_and_update_plain(want_state, *dev_arrays, now_ms)
        for route in routes:
            key = ("check_and_update_cluster" if route == "cluster"
                   else "check_and_update")
            before = K.launches[key]
            _, got = K.check_and_update_batch(states[route], *dev_arrays,
                                              now_ms, route=route)
            assert K.launches[key] == before + 1
            _equal(got, want)
            _equal(states[route], want_state)
        now_ms += 700
    if H > K.CLUSTER_MAX_HITS:
        with pytest.raises(RuntimeError):
            K.check_and_update_batch(states["block"], *dev_arrays, now_ms,
                                     route="cluster")


@pytest.mark.parametrize("n", [1, 8, 1000, 8001, 20000])
def test_clear_slots_host_form_matches_plain(cuda, n):
    """B3b's host form: the list by value (duplicates, the scratch slot,
    lists past one parameter block), one launch per block, equal to the
    plain version; an empty list launches nothing."""
    rng = np.random.default_rng(900 + n)
    tab = table(rng, 1_000_000, {})
    slots = rng.integers(0, C + 1, n).astype(np.int32)
    slots[0] = C
    ka, pb = _state(tab, cuda), _state(tab, cuda)
    ctx = K.TableContext(ka)
    before = dict(K.launches)
    K.clear_slots_host(ctx, slots)
    K.clear_slots_host(ctx, np.zeros(0, np.int32))
    assert K.launches["clear_slots_host"] == \
        before["clear_slots_host"] + -(-n // ctx.capacity[5])
    assert K.launches["clear_slots"] == before["clear_slots"]
    K.clear_slots_plain(pb, torch.from_numpy(slots).to(cuda))
    _equal(ka, pb)
    ctx.close()


@pytest.mark.parametrize("H", [8, 1024, 20000])
def test_update_kernel_matches_plain(cuda, H):
    rng = np.random.default_rng(100 + H)
    now_ms = 5_000_000
    n_slots = min(max(H // 2, 4), 4000)  # slots stay below C = 4096
    slot_lanes = lanes(rng, n_slots)
    tab = table(rng, now_ms, slot_lanes)
    ka, pb = _state(tab, cuda), _state(tab, cuda)
    slots, deltas, _m, wins, _r, fresh, bucket = batch(
        rng, H, slot_lanes, n_slots)
    deltas = np.where(rng.random(H) < 0.1, rng.integers(-5, 1 << 30, H),
                      deltas).astype(np.int32)
    args = tuple(torch.from_numpy(a).to(cuda)
                 for a in (slots, deltas, wins, fresh, bucket))
    K.update_batch(ka, *args, now_ms)
    K.update_plain(pb, *args, now_ms)
    _equal(ka, pb)


def test_read_clear_and_rebase_kernels_match_plain(cuda):
    rng = np.random.default_rng(3)
    tab = table(rng, 1_000_000, {})
    ka, pb = _state(tab, cuda), _state(tab, cuda)
    slots = torch.from_numpy(
        rng.integers(0, tab[0].shape[0], 999).astype(np.int32)).to(cuda)
    _equal(K.read_slots(ka, slots, 1_000_000),
           K.read_slots_plain(pb, slots, 1_000_000))
    K.clear_slots(ka, slots[:300])
    K.clear_slots_plain(pb, slots[:300])
    _equal(ka, pb)
    shift = 3 * ((1 << 31) - 1) + 12345
    K.rebase_epoch_chunked(ka.expiry_ms, shift)
    rest = shift
    want = pb.expiry_ms.clone()
    while rest > 0:
        step = min(rest, (1 << 31) - 1)
        K.rebase_expiry_plain(want, step)
        rest -= step
    assert torch.equal(ka.expiry_ms, want)


def test_storage_on_the_card_decides_like_the_cpu(cuda):
    class Clock:
        now = 1_700_000_000.0

        def __call__(self):
            return self.now

    clock = Clock()
    limiters = [
        RateLimiter(TorchStorage(capacity=256, clock=clock, device=dev))
        for dev in (cuda, "cpu")
    ]
    specs = [
        dict(namespace="ns", max_value=4, seconds=10,
             variables=["descriptors[0].u"], name="win"),
        dict(namespace="ns", max_value=3, seconds=1,
             variables=["descriptors[0].u"], policy="token_bucket",
             name="tb"),
    ]
    for lim in limiters:
        for spec in specs:
            lim.add_limit(Limit(**spec))
    rng = np.random.default_rng(9)
    for step in range(300):
        ctx = Context()
        ctx.list_binding("descriptors", [{"u": str(rng.integers(0, 5))}])
        delta = int(rng.integers(1, 3))
        if rng.random() < 0.2:
            for lim in limiters:
                lim.update_counters("ns", ctx, delta)
            continue
        got = [lim.check_rate_limited_and_update("ns", ctx, delta, True)
               for lim in limiters]
        assert got[0].limited == got[1].limited, step
        assert sorted((c.remaining, c.expires_in) for c in got[0].counters) \
            == sorted((c.remaining, c.expires_in) for c in got[1].counters)
        clock.now += float(rng.choice([0.0, 0.1, 0.5]))


@pytest.mark.parametrize("H", [8, 1024, 4096])
def test_credit_kernel_matches_plain(cuda, H):
    rng = np.random.default_rng(200 + H)
    now_ms = 5_000_000
    tab, rows = credit_batch(rng, H, now_ms)
    ka, pb = _state(tab, cuda), _state(tab, cuda)
    args = tuple(torch.from_numpy(a).to(cuda) for a in rows)
    before = K.launches["credit"]
    K.credit_batch(ka, *args, now_ms, check_unique=True)
    assert K.launches["credit"] == before + 1
    K.credit_plain(pb, *args, now_ms)
    _equal(ka, pb)
    assert int(ka.values[-1]) == int(ka.expiry_ms[-1]) == 0


@pytest.mark.parametrize("k", [1, 4, 64, 1000, 1024, 1025, 4096])
@pytest.mark.parametrize("kind", ["zipf", "sparse", "zero", "wide"])
def test_drain_top_hits_kernel_matches_plain(cuda, kind, k):
    hits = torch.from_numpy(hits_column(np.random.default_rng(k), kind))
    a, b = hits.to(cuda), hits.to(cuda)
    before = K.launches["drain_top_hits"]
    got = K.drain_top_hits(a, k)
    assert K.launches["drain_top_hits"] == before + 1
    want = K.drain_top_hits_plain(b, k)
    _equal(got, want)
    assert not a.any()


def _native(dev, hot):
    from limitador_tpu_torch.device import AsyncTorchStorage
    from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
    from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter

    limiter = CompiledTorchLimiter(AsyncTorchStorage(TorchStorage(
        capacity=1 << 12, clock=lambda: FROZEN_NOW, device=dev)))
    for limit in limits(Limit):
        limiter.add_limit(limit)
    return NativeRlsPipeline(limiter, hot_lane=hot), limiter


@pytest.mark.parametrize("hot", [True, False], ids=["lane-on", "lane-off"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_native_pipeline_on_the_card_decides_like_the_cpu(cuda, seed, hot):
    """The fuzz corpus through the native pipeline over the card's table
    (B1 on the card, by the route of each chunk's hit count) and over
    the CPU's (B1's plain version): every row, with several chunks in
    flight, and the final tables."""
    (gpu, _gl), (cpu, _cl) = _native(cuda, hot), _native("cpu", hot)
    blobs = corpus(seed)
    routes = ("check_and_update", "check_and_update_cluster")
    before = sum(K.launches[key] for key in routes)
    for _pass in range(2):
        for ofs in range(0, len(blobs), 100):
            part = blobs[ofs:ofs + 100]
            assert gpu.decide_many(part, chunk=25, inflight=4) == \
                cpu.decide_many(part, chunk=25, inflight=4)
    assert sum(K.launches[key] for key in routes) > before
    _equal(gpu.storage._state, cpu.storage._state)
    assert gpu.storage.drain_hot_slots(64) == cpu.storage.drain_hot_slots(64)


def test_begin_check_columnar_owns_its_inputs_on_the_card(cuda):
    """Staging buffers overwritten right after begin (what the hot lane's
    next begin does) do not reach the launched batch on the card."""
    H = 8192
    rng = np.random.default_rng(5)
    cols = (rng.integers(0, 4000, H).astype(np.int32),
            np.ones(H, np.int32), np.full(H, 3, np.int32),
            np.full(H, 60_000, np.int32), np.arange(H, dtype=np.int32),
            np.zeros(H, bool), np.zeros(H, bool))
    results = []
    for overwrite in (False, True):
        storage = TorchStorage(capacity=4096, clock=lambda: FROZEN_NOW,
                               device=cuda)
        staged = tuple(c.copy() for c in cols)
        handle = storage.begin_check_columnar(*staged)
        if overwrite:
            for c in staged:
                c[...] = 0
        results.append(storage.finish_check_columnar(handle))
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("H", [1, 8, 64, 1024, 20000])
def test_replicated_check_kernel_matches_plain(cuda, H):
    """B6a against its plain version over remote lanes with live and
    expired window sums, bucket TATs ahead of and behind now, and
    local + remote sums past 2**31; and, with both lanes zero, against
    B1."""
    rng = np.random.default_rng(300 + H)
    now_ms = 5_000_000
    n_slots = min(max(H // 2, 4), 4000)
    slot_lanes = lanes(rng, n_slots)
    values, expiry, hits = table(rng, now_ms, slot_lanes)
    rv, re = remote_lanes(rng, now_ms, slot_lanes, values, n_slots)
    tab = (values, expiry, hits)
    ka, pb = _state(tab, cuda), _state(tab, cuda)
    zero_a, zero_b = _state(tab, cuda), _state(tab, cuda)
    remote = (torch.from_numpy(rv).to(cuda), torch.from_numpy(re).to(cuda))
    zeros = tuple(torch.zeros_like(t) for t in remote)
    # the route by H, as B1's: the cluster from 1,024 to 16,384 hits
    key = ("replicated_check_cluster" if K.check_route(H) == "cluster"
           else "replicated_check")
    for _round in range(3):
        arrays = tuple(torch.from_numpy(a).to(cuda)
                       for a in batch(rng, H, slot_lanes, n_slots))
        before = K.launches[key]
        _, got = K.replicated_check_batch(ka, *remote, *arrays, now_ms)
        assert K.launches[key] == before + 1
        want = K.replicated_check_plain(pb, *remote, *arrays, now_ms)
        _equal(got, want)
        _equal(ka, pb)
        _, got = K.replicated_check_batch(zero_a, *zeros, *arrays, now_ms)
        _, want = K.check_and_update_batch(zero_b, *arrays, now_ms)
        _equal(got, want)
        _equal(zero_a, zero_b)
        now_ms += 700


@pytest.mark.parametrize("H", [1024, 8192, 16384, 16385])
def test_replicated_check_cluster_kernel_matches_plain(cuda, H):
    """B6a's two kernels (the cluster with the gossip hooks, and the one
    block) against the plain version on the same batches, over remote
    lanes with live and expired sums, bucket floors and sums past 2**31:
    every output and the final table, two rounds on one table. Past
    16,384 hits the wrapper takes the one block and forcing the cluster
    raises."""
    rng = np.random.default_rng(9300 + H)
    now_ms = 5_000_000
    n_slots = 4000
    slot_lanes = lanes(rng, n_slots)
    values, expiry, hits = table(rng, now_ms, slot_lanes)
    rv, re = remote_lanes(rng, now_ms, slot_lanes, values, n_slots)
    tab = (values, expiry, hits)
    remote = (torch.from_numpy(rv).to(cuda), torch.from_numpy(re).to(cuda))
    routes = ("cluster", "block") if H <= K.CLUSTER_MAX_HITS else ("block",)
    assert K.check_route(H) == routes[0]
    states = {route: _state(tab, cuda) for route in routes}
    want_state = _state(tab, cuda)
    for _round in range(2):
        arrays = tuple(torch.from_numpy(a).to(cuda)
                       for a in batch(rng, H, slot_lanes, n_slots))
        want = K.replicated_check_plain(want_state, *remote, *arrays,
                                        now_ms)
        for route in routes:
            key = ("replicated_check_cluster" if route == "cluster"
                   else "replicated_check")
            before = K.launches[key]
            _, got = K.replicated_check_batch(states[route], *remote,
                                              *arrays, now_ms, route=route)
            assert K.launches[key] == before + 1
            _equal(got, want)
            _equal(states[route], want_state)
        now_ms += 700
    if H > K.CLUSTER_MAX_HITS:
        with pytest.raises(RuntimeError):
            K.replicated_check_batch(states["block"], *remote, *arrays,
                                     now_ms, route="cluster")


@pytest.mark.parametrize("H", [8, 1024, 20000])
def test_replicated_update_kernel_matches_plain(cuda, H):
    rng = np.random.default_rng(400 + H)
    now_ms = 5_000_000
    n_slots = min(max(H // 2, 4), 4000)
    slot_lanes = lanes(rng, n_slots)
    values, expiry, hits = table(rng, now_ms, slot_lanes)
    _rv, re = remote_lanes(rng, now_ms, slot_lanes, values, n_slots)
    tab = (values, expiry, hits)
    ka, pb = _state(tab, cuda), _state(tab, cuda)
    slots, deltas, _m, wins, _r, fresh, bucket = batch(
        rng, H, slot_lanes, n_slots)
    deltas = np.where(rng.random(H) < 0.1, rng.integers(-5, 1 << 30, H),
                      deltas).astype(np.int32)
    args = tuple(torch.from_numpy(a).to(cuda)
                 for a in (slots, deltas, wins, fresh, bucket))
    remote_exp = torch.from_numpy(re).to(cuda)
    before = K.launches["replicated_update"]
    K.replicated_update_batch(ka, remote_exp, *args, now_ms)
    assert K.launches["replicated_update"] == before + 1
    K.replicated_update_plain(pb, remote_exp, *args, now_ms)
    _equal(ka, pb)


@pytest.mark.parametrize("n", [1, 8, 1024, 4000])
def test_apply_remote_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(500 + n)
    lanes_a = tuple(torch.from_numpy(
        rng.integers(0, 1000, 4097).astype(np.int32)).to(cuda)
        for _ in range(2))
    lanes_b = tuple(t.clone() for t in lanes_a)
    rows = tuple(torch.from_numpy(a).to(cuda) for a in remote_rows(rng, n))
    before = K.launches["apply_remote"]
    K.apply_remote(*lanes_a, *rows)
    assert K.launches["apply_remote"] == before + 1
    K.apply_remote_plain(*lanes_b, *rows)
    _equal(lanes_a, lanes_b)


def test_replicated_node_on_the_card_decides_like_the_cpu(cuda):
    """One TorchReplicatedStorage on the card and one on the CPU take the
    same checks, Report-path updates and peer updates (windows and a
    shared bucket): same answers, same merged views, same five arrays."""
    from limitador_tpu_torch.core.counter import Counter
    from limitador_tpu_torch.device.replicated import TorchReplicatedStorage
    from limitador_tpu_torch.storage.keys import key_for_counter

    class Clock:
        now = 1_700_000_000.0

        def __call__(self):
            return self.now

    clock = Clock()
    nodes = [TorchReplicatedStorage("me", capacity=256, cache_size=64,
                                    clock=clock, device=dev)
             for dev in (cuda, "cpu")]
    limiters = [RateLimiter(n) for n in nodes]
    specs = [
        dict(namespace="ns", max_value=6, seconds=10,
             variables=["descriptors[0].u"], name="win"),
        dict(namespace="ns", max_value=4, seconds=2,
             variables=["descriptors[0].u"], policy="token_bucket",
             name="tb"),
    ]
    limits = [Limit(**spec) for spec in specs]
    for lim in limiters:
        for limit in limits:
            lim.add_limit(limit)
    rng = np.random.default_rng(11)
    before = dict(K.launches)
    for step in range(400):
        user = str(rng.integers(0, 90))
        ctx = Context()
        ctx.list_binding("descriptors", [{"u": user}])
        r = rng.random()
        if r < 0.2:
            limit = limits[int(rng.integers(0, 2))]
            counter = Counter(limit, {"descriptors[0].u": user})
            now_ms = int(clock.now * 1000)
            if limit.policy == "token_bucket":
                tat = now_ms + int(rng.integers(-500, 3000))
                args = (key_for_counter(counter), {"peer": tat}, tat)
            else:
                args = (key_for_counter(counter),
                        {"peer": int(rng.integers(0, 6))},
                        now_ms + int(rng.integers(-100, 10_000)))
            for node in nodes:
                node._on_remote_update(*args)
            continue
        delta = int(rng.integers(1, 3))
        if r < 0.35:
            for lim in limiters:
                lim.update_counters("ns", ctx, delta)
            continue
        got = [lim.check_rate_limited_and_update("ns", ctx, delta, True)
               for lim in limiters]
        assert got[0].limited == got[1].limited, step
        assert sorted((c.remaining, c.expires_in) for c in got[0].counters) \
            == sorted((c.remaining, c.expires_in) for c in got[1].counters)
        clock.now += float(rng.choice([0.0, 0.05, 0.3]))
    views = [sorted((c.limit.name, c.set_variables["descriptors[0].u"],
                     c.remaining, c.expires_in)
                    for c in lim.get_counters("ns")) for lim in limiters]
    assert views[0] == views[1]
    for name in ("replicated_check", "replicated_update_host",
                 "apply_remote_host", "read_slots_host"):
        assert K.launches[name] > before[name], name
    for name in ("check_and_update", "check_and_update_cluster", "update",
                 "replicated_update"):
        assert K.launches[name] == before[name], name
    card, cpu = nodes
    _equal(card._state, cpu._state)
    _equal((card._remote_vals, card._remote_exp),
           (cpu._remote_vals, cpu._remote_exp))
    for node in nodes:
        node.close()


def test_replicated_node_clears_a_merge_in_one_launch(cuda):
    """A replicated node on the card whose table is full adopts 1,000
    gossiped counters in one merge, each into a recycled slot: the
    clears are staged and reach the card as one ``clear_slots_host``
    launch at the next access, never through ``clear_slots``; then a
    check batch on the adopted counters (not fresh) and the merged view
    equal a CPU node's given the same calls, as do the five arrays."""
    from limitador_tpu_torch.core.counter import Counter
    from limitador_tpu_torch.device.replicated import TorchReplicatedStorage
    from limitador_tpu_torch.device.storage import _Request
    from limitador_tpu_torch.storage.keys import key_for_counter

    class Clock:
        now = 1_700_000_000.0

        def __call__(self):
            return self.now

    clock = Clock()
    nodes = [TorchReplicatedStorage("me", capacity=4096, cache_size=1000,
                                    clock=clock, device=dev)
             for dev in (cuda, "cpu")]
    limit = Limit("ns", 50, 60, [], ["u"])
    for node in nodes:
        RateLimiter(node).add_limit(limit)
    resident = [_Request([Counter(limit, {"u": f"r{i}"})], 3, False)
                for i in range(1000)]
    adopted = [Counter(limit, {"u": f"g{i}"}) for i in range(1000)]
    now_ms = int(clock.now * 1000)
    merge = [(key_for_counter(c), {"peer": 7}, now_ms + 30_000)
             for c in adopted]
    answers = []
    for node in nodes:
        node.check_many(resident)
        before = dict(K.launches)
        for update in merge:
            node._on_remote_update(*update)
        staged = len(node._staged_clears)
        with node._lock:
            node._read([0], node._now_ms())
        launched = {name: K.launches[name] - before[name]
                    for name in ("clear_slots", "clear_slots_host")}
        # 41 fits only on a cleared cell: 0 + 7 remote + 41 <= 50, where
        # the evicted counter's 3 would make it 51
        auths = node.check_many(
            [_Request([c], 41, True) for c in adopted[:200]])
        answers.append((staged, launched, [a.limited for a in auths],
                        sorted((c.set_variables["u"], c.remaining)
                               for c in node.get_counters({limit}))))
    card, cpu = answers
    assert card[0] == cpu[0] == 1000
    assert card[1] == {"clear_slots": 0, "clear_slots_host": 1}
    assert card[2:] == cpu[2:] and not any(card[2])
    _equal(nodes[0]._state, nodes[1]._state)
    _equal((nodes[0]._remote_vals, nodes[0]._remote_exp),
           (nodes[1]._remote_vals, nodes[1]._remote_exp))
    for node in nodes:
        node.close()


# -- slice 4: B4d, B4b and the tiered storage ----------------------------------


@pytest.mark.parametrize("scratch", ["clean", "dirty"])
@pytest.mark.parametrize("n_real", [1, 5, 8, 1000, 1024])
def test_seed_slots_kernel_matches_plain(cuda, n_real, scratch):
    rng = np.random.default_rng(300 + n_real)
    now_ms = 5_000_000
    tab = table(rng, now_ms, {})
    if scratch == "dirty":
        tab = dirty_scratch(tab, rng)
    H = 8 if n_real <= 8 else 1024
    rows = tuple(torch.from_numpy(a).to(cuda)
                 for a in seed_rows(rng, H, n_real, now_ms))
    ka, pb = _state(tab, cuda), _state(tab, cuda)
    before = K.launches["seed_slots"]
    K.seed_slots(ka, *rows)
    assert K.launches["seed_slots"] == before + 1
    K.seed_slots_plain(pb, *rows)
    _equal(ka, pb)
    assert int(ka.values[C]) == int(ka.expiry_ms[C]) == 0


@pytest.mark.parametrize("shift", [0, 1, 999_000, NEVER])
def test_rebase_epoch_kernel_matches_plain(cuda, shift):
    rng = np.random.default_rng(shift % 991)
    tab = table(rng, 5_000_000, {})
    tab[1][1:40:2] = NEVER
    ka, pb = _state(tab, cuda), _state(tab, cuda)
    d_shift = torch.tensor([shift], dtype=torch.int32, device=cuda)
    before = K.launches["rebase_epoch_device"]
    K.rebase_epoch(ka, d_shift)
    assert K.launches["rebase_epoch_device"] == before + 1
    K.rebase_epoch_plain(pb, d_shift)
    _equal(ka, pb)


def test_tiered_storage_on_the_card_matches_the_cpu(cuda):
    """One op stream through TieredStorage on the card and on the CPU
    (plain versions), with manager rounds: the same answers, round
    results, cold cells and arrays, and the card launched B4d
    (promotions) and B3a (demotion peeks)."""
    from limitador_tpu_torch.tier import TieredStorage, TierManager

    class Clock:
        now = FROZEN_NOW

        def __call__(self):
            return self.now

    clock = Clock()
    stores = [TieredStorage(capacity=64, cache_size=8, clock=clock,
                            device=dev) for dev in (cuda, "cpu")]
    limiters = [RateLimiter(st) for st in stores]
    managers = [TierManager(st, interval_s=3600.0) for st in stores]
    specs = [Limit("ns", 9, 60, [], ["u"], name="w9"),
             Limit("ns", 15, 30, [], ["u"], name="b15",
                   policy="token_bucket")]
    for lim in limiters:
        for limit in specs:
            lim.add_limit(limit)
    rng = np.random.default_rng(5)
    before = dict(K.launches)
    for step in range(600):
        ctx = Context({"u": str(rng.integers(0, 30))})
        delta = int(rng.integers(1, 3))
        got = [lim.check_rate_limited_and_update("ns", ctx, delta).limited
               for lim in limiters]
        assert got[0] == got[1], step
        if step % 20 == 19:
            # three rounds without traffic: the first demotes below the
            # watermark, the next ones promote the hottest cold keys
            for _round in range(3):
                assert managers[0].run_once() == managers[1].run_once()
        clock.now += float(rng.choice([0.0, 0.2, 2.0]))
    assert K.launches["seed_slots"] > before["seed_slots"]
    assert K.launches["read_slots_host"] > before["read_slots_host"]
    card, cpu = stores
    _equal(card._state, cpu._state)
    assert [(k, c.value_raw if hasattr(c, "value_raw") else c.tat)
            for k, (c, _) in card._cold.cells.items()] == [
        (k, c.value_raw if hasattr(c, "value_raw") else c.tat)
        for k, (c, _) in cpu._cold.cells.items()]
    for st in stores:
        st.close()


# -- B7: the sharded table ----------------------------------------------------


def _sharded(arrays, dev):
    return M.ShardedCounterState(*(torch.from_numpy(a.copy()).to(dev)
                                   for a in arrays))


@pytest.mark.parametrize("coupled", [False, True], ids=["lean", "coupled"])
@pytest.mark.parametrize("has_global", [False, True],
                         ids=["local", "global"])
@pytest.mark.parametrize("n, H, L", [(8, 8, 512), (8, 1024, 1 << 14),
                                     (3, 64, 4096)])
def test_sharded_check_kernel_matches_plain(cuda, coupled, has_global, n,
                                            H, L):
    rng = np.random.default_rng(n * H + 2 * coupled + has_global)
    now_ms = 5_000_000
    G = 64
    n_slots = min(L, 4096)
    slot_lanes = sharded_lanes(rng, n_slots, G)
    tab = sharded_table(rng, n, L, now_ms, slot_lanes, G)
    ka, pb = _sharded(tab, cuda), _sharded(tab, cuda)
    key = ("sharded_check_and_update_cluster"
           if M.sharded_check_route(n, H, coupled, has_global) == "cluster"
           else "sharded_check_and_update")
    for _round in range(3):
        cols = tuple(torch.from_numpy(a).to(cuda) for a in sharded_batch(
            rng, n, H, slot_lanes, L, G, coupled, has_global, n_slots))
        before = K.launches[key]
        _, got = M.sharded_check_and_update(
            ka, *cols, now_ms, global_region=G, coupled=coupled,
            has_global=has_global)
        assert K.launches[key] == before + 1
        want = M.sharded_check_and_update_plain(
            pb, *cols, now_ms, G, coupled, has_global)
        _equal(got, want)
        _equal(ka, pb)
        now_ms += 700


@pytest.mark.parametrize("coupled", [False, True], ids=["lean", "coupled"])
def test_sharded_check_kernel_takes_a_region_past_the_row(cuda, coupled):
    """global_region beyond L + 1 covers the whole row (the JAX default
    of 1024 over short rows): the kernel equals the plain version."""
    rng = np.random.default_rng(5)
    n, H, L = 8, 8, 40
    tab = [rng.integers(0, 50, (n, L + 1)).astype(np.int32),
           rng.integers(0, 2000, (n, L + 1)).astype(np.int32),
           np.zeros((n, L + 1), np.int32)]
    for t in tab:
        t[:, L] = 0
    ka, pb = _sharded(tab, cuda), _sharded(tab, cuda)
    R = n * H if coupled else H
    cols = [np.full((n, H), f, dt) for f, dt in (
        (L, np.int32), (0, np.int32), (NEVER, np.int32), (0, np.int32),
        (R - 1, np.int32), (False, bool), (False, bool), (False, bool))]
    for row in range(n):
        for j in range(4):
            cols[0][row, j] = int(rng.integers(0, L))
            cols[1][row, j], cols[2][row, j] = 1, 400
            cols[3][row, j] = 60_000
            cols[4][row, j] = row * H + j if coupled else j
            cols[7][row, j] = j % 2 == 0
    d = [torch.from_numpy(c).to(cuda) for c in cols]
    _, got = M.sharded_check_and_update(ka, *d, 1000, global_region=1024,
                                        coupled=coupled, has_global=True)
    want = M.sharded_check_and_update_plain(pb, *d, 1000, 1024, coupled,
                                            True)
    _equal(got, want)
    _equal(ka, pb)


def test_coupled_launch_refuses_rows_the_card_cannot_hold(cuda):
    """The rows route's cooperative launch needs every row's block
    resident: one row more than the card holds raises (forced, since
    those n*8 hits fit the cluster route, which needs no residency)."""
    fits = M.coupled_row_capacity(8, False, cuda)
    n = fits + 1
    tab = [np.zeros((n, 65), np.int32) for _ in range(3)]
    state = _sharded(tab, cuda)
    cols = [torch.full((n, 8), f, dtype=dt, device=cuda) for f, dt in (
        (64, torch.int32), (0, torch.int32), (NEVER, torch.int32),
        (0, torch.int32), (n * 8 - 1, torch.int32), (False, torch.bool),
        (False, torch.bool), (False, torch.bool))]
    with pytest.raises(RuntimeError, match="resident"):
        M.sharded_check_and_update(state, *cols, 1000, global_region=8,
                                   coupled=True, has_global=False,
                                   route="rows")


def _both_routes(ka, kb, pb, cols, now_ms, G, coupled, has_global):
    """The cluster route on ``ka``, the rows route on ``kb`` and the
    plain version on ``pb``, one batch: every output and the final
    tables equal, one launch under each route's key."""
    want = M.sharded_check_and_update_plain(pb, *cols, now_ms, G, coupled,
                                            has_global)
    for state, route, key in (
            (ka, "cluster", "sharded_check_and_update_cluster"),
            (kb, "rows", "sharded_check_and_update")):
        before = K.launches[key]
        _, got = M.sharded_check_and_update(
            state, *cols, now_ms, global_region=G, coupled=coupled,
            has_global=has_global, route=route)
        assert K.launches[key] == before + 1
        _equal(got, want)
        _equal(state, pb)


@pytest.mark.parametrize("coupled", [False, True], ids=["lean", "coupled"])
@pytest.mark.parametrize("has_global", [False, True],
                         ids=["local", "global"])
@pytest.mark.parametrize("H", [1024, 2048])
def test_sharded_check_cluster_kernel_matches_plain(cuda, coupled,
                                                    has_global, H):
    """B7a's two kernels against the plain version over the phase-10a
    table's shape (8 rows of 1<<17 + 1 cells): 8 x 1024 and 8 x 2048
    hits, in each variant the cluster route (one cluster of n*H hits, or
    one a row when lean without a global hit) and the rows route, two
    rounds on one table."""
    rng = np.random.default_rng(9500 + H + 2 * coupled + has_global)
    now_ms = 5_000_000
    n, L, G = 8, 1 << 17, 1024
    slot_lanes = sharded_lanes(rng, 4096, G)
    tab = sharded_table(rng, n, L, now_ms, slot_lanes, G)
    assert M.sharded_check_route(n, H, coupled, has_global) == "cluster"
    ka, kb, pb = (_sharded(tab, cuda) for _ in range(3))
    for _round in range(2):
        cols = tuple(torch.from_numpy(a).to(cuda) for a in sharded_batch(
            rng, n, H, slot_lanes, L, G, coupled, has_global, 4096))
        _both_routes(ka, kb, pb, cols, now_ms, G, coupled, has_global)
        now_ms += 700


@pytest.mark.parametrize("has_global", [False, True],
                         ids=["local", "global"])
@pytest.mark.parametrize("H", [1024, 2048])
def test_sharded_lean_rows_keep_their_own_sweep_caps(cuda, has_global, H):
    """A lean batch whose rows settle after different sweep counts, row 0
    only at its cap of H sweeps (``divergent_lean_batch``): the cluster
    route, which sweeps every row in one loop, equals the plain version's
    per-row loops, as does the rows route."""
    rng = np.random.default_rng(9700 + H + has_global)
    now_ms = 5_000_000
    n, L, G = 8, 1 << 17, 1024
    slot_lanes = sharded_lanes(rng, 4096, G)
    tab = sharded_table(rng, n, L, now_ms, slot_lanes, G)
    cols = tuple(torch.from_numpy(a).to(cuda) for a in divergent_lean_batch(
        rng, n, H, slot_lanes, L, G, has_global, 4096))
    ka, kb, pb = (_sharded(tab, cuda) for _ in range(3))
    _both_routes(ka, kb, pb, cols, now_ms, G, False, has_global)


@pytest.mark.parametrize("coupled", [False, True], ids=["lean", "coupled"])
@pytest.mark.parametrize("has_global", [False, True],
                         ids=["local", "global"])
def test_sharded_check_past_the_cluster_takes_the_rows(cuda, coupled,
                                                       has_global):
    """Past the cluster's reach (8 x 4096 coupled or global: 32,768 hits
    in one cluster; lean rows of 20,000) the wrapper takes the rows
    route and equals the plain version; forcing the cluster raises."""
    rng = np.random.default_rng(9900 + 2 * coupled + has_global)
    now_ms = 5_000_000
    G = 64
    n, H, L = (8, 4096, 1 << 14) if coupled or has_global else \
        (2, 20000, 1 << 15)
    slot_lanes = sharded_lanes(rng, 4096, G)
    tab = sharded_table(rng, n, L, now_ms, slot_lanes, G)
    assert M.sharded_check_route(n, H, coupled, has_global) == "rows"
    cols = tuple(torch.from_numpy(a).to(cuda) for a in sharded_batch(
        rng, n, H, slot_lanes, L, G, coupled, has_global, 4096))
    ka, pb = _sharded(tab, cuda), _sharded(tab, cuda)
    before = K.launches["sharded_check_and_update"]
    _, got = M.sharded_check_and_update(ka, *cols, now_ms, global_region=G,
                                        coupled=coupled,
                                        has_global=has_global)
    assert K.launches["sharded_check_and_update"] == before + 1
    want = M.sharded_check_and_update_plain(pb, *cols, now_ms, G, coupled,
                                            has_global)
    _equal(got, want)
    _equal(ka, pb)
    with pytest.raises(RuntimeError):
        M.sharded_check_and_update(ka, *cols, now_ms, global_region=G,
                                   coupled=coupled, has_global=has_global,
                                   route="cluster")


@pytest.mark.parametrize("K_", [1, 64, 300])
def test_sharded_clear_kernel_matches_plain(cuda, K_):
    rng = np.random.default_rng(K_)
    L = 4096
    tab = sharded_table(rng, 8, L, 1_000_000, {}, 16)
    ka, pb = _sharded(tab, cuda), _sharded(tab, cuda)
    rows = rng.integers(0, L, (8, K_)).astype(np.int32)
    rows[rng.random((8, K_)) < 0.3] = L
    d_rows = torch.from_numpy(rows).to(cuda)
    M.sharded_clear_cells(ka, d_rows)
    M.sharded_clear_cells_plain(pb, d_rows)
    _equal(ka, pb)


@pytest.mark.parametrize("H", [8, 1024])
def test_sharded_update_kernel_matches_plain(cuda, H):
    rng = np.random.default_rng(300 + H)
    now_ms = 5_000_000
    L = 4096
    slot_lanes = sharded_lanes(rng, L, 16)
    tab = sharded_table(rng, 8, L, now_ms, slot_lanes, 16)
    ka, pb = _sharded(tab, cuda), _sharded(tab, cuda)
    slots, deltas, _m, wins, _r, fresh, bucket, _g = sharded_batch(
        rng, 8, H, slot_lanes, L, 16, False, True)
    deltas = np.where(rng.random((8, H)) < 0.1,
                      rng.integers(-5, 1 << 30, (8, H)),
                      deltas).astype(np.int32)
    args = tuple(torch.from_numpy(a).to(cuda)
                 for a in (slots, deltas, wins, fresh, bucket))
    M.sharded_update(ka, *args, now_ms)
    M.sharded_update_plain(pb, *args, now_ms)
    _equal(ka, pb)


@pytest.mark.parametrize("k", [1, 64, 1024, 1025])
@pytest.mark.parametrize("kind", ["zipf", "ties", "zero"])
def test_sharded_drain_kernel_matches_plain(cuda, kind, k):
    rng = np.random.default_rng(k)
    L = 1 << 14
    hits = np.zeros((8, L + 1), np.int32)
    if kind == "zipf":
        for s in range(8):
            np.add.at(hits[s], np.minimum(rng.zipf(1.3, 4 * L) - 1, L - 1),
                      1)
    elif kind == "ties":
        hits[:, :L] = rng.choice([0, 1, 2, 2], (8, L))
    hits[:, L] = 3
    ha = torch.from_numpy(hits.copy()).to(cuda)
    hb = ha.clone()
    _equal(M.sharded_drain_top_hits(ha, k),
           M.sharded_drain_top_hits_plain(hb, k))
    assert not ha.any()


# -- host lists by value: B7b's and B4d's host forms --------------------------


def _bucket(n):
    return max(8, 1 << (n - 1).bit_length())


@pytest.mark.parametrize("count", [1, 64, 3000, 9000])
@pytest.mark.parametrize("form", ["pairs", "all_rows"])
def test_sharded_clear_host_form_matches_plain(cuda, form, count):
    """B7b from a host list against its plain version, dirty column L
    included; a list longer than one parameter block launches in chunks,
    each counted."""
    rng = np.random.default_rng(count + (form == "pairs"))
    L = 1 << 14
    tab = sharded_table(rng, 8, L, 1_000_000, {}, 16)
    for a in tab:
        a[:, L] = rng.integers(1, 1000, 8)
    ka, pb = _sharded(tab, cuda), _sharded(tab, cuda)
    if form == "pairs":
        entries = np.stack([rng.integers(0, 8, count),
                            rng.integers(0, L + 1, count)], 1)
    else:
        entries = rng.integers(0, L + 1, count)
    entries = np.ascontiguousarray(entries, np.int32)
    all_rows = form == "all_rows"
    ctx = K.TableContext(ka, torch.cuda.current_stream(cuda))
    chunk = ctx.capacity[0 if all_rows else 1]
    before = K.launches["sharded_clear_cells"]
    M.sharded_clear_cells_host(ctx, entries, all_rows)
    assert K.launches["sharded_clear_cells"] == before + -(-count // chunk)
    M.sharded_clear_cells_host_plain(pb, entries, all_rows)
    torch.cuda.synchronize()
    _equal(ka, pb)
    ctx.close()


@pytest.mark.parametrize("scratch", ["clean", "dirty"])
@pytest.mark.parametrize("n", [1, 5, 8, 300, 3000])
def test_seed_slots_host_form_matches_plain(cuda, n, scratch):
    """B4d from host lists against its plain version, with the padding
    flag of the storage's bucket; past one parameter block in chunks."""
    rng = np.random.default_rng(400 + n)
    now_ms = 5_000_000
    tab = table(rng, now_ms, {})
    if scratch == "dirty":
        tab = dirty_scratch(tab, rng)
    rows = seed_rows(rng, n, n, now_ms)
    ka, pb = _state(tab, cuda), _state(tab, cuda)
    ctx = K.TableContext(ka, torch.cuda.current_stream(cuda))
    before = K.launches["seed_slots"]
    K.seed_slots_host(ctx, *rows, _bucket(n) > n)
    assert K.launches["seed_slots"] == before + -(-n // ctx.capacity[2])
    K.seed_slots_host_plain(pb, *rows, _bucket(n) > n)
    torch.cuda.synchronize()
    _equal(ka, pb)
    ctx.close()


def test_sharded_storage_on_the_card_clears_like_the_cpu(cuda):
    """One evicting stream through TorchShardedStorage on the card and on
    the CPU: the same answers and arrays after every call, and one B7b
    per staging pass plus one per releasing or deleting call."""
    from limitador_tpu_torch.device.sharded import TorchShardedStorage
    from limitador_tpu_torch.device.storage import _Request
    from limitador_tpu_torch.core.counter import Counter

    class Clock:
        now = FROZEN_NOW

        def __call__(self):
            return self.now

    clock = Clock()
    stores = [TorchShardedStorage(n_shards=8, local_capacity=256,
                                  global_region=8, global_namespaces=["g"],
                                  clock=clock, device=dev)
              for dev in (cuda, "cpu")]
    g = Limit("g", 5, 60, [], ["t"])
    one = Limit("ns", 1, 60, [], ["u"])
    rng = np.random.default_rng(9)
    calls = 0
    before = K.launches["sharded_clear_cells"]
    for b in range(6):
        tenants = rng.integers(0, 40, 32).tolist()
        for reqs in ([[Counter(g, {"t": str(t)})] for t in tenants],
                     [[Counter(one, {"u": "a"}),
                       Counter(g, {"t": f"new{b}"})]]):
            got = [[a.limited for a in st.check_many(
                [_Request(cs, 1, False) for cs in reqs])] for st in stores]
            assert got[0] == got[1]
            calls += 2
            _equal(stores[0]._state, stores[1]._state)
        clock.now += 7.0
    for st in stores:
        st.delete_counters({g})
    calls += 1
    _equal(stores[0]._state, stores[1]._state)
    assert 0 < K.launches["sharded_clear_cells"] - before <= calls
    assert stores[0]._gtable.evictions > calls


# -- host forms with answers and remote rows: B3a and B6c ----------------------


@pytest.mark.parametrize("n", [1, 8, 1000, 8001, 20000])
def test_read_slots_host_form_matches_plain(cuda, n):
    """B3a from a host list (the scratch slot and repeats included)
    against its plain version, at now and at both int32 edges; a list
    longer than one parameter block launches in chunks, each counted."""
    rng = np.random.default_rng(600 + n)
    now_ms = 5_000_000
    tab = table(rng, now_ms, lanes(rng, 64))
    tab[1][:40] = NEVER
    ka = _state(tab, cuda)
    ctx = K.TableContext(ka, torch.cuda.current_stream(cuda))
    slots = rng.integers(0, C + 1, n).astype(np.int32)
    slots[0] = C
    for now in (now_ms, -(1 << 31), NEVER):
        before = K.launches["read_slots_host"]
        got = K.read_slots_host(ctx, slots, now)
        assert K.launches["read_slots_host"] == \
            before + -(-n // ctx.capacity[3])
        want = K.read_slots_host_plain(ka, slots, now)
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and g.flags.owndata
            np.testing.assert_array_equal(g, w)
    ctx.close()


def test_read_slots_host_form_reuses_its_buffer(cuda):
    """The answer buffer grows on demand and is reused by reads of
    growing and shrinking n; every answer is an array of its own, left
    as it was by the reads after it."""
    rng = np.random.default_rng(611)
    now_ms = 5_000_000
    ka = _state(table(rng, now_ms, {}), cuda)
    ctx = K.TableContext(ka, torch.cuda.current_stream(cuda))
    kept, sizes = [], []
    for n in (5, 3000, 2, 9000, 1, 1024, 1025):
        slots = rng.integers(0, C, n).astype(np.int32)
        got = K.read_slots_host(ctx, slots, now_ms)
        kept.append((slots, [a.copy() for a in got], got))
        sizes.append(ctx.results.shape[0])
    assert sizes == sorted(sizes) and sizes[0] == 1024
    assert sizes[-1] == 16384
    for slots, copies, got in kept:
        want = K.read_slots_host_plain(ka, slots, now_ms)
        for c, g, w in zip(copies, got, want):
            np.testing.assert_array_equal(c, w)
            np.testing.assert_array_equal(g, w)
    ctx.close()
    with pytest.raises(RuntimeError):
        K.read_slots_host(ctx, np.zeros(1, np.int32), now_ms)


@pytest.mark.parametrize("n", [1, 8, 2666, 2667, 12288, 65536])
def test_apply_remote_host_form_matches_plain(cuda, n):
    """B6c from host rows on a context over the remote lanes (hits
    aliasing the expiry lane) against its plain version, only the two
    lanes changing: the wrapper (one launch, by value within one
    parameter block, staged past it), then each C design alone (a chain
    of parameter blocks, the staged copy), twice, reusing its buffers."""
    rng = np.random.default_rng(700 + n)
    L = 1 << 17
    lanes_a = tuple(torch.from_numpy(
        rng.integers(0, 1000, L + 1).astype(np.int32)).to(cuda)
        for _ in range(2))
    lanes_b = tuple(t.clone() for t in lanes_a)
    ctx = K.TableContext(K.CounterTableState(*lanes_a, lanes_a[1]),
                         torch.cuda.current_stream(cuda))
    rows = remote_rows(rng, n, L)
    for run in (None, ctx.remote_fn, ctx.remote_fn, ctx.staged_fn,
                ctx.staged_fn):
        before = K.launches["apply_remote_host"]
        if run is None:
            K.apply_remote_host(ctx, *rows)
            assert K.launches["apply_remote_host"] == before + 1
        else:
            assert run(ctx.handle, *(a.tobytes() for a in rows), n) == 0
        K.apply_remote_plain(*lanes_b, *(torch.from_numpy(a).to(cuda)
                                         for a in rows))
        torch.cuda.synchronize()
        _equal(lanes_a, lanes_b)
        rows = (rows[0], rows[1] ^ 5, rows[2] // 2)
    ctx.close()


def test_a_peek_right_after_a_b1_launch_reads_its_result(cuda):
    """B1 queued on the storage stream (no sync), then at once a peek:
    the answers are those of the plain read after the same B1, and the
    peek is one B3a launch with no padding row."""

    class Clock:
        now = 1000.0

        def __call__(self):
            return self.now

    clock = Clock()
    storage = TorchStorage(capacity=C, clock=clock, device=cuda)
    rng = np.random.default_rng(812)
    now_ms = 5_000_000
    slot_lanes = lanes(rng, 4000)
    tab = table(rng, now_ms, slot_lanes)
    storage._state = _state(tab, cuda)
    plain = _state(tab, cuda)
    clock.now = 1000.0 + now_ms / 1000
    for _round in range(3):
        arrays = tuple(torch.from_numpy(a).to(cuda)
                       for a in batch(rng, 20000, slot_lanes, 4000))
        slots = arrays[0][:64].cpu().numpy()
        torch.cuda.synchronize()  # the inputs are in place; B1 is not
        with storage._lock:
            with storage._on_device():
                K.check_and_update_batch(storage._state, *arrays, now_ms)
            before = K.launches["read_slots_host"]
            got = storage.peek_slots(slots)
            assert K.launches["read_slots_host"] == before + 1
        K.check_and_update_plain(plain, *arrays, now_ms)
        want = K.read_slots_host_plain(plain, slots, now_ms)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    _equal(storage._state, plain)
    storage.close()


# -- B5's one-pass drain and its host form; B7c's host form -------------------


DRAIN_KINDS = ("zipf", "sparse", "zero", "wide") + DRAIN_EDGE_KINDS


def _hits_table(hits, dev):
    col = torch.from_numpy(hits).to(dev)
    return K.CounterTableState(torch.zeros_like(col), torch.zeros_like(col),
                               col)


@pytest.mark.parametrize("n", [1 << 10, 1 << 20], ids=["1k", "1M"])
@pytest.mark.parametrize("k", [1, 7, 64, 1000, 1024])
@pytest.mark.parametrize("kind", DRAIN_KINDS)
def test_drain_one_pass_kernel_and_host_form_match_plain(cuda, kind, k, n):
    """B5's one-pass kernel (the device-tensor call, one launch) and its
    host form (answers in the context's mapped buffer) against the plain
    drain, on traffic-shaped and adversarial columns (counts rising with
    the index, all equal, negative and at INT_MIN/INT_MAX): the same
    counts and slots, ties to the lowest slot, and the column zeroed."""
    hits = hits_column(np.random.default_rng(k + n), kind, n)
    _, want_c, want_s = K.drain_top_hits_plain(
        torch.from_numpy(hits.copy()), k)
    a = torch.from_numpy(hits.copy()).to(cuda)
    before = K.launches["drain_top_hits"]
    _, got_c, got_s = K.drain_top_hits(a, k)
    assert K.launches["drain_top_hits"] == before + 1
    _equal((got_c, got_s), (want_c, want_s))
    assert not a.any()
    state = _hits_table(hits, cuda)
    ctx = K.TableContext(state, torch.cuda.current_stream(cuda))
    before = K.launches["drain_top_hits_host"]
    counts, slots = K.drain_top_hits_host(ctx, k)
    assert K.launches["drain_top_hits_host"] == before + 1
    assert counts.flags.owndata and slots.flags.owndata
    np.testing.assert_array_equal(counts, want_c.numpy())
    np.testing.assert_array_equal(slots, want_s.numpy())
    assert not state.hits.any()
    ctx.close()


def test_a_drain_right_after_a_b1_launch_reads_its_hits(cuda):
    """B1 queued on the storage stream (no sync), then at once the host
    form's drain through the storage's context: it reads the hits that
    B1 added, as the plain drain after the same B1 does."""
    storage = TorchStorage(capacity=C, clock=lambda: 1000.0, device=cuda)
    rng = np.random.default_rng(813)
    now_ms = 5_000_000
    slot_lanes = lanes(rng, 4000)
    tab = table(rng, now_ms, slot_lanes)
    storage._state = _state(tab, cuda)
    plain = _state(tab, cuda)
    for _round in range(3):
        arrays = tuple(torch.from_numpy(a).to(cuda)
                       for a in batch(rng, 20000, slot_lanes, 4000))
        torch.cuda.synchronize()  # the inputs are in place; B1 is not
        with storage._lock:
            with storage._on_device():
                K.check_and_update_batch(storage._state, *arrays, now_ms)
            got = K.drain_top_hits_host(storage._ctx, 64)
        K.check_and_update_plain(plain, *arrays, now_ms)
        _, want_c, want_s = K.drain_top_hits_plain(plain.hits, 64)
        np.testing.assert_array_equal(got[0], want_c.cpu().numpy())
        np.testing.assert_array_equal(got[1], want_s.cpu().numpy())
    _equal(storage._state, plain)
    storage.close()


def test_drains_in_a_row_leave_the_done_counter_at_zero(cuda):
    """The last block sets the workspace's done counter back to 0: drains
    in a row through one context (its workspace allocated once, grown
    for a larger k) and through the device-tensor call stay exact, the
    answer buffer's earlier answers kept by the caller's copies."""
    rng = np.random.default_rng(814)
    state = _hits_table(hits_column(rng, "zipf", 1 << 20), cuda)
    ctx = K.TableContext(state, torch.cuda.current_stream(cuda))
    for kind, k in (("zipf", 64), ("ascending", 64), ("equal", 7),
                    ("zipf", 1000), ("extremes", 64), ("sparse", 1),
                    ("zipf", 4096), ("zipf", 64)):
        hits = hits_column(rng, kind, 1 << 20)
        state.hits.copy_(torch.from_numpy(hits))
        _, want_c, want_s = K.drain_top_hits_plain(
            torch.from_numpy(hits.copy()), k)
        counts, slots = K.drain_top_hits_host(ctx, k)
        np.testing.assert_array_equal(counts, want_c.numpy())
        np.testing.assert_array_equal(slots, want_s.numpy())
        a = torch.from_numpy(hits).to(cuda)
        _equal(K.drain_top_hits(a, k)[1:], (want_c, want_s))
    ctx.close()


@pytest.mark.parametrize("count", [1, 8, 32, 33, 128, 129, 1999, 2000, 2001,
                                   6000])
def test_sharded_update_host_form_matches_plain(cuda, count):
    """B7c from a host list (one launch: the parameter block up to the
    capacity, one staged copy past it) against the JAX-shaped plain
    version on the padded [n, H] columns and against the host form's
    plain twin: repeated cells, buckets and windows mixed, deltas at the
    caps, and a cell whose fresh entry follows a non-fresh one across
    the capacity's boundary (or as the last two entries of a shorter
    list)."""
    rng = np.random.default_rng(900 + count)
    now_ms = 5_000_000
    L, G = 1 << 12, 16
    slot_lanes = sharded_lanes(rng, L, G)
    tab = sharded_table(rng, 8, L, now_ms, slot_lanes, G)
    ka, pb, pc = (_sharded(tab, cuda) for _ in range(3))
    ctx = K.TableContext(ka, torch.cuda.current_stream(cuda))
    cap = ctx.capacity[6]
    assert cap == 2000
    for _round in range(3):
        entries = update_entries(rng, count, 8, L, G, slot_lanes,
                                 straddle=min(count - 1, cap))
        before = K.launches["sharded_update_host"]
        M.sharded_update_host(ctx, entries, now_ms)
        assert K.launches["sharded_update_host"] == before + 1
        M.sharded_update_plain(pb, *(
            torch.from_numpy(a).to(cuda)
            for a in padded_update_columns(entries, 8, L)), now_ms)
        M.sharded_update_host_plain(pc, entries, now_ms)
        torch.cuda.synchronize()
        _equal(ka, pb)
        _equal(ka, pc)
        now_ms += int(rng.choice([0, 500, 61_000]))
    ctx.close()


def test_sharded_update_host_form_refuses_the_scratch_slot(cuda):
    """The host form has no padding: an entry of slot L or of a row past
    the table raises, and the table is left as it was."""
    tab = tuple(np.ones((8, 65), np.int32) for _ in range(3))
    ka = _sharded(tab, cuda)
    ctx = K.TableContext(ka, torch.cuda.current_stream(cuda))
    for bad in ([0, 64, 1, 1000, 0], [8, 3, 1, 1000, 0]):
        with pytest.raises(RuntimeError, match="invalid argument"):
            M.sharded_update_host(ctx, np.asarray([[1, 2, 1, 1000, 0], bad],
                                                  np.int32), 0)
    torch.cuda.synchronize()
    _equal(ka, _sharded(tab, cuda))
    ctx.close()


# -- B7d on B5's one-pass body and its host form; B6b's host form -------------

#: the sharded table's shapes: the storage's (8 rows of 1<<17 + 1 cells,
#: each row's start 4 (L + 1) bytes past the last: every row has its own
#: unaligned head and tail) and a small one
SHARDED_DRAIN_SHAPES = ((8, 1 << 17), (3, 1 << 10))


def _sharded_hits(rng, kind, rows, L):
    return np.stack([hits_column(rng, kind, L) for _ in range(rows)])


@pytest.mark.parametrize("shape", SHARDED_DRAIN_SHAPES,
                         ids=["8x128k", "3x1k"])
@pytest.mark.parametrize("k", [1, 7, 64, 1000, 1024, 1025])
@pytest.mark.parametrize("kind", DRAIN_KINDS)
def test_sharded_drain_host_form_and_call_match_plain(cuda, kind, k, shape):
    """B7d's device-tensor call (one drain_kernel launch over the rows for
    k <= 1024, at the kernel's own blocks a row and forced to 16 and 32;
    the full sort row after row past it) and its host form (the rows'
    answers in the context's mapped buffer) against the plain drain of
    every row: the
    same counts and slots on every row, ties to the lowest slot, and
    every row zeroed. A k past the row's L is taken as L."""
    rows, L = shape
    k = min(k, L)
    hits = _sharded_hits(np.random.default_rng(k + L + rows), kind, rows, L)
    _, want_c, want_s = M.sharded_drain_top_hits_plain(
        torch.from_numpy(hits.copy()), k)
    for blocks in (0, 16, 32):
        a = torch.from_numpy(hits.copy()).to(cuda)
        before = K.launches["sharded_drain_top_hits"]
        _, got_c, got_s = M.sharded_drain_top_hits(a, k, blocks=blocks)
        assert K.launches["sharded_drain_top_hits"] == before + 1
        _equal((got_c, got_s), (want_c, want_s))
        assert not a.any()
    col = torch.from_numpy(hits).to(cuda)
    state = M.ShardedCounterState(torch.zeros_like(col),
                                  torch.zeros_like(col), col)
    ctx = K.TableContext(state, torch.cuda.current_stream(cuda))
    before = K.launches["sharded_drain_top_hits_host"]
    counts, slots = M.sharded_drain_top_hits_host(ctx, k)
    assert K.launches["sharded_drain_top_hits_host"] == before + 1
    assert counts.shape == (rows, k) and counts.flags.owndata
    np.testing.assert_array_equal(counts, want_c.numpy())
    np.testing.assert_array_equal(slots, want_s.numpy())
    assert not state.hits.any()
    ctx.close()


def test_sharded_drains_in_a_row_leave_the_header_at_zero(cuda):
    """Every row's last block sets its done counter and shared bound back
    to 0: drains in a row through one context of the rows (its workspace
    allocated once, grown for a larger k, the full sort past 1024 and
    back) and through the device-tensor call stay exact."""
    rng = np.random.default_rng(815)
    rows, L = SHARDED_DRAIN_SHAPES[0]
    col = torch.zeros((rows, L + 1), dtype=torch.int32, device=cuda)
    state = M.ShardedCounterState(torch.zeros_like(col),
                                  torch.zeros_like(col), col)
    ctx = K.TableContext(state, torch.cuda.current_stream(cuda))
    for kind, k in (("zipf", 64), ("zipf", 64), ("ascending", 64),
                    ("equal", 7), ("extremes", 1000), ("sparse", 1),
                    ("wide", 1025), ("zipf", 64)):
        hits = _sharded_hits(rng, kind, rows, L)
        state.hits.copy_(torch.from_numpy(hits))
        _, want_c, want_s = M.sharded_drain_top_hits_plain(
            torch.from_numpy(hits.copy()), k)
        counts, slots = M.sharded_drain_top_hits_host(ctx, k)
        np.testing.assert_array_equal(counts, want_c.numpy())
        np.testing.assert_array_equal(slots, want_s.numpy())
        a = torch.from_numpy(hits).to(cuda)
        _equal(M.sharded_drain_top_hits(a, k)[1:], (want_c, want_s))
    ctx.close()


@pytest.mark.parametrize("count", [1, 2, 8, 64, 2000, 2001])
def test_replicated_update_host_form_matches_plain(cuda, count):
    """B6b from a host list (one launch: the parameter block up to its
    capacity, one staged copy past it) against B6b's plain version on
    the padded columns and against the host form's plain twin, on a
    table whose remote lanes hold bucket TATs ahead of and behind now:
    repeated cells mixing buckets and windows, fresh cells, deltas at
    the caps, a fresh entry after a non-fresh one on one cell at the
    capacity's boundary; the remote lanes are only read."""
    rng = np.random.default_rng(950 + count)
    now_ms = 5_000_000
    slot_lanes = lanes(rng, C)
    tab = table(rng, now_ms, slot_lanes)
    rv, re = remote_lanes(rng, now_ms, slot_lanes, tab[0])
    ka, pb, pc = (_state(tab, cuda) for _ in range(3))
    remote = K.CounterTableState(*(torch.from_numpy(a.copy()).to(cuda)
                                   for a in (rv, re, re)))
    ctx = K.TableContext(ka, torch.cuda.current_stream(cuda))
    rctx = K.TableContext(remote, torch.cuda.current_stream(cuda))
    for _round in range(3):
        entries = update_entries(rng, count, 1, C, 1, slot_lanes,
                                 straddle=min(count - 1, 2000))
        before = dict(K.launches)
        K.replicated_update_host(ctx, rctx, entries, now_ms)
        assert K.launches["replicated_update_host"] == \
            before["replicated_update_host"] + 1
        assert K.launches["replicated_update"] == before["replicated_update"]
        cols = [torch.from_numpy(c[0]).to(cuda)
                for c in padded_update_columns(entries, 1, C)]
        K.replicated_update_plain(pb, remote.expiry_ms, *cols, now_ms)
        K.replicated_update_host_plain(pc, remote.expiry_ms, entries, now_ms)
        torch.cuda.synchronize()
        _equal(ka, pb)
        _equal(ka, pc)
        now_ms += int(rng.choice([0, 500, 61_000]))
    np.testing.assert_array_equal(remote.expiry_ms.cpu().numpy(), re)
    np.testing.assert_array_equal(remote.values.cpu().numpy(), rv)
    ctx.close()
    rctx.close()


def test_replicated_update_host_form_refuses_mismatched_contexts(cuda):
    """The remote context must be one row of the table's length: a
    remote context of another length, or a sharded table, raises; so
    does the scratch slot. The table is left as it was."""
    tab = tuple(np.ones(C + 1, np.int32) for _ in range(3))
    ka = _state(tab, cuda)
    stream = torch.cuda.current_stream(cuda)
    ctx = K.TableContext(ka, stream)
    entries = np.asarray([[0, 5, 1, 1000, 2]], np.int32)
    short = K.TableContext(_state(tuple(np.ones(C, np.int32)
                                        for _ in range(3)), cuda), stream)
    rows = K.TableContext(_sharded(tuple(np.ones((2, C + 1), np.int32)
                                         for _ in range(3)), cuda), stream)
    good = K.TableContext(_state(tab, cuda), stream)
    for rctx in (short, rows):
        with pytest.raises(RuntimeError, match="invalid argument"):
            K.replicated_update_host(ctx, rctx, entries, 0)
    with pytest.raises(RuntimeError, match="invalid argument"):
        K.replicated_update_host(ctx, good, np.asarray(
            [[0, C, 1, 1000, 0]], np.int32), 0)
    torch.cuda.synchronize()
    _equal(ka, _state(tab, cuda))
    for c in (ctx, short, rows, good):
        c.close()


# -- B2's and B4c's host forms ------------------------------------------------


@pytest.mark.parametrize("count", [1, 2, 8, 33, 129, 2000, 2001])
def test_update_host_form_matches_plain(cuda, count):
    """B2 from a host list (one launch: the parameter block up to its
    capacity, one staged copy past it) against B2's plain version on the
    padded columns and against the host form's plain twin: repeated
    cells mixing buckets and windows, fresh cells, deltas at and past
    the caps, a fresh entry after a non-fresh one on one cell at the
    capacity's boundary; three rounds on one context."""
    rng = np.random.default_rng(970 + count)
    now_ms = 5_000_000
    slot_lanes = lanes(rng, C)
    tab = table(rng, now_ms, slot_lanes)
    ka, pb, pc = (_state(tab, cuda) for _ in range(3))
    ctx = K.TableContext(ka, torch.cuda.current_stream(cuda))
    for _round in range(3):
        entries = update_entries(rng, count, 1, C, 1, slot_lanes,
                                 straddle=min(count - 1, 2000))
        before = dict(K.launches)
        K.update_host(ctx, entries, now_ms)
        assert K.launches["update_host"] == before["update_host"] + 1
        assert K.launches["update"] == before["update"]
        cols = [torch.from_numpy(c[0]).to(cuda)
                for c in padded_update_columns(entries, 1, C)]
        K.update_plain(pb, *cols, now_ms)
        K.update_host_plain(pc, entries, now_ms)
        torch.cuda.synchronize()
        _equal(ka, pb)
        _equal(ka, pc)
        now_ms += int(rng.choice([0, 500, 61_000]))
    ctx.close()


def test_update_host_form_refuses_a_sharded_context(cuda):
    """``ct_update_host`` takes a single table: an 8-row context, the
    scratch slot, a negative slot and row 1 raise; the tables are left
    as they were."""
    tab = tuple(np.ones(C + 1, np.int32) for _ in range(3))
    rows_tab = tuple(np.ones((8, 65), np.int32) for _ in range(3))
    ka, kb = _state(tab, cuda), _sharded(rows_tab, cuda)
    stream = torch.cuda.current_stream(cuda)
    ctx, rows = K.TableContext(ka, stream), K.TableContext(kb, stream)
    with pytest.raises(RuntimeError, match="invalid argument"):
        K.update_host(rows, np.asarray([[0, 3, 1, 1000, 0]], np.int32), 0)
    for bad in ([0, C, 1, 1000, 0], [0, -1, 1, 1000, 0], [1, 3, 1, 1000, 0]):
        with pytest.raises(RuntimeError, match="invalid argument"):
            K.update_host(ctx, np.asarray([[0, 2, 1, 1000, 0], bad],
                                          np.int32), 0)
    torch.cuda.synchronize()
    _equal(ka, _state(tab, cuda))
    _equal(kb, _sharded(rows_tab, cuda))
    ctx.close()
    rows.close()


@pytest.mark.parametrize("count", [1, 9, 1024, 2000, 2001, 4000])
def test_credit_host_form_matches_plain(cuda, count):
    """B4c from the broker's host list (one launch: the parameter block up
    to its capacity, one staged copy past it) against B4c's plain
    version on the padded columns and against the host form's plain
    twin, with the edge rows (an expired window and bucket, a credit
    covering exactly, one short, credit x interval past int32, a window
    floored at 0, negative credits) and a dirty scratch cell."""
    rng = np.random.default_rng(990 + count)
    now_ms = 5_000_000
    tab, entries, rows = credit_list(rng, count, now_ms)
    ka, pb, pc = (_state(tab, cuda) for _ in range(3))
    ctx = K.TableContext(ka, torch.cuda.current_stream(cuda))
    before = dict(K.launches)
    K.credit_host(ctx, entries, now_ms, check_unique=True)
    assert K.launches["credit_host"] == before["credit_host"] + 1
    assert K.launches["credit"] == before["credit"]
    K.credit_plain(pb, *(torch.from_numpy(a).to(cuda) for a in rows),
                   now_ms)
    K.credit_host_plain(pc, entries, now_ms)
    torch.cuda.synchronize()
    _equal(ka, pb)
    _equal(ka, pc)
    assert int(ka.values[-1]) == int(ka.expiry_ms[-1]) == 0
    ctx.close()


def test_staged_credits_in_a_row_on_one_context(cuda):
    """Two staged credit lists (past one parameter block) in a row on one
    context, then a staged update and a third staged credit: the
    staging buffer's reuse keeps every launch exact against the plain
    twins."""
    rng = np.random.default_rng(997)
    now_ms = 5_000_000
    slot_lanes = lanes(rng, C)
    tab = table(rng, now_ms, slot_lanes)
    ka, pb = _state(tab, cuda), _state(tab, cuda)
    ctx = K.TableContext(ka, torch.cuda.current_stream(cuda))
    for step, count in enumerate((2001, 3000, 2500, 4000)):
        if step == 2:
            entries = update_entries(rng, count, 1, C, 1, slot_lanes)
            K.update_host(ctx, entries, now_ms)
            K.update_host_plain(pb, entries, now_ms)
        else:
            slots = rng.choice(C, count, replace=False).astype(np.int32)
            entries = np.zeros((count, 5), np.int32)
            entries[:, 1] = slots
            entries[:, 2] = rng.integers(-3, 300, count)
            entries[:, 3] = rng.integers(1, 5000, count)
            entries[:, 4] = (rng.random(count) < 0.5).astype(np.int32) << 1
            K.credit_host(ctx, entries, now_ms)
            K.credit_host_plain(pb, entries, now_ms)
        now_ms += 700
    torch.cuda.synchronize()
    _equal(ka, pb)
    ctx.close()


def test_storage_updates_and_credits_through_the_host_forms(cuda):
    """On the card ``update_counter``, ``apply_deltas`` and
    ``credit_columnar`` launch B2's and B4c's host forms, one launch a
    call, never ``update_batch`` or ``credit_batch``, and leave the table
    the CPU storage leaves."""
    from limitador_tpu_torch.core.counter import Counter

    class Clock:
        now = 1_700_000_000.0

        def __call__(self):
            return self.now

    clock = Clock()
    stores = [TorchStorage(capacity=256, clock=clock, device=dev)
              for dev in (cuda, "cpu")]
    win = Limit("ns", 40, 60, [], ["u"], name="win")
    tb = Limit("ns", 9, 60, [], ["u"], name="tb", policy="token_bucket")
    rng = np.random.default_rng(13)
    before = dict(K.launches)
    calls = 0
    for step in range(60):
        items = [(Counter((win, tb)[int(rng.integers(0, 2))],
                          {"u": str(rng.integers(0, 6))}),
                  int(rng.integers(0, 4)))
                 for _ in range((1, 2, 8)[step % 3])]
        if step % 4 == 0:
            for st in stores:
                st.update_counter(*items[0])
        else:
            got = [st.apply_deltas(items) for st in stores]
            assert got[0] == got[1], step
        calls += 1
        if step % 10 == 9:
            slots, credits, wins, bucket = [], [], [], []
            for slot, (_key, counter) in stores[0]._table.info.items():
                slots.append(slot)
                credits.append(int(rng.integers(0, 3)))
                wins.append(stores[0]._lane_of(counter)[0])
                bucket.append(stores[0]._lane_of(counter)[1])
            for st in stores:
                st.credit_columnar(np.asarray(slots, np.int32),
                                   np.asarray(credits, np.int32),
                                   np.asarray(wins, np.int32),
                                   np.asarray(bucket, bool))
        clock.now += float(rng.choice([0.0, 0.5, 7.0]))
    assert K.launches["update_host"] == before["update_host"] + calls
    assert K.launches["credit_host"] == before["credit_host"] + 6
    for name in ("update", "credit"):
        assert K.launches[name] == before[name], name
    _equal(stores[0]._state, stores[1]._state)
    for st in stores:
        st.close()


def test_http_server_on_the_card_answers_like_the_cpu(cuda, tmp_path):
    """The HTTP sequence of ``torch_http.py`` (check-and-report with and
    without draft-03 headers, check, report, bad bodies, a hot reload) to
    a ``--device cuda`` server and a ``--device cpu`` one: equal answers,
    ``/counters`` and ``/metrics`` counts; the storage paths launch B2,
    B3a and B5 only as host forms."""
    import asyncio

    from prometheus_client.parser import text_string_to_metric_families

    from limitador_tpu_torch.server import __main__ as port_main

    from . import torch_http as H

    device_forms = ("update", "read_slots", "drain_top_hits", "credit",
                    "clear_slots")

    async def run():
        clock = H.FakeClock()
        path = tmp_path / "limits.yaml"
        path.write_text(H.LIMITS)
        ports = {dev: H.free_port() for dev in ("cuda", "cpu")}
        servers = {}
        try:
            for dev, port in ports.items():
                servers[dev] = await port_main.start(
                    port_main.build_parser().parse_args(H.port_argv(
                        path, "torch", port, "--device", dev,
                        "--limit-name-in-labels", "--metric-labels",
                        H.LABELS)), clock=clock)

            async def reload():
                H.reload_limits_file(path)
                await H.wait_for(lambda: all(
                    any(l.name == "tb-total"
                        for l in s.limiter.get_limits("tb"))
                    for s in servers.values()))

            before = dict(K.launches)
            out = await H.drive(clock, {
                dev: f"http://127.0.0.1:{port}"
                for dev, port in ports.items()}, reload)
            return out, before, dict(K.launches)
        finally:
            for server in servers.values():
                await server.stop()

    out, before, after = asyncio.run(run())
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu["steps"] == cpu["steps"]
    for key in ("limits", "counters", "status"):
        assert gpu[key] == cpu[key], key

    def counts(text):
        return {
            (s.name, tuple(sorted(s.labels.items()))): s.value
            for f in text_string_to_metric_families(text)
            if f.name in ("authorized_calls", "authorized_hits",
                          "limited_calls")
            for s in f.samples if s.name.endswith("_total")
        }

    assert counts(gpu["metrics"]) == counts(cpu["metrics"])
    assert counts(gpu["metrics"])
    moved = {k for k in after if after[k] != before.get(k, 0)}
    assert moved & {"check_and_update", "check_and_update_cluster"}
    assert {"update_host", "read_slots_host"} <= moved
    assert not moved & set(device_forms), moved


def test_native_server_on_the_card_records_like_the_cpu(cuda, tmp_path):
    """The same sequential ShouldRateLimit calls to a ``--device cuda``
    and a ``--device cpu`` native server (hot lane on, recorder and
    native telemetry attached): equal answers, equal recorder counts
    (flushes, queue waits, phase observations, native begins), and
    ``device_backed`` 1 on the card, 0 on the CPU."""
    import asyncio

    import grpc
    from prometheus_client.parser import text_string_to_metric_families

    from limitador_tpu_torch.server import __main__ as port_main
    from limitador_tpu_torch.server.proto import rls_pb2

    from . import torch_http as H

    envoy = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
    limits = tmp_path / "limits.yaml"
    limits.write_text(
        "- namespace: nat\n  max_value: 3\n  seconds: 60\n"
        "  variables: [\"descriptors[0].u\"]\n")

    def blob(i):
        req = rls_pb2.RateLimitRequest(domain="nat")
        req.descriptors.add().entries.add(key="u", value=f"u{i % 4}")
        return req.SerializeToString()

    async def run():
        out = {}
        # one server at a time: the C telemetry plane is process-wide
        for dev in ("cuda", "cpu"):
            argv = H.port_argv(limits, "torch", H.free_port(), "--device",
                               dev, "--pipeline", "native",
                               "--usage-topk", "0",
                               "--native-trace-sample", "4")
            server = await port_main.start(
                port_main.build_parser().parse_args(argv),
                clock=H.FakeClock())
            try:
                rls = argv[argv.index("--rls-port") + 1]
                async with grpc.aio.insecure_channel(
                        f"127.0.0.1:{rls}") as channel:
                    answers = [
                        rls_pb2.RateLimitResponse.FromString(
                            await channel.unary_unary(envoy)(blob(i))
                        ).overall_code
                        for i in range(40)
                    ]
                out[dev] = (answers, server.metrics.render().decode(),
                            server.native_pipeline.lane_stats())
            finally:
                await server.stop()
        return out

    out = asyncio.run(run())

    def counts(text):
        keep = ("batcher_flushes", "batcher_queue_wait",
                "device_phase_latency", "dispatch_chunk_splits",
                "native_phase_hot_lookup", "native_phase_hot_stage")
        return {
            (s.name, tuple(sorted(s.labels.items()))): s.value
            for f in text_string_to_metric_families(text) if f.name in keep
            for s in f.samples
            if s.name.endswith(("_total", "_count"))
        }

    def gauge(text, name):
        return [s.value for f in text_string_to_metric_families(text)
                if f.name == name for s in f.samples][0]

    (gpu_answers, gpu_text, gpu_lane), (cpu_answers, cpu_text, cpu_lane) = (
        out["cuda"], out["cpu"])
    assert gpu_answers == cpu_answers
    assert gpu_answers.count(rls_pb2.RateLimitResponse.OVER_LIMIT) == 28
    assert counts(gpu_text) == counts(cpu_text)
    assert counts(gpu_text)[("batcher_queue_wait_count",
                             (("batcher", "check"),))] == 40
    begins = gpu_lane["hits"] + gpu_lane["misses"]
    assert counts(gpu_text)[("native_phase_hot_lookup_count", ())] == begins
    assert gpu_lane == cpu_lane
    assert gauge(gpu_text, "device_backed") == 1.0
    assert gauge(cpu_text, "device_backed") == 0.0


class _Clock:
    now = 1_700_000_000.0

    def __call__(self):
        return self.now


def _replica_drive(table, users, clock, batch_size=4096):
    """A port cached replica flushing to ``table`` served as the shared
    authority on 127.0.0.1:0: every user once, then a Zipf-like wave,
    one flush after each; the answers and the deltas the authority got."""
    import asyncio

    from limitador_tpu_torch import AsyncRateLimiter
    from limitador_tpu_torch.storage.authority import (
        RemoteAuthority,
        serve_authority,
    )
    from limitador_tpu_torch.storage.cached import CachedCounterStorage

    received = []
    apply = table.apply_deltas

    def recording(items):
        received.append([(c.limit.name, sorted(c.set_variables.items()), d)
                         for c, d in items])
        return apply(items)

    table.apply_deltas = recording
    server = serve_authority(table, "127.0.0.1:0")

    async def main():
        cached = CachedCounterStorage(
            RemoteAuthority(f"127.0.0.1:{server.port}", timeout=60),
            flush_period=3600, batch_size=batch_size, clock=clock)
        limiter = AsyncRateLimiter(cached)
        limiter.add_limit(Limit("ns", 3, 60, [], ["u"], name="user"))
        rng = np.random.default_rng(11)
        weights = 1.0 / np.arange(1, users + 1) ** 0.99
        out = []
        for wave in (np.arange(users),
                     rng.choice(users, size=users, p=weights / weights.sum())):
            for u in wave:
                r = await limiter.check_rate_limited_and_update(
                    "ns", Context({"u": f"u{u}"}), 1)
                out.append(r.limited)
            await cached.flush()
            clock.now += 1.0
        await cached.close()
        return out

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(main()), received
    finally:
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()
        server.stop()
        del table.apply_deltas


@pytest.mark.parametrize("users", [100, 2500])
@pytest.mark.parametrize("kind", ["torch", "sharded"])
def test_a_shared_authority_on_the_card_matches_the_cpu_and_the_oracle(
        cuda, kind, users):
    """Replicas flush to a table on the card served as the shared
    authority: ApplyDeltas runs B2's host form (B7c's on the sharded
    table; past 2,000 entries the staged route) and B3a's read; the
    answers, the deltas and the final table equal a CPU table's, and the
    counters equal an InMemoryStorage fed the same deltas. No check
    kernel launches."""
    from limitador_tpu_torch.device.sharded import TorchShardedStorage
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    update = "update_host" if kind == "torch" else "sharded_update_host"
    out = {}
    for dev in (cuda, "cpu"):
        clock = _Clock()
        if kind == "torch":
            table = TorchStorage(capacity=1 << 14, clock=clock, device=dev)
        else:
            table = TorchShardedStorage(n_shards=8, local_capacity=1 << 11,
                                        global_region=16, clock=clock,
                                        device=dev)
        before = dict(K.launches)
        answers, received = _replica_drive(table, users, clock)
        launched = {k: K.launches[k] - before[k] for k in K.launches}
        oracle = InMemoryStorage(clock=clock)
        limit = Limit("ns", 3, 60, [], ["u"], name="user")
        from limitador_tpu_torch.core.counter import Counter

        for batch in received:
            oracle.apply_deltas([(Counter(limit, dict(v)), d)
                                 for _n, v, d in batch])
        rows = sorted((sorted(c.set_variables.items()), c.remaining)
                      for c in table.get_counters({limit}))
        want = sorted((sorted(c.set_variables.items()), c.remaining)
                      for c in oracle.get_counters({limit}))
        assert rows == want
        out[str(dev)] = (answers, received, rows,
                         [t.cpu() for t in table._state], launched)
        table.close()
    gpu, cpu = out[str(cuda)], out["cpu"]
    assert gpu[:3] == cpu[:3]
    _equal(gpu[3], cpu[3])
    assert max(len(b) for b in gpu[1]) == users
    launched = gpu[4]
    # one warm-up launch before serving, then one a flush
    assert launched[update] == 3 and launched["read_slots_host"] >= 3
    assert not any(launched[k] for k in (
        "check_and_update", "check_and_update_cluster",
        "sharded_check_and_update", "sharded_check_and_update_cluster",
        "update", "sharded_update", "read_slots"))


def test_warm_apply_launches_on_a_table_of_its_own(cuda):
    """``warm_apply`` launches B2's (B7c's) and B3a's host forms once on
    a scratch table and leaves the served table as it was."""
    from limitador_tpu_torch.core.counter import Counter
    from limitador_tpu_torch.device.sharded import TorchShardedStorage

    for table, update in (
            (TorchStorage(capacity=64, device=cuda), "update_host"),
            (TorchShardedStorage(n_shards=2, local_capacity=64,
                                 global_region=4, device=cuda),
             "sharded_update_host")):
        table.apply_deltas([(Counter(Limit("ns", 9, 60, [], ["u"]),
                                     {"u": "a"}), 2)])
        state = [t.cpu().clone() for t in table._state]
        before = dict(K.launches)
        table.warm_apply()
        assert K.launches[update] == before[update] + 1
        assert K.launches["read_slots_host"] == before["read_slots_host"] + 1
        _equal([t.cpu() for t in table._state], state)
        table.close()


def _admission_table(kind, device):
    from limitador_tpu_torch.device.sharded import TorchShardedStorage

    from .torch_admission import hangable

    if kind == "sharded":
        return hangable(TorchShardedStorage)(
            n_shards=2, local_capacity=1 << 8, global_region=8,
            device=device)
    return hangable(TorchStorage)(capacity=1 << 8, device=device)


@pytest.mark.parametrize("kind", ["torch", "sharded"])
@pytest.mark.parametrize("seed", [0, 1])
def test_failover_and_reconcile_on_the_card_match_the_cpu(cuda, kind, seed):
    """A forced trip, seeded checks, reports and reads on the host
    oracle, then the reconcile (B2's, B7c's host form) into a table on
    the card and one on the CPU: equal answers, journals and counters."""
    from .torch_admission import failover_script, port

    pkg = port()
    got = failover_script(pkg, _admission_table(kind, cuda), seed)
    want = failover_script(pkg, _admission_table(kind, "cpu"), seed)
    assert got == want
    assert got["applied"] == len(got["journal"]) > 0


@pytest.mark.parametrize("kind", ["torch", "sharded"])
def test_chaos_drill_on_the_card_matches_the_cpu(cuda, kind):
    """The hang, stall trip, failover, probe (B1, B7a) and reconcile
    (B2, B7c) drill on a table on the card ends where the CPU's does:
    the failover window's answers and the oracle's counters."""
    import asyncio

    from .torch_admission import chaos, port

    pkg = port()
    before = dict(K.launches)
    got = asyncio.run(chaos(pkg, _admission_table(kind, cuda)))
    launched = {k: K.launches[k] - before[k] for k in K.launches}
    want = asyncio.run(chaos(pkg, _admission_table(kind, "cpu")))
    oracle = {("bulk", "bulk", (("u", "shared"),)): 140,
              ("tight", "tight", (("u", "shared"),)): 120}
    assert got["spent"] == want["spent"] == oracle
    assert got["c"] == want["c"] and got["c"].count("ok") == 120
    assert got["closed"] and got["reconciled"] == want["reconciled"] == 2
    assert sum(got["b"].values()) == 40 and got["b"]["over"] == 0
    prefix = "sharded_" if kind == "sharded" else ""
    assert launched[prefix + "update_host"] >= 1
    assert launched[prefix + "check_and_update"] \
        + launched[prefix + "check_and_update_cluster"] >= 1


@pytest.mark.parametrize("mode", ["coded", "uncoded", "off"])
def test_native_ingress_on_the_card_admits_exactly_the_limit(cuda, mode):
    """The native ingress over a table on the card (the pump begins B1 on
    its thread, two finish threads collect): 4,000 calls for one key of
    max 3 from 16 threads on one channel admit exactly 3, 1,000 calls
    over 50 users min(3, calls) each, and the table then equals an
    InMemoryStorage fed the admitted hits."""
    import asyncio
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import grpc

    from limitador_tpu_torch.device import AsyncTorchStorage
    from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
    from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
    from limitador_tpu_torch.native.ingress import NativeIngress
    from limitador_tpu_torch.server.proto import rls_pb2
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    var = "descriptors[0].u"
    limit = Limit("api", 3, 60, ["descriptors[0].m == 'GET'"], [var])
    ok = rls_pb2.RateLimitResponse(
        overall_code=rls_pb2.RateLimitResponse.OK).SerializeToString()

    def blob(user):
        req = rls_pb2.RateLimitRequest(domain="api")
        d = req.descriptors.add()
        d.entries.add(key="m", value="GET")
        d.entries.add(key="u", value=user)
        return req.SerializeToString()

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever)
    thread.start()
    limiter = CompiledTorchLimiter(AsyncTorchStorage(
        TorchStorage(capacity=1 << 12, device=cuda), max_delay=0.001))
    limiter.add_limit(limit)
    pipeline = NativeRlsPipeline(limiter, None, max_delay=0.001,
                                 hot_lane=mode != "off")
    if mode == "uncoded":
        pipeline.lane_code_templates = lambda: None
    launches = K.launches["check_and_update"]
    ing = NativeIngress(pipeline, host="127.0.0.1", port=0, loop=loop,
                        poll_ms=2)
    try:
        assert ing._coded == (mode == "coded")
        with grpc.insecure_channel(f"127.0.0.1:{ing.port}") as channel:
            call = channel.unary_unary(
                "/envoy.service.ratelimit.v3.RateLimitService/"
                "ShouldRateLimit")
            rng = np.random.default_rng(5)
            users = ["dave"] * 4000 + [
                f"u{int(rng.integers(0, 50))}" for _ in range(1000)]
            with ThreadPoolExecutor(16) as pool:
                answers = list(pool.map(
                    lambda u: call(blob(u), timeout=60), users))
        admitted, calls = {}, {}
        for user, answer in zip(users, answers):
            calls[user] = calls.get(user, 0) + 1
            admitted[user] = admitted.get(user, 0) + (answer == ok)
        assert admitted["dave"] == 3
        for user in calls:
            assert admitted[user] == min(3, calls[user]), user
        oracle = RateLimiter(InMemoryStorage())
        oracle.add_limit(limit)
        for user, n in admitted.items():
            ctx = Context()
            ctx.list_binding("descriptors", [{"m": "GET", "u": user}])
            oracle.update_counters("api", ctx, n)
        table = asyncio.run_coroutine_threadsafe(
            limiter.get_counters("api"), loop).result(timeout=60)
        assert ({c.set_variables[var]: c.remaining for c in table}
                == {c.set_variables[var]: c.remaining
                    for c in oracle.get_counters("api")})
        assert K.launches["check_and_update"] > launches
    finally:
        ing.close()

        async def shutdown():
            await pipeline.close()
            await limiter.storage.counters.close()

        asyncio.run_coroutine_threadsafe(shutdown(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.close()
