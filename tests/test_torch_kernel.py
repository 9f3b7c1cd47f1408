"""The port's counter-table kernels against the JAX package's, on the CPU.

For each of the seven kernels on the serving path (the fused check, the
unconditional update, ``read_slots``, ``clear_slots``, the epoch rebase,
the lease credit and the heavy-hitter drain), and the host forms of
``read_slots`` and ``clear_slots``, the same numpy-seeded inputs go
through the jitted JAX function
and through the port's wrapper on CPU tensors, which runs the kernel's
plain PyTorch version. Every output is an integer array, so the tolerance
is exact equality: every output and the final ``values``, ``expiry_ms``
and ``hits``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limitador_tpu.ops import kernel as JK
from limitador_tpu_torch.ops import kernel as TK

from .torch_batches import (
    CHECK_KINDS,
    DRAIN_EDGE_KINDS,
    C,
    NEVER,
    SpyContext,
    check_case,
    credit_batch,
    hits_column,
)
from .torch_batches import batch as _batch
from .torch_batches import lanes as _lanes
from .torch_batches import table as _tables


def _jax_state(values, expiry, hits):
    return JK.CounterTableState(
        jnp.asarray(values), jnp.asarray(expiry), jnp.asarray(hits)
    )


def _torch_state(values, expiry, hits):
    return TK.CounterTableState(
        torch.from_numpy(values.copy()), torch.from_numpy(expiry.copy()),
        torch.from_numpy(hits.copy()),
    )


def _assert_tables(jstate, tstate):
    for name, j, t in zip(TK.CounterTableState._fields, jstate, tstate):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


def _both_check(jstate, tstate, arrays, now_ms):
    jstate, jres = JK.check_and_update_batch(
        jstate, *arrays, np.int32(now_ms)
    )
    tstate, tres = TK.check_and_update_batch(
        tstate, *(torch.from_numpy(a) for a in arrays), now_ms
    )
    for name, j, t in zip(TK.BatchResult._fields, jres, tres):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
    _assert_tables(jstate, tstate)
    return jstate, tstate


@pytest.mark.parametrize("H", [8, 64, 1024])
@pytest.mark.parametrize("seed", range(3))
def test_check_and_update_matches_jax(H, seed):
    rng = np.random.default_rng(1000 * seed + H)
    now_ms = 5_000_000
    n_slots = max(H // 2, 4)
    lanes = _lanes(rng, n_slots)
    table = _tables(rng, now_ms, lanes)
    jstate, tstate = _jax_state(*table), _torch_state(*table)
    for round_i in range(4):
        arrays = _batch(rng, H, lanes, n_slots, zipf=round_i % 2 == 0)
        jstate, tstate = _both_check(jstate, tstate, arrays, now_ms)
        now_ms += int(rng.choice([0, 30, 700, 61_000]))


@pytest.mark.parametrize("kind", CHECK_KINDS)
@pytest.mark.parametrize("H", [8, 1024])
def test_check_edge_batches_match_jax(H, kind):
    """The batches the card tests hold both B1 kernels to (one segment of
    H, a cascade of flipping verdicts, int32 wraps, the mixed batch),
    two rounds on one table: the plain version equals the JAX program,
    whichever route is asked for (on a CPU table both take the plain
    version)."""
    rng = np.random.default_rng(4000 + H + 17 * CHECK_KINDS.index(kind))
    now_ms = 5_000_000
    table, arrays = check_case(rng, H, kind, now_ms)
    jstate = _jax_state(*table)
    tstates = {route: _torch_state(*table) for route in ("block", "cluster")}
    for _round in range(2):
        jstate, jres = JK.check_and_update_batch(jstate, *arrays,
                                                 np.int32(now_ms))
        for route, tstate in tstates.items():
            _, tres = TK.check_and_update_batch(
                tstate, *(torch.from_numpy(a) for a in arrays), now_ms,
                route=route)
            for name, j, t in zip(TK.BatchResult._fields, jres, tres):
                np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                              err_msg=name)
            _assert_tables(jstate, tstate)
        now_ms += 700


@pytest.mark.parametrize("H,route", [
    (1, "block"), (8, "block"), (512, "block"), (1023, "block"),
    (1024, "cluster"), (8192, "cluster"), (16383, "cluster"),
    (16384, "cluster"), (16385, "block"), (32768, "block")])
def test_check_route_is_a_rule_on_the_hit_count(H, route):
    """B1's kernel on the card is a function of H alone: the cluster from
    1024 hits (below it the one-block kernel measured faster) up to its
    capacity of 16 blocks of 1024 hits, the one-block kernel past it."""
    assert TK.CLUSTER_MIN_HITS == 1024
    assert TK.CLUSTER_MAX_HITS == 16 * 1024
    assert TK.check_route(H) == route


@pytest.mark.parametrize("H", [8, 64, 1024])
@pytest.mark.parametrize("seed", range(3))
def test_update_matches_jax(H, seed):
    rng = np.random.default_rng(7000 + 1000 * seed + H)
    now_ms = 5_000_000
    n_slots = max(H // 2, 4)
    lanes = _lanes(rng, n_slots)
    table = _tables(rng, now_ms, lanes)
    jstate, tstate = _jax_state(*table), _torch_state(*table)
    for _round in range(4):
        slots, deltas, _m, wins, _r, fresh, bucket = _batch(
            rng, H, lanes, n_slots
        )
        # large and negative deltas exercise the lane split, the clip at
        # 0, saturation and the bucket horizon clamp
        big = rng.random(H) < 0.1
        deltas = np.where(big, rng.integers(-5, 1 << 30, H), deltas)
        deltas = deltas.astype(np.int32)
        args = (slots, deltas, wins, fresh, bucket)
        jstate = JK.update_batch(jstate, *args, np.int32(now_ms))
        tstate = TK.update_batch(
            tstate, *(torch.from_numpy(a) for a in args), now_ms
        )
        _assert_tables(jstate, tstate)
        now_ms += int(rng.choice([0, 500, 61_000]))


@pytest.mark.parametrize("n", [1, 8, 1024])
def test_read_slots_matches_jax(n):
    rng = np.random.default_rng(n)
    now_ms = 1_000_000
    table = _tables(rng, now_ms, {})
    slots = rng.integers(0, C + 1, n).astype(np.int32)
    jv, jt = JK.read_slots(_jax_state(*table), slots, np.int32(now_ms))
    tv, tt = TK.read_slots(_torch_state(*table), torch.from_numpy(slots),
                           now_ms)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())


def _bucketed(slots):
    """The JAX storage's read list: padded to the pow2 bucket (8 at
    least) with the scratch slot."""
    H = max(8, 1 << (len(slots) - 1).bit_length())
    return np.concatenate([slots, np.full(H - len(slots), C, np.int32)])


def _wrapped(values):
    return np.asarray(values, np.int64).astype(np.int32)


@pytest.mark.parametrize("now_ms", [1_000_000, -(1 << 31), -(1 << 31) + 1,
                                    NEVER - 1, NEVER],
                         ids=["mid", "min", "min+1", "max-1", "max"])
@pytest.mark.parametrize("n", [1, 3, 8, 9, 1000])
def test_read_slots_host_form_matches_jax(n, now_ms):
    """B3a's host form (the bare list) equals ``JK.read_slots`` on the
    list padded to the bucket with the scratch slot, those rows dropped:
    the scratch slot in the list, live and expired cells, cells at the
    clock and at the int32 edges, where ``e - now`` wraps."""
    rng = np.random.default_rng(8000 + n)
    values, expiry, hits = _tables(rng, 1_000_000, {})
    edges = _wrapped([0, 1, NEVER, NEVER - 1, -(1 << 31), now_ms,
                      now_ms + 1, now_ms - 1])
    expiry[:edges.size] = edges
    values[:edges.size] = rng.integers(1, 60, edges.size)
    slots = rng.integers(0, C + 1, n).astype(np.int32)
    k = min(n - 1, edges.size)
    slots[1:1 + k] = np.arange(k)
    slots[0] = C
    jv, jt = JK.read_slots(_jax_state(values, expiry, hits),
                           _bucketed(slots), np.int32(now_ms))
    ctx = TK.TableContext(_torch_state(values, expiry, hits))
    before = dict(TK.launches)
    tv, tt = TK.read_slots_host(ctx, slots, now_ms)
    assert TK.launches == before  # the CPU runs the plain version
    for j, t in ((jv, tv), (jt, tt)):
        assert t.dtype == np.int32 and t.shape == (n,)
        np.testing.assert_array_equal(np.asarray(j)[:n], t)


@pytest.mark.parametrize("n", [1, 7, 8, 20, 1025])
def test_read_slots_host_wrapper_launches_per_block(n):
    """The card path of B3a's host form, through a context that emulates
    the C entry point: one call with the whole list as bytes, launches
    counted per block of 8 slots, the answer buffer grown on demand and
    the answers copied out of it (a later read leaves them as they
    were), equal to the JAX read."""
    rng = np.random.default_rng(8100 + n)
    now_ms = 1_000_000
    table = _tables(rng, now_ms, {})
    ctx = SpyContext(_torch_state(*table), capacity=(8, 4, 3, 8, 3))
    slots = rng.integers(0, C + 1, n).astype(np.int32)
    before = TK.launches["read_slots_host"]
    tv, tt = TK.read_slots_host(ctx, slots, now_ms)
    assert TK.launches["read_slots_host"] == before + -(-n // 8)
    assert ctx.calls == [("read", n)]
    assert ctx.results.shape[0] == max(1024, 1 << (n - 1).bit_length())
    jv, jt = JK.read_slots(_jax_state(*table), _bucketed(slots),
                           np.int32(now_ms))
    TK.read_slots_host(ctx, rng.integers(0, C, n).astype(np.int32),
                       now_ms + 777)
    for j, t in ((jv, tv), (jt, tt)):
        assert t.flags.owndata and t.dtype == np.int32
        np.testing.assert_array_equal(np.asarray(j)[:n], t)
    TK.read_slots_host(ctx, np.zeros(0, np.int32), now_ms)
    assert len(ctx.calls) == 2  # an empty list calls nothing
    ctx.close()
    with pytest.raises(RuntimeError):
        TK.read_slots_host(ctx, slots, now_ms)
    with pytest.raises(ValueError):
        TK.read_slots_host(SpyContext(ctx.state), slots.astype(np.int64),
                           now_ms)


@pytest.mark.parametrize("n", [1, 8, 1024])
def test_clear_slots_matches_jax(n):
    rng = np.random.default_rng(100 + n)
    table = _tables(rng, 1_000_000, {})
    slots = rng.integers(0, C, n).astype(np.int32)  # duplicates included
    jstate = JK.clear_slots(_jax_state(*table), slots)
    tstate = TK.clear_slots(_torch_state(*table), torch.from_numpy(slots))
    _assert_tables(jstate, tstate)


@pytest.mark.parametrize("n", [1, 9, 8001])
def test_clear_slots_host_form_matches_jax(n):
    """B3b's host form on a bare list (duplicates, the scratch slot, a
    list past one parameter block) equals ``JK.clear_slots`` on it:
    through a CPU context (the plain version, no launch) and through a
    context that emulates the C entry point (one call with the list as
    bytes, launches counted per block of 8)."""
    rng = np.random.default_rng(8200 + n)
    table = _tables(rng, 1_000_000, {})
    slots = rng.integers(0, C + 1, n).astype(np.int32)
    slots[0] = C
    slots[-1] = slots[n // 2]
    jstate = JK.clear_slots(_jax_state(*table), slots)
    ctx = TK.TableContext(_torch_state(*table))
    before = dict(TK.launches)
    TK.clear_slots_host(ctx, slots)
    assert TK.launches == before
    _assert_tables(jstate, ctx.state)
    spy = SpyContext(_torch_state(*table), capacity=(8, 4, 3, 8, 3, 8))
    TK.clear_slots_host(spy, slots)
    TK.clear_slots_host(spy, np.zeros(0, np.int32))
    assert spy.calls == [("clear", n)]
    assert TK.launches["clear_slots_host"] == \
        before["clear_slots_host"] + -(-n // 8)
    assert TK.launches["clear_slots"] == before["clear_slots"]
    _assert_tables(jstate, spy.state)
    with pytest.raises(ValueError):
        TK.clear_slots_host(spy, slots.astype(np.int64))
    spy.close()
    with pytest.raises(RuntimeError):
        TK.clear_slots_host(spy, slots)


@pytest.mark.parametrize(
    "shift", [1, 999_000, (1 << 31) - 1, 1 << 31, 5 * (1 << 31) + 17]
)
def test_rebase_epoch_matches_jax(shift):
    rng = np.random.default_rng(shift % 1000)
    expiry = rng.integers(0, NEVER, C + 1).astype(np.int32)
    j = JK.rebase_epoch_chunked(jnp.asarray(expiry), shift)
    t = TK.rebase_epoch_chunked(torch.from_numpy(expiry.copy()), shift)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


# -- hand cases (tests/test_kernel.py's edges, through both packages) --------


def _hand_check(jstate, tstate, slots, deltas, maxes, now_ms=1000,
                windows=None, fresh=None, req_ids=None, bucket=None):
    H = len(slots)
    arrays = (
        np.asarray(slots, np.int32), np.asarray(deltas, np.int32),
        np.asarray(maxes, np.int32),
        np.asarray(windows if windows is not None else [60_000] * H,
                   np.int32),
        np.asarray(req_ids if req_ids is not None else np.arange(H),
                   np.int32),
        np.asarray(fresh if fresh is not None else [False] * H, bool),
        np.asarray(bucket if bucket is not None else [False] * H, bool),
    )
    return _both_check(jstate, tstate, arrays, now_ms)


def _hand_update(jstate, tstate, slots, deltas, windows=None, now_ms=1000):
    H = len(slots)
    args = (
        np.asarray(slots, np.int32), np.asarray(deltas, np.int32),
        np.asarray(windows if windows is not None else [60_000] * H,
                   np.int32),
        np.zeros(H, bool), np.zeros(H, bool),
    )
    jstate = JK.update_batch(jstate, *args, np.int32(now_ms))
    tstate = TK.update_batch(
        tstate, *(torch.from_numpy(a) for a in args), now_ms
    )
    _assert_tables(jstate, tstate)
    return jstate, tstate


def _empty(c=8):
    z = np.zeros(c + 1, np.int32)
    return _jax_state(z, z, z), _torch_state(z, z, z)


def test_hand_update_lane_split_carries_and_saturation():
    js, ts = _empty()
    big = JK.MAX_DELTA_CAP
    js, ts = _hand_update(js, ts, [2, 2, 2, 2], [big] * 4)
    assert int(ts.values[2]) == TK.MAX_VALUE_CAP
    a, b = (1 << 29) - 123, (1 << 29) - 456
    js, ts = _hand_update(js, ts, [1, 1], [a, b])
    assert int(ts.values[1]) == a + b
    deltas = np.random.default_rng(7).integers(1, 5000, 64)
    js, ts = _hand_update(js, ts, [4] * 64, deltas)
    assert int(ts.values[4]) == int(deltas.sum())


def test_hand_check_padding_only_batch_is_inert():
    js, ts = _empty()
    js, ts = _hand_update(js, ts, [1, 2], [5, 7])
    before = [t.clone() for t in ts]
    js, ts = _hand_check(js, ts, [8] * 4, [0] * 4, [NEVER] * 4)
    for b, t in zip(before, ts):
        assert torch.equal(b, t)


def test_hand_check_hot_slot_and_rejections():
    js, ts = _empty()
    js, ts = _hand_check(js, ts, [3] * 64, [1] * 64, [10] * 64)
    assert int(ts.values[3]) == 10
    js, ts = _hand_check(js, ts, [5], [4], [5], now_ms=1000)
    js, ts = _hand_check(js, ts, [5, 5], [3, 3], [5, 5], now_ms=2000)
    js, ts = _hand_check(js, ts, [2], [1], [10], now_ms=1000,
                         windows=[1_000])
    js, ts = _hand_check(js, ts, [2], [0], [10], now_ms=5000,
                         windows=[1_000])
    js, ts = _hand_check(js, ts, [6], [99], [10], now_ms=1000,
                         windows=[2_000], fresh=[True])
    assert int(ts.expiry_ms[6]) == 3000


def test_hand_check_recycled_slot_and_interleaved_segments():
    for bucket, windows, deltas in (
        ([True, True], [100, 100], [1, 1]),
        ([False, False], [60_000, 60_000], [5, 5]),
    ):
        js, ts = _empty()
        js, ts = _hand_check(js, ts, [4], [9], [10], now_ms=1000)
        js, ts = _hand_check(js, ts, [4, 4], deltas, [10, 10],
                             now_ms=1000, windows=windows,
                             fresh=[True, False], bucket=bucket)
    js, ts = _empty()
    js, ts = _hand_check(js, ts, [1, 4, 1, 8, 4, 1], [1, 2, 1, 0, 2, 1],
                         [100, 3, 100, NEVER, 3, 100])
    assert ts.values[:5].tolist() == [0, 3, 0, 0, 2]


def test_hand_check_overcommitted_bucket_floors():
    """A TAT ahead of tau makes (tau - base_rel) negative: the floor
    division must round toward -inf, as jnp does."""
    # B=5, I=200: 8 tokens spent, 3 beyond capacity
    z = np.zeros(9, np.int32)
    e = z.copy()
    e[0] = 1000 + 8 * 200
    js, ts = _jax_state(z, e, z), _torch_state(z, e, z)
    for now in (1000, 1450, 1600, 1799, 1800, 2000):
        js, ts = _hand_check(js, ts, [0, 0], [1, 1], [5, 5], now_ms=now,
                             windows=[200, 200], bucket=[True, True],
                             req_ids=[0, 1])


def test_hand_check_multi_hit_requests_couple():
    js, ts = _empty(16)
    js, ts = _hand_check(
        js, ts, [0, 1, 0, 1, 1, 1], [1] * 6, [1, 2, 1, 2, 2, 2],
        req_ids=[0, 0, 1, 1, 2, 3],
    )
    assert ts.values[:2].tolist() == [1, 2]


# -- B4c: lease credit, B5: heavy-hitter drain --------------------------------


@pytest.mark.parametrize("H", [8, 64, 1024, 4096])
@pytest.mark.parametrize("seed", range(2))
def test_credit_matches_jax(H, seed):
    rng = np.random.default_rng(9000 + 100 * seed + H)
    now_ms = 5_000_000
    table, rows = credit_batch(rng, H, now_ms)
    jstate = JK.credit_batch(_jax_state(*table), *rows, np.int32(now_ms))
    tstate = TK.credit_batch(
        _torch_state(*table), *(torch.from_numpy(a) for a in rows), now_ms,
        check_unique=True,
    )
    _assert_tables(jstate, tstate)
    assert int(tstate.values[C]) == int(tstate.expiry_ms[C]) == 0


def test_credit_refuses_duplicate_slots_when_checking():
    z = np.zeros(C + 1, np.int32)
    rows = (np.array([3, 3], np.int32), np.array([1, 1], np.int32),
            np.array([10, 10], np.int32), np.zeros(2, bool))
    with pytest.raises(ValueError, match="duplicate"):
        TK.credit_batch(_torch_state(z, z, z),
                        *(torch.from_numpy(a) for a in rows), 0,
                        check_unique=True)


DRAIN_KINDS = ("zipf", "sparse", "zero", "wide") + DRAIN_EDGE_KINDS


@pytest.mark.parametrize("k", [1, 4, 64, C])
@pytest.mark.parametrize("kind", DRAIN_KINDS)
def test_drain_top_hits_matches_jax(kind, k):
    rng = np.random.default_rng(k)
    hits = hits_column(rng, kind)
    jh, jc, js = JK.drain_top_hits(jnp.asarray(hits), k)
    th, tc, ts = TK.drain_top_hits(torch.from_numpy(hits.copy()), k)
    for name, j, t in (("hits", jh, th), ("counts", jc, tc),
                       ("slots", js, ts)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
    assert not th.any()


def test_drain_top_hits_refuses_k_out_of_range():
    hits = torch.zeros(C + 1, dtype=torch.int32)
    for k in (0, C + 1):
        with pytest.raises(ValueError):
            TK.drain_top_hits(hits, k)


@pytest.mark.parametrize("k", [1, 7, 64, 1000, 1024, 1025, C])
@pytest.mark.parametrize("kind", DRAIN_KINDS)
def test_drain_top_hits_host_form_matches_jax(kind, k):
    """B5's host form equals ``JK.drain_top_hits`` on every column kind
    (counts rising with the index, all equal, negative and at
    INT_MIN/INT_MAX among them): through a CPU context (the plain twin,
    no launch) and through a context that emulates the C entry point
    (one call with k, one launch counted, the answers copied out of the
    buffer that the next drain overwrites); the column zeroed."""
    rng = np.random.default_rng(8300 + k)
    hits = hits_column(rng, kind)
    _jh, jc, js = JK.drain_top_hits(jnp.asarray(hits), k)
    z = np.zeros(C + 1, np.int32)
    ctx = TK.TableContext(_torch_state(z, z, hits.copy()))
    before = dict(TK.launches)
    tc, ts = TK.drain_top_hits_host(ctx, k)
    assert TK.launches == before
    spy = SpyContext(_torch_state(z, z, hits.copy()))
    sc, ss = TK.drain_top_hits_host(spy, k)
    assert spy.calls == [("drain", k)]
    assert TK.launches["drain_top_hits_host"] == \
        before["drain_top_hits_host"] + 1
    assert TK.launches["drain_top_hits"] == before["drain_top_hits"]
    spy.state.hits.copy_(torch.from_numpy(hits_column(rng, "wide")))
    TK.drain_top_hits_host(spy, k)
    assert sc.flags.owndata and ss.flags.owndata
    for got in ((tc, ts), (sc, ss)):
        for name, j, t in (("counts", jc, got[0]), ("slots", js, got[1])):
            assert t.dtype == np.int32
            np.testing.assert_array_equal(np.asarray(j), t, err_msg=name)
    assert not ctx.state.hits.any() and not spy.state.hits.any()
    for k_bad in (0, C + 1):
        with pytest.raises(ValueError):
            TK.drain_top_hits_host(spy, k_bad)
    spy.close()
    with pytest.raises(RuntimeError):
        TK.drain_top_hits_host(spy, k)
