"""B2's and B4c's host forms against the JAX package's programs, on the CPU.

``update_host`` (B2, the storages' unconditional update) and
``credit_host`` (B4c, the lease broker's credit) take the storage's host
list of (row, slot, delta, window, flags) entries, unpadded, on a bound
``TableContext``. The same numpy-seeded tables and lists go through the
jitted JAX ``update_batch`` and ``credit_batch`` (on the list's columns,
padded to a pow2 bucket of 8 at least with scratch rows, as the JAX
storage pads them) and through the port's host forms: on a CPU context
(the plain twins) and on a ``SpyContext``, which emulates the C entry
points with the plain twins on what the wrapper hands to C. Every output
is an integer array, so the tolerance is exact equality on all three
columns.

Then the storages' paths through ``fake_card`` (every wrapper on its card
path, the kernel library a recorder) and a ``SpyContext`` as the bound
context: ``update_counter``, ``apply_deltas`` (plain and tiered storage)
and a lease settle each make exactly one ``ct_update_host`` or
``ct_credit_host`` call carrying the unpadded list, and none to the
device-tensor entry points ``ct_update`` and ``ct_credit``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limitador_tpu as J
import limitador_tpu_torch as T
from limitador_tpu.core.counter import Counter as JCounter
from limitador_tpu.ops import kernel as JK
from limitador_tpu.tier import TieredStorage as JTiered
from limitador_tpu.tpu import TpuStorage
from limitador_tpu_torch.core.counter import Counter as TCounter
from limitador_tpu_torch.device import TorchStorage
from limitador_tpu_torch.ops import kernel as TK
from limitador_tpu_torch.tier import TieredStorage

from .torch_batches import (
    C,
    NEVER,
    SpyContext,
    credit_list,
    fake_card,
    lanes,
    padded_update_columns,
    table,
    update_entries,
)

#: entries one launch's parameter block carries on the card (nvcc 12.1
#: or later); a longer list is staged, still one launch
CAPACITY = 2000
UPDATE_COUNTS = (1, 2, 8, 33, 129, CAPACITY, CAPACITY + 1)
CREDIT_COUNTS = (1, 1024, CAPACITY, CAPACITY + 1)


def _states(values, expiry, hits):
    jstate = JK.CounterTableState(*(jnp.asarray(a)
                                    for a in (values, expiry, hits)))
    tstate = TK.CounterTableState(*(torch.from_numpy(a.copy())
                                    for a in (values, expiry, hits)))
    return jstate, tstate


def _same_table(jstate, tstate):
    for name, j, t in zip(TK.CounterTableState._fields, jstate, tstate):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


def _context(state, path):
    return TK.TableContext(state) if path == "plain" else SpyContext(state)


def _moved(before):
    return {key: TK.launches[key] - before[key] for key in before
            if TK.launches[key] != before[key]}


# -- B2: update_host ---------------------------------------------------------


def _jax_update(jstate, entries, now_ms):
    """The jitted ``update_batch`` on the list's padded columns."""
    cols = [c[0] for c in padded_update_columns(entries, 1, C)]
    return JK.update_batch(jstate, *cols, np.int32(now_ms))


def _update_table(rng, now_ms, slot_lanes):
    """``table`` with hit counts a few below INT32_MAX on some cells (so
    that a cell's hits wrap) and bucket TATs at the int32 horizon on
    others (so that the advance clamps), among the slots the Zipf lists
    hit most."""
    values, expiry, hits = table(rng, now_ms, slot_lanes)
    hot = np.arange(1, 64)
    hits[hot[rng.random(hot.size) < 0.2]] = NEVER - 2
    buckets = [s for s in hot if slot_lanes[int(s)][0]]
    expiry[buckets[::2]] = NEVER - rng.integers(0, 1000, len(buckets[::2]))
    return values, expiry, hits


@pytest.mark.parametrize("path", ["plain", "card"])
@pytest.mark.parametrize("count", UPDATE_COUNTS)
def test_update_host_form_matches_jax(count, path):
    """B2 from a host list equals the jitted ``update_batch`` on the
    list's padded columns, three rounds over one table: Zipf slots
    (repeated cells, a quarter of the entries on slot 0), 3% of bucket
    flags flipped (cells mixing buckets and windows, the last entry's
    interval taken), 10% fresh, deltas negative and at and past the
    caps (saturation), hits near INT32_MAX (the wrap), bucket TATs at
    the horizon, and a fresh entry after a non-fresh one on one cell at
    the parameter block's capacity. Through a CPU context (no launch)
    and through a context emulating ``ct_update_host`` (one call with
    the list as bytes, one launch counted under ``update_host``)."""
    rng = np.random.default_rng(4400 + count)
    now_ms = 5_000_000
    slot_lanes = lanes(rng, C)
    jstate, tstate = _states(*_update_table(rng, now_ms, slot_lanes))
    ctx = _context(tstate, path)
    for _round in range(3):
        entries = update_entries(rng, count, 1, C, 1, slot_lanes,
                                 straddle=min(count - 1, CAPACITY))
        if count >= CAPACITY and _round == 0:  # the cases occur
            slots, flags = entries[:, 1], entries[:, 4]
            assert np.unique(slots).size < count
            assert (flags & 1).any() and (flags & 2).any()
            assert (entries[:, 2] >= TK.MAX_DELTA_CAP).any()
            assert (entries[:, 2] < 0).any()
            expiry = ctx.state.expiry_ms.numpy()
            assert ((flags & 2 > 0) & (expiry[slots] > NEVER - 1000)).any()
            assert (ctx.state.hits.numpy()[slots] > NEVER - 3).any()
        jstate = _jax_update(jstate, entries, now_ms)
        before = dict(TK.launches)
        assert TK.update_host(ctx, entries, now_ms) is ctx.state
        assert _moved(before) == ({} if path == "plain"
                                  else {"update_host": 1})
        _same_table(jstate, ctx.state)
        now_ms += int(rng.choice([0, 500, 61_000]))
    if path == "card":
        assert ctx.calls == [("table_update", count)] * 3
        assert all(a.shape == (count, 5) for a in ctx.lists)


def test_update_host_form_hand_cells():
    """Hand cells through the host form's twin and the JAX program:
    deltas summing past MAX_VALUE_CAP (saturated, whichever way the sum
    is formed: the JAX program's 8-bit lanes, the kernel's 64-bit sum),
    a negative delta (clipped at 0), a window cell whose entries carry
    different windows (the expiry takes the largest), a cell of a
    window entry then a bucket entry and one of a bucket then a window
    entry (the last entry's lane and interval decide), a fresh entry
    after a live one (the cell restarts, its hits too), a bucket at the
    int32 horizon (the advance clamps), hits at INT32_MAX (they wrap)
    and a scratch cell that starts dirty (it ends at 0). An empty list
    changes nothing."""
    now_ms = 2_000_000
    I = 1000
    values = np.zeros(C + 1, np.int32)
    expiry = np.zeros(C + 1, np.int32)
    hits = np.full(C + 1, 3, np.int32)
    values[C], expiry[C], hits[C] = 5, 6, 7
    expiry[[10, 11, 12, 13, 14]] = now_ms + 60_000  # live windows
    values[[10, 11, 12, 13, 14]] = (7, 0, 4, 9, 2)
    expiry[15] = NEVER - 10  # TAT at the horizon
    hits[16] = NEVER
    expiry[16] = now_ms + 60_000
    entries = np.asarray([
        [0, 10, (1 << 30) - 1, 60_000, 0],
        [0, 10, NEVER, 60_000, 0],
        [0, 11, -5, 60_000, 0],
        [0, 12, 1, 1_000, 1],  # fresh: the window restarts
        [0, 12, 2, 90_000, 0],
        [0, 13, 1, 60_000, 0],
        [0, 13, 2, I, 2],  # window then bucket: a bucket at I
        [0, 14, 3, I, 2],
        [0, 14, 4, 60_000, 0],  # bucket then window: a live window
        [0, 15, 5, I, 2],
        [0, 16, 1, 60_000, 0],
    ], np.int32)
    jstate, tstate = _states(values, expiry, hits)
    jstate = _jax_update(jstate, entries, now_ms)
    TK.update_host(TK.TableContext(tstate), entries, now_ms)
    _same_table(jstate, tstate)
    v, e, h = (t.numpy() for t in tstate)
    assert v[10] == 1 << 30  # saturated at the cap
    assert v[11] == 0 and e[11] == now_ms + 60_000  # clipped delta
    assert v[12] == 3 and e[12] == now_ms + 90_000 and h[12] == 2
    # a bucket now: the window's end is read as its TAT, 3 tokens on
    assert v[13] == 0 and e[13] == now_ms + 60_000 + 3 * I
    assert v[14] == 9 and e[14] == now_ms + 60_000  # a live window
    assert e[15] > NEVER - 10 - I  # clamped below the horizon
    assert h[16] == -(1 << 31)  # two's-complement wrap
    assert v[C] == e[C] == h[C] == 0
    before = [t.clone() for t in tstate]
    TK.update_host(TK.TableContext(tstate), np.zeros((0, 5), np.int32),
                   now_ms)
    for t, b in zip(tstate, before):
        assert torch.equal(t, b)


@pytest.mark.parametrize("bad", [[0, C, 1, 1000, 0], [0, -1, 1, 1000, 0],
                                 [1, 3, 1, 1000, 0]])
def test_update_host_form_refuses_cells_past_the_table(bad):
    """The host form has no padding: an entry of the scratch slot, of a
    negative slot or of a row other than 0 raises, as does a list of the
    wrong shape or type; the table is left as it was."""
    state = TK.make_table(C, "cpu")
    ctx = TK.TableContext(state)
    with pytest.raises(ValueError):
        TK.update_host(ctx, np.asarray([[0, 3, 1, 1000, 0], bad], np.int32),
                       0)
    for wrong in (np.zeros((2, 4), np.int32), np.zeros((2, 5), np.int64)):
        with pytest.raises(ValueError):
            TK.update_host(ctx, wrong, 0)
    assert not any(t.any() for t in state)


# -- B4c: credit_host --------------------------------------------------------


@pytest.mark.parametrize("path", ["plain", "card"])
@pytest.mark.parametrize("count", CREDIT_COUNTS)
def test_credit_host_form_matches_jax(count, path):
    """B4c from the broker's list equals the jitted ``credit_batch`` on
    the padded columns, on a table whose scratch cell starts dirty, with
    the edge rows (an expired window, an expired bucket, a credit that
    covers exactly, one short, credit x interval past int32, a window
    floored at 0, negative credits): through a CPU context and through a
    context emulating ``ct_credit_host`` (one call, one launch counted
    under ``credit_host``); the hits column untouched."""
    now_ms = 5_000_000
    tbl, entries, rows = credit_list(np.random.default_rng(5100 + count),
                                     count, now_ms)
    jstate, tstate = _states(*tbl)
    ctx = _context(tstate, path)
    jstate = JK.credit_batch(jstate, *rows, np.int32(now_ms))
    before = dict(TK.launches)
    assert TK.credit_host(ctx, entries, now_ms, check_unique=True) \
        is ctx.state
    assert _moved(before) == ({} if path == "plain"
                              else {"credit_host": 1})
    _same_table(jstate, ctx.state)
    np.testing.assert_array_equal(ctx.state.hits.numpy(), tbl[2])
    assert int(ctx.state.values[C]) == int(ctx.state.expiry_ms[C]) == 0
    if path == "card":
        assert ctx.calls == [("credit", count)]
        np.testing.assert_array_equal(ctx.lists[0], entries)


def test_credit_host_form_hand_cells():
    """Hand cells through the host form's twin and the JAX program, one
    a line: a live window debited below 0 (floored), an expired window
    (untouched), a bucket whose credit covers exactly the intervals
    ahead (back to now), one short (retreats by credit x interval), an
    expired bucket (untouched), a credit x interval past int32 on a TAT
    at INT32_MAX (covers: now), and a negative credit (the window grows,
    the bucket's TAT advances by the wrapping product). The hits column
    and every other cell stay; the dirty scratch cell ends at 0."""
    now_ms = 1_000_000
    values = np.zeros(C + 1, np.int32)
    expiry = np.zeros(C + 1, np.int32)
    hits = np.arange(C + 1, dtype=np.int32)
    values[C], expiry[C] = 77, 12345
    cells = [  # slot, value, expiry, credit, interval, bucket
        (1, 5, now_ms + 10, 9, 60_000, False),
        (2, 5, now_ms, 3, 60_000, False),
        (3, 0, now_ms + 1000, 10, 100, True),
        (4, 0, now_ms + 1001, 9, 100, True),
        (5, 0, now_ms - 1, 3, 100, True),
        (6, 0, NEVER, 1 << 30, 1 << 20, True),
        (7, 5, now_ms + 10, -7, 1000, False),
        (8, 0, now_ms + 5000, -3, 1 << 30, True),
    ]
    entries = np.zeros((len(cells), 5), np.int32)
    for i, (slot, v, e, c, w, b) in enumerate(cells):
        values[slot], expiry[slot] = v, e
        entries[i] = (0, slot, c, w, 2 if b else 0)
    jstate, tstate = _states(values, expiry, hits)
    pad = np.zeros((8 - len(cells), 5), np.int32)
    pad[:, 1] = C
    cols = np.concatenate([entries, pad])
    jstate = JK.credit_batch(jstate, cols[:, 1], cols[:, 2], cols[:, 3],
                             cols[:, 4] > 0, np.int32(now_ms))
    TK.credit_host(TK.TableContext(tstate), entries, now_ms)
    _same_table(jstate, tstate)
    v, e, h = (t.numpy() for t in tstate)
    assert v[1] == 0 and v[2] == 5 and v[7] == 12
    assert e[3] == now_ms and e[4] == now_ms + 101 and e[5] == now_ms - 1
    assert e[6] == now_ms
    # now + 5000 - (-3 x 2^30), wrapped as XLA's int32 wraps
    assert e[8] == (now_ms + 5000 + 3 * (1 << 30) + (1 << 31)) % (1 << 32) \
        - (1 << 31)
    np.testing.assert_array_equal(h, hits)
    assert v[C] == e[C] == 0
    before = [t.clone() for t in tstate]
    TK.credit_host(TK.TableContext(tstate), np.zeros((0, 5), np.int32),
                   now_ms)
    for t, b in zip(tstate, before):
        assert torch.equal(t, b)


@pytest.mark.parametrize("bad", [[0, C, 1, 1000, 0], [0, -1, 1, 1000, 0],
                                 [1, 3, 1, 1000, 0]])
def test_credit_host_form_refuses_cells_past_the_table(bad):
    """An entry of the scratch slot, of a negative slot or of a row other
    than 0 raises; so do a list of the wrong shape or type and, under
    ``check_unique``, a duplicate slot; the table is left as it was."""
    state = TK.make_table(C, "cpu")
    ctx = TK.TableContext(state)
    with pytest.raises(ValueError):
        TK.credit_host(ctx, np.asarray([[0, 3, 1, 1000, 0], bad], np.int32),
                       0)
    for wrong in (np.zeros((2, 4), np.int32), np.zeros((2, 5), np.int64)):
        with pytest.raises(ValueError):
            TK.credit_host(ctx, wrong, 0)
    twice = np.asarray([[0, 3, 1, 1000, 0], [0, 3, 2, 1000, 0]], np.int32)
    with pytest.raises(ValueError, match="duplicate"):
        TK.credit_host(ctx, twice, 0, check_unique=True)
    assert not any(t.any() for t in state)


# -- the storages' paths: one host-form call each -----------------------------


class _Clock:
    def __init__(self):
        self.now = 1_700_000_000.0

    def __call__(self):
        return self.now


def _limit_pairs():
    """(JAX limit, port limit) pairs: a fixed window, a token bucket, and
    a limit beyond the device's caps (decided on the host)."""
    specs = (dict(max_value=30, seconds=60, name="win"),
             dict(max_value=6, seconds=60, name="bucket",
                  policy="token_bucket"),
             dict(max_value=1 << 40, seconds=60, name="big"))
    return [tuple(P.Limit("ns", s["max_value"], s["seconds"], [], ["u"],
                          **{k: v for k, v in s.items()
                             if k in ("name", "policy")})
                  for P in (J, T)) for s in specs]


def _spied(storage, monkeypatch):
    """The storage's bound context swapped for a ``SpyContext`` over its
    table, and every wrapper on its card path (``fake_card``): returns
    (spy, recording library)."""
    spy = SpyContext(storage._ctx.state)
    storage._ctx = spy
    return spy, fake_card(monkeypatch)


def _assert_no_device_tensor_update(lib, before):
    names = lib.names()
    assert "ct_update" not in names and "ct_credit" not in names, names
    assert TK.launches["update"] == before["update"]
    assert TK.launches["credit"] == before["credit"]


def _same_storage_table(jstorage, tstorage):
    for name, j, t in zip(TK.CounterTableState._fields, jstorage._state,
                          tstorage._ctx.state):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


@pytest.mark.parametrize("kind", ["plain", "tiered"])
def test_update_counter_is_one_update_host_call(monkeypatch, kind):
    """``update_counter`` of a device counter is one ``ct_update_host``
    call carrying its one entry (no padding to 8), a new counter's fresh
    flag and a bucket's flag set; a counter beyond the caps launches
    nothing. The table equals the JAX storage's after every call."""
    clock = _Clock()
    if kind == "plain":
        js = TpuStorage(capacity=64, clock=clock)
        ts = TorchStorage(capacity=64, clock=clock, device="cpu")
    else:
        js = JTiered(capacity=64, cache_size=8, clock=clock)
        ts = TieredStorage(capacity=64, cache_size=8, clock=clock,
                           device="cpu")
    spy, lib = _spied(ts, monkeypatch)
    before = dict(TK.launches)
    pairs = _limit_pairs()
    expected = []
    for step in range(12):
        jl, tl = pairs[step % 3]
        user = {"u": str(step % 5)}
        js.update_counter(JCounter(jl, dict(user)), 1 + step % 4)
        ts.update_counter(TCounter(tl, dict(user)), 1 + step % 4)
        if tl.name != "big":
            expected.append(("table_update", 1))
        assert spy.calls == expected
        _same_storage_table(js, ts)
        clock.now += 7.0
    flags = [int(a[0, 4]) for a in spy.lists]
    assert 1 in flags and 3 in flags  # a new window, a new bucket
    assert all(a.shape == (1, 5) and a[0, 0] == 0 for a in spy.lists)
    _assert_no_device_tensor_update(lib, before)
    assert TK.launches["update_host"] == before["update_host"] + len(
        expected)


@pytest.mark.parametrize("kind", ["plain", "tiered"])
def test_apply_deltas_is_one_update_host_call(monkeypatch, kind):
    """Every ``apply_deltas`` with a device counter is one
    ``ct_update_host`` call carrying each device counter's entry once, in
    item order, unpadded (1, 2 and 8 counters: windows, buckets, the
    same counter twice), and one B3a read; beyond-cap counters, and on
    the tiered storage the cold ones (its LRU evictions demote), stay on
    the host. The answers and the table equal, after every call, the JAX
    storage's (plain) or those of the same tiered storage on a CPU
    context (tiered: at step 26 an item's slot demotes a later item's
    counter; the port promotes it back through B4d and keeps its count,
    where the JAX tiered storage counts it from zero)."""
    clock = _Clock()
    if kind == "plain":
        ref = TpuStorage(capacity=64, clock=clock)
        ts = TorchStorage(capacity=64, clock=clock, device="cpu")
    else:
        ref = TieredStorage(capacity=64, cache_size=8, clock=clock,
                            device="cpu")
        ts = TieredStorage(capacity=64, cache_size=8, clock=clock,
                           device="cpu")
    spy, lib = _spied(ts, monkeypatch)
    before = dict(TK.launches)
    pairs = _limit_pairs()
    rng = np.random.default_rng(31)
    host_items = 0
    for step in range(30):
        size = (1, 2, 8)[step % 3]
        picks = [(pairs[int(rng.integers(0, 3))], str(rng.integers(0, 9)))
                 for _ in range(size)]
        deltas = [int(rng.integers(0, 4)) for _ in picks]
        Ref = JCounter if kind == "plain" else TCounter
        ritems = [(Ref(p[0 if kind == "plain" else 1], {"u": u}), d)
                  for (p, u), d in zip(picks, deltas)]
        titems = [(TCounter(p[1], {"u": u}), d)
                  for (p, u), d in zip(picks, deltas)]
        on_device = [c for c, _d in titems if not ts._is_big(c)]
        host_items += size - len(on_device)
        n_calls, n_lists = len(spy.calls), len(spy.lists)
        assert ts.apply_deltas(titems) == ref.apply_deltas(ritems), step
        calls = spy.calls[n_calls:]
        if on_device:
            # beside B4d's seeds (a key an earlier item's slot demoted,
            # promoted back) and B3a's read
            assert [c for c in calls if c[0] not in ("read", "seed")] == [
                ("table_update", len(on_device))], step
            assert calls[-1] == ("read", len(on_device)), step
            entries = spy.lists[-1]
            assert entries[:, 1].tolist() == [
                ts._table.lookup(ts._key_of(c), True) for c in on_device]
        else:
            assert calls == [] and len(spy.lists) == n_lists
        for name, r, t in zip(TK.CounterTableState._fields, ref._state,
                              ts._ctx.state):
            np.testing.assert_array_equal(np.asarray(r), t.numpy(),
                                          err_msg=name)
        clock.now += float(rng.choice([0.0, 3.0, 61.0]))
    assert host_items > 0
    if kind == "tiered":
        assert ts._cold.cells, "no counter was demoted"
    _assert_no_device_tensor_update(lib, before)


def _settle(spied, monkeypatch):
    """The lease contract's settle (a hot user driven, leases refreshed,
    one leased token spent, the clock past the ttl, one refresh that
    revokes and credits) on a CPU pipeline; with ``spied`` the settle's
    refresh runs with a ``SpyContext`` bound and every wrapper on its
    card path. Returns (table arrays, broker stats, spy, library)."""
    from limitador_tpu_torch.device import AsyncTorchStorage
    from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
    from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
    from limitador_tpu_torch.lease import LeaseConfig
    from limitador_tpu_torch.server.proto import rls_pb2

    clock = _Clock()
    storage = TorchStorage(capacity=1 << 12, clock=clock, device="cpu")
    limiter = CompiledTorchLimiter(AsyncTorchStorage(storage,
                                                     max_delay=0.001))
    limiter.add_limit(T.Limit("api", 1000, 60, [], ["descriptors[0].u"],
                              name="per-user"))
    pipeline = NativeRlsPipeline(limiter, max_delay=0.001, hot_lane=True)
    broker = pipeline.attach_lease(
        LeaseConfig(max_tokens=64, hot_threshold=2, ttl_s=5.0),
        autostart=False)
    broker._clock = clock
    blobs = []
    for user in ("hot", "warm", "hot", "cold", "hot", "warm"):
        req = rls_pb2.RateLimitRequest(domain="api")
        req.descriptors.add().entries.add(key="u", value=user)
        blobs.append(req.SerializeToString())
    for _ in range(3):
        pipeline.decide_many(blobs, chunk=len(blobs))
        broker.refresh()
    pipeline.decide_many(blobs[:2], chunk=2)  # spend leased tokens
    assert broker.stats()["lease_outstanding_tokens"] > 0
    spy = lib = None
    if spied:
        spy, lib = _spied(storage, monkeypatch)
    clock.now += 6.0  # past the ttl: the sweep revokes and credits
    broker.refresh()
    stats = broker.stats()
    arrays = [t.numpy().copy() for t in storage._ctx.state]
    broker.close()
    return arrays, stats, spy, lib


def test_a_lease_settle_is_one_credit_host_call(monkeypatch):
    """A settle's credits reach the table as one ``ct_credit_host`` call
    carrying one entry per credited counter (the broker's aggregate,
    unpadded, buckets flagged in bit 1), and none through ``ct_credit``;
    the table and the broker's books equal the same settle's on a plain
    CPU context, and nothing stays outstanding."""
    want_arrays, want_stats, _spy, _lib = _settle(False, monkeypatch)
    before = dict(TK.launches)
    arrays, stats, spy, lib = _settle(True, monkeypatch)
    credits = [c for c in spy.calls if c[0] == "credit"]
    assert len(credits) == 1 and len(spy.lists) == 1
    entries = spy.lists[0]
    assert credits[0] == ("credit", entries.shape[0]) and entries.shape[0] >= 1
    assert (entries[:, 0] == 0).all() and (entries[:, 2] > 0).all()
    assert np.unique(entries[:, 1]).size == entries.shape[0]
    assert stats == want_stats and stats["lease_outstanding_tokens"] == 0
    for a, b in zip(arrays, want_arrays):
        np.testing.assert_array_equal(a, b)
    _assert_no_device_tensor_update(lib, before)
    assert TK.launches["credit_host"] == before["credit_host"] + 1
