"""Time kernels of two trees on one card, in alternating turns.

    python -m limitador_tpu_torch.ops.ab OTHER_CHECKOUT [--rounds 2]

Runs on one card. Each turn is a subprocess in one tree (the two trees'
libraries and modules share names) that builds its kernels, checks them
against their plain versions, and prints median times (CUDA events, 50
calls after 5 of warm-up), the inputs made from one numpy seed:

- B1 at H = 8192 and 16,384 hits over a 1<<20-counter table (the call,
  through each tree's own route: the thread-block cluster where the tree
  has it, else the one-block kernel) and B6a at 8192 and 16,384 (the
  call and, from ``torch.profiler``, the kernel alone: ``b6a_kernel_ms``,
  ``b6a_16384_kernel_ms``);
- B7a coupled + global over an [8, 1<<17 + 1] table at 1024 and 2048
  hits a row, through each tree's own route (one cluster over the rows
  where the tree has it, else one block a row with the pre-pass): the
  call (``b7a_1024_ms``, ``b7a_2048_ms``) and the kernels alone
  (``b7a_1024_kernel_ms``, ``b7a_2048_kernel_ms``: every kernel of the
  call, the pre-pass included);
- B7b over an [8, 1<<17 + 1] table: the device-tensor call at [8, 64]
  (``b7b_call_ms``), the same list from a numpy array to the launched
  kernel (``b7b_path_ms``) and one evicted global slot on every row
  from a numpy list (``b7b_evict_ms``);
- B4d at one promoted key (a bucket of 8): the device-tensor call
  (``b4d_call_ms``) and the numpy lists to the launched kernel
  (``b4d_path_ms``);
- B3a through the tree's own ``TorchStorage._read`` on the card: one
  slot from a Python list to the numpy answers (``b3a_path_ms``);
- B6c through the tree's own ``TorchReplicatedStorage._flush_dirty_remote``
  on the card: a dirty map of 12,288 rows to the launched kernel
  (``b6c_path_ms``);
- B3b through the tree's own ``TorchReplicatedStorage`` on the card: a
  gossip merge that adopts 1,000 new keys into recycled slots (each
  adoption's clear launched at once, or staged), then one read of the
  table, which follows every clear (``b3b_path_ms``);
- B5 at k = 64 over a Zipf-0.99 hit column of 1<<20 counters: the
  kernels alone (``b5_kernel_ms``, profiler), the device-tensor call
  (``b5_call_ms``), and the tree's own ``TorchStorage.drain_hot_slots``
  on the card, the drain and the read of the live slots
  (``b5_path_ms``);
- B7c through the tree's own ``TorchShardedStorage.apply_deltas`` on the
  card ([8, 1<<17 + 1]): one Report of 1, 2 and 8 counters, each after
  the counters' first Report (``b7c_path_1_ms``, ``b7c_path_2_ms``,
  ``b7c_path_8_ms``), the answers checked against the same storage on
  the CPU;
- B7d at k = 64 over 8 Zipf-0.99 rows of 1<<17 + 1 cells: the kernels
  alone (``b7d_kernel_ms``, profiler), the device-tensor call
  (``b7d_call_ms``), and the tree's own
  ``TorchShardedStorage.drain_hot_slots`` on the card after a refill of
  the hits, the drain and the read of the live cells (``b7d_path_ms``),
  its records checked against the plain drain;
- B6b through the tree's own ``TorchReplicatedStorage.apply_deltas`` on
  the card: one Report of 1, 2 and 8 token-bucket counters whose remote
  TAT (a peer's spend, gossiped before) floors their advance
  (``b6b_path_1_ms``, ``b6b_path_2_ms``, ``b6b_path_8_ms``), the answers
  checked against the same node on the CPU;
- B2 through the tree's own ``TorchStorage`` on the card: one
  ``update_counter`` of a token bucket (``b2_path_1_ms``, until the
  launch is queued) and one ``apply_deltas`` of 8 counters, windows and
  buckets (``b2_path_8_ms``, the update and the read of the cells), the
  answers checked against the same storage on the CPU;
- B4c through the tree's own ``TorchStorage.credit_columnar`` on the
  card: a settle's 1024 unique rows, half of them buckets
  (``b4c_path_ms``, until the launch is queued), the table checked
  against the same credit on the CPU.

The storage paths are timed on the host clock (``perf_counter_ns``,
median of 500, 200, 20, 200, 500, 200, 500 and 500 calls, the card idle
before each): B3a's path ends with the answers on the host, B6c's, B2's
``update_counter`` and B4c's once the kernel is queued, B3b's with the
read's answers, B5's and B7d's with the records and B7c's, B6b's and
B2's ``apply_deltas`` with the answers (after the update and the read of
the cells).

A "path" time is the tree's own main path from the host list: the host
form (the list in the kernel's parameter block) where the tree has it,
else a pad to the bucket, pinned uploads and the device-tensor call.
The turns go other, this, this, other for each round, so that a drift
of the card over the call shows as a difference between the two turns
of one tree. Prints one JSON line per turn and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_TURN = r'''
import json, sys
import numpy as np
import torch
from limitador_tpu_torch.ops import kernel as K
from limitador_tpu_torch.parallel import mesh as M

C, H, now = 1 << 20, 8192, 5_000_000
rng = np.random.default_rng(6)
dev = torch.device("cuda", 0)
values = rng.integers(0, 60, C + 1).astype(np.int32)
expiry = rng.integers(0, 2 * now, C + 1).astype(np.int32)
hits = rng.integers(0, 1000, C + 1).astype(np.int32)
values[C] = expiry[C] = hits[C] = 0
w = 1.0 / np.arange(1, C + 1) ** 0.99
slots = np.searchsorted(np.cumsum(w), rng.random(H) * w.sum())
cols = (slots.astype(np.int32), rng.integers(0, 3, H).astype(np.int32),
        rng.choice([1, 10, 100], H).astype(np.int32),
        np.full(H, 60_000, np.int32), np.arange(H, dtype=np.int32),
        rng.random(H) < 0.1, np.zeros(H, bool))
rv = np.where(rng.random(C + 1) < 0.5, rng.integers(0, 50, C + 1), 0)
re = rng.integers(0, 2 * now, C + 1)
base = [torch.from_numpy(a).to(dev) for a in (values, expiry, hits)]
args = [torch.from_numpy(a).to(dev) for a in cols]
remote = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (rv, re)]


def table():
    return K.CounterTableState(*(t.clone() for t in base))


def median_ms(fn, setup=table):
    times = []
    for k in range(55):
        t = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(t)
        end.record()
        end.synchronize()
        if k >= 5:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def pinned(*arrays):
    return [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
            for a in arrays]


H2 = 16384
slots2 = np.searchsorted(np.cumsum(w), rng.random(H2) * w.sum())
args2 = [torch.from_numpy(a).to(dev) for a in (
    slots2.astype(np.int32), rng.integers(0, 3, H2).astype(np.int32),
    rng.choice([1, 10, 100], H2).astype(np.int32),
    np.full(H2, 60_000, np.int32), np.arange(H2, dtype=np.int32),
    rng.random(H2) < 0.1, np.zeros(H2, bool))]
b1 = lambda t: K.check_and_update_batch(t, *args, now)
b1_big = lambda t: K.check_and_update_batch(t, *args2, now)
b6a = lambda t: K.replicated_check_batch(t, *remote, *args, now)
b6a_big = lambda t: K.replicated_check_batch(t, *remote, *args2, now)


def kernel_ms(fn, setup=table, reps=10):
    """Device time per call of the kernels fn launches (profiler), each
    call on a fresh table made before the profiled range."""
    from torch.profiler import ProfilerActivity, profile

    tables = [setup() for _ in range(reps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in tables:
            fn(t)
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0.0))
                for e in prof.key_averages() if "kernel" in e.key)
    return total / reps / 1e3 if total > 0 else None


exact = True
for cols_ in (args, args2):
    ta, tb = table(), table()
    _, ra = K.check_and_update_batch(ta, *cols_, now)
    rb = K.check_and_update_plain(tb, *cols_, now)
    exact = exact and all(torch.equal(x, y) for x, y in zip(
        list(ra) + list(ta), list(rb) + list(tb)))
for cols_ in (args, args2):
    ta, tb = table(), table()
    _, ra = K.replicated_check_batch(ta, *remote, *cols_, now)
    rb = K.replicated_check_plain(tb, *remote, *cols_, now)
    exact = exact and all(torch.equal(x, y) for x, y in zip(
        list(ra) + list(ta), list(rb) + list(tb)))

# B7b and B4d: the device-tensor call, and the tree's path from host lists
host = hasattr(K, "TableContext")
n, L, k = 8, 1 << 17, 64
sbase = [torch.from_numpy(a).to(dev) for a in (
    rng.integers(0, 60, (n, L + 1)).astype(np.int32),
    rng.integers(0, 2 * now, (n, L + 1)).astype(np.int32),
    rng.integers(0, 1000, (n, L + 1)).astype(np.int32))]
rows = rng.integers(0, L, (n, k)).astype(np.int32)
rows[rng.random((n, k)) < 0.2] = L
pairs = np.stack([np.repeat(np.arange(n, dtype=np.int32), k),
                  rows.reshape(-1)], axis=1)
evicted = np.asarray([5], np.int32)
seed = (np.asarray([77], np.int32), np.asarray([3], np.int32),
        np.asarray([now + 60_000], np.int32))


def stable():
    return M.ShardedCounterState(*(t.clone() for t in sbase))


def bound(make):
    return lambda: K.TableContext(make(), torch.cuda.current_stream())


def parent_clear(r):
    def launch(t):
        b = max(8, 1 << (r.shape[1] - 1).bit_length())
        padded = np.full((n, b), L, np.int32)
        padded[:, :r.shape[1]] = r
        M.sharded_clear_cells(t, *pinned(padded))
    return launch


def parent_seed(t):
    fills = (C, 0, 0)
    K.seed_slots(t, *pinned(*(np.concatenate([a, np.full(7, f, np.int32)])
                              for a, f in zip(seed, fills))))


def b7a_cols(Hs):
    """Coupled + global [n, Hs] columns: requests of one to three hits on
    random rows (ids < n*Hs) and distinct cells, 30% of hits on global
    slots (< 1024, max 100), the rest Zipf over [1024, L) (max 10 or 100,
    window 60 s)."""
    cols = [[[] for _ in range(n)] for _ in range(8)]
    r = 0
    while True:
        rows_ = rng.integers(0, n, int(rng.integers(1, 4)))
        if any(len(cols[0][x]) + int((rows_ == x).sum()) > Hs - 1
               for x in rows_):
            break
        mine = set()
        for x in rows_:
            glob = rng.random() < 0.3
            slot = (int(rng.integers(0, 1024)) if glob
                    else int(min(1024 + rng.zipf(1.2) - 1, L - 1)))
            if (x, slot) in mine:
                continue
            mine.add((x, slot))
            for c, v in zip(cols, (slot, int(rng.integers(0, 3)),
                                   100 if glob else int(rng.choice([10, 100])),
                                   60_000, r, rng.random() < 0.05, False,
                                   glob)):
                c[x].append(v)
        r += 1
    out = []
    for c, fill, dt in zip(cols, (L, 0, 2**31 - 1, 0, n * Hs - 1, False,
                                  False, False),
                           (np.int32,) * 5 + (bool,) * 3):
        a = np.full((n, Hs), fill, dt)
        for x in range(n):
            a[x, :len(c[x])] = c[x]
        out.append(torch.from_numpy(a).to(dev))
    return out


times = {}
for Hs in (1024, 2048):
    cols_ = b7a_cols(Hs)
    b7a = lambda t, c=cols_: M.sharded_check_and_update(
        t, *c, now, global_region=1024, coupled=True, has_global=True)
    ta, tb = stable(), stable()
    _, ra = b7a(ta)
    rb = M.sharded_check_and_update_plain(tb, *cols_, now, 1024, True, True)
    exact = exact and all(torch.equal(x, y) for x, y in zip(
        list(ra) + list(ta), list(rb) + list(tb)))
    times[f"b7a_{Hs}_ms"] = median_ms(b7a, stable)
    times[f"b7a_{Hs}_kernel_ms"] = kernel_ms(b7a, stable)
    times[f"b7a_{Hs}_route"] = getattr(
        M, "sharded_check_route", lambda *a: "rows")(n, Hs, True, True)

d_rows = torch.from_numpy(rows).to(dev)
d_seed = pinned(*(np.concatenate([a, np.full(7, f, np.int32)])
                  for a, f in zip(seed, (C, 0, 0))))
times.update({
    "b1_ms": median_ms(b1), "b1_16384_ms": median_ms(b1_big),
    "b1_route": getattr(K, "check_route", lambda H: "block")(H),
    "b6a_ms": median_ms(b6a), "b6a_kernel_ms": kernel_ms(b6a),
    "b6a_16384_ms": median_ms(b6a_big),
    "b6a_16384_kernel_ms": kernel_ms(b6a_big),
    "b6a_route": ("cluster" if "replicated_check_cluster" in K.launches
                  else "block"),
    "b7b_call_ms": median_ms(lambda t: M.sharded_clear_cells(t, d_rows),
                             stable),
    "b4d_call_ms": median_ms(lambda t: K.seed_slots(t, *d_seed))})
if host:
    times.update(
        b7b_path_ms=median_ms(
            lambda c: M.sharded_clear_cells_host(c, pairs, False),
            bound(stable)),
        b7b_evict_ms=median_ms(
            lambda c: M.sharded_clear_cells_host(c, evicted, True),
            bound(stable)),
        b4d_path_ms=median_ms(lambda c: K.seed_slots_host(c, *seed, True),
                              bound(table)))
    for run, plain, make in (
            (lambda c: M.sharded_clear_cells_host(c, pairs, False),
             lambda t: M.sharded_clear_cells_host_plain(t, pairs, False),
             stable),
            (lambda c: M.sharded_clear_cells_host(c, evicted, True),
             lambda t: M.sharded_clear_cells_host_plain(t, evicted, True),
             stable),
            (lambda c: K.seed_slots_host(c, *seed, True),
             lambda t: K.seed_slots_host_plain(t, *seed, True), table)):
        ctx, tb = bound(make)(), make()
        run(ctx)
        plain(tb)
        exact = exact and all(torch.equal(x, y)
                              for x, y in zip(ctx.state, tb))
else:
    times.update(
        b7b_path_ms=median_ms(parent_clear(rows), stable),
        b7b_evict_ms=median_ms(
            parent_clear(np.broadcast_to(evicted, (n, 1))), stable),
        b4d_path_ms=median_ms(parent_seed))


# B3a and B6c through each tree's own storage path
import time
from limitador_tpu_torch.device.replicated import TorchReplicatedStorage
from limitador_tpu_torch.device.storage import TorchStorage


def host_ms(fn, setup=None, reps=500, warmup=20):
    spent = []
    for k in range(warmup + reps):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        fn()
        spent.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    return float(np.median(spent[warmup:])) / 1e6


store = TorchStorage(capacity=C, device=dev)
store._state = table()
torch.cuda.synchronize()
one = [int(slots[0])]
with store._lock:
    got = store._read(one, now)
    want = K.read_slots_plain(store._state, torch.tensor(one, dtype=torch.int32,
                                                         device=dev), now)
    exact = exact and all(np.array_equal(g, w.cpu().numpy())
                          for g, w in zip(got, want))
    times["b3a_path_ms"] = host_ms(lambda: store._read(one, now))
node = TorchReplicatedStorage("ab", capacity=C, device=dev)
rows = 12288
dirty = dict(zip(rng.choice(C, rows, replace=False).tolist(),
                 zip(rng.integers(0, 1 << 30, rows).tolist(),
                     rng.integers(0, 1 << 31, rows).tolist())))


def refill():
    node._dirty_remote = dict(dirty)


with node._lock:
    refill()
    node._flush_dirty_remote()
    torch.cuda.synchronize()
    keys = torch.tensor(list(dirty), dtype=torch.long, device=dev)
    exact = exact and all(
        np.array_equal(lane[keys].cpu().numpy(), np.asarray(col, np.int32))
        for lane, col in zip((node._remote_vals, node._remote_exp),
                             zip(*dirty.values())))
    times["b6c_path_ms"] = host_ms(node._flush_dirty_remote, refill, reps=200)
node.close()

# B3b: a merge adopting 1,000 new keys into recycled slots, then a read
from limitador_tpu_torch import Counter, Limit, RateLimiter
from limitador_tpu_torch.storage.keys import key_for_counter

node = TorchReplicatedStorage("ab", capacity=C, cache_size=1000, device=dev)
limit = Limit("ab", 50, 60, [], ["u"])
RateLimiter(node).add_limit(limit)
merges = iter(range(1 << 30))


def merge():
    m = next(merges)
    expires = int(time.time() * 1000) + 60_000
    for i in range(1000):
        key = key_for_counter(Counter(limit, {"u": f"{m}-{i}"}))
        node._on_remote_update(key, {"peer": 3}, expires)
    with node._lock:
        node._read([0], node._now_ms())


times["b3b_path_ms"] = host_ms(merge, reps=20, warmup=2)
node.close()
store.close()

# B5: the kernels, the device-tensor call and the storage's drain
zipf_hits = np.zeros(C + 1, np.int32)
np.add.at(zipf_hits, np.searchsorted(np.cumsum(w),
                                     rng.random(4 * 8192) * w.sum()), 1)
zipf_hits[C] = 3
d_zipf = torch.from_numpy(zipf_hits).to(dev)


def zipf_column():
    return d_zipf.clone()


b5 = lambda h: K.drain_top_hits(h, 64)
ha = zipf_column()
got = b5(ha)
want = K.drain_top_hits_plain(zipf_column(), 64)
exact = exact and all(torch.equal(x, y) for x, y in zip(got, want))
times["b5_kernel_ms"] = kernel_ms(b5, zipf_column)
times["b5_call_ms"] = median_ms(b5, zipf_column)
store = TorchStorage(capacity=C, device=dev)


def refill():
    with store._lock:
        store._state.hits.copy_(d_zipf)


refill()
records = store.drain_hot_slots(64)
exact = exact and [(r["slot"], r["count"]) for r in records] == [
    (int(s), int(c)) for s, c in zip(want[2].tolist(), want[1].tolist())
    if c > 0]
times["b5_path_ms"] = host_ms(lambda: store.drain_hot_slots(64), refill,
                              reps=200)
store.close()

# B7c: one Report through the sharded storage's apply_deltas
from limitador_tpu_torch.device.sharded import TorchShardedStorage

report_limit = Limit("ab", 1 << 20, 60, [], ["u"])
for size in (1, 2, 8):
    stores = [TorchShardedStorage(n_shards=8, local_capacity=1 << 17,
                                  clock=lambda: 1000.0, device=d)
              for d in (dev, "cpu")]
    items = [(Counter(report_limit, {"u": f"{size}-{i}"}), 1 + i % 3)
             for i in range(size)]
    answers = [[s_.apply_deltas(items) for _ in range(3)] for s_ in stores]
    exact = exact and answers[0] == answers[1]
    times[f"b7c_path_{size}_ms"] = host_ms(
        lambda: stores[0].apply_deltas(items), reps=500)
    for s_ in stores:
        s_.close()

# B7d: the kernels, the device-tensor call and the sharded storage's drain
L = 1 << 17
wl = 1.0 / np.arange(1, L - 1024 + 1) ** 0.99
zipf_rows = np.zeros((8, L + 1), np.int32)
for row in zipf_rows:
    np.add.at(row, 1024 + np.searchsorted(
        np.cumsum(wl), rng.random(4 * 1024) * wl.sum()), 1)
zipf_rows[:, L] = 3
d_rows = torch.from_numpy(zipf_rows).to(dev)


def zipf_table():
    return d_rows.clone()


b7d = lambda h: M.sharded_drain_top_hits(h, 64)
got = b7d(zipf_table())
want = M.sharded_drain_top_hits_plain(zipf_table(), 64)
exact = exact and all(torch.equal(x, y) for x, y in zip(got, want))
times["b7d_kernel_ms"] = kernel_ms(b7d, zipf_table)
times["b7d_call_ms"] = median_ms(b7d, zipf_table)
store = TorchShardedStorage(n_shards=8, local_capacity=L, device=dev)


def refill():
    with store._lock:
        store._state.hits.copy_(d_rows)


refill()
records = store.drain_hot_slots(64)
expect = sorted(((int(s_), r, int(c)) for r in range(8)
                 for s_, c in zip(want[2][r].tolist(), want[1][r].tolist())
                 if c > 0), key=lambda x: -x[2])[:64]
exact = exact and [(x["slot"], x["shard"], x["count"])
                   for x in records] == expect
times["b7d_path_ms"] = host_ms(lambda: store.drain_hot_slots(64), refill,
                               reps=200)
store.close()

# B6b: one Report through the replicated storage's apply_deltas, bucket
# counters whose remote TAT (a peer's spend) floors their advance
tb_limit = Limit("ab", 1000, 60, [], ["u"], policy="token_bucket")
for size in (1, 2, 8):
    nodes = [TorchReplicatedStorage("ab", capacity=C, clock=lambda: 1000.0,
                                    device=d) for d in (dev, "cpu")]
    items = [(Counter(tb_limit, {"u": f"{size}-{i}"}), 1 + i % 3)
             for i in range(size)]
    for node_ in nodes:
        RateLimiter(node_).add_limit(tb_limit)
        for i, (counter, _d) in enumerate(items):
            tat = 1_000_000 + 600 * (i + 1)  # ahead of now: tokens spent
            node_._on_remote_update(key_for_counter(counter), {"peer": tat},
                                    tat)
    answers = [[n_.apply_deltas(items) for _ in range(3)] for n_ in nodes]
    exact = exact and answers[0] == answers[1]
    times[f"b6b_path_{size}_ms"] = host_ms(
        lambda: nodes[0].apply_deltas(items), reps=500)
    for n_ in nodes:
        n_.close()

# B2 and B4c through the single table's own storage paths: update_counter
# of one counter, apply_deltas of 8 (the update and the read of the
# cells), credit_columnar of a settle's 1024 unique rows
stores = [TorchStorage(capacity=C, clock=lambda: 1000.0, device=d)
          for d in (dev, "cpu")]
win_limit = Limit("ab", 1 << 20, 60, [], ["u"])
tb_limit = Limit("ab", 1000, 60, [], ["u"], policy="token_bucket")
one = Counter(tb_limit, {"u": "one"})
eight = [(Counter((win_limit, tb_limit)[i % 2], {"u": f"r{i}"}), 1 + i % 3)
         for i in range(8)]
answers = []
for s_ in stores:
    s_.update_counter(one, 2)
    answers.append([s_.apply_deltas(eight) for _ in range(3)])
exact = exact and answers[0] == answers[1]
times["b2_path_1_ms"] = host_ms(lambda: stores[0].update_counter(one, 1),
                                reps=500)
times["b2_path_8_ms"] = host_ms(lambda: stores[0].apply_deltas(eight),
                                reps=500)
credit_slots = rng.choice(C, 1024, replace=False).astype(np.int32)
credit_cols = (credit_slots, rng.integers(0, 300, 1024).astype(np.int32),
               rng.integers(1, 5000, 1024).astype(np.int32),
               rng.random(1024) < 0.5)
for s_ in stores:
    with s_._lock:
        for t, b in zip(s_._state, base):
            t.copy_(b)
torch.cuda.synchronize()  # the copies ran on this thread's stream
for s_ in stores:
    s_.credit_columnar(*credit_cols)
torch.cuda.synchronize()
exact = exact and all(torch.equal(a.cpu(), b) for a, b in zip(
    stores[0]._state, stores[1]._state))
times["b4c_path_ms"] = host_ms(lambda: stores[0].credit_columnar(
    *credit_cols), reps=500)
for s_ in stores:
    s_.close()
print(json.dumps({"tree": sys.argv[1], "host_forms": host, "exact": exact,
                  **times}))
'''


def _turn(tree: str, label: str) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(tree)}
    proc = subprocess.run(
        [sys.executable, "-c", _TURN, label], cwd=tree, env=env,
        capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise SystemExit(f"turn in {tree} failed:\n{proc.stderr}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="the other tree's checkout")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}")
    turns = []
    for _ in range(args.rounds):
        for tree, label in ((args.other, "other"), (here, "this"),
                            (here, "this"), (args.other, "other")):
            turns.append(_turn(tree, label))
    return 0 if all(t["exact"] for t in turns) else 1


if __name__ == "__main__":
    sys.exit(main())
