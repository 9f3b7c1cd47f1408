"""Numpy-seeded counter tables and hit batches for the port's tests.

Shared by ``test_torch_kernel.py`` and ``test_torch_tier.py`` (the port
against the JAX package on the CPU) and ``test_torch_gpu.py`` (the CUDA
kernels against their plain versions on the card); imports numpy only
(``SpyContext`` imports the port when called), so the card's machine,
which has no JAX, can import it.
"""

import weakref

import numpy as np

C = 4096
NEVER = np.iinfo(np.int32).max


def table(rng, now_ms, lanes):
    """A mid-stream table: live and expired windows, live, full and
    overcommitted bucket TATs, and hit counts."""
    values = rng.integers(0, 60, C + 1).astype(np.int32)
    expiry = rng.integers(0, 2 * now_ms, C + 1).astype(np.int32)
    hits = rng.integers(0, 1000, C + 1).astype(np.int32)
    for slot, (is_bucket, maxv, win) in lanes.items():
        if is_bucket:
            # TAT from "full" (in the past) to overcommitted by a few tokens
            ahead = int(rng.integers(-3, maxv + 4)) * win
            expiry[slot] = max(now_ms + ahead, 0)
    values[C] = expiry[C] = hits[C] = 0
    return values, expiry, hits


def lanes(rng, n_slots):
    """Per-slot (bucket?, max, window-or-interval), consistent across
    batches the way the storage keeps them."""
    lanes = {}
    for slot in range(n_slots):
        if rng.random() < 0.3:
            maxv = int(rng.integers(1, 20))
            lanes[slot] = (True, maxv, int(rng.integers(1, 500)))
        else:
            maxv = int(rng.choice([1, 3, 10, 50, 1000]))
            lanes[slot] = (False, maxv, int(rng.choice([1000, 60_000])))
    return lanes


def batch(rng, H, lanes, n_slots, zipf=True):
    """Request-ordered hits padded to H: hot (Zipf) slots, multi-hit
    requests, fresh (recycled) slots and padding rows."""
    slots, deltas, maxes, wins, req, fresh, bucket = ([] for _ in range(7))
    n_real = int(rng.integers(max(H // 2, 1), H + 1))
    seen = set()
    r = 0
    while len(slots) < n_real and r < H - 1:
        k = min(int(rng.integers(1, 4)), n_real - len(slots))
        for _ in range(k):
            if zipf:
                s = int(min(rng.zipf(1.3) - 1, n_slots - 1))
            else:
                s = int(rng.integers(0, n_slots))
            is_bucket, maxv, win = lanes[s]
            slots.append(s)
            deltas.append(int(rng.choice([0, 1, 1, 1, 2, 5, 7])))
            maxes.append(maxv)
            wins.append(win)
            req.append(r)
            fresh.append(s not in seen and rng.random() < 0.15)
            bucket.append(is_bucket)
            seen.add(s)
        r += 1
    pad = H - len(slots)
    arrays = (
        np.asarray(slots + [C] * pad, np.int32),
        np.asarray(deltas + [0] * pad, np.int32),
        np.asarray(maxes + [NEVER] * pad, np.int32),
        np.asarray(wins + [0] * pad, np.int32),
        np.asarray(req + [H - 1] * pad, np.int32),
        np.asarray(fresh + [False] * pad, bool),
        np.asarray(bucket + [False] * pad, bool),
    )
    return arrays


CHECK_KINDS = ("mixed", "one_slot", "cascade", "wraps")


def check_case(rng, H, kind, now_ms):
    """A table and an H-hit B1 batch of one ``kind``:

    - "mixed": ``batch`` over ``lanes``: hot slots, multi-hit requests,
      buckets, fresh slots and scratch padding;
    - "one_slot": every hit on one window slot, one segment of H, in
      requests of 1-3 hits, the max a third of the way in;
    - "cascade": request r hits slots r and r + 1 (a fresh window of max
      1, delta 1), so each verdict flips the next one's: about one sweep
      per request until the fixpoint settles, then scratch padding;
    - "wraps": live window cells near 2**31, deltas up to 2**30 and
      maxes near INT32_MAX, so value + pending + delta wraps int32.
    """
    if kind == "mixed":
        n_slots = min(max(H // 2, 4), 4000)
        slot_lanes = lanes(rng, n_slots)
        return (table(rng, now_ms, slot_lanes),
                batch(rng, H, slot_lanes, n_slots))
    values, expiry, hits = table(rng, now_ms, {})
    slots = np.full(H, C, np.int32)
    deltas = np.zeros(H, np.int32)
    maxes = np.full(H, NEVER, np.int32)
    wins = np.zeros(H, np.int32)
    req = np.full(H, H - 1, np.int32)
    fresh = np.zeros(H, bool)
    bucket = np.zeros(H, bool)
    if kind == "one_slot":
        s = int(rng.integers(0, C))
        values[s], expiry[s] = 3, now_ms + 5_000
        slots[:] = s
        deltas[:] = rng.choice([0, 1, 1, 2], H)
        maxes[:] = max(H // 3, 1)
        wins[:] = 60_000
        req[:] = np.sort(rng.integers(0, H, H))
        req[0] = 0
    elif kind == "cascade":
        # the chain on slots [base, base + n_req], then one-hit filler
        # requests (delta 0) on slots below and above it, so that the
        # chain sits mid-batch in sorted order, across a block boundary
        # of the cluster kernel at H >= 2048
        n_req = min(H // 2, 300)
        base = C // 2
        r = np.repeat(np.arange(n_req, dtype=np.int32), 2)
        slots[:r.size] = base + r + np.tile(np.asarray([0, 1], np.int32),
                                            n_req)
        deltas[:r.size] = 1
        maxes[:r.size] = 1
        wins[:r.size] = 60_000
        req[:r.size] = r
        fresh[:r.size] = True
        n_fill = H - r.size - (1 if H > r.size else 0)
        below = rng.integers(0, base, n_fill)
        above = rng.integers(base + n_req + 1, C, n_fill)
        fill = np.where(np.arange(n_fill) % 2 == 0, below, above)
        slots[r.size:r.size + n_fill] = fill
        wins[r.size:r.size + n_fill] = 1000
        req[r.size:r.size + n_fill] = n_req + np.arange(n_fill)
    elif kind == "wraps":
        s = rng.integers(0, 64, H).astype(np.int32)
        values[:64] = NEVER - rng.integers(0, 1 << 20, 64)
        expiry[:64] = now_ms + rng.integers(1, 60_000, 64)
        order = np.argsort(rng.random(H), kind="stable")
        slots[:] = s[order]
        deltas[:] = rng.integers(0, (1 << 30) + 1, H)
        maxes[:] = NEVER - rng.integers(0, 1 << 10, H)
        wins[:] = 60_000
        req[:] = np.sort(rng.integers(0, H, H))
        req[0] = 0
    else:
        raise ValueError(kind)
    return (values, expiry, hits), (slots, deltas, maxes, wins, req, fresh,
                                    bucket)


def credit_batch(rng, H, now_ms, n_slots=C, n_real=None):
    """A table and an H-row credit batch (unique slots, padding rows at
    the scratch row) with the edge rows of the lease credit: an expired
    window, an expired bucket, a covering credit, a credit whose
    credit * interval exceeds int32 (the wrap guard), negative credits,
    and a scratch row that starts non-zero. ``n_real`` real rows (by
    default an eighth of H, at least one, is padding); the edge rows come
    first."""
    values = rng.integers(0, 200, C + 1).astype(np.int32)
    expiry = rng.integers(0, 2 * now_ms, C + 1).astype(np.int32)
    hits = rng.integers(0, 1000, C + 1).astype(np.int32)
    values[C], expiry[C], hits[C] = 77, 12345, 9  # garbage in scratch
    if n_real is None:
        n_real = max(H - max(H // 8, 1), 1)
    slots = rng.choice(n_slots, n_real, replace=False).astype(np.int32)
    credits = rng.integers(0, 300, n_real).astype(np.int32)
    windows = rng.integers(1, 5000, n_real).astype(np.int32)
    bucket = rng.random(n_real) < 0.5
    # live buckets: TAT a few intervals ahead of now
    ahead = rng.integers(0, 400, n_real) * windows
    expiry[slots] = np.where(
        bucket, np.minimum(now_ms + ahead, NEVER), expiry[slots]
    ).astype(np.int32)
    edges = [
        # (bucket, expiry, credit, window)
        (False, now_ms - 5, 50, 60_000),        # expired window
        (True, now_ms - 1, 3, 100),             # expired bucket (full)
        (True, now_ms + 10 * 100, 10, 100),     # credit covers exactly
        (True, now_ms + 10 * 100 + 1, 9, 100),  # one short: retreats 900
        (True, NEVER, 1 << 30, 1 << 20),        # wrap guard: covers
        (True, now_ms + (1 << 29), 1 << 20, 1 << 12),  # 2**32 ms: covers
        (False, now_ms + 1, 1 << 30, 1000),     # floored at 0
        (True, now_ms + 5_000, -3, 1 << 30),    # negative credit wraps
        (False, now_ms + 1, -7, 1000),          # negative credit adds
    ]
    for i, (is_bucket, e, c, w) in enumerate(edges[: n_real]):
        bucket[i] = is_bucket
        expiry[slots[i]] = e
        credits[i] = c
        windows[i] = w
    pad = H - n_real
    return (
        (values, expiry, hits),
        (
            np.concatenate([slots, np.full(pad, C, np.int32)]),
            np.concatenate([credits, rng.integers(0, 9, pad)]).astype(
                np.int32),
            np.concatenate([windows, np.zeros(pad, np.int32)]),
            np.concatenate([bucket, np.zeros(pad, bool)]),
        ),
    )


def credit_list(rng, count, now_ms):
    """``credit_batch`` as the lease broker hands it to B4c's host form:
    (table, entries, rows), ``entries`` the int32 [count, 5] list of (0,
    slot, credit, interval, bucket << 1) entries (the edge rows first,
    unpadded) and ``rows`` the same credits as the JAX call's columns,
    padded to a pow2 bucket of 8 at least with scratch rows."""
    H = max(8, 1 << (count - 1).bit_length())
    tbl, rows = credit_batch(rng, H, now_ms, n_real=count)
    entries = np.zeros((count, 5), np.int32)
    for j in range(3):
        entries[:, j + 1] = rows[j][:count]
    entries[:, 4] = rows[3][:count].astype(np.int32) << 1
    return tbl, entries, rows


#: B5's adversarial columns beside the traffic-shaped ones
DRAIN_EDGE_KINDS = ("ascending", "equal", "extremes")


def hits_column(rng, kind, n=C):
    """An int32[n+1] hit column: "zipf" (hot slots, many ties), "sparse"
    (fewer live slots than most k, tied counts), "zero", "wide" (large
    counts), "ascending" (counts rising with the index: every later cell
    beats every earlier one), "equal" (one count everywhere: the index
    alone orders), or "extremes" (negative counts, INT_MIN, INT_MAX,
    -1 and 0, with ties)."""
    hits = np.zeros(n + 1, np.int32)
    if kind == "zipf":
        keys = np.minimum(rng.zipf(1.3, 20 * n) - 1, n - 1)
        np.add.at(hits, keys, 1)
    elif kind == "sparse":
        live = rng.choice(n, 10, replace=False)
        hits[live] = rng.choice([1, 2, 2, 5], 10)
    elif kind == "wide":
        hits[:n] = rng.integers(0, NEVER, n)
    elif kind == "ascending":
        hits[:n] = np.arange(n, dtype=np.int32)
    elif kind == "equal":
        hits[:n] = 7
    elif kind == "extremes":
        edges = np.array([-(1 << 31), NEVER, -1, 0, 1], np.int32)
        hits[:n] = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
        pick = rng.random(n) < 0.5
        hits[:n][pick] = rng.choice(edges, int(pick.sum()))
    hits[n] = 3  # scratch garbage: zeroed, never reported
    return hits


MAX_VALUE_CAP = 1 << 30


def remote_lanes(rng, now_ms, lanes, values, n_slots=C):
    """The replicated node's remote lanes (int32[C+1] each) for ``lanes``:
    window slots with live and expired remote sums up to MAX_VALUE_CAP,
    bucket slots with a remote TAT ahead of and behind ``now_ms``, empty
    slots, and the scratch row left 0. ``values`` (the table's values
    column) is changed in place so that some live local counts sit near
    2**31 and local + remote crosses it, where int32 wraps."""
    remote_vals = np.zeros(C + 1, np.int32)
    remote_exp = np.zeros(C + 1, np.int32)
    for slot in range(n_slots):
        is_bucket, maxv, win = lanes[slot]
        kind = rng.random()
        if is_bucket:
            if kind < 0.4:  # remote TAT ahead: a peer spent tokens
                ahead = int(rng.integers(0, maxv + 3)) * win
                remote_exp[slot] = min(now_ms + ahead, NEVER)
            elif kind < 0.7:  # behind now: the bucket refilled
                remote_exp[slot] = max(now_ms - int(rng.integers(0, 5000)),
                                       0)
        elif kind < 0.45:  # live remote window sum
            remote_vals[slot] = int(rng.choice(
                [1, 2, 5, 40, MAX_VALUE_CAP - 1, MAX_VALUE_CAP]))
            remote_exp[slot] = now_ms + int(rng.integers(1, 60_000))
        elif kind < 0.65:  # expired (and exactly at now: not live)
            remote_vals[slot] = int(rng.integers(1, 100))
            remote_exp[slot] = now_ms - int(rng.integers(0, 3))
        elif kind < 0.75:  # local count near 2**31
            values[slot] = NEVER - int(rng.integers(0, 50))
            remote_vals[slot] = MAX_VALUE_CAP
            remote_exp[slot] = now_ms + 60_000
    return remote_vals, remote_exp


def remote_rows(rng, n, n_slots=C):
    """n unique slots with (sum, expiry) rows: the dirty-remote flush."""
    slots = rng.choice(n_slots, n, replace=False).astype(np.int32)
    sums = rng.integers(0, MAX_VALUE_CAP + 1, n).astype(np.int32)
    exps = rng.integers(0, NEVER, n).astype(np.int32)
    return slots, sums, exps


def seed_rows(rng, H, n_real, now_ms):
    """A B4d promotion batch: ``n_real`` unique real slots seeded with
    absolute values and expiries (0, INT32_MAX, live window ends and
    bucket TATs in the expiry lane), padded to H with scratch rows
    (value 0, expiry 0), as ``TorchStorage.seed_slot_values`` pads."""
    slots = rng.choice(C, n_real, replace=False).astype(np.int32)
    values = rng.integers(0, 1 << 30, n_real).astype(np.int32)
    expiry = rng.integers(0, 2 * now_ms, n_real).astype(np.int32)
    edge = rng.random(n_real)
    expiry[edge < 0.1] = 0
    expiry[(edge >= 0.1) & (edge < 0.2)] = NEVER
    values[(edge >= 0.2) & (edge < 0.4)] = 0  # bucket rows: TAT only
    pad = H - n_real
    return (
        np.concatenate([slots, np.full(pad, C, np.int32)]),
        np.concatenate([values, np.zeros(pad, np.int32)]),
        np.concatenate([expiry, np.zeros(pad, np.int32)]),
    )


def dirty_scratch(table_arrays, rng):
    """The same table with a nonzero scratch row (values, expiry, hits):
    the seed must leave it as the JAX program does."""
    out = tuple(a.copy() for a in table_arrays)
    for a in out:
        a[C] = int(rng.integers(1, 1000))
    return out


def sharded_table(rng, n, L, now_ms, lanes, G):
    """A mid-stream int32[n, L+1] sharded table (row s shard s, column L
    its scratch): live and expired windows, bucket TATs, hit counts, and
    in the global region (slots < G) per-row partials, live and expired,
    some near 2**31 so that their sum over the rows passes it."""
    values = rng.integers(0, 60, (n, L + 1)).astype(np.int32)
    expiry = rng.integers(0, 2 * now_ms, (n, L + 1)).astype(np.int32)
    hits = rng.integers(0, 1000, (n, L + 1)).astype(np.int32)
    for slot, (is_bucket, maxv, win) in lanes.items():
        if is_bucket and slot >= G:
            ahead = rng.integers(-3, maxv + 4, n) * win
            expiry[:, slot] = np.maximum(now_ms + ahead, 0)
    big = rng.random((n, G)) < 0.2
    values[:, :G] = np.where(big, (1 << 30) + rng.integers(0, 1 << 29,
                                                          (n, G)),
                             values[:, :G])
    values[:, L] = expiry[:, L] = hits[:, L] = 0
    return values, expiry, hits


def sharded_lanes(rng, L, G):
    """Per-slot (bucket?, max, window-or-interval) of a sharded table:
    global slots are fixed windows with large maxes (their base is the
    sum over the rows), local slots as ``lanes``."""
    out = lanes(rng, L)
    for slot in range(G):
        out[slot] = (False, int(rng.choice([1 << 30, 5 << 28, 100])),
                     int(rng.choice([1000, 60_000])))
    return out


def update_entries(rng, count, n, L, G, lanes_, straddle=None):
    """A B7c host list of ``count`` (row, slot, delta, window, flags)
    entries over an [n, L+1] table (flags bit 0 fresh, bit 1 bucket):
    local slots Zipf over [G, L) on any row (repeated cells), a quarter
    global slots (< G) on any row, lanes as ``lanes_`` says with 3% of
    bucket flags flipped (a cell whose entries mix buckets and windows),
    about 10% fresh, deltas 0 to 3 with some at and past the caps and
    some negative. With ``straddle`` = i (1 <= i < count), entries i - 1
    and i are one cell, the first not fresh and the second fresh: split
    between two launches at i, the cell would end at the second delta
    alone."""
    rows = rng.integers(0, n, count)
    glob = rng.random(count) < 0.25
    slots = np.where(glob, rng.integers(0, G, count),
                     np.minimum(G + rng.zipf(1.3, count) - 1, L - 1))
    bucket = np.array([lanes_[int(s)][0] for s in slots], bool)
    bucket ^= rng.random(count) < 0.03
    wins = np.array([lanes_[int(s)][2] for s in slots], np.int64)
    deltas = rng.integers(0, 4, count)
    edge = rng.random(count) < 0.06
    deltas[edge] = rng.choice([-5, (1 << 30) - 1, 1 << 30, NEVER, 12345],
                              int(edge.sum()))
    fresh = rng.random(count) < 0.1
    if straddle is not None and 1 <= straddle < count:
        i = straddle
        rows[i], slots[i] = rows[i - 1], slots[i - 1]
        bucket[i], wins[i] = bucket[i - 1], wins[i - 1]
        fresh[i - 1], fresh[i] = False, True
    flags = fresh.astype(np.int64) | bucket.astype(np.int64) << 1
    return np.stack([rows, slots, deltas, wins, flags],
                    axis=1).astype(np.int32)


def padded_update_columns(entries, n, L):
    """The JAX call's [n, H] columns (slots, deltas, windows, fresh,
    bucket) of a B7c host list: each row's entries in list order, padded
    with slot L, delta 0, window 0, fresh and bucket False; H a power of
    two, 8 at least."""
    counts = np.bincount(entries[:, 0], minlength=n)
    H = max(8, 1 << (max(int(counts.max(initial=0)), 1) - 1).bit_length())
    cols = [np.full((n, H), L, np.int32), np.zeros((n, H), np.int32),
            np.zeros((n, H), np.int32), np.zeros((n, H), bool),
            np.zeros((n, H), bool)]
    pos = np.zeros(n, np.int64)
    for row, slot, delta, win, flags in entries.tolist():
        j = pos[row]
        pos[row] += 1
        cols[0][row, j], cols[1][row, j], cols[2][row, j] = slot, delta, win
        cols[3][row, j], cols[4][row, j] = flags & 1, flags & 2
    return tuple(cols)


def sharded_batch(rng, n, H, lanes_, L, G, coupled, with_global,
                  n_slots=None):
    """Request-ordered [n, H] hit columns of a sharded batch, padded per
    row with slot L: lean (every request's hits on one row, row-local
    request ids < H) or coupled (requests spanning rows, ids < n*H),
    with global hits (a global slot, any row) when ``with_global``; local
    hits fall on Zipf slots in [G, n_slots) (default L). Returns (slots,
    deltas, maxes, windows, req_ids, fresh, bucket, is_global)."""
    top = (n_slots or L) - 1
    cols = [[[] for _ in range(n)] for _ in range(8)]
    seen = set()
    R = n * H if coupled else H
    local_r = [0] * n
    r = 0
    while r < R - 1:
        home = int(rng.integers(0, n))
        k = int(rng.integers(1, 4))
        rows = [home] + ([int(x) for x in rng.integers(0, n, k - 1)]
                         if coupled else [home] * (k - 1))
        if any(len(cols[0][s]) + rows.count(s) > H - 1 for s in rows):
            break
        rid = r if coupled else local_r[home]
        for s in rows:
            glob = with_global and G > 0 and rng.random() < 0.3
            if glob:
                slot = int(rng.integers(0, G))
            else:
                slot = int(min(G + rng.zipf(1.3) - 1, top))
            is_bucket, maxv, win = lanes_[slot]
            key = (s, slot)
            vals = (slot, int(rng.choice([0, 1, 1, 1, 2, 5, 7])), maxv, win,
                    rid, key not in seen and rng.random() < 0.15,
                    is_bucket and not glob, glob)
            for c, v in zip(cols, vals):
                c[s].append(v)
            seen.add(key)
        if coupled:
            r += 1
        else:
            local_r[home] += 1
            if local_r[home] >= H - 1:
                break
            r = max(local_r)
    fills = (L, 0, NEVER, 0, R - 1, False, False, False)
    dtypes = (np.int32,) * 5 + (bool,) * 3
    out = []
    for c, fill, dt in zip(cols, fills, dtypes):
        arr = np.full((n, H), fill, dt)
        for s in range(n):
            arr[s, :len(c[s])] = c[s]
        out.append(arr)
    return tuple(out)


def divergent_lean_batch(rng, n, H, lanes_, L, G, with_global,
                         n_slots=None):
    """Lean [n, H] columns whose rows' fixpoints settle after different
    sweep counts. Row 0 starts with a request of two delta-1 hits on one
    fresh slot of max 1: its verdict flips every sweep, up to the cap of
    H sweeps. Rows 1 to 3 start with cascades of 9, 4 and 1 requests
    (request j hits fresh slots j and j + 1 of max 1, so each verdict
    flips the next one's): about one sweep per request. These use the
    slots [top - 64, top), top = ``n_slots`` (default L). Every row is
    then filled with requests of one to three hits on distinct slots,
    Zipf over [G, top - 64), and global slots with ``with_global``;
    padding is slot L. Returns the columns of ``sharded_batch``."""
    spare = (n_slots or L) - 64
    fills = (L, 0, NEVER, 0, H - 1, False, False, False)
    dtypes = (np.int32,) * 5 + (bool,) * 3
    cols = [np.full((n, H), f, dt) for f, dt in zip(fills, dtypes)]
    for row in range(n):
        hits = []
        req = 0
        if row == 0:
            hits += [(spare, 1, 1, 60_000, 0, True, False, False)] * 2
            req = 1
        elif row <= 3:
            req = (9, 4, 1)[row - 1]
            hits += [(spare + j + k, 1, 1, 60_000, j, True, False, False)
                     for j in range(req) for k in (0, 1)]
        while True:
            k = int(rng.integers(1, 4))
            if len(hits) + k > H - 1:
                break
            mine = set()
            for _ in range(k):
                glob = with_global and G > 0 and rng.random() < 0.3
                slot = (int(rng.integers(0, G)) if glob
                        else int(min(G + rng.zipf(1.3) - 1, spare - 1)))
                if slot in mine:
                    continue
                mine.add(slot)
                is_bucket, maxv, win = lanes_[slot]
                hits.append((slot, int(rng.choice([0, 1, 1, 1, 2, 5, 7])),
                             maxv, win, req, rng.random() < 0.1,
                             is_bucket and not glob, glob))
            req += 1
        for c, vals in zip(cols, zip(*hits)):
            c[row, :len(hits)] = vals
    return tuple(cols)


class SpyContext:
    """Stands in for a ``TableContext`` bound on the card, over a CPU
    table: the host forms take their card path through it (``cuda`` and
    ``handle`` set), and its C entry points are emulated with the
    kernels' plain versions on what the wrapper hands to C (the lists as
    bytes; B3a's answers written into ``results`` as (value, ttl) pairs,
    as the kernel stores them). Every call is recorded in ``calls`` as
    (entry point, rows), so a CPU test sees the marshalling, the calls
    and the per-block launch counts. ``capacity`` is the entries a
    launch carries, by kind (all-rows slots, pairs, seed rows, slots
    read, remote rows, slots cleared, update entries)."""

    cuda = True
    #: handle -> live spy, so that an entry point given a second handle
    #: (B6b's remote context) finds its lanes
    _live = weakref.WeakValueDictionary()

    def __init__(self, state,
                 capacity=(8000, 4000, 2666, 8000, 2666, 8000, 2000)):
        self.state = state
        self.capacity = capacity
        self.handle = id(self)
        SpyContext._live[self.handle] = self
        self.calls = []
        #: the lists B2's and B4c's entry points were given, as arrays
        self.lists = []
        self.results = np.zeros((0, 2), np.int32)

    @staticmethod
    def _rows(*blobs):
        import torch

        return [torch.from_numpy(np.frombuffer(b, np.int32).copy())
                for b in blobs]

    def reserve(self, n):
        cap = max(1024, 1 << (n - 1).bit_length())
        self.results = np.zeros((cap, 2), np.int32)
        return self.results

    def read_fn(self, handle, slots, n, now_ms):
        from limitador_tpu_torch.ops import kernel as K

        (idx,) = self._rows(slots)
        assert handle and idx.numel() == n <= self.results.shape[0]
        values, ttls = K.read_slots_plain(self.state, idx, now_ms)
        self.results[:n, 0] = values.numpy()
        self.results[:n, 1] = ttls.numpy()
        self.calls.append(("read", n))
        return 0

    def remote_fn(self, handle, slots, sums, expiries, n):
        from limitador_tpu_torch.ops import kernel as K

        rows = self._rows(slots, sums, expiries)
        assert handle and rows[0].numel() == n
        K.apply_remote_plain(self.state.values, self.state.expiry_ms, *rows)
        self.calls.append(("remote", n))
        return 0

    def staged_fn(self, handle, slots, sums, expiries, n):
        self.remote_fn(handle, slots, sums, expiries, n)
        self.calls[-1] = ("staged", n)
        return 0

    def clear_slots_fn(self, handle, slots, n):
        from limitador_tpu_torch.ops import kernel as K

        (idx,) = self._rows(slots)
        assert handle and idx.numel() == n
        K.clear_slots_plain(self.state, idx)
        self.calls.append(("clear", n))
        return 0

    def drain_fn(self, handle, k):
        from limitador_tpu_torch.ops import kernel as K
        from limitador_tpu_torch.parallel import mesh as M

        if self.state.hits.dim() == 1:
            counts, slots = K.drain_top_hits_host_plain(self.state, k)
        else:
            counts, slots = M.sharded_drain_top_hits_host_plain(self.state,
                                                                k)
        n = counts.size
        assert handle and 1 <= k and n <= self.results.shape[0]
        self.results[:n, 0] = counts.reshape(-1)
        self.results[:n, 1] = slots.reshape(-1)
        self.calls.append(("drain", k))
        return 0

    def sharded_update_fn(self, handle, entries, count, now_ms):
        from limitador_tpu_torch.parallel import mesh as M

        rows = np.frombuffer(entries, np.int32).reshape(-1, 5)
        assert handle and rows.shape[0] == count
        M.sharded_update_host_plain(self.state, rows.copy(), now_ms)
        self.calls.append(("update", count))
        return 0

    def update_fn(self, handle, entries, count, now_ms):
        from limitador_tpu_torch.ops import kernel as K

        rows = np.frombuffer(entries, np.int32).reshape(-1, 5).copy()
        assert handle and rows.shape[0] == count
        K.update_host_plain(self.state, rows, now_ms)
        self.calls.append(("table_update", count))
        self.lists.append(rows)
        return 0

    def credit_fn(self, handle, entries, count, now_ms):
        from limitador_tpu_torch.ops import kernel as K

        rows = np.frombuffer(entries, np.int32).reshape(-1, 5).copy()
        assert handle and rows.shape[0] == count
        K.credit_host_plain(self.state, rows, now_ms)
        self.calls.append(("credit", count))
        self.lists.append(rows)
        return 0

    def replicated_update_fn(self, handle, remote_handle, entries, count,
                             now_ms):
        from limitador_tpu_torch.ops import kernel as K

        rows = np.frombuffer(entries, np.int32).reshape(-1, 5)
        remote = SpyContext._live[remote_handle]
        assert handle and rows.shape[0] == count
        K.replicated_update_host_plain(self.state, remote.state.expiry_ms,
                                       rows.copy(), now_ms)
        self.calls.append(("replicated_update", count))
        return 0

    def seed_fn(self, handle, slots, values, expiry, n, padded):
        from limitador_tpu_torch.ops import kernel as K

        rows = [r.numpy() for r in self._rows(slots, values, expiry)]
        assert handle and rows[0].size == n
        K.seed_slots_host_plain(self.state, *rows, bool(padded))
        self.calls.append(("seed", n))
        return 0

    def close(self):
        self.handle = None


class RecordingLibrary:
    """Stands in for the built kernel library on the CPU: every entry
    point records (name, argument count) in ``calls`` and returns 0
    (cudaSuccess), a workspace size of 64 bytes or, for the co-residency
    query, 132 rows, so that a CPU test sees which entry points a
    wrapper's card path calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, len(args)))
            if name.endswith("_capacity"):
                return 132
            return 64 if name.endswith("_bytes") else 0
        return entry

    def names(self):
        return [name for name, _ in self.calls]


def fake_card(monkeypatch):
    """Send the kernels' wrappers down their card path over CPU tensors,
    into a ``RecordingLibrary``, which it returns: ``_on_cuda`` answers
    yes, the current stream is 0 and the coupled co-residency query goes
    to the library."""
    import types

    import torch

    from limitador_tpu_torch.ops import build
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.parallel import mesh as M

    lib = RecordingLibrary()
    monkeypatch.setattr(K, "_on_cuda", lambda t: True)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(M, "coupled_row_capacity",
                        lambda H, has_global, device:
                        lib.ct_sharded_coupled_capacity(H, int(has_global)))
    return lib

