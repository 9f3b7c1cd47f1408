"""The sharded counter table: B7a-B7d, plain versions, CUDA wrappers.

Counterpart of the table programs of ``limitador_tpu/parallel/mesh.py``
(``make_sharded_table``, ``sharded_check_and_update``,
``sharded_clear_cells``, ``sharded_update``, ``sharded_drain_top_hits``,
``:388-612``). The JAX package splits the table over a device mesh with
``shard_map``; here the n shards are the rows of one int32[n, L+1]
tensor per column on one card, and the mesh's collectives become
reductions across rows inside the kernels:

- the coupled variant's ``pmin`` (a request spanning shards is admitted
  only if every shard votes for it, in every sweep of the admission
  fixpoint) is an AND of the rows' votes;
- the global region's ``psum`` (a global counter's base is the sum of
  every shard's live partial) is a sum over the rows of the first
  ``global_region`` columns, read before the step writes any row.

B7a has two CUDA kernels, chosen by a rule on the batch's shape
(``sharded_check_route``). The "cluster" route is B1's thread-block
cluster over the flattened columns: a coupled or global batch of n*H <=
16,384 hits is one cluster, whose shared memory holds every row's votes
and whose hits read the global sums before its barriers let any write
through; a lean batch without a global hit is one cluster a row, B1's
route per row (1,024 to 16,384 hits). It needs no workspace, no pre-pass
and no grid barrier (launches counted as
``sharded_check_and_update_cluster``). The "rows" route is one block a
row (``sharded_check_and_update``): lean rows run alone, the global sums
come from a pre-pass launch, and coupled rows meet at grid barriers
under a cooperative launch, which needs every row's block resident.

Column L of each row is that shard's scratch cell. Batch columns are
[n, H]: row s holds shard s's hits, padded with slot L, delta 0, max
INT32_MAX, fresh, bucket and global False (``TorchShardedStorage``
stages them).

Each program has a plain version (``*_plain``), which a CPU table runs
and ``chip_smoke.py`` holds the kernel against, and a wrapper that
launches the CUDA kernel of ``csrc/counter_table.cu`` for a CUDA table
and counts the launch in ``ops.kernel.launches``. B7b and B7c also take
the storage's host lists through a bound ``ops.kernel.TableContext``
(``sharded_clear_cells_host``, ``sharded_update_host``, the sharded
storage's path; B7c's host form counts under ``sharded_update_host``),
and B7d drains through one (``sharded_drain_top_hits_host``, counted
under its own key, its answers in the context's mapped host buffer).
Like the rest of the port, every function updates the table in place
and returns it.

The serving pod's parts of the JAX file (``PodInfo``, ``initialize_pod``,
``PodMembership``, ``pod_barrier``, ``PodPsumLane``,
``PeerPsumTransport``) are in ``pod.py``, imported in pod mode only. The
legacy global-mesh formation (``make_global_mesh``,
``host_local_to_global``, ``pod_sync``) is not ported: it needs a device
collective across processes, which no NCCL group gives two processes on
one card, and only the JAX package's bench and parity harnesses use it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import build
from ..ops import kernel as K

__all__ = [
    "ShardedCounterState",
    "ShardedBatchResult",
    "make_sharded_table",
    "sharded_check_and_update",
    "sharded_check_and_update_plain",
    "sharded_clear_cells",
    "sharded_clear_cells_plain",
    "sharded_clear_cells_host",
    "sharded_clear_cells_host_plain",
    "sharded_update",
    "sharded_update_plain",
    "sharded_update_host",
    "sharded_update_host_plain",
    "sharded_drain_top_hits",
    "sharded_drain_top_hits_plain",
    "sharded_drain_top_hits_host",
    "sharded_drain_top_hits_host_plain",
    "coupled_row_capacity",
    "sharded_check_route",
]

_I32 = torch.int32


class ShardedCounterState(NamedTuple):
    """The sharded table: int32[n, L+1] each, row s shard s. ``hits`` is
    the per-slot traffic accumulator (a global counter's traffic lands in
    the row of each shard it was applied on)."""

    values: torch.Tensor
    expiry_ms: torch.Tensor
    hits: torch.Tensor


class ShardedBatchResult(NamedTuple):
    admitted: torch.Tensor   # bool[n*H] coupled, bool[n, H] lean
    hit_ok: torch.Tensor     # bool[n, H]
    remaining: torch.Tensor  # int32[n, H]
    ttl_ms: torch.Tensor     # int32[n, H]


def make_sharded_table(n: int, local_capacity: int,
                       device) -> ShardedCounterState:
    """An empty table of n rows of ``local_capacity`` cells plus each
    row's scratch cell."""
    return ShardedCounterState(*(
        torch.zeros((n, local_capacity + 1), dtype=_I32, device=device)
        for _ in range(3)
    ))


def _row(state: ShardedCounterState, s: int) -> K.CounterTableState:
    """Shard s's row as a one-table state of views (writes land in the
    sharded tensors)."""
    return K.CounterTableState(*(t[s] for t in state))


def _require2(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or t.shape != shape:
        raise ValueError(
            f"{name}: expected {dtype}{list(shape)}, got "
            f"{t.dtype}{list(t.shape)}"
        )
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor on {device}")


def _require_state(state: ShardedCounterState) -> None:
    values = state.values
    if values.dim() != 2:
        raise ValueError("the sharded table is int32[n, L+1]")
    for name, t in zip(ShardedCounterState._fields, state):
        _require2(t, name, _I32, values.shape, values.device)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# -- B7a: the sharded check --------------------------------------------------


def _global_vals(state: ShardedCounterState, global_region: int, now: int):
    """psum of the live partials of the global region, read before the
    batch: int32[G], wrapping as XLA's int32 psum does."""
    g = global_region
    live = now < state.expiry_ms[:, :g]
    partial = torch.where(live, state.values[:, :g], 0).long()
    return K._wrap32(partial.sum(0))


def _global_hook(global_vals, global_region, slots, is_global):
    """``_local_step``'s base_hook: a global hit's base is the psum of
    live partials at its slot, in place of its own cell's base."""
    order = torch.sort(slots, stable=True).indices
    s_glob = is_global[order]

    def base_hook(v_local, s_slot):
        safe = torch.clamp_max(s_slot, global_region - 1)
        return torch.where(s_glob, global_vals[safe], v_local)

    return base_hook


def sharded_check_and_update_plain(
    state: ShardedCounterState, slots, deltas, maxes, windows_ms, req_ids,
    fresh, bucket, is_global, now_ms, global_region: int = 1024,
    coupled: bool = True, has_global: bool = True,
) -> ShardedBatchResult:
    """Plain PyTorch twin of ``sharded_check_and_update``: B1's body per
    row (``_local_step``). Lean rows each run their own fixpoint over
    row-local request ids; coupled rows sweep in lockstep, and each
    sweep's verdict is the AND of the rows' votes (the ``pmin``). In
    place."""
    now = K._now(now_ms)
    n, H = slots.shape
    gvals = _global_vals(state, global_region, now) if has_global else None
    plans = []
    for s in range(n):
        hook = None
        if has_global:
            hook = _global_hook(gvals, global_region, slots[s], is_global[s])
        plans.append(K._check_prepare(
            _row(state, s), slots[s], deltas[s], maxes[s], windows_ms[s],
            req_ids[s], fresh[s], bucket[s], now, base_hook=hook,
        ))
    dev = slots.device
    if coupled:
        num_req = n * H

        def sweep(admitted):
            votes, oks = zip(*(K._check_sweep(p, admitted, num_req)
                               for p in plans))
            return torch.stack(votes).all(0), oks

        admitted, oks = K._fixpoint(sweep, num_req, dev)
        rows = [K._check_finish(p, admitted, ok)
                for p, ok in zip(plans, oks)]
        admitted_out = admitted
    else:
        rows = []
        for p in plans:
            adm, ok = K._fixpoint(lambda a, p=p: K._check_sweep(p, a, H), H,
                                  dev)
            rows.append(K._check_finish(p, adm, ok))
        admitted_out = torch.stack([r.admitted for r in rows])
    return ShardedBatchResult(
        admitted_out,
        torch.stack([r.hit_ok for r in rows]),
        torch.stack([r.remaining for r in rows]),
        torch.stack([r.ttl_ms for r in rows]),
    )


@functools.lru_cache(maxsize=None)
def coupled_row_capacity(H: int, has_global: bool, device) -> int:
    """Rows a coupled launch at H hits a row can take on ``device``: its
    blocks (one per row, 1024 threads and up to 128 KB of shared memory
    each) must all be resident at once for the grid barrier."""
    with torch.cuda.device(device):
        got = build.library().ct_sharded_coupled_capacity(H, int(has_global))
    if got < 0:
        raise RuntimeError("ct_sharded_coupled_capacity: occupancy query "
                           "failed")
    return got


def sharded_check_route(n: int, H: int, coupled: bool,
                        has_global: bool) -> str:
    """B7a's CUDA kernel for an [n, H] batch: "cluster" or "rows" (one
    block a row). Coupled and global batches take one cluster over the
    n*H hits up to ``K.CLUSTER_MAX_HITS``, with no low edge: down to 8
    rows of 8 hits its call, one launch with no workspace, was faster
    than the rows route's, and its kernel faster for coupled batches and
    at most 5 us slower for lean global ones (PERF.md §6). Lean batches
    without a global hit take one cluster a row where B1 takes its
    cluster (``K.check_route(H)``). A rule on the shape alone: both
    kernels compute the same function."""
    if coupled or has_global:
        return "cluster" if n * H <= K.CLUSTER_MAX_HITS else "rows"
    return "cluster" if K.check_route(H) == "cluster" else "rows"


def sharded_check_and_update(
    state: ShardedCounterState,
    slots: torch.Tensor,       # int32[n, H] owner-row slot per hit
    deltas: torch.Tensor,      # int32[n, H]
    maxes: torch.Tensor,       # int32[n, H]
    windows_ms: torch.Tensor,  # int32[n, H]
    req_ids: torch.Tensor,     # int32[n, H] (< n*H coupled, < H lean)
    fresh: torch.Tensor,       # bool[n, H]
    bucket: torch.Tensor,      # bool[n, H]
    is_global: torch.Tensor,   # bool[n, H]
    now_ms: int,
    global_region: int = 1024,
    coupled: bool = True,
    has_global: bool = True,
    route: Optional[str] = None,
) -> Tuple[ShardedCounterState, ShardedBatchResult]:
    """One check-and-update step over every row of the sharded table (the
    JAX ``sharded_check_and_update``): ``coupled`` batches use request
    ids below n*H and return ``admitted[n*H]``; lean ones use row-local
    ids below H and return ``admitted[n, H]``. ``has_global`` reads the
    base of a hit flagged global as the live psum of its slot over the
    rows. Updates ``state`` in place. On the card ``route`` picks the
    kernel: None takes ``sharded_check_route``; "cluster" or "rows"
    forces one. A cluster past its capacity or one the card cannot place
    raises, and so does a coupled "rows" launch whose n blocks cannot all
    be resident on the card."""
    if not K._on_cuda(state.values):
        return state, sharded_check_and_update_plain(
            state, slots, deltas, maxes, windows_ms, req_ids, fresh, bucket,
            is_global, now_ms, global_region, coupled, has_global,
        )
    dev = state.values.device
    _require_state(state)
    n, H = slots.shape
    L = state.values.shape[1] - 1
    if state.values.shape[0] != n:
        raise ValueError(f"hit columns have {n} rows, the table "
                         f"{state.values.shape[0]}")
    for name, t in (("slots", slots), ("deltas", deltas), ("maxes", maxes),
                    ("windows_ms", windows_ms), ("req_ids", req_ids)):
        _require2(t, name, _I32, (n, H), dev)
    for name, t in (("fresh", fresh), ("bucket", bucket),
                    ("is_global", is_global)):
        _require2(t, name, torch.bool, (n, H), dev)
    if H < 1:
        raise ValueError("sharded_check_and_update needs at least one hit")
    # A region past the row covers the whole row, as the JAX program's
    # slice [:global_region] does.
    G = min(int(global_region), L + 1)
    if has_global and G < 1:
        raise ValueError(f"global_region {global_region} < 1")
    route = (sharded_check_route(n, H, coupled, has_global)
             if route is None else route)
    if route not in ("rows", "cluster"):
        raise ValueError(f"sharded_check_and_update: no route {route!r}")
    lib = build.library()
    result = ShardedBatchResult(
        torch.empty(n * H if coupled else (n, H), dtype=torch.bool,
                    device=dev),
        torch.empty((n, H), dtype=torch.bool, device=dev),
        torch.empty((n, H), dtype=_I32, device=dev),
        torch.empty((n, H), dtype=_I32, device=dev),
    )
    columns = [t.data_ptr() for t in (*state, slots, deltas, maxes,
                                      windows_ms, req_ids, fresh, bucket,
                                      is_global)]
    shape = (n, H, L, K._now(now_ms), max(G, 0), int(has_global),
             int(coupled))
    outputs = [t.data_ptr() for t in result]
    if route == "cluster":
        build.check(lib.ct_sharded_check_and_update_cluster(
            *columns, *shape, *outputs, _stream(dev),
        ), "ct_sharded_check_and_update_cluster")
        K.launches["sharded_check_and_update_cluster"] += 1
        return state, result
    if coupled:
        fits = coupled_row_capacity(H, bool(has_global), dev)
        if n > fits:
            raise RuntimeError(
                f"a coupled sharded launch of {n} rows needs {n} resident "
                f"blocks; the card holds {fits}"
            )
    workspace = torch.empty(
        lib.ct_sharded_check_workspace_bytes(n, H, max(G, 0)),
        dtype=torch.uint8, device=dev,
    )
    build.check(lib.ct_sharded_check_and_update(
        *columns, *shape, workspace.data_ptr(), *outputs, _stream(dev),
    ), "ct_sharded_check_and_update")
    K.launches["sharded_check_and_update"] += 1
    return state, result


# -- B7b: per-row cell clears ------------------------------------------------


def sharded_clear_cells_plain(state: ShardedCounterState,
                              slots) -> ShardedCounterState:
    """Plain PyTorch twin of ``sharded_clear_cells``: row s's cells at
    ``slots[s]`` zeroed in all three columns. In place."""
    rows = torch.arange(slots.shape[0], device=slots.device)[:, None]
    idx = (rows.expand_as(slots), slots.long())
    for t in state:
        t[idx] = 0
    return state


def sharded_clear_cells(
    state: ShardedCounterState, slots: torch.Tensor  # int32[n, K]
) -> ShardedCounterState:
    """Zero value, expiry and hits at per-row slot lists (the JAX
    ``sharded_clear_cells``); padding entries point at column L. Zeroing
    a global slot everywhere is the same list on every row. In place."""
    if not K._on_cuda(state.values):
        return sharded_clear_cells_plain(state, slots)
    values = state.values
    dev = values.device
    _require_state(state)
    n, L1 = values.shape
    k = slots.shape[1] if slots.dim() == 2 else -1
    _require2(slots, "slots", _I32, (n, k), dev)
    if k == 0:
        return state
    build.check(build.library().ct_sharded_clear(
        values.data_ptr(), state.expiry_ms.data_ptr(), state.hits.data_ptr(),
        slots.data_ptr(), n, k, L1 - 1, _stream(dev),
    ), "ct_sharded_clear")
    K.launches["sharded_clear_cells"] += 1
    return state


def sharded_clear_cells_host_plain(state: ShardedCounterState,
                                   entries: np.ndarray,
                                   all_rows: bool) -> ShardedCounterState:
    """Plain twin of ``sharded_clear_cells_host``. In place."""
    e = torch.from_numpy(entries).to(state.values.device).long()
    if all_rows:
        n = state.values.shape[0]
        rows = torch.arange(n, device=e.device)[:, None].expand(n, e.numel())
        idx = (rows, e.view(1, -1).expand(n, -1))
    else:
        pairs = e.view(-1, 2)
        idx = (pairs[:, 0], pairs[:, 1])
    for t in state:
        t[idx] = 0
    return state


def sharded_clear_cells_host(ctx: K.TableContext, entries: np.ndarray,
                             all_rows: bool) -> ShardedCounterState:
    """``sharded_clear_cells`` from a host list, on ``ctx.state`` in
    place: ``entries`` is a numpy int32 list of (row, slot) pairs, or,
    with ``all_rows``, of slots zeroed on every row (a global slot's
    clear: k entries where the [n, K] form carries n*K). The JAX call's
    padding entries are entries of slot L. On the card the list rides in
    the kernel's parameter block (``ct_sharded_clear_host``): no pinned
    buffer, no device copy, no tensor; a list longer than one block
    launches in chunks, in order. The list reaches C as ``bytes``."""
    if not ctx.cuda:
        return sharded_clear_cells_host_plain(ctx.state, entries, all_rows)
    if entries.dtype != np.int32 or (entries.ndim != 1 if all_rows
                                     else entries.size % 2):
        raise ValueError("entries: expected a numpy int32 list of slots "
                         "(all_rows) or of (row, slot) pairs")
    count = entries.size if all_rows else entries.size >> 1
    if count == 0:
        return ctx.state
    rc = ctx.clear_fn(ctx.handle, entries.tobytes(), count, int(all_rows))
    if rc:
        build.check(rc, "ct_sharded_clear_host")
    K.launches["sharded_clear_cells"] += -(-count // ctx.capacity[
        0 if all_rows else 1])
    return ctx.state


# -- B7c: per-row unconditional increments -----------------------------------


def sharded_update_plain(state: ShardedCounterState, slots, deltas,
                         windows_ms, fresh, bucket,
                         now_ms) -> ShardedCounterState:
    """Plain PyTorch twin of ``sharded_update``: B2 on each row. In
    place."""
    for s in range(slots.shape[0]):
        K.update_plain(_row(state, s), slots[s], deltas[s], windows_ms[s],
                       fresh[s], bucket[s], now_ms)
    return state


def sharded_update(
    state: ShardedCounterState,
    slots: torch.Tensor,       # int32[n, H]
    deltas: torch.Tensor,      # int32[n, H]
    windows_ms: torch.Tensor,  # int32[n, H]
    fresh: torch.Tensor,       # bool[n, H]
    bucket: torch.Tensor,      # bool[n, H]
    now_ms: int,
) -> ShardedCounterState:
    """Unconditional increments on every row (the JAX
    ``sharded_update``): B2 per row, no coupling; a global counter's
    delta lands in the row it is staged on. In place."""
    if not K._on_cuda(state.values):
        return sharded_update_plain(state, slots, deltas, windows_ms, fresh,
                                    bucket, now_ms)
    dev = state.values.device
    _require_state(state)
    n, H = slots.shape
    if state.values.shape[0] != n:
        raise ValueError(f"hit columns have {n} rows, the table "
                         f"{state.values.shape[0]}")
    for name, t in (("slots", slots), ("deltas", deltas),
                    ("windows_ms", windows_ms)):
        _require2(t, name, _I32, (n, H), dev)
    for name, t in (("fresh", fresh), ("bucket", bucket)):
        _require2(t, name, torch.bool, (n, H), dev)
    if H < 1:
        raise ValueError("sharded_update needs at least one hit")
    lib = build.library()
    workspace = torch.empty(lib.ct_sharded_update_workspace_bytes(n, H),
                            dtype=torch.uint8, device=dev)
    build.check(lib.ct_sharded_update(
        *(t.data_ptr() for t in state),
        *(t.data_ptr() for t in (slots, deltas, windows_ms, fresh, bucket)),
        n, H, state.values.shape[1] - 1, K._now(now_ms),
        workspace.data_ptr(), _stream(dev),
    ), "ct_sharded_update")
    K.launches["sharded_update"] += 1
    return state


def sharded_update_host_plain(state: ShardedCounterState,
                              entries: np.ndarray,
                              now_ms) -> ShardedCounterState:
    """Plain twin of ``sharded_update_host``: B2's plain version on each
    row over that row's entries in list order, every row's scratch cell
    zeroed (an empty list changes nothing, as on the card). In
    place."""
    K._require_entries(entries)
    if entries.shape[0] == 0:
        return state
    n, L1 = state.values.shape
    rows, slots = entries[:, 0], entries[:, 1]
    if ((rows < 0) | (rows >= n) | (slots < 0) | (slots >= L1 - 1)).any():
        raise ValueError(f"entries: rows must lie in [0, {n}) and slots in "
                         f"[0, {L1 - 1})")
    dev = state.values.device
    for s in range(n):
        mine = entries[rows == s]
        if mine.shape[0]:
            K.update_plain(_row(state, s), *K._entry_columns(mine, dev),
                           now_ms)
    for t in state:
        t[:, -1] = 0
    return state


def sharded_update_host(ctx: K.TableContext, entries: np.ndarray,
                        now_ms) -> ShardedCounterState:
    """``sharded_update`` from a host list, on ``ctx.state`` in place:
    ``entries`` is a numpy int32 [count, 5] list of (row, slot, delta,
    window, flags) entries, flags bit 0 fresh and bit 1 bucket, in the
    order the JAX call's [n, H] columns hold them row by row (its
    padding entries, slot L, are left out). Each row takes B2 over its
    entries, as the JAX call's rows do, and every row's scratch cell is
    zeroed. On the card one C call, one launch on the context's stream
    (``ct_sharded_update_host``): a list of up to ``ctx.capacity[6]``
    entries rides in the kernel's parameter block; a longer one goes
    through the context's staging buffer in one copy, never in chunks,
    so no cell's entries are split between launches. The kernel sorts
    the entries by cell, stably, and applies B2's rules per cell. No
    padding, no upload, no tensor, no workspace."""
    if not ctx.cuda:
        return sharded_update_host_plain(ctx.state, entries, now_ms)
    K._require_entries(entries)
    now = K._now(now_ms)
    if not ctx.handle:
        raise RuntimeError("sharded_update_host: the launch context is "
                           "closed")
    count = entries.shape[0]
    if count == 0:
        return ctx.state
    rc = ctx.sharded_update_fn(ctx.handle, entries.tobytes(), count,
                               now)
    if rc:
        build.check(rc, "ct_sharded_update_host")
    K.launches["sharded_update_host"] += 1
    return ctx.state


# -- B7d: per-row heavy-hitter drain -----------------------------------------


def sharded_drain_top_hits_plain(hits: torch.Tensor, k: int):
    """Plain PyTorch twin of ``sharded_drain_top_hits``: B5's plain
    drain on each row (ties to the lowest slot, as ``lax.top_k``), the
    whole tensor zeroed. In place."""
    counts, slots = [], []
    for s in range(hits.shape[0]):
        _, c, sl = K.drain_top_hits_plain(hits[s], k)
        counts.append(c)
        slots.append(sl)
    return hits, torch.stack(counts), torch.stack(slots)


def sharded_drain_top_hits(
    hits: torch.Tensor, k: int, blocks: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row read-and-reset of the hit accumulator (the JAX
    ``sharded_drain_top_hits``): returns (the zeroed hits, counts[n, k]
    descending per row, slots[n, k]), ties to the lowest slot, count-0
    entries filler; the scratch column is zeroed and never reported.
    ``1 <= k <= L``. In place. On the card, for k <= 1024, one launch of
    B5's one-pass kernel over the rows (after a memset of its fresh
    workspace's header), ``blocks`` blocks a row (0: the kernel's own
    rule; phase 3 of ``chip_smoke.py`` times the alternatives); a larger
    k sorts row after row. The storages drain through
    ``sharded_drain_top_hits_host``."""
    if hits.dim() != 2:
        raise ValueError("sharded hits are int32[n, L+1]")
    n, L1 = hits.shape
    k = int(k)
    if not 1 <= k <= L1 - 1:
        raise ValueError(f"sharded_drain_top_hits: k={k} outside "
                         f"[1, {L1 - 1}]")
    if not K._on_cuda(hits):
        return sharded_drain_top_hits_plain(hits, k)
    dev = hits.device
    _require2(hits, "hits", _I32, (n, L1), dev)
    lib = build.library()
    workspace = torch.empty(
        lib.ct_sharded_topk_workspace_bytes(n, L1, k, int(blocks)),
        dtype=torch.uint8, device=dev)
    counts = torch.empty((n, k), dtype=_I32, device=dev)
    slots = torch.empty((n, k), dtype=_I32, device=dev)
    build.check(lib.ct_sharded_drain_top_hits(
        hits.data_ptr(), n, L1, k, int(blocks), workspace.data_ptr(),
        counts.data_ptr(), slots.data_ptr(), _stream(dev),
    ), "ct_sharded_drain_top_hits")
    K.launches["sharded_drain_top_hits"] += 1
    return hits, counts, slots


def sharded_drain_top_hits_host_plain(
        state: ShardedCounterState, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Plain twin of ``sharded_drain_top_hits_host``:
    ``sharded_drain_top_hits_plain`` on the table's hits, the answers as
    numpy int32[n, k] arrays."""
    _, counts, slots = sharded_drain_top_hits_plain(state.hits, k)
    return counts.cpu().numpy(), slots.cpu().numpy()


def sharded_drain_top_hits_host(
        ctx: K.TableContext, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """``sharded_drain_top_hits`` on ``ctx.state``'s [n, L+1] hits,
    answered on the host: (counts, slots) as numpy int32[n, k] arrays of
    their own, the hits zeroed in place. On the card one C call
    (``ct_drain_top_hits_host`` on the context of the rows): for k <=
    1024 one launch of B5's one-pass kernel over the rows with the
    context's own workspace, each row's k (count, slot) pairs stored
    into the context's mapped host buffer (row r's at pairs [r k, r k +
    k)), and the call waits on the context's stream, so the drain
    follows every launch queued there before it; no allocation, no
    output tensor, no copy. The next read or drain through the context
    overwrites the buffer; the answers are copied out of it first."""
    hits = ctx.state.hits
    if hits.dim() != 2:
        raise ValueError("sharded hits are int32[n, L+1]")
    n, L1 = hits.shape
    k = int(k)
    if not 1 <= k <= L1 - 1:
        raise ValueError(f"sharded_drain_top_hits_host: k={k} outside "
                         f"[1, {L1 - 1}]")
    if not ctx.cuda:
        return sharded_drain_top_hits_host_plain(ctx.state, k)
    if not ctx.handle:
        raise RuntimeError("sharded_drain_top_hits_host: the launch "
                           "context is closed")
    results = ctx.results
    if results.shape[0] < n * k:
        results = ctx.reserve(n * k)
    rc = ctx.drain_fn(ctx.handle, k)
    if rc:
        build.check(rc, "ct_drain_top_hits_host")
    K.launches["sharded_drain_top_hits_host"] += 1
    pairs = results[:n * k].reshape(n, k, 2)
    return pairs[:, :, 0].copy(), pairs[:, :, 1].copy()
