"""Counter-table kernels: plain PyTorch versions, CUDA wrappers, launch counts.

Counterpart of ``limitador_tpu/ops/kernel.py``. The table, the caps and the
semantics are the JAX package's, bit for bit: the same hit batch and clock
give the same ``admitted``, ``hit_ok``, ``remaining`` and ``ttl_ms`` and the
same final ``values``, ``expiry_ms`` and ``hits``. The module docstring of
the JAX file explains the exactness contract (check-all-then-update-all
decided by a fixpoint over segmented prefix sums of hits sorted by slot),
the GCRA bucket lane that keeps its TAT in the expiry cell, and the scratch
row ``C`` that absorbs padding hits.

Each kernel has three parts here:

- ``*_plain``: the same function in plain PyTorch ops. It runs on any
  device. It is what a CPU tensor gets, and what ``chip_smoke.py`` holds
  the CUDA kernel against on the card.
- the wrapper (``check_and_update_batch``, ``update_batch``,
  ``read_slots``, ``clear_slots``, ``rebase_epoch_chunked``,
  ``rebase_epoch``, ``credit_batch``, ``seed_slots``,
  ``drain_top_hits``, ``replicated_check_batch``,
  ``replicated_update_batch``, ``apply_remote``): on a CUDA
  table it launches the hand-written kernel of
  ``limitador_tpu_torch/csrc/counter_table.cu`` and raises if that fails;
  on a CPU table it runs the plain version. No other device is accepted.
- ``launches[name]``: a plain integer, incremented by the wrapper each time
  it launches its CUDA kernel (never by the plain version).

Nine kernels also take host lists through a ``TableContext`` bound
once per table (their "host forms", the storages' main path): B4d
``seed_slots_host``, B7b ``sharded_clear_cells_host`` and B7c
``sharded_update_host`` (both in ``parallel/mesh.py``), B3a
``read_slots_host``, B6c ``apply_remote_host``, B3b
``clear_slots_host``, B6b ``replicated_update_host`` (B7c's body
with the remote TAT floor read through the node's remote-lane
context), B2 ``update_host`` (B7c's body on a one-row table) and B4c
``credit_host``; B5's host form, ``drain_top_hits_host``, and B7d's,
``sharded_drain_top_hits_host`` (``parallel/mesh.py``), take only k and
answer, as B3a's does, into the context's mapped host buffer. Every
host form but B4d's counts its launches under a key of its own
(``read_slots_host``, ``apply_remote_host``, ``clear_slots_host``,
``drain_top_hits_host``, ``replicated_update_host``,
``sharded_update_host``, ``sharded_drain_top_hits_host``,
``update_host``, ``credit_host``), so a run shows which form its path
took.

B1 and B6a each have two CUDA kernels, chosen by the batch's hit count H
alone (``check_route``): a thread-block cluster (``check_cluster_kernel``,
launches counted as ``check_and_update_cluster`` and
``replicated_check_cluster``) for ``CLUSTER_MIN_HITS <= H <=
CLUSTER_MAX_HITS`` (1,024 to 16,384: the drives' 8192-hit batches), and
the one-block ``check_kernel`` (``check_and_update``,
``replicated_check``) elsewhere (the served paths' small batches, and
batches past the cluster's capacity). B7a's routes are in
``parallel/mesh.py`` (``sharded_check_route``).

The JAX programs donate the table (``donate_argnums=(0,)``) and return a
new state. Here every function that writes the table updates its tensors
in place instead and returns the same ``CounterTableState``; callers that
keep the returned state see no difference.

int32 arithmetic wraps in XLA and in PyTorch's CPU ops alike. The CUDA
kernels do the same arithmetic through ``uint32``; ``torch.cumsum`` is
always given ``dtype=torch.int32``, since it would otherwise widen to
int64 and stop wrapping where XLA wraps.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import build

__all__ = [
    "CounterTableState",
    "BatchResult",
    "make_table",
    "check_and_update_batch",
    "check_and_update_plain",
    "check_route",
    "CLUSTER_MIN_HITS",
    "CLUSTER_MAX_HITS",
    "update_batch",
    "update_plain",
    "update_host",
    "update_host_plain",
    "read_slots",
    "read_slots_plain",
    "read_slots_host",
    "read_slots_host_plain",
    "clear_slots",
    "clear_slots_plain",
    "clear_slots_host",
    "clear_slots_host_plain",
    "rebase_epoch_chunked",
    "rebase_expiry_plain",
    "rebase_epoch",
    "rebase_epoch_plain",
    "credit_batch",
    "credit_plain",
    "credit_host",
    "credit_host_plain",
    "seed_slots",
    "seed_slots_plain",
    "seed_slots_host",
    "seed_slots_host_plain",
    "TableContext",
    "drain_top_hits",
    "drain_top_hits_plain",
    "drain_top_hits_host",
    "drain_top_hits_host_plain",
    "replicated_check_batch",
    "replicated_check_plain",
    "replicated_update_batch",
    "replicated_update_plain",
    "replicated_update_host",
    "replicated_update_host_plain",
    "apply_remote",
    "apply_remote_plain",
    "apply_remote_host",
    "apply_remote_host_plain",
    "launches",
    "reset_launches",
    "MAX_VALUE_CAP",
    "MAX_DELTA_CAP",
    "WINDOW_MS_CAP",
]

MAX_VALUE_CAP = 1 << 30        # value+delta stays inside int32
MAX_DELTA_CAP = (1 << 30) - 1
# now_ms is rebased before exceeding 2**30, so now_ms + window must stay
# under INT32_MAX: cap windows at INT32_MAX - 2**30 - 1 (~12.4 days).
WINDOW_MS_CAP = (1 << 31) - 1 - (1 << 30) - 1
_NEVER = (1 << 31) - 1
_I32 = torch.int32
#: B1's cluster route takes batches of CLUSTER_MIN_HITS to CLUSTER_MAX_HITS
#: hits: one block of the cluster per 1024 hits, up to the 16 blocks of
#: the H100's largest cluster (kClusterMaxHits in csrc/counter_table.cu).
#: Below 1024 hits the cluster is one block whose radix sort costs more
#: than the one-block kernel's bitonic sort: that kernel measured faster
#: there (PERF.md §6).
CLUSTER_MIN_HITS = 1024
CLUSTER_MAX_HITS = 16 * 1024

#: kernel name -> number of CUDA launches made by its wrapper
launches = {
    "check_and_update": 0,  # B1, one block (check_kernel)
    "check_and_update_cluster": 0,  # B1, a cluster (check_cluster_kernel)
    "update": 0,
    "update_host": 0,  # B2's host form
    "read_slots": 0,
    "read_slots_host": 0,  # B3a's host form
    "clear_slots": 0,
    "clear_slots_host": 0,  # B3b's host form
    "rebase_epoch": 0,  # B4a, rebase_epoch_chunked
    "rebase_epoch_device": 0,  # B4b, rebase_epoch
    "credit": 0,
    "credit_host": 0,  # B4c's host form
    "seed_slots": 0,
    "drain_top_hits": 0,
    "drain_top_hits_host": 0,  # B5's host form
    "replicated_check": 0,  # B6a, one block (check_kernel<true>)
    "replicated_check_cluster": 0,  # B6a, a cluster (its hooks)
    "replicated_update": 0,
    "replicated_update_host": 0,  # B6b's host form
    "apply_remote": 0,
    "apply_remote_host": 0,  # B6c's host form
    # B7a-d, the sharded table (parallel/mesh.py)
    "sharded_check_and_update": 0,  # B7a, one block a row
    "sharded_check_and_update_cluster": 0,  # B7a, thread-block clusters
    "sharded_clear_cells": 0,
    "sharded_update": 0,
    "sharded_update_host": 0,  # B7c's host form
    "sharded_drain_top_hits": 0,
    "sharded_drain_top_hits_host": 0,  # B7d's host form
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class CounterTableState(NamedTuple):
    """Device-resident counter table, int32[C+1] each. Row C is the
    padding scratch cell. ``hits`` is the per-slot traffic accumulator
    every check and update bumps."""

    values: torch.Tensor
    expiry_ms: torch.Tensor  # relative to the host epoch
    hits: torch.Tensor


class BatchResult(NamedTuple):
    admitted: torch.Tensor   # bool[H]  per request id
    hit_ok: torch.Tensor     # bool[H]  per hit, in input hit order
    remaining: torch.Tensor  # int32[H] max - (value_at_turn + delta), >= 0
    ttl_ms: torch.Tensor     # int32[H] window ttl observed at the hit's turn


def make_table(capacity: int, device) -> CounterTableState:
    """An empty table of ``capacity`` counters plus the scratch row."""
    return CounterTableState(
        *(torch.zeros(capacity + 1, dtype=_I32, device=device)
          for _ in range(3))
    )


# -- dispatch ---------------------------------------------------------------


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device is refused."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"counter-table kernels run on cuda or cpu, not {kind}")


def _require(t: torch.Tensor, name: str, dtype, n: int, device) -> None:
    if t.dtype != dtype or t.dim() != 1 or t.shape[0] != n:
        raise ValueError(
            f"{name}: expected {dtype}[{n}], got {t.dtype}{list(t.shape)}"
        )
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor on {device}")


def _require_table(state: CounterTableState) -> None:
    n = state.values.shape[0]
    for name, t in zip(CounterTableState._fields, state):
        _require(t, name, _I32, n, state.values.device)


def _require_host(a: np.ndarray, name: str, n: int) -> None:
    if a.dtype != np.int32 or a.ndim != 1 or a.shape[0] != n:
        raise ValueError(f"{name}: expected a numpy int32[{n}]")


def _require_entries(entries: np.ndarray) -> None:
    """The update and credit host lists (B7c, B6b, B2, B4c): numpy int32
    [count, 5]."""
    if entries.dtype != np.int32 or entries.ndim != 2 or \
            entries.shape[1] != 5:
        raise ValueError("entries: expected a numpy int32 [count, 5] list "
                         "of (row, slot, delta, window, flags)")


def _require_table_entries(entries: np.ndarray, c1: int) -> None:
    """A host list on a single table of ``c1`` cells: row 0 and slots in
    [0, c1 - 1) (the scratch cell is refused: a host list has no
    padding), as the C entry points refuse them."""
    rows, slots = entries[:, 0], entries[:, 1]
    if (rows != 0).any() or ((slots < 0) | (slots >= c1 - 1)).any():
        raise ValueError(f"entries: rows must be 0 and slots in "
                         f"[0, {c1 - 1})")


def _entry_columns(entries: np.ndarray, device):
    """(slots, deltas, windows, fresh, bucket) tensors of a host list."""
    cols = [torch.from_numpy(np.ascontiguousarray(entries[:, j])).to(device)
            for j in range(1, 5)]
    flags = cols[3]
    return cols[0], cols[1], cols[2], (flags & 1).bool(), (flags & 2).bool()


class TableContext:
    """A table bound once for the host-list launches (the host forms of
    B4d, ``seed_slots_host``, of B7b, ``sharded_clear_cells_host``, of
    B7c, ``sharded_update_host``, of B3a, ``read_slots_host``, of B6c,
    ``apply_remote_host``, of B3b, ``clear_slots_host``, of B6b,
    ``replicated_update_host``, of B2, ``update_host``, of B4c,
    ``credit_host``, and of B5 and B7d, ``drain_top_hits_host`` and
    ``sharded_drain_top_hits_host``).

    On the card the three columns are checked here, once, and bound with
    the stream (the storage's own) in a C context, ``ct_ctx_create``; a
    launch through it passes the handle and numpy lists and makes no
    torch call. The C context also owns the answer buffer of B3a, B5
    and B7d (pinned host memory mapped for the card, ``results`` its
    numpy view), B5's and B7d's workspace and the staging buffers of
    the update and credit host forms, freed with it. On the CPU it holds
    the table, and the host forms run their plain versions on it. A
    storage makes one whenever it takes or replaces its table, and
    closes the one it replaces: a context must never outlive the table
    it points at, so it keeps the table. Calls through one context are
    serialised by its owner (the storage's lock): they share the answer
    buffer."""

    __slots__ = ("state", "cuda", "handle", "capacity", "clear_fn",
                 "seed_fn", "read_fn", "remote_fn", "staged_fn",
                 "clear_slots_fn", "drain_fn", "sharded_update_fn",
                 "replicated_update_fn", "update_fn", "credit_fn",
                 "results",
                 "_results_fn", "_destroy")
    _NO_RESULTS = np.zeros((0, 2), np.int32)

    def __init__(self, state, stream=None):
        self.handle = None
        self.state = state
        self.cuda = _on_cuda(state.values)
        self.results = self._NO_RESULTS
        if not self.cuda:
            return
        values = state.values
        if values.dim() not in (1, 2):
            raise ValueError("a table is int32[C+1] or int32[n, L+1]")
        for name, t in zip(state._fields, state):
            if (t.dtype != _I32 or t.shape != values.shape
                    or t.device != values.device or not t.is_contiguous()):
                raise ValueError(
                    f"{name}: expected a contiguous int32"
                    f"{list(values.shape)} on {values.device}")
        rows, row_len = ((1, values.shape[0]) if values.dim() == 1
                         else tuple(values.shape))
        if stream is None:
            stream = torch.cuda.current_stream(values.device)
        lib = build.library()
        handle = lib.ct_ctx_create(
            *(t.data_ptr() for t in state), rows, row_len,
            stream.cuda_stream)
        if not handle:
            raise RuntimeError("ct_ctx_create: the table is not on a card")
        self.handle = handle
        self._destroy = lib.ct_ctx_destroy
        self.clear_fn = lib.ct_sharded_clear_host
        self.seed_fn = lib.ct_seed_slots_host
        self.read_fn = lib.ct_read_slots_host
        self.remote_fn = lib.ct_apply_remote_host
        self.staged_fn = lib.ct_apply_remote_staged
        self.clear_slots_fn = lib.ct_clear_slots_host
        self.drain_fn = lib.ct_drain_top_hits_host
        self.sharded_update_fn = lib.ct_sharded_update_host
        self.replicated_update_fn = lib.ct_update_replicated_host
        self.update_fn = lib.ct_update_host
        self.credit_fn = lib.ct_credit_host
        self._results_fn = lib.ct_ctx_results
        #: entries one launch carries: all-rows slots, pairs, seed rows,
        #: slots read (B3a), remote-share rows (B6c), slots cleared (B3b),
        #: update and credit entries (B7c, B6b, B2, B4c; a longer list is
        #: staged, still one launch)
        self.capacity = tuple(lib.ct_host_list_capacity(k) for k in range(7))

    def reserve(self, n: int) -> np.ndarray:
        """Grow the answer buffer to at least ``n`` int32 pairs (B3a's
        (value, ttl), B5's and B7d's (count, slot); a power of two, 1024
        at least)
        and return ``results``, its numpy view, which every read and
        drain overwrites."""
        cap = max(1024, 1 << (n - 1).bit_length())
        ptr = self._results_fn(self.handle, cap) if self.handle else None
        if not ptr:
            raise RuntimeError(
                f"ct_ctx_results: no answer buffer of {cap} pairs (a closed "
                f"context, or pinned host memory exhausted)")
        self.results = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int32)), shape=(cap, 2))
        return self.results

    def close(self) -> None:
        handle, self.handle = self.handle, None
        self.results = self._NO_RESULTS
        if handle:
            self._destroy(handle)

    def __del__(self):
        self.close()


def _now(now_ms) -> int:
    now = int(now_ms)
    if not -(1 << 31) <= now < (1 << 31):
        raise ValueError(f"now_ms {now} outside int32")
    return now


# -- shared plain building blocks -------------------------------------------


def _sort_segments(slots: torch.Tensor):
    """Stable sort of hits by slot plus the segment structure over the
    sorted order: (order, s_slot, is_start, is_end, seg_id)."""
    order = torch.sort(slots, stable=True).indices
    s_slot = slots[order]
    boundary = s_slot[1:] != s_slot[:-1]
    one = torch.ones(1, dtype=torch.bool, device=slots.device)
    is_start = torch.cat([one, boundary])
    is_end = torch.cat([boundary, one])
    seg_id = torch.cumsum(is_start, 0, dtype=_I32).long() - 1
    return order, s_slot, is_start, is_end, seg_id


def _seg_sum(x: torch.Tensor, seg_id: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x).index_add_(0, seg_id, x)


def _seg_max(x: torch.Tensor, seg_id: torch.Tensor) -> torch.Tensor:
    init = torch.full_like(x, -(1 << 31))
    return init.scatter_reduce_(0, seg_id, x, "amax", include_self=True)


def _seg_exclusive_prefix(contrib, seg_start_idx):
    """Exclusive prefix sum of ``contrib`` restarting at each segment
    start (int32, wrapping like XLA's cumsum)."""
    pre = torch.cumsum(contrib, 0, dtype=_I32) - contrib
    return pre - pre[seg_start_idx]


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


# -- B1: the fused exact admission -------------------------------------------


class _CheckPlan(NamedTuple):
    """One table's batch, sorted and read, ready for the admission
    fixpoint: what ``check_and_update_core`` computes before its
    ``while_loop`` (``_check_prepare``), what each sweep needs
    (``_check_sweep``) and what the writes need (``_check_finish``)."""

    state: CounterTableState
    now: int
    order: torch.Tensor
    s_slot: torch.Tensor
    is_end: torch.Tensor
    seg_id: torch.Tensor
    seg_start_idx: torch.Tensor
    s_delta: torch.Tensor
    s_max: torch.Tensor
    s_req: torch.Tensor
    s_win: torch.Tensor
    s_fresh: torch.Tensor
    s_bucket: torch.Tensor
    v_raw: torch.Tensor
    e_raw: torch.Tensor
    h_fresh: torch.Tensor
    expired: torch.Tensor
    tat_eff: torch.Tensor
    base_rel: torch.Tensor
    v_eff: torch.Tensor


def _check_prepare(state, slots, deltas, maxes, windows_ms, req_ids, fresh,
                   bucket, now_ms, base_hook=None,
                   tat_floor_hook=None) -> _CheckPlan:
    values, expiry, _hits = state
    now = _now(now_ms)
    H = slots.shape[0]
    order, s_slot, is_start, is_end, seg_id = _sort_segments(slots)
    s_slot_l = s_slot.long()
    s_win = windows_ms[order]
    s_max = maxes[order]
    s_bucket = bucket[order]
    s_fresh = fresh[order]
    v_raw = values[s_slot_l]
    e_raw = expiry[s_slot_l]
    # Freshness is a segment property for reads: every hit of a recycled
    # slot ignores the previous occupant's cell.
    h_fresh = _seg_max(s_fresh.to(_I32), seg_id).bool()[seg_id]
    e_eff = torch.where(h_fresh, s_win + now, e_raw)
    expired = e_eff <= now
    v_window = torch.where(expired | h_fresh, 0, v_raw)
    local_tat = torch.where(h_fresh, 0, e_raw)
    tat_eff = (
        local_tat if tat_floor_hook is None
        else torch.maximum(local_tat, tat_floor_hook(s_slot_l))
    )
    base_rel = torch.clamp_min(tat_eff - now, 0)
    s_ival = torch.clamp_min(s_win, 1)
    tau = (s_max - 1) * torch.where(s_bucket, s_win, 0)
    spent = s_max - (_floordiv(tau - base_rel, s_ival) + 1)
    v_local = torch.where(s_bucket, spent, v_window)
    v_eff = v_local if base_hook is None else base_hook(v_local, s_slot_l)
    idx = torch.arange(H, dtype=_I32, device=slots.device)
    seg_start_idx = torch.cummax(
        torch.where(is_start, idx, 0), 0
    ).values.long()
    return _CheckPlan(
        state, now, order, s_slot, is_end, seg_id, seg_start_idx,
        deltas[order], s_max, req_ids[order].long(), s_win, s_fresh,
        s_bucket, v_raw, e_raw, h_fresh, expired, tat_eff, base_rel, v_eff,
    )


def _check_sweep(plan: _CheckPlan, admitted, num_req: int):
    """One sweep of the fixpoint over one table: each hit's ``ok`` under
    ``admitted`` and the table's vote per request id (True where the
    request has no hit here, as ``segment_min``'s identity is)."""
    contrib = torch.where(admitted[plan.s_req], plan.s_delta, 0)
    pending = _seg_exclusive_prefix(contrib, plan.seg_start_idx)
    ok = plan.v_eff + pending + plan.s_delta <= plan.s_max
    vote = torch.ones(num_req, dtype=_I32, device=ok.device)
    vote.scatter_reduce_(0, plan.s_req, ok.to(_I32), "amin",
                         include_self=True)
    return vote.bool(), ok


def _fixpoint(sweep, num_req: int, device):
    """The JAX ``while_loop``: sweep from all-admitted until no vote
    changes, at most ``num_req`` sweeps. ``sweep(admitted)`` returns the
    new votes and what the last sweep computed besides."""
    admitted0 = torch.ones(num_req, dtype=torch.bool, device=device)
    admitted, extra = sweep(admitted0)
    changed = bool((admitted != admitted0).any())
    it = 1
    while changed and it < num_req:
        admitted_new, extra = sweep(admitted)
        changed = bool((admitted_new != admitted).any())
        admitted = admitted_new
        it += 1
    return admitted, extra


def _check_finish(plan: _CheckPlan, admitted, ok_sorted) -> BatchResult:
    """Per-hit outputs at the hit's turn and one write per segment, at
    its last hit, under the final ``admitted``. In place."""
    values, expiry, hits = plan.state
    now = plan.now
    s_slot, seg_id, s_delta, s_max, s_win = (
        plan.s_slot, plan.seg_id, plan.s_delta, plan.s_max, plan.s_win)
    s_bucket, h_fresh, e_raw = plan.s_bucket, plan.h_fresh, plan.e_raw
    H = s_slot.shape[0]
    is_admitted_hit = admitted[plan.s_req]
    contrib_final = torch.where(is_admitted_hit, s_delta, 0)
    pending_final = _seg_exclusive_prefix(contrib_final, plan.seg_start_idx)
    remaining = torch.clamp_min(
        s_max - (plan.v_eff + pending_final + s_delta), 0)
    reset_before = plan.expired & (pending_final > 0)
    ttl_window = torch.where(
        reset_before | h_fresh, s_win, torch.clamp_min(e_raw - now, 0)
    )
    ttl_ms = torch.where(
        s_bucket, plan.base_rel + pending_final * s_win, ttl_window
    )

    scratch = values.shape[0] - 1
    h_total = _seg_sum(contrib_final, seg_id)[seg_id]
    h_adm = _seg_max(is_admitted_hit.to(_I32), seg_id).bool()[seg_id]
    h_win = _seg_max(
        torch.where(is_admitted_hit | plan.s_fresh, s_win, 0), seg_id
    )[seg_id]
    starts_fresh = (e_raw <= now) | h_fresh
    val_new = torch.where(
        s_bucket, 0,
        torch.clamp_max(torch.where(starts_fresh, 0, plan.v_raw) + h_total,
                        _NEVER),
    )
    is_end = plan.is_end
    write_val = is_end & (h_adm | h_fresh)
    reset_window = (h_adm & starts_fresh) | h_fresh
    reset = is_end & torch.where(s_bucket, h_adm | h_fresh, reset_window)
    tat_base = torch.clamp_min(plan.tat_eff, now)
    exp_new = torch.where(s_bucket, tat_base + h_total * s_win, h_win + now)
    seg_count = _seg_sum(torch.ones_like(s_slot), seg_id)[seg_id]
    base_hits = torch.where(h_fresh, 0, hits[s_slot.long()])
    hit_count = torch.clamp_max(base_hits + seg_count, _NEVER)

    scratch_t = torch.full_like(s_slot, scratch)
    values[torch.where(write_val, s_slot, scratch_t).long()] = val_new
    expiry[torch.where(reset, s_slot, scratch_t).long()] = exp_new
    hits[torch.where(is_end, s_slot, scratch_t).long()] = hit_count
    values[scratch] = 0
    expiry[scratch] = 0
    hits[scratch] = 0

    inv = torch.empty_like(plan.order)
    inv[plan.order] = torch.arange(H, device=s_slot.device)
    return BatchResult(admitted, ok_sorted[inv], remaining[inv], ttl_ms[inv])


def check_and_update_plain(
    state: CounterTableState,
    slots, deltas, maxes, windows_ms, req_ids, fresh, bucket, now_ms,
    base_hook=None, tat_floor_hook=None,
) -> BatchResult:
    """Plain PyTorch twin of ``check_and_update_core`` on one chip.
    Updates ``state`` in place; returns the per-request and per-hit
    outputs. The hooks are the core's: ``base_hook(v_local, s_slot)``
    gives the effective base per sorted hit, ``tat_floor_hook(s_slot)``
    a floor max-merged into the bucket lanes' TAT (read and write base
    alike); None leaves B1 as it is."""
    plan = _check_prepare(state, slots, deltas, maxes, windows_ms, req_ids,
                          fresh, bucket, now_ms, base_hook, tat_floor_hook)
    H = slots.shape[0]
    admitted, ok_sorted = _fixpoint(
        lambda adm: _check_sweep(plan, adm, H), H, slots.device)
    return _check_finish(plan, admitted, ok_sorted)


def check_route(H: int) -> str:
    """B1's CUDA kernel for a batch of H hits: "cluster" (the
    thread-block cluster, ``check_cluster_kernel``) for ``CLUSTER_MIN_HITS
    <= H <= CLUSTER_MAX_HITS``, else "block" (the one-block
    ``check_kernel``). A rule on H alone: both kernels compute the same
    function."""
    return "cluster" if CLUSTER_MIN_HITS <= H <= CLUSTER_MAX_HITS \
        else "block"


def check_and_update_batch(
    state: CounterTableState,
    slots: torch.Tensor,       # int32[H] slot per hit (C for padding)
    deltas: torch.Tensor,      # int32[H]
    maxes: torch.Tensor,       # int32[H]
    windows_ms: torch.Tensor,  # int32[H] window, or emission interval I
    req_ids: torch.Tensor,     # int32[H] nondecreasing request id in [0, H)
    fresh: torch.Tensor,       # bool[H] slot newly allocated/recycled
    bucket: torch.Tensor,      # bool[H] GCRA token-bucket hit
    now_ms: int,
    route: Optional[str] = None,
) -> Tuple[CounterTableState, BatchResult]:
    """One fused check-all-then-update-all over a batch of requests (the
    JAX ``check_and_update_batch``). Padding hits use slot C, delta 0,
    max INT32_MAX, fresh and bucket False. Updates ``state`` in place.
    On the card ``route`` picks the kernel: None takes ``check_route(H)``;
    "block" or "cluster" forces one (the kernels' checks and timings
    compare both); a cluster past ``CLUSTER_MAX_HITS`` or one the card
    cannot place raises."""
    if not _on_cuda(state.values):
        return state, check_and_update_plain(
            state, slots, deltas, maxes, windows_ms, req_ids, fresh, bucket,
            now_ms,
        )
    H = slots.shape[0]
    dev = state.values.device
    _require_table(state)
    for name, t in (("slots", slots), ("deltas", deltas), ("maxes", maxes),
                    ("windows_ms", windows_ms), ("req_ids", req_ids)):
        _require(t, name, _I32, H, dev)
    _require(fresh, "fresh", torch.bool, H, dev)
    _require(bucket, "bucket", torch.bool, H, dev)
    if H < 1:
        raise ValueError("check_and_update_batch needs at least one hit")
    route = check_route(H) if route is None else route
    if route not in ("block", "cluster"):
        raise ValueError(f"check_and_update_batch: no route {route!r}")
    lib = build.library()
    result = BatchResult(
        torch.empty(H, dtype=torch.bool, device=dev),
        torch.empty(H, dtype=torch.bool, device=dev),
        torch.empty(H, dtype=_I32, device=dev),
        torch.empty(H, dtype=_I32, device=dev),
    )
    table = [t.data_ptr() for t in state]
    hits = [t.data_ptr() for t in (slots, deltas, maxes, windows_ms, req_ids,
                                   fresh, bucket)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "cluster":
        build.check(lib.ct_check_and_update_cluster(
            *table, *hits, H, state.values.shape[0] - 1, _now(now_ms),
            *(t.data_ptr() for t in result), stream,
        ), "ct_check_and_update_cluster")
        launches["check_and_update_cluster"] += 1
        return state, result
    workspace = torch.empty(
        lib.ct_check_workspace_bytes(H), dtype=torch.uint8, device=dev
    )
    build.check(lib.ct_check_and_update(
        *table, *hits, H, state.values.shape[0] - 1, _now(now_ms),
        workspace.data_ptr(), *(t.data_ptr() for t in result), stream,
    ), "ct_check_and_update")
    launches["check_and_update"] += 1
    return state, result


# -- B2: unconditional increments -------------------------------------------


def update_plain(
    state: CounterTableState, slots, deltas, windows_ms, fresh, bucket, now_ms,
    tat_floor_hook=None,
) -> CounterTableState:
    """Plain PyTorch twin of ``update_core``; ``tat_floor_hook(s_slot)``
    is its floor on the bucket lanes' starting TAT (None: no floor)."""
    values, expiry, hits = state
    now = _now(now_ms)
    scratch = values.shape[0] - 1
    order, s_slot, _is_start, is_end, seg_id = _sort_segments(slots)
    s_slot_l = s_slot.long()
    d = torch.clamp(deltas[order], 0, MAX_DELTA_CAP)
    s_win = windows_ms[order]
    s_fresh = fresh[order]
    s_bucket = bucket[order]

    # Exact per-segment sum through four 8-bit lanes with carries,
    # saturating at MAX_VALUE_CAP.
    l0 = _seg_sum(d & 0xFF, seg_id)
    l1 = _seg_sum((d >> 8) & 0xFF, seg_id)
    l2 = _seg_sum((d >> 16) & 0xFF, seg_id)
    l3 = _seg_sum(d >> 24, seg_id)
    t1 = l1 + (l0 >> 8)
    t2 = l2 + (t1 >> 8)
    t3 = l3 + (t2 >> 8)
    exact = (l0 & 0xFF) + ((t1 & 0xFF) << 8) + ((t2 & 0xFF) << 16) + (t3 << 24)
    seg_add = torch.where(
        t3 >= 64, MAX_VALUE_CAP, torch.clamp_max(exact, MAX_VALUE_CAP)
    )[seg_id]
    h_fresh = _seg_max(s_fresh.to(_I32), seg_id).bool()[seg_id]
    h_win = _seg_max(s_win, seg_id)[seg_id]

    v_raw = values[s_slot_l]
    e_raw = expiry[s_slot_l]
    cell_expired = (e_raw <= now) | h_fresh
    base_c = torch.clamp_max(torch.where(cell_expired, 0, v_raw), MAX_VALUE_CAP)
    headroom = MAX_VALUE_CAP - base_c
    val_new = torch.where(
        s_bucket, 0, base_c + torch.minimum(seg_add, headroom)
    )
    # Bucket TAT advance, clamped so max(TAT, now) + adv*I fits int32.
    s_ival = torch.clamp_min(s_win, 1)
    local_tat = torch.where(h_fresh, 0, e_raw)
    if tat_floor_hook is not None:
        local_tat = torch.maximum(local_tat, tat_floor_hook(s_slot_l))
    tat_base = torch.clamp_min(local_tat, now)
    max_adv = _floordiv(_NEVER - tat_base, s_ival)
    adv = torch.minimum(seg_add, max_adv)
    exp_new = torch.where(s_bucket, tat_base + adv * s_win, h_win + now)
    seg_count = _seg_sum(torch.ones_like(s_slot), seg_id)[seg_id]
    base_hits = torch.where(h_fresh, 0, hits[s_slot_l])
    hit_count = torch.clamp_max(base_hits + seg_count, _NEVER)

    scratch_t = torch.full_like(s_slot, scratch)
    values[torch.where(is_end, s_slot, scratch_t).long()] = val_new
    expiry[
        torch.where(is_end & (cell_expired | s_bucket), s_slot, scratch_t)
        .long()
    ] = exp_new
    hits[torch.where(is_end, s_slot, scratch_t).long()] = hit_count
    values[scratch] = 0
    expiry[scratch] = 0
    hits[scratch] = 0
    return state


def update_batch(
    state: CounterTableState,
    slots: torch.Tensor,       # int32[H]
    deltas: torch.Tensor,      # int32[H], clipped at 0
    windows_ms: torch.Tensor,  # int32[H]
    fresh: torch.Tensor,       # bool[H]
    bucket: torch.Tensor,      # bool[H]
    now_ms: int,
) -> CounterTableState:
    """Unconditional increments (the JAX ``update_batch``): every delta
    applies, expired windows reset, bucket TATs advance. In place."""
    if not _on_cuda(state.values):
        return update_plain(
            state, slots, deltas, windows_ms, fresh, bucket, now_ms
        )
    H = slots.shape[0]
    dev = state.values.device
    _require_table(state)
    for name, t in (("slots", slots), ("deltas", deltas),
                    ("windows_ms", windows_ms)):
        _require(t, name, _I32, H, dev)
    _require(fresh, "fresh", torch.bool, H, dev)
    _require(bucket, "bucket", torch.bool, H, dev)
    if H < 1:
        raise ValueError("update_batch needs at least one hit")
    lib = build.library()
    workspace = torch.empty(
        lib.ct_update_workspace_bytes(H), dtype=torch.uint8, device=dev
    )
    build.check(lib.ct_update(
        *(t.data_ptr() for t in state),
        *(t.data_ptr() for t in (slots, deltas, windows_ms, fresh, bucket)),
        H, state.values.shape[0] - 1, _now(now_ms), workspace.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    ), "ct_update")
    launches["update"] += 1
    return state


def update_host_plain(state: CounterTableState, entries: np.ndarray,
                      now_ms) -> CounterTableState:
    """Plain twin of ``update_host``: ``update_plain`` over the list's
    entries in list order (an empty list changes nothing, as on the
    card). In place."""
    _require_entries(entries)
    if entries.shape[0] == 0:
        return state
    _require_table_entries(entries, state.values.shape[0])
    return update_plain(
        state, *_entry_columns(entries, state.values.device), now_ms)


def update_host(ctx: TableContext, entries: np.ndarray,
                now_ms) -> CounterTableState:
    """``update_batch`` from a storage's host list, on ``ctx.state`` in
    place: ``entries`` is a numpy int32 [count, 5] list of (row, slot,
    delta, window, flags) entries, row 0, flags bit 0 fresh and bit 1
    bucket, in the order the JAX call's columns hold them (its padding
    entries, the scratch slot, are left out: they change nothing but the
    scratch cell, which every update leaves at 0). Each cell's bucket
    interval is its last entry's in list order, as the JAX call's stable
    sort leaves it. On the card one C call, one launch on the context's
    stream (``ct_update_host``, which refuses a context of more than one
    row): B7c's body on the one row, the list in the kernel's parameter
    block up to ``ctx.capacity[6]`` entries and past it in one staged
    copy, never split. No padding, no upload, no tensor, no
    workspace."""
    if not ctx.cuda:
        return update_host_plain(ctx.state, entries, now_ms)
    _require_entries(entries)
    now = _now(now_ms)
    if not ctx.handle:
        raise RuntimeError("update_host: the launch context is closed")
    count = entries.shape[0]
    if count == 0:
        return ctx.state
    rc = ctx.update_fn(ctx.handle, entries.tobytes(), count, now)
    if rc:
        build.check(rc, "ct_update_host")
    launches["update_host"] += 1
    return ctx.state


# -- B3: reads and clears ----------------------------------------------------


def read_slots_plain(state: CounterTableState, slots, now_ms):
    now = _now(now_ms)
    idx = slots.long()
    v = state.values[idx]
    e = state.expiry_ms[idx]
    return torch.where(e > now, v, 0), torch.clamp_min(e - now, 0)


def read_slots(
    state: CounterTableState, slots: torch.Tensor, now_ms: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Effective (window-aware) value and ttl_ms for a batch of slots."""
    if not _on_cuda(state.values):
        return read_slots_plain(state, slots, now_ms)
    n = slots.shape[0]
    dev = state.values.device
    _require_table(state)
    _require(slots, "slots", _I32, n, dev)
    out_v = torch.empty(n, dtype=_I32, device=dev)
    out_ttl = torch.empty(n, dtype=_I32, device=dev)
    if n == 0:
        return out_v, out_ttl
    build.check(build.library().ct_read_slots(
        state.values.data_ptr(), state.expiry_ms.data_ptr(),
        slots.data_ptr(), n, _now(now_ms), out_v.data_ptr(),
        out_ttl.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    ), "ct_read_slots")
    launches["read_slots"] += 1
    return out_v, out_ttl


def read_slots_host_plain(state: CounterTableState, slots: np.ndarray,
                          now_ms) -> Tuple[np.ndarray, np.ndarray]:
    """Plain twin of ``read_slots_host``: ``read_slots_plain`` on the
    list, the answers as numpy int32 arrays."""
    values, ttls = read_slots_plain(
        state, torch.from_numpy(slots).to(state.values.device), now_ms)
    return values.cpu().numpy(), ttls.cpu().numpy()


def read_slots_host(ctx: TableContext, slots: np.ndarray,
                    now_ms) -> Tuple[np.ndarray, np.ndarray]:
    """``read_slots`` from a host list (numpy int32[n], unpadded) on
    ``ctx.state``: (values, ttl_ms) as numpy int32[n] arrays of their own.
    The JAX call pads to a pow2 bucket with the scratch slot and drops
    those rows; a read of the scratch slot changes nothing, so the bare
    list gives the same answers. On the card the list rides in the
    kernel's parameter block (``ct_read_slots_host``, in chunks past one
    block), the kernel stores each answer into the context's mapped host
    buffer, and the call waits on the context's stream: the answers
    follow every launch queued there before the call (the storage's
    checks, updates and seeds), and are copied out of the buffer, which
    the next read overwrites."""
    if not ctx.cuda:
        return read_slots_host_plain(ctx.state, slots, now_ms)
    n = slots.shape[0]
    _require_host(slots, "slots", n)
    now = _now(now_ms)
    if not ctx.handle:
        raise RuntimeError("read_slots_host: the launch context is closed")
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    results = ctx.results
    if results.shape[0] < n:
        results = ctx.reserve(n)
    rc = ctx.read_fn(ctx.handle, slots.tobytes(), n, now)
    if rc:
        build.check(rc, "ct_read_slots_host")
    launches["read_slots_host"] += -(-n // ctx.capacity[3])
    pairs = results[:n]
    return pairs[:, 0].copy(), pairs[:, 1].copy()


def clear_slots_plain(state: CounterTableState, slots) -> CounterTableState:
    idx = slots.long()
    for t in state:
        t[idx] = 0
    return state


def clear_slots(
    state: CounterTableState, slots: torch.Tensor
) -> CounterTableState:
    """Zero value, expiry and hits at ``slots`` (in place). The storages
    clear through ``clear_slots_host``; this device-tensor form is the
    JAX-shaped call."""
    if not _on_cuda(state.values):
        return clear_slots_plain(state, slots)
    n = slots.shape[0]
    dev = state.values.device
    _require_table(state)
    _require(slots, "slots", _I32, n, dev)
    if n == 0:
        return state
    build.check(build.library().ct_clear_slots(
        *(t.data_ptr() for t in state), slots.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream,
    ), "ct_clear_slots")
    launches["clear_slots"] += 1
    return state


def clear_slots_host_plain(state: CounterTableState,
                           slots: np.ndarray) -> CounterTableState:
    """Plain twin of ``clear_slots_host``: ``clear_slots_plain`` on the
    list, in place."""
    return clear_slots_plain(
        state, torch.from_numpy(slots).to(state.values.device))


def clear_slots_host(ctx: TableContext,
                     slots: np.ndarray) -> CounterTableState:
    """``clear_slots`` from a host list (numpy int32[n]; duplicates and
    the scratch slot allowed: they write the same zeros) on
    ``ctx.state``, in place. On the card the list rides in the kernel's
    parameter block (``ct_clear_slots_host``, one launch per block of
    ``ctx.capacity[5]`` slots, in order on the context's stream): no
    upload, no tensor."""
    if not ctx.cuda:
        return clear_slots_host_plain(ctx.state, slots)
    n = slots.shape[0]
    _require_host(slots, "slots", n)
    if not ctx.handle:
        raise RuntimeError("clear_slots_host: the launch context is closed")
    if n == 0:
        return ctx.state
    rc = ctx.clear_slots_fn(ctx.handle, slots.tobytes(), n)
    if rc:
        build.check(rc, "ct_clear_slots_host")
    launches["clear_slots_host"] += -(-n // ctx.capacity[5])
    return ctx.state


# -- B4a: epoch rebase -------------------------------------------------------


def rebase_expiry_plain(expiry_ms: torch.Tensor, step: int) -> torch.Tensor:
    """One int32 step of the rebase: expiry = max(expiry - step, 0)."""
    return expiry_ms.sub_(int(step)).clamp_min_(0)


def rebase_epoch_chunked(expiry_ms: torch.Tensor, shift: int) -> torch.Tensor:
    """Shift an int32 expiry array by -shift in int32-sized steps,
    clamping at 0 (shift may exceed int32 after a month-long idle gap).
    In place; one launch per step on the card."""
    cuda = _on_cuda(expiry_ms)
    if cuda:
        _require(expiry_ms, "expiry_ms", _I32, expiry_ms.shape[0],
                 expiry_ms.device)
        lib = build.library()
    while shift > 0:
        step = min(shift, (1 << 31) - 1)
        if cuda:
            build.check(lib.ct_rebase_expiry(
                expiry_ms.data_ptr(), expiry_ms.shape[0], step,
                torch.cuda.current_stream(expiry_ms.device).cuda_stream,
            ), "ct_rebase_expiry")
            launches["rebase_epoch"] += 1
        else:
            rebase_expiry_plain(expiry_ms, step)
        shift -= step
    return expiry_ms


# -- B4b: epoch rebase by a device scalar ------------------------------------


def rebase_epoch_plain(
    state: CounterTableState, shift_ms: torch.Tensor
) -> CounterTableState:
    """Plain PyTorch twin of ``rebase_epoch``, in place:
    expiry = max(expiry - shift_ms, 0), the shift a one-element int32
    tensor on the table's device (no host read)."""
    state.expiry_ms.sub_(shift_ms.reshape(())).clamp_min_(0)
    return state


def rebase_epoch(
    state: CounterTableState, shift_ms: torch.Tensor
) -> CounterTableState:
    """Shift every expiry back by ``shift_ms`` (the JAX ``rebase_epoch``):
    already-expired cells clamp at 0 and stay expired. ``shift_ms`` is a
    one-element int32 tensor on the table's device, read by the kernel,
    so the launch needs no host sync. In place. ``TorchStorage`` rebases
    through ``rebase_epoch_chunked`` (its shift is a host int that may
    exceed int32), as the JAX storage does; nothing on the serving paths
    calls this one."""
    if not _on_cuda(state.values):
        return rebase_epoch_plain(state, shift_ms)
    dev = state.values.device
    _require_table(state)
    _require(shift_ms.reshape(1), "shift_ms", _I32, 1, dev)
    build.check(build.library().ct_rebase_epoch(
        state.expiry_ms.data_ptr(), state.expiry_ms.shape[0],
        shift_ms.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    ), "ct_rebase_epoch")
    launches["rebase_epoch_device"] += 1
    return state


# -- B4c: lease credit -------------------------------------------------------


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with XLA's two's-complement wrap."""
    return (((x + (1 << 31)) % (1 << 32)) - (1 << 31)).to(_I32)


def credit_plain(
    state: CounterTableState, slots, credits, windows_ms, bucket, now_ms,
) -> CounterTableState:
    """Plain PyTorch twin of ``credit_batch``, in place. Arithmetic runs
    in int64 and wraps back to int32 where XLA's int32 would wrap."""
    values, expiry, _hits = state
    now = _now(now_ms)
    idx = slots.long()
    v = values[idx].long()
    e = expiry[idx].long()
    c = credits.long()
    live_window = ~bucket & (now < e)
    new_v = torch.where(live_window, torch.clamp_min(_wrap32(v - c), 0), v)
    ival = torch.clamp_min(windows_ms.long(), 1)
    ahead = torch.clamp_min(_wrap32(e - now).long(), 0)
    covers = c >= torch.div(ahead, ival, rounding_mode="floor")
    bucket_live = bucket & (e > now)
    retreat = _wrap32(e - _wrap32(c * ival).long()).long()
    new_e = torch.where(
        bucket_live, torch.where(covers, torch.full_like(e, now), retreat), e
    )
    values[idx] = new_v.to(_I32)
    expiry[idx] = new_e.to(_I32)
    scratch = values.shape[0] - 1
    values[scratch] = 0
    expiry[scratch] = 0
    return state


def credit_batch(
    state: CounterTableState,
    slots: torch.Tensor,       # int32[H] slot per credit (C for padding)
    credits: torch.Tensor,     # int32[H] tokens*delta to return, >= 0
    windows_ms: torch.Tensor,  # int32[H] emission interval I of bucket rows
    bucket: torch.Tensor,      # bool[H]
    now_ms: int,
    check_unique: bool = False,
) -> CounterTableState:
    """Return unused leased quota (the JAX ``credit_batch``): a floored
    subtract on live fixed windows, a TAT retreat floored at now on live
    buckets, the hits column untouched, the scratch row reset. Callers
    pass unique non-scratch slots (the lease broker aggregates per slot);
    ``check_unique`` verifies that, for tests, at the cost of a sync. In
    place."""
    if check_unique:
        real = slots[slots != state.values.shape[0] - 1]
        if torch.unique(real).numel() != real.numel():
            raise ValueError("credit_batch: duplicate slots")
    if not _on_cuda(state.values):
        return credit_plain(state, slots, credits, windows_ms, bucket, now_ms)
    H = slots.shape[0]
    dev = state.values.device
    _require_table(state)
    for name, t in (("slots", slots), ("credits", credits),
                    ("windows_ms", windows_ms)):
        _require(t, name, _I32, H, dev)
    _require(bucket, "bucket", torch.bool, H, dev)
    if H < 1:
        raise ValueError("credit_batch needs at least one row")
    build.check(build.library().ct_credit(
        state.values.data_ptr(), state.expiry_ms.data_ptr(),
        *(t.data_ptr() for t in (slots, credits, windows_ms, bucket)),
        H, state.values.shape[0] - 1, _now(now_ms),
        torch.cuda.current_stream(dev).cuda_stream,
    ), "ct_credit")
    launches["credit"] += 1
    return state


def credit_host_plain(state: CounterTableState, entries: np.ndarray,
                      now_ms) -> CounterTableState:
    """Plain twin of ``credit_host``: ``credit_plain`` over the list's
    columns (an empty list changes nothing, as on the card). In
    place."""
    _require_entries(entries)
    if entries.shape[0] == 0:
        return state
    _require_table_entries(entries, state.values.shape[0])
    slots, credits, windows, _fresh, bucket = _entry_columns(
        entries, state.values.device)
    return credit_plain(state, slots, credits, windows, bucket, now_ms)


def credit_host(ctx: TableContext, entries: np.ndarray, now_ms,
                check_unique: bool = False) -> CounterTableState:
    """``credit_batch`` from the lease broker's host list, on
    ``ctx.state`` in place: ``entries`` is a numpy int32 [count, 5] list
    of (row, slot, credit, interval, flags) entries, row 0, flags bit 1
    bucket (bit 0 unused), unique slots (the broker aggregates by slot;
    ``check_unique`` verifies it on the host, for tests). The JAX call
    pads to a pow2 bucket with scratch rows, which change nothing but
    the scratch cell, which every credit leaves at 0. On the card one C
    call, one launch on the context's stream (``ct_credit_host``): one
    thread an entry, the list in the kernel's parameter block up to
    ``ctx.capacity[6]`` entries and past it in one staged copy. No
    padding, no upload, no tensor."""
    _require_entries(entries)
    if check_unique and np.unique(entries[:, 1]).size != entries.shape[0]:
        raise ValueError("credit_host: duplicate slots")
    if not ctx.cuda:
        return credit_host_plain(ctx.state, entries, now_ms)
    now = _now(now_ms)
    if not ctx.handle:
        raise RuntimeError("credit_host: the launch context is closed")
    count = entries.shape[0]
    if count == 0:
        return ctx.state
    rc = ctx.credit_fn(ctx.handle, entries.tobytes(), count, now)
    if rc:
        build.check(rc, "ct_credit_host")
    launches["credit_host"] += 1
    return ctx.state


# -- B4d: tier promotion seed ------------------------------------------------


def seed_slots_plain(
    state: CounterTableState, slots, values, expiry_ms
) -> CounterTableState:
    """Plain PyTorch twin of ``seed_slots``, in place: the JAX program's
    three scatters (padding rows included, so a padding row zeroes the
    scratch row's hits), then the scratch row's value and expiry reset."""
    idx = slots.long()
    state.values[idx] = values
    state.expiry_ms[idx] = expiry_ms
    state.hits[idx] = 0
    scratch = state.values.shape[0] - 1
    state.values[scratch] = 0
    state.expiry_ms[scratch] = 0
    return state


def seed_slots(
    state: CounterTableState,
    slots: torch.Tensor,      # int32[H] slot per seed (C for padding)
    values: torch.Tensor,     # int32[H] absolute value to write
    expiry_ms: torch.Tensor,  # int32[H] absolute (epoch-relative) expiry
) -> CounterTableState:
    """Absolute cell seed for tier promotion (the JAX ``seed_slots``):
    each slot's value and expiry land verbatim and its hits restart at 0,
    so a counter promoted from the host cold tier keeps its exact count
    and remaining window. Callers pass unique real slots and pad with the
    scratch slot. In place."""
    if not _on_cuda(state.values):
        return seed_slots_plain(state, slots, values, expiry_ms)
    H = slots.shape[0]
    dev = state.values.device
    _require_table(state)
    for name, t in (("slots", slots), ("values", values),
                    ("expiry_ms", expiry_ms)):
        _require(t, name, _I32, H, dev)
    if H < 1:
        raise ValueError("seed_slots needs at least one row")
    build.check(build.library().ct_seed_slots(
        *(t.data_ptr() for t in state),
        *(t.data_ptr() for t in (slots, values, expiry_ms)),
        H, state.values.shape[0] - 1,
        torch.cuda.current_stream(dev).cuda_stream,
    ), "ct_seed_slots")
    launches["seed_slots"] += 1
    return state


def seed_slots_host_plain(state: CounterTableState, slots: np.ndarray,
                          values: np.ndarray, expiry_ms: np.ndarray,
                          padded: bool) -> CounterTableState:
    """Plain twin of ``seed_slots_host``: ``seed_slots_plain`` on the
    unpadded lists, then the scratch hits a padding row would zero."""
    dev = state.values.device
    seed_slots_plain(state, *(torch.from_numpy(a).to(dev)
                              for a in (slots, values, expiry_ms)))
    if padded:
        state.hits[-1] = 0
    return state


def seed_slots_host(ctx: TableContext, slots: np.ndarray,
                    values: np.ndarray, expiry_ms: np.ndarray,
                    padded: bool) -> CounterTableState:
    """``seed_slots`` from host lists (numpy int32[n], unpadded) on
    ``ctx.state``, in place. The JAX call pads to a pow2 bucket with
    scratch rows; ``padded`` says it did, so the scratch hits zero as
    there. On the card the lists ride in the kernel's parameter block
    (``ct_seed_slots_host``): no pinned buffer, no device copy, no
    tensor; a list longer than one block launches in chunks. The lists
    reach C as ``bytes`` (a copy of 4 bytes a row, cheaper than
    ``ndarray.ctypes``)."""
    if not ctx.cuda:
        return seed_slots_host_plain(ctx.state, slots, values, expiry_ms,
                                     padded)
    n = slots.shape[0]
    _require_host(slots, "slots", n)
    _require_host(values, "values", n)
    _require_host(expiry_ms, "expiry_ms", n)
    rc = ctx.seed_fn(ctx.handle, slots.tobytes(), values.tobytes(),
                     expiry_ms.tobytes(), n, int(padded))
    if rc:
        build.check(rc, "ct_seed_slots_host")
    launches["seed_slots"] += max(-(-n // ctx.capacity[2]), 1)
    return ctx.state


# -- B5: heavy-hitter drain --------------------------------------------------


def drain_top_hits_plain(hits: torch.Tensor, k: int):
    """Plain PyTorch twin of ``drain_top_hits``: a stable descending sort
    of ``hits[:-1]`` (ties keep the lowest index first, as ``lax.top_k``
    does; ``torch.topk`` orders ties otherwise on the CPU), its first
    ``k``, then the column zeroed in place."""
    counts, order = torch.sort(hits[:-1], descending=True, stable=True)
    counts = counts[:k].clone()
    slots = order[:k].to(_I32)
    hits.zero_()
    return hits, counts, slots


def drain_top_hits(
    hits: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Read-and-reset the per-slot hit accumulator (the JAX
    ``drain_top_hits``): returns (the zeroed column, counts[k] descending,
    slots[k]), ties to the lowest slot; rows with count 0 are filler.
    The scratch row is zeroed and never reported. ``1 <= k <= C``. The
    column is zeroed in place. On the card, for k <= 1024, one launch of
    B5's one-pass kernel (after a 256-byte memset of its fresh
    workspace's done counter); the storages drain through
    ``drain_top_hits_host``."""
    n = hits.shape[0]
    k = int(k)
    if not 1 <= k <= n - 1:
        raise ValueError(f"drain_top_hits: k={k} outside [1, {n - 1}]")
    if not _on_cuda(hits):
        return drain_top_hits_plain(hits, k)
    dev = hits.device
    _require(hits, "hits", _I32, n, dev)
    lib = build.library()
    workspace = torch.empty(
        lib.ct_topk_workspace_bytes(n, k), dtype=torch.uint8, device=dev
    )
    counts = torch.empty(k, dtype=_I32, device=dev)
    slots = torch.empty(k, dtype=_I32, device=dev)
    build.check(lib.ct_drain_top_hits(
        hits.data_ptr(), n, k, workspace.data_ptr(), counts.data_ptr(),
        slots.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    ), "ct_drain_top_hits")
    launches["drain_top_hits"] += 1
    return hits, counts, slots


def drain_top_hits_host_plain(state: CounterTableState,
                              k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Plain twin of ``drain_top_hits_host``: ``drain_top_hits_plain``
    on the table's hit column, the answers as numpy int32 arrays."""
    _, counts, slots = drain_top_hits_plain(state.hits, k)
    return counts.cpu().numpy(), slots.cpu().numpy()


def drain_top_hits_host(ctx: TableContext,
                        k: int) -> Tuple[np.ndarray, np.ndarray]:
    """``drain_top_hits`` on ``ctx.state``'s hit column, answered on the
    host: (counts, slots) as numpy int32[k] arrays of their own, the
    column zeroed in place. On the card one C call launches B5's
    one-pass kernel (for k <= 1024; a larger k the full sort) with the
    context's own workspace, the kernel stores the k (count, slot) pairs
    into the context's mapped host buffer (B3a's), and the call waits on
    the context's stream: the drain follows every launch queued there
    before it, and needs no allocation, no output tensor and no copy.
    The next read or drain overwrites the buffer; the answers are copied
    out of it first."""
    n = ctx.state.hits.shape[0]
    k = int(k)
    if not 1 <= k <= n - 1:
        raise ValueError(f"drain_top_hits_host: k={k} outside [1, {n - 1}]")
    if not ctx.cuda:
        return drain_top_hits_host_plain(ctx.state, k)
    if not ctx.handle:
        raise RuntimeError("drain_top_hits_host: the launch context is "
                           "closed")
    results = ctx.results
    if results.shape[0] < k:
        results = ctx.reserve(k)
    rc = ctx.drain_fn(ctx.handle, k)
    if rc:
        build.check(rc, "ct_drain_top_hits_host")
    launches["drain_top_hits_host"] += 1
    pairs = results[:k]
    return pairs[:, 0].copy(), pairs[:, 1].copy()


# -- B6: the replicated topology --------------------------------------------
#
# A replicated node (device/replicated.py) keeps two more int32[C+1] lanes
# beside its table: remote_vals, the live sum of peers' window counts per
# slot, and remote_exp, their latest expiry (windows) or the max-merged
# remote TAT (buckets), both relative to the table's epoch.


def _remote_hooks(remote_vals, remote_exp, slots, bucket, now):
    """The JAX ``_replicated_check``'s hooks (tpu/replicated.py:55-93),
    over hits sorted as the core sorts them: window lanes add the live
    remote sum (``now < remote_exp``, strict) to their base, bucket lanes
    take ``remote_exp`` as a floor on their TAT (``_replicated_update``
    uses this one alone)."""
    order = torch.sort(slots, stable=True).indices
    s_bucket = bucket[order]

    def base_hook(v_local, s_slot):
        live = now < remote_exp[s_slot]
        return v_local + torch.where(s_bucket | ~live, 0,
                                     remote_vals[s_slot])

    def tat_floor_hook(s_slot):
        return torch.where(s_bucket, remote_exp[s_slot], 0)

    return base_hook, tat_floor_hook


def replicated_check_plain(
    state: CounterTableState, remote_vals, remote_exp,
    slots, deltas, maxes, windows_ms, req_ids, fresh, bucket, now_ms,
) -> BatchResult:
    """Plain PyTorch twin of ``_replicated_check``: B1 over the merged
    admission base; only the local cells are written. In place."""
    base_hook, tat_floor_hook = _remote_hooks(
        remote_vals, remote_exp, slots, bucket, _now(now_ms)
    )
    return check_and_update_plain(
        state, slots, deltas, maxes, windows_ms, req_ids, fresh, bucket,
        now_ms, base_hook=base_hook, tat_floor_hook=tat_floor_hook,
    )


def replicated_check_batch(
    state: CounterTableState,
    remote_vals: torch.Tensor,  # int32[C+1] live remote window sums
    remote_exp: torch.Tensor,   # int32[C+1] remote expiry / bucket TAT
    slots: torch.Tensor,
    deltas: torch.Tensor,
    maxes: torch.Tensor,
    windows_ms: torch.Tensor,
    req_ids: torch.Tensor,
    fresh: torch.Tensor,
    bucket: torch.Tensor,
    now_ms: int,
    route: Optional[str] = None,
) -> Tuple[CounterTableState, BatchResult]:
    """B1 with the gossip hooks (the JAX ``_replicated_check``): window
    lanes read their base as local + live remote sum, bucket lanes read
    and write from max(local TAT, remote TAT). The remote lanes are only
    read. Updates ``state`` in place. On the card ``route`` picks the
    kernel as B1's does: None takes ``check_route(H)`` (the cluster from
    1,024 to 16,384 hits, else one block); "block" or "cluster" forces
    one; a cluster past ``CLUSTER_MAX_HITS`` or one the card cannot place
    raises."""
    if not _on_cuda(state.values):
        return state, replicated_check_plain(
            state, remote_vals, remote_exp, slots, deltas, maxes,
            windows_ms, req_ids, fresh, bucket, now_ms,
        )
    H = slots.shape[0]
    dev = state.values.device
    _require_table(state)
    n = state.values.shape[0]
    _require(remote_vals, "remote_vals", _I32, n, dev)
    _require(remote_exp, "remote_exp", _I32, n, dev)
    for name, t in (("slots", slots), ("deltas", deltas), ("maxes", maxes),
                    ("windows_ms", windows_ms), ("req_ids", req_ids)):
        _require(t, name, _I32, H, dev)
    _require(fresh, "fresh", torch.bool, H, dev)
    _require(bucket, "bucket", torch.bool, H, dev)
    if H < 1:
        raise ValueError("replicated_check_batch needs at least one hit")
    route = check_route(H) if route is None else route
    if route not in ("block", "cluster"):
        raise ValueError(f"replicated_check_batch: no route {route!r}")
    lib = build.library()
    result = BatchResult(
        torch.empty(H, dtype=torch.bool, device=dev),
        torch.empty(H, dtype=torch.bool, device=dev),
        torch.empty(H, dtype=_I32, device=dev),
        torch.empty(H, dtype=_I32, device=dev),
    )
    head = [t.data_ptr() for t in (*state, remote_vals, remote_exp, slots,
                                   deltas, maxes, windows_ms, req_ids,
                                   fresh, bucket)]
    tail = [t.data_ptr() for t in result]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "cluster":
        build.check(lib.ct_check_and_update_replicated_cluster(
            *head, H, n - 1, _now(now_ms), *tail, stream,
        ), "ct_check_and_update_replicated_cluster")
        launches["replicated_check_cluster"] += 1
        return state, result
    workspace = torch.empty(
        lib.ct_check_workspace_bytes(H), dtype=torch.uint8, device=dev
    )
    build.check(lib.ct_check_and_update_replicated(
        *head, H, n - 1, _now(now_ms), workspace.data_ptr(), *tail, stream,
    ), "ct_check_and_update_replicated")
    launches["replicated_check"] += 1
    return state, result


def replicated_update_plain(
    state: CounterTableState, remote_exp, slots, deltas, windows_ms, fresh,
    bucket, now_ms,
) -> CounterTableState:
    """Plain PyTorch twin of ``_replicated_update``: B2 with the remote
    TAT as a floor on bucket lanes before the advance. In place."""
    _, tat_floor_hook = _remote_hooks(None, remote_exp, slots, bucket,
                                      _now(now_ms))
    return update_plain(
        state, slots, deltas, windows_ms, fresh, bucket, now_ms,
        tat_floor_hook=tat_floor_hook,
    )


def replicated_update_batch(
    state: CounterTableState,
    remote_exp: torch.Tensor,  # int32[C+1] remote expiry / bucket TAT
    slots: torch.Tensor,
    deltas: torch.Tensor,
    windows_ms: torch.Tensor,
    fresh: torch.Tensor,
    bucket: torch.Tensor,
    now_ms: int,
) -> CounterTableState:
    """B2 with the gossiped TAT floor folded into bucket lanes (the JAX
    ``_replicated_update``); window lanes are B2's. In place."""
    if not _on_cuda(state.values):
        return replicated_update_plain(
            state, remote_exp, slots, deltas, windows_ms, fresh, bucket,
            now_ms,
        )
    H = slots.shape[0]
    dev = state.values.device
    _require_table(state)
    n = state.values.shape[0]
    _require(remote_exp, "remote_exp", _I32, n, dev)
    for name, t in (("slots", slots), ("deltas", deltas),
                    ("windows_ms", windows_ms)):
        _require(t, name, _I32, H, dev)
    _require(fresh, "fresh", torch.bool, H, dev)
    _require(bucket, "bucket", torch.bool, H, dev)
    if H < 1:
        raise ValueError("replicated_update_batch needs at least one hit")
    lib = build.library()
    workspace = torch.empty(
        lib.ct_update_workspace_bytes(H), dtype=torch.uint8, device=dev
    )
    build.check(lib.ct_update_replicated(
        *(t.data_ptr() for t in state), remote_exp.data_ptr(),
        *(t.data_ptr() for t in (slots, deltas, windows_ms, fresh, bucket)),
        H, n - 1, _now(now_ms), workspace.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    ), "ct_update_replicated")
    launches["replicated_update"] += 1
    return state


def replicated_update_host_plain(state: CounterTableState,
                                 remote_exp: torch.Tensor,
                                 entries: np.ndarray,
                                 now_ms) -> CounterTableState:
    """Plain twin of ``replicated_update_host``: ``replicated_update_plain``
    over the list's entries in list order (an empty list changes
    nothing, as on the card). In place."""
    _require_entries(entries)
    if entries.shape[0] == 0:
        return state
    _require_table_entries(entries, state.values.shape[0])
    return replicated_update_plain(
        state, remote_exp, *_entry_columns(entries, state.values.device),
        now_ms)


def replicated_update_host(ctx: TableContext, remote_ctx: TableContext,
                           entries: np.ndarray,
                           now_ms) -> CounterTableState:
    """``replicated_update_batch`` from a replicated node's host list, on
    ``ctx.state`` in place: ``entries`` is a numpy int32 [count, 5] list
    of (row, slot, delta, window, flags) entries, row 0, flags bit 0
    fresh and bit 1 bucket, in the order the JAX call's columns hold
    them (its padding entries, the scratch slot, are left out); the
    remote TAT floor is ``remote_ctx.state.expiry_ms``, the node's
    ``remote_exp`` lane. On the card one C call, one launch on the
    context's stream (``ct_update_replicated_host``): B7c's body on the
    one row with the floor, the list in the kernel's parameter block up
    to ``ctx.capacity[6]`` entries and past it in one staged copy, never
    split. No padding, no upload, no tensor, no workspace. The caller
    passes the current contexts at every call: each is rebound when its
    lanes are replaced."""
    if not ctx.cuda:
        return replicated_update_host_plain(
            ctx.state, remote_ctx.state.expiry_ms, entries, now_ms)
    _require_entries(entries)
    now = _now(now_ms)
    if not ctx.handle or not remote_ctx.handle:
        raise RuntimeError("replicated_update_host: a launch context is "
                           "closed")
    count = entries.shape[0]
    if count == 0:
        return ctx.state
    rc = ctx.replicated_update_fn(ctx.handle, remote_ctx.handle,
                                  entries.tobytes(), count, now)
    if rc:
        build.check(rc, "ct_update_replicated_host")
    launches["replicated_update_host"] += 1
    return ctx.state


def apply_remote_plain(remote_vals, remote_exp, slots, sums, expiries):
    """Plain PyTorch twin of ``_apply_remote``: an index assignment of
    both lanes. In place."""
    idx = slots.long()
    remote_vals[idx] = sums
    remote_exp[idx] = expiries
    return remote_vals, remote_exp


def apply_remote(
    remote_vals: torch.Tensor,  # int32[C+1]
    remote_exp: torch.Tensor,   # int32[C+1]
    slots: torch.Tensor,        # int32[n] unique slots
    sums: torch.Tensor,         # int32[n]
    expiries: torch.Tensor,     # int32[n]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter refreshed remote shares into the remote lanes (the JAX
    ``_apply_remote``): ``remote_vals[slots] = sums``, ``remote_exp[slots]
    = expiries``. ``slots`` must be unique (the replicated storage's dirty
    map is keyed by slot). ``n`` is not bucketed. In place."""
    if not _on_cuda(remote_vals):
        return apply_remote_plain(remote_vals, remote_exp, slots, sums,
                                  expiries)
    n = slots.shape[0]
    dev = remote_vals.device
    c1 = remote_vals.shape[0]
    _require(remote_vals, "remote_vals", _I32, c1, dev)
    _require(remote_exp, "remote_exp", _I32, c1, dev)
    for name, t in (("slots", slots), ("sums", sums),
                    ("expiries", expiries)):
        _require(t, name, _I32, n, dev)
    if n == 0:
        return remote_vals, remote_exp
    build.check(build.library().ct_apply_remote(
        remote_vals.data_ptr(), remote_exp.data_ptr(), slots.data_ptr(),
        sums.data_ptr(), expiries.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream,
    ), "ct_apply_remote")
    launches["apply_remote"] += 1
    return remote_vals, remote_exp


def apply_remote_host_plain(state: CounterTableState, slots: np.ndarray,
                            sums: np.ndarray,
                            expiries: np.ndarray) -> CounterTableState:
    """Plain twin of ``apply_remote_host``: ``apply_remote_plain`` on the
    lanes ``state`` binds (values and expiry_ms), in place."""
    dev = state.values.device
    apply_remote_plain(state.values, state.expiry_ms,
                       *(torch.from_numpy(a).to(dev)
                         for a in (slots, sums, expiries)))
    return state


def apply_remote_host(ctx: TableContext, slots: np.ndarray, sums: np.ndarray,
                      expiries: np.ndarray) -> CounterTableState:
    """``apply_remote`` from host rows (numpy int32[n] each, unique
    slots) on a context bound to the remote lanes, as
    ``TableContext(CounterTableState(remote_vals, remote_exp,
    remote_exp))``: ``remote_vals[slots] = sums``, ``remote_exp[slots] =
    expiries``, nothing else written. In place; one C call and one launch
    on the context's stream, no tensor. Rows that fit in one kernel
    parameter block (2,666 with nvcc 12.1 or later) ride in it
    (``ct_apply_remote_host``); more take the staged design
    (``ct_apply_remote_staged``: the C call packs them into the
    context's pinned buffer, one copy to its device buffer, one
    ``apply_remote_kernel``), which measured faster than a chain of full
    parameter blocks from 12,288 rows (PERF.md)."""
    if not ctx.cuda:
        return apply_remote_host_plain(ctx.state, slots, sums, expiries)
    n = slots.shape[0]
    _require_host(slots, "slots", n)
    _require_host(sums, "sums", n)
    _require_host(expiries, "expiries", n)
    if not ctx.handle:
        raise RuntimeError("apply_remote_host: the launch context is closed")
    if n == 0:
        return ctx.state
    fn = ctx.remote_fn if n <= ctx.capacity[4] else ctx.staged_fn
    rc = fn(ctx.handle, slots.tobytes(), sums.tobytes(), expiries.tobytes(),
            n)
    if rc:
        build.check(rc, "ct_apply_remote_host" if fn is ctx.remote_fn
                    else "ct_apply_remote_staged")
    launches["apply_remote_host"] += 1
    return ctx.state
