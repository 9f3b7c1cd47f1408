// Counter-table kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Hand-written replacements for the jitted XLA programs of
// limitador_tpu/ops/kernel.py. Every kernel computes exactly what its JAX
// program computes, bit for bit, including where int32 arithmetic wraps:
// XLA's int32 wraps, C++'s signed overflow is undefined, so every sum,
// difference and product that can wrap goes through uint32 (wadd, wsub,
// wmul below), and every division floors as jnp's // does (floordiv).
//
// The table is three int32[C+1] columns (values, expiry_ms, hits); row C
// is the scratch row that padding hits point at and that every writing
// kernel leaves at 0. A batch holds H hits.
//
// Bound on the H100 (3.35 TB/s): a batch must read its H hits (7 columns,
// 22 bytes each), gather 3 cells per hit, write its outputs (10 bytes per
// hit) and write back 3 cells per touched slot: about 60 bytes per hit,
// 2 MB for H = 32768, which is 0.6 us. Nothing in that is compute bound,
// so the bound is bytes. What keeps these kernels far above it is not
// bandwidth but latency: the check's admission is a data-dependent
// fixpoint over a sorted batch, a chain of dependent block-wide phases.
//
// Design of the check (replacing check_and_update_core /
// check_and_update_batch, ops/kernel.py:153-430): batches of 1,024 to
// 16,384 hits run on a thread-block cluster (ct_check_and_update_cluster,
// check_cluster_kernel below: one block of up to 1024 threads per 1024
// hits, every per-hit array in distributed shared memory). Below 1,024
// hits (where it measured faster) and above the cluster's capacity, ONE
// thread block of 1024 threads walks the whole batch
// (ct_check_and_update, check_kernel), as does the update (ct_update,
// replacing update_core / update_batch, :433-576), with __syncthreads
// between phases and __syncthreads_or for the fixpoint's "changed" test.
// One block means no cross-block synchronisation, so the phases can
// depend on each other freely; the cost is that one SM does all the
// work. Its per-hit intermediates live in a device workspace the wrapper
// allocates (L1/L2 resident at these sizes); the sort keys live in
// shared memory up to 16384 hits.
//   1. Stable sort by slot: a bitonic sort of unique 64-bit keys
//      (slot << 32 | hit index), so equal slots keep input order.
//   2. Segment structure: segment start per sorted hit by a block-wide
//      max-scan; per-segment flags and maxima by writes and atomicMax to
//      the segment's start index.
//   3. The check's fixpoint: per sweep, one block-wide exclusive scan of
//      admitted deltas gives each hit's pending sum; a hit that does not
//      fit votes its request down. It stops when no vote changed, or
//      after H sweeps, as the JAX while_loop does.
//   4. Outputs scatter back to input order through the sort permutation;
//      each segment's last hit writes its cell.
//
// read_slots (:651-659), clear_slots (:662-669) and the two epoch
// rebases (rebase_epoch_chunked, :688-696, and rebase_epoch, :699-707)
// are grid-stride loops over their indices; they are bound by bytes and
// are a few lines each. So is the tier promotion seed (seed_slots,
// :625-648).
//
// The replicated topology (limitador_tpu/tpu/replicated.py:55-125) reuses
// the check and the update as templates on kRemote: B6a is the check with
// the gossip hooks of check_and_update_core (base_hook adds the live
// remote window sum, tat_floor_hook floors bucket TATs at the remote TAT,
// read and write base alike), on B1's two routes (the cluster kernel and
// the one block, both with kRemote, chosen by H as B1's); B6b the update
// with the TAT floor (update_kernel<true> from device tensors; from a
// replicated node's host list the host form of B7c's body with the
// floor, ct_update_replicated_host), and B6c a grid-stride scatter of
// both remote lanes.
//
// The sharded table (limitador_tpu/parallel/mesh.py:399-612) is n rows of
// L + 1 cells, one shard a row, contiguous in memory. B7a has two routes.
// Its cluster route (ct_sharded_check_and_update_cluster) is the cluster
// kernel with kRows over the flattened [n, H] columns: a hit's cell is row
// * (L + 1) + slot, so the rows' cells never share a segment. A coupled or
// global batch of n * H <= 16,384 hits is ONE cluster: the rows' votes
// meet in its shared memory (the pmin), and a global hit sums the live
// partials of its slot over the rows before the first write (the psum).
// A lean batch without a global hit is one cluster a row. The rows route
// (ct_sharded_check_and_update) takes what the cluster cannot: the check
// with kRows a row per block, plus kGlobal (the psum base from a pre-pass
// launch) and kCoupled (the pmin across rows, with grid barriers under a
// cooperative launch). B7c is the update with kRows on its device-tensor
// route and, from the storage's host list, one block over the flattened
// rows (update_list_kernel); B7d is B5's one-pass drain_kernel with the
// row in blockIdx.y; and B7b a grid-stride clear of per-row slot lists.
// Their bounds are the row kernels' bounds summed over the rows,
// plus, for B7a's global variants, 8 bytes per row and distinct global
// slot; latency, not bytes, keeps them above it, as for B1.
//
// B7b, B4d, B3a, B6c, B3b, B7c, B6b, B2 and B4c also take host lists by
// value (ct_sharded_clear_host, ct_seed_slots_host, ct_read_slots_host,
// ct_apply_remote_host, ct_clear_slots_host, ct_sharded_update_host,
// ct_update_replicated_host, ct_update_host, ct_credit_host, below): the
// storages' own lists ride in the kernel's parameter block, through a
// context bound once per table. B2's host form is B7c's body on a table
// of one row (update_list_kernel, no floor); B4c's is credit_kernel's
// body, one thread an entry (credit_list_kernel); past one parameter
// block both take the context's staging buffer, still one launch.
// B3a's host form and B5's and B7d's (ct_drain_top_hits_host, on a
// context of one row or of the sharded table's rows) answer into pinned
// host memory that the context owns. The storages stage their B3b clears
// and launch them as one such call before the table's next access.
//
// Every entry point launches on the stream it is given (or its context's)
// and returns cudaGetLastError() as an int; it allocates no device memory,
// except a context's own buffers (ct_ctx_results, the staging rows of
// ct_apply_remote_staged and of the update and credit host forms, the
// workspace of ct_drain_top_hits_host),
// which grow on demand and die with it.

#include <cooperative_groups.h>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <new>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemKeys = 16384;  // 128 KB of dynamic shared memory
constexpr int32_t kNever = 0x7fffffff;
constexpr int32_t kIntMin = (int32_t)0x80000000u;
constexpr int32_t kMaxValueCap = 1 << 30;
constexpr int32_t kMaxDeltaCap = (1 << 30) - 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
// Floor division for b >= 1 (C++ '/' truncates toward zero).
__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int32_t imax(int32_t a, int32_t b) {
  return a > b ? a : b;
}
__device__ __forceinline__ int32_t imin(int32_t a, int32_t b) {
  return a < b ? a : b;
}

__host__ __device__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The per-hit workspace: 64-bit sort keys first (used only when the
// batch exceeds the shared-memory key buffer), then int32 arrays of H,
// array k at a[k].
constexpr int kCheckArrays = 20;
constexpr int kUpdateArrays = 13;

size_t workspace_bytes(int H, int n_arrays) {
  return (size_t)next_pow2(H) * 8 + (size_t)n_arrays * (size_t)H * 4;
}

struct Work {
  uint64_t* keys;
  int32_t* ints;
  int H;
  __device__ Work(void* base, int H_, int P)
      : keys(reinterpret_cast<uint64_t*>(base)),
        ints(reinterpret_cast<int32_t*>(keys + P)), H(H_) {}
  __device__ __forceinline__ int32_t* operator[](int k) const {
    return ints + (size_t)k * H;
  }
};

// Block-wide scan of n values over contiguous per-thread chunks.
// kMax: running max (identity 0, inputs >= 0), else wrapping uint32 sum.
// Inclusive or exclusive; out may alias in. Ends with a barrier.
template <bool kMax>
__device__ void block_scan(const int32_t* in, int32_t* out, int n,
                           bool inclusive, uint32_t* sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ipt = (n + kThreads - 1) / kThreads;
  const int lo = min(n, tid * ipt), hi = min(n, lo + ipt);
  auto comb = [](uint32_t x, uint32_t y) -> uint32_t {
    return kMax ? (x > y ? x : y) : x + y;
  };
  uint32_t agg = 0;
  for (int i = lo; i < hi; ++i) agg = comb(agg, (uint32_t)in[i]);
  uint32_t x = agg;  // inclusive scan of chunk aggregates within the warp
  for (int o = 1; o < 32; o <<= 1) {
    uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = comb(x, y);
  }
  uint32_t ex = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) ex = 0;
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = sh[lane];
    for (int o = 1; o < 32; o <<= 1) {
      uint32_t y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = comb(w, y);
    }
    sh[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  uint32_t run = comb(warp > 0 ? sh[warp - 1] : 0u, ex);
  for (int i = lo; i < hi; ++i) {
    uint32_t v = (uint32_t)in[i];
    if (inclusive) {
      run = comb(run, v);
      out[i] = (int32_t)run;
    } else {
      out[i] = (int32_t)run;
      run = comb(run, v);
    }
  }
  __syncthreads();
}

// Stable sort of the batch by slot: bitonic sort of P (a power of two)
// unique keys slot << 32 | index, padded with ~0. Ends with a barrier.
__device__ void sort_by_slot(uint64_t* keys, const int32_t* slots, int H,
                             int P) {
  for (int i = threadIdx.x; i < P; i += kThreads) {
    keys[i] = i < H ? ((uint64_t)(uint32_t)slots[i] << 32) | (uint32_t)i
                    : ~0ull;
  }
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += kThreads) {
        int ixj = i ^ j;
        if (ixj > i) {
          uint64_t a = keys[i], b = keys[ixj];
          bool up = (i & k) == 0;
          if ((a > b) == up) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// After sort_by_slot: order, sorted slot, and each sorted hit's segment
// start (a max-scan of start marks). `mark` is scratch. Ends with a
// barrier.
__device__ void segments(const uint64_t* keys, int H, int32_t* order,
                         int32_t* s_slot, int32_t* mark, int32_t* seg_start,
                         uint32_t* sh) {
  for (int i = threadIdx.x; i < H; i += kThreads) {
    order[i] = (int32_t)(uint32_t)(keys[i] & 0xffffffffull);
    s_slot[i] = (int32_t)(uint32_t)(keys[i] >> 32);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < H; i += kThreads) {
    mark[i] = (i == 0 || s_slot[i] != s_slot[i - 1]) ? i : 0;
  }
  __syncthreads();
  block_scan<true>(mark, seg_start, H, true, sh);
}

__device__ __forceinline__ bool seg_is_end(const int32_t* s_slot, int i,
                                           int H) {
  return i == H - 1 || s_slot[i + 1] != s_slot[i];
}

// ---------------------------------------------------------------------------
// B1: the fused exact admission.

enum CheckArray {
  kOrder, kSlot, kMark, kStart, kDelta, kMaxv, kWin, kReq, kFlags, kVraw,
  kEraw, kVeff, kBase, kContrib, kPre, kOk, kAdmitted, kVote, kSegFlags,
  kSegWin
};
// The start marks are dead once the segment starts are scanned: the
// final pending sums reuse their array.
constexpr int kPending = kMark;
// kFlags bits per sorted hit: 1 fresh, 2 bucket, 4 h_fresh, 8 expired,
// 16 global (B7a). kSegFlags bits per segment start: 1 any fresh, 2 any
// admitted hit.

// The sharded table of B7 (limitador_tpu/parallel/mesh.py:399-612) is one
// int32[n, L+1] tensor per column; shard s is row s, column L its scratch.
// With kRows, block b runs on row b: its slice of the three columns, of
// the [n, H] hit and output columns, and of the workspace (ws_row bytes
// a row). B1, B2, B6a and B6b run one block on the whole table, and their
// template instances compile without any of it.
struct Rows {
  size_t ws_row;          // workspace bytes per row
  const int32_t* gvals;   // kGlobal: live partial sums, int32[G]
  int global_region;      // G
  int32_t* coupled;       // kCoupled: admitted[n*H], vote[n*H], flags[2]
};

// B7a's rows route is check_kernel<false, true, kGlobal, kCoupled>:
// - lean (kCoupled false): request ids are row-local (< H) and each block
//   runs its own fixpoint with __syncthreads_or, capped at H sweeps, as
//   each device's while_loop does under shard_map. No block waits on
//   another.
// - kGlobal: a hit flagged global (its slot < G, one slot on every row)
//   takes as its base the wrapping sum over rows of the live partials,
//   global_vals[min(slot, G - 1)], in place of its own cell's base (the
//   psum base_hook). global_sum_kernel computes the sums in a launch of
//   its own before this one, so that no row has written the table yet.
// - kCoupled: request ids are global (< n*H) and a request's verdict is
//   the AND of every row's vote (the pmin vote_combine). The admitted and
//   vote vectors live in device memory, shared by all blocks, and each
//   sweep has two grid-wide barriers: after the votes (every row has
//   voted before any verdict is read), and after the commit, where each
//   thread of the grid takes its share of request ids, compares vote with
//   admitted, copies the vote over and resets it to 1 for the next sweep,
//   and the grid ORs "changed" into flags[it & 1] (the other flag, read
//   in the previous sweep by every block before the first barrier, is
//   zeroed here). The cap is n*H sweeps, as the JAX loop's num_req. The
//   barriers are cooperative_groups' grid sync under a cooperative
//   launch, which needs every row's block resident (the launcher checks
//   n against the card's capacity before it launches). The cluster route
//   (check_cluster_kernel with kRows) takes every batch of n * H <=
//   16,384 hits instead, the card's largest cluster; this kernel keeps
//   the rest: more rows, or rows past 2,048 hits at n = 8.
template <bool kRemote, bool kRows = false, bool kGlobal = false,
          bool kCoupled = false>
__global__ void __launch_bounds__(kThreads, 1) check_kernel(
    int32_t* __restrict__ values, int32_t* __restrict__ expiry,
    int32_t* __restrict__ hits, const int32_t* __restrict__ remote_vals,
    const int32_t* __restrict__ remote_exp, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ deltas, const int32_t* __restrict__ maxes,
    const int32_t* __restrict__ windows, const int32_t* __restrict__ req_ids,
    const uint8_t* __restrict__ fresh, const uint8_t* __restrict__ bucket,
    int H, int scratch, int32_t now, void* workspace,
    uint8_t* __restrict__ out_admitted, uint8_t* __restrict__ out_ok,
    int32_t* __restrict__ out_remaining, int32_t* __restrict__ out_ttl,
    const uint8_t* __restrict__ is_global, Rows rows) {
  extern __shared__ uint64_t smem_keys[];
  __shared__ uint32_t sh[kWarps];
  if constexpr (kRows) {
    const size_t cell = (size_t)blockIdx.x * (scratch + 1);
    const size_t hit = (size_t)blockIdx.x * H;
    values += cell;
    expiry += cell;
    hits += cell;
    slots += hit;
    deltas += hit;
    maxes += hit;
    windows += hit;
    req_ids += hit;
    fresh += hit;
    bucket += hit;
    is_global += hit;
    out_ok += hit;
    out_remaining += hit;
    out_ttl += hit;
    if (!kCoupled) out_admitted += hit;
    workspace = static_cast<char*>(workspace) + blockIdx.x * rows.ws_row;
  }
  const int P = next_pow2(H);
  const Work a(workspace, H, P);
  uint64_t* keys = P <= kSmemKeys ? smem_keys : a.keys;
  const int tid = threadIdx.x;
  // Request-id space, verdicts and votes: the block's own (< H) unless
  // coupled, where they are the grid's (< n*H).
  const int num_req = kCoupled ? (int)gridDim.x * H : H;
  int32_t* adm = kCoupled ? rows.coupled : a[kAdmitted];
  int32_t* vote = kCoupled ? rows.coupled + num_req : a[kVote];
  int32_t* changed_flags = kCoupled ? rows.coupled + 2 * num_req : nullptr;
  const int gtid = blockIdx.x * kThreads + tid;
  const int gstride = gridDim.x * kThreads;

  sort_by_slot(keys, slots, H, P);
  segments(keys, H, a[kOrder], a[kSlot], a[kMark], a[kStart], sh);

  // Gather the hit columns in sorted order and the cells they read.
  for (int i = tid; i < H; i += kThreads) {
    const int h = a[kOrder][i];
    const int s = a[kSlot][i];
    a[kDelta][i] = deltas[h];
    a[kMaxv][i] = maxes[h];
    a[kWin][i] = windows[h];
    a[kReq][i] = req_ids[h];
    a[kFlags][i] = (fresh[h] ? 1 : 0) | (bucket[h] ? 2 : 0) |
                   (kGlobal && is_global[h] ? 16 : 0);
    a[kVraw][i] = values[s];
    a[kEraw][i] = expiry[s];
    a[kSegFlags][i] = 0;
    a[kSegWin][i] = kIntMin;
    if (!kCoupled) a[kAdmitted][i] = 1;
  }
  if constexpr (kCoupled) {
    for (int r = gtid; r < num_req; r += gstride) {
      adm[r] = 1;
      vote[r] = 1;
    }
    if (gtid == 0) changed_flags[0] = changed_flags[1] = 0;
    cooperative_groups::this_grid().sync();
  }
  __syncthreads();
  for (int i = tid; i < H; i += kThreads) {
    if (a[kFlags][i] & 1) atomicOr(&a[kSegFlags][a[kStart][i]], 1);
  }
  __syncthreads();

  // Effective base per hit: the window value, or the GCRA spent count.
  for (int i = tid; i < H; i += kThreads) {
    const bool h_fresh = a[kSegFlags][a[kStart][i]] & 1;
    const bool is_bucket = a[kFlags][i] & 2;
    const int32_t win = a[kWin][i], maxv = a[kMaxv][i];
    const int32_t v_raw = a[kVraw][i], e_raw = a[kEraw][i];
    const int32_t e_eff = h_fresh ? wadd(win, now) : e_raw;
    const bool expired = e_eff <= now;
    const int32_t v_window = (expired || h_fresh) ? 0 : v_raw;
    int32_t tat_eff = h_fresh ? 0 : e_raw;
    int32_t remote_add = 0;
    if (kRemote) {
      // B6a's hooks: bucket lanes floor their TAT at the remote TAT; window
      // lanes add the live remote sum (now < remote_exp, strict), fresh
      // slots included. The sum wraps as XLA's int32 does.
      const int s = a[kSlot][i];
      const int32_t r_exp = remote_exp[s];
      if (is_bucket) {
        tat_eff = imax(tat_eff, r_exp);
      } else if (now < r_exp) {
        remote_add = remote_vals[s];
      }
    }
    const int32_t base_rel = imax(wsub(tat_eff, now), 0);
    const int32_t ival = imax(win, 1);
    const int32_t tau = wmul(wsub(maxv, 1), is_bucket ? win : 0);
    const int32_t spent =
        wsub(maxv, wadd(floordiv(wsub(tau, base_rel), ival), 1));
    int32_t v_eff = is_bucket ? spent : wadd(v_window, remote_add);
    if (kGlobal && (a[kFlags][i] & 16)) {
      v_eff = rows.gvals[imin(a[kSlot][i], rows.global_region - 1)];
    }
    a[kVeff][i] = v_eff;
    a[kBase][i] = base_rel;
    a[kFlags][i] |= (h_fresh ? 4 : 0) | (expired ? 8 : 0);
  }
  __syncthreads();

  // The fixpoint: admitted[r] = AND over r's hits of
  // v_eff + (admitted earlier deltas on the slot) + delta <= max.
  int it = 0;
  bool changed;
  do {
    for (int i = tid; i < H; i += kThreads) {
      a[kContrib][i] = adm[a[kReq][i]] ? a[kDelta][i] : 0;
      if (!kCoupled) vote[i] = 1;
    }
    __syncthreads();
    block_scan<false>(a[kContrib], a[kPre], H, false, sh);
    for (int i = tid; i < H; i += kThreads) {
      const int32_t pending = wsub(a[kPre][i], a[kPre][a[kStart][i]]);
      const bool ok =
          wadd(wadd(a[kVeff][i], pending), a[kDelta][i]) <= a[kMaxv][i];
      a[kOk][i] = ok;
      if (!ok) vote[a[kReq][i]] = 0;
    }
    if constexpr (kCoupled) {
      cooperative_groups::grid_group grid = cooperative_groups::this_grid();
      grid.sync();
      int local = 0;
      for (int r = gtid; r < num_req; r += gstride) {
        if (vote[r] != adm[r]) local = 1;
        adm[r] = vote[r];
        vote[r] = 1;
      }
      if (gtid == 0) changed_flags[(it + 1) & 1] = 0;
      if (__syncthreads_or(local) && tid == 0) {
        atomicOr(&changed_flags[it & 1], 1);
      }
      grid.sync();
      changed = *reinterpret_cast<volatile int32_t*>(
                    &changed_flags[it & 1]) != 0;
    } else {
      __syncthreads();
      int local = 0;
      for (int r = tid; r < H; r += kThreads) {
        if (vote[r] != adm[r]) local = 1;
        adm[r] = vote[r];
      }
      changed = __syncthreads_or(local);
    }
    ++it;
  } while (changed && it < num_req);

  // Final pending sums under the final decisions.
  for (int i = tid; i < H; i += kThreads) {
    a[kContrib][i] = adm[a[kReq][i]] ? a[kDelta][i] : 0;
  }
  __syncthreads();
  block_scan<false>(a[kContrib], a[kPre], H, false, sh);

  // Per-hit outputs in input order; segment aggregates.
  for (int i = tid; i < H; i += kThreads) {
    const int h = a[kOrder][i];
    const int32_t flags = a[kFlags][i];
    const bool is_bucket = flags & 2, h_fresh = flags & 4,
               expired = flags & 8;
    const int32_t win = a[kWin][i], maxv = a[kMaxv][i];
    const int32_t pending = wsub(a[kPre][i], a[kPre][a[kStart][i]]);
    a[kPending][i] = pending;
    const int32_t used = wadd(wadd(a[kVeff][i], pending), a[kDelta][i]);
    out_ok[h] = (uint8_t)a[kOk][i];
    out_remaining[h] = imax(wsub(maxv, used), 0);
    const bool reset_before = expired && pending > 0;
    const int32_t ttl_window = (reset_before || h_fresh)
                                   ? win
                                   : imax(wsub(a[kEraw][i], now), 0);
    out_ttl[h] =
        is_bucket ? wadd(a[kBase][i], wmul(pending, win)) : ttl_window;
    const bool adm_hit = adm[a[kReq][i]];
    const int start = a[kStart][i];
    if (adm_hit) atomicOr(&a[kSegFlags][start], 2);
    atomicMax(&a[kSegWin][start], (adm_hit || (flags & 1)) ? win : 0);
  }
  if constexpr (kCoupled) {
    for (int r = gtid; r < num_req; r += gstride) {
      out_admitted[r] = (uint8_t)adm[r];
    }
  } else {
    for (int r = tid; r < H; r += kThreads) {
      out_admitted[r] = (uint8_t)adm[r];
    }
  }
  __syncthreads();

  // One write per segment, at its last hit. Each slot has exactly one
  // segment, so no two threads write one cell.
  for (int i = tid; i < H; i += kThreads) {
    if (!seg_is_end(a[kSlot], i, H)) continue;
    const int s = a[kSlot][i];
    if (s == scratch) continue;  // re-zeroed below
    const int start = a[kStart][i];
    const int32_t flags = a[kFlags][i];
    const bool is_bucket = flags & 2, h_fresh = flags & 4;
    const int32_t seg_flags = a[kSegFlags][start];
    const bool h_adm = seg_flags & 2;
    const int32_t win = a[kWin][i];
    const int32_t v_raw = a[kVraw][i], e_raw = a[kEraw][i];
    const int32_t h_total = wadd(a[kPending][i], a[kContrib][i]);
    const bool starts_fresh = e_raw <= now || h_fresh;
    if (h_adm || h_fresh) {
      values[s] = is_bucket ? 0 : wadd(starts_fresh ? 0 : v_raw, h_total);
    }
    const bool reset = is_bucket ? (h_adm || h_fresh)
                                 : ((h_adm && starts_fresh) || h_fresh);
    if (reset) {
      int32_t tat_eff = h_fresh ? 0 : e_raw;
      // B6a: the write base is the floored TAT, so the local cell
      // persists the join of local and remote state.
      if (kRemote && is_bucket) tat_eff = imax(tat_eff, remote_exp[s]);
      const int32_t tat_base = imax(tat_eff, now);
      expiry[s] = is_bucket ? wadd(tat_base, wmul(h_total, win))
                            : wadd(a[kSegWin][start], now);
    }
    const int32_t base_hits = h_fresh ? 0 : hits[s];
    hits[s] = wadd(base_hits, i - start + 1);
  }
  __syncthreads();
  if (tid == 0) {
    values[scratch] = 0;
    expiry[scratch] = 0;
    hits[scratch] = 0;
  }
}

// ---------------------------------------------------------------------------
// B1, B6a and B7a on thread-block clusters: check_cluster_kernel.
//
// The same function as check_kernel<kRemote> (B1, B6a), bit for bit,
// spread over one cluster of k = ceil(H / 1024) blocks (up to 16, the
// H100's non-portable cluster size, so H <= 16,384) on k SMs. With kRows
// it is B7a over the flattened [n, H] columns of the sharded table (the
// sort key is the cell, row * (L + 1) + slot; lean ids become row * H +
// id): one cluster of n * H hits for a coupled or global batch, or n
// clusters of H, one a row, for a lean one. Each thread owns one sorted
// position and one request id: block b owns positions and request ids
// [b * per, b * per + per), per = ceil(H / k). Everything another thread
// reads lives in shared memory; another block's arrays are reached
// through distributed shared memory (cluster.map_shared_rank), and
// cluster.sync() separates the phases. No device workspace.
//   1. Stable sort by slot: an LSD radix sort of (slot, index) keys over
//      the key's bits (bit length of the largest key, in passes of at
//      most 8 bits: 3 of 7 at C = 1 << 20, and at 8 rows of 1 << 17 + 1
//      cells). Within a block a key's rank
//      among equal digits comes from __match_any_sync per warp and the
//      warps' digit counts; across blocks from every block's digit counts
//      read through DSMEM. Each key is stored into the block that owns
//      its destination. Starting in index order, each pass stable, the
//      result is the (slot, index) order of the one-block kernel's
//      bitonic sort.
//   2. Segment starts: a block max-scan of start marks, then the maximum
//      of the earlier blocks' aggregates. Segment flags and window maxima
//      are atomics (skipped when they would change nothing) on the
//      segment start's owner, in DSMEM.
//   3. The fixpoint: each sweep scans the admitted deltas (a block scan,
//      then the earlier blocks' totals), votes are DSMEM stores to the
//      request's owner, "changed" is the OR of the blocks' flags. The
//      admitted vector is double-buffered (decisions and votes swap each
//      sweep), so a sweep needs two cluster barriers: after the scan
//      totals (which also publish the previous sweep's flags) and after
//      the votes. The sweep that finds nothing changed is the final
//      scan. The cap is H sweeps, as the JAX while_loop's (B7a: n * H
//      when coupled; H for lean rows, where a converged row's verdicts
//      no longer change while other rows sweep on, so each row ends as
//      its own loop would).
//   4. Outputs as check_kernel's; each segment's last hit writes its
//      cell (never a scratch cell); block 0 re-zeroes the scratch cells
//      after the last barrier.
// B6a's hooks read the remote lanes at the gather and floor the bucket
// TAT at the base and at the write. B7a's global hits read the n live
// partials of their slot at the gather, before the first barrier, so
// before any block writes: no pre-pass launch.
// Bound: the bytes of check_kernel; the barriers, about 2 per radix pass
// and per sweep, are the cost.

namespace cg = cooperative_groups;

constexpr int kClusterMaxBlocks = 16;
constexpr int kClusterMaxHits = kClusterMaxBlocks * kThreads;

struct ClusterPlan {
  int blocks;   // k: one cluster (the whole grid, but for B7a's lean rows)
  int per;      // positions and request ids a block owns
  int threads;  // per, rounded up to whole warps
  int passes;   // radix passes over the sort key's bits
  int width;    // bits a pass
  int cap;      // most sweeps of the fixpoint
};

// A cluster over H hits whose sort keys lie in [0, max_key].
ClusterPlan cluster_plan(int H, int max_key, int cap) {
  ClusterPlan p;
  p.blocks = (H + kThreads - 1) / kThreads;
  p.per = (H + p.blocks - 1) / p.blocks;
  p.threads = (p.per + 31) / 32 * 32;
  int bits = 1;
  while (bits < 32 && ((uint32_t)max_key >> bits) != 0) ++bits;
  p.passes = (bits + 7) / 8;
  p.width = (bits + p.passes - 1) / p.passes;
  p.cap = cap;
  return p;
}

// What B6a and B7a add to B1's cluster kernel; B1's instance reads none
// of it.
struct ClusterHooks {
  // kRemote (B6a): the remote lanes, int32[C+1] each, only read.
  const int32_t* remote_vals;
  const int32_t* remote_exp;
  // kRows (B7a): the [n, H] hit columns over the int32[n, L+1] table; a
  // hit of row r is the cell r * row_len + slot, each row's scratch its
  // cell L.
  const uint8_t* is_global;  // the global flags; null: no global hit
  int rows;                  // n
  int row_hits;              // H
  int row_len;               // L + 1
  int global_region;         // G <= L + 1
  int lean;                  // request ids are row-local (< H)
};

// Dynamic shared memory of one block: keys[per] (uint64), five int32
// arrays of per (scan prefixes, segment flags, segment window maxima, two
// admitted buffers), the warps' digit counts [warps][bins] and three
// arrays of bins (the block's digit counts, their exclusive scan, the
// digits' destinations).
size_t cluster_smem(const ClusterPlan& p) {
  const int bins = 1 << p.width;
  return (size_t)p.per * (8 + 5 * 4) +
         (size_t)(p.threads / 32 * bins + 3 * bins) * 4;
}

const size_t kClusterSmemMax =
    cluster_smem(ClusterPlan{kClusterMaxBlocks, kThreads, kThreads, 4, 8, 0});

// Inclusive scan of one value a thread over the block (kMax: running max
// of values >= 0, else wrapping uint32 sum); *total gets the block's
// aggregate. Ends with a barrier, so `wsum` may be reused at once.
template <bool kMax>
__device__ uint32_t block_scan1(uint32_t v, uint32_t* wsum, uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  auto comb = [](uint32_t x, uint32_t y) -> uint32_t {
    return kMax ? (x > y ? x : y) : x + y;
  };
  uint32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = comb(x, y);
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < nw ? wsum[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = comb(w, y);
    }
    wsum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const uint32_t out = warp > 0 ? comb(wsum[warp - 1], x) : x;
  *total = wsum[nw - 1];
  __syncthreads();
  return out;
}

// Exclusive wrapping sum-scan of n int32 in shared memory, in place, over
// contiguous per-thread chunks. Ends with a barrier.
__device__ void smem_exscan(int32_t* a, int n, uint32_t* wsum) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ipt = (n + nt - 1) / nt;
  const int lo = min(n, tid * ipt), hi = min(n, lo + ipt);
  uint32_t agg = 0;
  for (int i = lo; i < hi; ++i) agg += (uint32_t)a[i];
  uint32_t total;
  uint32_t run = block_scan1<false>(agg, wsum, &total) - agg;
  for (int i = lo; i < hi; ++i) {
    const uint32_t v = (uint32_t)a[i];
    a[i] = (int32_t)run;
    run += v;
  }
  __syncthreads();
}

// H is the hits of one cluster. kRows with several clusters (B7a's lean
// rows without a global region) gives cluster c the hits [c * H, c * H +
// H) of the flattened columns: one row each, no cluster reading another's
// cells.
template <bool kRemote, bool kRows>
__global__ void __launch_bounds__(kThreads, 1) check_cluster_kernel(
    int32_t* __restrict__ values, int32_t* __restrict__ expiry,
    int32_t* __restrict__ hits, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ deltas, const int32_t* __restrict__ maxes,
    const int32_t* __restrict__ windows, const int32_t* __restrict__ req_ids,
    const uint8_t* __restrict__ fresh, const uint8_t* __restrict__ bucket,
    int H, int scratch, int32_t now, ClusterPlan plan,
    uint8_t* __restrict__ out_admitted, uint8_t* __restrict__ out_ok,
    int32_t* __restrict__ out_remaining, int32_t* __restrict__ out_ttl,
    ClusterHooks hk) {
  extern __shared__ uint64_t cl_smem[];
  __shared__ uint32_t wsum[32];
  __shared__ uint32_t off[kClusterMaxBlocks];  // earlier blocks' totals
  // Read by other blocks: sh_agg (the segment-start aggregate), sh_total
  // (a sweep's contribution total), sh_flag (a sweep's "changed").
  __shared__ int32_t sh_agg, sh_total, sh_flag[2], sh_carry, sh_any;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int b = (int)cluster.block_rank();
  const int per = plan.per, bins = 1 << plan.width;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int lo = b * per;
  const int mine = min(per, H - lo);  // every block owns at least one
  const bool live = tid < mine;
  uint64_t* keys = cl_smem;
  int32_t* pre = reinterpret_cast<int32_t*>(keys + per);
  int32_t* segf = pre + per;  // bits: 1 any fresh, 2 any admitted hit
  int32_t* segw = segf + per;
  int32_t* adm = segw + per;  // two buffers of per
  int32_t* hist = adm + 2 * per;
  int32_t* cnt = hist + nw * bins;
  int32_t* tsum = cnt + bins;
  int32_t* dbase = tsum + bins;
  auto at = [&](auto* p, int rank) { return cluster.map_shared_rank(p, rank); };
  int base = 0;  // the cluster's first hit in the flattened columns
  if constexpr (kRows) {
    base = (int)(blockIdx.x / k) * H;
    slots += base;
    deltas += base;
    maxes += base;
    windows += base;
    req_ids += base;
    fresh += base;
    bucket += base;
    if (hk.is_global != nullptr) hk.is_global += base;
    out_admitted += base;
    out_ok += base;
    out_remaining += base;
    out_ttl += base;
  }

  // 1. The radix sort, of (cell, index) keys: the slot, or under kRows the
  // hit's row * row_len + slot.
  uint32_t slot = 0;
  int idx = 0;
  if (live) {
    slot = (uint32_t)slots[lo + tid];
    if constexpr (kRows) {
      slot += (uint32_t)((base + lo + tid) / hk.row_hits * hk.row_len);
    }
    idx = lo + tid;
  }
  const unsigned below = (1u << lane) - 1u;
  for (int pass = 0; pass < plan.passes; ++pass) {
    for (int j = tid; j < nw * bins; j += blockDim.x) hist[j] = 0;
    __syncthreads();
    const uint32_t d =
        live ? (slot >> (pass * plan.width)) & (uint32_t)(bins - 1)
             : (uint32_t)bins;
    const unsigned peers = __match_any_sync(kFull, d);
    const int rank = __popc(peers & below);
    if (live && rank == 0) hist[warp * bins + d] = __popc(peers);
    __syncthreads();
    for (int dd = tid; dd < bins; dd += blockDim.x) {
      int run = 0;
      for (int w = 0; w < nw; ++w) {
        const int c = hist[w * bins + dd];
        hist[w * bins + dd] = run;
        run += c;
      }
      cnt[dd] = run;
    }
    cluster.sync();  // every block's digit counts out, every key read
    for (int dd = tid; dd < bins; dd += blockDim.x) {
      int before = 0, total = 0;
      for (int r = 0; r < k; ++r) {
        const int c = *at(cnt + dd, r);
        total += c;
        if (r < b) before += c;
      }
      tsum[dd] = total;
      dbase[dd] = before;
    }
    __syncthreads();
    smem_exscan(tsum, bins, wsum);
    for (int dd = tid; dd < bins; dd += blockDim.x) dbase[dd] += tsum[dd];
    __syncthreads();
    if (live) {
      const int dest = dbase[d] + hist[warp * bins + d] + rank;
      const int owner = dest / per;
      *at(keys + (dest - owner * per), owner) =
          ((uint64_t)slot << 32) | (uint32_t)idx;
    }
    cluster.sync();  // every key stored
    if (live) {
      const uint64_t key = keys[tid];
      slot = (uint32_t)(key >> 32);
      idx = (int)(uint32_t)key;
    }
  }

  // 2. Segments, and the hit columns gathered in sorted order.
  const int i = lo + tid;
  const int32_t s = (int32_t)slot;
  const int h = idx;
  int mark = 0;
  bool is_end = false;
  if (live) {
    const uint32_t prev =
        tid > 0  ? (uint32_t)(keys[tid - 1] >> 32)
        : b > 0  ? (uint32_t)(*at(keys + per - 1, b - 1) >> 32)
                 : 0u;
    mark = (i == 0 || slot != prev) ? i : 0;
    if (i == H - 1) {
      is_end = true;
    } else {
      const uint64_t next = tid + 1 < mine ? keys[tid + 1] : *at(keys, b + 1);
      is_end = (uint32_t)(next >> 32) != slot;
    }
  }
  uint32_t agg;
  const int local_start = (int)block_scan1<true>((uint32_t)mark, wsum, &agg);
  if (tid == 0) sh_agg = (int32_t)agg;
  int32_t delta = 0, maxv = 0, win = 0, req = 0, v_raw = 0, e_raw = 0;
  int flags = 0;  // 1 fresh, 2 bucket, 4 h_fresh, 8 expired, 16 global
  bool is_scratch = false;
  // B6a: the remote TAT (bucket) and the live remote sum (window); B7a:
  // a global hit's base.
  int32_t r_exp = 0, r_add = 0, g_base = 0;
  if (live) {
    delta = deltas[h];
    maxv = maxes[h];
    win = windows[h];
    req = req_ids[h];
    flags = (fresh[h] ? 1 : 0) | (bucket[h] ? 2 : 0);
    v_raw = values[s];
    e_raw = expiry[s];
    if constexpr (kRows) {
      const int row = s / hk.row_len;
      const int local = s - row * hk.row_len;
      is_scratch = local == hk.row_len - 1;
      if (hk.lean) req += row * hk.row_hits - base;
      if (hk.is_global != nullptr && hk.is_global[h]) {
        // The psum base_hook: the wrapping sum over the rows of the live
        // partials at the slot, read before any block writes the table
        // (the writes follow the last sweep's barriers). Both cells are
        // loaded unconditionally, so the rows' loads are in flight
        // together.
        flags |= 16;
        const int g = imin(local, hk.global_region - 1);
        uint32_t sum = 0;
#pragma unroll 8
        for (int r = 0; r < hk.rows; ++r) {
          const size_t cell = (size_t)r * hk.row_len + g;
          const int32_t e = expiry[cell], v = values[cell];
          sum += now < e ? (uint32_t)v : 0u;
        }
        g_base = (int32_t)sum;
      }
    } else {
      is_scratch = s == scratch;
    }
    if constexpr (kRemote) {
      // B6a's hooks: bucket lanes floor their TAT at the remote TAT;
      // window lanes add the live remote sum (now < remote_exp, strict),
      // fresh slots included.
      r_exp = hk.remote_exp[s];
      if (!(flags & 2) && now < r_exp) r_add = hk.remote_vals[s];
    }
    segf[tid] = 0;
    segw[tid] = kIntMin;
    adm[tid] = 1;
    adm[per + tid] = 1;
  }
  cluster.sync();  // aggregates out, accumulators and verdicts set
  if (warp == 0) {
    uint32_t c = lane < b ? (uint32_t)*at(&sh_agg, lane) : 0u;
    for (int o = 16; o > 0; o >>= 1) {
      const uint32_t y = __shfl_xor_sync(kFull, c, o);
      c = c > y ? c : y;
    }
    if (lane == 0) sh_carry = (int32_t)c;
  }
  __syncthreads();
  const int start = imax(local_start, sh_carry);
  const int st_b = start / per, st_l = start - st_b * per;
  int32_t* st_segf = at(segf + st_l, st_b);
  int32_t* st_segw = at(segw + st_l, st_b);
  const int32_t* st_pre = at(pre + st_l, st_b);
  const int rq_b = req / per;
  int32_t* rq_adm = at(adm + (req - rq_b * per), rq_b);  // + per: buffer 1
  if (live && (flags & 1) && !(*st_segf & 1)) atomicOr(st_segf, 1);

  // 3. The fixpoint; sweep 0's first barrier also publishes the fresh
  // flags, so the effective bases are formed after it.
  int32_t v_eff = 0, base_rel = 0, ok = 0, contrib = 0;
  uint32_t pre_local = 0;
  int sweep = 0;
  for (;; ++sweep) {
    const int cur = sweep & 1;
    contrib = (live && rq_adm[cur * per]) ? delta : 0;
    uint32_t tot;
    pre_local = block_scan1<false>((uint32_t)contrib, wsum, &tot) -
                (uint32_t)contrib;
    if (live) pre[tid] = (int32_t)pre_local;
    if (tid == 0) sh_total = (int32_t)tot;
    cluster.sync();  // totals out; the previous sweep's flags out
    if (warp == 0) {
      const uint32_t t = lane < k ? (uint32_t)*at(&sh_total, lane) : 0u;
      uint32_t x = t;
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      if (lane < k) off[lane] = x - t;
      const int f = (sweep > 0 && lane < k) ? *at(&sh_flag[cur ^ 1], lane)
                                            : 0;
      const bool any = __any_sync(kFull, f != 0);
      if (lane == 0) sh_any = any;
    }
    __syncthreads();
    if (sweep > 0 && (!sh_any || sweep >= plan.cap)) break;
    if (sweep == 0 && live) {
      // The effective base per hit: the window value, or the GCRA spent
      // count.
      const bool h_fresh = *st_segf & 1;
      const bool is_bucket = flags & 2;
      const int32_t e_eff = h_fresh ? wadd(win, now) : e_raw;
      const bool expired = e_eff <= now;
      const int32_t v_window = (expired || h_fresh) ? 0 : v_raw;
      int32_t tat_eff = h_fresh ? 0 : e_raw;
      if (kRemote && is_bucket) tat_eff = imax(tat_eff, r_exp);
      base_rel = imax(wsub(tat_eff, now), 0);
      const int32_t ival = imax(win, 1);
      const int32_t tau = wmul(wsub(maxv, 1), is_bucket ? win : 0);
      const int32_t spent =
          wsub(maxv, wadd(floordiv(wsub(tau, base_rel), ival), 1));
      v_eff = is_bucket ? spent : (kRemote ? wadd(v_window, r_add) : v_window);
      if (kRows && (flags & 16)) v_eff = g_base;
      flags |= (h_fresh ? 4 : 0) | (expired ? 8 : 0);
    }
    if (live) {
      const int32_t pending = wsub((int32_t)(off[b] + pre_local),
                                   (int32_t)(off[st_b] + (uint32_t)*st_pre));
      ok = wadd(wadd(v_eff, pending), delta) <= maxv;
      if (!ok) rq_adm[(cur ^ 1) * per] = 0;
    }
    cluster.sync();  // every vote stored
    int changed = 0;
    if (live) {
      changed = adm[(cur ^ 1) * per + tid] != adm[cur * per + tid];
      adm[cur * per + tid] = 1;  // the next sweep's vote buffer
    }
    changed = __syncthreads_or(changed);
    if (tid == 0) sh_flag[cur] = changed;
  }

  // 4. Outputs under the final decisions (buffer `fin`), whose scan the
  // last pass of the loop made.
  const int fin = sweep & 1;
  if (live) {
    const bool is_bucket = flags & 2, h_fresh = flags & 4,
               expired = flags & 8;
    const int32_t pending = wsub((int32_t)(off[b] + pre_local),
                                 (int32_t)(off[st_b] + (uint32_t)*st_pre));
    pre_local = (uint32_t)pending;  // kept for the segment's write
    const int32_t used = wadd(wadd(v_eff, pending), delta);
    out_admitted[i] = (uint8_t)adm[fin * per + tid];
    out_ok[h] = (uint8_t)ok;
    out_remaining[h] = imax(wsub(maxv, used), 0);
    const bool reset_before = expired && pending > 0;
    const int32_t ttl_window = (reset_before || h_fresh)
                                   ? win
                                   : imax(wsub(e_raw, now), 0);
    out_ttl[h] =
        is_bucket ? wadd(base_rel, wmul(pending, win)) : ttl_window;
    const bool adm_hit = rq_adm[fin * per] != 0;
    if (adm_hit && !(*st_segf & 2)) atomicOr(st_segf, 2);
    const int32_t w = (adm_hit || (flags & 1)) ? win : 0;
    if (w > *st_segw) atomicMax(st_segw, w);
  }
  cluster.sync();  // segment aggregates complete
  if (live && is_end && !is_scratch) {
    const bool is_bucket = flags & 2, h_fresh = flags & 4;
    const int32_t seg_flags = *st_segf;
    const bool h_adm = seg_flags & 2;
    const int32_t h_total = wadd((int32_t)pre_local, contrib);
    const bool starts_fresh = e_raw <= now || h_fresh;
    if (h_adm || h_fresh) {
      values[s] = is_bucket ? 0 : wadd(starts_fresh ? 0 : v_raw, h_total);
    }
    const bool reset = is_bucket ? (h_adm || h_fresh)
                                 : ((h_adm && starts_fresh) || h_fresh);
    if (reset) {
      int32_t tat_eff = h_fresh ? 0 : e_raw;
      // B6a: the write base is the floored TAT, so the local cell
      // persists the join of local and remote state.
      if (kRemote && is_bucket) tat_eff = imax(tat_eff, r_exp);
      const int32_t tat_base = imax(tat_eff, now);
      expiry[s] = is_bucket ? wadd(tat_base, wmul(h_total, win))
                            : wadd(*st_segw, now);
    }
    const int32_t base_hits = h_fresh ? 0 : hits[s];
    hits[s] = wadd(base_hits, i - start + 1);
  }
  cluster.sync();  // no block leaves while another reads its memory
  if constexpr (kRows) {
    // Every row the cluster covers re-zeroes its scratch cell.
    if (b == 0) {
      const int last = (base + H - 1) / hk.row_hits;
      for (int r = base / hk.row_hits + tid; r <= last; r += blockDim.x) {
        const size_t cell = (size_t)r * hk.row_len + hk.row_len - 1;
        values[cell] = 0;
        expiry[cell] = 0;
        hits[cell] = 0;
      }
    }
  } else if (b == 0 && tid == 0) {
    values[scratch] = 0;
    expiry[scratch] = 0;
    hits[scratch] = 0;
  }
}

// ---------------------------------------------------------------------------
// B2: unconditional increments.

enum UpdateArray {
  uOrder, uSlot, uMark, uStart, uDelta, uWin, uFlags, uL0, uL1, uL2, uL3,
  uSegFresh, uSegWin
};

// B7c (sharded_update, parallel/mesh.py:552-586) is
// update_kernel<false, true>: block b runs B2 on row b of the sharded
// table (the Rows layout of B7a), with no coupling between rows.
template <bool kRemote, bool kRows = false>
__global__ void __launch_bounds__(kThreads, 1) update_kernel(
    int32_t* __restrict__ values, int32_t* __restrict__ expiry,
    int32_t* __restrict__ hits, const int32_t* __restrict__ remote_exp,
    const int32_t* __restrict__ slots,
    const int32_t* __restrict__ deltas, const int32_t* __restrict__ windows,
    const uint8_t* __restrict__ fresh, const uint8_t* __restrict__ bucket,
    int H, int scratch, int32_t now, void* workspace, size_t ws_row) {
  extern __shared__ uint64_t smem_keys[];
  __shared__ uint32_t sh[kWarps];
  if constexpr (kRows) {
    const size_t cell = (size_t)blockIdx.x * (scratch + 1);
    const size_t hit = (size_t)blockIdx.x * H;
    values += cell;
    expiry += cell;
    hits += cell;
    slots += hit;
    deltas += hit;
    windows += hit;
    fresh += hit;
    bucket += hit;
    workspace = static_cast<char*>(workspace) + blockIdx.x * ws_row;
  }
  const int P = next_pow2(H);
  const Work a(workspace, H, P);
  uint64_t* keys = P <= kSmemKeys ? smem_keys : a.keys;
  const int tid = threadIdx.x;

  sort_by_slot(keys, slots, H, P);
  segments(keys, H, a[uOrder], a[uSlot], a[uMark], a[uStart], sh);

  for (int i = tid; i < H; i += kThreads) {
    const int h = a[uOrder][i];
    a[uDelta][i] = imin(imax(deltas[h], 0), kMaxDeltaCap);
    a[uWin][i] = windows[h];
    a[uFlags][i] = (fresh[h] ? 1 : 0) | (bucket[h] ? 2 : 0);
    a[uL0][i] = a[uL1][i] = a[uL2][i] = a[uL3][i] = 0;
    a[uSegFresh][i] = 0;
    a[uSegWin][i] = kIntMin;
  }
  __syncthreads();
  // Exact per-segment sums in four 8-bit lanes.
  for (int i = tid; i < H; i += kThreads) {
    const int start = a[uStart][i];
    const uint32_t d = (uint32_t)a[uDelta][i];
    atomicAdd(reinterpret_cast<unsigned*>(&a[uL0][start]), d & 0xffu);
    atomicAdd(reinterpret_cast<unsigned*>(&a[uL1][start]), (d >> 8) & 0xffu);
    atomicAdd(reinterpret_cast<unsigned*>(&a[uL2][start]), (d >> 16) & 0xffu);
    atomicAdd(reinterpret_cast<unsigned*>(&a[uL3][start]), d >> 24);
    if (a[uFlags][i] & 1) atomicOr(&a[uSegFresh][start], 1);
    atomicMax(&a[uSegWin][start], a[uWin][i]);
  }
  __syncthreads();

  for (int i = tid; i < H; i += kThreads) {
    if (!seg_is_end(a[uSlot], i, H)) continue;
    const int s = a[uSlot][i];
    if (s == scratch) continue;  // re-zeroed below
    const int start = a[uStart][i];
    const int32_t l0 = a[uL0][start], l1 = a[uL1][start],
                  l2 = a[uL2][start], l3 = a[uL3][start];
    const int32_t t1 = wadd(l1, l0 >> 8);
    const int32_t t2 = wadd(l2, t1 >> 8);
    const int32_t t3 = wadd(l3, t2 >> 8);
    const int32_t exact =
        (int32_t)((uint32_t)(l0 & 0xff) + ((uint32_t)(t1 & 0xff) << 8) +
                  ((uint32_t)(t2 & 0xff) << 16) + ((uint32_t)t3 << 24));
    const int32_t seg_add =
        t3 >= 64 ? kMaxValueCap : imin(exact, kMaxValueCap);
    const bool h_fresh = a[uSegFresh][start] & 1;
    const bool is_bucket = a[uFlags][i] & 2;
    const int32_t win = a[uWin][i];
    const int32_t v_raw = values[s], e_raw = expiry[s];
    const bool cell_expired = e_raw <= now || h_fresh;
    const int32_t base_c = imin(cell_expired ? 0 : v_raw, kMaxValueCap);
    const int32_t headroom = wsub(kMaxValueCap, base_c);
    values[s] = is_bucket ? 0 : wadd(base_c, imin(seg_add, headroom));
    if (cell_expired || is_bucket) {
      const int32_t ival = imax(win, 1);
      int32_t local_tat = h_fresh ? 0 : e_raw;
      // B6b: the remote TAT floors a bucket's start before the advance.
      if (kRemote && is_bucket) local_tat = imax(local_tat, remote_exp[s]);
      const int32_t tat_base = imax(local_tat, now);
      const int32_t max_adv = floordiv(wsub(kNever, tat_base), ival);
      const int32_t adv = imin(seg_add, max_adv);
      expiry[s] = is_bucket ? wadd(tat_base, wmul(adv, win))
                            : wadd(now, a[uSegWin][start]);
    }
    const int32_t base_hits = h_fresh ? 0 : hits[s];
    hits[s] = wadd(base_hits, i - start + 1);
  }
  __syncthreads();
  if (tid == 0) {
    values[scratch] = 0;
    expiry[scratch] = 0;
    hits[scratch] = 0;
  }
}

// ---------------------------------------------------------------------------
// B3a, B3b, B4a, B4b, B4d: grid-stride loops.

__global__ void read_slots_kernel(const int32_t* __restrict__ values,
                                  const int32_t* __restrict__ expiry,
                                  const int32_t* __restrict__ slots, int n,
                                  int32_t now, int32_t* __restrict__ out_v,
                                  int32_t* __restrict__ out_ttl) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int s = slots[i];
    const int32_t v = values[s], e = expiry[s];
    out_v[i] = e > now ? v : 0;
    out_ttl[i] = imax(wsub(e, now), 0);
  }
}

__global__ void clear_slots_kernel(int32_t* __restrict__ values,
                                   int32_t* __restrict__ expiry,
                                   int32_t* __restrict__ hits,
                                   const int32_t* __restrict__ slots, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int s = slots[i];
    values[s] = 0;
    expiry[s] = 0;
    hits[s] = 0;
  }
}

// B7b: zero value, expiry and hits at per-row slot lists
// (sharded_clear_cells, parallel/mesh.py:507-549): entry i of the
// int32[n, K] list is row i / K's slot. A grid-stride loop over n*K
// entries, as B3b's over its slots; padding entries point at column L,
// which stays 0. Duplicates write the same zeros. Bound: bytes, 4 B of
// list read per entry and 12 B written per distinct cell.
__global__ void sharded_clear_kernel(int32_t* __restrict__ values,
                                     int32_t* __restrict__ expiry,
                                     int32_t* __restrict__ hits,
                                     const int32_t* __restrict__ slots,
                                     int n_entries, int K, int row_len) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_entries;
       i += gridDim.x * blockDim.x) {
    const size_t cell = (size_t)(i / K) * row_len + slots[i];
    values[cell] = 0;
    expiry[cell] = 0;
    hits[cell] = 0;
  }
}

// B7a's pre-pass: for each global slot g < G, the wrapping int32 sum over
// the n rows of the live partials (now < expiry), as XLA's psum of
// int32 wraps. Runs before the check launch, so it reads the table as
// the batch found it. Bound: bytes, 8 B read per row and slot plus 4 B
// written per slot.
__global__ void global_sum_kernel(const int32_t* __restrict__ values,
                                  const int32_t* __restrict__ expiry,
                                  int n, int row_len, int G, int32_t now,
                                  int32_t* __restrict__ out) {
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < G;
       g += gridDim.x * blockDim.x) {
    uint32_t sum = 0;
    for (int r = 0; r < n; ++r) {
      const size_t cell = (size_t)r * row_len + g;
      if (now < expiry[cell]) sum += (uint32_t)values[cell];
    }
    out[g] = (int32_t)sum;
  }
}

// One expiry moved back by `shift`, clamped at 0 (B4a and B4b).
__device__ __forceinline__ int32_t rebased(int32_t e, int32_t shift) {
  return imax(wsub(e, shift), 0);
}

__global__ void rebase_expiry_kernel(int32_t* __restrict__ expiry, int n,
                                     int32_t step) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    expiry[i] = rebased(expiry[i], step);
  }
}

// B4b: the epoch rebase by a device scalar (rebase_epoch,
// ops/kernel.py:699-707). The same grid-stride loop as B4a, but the
// shift is read from device memory, as the JAX program takes a device
// array, so the launch needs no host sync. Each thread reads the scalar
// once. Bound: bytes, the column read and written once: 8 (C + 1) bytes,
// 2.5 us at C = 1 << 20.
__global__ void rebase_epoch_kernel(int32_t* __restrict__ expiry, int n,
                                    const int32_t* __restrict__ shift_ms) {
  const int32_t shift = *shift_ms;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    expiry[i] = rebased(expiry[i], shift);
  }
}

// B4d: the tier promotion seed (seed_slots, ops/kernel.py:625-648).
// One thread per row writes value and expiry verbatim and zeroes hits.
// Real slots are unique by the callers' construction (a promotion seeds
// one slot per promoted key; the slot was just allocated), so no two
// rows write one cell and the order of writes does not matter. Padding
// rows (slot C) write nothing. The JAX program's end state of the
// scratch row: its value and expiry reset to 0 always, its hits zeroed
// only when some row is padding (the hits scatter lands there). Global
// thread 0 resets value and expiry; each block ORs "a row of mine is
// padding" and its thread 0 then zeroes the scratch hits; no row write
// races either (real rows never touch row C). Bound: bytes, 12 bytes of
// row read and 12 written per real row: 24 bytes. At n = 1, the
// promotion path's size, it is launch-bound.
__global__ void seed_slots_kernel(int32_t* __restrict__ values,
                                  int32_t* __restrict__ expiry,
                                  int32_t* __restrict__ hits,
                                  const int32_t* __restrict__ slots,
                                  const int32_t* __restrict__ seed_v,
                                  const int32_t* __restrict__ seed_e, int H,
                                  int scratch) {
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (first == 0) {
    values[scratch] = 0;
    expiry[scratch] = 0;
  }
  int padding = 0;
  for (int i = first; i < H; i += gridDim.x * blockDim.x) {
    const int s = slots[i];
    if (s == scratch) {
      padding = 1;
      continue;
    }
    values[s] = seed_v[i];
    expiry[s] = seed_e[i];
    hits[s] = 0;
  }
  if (__syncthreads_or(padding) && threadIdx.x == 0) hits[scratch] = 0;
}

// B6c: the remote-sum scatter (_apply_remote, tpu/replicated.py:120-125).
// One thread per row writes both lanes. The slots are the keys of the
// replicated storage's dirty map, unique by construction, so no two rows
// write one cell and the order of writes does not matter. Bound: bytes,
// 12 bytes of row read and 8 written per row.
__global__ void apply_remote_kernel(int32_t* __restrict__ remote_vals,
                                    int32_t* __restrict__ remote_exp,
                                    const int32_t* __restrict__ slots,
                                    const int32_t* __restrict__ sums,
                                    const int32_t* __restrict__ expiries,
                                    int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int s = slots[i];
    remote_vals[s] = sums[i];
    remote_exp[s] = expiries[i];
  }
}

// ---------------------------------------------------------------------------
// B4c: the lease credit (credit_batch, ops/kernel.py:579-622).
//
// One thread per credit row. Callers pass unique slots (the lease broker
// aggregates per slot), so rows never race; padding rows point at the
// scratch row and are skipped, and global thread 0 zeroes the scratch
// row's value and expiry, which no other thread writes. That is the JAX
// program's end state (its scatters land, then row C is reset) even when
// the scratch row held garbage. Bound: bytes (13 bytes of row in, two
// cells gathered and written back: about 29 bytes per row), 0.04 us at
// H = 4096; the launch costs more than the work.

// One credit row: credit c on cell s, interval (or window) w.
__device__ __forceinline__ void credit_cell(int32_t* __restrict__ values,
                                            int32_t* __restrict__ expiry,
                                            int s, int32_t c, int32_t w,
                                            bool is_bucket, int32_t now) {
  const int32_t e = expiry[s];
  if (is_bucket) {
    if (e > now) {
      // The TAT retreats by credit * interval, floored at now. The
      // product is formed only when the credit covers fewer intervals
      // than lie ahead, where it cannot wrap for a credit >= 0; XLA
      // forms it on every row and discards it. wmul keeps even a
      // negative credit's product equal to XLA's wrapping one.
      const int32_t ival = imax(w, 1);
      const int32_t ahead = imax(wsub(e, now), 0);
      expiry[s] = c >= ahead / ival ? now : wsub(e, wmul(c, ival));
    }
  } else if (now < e) {
    values[s] = imax(wsub(values[s], c), 0);
  }
}

__global__ void credit_kernel(int32_t* __restrict__ values,
                              int32_t* __restrict__ expiry,
                              const int32_t* __restrict__ slots,
                              const int32_t* __restrict__ credits,
                              const int32_t* __restrict__ windows,
                              const uint8_t* __restrict__ bucket, int H,
                              int scratch, int32_t now) {
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (first == 0) {
    values[scratch] = 0;
    expiry[scratch] = 0;
  }
  for (int i = first; i < H; i += gridDim.x * blockDim.x) {
    const int s = slots[i];
    if (s == scratch) continue;
    credit_cell(values, expiry, s, credits[i], windows[i], bucket[i], now);
  }
}

// ---------------------------------------------------------------------------
// B5: the heavy-hitter drain (drain_top_hits, ops/kernel.py:672-685).
//
// Returns lax.top_k(hits[:C], k) and zeroes all C + 1 cells. Each slot
// becomes one unique 64-bit key, (count with its sign bit flipped) << 32 |
// (0xffffffff - index): descending keys are counts descending, ties to
// the lowest index, which is top_k's order. Key 0 (count INT_MIN at index
// 0xffffffff) cannot be a slot's key and pads every list.
//
// k <= 1024, one launch (drain_kernel, below): up to 132 blocks of 256
// threads, one per SM, each walk a contiguous chunk of the column in
// rounds of 4,096 cells, four 16-byte loads a thread (the next round's
// in flight), zeroing each cell with a 16-byte store as it is read. No
// tile is sorted. A block keeps its K best (K = k rounded up to a power
// of two) sorted in shared memory and a threshold, a key that at least K
// keys of the column reach, raised by three bounds: the block's K-th
// best; each round while K <= 256, the least of the maxima of max(K, 32)
// groups of the round's cells (group (cell mod 4, thread mod groups / 4):
// a column ordered by the index alone, all counts equal or rising, keeps
// just `groups` cells); and the row's shared bound, which every block
// raises to its own with an atomicMax after each round and reads back
// before the next, so the hot part of a column filters the rest. A warp
// appends the keys that reach the threshold to a shared candidate buffer
// with one atomicAdd; the buffer is merged into the K best (one bitonic
// sort of the K best and the candidates, at most 2K or 512 keys, warps
// synchronising alone below distance 64) when it is full, and once more
// at the end after a last pass through the shared bound. Each block then
// publishes only its K best at or above the bound (a prefix of its list,
// mostly none) and counts itself done after a fence; the last block to
// finish reads just those, through the same filter, writes the first k,
// and sets the header back to 0 for the next launch on the stream. That
// last-block merge, rather than a thread-block cluster, because a
// cluster holds 16 blocks at most and the column needs 132 to reach the
// card's bandwidth. B7d (sharded_drain_top_hits, parallel/mesh.py:
// 589-612) is the same launch over the n rows of the sharded table, the
// row in blockIdx.y: each row has its own done counter, shared bound,
// published lists and last block, and its own unaligned head and tail
// (row r starts at 4 r (L + 1) bytes). No block waits on another, so a
// grid past one wave needs no co-residency; drain_row_blocks sets the
// blocks a row by k.
// k > 1024: a bitonic sort of every key in device memory, one launch per
// stage, then the first k are decoded: slower, for any k up to C.
// Bound: bytes, the column read and zeroed once: 8 (C + 1) bytes, 2.5 us
// at C = 1 << 20. What is left above it is latency: a round's barriers
// and the merges' bitonic stages (about 0.1 us each), and the last
// block's reads after every block is done.

constexpr int kTopkMaxSmall = 1024;  // largest k of drain_kernel

__device__ __forceinline__ uint64_t topk_key(int32_t count, uint32_t index) {
  return ((uint64_t)((uint32_t)count ^ 0x80000000u) << 32) |
         (uint64_t)(0xffffffffu - index);
}

__device__ __forceinline__ void topk_decode(uint64_t key, int32_t* count,
                                            int32_t* slot) {
  *count = (int32_t)((uint32_t)(key >> 32) ^ 0x80000000u);
  *slot = (int32_t)(0xffffffffu - (uint32_t)(key & 0xffffffffull));
}

__global__ void topk_keys_kernel(int32_t* __restrict__ hits, int n,
                                 int n_keys, long long P,
                                 uint64_t* __restrict__ keys) {
  const long long total = P > n ? P : n;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    uint64_t key = 0;
    if (i < n) {
      const int32_t c = hits[i];
      hits[i] = 0;
      if (i < n_keys) key = topk_key(c, (uint32_t)i);
    }
    if (i < P) keys[i] = key;
  }
}

__global__ void topk_sort_step_kernel(uint64_t* __restrict__ keys,
                                      long long P, long long k,
                                      long long j) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < P; i += (long long)gridDim.x * blockDim.x) {
    const long long ixj = i ^ j;
    if (ixj > i) {
      const uint64_t x = keys[i], y = keys[ixj];
      if ((x < y) == ((i & k) == 0)) {
        keys[i] = y;
        keys[ixj] = x;
      }
    }
  }
}

// The first k sorted keys decoded; answer i at out_counts[i * stride] and
// out_slots[i * stride] (stride 2: (count, slot) pairs in a host buffer).
__global__ void topk_emit_kernel(const uint64_t* __restrict__ keys, int k,
                                 int32_t* __restrict__ out_counts,
                                 int32_t* __restrict__ out_slots,
                                 int stride) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += gridDim.x * blockDim.x) {
    topk_decode(keys[i], &out_counts[(size_t)i * stride],
                &out_slots[(size_t)i * stride]);
  }
}

// B5's one-launch drain, k <= 1024 (see the section's head).
constexpr int kDrainThreads = 256;
constexpr int kDrainKeys = 16;  // keys a thread holds in a round
constexpr int kDrainVecs = kDrainKeys / 4;  // 16-byte loads a thread a round
constexpr int kDrainBuf = 2048;  // the K best, then the candidates
constexpr int kDrainMaxBlocks = 132;  // one per SM
constexpr int kDrainGroupMaxK = 256;  // the round threshold's largest K

struct DrainShared {
  uint64_t buf[kDrainBuf];  // [0, K) the K best, descending; then cnt keys
  uint64_t gmax[kDrainThreads];  // group maxima of the round threshold
  uint64_t wmin[kDrainThreads / 32];
  uint64_t thr;  // a key reaching it may be among the block's K best
  int cnt;
  int published;  // of the K best, those at or above the bound
  int last;
};

// Candidates a block gathers before it merges: K up to 256 merge every
// 256 (a sort of at most 512 keys), a larger K every K (2K keys). Each
// merge raises the threshold, and the keys still waiting are filtered
// again, so a column that floods the buffer merges often but small.
__device__ __forceinline__ int drain_room(int K) { return K < 256 ? 256 : K; }

// Descending bitonic sort of a[0, P) (P a power of two) by the block,
// P / 2 compare-exchanges a stage. At a distance up to 32 a warp's pairs
// stay in its own 64 keys (pair q touches keys 64 (q / 32) + [0, 64));
// at 64 or more they cross into other warps' keys. So only a step
// between two stages both at distances up to 32 may sync the warp alone;
// a step into or out of a wider stage needs the block's barrier.
__device__ void drain_sort(uint64_t* a, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < (P >> 1); q += blockDim.x) {
        const int lo = 2 * q - (q & (j - 1)), hi = lo + j;
        const uint64_t x = a[lo], y = a[hi];
        if ((x < y) == ((lo & k) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      const int next = j > 1 ? j >> 1 : k;  // the next stage's distance
      if (j >= 64 || next >= 64) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

// The K best and the m candidates after them sorted as one list; its
// first K are the new K best, and the K-th raises the threshold.
__device__ void drain_merge(DrainShared& s, int K, int m) {
  const int P = next_pow2(K + m);
  for (int i = K + m + threadIdx.x; i < P; i += blockDim.x) s.buf[i] = 0;
  __syncthreads();
  drain_sort(s.buf, P);
  if (threadIdx.x == 0) {
    s.cnt = 0;
    if (s.buf[K - 1] > s.thr) s.thr = s.buf[K - 1];
  }
  __syncthreads();
}

// The round threshold: key 4q + e of thread t (cell 4 (q * 256 + t) + e
// of the round) goes to group e * groups / 4 + t % (groups / 4), groups
// >= K; each group's maximum is a distinct key of the round, so at least
// K keys reach the least of them. The lowest cell of group (e, t) is
// cell 4t + e: a column ordered by the index alone leaves the round's
// first or last `groups` cells. Raises s.thr to it.
__device__ __forceinline__ void drain_round_threshold(
    DrainShared& s, const uint64_t (&key)[kDrainKeys], unsigned mask,
    int groups) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int quarter = groups >> 2;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint64_t m = 0;
#pragma unroll
    for (int q = 0; q < kDrainVecs; ++q) {
      const int j = 4 * q + e;
      if ((mask >> j & 1) && key[j] > m) m = key[j];
    }
    // lanes quarter apart share a group: their maximum first
    for (int o = quarter; o < 32; o <<= 1) {
      const uint64_t y = __shfl_xor_sync(kFull, m, o);
      m = y > m ? y : m;
    }
    if (m && lane < quarter) {
      atomicMax(reinterpret_cast<unsigned long long*>(
                    &s.gmax[e * quarter + tid % quarter]),
                (unsigned long long)m);
    }
  }
  __syncthreads();
  uint64_t least = ~0ull;
  if (tid < groups) {
    least = s.gmax[tid];
    s.gmax[tid] = 0;  // for the next round
  }
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t y = __shfl_xor_sync(kFull, least, o);
    least = y < least ? y : least;
  }
  if (lane == 0) s.wmin[tid >> 5] = least;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kDrainThreads / 32; ++w) {
      least = s.wmin[w] < least ? s.wmin[w] : least;
    }
    if (least != ~0ull && least > s.thr) s.thr = least;
  }
  __syncthreads();
}

// Appends the keys of `mask` that reach the threshold to the candidate
// buffer, a warp at a time (one atomicAdd), and merges whenever the
// buffer fills, until every key of the round is in or below the
// threshold. Called by every thread of the block.
__device__ __forceinline__ void drain_absorb(DrainShared& s,
                             const uint64_t (&key)[kDrainKeys],
                             unsigned mask, int K) {
  const int lane = threadIdx.x & 31;
  const int room = drain_room(K);
  for (;;) {
    const uint64_t thr = s.thr;
#pragma unroll
    for (int j = 0; j < kDrainKeys; ++j) {
      if (key[j] < thr) mask &= ~(1u << j);
    }
    const int mine = __popc(mask);
    int incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    int base = 0;
    if (lane == 31 && total) base = atomicAdd(&s.cnt, total);
    int pos = __shfl_sync(kFull, base, 31) + incl - mine;
#pragma unroll
    for (int j = 0; j < kDrainKeys; ++j) {
      if (mask >> j & 1) {
        if (pos < room) {
          s.buf[K + pos] = key[j];
          mask &= ~(1u << j);
        }
        ++pos;
      }
    }
    __syncthreads();
    const int cnt = s.cnt;
    const int pending = __syncthreads_or(mask != 0);
    if (cnt >= room) drain_merge(s, K, room);
    if (!pending) return;
  }
}

// The workspace of `rows` rows of G blocks: a header with each row's
// done counter (uint32) and shared threshold (uint64), 0 between
// launches; each block's count of published keys (uint32); each block's
// published keys (K a block).
__host__ __device__ inline size_t drain_thr_offset(int rows) {
  return ((size_t)rows * 4 + 7) & ~(size_t)7;
}
__host__ __device__ inline size_t drain_head_bytes(int rows) {
  return (drain_thr_offset(rows) + (size_t)rows * 8 + 255) & ~(size_t)255;
}
__host__ __device__ inline size_t drain_cand_offset(int rows, int G) {
  return drain_head_bytes(rows) + (((size_t)rows * G * 4 + 255) & ~(size_t)255);
}

// The row's shared threshold folded into the block's (thread 0; the
// caller's next barrier publishes it). Every bound in it is one that at
// least K keys of the row reach.
__device__ __forceinline__ void drain_take_shared(DrainShared& s,
                                                  unsigned long long* gthr) {
  const uint64_t g = __ldcg(gthr);
  if (g > s.thr) s.thr = g;
}

// B5 on row blockIdx.y of `rows` columns of n cells (B5 runs one, B7d
// the sharded table's rows), gridDim.x blocks a row. The column is
// zeroed; row r's first k answers go to out_counts[(r k + i) stride] and
// out_slots[(r k + i) stride]. The workspace's header must be 0 before
// the launch and is 0 after it.
//
// The blocks share their thresholds: each raises the row's shared bound
// (atomicMax) to its own after every round and reads it back before the
// next, so a bound found in the hot part of the column filters the rest
// of it. At the end a block drops its candidates below the bound, merges
// the rest, and publishes only its K best that reach it (a prefix of its
// sorted list, often none); the last block reads just those.
__global__ void __launch_bounds__(kDrainThreads) drain_kernel(
    int32_t* __restrict__ hits, int n, int K, int k, int groups,
    char* __restrict__ workspace, int32_t* __restrict__ out_counts,
    int32_t* __restrict__ out_slots, int stride) {
  __shared__ DrainShared s;
  __shared__ int offs[kDrainMaxBlocks + 1];
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const int rows = gridDim.y;
  const size_t row = blockIdx.y;
  const int n_keys = n - 1;  // the scratch cell is zeroed, never a key
  hits += row * n;
  unsigned* done = reinterpret_cast<unsigned*>(workspace) + row;
  unsigned long long* gthr = reinterpret_cast<unsigned long long*>(
                                 workspace + drain_thr_offset(rows)) + row;
  unsigned* counts = reinterpret_cast<unsigned*>(
                         workspace + drain_head_bytes(rows)) + row * G;
  uint64_t* cand = reinterpret_cast<uint64_t*>(
                       workspace + drain_cand_offset(rows, G)) + row * G * K;
  out_counts += row * k * stride;
  out_slots += row * k * stride;
  for (int i = tid; i < K; i += kDrainThreads) s.buf[i] = 0;
  s.gmax[tid] = 0;
  if (tid == 0) {
    s.thr = 1;  // every slot's key is >= 1; key 0 is filler
    s.cnt = 0;
  }
  __syncthreads();
  // Cells before the first 16-byte boundary and after the last whole
  // vector: block 0's, before its rounds.
  const int misaligned = (int)(((uintptr_t)hits >> 2) & 3);
  const int head = misaligned ? (4 - misaligned < n ? 4 - misaligned : n) : 0;
  const int nv = (n - head) >> 2;
  const int tail = head + 4 * nv;
  if (blockIdx.x == 0 && head + n - tail > 0) {
    uint64_t key[kDrainKeys] = {};
    unsigned mask = 0;
    const int i = tid < head ? tid : tail + tid - head;
    if (tid < head + n - tail) {
      const int32_t c = hits[i];
      hits[i] = 0;
      if (i < n_keys) {
        key[0] = topk_key(c, (uint32_t)i);
        mask = 1;
      }
    }
    drain_absorb(s, key, mask, K);
  }
  // Rounds of 4096 cells, the next round's loads in flight while this
  // one is filtered.
  int4* vec = reinterpret_cast<int4*>(hits + head);
  constexpr int step = kDrainThreads * kDrainVecs;
  const int per = (nv + G - 1) / G;
  const int lo = blockIdx.x * per;
  const int hi = lo + per < nv ? lo + per : nv;
  int4 next[kDrainVecs];
#pragma unroll
  for (int q = 0; q < kDrainVecs; ++q) {
    const int x = lo + q * kDrainThreads + tid;
    if (x < hi) next[q] = vec[x];
  }
  for (int base = lo; base < hi; base += step) {
    int4 v[kDrainVecs];
#pragma unroll
    for (int q = 0; q < kDrainVecs; ++q) {
      const int x = base + q * kDrainThreads + tid;
      v[q] = next[q];
      if (x < hi) vec[x] = make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int q = 0; q < kDrainVecs; ++q) {
      const int x = base + step + q * kDrainThreads + tid;
      if (x < hi) next[q] = vec[x];
    }
    // The shared bound's load in flight with the keys' arithmetic.
    const uint64_t shared_bound = G > 1 && tid == 0 ? __ldcg(gthr) : 0;
    uint64_t key[kDrainKeys];
    unsigned mask = 0;
#pragma unroll
    for (int q = 0; q < kDrainVecs; ++q) {
      const int x = base + q * kDrainThreads + tid;
      const int32_t c[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cell = head + 4 * x + e;
        const bool live = x < hi && cell < n_keys;
        key[4 * q + e] = live ? topk_key(c[e], (uint32_t)cell) : 0;
        mask |= (unsigned)live << (4 * q + e);
      }
    }
    if (tid == 0 && shared_bound > s.thr) s.thr = shared_bound;
    if (groups) {
      drain_round_threshold(s, key, mask, groups);
    } else {
      __syncthreads();
    }
    drain_absorb(s, key, mask, K);
    if (G > 1 && tid == 0 && s.thr > 1) atomicMax(gthr, s.thr);
  }
  if (G > 1) {
    // The candidates again through the latest shared bound, compacted.
    if (tid == 0) drain_take_shared(s, gthr);
    __syncthreads();
    const int m = s.cnt;
    uint64_t key[kDrainKeys];
    unsigned mask = 0;
#pragma unroll
    for (int j = 0; j < kDrainKeys; ++j) {
      const int x = j * kDrainThreads + tid;
      key[j] = x < m ? s.buf[K + x] : 0;
      mask |= (unsigned)(x < m) << j;
    }
    __syncthreads();
    if (tid == 0) s.cnt = 0;
    __syncthreads();
    drain_absorb(s, key, mask, K);
  }
  if (s.cnt) drain_merge(s, K, s.cnt);
  if (G > 1) {
    // Publish the K best that reach the bound (a prefix of the sorted
    // list), and the block's K-th best as a bound.
    if (tid == 0) {
      if (s.buf[K - 1] > s.thr) s.thr = s.buf[K - 1];
      if (s.thr > 1) atomicMax(gthr, s.thr);
      drain_take_shared(s, gthr);
    }
    if (tid == 0) s.published = 0;
    __syncthreads();
    const uint64_t thr = s.thr;
    for (int i = tid; i < K; i += kDrainThreads) {
      if (s.buf[i] >= thr) {
        cand[(size_t)blockIdx.x * K + i] = s.buf[i];
        if (i == K - 1 || s.buf[i + 1] < thr) s.published = i + 1;
      }
    }
    __syncthreads();
    if (tid == 0) counts[blockIdx.x] = (unsigned)s.published;
    __threadfence();
    __syncthreads();
    if (tid == 0) s.last = atomicAdd(done, 1u) == (unsigned)G - 1;
    __syncthreads();
    if (!s.last) return;
    __threadfence();
    // The last block: the published keys of the others (its own K best
    // are in s.buf), through the same filter from the final bound.
    if (tid == 0) drain_take_shared(s, gthr);
    int c = 0;
    if (tid < G && tid != (int)blockIdx.x) c = (int)__ldcg(counts + tid);
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if ((tid & 31) >= o) incl += y;
    }
    if ((tid & 31) == 31) s.wmin[tid >> 5] = (uint64_t)incl;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < (tid >> 5); ++w) before += (int)s.wmin[w];
    if (tid < G) offs[tid] = before + incl - c;
    if (tid == G - 1) offs[G] = before + incl;
    __syncthreads();
    const int total = offs[G];
    for (int base = 0; base < total; base += kDrainThreads * kDrainKeys) {
      uint64_t key[kDrainKeys];
      unsigned mask = 0;
#pragma unroll
      for (int j = 0; j < kDrainKeys; ++j) {
        const int x = base + j * kDrainThreads + tid;
        key[j] = 0;
        if (x < total) {
          int lo_b = 0, hi_b = G - 1;  // the block b with offs[b] <= x < offs[b + 1]
          while (lo_b < hi_b) {
            const int mid = (lo_b + hi_b + 1) >> 1;
            if (offs[mid] <= x) {
              lo_b = mid;
            } else {
              hi_b = mid - 1;
            }
          }
          key[j] = __ldcg(reinterpret_cast<const unsigned long long*>(
              cand + (size_t)lo_b * K + (x - offs[lo_b])));
          mask |= 1u << j;
        }
      }
      drain_absorb(s, key, mask, K);
    }
    if (s.cnt) drain_merge(s, K, s.cnt);
    if (tid == 0) {
      *done = 0;
      *gthr = 0;
    }
  }
  for (int i = tid; i < k; i += kDrainThreads) {
    topk_decode(s.buf[i], &out_counts[(size_t)i * stride],
                &out_slots[(size_t)i * stride]);
  }
}

// Blocks a row of n cells: one per round of cells, at most one per SM,
// and at most `cap` (0: no cap of its own).
int drain_blocks(int n, int cap) {
  const int rounds = (n / 4 + kDrainThreads * kDrainVecs - 1) /
                     (kDrainThreads * kDrainVecs);
  int G = rounds < kDrainMaxBlocks ? rounds : kDrainMaxBlocks;
  if (cap > 0 && G > cap) G = cap;
  return G < 1 ? 1 : G;
}

long long drain_workspace_bytes(int rows, int G, int k) {
  return (long long)drain_cand_offset(rows, G) +
         (long long)rows * G * next_pow2(k) * 8;
}

// One drain_kernel launch over `rows` rows of G blocks; the header must
// be 0.
int launch_drain(int32_t* hits, int rows, int n, int G, int k,
                 void* workspace, int32_t* out_counts, int32_t* out_slots,
                 int stride, cudaStream_t st) {
  const int K = next_pow2(k);
  const int groups = K <= kDrainGroupMaxK ? (K < 32 ? 32 : K) : 0;
  drain_kernel<<<dim3(G, rows), kDrainThreads, 0, st>>>(
      hits, n, K, k, groups, static_cast<char*>(workspace), out_counts,
      out_slots, stride);
  return (int)cudaGetLastError();
}

long long topk_sort_len(int n_keys) {
  long long P = 1;
  while (P < n_keys) P <<= 1;
  return P;
}

int grid_for(int n) {
  int blocks = (n + 255) / 256;
  return blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16;
}

int smem_for(int H) {
  const int P = next_pow2(H);
  return P <= kSmemKeys ? P * 8 : 0;
}

// kRemote = false is B1 (the remote pointers are null and never read);
// true is B6a. One template, so B1's code is what it was.
template <bool kRemote>
int launch_check(void* values, void* expiry, void* hits,
                 const void* remote_vals, const void* remote_exp,
                 const void* slots, const void* deltas, const void* maxes,
                 const void* windows, const void* req_ids, const void* fresh,
                 const void* bucket, int H, int scratch, int now_ms,
                 void* workspace, void* out_admitted, void* out_ok,
                 void* out_remaining, void* out_ttl, void* stream) {
  cudaFuncSetAttribute(check_kernel<kRemote>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemKeys * 8);
  check_kernel<kRemote><<<1, kThreads, smem_for(H), (cudaStream_t)stream>>>(
      (int32_t*)values, (int32_t*)expiry, (int32_t*)hits,
      (const int32_t*)remote_vals, (const int32_t*)remote_exp,
      (const int32_t*)slots, (const int32_t*)deltas, (const int32_t*)maxes,
      (const int32_t*)windows, (const int32_t*)req_ids,
      (const uint8_t*)fresh, (const uint8_t*)bucket, H, scratch,
      (int32_t)now_ms, workspace, (uint8_t*)out_admitted, (uint8_t*)out_ok,
      (int32_t*)out_remaining, (int32_t*)out_ttl, nullptr, Rows{});
  return (int)cudaGetLastError();
}

// Whether the card places a cluster of `blocks` blocks of this
// check_cluster_kernel instance at the largest block it may launch at that
// size (1024 threads and kClusterSmemMax bytes, one block to an SM):
// cudaOccupancyMaxActiveClusters, asked once per card, instance and size.
// 1 yes, 0 no, a negative CUDA error.
template <bool kRemote, bool kRows>
int cluster_room(int blocks) {
  constexpr int kDevices = 64;
  static int room[kDevices][kClusterMaxBlocks + 1];  // 0 unknown, 1 yes, 2 no
  auto kernel = check_cluster_kernel<kRemote, kRows>;
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return -(int)rc;
  int* known = device < kDevices ? &room[device][blocks] : nullptr;
  if (known && *known) return *known == 1;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)kClusterSmemMax);
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (rc != cudaSuccess) return -(int)rc;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kClusterSmemMax;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  rc = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return -(int)rc;
  }
  if (known) *known = clusters > 0 ? 1 : 2;
  return clusters > 0;
}

// check_cluster_kernel on `clusters` clusters of ceil(H / 1024) blocks
// each, H <= kClusterMaxHits hits a cluster, sort keys in [0, max_key].
// B1 and B6a pass one cluster and max_key = scratch. A cluster the card
// cannot place is refused (cudaErrorInvalidClusterSize) before any
// launch; so is one the launch itself refuses.
template <bool kRemote, bool kRows>
int launch_check_cluster(void* values, void* expiry, void* hits,
                         const void* slots, const void* deltas,
                         const void* maxes, const void* windows,
                         const void* req_ids, const void* fresh,
                         const void* bucket, int H, int clusters,
                         int scratch, int max_key, int cap, int now_ms,
                         const ClusterHooks& hk, void* out_admitted,
                         void* out_ok, void* out_remaining, void* out_ttl,
                         void* stream) {
  if (H < 1 || H > kClusterMaxHits || clusters < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const ClusterPlan p = cluster_plan(H, max_key, cap);
  const int room = cluster_room<kRemote, kRows>(p.blocks);
  if (room < 0) return -room;
  if (room == 0) return (int)cudaErrorInvalidClusterSize;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(p.blocks * clusters);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = cluster_smem(p);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, check_cluster_kernel<kRemote, kRows>, (int32_t*)values,
      (int32_t*)expiry, (int32_t*)hits, (const int32_t*)slots,
      (const int32_t*)deltas, (const int32_t*)maxes, (const int32_t*)windows,
      (const int32_t*)req_ids, (const uint8_t*)fresh, (const uint8_t*)bucket,
      H, scratch, (int32_t)now_ms, p, (uint8_t*)out_admitted,
      (uint8_t*)out_ok, (int32_t*)out_remaining, (int32_t*)out_ttl, hk);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// B7a's workspace: n rows of B1's workspace, then global_vals[G], then
// the coupled admitted[n*H], vote[n*H] and two changed flags.
size_t sharded_ws_row(int H) { return workspace_bytes(H, kCheckArrays); }

size_t sharded_check_ws(int n, int H, int G) {
  return (size_t)n * sharded_ws_row(H) +
         4 * ((size_t)G + 2 * (size_t)n * H + 2);
}

// Blocks of the coupled instance that fit on the card at once: the
// cooperative launch needs every row's block resident.
template <bool kGlobal>
int coupled_capacity(int H) {
  auto kernel = check_kernel<false, true, kGlobal, true>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemKeys * 8);
  int per_sm = 0, device = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, smem_for(H)) != cudaSuccess ||
      cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess) {
    return -1;
  }
  return per_sm * sms;
}

template <bool kGlobal, bool kCoupled>
int launch_sharded_check(void* values, void* expiry, void* hits,
                         const void* slots, const void* deltas,
                         const void* maxes, const void* windows,
                         const void* req_ids, const void* fresh,
                         const void* bucket, const void* is_global, int n,
                         int H, int L, int now_ms, int G, void* workspace,
                         void* out_admitted, void* out_ok,
                         void* out_remaining, void* out_ttl, void* stream) {
  auto kernel = check_kernel<false, true, kGlobal, kCoupled>;
  cudaStream_t st = (cudaStream_t)stream;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemKeys * 8);
  const size_t ws_row = sharded_ws_row(H);
  int32_t* tail = reinterpret_cast<int32_t*>(
      static_cast<char*>(workspace) + (size_t)n * ws_row);
  Rows rows{ws_row, tail, G, tail + G};
  if (kGlobal) {
    global_sum_kernel<<<grid_for(G), 256, 0, st>>>(
        (const int32_t*)values, (const int32_t*)expiry, n, L + 1, G,
        (int32_t)now_ms, tail);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  int32_t* v = (int32_t*)values;
  int32_t* e = (int32_t*)expiry;
  int32_t* h = (int32_t*)hits;
  const int32_t* no_remote = nullptr;
  const int32_t* sl = (const int32_t*)slots;
  const int32_t* de = (const int32_t*)deltas;
  const int32_t* mx = (const int32_t*)maxes;
  const int32_t* wi = (const int32_t*)windows;
  const int32_t* rq = (const int32_t*)req_ids;
  const uint8_t* fr = (const uint8_t*)fresh;
  const uint8_t* bu = (const uint8_t*)bucket;
  const uint8_t* gl = (const uint8_t*)is_global;
  int32_t now = (int32_t)now_ms;
  int scratch = L;
  uint8_t* oa = (uint8_t*)out_admitted;
  uint8_t* ok = (uint8_t*)out_ok;
  int32_t* orem = (int32_t*)out_remaining;
  int32_t* ottl = (int32_t*)out_ttl;
  const int smem = smem_for(H);
  if (!kCoupled) {
    kernel<<<n, kThreads, smem, st>>>(v, e, h, no_remote, no_remote, sl, de,
                                      mx, wi, rq, fr, bu, H, scratch, now,
                                      workspace, oa, ok, orem, ottl, gl,
                                      rows);
    return (int)cudaGetLastError();
  }
  void* args[] = {&v,  &e,  &h,  &no_remote, &no_remote, &sl,  &de,
                  &mx, &wi, &rq, &fr,        &bu,        &H,   &scratch,
                  &now, &workspace, &oa,    &ok,        &orem, &ottl,
                  &gl, &rows};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(n),
                                          dim3(kThreads), args, smem, st);
}

// kRemote = false is B2; true is B6b.
template <bool kRemote>
int launch_update(void* values, void* expiry, void* hits,
                  const void* remote_exp, const void* slots,
                  const void* deltas, const void* windows, const void* fresh,
                  const void* bucket, int H, int scratch, int now_ms,
                  void* workspace, void* stream) {
  cudaFuncSetAttribute(update_kernel<kRemote>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemKeys * 8);
  update_kernel<kRemote><<<1, kThreads, smem_for(H), (cudaStream_t)stream>>>(
      (int32_t*)values, (int32_t*)expiry, (int32_t*)hits,
      (const int32_t*)remote_exp, (const int32_t*)slots,
      (const int32_t*)deltas, (const int32_t*)windows, (const uint8_t*)fresh,
      (const uint8_t*)bucket, H, scratch, (int32_t)now_ms, workspace, 0);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host lists by value: B7b, B4d, B3a, B6c, B3b, B7c and B6b from the
// storages' own lists.
//
// The storages decide clears, promotion seeds, reads and remote shares on
// the host, a few cells at a time. Staged as device tensors (a pinned buffer, an H2D copy and
// tensor checks per array), such a list cost 50-80 us of host time around
// a kernel of 1-2 us. Here the list travels in the kernel's parameter
// block instead: the entry point copies it into a struct passed as a
// const __grid_constant__ parameter, which the launch itself carries to
// the card's constant bank, so a call allocates nothing and issues no
// copy. Since CUDA 12.1 a kernel takes 32,764 bytes of parameters (4,096
// before); a longer list launches in chunks of one block, in order, on
// the same stream. Each kernel comes in three block sizes, so that the
// launch of a short list does not carry a full block: a few entries, up
// to 4,096 bytes of parameters in all (the classic limit), and the most
// that fits.
//
// A context (ct_ctx_create) binds the table's three columns, its shape
// and the storage's stream once; a call passes the handle and the list.
// Bound: bytes, 12 B written per distinct cell (B3a: 8 B read and 8 B
// answered per slot; B6c: 12 B of row and 8 B written); a call is
// launch-bound.
//
// B3a's answers must come back to the host, after every launch queued
// before them on the storage's stream (a tier demotion is exact only so).
// The kernel stores them straight into pinned host memory that the
// context owns, mapped into the card's address space, and the call waits
// on the stream: no device buffer, no copy, no second synchronisation.

#if __CUDACC_VER_MAJOR__ > 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
constexpr int kListInts = 8000;  // 32,000 B of the 32,764
#else
constexpr int kListInts = 960;   // 3,840 B of the 4,096
#endif

struct Ctx {
  int32_t* values;
  int32_t* expiry;
  int32_t* hits;
  int rows;
  int row_len;
  int device;
  cudaStream_t stream;
  // B3a's answers: (value, ttl) pairs in pinned host memory mapped into
  // the card's address space (result_dev is its device alias).
  int2* result = nullptr;
  int2* result_dev = nullptr;
  int result_cap = 0;
  // B6c's staged design: pinned [3, n] rows, their device copy, and the
  // event after the copy that guards the pinned rows' reuse.
  int32_t* stage = nullptr;
  int32_t* stage_dev = nullptr;
  int stage_cap = 0;
  cudaEvent_t staged = nullptr;
  // B5's and B7d's host form: the header and each block's K best.
  void* drain_ws = nullptr;
  long long drain_ws_bytes = 0;
  // The staged design of B7c's, B6b's, B2's and B4c's host forms: pinned
  // [4, cap] entries, their device copy with the sort's scratch arrays,
  // and the event guarding the pinned rows.
  int32_t* upd_stage = nullptr;
  int32_t* upd_dev = nullptr;
  int upd_cap = 0;
  cudaEvent_t upd_staged = nullptr;
};

// The context's card is current for the launch (the calling thread's own
// current device is restored after it).
struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int device) {
    int cur;
    if (cudaGetDevice(&cur) == cudaSuccess && cur != device) {
      prev = cur;
      cudaSetDevice(device);
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

template <int N>
struct ClearList {
  int32_t e[N];
};

template <int N>
struct SeedList {
  int32_t slot[N];
  int32_t value[N];
  int32_t expiry[N];
};

// B7b's host form: `count` entries, either (row, slot) pairs or, with
// all_rows, slots cleared on every row (the global region's evictions:
// one list, not n copies of it). In the all-rows form neighbouring
// threads take the rows of one slot, so a warp reads few distinct words
// of the list (the constant cache serves one word per access).
template <int N>
__global__ void clear_list_kernel(int32_t* __restrict__ values,
                                  int32_t* __restrict__ expiry,
                                  int32_t* __restrict__ hits, int count,
                                  int all_rows, int rows, int row_len,
                                  const __grid_constant__ ClearList<N> list) {
  const int total = all_rows ? count * rows : count;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    int row, slot;
    if (all_rows) {
      const int j = i / rows;
      row = i - j * rows;
      slot = list.e[j];
    } else {
      row = list.e[2 * i];
      slot = list.e[2 * i + 1];
    }
    const size_t cell = (size_t)row * row_len + slot;
    values[cell] = 0;
    expiry[cell] = 0;
    hits[cell] = 0;
  }
}

// B4d's host form: seed_slots_kernel's writes from a list in one block.
// The JAX program pads to a pow2 bucket; `padded` says its list had a
// padding row, whose hits scatter zeroes the scratch cell's hits. A slot
// equal to the scratch slot counts as padding, as in seed_slots_kernel.
template <int N>
__global__ void seed_list_kernel(int32_t* __restrict__ values,
                                 int32_t* __restrict__ expiry,
                                 int32_t* __restrict__ hits, int n,
                                 int scratch, int padded,
                                 const __grid_constant__ SeedList<N> list) {
  int pad = padded;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s = list.slot[i];
    if (s == scratch) {
      pad = 1;
      continue;
    }
    values[s] = list.value[i];
    expiry[s] = list.expiry[i];
    hits[s] = 0;
  }
  if (__syncthreads_or(pad) && threadIdx.x == 0) hits[scratch] = 0;
  if (threadIdx.x == 0) {
    values[scratch] = 0;
    expiry[scratch] = 0;
  }
}

template <int N>
struct SlotList {
  int32_t slot[N];
};

// B3a's host form: read_slots_kernel's arithmetic on a list in the
// parameter block, each row's (value, ttl) one 8-byte store into the
// context's mapped host buffer (a posted write across the bus; the host
// reads it after the caller's wait on the stream).
template <int N>
__global__ void read_list_kernel(const int32_t* __restrict__ values,
                                 const int32_t* __restrict__ expiry, int n,
                                 int32_t now, int2* __restrict__ out,
                                 const __grid_constant__ SlotList<N> list) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int s = list.slot[i];
    const int32_t v = values[s], e = expiry[s];
    out[i] = make_int2(e > now ? v : 0, imax(wsub(e, now), 0));
  }
}

// B6c's host form: apply_remote_kernel's scatter from rows in the
// parameter block. It writes the two lanes and nothing else: on the
// remote lanes' context `hits` aliases the expiry lane, so a kernel that
// zeroed hits (seed_list_kernel) would undo the shares it wrote.
template <int N>
__global__ void remote_list_kernel(int32_t* __restrict__ remote_vals,
                                   int32_t* __restrict__ remote_exp, int n,
                                   const __grid_constant__ SeedList<N> list) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int s = list.slot[i];
    remote_vals[s] = list.value[i];
    remote_exp[s] = list.expiry[i];
  }
}

// B7c's host form (sharded_update, parallel/mesh.py:552-586): B2 on each
// row of the sharded table from a flat list of entries, (cell, delta,
// window, flags) with cell = row * (L + 1) + slot and flags bit 0 fresh,
// bit 1 bucket. Cells never cross rows, so one pass over the flattened
// rows is B2 on each row. One block: a warp for up to 32 entries, more
// warps up to the list's capacity. It sorts the entries by cell, stably
// (the key is cell << 32 | entry index, as B7a's cluster keys its
// hits), finds each sorted entry's segment start by a binary search of
// the sorted keys, gathers each segment's exact delta sum (64-bit
// atomics: count * (2^30 - 1) never wraps), OR of fresh and largest
// window at its start, and the segment's last entry (the last in list
// order) applies update_kernel's rules. No workspace: the keys and the
// segment arrays are shared memory (P = next_pow2(count) of each, 24
// bytes a key, and the list itself, copied out of the parameter block),
// or, for a list past one parameter block, the context's staging buffer
// in device memory (ct_sharded_update_host). Every row's
// scratch cell is zeroed, as the JAX program's scatter leaves it. Bound:
// bytes, 16 B of entry read and 12 B read and written per distinct cell;
// a call is launch-bound.
// B6b's host form (_replicated_update, tpu/replicated.py:96-117) is the
// same body on a single table (row 0) with `floor` set to the remote
// expiry lane: a bucket cell, by its segment's last entry's flag, starts
// its advance from max(own TAT, or 0 when fresh; floor[cell]) before
// max(., now), as update_core folds tat_floor_hook (ops/kernel.py:
// 535-538); window cells never read it. B7c and B2's host form (this
// body on a one-row table) pass null: their cells compute exactly what
// they did without the argument. B6b adds 4 B read
// per distinct bucket cell.
__device__ void update_entries(int32_t* __restrict__ values,
                               int32_t* __restrict__ expiry,
                               int32_t* __restrict__ hits, int rows,
                               int row_len, const int32_t* cell,
                               const int32_t* delta, const int32_t* window,
                               const int32_t* flags, int count, int32_t now,
                               const int32_t* __restrict__ floor,
                               uint64_t* keys,
                               unsigned long long* seg_sum, int* seg_fresh,
                               int* seg_win) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int P = next_pow2(count);
  for (int i = tid; i < P; i += T) {
    keys[i] = i < count ? ((uint64_t)(uint32_t)cell[i] << 32 | (uint32_t)i)
                        : ~0ull;
    seg_sum[i] = 0;
    seg_fresh[i] = 0;
    seg_win[i] = kIntMin;
  }
  __syncthreads();
  // Ascending bitonic sort (the padding keys, all ones, sort last).
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < (P >> 1); q += T) {
        const int lo = 2 * q - (q & (j - 1)), hi = lo + j;
        const uint64_t x = keys[lo], y = keys[hi];
        if ((x > y) == ((lo & k) == 0)) {
          keys[lo] = y;
          keys[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  // The start of sorted entry i's segment: the first key of its cell.
  auto seg_start = [&](int i, uint32_t c) {
    int lo = 0, hi = i;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((uint32_t)(keys[mid] >> 32) < c) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    return lo;
  };
  for (int i = tid; i < count; i += T) {
    const uint64_t key = keys[i];
    const int start = seg_start(i, (uint32_t)(key >> 32));
    const int e = (int)(uint32_t)key;
    atomicAdd(&seg_sum[start],
              (unsigned long long)imin(imax(delta[e], 0), kMaxDeltaCap));
    if (flags[e] & 1) atomicOr(&seg_fresh[start], 1);
    atomicMax(&seg_win[start], window[e]);
  }
  __syncthreads();
  for (int i = tid; i < count; i += T) {
    const uint64_t key = keys[i];
    const uint32_t c = (uint32_t)(key >> 32);
    if (i + 1 < count && (uint32_t)(keys[i + 1] >> 32) == c) continue;
    const int start = seg_start(i, c);
    const int e = (int)(uint32_t)key;  // the segment's last in list order
    const unsigned long long sum = seg_sum[start];
    const int32_t seg_add =
        sum >= (unsigned long long)kMaxValueCap ? kMaxValueCap : (int32_t)sum;
    const bool h_fresh = seg_fresh[start];
    const bool is_bucket = flags[e] & 2;
    const int32_t win = window[e];
    const int32_t v_raw = values[c], e_raw = expiry[c];
    const bool cell_expired = e_raw <= now || h_fresh;
    const int32_t base_c = imin(cell_expired ? 0 : v_raw, kMaxValueCap);
    const int32_t headroom = wsub(kMaxValueCap, base_c);
    values[c] = is_bucket ? 0 : wadd(base_c, imin(seg_add, headroom));
    if (cell_expired || is_bucket) {
      const int32_t ival = imax(win, 1);
      int32_t local_tat = h_fresh ? 0 : e_raw;
      if (floor != nullptr && is_bucket) {
        local_tat = imax(local_tat, floor[c]);
      }
      const int32_t tat_base = imax(local_tat, now);
      const int32_t max_adv = floordiv(wsub(kNever, tat_base), ival);
      const int32_t adv = imin(seg_add, max_adv);
      expiry[c] = is_bucket ? wadd(tat_base, wmul(adv, win))
                            : wadd(now, seg_win[start]);
    }
    hits[c] = wadd(h_fresh ? 0 : hits[c], i - start + 1);
  }
  for (int r = tid; r < rows; r += T) {
    const size_t scratch = (size_t)r * row_len + row_len - 1;
    values[scratch] = 0;
    expiry[scratch] = 0;
    hits[scratch] = 0;
  }
}

template <int N>
struct UpdateList {
  int32_t cell[N];
  int32_t delta[N];
  int32_t window[N];
  int32_t flags[N];
};

template <int N>
__global__ void update_list_kernel(int32_t* __restrict__ values,
                                   int32_t* __restrict__ expiry,
                                   int32_t* __restrict__ hits, int rows,
                                   int row_len, int count, int32_t now,
                                   const int32_t* __restrict__ floor,
                                   const __grid_constant__ UpdateList<N> list) {
  extern __shared__ uint64_t smem_keys[];
  const int P = next_pow2(count);
  uint64_t* keys = smem_keys;
  auto* seg_sum = reinterpret_cast<unsigned long long*>(keys + P);
  int* seg_fresh = reinterpret_cast<int*>(seg_sum + P);
  // The list copied out of the parameter block once, in order: the
  // constant bank serves one word a warp access, and the passes below
  // read the entries in sorted order.
  int32_t* ent = seg_fresh + 2 * P;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    ent[i] = list.cell[i];
    ent[count + i] = list.delta[i];
    ent[2 * count + i] = list.window[i];
    ent[3 * count + i] = list.flags[i];
  }
  __syncthreads();
  update_entries(values, expiry, hits, rows, row_len, ent, ent + count,
                 ent + 2 * count, ent + 3 * count, count, now, floor, keys,
                 seg_sum, seg_fresh, seg_fresh + P);
}

// The staged design: the [4, count] entries and the P-sized scratch
// arrays in one device buffer.
__global__ void update_staged_kernel(int32_t* __restrict__ values,
                                     int32_t* __restrict__ expiry,
                                     int32_t* __restrict__ hits, int rows,
                                     int row_len, int count, int32_t now,
                                     const int32_t* __restrict__ floor,
                                     int32_t* __restrict__ stage) {
  const int P = next_pow2(count);
  const size_t n = (size_t)count;
  uint64_t* keys = reinterpret_cast<uint64_t*>(stage + 4 * ((n + 1) & ~1));
  auto* seg_sum = reinterpret_cast<unsigned long long*>(keys + P);
  int* seg_fresh = reinterpret_cast<int*>(seg_sum + P);
  update_entries(values, expiry, hits, rows, row_len, stage, stage + n,
                 stage + 2 * n, stage + 3 * n, count, now, floor, keys,
                 seg_sum, seg_fresh, seg_fresh + P);
}

// B4c's host form (credit_batch, ops/kernel.py:579-622): credit_kernel's
// body from a list of (cell, credit, interval, flags) entries of a single
// table, flags bit 1 bucket, one thread an entry, in the parameter block
// (credit_list_kernel) or, past one block, in the context's staging
// buffer (credit_staged_kernel). The list has no padding (no entry is the
// scratch cell), and global thread 0 zeroes the scratch cell's value and
// expiry, as credit_kernel does.
template <int N>
__global__ void credit_list_kernel(
    int32_t* __restrict__ values, int32_t* __restrict__ expiry, int count,
    int scratch, int32_t now, const __grid_constant__ UpdateList<N> list) {
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (first == 0) {
    values[scratch] = 0;
    expiry[scratch] = 0;
  }
  for (int i = first; i < count; i += gridDim.x * blockDim.x) {
    credit_cell(values, expiry, list.cell[i], list.delta[i], list.window[i],
                list.flags[i] & 2, now);
  }
}

__global__ void credit_staged_kernel(int32_t* __restrict__ values,
                                     int32_t* __restrict__ expiry, int count,
                                     int scratch, int32_t now,
                                     const int32_t* __restrict__ stage) {
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (first == 0) {
    values[scratch] = 0;
    expiry[scratch] = 0;
  }
  const size_t n = (size_t)count;
  for (int i = first; i < count; i += gridDim.x * blockDim.x) {
    credit_cell(values, expiry, stage[i], stage[n + i], stage[2 * n + i],
                stage[3 * n + i] & 2, now);
  }
}

// Bytes of update_entries' scratch arrays for a list of `count`.
size_t update_scratch_bytes(int count) {
  return (size_t)next_pow2(count) * 24;
}

// The list's entries as (cell, delta, window, flags) columns of `n`;
// false when a row or slot is out of range (slot L, the scratch cell,
// included: the host form has no padding).
bool pack_updates(const Ctx& c, const int32_t* entries, int count,
                  int32_t* cell, int32_t* delta, int32_t* window,
                  int32_t* flags) {
  for (int i = 0; i < count; ++i) {
    const int32_t* e = entries + 5 * (size_t)i;
    if (e[0] < 0 || e[0] >= c.rows || e[1] < 0 || e[1] >= c.row_len - 1) {
      return false;
    }
    cell[i] = e[0] * c.row_len + e[1];
    delta[i] = e[2];
    window[i] = e[3];
    flags[i] = e[4];
  }
  return true;
}

template <int N>
int launch_update_list(const Ctx& c, const int32_t* entries, int count,
                       int32_t now, const int32_t* floor) {
  UpdateList<N> list;
  if (!pack_updates(c, entries, count, list.cell, list.delta, list.window,
                    list.flags)) {
    return (int)cudaErrorInvalidValue;
  }
  const int warps = (count + 31) / 32;
  const int threads = warps < 32 ? 32 * warps : 1024;
  const size_t smem = update_scratch_bytes(count) + 16 * (size_t)count;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(update_list_kernel<N>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  update_list_kernel<N><<<1, threads, smem, c.stream>>>(
      c.values, c.expiry, c.hits, c.rows, c.row_len, count, now, floor,
      list);
  return (int)cudaGetLastError();
}

template <int N>
int launch_credit_list(const Ctx& c, const int32_t* entries, int count,
                       int32_t now) {
  UpdateList<N> list;
  if (!pack_updates(c, entries, count, list.cell, list.delta, list.window,
                    list.flags)) {
    return (int)cudaErrorInvalidValue;
  }
  credit_list_kernel<N><<<grid_for(count), 256, 0, c.stream>>>(
      c.values, c.expiry, count, c.row_len - 1, now, list);
  return (int)cudaGetLastError();
}

template <int N>
int launch_read_list(const Ctx& c, const int32_t* slots, int n,
                     int32_t now, int2* out) {
  SlotList<N> list;
  memcpy(list.slot, slots, sizeof(int32_t) * n);
  read_list_kernel<N><<<grid_for(n), 256, 0, c.stream>>>(
      c.values, c.expiry, n, now, out, list);
  return (int)cudaGetLastError();
}

template <int N>
int launch_remote_list(const Ctx& c, const int32_t* slots,
                       const int32_t* sums, const int32_t* expiries, int n) {
  SeedList<N> list;
  memcpy(list.slot, slots, sizeof(int32_t) * n);
  memcpy(list.value, sums, sizeof(int32_t) * n);
  memcpy(list.expiry, expiries, sizeof(int32_t) * n);
  remote_list_kernel<N><<<grid_for(n), 256, 0, c.stream>>>(
      c.values, c.expiry, n, list);
  return (int)cudaGetLastError();
}

template <int N>
int launch_clear_list(const Ctx& c, const int32_t* entries, int count,
                      int all_rows) {
  ClearList<N> list;
  if (count) {
    memcpy(list.e, entries, sizeof(int32_t) * (all_rows ? 1 : 2) * count);
  }
  const int total = all_rows ? count * c.rows : count;
  clear_list_kernel<N><<<grid_for(total), 256, 0, c.stream>>>(
      c.values, c.expiry, c.hits, count, all_rows, c.rows, c.row_len, list);
  return (int)cudaGetLastError();
}

template <int N>
int launch_seed_list(const Ctx& c, const int32_t* slots,
                     const int32_t* values, const int32_t* expiry, int n,
                     int padded) {
  SeedList<N> list;
  if (n) {
    memcpy(list.slot, slots, sizeof(int32_t) * n);
    memcpy(list.value, values, sizeof(int32_t) * n);
    memcpy(list.expiry, expiry, sizeof(int32_t) * n);
  }
  const int threads = n <= 32 ? 32 : (n < 256 ? (n + 31) / 32 * 32 : 256);
  seed_list_kernel<N><<<1, threads, 0, c.stream>>>(
      c.values, c.expiry, c.hits, n, c.row_len - 1, padded, list);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ct_check_workspace_bytes(int H) {
  return (int)workspace_bytes(H, kCheckArrays);
}

int ct_update_workspace_bytes(int H) {
  return (int)workspace_bytes(H, kUpdateArrays);
}

int ct_check_and_update(void* values, void* expiry, void* hits,
                        const void* slots, const void* deltas,
                        const void* maxes, const void* windows,
                        const void* req_ids, const void* fresh,
                        const void* bucket, int H, int scratch, int now_ms,
                        void* workspace, void* out_admitted, void* out_ok,
                        void* out_remaining, void* out_ttl, void* stream) {
  return launch_check<false>(values, expiry, hits, nullptr, nullptr, slots,
                             deltas, maxes, windows, req_ids, fresh, bucket,
                             H, scratch, now_ms, workspace, out_admitted,
                             out_ok, out_remaining, out_ttl, stream);
}

// B1 on a thread-block cluster (check_cluster_kernel), 1 <= H <=
// kClusterMaxHits (the wrapper routes 1024 <= H <= 16,384 here): the same
// arguments as ct_check_and_update but the workspace, which it does not
// need.
int ct_check_and_update_cluster(void* values, void* expiry, void* hits,
                                const void* slots, const void* deltas,
                                const void* maxes, const void* windows,
                                const void* req_ids, const void* fresh,
                                const void* bucket, int H, int scratch,
                                int now_ms, void* out_admitted, void* out_ok,
                                void* out_remaining, void* out_ttl,
                                void* stream) {
  return launch_check_cluster<false, false>(
      values, expiry, hits, slots, deltas, maxes, windows, req_ids, fresh,
      bucket, H, 1, scratch, scratch, H, now_ms, ClusterHooks{},
      out_admitted, out_ok, out_remaining, out_ttl, stream);
}

// B6a (_replicated_check, tpu/replicated.py:55-93): B1 over the merged
// admission base, the remote lanes int32[C+1] each, only read.
int ct_check_and_update_replicated(
    void* values, void* expiry, void* hits, const void* remote_vals,
    const void* remote_exp, const void* slots, const void* deltas,
    const void* maxes, const void* windows, const void* req_ids,
    const void* fresh, const void* bucket, int H, int scratch, int now_ms,
    void* workspace, void* out_admitted, void* out_ok, void* out_remaining,
    void* out_ttl, void* stream) {
  return launch_check<true>(values, expiry, hits, remote_vals, remote_exp,
                            slots, deltas, maxes, windows, req_ids, fresh,
                            bucket, H, scratch, now_ms, workspace,
                            out_admitted, out_ok, out_remaining, out_ttl,
                            stream);
}

// B6a on the thread-block cluster (check_cluster_kernel with its hooks),
// 1 <= H <= kClusterMaxHits (the wrapper routes as B1): the arguments of
// ct_check_and_update_replicated but the workspace, which it does not
// need.
int ct_check_and_update_replicated_cluster(
    void* values, void* expiry, void* hits, const void* remote_vals,
    const void* remote_exp, const void* slots, const void* deltas,
    const void* maxes, const void* windows, const void* req_ids,
    const void* fresh, const void* bucket, int H, int scratch, int now_ms,
    void* out_admitted, void* out_ok, void* out_remaining, void* out_ttl,
    void* stream) {
  ClusterHooks hk{};
  hk.remote_vals = (const int32_t*)remote_vals;
  hk.remote_exp = (const int32_t*)remote_exp;
  return launch_check_cluster<true, false>(
      values, expiry, hits, slots, deltas, maxes, windows, req_ids, fresh,
      bucket, H, 1, scratch, scratch, H, now_ms, hk, out_admitted, out_ok,
      out_remaining, out_ttl, stream);
}

int ct_update(void* values, void* expiry, void* hits, const void* slots,
              const void* deltas, const void* windows, const void* fresh,
              const void* bucket, int H, int scratch, int now_ms,
              void* workspace, void* stream) {
  return launch_update<false>(values, expiry, hits, nullptr, slots, deltas,
                              windows, fresh, bucket, H, scratch, now_ms,
                              workspace, stream);
}

// B6b (_replicated_update, tpu/replicated.py:96-117): B2 with the remote
// TAT floor on bucket lanes.
int ct_update_replicated(void* values, void* expiry, void* hits,
                         const void* remote_exp, const void* slots,
                         const void* deltas, const void* windows,
                         const void* fresh, const void* bucket, int H,
                         int scratch, int now_ms, void* workspace,
                         void* stream) {
  return launch_update<true>(values, expiry, hits, remote_exp, slots, deltas,
                             windows, fresh, bucket, H, scratch, now_ms,
                             workspace, stream);
}

int ct_apply_remote(void* remote_vals, void* remote_exp, const void* slots,
                    const void* sums, const void* expiries, int n,
                    void* stream) {
  apply_remote_kernel<<<grid_for(n), 256, 0, (cudaStream_t)stream>>>(
      (int32_t*)remote_vals, (int32_t*)remote_exp, (const int32_t*)slots,
      (const int32_t*)sums, (const int32_t*)expiries, n);
  return (int)cudaGetLastError();
}

int ct_read_slots(const void* values, const void* expiry, const void* slots,
                  int n, int now_ms, void* out_v, void* out_ttl,
                  void* stream) {
  read_slots_kernel<<<grid_for(n), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)values, (const int32_t*)expiry, (const int32_t*)slots,
      n, (int32_t)now_ms, (int32_t*)out_v, (int32_t*)out_ttl);
  return (int)cudaGetLastError();
}

int ct_clear_slots(void* values, void* expiry, void* hits, const void* slots,
                   int n, void* stream) {
  clear_slots_kernel<<<grid_for(n), 256, 0, (cudaStream_t)stream>>>(
      (int32_t*)values, (int32_t*)expiry, (int32_t*)hits,
      (const int32_t*)slots, n);
  return (int)cudaGetLastError();
}

const char* ct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int ct_rebase_expiry(void* expiry, int n, int step, void* stream) {
  rebase_expiry_kernel<<<grid_for(n), 256, 0, (cudaStream_t)stream>>>(
      (int32_t*)expiry, n, (int32_t)step);
  return (int)cudaGetLastError();
}

int ct_rebase_epoch(void* expiry, int n, const void* shift_ms,
                    void* stream) {
  rebase_epoch_kernel<<<grid_for(n), 256, 0, (cudaStream_t)stream>>>(
      (int32_t*)expiry, n, (const int32_t*)shift_ms);
  return (int)cudaGetLastError();
}
int ct_seed_slots(void* values, void* expiry, void* hits, const void* slots,
                  const void* seed_v, const void* seed_e, int H,
                  int scratch, void* stream) {
  seed_slots_kernel<<<grid_for(H), 256, 0, (cudaStream_t)stream>>>(
      (int32_t*)values, (int32_t*)expiry, (int32_t*)hits,
      (const int32_t*)slots, (const int32_t*)seed_v, (const int32_t*)seed_e,
      H, scratch);
  return (int)cudaGetLastError();
}
int ct_credit(void* values, void* expiry, const void* slots,
              const void* credits, const void* windows, const void* bucket,
              int H, int scratch, int now_ms, void* stream) {
  credit_kernel<<<grid_for(H), 256, 0, (cudaStream_t)stream>>>(
      (int32_t*)values, (int32_t*)expiry, (const int32_t*)slots,
      (const int32_t*)credits, (const int32_t*)windows,
      (const uint8_t*)bucket, H, scratch, (int32_t)now_ms);
  return (int)cudaGetLastError();
}

// B5 past the shared-memory path (k > 1024): every key sorted in the
// workspace, one launch a stage, the first k decoded.
static int topk_full_sort(int32_t* hits, int n, int k, uint64_t* ws,
                          int32_t* out_counts, int32_t* out_slots,
                          int stride, cudaStream_t st) {
  const int n_keys = n - 1;
  const long long P = topk_sort_len(n_keys);
  const int grid = 132 * 16;
  topk_keys_kernel<<<grid, 256, 0, st>>>(hits, n, n_keys, P, ws);
  int rc = (int)cudaGetLastError();
  for (long long kk = 2; kk <= P && rc == 0; kk <<= 1) {
    for (long long j = kk >> 1; j > 0 && rc == 0; j >>= 1) {
      topk_sort_step_kernel<<<grid, 256, 0, st>>>(ws, P, kk, j);
      rc = (int)cudaGetLastError();
    }
  }
  if (rc != 0) return rc;
  topk_emit_kernel<<<grid_for(k), 256, 0, st>>>(ws, k, out_counts, out_slots,
                                                 stride);
  return (int)cudaGetLastError();
}

// Blocks a row of a drain over `rows` rows of n cells at k: one per
// round of cells, except that past the round threshold's reach (K >
// kDrainGroupMaxK) the rows share one wave (132 / rows blocks a row),
// since each row's last block then merges up to G x K published keys
// in series. On the H100 at [8, 1<<17 + 1] (PERF.md §6), 16 blocks a
// row took 0.11-0.20 ms at k = 1024 where 32 took 0.17-0.29, and 32
// took 0.0215 ms at k = 64 on Zipf where 16 took 0.0235. B5's one row
// takes 132 either way.
static int drain_row_blocks(int rows, int n, int k) {
  const int wave = kDrainMaxBlocks / rows;
  return drain_blocks(n, next_pow2(k) > kDrainGroupMaxK
                             ? (wave > 1 ? wave : 1)
                             : 0);
}

// The workspace of a drain of `rows` rows of n cells at k, G blocks a
// row: drain_kernel's header, counts and lists, or for k > 1024 the
// header (left at 0) and the full sort's keys after it.
static long long drain_rows_workspace(int rows, int n, int k, int G) {
  if (k <= kTopkMaxSmall) return drain_workspace_bytes(rows, G, k);
  return (long long)drain_head_bytes(rows) + topk_sort_len(n - 1) * 8;
}

// The drain of `rows` rows of n cells, row r's answer i at
// out_counts[(r k + i) stride] and out_slots[(r k + i) stride]: for k <=
// 1024 one drain_kernel launch of G blocks a row (the workspace's header
// must be 0, and is left at 0), a larger k the full sort row after row.
static int drain_rows(int32_t* hits, int rows, int n, int k, int G,
                      char* ws, int32_t* out_counts, int32_t* out_slots,
                      int stride, cudaStream_t st) {
  if (k <= kTopkMaxSmall) {
    return launch_drain(hits, rows, n, G, k, ws, out_counts, out_slots,
                        stride, st);
  }
  uint64_t* keys = reinterpret_cast<uint64_t*>(ws + drain_head_bytes(rows));
  for (int r = 0; r < rows; ++r) {
    const size_t at = (size_t)r * k * stride;
    const int rc = topk_full_sort(hits + (size_t)r * n, n, k, keys,
                                  out_counts + at, out_slots + at, stride,
                                  st);
    if (rc != 0) return rc;
  }
  return 0;
}

// A drain into device tensors: the fresh workspace's header zeroed, then
// drain_rows.
static int drain_device(void* hits, int rows, int n, int k, int G,
                        void* workspace, void* out_counts, void* out_slots,
                        cudaStream_t st) {
  const cudaError_t rc =
      cudaMemsetAsync(workspace, 0, drain_head_bytes(rows), st);
  if (rc != cudaSuccess) return (int)rc;
  return drain_rows((int32_t*)hits, rows, n, k, G, (char*)workspace,
                    (int32_t*)out_counts, (int32_t*)out_slots, 1, st);
}

// B5 on a device column of n = C + 1 cells (drain_kernel once for k <=
// 1024) and its workspace.
long long ct_topk_workspace_bytes(int n, int k) {
  return drain_rows_workspace(1, n, k, drain_row_blocks(1, n, k));
}

int ct_drain_top_hits(void* hits, int n, int k, void* workspace,
                      void* out_counts, void* out_slots, void* stream) {
  return drain_device(hits, 1, n, k, drain_row_blocks(1, n, k), workspace,
                      out_counts, out_slots, (cudaStream_t)stream);
}

// B7a (_local_step + sharded_check_and_update, parallel/mesh.py:399-504),
// its rows route: B1 on each row of the int32[n, L+1] table, one block
// per row, in one launch (two with has_global: the live-partial sums
// first). The bool columns are uint8. admitted is uint8[n*H] when coupled
// and uint8[n, H] when lean; ok, remaining and ttl_ms are [n, H].
long long ct_sharded_check_workspace_bytes(int n, int H, int G) {
  return (long long)sharded_check_ws(n, H, G);
}

int ct_sharded_coupled_capacity(int H, int has_global) {
  return has_global ? coupled_capacity<true>(H) : coupled_capacity<false>(H);
}

int ct_sharded_check_and_update(
    void* values, void* expiry, void* hits, const void* slots,
    const void* deltas, const void* maxes, const void* windows,
    const void* req_ids, const void* fresh, const void* bucket,
    const void* is_global, int n, int H, int L, int now_ms, int G,
    int has_global, int coupled, void* workspace, void* out_admitted,
    void* out_ok, void* out_remaining, void* out_ttl, void* stream) {
  auto go = [&](auto launch) {
    return launch(values, expiry, hits, slots, deltas, maxes, windows,
                  req_ids, fresh, bucket, is_global, n, H, L, now_ms, G,
                  workspace, out_admitted, out_ok, out_remaining, out_ttl,
                  stream);
  };
  if (coupled) {
    return has_global ? go(launch_sharded_check<true, true>)
                      : go(launch_sharded_check<false, true>);
  }
  return has_global ? go(launch_sharded_check<true, false>)
                    : go(launch_sharded_check<false, false>);
}

// B7a on thread-block clusters over the flattened [n, H] columns (no
// workspace, no pre-pass, no grid barrier): coupled or global batches run
// one cluster over all n * H <= kClusterMaxHits hits, so the rows' votes
// meet in its shared memory and the global sums are read before any
// write; lean batches without a global hit run n clusters of H <=
// kClusterMaxHits hits, one a row. The arguments of
// ct_sharded_check_and_update but the workspace.
int ct_sharded_check_and_update_cluster(
    void* values, void* expiry, void* hits, const void* slots,
    const void* deltas, const void* maxes, const void* windows,
    const void* req_ids, const void* fresh, const void* bucket,
    const void* is_global, int n, int H, int L, int now_ms, int G,
    int has_global, int coupled, void* out_admitted, void* out_ok,
    void* out_remaining, void* out_ttl, void* stream) {
  if (n < 1 || H < 1 || L < 0 || (long long)n * (L + 1) > 0x7fffffffLL ||
      (long long)n * H > 0x7fffffffLL || (has_global && G < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool one = coupled || has_global;
  ClusterHooks hk{};
  hk.is_global = has_global ? (const uint8_t*)is_global : nullptr;
  hk.rows = n;
  hk.row_hits = H;
  hk.row_len = L + 1;
  hk.global_region = G;
  hk.lean = !coupled;
  return launch_check_cluster<false, true>(
      values, expiry, hits, slots, deltas, maxes, windows, req_ids, fresh,
      bucket, one ? n * H : H, one ? 1 : n, L, n * (L + 1) - 1,
      coupled ? n * H : H, now_ms, hk, out_admitted, out_ok, out_remaining,
      out_ttl, stream);
}

// B7c: B2 on each row, one block per row, one launch.
long long ct_sharded_update_workspace_bytes(int n, int H) {
  return (long long)n * workspace_bytes(H, kUpdateArrays);
}

int ct_sharded_update(void* values, void* expiry, void* hits,
                      const void* slots, const void* deltas,
                      const void* windows, const void* fresh,
                      const void* bucket, int n, int H, int L, int now_ms,
                      void* workspace, void* stream) {
  auto kernel = update_kernel<false, true>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemKeys * 8);
  kernel<<<n, kThreads, smem_for(H), (cudaStream_t)stream>>>(
      (int32_t*)values, (int32_t*)expiry, (int32_t*)hits, nullptr,
      (const int32_t*)slots, (const int32_t*)deltas,
      (const int32_t*)windows, (const uint8_t*)fresh, (const uint8_t*)bucket,
      H, L, (int32_t)now_ms, workspace, workspace_bytes(H, kUpdateArrays));
  return (int)cudaGetLastError();
}

// B7b over an int32[n, K] slot list.
int ct_sharded_clear(void* values, void* expiry, void* hits,
                     const void* slots, int n, int K, int L, void* stream) {
  const int entries = n * K;
  sharded_clear_kernel<<<grid_for(entries), 256, 0, (cudaStream_t)stream>>>(
      (int32_t*)values, (int32_t*)expiry, (int32_t*)hits,
      (const int32_t*)slots, entries, K, L + 1);
  return (int)cudaGetLastError();
}

// B7d: the top-k drain on each of the `rows` rows of n = L + 1 cells
// into int32[rows, k] counts and slots: for k <= 1024 one drain_kernel
// launch of `blocks` blocks a row (0: drain_row_blocks, the storages'
// rule; phase 3 of chip_smoke.py times 32 and 16), a larger k B5's full
// sort row after row. Its workspace at the same arguments:
long long ct_sharded_topk_workspace_bytes(int rows, int n, int k,
                                          int blocks) {
  return drain_rows_workspace(rows, n, k,
                              blocks > 0 ? drain_blocks(n, blocks)
                                         : drain_row_blocks(rows, n, k));
}

int ct_sharded_drain_top_hits(void* hits, int rows, int n, int k, int blocks,
                              void* workspace, void* out_counts,
                              void* out_slots, void* stream) {
  const int G = blocks > 0 ? drain_blocks(n, blocks)
                           : drain_row_blocks(rows, n, k);
  return drain_device(hits, rows, n, k, G, workspace, out_counts, out_slots,
                      (cudaStream_t)stream);
}

// The launch context of one table: int32 columns of rows x row_len cells
// on one card (rows = 1 for a single table of C + 1 cells), and the
// stream every host-list launch of this table goes on. Null when the
// columns are not device memory.
void* ct_ctx_create(void* values, void* expiry, void* hits, int rows,
                    int row_len, void* stream) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, values) != cudaSuccess ||
      attr.type != cudaMemoryTypeDevice) {
    cudaGetLastError();
    return nullptr;
  }
  return new (std::nothrow) Ctx{(int32_t*)values, (int32_t*)expiry,
                                (int32_t*)hits,   rows,
                                row_len,          attr.device,
                                (cudaStream_t)stream};
}

// Frees the context and its buffers, after the work still queued on its
// stream (a staged copy may still read the pinned rows).
void ct_ctx_destroy(void* ctx) {
  Ctx* c = (Ctx*)ctx;
  if (!c) return;
  if (c->result || c->stage || c->drain_ws || c->upd_stage) {
    DeviceGuard guard(c->device);
    cudaStreamSynchronize(c->stream);
    if (c->result) cudaFreeHost(c->result);
    if (c->stage) cudaFreeHost(c->stage);
    if (c->stage_dev) cudaFree(c->stage_dev);
    if (c->staged) cudaEventDestroy(c->staged);
    if (c->drain_ws) cudaFree(c->drain_ws);
    if (c->upd_stage) cudaFreeHost(c->upd_stage);
    if (c->upd_dev) cudaFree(c->upd_dev);
    if (c->upd_staged) cudaEventDestroy(c->upd_staged);
    cudaGetLastError();
  }
  delete c;
}

// Entries one launch carries: 0 all-rows slots, 1 (row, slot) pairs,
// 2 seed rows, 3 slots read (B3a), 4 remote-share rows (B6c), 5 slots
// cleared (B3b), 6 update and credit entries (B7c, B6b, B2, B4c).
int ct_host_list_capacity(int kind) {
  switch (kind) {
    case 0:
    case 3:
    case 5:
      return kListInts;
    case 1:
      return kListInts / 2;
    case 6:
      return kListInts / 4;
    default:
      return kListInts / 3;
  }
}

// The context's B3a answer buffer, grown to `cap` (value, ttl) pairs if it
// holds fewer: pinned host memory, mapped for the card. Returns its host
// address (null if the allocation failed). No read may be in flight: the
// reads wait for their kernels, so none is between two calls.
void* ct_ctx_results(void* ctx, int cap) {
  Ctx* c = (Ctx*)ctx;
  if (!c || cap <= 0) return nullptr;
  if (cap <= c->result_cap) return c->result;
  DeviceGuard guard(c->device);
  void* host = nullptr;
  void* dev = nullptr;
  if (cudaHostAlloc(&host, sizeof(int2) * (size_t)cap,
                    cudaHostAllocMapped | cudaHostAllocPortable) !=
      cudaSuccess) {
    cudaGetLastError();
    return nullptr;
  }
  if (cudaHostGetDevicePointer(&dev, host, 0) != cudaSuccess) {
    cudaGetLastError();
    cudaFreeHost(host);
    return nullptr;
  }
  if (c->result) cudaFreeHost(c->result);
  c->result = (int2*)host;
  c->result_dev = (int2*)dev;
  c->result_cap = cap;
  return host;
}

// B3a from a host list: the n slots' (value, ttl) pairs at now_ms land in
// the context's answer buffer (ct_ctx_results, at least n pairs), in
// chunks of one parameter block, in order. Then the call waits on the
// context's stream, so the answers follow every launch queued there
// before it, and the host may read them when it returns. ctypes releases
// the GIL for the wait.
int ct_read_slots_host(void* ctx, const int32_t* slots, int n, int now_ms) {
  Ctx* c = (Ctx*)ctx;
  if (!c || c->rows != 1 || n < 0 || n > c->result_cap) {
    return (int)cudaErrorInvalidValue;
  }
  DeviceGuard guard(c->device);
  for (int off = 0; off < n; off += kListInts) {
    const int m = n - off < kListInts ? n - off : kListInts;
    int2* out = c->result_dev + off;
    const int rc =
        m <= 64     ? launch_read_list<64>(*c, slots + off, m, now_ms, out)
        : m <= 1000 ? launch_read_list<1000>(*c, slots + off, m, now_ms, out)
                    : launch_read_list<kListInts>(*c, slots + off, m, now_ms,
                                                  out);
    if (rc != 0) return rc;
  }
  return (int)cudaStreamSynchronize(c->stream);
}

// B6c from host rows (unique slots, their sums and expiries) on a
// context bound to the remote lanes (values = remote_vals, expiry =
// remote_exp); chunks of one parameter block, in order.
int ct_apply_remote_host(void* ctx, const int32_t* slots, const int32_t* sums,
                         const int32_t* expiries, int n) {
  Ctx* c = (Ctx*)ctx;
  if (!c || c->rows != 1 || n < 0) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(c->device);
  constexpr int per = kListInts / 3;
  for (int off = 0; off < n; off += per) {
    const int m = n - off < per ? n - off : per;
    const int rc =
        m <= 8 ? launch_remote_list<8>(*c, slots + off, sums + off,
                                       expiries + off, m)
        : m <= 256
            ? launch_remote_list<256>(*c, slots + off, sums + off,
                                      expiries + off, m)
            : launch_remote_list<per>(*c, slots + off, sums + off,
                                      expiries + off, m);
    if (rc != 0) return rc;
  }
  return 0;
}

// B6c's second design, from the same rows: one copy of the packed [3, n]
// rows from the context's pinned staging buffer to its device buffer,
// then one apply_remote_kernel. The event recorded after the copy guards
// the staging buffer: the next call waits for it before writing there.
int ct_apply_remote_staged(void* ctx, const int32_t* slots,
                           const int32_t* sums, const int32_t* expiries,
                           int n) {
  Ctx* c = (Ctx*)ctx;
  if (!c || c->rows != 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  DeviceGuard guard(c->device);
  cudaError_t rc;
  if (c->staged && (rc = cudaEventSynchronize(c->staged)) != cudaSuccess) {
    return (int)rc;
  }
  if (n > c->stage_cap) {
    int cap = 1024;
    while (cap < n) cap <<= 1;
    if (c->stage_dev &&
        (rc = cudaStreamSynchronize(c->stream)) != cudaSuccess) {
      return (int)rc;  // the last kernel still reads stage_dev
    }
    if (c->stage) cudaFreeHost(c->stage);
    if (c->stage_dev) cudaFree(c->stage_dev);
    c->stage = nullptr;
    c->stage_dev = nullptr;
    c->stage_cap = 0;
    const size_t bytes = sizeof(int32_t) * 3 * (size_t)cap;
    if ((rc = cudaHostAlloc((void**)&c->stage, bytes,
                            cudaHostAllocPortable)) != cudaSuccess ||
        (rc = cudaMalloc((void**)&c->stage_dev, bytes)) != cudaSuccess ||
        (!c->staged && (rc = cudaEventCreateWithFlags(
                            &c->staged, cudaEventDisableTiming)) !=
                           cudaSuccess)) {
      return (int)rc;
    }
    c->stage_cap = cap;
  }
  memcpy(c->stage, slots, sizeof(int32_t) * n);
  memcpy(c->stage + n, sums, sizeof(int32_t) * n);
  memcpy(c->stage + 2 * (size_t)n, expiries, sizeof(int32_t) * n);
  if ((rc = cudaMemcpyAsync(c->stage_dev, c->stage,
                            sizeof(int32_t) * 3 * (size_t)n,
                            cudaMemcpyHostToDevice, c->stream)) !=
          cudaSuccess ||
      (rc = cudaEventRecord(c->staged, c->stream)) != cudaSuccess) {
    return (int)rc;
  }
  apply_remote_kernel<<<grid_for(n), 256, 0, c->stream>>>(
      c->values, c->expiry, c->stage_dev, c->stage_dev + n,
      c->stage_dev + 2 * (size_t)n, n);
  return (int)cudaGetLastError();
}

// B7b from a host list: `count` (row, slot) pairs, or with all_rows
// `count` slots cleared on every row; chunks of one parameter block.
int ct_sharded_clear_host(void* ctx, const int32_t* entries, int count,
                          int all_rows) {
  const Ctx& c = *(const Ctx*)ctx;
  DeviceGuard guard(c.device);
  const int width = all_rows ? 1 : 2;
  const int per = kListInts / width;
  for (int off = 0; off < count; off += per) {
    const int m = count - off < per ? count - off : per;
    const int32_t* src = entries + (size_t)off * width;
    const int ints = m * width;
    const int rc =
        ints <= 64     ? launch_clear_list<64>(c, src, m, all_rows)
        : ints <= 1000 ? launch_clear_list<1000>(c, src, m, all_rows)
                       : launch_clear_list<kListInts>(c, src, m, all_rows);
    if (rc != 0) return rc;
  }
  return 0;
}

// B3b from a host list: zero value, expiry and hits at the n slots of a
// single table (duplicates and the scratch slot write the same zeros),
// through clear_list_kernel's all-rows form on the one-row context: the
// writes of clear_slots_kernel; chunks of one parameter block.
int ct_clear_slots_host(void* ctx, const int32_t* slots, int n) {
  const Ctx* c = (const Ctx*)ctx;
  if (!c || c->rows != 1 || n < 0) return (int)cudaErrorInvalidValue;
  return ct_sharded_clear_host(ctx, slots, n, 1);
}

// B4d from host lists of n rows (unpadded; `padded` says the JAX call's
// bucket had padding rows); chunks of one parameter block. A single
// table only.
int ct_seed_slots_host(void* ctx, const int32_t* slots,
                       const int32_t* values, const int32_t* expiry, int n,
                       int padded) {
  const Ctx& c = *(const Ctx*)ctx;
  if (c.rows != 1) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(c.device);
  constexpr int per = kListInts / 3;
  int off = 0;
  do {
    const int m = n - off < per ? n - off : per;
    const int rc =
        m <= 8 ? launch_seed_list<8>(c, slots + off, values + off,
                                     expiry + off, m, padded)
        : m <= 256
            ? launch_seed_list<256>(c, slots + off, values + off,
                                    expiry + off, m, padded)
            : launch_seed_list<per>(c, slots + off, values + off,
                                    expiry + off, m, padded);
    if (rc != 0) return rc;
    off += per;
  } while (off < n);
  return 0;
}

// B5 and B7d from the context's columns: each row's k answers, (count,
// slot) pairs, land in its answer buffer (ct_ctx_results, at least rows
// x k pairs; row r's at pairs [r k, r k + k)), and the call waits on its
// stream, so the drain follows every launch queued there before it and
// the host may read the answers when it returns. The workspace is the
// context's, allocated at the first call (and grown for a larger k) with
// its header at 0, which every launch leaves at 0.
int ct_drain_top_hits_host(void* ctx, int k) {
  Ctx* c = (Ctx*)ctx;
  if (!c || k < 1 || k > c->row_len - 1 ||
      (long long)c->rows * k > c->result_cap) {
    return (int)cudaErrorInvalidValue;
  }
  DeviceGuard guard(c->device);
  const int n = c->row_len;
  const int G = drain_row_blocks(c->rows, n, k);
  const long long need = drain_rows_workspace(c->rows, n, k, G);
  cudaError_t rc;
  if (need > c->drain_ws_bytes) {
    if (c->drain_ws) cudaFree(c->drain_ws);  // no drain is in flight
    c->drain_ws = nullptr;
    c->drain_ws_bytes = 0;
    if ((rc = cudaMalloc(&c->drain_ws, (size_t)need)) != cudaSuccess ||
        (rc = cudaMemset(c->drain_ws, 0, drain_head_bytes(c->rows))) !=
            cudaSuccess) {
      return (int)rc;
    }
    c->drain_ws_bytes = need;
  }
  int32_t* out = reinterpret_cast<int32_t*>(c->result_dev);
  const int launched = drain_rows(c->hits, c->rows, n, k, G,
                                  (char*)c->drain_ws, out, out + 1, 2,
                                  c->stream);
  if (launched != 0) return launched;
  return (int)cudaStreamSynchronize(c->stream);
}

// Packs `count` entries (row, slot, delta, window, flags) into the
// context's pinned staging buffer as [4, count] columns and queues one
// copy of them to its device buffer (upd_dev, with update_entries'
// scratch arrays after the columns), both grown on demand. The event
// after the copy guards the pinned buffer: the next staging waits for it.
static int stage_updates(Ctx* c, const int32_t* entries, int count) {
  cudaError_t rc;
  if (c->upd_staged &&
      (rc = cudaEventSynchronize(c->upd_staged)) != cudaSuccess) {
    return (int)rc;
  }
  if (count > c->upd_cap) {
    int cap = 4096;
    while (cap < count) cap <<= 1;
    if (c->upd_dev &&
        (rc = cudaStreamSynchronize(c->stream)) != cudaSuccess) {
      return (int)rc;  // the last staged launch still reads upd_dev
    }
    if (c->upd_stage) cudaFreeHost(c->upd_stage);
    if (c->upd_dev) cudaFree(c->upd_dev);
    c->upd_stage = nullptr;
    c->upd_dev = nullptr;
    c->upd_cap = 0;
    if ((rc = cudaHostAlloc((void**)&c->upd_stage, 16 * (size_t)cap,
                            cudaHostAllocPortable)) != cudaSuccess ||
        (rc = cudaMalloc((void**)&c->upd_dev,
                         16 * (size_t)cap + update_scratch_bytes(cap))) !=
            cudaSuccess ||
        (!c->upd_staged && (rc = cudaEventCreateWithFlags(
                                &c->upd_staged, cudaEventDisableTiming)) !=
                               cudaSuccess)) {
      return (int)rc;
    }
    c->upd_cap = cap;
  }
  const size_t n = (size_t)count;
  int32_t* st = c->upd_stage;
  if (!pack_updates(*c, entries, count, st, st + n, st + 2 * n,
                    st + 3 * n)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((rc = cudaMemcpyAsync(c->upd_dev, st, 16 * n, cudaMemcpyHostToDevice,
                            c->stream)) != cudaSuccess ||
      (rc = cudaEventRecord(c->upd_staged, c->stream)) != cudaSuccess) {
    return (int)rc;
  }
  return 0;
}

// B7c, B6b and B2 from a host list: `count` entries (row, slot, delta,
// window, flags), int32 each, flags bit 0 fresh and bit 1 bucket; 0 <=
// row < rows and 0 <= slot < L (no padding, no scratch slot); `floor`
// null (B7c, B2) or B6b's remote expiry lane. One launch: up to
// ct_host_list_capacity(6) entries ride in the parameter block; a longer
// list goes through the context's staging buffer (stage_updates) and is
// run by one block there, so no cell's entries are ever split between
// launches (in two launches a fresh entry in the second would drop the
// first's delta, hits and bucket advance).
static int update_host(Ctx* c, const int32_t* entries, int count,
                       int now_ms, const int32_t* floor) {
  if (count == 0) return 0;
  DeviceGuard guard(c->device);
  constexpr int per = kListInts / 4;
  const int32_t now = (int32_t)now_ms;
  if (count <= 32) {
    return launch_update_list<32>(*c, entries, count, now, floor);
  }
  if (count <= 128) {
    return launch_update_list<128>(*c, entries, count, now, floor);
  }
  if (count <= per) {
    return launch_update_list<per>(*c, entries, count, now, floor);
  }
  const int rc = stage_updates(c, entries, count);
  if (rc != 0) return rc;
  update_staged_kernel<<<1, 1024, 0, c->stream>>>(
      c->values, c->expiry, c->hits, c->rows, c->row_len, count, now, floor,
      c->upd_dev);
  return (int)cudaGetLastError();
}

int ct_sharded_update_host(void* ctx, const int32_t* entries, int count,
                           int now_ms) {
  Ctx* c = (Ctx*)ctx;
  if (!c || count < 0) return (int)cudaErrorInvalidValue;
  return update_host(c, entries, count, now_ms, nullptr);
}

// B6b from a host list on a replicated node's single table (`ctx`, row 0
// in every entry), the remote TAT floor read from the expiry lane of its
// remote context (`remote_ctx`, as bound by the node: values =
// remote_vals, expiry = remote_exp). Both contexts must be one row of
// the same length on one card and stream, so that the launch follows
// the remote lanes' flushes queued there.
int ct_update_replicated_host(void* ctx, void* remote_ctx,
                              const int32_t* entries, int count,
                              int now_ms) {
  Ctx* c = (Ctx*)ctx;
  const Ctx* r = (const Ctx*)remote_ctx;
  if (!c || !r || count < 0 || c->rows != 1 || r->rows != 1 ||
      r->row_len != c->row_len || r->device != c->device ||
      r->stream != c->stream) {
    return (int)cudaErrorInvalidValue;
  }
  return update_host(c, entries, count, now_ms, r->expiry);
}

// B2 from a host list on a single table (`ctx` of one row, row 0 in
// every entry): update_host without a floor, which is B7c's body on that
// row. A sharded context is refused, so that no B7c list reaches it.
int ct_update_host(void* ctx, const int32_t* entries, int count,
                   int now_ms) {
  Ctx* c = (Ctx*)ctx;
  if (!c || count < 0 || c->rows != 1) return (int)cudaErrorInvalidValue;
  return update_host(c, entries, count, now_ms, nullptr);
}

// B4c from a host list on a single table: `count` entries (row 0, slot,
// credit, interval, flags bit 1 bucket), unique slots in [0, L) (the
// lease broker aggregates by slot). One launch on the context's stream:
// up to ct_host_list_capacity(6) entries in the parameter block
// (credit_list_kernel), a longer list through the staging buffer that
// B7c's and B6b's long lists take (credit_staged_kernel).
int ct_credit_host(void* ctx, const int32_t* entries, int count,
                   int now_ms) {
  Ctx* c = (Ctx*)ctx;
  if (!c || count < 0 || c->rows != 1) return (int)cudaErrorInvalidValue;
  if (count == 0) return 0;
  DeviceGuard guard(c->device);
  constexpr int per = kListInts / 4;
  const int32_t now = (int32_t)now_ms;
  if (count <= 32) return launch_credit_list<32>(*c, entries, count, now);
  if (count <= 128) return launch_credit_list<128>(*c, entries, count, now);
  if (count <= per) return launch_credit_list<per>(*c, entries, count, now);
  const int rc = stage_updates(c, entries, count);
  if (rc != 0) return rc;
  credit_staged_kernel<<<grid_for(count), 256, 0, c->stream>>>(
      c->values, c->expiry, count, c->row_len - 1, now, c->upd_dev);
  return (int)cudaGetLastError();
}

}  // extern "C"
