// Native host path for the rate limiter's PyTorch/CUDA port.
//
// The port's own copy of native/hostpath.cc (the JAX package's host lane),
// built by limitador_tpu_torch/native/build.py. The device kernels decide
// admissions in bulk; the Python host path around them — protobuf decode,
// descriptor interning, column building, slot lookup — tops out orders of
// magnitude lower. This module is the C++ equivalent of the reference's
// native serving plane (the reference is a Rust binary end to end): the
// per-request byte work lives here, Python orchestrates batches.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image):
//
//   - string interner: FNV-1a open-addressing table, string -> dense id,
//     with a reverse offset table (id -> bytes);
//   - RLS request parser: hand-rolled proto3 wire parser for
//     envoy.service.ratelimit.v3.RateLimitRequest (domain=1,
//     descriptors=2 { entries=1 { key=1, value=2 } }, hits_addend=3) —
//     a batch of serialized requests becomes token-id columns for the
//     tracked descriptor keys, exactly the layout the vectorized limit
//     compiler consumes;
//   - slot map: open-addressing hash of composite keys
//     (limit_index, token...) -> device slot, the steady-state fast path
//     of the host key space (misses fall back to Python, which allocates
//     and inserts).
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -pthread
// (limitador_tpu_torch/native/build.py), bound by
// limitador_tpu_torch/native/__init__.py. This copy holds the interner,
// parser, slot map, hot lane, lease and usage exports and the native
// telemetry plane (hp_tel_*), the pod ownership mirror and foreign-row
// split (hp_pod_*, hp_plan_stamp_owner, hp_plan_set_owner), the plan
// export (hp_plan_export) and the partition assist
// (hp_partition_positions).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Interner
// ---------------------------------------------------------------------------

struct Interner {
  // open addressing: slot -> id+1 (0 = empty)
  std::vector<uint32_t> table;
  std::vector<uint64_t> hashes;
  // id -> (offset, len) into arena
  std::vector<uint64_t> offsets;
  std::vector<uint32_t> lengths;
  std::string arena;
  uint64_t mask;

  explicit Interner(uint64_t cap_pow2) {
    uint64_t cap = 1;
    while (cap < cap_pow2) cap <<= 1;
    table.assign(cap, 0);
    hashes.assign(cap, 0);
    mask = cap - 1;
  }

  static uint64_t fnv1a(const char* s, uint32_t len) {
    uint64_t h = 1469598103934665603ULL;
    for (uint32_t i = 0; i < len; i++) {
      h ^= (uint8_t)s[i];
      h *= 1099511628211ULL;
    }
    return h;
  }

  void grow() {
    uint64_t new_cap = (mask + 1) << 1;
    std::vector<uint32_t> nt(new_cap, 0);
    std::vector<uint64_t> nh(new_cap, 0);
    uint64_t nmask = new_cap - 1;
    for (uint64_t i = 0; i <= mask; i++) {
      if (table[i]) {
        uint64_t j = hashes[i] & nmask;
        while (nt[j]) j = (j + 1) & nmask;
        nt[j] = table[i];
        nh[j] = hashes[i];
      }
    }
    table.swap(nt);
    hashes.swap(nh);
    mask = nmask;
  }

  int32_t intern(const char* s, uint32_t len) {
    if ((uint64_t)offsets.size() * 10 >= (mask + 1) * 7) grow();
    uint64_t h = fnv1a(s, len);
    uint64_t j = h & mask;
    while (table[j]) {
      if (hashes[j] == h) {
        uint32_t id = table[j] - 1;
        if (lengths[id] == len &&
            memcmp(arena.data() + offsets[id], s, len) == 0)
          return (int32_t)id;
      }
      j = (j + 1) & mask;
    }
    uint32_t id = (uint32_t)offsets.size();
    offsets.push_back(arena.size());
    lengths.push_back(len);
    arena.append(s, len);
    table[j] = id + 1;
    hashes[j] = h;
    return (int32_t)id;
  }

  // lookup without inserting; -2 when absent (never equals any real id)
  int32_t find(const char* s, uint32_t len) const {
    uint64_t h = fnv1a(s, len);
    uint64_t j = h & mask;
    while (table[j]) {
      if (hashes[j] == h) {
        uint32_t id = table[j] - 1;
        if (lengths[id] == len &&
            memcmp(arena.data() + offsets[id], s, len) == 0)
          return (int32_t)id;
      }
      j = (j + 1) & mask;
    }
    return -2;
  }
};

// ---------------------------------------------------------------------------
// Slot map: composite int32 keys (k tokens) -> slot
// ---------------------------------------------------------------------------

struct SlotMap {
  std::vector<int64_t> slots;   // -1 = empty
  std::vector<uint64_t> hashes;
  std::vector<uint64_t> key_off;  // offset into keys arena (in int32 units)
  std::vector<int32_t> keys;      // arena: [len, tok0, tok1, ...]
  uint64_t mask;
  uint64_t count = 0;

  explicit SlotMap(uint64_t cap_pow2) {
    uint64_t cap = 1;
    while (cap < cap_pow2) cap <<= 1;
    slots.assign(cap, -1);
    hashes.assign(cap, 0);
    key_off.assign(cap, 0);
    mask = cap - 1;
  }

  static uint64_t hash_key(const int32_t* key, int32_t k) {
    uint64_t h = 1469598103934665603ULL;
    for (int32_t i = 0; i < k; i++) {
      h ^= (uint32_t)key[i];
      h *= 1099511628211ULL;
    }
    return h ^ (uint64_t)k * 0x9e3779b97f4a7c15ULL;
  }

  bool equals(uint64_t j, const int32_t* key, int32_t k) const {
    const int32_t* stored = keys.data() + key_off[j];
    if (stored[0] != k) return false;
    return memcmp(stored + 1, key, k * sizeof(int32_t)) == 0;
  }

  void grow() {
    uint64_t new_cap = (mask + 1) << 1;
    std::vector<int64_t> ns(new_cap, -1);
    std::vector<uint64_t> nh(new_cap, 0), no(new_cap, 0);
    uint64_t nmask = new_cap - 1;
    for (uint64_t i = 0; i <= mask; i++) {
      if (slots[i] >= 0) {
        uint64_t j = hashes[i] & nmask;
        while (ns[j] >= 0) j = (j + 1) & nmask;
        ns[j] = slots[i];
        nh[j] = hashes[i];
        no[j] = key_off[i];
      }
    }
    slots.swap(ns);
    hashes.swap(nh);
    key_off.swap(no);
    mask = nmask;
  }

  int64_t lookup(const int32_t* key, int32_t k) const {
    uint64_t h = hash_key(key, k);
    uint64_t j = h & mask;
    while (slots[j] >= 0) {
      if (hashes[j] == h && equals(j, key, k)) return slots[j];
      j = (j + 1) & mask;
    }
    return -1;
  }

  void insert(const int32_t* key, int32_t k, int64_t slot) {
    if (count * 10 >= (mask + 1) * 7) grow();
    uint64_t h = hash_key(key, k);
    uint64_t j = h & mask;
    while (slots[j] >= 0) {
      if (hashes[j] == h && equals(j, key, k)) {
        slots[j] = slot;  // overwrite
        return;
      }
      j = (j + 1) & mask;
    }
    key_off[j] = keys.size();
    keys.push_back(k);
    keys.insert(keys.end(), key, key + k);
    slots[j] = slot;
    hashes[j] = h;
    count++;
  }

  // no tombstone-compaction needed for rate-limiter lifetimes: removals
  // only happen on limit deletion; mark by overwriting with -2 sentinel
  void remove(const int32_t* key, int32_t k) {
    uint64_t h = hash_key(key, k);
    uint64_t j = h & mask;
    while (slots[j] >= 0) {
      if (hashes[j] == h && equals(j, key, k)) {
        slots[j] = -1;
        // re-insert the rest of the cluster so probing stays correct
        uint64_t i = (j + 1) & mask;
        count--;
        while (slots[i] >= 0) {
          int64_t s = slots[i];
          uint64_t hh = hashes[i];
          uint64_t oo = key_off[i];
          slots[i] = -1;
          count--;
          uint64_t t = hh & mask;
          while (slots[t] >= 0) t = (t + 1) & mask;
          slots[t] = s;
          hashes[t] = hh;
          key_off[t] = oo;
          count++;
          i = (i + 1) & mask;
        }
        return;
      }
      j = (j + 1) & mask;
    }
  }
};

// ---------------------------------------------------------------------------
// proto3 wire parsing for RateLimitRequest
// ---------------------------------------------------------------------------

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= (uint64_t)(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  bool skip(uint32_t wire_type) {
    switch (wire_type) {
      case 0: varint(); return ok;
      case 1: if (end - p < 8) { ok = false; return false; } p += 8; return true;
      case 2: {
        uint64_t len = varint();
        if (!ok || (uint64_t)(end - p) < len) { ok = false; return false; }
        p += len;
        return true;
      }
      case 5: if (end - p < 4) { ok = false; return false; } p += 4; return true;
      default: ok = false; return false;
    }
  }
};

// ---------------------------------------------------------------------------
// Pod ownership mirror: the C side of routing.py's stable_hash, a
// zlib-identical CRC-32 (polynomial 0xEDB88320, init and xor-out
// 0xFFFFFFFF) over the Python repr bytes of a counter key, so that the
// hot lane classifies a repeat descriptor as locally owned or foreign
// with no Python. The repr bytes are made once per unique blob on the
// Python miss path; the owner verdict is stamped on the mirrored plan
// and every later begin reads it as one int compare.
// ---------------------------------------------------------------------------

const uint32_t* crc32_table() {
  static uint32_t table[256];
  static std::once_flag once;
  std::call_once(once, [] {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1u) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
  });
  return table;
}

uint32_t crc32_bytes(const uint8_t* p, int64_t n) {
  const uint32_t* t = crc32_table();
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; i++) c = t[(c ^ p[i]) & 0xFFu] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Parallel pool: a tiny persistent worker pool for the hot lane's
// GIL-free passes (ctypes releases the GIL around every call into this
// library, so these threads parallelize host staging for real).
// ---------------------------------------------------------------------------

struct ParallelPool {
  std::vector<std::thread> workers;
  std::mutex m;
  // Serializes whole run() invocations: the pool is process-global
  // while the Python-side native lock is per-pipeline INSTANCE, so two
  // pipelines' hot begins may reach here concurrently.
  std::mutex run_mu;
  std::condition_variable cv, cv_done;
  std::function<void(int, int)> job;  // (part index, n_parts)
  uint64_t gen = 0;
  int n_parts = 0;
  int remaining = 0;
  bool stop = false;

  explicit ParallelPool(int n) {
    for (int i = 0; i < n; i++)
      workers.emplace_back([this, i] { worker(i); });
  }

  void worker(int idx) {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(m);
    for (;;) {
      cv.wait(lk, [&] { return stop || gen != seen; });
      if (stop) return;
      seen = gen;
      if (idx < n_parts) {
        auto f = job;
        int parts = n_parts;
        lk.unlock();
        f(idx, parts);
        lk.lock();
      }
      if (--remaining == 0) cv_done.notify_all();
    }
  }

  // Blocks until every part ran; concurrent callers serialize on
  // run_mu (losing parallelism, never correctness).
  void run(int parts, std::function<void(int, int)> f) {
    std::lock_guard<std::mutex> run_lk(run_mu);
    std::unique_lock<std::mutex> lk(m);
    job = std::move(f);
    n_parts = parts;
    remaining = (int)workers.size();
    gen++;
    cv.notify_all();
    cv_done.wait(lk, [&] { return remaining == 0; });
  }
};

// Leaked on purpose: joining at process exit would deadlock atexit
// ordering; exit() never joins detached-by-leak workers.
ParallelPool* g_pool = nullptr;
std::mutex g_pool_mu;
// FOUND BY THE RACE HUNT: this was a plain int — written by
// hp_set_threads (Python config path) while lane_threads() read it
// inside concurrent begins, a genuine data race TSAN flagged in the
// first drive. Atomic now; relaxed is sufficient because the value is
// an independent sizing hint: a begin that reads the pre-update count
// just sizes one pass with the old thread budget.
std::atomic<int> g_threads{-1};  // -1 = derive from hardware on first use

int lane_threads() {
  int configured = g_threads.load(std::memory_order_relaxed);
  if (configured >= 0) return configured;
  // Asked once: hardware_concurrency() reads the CPU list from /sys on
  // every call, a syscall that the native telemetry plane timed at
  // microseconds to hundreds of microseconds in a container, inside
  // every hot begin's lookup pass (PERF.md).
  static const int hw_threads = [] {
    unsigned hw = std::thread::hardware_concurrency();
    int n = (int)(hw == 0 ? 1 : hw);
    return n > 4 ? 4 : n;
  }();
  return hw_threads;
}

ParallelPool* pool_for(int threads) {
  std::lock_guard<std::mutex> lk(g_pool_mu);
  if (g_pool == nullptr && threads > 1) g_pool = new ParallelPool(threads);
  return g_pool;
}

// ---------------------------------------------------------------------------
// Plan mirror: the C side of device/plan_cache.py's DecisionPlanCache.
//
// blob bytes -> decision plan, epoch-guarded exactly like the Python
// cache (an epoch mismatch at sync time clears wholesale; a put carrying
// a stale epoch is discarded). Slot invalidation is CONSERVATIVE: the
// reverse index keys (hash, arena ref) per pinned slot and kills
// whatever live plan those bytes currently resolve to — over-
// invalidation only costs a re-derive, never a stale answer. Size
// bounds (entry count, arenas) clear wholesale: the mirror is a cache
// of the Python cache, so losing it costs one miss lane pass per hot
// blob, nothing else.
// ---------------------------------------------------------------------------

enum LaneKind {
  LANE_MISS = 0,
  LANE_KERNEL = 1,
  LANE_OK = 2,
  LANE_UNKNOWN = 3,
  LANE_OVER = 4,
  LANE_ERROR = 5,
  // Pod: the plan's counters live on another host. The row is never
  // staged locally; the begin answers LANE_FOREIGN_BASE + owner so that
  // Python bulk-forwards it.
  LANE_FOREIGN = 6,
};

// out_kind of a foreign-owned row: BASE + owner host. int8 bounds the pod
// at BASE..127, so 120 hosts (the Python binding mirrors this).
constexpr int32_t LANE_FOREIGN_BASE = 8;

//: per staged hit: slot, max_value, window_ms, bucket flag, name token
constexpr int REC_STRIDE = 5;

// Entries hp_lane_stats writes (out[0 .. HP_LANE_STATS)): the one length
// of every lane-stats buffer, the binding's LANE_STATS and the race-hunt
// driver's alike (tests/test_torch_race_hunt.py holds all three to it).
constexpr int HP_LANE_STATS = 9;

struct PlanEntry {
  uint64_t hash = 0;
  uint64_t blob_off = 0;
  uint32_t blob_len = 0;
  int8_t state = 0;  // 0 empty, 1 live, 2 dead (tombstone)
  int32_t kind = 0;  // LANE_KERNEL / LANE_OK / LANE_UNKNOWN
  int32_t ns_token = -1;  // -1 = count no metrics
  int32_t delta = 1;
  int32_t delta_capped = 1;
  int32_t nhits = 0;
  uint64_t rec_off = 0;  // into recs, REC_STRIDE per hit
  // Pod ownership: the host that must decide this blob; -1 = locally
  // owned or not stamped (no pod).
  int32_t owner = -1;
  // Quota lease: admissions this plan may answer locally with
  // zero device work. The broker pre-debited the device counters for
  // the whole grant, so local consumption never outruns the table; the
  // id keys the Python-side ledger when unused tokens travel back
  // through the return ring (invalidation/clear) for credit.
  int64_t lease_tokens = 0;
  int64_t lease_id = -1;
  int32_t lease_size = 0;   // tokens of the current/last grant
  uint32_t hot_count = 0;   // kernel-lane rows since last candidate drain
  // Tenant usage observatory: admissions this plan answered
  // from a live lease since the last hp_usage_drain. Leased rows never
  // touch the device, so the kernel's per-slot hit accumulator misses
  // them — this is the native half the drain merges back in. Distinct
  // from hot_count on purpose: hot_count resets on lease-candidacy
  // drains with their own cadence.
  uint32_t use_leased = 0;
};

struct BlobRef {
  uint64_t hash;
  uint64_t off;
  uint32_t len;
};

struct LeaseReturn {
  int64_t id;
  int64_t tokens;
};

struct PlanMirror {
  std::vector<PlanEntry> table;
  std::string blob_arena;
  std::vector<int32_t> recs;
  uint64_t mask;
  uint64_t live = 0;
  uint64_t dead = 0;
  int64_t epoch = 0;
  std::unordered_map<int64_t, std::vector<BlobRef>> by_slot;
  uint64_t max_plans;
  uint64_t max_arena;
  // cumulative stats (polled into the native_lane_* metric families)
  uint64_t hits = 0, misses = 0, staged_hits = 0, insertions = 0,
           invalidations = 0, overflows = 0;
  // ---- pod ownership ------------------------------------------
  // hosts <= 1 disables the foreign split (a single host's lane is the
  // lane without a pod). Set by hp_pod_config under the pipeline's
  // native lock, like every other mirror mutation.
  int32_t pod_hosts = 0;
  int32_t pod_host_id = 0;
  int32_t pod_shards_per_host = 1;
  // rows the begin classified foreign-owned (cumulative)
  uint64_t foreign = 0;
  // ---- quota leasing ----------------------------------------
  // Disabled by default: with lease_enabled == 0 the begin pass is
  // byte-identical to the pre-lease lane (no consume, no candidates).
  int32_t lease_enabled = 0;
  int32_t lease_hot_threshold = 8;
  // Tokens stranded by invalidation/clear travel here; Python drains
  // and credits the device counters back (ids key the broker ledger).
  std::vector<LeaseReturn> lease_returns;
  // Hot plans whose demand crossed the threshold (or whose lease just
  // exhausted): the broker drains these and decides grants.
  std::vector<BlobRef> lease_candidates;
  std::vector<int64_t> lease_cand_counts;
  static constexpr size_t kMaxCandidates = 1024;
  // cumulative lease stats (hp_lease_stats)
  uint64_t leased = 0;             // admissions answered from a lease
  uint64_t lease_grants = 0;
  uint64_t lease_granted_tokens = 0;
  uint64_t lease_ring_tokens = 0;  // tokens pushed to the return ring
  uint64_t lease_active = 0;       // live entries with tokens > 0
  int64_t lease_outstanding = 0;   // sum of live tokens (the bound)

  explicit PlanMirror(uint64_t max_plans_ = 1 << 16)
      : max_plans(max_plans_), max_arena(64u << 20) {
    uint64_t cap = 1 << 12;
    table.assign(cap, PlanEntry{});
    mask = cap - 1;
  }

  void push_return(PlanEntry& e) {
    if (e.lease_tokens > 0) {
      lease_returns.push_back(LeaseReturn{e.lease_id, e.lease_tokens});
      lease_ring_tokens += (uint64_t)e.lease_tokens;
      lease_outstanding -= e.lease_tokens;
      lease_active--;
      e.lease_tokens = 0;
    }
    e.lease_id = -1;
  }

  void push_candidate(PlanEntry& e, int64_t count) {
    if (lease_candidates.size() < kMaxCandidates) {
      lease_candidates.push_back(BlobRef{e.hash, e.blob_off, e.blob_len});
      lease_cand_counts.push_back(count);
    } else {
      // Queue full: drop, but restart the demand count so the plan
      // re-queues after another threshold's worth of traffic — a
      // hot_count left past the threshold would never fire == again.
      e.hot_count = 0;
    }
  }

  void clear() {
    invalidations += live;
    // Leases die with their plans, but their tokens must not: the
    // return ring survives the wipe so the broker can credit them back
    // (reload/snapshot-restore never strands phantom quota).
    for (auto& e : table) {
      if (e.state == 1) push_return(e);
      e.state = 0;
    }
    blob_arena.clear();
    recs.clear();
    by_slot.clear();
    lease_candidates.clear();  // blob refs die with the arena
    lease_cand_counts.clear();
    live = dead = 0;
  }

  void sync_epoch(int64_t e) {
    if (e != epoch) {
      clear();
      epoch = e;
    }
  }

  int64_t find(const uint8_t* blob, uint32_t len, uint64_t h) const {
    uint64_t j = h & mask;
    while (table[j].state != 0) {
      const PlanEntry& e = table[j];
      if (e.state == 1 && e.hash == h && e.blob_len == len &&
          memcmp(blob_arena.data() + e.blob_off, blob, len) == 0)
        return (int64_t)j;
      j = (j + 1) & mask;
    }
    return -1;
  }

  void rehash(uint64_t new_cap) {
    std::vector<PlanEntry> nt(new_cap, PlanEntry{});
    uint64_t nmask = new_cap - 1;
    for (auto& e : table) {
      if (e.state != 1) continue;
      uint64_t j = e.hash & nmask;
      while (nt[j].state != 0) j = (j + 1) & nmask;
      nt[j] = e;
    }
    table.swap(nt);
    mask = nmask;
    dead = 0;
  }

  void put(const uint8_t* blob, uint32_t len, int32_t kind, int32_t ns_token,
           int32_t delta, int32_t delta_capped, const int32_t* rec,
           int32_t nhits) {
    if (live >= max_plans || blob_arena.size() + len > max_arena ||
        recs.size() * sizeof(int32_t) > max_arena)
      clear();  // coarse cap: the mirror is a cache of a cache
    uint64_t h = Interner::fnv1a((const char*)blob, len);
    if (find(blob, len, h) >= 0) return;  // identical derivation, keep
    if ((live + dead) * 10 >= (mask + 1) * 7)
      rehash(live * 10 >= (mask + 1) * 5 ? (mask + 1) << 1 : mask + 1);
    uint64_t j = h & mask;
    while (table[j].state == 1) j = (j + 1) & mask;
    if (table[j].state == 2) dead--;
    PlanEntry& e = table[j];
    e.hash = h;
    e.blob_off = blob_arena.size();
    e.blob_len = len;
    e.state = 1;
    e.kind = kind;
    e.ns_token = ns_token;
    e.delta = delta;
    e.delta_capped = delta_capped;
    e.nhits = nhits;
    e.rec_off = recs.size();
    // A new plan is unstamped: a reused tombstone must not carry the
    // owner of the plan that held the slot before.
    e.owner = -1;
    blob_arena.append((const char*)blob, len);
    recs.insert(recs.end(), rec, rec + (size_t)nhits * REC_STRIDE);
    live++;
    insertions++;
    for (int32_t i = 0; i < nhits; i++)
      by_slot[rec[(size_t)i * REC_STRIDE]].push_back(
          BlobRef{h, e.blob_off, len});
  }

  void invalidate_slot(int64_t slot) {
    auto it = by_slot.find(slot);
    if (it == by_slot.end()) return;
    for (const BlobRef& ref : it->second) {
      int64_t j = find((const uint8_t*)blob_arena.data() + ref.off,
                       ref.len, ref.hash);
      if (j >= 0) {
        push_return(table[j]);  // stranded lease tokens -> return ring
        table[j].state = 2;
        live--;
        dead++;
        invalidations++;
      }
    }
    by_slot.erase(it);
  }
};

struct Ctx {
  Interner interner{1 << 12};
  SlotMap slot_map{1 << 12};
  std::vector<std::string> tracked;  // column index -> descriptor key
  PlanMirror mirror;
  // hot-begin scratch (entry index per row), reused across calls
  std::vector<int64_t> scratch_ent;
};

int32_t pow2_bucket(int64_t n, int64_t floor_) {
  int64_t b = floor_;
  while (b < n) b <<= 1;
  return (int32_t)b;
}

// routing.PodTopology.owner_host over repr bytes: crc32 modulo the total
// shards, integer-divided into the owner's contiguous block.
int32_t pod_owner_of(const PlanMirror& m, const uint8_t* key_repr,
                     int32_t len) {
  if (m.pod_hosts <= 1) return m.pod_host_id;
  uint64_t total =
      (uint64_t)m.pod_hosts * (uint64_t)m.pod_shards_per_host;
  uint64_t h = (uint64_t)crc32_bytes(key_repr, len);
  return (int32_t)((h % total) / (uint64_t)m.pod_shards_per_host);
}

// ---------------------------------------------------------------------------
// Native telemetry plane: lock-free phase histograms and a slow-row
// exemplar ring for the zero-Python hot lane.
//
// The hot lane runs no Python per repeat row, so the flight recorder and
// the phase histograms of the Python side never see those rows. This
// plane measures the native phases from inside the library: two
// steady_clock reads per begin pass and relaxed fetch_adds into a
// thread-striped bank of log2-ns counters, wait-free, no locks, no
// Python. State is process-global (not per Ctx) on purpose: hp_hot_finish
// runs with a NULL ctx after an interner recycle, and a global plane
// survives recycles by construction. hp_tel_drain snapshots the
// cumulative totals into a caller buffer in one call; the Python side
// (observability/native_plane.py) converts them to increments.
//
// Exemplars: a begin whose per-row average exceeds the configured
// threshold records its phase split, the lead row's blob digest and its
// lease/plan state into a small mutex-guarded ring (slow events are off
// the hot path by definition), drained into the flight recorder.
// ---------------------------------------------------------------------------

constexpr int TEL_PHASES = 4;    // hot_lookup, hot_stage, lease_hit, hot_finish
constexpr int TEL_BUCKETS = 40;  // log2 ns: bucket b holds [2^b, 2^{b+1})
constexpr int TEL_BANKS = 8;     // thread-striped to keep fetch_adds local
constexpr int TEL_EX_STRIDE = 12;
constexpr int TEL_EX_CAP = 64;

enum TelPhase {
  TEL_HOT_LOOKUP = 0,  // hot-begin plan-mirror lookup pass
  TEL_HOT_STAGE = 1,   // staging passes (incl. pad and lease consume)
  TEL_LEASE_HIT = 2,   // begins that answered >= 1 row from a live lease
  TEL_HOT_FINISH = 3,  // device columns -> response codes + metrics
};

struct alignas(64) TelBank {
  std::atomic<uint64_t> count[TEL_PHASES];
  std::atomic<uint64_t> sum[TEL_PHASES];
  std::atomic<uint64_t> buckets[TEL_PHASES][TEL_BUCKETS];
};

struct Tel {
  std::atomic<int32_t> enabled{0};
  std::atomic<int64_t> slow_ns{0};       // per-row average threshold; 0 = off
  std::atomic<int64_t> trace_sample{0};  // 1-in-N begin sampling; 0 = off
  std::atomic<uint64_t> batch_seq{0};
  TelBank banks[TEL_BANKS];
  std::mutex ex_mu;
  int64_t ring[TEL_EX_CAP][TEL_EX_STRIDE];
  int ex_n = 0;     // live exemplars
  int ex_head = 0;  // next write (oldest overwritten when full)
};

Tel g_tel;

int tel_bank_id() {
  static std::atomic<int> next{0};
  // relaxed: bank assignment only needs per-thread spread mod N
  thread_local int id =
      next.fetch_add(1, std::memory_order_relaxed) & (TEL_BANKS - 1);
  return id;
}

inline int64_t tel_now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

inline void tel_observe(int phase, int64_t ns) {
  if (ns < 0) ns = 0;
  int b = 0;
  uint64_t v = (uint64_t)ns;
  while (v >>= 1) b++;  // floor(log2); 0 and 1 land in bucket 0
  if (b >= TEL_BUCKETS) b = TEL_BUCKETS - 1;
  TelBank& bank = g_tel.banks[tel_bank_id()];
  // relaxed: each counter is monotone on its own and nothing
  // synchronizes through them; a drain racing this call may see count
  // without sum/bucket (or the reverse), and the next drain sees all
  bank.count[phase].fetch_add(1, std::memory_order_relaxed);
  bank.sum[phase].fetch_add((uint64_t)ns, std::memory_order_relaxed);
  bank.buckets[phase][b].fetch_add(1, std::memory_order_relaxed);
}

void tel_push_exemplar(const int64_t* fields) {
  std::lock_guard<std::mutex> lk(g_tel.ex_mu);
  memcpy(g_tel.ring[g_tel.ex_head], fields,
         TEL_EX_STRIDE * sizeof(int64_t));
  g_tel.ex_head = (g_tel.ex_head + 1) % TEL_EX_CAP;
  if (g_tel.ex_n < TEL_EX_CAP) g_tel.ex_n++;
}

}  // namespace

extern "C" {

void* hp_new() { return new Ctx(); }
void hp_free(void* c) { delete (Ctx*)c; }

int32_t hp_track_key(void* c, const char* key, int32_t len) {
  Ctx* ctx = (Ctx*)c;
  ctx->tracked.emplace_back(key, (size_t)len);
  return (int32_t)ctx->tracked.size() - 1;
}

int32_t hp_intern(void* c, const char* s, int32_t len) {
  return ((Ctx*)c)->interner.intern(s, (uint32_t)len);
}

int32_t hp_find(void* c, const char* s, int32_t len) {
  return ((Ctx*)c)->interner.find(s, (uint32_t)len);
}

// id -> string; returns length, writes pointer into *out
int32_t hp_string(void* c, int32_t id, const char** out) {
  Interner& in = ((Ctx*)c)->interner;
  if (id < 0 || (size_t)id >= in.offsets.size()) return -1;
  *out = in.arena.data() + in.offsets[id];
  return (int32_t)in.lengths[id];
}

int64_t hp_interned_count(void* c) {
  return (int64_t)((Ctx*)c)->interner.offsets.size();
}

// Parse a batch of serialized RateLimitRequest blobs.
//   buf, sizes[n]: concatenated blobs
//   out_domain[n]: interned domain token (-1 on parse failure / empty)
//   out_hits[n]:   hits_addend with the 0 -> 1 default applied
//   out_cols[n_tracked * n] (row-major per tracked key): token id of
//       descriptors[0][key], or -1 when absent
//   out_ndesc[n]:  number of descriptor entries seen in descriptors[0]
//                  (callers route multi-descriptor requests to the exact
//                  Python path; entries beyond descriptors[0] are counted
//                  in out_extra_desc)
//   out_extra[n]:  count of descriptors beyond the first
// Returns number of successfully parsed requests.
int32_t hp_parse_batch(void* c, const uint8_t* buf, const int32_t* sizes,
                       int32_t n, int32_t* out_domain, int32_t* out_hits,
                       int32_t* out_cols, int32_t* out_ndesc,
                       int32_t* out_extra) {
  Ctx* ctx = (Ctx*)c;
  int32_t n_tracked = (int32_t)ctx->tracked.size();
  // tracked-key token ids (intern once per call; table is stable)
  std::vector<int32_t> tracked_ids(n_tracked);
  for (int32_t t = 0; t < n_tracked; t++)
    tracked_ids[t] = ctx->interner.intern(ctx->tracked[t].data(),
                                          (uint32_t)ctx->tracked[t].size());

  const uint8_t* p = buf;
  int32_t parsed = 0;
  for (int32_t r = 0; r < n; r++) {
    Cursor cur{p, p + sizes[r]};
    p += sizes[r];
    out_domain[r] = -1;
    out_hits[r] = 1;
    out_ndesc[r] = 0;
    out_extra[r] = 0;
    for (int32_t t = 0; t < n_tracked; t++)
      out_cols[(int64_t)t * n + r] = -1;

    int desc_seen = 0;
    while (cur.ok && cur.p < cur.end) {
      uint64_t tag = cur.varint();
      if (!cur.ok) break;
      uint32_t field = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
      if (field == 1 && wt == 2) {  // domain
        uint64_t len = cur.varint();
        if (!cur.ok || (uint64_t)(cur.end - cur.p) < len) { cur.ok = false; break; }
        if (len > 0)
          out_domain[r] = ctx->interner.intern((const char*)cur.p, (uint32_t)len);
        cur.p += len;
      } else if (field == 3 && wt == 0) {  // hits_addend
        uint64_t v = cur.varint();
        out_hits[r] = v == 0 ? 1 : (int32_t)(v > 0x3fffffff ? 0x3fffffff : v);
      } else if (field == 2 && wt == 2) {  // descriptor
        uint64_t dlen = cur.varint();
        if (!cur.ok || (uint64_t)(cur.end - cur.p) < dlen) { cur.ok = false; break; }
        if (desc_seen++ > 0) {
          out_extra[r]++;
          cur.p += dlen;
          continue;
        }
        Cursor dc{cur.p, cur.p + dlen};
        cur.p += dlen;
        while (dc.ok && dc.p < dc.end) {
          uint64_t dtag = dc.varint();
          if (!dc.ok) break;
          uint32_t dfield = (uint32_t)(dtag >> 3), dwt = (uint32_t)(dtag & 7);
          if (dfield == 1 && dwt == 2) {  // entry
            uint64_t elen = dc.varint();
            if (!dc.ok || (uint64_t)(dc.end - dc.p) < elen) { dc.ok = false; break; }
            Cursor ec{dc.p, dc.p + elen};
            dc.p += elen;
            const char* key = nullptr; uint32_t key_len = 0;
            const char* val = nullptr; uint32_t val_len = 0;
            while (ec.ok && ec.p < ec.end) {
              uint64_t etag = ec.varint();
              if (!ec.ok) break;
              uint32_t ef = (uint32_t)(etag >> 3), ew = (uint32_t)(etag & 7);
              if ((ef == 1 || ef == 2) && ew == 2) {
                uint64_t slen = ec.varint();
                if (!ec.ok || (uint64_t)(ec.end - ec.p) < slen) { ec.ok = false; break; }
                if (ef == 1) { key = (const char*)ec.p; key_len = (uint32_t)slen; }
                else { val = (const char*)ec.p; val_len = (uint32_t)slen; }
                ec.p += slen;
              } else if (!ec.skip(ew)) break;
            }
            if (key) {
              out_ndesc[r]++;
              for (int32_t t = 0; t < n_tracked; t++) {
                const std::string& tk = ctx->tracked[t];
                if (tk.size() == key_len &&
                    memcmp(tk.data(), key, key_len) == 0) {
                  // proto3 omits empty strings on the wire: a present key
                  // with no value bytes means value "", matching the
                  // Python paths (never MISSING).
                  out_cols[(int64_t)t * n + r] =
                      val ? ctx->interner.intern(val, val_len)
                          : ctx->interner.intern("", 0);
                }
              }
            }
          } else if (!dc.skip(dwt)) break;
        }
      } else if (!cur.skip(wt)) {
        break;
      }
    }
    if (cur.ok) parsed++;
    else out_domain[r] = -1;
  }
  return parsed;
}

// ---- slot map -------------------------------------------------------------

// keys: n rows of k int32 tokens; out[n]: slot or -1
void hp_slots_lookup(void* c, const int32_t* keys, int32_t n, int32_t k,
                     int64_t* out) {
  Ctx* ctx = (Ctx*)c;
  for (int32_t i = 0; i < n; i++)
    out[i] = ctx->slot_map.lookup(keys + (int64_t)i * k, k);
}

void hp_slots_insert(void* c, const int32_t* key, int32_t k, int64_t slot) {
  ((Ctx*)c)->slot_map.insert(key, k, slot);
}

void hp_slots_remove(void* c, const int32_t* key, int32_t k) {
  ((Ctx*)c)->slot_map.remove(key, k);
}

int64_t hp_slots_count(void* c) {
  return (int64_t)((Ctx*)c)->slot_map.count;
}

// ---- hot lane -------------------------------------------------------------
// The zero-Python serving lane: plan-mirror lookup, columnar staging into
// the caller's pre-allocated upload buffers, and response-code build from
// the device result columns. Calls are GIL-free (ctypes) and the begin
// passes parallelize across the worker pool for large batches.

// relaxed: sizing hint only — no data is published through it (see
// the g_threads declaration; promoted from a plain int by the hunt)
void hp_set_threads(int32_t n) {
  g_threads.store(n < 0 ? -1 : n, std::memory_order_relaxed);
}

void hp_plan_epoch(void* c, int64_t epoch) {
  ((Ctx*)c)->mirror.sync_epoch(epoch);
}

// Insert one plan; discarded when ``epoch`` no longer matches the
// mirror's (the caller snapshotted it before deriving — same stale-put
// contract as DecisionPlanCache.put). ``rec`` is REC_STRIDE int32 per
// hit: slot, max_value, window_ms, bucket flag, limit-name token.
void hp_plan_put(void* c, const uint8_t* blob, int32_t len, int64_t epoch,
                 int32_t kind, int32_t ns_token, int32_t delta,
                 int32_t delta_capped, const int32_t* rec, int32_t nhits) {
  PlanMirror& m = ((Ctx*)c)->mirror;
  if (epoch != m.epoch) return;
  m.put(blob, (uint32_t)len, kind, ns_token, delta, delta_capped, rec,
        nhits);
}

void hp_plan_invalidate_slot(void* c, int64_t slot) {
  ((Ctx*)c)->mirror.invalidate_slot(slot);
}

int64_t hp_plan_count(void* c) {
  return (int64_t)((Ctx*)c)->mirror.live;
}

// ---- plan export ---------------------------------------------------------
// Serialize every live mirror entry. Two calls: the first (cap 0) returns
// the byte size the snapshot needs; the entries are written only when
// ``cap`` covers it. Layout: i64 count, then per entry: i32 blob_len, the
// blob bytes, i32 kind, i32 ns_token, i32 delta, i32 delta_capped,
// i32 owner, i32 nhits, nhits * REC_STRIDE i32 records. Tokens (ns_token,
// the records' name column) are this process's interner values: the
// Python side maps them back to strings before anything leaves the
// process.
int64_t hp_plan_export(void* c, uint8_t* buf, int64_t cap) {
  PlanMirror& m = ((Ctx*)c)->mirror;
  int64_t need = (int64_t)sizeof(int64_t);
  for (const PlanEntry& e : m.table) {
    if (e.state != 1) continue;
    need += (int64_t)(7 * sizeof(int32_t)) + (int64_t)e.blob_len +
            (int64_t)e.nhits * REC_STRIDE * (int64_t)sizeof(int32_t);
  }
  if (buf == nullptr || cap < need) return need;
  uint8_t* p = buf;
  int64_t count = (int64_t)m.live;
  memcpy(p, &count, sizeof(count));
  p += sizeof(count);
  auto put_i32 = [&p](int32_t v) {
    memcpy(p, &v, sizeof(v));
    p += sizeof(v);
  };
  for (const PlanEntry& e : m.table) {
    if (e.state != 1) continue;
    put_i32((int32_t)e.blob_len);
    memcpy(p, m.blob_arena.data() + e.blob_off, e.blob_len);
    p += e.blob_len;
    put_i32(e.kind);
    put_i32(e.ns_token);
    put_i32(e.delta);
    put_i32(e.delta_capped);
    put_i32(e.owner);
    put_i32(e.nhits);
    if (e.nhits > 0) {
      size_t n = (size_t)e.nhits * REC_STRIDE * sizeof(int32_t);
      memcpy(p, m.recs.data() + e.rec_off, n);
      p += n;
    }
  }
  return need;
}

// out[HP_LANE_STATS]: hits, misses, staged_hits, insertions,
// invalidations, overflows, live plans, epoch, foreign rows
void hp_lane_stats(void* c, int64_t* out) {
  PlanMirror& m = ((Ctx*)c)->mirror;
  out[0] = (int64_t)m.hits;
  out[1] = (int64_t)m.misses;
  out[2] = (int64_t)m.staged_hits;
  out[3] = (int64_t)m.insertions;
  out[4] = (int64_t)m.invalidations;
  out[5] = (int64_t)m.overflows;
  out[6] = (int64_t)m.live;
  out[7] = m.epoch;
  out[8] = (int64_t)m.foreign;
}

// ---- pod ownership ----------------------------------------------------------
// The C mirror of routing.py's crc32 ownership verdict. hp_pod_hash needs
// no context (its parity with zlib.crc32 is tested); hp_pod_config arms
// the foreign split on a mirror; the two stamp exports attach the deciding
// host to a mirrored plan: one resolves the owner here from the counter
// key's repr bytes (a single-key plan), one takes the owner the router
// resolved (pinned namespaces, key sets that span hosts). Every
// mirror-mutating call runs under the pipeline's native lock, like
// plan_put.

int64_t hp_pod_hash(const uint8_t* data, int32_t len) {
  return (int64_t)crc32_bytes(data, len);
}

int32_t hp_pod_config(void* c, int32_t hosts, int32_t host_id,
                      int32_t shards_per_host) {
  // The foreign verdict rides an int8 lane code (LANE_FOREIGN_BASE +
  // owner), so the largest owner it encodes is 127 - LANE_FOREIGN_BASE:
  // a bigger pod would wrap the code negative. Refuse to arm (-1); the
  // caller serves the routed compiled pipeline.
  if (hosts - 1 > 127 - LANE_FOREIGN_BASE) return -1;
  PlanMirror& m = ((Ctx*)c)->mirror;
  m.pod_hosts = hosts;
  m.pod_host_id = host_id;
  m.pod_shards_per_host = shards_per_host < 1 ? 1 : shards_per_host;
  return 0;
}

// Owner host of one counter key's repr bytes under the armed topology
// (== routing.PodTopology.owner_host).
int32_t hp_pod_owner(void* c, const uint8_t* key_repr, int32_t len) {
  return pod_owner_of(((Ctx*)c)->mirror, key_repr, len);
}

// Stamp a mirrored plan with the owner of its single counter key, hashed
// here: the C side is the authority for the per-key verdict. Returns the
// stamped owner, or -1 when the plan is gone or the epoch moved (the
// caller derived against dead limits; the next miss stamps again).
int32_t hp_plan_stamp_owner(void* c, const uint8_t* blob, int32_t len,
                            int64_t epoch, const uint8_t* key_repr,
                            int32_t repr_len) {
  PlanMirror& m = ((Ctx*)c)->mirror;
  if (epoch != m.epoch) return -1;
  uint64_t h = Interner::fnv1a((const char*)blob, len);
  int64_t j = m.find(blob, (uint32_t)len, h);
  if (j < 0) return -1;
  int32_t owner = pod_owner_of(m, key_repr, repr_len);
  m.table[j].owner = owner;
  return owner;
}

// Stamp an owner the router resolved (a pinned namespace, a key set);
// owner < 0 clears the stamp (locally owned). Returns 1 on success.
int32_t hp_plan_set_owner(void* c, const uint8_t* blob, int32_t len,
                          int64_t epoch, int32_t owner) {
  PlanMirror& m = ((Ctx*)c)->mirror;
  if (epoch != m.epoch) return 0;
  uint64_t h = Interner::fnv1a((const char*)blob, len);
  int64_t j = m.find(blob, (uint32_t)len, h);
  if (j < 0) return 0;
  m.table[j].owner = owner < 0 ? -1 : owner;
  return 1;
}

// ---- quota leasing ----------------------------------------------
// The C half of the lease tier: per-plan token balances consumed GIL-free
// inside hp_hot_begin (a leased row answers LANE_OK with zero staging and
// zero device work), a candidate queue feeding the Python LeaseBroker's
// grant pass, and a return ring carrying tokens stranded by plan
// invalidation back to the broker for device credit. All calls run under
// the pipeline's native lock, like the begins that mutate the same state.

void hp_lease_config(void* c, int32_t enabled, int32_t hot_threshold) {
  PlanMirror& m = ((Ctx*)c)->mirror;
  m.lease_enabled = enabled;
  if (hot_threshold > 0) m.lease_hot_threshold = hot_threshold;
}

// Attach a pre-debited grant to a live kernel plan. Refused (0) when the
// plan is gone, the epoch moved (the broker derived the grant from dead
// limits), the plan already holds tokens, or leasing is off — the caller
// must then credit the debit straight back.
int32_t hp_lease_grant(void* c, const uint8_t* blob, int32_t len,
                       int64_t epoch, int64_t lease_id, int64_t tokens) {
  PlanMirror& m = ((Ctx*)c)->mirror;
  if (!m.lease_enabled || tokens <= 0 || epoch != m.epoch) return 0;
  uint64_t h = Interner::fnv1a((const char*)blob, len);
  int64_t j = m.find(blob, (uint32_t)len, h);
  if (j < 0) return 0;
  PlanEntry& e = m.table[j];
  if (e.kind != LANE_KERNEL || e.lease_tokens > 0) return 0;
  e.lease_tokens = tokens;
  e.lease_id = lease_id;
  e.lease_size = (int32_t)(tokens > 0x7fffffff ? 0x7fffffff : tokens);
  e.hot_count = 0;
  m.lease_active++;
  m.lease_outstanding += tokens;
  m.lease_grants++;
  m.lease_granted_tokens += (uint64_t)tokens;
  return 1;
}

// Reclaim a lease synchronously (expiry sweep): returns the remaining
// tokens cleared from the plan, or -1 when there is nothing to reclaim
// (plan gone, tokens already travelled through the return ring, or —
// when expect_id >= 0 — the plan's live lease is a NEWER grant than the
// one being reclaimed: an expired ledger entry must never revoke its
// blob's renewal).
int64_t hp_lease_revoke(void* c, const uint8_t* blob, int32_t len,
                        int64_t expect_id) {
  PlanMirror& m = ((Ctx*)c)->mirror;
  uint64_t h = Interner::fnv1a((const char*)blob, len);
  int64_t j = m.find(blob, (uint32_t)len, h);
  if (j < 0) return -1;
  PlanEntry& e = m.table[j];
  if (e.lease_tokens <= 0) return -1;
  if (expect_id >= 0 && e.lease_id != expect_id) return -1;
  int64_t remaining = e.lease_tokens;
  m.lease_outstanding -= remaining;
  m.lease_active--;
  e.lease_tokens = 0;
  e.lease_id = -1;
  return remaining;
}

// Live token balance of one plan (tests/debug + the oracle bound);
// -1 when no live lease (or, with expect_id >= 0, a different grant).
int64_t hp_lease_tokens(void* c, const uint8_t* blob, int32_t len,
                        int64_t expect_id) {
  PlanMirror& m = ((Ctx*)c)->mirror;
  uint64_t h = Interner::fnv1a((const char*)blob, len);
  int64_t j = m.find(blob, (uint32_t)len, h);
  if (j < 0) return -1;
  const PlanEntry& e = m.table[j];
  if (expect_id >= 0 && e.lease_id != expect_id) return -1;
  return e.lease_tokens;
}

// Drain the return ring: (lease_id, stranded tokens) pairs pushed by
// invalidation/clear. Returns the number drained (ring keeps the rest
// when cap is short).
int32_t hp_lease_drain_returns(void* c, int64_t* out_ids,
                               int64_t* out_tokens, int32_t cap) {
  PlanMirror& m = ((Ctx*)c)->mirror;
  int32_t n = (int32_t)m.lease_returns.size();
  if (n > cap) n = cap;
  for (int32_t i = 0; i < n; i++) {
    out_ids[i] = m.lease_returns[i].id;
    out_tokens[i] = m.lease_returns[i].tokens;
  }
  m.lease_returns.erase(m.lease_returns.begin(),
                        m.lease_returns.begin() + n);
  return n;
}

// Drain the candidate queue: hot kernel plans whose demand crossed the
// threshold (or whose lease just exhausted). Blob bytes land
// concatenated in out_blobs with per-candidate lengths/demand counts;
// dead or since-granted plans are skipped; drained plans restart their
// demand count. The queue clears wholesale — a dropped candidate
// re-queues within one threshold's worth of traffic.
int32_t hp_lease_candidates(void* c, uint8_t* out_blobs, int64_t blob_cap,
                            int32_t* out_lens, int64_t* out_counts,
                            int32_t cap) {
  PlanMirror& m = ((Ctx*)c)->mirror;
  int32_t n = 0;
  int64_t used = 0;
  for (size_t i = 0; i < m.lease_candidates.size(); i++) {
    const BlobRef& ref = m.lease_candidates[i];
    int64_t j = m.find((const uint8_t*)m.blob_arena.data() + ref.off,
                       ref.len, ref.hash);
    if (j < 0) continue;
    PlanEntry& e = m.table[j];
    // Demand kept accruing between the threshold crossing and this
    // drain: report the larger figure so grants track real traffic.
    int64_t demand = m.lease_cand_counts[i] > (int64_t)e.hot_count
                         ? m.lease_cand_counts[i]
                         : (int64_t)e.hot_count;
    // Every candidate leaving the queue restarts its demand count,
    // DRAINED OR DROPPED — a hot_count parked past the threshold would
    // never fire the == crossing again, permanently starving exactly
    // the high-fanout hot plans the tier targets.
    e.hot_count = 0;
    if (e.kind != LANE_KERNEL || e.lease_tokens > 0) continue;
    if (n >= cap || used + ref.len > blob_cap) continue;  // drop + reset
    memcpy(out_blobs + used, m.blob_arena.data() + e.blob_off, ref.len);
    out_lens[n] = (int32_t)ref.len;
    out_counts[n] = demand;
    used += ref.len;
    n++;
  }
  m.lease_candidates.clear();
  m.lease_cand_counts.clear();
  return n;
}

// out[8]: leased admissions, grants, granted tokens, ring tokens,
// active leases, outstanding tokens (the over-admission bound),
// pending candidates, pending returns
void hp_lease_stats(void* c, int64_t* out) {
  PlanMirror& m = ((Ctx*)c)->mirror;
  out[0] = (int64_t)m.leased;
  out[1] = (int64_t)m.lease_grants;
  out[2] = (int64_t)m.lease_granted_tokens;
  out[3] = (int64_t)m.lease_ring_tokens;
  out[4] = (int64_t)m.lease_active;
  out[5] = m.lease_outstanding;
  out[6] = (int64_t)m.lease_candidates.size();
  out[7] = (int64_t)m.lease_returns.size();
}

// ---- tenant usage observatory -----------------------------------
// Drain per-plan LEASED admission counts accumulated since the last
// call: leased rows answer with zero device work, so the kernel's
// per-slot hit accumulator never sees them — the Python observatory
// resolves each blob back to its plan's device slots and merges these
// counts into the heavy-hitter table. Blob bytes land concatenated in
// out_blobs with per-plan lengths/counts; drained plans reset their
// count. A plan that doesn't fit the caller's buffers KEEPS its count
// for the next drain (conservation beats completeness here). Runs under
// the pipeline's native lock, like every other mirror walk.
int32_t hp_usage_drain(void* c, uint8_t* out_blobs, int64_t blob_cap,
                       int32_t* out_lens, int64_t* out_counts,
                       int32_t cap) {
  PlanMirror& m = ((Ctx*)c)->mirror;
  int32_t n = 0;
  int64_t used = 0;
  for (auto& e : m.table) {
    if (e.state != 1 || e.use_leased == 0) continue;
    if (n >= cap || used + e.blob_len > blob_cap) continue;  // keep count
    memcpy(out_blobs + used, m.blob_arena.data() + e.blob_off, e.blob_len);
    out_lens[n] = (int32_t)e.blob_len;
    out_counts[n] = (int64_t)e.use_leased;
    e.use_leased = 0;
    used += e.blob_len;
    n++;
  }
  return n;
}

// ---- native telemetry plane ----------------------------------------------
// Process-global (see Tel above): every context's begins and every
// finish, the NULL-ctx finishes that outlive an interner recycle
// included, land in one set of counters.

// enabled gates the histogram observes; slow_row_ns > 0 also records
// exemplars for begins whose per-row average exceeds it; trace_sample N
// stamps every Nth begin's out_meta with a trace id (0 = off).
void hp_tel_config(int32_t enabled, int64_t slow_row_ns,
                   int64_t trace_sample) {
  // relaxed: three independent flags; a begin that sees a mix of old
  // and new behaves like either config
  g_tel.enabled.store(enabled, std::memory_order_relaxed);
  g_tel.slow_ns.store(slow_row_ns < 0 ? 0 : slow_row_ns,
                      std::memory_order_relaxed);
  g_tel.trace_sample.store(trace_sample < 0 ? 0 : trace_sample,
                           std::memory_order_relaxed);
}

// 1 while the plane is armed (hp_tel_config enabled), else 0.
int32_t hp_tel_enabled() {
  return g_tel.enabled.load(std::memory_order_relaxed);
}

// Snapshot the cumulative histograms into out: TEL_PHASES records of
// [count, sum_ns, bucket_0 .. bucket_{TEL_BUCKETS-1}], in TelPhase
// order. Writes min(cap, needed) int64s and returns the full layout
// size, so a binding built against other constants fails loudly instead
// of misreading. Wait-free: relaxed reads summed across banks; a racing
// increment skews one drain by one observation, never corrupts.
int32_t hp_tel_drain(int64_t* out, int64_t cap) {
  const int64_t need = (int64_t)TEL_PHASES * (2 + TEL_BUCKETS);
  int64_t idx = 0;
  for (int p = 0; p < TEL_PHASES && idx < cap; p++) {
    uint64_t count = 0, sum = 0;
    // relaxed: every counter is monotone on its own and the Python
    // side converts per-bucket deltas against its own baseline, so an
    // observation a drain under-reads lands whole in the next one
    for (int k = 0; k < TEL_BANKS; k++) {
      count += g_tel.banks[k].count[p].load(std::memory_order_relaxed);
      sum += g_tel.banks[k].sum[p].load(std::memory_order_relaxed);
    }
    if (idx < cap) out[idx++] = (int64_t)count;
    if (idx < cap) out[idx++] = (int64_t)sum;
    for (int b = 0; b < TEL_BUCKETS && idx < cap; b++) {
      uint64_t c = 0;
      // relaxed: the same per-bucket monotone invariant
      for (int k = 0; k < TEL_BANKS; k++)
        c += g_tel.banks[k].buckets[p][b].load(std::memory_order_relaxed);
      out[idx++] = (int64_t)c;
    }
  }
  return (int32_t)need;
}

// Drain (and clear) the slow-row exemplar ring: up to cap records of
// TEL_EX_STRIDE int64 fields each, oldest first: [total_ns, lookup_ns,
// stage_ns, rows, kernel_rows, staged_hits, miss_rows, leased_rows,
// blob_digest, blob_len, plan_kind, lease_tokens]. Returns records
// written.
int32_t hp_tel_exemplars(int64_t* out, int32_t cap) {
  std::lock_guard<std::mutex> lk(g_tel.ex_mu);
  int n = g_tel.ex_n < cap ? g_tel.ex_n : cap;
  int start = (g_tel.ex_head - g_tel.ex_n + 2 * TEL_EX_CAP) % TEL_EX_CAP;
  for (int i = 0; i < n; i++) {
    memcpy(out + (int64_t)i * TEL_EX_STRIDE,
           g_tel.ring[(start + i) % TEL_EX_CAP],
           TEL_EX_STRIDE * sizeof(int64_t));
  }
  g_tel.ex_n = 0;
  g_tel.ex_head = 0;
  return n;
}

// The hot begin: one call per batch covering plan lookup + columnar
// staging + begin-time response codes.
//
//   ptrs/lens[n]: the raw request blobs (no copy — the ingress's take
//       buffers or a ctypes view over Python bytes objects)
//   epoch: the caller's limits epoch (mirror clears when it moved)
//   out_kind[n]: LANE_MISS / LANE_KERNEL / LANE_OK / LANE_UNKNOWN, or
//       LANE_FOREIGN_BASE + owner for a foreign-owned row (pod)
//   slots..bucket[cap]: pre-allocated kernel staging columns; staged
//       hits land at [0, nhits) and padding up to the pow2 bucket H is
//       filled here (scratch slot, delta 0, req H-1) so Python stages
//       NOTHING per row
//   out_rows/out_row_nhits/out_row_delta/out_row_ns[n]: per kernel row
//       (in kernel request-id order == batch order)
//   out_hit_names[cap]: limit-name token per staged hit
//   out_ok_ns/out_ok_calls/out_ok_hits[n]: begin-time OK metric
//       aggregation (plan-OK rows), n_ok_ns distinct namespaces
//   out_meta[12]: k, nhits, H, hit_rows, miss_rows, overflow_rows,
//       n_ok_ns, foreign_rows (rows answered LANE_FOREIGN_BASE + owner
//       for the pod's bulk-forward lane), then the telemetry tail (zeros with telemetry off): lookup_ns,
//       stage_ns, leased_rows, trace_id (nonzero only for the 1-in-N
//       sampled begins when hp_tel_config set trace_sample)
// Returns k (kernel rows staged).
int32_t hp_hot_begin(void* c, const uint8_t* const* ptrs,
                     const uint32_t* lens, int32_t n, int64_t epoch,
                     int8_t* out_kind, int32_t* slots, int32_t* deltas,
                     int32_t* maxes, int32_t* windows, int32_t* req,
                     uint8_t* bucket, int64_t cap, int64_t scratch_slot,
                     int32_t* out_rows, int32_t* out_row_nhits,
                     int32_t* out_row_delta, int32_t* out_row_ns,
                     int32_t* out_hit_names, int32_t* out_ok_ns,
                     int64_t* out_ok_calls, int64_t* out_ok_hits,
                     int64_t* out_meta) {
  Ctx* ctx = (Ctx*)c;
  PlanMirror& m = ctx->mirror;
  m.sync_epoch(epoch);
  std::vector<int64_t>& ent = ctx->scratch_ent;
  if ((int64_t)ent.size() < n) ent.resize(n);
  // relaxed: the flag gates clock reads only; a begin straddling a
  // config change measures (or skips) this one batch
  const int32_t tel = g_tel.enabled.load(std::memory_order_relaxed);
  const int64_t tel_t0 = tel ? tel_now_ns() : 0;

  // Pass 1 (parallel): hash + mirror lookup per row; OK/UNKNOWN rows get
  // their begin-time code here. Reads only; disjoint writes per range.
  int threads = lane_threads();
  ParallelPool* pool = n >= 4096 && threads > 1 ? pool_for(threads) : nullptr;
  auto lookup_range = [&](int part, int parts) {
    int32_t lo = (int32_t)((int64_t)n * part / parts);
    int32_t hi = (int32_t)((int64_t)n * (part + 1) / parts);
    for (int32_t r = lo; r < hi; r++) {
      uint64_t h = Interner::fnv1a((const char*)ptrs[r], lens[r]);
      int64_t j = m.find(ptrs[r], lens[r], h);
      ent[r] = j;
      if (j < 0) {
        out_kind[r] = LANE_MISS;
      } else {
        int32_t kind = m.table[j].kind;
        out_kind[r] = (int8_t)(kind == LANE_KERNEL ? LANE_KERNEL : kind);
      }
    }
  };
  if (pool != nullptr) {
    pool->run((int)pool->workers.size(), lookup_range);
  } else {
    lookup_range(0, 1);
  }
  const int64_t tel_t1 = tel ? tel_now_ns() : 0;

  // Pass 2 (serial): kernel-row offsets (prefix sum), overflow handling,
  // lease consumption, and the begin-time OK metric aggregation.
  int32_t k = 0;
  int64_t nhits = 0;
  int64_t leased_rows = 0;
  int64_t hit_rows = 0, miss_rows = 0, overflow_rows = 0;
  int64_t foreign_rows = 0;
  const bool pod_split = m.pod_hosts > 1;
  int32_t n_ok_ns = 0;
  auto aggregate_ok = [&](int32_t ns_token, int32_t delta) {
    int32_t g = 0;
    for (; g < n_ok_ns; g++) {
      if (out_ok_ns[g] == ns_token) break;
    }
    if (g == n_ok_ns) {
      out_ok_ns[g] = ns_token;
      out_ok_calls[g] = 0;
      out_ok_hits[g] = 0;
      n_ok_ns++;
    }
    out_ok_calls[g] += 1;
    out_ok_hits[g] += delta;
  };
  // per-kernel-row hit offset, reused scratch tail of ent (append)
  std::vector<int64_t> row_off((size_t)n);
  for (int32_t r = 0; r < n; r++) {
    int64_t j = ent[r];
    if (j < 0) {
      miss_rows++;
      continue;
    }
    PlanEntry& e = m.table[j];
    // Pod split: a plan stamped with a foreign owner never stages here;
    // the row's code carries the owner host and the Python side
    // bulk-forwards it over the peer lane. Checked before the lease
    // consume: a foreign plan never holds or spends a local lease.
    if (pod_split && e.owner >= 0 && e.owner != m.pod_host_id) {
      out_kind[r] = (int8_t)(LANE_FOREIGN_BASE + e.owner);
      ent[r] = -1;
      foreign_rows++;
      continue;
    }
    if (e.kind == LANE_FOREIGN) {
      // A foreign-kind plan whose owner stamp is missing or now maps to
      // this host (a topology re-arm, a stamp that raced an epoch bump):
      // derive it again through the miss lane rather than guess.
      out_kind[r] = LANE_MISS;
      ent[r] = -1;
      miss_rows++;
      continue;
    }
    hit_rows++;
    if (e.kind == LANE_KERNEL) {
      if (m.lease_enabled && e.lease_tokens > 0) {
        // Leased admission: the device counters were pre-debited at
        // grant time, so this row completes with zero staging and zero
        // device work — consume one token and answer OK in place.
        e.lease_tokens--;
        m.lease_outstanding--;
        m.leased++;
        e.use_leased++;
        leased_rows++;
        if (e.lease_tokens == 0) {
          m.lease_active--;
          // exhausted under live demand: renewal signal sized by the
          // grant just consumed
          m.push_candidate(e, (int64_t)e.lease_size);
          e.hot_count = 0;
        }
        out_kind[r] = LANE_OK;
        ent[r] = -1;  // not a kernel row: stage/finish must skip it
        if (e.ns_token >= 0) aggregate_ok(e.ns_token, e.delta);
        continue;
      }
      if (m.lease_enabled) {
        e.hot_count++;
        if (e.hot_count == (uint32_t)m.lease_hot_threshold)
          m.push_candidate(e, (int64_t)e.hot_count);
      }
      if (nhits + e.nhits > cap) {
        // Staging buffers full: everything from here takes the Python
        // miss lane (safe: it re-derives). Counted so a silently
        // undersized cap shows in native_lane_overflows.
        out_kind[r] = LANE_MISS;
        ent[r] = -1;
        hit_rows--;
        overflow_rows++;
        miss_rows++;
        continue;
      }
      out_rows[k] = r;
      out_row_nhits[k] = e.nhits;
      out_row_delta[k] = e.delta;
      out_row_ns[k] = e.ns_token;
      row_off[k] = nhits;
      nhits += e.nhits;
      k++;
    } else if (e.kind == LANE_OK && e.ns_token >= 0) {
      aggregate_ok(e.ns_token, e.delta);
    }
  }
  m.hits += (uint64_t)hit_rows;
  m.misses += (uint64_t)miss_rows;
  m.staged_hits += (uint64_t)nhits;
  m.overflows += (uint64_t)overflow_rows;
  m.foreign += (uint64_t)foreign_rows;

  // Pass 3 (parallel): scatter plan records into the staging columns.
  auto stage_range = [&](int part, int parts) {
    int32_t lo = (int32_t)((int64_t)k * part / parts);
    int32_t hi = (int32_t)((int64_t)k * (part + 1) / parts);
    for (int32_t i = lo; i < hi; i++) {
      const PlanEntry& e = m.table[ent[out_rows[i]]];
      const int32_t* rec = m.recs.data() + e.rec_off;
      int64_t off = row_off[i];
      for (int32_t hnum = 0; hnum < e.nhits; hnum++) {
        slots[off] = rec[0];
        maxes[off] = rec[1];
        windows[off] = rec[2];
        bucket[off] = (uint8_t)rec[3];
        out_hit_names[off] = rec[4];
        deltas[off] = e.delta_capped;
        req[off] = i;
        rec += REC_STRIDE;
        off++;
      }
    }
  };
  if (pool != nullptr && k >= 4096) {
    pool->run((int)pool->workers.size(), stage_range);
  } else {
    stage_range(0, 1);
  }

  // Pass 4: pad to the kernel's pow2 hit bucket with inert scratch hits
  // (delta 0, req H-1 — exactly TpuStorage.pad_hits' fill).
  int32_t H = 0;
  if (k > 0) {
    H = pow2_bucket(nhits > k ? nhits : k, 8);
    if (H > cap) H = (int32_t)cap;  // cap is pow2-sized by the caller
    for (int64_t i = nhits; i < H; i++) {
      slots[i] = (int32_t)scratch_slot;
      deltas[i] = 0;
      maxes[i] = 0x7fffffff;
      windows[i] = 0;
      req[i] = H - 1;
      bucket[i] = 0;
    }
  }
  out_meta[0] = k;
  out_meta[1] = nhits;
  out_meta[2] = H;
  out_meta[3] = hit_rows;
  out_meta[4] = miss_rows;
  out_meta[5] = overflow_rows;
  out_meta[6] = n_ok_ns;
  out_meta[7] = foreign_rows;
  out_meta[8] = 0;
  out_meta[9] = 0;
  out_meta[10] = 0;
  out_meta[11] = 0;
  if (tel) {
    const int64_t tel_t2 = tel_now_ns();
    const int64_t lookup_ns = tel_t1 - tel_t0;
    const int64_t stage_ns = tel_t2 - tel_t1;
    tel_observe(TEL_HOT_LOOKUP, lookup_ns);
    tel_observe(TEL_HOT_STAGE, stage_ns);
    if (leased_rows > 0) tel_observe(TEL_LEASE_HIT, tel_t2 - tel_t0);
    // relaxed: the threshold is advisory per batch; the ring itself is
    // mutex-guarded (tel_push_exemplar)
    const int64_t slow = g_tel.slow_ns.load(std::memory_order_relaxed);
    if (slow > 0 && n > 0 && (tel_t2 - tel_t0) > slow * (int64_t)n) {
      // Slow begin: the lead row's identity and lease/plan state, so the
      // flight recorder names a culprit. Lead row = the first kernel row
      // when one staged (its entry is still addressable through ent),
      // else row 0.
      int64_t fields[TEL_EX_STRIDE];
      fields[0] = tel_t2 - tel_t0;
      fields[1] = lookup_ns;
      fields[2] = stage_ns;
      fields[3] = n;
      fields[4] = k;
      fields[5] = nhits;
      fields[6] = miss_rows;
      fields[7] = leased_rows;
      if (k > 0) {
        const PlanEntry& e = m.table[ent[out_rows[0]]];
        fields[8] = (int64_t)e.hash;
        fields[9] = (int64_t)e.blob_len;
        fields[10] = e.kind;
        fields[11] = e.lease_tokens;
      } else {
        fields[8] = (int64_t)Interner::fnv1a((const char*)ptrs[0], lens[0]);
        fields[9] = (int64_t)lens[0];
        fields[10] = -1;
        fields[11] = -1;
      }
      tel_push_exemplar(fields);
    }
    out_meta[8] = lookup_ns;
    out_meta[9] = stage_ns;
    out_meta[10] = leased_rows;
    // relaxed: batch_seq needs only uniqueness and a 1-in-N cadence
    const int64_t samp = g_tel.trace_sample.load(std::memory_order_relaxed);
    if (samp > 0) {
      uint64_t seq = g_tel.batch_seq.fetch_add(1, std::memory_order_relaxed)
                     + 1;
      if (seq % (uint64_t)samp == 0) out_meta[11] = (int64_t)seq;
    }
  }
  return k;
}

// Concatenated-buffer form of hp_hot_begin: ``buf`` holds the blobs
// back to back with ``sizes[n]`` lengths (the cheap layout a Python
// bytes join produces; building a per-row pointer table through ctypes
// costs several times the whole C pass). The pointer table is derived
// here in one O(n) sweep.
int32_t hp_hot_begin_buf(void* c, const uint8_t* buf, const int32_t* sizes,
                         int32_t n, int64_t epoch, int8_t* out_kind,
                         int32_t* slots, int32_t* deltas, int32_t* maxes,
                         int32_t* windows, int32_t* req, uint8_t* bucket,
                         int64_t cap, int64_t scratch_slot,
                         int32_t* out_rows, int32_t* out_row_nhits,
                         int32_t* out_row_delta, int32_t* out_row_ns,
                         int32_t* out_hit_names, int32_t* out_ok_ns,
                         int64_t* out_ok_calls, int64_t* out_ok_hits,
                         int64_t* out_meta) {
  std::vector<const uint8_t*> ptrs((size_t)n);
  std::vector<uint32_t> lens((size_t)n);
  const uint8_t* p = buf;
  for (int32_t i = 0; i < n; i++) {
    ptrs[i] = p;
    lens[i] = (uint32_t)sizes[i];
    p += sizes[i];
  }
  return hp_hot_begin(c, ptrs.data(), lens.data(), n, epoch, out_kind,
                      slots, deltas, maxes, windows, req, bucket, cap,
                      scratch_slot, out_rows, out_row_nhits, out_row_delta,
                      out_row_ns, out_hit_names, out_ok_ns, out_ok_calls,
                      out_ok_hits, out_meta);
}

// The hot finish: turn the device result columns into response codes and
// aggregate the batch's metrics in one pass. Stateless with respect to
// the mirror (safe from any collect thread while the next begin runs).
//
//   admitted[k]: per kernel row; hit_ok[nhits]: per staged hit
//   out_kind: rows flip LANE_KERNEL -> LANE_OK / LANE_OVER
//   out_ok_*[k]: admitted-call aggregation per namespace token
//   out_lim_ns/out_lim_name/out_lim_count[k]: limited aggregation per
//       (namespace, first-failing-limit-name) token pair
//   out_counts[2]: n_ok_ns, n_limited
void hp_hot_finish(void* c, const uint8_t* admitted, const uint8_t* hit_ok,
                   int32_t k, const int32_t* rows,
                   const int32_t* row_nhits, const int32_t* row_delta,
                   const int32_t* row_ns, const int32_t* hit_names,
                   int8_t* out_kind, int32_t* out_ok_ns,
                   int64_t* out_ok_calls, int64_t* out_ok_hits,
                   int32_t* out_lim_ns, int32_t* out_lim_name,
                   int64_t* out_lim_count, int64_t* out_counts) {
  (void)c;
  // relaxed: the begin side's flag invariant; this call may run with a
  // NULL ctx after an interner recycle, which is why the plane is global
  const int32_t tel = g_tel.enabled.load(std::memory_order_relaxed);
  const int64_t tel_t0 = tel ? tel_now_ns() : 0;
  int32_t n_ok = 0, n_lim = 0;
  int64_t base = 0;
  for (int32_t i = 0; i < k; i++) {
    int32_t r = rows[i];
    if (admitted[i]) {
      out_kind[r] = LANE_OK;
      int32_t ns = row_ns[i];
      if (ns >= 0) {
        int32_t g = 0;
        for (; g < n_ok; g++) {
          if (out_ok_ns[g] == ns) break;
        }
        if (g == n_ok) {
          out_ok_ns[g] = ns;
          out_ok_calls[g] = 0;
          out_ok_hits[g] = 0;
          n_ok++;
        }
        out_ok_calls[g] += 1;
        out_ok_hits[g] += row_delta[i];
      }
    } else {
      out_kind[r] = LANE_OVER;
      int32_t ns = row_ns[i];
      if (ns >= 0) {
        // first failing hit in request order names the limit
        int32_t name = -1;
        for (int32_t hnum = 0; hnum < row_nhits[i]; hnum++) {
          if (!hit_ok[base + hnum]) {
            name = hit_names[base + hnum];
            break;
          }
        }
        int32_t g = 0;
        for (; g < n_lim; g++) {
          if (out_lim_ns[g] == ns && out_lim_name[g] == name) break;
        }
        if (g == n_lim) {
          out_lim_ns[g] = ns;
          out_lim_name[g] = name;
          out_lim_count[g] = 0;
          n_lim++;
        }
        out_lim_count[g] += 1;
      }
    }
    base += row_nhits[i];
  }
  out_counts[0] = n_ok;
  out_counts[1] = n_lim;
  if (tel) tel_observe(TEL_HOT_FINISH, tel_now_ns() - tel_t0);
}

// ---- per-group partition (device/storage.py staging assist) ----------------

// Grouped cumcount in one O(n) pass: counts[n_groups] and pos[i] = row i's
// index within its group, counted in input order (the host side of the
// per-row staging partition, without numpy's argsort).
void hp_partition_positions(const int32_t* group_ids, int64_t n,
                            int32_t n_groups, int64_t* out_counts,
                            int64_t* out_pos) {
  for (int32_t g = 0; g < n_groups; g++) out_counts[g] = 0;
  for (int64_t i = 0; i < n; i++) out_pos[i] = out_counts[group_ids[i]]++;
}

}  // extern "C"
