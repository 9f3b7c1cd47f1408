// Concurrency race-hunt driver for the port's csrc/hostpath.cc.
//
// A copy of the JAX package's driver (native/race_hunt_hostpath.cc),
// compiled standalone under -fsanitize=thread, address or undefined by
// limitador_tpu_torch/native/build.py build_tool (tools/race_hunt.py runs
// it, for tests/test_torch_race_hunt.py and chip_smoke.py): dlopen'ing
// an instrumented .so into a plain CPython needs the runtime preloaded,
// so the hunt drives the library as its own process instead: same
// translation unit, full sanitizer coverage.
//
// The driver keeps the production locking discipline, not a
// free-for-all: begins, lease traffic, usage drains, context swaps and
// every mirror mutation serialize on one mutex (pipeline_mu models the
// Python side's native lock and storage lock span, under which
// native/__init__.py's callers make each of these calls), because racing
// those is a bug in the caller by contract. What must be clean without
// the lock, and what the hunt hammers from unsynchronized threads, is:
//
//   * the wait-free telemetry plane: hp_tel_drain / hp_tel_exemplars /
//     hp_tel_config / hp_tel_enabled racing tel_observe from every
//     begin and finish;
//   * hp_hot_finish with a NULL ctx racing begins and hp_free (the
//     interner-recycle contract: pendings outlive their context);
//   * hp_set_threads racing lane_threads() inside large begins;
//   * the in-library ParallelPool (one serving thread uses 4096-row
//     batches to engage it);
//   * hp_partition_positions and hp_pod_hash on private buffers.
//
// Three changes from the JAX driver:
//   (a) the lane-stats buffer is HP_LANE_STATS long (the JAX driver's
//       eight-entry buffer overflows by one since hp_lane_stats writes
//       the pod's foreign rows into its ninth entry);
//   (b) the pod ownership mirror and the exports around it: a re-arm
//       worker (hp_pod_config, hp_plan_set_owner, as a commit re-arms a
//       member), serving workers that stamp owners (hp_plan_stamp_owner,
//       hp_pod_owner) and split foreign rows through hp_hot_begin and
//       hp_hot_begin_buf, a mirror worker (hp_plan_invalidate_slot,
//       hp_plan_export, re-puts) and an interner worker (hp_intern,
//       hp_find, hp_slots_insert / lookup / remove / count);
//   (c) the final RACE_HUNT_OK line also prints how many times each
//       export was called, and how many rows the begins split foreign.
//
// Exit 0 with a "RACE_HUNT_OK ops=<n> ..." line; any sanitizer report
// fails the hunt (TSAN_OPTIONS exitcode and an output scan).

#include "hostpath.cc"

#include <cinttypes>
#include <cstdio>
#include <random>
#include <string>
#include <vector>

namespace {

constexpr int64_t kEpoch = 7;
constexpr int kPlans = 64;
constexpr int64_t kCap = 1 << 14;
constexpr int64_t kScratchSlot = 100000;

std::mutex pipeline_mu;  // models the Python native+storage lock span
void* g_ctx_ptr = nullptr;  // guarded by pipeline_mu
std::atomic<bool> g_done{false};
std::atomic<uint64_t> g_ops{0};
std::atomic<uint64_t> g_foreign_rows{0};

// The exports the pod slices made live, each counted at its call: the
// hunt fails (tests/test_torch_race_hunt.py, chip_smoke.py) when one of
// them was never driven.
enum Export {
  E_POD_CONFIG,
  E_POD_OWNER,
  E_POD_HASH,
  E_PLAN_SET_OWNER,
  E_PLAN_STAMP_OWNER,
  E_PLAN_EXPORT,
  E_PLAN_INVALIDATE_SLOT,
  E_HOT_BEGIN_BUF,
  E_INTERN,
  E_SLOTS_INSERT,
  E_SLOTS_LOOKUP,
  E_SLOTS_REMOVE,
  E_TEL_ENABLED,
  E_COUNT
};

const char* const kExportNames[E_COUNT] = {
    "hp_pod_config",      "hp_pod_owner",         "hp_pod_hash",
    "hp_plan_set_owner",  "hp_plan_stamp_owner",  "hp_plan_export",
    "hp_plan_invalidate_slot", "hp_hot_begin_buf", "hp_intern",
    "hp_slots_insert",    "hp_slots_lookup",      "hp_slots_remove",
    "hp_tel_enabled",
};

std::atomic<uint64_t> g_calls[E_COUNT];

inline void tally(Export e) {
  // relaxed: a tally, read once after every thread joined
  g_calls[e].fetch_add(1, std::memory_order_relaxed);
}

std::vector<std::string> make_blobs() {
  std::vector<std::string> out;
  for (int i = 0; i < kPlans; i++) {
    std::string b = "blob-" + std::to_string(i) + "-";
    for (int j = 0; j < (i % 23); j++) b.push_back((char)('a' + j));
    out.push_back(b);
  }
  return out;
}

// The repr bytes of plan i's counter key (what the Python miss lane
// hands hp_plan_stamp_owner and hp_pod_owner).
std::vector<std::string> make_reprs() {
  std::vector<std::string> out;
  for (int i = 0; i < kPlans; i++)
    out.push_back("(('ns', 'limit-" + std::to_string(i % 5) +
                  "'), (('user', 'u" + std::to_string(i) + "'),))");
  return out;
}

// Plan i: a kernel plan of one or two hits, every 4th an OK plan, every
// 8th (from 5) a FOREIGN plan the way the pod's miss lane files one.
void put_plan(void* ctx, const std::vector<std::string>& blobs, int i) {
  int32_t nhits = 1 + (i % 2);
  int32_t rec[2 * REC_STRIDE];
  for (int32_t h = 0; h < nhits; h++) {
    rec[h * REC_STRIDE + 0] = (i * 2 + h) % 1000;  // slot
    rec[h * REC_STRIDE + 1] = 1000;                // max_value
    rec[h * REC_STRIDE + 2] = 1000;                // window_ms
    rec[h * REC_STRIDE + 3] = i % 2;               // bucket flag
    rec[h * REC_STRIDE + 4] = i;                   // name token
  }
  int32_t kind = (i % 8 == 5)   ? LANE_FOREIGN
                 : (i % 4 == 3) ? LANE_OK
                                : LANE_KERNEL;
  hp_plan_put(ctx, (const uint8_t*)blobs[i].data(),
              (int32_t)blobs[i].size(), kEpoch, kind, i % 8, 1, 1, rec,
              kind == LANE_KERNEL ? nhits : 0);
}

void seed_plans(void* ctx, const std::vector<std::string>& blobs) {
  hp_plan_epoch(ctx, kEpoch);
  for (int i = 0; i < (int)blobs.size(); i++) put_plan(ctx, blobs, i);
}

// per-thread staging buffers, sized once
struct Bufs {
  int32_t n;
  std::vector<const uint8_t*> ptrs;
  std::vector<uint32_t> lens;
  std::vector<int8_t> kind;
  std::vector<int32_t> slots, deltas, maxes, windows, req;
  std::vector<uint8_t> bucket, admitted, hit_ok;
  std::vector<int32_t> rows, row_nhits, row_delta, row_ns, hit_names;
  std::vector<int32_t> ok_ns, lim_ns, lim_name;
  std::vector<int64_t> ok_calls, ok_hits, lim_count;
  int64_t meta[12];
  int64_t counts[2];

  explicit Bufs(int32_t rows_n) : n(rows_n) {
    ptrs.resize(n);
    lens.resize(n);
    kind.resize(n);
    slots.resize(kCap);
    deltas.resize(kCap);
    maxes.resize(kCap);
    windows.resize(kCap);
    req.resize(kCap);
    bucket.resize(kCap);
    admitted.resize(n);
    hit_ok.resize(kCap);
    rows.resize(n);
    row_nhits.resize(n);
    row_delta.resize(n);
    row_ns.resize(n);
    hit_names.resize(kCap);
    ok_ns.resize(n);
    ok_calls.resize(n);
    ok_hits.resize(n);
    lim_ns.resize(n);
    lim_name.resize(n);
    lim_count.resize(n);
  }
};

// A serving thread: the miss lane's owner stamps (every few batches,
// under the lock, right after the plans it would have put), then a
// begin, through the pointer table or (``use_buf``) the concatenated
// buffer the Python lane builds.
void serving_worker(int seed, int32_t batch_rows, bool use_buf) {
  Bufs b(batch_rows);
  std::mt19937 rng(seed);
  const std::vector<std::string> blobs = make_blobs();
  const std::vector<std::string> reprs = make_reprs();
  std::vector<uint8_t> joined;
  std::vector<int32_t> sizes(batch_rows);
  uint64_t batch = 0;
  while (!g_done.load()) {
    int32_t k;
    int64_t nhits;
    {
      const std::string& key = reprs[rng() % reprs.size()];
      hp_pod_hash((const uint8_t*)key.data(), (int32_t)key.size());
      tally(E_POD_HASH);  // context-free: outside the lock
    }
    {
      std::lock_guard<std::mutex> lk(pipeline_mu);
      void* ctx = g_ctx_ptr;
      if ((batch++ & 3) == 0) {
        for (int s = 0; s < 4; s++) {
          int i = (int)(rng() % blobs.size());
          hp_plan_stamp_owner(ctx, (const uint8_t*)blobs[i].data(),
                              (int32_t)blobs[i].size(), kEpoch,
                              (const uint8_t*)reprs[i].data(),
                              (int32_t)reprs[i].size());
          tally(E_PLAN_STAMP_OWNER);
          hp_pod_owner(ctx, (const uint8_t*)reprs[i].data(),
                       (int32_t)reprs[i].size());
          tally(E_POD_OWNER);
        }
      }
      joined.clear();
      for (int32_t r = 0; r < b.n; r++) {
        const std::string& blob = blobs[rng() % blobs.size()];
        b.ptrs[r] = (const uint8_t*)blob.data();
        b.lens[r] = (uint32_t)blob.size();
        sizes[r] = (int32_t)blob.size();
        if (use_buf) joined.insert(joined.end(), blob.begin(), blob.end());
      }
      if (use_buf) {
        k = hp_hot_begin_buf(ctx, joined.data(), sizes.data(), b.n, kEpoch,
                             b.kind.data(), b.slots.data(), b.deltas.data(),
                             b.maxes.data(), b.windows.data(), b.req.data(),
                             b.bucket.data(), kCap, kScratchSlot,
                             b.rows.data(), b.row_nhits.data(),
                             b.row_delta.data(), b.row_ns.data(),
                             b.hit_names.data(), b.ok_ns.data(),
                             b.ok_calls.data(), b.ok_hits.data(), b.meta);
        tally(E_HOT_BEGIN_BUF);
      } else {
        k = hp_hot_begin(ctx, b.ptrs.data(), b.lens.data(), b.n, kEpoch,
                         b.kind.data(), b.slots.data(), b.deltas.data(),
                         b.maxes.data(), b.windows.data(), b.req.data(),
                         b.bucket.data(), kCap, kScratchSlot, b.rows.data(),
                         b.row_nhits.data(), b.row_delta.data(),
                         b.row_ns.data(), b.hit_names.data(), b.ok_ns.data(),
                         b.ok_calls.data(), b.ok_hits.data(), b.meta);
      }
      nhits = b.meta[1];
      g_foreign_rows.fetch_add((uint64_t)b.meta[7],
                               std::memory_order_relaxed);
    }
    // Device "result" + finish OUTSIDE the lock, NULL ctx — exactly the
    // interner-recycle contract production relies on.
    for (int32_t i = 0; i < k; i++) b.admitted[i] = (uint8_t)(rng() & 1);
    for (int64_t h = 0; h < nhits; h++) b.hit_ok[h] = (uint8_t)(rng() & 1);
    hp_hot_finish(nullptr, b.admitted.data(), b.hit_ok.data(), k,
                  b.rows.data(), b.row_nhits.data(), b.row_delta.data(),
                  b.row_ns.data(), b.hit_names.data(), b.kind.data(),
                  b.ok_ns.data(), b.ok_calls.data(), b.ok_hits.data(),
                  b.lim_ns.data(), b.lim_name.data(), b.lim_count.data(),
                  b.counts);
    g_ops.fetch_add(1);
  }
}

void broker_worker() {
  std::vector<uint8_t> cand_blobs(1 << 16);
  std::vector<int32_t> cand_lens(256);
  std::vector<int64_t> cand_counts(256), ret_ids(256), ret_tokens(256);
  int64_t stats[8];
  int64_t next_id = 1;
  const std::vector<std::string> blobs = make_blobs();
  std::mt19937 rng(99);
  while (!g_done.load()) {
    {
      std::lock_guard<std::mutex> lk(pipeline_mu);
      void* ctx = g_ctx_ptr;
      hp_lease_config(ctx, 1, 4);
      int32_t n = hp_lease_candidates(ctx, cand_blobs.data(),
                                      (int64_t)cand_blobs.size(),
                                      cand_lens.data(), cand_counts.data(),
                                      256);
      int64_t off = 0;
      for (int32_t i = 0; i < n; i++) {
        hp_lease_grant(ctx, cand_blobs.data() + off, cand_lens[i], kEpoch,
                       next_id++, 64);
        off += cand_lens[i];
      }
      const std::string& victim = blobs[rng() % blobs.size()];
      hp_lease_tokens(ctx, (const uint8_t*)victim.data(),
                      (int32_t)victim.size(), -1);
      if ((rng() & 3) == 0)
        hp_lease_revoke(ctx, (const uint8_t*)victim.data(),
                        (int32_t)victim.size(), -1);
      hp_lease_drain_returns(ctx, ret_ids.data(), ret_tokens.data(), 256);
      hp_lease_stats(ctx, stats);
    }
    std::this_thread::sleep_for(std::chrono::microseconds(200));
  }
}

void stats_worker() {
  std::vector<uint8_t> blobs(1 << 16);
  std::vector<int32_t> lens(256);
  std::vector<int64_t> counts(256);
  int64_t lane[HP_LANE_STATS];
  while (!g_done.load()) {
    {
      std::lock_guard<std::mutex> lk(pipeline_mu);
      void* ctx = g_ctx_ptr;
      hp_lane_stats(ctx, lane);
      hp_usage_drain(ctx, blobs.data(), (int64_t)blobs.size(), lens.data(),
                     counts.data(), 256);
    }
    std::this_thread::sleep_for(std::chrono::microseconds(300));
  }
}

void telemetry_worker(int which) {
  const int64_t need = (int64_t)TEL_PHASES * (2 + TEL_BUCKETS);
  std::vector<int64_t> hist(need);
  std::vector<int64_t> ex((size_t)TEL_EX_CAP * TEL_EX_STRIDE);
  int flip = 0;
  while (!g_done.load()) {
    hp_tel_drain(hist.data(), need);
    hp_tel_exemplars(ex.data(), TEL_EX_CAP);
    hp_tel_enabled();
    tally(E_TEL_ENABLED);
    if (which == 0 && (++flip & 15) == 0)
      hp_tel_config(1, 1, 3);  // re-assert: stores race the observes
    std::this_thread::sleep_for(std::chrono::microseconds(100));
  }
}

void config_worker() {
  int n = 1;
  while (!g_done.load()) {
    hp_set_threads(1 + (n++ % 4));  // races lane_threads() in begins
    std::this_thread::sleep_for(std::chrono::microseconds(500));
  }
}

void swap_worker() {
  const std::vector<std::string> blobs = make_blobs();
  while (!g_done.load()) {
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
    void* fresh = hp_new();
    seed_plans(fresh, blobs);
    void* old;
    {
      std::lock_guard<std::mutex> lk(pipeline_mu);
      old = g_ctx_ptr;
      g_ctx_ptr = fresh;
    }
    // free OUTSIDE the lock while NULL-ctx finishes may still run —
    // the production recycle contract (finish never derefs its ctx)
    hp_free(old);
  }
}

// The pod's re-arm: a commit (or a recycle) arms the mirror for the new
// topology and the router's verdicts land as owner stamps, under the
// native lock, while serving threads stamp and split.
void rearm_worker() {
  const std::vector<std::string> blobs = make_blobs();
  std::mt19937 rng(57);
  int n = 0;
  while (!g_done.load()) {
    {
      std::lock_guard<std::mutex> lk(pipeline_mu);
      void* ctx = g_ctx_ptr;
      int32_t hosts = 1 + (n % 3);  // 1 (no split), 2, 3
      hp_pod_config(ctx, hosts, n % hosts, 1 + (n % 2));
      tally(E_POD_CONFIG);
      for (int s = 0; s < 8; s++) {
        int i = (int)(rng() % blobs.size());
        int32_t owner = (int32_t)(rng() % (uint32_t)(hosts + 1)) - 1;
        hp_plan_set_owner(ctx, (const uint8_t*)blobs[i].data(),
                          (int32_t)blobs[i].size(), kEpoch, owner);
        tally(E_PLAN_SET_OWNER);
      }
      n++;
    }
    std::this_thread::sleep_for(std::chrono::microseconds(300));
  }
}

// Slot releases drop the plans that pinned them (plan_cache's
// invalidate_slot, under the storage lock); the miss lane puts them
// back; the elastic pod's plan seed exports the live mirror.
void mirror_worker() {
  const std::vector<std::string> blobs = make_blobs();
  std::vector<uint8_t> snapshot;
  std::mt19937 rng(61);
  while (!g_done.load()) {
    {
      std::lock_guard<std::mutex> lk(pipeline_mu);
      void* ctx = g_ctx_ptr;
      int i = (int)(rng() % blobs.size());
      hp_plan_invalidate_slot(ctx, (i * 2) % 1000);
      tally(E_PLAN_INVALIDATE_SLOT);
      int64_t need = hp_plan_export(ctx, nullptr, 0);
      tally(E_PLAN_EXPORT);
      snapshot.resize((size_t)need);
      hp_plan_export(ctx, snapshot.data(), need);
      tally(E_PLAN_EXPORT);
      put_plan(ctx, blobs, i);
    }
    std::this_thread::sleep_for(std::chrono::microseconds(250));
  }
}

// The interner and the slot map (the native pipeline's tracked tokens
// and its columnar slot lookups and inserts, under the storage lock).
void interner_worker() {
  std::mt19937 rng(67);
  std::vector<int32_t> keys(2 * 16);
  std::vector<int64_t> found(16);
  while (!g_done.load()) {
    {
      std::lock_guard<std::mutex> lk(pipeline_mu);
      void* ctx = g_ctx_ptr;
      for (int r = 0; r < 16; r++) {
        std::string s = "value-" + std::to_string(rng() % 512);
        int32_t id = hp_intern(ctx, s.data(), (int32_t)s.size());
        tally(E_INTERN);
        hp_find(ctx, s.data(), (int32_t)s.size());
        keys[2 * r] = 7;
        keys[2 * r + 1] = id;
      }
      for (int r = 0; r < 16; r += 2) {
        hp_slots_insert(ctx, &keys[2 * r], 2, 200000 + r);
        tally(E_SLOTS_INSERT);
      }
      hp_slots_lookup(ctx, keys.data(), 16, 2, found.data());
      tally(E_SLOTS_LOOKUP);
      for (int r = 0; r < 16; r += 4) {
        hp_slots_remove(ctx, &keys[2 * r], 2);
        tally(E_SLOTS_REMOVE);
      }
      hp_slots_count(ctx);
    }
    std::this_thread::sleep_for(std::chrono::microseconds(200));
  }
}

void partition_worker() {
  std::vector<int32_t> groups(4096);
  std::vector<int64_t> counts(8), pos(4096);
  std::mt19937 rng(7);
  while (!g_done.load()) {
    for (auto& g : groups) g = (int32_t)(rng() % 8);
    hp_partition_positions(groups.data(), (int64_t)groups.size(), 8,
                           counts.data(), pos.data());
    std::this_thread::sleep_for(std::chrono::microseconds(200));
  }
}

}  // namespace

int main() {
  const char* ms_env = getenv("RACE_HUNT_MS");
  int run_ms = ms_env ? atoi(ms_env) : 2000;
  if (run_ms <= 0) run_ms = 2000;

  hp_tel_config(1, /*slow_row_ns=*/1, /*trace_sample=*/3);
  void* ctx = hp_new();
  seed_plans(ctx, make_blobs());
  g_ctx_ptr = ctx;

  std::vector<std::thread> threads;
  threads.emplace_back(serving_worker, 1, 256, false);
  threads.emplace_back(serving_worker, 2, 256, true);
  threads.emplace_back(serving_worker, 3, 4096, false);  // the pool
  threads.emplace_back(serving_worker, 4, 64, true);
  threads.emplace_back(rearm_worker);
  threads.emplace_back(mirror_worker);
  threads.emplace_back(interner_worker);
  threads.emplace_back(broker_worker);
  threads.emplace_back(stats_worker);
  threads.emplace_back(telemetry_worker, 0);
  threads.emplace_back(telemetry_worker, 1);
  threads.emplace_back(config_worker);
  threads.emplace_back(swap_worker);
  threads.emplace_back(partition_worker);

  std::this_thread::sleep_for(std::chrono::milliseconds(run_ms));
  g_done.store(true);
  for (auto& t : threads) t.join();
  {
    std::lock_guard<std::mutex> lk(pipeline_mu);
    hp_free(g_ctx_ptr);
  }
  std::string calls;
  for (int e = 0; e < E_COUNT; e++) {
    if (e) calls += ",";
    calls += std::string(kExportNames[e]) + ":" +
             std::to_string(g_calls[e].load());
  }
  printf("RACE_HUNT_OK ops=%" PRIu64 " foreign_rows=%" PRIu64
         " calls=%s\n",
         g_ops.load(), g_foreign_rows.load(), calls.c_str());
  return 0;
}
