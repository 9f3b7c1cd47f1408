// Concurrency race-hunt driver for the port's csrc/h2ingress.cc.
//
// A copy of the JAX package's driver (native/race_hunt_h2i.cc), the
// same shape as race_hunt_hostpath.cc: a standalone instrumented binary
// (the sanitizer runtime cannot ride a plain-CPython dlopen), one per
// library translation unit, because both libraries define file-scope
// types in anonymous namespaces that would collide in a single unit.
// limitador_tpu_torch/native/build.py build_tool compiles it;
// tests/test_torch_race_hunt.py and chip_smoke.py run it.
//
// The ingress's contract: ONE epoll thread owns every socket; worker
// threads interact only through h2i_take / h2i_respond /
// h2i_respond_coded / h2i_set_code / h2i_stream_key (all serialized on
// the internal Ctx mutex) and the lock-free telemetry and stat exports.
// The hunt drives exactly that surface from unsynchronized threads
// (take racing respond racing set_code racing telemetry drains racing
// the io thread), plus a raw-TCP chaos client hammering the accept,
// protocol-error and connection-teardown paths with garbage bytes.
//
// Exit 0 with "RACE_HUNT_OK reqs=<n>"; any sanitizer report fails the
// hunt.

#include "h2ingress.cc"

#include <arpa/inet.h>
#include <cinttypes>
#include <cstdio>
#include <random>
#include <vector>

namespace {

std::atomic<bool> g_done{false};
std::atomic<uint64_t> g_taken{0};

void take_worker(void* ctx) {
  constexpr int kMax = 64;
  uint64_t ids[kMax];
  const uint8_t* ptrs[kMax];
  uint32_t lens[kMax];
  const char* path_ptrs[kMax];
  uint32_t path_lens[kMax];
  std::vector<int8_t> codes(kMax);
  while (!g_done.load()) {
    int n = h2i_take(ctx, kMax, 10, ids, ptrs, lens, path_ptrs, path_lens);
    if (n <= 0) continue;
    g_taken.fetch_add((uint64_t)n);
    for (int i = 0; i < n; i++) {
      h2i_stream_key(ctx, ids[i]);
      codes[i] = (int8_t)(i % 3);  // registered coded templates
    }
    // answer half through the coded batch path, half per-row
    int half = n / 2;
    if (half > 0) h2i_respond_coded(ctx, half, ids, codes.data());
    if (n - half > 0) {
      std::vector<int> statuses(n - half, 0);
      std::vector<const uint8_t*> payloads(n - half);
      std::vector<uint32_t> plens(n - half);
      static const uint8_t kBody[] = "ok";
      for (int i = 0; i < n - half; i++) {
        payloads[i] = kBody;
        plens[i] = 2;
      }
      h2i_respond(ctx, n - half, ids + half, statuses.data(),
                  payloads.data(), plens.data());
    }
  }
}

void bogus_respond_worker(void* ctx) {
  // responses for rids that were never taken (or already answered):
  // drain_responses must skip them without touching conn state
  std::mt19937 rng(17);
  while (!g_done.load()) {
    uint64_t rid = 1 + (rng() % 1000);
    int status = 7;
    static const uint8_t kBody[] = "bogus";
    const uint8_t* payload = kBody;
    uint32_t len = 5;
    h2i_respond(ctx, 1, &rid, &status, &payload, &len);
    int8_t code = 1;
    h2i_respond_coded(ctx, 1, &rid, &code);
    std::this_thread::sleep_for(std::chrono::microseconds(300));
  }
}

void config_worker(void* ctx) {
  std::mt19937 rng(23);
  int flip = 0;
  while (!g_done.load()) {
    static const uint8_t kOk[] = "\0\0\0\0\0";
    h2i_set_code(ctx, (int)(rng() % 3), 0, kOk, 5);
    h2i_tel_config((++flip & 1));
    for (int what = 0; what < 4; what++) h2i_stat(ctx, what);
    std::this_thread::sleep_for(std::chrono::microseconds(400));
  }
}

void tel_worker() {
  std::vector<int64_t> hist(2 + H2I_TEL_BUCKETS);
  while (!g_done.load()) {
    h2i_tel_drain(hist.data(), (int64_t)hist.size());
    std::this_thread::sleep_for(std::chrono::microseconds(150));
  }
}

// Request injector: same-TU access lets the driver enqueue inflight
// requests exactly the way the frame parser does (mu-guarded map +
// ready deque + cv notify), without speaking full HTTP/2. The conn id
// is deliberately dead so drain_responses exercises its peer-went-away
// path; what matters is that take/respond/stream_key race over LIVE
// queue entries.
void injector_worker(Ctx* c) {
  std::mt19937 rng(41);
  while (!g_done.load()) {
    {
      std::lock_guard<std::mutex> lk(c->mu);
      for (int i = 0; i < 32; i++) {
        uint64_t rid = c->next_rid++;
        c->inflight.emplace(
            rid, InflightReq{/*conn_id=*/9999, /*stream=*/1,
                             std::string(8 + (rng() % 48), 'x'),
                             c->target_path});
        c->ready.push_back(rid);
      }
    }
    c->stat_reqs++;
    c->cv.notify_all();
    std::this_thread::sleep_for(std::chrono::microseconds(200));
  }
}

// Raw-TCP chaos client: garbage bytes exercise accept, the proto-error
// path and conn teardown under the io thread, concurrently with every
// app-side export above.
void chaos_client(int port) {
  std::mt19937 rng(31);
  while (!g_done.load()) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) break;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    inet_pton(AF_INET, "127.0.0.1", &addr.sin_addr);
    if (connect(fd, (sockaddr*)&addr, sizeof(addr)) == 0) {
      char junk[128];
      for (auto& ch : junk) ch = (char)(rng() & 0xff);
      ssize_t ignored = write(fd, junk, sizeof(junk));
      (void)ignored;
      std::this_thread::sleep_for(std::chrono::microseconds(500));
    }
    ::close(fd);
  }
}

}  // namespace

int main() {
  const char* ms_env = getenv("RACE_HUNT_MS");
  int run_ms = ms_env ? atoi(ms_env) : 2000;
  if (run_ms <= 0) run_ms = 2000;

  void* ctx = h2i_create("127.0.0.1", 0, "/envoy.service/ShouldRateLimit",
                         nullptr);
  if (ctx == nullptr) {
    // no loopback interface here: nothing to hunt, succeed vacuously
    printf("RACE_HUNT_OK reqs=0 (no socket)\n");
    return 0;
  }
  int port = h2i_port(ctx);
  static const uint8_t kOk[] = "\0\0\0\0\0";
  for (int code = 0; code < 3; code++) h2i_set_code(ctx, code, 0, kOk, 5);
  h2i_tel_config(1);

  std::vector<std::thread> threads;
  threads.emplace_back(take_worker, ctx);
  threads.emplace_back(take_worker, ctx);
  threads.emplace_back(take_worker, ctx);
  threads.emplace_back(bogus_respond_worker, ctx);
  threads.emplace_back(injector_worker, (Ctx*)ctx);
  threads.emplace_back(config_worker, ctx);
  threads.emplace_back(tel_worker);
  threads.emplace_back(tel_worker);
  threads.emplace_back(chaos_client, port);
  threads.emplace_back(chaos_client, port);

  std::this_thread::sleep_for(std::chrono::milliseconds(run_ms));
  g_done.store(true);
  for (auto& t : threads) t.join();
  h2i_close(ctx);
  printf("RACE_HUNT_OK reqs=%" PRIu64 "\n", g_taken.load());
  return 0;
}
