"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing falls back:

1. The card: its name, compute capability (must be 9.0) and power limit.
2. The build: nvcc builds the counter-table kernels from
   limitador_tpu_torch/csrc/ for sm_90a, g++ builds the C++ host lane
   (csrc/hostpath.cc) and g++ the native HTTP/2 ingress
   (csrc/h2ingress.cc), all started together; prints seconds and ptxas
   lines.
3. Each kernel against its plain PyTorch version on the card, over a
   1<<20-counter table with numpy-seeded Zipf-0.99 batches: bit-exact
   outputs and final table, then median times (CUDA events), the plain
   version's time, the bytes bound at 3.35 TB/s and, where one PyTorch
   call computes the same function, that call's time. B1 in both its
   kernels at H = 8, 64, 128, 256, 512, 1024, 8192 and 16,384 (the
   thread-block cluster, the route from 1,024 to 16,384 hits, beside the
   one-block kernel, the route below and above) and at 32,768 (the
   one-block kernel alone), with the fixpoint's sweep count of each
   batch. The heavy-hitter drain (B5): its one-pass kernel and its host
   form (``drain_top_hits_host``: one launch answering into the
   context's mapped buffer) on Zipf, sparse, zero, uniform random,
   all-equal, ascending and INT_MIN/INT_MAX columns at k in (1, 7, 64, 1000, 1024), over
   1<<20 and 1<<10 cells, and k past 1024 (the full sort) up to C;
   timed on Zipf (kernel, device-tensor call, host form, plain, topk +
   zero_) and on the ascending, uniform random ("wide") and
   INT_MIN/INT_MAX columns at k = 64 and 1024. B3b also in its host form (the storage's numpy list in the
   kernel's parameter block) at n = 1, 8, 6600 and 9100, timed beside
   the parent's path for the same list (pinned upload, device-tensor
   launch) and index_fill_. The lease credit
   (B4c) runs with its edge rows; the replicated check (B6a)
   in both its kernels (the cluster with the gossip hooks at 1024, 8192
   and 16,384 hits, the one block at 8 to 32,768) and the update (B6b)
   over remote lanes with live and expired sums, bucket floors and sums
   past 2^31 (and B6a with zero lanes against B1's kernel of the same
   route), the
   remote-sum scatter (B6c) over unique slots, the tier promotion seed
   (B4d) at the promotion path's n = 1 and at larger batches with padding
   and a nonzero scratch row, the device-scalar epoch rebase (B4b) with
   shifts 0, 1, 999,000 and 2^31 - 1. B4d and B7b also in their host
   forms (the storage's numpy lists in the kernel's parameter block),
   each call timed from the list to the launched kernel beside the
   parent tree's path for the same list (pad, pinned upload, launch).
   B3a's host form (the list in the parameter block, the answers stored
   into the context's mapped host buffer, one wait) at n = 1, 8, 1000,
   8001 and 32,768, and B6c's (the rows by value within one parameter
   block, staged past it; both designs alone too) at n = 8, 1024, 12,288
   and 65,536: bit-exact with their plain versions, each timed by CUDA
   events, the kernel alone by the profiler, the wrapper's host time
   (time.perf_counter_ns) split into its steps at the main path's
   shapes, beside the parent's path from the same host list (B3a: pad,
   pinned upload, launch, two downloads; B6c: three-pass pack, three
   pinned uploads, launch) and the library path (B3a: index_select of
   both columns from an upload, then .cpu(); B6c: index_copy_ of both
   lanes stacked, from uploads). B7a in its four variants at 8, 1024
   and 2048 hits a row over the phase-10a table on both routes (the
   thread-block clusters and one block a row) and coupled at 4096 a row
   on the rows route. B7c's host form (``sharded_update_host``: the
   storage's list of (row, slot, delta, window, flags) entries by value,
   sorted by cell in one block) at 1, 2, 8, 64 and 1999 to 2001 entries
   (the parameter block's capacity, 2000, and one staged copy past it)
   with repeated cells, buckets and windows mixed, deltas at the caps
   and a fresh entry after a non-fresh one on one cell at the capacity's
   boundary: bit-exact with the JAX-shaped plain version on the padded
   columns, timed beside the parent's path for the same list (pad,
   pinned uploads, the device-tensor launch). B6b's host form
   (``replicated_update_host``: B7c's body on a replicated node's list
   with the remote TAT floor) the same way at 1, 2, 8, 64, 2000 and 2001
   entries, and B2's (``update_host``: a storage's list, B7c's body on
   the one-row table) at B7c's counts against B2's plain version on the
   padded columns, beside the parent's path (pad to 8, pinned uploads,
   update_batch with its workspace), and at the shared authority's
   flushes (100 and 4,096 counters, each once: an ApplyDeltas' update
   and its B3a read, timed from the list to the answers, the update's
   kernel alone by the profiler). B4c's host form (``credit_host``:
   the broker's list by value, one thread an entry, staged past 2000)
   at 1, 64, 1024, 1963 (phase 7b's largest settle), 2000, 2001 and
   6000 entries with the edge rows, twice in a row on one context,
   against its plain version on the padded columns and its plain twin,
   beside the parent's path (pad, stack, pinned uploads, credit_batch).
   B7d (one launch of B5's one-pass kernel over the rows, at
   the kernel's own blocks a row, 32 up to k = 256 and 16 past it, and
   forced to 32 and to 16; and its host form
   ``sharded_drain_top_hits_host``, the rows' answers in the context's
   mapped buffer, twice in a row on one context) on the seven column
   kinds at k in (1, 7, 64, 1000, 1024, 1025) over [8, 1<<17 + 1] and
   [3, 1<<10 + 1]; timed on Zipf, uniform random and INT_MIN/INT_MAX
   columns at k = 64 and 1024 at the rule and both block counts (call,
   kernel alone, plain, topk(dim=1) + zero_), and the host form at k =
   64.
4. The main path: the port's gRPC server on the card (capacity 1<<20)
   answers Envoy ShouldRateLimit and Kuadrant CheckRateLimit/Report over a
   real channel, with a hot reload and an epoch rebase; every answer is
   held against the port's InMemoryStorage on the same sequence, and every
   kernel of that path must have launched during the run (B2 through its
   host form only, update_host).
5. A short drive: 8192-hit batches through TorchStorage.check_many over
   1M Zipf-0.99 keys, then one batch of 32,768 hits (past the cluster's
   capacity: the one-block B1); decisions per second of the 8192-hit
   batches beside the card's name, every decision against serial order,
   and B1's launches by route (the 8192-hit batches must take the
   cluster, the large one the one-block kernel).
6. The native main path: the same step list against the server with
   --pipeline native --native-hot-lane on --lease-mode off --usage-topk 64
   (ShouldRateLimit through the C++ host lane and begin_check_columnar,
   the usage observatory draining through B5), held against the oracle.
7. The native drive: NativeRlsPipeline.decide_many at capacity 1<<20,
   8192-blob batches over 1M Zipf-0.99 users, one limit of 100 per hour:
   (a) leases off, every row against serial order, then the usage
   observatory's top-64 against a host tally; (b) leases on, the
   over-admission bound and token conservation after every refresh, then
   a forced settle through B4c's host form (credit_host, one launch) and
   every user's device value against its admitted count; the credit rows
   of every settle are printed.
8. The replicated topology: (a) three TorchReplicatedStorage nodes on the
   card (capacity 1<<20 each, frozen clock) take 8192-hit batches in turn
   over 1M Zipf-0.99 users, a loopback broker completing the gossip
   between batches: every row against serial order, and the whole drive
   against the same drive on three CPU nodes (rows and all five arrays);
   (b) three nodes built by the server's own code with real gossip
   brokers on localhost answer 2,000 sequential calls round-robin: every
   node's view exact after five gossip periods, spent users refused on
   every node, over-admission and per-node latency recorded. A replicated
   node must launch B6a/B6b/B6c and never B1/B2, B6b through its host
   form only (replicated_update_host); 8a's 8192-hit batches
   take B6a's cluster, 8b's small ones its one block, and both phases
   print B6a's calls by route and hits. Phase 8a splits the
   B6c flush's host time into the pack and the C call, with the B6c
   launches a flush, and records the B3b launches and the gossip's host
   ms a batch: the clears of a merge's adoptions are staged and reach
   the card through B3b's host form only, one launch per flush.
9. Tiers: (a) TieredStorage (capacity 1<<20, hot set 1<<16) on the card,
   frozen clock, 40 batches of 8192 one-hit requests through check_many
   over 1<<22 Zipf-0.99 users (20% to a token bucket), a TierManager
   round (batch 1024) after every fourth batch, one round killed between
   its phases, and a lull of rounds without traffic half-way until one
   promotes: every row against an InMemoryStorage fed the same requests,
   the final counters against its get_counters, B4d and B3a launched;
   (b) a server built by server.start with --tier-mode on --pipeline
   native --cache-size 256 --tier-migrate-interval 0.2 answers 2,000
   sequential calls over 600 users, leases off (every answer equal to a
   memory server's), on with the usage observatory off (no user over
   the limit, token conservation, reclaim_slots settled tokens), and on
   with the default observatory (--usage-topk 64: no user over the limit,
   token conservation), with no tier failure. Phase 9a reports the host
   time of one eviction peek.
   Phases 8a, 8b, 9a and 9b fail unless every B3a, B6c and B3b of their
   main path went through its host form (the launch counts' own keys,
   read_slots_host, apply_remote_host and clear_slots_host) and none
   through the device-tensor wrapper.
10. The sharded table: (a) TorchShardedStorage(n_shards=8,
   local_capacity=1<<17, global_namespaces=["tenants"], global_region=1024)
   on the card, frozen clock stepped past one window half way, 8 batches
   of 8192 requests of each kind through check_many: lean (100 per hour
   per user over 1M Zipf-0.99 users), coupled (per user and per (user,
   route of 16)), global (1000 per minute per tenant over 4096 Zipf
   tenants, more than the region holds) and mixed; the lean and coupled
   answers and counters against an InMemoryStorage, the whole drive (every
   answer, a B7d drain and all three [8, L+1] arrays after a
   delete_counters) against the same drive on the CPU, and the global
   over-admission per batch within (n - 1) x the budget left, and at
   most one B7b flush a staging pass and one a finish (staging split
   into the clears and the rest, global evictions beside B7b launches);
   (b) the server with sharded --global-namespaces tenants --pipeline
   compiled (one row on one card) answers 2,000 sequential
   ShouldRateLimit, CheckRateLimit and Report calls with a hot reload that
   drops a limit, each answer equal to a memory server's, p50 and p99
   recorded. B7a in all four variants, B7b, B7c and B7d must launch there,
   B7a on both its routes (10a must take the cluster), B7c and B7d
   through their host forms only (10a's and 10b's drains through
   sharded_drain_top_hits_host); both phases print
   B7a's calls by route, variant and shape.
11. The HTTP API on the card: server.start with torch --device cuda
   --capacity 1<<20 --usage-topk 64 --limit-name-in-labels and a
   one-label CEL --metric-labels map, beside a memory server with the same
   options, on one frozen clock; 2,000 sequential HTTP calls to each
   through http.client with keep-alive (60% POST /check_and_report, half
   with draft-03 headers, 20% /check, 20% /report; users Zipf-0.99 over
   1<<20 ids; 5 a minute per user, fixed window, and 3 per 10 s per
   (user, route of 16), token bucket; a hot reload that drops the bucket
   at call 1,000): every status and X-RateLimit header equal to the memory
   server's, /counters equal, the authorized_calls, authorized_hits and
   limited_calls samples equal, the occupancy gauge equal to
   device_stats(), /debug/top?k=64 equal to a host tally of hits; B1,
   update_host, read_slots_host and drain_top_hits_host launched and no
   device-tensor B2, B3a or B5; p50 and p99 by route. The servers of
   phases 4, 6, 8b, 9b and 10b serve HTTP too: after 6's drive
   native_lane_rows equals lane_stats()["hits"]; after 9b's the lease_*
   families keep granted = admissions + returned + outstanding,
   tier_resident equals tier_stats() and /debug/tiering answers 200;
   after 10b's sharded_launches by variant equals the storage's tally.
12. The device plane: (a) phases 4 and 6 again with
   --native-trace-sample 64 --slo-budget-ms 2, every call with its own
   x-request-id: batcher_flushes equals the pipelines' own flush tally
   (the batcher's flush sizes, the compiled and native flushes counted
   apart), batcher_queue_wait's count the requests queued, every
   device_phase_latency phase's count the batches (begins counted apart),
   native_phase_hot_lookup's count the lane's begins, the SLO watchdog's
   samples the decisions recorded, device_backed 1, the flight
   recorder's request ids ones the client sent, the answers the
   oracle's; the 400 latency calls' p50/p99 by phase (queue wait,
   dispatch, host_cache, native_lane, host_stage, device_sync, unpack)
   as shares of the served p50, and the recorder's own host time;
   (b) a MicroBatcher with dispatch_chunk=1024 and =0 on 8 flushes of
   8192 phase-5 Zipf requests (and a warm-up flush): equal decisions,
   equal to serial order, B1's cluster once a chunk, the chunk counts in
   dispatch_chunk_splits, decisions/s of each; (c) POST /debug/profile
   start, 200 calls, stop on a --device cuda server: the Chrome trace
   holds CUDA kernel events named after csrc/counter_table.cu's
   kernels.
13. The control planes at their defaults (the signal bus, the serving-model
   fit, the process flight recorder): (a) a server with torch --pipeline
   native --tier-mode on --cache-size 256 beside a memory server on one
   frozen clock, 2,000 ShouldRateLimit calls over 600 Zipf-0.99 users
   (every fourth with a second descriptor, which takes the exact path
   where cold keys decide on the host), the first 1,000 one at a time,
   the rest 8 at a time (8 distinct users a group): every answer equal
   to the memory server's (reset within 1 s); the fit ingested one
   observation per recorded batch and refit, the flight recorder tapped
   the lean or native_hot lane and the cold_tier lane, /debug/signals
   carries every ControlSignals field with device_backed 1, /debug/stats
   the signals, capacity and flight sections, the tier manager prices
   with the fit's positive row coefficients (its fallbacks where they
   are not), and B1, B5 and B4d launched; (b) POST /debug/flight/trigger
   {"note": "smoke", "profile": true} on a server with --flight-profile-s
   0.5 while calls go on: the bundle is in the spool and served back by
   GET /debug/flight?name=, its profile names a Chrome trace that exists
   (its CUDA kernel events are printed) and flight_bundles and
   flight_triggers{reason="manual"} count it; (c) phases 4's and 6's
   servers with the defaults and with --flight off --model-fit off
   --usage-topk 0 in one process on one clock, 150 rounds of one call to
   each, the order alternating: byte-equal answers and counters, p50,
   p99 and the per-round difference printed as records. Every server of
   the script writes its flight bundles under the run's own temporary
   directory.
14. The host-memory storages and the shared authority: (a) a
   TorchStorage of 1<<20 counters on the card served by the port's
   AuthorityServer on 127.0.0.1:0 (warmed: apply_deltas' kernels once
   on a table of their own) and four CachedCounterStorage replicas over
   RemoteAuthority at the reference's defaults (flush 1 s, batch 100,
   10,000 cached, 350 ms timeout), each on its own thread and event
   loop and offered 1,000 requests a second, deciding 40,000 one-hit
   requests together over Zipf-0.99 users from 1<<20 keys at 100 a
   minute each; then a fifth replica (batch 4096) flushes 2,400
   distinct counters in one RPC: B2's host form past
   its 2,000-entry parameter block (the staged route). After every
   replica's final flush every counter of the table (B3a) equals an
   InMemoryStorage fed the admitted hits; flush errors 0, no partition,
   no check kernel; the over-admission (the topology's bound) printed
   beside the replicas' counter_overshoot. The same on phase 10a's
   sharded table (8 rows of 131,073 cells) with two replicas and 10,000
   requests (B7c's host form). (b) On (a)'s table, two replicas on two
   limits: the authority stops half way (after a grace period for an RPC
   in flight), the replicas decide the rest and their flushes fail
   (on_partitioned(True), no decision fails), a new AuthorityServer
   binds the same port, the held deltas arrive (partitioned False
   again) and the table equals the oracle; then DeleteCounters on one
   limit (B3b's host form; its counters gone, the other's kept) and
   Clear (empty). (c) As operators deploy it: a server process
   `torch --authority-listen 127.0.0.1:P` on the card and two `cached
   --authority-url 127.0.0.1:P` processes; 1,000 HTTP /check_and_report
   calls to each over 600 Zipf-0.99 users, each admitted hit reported to
   an in-process memory server: within 10 s of the replicas' 1 s flush
   the authority's /counters/ns equals the memory server's (remaining
   exact, expires_in within 2 s); each replica's /metrics shows
   datastore_partitioned 0, counter_overshoot, evicted_pending_writes
   and the flush aggregate in datastore_latency; the replicas' p50/p99
   (decided on their host caches, never on the card) and the
   authority's ms per RPC by stage (decode, intern, apply = kernels and
   read, encode) from its /debug/stats. (d) Phase 11's sequence (1,000
   calls, the reload half way, the 61 s step at three quarters) on one
   frozen clock to disk and distributed servers beside a memory server,
   and to a cached server over its default disk authority beside a
   memory server without the token bucket (cached refuses the policy):
   every answer equal (X-RateLimit-Reset within 1 s; an expired window's
   reset, which the memory server reads as 0 and disk and distributed as
   the whole window, as the JAX package does, counted apart) and
   /counters/web equal; a second distributed node shows the first's
   counters after gossip over real brokers.
15. The admission plane: (a) phases 4's and 6's servers with
   --admission-mode enforce (the JAX defaults) and off in one process on
   one clock, the phase's calls (reload and 13-day step included) and 150
   rounds of one call to each, the order alternating: byte-equal answers
   and counters, the breaker closed with no transition, no failover
   decision and no shed, no controller on the off server; p50/p99 on and
   off. (b) The failover drill on a table of 65,536 cells on the card,
   on AsyncTorchStorage, the native pipeline and TorchShardedStorage: a
   Python-level hang of the collect step (the context stays healthy)
   under 64 concurrent calls trips the stall watch (200 ms), 300 calls
   decide on the host oracle (a fresh 120 budget admits exactly 120), the
   unhang lets the probe launch B1 (B7a) and the reconcile B2's (B7c's)
   host form; the table equals the hits admitted by the card or the
   oracle and admission_reconciled_deltas the journal; probe and
   reconcile times. (c) --max-inflight 4: 64 concurrent calls, then 16
   with 250 ms deadlines under a forced 1 s queue-wait estimate: overload and
   deadline sheds answer UNAVAILABLE and count in admission_sheds, no
   shed answers OK, the table equals the admitted calls. (d) A cold
   start: a fresh process builds the kernels and the host lane into an
   empty directory and starts an enforce server on the card: start, nvcc
   and g++ seconds, the warm-up launch and the first calls.
16. The native HTTP/2 ingress: a torch server on the card with
   --pipeline native --native-ingress (1<<20 cells, the control planes
   at their defaults), phase 6's grpc.aio native server and a memory
   server on one frozen clock. (a) 2,000 ShouldRateLimit calls over
   Zipf-0.99 users from 1<<20 keys (every 7th unmatched, every 10th with
   a second descriptor: the exact path), one at a time to each:
   byte-equal answers, the ingress's p50/p99 beside grpc.aio's. (b) From
   16 threads on one channel: 4,000 calls for one key of max 3 (exactly
   3 OK), then 10,000 over Zipf users of max 5 (min(5, calls) OK each);
   decisions per second, the pump's rows a batch, and the card's
   counters equal the memory server's limiter fed the admitted hits.
   (c) Kuadrant CheckRateLimit/Report on the ingress port and on
   --rls-port + 1, equal at each step; a reflection stream listing both
   services; an unknown method answering UNIMPLEMENTED. (d) /metrics:
   ingress_requests equal to the calls sent, ingress_protocol_errors 0,
   native_phase_h2i_respond counted; B1 on the card by route and shape,
   B2's host form by the Reports.
17. Serving shards and the routed pod: (a) a torch server on the card
   with --serving-shards 4, on the standard and then the native
   pipeline, answers 1,000 serial ShouldRateLimit calls over Zipf-0.99
   users from 1<<20 keys on 8 channels (one connection each) as an
   in-memory oracle on its frozen clock does, and admits exactly 3 of
   2,000 calls for one key of 3 from 16 threads; the loops that decided
   (the server's per-loop shards) and p50/p99 beside the same calls on a
   --serving-shards 1 server. (b) Two server processes on the card
   (--pod-processes 2, a TCPStore on localhost), once on sharded (a
   global namespace pinned) and once on torch: POD_CALLS sequential calls
   over Zipf users (a one-limit namespace routed by key, a two-limit one
   pinned, the global one) alternate between the hosts' RLS ports;
   every answer and the union of the hosts' /counters equal a
   single-process 2-row TorchShardedStorage on the card (on torch, an
   in-memory oracle) fed the same calls; pod_routed_local, _forwarded
   and _pinned equal the requests' verdicts and are each above 0;
   p50/p99 by verdict and the hop's phase split (/debug/pod). (c) On the
   torch pod, --pod-psum-lane on: 400 calls for one tenant of a
   fixed-window global namespace of 100, hosts alternating, exchange
   every 100 ms: admitted at least the limit, past it at most each
   host's admissions within two intervals, and after a final exchange
   both hosts limit. (d) On the torch pod: host 1 is killed mid-drive;
   host 0's calls for host 1's keys are answered (no error) by the
   stand-in, a fresh window each, and its breaker opens; host 1
   restarts on the same address with an empty table, the journal
   replays through apply_deltas (B2's host form), and host 1's counters
   for the keys born in the partition equal the oracle's (older keys
   within one extra window); trip, restart, probe and replay times. The
   pod's members are processes of their own, each writing its kernel
   launch counts when it exits, and the member killed in (d) just
   before (B1, B7a on both routes, B2's host form must launch there).
18. The native pod fast path: 17b's harness (POD_LIMITS, the psum lane
   on gpsum, seed 1718) with torch storage and --pipeline native
   --native-hot-lane on --rate-limit-headers NONE, so that each member's
   C hot lane stages its own rows for B1 on its table and sends each
   flush's foreign rows to their owner in one bulk_decide, where the
   owner's hot lane decides them with B1 on its table. (a) 17b's 4,000
   sequential calls alternating hosts: every answer equal to the
   in-memory oracle's, and the union of the hosts' spent /counters equal
   to its counters (the unspent ones, value 0, each of a denied request:
   the native lanes allocate a request's counters before its check); the
   requests' verdicts, pod_hot_local_rows/_foreign_rows,
   pod_bulk_forward_batches/_rows and rows a bulk forward; p50/p99 by
   verdict beside 17b torch's. (c) On the same pod, half of 400 more
   such calls alternating hosts (answers equal to the oracle), host 1
   killed, the other half all to host 0: no call fails, host 0's own
   keys still equal the oracle, and every call for host 1's keys is
   decided by the frontend's degraded stand-in (its bulk hop answering
   all-None: pod_failover_degraded_decisions counts each) as a fresh
   in-memory oracle of those calls decides them; host 1 restarts, its
   journal replays through B2's host form and its counters equal that
   oracle's. (b) A second pod with --native-ingress: 1,500 calls of the
   same population (the two-limit namespace's total of 400 never
   reached, so that no answer depends on the order) from 16 threads of
   a client process alternating the hosts' ingresses: each counter
   admits min(limit, its calls), the union of the spent counters equals
   the oracle's, rows a bulk forward, decisions/s and p50/p99. (d) A
   third pod with --flight-sample 1 (every decision in the flight rings;
   the other pods sample as 17b's do): 300 such serial calls (answers
   equal to the oracle), then a trigger on host 0 (POST
   /debug/flight/trigger): its bundle holds host 1's rings over the
   window, one of whose pod_forward entries shares a request id with
   host 0's. B1 must launch on both members of the first two pods, B2's
   host form in (c)'s replay.
19. The elastic pod: (a) two native torch members with --pod-resize on
   and a --standby on process: calls, the standby's join (calls during
   it for users whose slices do not move), calls over three hosts, every
   answer and spent counter the oracle's, each on its owner; (b) the
   drain back to two; (c) a join whose new host is killed mid-migration
   reverts with nothing lost; (d) a grow on the sharded table.
20. The capacity controller and redis_import: (a) three native torch
   servers with leases, the usage observatory and --admission-mode
   enforce, --capacity-controller off, observe and on (ticking every
   0.2 s against a 0.01 ms SLO budget the card misses), under one load
   of Zipf-user bursts: observe's answers and settled counters
   byte-equal with off's; on's applied knobs inside their KnobSpec
   envelopes, read back by the subsystems as its /debug/stats controller
   section says; on's counters equal an oracle of the hits it admitted,
   every other call an OVER_LIMIT or an admission shed counted in
   admission_sheds; the ctl_* families on all three; each knob's path
   over the ticks; B1, B4c's and B5's host forms launched. (b) Phase
   19's pod with member 0 in this process, where a controller runs on
   over its coordinator (the standby's address its pool, 2 to 3 hosts),
   ticked with injected calm, burn, ramp and idle snapshots, calls
   throughout: one grow by join and one drain, no flap, no failed call,
   every answer and spent counter the oracle's, each on its owner,
   controller_actuation < join_begin < epoch_bump < join_end, the
   standby's address back in the pool; B1 and B2's, B3a's and B3b's host
   forms on every member. (c) tools/redis_import.py replays a dump of
   1,000 counters (and 100 of limits whose conditions read fields that
   are not their counter's variables, the kubernetes configmap's shape
   among them, with expired and nil lines) into a torch server on the
   card: /counters equals the replayable entries, the others counted and
   not sent; B2's host form launched.
21. The port's correctness tooling on this box, which has no JAX (so
   the run also proves the tooling imports none): ``python -m
   limitador_tpu_torch.tools.analysis --all`` must exit 0 (style, the
   registries, the ctypes ABI of the hp_/h2i_/ct_ exports, buffer
   safety, lock order, host syncs), while g++ builds the race-hunt
   drivers (csrc/race_hunt_hostpath.cc under tsan, asan and ubsan,
   csrc/race_hunt_h2i.cc under tsan) together; each runs for
   HUNT_MS and fails the phase on a sanitizer report, on a missing
   RACE_HUNT_OK line, or (the host lane) on an export of
   tools/race_hunt.HOSTPATH_EXPORTS called zero times or no foreign row
   split. A variant whose runtime the box's g++ lacks (a two-line
   probe) is left out with the reason printed. One line a variant:
   seconds to build, seconds to run, operations.

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or limitador_tpu.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import io
import itertools
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
C = 1 << 20
NEVER = (1 << 31) - 1
HS = (8, 1024, 8192, 32768)
# B1: both kernels up to the cluster's capacity, the one block past it;
# 64 to 512 place the smallest batch where the cluster route pays
B1_HS = (8, 64, 128, 256, 512, 1024, 8192, 16384, 32768)
# B3b's host form: a few slots, and flushes of a merge's adoptions (phase
# 8a's carry about 6,600 slots on average and up to about 9,100, past one
# parameter block; PERF.md §6)
CLEAR_HOST_NS = (1, 8, 6600, 9100)
READ_NS = (8, 1024, 32768)
CREDIT_HS = (8, 1024, 4096)
DRAIN_KS = (64, 1, 7, 1000, 1024)
DRAIN_KINDS = ("zipf", "sparse", "zero", "wide", "equal", "ascending",
               "extremes")
DRAIN_SMALL_C = 1 << 10
# B7c's host form: Report sizes, and the parameter block's capacity
# (2000 entries with nvcc 12.1 or later) and one past it
UPDATE_HOST_COUNTS = (1, 2, 8, 64, 1999, 2000, 2001)
# B2's host form with B3a's read at the shared authority's flushes
# (phase 14): a replica's batch size (100) and a batch of 4096, past the
# parameter block (the staged route)
AUTHORITY_FLUSHES = (100, 4096)
# B2's host form runs the same counts as B7c's (an update_counter is one
# entry); B4c's: the credit rows of phase 7b's largest settle
# (CREDIT_SETTLE_ROWS, the shape of the JSON line; the phase prints its
# settles' rows: 1,327, 1,963 and 89 on the H100, PERF.md §6), 1, 64,
# 1024, the parameter block's capacity and past it
CREDIT_SETTLE_ROWS = 1963
CREDIT_HOST_COUNTS = (CREDIT_SETTLE_ROWS, 1, 64, 1024, 2000, 2001, 6000)
# B6b's host form: a served node's Reports (one or two counters), and
# the same capacity and one past it
REPLICATED_HOST_COUNTS = (1, 2, 8, 64, 2000, 2001)
# B6c's n: phase 8a's flushes gather two other nodes' batches, about
# 12,288 dirty slots (PERF.md), the shape its JSON row reports
REMOTE_NS = (8, 1024, 8192, 12288, 65536)
# Host staging on the H100's machine takes about 0.35 s per 8192-hit batch
# on the standard path (NVIDIA H100 80GB HBM3, 700 W; PERF.md). Phases 5,
# 7 and 8a were cut (from 100, 100 and 30 batches) when phase 10 came in,
# so that the whole run stays near 260 s, well inside half its 1200 s
# limit: 50 batches of the standard drive and of each native drive, and
# 25 since phase 17 came in (the script aims at half its limit).
DRIVE_BATCHES = 25
# ...then one batch past the cluster's capacity (the one-block B1)
DRIVE_BIG_HITS = 32768
NATIVE_BATCHES = 25
# Phase 12b: 8 flushes of 8192 requests (65,536 decisions) a setting,
# after one warm-up flush each
CHUNK_FLUSHES = 8
# Phase 8a runs its drive twice, on the card and replayed on the CPU, with
# Python gossip merges between batches: 16 batches (131,072 decisions).
REPLICATION_BATCHES = 16
# Phase 9a: 40 batches of 8192 hits (327,680 decisions) reach about 124k
# distinct users over 1<<22, about twice the 1<<16 hot set (30 batches
# promoted nothing: its gate needs B4d's launches).
TIER_BATCHES = 40
# Phase 10a: 8 batches of 8192 requests of each of the four kinds (262,144
# decisions), run on the card and replayed on the CPU.
SHARDED_BATCHES = 8
SEED_NS = (1, 5, 1000)
KERNEL_SOURCE = "limitador_tpu_torch/csrc/counter_table.cu"
REPLACES = {
    "check_and_update": "limitador_tpu/ops/kernel.py:153",
    "check_and_update_cluster": "limitador_tpu/ops/kernel.py:153",
    "update": "limitador_tpu/ops/kernel.py:433",
    "read_slots": "limitador_tpu/ops/kernel.py:651",
    "clear_slots": "limitador_tpu/ops/kernel.py:662",
    "rebase_epoch": "limitador_tpu/ops/kernel.py:688",
    "rebase_epoch_device": "limitador_tpu/ops/kernel.py:700",
    "credit": "limitador_tpu/ops/kernel.py:580",
    "seed_slots": "limitador_tpu/ops/kernel.py:626",
    "drain_top_hits": "limitador_tpu/ops/kernel.py:673",
    "replicated_check": "limitador_tpu/tpu/replicated.py:55",
    "replicated_check_cluster": "limitador_tpu/tpu/replicated.py:55",
    "replicated_update": "limitador_tpu/tpu/replicated.py:96",
    "apply_remote": "limitador_tpu/tpu/replicated.py:120",
    "sharded_check_and_update": "limitador_tpu/parallel/mesh.py:399",
    "sharded_check_and_update_cluster": "limitador_tpu/parallel/mesh.py:399",
    "sharded_clear_cells": "limitador_tpu/parallel/mesh.py:507",
    "sharded_update": "limitador_tpu/parallel/mesh.py:552",
    "sharded_drain_top_hits": "limitador_tpu/parallel/mesh.py:589",
}
# the shape each kernel sees on the main path, for the JSON line (B1: the
# cluster at the drives' 8192 hits, the one block at the served paths'
# 8 (it also takes phase 5's 32,768-hit batch); B3b: the host
# form at a phase-8a flush; B4c: the host form at rows of a lease
# settle; B5: the host
# form at k of the default --usage-topk; B6c: rows of a phase-8a flush;
# B4d: one promoted key; B4b: no caller, the whole column as B4a)
MAIN_SHAPE = {
    "check_and_update": 8, "check_and_update_cluster": 8192,
    # B2: the host form at one entry (an update_counter, a one-counter
    # Report; "host/8" beside it in the JSON line's host_forms)
    "update": "host/1", "read_slots": 8, "clear_slots": "host/6600",
    "rebase_epoch": C + 1, "rebase_epoch_device": C + 1,
    "credit": f"host/{CREDIT_SETTLE_ROWS}", "seed_slots": 1,
    "drain_top_hits": "host/64",
    # B6a: the cluster at phase 8a's 8192 hits, the one block at the
    # served nodes' 8 (phase 8b)
    "replicated_check": 8, "replicated_check_cluster": 8192,
    # B6b: the host form at a served node's one-counter Report (phase 8b)
    "replicated_update": "host/1", "apply_remote": 12288,
    # B7 over the phase-10a table, 8 rows of 1<<17 cells: B7a's cluster
    # at 2048 hits a row in its coupled + global variant (the mixed
    # batches), its rows route at 4096 coupled (past the cluster: the
    # coupled batches' busiest row), B7b at 64 slots a row, B7c's host
    # form at a Report of 8 counters, B7d's host form at k = 64
    "sharded_check_and_update_cluster": "coupled+global/2048",
    "sharded_check_and_update": "coupled/4096",
    "sharded_clear_cells": 64, "sharded_update": "host/8",
    "sharded_drain_top_hits": "host/64",
}
# B7: the phase-10a table and the shapes held against the plain versions
SHARDS = 8
LOCAL_CAP = 1 << 17
GLOBAL_REGION = 1024
SHARDED_HS = (8, 1024, 2048)
# B7a's rows route past the cluster: phase 10a's coupled batches (8 x
# 4096), timed on that route alone
SHARDED_ROWS_HS = (4096,)
# B6a: both kernels up to the cluster's capacity, the one block past it
B6A_HS = (8, 1024, 8192, 16384, 32768)
B7A_VARIANTS = ((False, False), (True, False), (False, True), (True, True))
# kernels each main-path phase must launch (B1 by the batch's hits: the
# served phases' small batches take the one-block kernel, the drives'
# 8192-hit batches the cluster)
PHASE4_KERNELS = ("check_and_update", "update", "read_slots",
                  "clear_slots", "rebase_epoch")
PHASE6_KERNELS = PHASE4_KERNELS + ("drain_top_hits",)
PHASE7_KERNELS = ("check_and_update_cluster", "read_slots", "credit",
                  "drain_top_hits")
# a replicated node checks through B6a and updates through B6b, never B1/B2
PHASE8A_KERNELS = ("replicated_check_cluster", "apply_remote",
                   "read_slots", "clear_slots")
PHASE8B_KERNELS = ("replicated_check", "replicated_update", "apply_remote",
                   "read_slots")
PLAIN_KERNELS = ("check_and_update", "check_and_update_cluster", "update",
                 "update_host")
# tiers: evictions and demotions peek through B3a, promotions seed
# through B4d; with leases, demotions settle through B4c
PHASE9A_KERNELS = ("check_and_update_cluster", "read_slots", "seed_slots")
PHASE9B_KERNELS = ("check_and_update", "read_slots", "seed_slots")
PHASE9B_LEASE_KERNELS = PHASE9B_KERNELS + ("credit",)
PHASE9B_SERVED_KERNELS = PHASE9B_KERNELS + ("drain_top_hits",)
# B2, B3a, B4c, B6c, B3b, B5, B6b, B7c and B7d count their host forms
# (the storages' path) under keys of their own: a phase launched one
# when either count moved, and no storage path (phases 4 and 6 to 10b)
# launches one through its device-tensor wrapper (_storage_forms,
# _host_forms_only)
HOST_FORMS = {"update": "update_host",
              "credit": "credit_host",
              "read_slots": "read_slots_host",
              "apply_remote": "apply_remote_host",
              "clear_slots": "clear_slots_host",
              "drain_top_hits": "drain_top_hits_host",
              "replicated_update": "replicated_update_host",
              "sharded_update": "sharded_update_host",
              "sharded_drain_top_hits": "sharded_drain_top_hits_host"}
READ_HOST_NS = (1, 8, 1000, 8001, 32768)
REMOTE_HOST_NS = (8, 1024, 12288, 65536)
# the sharded paths: 10a and 10b together must launch all five (B7a's
# two routes)
SHARDED_KERNELS = ("sharded_check_and_update",
                   "sharded_check_and_update_cluster",
                   "sharded_clear_cells", "sharded_update",
                   "sharded_drain_top_hits")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _http_options():
    """(--http-host/--http-port options on a free local port, the port):
    every server of this script serves the HTTP API beside gRPC."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return ["--http-host", "127.0.0.1", "--http-port", str(port)], port


def _http_get(port, path):
    """(status, body) of one GET, from a thread off the servers' loop."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


async def _served_get(port, path):
    status, body = await asyncio.get_running_loop().run_in_executor(
        None, _http_get, port, path)
    if status != 200:
        fail(f"GET {path} on port {port} answered {status}")
    return body


async def _served_metrics(port):
    """The /metrics families of the server on ``port``, by name."""
    from prometheus_client.parser import text_string_to_metric_families

    text = (await _served_get(port, "/metrics")).decode()
    return {f.name: f for f in text_string_to_metric_families(text)}


def _histogram(families, name):
    """count, mean ms and the upper bucket edges (ms) holding the 50th
    and 99th percentile of a latency histogram's samples."""
    fam = families[name]
    count = [s.value for s in fam.samples if s.name == name + "_count"][0]
    total = [s.value for s in fam.samples if s.name == name + "_sum"][0]
    buckets = sorted((float(s.labels["le"]), s.value) for s in fam.samples
                     if s.name == name + "_bucket")

    def edge(q):
        return next((le * 1e3 for le, n in buckets if n >= q * count),
                    None)

    return {"count": int(count),
            "mean_ms": total / count * 1e3 if count else None,
            "p50_le_ms": edge(0.5), "p99_le_ms": edge(0.99)}


def _metric(families, name, **labels):
    """The sum of a family's samples (counter totals) with ``labels``."""
    return sum(s.value for s in families[name].samples
               if s.name in (name, name + "_total")
               and all(s.labels.get(k) == v for k, v in labels.items()))


def _registry_total(metrics, family):
    """The sum of a counter family's samples in a PrometheusMetrics."""
    return int(sum(s.value for m in metrics.registry.collect()
                   if m.name == family for s in m.samples
                   if s.name == family + "_total"))


def _launched(run, name):
    """Launches of a kernel in one run's counts, its host form's too."""
    return run[name] + run.get(HOST_FORMS.get(name), 0)


def _host_forms_only(run, label, remote):
    """``_storage_forms``, and B3a's host form (on a replicated path
    B6c's too) must have launched."""
    _storage_forms(run, label, ("read_slots_host",) + (
        ("apply_remote_host",) if remote else ()))


def _storage_forms(run, label, need=()):
    """Fail unless every B2, B3a, B4c, B6c, B3b, B5, B6b, B7c and B7d of
    the run went through its host form, or if a host form in ``need``
    did not launch."""
    device = [name for name in HOST_FORMS if run[name]]
    if device:
        fail(f"{label}: launched through the device-tensor wrapper, not "
             f"the host form: {device}")
    missing = [name for name in need if run[name] == 0]
    if missing:
        fail(f"{label}: host forms not launched: {missing}")


@contextlib.contextmanager
def _route_tally(label):
    """Count B6a's and B7a's card calls by route and shape while the block
    runs (the storages look both wrappers up on their modules at each
    call), then print them under ``label``; yields the counts. The
    launch counts stay the wrappers' own."""
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.parallel import mesh as M

    counts = {}
    b6a, b7a = K.replicated_check_batch, M.sharded_check_and_update

    def add(key):
        counts[key] = counts.get(key, 0) + 1

    def replicated(state, remote_vals, remote_exp, slots, *args,
                   route=None):
        if state.values.is_cuda:
            H = slots.shape[0]
            add(f"B6a {route or K.check_route(H)} H={H}")
        return b6a(state, remote_vals, remote_exp, slots, *args,
                   route=route)

    def sharded(state, slots, *args, global_region=1024, coupled=True,
                has_global=True, route=None):
        if state.values.is_cuda:
            n, H = slots.shape
            taken = route or M.sharded_check_route(n, H, coupled,
                                                   has_global)
            variant = ("coupled" if coupled else "lean") + (
                "+global" if has_global else "")
            add(f"B7a {taken} {variant} {n}x{H}")
        return b7a(state, slots, *args, global_region=global_region,
                   coupled=coupled, has_global=has_global, route=route)

    K.replicated_check_batch, M.sharded_check_and_update = replicated, sharded
    try:
        yield counts
    finally:
        K.replicated_check_batch, M.sharded_check_and_update = b6a, b7a
        print(f"{label}: B6a/B7a card calls by route and shape: "
              f"{json.dumps(dict(sorted(counts.items())))}")


def zipf_keys(n_keys: int, n_samples: int, s: float, rng) -> np.ndarray:
    """Bounded Zipf(s) over [0, n_keys) by inverse-CDF over rank weights
    (the drive of the JAX package's bench, bench.py zipf_keys)."""
    w = 1.0 / np.arange(1, n_keys + 1, dtype=np.float64) ** s
    cdf = np.cumsum(w)
    u = rng.random(n_samples) * cdf[-1]
    return np.searchsorted(cdf, u).astype(np.int32)


# -- phase 1 ----------------------------------------------------------------


def phase_card():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(f"device: {name}  compute capability {cap[0]}.{cap[1]}  "
          f"count {torch.cuda.device_count()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"nvidia-smi: {card}")
    if cap != (9, 0):
        fail(f"compute capability {cap}, expected (9, 0)")
    return name, card


# -- phase 2 ----------------------------------------------------------------


def phase_build():
    """nvcc (the CUDA kernels), g++ (the host lane) and g++ (the native
    ingress) run together."""
    from concurrent.futures import ThreadPoolExecutor

    from limitador_tpu_torch import native
    from limitador_tpu_torch.native import build as host_build
    from limitador_tpu_torch.ops import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(build.library), pool.submit(host_build.library),
                pool.submit(host_build.ingress_library)]
        for job in jobs:
            job.result()
    info = build.build_info
    host = host_build.build_info
    ingress = host_build.ingress_build_info
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1] if nvcc else 'unknown'}; a host list carries "
          f"{build.library().ct_host_list_capacity(0)} int32 in one "
          f"kernel parameter block")
    print(f"build: {time.perf_counter() - t0:.2f}s "
          f"(nvcc {info['seconds']:.2f}s, built={info['built']}; "
          f"g++ {host['seconds']:.2f}s, built={host['built']}; "
          f"g++ ingress {ingress['seconds']:.2f}s, "
          f"built={ingress['built']}) "
          f"-> {os.path.relpath(info['path'])}, "
          f"{os.path.relpath(host['path'])}, "
          f"{os.path.relpath(ingress['path'])}")
    if not (native.lane_available() and native.lease_available()):
        fail("the host lane lacks its hot-lane or lease exports")
    for line in info["ptxas"]:
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  {line}")


# -- phase 3 ----------------------------------------------------------------


def _table(rng, now_ms, lanes):
    values = rng.integers(0, 60, C + 1).astype(np.int32)
    expiry = rng.integers(0, 2 * now_ms, C + 1).astype(np.int32)
    hits = rng.integers(0, 1000, C + 1).astype(np.int32)
    for slot, (is_bucket, maxv, win) in lanes.items():
        if is_bucket:
            expiry[slot] = max(now_ms + int(rng.integers(-3, maxv + 4)) * win,
                               0)
    values[C] = expiry[C] = hits[C] = 0
    return values, expiry, hits


def _lane(rng):
    if rng.random() < 0.3:
        return True, int(rng.integers(1, 20)), int(rng.integers(1, 500))
    return False, int(rng.choice([1, 3, 10, 50, 1000])), int(
        rng.choice([1000, 60_000]))


def _batch(rng, H, lanes):
    """Request-ordered hits over Zipf-0.99 slots, 1-3 hits per request
    on distinct slots (as a storage stages them), fresh (recycled) slots,
    bucket lanes and padding rows."""
    n_real = int(rng.integers(max(H // 2, 1), H + 1))
    keys = zipf_keys(C, n_real, 0.99, rng)
    cols = [[] for _ in range(7)]
    seen = set()
    r = i = 0
    while i < n_real and r < H - 1:
        mine = set()
        for _ in range(min(int(rng.integers(1, 4)), n_real - i)):
            s = int(keys[i])
            i += 1
            if s in mine:
                # a request's counters are distinct, so are their slots;
                # two hits of one request on one slot can make the
                # fixpoint flip that request every sweep, to the cap
                continue
            mine.add(s)
            if s not in lanes:
                lanes[s] = _lane(rng)
            is_bucket, maxv, win = lanes[s]
            for col, v in zip(cols, (
                s, int(rng.choice([0, 1, 1, 1, 2, 5, 7])), maxv, win, r,
                s not in seen and rng.random() < 0.15, is_bucket,
            )):
                col.append(v)
            seen.add(s)
        r += 1
    pad = H - len(cols[0])
    fills = (C, 0, NEVER, 0, H - 1, False, False)
    dtypes = (np.int32,) * 5 + (bool,) * 2
    return tuple(
        np.asarray(col + [fill] * pad, dt)
        for col, fill, dt in zip(cols, fills, dtypes)
    )


def _seed_rows(rng, H, n, now_ms):
    """A B4d batch: n unique real slots with absolute values and
    expiries (0, INT32_MAX, window ends, bucket TATs with value 0), padded
    to H with scratch rows."""
    slots = rng.choice(C, n, replace=False).astype(np.int32)
    values = rng.integers(0, 1 << 30, n).astype(np.int32)
    expiry = rng.integers(0, 2 * now_ms, n).astype(np.int32)
    edge = rng.random(n)
    expiry[edge < 0.1] = 0
    expiry[(edge >= 0.1) & (edge < 0.2)] = NEVER
    values[(edge >= 0.2) & (edge < 0.4)] = 0
    pad = H - n
    return (np.concatenate([slots, np.full(pad, C, np.int32)]),
            np.concatenate([values, np.zeros(pad, np.int32)]),
            np.concatenate([expiry, np.zeros(pad, np.int32)]))


def _credit_rows(rng, H, now_ms, base, n_real=None):
    """An H-row lease-credit batch over the 1<<20 table ``base`` (numpy
    columns, changed in place): unique slots from the Zipf head and tail,
    live buckets a few intervals ahead, padding rows at the scratch row
    (an eighth of H, at least one, unless ``n_real`` rows are real), and
    the edge rows first: an expired window, an expired bucket, a
    covering credit, credit * interval beyond int32 (the wrap guard);
    the scratch row starts non-zero."""
    values, expiry, _hits = base
    values[C], expiry[C] = 77, 12345
    if n_real is None:
        n_real = max(H - max(H // 8, 1), 1)
    slots = np.unique(zipf_keys(C, 4 * n_real, 0.99, rng))
    slots = rng.permutation(slots)[:n_real]
    if slots.size < n_real:
        extra = np.setdiff1d(rng.choice(C, 2 * n_real, replace=False),
                             slots)[: n_real - slots.size]
        slots = np.concatenate([slots, extra])
    slots = slots.astype(np.int32)
    credits = rng.integers(0, 300, n_real).astype(np.int32)
    windows = rng.integers(1, 5000, n_real).astype(np.int32)
    bucket = rng.random(n_real) < 0.5
    ahead = rng.integers(0, 400, n_real) * windows
    expiry[slots] = np.where(bucket, now_ms + ahead, expiry[slots])
    edges = [
        (False, now_ms - 5, 50, 60_000),        # expired window
        (True, now_ms - 1, 3, 100),             # expired bucket
        (True, now_ms + 1000, 10, 100),         # credit covers exactly
        (True, now_ms + 1001, 9, 100),          # one short: retreats
        (True, NEVER, 1 << 30, 1 << 20),        # credit * I beyond int32
        (False, now_ms + 1, 1 << 30, 1000),     # floored at 0
    ]
    for i, (is_bucket, e, c, w) in enumerate(edges[:n_real]):
        bucket[i], expiry[slots[i]], credits[i], windows[i] = (
            is_bucket, e, c, w)
    pad = H - n_real
    return (
        np.concatenate([slots, np.full(pad, C, np.int32)]),
        np.concatenate([credits, rng.integers(0, 9, pad)]).astype(np.int32),
        np.concatenate([windows, np.zeros(pad, np.int32)]),
        np.concatenate([bucket, np.zeros(pad, bool)]),
    )


def _credit_bytes(start, rows, after, now_ms):
    """The bytes B4c must move for this batch, counted per row from its
    inputs and result (numpy): every row's 4-byte slot; a real row's
    bucket flag, credit and its cell's expiry; a live window's value
    read, and written where it changes; a live bucket's interval read,
    and its expiry written where it changes; the scratch cells' reset."""
    values, expiry = start[0], start[1]
    slots, _credits, _windows, bucket = rows
    real = slots != C
    e = expiry[slots]
    live_window = real & ~bucket & (now_ms < e)
    live_bucket = real & bucket & (e > now_ms)
    new_v = after[0][slots] != values[slots]
    new_e = after[1][slots] != e
    return int(
        4 * slots.size + 9 * real.sum()
        + 4 * live_window.sum() + 4 * (live_window & new_v).sum()
        + 4 * live_bucket.sum() + 4 * (live_bucket & new_e).sum()
        + 8
    )


def _remote_lanes(rng, now_ms, lanes, values):
    """Remote lanes (int32[C+1] each) for the lanes' slots: live and
    expired window sums up to 2^30, bucket TATs ahead of and behind now,
    empty slots; ``values`` (the table's column, changed in place) gets
    live local counts near 2^31 under a live remote 2^30, so that local +
    remote crosses 2^31."""
    rv = np.zeros(C + 1, np.int32)
    re = np.zeros(C + 1, np.int32)
    for slot, (is_bucket, maxv, win) in lanes.items():
        kind = rng.random()
        if is_bucket:
            if kind < 0.4:
                re[slot] = min(now_ms + int(rng.integers(0, maxv + 3)) * win,
                               NEVER)
            elif kind < 0.7:
                re[slot] = max(now_ms - int(rng.integers(0, 5000)), 0)
        elif kind < 0.45:
            rv[slot] = int(rng.choice([1, 2, 5, 40, (1 << 30) - 1, 1 << 30]))
            re[slot] = now_ms + int(rng.integers(1, 60_000))
        elif kind < 0.65:
            rv[slot] = int(rng.integers(1, 100))
            re[slot] = now_ms - int(rng.integers(0, 3))
        elif kind < 0.75:
            values[slot] = NEVER - int(rng.integers(0, 50))
            rv[slot] = 1 << 30
            re[slot] = now_ms + 60_000
    return rv, re


def _cell_bytes(slots, fresh, bucket, before, after, now_ms, scratch=C):
    """The table bytes a check or update must move, counted per distinct
    slot from its inputs (numpy) and the plain version's result: each
    real slot's expiry read; its value read where it is a live window
    (not fresh, not expired); its hits read unless the slot is fresh;
    each cell (scratch row included) written only where it changed."""
    distinct, first = np.unique(slots, return_index=True)
    d = distinct[distinct != scratch]
    b = bucket[first][distinct != scratch]
    f = np.isin(d, slots[fresh])
    live_window = ~b & ~f & (before[1][d] > now_ms)
    changed = sum(int((after[k][distinct] != before[k][distinct]).sum())
                  for k in range(3))
    return int(4 * d.size + 4 * live_window.sum() + 4 * (~f).sum()
               + 4 * changed)


def _check_bytes(arrays, before, after, now_ms, remote=None, scratch=C):
    """The bytes B1 (``remote`` None) or B6a must move for this batch:
    22 B of hit row in and 10 B of outputs out per row, the table cells
    (``_cell_bytes``) and, with the remote lanes, each real slot's
    remote_exp and, for a window slot whose remote lane is live, its
    remote_vals."""
    slots, bucket = arrays[0], arrays[6]
    nbytes = 32 * slots.size + _cell_bytes(
        slots, arrays[5], bucket, before, after, now_ms, scratch)
    if remote is not None:
        rv, re = remote
        distinct, first = np.unique(slots, return_index=True)
        real = distinct != C
        window_live = ~bucket[first] & (re[distinct] > now_ms) & real
        nbytes += 4 * int(real.sum()) + 4 * int(window_live.sum())
    return nbytes


def _update_bytes(upd, before, after, now_ms, remote_exp=None, scratch=C):
    """The bytes B2 or (with ``remote_exp``) B6b must move: 14 B of row in,
    the table cells (``_cell_bytes``) and each real bucket slot's
    remote_exp."""
    slots, _deltas, _windows, fresh, bucket = upd
    nbytes = 14 * slots.size + _cell_bytes(
        slots, fresh, bucket, before, after, now_ms, scratch)
    if remote_exp is not None:
        distinct, first = np.unique(slots, return_index=True)
        nbytes += 4 * int((bucket[first] & (distinct != C)).sum())
    return nbytes


def _hit_column(rng, kind, n=C):
    """int32[n+1] hit columns for B5: Zipf-0.99 traffic (ties among the
    cold slots), fewer live slots than k with tied counts, all zero,
    uniform random counts in [0, 2^31 - 1) ("wide"), all equal (the index
    alone orders), counts rising with the index (every round beats every
    threshold), or random counts over all of int32 with INT_MIN, INT_MAX,
    -1, 0 and 1 among them."""
    hits = np.zeros(n + 1, np.int32)
    if kind == "zipf":
        np.add.at(hits, zipf_keys(n, max(4 * 8192 * n // C, 64), 0.99, rng),
                  1)
    elif kind == "sparse":
        hits[rng.choice(n, 10, replace=False)] = rng.choice([1, 2, 2, 5], 10)
    elif kind == "wide":
        hits[:n] = rng.integers(0, (1 << 31) - 1, n)
    elif kind == "equal":
        hits[:n] = 7
    elif kind == "ascending":
        hits[:n] = np.arange(n, dtype=np.int32)
    elif kind == "extremes":
        hits[:n] = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
        pick = rng.random(n) < 0.5
        hits[:n][pick] = rng.choice(
            np.array([-(1 << 31), (1 << 31) - 1, -1, 0, 1], np.int32),
            int(pick.sum()))
    hits[n] = 3  # scratch garbage: zeroed, never reported
    return hits


def _median_ms(fn, setup=None, reps=30, warmup=3):
    """Median device time of fn() over reps launches (CUDA events),
    after warm-up; setup() runs outside the timed range."""
    import torch

    times = []
    for k in range(warmup + reps):
        args = setup() if setup is not None else ()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        if k >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_ms(fn, setup, kernel, reps=10):
    """Mean device time per fn() call of the CUDA kernels whose names
    contain ``kernel`` (a string, or a tuple of them), from
    torch.profiler; None when the profiler records no device time for
    them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    for _attempt in range(2):  # a trace that saw no kernel at all, again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                args = setup() if setup is not None else ()
                fn(*args)
            torch.cuda.synchronize()
        total_us = 0.0
        seen = []
        for evt in prof.key_averages():
            dev_us = getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0))
            if any(name in evt.key for name in names):
                total_us += dev_us
            elif dev_us > 0:
                seen.append(evt.key[:60])
        if total_us > 0 or seen:
            break
    if total_us <= 0:
        print(f"    (the profiler recorded no device time for {names}; "
              f"kernels it saw: {seen[:6]})", file=sys.stderr)
    return total_us / reps / 1e3 if total_us > 0 else None


def _host(state):
    return [t.cpu().numpy() for t in state]


def _sweeps(state, dev_arrays, now_ms):
    """Sweeps of B1's fixpoint on this batch and table: the plain
    version's loop, counted."""
    from limitador_tpu_torch.ops import kernel as K

    plan = K._check_prepare(state, *dev_arrays, now_ms)
    H = dev_arrays[0].shape[0]
    count = [0]

    def sweep(admitted):
        count[0] += 1
        return K._check_sweep(plan, admitted, H)

    K._fixpoint(sweep, H, state.values.device)
    return count[0]


def _max_abs_err(pairs):
    err = 0
    for a, b in pairs:
        d = (a.long() - b.long()).abs().max().item() if a.numel() else 0
        err = max(err, int(d))
    return err


def phase_kernels(dev):
    """Kernel vs plain on the card, at the main path's shapes. Returns
    {name: {shape: record}}."""
    import torch

    from limitador_tpu_torch.ops import kernel as K

    rng = np.random.default_rng(20)
    now_ms = 5_000_000
    lanes = {}
    # lanes for the Zipf head; the tail gets lanes as batches touch it
    # (its cells then hold random expiries, read as TATs by bucket lanes)
    for s in range(4096):
        lanes[s] = _lane(rng)
    base_np = _table(rng, now_ms, lanes)
    base = K.CounterTableState(*(torch.from_numpy(a).to(dev)
                                 for a in base_np))

    def tables():
        return K.CounterTableState(*(t.clone() for t in base))
    # the replicated node's table: the same cells but some live local
    # counts near 2^31, and its two remote lanes
    rbase_np = [a.copy() for a in base_np]
    remote_np = _remote_lanes(rng, now_ms, lanes, rbase_np[0])
    rbase = K.CounterTableState(*(torch.from_numpy(a).to(dev)
                                  for a in rbase_np))
    out = {name: {} for name in REPLACES}
    exact = True

    def record(name, shape, err, ms, plain_ms, nbytes, library_ms=None,
               device_ms=None, parent_ms=None):
        nonlocal exact
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out[name][shape] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            library_ms=library_ms, bytes=nbytes, device_ms=device_ms,
            parent_path_ms=parent_ms,
        )
        exact = exact and err == 0
        lib = "" if library_ms is None else f" library {library_ms:.4f}ms"
        par = ("" if parent_ms is None
               else f" parent's path {parent_ms:.4f}ms")
        dev_t = "not measured" if device_ms is None else f"{device_ms:.4f}ms"
        print(f"  {name:17s} n={shape!s:<7} err={err} call {ms:.4f}ms "
              f"(kernel alone {dev_t}) plain {plain_ms:.4f}ms "
              f"bound {bound:.7f}ms ({nbytes} B){lib}{par}")
        return out[name][shape]

    print("kernels vs plain versions (C = 1<<20):")
    # B1: the fused check, both kernels on one batch per H
    for H in B1_HS:
        arrays = _batch(rng, H, lanes)
        dev_arrays = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        tb = tables()
        rb = K.check_and_update_plain(tb, *dev_arrays, now_ms)
        plain_ms = _median_ms(
            lambda t: K.check_and_update_plain(t, *dev_arrays, now_ms),
            lambda: (tables(),), reps=5, warmup=1)
        nbytes = _check_bytes(arrays, base_np, _host(tb), now_ms)
        sweeps = _sweeps(tables(), dev_arrays, now_ms)
        routes = (("check_and_update_cluster", "cluster",
                   "check_cluster_kernel"),
                  ("check_and_update", "block", "check_kernel"))
        for name, route, kernel in routes:
            if route == "cluster" and H > K.CLUSTER_MAX_HITS:
                continue
            ta = tables()
            _, ra = K.check_and_update_batch(ta, *dev_arrays, now_ms,
                                             route=route)
            torch.cuda.synchronize()
            err = _max_abs_err(list(zip(ra, rb)) + list(zip(ta, tb)))
            ms = _median_ms(
                lambda t: K.check_and_update_batch(t, *dev_arrays, now_ms,
                                                   route=route),
                lambda: (tables(),))
            dms = _device_ms(
                lambda t: K.check_and_update_batch(t, *dev_arrays, now_ms,
                                                   route=route),
                lambda: (tables(),), kernel)
            record(name, H, err, ms, plain_ms, nbytes,
                   device_ms=dms)["sweeps"] = sweeps
        print(f"    B1 at H={H}: the fixpoint ran {sweeps} sweeps")
    _replicated_checks(dev, rng, lanes, tables, base_np, rbase, rbase_np,
                       remote_np, now_ms, record)
    for H in HS:
        arrays = _batch(rng, H, lanes)
        dev_arrays = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        # B2: unconditional update (large deltas included)
        deltas = np.where(rng.random(H) < 0.1,
                          rng.integers(-5, 1 << 30, H), arrays[1])
        upd_np = (arrays[0], deltas.astype(np.int32), arrays[3], arrays[5],
                  arrays[6])
        upd = tuple(torch.from_numpy(a).to(dev) for a in upd_np)
        ta, tb = tables(), tables()
        K.update_batch(ta, *upd, now_ms)
        K.update_plain(tb, *upd, now_ms)
        torch.cuda.synchronize()
        err = _max_abs_err(list(zip(ta, tb)))
        ms = _median_ms(lambda t: K.update_batch(t, *upd, now_ms),
                        lambda: (tables(),))
        plain_ms = _median_ms(lambda t: K.update_plain(t, *upd, now_ms),
                              lambda: (tables(),), reps=5, warmup=1)
        dms = _device_ms(lambda t: K.update_batch(t, *upd, now_ms),
                         lambda: (tables(),), "update_kernel")
        record("update", H, err, ms, plain_ms,
               _update_bytes(upd_np, base_np, _host(tb), now_ms),
               device_ms=dms)
        rv, re = remote_np
        remote = (torch.from_numpy(rv).to(dev), torch.from_numpy(re).to(dev))

        def rtables():
            return K.CounterTableState(*(t.clone() for t in rbase))
        # B6b: the update with the remote TAT floor
        ta, tb = rtables(), rtables()
        K.replicated_update_batch(ta, remote[1], *upd, now_ms)
        K.replicated_update_plain(tb, remote[1], *upd, now_ms)
        torch.cuda.synchronize()
        err = _max_abs_err(list(zip(ta, tb)))
        ms = _median_ms(
            lambda t: K.replicated_update_batch(t, remote[1], *upd, now_ms),
            lambda: (rtables(),))
        plain_ms = _median_ms(
            lambda t: K.replicated_update_plain(t, remote[1], *upd, now_ms),
            lambda: (rtables(),), reps=5, warmup=1)
        dms = _device_ms(
            lambda t: K.replicated_update_batch(t, remote[1], *upd, now_ms),
            lambda: (rtables(),), "update_kernel")
        record("replicated_update", H, err, ms, plain_ms,
               _update_bytes(upd_np, rbase_np, _host(tb), now_ms, re),
               device_ms=dms)
    exact = _replicated_update_host_forms(dev, rng, record, rbase, remote_np,
                                          lanes, now_ms) and exact
    exact = _table_update_host_forms(dev, rng, record, base, base_np, lanes,
                                     now_ms) and exact

    table = tables()
    stacked2 = torch.stack([table.values, table.expiry_ms])
    stacked3 = torch.stack(list(table))
    for n in READ_NS:
        slots = torch.from_numpy(zipf_keys(C, n, 0.99, rng)).to(dev)
        # B3a
        va, ta_ = K.read_slots(table, slots, now_ms)
        vb, tb_ = K.read_slots_plain(table, slots, now_ms)
        err = _max_abs_err([(va, vb), (ta_, tb_)])
        ms = _median_ms(lambda: K.read_slots(table, slots, now_ms))
        plain_ms = _median_ms(lambda: K.read_slots_plain(table, slots,
                                                         now_ms))
        lib_ms = _median_ms(lambda: torch.index_select(stacked2, 1, slots))
        dms = _device_ms(lambda: K.read_slots(table, slots, now_ms), None,
                         "read_slots_kernel")
        record("read_slots", n, err, ms, plain_ms, 20 * n, lib_ms, dms)
        # B3b
        distinct = int(torch.unique(slots).numel())
        ta, tb = tables(), tables()
        K.clear_slots(ta, slots)
        K.clear_slots_plain(tb, slots)
        torch.cuda.synchronize()
        err = _max_abs_err(list(zip(ta, tb)))
        ms = _median_ms(lambda: K.clear_slots(table, slots))
        plain_ms = _median_ms(lambda: K.clear_slots_plain(table, slots))
        lib_ms = _median_ms(lambda: stacked3.index_fill_(1, slots.long(), 0))
        dms = _device_ms(lambda: K.clear_slots(table, slots), None,
                         "clear_slots_kernel")
        record("clear_slots", n, err, ms, plain_ms, 4 * n + 12 * distinct,
               lib_ms, dms)
    _read_host_forms(dev, record, table, rng, now_ms)
    _clear_slots_host_forms(dev, record, tables, rng)
    # B4a: one int32 step over the whole expiry column, and a chunked shift
    errs = []
    for shift in (999_000, NEVER, 3 * NEVER + 5):
        ea, eb = base.expiry_ms.clone(), base.expiry_ms.clone()
        K.rebase_epoch_chunked(ea, shift)
        while shift > 0:
            step = min(shift, NEVER)
            K.rebase_expiry_plain(eb, step)
            shift -= step
        errs.append((ea, eb))
    e = base.expiry_ms.clone()
    ms = _median_ms(lambda: K.rebase_epoch_chunked(e, 1000))
    plain_ms = _median_ms(lambda: K.rebase_expiry_plain(e, 1000))
    dms = _device_ms(lambda: K.rebase_epoch_chunked(e, 1000), None,
                     "rebase_expiry_kernel")
    record("rebase_epoch", C + 1, _max_abs_err(errs), ms, plain_ms,
           8 * (C + 1), device_ms=dms)
    # B4b: the rebase by a device scalar, no host sync
    errs = []
    for shift in (0, 1, 999_000, NEVER):
        d_shift = torch.tensor([shift], dtype=torch.int32, device=dev)
        ta, tb = tables(), tables()
        K.rebase_epoch(ta, d_shift)
        K.rebase_epoch_plain(tb, d_shift)
        errs.extend(zip(ta, tb))
    torch.cuda.synchronize()
    d_shift = torch.tensor([1000], dtype=torch.int32, device=dev)
    t = tables()
    ms = _median_ms(lambda: K.rebase_epoch(t, d_shift))
    plain_ms = _median_ms(lambda: K.rebase_epoch_plain(t, d_shift))
    dms = _device_ms(lambda: K.rebase_epoch(t, d_shift), None,
                     "rebase_epoch_kernel")
    record("rebase_epoch_device", C + 1, _max_abs_err(errs), ms, plain_ms,
           8 * (C + 1) + 4, device_ms=dms)
    # B4d: the promotion seed; n = 1 is the promotion path's size
    for n in SEED_NS:
        H = 8 if n <= 8 else 1024
        errs = []
        for dirty in (False, True):
            start_np = [a.copy() for a in base_np]
            if dirty:
                for a in start_np:
                    a[C] = int(rng.integers(1, 1000))
            rows = _seed_rows(rng, H, n, now_ms)
            args = tuple(torch.from_numpy(a).to(dev) for a in rows)
            start = [torch.from_numpy(a).to(dev) for a in start_np]
            ta = K.CounterTableState(*(x.clone() for x in start))
            tb = K.CounterTableState(*(x.clone() for x in start))
            K.seed_slots(ta, *args)
            K.seed_slots_plain(tb, *args)
            errs.extend(zip(ta, tb))
            if int(ta.values[C]) or int(ta.expiry_ms[C]):
                errs.append((torch.ones(1), torch.zeros(1)))
        torch.cuda.synchronize()
        err = _max_abs_err(errs)
        idx = args[0][:n].long()
        stacked = torch.stack(list(base))
        new_rows = torch.stack([args[1][:n], args[2][:n],
                                torch.zeros_like(args[1][:n])])
        ms = _median_ms(lambda t: K.seed_slots(t, *args), lambda: (tables(),))
        plain_ms = _median_ms(lambda t: K.seed_slots_plain(t, *args),
                              lambda: (tables(),))
        lib_ms = _median_ms(lambda t: t.index_copy_(1, idx, new_rows),
                            lambda: (stacked.clone(),))
        dms = _device_ms(lambda t: K.seed_slots(t, *args),
                         lambda: (tables(),), "seed_slots_kernel")
        pad = H - n
        record("seed_slots", n, err, ms, plain_ms,
               24 * n + 4 * pad + 8 + (4 if pad else 0), lib_ms, dms)
        _seed_host_form(dev, record, tables, base_np, rows, n, H, lib_ms)
    # B4c: the lease credit, edge rows included
    for H in CREDIT_HS:
        cols = [t.cpu().numpy().copy() for t in base]
        rows = _credit_rows(rng, H, now_ms, cols)
        start = K.CounterTableState(*(torch.from_numpy(c).to(dev)
                                      for c in cols))
        args = tuple(torch.from_numpy(a).to(dev) for a in rows)

        def fresh_start():
            return (K.CounterTableState(*(t.clone() for t in start)),)

        (ta,), (tb,) = fresh_start(), fresh_start()
        K.credit_batch(ta, *args, now_ms, check_unique=True)
        K.credit_plain(tb, *args, now_ms)
        torch.cuda.synchronize()
        err = _max_abs_err(list(zip(ta, tb)))
        if int(ta.values[C]) or int(ta.expiry_ms[C]):
            err = max(err, 1)
        ms = _median_ms(lambda t: K.credit_batch(t, *args, now_ms),
                        fresh_start)
        plain_ms = _median_ms(lambda t: K.credit_plain(t, *args, now_ms),
                              fresh_start, reps=10, warmup=1)
        dms = _device_ms(lambda t: K.credit_batch(t, *args, now_ms),
                         fresh_start, "credit_kernel")
        nbytes = _credit_bytes(cols, rows, [t.cpu().numpy() for t in tb],
                               now_ms)
        record("credit", H, err, ms, plain_ms, nbytes, device_ms=dms)
    exact = _credit_host_forms(dev, rng, record, base, now_ms) and exact
    exact = _drain_kernels(dev, rng, record) and exact
    # B6c: the remote-sum scatter over unique slots
    lanes_base = tuple(torch.from_numpy(a).to(dev) for a in remote_np)
    for n in REMOTE_NS:
        slots = np.unique(zipf_keys(C, 4 * n, 0.99, rng))
        if slots.size < n:
            slots = np.union1d(slots, rng.choice(C, 2 * n, replace=False))
        slots = rng.permutation(slots)[:n].astype(np.int32)
        rows = tuple(torch.from_numpy(a).to(dev) for a in (
            slots, rng.integers(0, (1 << 30) + 1, n).astype(np.int32),
            rng.integers(0, NEVER, n).astype(np.int32)))

        def fresh_lanes():
            return tuple(t.clone() for t in lanes_base)
        la, lb = fresh_lanes(), fresh_lanes()
        K.apply_remote(*la, *rows)
        K.apply_remote_plain(*lb, *rows)
        torch.cuda.synchronize()
        err = _max_abs_err(list(zip(la, lb)))
        ms = _median_ms(lambda a, b: K.apply_remote(a, b, *rows),
                        fresh_lanes)
        plain_ms = _median_ms(lambda a, b: K.apply_remote_plain(a, b, *rows),
                              fresh_lanes)
        stacked = torch.stack(lanes_base)
        idx = rows[0].long()
        new_rows = torch.stack(rows[1:])
        lib_ms = _median_ms(lambda t: t.index_copy_(1, idx, new_rows),
                            lambda: (stacked.clone(),))
        dms = _device_ms(lambda a, b: K.apply_remote(a, b, *rows),
                         fresh_lanes, "apply_remote_kernel")
        record("apply_remote", n, err, ms, plain_ms, 20 * n, lib_ms, dms)
    _remote_host_forms(dev, record, lanes_base, rng)
    exact = _sharded_kernels(dev, rng, record) and exact
    if not exact:
        fail("a kernel disagrees with its plain version")
    return out


def _replicated_checks(dev, rng, lanes, tables, base_np, rbase, rbase_np,
                       remote_np, now_ms, record):
    """B6a, both kernels (the cluster with the gossip hooks up to 16,384
    hits, the one block at every H), over remote lanes with live and
    expired window sums, bucket floors and local + remote past 2^31,
    against the plain version on one batch per H; with both lanes zero,
    each kernel must equal B1's kernel of the same route."""
    import torch

    from limitador_tpu_torch.ops import kernel as K

    rv, re = remote_np
    remote = (torch.from_numpy(rv).to(dev), torch.from_numpy(re).to(dev))
    zeros = tuple(torch.zeros_like(t) for t in remote)

    def rtables():
        return (K.CounterTableState(*(t.clone() for t in rbase)),)

    routes = (("replicated_check_cluster", "cluster", "check_cluster_kernel"),
              ("replicated_check", "block", "check_kernel"))
    for H in B6A_HS:
        arrays = _batch(rng, H, lanes)
        dev_arrays = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        (tb,) = rtables()
        rb = K.replicated_check_plain(tb, *remote, *dev_arrays, now_ms)
        plain_ms = _median_ms(
            lambda t: K.replicated_check_plain(t, *remote, *dev_arrays,
                                               now_ms),
            rtables, reps=5, warmup=1)
        nbytes = _check_bytes(arrays, rbase_np, _host(tb), now_ms, (rv, re))
        for name, route, kernel in routes:
            if route == "cluster" and H > K.CLUSTER_MAX_HITS:
                continue
            (ta,) = rtables()
            _, ra = K.replicated_check_batch(ta, *remote, *dev_arrays,
                                             now_ms, route=route)
            za, zb = tables(), tables()
            _, zra = K.replicated_check_batch(za, *zeros, *dev_arrays,
                                              now_ms, route=route)
            _, zrb = K.check_and_update_batch(zb, *dev_arrays, now_ms,
                                              route=route)
            torch.cuda.synchronize()
            err = _max_abs_err(list(zip(ra, rb)) + list(zip(ta, tb))
                               + list(zip(zra, zrb)) + list(zip(za, zb)))
            ms = _median_ms(
                lambda t: K.replicated_check_batch(
                    t, *remote, *dev_arrays, now_ms, route=route), rtables)
            dms = _device_ms(
                lambda t: K.replicated_check_batch(
                    t, *remote, *dev_arrays, now_ms, route=route), rtables,
                kernel)
            record(name, H, err, ms, plain_ms, nbytes, device_ms=dms)


def _replicated_update_host_forms(dev, rng, record, rbase, remote_np,
                                  lanes, now_ms):
    """B6b's host form (``replicated_update_host``: a replicated node's
    list of (0, slot, delta, window, flags) entries by value, B7c's body
    with the remote TAT floor read through the remote lanes' context)
    against B6b's plain version on the padded columns, at
    REPLICATED_HOST_COUNTS entries over the replicated table (bucket
    floors ahead of and behind now, live window expiries in the remote
    lane): repeated cells mixing buckets and windows, fresh cells,
    deltas at the caps and a fresh entry after a non-fresh one on one
    cell at the parameter block's capacity (2000; 2001: one staged copy,
    still one launch). Each call timed from the list to the launched
    kernel beside the parent's path for the same list (pad, two pinned
    uploads, the device-tensor launch), the kernel alone by the
    profiler, and the host time of a one-counter Report split into its
    steps. Returns whether every case was exact."""
    import torch

    from limitador_tpu_torch.ops import kernel as K

    exp0 = torch.from_numpy(remote_np[1]).to(dev)
    exp = exp0.clone()
    remote = K.CounterTableState(torch.from_numpy(remote_np[0]).to(dev),
                                 exp, exp)  # as a node binds its lanes
    rctx = _bound_ctx(remote)
    exact = True
    for count in REPLICATED_HOST_COUNTS:
        entries = _update_entries(rng, count, lanes, min(count - 1, 2000),
                                  n=1, L=C, G=1)
        padded = [c[0] for c in _padded_update(entries, n=1, L=C)]
        d_padded = [torch.from_numpy(a).to(dev) for a in padded]
        ctx = _bound_ctx(K.CounterTableState(*(t.clone() for t in rbase)))
        want = K.CounterTableState(*(t.clone() for t in rbase))
        before = K.launches["replicated_update_host"]
        K.replicated_update_host(ctx, rctx, entries, now_ms)
        launched = K.launches["replicated_update_host"] - before
        K.replicated_update_plain(want, remote.expiry_ms, *d_padded, now_ms)
        torch.cuda.synchronize()
        err = _max_abs_err(list(zip(ctx.state, want))
                           + [(remote.expiry_ms, exp0)])
        exact = exact and err == 0
        if launched != 1:
            fail(f"B6b host form at {count} entries: {launched} launches")

        def call():
            K.replicated_update_host(ctx, rctx, entries, now_ms)

        def parent():
            ints = np.stack(padded[:3])
            flags = np.stack(padded[3:])
            d_ints, d_flags = _pinned(dev, ints, flags)
            K.replicated_update_batch(ctx.state, remote.expiry_ms, *d_ints,
                                      *d_flags, now_ms)

        distinct, first = np.unique(entries[:, 1], return_index=True)
        buckets = int((entries[first, 4] & 2 > 0).sum())
        row = record(
            "replicated_update", f"host/{count}", err, _median_ms(call),
            _median_ms(lambda: K.replicated_update_host_plain(
                want, remote.expiry_ms, entries, now_ms), reps=5, warmup=1),
            16 * count + 24 * distinct.size + 4 * buckets, None,
            _device_ms(call, None, ("update_list_kernel",
                                    "update_staged_kernel")),
            _median_ms(parent))
        if count == 1:
            data, handle, rhandle = entries.tobytes(), ctx.handle, rctx.handle
            ints, flags = np.stack(padded[:3]), np.stack(padded[3:])

            def to_list():  # as the node's _kernel_update drops padding
                real = ints[0] != C
                e = np.zeros((int(real.sum()), 5), np.int32)
                e[:, 1:4] = ints[:, real].T
                e[:, 4] = flags[0, real] | flags[1, real].astype(
                    np.int32) << 1
                return e

            row["host_breakdown_us"] = _host_breakdown(
                f"B6b host form, {count} entry", {
                    "list from the staged columns": to_list,
                    "list as bytes": lambda: entries.tobytes(),
                    "C call (list into the parameter block, launch)":
                        lambda: ctx.replicated_update_fn(
                            handle, rhandle, data, count, now_ms),
                    "the whole wrapper": call,
                    "the parent's path": parent,
                })
        ctx.close()
    rctx.close()
    return exact


def _table_update_host_forms(dev, rng, record, base, base_np, lanes,
                             now_ms):
    """B2's host form (``update_host``: a storage's list of (0, slot,
    delta, window, flags) entries by value, B7c's body on the one-row
    table, no floor) against B2's plain version on the padded columns
    (the JAX call's), at UPDATE_HOST_COUNTS entries: repeated cells
    mixing buckets and windows, fresh cells, deltas at the caps and a
    fresh entry after a non-fresh one on one cell at the parameter
    block's capacity (2000; 2001: one staged copy, still one launch).
    Each call timed from the list to the launched kernel beside the
    parent's path for the same list (pad to the bucket, two pinned
    uploads, ``update_batch`` with its workspace), the kernel alone by
    the profiler, and the host time of an ``update_counter`` (one entry)
    split into its steps. Returns whether every case was exact."""
    import torch

    from limitador_tpu_torch.ops import kernel as K

    exact = True
    for count in UPDATE_HOST_COUNTS:
        entries = _update_entries(rng, count, lanes, min(count - 1, 2000),
                                  n=1, L=C, G=1)
        padded = [c[0] for c in _padded_update(entries, n=1, L=C)]
        d_padded = [torch.from_numpy(a).to(dev) for a in padded]
        ctx = _bound_ctx(K.CounterTableState(*(t.clone() for t in base)))
        want = K.CounterTableState(*(t.clone() for t in base))
        before = dict(K.launches)
        K.update_host(ctx, entries, now_ms)
        launched = {k: K.launches[k] - before[k] for k in before
                    if K.launches[k] != before[k]}
        K.update_plain(want, *d_padded, now_ms)
        torch.cuda.synchronize()
        err = _max_abs_err(list(zip(ctx.state, want)))
        exact = exact and err == 0
        if launched != {"update_host": 1}:
            fail(f"B2 host form at {count} entries launched {launched}")

        def call():
            K.update_host(ctx, entries, now_ms)

        def parent():
            ints = np.stack(padded[:3])
            flags = np.stack(padded[3:])
            d_ints, d_flags = _pinned(dev, ints, flags)
            K.update_batch(ctx.state, *d_ints, *d_flags, now_ms)

        distinct = np.unique(entries[:, 1]).size
        row = record(
            "update", f"host/{count}", err, _median_ms(call),
            _median_ms(lambda: K.update_host_plain(want, entries, now_ms),
                       reps=5, warmup=1),
            16 * count + 24 * distinct, None,
            _device_ms(call, None, ("update_list_kernel",
                                    "update_staged_kernel")),
            _median_ms(parent))
        if count == 1:
            data, handle = entries.tobytes(), ctx.handle
            one = tuple(int(x) for x in entries[0])

            def pad_columns():  # the parent tree's update_counter staging
                ints = np.zeros((3, 8), np.int32)
                flags = np.zeros((2, 8), bool)
                ints[0, :] = C
                ints[:, 0] = one[1:4]
                flags[:, 0] = (one[4] & 1, one[4] & 2)
                return ints, flags

            row["host_breakdown_us"] = _host_breakdown(
                f"B2 host form, {count} entry", {
                    "list from the counter's entry": lambda: np.asarray(
                        [one], np.int32),
                    "list as bytes": lambda: entries.tobytes(),
                    "C call (list into the parameter block, launch)":
                        lambda: ctx.update_fn(handle, data, count, now_ms),
                    "the whole wrapper": call,
                    "the parent's staging (pad to 8)": pad_columns,
                    "the parent's path": parent,
                })
        ctx.close()
    # the shared authority's ApplyDeltas (phase 14): each counter once,
    # window and bucket lanes, half of them fresh; timed from the list to
    # the answers (B2's host form, then B3a's read of the same cells, as
    # TorchStorage.apply_deltas runs them), the update's kernel alone by
    # the profiler
    for count in AUTHORITY_FLUSHES:
        slots = rng.choice(C, size=count, replace=False).astype(np.int32)
        entries = np.zeros((count, 5), np.int32)
        entries[:, 1] = slots
        entries[:, 2] = rng.integers(1, 4, count)
        entries[:, 3] = rng.choice((60_000, 1_000, 200), count)
        entries[:, 4] = (rng.random(count) < 0.5) | (
            rng.random(count) < 0.2).astype(np.int32) << 1
        ctx = _bound_ctx(K.CounterTableState(*(t.clone() for t in base)))
        want = K.CounterTableState(*(t.clone() for t in base))
        K.update_host(ctx, entries, now_ms)
        got = K.read_slots_host(ctx, slots, now_ms)
        K.update_host_plain(want, entries, now_ms)
        ref = K.read_slots_host_plain(want, slots, now_ms)
        torch.cuda.synchronize()
        err = max(_max_abs_err(list(zip(ctx.state, want))),
                  *(int(np.abs(a.astype(np.int64) - b).max())
                    for a, b in zip(got, ref)))
        exact = exact and err == 0

        def call():
            K.update_host(ctx, entries, now_ms)
            return K.read_slots_host(ctx, slots, now_ms)

        def plain():
            K.update_host_plain(want, entries, now_ms)
            return K.read_slots_host_plain(want, slots, now_ms)

        # the list, the cells read and written, the cells read again and
        # the answers
        record("update", f"host/authority-{count}", err, _median_ms(call),
               _median_ms(plain, reps=5, warmup=1),
               20 * count + 24 * count + 8 * count + 8 * count, None,
               _device_ms(lambda: K.update_host(ctx, entries, now_ms), None,
                          ("update_list_kernel", "update_staged_kernel")))
        ctx.close()
    return exact


def _credit_host_forms(dev, rng, record, base, now_ms):
    """B4c's host form (``credit_host``: the lease broker's list of (0,
    slot, credit, interval, bucket << 1) entries by value, one thread an
    entry) against B4c's plain version on the padded columns (the JAX
    call's), at CREDIT_HOST_COUNTS entries with the edge rows (an
    expired window, an expired bucket, a covering credit, one short,
    credit * interval beyond int32, a window floored at 0) and a dirty
    scratch row: up to 2000 in the parameter block, past it one staged
    copy, each twice in a row on one context. Each call timed from the
    list to the launched kernel beside the parent's path for the same
    columns (pad to the bucket, stack, two pinned uploads, the
    device-tensor launch), the kernel alone by the profiler, and the
    host time at the first count split into its steps. Returns whether
    every case was exact."""
    import torch

    from limitador_tpu_torch.device.storage import _staged
    from limitador_tpu_torch.ops import kernel as K

    exact = True
    for count in CREDIT_HOST_COUNTS:
        H = max(8, 1 << (count - 1).bit_length())
        cols = [t.cpu().numpy().copy() for t in base]
        rows = _credit_rows(rng, H, now_ms, cols, n_real=count)
        entries = np.zeros((count, 5), np.int32)
        entries[:, 1], entries[:, 2], entries[:, 3] = (r[:count]
                                                       for r in rows[:3])
        entries[:, 4] = rows[3][:count].astype(np.int32) << 1
        start = K.CounterTableState(*(torch.from_numpy(c).to(dev)
                                      for c in cols))
        d_rows = [torch.from_numpy(a).to(dev) for a in rows]
        ctx = _bound_ctx(K.CounterTableState(*(t.clone() for t in start)))
        want = K.CounterTableState(*(t.clone() for t in start))
        twin = K.CounterTableState(*(t.clone() for t in start))
        before = dict(K.launches)
        for _turn in range(2):  # twice in a row: the staging buffer's reuse
            K.credit_host(ctx, entries, now_ms, check_unique=True)
            K.credit_plain(want, *d_rows, now_ms)
            K.credit_host_plain(twin, entries, now_ms)
        launched = {k: K.launches[k] - before[k] for k in before
                    if K.launches[k] != before[k]}
        torch.cuda.synchronize()
        err = _max_abs_err(list(zip(ctx.state, want))
                           + list(zip(ctx.state, twin)))
        if int(ctx.state.values[C]) or int(ctx.state.expiry_ms[C]):
            err = max(err, 1)
        exact = exact and err == 0
        if launched != {"credit_host": 2}:
            fail(f"B4c host form at {count} entries launched {launched}")
        after = K.CounterTableState(*(t.clone() for t in start))
        K.credit_plain(after, *d_rows, now_ms)
        nbytes = _credit_bytes(cols, tuple(r[:count] for r in rows),
                               [t.cpu().numpy() for t in after], now_ms)

        def restore():  # the starting cells, outside the timed range
            for t, s0 in zip(ctx.state, start):
                t.copy_(s0)
            return (ctx,)

        def call(c):
            K.credit_host(c, entries, now_ms)

        def parent(c):  # the parent tree's credit_columnar
            ints = np.stack([_staged(rows[0][:count], H, C, np.int32),
                             _staged(rows[1][:count], H, 0, np.int32),
                             _staged(rows[2][:count], H, 0, np.int32)])
            flags = _staged(rows[3][:count], H, False, bool)
            d_ints, d_bucket = _pinned(dev, ints, flags)
            K.credit_batch(c.state, *d_ints, d_bucket, now_ms)

        row = record(
            "credit", f"host/{count}", err, _median_ms(call, restore),
            _median_ms(lambda t: K.credit_host_plain(t, entries, now_ms),
                       lambda: (K.CounterTableState(
                           *(t.clone() for t in start)),),
                       reps=5, warmup=1),
            nbytes, None,
            _device_ms(call, restore, ("credit_list_kernel",
                                       "credit_staged_kernel")),
            _median_ms(parent, restore))
        if count == CREDIT_HOST_COUNTS[0]:
            data, handle = entries.tobytes(), ctx.handle
            src = (rows[0][:count], rows[1][:count], rows[2][:count],
                   rows[3][:count])

            def to_list():  # as credit_columnar builds it
                e = np.zeros((count, 5), np.int32)
                e[:, 1], e[:, 2], e[:, 3] = src[:3]
                e[:, 4] = np.asarray(src[3], np.int32) << 1
                return e

            row["host_breakdown_us"] = _host_breakdown(
                f"B4c host form, {count} entries", {
                    "list from the broker's columns": to_list,
                    "list as bytes": lambda: entries.tobytes(),
                    "C call (list into the parameter block, launch)":
                        lambda: ctx.credit_fn(handle, data, count, now_ms),
                    "the whole wrapper": lambda: call(ctx),
                    "the parent's path": lambda: parent(ctx),
                }, reps=500)
        ctx.close()
    return exact


def _bound_ctx(table):
    """A host-list launch context on the current stream (the one the
    CUDA events time), as a storage binds its own stream."""
    import torch

    from limitador_tpu_torch.ops import kernel as K

    return K.TableContext(table, torch.cuda.current_stream())


def _pinned(dev, *arrays):
    """The parent tree's upload of host lists: pinned, non-blocking."""
    import torch

    return [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
            for a in arrays]


def _host_breakdown(label, steps, reps=2000, setup=None):
    """Median host time (``time.perf_counter_ns``) of each step of a
    host-form call, each step run alone ``reps`` times (a sync every
    100, so that no queue of launches builds up; with ``setup``, it and
    a sync before every step, outside the time)."""
    import torch

    out = {}
    for name, step in steps.items():
        times = []
        for k in range(reps):
            if setup is not None:
                setup()
            if k % 100 == 0 or setup is not None:
                torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            step()
            times.append(time.perf_counter_ns() - t0)
        out[name] = float(np.median(times)) / 1e3
    torch.cuda.synchronize()
    print(f"  host time of the {label} (median us): " + ", ".join(
        f"{k} {v:.2f}" for k, v in out.items()))
    return out


def _seed_host_form(dev, record, tables, start_np, rows, n, H, lib_ms):
    """B4d's host form on the storage's numpy lists (``seed_slots_host``,
    the lists in the kernel's parameter block) against its plain version,
    clean and dirty scratch; timed from the lists to the launched kernel
    beside the parent's path for the same promotion (pad to the bucket,
    three pinned uploads, the device-tensor launch)."""
    import torch

    from limitador_tpu_torch.ops import kernel as K

    lists = tuple(a[:n].copy() for a in rows)
    padded = H > n
    errs = []
    for dirty in (False, True):
        begin = [a.copy() for a in start_np]
        if dirty:
            for a in begin:
                a[C] = 7
        ta, tb = (K.CounterTableState(*(torch.from_numpy(a).to(dev)
                                        for a in begin)) for _ in range(2))
        K.seed_slots_host(_bound_ctx(ta), *lists, padded)
        K.seed_slots_host_plain(tb, *lists, padded)
        errs.extend(zip(ta, tb))
    torch.cuda.synchronize()

    def bound():
        return (_bound_ctx(tables()),)

    def parent(t):
        fills = (C, 0, 0)
        staged = [np.concatenate([a, np.full(H - n, f, np.int32)])
                  for a, f in zip(lists, fills)]
        K.seed_slots(t, *_pinned(dev, *staged))

    ms = _median_ms(lambda c: K.seed_slots_host(c, *lists, padded), bound)
    plain_ms = _median_ms(
        lambda t: K.seed_slots_host_plain(t, *lists, padded),
        lambda: (tables(),))
    parent_ms = _median_ms(parent, lambda: (tables(),))
    dms = _device_ms(lambda c: K.seed_slots_host(c, *lists, padded), bound,
                     "seed_list_kernel")
    row = record("seed_slots", f"host/{n}", _max_abs_err(errs), ms,
                 plain_ms, 24 * n + 8 + (4 if padded else 0), lib_ms, dms,
                 parent_ms)
    if n == 1:
        ctx = _bound_ctx(tables())
        ptrs = [a.tobytes() for a in lists]
        idx = torch.from_numpy(lists[0]).to(dev).long()
        stacked = torch.stack(list(tables()))
        new_rows = torch.stack([torch.from_numpy(a).to(dev)
                                for a in (lists[1], lists[2], lists[2])])
        row["host_breakdown_us"] = _host_breakdown("B4d host form, n=1", {
            "lists (the storage's np.asarray x3)": lambda: [
                np.asarray(a, np.int32) for a in ([5], [3], [77])],
            "checks (x3)": lambda: [K._require_host(a, "a", n)
                                    for a in lists],
            "lists as bytes (x3)": lambda: [a.tobytes() for a in lists],
            "C call (list into the parameter block, launch)":
                lambda: ctx.seed_fn(ctx.handle, *ptrs, n, 1),
            "the whole wrapper": lambda: K.seed_slots_host(ctx, *lists, True),
            "library call (index_copy_)":
                lambda: stacked.index_copy_(1, idx, new_rows),
        })


def _clear_host_forms(dev, rng, record, base, rows_np, device_form, lib_ms):
    """B7b's host form on host lists (``sharded_clear_cells_host``, the
    list in the kernel's parameter block) against its plain version:
    the [8, 64] list of the device-tensor row as (row, slot) pairs (also
    held against that row's result), one evicted global slot on every
    row (the parent's per-eviction call), and a staging pass's flush of
    1024 global slots. Timed from the list to the launched kernel, beside
    the parent's path for the same list where it had one (pad to the
    bucket, a pinned upload, the device-tensor launch)."""
    import torch

    from limitador_tpu_torch.parallel import mesh as M

    n, L = SHARDS, LOCAL_CAP
    stacked = torch.stack([t.reshape(-1) for t in base])

    def tables():
        return (M.ShardedCounterState(*(t.clone() for t in base)),)

    def bound():
        return (_bound_ctx(tables()[0]),)

    def parent(rows):
        def launch(t):
            k = max(8, 1 << (rows.shape[1] - 1).bit_length())
            padded = np.full((n, k), L, np.int32)
            padded[:, :rows.shape[1]] = rows
            M.sharded_clear_cells(t, *_pinned(dev, padded))
        return launch

    row_ids = np.repeat(np.arange(n, dtype=np.int32), rows_np.shape[1])
    pairs = np.stack([row_ids, rows_np.reshape(-1)], axis=1)
    one = np.asarray([int(rng.integers(0, GLOBAL_REGION))], np.int32)
    flush = np.arange(GLOBAL_REGION, dtype=np.int32)
    for shape, entries, all_rows, par_rows in (
            (f"host-pairs/{rows_np.shape[1]}", pairs, False, rows_np),
            ("host-all/1", one, True, np.broadcast_to(one, (n, 1))),
            (f"host-all/{GLOBAL_REGION}", flush, True, None)):
        (ta,), (tb,) = tables(), tables()
        M.sharded_clear_cells_host(_bound_ctx(ta), entries, all_rows)
        M.sharded_clear_cells_host_plain(tb, entries, all_rows)
        torch.cuda.synchronize()
        compared = list(zip(ta, tb))
        if not all_rows:
            compared += list(zip(ta, device_form))
        err = _max_abs_err(compared)
        ms = _median_ms(
            lambda c: M.sharded_clear_cells_host(c, entries, all_rows), bound)
        plain_ms = _median_ms(
            lambda t: M.sharded_clear_cells_host_plain(t, entries, all_rows),
            tables)
        parent_ms = (None if par_rows is None
                     else _median_ms(parent(par_rows), tables))
        if all_rows:
            cells = (np.arange(n)[:, None] * (L + 1)
                     + entries[None, :]).reshape(-1)
            flat = torch.from_numpy(cells).to(dev)
            lib = _median_ms(lambda t: t.index_fill_(1, flat, 0),
                             lambda: (stacked.clone(),))
            distinct = n * np.unique(entries).size
        else:
            lib = lib_ms
            distinct = np.unique(pairs, axis=0).shape[0]
        dms = _device_ms(
            lambda c: M.sharded_clear_cells_host(c, entries, all_rows), bound,
            "clear_list_kernel")
        row = record("sharded_clear_cells", shape, err, ms, plain_ms,
                     4 * entries.size + 12 * distinct, lib, dms, parent_ms)
        if shape == "host-all/1":
            ctx = _bound_ctx(tables()[0])
            ptr = entries.tobytes()
            flat_t = stacked.clone()
            # the C call by block size: 1 slot (a 256-byte list), 1000
            # (4,000 bytes, all parameters within the classic 4 KB),
            # 1024 and 8000 (the 32,000-byte block)
            lists = {k: np.arange(k, dtype=np.int32).tobytes()
                     for k in (1000, 1024, 8000)}
            row["host_breakdown_us"] = _host_breakdown(
                "B7b host form, one global slot on every row", {
                    "checks": lambda: (entries.dtype != np.int32
                                       or entries.ndim != 1),
                    "list as bytes": lambda: entries.tobytes(),
                    "C call (list into the parameter block, launch)":
                        lambda: ctx.clear_fn(ctx.handle, ptr, 1, 1),
                    "the whole wrapper": lambda: M.sharded_clear_cells_host(
                        ctx, entries, True),
                    "library call (index_fill_)":
                        lambda: flat_t.index_fill_(1, flat, 0),
                    "C call, 1000 slots": lambda: ctx.clear_fn(
                        ctx.handle, lists[1000], 1000, 1),
                    "C call, 1024 slots": lambda: ctx.clear_fn(
                        ctx.handle, lists[1024], 1024, 1),
                    "C call, 8000 slots": lambda: ctx.clear_fn(
                        ctx.handle, lists[8000], 8000, 1),
                })


def _clear_slots_host_forms(dev, record, tables, rng):
    """B3b's host form (``clear_slots_host``: the storage's numpy list in
    the kernel's parameter block through the bound context) against its
    plain version at CLEAR_HOST_NS, duplicates and the scratch slot in
    each list, the last past one parameter block. Each call timed from
    the list to the launched kernel, beside the parent tree's path for
    the same list (a pinned upload and the device-tensor launch, which
    ``TorchStorage._clear`` made once per adopted counter) and the
    library call (``index_fill_`` of the three columns stacked, from a
    device list)."""
    import torch

    from limitador_tpu_torch.ops import kernel as K

    table = tables()
    stacked = torch.stack(list(table))
    ctx = _bound_ctx(table)
    for n in CLEAR_HOST_NS:
        slots = zipf_keys(C, n, 0.99, rng)
        slots[0] = C
        ta, tb = tables(), tables()
        K.clear_slots_host(_bound_ctx(ta), slots)
        K.clear_slots_host_plain(tb, slots)
        torch.cuda.synchronize()
        err = _max_abs_err(list(zip(ta, tb)))

        def call():
            K.clear_slots_host(ctx, slots)

        def parent():
            K.clear_slots(table, *_pinned(dev, slots))

        d_slots = torch.from_numpy(slots).to(dev).long()
        distinct = int(np.unique(slots).size)
        row = record(
            "clear_slots", f"host/{n}", err, _median_ms(call),
            _median_ms(lambda: K.clear_slots_host_plain(table, slots)),
            4 * n + 12 * distinct,
            _median_ms(lambda: stacked.index_fill_(1, d_slots, 0)),
            _device_ms(call, None, "clear_list_kernel"), _median_ms(parent))
        if n == 8:
            data, handle = slots.tobytes(), ctx.handle
            row["host_breakdown_us"] = _host_breakdown(
                f"B3b host form, n={n}", {
                    "checks": lambda: K._require_host(slots, "slots", n),
                    "list as bytes": lambda: slots.tobytes(),
                    "C call (list into the parameter block, launch)":
                        lambda: ctx.clear_slots_fn(handle, data, n),
                    "the whole wrapper": call,
                    "the parent's path (pinned upload, launch)": parent,
                })
    ctx.close()


def _read_host_forms(dev, record, table, rng, now_ms):
    """B3a's host form (``read_slots_host``: the storage's numpy list in
    the kernel's parameter block, the answers stored into the context's
    mapped host buffer, one wait on the stream) against its plain version
    at READ_HOST_NS, lists past one parameter block included, the scratch
    slot in each. Each call timed from the list to the numpy answers,
    beside the parent tree's path for the same list (pad to the bucket, a
    pinned upload, the device-tensor launch, two downloads) and the
    library path (an upload, ``index_select`` of both columns,
    ``.cpu()``)."""
    import torch

    from limitador_tpu_torch.ops import kernel as K

    stacked = torch.stack([table.values, table.expiry_ms])
    ctx = _bound_ctx(table)
    for n in READ_HOST_NS:
        slots = zipf_keys(C, n, 0.99, rng)
        slots[0] = C

        def call():
            return K.read_slots_host(ctx, slots, now_ms)

        def parent():
            padded = np.full(max(8, 1 << (n - 1).bit_length()), C, np.int32)
            padded[:n] = slots
            values, ttls = K.read_slots(table, *_pinned(dev, padded), now_ms)
            return values.cpu().numpy()[:n], ttls.cpu().numpy()[:n]

        def library():
            return torch.index_select(stacked, 1,
                                      *_pinned(dev, slots)).cpu().numpy()

        want = K.read_slots_host_plain(table, slots, now_ms)
        err = max(int(np.abs(a.astype(np.int64) - b).max())
                  for pair in (zip(call(), want), zip(parent(), want))
                  for a, b in pair)
        row = record(
            "read_slots", f"host/{n}", err, _median_ms(call),
            _median_ms(lambda: K.read_slots_host_plain(table, slots, now_ms)),
            20 * n, _median_ms(library), _device_ms(call, None,
                                                   "read_list_kernel"),
            _median_ms(parent))
        if n in (1, 8):
            data, handle = slots.tobytes(), ctx.handle
            row["host_breakdown_us"] = _host_breakdown(
                f"B3a host form, n={n}", {
                    "checks": lambda: K._require_host(slots, "slots", n),
                    "list as bytes": lambda: slots.tobytes(),
                    "C call (list into the parameter block, launch, wait)":
                        lambda: ctx.read_fn(handle, data, n, now_ms),
                    "answers copied out": lambda: (
                        ctx.results[:n, 0].copy(), ctx.results[:n, 1].copy()),
                    "the whole wrapper": call,
                    "the parent's path": parent,
                    "library path (upload, index_select, .cpu())": library,
                })
    ctx.close()


def _drain_kernels(dev, rng, record):
    """B5 against its plain version: the one-pass kernel (the
    device-tensor call) and the host form (``drain_top_hits_host``, the
    answers in the context's mapped buffer) on every column kind at k in
    DRAIN_KS, over 1<<20 and 1<<10 cells, then k past 1024 (the full
    sort) up to C. Times at 1<<20: on Zipf at each k the device-tensor
    call, the kernel alone, plain and ``topk`` + ``zero_``; the host form
    at k = 64 (from the call to the numpy answers, its host time split
    into steps); the ascending column (every round beats every
    threshold), the uniform random one (each block's threshold rises
    slowest there) and the INT_MIN/INT_MAX one at k = 64 and 1024.
    Returns whether every case was exact."""
    import torch

    from limitador_tpu_torch.ops import kernel as K

    errs = []
    for n in (C, DRAIN_SMALL_C):
        for kind in DRAIN_KINDS:
            col = _hit_column(rng, kind, n)
            cold = torch.from_numpy(col).to(dev)
            for k in DRAIN_KS:
                ha, hb = cold.clone(), cold.clone()
                got = K.drain_top_hits(ha, k)
                want = K.drain_top_hits_plain(hb, k)
                errs.extend(zip(got, want))
                table = K.CounterTableState(torch.zeros_like(cold),
                                            torch.zeros_like(cold),
                                            cold.clone())
                ctx = _bound_ctx(table)
                counts, slots = K.drain_top_hits_host(ctx, k)
                ctx.close()
                errs.extend(zip((torch.from_numpy(counts),
                                 torch.from_numpy(slots), table.hits.cpu()),
                                (want[1].cpu(), want[2].cpu(),
                                 want[0].cpu())))
    err = _max_abs_err(errs)
    print(f"  drain_top_hits    {len(DRAIN_KINDS)} column kinds x k in "
          f"{DRAIN_KS} x C in (1<<20, 1<<10), kernel and host form: "
          f"err={err}")
    exact = err == 0
    zipf_col = torch.from_numpy(_hit_column(rng, "zipf")).to(dev)
    hard = {kind: torch.from_numpy(_hit_column(rng, kind)).to(dev)
            for kind in ("ascending", "wide", "extremes")}
    for k in DRAIN_KS:
        ha, hb = zipf_col.clone(), zipf_col.clone()
        err = _max_abs_err(zip(K.drain_top_hits(ha, k),
                               K.drain_top_hits_plain(hb, k)))

        def column():
            return (zipf_col.clone(),)

        ms = _median_ms(lambda h: K.drain_top_hits(h, k), column)
        plain_ms = _median_ms(lambda h: K.drain_top_hits_plain(h, k),
                              column)
        lib_ms = _median_ms(
            lambda h: (torch.topk(h[:-1], k), h.zero_()), column)
        dms = _device_ms(lambda h: K.drain_top_hits(h, k), column,
                         "drain_kernel")
        record("drain_top_hits", k, err, ms, plain_ms, 8 * (C + 1) + 8 * k,
               lib_ms, dms)
    for (kind, col), k in itertools.product(hard.items(), (64, 1024)):
        ha, hb = col.clone(), col.clone()
        err = _max_abs_err(zip(K.drain_top_hits(ha, k),
                               K.drain_top_hits_plain(hb, k)))

        def column(col=col):
            return (col.clone(),)

        record("drain_top_hits", f"{kind}/{k}", err,
               _median_ms(lambda h: K.drain_top_hits(h, k), column),
               _median_ms(lambda h: K.drain_top_hits_plain(h, k), column),
               8 * (C + 1) + 8 * k,
               _median_ms(lambda h: (torch.topk(h[:-1], k), h.zero_()),
                          column),
               _device_ms(lambda h: K.drain_top_hits(h, k), column,
                          "drain_kernel"))
    # the host form, the storages' path, at the default --usage-topk
    k = 64
    table = K.CounterTableState(torch.zeros_like(zipf_col),
                                torch.zeros_like(zipf_col), zipf_col.clone())
    ctx = _bound_ctx(table)

    def refill():
        table.hits.copy_(zipf_col)
        return ()

    def call():
        return K.drain_top_hits_host(ctx, k)

    def tensor_path():
        _, counts, slots = K.drain_top_hits(table.hits, k)
        return counts.cpu().numpy(), slots.cpu().numpy()

    refill()
    got = call()
    _, want_c, want_s = K.drain_top_hits_plain(zipf_col.clone(), k)
    err = max(int(np.abs(g.astype(np.int64) - w.cpu().numpy()).max())
              for g, w in zip(got, (want_c, want_s)))
    row = record(
        "drain_top_hits", f"host/{k}", err, _median_ms(call, refill),
        _median_ms(lambda: K.drain_top_hits_host_plain(table, k), refill),
        8 * (C + 1) + 8 * k,
        _median_ms(lambda h: (torch.topk(h[:-1], k), h.zero_()),
                   lambda: (zipf_col.clone(),)),
        _device_ms(call, refill, "drain_kernel"),
        _median_ms(tensor_path, refill))
    handle = ctx.handle
    row["host_breakdown_us"] = _host_breakdown(
        f"B5 host form, k={k} (each step on a refilled column)", {
            "C call (launch, wait)": lambda: ctx.drain_fn(handle, k),
            "answers copied out": lambda: (ctx.results[:k, 0].copy(),
                                           ctx.results[:k, 1].copy()),
            "the whole wrapper": call,
            "device-tensor call and two downloads": tensor_path,
        }, reps=300, setup=refill)
    ctx.close()
    exact = exact and err == 0
    # past the shared-memory path (k > 1024, the full sort) up to k = C
    big_errs = []
    for k in (1025, 4096, C):
        for kind in ("zipf", "sparse"):
            col = torch.from_numpy(_hit_column(rng, kind)).to(dev)
            ha, hb = col.clone(), col.clone()
            big_errs.extend(zip(K.drain_top_hits(ha, k),
                                K.drain_top_hits_plain(hb, k)))
    err = _max_abs_err(big_errs)
    print(f"  drain_top_hits    k in (1025, 4096, C) err={err}")
    return exact and err == 0


def _remote_host_forms(dev, record, lanes_base, rng):
    """B6c's host form (``apply_remote_host``: the rows in the kernel's
    parameter block within one block, the staged design past it) on a
    context over the remote lanes, against its plain version, at
    REMOTE_HOST_NS; each C design alone too (a chain of parameter blocks,
    the staged copy), all bit-exact. Timed from the numpy rows to the
    launched kernel (the wrapper and each design), and from the dirty map
    (this tree's one-pass pack and the wrapper; the parent tree's flush:
    three list passes, three pinned uploads, the device-tensor launch),
    beside the library path (uploads, ``index_copy_`` of both lanes
    stacked)."""
    import itertools

    import torch

    from limitador_tpu_torch.ops import build
    from limitador_tpu_torch.ops import kernel as K

    stacked = torch.stack(lanes_base)
    for n in REMOTE_HOST_NS:
        slots = np.unique(zipf_keys(C, 4 * n, 0.99, rng))
        if slots.size < n:
            slots = np.union1d(slots, rng.choice(C, 2 * n, replace=False))
        rows = (rng.permutation(slots)[:n].astype(np.int32),
                rng.integers(0, (1 << 30) + 1, n).astype(np.int32),
                rng.integers(0, NEVER, n).astype(np.int32))
        dirty = {int(s): (int(v), int(e)) for s, v, e in zip(*rows)}

        def bind():
            lanes = tuple(t.clone() for t in lanes_base)
            return lanes, _bound_ctx(K.CounterTableState(*lanes, lanes[1]))

        def design(ctx, fn, name):
            return lambda: build.check(
                fn(ctx.handle, *(a.tobytes() for a in rows), n), name)

        want = tuple(t.clone() for t in lanes_base)
        K.apply_remote_plain(*want, *(torch.from_numpy(a).to(dev)
                                      for a in rows))
        compared = []
        for form in ("wrapper", "param", "staged"):
            lanes, ctx = bind()
            if form == "wrapper":
                K.apply_remote_host(ctx, *rows)
            else:
                fn = ctx.remote_fn if form == "param" else ctx.staged_fn
                design(ctx, fn, form)()
            torch.cuda.synchronize()
            compared.extend(zip(lanes, want))
            ctx.close()
        lanes, ctx = bind()

        def wrapper():
            K.apply_remote_host(ctx, *rows)

        def path():
            keys = np.fromiter(dirty, np.int32, n)
            shares = np.fromiter(
                itertools.chain.from_iterable(dirty.values()), np.int32,
                2 * n)
            K.apply_remote_host(ctx, keys, shares[0::2], shares[1::2])

        def parent():
            items = list(dirty.items())
            packed = (np.asarray([s for s, _ in items], np.int32),
                      np.asarray([v for _, (v, _e) in items], np.int32),
                      np.asarray([e for _, (_v, e) in items], np.int32))
            K.apply_remote(*lanes, *_pinned(dev, *packed))

        def library():
            up = _pinned(dev, *rows)
            stacked.index_copy_(1, up[0].long(), torch.stack(up[1:]))

        param = design(ctx, ctx.remote_fn, "ct_apply_remote_host")
        staged = design(ctx, ctx.staged_fn, "ct_apply_remote_staged")
        row = record(
            "apply_remote", f"host/{n}", _max_abs_err(compared),
            _median_ms(wrapper),
            _median_ms(lambda: K.apply_remote_host_plain(
                K.CounterTableState(*lanes, lanes[1]), *rows)),
            20 * n, _median_ms(library),
            _device_ms(wrapper, None, ("remote_list_kernel",
                                       "apply_remote_kernel")),
            _median_ms(parent))
        row.update(param_ms=_median_ms(param), staged_ms=_median_ms(staged),
                   path_ms=_median_ms(path))
        blocks = -(-n // ctx.capacity[4])
        print(f"    B6c designs at n={n}: parameter blocks "
              f"{row['param_ms']:.4f}ms ({blocks} launches), staged "
              f"{row['staged_ms']:.4f}ms (one copy, one launch); from the "
              f"dirty map: this tree {row['path_ms']:.4f}ms, the parent's "
              f"{row['parent_path_ms']:.4f}ms")
        if n == MAIN_SHAPE["apply_remote"]:
            blobs = [a.tobytes() for a in rows]
            handle = ctx.handle
            items = list(dirty.items())
            packed = (np.asarray([s for s, _ in items], np.int32),
                      np.asarray([v for _, (v, _e) in items], np.int32),
                      np.asarray([e for _, (_v, e) in items], np.int32))
            pinned = [torch.from_numpy(a).pin_memory() for a in packed]
            uploaded = [t.to(dev, non_blocking=True) for t in pinned]
            row["host_breakdown_us"] = _host_breakdown(
                f"B6c host form, n={n}", {
                    "checks (x3)": lambda: [K._require_host(a, "a", n)
                                            for a in rows],
                    "rows as bytes (x3)": lambda: [a.tobytes()
                                                   for a in rows],
                    "C call, staged (pack, copy, launch)":
                        lambda: ctx.staged_fn(handle, *blobs, n),
                    "C call, parameter blocks":
                        lambda: ctx.remote_fn(handle, *blobs, n),
                    "the whole wrapper": wrapper,
                    "pack of the dirty map (this tree)": lambda: (
                        np.fromiter(dirty, np.int32, n),
                        np.fromiter(itertools.chain.from_iterable(
                            dirty.values()), np.int32, 2 * n)),
                    "from the dirty map (this tree)": path,
                    "the parent's path": parent,
                    "parent: three-pass pack": lambda: (
                        np.asarray([s for s, _ in items], np.int32),
                        np.asarray([v for _, (v, _e) in items], np.int32),
                        np.asarray([e for _, (_v, e) in items], np.int32)),
                    "parent: pin_memory (x3)": lambda: [
                        torch.from_numpy(a).pin_memory() for a in packed],
                    "parent: copies (x3)": lambda: [
                        t.to(dev, non_blocking=True) for t in pinned],
                    "parent: launch": lambda: K.apply_remote(*lanes,
                                                             *uploaded),
                    "library path (uploads, index_copy_)": library,
                }, reps=500)
        ctx.close()


def _sharded_table(rng, now_ms, lanes, n=SHARDS, L=LOCAL_CAP,
                   G=GLOBAL_REGION):
    """int32[n, L+1] x3 mid-stream: live and expired windows, bucket
    TATs, hit counts, and global-region partials some near 2^30 so that
    their sum over the rows passes 2^31."""
    values = rng.integers(0, 60, (n, L + 1)).astype(np.int32)
    expiry = rng.integers(0, 2 * now_ms, (n, L + 1)).astype(np.int32)
    hits = rng.integers(0, 1000, (n, L + 1)).astype(np.int32)
    for slot, (is_bucket, maxv, win) in lanes.items():
        if is_bucket and slot >= G:
            expiry[:, slot] = np.maximum(
                now_ms + rng.integers(-3, maxv + 4, n) * win, 0)
    big = rng.random((n, G)) < 0.2
    values[:, :G] = np.where(big, (1 << 30) + rng.integers(0, 1 << 29,
                                                          (n, G)),
                             values[:, :G])
    values[:, L] = expiry[:, L] = hits[:, L] = 0
    return values, expiry, hits


def _sharded_batch(rng, H, lanes, coupled, with_global, n=SHARDS,
                   L=LOCAL_CAP, G=GLOBAL_REGION):
    """[n, H] request-ordered hit columns over Zipf-0.99 local slots: lean
    (each request on one row, row-local ids) or coupled (requests over
    up to three rows, ids < n*H); global hits on global slots with
    ``with_global``. Returns (slots, deltas, maxes, windows, req_ids,
    fresh, bucket, is_global), rows padded with slot L. A request's cells
    are distinct, as a storage stages them (two hits of one request on
    one cell can flip its verdict every sweep, to the cap)."""
    cols = [[[] for _ in range(n)] for _ in range(8)]
    R = n * H if coupled else H
    local = [0] * n
    seen = set()
    keys = zipf_keys(L - G, 3 * n * H, 0.99, rng) + G
    ki = r = 0
    while r < R - 1 and ki < keys.size - 3:
        home = int(rng.integers(0, n))
        k = int(rng.integers(1, 4))
        rows = [home] + ([int(x) for x in rng.integers(0, n, k - 1)]
                         if coupled else [home] * (k - 1))
        if any(len(cols[0][x]) + rows.count(x) > H - 1 for x in rows):
            break
        rid = r if coupled else local[home]
        mine = set()
        for x in rows:
            glob = with_global and rng.random() < 0.3
            slot = int(rng.integers(0, G)) if glob else int(keys[ki])
            ki += 1
            if (x, slot) in mine:
                continue
            mine.add((x, slot))
            if slot not in lanes:
                lanes[slot] = _lane(rng)
            is_bucket, maxv, win = lanes[slot]
            if glob:
                is_bucket, maxv = False, int(rng.choice([1 << 30, 100]))
            vals = (slot, int(rng.choice([0, 1, 1, 1, 2, 5, 7])), maxv, win,
                    rid, (x, slot) not in seen and rng.random() < 0.15,
                    is_bucket, glob)
            for c, v in zip(cols, vals):
                c[x].append(v)
            seen.add((x, slot))
        if coupled:
            r += 1
        else:
            local[home] += 1
            r = max(local)
    fills = (L, 0, NEVER, 0, R - 1, False, False, False)
    dtypes = (np.int32,) * 5 + (bool,) * 3
    out = []
    for c, fill, dt in zip(cols, fills, dtypes):
        arr = np.full((n, H), fill, dt)
        for x in range(n):
            arr[x, :len(c[x])] = c[x]
        out.append(arr)
    return tuple(out)


def _sharded_kernels(dev, rng, record):
    """B7a-B7d against their plain versions on the card over the
    phase-10a table ([8, 1<<17 + 1]): B7a in its four variants at 8, 1024
    and 2048 hits a row on both routes (the thread-block clusters and one
    block a row) and coupled at 4096 a row on the rows route (past the
    cluster), B7b at 64 slots a row, B7c at 8 hits a row, B7d at k = 64;
    times, bounds and library times as the other kernels'."""
    import torch

    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.parallel import mesh as M

    now_ms = 5_000_000
    n, L, G = SHARDS, LOCAL_CAP, GLOBAL_REGION
    lanes = {}
    base_np = _sharded_table(rng, now_ms, lanes)
    base = M.ShardedCounterState(*(torch.from_numpy(a).to(dev)
                                   for a in base_np))

    def tables():
        return (M.ShardedCounterState(*(t.clone() for t in base)),)

    def rows_bytes(fn_bytes, cols, after):
        return sum(fn_bytes(tuple(c[x] for c in cols),
                            [a[x] for a in base_np], [a[x] for a in after],
                            now_ms) for x in range(n))

    routes = (("sharded_check_and_update_cluster", "cluster",
               "check_cluster_kernel"),
              ("sharded_check_and_update", "rows",
               ("check_kernel", "global_sum_kernel")))
    for H in SHARDED_HS + SHARDED_ROWS_HS:
        for coupled, has_global in B7A_VARIANTS:
            if H in SHARDED_ROWS_HS and (coupled, has_global) != (True,
                                                                  False):
                continue
            cols_np = _sharded_batch(rng, H, lanes, coupled, has_global)
            cols = tuple(torch.from_numpy(a).to(dev) for a in cols_np)
            (tb,) = tables()
            rb = M.sharded_check_and_update_plain(tb, *cols, now_ms, G,
                                                  coupled, has_global)
            plain_ms = _median_ms(
                lambda t: M.sharded_check_and_update_plain(
                    t, *cols, now_ms, G, coupled, has_global),
                tables, reps=3, warmup=1)
            after = _host(tb)
            nbytes = rows_bytes(
                lambda c, before, aft, now: _check_bytes(
                    c[:7], before, aft, now, scratch=L), cols_np, after)
            if has_global:
                # each hit's flag, and every row's partial (value and
                # expiry) of each global slot the batch touches
                touched = np.unique(cols_np[0][cols_np[7]])
                nbytes += n * H + 8 * n * touched.size
            variant = ("coupled" if coupled else "lean") + (
                "+global" if has_global else "")
            # one cluster of n*H hits, or (lean, no global hit) one of H
            # a row
            span = n * H if coupled or has_global else H
            for name, route, kernel in routes:
                if route == "cluster" and span > K.CLUSTER_MAX_HITS:
                    continue
                kw = dict(global_region=G, coupled=coupled,
                          has_global=has_global, route=route)
                (ta,) = tables()
                _, ra = M.sharded_check_and_update(ta, *cols, now_ms, **kw)
                torch.cuda.synchronize()
                err = _max_abs_err(list(zip(ra, rb)) + list(zip(ta, tb)))
                ms = _median_ms(
                    lambda t: M.sharded_check_and_update(t, *cols, now_ms,
                                                         **kw), tables)
                dms = _device_ms(
                    lambda t: M.sharded_check_and_update(t, *cols, now_ms,
                                                         **kw),
                    tables, kernel)
                record(name, f"{variant}/{H}", err, ms, plain_ms, nbytes,
                       device_ms=dms)
    # B7c: per-row update, large deltas included
    H = 8
    slots, deltas, _m, wins, _r, fresh, bucket, _g = _sharded_batch(
        rng, H, lanes, False, True)
    deltas = np.where(rng.random((n, H)) < 0.1,
                      rng.integers(-5, 1 << 30, (n, H)),
                      deltas).astype(np.int32)
    upd_np = (slots, deltas, wins, fresh, bucket)
    upd = tuple(torch.from_numpy(a).to(dev) for a in upd_np)
    (ta,), (tb,) = tables(), tables()
    M.sharded_update(ta, *upd, now_ms)
    M.sharded_update_plain(tb, *upd, now_ms)
    torch.cuda.synchronize()
    err = _max_abs_err(list(zip(ta, tb)))
    ms = _median_ms(lambda t: M.sharded_update(t, *upd, now_ms), tables)
    plain_ms = _median_ms(lambda t: M.sharded_update_plain(t, *upd, now_ms),
                          tables, reps=5, warmup=1)
    dms = _device_ms(lambda t: M.sharded_update(t, *upd, now_ms), tables,
                     "update_kernel")
    record("sharded_update", H, err, ms, plain_ms,
           rows_bytes(lambda u, before, aft, now: _update_bytes(
               u, before, aft, now, scratch=L), upd_np, _host(tb)),
           device_ms=dms)
    _update_host_forms(dev, rng, record, base, base_np, lanes, now_ms)
    # B7b: per-row clears, padding and duplicates included
    K_ = 64
    rows_np = rng.integers(G, L, (n, K_)).astype(np.int32)
    rows_np[:, :4] = rng.integers(0, G, 4)  # global slots on every row
    rows_np[rng.random((n, K_)) < 0.2] = L
    rows = torch.from_numpy(rows_np).to(dev)
    (ta,), (tb,) = tables(), tables()
    M.sharded_clear_cells(ta, rows)
    M.sharded_clear_cells_plain(tb, rows)
    torch.cuda.synchronize()
    err = _max_abs_err(list(zip(ta, tb)))
    flat = (torch.arange(n, device=dev)[:, None] * (L + 1)
            + rows.long()).reshape(-1)
    stacked = torch.stack([t.reshape(-1) for t in base])
    ms = _median_ms(lambda t: M.sharded_clear_cells(t, rows), tables)
    plain_ms = _median_ms(lambda t: M.sharded_clear_cells_plain(t, rows),
                          tables)
    lib_ms = _median_ms(lambda t: t.index_fill_(1, flat, 0),
                        lambda: (stacked.clone(),))
    dms = _device_ms(lambda t: M.sharded_clear_cells(t, rows), tables,
                     "sharded_clear_kernel")
    distinct = sum(np.unique(rows_np[x]).size for x in range(n))
    record("sharded_clear_cells", K_, err, ms, plain_ms,
           4 * n * K_ + 12 * distinct, lib_ms, dms)
    _clear_host_forms(dev, rng, record, base, rows_np, ta, lib_ms)
    return _sharded_drains(dev, rng, record)


def _sharded_drains(dev, rng, record):
    """B7d against its plain version: the device-tensor call (one launch
    of B5's one-pass kernel over the rows, at the kernel's own blocks a
    row and forced to 32 and to 16, a wave of 128 blocks) and the host
    form (``sharded_drain_top_hits_host``, the rows' answers in the
    context's mapped buffer) on every column kind at k in DRAIN_KS and
    1025 (the full sort), over [8, 1<<17 + 1] and [3, 1<<10 + 1], with
    two drains in a row on one context. Times over [8, 1<<17 + 1]: on
    Zipf, uniform random ("wide") and INT_MIN/INT_MAX columns at k = 64
    and 1024, the call and the kernel alone at the kernel's rule and at
    32 and 16 blocks a row, plain and ``topk(dim=1)`` + ``zero_``; the
    host form on Zipf at k = 64 (from the call to the numpy answers, its
    host time split into steps). Returns whether every case was
    exact."""
    import torch

    from limitador_tpu_torch.parallel import mesh as M

    n, L = SHARDS, LOCAL_CAP
    # the kernel's own rule (one block a round, 32 a row here, for k up
    # to 256; one wave, 16 a row, past it), then 32 and 16 forced
    rows_blocks = (0, 32, 16)

    def columns(kind, rows, width):
        return torch.from_numpy(np.stack([_hit_column(rng, kind, width)
                                          for _ in range(rows)])).to(dev)

    err = 0
    for rows, width in ((n, L), (3, DRAIN_SMALL_C)):
        for kind in DRAIN_KINDS:
            col = columns(kind, rows, width)
            state = M.ShardedCounterState(torch.zeros_like(col),
                                          torch.zeros_like(col), col.clone())
            ctx = _bound_ctx(state)
            for k in DRAIN_KS + (1025,):
                k = min(k, width)
                want = M.sharded_drain_top_hits_plain(col.clone(), k)
                for blocks in rows_blocks:
                    err = max(err, _max_abs_err(zip(M.sharded_drain_top_hits(
                        col.clone(), k, blocks=blocks), want)))
                for _again in range(2):  # the header back at 0 each time
                    state.hits.copy_(col)
                    counts, slots = M.sharded_drain_top_hits_host(ctx, k)
                    err = max(err, _max_abs_err(zip(
                        (torch.from_numpy(counts), torch.from_numpy(slots),
                         state.hits), (want[1].cpu(), want[2].cpu(),
                                       want[0]))))
            ctx.close()
    print(f"  sharded_drain_top_hits {len(DRAIN_KINDS)} column kinds x k in "
          f"{DRAIN_KS + (1025,)} x [8, 1<<17 + 1] and [3, 1<<10 + 1], the "
          f"call at {rows_blocks} blocks a row (0: the kernel's rule) and "
          f"the host form twice: err={err}")
    exact = err == 0
    cols = {kind: columns(kind, n, L) for kind in ("zipf", "wide",
                                                   "extremes")}
    for (kind, col), k in itertools.product(cols.items(), (64, 1024)):
        def column(col=col):
            return (col.clone(),)

        ha, hb = col.clone(), col.clone()
        err = _max_abs_err(zip(M.sharded_drain_top_hits(ha, k),
                               M.sharded_drain_top_hits_plain(hb, k)))
        nbytes = 8 * n * (L + 1) + 8 * n * k
        lib_ms = _median_ms(
            lambda h: (torch.topk(h[:, :-1], k, dim=1), h.zero_()), column)
        plain_ms = _median_ms(lambda h: M.sharded_drain_top_hits_plain(h, k),
                              column, reps=10, warmup=1)
        for blocks in rows_blocks:
            shape = (k if kind == "zipf" else f"{kind}/{k}") if not blocks \
                else f"{kind}/{k}/blocks{blocks}"  # 0: the kernel's rule
            record("sharded_drain_top_hits", shape, err,
                   _median_ms(lambda h: M.sharded_drain_top_hits(
                       h, k, blocks=blocks), column),
                   plain_ms, nbytes, lib_ms,
                   _device_ms(lambda h: M.sharded_drain_top_hits(
                       h, k, blocks=blocks), column, "drain_kernel"))
    # the host form, the sharded storage's path, at the default
    # --usage-topk
    k = 64
    zipf = cols["zipf"]
    state = M.ShardedCounterState(torch.zeros_like(zipf),
                                  torch.zeros_like(zipf), zipf.clone())
    ctx = _bound_ctx(state)

    def refill():
        state.hits.copy_(zipf)
        return ()

    def call():
        return M.sharded_drain_top_hits_host(ctx, k)

    def tensor_path():
        _, counts, slots = M.sharded_drain_top_hits(state.hits, k)
        return counts.cpu().numpy(), slots.cpu().numpy()

    refill()
    got = call()
    _, want_c, want_s = M.sharded_drain_top_hits_plain(zipf.clone(), k)
    err = max(int(np.abs(g.astype(np.int64) - w.cpu().numpy()).max())
              for g, w in zip(got, (want_c, want_s)))
    row = record(
        "sharded_drain_top_hits", f"host/{k}", err, _median_ms(call, refill),
        _median_ms(lambda: M.sharded_drain_top_hits_host_plain(state, k),
                   refill, reps=10, warmup=1),
        8 * n * (L + 1) + 8 * n * k,
        _median_ms(lambda h: (torch.topk(h[:, :-1], k, dim=1), h.zero_()),
                   lambda: (zipf.clone(),)),
        _device_ms(call, refill, "drain_kernel"),
        _median_ms(tensor_path, refill))
    handle = ctx.handle
    row["host_breakdown_us"] = _host_breakdown(
        f"B7d host form, k={k} (each step on a refilled table)", {
            "C call (launch, wait)": lambda: ctx.drain_fn(handle, k),
            "answers copied out": lambda: (
                ctx.results[:n * k].reshape(n, k, 2)[:, :, 0].copy(),
                ctx.results[:n * k].reshape(n, k, 2)[:, :, 1].copy()),
            "the whole wrapper": call,
            "device-tensor call and two downloads": tensor_path,
        }, reps=300, setup=refill)
    ctx.close()
    return exact and err == 0


def _update_entries(rng, count, lanes, straddle, n=SHARDS, L=LOCAL_CAP,
                   G=GLOBAL_REGION):
    """A B7c host list of ``count`` (row, slot, delta, window, flags)
    entries: local slots Zipf-0.99 over [G, L) on any row (repeated
    cells), a quarter global slots on any row (the row a delta is
    applied on), lanes from ``lanes`` with 3% of bucket flags flipped
    (cells mixing buckets and windows), 10% fresh, deltas 0 to 3 with 6%
    at and past the caps or negative; entries straddle - 1 and straddle
    are one cell, not fresh and then fresh."""
    rows = rng.integers(0, n, count)
    glob = rng.random(count) < 0.25
    slots = np.where(glob, rng.integers(0, G, count),
                     zipf_keys(L - G, count, 0.99, rng) + G)
    lane = [lanes.setdefault(int(x), (False, 1 << 30, 60_000) if x < G
                             else _lane(rng)) for x in slots]
    bucket = np.array([a for a, _m, _w in lane], bool)
    bucket ^= rng.random(count) < 0.03
    wins = np.array([w for _a, _m, w in lane], np.int64)
    deltas = rng.integers(0, 4, count)
    edge = rng.random(count) < 0.06
    deltas[edge] = rng.choice([-5, (1 << 30) - 1, 1 << 30, (1 << 31) - 1],
                              int(edge.sum()))
    fresh = rng.random(count) < 0.1
    if 1 <= straddle < count:
        i = straddle
        rows[i], slots[i] = rows[i - 1], slots[i - 1]
        bucket[i], wins[i] = bucket[i - 1], wins[i - 1]
        fresh[i - 1], fresh[i] = False, True
    flags = fresh.astype(np.int64) | bucket.astype(np.int64) << 1
    return np.stack([rows, slots, deltas, wins, flags],
                    axis=1).astype(np.int32)


def _padded_update(entries, n=SHARDS, L=LOCAL_CAP):
    """The JAX-shaped [n, H] columns of a B7c host list (what the parent
    tree stages): each row's entries in list order, padded with slot L;
    H a power of two, 8 at least."""
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
    return cols


def _update_host_forms(dev, rng, record, base, base_np, lanes, now_ms):
    """B7c's host form (``sharded_update_host``) against the JAX-shaped
    plain version on the padded columns, at UPDATE_HOST_COUNTS entries,
    a cell straddling the capacity (2000: the parameter block; 2001: one
    staged copy, still one launch); each call timed from the list to the
    launched kernel beside the parent's path for the same list (pad to
    [n, H], two pinned uploads, the device-tensor launch), the kernel
    alone by the profiler, and the host time of a Report of 8 split into
    its steps."""
    import torch

    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.parallel import mesh as M

    for count in UPDATE_HOST_COUNTS:
        entries = _update_entries(rng, count, lanes, min(count - 1, 2000))
        padded = _padded_update(entries)
        d_padded = [torch.from_numpy(a).to(dev) for a in padded]
        ctx = _bound_ctx(M.ShardedCounterState(*(t.clone() for t in base)))
        want = M.ShardedCounterState(*(t.clone() for t in base))
        before = K.launches["sharded_update_host"]
        M.sharded_update_host(ctx, entries, now_ms)
        launched = K.launches["sharded_update_host"] - before
        M.sharded_update_plain(want, *d_padded, now_ms)
        torch.cuda.synchronize()
        err = _max_abs_err(zip(ctx.state, want))
        if launched != 1:
            fail(f"B7c host form at {count} entries: {launched} launches")

        def call():
            M.sharded_update_host(ctx, entries, now_ms)

        def parent():
            ints = np.stack(padded[:3])
            flags = np.stack(padded[3:])
            d_ints, d_flags = _pinned(dev, ints, flags)
            M.sharded_update(ctx.state, *d_ints, *d_flags, now_ms)

        distinct = np.unique(entries[:, 0].astype(np.int64) * (LOCAL_CAP + 1)
                             + entries[:, 1]).size
        row = record(
            "sharded_update", f"host/{count}", err, _median_ms(call),
            _median_ms(lambda: M.sharded_update_host_plain(
                want, entries, now_ms), reps=5, warmup=1),
            16 * count + 24 * distinct, None,
            _device_ms(call, None, ("update_list_kernel",
                                    "update_staged_kernel")),
            _median_ms(parent))
        if count == 8:
            data, handle = entries.tobytes(), ctx.handle
            row["host_breakdown_us"] = _host_breakdown(
                f"B7c host form, {count} entries", {
                    "list from Python tuples": lambda: np.asarray(
                        [tuple(e) for e in entries.tolist()], np.int32),
                    "list as bytes": lambda: entries.tobytes(),
                    "C call (list into the parameter block, launch)":
                        lambda: ctx.sharded_update_fn(
                            handle, data, count, now_ms),
                    "the whole wrapper": call,
                    "the parent's path": parent,
                })
        ctx.close()


# -- phase 4 ----------------------------------------------------------------

LIMITS_YAML = """\
- namespace: api
  max_value: 5
  seconds: 60
  conditions: ["descriptors[0].method == 'GET'"]
  variables: ["descriptors[0].user"]
  name: per-user-get
- namespace: api
  max_value: 40
  seconds: 3600
  name: api-total
- namespace: api
  max_value: 8
  seconds: 30
  variables: ["descriptors[1].tenant"]
  name: per-tenant
- namespace: tb
  max_value: 4
  seconds: 2
  variables: ["descriptors[0].user"]
  policy: token_bucket
  name: bucket
"""

RELOADED_YAML = """\
- namespace: api
  max_value: 7
  seconds: 60
  conditions: ["descriptors[0].method == 'GET'"]
  variables: ["descriptors[0].user"]
  name: per-user-get
- namespace: api
  max_value: 40
  seconds: 3600
  name: api-total
- namespace: tb
  max_value: 4
  seconds: 2
  variables: ["descriptors[0].user"]
  policy: token_bucket
  name: bucket
"""


class ManualClock:
    """Wall time frozen at start, advanced only by the script, so the
    server and its in-memory oracle see the same instants."""

    def __init__(self):
        self.now = float(int(time.time()))

    def __call__(self):
        return self.now


def _rls_request(rls_pb2, domain, descriptors, hits_addend=0) -> bytes:
    req = rls_pb2.RateLimitRequest(domain=domain, hits_addend=hits_addend)
    for entries in descriptors:
        d = req.descriptors.add()
        for k, v in entries.items():
            d.entries.add(key=k, value=v)
    return req.SerializeToString()


def _main_path_steps(rls_pb2):
    """(rpc, request bytes, clock advance in s before it, reload?)."""
    envoy = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
    kuadrant = "/kuadrant.service.ratelimit.v1.RateLimitService/"
    req = functools.partial(_rls_request, rls_pb2)
    steps = []
    for user in ("a", "b"):
        for i in range(7):  # up to and past per-user-get's max of 5
            steps.append((envoy, req("api", [
                {"method": "GET", "user": user}, {"tenant": "t1"}]), 0.0,
                False))
    steps.append((envoy, req("api", [{"method": "POST", "user": "c"},
                                     {"tenant": "t2"}], 3), 0.25, False))
    steps.append((kuadrant + "CheckRateLimit", req("api", [
        {"method": "GET", "user": "c"}, {"tenant": "t2"}]), 0.0, False))
    steps.append((kuadrant + "Report", req("api", [
        {"method": "GET", "user": "c"}, {"tenant": "t2"}], 4), 0.0, False))
    steps.append((kuadrant + "CheckRateLimit", req("api", [
        {"method": "GET", "user": "c"}, {"tenant": "t2"}]), 0.0, False))
    for i in range(6):
        steps.append((envoy, req("tb", [{"user": "u"}], 1 + i % 2), 0.25,
                      False))
    steps.append((kuadrant + "Report", req("tb", [{"user": "u"}], 2), 0.0,
                  False))
    steps.append((kuadrant + "CheckRateLimit", req("tb", [{"user": "u"}]),
                  0.0, False))
    # hot reload: per-tenant (with live counters) goes, a max changes
    steps.append((envoy, req("api", [{"method": "GET", "user": "a"},
                                     {"tenant": "t1"}]), 0.5, True))
    steps.append((envoy, req("api", [{"method": "GET", "user": "a"},
                                     {"tenant": "t1"}]), 0.0, False))
    # 13 days on: the device epoch rebases before the next decision
    steps.append((envoy, req("api", [{"method": "GET", "user": "a"},
                                     {"tenant": "t1"}]), 13 * 86400.0,
                  False))
    for i in range(4):
        steps.append((envoy, req("tb", [{"user": "u"}], 2), 0.0, False))
        steps.append((kuadrant + "Report", req("api", [
            {"method": "GET", "user": "d"}, {"tenant": "t1"}]), 0.0, False))
        steps.append((kuadrant + "CheckRateLimit", req("api", [
            {"method": "GET", "user": "d"}, {"tenant": "t1"}]), 0.0, False))
    return steps


def _same_answer(rls_pb2, got: bytes, want: bytes) -> bool:
    """Same code and headers; X-RateLimit-Reset within 1 s (the device
    counts whole milliseconds, the oracle float seconds)."""
    g = rls_pb2.RateLimitResponse.FromString(got)
    w = rls_pb2.RateLimitResponse.FromString(want)
    gh = {h.key: h.value for h in g.response_headers_to_add}
    wh = {h.key: h.value for h in w.response_headers_to_add}
    if g.overall_code != w.overall_code or gh.keys() != wh.keys():
        return False
    for key in gh:
        if key == "X-RateLimit-Reset":
            if abs(int(gh[key]) - int(wh[key])) > 1:
                return False
        elif gh[key] != wh[key]:
            return False
    return True


# Phase 6 serves the phase-4 limits plus a namespace whose limits all
# vectorize, so single-descriptor ShouldRateLimit rides the native lanes
# (the api namespace's descriptors[1] variable sends it to the exact path).
NATIVE_NS_YAML = """\
- namespace: nat
  max_value: 5
  seconds: 60
  conditions: ["descriptors[0].method == 'GET'"]
  variables: ["descriptors[0].user"]
  name: nat-per-user
- namespace: nat
  max_value: 400
  seconds: 600
  name: nat-total
"""


def _native_steps(rls_pb2):
    """Phase 4's steps, with single-descriptor nat requests past their
    per-user limit before and after them."""
    envoy = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
    nat = [(envoy, _rls_request(rls_pb2, "nat", [
        {"method": "GET", "user": f"n{i % 3}"}], i % 3), 0.0, False)
        for i in range(24)]
    return nat + _main_path_steps(rls_pb2) + nat


def _lat_blob(rls_pb2, i, native):
    if native:
        return _rls_request(rls_pb2, "nat", [
            {"method": "GET", "user": f"lat{i % 50}"}])
    return _rls_request(rls_pb2, "api", [
        {"method": "GET", "user": f"lat{i % 50}"}, {"tenant": "t1"}])


async def _main_path(tmpdir, dev, native=False, plane=None):
    """Phase 4 (standard pipeline, draft-03 headers) or, with ``native``,
    phase 6 (the native pipeline; headers off, as the native handler
    serves only then). With ``plane`` (a dict, filled in), phase 12a: the
    same drive with --native-trace-sample 64 --slo-budget-ms 2, every call
    sending its own x-request-id, the device plane's tallies held against
    the pipelines' own (``_plane_checks``) and the latency calls' phase
    split printed."""
    import grpc

    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "native main path" if native else "main path"
    if plane is not None:
        label = f"device plane (12a, {'native' if native else 'standard'})"
    extra_yaml = NATIVE_NS_YAML if native else ""
    limits = os.path.join(tmpdir, "limits.yaml")
    with open(limits, "w") as f:
        f.write(LIMITS_YAML + extra_yaml)
    clock = ManualClock()
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    options = ["--rls-host", "127.0.0.1", "--rate-limit-headers",
               "NONE" if native else "DRAFT_VERSION_03"]
    device_options = ["--device", dev.type]
    if native:
        device_options += [
            "--pipeline", "native", "--native-hot-lane", "on",
            "--lease-mode", "off", "--usage-topk", "64",
            "--usage-drain-interval", "0.25",
        ]
    if plane is not None:
        device_options += ["--native-trace-sample", "64",
                           "--slo-budget-ms", "2"]
    parse = server.build_parser().parse_args
    K.reset_launches()
    t0 = time.perf_counter()
    tier_failures = []  # a usage drain or lease refresh that raised
    gpu_http, gpu_http_port = _http_options()
    gpu = await server.start(parse(
        [limits, "torch", *options, *device_options, *gpu_http,
         "--rls-port", str(ports[0])]), clock=clock,
        on_failure=tier_failures.append)
    oracle = await server.start(parse(
        [limits, "memory", *options, *_http_options()[0],
         "--rls-port", str(ports[1])]), clock=clock)
    answers = mismatches = 0
    sent = set()
    metadata = None
    if plane is not None:
        tally = _plane_spies(gpu)

        def metadata():
            rid = f"smoke12-{len(sent)}"
            sent.add(rid)
            return (("x-request-id", rid),)
    try:
        async with grpc.aio.insecure_channel(f"127.0.0.1:{ports[0]}") as gc, \
                grpc.aio.insecure_channel(f"127.0.0.1:{ports[1]}") as oc:
            steps = (_native_steps(rls_pb2) if native
                     else _main_path_steps(rls_pb2))
            for i, (rpc, blob, advance, reload) in enumerate(steps):
                clock.now += advance
                if reload:
                    with open(limits, "w") as f:
                        f.write(RELOADED_YAML + extra_yaml)
                    st = os.stat(limits)
                    os.utime(limits, ns=(st.st_atime_ns,
                                         st.st_mtime_ns + 10**9))
                    deadline = time.monotonic() + 20
                    while (gpu.status["limits_file_version"] < 2
                           or oracle.status["limits_file_version"] < 2
                           or len(gpu.limiter.get_limits("api")) != 2
                           or len(oracle.limiter.get_limits("api")) != 2):
                        if time.monotonic() > deadline:
                            fail("hot reload not applied within 20 s")
                        await asyncio.sleep(0.05)
                got = await gc.unary_unary(rpc)(
                    blob, timeout=60,
                    metadata=metadata() if metadata else None)
                want = await oc.unary_unary(rpc)(blob, timeout=60)
                answers += 1
                if not _same_answer(rls_pb2, got, want):
                    mismatches += 1
                    print(f"  step {i} {rpc.rsplit('/', 1)[1]}: port "
                          f"{rls_pb2.RateLimitResponse.FromString(got)} "
                          f"oracle "
                          f"{rls_pb2.RateLimitResponse.FromString(want)}")
            # served latency on the card: sequential ShouldRateLimit calls
            # (one request in flight, so each waits out the batcher's
            # 500 us linger); the oracle answers each one too, untimed
            envoy = "/envoy.service.ratelimit.v3.RateLimitService/" \
                "ShouldRateLimit"
            lat = []
            if plane is not None:
                # the split covers the latency calls alone
                tally["phases"].clear()
                tally["waits"].clear()
                for costs in tally["cost_ns"].values():
                    costs.clear()
            for i in range(400):
                blob = _lat_blob(rls_pb2, i, native)
                md = metadata() if metadata else None
                t1 = time.perf_counter()
                got = await gc.unary_unary(envoy)(blob, timeout=60,
                                                  metadata=md)
                lat.append(time.perf_counter() - t1)
                want = await oc.unary_unary(envoy)(blob, timeout=60)
                answers += 1
                mismatches += not _same_answer(rls_pb2, got, want)
            lat_ms = np.asarray(lat) * 1e3
            print(f"{label} served latency (sequential gRPC, {dev.type}): "
                  f"p50 "
                  f"{np.percentile(lat_ms, 50):.3f} ms, p99 "
                  f"{np.percentile(lat_ms, 99):.3f} ms over {lat_ms.size} "
                  f"(mean {lat_ms.mean():.3f} ms)")
            print(f"{label} served latency histogram (0.25 ms bins from 0 "
                  f"to 12 ms, then the rest): "
                  f"{np.histogram(np.minimum(lat_ms, 12.1), np.r_[np.arange(0, 12.01, 0.25), np.inf])[0].tolist()}")
            # the layers of the served call: the MetricsLayer's
            # should_rate_limit aggregate of datastore spans, and the
            # batcher's queue-excluded device round trip
            families = await _served_metrics(gpu_http_port)
            for hist in ("datastore_latency", "datastore_device_latency"):
                print(f"{label} /metrics {hist}: "
                      f"{json.dumps(_histogram(families, hist))}")
            if plane is not None:
                plane.update(await _plane_checks(
                    label, gpu, gpu_http_port, tally, sent, lat_ms,
                    native, plane["card"], dev.type == "cuda"))
            if native:
                # the observatory drains every 0.25 s; wait for one more
                drains = gpu.observatory.tenant_usage()["drains"]
                deadline = time.monotonic() + 10
                while gpu.observatory.tenant_usage()["drains"] <= drains:
                    if time.monotonic() > deadline:
                        fail("the usage observatory did not drain")
                    await asyncio.sleep(0.05)
                print(f"{label} usage top-3: "
                      f"{[(r['namespace'], r['key'], r['hits']) for r in gpu.observatory.top(3)]}")
                lane = gpu.native_pipeline.lane_stats()
                print(f"{label} hot lane: {json.dumps(lane)}")
                rows = _metric(await _served_metrics(gpu_http_port),
                               "native_lane_rows")
                if rows != lane["hits"] or rows == 0:
                    fail(f"{label}: /metrics native_lane_rows {rows} != "
                         f"lane_stats hits {lane['hits']}")
                print(f"{label}: /metrics native_lane_rows {int(rows)} "
                      "equals the hot lane's hits")
            final = {}
            for name, srv in (("gpu", gpu), ("oracle", oracle)):
                got = {}
                for ns in ("api", "tb", "nat"):
                    counters = srv.limiter.get_counters(ns)
                    if asyncio.iscoroutine(counters):
                        counters = await counters
                    for c in counters:
                        got[(ns, c.limit.name,
                             tuple(c.set_variables.items()))] = (
                            c.remaining, c.expires_in)
                final[name] = got
    finally:
        await gpu.stop()
        await oracle.stop()
    launches = dict(K.launches)
    seconds = time.perf_counter() - t0
    same_final = final["gpu"].keys() == final["oracle"].keys() and all(
        final["gpu"][k][0] == final["oracle"][k][0]
        and abs(final["gpu"][k][1] - final["oracle"][k][1]) <= 0.002
        for k in final["gpu"])
    print(f"{label}: {answers} gRPC answers in {seconds:.2f}s, "
          f"{mismatches} differ from the in-memory oracle; final counters "
          f"{'agree' if same_final else 'DIFFER'} ({len(final['gpu'])} live)")
    print(f"{label} launches: {json.dumps(launches)}")
    if mismatches or not same_final:
        fail(f"the {label} disagrees with the in-memory oracle")
    if tier_failures:
        fail(f"a background tier of the {label} failed: "
             f"{tier_failures[0]!r}")
    required = PHASE6_KERNELS if native else PHASE4_KERNELS
    missing = [name for name in required if _launched(launches, name) == 0]
    if missing:
        fail(f"kernels not launched on the {label}: {missing}")
    return launches


# -- phase 12 ---------------------------------------------------------------


def _count_calls(obj, name, tally, key):
    """Count the calls of ``obj.name`` into ``tally[key]`` (an instance
    attribute over the method: the pipelines call it through ``self``)."""
    fn = getattr(obj, name)

    def counted(*args, **kwargs):
        tally[key] += 1
        return fn(*args, **kwargs)

    setattr(obj, name, counted)


def _count_flushes(obj, tally, key):
    """Count a pipeline's flushes that take a non-empty queue."""
    flush = obj._flush

    async def counted(shard, *args):
        if shard.pending:
            tally[key] += 1
        return await flush(shard, *args)

    obj._flush = counted


def _plane_spies(server):
    """The pipelines' own tallies, independent of the recorder: requests
    entering each queue, flushes, begins (batches) and the native lane's
    exact-path rows; plus every phase dict and check-path queue wait the
    recorder is handed (for the split)."""
    tally = dict.fromkeys((
        "micro_submits", "compiled_submits", "native_submits",
        "compiled_flushes", "native_flushes", "begins", "native_begins",
        "exact_rows", "update_submits", "applies", "compiled_live"), 0)
    storage = server.limiter.storage.counters
    _count_calls(storage.batcher, "submit", tally, "micro_submits")
    _count_calls(storage.update_batcher, "submit", tally, "update_submits")
    _count_calls(storage.inner, "begin_check_many", tally, "begins")
    _count_calls(storage.inner, "apply_deltas", tally, "applies")
    limiter = server.limiter
    if hasattr(limiter, "submit_check"):
        _count_calls(limiter, "submit_check", tally, "compiled_submits")
        _count_flushes(limiter, tally, "compiled_flushes")
        collect = limiter._collect_batch

        def counted_collect(handle, live, *args):
            # the compiled lane records the rows that had counters
            tally["compiled_live"] += len(live)
            return collect(handle, live, *args)

        limiter._collect_batch = counted_collect
    pipeline = server.native_pipeline
    if pipeline is not None:
        _count_calls(pipeline, "submit", tally, "native_submits")
        _count_calls(pipeline, "_timed_begin_batch", tally, "native_begins")
        _count_calls(pipeline, "_decide_exact", tally, "exact_rows")
        _count_flushes(pipeline, tally, "native_flushes")
    rec = storage.recorder
    tally["phases"], tally["waits"] = [], []
    # the recorder's own host time, by method (record_batch includes its
    # record_phases)
    tally["cost_ns"] = {"record_flush": [], "record_chunks": [],
                        "record_batch": []}
    record_phases, record_flush = rec.record_phases, rec.record_flush

    def phases_tap(phases):
        tally["phases"].append(dict(phases))
        record_phases(phases)

    def flush_tap(reason, fill, waits, batcher="check"):
        waits = list(waits)
        if batcher == "check":
            tally["waits"].extend(waits)
        record_flush(reason, fill, waits, batcher)

    rec.record_phases, rec.record_flush = phases_tap, flush_tap

    def timed(name):
        fn = getattr(rec, name)

        def run(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                tally["cost_ns"][name].append(time.perf_counter_ns() - t0)

        setattr(rec, name, run)

    for name in tally["cost_ns"]:
        timed(name)
    return tally


def _count_of(families, name, **labels):
    fam = families[name]
    return sum(s.value for s in fam.samples if s.name == name + "_count"
               and all(s.labels.get(k) == v for k, v in labels.items()))


async def _plane_checks(label, server, http_port, tally, sent, lat_ms,
                        native, card, want_backed):
    """Phase 12a's equalities on a served drive, and the phase split of
    its latency calls (p50 and p99 of every phase and of the queue wait,
    each p50 as a share of the served p50)."""
    families = await _served_metrics(http_port)
    stats = json.loads(await _served_get(http_port, "/debug/stats"))
    flushes = _metric(families, "batcher_flushes", batcher="check")
    own_flushes = (_count_of(families, "batcher_flush_size")
                   + tally["compiled_flushes"] + tally["native_flushes"])
    decisions_in = (tally["micro_submits"] + tally["compiled_submits"]
                    + tally["native_submits"])
    decided = (tally["micro_submits"] + tally["compiled_live"]
               + tally["native_submits"] - tally["exact_rows"])
    batches = tally["begins"] + tally["native_begins"]
    waits = _count_of(families, "batcher_queue_wait", batcher="check")
    update_flushes = _metric(families, "batcher_flushes", batcher="update")
    update_waits = _count_of(families, "batcher_queue_wait", batcher="update")
    phase_counts = {
        phase: _count_of(families, "device_phase_latency", phase=phase)
        for phase in ("dispatch", "host_cache", "native_lane", "host_stage",
                      "device_sync", "unpack")}
    lookups = _count_of(families, "native_phase_hot_lookup")
    slo = server.native_plane.slo_status()
    backed = _metric(families, "device_backed")
    rids = {e["request_id"] for e in stats["flight_recorder"]
            if e["request_id"] is not None}
    lane = (server.native_pipeline.lane_stats()
            if server.native_pipeline is not None else {})
    print(f"{label}: batcher_flushes {flushes:.0f} (the pipelines' own "
          f"flush tally {own_flushes:.0f}); queue waits {waits:.0f} for "
          f"{decisions_in} requests; phases {json.dumps(phase_counts)} for "
          f"{batches} batches; update flushes {update_flushes:.0f} for "
          f"{tally['applies']} applies, update queue waits "
          f"{update_waits:.0f} for {tally['update_submits']} reports; "
          f"native_phase_hot_lookup {lookups:.0f} for "
          f"{tally['native_begins']} lane begins (lane_stats "
          f"{json.dumps(lane)}); SLO samples {slo['samples_1h']} for "
          f"{decided} decided; device_backed {backed:.0f}; flight recorder "
          f"{len(stats['flight_recorder'])} entries, {len(rids)} request "
          f"ids, all sent: {rids <= sent}")
    checks = [
        ("batcher_flushes", flushes, own_flushes),
        ("batcher_queue_wait count", waits, decisions_in),
        ("update flushes", update_flushes, tally["applies"]),
        ("update queue waits", update_waits, tally["update_submits"]),
        ("native_phase_hot_lookup count", lookups, tally["native_begins"]),
        ("SLO samples", slo["samples_1h"], decided),
        ("device_backed", backed, 1 if want_backed else 0),
    ]
    for phase in ("dispatch", "host_stage", "device_sync", "unpack"):
        checks.append((f"device_phase_latency {phase}",
                       phase_counts[phase], batches))
    for phase in ("host_cache", "native_lane"):
        checks.append((f"device_phase_latency {phase}", phase_counts[phase],
                       tally["native_begins"]))
    bad = [(what, got, want) for what, got, want in checks if got != want]
    if bad:
        fail(f"{label}: device-plane tallies differ: {bad}")
    if not rids or not rids <= sent:
        fail(f"{label}: flight recorder request ids {sorted(rids)[:5]} are "
             "not ids the client sent")
    if len(stats["flight_recorder"]) > 32 or \
            stats["device_backed"] is not want_backed:
        fail(f"{label}: /debug/stats flight_recorder or device_backed wrong")
    if native and not lookups:
        fail(f"{label}: the native lane recorded no begin")
    # the split: the latency calls' batches (the compiled, native and
    # micro-batcher paths each hand the recorder their own phases)
    served_p50 = float(np.percentile(lat_ms, 50))
    names = ["queue_wait"] + [p for p in (
        "dispatch", "host_cache", "native_lane", "host_stage",
        "device_sync", "unpack") if any(p in d for d in tally["phases"])]
    split = {}
    for name in names:
        values = (tally["waits"] if name == "queue_wait" else
                  [d[name] for d in tally["phases"] if name in d])
        ms = np.asarray(values, np.float64) * 1e3
        p50 = float(np.percentile(ms, 50))
        split[name] = {"p50_ms": p50,
                       "p99_ms": float(np.percentile(ms, 99)),
                       "share_of_served_p50": p50 / served_p50,
                       "n": int(ms.size)}
    inside = sum(v["p50_ms"] for v in split.values())
    cost = {name: {"calls": len(v),
                   "p50_us": float(np.percentile(v, 50)) / 1e3,
                   "p99_us": float(np.percentile(v, 99)) / 1e3}
            for name, v in tally["cost_ns"].items() if v}
    print(f"{label} recorder host time over the latency calls: "
          + ", ".join(f"{k} {v['calls']} calls p50 {v['p50_us']:.1f} p99 "
                      f"{v['p99_us']:.1f} us" for k, v in cost.items()))
    print(f"{label} split of {lat_ms.size} sequential calls, served p50 "
          f"{served_p50:.4f} ms p99 {float(np.percentile(lat_ms, 99)):.4f} "
          f"ms ({card}): " + ", ".join(
              f"{k} p50 {v['p50_ms']:.4f} p99 {v['p99_ms']:.4f} ms "
              f"({100 * v['share_of_served_p50']:.1f}%)"
              for k, v in split.items())
          + f"; sum of the p50s {inside:.4f} ms, the rest of the served "
          f"p50 {served_p50 - inside:.4f} ms")
    return {"split": split, "recorder_cost": cost,
            "served_p50_ms": served_p50,
            "served_p99_ms": float(np.percentile(lat_ms, 99)),
            "native_telemetry": stats["native_telemetry"],
            "slo": slo, "tally": {k: v for k, v in tally.items()
                                  if k not in ("phases", "waits",
                                               "cost_ns")}}


async def _chunked_drive(dev, dispatch_chunk, keys, flushes, hits):
    """Phase 12b: ``flushes`` flushes of ``hits`` one-hit requests (phase
    5's Zipf keys) through a MicroBatcher with ``dispatch_chunk``, each
    flush enqueued whole before the batcher runs; returns (decisions,
    decisions/s of the timed flushes, the chunk plans' splits)."""
    from limitador_tpu_torch import Counter, Limit
    from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics
    from limitador_tpu_torch.observability.native_plane import SloWatchdog

    clock = ManualClock()
    storage = AsyncTorchStorage(
        TorchStorage(capacity=C, clock=clock, device=dev),
        max_batch_hits=hits, max_delay=0.0005,
        dispatch_chunk=dispatch_chunk)
    metrics = PrometheusMetrics()
    storage.set_metrics(metrics)
    # the recorder feeds a watchdog 1024- and 8192-decision batches here
    # (SloWatchdog's numpy path; the served phases feed it one decision)
    watchdog = SloWatchdog(budget_ms=2.0)
    storage.recorder.slo = watchdog
    limit = Limit("drive", 100, 3600, [], ["u"])
    warm = Limit("warm", 1 << 20, 60, [], ["u"])
    names = [str(k) for k in range(C)]
    try:
        # warm-up flush on other keys (first launches, pinned buffers)
        await asyncio.gather(*[storage.check_and_update(
            [Counter(warm, {"u": names[i]})], 1, False)
            for i in range(hits)])
        decided = []
        t0 = time.perf_counter()
        for b in range(flushes):
            counters = [[Counter(limit, {"u": names[k]})]
                        for k in keys[b * hits:(b + 1) * hits].tolist()]
            auths = await asyncio.gather(*[
                storage.check_and_update(c, 1, False) for c in counters])
            decided.extend(a.limited for a in auths)
        seconds = time.perf_counter() - t0
    finally:
        await storage.close()
    splits = _metric_registry(metrics, "dispatch_chunk_splits")
    samples = watchdog.status()["samples_1h"]
    if samples != (flushes + 1) * hits:
        fail(f"chunked dispatch: the SLO watchdog counted {samples} "
             f"decisions, want {(flushes + 1) * hits}")
    return np.asarray(decided), flushes * hits / seconds, splits


def _metric_registry(metrics, name):
    """(count, sum) of an unlabelled histogram in a PrometheusMetrics."""
    samples = {s.name: s.value for m in metrics.registry.collect()
               if m.name == name for s in m.samples}
    return int(samples[name + "_count"]), int(samples[name + "_sum"])


def phase_chunked(dev, card, flushes=CHUNK_FLUSHES, hits=8192):
    """Phase 12b: the same Zipf flushes through dispatch_chunk=1024 and
    =0: equal decisions (and equal to serial order), B1's cluster once a
    chunk, the chunk counts in dispatch_chunk_splits."""
    from limitador_tpu_torch.ops import kernel as K

    rng = np.random.default_rng(99)  # phase 5's keys
    keys = zipf_keys(C, flushes * hits, 0.99, rng)
    out = {}
    for chunk in (1024, 0):
        K.reset_launches()
        decided, rate, splits = asyncio.run(
            _chunked_drive(dev, chunk, keys, flushes, hits))
        launches = dict(K.launches)
        out[chunk] = (decided, rate, splits, launches)
        print(f"chunked dispatch (12b) dispatch_chunk={chunk}: "
              f"{flushes} flushes x {hits} requests, {rate:.0f} "
              f"decisions/s ({card}); dispatch_chunk_splits count "
              f"{splits[0]} sum {splits[1]}; B1 launches cluster "
              f"{launches['check_and_update_cluster']} one block "
              f"{launches['check_and_update']}")
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.r_[0, np.flatnonzero(sk[1:] != sk[:-1]) + 1]
    rank = np.empty_like(order)
    rank[order] = np.arange(sk.size) - np.repeat(
        starts, np.diff(np.r_[starts, sk.size]))
    want = rank >= 100
    chunked, whole = out[1024], out[0]
    if not (np.array_equal(chunked[0], whole[0])
            and np.array_equal(whole[0], want)):
        fail("chunked dispatch: decisions differ between dispatch_chunk="
             "1024 and 0 or from serial order")
    # the warm-up flush is one more flush of `hits` hits
    want_chunks = (flushes + 1) * (hits // 1024)
    if chunked[2] != (flushes + 1, want_chunks) or \
            chunked[3]["check_and_update_cluster"] != want_chunks:
        fail(f"chunked dispatch: splits {chunked[2]} and cluster launches "
             f"{chunked[3]['check_and_update_cluster']}, want "
             f"{(flushes + 1, want_chunks)} and {want_chunks}")
    if whole[2] != (flushes + 1, flushes + 1) or \
            whole[3]["check_and_update_cluster"] != flushes + 1:
        fail(f"monolithic dispatch: splits {whole[2]}, cluster launches "
             f"{whole[3]['check_and_update_cluster']}")
    print(f"chunked dispatch (12b): decisions equal between the settings "
          f"and to serial order ({int(want.sum())} limited of "
          f"{want.size})")
    launches = {k: chunked[3][k] + whole[3][k] for k in chunked[3]}
    return launches, {"chunk_1024_decisions_per_s": chunked[1],
                      "monolithic_decisions_per_s": whole[1],
                      "chunk_1024_splits": chunked[2],
                      "monolithic_splits": whole[2]}


async def _profile_capture(tmpdir, dev, card, calls=200):
    """Phase 12c: POST /debug/profile start on a --device cuda server,
    ``calls`` sequential ShouldRateLimit calls, stop: the Chrome trace
    holds CUDA kernel events of csrc/counter_table.cu."""
    import re

    import grpc

    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.proto import rls_pb2

    limits = os.path.join(tmpdir, "limits.yaml")
    with open(limits, "w") as f:
        f.write(LIMITS_YAML)
    profile_dir = os.path.join(tmpdir, "profile")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        rls_port = sock.getsockname()[1]
    http, http_port = _http_options()
    srv = await server.start(server.build_parser().parse_args([
        limits, "torch", "--device", dev.type, "--rls-host", "127.0.0.1",
        "--rls-port", str(rls_port), "--profile-dir", profile_dir, *http]))

    def post(action):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", http_port, timeout=60)
        try:
            conn.request("POST", "/debug/profile",
                         json.dumps({"action": action}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    loop = asyncio.get_running_loop()
    envoy = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
    try:
        started = await loop.run_in_executor(None, post, "start")
        t0 = time.perf_counter()
        async with grpc.aio.insecure_channel(f"127.0.0.1:{rls_port}") as ch:
            for i in range(calls):
                await ch.unary_unary(envoy)(_lat_blob(rls_pb2, i, False),
                                            timeout=60)
        seconds = time.perf_counter() - t0
        stopped = await loop.run_in_executor(None, post, "stop")
        status = json.loads(await _served_get(http_port, "/debug/profile"))
    finally:
        await srv.stop()
    if started[0] != 200 or stopped[0] != 200 or status["active"]:
        fail(f"profile capture: start {started}, stop {stopped}, status "
             f"{status}")
    traces = [n for n in os.listdir(profile_dir) if n.endswith(".json")]
    if len(traces) != 1:
        fail(f"profile capture: {traces} in {profile_dir}")
    with open(os.path.join(profile_dir, traces[0])) as f:
        events = json.load(f).get("traceEvents", [])
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           KERNEL_SOURCE)) as f:
        source_kernels = set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
            f.read()))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = sorted({k for e in kernels for k in source_kernels
                   if re.search(rf"\b{k}\b", e.get("name", ""))})
    print(f"profile (12c): {calls} calls in {seconds:.2f}s captured to "
          f"{traces[0]}: {len(events)} events, {len(kernels)} CUDA kernel "
          f"events, kernels of {KERNEL_SOURCE}: {ours} ({card})")
    if not ours:
        fail("profile capture: no CUDA kernel event of "
             f"{KERNEL_SOURCE} in the trace")
    return {"events": len(events), "kernel_events": len(kernels),
            "source_kernels": ours}


def phase_device_plane(dev, card):
    """Phase 12: (a) the served drives of phases 4 and 6 with the device
    plane's checks and split, (b) chunked dispatch, (c) a profile
    capture. Returns (launches of 12a and 12c, results)."""
    from limitador_tpu_torch.ops import kernel as K

    t0 = time.perf_counter()
    out = {"standard": {"card": card}, "native": {"card": card}}
    # each _main_path counts its own run from 0 and returns it
    runs = []
    for native in (False, True):
        with tempfile.TemporaryDirectory() as tmpdir:
            runs.append(asyncio.run(_main_path(
                tmpdir, dev, native=native,
                plane=out["native" if native else "standard"])))
    K.reset_launches()
    with tempfile.TemporaryDirectory() as tmpdir:
        out["profile"] = asyncio.run(_profile_capture(tmpdir, dev, card))
    runs.append(dict(K.launches))
    served_launches = {k: sum(run.get(k, 0) for run in runs)
                       for k in runs[-1]}
    chunk_launches, out["chunked"] = phase_chunked(dev, card)
    launches = {k: served_launches[k] + chunk_launches[k]
                for k in served_launches}
    print(f"device plane (12): {time.perf_counter() - t0:.2f}s; launches "
          f"{json.dumps(launches)}")
    if _launched(served_launches, "check_and_update") == 0:
        fail("device plane (12): B1 did not launch on the served paths")
    return launches, out


# -- phase 13 ---------------------------------------------------------------

PHASE13A_KERNELS = ("check_and_update", "drain_top_hits", "seed_slots")
PLANES_OFF = ("--flight", "off", "--model-fit", "off", "--usage-topk", "0")


def _http_post(port, path, body):
    """(status, JSON body) of one POST, from a thread off the loop."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _free_ports(n):
    ports = []
    for _ in range(n):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    return ports


def _distinct_groups(users, size=8):
    """``users`` in order, cut into groups of up to ``size`` distinct
    users (a repeat waits for the next group): a group's calls go out
    together, and per-user limits make their answers independent of the
    order in which the server takes them."""
    groups, pending = [], list(users)
    while pending:
        group, rest = [], []
        for u in pending:
            (group if len(group) < size and u not in group
             else rest).append(u)
        groups.append(group)
        pending = rest
    return groups


def _plane_spy(server):
    """Count the recorder's batches with decisions and the estimator's
    ingests and draining refits (instance attributes over the methods:
    the pipelines and the drain thread call them through the objects)."""
    rec = server.limiter.recorder
    est = server.model_estimator
    tally = {"batches": 0, "ingests": 0, "refits": 0, "drained": 0}
    record_batch, ingest, refit = rec.record_batch, est.ingest, est.refit

    def counted_batch(entries, *args, **kwargs):
        entries = list(entries)
        tally["batches"] += bool(entries)
        return record_batch(entries, *args, **kwargs)

    def counted_ingest(*args, **kwargs):
        tally["ingests"] += 1
        return ingest(*args, **kwargs)

    def counted_refit(*args, **kwargs):
        got = refit(*args, **kwargs)
        if got:
            tally["refits"] += 1
            tally["drained"] += got
        return got

    rec.record_batch = counted_batch
    est.ingest = counted_ingest
    est.refit = counted_refit
    return tally


async def _served_planes(tmpdir, dev, card, calls=2000, users=600,
                         max_value=20):
    """Phase 13a: ``torch --pipeline native --tier-mode on --cache-size
    256`` with the control planes at their defaults beside a memory
    server, one frozen clock; 2,000 ShouldRateLimit calls over 600
    Zipf-0.99 users (every fourth with a second descriptor, which takes
    the exact path, where cold keys decide on the host), the first half
    one at a time, the rest 8 at a time (8 distinct users a group). Every
    answer equals the memory server's; then the planes' checks."""
    import grpc

    from limitador_tpu_torch.observability import model as model_mod
    from limitador_tpu_torch.observability.signals import ControlSignals
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "control planes (13a)"
    limits = os.path.join(tmpdir, "tiered.yaml")
    with open(limits, "w") as f:
        f.write(TIERED_YAML.format(max_value=max_value))
    ports = _free_ports(2)
    parse = server.build_parser().parse_args
    clock = ManualClock()
    failures = []
    http, http_port = _http_options()
    # a fresh process estimator: this server's observations only
    model_mod._PROCESS = None
    K.reset_launches()
    t0 = time.perf_counter()
    tiered = await server.start(parse([
        limits, "torch", "--device", dev.type, "--rls-host", "127.0.0.1",
        *http, "--rls-port", str(ports[0]), "--tier-mode", "on",
        "--pipeline", "native", "--cache-size", "256",
        "--tier-migrate-interval", "0.2", "--usage-drain-interval", "0.25",
        "--flight-spool-dir", os.path.join(tmpdir, "spool")]),
        clock=clock, on_failure=failures.append)
    oracle = await server.start(parse(
        [limits, "memory", "--rls-host", "127.0.0.1", *_http_options()[0],
         "--rls-port", str(ports[1])]), clock=clock)
    tally = _plane_spy(tiered)
    est = tiered.model_estimator
    rng = np.random.default_rng(67)
    who = zipf_keys(users, calls, 0.99, rng).tolist()
    envoy = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"

    def blob(i, u):
        descriptors = [{"user": f"t{u}"}]
        if i % 4 == 3:
            descriptors.append({"route": f"r{i % 5}"})
        return _rls_request(rls_pb2, "tier", descriptors)

    mismatches = 0
    lat = []
    try:
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{ports[0]}") as tc, \
                grpc.aio.insecure_channel(f"127.0.0.1:{ports[1]}") as oc:
            half = calls // 2
            for i, u in enumerate(who[:half]):
                b = blob(i, u)
                t1 = time.perf_counter()
                got = await tc.unary_unary(envoy)(b, timeout=60)
                lat.append(time.perf_counter() - t1)
                want = await oc.unary_unary(envoy)(b, timeout=60)
                mismatches += not _same_answer(rls_pb2, got, want)
            i = half
            for group in _distinct_groups(who[half:]):
                blobs = [blob(i + k, u) for k, u in enumerate(group)]
                i += len(group)
                got = await asyncio.gather(*(
                    tc.unary_unary(envoy)(b, timeout=60) for b in blobs))
                want = await asyncio.gather(*(
                    oc.unary_unary(envoy)(b, timeout=60) for b in blobs))
                mismatches += sum(not _same_answer(rls_pb2, g, w)
                                  for g, w in zip(got, want))
        seconds = time.perf_counter() - t0
        await asyncio.sleep(0.6)  # drains, bus ticks, refits, a round
        signals = json.loads(await _served_get(http_port, "/debug/signals"))
        capacity = json.loads(await _served_get(
            http_port, "/debug/capacity?batch=8&lease_share=0&procs=1"))
        bundles = json.loads(await _served_get(http_port, "/debug/flight"))
        stats = json.loads(await _served_get(http_port, "/debug/stats"))
        families = await _served_metrics(http_port)
        # nothing refits, migrates or taps between the reads below
        tiered.observatory.close()
        manager = tiered.tier_manager
        manager.close()
        flight = tiered.flight_engine.recorder.flight_debug()
        coeff = est.coefficients()
        costs = manager._row_costs()
        cold_p50_ms = tiered.storage.tier_stats()["cold_decide_p50_ms"]
        tstats = tiered.storage.tier_stats()
        pending = len(est._pending)
    finally:
        await tiered.stop()
        await oracle.stop()
    launches = dict(K.launches)
    lat_ms = np.asarray(lat) * 1e3
    print(f"{label}: {calls} calls over {users} users in {seconds:.2f}s "
          f"({calls // 2} sequential: p50 {np.percentile(lat_ms, 50):.3f} "
          f"ms, p99 {np.percentile(lat_ms, 99):.3f} ms; the rest 8 at a "
          f"time), {mismatches} differ from the memory server ({card})")
    print(f"{label}: recorder batches {tally['batches']}, ingests "
          f"{tally['ingests']}, draining refits {tally['refits']} "
          f"({tally['drained']} observations), pending {pending}, "
          f"dropped {est.dropped}; fit r2 {capacity['r2']}, drift "
          f"{capacity['drift']['state']}, coefficients "
          f"{json.dumps(coeff)}; tier manager row costs {costs} (cold "
          f"decide p50 {cold_p50_ms} ms)")
    print(f"{label}: flight taps {flight['taps']}, tails "
          f"{json.dumps(flight['tail_depth'])}, exemplars "
          f"{flight['exemplars']}; cold decisions "
          f"{tstats['cold']['decisions']}, promotions "
          f"{tstats['cold']['promotions']}, demotions "
          f"{tstats['cold']['demotions']}; bundles "
          f"{len(bundles['bundles'])}")
    print(f"{label}: /debug/signals current "
          f"{json.dumps(signals['current'])}")
    print(f"{label}: /debug/capacity what_if "
          f"{json.dumps(capacity.get('what_if'))}, headroom "
          f"{json.dumps(capacity['headroom'])}")
    print(f"{label} launches: {json.dumps(launches)}")
    if failures:
        fail(f"{label}: a background tier failed: {failures[0]!r}")
    if mismatches:
        fail(f"{label}: {mismatches} answers differ from the memory "
             "server's")
    if tally["ingests"] != tally["batches"] or tally["batches"] == 0:
        fail(f"{label}: {tally['ingests']} ingests for "
             f"{tally['batches']} recorded batches")
    if tally["drained"] + pending + est.dropped != tally["ingests"] \
            or pending > est.INGEST_CAP:
        fail(f"{label}: the fit did not consume its ingests: {tally}, "
             f"pending {pending}, dropped {est.dropped}")
    if tally["refits"] == 0 or capacity["observations"] == 0:
        fail(f"{label}: the fit never refit ({tally}, {capacity})")
    tails = flight["tail_depth"]
    if not (tails["lean"] or tails["native_hot"]) or not tails["cold_tier"]:
        fail(f"{label}: the flight recorder lacks taps: {tails}")
    current = signals["current"]
    if list(current) != list(ControlSignals.FIELDS) \
            or signals["fields"] != list(ControlSignals.FIELDS) \
            or current["device_backed"] != (1 if dev.type == "cuda" else 0):
        fail(f"{label}: the bus snapshot is wrong: {current}")
    for section in ("signals", "capacity", "flight", "tiering"):
        if section not in stats:
            fail(f"{label}: /debug/stats lacks {section}")
    want_costs = (
        coeff["host"]["row"] if coeff["host"]["row"] > 0
        else (cold_p50_ms / 1000.0 if cold_p50_ms > 0 else 20e-6),
        coeff["device"]["row"] if coeff["device"]["row"] > 0 else 1e-6)
    if costs != want_costs:
        fail(f"{label}: the tier manager prices with {costs}, not the "
             f"fit's {want_costs}")
    if _metric(families, "model_observations") <= 0 \
            or _metric(families, "flight_taps") <= 0:
        fail(f"{label}: model_observations or flight_taps stayed 0")
    missing = [k for k in PHASE13A_KERNELS if _launched(launches, k) == 0]
    if missing:
        fail(f"kernels not launched on {label}: {missing}")
    _host_forms_only(launches, label, remote=False)
    return launches, {
        "seconds": seconds, "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)), "tally": tally,
        "coefficients": coeff, "row_costs": list(costs),
        "fit_positive": {t: coeff[t]["row"] > 0 for t in coeff},
        "r2": capacity["r2"], "drift": capacity["drift"],
        "headroom": capacity["headroom"], "flight": flight,
        "cold": tstats["cold"], "signals": current,
    }


async def _flight_bundle(tmpdir, dev, card, calls=300):
    """Phase 13b: POST /debug/flight/trigger {"note": "smoke",
    "profile": true} on a card server with --flight-profile-s 0.5 while
    calls go on: the bundle is in the spool and served back by name, its
    profile names a Chrome trace that exists, and flight_bundles and
    flight_triggers{reason="manual"} count it."""
    import re

    import grpc

    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "flight bundle (13b)"
    limits = os.path.join(tmpdir, "limits.yaml")
    with open(limits, "w") as f:
        f.write(LIMITS_YAML)
    spool = os.path.join(tmpdir, "spool")
    (rls_port,) = _free_ports(1)
    http, http_port = _http_options()
    K.reset_launches()
    # a budget no call misses: no SLO-burn bundle races the manual one
    srv = await server.start(server.build_parser().parse_args([
        limits, "torch", "--device", dev.type, "--rls-host", "127.0.0.1",
        "--rls-port", str(rls_port), *http, "--flight-profile-s", "0.5",
        "--slo-budget-ms", "1000", "--flight-spool-dir", spool,
        "--profile-dir", os.path.join(tmpdir, "profile")]))
    loop = asyncio.get_running_loop()
    envoy = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
    try:
        async with grpc.aio.insecure_channel(f"127.0.0.1:{rls_port}") as ch:
            for i in range(50):
                await ch.unary_unary(envoy)(_lat_blob(rls_pb2, i, False),
                                            timeout=60)
            fired = loop.run_in_executor(
                None, _http_post, http_port, "/debug/flight/trigger",
                {"note": "smoke", "profile": True})
            for i in range(calls):
                await ch.unary_unary(envoy)(_lat_blob(rls_pb2, i, False),
                                            timeout=60)
            status, out = await fired
        name = out.get("bundle")
        listed = json.loads(await _served_get(http_port, "/debug/flight"))
        served = json.loads(await _served_get(
            http_port, f"/debug/flight?name={name}"))
        families = await _served_metrics(http_port)
    finally:
        await srv.stop()
    launches = dict(K.launches)
    if status != 200 or not out.get("fired") or not name:
        fail(f"{label}: the trigger answered {status} {out}")
    path = os.path.join(spool, name)
    if not os.path.exists(path):
        fail(f"{label}: {name} is not in the spool {spool}")
    with open(path) as f:
        on_disk = json.load(f)
    if served != on_disk or name not in [b["name"]
                                         for b in listed["bundles"]]:
        fail(f"{label}: GET /debug/flight does not serve {name}")
    profile = on_disk.get("profile") or {}
    if "error" in profile or not profile.get("trace") \
            or not os.path.exists(profile["trace"]):
        fail(f"{label}: the bundle's profile is {profile}")
    with open(profile["trace"]) as f:
        events = json.load(f).get("traceEvents", [])
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           KERNEL_SOURCE)) as f:
        source_kernels = set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
            f.read()))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = sorted({k for e in kernels for k in source_kernels
                   if re.search(rf"\b{k}\b", e.get("name", ""))})
    counted = {"flight_bundles": _metric(families, "flight_bundles"),
               "flight_triggers_manual": _metric(
                   families, "flight_triggers", reason="manual")}
    print(f"{label}: {name}, {os.path.getsize(path)} bytes, reason "
          f"{on_disk['reason']}, note {on_disk['note']!r}, "
          f"{len(on_disk['local']['exemplars'])} exemplars, worst "
          f"{ {k: len(v) for k, v in on_disk['local']['worst'].items()} }, "
          f"{len(on_disk['local']['signals'])} signal snapshots; profile "
          f"{profile['seconds']} s to {os.path.basename(profile['trace'])}: "
          f"{len(events)} events, {len(kernels)} CUDA kernel events, "
          f"kernels of {KERNEL_SOURCE}: {ours}; /metrics "
          f"{json.dumps(counted)} ({card})")
    if counted["flight_bundles"] < 1 or counted["flight_triggers_manual"] != 1:
        fail(f"{label}: the flight families do not count the bundle: "
             f"{counted}")
    return launches, {"bundle": name, "events": len(events),
                      "kernel_events": len(kernels),
                      "source_kernels": ours, **counted}


async def _planes_cost(tmpdir, dev, card, native, rounds=150):
    """Phase 13c: a phase-4 (or, with ``native``, phase-6) server with
    the control planes at their defaults beside one with
    ``--flight off --model-fit off --usage-topk 0``, in this process on
    one frozen clock; ``rounds`` rounds of one sequential ShouldRateLimit
    call to each, the order alternating by round. The answers must be
    byte-equal, and so must the final counters; p50/p99 of each side and
    the per-round difference are records, not a gate."""
    import grpc

    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.proto import rls_pb2

    label = f"planes cost (13c, {'native' if native else 'standard'})"
    limits = os.path.join(tmpdir, "limits.yaml")
    with open(limits, "w") as f:
        f.write(LIMITS_YAML + (NATIVE_NS_YAML if native else ""))
    options = ["--rls-host", "127.0.0.1", "--rate-limit-headers",
               "NONE" if native else "DRAFT_VERSION_03", "--device", dev.type]
    if native:
        options += ["--pipeline", "native", "--native-hot-lane", "on",
                    "--lease-mode", "off"]
    parse = server.build_parser().parse_args
    clock = ManualClock()
    ports = dict(zip("ND", _free_ports(2)))
    servers = {}
    failures = []
    try:
        for side, extra in (("N", ()), ("D", PLANES_OFF)):
            servers[side] = await server.start(parse(
                [limits, "torch", *options, *_http_options()[0],
                 "--rls-port", str(ports[side]),
                 "--flight-spool-dir", os.path.join(tmpdir, f"spool{side}"),
                 *extra]), clock=clock, on_failure=failures.append)
        envoy = "/envoy.service.ratelimit.v3.RateLimitService/" \
            "ShouldRateLimit"
        lat = {side: [] for side in servers}
        mismatches = 0
        channels = {side: grpc.aio.insecure_channel(f"127.0.0.1:{port}")
                    for side, port in ports.items()}
        try:
            for i in range(rounds + 30):  # the first 30 rounds warm up
                blob = _lat_blob(rls_pb2, i, native)
                order = "ND" if i % 2 == 0 else "DN"
                got = {}
                for side in order:
                    t0 = time.perf_counter()
                    got[side] = await channels[side].unary_unary(envoy)(
                        blob, timeout=60)
                    if i >= 30:
                        lat[side].append(time.perf_counter() - t0)
                mismatches += got["N"] != got["D"]
        finally:
            for ch in channels.values():
                await ch.close()
        final = {}
        for side, srv in servers.items():
            rows = {}
            for ns in ("api", "nat"):
                counters = srv.limiter.get_counters(ns)
                if asyncio.iscoroutine(counters):
                    counters = await counters
                for c in counters:
                    rows[(ns, c.limit.name,
                          tuple(c.set_variables.items()))] = (
                        c.remaining, c.expires_in)
            final[side] = rows
    finally:
        for srv in servers.values():
            await srv.stop()
    ms = {side: np.asarray(v) * 1e3 for side, v in lat.items()}
    diff = ms["N"] - ms["D"]
    out = {side: {"p50_ms": float(np.percentile(v, 50)),
                  "p99_ms": float(np.percentile(v, 99)),
                  "mean_ms": float(v.mean())} for side, v in ms.items()}
    out["minus_off_median_ms"] = float(np.median(diff))
    out["minus_off_mean_ms"] = float(diff.mean())
    out["slower_share"] = float((diff > 0).mean())
    print(f"{label}: {rounds} rounds, planes on p50 "
          f"{out['N']['p50_ms']:.3f} / p99 {out['N']['p99_ms']:.3f} ms, "
          f"off p50 {out['D']['p50_ms']:.3f} / p99 "
          f"{out['D']['p99_ms']:.3f} ms; on - off per round median "
          f"{out['minus_off_median_ms']:+.4f} ms, mean "
          f"{out['minus_off_mean_ms']:+.4f} ms, slower in "
          f"{out['slower_share']:.1%} of rounds ({card})")
    if failures:
        fail(f"{label}: a background tier failed: {failures[0]!r}")
    if mismatches or final["N"] != final["D"] or not final["N"]:
        fail(f"{label}: {mismatches} answers differ between the planes on "
             f"and off, or the counters do ({len(final['N'])} against "
             f"{len(final['D'])})")
    print(f"{label}: every answer byte-equal, {len(final['N'])} counters "
          "equal")
    return out


def phase_control_planes(dev, card):
    """Phase 13: (a) the served planes over tiers against a memory
    server, (b) a flight bundle with a profile, (c) the planes' served
    cost on phases 4 and 6. Returns (launches of 13a, 13b and 13c,
    results)."""
    from limitador_tpu_torch.ops import kernel as K

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        launches_a, served = asyncio.run(
            _served_planes(tmpdir, dev, card, calls=1400))
    with tempfile.TemporaryDirectory() as tmpdir:
        launches_b, bundle = asyncio.run(_flight_bundle(tmpdir, dev, card))
    K.reset_launches()
    cost = {}
    for native in (False, True):
        with tempfile.TemporaryDirectory() as tmpdir:
            cost["native" if native else "standard"] = asyncio.run(
                _planes_cost(tmpdir, dev, card, native))
    launches = {k: launches_a[k] + launches_b[k] + K.launches[k]
                for k in launches_a}
    _storage_forms(launches, "control planes (13)", ("drain_top_hits_host",))
    print(f"control planes (13): {time.perf_counter() - t0:.2f}s; launches "
          f"{json.dumps(launches)}")
    return launches, {"served": served, "bundle": bundle, "cost": cost,
                      "card": card}


# -- phase 5 ----------------------------------------------------------------


def phase_drive(dev, card, batches, hits=8192, max_value=100,
                big=DRIVE_BIG_HITS):
    """check_many over Zipf-0.99 keys from 1<<20, one hit per request;
    every key's first max_value hits are admitted, the rest rejected
    (serial exactness within and across batches, checked here). After
    the timed ``batches``, one batch of ``big`` hits, past the cluster's
    capacity. Returns (decisions/s of the timed batches, launches)."""
    from limitador_tpu_torch import Counter, Limit
    from limitador_tpu_torch.device.storage import TorchStorage, _Request
    from limitador_tpu_torch.ops import kernel as K

    clock = ManualClock()
    storage = TorchStorage(capacity=C, clock=clock, device=dev)
    limit = Limit("drive", max_value, 3600, [], ["u"])
    rng = np.random.default_rng(99)
    keys = zipf_keys(C, batches * hits + big, 0.99, rng)
    names = [str(k) for k in range(C)]
    # warm-up batch on other keys (first launch, pinned buffers)
    storage.check_many([_Request([Counter(Limit("warm", 1, 60, [], ["u"]),
                                          {"u": "w"})], 1, False)])
    storage.close()  # waits for the storage stream
    K.reset_launches()
    decided = []
    spent = {"requests": 0.0, "begin": 0.0, "finish": 0.0}
    t0 = time.perf_counter()
    inflight = None
    for b in range(batches):
        ks = keys[b * hits:(b + 1) * hits]
        t1 = time.perf_counter()
        requests = [_Request([Counter(limit, {"u": names[k]})], 1, False)
                    for k in ks.tolist()]
        t2 = time.perf_counter()
        handle = storage.begin_check_many(requests)
        t3 = time.perf_counter()
        if inflight is not None:
            decided.extend(a.limited for a in
                           storage.finish_check_many(inflight))
        inflight = handle
        t4 = time.perf_counter()
        spent["requests"] += t2 - t1
        spent["begin"] += t3 - t2
        spent["finish"] += t4 - t3
    decided.extend(a.limited for a in storage.finish_check_many(inflight))
    seconds = time.perf_counter() - t0
    t_big = time.perf_counter()
    decided.extend(a.limited for a in storage.check_many(
        [_Request([Counter(limit, {"u": names[k]})], 1, False)
         for k in keys[batches * hits:].tolist()]))
    t_big = time.perf_counter() - t_big
    storage.close()
    launches = dict(K.launches)
    limited = np.asarray(decided)
    # occurrence rank of each hit within its key, in drive order
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.r_[0, np.flatnonzero(sk[1:] != sk[:-1]) + 1]
    rank = np.empty_like(order)
    rank[order] = np.arange(sk.size) - np.repeat(
        starts, np.diff(np.r_[starts, sk.size]))
    want = rank >= max_value
    rate = batches * hits / seconds
    print(f"drive: {batches} batches x {hits} hits over 1M Zipf-0.99 keys "
          f"in {seconds:.2f}s = {rate:.0f} decisions/s "
          f"({limited[:batches * hits].sum()} limited; {card}); then one "
          f"batch of {big} hits in {t_big:.2f}s")
    print("drive host time: " + ", ".join(
        f"{k} {v / batches * 1e3:.2f} ms/batch" for k, v in spent.items()))
    print(f"drive launches: {json.dumps(launches)}")
    if not np.array_equal(limited, want):
        fail(f"drive decisions differ from serial order at "
             f"{int(np.flatnonzero(limited != want)[0])}")
    if launches["check_and_update_cluster"] < batches or \
            launches["check_and_update"] != 1:
        fail(f"drive: B1 by route {launches['check_and_update_cluster']} "
             f"cluster, {launches['check_and_update']} one-block launches; "
             f"want {batches} or more and 1")
    return rate, launches


# -- phase 7 ----------------------------------------------------------------


def _drive_blob(user: int) -> bytes:
    """The serialized RateLimitRequest {domain: "drive", descriptors:
    [{u: user}]}, built by hand (checked against protobuf below)."""
    v = str(user).encode()
    entry = b"\n\x01u\x12" + bytes([len(v)]) + v
    desc = b"\n" + bytes([len(entry)]) + entry
    return b"\n\x05drive\x12" + bytes([len(desc)]) + desc


def _timed(obj, name, spent, key):
    """Wrap obj.name so its calls add their host seconds to spent[key]."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent[key] += time.perf_counter() - t0

    setattr(obj, name, timed)


def phase_native_drive(dev, card, batches, leases, hits=8192,
                       max_value=100, capacity=C):
    """NativeRlsPipeline.decide_many over Zipf-0.99 users from 1<<20, one
    one-descriptor blob per request, one limit of max_value per hour per
    user, the storage clock frozen. Without leases every row must follow
    serial order (each user's first max_value admitted) and the usage
    observatory's top-64 must equal a host tally of hits per user. With
    leases (LeaseConfig defaults, refreshed between batches) no user may
    be admitted more than max_value times, every refresh must conserve
    tokens, and a forced settle (reload bump, clock past ttl_s) must
    leave every user's device value equal to its admitted count."""
    from limitador_tpu_torch import Limit
    from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage
    from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
    from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
    from limitador_tpu_torch.lease import LeaseConfig
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics
    from limitador_tpu_torch.observability.usage import (
        TenantUsageObservatory,
    )
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "native drive (leases on)" if leases else "native drive"
    want_blob = rls_pb2.RateLimitRequest(domain="drive")
    want_blob.descriptors.add().entries.add(key="u", value="123456")
    if _drive_blob(123456) != want_blob.SerializeToString():
        fail("hand-built drive blob differs from protobuf's")
    clock = ManualClock()
    storage = TorchStorage(capacity=capacity, clock=clock, device=dev)
    limiter = CompiledTorchLimiter(AsyncTorchStorage(storage))
    limiter.add_limit(Limit("drive", max_value, 3600, [],
                            ["descriptors[0].u"], name="per-user"))
    # the rows count into the metrics, as a server's pipeline counts them
    metrics = PrometheusMetrics()
    pipeline = NativeRlsPipeline(limiter, metrics=metrics, max_batch=hits,
                                 hot_lane=True)
    broker = None
    if leases:
        broker = pipeline.attach_lease(LeaseConfig(), autostart=False)
        broker._clock = clock
    rng = np.random.default_rng(77 if leases else 99)
    keys = zipf_keys(capacity, batches * hits, 0.99, rng)
    blob_of = {}
    spent = {"lane": 0.0, "begin": 0.0, "finish": 0.0, "refresh": 0.0}
    _timed(pipeline._hot_lane, "begin", spent, "lane")
    _timed(storage, "begin_check_columnar", spent, "begin")
    _timed(storage, "finish_check_columnar", spent, "finish")
    credit_rows = []
    credit = storage.credit_columnar

    def counted_credit(slots, *args):
        credit_rows.append(int(slots.shape[0]))
        return credit(slots, *args)

    storage.credit_columnar = counted_credit
    ok = pipeline.OK_BLOB
    admitted = np.zeros(batches * hits, bool)
    violations = 0
    t0 = time.perf_counter()
    for b in range(batches):
        part = keys[b * hits:(b + 1) * hits].tolist()
        blobs = []
        for k in part:
            blob = blob_of.get(k)
            if blob is None:
                blob = blob_of[k] = _drive_blob(k)
            blobs.append(blob)
        out = pipeline.decide_many(blobs, chunk=hits)
        if None in out:
            fail(f"{label}: rows left to the exact path")
        admitted[b * hits:(b + 1) * hits] = [r == ok for r in out]
        if broker is not None:
            t1 = time.perf_counter()
            broker.refresh()
            spent["refresh"] += time.perf_counter() - t1
            st = broker.stats()
            if st["lease_granted_tokens"] != (
                st["lease_admissions"] + st["lease_returned_tokens"]
                + st["lease_outstanding_tokens"]
            ):
                violations += 1
    seconds = time.perf_counter() - t0
    rate = admitted.size / seconds
    n = admitted.size
    print(f"{label}: {batches} batches x {hits} blobs over 1M Zipf-0.99 "
          f"users in {seconds:.2f}s = {rate:.0f} decisions/s "
          f"({n - int(admitted.sum())} limited; {card})")
    other = seconds - sum(spent.values())
    print(f"{label} host time: " + ", ".join(
        f"{k} {v / batches * 1e3:.2f} ms/batch"
        for k, v in list(spent.items()) + [("other", other)]))
    print(f"{label} hot lane: {json.dumps(pipeline.lane_stats())}")
    counted = {family: _registry_total(metrics, family)
               for family in ("authorized_calls", "limited_calls")}
    if counted != {"authorized_calls": int(admitted.sum()),
                   "limited_calls": n - int(admitted.sum())}:
        fail(f"{label}: the metrics counted {counted}, the drive admitted "
             f"{int(admitted.sum())} of {n}")
    per_user = np.bincount(keys, weights=admitted, minlength=capacity)
    if not leases:
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        starts = np.r_[0, np.flatnonzero(sk[1:] != sk[:-1]) + 1]
        rank = np.empty_like(order)
        rank[order] = np.arange(sk.size) - np.repeat(
            starts, np.diff(np.r_[starts, sk.size]))
        want = rank < max_value
        if not np.array_equal(admitted, want):
            fail(f"{label}: decisions differ from serial order at row "
                 f"{int(np.flatnonzero(admitted != want)[0])}")
        # usage observatory: one drain of everything the drive counted
        observatory = TenantUsageObservatory(storage, pipeline=pipeline,
                                             top_k=64)
        observatory.drain()
        got = [(int(r["key"]["descriptors[0].u"]), r["hits"])
               for r in observatory.top()]
        tally = np.bincount(keys, minlength=capacity)
        users, first = np.unique(keys, return_index=True)
        # ties to the lowest slot = the earliest first appearance
        top = np.lexsort((first, -tally[users]))[:64]
        expected = [(int(users[i]), int(tally[users[i]])) for i in top]
        if got != expected:
            fail(f"{label}: observatory top-64 differs from the host "
                 f"tally: {got[:5]} vs {expected[:5]}")
        print(f"{label} usage top-64 equals the host tally "
              f"(top: user {got[0][0]} with {got[0][1]} hits)")
        return rate, spent, seconds
    if per_user.max() > max_value:
        fail(f"{label}: a user was admitted {int(per_user.max())} times, "
             f"over the limit of {max_value}")
    if violations:
        fail(f"{label}: token conservation broke after {violations} "
             "refreshes")
    stats = broker.stats()
    # forced settle: the reload bump strands every live balance, one begin
    # syncs the mirror's epoch, the clock passes ttl_s, one refresh credits
    pipeline.invalidate()
    settle_user = capacity + 1
    if pipeline.decide_many([_drive_blob(settle_user)]) != [ok]:
        fail(f"{label}: the settle probe was not admitted")
    clock.now += LeaseConfig().ttl_s + 1.0
    credits_before = K.launches["credit_host"]
    broker.refresh()
    spent_credit = K.launches["credit_host"] - credits_before
    settled = broker.stats()
    if settled["lease_outstanding_tokens"] != 0 or settled[
            "lease_granted_tokens"] != (settled["lease_admissions"]
                                        + settled["lease_returned_tokens"]):
        fail(f"{label}: the settle left tokens outstanding: {settled}")
    values = storage._state.values.cpu().numpy()
    device = {}
    for slot, (_key, counter) in storage._table.info.items():
        device[int(counter.set_variables["descriptors[0].u"])] = int(
            values[slot])
    touched = np.flatnonzero(np.bincount(keys, minlength=capacity))
    bad = [u for u in touched.tolist()
           if device.get(u, 0) != int(per_user[u])]
    if device.get(settle_user) != 1:
        bad.append(settle_user)
    if bad:
        fail(f"{label}: {len(bad)} users' device values differ from their "
             f"admitted counts after the settle (first: user {bad[0]}: "
             f"{device.get(bad[0])} vs {int(per_user[bad[0]])})")
    exact = bool(np.array_equal(per_user, np.minimum(
        np.bincount(keys, minlength=capacity), max_value)))
    print(f"{label}: max admitted per user {int(per_user.max())}; "
          f"granted {stats['lease_granted_tokens']} = admissions "
          f"{stats['lease_admissions']} + returned "
          f"{stats['lease_returned_tokens']} + outstanding "
          f"{stats['lease_outstanding_tokens']} after every refresh; "
          f"credit rows per settle {credit_rows}; "
          f"settle: {spent_credit} credit launch(es), outstanding 0, "
          f"{touched.size} users' device values = admitted counts; "
          f"per-user admissions {'equal' if exact else 'DIFFER from'} "
          f"min(requests, {max_value})")
    return rate, spent, seconds


# -- phase 8 ----------------------------------------------------------------


class Loopback:
    """Stands in for the gossip broker of a replicated node: ``publish``
    hands the update to the other nodes' ``_on_remote_update`` at once;
    ``stop`` (``close`` calls it) has nothing to stop."""

    def __init__(self, peers):
        self.peers = peers

    def publish(self, key, values, expires_at):
        for peer in self.peers:
            peer._on_remote_update(key, dict(values), expires_at)

    def stop(self):
        pass


def _replication_drive(dev, clock, keys, to_bucket, batches, hits):
    """Three TorchReplicatedStorage nodes (capacity C) on ``dev`` with
    loopback gossip: batch b goes to node b mod 3 through check_many, then
    every node publishes what it touched. Returns (limited per row, the
    nodes' final arrays, host seconds per stage)."""
    from limitador_tpu_torch import Counter, Limit, RateLimiter
    from limitador_tpu_torch.device.replicated import TorchReplicatedStorage
    from limitador_tpu_torch.device.storage import _Request
    from limitador_tpu_torch.ops import kernel as K

    nodes = [TorchReplicatedStorage(name, capacity=C, clock=clock,
                                    device=dev) for name in "abc"]
    window = Limit("drive", 100, 3600, [], ["u"], name="per-user")
    bucket = Limit("drive-tb", 20, 60, [], ["u"], name="per-user-tb",
                   policy="token_bucket")
    for i, node in enumerate(nodes):
        limiter = RateLimiter(node)  # wires the limits provider
        limiter.add_limit(window)
        limiter.add_limit(bucket)
        node.broker = Loopback([n for j, n in enumerate(nodes) if j != i])
    spent = {"check": 0.0, "gossip": 0.0, "flush": 0.0, "flush_call": 0.0,
             "clears": 0.0}
    flush_rows = []  # dirty slots per B6c flush
    clear_rows = []  # staged slots per B3b flush
    host_form = K.apply_remote_host  # the flush's C call, timed apart
    _timed(K, "apply_remote_host", spent, "flush_call")
    for node in nodes:
        flush = node._flush_dirty_remote
        flush_clears = node._flush_clears

        def timed_flush(node=node, flush=flush):
            if node._dirty_remote:
                flush_rows.append(len(node._dirty_remote))
            t0 = time.perf_counter()
            try:
                return flush()
            finally:
                spent["flush"] += time.perf_counter() - t0

        def timed_clears(node=node, flush=flush_clears):
            if node._staged_clears:
                clear_rows.append(len(node._staged_clears))
            t0 = time.perf_counter()
            try:
                return flush()
            finally:
                spent["clears"] += time.perf_counter() - t0
        node._flush_dirty_remote = timed_flush
        node._flush_clears = timed_clears
    names = {}
    limited = []
    t0 = time.perf_counter()
    for b in range(batches):
        node = nodes[b % 3]
        part = keys[b * hits:(b + 1) * hits].tolist()
        tb = to_bucket[b * hits:(b + 1) * hits].tolist()
        requests = []
        for k, is_tb in zip(part, tb):
            name = names.get(k)
            if name is None:
                name = names[k] = str(k)
            requests.append(_Request([Counter(bucket if is_tb else window,
                                              {"u": name})], 1, False))
        flush0 = spent["flush"]
        t1 = time.perf_counter()
        limited.extend(a.limited for a in node.check_many(requests))
        t2 = time.perf_counter()
        for n in nodes:
            n._publish_touched()
        t3 = time.perf_counter()
        spent["check"] += (t2 - t1) - (spent["flush"] - flush0)
        spent["gossip"] += t3 - t2
    for n in nodes:
        with n._lock:
            n._flush_dirty_remote()
        n.close()
    seconds = time.perf_counter() - t0
    K.apply_remote_host = host_form
    arrays = [
        {"values": n._state.values.cpu().numpy(),
         "expiry_ms": n._state.expiry_ms.cpu().numpy(),
         "hits": n._state.hits.cpu().numpy(),
         "remote_vals": n._remote_vals.cpu().numpy(),
         "remote_exp": n._remote_exp.cpu().numpy()}
        for n in nodes
    ]
    return np.asarray(limited), arrays, spent, seconds, flush_rows, clear_rows


def phase_replication_drive(dev, card, batches, hits=8192):
    """Phase 8a: the replicated topology on the card, gossip complete
    between batches (a loopback broker), so admission is globally exact:
    every row must follow serial order against one table, and the same
    sequence on three CPU nodes (the kernels' plain versions) must give
    the same rows and the same final five arrays on every node."""
    import torch

    from limitador_tpu_torch.ops import kernel as K

    rng = np.random.default_rng(88)
    keys = zipf_keys(C, batches * hits, 0.99, rng)
    to_bucket = rng.random(batches * hits) < 0.2
    clock = ManualClock()
    K.reset_launches()
    limited, arrays, spent, seconds, flush_rows, clear_rows = \
        _replication_drive(dev, clock, keys, to_bucket, batches, hits)
    launches = dict(K.launches)
    rate = limited.size / seconds
    print(f"replication drive: 3 nodes x capacity {C}, {batches} batches x "
          f"{hits} hits over {C} Zipf-0.99 users (20% to a token bucket) in "
          f"{seconds:.2f}s = {rate:.0f} decisions/s ({int(limited.sum())} "
          f"limited; {card})")
    print("replication drive host time: " + ", ".join(
        f"{k} {v / batches * 1e3:.2f} ms/batch" for k, v in spent.items())
        + f"; B6c rows per flush: mean {np.mean(flush_rows):.0f}, max "
        f"{max(flush_rows)} over {len(flush_rows)} flushes")
    flushes = len(flush_rows)
    print(f"replication drive B6c flush, host ms per flush: pack "
          f"{(spent['flush'] - spent['flush_call']) / flushes * 1e3:.3f}, "
          f"C call {spent['flush_call'] / flushes * 1e3:.3f}; "
          f"{launches['apply_remote_host'] / flushes:.2f} B6c launches a "
          f"flush")
    print(f"replication drive B3b: {launches['clear_slots_host']} host-form "
          f"launches ({launches['clear_slots_host'] / batches:.2f} a batch) "
          f"over {len(clear_rows)} flushes of staged adoptions (mean "
          f"{np.mean(clear_rows or [0]):.0f} slots, max "
          f"{max(clear_rows or [0])}); {launches['clear_slots']} "
          f"device-tensor launches; gossip "
          f"{spent['gossip'] / batches * 1e3:.2f} ms a batch; the B3b "
          f"flushes (in check and gossip) "
          f"{spent['clears'] / batches * 1e3:.3f} ms a batch")
    print(f"replication drive launches: {json.dumps(launches)}")
    missing = [k for k in PHASE8A_KERNELS if _launched(launches, k) == 0]
    if missing:
        fail(f"kernels not launched on the replication drive: {missing}")
    _host_forms_only(launches, "replication drive", remote=True)
    if any(launches[k] for k in PLAIN_KERNELS):
        fail("a replicated node launched the plain check or update")
    # serial order against one table: the first max of each (limit, user)
    composite = keys.astype(np.int64) * 2 + to_bucket
    order = np.argsort(composite, kind="stable")
    sk = composite[order]
    starts = np.r_[0, np.flatnonzero(sk[1:] != sk[:-1]) + 1]
    rank = np.empty_like(order)
    rank[order] = np.arange(sk.size) - np.repeat(
        starts, np.diff(np.r_[starts, sk.size]))
    want = rank >= np.where(to_bucket, 20, 100)
    if not np.array_equal(limited, want):
        fail(f"replication drive rows differ from serial order at "
             f"{int(np.flatnonzero(limited != want)[0])}")
    t0 = time.perf_counter()
    cpu_limited, cpu_arrays, _spent, _s, _rows, _c = _replication_drive(
        torch.device("cpu"), clock, keys, to_bucket, batches, hits)
    if not np.array_equal(cpu_limited, limited):
        fail("the CPU replay's rows differ from the card's")
    for i, (a, b) in enumerate(zip(arrays, cpu_arrays)):
        for name in a:
            if not np.array_equal(a[name], b[name]):
                fail(f"node {i} {name} differs between card and CPU replay")
    print(f"replication drive: rows equal serial order and the CPU replay "
          f"(rows and all five arrays of all three nodes; replay "
          f"{time.perf_counter() - t0:.2f}s)")
    return launches, {"decisions_per_s": rate, "seconds": seconds,
                      "host_s": spent, "batches": batches, "hits": hits,
                      "flush_rows": flush_rows, "clear_rows": clear_rows,
                      "b3b_launches": launches["clear_slots_host"],
                      "b3b_device_tensor_launches": launches["clear_slots"]}


REPLICATED_YAML = """\
- namespace: rep
  max_value: {max_value}
  seconds: 3600
  variables: ["descriptors[0].user"]
  name: per-user
"""


async def _served_replication(tmpdir, dev, card, calls=2000, users=50,
                              max_value=20):
    """Phase 8b: three replicated nodes built by the server's own
    construction code (``server.start`` with --node-id, --listen-address
    and --peer), gossiping over real gRPC brokers on localhost, standard
    pipeline. ShouldRateLimit calls go round-robin over the nodes; every
    tenth call is a Kuadrant Report of one hit instead. After five gossip
    periods every node's view must be exact and a further call for a
    spent user must be refused everywhere."""
    import grpc

    from limitador_tpu_torch.device.replicated import DEFAULT_GOSSIP_PERIOD
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.proto import rls_pb2

    limits = os.path.join(tmpdir, "replicated.yaml")
    with open(limits, "w") as f:
        f.write(REPLICATED_YAML.format(max_value=max_value))
    ports = []
    for _ in range(6):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    gossip = [f"127.0.0.1:{p}" for p in ports[3:]]
    parse = server.build_parser().parse_args
    K.reset_launches()
    nodes = []
    try:
        for i in range(3):
            peers = [a for j, a in enumerate(gossip) if j != i]
            nodes.append(await server.start(parse([
                limits, "torch", "--device", dev.type, "--rls-host",
                "127.0.0.1", *_http_options()[0],
                "--rls-port", str(ports[i]), "--node-id",
                f"node{i}", "--listen-address", gossip[i], "--peer",
                peers[0], "--peer", peers[1]])))
        envoy = "/envoy.service.ratelimit.v3.RateLimitService/" \
            "ShouldRateLimit"
        report = "/kuadrant.service.ratelimit.v1.RateLimitService/Report"
        ok = rls_pb2.RateLimitResponse.OK
        over = rls_pb2.RateLimitResponse.OVER_LIMIT
        spent = np.zeros(users, np.int64)
        # OK answers given while the user's global spend (the calls are
        # sequential, so it is exact) had already reached the limit
        over_adm = np.zeros(users, np.int64)
        lat = [[], [], []]
        async with grpc.aio.insecure_channel(f"127.0.0.1:{ports[0]}") as c0, \
                grpc.aio.insecure_channel(f"127.0.0.1:{ports[1]}") as c1, \
                grpc.aio.insecure_channel(f"127.0.0.1:{ports[2]}") as c2:
            chans = (c0, c1, c2)
            # the mesh forms before the drive: every broker has 2 sessions
            deadline = time.monotonic() + 30
            while any(len(n.storage.broker.sessions) < 2 for n in nodes):
                if time.monotonic() > deadline:
                    fail("the replication mesh did not form within 30 s")
                await asyncio.sleep(0.05)
            t0 = time.perf_counter()
            for i in range(calls):
                node = i % 3
                user = (i // 3) % users
                if i % 10 == 9:
                    await chans[node].unary_unary(report)(_rls_request(
                        rls_pb2, "rep", [{"user": f"r{user}"}], 1),
                        timeout=60)
                    spent[user] += 1
                    continue
                blob = _rls_request(rls_pb2, "rep", [{"user": f"r{user}"}])
                t1 = time.perf_counter()
                got = await chans[node].unary_unary(envoy)(blob, timeout=60)
                lat[node].append(time.perf_counter() - t1)
                if rls_pb2.RateLimitResponse.FromString(
                        got).overall_code == ok:
                    over_adm[user] += spent[user] >= max_value
                    spent[user] += 1
            seconds = time.perf_counter() - t0
            await asyncio.sleep(5 * DEFAULT_GOSSIP_PERIOD)
            want = {f"r{u}": max(0, max_value - int(spent[u]))
                    for u in range(users)}
            t_wait = time.perf_counter()
            while True:
                views = []
                for n in nodes:
                    counters = await n.limiter.get_counters("rep")
                    views.append({c.set_variables["descriptors[0].user"]:
                                  max(0, c.remaining) for c in counters})
                # a spent user's counter is listed with 0 remaining
                if all(v == want for v in views):
                    break
                if time.perf_counter() - t_wait > 10:
                    bad = [(u, [v.get(u) for v in views], w)
                           for u, w in want.items()
                           if any(v.get(u) != w for v in views)]
                    fail(f"served replication did not converge: {bad[:5]}")
                await asyncio.sleep(DEFAULT_GOSSIP_PERIOD)
            settle = time.perf_counter() - t_wait + 5 * DEFAULT_GOSSIP_PERIOD
            refused = 0
            for u in range(users):
                if spent[u] < max_value:
                    continue
                blob = _rls_request(rls_pb2, "rep", [{"user": f"r{u}"}])
                for chan in chans:
                    got = await chan.unary_unary(envoy)(blob, timeout=60)
                    if rls_pb2.RateLimitResponse.FromString(
                            got).overall_code != over:
                        fail(f"user r{u} (spent {int(spent[u])}) was "
                             "admitted after convergence")
                    refused += 1
    finally:
        for n in nodes:
            await n.stop()
    launches = dict(K.launches)
    lat_ms = [np.asarray(x) * 1e3 for x in lat]
    print(f"served replication: 3 nodes, {calls} calls ({calls // 10} "
          f"Reports) over {users} users, limit {max_value}/h, in "
          f"{seconds:.2f}s; views exact after {settle:.2f}s; "
          f"{refused} further calls refused; over-admission per user max "
          f"{int(over_adm.max())}, mean {over_adm.mean():.2f}, "
          f"{int((over_adm > 0).sum())} of {users} users over ({card})")
    for i, x in enumerate(lat_ms):
        print(f"served replication node{i} latency (sequential gRPC, "
              f"{dev.type}): p50 {np.percentile(x, 50):.3f} ms, p99 "
              f"{np.percentile(x, 99):.3f} ms over {x.size}")
    print(f"served replication launches: {json.dumps(launches)}")
    missing = [k for k in PHASE8B_KERNELS if _launched(launches, k) == 0]
    if missing:
        fail(f"kernels not launched on the served replication: {missing}")
    _host_forms_only(launches, "served replication", remote=True)
    if any(launches[k] for k in PLAIN_KERNELS):
        fail("a replicated node launched the plain check or update")
    return launches, {
        "seconds": seconds, "settle_s": settle,
        "over_admission_max": int(over_adm.max()),
        "over_admission_mean": float(over_adm.mean()),
        "users_over": int((over_adm > 0).sum()),
        "p50_ms": [float(np.percentile(x, 50)) for x in lat_ms],
        "p99_ms": [float(np.percentile(x, 99)) for x in lat_ms],
    }


# -- phase 9 ----------------------------------------------------------------


def phase_tiered_drive(dev, card, batches=TIER_BATCHES, hits=8192,
                       users=1 << 22, cache_size=1 << 16, capacity=C,
                       round_every=4, manager_batch=1024):
    """Phase 9a: TieredStorage(capacity, cache_size) on ``dev``, frozen
    clock advanced 50 ms per batch, one-hit requests through check_many:
    80% under the phase-5 limit (100 per hour), 20% under a token bucket
    of 20 per minute on a second namespace, users Zipf-0.99 over
    ``users``. A TierManager round runs after every ``round_every``-th
    batch, one of them killed between its phases. Once half the batches
    have run, the drive pauses: manager rounds with no traffic, until one
    promotes (while traffic runs, demand evictions hold the hot set at
    its cap and the manager's headroom rule promotes nothing). Every row
    must equal serial order on an InMemoryStorage fed the same requests
    on the same clock, the final get_counters must agree, and the drive
    must have launched B4d (promotions) and B3a (demotion peeks)."""
    from limitador_tpu_torch import Counter, InMemoryStorage, Limit
    from limitador_tpu_torch.device.storage import _Request
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.tier import TieredStorage, TierManager

    clock = ManualClock()
    storage = TieredStorage(capacity=capacity, cache_size=cache_size,
                            clock=clock, device=dev)
    oracle = InMemoryStorage(cache_size=1 << 30, clock=clock)
    window = Limit("tier", 100, 3600, [], ["u"], name="per-user")
    bucket = Limit("tier-tb", 20, 60, [], ["u"], name="per-user-tb",
                   policy="token_bucket")
    manager = TierManager(storage, batch=manager_batch)
    rng = np.random.default_rng(55)
    keys = zipf_keys(users, batches * hits, 0.99, rng)
    to_bucket = rng.random(batches * hits) < 0.2
    spent = {"check": 0.0, "peeks": 0.0, "rounds": 0.0, "oracle": 0.0}
    peek = storage.peek_slots
    peeks = [0]
    in_check = [False]

    def timed_peek(slots):
        if not in_check[0]:
            return peek(slots)
        peeks[0] += 1
        t0 = time.perf_counter()
        try:
            return peek(slots)
        finally:
            spent["peeks"] += time.perf_counter() - t0

    storage.peek_slots = timed_peek
    K.reset_launches()
    rounds, lull_rounds, killed = [], 0, False
    limited = np.zeros(batches * hits, bool)
    want = np.zeros(batches * hits, bool)
    names = {}

    def run_round(kill=False):
        def die():
            raise RuntimeError("phase 9a: killed between phase A and B")

        manager.kill_hook = die if kill else None
        t0 = time.perf_counter()
        out = manager.run_once()
        manager.kill_hook = None
        spent["rounds"] += time.perf_counter() - t0
        rounds.append(out)
        return out

    t_start = time.perf_counter()
    for b in range(batches):
        lo, hi = b * hits, (b + 1) * hits
        counters = []
        for k, is_tb in zip(keys[lo:hi].tolist(), to_bucket[lo:hi].tolist()):
            name = names.get(k)
            if name is None:
                name = names[k] = str(k)
            counters.append(Counter(bucket if is_tb else window, {"u": name}))
        peeks0, t0 = spent["peeks"], time.perf_counter()
        in_check[0] = True
        auths = storage.check_many([_Request([c], 1, False)
                                    for c in counters])
        in_check[0] = False
        spent["check"] += time.perf_counter() - t0 - (spent["peeks"] - peeks0)
        limited[lo:hi] = [a.limited for a in auths]
        t0 = time.perf_counter()
        want[lo:hi] = [oracle.check_and_update([Counter(c.limit,
                                                        c.set_variables)],
                                               1, False).limited
                       for c in counters]
        spent["oracle"] += time.perf_counter() - t0
        clock.now += 0.05
        if (b + 1) % round_every == 0:
            kill = not killed and b + 1 == 3 * round_every
            out = run_round(kill)
            killed = killed or out["aborted"]
        if b + 1 == batches // 2:
            # the lull: rounds with no traffic until one promotes
            while lull_rounds < 32:
                lull_rounds += 1
                if run_round()["promoted"]:
                    break
    seconds = time.perf_counter() - t_start - spent["oracle"]
    launches = dict(K.launches)
    stats = storage.tier_stats()
    n = limited.size
    cold_share = stats["cold"]["decisions"] / n
    rate = n / seconds
    print(f"tiered drive: capacity {capacity}, hot set {cache_size}, "
          f"{batches} batches x {hits} hits over {users} Zipf-0.99 users "
          f"(20% to a token bucket; {len(names)} distinct) in "
          f"{seconds:.2f}s = {rate:.0f} decisions/s "
          f"({int(limited.sum())} limited; {card})")
    print("tiered drive host time: " + ", ".join(
        f"{k} {v / batches * 1e3:.2f} ms/batch"
        for k, v in spent.items() if k != "oracle")
        + f" (check excludes its {peeks[0]} eviction peeks, "
        f"{spent['peeks'] / max(peeks[0], 1) * 1e6:.2f} us each; rounds "
        f"include their own peeks)")
    print(f"tiered drive: cold share of decisions {cold_share:.4f} "
          f"({stats['cold']['decisions']} of {n}); resident device "
          f"{stats['device_resident']}, cold {stats['cold']['resident']}; "
          f"demotions {stats['cold']['demotions']}, promotions "
          f"{stats['cold']['promotions']}; {len(rounds)} rounds "
          f"({lull_rounds} in the lull, {manager.aborted} killed): "
          f"{json.dumps(manager.stats())}")
    print(f"tiered drive launches: {json.dumps(launches)}")
    if not killed:
        fail("tiered drive: the killed round did not abort")
    if not np.array_equal(limited, want):
        fail(f"tiered drive rows differ from serial order at "
             f"{int(np.flatnonzero(limited != want)[0])}")
    got = {(c.limit.name, c.set_variables["u"]): (c.remaining, c.expires_in)
           for c in storage.get_counters({window, bucket})}
    exp = {(c.limit.name, c.set_variables["u"]): (c.remaining, c.expires_in)
           for c in oracle.get_counters({window, bucket})}
    if got.keys() != exp.keys():
        fail(f"tiered drive: get_counters lists {len(got)} counters, the "
             f"oracle {len(exp)}")
    # the device keeps expiries in whole ms: ttls agree within 2 ms
    bad = [k for k in got if got[k][0] != exp[k][0]
           or abs(got[k][1] - exp[k][1]) > 0.002]
    if bad:
        fail(f"tiered drive: {len(bad)} counters differ from the oracle "
             f"(first {bad[0]}: {got[bad[0]]} vs {exp[bad[0]]})")
    missing = [k for k in PHASE9A_KERNELS if _launched(launches, k) == 0]
    if missing:
        fail(f"kernels not launched on the tiered drive: {missing}")
    _host_forms_only(launches, "tiered drive", remote=False)
    print(f"tiered drive: {n} rows equal serial order; get_counters equals "
          f"the oracle's ({len(got)} counters); B4d launched "
          f"{launches['seed_slots']} times, B3a {launches['read_slots_host']} "
          f"(host form)")
    storage.close()
    return launches, {
        "decisions_per_s": rate, "seconds": seconds,
        "host_ms_per_batch": {k: v / batches * 1e3
                              for k, v in spent.items()},
        "eviction_peeks": peeks[0], "cold_share": cold_share,
        "us_per_eviction_peek": spent["peeks"] / max(peeks[0], 1) * 1e6,
        "device_resident": stats["device_resident"],
        "cold_resident": stats["cold"]["resident"],
        "demotions": stats["cold"]["demotions"],
        "promotions": stats["cold"]["promotions"],
        "rounds": len(rounds), "lull_rounds": lull_rounds,
        "distinct_users": len(names),
    }


TIERED_YAML = """\
- namespace: tier
  max_value: {max_value}
  seconds: 3600
  variables: ["descriptors[0].user"]
  name: per-user
"""


LEASE_PROBE_CALLS = 10  # half the limit of 20: the probe keeps budget


async def _lease_probe(channel, envoy, rls_pb2, server, broker, label):
    """Phase 9b's reclaim, made deterministic: one user made hot
    (LEASE_PROBE_CALLS calls), a grant through the broker's refresh, then
    one manager round whose only demotion candidate is that user's
    counter, so that a demotion meets a slot whose lease is live (a
    grant lives 0.25 s; the round follows the refresh at once)."""
    blob = _rls_request(rls_pb2, "tier", [{"user": "lease-probe"}])
    for _ in range(LEASE_PROBE_CALLS):
        await channel.unary_unary(envoy)(blob, timeout=60)
    manager = server.tier_manager
    storage = manager.storage

    def force():
        broker.refresh()
        live = broker.outstanding_by_slot()
        with storage._lock:
            probe = [
                (slot, key) for slot, (key, counter)
                in storage._table.info.items()
                if counter.set_variables.get("descriptors[0].user")
                == "lease-probe"]
        if not probe or probe[0][0] not in live:
            fail(f"{label}: the probe's slot {probe} holds no live lease "
                 f"after a refresh ({len(live)} live)")
        slot, key = probe[0]
        real = manager._candidates
        manager._candidates = lambda *_args: ([], 0.0, [key], 1)
        try:
            done = manager.run_once()
        finally:
            manager._candidates = real
        if done.get("demoted") != 1:
            fail(f"{label}: the probe's demotion round did {done}")
        return slot, live[slot]

    slot, debit = await asyncio.get_running_loop().run_in_executor(
        None, force)
    print(f"{label}: the lease probe's slot {slot} (outstanding debit "
          f"{debit}) demoted by one manager round", flush=True)


async def _served_tiers(tmpdir, dev, card, leases, calls=2000, users=600,
                        max_value=20, extra=(), label=None,
                        need_reclaim=True):
    """Phase 9b: a server built by ``server.start`` with ``torch
    --tier-mode on --pipeline native --cache-size 256
    --tier-migrate-interval 0.2`` (and ``--lease-mode on``), 2,000
    sequential ShouldRateLimit calls over 600 Zipf-0.99 users under 20 per
    hour, the storage clock frozen. Leases off: every answer equals a
    memory-storage server's on the same clock. Leases on: no user is
    admitted more than 20 times, granted = admissions + returned +
    outstanding at the end, and (with ``need_reclaim``) ``reclaim_slots``
    settled tokens: after the drive, a hot user's granted slot is demoted
    by one forced manager round (``_lease_probe``). Either way the manager
    ran rounds, demoted and promoted, and recorded no failure."""
    import grpc

    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.proto import rls_pb2

    label = label or ("served tiers (leases on)" if leases
                      else "served tiers")
    limits = os.path.join(tmpdir, "tiered.yaml")
    with open(limits, "w") as f:
        f.write(TIERED_YAML.format(max_value=max_value))
    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    parse = server.build_parser().parse_args
    clock = ManualClock()
    failures = []
    http, http_port = _http_options()
    argv = [limits, "torch", "--device", dev.type, "--rls-host", "127.0.0.1",
            *http, "--rls-port", str(ports[0]), "--tier-mode", "on",
            "--pipeline", "native", "--cache-size", "256",
            "--tier-migrate-interval", "0.2"]
    if leases:
        argv += ["--lease-mode", "on"]
    argv += list(extra)
    rng = np.random.default_rng(66 if leases else 65)
    who = zipf_keys(users, calls, 0.99, rng)
    K.reset_launches()
    tiered = await server.start(parse(argv), clock=clock,
                                on_failure=failures.append)
    oracle = None
    if not leases:
        oracle = await server.start(parse(
            [limits, "memory", "--rls-host", "127.0.0.1",
             *_http_options()[0], "--rls-port", str(ports[1])]),
            clock=clock)
    reclaimed = [0]
    broker = tiered.native_pipeline.lease_broker
    if broker is not None:
        reclaim = broker.reclaim_slots

        def counted_reclaim(slots):
            got = reclaim(slots)
            reclaimed[0] += got
            return got

        broker.reclaim_slots = counted_reclaim
    envoy = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
    ok = rls_pb2.RateLimitResponse.OK
    admitted = np.zeros(users, np.int64)
    lat = []
    mismatches = 0
    try:
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{ports[0]}") as tc:
            oc = (grpc.aio.insecure_channel(f"127.0.0.1:{ports[1]}")
                  if oracle is not None else None)
            t0 = time.perf_counter()
            for i, u in enumerate(who.tolist()):
                blob = _rls_request(rls_pb2, "tier", [{"user": f"t{u}"}])
                t1 = time.perf_counter()
                got = await tc.unary_unary(envoy)(blob, timeout=60)
                lat.append(time.perf_counter() - t1)
                if rls_pb2.RateLimitResponse.FromString(
                        got).overall_code == ok:
                    admitted[u] += 1
                if oc is not None:
                    want = await oc.unary_unary(envoy)(blob, timeout=60)
                    mismatches += got != want
            seconds = time.perf_counter() - t0
            if oc is not None:
                await oc.close()
            if broker is not None and need_reclaim:
                await _lease_probe(tc, envoy, rls_pb2, tiered, broker,
                                   label)
        # let a last round run after the drive
        await asyncio.sleep(0.5)
        manager = tiered.tier_manager
        # nothing migrates, grants or settles between the reads below
        manager.close()
        if broker is not None:
            broker.close()
        mstats = manager.stats()
        tstats = tiered.storage.tier_stats()
        lstats = broker.stats() if broker is not None else None
        families = await _served_metrics(http_port)
        tiering = json.loads(await _served_get(http_port, "/debug/tiering"))
        served = {tier: _metric(families, "tier_resident", tier=tier)
                  for tier in ("device", "cold")}
        if served != {"device": tstats["device_resident"],
                      "cold": tstats["cold"]["resident"]} \
                or tiering["device_resident"] != tstats["device_resident"]:
            fail(f"{label}: tier_resident {served} or /debug/tiering "
                 f"differs from tier_stats {tstats}")
        if broker is not None:
            got = {k: _metric(families, k) for k in (
                "lease_granted_tokens", "lease_admissions",
                "lease_returned_tokens", "lease_outstanding_tokens")}
            if got["lease_granted_tokens"] != (
                    got["lease_admissions"] + got["lease_returned_tokens"]
                    + got["lease_outstanding_tokens"]) \
                    or got["lease_granted_tokens"] == 0:
                fail(f"{label}: the lease_* families break conservation: "
                     f"{got}")
            print(f"{label}: /metrics lease_* keep granted = admissions "
                  f"+ returned + outstanding: {json.dumps(got)}")
        print(f"{label}: /metrics tier_resident {json.dumps(served)} "
              "equals tier_stats(); /debug/tiering answers 200")
    finally:
        await tiered.stop()
        if oracle is not None:
            await oracle.stop()
    launches = dict(K.launches)
    lat_ms = np.asarray(lat) * 1e3
    print(f"{label}: {calls} calls over {users} users, limit "
          f"{max_value}/h, hot set 256, in {seconds:.2f}s; p50 "
          f"{np.percentile(lat_ms, 50):.3f} ms, p99 "
          f"{np.percentile(lat_ms, 99):.3f} ms ({dev.type}; {card})")
    print(f"{label}: manager {json.dumps(mstats)}; resident device "
          f"{tstats['device_resident']}, cold {tstats['cold']['resident']}, "
          f"demotions {tstats['cold']['demotions']}, promotions "
          f"{tstats['cold']['promotions']}, cold decisions "
          f"{tstats['cold']['decisions']}")
    print(f"{label} launches: {json.dumps(launches)}")
    if failures or manager.error is not None:
        fail(f"{label}: a background tier failed: {failures!r}")
    if mstats["rounds"] == 0 or tstats["cold"]["demotions"] == 0 \
            or tstats["cold"]["promotions"] == 0:
        fail(f"{label}: the tiers did not move counters")
    out = {"seconds": seconds, "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)), "manager": mstats,
           "demotions": tstats["cold"]["demotions"],
           "promotions": tstats["cold"]["promotions"]}
    if not leases:
        if mismatches:
            fail(f"{label}: {mismatches} answers differ from the oracle's")
        print(f"{label}: every answer equals the memory oracle's")
        return launches, out
    conserved = lstats["lease_granted_tokens"] == (
        lstats["lease_admissions"] + lstats["lease_returned_tokens"]
        + lstats["lease_outstanding_tokens"])
    if not conserved:
        fail(f"{label}: token conservation broke: {lstats}")
    if admitted.max() > max_value:
        fail(f"{label}: a user was admitted {int(admitted.max())} times, "
             f"over the limit of {max_value}")
    if need_reclaim and reclaimed[0] <= 0:
        fail(f"{label}: reclaim_slots settled no tokens ({lstats})")
    print(f"{label}: max admitted per user {int(admitted.max())} <= "
          f"{max_value}; granted {lstats['lease_granted_tokens']} = "
          f"admissions {lstats['lease_admissions']} + returned "
          f"{lstats['lease_returned_tokens']} + outstanding "
          f"{lstats['lease_outstanding_tokens']}; reclaim_slots settled "
          f"{reclaimed[0]} tokens")
    out.update(reclaimed_tokens=reclaimed[0], lease=lstats,
               max_admitted=int(admitted.max()))
    return launches, out


# -- phase 10 ---------------------------------------------------------------


def _sharded_stream(rng, batches, hits):
    """Phase 10a's requests: ``batches`` batches of each kind in turn
    (lean, coupled, global, mixed), each request a tuple ("u", user),
    ("p", user, route) or ("t", tenant); users Zipf-0.99 over 1<<20,
    tenants Zipf-0.99 over 4096, routes uniform over 16."""
    out = []
    for _b in range(batches):
        for kind in ("lean", "coupled", "global", "mixed"):
            users = zipf_keys(C, hits, 0.99, rng).tolist()
            tenants = zipf_keys(4096, hits, 0.99, rng).tolist()
            routes = rng.integers(0, 16, hits).tolist()
            pick = {"lean": np.zeros(hits, int), "coupled": np.ones(hits, int),
                    "global": np.full(hits, 2),
                    "mixed": rng.integers(0, 3, hits)}[kind].tolist()
            batch = []
            for i in range(hits):
                if pick[i] == 0:
                    batch.append(("u", users[i]))
                elif pick[i] == 1:
                    batch.append(("p", users[i], routes[i]))
                else:
                    batch.append(("t", tenants[i]))
            out.append((kind, batch))
    return out


def _sharded_drive(storage, stream, limits, clock, step_at, clears=None):
    """Run the phase-10a stream through ``storage`` (check_many, batch
    N+1 begun before N is finished); the clock steps 61 s before batch
    ``step_at``. Returns the answers ((limited, limit name) per request,
    in order) and the per-batch host times. ``clears`` is the [B7b
    flushes, seconds] pair that the caller's wrappers of the storage's
    clears keep: it splits the clears out of begin and records the most
    flushes one begin and one finish made."""
    from limitador_tpu_torch import Counter
    from limitador_tpu_torch.device.storage import _Request

    lean, per_user, per_route, tenant = limits
    cache = {}

    def counters(spec):
        got = cache.get(spec)
        if got is None:
            if spec[0] == "u":
                got = [Counter(lean, {"u": str(spec[1])})]
            elif spec[0] == "p":
                got = [Counter(per_user, {"u": str(spec[1])}),
                       Counter(per_route, {"u": str(spec[1]),
                                           "r": str(spec[2])})]
            else:
                got = [Counter(tenant, {"t": str(spec[1])})]
            cache[spec] = got
        return got

    answers = []
    spent = {"requests": 0.0, "begin": 0.0, "finish": 0.0, "clears": 0.0,
             "most_flushes_begin": 0, "most_flushes_finish": 0}
    clears = clears if clears is not None else [0, 0.0]

    def finish(handle):
        flushes = clears[0]
        answers.extend(storage.finish_check_many(handle))
        spent["most_flushes_finish"] = max(spent["most_flushes_finish"],
                                           clears[0] - flushes)

    inflight = None
    for b, (_kind, batch) in enumerate(stream):
        if b == step_at:
            if inflight is not None:
                finish(inflight)
                inflight = None
            clock.now += 61.0
        t1 = time.perf_counter()
        requests = [_Request(counters(spec), 1, False) for spec in batch]
        t2 = time.perf_counter()
        flushes, clear_s = clears
        handle = storage.begin_check_many(requests)
        t3 = time.perf_counter()
        spent["clears"] += clears[1] - clear_s
        spent["most_flushes_begin"] = max(spent["most_flushes_begin"],
                                          clears[0] - flushes)
        if inflight is not None:
            finish(inflight)
        inflight = handle
        t4 = time.perf_counter()
        spent["requests"] += t2 - t1
        spent["begin"] += t3 - t2
        spent["finish"] += t4 - t3
    finish(inflight)
    return [(a.limited, a.limit_name) for a in answers], spent


def phase_sharded_drive(dev, card, batches=SHARDED_BATCHES, hits=8192):
    """Phase 10a: TorchShardedStorage(n_shards=8, local_capacity=1<<17,
    global_namespaces=["tenants"], global_region=1024) on the card, frozen
    clock stepped past one window half way, ``batches`` batches of
    ``hits`` one-request-a-hit-or-two requests of each kind: lean (the
    phase-5 limit, 100 per hour per user), coupled (per user and per
    (user, route of 16): most requests span rows), global (1000 per
    minute per tenant over 4096 Zipf tenants, more than the region holds:
    evictions zero global slots through B7b) and mixed (all three in one
    batch). Then get_counters, a drain of the hit accumulator (B7d) and
    a delete_counters (B7b). Checks: the lean and coupled answers and
    counters against an InMemoryStorage on the same clock; the whole
    drive against the same drive on TorchShardedStorage(device="cpu")
    (every answer, the drain's records and the three [8, L+1] arrays);
    the global namespace's over-admission per batch within the JAX
    contract, (n - 1) x the budget left before the batch."""
    import torch

    from limitador_tpu_torch import Counter, InMemoryStorage, Limit
    from limitador_tpu_torch.device.sharded import TorchShardedStorage
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.parallel import mesh as M

    lean = Limit("drive", 100, 3600, [], ["u"])
    per_user = Limit("pair", 50, 3600, [], ["u"], name="per-user")
    per_route = Limit("pair", 10, 3600, [], ["u", "r"], name="per-route")
    tenant = Limit("tenants", 1000, 60, [], ["t"], name="per-tenant")
    limits = (lean, per_user, per_route, tenant)
    stream = _sharded_stream(np.random.default_rng(77), batches, hits)
    step_at = len(stream) // 2
    start = float(int(time.time()))
    n = SHARDS

    def build(device, clock):
        return TorchShardedStorage(
            n_shards=n, local_capacity=LOCAL_CAP,
            global_namespaces=["tenants"], global_region=GLOBAL_REGION,
            clock=clock, device=device)

    # the card: launches counted, the launch wrapper timed, evictions of
    # global slots recorded per window
    clock = ManualClock()
    clock.now = start
    storage = build(dev, clock)
    evicted = set()
    release = storage._gtable.release
    window = [0]

    def tracked_release(slot, key, qualified):
        evicted.add((window[0], key[1][0][1]))
        return release(slot, key, qualified)

    storage._gtable.release = tracked_release
    launch = M.sharded_check_and_update
    launch_s = [0.0]

    def timed_launch(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return launch(*args, **kwargs)
        finally:
            launch_s[0] += time.perf_counter() - t0

    M.sharded_check_and_update = timed_launch
    # the clears: B7b flushes counted, their time and the list building
    # (staging evicted global slots) timed
    clears = [0, 0.0]
    flush, zero = storage._flush_clears, storage._zero_global_slots

    def timed_flush():
        clears[0] += bool(storage._clear_pairs or storage._clear_all)
        t0 = time.perf_counter()
        try:
            flush()
        finally:
            clears[1] += time.perf_counter() - t0

    def timed_zero(slots):
        t0 = time.perf_counter()
        try:
            zero(slots)
        finally:
            clears[1] += time.perf_counter() - t0

    storage._flush_clears, storage._zero_global_slots = timed_flush, timed_zero
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        answers, spent = _sharded_drive(storage, stream, limits, clock,
                                        step_at, clears)
        storage.close()
    finally:
        M.sharded_check_and_update = launch
    seconds = time.perf_counter() - t0
    drive_clears, drive_flushes = K.launches["sharded_clear_cells"], clears[0]
    variants = storage.launch_stats()["sharded_launches"]
    got_counters = {
        (c.limit.name, tuple(c.set_variables.items())): (c.remaining,
                                                         c.expires_in)
        for c in storage.get_counters({lean, per_user, per_route})}
    drained = storage.drain_hot_slots(64)
    storage.delete_counters({tenant, per_route})
    storage.close()
    launches = dict(K.launches)
    card_arrays = [t.cpu().numpy() for t in storage._state]

    # the same drive on the CPU (plain versions)
    cpu_clock = ManualClock()
    cpu_clock.now = start
    cpu = build("cpu", cpu_clock)
    cpu_answers, _ = _sharded_drive(cpu, stream, limits, cpu_clock, step_at)
    cpu_drained = cpu.drain_hot_slots(64)
    cpu.delete_counters({tenant, per_route})
    same = cpu_answers == answers and cpu_drained == drained and all(
        np.array_equal(a, t.numpy()) for a, t in zip(card_arrays, cpu._state))

    # the lean and coupled namespaces against the in-memory oracle, fed
    # the same requests in the same order on the same clock
    oracle_clock = ManualClock()
    oracle_clock.now = start
    oracle = InMemoryStorage(cache_size=1 << 30, clock=oracle_clock)
    flat = [spec for _kind, batch in stream for spec in batch]
    per_batch = [len(batch) for _kind, batch in stream]
    mismatches = 0
    i = 0
    for b, size in enumerate(per_batch):
        if b == step_at:
            oracle_clock.now += 61.0
        for j in range(i, i + size):
            spec = flat[j]
            if spec[0] == "t":
                continue
            if spec[0] == "u":
                cs = [Counter(lean, {"u": str(spec[1])})]
            else:
                cs = [Counter(per_user, {"u": str(spec[1])}),
                      Counter(per_route, {"u": str(spec[1]),
                                          "r": str(spec[2])})]
            a = oracle.check_and_update(cs, 1, False)
            mismatches += (a.limited, a.limit_name) != answers[j]
        i += size
    want_counters = {
        (c.limit.name, tuple(c.set_variables.items())): (c.remaining,
                                                         c.expires_in)
        for c in oracle.get_counters({lean, per_user, per_route})}
    bad_counters = [k for k in want_counters
                    if k not in got_counters
                    or got_counters[k][0] != want_counters[k][0]
                    or abs(got_counters[k][1] - want_counters[k][1]) > 0.002]
    # Beyond the oracle's, the storage may list counters with nothing
    # spent: a fresh slot that a limited request of a batch allocated past
    # its first limited hit and another request of the same batch shares
    # stays allocated (the JAX storage's release rule, finish_check_many).
    full = {limit.name: limit.max_value for limit in limits}
    bad_counters += [k for k in got_counters if k not in want_counters
                     and got_counters[k][0] != full[k[0]]]

    # the global namespace: over-admission per batch within the contract
    admitted = {}
    over_total = 0
    violations = 0
    checked = 0
    i = 0
    for b, size in enumerate(per_batch):
        w = int(b >= step_at)
        in_batch = {}
        for j in range(i, i + size):
            spec = flat[j]
            if spec[0] == "t" and not answers[j][0]:
                in_batch[spec[1]] = in_batch.get(spec[1], 0) + 1
        for t, got in in_batch.items():
            before = admitted.get((w, t), 0)
            after = before + got
            admitted[(w, t)] = after
            excess = max(after - 1000, 0) - max(before - 1000, 0)
            over_total += excess
            if (w, str(t)) in evicted:
                continue  # its count restarted: LRU eviction, not the psum
            checked += 1
            if excess > (n - 1) * max(1000 - before, 0):
                violations += 1
        i += size
    decided = len(answers)
    rate = decided / seconds
    local_n = sum(1 for spec in flat if spec[0] != "t")
    print(f"sharded drive: {n} shards x {LOCAL_CAP} cells, "
          f"{len(stream)} batches x {hits} requests (lean, coupled, global, "
          f"mixed) in {seconds:.2f}s = {rate:.0f} decisions/s "
          f"({sum(a[0] for a in answers)} limited; {card})")
    print("sharded drive host time: " + ", ".join(
        f"{k} {v / len(stream) * 1e3:.2f} ms/batch" for k, v in
        (("requests", spent["requests"]),
         ("staging", spent["begin"] - launch_s[0]),
         ("of which clears", spent["clears"]),
         ("launch", launch_s[0]), ("finish", spent["finish"]))))
    print(f"sharded drive clears: {storage._gtable.evictions} global "
          f"evictions, {drive_clears} B7b launches in {drive_flushes} flushes "
          f"over {len(stream)} staging passes (at most "
          f"{spent['most_flushes_begin']} a staging pass, "
          f"{spent['most_flushes_finish']} a finish); "
          f"{launches['sharded_clear_cells'] - drive_clears} more for the "
          f"reads, drain and delete after it")
    print(f"sharded drive launches per variant: {json.dumps(variants)}; "
          f"kernels: {json.dumps(launches)}")
    print(f"sharded drive: {local_n} lean+coupled answers vs the "
          f"in-memory oracle: {mismatches} differ, {len(bad_counters)} "
          f"counters differ of {len(want_counters)}; card vs CPU: "
          f"{'equal' if same else 'DIFFERENT'} (answers, drain, arrays); "
          f"global over-admission {over_total} over "
          f"{len({k for k in admitted})} (window, tenant) pairs, "
          f"{violations} of {checked} batch checks past (n-1) x budget; "
          f"{storage._gtable.evictions} global evictions")
    if mismatches or bad_counters:
        k = bad_counters[0] if bad_counters else None
        fail(f"sharded drive: lean/coupled answers or counters differ from "
             f"the in-memory oracle (first counter {k}: "
             f"{got_counters.get(k)} vs {want_counters.get(k)})")
    if not same:
        fail("sharded drive: the card and the CPU differ")
    if violations:
        fail("sharded drive: global over-admission past the bound")
    if min(variants.values()) == 0:
        fail(f"sharded drive: a launch variant never ran: {variants}")
    if spent["most_flushes_begin"] > 1 or spent["most_flushes_finish"] > 1:
        fail("sharded drive: more than one B7b flush in a staging pass or "
             "a finish")
    missing = [k for k in ("sharded_check_and_update_cluster",
                           "sharded_clear_cells", "sharded_drain_top_hits")
               if _launched(launches, k) == 0]
    if missing:
        fail(f"kernels not launched on the sharded drive: {missing}")
    return launches, {
        "decisions_per_s": rate, "seconds": seconds,
        "host_ms_per_batch": {
            "requests": spent["requests"] / len(stream) * 1e3,
            "staging": (spent["begin"] - launch_s[0]) / len(stream) * 1e3,
            "staging_clears": spent["clears"] / len(stream) * 1e3,
            "launch": launch_s[0] / len(stream) * 1e3,
            "finish": spent["finish"] / len(stream) * 1e3},
        "variants": variants, "global_over_admission": over_total,
        "global_evictions": storage._gtable.evictions,
        "b7b_launches_drive": drive_clears,
        "b7b_flushes_drive": drive_flushes,
        "bound_checks": checked,
    }


SHARDED_YAML = """\
- namespace: shop
  max_value: 20
  seconds: 3600
  variables: ["descriptors[0].user"]
  name: per-user
- namespace: shop
  max_value: 6
  seconds: 3600
  variables: ["descriptors[0].user", "descriptors[0].item"]
  name: per-item
- namespace: tenants
  max_value: 40
  seconds: 60
  variables: ["descriptors[0].tenant"]
  name: per-tenant
"""

SHARDED_RELOADED_YAML = """\
- namespace: shop
  max_value: 20
  seconds: 3600
  variables: ["descriptors[0].user"]
  name: per-user
- namespace: tenants
  max_value: 40
  seconds: 60
  variables: ["descriptors[0].tenant"]
  name: per-tenant
"""


async def _served_sharded(tmpdir, dev, card, calls=2000, users=300):
    """Phase 10b: ``server.start`` with ``sharded --global-namespaces
    tenants --pipeline compiled`` on the card (one row: one card) and a
    memory server on one frozen clock; 2,000 sequential calls in turn:
    ShouldRateLimit and Kuadrant CheckRateLimit on shop (two limits,
    per user and per (user, item)), Kuadrant Report on shop (B7c), and
    ShouldRateLimit on the global tenants namespace; half way a hot
    reload drops per-item, whose live counters go through B7b; the
    default observatory drains through B7d. Every answer must equal the
    memory server's."""
    import grpc

    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.proto import rls_pb2

    limits = os.path.join(tmpdir, "sharded.yaml")
    with open(limits, "w") as f:
        f.write(SHARDED_YAML)
    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    parse = server.build_parser().parse_args
    clock = ManualClock()
    failures = []
    K.reset_launches()
    http, http_port = _http_options()
    sharded = await server.start(parse(
        [limits, "sharded", "--device", dev.type, "--global-namespaces",
         "tenants", "--pipeline", "compiled", "--usage-drain-interval",
         "0.25", "--rls-host", "127.0.0.1", *http, "--rls-port",
         str(ports[0])]), clock=clock, on_failure=failures.append)
    oracle = await server.start(parse(
        [limits, "memory", "--rls-host", "127.0.0.1", *_http_options()[0],
         "--rls-port", str(ports[1])]), clock=clock)
    rng = np.random.default_rng(88)
    who = zipf_keys(users, calls, 0.99, rng).tolist()
    items = rng.integers(0, 8, calls).tolist()
    tenants = zipf_keys(64, calls, 0.99, rng).tolist()
    envoy = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
    kuadrant = "/kuadrant.service.ratelimit.v1.RateLimitService/"
    lat = []
    mismatches = global_mismatches = 0
    try:
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{ports[0]}") as sc, grpc.aio.insecure_channel(
                f"127.0.0.1:{ports[1]}") as oc:
            t0 = time.perf_counter()
            for i in range(calls):
                if i == calls // 2:
                    with open(limits, "w") as f:
                        f.write(SHARDED_RELOADED_YAML)
                    st = os.stat(limits)
                    os.utime(limits, ns=(st.st_atime_ns,
                                         st.st_mtime_ns + 10**9))
                    deadline = time.monotonic() + 20
                    while (len(sharded.limiter.get_limits("shop")) != 1
                           or len(oracle.limiter.get_limits("shop")) != 1):
                        if time.monotonic() > deadline:
                            fail("sharded server: reload not applied")
                        await asyncio.sleep(0.05)
                kind = i % 4
                if kind == 3:
                    rpc, blob = envoy, _rls_request(
                        rls_pb2, "tenants", [{"tenant": f"t{tenants[i]}"}])
                else:
                    desc = [{"user": f"u{who[i]}", "item": f"i{items[i]}"}]
                    rpc = (envoy, kuadrant + "CheckRateLimit",
                           kuadrant + "Report")[kind]
                    blob = _rls_request(rls_pb2, "shop", desc,
                                        2 if kind == 2 else 0)
                t1 = time.perf_counter()
                got = await sc.unary_unary(rpc)(blob, timeout=60)
                lat.append(time.perf_counter() - t1)
                want = await oc.unary_unary(rpc)(blob, timeout=60)
                if got != want:
                    if kind == 3:
                        global_mismatches += 1
                    else:
                        mismatches += 1
            seconds = time.perf_counter() - t0
        drains = sharded.observatory.tenant_usage()["drains"]
        deadline = time.monotonic() + 10
        while sharded.observatory.tenant_usage()["drains"] <= drains:
            if time.monotonic() > deadline:
                fail("sharded server: the usage observatory did not drain")
            await asyncio.sleep(0.05)
        top = sharded.observatory.top(3)
        variants = sharded.storage.launch_stats()["sharded_launches"]
        families = await _served_metrics(http_port)
        served = {v: _metric(families, "sharded_launches", variant=v)
                  for v in variants}
        if served != variants:
            fail(f"served sharded: /metrics sharded_launches {served} != "
                 f"the storage's tally {variants}")
        print(f"served sharded: /metrics sharded_launches by variant "
              f"equals the storage's tally")
    finally:
        await sharded.stop()
        await oracle.stop()
    launches = dict(K.launches)
    lat_ms = np.asarray(lat) * 1e3
    print(f"served sharded: {calls} sequential calls in {seconds:.2f}s; "
          f"p50 {np.percentile(lat_ms, 50):.3f} ms, p99 "
          f"{np.percentile(lat_ms, 99):.3f} ms ({dev.type}; {card}); "
          f"{mismatches} non-global and {global_mismatches} global answers "
          f"differ from the memory server's")
    print(f"served sharded: variants {json.dumps(variants)}; usage top-3 "
          f"{[(r['namespace'], r['key'], r['hits']) for r in top]}")
    print(f"served sharded launches: {json.dumps(launches)}")
    if failures:
        fail(f"served sharded: a background tier failed: {failures!r}")
    if mismatches:
        fail("served sharded: answers differ from the memory server's")
    missing = [k for k in SHARDED_KERNELS if _launched(launches, k) == 0]
    if missing:
        fail(f"kernels not launched on the served sharded path: {missing}")
    return launches, {
        "seconds": seconds, "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "global_mismatches": global_mismatches, "variants": variants,
    }


# -- phase 11 ---------------------------------------------------------------

HTTP_CALLS = 1000  # 2,000 until phase 19 came in
HTTP_YAML = """\
- namespace: web
  max_value: 5
  seconds: 60
  variables: ["descriptors[0].user"]
  name: per-user
- namespace: web
  max_value: 3
  seconds: 10
  variables: ["descriptors[0].user", "descriptors[0].route"]
  policy: token_bucket
  name: per-route
"""
# the reload at call 1,000 drops the token bucket
HTTP_RELOADED_YAML = """\
- namespace: web
  max_value: 5
  seconds: 60
  variables: ["descriptors[0].user"]
  name: per-user
"""
HTTP_LABELS = "{'route': descriptors[0].route}"


def _same_http_answer(got, want) -> bool:
    """Same status, body and X-RateLimit headers; X-RateLimit-Reset
    within 1 s (the device counts whole milliseconds, the memory server
    float seconds), as ``_same_answer`` holds the gRPC answers."""
    (gs, gh, gb), (ws, wh, wb) = got, want
    if (gs, gb) != (ws, wb) or [k for k, _v in gh] != [k for k, _v in wh]:
        return False
    for (key, g), (_key, w) in zip(gh, wh):
        if key.lower() == "x-ratelimit-reset":
            if abs(int(g) - int(w)) > 1:
                return False
        elif g != w:
            return False
    return True


def _counters_by_identity(body):
    """A ``/counters`` body as {(limit, set_variables): (remaining,
    expires_in_seconds)}: its order sorts on the expiry too, so two
    servers a second apart list the same counters in other orders."""
    return {
        (json.dumps(c["limit"], sort_keys=True),
         json.dumps(c["set_variables"], sort_keys=True)):
        (c["remaining"], c["expires_in_seconds"])
        for c in body
    }


def _counters_differ(got, want, seconds=1):
    """The counters of two ``/counters`` bodies that differ: any but
    ``expires_in_seconds`` (whole seconds, truncated) within ``seconds``."""
    g, w = _counters_by_identity(got), _counters_by_identity(want)
    out = []
    for key in sorted(g.keys() | w.keys()):
        a, b = g.get(key), w.get(key)
        if a is None or b is None or a[0] != b[0] or (a[1] is None) != (
                b[1] is None) or (a[1] is not None
                                  and abs(a[1] - b[1]) > seconds):
            out.append((key, a, b))
    return out


def _http_calls(conns, calls, lat):
    """Send each (path, body) of ``calls`` to every connection of
    ``conns`` in turn (http.client, keep-alive); returns per call the
    answers (status, X-RateLimit-* headers, body), and appends the first
    connection's seconds per call to ``lat`` by path."""
    out = []
    headers = {"Content-Type": "application/json"}
    for path, body in calls:
        answers = []
        for i, conn in enumerate(conns):
            t0 = time.perf_counter()
            conn.request("POST", path, body, headers)
            resp = conn.getresponse()
            data = resp.read()
            if i == 0:
                lat.setdefault(path, []).append(time.perf_counter() - t0)
            answers.append((resp.status, sorted(
                (k, v) for k, v in resp.getheaders()
                if k.lower().startswith("x-ratelimit")), data))
        out.append(answers)
    return out


def _http_plan(calls):
    """Phase 11's calls: (path, JSON body) each, 60% POST
    /check_and_report (half with draft-03 headers), 20% /check, 20%
    /report, users Zipf-0.99 over 1<<20 ids, routes of 16; and the hits
    each user's per-user counter takes (every call but /check)."""
    rng = np.random.default_rng(111)
    users = zipf_keys(1 << 20, calls, 0.99, rng).tolist()
    routes = rng.integers(0, 16, calls).tolist()
    kinds = rng.random(calls).tolist()
    drafts = (rng.random(calls) < 0.5).tolist()
    plan = []
    tally = {}
    for i in range(calls):
        values = {"user": f"u{users[i]}", "route": f"r{routes[i]}"}
        body = {"namespace": "web", "values": values, "delta": 1}
        if kinds[i] < 0.6:
            path = "/check_and_report"
            if drafts[i]:
                body["response_headers"] = "DRAFT_VERSION_03"
        else:
            path = "/check" if kinds[i] < 0.8 else "/report"
        if path != "/check":
            # one kernel hit on the per-user counter (B1 or B2's host form)
            tally[users[i]] = tally.get(users[i], 0) + 1
        plan.append((path, json.dumps(body)))
    return plan, tally


async def _http_api(tmpdir, dev, card, calls=HTTP_CALLS):
    """Phase 11: the HTTP API of ``server.start`` with torch --device
    cuda --capacity 1<<20 --usage-topk 64 --limit-name-in-labels and a
    one-label --metric-labels map, beside a memory server with the same
    options, on one frozen clock (5 ms a call, 61 s at call 1,500).
    2,000 sequential calls to each through http.client with keep-alive:
    60% POST /check_and_report (half with draft-03 headers), 20% /check,
    20% /report, users Zipf-0.99 over 1<<20 ids, routes of 16; the
    limits file's token bucket is dropped at call 1,000. Every answer
    must equal the memory server's, and so must /counters/web and the
    authorized_calls, authorized_hits and limited_calls samples; the
    occupancy gauge must equal device_stats() and /debug/top?k=64 a host
    tally of hits (one drain, at the request: the observatory's interval
    is longer than the drive)."""
    import http.client

    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server import __main__ as server

    label = "HTTP API (11)"
    limits = os.path.join(tmpdir, "http.yaml")
    with open(limits, "w") as f:
        f.write(HTTP_YAML)
    parse = server.build_parser().parse_args
    clock = ManualClock()
    failures = []
    common = ["--rls-host", "127.0.0.1", "--limit-name-in-labels",
              "--metric-labels", HTTP_LABELS, "--usage-topk", "64",
              "--usage-drain-interval", "3600"]
    ports = {}
    servers = {}
    plan, tally = _http_plan(calls)
    K.reset_launches()
    try:
        for name, storage, extra in (
                ("gpu", "torch", ["--device", dev.type, "--capacity",
                                  str(C)]),
                ("memory", "memory", [])):
            http_opts, ports[name] = _http_options()
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                rls = sock.getsockname()[1]
            servers[name] = await server.start(parse(
                [limits, storage, *extra, *common, *http_opts,
                 "--rls-port", str(rls)]), clock=clock,
                on_failure=failures.append)
        gpu, memory = servers["gpu"], servers["memory"]
        conns = [http.client.HTTPConnection("127.0.0.1", ports[n],
                                            timeout=60)
                 for n in ("gpu", "memory")]
        loop = asyncio.get_running_loop()
        lat = {}
        answers = []
        t0 = time.perf_counter()
        for lo, hi in ((0, calls // 2), (calls // 2, calls)):
            if lo:
                with open(limits, "w") as f:
                    f.write(HTTP_RELOADED_YAML)
                st = os.stat(limits)
                os.utime(limits, ns=(st.st_atime_ns,
                                     st.st_mtime_ns + 10**9))
                deadline = time.monotonic() + 20
                while any(len(srv.limiter.get_limits("web")) != 1
                          for srv in servers.values()):
                    if time.monotonic() > deadline:
                        fail(f"{label}: reload not applied within 20 s")
                    await asyncio.sleep(0.05)
            for i in range(lo, hi):
                clock.now += 61.0 if i == 3 * calls // 4 else 0.005
                answers += await loop.run_in_executor(
                    None, _http_calls, conns, plan[i:i + 1], lat)
        seconds = time.perf_counter() - t0
        for conn in conns:
            conn.close()
        mismatches = [i for i, (got, want) in enumerate(answers)
                      if not _same_http_answer(got, want)]
        resets_off = sum(got != want for got, want in answers)
        statuses = {}
        for (status, _h, _b), _want in answers:
            statuses[status] = statuses.get(status, 0) + 1
        counters = {name: json.loads(await _served_get(
            ports[name], "/counters/web")) for name in servers}
        top = json.loads(await _served_get(ports["gpu"],
                                           "/debug/top?k=64"))["top"]
        occupied = gpu.storage.device_stats()["shards"][0]["occupied"]
        families = {name: await _served_metrics(ports[name])
                    for name in servers}
        device_latency = _histogram(families["gpu"],
                                    "datastore_device_latency")
    finally:
        for srv in servers.values():
            await srv.stop()
    launches = dict(K.launches)

    def samples(fams, name):
        return sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                      for s in fams[name].samples
                      if s.name.endswith("_total"))

    print(f"{label}: {calls} calls to each server in {seconds:.2f}s, "
          f"statuses {json.dumps(statuses)}; {len(mismatches)} answers "
          f"differ from the memory server's ({resets_off} with an "
          f"X-RateLimit-Reset 1 s apart)")
    for path, values in sorted(lat.items()):
        ms = np.asarray(values) * 1e3
        print(f"{label} {path} latency ({dev.type}; {card}): p50 "
              f"{np.percentile(ms, 50):.3f} ms, p99 "
              f"{np.percentile(ms, 99):.3f} ms over {ms.size}")
    print(f"{label} /metrics datastore_device_latency (the batchers' round "
          f"trips): {json.dumps(device_latency)}")
    print(f"{label} launches: {json.dumps(launches)}")
    if failures:
        fail(f"{label}: a background tier failed: {failures!r}")
    if mismatches:
        i = mismatches[0]
        fail(f"{label}: call {i} {plan[i]}: {answers[i][0]} != "
             f"{answers[i][1]}")
    if statuses.get(429, 0) == 0 or statuses.get(200, 0) == 0:
        fail(f"{label}: the drive never limited or never admitted")
    differ = _counters_differ(counters["gpu"], counters["memory"])
    if differ or not counters["gpu"]:
        fail(f"{label}: {len(differ)} of /counters/web differ from the "
             f"memory server's: {differ[:3]}")
    for name in ("authorized_calls", "authorized_hits", "limited_calls"):
        got = samples(families["gpu"], name)
        if got != samples(families["memory"], name) or not got:
            fail(f"{label}: {name} samples differ from the memory "
                 f"server's")
    used = _metric(families["gpu"], "counter_slots_used", shard="0")
    if used != occupied or occupied == 0:
        fail(f"{label}: counter_slots_used {used} != device_stats "
             f"{occupied}")
    got = [(int(r["key"]["descriptors[0].user"][1:]), r["hits"])
           for r in top]
    if any(tally.get(u) != hits for u, hits in got) or sorted(
            (h for _u, h in got), reverse=True) != sorted(
            tally.values(), reverse=True)[:64]:
        fail(f"{label}: /debug/top differs from the host tally: "
             f"{got[:5]}")
    print(f"{label}: answers, /counters/web, the reference counters and "
          f"the occupancy gauge ({occupied}) equal the memory server's "
          f"and device_stats(); /debug/top?k=64 equals the host tally "
          f"(top: user {got[0][0]} with {got[0][1]} hits)")
    if _launched(launches, "check_and_update") + _launched(
            launches, "check_and_update_cluster") == 0:
        fail(f"{label}: B1 not launched")
    _storage_forms(launches, label, ("update_host", "read_slots_host",
                                     "drain_top_hits_host"))
    return launches, {
        "seconds": seconds, "statuses": statuses,
        "latency_ms": {path: {
            "p50": float(np.percentile(np.asarray(v) * 1e3, 50)),
            "p99": float(np.percentile(np.asarray(v) * 1e3, 99)),
            "n": len(v)} for path, v in lat.items()},
        "occupied": occupied, "datastore_device_latency": device_latency,
    }


# -- phase 14: the host storages and the shared authority --------------------

# (a): four replicas at the reference's write-behind defaults decide this
# many one-hit requests together over Zipf-0.99 users from 1<<20 keys,
# under phase 5's limit at a minute (100 per user); a fifth replica then
# flushes this many distinct counters in one RPC (batch size 4096: past
# B2's parameter block, the staged route); the sharded authority takes
# two replicas and this many requests
# (80,000 and 20,000 until phase 17 came in)
AUTH_REQUESTS = 40_000
AUTH_REPLICAS = 4
AUTH_BIG_FLUSH = 2400
AUTH_SHARDED_REQUESTS = 10_000
# Requests a second offered to each replica. The replicas are threads of
# this process: deciding flat out they hold the GIL, the authority's RPC
# threads wait past the 350 ms timeout, and a replica that times out
# never recovers (it flushes its whole backlog in one RPC, which takes
# longer each time, and the authority applies every timed-out RPC
# anyway; PERF.md §6, ROADMAP Queue C). Paced, the four offer
# 4,000 requests a second, as four servers each under its own load.
AUTH_RATE = 1000
# (b): two replicas, half of the requests before the authority stops and
# half while it is down
PARTITION_REQUESTS = 6_000
# (c): calls to each served replica; (d): calls of phase 11's sequence
SERVED_AUTH_CALLS = 1000
HOST_CALLS = 1000
AUTH_LIMITS_YAML = """\
- namespace: ns
  max_value: 100
  seconds: 60
  variables: ["descriptors[0].u"]
  name: per-user
"""


def _replica_thread(url, users, clock, out, *, batch_size=100,
                    gates=None, limits=None, yield_every=64,
                    rate=AUTH_RATE):
    """One write-behind replica in a thread of its own with its own event
    loop: a CachedCounterStorage over RemoteAuthority(url) at the
    reference's defaults (flush 1 s, ``batch_size``, 10,000 cached, a
    350 ms timeout) decides one hit for each user of ``users`` in turn
    (``limits``: the limits it holds, phase 5's at a minute by default),
    ``rate`` a second (None: flat out), yielding to its flush loop every
    ``yield_every`` decisions (None: never, so that one flush carries
    them all), then flushes until its authority has every delta.
    ``gates``, for phase 14b: (halfway, down, partitioned, up) events:
    set ``halfway`` after half of the decisions, wait for ``down``,
    decide the rest, flush (which must fail), set ``partitioned``, wait
    for ``up``. Fills ``out`` with the admitted hits by (limit name,
    user), the partition flags, the flushes' sizes and seconds (client
    side), decision errors, flush errors, the overshoot and the seconds
    spent."""
    from limitador_tpu_torch import AsyncRateLimiter, Context, Limit
    from limitador_tpu_torch.storage.authority import RemoteAuthority
    from limitador_tpu_torch.storage.cached import CachedCounterStorage

    flags = []
    limits = limits or [Limit("ns", 100, 60, [], ["u"], name="per-user")]
    remote = RemoteAuthority(url, timeout=0.35)
    rpcs = []
    apply = remote.apply_deltas

    def timed(items):
        t0 = time.perf_counter()
        try:
            return apply(items)
        finally:
            rpcs.append((len(items), time.perf_counter() - t0))

    remote.apply_deltas = timed

    async def main():
        cached = CachedCounterStorage(
            remote, flush_period=1.0,
            batch_size=batch_size, max_cached=10_000, clock=clock,
            on_partitioned=flags.append)
        limiter = AsyncRateLimiter(cached)
        for limit in limits:
            limiter.add_limit(limit)
        namespaces = sorted({str(limit.namespace) for limit in limits})
        admitted = {}
        errors = 0
        t0 = time.perf_counter()
        half = len(users) // 2
        for i, user in enumerate(users):
            if gates is not None and i == half:
                gates[0].set()
                await asyncio.get_running_loop().run_in_executor(
                    None, gates[1].wait, 60)
            for ns in namespaces:
                try:
                    r = await limiter.check_rate_limited_and_update(
                        ns, Context({"u": user}), 1, load_counters=True)
                except Exception:
                    errors += 1
                    continue
                if not r.limited:
                    for c in r.counters:
                        key = (c.limit.name, user)
                        admitted[key] = admitted.get(key, 0) + 1
            if yield_every and i % yield_every == yield_every - 1:
                ahead = (t0 + (i + 1) / rate - time.perf_counter()
                         if rate else 0.0)
                await asyncio.sleep(max(ahead, 0.0))
        decided_s = time.perf_counter() - t0
        if gates is not None:
            await cached.flush()
            out["partitioned_after_down"] = cached.partitioned
            gates[2].set()
            await asyncio.get_running_loop().run_in_executor(
                None, gates[3].wait, 60)
        deadline = time.monotonic() + 20
        await cached.flush()
        while cached.partitioned or cached._batch:
            if time.monotonic() > deadline:
                break
            await asyncio.sleep(0.1)
            await cached.flush()
        out.update(admitted=admitted, errors=errors, seconds=decided_s,
                   flush_errors=cached.flush_errors,
                   overshoot=cached.counter_overshoot,
                   evicted=cached.evicted_pending_writes,
                   left=len(cached._batch), partitioned=cached.partitioned)
        await cached.close()

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(main())
    except BaseException as exc:  # reported by the caller
        out["raised"] = repr(exc)
    finally:
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()
        out["flags"] = flags
        out["rpcs"] = rpcs


@contextlib.contextmanager
def _frozen_heap():
    """Every object made before the block (torch's, the tables', the
    earlier phases') moved out of the collector's reach (``gc.freeze``)
    and the oldest generation's threshold raised while it runs: the
    replicas and the authority share this process, and a full collection
    stops all of them at once, for 630 ms over the whole script's heap
    and 150 ms over a frozen one's (PERF.md §6), where a flush may
    take 350 ms; each would be a process of its own in a deployment.
    Yields the collections in the block by generation: (count, longest
    ms), from gc.callbacks."""
    import gc

    pauses = {}
    started = []

    def timed(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            ms = (time.perf_counter() - started.pop()) * 1e3
            n, longest = pauses.get(info["generation"], (0, 0.0))
            pauses[info["generation"]] = (n + 1, max(longest, ms))

    thresholds = gc.get_threshold()
    gc.collect()
    gc.freeze()
    gc.set_threshold(thresholds[0], thresholds[1], 1_000_000)
    gc.callbacks.append(timed)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(timed)
        gc.set_threshold(*thresholds)
        gc.unfreeze()


def _run_replicas(url, streams, clock, **kw):
    """Replicas of ``_replica_thread``, one thread each, joined."""
    import threading

    outs = [{} for _ in streams]
    threads = [threading.Thread(target=_replica_thread,
                                args=(url, users, clock, out), kwargs=kw,
                                name=f"replica-{i}")
               for i, (users, out) in enumerate(zip(streams, outs))]
    for th in threads:
        th.start()
    return threads, outs


def _admitted_total(outs):
    total = {}
    for out in outs:
        for key, n in out.get("admitted", {}).items():
            total[key] = total.get(key, 0) + n
    return total


def _feed_oracle(oracle, limits, admitted):
    """Apply the replicas' admitted hits to ``oracle`` as the deltas they
    flushed."""
    from limitador_tpu_torch import Counter

    by_name = {limit.name: limit for limit in limits}
    items = [(Counter(by_name[name], {"u": user}), n)
             for (name, user), n in sorted(admitted.items())]
    for lo in range(0, len(items), 4096):
        oracle.apply_deltas(items[lo:lo + 4096])


def _table_differences(table, oracle, limits):
    """Counters of ``table`` that differ from ``oracle``'s, by (limit
    name, user): remaining and expires_in."""
    def rows(storage):
        return {(c.limit.name, c.set_variables["u"]):
                (c.remaining, c.expires_in)
                for c in storage.get_counters(set(limits))}

    got, want = rows(table), rows(oracle)
    return [(k, got.get(k), want.get(k)) for k in sorted(got.keys()
                                                         | want.keys())
            if got.get(k) != want.get(k)], len(got)


def _rpc_summary(outs):
    """Per replica: flushes sent, the largest, the slowest (ms) and how
    many took 350 ms or more (client side, RemoteAuthority)."""
    return [{"rpcs": len(out.get("rpcs", ())),
             "largest": max((n for n, _s in out.get("rpcs", ())), default=0),
             "slowest_ms": max((s for _n, s in out.get("rpcs", ())),
                               default=0.0) * 1e3,
             "over_timeout": sum(s >= 0.35 for _n, s in out.get("rpcs", ())),
             "flags": out.get("flags")} for out in outs]


def _check_replicas(label, outs, *, partitioned_ok=False):
    print(f"{label}: replicas' flushes: {json.dumps(_rpc_summary(outs))}")
    for i, out in enumerate(outs):
        if "raised" in out:
            fail(f"{label}: replica {i} raised {out['raised']}")
        if out["errors"]:
            fail(f"{label}: replica {i}: {out['errors']} decisions failed")
        if out["flush_errors"]:
            fail(f"{label}: replica {i}: {out['flush_errors']} flush "
                 f"errors")
        if out["left"] or out["partitioned"]:
            fail(f"{label}: replica {i} ended with {out['left']} pending "
                 f"counters, partitioned {out['partitioned']}")
        if not partitioned_ok and out["flags"]:
            fail(f"{label}: replica {i} was partitioned: {out['flags']}")


def _overadmission(admitted, max_value):
    """Hits admitted past the limit by the replicas together, and the
    users over it."""
    over = [n - max_value for n in admitted.values() if n > max_value]
    return sum(over), len(over)


def _authority_drive(dev, card, label, table, streams, limits, max_value,
                     big=None):
    """Serve ``table`` as the shared authority on 127.0.0.1:0 (warmed),
    run a replica for each of ``streams`` (and then, with ``big``, one
    more with batch size 4096 over ``big`` distinct users, one flush),
    and hold the table against an InMemoryStorage fed the admitted hits.
    Returns (launches, record)."""
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.parallel import mesh as M
    from limitador_tpu_torch.storage.authority import AuthorityServer
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    clock = table._clock
    t0 = time.perf_counter()
    server = AuthorityServer(table, "127.0.0.1:0").start()
    warm_s = time.perf_counter() - t0
    url = f"127.0.0.1:{server.port}"
    K.reset_launches()
    update, sharded_update = K.update_host, M.sharded_update_host
    sizes = []

    def tally(fn):
        def launch(ctx, entries, now_ms):
            sizes.append(int(entries.shape[0]))
            return fn(ctx, entries, now_ms)
        return launch

    K.update_host = tally(update)
    M.sharded_update_host = tally(sharded_update)
    try:
        with _frozen_heap() as pauses:
            t1 = time.perf_counter()
            threads, outs = _run_replicas(url, streams, clock)
            for th in threads:
                th.join()
            seconds = time.perf_counter() - t1
            big_out = None
            if big is not None:
                threads, (big_out,) = _run_replicas(
                    url, [big], clock, batch_size=4096, yield_every=None,
                    rate=None)
                threads[0].join()
    finally:
        K.update_host, M.sharded_update_host = update, sharded_update
    stats = server.stats()
    server.stop()
    launches = dict(K.launches)
    print(f"{label}: authority stats {json.dumps(stats)}; collections "
          f"in the drive by generation (count, longest ms): "
          f"{json.dumps(pauses)}")
    _check_replicas(label, outs + ([big_out] if big_out else []))
    admitted = _admitted_total(outs + ([big_out] if big_out else []))
    oracle = InMemoryStorage(cache_size=1 << 22, clock=clock)
    _feed_oracle(oracle, limits, admitted)
    differ, n_counters = _table_differences(table, oracle, limits)
    over, users_over = _overadmission(admitted, max_value)
    overshoot = sum(out["overshoot"] for out in outs)
    decisions = sum(len(s) for s in streams)
    rpcs = max(stats["apply_deltas"], 1)
    per_rpc = {k: v / rpcs for k, v in stats["ms"].items()}
    staged = [n for n in sizes if n > 2000]
    print(f"{label}: {len(streams)} replicas decided {decisions} requests "
          f"in {seconds:.2f}s ({decisions / seconds:.0f}/s; "
          f"{card}); the authority served {stats['apply_deltas']} "
          f"ApplyDeltas RPCs of {stats['items']} counters (warm-up "
          f"{warm_s * 1e3:.1f} ms before serving); per RPC, ms: "
          f"{json.dumps({k: round(v, 4) for k, v in per_rpc.items()})}; "
          f"B2/B7c host-form calls {len(sizes)} (largest {max(sizes or [0])}"
          f" entries, {len(staged)} past 2,000: the staged route)")
    print(f"{label}: {n_counters} counters; {len(differ)} differ from the "
          f"oracle; over-admission {over} hits on {users_over} users (the "
          f"topology's bound, recorded), replicas' counter_overshoot "
          f"{overshoot}")
    print(f"{label} launches: {json.dumps(launches)}")
    if differ:
        fail(f"{label}: {len(differ)} counters differ from the oracle: "
             f"{differ[:3]}")
    if stats["errors"]:
        fail(f"{label}: {stats['errors']} authority RPCs failed")
    return launches, {
        "decisions": decisions, "seconds": seconds,
        "rpcs": stats["apply_deltas"], "items": stats["items"],
        "rpc_ms": per_rpc, "warm_ms": warm_s * 1e3, "counters": n_counters,
        "overadmission": over, "users_over": users_over,
        "counter_overshoot": overshoot, "update_calls": len(sizes),
        "gc_pauses": pauses, "slowest_rpc_ms": stats["slowest_ms"],
        "largest_update": max(sizes or [0]), "staged_calls": len(staged),
    }


def _zipf_users(n, seed):
    rng = np.random.default_rng(seed)
    return [f"u{k}" for k in zipf_keys(C, n, 0.99, rng).tolist()]


def _partition_drive(dev, card, table):
    """Phase 14b on the table of 14a: two replicas decide, the authority
    stops half way and the replicas decide the other half against no
    authority (their flushes fail: partitioned), a new AuthorityServer
    over the same table binds the same port, the held deltas arrive and
    the table equals the oracle (every hit of 14a and 14b). Then
    DeleteCounters on the second limit (B3b's host form) and Clear."""
    import threading

    from limitador_tpu_torch import Limit
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.storage.authority import AuthorityServer

    label = "authority partition (14b)"
    clock = table._clock
    limits = [Limit("ns", 100, 60, [], ["u"], name="per-user"),
              Limit("ns2", 1000, 60, [], ["u"], name="per-user-2")]
    server = AuthorityServer(table, "127.0.0.1:0").start()
    port = server.port
    url = f"127.0.0.1:{port}"
    K.reset_launches()
    users = _zipf_users(PARTITION_REQUESTS, 1414)
    gates = [[threading.Event() for _ in range(4)] for _ in range(2)]
    outs = [{}, {}]
    threads = [threading.Thread(
        target=_replica_thread, args=(url, users[i::2], clock, outs[i]),
        kwargs={"gates": gates[i], "limits": limits}, name=f"partition-{i}")
        for i in range(2)]
    t0 = time.perf_counter()
    frozen = _frozen_heap()
    pauses = frozen.__enter__()
    for th in threads:
        th.start()
    for g in gates:
        if not g[0].wait(120):
            fail(f"{label}: a replica never reached half way")
    # a grace period lets an RPC in flight answer: cancelled after the
    # authority applied it, its deltas would be sent again (the replica
    # cannot tell), and counted twice
    server.stop(grace=5.0)
    down_at = time.perf_counter()
    for g in gates:
        g[1].set()
    for g in gates:
        if not g[2].wait(120):
            fail(f"{label}: a replica never flushed against the stopped "
                 f"authority")
    down_s = time.perf_counter() - down_at
    try:
        server = AuthorityServer(table, url).start()
    except Exception:
        time.sleep(0.5)
        server = AuthorityServer(table, url).start()
    for g in gates:
        g[3].set()
    for th in threads:
        th.join()
    frozen.__exit__(None, None, None)
    seconds = time.perf_counter() - t0
    for i, out in enumerate(outs):
        if not out.get("partitioned_after_down") or \
                out.get("flags", [])[:1] != [True] or \
                out["flags"][-1] is not False:
            fail(f"{label}: replica {i}: partition flags "
                 f"{out.get('flags')}, partitioned after the stop "
                 f"{out.get('partitioned_after_down')}")
    _check_replicas(label, outs, partitioned_ok=True)
    admitted = _admitted_total(outs)
    return server, limits, admitted, {
        "decisions": PARTITION_REQUESTS, "seconds": seconds,
        "down_s": down_s, "flags": [out["flags"] for out in outs],
        "gc_pauses": pauses,
    }, label


def phase_authority(dev, card):
    """Phase 14 (a) and (b): the shared authority on the card, in this
    process. Returns (launches of 14a and 14b, results)."""
    from limitador_tpu_torch import Counter, Limit
    from limitador_tpu_torch.device import TorchStorage
    from limitador_tpu_torch.device.sharded import TorchShardedStorage
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.storage.authority import RemoteAuthority
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    limit = Limit("ns", 100, 60, [], ["u"], name="per-user")
    clock = ManualClock()
    table = TorchStorage(capacity=C, clock=clock, device=dev)
    users = _zipf_users(AUTH_REQUESTS + AUTH_BIG_FLUSH * 8, 1400)
    streams = [users[i:AUTH_REQUESTS:AUTH_REPLICAS]
               for i in range(AUTH_REPLICAS)]
    seen = set(users[:AUTH_REQUESTS])
    big = []
    for u in users[AUTH_REQUESTS:]:
        if u not in seen and len(big) < AUTH_BIG_FLUSH:
            seen.add(u)
            big.append(u)
    launches_a, torch_rec = _authority_drive(
        dev, card, "shared authority (14a, torch)", table, streams,
        [limit], 100, big=big)
    if torch_rec["staged_calls"] == 0:
        fail("shared authority (14a, torch): no B2 call past 2,000 entries")
    _no_checks(launches_a, "shared authority (14a, torch)")
    _storage_forms(launches_a, "shared authority (14a, torch)",
                   ("update_host", "read_slots_host"))
    sharded = TorchShardedStorage(n_shards=SHARDS, local_capacity=LOCAL_CAP,
                                  global_region=GLOBAL_REGION, clock=clock,
                                  device=dev)
    users = _zipf_users(AUTH_SHARDED_REQUESTS, 1401)
    launches_s, sharded_rec = _authority_drive(
        dev, card, "shared authority (14a, sharded)", sharded,
        [users[0::2], users[1::2]], [limit], 100)
    sharded.close()
    _no_checks(launches_s, "shared authority (14a, sharded)")
    _storage_forms(launches_s, "shared authority (14a, sharded)",
                   ("sharded_update_host", "read_slots_host"))
    # (b): the partition, on the table of (a); the oracle starts from
    # the table's counters after (a), which were held equal to (a)'s
    oracle = InMemoryStorage(cache_size=1 << 22, clock=clock)
    base = [(Counter(limit, dict(c.set_variables)),
             c.limit.max_value - c.remaining)
            for c in table.get_counters({limit})]
    for lo in range(0, len(base), 4096):
        oracle.apply_deltas(base[lo:lo + 4096])
    server, limits, admitted_b, part_rec, label = _partition_drive(
        dev, card, table)
    _feed_oracle(oracle, limits, admitted_b)
    differ, n_counters = _table_differences(table, oracle, limits)
    remote = RemoteAuthority(f"127.0.0.1:{server.port}", timeout=30)
    try:
        before_clears = K.launches["clear_slots_host"]
        remote.delete_counters({limits[1]})
        cleared = K.launches["clear_slots_host"] - before_clears
        left_2 = len(table.get_counters({limits[1]}))
        kept = len(table.get_counters({limits[0]}))
        remote.clear()
        after_clear = len(table.get_counters(set(limits)))
    finally:
        remote.close()
        server.stop()
    launches_b = dict(K.launches)
    table.close()
    print(f"{label}: 2 replicas decided {PARTITION_REQUESTS} requests on "
          f"two limits in {part_rec['seconds']:.2f}s, the authority down "
          f"{part_rec['down_s']:.2f}s; partition flags "
          f"{json.dumps(part_rec['flags'])}; after recovery {n_counters} "
          f"counters, {len(differ)} differ from the oracle; DeleteCounters "
          f"on per-user-2: {cleared} B3b host-form launches, {left_2} of "
          f"its counters left, {kept} of per-user kept; Clear left "
          f"{after_clear}; collections in the drive by generation (count, "
          f"longest ms): {json.dumps(part_rec['gc_pauses'])}")
    print(f"{label} launches: {json.dumps(launches_b)}")
    if differ:
        fail(f"{label}: {len(differ)} counters differ from the oracle "
             f"after recovery: {differ[:3]}")
    if cleared == 0 or left_2 or not kept or after_clear:
        fail(f"{label}: DeleteCounters launched {cleared} clears and left "
             f"{left_2}; per-user kept {kept}; Clear left {after_clear}")
    _no_checks(launches_b, label)
    _storage_forms(launches_b, label, ("update_host", "read_slots_host",
                                       "clear_slots_host"))
    part_rec.update(counters=n_counters, cleared=cleared, kept=kept)
    launches = {k: launches_a[k] + launches_s[k] + launches_b[k]
                for k in launches_a}
    return launches, {"torch": torch_rec, "sharded": sharded_rec,
                      "partition": part_rec}


def _no_checks(launches, label):
    checks = [k for k in ("check_and_update", "check_and_update_cluster",
                          "replicated_check", "replicated_check_cluster",
                          "sharded_check_and_update",
                          "sharded_check_and_update_cluster")
              if launches[k]]
    if checks:
        fail(f"{label}: the authority launched check kernels: {checks}")


def _spawn_server(tmpdir, name, argv, http):
    """A server process of the port (``python -m
    limitador_tpu_torch.server``), its log in ``tmpdir``."""
    log = open(os.path.join(tmpdir, f"{name}.log"), "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "limitador_tpu_torch.server", *argv,
         "--rls-host", "127.0.0.1", "--rls-port", str(_free_ports(1)[0]),
         "--http-host", "127.0.0.1", "--http-port", str(http),
         "--flight-spool-dir", os.path.join(tmpdir, f"flight-{name}")],
        stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": os.getcwd()})
    return proc, log


def _wait_up(proc, port, name, tmpdir, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            with open(os.path.join(tmpdir, f"{name}.log")) as f:
                fail(f"served authority (14c): {name} exited "
                     f"{proc.returncode}: {f.read()[-2000:]}")
        try:
            status, _body = _http_get(port, "/status")
            if status == 200:
                return
        except OSError:
            pass
        time.sleep(0.2)
    fail(f"served authority (14c): {name} never answered /status")


async def _served_authority(tmpdir, dev, card, calls=SERVED_AUTH_CALLS,
                            users=600):
    """Phase 14c: an authority process (torch on the card,
    --authority-listen), two cached replica processes (--authority-url,
    the defaults), 1,000 HTTP /check_and_report calls to each over 600
    Zipf-0.99 users (phase 13a's), each admitted hit reported to an
    in-process memory server; the authority's /counters/ns must equal
    the memory server's within 10 s after the replicas' 1 s flush."""
    import http.client

    from limitador_tpu_torch.server import __main__ as server

    label = "served authority (14c)"
    limits = os.path.join(tmpdir, "auth.yaml")
    with open(limits, "w") as f:
        f.write(AUTH_LIMITS_YAML)
    auth_port, auth_http, *replica_http = _free_ports(4)
    procs = []
    try:
        procs.append(_spawn_server(tmpdir, "authority", [
            limits, "torch", "--device", dev.type, "--capacity", str(C),
            "--authority-listen", f"127.0.0.1:{auth_port}"], auth_http))
        for i, port in enumerate(replica_http):
            procs.append(_spawn_server(tmpdir, f"replica{i}", [
                limits, "cached", "--authority-url",
                f"127.0.0.1:{auth_port}"], port))
        for (proc, _log), name, port in zip(
                procs, ["authority", "replica0", "replica1"],
                [auth_http] + replica_http):
            _wait_up(proc, port, name, tmpdir)
        http_opts, mem_http = _http_options()
        memory = await server.start(server.build_parser().parse_args(
            [limits, "memory", "--rls-host", "127.0.0.1", "--rls-port",
             str(_free_ports(1)[0]), *http_opts]))
        try:
            rng = np.random.default_rng(1313)
            keys = zipf_keys(users, 2 * calls, 0.99, rng).tolist()
            conns = [http.client.HTTPConnection("127.0.0.1", p, timeout=60)
                     for p in replica_http + [mem_http]]
            lat = [[], []]
            statuses = {}

            def drive():
                headers = {"Content-Type": "application/json"}
                for i, user in enumerate(keys):
                    r = i % 2
                    body = json.dumps({"namespace": "ns",
                                       "values": {"u": f"u{user}"},
                                       "delta": 1})
                    t0 = time.perf_counter()
                    conns[r].request("POST", "/check_and_report", body,
                                     headers)
                    resp = conns[r].getresponse()
                    resp.read()
                    lat[r].append(time.perf_counter() - t0)
                    statuses[resp.status] = statuses.get(resp.status, 0) + 1
                    if resp.status == 200:
                        conns[2].request("POST", "/report", body, headers)
                        report = conns[2].getresponse()
                        report.read()
                        if report.status != 200:
                            fail(f"{label}: the memory server's /report "
                                 f"answered {report.status}")

            loop = asyncio.get_running_loop()
            t0 = time.perf_counter()
            await loop.run_in_executor(None, drive)
            seconds = time.perf_counter() - t0
            for conn in conns:
                conn.close()
            want = json.loads(await _served_get(mem_http, "/counters/ns"))
            deadline = time.monotonic() + 1.0 + 10.0
            while True:
                got = json.loads(await _served_get(auth_http,
                                                   "/counters/ns"))
                # the authority opens a window at the flush that carried
                # its first hit, up to one flush period (1 s) after the
                # memory server's report
                differ = _counters_differ(got, want, seconds=2)
                if not differ or time.monotonic() > deadline:
                    break
                await asyncio.sleep(0.25)
            waited = time.monotonic() - (deadline - 11.0)
            families = [await _served_metrics(p) for p in replica_http]
            stats = json.loads(await _served_get(auth_http, "/debug/stats"))
        finally:
            await memory.stop()
    finally:
        for proc, _log in procs:
            proc.terminate()
        for proc, log in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()
    auth = stats["authority"]
    rpcs = max(auth["apply_deltas"], 1)
    per_rpc = {k: v / rpcs for k, v in auth["ms"].items()}
    p = [{"p50": float(np.percentile(np.asarray(v) * 1e3, 50)),
          "p99": float(np.percentile(np.asarray(v) * 1e3, 99))}
         for v in lat]
    partitioned = [_metric(f, "datastore_partitioned") for f in families]
    flush_share = [_histogram(f, "datastore_latency") for f in families]
    print(f"{label}: {2 * calls} calls to two cached replica processes in "
          f"{seconds:.2f}s, statuses {json.dumps(statuses)}; the "
          f"authority process (torch on {dev.type}) equal to the memory "
          f"server after {waited:.2f}s: {len(differ)} of {len(got)} "
          f"counters differ")
    for i, q in enumerate(p):
        print(f"{label} replica {i} /check_and_report latency ({card}): "
              f"p50 {q['p50']:.3f} ms, p99 {q['p99']:.3f} ms over {calls} "
              f"(decided on the replica's host cache: these decisions "
              f"never touch the card)")
    print(f"{label}: the authority served {auth['apply_deltas']} "
          f"ApplyDeltas RPCs of {auth['items']} counters; per RPC, ms: "
          f"{json.dumps({k: round(v, 4) for k, v in per_rpc.items()})} "
          f"(apply = B2's host form and B3a's read)")
    print(f"{label}: replicas' datastore_partitioned {partitioned}; "
          f"datastore_latency (the flush_batcher_and_update_counters "
          f"aggregate) {json.dumps(flush_share)}")
    if differ or not got:
        fail(f"{label}: {len(differ)} of /counters/ns differ from the "
             f"memory server's: {differ[:3]}")
    if any(partitioned) or any(s["count"] == 0 for s in flush_share):
        fail(f"{label}: replicas partitioned {partitioned} or no flush "
             f"aggregate in datastore_latency")
    for f in families:
        for name in ("counter_overshoot", "evicted_pending_writes"):
            if name not in f:
                fail(f"{label}: a replica's /metrics lacks {name}")
    if auth["errors"] or auth["apply_deltas"] == 0:
        fail(f"{label}: the authority served {auth['apply_deltas']} RPCs "
             f"with {auth['errors']} errors")
    return {"seconds": seconds, "statuses": statuses, "latency_ms": p,
            "rpc_ms": per_rpc, "rpcs": auth["apply_deltas"],
            "items": auth["items"], "waited_s": waited,
            "datastore_latency": flush_share,
            "overshoot": [_metric(f, "counter_overshoot") for f in families]}


def _expired_reset(got, want):
    """Two answers that differ only where a counter's window has expired:
    the memory server's X-RateLimit-Reset reads 0 (the dead window's
    ttl), the disk and distributed storages' the whole window they open
    (their JAX counterparts do the same; ROADMAP Queue C)."""
    (gs, gh, gb), (ws, wh, wb) = got, want
    if (gs, gb) != (ws, wb) or [k for k, _v in gh] != [k for k, _v in wh]:
        return False
    return all(g == w or (k.lower() == "x-ratelimit-reset" and w == "0"
                          and int(g) > 0)
               for (k, g), (_k, w) in zip(gh, wh))


async def _host_storages(tmpdir, dev, card, calls=HOST_CALLS):
    """Phase 14d: phase 11's sequence (its first ``calls`` calls, the
    reload half way, the 61 s step at three quarters) to a disk server
    and a distributed node beside a memory server, on one frozen clock;
    a second distributed node (gossip over real brokers) must show the
    first's counters; a cached server over its default disk authority
    takes the same calls beside a second memory server with the reloaded
    limits throughout (cached storage refuses token buckets). Every
    answer equal to its memory server's (X-RateLimit-Reset within 1 s,
    and ``_expired_reset`` counted apart)."""
    import http.client

    from limitador_tpu_torch.server import __main__ as server

    label = "host storages (14d)"
    limits = os.path.join(tmpdir, "host.yaml")
    with open(limits, "w") as f:
        f.write(HTTP_YAML)
    plain = os.path.join(tmpdir, "plain.yaml")
    with open(plain, "w") as f:
        f.write(HTTP_RELOADED_YAML)
    parse = server.build_parser().parse_args
    clock = ManualClock()
    failures = []
    common = ["--rls-host", "127.0.0.1", "--limit-name-in-labels",
              "--metric-labels", HTTP_LABELS]
    g0, g1 = _free_ports(2)
    specs = (
        ("memory", limits, ["memory"]),
        ("disk", limits, ["disk", "--disk-path",
                          os.path.join(tmpdir, "disk.db")]),
        ("distributed", limits, ["distributed", "--node-id", "d0",
                                 "--listen-address", f"127.0.0.1:{g0}",
                                 "--peer", f"127.0.0.1:{g1}"]),
        ("distributed-peer", limits, [
            "distributed", "--node-id", "d1", "--listen-address",
            f"127.0.0.1:{g1}", "--peer", f"127.0.0.1:{g0}"]),
        ("memory-plain", plain, ["memory"]),
        ("cached", plain, ["cached", "--disk-path",
                           os.path.join(tmpdir, "cached.db")]),
    )
    plan, _tally = _http_plan(calls)
    ports, servers = {}, {}
    try:
        for name, path, argv in specs:
            http_opts, ports[name] = _http_options()
            servers[name] = await server.start(parse(
                [path, *argv, *common, *http_opts, "--rls-port",
                 str(_free_ports(1)[0])]), clock=clock,
                on_failure=failures.append)
        groups = (("memory", "disk", "distributed"),
                  ("memory-plain", "cached"))
        conns = {name: http.client.HTTPConnection("127.0.0.1", ports[name],
                                                  timeout=60)
                 for group in groups for name in group}
        loop = asyncio.get_running_loop()
        lat = {}
        answers = {group: [] for group in groups}
        t0 = time.perf_counter()
        for lo, hi in ((0, calls // 2), (calls // 2, calls)):
            if lo:
                with open(limits, "w") as f:
                    f.write(HTTP_RELOADED_YAML)
                st = os.stat(limits)
                os.utime(limits, ns=(st.st_atime_ns,
                                     st.st_mtime_ns + 10**9))
                deadline = time.monotonic() + 20
                while any(len(servers[n].limiter.get_limits("web")) != 1
                          for n in ("memory", "disk", "distributed",
                                    "distributed-peer")):
                    if time.monotonic() > deadline:
                        fail(f"{label}: reload not applied within 20 s")
                    await asyncio.sleep(0.05)
            for i in range(lo, hi):
                if i == 3 * calls // 4:
                    # the write-behind deltas reach the authority in their
                    # own window before the clock leaves it (one flushed
                    # later counts in the authority's window of that
                    # moment: the topology's contract)
                    await servers["cached"].limiter.storage.counters.flush()
                clock.now += 61.0 if i == 3 * calls // 4 else 0.005
                for group in groups:
                    answers[group] += await loop.run_in_executor(
                        None, _http_calls, [conns[n] for n in group],
                        plan[i:i + 1], lat)
        seconds = time.perf_counter() - t0
        for conn in conns.values():
            conn.close()
        mismatches, expired = {}, {}
        for group in groups:
            for j, name in enumerate(group[1:], start=1):
                pairs = [(i, per[j], per[0])
                         for i, per in enumerate(answers[group])
                         if not _same_http_answer(per[j], per[0])]
                expired[name] = sum(_expired_reset(g, w)
                                    for _i, g, w in pairs)
                mismatches[name] = [i for i, g, w in pairs
                                    if not _expired_reset(g, w)]
        counters = {name: json.loads(await _served_get(ports[name],
                                                       "/counters/web"))
                    for name in servers}
        deadline = time.monotonic() + 10
        while True:
            peer = json.loads(await _served_get(ports["distributed-peer"],
                                                "/counters/web"))
            converged = not _counters_differ(peer, counters["distributed"])
            if converged or time.monotonic() > deadline:
                break
            await asyncio.sleep(0.1)
    finally:
        for srv in servers.values():
            await srv.stop()
    print(f"{label}: {calls} calls of phase 11's sequence to disk, "
          f"distributed and (without the bucket) cached servers in "
          f"{seconds:.2f}s; answers differing from the memory server's: "
          f"{json.dumps({k: len(v) for k, v in mismatches.items()})}, and "
          f"only in X-RateLimit-Reset on an expired window (the memory "
          f"server reads 0, disk and distributed the whole window, as in "
          f"the JAX package): {json.dumps(expired)}; the distributed "
          f"peer's /counters/web converged: {converged}")
    if failures:
        fail(f"{label}: a background tier failed: {failures!r}")
    for name, bad in mismatches.items():
        if bad:
            group = next(g for g in groups if name in g)
            i = bad[0]
            fail(f"{label}: {name} call {i} {plan[i]}: "
                 f"{answers[group][i][group.index(name)]} != "
                 f"{answers[group][i][0]}")
    for name, ref in (("disk", "memory"), ("distributed", "memory"),
                      ("cached", "memory-plain")):
        differ = _counters_differ(counters[name], counters[ref])
        if differ or not counters[name]:
            fail(f"{label}: {name}'s /counters/web differs from the memory "
                 f"server's: {differ[:3]}")
    if not converged:
        fail(f"{label}: the distributed peer never showed the node's "
             f"counters")
    return {"seconds": seconds, "calls": calls, "expired_resets": expired,
            "counters": {k: len(v) for k, v in counters.items()}}


def phase_host_storages(dev, card):
    """Phase 14: (a) and (b) the shared authority on the card, (c) served
    as operators deploy it, (d) the host storages. Returns (launches of
    14a and 14b, results)."""
    t0 = time.perf_counter()
    launches, authority = phase_authority(dev, card)
    with tempfile.TemporaryDirectory() as tmpdir:
        served = asyncio.run(_served_authority(tmpdir, dev, card))
    with tempfile.TemporaryDirectory() as tmpdir:
        host = asyncio.run(_host_storages(tmpdir, dev, card))
    print(f"host storages and the shared authority (14): "
          f"{time.perf_counter() - t0:.2f}s; launches "
          f"{json.dumps(launches)}")
    return launches, {"authority": authority, "served": served,
                      "host": host, "card": card}


# -- phase 15: the admission plane -------------------------------------------

# 15b and 15c: a large per-user budget (never limited here) and a tight
# one the failover window fills
ADMISSION_YAML = """\
- namespace: bulk
  max_value: 1000000
  seconds: 3600
  variables: ["descriptors[0].u"]
  name: bulk
- namespace: tight
  max_value: 120
  seconds: 3600
  variables: ["descriptors[0].u"]
  name: tight
"""
FAILOVER_LOAD = 64
FAILOVER_CALLS = 300
SHED_CONCURRENCY = 64
SHED_SHORT = 16


def _hangable(base):
    """``base`` (a device storage) whose collect step can be wedged at
    the Python level, before its download: ``finish_check_many`` (the
    batchers') and ``finish_check_columnar`` (the native pipeline's) wait
    on a gate. The card itself is never touched, so later phases keep a
    healthy context."""
    import threading

    class Hangable(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._gate = threading.Event()
            self._gate.set()

        def hang(self):
            self._gate.clear()

        def unhang(self):
            self._gate.set()

        def finish_check_many(self, handle):
            self._gate.wait()
            return super().finish_check_many(handle)

        def finish_check_columnar(self, *args, **kwargs):
            self._gate.wait()
            return super().finish_check_columnar(*args, **kwargs)

    return Hangable


async def _admission_cost(tmpdir, dev, card, native, rounds=150):
    """Phase 15a: a phase-4 (or, with ``native``, phase-6) server with
    ``--admission-mode enforce`` and the JAX defaults beside one with
    ``off``, in this process on one frozen clock: the phase's calls (the
    hot reload and the 13-day step included), then ``rounds`` rounds of
    one call to each, the order alternating by call. Answers and final
    counters must be byte-equal, the breaker closed with no transition,
    no failover decision and no shed, and the ``off`` server must hold no
    controller; p50/p99 of each side and the per-round difference are
    records."""
    import grpc

    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.proto import rls_pb2

    label = f"admission on/off (15a, {'native' if native else 'standard'})"
    extra_yaml = NATIVE_NS_YAML if native else ""
    limits = os.path.join(tmpdir, "limits.yaml")
    with open(limits, "w") as f:
        f.write(LIMITS_YAML + extra_yaml)
    options = ["--rls-host", "127.0.0.1", "--rate-limit-headers",
               "NONE" if native else "DRAFT_VERSION_03", "--device", dev.type]
    if native:
        options += ["--pipeline", "native", "--native-hot-lane", "on",
                    "--lease-mode", "off"]
    parse = server.build_parser().parse_args
    clock = ManualClock()
    ports = dict(zip("EO", _free_ports(2)))
    http = {}
    servers = {}
    failures = []
    try:
        for side, mode in (("E", "enforce"), ("O", "off")):
            http_options, http[side] = _http_options()
            servers[side] = await server.start(parse(
                [limits, "torch", *options, *http_options,
                 "--rls-port", str(ports[side]),
                 "--flight-spool-dir", os.path.join(tmpdir, f"spool{side}"),
                 "--admission-mode", mode]),
                clock=clock, on_failure=failures.append)
        off_has_plane = servers["O"].admission is not None or getattr(
            servers["O"].limiter.storage.counters, "admission") is not None
        envoy = "/envoy.service.ratelimit.v3.RateLimitService/" \
            "ShouldRateLimit"
        steps = (_native_steps(rls_pb2) if native
                 else _main_path_steps(rls_pb2))
        lat = {side: [] for side in servers}
        mismatches = 0
        channels = {side: grpc.aio.insecure_channel(f"127.0.0.1:{port}")
                    for side, port in ports.items()}
        try:
            for i, (rpc, blob, advance, reload) in enumerate(steps):
                clock.now += advance
                if reload:
                    with open(limits, "w") as f:
                        f.write(RELOADED_YAML + extra_yaml)
                    st = os.stat(limits)
                    os.utime(limits, ns=(st.st_atime_ns,
                                         st.st_mtime_ns + 10**9))
                    deadline = time.monotonic() + 20
                    while any(s.status["limits_file_version"] < 2
                              or len(s.limiter.get_limits("api")) != 2
                              for s in servers.values()):
                        if time.monotonic() > deadline:
                            fail(f"{label}: hot reload not applied")
                        await asyncio.sleep(0.05)
                got = {}
                for side in ("EO" if i % 2 == 0 else "OE"):
                    got[side] = await channels[side].unary_unary(rpc)(
                        blob, timeout=60)
                mismatches += got["E"] != got["O"]
            for i in range(rounds + 30):  # the first 30 rounds warm up
                blob = _lat_blob(rls_pb2, i, native)
                got = {}
                for side in ("EO" if i % 2 == 0 else "OE"):
                    t0 = time.perf_counter()
                    got[side] = await channels[side].unary_unary(envoy)(
                        blob, timeout=60)
                    if i >= 30:
                        lat[side].append(time.perf_counter() - t0)
                mismatches += got["E"] != got["O"]
        finally:
            for ch in channels.values():
                await ch.close()
        adm = servers["E"].admission
        debug = adm.admission_debug()
        families = await _served_metrics(http["E"])
        stats = json.loads(await _served_get(http["E"], "/debug/stats"))
        off_stats = json.loads(await _served_get(http["O"], "/debug/stats"))
        plane = {
            "state": adm.breaker.state,
            "transitions": _metric(families, "admission_breaker_transitions"),
            "failover_decisions": _metric(families,
                                          "admission_failover_decisions"),
            "sheds": _metric(families, "admission_sheds"),
            "debug_state": stats["admission"]["breaker"]["state"],
            "debug_decisions": stats["admission"]["failover"]["decisions"],
            "off_section": "admission" in off_stats,
        }
        final = {}
        for side, srv in servers.items():
            rows = {}
            for ns in ("api", "tb", "nat"):
                counters = srv.limiter.get_counters(ns)
                if asyncio.iscoroutine(counters):
                    counters = await counters
                for c in counters:
                    rows[(ns, c.limit.name,
                          tuple(c.set_variables.items()))] = (
                        c.remaining, c.expires_in)
            final[side] = rows
    finally:
        for srv in servers.values():
            await srv.stop()
    ms = {side: np.asarray(v) * 1e3 for side, v in lat.items()}
    diff = ms["E"] - ms["O"]
    out = {side: {"p50_ms": float(np.percentile(v, 50)),
                  "p99_ms": float(np.percentile(v, 99)),
                  "mean_ms": float(v.mean())} for side, v in ms.items()}
    out["minus_off_median_ms"] = float(np.median(diff))
    out["minus_off_mean_ms"] = float(diff.mean())
    out["slower_share"] = float((diff > 0).mean())
    out["calls"] = len(steps) + rounds + 30
    out["plane"] = plane
    print(f"{label}: {out['calls']} calls to each, enforce p50 "
          f"{out['E']['p50_ms']:.3f} / p99 {out['E']['p99_ms']:.3f} ms, "
          f"off p50 {out['O']['p50_ms']:.3f} / p99 "
          f"{out['O']['p99_ms']:.3f} ms over {rounds} rounds; on - off per "
          f"round median {out['minus_off_median_ms']:+.4f} ms, mean "
          f"{out['minus_off_mean_ms']:+.4f} ms, slower in "
          f"{out['slower_share']:.1%} of rounds; plane {json.dumps(plane)} "
          f"({card})")
    if failures:
        fail(f"{label}: a background tier failed: {failures[0]!r}")
    if mismatches or final["E"] != final["O"] or not final["E"]:
        fail(f"{label}: {mismatches} answers differ between the plane on "
             f"and off, or the counters do ({len(final['E'])} against "
             f"{len(final['O'])})")
    if (plane["state"] != "closed" or plane["debug_state"] != "closed"
            or plane["transitions"] or plane["failover_decisions"]
            or plane["debug_decisions"] or plane["sheds"]):
        fail(f"{label}: the plane left closed or decided on the host: "
             f"{plane}")
    if off_has_plane or plane["off_section"]:
        fail(f"{label}: --admission-mode off built a controller")
    print(f"{label}: every answer byte-equal, {len(final['E'])} counters "
          "equal, breaker closed, 0 failover decisions")
    return out


async def _failover_drill(dev, card, kind):
    """Phase 15b on ``kind``: 'torch' (AsyncTorchStorage), 'native' (the
    native pipeline, hot lane on) or 'sharded' (TorchShardedStorage, one
    row per card), over a ``_hangable`` table of 65,536 cells on the card.
    The breaker (stall 200 ms, reset 200 ms, watchdog 50 ms) watches 50
    calls, then the collect step hangs under a load of 64 concurrent
    calls: the stall trip fails the dispatched launches over (a transient
    error; their hits are on the table) and decides the queued requests
    on the host oracle; 300 calls more are decided on the oracle (150 on
    a fresh 120 budget: exactly 120 admitted). On unhang the probe
    launches the check kernel (B1, B7a on sharded) and the reconcile the
    update's host form (B2, B7c), the breaker closes, every counter of
    the table equals the hits admitted (by the card or the oracle) and
    ``admission_reconciled_deltas`` equals the journal's size."""
    import torch

    from limitador_tpu_torch import AsyncRateLimiter, Context, Limit
    from limitador_tpu_torch.admission import (
        AdmissionController,
        BreakerState,
        CircuitBreaker,
    )
    from limitador_tpu_torch.device.batcher import AsyncTorchStorage
    from limitador_tpu_torch.device.storage import TorchStorage
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server.proto import rls_pb2
    from limitador_tpu_torch.storage.base import StorageError

    label = f"failover drill (15b, {kind})"
    if kind == "sharded":
        from limitador_tpu_torch.device.sharded import TorchShardedStorage

        device = _hangable(TorchShardedStorage)(
            n_shards=torch.cuda.device_count() if dev.type == "cuda" else 1,
            local_capacity=1 << 16,
            global_region=64, device=dev)
        probe_keys = ("sharded_check_and_update",
                      "sharded_check_and_update_cluster")
        reconcile_key = "sharded_update_host"
    else:
        device = _hangable(TorchStorage)(capacity=1 << 16, device=dev)
        probe_keys = ("check_and_update", "check_and_update_cluster")
        reconcile_key = "update_host"
    storage = AsyncTorchStorage(device)
    limits = [Limit("bulk", 1_000_000, 3600, [], ["descriptors[0].u"],
                    name="bulk"),
              Limit("tight", 120, 3600, [], ["descriptors[0].u"],
                    name="tight")]
    pipeline = None
    if kind == "native":
        from limitador_tpu_torch.device.native_pipeline import (
            NativeRlsPipeline,
        )
        from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter

        limiter = CompiledTorchLimiter(storage)
    else:
        limiter = AsyncRateLimiter(storage)
    for limit in limits:
        limiter.add_limit(limit)
    if kind == "native":
        pipeline = NativeRlsPipeline(limiter, hot_lane=True)
    codes = {rls_pb2.RateLimitResponse.OK: "ok",
             rls_pb2.RateLimitResponse.OVER_LIMIT: "over"}
    admitted = {}  # (namespace, user) -> hits the card or the oracle took

    async def call(ns, user):
        try:
            if pipeline is not None:
                blob = _rls_request(rls_pb2, ns, [{"u": user}])
                out = codes[rls_pb2.RateLimitResponse.FromString(
                    await pipeline.submit(blob)).overall_code]
            else:
                ctx = Context()
                ctx.list_binding("descriptors", [{"u": user}])
                r = await limiter.check_rate_limited_and_update(ns, ctx, 1)
                out = "over" if r.limited else "ok"
        except StorageError:
            out = "error"  # rode a failed-over launch: its hit is counted
        if out != "over":
            admitted[(ns, user)] = admitted.get((ns, user), 0) + 1
        return out

    metrics = PrometheusMetrics()
    adm = AdmissionController(
        mode="enforce", metrics=metrics,
        breaker=CircuitBreaker(failure_threshold=3, stall_timeout=0.2,
                               reset_timeout=0.2),
        watchdog_tick=0.05)
    probes, reconciles, replayed = [], [], []

    def timed(fn, sink):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                sink.append(time.perf_counter() - t0)
        return run

    def replay(fn):
        def run(table):
            replayed.append(adm.failover.journal_size())
            return fn(table)
        return run

    adm._probe = timed(adm._probe, probes)
    adm.failover.reconcile_into = replay(timed(adm.failover.reconcile_into,
                                               reconciles))
    out = {}
    try:
        for i in range(20):  # unwatched: plans, hot lane
            await call("bulk", f"u{i % 10}")
        storage.set_admission(adm)
        if pipeline is not None:
            adm.add_drainable(limiter)
            adm.add_drainable(pipeline)
        adm.start()
        watched = [await call("bulk", f"u{i % 10}") for i in range(50)]
        if watched != ["ok"] * 50:
            fail(f"{label}: watched calls {watched}")
        t_hang = time.perf_counter()
        device.hang()

        async def staggered(i):
            await asyncio.sleep((0.0, 0.05, 0.1)[i % 3])
            return await call("bulk", f"u{i % 10}")

        load = await asyncio.wait_for(asyncio.gather(
            *[staggered(i) for i in range(FAILOVER_LOAD)]), timeout=20.0)
        out["settle_s"] = time.perf_counter() - t_hang
        if adm.breaker.state == BreakerState.CLOSED:
            fail(f"{label}: the stall did not trip the breaker")
        failed_over = [await call("tight" if i % 2 else "bulk",
                                  "t" if i % 2 else f"u{i % 10}")
                       for i in range(FAILOVER_CALLS)]
        tight = failed_over[1::2]
        journal = adm.failover.journal_size()
        decisions = adm.failover.decisions
        before = dict(K.launches)
        t_unhang = time.perf_counter()
        device.unhang()
        deadline = time.monotonic() + 20
        while adm.breaker.state != BreakerState.CLOSED:
            if time.monotonic() > deadline:
                fail(f"{label}: the breaker did not close: "
                     f"{adm.admission_debug()}")
            await asyncio.sleep(0.01)
        out["close_s"] = time.perf_counter() - t_unhang
        launched = {k: K.launches[k] - before.get(k, 0) for k in K.launches
                    if K.launches[k] != before.get(k, 0)}
        table = {}
        for c in device.get_counters(set(limits)):
            key = (str(c.limit.namespace), c.set_variables["descriptors[0].u"])
            table[key] = c.limit.max_value - c.remaining
        reconciled = _registry_total(metrics, "admission_reconciled_deltas")
        left = adm.failover.journal_size()
        oracle = dict(admitted)
        after = await call("bulk", "u0")
    finally:
        device.unhang()
        await adm.close()
        if pipeline is not None:
            await pipeline.close()
        if kind == "native":
            await limiter.close()
        await storage.close()
    out.update({
        "load": {k: load.count(k) for k in ("ok", "error", "over")},
        "failed_over": {k: failed_over.count(k)
                        for k in ("ok", "error", "over")},
        "tight_admitted": tight.count("ok"),
        "journal": journal, "decisions": decisions,
        "reconciled_deltas": reconciled, "replayed": replayed,
        "probe_ms": probes[-1] * 1e3 if probes else None,
        "probes": len(probes),
        "reconcile_ms": reconciles[-1] * 1e3 if reconciles else None,
        "launched_on_recovery": launched,
        "counters": len(table),
    })
    print(f"{label}: load {out['load']}, failed over "
          f"{out['failed_over']} (tight {out['tight_admitted']} of 150), "
          f"journal {journal}, reconciled {reconciled} ({replayed}); "
          f"settled "
          f"{out['settle_s']:.3f}s after the hang, closed "
          f"{out['close_s']:.3f}s after the unhang; probe "
          f"{out['probe_ms']:.3f} ms ({len(probes)} probes), reconcile "
          f"{out['reconcile_ms']:.3f} ms; launched on recovery "
          f"{json.dumps(launched)} ({card})")
    if out["load"]["over"] or not out["load"]["error"]:
        fail(f"{label}: the load's answers {out['load']}")
    if out["failed_over"]["error"] or out["tight_admitted"] != 120 \
            or tight[-1] != "over":
        fail(f"{label}: the failover window's answers {out['failed_over']},"
             f" tight admitted {out['tight_admitted']}")
    if table != oracle:
        bad = sorted(k for k in set(table) | set(oracle)
                     if table.get(k) != oracle.get(k))[:5]
        fail(f"{label}: the table differs from the oracle of admitted "
             f"hits at {[(k, table.get(k), oracle.get(k)) for k in bad]}")
    if reconciled != sum(replayed) or not journal or left \
            or replayed[0] < journal:
        fail(f"{label}: admission_reconciled_deltas {reconciled} against "
             f"the journal's sizes at each reconcile {replayed} (at the "
             f"unhang {journal}, left {left})")
    if not sum(launched.get(k, 0) for k in probe_keys) \
            or not launched.get(reconcile_key) or not reconciles:
        fail(f"{label}: the recovery launched {launched}; the probe needs "
             f"{probe_keys}, the reconcile {reconcile_key}")
    if after != "ok":
        fail(f"{label}: the card does not decide after the recovery")
    print(f"{label}: the table's {len(table)} counters equal the oracle "
          "of admitted hits")
    return out


async def _shed_drill(tmpdir, dev, card):
    """Phase 15c: a torch server on the card with ``--admission-mode
    enforce --max-inflight 4``: 64 concurrent ShouldRateLimit calls (10 s
    deadlines), then, with the queue-wait estimate forced near 1 s, 16
    calls with 250 ms deadlines (shed on arrival, so that the answer
    beats the deadline) and 8 calls with 10 s ones. Overload sheds
    and the 16 deadline sheds answer UNAVAILABLE and count in
    ``admission_sheds`` by reason; no shed is answered OK; the table's
    counters equal an oracle fed only the admitted calls."""
    import grpc

    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "shed drill (15c)"
    limits = os.path.join(tmpdir, "limits.yaml")
    with open(limits, "w") as f:
        f.write(ADMISSION_YAML)
    http_options, http_port = _http_options()
    (port,) = _free_ports(1)
    srv = await server.start(server.build_parser().parse_args(
        [limits, "torch", "--device", dev.type, "--rls-host", "127.0.0.1",
         "--rls-port", str(port), *http_options, "--admission-mode",
         "enforce", "--max-inflight", "4",
         "--flight-spool-dir", os.path.join(tmpdir, "spool")]))
    envoy = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
    answers = []
    ok_by_user = {}
    try:
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = ch.unary_unary(envoy)

            async def call(user, timeout, phase):
                blob = _rls_request(rls_pb2, "bulk", [{"u": user}])
                try:
                    out = rls_pb2.RateLimitResponse.FromString(
                        await stub(blob, timeout=timeout))
                    answer = rls_pb2.RateLimitResponse.Code.Name(
                        out.overall_code)
                except grpc.aio.AioRpcError as exc:
                    answer = exc.code().name
                    if "admission shed" in (exc.details() or ""):
                        answer += ":" + exc.details().split("(")[1].split(
                            ",")[0]
                if answer == "OK":
                    ok_by_user[user] = ok_by_user.get(user, 0) + 1
                answers.append((phase, user, answer))

            await call("warm", 10, "warm")
            await asyncio.gather(*[call(f"s{i}", 10, "burst")
                                   for i in range(SHED_CONCURRENCY)])
            for _ in range(20):  # the queue-wait estimate near 1 s
                srv.admission.overload.observe(1.0)
            await asyncio.gather(*[call(f"d{i}", 0.25, "short")
                                   for i in range(SHED_SHORT)])
            for i in range(8):
                await call(f"l{i}", 10, "long")
        families = await _served_metrics(http_port)
        stats = json.loads(await _served_get(http_port, "/debug/stats"))
        counters = await srv.limiter.get_counters("bulk")
        table = {c.set_variables["descriptors[0].u"]:
                 c.limit.max_value - c.remaining for c in counters}
        breaker = (srv.admission.breaker.state,
                   srv.admission.failover.decisions)
    finally:
        await srv.stop()
    sheds = {reason: _metric(families, "admission_sheds", reason=reason)
             for reason in ("overload", "deadline", "controller")}
    tally = {}
    for phase, _user, answer in answers:
        tally.setdefault(phase, {})
        tally[phase][answer] = tally[phase].get(answer, 0) + 1
    out = {"answers": tally, "sheds": sheds,
           "debug_sheds": stats["admission"]["sheds"],
           "counters": len(table), "breaker": breaker}
    print(f"{label}: answers {json.dumps(tally)}; admission_sheds "
          f"{json.dumps(sheds)}; /debug/stats sheds "
          f"{json.dumps(out['debug_sheds'])} ({card})")
    burst = tally.get("burst", {})
    if not burst.get("UNAVAILABLE:overload") or \
            sheds["overload"] != burst.get("UNAVAILABLE:overload"):
        fail(f"{label}: overload sheds {sheds} against the burst's "
             f"answers {burst}")
    if tally.get("short") != {"UNAVAILABLE:deadline": SHED_SHORT} or \
            sheds["deadline"] != SHED_SHORT:
        fail(f"{label}: deadline sheds {sheds} against the short calls' "
             f"answers {tally.get('short')}")
    if breaker != ("closed", 0):
        fail(f"{label}: breaker {breaker[0]} with {breaker[1]} failover "
             "decisions on a healthy card")
    if tally.get("long") != {"OK": 8} or tally.get("warm") != {"OK": 1}:
        fail(f"{label}: admitted calls answered {tally}")
    shed_total = sum(sheds.values())
    ok_total = sum(ok_by_user.values())
    if shed_total + ok_total != len(answers):
        fail(f"{label}: {shed_total} sheds + {ok_total} OK answers != "
             f"{len(answers)} calls")
    if table != ok_by_user:
        fail(f"{label}: the table's counters differ from the oracle of "
             f"admitted calls ({len(table)} against {len(ok_by_user)})")
    print(f"{label}: no shed answered OK; the table's {len(table)} counters "
          "equal the oracle of the admitted calls")
    return out


_COLD_START = r'''
import asyncio, json, sys, time
from pathlib import Path

from limitador_tpu_torch.native import build as host_build
from limitador_tpu_torch.ops import build
from limitador_tpu_torch.server import __main__ as m

build.BUILD_DIR = host_build.BUILD_DIR = Path(sys.argv[1])
warm = []
warm_device = m._warm_device


def timed_warm(storage):
    seconds = warm_device(storage)
    warm.append(seconds)
    return seconds


m._warm_device = timed_warm


async def main(argv):
    import grpc
    from limitador_tpu_torch.server.proto import rls_pb2

    t0 = time.perf_counter()
    server = await m.start(m.build_parser().parse_args(argv))
    started = time.perf_counter() - t0
    port = argv[argv.index("--rls-port") + 1]
    req = rls_pb2.RateLimitRequest(domain="bulk")
    req.descriptors.add().entries.add(key="u", value="cold")
    calls = []
    try:
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            for _ in range(3):
                t1 = time.perf_counter()
                out = await ch.unary_unary(
                    "/envoy.service.ratelimit.v3.RateLimitService/"
                    "ShouldRateLimit")(req.SerializeToString(), timeout=60)
                calls.append((time.perf_counter() - t1) * 1e3)
        adm = server.admission
        return {"start_s": started, "nvcc_s": build.build_info["seconds"],
                "nvcc_built": build.build_info["built"],
                "gxx_s": host_build.build_info.get("seconds"),
                "warm_s": warm[0], "calls_ms": calls,
                "code": rls_pb2.RateLimitResponse.FromString(
                    out).overall_code,
                "breaker": adm.breaker.state,
                "failover": adm.failover.decisions}
    finally:
        await server.stop()


print(json.dumps(asyncio.run(main(sys.argv[2:]))))
'''


def _cold_start(tmpdir, dev, card):
    """Phase 15d: a fresh process builds the kernels and the host lane
    into an empty directory and starts a torch server on the card with
    ``--admission-mode enforce`` (the server builds and launches the
    check kernel once before the breaker watches a batch): its start,
    nvcc and g++ seconds, the warm-up and the first three calls."""
    limits = os.path.join(tmpdir, "limits.yaml")
    with open(limits, "w") as f:
        f.write(ADMISSION_YAML)
    http_options, _port = _http_options()
    (port,) = _free_ports(1)
    argv = [sys.executable, "-c", _COLD_START, os.path.join(tmpdir, "build"),
            limits, "torch", "--device", dev.type, "--rls-host", "127.0.0.1",
            "--rls-port", str(port), *http_options, "--admission-mode",
            "enforce", "--flight-spool-dir", os.path.join(tmpdir, "spool")]
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here}
    proc = subprocess.run(argv, cwd=here, env=env, capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cold start (15d) exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"cold start (15d): server up in {out['start_s']:.2f}s (nvcc "
          f"{out['nvcc_s']:.2f}s, built={out['nvcc_built']}; g++ "
          f"{out['gxx_s']}s; warm-up launch {out['warm_s'] * 1e3:.3f} ms); "
          f"first calls {[round(c, 3) for c in out['calls_ms']]} ms, "
          f"breaker {out['breaker']} ({card})")
    if not out["nvcc_built"] or out["breaker"] != "closed" \
            or out["failover"] or out["code"] != 1:
        fail(f"cold start (15d): {out}")
    return out


def phase_admission(dev, card):
    """Phase 15: (a) the plane's served cost on phases 4 and 6, (b) the
    failover drill on torch, native and sharded, (c) the shed drill,
    (d) a cold start. Returns (launches of 15, results)."""
    from limitador_tpu_torch.ops import kernel as K

    t0 = time.perf_counter()
    K.reset_launches()
    cost = {}
    for native in (False, True):
        with tempfile.TemporaryDirectory() as tmpdir:
            cost["native" if native else "standard"] = asyncio.run(
                _admission_cost(tmpdir, dev, card, native))
    drills = {kind: asyncio.run(_failover_drill(dev, card, kind))
              for kind in ("torch", "native", "sharded")}
    with tempfile.TemporaryDirectory() as tmpdir:
        sheds = asyncio.run(_shed_drill(tmpdir, dev, card))
    launches = dict(K.launches)
    with tempfile.TemporaryDirectory() as tmpdir:
        cold = _cold_start(tmpdir, dev, card)
    _storage_forms(launches, "admission plane (15)",
                   ("update_host", "sharded_update_host"))
    print(f"admission plane (15): {time.perf_counter() - t0:.2f}s; "
          f"launches {json.dumps(launches)}")
    return launches, {"cost": cost, "failover": drills, "sheds": sheds,
                      "cold_start": cold, "card": card}



# -- phase 16: the native HTTP/2 ingress --------------------------------------

# ing: 16a's serial calls (every 7th a POST, which no limit matches; every
# 10th with a second descriptor, which takes the exact path); one: 16b's
# single key; zipf: 16b's concurrent Zipf users.
INGRESS_YAML = """\
- namespace: ing
  max_value: 5
  seconds: 60
  conditions: ["descriptors[0].method == 'GET'"]
  variables: ["descriptors[0].user"]
  name: ing-per-user
- namespace: one
  max_value: 3
  seconds: 60
  variables: ["descriptors[0].user"]
  name: one-key
- namespace: zipf
  max_value: 5
  seconds: 60
  variables: ["descriptors[0].user"]
  name: zipf-per-user
"""
INGRESS_SERIAL = 2000
INGRESS_ONE_KEY = 4000
INGRESS_ZIPF = 10000  # 20,000 until phase 17 came in
INGRESS_THREADS = 16
INGRESS_KEYS = 1 << 20
ENVOY_PATH = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
KUADRANT_PATH = "/kuadrant.service.ratelimit.v1.RateLimitService/"


#: the spans of phase 16's split of a pump batch: ``begin`` inside
#: ``decide``; ``launch`` (every ``begin_check_columnar``: upload, B1,
#: the download's start) and ``miss_lane`` inside ``begin``, the miss
#: lane's own launches in both; ``device_wait`` inside ``collect``
#: inside ``finish``
INGRESS_SPANS = ("decide", "begin", "launch", "miss_lane", "finish",
                 "collect", "device_wait")


def _ingress_split(busy, batches):
    """ms a pump batch in each span; ``slot_wait`` is the decide's
    time outside its begin (the wait for a finish slot, the slow rows'
    submits), ``respond`` the finish's outside its collect."""
    out = {name: busy[name] / max(batches, 1) * 1e3
           for name in INGRESS_SPANS}
    out["slot_wait"] = out["decide"] - out["begin"]
    out["respond"] = out["finish"] - out["collect"]
    return {k: round(v, 4) for k, v in out.items()}


def _free_port_pair():
    """A free local port p whose p + 1 is free too (the ingress's and the
    gRPC server's)."""
    for _ in range(100):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            port = a.getsockname()[1]
            with socket.socket() as b:
                try:
                    b.bind(("127.0.0.1", port + 1))
                except OSError:
                    continue
        return port
    fail("no free pair of local ports")


@contextlib.contextmanager
def _b1_tally(counts):
    """Count B1's card calls by route and shape while the block runs (the
    storage looks the wrapper up on its module at each call)."""
    from limitador_tpu_torch.ops import kernel as K

    b1 = K.check_and_update_batch

    def tally(state, slots, *args, route=None):
        if state.values.is_cuda:
            H = slots.shape[0]
            key = f"B1 {route or K.check_route(H)} H={H}"
            counts[key] = counts.get(key, 0) + 1
        return b1(state, slots, *args, route=route)

    K.check_and_update_batch = tally
    try:
        yield counts
    finally:
        K.check_and_update_batch = b1


def _ingress_serial_blobs(rls_pb2, rng, calls):
    users = zipf_keys(INGRESS_KEYS, calls, 0.99, rng)
    out = []
    for i, user in enumerate(users.tolist()):
        descriptors = [{"method": "POST" if i % 7 == 3 else "GET",
                        "user": f"u{user}"}]
        if i % 10 == 9:
            descriptors.append({"tenant": "t1"})
        out.append(_rls_request(rls_pb2, "ing", descriptors,
                                2 if i % 11 == 5 else 0))
    return out


def _unary(channel, path):
    return channel.unary_unary(path, request_serializer=None,
                               response_deserializer=None)


def _ingress_serial(port, aio_port, oracle_port, blobs):
    """16a: each call to the ingress (timed), to phase 6's grpc.aio
    native server (timed) and to the memory server, one at a time from
    this thread. Returns (latencies of each, mismatches)."""
    import grpc

    lat_ing, lat_aio, bad = [], [], []
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ic, \
            grpc.insecure_channel(f"127.0.0.1:{aio_port}") as ac, \
            grpc.insecure_channel(f"127.0.0.1:{oracle_port}") as oc:
        ing, aio, mem = (_unary(c, ENVOY_PATH) for c in (ic, ac, oc))
        for i, blob in enumerate(blobs):
            t0 = time.perf_counter()
            got = ing(blob, timeout=60)
            t1 = time.perf_counter()
            got_aio = aio(blob, timeout=60)
            t2 = time.perf_counter()
            want = mem(blob, timeout=60)
            lat_ing.append(t1 - t0)
            lat_aio.append(t2 - t1)
            if got != want or got_aio != want:
                bad.append((i, got, got_aio, want))
    return np.asarray(lat_ing) * 1e3, np.asarray(lat_aio) * 1e3, bad


# 16b's client: its own process, as Envoy is, so that its 16 threads do
# not share the server's interpreter lock with the pump. argv: port,
# threads, the blobs file (u32 length-prefixed), the answers file (one
# byte a call: 1 the OK blob, 2 the OVER_LIMIT blob, 0 anything else).
_INGRESS_CLIENT = r'''
import json, resource, sys, time
from concurrent.futures import ThreadPoolExecutor

import grpc

port, threads, src, dst = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
raw = open(src, "rb").read()
blobs, off = [], 0
while off < len(raw):
    n = int.from_bytes(raw[off:off + 4], "little")
    blobs.append(raw[off + 4:off + 4 + n])
    off += 4 + n
OK, OVER = b"\x08\x01", b"\x08\x02"
with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
    call = channel.unary_unary(
        "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit")
    # the connection, before the clock (no call: each one counts)
    grpc.channel_ready_future(channel).result(timeout=60)
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        answers = list(pool.map(lambda b: call(b, timeout=60), blobs))
    seconds = time.perf_counter() - t0
    r1 = resource.getrusage(resource.RUSAGE_SELF)
open(dst, "wb").write(bytes(1 if a == OK else 2 if a == OVER else 0
                            for a in answers))
print(json.dumps({"seconds": seconds,
                  "cpu_s": (r1.ru_utime - r0.ru_utime)
                  + (r1.ru_stime - r0.ru_stime)}))
'''


def _ingress_concurrent(port, blobs, tmpdir, threads=INGRESS_THREADS):
    """16b: every blob once, from ``threads`` threads on ONE channel of a
    client process; (codes in blob order: 1 OK, 2 OVER_LIMIT, 0 other;
    the drive's seconds; the client's CPU seconds in it)."""
    src = os.path.join(tmpdir, "blobs.bin")
    dst = os.path.join(tmpdir, "answers.bin")
    with open(src, "wb") as f:
        for b in blobs:
            f.write(len(b).to_bytes(4, "little") + b)
    proc = subprocess.run(
        [sys.executable, "-c", _INGRESS_CLIENT, str(port), str(threads),
         src, dst], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"16b's client process failed:\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(dst, "rb") as f:
        codes = list(f.read())
    return codes, out["seconds"], out["cpu_s"]


def _ingress_surface(port, rls_pb2):
    """16c: Kuadrant CheckRateLimit/Report on the ingress port and on the
    gRPC server's (port + 1), answers equal at each step; a reflection
    stream listing the services; an unknown method. Returns (calls sent
    to the ingress, stream messages, problems)."""
    import grpc

    from limitador_tpu_torch.server.proto import reflection_pb2

    problems = []
    sent = 0
    req = functools.partial(_rls_request, rls_pb2)
    blob = req("ing", [{"method": "GET", "user": "kq"}])
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ic, \
            grpc.insecure_channel(f"127.0.0.1:{port + 1}") as gc:

        def both(name):
            nonlocal sent
            sent += 1
            a = _unary(ic, KUADRANT_PATH + name)(blob, timeout=60)
            b = _unary(gc, KUADRANT_PATH + name)(blob, timeout=60)
            return a, b

        codes = []
        for step, (method, channel) in enumerate((
                ("CheckRateLimit", None), ("Report", ic),
                ("CheckRateLimit", None), ("Report", gc),
                ("CheckRateLimit", None), ("Report", ic),
                ("CheckRateLimit", None))):
            if channel is None:
                a, b = both(method)
                if a != b:
                    problems.append(f"step {step}: ingress {a!r} gRPC {b!r}")
                codes.append(rls_pb2.RateLimitResponse.FromString(
                    a).overall_code)
            else:
                sent += channel is ic
                _unary(channel, KUADRANT_PATH + method)(
                    req("ing", [{"method": "GET", "user": "kq"}], 2),
                    timeout=60)
        ok, over = (rls_pb2.RateLimitResponse.OK,
                    rls_pb2.RateLimitResponse.OVER_LIMIT)
        if codes != [ok, ok, ok, over]:
            problems.append(f"Kuadrant check codes {codes}")
        stream = ic.stream_stream(
            "/grpc.reflection.v1alpha.ServerReflection/ServerReflectionInfo",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=(
                reflection_pb2.ServerReflectionResponse.FromString))
        answers = list(stream(iter([
            reflection_pb2.ServerReflectionRequest(list_services="")]),
            timeout=60))
        names = {s.name for a in answers
                 for s in a.list_services_response.service}
        want = {"envoy.service.ratelimit.v3.RateLimitService",
                "kuadrant.service.ratelimit.v1.RateLimitService",
                "grpc.reflection.v1alpha.ServerReflection"}
        if len(answers) != 1 or names != want:
            problems.append(f"reflection listed {sorted(names)}")
        sent += 1
        try:
            _unary(ic, "/foo.Bar/Baz")(blob, timeout=60)
            problems.append("an unknown method answered OK")
        except grpc.RpcError as exc:
            if exc.code() != grpc.StatusCode.UNIMPLEMENTED:
                problems.append(f"an unknown method answered {exc.code()}")
    # the stream: its one message and its half-close
    return sent, 2, problems


async def _native_ingress(tmpdir, dev, card, serial=INGRESS_SERIAL,
                          one_key=INGRESS_ONE_KEY, zipf=INGRESS_ZIPF):
    """Phase 16. A torch server on the card with --pipeline native
    --native-ingress (the table at the main path's 1<<20 cells, the
    control planes at their defaults), phase 6's grpc.aio native server
    and a memory server, all on one frozen clock. (a) ``serial`` calls
    one at a time to each: byte-equal answers, the ingress's p50/p99
    beside grpc.aio's; (b) ``one_key`` calls for one key of max 3, then
    ``zipf`` over Zipf-0.99 users of max 5, from 16 threads on one
    channel: exactly 3, min(5, calls) a user, and the card's counters
    equal an oracle fed the admitted hits; (c) the Kuadrant methods,
    reflection and an unknown method on the ingress port; (d) what
    /metrics and the launch counts record."""
    from limitador_tpu_torch.core.cel import Context
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "native ingress (16)"
    limits = os.path.join(tmpdir, "limits.yaml")
    with open(limits, "w") as f:
        f.write(INGRESS_YAML)
    clock = ManualClock()
    parse = server.build_parser().parse_args
    common = ["--rls-host", "127.0.0.1", "--rate-limit-headers", "NONE"]
    native = ["--device", dev.type, "--pipeline", "native"]
    port = _free_port_pair()
    ing_http, ing_http_port = _http_options()
    loop = asyncio.get_running_loop()
    rng = np.random.default_rng(16)
    serial_blobs = _ingress_serial_blobs(rls_pb2, rng, serial)
    one_blob = _rls_request(rls_pb2, "one", [{"user": "hot"}])
    zipf_users = zipf_keys(INGRESS_KEYS, zipf, 0.99, rng).tolist()
    zipf_blobs = [_rls_request(rls_pb2, "zipf", [{"user": f"z{u}"}])
                  for u in zipf_users]
    K.reset_launches()
    t0 = time.perf_counter()
    routes: dict = {}
    failures = []
    gpu = await server.start(parse(
        [limits, "torch", *common, *native, "--native-ingress",
         *ing_http, "--rls-port", str(port)]), clock=clock,
        on_failure=failures.append)
    aio = oracle = None
    try:
        aio_port, oracle_port = (_free_port_pair() for _ in range(2))
        aio = await server.start(parse(
            [limits, "torch", *common, *native, *_http_options()[0],
             "--rls-port", str(aio_port)]), clock=clock,
            on_failure=failures.append)
        # the memory server's LRU must hold every counter of the phase
        oracle = await server.start(parse(
            [limits, "memory", *common, *_http_options()[0],
             "--cache-size", str(INGRESS_KEYS), "--rls-port",
             str(oracle_port)]), clock=clock)
        if gpu.native_ingress is None or gpu.native_ingress.port != port:
            fail(f"{label}: the ingress does not serve --rls-port {port}")
        pipeline = gpu.native_pipeline
        begins = {"calls": 0, "rows": 0}
        coded = pipeline._begin_batch_coded_ptrs

        def counted(ptrs, lens, n):
            begins["calls"] += 1
            begins["rows"] += n
            return coded(ptrs, lens, n)

        # where the pump's and the finish threads' time goes: the pump's
        # batch (decide: the begin, then the wait for a finish slot; the
        # begin: the hot lane and B1's launch, the miss lane) and a
        # finish thread's (collect: the device wait, then the respond)
        busy = dict.fromkeys(INGRESS_SPANS, 0.0)
        ingress = gpu.native_ingress
        table = pipeline.storage

        def timed(name, fn):
            def run(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    busy[name] += time.perf_counter() - t
            return run

        pipeline._begin_batch_coded_ptrs = timed("begin", counted)
        pipeline._begin_miss_lane = timed("miss_lane",
                                          pipeline._begin_miss_lane)
        pipeline._finish_namespace = timed("collect",
                                           pipeline._finish_namespace)
        table.begin_check_columnar = timed("launch",
                                           table.begin_check_columnar)
        table.finish_check_columnar = timed("device_wait",
                                            table.finish_check_columnar)
        ingress._decide_coded = timed("decide", ingress._decide_coded)
        ingress._finish_coded = timed("finish", ingress._finish_coded)
        with _b1_tally(routes):
            # (a) serial
            lat_ing, lat_aio, bad = await loop.run_in_executor(
                None, _ingress_serial, port, aio_port, oracle_port,
                serial_blobs)
            for i, got, got_aio, want in bad[:5]:
                print(f"  call {i}: ingress {got!r} grpc.aio {got_aio!r} "
                      f"memory {want!r}")
            if bad:
                fail(f"{label}: {len(bad)} of {serial} serial answers "
                     "differ from the memory server")
            stats = {}
            for name, lat in (("ingress", lat_ing), ("grpc.aio", lat_aio)):
                stats[name] = {"p50_ms": float(np.percentile(lat, 50)),
                               "p99_ms": float(np.percentile(lat, 99)),
                               "mean_ms": float(lat.mean())}
            print(f"{label} (a): {serial} serial ShouldRateLimit calls "
                  f"byte-equal with the memory server; served latency "
                  f"({card}): ingress p50 "
                  f"{stats['ingress']['p50_ms']:.3f} ms p99 "
                  f"{stats['ingress']['p99_ms']:.3f} ms, phase 6's "
                  f"grpc.aio p50 {stats['grpc.aio']['p50_ms']:.3f} ms p99 "
                  f"{stats['grpc.aio']['p99_ms']:.3f} ms")
            serial_begins = dict(begins)
            split_a = _ingress_split(busy, serial_begins["calls"])
            print(f"{label} (a): ms a pump batch (one call): "
                  f"{json.dumps(split_a)}")
            busy.update(dict.fromkeys(INGRESS_SPANS, 0.0))
            # (b) concurrent, one connection, from a client process
            cpu0 = time.process_time()
            one, one_s, one_cpu = await loop.run_in_executor(
                None, _ingress_concurrent, port, [one_blob] * one_key,
                tmpdir)
            answers, zipf_s, zipf_cpu = await loop.run_in_executor(
                None, _ingress_concurrent, port, zipf_blobs, tmpdir)
            cpu_s = time.process_time() - cpu0
            busy_b = dict(busy)
        one_ok = one.count(1)
        if one_ok != 3 or one.count(2) != one_key - 3:
            fail(f"{label}: {one_ok} of {one_key} concurrent calls for one "
                 "key of max 3 answered OK")
        calls, admitted = {}, {}
        for user, answer in zip(zipf_users, answers):
            calls[user] = calls.get(user, 0) + 1
            if answer == 1:
                admitted[user] = admitted.get(user, 0) + 1
            elif answer != 2:
                fail(f"{label}: a Zipf call answered neither OK nor "
                     "OVER_LIMIT")
        wrong = [u for u in calls if admitted.get(u, 0) != min(5, calls[u])]
        if wrong:
            fail(f"{label}: {len(wrong)} of {len(calls)} Zipf users admitted "
                 f"other than min(5, calls), e.g. user {wrong[0]}: "
                 f"{admitted.get(wrong[0], 0)} of {calls[wrong[0]]}")
        rows = begins["rows"] - serial_begins["rows"]
        batches = max(begins["calls"] - serial_begins["calls"], 1)
        drive_s = one_s + zipf_s
        rate = (one_key + zipf) / drive_s
        mean_batch = rows / batches
        client_cores = (one_cpu + zipf_cpu) / drive_s
        server_cores = cpu_s / drive_s
        # The pump's share of the drive inside a batch (the begin, and
        # the wait for a finish slot when both are taken); the rest it
        # waits in h2i_take for calls. Mostly waiting: the clients bound
        # the rate, not the server.
        pump_busy = busy_b["decide"] / drive_s
        finish_busy = busy_b["finish"] / drive_s
        client_bound = pump_busy < 0.5
        split_b = _ingress_split(busy_b, batches)
        print(f"{label} (b): exactly 3 of {one_key} calls for one key; "
              f"{zipf} calls over {len(calls)} Zipf users admitted min(5, "
              f"calls) each; {rate:.0f} decisions/s from "
              f"{INGRESS_THREADS} client threads on one channel of a "
              f"client process ({one_s:.2f} s + {zipf_s:.2f} s; client "
              f"CPU {client_cores:.2f} cores, server process "
              f"{server_cores:.2f}), {rows} rows in {batches} coded pump "
              f"batches ({mean_batch:.2f} a batch); the pump busy "
              f"{pump_busy:.2f} of the drive, the finish threads "
              f"{finish_busy:.2f} (of 2): "
              + ("the client threads bound it (the pump waits for calls "
                 "most of the time)" if client_bound else
                 "the server bounds it (the pump is busy most of the "
                 "time)")
              + f"; ms a pump batch: {json.dumps(split_b)}")
        # the oracle: the memory server's limiter fed the admitted hits
        for ns, fed in (("one", {"hot": one_ok}),
                        ("zipf", {f"z{u}": n for u, n in admitted.items()})):
            for user, n in fed.items():
                ctx = Context()
                ctx.list_binding("descriptors", [{"user": user}])
                oracle.limiter.update_counters(ns, ctx, n)
        # (c) the rest of the surface
        sent_c, stream_msgs, problems = await loop.run_in_executor(
            None, _ingress_surface, port, rls_pb2)
        if problems:
            fail(f"{label} (c): {problems}")
        # ... and the oracle the three Reports of 2 hits each
        ctx = Context()
        ctx.list_binding("descriptors", [{"method": "GET", "user": "kq"}])
        for _ in range(3):
            oracle.limiter.update_counters("ing", ctx, 2)
        print(f"{label} (c): Kuadrant CheckRateLimit/Report answers equal "
              f"on the ingress port and on --rls-port + 1; reflection "
              f"lists both services; an unknown method answers "
              f"UNIMPLEMENTED")
        final = {}
        for name, srv in (("gpu", gpu), ("oracle", oracle)):
            got = {}
            for ns in ("ing", "one", "zipf"):
                counters = srv.limiter.get_counters(ns)
                if asyncio.iscoroutine(counters):
                    counters = await counters
                for c in counters:
                    got[(ns, tuple(c.set_variables.items()))] = c.remaining
            final[name] = got
        if final["gpu"] != final["oracle"]:
            diff = set(final["gpu"].items()) ^ set(final["oracle"].items())
            fail(f"{label}: the card's counters differ from the oracle's: "
                 f"{sorted(diff)[:5]}")
        # (d) what it records
        sent = serial + one_key + zipf + sent_c + stream_msgs
        families = await _served_metrics(ing_http_port)
        requests = _metric(families, "ingress_requests")
        errors = _metric(families, "ingress_protocol_errors")
        respond = _histogram(families, "native_phase_h2i_respond")
        if requests != sent or errors != 0 or not respond["count"]:
            fail(f"{label} (d): ingress_requests {requests} (sent {sent}), "
                 f"ingress_protocol_errors {errors}, "
                 f"native_phase_h2i_respond {respond}")
        stats["ingress_stats"] = gpu.native_ingress.stats()
        if failures:
            fail(f"{label}: a background tier failed: {failures[0]!r}")
    finally:
        for srv in (gpu, aio, oracle):
            if srv is not None:
                await srv.stop()
    launches = dict(K.launches)
    if not any(key.startswith("B1 ") for key in routes):
        fail(f"{label}: B1 did not launch on the card")
    if launches["update_host"] == 0:
        fail(f"{label}: the Reports did not launch B2's host form")
    seconds = time.perf_counter() - t0
    print(f"{label} (d): /metrics ingress_requests {int(requests)} = calls "
          f"sent, ingress_protocol_errors 0, native_phase_h2i_respond "
          f"{json.dumps(respond)}; B1 card calls by route and shape "
          f"{json.dumps(dict(sorted(routes.items())))}; launches "
          f"{json.dumps(launches)}; {seconds:.1f} s")
    return launches, {
        "serial": stats, "decisions_per_s": rate,
        "one_key_s": one_s, "zipf_s": zipf_s, "zipf_users": len(calls),
        "pump_batches": batches, "pump_rows": rows,
        "client_cpu_cores": client_cores, "server_cpu_cores": server_cores,
        "pump_busy": pump_busy, "finish_busy": finish_busy,
        "split_serial_ms": split_a, "split_concurrent_ms": split_b,
        "client_bound": client_bound,
        "routes": routes, "h2i_respond": respond, "seconds": seconds,
    }


def phase_native_ingress(dev, card):
    with tempfile.TemporaryDirectory() as tmpdir:
        return asyncio.run(_native_ingress(tmpdir, dev, card))


# -- phase 17: serving shards and the routed pod ----------------------------

SHARD_LOOPS = 4
SHARD_CALLS = 500  # 2,000 until phase 18, 1,000 until phase 19
# the one-loop server's calls, for its p50/p99 beside the 4-loop one's
SHARD_CALLS_ONE_LOOP = 300  # 500 until phase 19
SHARD_HAMMER = 2000
SHARD_THREADS = 16
SHARD_CHANNELS = 8
POD_CALLS = 600  # 4,000 until phase 19 came in, 1,200 until phase 20
PSUM_CALLS = 400  # 600 until phase 20 came in
PSUM_INTERVAL_MS = 100
PSUM_MAX = 100
DRILL_MAX = 4
# the kernels the pod's main paths must launch: B1 on torch, B7a on
# sharded (its one-row lean batches take the rows kernel, the global
# namespace's the cluster), and the journal's replay into the restarted
# owner through B2's host form
PHASE17A_KERNELS = ("check_and_update",)
PHASE17B_KERNELS = {"sharded": ("sharded_check_and_update",
                                "sharded_check_and_update_cluster"),
                    "torch": ("check_and_update",)}
PHASE17D_KERNELS = ("update_host",)
# phase 18: B1 on both members of both native pods, B2's host form in
# 18c's replay into the restarted owner
PHASE18_KERNELS = ("check_and_update",)
PHASE18C_KERNELS = ("update_host",)
POD_DEGRADED_CALLS = 400  # 800 until phase 20 came in
POD_CONCURRENT_CALLS = 1500
POD_FLIGHT_CALLS = 300

SHARD_LIMITS = """\
- namespace: shard
  max_value: 5
  seconds: 120
  variables: ["descriptors[0].user"]
  name: per-user
- namespace: hot
  max_value: 3
  seconds: 120
  variables: ["descriptors[0].user"]
  name: per-user-hot
"""

POD_LIMITS = """\
- namespace: pods
  max_value: 5
  seconds: 120
  variables: ["descriptors[0].user"]
  name: per-user
- namespace: multi
  max_value: 3
  seconds: 120
  variables: ["descriptors[0].user"]
  name: multi-user
- namespace: multi
  max_value: 400
  seconds: 120
  name: multi-total
- namespace: glob
  max_value: 40
  seconds: 120
  variables: ["descriptors[0].tenant"]
  name: per-tenant
- namespace: gpsum
  max_value: 100
  seconds: 120
  variables: ["descriptors[0].tenant"]
  name: psum-tenant
- namespace: drill
  max_value: 4
  seconds: 120
  variables: ["descriptors[0].user"]
  name: drill-user
"""

# A pod member: the port's server, its kernel launch counts written to a
# file when it exits or gets SIGUSR1 (the kernels count in the process
# that launches them, and a member about to be killed is asked first).
_POD_MAIN = """
import atexit, json, os, signal, sys
out = sys.argv[1]
from limitador_tpu_torch.ops import kernel as K
def dump(*_args):
    with open(out + ".tmp", "w") as f:
        json.dump(dict(K.launches), f)
    os.replace(out + ".tmp", out)
atexit.register(dump)
signal.signal(signal.SIGUSR1, dump)
from limitador_tpu_torch.server.__main__ import main
sys.exit(main(sys.argv[2:]))
"""


def _channels(port, n):
    """n channels to one port, each with its own connection (channels
    of one process to one target otherwise share one)."""
    import grpc

    return [grpc.insecure_channel(
        f"127.0.0.1:{port}",
        options=(("grpc.use_local_subchannel_pool", 1),)) for _ in range(n)]


def _envoy(channel):
    return channel.unary_unary(
        "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit")


def _pct(lat_ms):
    lat = sorted(lat_ms)
    if not lat:
        return None, None
    return (lat[len(lat) // 2],
            lat[min(int(0.99 * len(lat)), len(lat) - 1)])


def _ctx(Context, entries):
    ctx = Context()
    ctx.list_binding("descriptors", [entries])
    return ctx


def _shards_serial(port, blobs, rls_pb2):
    channels = _channels(port, SHARD_CHANNELS)
    calls = [_envoy(ch) for ch in channels]
    codes, lat = [], []
    try:
        for i, blob in enumerate(blobs):
            t0 = time.perf_counter()
            raw = calls[i % SHARD_CHANNELS](blob, timeout=60)
            lat.append((time.perf_counter() - t0) * 1e3)
            codes.append(rls_pb2.RateLimitResponse.FromString(
                raw).overall_code)
    finally:
        for ch in channels:
            ch.close()
    return codes, lat


def _shards_hammer(port, blob, rls_pb2):
    from concurrent.futures import ThreadPoolExecutor

    channels = _channels(port, SHARD_CHANNELS)
    calls = [_envoy(ch) for ch in channels]
    try:
        with ThreadPoolExecutor(SHARD_THREADS) as pool:
            codes = list(pool.map(
                lambda i: rls_pb2.RateLimitResponse.FromString(
                    calls[i % SHARD_CHANNELS](blob, timeout=60)
                ).overall_code, range(SHARD_HAMMER)))
    finally:
        for ch in channels:
            ch.close()
    return codes


def _loops_decided(srv):
    """Serving loops that decided a batch, from the server's own
    per-loop shards (the native pipeline's, else the batchers')."""
    if srv.native_pipeline is not None:
        return sum(1 for s in list(srv.native_pipeline._shards.values())
                   if s.batch_seq > 0)
    return sum(1 for mb, _ub in srv.limiter.storage.counters._batcher_pairs()
               if mb._batch_seq > 0)


async def _serving_shards(tmpdir, dev, card, native, loops):
    """Phase 17a, one server: torch on the card with --serving-shards
    ``loops`` (``native``: --pipeline native), SHARD_CALLS serial calls
    over Zipf-0.99 users from 1<<20 keys on 8 channels held against an
    in-memory oracle on the server's frozen clock, then (with more than
    one loop) SHARD_HAMMER calls for one key of 3 from 16 threads."""
    from limitador_tpu_torch import Context, RateLimiter
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.limits_file import load_limits_file
    from limitador_tpu_torch.server.proto import rls_pb2
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    label = (f"serving shards (17a, {'native' if native else 'standard'}, "
             f"{loops} loops)")
    path = os.path.join(tmpdir, "shard-limits.yaml")
    with open(path, "w") as f:
        f.write(SHARD_LIMITS)
    clock = ManualClock()
    oracle = RateLimiter(InMemoryStorage(1 << 20, clock=clock))
    oracle.configure_with(load_limits_file(path))
    http, _port = _http_options()
    rls = _free_ports(1)[0]
    argv = [path, "torch", "--device", "cuda", "--capacity", str(C),
            "--rls-host", "127.0.0.1", "--rls-port", str(rls),
            "--serving-shards", str(loops), *http]
    if native:
        argv += ["--pipeline", "native"]
    srv = await server.start(server.build_parser().parse_args(argv),
                             clock=clock)
    loop = asyncio.get_running_loop()
    rng = np.random.default_rng(1717 + native)
    calls = SHARD_CALLS if loops > 1 else SHARD_CALLS_ONE_LOOP
    users = zipf_keys(C, calls, 0.99, rng)
    blobs = [_rls_request(rls_pb2, "shard", [{"user": f"u{u}"}])
             for u in users]
    try:
        K.reset_launches()
        codes, lat = await loop.run_in_executor(
            None, _shards_serial, rls, blobs, rls_pb2)
        hammered = None
        if loops > 1:
            hammered = await loop.run_in_executor(
                None, _shards_hammer, rls,
                _rls_request(rls_pb2, "hot", [{"user": "h"}]), rls_pb2)
        launches = dict(K.launches)
        decided = _loops_decided(srv)
    finally:
        await srv.stop()
    ok, over = (rls_pb2.RateLimitResponse.OK,
                rls_pb2.RateLimitResponse.OVER_LIMIT)
    want = [over if oracle.check_rate_limited_and_update(
        "shard", _ctx(Context, {"user": f"u{u}"}), 1, False).limited
        else ok for u in users]
    differ = sum(a != b for a, b in zip(codes, want))
    if differ:
        fail(f"{label}: {differ} of {calls} answers differ from the "
             "in-memory oracle's")
    p50, p99 = _pct(lat)
    out = {"loops": loops, "loops_decided": decided, "p50_ms": p50,
           "p99_ms": p99, "calls": calls}
    if hammered is not None:
        admitted = hammered.count(ok)
        if admitted != 3:
            fail(f"{label}: {admitted} of {SHARD_HAMMER} one-key calls "
                 "admitted where the limit is 3")
        if decided < 2:
            fail(f"{label}: only {decided} serving loop(s) decided")
        out["hammer_admitted"] = admitted
    missing = [k for k in PHASE17A_KERNELS if _launched(launches, k) == 0]
    if missing:
        fail(f"{label}: kernels not launched: {missing}")
    print(f"{label}: {calls} serial calls on {SHARD_CHANNELS} "
          f"channels equal to the in-memory oracle"
          + (f", {SHARD_HAMMER} one-key calls from {SHARD_THREADS} threads "
             f"admitted exactly {out['hammer_admitted']}"
             if hammered is not None else "")
          + f"; {decided} of {loops} loops decided; p50 {p50:.3f} ms, "
          f"p99 {p99:.3f} ms ({card})", flush=True)
    return launches, out


def _pod_argv(tmpdir, tag, storage, pid, coord, peers, rls, http, extra):
    limits = os.path.join(tmpdir, "pod-limits.yaml")
    argv = [limits, storage, "--device", "cuda", "--capacity", str(1 << 17),
            "--rls-host", "127.0.0.1", "--rls-port", str(rls[pid]),
            "--http-host", "127.0.0.1", "--http-port", str(http[pid]),
            "--flight-spool-dir", os.path.join(tmpdir, f"flight-{tag}{pid}"),
            "--pod-coordinator", coord, "--pod-processes", "2",
            "--pod-process-id", str(pid),
            "--pod-peer-listen", f"127.0.0.1:{peers[pid]}",
            "--usage-topk", "0", *extra]
    for port in peers:
        argv += ["--pod-peer", f"127.0.0.1:{port}"]
    return argv


def _pod_spawn(tmpdir, name, argv, env=None):
    log = open(os.path.join(tmpdir, f"{name}.log"), "wb")
    out = os.path.join(tmpdir, f"{name}.launches.json")
    proc = subprocess.Popen(
        [sys.executable, "-c", _POD_MAIN, out, *argv],
        stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": os.getcwd(), **(env or {})})
    return {"proc": proc, "log": log, "launches": out, "name": name}


def _pod_wait(member, http_port, tmpdir, label, timeout=180):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if member["proc"].poll() is not None:
            with open(os.path.join(tmpdir, f"{member['name']}.log")) as f:
                fail(f"{label}: {member['name']} exited "
                     f"{member['proc'].returncode}: {f.read()[-3000:]}")
        try:
            if _http_get(http_port, "/status")[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.2)
    fail(f"{label}: {member['name']} never answered /status")


def _pod_stop(member, label):
    """SIGTERM, then the member's kernel launches (None once killed)."""
    proc = member["proc"]
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"{label}: {member['name']} did not stop on SIGTERM")
    member["log"].close()
    try:
        with open(member["launches"]) as f:
            return json.load(f)
    except OSError:
        return None


def _pod_launches_now(member, label, timeout=30):
    """A running member's kernel launch counts so far (SIGUSR1)."""
    import signal

    path = member["launches"]
    if os.path.exists(path):
        os.remove(path)
    member["proc"].send_signal(signal.SIGUSR1)
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            fail(f"{label}: {member['name']} wrote no launch counts")
        time.sleep(0.05)
    with open(path) as f:
        return json.load(f)


def _pod_metric(port, name):
    from prometheus_client.parser import text_string_to_metric_families

    text = _http_get(port, "/metrics")[1].decode()
    for fam in text_string_to_metric_families(text):
        if fam.name == name:
            return sum(s.value for s in fam.samples
                       if s.name in (name, name + "_total"))
    fail(f"/metrics on port {port} has no {name}")


def _pod_counters(port, ns):
    status, body = _http_get(port, f"/counters/{ns}")
    if status != 200:
        fail(f"GET /counters/{ns} on port {port} answered {status}")
    return {(ns, c["limit"]["name"],
             tuple(sorted(c["set_variables"].items())), c["remaining"])
            for c in json.loads(body)}


def _oracle_counters(limiter, ns):
    return {(ns, c.limit.name, tuple(sorted(c.set_variables.items())),
             c.remaining) for c in limiter.get_counters(ns)}


def _pod_drive(rls, calls_spec, rls_pb2):
    """Sequential calls, each to its arrival host; (codes, ms)."""
    import grpc

    channels = [_channels(port, 1)[0] for port in rls]
    calls = [_envoy(ch) for ch in channels]
    codes, lat = [], []
    try:
        for host, blob in calls_spec:
            t0 = time.perf_counter()
            try:
                raw = calls[host](blob, timeout=60)
            except grpc.RpcError as exc:
                codes.append(f"error:{exc.code().name}")
                lat.append((time.perf_counter() - t0) * 1e3)
                continue
            lat.append((time.perf_counter() - t0) * 1e3)
            codes.append(rls_pb2.RateLimitResponse.FromString(
                raw).overall_code)
    finally:
        for ch in channels:
            ch.close()
    return codes, lat


def _pod_requests(rng, n):
    """(host, namespace, entries) of the 17b drive: 60% a single-limit
    namespace (routed by key), 25% a two-limit one (pinned), 15% the
    global one (pinned on sharded); users Zipf-0.99 over 1<<20, the
    hosts alternating."""
    users = zipf_keys(C, n, 0.99, rng)
    kinds = rng.random(n)
    out = []
    for i in range(n):
        if kinds[i] < 0.60:
            ns, entries = "pods", {"user": f"u{users[i]}"}
        elif kinds[i] < 0.85:
            ns, entries = "multi", {"user": f"u{users[i]}"}
        else:
            ns, entries = "glob", {"tenant": f"t{users[i] % 16}"}
        out.append((i % 2, ns, entries))
    return out


def _router(limits, global_ns, host):
    from limitador_tpu_torch.routing import PodRouter, PodTopology

    router = PodRouter(PodTopology(hosts=2, host_id=host, shards_per_host=1))
    router.configure(limits, global_ns)
    return router


def _verdicts(requests, limits, global_ns):
    """Each request's routing verdict, as its arrival host computes it."""
    from limitador_tpu_torch import Context, RateLimiter
    from limitador_tpu_torch.core.limiter import _counters_that_apply
    from limitador_tpu_torch.core.limit import Namespace
    from limitador_tpu_torch.routing import counter_key
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    probe = RateLimiter(InMemoryStorage(16))
    probe.configure_with(limits)
    routers = [_router(limits, global_ns, h) for h in (0, 1)]
    out = []
    for host, ns, entries in requests:
        counters = _counters_that_apply(
            probe.storage, Namespace.of(ns), _ctx(Context, entries))
        out.append(routers[host].verdict(
            ns, [counter_key(c) for c in counters])[0])
    return out


def _hop_split(port):
    status, body = _http_get(port, "/debug/pod")
    if status != 200:
        fail(f"GET /debug/pod on port {port} answered {status}")
    return json.loads(body)["hops"]


async def _routed_pod(tmpdir, dev, card, storage):
    """Phases 17b (both storages) and, on torch, 17c and 17d: a pod of
    two server processes on the card."""
    from limitador_tpu_torch import Context, RateLimiter
    from limitador_tpu_torch.device.sharded import TorchShardedStorage
    from limitador_tpu_torch.server.limits_file import load_limits_file
    from limitador_tpu_torch.server.proto import rls_pb2
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    label = f"routed pod (17b, {storage})"
    with open(os.path.join(tmpdir, "pod-limits.yaml"), "w") as f:
        f.write(POD_LIMITS)
    limits = load_limits_file(os.path.join(tmpdir, "pod-limits.yaml"))
    if storage == "sharded":
        extra, global_ns = ["--global-namespaces", "glob",
                            "--global-region", "64"], ["glob"]
    else:
        extra = ["--global-namespaces", "gpsum", "--pod-psum-lane", "on",
                 "--pod-psum-interval-ms", str(PSUM_INTERVAL_MS)]
        global_ns = []  # the psum lane claims gpsum: nothing global pinned
    coord = f"127.0.0.1:{_free_ports(1)[0]}"
    peers, rls, http = _free_ports(2), _free_ports(2), _free_ports(2)
    argvs = [_pod_argv(tmpdir, storage, storage, pid, coord, peers, rls,
                       http, extra) for pid in (0, 1)]
    t0 = time.perf_counter()
    members = [_pod_spawn(tmpdir, f"pod-{storage}-{pid}", argvs[pid])
               for pid in (0, 1)]
    for pid in (0, 1):
        _pod_wait(members[pid], http[pid], tmpdir, label)
    formed_s = time.perf_counter() - t0
    loop = asyncio.get_running_loop()
    out = {"formed_s": formed_s}
    launches = []
    try:
        rng = np.random.default_rng(1718)
        requests = _pod_requests(rng, POD_CALLS)
        spec = [(h, _rls_request(rls_pb2, ns, [e])) for h, ns, e in requests]
        t0 = time.perf_counter()
        codes, lat = await loop.run_in_executor(
            None, _pod_drive, rls, spec, rls_pb2)
        drive_s = time.perf_counter() - t0
        errors = [c for c in codes if isinstance(c, str)]
        if errors:
            fail(f"{label}: {len(errors)} calls failed: {errors[:5]}")
        # the oracle: one process, fed the same calls in the same order
        if storage == "sharded":
            oracle = RateLimiter(TorchShardedStorage(
                n_shards=2, local_capacity=1 << 17,
                global_namespaces=["glob"], global_region=64,
                device=str(dev)))
        else:
            oracle = RateLimiter(InMemoryStorage(1 << 20))
        oracle.configure_with(limits)
        ok, over = (rls_pb2.RateLimitResponse.OK,
                    rls_pb2.RateLimitResponse.OVER_LIMIT)
        want = [over if oracle.check_rate_limited_and_update(
            ns, _ctx(Context, e), 1, False).limited else ok
            for _h, ns, e in requests]
        differ = sum(a != b for a, b in zip(codes, want))
        if differ:
            fail(f"{label}: {differ} of {POD_CALLS} answers differ from a "
                 "single-process table's")
        got_counters, want_counters = set(), set()
        for ns in ("pods", "multi", "glob"):
            for port in http:
                got_counters |= _pod_counters(port, ns)
            want_counters |= _oracle_counters(oracle, ns)
        if got_counters != want_counters:
            fail(f"{label}: the union of the hosts' counters differs from "
                 f"the single-process table's: "
                 f"{len(got_counters ^ want_counters)} differences of "
                 f"{len(want_counters)}")
        verdicts = _verdicts(requests, limits, global_ns)
        routed = {v: sum(_pod_metric(port, f"pod_routed_{v}")
                         for port in http)
                  for v in ("local", "forwarded", "pinned")}
        tally = {"local": verdicts.count("local"),
                 "forwarded": verdicts.count("forward"),
                 "pinned": verdicts.count("pinned")}
        if routed != tally or min(routed.values()) == 0:
            fail(f"{label}: routed {routed} where the requests' verdicts "
                 f"are {tally} (each must be above 0)")
        by = {v: [ms for ms, vv in zip(lat, verdicts) if vv == v]
              for v in ("local", "forward", "pinned")}
        out.update({
            "calls": POD_CALLS, "drive_s": drive_s, "routed": routed,
            "counters": len(want_counters),
            "p50_p99_ms": {v: _pct(ms) for v, ms in by.items()},
            "hops": [_hop_split(port) for port in http],
            "peer_errors": [_pod_metric(port, "pod_peer_errors")
                            for port in http],
        })
        print(f"{label}: pod formed in {formed_s:.2f} s; {POD_CALLS} "
              f"sequential calls alternating hosts in {drive_s:.2f} s, "
              f"every answer and the union of both hosts' "
              f"{len(want_counters)} counters equal to the single-process "
              f"{'2-row TorchShardedStorage' if storage == 'sharded' else 'in-memory oracle'}; "
              f"routed {json.dumps(routed)}; p50/p99 ms "
              f"{json.dumps(out['p50_p99_ms'])}; hop phases (host 0) "
              f"{json.dumps(out['hops'][0]['phases'])} ({card})", flush=True)
        if storage == "torch":
            out["psum"] = await loop.run_in_executor(
                None, _psum_check, rls, http, rls_pb2, card)
            killed, drill = await _degraded_drill(
                tmpdir, members, argvs, rls, http, limits, rls_pb2, card)
            out["drill"] = drill
            launches.append(killed)  # the killed member's, before it died
    finally:
        for member in members:
            launches.append(_pod_stop(member, label))
    launches = [run for run in launches if run is not None]
    total = {}
    for run in launches:
        for k, v in run.items():
            total[k] = total.get(k, 0) + v
    missing = [k for k in PHASE17B_KERNELS[storage]
               if _launched(total, k) == 0]
    if storage == "torch":
        missing += [k for k in PHASE17D_KERNELS if total.get(k, 0) == 0]
    if missing:
        fail(f"{label}: kernels not launched in the pod's processes: "
             f"{missing}")
    out["launches"] = total
    print(f"{label}: launches in the pod's processes "
          f"{json.dumps({k: v for k, v in total.items() if v})}", flush=True)
    return total, out


def _psum_check(rls, http, rls_pb2, card):
    """Phase 17c: PSUM_CALLS sequential calls for one tenant of a
    fixed-window global namespace of PSUM_MAX, alternating hosts, each
    host deciding locally against the other's partials exchanged every
    PSUM_INTERVAL_MS. Admitted past the limit: at most what the other
    host admitted in the blind spot, bounded here by each host's largest
    admissions within two intervals (one interval of staleness plus the
    exchange in flight)."""
    label = "psum lane (17c)"
    ok = rls_pb2.RateLimitResponse.OK
    blob = _rls_request(rls_pb2, "gpsum", [{"tenant": "t0"}])
    spec = [(i % 2, blob) for i in range(PSUM_CALLS)]
    stamps = []
    codes, lat = [], []
    import grpc

    channels = [_channels(port, 1)[0] for port in rls]
    calls = [_envoy(ch) for ch in channels]
    try:
        for host, b in spec:
            t = time.monotonic()
            raw = calls[host](b, timeout=60)
            code = rls_pb2.RateLimitResponse.FromString(raw).overall_code
            codes.append(code)
            stamps.append((t, host, code == ok))
        time.sleep(4 * PSUM_INTERVAL_MS / 1e3)  # a final exchange
        after = [rls_pb2.RateLimitResponse.FromString(
            calls[h](blob, timeout=60)).overall_code for h in (0, 1)]
    except grpc.RpcError as exc:
        fail(f"{label}: a call failed: {exc.code().name}")
    finally:
        for ch in channels:
            ch.close()
    admitted = codes.count(ok)
    window = 2 * PSUM_INTERVAL_MS / 1e3
    bound = 0
    for host in (0, 1):
        times = [t for t, h, a in stamps if h == host and a]
        best = j = 0
        for i, t in enumerate(times):
            while times[j] < t - window:
                j += 1
            best = max(best, i - j + 1)
        bound += best
    over = max(admitted - PSUM_MAX, 0)
    exchanges = [_pod_metric(port, "pod_psum_exchanges") for port in http]
    decisions = [_pod_metric(port, "pod_psum_decisions") for port in http]
    if admitted < PSUM_MAX or over > bound:
        fail(f"{label}: admitted {admitted} of limit {PSUM_MAX}: "
             f"over-admission {over} past the bound {bound}")
    if ok in after:
        fail(f"{label}: a call after the final exchange was admitted")
    if min(exchanges) == 0 or sum(decisions) < PSUM_CALLS:
        fail(f"{label}: exchanges {exchanges}, decisions {decisions}")
    print(f"{label}: {PSUM_CALLS} calls for one tenant of {PSUM_MAX}, "
          f"hosts alternating, exchange every {PSUM_INTERVAL_MS} ms: "
          f"admitted {admitted}, over-admission {over} (bound {bound}: "
          f"each host's admissions within two intervals); after the final "
          f"exchange both hosts limit; exchanges {exchanges} ({card})",
          flush=True)
    return {"admitted": admitted, "limit": PSUM_MAX, "over": over,
            "bound": bound, "exchanges": exchanges}


async def _degraded_drill(tmpdir, members, argvs, rls, http, limits,
                          rls_pb2, card):
    """Phase 17d on the torch pod: host 1 killed mid-drive, host 0's
    calls for host 1's keys answered by the stand-in (no UNAVAILABLE),
    host 1 restarted on the same address with an empty table, the
    journal replayed into it through ``apply_deltas`` (B2's host form),
    its counters for keys born in the partition equal to the oracle's."""
    from limitador_tpu_torch import Context, RateLimiter
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    label = "degraded drill (17d)"
    loop = asyncio.get_running_loop()
    ok = rls_pb2.RateLimitResponse.OK
    verdicts = _verdicts(
        [(0, "drill", {"user": f"d{i}"}) for i in range(400)], limits, [])
    owned = [f"d{i}" for i, v in enumerate(verdicts) if v == "forward"][:6]
    if len(owned) < 6:
        fail(f"{label}: found no keys of host 1")
    pre, fresh = owned[:2], owned[2:]

    def call(user):
        return (0, _rls_request(rls_pb2, "drill", [{"user": user}]))

    codes, _lat = await loop.run_in_executor(
        None, _pod_drive, rls, [call(u) for u in pre for _ in range(2)],
        rls_pb2)
    if codes != [ok] * 4:
        fail(f"{label}: before the kill: {codes}")
    killed = _pod_launches_now(members[1], label)
    t_kill = time.monotonic()
    members[1]["proc"].kill()
    members[1]["proc"].wait()
    members[1]["log"].close()
    rounds = [call(u) for _ in range(DRILL_MAX + 1) for u in owned]
    codes, lat = await loop.run_in_executor(
        None, _pod_drive, rls, rounds, rls_pb2)
    errors = [c for c in codes if isinstance(c, str)]
    if errors:
        fail(f"{label}: {len(errors)} calls for the dead owner's keys "
             f"failed: {errors[:5]}")
    admitted = {u: 0 for u in owned}
    for (_h, _b), code, user in zip(rounds, codes,
                                    [u for _ in range(DRILL_MAX + 1)
                                     for u in owned]):
        admitted[user] += code == ok
    deadline = time.monotonic() + 30
    while _pod_metric(http[0], "pod_failover_breaker_open") < 1:
        if time.monotonic() > deadline:
            fail(f"{label}: the breaker never opened")
        time.sleep(0.05)
    trip_s = time.monotonic() - t_kill
    if any(n != DRILL_MAX for n in admitted.values()):
        fail(f"{label}: the stand-in admitted {admitted} (a fresh window "
             f"of {DRILL_MAX} each)")
    journal = _pod_metric(http[0], "pod_failover_journal_depth")
    t_restart = time.monotonic()
    members[1] = _pod_spawn(tmpdir, "pod-torch-1b", argvs[1])
    _pod_wait(members[1], http[1], tmpdir, label)
    up_s = time.monotonic() - t_restart
    deadline = time.monotonic() + 60
    while not (_pod_metric(http[0], "pod_failover_journal_depth") == 0
               and _pod_metric(http[0], "pod_failover_reconciles") >= 1):
        if time.monotonic() > deadline:
            fail(f"{label}: the journal never replayed")
        time.sleep(0.05)
    replay_done_s = time.monotonic() - t_restart
    probe_s = replay_done_s - up_s
    replayed = _pod_metric(http[0], "pod_failover_replayed_deltas")
    reconcile_s = _pod_metric(http[0], "pod_failover_reconcile_seconds")
    after, _ = await loop.run_in_executor(
        None, _pod_drive, rls, [call(u) for u in owned], rls_pb2)
    if ok in after:
        fail(f"{label}: after the replay the owner admitted {after}")
    oracle = RateLimiter(InMemoryStorage(4096))
    oracle.configure_with(limits)
    for user in owned:
        for _ in range(admitted[user]):
            oracle.check_rate_limited_and_update(
                "drill", _ctx(Context, {"user": user}), 1, False)
    got = {c[2]: c[3] for c in _pod_counters(http[1], "drill")}
    want = {c[2]: c[3] for c in _oracle_counters(oracle, "drill")}
    for user in fresh:
        key = (("descriptors[0].user", user),)
        if got.get(key) != want.get(key):
            fail(f"{label}: host 1 holds {got.get(key)} for {user}, the "
                 f"oracle {want.get(key)}")
    for user in pre:  # older keys: within one extra window
        if 2 + admitted[user] > 2 * DRILL_MAX:
            fail(f"{label}: {user} admitted past two windows")
    if replayed != len(owned):
        fail(f"{label}: replayed {replayed} deltas for {len(owned)} "
             "journaled counters")
    out = {"trip_s": trip_s, "restart_up_s": up_s,
           "replay_done_s": replay_done_s, "probe_s": probe_s,
           "reconcile_s": reconcile_s, "replayed_deltas": replayed,
           "journal": journal, "degraded_p50_p99_ms": _pct(lat)}
    print(f"{label}: host 1 killed mid-drive, {len(rounds)} calls for its "
          f"{len(owned)} keys answered by host 0's stand-in with no error "
          f"(p50/p99 {out['degraded_p50_p99_ms']} ms); breaker open "
          f"{trip_s:.3f} s after the kill; host 1 back in {up_s:.2f} s, "
          f"journal of {journal:.0f} counters replayed ({replayed:.0f} "
          f"deltas) {replay_done_s:.3f} s after the restart ({probe_s:.3f} "
          f"s after it answered: the probe and the replay), reconcile "
          f"{reconcile_s * 1e3:.1f} ms; host 1's counters for the "
          f"partition's keys equal the oracle ({card})", flush=True)
    return killed, out


def phase_pod(dev, card):
    """Phase 17: serving shards (a), the routed pod on sharded and torch
    (b), the psum lane (c) and the degraded drill (d)."""
    t0 = time.perf_counter()
    runs, out = [], {"shards": []}
    with tempfile.TemporaryDirectory() as tmpdir:
        for native in (False, True):
            for loops in (SHARD_LOOPS, 1):
                run, res = asyncio.run(_serving_shards(
                    tmpdir, dev, card, native, loops))
                res["pipeline"] = "native" if native else "standard"
                runs.append(run)
                out["shards"].append(res)
    for storage in ("sharded", "torch"):
        with tempfile.TemporaryDirectory() as tmpdir:
            run, res = asyncio.run(_routed_pod(tmpdir, dev, card, storage))
        runs.append(run)
        out[storage] = res
    launches = {}
    for run in runs:
        for k, v in run.items():
            launches[k] = launches.get(k, 0) + v
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 17 took {out['seconds']:.1f} s", flush=True)
    return launches, out


# 18b's client: its own process (as 16b's), 16 threads, call i to host
# i % 2's ingress over its own channel. argv: ports (comma-separated),
# threads, the blobs file (u32 length-prefixed), the answers file (one
# byte a call: 1 the OK blob, 2 the OVER_LIMIT blob, 0 anything else),
# the latencies file (float64 ms a call).
_POD_CLIENT = r'''
import json, sys, time
from concurrent.futures import ThreadPoolExecutor

import grpc
import numpy as np

ports = [int(p) for p in sys.argv[1].split(",")]
threads, src, dst, lat_path = int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
raw = open(src, "rb").read()
blobs, off = [], 0
while off < len(raw):
    n = int.from_bytes(raw[off:off + 4], "little")
    blobs.append(raw[off + 4:off + 4 + n])
    off += 4 + n
OK, OVER = b"\x08\x01", b"\x08\x02"
channels = [grpc.insecure_channel(f"127.0.0.1:{p}") for p in ports]
calls = [c.unary_unary(
    "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit")
    for c in channels]
for c in channels:
    grpc.channel_ready_future(c).result(timeout=60)
lat = np.zeros(len(blobs))

def one(i):
    t = time.perf_counter()
    out = calls[i % len(calls)](blobs[i], timeout=60)
    lat[i] = (time.perf_counter() - t) * 1e3
    return out

t0 = time.perf_counter()
with ThreadPoolExecutor(threads) as pool:
    answers = list(pool.map(one, range(len(blobs))))
seconds = time.perf_counter() - t0
for c in channels:
    c.close()
open(dst, "wb").write(bytes(1 if a == OK else 2 if a == OVER else 0
                            for a in answers))
np.asarray(lat, np.float64).tofile(lat_path)
print(json.dumps({"seconds": seconds}))
'''


def _native_pod_argv(tmpdir, tag, pid, coord, peers, rls, http, ingress,
                     flight_sample):
    """17b's torch member options with the native pipeline; 18d's pod
    records every decision into the flight rings (``flight_sample``
    1), the others sample as a server does by default (17b's too)."""
    extra = ["--global-namespaces", "gpsum", "--pod-psum-lane", "on",
             "--pod-psum-interval-ms", str(PSUM_INTERVAL_MS),
             "--pipeline", "native", "--native-hot-lane", "on",
             "--rate-limit-headers", "NONE"]
    if ingress:
        extra.append("--native-ingress")
    if flight_sample is not None:
        extra += ["--flight-sample", str(flight_sample)]
    return _pod_argv(tmpdir, tag, "torch", pid, coord, peers, rls, http,
                     extra)


def _pod_ports(ingress):
    """(coordinator, peer, RLS, HTTP ports) of a 2-member pod, all
    distinct; an ingress member's RLS port p has p + 1 free (its gRPC
    server's)."""
    taken = set()
    rls = []
    for _ in (0, 1):
        port = _free_port_pair() if ingress else _free_ports(1)[0]
        while port in taken or port + 1 in taken:
            port = _free_port_pair() if ingress else _free_ports(1)[0]
        rls.append(port)
        taken |= {port, port + 1}
    others = []
    while len(others) < 5:
        port = _free_ports(1)[0]
        if port not in taken:
            taken.add(port)
            others.append(port)
    return (f"127.0.0.1:{others[0]}", others[1:3], rls, others[3:5])


def _start_native_pod(tmpdir, tag, label, ingress=False,
                      flight_sample=None):
    with open(os.path.join(tmpdir, "pod-limits.yaml"), "w") as f:
        f.write(POD_LIMITS)
    coord, peers, rls, http = _pod_ports(ingress)
    argvs = [_native_pod_argv(tmpdir, tag, pid, coord, peers, rls, http,
                              ingress, flight_sample) for pid in (0, 1)]
    t0 = time.perf_counter()
    members = [_pod_spawn(tmpdir, f"pod-{tag}-{pid}", argvs[pid])
               for pid in (0, 1)]
    for pid in (0, 1):
        _pod_wait(members[pid], http[pid], tmpdir, label)
    return members, argvs, rls, http, time.perf_counter() - t0


def _pod_oracle(limits):
    from limitador_tpu_torch import RateLimiter
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    oracle = RateLimiter(InMemoryStorage(1 << 20))
    oracle.configure_with(limits)
    return oracle


def _oracle_codes(oracle, requests, rls_pb2):
    from limitador_tpu_torch import Context

    ok, over = (rls_pb2.RateLimitResponse.OK,
                rls_pb2.RateLimitResponse.OVER_LIMIT)
    return [over if oracle.check_rate_limited_and_update(
        ns, _ctx(Context, e), 1, False).limited else ok
        for _h, ns, e in requests]


def _native_counters_equal(label, got, oracle, limits, requests, codes,
                           rls_pb2):
    """The native path's table against the in-memory oracle: the spent
    counters (remaining below the limit) equal the oracle's, and every
    unspent one is a counter of a denied request, whose fresh slot the
    miss lane allocated before the check (ROADMAP Queue C: both packages'
    columnar lanes leave it; the oracle makes none). Returns (spent,
    unspent) counts."""
    maxes = {l.name: l.max_value for l in limits}
    want = set()
    for ns in ("pods", "multi", "glob"):
        want |= _oracle_counters(oracle, ns)
    spent = {c for c in got if c[3] < maxes[c[1]]}
    if spent != want:
        fail(f"{label}: the union of the hosts' spent counters differs from "
             f"the oracle's: {len(spent ^ want)} differences of {len(want)}")
    denied = set()
    for (_h, ns, e), code in zip(requests, codes):
        if code != rls_pb2.RateLimitResponse.OVER_LIMIT:
            continue
        for limit in limits:
            if str(limit.namespace) != ns:
                continue
            denied.add((ns, limit.name, tuple(sorted(
                (v.source, e[v.source.split(".")[-1]])
                for v in limit.variables))))
    stray = [c for c in got - spent if c[:3] not in denied]
    if stray:
        fail(f"{label}: {len(stray)} unspent counters of no denied request: "
             f"{stray[:3]}")
    return len(spent), len(got) - len(spent)


def _pod_sums(http, names):
    return {name: sum(_pod_metric(port, name) for port in http)
            for name in names}


async def _native_pod_flight(tmpdir, card):
    """18d: a pod recording every decision in its flight rings, a short
    serial drive (answers equal to the oracle), then ``_flight_check``."""
    from limitador_tpu_torch.server.limits_file import load_limits_file
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "native pod flight (18d)"
    loop = asyncio.get_running_loop()
    members, _argvs, rls, http, _formed_s = _start_native_pod(
        tmpdir, "flight", label, flight_sample=1)
    limits = load_limits_file(os.path.join(tmpdir, "pod-limits.yaml"))
    launches = []
    try:
        requests = _pod_requests(np.random.default_rng(1820),
                                 POD_FLIGHT_CALLS)
        spec = [(h, _rls_request(rls_pb2, ns, [e])) for h, ns, e in requests]
        codes, _lat = await loop.run_in_executor(
            None, _pod_drive, rls, spec, rls_pb2)
        if codes != _oracle_codes(_pod_oracle(limits), requests, rls_pb2):
            fail(f"{label}: the drive's answers differ from the oracle's")
        out = await loop.run_in_executor(None, _flight_check, http, card)
        out["calls"] = POD_FLIGHT_CALLS
    finally:
        for member in members:
            launches.append(_pod_stop(member, label))
    return [run for run in launches if run is not None], out


def _flight_check(http, card):
    """A manual trigger on host 0; its bundle must hold host 1's rings,
    one of whose pod_forward entries shares a request id with one of
    host 0's."""
    label = "native pod flight (18d)"
    status, out = _http_post(http[0], "/debug/flight/trigger",
                             {"note": "18d"})
    name = out.get("bundle")
    if status != 200 or not out.get("fired") or not name:
        fail(f"{label}: the trigger answered {status} {out}")
    status, body = _http_get(http[0], f"/debug/flight?name={name}")
    if status != 200:
        fail(f"{label}: GET /debug/flight?name={name} answered {status}")
    bundle = json.loads(body)
    peer = bundle.get("peers", {}).get("1") or {}
    if "error" in peer or not peer.get("exemplars"):
        fail(f"{label}: the bundle holds no rings of host 1: {peer}")

    def ids(part):
        return {e.get("request_id") for e in part.get("exemplars", ())
                if e.get("lane") == "pod_forward" and e.get("request_id")}

    mine, theirs = ids(bundle["local"]), ids(peer)
    shared = mine & theirs
    if not shared:
        fail(f"{label}: no pod_forward request id in both hosts' rings "
             f"({len(mine)} on host 0, {len(theirs)} on host 1)")
    out = {"bundle": name, "peer_exemplars": len(peer["exemplars"]),
           "pod_forward_ids": [len(mine), len(theirs)],
           "shared_ids": len(shared), "window": bundle["window"]}
    print(f"{label}: bundle {name} holds host 1's rings "
          f"({out['peer_exemplars']} exemplars); pod_forward request ids "
          f"{len(mine)} on host 0, {len(theirs)} on host 1, {len(shared)} "
          f"in both ({card})", flush=True)
    return out


async def _native_pod_serial(tmpdir, card, base):
    """Phases 18a and 18c on one native pod; ``base`` is 17b torch's
    p50/p99 by verdict."""
    from limitador_tpu_torch.server.limits_file import load_limits_file
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "native pod (18a)"
    loop = asyncio.get_running_loop()
    members, argvs, rls, http, formed_s = _start_native_pod(
        tmpdir, "native", label)
    limits = load_limits_file(os.path.join(tmpdir, "pod-limits.yaml"))
    out = {"formed_s": formed_s}
    launches = []
    try:
        requests = _pod_requests(np.random.default_rng(1718), POD_CALLS)
        spec = [(h, _rls_request(rls_pb2, ns, [e])) for h, ns, e in requests]
        t0 = time.perf_counter()
        codes, lat = await loop.run_in_executor(
            None, _pod_drive, rls, spec, rls_pb2)
        drive_s = time.perf_counter() - t0
        errors = [c for c in codes if isinstance(c, str)]
        if errors:
            fail(f"{label}: {len(errors)} calls failed: {errors[:5]}")
        oracle = _pod_oracle(limits)
        want = _oracle_codes(oracle, requests, rls_pb2)
        differ = sum(a != b for a, b in zip(codes, want))
        if differ:
            fail(f"{label}: {differ} of {POD_CALLS} answers differ from the "
                 "in-memory oracle's")
        got_counters = set()
        for ns in ("pods", "multi", "glob"):
            for port in http:
                got_counters |= _pod_counters(port, ns)
        spent, unspent = _native_counters_equal(
            label, got_counters, oracle, limits, requests, codes, rls_pb2)
        verdicts = _verdicts(requests, limits, [])
        tally = {v: verdicts.count(v) for v in ("local", "forward", "pinned")}
        sums = _pod_sums(http, (
            "pod_hot_local_rows", "pod_hot_foreign_rows",
            "pod_bulk_forward_batches", "pod_bulk_forward_rows",
            "pod_bulk_served_rows", "pod_peer_errors"))
        if not (sums["pod_hot_foreign_rows"] > 0
                and 0 < sums["pod_bulk_forward_batches"]
                <= sums["pod_bulk_forward_rows"]
                == sums["pod_bulk_served_rows"]):
            fail(f"{label}: the split or the bulk lane did not engage: "
                 f"{sums}")
        after = [_pod_launches_now(m, label) for m in members]
        missing = [pid for pid, run in enumerate(after)
                   for k in PHASE18_KERNELS if _launched(run, k) == 0]
        if missing:
            fail(f"{label}: B1 did not launch on members {missing}")
        by = {v: [ms for ms, vv in zip(lat, verdicts) if vv == v]
              for v in ("local", "forward", "pinned")}
        out.update({
            "calls": POD_CALLS, "drive_s": drive_s, "verdicts": tally,
            "counters": spent, "unspent_counters": unspent, "sums": sums,
            "rows_per_bulk": sums["pod_bulk_forward_rows"]
            / sums["pod_bulk_forward_batches"],
            "p50_p99_ms": {v: _pct(ms) for v, ms in by.items()},
            "p50_p99_ms_17b_torch": base,
            "hops": [_hop_split(port) for port in http],
            "b1_by_member": [_launched(run, "check_and_update")
                             for run in after],
        })
        print(f"{label}: pod formed in {formed_s:.2f} s; {POD_CALLS} "
              f"sequential calls alternating hosts in {drive_s:.2f} s, "
              f"every answer and the union of both hosts' {spent} spent "
              f"counters equal to the in-memory oracle ({unspent} unspent, "
              f"each of a denied request); verdicts {json.dumps(tally)}; "
              f"{json.dumps(sums)}; rows a bulk forward "
              f"{out['rows_per_bulk']:.3f}; p50/p99 ms "
              f"{json.dumps(out['p50_p99_ms'])} against 17b torch's "
              f"{json.dumps(base)}; B1 launches by member "
              f"{out['b1_by_member']} ({card})", flush=True)
        killed, out["degraded"] = await _native_pod_drill(
            tmpdir, members, argvs, rls, http, limits, oracle, rls_pb2,
            card)
        launches.append(killed)
    finally:
        for member in members:
            launches.append(_pod_stop(member, label))
    return [run for run in launches if run is not None], out


async def _native_pod_drill(tmpdir, members, argvs, rls, http, limits,
                            oracle, rls_pb2, card):
    """18c: half of POD_DEGRADED_CALLS alternating hosts, host 1 killed,
    the other half to host 0; host 1 restarted and its journal
    replayed. ``oracle`` holds 18a's calls."""
    label = "native pod, dead owner (18c)"
    loop = asyncio.get_running_loop()
    requests = _pod_requests(np.random.default_rng(1819), POD_DEGRADED_CALLS)
    half = POD_DEGRADED_CALLS // 2
    first = requests[:half]
    spec = [(h, _rls_request(rls_pb2, ns, [e])) for h, ns, e in first]
    codes, _lat = await loop.run_in_executor(
        None, _pod_drive, rls, spec, rls_pb2)
    want = _oracle_codes(oracle, first, rls_pb2)
    if codes != want:
        fail(f"{label}: before the kill, "
             f"{sum(a != b for a, b in zip(codes, want))} answers differ")
    killed = _pod_launches_now(members[1], label)
    degraded0 = _pod_metric(http[0], "pod_failover_degraded_decisions")
    members[1]["proc"].kill()
    members[1]["proc"].wait()
    members[1]["log"].close()
    second = [(0, ns, e) for _h, ns, e in requests[half:]]
    spec = [(0, _rls_request(rls_pb2, ns, [e])) for _h, ns, e in second]
    t0 = time.perf_counter()
    codes, lat = await loop.run_in_executor(
        None, _pod_drive, rls, spec, rls_pb2)
    drive_s = time.perf_counter() - t0
    errors = [c for c in codes if isinstance(c, str)]
    if errors:
        fail(f"{label}: {len(errors)} calls failed while host 1 was dead: "
             f"{errors[:5]}")
    verdicts = _verdicts(second, limits, [])
    theirs = [i for i, v in enumerate(verdicts) if v != "local"]
    ours = [i for i, v in enumerate(verdicts) if v == "local"]
    want_ours = _oracle_codes(oracle, [second[i] for i in ours], rls_pb2)
    if [codes[i] for i in ours] != want_ours:
        fail(f"{label}: host 0's own keys answered apart from the oracle")
    stand_in = _pod_oracle(limits)
    want_theirs = _oracle_codes(stand_in, [second[i] for i in theirs],
                                rls_pb2)
    if [codes[i] for i in theirs] != want_theirs:
        fail(f"{label}: host 1's keys answered apart from a fresh oracle "
             "of the calls the stand-in decided")
    degraded = _pod_metric(http[0], "pod_failover_degraded_decisions") - (
        degraded0)
    if degraded != len(theirs):
        fail(f"{label}: {degraded} degraded decisions for {len(theirs)} "
             "calls of host 1's keys")
    journal = _pod_metric(http[0], "pod_failover_journal_depth")
    t_restart = time.monotonic()
    members[1] = _pod_spawn(tmpdir, "pod-native-1b", argvs[1])
    _pod_wait(members[1], http[1], tmpdir, label)
    up_s = time.monotonic() - t_restart
    deadline = time.monotonic() + 90
    while not (_pod_metric(http[0], "pod_failover_journal_depth") == 0
               and _pod_metric(http[0], "pod_failover_reconciles") >= 1):
        if time.monotonic() > deadline:
            fail(f"{label}: the journal never replayed")
        time.sleep(0.05)
    replay_s = time.monotonic() - t_restart
    got, want = set(), set()
    for ns in ("pods", "multi", "glob"):
        got |= _pod_counters(http[1], ns)
        want |= _oracle_counters(stand_in, ns)
    if got != want:
        fail(f"{label}: host 1's counters after the replay differ from the "
             f"oracle of the stand-in's calls: {len(got ^ want)} "
             f"differences of {len(want)}")
    out = {"calls": POD_DEGRADED_CALLS, "after_kill": len(second),
           "host1_calls": len(theirs), "degraded_decisions": degraded,
           "journal": journal, "restart_up_s": up_s, "replay_done_s": replay_s,
           "replayed_counters": len(want), "drive_s": drive_s,
           "p50_p99_ms": _pct(lat)}
    print(f"{label}: {half} calls alternating hosts, host 1 killed, "
          f"{len(second)} to host 0 with no error ({len(theirs)} for host "
          f"1's keys, each a degraded decision, as a fresh oracle decides "
          f"them; p50/p99 {out['p50_p99_ms']} ms); host 1 back in "
          f"{up_s:.2f} s, its journal of {journal:.0f} counters replayed "
          f"{replay_s:.2f} s after the restart, its {len(want)} counters "
          f"equal the oracle's ({card})", flush=True)
    return killed, out


async def _native_pod_concurrent(tmpdir, card):
    """18b: a pod with --native-ingress, POD_CONCURRENT_CALLS from 16
    threads of a client process alternating the hosts' ingresses."""
    from collections import Counter as Tally

    from limitador_tpu_torch.server.limits_file import load_limits_file
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "native ingress pod (18b)"
    members, _argvs, rls, http, formed_s = _start_native_pod(
        tmpdir, "ingress", label, ingress=True)
    limits = load_limits_file(os.path.join(tmpdir, "pod-limits.yaml"))
    launches = []
    try:
        requests = _pod_requests(np.random.default_rng(1718),
                                 POD_CONCURRENT_CALLS)
        src = os.path.join(tmpdir, "pod-blobs.bin")
        dst = os.path.join(tmpdir, "pod-answers.bin")
        lat_path = os.path.join(tmpdir, "pod-lat.bin")
        with open(src, "wb") as f:
            for _h, ns, e in requests:
                b = _rls_request(rls_pb2, ns, [e])
                f.write(len(b).to_bytes(4, "little") + b)
        proc = subprocess.run(
            [sys.executable, "-c", _POD_CLIENT, ",".join(map(str, rls)),
             str(INGRESS_THREADS), src, dst, lat_path],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"{label}: the client process failed:\n"
                 f"{proc.stderr[-3000:]}")
        seconds = json.loads(proc.stdout.strip().splitlines()[-1])["seconds"]
        with open(dst, "rb") as f:
            codes = list(f.read())
        lat = np.fromfile(lat_path, np.float64)
        if 0 in codes or len(codes) != len(requests):
            fail(f"{label}: {codes.count(0)} calls answered neither OK nor "
                 "OVER_LIMIT")
        # every counter admits min(limit, its calls): with the two-limit
        # namespace's total below its 400, no answer depends on the order
        maxes = {l.name: l.max_value for l in limits}
        calls, admitted = Tally(), Tally()
        for (_h, ns, e), code in zip(requests, codes):
            keys = [("per-user" if ns == "pods" else "multi-user"
                     if ns == "multi" else "per-tenant",
                     tuple(sorted(e.items())))]
            if ns == "multi":
                keys.append(("multi-total", ()))
            for key in keys:
                calls[key] += 1
                admitted[key] += code == 1
        total = sum(min(maxes["multi-user"], n) for (name, _k), n
                    in calls.items() if name == "multi-user")
        if total > maxes["multi-total"]:
            fail(f"{label}: the drive reaches multi-total ({total})")
        bad = [key for key, n in calls.items() if key[0] != "multi-total"
               and admitted[key] != min(maxes[key[0]], n)]
        if bad or admitted["multi-total", ()] != total:
            fail(f"{label}: {len(bad)} counters admitted other than "
                 f"min(limit, calls): {bad[:5]}")
        oracle = _pod_oracle(limits)
        ok, over = (rls_pb2.RateLimitResponse.OK,
                    rls_pb2.RateLimitResponse.OVER_LIMIT)
        _oracle_codes(oracle, requests, rls_pb2)
        got_counters = set()
        for ns in ("pods", "multi", "glob"):
            for port in http:
                got_counters |= _pod_counters(port, ns)
        spent, unspent = _native_counters_equal(
            label, got_counters, oracle, limits, requests,
            [ok if c == 1 else over for c in codes], rls_pb2)
        sums = _pod_sums(http, (
            "pod_hot_local_rows", "pod_hot_foreign_rows",
            "pod_bulk_forward_batches", "pod_bulk_forward_rows",
            "pod_bulk_served_rows", "ingress_requests"))
        if not (0 < sums["pod_bulk_forward_batches"]
                <= sums["pod_bulk_forward_rows"]
                == sums["pod_bulk_served_rows"]):
            fail(f"{label}: the bulk lane did not engage: {sums}")
        out = {"calls": len(requests), "threads": INGRESS_THREADS,
               "formed_s": formed_s, "seconds": seconds,
               "decisions_per_s": len(requests) / seconds,
               "p50_p99_ms": _pct(lat.tolist()), "sums": sums,
               "rows_per_bulk": sums["pod_bulk_forward_rows"]
               / sums["pod_bulk_forward_batches"],
               "counters": spent, "unspent_counters": unspent}
    finally:
        for member in members:
            launches.append(_pod_stop(member, label))
    missing = [pid for pid, run in enumerate(launches) if run is None
               or any(_launched(run, k) == 0 for k in PHASE18_KERNELS)]
    if missing:
        fail(f"{label}: B1 did not launch on members {missing}")
    out["b1_by_member"] = [_launched(run, "check_and_update")
                           for run in launches]
    print(f"{label}: {len(requests)} calls from {INGRESS_THREADS} threads "
          f"of a client process alternating the hosts' ingresses in "
          f"{seconds:.3f} s ({out['decisions_per_s']:.0f} decisions/s, "
          f"p50/p99 {out['p50_p99_ms']} ms); each counter admitted "
          f"min(limit, calls), the union of both hosts' {out['counters']} "
          f"spent counters equal to the oracle's "
          f"({out['unspent_counters']} unspent, each of a denied request); "
          f"{json.dumps(sums)}, rows a "
          f"bulk forward {out['rows_per_bulk']:.3f}; B1 launches by member "
          f"{out['b1_by_member']} ({card})", flush=True)
    return launches, out


def phase_native_pod(dev, card, base):
    """Phase 18: the native pod fast path on two server processes of
    the card (a and c on one pod, b on a pod with the ingress, d on a
    pod recording every decision); ``base`` is 17b torch's p50/p99 by
    verdict."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        serial_runs, out = asyncio.run(
            _native_pod_serial(tmpdir, card, base))
    with tempfile.TemporaryDirectory() as tmpdir:
        concurrent_runs, out["concurrent"] = asyncio.run(
            _native_pod_concurrent(tmpdir, card))
    with tempfile.TemporaryDirectory() as tmpdir:
        flight_runs, out["flight"] = asyncio.run(
            _native_pod_flight(tmpdir, card))
    launches = {}
    for run in serial_runs + concurrent_runs + flight_runs:
        for k, v in run.items():
            launches[k] = launches.get(k, 0) + v
    missing = [k for k in PHASE18C_KERNELS if launches.get(k, 0) == 0]
    if missing:
        fail(f"native pod (18c): kernels not launched: {missing}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print(f"native pod: launches in the pods' processes "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; phase 18 "
          f"took {out['seconds']:.1f} s", flush=True)
    return launches, out


# -- phase 19: the elastic pod ---------------------------------------------

#: (a) the calls before and after the join, each; (b) the calls after the
#: drain; (a) at most this many calls while the join runs; (d) the calls
#: before and after its join, each
ELASTIC_CALLS = 750  # 1,500 until phase 20 came in
ELASTIC_DRAIN_CALLS = 500  # 1,000 until phase 20 came in
ELASTIC_DURING_MAX = 400
ELASTIC_SHARDED_CALLS = 300
#: (c): the pause before each slice's copy (the kill lands in it), the
#: transition's bound, and the users of the drill's namespace (limit
#: DRILL_MAX) before the resize and born in its window
ELASTIC_SLICE_PAUSE_MS = 1500
ELASTIC_TIMEOUT_S = 20
ELASTIC_PRE_USERS = 12
ELASTIC_BORN_USERS = 16
#: the members' launches phase 19 gates on: B1 on every member and on the
#: standby; in (a) and (b) B3a's host form (the source's reads), B2's (the
#: receiver's apply) and B3b's (the source's release) on every member
PHASE19_TORCH_KERNELS = ("read_slots_host", "update_host",
                         "clear_slots_host")
#: (d): B7c's host form on the receivers, B7b's on the sources
PHASE19_SHARDED_KERNELS = ("sharded_update_host", "sharded_clear_cells")
#: POD_LIMITS without the psum namespace, on hour-long windows, so that no
#: window rolls within the phase
ELASTIC_LIMITS = POD_LIMITS.split("- namespace: gpsum")[0] + \
    "- namespace: drill" + POD_LIMITS.split("- namespace: drill")[1]
ELASTIC_LIMITS = ELASTIC_LIMITS.replace("seconds: 120", "seconds: 3600")


def _b1(run):
    return (run.get("check_and_update", 0)
            + run.get("check_and_update_cluster", 0))


def _elastic_ports(n):
    """n distinct free local ports."""
    out = []
    while len(out) < n:
        port = _free_ports(1)[0]
        if port not in out:
            out.append(port)
    return out


def _elastic_spawn(tmpdir, tag, storage, extra, env=None, ports=None):
    """Two resize-armed members of ``storage`` on the card (capacity
    1<<20 each) and one warm standby, on ``ports`` (10 distinct free
    ones; pods started together share one allocation); returns (members,
    peer ports, RLS ports, HTTP ports), host 2 the standby."""
    with open(os.path.join(tmpdir, "pod-limits.yaml"), "w") as f:
        f.write(ELASTIC_LIMITS)
    ports = ports or _elastic_ports(10)
    coord = f"127.0.0.1:{ports[0]}"
    peers, rls, http = ports[1:4], ports[4:7], ports[7:10]
    argvs = [_pod_argv(tmpdir, tag, storage, pid, coord, peers[:2], rls,
                       http, ["--capacity", str(C), "--pod-resize", "on",
                              *extra]) for pid in (0, 1)]
    argvs.append([
        os.path.join(tmpdir, "pod-limits.yaml"), storage, "--device", "cuda",
        "--capacity", str(C), "--rls-host", "127.0.0.1",
        "--rls-port", str(rls[2]), "--http-host", "127.0.0.1",
        "--http-port", str(http[2]),
        "--flight-spool-dir", os.path.join(tmpdir, f"flight-{tag}2"),
        "--pod-peer-listen", f"127.0.0.1:{peers[2]}", "--usage-topk", "0",
        "--standby", "on", *extra])
    members = [_pod_spawn(tmpdir, f"elastic-{tag}-{h}", argv, env)
               for h, argv in enumerate(argvs)]
    return members, peers, rls, http


def _elastic_wait(members, http, tmpdir, label):
    for h, member in enumerate(members):
        _pod_wait(member, http[h], tmpdir, label)


def _elastic_calls(rng, n, hosts):
    """17b's requests (pods by user, multi pinned, glob by tenant),
    arriving at hosts ``0 .. hosts - 1`` in turn."""
    return [(i % hosts, ns, e)
            for i, (_h, ns, e) in enumerate(_pod_requests(rng, n))]


def _elastic_drive(rls, requests, oracle, rls_pb2, label):
    """Drive ``requests`` sequentially, each to its arrival host; fail on
    an error or an answer that differs from ``oracle``'s (fed the same
    calls in the same order). Returns the latencies (ms)."""
    from limitador_tpu_torch import Context

    spec = [(h, _rls_request(rls_pb2, ns, [e])) for h, ns, e in requests]
    codes, lat = _pod_drive(rls, spec, rls_pb2)
    errors = [c for c in codes if isinstance(c, str)]
    if errors:
        fail(f"{label}: {len(errors)} calls failed: {errors[:5]}")
    ok, over = (rls_pb2.RateLimitResponse.OK,
                rls_pb2.RateLimitResponse.OVER_LIMIT)
    want = [over if oracle.check_rate_limited_and_update(
        ns, _ctx(Context, e), 1, False).limited else ok
        for _h, ns, e in requests]
    differ = sum(a != b for a, b in zip(codes, want))
    if differ:
        fail(f"{label}: {differ} of {len(requests)} answers differ from the "
             "in-memory oracle's")
    return lat


def _elastic_counters(http, hosts, limits, label):
    """The union of the hosts' spent counters (remaining below the limit),
    each checked to live on exactly its owner under a ``hosts``-host
    topology (a pinned namespace's on its pin host)."""
    from limitador_tpu_torch.routing import PodRouter, PodTopology

    router = PodRouter(PodTopology(hosts=hosts, host_id=0,
                                   shards_per_host=1))
    router.configure(limits, [])
    pinned = router.pinned_map()
    by_name = {lim.name: lim for lim in limits}
    union = set()
    for host, port in enumerate(http):
        for ns in ("pods", "multi", "glob", "drill"):
            status, body = _http_get(port, f"/counters/{ns}")
            if status != 200:
                fail(f"{label}: GET /counters/{ns} on host {host} "
                     f"answered {status}")
            for c in json.loads(body):
                limit = by_name[c["limit"]["name"]]
                if c["remaining"] >= limit.max_value:
                    continue  # unspent: a denied request's other limit
                vars_ = tuple(sorted(c["set_variables"].items()))
                owner = pinned.get(ns)
                if owner is None:
                    owner = router.topology.owner_host(
                        (limit._identity, vars_))
                if owner != host:
                    fail(f"{label}: host {host} holds {ns}/{limit.name} "
                         f"{vars_}, which host {owner} owns under "
                         f"{hosts} hosts")
                entry = (ns, limit.name, vars_, c["remaining"])
                if entry in union:
                    fail(f"{label}: {entry} lives on two hosts")
                union.add(entry)
    return union


def _oracle_spent(oracle, namespaces=("pods", "multi", "glob", "drill")):
    return {(ns, c.limit.name, tuple(sorted(c.set_variables.items())),
             c.remaining)
            for ns in namespaces for c in oracle.get_counters(ns)
            if c.remaining < c.max_value}


def _elastic_stats(http, names):
    return {name: sum(_pod_metric(port, name) for port in http)
            for name in names}


def _stable_users(limits, n, rng):
    """Zipf-0.99 users of the ``pods`` namespace whose counter has the same
    owner under 2 and under 3 hosts (no slice of theirs moves)."""
    from limitador_tpu_torch.routing import PodTopology

    limit = next(lim for lim in limits if lim.namespace == "pods")
    two, three = PodTopology(2, 0, 1), PodTopology(3, 0, 1)
    out = []
    for u in zipf_keys(C, 8 * n, 0.99, rng).tolist():
        key = (limit._identity, (("descriptors[0].user", f"u{u}"),))
        if two.owner_host(key) == three.owner_host(key):
            out.append(u)
        if len(out) == n:
            break
    return out


def _events_order(port, kinds):
    status, body = _http_get(port, "/debug/events")
    if status != 200:
        return None
    seq = {}
    for event in json.loads(body)["events"]:
        seq.setdefault(event["kind"], event["seq"])
    return [seq.get(k) for k in kinds]


def _elastic_grow_drain(tmpdir, card):
    """Phases 19a and 19b: two native members and a native warm standby
    on torch; ELASTIC_CALLS calls, the join (with calls for users whose
    slices do not move while it runs), ELASTIC_CALLS calls over the three
    hosts, then a drain back to two and ELASTIC_DRAIN_CALLS calls."""
    from limitador_tpu_torch.server.limits_file import load_limits_file
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "elastic pod (19a, torch native)"
    native = ["--pipeline", "native", "--native-hot-lane", "on",
              "--rate-limit-headers", "NONE"]
    t0 = time.perf_counter()
    members, peers, rls, http = _elastic_spawn(tmpdir, "grow", "torch",
                                               native)
    out = {}
    runs = [None, None, None]
    try:
        _elastic_wait(members, http, tmpdir, label)
        out["formed_s"] = time.perf_counter() - t0
        limits = load_limits_file(os.path.join(tmpdir, "pod-limits.yaml"))
        oracle = _pod_oracle(limits)
        # the standby's warm-up: its B1 and B2 launches so far, all of it
        warm_run = _pod_launches_now(members[2], label)
        status, body = _http_get(http[2], "/debug/pod/standby")
        standby = json.loads(body) if status == 200 else {}
        warmed = _b1(warm_run) + warm_run.get("update_host", 0)
        if status != 200 or standby.get("standby_warm_kernels") != warmed \
                or warmed == 0:
            fail(f"{label}: standby_warm_kernels "
                 f"{standby.get('standby_warm_kernels')} where the standby "
                 f"launched B1 and B2 {warmed} times ({status})")
        rng = np.random.default_rng(1919)
        lat_before = _elastic_drive(
            rls, _elastic_calls(rng, ELASTIC_CALLS, 2), oracle, rls_pb2,
            label + " before the join")
        joined = {}

        def join():
            t = time.perf_counter()
            joined["resp"] = _http_post(
                http[0], "/debug/pod/join",
                {"address": f"127.0.0.1:{peers[2]}"})
            joined["seconds"] = time.perf_counter() - t

        thread = threading.Thread(target=join, daemon=True)
        thread.start()
        stable = _stable_users(limits, ELASTIC_DURING_MAX, rng)
        during, lat_during = 0, []
        while thread.is_alive() and during < len(stable):
            lat_during += _elastic_drive(
                rls, [(during % 2, "pods",
                       {"user": f"u{stable[during]}"})], oracle, rls_pb2,
                label + " during the join")
            during += 1
        thread.join(timeout=180)
        status, resp = joined.get("resp", (None, {}))
        if status != 200 or not resp.get("ok"):
            fail(f"{label}: POST /debug/pod/join answered {status}: "
                 f"{json.dumps(resp)[:800]}")
        lat_after = _elastic_drive(
            rls, _elastic_calls(rng, ELASTIC_CALLS, 3), oracle, rls_pb2,
            label + " after the join")
        union = _elastic_counters(http, 3, limits, label)
        if union != _oracle_spent(oracle):
            fail(f"{label}: the hosts' spent counters differ from the "
                 f"oracle's: {len(union ^ _oracle_spent(oracle))} "
                 "differences")
        epochs = {json.loads(_http_get(port, "/debug/pod/resize")[1])[
            "topology_epoch"] for port in http}
        if len(epochs) != 1:
            fail(f"{label}: the hosts' topology epochs differ: {epochs}")
        order = _events_order(http[0], ("join_begin", "epoch_bump",
                                        "join_end"))
        if None in order or not order[0] < order[1] < order[2]:
            fail(f"{label}: host 0's events join_begin, epoch_bump, "
                 f"join_end at {order}")
        completed = _pod_metric(http[0], "join_completed")
        ttfd = _pod_metric(http[2], "join_ttfd_seconds")
        if completed != 1 or ttfd <= 0:
            fail(f"{label}: join_completed {completed}, joiner's "
                 f"join_ttfd_seconds {ttfd}")
        moved = _elastic_stats(http, ("pod_resize_slices_moved",
                                      "pod_resize_moved_deltas",
                                      "pod_resize_released_counters"))
        out.update({
            "join_s": joined["seconds"], "join": resp,
            "ttfd_s": ttfd, "moved": moved, "epoch": epochs.pop(),
            "during_calls": during, "counters": len(union),
            "p50_p99_ms": {"before": _pct(lat_before),
                           "during": _pct(lat_during),
                           "after": _pct(lat_after)},
            "warm_kernels": warmed,
        })
        print(f"{label}: pod formed in {out['formed_s']:.2f} s; "
              f"{ELASTIC_CALLS} calls on two hosts, the join of the "
              f"standby as host 2 in {joined['seconds']:.3f} s "
              f"(join_seconds {resp.get('join_seconds')}, ttfd "
              f"{ttfd:.6f} s, {resp.get('seeded')} plans seeded) with "
              f"{during} calls during it, {ELASTIC_CALLS} calls on three "
              f"hosts: every answer and the hosts' {len(union)} spent "
              f"counters, each on its owner, equal to the in-memory "
              f"oracle; moved {json.dumps(moved)}; standby warm-up "
              f"{warmed} kernel launches; p50/p99 ms "
              f"{json.dumps(out['p50_p99_ms'])} ({card})", flush=True)
        # (b) the drain back to two hosts, within the windows
        label_b = "elastic pod (19b, drain)"
        t = time.perf_counter()
        status, resp = _http_post(http[0], "/debug/pod/resize", {"hosts": 2})
        drain_s = time.perf_counter() - t
        if status != 200 or not resp.get("ok"):
            fail(f"{label_b}: POST /debug/pod/resize answered {status}: "
                 f"{json.dumps(resp)[:800]}")
        lat_drain = _elastic_drive(
            rls[:2], _elastic_calls(rng, ELASTIC_DRAIN_CALLS, 2), oracle,
            rls_pb2, label_b)
        union = _elastic_counters(http, 2, limits, label_b)
        if union != _oracle_spent(oracle):
            fail(f"{label_b}: the hosts' spent counters differ from the "
                 f"oracle's: {len(union ^ _oracle_spent(oracle))} "
                 "differences")
        moved_b = _elastic_stats(http, ("pod_resize_slices_moved",
                                        "pod_resize_released_counters"))
        out["drain"] = {"seconds": drain_s, "p50_p99_ms": _pct(lat_drain),
                        "counters": len(union), "moved": moved_b}
        print(f"{label_b}: drained to 2 hosts in {drain_s:.3f} s; "
              f"{ELASTIC_DRAIN_CALLS} calls: every answer and the hosts' "
              f"{len(union)} spent counters (those that moved out in 19a "
              f"and back now among them) equal to the oracle; p50/p99 ms "
              f"{json.dumps(_pct(lat_drain))} ({card})", flush=True)
    finally:
        for h, member in enumerate(members):
            runs[h] = _pod_stop(member, label)
    for h, run in enumerate(runs):
        missing = [k for k in PHASE19_TORCH_KERNELS
                   if not run or run.get(k, 0) == 0]
        if not run or _b1(run) == 0:
            missing.append("check_and_update")
        if missing:
            fail(f"{label}: host {h} launched none of {missing}")
    out["launches"] = runs
    return runs, out


def _elastic_abort(tmpdir, card, pod):
    """Phase 19c on a pod spawned by ``_elastic_spawn`` (torch, the
    standard pipeline, the slice pause on): the standby's join starts a
    2 -> 3 resize, the new host is killed in the pause before the first
    slice's copy, and the pod reverts to 2 hosts with no call failed and
    nothing admitted lost."""
    from limitador_tpu_torch.server.limits_file import load_limits_file
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "elastic pod (19c, abort)"
    members, peers, rls, http = pod
    limits = load_limits_file(os.path.join(tmpdir, "pod-limits.yaml"))
    oracle = _pod_oracle(limits)
    pre = [{"user": f"pre-{i}"} for i in range(ELASTIC_PRE_USERS)]
    born = [{"user": f"born-{i}"} for i in range(ELASTIC_BORN_USERS)]
    _elastic_drive(rls[:2], [(i % 2, "drill", e)
                             for _ in range(3) for i, e in enumerate(pre)],
                   oracle, rls_pb2, label + " before the resize")
    joined = {}

    def join():
        joined["resp"] = _http_post(
            http[0], "/debug/pod/join", {"address": f"127.0.0.1:{peers[2]}"})

    thread = threading.Thread(target=join, daemon=True)
    thread.start()
    def committed(port):
        status, body = _http_get(port, "/debug/pod/resize")
        transition = json.loads(body).get("transition") \
            if status == 200 else None
        return bool(transition) and transition["state"] in ("migrating",
                                                            "done")

    # mid-migration: the new host has committed, and a source's first
    # slice has begun (its copy waits out the slice pause)
    deadline = time.monotonic() + 60
    while True:
        if committed(http[2]) and any(
                _events_order(port, ("migrate_begin",)) not in (None, [None])
                for port in http[:2]):
            break
        if time.monotonic() > deadline or not thread.is_alive():
            fail(f"{label}: no migration began ({joined})")
        time.sleep(0.02)
    t_kill = time.monotonic()
    members[2]["proc"].kill()
    members[2]["proc"].wait()
    # the window: calls for users born in it, none of which may fail
    admitted = {e["user"]: 0 for e in born}
    rounds = 0
    spec = [(i % 2, _rls_request(rls_pb2, "drill", [e]))
            for i, e in enumerate(born)]
    ok = rls_pb2.RateLimitResponse.OK
    from limitador_tpu_torch import Context

    def one_round():
        codes, _lat = _pod_drive(rls[:2], spec, rls_pb2)
        errors = [c for c in codes if isinstance(c, str)]
        if errors:
            fail(f"{label}: {len(errors)} calls failed in the window: "
                 f"{errors[:5]}")
        for e, code in zip(born, codes):
            admitted[e["user"]] += code == ok
            oracle.check_rate_limited_and_update(
                "drill", _ctx(Context, e), 1, False)

    while thread.is_alive() and rounds < DRILL_MAX - 2:
        one_round()
        rounds += 1
    thread.join(timeout=120)
    abort_s = time.monotonic() - t_kill
    status, resp = joined.get("resp", (None, {}))
    if resp.get("ok") or not resp.get("aborted"):
        fail(f"{label}: the join did not abort ({status}: "
             f"{json.dumps(resp)[:600]})")
    for h in (0, 1):
        state = json.loads(_http_get(http[h], "/debug/pod/resize")[1])
        if state["hosts"] != 2 or state["topology_epoch"] < 2:
            fail(f"{label}: host {h} on {state['hosts']} hosts at epoch "
                 f"{state['topology_epoch']} after the abort")
    if _pod_metric(http[0], "pod_resize_aborted") != 1:
        fail(f"{label}: pod_resize_aborted is not 1 on host 0")
    deadline = time.monotonic() + 30
    while sum(_pod_metric(port, "pod_failover_journal_depth")
              for port in http[:2]) > 0:
        if time.monotonic() > deadline:
            fail(f"{label}: the stand-ins' journals never drained")
        time.sleep(0.1)
    for _ in range(2):
        one_round()
    got = {}
    for h in (0, 1):
        for c in json.loads(_http_get(http[h], "/counters/drill")[1]):
            user = c["set_variables"]["descriptors[0].user"]
            got[user] = got.get(user, 0) + DRILL_MAX - c["remaining"]
    want = {c.set_variables["descriptors[0].user"]: DRILL_MAX - c.remaining
            for c in oracle.get_counters("drill")}
    for e in born:
        u = e["user"]
        if got.get(u, 0) != want.get(u, 0) or admitted[u] != rounds + 2:
            fail(f"{label}: window-born {u} spent {got.get(u, 0)} of "
                 f"{want.get(u, 0)}, admitted {admitted[u]} of {rounds + 2}")
    for e in pre:
        u = e["user"]
        if not want.get(u, 0) <= got.get(u, 0) <= want.get(u, 0) + DRILL_MAX:
            fail(f"{label}: pre-resize {u} spent {got.get(u, 0)} where the "
                 f"oracle spent {want.get(u, 0)} (bound +{DRILL_MAX})")
    out = {"abort_s": abort_s, "window_rounds": rounds,
           "join": resp, "born": len(born), "pre": len(pre)}
    print(f"{label}: the new host killed in the slice pause; the pod "
          f"reverted to 2 hosts {abort_s:.3f} s after the kill with "
          f"pod_resize_aborted 1; {rounds + 2} rounds of "
          f"{len(born)} window-born users with no call failed, each "
          f"counter equal to the oracle's; {len(pre)} earlier users within "
          f"the degraded-window bound ({card})", flush=True)
    return out


def _elastic_sharded(tmpdir, card, pod):
    """Phase 19d on a pod spawned by ``_elastic_spawn`` (sharded, the
    compiled pipeline): calls, the standby's join, calls over the three
    hosts, every answer and spent counter equal to the oracle."""
    from limitador_tpu_torch.server.limits_file import load_limits_file
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "elastic pod (19d, sharded compiled)"
    members, peers, rls, http = pod
    limits = load_limits_file(os.path.join(tmpdir, "pod-limits.yaml"))
    oracle = _pod_oracle(limits)
    rng = np.random.default_rng(1920)
    _elastic_drive(rls, _elastic_calls(rng, ELASTIC_SHARDED_CALLS, 2),
                   oracle, rls_pb2, label + " before the join")
    t = time.perf_counter()
    status, resp = _http_post(http[0], "/debug/pod/join",
                              {"address": f"127.0.0.1:{peers[2]}"})
    join_s = time.perf_counter() - t
    if status != 200 or not resp.get("ok"):
        fail(f"{label}: POST /debug/pod/join answered {status}: "
             f"{json.dumps(resp)[:800]}")
    _elastic_drive(rls, _elastic_calls(rng, ELASTIC_SHARDED_CALLS, 3),
                   oracle, rls_pb2, label + " after the join")
    union = _elastic_counters(http, 3, limits, label)
    if union != _oracle_spent(oracle):
        fail(f"{label}: the hosts' spent counters differ from the oracle's")
    print(f"{label}: joined in {join_s:.3f} s; {2 * ELASTIC_SHARDED_CALLS} "
          f"calls: every answer and the hosts' {len(union)} spent counters "
          f"equal to the oracle ({card})", flush=True)
    return {"join_s": join_s, "counters": len(union)}


def phase_elastic(card):
    """Phase 19: the elastic pod on the card: a grow by join and a drain
    on native torch members (a, b), an abort with nothing lost (c) and a
    grow on the sharded table (d). The pods of c and d start together."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        grow_runs, out = _elastic_grow_drain(tmpdir, card)
    env = {"TPU_POD_RESIZE_SLICE_PAUSE_MS": str(ELASTIC_SLICE_PAUSE_MS),
           "TPU_POD_RESIZE_TIMEOUT_S": str(ELASTIC_TIMEOUT_S)}
    with tempfile.TemporaryDirectory() as abort_dir, \
            tempfile.TemporaryDirectory() as sharded_dir:
        ports = _elastic_ports(20)
        abort_pod = _elastic_spawn(abort_dir, "abort", "torch", [], env,
                                   ports[:10])
        sharded_pod = _elastic_spawn(sharded_dir, "sharded", "sharded",
                                     ["--pipeline", "compiled"], None,
                                     ports[10:])
        abort_runs, sharded_runs = [], []
        try:
            _elastic_wait(abort_pod[0], abort_pod[3], abort_dir,
                          "elastic pod (19c)")
            _elastic_wait(sharded_pod[0], sharded_pod[3], sharded_dir,
                          "elastic pod (19d)")
            out["abort"] = _elastic_abort(abort_dir, card, abort_pod)
            out["sharded"] = _elastic_sharded(sharded_dir, card, sharded_pod)
        finally:
            for member in abort_pod[0]:
                abort_runs.append(_pod_stop(member, "elastic pod (19c)"))
            for member in sharded_pod[0]:
                sharded_runs.append(_pod_stop(member, "elastic pod (19d)"))
    total = {}
    for run in grow_runs + abort_runs + sharded_runs:
        for k, v in (run or {}).items():
            total[k] = total.get(k, 0) + v
    missing = [k for k in PHASE19_SHARDED_KERNELS if total.get(k, 0) == 0]
    for h, run in enumerate(sharded_runs[:2]):
        if not run or run.get("sharded_check_and_update", 0) + run.get(
                "sharded_check_and_update_cluster", 0) == 0:
            missing.append(f"B7a on host {h}")
    if not sharded_runs[2] or _b1(sharded_runs[2]) == 0:
        missing.append("B1 on the sharded standby")
    if missing:
        fail(f"elastic pod (19d): kernels not launched: {missing}")
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t0
    print(f"elastic pod: launches in the pods' processes "
          f"{json.dumps({k: v for k, v in total.items() if v})}; phase 19 "
          f"took {out['seconds']:.1f} s", flush=True)
    return total, out


# -- phase 20: the capacity controller and redis_import ------------------------

CTL_YAML = """\
- namespace: ctl
  max_value: 40
  seconds: 3600
  variables: ["descriptors[0].user"]
  name: ctl-per-user
"""
#: 20a: bursts of distinct Zipf users, sent to each server in turn
CTL_ROUNDS = 40
CTL_BURST = 32
CTL_USERS = 400
#: 20a: a p99 budget the card's served p99 does not meet, so that the SLO
#: burns and the controller's pressure is real; and its tick
CTL_BUDGET_MS = 0.01
CTL_INTERVAL_S = 0.2
#: 20b: the injected-snapshot drill's clocks (s of its own clock, which
#: each step advances by 0.1) and the calls between two ticks
CTL_SUSTAIN_S = 0.4
CTL_DWELL_S = 1.0
CTL_ROUND = 24
#: 20c: the dump's replayable counters, unreplayable ones (conditions on
#: fields that are not the counter's variables), expired and nil lines
IMPORT_COUNTERS = 1000
IMPORT_UNREPLAYABLE = 100
IMPORT_EXPIRED = 50
IMPORT_NIL = 10
IMPORT_YAML = """\
- namespace: mig
  max_value: 1000
  seconds: 3600
  variables: ["descriptors[0].u"]
  name: per-u
- namespace: mig
  max_value: 500
  seconds: 3600
  conditions: ["descriptors[0].plan == 'gold'"]
  variables: ["descriptors[0].u"]
  name: gold
- namespace: api
  max_value: 100
  seconds: 60
  conditions: ["descriptors[0].method == 'GET'"]
  variables: ["descriptors[0].user"]
  name: configmap
"""


def _ctl_planners(srv):
    """Every ChunkPlanner a served build decides through: each batcher
    pair's, the compiled limiter's and the native pipeline's."""
    counters = srv.limiter.storage.counters
    out = [mb.chunk_planner for mb, _ub in counters._batcher_pairs()]
    for owner in (getattr(srv.limiter, "wrapped", srv.limiter),
                  srv.native_pipeline):
        planner = getattr(owner, "chunk_planner", None)
        if planner is not None:
            out.append(planner)
    return out


def _ctl_knobs_hold(srv, section, label):
    """The subsystems a stopped controller moved read what its
    ``/debug/stats`` section says."""
    knobs = section["knobs"]
    admission = srv.admission
    live = {
        "admission_ceiling": float(admission.overload.max_inflight),
        "shed_floor": float(admission.shed_floor),
        "lease_scale": float(srv.native_pipeline.lease_broker.grant_scale),
    }
    targets = {round(p.target_s * 1e3, 4) for p in _ctl_planners(srv)}
    if len(targets) != 1:
        fail(f"{label}: the planners' targets differ: {sorted(targets)} ms")
    live["chunk_target_ms"] = targets.pop()
    live = {k: round(v, 4) for k, v in live.items()}
    if live != knobs:
        fail(f"{label}: the subsystems read {live} where /debug/stats "
             f"controller says {knobs}")
    return live


def _ctl_envelopes(decisions, specs, label):
    """Every applied knob inside its KnobSpec bounds and one tick's slew
    of the value it moved from; returns each knob's path over the
    ticks."""
    from limitador_tpu_torch.control import KnobSpec

    by_name = {s["name"]: KnobSpec(**s) for s in specs}
    path = {name: [] for name in by_name}
    for d in decisions:
        for name, value in d["current"].items():
            path[name].append(value)
        for name, value in d["applied"].items():
            spec = by_name[name]
            cur = d["current"][name]
            step = spec.max_step(cur)
            # the envelope's ends, rounded as an integer knob rounds
            low, high = spec.clamp(cur - step), spec.clamp(cur + step)
            if not (spec.lo <= value <= spec.hi
                    and low - 1e-3 <= value <= high + 1e-3):
                fail(f"{label}: {name} moved {cur} -> {value}, outside "
                     f"[{low}, {high}] of {spec.to_dict()}")
    return path


async def _ctl_served(tmpdir, dev, card):
    """Phase 20a: three native servers on the card with leases, the usage
    observatory and ``--admission-mode enforce`` under one served load
    (bursts of distinct Zipf users, each server in turn): the capacity
    controller ``off``, ``observe`` and ``on``, ticking every
    ``CTL_INTERVAL_S`` against an SLO budget the card misses. observe
    answers byte-equal with off, and so are its settled counters; on
    applies knobs inside their envelopes that the subsystems then read,
    and its counters equal an oracle fed the hits it admitted, every
    other answer an OVER_LIMIT or an admission shed counted in
    ``admission_sheds``."""
    import grpc

    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "capacity controller (20a, served knobs)"
    limits = os.path.join(tmpdir, "limits.yaml")
    with open(limits, "w") as f:
        f.write(CTL_YAML)
    parse = server.build_parser().parse_args
    clock = ManualClock()
    common = ["--device", dev.type, "--rls-host", "127.0.0.1",
              "--pipeline", "native", "--native-hot-lane", "on",
              "--rate-limit-headers", "NONE", "--lease-mode", "on",
              "--admission-mode", "enforce", "--usage-drain-interval",
              "0.2", "--slo-budget-ms", str(CTL_BUDGET_MS),
              "--ctl-interval", str(CTL_INTERVAL_S)]
    modes = ("off", "observe", "on")
    ports = dict(zip(modes, _free_ports(3)))
    http, servers, failures = {}, {}, []
    loop = asyncio.get_running_loop()
    try:
        for mode in modes:
            http_options, http[mode] = _http_options()
            servers[mode] = await server.start(parse(
                [limits, "torch", *common, *http_options,
                 "--rls-port", str(ports[mode]),
                 "--flight-spool-dir", os.path.join(tmpdir, f"spool-{mode}"),
                 "--capacity-controller", mode]),
                clock=clock, on_failure=failures.append)
        rng = np.random.default_rng(2020)
        bursts = []
        for _ in range(CTL_ROUNDS):
            drawn = zipf_keys(CTL_USERS, 4 * CTL_BURST, 0.99, rng).tolist()
            bursts.append(list(dict.fromkeys(drawn))[:CTL_BURST])
        blobs = {u: _rls_request(rls_pb2, "ctl", [{"user": f"c{u}"}])
                 for burst in bursts for u in burst}
        channels = {m: grpc.aio.insecure_channel(f"127.0.0.1:{p}")
                    for m, p in ports.items()}
        answers = {m: [] for m in modes}

        async def call(mode, user):
            try:
                return ("raw", await channels[mode].unary_unary(ENVOY_PATH)(
                    blobs[user], timeout=60))
            except grpc.aio.AioRpcError as exc:
                return ("error", exc.code().name, exc.details() or "")

        t0 = time.perf_counter()
        try:
            for i, burst in enumerate(bursts):
                for mode in modes[i % 3:] + modes[:i % 3]:
                    got = await asyncio.gather(*[call(mode, u)
                                                 for u in burst])
                    answers[mode].extend(zip(burst, got))
        finally:
            for ch in channels.values():
                await ch.close()
        drive_s = time.perf_counter() - t0
        on = servers["on"]
        deadline = time.monotonic() + 20
        while on.controller.stats()["ctl_ticks"] < 8:
            if time.monotonic() > deadline:
                fail(f"{label}: the controller ticked "
                     f"{on.controller.stats()['ctl_ticks']} times")
            await asyncio.sleep(0.05)
        # freeze the knobs, then let every lease expire and settle
        for mode in ("observe", "on"):
            await loop.run_in_executor(None, servers[mode].controller.close)
        deadline = time.monotonic() + 20
        while any(s.native_pipeline.lease_broker.stats()[
                "lease_outstanding_tokens"] for s in servers.values()):
            if time.monotonic() > deadline:
                fail(f"{label}: leases still outstanding after 20 s")
            await asyncio.sleep(0.05)
        stats, families, spent = {}, {}, {}
        for mode, srv in servers.items():
            stats[mode] = json.loads(await _served_get(http[mode],
                                                       "/debug/stats"))
            families[mode] = await _served_metrics(http[mode])
            spent[mode] = {
                c.set_variables["descriptors[0].user"]:
                c.limit.max_value - c.remaining
                for c in await srv.limiter.get_counters("ctl")
                if c.remaining < c.limit.max_value}
        section = stats["on"]["controller"]
        live = _ctl_knobs_hold(on, section, label)
        observe_section = stats["observe"]["controller"]
        ring = list(on.controller._ring)
        observe_ring = list(servers["observe"].controller._ring)
        snapshot = on.signal_bus.snapshot().to_dict()
        if failures:
            fail(f"{label}: a background tier failed: {failures[0]!r}")
    finally:
        for srv in servers.values():
            await srv.stop()
    # observe against off: every answer and every settled counter
    differ = sum(a != b for a, b in zip(answers["observe"], answers["off"]))
    if differ or len(answers["observe"]) != len(answers["off"]):
        fail(f"{label}: {differ} of {len(answers['off'])} observe answers "
             "differ from the off server's")
    if spent["observe"] != spent["off"]:
        fail(f"{label}: the observe server's counters differ from the off "
             "server's")
    if observe_section["actuations"] or observe_section["knobs"] != {
            "admission_ceiling": 4096.0, "shed_floor": 0.0,
            "chunk_target_ms": 2.0, "lease_scale": 1.0}:
        fail(f"{label}: the observe controller moved a knob: "
             f"{observe_section['actuations']} {observe_section['knobs']}")
    # on: envelopes, the oracle of what it admitted, the sheds
    paths = _ctl_envelopes(ring, section["specs"], label)
    if not section["actuations"]:
        fail(f"{label}: the on controller moved no knob under a budget of "
             f"{CTL_BUDGET_MS} ms (pressure {ring[-1]['proposal']})")
    ok_code = rls_pb2.RateLimitResponse.OK
    over_code = rls_pb2.RateLimitResponse.OVER_LIMIT
    admitted, tally, shed_reasons = {}, {}, {}
    for user, got in answers["on"]:
        if got[0] == "raw":
            code = rls_pb2.RateLimitResponse.FromString(got[1]).overall_code
            kind = {ok_code: "OK", over_code: "OVER_LIMIT"}.get(code, code)
            if code == ok_code:
                admitted[f"c{user}"] = admitted.get(f"c{user}", 0) + 1
        elif got[1] == "UNAVAILABLE" and "admission shed (" in got[2]:
            reason = got[2].split("admission shed (")[1].split(",")[0]
            shed_reasons[reason] = shed_reasons.get(reason, 0) + 1
            kind = "shed:" + reason
        else:
            fail(f"{label}: a call failed: {got}")
        tally[kind] = tally.get(kind, 0) + 1
    if spent["on"] != admitted:
        bad = sorted(set(spent["on"].items()) ^ set(admitted.items()))
        fail(f"{label}: the on server's counters differ from the oracle of "
             f"its admitted hits: {bad[:6]}")
    for reason in ("deadline", "overload", "controller"):
        family = _metric(families["on"], "admission_sheds", reason=reason)
        if family != shed_reasons.get(reason, 0):
            fail(f"{label}: admission_sheds{{reason={reason}}} {family} for "
                 f"{shed_reasons.get(reason, 0)} shed answers")
    for mode, want in zip(modes, (0.0, 1.0, 2.0)):
        fams = families[mode]
        missing = [f for f in ("ctl_mode", "ctl_knob", "ctl_actuations",
                               "ctl_membership_actions",
                               "ctl_interlock_holds", "ctl_objective",
                               "ctl_pressure") if f not in fams]
        if missing or _metric(fams, "ctl_mode") != want:
            fail(f"{label}: the {mode} server's ctl_* families: missing "
                 f"{missing}, ctl_mode {_metric(fams, 'ctl_mode')}")
    live_bus = {k: snapshot[k] for k in (
        "queue_wait_ms", "slo_burn_5m", "slo_breached",
        "capacity_headroom_ratio", "model_r2", "model_drift",
        "near_exhaustion")}
    proposals = [d["proposal"] for d in observe_ring]
    out = {
        "drive_s": drive_s, "calls": len(answers["on"]),
        "ticks": section["ticks"], "actuations": section["actuations"],
        "knobs": live, "paths": paths, "answers_on": tally,
        "sheds": shed_reasons, "admitted": sum(admitted.values()),
        "live_bus": live_bus,
        "observe_pressure": [p["pressure"] for p in proposals],
        "observe_reasons": sorted({p["reason"] for p in proposals}),
        "observe_terms": proposals[-1]["terms"] if proposals else None,
        "observe_targets": proposals[-1]["targets"] if proposals else None,
    }
    for name, values in paths.items():
        print(f"{label}: {name} over the on server's {len(values)} ticks: "
              f"{values}", flush=True)
    print(f"{label}: {len(answers['off'])} calls a server in {drive_s:.2f} s "
          f"(3 servers); observe answers and counters byte-equal with off; "
          f"on: {json.dumps(tally)}, counters equal the oracle of its "
          f"{out['admitted']} admitted hits, sheds {json.dumps(shed_reasons)} "
          f"as counted; knobs {json.dumps(live)} as the subsystems read "
          f"them; the live bus {json.dumps(live_bus)}, the observe "
          f"policy's reasons {out['observe_reasons']} ({card})", flush=True)
    return out


class _LoopThread:
    """An event loop on a thread of its own: an in-process server serves
    on it while the calling thread drives calls and controller ticks."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=300):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        self.run(self.loop.shutdown_default_executor())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.loop.close()


def _ctl_membership(tmpdir, card):
    """Phase 20b: phase 19's pod (two native torch members with
    ``--pod-resize on`` and a ``--standby on`` process, all on the card)
    with member 0 in this process, where a capacity controller runs
    ``on`` over its coordinator (``standby_addresses=[standby]``,
    ``min_hosts=2, max_hosts=3``), ticked with injected snapshots (calm,
    burn, ramp noise, idle) on a clock of its own. Calls run throughout:
    while a tick runs, calls of users whose slices do not move; after
    each tick, a round over the current hosts. One grow and one drain,
    no call failed, every answer and every spent counter (each on its
    owner) the oracle's, the causal chain, the standby's address back in
    the pool."""
    from limitador_tpu_torch.control import CapacityController, ServerActuator
    from limitador_tpu_torch.observability.signals import ControlSignals
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.limits_file import load_limits_file
    from limitador_tpu_torch.server.proto import rls_pb2

    label = "capacity controller (20b, membership)"
    native = ["--pipeline", "native", "--native-hot-lane", "on",
              "--rate-limit-headers", "NONE"]
    with open(os.path.join(tmpdir, "pod-limits.yaml"), "w") as f:
        f.write(ELASTIC_LIMITS)
    ports = _elastic_ports(10)
    coord = f"127.0.0.1:{ports[0]}"
    peers, rls, http = ports[1:4], ports[4:7], ports[7:10]
    argvs = [_pod_argv(tmpdir, "ctl", "torch", pid, coord, peers[:2], rls,
                       http, ["--capacity", str(C), "--pod-resize", "on",
                              *native]) for pid in (0, 1)]
    standby_argv = [
        os.path.join(tmpdir, "pod-limits.yaml"), "torch", "--device", "cuda",
        "--capacity", str(C), "--rls-host", "127.0.0.1",
        "--rls-port", str(rls[2]), "--http-host", "127.0.0.1",
        "--http-port", str(http[2]),
        "--flight-spool-dir", os.path.join(tmpdir, "flight-ctl2"),
        "--pod-peer-listen", f"127.0.0.1:{peers[2]}", "--usage-topk", "0",
        "--standby", "on", *native]
    t0 = time.perf_counter()
    members = [_pod_spawn(tmpdir, "ctl-1", argvs[1]),
               _pod_spawn(tmpdir, "ctl-2", standby_argv)]
    runs = [None, None, None]
    loop = _LoopThread()
    srv = None
    before = dict(K.launches)
    out = {}
    try:
        srv = loop.run(server.start(server.build_parser().parse_args(
            argvs[0])), timeout=300)
        for h, member in ((1, members[0]), (2, members[1])):
            _pod_wait(member, http[h], tmpdir, label)
        out["formed_s"] = time.perf_counter() - t0
        limits = load_limits_file(os.path.join(tmpdir, "pod-limits.yaml"))
        oracle = _pod_oracle(limits)
        standby = f"127.0.0.1:{peers[2]}"
        actuator = ServerActuator(coordinator=srv.pod.resize,
                                  standby_addresses=[standby],
                                  min_hosts=2, max_hosts=3)
        clock = ManualClock()
        controller = CapacityController(
            actuator, events=srv.pod.events, mode="on", interval_s=0.1,
            sustain_s=CTL_SUSTAIN_S, dwell_s=CTL_DWELL_S, clock=clock)
        burn = ControlSignals(capacity_headroom_ratio=1.0)
        hold = ControlSignals(capacity_headroom_ratio=2.0)
        idle = ControlSignals(capacity_headroom_ratio=4.0)
        rng = np.random.default_rng(2021)
        stable = _stable_users(limits, 400, rng)
        log, hosts_seen, actions = [], [], []

        def drive(requests, tag):
            spec = [(h, _rls_request(rls_pb2, ns, [e]))
                    for h, ns, e in requests]
            codes, _lat = _pod_drive(rls, spec, rls_pb2)
            log.extend((tag, h, ns, e, code)
                       for (h, ns, e), code in zip(requests, codes))

        def step(snapshot, tag):
            clock.now += 0.1
            hosts = actuator.hosts()
            done = {}
            tick = threading.Thread(
                target=lambda: done.update(d=controller.tick(snapshot)))
            t = time.perf_counter()
            tick.start()
            i = 0
            while tick.is_alive():
                u = stable[i % len(stable)]
                drive([(i % 2, "pods", {"user": f"u{u}"})], tag + " tick")
                i += 1
            tick.join()
            seconds = time.perf_counter() - t
            member = done["d"]["membership"] or {}
            if "action" in member:
                actions.append((member["action"], member["ok"], seconds,
                                i))
            hosts_seen.append(actuator.hosts())
            drive(_elastic_calls(rng, CTL_ROUND, actuator.hosts()), tag)

        def until(snapshot, tag, done, limit=60):
            for _ in range(limit):
                if done():
                    return
                step(snapshot, tag)
            fail(f"{label}: {tag} never converged "
                 f"({json.dumps(controller.controller_debug())[:1500]})")

        for _ in range(6):
            step(hold, "calm")
        if actuator.hosts() != 2 or actions:
            fail(f"{label}: the calm ticks moved membership: {actions}")
        until(burn, "grow", lambda: actuator.hosts() == 3)
        pool_grown = actuator.standby_pool()
        for _ in range(2):
            for snapshot in (burn, burn, hold, hold):
                step(snapshot, "ramp")
        if actuator.hosts() != 3:
            fail(f"{label}: the ramp noise moved membership: {actions}")
        until(idle, "shrink", lambda: actuator.hosts() == 2)
        for _ in range(3):
            step(idle, "after")
        pool = actuator.standby_pool()
        stats = controller.stats()
        failed = [entry for entry in log if isinstance(entry[4], str)]
        ok_code, over_code = (rls_pb2.RateLimitResponse.OK,
                              rls_pb2.RateLimitResponse.OVER_LIMIT)
        from limitador_tpu_torch import Context

        want = [over_code if oracle.check_rate_limited_and_update(
            ns, _ctx(Context, e), 1, False).limited else ok_code
            for _t, _h, ns, e, _c in log]
        differ = sum(w != entry[4] for w, entry in zip(want, log))
        union = _elastic_counters(http[:2], 2, limits, label)
        oracle_spent = _oracle_spent(oracle)
        order = _events_order(http[0], ("controller_actuation", "join_begin",
                                        "epoch_bump", "join_end"))
        kinds = [e["detail"]["action"] for e in srv.pod.events.snapshot(
            kind="controller_actuation")]
        completed = _pod_metric(http[0], "join_completed")
    finally:
        if srv is not None:
            loop.run(srv.stop(), timeout=120)
        loop.close()
        runs[0] = {k: v - before.get(k, 0) for k, v in K.launches.items()}
        for h, member in ((1, members[0]), (2, members[1])):
            runs[h] = _pod_stop(member, label)
    if failed:
        fail(f"{label}: {len(failed)} calls failed: {failed[:5]}")
    if differ:
        fail(f"{label}: {differ} of {len(log)} answers differ from the "
             "in-memory oracle's")
    if union != oracle_spent:
        fail(f"{label}: the members' spent counters differ from the "
             f"oracle's: {len(union ^ oracle_spent)} differences")
    if (stats["ctl_hosts_added"], stats["ctl_hosts_drained"]) != (1, 1) or \
            kinds != ["add_host", "drain_host"] or \
            [a[:2] for a in actions] != [("add_host", True),
                                         ("drain_host", True)]:
        fail(f"{label}: membership actions {actions}, events {kinds}, "
             f"stats {stats}")
    if None in order or order != sorted(order) or len(set(order)) != 4:
        fail(f"{label}: host 0's controller_actuation, join_begin, "
             f"epoch_bump, join_end at {order}")
    if pool_grown != [] or pool != [standby] or completed != 1:
        fail(f"{label}: the standby pool {pool_grown} after the grow, "
             f"{pool} after the drain; join_completed {completed}")
    for h, run in enumerate(runs):
        missing = [k for k in PHASE19_TORCH_KERNELS
                   if not run or run.get(k, 0) == 0]
        if not run or _b1(run) == 0:
            missing.append("check_and_update")
        if missing:
            fail(f"{label}: host {h} launched none of {missing}")
    out.update({
        "calls": len(log), "counters": len(union), "hosts": hosts_seen,
        "join_s": actions[0][2], "drain_s": actions[1][2],
        "calls_during": [actions[0][3], actions[1][3]],
        "ticks": stats["ctl_ticks"], "chain": order,
        "launches": runs,
    })
    print(f"{label}: pod formed in {out['formed_s']:.2f} s; "
          f"{stats['ctl_ticks']} ticks, one grow 2 -> 3 by join in "
          f"{actions[0][2]:.3f} s ({actions[0][3]} calls during it) and "
          f"one drain 3 -> 2 in {actions[1][2]:.3f} s ({actions[1][3]} "
          f"calls during it), no flap under the ramp noise; {len(log)} "
          f"calls, none failed, every answer and the {len(union)} spent "
          f"counters (each on its owner) equal to the oracle; events "
          f"{order}; the standby back in the pool ({card})", flush=True)
    return runs, out


async def _ctl_import(tmpdir, dev, card):
    """Phase 20c: ``redis_import`` replays a dump of the port's
    ``key_for_counter`` keys into a torch server on the card through
    ``POST /report``: ``/counters`` equals the dump for every replayable
    entry; the entries of limits with conditions on fields that are not
    their counter's variables (the ``kubernetes/`` configmap's shape
    among them) are counted and not sent; expired and nil lines are
    skipped."""
    import base64

    from limitador_tpu_torch.core.counter import Counter
    from limitador_tpu_torch.ops import kernel as K
    from limitador_tpu_torch.server import __main__ as server
    from limitador_tpu_torch.server.limits_file import load_limits_file
    from limitador_tpu_torch.storage.keys import key_for_counter
    from limitador_tpu_torch.tools import redis_import as R

    label = "redis_import (20c)"
    limits_path = os.path.join(tmpdir, "import-limits.yaml")
    with open(limits_path, "w") as f:
        f.write(IMPORT_YAML)
    limits = load_limits_file(limits_path)
    by_name = {lim.name: lim for lim in limits}
    rng = np.random.default_rng(2022)

    def line(counter, value, pttl):
        return (base64.b64encode(key_for_counter(counter)).decode()
                + f" {value} {pttl}")

    lines, want = [], {}
    for i in range(IMPORT_COUNTERS):
        value = int(rng.integers(1, 1000))
        want[f"m{i}"] = value
        lines.append(line(Counter(by_name["per-u"],
                                  {"descriptors[0].u": f"m{i}"}), value,
                          int(rng.integers(1000, 3_600_000))))
    for i in range(IMPORT_UNREPLAYABLE):
        name, var = (("configmap", "descriptors[0].user") if i % 2
                     else ("gold", "descriptors[0].u"))
        lines.append(line(Counter(by_name[name], {var: f"x{i}"}),
                          int(rng.integers(1, 100)), 30_000))
    for i in range(IMPORT_EXPIRED):
        lines.append(line(Counter(by_name["per-u"],
                                  {"descriptors[0].u": f"old{i}"}), 5, 0))
    for i in range(IMPORT_NIL):
        key = key_for_counter(Counter(by_name["per-u"],
                                      {"descriptors[0].u": f"nil{i}"}))
        lines.append(base64.b64encode(key).decode() + " nil 1000")
    order = rng.permutation(len(lines))
    dump = os.path.join(tmpdir, "counters.dump")
    with open(dump, "w") as f:
        f.write("\n".join(lines[i] for i in order) + "\n")
    entries, nil = R.parse_dump(lines)
    pairs, expired, unknown = R.decode_entries(entries, limits)
    by_ns = {}
    for lim in limits:
        by_ns.setdefault(str(lim.namespace), []).append(lim)
    reasons = [R.unreplayable_reason(c, by_ns[str(c.namespace)])[0]
               for c, _v in pairs]
    if (nil, expired, unknown) != (IMPORT_NIL, IMPORT_EXPIRED, 0) or \
            reasons.count("conditions") != IMPORT_UNREPLAYABLE or \
            reasons.count(None) != IMPORT_COUNTERS:
        fail(f"{label}: the dump decodes to nil {nil}, expired {expired}, "
             f"unknown {unknown}, reasons {set(reasons)}")
    http_options, http_port = _http_options()
    (port,) = _free_ports(1)
    srv = await server.start(server.build_parser().parse_args(
        [limits_path, "torch", "--device", dev.type, "--capacity", str(C),
         "--rls-host", "127.0.0.1", "--rls-port", str(port), *http_options,
         "--flight-spool-dir", os.path.join(tmpdir, "spool-import")]))
    before = dict(K.launches)
    try:
        err = io.StringIO()

        def run_tool():
            # one warning line a refused entry: kept for the count
            with contextlib.redirect_stderr(err):
                return R.main([limits_path, dump, "--target",
                               f"http://127.0.0.1:{http_port}"])

        t = time.perf_counter()
        rc = await asyncio.get_running_loop().run_in_executor(None, run_tool)
        seconds = time.perf_counter() - t
        mig = json.loads(await _served_get(http_port, "/counters/mig"))
        api = json.loads(await _served_get(http_port, "/counters/api"))
    finally:
        await srv.stop()
    launches = {k: v - before.get(k, 0) for k, v in K.launches.items()}
    got = {}
    for c in mig:
        if c["limit"]["name"] != "per-u":
            fail(f"{label}: /counters/mig holds {c}")
        got[c["set_variables"]["descriptors[0].u"]] = 1000 - c["remaining"]
    refused = err.getvalue().count("unreplayable (conditions)")
    summary = [ln for ln in err.getvalue().splitlines()
               if ln.startswith(("decoded ", "replayed "))]
    if rc != 2 or got != want or api or refused != IMPORT_UNREPLAYABLE:
        bad = sorted(set(got.items()) ^ set(want.items()))[:5]
        fail(f"{label}: exit {rc}; /counters/mig differs from the dump's "
             f"replayable entries at {bad}; /counters/api {api[:3]}; "
             f"{refused} entries refused; {summary}")
    _storage_forms(launches, label, ("update_host",))
    out = {"seconds": seconds, "replayed": len(got), "tool": summary,
           "unreplayable": refused, "expired": expired,
           "nil": nil, "update_host": launches.get("update_host", 0)}
    print(f"{label}: {len(got)} counters replayed through /report in "
          f"{seconds:.2f} s, /counters equal to the dump; "
          f"{IMPORT_UNREPLAYABLE} unreplayable entries (conditions) counted "
          f"and not sent, {expired} expired and {nil} nil skipped; B2's "
          f"host form launched {out['update_host']} times ({card})",
          flush=True)
    return launches, out


def phase_controller(dev, card):
    """Phase 20: the capacity controller's served knobs (a), its
    membership over an elastic pod (b) and the ``redis_import`` tool
    (c). Returns (launches of 20, results)."""
    from limitador_tpu_torch.ops import kernel as K

    t0 = time.perf_counter()
    K.reset_launches()
    with tempfile.TemporaryDirectory() as tmpdir:
        served = asyncio.run(_ctl_served(tmpdir, dev, card))
    served_launches = dict(K.launches)
    missing = [k for k in ("credit_host", "drain_top_hits_host")
               if served_launches.get(k, 0) == 0]
    if _b1(served_launches) == 0:
        missing.append("check_and_update")
    if missing:
        fail(f"capacity controller (20a): kernels not launched: {missing}")
    _storage_forms(served_launches, "capacity controller (20a)",
                   ("credit_host", "drain_top_hits_host"))
    with tempfile.TemporaryDirectory() as tmpdir:
        member_runs, membership = _ctl_membership(tmpdir, card)
    with tempfile.TemporaryDirectory() as tmpdir:
        _import_launches, imported = asyncio.run(_ctl_import(tmpdir, dev,
                                                             card))
    launches = dict(K.launches)
    total = dict(launches)
    for run in member_runs[1:]:
        for k, v in (run or {}).items():
            total[k] = total.get(k, 0) + v
    seconds = time.perf_counter() - t0
    print(f"capacity controller (20): {seconds:.1f} s; launches in this "
          f"process {json.dumps({k: v for k, v in launches.items() if v})}",
          flush=True)
    return total, {"served": served, "membership": membership,
                   "import": imported, "seconds": seconds}


# -- phase 21: the port's correctness tooling -----------------------------

#: milliseconds each race-hunt driver runs
HUNT_MS = 2000


def phase_tooling(card: str) -> dict:
    """Phase 21: the port's analysis gate and its sanitizer race hunts on
    this box. The analysis runs in a process of its own beside the
    drivers' builds; the drivers run one after another. Returns what the
    phase measured."""
    from concurrent.futures import ThreadPoolExecutor

    from limitador_tpu_torch.native import build as host_build
    from limitador_tpu_torch.tools import race_hunt as RH

    t0 = time.perf_counter()
    analysis = subprocess.Popen(
        [sys.executable, "-m", "limitador_tpu_torch.tools.analysis",
         "--all", "--json"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    variants = sorted({variant for _driver, variant in RH.HUNTS})
    with ThreadPoolExecutor(len(variants)) as pool:
        probes = dict(zip(variants, pool.map(host_build.sanitizer_probe,
                                             variants)))
    missing = {v: why for v, why in probes.items() if why is not None}
    for variant, why in missing.items():
        print(f"tooling (21): the box's g++ lacks the {variant} runtime; "
              f"its hunts are left out: {why}", flush=True)
    hunts = [(d, v) for d, v in RH.HUNTS if v not in missing]
    infos = {key: {} for key in hunts}
    with ThreadPoolExecutor(max(len(hunts), 1)) as pool:
        jobs = [pool.submit(host_build.build_tool, f"race_hunt_{d}",
                            host_build.RACE_HUNT_SOURCES[d], variant=v,
                            info=infos[(d, v)])
                for d, v in hunts]
        for job in jobs:
            job.result()
    build_s = time.perf_counter() - t0
    rows = []
    for driver, variant in hunts:
        result = RH.hunt(driver, variant, HUNT_MS)
        row = result.summary()
        row["build_s"] = round(infos[(driver, variant)]["seconds"], 3)
        rows.append(row)
        called = sum(1 for name in RH.HOSTPATH_EXPORTS
                     if result.calls.get(name, 0) > 0)
        print(f"tooling (21): race hunt {driver}/{variant}: build "
              f"{row['build_s']:.2f} s, run {result.run_s:.2f} s, "
              f"{result.operations} operations"
              + (f", {result.foreign_rows} foreign rows, "
                 f"{called} of {len(RH.HOSTPATH_EXPORTS)} counted exports "
                 "called" if driver == "hostpath" else ""), flush=True)
        failures = result.failures()
        if failures:
            print(result.output[-4000:], flush=True)
            fail(f"race hunt {driver}/{variant}: {failures}")
    out, err = analysis.communicate(timeout=600)
    if analysis.returncode != 0:
        print(out[-4000:], err[-4000:], flush=True)
        fail(f"analysis gate exited {analysis.returncode}")
    report = json.loads(out)
    seconds = time.perf_counter() - t0
    print(f"tooling (21): analysis --all clean over "
          f"{len(report['passes'])} passes ({len(report['suppressed'])} "
          f"allowlisted); {seconds:.1f} s, the hunts' builds "
          f"{build_s:.1f} s together; card {card}", flush=True)
    return {"seconds": seconds, "build_s": build_s,
            "analysis": {"passes": report["passes"],
                         "active": len(report["active"]),
                         "suppressed": len(report["suppressed"])},
            "missing_runtimes": missing, "hunts": rows}


_T0 = time.perf_counter()


def _mark(label: str) -> None:
    """The seconds since the script started, at the end of a phase."""
    print(f"[{time.perf_counter() - _T0:.1f} s] {label} done", flush=True)


def main() -> int:
    name, card = phase_card()
    import torch

    # every server's flight bundles go under this run's own directory
    spool_root = tempfile.TemporaryDirectory()
    os.environ["TPU_FLIGHT_SPOOL"] = os.path.join(spool_root.name, "flight")

    dev = torch.device("cuda", 0)
    phase_build()
    _mark("phase 2")
    results = phase_kernels(dev)
    _mark("phase 3")
    with tempfile.TemporaryDirectory() as tmpdir:
        launches = asyncio.run(_main_path(tmpdir, dev))
    _mark("phase 4")
    rate, drive5_launches = phase_drive(dev, card, DRIVE_BATCHES)
    _mark("phase 5")
    from limitador_tpu_torch.ops import kernel as K

    with tempfile.TemporaryDirectory() as tmpdir:
        native_launches = asyncio.run(_main_path(tmpdir, dev, native=True))
    K.reset_launches()
    native = phase_native_drive(dev, card, NATIVE_BATCHES, leases=False)
    leased = phase_native_drive(dev, card, NATIVE_BATCHES, leases=True)
    drive_launches = dict(K.launches)
    print(f"native drive launches: {json.dumps(drive_launches)}")
    _mark("phases 6 and 7")
    missing = [name for name in PHASE7_KERNELS
               if _launched(drive_launches, name) == 0]
    if missing:
        fail(f"kernels not launched on the native drive: {missing}")
    with _route_tally("replication drive (8a)") as routes:
        repl_launches, repl = phase_replication_drive(dev, card,
                                                      REPLICATION_BATCHES)
    repl["routes"] = routes
    if any(key.startswith("B6a block") and int(key.split("H=")[1]) >= 1024
           for key in routes):
        fail("replication drive: a B6a batch of 1,024 hits or more took "
             "the one block")
    with tempfile.TemporaryDirectory() as tmpdir, \
            _route_tally("served replication (8b)") as routes:
        served_launches, served = asyncio.run(
            _served_replication(tmpdir, dev, card))
    served["routes"] = routes
    _mark("phase 8")
    tier_launches, tiered = phase_tiered_drive(dev, card)
    with tempfile.TemporaryDirectory() as tmpdir:
        served_tier_launches, served_tiers = asyncio.run(
            _served_tiers(tmpdir, dev, card, leases=False, calls=1400))
    # Leases on, the observatory off: its veto keeps the hottest counters
    # resident, and those are the ones that hold leases, so with it on a
    # demotion meets a live lease only when the veto falls short.
    with tempfile.TemporaryDirectory() as tmpdir:
        leased_tier_launches, leased_tiers = asyncio.run(
            _served_tiers(tmpdir, dev, card, leases=True, calls=1400,
                          extra=("--usage-topk", "0")))
    # Leases on and the default observatory, as a server runs by default:
    # the same checks but reclaim, which the veto may leave idle.
    with tempfile.TemporaryDirectory() as tmpdir:
        served_default_launches, served_default = asyncio.run(
            _served_tiers(tmpdir, dev, card, leases=True, calls=1400,
                          label="served tiers (leases on, observatory on)",
                          need_reclaim=False))
    _mark("phase 9")
    with _route_tally("sharded drive (10a)") as routes:
        sharded_launches, sharded = phase_sharded_drive(dev, card)
    sharded["routes"] = routes
    with tempfile.TemporaryDirectory() as tmpdir, \
            _route_tally("served sharded (10b)") as routes:
        served_sharded_launches, served_sharded = asyncio.run(
            _served_sharded(tmpdir, dev, card, calls=1000))
    served_sharded["routes"] = routes
    _mark("phase 10")
    with tempfile.TemporaryDirectory() as tmpdir:
        http_launches, http_api = asyncio.run(_http_api(tmpdir, dev, card))
    _mark("phase 11")
    plane_launches, device_plane = phase_device_plane(dev, card)
    _mark("phase 12")
    planes_launches, control_planes = phase_control_planes(dev, card)
    _mark("phase 13")
    host_launches, host_storages = phase_host_storages(dev, card)
    _mark("phase 14")
    admission_launches, admission = phase_admission(dev, card)
    _mark("phase 15")
    ingress_launches, ingress = phase_native_ingress(dev, card)
    _mark("phase 16")
    pod_launches, pod = phase_pod(dev, card)
    _mark("phase 17")
    native_pod_launches, native_pod = phase_native_pod(
        dev, card, pod["torch"]["p50_p99_ms"])
    _mark("phase 18")
    elastic_launches, elastic = phase_elastic(card)
    _mark("phase 19")
    controller_launches, controller = phase_controller(dev, card)
    _mark("phase 20")
    tooling = phase_tooling(card)
    _mark("phase 21")
    missing = [k for k in SHARDED_KERNELS
               if _launched(sharded_launches, k)
               + _launched(served_sharded_launches, k) == 0]
    if missing:
        fail(f"kernels not launched on the sharded paths: {missing}")
    # B2, B4c, B5, B6b, B7c and B7d on the storages' paths: their host
    # forms only (4's and 6's updates, 7b's settle, the observatory's
    # drains in 6, 7, 10a and 10b, 8b's and 10b's Reports)
    for label, run, need in (
            ("main path (4)", launches, ("update_host",)),
            ("native main path (6)", native_launches,
             ("update_host", "drain_top_hits_host")),
            ("native drive (7)", drive_launches,
             ("credit_host", "drain_top_hits_host")),
            ("replication drive (8a)", repl_launches, ()),
            ("served replication (8b)", served_launches,
             ("replicated_update_host",)),
            ("sharded drive (10a)", sharded_launches,
             ("sharded_drain_top_hits_host",)),
            ("served sharded (10b)", served_sharded_launches,
             ("sharded_update_host", "sharded_drain_top_hits_host"))):
        _storage_forms(run, label, need)
    for label, got, want in (
            ("served tiers", served_tier_launches, PHASE9B_KERNELS),
            ("served tiers (leases on)", leased_tier_launches,
             PHASE9B_LEASE_KERNELS),
            ("served tiers (leases on, observatory on)",
             served_default_launches, PHASE9B_SERVED_KERNELS)):
        missing = [k for k in want if _launched(got, k) == 0]
        if missing:
            fail(f"kernels not launched on {label}: {missing}")
        _host_forms_only(got, label, remote=False)
    _storage_forms(plane_launches, "device plane (12)", ("update_host",))
    # launches on the main paths: phases 4, 5, 6, 7, 8a, 8b, 9a, 9b, 10a,
    # 10b, 11, 12, 13, 14, 15, 16, 17, 18, 19 (14c's authority and 15d's
    # server are other processes: 14c's RPCs are counted by its
    # /debug/stats, not here; 17's, 18's and 19's pod members write their
    # own counts as they exit, the members killed in 17d and 18c just
    # before their kill; 19c's killed standby's are lost with it)
    runs = (launches, drive5_launches, native_launches, drive_launches,
            repl_launches,
            served_launches, tier_launches, served_tier_launches,
            leased_tier_launches, served_default_launches, sharded_launches,
            served_sharded_launches, http_launches, plane_launches,
            planes_launches, host_launches, admission_launches,
            ingress_launches, pod_launches, native_pod_launches,
            elastic_launches, controller_launches)
    launches = {name: sum(run.get(name, 0) for run in runs)
                for name in launches}
    kernels = []
    for kname, by_shape in results.items():
        rec = by_shape[MAIN_SHAPE[kname]]
        row = {
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[kname],
            "launches": _launched(launches, kname),
            "max_abs_err": max(r["max_abs_err"] for r in by_shape.values()),
            # the kernel alone (profiler) where measured, else the call
            "ms": rec["device_ms"] if rec["device_ms"] is not None
            else rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": "bytes",
            "library_ms": rec["library_ms"],
        }
        # B4d, B7b, B3a and B6c from host lists (the main paths' form):
        # each call timed from the list, beside the parent's path for it
        host = {shape: {k: r[k] for k in ("ms", "device_ms", "plain_ms",
                                          "parent_path_ms", "library_ms",
                                          "bound_ms", "param_ms",
                                          "staged_ms", "path_ms")
                        if k in r}
                for shape, r in by_shape.items()
                if str(shape).startswith("host")}
        if host:
            row["host_forms"] = host
        if kname in HOST_FORMS:
            row["host_form_launches"] = launches[HOST_FORMS[kname]]
        kernels.append(row)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({
            "card": card, "kernels": results, "launches": launches,
            "drive_decisions_per_s": rate,
            "native_drive": {"decisions_per_s": native[0],
                             "host_s": native[1], "seconds": native[2]},
            "native_drive_leases": {"decisions_per_s": leased[0],
                                    "host_s": leased[1],
                                    "seconds": leased[2]},
            "replication_drive": repl,
            "served_replication": served,
            "tiered_drive": tiered,
            "served_tiers": served_tiers,
            "served_tiers_leases": leased_tiers,
            "served_tiers_default": served_default,
            "sharded_drive": sharded,
            "served_sharded": served_sharded,
            "http_api": http_api,
            "http_api_launches": http_launches,
            "device_plane": device_plane,
            "device_plane_launches": plane_launches,
            "control_planes": control_planes,
            "control_planes_launches": planes_launches,
            "host_storages": host_storages,
            "host_storages_launches": host_launches,
            "admission": admission,
            "admission_launches": admission_launches,
            "native_ingress": ingress,
            "native_ingress_launches": ingress_launches,
            "pod": pod,
            "pod_launches": pod_launches,
            "native_pod": native_pod,
            "native_pod_launches": native_pod_launches,
            "elastic_pod": elastic,
            "elastic_pod_launches": elastic_launches,
            "controller": controller,
            "controller_launches": controller_launches,
            "tooling": tooling,
        }, f, indent=1)
    spool_root.cleanup()
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
