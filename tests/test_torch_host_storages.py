"""The port's host-memory storages against the JAX package's.

- ``disk`` (``storage/disk.py``): the cases of ``tests/test_disk.py`` on
  the port (clocks injected where the JAX tests sleep), the rows of a
  random stream of windows and buckets equal to the JAX package's, and a
  file written by either package read the same by the other.
- ``distributed`` (``storage/distributed/``): the CRDT laws and the
  storage cases of ``tests/test_distributed.py``, over real gossip on
  loopback, and a JAX node and a port node converging with each other.
- ``cached`` (``storage/cached.py``): the cases of ``tests/test_cached.py``.
- The token-bucket cases of ``tests/test_token_bucket.py`` for disk and
  distributed, and the cached storage's refusal of the policy.
- The behaviour matrix (``tests/test_behavior.py``) for the three
  backends through ``torch_twin.HostTwin``: every answer and the whole
  final state equal to the JAX package's.

Each scenario runs once on each package (``J`` and ``T``, namespaces of
the same names) and the two results must be equal, exactly; the
scenario's own assertions hold for both. Every test runs inside
``torch_steady.steady()``: brokers, flush loops and executors end with it.
"""

from __future__ import annotations

import asyncio
import importlib
import random
import socket
import time
import types

import numpy as np
import pytest

from .torch_steady import steady
from .torch_twin import BACKENDS, Clock, HostTwin, crdt_entries, disk_rows


def _pkg(name):
    """The names the scenarios use, from the JAX package (``jax``) or
    the port."""
    root_name = "limitador_tpu" if name == "jax" else "limitador_tpu_torch"

    def mod(path):
        return importlib.import_module(f"{root_name}.{path}")

    root = importlib.import_module(root_name)
    distributed = mod("storage.distributed")
    return types.SimpleNamespace(
        name=name, Context=root.Context, Limit=root.Limit,
        Counter=mod("core.counter").Counter,
        RateLimiter=root.RateLimiter, AsyncRateLimiter=root.AsyncRateLimiter,
        InMemoryStorage=mod("storage.in_memory").InMemoryStorage,
        StorageError=mod("storage.base").StorageError,
        DiskStorage=mod("storage.disk").DiskStorage, disk=mod("storage.disk"),
        CachedCounterStorage=mod("storage.cached").CachedCounterStorage,
        CrInMemoryStorage=distributed.CrInMemoryStorage,
        CrCounterValue=distributed.CrCounterValue,
        CrTatValue=distributed.CrTatValue,
        broker=mod("storage.distributed.broker"),
        key_for_counter=mod("storage.keys").key_for_counter,
        PrometheusMetrics=mod("observability.metrics").PrometheusMetrics,
    )


J = _pkg("jax")
T = _pkg("port")


@pytest.fixture(scope="module", autouse=True)
def _grpc_aio_poller():
    """Two gossiping nodes for the module's length: grpc.aio starts its
    completion-queue poller thread when brokers on two event loops talk,
    and ends it some time after the last aio object is gone, so a test
    that gossips could start a poller that outlives it. Held here, the
    one poller and these nodes' threads predate every test's thread
    count (``steady``)."""
    a, b = _cluster(T)
    try:
        assert eventually(lambda: a.broker.sessions and b.broker.sessions)
        yield
    finally:
        a.close()
        b.close()


@pytest.fixture(autouse=True)
def _steady(_grpc_aio_poller):
    with steady():
        yield


def both(scenario, tmp_path=None):
    """``scenario(pkg[, tmp dir])`` on each package; the results must be
    equal. Returns the port's."""
    args = {}
    out = []
    for pkg in (J, T):
        if tmp_path is not None:
            d = tmp_path / pkg.name
            d.mkdir()
            args = {"tmp": d}
        out.append(scenario(pkg, **args))
    assert out[0] == out[1]
    return out[1]


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def eventually(cond, timeout=10.0, tick=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return False


TB = dict(conditions=[], variables=["descriptors[0].u"],
          policy="token_bucket")


def ctx_for(pkg, user="a"):
    ctx = pkg.Context()
    ctx.list_binding("descriptors", [{"u": user}])
    return ctx


# -- disk (tests/test_disk.py) ------------------------------------------------


def test_disk_counters_survive_reopen(tmp_path):
    def scenario(P, tmp):
        path = str(tmp / "c.db")
        limit = P.Limit("ns", 10, 60, [], ["u"])
        storage = P.DiskStorage(path)
        limiter = P.RateLimiter(storage)
        limiter.add_limit(limit)
        limiter.update_counters("ns", P.Context({"u": "a"}), 7)
        storage.close()
        storage2 = P.DiskStorage(path)
        try:
            limiter2 = P.RateLimiter(storage2)
            limiter2.add_limit(limit)
            counters = limiter2.get_counters("ns")
            assert len(counters) == 1
            return next(iter(counters)).remaining
        finally:
            storage2.close()

    assert both(scenario, tmp_path) == 3


def test_disk_window_merge_across_reopen(tmp_path):
    def scenario(P, tmp):
        path = str(tmp / "c.db")
        clock = Clock()
        limit = P.Limit("ns", 10, 1, [], [])
        storage = P.DiskStorage(path, clock=clock)
        limiter = P.RateLimiter(storage)
        limiter.add_limit(limit)
        got = [limiter.check_rate_limited_and_update(
            "ns", P.Context({}), 10).limited,
            limiter.check_rate_limited_and_update(
                "ns", P.Context({}), 1).limited]
        storage.close()
        clock.t += 1.05  # the window expires while closed
        storage2 = P.DiskStorage(path, clock=clock)
        try:
            limiter2 = P.RateLimiter(storage2)
            limiter2.add_limit(limit)
            got.append(limiter2.check_rate_limited_and_update(
                "ns", P.Context({}), 1).limited)
            return got
        finally:
            storage2.close()

    assert both(scenario, tmp_path) == [False, True, False]


def test_disk_expired_sweep(tmp_path):
    def scenario(P, tmp):
        clock = Clock()
        storage = P.DiskStorage(str(tmp / "c.db"), clock=clock)
        try:
            limiter = P.RateLimiter(storage)
            limiter.add_limit(P.Limit("ns", 100, 1, [], ["u"]))
            limiter.update_counters("ns", P.Context({"u": "x"}), 1)
            clock.t += 1.05
            storage._ops = P.disk._SWEEP_EVERY - 1  # the next op sweeps
            limiter.update_counters("ns", P.Context({"u": "y"}), 1)
            return storage._db.execute(
                "SELECT COUNT(*) FROM counters").fetchone()[0]
        finally:
            storage.close()

    assert both(scenario, tmp_path) == 1  # x swept, y remains


def test_disk_scan_tolerates_undecodable_keys(tmp_path):
    def scenario(P, tmp):
        storage = P.DiskStorage(str(tmp / "c.db"))
        try:
            limit = P.Limit("ns", 10, 60, [], ["u"])
            storage.update_counter(P.Counter(limit, {"u": "a"}), 3)
            storage._db.execute(
                "INSERT INTO counters (key, namespace, value, expiry) "
                "VALUES (?,?,?,?)",
                (b"\x01\x93\xa2ns*junk", "ns", 1, time.time() + 60))
            storage._db.commit()
            counters = storage.get_counters({limit})
            assert len(counters) == 1
            remaining = next(iter(counters)).remaining
            storage.delete_counters({limit})  # must not raise either
            return remaining
        finally:
            storage.close()

    assert both(scenario, tmp_path) == 7


def test_disk_refuses_a_path_it_cannot_open(tmp_path):
    def scenario(P, tmp):
        with pytest.raises(P.StorageError, match="cannot open disk"):
            P.DiskStorage(str(tmp / "no-such-dir" / "c.db"))
        return True

    assert both(scenario, tmp_path)


_DISK_LIMITS = (
    ("ns", 5, 60, [], ["u"], None, "fixed_window"),
    ("ns", 12, 2, [], ["u"], "short", "fixed_window"),
    ("ns", 7, 3, [], ["u"], "bucket", "token_bucket"),
    ("other", 3, 60, [], [], "global", "fixed_window"),
)


def _limits(P):
    return [P.Limit(ns, mx, s, c, v, name=n, policy=pol)
            for ns, mx, s, c, v, n, pol in _DISK_LIMITS]


def _disk_stream(P, tmp, seed, steps=300):
    """A random stream of checks, Reports, apply_deltas, reads and
    deletes over windows, a bucket and an unqualified limit; every
    answer, and the rows at the end."""
    rng = random.Random(seed)
    clock = Clock()
    storage = P.DiskStorage(str(tmp / "c.db"), clock=clock)
    try:
        limiter = P.RateLimiter(storage)
        limits = _limits(P)
        for limit in limits:
            limiter.add_limit(limit)
        out = []
        for _ in range(steps):
            op = rng.random()
            ctx = P.Context({"u": f"u{rng.randrange(4)}"})
            ns = "ns" if rng.random() < 0.8 else "other"
            delta = rng.choice([0, 1, 1, 2, 3])
            if op < 0.55:
                r = limiter.check_rate_limited_and_update(
                    ns, ctx, delta, load_counters=rng.random() < 0.5)
                out.append(("check", r.limited, r.limit_name, sorted(
                    ((c.limit.name, c.remaining, c.expires_in)
                     for c in r.counters), key=repr)))
            elif op < 0.7:
                limiter.update_counters(ns, ctx, delta)
            elif op < 0.8:
                limit = rng.choice(limits)
                items = [(P.Counter(limit, {"u": f"u{i}"} if limit.variables
                                    else {}), rng.randrange(3))
                         for i in range(rng.randrange(1, 4))]
                out.append(("apply", storage.apply_deltas(items)))
            elif op < 0.9:
                out.append(("counters", sorted(
                    ((c.limit.name, sorted(c.set_variables.items()),
                      c.remaining, c.expires_in)
                     for c in limiter.get_counters(ns)), key=repr)))
            elif op < 0.93:
                storage.delete_counters({rng.choice(limits)})
            clock.t += rng.choice([0.0, 0.01, 0.3, 1.1])
        return out, disk_rows(storage)
    finally:
        storage.close()


@pytest.mark.parametrize("seed", range(3))
def test_disk_stream_answers_and_rows_match_jax(tmp_path, seed):
    out, rows = both(lambda P, tmp: _disk_stream(P, tmp, seed), tmp_path)
    assert rows and any(step[0] == "check" and step[1] for step in out)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_file_written_by_one_package_reads_the_same_in_the_other(
        tmp_path, writer):
    """Both packages write one stream into files of their own; each file
    is then read and driven further by the other package, and every
    answer and row equals what the writer itself gives."""
    import shutil

    W, R = (J, T) if writer == "jax" else (T, J)
    written = tmp_path / "w"
    written.mkdir()
    _disk_stream(W, written, 7, steps=150)
    shutil.copytree(written, tmp_path / "copy")

    def reopen(P, d):
        clock = Clock(1_000_000.0 + 30)
        storage = P.DiskStorage(str(d / "c.db"), clock=clock)
        try:
            limiter = P.RateLimiter(storage)
            for limit in _limits(P):
                limiter.add_limit(limit)
            seen = [sorted(((c.limit.name, sorted(c.set_variables.items()),
                             c.remaining, c.expires_in)
                            for c in limiter.get_counters(ns)), key=repr)
                    for ns in ("ns", "other")]
            answers = []
            for i in range(20):
                r = limiter.check_rate_limited_and_update(
                    "ns", P.Context({"u": f"u{i % 5}"}), 1, True)
                answers.append((r.limited, r.limit_name))
            return seen, answers, disk_rows(storage)
        finally:
            storage.close()

    own = reopen(W, tmp_path / "copy")
    assert own == reopen(R, written)
    assert own[0][0] and any(limited for limited, _n in own[1])


def test_disk_bucket_tat_survives_reopen(tmp_path):
    def scenario(P, tmp):
        path = str(tmp / "tb.db")
        clock = Clock(time.time())
        storage = P.DiskStorage(path, clock=clock)
        rl = P.RateLimiter(storage)
        rl.add_limit(P.Limit("tb", 5, 60, **TB))  # I = 12 s
        for _ in range(3):
            rl.check_rate_limited_and_update("tb", ctx_for(P), 1)
        storage.close()
        storage2 = P.DiskStorage(path, clock=clock)
        try:
            rl2 = P.RateLimiter(storage2)
            rl2.add_limit(P.Limit("tb", 5, 60, **TB))
            got = [rl2.check_rate_limited_and_update(
                "tb", ctx_for(P), 1).limited for _ in range(3)]
            clock.t += 12.5  # one emission interval: a token is back
            got.append(rl2.check_rate_limited_and_update(
                "tb", ctx_for(P), 1).limited)
            return got
        finally:
            storage2.close()

    assert both(scenario, tmp_path) == [False, False, True, False]


# -- token buckets (tests/test_token_bucket.py) ---------------------------------


def _bucket_storage(P, kind, clock, tmp):
    if kind == "disk":
        return P.DiskStorage(str(tmp / "tb.db"), clock=clock)
    return P.CrInMemoryStorage("n1", clock=clock)


@pytest.mark.parametrize("kind", ["disk", "distributed"])
def test_burst_refill_and_headers(tmp_path, kind):
    def scenario(P, tmp):
        clock = Clock()
        storage = _bucket_storage(P, kind, clock, tmp)
        try:
            rl = P.RateLimiter(storage)
            rl.add_limit(P.Limit("tb", 5, 1, **TB))  # I = 200 ms
            got = [rl.check_rate_limited_and_update(
                "tb", ctx_for(P), 1).limited for _ in range(7)]
            assert got == [False] * 5 + [True] * 2
            clock.t += 0.45  # exactly 2 tokens back
            got += [rl.check_rate_limited_and_update(
                "tb", ctx_for(P), 1).limited for _ in range(3)]
            assert got[7:] == [False, False, True]
            clock.t += 60
            res = rl.check_rate_limited_and_update(
                "tb", ctx_for(P), 2, load_counters=True)
            headers = res.response_header()
            assert headers["X-RateLimit-Limit"].startswith("5")
            assert headers["X-RateLimit-Remaining"] == "3"
            return got, headers
        finally:
            storage.close()

    both(scenario, tmp_path)


@pytest.mark.parametrize("kind,seed", [("disk", 0), ("disk", 1),
                                       ("distributed", 0),
                                       ("distributed", 1)])
def test_randomized_bucket_parity_with_the_oracle(tmp_path, kind, seed):
    """Same op stream against the port's oracle and the storage: the same
    admissions at every step, and the storage's answers equal to the
    JAX package's."""
    def scenario(P, tmp):
        rng = np.random.default_rng(seed + 100)
        clk_a, clk_b = Clock(), Clock()
        a = P.RateLimiter(P.InMemoryStorage(clock=clk_a))
        storage = _bucket_storage(P, kind, clk_b, tmp)
        b = P.RateLimiter(storage)
        try:
            for rl in (a, b):
                rl.add_limit(P.Limit("tb", 7, 2, **TB))
                rl.add_limit(P.Limit("tb", 50, 10, name="slow",
                                     conditions=[],
                                     variables=["descriptors[0].u"],
                                     policy="token_bucket"))
            out = []
            for step in range(80):
                user = ["u1", "u2"][int(rng.integers(2))]
                delta = int(rng.integers(1, 4))
                ra = a.check_rate_limited_and_update(
                    "tb", ctx_for(P, user), delta)
                rb = b.check_rate_limited_and_update(
                    "tb", ctx_for(P, user), delta)
                assert ra.limited == rb.limited, f"seed {seed} step {step}"
                out.append((rb.limited, rb.limit_name))
                if rng.random() < 0.3:
                    dt = float(rng.random())
                    clk_a.t += dt
                    clk_b.t += dt
            return out
        finally:
            storage.close()

    both(scenario, tmp_path)


def test_cached_rejects_token_buckets_up_front():
    def scenario(P):
        storage = P.CachedCounterStorage(P.InMemoryStorage())
        rl = P.AsyncRateLimiter(storage)
        try:
            with pytest.raises(ValueError, match="token_bucket"):
                rl.add_limit(P.Limit("ns", 5, 1, **TB))
        finally:
            storage.close().close()  # nothing was started
        return True

    assert both(scenario)


@pytest.mark.parametrize("cls", ["DiskStorage", "CrInMemoryStorage",
                                 "CachedCounterStorage"])
def test_token_bucket_support_flags_match_jax(cls):
    assert getattr(getattr(T, cls), "supports_token_bucket", False) == \
        getattr(getattr(J, cls), "supports_token_bucket", False)


# -- distributed: the CRDT laws (tests/test_distributed.py) -----------------------


def test_crdt_read_as_sum():
    def scenario(P):
        v = P.CrCounterValue("a", 60, now=100.0)
        v.inc_at(3, 60, 100.0)
        v.inc_actor_at("b", 4, 60, 101.0)
        return v.read_at(102.0), v.snapshot()

    assert both(scenario)[0] == 7


def test_crdt_merge_is_per_actor_max():
    def scenario(P):
        v = P.CrCounterValue("a", 60, now=100.0)
        v.inc_at(3, 60, 100.0)
        v.merge_at({"a": 2, "b": 5}, expiry=160.0, now=101.0)
        return v.read_at(101.0), v.snapshot()

    assert both(scenario)[0] == 8


def test_crdt_merge_commutes():
    def scenario(P):
        def build(merges):
            v = P.CrCounterValue("me", 60, now=100.0)
            for values, expiry in merges:
                v.merge_at(values, expiry, 100.0)
            return v.read_at(100.0), v.expiry

        m1 = ({"a": 3}, 150.0)
        m2 = ({"a": 1, "b": 2}, 140.0)
        assert build([m1, m2]) == build([m2, m1])
        return build([m1, m2])

    both(scenario)


def test_crdt_merge_idempotent():
    def scenario(P):
        v = P.CrCounterValue("me", 60, now=100.0)
        for _ in range(3):
            v.merge_at({"a": 5}, 150.0, 100.0)
        return v.read_at(100.0)

    assert both(scenario) == 5


def test_crdt_expiry_resets():
    def scenario(P):
        v = P.CrCounterValue("a", 10, now=100.0)
        v.inc_at(3, 10, 100.0)
        v.inc_actor_at("b", 4, 10, 100.0)
        gone = v.read_at(111.0)
        v.inc_at(1, 10, 111.0)
        return gone, v.read_at(111.0), v.snapshot()

    assert both(scenario)[:2] == (0, 1)


def test_crdt_expired_remote_merge_ignored():
    def scenario(P):
        v = P.CrCounterValue("a", 60, now=100.0)
        v.inc_at(1, 60, 100.0)
        v.merge_at({"b": 99}, expiry=90.0, now=100.0)
        return v.read_at(100.0)

    assert both(scenario) == 1


def _tb_limit(P):
    return P.Limit("tb", 5, 60, [], ["u"], policy="token_bucket")


def test_crdt_tat_local_spend_and_refill():
    def scenario(P):
        v = P.CrTatValue("a", _tb_limit(P))
        v.inc_at(3, 60, 1000.0)  # 3 of 5 spent, I = 12 s
        return v.read_at(1000.0), v.ttl(1000.0), v.read_at(1012.5)

    assert both(scenario) == (3, 36.0, 2)


def test_crdt_tat_merge_is_max_idempotent_commutative():
    def scenario(P):
        limit = _tb_limit(P)
        now = 1000.0
        t3, t2 = int(now * 1000) + 3 * 12_000, int(now * 1000) + 2 * 12_000

        def merged(deliveries):
            v = P.CrTatValue("me", limit)
            for payload in deliveries:
                v.merge_at(payload, 0.0, now)
            return v.read_at(now)

        return [merged([{"a": t3}]), merged([{"a": t3}, {"a": t3}]),
                merged([{"a": t3}, {"b": t2}]),
                merged([{"b": t2}, {"a": t3}]), merged([{"a": t2}])]

    assert both(scenario) == [3, 3, 3, 3, 2]


def test_crdt_tat_snapshot_round_trips():
    def scenario(P):
        limit = _tb_limit(P)
        a = P.CrTatValue("a", limit)
        a.inc_at(4, 60, 1000.0)
        values, expiry_s = a.snapshot()
        b = P.CrTatValue("b", limit)
        b.merge_at(values, expiry_s, 1000.0)
        assert b.read_at(1000.0) == a.read_at(1000.0)
        return values, expiry_s

    both(scenario)


def test_distributed_standalone_behaves_like_memory():
    def scenario(P):
        storage = P.CrInMemoryStorage.standalone("n1")
        limiter = P.RateLimiter(storage)
        limiter.add_limit(P.Limit("ns", 3, 60, [], ["u"]))
        ctx = P.Context({"u": "a"})
        out = [limiter.check_rate_limited_and_update("ns", ctx, 1).limited
               for _ in range(4)]
        storage.close()
        return out

    assert both(scenario) == [False, False, False, True]


def test_distributed_gossip_before_the_limit_coerces_to_a_bucket():
    """Gossip for a bucket key landing before the limit is known parks as
    a window shell; the first local touch coerces it to the TAT cell."""
    def scenario(P):
        limit = P.Limit("tb", 5, 600, [], ["u"], policy="token_bucket")
        clock = Clock(1_700_000_000.0)
        storage = P.CrInMemoryStorage("me", clock=clock)
        try:
            now_ms = int(clock.t * 1000)
            tat = now_ms + 3 * 120_000  # 3 of 5 spent at I = 120 s
            storage._on_remote_update(
                P.key_for_counter(P.Counter(limit, {"u": "x"})),
                {"peer": tat}, tat)
            lim = P.RateLimiter(storage)
            lim.add_limit(limit)
            ctx = P.Context({"u": "x"})
            got = (lim.is_rate_limited("tb", ctx, 2).limited,
                   lim.is_rate_limited("tb", ctx, 3).limited,
                   {c.remaining for c in lim.get_counters("tb")})
            return got, crdt_entries(storage)
        finally:
            storage.close()

    assert both(scenario)[0] == (False, True, {2})


def test_distributed_random_stream_matches_jax():
    """A random stream of checks, Reports and gossip deliveries on one
    standalone node of each package (frozen clocks): every answer and
    every CRDT entry equal."""
    def scenario(P):
        rng = random.Random(5)
        clock = Clock()
        storage = P.CrInMemoryStorage("me", clock=clock)
        limiter = P.RateLimiter(storage)
        window = P.Limit("ns", 6, 5, [], ["u"], name="w")
        bucket = P.Limit("ns", 4, 8, [], ["u"], name="b",
                         policy="token_bucket")
        for limit in (window, bucket):
            limiter.add_limit(limit)
        out = []
        for _ in range(250):
            user = f"u{rng.randrange(3)}"
            op = rng.random()
            if op < 0.6:
                r = limiter.check_rate_limited_and_update(
                    "ns", P.Context({"u": user}), rng.choice([1, 1, 2]),
                    load_counters=True)
                out.append((r.limited, r.limit_name, sorted(
                    (c.limit.name, c.remaining, c.expires_in)
                    for c in r.counters)))
            elif op < 0.75:
                limiter.update_counters("ns", P.Context({"u": user}), 1)
            else:
                limit = rng.choice((window, bucket))
                key = P.key_for_counter(P.Counter(limit, {"u": user}))
                peer = rng.choice(["p1", "p2"])
                if limit is bucket:
                    tat = int(clock.t * 1000) + rng.randrange(0, 30_000)
                    storage._on_remote_update(key, {peer: tat}, tat)
                else:
                    storage._on_remote_update(
                        key, {peer: rng.randrange(4)},
                        int((clock.t + rng.choice([-1, 2, 5])) * 1000))
            clock.t += rng.choice([0.0, 0.2, 1.5])
        out.append(sorted(storage._snapshot()))
        storage.close()
        return out, crdt_entries(storage)

    both(scenario)


# -- distributed over real gossip --------------------------------------------------


def _node(P, name, peers=(), port=None, **kw):
    """A gossiping node of package ``P`` on a free local port (the broker
    cannot bind port 0 and report it): a bind that fails leaves the
    broker unstarted, and is tried once more on another port."""
    for _attempt in range(2):
        port = port or free_port()
        node = P.CrInMemoryStorage(name, f"127.0.0.1:{port}", list(peers),
                                   **kw)
        if node.broker._started.is_set():
            return node
        node.close()
        port = None
    raise AssertionError(f"{name}: the broker did not bind")


def _cluster(P, n=2, **kw):
    ports = [free_port() for _ in range(n)]
    return [_node(P, f"node{i}", [f"127.0.0.1:{q}" for j, q in
                                  enumerate(ports) if j != i],
                  port=ports[i], **kw) for i in range(n)]


def test_distributed_nodes_converge():
    nodes = _cluster(T)
    try:
        limit = T.Limit("ns", 3, 60, ["m == 'GET'"], ["u"])
        limiters = [T.RateLimiter(s) for s in nodes]
        for lim in limiters:
            lim.add_limit(limit)
        ctx = T.Context({"m": "GET", "u": "app"})
        for i in range(3):
            lim = limiters[i % 2]
            assert not lim.is_rate_limited("ns", ctx, 1).limited, i
            lim.update_counters("ns", ctx, 1)
        for lim in limiters:
            assert eventually(
                lambda: lim.is_rate_limited("ns", ctx, 1).limited)
    finally:
        for s in nodes:
            s.close()


def test_distributed_late_joiner_resyncs():
    n0 = _node(T, "node0")
    try:
        limit = T.Limit("ns", 10, 60, [], ["u"])
        lim0 = T.RateLimiter(n0)
        lim0.add_limit(limit)
        lim0.update_counters("ns", T.Context({"u": "x"}), 7)
        n1 = _node(T, "node1", [n0.broker.listen_address])
        try:
            lim1 = T.RateLimiter(n1)
            lim1.add_limit(limit)
            assert eventually(lambda: any(
                c.remaining == 3 for c in lim1.get_counters("ns")))
        finally:
            n1.close()
    finally:
        n0.close()


def test_distributed_buckets_converge():
    nodes = _cluster(T)
    try:
        limit = T.Limit("tb", 5, 600, [], ["u"], policy="token_bucket")
        limiters = [T.RateLimiter(s) for s in nodes]
        for lim in limiters:
            lim.add_limit(limit)
        ctx = T.Context({"u": "shared"})
        for _ in range(3):
            assert not limiters[0].check_rate_limited_and_update(
                "tb", ctx, 1).limited
        assert eventually(
            lambda: limiters[1].is_rate_limited("tb", ctx, 3).limited)
        assert not limiters[1].is_rate_limited("tb", ctx, 2).limited
        assert not limiters[1].check_rate_limited_and_update(
            "tb", ctx, 2).limited
        assert eventually(
            lambda: limiters[0].is_rate_limited("tb", ctx, 1).limited)
        assert eventually(lambda: all(
            {c.remaining for c in lim.get_counters("tb")} == {0}
            for lim in limiters))
    finally:
        for s in nodes:
            s.close()


@pytest.mark.parametrize("policy", ["fixed_window", "token_bucket"])
def test_a_jax_node_and_a_port_node_converge(policy):
    """The broker's wire is the JAX package's: a JAX ``distributed`` node
    and a port one gossip with each other, and each refuses what the
    other spent."""
    jn = _node(J, "jax")
    tn = _node(T, "port", [jn.broker.listen_address])
    try:
        lj, lt = J.RateLimiter(jn), T.RateLimiter(tn)
        lj.add_limit(J.Limit("ns", 4, 600, [], ["u"], policy=policy))
        lt.add_limit(T.Limit("ns", 4, 600, [], ["u"], policy=policy))
        assert not lj.check_rate_limited_and_update(
            "ns", J.Context({"u": "x"}), 3).limited
        assert eventually(lambda: lt.is_rate_limited(
            "ns", T.Context({"u": "x"}), 2).limited)
        assert not lt.check_rate_limited_and_update(
            "ns", T.Context({"u": "x"}), 1).limited
        assert eventually(lambda: lj.is_rate_limited(
            "ns", J.Context({"u": "x"}), 1).limited)
        assert eventually(lambda: {
            c.remaining for c in lt.get_counters("ns")} == {0} == {
            c.remaining for c in lj.get_counters("ns")})
    finally:
        tn.close()
        jn.close()


def test_distributed_hello_carries_the_advertise_address():
    p0 = free_port()
    n0 = _node(T, "adv-node0", port=p0, advertise_address=f"localhost:{p0}")
    p0 = int(n0.broker.listen_address.rsplit(":", 1)[1])
    n1 = _node(T, "adv-node1", [n0.broker.listen_address])
    p1 = int(n1.broker.listen_address.rsplit(":", 1)[1])
    try:
        assert eventually(lambda: "adv-node1" in n0.broker.known_peers)
        assert n0.broker.known_peers["adv-node1"] == [f"127.0.0.1:{p1}"]
        n0.broker._loop.call_soon_threadsafe(
            n0.broker._spawn_dialer, f"127.0.0.1:{p1}")
        assert eventually(lambda: n1.broker.known_peers.get("adv-node0")
                          == [f"localhost:{p0}"])
    finally:
        n1.close()
        n0.close()


def test_distributed_never_dials_its_own_advertised_url():
    port = free_port()
    n = _node(T, "adv-self", [f"localhost:{port}"], port=port,
              advertise_address=f"localhost:{port}")
    try:
        time.sleep(0.2)
        assert not n.broker._dialers
    finally:
        n.close()


def test_distributed_live_ping_round_measures_latency(monkeypatch):
    monkeypatch.setattr(T.broker, "PING_INTERVAL_SECONDS", 0.1)
    a, b = _cluster(T)
    try:
        def pinged():
            return any(s.pongs_received >= 2 and storage.broker.peer_last_seen
                       for storage in (a, b)
                       for s in list(storage.broker.sessions.values()))

        assert eventually(pinged)
    finally:
        a.close()
        b.close()


# -- cached (tests/test_cached.py) ---------------------------------------------


def _flaky(P):
    class FlakyAuthority(P.InMemoryStorage):
        def __init__(self):
            super().__init__()
            self.fail = False
            self.applied = []

        def apply_deltas(self, items):
            if self.fail:
                raise P.StorageError("connection refused", transient=True)
            self.applied.append(
                [(c.set_variables.get("u"), d) for c, d in items])
            return super().apply_deltas(items)

    return FlakyAuthority()


def test_cached_local_decisions_and_flush_to_authority():
    def scenario(P):
        async def main():
            authority = P.InMemoryStorage()
            cached = P.CachedCounterStorage(authority, flush_period=10.0)
            limiter = P.AsyncRateLimiter(cached)
            limit = P.Limit("ns", 10, 60, [], ["u"])
            limiter.add_limit(limit)
            for _ in range(4):
                r = await limiter.check_rate_limited_and_update(
                    "ns", P.Context({"u": "a"}), 1)
                assert not r.limited
            await cached.flush()
            got = {c.set_variables["u"]: c.remaining
                   for c in authority.get_counters({limit})}
            await cached.close()
            return got

        return run(main())

    assert both(scenario) == {"a": 6}


def test_cached_replicas_converge_through_a_shared_authority():
    def scenario(P):
        async def main():
            authority = P.InMemoryStorage()
            a = P.CachedCounterStorage(authority, flush_period=10.0)
            b = P.CachedCounterStorage(authority, flush_period=10.0)
            la, lb = P.AsyncRateLimiter(a), P.AsyncRateLimiter(b)
            limit = P.Limit("ns", 4, 60, [], ["u"])
            la.add_limit(limit)
            lb.add_limit(limit)
            ctx = P.Context({"u": "x"})
            for _ in range(2):
                for lim in (la, lb):
                    assert not (await lim.check_rate_limited_and_update(
                        "ns", ctx, 1)).limited
            await a.flush()
            await b.flush()
            await la.check_rate_limited_and_update("ns", ctx, 1)
            await a.flush()
            second = await la.check_rate_limited_and_update("ns", ctx, 1)
            await a.close()
            await b.close()
            return second.limited

        return run(main())

    assert both(scenario) is True


def test_cached_partition_revert_and_recovery():
    def scenario(P):
        async def main():
            authority = _flaky(P)
            flags = []
            cached = P.CachedCounterStorage(
                authority, flush_period=10.0, on_partitioned=flags.append)
            limiter = P.AsyncRateLimiter(cached)
            limit = P.Limit("ns", 100, 60, [], ["u"])
            limiter.add_limit(limit)
            await limiter.check_rate_limited_and_update(
                "ns", P.Context({"u": "a"}), 5)
            authority.fail = True
            await cached.flush()
            assert cached.partitioned is True
            r = await limiter.check_rate_limited_and_update(
                "ns", P.Context({"u": "a"}), 1, True)
            assert not r.limited and r.counters[0].remaining == 94
            authority.fail = False
            await cached.flush()
            assert cached.partitioned is False
            remaining = next(iter(authority.get_counters({limit}))).remaining
            await cached.close()
            return flags, remaining

        return run(main())

    assert both(scenario) == ([True, False], 94)


def test_cached_batch_coalesces_per_counter():
    def scenario(P):
        async def main():
            authority = _flaky(P)
            cached = P.CachedCounterStorage(authority, flush_period=10.0)
            limiter = P.AsyncRateLimiter(cached)
            limiter.add_limit(P.Limit("ns", 1000, 60, [], ["u"]))
            for _ in range(5):
                await limiter.check_rate_limited_and_update(
                    "ns", P.Context({"u": "a"}), 2)
            await limiter.check_rate_limited_and_update(
                "ns", P.Context({"u": "b"}), 1)
            await cached.flush()
            await cached.close()
            return authority.applied

        return run(main())

    applied = both(scenario)
    assert len(applied) == 1 and sorted(applied[0]) == [("a", 10), ("b", 1)]


def test_cached_eviction_with_pending_writes_survives_flush():
    def scenario(P):
        async def main():
            authority = _flaky(P)
            cached = P.CachedCounterStorage(authority, flush_period=10.0,
                                            max_cached=2)
            limiter = P.AsyncRateLimiter(cached)
            limit = P.Limit("ns", 1000, 60, [], ["u"])
            limiter.add_limit(limit)
            for u in ("a", "b", "c", "d"):
                await limiter.check_rate_limited_and_update(
                    "ns", P.Context({"u": u}), 1)
            assert cached.evicted_pending_writes >= 1
            await cached.flush()
            got = {c.set_variables["u"]: c.remaining
                   for c in authority.get_counters({limit})}
            await cached.close()
            return got

        return run(main())

    assert both(scenario) == dict.fromkeys("abcd", 999)


def test_cached_writes_during_an_inflight_flush_are_preserved():
    import threading

    def scenario(P):
        class SlowAuthority(P.InMemoryStorage):
            def __init__(self):
                super().__init__()
                self.gate = threading.Event()
                self.entered = threading.Event()

            def apply_deltas(self, items):
                self.entered.set()
                assert self.gate.wait(5.0)
                return super().apply_deltas(items)

        async def main():
            authority = SlowAuthority()
            cached = P.CachedCounterStorage(authority, flush_period=10.0)
            limiter = P.AsyncRateLimiter(cached)
            limit = P.Limit("ns", 100, 60, [], ["u"])
            limiter.add_limit(limit)
            ctx = P.Context({"u": "a"})
            await limiter.check_rate_limited_and_update("ns", ctx, 5)
            loop = asyncio.get_running_loop()
            flush = loop.create_task(cached.flush())
            await loop.run_in_executor(None, authority.entered.wait)
            await limiter.check_rate_limited_and_update("ns", ctx, 3)
            authority.gate.set()
            await flush
            r = await limiter.check_rate_limited_and_update("ns", ctx, 1,
                                                            True)
            await cached.flush()
            auth = next(iter(authority.get_counters({limit}))).remaining
            await cached.close()
            return r.counters[0].remaining, auth

        return run(main())

    assert both(scenario) == (91, 91)


def test_cached_flush_loop_survives_a_nontransient_error():
    def scenario(P):
        class BrokenOnce(P.InMemoryStorage):
            def __init__(self):
                super().__init__()
                self.calls = 0

            def apply_deltas(self, items):
                self.calls += 1
                if self.calls == 1:
                    raise P.StorageError("corrupt frame", transient=False)
                return super().apply_deltas(items)

        async def main():
            authority = BrokenOnce()
            cached = P.CachedCounterStorage(authority, flush_period=0.01)
            limiter = P.AsyncRateLimiter(cached)
            limit = P.Limit("ns", 100, 60, [], ["u"])
            limiter.add_limit(limit)
            await limiter.check_rate_limited_and_update(
                "ns", P.Context({"u": "a"}), 7)
            deadline = asyncio.get_running_loop().time() + 5.0
            while authority.calls < 2:
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.01)
            assert cached.flush_errors >= 1
            auth = next(iter(authority.get_counters({limit}))).remaining
            await cached.close()
            return auth

        return run(main())

    assert both(scenario) == 93


def test_cached_priority_flush_for_a_never_synced_counter():
    def scenario(P):
        async def main():
            authority = _flaky(P)
            cached = P.CachedCounterStorage(authority, flush_period=10.0,
                                            batch_size=1000)
            limiter = P.AsyncRateLimiter(cached)
            limiter.add_limit(P.Limit("ns", 100, 60, [], ["u"]))
            await limiter.check_rate_limited_and_update(
                "ns", P.Context({"u": "a"}), 2)
            deadline = asyncio.get_running_loop().time() + 3.0
            while not authority.applied:
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.01)
            await cached.close()
            return authority.applied

        return run(main())

    assert both(scenario) == [[("a", 2)]]


def test_cached_pending_cap_backpressure():
    def scenario(P):
        async def main():
            authority = _flaky(P)
            cached = P.CachedCounterStorage(
                authority, flush_period=1000.0, batch_size=10**6,
                max_pending=5)
            limiter = P.AsyncRateLimiter(cached)
            limiter.add_limit(P.Limit("ns", 100, 60, [], ["u"]))
            for u in range(12):
                await limiter.check_rate_limited_and_update(
                    "ns", P.Context({"u": f"u{u}"}), 1)
            pending_now = len(cached._batch)
            delivered = sum(len(batch) for batch in authority.applied)
            await cached.close()
            return pending_now, delivered

        return run(main())

    pending_now, delivered = both(scenario)
    assert pending_now < 5 and delivered >= 8


def test_cached_library_stats_feed_the_prometheus_families():
    def scenario(P):
        async def main():
            authority = _flaky(P)
            cached = P.CachedCounterStorage(authority, flush_period=10.0,
                                            max_cached=2)
            metrics = P.PrometheusMetrics()
            metrics.attach_library_source(cached)
            limiter = P.AsyncRateLimiter(cached)
            limiter.add_limit(P.Limit("ns", 100, 60, [], ["u"]))
            for u in ("a", "b", "c", "d"):
                await limiter.check_rate_limited_and_update(
                    "ns", P.Context({"u": u}), 1)
            await cached.flush()
            text = metrics.render().decode()
            await cached.close()
            return sorted(line for line in text.splitlines()
                          if line.startswith(("evicted_pending_writes_total",
                                              "counter_overshoot_total",
                                              "batcher_flush_size_count",
                                              "cache_size ")))

        return run(main())

    lines = both(scenario)
    assert "batcher_flush_size_count 1.0" in lines
    assert "cache_size 2.0" in lines
    assert any(line.startswith("evicted_pending_writes_total")
               for line in lines)


def test_cached_random_single_replica_parity_with_the_oracle():
    def scenario(P):
        async def main():
            rng = random.Random(11)
            clock = Clock()
            authority = P.InMemoryStorage(clock=clock)
            cached = P.CachedCounterStorage(authority, flush_period=1000.0,
                                            clock=clock)
            mem = P.RateLimiter(P.InMemoryStorage(clock=clock))
            limiter = P.AsyncRateLimiter(cached)
            for lim in (P.Limit("ns", 5, 60, [], ["u"], name="l5"),
                        P.Limit("ns", 12, 3600, [], ["u"], name="l12")):
                mem.add_limit(lim)
                limiter.add_limit(lim)
            out = []
            for step in range(250):
                op = rng.random()
                ctx = P.Context({"u": str(rng.randrange(5))})
                delta = rng.choice([1, 1, 2])
                if op < 0.65:
                    r1 = mem.check_rate_limited_and_update("ns", ctx, delta)
                    r2 = await limiter.check_rate_limited_and_update(
                        "ns", ctx, delta)
                    assert (r1.limited, r1.limit_name) == (
                        r2.limited, r2.limit_name), step
                    out.append((r2.limited, r2.limit_name))
                elif op < 0.85:
                    mem.update_counters("ns", ctx, delta)
                    await limiter.update_counters("ns", ctx, delta)
                else:
                    await cached.flush()
            await cached.close()
            return out

        return run(main())

    both(scenario)


def test_cached_over_a_torch_table_authority():
    """The device table (on the CPU here) as the authority, beside the
    JAX package's TpuStorage."""
    def scenario(P):
        if P is J:
            from limitador_tpu.tpu.storage import TpuStorage

            authority = TpuStorage(capacity=256)
        else:
            from limitador_tpu_torch.device import TorchStorage

            authority = TorchStorage(capacity=256, device="cpu")

        async def main():
            cached = P.CachedCounterStorage(authority, flush_period=10.0)
            limiter = P.AsyncRateLimiter(cached)
            limit = P.Limit("ns", 5, 60, [], ["u"])
            limiter.add_limit(limit)
            for _ in range(3):
                await limiter.check_rate_limited_and_update(
                    "ns", P.Context({"u": "z"}), 1)
            await cached.flush()
            auth = authority.get_counters({limit})
            await cached.close()
            return next(iter(auth)).remaining

        return run(main())

    assert both(scenario) == 2


def test_cached_overshoot_counts_once_including_the_first_reconcile():
    def scenario(P):
        async def main():
            authority = P.InMemoryStorage()
            cached = P.CachedCounterStorage(authority, flush_period=10.0)
            limiter = P.AsyncRateLimiter(cached)
            limiter.add_limit(P.Limit("ns", 10, 60, [], ["u"]))
            ctx = P.Context({"u": "a"})
            seen = []
            for delta, evict in ((15, False), (3, False), (0, True)):
                if evict:
                    cached._cache.clear()
                await limiter.update_counters("ns", ctx, delta)
                await cached.flush()
                seen.append(cached.counter_overshoot)
            await cached.close()
            return seen

        return run(main())

    assert both(scenario) == [5, 8, 8]


def test_cached_concurrent_flushes_serialize():
    def scenario(P):
        class SlowAuthority(P.InMemoryStorage):
            def apply_deltas(self, items):
                time.sleep(0.01)
                return super().apply_deltas(items)

        async def main():
            authority = SlowAuthority()
            cached = P.CachedCounterStorage(authority, flush_period=10.0)
            limiter = P.AsyncRateLimiter(cached)
            limit = P.Limit("ns", 10_000, 60, [], ["u"])
            limiter.add_limit(limit)
            ctx = P.Context({"u": "a"})
            await limiter.update_counters("ns", ctx, 1)
            flushes = [asyncio.create_task(cached.flush()) for _ in range(3)]
            await limiter.update_counters("ns", ctx, 2)
            await asyncio.gather(*flushes)
            await cached.flush()
            remaining = next(iter(authority.get_counters({limit}))).remaining
            await cached.close()
            return remaining

        return run(main())

    assert both(scenario) == 10_000 - 3


def test_cached_rejects_negative_deltas():
    def scenario(P):
        async def main():
            cached = P.CachedCounterStorage(P.InMemoryStorage(),
                                            flush_period=10.0)
            counter = P.Counter(P.Limit("ns", 5, 60, [], ["u"]), {"u": "a"})
            with pytest.raises(Exception) as err:
                await cached.update_counter(counter, -1)
            await cached.close()
            return type(err.value).__name__

        return run(main())

    both(scenario)


# -- the behaviour matrix ---------------------------------------------------------


def _behavior_tests():
    from . import test_behavior

    return sorted(name for name in vars(test_behavior)
                  if name.startswith("test_"))


@pytest.mark.parametrize("name", _behavior_tests())
@pytest.mark.parametrize("backend", BACKENDS)
def test_behavior_matrix_host_backends_match_jax(tmp_path, backend, name):
    from . import test_behavior

    twin = HostTwin(backend, tmp_path)
    try:
        getattr(test_behavior, name)(twin)
        twin.check_storages()
    finally:
        twin.cleanup()
