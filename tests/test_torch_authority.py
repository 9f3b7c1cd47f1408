"""The port's shared authority (``storage/authority.py``) against the JAX
package's.

- The cases of ``tests/test_authority.py`` on the port: replicas that
  converge over the network, a partition and its recovery on the same
  port, DeleteCounters and Clear, the device table as the authority, and
  three server processes (an authority and two ``cached`` replicas).
- The wire both ways: a JAX replica flushing to a port authority and a
  port replica flushing to a JAX authority answer as the all-JAX pair,
  and the authorities end equal.
- A cached replica over a ``TorchStorage(device="cpu")`` authority and
  one over a JAX ``TpuStorage``, and the same over the sharded tables: the
  deltas each authority received, every answer and the final table
  arrays equal, with flushes of up to 4,096 counters (B2's and B7c's
  staged route on the card starts past 2,000).
- Served checks (the native pipeline's hot lane included) and authority
  RPCs on one storage at once end equal to an oracle fed the same hits,
  and a DeleteCounters in between leaves no stale slot in the plan cache.
- The server's ``--authority-listen`` over each storage that has
  ``apply_deltas``, a ``cached`` server over its default disk authority,
  ``datastore_partitioned`` following a replica's partition, and the
  ``authority`` section of ``/debug/stats``.

Every authority binds ``127.0.0.1:0`` and is reached on its ``.port``;
flushes are explicit. Every test runs inside ``torch_steady.steady()``.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import random
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import grpc
import numpy as np
import pytest
import torch

from limitador_tpu_torch.server import __main__ as port_main
from limitador_tpu_torch.server.proto import rls_pb2

from .torch_steady import steady
from .torch_twin import Clock

REPO = Path(__file__).resolve().parent.parent
ENVOY = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"


def _pkg(name):
    """The names the scenarios use, from the JAX package (``jax``) or
    the port."""
    root_name = "limitador_tpu" if name == "jax" else "limitador_tpu_torch"

    def mod(path):
        return importlib.import_module(f"{root_name}.{path}")

    root = importlib.import_module(root_name)
    authority = mod("storage.authority")
    return types.SimpleNamespace(
        name=name, Context=root.Context, Limit=root.Limit,
        RateLimiter=root.RateLimiter, AsyncRateLimiter=root.AsyncRateLimiter,
        InMemoryStorage=mod("storage.in_memory").InMemoryStorage,
        StorageError=mod("storage.base").StorageError,
        CachedCounterStorage=mod("storage.cached").CachedCounterStorage,
        RemoteAuthority=authority.RemoteAuthority,
        serve_authority=authority.serve_authority,
        key_for_counter=mod("storage.keys").key_for_counter,
    )


J = _pkg("jax")
T = _pkg("port")


@pytest.fixture(autouse=True)
def _steady():
    with steady():
        yield


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


def serve(P, storage, port=0):
    """``P.serve_authority`` on 127.0.0.1:``port``; a bind of a given
    port that fails is tried once more."""
    try:
        return P.serve_authority(storage, f"127.0.0.1:{port}")
    except Exception:
        if not port:
            raise
        time.sleep(0.2)
        return P.serve_authority(storage, f"127.0.0.1:{port}")


def stop(server):
    """Stop an authority of either package and wait for its threads: the
    JAX server's ``stop`` neither waits nor ends its pool's threads."""
    if hasattr(server, "_pool"):
        server.stop()
        return
    server._server.stop(0).wait()
    server._server._state.thread_pool.shutdown(wait=True)


def _counter_rows(counters):
    return sorted(((str(c.namespace), c.limit.name,
                    sorted(c.set_variables.items()), c.remaining,
                    c.expires_in) for c in counters), key=repr)


def _answer(r):
    return (r.limited, r.limit_name,
            sorted(((c.limit.name, c.remaining, c.expires_in)
                    for c in r.counters), key=repr))


# -- tests/test_authority.py on the port ---------------------------------------


def test_replicas_converge_over_the_network():
    backend = T.InMemoryStorage()
    server = serve(T, backend)
    try:
        async def main():
            url = f"127.0.0.1:{server.port}"
            a = T.CachedCounterStorage(T.RemoteAuthority(url),
                                       flush_period=3600)
            b = T.CachedCounterStorage(T.RemoteAuthority(url),
                                       flush_period=3600)
            la, lb = T.AsyncRateLimiter(a), T.AsyncRateLimiter(b)
            limit = T.Limit("ns", 4, 60, [], ["u"])
            la.add_limit(limit)
            lb.add_limit(limit)
            ctx = T.Context({"u": "x"})
            for _ in range(2):
                for lim in (la, lb):
                    assert not (await lim.check_rate_limited_and_update(
                        "ns", ctx, 1)).limited
            await a.flush()
            await b.flush()
            assert next(iter(backend.get_counters({limit}))).remaining == 0
            # a flushed before b: its view may admit one more hit, and
            # after one more flush it has converged
            await la.check_rate_limited_and_update("ns", ctx, 1)
            await a.flush()
            second = await la.check_rate_limited_and_update("ns", ctx, 1)
            await a.close()
            await b.close()
            return second.limited

        assert run(main()) is True
    finally:
        server.stop()


def test_partition_revert_and_recovery_over_the_network():
    backend = T.InMemoryStorage()
    server = serve(T, backend)
    port = server.port

    async def main():
        flags = []
        cached = T.CachedCounterStorage(
            T.RemoteAuthority(f"127.0.0.1:{port}", timeout=0.5),
            flush_period=3600, on_partitioned=flags.append)
        limiter = T.AsyncRateLimiter(cached)
        limit = T.Limit("ns", 100, 60, [], ["u"])
        limiter.add_limit(limit)
        await limiter.check_rate_limited_and_update(
            "ns", T.Context({"u": "a"}), 5)
        server.stop(grace=0)
        await cached.flush()
        assert cached.partitioned is True
        r = await limiter.check_rate_limited_and_update(
            "ns", T.Context({"u": "a"}), 1, True)
        assert not r.limited and r.counters[0].remaining == 94
        again = serve(T, backend, port)
        try:
            deadline = time.monotonic() + 10.0
            while cached.partitioned:
                assert time.monotonic() < deadline
                await asyncio.sleep(0.1)
                await cached.flush()
            remaining = next(iter(backend.get_counters({limit}))).remaining
            await cached.close()
            return flags, remaining
        finally:
            again.stop()

    assert run(main()) == ([True, False], 94)


@pytest.mark.parametrize("table", ["memory", "torch", "sharded"])
def test_delete_and_clear_propagate(table):
    if table == "memory":
        backend = T.InMemoryStorage()
    elif table == "torch":
        from limitador_tpu_torch.device import TorchStorage

        backend = TorchStorage(capacity=256, device="cpu")
    else:
        from limitador_tpu_torch.device.sharded import TorchShardedStorage

        backend = TorchShardedStorage(n_shards=2, local_capacity=256,
                                      global_region=8, device="cpu")
    server = serve(T, backend)
    try:
        async def main():
            cached = T.CachedCounterStorage(
                T.RemoteAuthority(f"127.0.0.1:{server.port}"),
                flush_period=3600)
            limiter = T.AsyncRateLimiter(cached)
            keep = T.Limit("ns", 50, 60, [], ["u"], name="keep")
            drop = T.Limit("ns", 40, 120, [], ["u"], name="drop")
            for limit in (keep, drop):
                limiter.add_limit(limit)
            for u in "abc":
                await limiter.check_rate_limited_and_update(
                    "ns", T.Context({"u": u}), 3)
            await cached.flush()
            before = len(backend.get_counters({keep, drop}))
            await limiter.delete_limit(drop)
            after_delete = _counter_rows(backend.get_counters({keep, drop}))
            await limiter.storage.clear()
            after_clear = len(backend.get_counters({keep, drop}))
            stats = server.stats()
            await cached.close()
            return before, after_delete, after_clear, stats

        before, after_delete, after_clear, stats = run(main())
        assert before == 6
        assert [row[1] for row in after_delete] == ["keep"] * 3
        assert after_clear == 0
        assert (stats["apply_deltas"], stats["delete_counters"],
                stats["clear"], stats["errors"], stats["items"]) == (
            1, 1, 1, 0, 6)
        assert set(stats["ms"]) == {"decode", "intern", "apply", "encode"}
    finally:
        server.stop()
        close = getattr(backend, "close", None)
        if close is not None:
            close()


def test_torch_table_as_network_authority():
    from limitador_tpu_torch.device import TorchStorage

    backend = TorchStorage(capacity=512, device="cpu")
    server = serve(T, backend)
    try:
        async def main():
            cached = T.CachedCounterStorage(
                T.RemoteAuthority(f"127.0.0.1:{server.port}"),
                flush_period=3600)
            limiter = T.AsyncRateLimiter(cached)
            limit = T.Limit("ns", 10, 60, [], ["u"])
            limiter.add_limit(limit)
            for _ in range(4):
                await limiter.check_rate_limited_and_update(
                    "ns", T.Context({"u": "z"}), 1)
            await cached.flush()
            auth = next(iter(backend.get_counters({limit})))
            await cached.close()
            return auth.remaining

        assert run(main()) == 6
    finally:
        server.stop()
        backend.close()


def test_an_authority_that_cannot_bind_raises():
    backend = T.InMemoryStorage()
    with pytest.raises(T.StorageError, match="cannot bind authority"):
        T.serve_authority(backend, "256.0.0.1:1")


def test_the_apply_warm_up_is_nothing_on_the_cpu():
    from limitador_tpu_torch.device import TorchStorage
    from limitador_tpu_torch.device.sharded import TorchShardedStorage
    from limitador_tpu_torch.ops import kernel as K

    before = dict(K.launches)
    for storage in (TorchStorage(capacity=64, device="cpu"),
                    TorchShardedStorage(n_shards=2, local_capacity=64,
                                        global_region=4, device="cpu")):
        storage.warm_apply()
        storage.close()
    assert dict(K.launches) == before


# -- the wire both ways ---------------------------------------------------------


_WIRE_LIMITS = (("ns", 6, 60, [], ["u"], "per-user"),
                ("ns", 20, 120, [], [], "total"))


def _wire_drive(R, A):
    """A replica of package ``R`` over an InMemoryStorage authority of
    package ``A`` (one frozen clock): answers, the authority's counters
    after each flush, a DeleteCounters and a Clear."""
    clock = Clock()
    backend = A.InMemoryStorage(clock=clock)
    server = serve(A, backend)
    try:
        async def main():
            cached = R.CachedCounterStorage(
                R.RemoteAuthority(f"127.0.0.1:{server.port}"),
                flush_period=3600, clock=clock)
            limiter = R.AsyncRateLimiter(cached)
            limits = [R.Limit(ns, mx, s, c, v, name=n)
                      for ns, mx, s, c, v, n in _WIRE_LIMITS]
            auth_limits = {A.Limit(ns, mx, s, c, v, name=n)
                           for ns, mx, s, c, v, n in _WIRE_LIMITS}
            for limit in limits:
                limiter.add_limit(limit)
            rng = random.Random(3)
            out = []
            for wave in range(3):
                for _ in range(12):
                    r = await limiter.check_rate_limited_and_update(
                        "ns", R.Context({"u": f"u{rng.randrange(4)}"}),
                        rng.choice([1, 2]), load_counters=True)
                    out.append(_answer(r))
                await limiter.update_counters(
                    "ns", R.Context({"u": "u0"}), 1)
                await cached.flush()
                out.append(_counter_rows(backend.get_counters(auth_limits)))
                clock.t += 30
            await limiter.delete_limit(limits[0])
            out.append(_counter_rows(backend.get_counters(auth_limits)))
            await limiter.storage.clear()
            out.append(_counter_rows(backend.get_counters(auth_limits)))
            await cached.close()
            return out

        return run(main())
    finally:
        stop(server)


@pytest.mark.parametrize("replica,authority", [("jax", "port"),
                                               ("port", "jax"),
                                               ("port", "port")])
def test_the_wire_works_between_the_packages(replica, authority):
    pkgs = {"jax": J, "port": T}
    want = _wire_drive(J, J)
    assert _wire_drive(pkgs[replica], pkgs[authority]) == want
    assert any(step[0] for step in want if isinstance(step, tuple))


# -- a replica over a device table: the port against the JAX package -----------


def _tables(kind, clock):
    if kind == "torch":
        from limitador_tpu.tpu.storage import TpuStorage
        from limitador_tpu_torch.device import TorchStorage

        return (TpuStorage(capacity=8192, clock=clock),
                TorchStorage(capacity=8192, clock=clock, device="cpu"))
    from limitador_tpu.tpu.sharded import TpuShardedStorage
    from limitador_tpu_torch.device.sharded import TorchShardedStorage

    return (TpuShardedStorage(local_capacity=1024, global_region=64,
                              clock=clock),
            TorchShardedStorage(n_shards=8, local_capacity=1024,
                                global_region=64, clock=clock,
                                device="cpu"))


def _arrays(storage):
    state = storage._state
    if isinstance(state.values, torch.Tensor):
        return [t.numpy().copy() for t in state]
    return [np.asarray(t) for t in state]


def _device_drive(P, table, clock, users, batch_size, waves=2):
    """A replica of package ``P`` over ``table`` served as its authority:
    a wave of one-hit checks over ``users`` Zipf-like users, one flush of
    every counter the wave touched, twice; every answer, and the deltas
    the table received (key, delta) in order."""
    received = []
    apply = table.apply_deltas

    def recording(items):
        received.append([(P.key_for_counter(c), d) for c, d in items])
        return apply(items)

    table.apply_deltas = recording
    server = serve(P, table)
    try:
        async def main():
            cached = P.CachedCounterStorage(
                P.RemoteAuthority(f"127.0.0.1:{server.port}", timeout=60),
                flush_period=3600, batch_size=batch_size, clock=clock)
            limiter = P.AsyncRateLimiter(cached)
            limiter.add_limit(P.Limit("ns", 3, 60, [], ["u"], name="user"))
            limiter.add_limit(P.Limit("ns", 1_000_000, 60, [], [],
                                      name="all"))
            rng = np.random.default_rng(7)
            weights = 1.0 / np.arange(1, users + 1) ** 0.99
            out = []
            for _wave in range(waves):
                picks = rng.choice(users, size=users + users // 2,
                                   p=weights / weights.sum())
                for u in np.concatenate([np.arange(users), picks]):
                    r = await limiter.check_rate_limited_and_update(
                        "ns", P.Context({"u": f"u{u}"}), 1)
                    out.append((r.limited, r.limit_name))
                await cached.flush()
                clock.t += 1.0
            await cached.close()
            return out

        return run(main()), received
    finally:
        stop(server)
        del table.apply_deltas


@pytest.mark.parametrize("kind,users,batch_size", [
    ("torch", 8, 100), ("torch", 100, 100), ("torch", 2001, 4096),
    ("torch", 2500, 4096), ("sharded", 64, 100), ("sharded", 2500, 4096)])
def test_a_replica_over_a_device_authority_matches_jax(kind, users,
                                                       batch_size):
    clock = Clock(1_700_000_000.0)
    jtable, ttable = _tables(kind, clock)
    try:
        janswers, jdeltas = _device_drive(J, jtable, clock, users,
                                          batch_size)
        clock.t = 1_700_000_000.0
        tanswers, tdeltas = _device_drive(T, ttable, clock, users,
                                          batch_size)
        assert tanswers == janswers
        assert tdeltas == jdeltas
        # one RPC a flush carries every counter the wave touched
        assert max(len(batch) for batch in tdeltas) == users + 1
        assert any(limited for limited, _name in tanswers)
        for j, t in zip(_arrays(jtable), _arrays(ttable)):
            np.testing.assert_array_equal(j, t)
    finally:
        jtable.close()
        ttable.close()


# -- served checks and authority RPCs on one storage at once ------------------------

SERVED_LIMITS = """\
- namespace: api
  max_value: 1000000
  seconds: 3600
  variables: ["descriptors[0].user"]
  name: per-user
"""


def _request(user, hits=1) -> bytes:
    req = rls_pb2.RateLimitRequest(domain="api", hits_addend=hits)
    d = req.descriptors.add()
    d.entries.add(key="user", value=user)
    return req.SerializeToString()


@pytest.mark.parametrize("storage,pipeline", [("torch", "native"),
                                              ("torch", "standard"),
                                              ("sharded", "compiled")])
def test_served_checks_and_authority_rpcs_at_once(tmp_path, storage,
                                                  pipeline):
    """ShouldRateLimit calls through the server's pipeline and ApplyDeltas
    RPCs from four threads on the same counters, then a DeleteCounters
    and more of both: the table ends equal to an oracle fed every hit,
    and no check after the delete sees a counter it dropped."""
    from limitador_tpu_torch.core.counter import Counter

    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(SERVED_LIMITS)
    argv = [str(limits_path), storage, "--device", "cpu", "--capacity",
            "4096", "--pipeline", pipeline, "--usage-topk", "0",
            "--rls-host", "127.0.0.1", "--rls-port", str(free_port()),
            "--http-host", "127.0.0.1", "--http-port", str(free_port()),
            "--flight-spool-dir", str(tmp_path / "flight"),
            "--authority-listen", "127.0.0.1:0"]
    users = [f"u{i}" for i in range(24)]
    limit = T.Limit("api", 1000000, 3600, [], ["descriptors[0].user"],
                    name="per-user")

    async def main():
        server = await port_main.start(port_main.build_parser().parse_args(
            argv))
        oracle = {u: 0 for u in users}
        lock = threading.Lock()
        url = f"127.0.0.1:{server.authority.port}"
        rls = argv[argv.index("--rls-port") + 1]
        try:
            async def checks(rounds, seed):
                rng = random.Random(seed)
                async with grpc.aio.insecure_channel(
                        f"127.0.0.1:{rls}") as channel:
                    call = channel.unary_unary(ENVOY)
                    for _ in range(rounds):
                        batch = [rng.choice(users) for _ in range(8)]
                        blobs = await asyncio.gather(*(
                            call(_request(u)) for u in batch))
                        for u, blob in zip(batch, blobs):
                            code = rls_pb2.RateLimitResponse.FromString(
                                blob).overall_code
                            assert code == rls_pb2.RateLimitResponse.OK
                            with lock:
                                oracle[u] += 1

            def rpcs(seed):
                rng = random.Random(seed)
                remote = T.RemoteAuthority(url, timeout=30)
                try:
                    for _ in range(30):
                        items = [(Counter(limit, {
                            "descriptors[0].user": rng.choice(users)}),
                            rng.randrange(1, 4))
                            for _ in range(rng.randrange(1, 6))]
                        remote.apply_deltas(items)
                        with lock:
                            for c, d in items:
                                oracle[c.set_variables[
                                    "descriptors[0].user"]] += d
                finally:
                    remote.close()

            async def phase(seed):
                loop = asyncio.get_running_loop()
                await asyncio.gather(
                    checks(12, seed),
                    *(loop.run_in_executor(None, rpcs, seed * 10 + i)
                      for i in range(4)))

            def table():
                return {c.set_variables["descriptors[0].user"]:
                        c.limit.max_value - c.remaining
                        for c in server.storage.get_counters({limit})}

            await phase(1)
            assert table() == {u: n for u, n in oracle.items() if n}
            remote = T.RemoteAuthority(url, timeout=30)
            try:
                remote.delete_counters({limit})
            finally:
                remote.close()
            assert table() == {}
            for u in users:
                oracle[u] = 0
            await phase(2)
            assert table() == {u: n for u, n in oracle.items() if n}
            stats = server.authority.stats()
            assert stats["apply_deltas"] == 240
            assert stats["delete_counters"] == 1 and stats["errors"] == 0
        finally:
            await server.stop()

    run(main())


# -- the server ---------------------------------------------------------------------

HOST_LIMITS = """\
- namespace: ns
  max_value: 100
  seconds: 60
  variables: ["descriptors[0].u"]
"""


def _argv(tmp_path, storage, *extra):
    limits_path = tmp_path / "limits.yaml"
    if not limits_path.exists():
        limits_path.write_text(HOST_LIMITS)
    return [str(limits_path), storage, "--rls-host", "127.0.0.1",
            "--rls-port", str(free_port()), "--http-host", "127.0.0.1",
            "--http-port", str(free_port()), "--flight-spool-dir",
            str(tmp_path / "flight"), *extra]


def _http_get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return resp.read().decode()


def _http_post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", json.dumps(body).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status


def _metric(text, name):
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


@pytest.mark.parametrize("storage", ["torch", "sharded", "memory", "disk"])
def test_authority_listen_serves_every_storage_with_apply_deltas(
        tmp_path, storage):
    extra = {"torch": ("--device", "cpu", "--capacity", "1024"),
             "sharded": ("--device", "cpu", "--capacity", "1024",
                         "--global-region", "16"),
             "memory": (),
             "disk": ("--disk-path", str(tmp_path / "auth.db"))}[storage]
    argv = _argv(tmp_path, storage, *extra, "--authority-listen",
                 "127.0.0.1:0")
    http = int(argv[argv.index("--http-port") + 1])

    async def main():
        server = await port_main.start(port_main.build_parser().parse_args(
            argv))
        loop = asyncio.get_running_loop()
        try:
            replicas = [T.CachedCounterStorage(T.RemoteAuthority(
                f"127.0.0.1:{server.authority.port}"), flush_period=3600)
                for _ in range(2)]
            limit = T.Limit("ns", 100, 60, [], ["descriptors[0].u"])
            for i, replica in enumerate(replicas):
                limiter = T.AsyncRateLimiter(replica)
                limiter.add_limit(limit)
                ctx = T.Context()
                ctx.list_binding("descriptors", [{"u": "shared"}])
                await limiter.check_rate_limited_and_update("ns", ctx,
                                                            5 + i)
                await replica.flush()
            counters = json.loads(await loop.run_in_executor(
                None, _http_get, http, "/counters/ns"))
            stats = json.loads(await loop.run_in_executor(
                None, _http_get, http, "/debug/stats"))["authority"]
            for replica in replicas:
                await replica.close()
            return counters, stats
        finally:
            await server.stop()

    counters, stats = run(main())
    assert [c["remaining"] for c in counters] == [89]
    assert stats["apply_deltas"] == 2 and stats["items"] == 2
    assert stats["errors"] == 0 and stats["port"] > 0


def test_a_cached_server_flushes_to_its_default_disk_authority(tmp_path):
    from limitador_tpu_torch.storage.disk import DiskStorage

    db = tmp_path / "cached.db"
    argv = _argv(tmp_path, "cached", "--disk-path", str(db),
                 "--flush-period", "3600000")
    http = int(argv[argv.index("--http-port") + 1])

    async def main():
        server = await port_main.start(port_main.build_parser().parse_args(
            argv))
        loop = asyncio.get_running_loop()
        try:
            cached = server.limiter.storage.counters
            assert (cached.flush_period, cached.batch_size,
                    cached.max_cached) == (3600.0, 100, 10_000)
            for _ in range(3):
                assert await loop.run_in_executor(
                    None, _http_post, http, "/check_and_report",
                    {"namespace": "ns", "values": {"u": "a"},
                     "delta": 2}) == 200
            await cached.flush()
            metrics = await loop.run_in_executor(None, _http_get, http,
                                                 "/metrics")
        finally:
            await server.stop()
        return metrics

    metrics = run(main())
    # a flush for each write (its window ends before two flush periods)
    flushes = _metric(metrics, "batcher_flush_size_count")
    assert flushes >= 1
    assert _metric(metrics, "datastore_latency_count") >= flushes
    assert _metric(metrics, "counter_overshoot_total") == 0.0
    assert _metric(metrics, "evicted_pending_writes_total") == 0.0
    disk = DiskStorage(str(db))
    try:
        rows = disk._db.execute("SELECT value FROM counters").fetchall()
    finally:
        disk.close()
    assert rows == [(6,)]


def test_datastore_partitioned_follows_the_replica(tmp_path):
    """A replica whose authority is down reports datastore_partitioned 1
    after a flush and keeps answering; once the authority serves on that
    port, the next flush delivers the held deltas and the gauge is 0."""
    from limitador_tpu_torch.storage.in_memory import InMemoryStorage

    backend = InMemoryStorage()
    first = serve(T, backend)
    port = first.port
    first.stop(grace=0)
    argv = _argv(tmp_path, "cached", "--authority-url",
                 f"127.0.0.1:{port}", "--response-timeout", "300",
                 "--flush-period", "3600000")
    http = int(argv[argv.index("--http-port") + 1])

    async def main():
        server = await port_main.start(port_main.build_parser().parse_args(
            argv))
        loop = asyncio.get_running_loop()
        cached = server.limiter.storage.counters
        authority = None
        try:
            for _ in range(4):
                assert await loop.run_in_executor(
                    None, _http_post, http, "/check_and_report",
                    {"namespace": "ns", "values": {"u": "a"},
                     "delta": 1}) == 200
            await cached.flush()
            down = _metric(await loop.run_in_executor(
                None, _http_get, http, "/metrics"), "datastore_partitioned")
            authority = serve(T, backend, port)
            deadline = time.monotonic() + 10
            while cached.partitioned:
                assert time.monotonic() < deadline
                await asyncio.sleep(0.1)
                await cached.flush()
            up = _metric(await loop.run_in_executor(
                None, _http_get, http, "/metrics"), "datastore_partitioned")
            held = [c.remaining for c in backend.get_counters(
                set(server.limiter.get_limits("ns")))]
            return down, up, held
        finally:
            await server.stop()
            if authority is not None:
                authority.stop()

    assert run(main()) == (1.0, 0.0, [96])


#: a server's log when a port picked free was taken before it bound it
BIND_FAILURES = ("ddress already in use", "could not bind",
                 "Failed to bind", "cannot bind")


def test_three_server_processes_share_one_torch_authority(tmp_path):
    """An authority process (torch storage on the CPU, --authority-listen
    on port 0, read back from /debug/stats) and two cached replica
    processes at the default 1 s flush: the authority's counters equal
    the sum of both replicas' hits within 10 s."""
    limits = tmp_path / "limits.yaml"
    limits.write_text(HOST_LIMITS)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = []

    def start(storage, *extra):
        """Spawn a server and wait until it serves; returns its HTTP port
        and first /debug/stats. Its ports are picked free before it binds
        them, so another process can take one in between: a server that
        exits on a bind failure starts again on fresh ports, and one that
        exits for another reason fails at once with its log."""
        for attempt in range(3):
            http = free_port()
            err = tmp_path / f"server{len(procs)}.err"
            with open(err, "w") as log:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "limitador_tpu_torch.server",
                     str(limits), storage, "--rls-host", "127.0.0.1",
                     "--rls-port", str(free_port()), "--http-host",
                     "127.0.0.1", "--http-port", str(http),
                     "--flight-spool-dir",
                     str(tmp_path / f"flight{len(procs)}"), *extra],
                    cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                    stderr=log)
            procs.append(proc)
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                try:
                    stats = json.loads(_http_get(http, "/debug/stats"))
                except Exception:
                    stats = None
                if proc.poll() is not None:
                    break
                if stats is not None:
                    return http, stats
                time.sleep(0.2)
            else:
                raise AssertionError("server never came up")
            text = err.read_text()
            if attempt == 2 or not any(m in text for m in BIND_FAILURES):
                raise AssertionError(
                    f"server exited {proc.returncode}:\n{text[-3000:]}")
        raise AssertionError("unreachable")

    try:
        auth_http, stats = start("torch", "--device", "cpu", "--capacity",
                                 "1024", "--usage-topk", "0",
                                 "--authority-listen", "127.0.0.1:0")
        port = stats["authority"]["port"]
        replicas = [start("cached", "--authority-url",
                          f"127.0.0.1:{port}")[0] for _ in range(2)]
        for i, http in enumerate(replicas):
            assert _http_post(http, "/check_and_report", {
                "namespace": "ns", "values": {"u": "shared"},
                "delta": 4 + i}) == 200
        deadline = time.monotonic() + 10
        counters = []
        while time.monotonic() < deadline:
            counters = json.loads(_http_get(auth_http, "/counters/ns"))
            if counters and counters[0]["remaining"] == 91:
                break
            time.sleep(0.25)
        assert [c["remaining"] for c in counters] == [91]
        metrics = [_http_get(http, "/metrics") for http in replicas]
        assert all(_metric(m, "datastore_partitioned") == 0.0
                   for m in metrics)
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
