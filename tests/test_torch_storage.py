"""Op-stream parity of the port's TorchStorage with the JAX package.

The same operations, on one fake clock, go through three storages:
``TorchStorage(device="cpu")`` (the port, running its kernels' plain
versions), the JAX package's ``TpuStorage`` and its ``InMemoryStorage``
(the exact host reference). Each test builds its ``Limit``, ``Counter``
and ``Context`` objects once per package, from the same specs.

The port and ``TpuStorage`` quantize time to the same milliseconds, so
between them everything is compared exactly: decisions, limit names,
loaded ``remaining`` and ``expires_in``, final counters. Against
``InMemoryStorage`` (float seconds) ttl is compared within 2 ms, as
``tests/test_tpu_parity.py`` does.
"""

import random

import numpy as np
import pytest
import torch

import limitador_tpu as J
import limitador_tpu_torch as T
from limitador_tpu.tpu.storage import TpuStorage, _Request as JRequest
from limitador_tpu_torch.convert import storage_from_state
from limitador_tpu_torch.device.storage import TorchStorage
from limitador_tpu_torch.device.storage import _Request as TRequest


class FakeClock:
    def __init__(self):
        self.now = 1_700_000_000.0

    def __call__(self):
        return self.now

    def advance(self, s):
        self.now += s


LIMITS = [
    dict(namespace="ns", max_value=5, seconds=60,
         conditions=["descriptors[0].m == 'GET'"],
         variables=["descriptors[0].u"], name="l5"),
    dict(namespace="ns", max_value=12, seconds=10,
         variables=["descriptors[0].u"], name="l12"),
    dict(namespace="ns", max_value=30, seconds=3600, name="l30"),
    dict(namespace="ns2", max_value=3, seconds=1,
         variables=["descriptors[0].u"]),
    dict(namespace="tb", max_value=7, seconds=2,
         variables=["descriptors[0].u"], policy="token_bucket", name="tb7"),
    dict(namespace="tb", max_value=50, seconds=10,
         variables=["descriptors[0].u"], policy="token_bucket"),
    # beyond the device's int32 caps: decided on the exact host path
    dict(namespace="ns", max_value=3 << 30, seconds=60,
         variables=["descriptors[0].u"], name="big"),
    dict(namespace="tb", max_value=5000, seconds=1,
         variables=["descriptors[0].u"], policy="token_bucket",
         name="fast"),
]
# The JAX package's host path for beyond-cap fixed windows differs from
# its own oracle (ROADMAP.md, Queue C): a rejected check creates no
# window, and an expired cell loads expires_in = the full window. The
# port matches the JAX package there exactly; "big" is left out of the
# comparisons with the oracle only.
JAX_ORACLE_GAP = "big"
# convert.py carries the device table and slot map, not host-path cells
DEVICE_LIMITS = [s for s in LIMITS if s.get("name") not in ("big", "fast")]


def _ctx(pkg, values):
    ctx = pkg.Context()
    ctx.list_binding("descriptors", [values])
    return ctx


def _limiters(clock, capacity=1 << 12, cache_size=None):
    """name -> (package, limiter) over one clock. With a cache_size the
    device storages evict, and the oracle (which would not) is left out."""
    out = {
        "torch": (T, T.RateLimiter(TorchStorage(
            capacity=capacity, cache_size=cache_size, clock=clock,
            device="cpu"))),
        "tpu": (J, J.RateLimiter(TpuStorage(
            capacity=capacity, cache_size=cache_size, clock=clock))),
    }
    if cache_size is None:
        out["mem"] = (J, J.RateLimiter(J.InMemoryStorage(clock=clock)))
    return out


def _loaded(result):
    return sorted(
        (tuple(c.set_variables.items()), c.limit.name or "", c.remaining,
         c.expires_in)
        for c in result.counters
    )


def _assert_same(results, what):
    t, j = results["torch"], results["tpu"]
    assert t == j, f"{what}: port {t} != jax {j}"
    if "mem" not in results:
        return
    m = results["mem"]
    if isinstance(t, list):  # loaded counters: ttl within 2ms of the oracle
        t = [a for a in t if a[1] != JAX_ORACLE_GAP]
        m = [b for b in m if b[1] != JAX_ORACLE_GAP]
        assert len(t) == len(m), what
        for a, b in zip(t, m):
            assert a[:3] == b[:3], f"{what}: {a} vs oracle {b}"
            assert abs(a[3] - b[3]) <= 0.002, f"{what}: {a} vs oracle {b}"
    else:
        assert t == m, f"{what}: port {t} != oracle {m}"


def _counters(limiter, ns):
    return {
        (tuple(c.set_variables.items()), c.window_seconds,
         c.limit.policy, c.limit.name): (c.remaining, c.expires_in)
        for c in limiter.get_counters(ns)
    }


def _assert_final(limiters, namespaces):
    for ns in namespaces:
        got = {name: _counters(lim, ns) for name, (_p, lim) in
               limiters.items()}
        assert got["torch"] == got["tpu"], ns
        if "mem" not in got:
            continue
        port, oracle = (
            {k: v for k, v in got[name].items() if k[3] != JAX_ORACLE_GAP}
            for name in ("torch", "mem")
        )
        assert port.keys() == oracle.keys(), ns
        for k, (rem, ttl) in port.items():
            assert rem == oracle[k][0], (ns, k)
            assert abs(ttl - oracle[k][1]) <= 0.002, (ns, k)


def _drive(limiters, clock, rng, steps, users, namespaces):
    for step in range(steps):
        op = rng.random()
        ns = rng.choice(namespaces)
        values = {"m": rng.choice(["GET", "POST"]), "u": rng.choice(users)}
        delta = rng.choice([1, 1, 1, 2, 5])
        if op < 0.6:
            load = rng.random() < 0.5
            out = {}
            for name, (pkg, lim) in limiters.items():
                r = lim.check_rate_limited_and_update(
                    ns, _ctx(pkg, values), delta, load)
                out[name] = (r.limited, r.limit_name, _loaded(r))
            _assert_same({k: v[:2] for k, v in out.items()},
                         f"step {step} check")
            _assert_same({k: v[2] for k, v in out.items()},
                         f"step {step} loaded")
        elif op < 0.75:
            for pkg, lim in limiters.values():
                lim.update_counters(ns, _ctx(pkg, values), delta)
        elif op < 0.9:
            _assert_same({
                name: lim.is_rate_limited(ns, _ctx(pkg, values),
                                          delta).limited
                for name, (pkg, lim) in limiters.items()
            }, f"step {step} is_rate_limited")
        else:
            clock.advance(rng.choice([0.05, 0.3, 1.0, 5.0, 11.0]))


def _add_limits(limiters, specs):
    for pkg, lim in limiters.values():
        for spec in specs:
            lim.add_limit(pkg.Limit(**spec))


@pytest.mark.parametrize("seed", range(4))
def test_op_stream_parity(seed):
    clock = FakeClock()
    limiters = _limiters(clock)
    _add_limits(limiters, LIMITS)
    rng = random.Random(seed)
    _drive(limiters, clock, rng, 250, [str(i) for i in range(6)],
           ["ns", "ns", "ns2", "tb"])
    _assert_final(limiters, ["ns", "ns2", "tb"])


def test_lru_eviction_and_recycled_slots_parity():
    """A small qualified cache forces evictions: recycled slots carry the
    previous occupant's cell, which the kernels' fresh flag overrides."""
    clock = FakeClock()
    limiters = _limiters(clock, capacity=64, cache_size=8)
    _add_limits(limiters, LIMITS)
    rng = random.Random(11)
    _drive(limiters, clock, rng, 300, [str(i) for i in range(40)],
           ["ns", "tb"])
    _assert_final(limiters, ["ns", "tb"])


def test_month_long_idle_rebases_the_epoch_identically():
    clock = FakeClock()
    limiters = _limiters(clock)
    _add_limits(limiters, LIMITS)
    rng = random.Random(5)
    _drive(limiters, clock, rng, 60, ["a", "b"], ["ns", "tb"])
    clock.advance(40 * 24 * 3600)  # > 2^31 ms: a chunked rebase
    _drive(limiters, clock, rng, 60, ["a", "b"], ["ns", "tb"])
    clock.advance(13 * 24 * 3600)  # > 2^30 ms: one more rebase
    _drive(limiters, clock, rng, 60, ["a", "b"], ["ns", "tb"])
    _assert_final(limiters, ["ns", "tb"])
    port = limiters["torch"][1].storage.counters
    jax_storage = limiters["tpu"][1].storage.counters
    assert port._epoch == jax_storage._epoch
    np.testing.assert_array_equal(
        port._state.expiry_ms.numpy(), np.asarray(jax_storage._state.expiry_ms)
    )


@pytest.mark.parametrize("seed", range(3))
def test_batched_check_many_parity(seed):
    """Whole contended batches through check_many (one kernel launch per
    batch), with multi-counter requests and a mix of load flags: the same
    decisions and loaded counters as the JAX storage, and the same table
    afterwards."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    port = TorchStorage(capacity=1 << 10, clock=clock, device="cpu")
    ref = TpuStorage(capacity=1 << 10, clock=clock)
    limits = {pkg: [pkg.Limit(**spec) for spec in LIMITS] for pkg in (T, J)}
    for _round in range(5):
        picks = []
        for _ in range(int(rng.integers(1, 300))):
            n = int(rng.integers(1, 3))
            idx = rng.choice(len(LIMITS), n, replace=False)
            user = str(int(rng.zipf(1.5)) % 50)
            picks.append((idx, user, int(rng.integers(1, 4)),
                          bool(rng.random() < 0.5)))
        batches = {}
        for pkg, Req in ((T, TRequest), (J, JRequest)):
            batches[pkg] = [
                Req([pkg.Counter(limits[pkg][i], {
                    v: user for v in LIMITS[i].get("variables", [])
                }) for i in idx], delta, load)
                for idx, user, delta, load in picks
            ]
        got = port.check_many(batches[T])
        want = ref.check_many(batches[J])
        assert [(a.limited, a.limit_name) for a in got] == [
            (a.limited, a.limit_name) for a in want]
        for rt, rj in zip(batches[T], batches[J]):
            assert [(c.remaining, c.expires_in) for c in rt.ordered] == [
                (c.remaining, c.expires_in) for c in rj.ordered]
        clock.advance(float(rng.choice([0.0, 0.4, 3.0])))
    for name in ("values", "expiry_ms", "hits"):
        np.testing.assert_array_equal(
            getattr(port._state, name).numpy(),
            np.asarray(getattr(ref._state, name)), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_check_columnar_parity(seed):
    """Request-ordered hit columns (padded by ``pad_hits``) through
    ``check_columnar``, fixed windows and buckets, fresh flags and
    contended slots: the same four result columns as the JAX storage,
    and the same table afterwards (exact)."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    port = TorchStorage(capacity=1 << 8, clock=clock, device="cpu")
    ref = TpuStorage(capacity=1 << 8, clock=clock)
    lanes = {int(s): (bool(rng.random() < 0.3), int(rng.integers(1, 20)),
                      int(rng.choice([1000, 5000, 60_000])))
             for s in range(1 << 8)}
    for _round in range(6):
        nreq = int(rng.integers(1, 120))
        cols = [[] for _ in range(7)]
        for r in range(nreq):
            for s in rng.choice(1 << 8, int(rng.integers(1, 3)),
                                replace=False):
                bucket, maxv, win = lanes[int(s)]
                for col, v in zip(cols, (
                    int(s), int(rng.choice([0, 1, 1, 2, 7])), maxv,
                    win // maxv if bucket else win, r,
                    bool(rng.random() < 0.05), bucket,
                )):
                    col.append(v)
        nhits = len(cols[0])
        arrays = tuple(np.asarray(c, t) for c, t in zip(
            cols, (np.int32,) * 5 + (bool,) * 2))
        got = port.check_columnar(*port.pad_hits(arrays, nhits))
        want = ref.check_columnar(*ref.pad_hits(arrays, nhits))
        for name, a, b in zip(("admitted", "hit_ok", "remaining", "ttl_ms"),
                              got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)
        clock.advance(float(rng.choice([0.0, 0.7, 6.0])))
    for name in ("values", "expiry_ms", "hits"):
        np.testing.assert_array_equal(
            getattr(port._state, name).numpy(),
            np.asarray(getattr(ref._state, name)), err_msg=name)


def test_convert_continues_from_a_mid_stream_jax_table():
    """Drive the JAX storage alone, carry its table, slot map and epoch
    into a TorchStorage, then drive both on: they decide alike."""
    clock = FakeClock()
    jax_lim = J.RateLimiter(TpuStorage(capacity=1 << 12, clock=clock))
    mem_lim = J.RateLimiter(J.InMemoryStorage(clock=clock))
    rng = random.Random(3)
    for lim in (jax_lim, mem_lim):
        for spec in DEVICE_LIMITS:
            lim.add_limit(J.Limit(**spec))
    for _ in range(150):
        values = {"m": rng.choice(["GET", "POST"]),
                  "u": rng.choice("abcdef")}
        ns = rng.choice(["ns", "ns2", "tb"])
        for lim in (jax_lim, mem_lim):
            lim.check_rate_limited_and_update(ns, _ctx(J, values), 1)
        clock.advance(rng.choice([0.0, 0.2, 1.0]))
    src = jax_lim.storage.counters
    dump = src._table.dump()
    dump["info"] = {s: (k, c.to_dict()) for s, (k, c) in dump["info"].items()}
    port = storage_from_state(
        dump, *(np.asarray(a) for a in src._state), src._epoch,
        clock=clock, device="cpu",
    )
    torch_lim = T.RateLimiter(port)
    for spec in DEVICE_LIMITS:
        torch_lim.add_limit(T.Limit(**spec))
    limiters = {"torch": (T, torch_lim), "tpu": (J, jax_lim),
                "mem": (J, mem_lim)}
    _assert_final(limiters, ["ns", "ns2", "tb"])
    _drive(limiters, clock, rng, 200, list("abcdef"), ["ns", "ns2", "tb"])
    _assert_final(limiters, ["ns", "ns2", "tb"])


def test_hot_reload_keeps_surviving_counters_and_clears_deleted():
    clock = FakeClock()
    limiters = _limiters(clock)
    _add_limits(limiters, LIMITS)
    rng = random.Random(8)
    _drive(limiters, clock, rng, 120, list("abc"), ["ns", "ns2"])
    kept = [s for s in LIMITS if s.get("name") != "l12"]
    for pkg, lim in limiters.values():
        lim.configure_with([pkg.Limit(**s) for s in kept])
    _assert_final(limiters, ["ns", "ns2"])
    for pkg, lim in limiters.values():
        lim.configure_with([pkg.Limit(**s) for s in LIMITS])
    _drive(limiters, clock, rng, 120, list("abc"), ["ns", "ns2"])
    _assert_final(limiters, ["ns", "ns2"])


def test_default_device_is_the_card():
    """TorchStorage() without a device means the card: without CUDA it
    raises rather than counting on the CPU."""
    if torch.cuda.is_available():
        assert TorchStorage(capacity=8).device.type == "cuda"
    else:
        with pytest.raises(T.StorageError, match="CUDA"):
            TorchStorage(capacity=8)
    assert TorchStorage(capacity=8, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("cache_size", [None, 8], ids=["roomy", "evicting"])
def test_snapshot_and_restore_parity(tmp_path, cache_size):
    """Each package snapshots mid-stream (its own format) and restores
    into a new storage, with table, key space and big cells intact: the
    restored storages equal each other in every array and go on deciding
    alike, and the Report path's batched apply_deltas returns the same
    (value, ttl) rows."""
    clock = FakeClock()
    limiters = _limiters(clock, capacity=64, cache_size=cache_size)
    limiters.pop("mem", None)
    _add_limits(limiters, LIMITS)
    rng = random.Random(5)
    users = [str(i) for i in range(12)]
    _drive(limiters, clock, rng, 150, users, ["ns", "tb"])
    restored = {}
    for name, cls in (("torch", TorchStorage), ("tpu", TpuStorage)):
        pkg, lim = limiters[name]
        path = str(tmp_path / f"{name}.ckpt")
        lim.storage.counters.snapshot(path)
        if name == "torch":
            storage = cls.restore(path, clock=clock, device="cpu")
        else:
            storage = cls.restore(path, clock=clock)
        assert storage._capacity == 64
        restored[name] = (pkg, pkg.RateLimiter(storage))
    _add_limits(restored, LIMITS)
    t, j = (restored[n][1].storage.counters for n in ("torch", "tpu"))
    # the hit accumulator is telemetry: both restore it as zeros
    for name, a, b in zip(("values", "expiry_ms", "hits"), t._state,
                          j._state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    assert t._table.info.keys() == j._table.info.keys()
    assert t._epoch == j._epoch
    assert sorted(map(str, t._big)) == sorted(map(str, j._big))
    _assert_final(restored, ["ns", "tb"])
    spec = {s.get("name"): s for s in LIMITS}
    items = {
        name: [(pkg.Counter(pkg.Limit(**spec[n]), {"descriptors[0].u": u}), d)
               for n, u, d in (("l12", "1", 2), ("tb7", "2", 1),
                               ("big", "3", 5), ("l12", "1", 1))]
        for name, (pkg, _lim) in restored.items()
    }
    assert t.apply_deltas(items["torch"]) == j.apply_deltas(items["tpu"])
    _drive(restored, clock, rng, 100, users, ["ns", "tb"])
    _assert_final(restored, ["ns", "tb"])
