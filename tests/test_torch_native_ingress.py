"""The port's native HTTP/2 ingress (``native/ingress.py``) through a
real gRPC client, on the CPU.

- Serial: the same request sequence to the port's ingress over
  ``TorchStorage`` and to the JAX package's over ``TpuStorage`` gives
  byte-equal answers, with the hot lane on (the coded pump) and off (the
  pipelined pump): limits enforced, an empty domain, an unmatched
  descriptor, ``hits_addend``, rows of several descriptors (the exact
  path), an unknown namespace, a second connection; and a response large
  enough to need flow control, from a fake pipeline behind each.
- Concurrent, held to the in-memory oracle and NOT to the JAX ingress
  (whose hot lane over-admits here: ROADMAP Queue C): 4,000 calls for one
  key of max 3 from 16 threads on one channel admit exactly 3, 1,000
  calls over 50 seeded users admit min(3, calls) each, and the table then
  equals an ``InMemoryStorage`` fed the admitted hits; with the coded
  pump, the uncoded pump (the hot lane on, no outcome templates) and the
  hot lane off.
- The admission breaker forced open sends every row to the exact path
  (no columnar begin); the ingress closes cleanly under a slow call
  still pending on the loop; the reflection stream's answer locks are
  per stream; ``stats()`` counts as the JAX ingress's does.

Every client call has its own timeout; every ingress, loop and thread
is closed or joined in teardown (``tests/torch_steady.py``).
"""

import asyncio
import threading
from concurrent.futures import ThreadPoolExecutor

import grpc
import numpy as np
import pytest

from limitador_tpu import Limit as JLimit
from limitador_tpu.native import ingress as jax_ingress
from limitador_tpu.tpu import AsyncTpuStorage, TpuStorage
from limitador_tpu.tpu.native_pipeline import NativeRlsPipeline as JNative
from limitador_tpu.tpu.pipeline import CompiledTpuLimiter
from limitador_tpu_torch import Context, RateLimiter
from limitador_tpu_torch import Limit as TLimit
from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage
from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
from limitador_tpu_torch.native import ingress as port_ingress
from limitador_tpu_torch.server.proto import rls_pb2
from limitador_tpu_torch.storage.in_memory import InMemoryStorage

from .torch_reference import jax_reference_ingress  # noqa: F401 (autouse)
from .torch_reference import jax_reference_lane  # noqa: F401 (autouse)
from .torch_steady import steady

ENVOY = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
D = "descriptors[0]"
OK = rls_pb2.RateLimitResponse(
    overall_code=rls_pb2.RateLimitResponse.OK).SerializeToString()
OVER = rls_pb2.RateLimitResponse(
    overall_code=rls_pb2.RateLimitResponse.OVER_LIMIT).SerializeToString()


def blob(domain="api", hits=0, entries=None, descriptors=None) -> bytes:
    req = rls_pb2.RateLimitRequest(domain=domain, hits_addend=hits)
    for desc in descriptors if descriptors is not None else [entries or {}]:
        d = req.descriptors.add()
        for k, v in desc.items():
            d.entries.add(key=k, value=v)
    return req.SerializeToString()


def limits(Limit):
    return [Limit("api", 3, 60, [f"{D}.m == 'GET'"], [f"{D}.u"], name="q")]


class Served:
    """One package's native pipeline behind its ingress, with an event
    loop thread for the exact path and the registered handlers.
    ``mode``: "coded" (the hot lane and its outcome templates), "uncoded"
    (the hot lane without templates: the pipelined pump) or "off" (the
    hot lane off)."""

    def __init__(self, package, mode="coded", handlers=None,
                 stream_path=None):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="ingress-test-loop")
        self.thread.start()
        hot = mode != "off"
        if package == "port":
            self.limiter = CompiledTorchLimiter(AsyncTorchStorage(
                TorchStorage(capacity=1 << 10, device="cpu"),
                max_delay=0.001))
            Limit, Pipeline, module = TLimit, NativeRlsPipeline, port_ingress
        else:
            self.limiter = CompiledTpuLimiter(AsyncTpuStorage(
                TpuStorage(capacity=1 << 10), max_delay=0.001))
            Limit, Pipeline, module = JLimit, JNative, jax_ingress
        for limit in limits(Limit):
            self.limiter.add_limit(limit)
        self.pipeline = Pipeline(self.limiter, None, max_delay=0.001,
                                 hot_lane=hot)
        if mode == "uncoded":
            self.pipeline.lane_code_templates = lambda: None
        self.ingress = module.NativeIngress(
            self.pipeline, host="127.0.0.1", port=0, loop=self.loop,
            poll_ms=2, handlers=handlers, stream_path=stream_path)
        assert self.ingress._coded == (mode == "coded")
        self.channel = grpc.insecure_channel(
            f"127.0.0.1:{self.ingress.port}")
        self.envoy = self.channel.unary_unary(ENVOY)

    def run(self, coro, timeout=30):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout=timeout)

    def close(self):
        self.channel.close()
        self.ingress.close()

        async def shutdown():
            await self.pipeline.close()
            await self.limiter.storage.counters.close()

        try:
            self.run(shutdown())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=10)
            self.loop.close()


@pytest.fixture
def served():
    made = []

    def make(*args, **kwargs):
        made.append(Served(*args, **kwargs))
        return made[-1]

    with steady():
        try:
            yield make
        finally:
            for s in made:
                s.close()


# -- serial: byte-equal with the JAX ingress ---------------------------------


def _serial_sequence():
    alice = blob(entries={"m": "GET", "u": "alice"})
    seq = [alice] * 5
    seq += [blob(domain="")] * 2
    seq += [blob(entries={"m": "POST", "u": "alice"})] * 3
    seq += [blob(hits=3, entries={"m": "GET", "u": "bob"})] * 2
    seq += [blob(descriptors=[{"m": "GET", "u": "carol"},
                              {"other": "x"}])] * 5
    seq += [blob(domain="nope", entries={"u": "z"})] * 2
    seq += [blob(hits=2, entries={"m": "GET", "u": "dan"}),
            blob(entries={"m": "GET", "u": "dan"}),
            blob(entries={"m": "GET", "u": "dan"})]
    return seq


@pytest.mark.parametrize("mode", ["coded", "off"])
def test_serial_answers_equal_the_jax_ingress(served, mode):
    port, jax = served("port", mode), served("jax", mode)
    seq = _serial_sequence()
    got = [port.envoy(b, timeout=15) for b in seq]
    want = [jax.envoy(b, timeout=15) for b in seq]
    assert got == want
    assert got[:5] == [OK, OK, OK, OVER, OVER]
    assert got[5] == rls_pb2.RateLimitResponse().SerializeToString()
    assert got[7:10] == [OK] * 3  # POST: no limit applies
    assert got[10:12] == [OK, OVER]  # hits_addend 3 of max 3
    assert got[12:17] == [OK, OK, OK, OVER, OVER]  # the exact path
    assert got[19:22] == [OK, OK, OVER]  # 2 hits, 1 more, then none left
    # a second connection shares the counters
    erin = blob(entries={"m": "GET", "u": "erin"})
    answers = []
    for s in (port, jax):
        first = s.envoy(erin, timeout=15)
        # its own subchannel pool: a TCP connection of its own
        with grpc.insecure_channel(
                f"127.0.0.1:{s.ingress.port}",
                options=[("grpc.use_local_subchannel_pool", 1)]) as ch2:
            call2 = ch2.unary_unary(ENVOY)
            answers.append([first] + [call2(erin, timeout=15)
                                      for _ in range(4)])
    assert answers[0] == answers[1] == [OK, OK, OK, OVER, OVER]
    stats = [s.ingress.stats() for s in (port, jax)]
    assert stats[0] == stats[1]
    assert stats[0]["connections"] == 2
    assert stats[0]["requests"] == stats[0]["responses"] == len(seq) + 5
    assert stats[0]["protocol_errors"] == 0


def test_large_response_flows_alike():
    """256 KiB answers, past the 16,384-byte frame and the 65,535-byte
    window, twice (the second rides the credit the first returned)."""
    big = bytes(range(256)) * 1024

    class BigPipeline:
        STORAGE_ERROR = object()

        def decide_many(self, blobs, chunk=None):
            return [big for _ in blobs]

    with steady():
        for module in (port_ingress, jax_ingress):
            ing = module.NativeIngress(BigPipeline(), host="127.0.0.1",
                                       port=0, poll_ms=2)
            try:
                with grpc.insecure_channel(
                        f"127.0.0.1:{ing.port}") as channel:
                    call = channel.unary_unary(ENVOY)
                    for _ in range(2):
                        assert call(blob(entries={"u": "x"}),
                                    timeout=20) == big
                assert ing.stats()["protocol_errors"] == 0
            finally:
                ing.close()


# -- concurrent: held to the oracle -----------------------------------------


def _hammer(s, blobs, threads=16):
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(lambda b: s.envoy(b, timeout=30), blobs))


def _oracle_counters(admitted):
    """An InMemoryStorage limiter fed the admitted hits: (user ->
    remaining)."""
    oracle = RateLimiter(InMemoryStorage())
    for limit in limits(TLimit):
        oracle.add_limit(limit)
    for user, n in admitted.items():
        if n:
            ctx = Context()
            ctx.list_binding("descriptors", [{"m": "GET", "u": user}])
            oracle.update_counters("api", ctx, n)
    return {dict(c.set_variables)[f"{D}.u"]: c.remaining
            for c in oracle.get_counters("api")}


@pytest.mark.parametrize("mode", ["coded", "uncoded", "off"])
def test_concurrent_calls_admit_exactly_the_limit(served, mode):
    s = served("port", mode)
    dave = blob(entries={"m": "GET", "u": "dave"})
    codes = _hammer(s, [dave] * 4000)
    assert codes.count(OK) == 3 and codes.count(OVER) == 3997
    rng = np.random.default_rng(3)
    users = [f"u{int(rng.integers(0, 50))}" for _ in range(1000)]
    codes = _hammer(s, [blob(entries={"m": "GET", "u": u}) for u in users])
    calls, admitted = {}, {"dave": 3}
    for u, code in zip(users, codes):
        calls[u] = calls.get(u, 0) + 1
        admitted[u] = admitted.get(u, 0) + (code == OK)
    for u in calls:
        assert admitted[u] == min(3, calls[u]), u
    table = {dict(c.set_variables)[f"{D}.u"]: c.remaining
             for c in s.run(s.limiter.get_counters("api"))}
    assert table == _oracle_counters(admitted)
    stats = s.ingress.stats()
    assert stats["requests"] == stats["responses"] == 5000


# -- the rest ----------------------------------------------------------------


def test_open_breaker_sends_every_row_to_the_exact_path(served):
    """While the breaker is not closed no columnar begin runs: every row
    is submitted to the exact path (decided on the failover oracle),
    and admission stays exact."""
    from limitador_tpu_torch.admission import AdmissionController

    s = served("port", "coded")
    alice = blob(entries={"m": "GET", "u": "alice"})
    assert s.envoy(alice, timeout=15) == OK  # warm, on the table
    adm = AdmissionController(mode="monitor")
    s.limiter._torch.set_admission(adm)
    adm.breaker.trip("test")
    slow, begins = [], []
    submit_slow = s.ingress._submit_slow
    begin = s.pipeline.storage.begin_check_columnar
    s.ingress._submit_slow = lambda rid, b: (slow.append(rid),
                                             submit_slow(rid, b))
    s.pipeline.storage.begin_check_columnar = lambda *a: (
        begins.append(1), begin(*a))[1]
    try:
        codes = [s.envoy(blob(entries={"m": "GET", "u": "bob"}),
                         timeout=15) for _ in range(5)]
        assert codes == [OK, OK, OK, OVER, OVER]
        assert len(slow) == 5 and not begins
        assert adm.failover.decisions == 5
    finally:
        s.run(adm.close())


def test_clean_close_under_a_pending_slow_call():
    """A handler still running on the loop when the ingress closes
    answers into a freed context: nothing is written, nothing crashes."""
    path = "/test.Slow/Call"
    started, release = threading.Event(), None

    async def slow(_blob: bytes) -> bytes:
        started.set()
        await release.wait()
        return b"late"

    class NoPipeline:
        STORAGE_ERROR = object()

        def decide_many(self, blobs, chunk=None):
            return [OK for _ in blobs]

    with steady():
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_forever)
        thread.start()
        release = asyncio.run_coroutine_threadsafe(
            _make_event(), loop).result(timeout=10)
        ing = port_ingress.NativeIngress(
            NoPipeline(), host="127.0.0.1", port=0, loop=loop, poll_ms=2,
            handlers={path: slow})
        channel = grpc.insecure_channel(f"127.0.0.1:{ing.port}")
        try:
            future = channel.unary_unary(path).future(b"x", timeout=30)
            assert started.wait(10)
            ing.close()
            assert ing.stats() == {"connections": 0, "requests": 0,
                                   "responses": 0, "protocol_errors": 0}
            loop.call_soon_threadsafe(release.set)
            with pytest.raises(grpc.RpcError):
                future.result(timeout=30)
        finally:
            channel.close()
            ing.close()
            loop.call_soon_threadsafe(loop.stop)
            thread.join(timeout=10)
            loop.close()


async def _make_event():
    return asyncio.Event()


def test_stream_answer_locks_are_per_stream():
    """A stream whose handler waits does not hold back another stream's
    answers or its close; the lock entries go as the streams close."""
    path = "/test.Chat/Say"
    gate = None

    async def chat(message: bytes) -> bytes:
        if message == b"slow":
            await gate.wait()
        return b"pong:" + message

    class NoPipeline:
        STORAGE_ERROR = object()

        def decide_many(self, blobs, chunk=None):
            return [b"" for _ in blobs]

    with steady():
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_forever)
        thread.start()
        gate = asyncio.run_coroutine_threadsafe(
            _make_event(), loop).result(timeout=10)
        ing = port_ingress.NativeIngress(
            NoPipeline(), host="127.0.0.1", port=0, loop=loop, poll_ms=2,
            handlers={path: chat}, stream_path=path)
        channel = grpc.insecure_channel(f"127.0.0.1:{ing.port}")
        stream = channel.stream_stream(path)
        out = {}
        try:
            slow = threading.Thread(target=lambda: out.update(
                slow=list(stream(iter([b"slow"]), timeout=30))))
            slow.start()
            deadline = 100
            while not ing._stream_locks and deadline:
                threading.Event().wait(0.05)
                deadline -= 1
            # the slow stream's handler holds its lock; a second stream
            # completes (answer and close) while it waits
            assert list(stream(iter([b"a", b"b"]), timeout=10)) == [
                b"pong:a", b"pong:b"]
            assert "slow" not in out
            loop.call_soon_threadsafe(gate.set)
            slow.join(timeout=30)
            assert out["slow"] == [b"pong:slow"]
            for _ in range(100):
                if not ing._stream_locks:
                    break
                threading.Event().wait(0.05)
            assert not ing._stream_locks
        finally:
            channel.close()
            ing.close()
            loop.call_soon_threadsafe(loop.stop)
            thread.join(timeout=10)
            loop.close()


def test_no_loop_answers_the_exact_path_unimplemented(served):
    """Without a loop the rows the columnar engine cannot take answer
    UNIMPLEMENTED, as in the JAX ingress; the rest decide."""
    results = []
    for module, Limit, storage in (
            (port_ingress, TLimit, "port"), (jax_ingress, JLimit, "jax")):
        s = served(storage, "coded")
        ing = module.NativeIngress(s.pipeline, host="127.0.0.1", port=0,
                                   poll_ms=2)
        try:
            with grpc.insecure_channel(f"127.0.0.1:{ing.port}") as ch:
                call = ch.unary_unary(ENVOY)
                got = [call(blob(entries={"m": "GET", "u": "solo"}),
                            timeout=15)]
                with pytest.raises(grpc.RpcError) as exc:
                    call(blob(descriptors=[{"m": "GET", "u": "x"}, {}]),
                         timeout=15)
                got.append(exc.value.code())
            results.append(got)
        finally:
            ing.close()
    assert results[0] == results[1] == [OK, grpc.StatusCode.UNIMPLEMENTED]
