"""Replication broker: full-mesh gRPC gossip of CRDT counter updates.

Port counterpart of ``limitador_tpu/storage/distributed/broker.py``, copied
with the protobuf classes taken from the port's own pool
(``server/proto/distributed_pb2.py``). Package, service and messages are
the JAX package's, so a port broker and a JAX broker gossip with each
other.

The distributed communication backend, mirroring upstream limitador's
src/storage/distributed/grpc/mod.rs over grpc.aio:

- bidirectional ``Replication.Stream(stream Packet)`` sessions: same wire
  messages / field numbers as the reference's proto, and counter KEYS use
  the postcard-compatible codec (storage/keys.py, byte-identical to
  keys.rs:236-249), so a mixed Rust/Python cluster's updates land on the
  SAME key and merge;
- handshake: both sides send Hello, answer with Pong carrying wall-clock
  ms; the receiver derives per-peer clock skew used to map remote expiry
  timestamps into the local clock (grpc/mod.rs:33-77, 625-746);
- duplicate-session tiebreak by peer-id ordering (grpc/mod.rs:678-709);
- membership gossip: MembershipUpdate advertises known peers; unknown
  peers are dialed, forming the full mesh (grpc/mod.rs:230-260);
- re-sync on connect: the full counter set streams to a newly connected
  peer, ending with ReSyncEnd (grpc/mod.rs:110-148);
- per-session send loop coalesces multiple updates to the same key —
  backpressure by coalescing, never by blocking the hot path
  (grpc/mod.rs:155-192);
- auto-reconnect every second (grpc/mod.rs:521-529).

The broker owns a daemon thread running its own asyncio loop; the sync
storage publishes via ``publish()`` (thread-safe) and receives merges on
the broker thread through ``on_update`` (the storage lock serializes).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import grpc

from ...server.proto import distributed_pb2 as pb

__all__ = ["Broker"]

log = logging.getLogger("limitador_tpu_torch.distributed")

_SERVICE = "limitador.service.distributed.v1.Replication"
_METHOD = f"/{_SERVICE}/Stream"
_RECONNECT_SECONDS = 1.0
PING_INTERVAL_SECONDS = 5.0   # periodic RTT/skew refresh (grpc/mod.rs:625-746)
PEER_PRUNE_SECONDS = 30.0     # forget gossip-learned peers silent this long
# Dial-side handshake deadline: without one, a half-dead connection (TCP
# up, stream wedged — observed under chaos when the peer's poller chokes)
# parks the redial loop FOREVER on the hello read and the partition never
# heals. Timed out attempts close the channel and retry on a fresh one.
HANDSHAKE_TIMEOUT_SECONDS = 5.0
# Session idle reaper: pings flow every PING_INTERVAL_SECONDS, so a
# session with NOTHING arriving for several intervals is a zombie
# (half-open stream whose peer vanished without FIN/RST); reap it so the
# slot reopens for a fresh dial. Mirrors the reference's session-health
# tracking (grpc/mod.rs:625-746).
SESSION_IDLE_TIMEOUT_SECONDS = 30.0

OnUpdate = Callable[[bytes, Dict[str, int], int], None]
SnapshotProvider = Callable[[], Iterable[Tuple[bytes, Dict[str, int], int]]]


def _now_ms() -> int:
    return int(time.time() * 1000)


class _Session:
    """One live replication session with a peer (either direction)."""

    def __init__(self, peer_id: str, initiated: bool):
        self.peer_id = peer_id
        self.initiated = initiated
        self.clock_skew_ms = 0
        self.latency_ms = 0
        self.ping_sent_ms: Optional[int] = None
        self.pongs_received = 0
        self._pending: Dict[bytes, Tuple[Dict[str, int], int]] = {}
        self._wakeup = asyncio.Event()
        self.closed = asyncio.Event()

    def enqueue(self, key: bytes, values: Dict[str, int], expires_at: int) -> None:
        # Coalesce by key: only the latest snapshot per counter is sent.
        self._pending[key] = (values, expires_at)
        self._wakeup.set()

    async def drain(self) -> List[pb.Packet]:
        await self._wakeup.wait()
        self._wakeup.clear()
        pending, self._pending = self._pending, {}
        return [
            pb.Packet(
                counter_update=pb.CounterUpdate(
                    key=key, values=values, expires_at=expires_at
                )
            )
            for key, (values, expires_at) in pending.items()
        ]


class Broker:
    def __init__(
        self,
        peer_id: str,
        listen_address: str,
        peer_urls: Iterable[str],
        on_update: OnUpdate,
        snapshot_provider: SnapshotProvider,
        advertise_address: Optional[str] = None,
    ):
        self.peer_id = peer_id
        self.listen_address = listen_address
        # What Hello packets advertise as this node's dialable URL.
        # Defaults to the bind address, but a node bound to 0.0.0.0
        # must advertise something peers can actually dial (the pod's
        # stable DNS name in kubernetes) — otherwise every peer learns
        # a self-connecting 0.0.0.0 URL from gossip and the mesh only
        # heals through the static --peer redial loop.
        self.advertise_address = advertise_address or listen_address
        self.peer_urls: List[str] = list(peer_urls)
        self.on_update = on_update
        self.snapshot_provider = snapshot_provider
        self.sessions: Dict[str, _Session] = {}
        self.known_peers: Dict[str, List[str]] = {}  # peer_id -> urls
        # Peers learned via membership gossip (pruned when silent, unlike
        # the configured peer_urls which are dialed forever) and the last
        # time any packet arrived from each peer.
        self._gossip_peers: set = set()
        self.peer_last_seen: Dict[str, float] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[grpc.aio.Server] = None
        self._dialers: Dict[str, asyncio.Task] = {}
        self._stopping = threading.Event()
        self._started = threading.Event()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._thread_main, name=f"broker-{self.peer_id}", daemon=True
        )
        self._thread.start()
        self._started.wait(timeout=10)

    def _thread_main(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self._amain())

    async def _amain(self) -> None:
        self._server = grpc.aio.server()
        handler = grpc.method_handlers_generic_handler(
            _SERVICE,
            {
                "Stream": grpc.stream_stream_rpc_method_handler(
                    self._serve_stream,
                    request_deserializer=pb.Packet.FromString,
                    response_serializer=lambda m: m.SerializeToString(),
                )
            },
        )
        self._server.add_generic_rpc_handlers((handler,))
        self._server.add_insecure_port(self.listen_address)
        await self._server.start()
        for url in self.peer_urls:
            self._spawn_dialer(url)
        self._started.set()
        while not self._stopping.is_set():
            await asyncio.sleep(0.5)
            self._prune_dead_peers()
        for d in self._dialers.values():
            d.cancel()
        await asyncio.gather(*self._dialers.values(), return_exceptions=True)
        await self._server.stop(grace=0.2)

    def _spawn_dialer(self, url: str) -> None:
        """One tracked dial loop per url (gossip-learned ones included, so
        shutdown cancels them and a peer's multiple urls don't race).
        Never dial ourselves — under either the bind or advertised name."""
        if (
            url not in self._dialers
            and url != self.listen_address
            and url != self.advertise_address
        ):
            self._dialers[url] = asyncio.ensure_future(self._dial_loop(url))

    def stop(self) -> None:
        self._stopping.set()
        if self._thread:
            self._thread.join(timeout=5)

    # -- publishing (called from the storage thread) --------------------------

    def publish(self, key: bytes, values: Dict[str, int], expires_at: int) -> None:
        if self._loop is None:
            return
        def _enqueue():
            for session in list(self.sessions.values()):
                session.enqueue(key, values, expires_at)
        try:
            self._loop.call_soon_threadsafe(_enqueue)
        except RuntimeError:
            pass  # loop shut down

    # -- session protocol ------------------------------------------------------

    def _membership_packet(self) -> pb.Packet:
        peers = []
        for pid, urls in self.known_peers.items():
            session = self.sessions.get(pid)
            latency = session.latency_ms if session is not None else 0
            peers.append(pb.Peer(peer_id=pid, urls=urls, latency=latency))
        return pb.Packet(membership_update=pb.MembershipUpdate(peers=peers))

    def _prune_dead_peers(self) -> None:
        """Forget gossip-learned peers with no live session that have been
        silent past the prune window (the reference tracks session health
        per peer; configured peers keep their 1s redial loop forever)."""
        now = time.monotonic()
        for pid in list(self._gossip_peers):
            session = self.sessions.get(pid)
            if session is not None and not session.closed.is_set():
                continue
            if now - self.peer_last_seen.get(pid, now) < PEER_PRUNE_SECONDS:
                continue
            urls = self.known_peers.pop(pid, []) or []
            self._gossip_peers.discard(pid)
            self.peer_last_seen.pop(pid, None)
            for url in urls:
                if url in self.peer_urls:
                    # Configured urls keep their forever-redial loop even
                    # when a gossip-learned peer_id advertised the same url.
                    continue
                dialer = self._dialers.pop(url, None)
                if dialer is not None:
                    dialer.cancel()
            log.debug("pruned dead peer %s", pid)

    @staticmethod
    def _apply_pong(session: _Session, remote_time_ms: int, now_ms: int) -> None:
        """RTT + skew from one ping/pong round (ClockSkew, grpc/mod.rs:33-63):
        latency is half the round trip; skew compares the remote clock to
        the estimated local clock at the instant the peer stamped it."""
        session.pongs_received += 1
        if session.ping_sent_ms is not None:
            rtt = max(now_ms - session.ping_sent_ms, 0)
            session.latency_ms = rtt // 2
            session.ping_sent_ms = None
            session.clock_skew_ms = remote_time_ms - (now_ms - rtt // 2)
        else:
            # Handshake pong: no in-flight ping, skew only.
            session.clock_skew_ms = remote_time_ms - now_ms

    def _register(self, session: _Session) -> bool:
        """Duplicate-session tiebreak (grpc/mod.rs:678-709): when two
        sessions to the same peer race, keep the one initiated by the
        lexicographically smaller peer id."""
        existing = self.sessions.get(session.peer_id)
        if existing is not None and not existing.closed.is_set():
            keep_initiated_by_us = self.peer_id < session.peer_id
            if session.initiated != keep_initiated_by_us:
                return False
            existing.closed.set()
        self.sessions[session.peer_id] = session
        return True

    async def _run_session(self, session: _Session, send, recv) -> None:
        """Symmetric post-Hello protocol: pong, membership, re-sync, updates."""
        await send(pb.Packet(pong=pb.Pong(current_time=_now_ms())))
        await send(self._membership_packet())
        for key, values, expires_at in self.snapshot_provider():
            await send(
                pb.Packet(
                    counter_update=pb.CounterUpdate(
                        key=key, values=values, expires_at=expires_at
                    )
                )
            )
        await send(pb.Packet(re_sync_end=pb.Empty()))

        async def sender():
            while not session.closed.is_set():
                for packet in await session.drain():
                    await send(packet)

        async def pinger():
            # Periodic RTT/skew refresh so long sessions don't drift
            # (grpc/mod.rs:625-746 re-pings on an interval).
            while not session.closed.is_set():
                await asyncio.sleep(PING_INTERVAL_SECONDS)
                if session.ping_sent_ms is None:
                    session.ping_sent_ms = _now_ms()
                    await send(pb.Packet(ping=pb.Empty()))

        send_task = asyncio.ensure_future(sender())
        ping_task = asyncio.ensure_future(pinger())
        try:
            while True:
                try:
                    packet = await asyncio.wait_for(
                        recv(), SESSION_IDLE_TIMEOUT_SECONDS
                    )
                except asyncio.TimeoutError:
                    # Nothing (not even a ping) for several ping
                    # intervals: zombie half-open stream — reap it.
                    log.debug(
                        "session %s idle past %.0fs, reaping",
                        session.peer_id, SESSION_IDLE_TIMEOUT_SECONDS,
                    )
                    break
                if packet is None:
                    break
                self.peer_last_seen[session.peer_id] = time.monotonic()
                kind = packet.WhichOneof("message")
                if kind == "counter_update":
                    cu = packet.counter_update
                    # Map the remote expiry into the local clock.
                    expires_at = cu.expires_at - session.clock_skew_ms
                    self.on_update(cu.key, dict(cu.values), expires_at)
                elif kind == "ping":
                    await send(pb.Packet(pong=pb.Pong(current_time=_now_ms())))
                elif kind == "pong":
                    self._apply_pong(
                        session, packet.pong.current_time, _now_ms()
                    )
                elif kind == "membership_update":
                    for peer in packet.membership_update.peers:
                        if (
                            peer.peer_id != self.peer_id
                            and peer.peer_id not in self.known_peers
                        ):
                            self.known_peers[peer.peer_id] = list(peer.urls)
                            self._gossip_peers.add(peer.peer_id)
                            self.peer_last_seen[peer.peer_id] = (
                                time.monotonic()
                            )
                            for url in peer.urls:
                                self._spawn_dialer(url)
                # re_sync_end / hello: nothing to do post-handshake
        finally:
            session.closed.set()
            send_task.cancel()
            ping_task.cancel()
            if self.sessions.get(session.peer_id) is session:
                del self.sessions[session.peer_id]

    # -- server side -----------------------------------------------------------

    async def _serve_stream(self, request_iterator, context):
        out: asyncio.Queue = asyncio.Queue()

        async def send(packet):
            await out.put(packet)

        it = request_iterator.__aiter__()

        async def recv():
            try:
                return await it.__anext__()
            except StopAsyncIteration:
                return None

        async def protocol():
            hello_pkt = await recv()
            if hello_pkt is None or hello_pkt.WhichOneof("message") != "hello":
                await out.put(None)
                return
            peer_id = hello_pkt.hello.sender_peer_id
            self.known_peers.setdefault(
                peer_id, list(hello_pkt.hello.sender_urls)
            )
            self.peer_last_seen[peer_id] = time.monotonic()
            session = _Session(peer_id, initiated=False)
            if not self._register(session):
                await out.put(None)
                return
            await send(pb.Packet(hello=pb.Hello(sender_peer_id=self.peer_id)))
            try:
                await self._run_session(session, send, recv)
            finally:
                await out.put(None)

        task = asyncio.ensure_future(protocol())
        try:
            while True:
                packet = await out.get()
                if packet is None:
                    break
                yield packet
        finally:
            task.cancel()

    # -- client side -------------------------------------------------------------

    async def _dial_loop(self, url: str) -> None:
        while not self._stopping.is_set():
            try:
                await self._dial_once(url)
            except asyncio.CancelledError:
                return
            except Exception as exc:  # keep redialing on ANY failure
                # An abruptly severed stream can surface exception types
                # beyond RpcError/OSError (cython-layer errors, protocol
                # violations mid-_run_session); a narrower catch let one
                # such error kill this loop silently and the peer never
                # reconnected (found by the JAX package's chaos tests). The
                # reference redials unconditionally every second
                # (grpc/mod.rs:521-529).
                log.debug("dial %s failed: %s", url, exc)
            await asyncio.sleep(_RECONNECT_SECONDS)

    async def _dial_once(self, url: str) -> None:
        async with grpc.aio.insecure_channel(url) as channel:
            stream = channel.stream_stream(
                _METHOD,
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=pb.Packet.FromString,
            )
            call = stream()
            await asyncio.wait_for(
                call.write(
                    pb.Packet(
                        hello=pb.Hello(
                            sender_peer_id=self.peer_id,
                            sender_urls=[self.advertise_address],
                            receiver_url=url,
                        )
                    )
                ),
                HANDSHAKE_TIMEOUT_SECONDS,
            )
            hello_pkt = await asyncio.wait_for(
                call.read(), HANDSHAKE_TIMEOUT_SECONDS
            )
            if (
                hello_pkt is grpc.aio.EOF
                or hello_pkt.WhichOneof("message") != "hello"
            ):
                return
            peer_id = hello_pkt.hello.sender_peer_id
            if peer_id == self.peer_id:
                return  # configured to dial ourselves
            self.peer_last_seen[peer_id] = time.monotonic()
            session = _Session(peer_id, initiated=True)
            if not self._register(session):
                # A healthy session to this peer already exists (tiebreak
                # kept it); park until it drops instead of redialing every
                # second (reference grpc/mod.rs:506-517).
                existing = self.sessions.get(peer_id)
                if existing is not None:
                    await existing.closed.wait()
                return

            # _run_session has THREE writers (sender drain, pinger, pong
            # replies from the recv loop); grpc.aio's call.write is not
            # concurrency-safe — overlapping writes fail the whole RPC
            # with GRPC_CALL_ERROR_TOO_MANY_OPERATIONS (found by
            # the JAX package's chaos tests: under load every redial died on it,
            # leaving the partition permanent). The server side already
            # serializes through its out-queue; serialize here too.
            write_lock = asyncio.Lock()

            async def send(packet):
                async with write_lock:
                    await call.write(packet)

            async def recv():
                packet = await call.read()
                return None if packet is grpc.aio.EOF else packet

            await self._run_session(session, send, recv)
