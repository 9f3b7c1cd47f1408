"""The port's HTTP/2 ingress (``csrc/h2ingress.cc``) against the JAX
package's (``native/h2ingress.cc``), below gRPC.

- HPACK: the port's ``HpackDecoder`` and the JAX one decode the RFC 7541
  Appendix C.2 and C.4 vectors, the python-hyper sequence of
  ``tests/data/hpack_vectors.json``, 200 header blocks of a seeded
  reference encoder written here (RFC 7541 section 6: every
  representation, Huffman on and off, table-size updates, eviction) and
  malformed blocks alike: the same fields, the same dynamic table size,
  the same refusals.
- Raw sockets: the same bytes sent to each ingress (a bad preface,
  SETTINGS and PING, an oversized frame, malformed HPACK, an unknown
  frame type, a header block split over CONTINUATION, interrupted or on
  the wrong stream, padded HEADERS and DATA, abrupt disconnects) bring
  back the same frames, or the same close and GOAWAY code.

Both ingresses answer from a fake pipeline; every socket has a timeout
and every ingress is closed in teardown.
"""

import json
import re
import socket
from pathlib import Path

import grpc
import numpy as np
import pytest

from limitador_tpu.native import ingress as jax_ingress
from limitador_tpu_torch.native import ingress as port_ingress
from limitador_tpu_torch.server.proto import rls_pb2

from .torch_reference import jax_reference_ingress  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
VECTORS = json.loads(
    (Path(__file__).parent / "data" / "hpack_vectors.json").read_text()
)
ENVOY_PATH = b"/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
OK_BLOB = rls_pb2.RateLimitResponse(
    overall_code=rls_pb2.RateLimitResponse.OK
).SerializeToString()


def decoders():
    return port_ingress.HpackDecoder(), jax_ingress.HpackDecoder()


def decode_both(pair, block):
    """Each decoder's fields (or the exception type it raised) and its
    dynamic table size afterwards."""
    out = []
    for d in pair:
        try:
            got = d.decode(block)
        except ValueError:
            got = ValueError
        out.append((got, d.dynamic_table_size))
    return out


# -- HPACK -------------------------------------------------------------------


def test_rfc7541_c2_literal_forms_decode_alike():
    pair = decoders()
    for hexblock, want in (
        ("400a637573746f6d2d6b65790d637573746f6d2d686561646572",
         [(b"custom-key", b"custom-header")]),
        ("040c2f73616d706c652f70617468", [(b":path", b"/sample/path")]),
        ("100870617373776f726406736563726574", [(b"password", b"secret")]),
        ("82", [(b":method", b"GET")]),
    ):
        port, jax = decode_both(pair, bytes.fromhex(hexblock))
        assert port == jax == (want, 55)


def test_rfc7541_c4_huffman_sequence_decodes_alike():
    pair = decoders()
    blocks = ("828684418cf1e3c2e5f23a6ba0ab90f4ff",
              "828684be5886a8eb10649cbf",
              "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf")
    wants = (
        [(b":method", b"GET"), (b":scheme", b"http"), (b":path", b"/"),
         (b":authority", b"www.example.com")],
        [(b":method", b"GET"), (b":scheme", b"http"), (b":path", b"/"),
         (b":authority", b"www.example.com"),
         (b"cache-control", b"no-cache")],
        [(b":method", b"GET"), (b":scheme", b"https"),
         (b":path", b"/index.html"), (b":authority", b"www.example.com"),
         (b"custom-key", b"custom-value")],
    )
    for block, want in zip(blocks, wants):
        port, jax = decode_both(pair, bytes.fromhex(block))
        assert port == jax
        assert port[0] == want


def test_python_hyper_sequence_decodes_alike():
    pair = decoders()
    for i, case in enumerate(VECTORS["sequence"]):
        port, jax = decode_both(pair, bytes.fromhex(case["block"]))
        want = [(n.encode("latin1"), v.encode("latin1"))
                for n, v in case["headers"]]
        assert port == jax, f"block {i}"
        assert port[0] == want, f"block {i}"


def _rfc_tables():
    """The static table and the Huffman code of RFC 7541 (Appendices A
    and B), read from the JAX package's header."""
    text = (REPO / "native" / "h2_hpack_tables.h").read_text()

    def ints(name):
        body = re.search(name + r"\[257\] = \{(.*?)\};", text, re.S).group(1)
        return [int(x, 0) for x in re.findall(r"0x[0-9a-f]+|\d+", body)]

    static = re.findall(
        r'\{"([^"]*)", "([^"]*)"\}',
        re.search(r"kStaticTable\[61\] = \{(.*?)\};", text, re.S).group(1))
    return ([(n.encode(), v.encode()) for n, v in static],
            ints("kHuffCodes"), ints("kHuffLens"))


STATIC, HUFF_CODES, HUFF_LENS = _rfc_tables()


class RefEncoder:
    """A straightforward RFC 7541 encoder with its own dynamic table: an
    integer with an N-bit prefix (5.1), a string literal raw or Huffman
    coded (5.2), and every field representation of section 6."""

    def __init__(self, rng, max_size=4096):
        self.rng = rng
        self.max_size = max_size
        self.size = max_size
        self.table = []  # newest first

    @staticmethod
    def integer(value, prefix, first=0):
        limit = (1 << prefix) - 1
        if value < limit:
            return bytes([first | value])
        out = [first | limit]
        value -= limit
        while value >= 128:
            out.append((value & 0x7F) | 0x80)
            value >>= 7
        out.append(value)
        return bytes(out)

    def string(self, s):
        if self.rng.random() < 0.5:
            return self.integer(len(s), 7) + s
        bits, nbits = 0, 0
        for byte in s:
            bits = (bits << HUFF_LENS[byte]) | HUFF_CODES[byte]
            nbits += HUFF_LENS[byte]
        pad = -nbits % 8
        bits = (bits << pad) | ((1 << pad) - 1)
        coded = bits.to_bytes((nbits + pad) // 8, "big") if nbits else b""
        return self.integer(len(coded), 7, 0x80) + coded

    def _evict(self):
        while self.table and sum(
                len(n) + len(v) + 32 for n, v in self.table) > self.size:
            self.table.pop()

    def _add(self, name, value):
        self.table.insert(0, (name, value))
        self._evict()

    def _entries(self):
        return STATIC + self.table

    def block(self, headers):
        out = b""
        if self.rng.random() < 0.15:
            self.size = int(self.rng.integers(0, self.max_size + 1))
            self._evict()
            out += self.integer(self.size, 5, 0x20)
        for name, value in headers:
            entries = self._entries()
            exact = [i for i, e in enumerate(entries) if e == (name, value)]
            named = [i for i, e in enumerate(entries) if e[0] == name]
            form = self.rng.integers(0, 4)
            if exact and form == 0:
                out += self.integer(exact[0] + 1, 7, 0x80)
                continue
            prefix, first = ((6, 0x40), (4, 0x00), (4, 0x10))[
                int(self.rng.integers(0, 3))]
            if named and self.rng.random() < 0.5:
                out += self.integer(named[-1] + 1, prefix, first)
            else:
                out += self.integer(0, prefix, first) + self.string(name)
            out += self.string(value)
            if first == 0x40:
                self._add(name, value)
        return out


def _random_headers(rng):
    names = [n for n, _ in STATIC[:20]] + [
        b"x-request-id", b"grpc-timeout", b"te", b"custom-key"]
    out = []
    for _ in range(int(rng.integers(1, 9))):
        if rng.random() < 0.3:
            out.append(STATIC[int(rng.integers(0, len(STATIC)))])
            continue
        name = names[int(rng.integers(0, len(names)))]
        n = int(rng.choice([0, 3, 12, 40, 200]))
        value = bytes(rng.integers(32, 127, n).astype(np.uint8))
        if rng.random() < 0.1:  # any octet, NUL and high bytes included
            value = bytes(rng.integers(0, 256, n).astype(np.uint8))
        out.append((name, value))
    return out


def test_seeded_reference_encoder_blocks_decode_alike():
    """200 blocks over one connection-long dynamic table: both decoders
    give the encoder's fields and its table size after every block."""
    rng = np.random.default_rng(7541)
    encoder = RefEncoder(rng)
    pair = decoders()
    for i in range(200):
        headers = _random_headers(rng)
        block = encoder.block(headers)
        port, jax = decode_both(pair, block)
        assert port == jax, f"block {i}"
        assert port[0] == headers, f"block {i}"
        assert port[1] == sum(len(n) + len(v) + 32
                              for n, v in encoder.table), f"block {i}"


@pytest.mark.parametrize("bad", [
    "80",            # indexed field with index 0
    "ffffffffff7f",  # runaway integer
    "418cf1e3",      # truncated Huffman string
    "4184ffffffff",  # Huffman padding longer than 7 bits (EOS)
    "be",            # a dynamic reference into an empty table
    "40",            # a literal with nothing after it
    "3fe221",        # a table-size update past the 4096 limit
])
def test_malformed_blocks_are_refused_alike(bad):
    port, jax = decode_both(decoders(), bytes.fromhex(bad))
    assert port == jax
    assert port[0] is ValueError


def test_table_size_updates_evict_alike():
    pair = decoders()
    for hexblock in (
            "400a637573746f6d2d6b65790d637573746f6d2d686561646572",
            "3f1a",  # size 57: the entry (55) stays
            "20",    # size 0: evicted
            "be",    # the evicted entry no longer resolves
            "3fe11f" "400161016162",  # size 4096 again, then an entry
            # an update after a field: both decoders take it (RFC 7541
            # 4.2 wants it first in the block)
            "82" "3f1a"):
        port, jax = decode_both(pair, bytes.fromhex(hexblock))
        assert port == jax, hexblock


def test_closed_decoder_refuses_alike():
    for d in decoders():
        d.close()
        with pytest.raises(ValueError):
            d.decode(b"\x82")
        with pytest.raises(ValueError):
            _ = d.dynamic_table_size


# -- raw sockets -----------------------------------------------------------


class OkPipeline:
    """Answers every ShouldRateLimit with OK (the ingress's serial
    pump)."""

    STORAGE_ERROR = object()

    def decide_many(self, blobs, chunk=None):
        return [OK_BLOB for _ in blobs]


@pytest.fixture
def pair():
    """(port ingress, JAX ingress), each over the fake pipeline."""
    made = []
    try:
        for module in (port_ingress, jax_ingress):
            made.append(module.NativeIngress(
                OkPipeline(), host="127.0.0.1", port=0, poll_ms=2))
        yield tuple(made)
    finally:
        for ing in made:
            ing.close()


def frame(ftype, flags, stream, payload=b""):
    return (len(payload).to_bytes(3, "big") + bytes([ftype, flags])
            + stream.to_bytes(4, "big") + payload)


def read_frame(sock):
    """(type, flags, stream, payload), or None once the peer closed."""
    def read(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    head = read(9)
    if head is None:
        return None
    body = read(int.from_bytes(head[:3], "big"))
    if body is None:
        return None
    return (head[3], head[4], int.from_bytes(head[5:9], "big") & 0x7FFFFFFF,
            body)


def transcript(port, sends, until):
    """Send each chunk of ``sends`` on a fresh connection, then read
    frames until ``until(frame)`` is true or the peer closes; returns the
    frames read (None last when the peer closed)."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=5)
    sock.settimeout(5)
    try:
        for chunk in sends:
            sock.sendall(chunk)
        frames = []
        for _ in range(32):
            got = read_frame(sock)
            frames.append(got)
            if got is None or until(got):
                break
        return frames
    finally:
        sock.close()


def alike(pair, sends, until):
    """The same transcript from both ingresses; returns it."""
    port, jax = (transcript(ing.port, sends, until) for ing in pair)
    assert port == jax
    return port


def _goaway(f):
    return f[0] == 7


def _header_block():
    """Valid gRPC request headers in static-table forms: :method POST,
    :scheme http, :path literal, content-type literal."""
    ct = b"application/grpc"
    return (bytes([0x83, 0x86, 0x04, len(ENVOY_PATH)]) + ENVOY_PATH
            + bytes([0x0F, 0x10, len(ct)]) + ct)


HANDSHAKE = PREFACE + frame(4, 0, 0)
EMPTY_REQUEST = b"\x00\x00\x00\x00\x00"


def _data_on_1(f):
    return f[0] == 0 and f[2] == 1 or f[0] == 7


def test_bad_preface_closes_alike(pair):
    frames = alike(pair, [b"GET / HTTP/1.1\r\nHost: x\r\n\r\n"],
                   lambda f: False)
    assert frames == [None]


def test_settings_and_ping_ack_alike(pair):
    frames = alike(pair, [HANDSHAKE + frame(6, 0, 0, b"12345678")],
                   lambda f: f[0] == 6)
    assert [(f[0], f[1]) for f in frames] == [(4, 0), (4, 1), (6, 1)]
    assert frames[-1][3] == b"12345678"


def test_oversized_frame_goaway_alike(pair):
    frames = alike(pair, [HANDSHAKE, (1 << 20).to_bytes(3, "big")
                          + bytes([0, 0]) + (1).to_bytes(4, "big")],
                   _goaway)
    assert frames[-1][0] == 7
    assert all(ing.stats()["protocol_errors"] == 1 for ing in pair)


def test_malformed_hpack_goaway_alike(pair):
    frames = alike(pair, [HANDSHAKE + frame(1, 0x5, 1, b"\xbe")], _goaway)
    assert int.from_bytes(frames[-1][3][4:8], "big") == 9  # COMPRESSION


def test_unknown_frame_type_ignored_alike(pair):
    frames = alike(pair, [HANDSHAKE + frame(0xFA, 0, 0, b"junk")
                          + frame(6, 0, 0, b"abcdefgh")],
                   lambda f: f[0] == 6)
    assert frames[-1][:2] == (6, 1)


def test_continuation_split_serves_alike(pair):
    block = _header_block()
    a, b = len(block) // 3, 2 * len(block) // 3
    frames = alike(pair, [HANDSHAKE + frame(1, 0, 1, block[:a])
                          + frame(9, 0, 1, block[a:b])
                          + frame(9, 0x4, 1, block[b:])
                          + frame(0, 0x1, 1, EMPTY_REQUEST)], _data_on_1)
    assert frames[-1][0] == 0
    assert frames[-1][3][5:] == OK_BLOB


@pytest.mark.parametrize("interrupt", ["ping", "wrong-stream"])
def test_interrupted_continuation_is_a_protocol_error_alike(pair, interrupt):
    block = _header_block()
    half = len(block) // 2
    second = (frame(6, 0, 0, b"12345678") if interrupt == "ping"
              else frame(9, 0x4, 3, block[half:]))
    frames = alike(pair, [HANDSHAKE + frame(1, 0, 1, block[:half])
                          + second], _goaway)
    assert int.from_bytes(frames[-1][3][4:8], "big") == 1  # PROTOCOL


def test_padded_headers_and_data_serve_alike(pair):
    block = _header_block()
    headers = bytes([7]) + b"\x00\x00\x00\x03\x10" + block + b"\x00" * 7
    data = bytes([3]) + EMPTY_REQUEST + b"\x00" * 3
    frames = alike(pair, [HANDSHAKE + frame(1, 0x4 | 0x8 | 0x20, 1, headers)
                          + frame(0, 0x1 | 0x8, 1, data)], _data_on_1)
    assert frames[-1][3][5:] == OK_BLOB


def test_abrupt_disconnects_leave_both_serving(pair):
    for ing in pair:
        for _ in range(5):
            sock = socket.create_connection(("127.0.0.1", ing.port),
                                            timeout=5)
            sock.sendall(HANDSHAKE)
            sock.close()
        with grpc.insecure_channel(f"127.0.0.1:{ing.port}") as channel:
            call = channel.unary_unary(ENVOY_PATH.decode())
            assert call(rls_pb2.RateLimitRequest(
                domain="x").SerializeToString(), timeout=10) == OK_BLOB
    assert [ing.stats()["connections"] for ing in pair] == [6, 6]
