"""Minimal postcard wire-format primitives.

Port counterpart of ``limitador_tpu/storage/postcard.py``, copied verbatim.

Upstream limitador serializes binary counter keys with the `postcard`
crate (limitador/src/storage/keys.rs:188-304). To make mixed
Rust/Python clusters actually merge counters (same key bytes -> same CRDT
cell), this module implements the exact subset of postcard's data model
those keys use:

- ``u8``: one raw byte;
- ``u64``/lengths: LEB128 varint (7-bit little-endian groups, high bit =
  continuation);
- ``str``: varint byte-length prefix + UTF-8 bytes;
- ``Vec<T>``: varint element count + elements;
- tuples/structs: fields back-to-back, no framing.

Postcard spec: https://postcard.jamesmunns.com/wire-format (public).
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = [
    "encode_varint",
    "decode_varint",
    "encode_str",
    "decode_str",
    "encode_str_seq",
    "decode_str_seq",
    "encode_pairs",
    "decode_pairs",
]


def encode_varint(n: int) -> bytes:
    if n < 0:
        raise ValueError("postcard varints are unsigned")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    value = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def encode_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return encode_varint(len(raw)) + raw


def decode_str(buf: bytes, pos: int) -> Tuple[str, int]:
    n, pos = decode_varint(buf, pos)
    if pos + n > len(buf):
        raise ValueError("truncated string")
    return buf[pos:pos + n].decode("utf-8"), pos + n


def encode_str_seq(items: List[str]) -> bytes:
    out = bytearray(encode_varint(len(items)))
    for s in items:
        out += encode_str(s)
    return bytes(out)


def decode_str_seq(buf: bytes, pos: int) -> Tuple[List[str], int]:
    n, pos = decode_varint(buf, pos)
    items = []
    for _ in range(n):
        s, pos = decode_str(buf, pos)
        items.append(s)
    return items, pos


def encode_pairs(pairs: List[Tuple[str, str]]) -> bytes:
    out = bytearray(encode_varint(len(pairs)))
    for k, v in pairs:
        out += encode_str(k)
        out += encode_str(v)
    return bytes(out)


def decode_pairs(buf: bytes, pos: int) -> Tuple[List[Tuple[str, str]], int]:
    n, pos = decode_varint(buf, pos)
    pairs = []
    for _ in range(n):
        k, pos = decode_str(buf, pos)
        v, pos = decode_str(buf, pos)
        pairs.append((k, v))
    return pairs, pos
