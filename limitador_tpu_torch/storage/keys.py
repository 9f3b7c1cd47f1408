"""Counter key codecs.

Port counterpart of ``limitador_tpu/storage/keys.py``, copied with its
imports kept package-relative. The bytes must stay identical with the JAX
package's: replicated peers of either package merge on them.

Mirrors upstream limitador/src/storage/keys.rs:

- Text encoding ``namespace:{ns},counter:<json>`` with the ``{ns}``
  hash-tag so a Redis-cluster-style sharder routes a namespace's counters
  together (keys.rs:1-40); ``prefix_for_namespace`` gives the scan prefix.
- Binary versioned codec, BYTE-IDENTICAL to the reference's
  postcard-serialized ``key_for_counter_v2`` (keys.rs:236-249): version
  byte 2 + IdCounterKey{id, variables} for limits with an id — compact;
  version byte 1 + CounterKey{ns, seconds, conditions, variables} for the
  full identity. A Python node and a Rust limitador therefore produce the
  SAME key bytes for the same counter, so a mixed cluster's CRDT cells
  merge instead of coexisting.
- Flat (unversioned) CounterKey codec = the reference's rocksdb disk key
  (keys.rs:300-307), whose first bytes are ``prefix_for_namespace_bin``
  for namespace range scans.

``partial_counter_from_key`` reconstructs enough of a Counter to re-attach
it to a live Limit (keys.rs:79-106). Re-attachment is O(1) via
``LimitKeyIndex`` — pass one where you decode many keys (disk scans,
gossip floods); a plain iterable of limits still works for one-off calls.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple, Union

from ..core.counter import Counter
from ..core.limit import Limit
from .postcard import (
    decode_pairs,
    decode_str,
    decode_str_seq,
    decode_varint,
    encode_pairs,
    encode_str,
    encode_str_seq,
    encode_varint,
)

__all__ = [
    "key_for_counter_text",
    "prefix_for_namespace",
    "key_for_counter",
    "key_for_counter_rocksdb",
    "prefix_for_namespace_bin",
    "partial_counter_from_key",
    "partial_counter_from_rocksdb_key",
    "LimitKeyIndex",
]


# -- text codec (keys.rs:20-63) ---------------------------------------------


def key_for_counter_text(counter: Counter) -> str:
    counter_json = json.dumps(
        {
            "namespace": str(counter.namespace),
            "seconds": counter.window_seconds,
            "conditions": sorted(c.source for c in counter.limit.conditions),
            "variables": sorted(v.source for v in counter.limit.variables),
            "vars": dict(counter.set_variables),
        },
        sort_keys=True,
        separators=(",", ":"),
    )
    return f"namespace:{{{counter.namespace}}},counter:{counter_json}"


def prefix_for_namespace(namespace: str) -> str:
    return f"namespace:{{{namespace}}},"


# -- binary codec (keys.rs:188-307, postcard-compatible) ---------------------


def _counter_fields(counter: Counter):
    """CounterKey fields exactly as the reference builds them
    (keys.rs:218-234): conditions sorted, set variables sorted by name
    (counter.rs:113-120)."""
    return (
        str(counter.namespace),
        counter.window_seconds,
        sorted(c.source for c in counter.limit.conditions),
        sorted(counter.set_variables.items()),
    )


def _encode_counter_key(counter: Counter) -> bytes:
    ns, seconds, conditions, variables = _counter_fields(counter)
    return (
        encode_str(ns)
        + encode_varint(seconds)
        + encode_str_seq(conditions)
        + encode_pairs(variables)
    )


def key_for_counter(counter: Counter) -> bytes:
    """The reference's ``key_for_counter_v2`` (keys.rs:236-249):
    version-prefixed postcard; v2 (id + vars) when the limit has an id,
    else v1 (full limit identity + vars)."""
    if counter.limit.id is not None:
        return (
            b"\x02"
            + encode_str(counter.limit.id)
            + encode_pairs(sorted(counter.set_variables.items()))
        )
    return b"\x01" + _encode_counter_key(counter)


def key_for_counter_rocksdb(counter: Counter) -> bytes:
    """Flat CounterKey, no version byte — the reference's disk key
    (keys.rs:300-303); starts with ``prefix_for_namespace_bin``."""
    return _encode_counter_key(counter)


def prefix_for_namespace_bin(namespace: str) -> bytes:
    """postcard(str) == the leading bytes of every flat counter key in
    the namespace (keys.rs:305-307)."""
    return encode_str(str(namespace))


class LimitKeyIndex:
    """O(1) limit lookup for key re-attachment: by id (v2 keys) and by
    identity tuple (v1/flat keys). Build once per scan instead of probing
    every limit per key (O(keys x limits) on a scan over many
    namespaces)."""

    __slots__ = ("by_id", "by_identity")

    def __init__(self, limits: Iterable[Limit]):
        self.by_id: Dict[str, Limit] = {}
        self.by_identity: Dict[tuple, Limit] = {}
        for limit in limits:
            if limit.id is not None:
                self.by_id[limit.id] = limit
            self.by_identity[self._identity(limit)] = limit

    @staticmethod
    def _identity(limit: Limit) -> tuple:
        return (
            str(limit.namespace),
            limit.seconds,
            tuple(sorted(c.source for c in limit.conditions)),
            tuple(sorted(v.source for v in limit.variables)),
        )

    def lookup(
        self,
        namespace: str,
        seconds: int,
        conditions: List[str],
        variables: List[Tuple[str, str]],
    ) -> Optional[Limit]:
        return self.by_identity.get(
            (
                namespace,
                seconds,
                tuple(conditions),
                tuple(sorted(k for k, _v in variables)),
            )
        )


def _as_index(limits) -> LimitKeyIndex:
    return limits if isinstance(limits, LimitKeyIndex) else LimitKeyIndex(limits)


def _decode_counter_key(body: bytes, pos: int, index: LimitKeyIndex):
    ns, pos = decode_str(body, pos)
    seconds, pos = decode_varint(body, pos)
    conditions, pos = decode_str_seq(body, pos)
    variables, pos = decode_pairs(body, pos)
    limit = index.lookup(ns, seconds, sorted(conditions), variables)
    if limit is None:
        return None
    return Counter(limit, dict(variables))


def partial_counter_from_key(
    key: bytes, limits: Union[Iterable[Limit], LimitKeyIndex]
) -> Optional[Counter]:
    """Decode a versioned binary key and re-attach it to the matching
    limit; None if no limit matches (the limit was deleted). ``limits``
    may be a prebuilt ``LimitKeyIndex`` (O(1) per key) or any iterable."""
    index = _as_index(limits)
    version = key[0]
    if version == 2:
        pos = 1
        limit_id, pos = decode_str(key, pos)
        variables, pos = decode_pairs(key, pos)
        limit = index.by_id.get(limit_id)
        if limit is None:
            return None
        return Counter(limit, dict(variables))
    if version == 1:
        return _decode_counter_key(key, 1, index)
    raise ValueError(f"unknown counter key version {version}")


def partial_counter_from_rocksdb_key(
    key: bytes, limits: Union[Iterable[Limit], LimitKeyIndex]
) -> Optional[Counter]:
    """Decode a flat (unversioned) disk key (keys.rs:309-334)."""
    return _decode_counter_key(key, 0, _as_index(limits))
