"""The port's counter-key codecs against the JAX package's.

Replicated peers merge counters on the bytes of their wire keys, so the
port's ``storage/keys.py`` and ``storage/postcard.py`` must produce and
read exactly the JAX package's bytes. One parametrised test runs over the
cases of ``tests/test_keys_postcard.py`` (the reference's own vectors,
ids, multi-variable and UTF-8 keys, randomized limits, varints), building
each counter once per package: the binary (v1/v2), flat (RocksDB) and
text keys and the namespace prefixes must be equal, and each package must
decode the other's keys back onto its own limit.
"""

import random

import pytest

import limitador_tpu as J
import limitador_tpu_torch as T
from limitador_tpu.core.counter import Counter as JCounter
from limitador_tpu.storage import keys as JKeys
from limitador_tpu.storage import postcard as jpc
from limitador_tpu_torch.core.counter import Counter as TCounter
from limitador_tpu_torch.storage import keys as TKeys
from limitador_tpu_torch.storage import postcard as tpc


def _random_cases(n=40, seed=7):
    rng = random.Random(seed)
    alphabet = "abcXYZ018_:-/ é¢"
    cases = []
    for i in range(n):
        names = [f"v{j}" for j in range(rng.randint(0, 4))]
        spec = dict(
            namespace="".join(rng.choices(alphabet, k=rng.randint(1, 20))),
            max_value=rng.randint(1, 1 << 40),
            seconds=rng.randint(1, 10**6),
            conditions=[f"c{j} == '{j}'" for j in range(rng.randint(0, 3))],
            variables=names,
            id=f"id{i}" if rng.random() < 0.5 else None,
        )
        values = {n: "".join(rng.choices(alphabet, k=rng.randint(0, 200)))
                  for n in names}
        cases.append((f"random-{i}", "counter", (spec, values)))
    return cases


def _ref(with_id=False):
    return dict(namespace="ns_counter:", max_value=1, seconds=1,
                conditions=["req_method == 'GET'"], variables=["app_id"],
                id="id200" if with_id else None)


CASES = [
    ("reference-flat-v1", "counter", (_ref(), {"app_id": "foo"})),
    ("reference-v2-id", "counter", (_ref(True), {"app_id": "foo"})),
    ("two-variables", "counter", (dict(
        namespace="ns", max_value=10, seconds=60, conditions=["a == '1'"],
        variables=["u", "z"]), {"u": "alice", "z": "9"})),
    ("id-one-variable", "counter", (dict(
        namespace="ns", max_value=10, seconds=60, conditions=[],
        variables=["u"], id="lim-1"), {"u": "bob"})),
    ("utf8-and-long-value", "counter", (dict(
        namespace="nämespace", max_value=10, seconds=60, conditions=[],
        variables=["u"]), {"u": "x" * 300})),
    ("simple-limit", "counter", (dict(
        namespace="ns", max_value=10, seconds=60, conditions=[],
        variables=[]), {})),
    ("token-bucket", "counter", (dict(
        namespace="tb", max_value=5, seconds=60, conditions=[],
        variables=["u"], policy="token_bucket"), {"u": "x"})),
] + _random_cases() + [
    (f"varint-{n}", "varint", n)
    for n in (0, 1, 127, 128, 300, 16384, (1 << 64) - 1)
] + [("unknown-version", "bad-key", b"\x09junk"),
     ("truncated-varint", "bad-key", b"\x01\x80")]


@pytest.mark.parametrize("kind,payload", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_keys_match_the_jax_package(kind, payload):
    if kind == "varint":
        raw = jpc.encode_varint(payload)
        assert tpc.encode_varint(payload) == raw
        assert tpc.decode_varint(raw, 0) == jpc.decode_varint(raw, 0)
        return
    if kind == "bad-key":
        with pytest.raises(ValueError) as jexc:
            JKeys.partial_counter_from_key(payload, [])
        with pytest.raises(ValueError) as texc:
            TKeys.partial_counter_from_key(payload, [])
        assert str(texc.value) == str(jexc.value)
        return
    spec, values = payload
    jlimit, tlimit = J.Limit(**spec), T.Limit(**spec)
    jc, tc = JCounter(jlimit, values), TCounter(tlimit, values)
    key = JKeys.key_for_counter(jc)
    assert TKeys.key_for_counter(tc) == key
    assert TKeys.key_for_counter_rocksdb(tc) == \
        JKeys.key_for_counter_rocksdb(jc)
    assert TKeys.key_for_counter_text(tc) == JKeys.key_for_counter_text(jc)
    ns = spec["namespace"]
    assert TKeys.prefix_for_namespace_bin(ns) == \
        JKeys.prefix_for_namespace_bin(ns)
    assert TKeys.prefix_for_namespace(ns) == JKeys.prefix_for_namespace(ns)
    # each package reads the other's bytes back onto its own limit
    for decode, limit, want in (
        (TKeys.partial_counter_from_key, tlimit, tc),
        (JKeys.partial_counter_from_key, jlimit, jc),
    ):
        back = decode(key, [limit])
        assert back == want and back.set_variables == values
    index = TKeys.LimitKeyIndex([tlimit])
    assert TKeys.partial_counter_from_key(key, index) == tc
    flat = JKeys.key_for_counter_rocksdb(jc)
    assert TKeys.partial_counter_from_rocksdb_key(flat, [tlimit]) == tc
    other = T.Limit(**{**spec, "namespace": ns + "-other",
                       "id": None if spec.get("id") is None
                       else spec["id"] + "-other"})
    assert TKeys.partial_counter_from_key(key, [other]) is None
