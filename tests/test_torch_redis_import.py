"""The port's ``tools/redis_import.py`` against the JAX package's.

Every case of the JAX ``tests/test_redis_import.py`` runs through the
port's functions, over dumps built with the port's ``key_for_counter``
(byte-equal to the JAX package's and to the reference's key bytes), and
the results equal the JAX tool's on the same lines:

- ``parse_dump`` (comments, nil values, truncated and malformed lines
  with their line numbers), ``decode_entries`` (expired, unknown, v1 and
  id-prefixed keys), ``values_for_replay`` and ``unreplayable_reason``
  (a variable with no HTTP form, conditions on fields that are not the
  counter's variables, the ``kubernetes/`` configmap's limit among them,
  a multi-credit replay), ``replay`` stopping at the first failed send
  with the unsent remainder, and ``dump_line``;
- end to end: ``main`` replays a dump into a running port server
  (``torch --device cpu``) through ``POST /report``; ``/counters``
  equals the dump for every replayable entry, the unreplayable ones are
  counted and not sent (exit code 2), and an unreachable target leaves a
  ``.remaining`` file that a second run finishes without double counts.
"""

import asyncio
import base64
import json
import urllib.request
from pathlib import Path

import pytest
import yaml

from limitador_tpu.core.counter import Counter as JCounter
from limitador_tpu.core.limit import Limit as JLimit
from limitador_tpu.storage.keys import key_for_counter as j_key_for_counter
from limitador_tpu.tools import redis_import as J
from limitador_tpu_torch import Limit
from limitador_tpu_torch.core.counter import Counter
from limitador_tpu_torch.server import __main__ as port_main
from limitador_tpu_torch.storage.keys import key_for_counter
from limitador_tpu_torch.tools import redis_import as R
from tests import torch_http as H
from tests.torch_steady import steady

REPO = Path(__file__).resolve().parent.parent

LIMIT = Limit("api", 1000, 60, [], ["descriptors[0].u"])
NAMED = Limit("api", 500, 3600, [], ["descriptors[0].t"], id="plan-a")


def dump_line(counter, value, pttl=30_000):
    key = base64.b64encode(key_for_counter(counter)).decode()
    return f"{key} {value} {pttl}"


def _summary(pairs):
    return sorted(((str(c.namespace), c.limit.name, c.limit.id,
                    tuple(sorted(c.set_variables.items())), v)
                   for c, v in pairs), key=repr)


def _both_limits(limits):
    """Each port limit and its JAX twin."""
    return limits, [JLimit(str(lim.namespace), lim.max_value, lim.seconds,
                           sorted(c.source for c in lim.conditions),
                           sorted(v.source for v in lim.variables),
                           name=lim.name, id=lim.id) for lim in limits]


class _null_cm:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_port_keys_are_the_jax_keys():
    for limit, j_limit in zip(*_both_limits([LIMIT, NAMED])):
        for value in ("alice", "béb", ""):
            var = next(iter(limit.variables)).source
            assert key_for_counter(Counter(limit, {var: value})) == \
                j_key_for_counter(JCounter(j_limit, {var: value}))


def test_parse_and_decode_reference_keys():
    lines = [
        "# comment",
        "",
        dump_line(Counter(LIMIT, {"descriptors[0].u": "alice"}), 7),
        dump_line(Counter(NAMED, {"descriptors[0].t": "gold"}), 12),
        dump_line(Counter(LIMIT, {"descriptors[0].u": "bob"}), 3, pttl=0),
    ]
    entries, nil_skipped = R.parse_dump(lines)
    assert (entries, nil_skipped) == J.parse_dump(lines)
    assert nil_skipped == 0 and len(entries) == 3
    limits, j_limits = _both_limits([LIMIT, NAMED])
    pairs, expired, unknown = R.decode_entries(entries, limits)
    j_pairs, j_expired, j_unknown = J.decode_entries(entries, j_limits)
    assert (_summary(pairs), expired, unknown) == (
        _summary(j_pairs), j_expired, j_unknown)
    assert (expired, unknown) == (1, 0)
    got = {(str(c.namespace), tuple(sorted(c.set_variables.items()))): v
           for c, v in pairs}
    assert got[("api", (("descriptors[0].u", "alice"),))] == 7
    assert got[("api", (("descriptors[0].t", "gold"),))] == 12


def test_unknown_keys_counted_not_fatal():
    other = Limit("gone", 10, 60, [], ["descriptors[0].u"])
    entries, _ = R.parse_dump(
        [dump_line(Counter(other, {"descriptors[0].u": "x"}), 5)])
    assert R.decode_entries(entries, [LIMIT]) == ([], 0, 1)
    assert J.decode_entries(entries, _both_limits([LIMIT])[1]) == ([], 0, 1)


def test_nil_values_skipped_not_fatal():
    good = dump_line(Counter(LIMIT, {"descriptors[0].u": "a"}), 5)
    for tool in (R, J):
        entries, nil_skipped = tool.parse_dump([good, "QQ== nil 1000"])
        assert nil_skipped == 1 and len(entries) == 1
        with pytest.raises(ValueError, match="line 1"):
            tool.parse_dump(["QQ== 42"])


@pytest.mark.parametrize("lines,where", [
    (["not-base64!!! 5 1000"], "line 1"),
    (["", "QQ== five 1000"], "line 2"),
])
def test_malformed_lines_raise_with_line_number(lines, where):
    for tool in (R, J):
        with pytest.raises(ValueError, match=where) as exc:
            tool.parse_dump(lines)
        if tool is R:
            port = str(exc.value)
    with pytest.raises(ValueError) as exc:
        J.parse_dump(lines)
    assert port == str(exc.value)


def test_send_failure_stops_and_returns_resumable_remainder():
    def run(tool, limit, counter_cls):
        pairs = [(counter_cls(limit, {"descriptors[0].u": f"u{i}"}), i + 1)
                 for i in range(5)]
        calls = []

        def opener(req, timeout):
            calls.append(json.loads(req.data))
            if len(calls) == 3:
                raise OSError("connection reset")
            return _null_cm()

        sent, unreplayable, remaining, error = tool.replay(
            pairs, "http://unused", opener=opener)
        return sent, unreplayable, [v for _c, v in remaining], error, calls

    port = run(R, LIMIT, Counter)
    jax = run(J, _both_limits([LIMIT])[1][0], JCounter)
    assert port == jax
    assert port[:3] == (2, 0, [3, 4, 5]) and "connection reset" in port[3]


def test_unreplayable_variable_forms_reported_not_sent():
    c = Counter(LIMIT, {"descriptors[0].u": "a"})
    assert R.values_for_replay(c) == {"u": "a"}
    dotted = Limit("api", 10, 60, [], ["descriptors[0]['k.with.dots']"])
    assert R.values_for_replay(
        Counter(dotted, {"descriptors[0]['k.with.dots']": "v"})
    ) == {"k.with.dots": "v"}
    quoted = Limit("api", 10, 60, [], ['descriptors[0]["q"]'])
    assert R.values_for_replay(
        Counter(quoted, {'descriptors[0]["q"]': "w"})) == {"q": "w"}
    weird = Limit("api", 10, 60, [], ["size(descriptors)"])
    calls = []
    out = R.replay(
        [(Counter(weird, {"size(descriptors)": "1"}), 5)], "http://unused",
        opener=lambda req, timeout: calls.append(req) or _null_cm())
    assert out == (0, 1, [], None) and not calls
    j_weird = _both_limits([weird])[1][0]
    assert J.replay(
        [(JCounter(j_weird, {"size(descriptors)": "1"}), 5)],
        "http://unused", opener=lambda req, timeout: _null_cm()) == out


def _classify(tool, counter_cls, limit, variables, others):
    return tool.unreplayable_reason(counter_cls(limit, variables), others)


def test_condition_unreplayable_entries_detected_not_miscredited():
    gated = Limit("api", 1000, 60, ["descriptors[0].m == 'GET'"],
                  ["descriptors[0].u"])
    (p_gated, p_limit), (j_gated, j_limit) = _both_limits([gated, LIMIT])
    variables = {"descriptors[0].u": "alice"}
    reason = _classify(R, Counter, p_gated, variables, [p_gated, p_limit])
    assert reason == _classify(J, JCounter, j_gated, variables,
                               [j_gated, j_limit])
    assert reason[0] == "conditions"
    for tool, counter_cls, limits in ((R, Counter, [p_gated, p_limit]),
                                      (J, JCounter, [j_gated, j_limit])):
        calls, stats = [], {}
        out = tool.replay(
            [(counter_cls(limits[0], variables), 9)], "http://unused",
            opener=lambda req, timeout: calls.append(req) or _null_cm(),
            limits=limits, stats=stats)
        assert out == (0, 1, [], None)
        assert stats == {"shape": 0, "conditions": 1, "multi_credit": 0}
        assert not calls


def _configmap_limits():
    doc = yaml.safe_load(
        (REPO / "kubernetes" / "limitador-config-configmap.yaml").read_text())
    return yaml.safe_load(doc["data"]["limits.yaml"])


def test_the_configmap_shape_is_unreplayable_in_both_packages(tmp_path):
    """The deployment's configmap limits requests by user with a
    condition on the method: a counter keyed by user alone cannot be
    replayed as a /report (the method is not among its variables), in
    either package; the same limit without the condition can."""
    from limitador_tpu.server.limits_file import (
        load_limits_file as j_load,
    )
    from limitador_tpu_torch.server.limits_file import load_limits_file

    entries = _configmap_limits()
    path = tmp_path / "limits.yaml"
    path.write_text(yaml.safe_dump(entries))
    port, jax = load_limits_file(str(path)), j_load(str(path))
    assert len(port) == len(jax) == 1
    variables = {"descriptors[0].user": "alice"}
    got = _classify(R, Counter, port[0], variables, port)
    assert got == _classify(J, JCounter, jax[0], variables, jax)
    assert got == ("conditions", 0)
    open_entries = [dict(entries[0], conditions=[])]
    path.write_text(yaml.safe_dump(open_entries))
    port, jax = load_limits_file(str(path)), j_load(str(path))
    got = _classify(R, Counter, port[0], variables, port)
    assert got == _classify(J, JCounter, jax[0], variables, jax)
    assert got == (None, 0)


def test_multi_credit_replays_are_warned_but_sent():
    twin = Limit("api", 99, 7, [], ["descriptors[0].u"])
    (p_limit, p_twin), (j_limit, j_twin) = _both_limits([LIMIT, twin])
    variables = {"descriptors[0].u": "alice"}
    assert _classify(R, Counter, p_limit, variables, [p_limit, p_twin]) == \
        _classify(J, JCounter, j_limit, variables, [j_limit, j_twin]) == \
        (None, 1)
    for tool, counter_cls, limits in ((R, Counter, [p_limit, p_twin]),
                                      (J, JCounter, [j_limit, j_twin])):
        calls, stats = [], {}
        sent, unreplayable, _rest, _err = tool.replay(
            [(counter_cls(limits[0], variables), 4)], "http://unused",
            opener=lambda req, timeout: calls.append(req) or _null_cm(),
            limits=limits, stats=stats)
        assert (sent, unreplayable, stats["multi_credit"], len(calls)) == \
            (1, 0, 1, 1)


def test_replayable_entry_passes_condition_preflight():
    limits, j_limits = _both_limits([LIMIT, NAMED])
    variables = {"descriptors[0].u": "alice"}
    assert _classify(R, Counter, limits[0], variables, limits) == \
        _classify(J, JCounter, j_limits[0], variables, j_limits) == (None, 0)


def test_dump_line_round_trips_and_equals_the_jax_line():
    for limit, j_limit in zip(*_both_limits([LIMIT, NAMED])):
        var = next(iter(limit.variables)).source
        line = R.dump_line(Counter(limit, {var: "x"}), 17, 250)
        assert line == J.dump_line(JCounter(j_limit, {var: "x"}), 17, 250)
        entries, _ = R.parse_dump([line])
        pairs, _e, _u = R.decode_entries(entries, [limit])
        assert _summary(pairs) == [(str(limit.namespace), limit.name,
                                    limit.id, ((var, "x"),), 17)]


# -- end to end through a port server ---------------------------------------------

SERVED_LIMITS = """\
- namespace: api
  max_value: 1000
  seconds: 60
  variables: ["descriptors[0].u"]
- namespace: api
  max_value: 100
  seconds: 60
  conditions: ["descriptors[0].method == 'GET'"]
  variables: ["descriptors[0].user"]
  name: gated
"""


def _served_dump(limits):
    """Replayable counters of the first limit, and one of the gated
    limit, keyed by user alone (the configmap's shape)."""
    lines = [dump_line(Counter(limits[0], {"descriptors[0].u": u}), v)
             for u, v in (("alice", 40), ("bob", 9), ("carol", 1))]
    lines.append(dump_line(Counter(limits[1], {"descriptors[0].user": "dan"}),
                           5))
    lines.append(dump_line(Counter(limits[0], {"descriptors[0].u": "old"}),
                           3, pttl=0))
    return lines


async def _counters(base):
    import aiohttp

    async with aiohttp.ClientSession() as session:
        async with session.get(base + "/counters/api") as resp:
            return await resp.json()


def _remaining(counters):
    return sorted(((c["limit"]["name"], tuple(sorted(
        c["set_variables"].items())), c["remaining"]) for c in counters),
        key=repr)


def test_end_to_end_replay_into_a_port_server(tmp_path, capsys):
    from limitador_tpu_torch.server.limits_file import load_limits_file

    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(SERVED_LIMITS)
    limits = load_limits_file(str(limits_path))
    dump = tmp_path / "counters.dump"
    dump.write_text("\n".join(_served_dump(limits)) + "\n")
    http_port = H.free_port()
    argv = H.port_argv(limits_path, "torch", http_port)
    base = f"http://127.0.0.1:{http_port}"

    async def run():
        server = await port_main.start(port_main.build_parser()
                                       .parse_args(argv))
        loop = asyncio.get_running_loop()
        try:
            dry = await loop.run_in_executor(None, R.main, [
                str(limits_path), str(dump), "--dry-run",
                "--target", base])
            after_dry = await _counters(base)
            # the send path, on a thread: the tool's urllib blocks
            rc = await loop.run_in_executor(None, R.main, [
                str(limits_path), str(dump), "--target", base])
            got = await _counters(base)
            stats = (await loop.run_in_executor(
                None, lambda: json.loads(urllib.request.urlopen(
                    base + "/debug/stats", timeout=10).read())))
            return dry, after_dry, rc, got, stats
        finally:
            await server.stop()

    with steady():
        dry, after_dry, rc, got, stats = asyncio.run(run())
    err = capsys.readouterr().err
    assert dry == 0 and after_dry == []
    # one entry unreplayable (conditions): counted, not sent, exit 2
    assert rc == 2
    assert "decoded 4 live counters (1 expired skipped" in err
    assert "1 unreplayable NOT sent" in err and "1 whose limit" in err
    assert _remaining(got) == [
        (None, (("descriptors[0].u", "alice"),), 960),
        (None, (("descriptors[0].u", "bob"),), 991),
        (None, (("descriptors[0].u", "carol"),), 999),
    ]
    assert stats["shards"]


def test_an_unreachable_target_leaves_a_resumable_remainder(tmp_path):
    from limitador_tpu_torch.server.limits_file import load_limits_file

    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(SERVED_LIMITS)
    limits = load_limits_file(str(limits_path))
    dump = tmp_path / "counters.dump"
    dump.write_text("\n".join(_served_dump(limits)[:3]) + "\n")
    http_port = H.free_port()
    rc = R.main([str(limits_path), str(dump), "--target",
                 f"http://127.0.0.1:{http_port}"])
    assert rc == 1
    remainder = Path(str(dump) + ".remaining")
    entries, _ = R.parse_dump(remainder.read_text().splitlines())
    assert len(entries) == 3
    argv = H.port_argv(limits_path, "torch", http_port)

    async def run():
        server = await port_main.start(port_main.build_parser()
                                       .parse_args(argv))
        try:
            rc = await asyncio.get_running_loop().run_in_executor(
                None, R.main, [str(limits_path), str(remainder), "--target",
                               f"http://127.0.0.1:{http_port}"])
            return rc, await _counters(f"http://127.0.0.1:{http_port}")
        finally:
            await server.stop()

    with steady():
        rc, got = asyncio.run(run())
    assert rc == 0
    assert [r for _n, _v, r in _remaining(got)] == [960, 991, 999]
