"""The HTTP request sequence of the port's HTTP API tests, and its drive.

Shared by ``test_torch_http_api.py`` and ``test_torch_metrics.py`` (the
port against the JAX package on the CPU) and ``test_torch_gpu.py`` (a
``--device cuda`` server against a ``--device cpu`` one on the card).
It imports aiohttp and the port only, so the card's machine, which has
no JAX, can import it.

One sequence goes to every server under test, each on its own free port
and all on one fake clock: ``POST /check_and_report`` with and without
draft-03 headers, ``/check`` and ``/report``, fixed windows and token
buckets, hits past a limit, clock steps past a window, bad bodies and a
negative delta (400), and, between the two halves, a hot reload of the
limits file. ``drive`` records each answer's status, ``X-RateLimit-*``
headers and body, then the JSON bodies of ``/limits``, ``/counters`` and
``/status`` and the ``/metrics`` exposition.
"""

import asyncio
import json
import os
import socket
import time

import aiohttp
import pytest

LIMITS = """\
- namespace: api
  max_value: 5
  seconds: 60
  conditions: ["descriptors[0].method == 'GET'"]
  variables: ["descriptors[0].user"]
  name: per-user-get
- namespace: api
  max_value: 6
  seconds: 30
  variables: ["descriptors[0].tenant"]
  name: per-tenant
- namespace: tb
  max_value: 4
  seconds: 2
  variables: ["descriptors[0].user"]
  policy: token_bucket
  name: bucket
"""

#: drops per-tenant, raises per-user-get, adds a namespace-wide limit
RELOADED = """\
- namespace: api
  max_value: 7
  seconds: 60
  conditions: ["descriptors[0].method == 'GET'"]
  variables: ["descriptors[0].user"]
  name: per-user-get
- namespace: tb
  max_value: 4
  seconds: 2
  variables: ["descriptors[0].user"]
  policy: token_bucket
  name: bucket
- namespace: tb
  max_value: 9
  seconds: 10
  name: tb-total
"""

NAMESPACES = ("api", "tb")
DRAFT = "DRAFT_VERSION_03"
#: a CEL label map for --metric-labels
LABELS = "{'user': descriptors[0].user}"


class FakeClock:
    def __init__(self):
        self.now = 1_700_000_000.0

    def __call__(self):
        return self.now


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _info(ns, values, delta=1, headers=False):
    body = {"namespace": ns, "values": values, "delta": delta}
    if headers:
        body["response_headers"] = DRAFT
    return body


def sequence():
    """(path, JSON body or raw bytes, clock advance before it) steps of
    one half of the drive."""
    get_a = {"method": "GET", "user": "a", "tenant": "t1"}
    get_b = {"method": "GET", "user": "b", "tenant": "t1"}
    post_c = {"method": "POST", "user": "c", "tenant": "t2"}
    steps = []
    for i in range(7):
        steps.append(("/check_and_report",
                      _info("api", get_a, headers=i % 2 == 0), 0.0))
    steps.append(("/check_and_report", _info("api", get_b, 3, True), 0.25))
    steps.append(("/check", _info("api", get_b), 0.0))
    steps.append(("/report", _info("api", get_b, 2), 0.0))
    steps.append(("/check", _info("api", get_b, 2), 0.1))
    steps.append(("/check_and_report", _info("api", post_c, 2, True), 0.0))
    steps.append(("/check_and_report", _info("api", {}, 1, True), 0.0))
    for i in range(6):
        steps.append(("/check_and_report",
                      _info("tb", {"user": "u"}, 1 + i % 2, i % 3 == 0),
                      0.3))
    steps.append(("/report", _info("tb", {"user": "u"}, 3), 0.0))
    steps.append(("/check", _info("tb", {"user": "u"}), 0.0))
    # bad bodies and a negative delta: 400 before any storage call
    steps.append(("/check_and_report", {"nope": 1}, 0.0))
    steps.append(("/report", _info("api", get_a, -1), 0.0))
    steps.append(("/check", b"{not json", 0.0))
    steps.append(("/check_and_report", _info("api", get_a, "x"), 0.0))
    # past the 30 s and 60 s windows
    steps.append(("/check_and_report", _info("api", get_a, 1, True), 31.0))
    steps.append(("/check_and_report", _info("api", get_a, 1, True), 30.0))
    steps.append(("/check_and_report", _info("tb", {"user": "v"}, 2, True),
                  0.0))
    return steps


async def _answer(session, base, path, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    async with session.post(base + path, data=data, headers={
            "Content-Type": "application/json"}) as resp:
        headers = {k: v for k, v in resp.headers.items()
                   if k.lower().startswith("x-ratelimit")}
        return resp.status, headers, await resp.read()


async def _get(session, base, path):
    async with session.get(base + path) as resp:
        return resp.status, resp.headers.get("Content-Type"), \
            await resp.read()


async def wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "timed out"
        await asyncio.sleep(0.02)


def reload_limits_file(path, text=RELOADED) -> None:
    """Replace the limits file with ``text``, its mtime a second on, so
    that a polling watcher sees the change at once, and as one change: a
    write and then a touch of the same file could be polled in between
    and reload twice."""
    tmp = path.with_name(path.name + ".next")
    tmp.write_text(text)
    st = path.stat()
    os.utime(tmp, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    os.replace(tmp, path)


async def drive(clock, servers, reload, extra=None):
    """Send both halves of the sequence to every server of ``servers``
    (name -> HTTP base URL) in turn, calling ``await reload()`` between
    the halves, and ``await extra(session, name, base)`` after the last
    step on each server. Returns name -> {"steps": [(status, headers,
    body)], "limits", "counters", "status", "metrics"}."""
    out = {name: {"steps": []} for name in servers}
    async with aiohttp.ClientSession() as session:
        for half in (0, 1):
            for path, body, advance in sequence():
                clock.now += advance
                for name, base in servers.items():
                    out[name]["steps"].append(
                        await _answer(session, base, path, body))
            if half == 0:
                await reload()
        for name, base in servers.items():
            rec = out[name]
            rec["limits"] = {
                ns: json.loads((await _get(session, base, f"/limits/{ns}"))[2])
                for ns in NAMESPACES
            }
            rec["counters"] = {
                ns: json.loads(
                    (await _get(session, base, f"/counters/{ns}"))[2])
                for ns in NAMESPACES
            }
            rec["status"] = json.loads((await _get(session, base,
                                                   "/status"))[2])
            if extra is not None:
                await extra(session, name, base)
            _st, rec["metrics_type"], body = await _get(session, base,
                                                        "/metrics")
            rec["metrics"] = body.decode()
    return out


@pytest.fixture(autouse=True)
def flight_spool(tmp_path, monkeypatch):
    """Imported by the test files whose servers are not started through
    ``port_argv``: a server's default ``--flight-spool-dir`` (read when
    the parser is built) is the test's own directory, never the default
    spool another test's server may prune."""
    monkeypatch.setenv("TPU_FLIGHT_SPOOL", str(tmp_path / "flight"))


def port_argv(limits_path, storage, http_port, *extra):
    """The port server's command line for one server of a drive. Its
    flight bundles go to ``flight/`` beside the limits file, never to the
    default spool another test's server may prune."""
    spool = os.path.join(os.path.dirname(str(limits_path)), "flight")
    return [str(limits_path), storage, "--device", "cpu", "--capacity",
            "4096", "--http-host", "127.0.0.1", "--http-port",
            str(http_port), "--rls-host", "127.0.0.1", "--rls-port",
            str(free_port()), "--limits-poll-interval", "0.05",
            "--flight-spool-dir", spool, *extra]
