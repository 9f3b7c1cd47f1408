"""The control planes on the port's served path, on the CPU.

One pair of ``torch --device cpu --pipeline native`` servers on one fake
clock: one with the planes at their defaults (the signal bus with the
usage observatory, ``--model-fit on``, ``--flight on``) and one with
``--flight off --model-fit off --usage-topk 0``. The HTTP sequence of
``tests/torch_http.py`` and a gRPC ShouldRateLimit drive through the
native lane go to both:

- the answers are byte-equal, and so are ``/counters``, ``/limits`` and
  the ``authorized_calls``/``authorized_hits``/``limited_calls`` samples;
- on the defaults server ``/debug/signals``, ``/debug/capacity`` (bare,
  with what-if queries, with bad ones), ``/debug/flight`` (the list, a
  bundle by name, an unknown name) and ``POST /debug/flight/trigger``
  (with and without a body, a bad note) answer the JAX package's status
  codes with the JAX keys, as the JAX ``make_http_app`` answers over the
  JAX planes; the served fit has ingested batches, the flight recorder
  has tapped the ``lean`` lane, and ``/debug/stats`` carries the
  ``signals``, ``capacity`` and ``flight`` sections; on the other server
  every one of those routes answers 404, as on a JAX server with the
  planes off.

Also: a ``--flight-spool-dir`` that cannot be created stops ``start``
with a ValueError (the binary exits 2), and ``server.stop()`` stops the
trigger thread and takes the taps off the recorder and the estimator's
context off the process estimator.
"""

import asyncio
import json
from urllib.parse import quote

import aiohttp
import grpc
import pytest
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from limitador_tpu.core.limiter import RateLimiter as JRateLimiter
from limitador_tpu.observability import flight as j_flight
from limitador_tpu.observability import model as j_model
from limitador_tpu.observability import signals as j_signals
from limitador_tpu.server.http_api import make_http_app as j_make_http_app
from limitador_tpu.storage.in_memory import InMemoryStorage as JInMemory
from limitador_tpu_torch.observability import model
from limitador_tpu_torch.server import __main__ as port_main
from limitador_tpu_torch.server.proto import rls_pb2
from tests import torch_http as H
from tests.torch_steady import steady

parse = port_main.build_parser().parse_args
ENVOY = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
OFF = ("--flight", "off", "--model-fit", "off", "--usage-topk", "0")

#: (method, path, body or None): the debug requests sent to every server
#: and to the JAX app; "{bundle}" is the first bundle's name
DEBUG_REQUESTS = [
    ("GET", "/debug/signals", None),
    ("GET", "/debug/capacity", None),
    ("GET", "/debug/capacity?batch=8&lease_share=0.5&procs=2", None),
    ("GET", "/debug/capacity?batch=0", None),
    ("GET", "/debug/capacity?lease_share=nan", None),
    ("GET", "/debug/capacity?procs=x", None),
    ("GET", "/debug/flight", None),
    ("POST", "/debug/flight/trigger", {"note": "from a test"}),
    ("POST", "/debug/flight/trigger", None),
    ("POST", "/debug/flight/trigger", {"note": 5}),
    ("GET", "/debug/flight?name={bundle}", None),
    ("GET", "/debug/flight?name=flight-1-manual-h0.json", None),
    ("GET", "/debug/flight?name=..%2Fx", None),
]


def _request(user) -> bytes:
    req = rls_pb2.RateLimitRequest(domain="api")
    d = req.descriptors.add()
    for key, value in (("method", "GET"), ("user", user), ("tenant", "t")):
        d.entries.add(key=key, value=value)
    return req.SerializeToString()


async def _debug(session, base, bundle_name):
    out = []
    for method, path, body in DEBUG_REQUESTS:
        path = path.replace("{bundle}", quote(bundle_name or "none"))
        kwargs = {"json": body} if body is not None else {}
        async with session.request(method, base + path, **kwargs) as resp:
            raw = await resp.read()
            try:
                payload = json.loads(raw)
            except ValueError:
                payload = raw.decode()
            out.append((resp.status, payload))
        if method == "POST" and out[-1][0] == 200 and bundle_name is None:
            bundle_name = out[-1][1]["bundle"]
    return out


async def _pair(tmp_path):
    clock = H.FakeClock()
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(H.LIMITS)
    ports = {"on": H.free_port(), "off": H.free_port()}
    servers, rls = {}, {}
    out = {}
    try:
        for name, extra in (("on", ("--usage-drain-interval", "0.05")),
                            ("off", OFF)):
            argv = H.port_argv(limits_path, "torch", ports[name],
                               "--pipeline", "native", *extra)
            rls[name] = argv[argv.index("--rls-port") + 1]
            servers[name] = await port_main.start(parse(argv), clock=clock)
        answers = {name: [] for name in servers}
        for name, port in rls.items():
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{port}") as chan:
                for i in range(40):
                    answers[name].append(await chan.unary_unary(ENVOY)(
                        _request(f"g{i % 7}"), timeout=30))
        # a few drains, bus ticks and refits: wait for what the test
        # asserts of them (a fixed sleep could end first under load)
        on = servers["on"]

        def planes_fed():
            taps = on.flight_engine.recorder.flight_debug()
            return (on.model_estimator.observations > 0
                    and on.model_estimator.updates > 0
                    and taps["taps"] > 0
                    and taps["tail_depth"].get("lean", 0) > 0)

        await H.wait_for(planes_fed, timeout=10.0)

        async def reload():
            H.reload_limits_file(limits_path)
            await H.wait_for(lambda: all(
                s.status["limits_file_version"] == 2
                for s in servers.values()))

        debug = {}

        async def extra(session, name, base):
            debug[name] = await _debug(session, base, None)
            async with session.get(base + "/debug/stats") as resp:
                debug[name, "stats"] = await resp.json()

        out = await H.drive(clock, {
            name: f"http://127.0.0.1:{port}" for name, port in ports.items()
        }, reload, extra)
        out["grpc"] = answers
        out["debug"] = debug
        on = servers["on"]
        out["served"] = {
            "observations": on.model_estimator.observations,
            "updates": on.model_estimator.updates,
            "taps": on.flight_engine.recorder.flight_debug(),
            "thread": on.flight_engine.is_alive(),
        }
        return out
    finally:
        for server in servers.values():
            await server.stop()
        if "on" in servers:
            on = servers["on"]
            out["stopped"] = {
                "thread": on.flight_engine.is_alive(),
                "recorder_tap": on.limiter.recorder.flight_tap,
                "recorder_model": on.limiter.recorder.model,
                "context": model.process_estimator()._context_fn,
            }


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    with steady():
        return asyncio.run(_pair(tmp_path_factory.mktemp("planes")))


def _reference_samples(text):
    return {
        (s.name, tuple(sorted(s.labels.items()))): s.value
        for family in text_string_to_metric_families(text)
        if family.name in ("authorized_calls", "authorized_hits",
                           "limited_calls")
        for s in family.samples if not s.name.endswith("_created")
    }


def test_planes_change_no_answer_and_no_counter(pair):
    on, off = pair["on"], pair["off"]
    assert on["steps"] == off["steps"]
    assert pair["grpc"]["on"] == pair["grpc"]["off"]
    codes = [rls_pb2.RateLimitResponse.FromString(a).overall_code
             for a in pair["grpc"]["on"]]
    assert rls_pb2.RateLimitResponse.OVER_LIMIT in codes
    for key in ("counters", "limits", "status"):
        assert on[key] == off[key], key
    assert _reference_samples(on["metrics"]) == \
        _reference_samples(off["metrics"])
    assert _reference_samples(on["metrics"])


async def _jax_debug(tmp_path):
    """The same debug requests to the JAX app over JAX planes (a bus, an
    estimator fed a few launches, a trigger engine), and to one without
    them."""
    est = j_model.ServingModelEstimator(calibration=lambda: 1.0)
    for i in range(200):
        est.ingest(8 * (1 + i % 4), 1e-4, 2e-5, 1e-5)
    est.refit(force=True)
    bus = j_signals.SignalBus()
    bus.attach_model(est)
    engine = j_flight.TriggerEngine(
        j_flight.FlightRecorder(), j_flight.BundleSpool(tmp_path / "jax"),
        signals=bus)
    out = {}
    for name, sources in (("on", [bus, est, engine]), ("off", [])):
        app = j_make_http_app(JRateLimiter(JInMemory()), None, {},
                              debug_sources=sources)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            base = str(client.make_url(""))
            async with aiohttp.ClientSession() as session:
                out[name] = await _debug(session, base, None)
        finally:
            await client.close()
    return out


def _keys(payload):
    return set(payload) if isinstance(payload, dict) else type(payload)


def test_debug_routes_answer_the_jax_codes_and_keys(pair, tmp_path):
    with steady():
        jax = asyncio.run(_jax_debug(tmp_path))
    for name in ("on", "off"):
        got, want = pair["debug"][name], jax[name]
        for (method, path, _b), (gs, gp), (ws, wp) in zip(
                DEBUG_REQUESTS, got, want):
            assert gs == ws, (name, method, path, gp, wp)
            assert _keys(gp) == _keys(wp), (name, path)
    on = dict(zip((p for _m, p, _b in DEBUG_REQUESTS), pair["debug"]["on"]))
    signals_body = on["/debug/signals"][1]
    assert signals_body["fields"] == list(j_signals.ControlSignals.FIELDS)
    assert len(signals_body["vector"]) == 32
    assert signals_body["current"]["device_backed"] == 0  # --device cpu
    assert signals_body["current"]["batch_fill"] > 0
    assert signals_body["timeline"]
    capacity = on["/debug/capacity?batch=8&lease_share=0.5&procs=2"][1]
    assert capacity["what_if"]["batch"] == 8
    assert capacity["what_if"]["procs"] == 2
    bundle = on["/debug/flight?name={bundle}"][1]
    assert bundle["reason"] == "manual" and bundle["note"] == "from a test"
    assert bundle["local"]["worst"]["lean"]
    assert bundle["profile"] is None  # --flight-profile-s 0
    assert set(bundle) == set(jax["on"][10][1])


def test_served_planes_ingest_tap_and_stop(pair):
    served = pair["served"]
    assert served["observations"] > 0 and served["updates"] > 0
    assert served["taps"]["taps"] > 0
    assert served["taps"]["tail_depth"]["lean"] > 0
    assert served["thread"]
    stopped = pair["stopped"]
    assert not stopped["thread"]
    assert stopped["recorder_tap"] is None
    assert stopped["recorder_model"] is None
    assert stopped["context"] is None
    stats = pair["debug"]["on", "stats"]
    for section in ("signals", "capacity", "flight"):
        assert section in stats, section
        assert section not in pair["debug"]["off", "stats"], section
    assert stats["flight"]["triggers"]["manual"] == 2
    assert stats["flight"]["bundles"] == 2
    assert stats["capacity"]["observations"] > 0


def test_an_unusable_spool_dir_stops_the_server(tmp_path):
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(H.LIMITS)
    (tmp_path / "file").write_text("not a directory")
    argv = H.port_argv(limits_path, "torch", H.free_port(),
                       "--flight-spool-dir", str(tmp_path / "file" / "x"))
    with steady():
        with pytest.raises(ValueError, match="--flight-spool-dir"):
            asyncio.run(port_main.start(parse(argv)))


def test_api_spec_covers_the_plane_routes():
    from limitador_tpu.server.http_api import _openapi_spec as j_spec
    from limitador_tpu_torch.server.http_api import _openapi_spec

    paths, j_paths = _openapi_spec()["paths"], j_spec()["paths"]
    for path in ("/debug/signals", "/debug/capacity", "/debug/flight",
                 "/debug/flight/trigger"):
        assert paths[path] == j_paths[path], path
