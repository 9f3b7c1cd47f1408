"""The port's Prometheus metrics against the JAX package's.

The HTTP request sequence of ``tests/torch_http.py`` goes to the JAX
package's HTTP and gRPC servers over ``AsyncTpuStorage(TpuStorage)``
(wired as the JAX server wires them: ``set_metrics``, the library
source and the MetricsLayer's ``should_rate_limit`` aggregate) and to
the port's server (``torch --device cpu``), both with
``--limit-name-in-labels`` and a CEL ``--metric-labels`` map; a few gRPC
``ShouldRateLimit`` calls follow, then a labels reload. The two
``/metrics`` bodies, parsed with ``prometheus_client.parser``:

- every family the port declares is declared by the JAX package with the
  same type and help;
- the ``authorized_calls``, ``authorized_hits`` and ``limited_calls``
  samples are equal, and so are the counts of ``datastore_latency`` and
  ``datastore_device_latency``;
- the per-shard table gauges equal the storage's ``device_stats``.

Also: exemplars switch to the OpenMetrics exposition; every family that
``examples/grafana-dashboard.json`` reads under a ported prefix is
declared (the native ingress's ``ingress_*`` and
``native_phase_h2i_respond`` among them); the device plane's families (recorder, chunked
dispatch, native telemetry, SLO watchdog, ``device_backed``) are the JAX
package's; and the native (with leases), tiered and sharded servers feed
their families from the layers' own tallies.
"""

import asyncio
import json
import re
from pathlib import Path

import aiohttp
import grpc
import pytest
from prometheus_client.parser import text_string_to_metric_families

from limitador_tpu.core.limiter import AsyncRateLimiter as JAsyncRateLimiter
from limitador_tpu.observability import metrics_layer as j_metrics_layer
from limitador_tpu.observability.metrics import (
    PrometheusMetrics as JPrometheusMetrics,
)
from limitador_tpu.server.http_api import run_http_server as j_run_http
from limitador_tpu.server.limits_file import load_limits_file as j_load
from limitador_tpu.server.rls import serve_rls as j_serve_rls
from limitador_tpu.tpu.batcher import AsyncTpuStorage
from limitador_tpu.tpu.storage import TpuStorage
from limitador_tpu_torch.observability.device_plane import set_request_id
from limitador_tpu_torch.observability.metrics import PrometheusMetrics
from limitador_tpu_torch.observability.metrics_layer import Timings
from limitador_tpu_torch.server import __main__ as port_main
from limitador_tpu_torch.server.proto import rls_pb2
from tests import torch_http as H

REPO = Path(__file__).resolve().parent.parent
ENVOY = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
#: the reloaded label map: same label name, another value expression
RELABELED = "{'user': descriptors[0].tenant}"
parse = port_main.build_parser().parse_args


def _request(domain, entries, hits_addend=0) -> bytes:
    req = rls_pb2.RateLimitRequest(domain=domain, hits_addend=hits_addend)
    d = req.descriptors.add()
    for k, v in entries.items():
        d.entries.add(key=k, value=v)
    return req.SerializeToString()


async def _should_rate_limit(port, blobs):
    async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as chan:
        for blob in blobs:
            await chan.unary_unary(ENVOY)(blob, timeout=30)


GRPC_CALLS = [
    _request("api", {"method": "GET", "user": "g", "tenant": "t3"}),
] * 6 + [_request("tb", {"user": "g"}, 2)] * 3


async def _pair(tmp_path):
    clock = H.FakeClock()
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(H.LIMITS)
    labels_path = tmp_path / "labels.cel"
    labels_path.write_text(H.LABELS)
    j_metrics = JPrometheusMetrics(use_limit_name_label=True,
                                   metric_labels=H.LABELS)
    j_storage = AsyncTpuStorage(TpuStorage(capacity=4096, clock=clock))
    j_limiter = JAsyncRateLimiter(j_storage)
    await j_limiter.configure_with(j_load(str(limits_path)))
    j_metrics.attach_library_source(j_storage)
    j_storage.set_metrics(j_metrics)
    prior_layer = j_metrics_layer.installed()
    j_metrics_layer.install(j_metrics_layer.MetricsLayer().gather(
        "should_rate_limit", j_metrics.record_datastore_latency,
        ["datastore"]))
    j_status = {"limits_file_version": 1, "limits_file_errors": 0}
    j_http, j_rls = H.free_port(), H.free_port()
    p_http = H.free_port()
    j_runner = await j_run_http(j_limiter, "127.0.0.1", j_http, j_metrics,
                                j_status)
    j_server = await j_serve_rls(j_limiter, f"127.0.0.1:{j_rls}", j_metrics)
    argv = H.port_argv(limits_path, "torch", p_http, "--limit-name-in-labels",
                       "--metric-labels-file", str(labels_path))
    server = await port_main.start(parse(argv), clock=clock)
    p_rls = int(argv[argv.index("--rls-port") + 1])

    async def reload():
        H.reload_limits_file(limits_path)
        await j_limiter.configure_with(j_load(str(limits_path)))
        await H.wait_for(lambda: any(l.name == "tb-total" for l in
                                     server.limiter.get_limits("tb")))

    async def extra(session, name, base):
        if name == "jax":
            await _should_rate_limit(j_rls, GRPC_CALLS)
            j_metrics.reload_labels(RELABELED)
            await _should_rate_limit(j_rls, GRPC_CALLS[:1])
            return
        await _should_rate_limit(p_rls, GRPC_CALLS)
        labels_path.write_text(RELABELED)
        await H.wait_for(
            lambda: server.metrics.labels_expr.source == RELABELED)
        await _should_rate_limit(p_rls, GRPC_CALLS[:1])

    try:
        out = await H.drive(clock, {
            "jax": f"http://127.0.0.1:{j_http}",
            "port": f"http://127.0.0.1:{p_http}",
        }, reload, extra)
        out["device_stats"] = server.storage.device_stats()
        return out
    finally:
        await server.stop()
        await j_runner.cleanup()
        await j_server.stop(grace=None)
        await j_storage.close()
        j_metrics_layer.install(prior_layer)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return asyncio.run(_pair(tmp_path_factory.mktemp("metrics")))


def _families(text):
    """Families by name; the ``*_created`` timestamps a labeled counter's
    samples bring are left out."""
    return {
        f.name: f for f in text_string_to_metric_families(text)
        if f.type != "unknown" and not f.name.endswith("_created")
    }


def _samples(family, suffix=""):
    return sorted(
        (s.name, tuple(sorted(s.labels.items())), s.value)
        for s in family.samples if s.name.endswith(suffix)
    )


def test_every_port_family_is_a_jax_family(pair):
    jax = _families(pair["jax"]["metrics"])
    port = _families(pair["port"]["metrics"])
    assert len(port) >= 50
    for name, family in port.items():
        assert name in jax, name
        assert (family.type, family.documentation) == (
            jax[name].type, jax[name].documentation), name


DEVICE_PLANE_FAMILIES = (
    "batcher_queue_wait", "batcher_batch_fill_ratio", "batcher_flushes",
    "device_phase_latency", "dispatch_chunk_hits", "dispatch_chunk_splits",
    "native_phase_hot_lookup", "native_phase_hot_stage",
    "native_phase_lease_hit", "native_phase_hot_finish", "slo_p99_ms_5m",
    "slo_p99_ms_1h", "slo_burn_rate_5m", "slo_burn_rate_1h", "slo_budget_ms",
    "slo_breached", "slo_breached_actionable", "device_backed",
)


@pytest.mark.parametrize("name", DEVICE_PLANE_FAMILIES)
def test_device_plane_families_are_the_jax_families(name):
    """Each family of the device plane is declared with the JAX
    package's type, help and bucket edges."""
    port = _families(PrometheusMetrics().render().decode())
    jax = _families(JPrometheusMetrics().render().decode())
    assert name in port, name
    assert (port[name].type, port[name].documentation) == (
        jax[name].type, jax[name].documentation)
    edges = [
        sorted({s.labels["le"] for s in fam.samples if "le" in s.labels})
        for fam in (port[name], jax[name])
    ]
    assert edges[0] == edges[1]


@pytest.mark.parametrize("name", [
    "authorized_calls", "authorized_hits", "limited_calls",
])
def test_reference_counters_equal_the_jax_samples(pair, name):
    jax = _families(pair["jax"]["metrics"])[name]
    port = _families(pair["port"]["metrics"])[name]
    assert _samples(port, "_total") == _samples(jax, "_total")
    assert _samples(port, "_total")


def test_limit_names_and_custom_labels_are_in_the_samples(pair):
    limited = _families(pair["port"]["metrics"])["limited_calls"]
    labels = [dict(lbl) for _n, lbl, _v in _samples(limited, "_total")]
    assert {"limitador_namespace", "limitador_limit_name", "user"} == set(
        labels[0])
    assert {l["limitador_limit_name"] for l in labels} >= {"per-user-get"}
    authorized = _families(pair["port"]["metrics"])["authorized_calls"]
    users = {dict(lbl)["user"] for _n, lbl, _v in
             _samples(authorized, "_total")}
    # "t3" only after the labels reload, which maps user to the tenant
    assert {"a", "g", "t3"} <= users


@pytest.mark.parametrize("name", [
    "datastore_latency", "datastore_device_latency",
])
def test_latency_counts_equal_the_jax_counts(pair, name):
    def count(text):
        return [s.value for s in _families(text)[name].samples
                if s.name == name + "_count"][0]

    want = count(pair["jax"]["metrics"])
    assert count(pair["port"]["metrics"]) == want
    assert want > 0


def test_shard_gauges_equal_device_stats(pair):
    families = _families(pair["port"]["metrics"])
    (shard,) = pair["device_stats"]["shards"]
    used = {dict(lbl)["shard"]: v for _n, lbl, v in
            _samples(families["counter_slots_used"])}
    capacity = {dict(lbl)["shard"]: v for _n, lbl, v in
                _samples(families["counter_slots_capacity"])}
    assert used == {"0": shard["occupied"]} and shard["occupied"] > 0
    assert capacity == {"0": shard["capacity"]} == {"0": 4096}


def test_metrics_body_is_the_text_exposition(pair):
    assert pair["port"]["metrics_type"].startswith("text/plain")
    assert pair["port"]["metrics_type"] == pair["jax"]["metrics_type"]


def test_exemplars_render_openmetrics_with_the_request_id():
    metrics = PrometheusMetrics()
    metrics.enable_exemplars()
    set_request_id("req-7")
    metrics.record_datastore_latency(Timings(busy=30_000_000))
    metrics.record_datastore_latency(Timings(busy=1_000_000))
    body = metrics.render().decode()
    assert metrics.content_type.startswith("application/openmetrics-text")
    assert body.endswith("# EOF\n")
    exemplars = [l for l in body.splitlines() if 'trace_id="req-7"' in l]
    assert len(exemplars) == 1 and 'le="0.05"' in exemplars[0]
    j_metrics = JPrometheusMetrics()
    j_metrics.enable_exemplars()
    assert j_metrics.content_type == metrics.content_type


def test_labels_reload_refuses_new_label_names():
    metrics = PrometheusMetrics(metric_labels=H.LABELS)
    metrics.reload_labels(RELABELED)
    with pytest.raises(ValueError):
        metrics.reload_labels("{'tenant': descriptors[0].tenant}")
    with pytest.raises(ValueError):
        PrometheusMetrics(metric_labels="descriptors[0].x")


def _dashboard_families():
    """Sample and family names the Grafana dashboard reads under the
    ported prefixes."""
    text = (REPO / "examples" / "grafana-dashboard.json").read_text()
    exprs = " ".join(
        target.get("expr", "")
        for panel in json.loads(text).get("panels", [])
        for target in panel.get("targets", [])
    )
    names = set(re.findall(
        r"(?<![A-Za-z0-9_])((?:authorized|limited|datastore|batcher|"
        r"plan_cache|native_lane|lease|tenant|tier|sharded|device_phase|"
        r"native_phase|slo|signal|flight|model|capacity|ingress)"
        r"_[a-z0-9_]+|"
        r"device_backed)",
        exprs))
    return names


#: The prefixes above hold no family of a plane the port does not have
#: yet: the pod's and the capacity controller's families (``pod_*``,
#: ``ctl_*``, ROADMAP Queue A items 7 and 8) fall outside them; the pod's
#: ``pod_signal_*`` are not ``signal_*`` families.


HOT_LIMIT = """\
- namespace: hot
  max_value: 1000000
  seconds: 60
  variables: ["descriptors[0].user"]
"""


async def _layers(tmp_path):
    """Native (leases on), tiered and sharded servers of the port, each
    driven over gRPC; their /metrics and their layers' own tallies."""
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(H.LIMITS + HOT_LIMIT)
    argv = {
        "native": ("torch", "--pipeline", "native", "--lease-mode", "on",
                   "--batch-delay-us", "200"),
        "tiered": ("torch", "--tier-mode", "on", "--cache-size", "2",
                   "--tier-migrate-interval", "0.05"),
        "sharded": ("sharded", "--global-namespaces", "tb",
                    "--global-region", "64"),
    }
    out = {}
    for name, (storage, *extra) in argv.items():
        http_port = H.free_port()
        args = H.port_argv(limits_path, storage, http_port, *extra)
        server = await port_main.start(parse(args))
        try:
            rls = int(args[args.index("--rls-port") + 1])
            blobs = [
                _request("api", {"method": "GET", "user": f"u{i % 5}",
                                 "tenant": "t1"}) for i in range(10)
            ] + [_request("tb", {"user": f"u{i % 3}"}) for i in range(6)]
            # a repeat descriptor, hot enough for the lease broker
            blobs += [_request("hot", {"user": "h"})] * 30
            for _wave in range(3):
                await _should_rate_limit(rls, blobs)
                await asyncio.sleep(0.05)
            pipeline = server.native_pipeline
            if pipeline is not None:
                # No grant or settle between the families' reads.
                pipeline.lease_broker.close()
            async with aiohttp.ClientSession() as session:
                async with session.get(
                        f"http://127.0.0.1:{http_port}/metrics") as resp:
                    text = (await resp.read()).decode()
            out[name] = {
                "families": _families(text),
                "lane": pipeline.lane_stats() if pipeline else None,
                "lease": pipeline.lease_broker.stats() if pipeline else None,
                "tiers": (server.storage.tier_stats()
                          if name == "tiered" else None),
                "launches": (server.storage.launch_stats()
                             if name == "sharded" else None),
            }
        finally:
            await server.stop()
    return out


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    return asyncio.run(_layers(tmp_path_factory.mktemp("layers")))


def test_dashboard_families_are_declared(pair, layers):
    wanted = _dashboard_families()
    assert {"authorized_calls_total", "lease_grants_total",
            "native_lane_rows_total", "tier_resident", "tenant_hits_total",
            "batcher_size", "device_phase_latency_bucket", "device_backed",
            "native_phase_hot_lookup_bucket", "slo_breached_actionable",
            "native_phase_h2i_respond_bucket", "signal_queue_wait_ms",
            "flight_triggers_total", "model_coefficient",
            "capacity_headroom_ratio", "ingress_requests_total"} <= wanted
    for families in [_families(pair["port"]["metrics"])] + [
            layer["families"] for layer in layers.values()]:
        for name in wanted:
            # a sample's name, or its family's
            assert name in families or re.sub(
                r"_(total|bucket|count|sum)$", "", name) in families, name


def _value(families, name, **labels):
    return sum(s.value for s in families[name].samples
               if s.name in (name, name + "_total")
               and all(s.labels.get(k) == v for k, v in labels.items()))


def test_native_lane_rows_equal_the_lane_tally(layers):
    native = layers["native"]
    assert native["lane"]["hits"] > 0
    assert _value(native["families"], "native_lane_rows") == \
        native["lane"]["hits"]
    assert _value(native["families"], "plan_cache_hits") > 0


def test_lease_families_keep_the_conservation_law(layers):
    families = layers["native"]["families"]
    granted = _value(families, "lease_granted_tokens")
    assert granted > 0
    assert granted == (_value(families, "lease_admissions")
                       + _value(families, "lease_returned_tokens")
                       + _value(families, "lease_outstanding_tokens"))


def test_tier_resident_equals_tier_stats(layers):
    tiered = layers["tiered"]
    families = tiered["families"]
    assert _value(families, "tier_resident", tier="device") == \
        tiered["tiers"]["device_resident"]
    assert _value(families, "tier_resident", tier="cold") == \
        tiered["tiers"]["cold"]["resident"] > 0


def test_sharded_launches_equal_the_storage_tally(layers):
    sharded = layers["sharded"]
    tally = sharded["launches"]["sharded_launches"]
    assert sum(tally.values()) > 0
    for variant, count in tally.items():
        assert _value(sharded["families"], "sharded_launches",
                      variant=variant) == count, variant
