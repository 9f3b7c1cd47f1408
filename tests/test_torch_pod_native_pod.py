"""Real 2-process pods of port servers serving ``--pipeline native``.

Each pod is two server processes of ``tests/torch_pod_worker.py`` on the
CPU, formed over a TCPStore, with a stepped clock. A module fixture runs
three pods one after the other, once for the module, and the tests read
their reports:

- ``native``: ``--pipeline native`` (the hot lane on): ShouldRateLimit
  calls over grpc.aio into the native pipeline, whose C hot lane splits
  each flush by owner and bulk-forwards the foreign rows;
- ``ingress``: the same with ``--native-ingress`` (the pump's begin and
  its pod branch);
- ``lane-off``: ``--native-hot-lane off`` in a pod, which warns and
  serves through the routed compiled pipeline, as the JAX server does.

Each pod's merged answers and the union of both hosts' counters equal a
single-process 2-row ``TorchShardedStorage`` fed the same drive
(``drive_oracle``), exactly.
"""

import pytest

from limitador_tpu_torch import routing as prouting

from . import torch_pod_worker as W

MODES = ("native", "ingress", "lane-off")


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """Every mode's two reports, one pod at a time."""
    return {mode: W.spawn_pod(tmp_path_factory.mktemp(mode), "torch",
                              mode=mode, timeout=180)
            for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_pod_answers_equal_the_single_process_table(pods, mode):
    want, want_counters = W.drive_oracle(native=True)
    merged, counters, _routed = W.merge(pods[mode])
    assert merged == want
    assert counters == want_counters
    assert any(d["limited"] for d in merged.values())
    for result in pods[mode]:
        assert result["lane"]["pod_peer_errors"] == 0
        http = result["http"]
        assert {p: h["status"] for p, h in http.items()} == dict.fromkeys(
            http, 200)
        # nothing of the JAX package in a member
        assert not [m for m in result["modules"]
                    if m.split(".")[0] in ("jax", "jaxlib",
                                           "limitador_tpu")]


@pytest.mark.parametrize("mode", ["native", "ingress"])
def test_native_pod_splits_by_owner_and_bulk_forwards(pods, mode):
    results = pods[mode]
    foreign = sum(r["pod_stats"]["pod_hot_foreign_rows"] for r in results)
    local = sum(r["pod_stats"]["pod_hot_local_rows"] for r in results)
    batches = sum(r["lane"]["pod_bulk_forward_batches"] for r in results)
    rows = sum(r["lane"]["pod_bulk_forward_rows"] for r in results)
    served = sum(r["lane"]["pod_bulk_served_rows"] for r in results)
    assert foreign > 0 and local > 0
    assert 0 < batches <= rows == served
    # the frontend's router never decided: every step rode the lanes
    assert sum(r["router"]["pod_routed_local"] for r in results) == 0
    for result in results:
        assert result["native_pipeline"]
        assert result["native_ingress"] == (mode == "ingress")
        assert result["warnings"] == []
        routing = result["http"]["/debug/pod/routing"]["body"]
        assert routing["native_hot_lane"] is True
        assert routing["pinned_namespaces"] == {
            "multi": prouting.PodRouter.pin_host("multi", 2)}
        text = result["http"]["/metrics"]["body"]
        for family in ("pod_hot_local_rows", "pod_hot_foreign_rows",
                       "pod_bulk_forward_batches", "pod_bulk_forward_rows",
                       "pod_bulk_served_rows"):
            value = (result["pod_stats"].get(family)
                     if family.startswith("pod_hot")
                     else result["lane"][family])
            assert f"{family}_total {float(value)}" in text, family


def test_lane_off_pod_warns_and_serves_routed(pods):
    results = pods["lane-off"]
    _merged, _counters, routed = W.merge(results)
    assert routed["pod_routed_forwarded"] > 0
    assert routed["pod_routed_pinned"] > 0
    for result in results:
        assert not result["native_pipeline"]
        assert result["pod_stats"] == {}
        assert result["warnings"] == [
            "pod mode: --native-hot-lane off leaves the native pipeline "
            "without the shard-aware lane; serving through the routed "
            "compiled pipeline"]
        routing = result["http"]["/debug/pod/routing"]["body"]
        assert routing["native_hot_lane"] is False
        assert result["lane"]["pod_bulk_forward_batches"] == 0
