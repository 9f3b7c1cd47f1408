"""The native-lane fuzz corpus and its limits, for the port's tests.

A copy of the generator of ``tests/test_native_lane_fuzz.py`` (``_limits``,
``_corpus``): the same seeds give the same blobs. Shared by
``test_torch_native_pipeline.py``, ``test_torch_lease.py`` and
``test_torch_usage.py`` (the port against the JAX package on the CPU) and
``test_torch_gpu.py`` (the port on the card against the port on the CPU);
it imports numpy and the port only, so the card's machine, which has no
JAX, can import it. ``limits`` takes the ``Limit`` class of the package
under test.
"""

import numpy as np

from limitador_tpu_torch.server.proto import rls_pb2

D = "descriptors[0]"
FROZEN_NOW = 1_700_000_000.0
#: namespaces whose counters the corpus touches
NAMESPACES = ("api", "bucket", "mixed", "shared")


def limits(Limit):
    return [
        Limit("api", 3, 60, [f"{D}.m == 'GET'"], [f"{D}.u"], name="per-get"),
        Limit("api", 7, 120, [], [f"{D}.u"], name="per-user"),
        # CEL-gated on a second descriptor key (vectorized equality)
        Limit("api", 5, 60, [f"{D}.tier == 'pro'"], [f"{D}.tier"],
              name="cel-gated"),
        Limit("bucket", 4, 60, [], [f"{D}.u"], name="tb",
              policy="token_bucket"),
        Limit("mixed", 2, 30, [f"{D}.m == 'GET'"], [f"{D}.u"], name="fw"),
        Limit("mixed", 6, 60, [], [f"{D}.u"], name="tb2",
              policy="token_bucket"),
        # empty-variables limit: a single shared counter
        Limit("shared", 10, 60, [], [], name="global"),
        # non-vectorizable predicate: the whole namespace routes exact
        Limit("slowns", 2, 60, [f"{D}.u.startsWith('u')"], [f"{D}.u"],
              name="regexy"),
    ]


def corpus(seed: int, n: int = 400):
    """Deterministic blob corpus: every wire shape the lane must route
    (multi-descriptor requests, unknown fields, long values, CEL-gated
    limits, buckets, empty domains, empty-limits namespaces, hits_addend
    variation, byte-identical repeats)."""
    rng = np.random.default_rng(seed)
    blobs = []
    domains = ["api", "bucket", "mixed", "shared", "nolimits", "",
               "slowns"]
    for _ in range(n):
        roll = rng.integers(0, 10)
        req = rls_pb2.RateLimitRequest(
            domain=str(domains[int(rng.integers(0, len(domains)))])
        )
        if roll >= 8:
            req.hits_addend = int(rng.integers(0, 4))
        n_desc = 2 if roll == 7 else 1  # multi-descriptor -> exact path
        for _d in range(n_desc):
            d = req.descriptors.add()
            e = d.entries.add()
            e.key = "m"
            e.value = "GET" if rng.integers(0, 3) else "POST"
            e = d.entries.add()
            e.key = "u"
            if roll == 6:  # long value
                e.value = "u-" + "x" * int(rng.integers(100, 400))
            else:
                e.value = f"user-{int(rng.integers(0, 12))}"
            if rng.integers(0, 2):
                e = d.entries.add()
                e.key = "tier"
                e.value = str(
                    ["pro", "plus", "free"][int(rng.integers(0, 3))]
                )
        blob = req.SerializeToString()
        if roll == 5:
            # unknown field (tag 15, varint): parsers must skip it
            blob += b"\x78\x2a"
        blobs.append(blob)
        if roll == 9 and blobs:
            # byte-identical repeat of an earlier blob
            blobs.append(blobs[int(rng.integers(0, len(blobs)))])
    return blobs


def columnar_only(blobs):
    """The blobs the columnar lanes answer themselves: one descriptor,
    a namespace without non-vectorizable limits."""
    out = []
    for blob in blobs:
        req = rls_pb2.RateLimitRequest.FromString(blob)
        if req.domain != "slowns" and len(req.descriptors) == 1:
            out.append(blob)
    return out


def decide_cached(pipeline, batch):
    """One batch through the begin/finish split with the plan cache on:
    the C hot lane on a hot pipeline, the pure-Python cached lane on a
    lane-off one. Exact-path rows stay None; failed allocations come back
    as the string "STORAGE_ERROR". Works for both packages' pipelines."""
    with pipeline._native_lock:
        begun = pipeline._begin_batch_locked(list(batch), use_cache=True)
    results, pendings = begun[0], begun[2]
    for pending in pendings:
        pipeline._finish_namespace(pending, results)
    return [
        "STORAGE_ERROR" if r is pipeline.STORAGE_ERROR else r
        for r in results
    ]
