"""HTTP admin and check API.

Counterpart of ``limitador_tpu/server/http_api.py`` (the reference's
http_api/server.rs) over aiohttp:

    GET  /status            liveness + limits-config version/error counters
    GET  /api/spec          OpenAPI document of this API
    GET  /metrics           Prometheus exposition (text 0.0.4, or
                            OpenMetrics with --metrics-exemplars on)
    GET  /limits/{ns}       limits of a namespace (DTO: request_types.rs:19-27)
    GET  /counters/{ns}     live counters with remaining/expires_in_seconds
    POST /check             200/429, read-only (server.rs:127-157)
    POST /report            200, update-only (server.rs:159-183)
    POST /check_and_report  200/429 + optional draft-03 headers
                            (server.rs:185-260); with an admission
                            controller a shed answers 503, or 429 under
                            --shed-response overlimit, before the request
                            takes a batch slot

and the debug endpoints of the planes the port has:

    GET  /debug/stats       batcher queue depths, per-shard counter-table
                            occupancy, flush-reason tallies, the slowest-N
                            decision flight recorder, decision-plan
                            caches, the native hot lane, leases, the
                            native telemetry plane, the SLO watchdog,
                            device_backed, the usage observatory, the
                            tiers, the admission plane, the profiler
                            state and the kernel/host-lane build state
    GET  /debug/profile     torch.profiler capture status
    POST /debug/profile     {"action": "start"|"stop", "trace_dir"?: str}
                            starts or stops an on-demand torch.profiler
                            capture (409 when already capturing / idle);
                            stop exports a Chrome trace into the
                            directory
    GET  /debug/top         tenant usage observatory: true top-K hottest
                            counters with namespace/limit/key attribution
                            and utilization (?k=N trims)
    GET  /debug/tiering     tiered-storage state (404 with --tier-mode off)
    GET  /debug/signals     the control-signal bus: the current
                            ControlSignals snapshot, its flattened
                            observation vector and the ring timeline
                            (404 without the usage observatory)
    GET  /debug/capacity    the serving-model fit: coefficients, R², drift
                            state, SLO headroom and what-if forecasts
                            (?batch=, ?lease_share=, ?procs=; 404 with
                            --model-fit off or on memory storage)
    GET  /debug/flight      the flight recorder's incident bundles, newest
                            first (?name= serves one bundle; 404 with
                            --flight off or an unknown bundle)
    POST /debug/flight/trigger
                            {"note"?: str, "profile"?: bool}: a manual
                            trigger freezes the exemplar rings and
                            persists a bundle (404 with --flight off)

POST bodies are CheckAndReportInfo: {"namespace", "values": {str: str},
"delta", "response_headers": optional "DRAFT_VERSION_03"}
(request_types.rs:10-16).

The debug routes of planes not ported yet stay unregistered (404):
``/debug/pod*`` and ``/debug/events`` (ROADMAP Queue A item 7).
"""

from __future__ import annotations

import asyncio
import json
import math
from typing import Optional

from aiohttp import web

from ..core.cel import Context
from ..core.limit import Limit
from ..native.build import build_status as host_lane_build_status
from ..observability.device_plane import (
    ProfilerStateError,
    TorchProfiler,
    collect_debug_stats,
)
from ..observability.metrics import PrometheusMetrics
from ..ops.build import build_status as kernel_build_status
from ..storage.base import StorageError
from .middleware import http_request_id_middleware
from .rls import RATE_LIMIT_HEADERS_DRAFT03

__all__ = [
    "make_http_app",
    "run_http_server",
    "DEBUG_STATS_SECTIONS",
    "DEBUG_SOURCE_SECTIONS",
]

#: /debug/stats sections sourced from debug_sources by named callable:
#: (section key, source attribute)
DEBUG_SOURCE_SECTIONS = (
    ("native_telemetry", "native_telemetry"),
    ("slo", "slo_status"),
    ("device_backed", "device_backed"),
    ("tenant_usage", "tenant_usage"),
    ("signals", "signals_debug"),
    ("capacity", "capacity_debug"),
    ("flight", "flight_debug"),
    ("tiering", "tiering_debug"),
    ("authority", "authority_stats"),
)

#: every /debug/stats section this module adds on top of
#: collect_debug_stats' base payload
DEBUG_STATS_SECTIONS = (
    "profiler",
    "native_build",
    "native_hot_lane",
    "lease",
    "native_telemetry",
    "slo",
    "device_backed",
    "tenant_usage",
    "signals",
    "capacity",
    "flight",
    "tiering",
    "authority",
)


def _limit_dto(limit: Limit) -> dict:
    d = {
        "id": limit.id,
        "namespace": str(limit.namespace),
        "max_value": limit.max_value,
        "seconds": limit.seconds,
        "name": limit.name,
        "conditions": sorted(c.source for c in limit.conditions),
        "variables": sorted(v.source for v in limit.variables),
    }
    if limit.policy != "fixed_window":
        # The reference's DTOs have no policy field; it is emitted only
        # for the token-bucket extension.
        d["policy"] = limit.policy
    return d


def _counter_dto(counter) -> dict:
    return {
        "limit": _limit_dto(counter.limit),
        "set_variables": dict(counter.set_variables),
        "remaining": counter.remaining,
        "expires_in_seconds": (
            int(counter.expires_in) if counter.expires_in is not None else None
        ),
    }


def _openapi_spec() -> dict:
    """OpenAPI 3 document mirroring the reference's paperclip spec surface
    (request_types.rs:10-97, http_api/server.rs:77-260)."""
    limit_schema = {
        "type": "object",
        "required": ["namespace", "max_value", "seconds"],
        "properties": {
            "id": {"type": "string", "nullable": True},
            "namespace": {"type": "string"},
            "max_value": {"type": "integer", "format": "int64"},
            "seconds": {"type": "integer", "format": "int64"},
            "name": {"type": "string", "nullable": True},
            "conditions": {"type": "array", "items": {"type": "string"}},
            "variables": {"type": "array", "items": {"type": "string"}},
        },
    }
    counter_schema = {
        "type": "object",
        "properties": {
            "limit": {"$ref": "#/components/schemas/Limit"},
            "set_variables": {
                "type": "object",
                "additionalProperties": {"type": "string"},
            },
            "remaining": {
                "type": "integer", "format": "int64", "nullable": True,
            },
            "expires_in_seconds": {
                "type": "number", "nullable": True,
            },
        },
    }
    info_schema = {
        "type": "object",
        "required": ["namespace", "values"],
        "properties": {
            "namespace": {"type": "string"},
            "values": {
                "type": "object",
                "additionalProperties": {"type": "string"},
            },
            "delta": {"type": "integer", "format": "int64"},
            "response_headers": {
                "type": "string",
                "nullable": True,
                "enum": [None, "none", "draft_version_03"],
            },
        },
    }
    check_responses = {
        "200": {"description": "not rate limited"},
        "429": {"description": "rate limited"},
        "500": {"description": "storage error"},
    }
    ns_param = {
        "name": "namespace",
        "in": "path",
        "required": True,
        "schema": {"type": "string"},
    }
    info_body = {
        "required": True,
        "content": {
            "application/json": {
                "schema": {"$ref": "#/components/schemas/CheckAndReportInfo"}
            }
        },
    }
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "Limitador server endpoint",
            "version": "1.0.0",
        },
        "paths": {
            "/status": {
                "get": {
                    "summary": "Health / config status",
                    "responses": {"200": {"description": "running"}},
                }
            },
            "/metrics": {
                "get": {
                    "summary": "Prometheus metrics",
                    "responses": {
                        "200": {"description": "prometheus exposition"}
                    },
                }
            },
            "/debug/stats": {
                "get": {
                    "summary": "Device-plane debug state (queues, shard "
                               "occupancy, plan-cache stats, flight "
                               "recorder)",
                    "responses": {
                        "200": {"description": "debug stats"}
                    },
                }
            },
            "/debug/profile": {
                "get": {
                    "summary": "torch.profiler capture status",
                    "responses": {"200": {"description": "profiler status"}},
                },
                "post": {
                    "summary": "Start/stop an on-demand torch.profiler "
                               "capture",
                    "requestBody": {
                        "required": True,
                        "content": {
                            "application/json": {
                                "schema": {
                                    "$ref": "#/components/schemas"
                                            "/ProfileAction"
                                }
                            }
                        },
                    },
                    "responses": {
                        "200": {"description": "profiler toggled"},
                        "409": {"description": "capture already active / "
                                               "not active"},
                    },
                },
            },
            "/debug/top": {
                "get": {
                    "summary": "Tenant usage observatory: top-K hottest "
                               "counters with namespace/limit/key "
                               "attribution and utilization",
                    "responses": {
                        "200": {"description": "top counters"},
                        "404": {"description": "observatory not running"},
                    },
                }
            },
            "/debug/signals": {
                "get": {
                    "summary": "Unified control-signal snapshot (queue "
                               "wait, batch fill, breaker, sheds, lease "
                               "outstanding, native p99s, SLO burn, "
                               "calibration) + ring timeline",
                    "responses": {
                        "200": {"description": "control signals"},
                        "404": {"description": "signal bus not running"},
                    },
                }
            },
            "/debug/capacity": {
                "get": {
                    "summary": "Online serving-model observatory: "
                               "fitted coefficients, R², drift state, "
                               "SLO headroom and what-if forecasts "
                               "(?batch=, ?lease_share=, ?procs=)",
                    "responses": {
                        "200": {"description": "capacity forecast"},
                        "404": {"description": "model fit not running"},
                    },
                }
            },
            "/debug/flight": {
                "get": {
                    "summary": "Flight-recorder incident bundles: list "
                               "the retention-capped spool, or serve "
                               "one self-contained bundle verbatim "
                               "(?name=)",
                    "responses": {
                        "200": {"description": "bundle list or bundle"},
                        "404": {"description": "recorder off / unknown "
                                               "bundle"},
                    },
                }
            },
            "/debug/flight/trigger": {
                "post": {
                    "summary": "Fire a manual flight-recorder trigger: "
                               "freeze the exemplar rings, collect pod "
                               "peers' rings for the same window, "
                               "persist an incident bundle",
                    "requestBody": {
                        "required": False,
                        "content": {
                            "application/json": {
                                "schema": {
                                    "type": "object",
                                    "properties": {
                                        "note": {
                                            "type": "string",
                                            "nullable": True,
                                        },
                                        "profile": {
                                            "type": "boolean",
                                            "default": False,
                                        },
                                    },
                                }
                            }
                        },
                    },
                    "responses": {
                        "200": {"description": "bundle persisted"},
                        "404": {"description": "recorder off"},
                    },
                }
            },
            "/limits/{namespace}": {
                "get": {
                    "summary": "Limits configured for a namespace",
                    "parameters": [ns_param],
                    "responses": {
                        "200": {
                            "description": "limits",
                            "content": {
                                "application/json": {
                                    "schema": {
                                        "type": "array",
                                        "items": {
                                            "$ref": "#/components/schemas/Limit"
                                        },
                                    }
                                }
                            },
                        }
                    },
                }
            },
            "/counters/{namespace}": {
                "get": {
                    "summary": "Live counters of a namespace",
                    "parameters": [ns_param],
                    "responses": {
                        "200": {
                            "description": "counters",
                            "content": {
                                "application/json": {
                                    "schema": {
                                        "type": "array",
                                        "items": {
                                            "$ref": "#/components/schemas/Counter"
                                        },
                                    }
                                }
                            },
                        }
                    },
                }
            },
            "/check": {
                "post": {
                    "summary": "Check only (no counter update)",
                    "requestBody": info_body,
                    "responses": check_responses,
                }
            },
            "/report": {
                "post": {
                    "summary": "Update counters only (no check)",
                    "requestBody": info_body,
                    "responses": {
                        "200": {"description": "counters updated"},
                        "500": {"description": "storage error"},
                    },
                }
            },
            "/check_and_report": {
                "post": {
                    "summary": "Check and update atomically",
                    "requestBody": info_body,
                    "responses": check_responses,
                }
            },
        },
        "components": {
            "schemas": {
                "Limit": limit_schema,
                "Counter": counter_schema,
                "CheckAndReportInfo": info_schema,
                "ProfileAction": {
                    "type": "object",
                    "required": ["action"],
                    "properties": {
                        "action": {
                            "type": "string", "enum": ["start", "stop"],
                        },
                        "trace_dir": {"type": "string", "nullable": True},
                    },
                },
            }
        },
    }

class _Api:
    def __init__(
        self,
        limiter,
        metrics: Optional[PrometheusMetrics],
        status,
        debug_sources=None,
        profiler: Optional[TorchProfiler] = None,
        admission=None,
    ):
        self.limiter = limiter
        self.metrics = metrics
        self.status = status or {}
        #: AdmissionController gating POST /check_and_report; None = no
        #: admission plane
        self.admission = admission
        # Objects walked for /debug/stats; the limiter is always included
        # (it reaches the batchers and the device tables).
        self.debug_sources = [limiter] + list(debug_sources or ())
        self.profiler = profiler or TorchProfiler()

    async def _call(self, thunk):
        """Invoke a limiter call, awaiting it where the limiter is async.
        The reference's HTTP handlers carry non-aggregate span names, so
        only the gRPC should_rate_limit aggregate feeds
        datastore_latency."""
        value = thunk()
        if asyncio.iscoroutine(value):
            return await value
        return value

    # -- handlers ----------------------------------------------------------

    async def get_status(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "ok", **self.status})

    async def get_spec(self, request: web.Request) -> web.Response:
        """OpenAPI document for the admin/check API (the reference serves
        a generated spec at /api/spec)."""
        return web.json_response(_openapi_spec())

    async def get_metrics(self, request: web.Request) -> web.Response:
        if self.metrics is None:
            return web.Response(body=b"", content_type="text/plain")
        body = self.metrics.render()
        # The OpenMetrics exposition (exemplars on) carries its own
        # content type; headers= keeps the full parameterized value.
        return web.Response(
            body=body,
            headers={"Content-Type": self.metrics.content_type},
        )

    async def get_debug_stats(self, request: web.Request) -> web.Response:
        """Device-plane state without a debugger: queue depths, per-shard
        table occupancy, flush reasons, the flight recorder, decision-plan
        cache stats, the native hot lane, leases, the native telemetry
        plane, the SLO watchdog, the usage observatory, the tiers, the
        shared authority's RPCs, the profiler and the build state of the
        kernels and the host lane."""
        stats = collect_debug_stats(*self.debug_sources)
        stats["profiler"] = self.profiler.status()
        stats["native_build"] = {
            **host_lane_build_status(), **kernel_build_status(),
        }
        for key, attr in (("native_hot_lane", "lane_stats"),
                          ("lease", "lease_stats")):
            fn = self._debug_source_fn(attr)
            section = fn() if fn is not None else None
            if section:
                stats[key] = section
        for key, attr in DEBUG_SOURCE_SECTIONS:
            fn = self._debug_source_fn(attr)
            if fn is not None:
                stats[key] = fn()
        return web.json_response(stats)

    def _debug_source_fn(self, attr: str):
        """First debug source exposing a callable ``attr``."""
        for source in self.debug_sources:
            fn = getattr(source, attr, None)
            if callable(fn):
                return fn
        return None

    async def get_debug_profile(self, request: web.Request) -> web.Response:
        return web.json_response(self.profiler.status())

    async def post_debug_profile(self, request: web.Request) -> web.Response:
        try:
            data = await request.json()
            action = data["action"]
            trace_dir = data.get("trace_dir")
            if action not in ("start", "stop"):
                raise ValueError(f"unknown action {action!r}")
            if trace_dir is not None and not isinstance(trace_dir, str):
                raise ValueError("trace_dir must be a string")
        except (KeyError, ValueError, TypeError) as exc:
            return web.json_response(
                {"error": f"bad request: {exc}"}, status=400
            )
        # On the loop's thread: the profiler must stop on the thread that
        # started it (the export blocks the loop for its duration).
        try:
            target = (self.profiler.stop() if action == "stop"
                      else self.profiler.start(trace_dir))
        except ProfilerStateError as exc:
            return web.json_response({"error": str(exc)}, status=409)
        except OSError as exc:
            return web.json_response({"error": str(exc)}, status=500)
        return web.json_response({
            "status": "stopped" if action == "stop" else "started",
            "trace_dir": target,
        })

    async def get_debug_top(self, request: web.Request) -> web.Response:
        """Tenant usage observatory: the true top-K hottest counters with
        namespace/limit/key attribution and utilization (drains the
        device accumulator first, so nothing is in flight)."""
        fn = self._debug_source_fn("top_counters")
        if fn is None:
            return web.json_response(
                {"error": "tenant usage observatory not running (torch "
                          "and sharded storage with --usage-topk > 0)"},
                status=404,
            )
        try:
            k = int(request.query["k"]) if "k" in request.query else None
        except ValueError:
            return web.json_response(
                {"error": "k must be an integer"}, status=400
            )
        # The drain runs a kernel and waits on the card: off the loop.
        out = await asyncio.get_running_loop().run_in_executor(None, fn, k)
        return web.json_response(out)

    async def get_debug_tiering(self, request: web.Request) -> web.Response:
        """Tiered-storage state: per-tier resident counts, the
        TierManager's migration/backlog accounting, cold-decide latency
        and the per-row costs the last round priced with."""
        fn = self._debug_source_fn("tiering_debug")
        if fn is None:
            return web.json_response(
                {"error": "tiered storage not enabled (--tier-mode on)"},
                status=404,
            )
        return web.json_response(fn())

    async def get_debug_signals(self, request: web.Request) -> web.Response:
        """Unified control-signal bus: the current ControlSignals
        snapshot, its flattened observation vector, and the ring
        timeline."""
        fn = self._debug_source_fn("signals_debug")
        if fn is None:
            return web.json_response(
                {"error": "signal bus not running"}, status=404
            )
        return web.json_response(fn())

    async def get_debug_capacity(
        self, request: web.Request
    ) -> web.Response:
        """The serving-model fit: coefficients, R², drift state, SLO
        headroom and what-if forecasts. ``?batch=`` overrides the batch
        size, ``?lease_share=`` the lease coverage, ``?procs=`` the host
        count."""
        fn = self._debug_source_fn("capacity_debug")
        if fn is None:
            return web.json_response(
                {"error": "serving-model fit not running "
                          "(--model-fit off or host-only storage)"},
                status=404,
            )
        kwargs: dict = {}
        try:
            if "batch" in request.query:
                kwargs["batch"] = int(request.query["batch"])
                if kwargs["batch"] < 1:
                    raise ValueError
            if "lease_share" in request.query:
                kwargs["lease_share"] = float(
                    request.query["lease_share"]
                )
                # float() happily parses nan/inf, which would ride the
                # clamp into the features and serialize as bare NaN —
                # invalid JSON for any strict client
                if not math.isfinite(kwargs["lease_share"]):
                    raise ValueError
            if "procs" in request.query:
                kwargs["procs"] = int(request.query["procs"])
                if kwargs["procs"] < 1:
                    raise ValueError
        except ValueError:
            return web.json_response(
                {"error": "batch and procs must be positive integers, "
                          "lease_share a finite float"},
                status=400,
            )
        return web.json_response(fn(**kwargs))

    async def get_debug_flight(self, request: web.Request) -> web.Response:
        """The flight-recorder bundle spool: the list of persisted
        incident bundles (newest first), or — with ``?name=`` — one
        self-contained bundle verbatim for offline autopsy."""
        list_fn = self._debug_source_fn("flight_bundles")
        if list_fn is None:
            return web.json_response(
                {"error": "flight recorder not running (--flight off)"},
                status=404,
            )
        name = request.query.get("name")
        if name is None:
            return web.json_response({"bundles": list_fn()})
        read_fn = self._debug_source_fn("flight_bundle")
        bundle = read_fn(name) if read_fn is not None else None
        if bundle is None:
            return web.json_response(
                {"error": f"unknown bundle {name!r}"}, status=404
            )
        return web.json_response(bundle)

    async def post_debug_flight_trigger(
        self, request: web.Request
    ) -> web.Response:
        """Fire a manual flight-recorder trigger (``{"note"?: str,
        "profile"?: bool}``): freezes the exemplar rings, asks pod
        peers for their rings over the same window (none until the pod
        is ported), and persists a self-contained incident bundle. Runs
        off the loop, on an executor thread, which also starts and stops
        a requested ``torch.profiler`` capture."""
        fn = self._debug_source_fn("flight_trigger")
        if fn is None:
            return web.json_response(
                {"error": "flight recorder not running (--flight off)"},
                status=404,
            )
        note, profile = None, False
        if request.can_read_body:
            try:
                data = await request.json()
                note = data.get("note")
                profile = bool(data.get("profile", False))
                if note is not None and not isinstance(note, str):
                    raise ValueError("note must be a string")
            except ValueError as exc:
                return web.json_response(
                    {"error": f"bad request: {exc}"}, status=400
                )
        loop = asyncio.get_running_loop()
        try:
            out = await loop.run_in_executor(
                None, lambda: fn(note, profile)
            )
        except Exception as exc:  # diagnostics must never 500 opaquely
            return web.json_response({"error": str(exc)}, status=500)
        return web.json_response(out)

    async def get_limits(self, request: web.Request) -> web.Response:
        ns = request.match_info["namespace"]
        limits = self.limiter.get_limits(ns)
        return web.json_response([_limit_dto(l) for l in sorted(limits)])

    async def get_counters(self, request: web.Request) -> web.Response:
        ns = request.match_info["namespace"]
        try:
            counters = await self._call(lambda: self.limiter.get_counters(ns))
        except StorageError as exc:
            return web.json_response({"error": str(exc)}, status=500)
        dtos = sorted(
            (_counter_dto(c) for c in counters),
            key=lambda d: json.dumps(d, sort_keys=True),
        )
        return web.json_response(dtos)

    @staticmethod
    def _parse_info(data) -> tuple:
        namespace = data["namespace"]
        values = data.get("values") or {}
        delta = int(data.get("delta", 1))
        if delta < 0:
            # The reference's DTO declares delta: u64 (request_types.rs:14);
            # a negative delta would decrement counters and defeat limits.
            raise ValueError("delta must be >= 0")
        response_headers = data.get("response_headers")
        ctx = Context()
        ctx.list_binding("descriptors", [dict(values)])
        return namespace, ctx, delta, response_headers

    async def post_check(self, request: web.Request) -> web.Response:
        try:
            data = await request.json()
            namespace, ctx, delta, _ = self._parse_info(data)
        except (KeyError, ValueError, TypeError) as exc:
            return web.json_response({"error": f"bad request: {exc}"}, status=400)
        try:
            result = await self._call(
                lambda: self.limiter.is_rate_limited(namespace, ctx, delta)
            )
        except StorageError as exc:
            return web.json_response({"error": str(exc)}, status=500)
        if result.limited:
            return web.Response(status=429)
        return web.Response(status=200)

    async def post_report(self, request: web.Request) -> web.Response:
        try:
            data = await request.json()
            namespace, ctx, delta, _ = self._parse_info(data)
        except (KeyError, ValueError, TypeError) as exc:
            return web.json_response({"error": f"bad request: {exc}"}, status=400)
        try:
            await self._call(
                lambda: self.limiter.update_counters(namespace, ctx, delta)
            )
        except StorageError as exc:
            return web.json_response({"error": str(exc)}, status=500)
        return web.Response(status=200)

    async def post_check_and_report(self, request: web.Request) -> web.Response:
        try:
            data = await request.json()
            namespace, ctx, delta, response_headers = self._parse_info(data)
        except (KeyError, ValueError, TypeError) as exc:
            return web.json_response({"error": f"bad request: {exc}"}, status=400)
        want_headers = response_headers == RATE_LIMIT_HEADERS_DRAFT03
        ticket = None
        if self.admission is not None:
            from ..admission.controller import AdmissionShed

            try:
                # The HTTP surface carries no deadline; overload and
                # priority shedding still apply (429 for the over-limit
                # semantics, 503 for unavailable: a shed is an explicit
                # backpressure signal, not a storage failure's 500).
                ticket = self.admission.admit(
                    namespace, data.get("values") or {}
                )
            except AdmissionShed as shed:
                if shed.overlimit:
                    return web.Response(status=429)
                return web.json_response({"error": str(shed)}, status=503)
        try:
            result = await self._call(
                lambda: self.limiter.check_rate_limited_and_update(
                    namespace, ctx, delta, want_headers
                )
            )
        except StorageError as exc:
            return web.json_response({"error": str(exc)}, status=500)
        finally:
            if ticket is not None:
                ticket.release()
        headers = result.response_header() if want_headers else {}
        metrics = self.metrics
        if metrics:
            extra = metrics.custom_labels(ctx)
        if result.limited:
            if metrics:
                metrics.incr_limited_calls(
                    namespace, result.limit_name, labels=extra
                )
            return web.Response(status=429, headers=headers)
        if metrics:
            metrics.incr_authorized_calls(namespace, labels=extra)
            metrics.incr_authorized_hits(namespace, delta, labels=extra)
        return web.Response(status=200, headers=headers)


def make_http_app(
    limiter,
    metrics: Optional[PrometheusMetrics] = None,
    status: Optional[dict] = None,
    debug_sources=None,
    profiler: Optional[TorchProfiler] = None,
    admission=None,
) -> web.Application:
    api = _Api(limiter, metrics, status, debug_sources, profiler, admission)
    app = web.Application(middlewares=[http_request_id_middleware])
    app.router.add_get("/status", api.get_status)
    app.router.add_get("/api/spec", api.get_spec)
    app.router.add_get("/metrics", api.get_metrics)
    app.router.add_get("/debug/stats", api.get_debug_stats)
    app.router.add_get("/debug/top", api.get_debug_top)
    app.router.add_get("/debug/tiering", api.get_debug_tiering)
    app.router.add_get("/debug/signals", api.get_debug_signals)
    app.router.add_get("/debug/capacity", api.get_debug_capacity)
    app.router.add_get("/debug/flight", api.get_debug_flight)
    app.router.add_post("/debug/flight/trigger",
                        api.post_debug_flight_trigger)
    app.router.add_get("/debug/profile", api.get_debug_profile)
    app.router.add_post("/debug/profile", api.post_debug_profile)
    app.router.add_get("/limits/{namespace}", api.get_limits)
    app.router.add_get("/counters/{namespace}", api.get_counters)
    app.router.add_post("/check", api.post_check)
    app.router.add_post("/report", api.post_report)
    app.router.add_post("/check_and_report", api.post_check_and_report)
    return app


async def run_http_server(
    limiter,
    host: str = "0.0.0.0",
    port: int = 8080,
    metrics: Optional[PrometheusMetrics] = None,
    status: Optional[dict] = None,
    debug_sources=None,
    profiler: Optional[TorchProfiler] = None,
    admission=None,
) -> web.AppRunner:
    """Start the HTTP server (returns the runner; caller owns shutdown).
    A port that cannot be bound raises OSError after the runner is
    cleaned up."""
    app = make_http_app(limiter, metrics, status, debug_sources, profiler,
                        admission)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    try:
        await site.start()
    except BaseException:
        await runner.cleanup()
        raise
    return runner
