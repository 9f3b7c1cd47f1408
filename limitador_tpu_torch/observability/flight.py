"""Process flight recorder: always-on decision exemplars, triggered
incident bundles and their spool.

Counterpart of ``limitador_tpu/observability/flight.py``:

* :class:`FlightRecorder`: lock-light rings. ``tap`` runs on the
  decision path: a 1-in-``sample_stride`` counter admits exemplars into
  a bounded ring, and a worst-K min-heap per lane
  (:data:`FLIGHT_LANES`) keeps the slowest decisions whatever the
  sample rate. The common path (not sampled, below the lane's tail
  floor) is a counter bump and two reads, with no lock. Exemplars carry
  the device plane's stage breakdown (``phases_ms``), lane, key hash,
  namespace, request id, trace id and topology epoch; ``note_signals``
  rings ``ControlSignals.vector()`` snapshots beside them.
* :class:`TriggerEngine`: a polling thread over the signals the planes
  already compute: SLO-burn threshold crossings, the drift flip, a
  ``device_backed`` falling edge, the pod's ``breaker_open``,
  ``resize_abort`` and ``controller_actuation`` events, and manual
  ``POST /debug/flight/trigger``. A fire freezes the rings (recording
  goes on), optionally wraps a bounded ``torch.profiler`` capture
  through ``device_plane.TorchProfiler`` (the JAX engine's
  ``JaxProfiler``), asks pod peers for their rings over the same window
  and persists one self-contained JSON bundle into the retention-capped
  :class:`BundleSpool`.

``GET /debug/flight`` lists or serves bundles; the ``flight``
``/debug/stats`` section and the ``flight_*`` families summarize the
plane. The whole :data:`FLIGHT_LANES` and :data:`TRIGGER_REASONS`
tuples are kept (bounded label sets). The port taps ``lean`` (the
recorder's batched decisions), ``native_hot`` (the host lane's slow-row
exemplars) and ``cold_tier`` (tiered cold decides), and can fire
``manual``, ``slo_burn``, ``drift`` and ``device_probe``; the pod lanes
and triggers, and the peer collection (``lane``), wait for the pod and
the capacity controller (ROADMAP Queue A items 7 and 8): ``lane=None``
collects nothing, as on a JAX server without a pod. The admission
breaker fires no trigger of its own: ``breaker_open`` counts the pod's
events, in the JAX engine too.
"""

from __future__ import annotations

import heapq
import itertools
import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = [
    "FLIGHT_LANES",
    "TRIGGER_REASONS",
    "FLIGHT_BUNDLE_SCHEMA",
    "FlightRecorder",
    "BundleSpool",
    "TriggerEngine",
    "METRIC_FAMILIES",
]

#: Prometheus families owned by this module (declared in metrics.py)
METRIC_FAMILIES = (
    "flight_taps",
    "flight_exemplars",
    "flight_tail_retained",
    "flight_triggers",
    "flight_bundles",
    "flight_spool_bytes",
    "flight_peer_rings",
)

#: the serving lanes one decision can ride, in tap order: the
#: zero-Python native hot lane, the lean batched device path, a pod
#: forward (either side of the hop), the degraded-owner stand-in, a
#: cold-tier decide (exact host cell for a non-resident key), and a
#: just-promoted joiner's first answered decision (the
#: time-to-first-decision exemplar an incident bundle shows next to
#: the join_begin/join_end timeline).
FLIGHT_LANES = (
    "native_hot", "lean", "pod_forward", "degraded", "cold_tier", "join",
)

#: the closed trigger-reason set (bounded Prometheus label values)
TRIGGER_REASONS = (
    "manual",
    "slo_burn",
    "breaker_open",
    "resize_abort",
    "drift",
    "device_probe",
    # capacity controller: a membership actuation or
    # shed-floor jump emitted a controller_actuation pod event —
    # every autoscale decision leaves an autopsy bundle
    "controller_actuation",
)

#: incident bundle schema version (bundles are self-contained JSON;
#: consumers key on this, not on file layout)
FLIGHT_BUNDLE_SCHEMA = 1

#: default 1-in-N exemplar sampling stride (the server's --flight-sample)
DEFAULT_SAMPLE_STRIDE = 64


def _key_hash(key, namespace) -> int:
    """Stable 32-bit hash of the decision's counter key (falls back to
    the namespace): correlates one tenant key across hosts without
    shipping the raw key material into bundles."""
    basis = key if key is not None else namespace
    if basis is None:
        return 0
    return zlib.crc32(str(basis).encode("utf-8", "replace")) & 0xFFFFFFFF


class FlightRecorder:
    """Lock-light always-on decision recorder (see module docstring).

    ``tap`` is the hot-path entry point; everything else runs on
    trigger/debug/render threads. The single internal lock is only
    taken when an observation is sampled in or beats its lane's
    worst-K floor."""

    def __init__(
        self,
        capacity: int = 512,
        worst_k: int = 16,
        sample_stride: int = DEFAULT_SAMPLE_STRIDE,
        signal_capacity: int = 256,
        host_id: int = 0,
        clock=time.time,
    ):
        self.host_id = int(host_id)
        self.capacity = max(int(capacity), 1)
        self.worst_k = max(int(worst_k), 1)
        self.sample_stride = max(int(sample_stride), 1)
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._signals: deque = deque(maxlen=max(int(signal_capacity), 1))
        # per-lane worst-K min-heaps of (duration_s, seq, entry); the
        # floor is read WITHOUT the lock on the hot path (a stale read
        # only costs one extra lock round, never a lost tail entry)
        self._tail: Dict[str, list] = {lane: [] for lane in FLIGHT_LANES}
        self._tail_floor: Dict[str, float] = {
            lane: -1.0 for lane in FLIGHT_LANES
        }
        self._tapseq = itertools.count()
        self._heapseq = itertools.count()
        # mirror of the tap sequence (itertools.count consumes on
        # read); a plain store is atomic under the GIL
        self._taps_seen = 0
        self.exemplars = 0
        self.tail_retained = 0
        self.signal_snapshots = 0
        #: callable() -> int: the pod topology epoch stamped into
        #: sampled exemplars (PodFrontend.attach_flight_recorder)
        self.epoch_provider: Optional[Callable[[], int]] = None
        #: callable() -> Optional[str]: the active trace id, resolved
        #: only AFTER the sampling decision (tracing.current_trace_id)
        self.trace_provider: Optional[Callable[[], Optional[str]]] = None
        #: the TriggerEngine, once armed (poll/debug read-through)
        self.engine = None
        # render-time baselines: cumulative counts -> Prometheus incs
        self._prom_base: Dict[str, float] = {}

    # -- the hot-path tap ----------------------------------------------------

    def taps(self) -> int:
        """Cumulative decisions seen by the tap (all lanes)."""
        return self._taps_seen

    def tap(
        self,
        duration_s: float,
        lane: str,
        request_id: Optional[str] = None,
        namespace: Optional[str] = None,
        phases_ms: Optional[dict] = None,
        key=None,
        trace_id: Optional[str] = None,
    ) -> None:
        """One decision observed. The common path (not sampled, below
        the lane tail floor) is a counter bump and two dict reads —
        no lock, no allocation."""
        n = next(self._tapseq)
        self._taps_seen = n + 1
        sampled = (
            self.sample_stride <= 1 or n % self.sample_stride == 0
        )
        floor = self._tail_floor.get(lane)
        if not sampled and (floor is None or duration_s <= floor):
            return
        entry = self._entry(
            duration_s, lane, request_id, namespace, phases_ms, key,
            trace_id,
        )
        with self._lock:
            if sampled:
                self.exemplars += 1
                self._ring.append(entry)
            heap = self._tail.get(lane)
            if heap is not None and duration_s > self._tail_floor[lane]:
                self.tail_retained += 1
                item = (float(duration_s), next(self._heapseq), entry)
                if len(heap) < self.worst_k:
                    heapq.heappush(heap, item)
                else:
                    heapq.heapreplace(heap, item)
                if len(heap) >= self.worst_k:
                    self._tail_floor[lane] = heap[0][0]

    def _entry(
        self, duration_s, lane, request_id, namespace, phases_ms, key,
        trace_id,
    ) -> dict:
        if trace_id is None and self.trace_provider is not None:
            try:
                trace_id = self.trace_provider()
            except Exception:
                trace_id = None
        tepoch = None
        if self.epoch_provider is not None:
            try:
                tepoch = int(self.epoch_provider())
            except Exception:
                tepoch = None
        return {
            "ts": round(float(self._clock()), 4),
            "lane": str(lane),
            "duration_ms": round(float(duration_s) * 1e3, 4),
            "request_id": request_id,
            "namespace": None if namespace is None else str(namespace),
            "key_hash": _key_hash(key, namespace),
            "tepoch": tepoch,
            "trace_id": trace_id,
            "phases_ms": dict(phases_ms) if phases_ms else {},
        }

    # -- signal snapshots ----------------------------------------------------

    def note_signals(self, snapshot) -> None:
        """Ring one ``ControlSignals`` snapshot (trigger-thread
        cadence): ``vector()`` flattened next to its timestamp, so a
        bundle replays the control plane across the incident window."""
        try:
            entry = {
                "ts": round(float(snapshot.ts), 3),
                "vector": snapshot.vector(),
            }
        except Exception:
            return
        with self._lock:
            self.signal_snapshots += 1
            self._signals.append(entry)

    # -- freeze / contribute -------------------------------------------------

    def contribute(self, t0=None, t1=None) -> dict:
        """Atomic ring snapshot for an incident window: exemplars and
        signal snapshots filtered to ``[t0, t1]`` (either bound
        optional), worst-K tails contributed WHOLE — the tail is always
        evidence, whatever the window. This is both the local freeze at
        trigger time and the payload a peer ships back for the
        ``kind: "flight"`` lane request."""
        with self._lock:
            ring = list(self._ring)
            signals = list(self._signals)
            tails = {
                lane: [item[2] for item in sorted(heap, reverse=True)]
                for lane, heap in self._tail.items()
            }
            exemplars_total = self.exemplars
            tail_total = self.tail_retained

        def _in_window(entry) -> bool:
            ts = entry.get("ts", 0.0)
            if t0 is not None and ts < float(t0):
                return False
            if t1 is not None and ts > float(t1):
                return False
            return True

        return {
            "host": self.host_id,
            "sample_stride": self.sample_stride,
            "exemplars": [e for e in ring if _in_window(e)],
            "worst": tails,
            "signals": [s for s in signals if _in_window(s)],
            "counts": {
                "exemplars_total": exemplars_total,
                "tail_retained_total": tail_total,
            },
        }

    # -- render / debug ------------------------------------------------------

    def _counts(self) -> dict:
        with self._lock:
            return {
                "exemplars": self.exemplars,
                "tail_retained": self.tail_retained,
                "signal_snapshots": self.signal_snapshots,
                "ring_depth": len(self._ring),
                "signal_depth": len(self._signals),
                "tail_depth": {
                    lane: len(heap)
                    for lane, heap in self._tail.items()
                },
            }

    def flight_debug(self) -> dict:
        """The recorder half of the ``flight`` /debug/stats section."""
        out = self._counts()
        out["taps"] = self.taps()
        out["sample_stride"] = self.sample_stride
        out["capacity"] = self.capacity
        out["worst_k"] = self.worst_k
        return out

    def poll(self, metrics) -> None:
        """``PrometheusMetrics.attach_render_hook`` protocol: feed the
        ``flight_*`` families (cumulative counts converted to
        increments against kept baselines; spool/trigger state read
        through the attached engine)."""
        counts = self._counts()
        for family, value in (
            ("flight_exemplars", counts["exemplars"]),
            ("flight_tail_retained", counts["tail_retained"]),
        ):
            counter = getattr(metrics, family, None)
            if counter is None:
                continue
            base = self._prom_base.get(family, 0.0)
            if value > base:
                counter.inc(value - base)
                self._prom_base[family] = value
        taps_gauge = getattr(metrics, "flight_taps", None)
        if taps_gauge is not None:
            taps_gauge.set(self.taps())
        engine = self.engine
        if engine is not None:
            engine.poll(metrics, self._prom_base)


def _spool_name_fields(name: str):
    """(ts_ms, reason) parsed from a bundle file name, or None."""
    if not name.startswith("flight-") or not name.endswith(".json"):
        return None
    parts = name[len("flight-"):-len(".json")].split("-")
    if len(parts) < 2 or not parts[0].isdigit():
        return None
    return int(parts[0]), parts[1]


class BundleSpool:
    """Retention-capped on-disk spool of JSON incident bundles.

    Names are ``flight-<ts_ms>-<reason>-h<host>.json``; retention
    evicts oldest-first past ``max_bundles`` or ``max_bytes``. Reads
    reject path separators — the HTTP surface serves by bare name."""

    def __init__(
        self,
        directory,
        max_bundles: int = 32,
        max_bytes: int = 64 * 1024 * 1024,
    ):
        self.directory = str(directory)
        self.max_bundles = max(int(max_bundles), 1)
        self.max_bytes = max(int(max_bytes), 1)
        self._lock = threading.Lock()
        os.makedirs(self.directory, exist_ok=True)

    def _names(self) -> List[str]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(
            n for n in names if _spool_name_fields(n) is not None
        )

    def write(self, name: str, bundle: dict) -> str:
        """Persist one bundle (tmp + rename: a reader never sees a
        torn file) and enforce retention. Returns the absolute path."""
        path = os.path.join(self.directory, name)
        tmp = path + ".tmp"
        data = json.dumps(bundle, sort_keys=True)
        with self._lock:
            with open(tmp, "w") as f:
                f.write(data)
            os.replace(tmp, path)
            self._enforce_locked()
        return path

    def _enforce_locked(self) -> None:
        names = self._names()
        sizes = {}
        for n in names:
            try:
                sizes[n] = os.path.getsize(
                    os.path.join(self.directory, n)
                )
            except OSError:
                sizes[n] = 0
        while names and (
            len(names) > self.max_bundles
            or sum(sizes[n] for n in names) > self.max_bytes
        ):
            oldest = names.pop(0)
            try:
                os.remove(os.path.join(self.directory, oldest))
            except OSError:
                pass

    def read(self, name: str) -> Optional[dict]:
        if os.sep in name or "/" in name:
            return None
        if _spool_name_fields(name) is None:
            return None
        try:
            with open(os.path.join(self.directory, name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def list(self) -> List[dict]:
        """Newest-first bundle index (name, reason, ts, bytes)."""
        out = []
        for name in self._names():
            fields = _spool_name_fields(name)
            try:
                size = os.path.getsize(
                    os.path.join(self.directory, name)
                )
            except OSError:
                size = 0
            out.append({
                "name": name,
                "ts": round(fields[0] / 1e3, 3),
                "reason": fields[1],
                "bytes": size,
            })
        out.reverse()
        return out

    def total_bytes(self) -> int:
        total = 0
        for name in self._names():
            try:
                total += os.path.getsize(
                    os.path.join(self.directory, name)
                )
            except OSError:
                pass
        return total


class TriggerEngine(threading.Thread):
    """The flight recorder's trigger plane (see module docstring).

    One daemon thread polls the attached sources every
    ``poll_interval_s``: the SignalBus snapshot (also ringed into the
    recorder), the pod event-count deltas, and the pending peer-retry
    queue. Edge detection fires at most one bundle per reason per
    ``cooldown_s`` (manual fires bypass the cooldown)."""

    #: pod event kinds that fire a bundle, kind -> trigger reason
    EVENT_TRIGGERS = {
        "breaker_open": "breaker_open",
        "resize_abort": "resize_abort",
        "controller_actuation": "controller_actuation",
    }

    def __init__(
        self,
        recorder: FlightRecorder,
        spool: BundleSpool,
        signals=None,
        events=None,
        lane=None,
        profiler=None,
        poll_interval_s: float = 0.5,
        window_s: float = 10.0,
        cooldown_s: float = 30.0,
        profile_s: float = 0.0,
        slo_burn_threshold: float = 2.0,
        peer_retry_s: float = 60.0,
        clock=time.time,
    ):
        super().__init__(name="flight-trigger", daemon=True)
        self.recorder = recorder
        self.spool = spool
        self.signals = signals
        self.events = events
        self.lane = lane
        self.profiler = profiler
        self.poll_interval_s = max(float(poll_interval_s), 0.01)
        self.window_s = max(float(window_s), 0.1)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self.profile_s = max(float(profile_s), 0.0)
        self.slo_burn_threshold = float(slo_burn_threshold)
        self.peer_retry_s = max(float(peer_retry_s), 0.0)
        self._clock = clock
        # named to avoid shadowing threading.Thread._stop(),
        # which join() calls internally
        self._halt = threading.Event()
        self._fire_lock = threading.Lock()
        self._last_fire: Dict[str, float] = {}
        self._last_stamp = 0  # the last bundle name's millisecond
        self._last_counts: Dict[str, int] = {}
        self._last_burn = 0.0
        self._last_drift = 0.0
        self._last_backed: Optional[float] = None
        self._primed = False
        # pending peer contributions: bundle name -> list of
        # {host, t0, t1, deadline}
        self._pending: List[dict] = []
        self.trigger_counts: Dict[str, int] = {
            reason: 0 for reason in TRIGGER_REASONS
        }
        self.suppressed = 0
        self.peer_rings = 0
        self.last_bundle: Optional[str] = None
        recorder.engine = self

    # -- lifecycle -----------------------------------------------------------

    def run(self) -> None:
        while not self._halt.wait(self.poll_interval_s):
            try:
                self.tick()
            except Exception:
                pass  # the trigger plane must never take serving down

    def stop(self) -> None:
        self._halt.set()

    # -- the poll ------------------------------------------------------------

    def tick(self) -> None:
        """One poll round: snapshot signals, detect edges, fire, and
        drain the peer-retry queue. Safe to call inline from tests."""
        snap = None
        bus = self.signals
        if bus is not None:
            try:
                snap = bus.snapshot()
            except Exception:
                snap = None
        if snap is not None:
            self.recorder.note_signals(snap)
            self._signal_edges(snap)
        ev = self.events
        if ev is not None:
            try:
                counts = dict(ev.counts())
            except Exception:
                counts = None
            if counts is not None:
                if self._primed:
                    for kind, reason in self.EVENT_TRIGGERS.items():
                        if counts.get(kind, 0) > self._last_counts.get(
                            kind, 0
                        ):
                            self.fire(
                                reason,
                                note=f"pod event {kind}",
                            )
                self._last_counts = counts
        self._primed = True
        self._retry_pending()

    def _signal_edges(self, snap) -> None:
        """Rising/falling-edge detection over one snapshot. The first
        snapshot only records baselines (a restarted engine must not
        fire on pre-existing state)."""
        burn = float(getattr(snap, "slo_burn_5m", 0.0) or 0.0)
        drift = float(getattr(snap, "model_drift", 0.0) or 0.0)
        backed = float(getattr(snap, "device_backed", 0.0) or 0.0)
        if self._primed:
            if (
                burn >= self.slo_burn_threshold
                and self._last_burn < self.slo_burn_threshold
            ):
                self.fire(
                    "slo_burn", note=f"slo_burn_5m={round(burn, 3)}"
                )
            if drift >= 1.0 and self._last_drift < 1.0:
                self.fire("drift", note="model drift CUSUM tripped")
            if (
                self._last_backed is not None
                and self._last_backed >= 1.0 and backed < 1.0
            ):
                self.fire(
                    "device_probe",
                    note="device_backed fell (probe failure / fallback)",
                )
        self._last_burn = burn
        self._last_drift = drift
        self._last_backed = backed

    # -- firing --------------------------------------------------------------

    def fire(
        self, reason: str, note: Optional[str] = None,
        force: bool = False, profile: Optional[bool] = None,
    ) -> Optional[str]:
        """Produce one incident bundle. Returns its spool name, or
        None when the per-reason cooldown suppressed the fire.
        ``force`` (the manual trigger) bypasses the cooldown;
        ``profile`` overrides the engine's auto-capture default."""
        if reason not in TRIGGER_REASONS:
            reason = "manual"
        now = float(self._clock())
        with self._fire_lock:
            last = self._last_fire.get(reason)
            if (
                not force and last is not None
                and now - last < self.cooldown_s
            ):
                self.suppressed += 1
                return None
            self._last_fire[reason] = now
            # One file a bundle: the name's millisecond moves past the
            # last one taken, so two fires within one millisecond (two
            # manual triggers in a row) keep both bundles; the JAX
            # engine names both alike and its spool keeps the second.
            stamp = max(int(now * 1000), self._last_stamp + 1)
            self._last_stamp = stamp
        t0, t1 = now - self.window_s, now
        bundle = self._build_bundle(reason, note, t0, t1, profile)
        name = "flight-{}-{}-h{}.json".format(
            stamp, reason, self.recorder.host_id
        )
        self.spool.write(name, bundle)
        self.trigger_counts[reason] = (
            self.trigger_counts.get(reason, 0) + 1
        )
        self.last_bundle = name
        self._queue_failed_peers(name, bundle, t0, t1)
        return name

    def _build_bundle(
        self, reason, note, t0, t1, profile
    ) -> dict:
        rec = self.recorder
        tepoch = None
        if rec.epoch_provider is not None:
            try:
                tepoch = int(rec.epoch_provider())
            except Exception:
                tepoch = None
        bundle = {
            "schema": FLIGHT_BUNDLE_SCHEMA,
            "host": rec.host_id,
            "reason": reason,
            "note": note,
            "ts": round(t1, 3),
            "window": [round(t0, 3), round(t1, 3)],
            "tepoch": tepoch,
            "signal_fields": self._signal_fields(),
            "local": rec.contribute(t0, t1),
            "events": self._event_tail(),
            "profile": self._capture_profile(profile),
            "peers": self._collect_peers(t0, t1, tepoch),
        }
        return bundle

    @staticmethod
    def _signal_fields() -> List[str]:
        try:
            from .signals import ControlSignals

            return list(ControlSignals.FIELDS)
        except Exception:
            return []

    def _event_tail(self) -> list:
        ev = self.events
        if ev is None:
            return []
        try:
            return ev.snapshot(64)
        except Exception:
            return []

    def _capture_profile(self, profile) -> Optional[dict]:
        """Bounded ``torch.profiler`` capture riding the incident (a
        ``device_plane.TorchProfiler``; clean no-op when none is
        attached or auto-capture is off). Waits ``profile_s`` on the
        calling thread (the trigger thread, or the HTTP route's executor
        thread for a manual fire), never the decision path; the server's
        profiler starts and stops the capture on its loop's thread. The
        entry names the exported Chrome trace (``trace``) beside the JAX
        entry's ``trace_dir`` and ``seconds``; a failed capture is kept
        as ``{"error": ...}``."""
        want = self.profile_s > 0.0 if profile is None else profile
        prof = self.profiler
        if not want or prof is None:
            return None
        seconds = min(max(self.profile_s, 0.1), 10.0)
        try:
            trace_dir = prof.start(None)
            time.sleep(seconds)
            trace_dir = prof.stop()
            return {"trace_dir": trace_dir, "seconds": seconds,
                    "trace": prof.last_trace}
        except Exception as exc:
            return {"error": str(exc)}

    # -- pod correlation -----------------------------------------------------

    def _peer_request(self, t0, t1, tepoch) -> dict:
        return {"kind": "flight", "t0": t0, "t1": t1, "tepoch": tepoch}

    def _collect_peers(self, t0, t1, tepoch) -> dict:
        """Ask every lane peer for its rings over the incident window
        (blocking admin_call per peer, trigger thread only). Failures
        land as error entries and are retried by ``_retry_pending``."""
        lane = self.lane
        if lane is None:
            return {}
        out: dict = {}
        for host in sorted(getattr(lane, "peers", {})):
            try:
                resp = lane.admin_call(
                    host, self._peer_request(t0, t1, tepoch),
                    timeout=5.0,
                )
                contribution = (resp or {}).get("flight")
                if contribution is None:
                    raise ValueError(
                        (resp or {}).get("error")
                        or "peer has no flight recorder"
                    )
                out[str(host)] = contribution
                self.peer_rings += 1
            except Exception as exc:
                out[str(host)] = {"error": str(exc)}
        return out

    def _queue_failed_peers(self, name, bundle, t0, t1) -> None:
        if self.lane is None or self.peer_retry_s <= 0.0:
            return
        deadline = float(self._clock()) + self.peer_retry_s
        for host, contribution in bundle.get("peers", {}).items():
            if self._needs_retry(contribution):
                self._pending.append({
                    "name": name,
                    "host": int(host),
                    "t0": t0,
                    "t1": t1,
                    "tepoch": bundle.get("tepoch"),
                    "deadline": deadline,
                })

    @staticmethod
    def _needs_retry(contribution) -> bool:
        """A peer still owes rings: it errored, or it answered before
        accumulating anything (a freshly restarted host contributes once
        it has served again)."""
        if not isinstance(contribution, dict):
            return True
        if "error" in contribution:
            return True
        return not (
            contribution.get("exemplars")
            or any(contribution.get("worst", {}).values())
        )

    def _retry_pending(self) -> None:
        """Drain the peer-retry queue: a host that was down at trigger
        time (exactly when bundles fire) gets asked again each poll
        until it contributes rings or the retry deadline lapses; the
        bundle is patched on disk so the autopsy completes when the
        peer returns."""
        if not self._pending:
            return
        now = float(self._clock())
        keep: List[dict] = []
        for item in self._pending:
            done = False
            try:
                resp = self.lane.admin_call(
                    item["host"],
                    self._peer_request(
                        item["t0"], item["t1"], item["tepoch"]
                    ),
                    timeout=5.0,
                )
                contribution = (resp or {}).get("flight")
            except Exception:
                contribution = None
            if contribution is not None:
                bundle = self.spool.read(item["name"])
                if bundle is not None:
                    bundle["peers"][str(item["host"])] = contribution
                    self.spool.write(item["name"], bundle)
                    self.peer_rings += 1
                    done = not self._needs_retry(contribution)
                else:
                    done = True  # bundle aged out of the spool
            if not done and now < item["deadline"]:
                keep.append(item)
        self._pending = keep

    # -- HTTP / debug surfaces -----------------------------------------------

    def flight_trigger(
        self, note: Optional[str] = None, profile: bool = False
    ) -> dict:
        """``POST /debug/flight/trigger`` (blocking — the handler runs
        it in an executor): manual fire, cooldown bypassed."""
        name = self.fire(
            "manual", note=note, force=True,
            profile=True if profile else None,
        )
        return {"fired": name is not None, "bundle": name}

    def flight_bundles(self) -> List[dict]:
        """``GET /debug/flight``: the spool index, newest first."""
        return self.spool.list()

    def flight_bundle(self, name: str) -> Optional[dict]:
        """``GET /debug/flight?name=``: one bundle, parsed."""
        return self.spool.read(name)

    def flight_debug(self) -> dict:
        """The ``flight`` /debug/stats section: recorder counters plus
        trigger/spool state."""
        out = {"recorder": self.recorder.flight_debug()}
        out["triggers"] = dict(self.trigger_counts)
        out["suppressed"] = self.suppressed
        out["peer_rings"] = self.peer_rings
        out["pending_peers"] = len(self._pending)
        out["bundles"] = len(self.spool.list())
        out["spool_bytes"] = self.spool.total_bytes()
        out["last_bundle"] = self.last_bundle
        out["window_s"] = self.window_s
        out["cooldown_s"] = self.cooldown_s
        return out

    def poll(self, metrics, base: Dict[str, float]) -> None:
        """The engine half of the recorder's render hook: trigger
        counters (labeled by reason), spool gauges, peer-ring count."""
        triggers = getattr(metrics, "flight_triggers", None)
        if triggers is not None:
            for reason in TRIGGER_REASONS:
                value = self.trigger_counts.get(reason, 0)
                key = f"flight_triggers:{reason}"
                prev = base.get(key, 0.0)
                if value > prev:
                    triggers.labels(reason).inc(value - prev)
                    base[key] = value
        rings = getattr(metrics, "flight_peer_rings", None)
        if rings is not None:
            prev = base.get("flight_peer_rings", 0.0)
            if self.peer_rings > prev:
                rings.inc(self.peer_rings - prev)
                base["flight_peer_rings"] = self.peer_rings
        bundles = getattr(metrics, "flight_bundles", None)
        if bundles is not None:
            bundles.set(len(self.spool.list()))
        spool_bytes = getattr(metrics, "flight_spool_bytes", None)
        if spool_bytes is not None:
            spool_bytes.set(self.spool.total_bytes())
