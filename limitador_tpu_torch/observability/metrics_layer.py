"""Span-tree metrics aggregation (MetricsLayer).

The port's copy of ``limitador_tpu/observability/metrics_layer.py``
(pure Python, unchanged apart from the context variable's name).

Re-implements the reference's ``MetricsLayer``
(limitador-server/src/metrics.rs:100-211) without a tracing framework:
spans are explicit lightweight objects parented through a ``ContextVar``
(so an ``await``-ing request handler parents the storage spans it
triggers in the same task), and the layer walks the same state machine —

* a span whose name was registered via :meth:`MetricsLayer.gather` is an
  **aggregator**: it owns a :class:`SpanState` with one
  :class:`Timings` accumulator per group (metrics.rs:119-131);
* a span whose name appears in a group's ``records`` (and which sits
  under an aggregator, directly or through intermediates) carries its
  own :class:`Timings` (metrics.rs:133-148) accumulating busy (entered)
  and idle (open but not entered) nanoseconds;
* on close, a record span folds its timings into every matching group
  of its state and re-publishes the state to its parent
  (metrics.rs:185-202) so sibling records accumulate; an aggregator
  span hands the group total to the configured consumer
  (metrics.rs:204-208).

The server wires this exactly like the reference's
``configure_tracing_subscriber`` (main.rs:908-917): both the
``should_rate_limit`` and ``flush_batcher_and_update_counters``
aggregates feed ``datastore`` child spans into the
``datastore_latency`` histogram.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "Timings",
    "SpanState",
    "MetricsLayer",
    "Span",
    "install",
    "installed",
    "metrics_span",
    "current_span",
]


class Timings:
    """Busy/idle nanosecond accumulator (metrics.rs:9-51).

    ``busy`` counts time the span was entered (executing), ``idle``
    counts time it was open but not entered (queued / awaiting);
    ``updated`` marks that the span was entered at least once, which
    gates the consumer callback (metrics.rs:205)."""

    __slots__ = ("idle", "busy", "last", "updated")

    def __init__(
        self,
        idle: int = 0,
        busy: int = 0,
        last: Optional[int] = None,
        updated: bool = False,
    ):
        self.idle = idle
        self.busy = busy
        self.last = time.perf_counter_ns() if last is None else last
        self.updated = updated

    def __add__(self, other: "Timings") -> "Timings":
        return Timings(
            idle=self.idle + other.idle,
            busy=self.busy + other.busy,
            last=max(self.last, other.last),
            updated=self.updated or other.updated,
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, Timings):
            return NotImplemented
        return (
            self.idle == other.idle
            and self.busy == other.busy
            and self.last == other.last
            and self.updated == other.updated
        )

    def copy(self) -> "Timings":
        return Timings(self.idle, self.busy, self.last, self.updated)

    @property
    def duration(self) -> float:
        """Total open seconds — ``Duration::from(timings)`` is
        idle + busy (metrics.rs:47-51)."""
        return (self.idle + self.busy) / 1e9

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Timings(idle={self.idle}, busy={self.busy}, "
            f"updated={self.updated})"
        )


class SpanState:
    """Per-aggregator accumulators carried down the span tree
    (metrics.rs:53-71)."""

    __slots__ = ("group_times",)

    def __init__(self, group: Optional[str] = None):
        self.group_times: Dict[str, Timings] = {}
        if group is not None:
            self.group_times[group] = Timings()

    def increment(self, group: str, timings: Timings) -> None:
        cur = self.group_times.get(group)
        self.group_times[group] = timings if cur is None else cur + timings

    def copy(self) -> "SpanState":
        st = SpanState()
        st.group_times = {k: v.copy() for k, v in self.group_times.items()}
        return st


class _MetricsGroup:
    __slots__ = ("consumer", "records")

    def __init__(self, consumer: Callable[[Timings], None], records: List[str]):
        self.consumer = consumer
        self.records = records


_current: ContextVar[Optional["Span"]] = ContextVar(
    "limitador_tpu_torch_metrics_span", default=None
)


def current_span() -> Optional["Span"]:
    return _current.get()


class Span:
    """One node of the span tree. Supports repeated enter/exit cycles
    before close, mirroring tracing's span lifecycle so async code can
    account queue/await time as idle."""

    __slots__ = ("layer", "name", "parent", "state", "timings", "_token",
                 "closed")

    def __init__(self, layer: "MetricsLayer", name: str,
                 parent: Optional["Span"]):
        self.layer = layer
        self.name = name
        self.parent = parent
        self.state: Optional[SpanState] = None
        self.timings: Optional[Timings] = None
        self._token = None
        self.closed = False

    # -- lifecycle (on_enter / on_exit, metrics.rs:151-172) ---------------

    def enter(self) -> "Span":
        self._token = _current.set(self)
        t = self.timings
        if t is not None:
            now = time.perf_counter_ns()
            t.idle += now - t.last
            t.last = now
            t.updated = True
        return self

    def exit(self) -> None:
        if self._token is not None:
            try:
                _current.reset(self._token)
            except ValueError:  # exited from a different context
                _current.set(self.parent)
            self._token = None
        t = self.timings
        if t is not None:
            now = time.perf_counter_ns()
            t.busy += now - t.last
            t.last = now
            t.updated = True

    # -- on_close (metrics.rs:174-210) ------------------------------------

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        timing: Optional[Timings] = None
        t = self.timings
        if t is not None:
            t.idle += time.perf_counter_ns() - t.last
            timing = t.copy()
        state = self.state
        if state is None:
            return
        groups = self.layer.groups
        if timing is not None:
            for group in list(state.group_times):
                if self.name in groups[group].records:
                    state.increment(group, timing)
        # bubble the updated state up so the next sibling record (created
        # after us) starts from the accumulated totals (metrics.rs:199-202)
        if self.parent is not None and not self.parent.closed:
            self.parent.state = state.copy()
        mg = groups.get(self.name)
        if mg is not None:
            total = state.group_times.get(self.name)
            if total is not None and total.updated:
                mg.consumer(total.copy())

    # -- context manager: enter on with, exit+close on leave ---------------

    def __enter__(self) -> "Span":
        return self.enter()

    def __exit__(self, *exc) -> None:
        self.exit()
        self.close()


class MetricsLayer:
    """Aggregate registry + span factory (metrics.rs:84-98)."""

    def __init__(self):
        self.groups: Dict[str, _MetricsGroup] = {}

    def gather(
        self,
        aggregate: str,
        consumer: Callable[[Timings], None],
        records: Sequence[str],
    ) -> "MetricsLayer":
        self.groups.setdefault(
            aggregate, _MetricsGroup(consumer, list(records))
        )
        return self

    def new_span(
        self, name: str, parent: Optional["Span"] = None, *,
        inherit: bool = True,
    ) -> Span:
        """on_new_span (metrics.rs:105-149): inherit the parent's state,
        extend it when this span is itself an aggregator, and attach a
        Timings accumulator when any inherited group records this name."""
        if parent is None and inherit:
            parent = _current.get()
        elif not inherit:
            parent = None
        span = Span(self, name, parent)
        if parent is not None and parent.state is not None:
            span.state = parent.state.copy()
        if name in self.groups:
            if span.state is not None:
                # second-level aggregator: append ourselves
                span.state.group_times.setdefault(name, Timings())
            else:
                span.state = SpanState(name)
        if span.state is not None:
            for group in span.state.group_times:
                if name in self.groups[group].records:
                    span.timings = Timings()
                    break
        return span


# -- process-global installation (the server's subscriber registry) --------

_installed: Optional[MetricsLayer] = None


def install(layer: Optional[MetricsLayer]) -> None:
    global _installed
    _installed = layer


def installed() -> Optional[MetricsLayer]:
    return _installed


_NULLCONTEXT = nullcontext()


@contextmanager
def _live_span(layer: "MetricsLayer", name: str, inherit: bool):
    span = layer.new_span(name, inherit=inherit)
    span.enter()
    try:
        yield span
    finally:
        span.exit()
        span.close()


def metrics_span(name: str, inherit: bool = True):
    """Open a span on the installed layer. With none installed this is a
    module-global check returning a shared nullcontext — no generator
    machinery on the hot path (a @contextmanager no-op still costs ~5us
    per request at serving rates). ``inherit=False`` detaches from any
    contextvar parent — for conceptually-background aggregates (the
    write-behind flush) that can run inline under a request span, where
    inheriting would fold the same wall clock into the request's
    aggregate twice."""
    layer = _installed
    if layer is None:
        return _NULLCONTEXT
    return _live_span(layer, name, inherit)
