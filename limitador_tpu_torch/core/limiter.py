"""Rate limiter facades.

Port counterpart of ``limitador_tpu/core/limiter.py``, copied with its
imports kept package-relative; the ``datastore`` spans stand where the
JAX package has them (``observability/tracing.py``).

Mirrors upstream limitador/src/lib.rs: ``RateLimiter`` (sync) and
``AsyncRateLimiter`` over the storage facades, ``CheckResult`` with the
draft-03 ratelimit response headers (lib.rs:228-275), and the declarative
``configure_with`` reconcile (lib.rs:475-505).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Union

from ..observability.tracing import datastore_span
from ..storage.base import (
    AsyncCounterStorage,
    AsyncStorage,
    CounterStorage,
    Storage,
)
from ..storage.in_memory import DEFAULT_CACHE_SIZE, InMemoryStorage
from .cel import Context
from .counter import Counter
from .limit import Limit, Namespace

__all__ = ["CheckResult", "RateLimiter", "AsyncRateLimiter"]


class CheckResult:
    """Outcome of a check: limited flag, loaded counters, first limit name."""

    __slots__ = ("limited", "counters", "limit_name")

    def __init__(
        self,
        limited: bool,
        counters: Optional[List[Counter]] = None,
        limit_name: Optional[str] = None,
    ):
        self.limited = limited
        self.counters: List[Counter] = counters if counters is not None else []
        self.limit_name = limit_name

    def __bool__(self) -> bool:
        return self.limited

    def response_header(self) -> Dict[str, str]:
        """draft-03 ratelimit headers, most-restrictive counter first
        (lib.rs:235-275)."""
        headers: Dict[str, str] = {}
        self.counters.sort(
            key=lambda c: c.remaining if c.remaining is not None else c.max_value
        )

        all_limits_text = ""
        for counter in self.counters:
            all_limits_text += f", {counter.max_value};w={counter.window_seconds}"
            if counter.limit.name is not None:
                name = counter.limit.name.replace('"', "'")
                all_limits_text += f';name="{name}"'

        if self.counters:
            first = self.counters[0]
            max_value = first.max_value
            remaining = first.remaining if first.remaining is not None else max_value
            headers["X-RateLimit-Limit"] = f"{max_value}{all_limits_text}"
            headers["X-RateLimit-Remaining"] = str(remaining)
            if first.expires_in is not None:
                headers["X-RateLimit-Reset"] = str(int(first.expires_in))
        return headers


def _counters_that_apply(
    storage: Union[Storage, AsyncStorage], namespace: Namespace, ctx: Context
) -> List[Counter]:
    """Limits of the namespace that apply to the context, as counters
    (lib.rs:507-522)."""
    counters: List[Counter] = []
    for limit in sorted(storage.get_limits(namespace)):
        if limit.applies(ctx):
            counter = Counter.new(limit, ctx)
            if counter is not None:
                counters.append(counter)
    return counters


def _classify_limits_by_namespace(
    limits: Iterable[Limit],
) -> Dict[Namespace, Set[Limit]]:
    out: Dict[Namespace, Set[Limit]] = {}
    for limit in limits:
        out.setdefault(limit.namespace, set()).add(limit)
    return out


class RateLimiter:
    """Synchronous rate limiter (lib.rs:323-523)."""

    def __init__(
        self,
        storage: Optional[CounterStorage] = None,
        cache_size: int = DEFAULT_CACHE_SIZE,
    ):
        self.storage = Storage(storage or InMemoryStorage(cache_size))

    # -- limit CRUD --------------------------------------------------------

    def get_namespaces(self) -> Set[Namespace]:
        return self.storage.get_namespaces()

    def add_limit(self, limit: Limit) -> bool:
        return self.storage.add_limit(limit)

    def update_limit(self, limit: Limit) -> bool:
        return self.storage.update_limit(limit)

    def delete_limit(self, limit: Limit) -> None:
        self.storage.delete_limit(limit)

    def get_limits(self, namespace: Union[str, Namespace]) -> Set[Limit]:
        return self.storage.get_limits(Namespace.of(namespace))

    def delete_limits(self, namespace: Union[str, Namespace]) -> None:
        self.storage.delete_limits(Namespace.of(namespace))

    # -- checks ------------------------------------------------------------

    def is_rate_limited(
        self, namespace: Union[str, Namespace], ctx: Context, delta: int,
        counters: Optional[List[Counter]] = None,
    ) -> CheckResult:
        """Read-only check (lib.rs:362-385). ``counters`` short-circuits
        limit matching with a precomputed set (a frontend that
        already matched the limits passes them here)."""
        if counters is None:
            counters = _counters_that_apply(
                self.storage, Namespace.of(namespace), ctx
            )
        with datastore_span("is_within_limits"):
            for counter in counters:
                if not self.storage.is_within_limits(counter, delta):
                    return CheckResult(True, [], counter.limit.name)
        return CheckResult(False, [], None)

    def update_counters(
        self, namespace: Union[str, Namespace], ctx: Context, delta: int,
        counters: Optional[List[Counter]] = None,
    ) -> None:
        if counters is None:
            counters = _counters_that_apply(
                self.storage, Namespace.of(namespace), ctx
            )
        with datastore_span("update_counter"):
            for counter in counters:
                self.storage.update_counter(counter, delta)

    def check_rate_limited_and_update(
        self,
        namespace: Union[str, Namespace],
        ctx: Context,
        delta: int,
        load_counters: bool = False,
        counters: Optional[List[Counter]] = None,
    ) -> CheckResult:
        """THE hot path: check-and-update in one storage call
        (lib.rs:425-464). ``counters`` short-circuits matching with a
        precomputed set (limits matched once by the caller)."""
        if counters is None:
            counters = _counters_that_apply(
                self.storage, Namespace.of(namespace), ctx
            )
        if not counters:
            return CheckResult(False, counters, None)
        with datastore_span("check_and_update"):
            auth = self.storage.check_and_update(
                counters, delta, load_counters
            )
        loaded = counters if load_counters else []
        if auth.limited:
            return CheckResult(True, loaded, auth.limit_name)
        return CheckResult(False, loaded, None)

    def get_counters(self, namespace: Union[str, Namespace]) -> Set[Counter]:
        return self.storage.get_counters(Namespace.of(namespace))

    # -- declarative reconcile (lib.rs:475-505) ----------------------------

    def configure_with(self, limits: Iterable[Limit]) -> None:
        keep = _classify_limits_by_namespace(limits)
        # Pre-flight every limit BEFORE the delete/add mutation loop: a
        # mid-apply rejection (e.g. a policy this storage can't count)
        # must leave the previous config fully in force, not half-gone.
        for per_ns in keep.values():
            for limit in per_ns:
                self.storage.check_policy_supported(limit)
        namespaces = self.get_namespaces() | set(keep.keys())
        for namespace in namespaces:
            existing = self.get_limits(namespace)
            wanted = keep.get(namespace, set())
            for limit in existing - wanted:
                self.delete_limit(limit)
            for limit in wanted - existing:
                self.add_limit(limit)
            for limit in wanted:
                self.storage.update_limit(limit)


class AsyncRateLimiter:
    """Asynchronous rate limiter (lib.rs:530+); used by the serving plane in
    front of batched backends (TPU micro-batcher, replicated stores)."""

    def __init__(self, storage: AsyncCounterStorage):
        self.storage = AsyncStorage(storage)

    def get_namespaces(self) -> Set[Namespace]:
        return self.storage.get_namespaces()

    def add_limit(self, limit: Limit) -> bool:
        return self.storage.add_limit(limit)

    def update_limit(self, limit: Limit) -> bool:
        return self.storage.update_limit(limit)

    async def delete_limit(self, limit: Limit) -> None:
        await self.storage.delete_limit(limit)

    def get_limits(self, namespace: Union[str, Namespace]) -> Set[Limit]:
        return self.storage.get_limits(Namespace.of(namespace))

    async def delete_limits(self, namespace: Union[str, Namespace]) -> None:
        await self.storage.delete_limits(Namespace.of(namespace))

    async def is_rate_limited(
        self, namespace: Union[str, Namespace], ctx: Context, delta: int,
        counters: Optional[List[Counter]] = None,
    ) -> CheckResult:
        if counters is None:
            counters = _counters_that_apply(
                self.storage, Namespace.of(namespace), ctx
            )
        with datastore_span("is_within_limits"):
            for counter in counters:
                if not await self.storage.is_within_limits(counter, delta):
                    return CheckResult(True, [], counter.limit.name)
        return CheckResult(False, [], None)

    async def update_counters(
        self, namespace: Union[str, Namespace], ctx: Context, delta: int,
        counters: Optional[List[Counter]] = None,
    ) -> None:
        if counters is None:
            counters = _counters_that_apply(
                self.storage, Namespace.of(namespace), ctx
            )
        with datastore_span("update_counter"):
            for counter in counters:
                await self.storage.update_counter(counter, delta)

    async def check_rate_limited_and_update(
        self,
        namespace: Union[str, Namespace],
        ctx: Context,
        delta: int,
        load_counters: bool = False,
        counters: Optional[List[Counter]] = None,
    ) -> CheckResult:
        if counters is None:
            counters = _counters_that_apply(
                self.storage, Namespace.of(namespace), ctx
            )
        if not counters:
            return CheckResult(False, counters, None)
        with datastore_span("check_and_update"):
            auth = await self.storage.check_and_update(
                counters, delta, load_counters
            )
        loaded = counters if load_counters else []
        if auth.limited:
            return CheckResult(True, loaded, auth.limit_name)
        return CheckResult(False, loaded, None)

    async def get_counters(self, namespace: Union[str, Namespace]) -> Set[Counter]:
        return await self.storage.get_counters(Namespace.of(namespace))

    async def configure_with(self, limits: Iterable[Limit]) -> None:
        keep = _classify_limits_by_namespace(limits)
        # Pre-flight before mutating (see RateLimiter.configure_with).
        for per_ns in keep.values():
            for limit in per_ns:
                self.storage.check_policy_supported(limit)
        namespaces = self.get_namespaces() | set(keep.keys())
        for namespace in namespaces:
            existing = self.get_limits(namespace)
            wanted = keep.get(namespace, set())
            for limit in existing - wanted:
                await self.delete_limit(limit)
            for limit in wanted - existing:
                self.add_limit(limit)
            for limit in wanted:
                self.storage.update_limit(limit)
