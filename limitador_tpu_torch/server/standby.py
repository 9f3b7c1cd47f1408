"""The warm standby: a host that joins a running pod in under a second.

Counterpart of ``limitador_tpu/server/standby.py`` (``WarmStandby``). A
cold host joining a pod pays, before its first decision, the start of its
process, the first load of the decision kernels and the limits
configuration. The warm standby pays them before it is a member, so that
the join (``server/resize.py`` ``join_host``) flips membership as a
control-plane fact:

* **process**: the standby serves its peer lane memberless, as host 0 of
  a pod of one, until a coordinator's ``join_admin`` adopt ships it the
  real topology;
* **kernels**: :meth:`WarmStandby.warm` launches the port's decision
  kernels once per hit bucket on a scratch table of the serving capacity
  (B1 on an all-padding batch, which changes nothing; B2's host form; and
  one B1 on the cluster route at 1,024 hits), so that the kernel library
  is built and loaded and each kernel has run once on the card; with
  ``--kernel-cache-dir`` the build persists across restarts;
* **state**: the coordinator ships the limits and the plan-cache seed
  over the ``join_admin`` and ``plan_seed`` lane kinds (armed here)
  before any routing changes, and the migrate lane moves the joiner's
  slices after the epoch bump, while the pod serves.

Unlike the JAX warm-up, which logs a failure and stays joinable, this one
raises where a kernel cannot build or launch: the port has no fallback.
``--standby off`` (the default) never imports this module.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

__all__ = ["WarmStandby", "METRIC_FAMILIES", "DEFAULT_WARM_BUCKETS"]

log = logging.getLogger("limitador_tpu_torch.pod.standby")

#: metric families of the warm standby (merged into the frontend's
#: library_stats)
METRIC_FAMILIES = (
    "standby_ready",
    "standby_warm_kernels",
    "standby_warm_seconds",
)

#: the hit buckets warmed by default (the JAX package's pow2 buckets)
DEFAULT_WARM_BUCKETS = (8, 16, 32, 64, 128, 256, 512)

#: the hits of the one warm-up launch on B1's cluster route
CLUSTER_WARM_HITS = 1024


class WarmStandby:
    """Holds a started, warmed, memberless host ready for
    :meth:`PodResizeCoordinator.join_host` to promote.

    Construct it over the assembled frontend and coordinator (``--standby
    on`` in ``server/__main__.py``, or a test harness), call :meth:`warm`
    once off the serving path, and the standby waits for a coordinator's
    ``join_admin`` adopt. Arming the join kinds is explicit and separate
    from ``attach_resize``."""

    def __init__(
        self,
        frontend,
        coordinator,
        warm_buckets: Sequence[int] = DEFAULT_WARM_BUCKETS,
        table_capacity: Optional[int] = None,
        device=None,
    ):
        self.frontend = frontend
        self.coordinator = coordinator
        self.warm_buckets = tuple(
            sorted({int(b) for b in warm_buckets})
        )
        # the serving table's capacity and card, so that the warm-up runs
        # the kernels at the serving shapes
        storage = getattr(frontend._limiter, "storage", None)
        storage = getattr(storage, "counters", storage)
        storage = getattr(storage, "inner", storage)
        if table_capacity is None:
            table_capacity = (getattr(storage, "_capacity", None)
                              or getattr(storage, "_local_capacity", None))
        if device is None:
            device = getattr(storage, "device", None) or "cpu"
        self.table_capacity = int(table_capacity or 1024)
        self.device = device
        self.ready = False
        self.warm_kernels = 0
        self.warm_seconds = 0.0
        # the join's control plane: the coordinator answers the adopt
        # and limits ops, the frontend imports shipped plan seeds, and
        # the frontend's library_stats carries the standby_* families
        frontend.lane.join_cb = coordinator.handle_join
        frontend.lane.plan_seed_cb = frontend.plan_seed_import
        frontend.standby = self

    def warm(self) -> dict:
        """Launch the decision kernels at every hit bucket (blocking; at
        start-up, never on a serving loop). Raises where a kernel cannot
        build or launch."""
        started = time.time()
        self.warm_kernels = self._warm_buckets()
        self.warm_seconds = round(time.time() - started, 6)
        self.ready = True
        self.frontend.events.emit(
            "standby_ready",
            kernels=self.warm_kernels,
            buckets=len(self.warm_buckets),
            seconds=self.warm_seconds,
            capacity=self.table_capacity,
        )
        log.info(
            f"warm standby ready: {self.warm_kernels} kernel calls over "
            f"buckets {list(self.warm_buckets)} in {self.warm_seconds:.3f}s "
            f"(table capacity {self.table_capacity})"
        )
        return {
            "ready": True,
            "kernels": self.warm_kernels,
            "seconds": self.warm_seconds,
        }

    def _warm_buckets(self) -> int:
        """One scratch table of the serving capacity; at each bucket B1 on
        an all-padding batch (slot C, delta 0, max INT32_MAX: the inert
        rows of the kernel's contract) and B2's host form, then one B1 on
        the cluster route. Returns the kernel calls made, each one launch
        on a card (the plain versions on the CPU)."""
        import numpy as np
        import torch

        from ..ops import kernel as K

        cap = self.table_capacity
        device = torch.device(self.device)
        state = K.make_table(cap, device)
        ctx = K.TableContext(state)
        calls = 0
        try:
            for H in self.warm_buckets + (CLUSTER_WARM_HITS,):
                slots = torch.full((H,), cap, dtype=torch.int32,
                                   device=device)
                zeros = torch.zeros(H, dtype=torch.int32, device=device)
                maxes = torch.full((H,), np.iinfo(np.int32).max,
                                   dtype=torch.int32, device=device)
                windows = torch.ones(H, dtype=torch.int32, device=device)
                off = torch.zeros(H, dtype=torch.bool, device=device)
                K.check_and_update_batch(
                    state, slots, zeros, maxes, windows, zeros, off, off, 0)
                calls += 1
                if H == CLUSTER_WARM_HITS:
                    break
                # delta 0 on the scratch table's first cell
                K.update_host(ctx, np.asarray([[0, 0, 0, 1, 0]], np.int32), 0)
                calls += 1
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        finally:
            ctx.close()
        return calls

    def stats(self) -> dict:
        """The ``standby_*`` families (merged into library_stats)."""
        return {
            "standby_ready": 1 if self.ready else 0,
            "standby_warm_kernels": self.warm_kernels,
            "standby_warm_seconds": self.warm_seconds,
        }

    def status(self) -> dict:
        """The ``GET /debug/pod/standby`` payload."""
        return {
            **self.stats(),
            "buckets": list(self.warm_buckets),
            "table_capacity": self.table_capacity,
            "host": self.coordinator.host_id,
            "topology_epoch": self.coordinator.router.topology_epoch,
            "join_ttfd_seconds": self.coordinator.join_ttfd_seconds,
        }
