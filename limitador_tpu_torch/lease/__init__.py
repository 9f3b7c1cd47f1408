"""Quota-leasing edge tier for the native serving path.

Port counterpart of ``limitador_tpu/lease/``. The
:class:`~limitador_tpu_torch.lease.broker.LeaseBroker` watches the C plan
mirror's demand signal, pre-debits batches of quota from the device table
through the shared columnar check lane (B1), and attaches the tokens to
the mirrored plan, after which a repeat descriptor with live lease tokens
is admitted inside the C hot lane with zero Python and zero device work.

The contract:

- **Bounded over-admission**: grants are pre-debited, so the device
  counter always runs AHEAD of true usage by exactly the outstanding
  (granted-but-unconsumed) tokens; over-admission for any counter is
  bounded by its outstanding leased tokens, and only across a window
  roll.
- **Headroom-checked grants**: the debit rides the same
  check-all-then-update-all kernel as live traffic, so a grant past the
  remaining window headroom is refused atomically.
- **No stranded quota**: unused tokens come back. Expiry revokes
  synchronously; plan invalidation (slot recycling, limits-epoch bumps)
  pushes the balance onto a return ring the broker drains and credits
  back through the floor-guarded credit kernel (B4c,
  ``ops/kernel.py::credit_batch``). Credits verify slot->counter identity
  under the storage lock, so a recycled slot's dead debit is dropped
  instead of crediting a stranger.
- **Cold keys stay exact**: only repeat descriptors with a live mirrored
  kernel plan are leasable.
"""

from .broker import LeaseBroker, LeaseConfig

__all__ = ["LeaseBroker", "LeaseConfig", "METRIC_FAMILIES"]

#: the lease tier's families (fed by the broker's stats), as the JAX package
#: registers them (the analysis gate holds them to
#: observability/metrics.py)
METRIC_FAMILIES = (
    "lease_admissions",
    "lease_grants",
    "lease_grant_denials",
    "lease_granted_tokens",
    "lease_returned_tokens",
    "lease_active",
    "lease_outstanding_tokens",
)
