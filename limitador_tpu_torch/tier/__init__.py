"""Tiered counter storage: a device-resident hot set over an exact host
cold tier, heat-driven migration.

Port counterpart of ``limitador_tpu/tier/``. The device table holds
``capacity`` slots; the keyspace served may be far larger. The Zipf-hot
head stays resident on the card, a large exact host store backs it, and
counters migrate on observed heat.

* :class:`~limitador_tpu_torch.tier.cold.ColdStore`: the exact host cold
  tier, with an optional append-log disk spill.
* :class:`~limitador_tpu_torch.tier.storage.TieredStorage`: a
  ``TorchStorage`` whose LRU eviction is an exact demotion (one B3a
  peek) and whose big-limit host lane also serves cold residents;
  promotion seeds the device cell through B4d.
* :class:`~limitador_tpu_torch.tier.manager.TierManager`: the migration
  thread: heat in, two-phase ledgered moves out, demotions settled
  through the lease broker's ``reclaim_slots`` (B4c) first.
"""

from .cold import ColdStore
from .manager import TierManager
from .storage import TieredStorage

__all__ = [
    "ColdStore",
    "TieredStorage",
    "TierManager",
    "METRIC_FAMILIES",
]

#: Prometheus families the tier subsystem feeds (``TierManager.poll``);
#: the port's metrics registry arrives with the HTTP API slice.
METRIC_FAMILIES = (
    "tier_resident",
    "tier_migrations",
    "tier_migration_backlog",
    "tier_cold_decide_seconds",
    "tier_decision_benefit",
    "tier_cold_spilled",
)
