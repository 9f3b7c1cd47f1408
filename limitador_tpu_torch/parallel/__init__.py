"""The sharded counter table of the port (one card, n rows).

Counterpart of ``limitador_tpu/parallel/``, cut to the table programs.
"""

from .mesh import (
    ShardedBatchResult,
    ShardedCounterState,
    make_sharded_table,
    sharded_check_and_update,
    sharded_clear_cells,
    sharded_drain_top_hits,
    sharded_update,
)

__all__ = [
    "ShardedBatchResult",
    "ShardedCounterState",
    "make_sharded_table",
    "sharded_check_and_update",
    "sharded_clear_cells",
    "sharded_drain_top_hits",
    "sharded_update",
]
