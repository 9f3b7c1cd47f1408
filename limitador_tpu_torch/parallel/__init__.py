"""The sharded counter table of the port (one card, n rows), and the
pod's formation and psum lane.

Counterpart of ``limitador_tpu/parallel/``: the table programs here
(``mesh.py``), the serving pod's formation over a TCPStore, its barrier
and its psum lane in ``pod.py``, which only a pod member imports.
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
