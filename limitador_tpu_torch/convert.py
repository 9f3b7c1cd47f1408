"""State carried across from the JAX package to the port.

The port's counterpart of the state a ``limitador_tpu`` ``TpuStorage``
holds: its device table (``CounterTableState`` of ``limitador_tpu/ops/
kernel.py``: ``values``, ``expiry_ms`` and ``hits``, each int32[C+1]) and
its host key space (``_SlotTable.dump()`` of ``limitador_tpu/tpu/
storage.py``) relative to its epoch. Everything comes in as numpy arrays
and plain Python values, so this module imports nothing of the JAX
package: a caller that holds a ``TpuStorage`` passes
``np.asarray(state.values)`` and friends, ``storage._table.dump()`` and
``storage._epoch``.

The dump's counters may be given as ``Counter.to_dict()`` dictionaries or
as any object with a ``to_dict()`` method; they are rebuilt as the port's
own ``Counter`` and ``Limit``. Slot keys are tuples of strings and ints
and carry over as they are. The host-path cells of limits beyond the
device's caps (``TpuStorage._big``) are not carried: they start empty.
The native path's per-slot keys (``native_keys``) are not carried either:
they start empty, and a native pipeline built over the new storage
re-derives its plans and slot-map entries from the carried key space.

``sharded_storage_from_state`` does the same for a ``TpuShardedStorage``:
its three int32[n, L+1] arrays (``np.asarray(storage._state.values)``
and friends), each shard's ``_SlotTable.dump()`` (``storage._tables``),
the global region's (``storage._gtable``) and the epoch, and becomes a
``TorchShardedStorage`` of n rows with the same slots and cells.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .core.counter import Counter
from .core.limit import Limit
from .device.storage import TorchStorage
from .ops import kernel as K

__all__ = ["table_from_numpy", "storage_from_state",
           "sharded_storage_from_state"]


def table_from_numpy(values, expiry_ms, hits, device) -> K.CounterTableState:
    """The port's device table from three int32[C+1] arrays."""
    columns = [np.ascontiguousarray(a, dtype=np.int32)
               for a in (values, expiry_ms, hits)]
    n = columns[0].shape
    if columns[0].ndim != 1 or any(c.shape != n for c in columns):
        raise ValueError("values, expiry_ms and hits must be int32[C+1]")
    return K.CounterTableState(*(
        torch.from_numpy(c.copy()).to(device) for c in columns
    ))


def _counter(entry) -> Counter:
    data = entry if isinstance(entry, dict) else entry.to_dict()
    return Counter(Limit.from_dict(data["limit"]),
                   dict(data["set_variables"]))


def _table_dump(slot_dump: dict) -> dict:
    """A ``_SlotTable.dump()`` with the port's own counters."""
    return {
        "simple": {tuple(k): int(s) for k, s in slot_dump["simple"].items()},
        "qualified": [(tuple(k), int(s)) for k, s in slot_dump["qualified"]],
        "info": {
            int(s): (tuple(key), _counter(counter))
            for s, (key, counter) in slot_dump["info"].items()
        },
    }


def storage_from_state(
    slot_dump: dict,
    values,
    expiry_ms,
    hits,
    epoch: float,
    cache_size=None,
    clock=time.time,
    device=None,
) -> TorchStorage:
    """A ``TorchStorage`` that continues from the JAX storage's state:
    the same slots, cells and epoch, so the two decide the same next
    operations identically. ``slot_dump`` is ``_SlotTable.dump()``
    (``simple``, ``qualified`` and ``info``)."""
    capacity = int(np.shape(values)[0]) - 1
    storage = TorchStorage(
        capacity=capacity, cache_size=cache_size, clock=clock, device=device
    )
    table = storage._replace_table()
    table.load(_table_dump(slot_dump), 0, capacity)
    with storage._on_device():
        storage._state = table_from_numpy(values, expiry_ms, hits,
                                          storage.device)
    storage._epoch = float(epoch)
    return storage


def sharded_storage_from_state(
    shard_dumps,
    global_dump: dict,
    values,
    expiry_ms,
    hits,
    epoch: float,
    global_namespaces=(),
    global_region: int = 1024,
    next_app_shard: int = 0,
    cache_size=None,
    clock=time.time,
    device=None,
):
    """A ``TorchShardedStorage`` that continues from the JAX sharded
    storage's state: the same rows, slots, cells and epoch, so the two
    decide the same next operations identically. ``shard_dumps`` is one
    ``_SlotTable.dump()`` per shard, ``global_dump`` the global region's;
    ``values``, ``expiry_ms`` and ``hits`` are int32[n, L+1]. The
    namespaces, region and cache size must be the JAX storage's;
    ``next_app_shard`` is its round-robin row for the next global delta
    (``storage._rr``), so that later partials land on the same rows."""
    from .device.sharded import TorchShardedStorage

    columns = [np.ascontiguousarray(a, dtype=np.int32)
               for a in (values, expiry_ms, hits)]
    shape = columns[0].shape
    if columns[0].ndim != 2 or any(c.shape != shape for c in columns):
        raise ValueError("values, expiry_ms and hits must be int32[n, L+1]")
    n, local_capacity = shape[0], shape[1] - 1
    if len(shard_dumps) != n:
        raise ValueError(f"{len(shard_dumps)} shard tables for {n} rows")
    storage = TorchShardedStorage(
        n_shards=n, local_capacity=local_capacity, cache_size=cache_size,
        global_namespaces=global_namespaces, global_region=global_region,
        clock=clock, device=device,
    )
    for table, dump in zip(storage._tables, shard_dumps):
        table.load(_table_dump(dump), global_region, local_capacity)
    storage._gtable.load(_table_dump(global_dump), 0, global_region)
    with storage._on_device():
        state = [torch.from_numpy(c.copy()).to(storage.device)
                 for c in columns]
        storage._state = type(storage._state)(*state)
    storage._epoch = float(epoch)
    storage._rr = int(next_app_shard) % n
    return storage
