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
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .core.counter import Counter
from .core.limit import Limit
from .device.storage import TorchStorage
from .ops import kernel as K

__all__ = ["table_from_numpy", "storage_from_state"]


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
    table.load({
        "simple": {tuple(k): int(s) for k, s in slot_dump["simple"].items()},
        "qualified": [(tuple(k), int(s)) for k, s in slot_dump["qualified"]],
        "info": {
            int(s): (tuple(key), _counter(counter))
            for s, (key, counter) in slot_dump["info"].items()
        },
    }, 0, capacity)
    with storage._on_device():
        storage._state = table_from_numpy(values, expiry_ms, hits,
                                          storage.device)
    storage._epoch = float(epoch)
    return storage
