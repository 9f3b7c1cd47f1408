"""Host-side storages and the storage protocol of the port.

Counterpart of ``limitador_tpu/storage/``, with the same exports: the
storage protocol (``base``), the window and bucket cells
(``expiring_value``, ``gcra``), the key codec (``keys``, ``postcard``),
the in-memory reference (``in_memory``), and the host-memory storages the
server builds by name: ``disk`` (SQLite), ``cached`` (write-behind over an
authority), ``authority`` (the shared authority's gRPC client and server)
and ``distributed`` (the CRDT gossip storage).
"""

from .base import (
    AsyncCounterStorage,
    AsyncStorage,
    Authorization,
    CounterStorage,
    Storage,
    StorageError,
)
from .expiring_value import ExpiringValue
from .in_memory import InMemoryStorage

__all__ = [
    "AsyncCounterStorage",
    "AsyncStorage",
    "Authorization",
    "CounterStorage",
    "Storage",
    "StorageError",
    "ExpiringValue",
    "InMemoryStorage",
]
