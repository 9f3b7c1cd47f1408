"""Replication between nodes: the CRDT gossip broker.

Counterpart of ``limitador_tpu/storage/distributed/``, holding only the
``Broker`` that the replicated device table (``device/replicated.py``)
gossips through. The host-memory ``distributed`` storage
(``CrInMemoryStorage``) is not ported yet.
"""

from .broker import Broker

__all__ = ["Broker"]
