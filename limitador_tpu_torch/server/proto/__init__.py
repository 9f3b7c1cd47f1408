"""Generated protobuf bindings: Envoy RLS v3, Kuadrant v1, the
replication protocol (``limitador.service.distributed.v1``) and gRPC
server reflection (``grpc.reflection.v1alpha``).

Counterpart of ``limitador_tpu/server/proto/``. The ``*_pb2`` modules are
copies of the JAX package's generated files with two changes: they import
each other relatively (flattened into this one directory, so nothing goes
on ``sys.path``), and they register in the port's own descriptor pool
(``_pool.POOL``). Both keep the port's message classes its own even when
both packages are imported in one process.
"""

from . import (
    base_pb2,
    distributed_pb2,
    kuadrant_rls_pb2,
    ratelimit_pb2,
    reflection_pb2,
    rls_pb2,
)

__all__ = [
    "base_pb2", "distributed_pb2", "kuadrant_rls_pb2", "ratelimit_pb2",
    "reflection_pb2", "rls_pb2",
]
