"""Observability of the port: the tenant usage observatory.

Counterpart of part of ``limitador_tpu/observability/``; metrics, tracing
and the device plane wait for the observability slice (``ROADMAP.md``).
"""
