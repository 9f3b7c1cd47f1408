"""Observability of the port: Prometheus metrics (``metrics.py``), the
span-tree latency aggregation (``metrics_layer.py``), tracing and OTLP
span export (``tracing.py``, ``otlp.py``), request ids and the
``/debug/stats`` walk (``device_plane.py``), and the tenant usage
observatory (``usage.py``).

Counterpart of part of ``limitador_tpu/observability/``; the device-plane
recorder, the native telemetry plane, the signal bus, the flight
recorder, the serving model and the pod plane wait for their slices
(``ROADMAP.md``).
"""
