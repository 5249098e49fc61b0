"""``hops_tpu_torch.telemetry`` — metrics registry, span timers and
request tracing (counterpart of ``hops_tpu/telemetry``).

- :mod:`~hops_tpu_torch.telemetry.metrics` — thread-safe, label-aware
  ``Counter`` / ``Gauge`` / ``Histogram`` in a process-global
  ``REGISTRY``, host-tagged like ``runtime/logging.py``.
- :mod:`~hops_tpu_torch.telemetry.spans` — ``with span(...)`` /
  ``@timed`` block timers feeding histograms; ``StepTimer`` for
  training loops.
- :mod:`~hops_tpu_torch.telemetry.tracing` — W3C-style distributed
  request tracing.
- :mod:`~hops_tpu_torch.telemetry.export` — Prometheus and JSON
  exposition (the ``/metrics`` and ``/debug`` routes of every serving).
- :mod:`~hops_tpu_torch.telemetry.workload` — workload capture, replay
  and scenario synthesis.
"""
