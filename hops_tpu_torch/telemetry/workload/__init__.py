"""Trace-driven workload capture, replay, and scenario synthesis
(a copy of ``hops_tpu/telemetry/workload/``: the package imports no JAX, and
the port imports nothing of the JAX package).

Tracing makes individual requests observable; this package makes the
*workload itself* — the arrival process, tenant mix, and prompt/entity
shapes — a first-class, replayable artifact. Three pieces, one schema:

- :mod:`~hops_tpu_torch.telemetry.workload.capture` — a
  :class:`WorkloadRecorder` tapped into the fleet router and every
  serving endpoint records, per request, the monotonic+wall arrival
  time, tenant, endpoint, payload (full body below a size cap,
  shape-summary above it), entity-ID keys, LM prompt lengths, and the
  outcome (status, latency, trace-id cross-link) into a versioned
  append-only JSONL segment stream with rotation and a
  checkpoint-style size+SHA-256 manifest. Armed via
  ``HOPS_TPU_WORKLOAD_CAPTURE=<dir>`` or
  ``POST /admin/capture/start``; status at ``GET /debug/workload``.
- :mod:`~hops_tpu_torch.telemetry.workload.replay` — verifies and loads an
  artifact (bitrot refuses loudly), deterministically re-materializes
  capped payloads from a seed, and re-issues the stream open-loop
  against any live configuration at ``--replay-speed`` multiples,
  reporting recorded-vs-replayed status mix / throughput / latency and
  arrival-fidelity stats.
- :mod:`~hops_tpu_torch.telemetry.workload.synthesize` — produces artifacts
  in the same schema for what capture can't see: diurnal ramps,
  post-rollout thundering herds, hot-key entity skew, and adversarial
  tenant spray — so chaos tests and benches consume captured and
  synthetic workloads through one code path.

Stdlib-only: the capture tap lives on serving-host and router hot
paths that must never import torch. Disabled capture costs one module
global read (``capturing()``), the same contract tracing and
faultinject keep. See docs/operations.md "Workload capture & replay".
"""

from hops_tpu_torch.telemetry.workload.capture import (  # noqa: F401
    SCHEMA,
    WorkloadRecorder,
    admin_action,
    capturing,
    crash_flush,
    record_request,
    start_capture,
    status,
    stop_capture,
)
from hops_tpu_torch.telemetry.workload.replay import (  # noqa: F401
    ReplayReport,
    WorkloadCorruptError,
    issued_stream,
    load_artifact,
    materialize_body,
    materialize_payload,
    replay,
)
from hops_tpu_torch.telemetry.workload.synthesize import (  # noqa: F401
    SCENARIOS,
    synthesize,
)
