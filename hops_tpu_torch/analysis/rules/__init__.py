"""Built-in graftlint rules — importing this package registers them.
(counterpart of ``hops_tpu/analysis/rules/__init__.py``)

Each module registers one rule with :func:`hops_tpu_torch.analysis.engine.register`:

- :mod:`.adhoc_http_server` — ``adhoc-http-server``
- :mod:`.jit_purity` — ``jit-purity``
- :mod:`.donation` — ``use-after-donation``
- :mod:`.host_sync` — ``host-sync-in-loop``
- :mod:`.lock_discipline` — ``lock-discipline``
- :mod:`.metric_consistency` — ``metric-name-consistency``
- :mod:`.debug_surfaces` — ``debug-surface-docs``
- :mod:`.hardcoded_loopback` — ``hardcoded-loopback``
- :mod:`.swallowed_exception` — ``swallowed-exception``
- :mod:`.naked_retry` — ``naked-retry-loop``
- :mod:`.json_on_hot_wire` — ``json-on-hot-wire``
- :mod:`.blocking_call` — ``blocking-call-no-deadline``
- :mod:`.relay_json_roundtrip` — ``relay-json-roundtrip``
- :mod:`.unbounded_priority_queue` — ``unbounded-priority-queue``
- :mod:`.lock_order_inversion` — ``lock-order-inversion``
- :mod:`.blocking_under_lock` — ``blocking-under-lock``
- :mod:`.event_loop_stall` — ``event-loop-stall``
- :mod:`.wall_clock_deadline` — ``wall-clock-deadline``
"""

from hops_tpu_torch.analysis.rules import (  # noqa: F401 — registration side effects
    adhoc_http_server,
    blocking_call,
    blocking_under_lock,
    debug_surfaces,
    donation,
    event_loop_stall,
    hardcoded_loopback,
    host_sync,
    jit_purity,
    json_on_hot_wire,
    lock_discipline,
    lock_order_inversion,
    metric_consistency,
    naked_retry,
    relay_json_roundtrip,
    swallowed_exception,
    unbounded_priority_queue,
    wall_clock_deadline,
)
