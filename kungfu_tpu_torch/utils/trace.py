"""The scoped tracer's old home: re-exports `telemetry/tracing.py`.

Port of `kungfu_tpu/utils/trace.py`. Every ``utils.trace`` call site
(transport, collective walks, the scheduler, elastic resize phases)
records into the one telemetry ring, so its spans show up in the
``/trace`` Chrome-trace export and ``telemetry.dump()`` beside the
metrics and audit records.
"""

from __future__ import annotations

from kungfu_tpu_torch.telemetry.tracing import (  # noqa: F401
    MAX_EVENTS,
    TraceEvent,
    chrome_trace,
    chrome_trace_json,
    clear,
    current_step,
    events,
    export_chrome,
    full_events,
    instant,
    record,
    span,
    step_scope,
    summary_ms,
)
