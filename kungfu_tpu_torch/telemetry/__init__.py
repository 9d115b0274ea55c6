"""Telemetry of the host plane. Port of `kungfu_tpu/telemetry/`, so far
its logger (`log`); metrics, tracing and the rest come with the
telemetry slice."""
