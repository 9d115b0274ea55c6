"""The worker side of the runner contract (port of `kungfu_tpu/runner/`)."""
