"""The runner (port of `kungfu_tpu/runner/`): kfrun's launcher
(`python -m kungfu_tpu_torch.runner.cli`) in its simple, watch and
monitored modes, warm standbys, card-slot and CPU-affinity plans, the
SSH fan-out, and the worker side of the environment contract."""

from kungfu_tpu_torch.runner.env import WorkerConfig, parse_config_from_env, worker_env

__all__ = ["WorkerConfig", "parse_config_from_env", "worker_env"]
