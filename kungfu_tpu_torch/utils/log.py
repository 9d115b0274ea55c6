"""The leveled logger, re-exported from kungfu_tpu_torch.telemetry.log
(port of `kungfu_tpu/utils/log.py`).

Same API (debug/info/warn/error with %-args, set_level, set_output)
plus structured key=value fields and ``echo()`` for CLI surfaces; level
honours KF_LOG_LEVEL with fallback to the legacy KF_CONFIG_LOG_LEVEL.
"""

from __future__ import annotations

from kungfu_tpu_torch.telemetry.log import (  # noqa: F401
    LEVELS,
    debug,
    echo,
    error,
    info,
    reset,
    set_level,
    set_output,
    warn,
    warning,
)
