"""Elastic training (port of `kungfu_tpu/elastic/`): the config server,
the elastic dataset, the step-based schedule and ElasticState."""

from kungfu_tpu_torch.elastic.configserver import ConfigServer
from kungfu_tpu_torch.elastic.dataset import ElasticDataset
from kungfu_tpu_torch.elastic.schedule import (
    StepBasedSchedule,
    parse_schedule,
    schedule_target,
)
from kungfu_tpu_torch.elastic.state import ElasticState

__all__ = [
    "ConfigServer",
    "ElasticDataset",
    "ElasticState",
    "StepBasedSchedule",
    "parse_schedule",
    "schedule_target",
]
