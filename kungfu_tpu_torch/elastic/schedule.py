"""Step-based elastic schedules: "np:steps,np:steps,..." driving resizes.

Port of `kungfu_tpu/elastic/schedule.py`, with its
`kungfu_schedule_proposals_total` counter and the memory plane's grow
deferral: rank 0 defers a scheduled grow while its measured headroom is
at or below the pressure line (`kungfu_memory_grow_deferrals_total`),
and proposes it when headroom is unmeasured. Capability parity:
KungfuStepBasedSchedule (ops/cpu/elastic.cpp:16-81) +
KungFuElasticTrainHook (hooks/elastic.py:14-88) — a declarative schedule
of cluster sizes by global step; rank 0 publishes the target size to the
config server at each boundary and every worker resizes via consensus.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from kungfu_tpu_torch import api
from kungfu_tpu_torch.telemetry import log


def parse_schedule(spec: str) -> List[Tuple[int, int]]:
    """"2:10,4:20,1:5" -> [(2,10), (4,20), (1,5)]: np for a span of steps."""
    out: List[Tuple[int, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        np_s, _, steps_s = part.partition(":")
        n, steps = int(np_s), int(steps_s)
        if n <= 0 or steps <= 0:
            raise ValueError(f"bad schedule entry {part!r}: sizes/spans must be > 0")
        out.append((n, steps))
    if not out:
        raise ValueError(f"empty schedule: {spec!r}")
    return out


def schedule_target(schedule: List[Tuple[int, int]], step: int) -> Optional[int]:
    """Desired cluster size at `step`; None once the schedule is exhausted
    (training continues at the last size)."""
    off = 0
    for n, steps in schedule:
        if step < off + steps:
            return n
        off += steps
    return None


class StepBasedSchedule:
    """Drives propose_new_size from a schedule inside the elastic loop:

        sched = StepBasedSchedule("2:10,4:20,1:5")
        while not es.stopped():
            with es.scope():
                sched.maybe_propose(es.progress)
                ...
                es.end(1)

    Only rank 0 publishes; the resize itself still flows through the config
    server + consensus like any other elastic event.
    """

    REPROPOSE_AFTER = 10.0  # seconds before a non-landed proposal is resent

    def __init__(self, spec: str):
        self.schedule = parse_schedule(spec)
        self._last_proposed: Optional[int] = None
        self._proposed_at = 0.0

    def total_steps(self) -> int:
        return sum(steps for _, steps in self.schedule)

    def maybe_propose(self, step: int) -> Optional[int]:
        """Publish the scheduled size if the cluster isn't there yet;
        returns the size proposed (or None).

        _last_proposed is only recorded after propose_new_size SUCCEEDS on
        the acting rank 0: if the PUT fails or rank 0 detaches at the
        boundary, the next acting rank 0 re-proposes instead of the
        schedule silently skipping the resize. A proposal that was accepted
        but then lost (config-server restart) is also covered: while the
        observed cluster size stays off-target, the proposal is re-sent
        every REPROPOSE_AFTER seconds (rate-limited so the steady
        propose→consensus window doesn't spam the server)."""
        target = schedule_target(self.schedule, step)
        if target is None:
            return None
        if target == api.cluster_size():
            self._last_proposed = target  # landed; don't re-propose
            return None
        if api.current_rank() != 0:
            return None
        if (
            target == self._last_proposed
            and time.monotonic() - self._proposed_at < self.REPROPOSE_AFTER
        ):
            # proposed recently: the resize flows through the config-server
            # consensus in es.end(); give it time to land
            return None
        if target > api.cluster_size():
            try:
                from kungfu_tpu_torch.telemetry import memory as tmem

                ok, why = tmem.get_plane().grow_ok()
            except Exception:  # noqa: BLE001 - a broken memory plane never blocks a resize
                ok, why = True, "plane unavailable"
            if not ok:
                from kungfu_tpu_torch.telemetry import metrics

                metrics.counter(
                    "kungfu_memory_grow_deferrals_total",
                    "Scheduled grow proposals deferred because the "
                    "acting rank 0's measured memory headroom sat at "
                    "or below the pressure line",
                ).inc()
                log.warn("schedule: deferring grow to %d at progress %d: %s",
                         target, step, why)
                # rate-limit the re-check like a sent proposal, so a
                # pressured rank 0 logs once a window, not once a step
                self._last_proposed = target
                self._proposed_at = time.monotonic()
                return None
        try:
            api.propose_new_size(target)
        except OSError as e:
            # transient config-server blip: _last_proposed stays unset so
            # the very next maybe_propose call retries the PUT; warn so a
            # PERSISTENT failure is distinguishable from a spent schedule
            log.warn("propose_new_size(%d) failed (%s); will retry", target, e)
            return None
        from kungfu_tpu_torch.telemetry import metrics

        metrics.counter(
            "kungfu_schedule_proposals_total",
            "Cluster sizes proposed by the step-based schedule",
        ).inc()
        log.info("schedule proposed cluster size %d at progress %d", target, step)
        self._last_proposed = target
        self._proposed_at = time.monotonic()
        return target
