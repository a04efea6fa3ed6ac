"""Tracing / profiling, the counterpart of ``adalog_tpu.utils.profiling``.

The reference has no profiling beyond AverageMeter batch times (SURVEY.md §5).
Here: accumulating phase timers (the device synchronized at the end of each
phase) and a ``torch.profiler`` trace of the host and the CUDA device,
written as a Chrome trace that Perfetto and TensorBoard open.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

log = logging.getLogger("adalog_tpu_torch")


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulating named phase timer; each phase ends with a
    ``torch.cuda.synchronize`` when CUDA is in use, so a phase's time
    includes the device work it queued."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"  {name:<32s} {self.totals[name]:8.2f}s x{self.counts[name]}"
                 for name in sorted(self.totals, key=self.totals.get,
                                    reverse=True)]
        return "phase timings:\n" + "\n".join(lines)

    def log_report(self):
        log.info("%s", self.report())


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the host and (where there is one) the CUDA device into
    ``logdir/trace.json``, a Chrome trace that Perfetto and TensorBoard's
    profile plugin open."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("device trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in traces."""
    with torch.profiler.record_function(name):
        yield
