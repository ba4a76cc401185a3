"""Profiling / tracing helpers; counterpart of
cvpce_tpu/utils/profiling.py.

The same batch-time capture (`StepTimer`) and timestamped marker
(`print_time`), with torch.profiler in place of the jax profiler:
`trace` records host operations and, on a card, its CUDA kernels and
copies, and writes a Chrome trace (TensorBoard's torch profiler plugin
and Perfetto read it); `annotate` names a region of it.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity

from . import resolve_device


@contextlib.contextmanager
def trace(log_dir: str, device="cuda") -> Iterator[torch.profiler.profile]:
    """Profile the block: host operations, and CUDA activity when
    `device` is a card; yields the running `torch.profiler.profile` (its
    `key_averages()` sums the block by name once it ends) and writes its
    Chrome trace, `<host>_<pid>.<stamp>.pt.trace.json`, into `log_dir`."""
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in profiler traces."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Per-step wall-clock recorder (the reference's batch_times list)."""

    def __init__(self) -> None:
        self.times: List[float] = []
        self._start: Optional[float] = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is None:
            raise RuntimeError("StepTimer.stop() before start()")
        elapsed = time.perf_counter() - self._start
        self.times.append(elapsed)
        self._start = None
        return elapsed

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "mean_s": float(t.mean()),
            "p50_s": float(np.median(t)),
            "p95_s": float(np.quantile(t, 0.95)),
            "steps": len(t),
        }


def print_time() -> None:
    """Timestamped marker print (cvpce/utils.py:313-314)."""
    print(f"-- {time.asctime(time.localtime())} --")
