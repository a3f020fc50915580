"""Per-stage timing and throughput counters.

The reference has no profiling at all (SURVEY.md aux table); this provides
the per-stage timers (build/trace/shade/accumulate) and Mrays/s counters,
plus a hook into ``torch.profiler`` for deep traces. The port of the JAX
package's ``utils/timing.py``: where that module synchronizes by fetching a
value, this one waits for the CUDA devices that hold the stage's results
(``torch.cuda.synchronize``); CPU tensors are ready when their op returns.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional


def device_sync(tree) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree`` (a tensor,
    or nested lists/tuples/dicts of them). Nothing to wait for on the CPU."""
    import torch

    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Accumulating wall-clock timer keyed by stage name.

    Use ``block=True`` (default) to synchronize before reading the clock so
    device work is attributed to the stage that launched it: the stage
    appends its results to ``result_holder`` and the timer waits for their
    devices. For true per-stage DEVICE time use
    utils/profiling.profile_stages, which parses the profiler's device
    timeline.
    """

    def __init__(self, block: bool = True):
        self.block = block
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result_holder: Optional[List] = None):
        t0 = time.perf_counter()
        yield
        if self.block and result_holder:
            device_sync(result_holder)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<16} {total*1000:9.2f} ms total "
                         f"({n}x, {total/n*1000:.2f} ms avg)")
        return "\n".join(lines)


def mrays_per_sec(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-12) / 1e6


def measure_throughput(fn, *args, warmup: int = 1, iters: int = 3,
                       n_rays: Optional[int] = None):
    """Time a callable; returns (best_seconds, mrays or None).

    Each call is followed by a wait for the devices of its result, so the
    time covers the device work and not only its launch.
    """
    for _ in range(warmup):
        device_sync(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        device_sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, (mrays_per_sec(n_rays, best) if n_rays else None)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """torch.profiler trace context: records host activity, and the card's
    where torch sees one, and writes ``<logdir>/torch.trace.json`` (a Chrome
    trace; view in Perfetto or chrome://tracing) when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        for card in range(torch.cuda.device_count()):
            torch.cuda.synchronize(card)
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "torch.trace.json"))
