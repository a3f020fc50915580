"""Per-stage device-time attribution from a ``torch.profiler`` trace.

The port of the JAX package's ``utils/profiling.py``. ``profile_stages(run)``
traces one call of ``run()`` under ``torch.profiler`` (CUDA activity when
the device is the card; the window ends in a synchronize so the device
timeline is complete), exports the trace as Chrome JSON and parses it with
``parse_device_trace``, the pure parser, into a per-stage millisecond
breakdown (:class:`DeviceProfile`).

Device rows are the trace's events whose ``cat`` is torch's kernel, memcpy
or memset category. A trace with none of those (a CPU-only window, or a
trace from another profiler) falls back to the JAX parser's rules: the
processes named like a device, else pid 3, else the pid with the most event
time. Nested events are charged their self time. Stages are a regex over
the event name, first match wins; each stage's durations are also kept per
occurrence in timestamp order (occurrence k of a per-bounce kernel inside
one frame is bounce k).
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
import re
import shutil
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

# Default stage classification, first match wins: the port's kernels by
# their CUDA function names, then torch's own kernels (copies and memsets,
# indexing, reductions and scans, elementwise passes).
DEFAULT_STAGES: Sequence[Tuple[str, str]] = (
    ("path", r"urt_path"),
    ("trace_kernel", r"urt_trace"),
    ("env", r"urt_sky_tap"),
    ("rng", r"urt_uniform|urt_bounce_rows"),
    ("denoise", r"urt_atrous"),
    ("copy", r"Memcpy|Memset|copy|CatArray"),
    ("index", r"index|gather|scatter"),
    ("reduce", r"reduce_kernel|scan"),
    ("elementwise", r"elementwise"),
)

# torch.profiler's Chrome-trace categories of device work.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_DEVICE_NAME_RE = re.compile(r"/device:|TPU|Device|XLA_OP", re.IGNORECASE)


@dataclasses.dataclass
class DeviceProfile:
    """Parsed device timeline for one traced region."""

    total_ms: float                      # sum of device event self times
    stages_ms: Dict[str, float]          # stage -> device ms (incl. "other")
    per_occurrence_ms: Dict[str, List[float]]  # stage -> durations, ts order
    top_ops: List[Tuple[str, float, int]]      # (name, ms, count), desc

    def report(self) -> str:
        lines = [f"device total {self.total_ms:9.3f} ms"]
        for name, ms in sorted(self.stages_ms.items(), key=lambda kv: -kv[1]):
            line = f"  {name:<20} {ms:9.3f} ms"
            occ = self.per_occurrence_ms.get(name)
            if occ and 1 < len(occ) <= 16:
                line += "  [" + ", ".join(f"{d:.2f}" for d in occ) + "]"
            lines.append(line)
        return "\n".join(lines)


def find_trace_file(logdir: str) -> Optional[str]:
    """Newest ``*.trace.json`` or ``*.trace.json.gz`` under ``logdir``
    (searched recursively)."""
    hits = [p for pat in ("*.trace.json.gz", "*.trace.json")
            for p in glob.glob(os.path.join(logdir, "**", pat),
                               recursive=True)]
    return max(hits, key=os.path.getmtime) if hits else None


def _load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", data if isinstance(data, list) else [])


def _device_pids(events: Sequence[dict]) -> List[int]:
    """Device-timeline process ids of a trace without device categories:
    process_name metadata matching a device-ish pattern; then pid 3; then
    the pid with the largest total event duration."""
    names: Dict[int, str] = {}
    durs: Dict[int, float] = {}
    for ev in events:
        pid = ev.get("pid")
        if pid is None:
            continue
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            names[pid] = str(ev.get("args", {}).get("name", ""))
        elif ev.get("ph") == "X":
            durs[pid] = durs.get(pid, 0.0) + float(ev.get("dur", 0.0))

    matched = [p for p, n in names.items() if _DEVICE_NAME_RE.search(n)
               and durs.get(p, 0.0) > 0.0]
    if matched:
        return sorted(matched)
    if durs.get(3, 0.0) > 0.0:
        return [3]
    if durs:
        return [max(durs, key=durs.get)]
    return []


def _device_events(events: Sequence[dict]) -> List[dict]:
    spans = [ev for ev in events if ev.get("ph") == "X"]
    by_cat = [ev for ev in spans if ev.get("cat") in DEVICE_CATS]
    if by_cat:
        return by_cat
    pids = set(_device_pids(events))
    return [ev for ev in spans if ev.get("pid") in pids]


def parse_device_trace(logdir_or_file: str,
                       stages: Sequence[Tuple[str, str]] = DEFAULT_STAGES,
                       ) -> DeviceProfile:
    """Parse a profiler trace into a per-stage device-time breakdown.

    Args:
      logdir_or_file: a directory holding a ``*.trace.json(.gz)`` or the
        trace file itself.
      stages: ordered (stage_name, regex) pairs; first match classifies an
        event, unmatched events land in "other".
    """
    path = logdir_or_file
    if os.path.isdir(path):
        found = find_trace_file(path)
        if found is None:
            raise FileNotFoundError(f"no *.trace.json(.gz) under {path}")
        path = found

    # Self time per event: rows may nest (an annotation around kernels), so
    # walk each (pid, tid) row in start order with a stack of open
    # intervals and subtract each directly nested child from its parent.
    rows: Dict[Tuple[int, int], List[dict]] = {}
    for ev in _device_events(_load_events(path)):
        rows.setdefault((ev.get("pid"), ev.get("tid", 0)), []).append(ev)

    compiled = [(name, re.compile(pat)) for name, pat in stages]
    stages_ms: Dict[str, float] = {}
    timeline: Dict[str, List[Tuple[float, float]]] = {}
    ops: Dict[str, Tuple[float, int]] = {}
    total = 0.0

    def emit(name: str, ts: float, self_us: float) -> None:
        nonlocal total
        dur_ms = max(self_us, 0.0) / 1000.0
        total += dur_ms
        ms, cnt = ops.get(name, (0.0, 0))
        ops[name] = (ms + dur_ms, cnt + 1)
        stage = next((s for s, creg in compiled if creg.search(name)),
                     "other")
        stages_ms[stage] = stages_ms.get(stage, 0.0) + dur_ms
        timeline.setdefault(stage, []).append((ts, dur_ms))

    for revents in rows.values():
        revents.sort(key=lambda e: (float(e.get("ts", 0.0)),
                                    -float(e.get("dur", 0.0))))
        stack: List[List] = []  # [end_ts, name, start_ts, self_dur_us]
        for ev in revents:
            ts = float(ev.get("ts", 0.0))
            dur = float(ev.get("dur", 0.0))
            while stack and stack[-1][0] <= ts + 1e-9:
                rec = stack.pop()
                emit(rec[1], rec[2], rec[3])
            if stack:
                stack[-1][3] -= dur  # child span leaves parent's self time
            stack.append([ts + dur, str(ev.get("name", "")), ts, dur])
        while stack:
            rec = stack.pop()
            emit(rec[1], rec[2], rec[3])

    per_occ = {s: [d for _, d in sorted(v)] for s, v in timeline.items()}
    top = sorted(((n, ms, c) for n, (ms, c) in ops.items()),
                 key=lambda x: -x[1])[:20]
    return DeviceProfile(total_ms=total, stages_ms=stages_ms,
                         per_occurrence_ms=per_occ, top_ops=top)


def profile_stages(run, logdir: Optional[str] = None,
                   stages: Sequence[Tuple[str, str]] = DEFAULT_STAGES,
                   device="cuda") -> DeviceProfile:
    """Trace ``run()`` with torch.profiler and return its device breakdown.

    ``run`` should launch work whose kernels are already built. With a
    CUDA ``device`` (the default) the profiler records the card's activity
    and the window ends with a synchronize of that device; it raises where
    torch sees no CUDA device. ``device="cpu"`` records host activity only
    (the breakdown is then of host ops). The Chrome trace is written to
    ``logdir`` (kept) or to a temporary directory (removed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("profile_stages(device='cuda'): torch sees no "
                               "CUDA device")
        activities.append(ProfilerActivity.CUDA)
    own = logdir is None
    logdir = logdir or tempfile.mkdtemp(prefix="urt_prof_")
    try:
        with profile(activities=activities) as prof:
            run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        path = os.path.join(logdir, "torch.trace.json")
        prof.export_chrome_trace(path)
        return parse_device_trace(path, stages)
    finally:
        if own:
            shutil.rmtree(logdir, ignore_errors=True)
