"""Tracing and step timing.

Counterpart of masked_diffusion_tpu/utils/profiling.py, on torch.profiler:

  * trace(profile_dir, rank, device) — a torch.profiler window (CPU
    activity, and CUDA activity when the device is a card) that writes one
    Chrome trace per rank, profile_dir/trace_rank{rank}.json, loadable in
    Perfetto or chrome://tracing. Under torchrun every rank writes its own.
    Beside the trace events the file holds `mdt_summary` (summarize): the
    window's wall ms, the device's busy ms and idle share, and the
    collectives' host and device ms. A falsy profile_dir makes it a no-op;
  * device_rows — the window's device kernels and copies, by name (the
    reading tools/profile_train.py reports);
  * StepTimer — a copy of the JAX package's wall-clock step timer.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from typing import Dict, List, Optional

#: the name of the summary key in a trace file
SUMMARY_KEY = "mdt_summary"


@contextlib.contextmanager
def trace(profile_dir: Optional[str], rank: int = 0, device="cpu"):
    """Profile the block; no-op when profile_dir is falsy. Yields the
    torch.profiler.profile (None when off). On a card the block's work is
    synchronized before the window closes, so the trace holds all of it and
    the wall time covers it. The trace is written only when the block ends
    without an exception."""
    if not profile_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    # one cycle (no schedule); acc_events keeps its events for summarize
    with profile(activities=activities, acc_events=True) as prof:
        t0 = time.perf_counter()
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
        wall_s = time.perf_counter() - t0
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_rank{rank}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    prof.export_chrome_trace(tmp)
    _append_key(tmp, SUMMARY_KEY, summarize(prof, wall_s, cuda))
    os.replace(tmp, path)


def _append_key(path: str, key: str, value) -> None:
    """Add key: value to the JSON object in the file, in place: the object's
    closing brace is rewritten, the trace events before it are not parsed."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        end = f.tell()
        f.seek(max(0, end - 4096))
        tail = f.read()
        close = tail.rindex(b"}")
        f.seek(end - len(tail) + close)
        f.truncate()
        f.write(b", " + json.dumps(key).encode() + b": " + json.dumps(value).encode() + b"}\n")


def device_rows(prof):
    """[(name, device ms total, calls)] of the window's kernels and copies,
    the longest first."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        # a user annotation's device range (e.g. Optimizer.step#AdamW.step)
        # covers kernels that are listed on their own
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) \
                or "#" in e.key:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        rows.append((e.key, t / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def _is_collective(name: str) -> bool:
    """A c10d collective's span on the host (gloo:all_reduce, nccl:all_reduce,
    ...) or an NCCL kernel on the device."""
    return name.lower().startswith(("gloo:", "nccl"))


def _union_ms(spans) -> float:
    """The length of the union of (start, end) spans in microseconds, in ms."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def summarize(prof, wall_s: float, cuda: bool) -> dict:
    """The window in numbers: wall ms, device busy ms (device_rows' sum),
    the device's idle share (None without CUDA activity), kernels run, the
    collectives on the host (the c10d spans, enqueue to completion, which is
    what a gloo all-reduce costs: their summed ms, calls, and in_flight_ms,
    the wall time with at least one in flight, since queued buckets
    overlap) and on the device (NCCL kernels' ms), and the top device
    rows."""
    from torch.autograd import DeviceType

    rows = device_rows(prof) if cuda else []
    busy = sum(r[1] for r in rows)
    wall_ms = 1e3 * wall_s
    host = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and _is_collective(e.name):
            entry = host.setdefault(e.name, {"ms": 0.0, "calls": 0, "spans": []})
            entry["ms"] += (e.time_range.end - e.time_range.start) / 1e3
            entry["calls"] += 1
            entry["spans"].append((e.time_range.start, e.time_range.end))
    for entry in host.values():
        entry["in_flight_ms"] = _union_ms(entry.pop("spans"))
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms) if cuda and wall_ms > 0 else None,
        "device_kernels": sum(r[2] for r in rows),
        "collectives_host_ms": host,
        "collectives_device_ms": {n: {"ms": t, "calls": c} for n, t, c in rows
                                  if _is_collective(n)},
        "top_device": [{"name": n[:160], "ms": t, "calls": c} for n, t, c in rows[:20]],
    }


def read_trace(path: str) -> dict:
    """A trace file of trace(): {'events': the trace events, 'summary':
    its mdt_summary}."""
    with open(path) as f:
        data = json.load(f)
    return {"events": data.get("traceEvents", []), "summary": data.get(SUMMARY_KEY, {})}


class StepTimer:
    """Wall-clock step timer. Call tick() once per step; summary() returns
    mean/p50/p95 seconds and steps/sec for the metrics sink. A copy of
    masked_diffusion_tpu/utils/profiling.py:StepTimer."""

    def __init__(self, capacity: int = 1000):
        self.capacity = capacity
        self._samples: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            if len(self._samples) >= self.capacity:
                self._samples.pop(0)
            self._samples.append(now - self._last)
        self._last = now

    def reset_epoch(self) -> None:
        self._last = None

    def summary(self) -> Dict[str, float]:
        if not self._samples:
            return {}
        s = sorted(self._samples)
        mean = statistics.mean(s)
        return {
            "step_time_mean_s": mean,
            "step_time_p50_s": s[len(s) // 2],
            "step_time_p95_s": s[min(len(s) - 1, int(len(s) * 0.95))],
            "steps_per_sec": (1.0 / mean) if mean > 0 else 0.0,
        }
