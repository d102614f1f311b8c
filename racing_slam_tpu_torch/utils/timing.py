"""Stage timers, a JSONL metrics sink and profiler capture (port of
racing_slam_tpu/utils/timing.py).

CUDA work is queued asynchronously, so a host clock sees the enqueue, not
the work. `time_it` and `StageTimer.stage(block_on=...)` therefore wait for
the devices of the tensors they are handed (`torch.cuda.synchronize` on
each CUDA device among them) before reading the clock; CPU tensors need no
wait. `profiler_trace` records a `torch.profiler` trace.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree) -> None:
    """Wait for every CUDA device that holds a tensor of `tree` (nested
    tuples, lists and dicts)."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_it(name: str, fn, block: bool = True):
    """Print fn()'s wall time in ms, after its tensors are ready when
    `block`; returns fn's result."""
    t0 = time.perf_counter()
    out = fn()
    if block:
        block_until_ready(out)
    print(f"{name}: {(time.perf_counter() - t0) * 1e3:.2f} ms")
    return out


class StageTimer:
    """Accumulate wall-clock per named stage; report mean/total."""

    def __init__(self):
        self._acc = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time the block; with `block_on` (tensors), after they are ready."""
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        self._acc[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        return {k: {"mean_ms": 1e3 * sum(v) / len(v), "total_ms": 1e3 * sum(v), "count": len(v)}
                for k, v in self._acc.items()}

    def report(self) -> str:
        return "\n".join(
            f"{k:>16}: {s['mean_ms']:8.2f} ms avg x{s['count']:<5d} ({s['total_ms']:.0f} ms total)"
            for k, s in sorted(self.summary().items()))


class MetricsSink:
    """Append-only JSONL of per-frame metrics."""

    def __init__(self, path: str | Path):
        self._f = open(path, "a", buffering=1)

    def write(self, record: dict) -> None:
        self._f.write(json.dumps({k: _jsonable(v) for k, v in record.items()}) + "\n")

    def close(self):
        self._f.close()


def _jsonable(v):
    """Tensors and numpy values as JSON numbers or lists."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.item() if v.dim() == 0 else v.tolist()
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


@contextlib.contextmanager
def profiler_trace(logdir: str | Path):
    """Record a torch.profiler trace of the block (host, and the card when
    there is one) into `logdir`/trace.json (chrome://tracing, Perfetto).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
