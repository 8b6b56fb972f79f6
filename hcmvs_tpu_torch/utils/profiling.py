"""Stage timers, the end-of-run report and device traces (port of
``hcmvs_tpu/utils/profiling.py``; ref: the reference's TD_TIMER scoped
timers, e.g. frame_main/libs/MVS/SceneDensify.cpp:760,3008,3267, and
Util::LogMemoryInfo at shutdown, DensifyPointCloud.cpp:362).

``stage_timer`` accumulates wall seconds per stage name into one report
for the process (total, calls, max, and each call's seconds in order).
Its ``block_on`` takes a device (or a tensor, whose device is used): on a
CUDA device the timer synchronises it before reading the clock, so the
span covers the work queued inside the block.
The report's memory line is ``torch.cuda.max_memory_allocated``.
``trace`` writes a ``torch.profiler`` Chrome trace of a block (the JAX
package's ``jax.profiler`` trace; view it in Perfetto or
chrome://tracing).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

_STAGES: Dict[str, dict] = defaultdict(
    lambda: {"total_s": 0.0, "calls": 0, "max_s": 0.0, "each_s": []})

_LOGGER: Optional[logging.Logger] = None


def get_logger() -> logging.Logger:
    """The port's shared logger (INFO, to stderr)."""
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("hcmvs_tpu_torch")
        logger.propagate = False
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname).1s] %(message)s", datefmt="%H:%M:%S"))
        logger.addHandler(sh)
        logger.setLevel(logging.INFO)
        _LOGGER = logger
    return _LOGGER


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a device, a device string
    or a tensor); nothing to wait for on the CPU."""
    if torch.is_tensor(device):
        device = device.device
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage_timer(name: str, block_on=None, log: bool = False):
    """Scoped timer accumulating into the stage report; ``block_on`` (a
    device or tensor) is synchronised before the clock is read.  Yields a
    dict whose ``"seconds"`` is set when the block ends."""
    t0 = time.perf_counter()
    span = {}
    try:
        yield span
    finally:
        if block_on is not None:
            synchronize(block_on)
        dt = time.perf_counter() - t0
        span["seconds"] = dt
        s = _STAGES[name]
        s["total_s"] += dt
        s["calls"] += 1
        s["max_s"] = max(s["max_s"], dt)
        s["each_s"].append(dt)
        if log:
            get_logger().info("%s: %.3fs", name, dt)


def add_bytes(name: str, n: int) -> None:
    """Add ``n`` bytes to stage ``name``'s ``bytes`` (what a collective
    moved, beside its seconds)."""
    s = _STAGES[name]
    s["bytes"] = s.get("bytes", 0) + int(n)


def reset_report() -> None:
    _STAGES.clear()


def report() -> Dict[str, dict]:
    """Snapshot of accumulated stage timings."""
    return {k: dict(v, each_s=list(v["each_s"])) for k, v in _STAGES.items()}


def device_memory_stats() -> Dict[str, int]:
    """Device memory of the current CUDA device (empty without one)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated()}


def log_report() -> str:
    """Format and log the per-stage report (the shutdown summary)."""
    lines = ["stage timing report:"]
    for name, s in sorted(_STAGES.items(), key=lambda kv: -kv[1]["total_s"]):
        lines.append(f"  {name:<32} {s['total_s']:9.3f}s "
                     f"x{int(s['calls']):<4} max {s['max_s']:.3f}s")
    mem = device_memory_stats()
    if mem:
        lines.append(f"  device memory: in_use="
                     f"{mem['bytes_in_use'] / 1e6:.1f}MB peak="
                     f"{mem['peak_bytes_in_use'] / 1e6:.1f}MB")
    msg = "\n".join(lines)
    get_logger().info(msg)
    return msg


@contextlib.contextmanager
def trace(log_dir: str = "hcmvs_trace"):
    """``torch.profiler`` around a block (the host's operations, and the
    card's kernels and copies when CUDA is up), written as a Chrome trace
    ``<log_dir>/trace_<pid>.json`` when the block ends; yields
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))
