"""Structured stage logging + per-stage timers.

A copy of ``drone_image_stitch_cpp_tpu/runtime/logging.py``:
``[Stage] message key=value`` lines (the reference's de-facto metrics
schema, e.g. visual_flight_grouper.cpp:362-373), an optional JSONL sink,
wall-clock stage timers, and the profiler hook :func:`device_trace`
(``torch.profiler`` in place of ``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class StageLogger:
    """`[Stage] message key=value ...` lines + optional JSONL sink."""

    jsonl_path: Optional[str] = None
    verbose: bool = True
    _records: List[dict] = field(default_factory=list)

    def log(self, stage: str, message: str, **fields):
        if self.verbose:
            kv = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
            print(f"[{stage}] {message}" + (f" {kv}" if kv else ""))
        rec = {"ts": time.time(), "stage": stage, "msg": message, **fields}
        self._records.append(rec)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")

    @contextlib.contextmanager
    def timer(self, stage: str, what: str, sync=None):
        """Wall-clock a block. ``sync``: optional callable run before each
        clock read (``torch.cuda.synchronize`` on the card, so the time
        covers the device work the block enqueued)."""
        if sync is not None:
            sync()
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        dt = time.perf_counter() - t0
        self.log(stage, f"{what} done", seconds=round(dt, 3))

    def timings(self) -> Dict[str, float]:
        return {r["msg"]: r["seconds"] for r in self._records
                if "seconds" in r}


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4g}"
    return v


_GLOBAL = StageLogger()


def get_logger() -> StageLogger:
    return _GLOBAL


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None):
    """``torch.profiler`` trace around a block (no-op without a directory):
    CPU activity, and CUDA kernels and copies when a card is visible; on
    exit one Chrome trace, ``trace-<UTC timestamp>-<pid>.json``, is
    written into ``trace_dir`` (open it in Perfetto or chrome://tracing).
    """
    if not trace_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace-{stamp}-{os.getpid()}.json"))
