"""Structured stage logging, the program's span recorder, and the profiler
hook.

A copy of ``drone_image_stitch_cpp_tpu/runtime/logging.py``:
``[Stage] message key=value`` lines (the reference's de-facto metrics
schema, e.g. visual_flight_grouper.cpp:362-373), an optional JSONL sink,
wall-clock stage timers, and the profiler hook :func:`device_trace`
(``torch.profiler`` in place of ``jax.profiler``).

Spans. :meth:`StageLogger.timer` (a stage, printed) and
:meth:`StageLogger.span` (a step inside one, silent) write one record
each, ``{ts, stage, msg: "<what> done", seconds, parent, ...}``:
``seconds`` unrounded, ``ts`` the epoch time read beside the closing
``perf_counter()`` (so ``ts - seconds`` is the start on the profiler's
clock), ``parent`` the ``msg`` of the enclosing open span of the same
thread (None at the top). A span takes its stage from that enclosing span
unless it is given one ("" when none is open), and carries its integer
counters.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class StageLogger:
    """`[Stage] message key=value ...` lines + optional JSONL sink."""

    jsonl_path: Optional[str] = None
    verbose: bool = True
    _records: List[dict] = field(default_factory=list)
    # per thread: the open spans' (stage, msg), innermost last
    _open: threading.local = field(default_factory=threading.local,
                                   repr=False, compare=False)

    def _open_spans(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def log(self, stage: str, message: str, **fields):
        if self.verbose:
            _print(stage, message, fields)
        self._write({"ts": time.time(), "stage": stage, "msg": message,
                     **fields})

    def _write(self, rec: dict):
        self._records.append(rec)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")

    def timer(self, stage: str, what: str, sync=None, **counters):
        """Wall-clock a stage and print its line. ``sync``: optional
        callable run before each clock read (``torch.cuda.synchronize`` on
        the card, so the time covers the device work the block enqueued).
        ``counters``: integers carried on the record and the line."""
        return _Span(self, stage, what, counters, sync, True)

    def span(self, what: str, stage: Optional[str] = None, **counters):
        """A step inside a stage: one ``"<what> done"`` record, no line,
        no synchronisation, no profiler range. ``with`` yields the
        counters dict, so the block can add counts it learns."""
        return _Span(self, stage, what, counters, None, False)


class _Span:
    """One timed block of :class:`StageLogger`; a record is written only
    when the block ends without an exception."""

    __slots__ = ("log", "stage", "msg", "counters", "sync", "echo",
                 "parent", "t0")

    def __init__(self, log, stage, what, counters, sync, echo):
        self.log, self.stage, self.msg = log, stage, f"{what} done"
        self.counters, self.sync, self.echo = counters, sync, echo

    def __enter__(self):
        stack = self.log._open_spans()
        self.parent = stack[-1] if stack else None
        if self.stage is None:
            self.stage = self.parent[0] if self.parent else ""
        if self.sync is not None:
            self.sync()
        stack.append((self.stage, self.msg))
        self.t0 = time.perf_counter()
        return self.counters

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self.sync is not None:
            self.sync()
        t1 = time.perf_counter()
        ts = time.time()
        self.log._open_spans().pop()
        if exc_type is not None:
            return False
        seconds = t1 - self.t0
        self.log._write({"ts": ts, "stage": self.stage, "msg": self.msg,
                         "seconds": seconds,
                         "parent": self.parent[1] if self.parent else None,
                         **self.counters})
        if self.echo and self.log.verbose:
            _print(self.stage, self.msg,
                   {"seconds": round(seconds, 3), **self.counters})
        return False


def _print(stage, message, fields):
    kv = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
    print(f"[{stage}] {message}" + (f" {kv}" if kv else ""))


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
    written into ``trace_dir`` (open it in Perfetto or chrome://tracing),
    with the block's span records as complete events of a "program spans"
    track on the profiler's clock, above the kernels they launched.
    """
    if not trace_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    n0 = len(_GLOBAL._records)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    path = os.path.join(trace_dir, f"trace-{stamp}-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    add_spans_to_chrome_trace(path, [r for r in _GLOBAL._records[n0:]
                                     if "seconds" in r])


_BASE_NS = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')


def add_spans_to_chrome_trace(path: str, records) -> int:
    """Insert span records into a Chrome trace written by
    ``torch.profiler`` as complete (``"X"``) events; returns how many.

    The profiler writes ``ts`` in microseconds after the epoch time of
    its ``baseTimeNanoseconds`` key (0 without one), so a record's epoch
    ``ts - seconds`` lands on the kernels' clock. The file is copied in
    chunks with the events first in its ``traceEvents`` list, never parsed
    whole (a multi-line run's trace is hundreds of MB)."""
    if not records:
        return 0
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(1 << 16)
        f.seek(max(0, size - (1 << 16)))
        tail = f.read()
    at = head.find(b'"traceEvents"')
    if at < 0:
        return 0
    found = _BASE_NS.search(head) or _BASE_NS.search(tail)
    base_s = int(found.group(1)) / 1e9 if found else 0.0
    pid = os.getpid()
    events = [{"ph": "X", "cat": "program span", "pid": pid,
               "tid": "program spans",
               "name": f"{r['stage']} {r['msg'].removesuffix(' done')}",
               "ts": (r["ts"] - base_s - r["seconds"]) * 1e6,
               "dur": r["seconds"] * 1e6,
               "args": {k: v for k, v in r.items()
                        if k not in ("ts", "stage", "msg", "seconds")}}
              for r in records]
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": "program spans", "args": {"name": "program spans"}})
    opening = head.index(b"[", at) + 1
    empty = head[opening:].lstrip().startswith(b"]")
    body = ",\n".join(json.dumps(e, default=str) for e in events)
    tmp = path + ".tmp"
    with open(path, "rb") as src, open(tmp, "wb") as dst:
        dst.write(head[:opening])
        dst.write(body.encode() + (b"\n" if empty else b",\n"))
        src.seek(opening)
        while chunk := src.read(1 << 24):
            dst.write(chunk)
    os.replace(tmp, path)
    return len(records)
