"""What a span of the program's recorder costs (runtime/logging), and
whether the operator's trace places the spans on the kernels' clock.

    python studies/span_cost.py [--n 200000] [--device cuda:0]

Prints one JSON line: ``span_us`` (an entered and closed ``span`` inside
a stage, on the host), ``span_counters_us`` (with two counters),
``launch_us`` / ``launch_in_span_us`` (a small elementwise op on
``device`` alone and inside a span, the queue drained once at the end:
what the span adds to a launch loop), ``trace`` (one ``device_trace``
of a span around a matmul: whether the span's event holds the matmul's
host op and its kernels start after the span starts, in the exported
Chrome trace) and the card's name and power limit.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from drone_image_stitch_cpp_tpu_torch.runtime import logging as L  # noqa


def _per_call_us(fn, n):
    fn(n // 10)
    t0 = time.perf_counter()
    fn(n)
    return 1e6 * (time.perf_counter() - t0) / n


def host_cost(n):
    log = L.StageLogger(verbose=False)

    def spans(k):
        with log.timer("Bench", "stage"):
            for _ in range(k):
                with log.span("step"):
                    pass
        log._records.clear()

    def counted(k):
        with log.timer("Bench", "stage"):
            for _ in range(k):
                with log.span("step", frames=3, bytes=1):
                    pass
        log._records.clear()

    def bare(k):
        for _ in range(k):
            pass

    base = _per_call_us(bare, n)
    return (_per_call_us(spans, n) - base, _per_call_us(counted, n) - base)


def launch_cost(device, n):
    log = L.StageLogger(verbose=False)
    x = torch.zeros(1024, device=device)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)

    def alone(k):
        for _ in range(k):
            x.add_(1.0)
        sync()

    def in_span(k):
        with log.timer("Bench", "stage"):
            for _ in range(k):
                with log.span("launch"):
                    x.add_(1.0)
        sync()
        log._records.clear()

    out = []
    for fn in (alone, in_span, in_span, alone):   # in turns
        out.append(_per_call_us(fn, n))
    return 0.5 * (out[0] + out[3]), 0.5 * (out[1] + out[2])


def trace_check(device):
    d = tempfile.mkdtemp()
    try:
        a = torch.randn(512, 512, device=device)
        with L.device_trace(d):
            with L.get_logger().span("matmul", stage="Bench"):
                (a @ a).sum().item()
        path = os.path.join(d, os.listdir(d)[0])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(d)
    span = [e for e in events if e.get("cat") == "program span"]
    if len(span) != 1:
        return {"ok": False, "why": f"{len(span)} span events"}
    s0, s1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    ops = [e for e in events if e.get("name") == "aten::mm"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    held = bool(ops) and all(s0 <= e["ts"] and e["ts"] + e["dur"] <= s1 + 1
                             for e in ops)
    after = all(e["ts"] >= s0 for e in kernels)
    return {"ok": held and after, "mm_ops": len(ops),
            "kernels": len(kernels), "span_us": s1 - s0,
            "first_kernel_after_start_us": min(
                (e["ts"] - s0 for e in kernels), default=None)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    dev = torch.device(args.device)
    span_us, counted_us = host_cost(args.n)
    alone_us, in_span_us = launch_cost(dev, args.n // 10)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps({"span_us": span_us, "span_counters_us": counted_us,
                      "launch_us": alone_us, "launch_in_span_us": in_span_us,
                      "trace": trace_check(dev), "device": str(dev),
                      "card": card, "torch": torch.__version__}))


if __name__ == "__main__":
    main()
