"""One run of one cell: set-up, the measured window, the check, one line.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. Everything about a cell is
found by name in files: the cell's configuration and traffic in
``BENCHMARK.json``, ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json`` (whose ``kind`` names a module of
``mosaicbench/kinds``), the limits of its check in
``benchmark/limits/<cell>.json``, and each metric's reader in
``benchmark/metrics/<metric>.py``. A cell, a configuration, a traffic
mix or a metric is added by adding files and entries.

The run: set-up (the inputs from the seed, the warm-up) up to the
window; the window, units of work one at a time until ``--seconds`` have
passed (the unit in flight finishes and counts); with ``--trace 1`` the
units are timed stage by stage and one unit more runs under the
profiler. Then the peak device memory is read, the check of every answer
against the planted truth runs, the metrics are read, and the last line
of standard output is one JSON object. The numbers compared, each beside
its limit, are the last lines of standard error and the last key of that
object. Progress, the card's power limit, launch counts and the bytes
written go to standard error and to ``$TMPDIR/mosaicbench/<cell>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

from .reference import compare

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "drone_image_stitch_cpp_tpu")


def log(*a):
    print("[bench]", *a, file=sys.stderr, flush=True)


def _json(path):
    with open(path) as f:
        return json.load(f)


def _boot_s():
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def _process_start_boot_s():
    """When this process started, on the boot-time clock (s)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def load_cell(name, spec=None):
    """(cell entry, config, traffic, limits, end-to-end metrics, per-layer
    metrics) of the cell ``name``: the metrics are the spec entries that
    apply to it."""
    spec = spec or _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = _json(os.path.join(BENCH_DIR, "configs",
                                f"{cell['config']}.json"))
    traffic = _json(os.path.join(BENCH_DIR, "traffic",
                                 f"{cell['traffic']}.json"))
    limits = _json(os.path.join(BENCH_DIR, "limits", f"{name}.json"))

    def applies(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    layer = [m for m in spec["per_layer"] if applies(m)]
    return cell, config, traffic, limits, e2e, layer


def reader(metric_name):
    """The ``read(ctx)`` of ``benchmark/metrics/<metric_name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric_name}.py")
    spec = importlib.util.spec_from_file_location(
        f"mosaicbench_metric_{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind_class(kind):
    mod = importlib.import_module(f"mosaicbench.kinds.{kind}")
    return getattr(mod, kind.capitalize())


class Context:
    """What a metric's reader reads: ``units`` (the window's records),
    ``window_s``, ``setup_s``, ``numbers`` (the check's readings),
    ``trace`` (a ``trace.Trace`` or None), ``trace_ok`` (it held a record
    of every launch it made and passed the in-trace check), ``bounds``
    ({kernel: seconds at the card's peaks} for the traced units),
    ``config`` and ``traffic``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def span_mean(self, stage_re, msgs, field="seconds"):
        """The mean over the window's units of the sum of the program's
        log records whose stage matches ``stage_re`` and message is one of
        ``msgs``; None when no unit has one."""
        pat = re.compile(stage_re)
        per_unit, seen = [], False
        for u in self.units:
            tot = 0.0
            for r in u.get("records", ()):
                if pat.fullmatch(r["stage"]) and r["msg"] in msgs \
                        and field in r:
                    tot += float(r[field])
                    seen = True
            per_unit.append(tot)
        return sum(per_unit) / len(per_unit) if seen else None


def _set_precision(torch, config):
    """The configuration's float32 rules: TF32 as its ``precision``
    states."""
    tf32 = bool(config["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _launches():
    """The program's kernel launch counters (K1; K2 by form and source)."""
    from drone_image_stitch_cpp_tpu_torch.tools.bench_sortie import (
        launch_counts)
    return launch_counts()


def _io_counts():
    """This process's write counters (/proc/self/io): ``wchar``, the bytes
    it handed to write calls, and ``write_bytes``, those that reached a
    block device (0 on a file system held in memory)."""
    with open("/proc/self/io") as f:
        rows = dict(line.split(":") for line in f)
    return {k: int(rows[k]) for k in ("wchar", "write_bytes")}


def run_cell(name, seed, seconds, trace, device, overrides=None,
             spec=None):
    """Set up, measure and check one cell on ``device``; returns (the
    result line as a dict, the run's record for standard error and
    ``$TMPDIR``). ``overrides`` replaces keys of the
    cell's config, traffic and limits ({"config": {...}, ...}) and may
    name ``patch``, a callable run on the kind's object after set-up (a
    control or a fault under test)."""
    import torch

    t_proc = _process_start_boot_s()
    cell, config, traffic, limits, e2e, layer = load_cell(name, spec)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    limits = {**limits, **overrides.get("limits", {})}
    cuda = device.type == "cuda"
    _set_precision(torch, config)
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else \
        (lambda: None)
    work = os.path.join(os.environ.get("TMPDIR") or os.path.join(
        ROOT, "build"), "mosaicbench", name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    info = {"cell": name, "seed": seed, "seconds": seconds, "trace": trace,
            "card": _card_line() if cuda else "cpu"}
    log(f"cell {name} seed {seed} card {info['card']}")
    kind = None
    try:
        kind = kind_class(traffic["kind"])(config, traffic, seed, device,
                                           work)
        if overrides.get("patch"):
            overrides["patch"](kind)
        traced = None
        if trace:                   # early in the process: a clean trace
            traced = _trace_unit(kind, device)
        sync()
        setup_s = _boot_s() - t_proc
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        launches0 = _launches()
        units = []
        t0 = time.perf_counter()
        while True:
            rec = kind.unit(spans=bool(trace))
            units.append(rec)
            done = time.perf_counter()
            kind.between(rec)
            if done - t0 >= seconds:
                break
        window_s = done - t0
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        launches = {k: v - launches0[k] for k, v in _launches().items()}
        if trace and not (traced and traced[0]):
            traced = _trace_unit(kind, device)   # the first lost records
        found = forbidden_modules()
        if found:
            raise ForbiddenModules(found)
        failed, numbers, unscored, scored = kind.check(units)
        bounds = None
        trace_obj = trace_ok = None
        if traced:
            trace_ok, trace_obj, trace_units = traced
            if trace_ok and hasattr(kind, "bounds"):
                bounds = kind.bounds(trace_units)
        ctx = Context(units=units, window_s=window_s, setup_s=setup_s,
                      numbers=numbers, trace=trace_obj, trace_ok=trace_ok,
                      bounds=bounds, config=config, traffic=traffic)
        metrics = {}
        for m in (layer if trace else e2e):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        numbers["unscored"] = unscored
        limits = {**limits, "unscored": 0}
        within, checks = compare(numbers, limits)
        result = {"correct": bool(within and failed == 0 and units),
                  "attempted": len(units), "failed": int(failed),
                  "metrics": metrics,
                  "device": {"platform": "gpu" if cuda else "cpu",
                             "kind": (torch.cuda.get_device_name(device)
                                      if cuda else "cpu"),
                             "count": 1, "memory_peak_bytes": int(peak)}}
        if trace_obj is not None:
            result["device"]["busy_s"] = trace_obj.busy_s
            result["device"]["window_s"] = trace_obj.wall_s
            result["breakdown"] = {"device_ops": trace_obj.top_ops(),
                                   "idle_gaps": trace_obj.idle_gaps()}
        result["checks"] = checks
        info.update(setup_s=setup_s, window_s=window_s, units=len(units),
                    unit_seconds=[u["seconds"] for u in units],
                    distinct_answers_scored=scored,
                    launches=launches, memory_peak_bytes=peak,
                    trace_ok=trace_ok, written=_io_counts())
        return result, info
    finally:
        if kind is not None:
            kind.close()
        shutil.rmtree(work, ignore_errors=True)


class ForbiddenModules(RuntimeError):
    pass


def _trace_unit(kind, device):
    """One unit of work under the profiler: (trace_ok, Trace, [unit]).
    trace_ok: the trace passed the in-trace check (``Trace.faults``) and
    holds a record of every launch of the kernels the kind names."""
    from .trace import traced
    before = _launches()
    recs, tr = traced(kind.trace_units, device)
    for rec in recs:
        kind.between(rec)
    after = _launches()
    names = kind.trace_names()
    faults = tr.faults(names)
    for kname, counter in names.items():
        n = after[counter] - before[counter]
        got = len(tr.kernel_s(kname))
        if got != n:
            faults.append(f"{got} '{kname}' records of {n} launches")
    first, over = tr.margins()
    log(f"trace: wall {tr.wall_s:.6f} s events {tr.events_s:.6f} s busy "
        f"{tr.busy_s:.6f} s, {len(tr.ops)} device operations, first "
        f"starts at {first} s, last ends {over} s after the wall; "
        f"faults {faults}")
    return not faults, tr, recs


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        log(f"no torch: {e}")
        return 2
    if not torch.cuda.is_available():
        log("no CUDA card: torch.cuda.is_available() is False")
        return 2
    try:
        cell = load_cell(args.workload)[0]
    except (KeyError, OSError) as e:
        log(f"cannot load the cell: {e}")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"the cell needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    sys.path.insert(0, ROOT)
    try:
        import drone_image_stitch_cpp_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program is not in this checkout: {e}")
        return 2
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    device = torch.device("cuda:0")
    try:
        with contextlib.redirect_stdout(sys.stderr):  # the program's log
            result, info = run_cell(args.workload, args.seed, args.seconds,
                                    args.trace, device)
    except ForbiddenModules as e:
        log(f"modules of JAX or the JAX package are loaded: {e}")
        return 3
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 3
    info_path = os.path.join(os.environ.get("TMPDIR") or build,
                             "mosaicbench", f"{args.workload}.json")
    os.makedirs(os.path.dirname(info_path), exist_ok=True)
    with open(info_path, "w") as f:
        json.dump(info, f)
    log("run " + json.dumps(info))
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
