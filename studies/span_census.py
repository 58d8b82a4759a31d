"""One benchmark cell run with a census of the program's span records.

    python studies/span_census.py --workload area-3x20-4k --seed N \\
        --seconds 51 --trace 1 --out chiprun_out/census-area.json

Runs the cell through the benchmark's harness (``mosaicbench.harness.
run_cell``, as ``benchmark/run.py`` does, on cuda:0) and keeps every
sortie's records. Prints the result line as ``benchmark/run.py`` does and
writes ``--out``: the window's sortie seconds, records per sortie, and
per (stage, message) of the span records the count, seconds and counters
summed over a sortie (the window's mean) and over the traced sortie, for
each stage span the share its inner spans cover, and the first sortie's
span records. ``--cpu-tiny`` runs
the cell at a cut size on the CPU (a rehearsal: the sizes of
``benchmark/tests/test_bench_check.py``).
"""

import argparse
import contextlib
import json
import os
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmark"))

TINY = {"config": {"frame_h": 160, "frame_w": 208, "frames_per_line": 5},
        "traffic": {"warmup": False},
        "limits": {"mosaic_rmse": 10.0, "mosaic_block_rmse": 25.0,
                   "mosaic_uncovered": 2.0, "mosaic_size_px": 8}}
TINY_AREA = {"traffic": {"warmup": False, "lines": 2},
             "limits": {**TINY["limits"], "lines_off": 0,
                        "strip_rmse": 10.0, "strip_block_rmse": 25.0,
                        "strip_uncovered": 2.0, "strip_size_px": 8}}


def census(units):
    """{"stage|msg": {n, seconds, counters...}} summed over the units,
    divided by their count."""
    tot = defaultdict(lambda: defaultdict(float))
    for recs in units:
        for r in recs:
            if "seconds" not in r:
                continue
            row = tot[f"{r['stage']}|{r['msg']}"]
            row["n"] += 1
            for k, v in r.items():
                if k not in ("ts", "stage", "msg", "parent") and \
                        isinstance(v, (int, float)):
                    row[k] += v
    k = max(1, len(units))
    return {key: {f: v / k for f, v in row.items()}
            for key, row in sorted(tot.items())}


def covered(units):
    """{"stage|message": share of a span's seconds that its direct
    children cover}, over the units. A child names its parent's message;
    its stage is the parent's, or (a stage given to the child) the one
    stage holding a span of that message."""
    par, kid = defaultdict(float), defaultdict(float)
    for recs in units:
        for r in recs:
            if "seconds" in r:
                par[f"{r['stage']}|{r['msg']}"] += r["seconds"]
    for recs in units:
        for r in recs:
            if "seconds" not in r or not r.get("parent"):
                continue
            key = f"{r['stage']}|{r['parent']}"
            if key not in par:
                same = [k for k in par if k.endswith(f"|{r['parent']}")]
                key = same[0] if len(same) == 1 else key
            kid[key] += r["seconds"]
    return {k: kid[k] / par[k] for k in sorted(kid) if par.get(k)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=1)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cpu-tiny", action="store_true")
    args = ap.parse_args()
    import torch
    from mosaicbench import harness as H

    window, traced = [], []

    def patch(kind):
        real = kind.unit

        def unit(span=None, spans=False):
            rec = real(span=span, spans=spans)
            (window if span is None else traced).append(
                (rec["seconds"], rec["records"]))
            return rec
        kind.unit = unit

    ov = {}
    if args.cpu_tiny:
        ov = {**TINY, **(TINY_AREA if args.workload.startswith("area")
                         else {})}
    ov["patch"] = patch
    dev = torch.device("cpu" if args.cpu_tiny else "cuda:0")
    with contextlib.redirect_stdout(sys.stderr):
        result, info = H.run_cell(args.workload, args.seed, args.seconds,
                                  args.trace, dev, ov)
    recs = [r for _, r in window]
    out = {"workload": args.workload, "seed": args.seed,
           "card": info["card"], "sortie_s": [s for s, _ in window],
           "traced_sortie_s": [s for s, _ in traced],
           "records_per_sortie": [len(r) for r in recs],
           "span_records_per_sortie": [sum("seconds" in x for x in r)
                                       for r in recs],
           "window": census(recs), "traced": census([r for _, r in traced]),
           "covered": covered(recs),
           "first_sortie": [r for r in recs[0] if "seconds" in r]
           if recs else [], "result": result}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
