"""Readings that the limits of a cell's check are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 4,5,6] [--tf32 7,8] [--out FILE]

For each seed of ``--seeds``, one unit of the cell's work through the
program as configured, scored by the check; for each seed of
``--control``, the same with each of the cell's lower-precision controls
in the program's place (``mosaicbench.controls``); for each seed of
``--tf32``,
the program with TF32 matrix products allowed (the configuration says
off). One process, set up and warmed up once a side: each later seed
renders its inputs and runs at once. One JSON line per reading on
standard output (and appended to ``--out``): the cell, the seed, the
side (with the control's name), the unit's seconds and every number the
check compares. The limits in ``limits/<cell>.json`` lie between the
program's largest reading and the control's smallest.
"""

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mosaicbench.controls import controls_for  # noqa: E402
from mosaicbench.harness import ROOT, load_cell, log, run_cell  # noqa: E402


def readings(cell, seeds, side, device, out=None, overrides=None,
             first=True):
    """Yield one reading dict per seed (see the module's docstring);
    ``side`` is "program", "tf32" or "control:<name>" (a control of
    ``controls_for(cell)``); ``first``: the process is not warm yet."""
    overrides = dict(overrides or {})
    if side == "tf32":
        prec = {**load_cell(cell)[1]["precision"], "tf32": True}
        overrides["config"] = {**overrides.get("config", {}),
                               "precision": prec}
    for s in seeds:
        ov = dict(overrides)
        if not first:       # the process is warm: no second warm-up
            ov["traffic"] = {**ov.get("traffic", {}), "warmup": False}
        if side.startswith("control:"):
            ov["patch"] = controls_for(cell)[side.split(":", 1)[1]]
        res, info = run_cell(cell, s, 0.0, 0, device, ov)
        first = False
        rec = {"cell": cell, "seed": s, "side": side,
               "correct": res["correct"], "seconds": info["unit_seconds"],
               "numbers": {k: v["value"] for k, v in res["checks"].items()}}
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        yield rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--tf32", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA card")
        return 2
    sys.path.insert(0, ROOT)
    device = torch.device("cuda:0")
    # the controls last: the sortie's stays patched into the process
    sides = [(args.seeds, "program"), (args.tf32, "tf32")] + [
        (args.control, f"control:{c}") for c in controls_for(args.workload)]
    first = True
    for seeds, side in sides:
        seeds = [int(s) for s in seeds.split(",") if s]
        with contextlib.redirect_stdout(sys.stderr):
            recs = list(readings(args.workload, seeds, side, device,
                                 args.out, first=first))
        first = first and not seeds
        for rec in recs:
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
