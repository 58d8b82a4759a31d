"""Calibration readings of a sortie cell whose traffic kind the
benchmark's ``calibrate.py --control`` cannot reach (``controls.
controls_for`` is keyed by kind, and has no ``thermal``).

    python studies/thermal_limits.py --seeds 1,2,3 --control 4,5,6 \\
        [--workload thermal-3x100-640] [--out limits.jsonl]

For each seed of ``--seeds``, one unit of the cell's work through the
program as configured, scored by the check; for each seed of
``--control``, the same with the sortie kinds' lower-precision control,
the program's own float32 bundle adjust (``controls.
_sortie_float32_bundle_adjust``, passed to ``harness.run_cell`` as its
``overrides`` patch). One process on cuda:0, set up and warmed up once:
each later seed renders its inputs and runs at once; the control side
runs last, since its patch stays in the process. One JSON line per
reading on standard output (and appended to ``--out``), as
``calibrate.py`` writes them: the cell, the seed, the side, ``correct``
under the cell's current limits, the unit's seconds and every number the
check compares. The limits in ``benchmark/limits/<cell>.json`` lie
between the program's largest reading and the control's smallest.
"""

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmark"))


def readings(cell, seeds, control, device, out=None, first=True):
    """Yield one reading dict per seed; ``control``: run under the float32
    bundle adjust; ``first``: the process is not warm yet."""
    from mosaicbench import controls
    from mosaicbench.harness import run_cell
    for s in seeds:
        ov = {}
        if not first:       # the process is warm: no second warm-up
            ov["traffic"] = {"warmup": False}
        if control:
            ov["patch"] = controls._sortie_float32_bundle_adjust
        res, info = run_cell(cell, s, 0.0, 0, device, ov)
        first = False
        rec = {"cell": cell, "seed": s,
               "side": "control:f32_bundle_adjust" if control else "program",
               "correct": res["correct"], "seconds": info["unit_seconds"],
               "numbers": {k: v["value"] for k, v in res["checks"].items()}}
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        yield rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="thermal-3x100-640")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    first = True
    for seeds, control in ((args.seeds, False), (args.control, True)):
        seeds = [int(s) for s in seeds.split(",") if s]
        with contextlib.redirect_stdout(sys.stderr):
            recs = list(readings(args.workload, seeds, control, device,
                                 args.out, first=first))
        first = first and not seeds
        for rec in recs:
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
