"""The graph-cut engines' A/B: the port's host solver (``csrc/graphcut.cpp``)
against the JAX package's reference solver (``native/graphcut.cpp``) and,
where there is a card, the card's push-relabel kernel (``csrc/maxflow.cu``
through ``ops/maxflow_kernel``) on the same seam problems, timed in turns
in one process.

    python studies/gc_engine_ab.py [--seed 1] [--height 1600] \\
        [--width 3500] [--rounds 3] [--out FILE]
    python studies/gc_engine_ab.py --workload area-3x20-4k --seed N \\
        [--rounds 3|0] [--out FILE]

Without ``--workload`` the problems are synthetic: a union box of
``--height`` x ``--width`` over smooth random terrain, the second image
misregistered by a smooth 1-3 px shift, the two masks overlapping on the
middle ~30% of the rows along a ragged edge, so the seam runs along the
width as between two flight lines. They are built with ``ops/seam``'s own
steps, as ``graphcut_pairwise_seam`` builds them: ``_gc_problem`` on the
coarse grid and its solve, then on the full grid the band of
``max(32, round(3 / sc))`` px around the upsampled coarse seam with every
overlap pixel outside it pinned (``fine``), and the same with the band
doubled (``widened``), which is built whether or not the fine cut presses on
its band (``fine_cut_touches`` says whether it does).

With ``--workload`` the problems are the real ones of one sortie of that
benchmark cell, on ``cuda:0`` (the CPU with ``--cpu-tiny``, at the cut
size of ``studies/span_census.py``): the cell runs through the benchmark's
harness without its warm-up and with a one-sortie window, every solve
(``utils/native.graphcut_native`` on the host, or
``ops/maxflow_kernel.graphcut_device`` on the card) is recorded, and each
recorded problem is solved again here by every engine.

With ``--workload`` each problem is also held to the numpy path that
built the seam problems on the host before they were built on the images'
device (``tests/test_torch_seam_build.pairwise_seam_np``, run on each
pair's union box as the sortie handed it over, its problems solved by the
sortie's engine): grid elements and labels that differ and, where labels
differ, both labellings' float64 cut values on the numpy path's problem;
the head line sums it up (``numpy_path``: problems, grids and labels
equal, tie nodes, other nodes, masks' differing pixels). ``--rounds 0``
makes that comparison alone.

Each problem is solved by the engines in turns, ``ref, new, dev, dev, new,
ref`` a round: for the host engines the whole ``tm_graphcut`` call (graph
build, solve and labels); for the card (``dev``, only where
``torch.cuda.is_available()``) the whole ``graphcut_device`` call on the
four grids already on the card (contraction, rounds, until the labels
are ready on the card), and beside
it the rounds alone (``rounds_kernel`` on the contracted problem, between
two CUDA events). The reference's counts (augmentations and orphans
processed; every root is active at its start) come from an untimed copy of
its source with two counters added (built into ``build/native/``). Prints
one JSON line per problem and writes them all to ``--out``: nodes, free
nodes (no terminal capacity), the card's free nodes after contraction,
rounds and global relabels, each engine's seconds (every run and the
median), flow and counts, the nodes whose labels differ (the port's host
engine against the reference, the card against the port's host engine,
and the card's later runs against its first) and, if any do, the
labellings' cut values in float64.
"""

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import drone_image_stitch_cpp_tpu_torch.ops.maxflow_kernel as M  # noqa: E402
from drone_image_stitch_cpp_tpu_torch.ops import seam as S  # noqa: E402
from drone_image_stitch_cpp_tpu_torch.ops.resize import (  # noqa: E402
    resize_area)
from drone_image_stitch_cpp_tpu_torch.utils import native as N  # noqa: E402

FPTR = np.ctypeslib.ndpointer(dtype=np.float32, flags="C")
UPTR = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C")
# the counters added to the reference's copy: (anchor, line added after it)
COUNTED = (("  int time_ = 0;\n", "  long long n_augments_ = 0, n_orphans_ = 0;\n"),
           ("      ++time_;\n", "      ++n_augments_;\n"),
           ("      if (t == kFree) continue;\n", "      ++n_orphans_;\n"),
           ("  bool source_side(int i) const { return tree_[i] == kTreeS; }\n",
            "  void counts(long long* c) const { c[0] = n_augments_;"
            " c[1] = n_orphans_; }\n"),
           ("  for (int i = 0; i < n; ++i) labels_out[i] = "
            "g.source_side(i) ? 1 : 0;\n",
            "  g.counts(tm_counts);\n"),
           ('extern "C" {\n', "long long tm_counts[2];\n"))


def engines():
    """(the port's tm_graphcut, the reference's, the reference's counting
    copy and its counts array)."""
    if N.graphcut_library() is None:
        raise SystemExit("no C++ compiler: the solvers do not build")
    new = N._GC["fn"]
    path, err = N._build("tmgraphcutref", ["graphcut.cpp"])
    if path is None:
        raise SystemExit(f"the reference solver does not build: {err}")
    ref = ctypes.CDLL(path).tm_graphcut
    with open(os.path.join(ROOT, "native", "graphcut.cpp")) as f:
        src = f.read()
    for anchor, line in COUNTED:
        if src.count(anchor) != 1:
            raise SystemExit(f"the reference source has changed: {anchor!r}")
        src = src.replace(anchor, anchor + line)
    out_dir = os.path.join(ROOT, "build", "native", "counted")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "graphcut.cpp"), "w") as f:
        f.write(src)
    path, err = N._build("tmgraphcutcounted", ["graphcut.cpp"],
                         src_dir=out_dir)
    if path is None:
        raise SystemExit(f"the counting copy does not build: {err}")
    lib = ctypes.CDLL(path)
    counted = lib.tm_graphcut
    for fn in (ref, counted):
        fn.restype = ctypes.c_double
        fn.argtypes = [ctypes.c_int, ctypes.c_int, FPTR, FPTR, FPTR, FPTR,
                       UPTR]
    counts = np.ctypeslib.as_array((ctypes.c_longlong * 2).in_dll(
        lib, "tm_counts"))
    return new, ref, counted, counts


def cut_value(lab, cs, ck, ch, cv):
    labf = lab.astype(bool)
    cut = float(np.where(~labf, cs, 0).astype(np.float64).sum())
    cut += float(np.where(labf, ck, 0).astype(np.float64).sum())
    cut += float((ch.astype(np.float64) * (labf[:, :-1] != labf[:, 1:])).sum())
    cut += float((cv.astype(np.float64) * (labf[:-1, :] != labf[1:, :])).sum())
    return cut


def smooth_field(rng, h, w, cell, ch=1):
    """Random values on a grid of ``cell`` px, bicubically upsampled to
    (h, w, ch)."""
    g = rng.uniform(0.0, 1.0, (1, ch, h // cell + 4, w // cell + 4))
    up = F.interpolate(torch.from_numpy(g.astype(np.float32)),
                       scale_factor=cell, mode="bicubic",
                       align_corners=False)
    return up[0, :, cell:cell + h, cell:cell + w].permute(1, 2, 0).numpy()


def synthetic_pair(seed, h, w):
    """(a, b, mask_a, mask_b): terrain, the same terrain sampled 1-3 px off
    by a smooth shift, with sensor noise; A holds the top 65% of the rows,
    B the bottom 65%, each edge ragged by up to 24 px."""
    rng = np.random.default_rng(seed)
    terrain = (150.0 * smooth_field(rng, h + 8, w + 8, 64, 3)
               + 60.0 * smooth_field(rng, h + 8, w + 8, 8, 3)
               + 30.0 * smooth_field(rng, h + 8, w + 8, 2, 3))
    t = torch.from_numpy(np.ascontiguousarray(
        terrain.transpose(2, 0, 1)))[None]
    shift = 1.0 + 2.0 * smooth_field(rng, h, w, 256, 2)
    sign = np.where(rng.random(2) < 0.5, -1.0, 1.0).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32) + 4,
                         np.arange(w, dtype=np.float32) + 4, indexing="ij")

    def sample(dy, dx):
        gx = (xx + dx) / (w + 7) * 2 - 1
        gy = (yy + dy) / (h + 7) * 2 - 1
        grid = torch.from_numpy(np.stack([gx, gy], -1)[None])
        return F.grid_sample(t, grid, mode="bilinear",
                             align_corners=True)[0].permute(1, 2, 0).numpy()

    a = sample(0.0, 0.0)
    b = sample(sign[0] * shift[..., 0], sign[1] * shift[..., 1])
    a = a + rng.normal(0, 2.0, a.shape).astype(np.float32)
    b = b + rng.normal(0, 2.0, b.shape).astype(np.float32)
    rag = 24.0 * smooth_field(rng, 1, w, 128, 2)[0]
    rows = np.arange(h)[:, None]
    ma = rows < (0.65 * h - rag[:, 0])[None, :]
    mb = rows >= (0.35 * h + rag[:, 1])[None, :]
    a = np.clip(a, 0, 255) * ma[..., None]
    b = np.clip(b, 0, 255) * mb[..., None]
    return a.astype(np.float32), b.astype(np.float32), ma, mb


def synthetic_problems(seed, h, w):
    """[(name, (cap_src, cap_snk, cap_h, cap_v))] as host arrays, and
    whether the fine cut presses on its band: ``graphcut_pairwise_seam``'s
    coarse, fine and widened problems of the synthetic pair (the union box
    is the whole (h, w) grid), built by its own helpers on CPU tensors."""
    a, b, ma, mb = [torch.from_numpy(x)
                    for x in synthetic_pair(seed, h, w)]
    both = ma & mb
    sc = (S.GC_COARSE_NODES / float(h * w)) ** 0.5
    nh, nw = max(2, int(h * sc)), max(2, int(w * sc))

    def host(prob):
        return tuple(c.numpy() for c in prob)

    coarse = host(S._gc_problem(
        resize_area(a, nh, nw), resize_area(b, nh, nw),
        S._resize_nearest(ma, nh, nw), S._resize_nearest(mb, nh, nw)))
    lab_up = S._resize_nearest(torch.from_numpy(
        N.graphcut_native(*coarse)).to(torch.bool), h, w)
    cap_src, cap_snk, cap_h, cap_v = S._gc_problem(a, b, ma, mb)
    out = [("coarse", coarse)]
    band = max(32, int(round(3.0 / sc)))
    touches = None
    for name in ("fine", "widened"):
        fixed = both & ~S._seam_band(lab_up, band)
        pin_a, pin_b = fixed & lab_up, fixed & ~lab_up
        prob = host((torch.where(pin_a, S._PIN, cap_src),
                     torch.where(pin_b, S._PIN, cap_snk), cap_h, cap_v))
        out.append((f"{name} band {band}", prob))
        if touches is None:
            touches = bool(S._cut_touches(
                torch.from_numpy(N.graphcut_native(*prob)).to(torch.bool),
                pin_a | pin_b))
        band *= 2
    return out, touches


def cell_problems(workload, seed, cpu_tiny):
    """[(name, problem)] of every solve in one sortie of ``workload``,
    through the benchmark's harness, and each problem's comparison with
    the numpy path the problems were built by before they were built on
    the images' device (``tests/test_torch_seam_build.pairwise_seam_np``
    on the same union boxes, each of its problems solved by the same
    engine): grid elements and labels that differ, the float64 cut
    values of both labellings on the numpy path's problem where labels
    differ, and the masks' differing pixels."""
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    from mosaicbench import harness as H
    sys.path.insert(0, os.path.join(ROOT, "studies"))
    from span_census import TINY, TINY_AREA
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_seam_build import pairwise_seam_np
    real, real_dev = N.graphcut_native, M.graphcut_device
    real_pair = S.graphcut_pairwise_seam
    seen, labels, pairs = [], [], []

    def recording(*prob):
        seen.append([np.array(c, np.float32) for c in prob])
        lab = real(*prob)
        labels.append(None if lab is None else np.array(lab))
        return lab

    def recording_dev(*prob):
        seen.append([c.cpu().numpy() for c in prob])
        lab = real_dev(*prob)
        labels.append(lab.cpu().numpy())
        return lab

    def recording_pair(*args):
        # copies before the call: the masks are views the stage carves
        inputs = [x.cpu().numpy().copy() for x in args]
        first = len(seen)
        out = real_pair(*args)
        pairs.append((inputs, first, len(seen), None if out is None else
                      [m.cpu().numpy().copy() for m in out]))
        return out

    ov = {**TINY, **(TINY_AREA if workload.startswith("area") else {})} \
        if cpu_tiny else {}
    ov["traffic"] = {**ov.get("traffic", {}), "warmup": False}
    dev = torch.device("cpu" if cpu_tiny else "cuda:0")
    N.graphcut_native, M.graphcut_device = recording, recording_dev
    S.graphcut_pairwise_seam = recording_pair
    try:
        with contextlib.redirect_stdout(sys.stderr):
            result, _ = H.run_cell(workload, seed, 0.0, 0, dev, ov)
    finally:
        N.graphcut_native, M.graphcut_device = real, real_dev
        S.graphcut_pairwise_seam = real_pair
    if not result["correct"]:
        raise SystemExit(f"the sortie was not correct: {result['checks']}")

    def solve_np(*prob):
        if dev.type == "cpu":
            return real(*prob)
        return real_dev(*[torch.from_numpy(np.ascontiguousarray(
            c, np.float32)).to(dev) for c in prob]).cpu().numpy()

    parent = [None] * len(seen)
    for k, (args, first, end, masks) in enumerate(pairs):
        want, want_probs = pairwise_seam_np(*args, solve_np)
        mask_differ = None
        if (want is None) == (masks is None) and want is not None:
            mask_differ = sum(int((x != y).sum())
                              for x, y in zip(masks, want))
        for i, prob_np in zip(range(first, end), want_probs):
            prob_np = [np.ascontiguousarray(c, np.float32) for c in prob_np]
            lab_np = solve_np(*prob_np)
            rec = {"pair": k,
                   "parent_path_problems": len(want_probs),
                   "grids_differ": sum(
                       int((x != y).sum()) if x.shape == y.shape else -1
                       for x, y in zip(seen[i], prob_np)),
                   "labels_differ": int((labels[i] != lab_np).sum()),
                   "masks_differ": mask_differ,
                   "masks_none": [masks is None, want is None]}
            if rec["labels_differ"]:
                rec["cut_values"] = [cut_value(x, *prob_np)
                                     for x in (labels[i], lab_np)]
            parent[i] = rec
    names = [f"{workload} call {i} ({p[0].shape[0]}x{p[0].shape[1]})"
             for i, p in enumerate(seen)]
    return list(zip(names, seen)), parent


def card_rounds_s(prob, dev):
    """(seconds of the card's rounds alone, between two CUDA events, on
    the problem's contraction; its counts)."""
    rib = M.contract(*[torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                       for c in prob])
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    _, rounds, relabels = M.rounds_kernel(rib)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, {
        "free": rib.n_free, "rounds": rounds, "relabels": relabels}


def ab(name, prob, new, ref, counted, ref_counts, rounds, dev=None):
    """One problem solved by the engines in turns (the card's only with a
    CUDA ``dev``); its JSON record."""
    cs, ck, ch, cv = [np.ascontiguousarray(c, np.float32) for c in prob]
    h, w = cs.shape
    engines_ = ("ref", "new") + (("dev",) if dev is not None else ())
    lab = {k: np.zeros((h, w), np.uint8) for k in engines_}
    counts = np.zeros(3, np.int64)
    secs = {k: [] for k in engines_}
    flow = {}
    dev_runs = []

    grids = None if dev is None else [torch.from_numpy(c).to(dev)
                                      for c in (cs, ck, ch, cv)]

    def run(which):
        if which == "dev":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if which == "dev":
            out = M.graphcut_device(*grids)
            torch.cuda.synchronize(dev)
        elif which == "new":
            flow[which] = new(h, w, cs, ck, ch, cv, lab[which], counts)
        else:
            flow[which] = ref(h, w, cs, ck, ch, cv, lab[which])
        secs[which].append(time.perf_counter() - t0)
        if which == "dev":
            lab[which] = out.cpu().numpy()
            dev_runs.append(lab[which])

    for _ in range(rounds):
        for which in engines_ + engines_[::-1]:
            run(which)
    counted(h, w, cs, ck, ch, cv, np.zeros((h, w), np.uint8))
    tr = cs - ck
    roots = int(((tr > 1e-12) | (tr < -1e-12)).sum())
    differ = int((lab["ref"] != lab["new"]).sum())
    rec = {"problem": name, "nodes": h * w,
           "free_nodes": h * w - roots,
           "seconds": {k: v for k, v in secs.items()},
           "median_s": {k: statistics.median(v) for k, v in secs.items()},
           "flow": flow,
           "ref_counts": {"augments": int(ref_counts[0]),
                          "orphans": int(ref_counts[1]),
                          "active_roots": roots},
           "new_counts": dict(zip(("augments", "orphans", "active_roots"),
                                  counts.tolist())),
           "labels_differ": differ}
    rec["speedup"] = rec["median_s"]["ref"] / rec["median_s"]["new"]
    if dev is not None:
        kernel = [card_rounds_s(prob, dev) for _ in range(rounds)]
        rec["dev_rounds_s"] = [k[0] for k in kernel]
        rec["dev_counts"] = kernel[0][1]
        rec["dev_labels_differ"] = int((lab["dev"] != lab["new"]).sum())
        rec["dev_repeats_differ"] = sum(int((r != dev_runs[0]).sum())
                                        for r in dev_runs[1:])
        rec["dev_speedup"] = rec["median_s"]["new"] / rec["median_s"]["dev"]
        differ += rec["dev_labels_differ"]
    if differ:
        rec["cut_value"] = {k: cut_value(v, cs, ck, ch, cv)
                            for k, v in lab.items()}
    return rec


def numpy_path_summary(parent):
    """A cell's comparison with the numpy path: problems, those whose
    grids and labels are bit-equal, the tie nodes (labels that differ
    where both labellings' float64 cut values are equal) and the nodes
    that differ otherwise, and the masks' differing pixels."""
    ties = other = 0
    for r in parent:
        if r is None or not r["labels_differ"]:
            continue
        cuts = r["cut_values"]
        if abs(cuts[0] - cuts[1]) <= 1e-9 * max(abs(cuts[1]), 1.0):
            ties += r["labels_differ"]
        else:
            other += r["labels_differ"]
    known = [r for r in parent if r is not None]
    return {"problems": len(parent), "compared": len(known),
            "grids_equal": sum(r["grids_differ"] == 0 for r in known),
            "labels_equal": sum(r["labels_differ"] == 0 for r in known),
            "tie_nodes": ties, "other_nodes": other,
            "masks_differ": sum(r["masks_differ"] or 0 for r in known),
            "none_agree": all(r["masks_none"][0] == r["masks_none"][1]
                              for r in known)}


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--height", type=int, default=1600)
    ap.add_argument("--width", type=int, default=3500)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--workload")
    ap.add_argument("--cpu-tiny", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.rounds < 0 or (args.rounds == 0 and not args.workload):
        raise SystemExit("--rounds must be at least 1 (0: with --workload, "
                         "the comparison with the numpy path alone)")
    new, ref, counted, ref_counts = engines()
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else None
    head = {"card": card(), "cpu": os.cpu_count(), "seed": args.seed}
    parent = None
    if args.workload:
        probs, parent = cell_problems(args.workload, args.seed,
                                      args.cpu_tiny)
        head["workload"] = args.workload
        head["numpy_path"] = numpy_path_summary(parent)
    else:
        probs, touches = synthetic_problems(args.seed, args.height,
                                            args.width)
        head.update(union_box=[args.height, args.width],
                    fine_cut_touches=touches)
    print(json.dumps(head), flush=True)
    recs = [head]
    for i, (name, prob) in enumerate(probs):
        rec = {"problem": name, "nodes": int(prob[0].size)}
        if args.rounds:
            rec = ab(name, prob, new, ref, counted, ref_counts,
                     args.rounds, dev)
        if parent is not None:
            rec["numpy_path"] = parent[i]
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
