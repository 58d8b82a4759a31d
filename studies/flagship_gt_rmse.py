"""Where the flagship's GT-RMSE comes from: the port's own scatter, the
global stage's two seam switches, the bundle adjust's precision, and the
port against the JAX package on the same JPEGs.

    python studies/flagship_gt_rmse.py card --out FILE   # on a CUDA card
    python studies/flagship_gt_rmse.py card --out FILE --device cpu \
        --work DIR --rows 2 --cols 4 --frame 160x208     # a CPU rehearsal
    python studies/flagship_gt_rmse.py cpu --out FILE [--rows 3 --cols 6]
    python studies/flagship_gt_rmse.py compare --out FILE   # cpu runs' file
    python studies/flagship_gt_rmse.py card --only none --out F \
        --save-ba BA.npz                          # on a card: the systems
    python studies/flagship_gt_rmse.py ba --inputs BA.npz --out JAX.npz
    python studies/flagship_gt_rmse.py card --only "(e)" --out F \
        --inject-ba JAX.npz                       # on a card

``card`` (about 25 min): renders the flagship with the port's harness
(``tools/sortie_bench.make_sortie``: 10 x 20 frames of 2160x3840,
overlaps 0.70 / 0.35, seed 11, JPEG quality 92) under ``build/sortie200``
and runs ``tools/bench_sortie.measure_run`` (``app.run_stitch_application``
end to end) once per variant, after one cold run at the defaults:

  (a) the defaults on the I420 store with every RANSAC seed the port draws
      offset by 0..4 (``torch.Generator.manual_seed`` in
      ``pipeline/pairgraph.sample_banks``, ``pipeline/roi_align.
      sample_bank``, ``pipeline/pairwise._bank`` and the strip stage's
      failure diagnostics: the study installs a ``torch.Generator`` that
      adds the offset to every seed);
  (b) ``seam_warp="fullres"``, ``seam_method="dp"`` and both, on the I420
      store; the defaults and the two switches alone on the BGR store;
  (c) the strip bundle adjust in float32 (the JAX package's precision),
      with the pairs in their order and reversed;
  (e) with ``--inject-ba``: every strip takes the JAX package's own
      float32 solution of its bundle-adjust system, solved on the CPU by
      the ``ba`` mode from the systems that ``--save-ba`` saved from the
      cold run (the file holds them, so the run checks that each strip's
      system has the saved shape).

``ba`` (on a machine without a card, JAX on the CPU): each saved strip
system solved by the JAX package's ``bundle_adjust_similarity`` (float32)
and by the port's in float64 and in float32 (1 and 8 threads): the
largest frame displacement of each from the card's float64 solution.

``cpu`` (on a machine without a card): renders a cut of the flagship's
layout (``--rows`` x ``--cols`` frames of 2160x3840, the same overlaps,
seed and quality) and runs each package's ``run_stitch_application`` on
the same JPEGs: the defaults end to end, then each switch setting from
the strip checkpoint (``resume``: only the global stage runs again); the
JAX package takes the switches as ``TM_SEAM_WARP`` / ``TM_SEAM_METHOD``,
the port as ``RunConfig`` fields. It compares the groups, the kept frames,
the strip transforms, the global transforms, the flips and the seam
methods of the two packages.

Every run reports GT-RMSE (``tools/sortie_bench.gt_rmse``, max_dim 6000)
whole and per flight line (the ground-truth rows the line's planted
frames cover), the mosaic's size, the groups, the flips, the seam methods,
the global stage's seam-warp and seam seconds and the wall; one JSON
object per run goes to ``--out``. A study script, kept to reproduce the
verdict in PERF.md section 6; no test runs it. It imports JAX only in the
``cpu`` mode.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FRAME_H, FRAME_W = 2160, 3840
GT_MAX_DIM = 6000


def _emit(out, rec):
    print("[study] " + json.dumps(rec), flush=True)
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")


def _translation_diff(a, b):
    """Worst |translation| difference (px) of two lists of affines."""
    return float(max(np.abs(np.asarray(x, np.float64)[..., :2, 2]
                            - np.asarray(y, np.float64)[..., :2, 2]).max()
                     for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# card: the flagship's variants
# ---------------------------------------------------------------------------

def _offset_generator(torch, offset):
    """A torch.Generator whose manual_seed adds ``offset``."""
    base = torch.Generator

    class OffsetGenerator(base):
        def manual_seed(self, seed):
            return super().manual_seed(int(seed) + offset)

    return OffsetGenerator


def card(args) -> int:
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("[study] FAIL: no CUDA card", flush=True)
        return 1
    from drone_image_stitch_cpp_tpu_torch import app as A
    from drone_image_stitch_cpp_tpu_torch.pipeline import strip as TS
    from drone_image_stitch_cpp_tpu_torch.runtime.device import (
        card_name_and_power_limit)
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
    from drone_image_stitch_cpp_tpu_torch.tools import bench_sortie as BS
    from drone_image_stitch_cpp_tpu_torch.tools.sortie_bench import (
        line_rows, make_sortie)

    get_logger().verbose = False
    card_line = card_name_and_power_limit()
    print(f"[study] card: {card_line}", flush=True)
    t0 = time.perf_counter()
    fh, fw = (int(v) for v in args.frame.split("x"))
    root, gt_path = make_sortie(args.work, args.rows, args.cols, fh, fw,
                                device=args.device)
    gt = np.load(gt_path)
    with open(os.path.join(root, "meta.json")) as f:
        lines = line_rows(json.load(f))
    print(f"[study] sortie rendered in {time.perf_counter() - t0:.1f} s",
          flush=True)

    variants = [("cold, defaults, I420", {}, 0, None)]
    variants += [(f"(a) seed offset {k}, I420", {}, k, None)
                 for k in range(5)]
    variants += [("(b) fullres, I420", {"seam_warp": "fullres"}, 0, None),
                 ("(b) dp, I420", {"seam_method": "dp"}, 0, None),
                 ("(b) fullres + dp, I420", {"seam_warp": "fullres",
                                             "seam_method": "dp"}, 0, None),
                 ("(b) defaults, BGR", {"ingest_fmt": "bgr"}, 0, None),
                 ("(b) fullres, BGR", {"ingest_fmt": "bgr",
                                       "seam_warp": "fullres"}, 0, None),
                 ("(b) dp, BGR", {"ingest_fmt": "bgr", "seam_method": "dp"},
                  0, None),
                 ("(c) float32 bundle adjust, I420", {}, 0, "f32"),
                 ("(c) float32 bundle adjust, pairs reversed, I420", {}, 0,
                  "f32 reversed")]
    if args.inject_ba:
        variants.append(("(e) the JAX package's float32 solve, I420", {}, 0,
                         "inject"))
    if args.save_ba:
        variants[0] = variants[0][:3] + ("save",)
    if args.only:
        keep = set(args.only.split(","))
        variants = [v for v in variants if v[0][:3] in keep
                    or v[0].startswith("cold")]
    inject = dict(np.load(args.inject_ba)) if args.inject_ba else {}
    saved = {}

    real_generator = torch.Generator
    real_ba = TS.bundle_adjust_similarity
    real_frames = A.stitch_frames
    ref = None
    for label, kw, offset, ba in variants:
        seen = {}

        def frames(*a, **k):
            seen["result"] = real_frames(*a, **k)
            return seen["result"]

        def adjust(pair_idx, pts_a, pts_b, w, init, dtype=None):
            k = seen.get("ba_calls", 0)
            seen["ba_calls"] = k + 1
            if ba == "save":
                out = real_ba(pair_idx, pts_a, pts_b, w, init)
                for name, x in (("pair_idx", pair_idx), ("pts_a", pts_a),
                                ("pts_b", pts_b), ("w", w), ("init", init),
                                ("float64", out)):
                    saved[f"s{k}_{name}"] = x.cpu().numpy()
                return out
            if ba == "inject":
                if inject[f"s{k}_pair_idx"].shape != tuple(pair_idx.shape):
                    raise RuntimeError(f"strip {k}: the saved system does "
                                       f"not match this run's")
                return torch.from_numpy(inject[f"s{k}_jax"]).to(init.device)
            if ba.endswith("reversed"):
                rev = torch.arange(pair_idx.shape[0] - 1, -1, -1,
                                   device=pair_idx.device)
                pair_idx, pts_a, pts_b, w = (x[rev] for x in (
                    pair_idx, pts_a, pts_b, w))
            return real_ba(pair_idx, pts_a, pts_b, w, init,
                           dtype=torch.float32)

        A.stitch_frames = frames
        if offset:
            torch.Generator = _offset_generator(torch, offset)
        if ba:
            TS.bundle_adjust_similarity = adjust
        try:
            run, mosaic, recs = BS.measure_run(
                root, gt, args.device, "cold" if label.startswith("cold")
                else "warm", retries=0, lines=lines, **kw)
        except Exception as err:    # a failed variant: record it, go on
            _emit(args.out, dict(label=label, card=card_line,
                                 error=f"{type(err).__name__}: {err}"))
            continue
        finally:
            A.stitch_frames = real_frames
            torch.Generator = real_generator
            TS.bundle_adjust_similarity = real_ba
        if ba == "save":
            np.savez(args.save_ba, **saved)
        res = seen["result"]
        geo = dict(groups=[len(g.indices) for g in res.groups],
                   flipped=res.flipped,
                   seam_methods=sorted(set(res.seam_methods.values())),
                   strip_tf=[t.tolist() for t in res.strip_transforms],
                   global_tf=[np.asarray(t).tolist()
                              for t in res.global_transforms])
        if ref is None:
            ref = geo
        rec = dict(label=label, card=card_line, seed_offset=offset,
                   bundle_adjust=ba or "float64", **{
                       k: run[k] for k in (
                           "secs", "gt_rmse", "gt_rmse_lines", "gt_shift",
                           "mosaic_hw", "store_fmt", "seam_warp",
                           "seam_method", "seam_warps_s", "seams_s",
                           "peak_device_gib", "launches")},
                   groups=geo["groups"], flipped=geo["flipped"],
                   seam_methods=geo["seam_methods"],
                   strip_tf_vs_first_px=round(_translation_diff(
                       geo["strip_tf"], ref["strip_tf"]), 4),
                   global_tf_vs_first_px=round(_translation_diff(
                       geo["global_tf"], ref["global_tf"]), 4),
                   global_offsets=[np.round(np.asarray(t)[:2, 2], 3).tolist()
                                   for t in res.global_transforms])
        _emit(args.out, rec)
        del mosaic, res, seen
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


# ---------------------------------------------------------------------------
# cpu: both packages on the same JPEGs
# ---------------------------------------------------------------------------

SWITCHES = {"defaults": ("prescaled", "graphcut"),
            "fullres": ("fullres", "graphcut"),
            "dp": ("prescaled", "dp"),
            "fullres + dp": ("fullres", "dp")}


class _Hooks:
    """Record a package's groups, kept frames, strip transforms, global
    transforms, flips and global seam methods over one application run."""

    def __init__(self, pkg):
        import importlib
        self.app = importlib.import_module(pkg + ".app")
        self.strip = importlib.import_module(pkg + ".pipeline.strip")
        self.glob = importlib.import_module(pkg + ".pipeline.global_")
        self.seam = importlib.import_module(pkg + ".ops.seam")
        self.saved = []

    def _patch(self, mod, name, fn):
        self.saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def __enter__(self):
        rec = self.rec = {"groups": None, "strips": [], "global": None,
                          "seams": []}
        group, est = self.app.group_boustrophedon, \
            self.strip.estimate_strip_transforms
        align, find = self.glob._align_strips_dev, \
            self.seam.find_seams_sequential
        gc, dp = self.seam.graphcut_pairwise_seam, self.seam.pairwise_seam
        state = {"global": False, "dp": False}

        def group_(*a, **k):
            out = group(*a, **k)
            rec["groups"] = [list(g.indices) for g in out]
            return out

        def est_(*a, **k):
            out = est(*a, **k)
            rec["strips"].append((list(out[0]),
                                  np.asarray(out[1]).tolist()))
            return out

        def align_(*a, **k):
            out = align(*a, **k)
            rec["global"] = ([np.asarray(t).tolist() for t in out[0]],
                             list(out[2]))
            state["global"] = True
            return out

        def find_(*a, **k):
            # the global stage's seams come after its alignment
            out = find(*a, **k)
            state["global"] = False
            return out

        def gc_(*a, **k):
            out = gc(*a, **k)
            if state["global"] and out is not None:
                rec["seams"].append("graphcut")
            return out

        def dp_(*a, **k):
            if state["global"] and not state["dp"]:
                rec["seams"].append("dp")
            state["dp"] = True
            try:
                return dp(*a, **k)
            finally:
                state["dp"] = False

        self._patch(self.app, "group_boustrophedon", group_)
        self._patch(self.strip, "estimate_strip_transforms", est_)
        self._patch(self.glob, "_align_strips_dev", align_)
        self._patch(self.seam, "find_seams_sequential", find_)
        self._patch(self.seam, "graphcut_pairwise_seam", gc_)
        self._patch(self.seam, "pairwise_seam", dp_)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        self.saved.clear()


def _port_methods(records):
    rec = next((r for r in records if r["msg"] == "seam methods"), {})
    return [v for k, v in rec.items() if k not in ("ts", "stage", "msg")]


def cpu(args) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import drone_image_stitch_cpp_tpu.runtime.logging as JL
    from drone_image_stitch_cpp_tpu.app import RunConfig as JConfig
    from drone_image_stitch_cpp_tpu.app import (
        run_stitch_application as jrun)
    from drone_image_stitch_cpp_tpu_torch.app import RunConfig as TConfig
    from drone_image_stitch_cpp_tpu_torch.app import (
        run_stitch_application as trun)
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
    from drone_image_stitch_cpp_tpu_torch.tools.sortie_bench import (
        _cv2, gt_rmse_rows, line_rows, make_sortie)

    import torch
    torch.set_num_threads(args.threads)
    cv2 = _cv2()
    cores = os.cpu_count()
    fh, fw = (int(v) for v in args.frame.split("x"))
    root, gt_path = make_sortie(args.work, args.rows, args.cols, fh, fw,
                                device="cpu")
    gt = np.load(gt_path)
    with open(os.path.join(root, "meta.json")) as f:
        lines = line_rows(json.load(f))
    packages = {"jax": ("drone_image_stitch_cpp_tpu", JConfig, jrun,
                        JL.get_logger()),
                "port": ("drone_image_stitch_cpp_tpu_torch", TConfig, trun,
                         get_logger())}
    got = {}
    for name in args.packages.split(","):
        pkg, config, run, logger = packages[name]
        logger.verbose = False
        out_root = os.path.join(args.work, f"_{name}")
        for k, variant in enumerate(args.variants.split(",")):
            warp, method = SWITCHES[variant]
            kw = {}
            if name == "jax":
                os.environ["TM_SEAM_WARP"] = warp
                os.environ["TM_SEAM_METHOD"] = method
            else:
                kw = dict(device="cpu", seam_warp=warp, seam_method=method)
            cfg = config(image_folder=root, image_type="visible",
                         group="minfull", output_root=out_root,
                         resume=k > 0, **kw)
            n0 = len(logger._records)
            t0 = time.perf_counter()
            with _Hooks(pkg) as hooks:
                rc = run(cfg)
            wall = time.perf_counter() - t0
            recs = logger._records[n0:]
            mosaic = cv2.imread(cfg.output_path, cv2.IMREAD_COLOR)
            if rc != 0 or mosaic is None:
                print(f"[study] FAIL: {name} {variant} rc={rc}", flush=True)
                return 1
            rmse, dx, dy, by_line = gt_rmse_rows(mosaic, gt, GT_MAX_DIM,
                                                 lines)
            h = hooks.rec
            if k == 0:
                got[(name, "strips")] = (h["groups"], h["strips"])
            groups, strips = got[(name, "strips")]
            seams = h["seams"] if name == "jax" else _port_methods(recs)
            rec = dict(package=name, variant=variant, seam_warp=warp,
                       seam_method=method, resumed=k > 0, rc=rc,
                       wall_s=round(wall, 2), cpu_cores=cores,
                       gt_rmse=round(rmse, 4),
                       gt_rmse_lines=[round(r, 4) for r in by_line],
                       gt_shift=[round(dx, 2), round(dy, 2)],
                       mosaic_hw=list(mosaic.shape[:2]), groups=groups,
                       kept=[s[0] for s in strips],
                       strip_tf=[s[1] for s in strips],
                       global_tf=h["global"][0], flipped=h["global"][1],
                       seam_methods=seams, ru_maxrss_gib=round(
                           resource.getrusage(resource.RUSAGE_SELF)
                           .ru_maxrss / 2**20, 3))
            got[(name, variant)] = rec
            _emit(args.out, rec)
    for variant in args.variants.split(","):
        j, p = got.get(("jax", variant)), got.get(("port", variant))
        if j is not None and p is not None:
            _emit(args.out, {"compare": _compare(j, p)})
    return 0


def compare(args) -> int:
    """The comparison of ``cpu`` runs written to ``--out`` by separate
    processes (one package each)."""
    with open(args.out) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    got = {(r["package"], r["variant"]): r for r in recs if "package" in r}
    for (name, variant), p in got.items():
        j = got.get(("jax", variant))
        if name == "port" and j is not None:
            print("[study] " + json.dumps({"compare": _compare(j, p)}),
                  flush=True)
    return 0


def _compare(j, p):
    """The JAX package's run ``j`` against the port's ``p``."""
    same = [len(a) == len(b) for a, b in zip(j["strip_tf"], p["strip_tf"])]
    linear = max(np.abs(np.asarray(a)[:2, :2] - np.asarray(b)[:2, :2]).max()
                 for a, b in zip(j["global_tf"], p["global_tf"]))
    return dict(
        variant=p["variant"], groups_equal=j["groups"] == p["groups"],
        kept_equal=j["kept"] == p["kept"],
        strip_tf_worst_px=(round(_translation_diff(
            j["strip_tf"], p["strip_tf"]), 4) if all(same) else None),
        global_tf_worst_px=round(_translation_diff(j["global_tf"],
                                                   p["global_tf"]), 4),
        global_linear_worst=round(float(linear), 6),
        flips_equal=j["flipped"] == p["flipped"],
        seam_methods=[j["seam_methods"], p["seam_methods"]],
        gt_rmse=[j["gt_rmse"], p["gt_rmse"]],
        gt_rmse_lines=[j["gt_rmse_lines"], p["gt_rmse_lines"]],
        mosaic_hw=[j["mosaic_hw"], p["mosaic_hw"]],
        wall_s=[j["wall_s"], p["wall_s"]], cpu_cores=p["cpu_cores"])


def solve_ba(args) -> int:
    """Each strip's bundle-adjust system saved by ``card --save-ba``,
    solved on the CPU by the JAX package's ``bundle_adjust_similarity``
    (float32) and by the port's in float64 and float32 (1 and 8 threads):
    each solution's largest frame displacement from the card's float64
    one (translation, px, and the mean over a 9 x 16 grid of the frame).
    Writes the inputs and the JAX solutions (``s{k}_jax``) to ``--out``
    for ``card --inject-ba``."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from drone_image_stitch_cpp_tpu.pipeline.bundle import (
        bundle_adjust_similarity as jax_ba)
    from drone_image_stitch_cpp_tpu_torch.pipeline.bundle import (
        bundle_adjust_similarity as port_ba)

    data = dict(np.load(args.inputs))
    n_strips = len([k for k in data if k.endswith("_pair_idx")])

    def area(t, ref):
        ys, xs = np.meshgrid(np.linspace(0, FRAME_H - 1, 9),
                             np.linspace(0, FRAME_W - 1, 16), indexing="ij")
        p = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)], -1)
        d = p @ np.asarray(t, np.float64).transpose(0, 2, 1) \
            - p @ np.asarray(ref, np.float64).transpose(0, 2, 1)
        return float(np.linalg.norm(d, axis=-1).mean(axis=-1).max())

    rows = []
    for k in range(n_strips):
        sysk = [data[f"s{k}_{n}"] for n in ("pair_idx", "pts_a", "pts_b",
                                            "w", "init")]
        ref = data[f"s{k}_float64"]
        got = {"jax float32": np.asarray(jax_ba(
            jnp.asarray(sysk[0].astype(np.int32)),
            *(jnp.asarray(x.astype(np.float32)) for x in sysk[1:])))}
        data[f"s{k}_jax"] = got["jax float32"].astype(np.float32)
        for name, dtype, threads in (("port float64", torch.float64, 8),
                                     ("port float32, 1 thread",
                                      torch.float32, 1),
                                     ("port float32, 8 threads",
                                      torch.float32, 8)):
            torch.set_num_threads(threads)
            got[name] = port_ba(*(torch.from_numpy(x) for x in sysk),
                                dtype=dtype).numpy()
        rec = {"strip": k, "frames": int(ref.shape[0]),
               "pairs": int(sysk[0].shape[0])}
        for name, t in got.items():
            rec[name] = {"max_translation_px": round(_translation_diff(
                [t], [ref]), 4), "max_area_px": round(area(t, ref), 4)}
        rows.append(rec)
        print("[study] " + json.dumps(rec), flush=True)
    np.savez(args.out, **data)
    for name in rows[0]:
        if isinstance(rows[0][name], dict):
            print(f"[study] {name}: worst over strips "
                  f"{max(r[name]['max_translation_px'] for r in rows)} px "
                  f"translation, {max(r[name]['max_area_px'] for r in rows)}"
                  f" px area", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("card")
    c.add_argument("--out", required=True)
    c.add_argument("--only", default=None,
                   help="comma list of (a), (b), (c): run only those")
    c.add_argument("--device", default="cuda:0")
    c.add_argument("--work", default=os.path.join(ROOT, "build",
                                                  "sortie200"))
    c.add_argument("--rows", type=int, default=10)
    c.add_argument("--cols", type=int, default=20)
    c.add_argument("--frame", default=f"{FRAME_H}x{FRAME_W}")
    c.add_argument("--save-ba", default=None,
                   help="save the cold run's strip bundle-adjust systems "
                        "(npz) for the ba mode")
    c.add_argument("--inject-ba", default=None,
                   help="the ba mode's npz: add a run whose strips take "
                        "the JAX package's solutions")
    b = sub.add_parser("ba")
    b.add_argument("--inputs", required=True, help="card --save-ba's npz")
    b.add_argument("--out", required=True,
                   help="npz of the inputs and the JAX package's solutions")
    p = sub.add_parser("cpu")
    p.add_argument("--out", required=True)
    p.add_argument("--work", required=True,
                   help="where the cut sortie and the outputs go")
    p.add_argument("--rows", type=int, default=3)
    p.add_argument("--cols", type=int, default=6)
    p.add_argument("--frame", default=f"{FRAME_H}x{FRAME_W}")
    p.add_argument("--packages", default="port,jax")
    p.add_argument("--variants", default="defaults,fullres,dp,fullres + dp")
    p.add_argument("--threads", type=int, default=4,
                   help="torch's intra-op threads")
    q = sub.add_parser("compare")
    q.add_argument("--out", required=True, help="a cpu run's --out file")
    args = ap.parse_args(argv)
    return {"card": card, "cpu": cpu, "compare": compare,
            "ba": solve_ba}[args.mode](args)


if __name__ == "__main__":
    sys.exit(main())
