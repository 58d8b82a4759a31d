"""Traffic kind ``sortie``: whole production runs, one at a time.

Each unit of work is one ``app.run_stitch_application`` of the program,
from a folder of JPEGs on disk to the mosaic JPEG on disk, with the
configuration's ``RunConfig`` fields: the closed loop of a crew that
stitches one sortie after another. The folder is rendered once at
set-up (``render.render_sortie``); every unit stitches it again. A
unit's clock starts after ``torch.cuda.synchronize()`` and stops after
the run has returned (the mosaic file closed) and the card is
synchronised; clearing the previous output is off the clock.

Every unit's outputs (the mosaic and, for several lines, the lossless
strip checkpoint) are hashed off the clock; the first output of each
distinct hash is kept and scored against the planted ground truth once
the window has closed, so every answer of the window is checked.

Traffic file keys: ``kind``, ``lines`` (flight lines),
``terrain_seed`` (the terrain every seed flies; ``--seed`` draws its
sensor noise; the terrain is kept in ``build/mosaicbench/terrain`` of
the checkout, made by its first run), ``warmup`` (stitch the sortie
once at set-up), ``max_kept`` (distinct outputs scored at most).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import time

import numpy as np

from . import sync
from .. import reference as REF
from ..harness import ROOT, log
from ..render import render_sortie, sortie_layout

GROUP = ("visible", "minfull")
# the terrains under the seeds' noise, made by a checkout's first run
TERRAIN_CACHE = os.path.join(ROOT, "build", "mosaicbench", "terrain")


class Sortie:
    def __init__(self, config, traffic, seed, device, work):
        from drone_image_stitch_cpp_tpu_torch.runtime.logging import (
            get_logger)
        self.cfg, self.traffic, self.device = config, traffic, device
        self.work = work
        self.log = get_logger()
        self.lines = int(traffic["lines"])
        c = config
        self.cols = int(c["frames_per_line"])
        self.frame_h, self.frame_w = int(c["frame_h"]), int(c["frame_w"])
        self.step_y, self.step_x, _, _, _ = sortie_layout(
            self.lines, self.cols, self.frame_h, self.frame_w,
            c["overlap"], c["overlap_y"])
        self.in_root = os.path.join(work, "in")
        t0 = time.perf_counter()
        # one terrain for every seed, under the seed's own sensor noise:
        # the seam problems' size and difficulty follow the terrain
        self.gt = render_sortie(os.path.join(self.in_root, *GROUP),
                                self.lines, self.cols, self.frame_h,
                                self.frame_w, c["overlap"], c["overlap_y"],
                                seed=int(traffic["terrain_seed"]),
                                jpeg_q=int(c["jpeg_q"]), device=device,
                                noise_seed=seed, cache_dir=TERRAIN_CACHE)
        self.kept = {}          # hash -> output directory
        t1 = time.perf_counter()
        if traffic["warmup"]:
            self._warm_up()
        log(f"set-up: render {t1 - t0:.3f} s, warm-up "
            f"{time.perf_counter() - t1:.3f} s")

    # -- the program's run -------------------------------------------------
    def _run_config(self, in_root, out_root):
        from drone_image_stitch_cpp_tpu_torch.app import RunConfig
        return RunConfig(image_folder=in_root, image_type=GROUP[0],
                         group=GROUP[1], output_root=out_root,
                         device=str(self.device), **self.cfg["run_config"])

    def _warm_up(self):
        """Stitch the cell's sortie once: the first run at full size pays
        for allocations and library set-up that a shorter one leaves to
        the window (the global stage's align and seam warps)."""
        from drone_image_stitch_cpp_tpu_torch.app import (
            run_stitch_application)
        out = os.path.join(self.work, "warm_out")
        rc = run_stitch_application(self._run_config(self.in_root, out))
        if rc != 0:
            raise RuntimeError(f"the warm-up sortie failed: rc={rc}")
        shutil.rmtree(out)

    def unit(self, span=None, spans=False):
        """One sortie: {seconds, ok, records (the program's log records of
        this run)}; ``span`` names the run for a trace."""
        from drone_image_stitch_cpp_tpu_torch.app import (
            run_stitch_application)
        out = os.path.join(self.work, "out")
        cfg = self._run_config(self.in_root, out)
        n0 = len(self.log._records)
        sync(self.device)
        w0 = time.time()
        t0 = time.perf_counter()
        rc = run_stitch_application(cfg)
        sync(self.device)
        secs = time.perf_counter() - t0
        records = self.log._records[n0:]
        if span is not None:
            for r in records:
                if "seconds" in r:
                    span(f"{r['stage']} {r['msg'].replace(' done', '')}",
                         r["ts"] - r["seconds"], r["ts"])
            span("sortie", w0, w0 + secs)
        return {"seconds": secs, "ok": rc == 0
                and os.path.exists(cfg.output_path), "records": records,
                "out": out, "mosaic": cfg.output_path,
                "strips": cfg.strips_dir}

    def trace_units(self, span):
        """The traced span: one sortie."""
        return [self.unit(span=span)]

    def between(self, rec):
        """Off the clock: hash the unit's outputs; keep the first of each
        distinct hash for scoring, delete the rest."""
        out = rec.pop("out")
        if rec["ok"]:
            files = [rec["mosaic"]] + sorted(
                os.path.join(rec["strips"], f)
                for f in (os.listdir(rec["strips"])
                          if os.path.isdir(rec["strips"]) else ())
                if f.endswith(".npy"))
            h = hashlib.sha1()
            for f in files:
                with open(f, "rb") as fh:
                    while chunk := fh.read(1 << 24):
                        h.update(chunk)
            rec["hash"] = h.hexdigest()
            if rec["hash"] not in self.kept and \
                    len(self.kept) < int(self.traffic["max_kept"]):
                keep = os.path.join(self.work, f"kept{len(self.kept)}")
                os.rename(out, keep)
                self.kept[rec["hash"]] = keep
        shutil.rmtree(out, ignore_errors=True)

    # -- the check ---------------------------------------------------------
    def numbers(self, out_dir):
        """The reference's numbers of one kept output directory."""
        import cv2
        d = os.path.join(out_dir, *GROUP)
        mosaic_path = os.path.join(
            d, f"{GROUP[0]}_{GROUP[1]}_uav_panorama.jpg")
        mosaic = cv2.imread(mosaic_path, cv2.IMREAD_COLOR)
        sdir = os.path.join(d, "strips")
        strips = None
        if self.lines > 1:
            names = sorted(f for f in os.listdir(sdir) if f.endswith(".npy")) \
                if os.path.isdir(sdir) else []
            strips = [np.load(os.path.join(sdir, f)) for f in names]
        return REF.sortie_numbers(mosaic, strips, self.gt, self.lines,
                                  self.frame_h, self.step_y, self.step_x,
                                  int(self.cfg["gt_max_dim"]))

    def check(self, units):
        """(failed units, {number: worst reading over the kept outputs},
        units whose output no kept output stands for, outputs scored)."""
        failed = sum(not u["ok"] for u in units)
        nums = [self.numbers(d) for d in self.kept.values()]
        unscored = sum(u.get("hash") not in self.kept for u in units
                       if u["ok"])
        return failed, REF.worst_of(nums), unscored, len(nums)

    def trace_names(self):
        """{kernel name in the trace: its launch counter}: the trace holds
        a record of every launch, or it lost some."""
        return {"sift_orient_desc_kernel": "sift_orient_desc"}

    def close(self):
        self.gt = None
