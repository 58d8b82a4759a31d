"""Traffic kind ``thermal``: whole production runs of a thermal survey,
one at a time.

A :class:`sortie.Sortie` in all but its inputs and its modality: the
folder is the configuration's thermal sortie (``render_thermal``: the
seeded terrain seen by a long-wave infrared core, each frame under the
seed's own sensor noise), stitched by ``app.run_stitch_application``
with the configuration's ``image_type`` (``lwir``: the upstream's lwir
preset), and each output is scored against the planted thermal truth by
``reference.sortie_numbers``, as a sortie's is.

Traffic file keys: those of ``sortie``.
"""

from __future__ import annotations

import os
import time

import cv2
import numpy as np

from . import sortie as S
from .. import reference as REF
from ..harness import log
from ..render_thermal import render_thermal, thermal_layout


class Thermal(S.Sortie):
    def __init__(self, config, traffic, seed, device, work):
        from drone_image_stitch_cpp_tpu_torch.runtime.logging import (
            get_logger)
        self.cfg, self.traffic, self.device = config, traffic, device
        self.work = work
        self.log = get_logger()
        self.group = (config["image_type"], "minfull")
        self.lines = int(traffic["lines"])
        c = config
        self.cols = int(c["frames_per_line"])
        self.frame_h, self.frame_w = int(c["frame_h"]), int(c["frame_w"])
        self.step_y, self.step_x, _, _, _ = thermal_layout(
            self.lines, self.cols, self.frame_h, self.frame_w,
            c["overlap"], c["overlap_y"])
        self.in_root = os.path.join(work, "in")
        t0 = time.perf_counter()
        self.gt = render_thermal(os.path.join(self.in_root, *self.group),
                                 self.lines, self.cols, self.frame_h,
                                 self.frame_w, c["overlap"], c["overlap_y"],
                                 seed=int(traffic["terrain_seed"]),
                                 noise_seed=seed, jpeg_q=int(c["jpeg_q"]),
                                 device=device, cache_dir=S.TERRAIN_CACHE)
        self.kept = {}
        t1 = time.perf_counter()
        if traffic["warmup"]:
            self._warm_up()
        log(f"set-up: render {t1 - t0:.3f} s, warm-up "
            f"{time.perf_counter() - t1:.3f} s")

    def _run_config(self, in_root, out_root):
        from drone_image_stitch_cpp_tpu_torch.app import RunConfig
        return RunConfig(image_folder=in_root, image_type=self.group[0],
                         group=self.group[1], output_root=out_root,
                         device=str(self.device), **self.cfg["run_config"])

    def numbers(self, out_dir):
        """The reference's numbers of one kept output directory."""
        d = os.path.join(out_dir, *self.group)
        mosaic = cv2.imread(os.path.join(
            d, f"{self.group[0]}_{self.group[1]}_uav_panorama.jpg"),
            cv2.IMREAD_COLOR)
        sdir = os.path.join(d, "strips")
        strips = None
        if self.lines > 1:
            names = sorted(f for f in os.listdir(sdir) if f.endswith(".npy")) \
                if os.path.isdir(sdir) else []
            strips = [np.load(os.path.join(sdir, f)) for f in names]
        return REF.sortie_numbers(mosaic, strips, self.gt, self.lines,
                                  self.frame_h, self.step_y, self.step_x,
                                  int(self.cfg["gt_max_dim"]))
