"""Traffic kind ``triage``: registration batches, one at a time.

Each unit of work is one batch of gray 4K frames through the program's
registration path, as a crew triaging frames as they land would run it:
``tools/bench_throughput.prep`` (area resize to the work size, edge pad),
``ops/features.detect_and_describe_batched`` (K1), ``register`` (the
neighbour pairs' kNN-2 ratio match and similarity RANSAC as one batch)
and ``warp_sums`` (every frame but the first warped at full size by its
pair's model, one launch of K2's single-plane form, each warp summed),
then ``torch.cuda.synchronize()``. A few distinct batches are cut from
one seeded ortho at set-up (``render.make_batches``), placed on the card
and cycled. With ``spans``, the stages are synchronised and timed one by
one (the per-layer spans of a traced run).

Every batch's outputs (the pair models and warp sums) stay on the card
until the window has closed; the first answer for each distinct batch is
held against the planted truth (``reference.triage_numbers``) and every
later answer for the same batch must equal it bit for bit, else it is
scored too.

Traffic file keys: ``kind``, ``batches`` (distinct batches), ``batch_dy``
and ``batch_dx`` (each batch's offset into the ortho), ``warmup_rounds``
(passes over the batches at set-up).
"""

from __future__ import annotations

import time

import torch

from . import sync
from .. import reference as REF
from ..harness import log
from ..render import make_batches
from ..work import k1_bound, k2_plane_bound


class Triage:
    def __init__(self, config, traffic, seed, device, work):
        from drone_image_stitch_cpp_tpu_torch.tools import (
            bench_throughput as BT)
        self.BT = BT
        self.cfg, self.traffic, self.device = config, traffic, device
        c = config
        self.n = int(c["frames"])
        self.frame_h, self.frame_w = int(c["frame_h"]), int(c["frame_w"])
        self.n_features = int(c["sift_features"])
        # the program's registration fixes these; the file must state them
        if (float(c["ratio"]), float(c["ransac_thresh_px"])) != (
                BT.RATIO, BT.RANSAC_THRESH):
            raise ValueError(f"the configuration's ratio and RANSAC "
                             f"threshold are not the program's "
                             f"({BT.RATIO}, {BT.RANSAC_THRESH})")
        t0 = time.perf_counter()
        frames = make_batches(int(traffic["batches"]), self.n, self.frame_h,
                              self.frame_w, int(c["step_y"]),
                              int(c["step_x"]), int(traffic["batch_dy"]),
                              int(traffic["batch_dx"]), seed=seed)
        self.frames = torch.from_numpy(frames).to(device)
        del frames
        self.geometry = BT.work_geometry(self.frame_h, self.frame_w,
                                         float(c["reg_mpx"]))
        self.banks = BT.sample_banks(self.n - 1,
                                     int(c["ransac_hypotheses"])).to(device)
        self.planted = REF.planted_model(
            self.frame_h, self.frame_w, self.geometry[1], self.geometry[2],
            int(c["step_y"]), int(c["step_x"]))
        self.k = 0
        # a control puts its own stage in place of these
        self.register, self.warp_sums = BT.register, BT.warp_sums
        t1 = time.perf_counter()
        for _ in range(int(traffic["warmup_rounds"])):
            for _ in range(self.frames.shape[0]):
                self.between(self.unit())
        log(f"set-up: batches {t1 - t0:.3f} s, warm-up "
            f"{time.perf_counter() - t1:.3f} s")

    def unit(self, span=None, spans=False):
        """One batch: {seconds, batch, models, ok, sums} (outputs on the
        card); with ``spans`` also {prep, detect, register, warp} seconds,
        each synchronised; ``span`` names the stages for a trace."""
        BT, dev = self.BT, self.device
        b = self.k % self.frames.shape[0]
        self.k += 1
        f = self.frames[b]
        marks = [("prep", time.time())]
        t = [time.perf_counter()]

        def stage(name):
            if spans:
                sync(dev)
            t.append(time.perf_counter())
            marks.append((name, time.time()))

        small = BT.prep(f, self.geometry)
        stage("detect")
        feats = BT.detect_and_describe_batched(small, self.n_features)
        stage("register")
        res, _ = self.register(feats, self.banks)
        stage("warp")
        sums = self.warp_sums(f, res.model)
        sync(dev)
        t.append(time.perf_counter())
        marks.append(("", time.time()))
        if span is not None:
            for (name, a), (_, e) in zip(marks, marks[1:]):
                span(name, a, e)
        rec = {"seconds": t[-1] - t[0], "batch": b, "models": res.model,
               "ok": res.ok, "sums": sums}
        if spans:
            rec.update({name: t[i + 1] - t[i] for i, (name, _) in
                        enumerate(marks[:-1])})
        return rec

    def between(self, rec):
        pass

    def trace_units(self, span):
        """The traced span: ``trace_batches`` batches back to back."""
        return [self.unit(span=span)
                for _ in range(int(self.traffic["trace_batches"]))]

    def check(self, units):
        """(failed units, {number: worst reading}, units not scored,
        answers scored). The
        first answer for each batch is scored; a later one that differs
        from it in any bit is scored too."""
        first, scored, nums = {}, [], []
        for u in units:
            ok = bool(u["ok"].all())
            u["ok"] = ok
            f = first.get(u["batch"])
            if f is None:
                first[u["batch"]] = u
                scored.append(u)
            elif not (torch.equal(f["models"], u["models"])
                      and torch.equal(f["sums"], u["sums"])):
                scored.append(u)
        for u in scored:
            nums.append(REF.triage_numbers(
                self.frames[u["batch"]], u["models"].cpu().numpy(),
                u["sums"].cpu().numpy(), self.planted,
                self.geometry[1:3]))
        failed = sum(not u["ok"] for u in units)
        return failed, REF.worst_of(nums), 0, len(nums)

    def bounds(self, units):
        """{kernel name in the trace: seconds the card's peaks allow for
        the traced units' calls}, from what each call was given: K1 the
        Gaussian stack and keypoints of its batch (selected again by the
        program's ``select_keypoints`` on the same batch), K2 the planes
        and the models."""
        from drone_image_stitch_cpp_tpu_torch.ops.features import (
            select_keypoints)
        k1 = k2 = 0.0
        for u in units:
            f = self.frames[u["batch"]]
            sel = select_keypoints(self.BT.prep(f, self.geometry),
                                   self.n_features)
            k1 += k1_bound(sel.gauss_flat, sel.flat_layer, sel.yf, sel.xf,
                           sel.sigma, sel.true_h, sel.true_w)
            k2 += k2_plane_bound(u["models"][:, :2].cpu().numpy(),
                                 self.frame_h, self.frame_w, self.device)
        return {"sift_orient_desc_kernel": k1, "warp_plane_kernel": k2}

    def trace_names(self):
        return {"sift_orient_desc_kernel": "sift_orient_desc",
                "warp_plane_kernel": "warp_affine_plane"}

    def close(self):
        self.frames = None
