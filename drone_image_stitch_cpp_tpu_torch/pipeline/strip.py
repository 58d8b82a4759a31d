"""N-frame strip stitching: the cv::Stitcher SCANS-mode pipeline.

Port of the joint path of ``drone_image_stitch_cpp_tpu/pipeline/strip.py``
(stitchRobustly / createConfiguredStitcher, stitch_robust.cpp:174-271,
337-376): one batched detect, banded match + RANSAC, biggest-component
filter on pano_conf_thresh, affine-partial bundle adjustment, seam-scale
warps of every frame (K2), block-gain exposure surfaces, DP seams, and a
multiband compose fed frame by frame (K2 again): whole canvas, or through
tiles when the canvas pyramid exceeds ``ops/blend.TILED_THRESHOLD_BYTES``.
A tiled strip's crop box comes from the tiles' device content flags, and
with ``return_device=True`` its panorama stays on the device as a
:class:`runtime.handoff.DeviceStrip` for the global stage.

Not ported yet: the sequential anchor-window fallback (a failed joint
stitch raises :class:`StripStitchError`), the perspective warper and a
compositing resolution below full size.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config.tuning import StitchTuning
from ..ops import blend as B
from ..ops import exposure as E
from ..ops import seam as S
from ..ops.crop import auto_crop_black_border
from ..ops.resize import scale_for_megapixels
from ..ops.warp_kernel import warp_frames
from ..runtime.device import device_sync
from ..runtime.handoff import DeviceStrip
from ..runtime.logging import get_logger
from . import compose_feed as CF
from .bundle import bundle_adjust_similarity, params_from_affine
from .pairgraph import (all_pairs, banded_pairs, biggest_component,
                        chain_init, register_pairs)
from .registration import detect_features

_LOWE_RATIO = 0.75


class StripStitchError(RuntimeError):
    """The joint strip stitch failed (the sequential fallback is not
    ported)."""


class _Frames:
    """Uniform access to a strip's frames: host list or device store."""

    def __init__(self, images, store, indices, device):
        self.images = images
        self.store = store
        self.indices = indices
        self.device = store.device if store is not None else device
        self.n = len(indices) if store is not None else len(images)
        self.shape = (tuple(store.shape0) if store is not None
                      else images[0].shape)

    def device_frame(self, k: int) -> torch.Tensor:
        if self.store is not None:
            return self.store.frame(self.indices[k])
        return torch.from_numpy(np.ascontiguousarray(self.images[k])).to(
            self.device)

    def device_batch(self) -> torch.Tensor:
        """All n frames as one (n, H, W, 3) uint8 device tensor, for
        reading only: from a store it may be a view of the store's frames
        (``FrameStore.batch``), so it must not be written."""
        if self.store is not None:
            return self.store.batch(self.indices)
        return torch.from_numpy(np.stack(self.images)).to(self.device)


def estimate_strip_transforms(images: Optional[List[np.ndarray]],
                              tuning: StitchTuning,
                              range_width: Optional[int] = None,
                              stage: str = "Strip", seed: int = 0,
                              device: Optional[torch.device] = None,
                              store=None,
                              indices: Optional[List[int]] = None):
    """Registration: features -> banded pair graph -> component -> BA.

    Returns (kept_indices, transforms (n_kept, 2, 3) float32 frame->frame0
    numpy, graph).
    """
    log = get_logger()
    n = len(images) if images is not None else len(indices)
    rw = range_width if range_width is not None else tuning.range_width
    feats, scale = detect_features(images, tuning.sift_features,
                                   tuning.registration_resol_mpx,
                                   device=device, store=store,
                                   indices=indices)
    pairs = banded_pairs(n, rw) if tuning.use_range_matcher else all_pairs(n)
    if not pairs:
        raise StripStitchError(f"{stage}: empty pair schedule")
    graph = register_pairs(feats, pairs, _LOWE_RATIO, thresh=4.0 / scale,
                           seed=seed)
    conf = graph.conf.cpu().numpy()
    ok = graph.ok.cpu().numpy()
    keep = ok & (conf >= tuning.pano_conf_thresh)
    log.log(stage, "pair graph", pairs=len(pairs), kept=int(keep.sum()),
            mean_conf=float(conf[ok].mean()) if ok.any() else 0.0)

    if n == 2:
        # 2-image pair gates (stitchWithMode, stitch_robust.cpp:233-243)
        ng = int(graph.n_good[0])
        ni = int(graph.n_inliers[0])
        if (not bool(ok[0])) or ng < tuning.min_good_matches \
                or ni < tuning.min_inliers:
            raise StripStitchError(
                f"{stage}: pair gates failed (good={ng} inliers={ni}, "
                f"need {tuning.min_good_matches}/{tuning.min_inliers})")

    comp = biggest_component(n, graph.pairs, keep)
    if len(comp) < 2:
        raise StripStitchError(
            f"{stage}: pair graph too weak (component={len(comp)})")
    comp_set = set(comp)
    models = graph.model.cpu().numpy()
    init_t = chain_init(n, graph.pairs, models, keep, conf)

    if tuning.use_affine_bundle:
        pk = [k for k, (i, j) in enumerate(graph.pairs)
              if keep[k] and int(i) in comp_set and int(j) in comp_set]
        dev = graph.model.device
        pk_t = torch.as_tensor(pk, dtype=torch.long, device=dev)
        init_params = params_from_affine(
            torch.from_numpy(init_t[:, :2, :]).to(dev))
        refined = bundle_adjust_similarity(
            torch.from_numpy(graph.pairs).to(dev)[pk_t], graph.pts_a[pk_t],
            graph.pts_b[pk_t], graph.w[pk_t], init_params)
        transforms = refined.cpu().numpy()
        if not np.isfinite(transforms).all():
            log.log(stage, "bundle adjust produced non-finite transforms; "
                           "keeping chain init")
            transforms = init_t[:, :2, :]
    else:
        transforms = init_t[:, :2, :]
    if not np.isfinite(transforms).all():
        raise StripStitchError(f"{stage}: non-finite transforms")
    kept = sorted(comp_set)
    return kept, transforms[np.asarray(kept)], graph


def _axes_from_transforms(transforms: np.ndarray) -> List[str]:
    """Seam axis per adjacent pair from the dominant translation."""
    axes = []
    for i in range(len(transforms) - 1):
        dt = transforms[i + 1][:, 2] - transforms[i][:, 2]
        axes.append("vertical" if abs(dt[0]) >= abs(dt[1]) else "horizontal")
    return axes


def compose_strip(images: Optional[List[np.ndarray]],
                  transforms: np.ndarray, tuning: StitchTuning,
                  stage: str = "Strip",
                  device: Optional[torch.device] = None, store=None,
                  indices: Optional[List[int]] = None,
                  return_device: bool = False):
    """Seam-scale warps + gains + DP seams + multiband blend at full
    resolution. Returns the cropped (H, W, 3) uint8 host panorama, or,
    with ``return_device`` and a tiled canvas, a :class:`DeviceStrip`.
    """
    log = get_logger()
    fr = _Frames(images, store, indices, device)
    n = fr.n
    h, w = fr.shape[:2]
    if not tuning.use_affine_warper:
        raise NotImplementedError(
            "use_affine_warper=False (perspective compose) is not ported")
    if scale_for_megapixels(h, w, tuning.compositing_resol_mpx) < 1.0:
        raise NotImplementedError(
            "compositing below full resolution is not ported")
    sync = device_sync(fr.device)

    # canvas bbox over all transformed corners (host numpy)
    tf = np.asarray(transforms, np.float32)
    corners = np.asarray([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0],
                          [0.0, h - 1.0]], np.float32)
    boxes = []
    for t in tf:
        pts = corners @ t[:, :2].T + t[:, 2]
        boxes.append((pts[:, 0].min(), pts[:, 1].min(),
                      pts[:, 0].max(), pts[:, 1].max()))
    # integer canvas origin: a fractional shift would resample every frame
    x0 = float(np.floor(min(b[0] for b in boxes)))
    y0 = float(np.floor(min(b[1] for b in boxes)))
    x1 = max(float(b[2]) for b in boxes)
    y1 = max(float(b[3]) for b in boxes)
    canvas_w = int(np.ceil(x1 - x0)) + 1
    canvas_h = int(np.ceil(y1 - y0)) + 1
    shift3 = np.asarray([[1, 0, -x0], [0, 1, -y0], [0, 0, 1]], np.float32)
    t_canvas = [(shift3 @ np.vstack([t, [0.0, 0.0, 1.0]]))[:2].astype(
        np.float32) for t in tf]
    log.log(stage, "canvas", h=canvas_h, w=canvas_w)
    # the strip stage uses the configured band count (the adaptive formula
    # belongs to the global stage, stitch_global.cpp:632-635)
    bands = max(1, tuning.blend_bands)
    use_tiled = (B.pyramid_bytes(canvas_h, canvas_w, bands)
                 > B.TILED_THRESHOLD_BYTES)
    if use_tiled:
        bands = B.tiled_bands(canvas_h, canvas_w, bands)
        log.log(stage, "tiled compose",
                tiles=len(B.mb_tile_grid(canvas_h, canvas_w, bands)[0]),
                bands=bands)
    else:
        B.ensure_canvas_fits(canvas_h, canvas_w, bands, fr.device)

    # ---- seam-scale warps (K2: every frame + footprint in ONE launch, as
    # the JAX package's _seam_warp_batch) ---------------------------------
    seam_scale = scale_for_megapixels(h, w, tuning.seam_estimation_resol_mpx)
    # dims snapped up to a 64 grid like the JAX package: the pad is mask-
    # empty and contributes nothing to the hat upsample
    sh = B.align_up(max(1, int(round(canvas_h * seam_scale))), 64)
    sw = B.align_up(max(1, int(round(canvas_w * seam_scale))), 64)
    ssc = np.diag([seam_scale, seam_scale]).astype(np.float32)
    with log.timer(stage, "seam warps", sync=sync):
        simgs, scms = warp_frames(
            fr.device_batch(),
            np.stack([ssc @ t for t in t_canvas]).astype(np.float32),
            sh, sw)
        smasks = scms >= 0.5
        seam_imgs, seam_masks = list(simgs), list(smasks)

    gain_maps = None
    if tuning.use_blocks_gain:
        with log.timer(stage, "gains", sync=sync):
            gain_maps = E.block_gain_maps(simgs.mean(dim=-1), smasks,
                                          block=max(8, 32 * sh // 1024))
        log.log(stage, "gains", gains=[
            round(float(g), 3) for g in gain_maps.mean(dim=(1, 2)).cpu()])

    axes = _axes_from_transforms(np.asarray(transforms))
    with log.timer(stage, "seams", sync=sync):
        seam_masks = S.find_seams_sequential(seam_imgs, seam_masks, axes)
    del seam_imgs, simgs

    # ---- full-res compose: ROI warp -> canvas pyramid --------------------
    def feed_roi(cv, k, oy, ox, ch_, cw_):
        """Feed frame k into a canvas pyramid whose origin is (ox, oy)."""
        bx0, by0 = boxes[k][0] - x0 - ox, boxes[k][1] - y0 - oy
        bx1, by1 = boxes[k][2] - x0 - ox, boxes[k][3] - y0 - oy
        tlx, tly, rh_b, rw_b = B.bucketed_window(
            float(bx0), float(by0), float(bx1), float(by1), bands, ch_, cw_)
        gx, gy = ox + tlx, oy + tly     # canvas offsets of the ROI
        t_full = t_canvas[k].copy()
        t_full[0, 2] -= gx
        t_full[1, 2] -= gy
        return CF.feed_frame(
            cv, fr.device_frame(k), seam_masks[k], t_full, tlx, tly,
            float(gx), float(gy), seam_scale, rh_b, rw_b,
            gain_m1=(gain_maps[k] - 1.0 if gain_maps is not None
                     else None))

    if use_tiled:
        frame_boxes = [(b[0] - x0, b[1] - y0, b[2] - x0, b[3] - y0)
                       for b in boxes]
        with log.timer(stage, "tiled blend", sync=sync):
            out, bbox = B.mb_compose_tiled(
                canvas_h, canvas_w, bands, frame_boxes, feed_roi, fr.device,
                assemble="device" if return_device else "host")
        if bbox is None:
            raise StripStitchError(f"{stage}: blended canvas is empty")
        if return_device:
            return DeviceStrip(out, bbox)
        # the crop box comes from the tiles' device content flags: a slice
        # here instead of a host gray pass over the panorama
        by0, by1, bx0, bx1 = bbox
        return np.ascontiguousarray(out[by0:by1, bx0:bx1])

    with log.timer(stage, "blend", sync=sync):
        canvas = B.mb_prepare(canvas_h, canvas_w, bands, fr.device)
        ch_, cw_ = canvas.wacc[0].shape
        for k in range(n):
            canvas = feed_roi(canvas, k, 0, 0, ch_, cw_)
        out, _ = B.mb_blend(canvas, canvas_h, canvas_w)
        pano = B.clip_u8(out).cpu().numpy()
        del canvas, out
    with log.timer(stage, "crop"):
        return auto_crop_black_border(pano)


def stitch_strip(images: Optional[List[np.ndarray]],
                 tuning: Optional[StitchTuning] = None,
                 stage: str = "Strip",
                 range_width_override: Optional[int] = None,
                 image_tags: Optional[Sequence[str]] = None,
                 seed: int = 0, device: Optional[torch.device] = None,
                 store=None, indices: Optional[List[int]] = None,
                 info: Optional[dict] = None, return_device: bool = False):
    """Joint strip stitch (stitchRobustly's first rung,
    stitch_robust.cpp:337-376); raises StripStitchError on failure.

    ``image_tags``: optional per-frame tags for the logged pair plan.
    ``info``: optional dict that receives ``kept`` (kept frame positions)
    and ``transforms`` ((n_kept, 2, 3) frame->frame0).
    ``return_device``: a tiled panorama comes back as a
    :class:`DeviceStrip`; small canvases still return host arrays.
    """
    log = get_logger()
    tuning = tuning or StitchTuning()
    n = len(images) if images is not None else len(indices)
    if n == 0:
        raise StripStitchError(f"{stage}: need at least one image")
    if n == 1:
        if info is not None:
            info.update(kept=[0], transforms=np.asarray(
                [[[1, 0, 0], [0, 1, 0]]], np.float32))
        return (images[0].copy() if images is not None
                else store.host_frame(indices[0]).copy())
    if image_tags:
        log.log(stage, "plan", pairs=", ".join(
            f"{a}->{b}" for a, b in zip(image_tags, image_tags[1:])))
    sync = device_sync(store.device if store is not None
                       else torch.device(device))
    with log.timer(stage, "register", sync=sync):
        kept, transforms, _ = estimate_strip_transforms(
            images, tuning, range_width_override, stage, seed,
            device=device, store=store, indices=indices)
    if len(kept) < n:
        log.log(stage, "dropped weak frames",
                dropped=[i for i in range(n) if i not in set(kept)])
    if info is not None:
        info.update(kept=kept, transforms=transforms)
    return compose_strip(
        None if images is None else [images[i] for i in kept], transforms,
        tuning, stage, device=device, store=store,
        indices=None if indices is None else [indices[i] for i in kept],
        return_device=return_device)
