"""N-frame strip stitching: the cv::Stitcher SCANS-mode pipeline.

Port of ``drone_image_stitch_cpp_tpu/pipeline/strip.py`` (stitchRobustly /
createConfiguredStitcher, stitch_robust.cpp:174-271, 337-376). The joint
path: one batched detect, banded match + RANSAC, biggest-component
filter on pano_conf_thresh, affine-partial bundle adjustment, seam-scale
warps of every frame (K2), block-gain exposure surfaces, DP seams, and a
multiband compose fed frame by frame (K2 again): whole canvas, or through
tiles when the canvas pyramid exceeds ``ops/blend.TILED_THRESHOLD_BYTES``.
A tiled strip's crop box comes from the tiles' device content flags, and
with ``return_device=True`` its panorama stays on the device as a
:class:`runtime.handoff.DeviceStrip` for the global stage.

The fallback ladder (stitch_robust.cpp:273-334, 360-375): when the joint
stitch fails and no matching mask was given, :func:`_stitch_sequential`
folds the frames into a growing mosaic, registering an anchor batch
[mosaic, anchors..., next] (mixed frame sizes: a mixed-size detect batch
and the non-uniform compose), then the bare pair; a step that fails both
dumps the pair's diagnostics and raises. 2-image jobs pass the
min_good_matches / min_inliers gates with a diagnostics record.

Two knobs of the compose (stitch_robust.cpp:185, 203-205), as the JAX
package has them: ``compositing_resol_mpx`` > 0 area-resizes the frames on
the device to the megapixel budget and composes them unquantised, as
float32 (K2's float32 source), with the transforms rescaled;
``use_affine_warper=False`` sends the seam-scale warps and every compose
feed through the plain perspective warp (``ops/warp.warp_perspective``)
instead of K2.

A ``yuv420`` frame store's packed I420 frames go to K2's I420 source (one
batched launch for the seam warps, one launch per compose feed); the
perspective warper warps their ``ops/color.yuv420_to_bgr`` conversion, and
compositing below full resolution resizes the store's host BGR frames
(strip.py:255-260 of the JAX package takes store frames only when
cs >= 1).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from collections import deque

import numpy as np
import torch

from ..config.tuning import StitchTuning
from ..ops import blend as B
from ..ops import exposure as E
from ..ops import match as M
from ..ops import seam as S
from ..ops.color import yuv420_to_bgr
from ..ops.crop import auto_crop_black_border
from ..ops.resize import resize_area, scale_for_megapixels
from ..ops.ransac import find_homography
from ..ops.warp import warp_perspective
from ..ops.warp_kernel import warp_frame, warp_frames
from ..runtime.device import device_sync, placement
from ..runtime.handoff import DeviceStrip
from ..runtime.logging import get_logger
from . import compose_feed as CF
from .bundle import bundle_adjust_similarity, params_from_affine
from .pairgraph import (all_pairs, banded_pairs, biggest_component,
                        chain_init, register_pairs)
from .registration import detect_features

_LOWE_RATIO = 0.75


class StripStitchError(RuntimeError):
    """Raised when the joint stitch fails and the sequential ladder is not
    allowed (a matching mask was given) or fails too."""


class _Frames:
    """Access to a strip's frames: host list (frames may differ in size),
    device store (BGR, or packed I420: :meth:`device_frame` and
    :meth:`device_batch` then serve (H*3/2, W) frames, ``shapes`` the
    logical (H, W)), or (:meth:`resized`) float32 device frames."""

    def __init__(self, images, store, indices, device):
        self.images = images
        self.store = store
        self.indices = indices
        self.device = store.device if store is not None else device
        self.n = len(indices) if store is not None else len(images)
        self.shapes = ([tuple(store.shape0[:2])] * self.n
                       if store is not None
                       else [tuple(im.shape[:2]) for im in images])
        self.shape = self.shapes[0]
        self._dev = {}

    def device_frame(self, k: int) -> torch.Tensor:
        if self.store is not None:
            return self.store.frame(self.indices[k])
        if k not in self._dev:      # each host frame crosses once
            self._dev[k] = torch.from_numpy(
                np.ascontiguousarray(self.images[k])).to(self.device)
        return self._dev[k]

    def device_batch(self) -> torch.Tensor:
        """All n frames as one (n, H, W, 3) or (n, H*3/2, W) device
        tensor, for reading only: from a store it may be a view of the
        store's frames (``FrameStore.batch``), so it must not be
        written."""
        if self.store is not None:
            return self.store.batch(self.indices)
        if self.images is None:
            return torch.stack([self._dev[k] for k in range(self.n)])
        return torch.from_numpy(np.stack(self.images)).to(self.device)

    def _bgr_u8(self, k: int) -> torch.Tensor:
        """Frame k as (H, W, 3) uint8 BGR on the device: a packed store's
        host BGR frame (``FrameStore.host_frame``, the JPEG decoded as the
        eager loader decodes it) crosses to the device; any other frame is
        read where it is."""
        if self.store is not None and self.store.fmt == "yuv420":
            return torch.from_numpy(self.store.host_frame(
                self.indices[k])).to(self.device)
        return self.device_frame(k)

    def resized(self, cs: float) -> "_Frames":
        """The frames area-resized by ``cs`` on the device and kept float32
        (strip.py:232-235): a BGR store's frames are read on the device, a
        packed store's host BGR frames and host frames cross once."""
        out = _Frames.__new__(_Frames)
        out.images = out.store = out.indices = None
        out.device, out.n = self.device, self.n
        out._dev = {k: resize_area(self._bgr_u8(k).to(torch.float32),
                                   max(1, int(round(h * cs))),
                                   max(1, int(round(w * cs))))
                    for k, (h, w) in enumerate(self.shapes)}
        out.shapes = [tuple(out._dev[k].shape[:2]) for k in range(self.n)]
        out.shape = out.shapes[0]
        return out


def estimate_strip_transforms(images: Optional[List[np.ndarray]],
                              tuning: StitchTuning,
                              range_width: Optional[int] = None,
                              stage: str = "Strip", seed: int = 0,
                              device=None, store=None,
                              indices: Optional[List[int]] = None,
                              matching_mask: Optional[np.ndarray] = None):
    """Registration: features -> pair graph (banded, all pairs, or the
    pairs ``matching_mask`` marks) -> component -> BA.

    Returns (kept_indices, transforms (n_kept, 2, 3) float32 frame->frame0
    numpy, graph). ``device``: a device, or a list of them
    (``runtime/device.placement``; default the store's): the pair
    registration's chunks spread over the list
    (:func:`pairgraph.register_pairs`); detect and the bundle adjust run
    on its first device, where the frames are. Three spans of ``stage``
    time its steps: ``detect`` (``frames``), ``pairs`` (match and RANSAC
    over the schedule up to the fetch of the pair graph; ``pairs``,
    ``kept``) and ``bundle adjust`` (up to the fetch of its transforms;
    ``frames``, ``pairs``); none adds a synchronisation.
    """
    log = get_logger()
    devices = placement(device, None if store is None else store.device)
    n = len(images) if images is not None else len(indices)
    rw = range_width if range_width is not None else tuning.range_width
    with log.span("detect", stage=stage, frames=n):
        feats, scale = detect_features(images, tuning.sift_features,
                                       tuning.registration_resol_mpx,
                                       device=devices[0], store=store,
                                       indices=indices)
    if matching_mask is not None:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
                 if matching_mask[i, j] or matching_mask[j, i]]
    elif tuning.use_range_matcher:
        pairs = banded_pairs(n, rw)
    else:
        pairs = all_pairs(n)
    if not pairs:
        raise StripStitchError(f"{stage}: empty pair schedule")
    with log.span("pairs", stage=stage, pairs=len(pairs)) as counters:
        graph = register_pairs(feats, pairs, _LOWE_RATIO,
                               thresh=4.0 / scale, seed=seed,
                               devices=devices)
        conf = graph.conf.cpu().numpy()
        ok = graph.ok.cpu().numpy()
        keep = ok & (conf >= tuning.pano_conf_thresh)
        counters["kept"] = int(keep.sum())
    log.log(stage, "pair graph", pairs=len(pairs), kept=counters["kept"],
            mean_conf=float(conf[ok].mean()) if ok.any() else 0.0)

    if n == 2:
        # 2-image pair gates (stitchWithMode, stitch_robust.cpp:233-243)
        ng = int(graph.n_good[0])
        ni = int(graph.n_inliers[0])
        okp = bool(ok[0])
        if (not okp) or ng < tuning.min_good_matches \
                or ni < tuning.min_inliers:
            # the diagnostics record (logPairDiagnostics,
            # stitch_robust.cpp:144-172)
            shape = (lambda k: images[k].shape if images is not None
                     else tuple(store.shape0))
            log.log(stage, "failure diagnostics", idx=1,
                    left=f"{shape(0)}", right=f"{shape(1)}",
                    kp_left=int(feats.valid[0].sum()),
                    kp_right=int(feats.valid[1].sum()),
                    good_matches=f"{ng}(min={tuning.min_good_matches})",
                    model=("failed" if not okp else
                           f"inliers/good_matches={ni}/{ng}"
                           f"(min={tuning.min_inliers})"))
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
        with log.span("bundle adjust", stage=stage, frames=n,
                      pairs=len(pk)):
            refined = bundle_adjust_similarity(
                torch.from_numpy(graph.pairs).to(dev)[pk_t],
                graph.pts_a[pk_t], graph.pts_b[pk_t], graph.w[pk_t],
                init_params)
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


def _scale_transform(t33: np.ndarray, s: float) -> np.ndarray:
    """Rescale a transform estimated at full resolution to scale ``s``."""
    sc = np.diag([s, s, 1.0]).astype(np.float32)
    return sc @ t33 @ np.linalg.inv(sc)


def _seam_warps_persp(fr: _Frames, t_seam: np.ndarray, sh: int, sw: int):
    """The perspective warper's seam-scale warps (strip.py:60-73): each
    frame (packed I420 converted to BGR first) and its all-ones mask by
    ``warp_perspective``; (images (n, sh, sw, 3), footprints (n, sh,
    sw))."""
    imgs, masks = [], []
    for k in range(fr.n):
        img = fr.device_frame(k)
        if img.ndim == 2:
            img = yuv420_to_bgr(img)
        h33 = np.vstack([t_seam[k], [0.0, 0.0, 1.0]]).astype(np.float32)
        ones = torch.ones(img.shape[:2], dtype=torch.float32,
                          device=img.device)
        imgs.append(warp_perspective(img, h33, sh, sw))
        masks.append(warp_perspective(ones, h33, sh, sw))
    return torch.stack(imgs), torch.stack(masks)


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
                  device=None, store=None,
                  indices: Optional[List[int]] = None,
                  return_device: bool = False):
    """Seam-scale warps + gains + DP seams + multiband blend at
    compositing resolution. Returns the cropped (H, W, 3) uint8 host
    panorama, or, with ``return_device`` and a tiled canvas, a
    :class:`DeviceStrip`. Host ``images`` may differ in size (the
    sequential ladder's mosaic and frames): each is then warped to the
    seam scale on its own.

    ``transforms``: (N, 2, 3) frame->reference affines in full-resolution
    pixels. ``compositing_resol_mpx`` > 0 composes at that megapixel
    budget (setCompositingResol, stitch_robust.cpp:185): the frames are
    area-resized on the device and stay float32, the transforms are
    rescaled, and the seam scale is taken relative to the resized frames.
    ``use_affine_warper=False`` warps through the perspective route.
    ``device``: a device, or a list of them (``runtime/device.placement``;
    default the store's): the frames are on the first device; a tiled
    canvas assembled on the host spreads its tiles over the list
    (``ops/blend.mb_compose_tiled``), a device-assembled one
    (``return_device``) stays on the first device.
    """
    log = get_logger()
    devices = placement(device, None if store is None else store.device)
    fr = _Frames(images, store, indices, devices[0])
    n = fr.n
    h, w = fr.shape[:2]
    sync = device_sync(fr.device)
    cs = scale_for_megapixels(h, w, tuning.compositing_resol_mpx)
    if cs < 1.0:
        log.log(stage, "compositing scale", scale=round(cs, 4))
        with log.timer(stage, "compositing resize", sync=sync):
            fr = fr.resized(cs)
        transforms = np.stack([
            _scale_transform(np.vstack([t, [0.0, 0.0, 1.0]]).astype(
                np.float32), cs)[:2] for t in np.asarray(transforms)])
        h, w = fr.shape[:2]
    persp = not tuning.use_affine_warper

    # canvas bbox over all transformed corners (host numpy)
    tf = np.asarray(transforms, np.float32)
    boxes = []
    for t, (ih, iw) in zip(tf, fr.shapes):
        corners = np.asarray([[0.0, 0.0], [iw - 1.0, 0.0],
                              [iw - 1.0, ih - 1.0], [0.0, ih - 1.0]],
                             np.float32)
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
    t_seam = np.stack([ssc @ t for t in t_canvas]).astype(np.float32)
    with log.timer(stage, "seam warps", sync=sync):
        if persp:
            simgs, scms = _seam_warps_persp(fr, t_seam, sh, sw)
        elif len(set(fr.shapes)) == 1:
            simgs, scms = warp_frames(fr.device_batch(), t_seam, sh, sw)
        else:   # frames of different sizes: one warp each
            simgs, scms = (torch.stack(a) for a in zip(*(
                warp_frame(fr.device_frame(k), t_seam[k], sh, sw)
                for k in range(n))))
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
                     else None), persp=persp,
            h33=(np.vstack([t_full, [0.0, 0.0, 1.0]]).astype(np.float32)
                 if persp else None))

    if use_tiled:
        frame_boxes = [(b[0] - x0, b[1] - y0, b[2] - x0, b[3] - y0)
                       for b in boxes]
        with log.timer(stage, "tiled blend", sync=sync):
            out, bbox = B.mb_compose_tiled(
                canvas_h, canvas_w, bands, frame_boxes, feed_roi,
                fr.device if return_device else devices,
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
                 seed: int = 0, device=None,
                 store=None, indices: Optional[List[int]] = None,
                 info: Optional[dict] = None, return_device: bool = False,
                 matching_mask: Optional[np.ndarray] = None):
    """Robust strip stitch with the reference's fallback ladder
    (stitchRobustly, stitch_robust.cpp:337-376): the joint stitch first;
    when it fails, and only without a ``matching_mask``
    (stitch_robust.cpp:360-364), the sequential anchor-window ladder
    (:func:`_stitch_sequential`) on the host frames. Raises
    StripStitchError when no rung succeeds.

    ``image_tags``: optional per-frame tags for the logged pair plan.
    ``info``: optional dict that receives ``kept`` (kept frame positions)
    and ``transforms`` ((n_kept, 2, 3) frame->frame0; NaN after the
    sequential ladder, which folds frames into a growing mosaic and keeps
    no per-frame transform) and ``path`` ("joint" or "sequential").
    ``return_device``: a tiled joint panorama comes back as a
    :class:`DeviceStrip`; small canvases and the ladder's mosaic are host
    arrays. ``device``: a device, or a list of them
    (``runtime/device.placement``; default the store's; the JAX package's
    ``mesh``): the frames are on the first device, the joint path's pair
    registration and host-assembled tiles spread over the list, and the
    ladder runs on the first device.
    """
    log = get_logger()
    tuning = tuning or StitchTuning()
    n = len(images) if images is not None else len(indices)
    if n == 0:
        raise StripStitchError(f"{stage}: need at least one image")
    if n == 1:
        if info is not None:
            info.update(kept=[0], transforms=np.asarray(
                [[[1, 0, 0], [0, 1, 0]]], np.float32), path="joint")
        return (images[0].copy() if images is not None
                else store.host_frame(indices[0]).copy())
    if image_tags:
        log.log(stage, "plan", pairs=", ".join(
            f"{a}->{b}" for a, b in zip(image_tags, image_tags[1:])))
    devices = placement(device, None if store is None else store.device)
    dev = devices[0]
    sync = device_sync(dev)
    try:
        with log.timer(stage, "register", sync=sync):
            kept, transforms, _ = estimate_strip_transforms(
                images, tuning, range_width_override, stage, seed,
                device=devices, store=store, indices=indices,
                matching_mask=matching_mask)
        if len(kept) < n:
            log.log(stage, "dropped weak frames",
                    dropped=[i for i in range(n) if i not in set(kept)])
        pano = compose_strip(
            None if images is None else [images[i] for i in kept],
            transforms, tuning, stage, device=devices, store=store,
            indices=None if indices is None else [indices[i] for i in kept],
            return_device=return_device)
        if info is not None:
            info.update(kept=kept, transforms=transforms, path="joint")
        return pano
    except StripStitchError as err:
        log.log(stage, "joint stitch failed", error=str(err))
        if matching_mask is not None:
            raise       # reference: no fallback when a mask was supplied
    # the sequential ladder is unconditional on joint failure
    # (stitch_robust.cpp:366-375); use_anchor_fallback only gates the
    # anchor batch inside it (:297)
    log.log(stage, "falling back to sequential stitch")
    if images is None:
        images = [store.host_frame(i) for i in indices]
    pano = _stitch_sequential(images, tuning, stage, seed,
                              range_width_override, dev)
    if info is not None:
        info.update(kept=list(range(n)),
                    transforms=np.full((n, 2, 3), np.nan, np.float32),
                    path="sequential")
    return pano


def _pair_diagnostics_dump(left: np.ndarray, right: np.ndarray,
                           tuning: StitchTuning, stage: str, idx: int,
                           device: torch.device) -> None:
    """Diagnostics of a bare pair after a failed step (logPairDiagnostics,
    stitch_robust.cpp:144-172, 319-325): detect -> kNN-2 ratio 0.75 ->
    homography RANSAC(3.0), with both sides' keypoint counts. Never masks
    the error that led here."""
    log = get_logger()
    try:
        feats, scale = detect_features([left, right], tuning.sift_features,
                                       tuning.registration_resol_mpx,
                                       device=device)
        m = M.knn2_ratio(feats.desc[0], feats.valid[0], feats.desc[1],
                         feats.valid[1], _LOWE_RATIO)
        src, dst, good = M.gather_correspondences(feats.xy[0], feats.xy[1],
                                                  m)
        g = torch.Generator(device="cpu")
        g.manual_seed(idx)
        raw = torch.randint(0, 2 ** 31 - 1, (1, 1024, 4), generator=g)
        res = find_homography(src[None], dst[None], good[None],
                              raw.to(src.device),
                              thresh=3.0 / max(scale, 1e-6))
        ng = int(good.sum())
        ni = int(res.n_inliers[0])
        log.log(stage, "failure diagnostics", idx=idx,
                left=f"{left.shape}", right=f"{right.shape}",
                kp_left=int(feats.valid[0].sum()),
                kp_right=int(feats.valid[1].sum()),
                good_matches=f"{ng}(min={tuning.min_good_matches})",
                model=("failed" if not bool(res.ok[0]) else
                       f"inliers/good_matches={ni}/{ng}"
                       f"(min={tuning.min_inliers})"))
    except Exception as diag_err:   # diagnostics never mask the error
        log.log(stage, "failure diagnostics unavailable",
                error=str(diag_err))


def _stitch_sequential(images: List[np.ndarray], tuning: StitchTuning,
                       stage: str, seed: int,
                       range_width_override: Optional[int],
                       device: torch.device) -> np.ndarray:
    """Left-fold incremental stitch with a sliding anchor window
    (stitchSequentially, stitch_robust.cpp:273-334): the anchors start
    with the FIRST frame (:285); each step tries the anchor batch
    [mosaic, anchors..., next] with the local range width
    max(2, min(len(batch), range_width)) (:305-310), then the bare pair;
    a step that fails both dumps the pair's diagnostics (:319-325) and
    raises."""
    log = get_logger()
    current = images[0]
    anchors: deque = deque([images[0]], maxlen=max(1, tuning.anchor_window))
    rw = (range_width_override if range_width_override
          and range_width_override > 0 else tuning.range_width)
    for i in range(1, len(images)):
        attempts = [[current, images[i]]]
        if tuning.use_anchor_fallback and anchors:
            attempts.insert(0, [current, *anchors, images[i]])
        for attempt, imgs in enumerate(attempts):
            local_rw = max(2, min(len(imgs), rw)) if len(imgs) > 2 else rw
            try:
                kept, transforms, _ = estimate_strip_transforms(
                    imgs, tuning, range_width=local_rw,
                    stage=f"{stage}/seq{i}", seed=seed + i, device=device)
                current = compose_strip([imgs[k] for k in kept], transforms,
                                        tuning, f"{stage}/seq{i}",
                                        device=device)
                break
            except StripStitchError as err:
                log.log(f"{stage}/seq{i}", "attempt failed",
                        attempt=attempt, n_images=len(imgs),
                        error=str(err))
        else:
            _pair_diagnostics_dump(current, images[i], tuning,
                                   f"{stage}/seq{i}", i, device)
            raise StripStitchError(
                f"{stage}: sequential stitch failed at frame {i}")
        anchors.append(images[i])
    return current
