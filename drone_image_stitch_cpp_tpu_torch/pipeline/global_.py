"""Global inter-strip composition: the custom mosaic composer.

Port of ``drone_image_stitch_cpp_tpu/pipeline/global_.py``
(stitchInterStripsCustom, stitch_global.cpp:386-675):
  (a) pairwise strip alignment: gray at a <= 2800 px work scale, SIFT with
      the global feature budget (K1), knn2 with the adaptive ratio, halved
      match/inlier minima, affine RANSAC(4.0) (:100-224);
  (b) the ROI grid per strip and the horizontal-flip hypothesis, solved as
      one banked batch per strip pair (pipeline/roi_align.py) (:226-289,
      :401-428);
  (c) transform chaining onto the strip-0 frame (:430-458);
  (d) seam-scale (<= 8 MP) warps with 0.999-footprint content masks, the
      chained clamped mean-ratio gains and the canvas-size-adaptive
      exposure compensation (:307-326, :353-383, :497-573);
  (e) graph-cut seams with the DP seam as fallback (:583-630);
      the JAX package's two seam ablation switches (``TM_SEAM_WARP``,
      ``TM_SEAM_METHOD``) are the keywords ``seam_warp`` (the seam canvas
      warped from the area-downscaled strip, or straight from the
      full-resolution one through K2's content mode) and ``seam_method``
      (graph cut, or the DP seam for every pair);
  (f) the multiband blend with sigma-10 soft seam masks, through tiles
      above ``ops/blend.TILED_THRESHOLD_BYTES``, the crop box from the
      tiles' device content flags (:632-666), the finished row bands
      optionally streamed into a row sink (the app's JPEG writer).

Every strip lives on the device once, as uint8 padded to the common
512-snapped size: that size sets the align detect's work scale and the
edge clamp of its work image, so it is kept from the JAX package. The
JAX package's extra shape-bucket pad of the detect image is not ported;
its mesh is a device list here: strips handed over from other cards are
copied onto the stage's device after their padding on their own card,
and the tiled blend spreads its tiles over the list.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..config.tuning import StitchTuning
from ..ops import blend as B
from ..ops import exposure as E
from ..ops import features as F
from ..ops import seam as S
from ..ops.color import bgr_to_gray, content_mask
from ..ops.crop import auto_crop_black_border
from ..ops.resize import resize_area, scale_for_max_dim
from ..ops.warp import warp_affine, warp_content_mask
from ..ops.warp_kernel import warp_frame
from ..runtime.device import device_sync, placement, resolve_device
from ..runtime.handoff import DeviceStrip
from ..runtime.logging import get_logger
from . import compose_feed as CF
from .roi_align import align_pair_banked

_MAX_ALIGN_DIM = 2800       # reference :119
_SEAM_CANVAS_MP = 8.0       # reference :585
_GAIN_CLAMP = (0.8, 1.25)   # reference :497-549
_GAIN_MIN_OVERLAP = 1000    # full-res valid-px inheritance threshold (:529)
_STRIP_BUCKET = 512         # common padded strip size grid
_STAGE = "GlobalCustom"
SEAM_WARPS = ("prescaled", "fullres")
SEAM_METHODS = ("graphcut", "dp")


class GlobalStitchError(RuntimeError):
    pass


def _snap_strip(d: int) -> int:
    return -(-d // _STRIP_BUCKET) * _STRIP_BUCKET


def strip_work_image(dev_img: torch.Tensor, true_hw):
    """The align detect's work image of one padded device strip ((HP, WP,
    3) uint8, content at the origin with true dims ``true_hw``):
    (work (cwh, cww) float32 gray, sc, sx, sy).

    The padded image is gray-converted and area-resized to the <= 2800 px
    work scale of its PADDED size (sx, sy: the exact per-axis scales of
    that resize); the content part is kept and edge-extended from its last
    fully interior row and column (cwh-2, cww-2: the last one mixes the
    black pad into its area average), so no content-to-black edge floods
    the keypoint budget.
    """
    hp, wp = int(dev_img.shape[0]), int(dev_img.shape[1])
    h, w = true_hw
    sc = scale_for_max_dim(hp, wp, _MAX_ALIGN_DIM)
    out_h = max(1, int(round(hp * sc)))
    out_w = max(1, int(round(wp * sc)))
    sy = out_h / float(hp)        # exact content scales of the resize
    sx = out_w / float(wp)
    cwh = min(int(round(h * sy)), out_h)
    cww = min(int(round(w * sx)), out_w)
    dev = dev_img.device
    work = resize_area(bgr_to_gray(dev_img.to(torch.float32)), out_h, out_w)
    ri = torch.arange(cwh, device=dev).clamp(0, max(cwh - 2, 0))
    ci = torch.arange(cww, device=dev).clamp(0, max(cww - 2, 0))
    return work[ri[:, None], ci[None, :]], sc, sx, sy


def _detect_strip_dev(dev_img: torch.Tensor, true_hw, n_feats: int):
    """Features of one padded device strip (see :func:`strip_work_image`)
    in full-resolution strip coordinates, and the work scale: one detect,
    one K1 launch."""
    work, sc, sx, sy = strip_work_image(dev_img, true_hw)
    feats = F.detect_and_describe_batched(work[None], n_feats)
    xy = torch.stack([(feats.xy[..., 0] + 0.5) / sx - 0.5,
                      (feats.xy[..., 1] + 0.5) / sy - 0.5], dim=-1)
    return feats._replace(xy=xy, sigma=feats.sigma / sc), sc


def _pad_strip_u8(img: np.ndarray, hp: int, wp: int) -> np.ndarray:
    if img.dtype != np.uint8:
        img = np.clip(img, 0.0, 255.0).astype(np.uint8)
    h, w = img.shape[:2]
    if (h, w) == (hp, wp):
        return img
    return np.pad(img, ((0, hp - h), (0, wp - w), (0, 0)))


def _flip_padded(img: torch.Tensor, true_w: int) -> torch.Tensor:
    """Horizontal flip of the CONTENT of a padded strip: flip the whole
    array, then roll the content (now at the right edge) back to x = 0."""
    return torch.roll(img.flip(1), true_w - img.shape[1], dims=1)


def align_strips(strips: List[np.ndarray], tuning: StitchTuning, device,
                 seed: int = 0):
    """Chained global transforms + per-strip orientation (:400-437) of host
    strips, computed on ``device`` (``cuda`` unless the caller asks for
    ``cpu``). Returns (transforms, oriented, flipped): ``oriented[i]`` is
    the strip with the chosen flip applied, and ``transforms[i]`` (3, 3)
    maps oriented-strip coordinates into the strip-0 frame."""
    dev = resolve_device(device)
    shapes = [st.shape[:2] for st in strips]
    dev_padded = [torch.from_numpy(_pad_strip_u8(
        st, _snap_strip(st.shape[0]), _snap_strip(st.shape[1]))).to(dev)
        for st in strips]
    transforms, oriented_dev, flipped = _align_strips_dev(
        dev_padded, shapes, tuning, seed)
    oriented = [d[:h, :w].cpu().numpy() for d, (h, w) in zip(oriented_dev,
                                                              shapes)]
    return transforms, oriented, flipped


def _align_strips_dev(dev_padded, shapes, tuning: StitchTuning,
                      seed: int = 0):
    """align_strips on padded device uint8 strips; ``oriented`` entries
    keep the padded layout (a chosen flip runs on the device). Per strip
    pair: one detect (K1), the flip hypothesis as mirrored features, and
    the direct + flipped x ROI grid in one banked batch."""
    log = get_logger()
    n = len(dev_padded)
    transforms = [np.eye(3, dtype=np.float32)]
    flipped = [False]
    oriented = [dev_padded[0]]
    f_prev, s_prev = _detect_strip_dev(dev_padded[0], shapes[0],
                                       tuning.global_sift_features)
    for i in range(1, n):
        cur_w = shapes[i][1]
        f_cur, _ = _detect_strip_dev(dev_padded[i], shapes[i],
                                     tuning.global_sift_features)
        f_flip = F.mirror_features(f_cur, cur_w)
        direct, flip_est = align_pair_banked(
            f_prev, s_prev, f_cur, f_flip, shapes[i - 1], shapes[i],
            tuning, seed + i)
        # choose by inliers then ratio (:406-421)
        use_flip = flip_est.ok and (
            not direct.ok
            or (flip_est.inliers, flip_est.ratio) > (direct.inliers,
                                                     direct.ratio))
        est = flip_est if use_flip else direct
        if not est.ok:
            raise GlobalStitchError(
                f"strip {i} alignment failed: direct(inl={direct.inliers}, "
                f"m={direct.matches}) flipped(inl={flip_est.inliers}, "
                f"m={flip_est.matches})")
        log.log(_STAGE, f"strip {i} aligned", flipped=use_flip,
                inliers=est.inliers, matches=est.matches,
                ratio=round(est.ratio, 3))
        # est.model maps oriented-cur -> oriented-prev coordinates
        chained = (transforms[i - 1] @ est.model).astype(np.float32)
        if not np.isfinite(chained).all():
            raise GlobalStitchError(
                f"strip {i} chained transform is non-finite")
        transforms.append(chained)
        flipped.append(bool(use_flip))
        oriented.append(_flip_padded(dev_padded[i], cur_w) if use_flip
                        else dev_padded[i])
        f_prev = f_flip if use_flip else f_cur
    return transforms, oriented, flipped


def _pair_gain_stats(img_ref: torch.Tensor, img_cur: torch.Tensor,
                     mask_ref: torch.Tensor, mask_cur: torch.Tensor
                     ) -> torch.Tensor:
    """Overlap stats of one strip pair: [count, sum_ref(3), sum_cur(3)]."""
    overlap = mask_ref & mask_cur
    of = overlap[..., None]
    zero = torch.zeros((), device=img_ref.device)
    return torch.cat([overlap.sum().to(torch.float32)[None],
                      torch.where(of, img_ref, zero).sum(dim=(0, 1)),
                      torch.where(of, img_cur, zero).sum(dim=(0, 1))])


def _gain_chain(seam_imgs, seam_masks, n: int,
                seam_scale: float = 1.0) -> np.ndarray:
    """Cumulative clamped mean-ratio gains + geometric-mean normalisation
    (:497-573), (n, 3) float32: the pairwise ratio of raw overlap means is
    clamped to [0.8, 1.25] where both channel means exceed 5, the
    cumulative product is not clamped, a strip whose overlap has under
    1000 full-resolution pixels inherits its predecessor's gain, and the
    geometric-mean normalisation divides only where the mean exceeds 0.01.
    One host read of the (n-1, 7) stats table."""
    log = get_logger()
    gains = np.ones((n, 3), np.float32)
    inv_area = 1.0 / max(seam_scale * seam_scale, 1e-12)
    stats = (torch.stack([_pair_gain_stats(seam_imgs[i - 1], seam_imgs[i],
                                           seam_masks[i - 1], seam_masks[i])
                          for i in range(1, n)]).cpu().numpy()
             if n > 1 else np.zeros((0, 7), np.float32))
    for i in range(1, n):
        cnt = float(stats[i - 1, 0])
        if cnt * inv_area < _GAIN_MIN_OVERLAP:
            gains[i] = gains[i - 1]  # inheritance (:507-529)
            log.log(_STAGE, f"gain inherit strip {i}", overlap=int(cnt))
            continue
        ref_mean = stats[i - 1, 1:4] / cnt
        cur_mean = stats[i - 1, 4:7] / cnt
        pw = np.ones(3, np.float32)
        bright = (ref_mean > 5.0) & (cur_mean > 5.0)  # dark guard (:538)
        pw[bright] = np.clip(ref_mean[bright] / cur_mean[bright],
                             *_GAIN_CLAMP)
        gains[i] = gains[i - 1] * pw
        log.log(_STAGE, f"gain strip {i}", pw=np.round(pw, 3).tolist(),
                cum=np.round(gains[i], 3).tolist(), overlap=int(cnt))
    geo = np.exp(np.log(np.maximum(gains, 1e-6)).mean(axis=0))
    return (gains / np.where(geo > 0.01, geo, 1.0)).astype(np.float32)


def _to_seam(strip_u8: torch.Tensor, t_small: np.ndarray, hp_s: int,
             wp_s: int, sh: int, sw: int):
    """Seam-scale image and content mask of one padded strip: area-resize
    the strip and its gray > 2 coverage to (hp_s, wp_s) first, then warp
    (anti-aliased, and an order of magnitude less gather work than warping
    from full resolution); the coverage is kept at full (>= 0.999) before
    the 0.999-footprint mask warp."""
    t = torch.from_numpy(np.asarray(t_small, np.float32)).to(strip_u8.device)
    small = resize_area(strip_u8.to(torch.float32), hp_s, wp_s)
    cov = resize_area(content_mask(strip_u8).to(torch.float32), hp_s, wp_s)
    simg = warp_affine(small, t, sh, sw)
    smask = warp_content_mask(cov >= 0.999, t, sh, sw, footprint_thresh=0.999)
    return simg, smask


def _to_seam_fullres(strip_u8: torch.Tensor, t_seam: np.ndarray, sh: int,
                     sw: int):
    """Seam-scale image and content mask of one padded strip warped
    straight from full resolution by the seam transform ``t_seam`` (JAX's
    ``TM_SEAM_WARP=fullres``, global_.py:438-459): the warped image, and
    the warped gray > 2 indicator kept at >= 0.999. One launch of K2's
    content mode on a CUDA strip (no float32 copy of the strip is made);
    a CPU strip runs its plain version."""
    simg, cov = warp_frame(strip_u8, t_seam, sh, sw, content="nonblack")
    return simg, cov >= 0.999


def check_seam_switches(seam_warp: str, seam_method: str) -> None:
    """ValueError unless ``seam_warp`` is one of :data:`SEAM_WARPS` and
    ``seam_method`` one of :data:`SEAM_METHODS`."""
    if seam_warp not in SEAM_WARPS:
        raise ValueError(f"seam_warp must be one of {SEAM_WARPS}, got "
                         f"{seam_warp!r}")
    if seam_method not in SEAM_METHODS:
        raise ValueError(f"seam_method must be one of {SEAM_METHODS}, got "
                         f"{seam_method!r}")


def stitch_inter_strips_custom(strips: List, tuning: Optional[StitchTuning]
                               = None, seed: int = 0, device=None,
                               info: Optional[dict] = None,
                               row_sink=None,
                               fetch_packed: bool = False,
                               seam_warp: str = "prescaled",
                               seam_method: str = "graphcut") -> np.ndarray:
    """Compose strip panoramas (host arrays or :class:`DeviceStrip`) into
    one cropped mosaic (reference :386-675) on ``device`` (default: the
    device strips'). ``info``: optional dict that receives ``transforms``
    (per strip, (3, 3) oriented strip -> strip 0), ``flipped``,
    ``seam_methods`` ({(i, j): "graphcut" or "dp"}), ``canvas``, ``bands``,
    ``tiled`` and ``crop_box``. Raises GlobalStitchError where the JAX
    package does.

    ``row_sink``: optional ``runtime.writer.StreamedMosaicWriter``-protocol
    object. On the tiled path the mosaic's finished row bands stream into
    it while later tiles blend (begin / on_rows / finish); the crop box
    given to ``begin`` is the union of the seam-scale content masks,
    upscaled with a margin of 2 ceil(1 / seam_scale) + 2 px, so it
    contains the exact autocrop box. A sink whose ``begin`` fails is logged
    ("streamed write unavailable") and left unused; the caller then crops
    and writes the returned mosaic.

    ``device`` may be a list of devices (``runtime/device.placement``;
    the JAX package's mesh, global_.py:358, 608-612): every strip is
    pulled onto the first, where the stage runs, and a tiled blend
    spreads its tiles over the list.

    ``fetch_packed``: a tiled blend's tiles leave the device as packed
    I420 (``ops/blend.mb_compose_tiled``; up to ~3 gray levels of 4:2:0
    chroma loss). Off by default: the JAX package turns it on
    (``TM_FETCH_PACKED``, global_.py:612) to halve the bytes over its
    remote TPU link, which a card on PCIe does not need.

    ``seam_warp``: ``"prescaled"`` (default) area-downscales each padded
    strip and its coverage to the seam scale before the warp;
    ``"fullres"`` warps the seam canvas straight from the full-resolution
    strip (:func:`_to_seam_fullres`, one K2 content-mode launch per strip
    on a card). ``seam_method``: ``"graphcut"`` (default, the DP seam
    where the min-cut has no terminals) or ``"dp"`` for every pair. These
    are the JAX package's ``TM_SEAM_WARP`` / ``TM_SEAM_METHOD``
    (global_.py:425, 505-510); any other value raises ValueError.
    """
    check_seam_switches(seam_warp, seam_method)
    log = get_logger()
    tuning = tuning or StitchTuning()
    n = len(strips)
    if n < 2:
        raise GlobalStitchError("need at least 2 strips")
    if device is None:
        devs = [st.device for st in strips if isinstance(st, DeviceStrip)]
        if not devs:
            raise ValueError("stitch_inter_strips_custom: pass a device for "
                             "host strips")
        device = devs[0]
    devices = placement(device)
    dev = devices[0]
    sync = device_sync(dev)

    # ONE padded uint8 device copy per strip, shared by the align detect,
    # the seam-scale warps and every blend feed; the black pad is excluded
    # by the gray > 2 content masks, and the canvas keeps the TRUE dims
    shapes = [(tuple(st.hw) if isinstance(st, DeviceStrip)
               else tuple(st.shape[:2])) for st in strips]
    hp_ = B.align_up(max(h for h, _ in shapes), _STRIP_BUCKET)
    wp_ = B.align_up(max(w for _, w in shapes), _STRIP_BUCKET)
    dev_strips = []
    for st in strips:
        if isinstance(st, DeviceStrip):
            dev_strips.append(st.device_padded(hp_, wp_).to(dev))
            st.mark_consumed()
        else:
            dev_strips.append(torch.from_numpy(
                _pad_strip_u8(st, hp_, wp_)).to(dev))
    with log.timer(_STAGE, "align", sync=sync):
        transforms, dev_strips, flipped = _align_strips_dev(
            dev_strips, shapes, tuning, seed)

    # canvas bbox over the transformed corners (:439-458)
    boxes = []
    for (ih, iw), t in zip(shapes, transforms):
        t2 = np.asarray(t[:2, :], np.float32)
        corners = np.asarray([[0.0, 0.0], [iw - 1.0, 0.0],
                              [iw - 1.0, ih - 1.0], [0.0, ih - 1.0]],
                             np.float32)
        pts = corners @ t2[:, :2].T + t2[:, 2]
        boxes.append((float(pts[:, 0].min()), float(pts[:, 1].min()),
                      float(pts[:, 0].max()), float(pts[:, 1].max())))
    # integer origin: keep strip 0 pixel-aligned
    x0 = float(math.floor(min(b[0] for b in boxes)))
    y0 = float(math.floor(min(b[1] for b in boxes)))
    x1 = max(b[2] for b in boxes)
    y1 = max(b[3] for b in boxes)
    canvas_w = int(math.ceil(x1 - x0)) + 1
    canvas_h = int(math.ceil(y1 - y0)) + 1
    log.log(_STAGE, "canvas", h=canvas_h, w=canvas_w)
    t_canvas = []
    for t in transforms:
        tc = np.asarray(t[:2, :], np.float32).copy()
        tc[0, 2] -= x0
        tc[1, 2] -= y0
        t_canvas.append(tc)

    # ---- seam-scale canvas (<= 8 MP) --------------------------------------
    seam_scale = min(1.0, math.sqrt(_SEAM_CANVAS_MP * 1e6
                                    / (canvas_h * canvas_w)))
    sh = max(1, int(round(canvas_h * seam_scale)))
    sw = max(1, int(round(canvas_w * seam_scale)))
    ssc = np.diag([seam_scale, seam_scale]).astype(np.float32)
    log.log(_STAGE, "seam scale", scale=round(seam_scale, 4), h=sh, w=sw)
    log.log(_STAGE, "seam", warp=seam_warp, method=seam_method)
    hp_s = max(1, int(round(hp_ * seam_scale)))
    wp_s = max(1, int(round(wp_ * seam_scale)))
    s_x, s_y = wp_s / wp_, hp_s / hp_
    seam_imgs, seam_masks = [], []
    with log.timer(_STAGE, "seam warps", sync=sync):
        for i in range(n):
            tsm = (ssc @ t_canvas[i]).astype(np.float32).copy()
            if seam_warp == "fullres":
                simg, smask = _to_seam_fullres(dev_strips[i], tsm, sh, sw)
            else:
                tsm[:, 0] /= s_x        # pre-scaled source -> seam canvas
                tsm[:, 1] /= s_y
                simg, smask = _to_seam(dev_strips[i], tsm, hp_s, wp_s, sh,
                                       sw)
            seam_imgs.append(simg)
            seam_masks.append(smask)

    # ---- radiometric pre-equalisation and exposure (:307-326, :497-573) --
    with log.timer(_STAGE, "gains+exposure", sync=sync):
        gains = _gain_chain(seam_imgs, seam_masks, n, seam_scale)
        # ChannelsCompensator(2) up to 120 MP, scalar GainCompensator(1)
        # above
        gained = [im * torch.from_numpy(g).to(dev)
                  for im, g in zip(seam_imgs, gains)]
        if canvas_h * canvas_w / 1e6 <= 120.0:
            comp_gains = E.channels_compensate(
                torch.stack(gained), torch.stack(seam_masks),
                similarity_thresh=0.95).cpu().numpy()
            log.log(_STAGE, "exposure", kind="channels",
                    gains=np.round(comp_gains, 3).tolist())
        else:
            comp = E.gain_compensate_scalar(
                torch.stack([g.mean(dim=-1) for g in gained]),
                torch.stack(seam_masks), similarity_thresh=0.95)
            comp_gains = np.repeat(comp.cpu().numpy()[:, None], 3, axis=1)
            log.log(_STAGE, "exposure", kind="gain")
        del gained
    total_gains = (gains * comp_gains).astype(np.float32)

    # ---- graph-cut seams with the DP fallback, or DP seams (:583-630) -----
    comp_imgs = [im * torch.from_numpy(g).to(dev)
                 for im, g in zip(seam_imgs, total_gains)]
    axes = []
    for i in range(n - 1):
        dt = t_canvas[i + 1][:, 2] - t_canvas[i][:, 2]
        axes.append("vertical" if abs(dt[0]) >= abs(dt[1])
                    else "horizontal")
    methods: dict = {}
    if row_sink is not None:
        # before the seams, which carve the masks in place
        union = torch.stack(seam_masks).any(dim=0).cpu().numpy()
    n0 = len(log._records)
    with log.timer(_STAGE, "seams", sync=sync):
        seam_out = S.find_seams_sequential(comp_imgs, seam_masks, axes,
                                           method=seam_method,
                                           methods=methods)
    log.log(_STAGE, "seam methods",
            **{f"{i}-{j}": m for (i, j), m in methods.items()})
    # the min-cut solver's share of the seams (its spans); the rest is
    # host set-up
    solves = [r for r in log._records[n0:] if r["stage"] == _STAGE
              and r["msg"] == "seam solve done"]
    log.log(_STAGE, "seam solver", calls=len(solves),
            solver_seconds=round(sum(r["seconds"] for r in solves), 3),
            nodes=sum(r["nodes"] for r in solves))
    crop_box = None
    if row_sink is not None:
        # the content bbox at seam scale, upscaled with an outward margin of
        # TWO scale quanta (+2 px): the seam masks keep only fully covered
        # cells (coverage >= 0.999, then a 0.999 warp footprint), so each
        # may drop one partly covered cell at the content's edge. The JAX
        # package's one quantum cut the last content column of
        # chip_smoke.py's 3 x 10 4K mosaic on an H100; two keep the whole
        # exact box
        r, c = union.any(axis=1), union.any(axis=0)
        if r.any():
            margin = 2 * int(math.ceil(1.0 / max(seam_scale, 1e-6))) + 2
            ry0, ry1 = int(np.argmax(r)), len(r) - int(np.argmax(r[::-1]))
            cx0, cx1 = int(np.argmax(c)), len(c) - int(np.argmax(c[::-1]))
            crop_box = (max(0, int(ry0 / seam_scale) - margin),
                        min(canvas_h, int(ry1 / seam_scale) + margin),
                        max(0, int(cx0 / seam_scale) - margin),
                        min(canvas_w, int(cx1 / seam_scale) + margin))
    del comp_imgs, seam_imgs

    # ---- multiband blend with soft masks (:632-666) -----------------------
    bands = B.num_blend_bands(tuning.blend_bands, canvas_h, canvas_w)
    use_tiled = (B.pyramid_bytes(canvas_h, canvas_w, bands)
                 > B.TILED_THRESHOLD_BYTES)
    if use_tiled:
        bands = B.tiled_bands(canvas_h, canvas_w, bands)
    else:
        B.ensure_canvas_fits(canvas_h, canvas_w, bands, dev)
    log.log(_STAGE, "blend", bands=bands, tiled=use_tiled)

    def feed_roi(cv, i, oy, ox, ch_, cw_):
        """Feed strip i into a canvas pyramid whose origin is (ox, oy)."""
        bx0, by0 = boxes[i][0] - x0 - ox, boxes[i][1] - y0 - oy
        bx1, by1 = boxes[i][2] - x0 - ox, boxes[i][3] - y0 - oy
        tlx, tly, rh_b, rw_b = B.bucketed_window(bx0, by0, bx1, by1,
                                                 bands, ch_, cw_)
        gx, gy = ox + tlx, oy + tly
        t_full = t_canvas[i].copy()
        t_full[0, 2] -= gx
        t_full[1, 2] -= gy
        return CF.feed_frame(cv, dev_strips[i], seam_out[i], t_full, tlx,
                             tly, float(gx), float(gy), seam_scale, rh_b,
                             rw_b, mode="global", chan_gain=total_gains[i])

    with log.timer(_STAGE, "blend", sync=sync):
        if use_tiled:
            frame_boxes = [(b[0] - x0, b[1] - y0, b[2] - x0, b[3] - y0)
                           for b in boxes]
            on_rows = None
            if row_sink is not None and crop_box is not None:
                try:
                    row_sink.begin(canvas_h, canvas_w, crop_box)
                    on_rows = row_sink.on_rows
                    log.log(_STAGE, "streaming mosaic write", crop=crop_box)
                except Exception as err:
                    log.log(_STAGE, "streamed write unavailable",
                            error=str(err))
            out, bbox = B.mb_compose_tiled(canvas_h, canvas_w, bands,
                                           frame_boxes, feed_roi, devices,
                                           on_rows=on_rows,
                                           fetch_packed=fetch_packed)
            if on_rows is not None:
                try:
                    t0 = time.perf_counter()
                    hw = row_sink.finish()
                    log.log(_STAGE, "streamed mosaic written", h=hw[0],
                            w=hw[1], encode_seconds=round(
                                getattr(row_sink, "encode_seconds", 0.0), 3),
                            finish_wait_seconds=round(
                                time.perf_counter() - t0, 3))
                except Exception as err:
                    log.log(_STAGE, "streamed write failed", error=str(err))
            if bbox is None:
                raise GlobalStitchError("the blended mosaic is empty")
            by0, by1, bx0, bx1 = bbox
            result = np.ascontiguousarray(out[by0:by1, bx0:bx1])
        else:
            canvas = B.mb_prepare(canvas_h, canvas_w, bands, dev)
            ch_, cw_ = canvas.wacc[0].shape
            for i in range(n):
                canvas = feed_roi(canvas, i, 0, 0, ch_, cw_)
            out, _ = B.mb_blend(canvas, canvas_h, canvas_w)
            del canvas
            result = auto_crop_black_border(B.clip_u8(out).cpu().numpy())
    if info is not None:
        info.update(transforms=transforms, flipped=flipped,
                    seam_methods=methods, canvas=(canvas_h, canvas_w),
                    bands=bands, tiled=use_tiled, crop_box=crop_box)
    return result
