"""Two-frame stitch: detect -> match -> RANSAC -> warp -> feather blend.

Port of ``drone_image_stitch_cpp_tpu/pipeline/pairwise.py``, the library
entry of a two-frame job and the analog of the reference's 2-image path:
the computePairDiagnostics health check (SIFT -> kNN-2 -> Lowe 0.75 ->
findHomography RANSAC 3.0 -> inlier count, stitch_robust.cpp:76-142)
gated by min_good_matches / min_inliers (stitch_robust.cpp:233-243), then
the chosen model refitted on the same features and both frames warped
onto one canvas with the perspective warp and feather-blended.

The detect runs K1 (``ops/features``); the warps are the plain PyTorch
``ops/warp.warp_perspective``, as the JAX package never sends them to its
Pallas kernel. The RANSAC sample integers come from a ``torch.Generator``
seeded with ``seed`` (one fresh stream per model kind, as the JAX package
reuses its one key), or are injected through ``raw``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from ..config.tuning import StitchTuning
from ..ops import match as M
from ..ops import ransac as R
from ..ops.blend import border_feather_weight, feather_blend
from ..ops.crop import auto_crop_black_border
from ..ops.transform import apply_homography_pts, image_corners
from ..ops.warp import warp_perspective
from ..runtime.device import resolve_device
from ..runtime.logging import get_logger
from .registration import detect_features

_LOWE_RATIO = 0.75   # fixed pair-diagnostics ratio (stitch_robust.cpp:110)
_HOMOG_THRESH = 3.0  # findHomography reprojection threshold (:135)
_N_HYP = 1024        # RANSAC hypotheses per fit (the JAX package's default)


@dataclass
class PairDiagnostics:
    """Reference: PairDiagnostics struct (stitch_robust.cpp:23-30)."""

    kp_a: int
    kp_b: int
    good_matches: int
    inliers: int

    @property
    def inlier_ratio(self) -> float:
        return self.inliers / max(1, self.good_matches)


def _bank(kind: str, seed: int, raw: Optional[Mapping], device
          ) -> torch.Tensor:
    """(1, n_hyp, m) RANSAC sample integers for ``kind``: ``raw[kind]``
    when given, else drawn from a torch.Generator seeded with ``seed``."""
    if raw is not None and kind in raw:
        bank = torch.as_tensor(np.asarray(raw[kind]))
    else:
        g = torch.Generator(device="cpu")
        g.manual_seed(seed)
        bank = torch.randint(0, 2 ** 31 - 1, (_N_HYP, R.MIN_SAMPLES[kind]),
                             generator=g)
    return bank[None].to(device)


def _correspondences(feats):
    m = M.knn2_ratio(feats.desc[0], feats.valid[0], feats.desc[1],
                     feats.valid[1], _LOWE_RATIO)
    src, dst, good = M.gather_correspondences(feats.xy[0], feats.xy[1], m)
    return m, src, dst, good


def compute_pair_diagnostics(img_a: np.ndarray, img_b: np.ndarray,
                             tuning: StitchTuning, seed: int = 0,
                             device="cuda", raw: Optional[Mapping] = None):
    """Pair health check: (diag, model (3, 3) numpy or None, the RANSAC
    result, the features, the work scale).

    Mirrors computePairDiagnostics (stitch_robust.cpp:76-142): features,
    kNN-2 with the fixed 0.75 ratio, RANSAC homography at 3 px. The
    features and work scale are returned so callers refit other model
    classes without detecting again."""
    dev = resolve_device(device)
    feats, scale = detect_features([img_a, img_b], tuning.sift_features,
                                   tuning.registration_resol_mpx, device=dev)
    m, src, dst, good = _correspondences(feats)
    res = R.find_homography(src[None], dst[None], good[None],
                            _bank("homography", seed, raw, dev),
                            thresh=_HOMOG_THRESH / scale, refine_iters=3)
    diag = PairDiagnostics(
        kp_a=int(feats.valid[0].sum()), kp_b=int(feats.valid[1].sum()),
        good_matches=int(m.good.sum()), inliers=int(res.n_inliers[0]))
    model = res.model[0].cpu().numpy() if bool(res.ok[0]) else None
    return diag, model, res, feats, scale


def pair_gates_pass(diag: PairDiagnostics, tuning: StitchTuning) -> bool:
    """Health gates (stitch_robust.cpp:233-243)."""
    return (diag.good_matches >= tuning.min_good_matches
            and diag.inliers >= tuning.min_inliers)


def stitch_pair(img_a: np.ndarray, img_b: np.ndarray,
                tuning: Optional[StitchTuning] = None,
                model_kind: str = "similarity", autocrop: bool = True,
                seed: int = 0, device="cuda",
                raw: Optional[Mapping] = None) -> np.ndarray:
    """Stitch two (H, W, 3) uint8 BGR frames into one feather-blended
    panorama (uint8, autocropped unless ``autocrop`` is False).

    ``model_kind``: "similarity" (the SCANS-mode affine family, the
    reference's default geometry), "affine" or "homography" (full
    perspective). ``raw``: optional RANSAC sample banks by kind
    ({"homography": (n_hyp, 4), "similarity": (n_hyp, 2), ...} integers).
    Raises RuntimeError when the pair fails its gates or the model fit.
    """
    log = get_logger()
    tuning = tuning or StitchTuning()
    dev = resolve_device(device)
    diag, _, res, feats, scale = compute_pair_diagnostics(
        img_a, img_b, tuning, seed, dev, raw)
    log.log("Pair", "diagnostics", kp_a=diag.kp_a, kp_b=diag.kp_b,
            good=diag.good_matches, inliers=diag.inliers)
    if not pair_gates_pass(diag, tuning):
        raise RuntimeError(
            f"pair gates failed: good={diag.good_matches} "
            f"inliers={diag.inliers} (need {tuning.min_good_matches}/"
            f"{tuning.min_inliers})")

    if model_kind != "homography":
        # refit the chosen model class on the same features (one detect
        # per pair: detection dominates a two-frame job)
        _, src, dst, good = _correspondences(feats)
        res = R.ransac(src[None], dst[None], good[None],
                       _bank(model_kind, seed, raw, dev), model_kind,
                       thresh=4.0 / scale, refine_iters=3)
        if not bool(res.ok[0]):
            raise RuntimeError("model estimation failed")

    # the model maps A -> B; compose both on a canvas holding A unmoved
    # (host float32: a few 3x3 products)
    h_ab = res.model[0].cpu()
    h_ba = torch.linalg.inv(h_ab)
    ha, wa = img_a.shape[:2]
    hb, wb = img_b.shape[:2]
    corners_b = apply_homography_pts(h_ba, image_corners(hb, wb))
    # an integer origin keeps frame A pixel-aligned on the canvas
    x0 = float(np.floor(min(float(corners_b[:, 0].min()), 0.0)))
    y0 = float(np.floor(min(float(corners_b[:, 1].min()), 0.0)))
    x1 = max(float(corners_b[:, 0].max()), wa - 1.0)
    y1 = max(float(corners_b[:, 1].max()), ha - 1.0)
    out_w = int(np.ceil(x1 - x0)) + 1
    out_h = int(np.ceil(y1 - y0)) + 1
    shift = torch.tensor([[1.0, 0.0, -x0], [0.0, 1.0, -y0],
                          [0.0, 0.0, 1.0]], dtype=torch.float32)
    t_a, t_b = shift, shift @ h_ba          # A -> canvas, B -> canvas

    a32 = torch.from_numpy(np.ascontiguousarray(img_a)).to(dev).float()
    b32 = torch.from_numpy(np.ascontiguousarray(img_b)).to(dev).float()
    warped_a = warp_perspective(a32, t_a, out_h, out_w)
    warped_b = warp_perspective(b32, t_b, out_h, out_w)
    wwa = warp_perspective(border_feather_weight(ha, wa, device=dev), t_a,
                           out_h, out_w)
    wwb = warp_perspective(border_feather_weight(hb, wb, device=dev), t_b,
                           out_h, out_w)
    out, _ = feather_blend([warped_a, warped_b], [wwa, wwb])
    # truncated like the JAX package's astype(np.uint8), not rounded
    pano = out.to(torch.uint8).cpu().numpy()
    if autocrop:
        pano = auto_crop_black_border(pano)
    log.log("Pair", "stitched", h=pano.shape[0], w=pano.shape[1])
    return pano
