"""Banked ROI x flip strip alignment: one batched pass, one host read.

Port of ``drone_image_stitch_cpp_tpu/pipeline/roi_align.py``
(estimatePairAffineWithRoiSearch + the flip hypothesis, stitch_global.cpp:
226-289 ROI grid, :401-421 flip choice). Features are detected once per
strip; an ROI hypothesis is a validity mask over the fixed keypoint set,
and the flipped variant is the closed-form mirror of the same features
(ops/features.mirror_features). One distance product per variant is
shared by all hypotheses; the masked top-2 + ratio test and the affine
RANSAC run as one batch over (variant = 2) x (hypothesis <= 16), and one
host read brings back every hypothesis's model, inliers, matches and ok.

ROI rects mirror the reference: full frame, left-heavy (0..0.68 x,
0.05..0.95 y), right-heavy (0.32..1.0 x), centre (0.16..0.84 x),
deduplicated, dropped when narrower or shorter than 120 px.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config.tuning import StitchTuning
from ..ops import match as M
from ..ops import ransac as R

_ROI_MIN_PX = 120     # reference :243-245
N_HYP_MAX = 16        # 4 ref ROIs x 4 cur ROIs
N_RANSAC_HYP = 1024   # RANSAC samples per hypothesis

# fractional ROI grid (x0, x1, y0, y1), reference :236-239
_ROI_FRACTIONS = (
    (0.00, 1.00, 0.00, 1.00),   # full
    (0.00, 0.68, 0.05, 0.95),   # left-heavy
    (0.32, 1.00, 0.05, 0.95),   # right-heavy
    (0.16, 0.84, 0.05, 0.95),   # centre
)


@dataclass
class PairAffineEstimate:
    """Reference: PairAffineEstimate (stitch_global.cpp:32-39)."""

    ok: bool
    model: Optional[np.ndarray]  # (3, 3) cur -> ref, full-res strip coords
    inliers: int = 0
    matches: int = 0
    ratio: float = 0.0

    @property
    def score(self) -> float:
        return self.inliers + 20.0 * self.ratio + 0.02 * self.matches


def roi_candidates(shape) -> List[Tuple[float, float, float, float]]:
    """ROI rects (x0, x1, y0, y1) in image pixels (buildStripRoi
    Candidates, stitch_global.cpp:226-259): floor/ceil rounding, >= 120 px
    in both dims, deduplicated; the full frame when none survives."""
    h, w = int(shape[0]), int(shape[1])
    rois: List[Tuple[float, float, float, float]] = []
    for fx0, fx1, fy0, fy1 in _ROI_FRACTIONS:
        x = min(max(int(np.floor(w * fx0)), 0), max(0, w - 1))
        y = min(max(int(np.floor(h * fy0)), 0), max(0, h - 1))
        r = min(max(int(np.ceil(w * fx1)), x + 1), w)
        b = min(max(int(np.ceil(h * fy1)), y + 1), h)
        if r - x < _ROI_MIN_PX or b - y < _ROI_MIN_PX:
            continue
        rect = (float(x), float(r), float(y), float(b))
        if rect not in rois:
            rois.append(rect)
    if not rois:
        rois.append((0.0, float(w), 0.0, float(h)))
    return rois


def build_hyp_bank(cur_shape, ref_shape) -> Tuple[np.ndarray, int]:
    """((N_HYP_MAX, 8) rows [cx0, cx1, cy0, cy1, rx0, rx1, ry0, ry1],
    n_real): the ref x cur grid like the reference's nested loop
    (:271-272); rows past ``n_real`` repeat row 0 to keep the batch shape
    and must never be scored (they draw their own samples)."""
    cur_rois = roi_candidates(cur_shape)
    ref_rois = roi_candidates(ref_shape)
    rows = [np.asarray(list(c) + list(r), np.float32)
            for r in ref_rois for c in cur_rois]
    rows = rows[:N_HYP_MAX]
    n_real = len(rows)
    while len(rows) < N_HYP_MAX:
        rows.append(rows[0])
    return np.stack(rows), n_real


def _in_rect(xy: torch.Tensor, rect: torch.Tensor) -> torch.Tensor:
    """(..., H, K) keypoint-in-rect masks of (..., K, 2) points against
    (H, 4) rects (x0, x1, y0, y1)."""
    x = xy[..., None, :, 0]
    y = xy[..., None, :, 1]
    return ((x >= rect[:, 0:1]) & (x < rect[:, 1:2])
            & (y >= rect[:, 2:3]) & (y < rect[:, 3:4]))


def banked_align(desc_c, xy_c, valid_c, desc_r, xy_r, valid_r, hyp, raw,
                 ratio: float, thresh: float):
    """Every (variant, hypothesis) alignment in one batch.

    ``desc_c``/``xy_c``/``valid_c``: (V, K, .) current-strip variants;
    ``desc_r``/``xy_r``/``valid_r``: (K, .) reference features; ``hyp``:
    (H, 8) rect rows; ``raw``: (V, H, n_hyp, 3) RANSAC sample integers.
    Returns (model (V, H, 3, 3), n_inliers (V, H), n_matches (V, H),
    ok (V, H)) as device tensors.
    """
    v, k = valid_c.shape
    h = hyp.shape[0]
    d2 = M.distance_sq(desc_c, desc_r[None], valid_c, valid_r[None])
    vc = valid_c[:, None] & _in_rect(xy_c, hyp[:, 0:4])       # (V, H, K)
    vr = valid_r[None] & _in_rect(xy_r, hyp[:, 4:8])           # (H, K)
    m = M.knn2_ratio_from_d2(d2[:, None], vc, vr[None], ratio)
    src = xy_c[:, None].expand(v, h, k, 2)
    dst = xy_r[m.idx]                                          # (V, H, K, 2)
    n_good = m.good.sum(dim=-1)
    res = R.ransac(src.reshape(v * h, k, 2), dst.reshape(v * h, k, 2),
                   m.good.reshape(v * h, k), raw.reshape(v * h, -1, 3),
                   "affine", thresh)
    return (res.model.reshape(v, h, 3, 3), res.n_inliers.reshape(v, h),
            n_good, res.ok.reshape(v, h))


def sample_bank(seed: int, n_var: int = 2, n_hyp: int = N_HYP_MAX,
                n_samp: int = N_RANSAC_HYP) -> torch.Tensor:
    """(n_var, n_hyp, n_samp, 3) affine RANSAC sample integers from a
    seeded CPU generator (the same on every device)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return torch.randint(0, 2 ** 31 - 1, (n_var, n_hyp, n_samp, 3),
                         generator=g)


def _pick_best(models, n_inl, n_good, ok, min_good: int,
               min_inl: int) -> PairAffineEstimate:
    """Best-score hypothesis of one variant under the halved gates
    (reference :170 matches, :201 inliers)."""
    best = PairAffineEstimate(ok=False, model=None,
                              matches=int(n_good.max(initial=0)),
                              inliers=int(n_inl.max(initial=0)))
    for hh in range(len(ok)):
        if not ok[hh]:
            continue
        if n_good[hh] < max(2, min_good) or n_inl[hh] < max(2, min_inl):
            continue
        est = PairAffineEstimate(
            ok=True, model=np.asarray(models[hh]), inliers=int(n_inl[hh]),
            matches=int(n_good[hh]),
            ratio=float(n_inl[hh]) / max(1, int(n_good[hh])))
        if not best.ok or est.score > best.score:
            best = est
    return best


def align_pair_banked(f_ref, s_ref: float, f_cur, f_cur_flip, ref_shape,
                      cur_shape, tuning: StitchTuning, seed: int,
                      raw: Optional[torch.Tensor] = None
                      ) -> Tuple[PairAffineEstimate, PairAffineEstimate]:
    """(direct, flipped) best-ROI estimates for one strip pair.

    ``f_cur_flip`` is the mirrored feature set (coordinates in the flipped
    strip's frame), so the flipped model maps flipped-cur coordinates into
    ref. ``raw``: optional (2, N_HYP_MAX, n_hyp, 3) sample bank (default
    :func:`sample_bank` with ``seed``).
    """
    hyp_np, n_real = build_hyp_bank(cur_shape, ref_shape)
    dev = f_ref.desc.device
    if raw is None:
        raw = sample_bank(seed)
    out = banked_align(
        torch.stack([f_cur.desc[0], f_cur_flip.desc[0]]),
        torch.stack([f_cur.xy[0], f_cur_flip.xy[0]]),
        torch.stack([f_cur.valid[0], f_cur_flip.valid[0]]),
        f_ref.desc[0], f_ref.xy[0], f_ref.valid[0],
        torch.from_numpy(hyp_np).to(dev), raw.to(dev),
        M.adaptive_ratio(tuning.match_conf), 4.0 / max(s_ref, 1e-6))
    # ONE host read for all hypotheses
    flat = torch.cat([out[0].reshape(-1).double(),
                      *(a.reshape(-1).double() for a in out[1:])]).cpu()
    flat = flat.numpy()
    nv, nh = out[1].shape
    models = flat[:nv * nh * 9].reshape(nv, nh, 3, 3).astype(np.float32)
    rest = flat[nv * nh * 9:].reshape(3, nv, nh)
    n_inl = rest[0].astype(np.int64)
    n_good = rest[1].astype(np.int64)
    ok = rest[2].astype(bool)
    mg = tuning.min_good_matches // 2
    mi = tuning.min_inliers // 2
    # rows >= n_real are shape padding (see build_hyp_bank): never scored
    direct = _pick_best(models[0][:n_real], n_inl[0][:n_real],
                        n_good[0][:n_real], ok[0][:n_real], mg, mi)
    flip = _pick_best(models[1][:n_real], n_inl[1][:n_real],
                      n_good[1][:n_real], ok[1][:n_real], mg, mi)
    return direct, flip
