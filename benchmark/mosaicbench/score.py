"""Scores of a mosaic against its planted ground truth.

:func:`gt_rmse_rows` is a frozen copy of ``gt_rmse_rows`` in
``drone_image_stitch_cpp_tpu_torch/tools/sortie_bench.py`` at commit
8b7ff0e672e454ed1a7cdb8444acc84ca8d92c55 (cv2 phase correlation of gray
downscales, the full-resolution shift, the eroded gray > 2 mask, the
9-tap sigma-2 blur), split at the per-pixel squared difference so that
:func:`score_image` can read the same difference by blocks and by
coverage. ``tests/test_bench_frozen.py`` holds it equal to the program's.
Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np


def _aligned_diff(mosaic: np.ndarray, gt: np.ndarray, max_dim: int):
    """(per-pixel mean squared difference of the blurred, shifted mosaic
    and ground truth, the eroded mask of mosaic content, dx, dy)."""
    import cv2

    def gray(a):
        return cv2.cvtColor(a, cv2.COLOR_BGR2GRAY).astype(np.float32)

    s = min(1.0, max_dim / max(gt.shape[0], gt.shape[1],
                               mosaic.shape[0], mosaic.shape[1]))
    gm = cv2.resize(gray(mosaic), None, fx=s, fy=s,
                    interpolation=cv2.INTER_AREA)
    gg = cv2.resize(gray(gt), None, fx=s, fy=s,
                    interpolation=cv2.INTER_AREA)
    h = min(gm.shape[0], gg.shape[0])
    w = min(gm.shape[1], gg.shape[1])
    (dx, dy), _ = cv2.phaseCorrelate(gm[:h, :w], gg[:h, :w])
    # full-res shift of the mosaic onto the gt frame
    fdx, fdy = dx / s, dy / s
    m = cv2.warpAffine(
        mosaic, np.asarray([[1, 0, fdx], [0, 1, fdy]], np.float32),
        (gt.shape[1], gt.shape[0]))
    valid = (cv2.cvtColor(m, cv2.COLOR_BGR2GRAY) > 2)
    valid = cv2.erode(valid.astype(np.uint8), np.ones((9, 9), np.uint8))
    mb = cv2.GaussianBlur(m.astype(np.float32), (9, 9), 2.0)
    gb = cv2.GaussianBlur(gt.astype(np.float32), (9, 9), 2.0)
    diff = ((mb - gb) ** 2).mean(axis=-1)
    return diff, valid.astype(bool), fdx, fdy


def _rmse(d, m):
    return float(np.sqrt(d[m].mean())) if m.sum() >= 1000 \
        else float("inf")


def gt_rmse_rows(mosaic: np.ndarray, gt: np.ndarray, max_dim: int = 4000,
                 rows=()):
    """Blurred RMSE of a mosaic against the ground-truth ortho crop after
    the phase-correlated shift, and the same RMSE over each (y0, y1) band
    of ground-truth rows in ``rows`` (inf where a band holds under 1000
    common pixels): (rmse, dx, dy, [band rmse])."""
    diff, sel, fdx, fdy = _aligned_diff(mosaic, gt, max_dim)
    return (_rmse(diff, sel), fdx, fdy,
            [_rmse(diff[y0:y1], sel[y0:y1]) for y0, y1 in rows])


def score_image(img: np.ndarray, gt: np.ndarray, block_hw, max_dim: int
                ) -> dict:
    """What the check compares of one output image against its ground
    truth: ``rmse`` (:func:`gt_rmse_rows`' whole RMSE), ``block_rmse``
    (the worst RMSE over a grid of (bh, bw) = ``block_hw`` blocks of the
    ground truth, blocks under 1000 common pixels left out), ``uncovered``
    (the share of ground-truth pixels, in %, that the eroded mosaic
    content does not cover) and ``size_px`` (the largest difference of the
    image's height or width from the ground truth's)."""
    diff, sel, fdx, fdy = _aligned_diff(img, gt, max_dim)
    bh, bw = block_hw
    blocks = [_rmse(diff[y:y + bh, x:x + bw], sel[y:y + bh, x:x + bw])
              for y in range(0, gt.shape[0], bh)
              for x in range(0, gt.shape[1], bw)]
    finite = [b for b in blocks if np.isfinite(b)]
    return {"rmse": _rmse(diff, sel),
            "block_rmse": max(finite) if finite else float("inf"),
            "uncovered": float(100.0 * (1.0 - sel.mean())),
            "size_px": int(max(abs(img.shape[0] - gt.shape[0]),
                               abs(img.shape[1] - gt.shape[1]))),
            "shift": (float(fdx), float(fdy))}
