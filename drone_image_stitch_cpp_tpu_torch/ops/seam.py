"""Seam finding: dynamic-programming optimal seams on overlap regions.

Port of the DP path of ``drone_image_stitch_cpp_tpu/ops/seam.py``
(detail::DpSeamFinder(COLOR_GRAD) analog, stitch_robust.cpp:207):
per overlapping pair, a min-cost path through color + gradient
differences splits the overlap. The forward recurrence runs on the device
row by row; the backtrack reads the (H, W) int8 move table once on the
host. The graph-cut seams of the global stage are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .blend import align_up

_BIGCOST = 1e7
_INF = 3e38


def _color_grad_cost(img_a: torch.Tensor, img_b: torch.Tensor,
                     overlap: torch.Tensor) -> torch.Tensor:
    """Per-pixel seam cost inside the overlap; 1e7 elsewhere."""
    diff = torch.sqrt(((img_a - img_b) ** 2).sum(dim=-1) + 1e-6)

    def grad_mag(g):
        gx = torch.zeros_like(g)
        gy = torch.zeros_like(g)
        gx[:, 1:-1] = 0.5 * (g[:, 2:] - g[:, :-2])
        gy[1:-1, :] = 0.5 * (g[2:, :] - g[:-2, :])
        return gx.abs() + gy.abs()

    gdiff = (grad_mag(img_a.mean(dim=-1)) - grad_mag(img_b.mean(dim=-1))
             ).abs()
    return torch.where(overlap, diff + gdiff,
                       torch.full_like(diff, _BIGCOST))


def _vertical_seam_path(cost: torch.Tensor) -> torch.Tensor:
    """Min-cost top-to-bottom path; per-row x index (H,) long. Ties go to
    the lower offset (-1, 0, +1), as jnp.argmin does."""
    h, w = cost.shape
    offs = torch.zeros((h, w), dtype=torch.int8, device=cost.device)
    inf = torch.full((1,), _INF, dtype=torch.float32, device=cost.device)
    prev = cost[0]
    for r in range(1, h):
        stacked = torch.stack([torch.cat([inf, prev[:-1]]), prev,
                               torch.cat([prev[1:], inf])])
        best, arg = torch.min(stacked, dim=0)
        offs[r] = (arg - 1).to(torch.int8)
        prev = cost[r] + best
    offs_h = offs.cpu().numpy()
    xs = np.empty(h, np.int64)
    xs[h - 1] = int(torch.argmin(prev))
    for r in range(h - 1, 0, -1):
        xs[r - 1] = min(max(xs[r] + int(offs_h[r, xs[r]]), 0), w - 1)
    return torch.from_numpy(xs).to(cost.device)


def pairwise_seam(img_a: torch.Tensor, img_b: torch.Tensor,
                  mask_a: torch.Tensor, mask_b: torch.Tensor,
                  axis: str = "vertical"):
    """Split the overlap of two canvas-frame images with a DP seam.

    img_*: (H, W, 3) float32 (zeros outside masks); mask_*: (H, W) bool;
    ``axis``: "vertical" (one x per row: images side by side) or
    "horizontal" (one y per column). Returns (new_mask_a, new_mask_b),
    disjoint on the overlap and unchanged elsewhere; masks pass through
    when there is no overlap.
    """
    if axis == "horizontal":
        na, nb = pairwise_seam(img_a.transpose(0, 1), img_b.transpose(0, 1),
                               mask_a.transpose(0, 1),
                               mask_b.transpose(0, 1), axis="vertical")
        return na.transpose(0, 1), nb.transpose(0, 1)
    h, w = mask_a.shape
    overlap = mask_a & mask_b
    if not bool(overlap.any()):
        return mask_a, mask_b
    seam_x = _vertical_seam_path(_color_grad_cost(img_a, img_b, overlap))
    xs = torch.arange(w, device=mask_a.device)[None, :].expand(h, w)
    xsf = xs.to(torch.float32)
    # which side of the seam belongs to A: compare x-centroids
    ca = (xsf * mask_a).sum() / mask_a.sum().clamp(min=1)
    cb = (xsf * mask_b).sum() / mask_b.sum().clamp(min=1)
    left_of = xs <= seam_x[:, None]
    a_side = left_of if bool(ca <= cb) else ~left_of
    new_a = (mask_a & ~mask_b) | (overlap & a_side)
    new_b = (mask_b & ~mask_a) | (overlap & ~a_side)
    return new_a, new_b


def _mask_bboxes(masks):
    """(y0, y1, x0, x1) bounding box per mask, None when empty; one host
    fetch of the stacked row/col occupancy vectors."""
    rows = torch.stack([m.any(dim=1) for m in masks]).cpu().numpy()
    cols = torch.stack([m.any(dim=0) for m in masks]).cpu().numpy()
    boxes = []
    for r, c in zip(rows, cols):
        ys = np.flatnonzero(r)
        if ys.size == 0:
            boxes.append(None)
            continue
        xs = np.flatnonzero(c)
        boxes.append((int(ys[0]), int(ys[-1]) + 1,
                      int(xs[0]), int(xs[-1]) + 1))
    return boxes


def find_seams_sequential(images, masks, axes=None):
    """Pairwise-sequential DP seams over N canvas-frame images.

    For each ordered pair (i, j), i < j, whose mask boxes intersect, carve
    the overlap between the current masks on the intersection box padded
    to a 64-px grid (the JAX package's crop, kept so both packages cut
    the same windows). ``axes``: per-adjacent-pair seam axis from the
    transform geometry. Returns the new mask list; the input mask tensors
    are updated in place.
    """
    n = len(images)
    masks = list(masks)
    h, w = images[0].shape[:2]
    boxes = _mask_bboxes(masks)
    for i in range(n - 1):
        for j in range(i + 1, n):
            bi, bj = boxes[i], boxes[j]
            if bi is None or bj is None:
                continue
            y0, y1 = max(bi[0], bj[0]), min(bi[1], bj[1])
            x0, x1 = max(bi[2], bj[2]), min(bi[3], bj[3])
            if y0 >= y1 or x0 >= x1:
                continue
            ax = "vertical"
            if axes is not None:
                ax = axes[min(j - 1, len(axes) - 1)]
            y1b = min(h, y0 + align_up(y1 - y0, 64))
            x1b = min(w, x0 + align_up(x1 - x0, 64))
            sl = (slice(y0, y1b), slice(x0, x1b))
            na, nb = pairwise_seam(images[i][sl], images[j][sl],
                                   masks[i][sl], masks[j][sl], axis=ax)
            masks[i][sl] = na
            masks[j][sl] = nb
            # boxes keep their pre-carve extents: masks only shrink
    return masks
