"""Seam finding: DP seams and graph-cut seams on overlap regions.

Port of ``drone_image_stitch_cpp_tpu/ops/seam.py``:
  * detail::DpSeamFinder(COLOR_GRAD) analog (stitch_robust.cpp:207): per
    overlapping pair, a min-cost path through color + gradient differences
    splits the overlap. On the card the recurrence and the backtrack are
    one launch of csrc/dp_seam.cu (ops/seam_kernel); CPU tensors run its
    plain version, a row loop and a host backtrack.
  * detail::GraphCutSeamFinder(COST_COLOR_GRAD) analog of the global stage
    (stitch_global.cpp:585-619): a min-cut over the pair's union box, at
    full seam resolution through a coarse solve and a banded
    full-resolution re-solve. The problems are built on the host; on a
    CUDA device each is solved on the card by csrc/maxflow.cu
    (ops/maxflow_kernel.graphcut_device, push-relabel on the free ribbon
    with int64 residuals), elsewhere on the host by the port's
    Boykov-Kolmogorov solver, csrc/graphcut.cpp
    (utils/native.graphcut_native). Both return the source-minimal cut,
    the JAX package's native/graphcut.cpp's, the tests' reference
    solver. The JAX package resizes and dilates with cv2 there; the port
    uses its own area resize (ops/resize.resize_area), index-based
    nearest sampling and a separable max-pool dilation. The DP seam is
    the fallback where the reference falls back: no overlap, nested
    masks, or no solver.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime.logging import get_logger
from .blend import align_up
from .resize import resize_area
from .seam_kernel import seam_path

_BIGCOST = 1e7


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
    the lower offset (-1, 0, +1), as jnp.argmin does. CUDA costs take one
    launch of ``csrc/dp_seam.cu`` (``seam_kernel.seam_path``). The scan is
    one ``dp scan`` span, which ends when the path is ready: on the card
    with one synchronisation, as the host loop's move-table fetch did."""
    h, w = cost.shape
    with get_logger().span("dp scan", rows=h, cols=w):
        xs = seam_path(cost)
        if xs.is_cuda:
            torch.cuda.current_stream(xs.device).synchronize()
    return xs


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


GC_COARSE_NODES = 100_000    # above this many pixels the cut is banded


def _gc_problem(a, b, ma, mb):
    """(cap_src, cap_snk, cap_h, cap_v) of one min-cut seam problem
    (COST_COLOR_GRAD analog) on host arrays, or None when no exclusive
    region anchors a terminal (fully nested masks)."""
    diff = np.sqrt(((a - b) ** 2).sum(-1) + 1e-6)
    gray_a = a.mean(-1)
    gray_b = b.mean(-1)

    def grad(g):
        gx = np.zeros_like(g)
        gy = np.zeros_like(g)
        gx[:, 1:-1] = 0.5 * np.abs(g[:, 2:] - g[:, :-2])
        gy[1:-1, :] = 0.5 * np.abs(g[2:, :] - g[:-2, :])
        return gx + gy

    gsum = grad(gray_a) + grad(gray_b)
    big = np.float32(1e8)
    cap_src = np.where(ma & ~mb, big, 0.0).astype(np.float32)
    cap_snk = np.where(mb & ~ma, big, 0.0).astype(np.float32)
    if cap_src.max() == 0.0 or cap_snk.max() == 0.0:
        return None
    # color difference damped by the local gradient, so the seam prefers
    # running along real edges
    cost = (diff / (1.0 + 0.5 * gsum) + 1e-3).astype(np.float32)
    inb = (ma & mb).astype(np.float32)
    cap_h = ((cost[:, :-1] + cost[:, 1:]) * 0.5
             * np.maximum(inb[:, :-1], inb[:, 1:])).astype(np.float32)
    cap_v = ((cost[:-1, :] + cost[1:, :]) * 0.5
             * np.maximum(inb[:-1, :], inb[1:, :])).astype(np.float32)
    # outside-the-union pixels carry no edges
    union = (ma | mb).astype(np.float32)
    cap_h *= np.minimum(union[:, :-1], union[:, 1:])
    cap_v *= np.minimum(union[:-1, :], union[1:, :])
    return cap_src, cap_snk, cap_h, cap_v


def _dilate(mask: np.ndarray, band: int, device) -> np.ndarray:
    """Bool mask dilated by a (2 band + 1)^2 square (cv2.dilate with a
    square kernel), as two 1-D max-pools on ``device``."""
    k = 2 * band + 1
    x = torch.from_numpy(mask.astype(np.float32)).to(device)[None, None]
    x = F.max_pool2d(x, (k, 1), stride=1, padding=(band, 0))
    x = F.max_pool2d(x, (1, k), stride=1, padding=(0, band))
    return (x[0, 0] > 0.5).cpu().numpy()


def _seam_band(lab: np.ndarray, band: int, device) -> np.ndarray:
    """Bool mask of pixels within ``band`` px (Chebyshev) of a label
    edge."""
    bm = np.zeros(lab.shape, bool)
    dh = lab[:, :-1] != lab[:, 1:]
    bm[:, :-1] |= dh
    bm[:, 1:] |= dh
    dv = lab[:-1, :] != lab[1:, :]
    bm[:-1, :] |= dv
    bm[1:, :] |= dv
    return _dilate(bm, band, device)


def _cut_touches(lab, pinned) -> bool:
    """True when any label discontinuity has a pinned endpoint."""
    dh = lab[:, :-1] != lab[:, 1:]
    if (dh & (pinned[:, :-1] | pinned[:, 1:])).any():
        return True
    dv = lab[:-1, :] != lab[1:, :]
    return bool((dv & (pinned[:-1, :] | pinned[1:, :])).any())


def _resize_nearest(a: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """cv2.resize INTER_NEAREST: source index floor(i * n_in / n_out)."""
    h, w = a.shape[:2]
    ys = np.minimum(np.floor(np.arange(nh) * (h / nh)).astype(np.int64),
                    h - 1)
    xs = np.minimum(np.floor(np.arange(nw) * (w / nw)).astype(np.int64),
                    w - 1)
    return a[ys[:, None], xs[None, :]]


def _resize_area_np(a: np.ndarray, nh: int, nw: int) -> np.ndarray:
    return resize_area(torch.from_numpy(np.ascontiguousarray(a)), nh,
                       nw).numpy()


def _solve(prob, device):
    """Min-cut labels of one problem (cap_src, cap_snk, cap_h, cap_v):
    on a CUDA ``device`` by the card's kernel, elsewhere by the host
    engine (None without a C++ compiler)."""
    if device.type == "cuda":
        from .maxflow_kernel import graphcut_device
        return graphcut_device(*prob, device)
    from ..utils.native import graphcut_native
    return graphcut_native(*prob)


def graphcut_pairwise_seam(img_a, img_b, mask_a, mask_b, device):
    """Min-cut seam on the overlap of two host images (GraphCutSeamFinder
    COST_COLOR_GRAD analog, stitch_global.cpp:616-619).

    The cut is solved at full seam resolution: above GC_COARSE_NODES a
    coarse solve picks the seam corridor, then a full-resolution re-solve
    runs with every overlap pixel farther than the band from the coarse
    seam pinned to its coarse side; a cut that presses against the band
    widens it and re-solves once. The band dilation and, on a card, the
    solves run on ``device``. Returns (new_mask_a, new_mask_b) numpy
    bool, or None when the host solver is unavailable, there is no
    overlap, or no exclusive region anchors a terminal (callers fall back
    to the DP seam).
    """
    span = get_logger().span
    with span("seam problem"):
        a = np.asarray(img_a, np.float32)
        b = np.asarray(img_b, np.float32)
        ma = np.asarray(mask_a, bool)
        mb = np.asarray(mask_b, bool)
        if not (ma & mb).any():
            return None
        ys, xs = np.where(ma | mb)
        y0, y1 = int(ys.min()), int(ys.max()) + 1
        x0, x1 = int(xs.min()), int(xs.max()) + 1
        a_, b_ = a[y0:y1, x0:x1], b[y0:y1, x0:x1]
        ma_, mb_ = ma[y0:y1, x0:x1], mb[y0:y1, x0:x1]
        fh, fw = a_.shape[:2]
        both = ma_ & mb_
        coarse = fh * fw > GC_COARSE_NODES
        if coarse:
            sc = (GC_COARSE_NODES / float(fh * fw)) ** 0.5
            nh = max(2, int(fh * sc))
            nw = max(2, int(fw * sc))
            ac = _resize_area_np(a_, nh, nw)
            bc = _resize_area_np(b_, nh, nw)
            mac = _resize_nearest(ma_, nh, nw)
            mbc = _resize_nearest(mb_, nh, nw)
            if not (mac & mbc).any():
                return None
            prob = _gc_problem(ac, bc, mac, mbc)
        else:
            prob = _gc_problem(a_, b_, ma_, mb_)
    if prob is None:
        return None
    labels = _solve(prob, device)
    if labels is None:
        return None
    lab = labels.astype(bool)
    if coarse:
        with span("seam problem"):
            lab_up = _resize_nearest(lab, fh, fw)
            prob_f = _gc_problem(a_, b_, ma_, mb_)
        if prob_f is None:
            return None
        cap_src, cap_snk, cap_h, cap_v = prob_f
        big = np.float32(1e8)
        # wide enough to cover >= 3 coarse pixels of nearest quantisation
        band = max(32, int(round(3.0 / sc)))
        for attempt in range(2):
            with span("seam band"):
                in_band = _seam_band(lab_up, band, device)
                pin_a = both & ~in_band & lab_up
                pin_b = both & ~in_band & ~lab_up
                cs2 = cap_src.copy()
                ck2 = cap_snk.copy()
                cs2[pin_a] = big
                ck2[pin_b] = big
            labels = _solve((cs2, ck2, cap_h, cap_v), device)
            if labels is None:
                return None
            lab = labels.astype(bool)
            if attempt == 0:
                with span("seam band"):
                    widen = _cut_touches(lab, pin_a | pin_b)
                if widen:
                    band *= 2
                    continue
            break
    with span("seam fetch"):
        new_a = ma.copy()
        new_b = mb.copy()
        new_a[y0:y1, x0:x1] = (ma_ & ~mb_) | (both & lab)
        new_b[y0:y1, x0:x1] = (mb_ & ~ma_) | (both & ~lab)
    return new_a, new_b


def _to_u8(img: torch.Tensor) -> np.ndarray:
    """Round-and-saturate to uint8 on the device, then one host copy."""
    return img.round().clamp(0.0, 255.0).to(torch.uint8).cpu().numpy()


def find_seams_sequential(images, masks, axes=None, method: str = "dp",
                          methods: Optional[Dict[Tuple[int, int], str]]
                          = None):
    """Pairwise-sequential seams over N canvas-frame images.

    For each ordered pair (i, j), i < j, whose mask boxes intersect, carve
    the overlap between the current masks. ``method="dp"``: the DP seam on
    the intersection box padded to a 64-px grid (the JAX package's crop,
    kept so both packages cut the same windows); ``axes``: per-adjacent-
    pair seam axis from the transform geometry. ``method="graphcut"``: the
    min-cut over the pair's union box (256-px grid), copied to the host
    as uint8 with the masks, falling back to the DP seam where
    :func:`graphcut_pairwise_seam` returns None. ``methods``: optional dict
    that receives the method that cut each pair. Returns the new mask
    list; the input mask tensors are updated in place.
    """
    log = get_logger()
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
            if method == "graphcut":
                uy0, ux0 = min(bi[0], bj[0]), min(bi[2], bj[2])
                uy1 = min(h, uy0 + align_up(max(bi[1], bj[1]) - uy0, 256))
                ux1 = min(w, ux0 + align_up(max(bi[3], bj[3]) - ux0, 256))
                usl = (slice(uy0, uy1), slice(ux0, ux1))
                with log.span("seam fetch"):
                    host = (_to_u8(images[i][usl]), _to_u8(images[j][usl]),
                            masks[i][usl].cpu().numpy(),
                            masks[j][usl].cpu().numpy())
                got = graphcut_pairwise_seam(*host, masks[i].device)
                if got is not None:
                    dev = masks[i].device
                    with log.span("seam fetch"):
                        masks[i][usl] = torch.from_numpy(got[0]).to(dev)
                        masks[j][usl] = torch.from_numpy(got[1]).to(dev)
                    if methods is not None:
                        methods[(i, j)] = "graphcut"
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
            if methods is not None:
                methods[(i, j)] = "dp"
            # boxes keep their pre-carve extents: masks only shrink
    return masks
