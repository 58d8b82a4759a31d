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
    full-resolution re-solve. The problems are built in tensor code on
    the device that holds the seam images, the same code on a card and
    on the CPU, with the numpy statement's float32 grids; on a CUDA
    device each is solved on the card by csrc/maxflow.cu
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
from .resize import resize_area, resize_linear
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
_PIN = 1e8                   # a terminal capacity no cut can afford


def _host(*vals) -> list:
    """The host values of a few bool or integer device scalars, stacked
    into one copy; a copy from a card adds its bytes to ``_host.bytes``."""
    t = torch.stack([v.to(torch.int64) for v in vals])
    if t.device.type != "cpu":
        _host.bytes += t.nbytes
    return t.tolist()


_host.bytes = 0


def _moved() -> int:
    """Bytes the graph cut's problem builds have moved between host and
    card so far: scalar reads and the area resize's weight matrices."""
    return _host.bytes + resize_linear.uploaded


def _first(occupied: torch.Tensor) -> torch.Tensor:
    """Index of the first True of a bool vector (0 when there is none)."""
    return occupied.to(torch.uint8).argmax()


def _anchored(ma: torch.Tensor, mb: torch.Tensor) -> torch.Tensor:
    """Device bool: each mask has a pixel the other lacks, so both
    terminals of the problem are anchored (no fully nested masks)."""
    return (ma & ~mb).any() & (mb & ~ma).any()


def _gc_problem(a, b, ma, mb):
    """(cap_src, cap_snk, cap_h, cap_v) float32 of one min-cut seam problem
    (COST_COLOR_GRAD analog) on the tensors' device; :func:`_anchored`
    says whether it has both terminals. The grids are the numpy
    statement's bit for bit: the channel sums are float32 adds in channel
    order and the grey is that sum divided by a 3 held on the device, as
    numpy's float32 ``sum`` and ``mean`` compute them (CUDA divides by a
    host scalar through its reciprocal); the root is taken in float64 and
    rounded once to float32, numpy's correctly rounded float32 root (the
    CPU's vectorised float32 root is not correctly rounded)."""
    d = a - b
    d = d * d
    diff = torch.sqrt(((d[..., 0] + d[..., 1]) + d[..., 2] + 1e-6).to(
        torch.float64)).to(torch.float32)
    three = torch.full((), 3.0, dtype=torch.float32, device=a.device)

    def grad(x):
        g = ((x[..., 0] + x[..., 1]) + x[..., 2]) / three
        gx = torch.zeros_like(g)
        gy = torch.zeros_like(g)
        gx[:, 1:-1] = 0.5 * (g[:, 2:] - g[:, :-2]).abs()
        gy[1:-1, :] = 0.5 * (g[2:, :] - g[:-2, :]).abs()
        return gx + gy

    gsum = grad(a) + grad(b)
    cap_src = (ma & ~mb).to(torch.float32) * _PIN
    cap_snk = (mb & ~ma).to(torch.float32) * _PIN
    # color difference damped by the local gradient, so the seam prefers
    # running along real edges
    cost = diff / (1.0 + 0.5 * gsum) + 1e-3
    inb = (ma & mb).to(torch.float32)
    # outside-the-union pixels carry no edges
    union = (ma | mb).to(torch.float32)
    cap_h = ((cost[:, :-1] + cost[:, 1:]) * 0.5
             * torch.maximum(inb[:, :-1], inb[:, 1:])
             * torch.minimum(union[:, :-1], union[:, 1:]))
    cap_v = ((cost[:-1, :] + cost[1:, :]) * 0.5
             * torch.maximum(inb[:-1, :], inb[1:, :])
             * torch.minimum(union[:-1, :], union[1:, :]))
    return cap_src, cap_snk, cap_h, cap_v


def _dilate(mask: torch.Tensor, band: int) -> torch.Tensor:
    """Bool mask dilated by a (2 band + 1)^2 square (cv2.dilate with a
    square kernel), as two 1-D max-pools on its device."""
    k = 2 * band + 1
    x = mask.to(torch.float32)[None, None]
    x = F.max_pool2d(x, (k, 1), stride=1, padding=(band, 0))
    x = F.max_pool2d(x, (1, k), stride=1, padding=(0, band))
    return x[0, 0] > 0.5


def _seam_band(lab: torch.Tensor, band: int) -> torch.Tensor:
    """Bool mask of pixels within ``band`` px (Chebyshev) of a label
    edge."""
    bm = torch.zeros(lab.shape, dtype=torch.bool, device=lab.device)
    dh = lab[:, :-1] != lab[:, 1:]
    bm[:, :-1] |= dh
    bm[:, 1:] |= dh
    dv = lab[:-1, :] != lab[1:, :]
    bm[:-1, :] |= dv
    bm[1:, :] |= dv
    return _dilate(bm, band)


def _cut_touches(lab: torch.Tensor, pinned: torch.Tensor) -> torch.Tensor:
    """Device bool: a label discontinuity has a pinned endpoint."""
    dh = lab[:, :-1] != lab[:, 1:]
    dv = lab[:-1, :] != lab[1:, :]
    return ((dh & (pinned[:, :-1] | pinned[:, 1:])).any()
            | (dv & (pinned[:-1, :] | pinned[1:, :])).any())


def _resize_nearest(x: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """cv2.resize INTER_NEAREST: source index floor(i * n_in / n_out),
    in float64 as numpy computes it; one gather on the tensor's device."""
    h, w = x.shape[:2]

    def index(n_out, n_in):
        i = torch.arange(n_out, dtype=torch.float64, device=x.device)
        return (i * (n_in / n_out)).floor().to(torch.int64).clamp(
            max=n_in - 1)

    return x[index(nh, h)[:, None], index(nw, w)[None, :]]


def _solve(prob):
    """Min-cut labels (h, w) uint8 of one problem (cap_src, cap_snk,
    cap_h, cap_v) on its tensors' device: on a card by the card's kernel,
    on the CPU by the host engine (None without a C++ compiler)."""
    if prob[0].is_cuda:
        from .maxflow_kernel import graphcut_device
        return graphcut_device(*prob)
    from ..utils.native import graphcut_native
    lab = graphcut_native(*(c.numpy() for c in prob))
    return None if lab is None else torch.from_numpy(lab)


def graphcut_pairwise_seam(img_a, img_b, mask_a, mask_b):
    """Min-cut seam on the overlap of two images (GraphCutSeamFinder
    COST_COLOR_GRAD analog, stitch_global.cpp:616-619).

    img_*: (H, W, 3) with whole-number values 0..255 (uint8 or float);
    mask_*: (H, W) bool; all on one device, where the problems are built
    and solved and the new masks returned: only a few scalars cross to
    the host, one read before each branch (the overlap and the union's
    box; the coarse overlap and both terminals; the widen test).

    The cut is solved at full seam resolution: above GC_COARSE_NODES a
    coarse solve picks the seam corridor, then a full-resolution re-solve
    runs with every overlap pixel farther than the band from the coarse
    seam pinned to its coarse side; a cut that presses against the band
    widens it and re-solves once. The ``seam problem`` spans carry
    ``device`` (1: the grids were built on a card). Returns (new_mask_a,
    new_mask_b), or None when the host solver is unavailable, there is no
    overlap, or no exclusive region anchors a terminal (callers fall back
    to the DP seam).
    """
    span = get_logger().span
    card = int(mask_a.is_cuda)
    with span("seam problem", device=card):
        a = img_a.to(torch.float32)
        b = img_b.to(torch.float32)
        ma = mask_a.to(torch.bool)
        mb = mask_b.to(torch.bool)
        h, w = ma.shape
        union = ma | mb
        rows, cols = union.any(dim=1), union.any(dim=0)
        overlap, y0, y_end, x0, x_end = _host(
            (ma & mb).any(), _first(rows), _first(rows.flip(0)),
            _first(cols), _first(cols.flip(0)))
        if not overlap:
            return None
        box = (slice(y0, h - y_end), slice(x0, w - x_end))
        a_, b_, ma_, mb_ = a[box], b[box], ma[box], mb[box]
        fh, fw = ma_.shape
        both = ma_ & mb_
        coarse = fh * fw > GC_COARSE_NODES
        if coarse:
            sc = (GC_COARSE_NODES / float(fh * fw)) ** 0.5
            nh = max(2, int(fh * sc))
            nw = max(2, int(fw * sc))
            mac = _resize_nearest(ma_, nh, nw)
            mbc = _resize_nearest(mb_, nh, nw)
            prob = _gc_problem(resize_area(a_.contiguous(), nh, nw),
                               resize_area(b_.contiguous(), nh, nw),
                               mac, mbc)
            # the coarse masks sample the fine ones, so coarse terminals
            # anchor the fine problem's too
            ok = (mac & mbc).any() & _anchored(mac, mbc)
        else:
            prob = _gc_problem(a_, b_, ma_, mb_)
            ok = _anchored(ma_, mb_)
        if not _host(ok)[0]:
            return None
    labels = _solve(prob)
    if labels is None:
        return None
    lab = labels.to(torch.bool)
    if coarse:
        with span("seam problem", device=card):
            lab_up = _resize_nearest(lab, fh, fw)
            cap_src, cap_snk, cap_h, cap_v = _gc_problem(a_, b_, ma_, mb_)
        # wide enough to cover >= 3 coarse pixels of nearest quantisation
        band = max(32, int(round(3.0 / sc)))
        for attempt in range(2):
            with span("seam band"):
                fixed = both & ~_seam_band(lab_up, band)
                pin_a = fixed & lab_up
                pin_b = fixed & ~lab_up
                cs2 = torch.where(pin_a, _PIN, cap_src)
                ck2 = torch.where(pin_b, _PIN, cap_snk)
            labels = _solve((cs2, ck2, cap_h, cap_v))
            if labels is None:
                return None
            lab = labels.to(torch.bool)
            if attempt == 0:
                with span("seam band"):
                    widen = _host(_cut_touches(lab, pin_a | pin_b))[0]
                if widen:
                    band *= 2
                    continue
            break
    with span("seam fetch"):
        new_a = ma.clone()
        new_b = mb.clone()
        new_a[box] = (ma_ & ~mb_) | (both & lab)
        new_b[box] = (mb_ & ~ma_) | (both & ~lab)
    return new_a, new_b


def _to_u8(img: torch.Tensor) -> torch.Tensor:
    """Round-and-saturate to uint8 on the image's device."""
    return img.round().clamp(0.0, 255.0).to(torch.uint8)


def find_seams_sequential(images, masks, axes=None, method: str = "dp",
                          methods: Optional[Dict[Tuple[int, int], str]]
                          = None):
    """Pairwise-sequential seams over N canvas-frame images.

    For each ordered pair (i, j), i < j, whose mask boxes intersect, carve
    the overlap between the current masks. ``method="dp"``: the DP seam on
    the intersection box padded to a 64-px grid (the JAX package's crop,
    kept so both packages cut the same windows); ``axes``: per-adjacent-
    pair seam axis from the transform geometry. ``method="graphcut"``: the
    min-cut over the pair's union box (256-px grid), quantised to uint8
    on the images' device and cut there with the masks, falling back to
    the DP seam where :func:`graphcut_pairwise_seam` returns None; the
    ``seam fetch`` span that closes each pair carries ``bytes``, what its
    problem builds moved between host and card. ``methods``: optional dict
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
                moved = _moved()
                with log.span("seam fetch"):
                    pair = (_to_u8(images[i][usl]), _to_u8(images[j][usl]),
                            masks[i][usl], masks[j][usl])
                got = graphcut_pairwise_seam(*pair)
                with log.span("seam fetch") as fetch:
                    if got is not None:
                        masks[i][usl] = got[0]
                        masks[j][usl] = got[1]
                    fetch["bytes"] = _moved() - moved
                if got is not None:
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
