"""Whole-canvas multiband (Laplacian) blending.

Port of the whole-canvas part of ``drone_image_stitch_cpp_tpu/ops/
blend.py`` (detail::MultiBandBlender analog, stitch_robust.cpp:213): each
frame enters as an ROI patch aligned to the 2^bands grid, and its
mask-normalised Laplacian pyramid accumulates into one shared canvas
pyramid, so no per-frame canvas is ever materialised. The accumulators
are updated in place.

The JAX package streams canvases whose pyramid exceeds 512 MB through
tiles. The port keeps the whole canvas on the card and instead checks the
pyramid against ``torch.cuda.mem_get_info()``: a canvas that will not fit
raises :class:`CanvasTooLargeError` (the tiled compose is not ported).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .gaussian import collapse_laplacian, gaussian_pyramid, pyr_up


class CanvasTooLargeError(MemoryError):
    """The whole-canvas pyramid would not fit in the card's free memory."""


def align_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def align_down(v: int, m: int) -> int:
    return (v // m) * m


def aligned_roi(x0: float, y0: float, x1: float, y1: float, bands: int,
                canvas_h: int, canvas_w: int):
    """Expand a float bbox to the 2^bands grid and clip to the canvas.
    Returns (tl_x, tl_y, w, h), all multiples of 2^bands."""
    g = 1 << bands
    tlx = max(0, align_down(int(math.floor(x0)) - g, g))
    tly = max(0, align_down(int(math.floor(y0)) - g, g))
    brx = min(canvas_w, align_up(int(math.ceil(x1)) + g, g))
    bry = min(canvas_h, align_up(int(math.ceil(y1)) + g, g))
    brx = max(brx, tlx + g)
    bry = max(bry, tly + g)
    return tlx, tly, brx - tlx, bry - tly


FEED_SNAP = 1024  # feed-window dim quantum


def bucketed_window(x0: float, y0: float, x1: float, y1: float,
                    bands: int, ch: int, cw: int, snap: int = FEED_SNAP):
    """Feed window covering the float bbox: sizes snapped up to multiples
    of ``snap`` (capped at the aligned canvas), positions shifted to stay
    inside. Kept from the JAX package so both cut the same ROI windows
    (the pyramid of a window depends on its borders).
    Returns (tl_x, tl_y, h, w)."""
    g = 1 << bands
    tlx, tly, rw, rh = aligned_roi(x0, y0, x1, y1, bands, ch, cw)
    rw += tlx % 256
    tlx = align_down(tlx, 256)
    rh += tly % 256
    tly = align_down(tly, 256)
    caw = align_up(cw, g)
    cah = align_up(ch, g)
    rw_b = min(align_up(rw, snap), caw)
    rh_b = min(align_up(rh, snap), cah)
    tlx = min(tlx, caw - rw_b)
    tly = min(tly, cah - rh_b)
    return tlx, tly, rh_b, rw_b


class MultiBandCanvas(NamedTuple):
    """Shared canvas pyramid accumulators."""

    acc: list    # per level: (Hl, Wl, 3) float32 weighted laplacians
    wacc: list   # per level: (Hl, Wl) float32 weights


def pyramid_bytes(canvas_h: int, canvas_w: int, bands: int) -> int:
    """Bytes of the mb_prepare accumulators for a canvas."""
    ch = align_up(canvas_h, 1 << bands)
    cw = align_up(canvas_w, 1 << bands)
    return sum((ch >> lvl) * (cw >> lvl) * 4 * 4 for lvl in range(bands + 1))


# the accumulators, their normalised copy and the collapse transients
_BLEND_FOOTPRINT = 3


def ensure_canvas_fits(canvas_h: int, canvas_w: int, bands: int,
                       device: torch.device) -> None:
    """Raise CanvasTooLargeError when the whole-canvas blend of this size
    would not fit in the card's free memory (no-op off the card)."""
    if device.type != "cuda":
        return
    need = _BLEND_FOOTPRINT * pyramid_bytes(canvas_h, canvas_w, bands)
    free, total = torch.cuda.mem_get_info(device)
    if need > free:
        raise CanvasTooLargeError(
            f"canvas {canvas_h}x{canvas_w} at {bands} bands needs "
            f"~{need >> 20} MiB for its whole-canvas pyramid; {free >> 20} "
            f"of {total >> 20} MiB free (the tiled compose is not ported)")


def mb_prepare(canvas_h: int, canvas_w: int, bands: int,
               device: torch.device) -> MultiBandCanvas:
    """Zeroed canvas pyramids; dims padded to the 2^bands grid."""
    ch = align_up(canvas_h, 1 << bands)
    cw = align_up(canvas_w, 1 << bands)
    acc = [torch.zeros((ch >> l, cw >> l, 3), dtype=torch.float32,
                       device=device) for l in range(bands + 1)]
    wacc = [torch.zeros((ch >> l, cw >> l), dtype=torch.float32,
                        device=device) for l in range(bands + 1)]
    return MultiBandCanvas(acc=acc, wacc=wacc)


def mb_feed(canvas: MultiBandCanvas, img_roi: torch.Tensor,
            weight_roi: torch.Tensor, tl_x: int, tl_y: int,
            content_roi: torch.Tensor) -> MultiBandCanvas:
    """Accumulate one (Hr, Wr, 3) patch with (Hr, Wr) weights in place.

    The Laplacian pyramid is built from the mask-normalised image pyramid
    gp(img*m)/gp(m), which extends content across its boundary instead of
    mixing black padding into the coarse levels. ``tl_x``/``tl_y`` and
    Hr/Wr are multiples of 2^bands (see ``aligned_roi``).
    """
    bands = len(canvas.acc) - 1
    m = content_roi.to(torch.float32)
    gp_i = gaussian_pyramid(img_roi * m[..., None], bands)
    gp_m = gaussian_pyramid(m, bands)
    norm = [gi / gm.clamp(min=1e-6)[..., None] for gi, gm in zip(gp_i, gp_m)]
    lap = [norm[l] - pyr_up(norm[l + 1], norm[l].shape[0], norm[l].shape[1])
           for l in range(bands)] + [norm[bands]]
    wp = gaussian_pyramid(weight_roi.to(torch.float32), bands)
    for lvl in range(bands + 1):
        ox, oy = tl_x >> lvl, tl_y >> lvl
        w = wp[lvl]
        hh, ww = w.shape
        canvas.acc[lvl][oy:oy + hh, ox:ox + ww] += lap[lvl] * w[..., None]
        canvas.wacc[lvl][oy:oy + hh, ox:ox + ww] += w
    return canvas


def mb_blend(canvas: MultiBandCanvas, out_h: int, out_w: int):
    """Normalise, collapse, crop. Returns (img (H, W, 3) float32 in
    [0, 255], valid (H, W) bool)."""
    eps = 1e-5
    pyr = [a / (w[..., None] + eps) for a, w in zip(canvas.acc, canvas.wacc)]
    out = collapse_laplacian(pyr)
    valid = canvas.wacc[0] > 1e-3
    out = torch.where(valid[..., None], out,
                      torch.zeros((), device=out.device))
    return (out[:out_h, :out_w].clamp(0.0, 255.0), valid[:out_h, :out_w])


def clip_u8(img: torch.Tensor) -> torch.Tensor:
    """float -> uint8 the JAX way: clip to [0, 255], then truncate."""
    return img.clamp(0.0, 255.0).to(torch.uint8)
