"""Multiband (Laplacian) blending: whole canvas and tiled.

Port of ``drone_image_stitch_cpp_tpu/ops/blend.py`` (detail::
MultiBandBlender analog, stitch_robust.cpp:213, stitch_global.cpp:
632-660): each frame enters as an ROI patch aligned to the 2^bands grid,
and its mask-normalised Laplacian pyramid accumulates into one shared
canvas pyramid, so no per-frame canvas is ever materialised. The
accumulators are updated in place.

Canvases whose pyramid exceeds ``TILED_THRESHOLD_BYTES`` blend through
fixed-size tiles (:func:`mb_compose_tiled`), exactly as the JAX package
decides and cuts them: the tile geometry, the ``EXT_SNAP`` snap of the
extended windows and the band downgrade of :func:`tiled_bands` decide the
mosaic, not only the memory. Each tile's core is cropped on the device
with its content flags (the reference's fixed-point gray > 1), so the
caller's autocrop box needs no host gray pass. With ``fetch_packed`` a
host-assembled tile leaves the device as packed video-range I420
(``ops/color.bgr_to_yuv420``, 1.5 bytes a pixel) and is unpacked with
``cv2.COLOR_YUV2BGR_I420`` (ops/blend.py:378, 476-501 of the JAX
package). A whole canvas that would not fit the card's free memory raises
:class:`CanvasTooLargeError`.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime.device import placement
from ..runtime.logging import get_logger
from .color import bgr_to_yuv420
from .gaussian import collapse_laplacian, gaussian_pyramid, pyr_up


class CanvasTooLargeError(MemoryError):
    """The whole-canvas pyramid would not fit in the card's free memory."""


def num_blend_bands(cfg_bands: int, canvas_h: int, canvas_w: int) -> int:
    """Reference band formula (stitch_global.cpp:632-635): the canvas-
    derived term is capped at 12, a configured count above 12 is kept."""
    max_dim = max(canvas_h, canvas_w)
    auto = max(1, int(math.ceil(math.log2(max(max_dim, 2)))) - 1)
    return max(max(5, cfg_bands), min(auto, 12))


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
            f"of {total >> 20} MiB free")


# Canvases above this pyramid footprint blend through tiles.
TILED_THRESHOLD_BYTES = 512 << 20
TILE = 4096
MAX_TILED_BANDS = 8  # the halo is 8 * 2^bands px
# Per-tile extended-window pyramid budget: the halo grows with 2^bands,
# so high band counts are lowered until the window's pyramid fits (the
# reference's canvas-size-adaptive degradation, stitch_global.cpp:
# 307-326).
TILE_PYR_BUDGET_BYTES = 640 << 20
# Extended-window dimension quantum (kept from the JAX package: it sets
# the window every frame is fed into, and a window's pyramid depends on
# its borders).
EXT_SNAP = 512


def _ext_dims(canvas_h: int, canvas_w: int, bands: int, tile: int):
    """(aligned tile, halo, ext_h, ext_w) shared by tiled_bands and
    mb_tile_grid."""
    g = 1 << bands
    halo = 8 << bands
    t = align_up(tile, g)
    ext_h = min(t + 2 * halo, align_up(canvas_h, max(g, EXT_SNAP)))
    ext_w = min(t + 2 * halo, align_up(canvas_w, max(g, EXT_SNAP)))
    return t, halo, ext_h, ext_w


def tiled_bands(canvas_h: int, canvas_w: int, bands: int,
                tile: Optional[int] = None) -> int:
    """Largest band count (at most ``MAX_TILED_BANDS``) whose per-tile
    extended-window pyramid fits ``TILE_PYR_BUDGET_BYTES``."""
    bands = min(bands, MAX_TILED_BANDS)
    tile = tile if tile is not None else TILE
    while bands > 1:
        _, _, ext_h, ext_w = _ext_dims(canvas_h, canvas_w, bands, tile)
        if pyramid_bytes(ext_h, ext_w, bands) <= TILE_PYR_BUDGET_BYTES:
            break
        bands -= 1
    return bands


Tile = Tuple[int, int, int, int, int, int, int, int]


def mb_tile_grid(canvas_h: int, canvas_w: int, bands: int,
                 tile: Optional[int] = None) -> Tuple[List[Tile], int]:
    """Tile decomposition of a canvas: (tiles, halo). Each tile is
    (core_y0, core_y1, core_x0, core_x1, ext_y0, ext_y1, ext_x0, ext_x1):
    the core is what the tile emits, the extended window (core + halo,
    one fixed size per canvas, shifted rather than clipped at the canvas
    edges) what its pyramid covers. The pyramid filters reach ~4 * 2^bands
    px at the coarsest level, inside the halo, so tiling is exact."""
    g = 1 << bands
    tile, halo, ext_h, ext_w = _ext_dims(canvas_h, canvas_w, bands,
                                         tile if tile is not None else TILE)
    ch = align_up(canvas_h, g)
    cw = align_up(canvas_w, g)
    tiles = []
    for cy0 in range(0, canvas_h, tile):
        cy1 = min(canvas_h, cy0 + tile)
        for cx0 in range(0, canvas_w, tile):
            cx1 = min(canvas_w, cx0 + tile)
            ey0 = min(max(0, align_down(cy0 - halo, g)), max(0, ch - ext_h))
            ex0 = min(max(0, align_down(cx0 - halo, g)), max(0, cw - ext_w))
            tiles.append((cy0, cy1, cx0, cx1, ey0, ey0 + ext_h,
                          ex0, ex0 + ext_w))
    return tiles, halo


def content_flags(img_u8: torch.Tensor):
    """Row and column "has content" flags of an (H, W, 3) uint8 BGR image:
    the fixed-point BT.601 gray (29 b + 150 g + 77 r + 128) >> 8 > 1, the
    reference's autocrop test (stitch_common.cpp:9)."""
    x = img_u8.to(torch.int32)
    gray = (29 * x[..., 0] + 150 * x[..., 1] + 77 * x[..., 2] + 128) >> 8
    content = gray > 1
    return content.any(dim=1), content.any(dim=0)


def _blend_core(canvas: MultiBandCanvas, ext_h: int, ext_w: int,
                core: Tuple[int, int, int, int],
                pack: Optional[Tuple[int, int, int, int]] = None):
    """Blend one tile's pyramid and crop its core (tile-local (y0, y1,
    x0, x1)): (uint8 core (h, w, 3), row flags (h,), column flags (w,)).
    ``pack``: a tile-local window (y0, x0, h, w) holding the core, h % 4
    == 0 and w % 2 == 0, returned as packed I420 in place of the core (the
    flags are still the core's, from its BGR pixels)."""
    img, _ = mb_blend(canvas, ext_h, ext_w)
    y0, y1, x0, x1 = core
    if pack is None:
        win = clip_u8(img[y0:y1, x0:x1])
        rows, cols = content_flags(win)
        return win, rows, cols
    py, px, ph, pw = pack
    win = clip_u8(img[py:py + ph, px:px + pw])
    rows, cols = content_flags(win[y0 - py:y1 - py, x0 - px:x1 - px])
    return bgr_to_yuv420(win), rows, cols


def _packed_window(core: Tuple[int, int, int, int], ext_h: int, ext_w: int):
    """The tile-local window the JAX package packs around a tile's core
    (ops/blend.py:466-474: the core's dims snapped up to 256 and kept in
    the ext window) as (y0, x0, h, w), or None where its dims break the
    I420 contract (h % 4, w % 2) and the core is fetched as BGR."""
    y0, y1, x0, x1 = core
    ph = min(align_up(y1 - y0, 256), ext_h)
    pw = min(align_up(x1 - x0, 256), ext_w)
    if ph % 4 or pw % 2:
        return None
    return min(y0, ext_h - ph), min(x0, ext_w - pw), ph, pw


def _bbox_from_flags(entries, canvas_h: int, canvas_w: int):
    """Exact content box (y0, y1, x0, x1) from per-tile core flags
    ``entries`` [(cy0, cx0, rows, cols)], read with one host copy; None
    when no tile has content."""
    if not entries:
        return None
    flat = torch.cat([f for e in entries for f in (e[2], e[3])]).cpu()
    flat = flat.numpy()
    box = [canvas_h, -1, canvas_w, -1]
    pos = 0
    for cy0, cx0, rows, cols in entries:
        ra = flat[pos:pos + rows.shape[0]]
        pos += rows.shape[0]
        ca = flat[pos:pos + cols.shape[0]]
        pos += cols.shape[0]
        if ra.any():
            box[0] = min(box[0], cy0 + int(np.argmax(ra)))
            box[1] = max(box[1], cy0 + len(ra) - int(np.argmax(ra[::-1])))
        if ca.any():
            box[2] = min(box[2], cx0 + int(np.argmax(ca)))
            box[3] = max(box[3], cx0 + len(ca) - int(np.argmax(ca[::-1])))
    has = box[1] > box[0] and box[3] > box[2]
    return tuple(box) if has else None


FeedTile = Callable[[MultiBandCanvas, int, int, int, int, int],
                    MultiBandCanvas]


def mb_compose_tiled(canvas_h: int, canvas_w: int, bands: int,
                     frame_boxes: Sequence[Tuple[float, float, float, float]],
                     feed_tile: FeedTile, device,
                     tile: Optional[int] = None, assemble: str = "host",
                     on_rows: Optional[Callable[[int, int, np.ndarray],
                                                None]] = None,
                     fetch_packed: bool = False):
    """Multiband blend streamed through canvas tiles.

    ``frame_boxes``: per-frame (x0, y0, x1, y1) canvas-space bounds;
    ``feed_tile(canvas_t, i, ey0, ex0, eh, ew) -> canvas_t`` feeds frame i
    into a tile canvas whose origin is (ex0, ey0). The band count is
    lowered by :func:`tiled_bands`.

    Returns ``(mosaic, bbox)``. ``assemble="host"``: the mosaic is the
    (canvas_h, canvas_w, 3) uint8 numpy array (one device-to-host copy of
    each tile's core); ``assemble="device"``: every blended core stays on
    ``device`` in a (CH, CW, 3) uint8 canvas with EXT_SNAP-snapped dims
    (content in [0, canvas_h) x [0, canvas_w), zeros beyond). ``bbox``:
    the exact autocrop box (y0, y1, x0, x1), exclusive ends, from the
    cores' device content flags (None when the canvas is empty).

    ``device``: one device, or (host assembly only; ops/blend.py:262-284
    of the JAX package) a list of N: tile t blends on ``device[t % N]``
    and at most N tiles are in flight, each tile's core fetched once N
    later tiles were queued; the tiles are independent (the halo makes
    tiling exact), so the mosaic does not depend on N.

    ``on_rows(y0, y1, rows)`` (host assembly only): called in increasing y
    once every tile of a tile row has landed (empty tiles included), with
    ``rows`` the finished ``mosaic[y0:y1]`` view, never written again; the
    caller streams the mosaic out while later tile rows still blend.

    ``fetch_packed`` (host assembly only): each tile leaves the device as
    the packed video-range I420 of the window the JAX package packs around
    its core (half the bytes of BGR) and is unpacked on the host with
    ``cv2.COLOR_YUV2BGR_I420``; the 4:2:0 chroma costs up to ~3 gray
    levels. A window whose dims break the I420 contract is fetched as BGR.

    Spans of the calling stage: each tile's enqueue (``mb_prepare``, the
    feeds and the blend) is a ``tile feed`` (``frames`` fed), each host
    fetch of a core with its unpack a ``tile fetch`` (``bytes``), each
    ``on_rows`` call a ``rows out``.
    """
    if assemble not in ("host", "device"):
        raise ValueError(f"assemble must be 'host' or 'device', got "
                         f"{assemble!r}")
    devices = placement(device)
    if assemble == "device" and (on_rows is not None or len(devices) > 1
                                 or fetch_packed):
        raise ValueError("assemble='device' supports neither on_rows, "
                         "fetch_packed nor a device list")
    log = get_logger()
    bands = tiled_bands(canvas_h, canvas_w, bands, tile)
    tiles, _ = mb_tile_grid(canvas_h, canvas_w, bands, tile)
    g = 1 << bands
    if assemble == "device":
        out = torch.zeros((align_up(canvas_h, max(g, EXT_SNAP)),
                           align_up(canvas_w, max(g, EXT_SNAP)), 3),
                          dtype=torch.uint8, device=devices[0])
    else:
        out = np.zeros((canvas_h, canvas_w, 3), np.uint8)
    flags = []
    # tiles come row-major, a fixed number per tile row
    left = {}
    for t in tiles:
        left[(t[0], t[1])] = left.get((t[0], t[1]), 0) + 1
    bands_y = sorted(left)
    next_band = 0
    pending = []        # blended tiles whose cores are not fetched yet

    def land(cy0, cy1, cx0, cx1, origin=None, win=None, rows=None,
             cols=None):
        """Place a tile's core; ``origin``: the canvas (y, x) of a packed
        window, which is unpacked on the host and cut to the core."""
        nonlocal next_band
        if win is not None:
            if assemble == "device":
                out[cy0:cy1, cx0:cx1] = win
            else:
                with log.span("tile fetch", bytes=win.numel()):
                    if origin is not None:
                        import cv2
                        oy, ox = origin
                        bgr = cv2.cvtColor(win.cpu().numpy(),
                                           cv2.COLOR_YUV2BGR_I420)
                        out[cy0:cy1, cx0:cx1] = bgr[cy0 - oy:cy1 - oy,
                                                    cx0 - ox:cx1 - ox]
                    else:
                        out[cy0:cy1, cx0:cx1] = win.cpu().numpy()
            flags.append((cy0, cx0, rows.to(devices[0]),
                          cols.to(devices[0])))
        left[(cy0, cy1)] -= 1
        while (on_rows is not None and next_band < len(bands_y)
               and left[bands_y[next_band]] == 0):
            y0, y1 = bands_y[next_band]
            with log.span("rows out"):
                on_rows(y0, y1, out[y0:y1])
            next_band += 1

    for t_idx, (cy0, cy1, cx0, cx1, ey0, ey1, ex0, ex1) in \
            enumerate(tiles):
        sel = [i for i, (fx0, fy0, fx1, fy1) in enumerate(frame_boxes)
               if not (fx1 <= ex0 or fx0 >= ex1 or fy1 <= ey0
                       or fy0 >= ey1)]
        if not sel:             # an empty tile's rows stay zero
            land(cy0, cy1, cx0, cx1)
            continue
        eh, ew = ey1 - ey0, ex1 - ex0
        with log.span("tile feed", frames=len(sel)):
            canvas_t = mb_prepare(eh, ew, bands,
                                  devices[t_idx % len(devices)])
            for i in sel:
                canvas_t = feed_tile(canvas_t, i, ey0, ex0, eh, ew)
            core = (cy0 - ey0, cy1 - ey0, cx0 - ex0, cx1 - ex0)
            pack = _packed_window(core, eh, ew) if fetch_packed else None
            origin = None if pack is None else (ey0 + pack[0],
                                                ex0 + pack[1])
            pending.append((cy0, cy1, cx0, cx1, origin) + _blend_core(
                canvas_t, eh, ew, core, pack))
            del canvas_t
        while len(pending) >= len(devices):
            land(*pending.pop(0))
    for entry in pending:
        land(*entry)
    return out, _bbox_from_flags(flags, canvas_h, canvas_w)


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


# --------------------------------------------------------------------------
# feather blend (the two-frame stitch, pipeline/pairwise.py)
# --------------------------------------------------------------------------

def border_feather_weight(h: int, w: int, sharpness: float = 0.04,
                          device=None) -> torch.Tensor:
    """Source-frame weight: distance to the frame border, saturating.

    OpenCV's FeatherBlender weights by the distance transform of the mask;
    for a full rectangle that is the distance to the nearest edge. The
    weight is warped with the frame, so it holds under any transform;
    ``sharpness`` is cv2's 1 / ramp width (0.04 -> a 25 px ramp)."""
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    d = torch.minimum(torch.minimum(ys + 1.0, h - ys),
                      torch.minimum(xs + 1.0, w - xs))
    return (d * sharpness).clamp(0.0, 1.0)


def feather_blend(images: Sequence[torch.Tensor],
                  weights: Sequence[torch.Tensor]):
    """Weighted-average blend of (H, W, 3) images by (H, W) weights in
    [0, 1]: (blended (H, W, 3), covered (H, W) bool)."""
    acc = torch.zeros_like(images[0])
    wsum = torch.zeros(images[0].shape[:2], dtype=torch.float32,
                       device=images[0].device)
    for img, w in zip(images, weights):
        acc = acc + img * w[..., None]
        wsum = wsum + w
    out = acc / wsum.clamp(min=1e-6)[..., None]
    covered = wsum > 1e-6
    return torch.where(covered[..., None], out,
                       torch.zeros((), device=out.device)), covered
