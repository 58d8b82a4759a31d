"""Synthetic sorties with exact ground truth, without OpenCV.

Counterpart of ``drone_image_stitch_cpp_tpu/utils/synthetic.py`` for
machines that have numpy and torch but no cv2: ``fractal_ortho`` upsamples
its noise octaves with torch's bicubic interpolation (the same a = -0.75
Keys kernel with half-pixel centres as cv2.INTER_CUBIC),
``synthetic_ortho`` is the JAX package's textured ortho (numpy and scipy,
byte-equal), ``render_sortie`` is the JAX package's crop renderer, and
``gt_rmse`` scores a panorama
against the ortho after a 9-tap sigma-2 Gaussian with REFLECT_101
borders (cv2.GaussianBlur((9, 9), 2.0)).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.gaussian import gaussian_blur


def fractal_ortho(h: int, w: int, seed: int = 0,
                  device: torch.device | str = "cpu") -> np.ndarray:
    """Aperiodic multi-octave value-noise 'terrain' ortho (uint8-range
    float32 (h, w, 3)) with sharp rectangles at SIFT scales. ``device``
    only places the upsampling work. The image is built in place, with at
    most one channel's temporary beside it on the host (the flagship's
    14828x25760 ortho is 4.6 GB)."""
    r = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    for cell in (512, 128, 32, 8):
        gh = -(-h // cell) + 1
        gw = -(-w // cell) + 1
        amp = 90.0 * (cell / 512.0) ** 0.6
        grid = r.normal(0, 1.0, (gh, gw, 3)).astype(np.float32)
        g = torch.from_numpy(grid).permute(2, 0, 1)[None].to(device)
        up = F.interpolate(g, size=(gh * cell, gw * cell), mode="bicubic",
                           align_corners=False)[0, :, :h, :w]
        for c in range(3):      # one channel's temporary at a time
            uc = up[c].cpu().numpy()
            uc *= amp
            img[..., c] += uc
            del uc
        del up
    img *= 0.55
    img += 118.0
    for _ in range(max(600, h * w // 1300)):
        cy, cx = int(r.integers(0, h)), int(r.integers(0, w))
        rh_, rw_ = int(r.integers(3, 16)), int(r.integers(3, 16))
        col = r.uniform(0, 255, 3).astype(np.float32)
        y0, y1 = max(0, cy - rh_), min(h, cy + rh_)
        x0, x1 = max(0, cx - rw_), min(w, cx + rw_)
        img[y0:y1, x0:x1] = 0.35 * img[y0:y1, x0:x1] + 0.65 * col
    for y in range(0, h, 512):  # the same draws as one call, in row bands
        img[y:y + 512] += r.normal(0, 3.0, (min(512, h - y), w, 3)).astype(
            np.float32)
    return np.clip(img, 0, 255, out=img)


def synthetic_ortho(h=768, w=1024, seed=0):
    """A textured 'ground truth ortho' image with structure at many scales
    (uint8-range float32 (h, w, 3)): the JAX package's generator, numpy
    and scipy only, so the same seed gives the same bytes. The throughput
    benchmark crops its frames from it (``tools/bench_throughput``). Its
    sin/cos base is periodic (~230 px): use :func:`fractal_ortho` for
    sorties. Raises ImportError without scipy, whose band-limited texture
    is part of the image."""
    from scipy.ndimage import gaussian_filter

    r = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    # low-frequency base
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for c in range(3):
        img[..., c] = (
            96 + 60 * np.sin(xx / (37 + 11 * c)) * np.cos(yy / (29 + 7 * c)))
    # mid-frequency blobs
    for _ in range(400):
        cy, cx = r.integers(0, h), r.integers(0, w)
        rad = int(r.integers(4, 24))
        col = r.uniform(0, 255, 3).astype(np.float32)
        y0, y1 = max(0, cy - rad), min(h, cy + rad)
        x0, x1 = max(0, cx - rad), min(w, cx + rad)
        py, px = np.mgrid[y0:y1, x0:x1]
        m = ((py - cy) ** 2 + (px - cx) ** 2) <= rad * rad
        img[y0:y1, x0:x1][m] = 0.5 * img[y0:y1, x0:x1][m] + 0.5 * col
    # sharp-cornered rectangles: strong DoG extrema at SIFT scales
    for _ in range(600):
        cy, cx = int(r.integers(0, h)), int(r.integers(0, w))
        rh_, rw_ = int(r.integers(3, 14)), int(r.integers(3, 14))
        col = r.uniform(0, 255, 3).astype(np.float32)
        y0, y1 = max(0, cy - rh_), min(h, cy + rh_)
        x0, x1 = max(0, cx - rw_), min(w, cx + rw_)
        img[y0:y1, x0:x1] = 0.35 * img[y0:y1, x0:x1] + 0.65 * col
    # band-limited texture that survives sigma~1.6 blur
    bl = gaussian_filter(r.normal(0, 1.0, (h, w)), 2.5) * 55.0
    img += bl[..., None].astype(np.float32)
    img += r.normal(0, 4.0, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.float32)


def render_sortie(ortho, rows, cols, frame_h=160, frame_w=208,
                  overlap=0.5, y0=40, x0=40, jitter=0, seed=7,
                  overlap_y=None):
    """Boustrophedon sortie: crops of the ortho with known positions.

    Returns (images uint8, ids, positions [(y, x)] in ortho coords). Even
    rows left->right, odd rows right->left.
    """
    r = np.random.default_rng(seed)
    if overlap_y is None:
        overlap_y = overlap
    step_x = int(frame_w * (1 - overlap))
    step_y = int(frame_h * (1 - overlap_y))
    images, ids, pos = [], [], []
    k = 0
    for row in range(rows):
        xs = list(range(cols))
        if row % 2 == 1:
            xs = xs[::-1]
        for c in xs:
            y = y0 + row * step_y
            x = x0 + c * step_x
            if jitter:
                y += int(r.integers(-jitter, jitter + 1))
                x += int(r.integers(-jitter, jitter + 1))
            images.append(ortho[y:y + frame_h, x:x + frame_w].astype(
                np.uint8))
            ids.append(f"IMG{k:03d}")
            pos.append((y, x))
            k += 1
    return images, ids, pos


def _blur9(a: torch.Tensor) -> torch.Tensor:
    return gaussian_blur(a.to(torch.float32), 2.0, radius=4,
                         channels_last=True)


def gt_rmse(pano: np.ndarray, gt: np.ndarray, search: int = 6,
            device: torch.device | str = "cpu"):
    """Blurred RMSE of a panorama against its ground-truth ortho crop.

    A stitcher may place the mosaic a few pixels off the crop origin
    (integer canvas origin, autocrop), so the best integer shift within
    +-``search`` px is found on gray means first. Returns (rmse, dy, dx):
    pano[y, x] is compared with gt[y + dy, x + dx] over the common region
    less a 9-px margin.
    """
    p = torch.from_numpy(np.ascontiguousarray(pano)).to(device).float()
    g = torch.from_numpy(np.ascontiguousarray(gt)).to(device).float()
    pg, gg = p.mean(dim=-1), g.mean(dim=-1)
    best = None
    for dy in range(-search, search + 1):
        for dx in range(-search, search + 1):
            py0, gy0 = max(0, -dy), max(0, dy)
            px0, gx0 = max(0, -dx), max(0, dx)
            hh = min(pg.shape[0] - py0, gg.shape[0] - gy0)
            ww = min(pg.shape[1] - px0, gg.shape[1] - gx0)
            if hh < 64 or ww < 64:
                continue
            d = (pg[py0:py0 + hh:4, px0:px0 + ww:4]
                 - gg[gy0:gy0 + hh:4, gx0:gx0 + ww:4])
            e = float((d * d).mean())
            if best is None or e < best[0]:
                best = (e, dy, dx)
    if best is None:
        return float("inf"), 0, 0
    _, dy, dx = best
    py0, gy0 = max(0, -dy), max(0, dy)
    px0, gx0 = max(0, -dx), max(0, dx)
    hh = min(p.shape[0] - py0, g.shape[0] - gy0)
    ww = min(p.shape[1] - px0, g.shape[1] - gx0)
    pb = _blur9(p[py0:py0 + hh, px0:px0 + ww])
    gb = _blur9(g[gy0:gy0 + hh, gx0:gx0 + ww])
    m = 9
    diff = (pb - gb)[m:hh - m, m:ww - m]
    return float(torch.sqrt((diff ** 2).mean())), dy, dx
