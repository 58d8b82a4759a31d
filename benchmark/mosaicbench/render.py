"""The benchmark's inputs, made from the seed: sorties and triage batches.

Frozen copies, taken at commit 8b7ff0e672e454ed1a7cdb8444acc84ca8d92c55:

* :func:`fractal_ortho` of ``drone_image_stitch_cpp_tpu_torch/utils/
  synthetic.py``, split at its last layer (the sensor noise) so that
  :func:`render_sortie` can keep the terrain under it in a cache;
* :func:`synthetic_ortho` of the same file (verbatim);
* :func:`render_sortie`: the layout, file names and JPEG write of
  ``make_sortie`` in ``drone_image_stitch_cpp_tpu_torch/tools/
  sortie_bench.py``, without its ``meta.json`` cache and ``gt.npy`` (the
  ground truth stays in memory);
* :func:`make_batches`: ``make_frames`` of ``drone_image_stitch_cpp_tpu_
  torch/tools/bench_throughput.py``, with distinct batches cut from one
  larger ortho (one batch with no offsets is ``make_frames`` byte for
  byte).

``tests/test_bench_frozen.py`` holds each against the program's current
one, so a drift on either side shows. Nothing here imports the program.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

MARGIN = 16             # ortho border around the sortie footprint


def fractal_ortho(h: int, w: int, seed: int = 0,
                  device: torch.device | str = "cpu",
                  noise_seed: int | None = None) -> np.ndarray:
    """Aperiodic multi-octave value-noise 'terrain' ortho (uint8-range
    float32 (h, w, 3)) with sharp rectangles at SIFT scales. ``device``
    only places the upsampling work. ``noise_seed`` (not in the
    program's copy) draws the last layer, the per-pixel sensor noise,
    from a generator of its own: one terrain, another noise."""
    img, r = _terrain(h, w, seed, device)
    if noise_seed is not None:
        r = np.random.default_rng(noise_seed)
    return _add_noise(img, r)


def _terrain(h, w, seed, device):
    """fractal_ortho's layers under its sensor noise: (the float32 image,
    the generator as the noise finds it)."""
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
    return img, r


def _add_noise(img, r):
    """fractal_ortho's last layer, N(0, 3) a pixel from ``r``, then the
    clip to [0, 255], in place."""
    h, w = img.shape[:2]
    for y in range(0, h, 512):  # the same draws as one call, in row bands
        img[y:y + 512] += r.normal(0, 3.0, (min(512, h - y), w, 3)).astype(
            np.float32)
    return np.clip(img, 0, 255, out=img)


def cached_terrain(h, w, seed, device, cache_dir):
    """:func:`_terrain`'s image, kept in ``cache_dir`` as
    ``terrain-<h>x<w>-seed<seed>-<device type>.npy``: made and written by
    the first call, read by every later one (the same bytes)."""
    path = os.path.join(cache_dir, f"terrain-{h}x{w}-seed{seed}-"
                        f"{torch.device(device).type}.npy")
    if os.path.exists(path):
        return np.load(path)
    img, _ = _terrain(h, w, seed, device)
    os.makedirs(cache_dir, exist_ok=True)
    part = f"{path}.{os.getpid()}.part"
    with open(part, "wb") as f:
        np.save(f, img)
    os.replace(part, path)
    return img


def synthetic_ortho(h=768, w=1024, seed=0):
    """A textured 'ground truth ortho' (uint8-range float32 (h, w, 3)):
    numpy and scipy only, so the same seed gives the same bytes."""
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


# ---------------------------------------------------------------------------
# sorties
# ---------------------------------------------------------------------------

def sortie_layout(rows, cols, frame_h, frame_w, overlap=0.7,
                  overlap_y=0.35):
    """(step_y, step_x, gt_h, gt_w, [(y, x)] per frame in flight order):
    a boustrophedon over the ground truth, even lines left to right, odd
    lines right to left; (y, x) is a frame's corner in ground-truth
    coordinates."""
    step_x = int(frame_w * (1 - overlap))
    step_y = int(frame_h * (1 - overlap_y))
    pos = []
    for row in range(rows):
        xs = range(cols) if row % 2 == 0 else range(cols - 1, -1, -1)
        pos.extend((row * step_y, c * step_x) for c in xs)
    return (step_y, step_x, frame_h + (rows - 1) * step_y,
            frame_w + (cols - 1) * step_x, pos)


def _imwrite(path, img, jpeg_q):
    import cv2
    if not cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, jpeg_q]):
        raise OSError(f"cv2.imwrite failed for {path}")


def render_sortie(img_dir: str, rows: int, cols: int, frame_h: int,
                  frame_w: int, overlap: float = 0.7,
                  overlap_y: float = 0.35, seed: int = 11, jpeg_q: int = 92,
                  device="cuda", noise_seed: int | None = None,
                  cache_dir: str | None = None) -> np.ndarray:
    """Write the sortie's frames as ``img_dir/IMG<k>_f<k>.jpg`` (k in
    flight order, JPEG at ``jpeg_q``, cv2's default 4:2:0) and return the
    uint8 ground-truth ortho crop that covers exactly its footprint.
    ``seed`` draws the terrain and ``noise_seed`` its sensor noise
    (:func:`fractal_ortho`); with both ``noise_seed`` and ``cache_dir``,
    the terrain is read from the cache (:func:`cached_terrain`)."""
    _, _, gt_h, gt_w, pos = sortie_layout(rows, cols, frame_h, frame_w,
                                          overlap, overlap_y)
    os.makedirs(img_dir, exist_ok=True)
    oh, ow = gt_h + 2 * MARGIN, gt_w + 2 * MARGIN
    if noise_seed is not None and cache_dir is not None:
        ortho = _add_noise(cached_terrain(oh, ow, seed, device, cache_dir),
                           np.random.default_rng(noise_seed))
    else:
        ortho = fractal_ortho(oh, ow, seed=seed, device=device,
                              noise_seed=noise_seed)

    def write(job):
        k, (y, x) = job
        frame = ortho[MARGIN + y:MARGIN + y + frame_h,
                      MARGIN + x:MARGIN + x + frame_w].astype(np.uint8)
        _imwrite(os.path.join(img_dir, f"IMG{k:04d}_f{k:04d}.jpg"), frame,
                 jpeg_q)

    # cv2 encodes without the GIL: frames in parallel, same bytes
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(write, enumerate(pos)))
    gt = ortho[MARGIN:MARGIN + gt_h, MARGIN:MARGIN + gt_w].astype(np.uint8)
    del ortho
    return gt


# ---------------------------------------------------------------------------
# triage batches
# ---------------------------------------------------------------------------

def make_batches(n_batches=1, n_frames=8, frame_h=2160, frame_w=3840,
                 step_y=64, step_x=256, batch_dy=0, batch_dx=0, seed=3):
    """``n_batches`` batches of ``n_frames`` gray float32 (frame_h,
    frame_w) crops of one ``synthetic_ortho``: in each batch frame i + 1
    lies ``step_y`` px lower and ``step_x`` px further right than frame i,
    and batch b starts ``b * batch_dy``, ``b * batch_dx`` px in.
    (n_batches, n_frames, frame_h, frame_w) float32."""
    big = synthetic_ortho(
        h=frame_h + step_y * n_frames + batch_dy * (n_batches - 1),
        w=frame_w + step_x * n_frames + batch_dx * (n_batches - 1),
        seed=seed)
    gray = (0.114 * big[..., 0] + 0.587 * big[..., 1]
            + 0.299 * big[..., 2]).astype(np.float32)
    del big
    out = np.empty((n_batches, n_frames, frame_h, frame_w), np.float32)
    for b in range(n_batches):
        for i in range(n_frames):
            y, x = b * batch_dy + step_y * i, b * batch_dx + step_x * i
            out[b, i] = gray[y:y + frame_h, x:x + frame_w]
    return out
