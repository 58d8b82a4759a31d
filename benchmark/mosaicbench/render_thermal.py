"""The plain reference of the ``lwir-640`` configuration: a thermal
sortie and its planted ground truth, made from the seed.

The truth is the seeded terrain of :func:`render.cached_terrain` seen by
a long-wave infrared core: its luma (0.114 B + 0.587 G + 0.299 R),
blurred by a Gaussian of sigma 1.0 px (the optics and the 12 um pitch),
its contrast scaled by 0.6 about its mean, on three equal channels (a
white-hot palette). Each frame is a crop of that truth plus sensor noise
of sigma 2.0 DN drawn from ``--seed`` (one generator a frame, so frames
render in parallel to the same bytes), written as a JPEG in flight order
under the names :func:`render.render_sortie` gives.

The layout is :func:`render.sortie_layout`'s boustrophedon with the
steps rounded to the nearest pixel, so 90% of a 640 px side is a 64 px
step. numpy, torch and cv2 only: nothing of the program, nothing of JAX.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .render import _imwrite, cached_terrain

LUMA = (0.114, 0.587, 0.299)    # weights of B, G, R
BLUR_SIGMA = 1.0
CONTRAST = 0.6
NOISE_SIGMA = 2.0


def thermal_layout(rows, cols, frame_h, frame_w, overlap, overlap_y):
    """(step_y, step_x, gt_h, gt_w, [(y, x)] per frame in flight order):
    even lines left to right, odd lines right to left, each step the
    frame's side times one less the overlap, rounded to a pixel."""
    step_x = int(round(frame_w * (1 - overlap)))
    step_y = int(round(frame_h * (1 - overlap_y)))
    pos = []
    for row in range(rows):
        xs = range(cols) if row % 2 == 0 else range(cols - 1, -1, -1)
        pos.extend((row * step_y, c * step_x) for c in xs)
    return (step_y, step_x, frame_h + (rows - 1) * step_y,
            frame_w + (cols - 1) * step_x, pos)


def thermal_truth(terrain: np.ndarray) -> np.ndarray:
    """The float32 (h, w) thermal radiance of a float32 (h, w, 3) BGR
    terrain: luma, blurred, contrast scaled about its mean, unclipped."""
    import cv2
    luma = (LUMA[0] * terrain[..., 0] + LUMA[1] * terrain[..., 1]
            + LUMA[2] * terrain[..., 2]).astype(np.float32)
    luma = cv2.GaussianBlur(luma, (0, 0), BLUR_SIGMA)
    mean = float(luma.mean(dtype=np.float64))
    return (mean + CONTRAST * (luma - mean)).astype(np.float32)


def to_u8(gray: np.ndarray) -> np.ndarray:
    """A float (h, w) plane rounded and clipped to uint8, on three equal
    channels."""
    g = np.clip(np.rint(gray), 0, 255).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=2)


def thermal_frame(truth: np.ndarray, y: int, x: int, frame_h: int,
                  frame_w: int, rng=None) -> np.ndarray:
    """One (frame_h, frame_w, 3) uint8 frame: the truth's crop at (y, x)
    plus N(0, NOISE_SIGMA) a pixel from ``rng`` (none without one)."""
    crop = truth[y:y + frame_h, x:x + frame_w]
    if rng is not None:
        crop = crop + NOISE_SIGMA * rng.standard_normal(crop.shape,
                                                        dtype=np.float32)
    return to_u8(crop)


def render_thermal(img_dir: str, rows: int, cols: int, frame_h: int,
                   frame_w: int, overlap: float, overlap_y: float,
                   seed: int, noise_seed: int, cache_dir: str,
                   jpeg_q: int = 92, device="cuda") -> np.ndarray:
    """Write the thermal sortie's frames as ``img_dir/IMG<k>_f<k>.jpg``
    (k in flight order, JPEG at ``jpeg_q``, cv2's default 4:2:0) and
    return the uint8 (gt_h, gt_w, 3) planted truth that covers exactly its
    footprint. ``seed`` draws the terrain (kept in ``cache_dir``,
    :func:`render.cached_terrain`), ``noise_seed`` the frames' sensor
    noise."""
    _, _, gt_h, gt_w, pos = thermal_layout(rows, cols, frame_h, frame_w,
                                           overlap, overlap_y)
    os.makedirs(img_dir, exist_ok=True)
    truth = thermal_truth(cached_terrain(gt_h, gt_w, seed, device,
                                         cache_dir))

    def write(job):
        k, (y, x) = job
        rng = np.random.default_rng([noise_seed, k])
        _imwrite(os.path.join(img_dir, f"IMG{k:04d}_f{k:04d}.jpg"),
                 thermal_frame(truth, y, x, frame_h, frame_w, rng), jpeg_q)

    # cv2 encodes without the GIL: frames in parallel, same bytes
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(write, enumerate(pos)))
    return to_u8(truth)
