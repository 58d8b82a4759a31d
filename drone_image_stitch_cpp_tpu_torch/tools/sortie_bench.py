"""The sortie harness of the flagship benchmark, on PyTorch.

Counterpart of the JAX package's ``tools/sortie_bench.py``:

  * make_sortie(): render a boustrophedon sortie from a fractal ortho into
    the reference's layout (<root>/visible/minfull/*.jpg), with the
    ground-truth ortho crop cached alongside (``gt.npy``) and the same
    ``meta.json``, so the same arguments give the same folder;
  * run_ours(): one end-to-end ``app.run_stitch_application`` in this
    process, with ``--resume`` retries; returns (seconds, mosaic, rc);
  * gt_rmse(): mosaic vs ground-truth ortho crop, phase-aligned at reduced
    scale, blurred RMSE over the eroded shared region (the same cv2
    operations in the same order as the JAX harness); gt_rmse_rows() also
    gives the RMSE over row bands of the ground truth, such as each
    flight line's (line_rows()).

The C++ reference's build and run have no counterpart here: they need the
reference sources and an OpenCV 5 C++ build, which this repository does
not hold. cv2 writes the JPEGs and scores the mosaic, as in the JAX
harness; every function that needs it raises without it.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MARGIN = 16             # ortho border around the sortie footprint


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _cv2():
    try:
        import cv2
    except ImportError as err:
        raise RuntimeError(
            "the sortie harness needs cv2 (JPEG write, mosaic read and "
            f"the GT-RMSE's phase correlation): {err}") from err
    return cv2


# ---------------------------------------------------------------------------
# sortie generation
# ---------------------------------------------------------------------------

def make_sortie(root: str, rows: int, cols: int, frame_h: int, frame_w: int,
                overlap: float = 0.7, overlap_y: float = 0.35,
                seed: int = 11, jpeg_q: int = 92, device="cuda"):
    """Render <root>/visible/minfull/*.jpg + <root>/gt.npy; cached.

    Returns (input_root, gt_path): ``input_root`` is the folder whose
    visible/minfull the application consumes; ``gt.npy`` holds the uint8
    ground-truth ortho crop covering exactly the sortie footprint.
    ``device`` places the ortho's upsampling (``fractal_ortho``); the
    ortho itself is host float32 (4.6 GB at the flagship's 10 x 20 4K).
    """
    cv2 = _cv2()
    from ..utils.synthetic import fractal_ortho

    img_dir = os.path.join(root, "visible", "minfull")
    gt_path = os.path.join(root, "gt.npy")
    meta_path = os.path.join(root, "meta.json")
    meta = {"rows": rows, "cols": cols, "frame_h": frame_h,
            "frame_w": frame_w, "overlap": overlap, "overlap_y": overlap_y,
            "seed": seed, "jpeg_q": jpeg_q}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            if json.load(f) == meta and os.path.exists(gt_path):
                log(f"[sortie] cached: {img_dir}")
                return root, gt_path

    shutil.rmtree(img_dir, ignore_errors=True)
    os.makedirs(img_dir)
    step_x = int(frame_w * (1 - overlap))
    step_y = int(frame_h * (1 - overlap_y))
    oh = 2 * MARGIN + frame_h + (rows - 1) * step_y
    ow = 2 * MARGIN + frame_w + (cols - 1) * step_x
    log(f"[sortie] ortho {oh}x{ow}, {rows * cols} frames "
        f"{frame_h}x{frame_w}")
    ortho = fractal_ortho(oh, ow, seed=seed, device=device)
    jobs = []
    for row in range(rows):
        xs = range(cols) if row % 2 == 0 else range(cols - 1, -1, -1)
        for c in xs:
            jobs.append((len(jobs), MARGIN + row * step_y,
                         MARGIN + c * step_x))

    def write(job):
        k, y, x = job
        frame = ortho[y:y + frame_h, x:x + frame_w].astype(np.uint8)
        if not cv2.imwrite(os.path.join(img_dir, f"IMG{k:04d}_f{k:04d}.jpg"),
                           frame, [cv2.IMWRITE_JPEG_QUALITY, jpeg_q]):
            raise OSError(f"cv2.imwrite failed for frame {k} in {img_dir}")

    # cv2 encodes without the GIL: frames in parallel, same bytes
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(write, jobs))
    gt = ortho[MARGIN:MARGIN + frame_h + (rows - 1) * step_y,
               MARGIN:MARGIN + frame_w + (cols - 1) * step_x]
    np.save(gt_path, gt.astype(np.uint8))
    del ortho, gt
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return root, gt_path


# ---------------------------------------------------------------------------
# the application's run
# ---------------------------------------------------------------------------

def run_ours(input_root: str, out_root: str, device, retries: int = 0,
             ingest_fmt: str = "auto", fetch_packed: bool = False,
             seam_warp: str = "prescaled", seam_method: str = "graphcut"):
    """End-to-end run of the port; returns (seconds, mosaic, rc).

    ``device`` is the run's device (``cuda``, ``cuda:N``, ``cpu`` or a
    list; no default). ``retries``: re-attempts after a non-zero exit,
    resuming the global stage from the strip checkpoint (``--resume``) so
    completed strips are not re-stitched. Wall-clock accumulates across
    attempts. ``ingest_fmt`` / ``fetch_packed``: the run's
    ``RunConfig.ingest_fmt`` (the frame store's format: ``auto`` stores a
    4:2:0 JPEG folder packed I420 where the codec builds) and
    ``RunConfig.fetch_packed`` (the global tiles leave the card as packed
    I420), the JAX harness's ``TM_INGEST_FMT`` / ``TM_FETCH_PACKED``;
    ``seam_warp`` / ``seam_method``: ``RunConfig.seam_warp`` and
    ``RunConfig.seam_method`` (its ``TM_SEAM_WARP`` / ``TM_SEAM_METHOD``).
    """
    cv2 = _cv2()
    from ..app import RunConfig, run_stitch_application

    shutil.rmtree(out_root, ignore_errors=True)
    t0 = time.perf_counter()
    for attempt in range(retries + 1):
        cfg = RunConfig(image_folder=input_root, image_type="visible",
                        group="minfull", output_root=out_root,
                        device=device, resume=attempt > 0,
                        ingest_fmt=ingest_fmt, fetch_packed=fetch_packed,
                        seam_warp=seam_warp, seam_method=seam_method)
        rc = run_stitch_application(cfg)
        if rc == 0:
            break
        if attempt < retries:
            log(f"[ours] rc={rc}; retrying with --resume "
                f"({attempt + 1}/{retries})")
    secs = time.perf_counter() - t0
    mosaic = cv2.imread(cfg.output_path, cv2.IMREAD_COLOR) \
        if os.path.exists(cfg.output_path) else None
    return secs, mosaic, rc


# ---------------------------------------------------------------------------
# ground-truth RMSE
# ---------------------------------------------------------------------------

def line_rows(meta: dict):
    """[(y0, y1)] per flight line: the ground-truth rows its planted
    frames cover (``meta``: :func:`make_sortie`'s ``meta.json``)."""
    step_y = int(meta["frame_h"] * (1 - meta["overlap_y"]))
    return [(k * step_y, k * step_y + meta["frame_h"])
            for k in range(meta["rows"])]


def gt_rmse(mosaic: np.ndarray, gt: np.ndarray, max_dim: int = 4000):
    """Blurred RMSE between a mosaic and the ground-truth ortho crop.

    Phase-correlates gray downscales to absorb the global translation a
    stitcher is free to choose, shifts the mosaic, and computes RMSE after
    a mild blur (subpixel-resampling tolerant) over the common region.
    Returns (rmse, dx, dy).
    """
    return gt_rmse_rows(mosaic, gt, max_dim)[:3]


def gt_rmse_rows(mosaic: np.ndarray, gt: np.ndarray, max_dim: int = 4000,
                 rows=()):
    """:func:`gt_rmse` and the same RMSE over each (y0, y1) band of ground-
    truth rows in ``rows`` (the shifted mosaic and the ground truth
    restricted to those rows; inf where the band holds under 1000 common
    pixels): (rmse, dx, dy, [band rmse])."""
    cv2 = _cv2()

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
    sel = valid.astype(bool)

    def rmse(d, m):
        return float(np.sqrt(d[m].mean())) if m.sum() >= 1000 \
            else float("inf")

    return (rmse(diff, sel), fdx, fdy,
            [rmse(diff[y0:y1], sel[y0:y1]) for y0, y1 in rows])
