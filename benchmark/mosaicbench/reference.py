"""The plain reference that decides ``correct``: the planted truth.

The benchmark makes every input from the seed (``render.py``), so it
knows what a right answer is without the program: the ground-truth ortho
a sortie was cut from, the flight lines it was flown in, and the
translation planted between two triage frames. This module holds the
program's outputs against that truth. It imports nothing of the program
and takes nothing the program made but the outputs it judges.

Each number compared is reported with its limit (``limits/<cell>.json``);
a run is correct when every number is at or under its limit, and no unit
of work failed.
"""

from __future__ import annotations

import numpy as np
import torch

from .score import score_image


def compare(numbers: dict, limits: dict):
    """(every number within its limit, {name: {"value", "limit"}}) in the
    order of ``limits``; a number without a limit is an error in the
    cell's files, a limit without a number a fault of the run (it reads
    inf)."""
    extra = set(numbers) - set(limits)
    if extra:
        raise KeyError(f"numbers without a limit: {sorted(extra)}")
    vals = {k: float(numbers.get(k, float("inf"))) for k in limits}
    ok = all(vals[k] <= lim for k, lim in limits.items())
    # a reading that is no finite number is no reading: null in the line
    return ok, {k: {"value": vals[k] if np.isfinite(vals[k]) else None,
                    "limit": lim} for k, lim in limits.items()}


# ---------------------------------------------------------------------------
# sorties
# ---------------------------------------------------------------------------

def sortie_numbers(mosaic, strips, gt, lines, frame_h, step_y, step_x,
                   max_dim):
    """What the check compares of one sortie's outputs: the mosaic
    (``mosaic_*``: :func:`score.score_image` against the whole ground
    truth) and, where the run wrote the lossless strip checkpoint
    (``strips`` not None), the count of strips against the planted
    ``lines`` (``lines_off``) and each strip against the ground-truth rows
    of its flight line (``strip_*``, the worst strip)."""
    block = (step_y, step_x)
    out = {}
    if mosaic is None:
        return {"mosaic_rmse": float("inf")}
    for k, v in score_image(mosaic, gt, block, max_dim).items():
        if k != "shift":
            out[f"mosaic_{k}"] = v
    if strips is not None:
        out["lines_off"] = abs(len(strips) - lines)
        worst = {}
        for i, s in enumerate(strips[:lines]):
            band = gt[i * step_y:i * step_y + frame_h]
            for k, v in score_image(s, band, block, max_dim).items():
                if k != "shift":
                    worst[k] = max(worst.get(k, v), v)
        for k, v in worst.items():
            out[f"strip_{k}"] = v
    return out


def worst_of(numbers_list):
    """The worst reading of each number over several outputs."""
    out: dict = {}
    for nums in numbers_list:
        for k, v in nums.items():
            out[k] = max(out.get(k, v), v)
    return out


# ---------------------------------------------------------------------------
# triage
# ---------------------------------------------------------------------------

def planted_model(frame_h, frame_w, work_h, work_w, step_y, step_x):
    """The (3, 3) work-resolution model of every pair (frame i -> frame
    i + 1): frame i + 1 lies ``step_y`` px lower and ``step_x`` px further
    right, so a point moves by (-step_x, -step_y) full-resolution px,
    scaled to the work size the frames were resized to."""
    m = np.eye(3)
    m[0, 2] = -step_x * work_w / frame_w
    m[1, 2] = -step_y * work_h / frame_h
    return m


def model_error_px(models, planted, work_h, work_w) -> float:
    """The largest distance, in work px, between where a pair's model and
    the planted model send a corner of the work frame, over the pairs."""
    corners = np.array([[0, 0, 1], [work_w, 0, 1], [0, work_h, 1],
                        [work_w, work_h, 1]], np.float64).T
    worst = 0.0
    for m in np.asarray(models, np.float64):
        p, q = m @ corners, planted @ corners
        d = p[:2] / p[2] - q[:2] / q[2]
        worst = max(worst, float(np.sqrt((d * d).sum(axis=0)).max()))
    return worst


def warp_plane(frame: torch.Tensor, a23, out_h: int, out_w: int,
               dtype=torch.float64, store=None) -> torch.Tensor:
    """Bilinear warp of one (H, W) plane by the src->dst affine ``a23``
    (inverted in float64), each tap outside the plane reading 0, computed
    in ``dtype``; ``store`` rounds the plane and the result to a storage
    type (the lower-precision control)."""
    dev = frame.device
    m = np.vstack([np.asarray(a23, np.float64).reshape(2, 3), [0, 0, 1]])
    inv = torch.tensor(np.linalg.inv(m)[:2], dtype=dtype, device=dev)
    img = frame if store is None else frame.to(store)
    img = img.to(dtype)
    h, w = img.shape
    xs = torch.arange(out_w, dtype=dtype, device=dev)[None, :]
    out = torch.empty((out_h, out_w), dtype=dtype, device=dev)
    for y0 in range(0, out_h, 540):
        ys = torch.arange(y0, min(out_h, y0 + 540), dtype=dtype,
                          device=dev)[:, None]
        sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
        sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
        x0, y0f = torch.floor(sx), torch.floor(sy)
        fx, fy = sx - x0, sy - y0f
        xi, yi = x0.long(), y0f.long()

        def tap(dy, dx):
            yy, xx = yi + dy, xi + dx
            inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            v = img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
            return torch.where(inb, v, torch.zeros((), dtype=dtype,
                                                   device=dev))

        top = tap(0, 0) * (1 - fx) + tap(0, 1) * fx
        bot = tap(1, 0) * (1 - fx) + tap(1, 1) * fx
        out[y0:y0 + ys.shape[0]] = top * (1 - fy) + bot * fy
    if store is not None:
        out = out.to(store).to(dtype)
    return out


def reference_sums(frames: torch.Tensor, models) -> np.ndarray:
    """Frames 1.. of a (N, H, W) batch warped at full size by the pairs'
    models (their top two rows), each summed, in float64."""
    h, w = frames.shape[1:]
    return np.array([float(warp_plane(frames[i + 1], m[:2], h, w).sum())
                     for i, m in enumerate(np.asarray(models))])


def triage_numbers(frames, models, sums, planted, work_hw) -> dict:
    """What the check compares of one batch's outputs: ``model_px`` (the
    worst pair's model against the planted one, work px) and ``sum_rel``
    (the worst relative gap of a pair's warp sum from the reference's
    float64 warp of the same frame by the same model)."""
    ref = reference_sums(frames, models)
    rel = np.abs(np.asarray(sums, np.float64) - ref) / np.abs(ref)
    return {"model_px": model_error_px(models, planted, *work_hw),
            "sum_rel": float(rel.max())}
