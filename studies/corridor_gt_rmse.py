"""Why the corridor's GT-RMSE moves with the bundle adjust's precision.

    python studies/corridor_gt_rmse.py      # on a CUDA card, about 1 min

The corridor is ``chip_smoke.py``'s: 12 frames of 2160x3840 cut from the
seeded 2300x16640 ``fractal_ortho`` at 0.70 overlap. The script stitches
it once with ``app.stitch_frames`` on the card and keeps the inputs of
the strip's bundle adjust (pairs, matched points, weights, chain init).
It then solves that one system several ways: float64 and float32, on the
card and on the CPU (1 and 8 threads), with the pairs in their order and
reversed; and it takes the planted transforms as a last variant. Every
variant's transforms are composed with ``pipeline/strip.compose_strip``
(the app's strip knobs) and printed with:

- each frame's offset error at its origin (the smoke's check), px;
- each frame's mean displacement over its area, |T_k(p) - (p + planted
  offset)| on a 9 x 16 grid, px (the linear part included);
- the panorama's GT-RMSE (``utils/synthetic.gt_rmse``, the smoke's
  measure) and the same blurred RMSE in 1152-px column bands (one frame
  step each), and the K2 launches of the compose.

A study script, kept to reproduce the finding in PERF.md section 6; no
test runs it.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def area_displacement(t, off, h, w):
    """Mean |T(p) - (p + off)| over a 9 x 16 grid of the frame, px."""
    ys, xs = np.meshgrid(np.linspace(0, h - 1, 9), np.linspace(0, w - 1, 16),
                         indexing="ij")
    p = np.stack([xs.ravel(), ys.ravel()], -1)
    q = p @ np.asarray(t[:, :2], np.float64).T + np.asarray(t[:, 2],
                                                            np.float64)
    return float(np.linalg.norm(q - (p + off), axis=1).mean())


def band_rmse(torch, pano, gt, dy, dx, band, dev):
    """The blurred RMSE of gt_rmse at the shift (dy, dx), in column bands
    of ``band`` gt pixels."""
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import _blur9
    p = torch.from_numpy(np.ascontiguousarray(pano)).to(dev).float()
    g = torch.from_numpy(np.ascontiguousarray(gt)).to(dev).float()
    py0, gy0 = max(0, -dy), max(0, dy)
    px0, gx0 = max(0, -dx), max(0, dx)
    hh = min(p.shape[0] - py0, g.shape[0] - gy0)
    ww = min(p.shape[1] - px0, g.shape[1] - gx0)
    m = 9
    d = (_blur9(p[py0:py0 + hh, px0:px0 + ww])
         - _blur9(g[gy0:gy0 + hh, gx0:gx0 + ww]))[m:hh - m, m:ww - m]
    d2 = (d * d).mean(dim=(0, 2)).cpu().numpy()      # per column
    cols = np.arange(d2.shape[0]) + m + gx0          # gt column
    return [round(float(np.sqrt(d2[(cols >= b) & (cols < b + band)].mean())),
                  4) for b in range(0, int(cols[-1]) + 1, band)
            if ((cols >= b) & (cols < b + band)).any()]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[gt] FAIL: no CUDA card", flush=True)
        return 1
    import chip_smoke as S
    from drone_image_stitch_cpp_tpu_torch import app as A
    from drone_image_stitch_cpp_tpu_torch.config.tuning import (
        load_stitch_tuning)
    from drone_image_stitch_cpp_tpu_torch.ops.crop import (
        auto_crop_black_border)
    from drone_image_stitch_cpp_tpu_torch.pipeline import bundle as TB
    from drone_image_stitch_cpp_tpu_torch.pipeline import strip as TS
    from drone_image_stitch_cpp_tpu_torch.runtime.feed import FrameStore
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

    dev = torch.device("cuda", 0)
    get_logger().verbose = False
    print(S.phase_environment(torch), flush=True)
    tuning = load_stitch_tuning("visible")
    ortho, imgs, ids, pos = S.render_sortie(torch, dev)
    n, h, w = len(imgs), S.FRAME_H, S.FRAME_W
    step = pos[1][1] - pos[0][1]
    planted = np.asarray([(x - pos[0][1], y - pos[0][0]) for y, x in pos],
                         np.float64)
    gt_w = w + (n - 1) * step
    y0, x0 = pos[0]
    gt = np.clip(ortho[y0:y0 + h, x0:x0 + gt_w], 0, 255).astype(np.uint8)

    A.stitch_frames(imgs, ids, tuning, dev)            # warm-up
    seen = []
    real = TS.bundle_adjust_similarity

    def keep(*args, **kw):
        seen.append(tuple(a.clone() for a in args))
        return real(*args, **kw)

    TS.bundle_adjust_similarity = keep
    try:
        res = A.stitch_frames(imgs, ids, tuning, dev)
    finally:
        TS.bundle_adjust_similarity = real
    if len(seen) != 1 or res.kept != list(range(n)):
        print(f"[gt] FAIL: {len(seen)} bundle adjusts, kept {res.kept}",
              flush=True)
        return 1
    rmse_app, dy_app, dx_app = gt_rmse(res.panorama, gt, device=dev)
    print(f"[gt] app.stitch_frames: panorama {res.panorama.shape[:2]}, "
          f"GT-RMSE {rmse_app:.4f} at ({dy_app},{dx_app})", flush=True)

    pair_idx, pts_a, pts_b, wts, init = seen[0]
    rev = torch.arange(pair_idx.shape[0] - 1, -1, -1, device=dev)
    store = FrameStore(imgs, dev)
    st = tuning.replace(sift_features=tuning.strip_sift_features)

    def solve(dtype, where, reverse=False, threads=None):
        def run():
            args = [a[rev] if reverse else a
                    for a in (pair_idx, pts_a, pts_b, wts)]
            return TB.bundle_adjust_similarity(
                *(a.to(where) for a in (*args, init)), dtype=dtype)
        if threads is None:
            return run().cpu().numpy()
        before = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            return run().numpy()
        finally:
            torch.set_num_threads(before)

    cpu = torch.device("cpu")
    variants = [
        ("float64 on the card (this PR)", solve(torch.float64, dev)),
        ("float64 on the card, pairs reversed",
         solve(torch.float64, dev, reverse=True)),
        ("float64 on the CPU, 8 threads",
         solve(torch.float64, cpu, threads=8)),
        ("float32 on the card (the parent)", solve(torch.float32, dev)),
        ("float32 on the card, pairs reversed",
         solve(torch.float32, dev, reverse=True)),
        ("float32 on the CPU, 1 thread",
         solve(torch.float32, cpu, threads=1)),
        ("float32 on the CPU, 8 threads",
         solve(torch.float32, cpu, threads=8)),
        ("float32 on the CPU, 1 thread, pairs reversed",
         solve(torch.float32, cpu, reverse=True, threads=1)),
        ("planted transforms", np.concatenate([np.tile(
            np.eye(2, dtype=np.float32), (n, 1, 1)),
            planted.astype(np.float32)[:, :, None]], axis=2)),
    ]
    rows = []
    for label, tf in variants:
        off = np.abs(tf[:, :, 2].astype(np.float64) - planted).max(axis=1)
        area = [area_displacement(tf[k], planted[k], h, w) for k in range(n)]
        S._zero_counts()
        t0 = time.perf_counter()
        pano = auto_crop_black_border(TS.compose_strip(
            None, tf, st, "Single", device=dev, store=store,
            indices=list(range(n))))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k2 = S._counts()["warp_affine"]
        rmse, dy, dx = gt_rmse(pano, gt, device=dev)
        bands = band_rmse(torch, pano, gt, dy, dx, step, dev)
        rows.append((label, rmse, float(np.mean(area)), float(off.max())))
        print(f"[gt] {label}: GT-RMSE {rmse:.4f} at ({dy},{dx}), panorama "
              f"{pano.shape[0]}x{pano.shape[1]}, K2 launches {k2}, compose "
              f"{wall:.2f} s; offset error max {off.max():.4f} px, per frame "
              f"{np.round(off, 4).tolist()}; area displacement mean "
              f"{np.mean(area):.4f} px, per frame "
              f"{np.round(area, 4).tolist()}; band RMSE {bands}", flush=True)
    print("[gt] summary (variant, GT-RMSE, mean area displacement px, max "
          "offset error px): " + "; ".join(
              f"{lb}: {r:.4f}, {a:.4f}, {o:.4f}" for lb, r, a, o in rows),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
