"""The calibrated-corridor drift study: where a 12-frame 2160x3840
corridor seen through a barrel lens registers against its planted
positions, stage by stage.

    python studies/calib_drift.py card --save FILE   # the port on a CUDA card
    python studies/calib_drift.py cpu [--card-frames FILE]   # both packages

The frames: the 12 corridor crops of the seeded 2300x16640
``fractal_ortho``, placed 64 px into the ortho (origin (64, 64 + k *
1152)) and rendered through the lens of ``chip_smoke.KNOB_LENS`` (fx =
fy = 3000 px, centred, k1 = -0.05, k2 = 0.01) by a copy of
``chip_smoke._distorted_frames`` sampling the unpadded ortho (the lens
moves no sample outside it at this placement). Rendered on the CPU, or,
as the smoke renders, with the ortho's upsampling and the lens samples
on the card: the two renderings differ in a few pixels by one level.

``card``: renders both ways, saves to FILE (npz) where the card's
rendering differs from the CPU's and where the card's undistortion of it
differs from the CPU's, and runs the port's undistortion +
``app.stitch_frames`` on each three ways: as it is; with the
undistortion done on the CPU; with K1 replaced by its plain version (on
the card). ``cpu``: the JAX package's ``app._undistort_if_ready``
against the port's ``app.undistort_frames`` (pixels that differ), then
each package's ``estimate_strip_transforms`` with the app's strip knobs,
the port given the RANSAC sample banks JAX draws (its pair keys; the
detects still differ by JAX's shape-bucket pad) and its own; on the CPU
rendering, or with ``--card-frames`` on the card's (the CPU rendering
with the saved differences applied), then also both packages'
registration on the frames as the card undistorted them. Every run
prints each frame's offset error against the planted position (px) and
the largest.
A study script, kept to reproduce the verdict in PERF.md section 6; no
test runs it. It imports JAX only in the ``cpu`` mode.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FRAME_H, FRAME_W = 2160, 3840
ORTHO_H, ORTHO_W = 2300, 16640
N_FRAMES, OVERLAP = 12, 0.70
ORIGIN = 64
LENS = dict(fx=3000.0, fy=3000.0, cx=(FRAME_W - 1) / 2.0,
            cy=(FRAME_H - 1) / 2.0,
            dist=(-0.05, 0.01, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0))


def positions():
    step = int(FRAME_W * (1 - OVERLAP))
    return [(ORIGIN, ORIGIN + k * step) for k in range(N_FRAMES)]


def distorted_frames(torch, ortho, pos, calib, dev):
    """The frames at ``pos`` as the lens sees them (the inverse of the
    undistortion map by fixed-point iteration, bilinear samples of the
    ortho), rendered on ``dev``; uint8 host frames."""
    from drone_image_stitch_cpp_tpu_torch.ops.warp import bilinear_sample
    k1, k2 = calib.dist[0], calib.dist[1]
    ys = torch.arange(FRAME_H, dtype=torch.float64, device=dev)[:, None]
    xs = torch.arange(FRAME_W, dtype=torch.float64, device=dev)[None, :]
    xd = ((xs - calib.cx) / calib.fx).expand(FRAME_H, FRAME_W)
    yd = ((ys - calib.cy) / calib.fy).expand(FRAME_H, FRAME_W)
    x, y = xd, yd
    for _ in range(30):
        r2 = x * x + y * y
        rad = 1.0 + k1 * r2 + k2 * r2 * r2
        x, y = xd / rad, yd / rad
    ux = (x * calib.fx + calib.cx).float()
    uy = (y * calib.fy + calib.cy).float()
    src = torch.from_numpy(ortho).to(dev)
    frames = []
    for py, px in pos:
        sx, sy = ux + px, uy + py
        if float(sx.min()) < 0 or float(sy.min()) < 0 or \
                float(sx.max()) > src.shape[1] - 2 or \
                float(sy.max()) > src.shape[0] - 2:
            raise SystemExit(f"frame at {(py, px)} samples outside the ortho")
        d = bilinear_sample(src, sx, sy)
        frames.append(d.round().clamp(0, 255).to(torch.uint8).cpu().numpy())
    return frames


def offset_errors(transforms, pos):
    """Per-frame |offset - planted| (max over x and y), px."""
    exp = np.asarray([(x - pos[0][1], y - pos[0][0]) for y, x in pos],
                     np.float64)
    t = np.asarray(transforms, np.float64)
    return np.abs(t[:, :, 2] - exp).max(axis=1)


def report(label, transforms, pos, wall=None):
    per = offset_errors(transforms, pos)
    extra = f", wall {wall:.2f} s" if wall is not None else ""
    print(f"[drift] {label}: max {per.max():.4f} px at frame "
          f"{int(per.argmax())}; per frame {np.round(per, 4).tolist()}"
          f"{extra}", flush=True)
    return per


def setup(torch, dev="cpu"):
    """(frames rendered on ``dev``, planted positions, the visible tuning
    with the lens's calibration)."""
    from drone_image_stitch_cpp_tpu_torch.config.tuning import (
        CameraCalibration, MultiBandCalibration, load_stitch_tuning)
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import (
        fractal_ortho)
    t0 = time.perf_counter()
    ortho = fractal_ortho(ORTHO_H, ORTHO_W, seed=0, device=dev)
    pos = positions()
    cam = CameraCalibration(name="visible", **LENS)
    frames = distorted_frames(torch, ortho, pos, cam, dev)
    tuning = load_stitch_tuning("visible").replace(
        calibration=MultiBandCalibration(visible=cam))
    print(f"[drift] {N_FRAMES} distorted frames at {pos[0]} + k * "
          f"{pos[1][1] - pos[0][1]} px rendered on {dev} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return frames, pos, tuning


def frame_diff(base, other):
    """Where ``other`` differs from ``base`` (same-shape uint8 frames):
    {"frame", "index" (flat pixel index), "value" (other's BGR)}."""
    fi, idx, val = [], [], []
    for k, (a, b) in enumerate(zip(base, other)):
        flat = np.flatnonzero((a != b).any(axis=-1))
        fi.append(np.full(flat.shape, k, np.int32))
        idx.append(flat.astype(np.int64))
        val.append(b.reshape(-1, 3)[flat])
    return {"frame": np.concatenate(fi), "index": np.concatenate(idx),
            "value": np.concatenate(val)}


def apply_diff(base, diff):
    out = [f.copy() for f in base]
    for k, f in enumerate(out):
        sel = diff["frame"] == k
        f.reshape(-1, 3)[diff["index"][sel]] = diff["value"][sel]
    return out


def run_cpu(card_frames=None) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import dataclasses

    import jax
    import torch

    from drone_image_stitch_cpp_tpu import app as japp
    from drone_image_stitch_cpp_tpu.config.tuning import (
        CameraCalibration as JCam, MultiBandCalibration as JCal,
        load_stitch_tuning as jload, tuning_as_dict)
    from drone_image_stitch_cpp_tpu.pipeline.strip import (
        estimate_strip_transforms as jestimate)
    from drone_image_stitch_cpp_tpu_torch import app as tapp
    from drone_image_stitch_cpp_tpu_torch.config.tuning import from_jax_dict
    from drone_image_stitch_cpp_tpu_torch.pipeline import strip as TS

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    frames, pos, _ = setup(torch)
    diff = {}
    if card_frames:
        with np.load(card_frames) as z:
            diff = {k: z[k] for k in z.files}
        frames = apply_diff(frames, {k: diff[k] for k in
                                     ("frame", "index", "value")})
        print(f"[drift] the card's rendering: {len(diff['index'])} pixels "
              f"of the CPU's changed", flush=True)
    jcal = JCal(visible=JCam(name="visible", **LENS))
    jt = jload("visible").replace(calibration=jcal)
    tt = from_jax_dict(tuning_as_dict(jt),
                       calibration=dataclasses.asdict(jcal))

    t0 = time.perf_counter()
    ju = japp._undistort_if_ready(frames, jt, "visible")
    print(f"[drift] JAX undistortion {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    tu = tapp.undistort_frames(frames, tt, "visible", "cpu")
    print(f"[drift] port undistortion {time.perf_counter() - t0:.1f} s",
          flush=True)
    per = [int((a != b).any(axis=-1).sum()) for a, b in zip(ju, tu)]
    lv = max(int(np.abs(a.astype(int) - b.astype(int)).max())
             for a, b in zip(ju, tu))
    print(f"[drift] undistorted frames: pixels that differ per frame "
          f"{per} (largest level difference {lv})", flush=True)

    st_j = jt.replace(sift_features=jt.strip_sift_features)
    st_t = tt.replace(sift_features=tt.strip_sift_features)
    t0 = time.perf_counter()
    kept_j, tr_j, _ = jestimate(ju, st_j, range_width=jt.range_width,
                                stage="Single", seed=0)
    report(f"JAX estimate_strip_transforms (kept {len(kept_j)})",
           np.asarray(tr_j), pos, time.perf_counter() - t0)

    def jax_banks(seed, n_pairs, n_hyp, chunk=16):
        n_keys = -(-n_pairs // chunk) * chunk
        keys = jax.random.split(jax.random.PRNGKey(seed), n_keys)[:n_pairs]
        return torch.from_numpy(np.stack([np.asarray(jax.random.randint(
            k, (n_hyp, 2), 0, np.iinfo(np.int32).max)) for k in keys]))

    real = TS.register_pairs

    def with_jax_banks(feats, pairs, ratio, thresh, seed=0, **kw):
        return real(feats, pairs, ratio, thresh, seed=seed,
                    banks=jax_banks(seed, len(pairs), 1024), **kw)

    runs = [("JAX's undistorted frames", ju),
            ("its own undistorted frames", tu)]
    if "und_index" in diff:
        card_und = apply_diff(tu, {k[4:]: v for k, v in diff.items()
                                   if k.startswith("und_")})
        runs.append(("the frames the card undistorted", card_und))
        t0 = time.perf_counter()
        kept_j, tr_j, _ = jestimate(card_und, st_j,
                                    range_width=jt.range_width,
                                    stage="Single", seed=0)
        report(f"JAX estimate_strip_transforms on the frames the card "
               f"undistorted (kept {len(kept_j)})", np.asarray(tr_j), pos,
               time.perf_counter() - t0)
    for label, imgs in runs:
        for banks in ("JAX's banks", "its own banks"):
            TS.register_pairs = (with_jax_banks if banks == "JAX's banks"
                                 else real)
            try:
                t0 = time.perf_counter()
                kept_t, tr_t, _ = TS.estimate_strip_transforms(
                    imgs, st_t, range_width=tt.range_width, stage="Single",
                    seed=0, device=torch.device("cpu"))
            finally:
                TS.register_pairs = real
            report(f"port estimate_strip_transforms on {label}, {banks} "
                   f"(kept {len(kept_t)})", tr_t, pos,
                   time.perf_counter() - t0)
    return 0


def run_card(save=None) -> int:
    import torch

    from drone_image_stitch_cpp_tpu_torch import app as A
    from drone_image_stitch_cpp_tpu_torch.ops import sift_kernel as SK
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger

    if not torch.cuda.is_available():
        print("[drift] FAIL: no CUDA card", flush=True)
        return 1
    dev = torch.device("cuda", 0)
    get_logger().verbose = False
    frames, pos, tuning = setup(torch)
    card_frames, _, _ = setup(torch, dev)
    diff = frame_diff(frames, card_frames)
    per = np.bincount(diff["frame"], minlength=N_FRAMES).tolist()
    lv = max((int(np.abs(a.astype(int) - b.astype(int)).max())
              for a, b in zip(frames, card_frames)), default=0)
    print(f"[drift] rendered on the card vs the CPU: pixels that differ per "
          f"frame {per} (largest level difference {lv})", flush=True)
    ids = [f"IMG{k:03d}" for k in range(N_FRAMES)]
    saved = {}

    def run(label, imgs, undistort_dev, plain_k1=False):
        real = SK._launch
        if plain_k1:
            SK._launch = (lambda gauss, radius, layer, *rest:
                          SK.orientation_descriptor_plain(gauss, layer,
                                                          *rest))
        try:
            t0 = time.perf_counter()
            und = A.undistort_frames(imgs, tuning, "visible", undistort_dev)
            res = A.stitch_frames(und, ids, tuning, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            SK._launch = real
        sizes = [len(g.indices) for g in res.groups]
        report(f"{label} (groups {sizes}, kept {len(res.kept)})",
               res.transforms, pos, wall)
        return und

    A.stitch_frames(A.undistort_frames(frames, tuning, "visible", dev),
                    ids, tuning, dev)          # warm-up
    for where, imgs in (("the card", card_frames), ("the CPU", frames)):
        und_card = run(f"rendered on {where}: the port on the card, as it "
                       f"is", imgs, dev)
        und_cpu = run(f"rendered on {where}: the port on the card, "
                      f"undistortion on the CPU", imgs, torch.device("cpu"))
        per = [int((a != b).any(axis=-1).sum())
               for a, b in zip(und_card, und_cpu)]
        print(f"[drift] rendered on {where}: undistorted on the card vs the "
              f"CPU: pixels that differ per frame {per}", flush=True)
        if where == "the card":
            saved = {**diff, **{f"und_{k}": v for k, v in
                                frame_diff(und_cpu, und_card).items()}}
        run(f"rendered on {where}: the port on the card, K1 replaced by its "
            f"plain version", imgs, dev, plain_k1=True)
    if save:
        np.savez_compressed(save, **saved)
    return 0


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("cpu", "card"))
    p.add_argument("--save", default=None,
                   help="card: npz of where the card's rendering differs")
    p.add_argument("--card-frames", default=None,
                   help="cpu: run on the card's rendering (a --save file)")
    args = p.parse_args()
    sys.exit(run_cpu(args.card_frames) if args.mode == "cpu"
             else run_card(args.save))
