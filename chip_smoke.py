"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits nonzero and prints no result):
  1. environment: torch/CUDA/nvcc versions, the card's name and power limit;
  2. build both CUDA kernels from csrc/ (build/kernels/, keyed by source);
  3. each kernel's wrapper against its plain PyTorch version on the card
     at the shapes the main path gives it (K1 at both detect
     resolutions), with timings (median of 10);
  4. the single-flight-line main path (app.stitch_frames) on a rendered
     12-frame 2160x3840 corridor sortie, once to warm up and once measured:
     one group, frame offsets within 1 px, panorama size, GT-RMSE, and the
     kernels' launch counts in the measured pass;
  5. optional: the port's CLI on a 4-frame JPEG folder, when this machine
     can encode JPEGs (run in child processes; reported, not required).
The line before the last is a JSON object with each kernel's numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

FRAME_H, FRAME_W = 2160, 3840       # flagship frame size
N_FRAMES = 12                       # one flight line
OVERLAP = 0.70                      # along-track
ORTHO_H, ORTHO_W = 2300, 16640
K1_FRAMES, K1_KP = 8, 1500          # detect chunk, keypoints per frame
K2_WIN = (2176, 3904)               # ROI window of a 4K frame at 5 bands
GT_RMSE_MAX = 8.0                   # blurred RMSE bound vs the ortho crop
OFFSET_TOL_PX = 1.0
SIZE_TOL_PX = 4


def _fail(phase: str, msg: str) -> None:
    print(f"[smoke] FAIL {phase}: {msg}", flush=True)
    sys.exit(1)


def _median_ms(fn, torch, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_environment(torch) -> str:
    from drone_image_stitch_cpp_tpu_torch.runtime.device import (
        card_name_and_power_limit)
    from drone_image_stitch_cpp_tpu_torch.runtime.kernels import _nvcc
    card = card_name_and_power_limit()
    nv = subprocess.run([_nvcc(), "--version"], capture_output=True,
                        text=True, timeout=60).stdout.strip().splitlines()
    print(f"[smoke] env torch={torch.__version__} cuda={torch.version.cuda} "
          f"python={sys.version.split()[0]} nvcc='{nv[-1] if nv else '?'}' "
          f"device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} card='{card}'", flush=True)
    return card


def phase_build() -> None:
    from drone_image_stitch_cpp_tpu_torch.runtime.kernels import load_kernel
    for src in ("sift_orient_desc.cu", "warp_affine.cu"):
        t0 = time.perf_counter()
        k = load_kernel(src)
        regs = [ln.strip() for ln in k.ptxas.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[smoke] build {src}: nvcc {k.seconds:.2f} s, load "
              f"{time.perf_counter() - t0:.2f} s; ptxas: "
              f"{' | '.join(regs)}", flush=True)


def render_sortie(torch, dev):
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import (
        fractal_ortho, render_sortie as render)
    t0 = time.perf_counter()
    ortho = fractal_ortho(ORTHO_H, ORTHO_W, seed=0, device=dev)
    imgs, ids, pos = render(ortho, 1, N_FRAMES, FRAME_H, FRAME_W, OVERLAP)
    print(f"[smoke] sortie: {len(imgs)} frames {FRAME_H}x{FRAME_W}, "
          f"overlap {OVERLAP}, ortho {ORTHO_H}x{ORTHO_W}, rendered in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return ortho, imgs, ids, pos


def _k1_check(torch, dev, imgs, label, mpx, n_kp):
    """K1's wrapper (as the main path calls it) against its plain version
    on the Gaussian stack of one 8-frame detect batch at ``mpx``."""
    from drone_image_stitch_cpp_tpu_torch.ops.color import bgr_to_gray
    from drone_image_stitch_cpp_tpu_torch.ops.features import select_keypoints
    from drone_image_stitch_cpp_tpu_torch.ops.resize import (
        resize_area, scale_for_megapixels)
    from drone_image_stitch_cpp_tpu_torch.ops import sift_kernel as SK

    sc = scale_for_megapixels(FRAME_H, FRAME_W, mpx)
    wh, ww = int(round(FRAME_H * sc)), int(round(FRAME_W * sc))
    frames = torch.from_numpy(np.stack(imgs[:K1_FRAMES])).to(dev)
    gray = resize_area(bgr_to_gray(frames.float()), wh, ww,
                       channels_last=False)
    sel = select_keypoints(gray, n_kp)
    kp = (sel.gauss_flat, sel.flat_layer, sel.yf, sel.xf, sel.sigma,
          sel.true_h, sel.true_w)
    flat = (sel.gauss_flat, sel.flat_layer.reshape(-1).int().contiguous(),
            *(a.reshape(-1).float().contiguous() for a in
              (sel.yf, sel.xf, sel.sigma, sel.true_h, sel.true_w)))
    ang_k, desc_k = SK.orientation_descriptor_flat(*kp)
    ang_k, desc_k = ang_k.reshape(-1), desc_k.reshape(-1, 128)
    ang_p, desc_p = SK.orientation_descriptor_plain(*flat)
    torch.cuda.synchronize()
    v = sel.valid.reshape(-1)
    nv = int(v.sum())
    if not (torch.isfinite(ang_k).all() and torch.isfinite(desc_k).all()):
        _fail("k1", f"{label}: non-finite kernel output")
    if nv < K1_FRAMES * n_kp // 2:
        _fail("k1", f"{label}: only {nv} valid keypoints")
    dang = torch.remainder(ang_k - ang_p + np.pi, 2 * np.pi) - np.pi
    dang = dang.abs()[v]
    l2 = torch.linalg.norm(desc_k - desc_p, dim=-1)[v]
    frac = float(((dang < 0.02) & (l2 < 2.0)).float().mean())
    flips = int((dang >= 0.02).sum())
    worst = float(l2.max())
    max_err = float((desc_k - desc_p).abs()[v].max())
    if frac < 0.99 or worst >= 25.0 or flips > 0.01 * nv:
        _fail("k1", f"{label}: close fraction {frac:.5f} (need >= 0.99), "
                    f"max L2 {worst:.3f} (need < 25), angle flips {flips} "
                    f"of {nv} (need <= 1%)")
    ms = _median_ms(lambda: SK.orientation_descriptor_flat(*kp), torch)
    plain_ms = _median_ms(lambda: SK.orientation_descriptor_plain(*flat),
                          torch)
    print(f"[smoke] k1 sift_orient_desc {label}: {nv} valid keypoints of "
          f"{v.numel()} on a {tuple(sel.gauss_flat.shape)} stack; "
          f"close (angle<0.02 rad, L2<2) {frac:.5f}; angle flips {flips}; "
          f"max L2 {worst:.4f}; max |d desc| {max_err:.4f}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    return max_err, ms, plain_ms


def phase_k1(torch, dev, imgs, tuning):
    """K1 at both detect resolutions of the main path: strip registration
    (1500 keypoints per frame) and grouping (the grouper's work size and
    feature budget, grouping/flight_grouper.estimate_relations)."""
    from drone_image_stitch_cpp_tpu_torch.grouping.flight_grouper import (
        _MAX_DIM)
    err_r, ms, plain_ms = _k1_check(torch, dev, imgs, "registration",
                                    tuning.registration_resol_mpx, K1_KP)
    group_mpx = FRAME_H * FRAME_W * min(
        1.0, (_MAX_DIM / max(FRAME_H, FRAME_W)) ** 2) / 1e6
    group_kp = int(np.clip(tuning.strip_sift_features, 600, 1800))
    err_g, _, _ = _k1_check(torch, dev, imgs, "grouping", group_mpx,
                            group_kp)
    return {"name": "sift_orient_desc", "route": "cuda",
            "source": "drone_image_stitch_cpp_tpu_torch/csrc/"
                      "sift_orient_desc.cu",
            "replaces": "drone_image_stitch_cpp_tpu/ops/pallas_sift.py:308",
            "max_abs_err": max(err_r, err_g), "ms": ms, "plain_ms": plain_ms}


def phase_k2(torch, dev, img):
    """K2's wrapper vs its plain version: a full 4K uint8 frame into a
    2176x3904 window, rotated 2 deg, from a canvas position near
    x = 1.2e4 (the window origin 11904 is subtracted as the compose feed
    does)."""
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    th = np.radians(2.0)
    c, s = np.cos(th), np.sin(th)
    a_canvas = np.asarray([[c, -s, 12000.37], [s, c, 20.61]], np.float64)
    a23 = a_canvas.copy()
    a23[0, 2] -= 11904.0
    a23 = a23.astype(np.float32)
    frame = torch.from_numpy(img).to(dev)
    oh, ow = K2_WIN
    wk, mk = WK.warp_frame(frame, a23, oh, ow)
    wp, mp = WK.warp_frame_plain(frame, WK.inverse_coeffs(a23), oh, ow)
    torch.cuda.synchronize()
    d = torch.cat([(wk - wp).abs().reshape(-1), (mk - mp).abs().reshape(-1)])
    max_err, mean_err = float(d.max()), float(d.mean())
    covered = float((mk >= 0.5).float().mean())
    if max_err > 0.5 or mean_err > 1e-3 or covered < 0.5:
        _fail("k2", f"max |d| {max_err} (<= 0.5), mean {mean_err} "
                    f"(<= 1e-3), covered {covered:.3f}")
    ms = _median_ms(lambda: WK.warp_frame(frame, a23, oh, ow), torch)
    plain_ms = _median_ms(lambda: WK.warp_frame_plain(
        frame, WK.inverse_coeffs(a23), oh, ow), torch)
    print(f"[smoke] k2 warp_affine: {FRAME_H}x{FRAME_W} u8 -> {oh}x{ow}x3 "
          f"+ mask, window coverage {covered:.3f}; max |d| {max_err:.3g}, "
          f"mean |d| {mean_err:.3g}; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms", flush=True)
    return {"name": "warp_affine", "route": "cuda",
            "source": "drone_image_stitch_cpp_tpu_torch/csrc/warp_affine.cu",
            "replaces": "drone_image_stitch_cpp_tpu/ops/pallas_warp.py:234",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def phase_slice(torch, dev, ortho, imgs, ids, pos, tuning):
    from drone_image_stitch_cpp_tpu_torch.app import stitch_frames
    from drone_image_stitch_cpp_tpu_torch.ops.sift_kernel import (
        orientation_descriptor_flat)
    from drone_image_stitch_cpp_tpu_torch.ops.warp_kernel import warp_frame
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

    log = get_logger()
    log.verbose = False
    # first pass: library handles (cuBLAS, cuSOLVER) and allocator warm-up
    t0 = time.perf_counter()
    stitch_frames(imgs, ids, tuning, dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    orientation_descriptor_flat.launches = 0
    warp_frame.launches = 0
    t0 = time.perf_counter()
    res = stitch_frames(imgs, ids, tuning, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"sift_orient_desc": orientation_descriptor_flat.launches,
                "warp_affine": warp_frame.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    tm = log.timings()
    stages = {k: tm.get(v) for k, v in (
        ("store", "frame store done"), ("grouping", "grouping done"),
        ("register", "register done"), ("seam_warps", "seam warps done"),
        ("gains", "gains done"), ("seams", "seams done"),
        ("blend", "blend done"), ("crop", "crop done"),
        ("stitch", "single-group stitch done"))}

    sizes = [len(g.indices) for g in res.groups]
    if sizes != [N_FRAMES]:
        _fail("slice", f"groups {sizes}, expected one group of {N_FRAMES}")
    if res.kept != list(range(N_FRAMES)):
        _fail("slice", f"kept frames {res.kept}")
    exp = np.asarray([(x - pos[0][1], y - pos[0][0]) for y, x in pos],
                     np.float64)
    got = res.transforms[:, :, 2].astype(np.float64)
    off_err = float(np.abs(got - exp).max())
    lin_err = float(np.abs(res.transforms[:, :, :2]
                           - np.eye(2, dtype=np.float32)).max())
    if off_err > OFFSET_TOL_PX:
        _fail("slice", f"frame offsets off by {off_err:.3f} px")
    pano = res.panorama
    gt_h = FRAME_H
    gt_w = FRAME_W + (N_FRAMES - 1) * (pos[1][1] - pos[0][1])
    if abs(pano.shape[0] - gt_h) > SIZE_TOL_PX or \
            abs(pano.shape[1] - gt_w) > SIZE_TOL_PX:
        _fail("slice", f"panorama {pano.shape[:2]} vs ground truth "
                       f"{(gt_h, gt_w)}")
    y0, x0 = pos[0]
    gt = np.clip(ortho[y0:y0 + gt_h, x0:x0 + gt_w], 0, 255).astype(np.uint8)
    rmse, dy, dx = gt_rmse(pano, gt, device=dev)
    if not np.isfinite(rmse) or rmse > GT_RMSE_MAX:
        _fail("slice", f"GT-RMSE {rmse} > {GT_RMSE_MAX}")
    print(f"[smoke] slice: groups {sizes}, panorama {pano.shape[0]}x"
          f"{pano.shape[1]} (gt {gt_h}x{gt_w}), max offset error "
          f"{off_err:.4f} px, max |linear - I| {lin_err:.2e}, GT-RMSE "
          f"{rmse:.4f} at shift ({dy},{dx}), wall {wall:.2f} s (first pass "
          f"{cold:.2f} s)", flush=True)
    print(f"[smoke] slice stages (s): " + ", ".join(
        f"{k}={v}" for k, v in stages.items()), flush=True)
    print(f"[smoke] slice peak memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated), launches {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            _fail("slice", f"kernel {name} never launched on the main path")
    return launches


def _child_write_jpegs(src_dir: str, out_dir: str) -> int:
    """Child process: encode the .npy frames of ``src_dir`` as JPEGs."""
    from drone_image_stitch_cpp_tpu_torch.app import write_image
    os.makedirs(out_dir, exist_ok=True)
    for name in sorted(os.listdir(src_dir)):
        img = np.load(os.path.join(src_dir, name))
        write_image(os.path.join(out_dir, name.replace(".npy", ".jpg")), img)
    return 0


def phase_cli(imgs) -> None:
    """The port's CLI on 4 frames of the line; needs a JPEG codec, which
    this machine may lack: reported either way, never required."""
    tmp = tempfile.mkdtemp(prefix="smoke_cli_")
    try:
        npy = os.path.join(tmp, "npy")
        os.makedirs(npy)
        for k, im in enumerate(imgs[:4]):
            np.save(os.path.join(npy, f"IMG{k:03d}_x.npy"), im)
        folder = os.path.join(tmp, "in", "visible", "run")
        w = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--write-jpegs", npy, folder],
                           capture_output=True, text=True, timeout=300)
        if w.returncode != 0:
            tail = (w.stderr.strip().splitlines() or ["?"])[-1]
            print(f"[smoke] cli: skipped, JPEG codec unavailable here "
                  f"(rc={w.returncode}: {tail[:160]})", flush=True)
            return
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "drone_image_stitch_cpp_tpu_torch.cli.main",
             "--device", "cuda", "--image-folder", os.path.join(tmp, "in"),
             "--image-type", "visible", "--group", "run",
             "--output-root", out],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        pano = os.path.join(out, "visible", "run",
                            "visible_run_uav_panorama.jpg")
        print(f"[smoke] cli: rc={r.returncode}, panorama written="
              f"{os.path.exists(pano)}, {time.perf_counter() - t0:.1f} s",
              flush=True)
    except subprocess.TimeoutExpired as e:
        print(f"[smoke] cli: timed out ({e.timeout} s)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[smoke] FAIL env: torch.cuda.is_available() is False",
              flush=True)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import drone_image_stitch_cpp_tpu_torch  # noqa: F401  (fp32 policy)
    from drone_image_stitch_cpp_tpu_torch.config.tuning import (
        load_stitch_tuning)

    dev = torch.device("cuda", 0)
    card = phase_environment(torch)
    phase_build()
    tuning = load_stitch_tuning("visible")
    ortho, imgs, ids, pos = render_sortie(torch, dev)
    k1 = phase_k1(torch, dev, imgs, tuning)
    k2 = phase_k2(torch, dev, imgs[len(imgs) // 2])
    torch.cuda.empty_cache()
    launches = phase_slice(torch, dev, ortho, imgs, ids, pos, tuning)
    torch.cuda.empty_cache()
    phase_cli(imgs)
    k1["launches"] = launches["sift_orient_desc"]
    k2["launches"] = launches["warp_affine"]
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms")
    print(card)
    print(json.dumps({"kernels": [{k: d[k] for k in order}
                                  for d in (k1, k2)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--write-jpegs":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(_child_write_jpegs(sys.argv[2], sys.argv[3]))
    sys.exit(main())
