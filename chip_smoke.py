"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits nonzero and prints no result):
  1. environment: torch/CUDA/nvcc versions, the card's name and power limit;
  2. build both CUDA kernels from csrc/ (build/kernels/, keyed by source;
     one nvcc per source, all started together), with ptxas's registers
     and spills;
  3. each kernel's wrapper against its plain PyTorch version on the card
     at the shapes the main paths give it: K1 at both detect resolutions
     of a strip and at the global stage's strip detect (two launches
     bit-identical; the padded-stack build that feeds it timed beside
     it), K2 at the compose-feed window, batched at the seam scale, and
     in content mode from a padded strip into the global compose's
     5120x5120 window (each bit-equal to its plain version). Times: the
     wrapper per
     call (ms: CUDA events around one call on an idle card, median of 10,
     so its host set-up counts; wrapper_b2b_ms: 20 calls back to back / 20,
     where host and device overlap), the bare launch (device_ms: events
     around 20 back-to-back launches / 20, median of 5) and, for K2, one
     F.grid_sample call on the same input (library_ms, a yardstick the
     port never calls);
  4. the single-flight-line main path (app.stitch_frames) on a rendered
     12-frame 2160x3840 corridor sortie, once to warm up and once measured:
     one group, frame offsets within 1 px, panorama size, GT-RMSE, and the
     kernels' launch counts in the measured pass;
  5. the multi-line main path (app.stitch_frames: three strip stitches
     whose panoramas stay on the card, then the global stage) on a
     rendered 3 x 10 boustrophedon sortie of 2160x3840 frames (overlaps
     0.70 along-track, 0.35 side), measured once after the production
     phase's run of the same sortie (its first pass, which also gives the
     per-strip GT-RMSE from its checkpointed strips):
     groups, no flips, strip offsets within 2 px, mosaic size within 8 px,
     GT-RMSE (and per strip), graph-cut seams on every adjacent strip pair,
     K1 launched by the global stage and K2's content mode launched;
  6. fallback: the strip stage's sequential anchor-window ladder on the
     first 4 corridor frames (joint registration forced to fail here):
     panorama size within 8 px of the planted one, GT-RMSE, K1 launched on
     a mixed-size batch (its mixed_launches counter) and K2 launched; a
     non-overlapping 4K pair must raise StripStitchError with a
     diagnostics record; K1 timed at the ladder's mixed-size batch against
     its plain version, as at the other shapes;
  7. production (run before phase 5's measured pass), on the multi-line
     phase's 3 x 10 sortie (its strips tile, so they come back as
     DeviceStrips):
     app.stitch_frames with a BackgroundWriter fetching every DeviceStrip
     and writing the strip checkpoint (.npy) on its thread while the next
     strip stitches, and an in-memory row sink on the global stage (bands
     in order, crop box holding the exact content box); then a resume:
     load_strip_checkpoint + stitch_inter_strips_custom, whose mosaic and
     bands must equal the straight run's. Then, when this machine can
     encode JPEGs (the codec built from native/, else cv2), the CLI in
     child processes on the JPEGs of the sortie's first 6 frames of each
     line (cut from 10 to keep the smoke's time): rc 0, strip JPEGs and
     checkpoint written, the streamed write logged when the codec built,
     the decoded panorama within GT-RMSE 8, and a --resume run whose
     decoded panorama equals the first; decode, grouping, strip-save
     drain, streamed write and whole-run times, and the children's peak
     RSS. Where no encoder exists, it prints why.
The environment line carries the JPEG codec probe (jpeglib.h, the libjpeg
the loader sees, g++, cv2 and PIL); the build phase builds the codec from
native/ beside the kernels and prints its library or the compiler's
first error line.
The line before the last is a JSON object with each kernel's numbers:
bound_ms is the larger of the bytes the call must move (each input byte
it needs read once: for K1 the stack pixels that its keypoints' needed
gradients tap, for K2 the source pixels its taps touch; each output
written once) over 3.35 TB/s and its float32 operations (for K1 counted
from its plain version over the gradients, orientation-box and descriptor
terms this run needs, transcendental functions as one) over 67 TFLOP/s;
share = bound_ms / device_ms. The last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
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
ML_ROWS, ML_COLS = 3, 10            # multi-line sortie: lines x frames
ML_OVERLAP_Y = 0.35                 # side overlap (BENCH_sortie.json)
ML_ORTHO_H = 5100
ML_STRIP_TOL_PX = 2.0               # strip offsets vs the planted ones
ML_SIZE_TOL_PX = 8
K2_GLOBAL_WIN = (5120, 5120)        # the global compose's tile window
# 0.9 x the 1731 valid keypoints the JAX package's global detect finds on
# the multi-line sortie's line-1 strip (tests/test_torch_global_detect.py
# holds the port's count to it and this floor under 0.9 of it)
K1_GLOBAL_MIN_VALID = 1557
CLI_COLS = 6                        # production CLI: frames per line
FB_FRAMES = 4                       # fallback phase: corridor frames
FB_SIZE_TOL_PX = 8
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
FP32_OPS_PER_S = 67e12              # float32 outside the tensor cores


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


def _device_ms(fn, torch, launches: int = 20, reps: int = 5) -> float:
    """Device time of one call: CUDA events around ``launches`` back-to-
    back calls, divided by ``launches`` (median of ``reps``)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def _bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by) of a call that moves n_bytes and does n_ops."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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
    print(f"[smoke] env codec probe: {_codec_probe()}", flush=True)
    return card


def _codec_probe() -> str:
    """What this machine offers for JPEG: jpeglib.h, the libjpeg the
    dynamic loader lists, g++, cv2 and PIL."""
    import importlib.util
    heads = [d for d in ("/usr/include", "/usr/local/include",
                         "/usr/include/x86_64-linux-gnu")
             if os.path.exists(os.path.join(d, "jpeglib.h"))]
    try:
        ld = subprocess.run(["ldconfig", "-p"], capture_output=True,
                            text=True, timeout=30).stdout
        libs = sorted({ln.split()[0] for ln in ld.splitlines()
                       if "libjpeg.so" in ln})
    except (OSError, subprocess.TimeoutExpired) as e:
        libs = [f"ldconfig failed: {e}"]
    gxx = shutil.which("g++")
    ver = (subprocess.run([gxx, "--version"], capture_output=True, text=True,
                          timeout=30).stdout.splitlines() or ["?"])[0] \
        if gxx else "none"
    mods = {m: importlib.util.find_spec(m) is not None
            for m in ("cv2", "PIL")}
    return (f"jpeglib.h {heads or 'absent'}; libjpeg {libs or 'absent'}; "
            f"g++ '{ver}'; cv2 {mods['cv2']}; PIL {mods['PIL']}")


def phase_build() -> dict:
    """Build both kernels, one nvcc each, started together; returns each
    source's (registers, spill bytes) as ptxas reports them."""
    from drone_image_stitch_cpp_tpu_torch.ops import sift_kernel as SK
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    from drone_image_stitch_cpp_tpu_torch.runtime.kernels import load_kernels

    import threading

    from drone_image_stitch_cpp_tpu_torch.utils.native import (
        jpeg_codec_error, jpeg_codec_library)

    t0 = time.perf_counter()
    # the host JPEG codec (g++) builds beside the nvcc builds
    codec = threading.Thread(target=jpeg_codec_error)
    codec.start()
    mods = (SK, WK)
    built = load_kernels({m.KERNEL_SOURCE: m.KERNEL_SIGNATURES
                          for m in mods})
    codec.join()
    err = jpeg_codec_error()
    print(f"[smoke] build JPEG codec from native/decode.cpp + encode.cpp: "
          + (f"built {os.path.relpath(jpeg_codec_library())}" if err is None
             else f"not built: {err}"), flush=True)
    out = {}
    for m in mods:
        k = built[m.KERNEL_SOURCE]
        lines = [ln.strip() for ln in k.ptxas.splitlines()
                 if "registers" in ln or "spill" in ln]
        regs = [int(x) for x in re.findall(r"Used (\d+) registers",
                                           k.ptxas)]
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill",
                                               k.ptxas))
        out[m.KERNEL_SOURCE] = (max(regs, default=-1), spill)
        print(f"[smoke] build {m.KERNEL_SOURCE}: nvcc {k.seconds:.2f} s; "
              f"ptxas: {' | '.join(lines)}", flush=True)
    print(f"[smoke] build: both kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    return out


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


def _k1_work(torch, gauss, layer, yf, xf, sigma, true_h, true_w, angle):
    """What one K1 call needs on these keypoints, by the plain version's
    geometry and this run's angles: (stack pixels read, gradients,
    orientation-box terms, descriptor terms). A gradient is needed where it
    is valid in its octave and lies in the orientation box (|dy|, |dx| <=
    round(4.5 sigma) around the rounded centre) or in the descriptor square
    (rbin, cbin in (-1, 4) in the frame rotated by the keypoint's angle); a
    stack pixel is read when it is one of a needed gradient's four
    central-difference taps, once however many keypoints share it."""
    from drone_image_stitch_cpp_tpu_torch.ops.sift_kernel import (
        support_radius)
    l_, h_, w_ = gauss.shape
    dev = gauss.device
    used = torch.zeros((l_, h_, w_), dtype=torch.bool, device=dev)
    g = support_radius(float(sigma.max())) - 1
    off = torch.arange(-g, g + 1, device=dev)
    n_grad = n_ori = n_desc = 0
    for c0 in range(0, layer.numel(), 1024):
        sl = slice(c0, c0 + 1024)
        li = layer[sl].long().clamp(0, l_ - 1)
        y, x, s = yf[sl], xf[sl], sigma[sl]
        rows = torch.round(y).long()[:, None] + off              # (n, 2g+1)
        cols = torch.round(x).long()[:, None] + off
        rf, cf = rows.float(), cols.float()
        valid = (((rf >= 1) & (rf <= true_h[sl, None] - 2))[:, :, None]
                 & ((cf >= 1) & (cf <= true_w[sl, None] - 2))[:, None, :])
        ro = torch.round(4.5 * s)[:, None]
        near = off.abs()[None, :] <= ro
        obox = near[:, :, None] & near[:, None, :] & valid
        a = angle[sl][:, None, None]
        ca, sa = torch.cos(a), torch.sin(a)
        hw = 3.0 * s[:, None, None]
        dx = cf[:, None, :] - x[:, None, None]
        dy = rf[:, :, None] - y[:, None, None]
        cbin = (ca * dx - sa * dy) / hw + 1.5
        rbin = (sa * dx + ca * dy) / hw + 1.5
        square = ((rbin > -1) & (rbin < 4) & (cbin > -1) & (cbin < 4)
                  & valid)
        need = obox | square
        n_grad += int(need.sum())
        n_ori += int(obox.sum())
        n_desc += int(square.sum())
        flat = ((li[:, None, None] * h_ + rows[:, :, None]) * w_
                + cols[:, None, :])
        used.view(-1)[flat[need]] = True
    reads = torch.zeros_like(used)
    reads[:, :-1] |= used[:, 1:]
    reads[:, 1:] |= used[:, :-1]
    reads[:, :, :-1] |= used[:, :, 1:]
    reads[:, :, 1:] |= used[:, :, :-1]
    return int(reads.sum()), n_grad, n_ori, n_desc


# K1's float32 operations, counted from its plain version
# (ops/sift_kernel._plain_chunk) on what the function needs; a
# transcendental function (sqrt, atan2, exp, sin, cos) counts as one,
# index arithmetic and comparisons as none
K1_GRAD_OPS = 9    # gx, gy (sub, x0.5 each), gx^2 + gy^2 (3), sqrt, atan2
K1_ORI_OPS = 10    # dy^2 + dx^2 (3), / 2 sig^2, exp, x mag, theta / 2pi x 36
#                    (2), round, the histogram add
K1_DESC_OPS = 62   # dx, dy (2); u, v (8); rbin, cbin (2); orientation bin
#                    (4); Gaussian weight (5); x mag; the 2 row, 2 column
#                    and 2 orientation hats that reach bins (3 each);
#                    14 products; 8 histogram adds
K1_KP_OPS = 36 * 7 + 36 + 10 + 128 * 9 + 2   # smoothing, argmax, peak,
#                    angle, sin, cos; two normalisations with clip, x512


def _k1_bound(torch, gauss, layer, yf, xf, sigma, true_h, true_w, angle):
    """(bound_ms, bound_by, MB, GFLOP) of one K1 call on these keypoints:
    bytes are the stack pixels it must read (_k1_work), the six keypoint
    fields (layer int64) and the outputs; operations as counted above."""
    pixels, n_grad, n_ori, n_desc = _k1_work(torch, gauss, layer, yf, xf,
                                             sigma, true_h, true_w, angle)
    n = layer.numel()
    n_bytes = 4.0 * pixels + (8 + 5 * 4.0) * n + 129 * 4.0 * n
    n_ops = float(K1_GRAD_OPS * n_grad + K1_ORI_OPS * n_ori
                  + K1_DESC_OPS * n_desc + K1_KP_OPS * n)
    b_ms, b_by = _bound(n_bytes, n_ops)
    return b_ms, b_by, n_bytes / 1e6, n_ops / 1e9


def _k1_gray(torch, dev, imgs, mpx):
    """One 8-frame detect batch of the strip path at ``mpx``: (B, h, w)."""
    from drone_image_stitch_cpp_tpu_torch.ops.color import bgr_to_gray
    from drone_image_stitch_cpp_tpu_torch.ops.resize import (
        resize_area, scale_for_megapixels)
    sc = scale_for_megapixels(FRAME_H, FRAME_W, mpx)
    wh, ww = int(round(FRAME_H * sc)), int(round(FRAME_W * sc))
    frames = torch.from_numpy(np.stack(imgs[:K1_FRAMES])).to(dev)
    return resize_area(bgr_to_gray(frames.float()), wh, ww,
                       channels_last=False)


def _k1_check(torch, gray, label, n_kp, min_valid=None, true_hw=None):
    """K1's wrapper (as the main path calls it) against its plain version
    on the Gaussian stack of the detect batch ``gray`` (B, h, w), with
    each frame's true size ``true_hw`` for a mixed-size batch; two
    launches must agree bit for bit, and at least ``min_valid`` keypoints
    (default: half the budget) must be valid."""
    from drone_image_stitch_cpp_tpu_torch.ops.features import (
        build_scale_space, flat_gauss_stack, num_octaves, select_keypoints)
    from drone_image_stitch_cpp_tpu_torch.ops import sift_kernel as SK

    wh, ww = gray.shape[1:]
    sel = select_keypoints(gray, n_kp, true_hw=true_hw)
    kp = (sel.gauss_flat, sel.flat_layer, sel.yf, sel.xf, sel.sigma,
          sel.true_h, sel.true_w)
    flat = (sel.gauss_flat, sel.flat_layer.reshape(-1).contiguous(),
            *(a.reshape(-1).float().contiguous() for a in
              (sel.yf, sel.xf, sel.sigma, sel.true_h, sel.true_w)))
    ang_k, desc_k = SK.orientation_descriptor_flat(*kp)
    ang_k, desc_k = ang_k.reshape(-1), desc_k.reshape(-1, 128)
    ang_k2, desc_k2 = SK.orientation_descriptor_flat(*kp)
    ang_p, desc_p = SK.orientation_descriptor_plain(*flat)
    torch.cuda.synchronize()
    if not (torch.equal(ang_k, ang_k2.reshape(-1))
            and torch.equal(desc_k, desc_k2.reshape(-1, 128))):
        _fail("k1", f"{label}: two launches on the same input differ")
    v = sel.valid.reshape(-1)
    nv = int(v.sum())
    if not (torch.isfinite(ang_k).all() and torch.isfinite(desc_k).all()):
        _fail("k1", f"{label}: non-finite kernel output")
    if min_valid is None:
        min_valid = gray.shape[0] * n_kp // 2
    if nv < min_valid:
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
    b2b_ms = _device_ms(lambda: SK.orientation_descriptor_flat(*kp), torch)
    radius = SK.support_radius(flat[4])
    device_ms = _device_ms(lambda: SK._launch(flat[0], radius, *flat[1:]),
                           torch)
    plain_ms = _median_ms(lambda: SK.orientation_descriptor_plain(*flat),
                          torch)
    octs = build_scale_space(gray, 3, num_octaves(wh, ww, False), False)
    stack_ms = _median_ms(lambda: flat_gauss_stack(octs), torch)
    stack_mb = sel.gauss_flat.numel() * 4 / 1e6
    del octs
    bound_ms, bound_by, mb, gflop = _k1_bound(torch, *flat, ang_k)
    print(f"[smoke] k1 sift_orient_desc {label}: {nv} valid keypoints of "
          f"{v.numel()} on a {tuple(sel.gauss_flat.shape)} stack; "
          f"close (angle<0.02 rad, L2<2) {frac:.5f}; angle flips {flips}; "
          f"max L2 {worst:.4f}; max |d desc| {max_err:.4f}; two launches "
          f"bit-identical; wrapper {ms:.4f} ms ({b2b_ms:.4f} ms back to "
          f"back), device {device_ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"({mb:.1f} MB, {gflop:.3f} GFLOP), share "
          f"{bound_ms / device_ms:.3f}; padded-stack build {stack_ms:.4f} "
          f"ms ({stack_mb:.0f} MB)", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "wrapper_b2b_ms": b2b_ms,
            "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / device_ms, "stack_build_ms": stack_ms,
            "keypoints": v.numel()}


def phase_k1(torch, dev, imgs, tuning):
    """K1 at both detect resolutions of the main path: strip registration
    (1500 keypoints per frame) and grouping (the grouper's work size and
    feature budget, grouping/flight_grouper.estimate_relations)."""
    from drone_image_stitch_cpp_tpu_torch.grouping.flight_grouper import (
        _MAX_DIM)
    reg = _k1_check(torch, _k1_gray(torch, dev, imgs,
                                    tuning.registration_resol_mpx),
                    "registration", K1_KP)
    group_mpx = FRAME_H * FRAME_W * min(
        1.0, (_MAX_DIM / max(FRAME_H, FRAME_W)) ** 2) / 1e6
    group_kp = int(np.clip(tuning.strip_sift_features, 600, 1800))
    grp = _k1_check(torch, _k1_gray(torch, dev, imgs, group_mpx),
                    "grouping", group_kp)
    return {"name": "sift_orient_desc", "route": "cuda",
            "source": "drone_image_stitch_cpp_tpu_torch/csrc/"
                      "sift_orient_desc.cu",
            "replaces": "drone_image_stitch_cpp_tpu/ops/pallas_sift.py:308",
            **{k: reg[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "device_ms", "share", "wrapper_b2b_ms",
                                   "stack_build_ms")},
            "max_abs_err": max(reg["max_abs_err"], grp["max_abs_err"]),
            "library_ms": None, "grouping": grp}


def _k2_source_pixels(torch, dev, inv, h, w, oh, ow):
    """Source pixels that the bilinear taps of an (oh, ow) warp touch."""
    from drone_image_stitch_cpp_tpu_torch.ops.warp import dst_to_src_coords
    inv23 = torch.tensor(inv, dtype=torch.float32, device=dev).reshape(2, 3)
    sx, sy = dst_to_src_coords(inv23, oh, ow)
    x0, y0 = torch.floor(sx).long(), torch.floor(sy).long()
    touched = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            touched[yy[ok], xx[ok]] = True
    return int(touched.sum())


def _k2_library(torch, dev, frames_u8, invs, oh, ow):
    """F.grid_sample (bilinear, zeros, align_corners=True) on (N, 4, H, W)
    float32 (BGR + ones) with K2's sample grid; input and grid are built
    here, outside the timed call. Returns (ms, its (N, 4, oh, ow) output)."""
    import torch.nn.functional as F
    from drone_image_stitch_cpp_tpu_torch.ops.warp import dst_to_src_coords
    n, h, w = frames_u8.shape[:3]
    src = torch.cat([frames_u8.permute(0, 3, 1, 2).float(),
                     torch.ones((n, 1, h, w), device=dev)], dim=1)
    grids = []
    for inv in invs:
        inv23 = torch.tensor(inv, dtype=torch.float32,
                             device=dev).reshape(2, 3)
        sx, sy = dst_to_src_coords(inv23, oh, ow)
        grids.append(torch.stack([sx / (w - 1) * 2 - 1,
                                  sy / (h - 1) * 2 - 1], dim=-1))
    grid = torch.stack(grids)

    def call():
        return F.grid_sample(src, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    out = call()
    return _median_ms(call, torch), out


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
    inv = WK.inverse_coeffs(a23)
    wk, mk = WK.warp_frame(frame, a23, oh, ow)
    wp, mp = WK.warp_frame_plain(frame, inv, oh, ow)
    torch.cuda.synchronize()
    d = torch.cat([(wk - wp).abs().reshape(-1), (mk - mp).abs().reshape(-1)])
    max_err, mean_err = float(d.max()), float(d.mean())
    covered = float((mk >= 0.5).float().mean())
    if max_err > 0.5 or mean_err > 1e-3 or covered < 0.5:
        _fail("k2", f"max |d| {max_err} (<= 0.5), mean {mean_err} "
                    f"(<= 1e-3), covered {covered:.3f}")
    if not (torch.equal(wk, wp) and torch.equal(mk, mp)):
        _fail("k2", f"not bit-identical to the plain version (max |d| "
                    f"{max_err})")
    ms = _median_ms(lambda: WK.warp_frame(frame, a23, oh, ow), torch)
    b2b_ms = _device_ms(lambda: WK.warp_frame(frame, a23, oh, ow), torch)
    device_ms = _device_ms(lambda: WK._launch(frame, 1, inv, oh, ow), torch)
    plain_ms = _median_ms(lambda: WK.warp_frame_plain(frame, inv, oh, ow),
                          torch)
    library_ms, lib = _k2_library(torch, dev, frame[None], [inv], oh, ow)
    lib_err = float(torch.maximum(
        (lib[0, :3].permute(1, 2, 0) - wk).abs().max(),
        (lib[0, 3] - mk).abs().max()))
    del lib
    src_px = _k2_source_pixels(torch, dev, inv, FRAME_H, FRAME_W, oh, ow)
    bound_ms, bound_by = _bound(3.0 * src_px + 16.0 * oh * ow,
                                30.0 * oh * ow)
    print(f"[smoke] k2 warp_affine: {FRAME_H}x{FRAME_W} u8 -> {oh}x{ow}x3 "
          f"+ mask, window coverage {covered:.3f}; bit-identical to plain; "
          f"wrapper {ms:.4f} ms ({b2b_ms:.4f} ms back to back), device "
          f"{device_ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, grid_sample {library_ms:.4f} ms (max |d| "
          f"{lib_err:.3g}); bound {bound_ms:.4f} ms by {bound_by} "
          f"({(3.0 * src_px + 16.0 * oh * ow) / 1e6:.1f} MB), share "
          f"{bound_ms / device_ms:.3f}", flush=True)
    return {"name": "warp_affine", "route": "cuda",
            "source": "drone_image_stitch_cpp_tpu_torch/csrc/warp_affine.cu",
            "replaces": "drone_image_stitch_cpp_tpu/ops/pallas_warp.py:234",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": device_ms,
            "share": bound_ms / device_ms, "wrapper_b2b_ms": b2b_ms}


def phase_k2_batch(torch, dev, imgs, pos, tuning):
    """The batched K2 as the strip compose calls it: every frame of the
    line into the seam-scale canvas in one launch, each frame bit-equal to
    its plain warp."""
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    from drone_image_stitch_cpp_tpu_torch.ops.blend import align_up
    from drone_image_stitch_cpp_tpu_torch.ops.resize import (
        scale_for_megapixels)
    ys = [p[0] for p in pos]
    xs = [p[1] for p in pos]
    canvas_h = max(ys) - min(ys) + FRAME_H
    canvas_w = max(xs) - min(xs) + FRAME_W
    ss = scale_for_megapixels(FRAME_H, FRAME_W,
                              tuning.seam_estimation_resol_mpx)
    sh = align_up(int(round(canvas_h * ss)), 64)
    sw = align_up(int(round(canvas_w * ss)), 64)
    a23s = np.stack([np.asarray([[ss, 0, ss * (x - min(xs))],
                                 [0, ss, ss * (y - min(ys))]], np.float32)
                     for y, x in pos])
    frames = torch.from_numpy(np.stack(imgs)).to(dev)
    invs = [WK.inverse_coeffs(a) for a in a23s]
    wk, mk = WK.warp_frames(frames, a23s, sh, sw)
    for k in range(len(imgs)):
        wp, mp = WK.warp_frame_plain(frames[k], invs[k], sh, sw)
        if not (torch.equal(wk[k], wp) and torch.equal(mk[k], mp)):
            _fail("k2", f"seam batch: frame {k} differs from its plain warp")
    table = torch.tensor(invs, dtype=torch.float32, device=dev)
    ms = _median_ms(lambda: WK.warp_frames(frames, a23s, sh, sw), torch)
    device_ms = _device_ms(lambda: WK._launch(frames, len(imgs), table, sh,
                                              sw), torch)
    plain_ms = _median_ms(lambda: WK.warp_frames_plain(frames, invs, sh, sw),
                          torch)
    library_ms, lib = _k2_library(torch, dev, frames, invs, sh, sw)
    del lib
    src_px = sum(_k2_source_pixels(torch, dev, inv, FRAME_H, FRAME_W, sh,
                                   sw) for inv in invs)
    n_out = len(imgs) * sh * sw
    bound_ms, bound_by = _bound(3.0 * src_px + 16.0 * n_out, 30.0 * n_out)
    print(f"[smoke] k2 warp_affine seam batch: {len(imgs)} x {FRAME_H}x"
          f"{FRAME_W} u8 -> {sh}x{sw} (seam scale {ss:.4f}) in one launch, "
          f"every frame bit-identical to plain; wrapper {ms:.4f} ms, device "
          f"{device_ms:.4f} ms, plain {plain_ms:.3f} ms, grid_sample "
          f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by}, "
          f"share {bound_ms / device_ms:.3f}", flush=True)
    return {"shape": [len(imgs), sh, sw], "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / device_ms}


def phase_slice(torch, dev, ortho, imgs, ids, pos, tuning):
    from drone_image_stitch_cpp_tpu_torch.app import stitch_frames
    from drone_image_stitch_cpp_tpu_torch.ops.sift_kernel import (
        orientation_descriptor_flat)
    from drone_image_stitch_cpp_tpu_torch.ops.warp_kernel import (
        warp_frame, warp_frames)
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
    _zero_counts()
    t0 = time.perf_counter()
    res = stitch_frames(imgs, ids, tuning, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"sift_orient_desc": orientation_descriptor_flat.launches,
                "warp_affine": warp_frame.launches + warp_frames.launches}
    k2_split = (warp_frame.launches, warp_frames.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    tm = log.timings()
    stages = {k: tm.get(v) for k, v in (
        ("store", "frame store done"), ("grouping", "grouping done"),
        ("register", "register done"), ("seam_warps", "seam warps done"),
        ("gains", "gains done"), ("seams", "seams done"),
        ("blend", "blend done"), ("tiled_blend", "tiled blend done"),
        ("crop", "crop done"), ("stitch", "single-group stitch done"))}

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
          f"(max_memory_allocated), launches {launches} (K2: "
          f"{k2_split[0]} compose feeds + {k2_split[1]} seam batch)",
          flush=True)
    for name, n in launches.items():
        if n <= 0:
            _fail("slice", f"kernel {name} never launched on the main path")
    if k2_split[1] != 1:
        _fail("slice", f"seam warps took {k2_split[1]} batched launches, "
                       f"expected 1")
    return launches


def render_multiline(torch, dev):
    """The 3 x 10 boustrophedon sortie: 2160x3840 frames, overlaps 0.70
    along-track and 0.35 side, odd lines right to left."""
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import (
        fractal_ortho, render_sortie as render)
    t0 = time.perf_counter()
    ortho = fractal_ortho(ML_ORTHO_H, ORTHO_W, seed=0, device=dev)
    imgs, ids, pos = render(ortho, ML_ROWS, ML_COLS, FRAME_H, FRAME_W,
                            OVERLAP, overlap_y=ML_OVERLAP_Y)
    print(f"[smoke] multi-line sortie: {ML_ROWS} lines x {ML_COLS} frames "
          f"{FRAME_H}x{FRAME_W}, overlaps {OVERLAP}/{ML_OVERLAP_Y}, ortho "
          f"{ML_ORTHO_H}x{ORTHO_W}, rendered in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return ortho, imgs, ids, pos


def _ml_geometry(pos):
    """(step_y, union (h, w), union origin (y, x)) of the planted sortie."""
    ys = sorted({p[0] for p in pos})
    xs = [p[1] for p in pos]
    step_y = ys[1] - ys[0]
    return step_y, (ys[-1] - ys[0] + FRAME_H,
                    max(xs) - min(xs) + FRAME_W), (ys[0], min(xs))


def _padded_strip(torch, dev, ortho, pos, line):
    """Line ``line``'s planted strip panorama (the ortho under its frames)
    padded with black to the global stage's 512-snapped layout, as the
    global stage holds it: ((HP, WP, 3) uint8 device tensor, (h, w))."""
    from drone_image_stitch_cpp_tpu_torch.ops.blend import align_up
    step_y, (_, uw), (oy, ox) = _ml_geometry(pos)
    y0 = oy + line * step_y
    strip = np.clip(ortho[y0:y0 + FRAME_H, ox:ox + uw], 0, 255).astype(
        np.uint8)
    hp, wp = align_up(FRAME_H, 512), align_up(uw, 512)
    out = torch.zeros((hp, wp, 3), dtype=torch.uint8, device=dev)
    out[:FRAME_H, :uw] = torch.from_numpy(strip).to(dev)
    return out, (FRAME_H, uw)


def phase_k1_global(torch, padded, true_hw, tuning):
    """K1 at the global stage's strip detect: one padded strip's work
    image (<= 2800 px wide), the global feature budget, one launch."""
    from drone_image_stitch_cpp_tpu_torch.pipeline.global_ import (
        strip_work_image)
    work = strip_work_image(padded, true_hw)[0]
    return _k1_check(torch, work[None], "global detect",
                     tuning.global_sift_features,
                     min_valid=K1_GLOBAL_MIN_VALID)


def phase_k2_content(torch, dev, padded):
    """K2's content mode as the global compose calls it: a padded strip
    into the 5120x5120 tile window (a near-identity affine, the second
    line's offset), with crafted pixels of gray 2 and 3 planted in the
    strip; bit-equal to its plain version."""
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    from drone_image_stitch_cpp_tpu_torch.ops.color import content_mask
    src = padded.clone()
    # gray of (2, 2, 2) is exactly 2 (not content), of (3, 3, 3) 3; mixed
    # triples land on both sides of the threshold
    crafted = torch.tensor([[2, 2, 2], [3, 3, 3], [2, 3, 2], [1, 2, 3],
                            [3, 2, 1], [0, 4, 0], [17, 0, 0], [18, 0, 0]],
                           dtype=torch.uint8, device=dev)
    for k in range(crafted.shape[0]):
        src[100 + 40 * k:130 + 40 * k, 200:260 + 900 * k] = crafted[k]
    th = np.radians(0.05)
    c, s_ = np.cos(th), np.sin(th)
    a23 = np.asarray([[c, -s_, 0.37], [s_, c, 1404.61]], np.float32)
    oh, ow = K2_GLOBAL_WIN
    inv = WK.inverse_coeffs(a23)
    n0 = WK.warp_frame.nonblack_launches
    wk, mk = WK.warp_frame(src, a23, oh, ow, content="nonblack")
    if WK.warp_frame.nonblack_launches != n0 + 1:
        _fail("k2", "content mode did not count its launch")
    wp, mp = WK.warp_frame_plain(src, inv, oh, ow, content="nonblack")
    torch.cuda.synchronize()
    if not (torch.equal(wk, wp) and torch.equal(mk, mp)):
        d = float(torch.maximum((wk - wp).abs().max(),
                                (mk - mp).abs().max()))
        _fail("k2", f"content mode not bit-identical to plain (max |d| {d})")
    kept = float((mk >= 0.999).float().mean())
    ms = _median_ms(lambda: WK.warp_frame(src, a23, oh, ow,
                                          content="nonblack"), torch)
    device_ms = _device_ms(lambda: WK._launch(src, 1, inv, oh, ow,
                                              "nonblack"), torch)
    plain_ms = _median_ms(lambda: WK.warp_frame_plain(
        src, inv, oh, ow, content="nonblack"), torch)
    # grid_sample on BGR + the gray > 2 plane (made outside the timed call)
    import torch.nn.functional as F
    from drone_image_stitch_cpp_tpu_torch.ops.warp import dst_to_src_coords
    h, w = src.shape[:2]
    planes = torch.cat([src.permute(2, 0, 1).float(),
                        content_mask(src).float()[None]])[None]
    sx, sy = dst_to_src_coords(torch.tensor(inv, dtype=torch.float32,
                                            device=dev).reshape(2, 3), oh, ow)
    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1],
                       dim=-1)[None]
    library_ms = _median_ms(lambda: F.grid_sample(
        planes, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), torch)
    del planes, grid, sx, sy
    src_px = _k2_source_pixels(torch, dev, inv, h, w, oh, ow)
    n_bytes = 3.0 * src_px + 16.0 * oh * ow
    bound_ms, bound_by = _bound(n_bytes, 54.0 * oh * ow)
    print(f"[smoke] k2 warp_affine content mode: {h}x{w} u8 padded strip "
          f"-> {oh}x{ow}x3 + gray>2 mask, kept (>=0.999) {kept:.3f}; "
          f"bit-identical to plain (crafted gray-2/3 pixels included); "
          f"wrapper {ms:.4f} ms, device {device_ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, grid_sample {library_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e6:.1f} MB), share "
          f"{bound_ms / device_ms:.3f}", flush=True)
    return {"shape": [h, w, oh, ow], "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / device_ms, "max_abs_err": 0.0}


def _counts():
    from drone_image_stitch_cpp_tpu_torch.ops.sift_kernel import (
        orientation_descriptor_flat)
    from drone_image_stitch_cpp_tpu_torch.ops.warp_kernel import (
        warp_frame, warp_frames)
    return {"sift_orient_desc": orientation_descriptor_flat.launches,
            "warp_affine": warp_frame.launches + warp_frames.launches,
            "warp_affine_nonblack": warp_frame.nonblack_launches}


def _zero_counts():
    from drone_image_stitch_cpp_tpu_torch.ops.sift_kernel import (
        orientation_descriptor_flat)
    from drone_image_stitch_cpp_tpu_torch.ops.warp_kernel import (
        warp_frame, warp_frames)
    orientation_descriptor_flat.launches = 0
    orientation_descriptor_flat.mixed_launches = 0
    warp_frame.launches = 0
    warp_frame.nonblack_launches = 0
    warp_frames.launches = 0


def phase_multiline(torch, dev, ortho, imgs, ids, pos, tuning, first):
    """The multi-line main path through app.stitch_frames, measured pass
    (the production phase's run before it is the warm-up: ``first`` holds
    its wall and its strips as the global stage received them, host
    copies); hard checks as the module doc lists."""
    from drone_image_stitch_cpp_tpu_torch import app as A
    from drone_image_stitch_cpp_tpu_torch.runtime.handoff import DeviceStrip
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
    from drone_image_stitch_cpp_tpu_torch.utils.native import (
        graphcut_library)
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

    log = get_logger()
    log.verbose = False
    step_y, (gt_h, gt_w), (oy, ox) = _ml_geometry(pos)
    real_global = A.stitch_inter_strips_custom
    seen = {}

    def global_probe(strips, *a, **kw):
        # how many strips reach the global stage on the device, and the
        # kernel launches the stage makes
        seen["device_strips"] = sum(isinstance(st, DeviceStrip)
                                    for st in strips)
        before = _counts()
        out = real_global(strips, *a, **kw)
        after = _counts()
        seen["global_launches"] = {k: after[k] - before[k] for k in after}
        return out

    A.stitch_inter_strips_custom = global_probe
    try:
        cold = first["seconds"]
        strip_rmse = []
        for k, st in enumerate(first["strips"]):
            y0 = oy + k * step_y
            gt = np.clip(ortho[y0:y0 + FRAME_H, ox:ox + gt_w], 0,
                         255).astype(np.uint8)
            strip_rmse.append(round(gt_rmse(st, gt, device=dev)[0], 4))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        mark = len(log._records)
        _zero_counts()
        t0 = time.perf_counter()
        res = A.stitch_frames(imgs, ids, tuning, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
    finally:
        A.stitch_inter_strips_custom = real_global
    peak = torch.cuda.max_memory_allocated(dev)
    stages = {}
    for r in log._records[mark:]:
        if "seconds" in r:
            stages[f"{r['stage']}/{r['msg'][:-5]}"] = r["seconds"]

    sizes = [g.indices for g in res.groups]
    want = [list(range(k * ML_COLS, (k + 1) * ML_COLS))
            for k in range(ML_ROWS)]
    if sizes != want:
        _fail("multiline", f"groups {sizes}, expected {want}")
    if any(res.flipped):
        _fail("multiline", f"flipped {res.flipped}")
    offs = np.asarray([t[:2, 2] for t in res.global_transforms], np.float64)
    exp = np.asarray([(0.0, k * step_y) for k in range(ML_ROWS)])
    off_err = float(np.abs(offs - exp).max())
    lin_err = float(max(np.abs(t[:2, :2] - np.eye(2)).max()
                        for t in res.global_transforms))
    if off_err > ML_STRIP_TOL_PX:
        _fail("multiline", f"strip offsets {offs.tolist()} off the planted "
                           f"{exp.tolist()} by {off_err:.3f} px")
    pano = res.panorama
    if abs(pano.shape[0] - gt_h) > ML_SIZE_TOL_PX or \
            abs(pano.shape[1] - gt_w) > ML_SIZE_TOL_PX:
        _fail("multiline", f"mosaic {pano.shape[:2]} vs ground truth "
                           f"{(gt_h, gt_w)}")
    gt = np.clip(ortho[oy:oy + gt_h, ox:ox + gt_w], 0, 255).astype(np.uint8)
    rmse, dy, dx = gt_rmse(pano, gt, device=dev)
    if not np.isfinite(rmse) or rmse > GT_RMSE_MAX:
        _fail("multiline", f"GT-RMSE {rmse} > {GT_RMSE_MAX} (per strip "
                           f"{strip_rmse})")
    gl = seen["global_launches"]
    if gl["sift_orient_desc"] <= 0:
        _fail("multiline", "K1 was not launched by the global stage")
    if launches["warp_affine_nonblack"] <= 0:
        _fail("multiline", "K2's content mode was never launched")
    pairs = {(i, i + 1): res.seam_methods.get((i, i + 1))
             for i in range(ML_ROWS - 1)}
    solver = graphcut_library()
    if any(m != "graphcut" for m in pairs.values()):
        _fail("multiline", f"adjacent strip pairs not cut by the graph-cut "
                           f"solver: {pairs} (solver library: {solver})")
    print(f"[smoke] multiline: groups {[len(g) for g in sizes]}, flipped "
          f"{res.flipped}, strip offsets {np.round(offs, 3).tolist()} "
          f"(max error {off_err:.4f} px, max |linear - I| {lin_err:.2e}), "
          f"mosaic {pano.shape[0]}x{pano.shape[1]} (gt {gt_h}x{gt_w}), "
          f"GT-RMSE {rmse:.4f} at shift ({dy},{dx}), per strip "
          f"{strip_rmse}, device strips {seen['device_strips']} of "
          f"{ML_ROWS}; seams {pairs} (solver {os.path.relpath(solver)}); "
          f"wall {wall:.2f} s (first pass, the production run "
          f"{cold:.2f} s)", flush=True)
    print("[smoke] multiline stages (s): " + ", ".join(
        f"{k}={v}" for k, v in stages.items()), flush=True)
    print(f"[smoke] multiline peak memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated), launches {launches} (global stage: "
          f"{gl})", flush=True)
    for name in ("sift_orient_desc", "warp_affine"):
        if launches[name] <= 0:
            _fail("multiline", f"kernel {name} never launched")
    return launches


def _counts_all():
    """Every launch counter, with K1's mixed-size launches."""
    from drone_image_stitch_cpp_tpu_torch.ops.sift_kernel import (
        orientation_descriptor_flat)
    return {**_counts(),
            "sift_orient_desc_mixed": orientation_descriptor_flat.mixed_launches}


def phase_fallback(torch, dev, ortho, imgs, pos, tuning):
    """The sequential ladder on the first FB_FRAMES corridor frames with
    the joint registration forced to fail; then a non-overlapping pair;
    then K1 at the ladder's mixed-size batch."""
    import drone_image_stitch_cpp_tpu_torch.ops.features as TF
    import drone_image_stitch_cpp_tpu_torch.pipeline.strip as TS
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

    log = get_logger()
    frames = imgs[:FB_FRAMES]
    st = tuning.replace(sift_features=tuning.strip_sift_features)
    real_est = TS.estimate_strip_transforms
    real_det = TF.detect_and_describe_batched
    mixed = {}

    def est(images, *a, **kw):
        if images is not None and len(images) > 2:
            raise TS.StripStitchError("joint registration forced to fail "
                                      "(smoke)")
        return real_est(images, *a, **kw)

    def det(grays, max_kp, *a, true_hw=None, **kw):
        out = real_det(grays, max_kp, *a, true_hw=true_hw, **kw)
        if true_hw is not None:     # keep the ladder's last mixed batch
            mixed.update(gray=grays.clone(), true_hw=true_hw.clone(),
                         n_kp=max_kp, valid=int(out.valid.sum()))
        return out

    TS.estimate_strip_transforms, TF.detect_and_describe_batched = est, det
    info = {}
    try:
        _zero_counts()
        t0 = time.perf_counter()
        pano = TS.stitch_strip(frames, st, stage="Fallback", device=dev,
                               info=info)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts_all()
    finally:
        TS.estimate_strip_transforms = real_est
        TF.detect_and_describe_batched = real_det
    if info.get("path") != "sequential":
        _fail("fallback", f"the ladder did not run (path {info.get('path')})")
    gt_h = FRAME_H
    gt_w = FRAME_W + (FB_FRAMES - 1) * (pos[1][1] - pos[0][1])
    if abs(pano.shape[0] - gt_h) > FB_SIZE_TOL_PX or \
            abs(pano.shape[1] - gt_w) > FB_SIZE_TOL_PX:
        _fail("fallback", f"panorama {pano.shape[:2]} vs planted "
                          f"{(gt_h, gt_w)}")
    y0, x0 = pos[0]
    gt = np.clip(ortho[y0:y0 + gt_h, x0:x0 + gt_w], 0, 255).astype(np.uint8)
    rmse, dy, dx = gt_rmse(pano, gt, device=dev)
    if not np.isfinite(rmse) or rmse > GT_RMSE_MAX:
        _fail("fallback", f"GT-RMSE {rmse} > {GT_RMSE_MAX}")
    if launches["sift_orient_desc_mixed"] <= 0 or not mixed:
        _fail("fallback", f"K1 never launched on a mixed-size batch "
                          f"({launches})")
    if launches["warp_affine"] <= 0:
        _fail("fallback", f"K2 never launched ({launches})")
    print(f"[smoke] fallback: {FB_FRAMES} frames {FRAME_H}x{FRAME_W} through "
          f"the sequential ladder (joint forced to fail), panorama "
          f"{pano.shape[0]}x{pano.shape[1]} (planted {gt_h}x{gt_w}), GT-RMSE "
          f"{rmse:.4f} at shift ({dy},{dx}), wall {wall:.2f} s, launches "
          f"{launches}", flush=True)

    # a non-overlapping pair fails every rung, with a diagnostics record
    a = np.clip(ortho[0:FRAME_H, 0:FRAME_W], 0, 255).astype(np.uint8)
    xb = ortho.shape[1] - FRAME_W          # the corridor's far end
    b = np.clip(ortho[100:100 + FRAME_H, xb:xb + FRAME_W], 0,
                255).astype(np.uint8)
    n0 = len(log._records)
    try:
        TS.stitch_strip([a, b], st, stage="FallbackPair", device=dev)
        _fail("fallback", "a non-overlapping pair stitched")
    except TS.StripStitchError as e:
        recs = [r for r in log._records[n0:]
                if r["msg"] == "failure diagnostics"
                and r["stage"] == "FallbackPair/seq1"]
        fields = ("left", "right", "kp_left", "kp_right", "good_matches",
                  "model")
        if not recs or any(f not in recs[-1] for f in fields):
            _fail("fallback", f"no diagnostics record for the pair ({e})")
        print(f"[smoke] fallback pair: StripStitchError '{e}'; diagnostics "
              + ", ".join(f"{f}={recs[-1][f]}" for f in fields[2:]),
              flush=True)

    # K1 at the ladder's mixed-size batch (the last one it detected; the
    # mosaic sets the work scale, so its frames hold fewer keypoints than
    # the budget: the floor is what the ladder's own detect found)
    thw = mixed["true_hw"]
    k1 = _k1_check(torch, mixed["gray"], "fallback mixed-size batch "
                   f"(true sizes {thw.round().int().tolist()})",
                   mixed["n_kp"], min_valid=mixed["valid"], true_hw=thw)
    k1["shape"] = list(mixed["gray"].shape)
    return launches, k1


class _RowSink:
    """The StreamedMosaicWriter protocol in memory: checks that the bands
    arrive in order and cover the canvas, and keeps the canvas."""

    def __init__(self):
        self.crop = self.canvas = None
        self.next_y = self.bands = 0
        self.done = False

    def begin(self, canvas_h, canvas_w, crop):
        self.crop = crop
        self.canvas = np.zeros((canvas_h, canvas_w, 3), np.uint8)

    def on_rows(self, y0, y1, rows):
        if y0 != self.next_y or y1 <= y0:
            _fail("production", f"row band ({y0}, {y1}) out of order "
                                f"(next row {self.next_y})")
        self.canvas[y0:y1] = rows
        self.next_y = y1
        self.bands += 1

    def finish(self):
        if self.next_y != self.canvas.shape[0]:
            _fail("production", f"bands stop at row {self.next_y} of "
                                f"{self.canvas.shape[0]}")
        self.done = True
        y0, y1, x0, x1 = self.crop
        return y1 - y0, x1 - x0

    def abort(self):
        pass


def _content_box(img):
    """Exact autocrop box (y0, y1, x0, x1) of a uint8 BGR image: the
    fixed-point gray > 1 test of ops/blend.content_flags."""
    x = img.astype(np.int32)
    c = ((29 * x[..., 0] + 150 * x[..., 1] + 77 * x[..., 2] + 128) >> 8) > 1
    r, k = np.flatnonzero(c.any(axis=1)), np.flatnonzero(c.any(axis=0))
    return int(r[0]), int(r[-1]) + 1, int(k[0]), int(k[-1]) + 1


def phase_production(torch, dev, ortho, imgs, ids, pos, tuning, work):
    """The production run in process: strips checkpointed by a
    BackgroundWriter while the next strip stitches, the global stage into
    a row sink, then a resume from the checkpoint that must give the same
    mosaic. It is the multi-line path's first pass: returns (launches,
    {"seconds": its stitch_frames wall, "strips": the host strips})."""
    from drone_image_stitch_cpp_tpu_torch.app import (global_tuning,
                                                      stitch_frames)
    from drone_image_stitch_cpp_tpu_torch.pipeline.global_ import (
        stitch_inter_strips_custom)
    from drone_image_stitch_cpp_tpu_torch.runtime.checkpoint import (
        load_strip_checkpoint, save_strip_checkpoint)
    from drone_image_stitch_cpp_tpu_torch.runtime.handoff import (
        DeviceStrip, as_host_strips)
    from drone_image_stitch_cpp_tpu_torch.runtime.writer import (
        BackgroundWriter)
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

    ckpt = os.path.join(work, "strips")
    writer = BackgroundWriter()
    done, jobs, strip_end = [], [], []

    def timed(fn):
        def run():
            t0 = time.perf_counter()
            fn()
            jobs.append((t0, time.perf_counter()))
        return run

    def on_strip(gi, pano, last):
        strip_end.append(time.perf_counter())
        done.append(pano)
        if isinstance(pano, DeviceStrip):
            writer.submit(timed(pano.host))
        if last:
            writer.submit(timed(lambda: save_strip_checkpoint(
                ckpt, as_host_strips(done))))

    sink = _RowSink()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    res = stitch_frames(imgs, ids, tuning, dev, on_strip=on_strip,
                        row_sink=sink)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = _counts()
    writer.join()
    drain = time.perf_counter() - t_end
    peak = torch.cuda.max_memory_allocated(dev)
    # writer time during the later strips' stitches, during the global
    # stage, and the drain left after it
    busy = sum(b - a for a, b in jobs)
    in_strips = sum(max(0.0, min(b, strip_end[-1]) - a) for a, b in jobs)
    in_global = sum(max(0.0, min(b, t_end) - max(a, strip_end[-1]))
                    for a, b in jobs)

    sizes = [g.indices for g in res.groups]
    want = [list(range(k * ML_COLS, (k + 1) * ML_COLS))
            for k in range(ML_ROWS)]
    if sizes != want:
        _fail("production", f"groups {sizes}, expected {want}")
    if not sink.done or sink.bands < 2:
        _fail("production", f"row sink not driven (done {sink.done}, bands "
                            f"{sink.bands})")
    box = _content_box(sink.canvas)
    cy0, cy1, cx0, cx1 = sink.crop
    if not (cy0 <= box[0] and box[1] <= cy1 and cx0 <= box[2]
            and box[3] <= cx1):
        _fail("production", f"sink crop {sink.crop} does not hold the "
                            f"exact box {box}")
    if not np.array_equal(sink.canvas[box[0]:box[1], box[2]:box[3]],
                          res.panorama):
        _fail("production", "the sink's canvas, cropped, is not the mosaic")
    step_y, (gt_h, gt_w), (oy, ox) = _ml_geometry(pos)
    gt = np.clip(ortho[oy:oy + gt_h, ox:ox + gt_w], 0, 255).astype(np.uint8)
    rmse, dy, dx = gt_rmse(res.panorama, gt, device=dev)
    if not np.isfinite(rmse) or rmse > GT_RMSE_MAX:
        _fail("production", f"GT-RMSE {rmse} > {GT_RMSE_MAX}")

    # resume: the global stage from the checkpoint alone
    t1 = time.perf_counter()
    strips = load_strip_checkpoint(ckpt)
    if strips is None or len(strips) != ML_ROWS:
        _fail("production", "no complete strip checkpoint")
    sink2 = _RowSink()
    mosaic2 = stitch_inter_strips_custom(strips, global_tuning(tuning),
                                         device=dev, row_sink=sink2)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t1
    same = (mosaic2.shape == res.panorama.shape
            and np.array_equal(mosaic2, res.panorama))
    if not same or not np.array_equal(sink2.canvas, sink.canvas):
        d = (np.abs(mosaic2.astype(np.int16) - res.panorama.astype(np.int16))
             .max() if mosaic2.shape == res.panorama.shape else "shape")
        _fail("production", f"resumed mosaic differs from the straight run "
                            f"({mosaic2.shape} vs {res.panorama.shape}, max "
                            f"|d| {d})")
    print(f"[smoke] production: groups {[len(g) for g in sizes]}, device "
          f"strips {sum(isinstance(p, DeviceStrip) for p in done)} of "
          f"{ML_ROWS}, mosaic "
          f"{res.panorama.shape[0]}x{res.panorama.shape[1]} (gt {gt_h}x"
          f"{gt_w}), GT-RMSE {rmse:.4f} at shift ({dy},{dx}); row sink "
          f"{sink.bands} bands in order, crop {sink.crop} holds the exact "
          f"box {box}; stitch_frames {t_end - t0:.2f} s, peak "
          f"{peak / 2**30:.3f} GiB, launches {launches}; strip writer "
          f"{len(jobs)} jobs busy {busy:.3f} s: {in_strips:.3f} s during "
          f"the later strips, {in_global:.3f} s during the global stage, "
          f"drain after it {drain:.3f} s; resume (checkpoint load + global "
          f"stage) {resume_s:.2f} s, mosaic and bands equal to the "
          f"straight run", flush=True)
    return launches, {"seconds": t_end - t0, "strips": strips}


def _cli(args, log_path):
    """One CLI run in a child process: (rc, seconds, JSONL records)."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "drone_image_stitch_cpp_tpu_torch.cli.main",
         "--device", "cuda", "--log-jsonl", log_path, *args],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    recs = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
    if r.returncode != 0:
        tail = (r.stdout + r.stderr).strip().splitlines()[-12:]
        _fail("production", f"CLI {args[-1:]} rc={r.returncode}: "
                            + " | ".join(tail))
    return wall, recs


def _rec(recs, msg, key="seconds"):
    return next((r.get(key) for r in recs if r["msg"] == msg), None)


def phase_production_cli(ortho, imgs, pos, work):
    """The CLI on the production sortie's JPEGs, then --resume."""
    import resource

    from drone_image_stitch_cpp_tpu_torch.app import write_image
    from drone_image_stitch_cpp_tpu_torch.runtime.loader import decode_all
    from drone_image_stitch_cpp_tpu_torch.utils.native import (
        jpeg_codec_error)
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse
    import importlib.util

    codec = jpeg_codec_error() is None
    has_cv2 = importlib.util.find_spec("cv2") is not None
    if not codec and not has_cv2:
        print(f"[smoke] production cli: skipped, no JPEG encoder here (codec "
              f"not built: {jpeg_codec_error()}; no cv2)", flush=True)
        return
    # the first CLI_COLS frames of each line (along-track), in flight order
    x_min = min(x for _, x in pos)
    step_x = int(FRAME_W * (1 - OVERLAP))
    keep = [i for i, (_, x) in enumerate(pos)
            if x - x_min < CLI_COLS * step_x]
    imgs, pos = [imgs[i] for i in keep], [pos[i] for i in keep]
    folder = os.path.join(work, "in", "visible", "run")
    t0 = time.perf_counter()
    for k, im in enumerate(imgs):
        write_image(os.path.join(folder, f"IMG{k:03d}_x.jpg"), im)
    enc_s = time.perf_counter() - t0
    out = os.path.join(work, "out")
    args = ["--image-folder", os.path.join(work, "in"), "--image-type",
            "visible", "--group", "run", "--output-root", out]
    wall, recs = _cli(args, os.path.join(work, "run.jsonl"))
    rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 2**20
    odir = os.path.join(out, "visible", "run")
    pano_path = os.path.join(odir, "visible_run_uav_panorama.jpg")
    names = sorted(os.listdir(os.path.join(odir, "strips")))
    want = (["checkpoint.json"] + [f"strip_{k:02d}.{e}" for k in
                                   range(ML_ROWS) for e in ("jpg", "npy")])
    if names != sorted(want):
        _fail("production", f"strips/ holds {names}")
    streamed = _rec(recs, "wrote", "streamed")
    if codec and not streamed:
        _fail("production", "the codec built but the mosaic was not "
                            "streamed")
    with open(pano_path, "rb") as f:
        first = f.read()
    pano = decode_all([pano_path])[0]
    step_y, (gt_h, gt_w), (oy, ox) = _ml_geometry(pos)
    gt = np.clip(ortho[oy:oy + gt_h, ox:ox + gt_w], 0, 255).astype(np.uint8)
    rmse, dy, dx = gt_rmse(pano, gt, search=12)
    if not np.isfinite(rmse) or rmse > GT_RMSE_MAX:
        _fail("production", f"CLI panorama GT-RMSE {rmse} > {GT_RMSE_MAX}")
    wall2, recs2 = _cli(args + ["--resume"], os.path.join(work,
                                                          "resume.jsonl"))
    if _rec(recs2, "resuming global stage from checkpoint", "strips") \
            != ML_ROWS:
        _fail("production", "the --resume run did not resume")
    with open(pano_path, "rb") as f:
        second = f.read()
    if not np.array_equal(decode_all([pano_path])[0], pano):
        _fail("production", "the --resume panorama differs from the "
                            "straight run's")
    print(f"[smoke] production cli: {ML_ROWS} lines x {CLI_COLS} frames "
          f"{FRAME_H}x{FRAME_W} (each line cut from {ML_COLS} for time), "
          f"{len(imgs)} frames encoded with "
          f"{'cv2' if has_cv2 else 'the codec'} in {enc_s:.2f} s; run rc 0 in "
          f"{wall:.2f} s (streaming decode "
          f"{_rec(recs, 'streaming decode', 'decode_seconds')} s of decode "
          f"thread, grouping {_rec(recs, 'grouping done')} s, global compose "
          f"{_rec(recs, 'global compose done')} s, strip-save drain "
          f"{_rec(recs, 'strip-save drain done')} s, "
          + (f"streamed write encode "
             f"{_rec(recs, 'streamed mosaic written', 'encode_seconds')} s, "
             f"finish wait "
             f"{_rec(recs, 'streamed mosaic written', 'finish_wait_seconds')}"
             f" s" if streamed else
             f"write after the blend {_rec(recs, 'write done')} s (no "
             f"streamed write)")
          + f"), panorama {pano.shape[0]}x{pano.shape[1]} GT-RMSE "
          f"{rmse:.4f} at shift ({dy},{dx}); --resume rc 0 in {wall2:.2f} s "
          f"(global compose {_rec(recs2, 'global compose done')} s), decoded "
          f"panorama equal, file bytes equal {first == second}; children's "
          f"peak RSS {rss:.2f} GiB", flush=True)


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
    ptxas = phase_build()
    tuning = load_stitch_tuning("visible")
    ortho, imgs, ids, pos = render_sortie(torch, dev)
    k1 = phase_k1(torch, dev, imgs, tuning)
    k2 = phase_k2(torch, dev, imgs[len(imgs) // 2])
    k2["seam_batch"] = phase_k2_batch(torch, dev, imgs, pos, tuning)
    torch.cuda.empty_cache()
    _zero_counts()
    launches = phase_slice(torch, dev, ortho, imgs, ids, pos, tuning)
    torch.cuda.empty_cache()
    fb_launches, k1["fallback_mixed"] = phase_fallback(torch, dev, ortho,
                                                       imgs, pos, tuning)
    torch.cuda.empty_cache()
    del ortho, imgs, ids, pos
    ml_ortho, ml_imgs, ml_ids, ml_pos = render_multiline(torch, dev)
    padded, true_hw = _padded_strip(torch, dev, ml_ortho, ml_pos, 1)
    k1["global_detect"] = phase_k1_global(torch, padded, true_hw, tuning)
    k2["content_mode"] = phase_k2_content(torch, dev, padded)
    del padded
    torch.cuda.empty_cache()
    # the production run takes the multi-line sortie and is that path's
    # first pass; the multi-line phase measures the second
    work = tempfile.mkdtemp(prefix="smoke_production_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        pr_launches, first = phase_production(
            torch, dev, ml_ortho, ml_imgs, ml_ids, ml_pos, tuning, work)
        torch.cuda.empty_cache()
        ml_launches = phase_multiline(torch, dev, ml_ortho, ml_imgs, ml_ids,
                                      ml_pos, tuning, first)
        del first
        torch.cuda.empty_cache()
        phase_production_cli(ml_ortho, ml_imgs, ml_pos, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del ml_ortho, ml_imgs
    paths = {"single_line": launches, "multi_line": ml_launches,
             "fallback": fb_launches, "production": pr_launches}
    k1["launches"] = sum(c["sift_orient_desc"] for c in paths.values())
    k2["launches"] = sum(c["warp_affine"] for c in paths.values())
    k1["launches_by_path"] = {
        **{p: c["sift_orient_desc"] for p, c in paths.items()},
        "fallback_mixed_size": fb_launches["sift_orient_desc_mixed"]}
    k2["launches_by_path"] = {
        **{p: c["warp_affine"] for p, c in paths.items()},
        "multi_line_content_mode": ml_launches["warp_affine_nonblack"],
        "production_content_mode": pr_launches["warp_affine_nonblack"]}
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            k1["global_detect"]["max_abs_err"],
                            k1["fallback_mixed"]["max_abs_err"])
    for d in (k1, k2):
        d["registers"], d["spill_bytes"] = ptxas[d["source"].split("/")[-1]]
        d["card"] = card
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "share", "device_ms")
    print(card)
    print(json.dumps({"kernels": [
        {**{k: d[k] for k in order},
         **{k: v for k, v in d.items() if k not in order}}
        for d in (k1, k2)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
