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
     0.70 along-track, 0.35 side), once to warm up and once measured:
     groups, no flips, strip offsets within 2 px, mosaic size within 8 px,
     GT-RMSE (and per strip), graph-cut seams on every adjacent strip pair,
     K1 launched by the global stage and K2's content mode launched;
  6. optional: the port's CLI on a 4-frame JPEG folder, when this machine
     can encode JPEGs (run in child processes; reported, not required).
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
    return card


def phase_build() -> dict:
    """Build both kernels, one nvcc each, started together; returns each
    source's (registers, spill bytes) as ptxas reports them."""
    from drone_image_stitch_cpp_tpu_torch.ops import sift_kernel as SK
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    from drone_image_stitch_cpp_tpu_torch.runtime.kernels import load_kernels

    t0 = time.perf_counter()
    mods = (SK, WK)
    built = load_kernels({m.KERNEL_SOURCE: m.KERNEL_SIGNATURES
                          for m in mods})
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


def _k1_check(torch, gray, label, n_kp, min_valid=None):
    """K1's wrapper (as the main path calls it) against its plain version
    on the Gaussian stack of the detect batch ``gray`` (B, h, w); two
    launches must agree bit for bit, and at least ``min_valid`` keypoints
    (default: half the budget) must be valid."""
    from drone_image_stitch_cpp_tpu_torch.ops.features import (
        build_scale_space, flat_gauss_stack, num_octaves, select_keypoints)
    from drone_image_stitch_cpp_tpu_torch.ops import sift_kernel as SK

    wh, ww = gray.shape[1:]
    sel = select_keypoints(gray, n_kp)
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
    warp_frame.launches = 0
    warp_frame.nonblack_launches = 0
    warp_frames.launches = 0


def phase_multiline(torch, dev, ortho, imgs, ids, pos, tuning):
    """The multi-line main path through app.stitch_frames, warm-up pass
    then measured pass; hard checks as the module doc lists."""
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
        # the strips as the global stage receives them (host copies only
        # in the warm-up pass), and the kernel launches the stage makes
        if seen.get("want_strips"):
            seen["strips"] = [st.host() if isinstance(st, DeviceStrip)
                              else st for st in strips]
            seen["device_strips"] = sum(isinstance(st, DeviceStrip)
                                        for st in strips)
        before = _counts()
        out = real_global(strips, *a, **kw)
        after = _counts()
        seen["global_launches"] = {k: after[k] - before[k] for k in after}
        return out

    A.stitch_inter_strips_custom = global_probe
    try:
        seen["want_strips"] = True
        t0 = time.perf_counter()
        A.stitch_frames(imgs, ids, tuning, dev)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        seen["want_strips"] = False
        strip_rmse = []
        for k, st in enumerate(seen.pop("strips")):
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
          f"wall {wall:.2f} s (first pass "
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
    cli_imgs = imgs[:4]
    del ortho, imgs, ids, pos
    ml_ortho, ml_imgs, ml_ids, ml_pos = render_multiline(torch, dev)
    padded, true_hw = _padded_strip(torch, dev, ml_ortho, ml_pos, 1)
    k1["global_detect"] = phase_k1_global(torch, padded, true_hw, tuning)
    k2["content_mode"] = phase_k2_content(torch, dev, padded)
    del padded
    torch.cuda.empty_cache()
    ml_launches = phase_multiline(torch, dev, ml_ortho, ml_imgs, ml_ids,
                                  ml_pos, tuning)
    del ml_ortho, ml_imgs
    torch.cuda.empty_cache()
    phase_cli(cli_imgs)
    k1["launches"] = (launches["sift_orient_desc"]
                      + ml_launches["sift_orient_desc"])
    k2["launches"] = launches["warp_affine"] + ml_launches["warp_affine"]
    k1["launches_by_path"] = {
        "single_line": launches["sift_orient_desc"],
        "multi_line": ml_launches["sift_orient_desc"]}
    k2["launches_by_path"] = {
        "single_line": launches["warp_affine"],
        "multi_line": ml_launches["warp_affine"],
        "multi_line_content_mode": ml_launches["warp_affine_nonblack"]}
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            k1["global_detect"]["max_abs_err"])
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
    if len(sys.argv) == 4 and sys.argv[1] == "--write-jpegs":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(_child_write_jpegs(sys.argv[2], sys.argv[3]))
    sys.exit(main())
