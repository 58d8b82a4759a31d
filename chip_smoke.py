"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits nonzero and prints no result):
  1. environment: torch/CUDA/nvcc versions, the card's name and power limit;
  2. build every CUDA kernel from csrc/ (build/kernels/, keyed by source;
     one nvcc per source, all started together), with ptxas's registers
     and spills;
 2a. throughput (on the empty card): the JAX repo's bench.py through its
     port, drone_image_stitch_cpp_tpu_torch/tools/bench_throughput, at its
     full sizes (8 gray 2160x3840 crops of synthetic_ortho seed 3, the
     0.45 MP work size padded to 512x896, 2200 features, 7 pairs of match
     + similarity RANSAC as one batch, 7 full-4K single-plane warps by the
     work-resolution models in one launch, models inverted on the card)
     and its OpenCV baseline on this host's cores. Hard checks: every pair
     succeeds, each model's translation within 0.5 work px of the planted
     (-256 s, -64 s), one batch launches K1 once and K2's single-plane
     form once, its warp stage makes no host sync (sync debug mode). It
     prints the stage times, the queued x5 time, each stage's
     synchronising calls, frames/s and vs_baseline. Then K2's single-plane
     form for one frame and the 7-frame batch on the bench's frames and
     device models, a strided slice of the (N, 3, 3) models as the bench
     passes them (the kernel's in-kernel inverse first, bit-equal to
     inverse_coeffs on 10,200 affines; one call must be ONE device
     operation, the kernel, by torch.profiler; the wrapper and both
     routes, staged boxes and the direct gather, bit-equal to the plain
     version; wrapper, each route's device time in turns, plain and
     F.grid_sample times, bound, each route's share) and K1
     at the bench's detect shape (8 x 2200 keypoints on a (192, 512, 896)
     stack, at least TP_K1_MIN_VALID valid);
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
     around 20 back-to-back launches / 20, median of 5: the host's launch
     pace where that is slower than the kernel), the kernel's own
     duration (kernel_ms: the median of torch.profiler's durations of the
     kernel over 20 launches in one trace, whose durations must add up to
     no more than the CUDA events time around the same launches; the
     smoke fails when three traces in a row do not hold them; the share
     is taken from it)
     and, for K2, one F.grid_sample call on the same input (library_ms, a
     yardstick the port never calls). K2's gather kernel counts its tiles
     by route (zero, direct) on every uint8, float32 and per-tap I420 row,
     and the row fails when the counts contradict the launch's plan; the
     float32 row holds the wrapper's launch (the coefficients of the
     kernel library's host inverse) bit-equal to plain with its tiles as
     planned, and times the wrapper and F.grid_sample in turns;
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
     K1 launched by the global stage and K2's content mode launched.
     Then the pass's seam problems, each solved by csrc/maxflow.cu in the
     pass, contracted on the card once and run by the kernel and by its
     plain rounds on that same ribbon: equal sides, rounds and relabels,
     the labels the pass's and the host engine's (or a tie: float64 cut
     values within 1e-6), one launch a batch of rounds in the pass; and
     the pass's DP seam costs, each csrc/dp_seam.cu's path bit-equal to
     the plain version's and the pass's, one launch a scan;
 5a. switches: one more multi-line pass with both of the global stage's
     seam switches (stitch_frames(seam_warp="fullres", seam_method="dp"):
     the seam canvas warped from each full-resolution strip by one K2
     content-mode launch, DP seams), its launch counts set to 0 just
     before it and read just after: the default pass's groups, no flips,
     strip offsets within 2 px of the default pass's, every seam pair cut
     by the DP seam, GT-RMSE <= 8, and exactly one content-mode K2 launch
     per strip's seam warp (the pass's content-mode launches the default
     pass's plus one per strip); its seam-warp and seam seconds beside
     the default pass's. Then K2's content mode at that launch's shape
     (line 1's padded strip at full resolution into the logged seam
     canvas, scale ~0.34): bit-equal to its plain version, timed as the
     other rows;
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
     bands must equal the straight run's. Then the CLI in child processes
     on the JPEGs of the sortie's first 6 frames of each line (cut from 10
     to keep the smoke's time), written by the codec: rc 0, the children's
     codec route logged, a packed I420 store, strip JPEGs (the codec's)
     and checkpoint written, the mosaic streamed into the codec's encoder,
     the decoded panorama within GT-RMSE 8, and a --resume run, streamed
     too, whose file equals the first byte for byte; decode, grouping,
     strip-save drain, streamed write and whole-run times, and the
     children's peak RSS.
  8. knobs, on the corridor's 2160x3840 frames (all 12), each run with the
     launch counts set to 0 just before it and read just after (in the
     order (b), (c), (d), (e), (a)):
     (a) a calibrated run: a barrel lens of a drone camera's size
     (fx = fy = 3000 px, centred, k1 = -0.05, k2 = 0.01) planted by
     rendering each frame distorted (the inverse of the undistortion map
     by fixed-point iteration, as cv::undistortPoints, sampled from the
     reflect-padded ortho at the corridor's positions), then
     app.undistort_frames and app.stitch_frames: one group,
     frame offsets within 1 px of the planted ones, GT-RMSE; (b)
     compositing_resol_mpx = 2.0: panorama size within 4 px of the scaled
     planted size, GT-RMSE against the ortho crop resized by the same
     scale, K2's float32 source launched; (c) use_affine_warper=False:
     panorama shape equal to the affine run's (phase 4), blurred RMSE
     between the two < 2; (d) pipeline.pairwise.stitch_pair on frames 0
     and 1 in similarity and homography mode: size within 4 px of
     2160 x 4992, GT-RMSE; (e) K2's float32 source at the compositing
     shape as (b) called it (the frame, affine and window of its first
     float32 compose feed), bit-equal to its plain version and timed as
     the other K2 rows, plus its batched seam warp of (b)'s frames.
  9. devices: the corridor (phase 4) and the multi-line pass (phase 5)
     again over the device list [cuda:0, cuda:0] (app.stitch_frames:
     the pair registration's chunks, the strips and the host-assembled
     compose tiles placed over it, two tiles in flight): panorama bytes,
     groups, strip and global transforms equal to the one-device pass,
     and the same launch counts; walls and peak memory beside the
     one-device pass's. With more than one card also device="cuda" (every
     card) under the same checks; with one, a line says it did not run;
 10. sortie step: parallel/sortie_step over [cuda:0, cuda:0] against
     [cuda:0] on the corridor's first 8 frames as gray at the grouper's
     work size and feature budget: transforms within 1e-4, inlier counts
     equal, the planted steps within 2 px, K1 launched; the canvas's
     largest difference and the warm walls; then K1 against its plain
     version at the step's shape (one frame, one call per frame);
 11. trace: one more multi-line pass under runtime/logging.device_trace
     (torch.profiler, CPU and CUDA activity) into build/smoke_trace: the
     file parses, it holds launches of both kernels, and its device busy
     share (the union of the kernel, copy and memset intervals over the
     traced wall) is in (0, 1]; its size, event count, the five device
     operations that took the most time, the traced wall against the
     untraced pass of phase 5, and the mosaic equal to that pass's;
 12. i420 (run right after phase 4): the corridor from a packed I420
     frame store (the JAX package's store format for 4:2:0 JPEGs; the
     packed frames made from the rendered BGR by the full-range JFIF
     forward transform, as a camera's encoder makes them; the flagship
     feeds the codec's raw planes): app.stitch_frames twice, the second
     measured with its launch counts set to 0 just before it; the
     corridor's geometry checks, GT-RMSE within 0.5 of phase 4's, K1 4
     launches and every K2 launch from its I420 source, the compose
     feeds from its staged kernel and the seam batch per tap (the host
     plan's choices); wall and peak memory beside phase 4's; a third pass
     with every launch per tap gives the same panorama. K2's I420 source
     at the compose feed and the 12-frame seam batch: the wrapper and
     both kernels (the staged one where its box fits a block) bit-equal
     to the plain version, both kernels timed in turns, with registers
     and shared memory (library: yuv420_to_bgr + F.grid_sample). The
     half-resolution store:
     two corridor JPEGs (the codec's) read at 1/2 by libjpeg's DCT
     scaling (the store's frames equal to the codec's scaled decode) and
     detected with coord_scale=2, the planted offset within 1 px.
 13. flagship (last, after the multi-line phases have released their
     frames): the JAX package's headline workload through the port's
     harness (drone_image_stitch_cpp_tpu_torch/tools): make_sortie
     renders the 200-frame 10 x 20 boustrophedon sortie of 2160x3840
     frames (overlaps 0.70 / 0.35, seed 11, JPEG quality 92; never cut)
     into a work directory under build/ that the phase deletes, then one
     warm run_ours on cuda:0 (app.run_stitch_application end to end, the
     JAX package's production I/O: the 4:2:0 JPEGs stored packed I420
     through the codec's raw decode, the mosaic streamed into its
     encoder), its launch counts set to 0 just before and read just after.
     Hard checks: rc 0 and a mosaic on disk; 10 groups of 20 frames
     (segments [0, 19] ... [180, 199]); 9 global seams, all graph-cut;
     no strip flipped; the mosaic within 16 px per axis of the band of
     the JAX package's own flagship mosaics across its commits
     (14804-14869 x 25716-25775; its record 14859x25775 is one draw at
     the band's top) and no smaller than the planted footprint (less 8
     px); GT-RMSE (tools/sortie_bench.gt_rmse, max_dim 6000) at or below
     49.0, the top of the JAX package's band across its commits; K1, K2
     and K2's content mode launched; the store yuv420 at 1.5 B a pixel
     (200 x 12.44 MB) through the codec's route, the mosaic streamed
     (`[GlobalCustom] streamed mosaic written`) and its file decoding to
     the mosaic's size; detect reading the store's Y plane; every K2
     launch of the strips from the I420 source, the compose feeds staged
     and the seam batches per tap (warp_kernel.i420_plan's choice at
     these shapes, read from the launch counters). Printed: the render and run walls,
     the stage split, the graph-cut seams' solver time, each strip's
     stitch, the global canvas and seam scale, GT-RMSE, peak device
     memory, the decode thread's busy time, ru_maxrss, the launches and
     the card. Then, in a child process of this script (a fresh process:
     after the run, torch.profiler's traces in this one lose kernel
     records), each kernel at the shapes only this path gives it, from
     the ground-truth crop: K1 at the global detect of a 25.7k-px
     strip (at least 531 valid keypoints), K2 in content mode from that
     padded strip into the compose window and, as the full-resolution
     seam warp calls it, into the ~2150x3720 seam canvas at the run's
     logged seam scale (~0.14), K2's seam batch of a 20-frame line, and
     K2's I420 source on the codec's raw planes of line 0's JPEGs at the compose
     feed and the 20-frame seam batch, each held against its plain
     version (K2 bit-equal) and timed as the other rows.
The environment line carries the JPEG codec probe (jpeglib.h, the libjpeg
the loader sees, the libjpeg-turbo in Pillow's wheel, g++, cv2 and PIL);
the build phase builds the codec from native/ beside the kernels
(utils/native: the system libjpeg, else Pillow's with the vendored
headers) and prints its route, library and the libjpeg it links, or fails
with both routes' errors.
The line before the last is a JSON object with each kernel's numbers (K1,
K2's BGR and I420 forms, K2's single-plane form as its own entry,
warp_affine_plane, with its launches by path and the throughput run;
maxflow_run and dp_seam_path with the measured multi-line pass's launches,
their times summed over its solves and scans, maxflow_run's per solve):
bound_ms is the larger of the bytes the call must move (each input byte
it needs read once: for K1 the stack pixels that its keypoints' needed
gradients tap, for K2 the source pixels its taps touch; each output
written once) over 3.35 TB/s and its float32 operations (for K1 counted
from its plain version over the gradients, orientation-box and descriptor
terms this run needs, transcendental functions as one) over 67 TFLOP/s;
share = bound_ms / kernel_ms (the kernel's own duration; device_ms, the
back-to-back events time, beside it). maxflow_run's bound is 36 B a slot a
round (excess, incoming excess, heights) x slots x rounds, dp_seam_path's
its cost read and its move table written, both over 3.35 TB/s and both
lower bounds of kernels bound by their barriers; their share is bound_ms /
device_ms. The last line is {"ok": true,
"device": {...}}.
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
# 0.9 x the 591 the JAX package finds on a 2160x25728 strip of a seed-11
# fractal ortho, the flagship's strip width (its work image is 232 x 2759;
# tests/test_torch_global_detect.py holds the port's count to it)
FLAG_K1_GLOBAL_MIN_VALID = 531
KNOB_LENS = dict(fx=3000.0, fy=3000.0, cx=(FRAME_W - 1) / 2.0,
                 cy=(FRAME_H - 1) / 2.0,
                 dist=(-0.05, 0.01, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0))
KNOB_PAD = 96                       # ortho padding for the lens's samples
KNOB_COMPOSITING_MPX = 2.0
KNOB_PAIR_W = FRAME_W + 1152        # two corridor frames, 0.70 overlap
CLI_COLS = 6                        # production CLI: frames per line
FB_FRAMES = 4                       # fallback phase: corridor frames
FB_SIZE_TOL_PX = 8
I420_TOL_RMSE = 0.5                 # GT-RMSE against the BGR corridor's
I420_OPS_PER_PX = 166               # K2's I420 source: 4 taps x 34 + 30
FLAG_ROWS, FLAG_COLS = 10, 20       # the flagship sortie (BENCH_sortie.json)
FLAG_MOSAIC = (14859, 25775)        # the JAX package's mosaic on it (TPU)
# the JAX package's flagship mosaics across its commits, (h), (w): one
# geometry draw each (artifacts/flagship_r*.log, TPU runs); the record
# above lies at the band's top
FLAG_MOSAIC_BAND = ((14804, 14869), (25716, 25775))
FLAG_SIZE_TOL_PX = 16
# the top of the JAX package's GT-RMSE band across its commits on the
# flagship, 38.6-49.0 (artifacts/RMSE_attribution_r5.md)
FLAG_RMSE_MAX = 49.0
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
SMEM_PER_BLOCK = 232448             # H100: shared memory a block can use
FP32_OPS_PER_S = 67e12              # float32 outside the tensor cores
# 0.9 x the 3831 valid keypoints (of 8 x 2200) that the port's
# select_keypoints finds on the CPU on the throughput benchmark's 8 prepped
# frames (512 x 896, synthetic_ortho seed 3)
TP_K1_MIN_VALID = 3447


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
    dynamic loader lists, the libjpeg-turbo in Pillow's wheel, g++, cv2
    and PIL."""
    import importlib.util

    from drone_image_stitch_cpp_tpu_torch.utils.native import _pillow_libjpeg
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
            f"Pillow's bundled libjpeg {_pillow_libjpeg() or 'absent'}; "
            f"g++ '{ver}'; cv2 {mods['cv2']}; PIL {mods['PIL']}")


def _ptxas_entries(report: str,
                   what: str = r"Used (\d+) registers") -> dict:
    """{entry: registers} (or, with ``what`` another pattern, that number)
    from an -Xptxas -v report, K2's entries by the source they read (u8,
    f32, i420_per_tap, i420_staged, plane, affine_inverse)."""
    names = {"warp_i420_staged_kernel": "i420_staged", "I420": "i420_per_tap",
             "warp_plane_kernel": "plane", "affine_inverse": "affine_inverse",
             "warp_affine_tile_kernelIh": "u8",
             "warp_affine_tile_kernelIf": "f32"}
    out = {}
    for part in report.split("Compiling entry function '")[1:]:
        entry = part.split("'")[0]
        num = re.search(what, part)
        key = next((v for k, v in names.items() if k in entry), entry)
        out[key] = max(out.get(key, -1), int(num.group(1)) if num else -1)
    return out


def _linked_libjpeg(path: str) -> str:
    """The libjpeg that the dynamic loader resolves for the library at
    ``path`` (its ``ldd`` line)."""
    try:
        out = subprocess.run(["ldd", path], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"ldd failed: {e}"
    return "; ".join(ln.strip() for ln in out.splitlines()
                     if "libjpeg" in ln) or "no libjpeg line"


def phase_build() -> dict:
    """Build every kernel, one nvcc each, started together, and the JPEG
    codec beside them (it must build, by one of its two routes); returns
    each source's (registers, spill bytes, {entry: registers}) as ptxas
    reports them."""
    from drone_image_stitch_cpp_tpu_torch.ops import maxflow_kernel as MK
    from drone_image_stitch_cpp_tpu_torch.ops import seam_kernel as DK
    from drone_image_stitch_cpp_tpu_torch.ops import sift_kernel as SK
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    from drone_image_stitch_cpp_tpu_torch.runtime.kernels import load_kernels

    import threading

    from drone_image_stitch_cpp_tpu_torch.utils.native import (
        jpeg_codec_error, jpeg_codec_library, jpeg_codec_route)

    t0 = time.perf_counter()
    # the host JPEG codec (g++) builds beside the nvcc builds
    codec = threading.Thread(target=jpeg_codec_error)
    codec.start()
    mods = (SK, WK, MK, DK)
    built = load_kernels({m.KERNEL_SOURCE: m.KERNEL_SIGNATURES
                          for m in mods})
    codec.join()
    err = jpeg_codec_error()
    if err is not None:
        _fail("build", f"the JPEG codec builds by neither route: {err}")
    lib = jpeg_codec_library()
    print(f"[smoke] build JPEG codec from native/decode.cpp + encode.cpp: "
          f"route {jpeg_codec_route()}, built {os.path.relpath(lib)}, "
          f"linked {_linked_libjpeg(lib)}", flush=True)
    _codec_vs_cv2_write()
    out = {}
    for m in mods:
        k = built[m.KERNEL_SOURCE]
        lines = [ln.strip() for ln in k.ptxas.splitlines()
                 if "registers" in ln or "spill" in ln]
        regs = [int(x) for x in re.findall(r"Used (\d+) registers",
                                           k.ptxas)]
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill",
                                               k.ptxas))
        out[m.KERNEL_SOURCE] = (
            max(regs, default=-1), spill, _ptxas_entries(k.ptxas),
            _ptxas_entries(k.ptxas, r"(\d+) bytes smem"))
        print(f"[smoke] build {m.KERNEL_SOURCE}: nvcc {k.seconds:.2f} s; "
              f"ptxas: {' | '.join(lines)}", flush=True)
    print(f"[smoke] build: {len(mods)} kernels in "
          f"{time.perf_counter() - t0:.2f} s",
          flush=True)
    return out


def _codec_vs_cv2_write():
    """Print whether app.write_image (the codec at quality 95 with
    libjpeg's defaults) writes cv2.imwrite's default bytes on this
    machine, whose cv2 carries its own libjpeg: a reading, not a check."""
    import cv2

    from drone_image_stitch_cpp_tpu_torch.app import write_image
    img = cv2.GaussianBlur(np.random.default_rng(11).integers(
        0, 256, (243, 321, 3), np.uint8), (7, 7), 2.0)
    with tempfile.TemporaryDirectory() as d:
        ours, ref = os.path.join(d, "ours.jpg"), os.path.join(d, "cv2.jpg")
        write_image(ours, img)
        cv2.imwrite(ref, img)
        with open(ours, "rb") as f, open(ref, "rb") as g:
            a, b = f.read(), g.read()
        diff = np.abs(cv2.imread(ours).astype(np.int16)
                      - cv2.imread(ref).astype(np.int16)).max()
    print(f"[smoke] build JPEG codec: write_image vs cv2.imwrite (cv2 "
          f"{cv2.__version__}) on a 243x321 frame: bytes equal {a == b} "
          f"({len(a)} vs {len(b)} B), decoded max |diff| {int(diff)}",
          flush=True)


def _plane_library(torch, planes, table, oh, ow):
    """F.grid_sample (bilinear, zeros, align_corners=True) on (N, 1, H, W)
    float32 planes with the single-plane K2's sample grid (built here,
    outside the timed call): (ms, its (N, 1, oh, ow) output)."""
    import torch.nn.functional as F
    from drone_image_stitch_cpp_tpu_torch.ops.warp import dst_to_src_coords
    n, h, w = planes.shape
    grids = []
    for k in range(n):
        sx, sy = dst_to_src_coords(table[k].reshape(2, 3), oh, ow)
        grids.append(torch.stack([sx / (w - 1) * 2 - 1,
                                  sy / (h - 1) * 2 - 1], dim=-1))
    grid = torch.stack(grids)
    src = planes[:, None]

    def call():
        return F.grid_sample(src, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    out = call()
    return _median_ms(call, torch), out


def _device_ops(torch, fn, calls: int = 1, span=None):
    """The device operations (kernels, copies, memsets) of ``calls`` calls
    of ``fn`` after a warm call, from a torch.profiler trace: [(category,
    name, duration in us)]. ``span``, a list, gets the CUDA events time
    around the traced calls (ms)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(suffix=".json", dir=out_dir)
    os.close(fd)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    if span is not None:
        span.append(a.elapsed_time(b))
    return [(e["cat"], e["name"], float(e.get("dur", 0.0))) for e in events
            if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _kernel_ms(torch, fn, kernel: str, calls: int = 20) -> float:
    """The kernel's own duration: the median ``dur`` of the device kernels
    named ``kernel`` (a substring) over ``calls`` back-to-back calls of
    ``fn`` in one torch.profiler trace (CUPTI's start and end of each
    kernel, so the host's pace between launches is not in it), ms. The
    trace is taken again, up to three times, when it holds fewer than half
    as many such kernels as calls (CUPTI dropped records) or when their
    durations add up to more than the CUDA events time around the same
    calls (the calls run one after another on one stream, so that reading
    is impossible); then the smoke fails."""
    for _ in range(3):
        span = []
        durs = [d for cat, name, d in _device_ops(torch, fn, calls, span)
                if cat == "kernel" and kernel in name]
        if len(durs) >= calls // 2 and sum(durs) / 1e3 <= span[0]:
            return float(np.median(durs)) / 1e3
        print(f"[smoke] profile: {len(durs)} '{kernel}' kernels of {calls} "
              f"calls, {sum(durs) / 1e3:.4f} ms in all against the events' "
              f"{span[0]:.4f} ms: trace taken again", flush=True)
    _fail("profile", f"no trace of {calls} calls held the '{kernel}' "
                     f"kernels' durations, three times")


def _routes_of(torch, dev, launch) -> dict:
    """{route: tiles} of one launch of K2's gather kernel: ``launch(tiles)``
    with a card int32 counter of each of warp_kernel.ROUTES."""
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    tiles = torch.zeros(len(WK.ROUTES), dtype=torch.int32, device=dev)
    launch(tiles)
    torch.cuda.synchronize()
    return dict(zip(WK.ROUTES, tiles.tolist()))


def _check_routes(label, routes, shape, want):
    """Fails when a launch's tile counts contradict its plan: every tile of
    the (n, oh, ow) window counted once, and each route of ``want`` taken
    (True) or not (False)."""
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    n, oh, ow = shape
    total = n * -(-oh // WK.TILE[0]) * -(-ow // WK.TILE[1])
    if sum(routes.values()) != total or any(
            (routes[r] > 0) != v for r, v in want.items()):
        _fail("k2", f"{label}: tiles by route {routes} of {total} contradict "
                    f"the plan (routes taken: {want})")


def _plane_row(torch, dev, label, planes, a23s):
    """K2's single-plane form at the throughput path's shape, ``a23s`` the
    device models as the bench passes them (a (N, 2, 3) slice of the
    (N, 3, 3) models): the wrapper's call is ONE device operation, the
    kernel itself (torch.profiler); the wrapper and both routes (staged
    boxes where they fit, and every tile direct) bit-equal to the plain
    version on the same table, the staged route staging tiles and the
    direct one none; wrapper, device time of each route (in turns:
    staged, direct, direct, staged), plain and F.grid_sample times; the
    bound (4 B a touched source pixel read, 4 B an output pixel written;
    20 operations an output pixel) and each route's share of it (bound /
    kernel ms). Fails when the direct route's kernel time beats the staged
    one, the kernel's default."""
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    n, h, w = planes.shape
    table = WK.device_inverse_coeffs(a23s)
    got = WK.warp_planes(planes, a23s, h, w)
    plain = WK.warp_planes_plain(planes, table, h, w)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    routes = {r: WK._launch_planes(planes, a23s, h, w,
                                   direct=r == "direct",
                                   staged_tiles=counts[i])
              for i, r in enumerate(("staged", "direct"))}
    torch.cuda.synchronize()
    if not torch.equal(got, plain):
        _fail("throughput", f"k2 plane {label}: not bit-equal to the plain "
                            f"version (max |d| "
                            f"{float((got - plain).abs().max())})")
    for r, out in routes.items():
        if not torch.equal(out, plain):
            _fail("throughput", f"k2 plane {label}: the {r} route is not "
                                f"bit-equal to the plain version")
    del got, plain, routes
    tiles = n * -(-h // WK.PLANE_TILE[0]) * -(-w // WK.PLANE_TILE[1])
    staged, direct = counts.tolist()
    if staged == 0 or direct != 0:
        _fail("throughput", f"k2 plane {label}: {staged} tiles staged by "
                            f"the staged route (need > 0), {direct} by the "
                            f"direct one (need 0)")
    ops = _device_ops(torch, lambda: WK.warp_planes(planes, a23s, h, w))
    if len(ops) != 1 or ops[0][0] != "kernel" or \
            "warp_plane_kernel" not in ops[0][1]:
        _fail("throughput", f"k2 plane {label}: one warp_planes call ran "
                            f"{ops} on the device (need exactly one "
                            f"warp_plane_kernel)")
    ms = _median_ms(lambda: WK.warp_planes(planes, a23s, h, w), torch)
    runs = {"staged": [], "direct": []}
    kruns = {"staged": [], "direct": []}
    for r in ("staged", "direct", "direct", "staged"):
        def launch():
            return WK._launch_planes(planes, a23s, h, w,
                                     direct=r == "direct")
        runs[r].append(_device_ms(launch, torch))
        kruns[r].append(_kernel_ms(torch, launch, "warp_plane_kernel"))
    plain_ms = _median_ms(lambda: WK.warp_planes_plain(planes, table, h, w),
                          torch)
    library_ms, lib = _plane_library(torch, planes, table, h, w)
    lib_err = float((lib[:, 0] - WK.warp_planes(planes, a23s, h,
                                                w)).abs().max())
    del lib
    src_px = sum(_k2_source_pixels(torch, dev, inv, h, w, h, w)
                 for inv in table.tolist())
    n_out = n * h * w
    n_bytes = 4.0 * src_px + 4.0 * n_out
    bound_ms, bound_by = _bound(n_bytes, 20.0 * n_out)
    route_rows = {}
    for r, t in runs.items():
        kernel_ms = float(np.mean(kruns[r]))
        route_rows[r] = {"device_ms": float(np.mean(t)), "runs_ms": t,
                         "kernel_ms": kernel_ms, "kernel_ms_runs": kruns[r],
                         "share": bound_ms / kernel_ms}
    route_rows["staged"]["staged_tiles"] = staged
    route_rows["staged"]["tiles"] = tiles
    # the kernel's own choice wherever a box fits, so it must be the faster
    default = "staged"
    if route_rows["direct"]["kernel_ms"] < route_rows[default]["kernel_ms"]:
        _fail("throughput", f"k2 plane {label}: the direct route "
                            f"({route_rows['direct']['kernel_ms']:.4f} ms) "
                            f"beats the default, staged one "
                            f"({route_rows[default]['kernel_ms']:.4f} ms)")
    device_ms = route_rows[default]["device_ms"]
    kernel_ms = route_rows[default]["kernel_ms"]
    print(f"[smoke] k2 warp_affine_plane_f32 {label}: {n} x {h}x{w} f32 -> "
          f"{h}x{w} (no mask), device models (strided), inverted in the "
          f"kernel; one call = {ops[0][1][:60]} alone on the device; "
          f"wrapper, staged and direct routes bit-identical to plain; "
          f"staged route staged {staged} of {tiles} tiles; wrapper "
          f"{ms:.4f} ms, device staged "
          f"{route_rows['staged']['device_ms']:.4f} ms (runs "
          f"{', '.join(f'{x:.4f}' for x in runs['staged'])}), direct "
          f"{route_rows['direct']['device_ms']:.4f} ms (runs "
          f"{', '.join(f'{x:.4f}' for x in runs['direct'])}), kernel "
          f"staged {route_rows['staged']['kernel_ms']:.4f} ms (runs "
          f"{', '.join(f'{x:.4f}' for x in kruns['staged'])}), direct "
          f"{route_rows['direct']['kernel_ms']:.4f} ms (runs "
          f"{', '.join(f'{x:.4f}' for x in kruns['direct'])}), default "
          f"{default}; plain {plain_ms:.3f} ms, grid_sample "
          f"{library_ms:.4f} ms (max |d| {lib_err:.3g}); bound "
          f"{bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e6:.1f} MB), share "
          f"staged {route_rows['staged']['share']:.3f}, direct "
          f"{route_rows['direct']['share']:.3f}; wrapper / grid_sample "
          f"{ms / library_ms:.3f}", flush=True)
    return {"shape": [n, h, w], "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "share": route_rows[default]["share"], "device_ms": device_ms,
            "kernel_ms": kernel_ms, "bytes": n_bytes,
            "default_route": default,
            "routes": route_rows, "device_ops_per_call": len(ops)}


def _plane_inverse_check(torch, dev):
    """The card's build of the single-plane kernel's inverse
    (csrc/affine_inverse.cuh, through ops/warp_kernel.kernel_inverse_coeffs)
    bit-equal to inverse_coeffs and device_inverse_coeffs on the affines
    of utils/plane_affines (the 200 of the throughput tests and 10^4
    more), and not finite on singular ones; the kernel library's host
    entry of it (host_inverse_coeffs, the other K2 launches' inverse)
    bit-equal to inverse_coeffs on the same affines."""
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    from drone_image_stitch_cpp_tpu_torch.utils.plane_affines import (
        bench_affines, singular_affines, wide_affines)
    total = 0
    for a23s in (bench_affines(), wide_affines()):
        on_card = torch.from_numpy(a23s).to(dev)
        got = WK.kernel_inverse_coeffs(on_card)
        ref = np.asarray([WK.inverse_coeffs(a) for a in a23s], np.float32)
        if not (np.array_equal(got.cpu().numpy(), ref)
                and torch.equal(got, WK.device_inverse_coeffs(on_card))):
            _fail("throughput", "the in-kernel affine inverse differs from "
                                "inverse_coeffs / device_inverse_coeffs")
        if not np.array_equal(WK.host_inverse_coeffs(a23s), ref):
            _fail("throughput", "the kernel library's host inverse differs "
                                "from inverse_coeffs")
        total += len(a23s)
    sing = WK.kernel_inverse_coeffs(torch.from_numpy(
        singular_affines()).to(dev)).cpu().numpy()
    if np.isfinite(sing).all(axis=1).any():
        _fail("throughput", f"a singular affine inverted to finite "
                            f"coefficients {sing.tolist()}")
    print(f"[smoke] k2 plane inverse: the kernel's float32 LU "
          f"(csrc/affine_inverse.cuh) bit-equal to inverse_coeffs and "
          f"device_inverse_coeffs on {total} affines, and so is its host "
          f"entry in the same library; singular ones not finite",
          flush=True)
    return total


def phase_throughput(torch, dev):
    """The JAX repo's bench.py through its port, tools/bench_throughput, at
    its full sizes (8 frames of 2160x3840, 2200 features, 7 full-4K
    warps), on the empty card; then K1 at the bench's detect shape and
    K2's single-plane form for one frame and the 7-frame batch, each
    against its plain version. Returns (launch counts of the bench's run,
    the K1 row, the single-plane kernel's entry)."""
    from drone_image_stitch_cpp_tpu_torch.tools import bench_throughput as BT

    t0 = time.perf_counter()
    frames = BT.make_frames()
    print(f"[smoke] throughput: {len(frames)} gray frames {FRAME_H}x"
          f"{FRAME_W} (synthetic_ortho seed 3) made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _zero_counts()
    t0 = time.perf_counter()
    r = BT.bench_torch(frames, dev)
    wall = time.perf_counter() - t0
    launches = _counts()
    fps_cpu = BT.bench_opencv(frames)
    planted = np.asarray([-256.0, -64.0]) * r["scale"]
    err = np.abs(r["models"][:, :2, 2] - planted).max(axis=1)
    st, sy = r["stages_ms"], r["syncs"]
    print(f"[smoke] throughput: {r['fps']:.3f} frames/s, vs_baseline "
          f"{r['fps'] / fps_cpu:.3f} (OpenCV on {os.cpu_count()} cores "
          f"{fps_cpu:.3f} frames/s); stages ms: prep {st['prep']:.3f}, "
          f"detect(+prep) {st['detect']:.3f}, register {st['register']:.3f}"
          f", warp x{len(frames) - 1} {st['warp']:.3f}, total "
          f"{st['total']:.3f}, queued x{BT.PIPE_REPS} {st['queued']:.3f} a "
          f"batch; synchronising calls of one batch {sy}; work "
          f"{r['work_hw']} padded {r['padded_hw']} scale {r['scale']:.4f}; "
          f"n_good {r['n_good'].tolist()}, inliers "
          f"{r['n_inliers'].tolist()}; translation error vs the planted "
          f"({planted[0]:.3f}, {planted[1]:.3f}) work px: max "
          f"{err.max():.4f}; launches per batch {r['launches']}, in the "
          f"run K1 {launches['sift_orient_desc']} K2 plane "
          f"{launches['warp_affine_plane']}; useful-FLOP estimate "
          f"{r['gflop']:.1f} GFLOP; bench wall {wall:.1f} s", flush=True)
    if not r["ok"].all():
        _fail("throughput", f"pairs failed: ok {r['ok'].tolist()}")
    if err.max() > 0.5:
        _fail("throughput", f"translation error {err.tolist()} work px "
                            f"(need <= 0.5)")
    if r["launches"] != {"sift_orient_desc": 1, "warp_affine_plane": 1}:
        _fail("throughput", f"launches of one batch {r['launches']} (need "
                            f"K1 1 and the single-plane K2 1)")
    if sy["warp"] != 0:
        _fail("throughput", f"the warp stage synchronised {sy['warp']} "
                            f"times (need 0)")
    fdev = torch.from_numpy(np.stack(frames)).to(dev)
    a23s = torch.from_numpy(r["models"].astype(np.float32)).to(dev)[:, :2]
    n_inv = _plane_inverse_check(torch, dev)
    one = _plane_row(torch, dev, "one frame", fdev[1:2], a23s[:1])
    batch = _plane_row(torch, dev, f"{len(frames) - 1}-frame batch",
                       fdev[1:], a23s)
    gray = BT.prep(fdev, BT.work_geometry(FRAME_H, FRAME_W))
    del fdev
    k1 = _k1_check(torch, gray, "throughput", BT.SIFT_FEATURES,
                   min_valid=TP_K1_MIN_VALID)
    del gray
    torch.cuda.empty_cache()
    plane = {"name": "warp_affine_plane", "route": "cuda",
             "source": "drone_image_stitch_cpp_tpu_torch/csrc/warp_affine.cu",
             "replaces": "drone_image_stitch_cpp_tpu/ops/pallas_warp.py:234",
             "entry": "warp_affine_plane_f32, for warp_affine_traced "
                      "(pallas_warp.py:323) and warp_affine_many (:287)",
             **{k: batch[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "share", "device_ms", "kernel_ms",
                                      "shape",
                                      "default_route", "routes",
                                      "device_ops_per_call")},
             "one_frame": one, "inverse_affines_checked": n_inv,
             "throughput": {"fps": r["fps"], "vs_baseline": r["fps"] / fps_cpu,
                            "opencv_fps": fps_cpu, "stages_ms": st,
                            "syncs": sy, "cores": os.cpu_count()}}
    return launches, k1, plane


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
    kernel_ms = _kernel_ms(torch, lambda: SK._launch(flat[0], radius,
                                                     *flat[1:]),
                           "sift_orient_desc_kernel")
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
          f"back), device {device_ms:.4f} ms, kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"({mb:.1f} MB, {gflop:.3f} GFLOP), share "
          f"{bound_ms / kernel_ms:.3f}; padded-stack build "
          f"{stack_ms:.4f} "
          f"ms ({stack_mb:.0f} MB)", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "wrapper_b2b_ms": b2b_ms,
            "device_ms": device_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / kernel_ms,
            "stack_build_ms": stack_ms,
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
                                   "device_ms", "kernel_ms", "share",
                                   "wrapper_b2b_ms", "stack_build_ms")},
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
    routes = _routes_of(torch, dev, lambda c: WK._launch(frame, 1, inv, oh,
                                                         ow, tiles=c))
    _check_routes("compose feed", routes, (1, oh, ow), {"direct": True})
    ms = _median_ms(lambda: WK.warp_frame(frame, a23, oh, ow), torch)
    b2b_ms = _device_ms(lambda: WK.warp_frame(frame, a23, oh, ow), torch)
    device_ms = _device_ms(lambda: WK._launch(frame, 1, inv, oh, ow), torch)
    kernel_ms = _kernel_ms(torch, lambda: WK._launch(frame, 1, inv, oh, ow),
                           "warp_affine_tile_kernel")
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
          f"tiles {routes}; wrapper {ms:.4f} ms ({b2b_ms:.4f} ms back to "
          f"back), device {device_ms:.4f} ms, kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, grid_sample {library_ms:.4f} ms (max "
          f"|d| {lib_err:.3g}); bound {bound_ms:.4f} ms by {bound_by} "
          f"({(3.0 * src_px + 16.0 * oh * ow) / 1e6:.1f} MB), share "
          f"{bound_ms / kernel_ms:.3f}", flush=True)
    return {"name": "warp_affine", "route": "cuda",
            "source": "drone_image_stitch_cpp_tpu_torch/csrc/warp_affine.cu",
            "replaces": "drone_image_stitch_cpp_tpu/ops/pallas_warp.py:234",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": device_ms,
            "kernel_ms": kernel_ms, "share": bound_ms / kernel_ms,
            "wrapper_b2b_ms": b2b_ms, "tiles": routes}


def _seam_affines(pos, tuning):
    """The strip compose's seam-scale warps of a line's frames at ``pos``:
    (affines (N, 2, 3), canvas rows, canvas columns, seam scale)."""
    from drone_image_stitch_cpp_tpu_torch.ops.blend import align_up
    from drone_image_stitch_cpp_tpu_torch.ops.resize import (
        scale_for_megapixels)
    ys = [p[0] for p in pos]
    xs = [p[1] for p in pos]
    ss = scale_for_megapixels(FRAME_H, FRAME_W,
                              tuning.seam_estimation_resol_mpx)
    sh = align_up(int(round((max(ys) - min(ys) + FRAME_H) * ss)), 64)
    sw = align_up(int(round((max(xs) - min(xs) + FRAME_W) * ss)), 64)
    a23s = np.stack([np.asarray([[ss, 0, ss * (x - min(xs))],
                                 [0, ss, ss * (y - min(ys))]], np.float32)
                     for y, x in pos])
    return a23s, sh, sw, ss


def phase_k2_batch(torch, dev, imgs, pos, tuning):
    """The batched K2 as the strip compose calls it: every frame of the
    line into the seam-scale canvas in one launch, each frame bit-equal to
    its plain warp."""
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    a23s, sh, sw, ss = _seam_affines(pos, tuning)
    frames = torch.from_numpy(np.stack(imgs)).to(dev)
    invs = [WK.inverse_coeffs(a) for a in a23s]
    wk, mk = WK.warp_frames(frames, a23s, sh, sw)
    for k in range(len(imgs)):
        wp, mp = WK.warp_frame_plain(frames[k], invs[k], sh, sw)
        if not (torch.equal(wk[k], wp) and torch.equal(mk[k], mp)):
            _fail("k2", f"seam batch: frame {k} differs from its plain warp")
    table = torch.tensor(invs, dtype=torch.float32, device=dev)
    routes = _routes_of(torch, dev, lambda c: WK._launch(
        frames, len(imgs), invs, sh, sw, tiles=c))
    _check_routes("seam batch", routes, (len(imgs), sh, sw),
                  {"zero": True, "direct": True})
    ms = _median_ms(lambda: WK.warp_frames(frames, a23s, sh, sw), torch)
    device_ms = _device_ms(lambda: WK._launch(frames, len(imgs), invs, sh,
                                              sw, table=table), torch)
    kernel_ms = _kernel_ms(torch, lambda: WK._launch(frames, len(imgs), invs,
                                                     sh, sw),
                           "warp_affine_tile_kernel")
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
          f"every frame bit-identical to plain; tiles {routes}; wrapper "
          f"{ms:.4f} ms, device {device_ms:.4f} ms, kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.3f} ms, grid_sample "
          f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by}, "
          f"share {bound_ms / kernel_ms:.3f}", flush=True)
    return {"shape": [len(imgs), sh, sw], "ms": ms, "device_ms": device_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share": bound_ms / kernel_ms,
            "tiles": routes}


def _stage_seconds(recs, stages=None):
    """{"stage/what": seconds} of the program's span records ``recs`` (of
    ``stages`` only, when given), each step's records summed: a step
    inside a stage (a tile's feed, a seam's solve) repeats."""
    out = {}
    for r in recs:
        if "seconds" in r and (stages is None or r["stage"] in stages):
            k = f"{r['stage']}/{r['msg'].removesuffix(' done')}"
            out[k] = out.get(k, 0.0) + r["seconds"]
    return {k: round(v, 3) for k, v in out.items()}


def phase_slice(torch, dev, ortho, imgs, ids, pos, tuning):
    from drone_image_stitch_cpp_tpu_torch.app import stitch_frames
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
    launches = _counts()
    k2_split = (launches["warp_affine"] - launches["warp_affine_batched"],
                launches["warp_affine_batched"])
    peak = torch.cuda.max_memory_allocated(dev)
    tm = {r["msg"]: r["seconds"] for r in log._records if "seconds" in r}
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
    for name in ("sift_orient_desc", "warp_affine"):
        if launches[name] <= 0:
            _fail("slice", f"kernel {name} never launched on the main path")
    if k2_split[1] != 1:
        _fail("slice", f"seam warps took {k2_split[1]} batched launches, "
                       f"expected 1")
    return launches, {"res": res, "wall": wall, "peak": peak, "rmse": rmse,
                      "stages": stages}


def _distorted_frames(torch, dev, ortho, pos, calib):
    """The corridor's frames (at ``pos``) as the planted lens sees them:
    distorted pixel v shows the ortho at the frame's origin + u, with
    u = m^-1(v) for the undistortion map m (ops/undistort.distortion_maps)
    inverted by fixed-point iteration as cv::undistortPoints does. The
    ortho is reflect-padded by KNOB_PAD px first, so no sample falls
    outside it; the padding is seen only by distorted pixels whose u lies
    outside the frame, which the undistortion never reads back. Returns
    (uint8 frames, the largest |u - v| in px)."""
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
    shift = float(torch.maximum((ux - xs.float()).abs(),
                                (uy - ys.float()).abs()).max())
    src = torch.from_numpy(np.pad(ortho, ((KNOB_PAD, KNOB_PAD),
                                          (KNOB_PAD, KNOB_PAD), (0, 0)),
                                  mode="reflect")).to(dev)
    frames = []
    for py, px in pos:
        sx, sy = ux + (px + KNOB_PAD), uy + (py + KNOB_PAD)
        if float(sx.min()) < 0 or float(sy.min()) < 0 or \
                float(sx.max()) > src.shape[1] - 2 or \
                float(sy.max()) > src.shape[0] - 2:
            _fail("knobs", f"distorted frame at {(py, px)} samples outside "
                           f"the padded ortho (lens shift {shift:.1f} px)")
        d = bilinear_sample(src, sx, sy)
        frames.append(d.round().clamp(0, 255).to(torch.uint8).cpu().numpy())
    del src
    return frames, shift


def _knob_run(torch, dev, label, fn):
    """Run ``fn`` with the launch counts set to 0 just before it: (its
    result, wall s, launch counts read just after); prints them with the
    stage timers the run logged."""
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
    log = get_logger()
    mark = len(log._records)
    _zero_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    stages = ", ".join(f"{k}={v}" for k, v in
                       _stage_seconds(log._records[mark:]).items())
    print(f"[smoke] knobs {label}: wall {wall:.2f} s, launches {counts}; "
          f"stages (s): {stages or 'none logged'}", flush=True)
    return out, wall, counts


def _check_line(res, pos, label):
    """One group of every frame, offsets within OFFSET_TOL_PX of ``pos``."""
    n = len(pos)
    if [len(g.indices) for g in res.groups] != [n] or \
            res.kept != list(range(n)):
        _fail("knobs", f"{label}: groups {[g.indices for g in res.groups]}, "
                       f"kept {res.kept}")
    exp = np.asarray([(x - pos[0][1], y - pos[0][0]) for y, x in pos],
                     np.float64)
    per = np.abs(res.transforms[:, :, 2].astype(np.float64)
                 - exp).max(axis=1)
    err = float(per.max())
    if err > OFFSET_TOL_PX:
        _fail("knobs", f"{label}: frame offsets off by {err:.3f} px (per "
                       f"frame {np.round(per, 3).tolist()}, max |linear - I| "
                       f"{np.abs(res.transforms[:, :, :2] - np.eye(2)).max():.2e})")
    return err


def phase_knobs(torch, dev, ortho, imgs, ids, pos, tuning, affine_pano):
    """The strip-stage and ingest options on the corridor (module doc,
    phase 8). Returns (summed launch counts, the K2 float32 row)."""
    from drone_image_stitch_cpp_tpu_torch import app as A
    from drone_image_stitch_cpp_tpu_torch.config.tuning import (
        CameraCalibration, MultiBandCalibration)
    from drone_image_stitch_cpp_tpu_torch.ops.resize import (
        resize_area, scale_for_megapixels)
    from drone_image_stitch_cpp_tpu_torch.pipeline import compose_feed as CF
    from drone_image_stitch_cpp_tpu_torch.pipeline.pairwise import (
        stitch_pair)
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

    log = get_logger()
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    n = len(imgs)
    gt_h = FRAME_H
    gt_w = FRAME_W + (n - 1) * (pos[1][1] - pos[0][1])

    # (b) compositing below full resolution; the first float32 compose
    # feed's frame, affine and window are kept for (e)
    cs = scale_for_megapixels(FRAME_H, FRAME_W, KNOB_COMPOSITING_MPX)
    comp = tuning.replace(compositing_resol_mpx=KNOB_COMPOSITING_MPX)
    real_warp = CF.warp_frame
    fed = {}

    def probe(img, a23, oh, ow, content="ones"):
        if img.dtype == torch.float32 and "img" not in fed:
            fed.update(img=img, a23=np.asarray(a23, np.float32), oh=oh,
                       ow=ow)
        return real_warp(img, a23, oh, ow, content=content)

    mark = len(log._records)
    CF.warp_frame = probe
    try:
        res, wall_b, counts = _knob_run(
            torch, dev, "compositing",
            lambda: A.stitch_frames(imgs, ids, comp, dev))
    finally:
        CF.warp_frame = real_warp
    add(counts)
    tiled = any(r["msg"] == "tiled compose" for r in log._records[mark:])
    if counts["warp_affine_f32"] <= 0 or not fed:
        _fail("knobs", f"compositing: K2's float32 source never launched "
                       f"({counts})")
    _check_line(res, pos, "compositing")
    sh, sw = int(round(gt_h * cs)), int(round(gt_w * cs))
    ph, pw = res.panorama.shape[:2]
    if abs(ph - sh) > SIZE_TOL_PX or abs(pw - sw) > SIZE_TOL_PX:
        _fail("knobs", f"compositing: panorama {ph}x{pw} vs scaled planted "
                       f"{sh}x{sw}")
    y0, x0 = pos[0]
    crop = torch.from_numpy(np.ascontiguousarray(
        ortho[y0:y0 + gt_h, x0:x0 + gt_w])).to(dev)
    gt = resize_area(crop, sh, sw).clamp(0, 255).to(torch.uint8).cpu(
        ).numpy()
    del crop
    rmse, dy, dx = gt_rmse(res.panorama, gt, device=dev)
    if not np.isfinite(rmse) or rmse > GT_RMSE_MAX:
        _fail("knobs", f"compositing GT-RMSE {rmse} > {GT_RMSE_MAX}")
    print(f"[smoke] knobs compositing: {KNOB_COMPOSITING_MPX} MP, scale "
          f"{cs:.4f}, panorama {ph}x{pw} (scaled planted {sh}x{sw}), "
          f"GT-RMSE {rmse:.4f} at shift ({dy},{dx}) against the ortho crop "
          f"resized by the same scale; canvas tiled {tiled}; K2 float32 "
          f"launches {counts['warp_affine_f32']}", flush=True)
    del res

    # (c) the perspective warper
    persp = tuning.replace(use_affine_warper=False)
    res, wall_c, counts = _knob_run(
        torch, dev, "perspective",
        lambda: A.stitch_frames(imgs, ids, persp, dev))
    add(counts)
    _check_line(res, pos, "perspective")
    if res.panorama.shape != affine_pano.shape:
        _fail("knobs", f"perspective panorama {res.panorama.shape} vs the "
                       f"affine run's {affine_pano.shape}")
    rmse_pa, _, _ = gt_rmse(res.panorama, affine_pano, search=1, device=dev)
    if not np.isfinite(rmse_pa) or rmse_pa >= 2.0:
        _fail("knobs", f"perspective vs affine blurred RMSE {rmse_pa} >= 2")
    if counts["sift_orient_desc"] <= 0:
        _fail("knobs", "perspective: K1 never launched")
    print(f"[smoke] knobs perspective: panorama {res.panorama.shape[0]}x"
          f"{res.panorama.shape[1]} equal in shape to the affine run's, "
          f"blurred RMSE between the two {rmse_pa:.4f}; wall {wall_c:.2f} s; "
          f"K2 launches {counts['warp_affine']} (the perspective route "
          f"warps in plain PyTorch)", flush=True)
    del res

    # (d) the two-frame stitch
    y0, x0 = pos[0]
    gt = np.clip(ortho[y0:y0 + FRAME_H, x0:x0 + KNOB_PAIR_W], 0,
                 255).astype(np.uint8)
    for kind in ("similarity", "homography"):
        pano, wall_d, counts = _knob_run(
            torch, dev, f"pair {kind}",
            lambda: stitch_pair(imgs[0], imgs[1], tuning, model_kind=kind,
                                device=dev))
        add(counts)
        if abs(pano.shape[0] - FRAME_H) > SIZE_TOL_PX or \
                abs(pano.shape[1] - KNOB_PAIR_W) > SIZE_TOL_PX:
            _fail("knobs", f"pair {kind}: panorama {pano.shape[:2]} vs "
                           f"{(FRAME_H, KNOB_PAIR_W)}")
        rmse, dy, dx = gt_rmse(pano, gt, device=dev)
        if not np.isfinite(rmse) or rmse > GT_RMSE_MAX:
            _fail("knobs", f"pair {kind}: GT-RMSE {rmse} > {GT_RMSE_MAX}")
        if counts["sift_orient_desc"] <= 0:
            _fail("knobs", f"pair {kind}: K1 never launched")
        print(f"[smoke] knobs pair {kind}: panorama {pano.shape[0]}x"
              f"{pano.shape[1]} (planted {FRAME_H}x{KNOB_PAIR_W}), GT-RMSE "
              f"{rmse:.4f} at shift ({dy},{dx}), wall {wall_d:.2f} s",
              flush=True)
    k2f = phase_k2_f32(torch, dev, fed, imgs, pos, comp, cs)

    # (a) the calibrated run
    cam = CameraCalibration(name="visible", **KNOB_LENS)
    t0 = time.perf_counter()
    dist, shift = _distorted_frames(torch, dev, ortho, pos, cam)
    render_s = time.perf_counter() - t0
    calibrated = tuning.replace(
        calibration=MultiBandCalibration(visible=cam))

    def run_a():
        t1 = time.perf_counter()
        und = A.undistort_frames(dist, calibrated, "visible", dev)
        torch.cuda.synchronize()
        und_s = time.perf_counter() - t1
        return A.stitch_frames(und, ids, calibrated, dev), und_s

    (res, und_s), wall, counts = _knob_run(torch, dev, "calibrated", run_a)
    add(counts)
    err = _check_line(res, pos, "calibrated")
    y0, x0 = pos[0]
    gt = np.clip(ortho[y0:y0 + gt_h, x0:x0 + gt_w], 0, 255).astype(np.uint8)
    rmse, dy, dx = gt_rmse(res.panorama, gt, device=dev)
    if not np.isfinite(rmse) or rmse > GT_RMSE_MAX:
        _fail("knobs", f"calibrated GT-RMSE {rmse} > {GT_RMSE_MAX}")
    print(f"[smoke] knobs calibrated: lens fx=fy={cam.fx:.0f} k1={cam.dist[0]}"
          f" k2={cam.dist[1]} (planted shift up to {shift:.1f} px, {n} "
          f"distorted frames rendered in {render_s:.2f} s); undistortion "
          f"{und_s / n * 1e3:.1f} ms per frame; groups "
          f"{[len(g.indices) for g in res.groups]}, max offset error "
          f"{err:.4f} px, panorama {res.panorama.shape[0]}x"
          f"{res.panorama.shape[1]} (gt {gt_h}x{gt_w}), GT-RMSE {rmse:.4f} "
          f"at shift ({dy},{dx})", flush=True)
    del dist, res
    return total, k2f


def phase_k2_f32(torch, dev, fed, imgs, pos, tuning, cs):
    """(e) K2's float32 source at the compositing shape: the frame, affine
    and window of phase (b)'s first float32 compose feed, bit-equal to its
    plain version and timed as the other K2 rows; then the batched seam
    warp of every frame resized as (b) resized them, bit-equal too."""
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    from drone_image_stitch_cpp_tpu_torch.ops.blend import align_up
    from drone_image_stitch_cpp_tpu_torch.ops.resize import (
        resize_area, scale_for_megapixels)
    frame, a23, oh, ow = fed["img"], fed["a23"], fed["oh"], fed["ow"]
    frame = frame.contiguous()      # as the wrapper hands it to the kernel
    h, w = frame.shape[:2]
    inv = WK.inverse_coeffs(a23)
    n0 = WK.warp_frame.f32_launches
    wk, mk = WK.warp_frame(frame, a23, oh, ow)
    if WK.warp_frame.f32_launches != n0 + 1:
        _fail("k2", "float32 source did not count its launch")
    wp, mp = WK.warp_frame_plain(frame, inv, oh, ow)
    torch.cuda.synchronize()
    if not (torch.equal(wk, wp) and torch.equal(mk, mp)):
        d = float(torch.maximum((wk - wp).abs().max(),
                                (mk - mp).abs().max()))
        _fail("k2", f"float32 source not bit-identical to plain (max |d| "
                    f"{d})")
    covered = float((mk >= 0.5).float().mean())
    # the wrapper's launch (the host inverse's coefficients), bit-equal to
    # plain, with its tiles by route
    sets = WK.host_inverse_coeffs(a23)

    def launch(tiles=None):
        return WK._launch(frame, 1, sets, oh, ow, tiles=tiles)

    routes = _routes_of(torch, dev, launch)
    wr, mr, _ = launch()
    torch.cuda.synchronize()
    if not (torch.equal(wr, wp) and torch.equal(mr, mp)):
        _fail("k2", "float32 source: the wrapper's launch is not "
                    "bit-identical to plain")
    del wr, mr
    _check_routes("float32 source", routes, (1, oh, ow), {"direct": True})
    b2b_ms = _device_ms(lambda: WK.warp_frame(frame, a23, oh, ow), torch)
    device_ms = _device_ms(launch, torch)
    kernel_ms = _kernel_ms(torch, launch, "warp_affine_tile_kernel")
    plain_ms = _median_ms(lambda: WK.warp_frame_plain(frame, inv, oh, ow),
                          torch)
    import torch.nn.functional as F
    from drone_image_stitch_cpp_tpu_torch.ops.warp import dst_to_src_coords
    planes = torch.cat([frame.permute(2, 0, 1),
                        torch.ones((1, h, w), device=dev)])[None]
    sx, sy = dst_to_src_coords(torch.tensor(inv, dtype=torch.float32,
                                            device=dev).reshape(2, 3), oh, ow)
    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1],
                       dim=-1)[None]

    def library():
        return F.grid_sample(planes, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    # the wrapper and the library call in turns, in this call
    turns = {"wrapper": [], "grid_sample": []}
    for name in ("wrapper", "grid_sample", "grid_sample", "wrapper"):
        turns[name].append(_median_ms(
            (lambda: WK.warp_frame(frame, a23, oh, ow)) if name == "wrapper"
            else library, torch))
    library_ms = float(np.mean(turns["grid_sample"]))
    ms = float(np.mean(turns["wrapper"]))
    del planes, grid, sx, sy
    src_px = _k2_source_pixels(torch, dev, inv, h, w, oh, ow)
    n_bytes = 12.0 * src_px + 16.0 * oh * ow
    bound_ms, bound_by = _bound(n_bytes, 30.0 * oh * ow)
    print(f"[smoke] k2 warp_affine float32 source: {h}x{w} f32 (compositing "
          f"scale {cs:.4f}) -> {oh}x{ow}x3 + mask by {a23.tolist()}, window "
          f"coverage {covered:.3f}; wrapper and its launch bit-identical to "
          f"plain; tiles {routes}; wrapper {ms:.4f} ms (runs "
          f"{', '.join(f'{t:.4f}' for t in turns['wrapper'])}; {b2b_ms:.4f} "
          f"ms back to back), device {device_ms:.4f} ms, kernel "
          f"{kernel_ms:.4f} ms; plain {plain_ms:.3f} ms, grid_sample "
          f"{library_ms:.4f} ms (runs "
          f"{', '.join(f'{t:.4f}' for t in turns['grid_sample'])}); bound "
          f"{bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e6:.1f} MB), share "
          f"{bound_ms / kernel_ms:.3f}; wrapper / grid_sample "
          f"{ms / library_ms:.3f}", flush=True)
    row = {"shape": [h, w, oh, ow], "a23": a23.tolist(), "ms": ms,
           "wrapper_runs_ms": turns["wrapper"],
           "library_runs_ms": turns["grid_sample"],
           "wrapper_b2b_ms": b2b_ms, "device_ms": device_ms,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "share": bound_ms / kernel_ms,
           "max_abs_err": 0.0, "tiles": routes}

    # the batched seam warp of the resized frames (strip.compose_strip)
    rh_, rw_ = int(round(FRAME_H * cs)), int(round(FRAME_W * cs))
    frames = torch.stack([resize_area(torch.from_numpy(im).to(dev).float(),
                                      rh_, rw_) for im in imgs])
    ss = scale_for_megapixels(rh_, rw_, tuning.seam_estimation_resol_mpx)
    xs = [p[1] - pos[0][1] for p in pos]
    sh = align_up(int(round(rh_ * ss)), 64)
    sw = align_up(int(round((max(xs) * cs + rw_) * ss)), 64)
    a23s = np.stack([np.asarray([[ss, 0, ss * cs * x], [0, ss, 0]],
                                np.float32) for x in xs])
    wb, mb = WK.warp_frames(frames, a23s, sh, sw)
    invs = [WK.inverse_coeffs(a) for a in a23s]
    for k in range(len(imgs)):
        wp, mp = WK.warp_frame_plain(frames[k], invs[k], sh, sw)
        if not (torch.equal(wb[k], wp) and torch.equal(mb[k], mp)):
            _fail("k2", f"float32 seam batch: frame {k} differs from its "
                        f"plain warp")
    table = torch.tensor(invs, dtype=torch.float32, device=dev)
    tiles = _routes_of(torch, dev, lambda c: WK._launch(
        frames, len(imgs), invs, sh, sw, tiles=c))
    _check_routes("float32 seam batch", tiles, (len(imgs), sh, sw),
                  {"zero": True, "direct": True})
    batch_ms = _device_ms(lambda: WK._launch(frames, len(imgs), invs, sh,
                                             sw, table=table), torch)
    batch_kernel_ms = _kernel_ms(torch, lambda: WK._launch(
        frames, len(imgs), invs, sh, sw), "warp_affine_tile_kernel")
    src_px = sum(_k2_source_pixels(torch, dev, inv, rh_, rw_, sh, sw)
                 for inv in invs)
    n_out = len(imgs) * sh * sw
    b_ms, b_by = _bound(12.0 * src_px + 16.0 * n_out, 30.0 * n_out)
    print(f"[smoke] k2 warp_affine float32 seam batch: {len(imgs)} x {rh_}x"
          f"{rw_} f32 -> {sh}x{sw} (seam scale {ss:.4f}) in one launch, "
          f"every frame bit-identical to plain; tiles {tiles}; device "
          f"{batch_ms:.4f} ms, kernel {batch_kernel_ms:.4f} ms; bound "
          f"{b_ms:.4f} ms by {b_by}, share {b_ms / batch_kernel_ms:.3f}",
          flush=True)
    row["seam_batch"] = {"shape": [len(imgs), sh, sw], "device_ms": batch_ms,
                         "kernel_ms": batch_kernel_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "share": b_ms / batch_kernel_ms,
                         "tiles": tiles}
    return row


def _jfif_i420(bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (H*3/2, W) packed I420 by the full-range
    JFIF forward transform with 2x2 chroma means (see phase_i420)."""
    h, w = bgr.shape[:2]
    b, g, r = (bgr[..., c].astype(np.float32) for c in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    cb = cb.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    cr = cr.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    def u8(p):
        return np.clip(np.round(p), 0, 255).astype(np.uint8)

    return np.concatenate([u8(y), u8(cb).reshape(h // 4, w),
                           u8(cr).reshape(h // 4, w)])


def _feed_affine() -> np.ndarray:
    """The affine of phase_k2's compose feed (a 2-degree turn into the
    K2_WIN window), which the I420 rows reuse."""
    th = np.radians(2.0)
    c, s_ = np.cos(th), np.sin(th)
    return np.asarray([[c, -s_, 12000.37 - 11904.0], [s_, c, 20.61]],
                      np.float32)


def _k2_i420_row(torch, dev, label, frames, a23s, oh, ow, regs):
    """K2's I420 source on ``frames`` ((N, H*3/2, W) packed, one launch;
    N == 1 is the compose feed's single-frame call) through its wrapper
    (the kernel the host plan picks) and with each kernel forced, against
    its plain version (yuv420_to_bgr, then the float warp): each
    bit-equal, each timed as the other K2 rows, in turns in this call (per
    tap, staged, staged, per tap; the staged kernel where its box fits a
    block's shared memory). The library time is yuv420_to_bgr +
    F.grid_sample on the same samples. ``regs``: ptxas's registers by
    entry."""
    import torch.nn.functional as F
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    from drone_image_stitch_cpp_tpu_torch.ops.color import yuv420_to_bgr
    from drone_image_stitch_cpp_tpu_torch.ops.warp import dst_to_src_coords
    nf = frames.shape[0]
    h, w = frames.shape[1] * 2 // 3, frames.shape[2]
    invs = [WK.inverse_coeffs(a) for a in a23s]
    plan = WK.i420_plan(invs, h, w, oh, ow)
    box = WK.i420_box(invs, h, w, oh, ow)
    smem = WK.i420_smem_bytes(box, h, w)
    n0 = (WK.warp_frame.i420_launches, WK.warp_frame.i420_staged_launches)
    if nf == 1:
        def wrapper():
            return WK.warp_frame(frames[0], a23s[0], oh, ow)
        bare, table = (frames[0], 1, invs[0]), None
    else:
        def wrapper():
            return WK.warp_frames(frames, a23s, oh, ow)
        bare = (frames, nf, invs)
        table = torch.tensor(invs, dtype=torch.float32, device=dev)
    branches = {"per_tap": False}
    if smem <= SMEM_PER_BLOCK:
        branches["staged"] = True
    outs = {"wrapper": wrapper()}
    if (WK.warp_frame.i420_launches, WK.warp_frame.i420_staged_launches) \
            != (n0[0] + 1, n0[1] + (plan is not None)):
        _fail("i420", f"{label}: the I420 source did not count its launch "
                      f"as its plan ({plan}) says")
    for name, staged in branches.items():
        outs[name] = WK._launch(*bare, oh, ow, table=table,
                                i420_staged=staged)[:2]
    for k in range(nf):
        wp, mp = WK.warp_frame_plain(frames[k], invs[k], oh, ow)
        for name, (wk, mk) in outs.items():
            wk, mk = wk.reshape(nf, oh, ow, 3)[k], mk.reshape(nf, oh, ow)[k]
            if not (torch.equal(wk, wp) and torch.equal(mk, mp)):
                d = float(torch.maximum((wk - wp).abs().max(),
                                        (mk - mp).abs().max()))
                _fail("i420", f"{label} {name}: frame {k} not bit-identical "
                              f"to its plain version (max |d| {d})")
        del wp, mp
    covered = float((outs["wrapper"][1] >= 0.5).float().mean())
    del outs
    tiles = _routes_of(torch, dev, lambda c: WK._launch(
        *bare, oh, ow, table=table, i420_staged=False, tiles=c))
    _check_routes(f"I420 {label} per tap", tiles, (nf, oh, ow),
                  {"direct": True, **({"zero": True} if nf > 1 else {})})
    ms = _median_ms(wrapper, torch)
    times = {name: [] for name in branches}
    ktimes = {name: [] for name in branches}
    kname = {"per_tap": "warp_affine_tile_kernel",
             "staged": "warp_i420_staged_kernel"}
    for name in list(branches) + list(branches)[::-1]:
        def launch():
            return WK._launch(*bare, oh, ow, table=table,
                              i420_staged=branches[name])
        times[name].append(_device_ms(launch, torch))
        ktimes[name].append(_kernel_ms(torch, launch, kname[name]))
    device = {name: float(np.mean(t)) for name, t in times.items()}
    kernel = {name: float(np.mean(t)) for name, t in ktimes.items()}
    plan_name = "staged" if plan else "per_tap"
    if "staged" in kernel and kernel["per_tap"] < kernel[plan_name]:
        _fail("i420", f"{label}: the per-tap gather ({kernel['per_tap']:.4f} "
                      f"ms) beats the plan's staged kernel "
                      f"({kernel['staged']:.4f} ms; kernel times)")
    plain_ms = _median_ms(lambda: [WK.warp_frame_plain(frames[k], invs[k],
                                                       oh, ow)
                                   for k in range(nf)], torch)
    grid = torch.stack([torch.stack(
        [sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], dim=-1)
        for sx, sy in (dst_to_src_coords(torch.tensor(
            inv, dtype=torch.float32, device=dev).reshape(2, 3), oh, ow)
            for inv in invs)])
    ones = torch.ones((nf, 1, h, w), device=dev)

    def library():
        bgr = yuv420_to_bgr(frames).permute(0, 3, 1, 2)
        return F.grid_sample(torch.cat([bgr, ones], dim=1), grid,
                             mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    library_ms = _median_ms(library, torch)
    del grid, ones
    src_px = sum(_k2_source_pixels(torch, dev, inv, h, w, oh, ow)
                 for inv in invs)
    n_out = nf * oh * ow
    n_bytes = 1.5 * src_px + 16.0 * n_out
    bound_ms, bound_by = _bound(n_bytes, I420_OPS_PER_PX * n_out)
    print(f"[smoke] k2 warp_affine I420 source {label}: {nf} x {h}x{w} "
          f"packed I420 -> {oh}x{ow}x3 + mask in one launch, coverage "
          f"{covered:.3f}; plan {plan_name} (largest tile box {box[0]}x"
          f"{box[1]} px, {smem} B of shared memory); wrapper and both "
          f"kernels bit-identical to plain; per-tap tiles {tiles}; wrapper "
          f"{ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, yuv420_to_bgr + grid_sample "
          f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"({n_bytes / 1e6:.1f} MB)", flush=True)
    row = {"shape": [nf, h, w, oh, ow], "plan": plan_name, "box": list(box),
           "ms": ms, "device_ms": device[plan_name],
           "kernel_ms": kernel[plan_name], "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "share": bound_ms / kernel[plan_name],
           "max_abs_err": 0.0, "per_tap_tiles": tiles}
    for name in ("per_tap", "staged"):
        block = smem if name == "staged" else 0
        if name not in device:
            row[name] = {"launched": False, "smem_bytes": smem}
            print(f"[smoke] k2 I420 {label} staged: not launched, its "
                  f"{box[0]}x{box[1]} box needs {smem} B of shared memory, "
                  f"above a block's {SMEM_PER_BLOCK}", flush=True)
            continue
        row[name] = {"device_ms": device[name], "device_ms_runs": times[name],
                     "kernel_ms": kernel[name],
                     "kernel_ms_runs": ktimes[name],
                     "share": bound_ms / kernel[name],
                     "registers": regs.get(f"i420_{name}", -1),
                     "smem_bytes": block}
        print(f"[smoke] k2 I420 {label} {name}: device {device[name]:.4f} ms "
              f"(runs {', '.join(f'{t:.4f}' for t in times[name])}), kernel "
              f"{kernel[name]:.4f} ms (runs "
              f"{', '.join(f'{t:.4f}' for t in ktimes[name])}), share "
              f"{bound_ms / kernel[name]:.3f}, "
              f"{row[name]['registers']} "
              f"registers, {block} B of dynamic shared memory a block",
              flush=True)
    if "staged" in kernel:
        row["staged_speedup"] = kernel["per_tap"] / kernel["staged"]
        print(f"[smoke] k2 I420 {label}: staged {row['staged_speedup']:.2f}x "
              f"the per-tap kernel's speed", flush=True)
    return row


def phase_i420(torch, dev, ortho, imgs, ids, pos, tuning, bgr, regs):
    """The I420 ingest wire on the corridor (the JAX package's store
    format for a drone's 4:2:0 JPEGs). The packed frames are made here from
    the rendered BGR with the full-range JFIF forward transform, as a
    camera's encoder makes them (the flagship phase feeds the store the
    codec's raw planes of real JPEGs):
        Y  = .299 R + .587 G + .114 B
        Cb = -.168736 R - .331264 G + .5 B + 128
        Cr = .5 R - .418688 G - .081312 B + 128,
    chroma as 2x2 means, each plane rounded and clipped to [0, 255].
    app.stitch_frames from FrameStore(packed, fmt="yuv420") runs twice
    (the second measured, its launch counts set to 0 just before it): the
    corridor's geometry checks, GT-RMSE within I420_TOL_RMSE of the BGR
    corridor's (``bgr``: phase 4's result), K1 4 launches and every K2
    launch from the I420 source, every compose feed (warp_frame) from its
    staged kernel and every seam batch (warp_frames, a 0.12 downscale) per
    tap, as the host plan says; wall and peak memory beside the BGR pass.
    A third pass with the plan forced to the per-tap kernel: the same
    panorama, so the same GT-RMSE. Then K2's I420 source at the compose
    feed and the 12-frame seam batch, the wrapper and each kernel
    bit-equal to the plain version (``regs``: ptxas's registers by
    entry); then the half-resolution
    store: two corridor frames written as JPEG by the codec, read back
    with scale_denom=2 (libjpeg's DCT scaling: the store's frames equal the
    codec's scaled decode) and detected with coord_scale=2: the planted
    offset within 1 px. Returns (launch counts, the two K2 rows)."""
    from drone_image_stitch_cpp_tpu_torch.app import stitch_frames
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    from drone_image_stitch_cpp_tpu_torch.pipeline.pairgraph import (
        register_pairs)
    from drone_image_stitch_cpp_tpu_torch.pipeline.registration import (
        detect_features)
    from drone_image_stitch_cpp_tpu_torch.runtime.feed import FrameStore
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
    from drone_image_stitch_cpp_tpu_torch.utils.native import (
        decode_batch_native, encode_jpeg_native)
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

    t0 = time.perf_counter()
    packed = [_jfif_i420(im) for im in imgs]
    make_s = time.perf_counter() - t0
    stitch_frames(None, ids, tuning, dev,
                  store=FrameStore(packed, dev, fmt="yuv420"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    log = get_logger()
    mark = len(log._records)
    _zero_counts()
    t0 = time.perf_counter()
    res = stitch_frames(None, ids, tuning, dev,
                        store=FrameStore(packed, dev, fmt="yuv420"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    feeds, batches = WK.warp_frame.launches, WK.warp_frames.launches
    peak = torch.cuda.max_memory_allocated(dev)
    stages = ", ".join(f"{k}={v}" for k, v in _stage_seconds(
        log._records[mark:], ("Main", "Single")).items())
    # the same pass with every I420 launch per tap
    plan = WK.i420_plan
    WK.i420_plan = lambda *a: None
    try:
        n0 = WK.warp_frame.i420_staged_launches
        per_tap = stitch_frames(None, ids, tuning, dev,
                                store=FrameStore(packed, dev, fmt="yuv420"))
        if WK.warp_frame.i420_staged_launches != n0:
            _fail("i420", "the per-tap pass launched the staged kernel")
    finally:
        WK.i420_plan = plan
    err = _check_line(res, pos, "i420")
    gt_h = FRAME_H
    gt_w = FRAME_W + (len(imgs) - 1) * (pos[1][1] - pos[0][1])
    pano = res.panorama
    if abs(pano.shape[0] - gt_h) > SIZE_TOL_PX or \
            abs(pano.shape[1] - gt_w) > SIZE_TOL_PX:
        _fail("i420", f"panorama {pano.shape[:2]} vs {(gt_h, gt_w)}")
    y0, x0 = pos[0]
    gt = np.clip(ortho[y0:y0 + gt_h, x0:x0 + gt_w], 0, 255).astype(np.uint8)
    rmse, dy, dx = gt_rmse(pano, gt, device=dev)
    if not np.isfinite(rmse) or abs(rmse - bgr["rmse"]) > I420_TOL_RMSE:
        _fail("i420", f"GT-RMSE {rmse} vs the BGR corridor's "
                      f"{bgr['rmse']} (tolerance {I420_TOL_RMSE})")
    k2 = counts["warp_affine"]
    if counts["sift_orient_desc"] != 4 or k2 <= 0 or \
            counts["warp_affine_i420"] != k2:
        _fail("i420", f"launches {counts}: K1 4 expected, every K2 launch "
                      f"from the I420 source")
    if feeds <= 0 or counts["warp_affine_i420_staged"] != feeds or \
            k2 - feeds != batches:
        _fail("i420", f"launches {counts}: {feeds} compose feeds, all "
                      f"staged, and {batches} seam batches per tap expected")
    rmse_pt = gt_rmse(per_tap.panorama, gt, device=dev)[0]
    if not np.array_equal(per_tap.panorama, pano) or rmse_pt != rmse:
        _fail("i420", f"the per-tap pass's panorama differs (GT-RMSE "
                      f"{rmse_pt} vs the staged pass's {rmse})")
    del per_tap
    print(f"[smoke] i420 corridor: {len(packed)} frames packed in "
          f"{make_s:.2f} s; groups {[len(g.indices) for g in res.groups]}, "
          f"max offset error {err:.4f} px, panorama {pano.shape[0]}x"
          f"{pano.shape[1]}, GT-RMSE {rmse:.4f} at shift ({dy},{dx}) (BGR "
          f"corridor {bgr['rmse']:.4f}); wall {wall:.2f} s (BGR "
          f"{bgr['wall']:.2f} s), peak memory {peak / 2**30:.3f} GiB (BGR "
          f"{bgr['peak'] / 2**30:.3f} GiB); launches {counts}", flush=True)
    print(f"[smoke] i420 stages (s): {stages}", flush=True)
    print(f"[smoke] i420 kernels: {feeds} compose feeds staged, {batches} "
          f"seam batch per tap (the plan's choices); the pass with every "
          f"launch per tap gave the same panorama, GT-RMSE {rmse_pt:.4f}",
          flush=True)
    del res, pano

    # K2's I420 source at the compose feed (phase_k2's window and affine)
    # and at the seam batch (phase_k2_batch's)
    dev_packed = torch.from_numpy(np.stack(packed)).to(dev)
    oh, ow = K2_WIN
    mid = len(packed) // 2
    feed = _k2_i420_row(torch, dev, "compose feed",
                        dev_packed[mid:mid + 1], _feed_affine()[None], oh, ow,
                        regs)
    a23s, sh, sw, _ = _seam_affines(pos, tuning)
    seam = _k2_i420_row(torch, dev, "seam batch", dev_packed, a23s, sh, sw,
                        regs)
    del dev_packed

    # the half-resolution store
    work = tempfile.mkdtemp(prefix="smoke_halfres_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        paths = []
        for k in (0, 1):
            paths.append(os.path.join(work, f"F{k}.jpg"))
            encode_jpeg_native(paths[-1], imgs[k], 95)
        t0 = time.perf_counter()
        st = FrameStore.from_paths(paths, dev, scale_denom=2)
        feats, scale = detect_features(None, tuning.sift_features,
                                       tuning.registration_resol_mpx,
                                       store=st, indices=[0, 1],
                                       coord_scale=2.0)
        graph = register_pairs(feats, [(0, 1)], 0.75, thresh=4.0 / scale)
        model = graph.model[0].cpu().numpy()
        half_s = time.perf_counter() - t0
        dct = decode_batch_native(paths, 2, scale_denom=2)
        if not all(np.array_equal(st.frame(k).cpu().numpy(), dct[k])
                   for k in (0, 1)):
            _fail("i420", "the half-resolution store's frames are not the "
                          "codec's DCT-scaled decode")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    planted = np.asarray([pos[1][1] - pos[0][1], pos[1][0] - pos[0][0]],
                         np.float64)
    half_err = float(np.abs(model[:2, 2] + planted).max())
    if st.fmt != "bgr" or st.shape0 != (FRAME_H // 2, FRAME_W // 2, 3) or \
            not bool(graph.ok[0]) or half_err > OFFSET_TOL_PX:
        _fail("i420", f"half-resolution store: fmt {st.fmt}, shape "
                      f"{st.shape0}, ok {bool(graph.ok[0])}, model "
                      f"translation {model[:2, 2].tolist()} vs the planted "
                      f"{(-planted).tolist()}")
    print(f"[smoke] i420 half-resolution store: 2 corridor JPEGs read at "
          f"1/2 by libjpeg's DCT scaling ({st.shape0[0]}x{st.shape0[1]}, fmt "
          f"{st.fmt}, equal to the codec's scaled decode), detected "
          f"with coord_scale=2 at work scale {scale:.4f} of full "
          f"resolution: translation {np.round(model[:2, 2], 4).tolist()} "
          f"vs planted {(-planted).tolist()} (error {half_err:.4f} px), "
          f"{half_s:.2f} s", flush=True)
    return counts, feed, seam



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


def phase_k1_global(torch, padded, true_hw, tuning, label="global detect",
                    min_valid=K1_GLOBAL_MIN_VALID):
    """K1 at the global stage's strip detect: one padded strip's work
    image (<= 2800 px wide), the global feature budget, one launch."""
    from drone_image_stitch_cpp_tpu_torch.pipeline.global_ import (
        strip_work_image)
    work = strip_work_image(padded, true_hw)[0]
    return _k1_check(torch, work[None], label, tuning.global_sift_features,
                     min_valid=min_valid)


def phase_k2_content(torch, dev, padded):
    """K2's content mode as the global compose calls it: a padded strip
    into the 5120x5120 tile window (a near-identity affine, the second
    line's offset), with crafted pixels of gray 2 and 3 planted in the
    strip; bit-equal to its plain version."""
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
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
    row = _k2_content_times(torch, dev, src, a23, oh, ow)
    h, w = src.shape[:2]
    print(f"[smoke] k2 warp_affine content mode: {h}x{w} u8 padded strip "
          f"-> {oh}x{ow}x3 + gray>2 mask, kept (>=0.999) {kept:.3f}; "
          f"bit-identical to plain (crafted gray-2/3 pixels included); "
          + _k2_row_text(row), flush=True)
    return row


def _k2_content_times(torch, dev, src, a23, oh, ow):
    """K2's content mode from the uint8 ``src`` by ``a23`` into (oh, ow),
    timed as every K2 row: the wrapper, the bare launch, the plain
    version, F.grid_sample on BGR + the gray > 2 plane (made outside the
    timed call) and the bound (3 B per touched source pixel, 16 B per
    output pixel written)."""
    import torch.nn.functional as F
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    from drone_image_stitch_cpp_tpu_torch.ops.color import content_mask
    from drone_image_stitch_cpp_tpu_torch.ops.warp import dst_to_src_coords
    inv = WK.inverse_coeffs(a23)
    ms = _median_ms(lambda: WK.warp_frame(src, a23, oh, ow,
                                          content="nonblack"), torch)
    device_ms = _device_ms(lambda: WK._launch(src, 1, inv, oh, ow,
                                              "nonblack"), torch)
    kernel_ms = _kernel_ms(torch, lambda: WK._launch(src, 1, inv, oh, ow,
                                                     "nonblack"),
                           "warp_affine_tile_kernel")
    plain_ms = _median_ms(lambda: WK.warp_frame_plain(
        src, inv, oh, ow, content="nonblack"), torch)
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
    return {"shape": [h, w, oh, ow], "ms": ms, "device_ms": device_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share": bound_ms / kernel_ms,
            "max_abs_err": 0.0, "bytes": n_bytes}


def _k2_row_text(row):
    return (f"wrapper {row['ms']:.4f} ms, device {row['device_ms']:.4f} ms, "
            f"kernel {row['kernel_ms']:.4f} ms, "
            f"plain {row['plain_ms']:.3f} ms, grid_sample "
            f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']} ({row['bytes'] / 1e6:.1f} MB), share "
            f"{row['share']:.3f}")


def phase_k2_seam_fullres(torch, dev, padded, scale, step_y, sh, sw,
                          label):
    """K2's content mode as the global stage's full-resolution seam warp
    calls it (``pipeline/global_._to_seam_fullres``, ``seam_warp=
    "fullres"``): the padded strip of the second line minified by the
    seam ``scale`` into the (sh, sw) seam canvas at its planted offset
    ``step_y``; one launch, bit-equal to its plain version, timed as
    every K2 row."""
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    from drone_image_stitch_cpp_tpu_torch.pipeline import global_ as TG
    a23 = np.asarray([[scale, 0.0, 0.0], [0.0, scale, scale * step_y]],
                     np.float32)
    n0 = WK.warp_frame.nonblack_launches
    simg, smask = TG._to_seam_fullres(padded, a23, sh, sw)
    if WK.warp_frame.nonblack_launches != n0 + 1:
        _fail("k2", f"{label}: the full-resolution seam warp made "
                    f"{WK.warp_frame.nonblack_launches - n0} content-mode "
                    f"launches, expected 1")
    wp, mp = WK.warp_frame_plain(padded, WK.inverse_coeffs(a23), sh, sw,
                                 content="nonblack")
    torch.cuda.synchronize()
    if not (torch.equal(simg, wp) and torch.equal(smask, mp >= 0.999)):
        d = float((simg - wp).abs().max())
        _fail("k2", f"{label}: the full-resolution seam warp is not "
                    f"bit-identical to plain (max |d| {d})")
    kept = float(smask.float().mean())
    del simg, smask, wp, mp
    row = _k2_content_times(torch, dev, padded, a23, sh, sw)
    h, w = padded.shape[:2]
    print(f"[smoke] k2 warp_affine content mode {label}: {h}x{w} u8 padded "
          f"strip at full resolution -> {sh}x{sw} seam canvas (scale "
          f"{scale:.4f}, one launch), kept (>=0.999) {kept:.3f}; "
          f"bit-identical to plain; " + _k2_row_text(row), flush=True)
    return {**row, "scale": scale}


def _counts():
    from drone_image_stitch_cpp_tpu_torch.tools.bench_sortie import (
        launch_counts)
    return launch_counts()


def _zero_counts():
    from drone_image_stitch_cpp_tpu_torch.tools.bench_sortie import (
        zero_launch_counts)
    zero_launch_counts()


def _cut_value(lab, cs, ck, ch, cv) -> float:
    """The float64 value of the cut ``lab`` (1 = source side)."""
    src = lab.astype(bool)
    f64 = np.float64
    return float(np.where(~src, cs, 0).astype(f64).sum()
                 + np.where(src, ck, 0).astype(f64).sum()
                 + (ch.astype(f64) * (src[:, :-1] != src[:, 1:])).sum()
                 + (cv.astype(f64) * (src[:-1, :] != src[1:, :])).sum())


def _maxflow_check(torch, dev, solves, launches):
    """csrc/maxflow.cu on the seam problems a measured multi-line pass
    solved (``solves``: each problem's four host grids and the labels the
    pass got): each grid uploaded and contracted on the card once, the
    kernel's rounds beside rounds_plain's on that same ribbon (equal
    sides, rounds and relabels), the labels the pass's, and the host
    engine's or a tie with them (float64 cut values within 1e-6); the
    pass's ``launches`` one a batch of rounds. Returns the kernels line's
    entry: ms the wrapper (upload to labels on the card), device_ms the
    rounds between CUDA events, bound_ms 36 B a slot a round x slots x
    rounds over 3.35 TB/s (a lower bound for this algorithm, not for the
    cut), each summed over the solves."""
    from drone_image_stitch_cpp_tpu_torch.ops import maxflow_kernel as MK
    from drone_image_stitch_cpp_tpu_torch.utils.native import (
        graphcut_native)

    if not solves:
        _fail("maxflow", "the multi-line pass handed the card no seam "
                         "problem")
    rows, batches = [], 0
    for prob, lab_pass in solves:
        grids = [torch.from_numpy(np.ascontiguousarray(c, np.float32)).to(
            dev) for c in prob]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lab, counts = MK.min_cut(*grids)
        lab = lab.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        rib = MK.contract(*grids)
        slots = rib.tr.numel()
        dev_ms = plain_ms = 0.0
        same = True
        if rib.n_free:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            side_k, rounds, relabels = MK.rounds_kernel(rib)
            b.record()
            b.synchronize()
            dev_ms = a.elapsed_time(b)
            t0 = time.perf_counter()
            side_p, rounds_p, relabels_p = MK.rounds_plain(rib)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            same = torch.equal(side_k, side_p)
            if not same or (rounds, relabels) != (rounds_p, relabels_p):
                _fail("maxflow", f"{rib.h}x{rib.w}: the kernel's side, "
                                 f"rounds {rounds}, relabels {relabels} "
                                 f"against rounds_plain's (same side: "
                                 f"{same}, rounds {rounds_p}, relabels "
                                 f"{relabels_p})")
            batches += -(-rounds // MK.BATCH_ROUNDS)
        else:
            rounds = relabels = 0
        if (counts["rounds"], counts["relabels"]) != (rounds, relabels) \
                or not np.array_equal(lab, lab_pass):
            _fail("maxflow", f"{rib.h}x{rib.w}: a second solve differs from "
                             f"the pass's ({counts} against rounds {rounds}, "
                             f"relabels {relabels})")
        host = graphcut_native(*prob)
        differ = int((host != lab).sum())
        cuts = None
        if differ:
            cuts = [_cut_value(x, *prob) for x in (lab, host)]
            if abs(cuts[0] - cuts[1]) > 1e-6 * max(abs(cuts[1]), 1.0):
                _fail("maxflow", f"{rib.h}x{rib.w}: {differ} labels differ "
                                 f"from the host engine's, cut values "
                                 f"{cuts} (card, host)")
        rows.append({"shape": [rib.h, rib.w], "slots": slots,
                     "free": rib.n_free, "rounds": rounds,
                     "relabels": relabels, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms,
                     "bound_ms": _bound(36.0 * slots * rounds, 0.0)[0],
                     "host_differ": differ, "cut_values": cuts})
    if launches != batches:
        _fail("maxflow", f"{launches} launches in the pass, {batches} "
                         f"batches of {MK.BATCH_ROUNDS} rounds expected")
    tot = {k: sum(r[k] for r in rows)
           for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    print(f"[smoke] maxflow: the pass's {len(rows)} seam solves on the card "
          f"(slots {[r['slots'] for r in rows]}, rounds "
          f"{[r['rounds'] for r in rows]}): kernel = rounds_plain on the "
          f"same ribbons (sides, rounds, relabels), labels the pass's; "
          f"host engine labels differ by {[r['host_differ'] for r in rows]} "
          f"(any a tie); {launches} launches in the pass; wrapper "
          f"{tot['ms']:.2f} ms, rounds {tot['device_ms']:.2f} ms, plain "
          f"{tot['plain_ms']:.1f} ms, bound {tot['bound_ms']:.2f} ms, share "
          f"{tot['bound_ms'] / max(tot['device_ms'], 1e-9):.3f}", flush=True)
    return {"name": "maxflow_run", "route": "cuda",
            "source": "drone_image_stitch_cpp_tpu_torch/csrc/maxflow.cu",
            "replaces": "drone_image_stitch_cpp_tpu_torch/csrc/graphcut.cpp "
                        "(host; no TPU kernel)",
            "launches": launches, "max_abs_err": 0.0, **tot,
            "bound_by": "bytes", "library_ms": None, "kernel_ms": None,
            "share": tot["bound_ms"] / max(tot["device_ms"], 1e-9),
            "solves": rows}


def _dp_seam_check(torch, scans, launches):
    """csrc/dp_seam.cu on the DP seam costs a measured multi-line pass
    scanned (``scans``: each cost and the path the pass got): the kernel's
    path the plain version's and the pass's, ``launches`` one a scan.
    Returns the kernels line's entry: device_ms the launches between CUDA
    events, plain_ms the plain version, bound_ms the cost read and the
    move table written once (5 B a pixel) over 3.35 TB/s, summed."""
    from drone_image_stitch_cpp_tpu_torch.ops import seam_kernel as DK

    if not scans:
        _fail("dp_seam", "the multi-line pass made no DP seam scan")
    if launches != len(scans):
        _fail("dp_seam", f"{launches} launches in the pass, {len(scans)} "
                         f"scans on the card")
    dev_ms = plain_ms = px = 0.0
    for cost, xs_pass in scans:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        xs = DK._launch(cost)
        b.record()
        b.synchronize()
        dev_ms += a.elapsed_time(b)
        t0 = time.perf_counter()
        xs_p = DK.seam_path_plain(cost)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        if not (torch.equal(xs, xs_p) and torch.equal(xs, xs_pass)):
            _fail("dp_seam", f"{tuple(cost.shape)}: the kernel's path is "
                             f"not the plain version's and the pass's")
        px += cost.numel()
    bound_ms, bound_by = _bound(5.0 * px, 3.0 * px)
    print(f"[smoke] dp_seam: the pass's {len(scans)} DP scans ({px / 1e6:.1f}"
          f" Mpx) = the plain version's paths; {launches} launches in the "
          f"pass; kernel {dev_ms:.2f} ms, plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}; the rows' barrier bounds it)",
          flush=True)
    return {"name": "dp_seam_path", "route": "cuda",
            "source": "drone_image_stitch_cpp_tpu_torch/csrc/dp_seam.cu",
            "replaces": "drone_image_stitch_cpp_tpu/ops/seam.py "
                        "(lax.scan; no Pallas kernel)",
            "launches": launches, "max_abs_err": 0.0, "ms": None,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "share": bound_ms / max(dev_ms, 1e-9),
            "kernel_ms": None, "device_ms": dev_ms, "scans": len(scans)}


def phase_multiline(torch, dev, ortho, imgs, ids, pos, tuning, first):
    """The multi-line main path through app.stitch_frames, measured pass
    (the production phase's run before it is the warm-up: ``first`` holds
    its wall and its strips as the global stage received them, host
    copies); hard checks as the module doc lists."""
    from drone_image_stitch_cpp_tpu_torch import app as A
    from drone_image_stitch_cpp_tpu_torch.ops import maxflow_kernel as MK
    from drone_image_stitch_cpp_tpu_torch.ops import seam as S
    from drone_image_stitch_cpp_tpu_torch.ops import seam_kernel as DK
    from drone_image_stitch_cpp_tpu_torch.runtime.handoff import DeviceStrip
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
    from drone_image_stitch_cpp_tpu_torch.utils.native import (
        graphcut_library)
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

    log = get_logger()
    log.verbose = False
    step_y, (gt_h, gt_w), (oy, ox) = _ml_geometry(pos)
    real_global = A.stitch_inter_strips_custom
    real_solve, real_scan = MK.graphcut_device, S.seam_path
    seen = {}
    solves, scans = [], []

    def solve_probe(*args):
        # each seam problem the global stage hands the card (its four
        # grids, then the device), and its labels
        lab = real_solve(*args)
        solves.append((args[:4], lab))
        return lab

    def scan_probe(cost):
        # each DP seam scan's cost and path
        xs = real_scan(cost)
        if cost.is_cuda:
            scans.append((cost.clone(memory_format=torch.contiguous_format),
                          xs))
        return xs

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
    MK.graphcut_device, S.seam_path = solve_probe, scan_probe
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
        MK.min_cut.launches = DK.seam_path.launches = 0
        t0 = time.perf_counter()
        res = A.stitch_frames(imgs, ids, tuning, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        mf_launches, dp_launches = MK.min_cut.launches, DK.seam_path.launches
    finally:
        A.stitch_inter_strips_custom = real_global
        MK.graphcut_device, S.seam_path = real_solve, real_scan
    peak = torch.cuda.max_memory_allocated(dev)
    stages = _stage_seconds(log._records[mark:])

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
    mf = _maxflow_check(torch, dev, solves, mf_launches)
    del solves
    dp = _dp_seam_check(torch, scans, dp_launches)
    del scans
    torch.cuda.empty_cache()
    return launches, {"res": res, "wall": wall, "peak": peak,
                      "stages": stages, "maxflow": mf, "dp_seam": dp}


def phase_multiline_switches(torch, dev, ortho, imgs, ids, pos, tuning, ref,
                             ref_launches):
    """One more multi-line pass with both of the global stage's seam
    switches (app.stitch_frames(seam_warp="fullres", seam_method="dp")),
    its launch counts set to 0 just before it and read just after; hard
    checks against phase 5's default pass (``ref``, ``ref_launches``) as
    the module doc lists. Returns (launches, the seam scale record)."""
    from drone_image_stitch_cpp_tpu_torch import app as A
    from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
    from drone_image_stitch_cpp_tpu_torch.pipeline import global_ as TG
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

    log = get_logger()
    step_y, (gt_h, gt_w), (oy, ox) = _ml_geometry(pos)
    real = TG._to_seam_fullres
    per_strip = []

    def counted(*a, **kw):
        # the content-mode launches each strip's seam warp makes
        n0 = WK.warp_frame.nonblack_launches
        out = real(*a, **kw)
        per_strip.append(WK.warp_frame.nonblack_launches - n0)
        return out

    TG._to_seam_fullres = counted
    try:
        mark = len(log._records)
        _zero_counts()
        t0 = time.perf_counter()
        res = A.stitch_frames(imgs, ids, tuning, dev, seam_warp="fullres",
                              seam_method="dp")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
    finally:
        TG._to_seam_fullres = real
    recs = log._records[mark:]
    stages = _stage_seconds(recs)
    scale = next(r for r in recs if r["msg"] == "seam scale")
    switch = [(r["warp"], r["method"]) for r in recs if r["msg"] == "seam"]
    dref = ref["res"]
    if [g.indices for g in res.groups] != [g.indices for g in dref.groups]:
        _fail("switches", f"groups {[g.indices for g in res.groups]}, the "
                          f"default pass's {[g.indices for g in dref.groups]}")
    if any(res.flipped):
        _fail("switches", f"flipped {res.flipped}")
    offs = np.asarray([t[:2, 2] for t in res.global_transforms], np.float64)
    ref_offs = np.asarray([t[:2, 2] for t in dref.global_transforms],
                          np.float64)
    off_d = float(np.abs(offs - ref_offs).max())
    if off_d > ML_STRIP_TOL_PX:
        _fail("switches", f"strip offsets {offs.tolist()} off the default "
                          f"pass's {ref_offs.tolist()} by {off_d:.3f} px")
    if switch != [("fullres", "dp")]:
        _fail("switches", f"the global stage logged seam {switch}")
    methods = set(res.seam_methods.values())
    if methods != {"dp"} or len(res.seam_methods) < ML_ROWS - 1:
        _fail("switches", f"seam methods {res.seam_methods}: dp expected "
                          f"on every strip pair")
    pano = res.panorama
    if abs(pano.shape[0] - gt_h) > ML_SIZE_TOL_PX or \
            abs(pano.shape[1] - gt_w) > ML_SIZE_TOL_PX:
        _fail("switches", f"mosaic {pano.shape[:2]} vs ground truth "
                          f"{(gt_h, gt_w)}")
    gt = np.clip(ortho[oy:oy + gt_h, ox:ox + gt_w], 0, 255).astype(np.uint8)
    rmse, dy, dx = gt_rmse(pano, gt, device=dev)
    ref_rmse = gt_rmse(dref.panorama, gt, device=dev)[0]
    if not np.isfinite(rmse) or rmse > GT_RMSE_MAX:
        _fail("switches", f"GT-RMSE {rmse} > {GT_RMSE_MAX}")
    extra = launches["warp_affine_nonblack"] \
        - ref_launches["warp_affine_nonblack"]
    if per_strip != [1] * ML_ROWS or extra != ML_ROWS:
        _fail("switches", f"seam warps made {per_strip} content-mode K2 "
                          f"launches per strip, the pass {extra} more than "
                          f"the default pass: 1 per strip expected")
    sw_key, sm_key = "GlobalCustom/seam warps", "GlobalCustom/seams"
    print(f"[smoke] switches: seam_warp=fullres seam_method=dp on the 3 x 10 "
          f"sortie: groups as the default pass, flipped {res.flipped}, strip "
          f"offsets {np.round(offs, 3).tolist()} (max {off_d:.4f} px from the "
          f"default pass's), seams {res.seam_methods}, mosaic "
          f"{pano.shape[0]}x{pano.shape[1]} (default "
          f"{dref.panorama.shape[0]}x{dref.panorama.shape[1]}), GT-RMSE "
          f"{rmse:.4f} at ({dy},{dx}) (default pass {ref_rmse:.4f}); seam "
          f"scale {scale['scale']} into {scale['h']}x{scale['w']}; seam "
          f"warps {stages.get(sw_key)} s (default {ref['stages'].get(sw_key)}"
          f" s), seams {stages.get(sm_key)} s (default "
          f"{ref['stages'].get(sm_key)} s); content-mode K2 per strip's seam "
          f"warp {per_strip}, {launches['warp_affine_nonblack']} in the pass "
          f"(default {ref_launches['warp_affine_nonblack']}); wall "
          f"{wall:.2f} s (default {ref['wall']:.2f} s); launches {launches}",
          flush=True)
    return launches, scale


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
    """The CLI on the production sortie's JPEGs (written by the codec:
    4:2:0, so the children store packed I420), then --resume: the strip
    JPEGs and the streamed mosaic written by the codec (the children log
    its route), the resumed mosaic streamed too and its file byte-equal to
    the straight run's."""
    import resource

    from drone_image_stitch_cpp_tpu_torch.app import write_image
    from drone_image_stitch_cpp_tpu_torch.runtime.loader import decode_all
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

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
    route = _rec(recs, "codec", "route")
    fmt = _rec(recs, "streaming ingest", "fmt")
    streamed = _rec(recs, "wrote", "streamed")
    if route is None or fmt != "yuv420" or not streamed:
        _fail("production", f"the CLI run: codec route {route}, store {fmt}, "
                            f"streamed {streamed} (the codec's route, a "
                            f"yuv420 store and a streamed mosaic expected)")
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
    if second != first or not _rec(recs2, "wrote", "streamed"):
        _fail("production", "the --resume mosaic was not streamed or its "
                            "file differs from the straight run's")
    print(f"[smoke] production cli: {ML_ROWS} lines x {CLI_COLS} frames "
          f"{FRAME_H}x{FRAME_W} (each line cut from {ML_COLS} for time), "
          f"{len(imgs)} frames encoded by the codec in {enc_s:.2f} s; the "
          f"children's codec route {route}, store {fmt}; run rc 0 in "
          f"{wall:.2f} s (streaming decode "
          f"{_rec(recs, 'streaming decode', 'decode_seconds')} s of decode "
          f"thread, grouping {_rec(recs, 'grouping done')} s, global compose "
          f"{_rec(recs, 'global compose done')} s, strip-save drain "
          f"{_rec(recs, 'strip-save drain done')} s, streamed write encode "
          f"{_rec(recs, 'streamed mosaic written', 'encode_seconds')} s, "
          f"finish wait "
          f"{_rec(recs, 'streamed mosaic written', 'finish_wait_seconds')} "
          f"s), panorama {pano.shape[0]}x{pano.shape[1]} GT-RMSE "
          f"{rmse:.4f} at shift ({dy},{dx}); --resume rc 0 in {wall2:.2f} s "
          f"(global compose {_rec(recs2, 'global compose done')} s), "
          f"streamed, file bytes equal to the straight run's; children's "
          f"peak RSS {rss:.2f} GiB", flush=True)


def _flagship_kernels(torch, dev, gt, tuning, planes, regs, seam):
    """Each kernel at the shapes the flagship alone gives it: from the
    ground-truth crop (the frames' bytes before JPEG), K1 at the global
    detect of line 1's 25.7k-px strip and K2's content mode from it, as
    the global stage pads it, the same strip warped at full resolution
    into the seam canvas (``seam``: the run's logged seam scale record;
    the ``seam_warp="fullres"`` launch), and K2's uint8 seam batch of line
    0's 20 frames; from ``planes``, the codec's raw 4:2:0 planes of line 0's 20
    JPEGs (packed I420), K2's I420 source at the strip compose feed (one
    frame into the compose window) and at the 20-frame seam batch
    (``regs``: ptxas's registers by entry). Returns ({"global_detect":
    K1}, {"content_mode", "seam_fullres", "seam_batch",
    "i420_compose_feed", "i420_seam_batch": K2})."""
    from drone_image_stitch_cpp_tpu_torch.ops.blend import align_up
    step_y = int(FRAME_H * (1 - ML_OVERLAP_Y))
    step_x = int(FRAME_W * (1 - OVERLAP))
    w = gt.shape[1]
    padded = torch.zeros((align_up(FRAME_H, 512), align_up(w, 512), 3),
                         dtype=torch.uint8, device=dev)
    padded[:FRAME_H, :w] = torch.from_numpy(gt[step_y:step_y + FRAME_H]).to(
        dev)
    k1 = phase_k1_global(torch, padded, (FRAME_H, w), tuning,
                         label="flagship global detect",
                         min_valid=FLAG_K1_GLOBAL_MIN_VALID)
    content = phase_k2_content(torch, dev, padded)
    fullres = phase_k2_seam_fullres(torch, dev, padded, seam["scale"],
                                    step_y, seam["h"], seam["w"],
                                    "flagship seam warp")
    del padded
    torch.cuda.empty_cache()
    pos = [(0, c * step_x) for c in range(FLAG_COLS)]
    imgs = [gt[:FRAME_H, x:x + FRAME_W] for _, x in pos]
    batch = phase_k2_batch(torch, dev, imgs, pos, tuning)
    del imgs
    torch.cuda.empty_cache()
    frames = torch.from_numpy(np.stack(planes)).to(dev)
    oh, ow = K2_WIN
    mid = FLAG_COLS // 2
    feed = _k2_i420_row(torch, dev, "flagship compose feed (codec planes)",
                        frames[mid:mid + 1], _feed_affine()[None], oh, ow,
                        regs)
    a23s, sh, sw, _ = _seam_affines(pos, tuning)
    seam = _k2_i420_row(torch, dev, "flagship seam batch (codec planes)",
                        frames, a23s, sh, sw, regs)
    del frames
    torch.cuda.empty_cache()
    return {"global_detect": k1}, {"content_mode": content,
                                   "seam_fullres": fullres,
                                   "seam_batch": batch,
                                   "i420_compose_feed": feed,
                                   "i420_seam_batch": seam}


class _Recorder:
    """Counts the calls of ``module.name`` (``record(args, result)`` sees
    each) from ``__enter__`` to ``__exit__``, calling through."""

    def __init__(self, module, name, record):
        self.module, self.name, self.record = module, name, record

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            out = self.fn(*a, **kw)
            self.record(a, out)
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def phase_flagship(torch, dev, card, tuning, regs):
    """The flagship: the 200-frame 10 x 20 sortie of 2160x3840 frames
    from the port's harness (tools/sortie_bench.make_sortie with the JAX
    harness's defaults: overlaps 0.70 / 0.35, seed 11, JPEG quality 92,
    4:2:0) in a work directory under build/ that is deleted at the end,
    then one run_ours on cuda:0 (the application end to end: streaming
    ingest into a packed I420 store through the codec's raw decode,
    grouping and registration on the Y plane, 10 strips fed by K2's I420
    source, the global stage, the mosaic streamed into the codec's
    encoder), measured by tools/bench_sortie.measure_run. Hard checks as
    the module doc lists; then the kernels at this path's own shapes
    (_flagship_kernels, with the codec's raw planes of line 0's JPEGs;
    ``regs``: ptxas's registers by entry). Returns (the run's launch
    counts, K1's and K2's rows)."""
    import resource

    from drone_image_stitch_cpp_tpu_torch.pipeline import registration as R
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
    from drone_image_stitch_cpp_tpu_torch.tools import bench_sortie as BS
    from drone_image_stitch_cpp_tpu_torch.tools.sortie_bench import (
        make_sortie)
    from drone_image_stitch_cpp_tpu_torch.utils.native import (
        decode_batch_yuv420_native)

    get_logger().verbose = False
    work = tempfile.mkdtemp(prefix="smoke_flagship_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    luma = []
    try:
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        t0 = time.perf_counter()
        try:
            root, gt_path = make_sortie(work, FLAG_ROWS, FLAG_COLS, FRAME_H,
                                        FRAME_W, device=dev)
        except (RuntimeError, OSError) as err:
            _fail("flagship", f"make_sortie: {err}")
        render_s = time.perf_counter() - t0
        gt = np.load(gt_path)
        torch.cuda.empty_cache()
        try:
            # the launch counts are set to 0 just before run_ours and read
            # just after it; the Y-plane reads are recorded over the same run
            with _Recorder(R, "yuv420_luma",
                           lambda a, out: luma.append(tuple(out.shape))):
                run, mosaic, recs = BS.measure_run(root, gt, dev, "warm",
                                                   retries=0)
        except RuntimeError as err:
            _fail("flagship", str(err))
        launches = run["launches"]
        on_disk = os.path.exists(os.path.join(
            root, "_ours", "visible", "minfull",
            "visible_minfull_uav_panorama.jpg"))
        img_dir = os.path.join(root, "visible", "minfull")
        line0 = sorted(os.listdir(img_dir))[:FLAG_COLS]
        planes = decode_batch_yuv420_native(
            [os.path.join(img_dir, n) for n in line0], 8)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def rec(msg, stage="GlobalCustom"):
        return next((r for r in recs if r["msg"] == msg
                     and r["stage"] == stage), {})

    if not on_disk:
        _fail("flagship", "no mosaic on disk")
    sizes = rec("groups", "Main").get("sizes")
    segments = rec("strips", "VisualGroup").get("segments")
    want = [[k * FLAG_COLS, (k + 1) * FLAG_COLS - 1]
            for k in range(FLAG_ROWS)]
    if sizes != [FLAG_COLS] * FLAG_ROWS or segments != want:
        _fail("flagship", f"groups {sizes} (segments {segments}), expected "
                          f"{FLAG_ROWS} of {FLAG_COLS}: {want}")
    flips = [r["flipped"] for r in recs if r["stage"] == "GlobalCustom"
             and r["msg"].endswith(" aligned")]
    if flips != [False] * (FLAG_ROWS - 1):
        _fail("flagship", f"strip alignments flipped {flips}")
    seams = {k: v for k, v in rec("seam methods").items()
             if k not in ("ts", "stage", "msg")}
    if len(seams) != FLAG_ROWS - 1 or set(seams.values()) != {"graphcut"}:
        _fail("flagship", f"global seams {seams}: expected "
                          f"{FLAG_ROWS - 1}, all graphcut")
    mh, mw = run["mosaic_hw"]
    step_y = int(FRAME_H * (1 - ML_OVERLAP_Y))
    step_x = int(FRAME_W * (1 - OVERLAP))
    foot = (FRAME_H + (FLAG_ROWS - 1) * step_y,
            FRAME_W + (FLAG_COLS - 1) * step_x)
    (h0, h1), (w0, w1) = FLAG_MOSAIC_BAND
    tol = FLAG_SIZE_TOL_PX
    if not (h0 - tol <= mh <= h1 + tol and w0 - tol <= mw <= w1 + tol):
        _fail("flagship", f"mosaic {mh}x{mw} outside the JAX package's "
                          f"band {h0}-{h1} x {w0}-{w1} +- {tol} px (its "
                          f"record {FLAG_MOSAIC[0]}x{FLAG_MOSAIC[1]})")
    if mh < foot[0] - ML_SIZE_TOL_PX or mw < foot[1] - ML_SIZE_TOL_PX:
        _fail("flagship", f"mosaic {mh}x{mw} smaller than the planted "
                          f"footprint {foot[0]}x{foot[1]}")
    rmse = run["gt_rmse"]
    if not np.isfinite(rmse) or rmse > FLAG_RMSE_MAX:
        _fail("flagship", f"GT-RMSE {rmse} > {FLAG_RMSE_MAX}")
    for name in ("sift_orient_desc", "warp_affine", "warp_affine_nonblack"):
        if launches[name] <= 0:
            _fail("flagship", f"kernel {name} never launched")
    # the production I/O: a packed I420 store through the codec, the
    # mosaic streamed into its encoder and decoding from disk
    n_frames = FLAG_ROWS * FLAG_COLS
    store_bytes = n_frames * FRAME_H * 3 // 2 * FRAME_W
    written = rec("streamed mosaic written")
    if run["codec_route"] is None or run["store_fmt"] != "yuv420" or \
            run["store_bytes"] != store_bytes:
        _fail("flagship", f"store {run['store_fmt']} of {run['store_bytes']}"
                          f" B through codec route {run['codec_route']}: a "
                          f"yuv420 store of {store_bytes} B expected")
    if not run["streamed"] or [written.get("h"), written.get("w")] != \
            [mh, mw]:
        _fail("flagship", f"the mosaic was not streamed ({written}) or its "
                          f"file does not decode to {mh}x{mw}")
    if len(planes) != FLAG_COLS or any(p is None or p.shape != (
            FRAME_H * 3 // 2, FRAME_W) for p in planes):
        _fail("flagship", "line 0's JPEGs do not decode to raw 4:2:0 planes")
    # K1 on the Y plane; every strip launch of K2 from the I420 source:
    # compose feeds staged, seam batches per tap
    by = run["k2_by_source"]
    feeds = launches["warp_affine"] - launches["warp_affine_batched"] \
        - by["content"]
    if not luma or any(sh[-2:] != (FRAME_H, FRAME_W) for sh in luma):
        _fail("flagship", f"detect read no Y plane of the store ({luma[:4]})")
    if by["u8"] or by["f32"] or by["i420_staged"] != feeds or \
            by["i420_per_tap"] != launches["warp_affine_batched"]:
        _fail("flagship", f"K2 by source {by}, {feeds} compose feeds, "
                          f"{launches['warp_affine_batched']} seam batches: "
                          f"every strip launch from the I420 source, the "
                          f"compose feeds staged and the seam batches per "
                          f"tap, expected")
    canvas, scale = rec("canvas"), rec("seam scale")
    print(f"[smoke] flagship: {FLAG_ROWS} x {FLAG_COLS} frames {FRAME_H}x"
          f"{FRAME_W} (overlaps 0.70/0.35, seed 11, JPEG q92) rendered and "
          f"written in {render_s:.2f} s; run_ours rc 0 in {run['secs']:.2f} "
          f"s; groups {sizes}, no flip, seams {seams}; global canvas "
          f"{canvas.get('h')}x{canvas.get('w')} at seam scale "
          f"{scale.get('scale')}; mosaic {mh}x{mw} (planted footprint "
          f"{foot[0]}x{foot[1]}; the JAX package's record "
          f"{FLAG_MOSAIC[0]}x{FLAG_MOSAIC[1]}, its band {h0}-{h1} x "
          f"{w0}-{w1}), GT-RMSE {rmse:.3f} "
          f"(max_dim 6000, shift {run['gt_shift']}; the JAX package's "
          f"band 38.6-49.0)", flush=True)
    print(f"[smoke] flagship I/O: codec route {run['codec_route']}; store "
          f"{run['store_fmt']}, {run['store_bytes']} B ({n_frames} x "
          f"{store_bytes // n_frames} B, 1.5 B a pixel), decode thread busy "
          f"{run['decode_thread_s']} s; mosaic streamed into the encoder "
          f"(encoder {run['encode_s']} s on its thread, finish wait "
          f"{run['finish_wait_s']} s after the blend), decoded from disk "
          f"{mh}x{mw}; detect on the Y plane ({len(luma)} reads); K2 by "
          f"source {by}: {feeds} compose feeds staged, "
          f"{launches['warp_affine_batched']} seam batches per tap",
          flush=True)
    print("[smoke] flagship stages (s): " + ", ".join(
        f"{k}={v}" for k, v in run["stages"].items()), flush=True)
    seams_s = rec("seams done").get("seconds")
    solver = rec("seam solver")
    print(f"[smoke] flagship graph-cut seams {seams_s:.3f} s, of which the "
          f"min-cut solver {solver.get('solver_seconds')} s in "
          f"{solver.get('calls')} calls on {solver.get('nodes')} nodes (the "
          f"rest host set-up)", flush=True)
    print("[smoke] flagship strip stitches (s): " + ", ".join(
        f"{r['stage']}={r['seconds']:.3f}" for r in recs
        if r["msg"] == "stitch done"), flush=True)
    print(f"[smoke] flagship peak device memory {run['peak_device_gib']} GiB "
          f"(max_memory_allocated); ru_maxrss {run['ru_maxrss_gib']} GiB "
          f"(the process's high-water: {rss0:.3f} GiB before the phase); "
          f"launches {launches}; card '{card}'", flush=True)
    del mosaic
    torch.cuda.empty_cache()
    return (launches, *_flagship_kernels_apart(gt, planes, regs, scale))


def _flagship_kernels_apart(gt, planes, regs, seam):
    """_flagship_kernels in a child process of this script
    (``--flagship-kernels DIR``) on the inputs saved into DIR, under
    build/: after the flagship's run, torch.profiler's traces in this
    process lose the kernels' records (PERF.md section 7), and a fresh
    process's do not. The child's lines print with this process's;
    returns its K1 and K2 rows."""
    d = tempfile.mkdtemp(prefix="smoke_flagship_kernels_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        step_y = int(FRAME_H * (1 - ML_OVERLAP_Y))
        np.save(os.path.join(d, "gt.npy"), gt[:step_y + FRAME_H])
        np.save(os.path.join(d, "planes.npy"), np.stack(planes))
        with open(os.path.join(d, "args.json"), "w") as f:
            json.dump({"regs": regs, "seam": {k: seam[k] for k in
                                              ("scale", "h", "w")}}, f)
        sys.stdout.flush()
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--flagship-kernels", d],
                            timeout=900).returncode
        if rc != 0:
            _fail("flagship", f"the kernels' child process exited {rc}")
        with open(os.path.join(d, "rows.json")) as f:
            k1, k2 = json.load(f)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return k1, k2


def flagship_kernels_main(d: str) -> int:
    """The child of _flagship_kernels_apart: _flagship_kernels on the
    inputs in ``d``, its rows written to d/rows.json."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import drone_image_stitch_cpp_tpu_torch  # noqa: F401  (fp32 policy)
    from drone_image_stitch_cpp_tpu_torch.config.tuning import (
        load_stitch_tuning)
    with open(os.path.join(d, "args.json")) as f:
        args = json.load(f)
    rows = _flagship_kernels(
        torch, torch.device("cuda", 0), np.load(os.path.join(d, "gt.npy")),
        load_stitch_tuning("visible"),
        list(np.load(os.path.join(d, "planes.npy"))), args["regs"],
        args["seam"])
    with open(os.path.join(d, "rows.json"), "w") as f:
        json.dump(rows, f)
    return 0


def _synchronize_all(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _stitch_counted(torch, dev, fn):
    """Run ``fn`` (a stitch) with the launch counts set to 0 just before
    it: (its result, wall s, launch counts read just after, peak bytes on
    ``dev``)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    res = fn()
    _synchronize_all(torch)
    wall = time.perf_counter() - t0
    return res, wall, _counts(), torch.cuda.max_memory_allocated(dev)


def _same_stitch(label, ref, got):
    """Panorama bytes, groups, kept frames, every strip and global
    transform, flips and seam methods equal to the one-device run's."""
    a, b = ref.panorama, got.panorama
    if a.shape != b.shape or not np.array_equal(a, b):
        diff = (int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
                if a.shape == b.shape else "n/a")
        _fail("devices", f"{label}: panorama {b.shape} differs from the "
                         f"one-device run's {a.shape} (max |diff| {diff})")
    if [g.indices for g in ref.groups] != [g.indices for g in got.groups] \
            or ref.strip_kept != got.strip_kept:
        _fail("devices", f"{label}: groups or kept frames differ")
    for name in ("strip_transforms", "global_transforms"):
        for x, y in zip(getattr(ref, name), getattr(got, name)):
            x, y = np.asarray(x), np.asarray(y)
            if not np.array_equal(x, y):
                _fail("devices", f"{label}: {name} differ by "
                                 f"{np.abs(x - y).max():.3e}")
    if ref.flipped != got.flipped or ref.seam_methods != got.seam_methods:
        _fail("devices", f"{label}: flips or seam methods differ")


def phase_devices(torch, dev, label, imgs, ids, tuning, ref, ref_launches):
    """The main path over the device list [dev, dev] (the pair
    registration's chunks, the strips and the host-assembled compose tiles
    placed over it, two tiles in flight) against the one-device pass
    ``ref`` of the same frames: equal bit for bit, with the same launches.
    With more than one card, ``device="cuda"`` (every card) too."""
    from drone_image_stitch_cpp_tpu_torch.app import stitch_frames

    def check(tag, spec):
        res, wall, counts, peak = _stitch_counted(
            torch, dev, lambda: stitch_frames(imgs, ids, tuning, spec))
        _same_stitch(f"{label} {tag}", ref["res"], res)
        for name in ("sift_orient_desc", "warp_affine"):
            if counts[name] <= 0:
                _fail("devices", f"{label} {tag}: kernel {name} never "
                                 f"launched")
            if counts[name] != ref_launches[name]:
                _fail("devices", f"{label} {tag}: {name} launched "
                                 f"{counts[name]} times, one device "
                                 f"{ref_launches[name]}")
        ph, pw = res.panorama.shape[:2]
        print(f"[smoke] devices {label} {tag}: equal to one device "
              f"(panorama {ph}x{pw} bytes, {len(res.strip_transforms)} "
              f"strip and {len(res.global_transforms)} global transforms); "
              f"wall {wall:.2f} s (one device {ref['wall']:.2f} s), peak "
              f"{peak / 2**30:.3f} GiB on cuda:0 (one device "
              f"{ref['peak'] / 2**30:.3f}); launches {counts}", flush=True)
        return counts

    counts = check("[cuda:0, cuda:0]", [dev, dev])
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        check(f"device='cuda' ({n_cards} cards)", "cuda")
    else:
        print(f"[smoke] devices {label}: the multi-card check did not run "
              f"({n_cards} card visible)", flush=True)
    return counts


def phase_sortie_step(torch, dev, imgs, tuning):
    """parallel/sortie_step over [dev, dev] against [dev] on the first 8
    corridor frames as gray at the grouper's work size and feature
    budget: transforms within 1e-4, inlier counts equal, the planted
    steps recovered within 2 px; K1 launched, and held against its plain
    version at the step's 1-frame shape."""
    from drone_image_stitch_cpp_tpu_torch.grouping.flight_grouper import (
        _MAX_DIM)
    from drone_image_stitch_cpp_tpu_torch.parallel.sortie_step import (
        build_sortie_step)
    group_mpx = FRAME_H * FRAME_W * min(
        1.0, (_MAX_DIM / max(FRAME_H, FRAME_W)) ** 2) / 1e6
    gray = _k1_gray(torch, dev, imgs, group_mpx)
    n_fr, h, w = gray.shape
    kw = dict(max_kp=int(np.clip(tuning.strip_sift_features, 600, 1800)),
              range_width=2, n_hyp=1024, thresh=4.0, canvas_h=512,
              canvas_w=2048)
    outs = {}
    for n_dev in (1, 1, 2, 2):  # the first run of each count warms it
        devices = [dev] * n_dev
        step = build_sortie_step(devices, n_fr, h, w, **kw)
        shards = [c.contiguous() for c in gray.chunk(n_dev)]
        _zero_counts()
        t0 = time.perf_counter()
        out = step(shards, seed=0)
        torch.cuda.synchronize()
        outs[n_dev] = (out, time.perf_counter() - t0, _counts())
    (t1, c1, i1), wall1, _ = outs[1]
    (t2, c2, i2), wall2, counts = outs[2]
    dt = float((t1 - t2).abs().max())
    dc = float((c1 - c2).abs().max())
    if dt > 1e-4:
        _fail("sortie_step", f"transforms over [cuda:0, cuda:0] differ from "
                             f"[cuda:0] by {dt:.3e} > 1e-4")
    if not torch.equal(i1, i2):
        _fail("sortie_step", f"inlier counts differ: {i1.tolist()} vs "
                             f"{i2.tolist()}")
    step_x = (FRAME_W * (1 - OVERLAP)) * w / FRAME_W
    exp = torch.tensor([k * step_x for k in range(n_fr)], device=dev)
    off = float((t2[:, 0, 2] - exp).abs().max().item())
    if not torch.isfinite(c2).all() or off > 2.0:
        _fail("sortie_step", f"steps off the planted {step_x:.1f} px by "
                             f"{off:.3f} px (or the canvas is not finite)")
    if counts["sift_orient_desc"] <= 0:
        _fail("sortie_step", "K1 never launched")
    # the step detects each frame on its own: K1 at a 1 x max_kp call
    k1 = _k1_check(torch, gray[:1], "sortie step", kw["max_kp"])
    print(f"[smoke] sortie_step: {n_fr} frames {h}x{w}, {kw['max_kp']} "
          f"keypoints, {kw['n_hyp']} hypotheses; [cuda:0, cuda:0] vs "
          f"[cuda:0]: transforms max |diff| {dt:.3e}, inlier counts equal "
          f"{i2.tolist()}, canvas {tuple(c2.shape)} max |diff| {dc:.3e}; "
          f"x steps within {off:.4f} px of the planted {step_x:.2f}; K1 "
          f"launches {counts['sift_orient_desc']}; warm wall {wall2:.3f} s "
          f"(one device {wall1:.3f} s)", flush=True)
    return counts, k1


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def phase_trace(torch, dev, imgs, ids, tuning, ref):
    """One warm multi-line pass under runtime/logging.device_trace into
    build/: the trace's size and events, the device busy share (the union
    of the CUDA kernel, copy and memset intervals over the traced wall),
    the five device operations that took the most time, and the traced
    wall against the untraced pass ``ref`` (the profiler's overhead)."""
    from drone_image_stitch_cpp_tpu_torch.app import stitch_frames
    from drone_image_stitch_cpp_tpu_torch.runtime.logging import device_trace
    tdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_trace")
    shutil.rmtree(tdir, ignore_errors=True)
    torch.cuda.empty_cache()
    _zero_counts()
    t_all = time.perf_counter()
    with device_trace(tdir):
        t0 = time.perf_counter()
        res = stitch_frames(imgs, ids, tuning, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    export_s = time.perf_counter() - t_all - wall
    counts = _counts()
    files = os.listdir(tdir)
    if len(files) != 1:
        _fail("trace", f"expected one trace file in {tdir}, found {files}")
    path = os.path.join(tdir, files[0])
    size = os.path.getsize(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    except (ValueError, KeyError) as e:
        _fail("trace", f"{files[0]} does not parse: {e}")
    dev_ev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    names = {e["name"] for e in dev_ev if e["cat"] == "kernel"}
    for k in ("sift_orient_desc", "warp_affine"):
        if not any(k in nm for nm in names):
            _fail("trace", f"no {k} kernel in the trace")
    busy = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in dev_ev)
    share = busy / (wall * 1e6)
    if not 0.0 < share <= 1.0:
        _fail("trace", f"device busy share {share} outside (0, 1]")
    by_name = {}
    for e in dev_ev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    kernel_us = sum(float(e["dur"]) for e in dev_ev if e["cat"] == "kernel")
    same = np.array_equal(res.panorama, ref["res"].panorama)
    if not same:
        _fail("trace", "the traced pass's mosaic differs from the untraced "
                       "pass's")
    print(f"[smoke] trace: {os.path.relpath(path)} {size / 2**20:.1f} MiB, "
          f"{len(events)} events ({len(dev_ev)} on the device: "
          f"{sum(e['cat'] == 'kernel' for e in dev_ev)} kernels); device busy "
          f"{busy / 1e6:.3f} s of the traced wall {wall:.2f} s: share "
          f"{share:.4f} (kernels alone {kernel_us / 1e6:.3f} s); traced wall "
          f"{wall:.2f} s vs the untraced pass {ref['wall']:.2f} s "
          f"(x{wall / ref['wall']:.3f}), export {export_s:.2f} s; mosaic "
          f"equal to the untraced pass's; launches {counts}", flush=True)
    print("[smoke] trace top device operations (s, count): " + "; ".join(
        f"{nm[:90]} {us / 1e6:.3f} "
        f"{sum(e['name'] == nm for e in dev_ev)}" for nm, us in top),
        flush=True)
    shutil.rmtree(tdir, ignore_errors=True)
    return counts


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
    from drone_image_stitch_cpp_tpu_torch.tools.bench_sortie import (
        k2_by_source)

    dev = torch.device("cuda", 0)
    card = phase_environment(torch)
    ptxas = phase_build()
    tp_launches, k1_tp, plane = phase_throughput(torch, dev)
    tuning = load_stitch_tuning("visible")
    ortho, imgs, ids, pos = render_sortie(torch, dev)
    k1 = phase_k1(torch, dev, imgs, tuning)
    k1["throughput"] = k1_tp
    k2 = phase_k2(torch, dev, imgs[len(imgs) // 2])
    k2["seam_batch"] = phase_k2_batch(torch, dev, imgs, pos, tuning)
    torch.cuda.empty_cache()
    _zero_counts()
    launches, sl_ref = phase_slice(torch, dev, ortho, imgs, ids, pos, tuning)
    affine_pano = sl_ref["res"].panorama
    torch.cuda.empty_cache()
    i420_launches, k2["i420_source"], k2["i420_seam_batch"] = phase_i420(
        torch, dev, ortho, imgs, ids, pos, tuning, sl_ref,
        ptxas["warp_affine.cu"][2])
    torch.cuda.empty_cache()
    fb_launches, k1["fallback_mixed"] = phase_fallback(torch, dev, ortho,
                                                       imgs, pos, tuning)
    torch.cuda.empty_cache()
    kn_launches, k2["f32_source"] = phase_knobs(torch, dev, ortho, imgs, ids,
                                                pos, tuning, affine_pano)
    del affine_pano
    torch.cuda.empty_cache()
    dv_sl = phase_devices(torch, dev, "single_line", imgs, ids, tuning,
                          sl_ref, launches)
    del sl_ref
    st_launches, k1["sortie_step"] = phase_sortie_step(torch, dev, imgs,
                                                       tuning)
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
        ml_launches, ml_ref = phase_multiline(torch, dev, ml_ortho, ml_imgs,
                                              ml_ids, ml_pos, tuning, first)
        mf, dp = ml_ref.pop("maxflow"), ml_ref.pop("dp_seam")
        del first
        sw_launches, sw_scale = phase_multiline_switches(
            torch, dev, ml_ortho, ml_imgs, ml_ids, ml_pos, tuning, ml_ref,
            ml_launches)
        padded, _ = _padded_strip(torch, dev, ml_ortho, ml_pos, 1)
        k2["seam_fullres"] = phase_k2_seam_fullres(
            torch, dev, padded, sw_scale["scale"], _ml_geometry(ml_pos)[0],
            sw_scale["h"], sw_scale["w"], "3 x 10 seam warp")
        del padded
        torch.cuda.empty_cache()
        dv_ml = phase_devices(torch, dev, "multi_line", ml_imgs, ml_ids,
                              tuning, ml_ref, ml_launches)
        tr_launches = phase_trace(torch, dev, ml_imgs, ml_ids, tuning, ml_ref)
        del ml_ref
        torch.cuda.empty_cache()
        phase_production_cli(ml_ortho, ml_imgs, ml_pos, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del ml_ortho, ml_imgs, ml_ids, ml_pos
    torch.cuda.empty_cache()
    fl_launches, k1_fl, k2_fl = phase_flagship(torch, dev, card, tuning,
                                               ptxas["warp_affine.cu"][2])
    k1["flagship"], k2["flagship"] = k1_fl, k2_fl
    paths = {"throughput": tp_launches, "single_line": launches,
             "i420": i420_launches,
             "multi_line": ml_launches, "multi_line_switches": sw_launches,
             "fallback": fb_launches, "production": pr_launches,
             "knobs": kn_launches, "devices_single_line": dv_sl,
             "devices_multi_line": dv_ml, "sortie_step": st_launches,
             "trace": tr_launches, "flagship": fl_launches}
    k1["launches"] = sum(c["sift_orient_desc"] for c in paths.values())
    k2["launches"] = sum(c["warp_affine"] for c in paths.values())
    plane["launches"] = sum(c["warp_affine_plane"] for c in paths.values())
    plane["launches_by_path"] = {p: c["warp_affine_plane"]
                                 for p, c in paths.items()}
    k1["launches_by_path"] = {
        **{p: c["sift_orient_desc"] for p, c in paths.items()},
        "fallback_mixed_size": fb_launches["sift_orient_desc_mixed"]}
    k2["launches_by_path"] = {
        **{p: c["warp_affine"] for p, c in paths.items()},
        "multi_line_content_mode": ml_launches["warp_affine_nonblack"],
        "multi_line_switches_content_mode": sw_launches[
            "warp_affine_nonblack"],
        "production_content_mode": pr_launches["warp_affine_nonblack"],
        "flagship_content_mode": fl_launches["warp_affine_nonblack"]}
    k2["f32_launches_by_path"] = {p: c["warp_affine_f32"]
                                  for p, c in paths.items()}
    k2["i420_launches_by_path"] = {p: c["warp_affine_i420"]
                                   for p, c in paths.items()}
    k2["launches_by_source"] = {p: k2_by_source(c)
                                for p, c in paths.items()}
    # the gather kernel's tiles by route (zero, direct) of each launch the
    # smoke counted, against its plan
    k2["tiles_by_row"] = {
        "compose_feed": k2["tiles"],
        "seam_batch": k2["seam_batch"]["tiles"],
        "f32_source": k2["f32_source"]["tiles"],
        "f32_seam_batch": k2["f32_source"]["seam_batch"]["tiles"],
        "i420_compose_feed_per_tap": k2["i420_source"]["per_tap_tiles"],
        "i420_seam_batch": k2["i420_seam_batch"]["per_tap_tiles"],
        "flagship_seam_batch": k2["flagship"]["seam_batch"]["tiles"],
        "flagship_i420_seam_batch": k2["flagship"]["i420_seam_batch"][
            "per_tap_tiles"]}
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            k1["global_detect"]["max_abs_err"],
                            k1["fallback_mixed"]["max_abs_err"],
                            k1["sortie_step"]["max_abs_err"],
                            k1["throughput"]["max_abs_err"],
                            k1["flagship"]["global_detect"]["max_abs_err"])
    for d in (k1, k2, plane, mf, dp):
        (d["registers"], d["spill_bytes"], d["registers_by_entry"],
         d["static_smem_by_entry"]) = ptxas[d["source"].split("/")[-1]]
        d["card"] = card
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "share", "kernel_ms", "device_ms")
    print(card)
    print(json.dumps({"kernels": [
        {**{k: d[k] for k in order},
         **{k: v for k, v in d.items() if k not in order}}
        for d in (k1, k2, plane, mf, dp)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--flagship-kernels"]:
        sys.exit(flagship_kernels_main(sys.argv[2]))
    sys.exit(main())
