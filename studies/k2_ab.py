"""K2 on the card: csrc/warp_affine.cu against another version of it, in
one process, in turns.

    python studies/k2_ab.py --other build/parent/warp_affine.cu

Builds the current source and the other one with runtime/kernels' nvcc
flags into build/k2_ab/ and prints ptxas's registers of every kernel of
both. Then it times each bare C entry at the smoke's K2 shapes on random
data, two ways: ``kernel``, the kernel's own duration
(``chip_smoke._kernel_ms``: the median of torch.profiler's durations of
the kernel over 20 launches in one trace), and ``events``, CUDA events
around 20 back-to-back launches / 20 (median of 5), which is the host's
launch pace wherever that is slower than the kernel. The shapes: the
uint8 compose feed, the uint8 seam batch of 12 frames and of the
flagship's 20, content mode (the global compose feed and the
full-resolution seam warp at 0.3366), the float32 compositing feed and
its 12-frame seam batch, the I420 compose feed (staged and per tap) and
the I420 seam batch of 12 and of the flagship's 20 (per tap), and the
single-plane form (one frame and the 7-frame batch, staged and direct).
The current source also reports each launch's tiles by the gather
kernel's route (zero, direct). Builds take turns: other, current,
current, other; each line gives the mean of the two runs and both runs.

``--variants U,F,I,TH ...`` adds a build of the current source for each
spec, whose gather kernel asks ptxas for U, F and I blocks an SM
(``kTileBlocks``: its register bound) for the uint8, float32 and I420
sources and takes TH-row output tiles (``kGatherTileH``); the variants
take their turns after the current source.

The other source takes either this tree's entry points or those of
the sources whose uint8 and float32 entries took an ``invert`` flag
(passed 0 here: every launch takes dst->src coefficients). The first
line is the card's name and power limit. Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import _kernel_ms  # noqa: E402
from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK  # noqa
from drone_image_stitch_cpp_tpu_torch.runtime import kernels as RK  # noqa
from drone_image_stitch_cpp_tpu_torch.runtime.device import (  # noqa
    card_name_and_power_limit)

OUT = os.path.join(ROOT, "build", "k2_ab")
FRAME = (2160, 3840)
FEED_WIN = (2176, 3904)
CONTENT_WIN = (5120, 5120)
F32_FRAME, F32_WIN = (1061, 1886), (1088, 2048)
N_PLANES = 7
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the entry points of a source with an invert flag (0: dst->src sets)
INVERTING = {"warp_affine_u8": (I, [P, LL, I, I, P, P, I, I, P, P, I, I, I,
                                    P, P]),
             "warp_affine_f32": (I, [P, LL, I, I, P, P, I, P, P, I, I, I,
                                     P, P])}


def build(src_text: str, tag: str):
    """nvcc ``src_text`` into build/k2_ab/lib<tag>.so: (library, ptxas)."""
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, f"{tag}.cu")
    with open(cu, "w") as f:
        f.write(src_text)
    lib = os.path.join(OUT, f"lib{tag}.so")
    run = subprocess.run([RK._nvcc(), *RK.NVCC_FLAGS, "-I", RK.CSRC_DIR,
                          "-o", lib, cu],
                         capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc {tag}: {run.stderr[-3000:]}")
    return ctypes.CDLL(lib), run.stderr


def entries(ptxas: str) -> dict:
    """{kernel: (registers, spill store bytes)} from a ptxas report."""
    out = {}
    for part in ptxas.split("Compiling entry function '")[1:]:
        name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "NS",
                      part.split("'")[0])
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out[name] = (int(regs.group(1)) if regs else -1,
                     int(spill.group(1)) if spill else -1)
    return out


def device_ms(fn, launches: int = 20, reps: int = 5) -> float:
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


def rot(deg, tx, ty, s=1.0):
    c, sn = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.asarray([[s * c, -s * sn, tx], [s * sn, s * c, ty]],
                      np.float32)


def seam(n, scale, step):
    return [rot(0.0, scale * step * k, 0.0, scale) for k in range(n)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="another warp_affine.cu (e.g. the parent commit's)")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="U,F,I: the gather kernel's blocks an SM")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("[k2ab] FAIL: no CUDA card")
        return 1
    print(card_name_and_power_limit(), flush=True)
    with open(os.path.join(RK.CSRC_DIR, WK.KERNEL_SOURCE)) as f:
        current = f.read()
    with open(args.other) as f:
        other = f.read()
    builds = {"other": other, "current": current}
    for v in args.variants:
        u, f, i, th = v.split(",")
        src = re.sub(r"(constexpr int kTileBlocks = )[^;]*;",
                     rf"\g<1>std::is_same<T, I420>::value ? {i} : "
                     rf"std::is_same<T, float>::value ? {f} : {u};", current)
        src = re.sub(r"constexpr int kGatherTileH = \d+;",
                     f"constexpr int kGatherTileH = {th};", src)
        builds[f"blocks{u}{f}{i}_tile{th}"] = src
    libs = {}
    for tag, src in builds.items():
        libs[tag], ptxas = build(src, tag)
        print(f"[k2ab] build {tag}: registers, spill bytes "
              f"{entries(ptxas)}", flush=True)
    inverting = {tag: "int invert" in src for tag, src in builds.items()}
    if any(src == current for t, src in builds.items()
           if t.startswith("blocks")):
        raise SystemExit("a variant's kTileBlocks did not substitute")

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    h, w = FRAME

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.uint8)

    frames = u8(20, h, w, 3)
    packed = u8(20, h * 3 // 2, w)
    strip = u8(2560, 14336, 3)
    f32 = torch.rand((12, *F32_FRAME, 3), generator=g, device=dev) * 255.0
    feed_a = rot(2.0, 12000.37 - 11904.0, 20.61)
    comp_a = rot(0.01, 3.62, 9.41)
    stream = RK.stream_handle(dev)
    outs = {}
    keep = []       # the host coefficient arrays the entries point into

    def planes_out(n, oh, ow):
        key = (n, oh, ow)
        if key not in outs:
            outs[key] = (torch.empty((n, oh, ow, 3), device=dev),
                         torch.empty((n, oh, ow), device=dev))
        o, m = outs[key]
        return o.data_ptr(), m.data_ptr()

    def host(sets):
        arr = np.ascontiguousarray(np.asarray(sets, np.float32).reshape(-1, 6))
        keep.append(arr)
        return arr.ctypes.data

    def call(tag, kind, src, hw, a23s, win, content=0, route="default",
             tiles=None):
        """A bare launch of entry ``kind`` (u8, f32, i420) of build
        ``tag`` from the host inverse's dst->src coefficients; ``route``:
        default, direct (I420 per tap) or staged (I420)."""
        lib = libs[tag]
        n = len(a23s)
        hh, ww = hw
        invs = [WK.inverse_coeffs(a) for a in a23s]
        sets = host(invs)
        stride = src[0].numel() if n > 1 else src.numel()
        o, m = planes_out(n, *win)
        head = [src.data_ptr(), stride, hh, ww, None, sets]
        flag = [0] if inverting[tag] else []
        counter = tiles.data_ptr() if tiles is not None else None
        if kind == "u8":
            fn = lib.warp_affine_u8
            a_ = head + flag + [content, o, m, *win, n, counter]
        elif kind == "f32":
            fn = lib.warp_affine_f32
            a_ = head + flag + [o, m, *win, n, counter]
        else:
            fn = lib.warp_affine_i420
            box = (0, 0, 0)
            if route == "staged":
                b = WK.i420_box(invs, hh, ww, *win)
                box = (*b, WK.i420_smem_bytes(b, hh, ww))
            a_ = head + [o, m, *win, n, *box, counter]
        fn.restype = I
        fn.argtypes = (INVERTING if flag and kind != "i420"
                       else WK.KERNEL_SIGNATURES)[fn.__name__][1]
        a_ = tuple(a_) + (stream,)

        def go():
            err = fn(*a_)
            if err:
                raise RuntimeError(f"{kind} {tag}: cudaError {err}")
        return go

    gray = torch.rand((N_PLANES, h, w), generator=g, device=dev) * 255.0
    models = torch.tensor(np.stack([rot(-0.0255 + 0.004 * k, -59.63 + k,
                                        -14.9 - 0.5 * k)
                                    for k in range(N_PLANES)]), device=dev)
    plane_out = torch.empty((N_PLANES, h, w), device=dev)

    def plane_call(tag, n, direct):
        fn = libs[tag].warp_affine_plane_f32
        fn.restype = I
        fn.argtypes = [P, LL, I, I, P, LL, LL, LL, P, P, I, I, I, I, P, P]
        a_ = (gray.data_ptr(), h * w, h, w, models.data_ptr(),
              *models.stride(), None, plane_out.data_ptr(), h, w, n,
              int(direct), None, stream)

        def go():
            err = fn(*a_)
            if err:
                raise RuntimeError(f"warp_affine_plane_f32: cudaError {err}")
        return go

    s12, s20 = seam(12, 0.1203, 1152.0), seam(20, 0.1203, 1152.0)
    f32_seam = seam(12, 0.2449, 566.0)
    # (label, kind, src, (h, w), affines, window, content, routes)
    shapes = [
        ("u8 compose feed", "u8", frames[6], FRAME, [feed_a], FEED_WIN, 0,
         ("default",)),
        ("u8 seam batch 12", "u8", frames[:12], FRAME, s12, (320, 2048), 0,
         ("default",)),
        ("u8 seam batch 20 (flagship)", "u8", frames, FRAME, s20,
         (320, 3136), 0, ("default",)),
        ("content mode", "u8", strip, (2560, 14336),
         [rot(0.05, 0.37, 1404.61)], CONTENT_WIN, 1, ("default",)),
        ("content mode seam fullres", "u8", strip, (2560, 14336),
         [rot(0.0, 0.0, 0.0, 0.3366)], (1673, 4783), 1, ("default",)),
        ("f32 compositing feed", "f32", f32[0], F32_FRAME, [comp_a], F32_WIN,
         0, ("default",)),
        ("f32 seam batch 12", "f32", f32, F32_FRAME, f32_seam, (320, 2048),
         0, ("default",)),
        ("i420 compose feed", "i420", packed[6], FRAME, [feed_a], FEED_WIN,
         0, ("staged", "direct")),
        ("i420 seam batch 12", "i420", packed[:12], FRAME, s12, (320, 2048),
         0, ("direct",)),
        ("i420 seam batch 20 (flagship)", "i420", packed, FRAME, s20,
         (320, 3136), 0, ("direct",)),
    ]
    tile = "warp_affine_tile_kernel"
    kernel_names = {"default": tile, "direct": tile,
                    "staged": "warp_i420_staged_kernel"}
    cases = {}      # (label, tag): (call, kernel name)
    for label, kind, src, hw, a23s, win, content, routes in shapes:
        for route in routes:
            for tag in builds:
                cases[f"{label} {route}", tag] = (
                    call(tag, kind, src, hw, a23s, win, content, route),
                    kernel_names[route])
            if route != "staged":
                tiles = torch.zeros(len(WK.ROUTES), dtype=torch.int32,
                                    device=dev)
                call("current", kind, src, hw, a23s, win, content, route,
                     tiles)()
                torch.cuda.synchronize()
                print(f"[k2ab] tiles {label} {route} current: "
                      f"{dict(zip(WK.ROUTES, tiles.tolist()))}", flush=True)
    for label, n in (("plane one frame", 1),
                     (f"plane {N_PLANES}-frame batch", N_PLANES)):
        for route, direct in (("staged", False), ("direct", True)):
            for tag in builds:
                cases[f"{label} {route}", tag] = (plane_call(tag, n, direct),
                                                  "warp_plane_kernel")
    order = list(builds) + list(builds)[::-1]
    keys = list(dict.fromkeys(k for k, _ in cases))
    for key in keys:
        runs = {}
        for tag in order:
            if (key, tag) in cases:
                fn, name = cases[key, tag]
                runs.setdefault(tag, []).append(
                    (_kernel_ms(torch, fn, name), device_ms(fn)))
        for tag, t in runs.items():
            k_ms = [x[0] for x in t]
            e_ms = [x[1] for x in t]
            print(f"[k2ab] {key} {tag}: kernel {np.mean(k_ms):.4f} ms (runs "
                  f"{', '.join(f'{x:.4f}' for x in k_ms)}), events "
                  f"{np.mean(e_ms):.4f} ms (runs "
                  f"{', '.join(f'{x:.4f}' for x in e_ms)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
