"""K2 on the card: csrc/warp_affine.cu against another version of it, in
one process, in turns.

    python studies/k2_ab.py --other build/parent/warp_affine.cu \
        [--variants 16x4,32x4]

Builds the current source, the other one and, for each variant THxB, a
copy of the current source whose staged I420 kernel takes TH-row output
tiles and asks for B blocks an SM (its launch bound), with
runtime/kernels' nvcc flags into build/k2_ab/. Then:
  * the SASS (cuobjdump -sass) of the uint8 and float32 kernels of the
    current and the other source, compared instruction by instruction:
    "identical" means their code path did not change;
  * ptxas's registers of every kernel of every build;
  * the device time of each bare C entry (CUDA events around 20
    back-to-back launches / 20, median of 5) at the smoke's K2 shapes on
    random data: uint8 compose feed, uint8 seam batch, content mode,
    float32 compose feed, I420 compose feed and seam batch per tap and,
    in each build that has it, the staged I420 kernel (sized as
    ops/warp_kernel.i420_plan sizes it for that tile); the single-plane
    form on 2160x3840 float32 planes, one frame and the throughput
    bench's 7-frame batch, by a near-identity model (a build whose plane
    entry takes a dst->src table reads device_inverse_coeffs' table; one
    that takes the src->dst affines runs each of its routes, staged and
    direct). Builds take turns: other, current, variants, then the same in
    reverse; each line gives the mean of the two runs and both runs.
A build's entries pass a batch's coefficients by value where its source
takes them so (a "const float* host" argument), else by a device table.
The first line is the card's name and power limit. Needs one card.
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

from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK  # noqa
from drone_image_stitch_cpp_tpu_torch.runtime import kernels as RK  # noqa
from drone_image_stitch_cpp_tpu_torch.runtime.device import (  # noqa
    card_name_and_power_limit)

OUT = os.path.join(ROOT, "build", "k2_ab")
FRAME = (2160, 3840)
FEED_WIN = (2176, 3904)
CONTENT_WIN = (5120, 5120)
N_SEAM = 12
N_PLANES = 7


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
    """{kernel: registers} from a ptxas report."""
    out = {}
    for part in ptxas.split("Compiling entry function '")[1:]:
        name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "NS",
                      part.split("'")[0])
        regs = re.search(r"Used (\d+) registers", part)
        out[name] = int(regs.group(1)) if regs else -1
    return out


def sass(lib_path: str) -> dict:
    """{kernel: instruction lines} of a library, addresses dropped and the
    anonymous namespace's per-file name normalised."""
    cuobjdump = os.path.join(os.path.dirname(RK._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "NS", m.group(1))
            out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            out[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/|;?\s*/\*.*?\*/", "",
                                    line).strip())
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


def rot(deg, tx, ty):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.asarray([[c, -s, tx], [s, c, ty]], np.float32)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="another warp_affine.cu (e.g. the parent commit's)")
    ap.add_argument("--variants", default="",
                    help="comma-separated THxB staged-kernel variants")
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
    tiles = {t: int(re.search(r"constexpr int kTileH = (\d+);",
                              src).group(1)) for t, src in builds.items()}
    for v in filter(None, args.variants.split(",")):
        th, blocks = (int(x) for x in v.split("x"))
        src = re.sub(r"constexpr int kTileH = \d+;",
                     f"constexpr int kTileH = {th};", current)
        src = src.replace("__launch_bounds__(kThreads, 4)",
                          f"__launch_bounds__(kThreads, {blocks})")
        builds[f"tile{th}x{blocks}"] = src
        tiles[f"tile{th}x{blocks}"] = th
    libs = {}
    for tag, src in builds.items():
        lib, ptxas = build(src, tag)
        libs[tag] = lib
        print(f"[k2ab] build {tag}: registers {entries(ptxas)}", flush=True)
    a, b = (sass(os.path.join(OUT, f"lib{t}.so")) for t in ("other",
                                                             "current"))
    for key in ("warp_affine_kernelIh", "warp_affine_kernelIf"):
        fa = {k: v for k, v in a.items() if key in k}
        fb = {k: v for k, v in b.items() if key in k}
        for ka, va in fa.items():
            for kb, vb in fb.items():
                print(f"[k2ab] SASS {ka[:70]} vs {kb[:70]}: "
                      f"{'identical' if va == vb else 'differs'} "
                      f"({len(va)} vs {len(vb)} instructions)", flush=True)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    h, w = FRAME

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.uint8)

    frames = u8(N_SEAM, h, w, 3)
    packed = u8(N_SEAM, h * 3 // 2, w)
    strip = u8(2560, 14336, 3)
    f32 = torch.rand((1061, 1886, 3), generator=g, device=dev) * 255.0
    ss = float(np.sqrt(0.12e6 / (h * w)))
    seam = [np.asarray([[ss, 0, ss * 1152 * k], [0, ss, 0]], np.float32)
            for k in range(N_SEAM)]
    seam_invs = [WK.inverse_coeffs(x) for x in seam]
    table = torch.tensor(seam_invs, dtype=torch.float32, device=dev)
    feed = WK.inverse_coeffs(rot(2.0, 12000.37 - 11904.0, 20.61))
    content = WK.inverse_coeffs(rot(0.05, 0.37, 1404.61))
    comp = WK.inverse_coeffs(rot(2.0, 60.3, 10.7))
    stream = RK.stream_handle(dev)
    outs = {}

    def planes(n, oh, ow):
        key = (n, oh, ow)
        if key not in outs:
            outs[key] = (torch.empty((n, oh, ow, 3), device=dev),
                         torch.empty((n, oh, ow), device=dev))
        o, m = outs[key]
        return o.data_ptr(), m.data_ptr()

    by_value = {}   # tag: whether its entries take coefficients by value
    keep = []       # the host coefficient arrays the entries point into

    def call(lib, name, src, stride, hw, tab, coeffs, mode, n, win, box,
             tag=None):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        o, m = planes(n, *win)
        if by_value[tag]:       # the coefficient sets at a host pointer
            host = np.asarray(coeffs, np.float32).reshape(-1, 6)
            keep.append(host)
            coeff_args = (tab, None if tab is not None else host.ctypes.data)
            coeff_types = [ctypes.c_void_p] * 2
        else:
            coeff_args = (tab, *np.asarray(coeffs, np.float32).reshape(-1)[:6])
            coeff_types = [ctypes.c_void_p] + [ctypes.c_float] * 6
        a_ = (src.data_ptr(), stride, *hw, *coeff_args, *mode, o, m, *win,
              n, *box, stream)
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int] + coeff_types
                       + [ctypes.c_int] * len(mode)
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_int] * len(box) + [ctypes.c_void_p])

        def go():
            err = fn(*a_)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
        return go

    def staged_box(tag, invs, oh, ow):
        old = WK.I420_TILE
        WK.I420_TILE = (tiles[tag], old[1])
        try:
            box = WK.i420_box(invs, h, w, oh, ow)
        finally:
            WK.I420_TILE = old
        return (*box, WK.i420_smem_bytes(box, h, w))

    gray = torch.rand((N_PLANES, h, w), generator=g, device=dev) * 255.0
    models = torch.tensor(np.stack([rot(-0.0255 + 0.004 * k, -59.63 + k,
                                        -14.9 - 0.5 * k)
                                    for k in range(N_PLANES)]), device=dev)
    plane_table = WK.device_inverse_coeffs(models)
    plane_out = torch.empty((N_PLANES, h, w), device=dev)

    def plane_call(lib, tag, n, direct):
        fn = lib.warp_affine_plane_f32
        fn.restype = ctypes.c_int
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if by_value[tag]:       # src->dst affines, inverted in the kernel
            fn.argtypes = [p, ll, i, i, p, ll, ll, ll, p, p, i, i, i, i, p,
                           p]
            a_ = (gray.data_ptr(), h * w, h, w, models.data_ptr(),
                  *models.stride(), None, plane_out.data_ptr(), h, w, n,
                  int(direct), None, stream)
        else:                   # a dst->src device table
            fn.argtypes = [p, ll, i, i, p, p, i, i, i, p]
            a_ = (gray.data_ptr(), h * w, h, w, plane_table.data_ptr(),
                  plane_out.data_ptr(), h, w, n, stream)

        def go():
            err = fn(*a_)
            if err:
                raise RuntimeError(f"warp_affine_plane_f32: cudaError {err}")
        return go

    def shapes(tag):
        lib = libs[tag]
        by_value[tag] = "const float* host" in builds[tag]
        new_i420 = "int box_h" in builds[tag]
        per_tap = (0, 0, 0) if new_i420 else ()
        out = {
            "u8 compose feed": call(lib, "warp_affine_u8", frames[6],
                                    h * w * 3, (h, w), None, feed, (0,), 1,
                                    FEED_WIN, (), tag),
            "u8 seam batch": call(lib, "warp_affine_u8", frames, h * w * 3,
                                  (h, w), None if by_value[tag]
                                  else table.data_ptr(), seam_invs, (0,),
                                  N_SEAM, (320, 2048), (), tag),
            "content mode": call(lib, "warp_affine_u8", strip,
                                 2560 * 14336 * 3, (2560, 14336), None,
                                 content, (1,), 1, CONTENT_WIN, (), tag),
            "f32 compose feed": call(lib, "warp_affine_f32", f32,
                                     1061 * 1886 * 3, (1061, 1886), None,
                                     comp, (), 1, (1088, 2048), (), tag),
            "i420 compose feed per tap": call(
                lib, "warp_affine_i420", packed[6], h * w * 3 // 2, (h, w),
                None, feed, (), 1, FEED_WIN, per_tap, tag),
            "i420 seam batch per tap": call(
                lib, "warp_affine_i420", packed, h * w * 3 // 2, (h, w),
                None if by_value[tag] else table.data_ptr(), seam_invs, (),
                N_SEAM, (320, 2048), per_tap, tag)}
        if new_i420:
            out["i420 compose feed staged"] = call(
                lib, "warp_affine_i420", packed[6], h * w * 3 // 2, (h, w),
                None, feed, (), 1, FEED_WIN,
                staged_box(tag, [feed], *FEED_WIN), tag)
        routes = ((" staged", False), (" direct", True)) if by_value[tag] \
            else (("", False),)
        for label, n in (("one frame", 1), (f"{N_PLANES}-frame batch",
                                             N_PLANES)):
            for route, direct in routes:
                out[f"plane {label}{route}"] = plane_call(lib, tag, n,
                                                          direct)
        return out

    calls = {tag: shapes(tag) for tag in builds}
    order = list(builds) + list(builds)[::-1]
    shapes_all = list(calls["current"]) + [
        k for k in calls["other"] if k not in calls["current"]]
    for shape in shapes_all:
        runs = {}
        for tag in order:
            if shape in calls[tag]:
                runs.setdefault(tag, []).append(device_ms(calls[tag][shape]))
        for tag, t in runs.items():
            extra = (f", box {staged_box(tag, [feed], *FEED_WIN)}"
                     if "staged" in shape else "")
            print(f"[k2ab] {shape} {tag}: device {np.mean(t):.4f} ms (runs "
                  f"{', '.join(f'{x:.4f}' for x in t)}){extra}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
