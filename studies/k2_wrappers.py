"""K2's wrappers on the card as a caller times them, at the smoke's K2
shapes on random data, for several checkouts of the port in one process.

    python studies/k2_wrappers.py [--roots DIR ...] [--rounds 20]
        [--reps 10]

``--roots`` are checkouts whose ``drone_image_stitch_cpp_tpu_torch`` is
timed (default: this one), for example the parent commit unpacked by
``git archive`` into ``build/parent`` beside this one (``--roots
build/parent .``). Each is loaded under a name of its own (the package
imports itself only relatively), builds its kernels into its own
``build/kernels`` and is called through the same public wrappers, so the
versions share one process and one host. Each case of each version is
timed two ways, over ``--rounds`` x ``--reps`` calls after a warm one;
versions and cases take turns, ``--reps`` calls each a round, so a drift
of the host's speed spreads over all of them: ``events``, the median of
CUDA events around one call followed by a synchronize
(``chip_smoke._median_ms``'s way), and ``host``, the median host time to
issue one call (``time.perf_counter`` around the call, the synchronize
after it). The first line is the card's name and power limit
(nvidia-smi); then one line per case and version: ``[k2w] <case> <root>:
events <ms> ms, host <us> us``. Needs one card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _feed_affine() -> np.ndarray:
    """The smoke's compose-feed affine: a 2-degree turn into the window."""
    th = np.radians(2.0)
    c, s = np.cos(th), np.sin(th)
    return np.asarray([[c, -s, 12000.37 - 11904.0], [s, c, 20.61]],
                      np.float32)


def _seam_affines(n: int, scale: float) -> np.ndarray:
    """n frames of one flight line at the seam scale, 180 px apart."""
    return np.stack([np.asarray([[scale, 0, scale * 180.0 * k],
                                 [0, scale, scale * 40.0]], np.float32)
                     for k in range(n)])


def inputs(torch, dev) -> dict:
    """The cases' frames and affines, made once for every version."""
    g = torch.Generator(device=dev).manual_seed(0)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.uint8)

    bgr = u8(2160, 3840, 3)
    bgr12 = u8(12, 2160, 3840, 3)
    i420 = u8(3240, 3840)
    i420_12 = u8(12, 3240, 3840)
    strip = u8(2560, 14336, 3)
    f32 = torch.rand((1061, 1886, 3), generator=g, device=dev) * 255.0
    planes = torch.rand((7, 2160, 3840), generator=g, device=dev) * 255.0
    feed = _feed_affine()
    seam = _seam_affines(12, 0.1203)
    f32_a23 = np.asarray([[0.999, -0.035, 12.4], [0.035, 0.999, 9.7]],
                         np.float32)
    content_a23 = np.asarray([[1, 0, -4000.0], [0, 1, 1280.0]], np.float32)
    full_a23 = np.asarray([[0.3366, 0, 0], [0, 0.3366, 0]], np.float32)
    models = torch.eye(3, device=dev).repeat(7, 1, 1)
    models[:, 0, 2] = -256.0 * 0.2329
    models[:, 1, 2] = -64.0 * 0.2329
    dev_a23s = models[:, :2]
    host_a23s = dev_a23s.cpu().numpy()
    return dict(locals())


def cases(WK, d: dict):
    """[(name, call)]: every K2 wrapper of ``WK`` at the smoke's shapes on
    the inputs ``d``."""
    bgr, bgr12, i420, i420_12 = d["bgr"], d["bgr12"], d["i420"], d["i420_12"]
    strip, f32, planes = d["strip"], d["f32"], d["planes"]
    feed, seam, f32_a23 = d["feed"], d["seam"], d["f32_a23"]
    content_a23, full_a23 = d["content_a23"], d["full_a23"]
    dev_a23s, host_a23s = d["dev_a23s"], d["host_a23s"]
    return [
        ("u8 compose feed", lambda: WK.warp_frame(bgr, feed, 2176, 3904)),
        ("u8 seam batch 12", lambda: WK.warp_frames(bgr12, seam, 320,
                                                    2048)),
        ("f32 compose feed", lambda: WK.warp_frame(f32, f32_a23, 1088,
                                                   2048)),
        ("content mode compose", lambda: WK.warp_frame(
            strip, content_a23, 5120, 5120, content="nonblack")),
        ("content mode seam fullres", lambda: WK.warp_frame(
            strip, full_a23, 1673, 4783, content="nonblack")),
        ("i420 compose feed", lambda: WK.warp_frame(i420, feed, 2176, 3904)),
        ("i420 seam batch 12", lambda: WK.warp_frames(i420_12, seam, 320,
                                                      2048)),
        ("plane one frame, card models", lambda: WK.warp_planes(
            planes[:1], dev_a23s[:1], 2160, 3840)),
        ("plane 7-frame batch, card models", lambda: WK.warp_planes(
            planes, dev_a23s, 2160, 3840)),
        ("plane 7-frame batch, host affines", lambda: WK.warp_planes(
            planes, host_a23s, 2160, 3840)),
    ]


def time_calls(torch, fn, reps: int, events: list, host: list) -> None:
    """Append the events ms and host us of ``reps`` calls of ``fn``."""
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        b.record()
        torch.cuda.synchronize()
        events.append(a.elapsed_time(b))
        host.append((t1 - t0) * 1e6)


def load_warp_kernel(root: str, k: int):
    """``ops/warp_kernel`` of the checkout at ``root``, its package loaded
    as ``k2w_port<k>``."""
    pkg = os.path.join(root, "drone_image_stitch_cpp_tpu_torch")
    name = f"k2w_port{k}"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.warp_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=[ROOT])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("[k2w] needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0],
          flush=True)
    data = inputs(torch, torch.device("cuda", 0))
    todo = {}           # (case, root): call
    for k, root in enumerate(args.roots):
        WK = load_warp_kernel(os.path.abspath(root), k)
        for name, fn in cases(WK, data):
            todo[name, root] = fn
    for fn in todo.values():
        fn()
    torch.cuda.synchronize()
    times = {key: ([], []) for key in todo}
    for _ in range(args.rounds):
        for key, fn in todo.items():
            time_calls(torch, fn, args.reps, *times[key])
    names = [name for name, _ in cases(None, data)]
    for key in sorted(todo, key=lambda kr: (names.index(kr[0]),
                                            args.roots.index(kr[1]))):
        events, host = times[key]
        print(f"[k2w] {key[0]} {key[1]}: events {np.median(events):.4f} "
              f"ms, host {np.median(host):.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
