"""How far the strip bundle adjust shrinks one long thermal line.

    PYTHONPATH= JAX_PLATFORMS=cpu python studies/bundle_shrink.py \\
        [--frames 100] [--noise-seed 2654435761]     # CPU, about 3 min

Renders one line of the ``lwir-640`` configuration (640x512 frames at 64 px
steps, ``benchmark/mosaicbench/render_thermal``, terrain seed 11) into a
scratch directory, runs the port's strip registration on the CPU with the
lwir preset and keeps the inputs of its bundle adjust (pairs, matched
points, weights, chain init). It then solves that one system four ways
and prints, for each, the last frame's scale and offset against the
planted ones, and the largest offset error over the line:

- the port as it runs (float64, with its errors-in-variables correction);
- the port's float32 path (the benchmark's sortie control);
- the JAX package's formulation as written (float32);
- the same in float64: x64 on, the module's float32 dtypes read as
  float64, which is the plain least-squares solve without the correction.

A study script, kept to reproduce the finding in PERF.md section 6; no
test runs it. It edits nothing of either package.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmark")]


def _inputs(frames, noise_seed, work):
    import cv2
    import numpy as np
    import torch
    from mosaicbench.render_thermal import render_thermal
    from drone_image_stitch_cpp_tpu_torch.config.tuning import (
        load_stitch_tuning)
    from drone_image_stitch_cpp_tpu_torch.pipeline import strip

    d = os.path.join(work, "in")
    render_thermal(d, 1, frames, 512, 640, 0.90, 0.60, seed=11,
                   noise_seed=noise_seed, device="cpu",
                   cache_dir=os.path.join(work, "terrain"))
    names = sorted(os.listdir(d))
    imgs = [cv2.imread(os.path.join(d, f)) for f in names]
    tu = load_stitch_tuning("lwir")
    tu = tu.replace(sift_features=tu.strip_sift_features)
    kept = {}
    solve = strip.bundle_adjust_similarity

    def keep(*args, **kw):
        kept["args"] = [a.cpu() for a in args]
        return solve(*args, **kw)

    strip.bundle_adjust_similarity = keep
    try:
        strip.estimate_strip_transforms(imgs, tu, tu.range_width,
                                        device=torch.device("cpu"))
    finally:
        strip.bundle_adjust_similarity = solve
    return [np.asarray(a) for a in kept["args"]]


def _jax_solve(args, float64):
    import jax
    jax.config.update("jax_enable_x64", True)   # float32 inputs stay so
    import jax.numpy as jnp
    import numpy as np
    from drone_image_stitch_cpp_tpu.pipeline import bundle as JB

    pi, pa, pb, w, init = args
    dt = np.float64 if float64 else np.float32
    real = JB.jnp
    if float64:
        names = {k: getattr(jnp, k) for k in dir(jnp)
                 if not k.startswith("__")}
        JB.jnp = types.SimpleNamespace(**{**names, "float32": jnp.float64})
    try:
        out = JB.bundle_adjust_similarity(
            jnp.asarray(pi.astype(np.int32)),
            *(jnp.asarray(a.astype(dt)) for a in (pa, pb, w, init)))
    finally:
        JB.jnp = real
    return np.asarray(out, dtype=np.float64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--noise-seed", type=int, default=2654435761)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    torch.set_num_threads(min(6, os.cpu_count() or 1))
    from drone_image_stitch_cpp_tpu_torch.pipeline.bundle import (
        bundle_adjust_similarity)

    with tempfile.TemporaryDirectory() as work:
        inputs = _inputs(args.frames, args.noise_seed, work)
    tin = [torch.from_numpy(a) for a in inputs]
    step = 64.0
    rows = [
        ("port, float64 (corrected)",
         bundle_adjust_similarity(*tin).numpy()),
        ("port, float32 (control)",
         bundle_adjust_similarity(*tin, dtype=torch.float32).numpy()),
        ("JAX package, float32", _jax_solve(inputs, False)),
        ("JAX package, float64", _jax_solve(inputs, True)),
    ]
    last = args.frames - 1
    print(f"frame {last}: planted scale 1, offset ({step * last:.0f}, 0)")
    for name, out in rows:
        out = np.asarray(out, dtype=np.float64)
        sc = np.hypot(out[:, 0, 0], out[:, 1, 0])
        err = np.abs(out[:, 0, 2] - step * np.arange(len(out))).max()
        print(f"{name:28s} scale {sc[last]:.5f}  offset "
              f"({out[last, 0, 2]:.2f}, {out[last, 1, 2]:.2f})  "
              f"largest x error {err:.2f} px")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
