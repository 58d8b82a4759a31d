"""The multi-device sortie registration step over a device list.

Port of ``drone_image_stitch_cpp_tpu/parallel/sortie_step.py``
(``build_sortie_step``, a ``shard_map`` over a 1-D mesh, which is one
process driving every chip, as this is). The frames are sharded over the
devices in order; each device detects its shard (K1 on a card), the
descriptors are all-gathered so the banded pair schedule can match
across shard boundaries, each device registers the pairs whose first
frame it holds (``pipeline/pairgraph.register_pairs``, match + similarity
RANSAC, one pair per chunk), the bundle-adjust normal
equations are psum-reduced, every device solves the same system, and a
feather-blended preview canvas of the single-channel frames (the plain
``ops/warp.warp_affine``, as the JAX step never sends it to Pallas) is
psum-composed. The collectives are the host-ordered ones of
``parallel/mesh.py``.

Each frame is detected, and each pair matched and fitted, on its own
(a pair with its own sample bank), so their numbers have the same shapes
on any device count; only the psum's summation order depends on N. The
normal equations, their psum and the solve are float64 (the JAX step's
are float32): the system is built on raw pixel coordinates, and at the
grouper's 1800-px work size its float32 solve moves the transforms by
over a pixel with the summation order alone (between one and two devices
on the same frames), while float64 holds them within 1e-4.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.blend import border_feather_weight
from ..ops.features import Features, detect_and_describe_batched
from ..ops.transform import compose_affine
from ..ops.warp import warp_affine
from ..pipeline.bundle import normal_equations, solve_with_priors
from ..pipeline.pairgraph import register_pairs, sample_banks
from .mesh import all_gather, psum

_RATIO = 0.8


def build_sortie_step(devices: Sequence[torch.device], n_frames: int, h: int,
                      w: int, max_kp: int = 128, range_width: int = 2,
                      n_hyp: int = 128, thresh: float = 4.0,
                      canvas_h: int = 256, canvas_w: int = 512
                      ) -> Callable:
    """The step over ``devices`` for ``n_frames`` (H, W) gray frames
    (``n_frames`` divisible by the device count).

    Returns ``step(shards, seed=0, banks=None) -> (transforms, canvas,
    n_inliers)``. ``shards``: one (n_frames / N, H, W) float32 tensor per
    device, on it (:func:`demo_inputs`); ``banks``: optional
    (n_frames, range_width, n_hyp, 2) RANSAC sample integers for pair
    (i, i + g) at ``[i, g - 1]``, else drawn from a host generator seeded
    with ``seed`` (so they do not depend on N). Outputs on ``devices[0]``:
    transforms (n_frames, 2, 3) frame -> frame 0, canvas (canvas_h,
    canvas_w) feather-blend preview, n_inliers (n_frames * range_width,)
    per (frame, gap) pair, 0 where the partner is past the last frame.
    """
    devices = list(devices)
    n_dev = len(devices)
    if n_dev < 1 or n_frames % n_dev:
        raise ValueError(f"{n_frames} frames do not shard over {n_dev} "
                         f"devices")
    b_loc = n_frames // n_dev
    shift = torch.tensor([[0.25, 0.0, canvas_w * 0.25],
                          [0.0, 0.25, canvas_h * 0.25]], dtype=torch.float32)

    def step(shards: Sequence[torch.Tensor], seed: int = 0,
             banks: Optional[torch.Tensor] = None):
        if len(shards) != n_dev or any(
                s.shape != (b_loc, h, w) or s.device != d
                for s, d in zip(shards, devices)):
            raise ValueError(f"need {n_dev} shards of shape ({b_loc}, {h}, "
                             f"{w}), each on its device")
        if banks is None:
            banks = sample_banks(n_frames * range_width, n_hyp, seed)
        banks = torch.as_tensor(banks).reshape(n_frames * range_width,
                                               n_hyp, 2)
        # each frame detected on its own: the same shapes on any N
        feats = [Features(*(torch.cat(fs) for fs in zip(*(
            detect_and_describe_batched(s[li:li + 1].to(torch.float32),
                                        max_kp) for li in range(b_loc)))))
                 for s in shards]
        # every device sees every frame's keypoints, so the banded
        # schedule crosses shard boundaries
        xy_all, desc_all, valid_all = (
            all_gather([getattr(f, k) for f in feats], devices)
            for k in ("xy", "desc", "valid"))

        systems, n_inl = [], []
        for d, dev in enumerate(devices):
            # the pairs (i, i + g) of this device's frames in (frame, gap)
            # order, each with its own bank; a partner past the last
            # frame makes no pair and counts 0 inliers
            sched = [(i, i + g) for i in range(d * b_loc, (d + 1) * b_loc)
                     for g in range(1, range_width + 1)]
            live = [k for k, (_, j) in enumerate(sched) if j < n_frames]
            inl = torch.zeros(len(sched), dtype=torch.int64, device=dev)
            pair_idx = torch.zeros((0, 2), dtype=torch.long, device=dev)
            pts_a = pts_b = torch.zeros((0, 1, 2), dtype=torch.float64,
                                        device=dev)
            wts = torch.zeros((0, 1), dtype=torch.float64, device=dev)
            if live:
                # register_pairs reads only xy, desc and valid
                g = register_pairs(
                    Features(xy_all[d], None, None, None, desc_all[d],
                             valid_all[d]),
                    [sched[k] for k in live], _RATIO, thresh,
                    n_hyp=n_hyp, chunk=1,
                    banks=banks[d * len(sched) + torch.tensor(live)],
                    devices=[dev])
                inl[live] = g.n_inliers.to(torch.int64)
                pair_idx = torch.from_numpy(g.pairs).to(dev)
                pts_a, pts_b, wts = (a.to(torch.float64)
                                     for a in (g.pts_a, g.pts_b, g.w))
            systems.append(normal_equations(pair_idx, pts_a, pts_b, wts,
                                            n_frames))
            n_inl.append(inl)

        # mesh-wide reduce of the normal equations, replicated solve
        ata = psum([s[0] for s in systems], devices)
        atb = psum([s[1] for s in systems], devices)
        transforms = []
        acc_loc, wacc_loc = [], []
        for d, dev in enumerate(devices):
            init = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64,
                                device=dev).repeat(n_frames, 1)
            t_all = solve_with_priors(ata[d], atb[d], init).to(torch.float32)
            transforms.append(t_all)
            # preview canvas: local warps, psum over the devices
            feather = border_feather_weight(h, w, device=dev)
            acc = torch.zeros((canvas_h, canvas_w), dtype=torch.float32,
                              device=dev)
            wacc = torch.zeros_like(acc)
            sh = shift.to(dev)
            for li in range(b_loc):
                tc = compose_affine(sh, t_all[d * b_loc + li])
                acc = acc + warp_affine(shards[d][li] * feather, tc,
                                        canvas_h, canvas_w)
                wacc = wacc + warp_affine(feather, tc, canvas_h, canvas_w)
            acc_loc.append(acc)
            wacc_loc.append(wacc)
        acc = psum(acc_loc, devices)[0]
        wacc = psum(wacc_loc, devices)[0]
        canvas = acc / wacc.clamp(min=1e-6)
        n_inliers = torch.cat([v.to(devices[0]) for v in n_inl])
        return transforms[0], canvas, n_inliers

    return step


def demo_inputs(devices: Sequence[torch.device], n_frames: int, h: int,
                w: int, seed: int = 0) -> Tuple[List[torch.Tensor], int]:
    """The JAX package's synthetic frames (the same numpy draws: a
    sinusoid with sharp patches and smoothed noise, frame k shifted by
    8 k px on both axes), sharded over ``devices`` in order: (one
    (n_frames / N, H, W) float32 shard per device, the bank seed)."""
    r = np.random.default_rng(seed)
    bh, bw = h + 8 * n_frames, w + 8 * n_frames
    yy, xx = np.mgrid[0:bh, 0:bw].astype(np.float32)
    base = 110 + 50 * np.sin(xx / 17.0) * np.cos(yy / 13.0)
    for _ in range(300):  # sharp patches: structure at feature scales
        cy, cx = int(r.integers(0, bh)), int(r.integers(0, bw))
        s = int(r.integers(2, 8))
        base[max(0, cy - s):cy + s, max(0, cx - s):cx + s] = r.uniform(0,
                                                                       255)
    try:
        from scipy.ndimage import gaussian_filter
        base = base + gaussian_filter(r.normal(0, 1, (bh, bw)), 2.0) * 40.0
    except ImportError:
        pass
    base = np.clip(base, 0, 255).astype(np.float32)
    frames = np.stack([base[8 * i:8 * i + h, 8 * i:8 * i + w]
                       for i in range(n_frames)])
    devices = list(devices)
    b_loc = n_frames // len(devices)
    return [torch.from_numpy(frames[d * b_loc:(d + 1) * b_loc]).to(dev)
            for d, dev in enumerate(devices)], seed
