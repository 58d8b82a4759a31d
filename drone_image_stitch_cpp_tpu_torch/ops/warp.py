"""Affine / homography image warping with bilinear sampling (the exact
gather).

Port of ``drone_image_stitch_cpp_tpu/ops/warp.py``: ``warp_affine``
(cv::warpAffine INTER_LINEAR + BORDER_CONSTANT(0), stitch_global.cpp:
369-376), ``warp_perspective`` (the plane-warper family,
stitch_robust.cpp:203-205), ``warp_content_mask`` (buildWarpedContentMask,
:353-383) and ``remap`` (cv::remap, the sampler of ops/undistort.py).
Transforms are src->dst like OpenCV and are inverted here; out-of-bounds
taps read the constant border. ``warp_affine`` is the function the
hand-written warp kernel (ops/warp_kernel.py) is held to; the perspective
warps and ``remap`` stay plain PyTorch, as the JAX package never sends
them to its Pallas kernel.
"""

from __future__ import annotations

import torch

from .transform import invert_affine


def bilinear_sample(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                    border_value: float = 0.0) -> torch.Tensor:
    """Sample (H, W) or (H, W, C) ``img`` at float coords (Ho, Wo)."""
    h, w = img.shape[0], img.shape[1]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.long)
    y0i = y0.to(torch.long)
    border = torch.tensor(border_value, dtype=img.dtype, device=img.device)

    def fetch(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(inb[..., None] if img.ndim == 3 else inb, v,
                           border)

    v00 = fetch(y0i, x0i)
    v01 = fetch(y0i, x0i + 1)
    v10 = fetch(y0i + 1, x0i)
    v11 = fetch(y0i + 1, x0i + 1)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def dst_to_src_coords(inv23: torch.Tensor, out_h: int, out_w: int):
    """Source coordinates (sx, sy) of every output pixel for a dst->src
    (2, 3) affine, evaluated as ((a*x) + (b*y)) + c in float32."""
    dev = inv23.device
    dx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    dy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    sx = inv23[0, 0] * dx + inv23[0, 1] * dy + inv23[0, 2]
    sy = inv23[1, 0] * dx + inv23[1, 1] * dy + inv23[1, 2]
    return sx, sy


def warp_affine(img: torch.Tensor, a23: torch.Tensor, out_h: int,
                out_w: int, border_value: float = 0.0) -> torch.Tensor:
    """Warp with a src->dst (2, 3) affine, bilinear, constant border."""
    inv = invert_affine(a23.to(torch.float32))
    sx, sy = dst_to_src_coords(inv, out_h, out_w)
    return bilinear_sample(img.to(torch.float32), sx, sy, border_value)


def warp_perspective(img: torch.Tensor, h33, out_h: int, out_w: int,
                     border_value: float = 0.0) -> torch.Tensor:
    """Warp with a src->dst (3, 3) homography (host array or tensor),
    bilinear, constant border. The inverse is ``torch.linalg.inv`` in
    float32 on the host, so the card and the CPU sample the same
    coordinates; a destination pixel whose denominator is within 1e-12 of
    0 divides by 1e-12, as in the JAX package."""
    dev = img.device
    inv = torch.linalg.inv(torch.as_tensor(h33, dtype=torch.float32).cpu()
                           ).to(dev)
    dx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    dy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    den = inv[2, 0] * dx + inv[2, 1] * dy + inv[2, 2]
    den = torch.where(den.abs() < 1e-12,
                      torch.tensor(1e-12, dtype=torch.float32, device=dev),
                      den)
    sx = (inv[0, 0] * dx + inv[0, 1] * dy + inv[0, 2]) / den
    sy = (inv[1, 0] * dx + inv[1, 1] * dy + inv[1, 2]) / den
    return bilinear_sample(img.to(torch.float32), sx, sy, border_value)


def warp_content_mask(content_mask: torch.Tensor, a23: torch.Tensor,
                      out_h: int, out_w: int,
                      footprint_thresh: float = 0.999) -> torch.Tensor:
    """Warp a bool/float content mask bilinearly and keep the pixels whose
    footprint is >= ``footprint_thresh`` (excludes out-of-bounds wedges
    and interior black pixels). Returns bool (out_h, out_w)."""
    warped = warp_affine(content_mask.to(torch.float32), a23, out_h, out_w)
    return warped >= footprint_thresh


def remap(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
          border_value: float = 0.0) -> torch.Tensor:
    """cv::remap analog: sample ``img`` at per-pixel float coordinates."""
    return bilinear_sample(img.to(torch.float32), map_x, map_y, border_value)
