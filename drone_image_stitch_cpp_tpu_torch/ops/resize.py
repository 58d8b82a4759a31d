"""Resize ops: linear (triangle filter) and area-average downscale.

Port of ``drone_image_stitch_cpp_tpu/ops/resize.py``. ``resize_linear``
reproduces ``jax.image.resize(..., method="linear")``: per spatial axis a
dense (in, out) weight matrix of the triangle kernel, widened by the
downscale factor (antialiasing) when shrinking, each column normalised,
columns whose sample lies outside the input zeroed; the axes are then
contracted one after the other.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _linear_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of jax.image's scale_and_translate
    with the triangle kernel, antialias on, zero translation."""
    inv_scale = np.float32(1.0 / (n_out / n_in))   # float64, then f32
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :]
                - np.arange(n_in, dtype=np.float32)[:, None])
         / np.float32(kernel_scale))
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps,
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _weights(n_in: int, n_out: int, device) -> torch.Tensor:
    w = torch.from_numpy(_linear_weights_np(n_in, n_out))
    if torch.device(device).type != "cpu":
        resize_linear.uploaded += w.nbytes
    return w.to(device)


def _spatial_axes(img: torch.Tensor, channels_last: bool):
    if img.ndim == 2 or not channels_last:
        return img.ndim - 2, img.ndim - 1
    return img.ndim - 3, img.ndim - 2


def resize_linear(img: torch.Tensor, out_h: int, out_w: int,
                  channels_last: bool | None = None) -> torch.Tensor:
    """Triangle-filter resize of (..., H, W) or (H, W, C).

    Like the JAX package, a 3-D input is (H, W, C) and a 2-D one (H, W);
    pass ``channels_last=False`` for a (B, H, W) batch. Axes whose size
    does not change are left untouched (the kernel is interpolating).
    """
    if channels_last is None:
        channels_last = img.ndim == 3
    hax, wax = _spatial_axes(img, channels_last)
    x = img.to(torch.float32)
    for ax, n_out in ((hax, out_h), (wax, out_w)):
        n_in = x.shape[ax]
        if n_in == n_out:
            continue
        wm = _weights(n_in, n_out, x.device)
        x = torch.movedim(torch.movedim(x, ax, -1) @ wm, -1, ax)
    return x


resize_linear.uploaded = 0      # bytes of weights copied from the host to
                                # a card, summed over every call


def resize_area(img: torch.Tensor, out_h: int, out_w: int,
                channels_last: bool | None = None) -> torch.Tensor:
    """Area-average downscale (cv INTER_AREA analog): an exact box filter
    for integer decimation factors, else :func:`resize_linear`."""
    if channels_last is None:
        channels_last = img.ndim == 3
    hax, wax = _spatial_axes(img, channels_last)
    h, w = img.shape[hax], img.shape[wax]
    if h % out_h == 0 and w % out_w == 0:
        fy, fx = h // out_h, w // out_w
        x = img.to(torch.float32)
        shape = (list(x.shape[:hax]) + [out_h, fy, out_w, fx]
                 + list(x.shape[wax + 1:]))
        return x.reshape(shape).mean(dim=(hax + 1, hax + 3))
    return resize_linear(img, out_h, out_w, channels_last)


def scale_for_megapixels(h: int, w: int, mpx: float) -> float:
    """Work-scale so h*w*scale^2 ~= mpx * 1e6; never upscales; negative
    mpx means full resolution (stitch_robust.cpp:183-185)."""
    if mpx is None or mpx <= 0:
        return 1.0
    return min(1.0, (mpx * 1e6 / float(h * w)) ** 0.5)


def scale_for_max_dim(h: int, w: int, max_dim: int) -> float:
    """Work-scale so that max(h, w) <= max_dim; never upscales (the global
    aligner's <= 2800 px, stitch_global.cpp:119-136)."""
    m = max(h, w)
    return 1.0 if m <= max_dim else max_dim / float(m)
