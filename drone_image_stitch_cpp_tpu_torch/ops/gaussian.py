"""Separable Gaussian filtering and image pyramids.

Port of ``drone_image_stitch_cpp_tpu/ops/gaussian.py``: REFLECT_101 borders
(OpenCV's default), the same banded-Toeplitz matmul for sides up to 2048
px and a shift-and-add 1-D convolution above that, cv::pyrDown/pyrUp with
the 5-tap binomial kernel, and Gaussian/Laplacian pyramids.

Layout: like the JAX package, a 2-D input is (H, W) and a 3-D one is
(H, W, C) unless ``channels_last=False`` says it is a (B, H, W) batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    """1-D Gaussian taps. Radius defaults to OpenCV-ish round(4*sigma)."""
    if radius is None:
        radius = max(1, int(round(4.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def _axes(x: torch.Tensor, channels_last: bool | None):
    if channels_last is None:
        channels_last = x.ndim >= 3
    hax = x.ndim - 3 if channels_last else x.ndim - 2
    return hax, hax + 1


@functools.lru_cache(maxsize=64)
def _reflect_index_np(n: int, r: int) -> np.ndarray:
    """Source index of each position of an ``r``-padded length-``n`` axis
    under REFLECT_101 (numpy's "reflect"), repeated reflection included."""
    i = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * n - 2
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


def _conv1d_along(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Depthwise 1-D convolution with REFLECT_101 padding along ``axis``,
    as a sum of statically shifted slices (the JAX package's op order)."""
    taps_np = np.asarray(taps, np.float32)
    r = taps_np.shape[0] // 2
    x = torch.movedim(img.to(torch.float32), axis, -1)
    n = x.shape[-1]
    idx = torch.from_numpy(_reflect_index_np(n, r)).to(x.device)
    xp = x.index_select(-1, idx)
    y = float(taps_np[0]) * xp[..., 0:n]
    for k in range(1, 2 * r + 1):
        y = y + float(taps_np[k]) * xp[..., k:k + n]
    return torch.movedim(y, -1, axis)


@functools.lru_cache(maxsize=256)
def _blur_matrix(sigma: float, n: int, radius: int | None) -> np.ndarray:
    """(n, n) banded Toeplitz blur matrix with REFLECT_101 edges folded in."""
    k = gaussian_kernel1d(sigma, radius)
    r = k.shape[0] // 2
    t = np.zeros((n, n), np.float32)
    for i in range(n):
        for dj, w in zip(range(-r, r + 1), k):
            j = i + dj
            if j < 0:
                j = -j              # reflect-101: -1 -> 1
            elif j >= n:
                j = 2 * n - 2 - j   # n -> n-2
            j = min(max(j, 0), n - 1)
            t[i, j] += w
    return t


_BLUR_MATMUL_MAX = 2048
_MATRIX_CACHE: dict = {}


def _blur_matrix_t(sigma: float, n: int, radius, device) -> torch.Tensor:
    """Transposed Toeplitz matrix on ``device`` (cached per device)."""
    key = (float(sigma), n, radius, str(device))
    m = _MATRIX_CACHE.get(key)
    if m is None:
        m = torch.from_numpy(_blur_matrix(float(sigma), n, radius).T.copy()
                             ).to(device)
        if len(_MATRIX_CACHE) > 256:
            _MATRIX_CACHE.clear()
        _MATRIX_CACHE[key] = m
    return m


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None,
                  channels_last: bool | None = None) -> torch.Tensor:
    """Separable Gaussian blur over the (H, W) axes: banded-Toeplitz
    matmuls for sides up to 2048 px, shifted-slice convolution above."""
    hax, wax = _axes(img, channels_last)
    h, w = img.shape[hax], img.shape[wax]
    x = img.to(torch.float32)
    if max(h, w) <= _BLUR_MATMUL_MAX:
        for ax, n in ((hax, h), (wax, w)):
            tm = _blur_matrix_t(sigma, n, radius, x.device)
            x = torch.movedim(torch.movedim(x, ax, -1) @ tm, -1, ax)
        return x
    taps = gaussian_kernel1d(sigma, radius)
    x = _conv1d_along(x, taps, axis=hax)
    return _conv1d_along(x, taps, axis=wax)


# cv::pyrDown 5-tap kernel
_PYR_TAPS = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def pyr_down(img: torch.Tensor, channels_last: bool | None = None
             ) -> torch.Tensor:
    """Blur with the 5-tap binomial kernel and decimate by 2."""
    hax, wax = _axes(img, channels_last)
    x = _conv1d_along(img, _PYR_TAPS, axis=hax)
    x = _conv1d_along(x, _PYR_TAPS, axis=wax)
    idx = [slice(None)] * x.ndim
    idx[hax] = slice(0, None, 2)
    idx[wax] = slice(0, None, 2)
    return x[tuple(idx)]


def pyr_up(img: torch.Tensor, out_h: int, out_w: int,
           channels_last: bool | None = None) -> torch.Tensor:
    """Zero-stuff upsample x2 then blur with the 2x kernel (cv::pyrUp)."""
    hax, wax = _axes(img, channels_last)
    x = img.to(torch.float32)
    shape = list(x.shape)
    shape[hax] = out_h
    shape[wax] = out_w
    up = torch.zeros(shape, dtype=x.dtype, device=x.device)
    src = [slice(None)] * x.ndim
    src[hax] = slice(0, (out_h + 1) // 2)
    src[wax] = slice(0, (out_w + 1) // 2)
    dst = [slice(None)] * x.ndim
    dst[hax] = slice(0, out_h, 2)
    dst[wax] = slice(0, out_w, 2)
    up[tuple(dst)] = x[tuple(src)]
    up = _conv1d_along(up, _PYR_TAPS * 2.0, axis=hax)
    return _conv1d_along(up, _PYR_TAPS * 2.0, axis=wax)


def gaussian_pyramid(img: torch.Tensor, levels: int,
                     channels_last: bool | None = None
                     ) -> list[torch.Tensor]:
    """[img, pyrDown(img), ...] with ``levels + 1`` entries."""
    out = [img.to(torch.float32)]
    for _ in range(levels):
        out.append(pyr_down(out[-1], channels_last))
    return out


def laplacian_pyramid(img: torch.Tensor, levels: int,
                      channels_last: bool | None = None
                      ) -> list[torch.Tensor]:
    """Band-pass pyramid; last entry is the low-pass residual."""
    gp = gaussian_pyramid(img, levels, channels_last)
    out = []
    for i in range(levels):
        hax, wax = _axes(gp[i], channels_last)
        up = pyr_up(gp[i + 1], gp[i].shape[hax], gp[i].shape[wax],
                    channels_last)
        out.append(gp[i] - up)
    out.append(gp[levels])
    return out


def collapse_laplacian(pyr: list[torch.Tensor],
                       channels_last: bool | None = None) -> torch.Tensor:
    """Reconstruct the image from its Laplacian pyramid."""
    x = pyr[-1]
    for lvl in reversed(pyr[:-1]):
        hax, wax = _axes(lvl, channels_last)
        x = pyr_up(x, lvl.shape[hax], lvl.shape[wax], channels_last) + lvl
    return x
