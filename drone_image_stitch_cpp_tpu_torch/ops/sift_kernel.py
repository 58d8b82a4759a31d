"""K1: SIFT orientation + descriptor per keypoint (CUDA kernel + plain twin).

Replaces the Pallas TPU kernel ``drone_image_stitch_cpp_tpu/ops/
pallas_sift.py::_kernel`` (launched through ``_run`` /
``orientation_descriptor_flat``; called at ``ops/features.py:794``).

Semantics (full support, as the Pallas kernel): for keypoint k at (yf, xf)
with scale sigma in flat layer l of a (L, H, W) Gaussian stack, central-
difference gradients are taken over the 81x81 window centred on
(round(yf), round(xf)) and zeroed outside ``[1, h-2] x [1, w-2]`` of the
keypoint's own octave (``true_h``/``true_w``: the octaves share one stack
padded to octave 0's size). A 36-bin histogram of magnitude x
Gaussian(1.5 sigma) within radius round(4.5 sigma), circularly smoothed
with [1,4,6,4,1]/16, gives the dominant angle (argmax + parabolic peak);
a 4x4x8 descriptor over the native pixels rotated by that angle (hist
width 3 sigma, weight exp(-(u^2+v^2)/8), trilinear hats) is L2-normalised,
clipped at 0.2, renormalised, scaled by 512 and clipped at 255. The 81x81
window covers the whole descriptor support for sigma < 3.68 (radius
10.61 sigma + 0.5 <= 39), which includes every detected scale
(sigma < 1.6 * 2^(3.5/3) = 3.59).

``orientation_descriptor_flat`` launches the CUDA kernel
``csrc/sift_orient_desc.cu`` for CUDA tensors and runs
:func:`orientation_descriptor_plain` for CPU tensors; it never falls back
from one to the other. The kernel visits each keypoint's own support
(:func:`support_radius` of its scale sizes the window) and sums its
histograms in a fixed order, so its output is repeatable bit for bit; the
plain version sums in another order (tolerance, not equality).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..runtime.kernels import load_kernel, stream_handle

SUPPORT_R = 40           # window half-size: 81x81 px around the keypoint
KERNEL_SOURCE = "sift_orient_desc.cu"
KERNEL_SIGNATURES = {
    "sift_orient_desc": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]),
}
_ORI_BINS = 36
_D = 4
_OBINS = 8
_TWO_PI = 2.0 * math.pi


def support_radius(sigma_max):
    """Window half-size that holds every gradient a keypoint of scale
    <= ``sigma_max`` can use: descriptor support 2.5*sqrt(2)*3 sigma from a
    sub-pixel centre within 0.5 px of the window centre, plus the
    central-difference ring; at most SUPPORT_R. A float gives an int; a
    tensor of scales gives each one's radius as int32 on its device (what
    the kernel reads), computed in float64 like the float."""
    r = torch.clamp(torch.ceil(torch.as_tensor(sigma_max, dtype=torch.float64)
                               * 10.61 + 0.5) + 1, max=SUPPORT_R)
    if isinstance(sigma_max, torch.Tensor):
        return r.to(torch.int32)
    return int(r)


def orientation_descriptor_plain(gauss_flat: torch.Tensor,
                                 flat_layer: torch.Tensor,
                                 yf: torch.Tensor, xf: torch.Tensor,
                                 sigma: torch.Tensor, true_h: torch.Tensor,
                                 true_w: torch.Tensor, chunk: int = 512):
    """Plain PyTorch version of K1 on (N,) keypoints; returns
    (angle (N,), desc (N, 128)). Works on any device. Keypoints are taken
    ``chunk`` at a time in order of scale, each chunk over the window its
    largest scale needs (pixels outside the support weigh zero), which
    bounds the (chunk, window, 8) intermediates."""
    n = flat_layer.shape[0]
    dev = gauss_flat.device
    angle = torch.empty((n,), dtype=torch.float32, device=dev)
    desc = torch.empty((n, 128), dtype=torch.float32, device=dev)
    order = torch.argsort(sigma)
    for c0 in range(0, n, chunk):
        idx = order[c0:c0 + chunk]
        r = support_radius(float(sigma[idx].max()))
        a, d = _plain_chunk(gauss_flat, flat_layer[idx], yf[idx], xf[idx],
                            sigma[idx], true_h[idx], true_w[idx], r)
        angle[idx] = a
        desc[idx] = d
    return angle, desc


def _plain_chunk(gauss, layer, yf, xf, sigma, true_h, true_w, r):
    l_, h_, w_ = gauss.shape
    dev = gauss.device
    li = layer.long().clamp(0, l_ - 1)
    yi = torch.round(yf).long()
    xi = torch.round(xf).long()
    off = torch.arange(-r, r + 1, device=dev)
    rows = yi[:, None] + off[None, :]                   # (n, 2r+1)
    cols = xi[:, None] + off[None, :]
    win = gauss[li[:, None, None], rows.clamp(0, h_ - 1)[:, :, None],
                cols.clamp(0, w_ - 1)[:, None, :]]      # (n, 2r+1, 2r+1)
    gx = 0.5 * (win[:, 1:-1, 2:] - win[:, 1:-1, :-2])
    gy = 0.5 * (win[:, :-2, 1:-1] - win[:, 2:, 1:-1])   # y-up
    ra = rows[:, 1:-1].to(torch.float32)                # (n, 2r-1)
    ca_ = cols[:, 1:-1].to(torch.float32)
    th = true_h.to(torch.float32)[:, None]
    tw = true_w.to(torch.float32)[:, None]
    gvalid = (((ra >= 1.0) & (ra <= th - 2.0))[:, :, None]
              & ((ca_ >= 1.0) & (ca_ <= tw - 2.0))[:, None, :])
    mag = torch.sqrt(gx * gx + gy * gy)
    theta = torch.atan2(gy, gx)

    # ---- orientation: offsets from the ROUNDED centre ------------------
    o = off[1:-1].to(torch.float32)
    dyo = o[None, :, None]
    dxo = o[None, None, :]
    s = sigma.to(torch.float32)[:, None, None]
    radius = torch.round(4.5 * s)
    sig = 1.5 * s
    owgt = torch.exp(-(dyo * dyo + dxo * dxo) / (2.0 * sig * sig))
    oin = (dyo.abs() <= radius) & (dxo.abs() <= radius) & gvalid
    contrib = torch.where(oin, mag * owgt, torch.zeros_like(mag))
    binf = (theta / _TWO_PI) * _ORI_BINS
    bini = torch.remainder(torch.round(binf).long(), _ORI_BINS)
    n = li.shape[0]
    hist = torch.zeros((n, _ORI_BINS), dtype=torch.float32, device=dev)
    hist.scatter_add_(1, bini.reshape(n, -1), contrib.reshape(n, -1))
    hs = (torch.roll(hist, 2, 1) + torch.roll(hist, -2, 1)
          + 4.0 * (torch.roll(hist, 1, 1) + torch.roll(hist, -1, 1))
          + 6.0 * hist) / 16.0
    b = torch.argmax(hs, dim=1)
    l_v = hs.gather(1, torch.remainder(b - 1, _ORI_BINS)[:, None])[:, 0]
    c_v = hs.gather(1, b[:, None])[:, 0]
    r_v = hs.gather(1, torch.remainder(b + 1, _ORI_BINS)[:, None])[:, 0]
    denom = l_v - 2.0 * c_v + r_v
    big = denom.abs() > 1e-12
    interp = torch.where(big, 0.5 * (l_v - r_v)
                         / torch.where(big, denom, torch.ones_like(denom)),
                         torch.zeros_like(denom))
    bin_pos = torch.remainder(b.to(torch.float32) + interp, float(_ORI_BINS))
    angle = bin_pos * (_TWO_PI / _ORI_BINS)

    # ---- descriptor: sub-pixel offsets, rotated frame --------------------
    a3 = angle[:, None, None]
    cos_a = torch.cos(a3)
    sin_a = torch.sin(a3)
    hist_width = 3.0 * s
    dx = ca_[:, None, :] - xf.to(torch.float32)[:, None, None]
    dy = ra[:, :, None] - yf.to(torch.float32)[:, None, None]
    u = (cos_a * dx - sin_a * dy) / hist_width
    v = (sin_a * dx + cos_a * dy) / hist_width
    rbin = v + (_D - 1) / 2.0
    cbin = u + (_D - 1) / 2.0
    obin = torch.remainder(((theta - a3) / _TWO_PI) * _OBINS, float(_OBINS))
    gw = torch.exp(-(u * u + v * v) * (2.0 / (_D * _D)))
    inside = ((rbin > -1.0) & (rbin < _D) & (cbin > -1.0) & (cbin < _D)
              & gvalid)
    m = torch.where(inside, mag * gw, torch.zeros_like(mag)).reshape(n, -1)
    rb = rbin.reshape(n, -1)
    cb = cbin.reshape(n, -1)
    ob = obin.reshape(n, -1)
    bins = torch.arange(_OBINS, dtype=torch.float32, device=dev)
    odiff = (ob[:, :, None] - bins).abs()
    wo = torch.clamp(1.0 - torch.minimum(odiff, _OBINS - odiff), min=0.0)
    sp = torch.arange(_D, dtype=torch.float32, device=dev)
    wx_all = torch.clamp(1.0 - (cb[:, :, None] - sp).abs(), min=0.0)
    parts = []
    for by in range(_D):
        wy = torch.clamp(1.0 - (rb - by).abs(), min=0.0) * m
        z = wx_all * wy[:, :, None]                     # (n, P, 4)
        parts.append(torch.einsum("npx,npo->nxo", z, wo))
    d = torch.stack(parts, dim=1).reshape(n, 128)
    nrm = torch.sqrt((d * d).sum(dim=1, keepdim=True) + 1e-12)
    d = torch.clamp(d / nrm, max=0.2)
    nrm2 = torch.sqrt((d * d).sum(dim=1, keepdim=True) + 1e-12)
    return angle, torch.clamp(d / nrm2 * 512.0, max=255.0)


def _launch(gauss, radius, layer, yf, xf, sigma, true_h, true_w):
    fn = load_kernel(KERNEL_SOURCE, KERNEL_SIGNATURES).fns["sift_orient_desc"]
    n = layer.shape[0]
    l_, h_, w_ = gauss.shape
    angle = torch.empty((n,), dtype=torch.float32, device=gauss.device)
    desc = torch.empty((n, 128), dtype=torch.float32, device=gauss.device)
    err = fn(gauss.data_ptr(), l_, h_, w_, radius.data_ptr(),
             layer.data_ptr(), yf.data_ptr(),
             xf.data_ptr(), sigma.data_ptr(), true_h.data_ptr(),
             true_w.data_ptr(), angle.data_ptr(), desc.data_ptr(), n,
             stream_handle(gauss.device))
    if err != 0:
        raise RuntimeError(f"sift_orient_desc launch failed: cudaError {err}")
    return angle, desc


def orientation_descriptor_flat(gauss_flat: torch.Tensor,
                                flat_layer: torch.Tensor,
                                yf: torch.Tensor, xf: torch.Tensor,
                                sigma: torch.Tensor, true_h: torch.Tensor,
                                true_w: torch.Tensor, mixed: bool = False):
    """K1 over keypoints with any leading shape into a flat (L, H, W)
    float32 stack. Returns (angle (...,), desc (..., 128)).

    CUDA tensors launch ``csrc/sift_orient_desc.cu`` (counted in
    ``orientation_descriptor_flat.launches``, and also in ``.mixed_launches``
    when the caller's batch holds frames of different sizes, ``mixed``);
    CPU tensors run the plain version. Mixed devices raise.
    """
    lead = flat_layer.shape
    dev = gauss_flat.device
    args = [flat_layer, yf, xf, sigma, true_h, true_w]
    if any(a.device != dev for a in args):
        raise ValueError("orientation_descriptor_flat: all inputs must be "
                         f"on {dev}")
    if gauss_flat.ndim != 3 or gauss_flat.dtype != torch.float32:
        raise ValueError("gauss_flat must be a (L, H, W) float32 tensor, "
                         f"got {tuple(gauss_flat.shape)} {gauss_flat.dtype}")
    if any(a.shape != lead for a in args[1:]):
        raise ValueError("keypoint fields must share one shape")
    layer = flat_layer.reshape(-1).to(torch.int64).contiguous()
    fl = [a.reshape(-1).to(torch.float32).contiguous() for a in args[1:]]
    if dev.type == "cuda":
        if layer.numel() == 0:
            angle = torch.empty((0,), dtype=torch.float32, device=dev)
            desc = torch.empty((0, 128), dtype=torch.float32, device=dev)
        else:
            angle, desc = _launch(gauss_flat.contiguous(),
                                  support_radius(fl[2]), layer, *fl)
            orientation_descriptor_flat.launches += 1
            if mixed:
                orientation_descriptor_flat.mixed_launches += 1
    elif dev.type == "cpu":
        angle, desc = orientation_descriptor_plain(gauss_flat, layer, *fl)
    else:
        raise ValueError(f"unsupported device {dev}")
    return angle.reshape(lead), desc.reshape(*lead, 128)


orientation_descriptor_flat.launches = 0
orientation_descriptor_flat.mixed_launches = 0
