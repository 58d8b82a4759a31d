"""K2: bilinear affine warp of uint8 BGR frames + their content masks.

Replaces the Pallas TPU kernel ``drone_image_stitch_cpp_tpu/ops/
pallas_warp.py::_kernel`` (launched through ``_run``; entries
``warp_affine`` and ``warp_affine_many``; called four times per compose
feed at ``pipeline/compose_feed.py:92,97``: three channels and the content
mask). The Pallas kernel was a near-identity shift-select approximation
(|linear - I| <= 0.05, errors of a few levels); the CUDA kernel
``csrc/warp_affine.cu`` is the exact per-pixel bilinear gather of
:func:`ops.warp.warp_affine` for ANY affine, and one launch reads N uint8
frames and writes all three float32 channels and the warped content mask
of each (BORDER_CONSTANT 0 outside the source). The mask is the warp of
all-ones (``content="ones"``, the strip compose) or of the source's gray
> 2 indicator (``content="nonblack"``, the global compose:
:func:`ops.color.content_mask`).

:func:`warp_frame` (one frame) and :func:`warp_frames` (a batch, as the
JAX package's ``warp_affine_many``) launch the kernel for CUDA tensors and
run the plain versions for CPU tensors; they never fall back from one to
the other.
"""

from __future__ import annotations

import ctypes
import math
import struct

import numpy as np
import torch

from ..runtime.kernels import load_kernel, stream_handle
from .color import content_mask
from .warp import bilinear_sample, dst_to_src_coords

KERNEL_SOURCE = "warp_affine.cu"
KERNEL_SIGNATURES = {
    "warp_affine_u8": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p] + [ctypes.c_float] * 6 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}
CONTENT_MODES = ("ones", "nonblack")
_MAX_FRAMES = 65535          # grid.y of one launch
_F32 = struct.Struct("f")


def _r32(v: float) -> float:
    """``v`` rounded to float32, as a Python float (infinite beyond the
    float32 range)."""
    try:
        return _F32.unpack(_F32.pack(v))[0]
    except OverflowError:
        return math.copysign(math.inf, v)


def _singular(a23) -> ValueError:
    return ValueError(f"affine {np.asarray(a23).tolist()} is singular")


def inverse_coeffs(a23) -> tuple:
    """dst->src coefficients (i00, i01, i02, i10, i11, i12) of a src->dst
    (2, 3) affine, as Python floats holding float32 values.

    A float32 LU solve with partial pivoting in the operation order of the
    JAX package's ``ops/transform.invert_affine`` on the CPU (pivot
    reciprocals, fused back substitution and translation), so the
    coefficients equal JAX's bit for bit. Each step is computed in float64
    and rounded to float32, which gives the float32 result of a basic
    operation; ``a * b + c`` of float32 values rounded once is the fused
    multiply-add (the product is exact in float64). The kernel and the
    plain version both take these, so they sample the same coordinates; no
    tensor is made, so a launch costs no host round trip."""
    (a, b, tx), (c, d, ty) = np.asarray(a23, np.float32).reshape(
        2, 3).tolist()
    swap = abs(c) > abs(a)
    p, q, r, s = (c, d, a, b) if swap else (a, b, c, d)
    if p == 0:
        raise _singular(a23)
    rp = _r32(1.0 / p)
    low = _r32(r * rp)
    u = _r32(s - _r32(low * q))
    if u == 0 or not math.isfinite(u):
        raise _singular(a23)
    ru = _r32(1.0 / u)
    cols = []
    for e1, e2 in ((1.0, 0.0), (0.0, 1.0)):
        y1, y2 = (e2, e1) if swap else (e1, e2)
        x2 = _r32(_r32(y2 - _r32(low * y1)) * ru)
        cols.append((_r32(_r32(y1 - q * x2) * rp), x2))
    (i00, i10), (i01, i11) = cols
    return (i00, i01, -_r32(i01 * ty + _r32(i00 * tx)),
            i10, i11, -_r32(i11 * ty + _r32(i10 * tx)))


def warp_frame_plain(img_u8: torch.Tensor, inv, out_h: int, out_w: int,
                     content: str = "ones"):
    """Plain PyTorch version of K2 for one frame and its
    :func:`inverse_coeffs`: (warped (out_h, out_w, 3) float32, warped
    content mask (out_h, out_w) float32: the warp of all-ones, or with
    ``content="nonblack"`` of :func:`ops.color.content_mask`)."""
    inv23 = torch.tensor(inv, dtype=torch.float32,
                         device=img_u8.device).reshape(2, 3)
    sx, sy = dst_to_src_coords(inv23, out_h, out_w)
    wimg = bilinear_sample(img_u8.to(torch.float32), sx, sy)
    if content == "nonblack":
        src = content_mask(img_u8).to(torch.float32)
    else:
        src = torch.ones(img_u8.shape[:2], dtype=torch.float32,
                         device=img_u8.device)
    return wimg, bilinear_sample(src, sx, sy)


def warp_frames_plain(frames_u8: torch.Tensor, invs, out_h: int, out_w: int,
                      content: str = "ones"):
    """Plain version of the batched K2: :func:`warp_frame_plain` per frame,
    stacked to ((N, out_h, out_w, 3), (N, out_h, out_w))."""
    outs = [warp_frame_plain(f, inv, out_h, out_w, content)
            for f, inv in zip(frames_u8, invs)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def _launch(src_u8: torch.Tensor, nf: int, invs, out_h: int, out_w: int,
            content: str = "ones"):
    """One kernel launch over ``nf`` contiguous (H, W, 3) uint8 frames
    (``src_u8``: (H, W, 3) for one, (N, H, W, 3) for a batch); ``invs``:
    one coefficient tuple (passed by value, nf == 1) or a device (N, 6)
    float32 table. Returns the warped planes, shaped with src_u8's leading
    dimensions."""
    fn = load_kernel(KERNEL_SOURCE, KERNEL_SIGNATURES).fns["warp_affine_u8"]
    lead = src_u8.shape[:-3]
    h, w = src_u8.shape[-3], src_u8.shape[-2]
    dev = src_u8.device
    wimg = torch.empty(lead + (out_h, out_w, 3), dtype=torch.float32,
                       device=dev)
    mask = torch.empty(lead + (out_h, out_w), dtype=torch.float32,
                       device=dev)
    if isinstance(invs, torch.Tensor):
        table, coeffs = invs.data_ptr(), (0.0,) * 6
    else:
        table, coeffs = None, invs
    err = fn(src_u8.data_ptr(), h * w * 3, h, w, table, *coeffs,
             int(content == "nonblack"), wimg.data_ptr(), mask.data_ptr(),
             out_h, out_w, nf, stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"warp_affine_u8 launch failed: cudaError {err}")
    return wimg, mask


def _check(frames_u8: torch.Tensor, ndim: int, out_h: int, out_w: int,
           content: str):
    if frames_u8.dtype != torch.uint8 or frames_u8.ndim != ndim \
            or frames_u8.shape[-1] != 3:
        shape = "(H, W, 3)" if ndim == 3 else "(N, H, W, 3)"
        raise ValueError(f"K2 takes {shape} uint8 frames, got "
                         f"{tuple(frames_u8.shape)} {frames_u8.dtype}")
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"empty output window {out_h}x{out_w}")
    if content not in CONTENT_MODES:
        raise ValueError(f"content must be one of {CONTENT_MODES}, got "
                         f"{content!r}")
    if frames_u8.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {frames_u8.device}")


def warp_frame(img_u8: torch.Tensor, a23, out_h: int, out_w: int,
               content: str = "ones"):
    """Warp an (H, W, 3) uint8 BGR frame by the src->dst affine ``a23``
    (host (2, 3)) into an (out_h, out_w) window.

    Returns (warped (out_h, out_w, 3) float32, content mask (out_h, out_w)
    float32: the bilinear footprint of the source rectangle, or with
    ``content="nonblack"`` the warp of the source's gray > 2 indicator).
    CUDA frames launch ``csrc/warp_affine.cu`` (counted in
    ``warp_frame.launches``; see :func:`_count_launch`); CPU frames run the
    plain version.
    """
    _check(img_u8, 3, out_h, out_w, content)
    inv = inverse_coeffs(a23)
    if img_u8.device.type == "cpu":
        return warp_frame_plain(img_u8, inv, out_h, out_w, content)
    out = _launch(img_u8.contiguous(), 1, inv, out_h, out_w, content)
    _count_launch(warp_frame, content)
    return out


def warp_frames(frames_u8: torch.Tensor, a23s, out_h: int, out_w: int,
                content: str = "ones"):
    """Warp N same-size (N, H, W, 3) uint8 frames, each by its src->dst
    affine (host (N, 2, 3)), into one (out_h, out_w) window size.

    Returns ((N, out_h, out_w, 3), (N, out_h, out_w)) float32, the mask as
    in :func:`warp_frame`. CUDA frames make ONE launch of
    ``csrc/warp_affine.cu`` with a device table of the N inverse affines
    (counted in ``warp_frames.launches``; see :func:`_count_launch`); CPU
    frames run :func:`warp_frames_plain`.
    """
    _check(frames_u8, 4, out_h, out_w, content)
    a = np.asarray(a23s, np.float32).reshape(-1, 2, 3)
    nf = frames_u8.shape[0]
    if a.shape[0] != nf or not 0 < nf <= _MAX_FRAMES:
        raise ValueError(f"{nf} frames with {a.shape[0]} affines "
                         f"(need 1..{_MAX_FRAMES} of each)")
    invs = [inverse_coeffs(t) for t in a]
    if frames_u8.device.type == "cpu":
        return warp_frames_plain(frames_u8, invs, out_h, out_w, content)
    table = torch.tensor(invs, dtype=torch.float32).to(frames_u8.device)
    out = _launch(frames_u8.contiguous(), nf, table, out_h, out_w, content)
    _count_launch(warp_frames, content)
    return out


def _count_launch(wrapper, content: str) -> None:
    """One kernel launch by ``wrapper`` (its ``launches``); a content-mode
    launch of either wrapper also counts in the one shared
    ``warp_frame.nonblack_launches``."""
    wrapper.launches += 1
    if content == "nonblack":
        warp_frame.nonblack_launches += 1


warp_frame.launches = 0
warp_frame.nonblack_launches = 0
warp_frames.launches = 0
