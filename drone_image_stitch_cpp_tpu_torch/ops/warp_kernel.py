"""K2: bilinear affine warp of a uint8 BGR frame + its content mask.

Replaces the Pallas TPU kernel ``drone_image_stitch_cpp_tpu/ops/
pallas_warp.py::_kernel`` (launched through ``_run``; called four times
per compose feed at ``pipeline/compose_feed.py:92,97``: three channels and
the content mask). The Pallas kernel was a near-identity shift-select
approximation (|linear - I| <= 0.05, errors of a few levels); the CUDA
kernel ``csrc/warp_affine.cu`` is the exact per-pixel bilinear gather of
:func:`ops.warp.warp_affine` for ANY affine, and one launch reads the
uint8 frame and writes all three float32 channels and the warped
all-ones content mask (BORDER_CONSTANT 0 outside the source).

:func:`warp_frame` launches the kernel for CUDA tensors and runs
:func:`warp_frame_plain` for CPU tensors; it never falls back from one to
the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .transform import invert_affine
from .warp import bilinear_sample, dst_to_src_coords


def inverse_coeffs(a23) -> torch.Tensor:
    """dst->src (2, 3) float32 coefficients of a src->dst affine, computed
    once on the host so the kernel and the plain version share them."""
    a = torch.as_tensor(np.asarray(a23, np.float32).reshape(2, 3))
    return invert_affine(a)


def warp_frame_plain(img_u8: torch.Tensor, inv23: torch.Tensor,
                     out_h: int, out_w: int):
    """Plain PyTorch version of K2: (warped (out_h, out_w, 3) float32,
    warped content mask (out_h, out_w) float32)."""
    inv = inv23.to(img_u8.device)
    sx, sy = dst_to_src_coords(inv, out_h, out_w)
    wimg = bilinear_sample(img_u8.to(torch.float32), sx, sy)
    ones = torch.ones(img_u8.shape[:2], dtype=torch.float32,
                      device=img_u8.device)
    return wimg, bilinear_sample(ones, sx, sy)


def _launch(img_u8: torch.Tensor, inv23: torch.Tensor, out_h: int,
            out_w: int):
    from ..runtime.kernels import load_kernel

    lib = load_kernel("warp_affine.cu").lib
    fn = lib.warp_affine_u8
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_float] * 6
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    h, w = img_u8.shape[0], img_u8.shape[1]
    dev = img_u8.device
    wimg = torch.empty((out_h, out_w, 3), dtype=torch.float32, device=dev)
    mask = torch.empty((out_h, out_w), dtype=torch.float32, device=dev)
    c = [float(v) for v in inv23.reshape(-1).tolist()]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(img_u8.data_ptr(), h, w, *c, wimg.data_ptr(), mask.data_ptr(),
             out_h, out_w, stream)
    if err != 0:
        raise RuntimeError(f"warp_affine_u8 launch failed: cudaError {err}")
    return wimg, mask


def warp_frame(img_u8: torch.Tensor, a23, out_h: int, out_w: int):
    """Warp an (H, W, 3) uint8 BGR frame by the src->dst affine ``a23``
    (host (2, 3)) into an (out_h, out_w) window.

    Returns (warped (out_h, out_w, 3) float32, content mask (out_h, out_w)
    float32: the bilinear footprint of the source rectangle). CUDA frames
    launch ``csrc/warp_affine.cu`` (counted in ``warp_frame.launches``);
    CPU frames run the plain version.
    """
    if img_u8.dtype != torch.uint8 or img_u8.ndim != 3 \
            or img_u8.shape[2] != 3:
        raise ValueError("warp_frame takes an (H, W, 3) uint8 frame, got "
                         f"{tuple(img_u8.shape)} {img_u8.dtype}")
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"empty output window {out_h}x{out_w}")
    inv = inverse_coeffs(a23)
    if img_u8.device.type == "cuda":
        out = _launch(img_u8.contiguous(), inv, out_h, out_w)
        warp_frame.launches += 1
        return out
    if img_u8.device.type == "cpu":
        return warp_frame_plain(img_u8, inv, out_h, out_w)
    raise ValueError(f"unsupported device {img_u8.device}")


warp_frame.launches = 0
