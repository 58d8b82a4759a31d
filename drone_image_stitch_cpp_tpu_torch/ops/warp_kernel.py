"""K2: bilinear affine warp of BGR frames + their content masks.

Replaces the Pallas TPU kernel ``drone_image_stitch_cpp_tpu/ops/
pallas_warp.py::_kernel`` (launched through ``_run``; entries
``warp_affine`` and ``warp_affine_many``; called four times per compose
feed at ``pipeline/compose_feed.py:92,97``: three channels and the content
mask). The Pallas kernel was a near-identity shift-select approximation
(|linear - I| <= 0.05, errors of a few levels); the CUDA kernel
``csrc/warp_affine.cu`` is the exact per-pixel bilinear gather of
:func:`ops.warp.warp_affine` for ANY affine, and one launch reads N
frames and writes all three float32 channels and the warped content mask
of each (BORDER_CONSTANT 0 outside the source). The mask is the warp of
all-ones (``content="ones"``, the strip compose) or of the source's gray
> 2 indicator (``content="nonblack"``, the global compose:
:func:`ops.color.content_mask`). Frames are uint8 BGR (as decoded),
float32 BGR (area-resized for compositing below full resolution, which the
JAX package warps unquantised) or packed I420 uint8 (a ``yuv420`` frame
store's JPEG planes: (H*3/2, W) a frame, H % 4 == 0, W % 2 == 0), which
the kernel converts exactly as :func:`ops.color.yuv420_to_bgr` converts
the frame (the JAX package feeds its kernel
``yuv420_to_bgr(frame)``). Float32 and I420 frames take
``content="ones"`` only, as no caller of either package warps them in
content mode. An I420 launch takes one of two kernels, as
:func:`i420_plan` decides from the host affines: the staged kernel, which
converts each output tile's source box once in shared memory (the
compose feed), or the per-tap kernel, which converts each tap where it
is read (a downscale such as the seam batch, or a strong rotation).

:func:`warp_frame` (one frame) and :func:`warp_frames` (a batch, as the
JAX package's ``warp_affine_many``) launch the kernel for CUDA tensors and
run the plain versions for CPU tensors; they never fall back from one to
the other. Every launch counts in its wrapper's ``launches``; content-
mode launches also in ``warp_frame.nonblack_launches``, float32-source
launches in ``warp_frame.f32_launches``, I420-source launches in
``warp_frame.i420_launches`` and those of them that took the staged
kernel in ``warp_frame.i420_staged_launches`` (all four shared by the
wrappers).
"""

from __future__ import annotations

import ctypes
import math
import struct

import numpy as np
import torch

from ..runtime.kernels import load_kernel, stream_handle
from .color import content_mask, yuv420_to_bgr
from .warp import bilinear_sample, dst_to_src_coords

KERNEL_SOURCE = "warp_affine.cu"
_HEAD = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p] + [ctypes.c_float] * 6
_TAIL = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]
KERNEL_SIGNATURES = {
    "warp_affine_u8": (ctypes.c_int, _HEAD + [ctypes.c_int] + _TAIL),
    "warp_affine_f32": (ctypes.c_int, _HEAD + _TAIL),
    "warp_affine_i420": (ctypes.c_int,
                         _HEAD + _TAIL[:-1] + [ctypes.c_int] * 3 + _TAIL[-1:]),
}
CONTENT_MODES = ("ones", "nonblack")
SOURCE_DTYPES = (torch.uint8, torch.float32)
_MAX_FRAMES = 65535          # grid.y (grid.z when staged) of one launch
I420_TILE = (24, 128)        # the staged kernel's output tile: rows, columns
I420_SMEM_CAP = 96 * 1024    # larger boxes take the per-tap kernel
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


def _is_i420(frames: torch.Tensor) -> bool:
    """Packed I420 frames end in an even width; BGR frames in their 3
    channels (the shape checks of :func:`_check` hold either way)."""
    return frames.dtype == torch.uint8 and frames.shape[-1] != 3


def _row16(n: int) -> int:
    """Bytes of a staged row of n bytes: whole 16-byte chunks from the
    aligned one holding its first byte."""
    return 16 * ((n + 30) >> 4)


def i420_smem_bytes(box, h: int, w: int) -> int:
    """Dynamic shared memory of the staged I420 kernel for source boxes of
    at most ``box`` = (rows, columns) of an h x w frame, as the kernel's
    ``StagedLayout`` lays it out: planar float32 B, G, R rows padded one
    float every 32, then the Y rows and the U and V rows of the chroma box
    ((box >> 1) + 3 samples each way at most, and the plane)."""
    bh, bw = box
    cbh = min((bh >> 1) + 3, h >> 1)
    cbw = min((bw >> 1) + 3, w >> 1)
    plane = bh * (bw + ((bw - 1) >> 5))
    return (16 * ((12 * plane + 15) >> 4) + bh * _row16(bw)
            + 2 * cbh * _row16(cbw))


def i420_box(invs, h: int, w: int, out_h: int, out_w: int):
    """(rows, columns) that bound the source box of every output tile
    (:data:`I420_TILE`) of every frame, ``invs`` one :func:`inverse_coeffs`
    tuple a frame; None when a coordinate is not finite.

    The kernel's box of a tile is [floor(min s), floor(max s) + 1] along
    each source axis over the tile's corners, clipped to the frame. Its
    size is at most ceil(max s - min s) + 2, and the corners' computed
    spread is at most the exact |a| (tile width - 1) + |b| (tile height -
    1) plus the rounding of each corner's three float32 operations (below
    3 * 2**-24 of |a| x + |b| y + |c|)."""
    th, tw = (min(t, n) - 1 for t, n in zip(I420_TILE, (out_h, out_w)))
    box = [0, 0]
    for inv in invs:
        for i, (a, b, c, n) in enumerate(((inv[3], inv[4], inv[5], h),
                                          (inv[0], inv[1], inv[2], w))):
            err = 2.0 ** -21 * (abs(a) * (out_w - 1) + abs(b) * (out_h - 1)
                                + abs(c))
            spread = abs(a) * tw + abs(b) * th + err
            if not math.isfinite(spread):
                return None
            box[i] = max(box[i], min(math.ceil(spread) + 2, n))
    return tuple(box)


def i420_plan(invs, h: int, w: int, out_h: int, out_w: int):
    """The staged kernel's launch for packed I420 frames of h x w warped by
    ``invs`` into an out_h x out_w window: (box rows, box columns, shared
    memory bytes), or None where that memory would exceed
    :data:`I420_SMEM_CAP` and the launch takes the per-tap kernel (a
    downscale such as the seam batch's, or a strong rotation)."""
    box = i420_box(invs, h, w, out_h, out_w)
    if box is None:
        return None
    smem = i420_smem_bytes(box, h, w)
    return (*box, smem) if smem <= I420_SMEM_CAP else None


def warp_frame_plain(img: torch.Tensor, inv, out_h: int, out_w: int,
                     content: str = "ones"):
    """Plain PyTorch version of K2 for one uint8 or float32 BGR frame, or
    a packed I420 frame (converted by :func:`ops.color.yuv420_to_bgr`
    first), and its :func:`inverse_coeffs`: (warped (out_h, out_w, 3)
    float32, warped content mask (out_h, out_w) float32: the warp of
    all-ones, or with ``content="nonblack"`` of
    :func:`ops.color.content_mask`)."""
    if _is_i420(img):
        img = yuv420_to_bgr(img)
    inv23 = torch.tensor(inv, dtype=torch.float32,
                         device=img.device).reshape(2, 3)
    sx, sy = dst_to_src_coords(inv23, out_h, out_w)
    wimg = bilinear_sample(img.to(torch.float32), sx, sy)
    if content == "nonblack":
        src = content_mask(img).to(torch.float32)
    else:
        src = torch.ones(img.shape[:2], dtype=torch.float32,
                         device=img.device)
    return wimg, bilinear_sample(src, sx, sy)


def warp_frames_plain(frames: torch.Tensor, invs, out_h: int,
                      out_w: int, content: str = "ones"):
    """Plain version of the batched K2: :func:`warp_frame_plain` per frame,
    stacked to ((N, out_h, out_w, 3), (N, out_h, out_w))."""
    outs = [warp_frame_plain(f, inv, out_h, out_w, content)
            for f, inv in zip(frames, invs)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def _launch(src: torch.Tensor, nf: int, invs, out_h: int, out_w: int,
            content: str = "ones", table=None, i420_staged=None):
    """One kernel launch over ``nf`` contiguous frames: (H, W, 3) uint8 or
    float32 BGR, or (H*3/2, W) packed I420 (``src``: one frame, or a batch
    with a leading N); ``invs``: one coefficient tuple (passed by value,
    nf == 1) or a list of nf tuples, read from the device (N, 6) float32
    ``table`` (made here when None). ``i420_staged`` forces the staged
    (True) or the per-tap (False) kernel of an I420 source; None takes
    :func:`i420_plan`'s choice. Returns the warped planes, shaped with
    src's leading dimensions, and whether the staged kernel ran."""
    f32 = src.dtype == torch.float32
    i420 = _is_i420(src)
    name = ("warp_affine_f32" if f32 else
            "warp_affine_i420" if i420 else "warp_affine_u8")
    fn = load_kernel(KERNEL_SOURCE, KERNEL_SIGNATURES).fns[name]
    if i420:
        lead = src.shape[:-2]
        h, w = src.shape[-2] * 2 // 3, src.shape[-1]
        stride = src.shape[-2] * w
    else:
        lead = src.shape[:-3]
        h, w = src.shape[-3], src.shape[-2]
        stride = h * w * 3
    dev = src.device
    wimg = torch.empty(lead + (out_h, out_w, 3), dtype=torch.float32,
                       device=dev)
    mask = torch.empty(lead + (out_h, out_w), dtype=torch.float32,
                       device=dev)
    if isinstance(invs, list):
        if table is None:
            table = torch.tensor(invs, dtype=torch.float32).to(dev)
        ptr, coeffs, frame_invs = table.data_ptr(), (0.0,) * 6, invs
    else:
        ptr, coeffs, frame_invs = None, invs, [invs]
    mode = () if f32 or i420 else (int(content == "nonblack"),)
    plan = None
    if i420 and i420_staged is None:
        plan = i420_plan(frame_invs, h, w, out_h, out_w)
    elif i420 and i420_staged:
        staged_box = i420_box(frame_invs, h, w, out_h, out_w)
        if staged_box is None:
            raise ValueError("no staged box for non-finite coordinates")
        plan = (*staged_box, i420_smem_bytes(staged_box, h, w))
    box = (plan or (0, 0, 0)) if i420 else ()
    with torch.cuda.device(dev):    # <<<>>> binds to the current device
        err = fn(src.data_ptr(), stride, h, w, ptr, *coeffs, *mode,
                 wimg.data_ptr(), mask.data_ptr(), out_h, out_w, nf, *box,
                 stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return wimg, mask, plan is not None


def _check(frames: torch.Tensor, ndim: int, out_h: int, out_w: int,
           content: str):
    """``ndim``: the rank of BGR frames here (3 for one, 4 for a batch);
    packed I420 frames have one dimension less."""
    lead = "" if ndim == 3 else "N, "
    i420 = frames.dtype == torch.uint8 and frames.ndim == ndim - 1
    if i420:
        rows, w = frames.shape[-2], frames.shape[-1]
        if rows % 6 or w % 2 or rows == 0:
            raise ValueError(f"K2's I420 source takes ({lead}H*3/2, W) uint8 "
                             f"frames with H % 4 == 0 and W % 2 == 0, got "
                             f"{tuple(frames.shape)}")
    elif frames.dtype not in SOURCE_DTYPES or frames.ndim != ndim \
            or frames.shape[-1] != 3:
        raise ValueError(f"K2 takes ({lead}H, W, 3) uint8 or float32 BGR or "
                         f"({lead}H*3/2, W) uint8 I420 frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"empty output window {out_h}x{out_w}")
    if content not in CONTENT_MODES:
        raise ValueError(f"content must be one of {CONTENT_MODES}, got "
                         f"{content!r}")
    if content != "ones" and (frames.dtype == torch.float32 or i420):
        raise ValueError(f"content={content!r} takes uint8 BGR frames; "
                         f"float32 and I420 frames warp with "
                         f"content='ones' only")
    if frames.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {frames.device}")


def warp_frame(img: torch.Tensor, a23, out_h: int, out_w: int,
               content: str = "ones"):
    """Warp an (H, W, 3) uint8 or float32 BGR frame, or an (H*3/2, W)
    packed I420 frame, by the src->dst affine ``a23`` (host (2, 3)) into
    an (out_h, out_w) window.

    Returns (warped (out_h, out_w, 3) float32, content mask (out_h, out_w)
    float32: the bilinear footprint of the source rectangle, or with
    ``content="nonblack"`` the warp of the source's gray > 2 indicator).
    CUDA frames launch ``csrc/warp_affine.cu`` (counted in
    ``warp_frame.launches``; see :func:`_count_launch`); CPU frames run the
    plain version.
    """
    _check(img, 3, out_h, out_w, content)
    inv = inverse_coeffs(a23)
    if img.device.type == "cpu":
        return warp_frame_plain(img, inv, out_h, out_w, content)
    wimg, mask, staged = _launch(img.contiguous(), 1, inv, out_h, out_w,
                                 content)
    _count_launch(warp_frame, content, img, staged)
    return wimg, mask


def warp_frames(frames: torch.Tensor, a23s, out_h: int, out_w: int,
                content: str = "ones"):
    """Warp N same-size frames ((N, H, W, 3) uint8 or float32 BGR, or
    (N, H*3/2, W) packed I420), each by its src->dst affine (host
    (N, 2, 3)), into one (out_h, out_w) window size.

    Returns ((N, out_h, out_w, 3), (N, out_h, out_w)) float32, the mask as
    in :func:`warp_frame`. CUDA frames make ONE launch of
    ``csrc/warp_affine.cu`` with a device table of the N inverse affines
    (counted in ``warp_frames.launches``; see :func:`_count_launch`); CPU
    frames run :func:`warp_frames_plain`.
    """
    _check(frames, 4, out_h, out_w, content)
    a = np.asarray(a23s, np.float32).reshape(-1, 2, 3)
    nf = frames.shape[0]
    if a.shape[0] != nf or not 0 < nf <= _MAX_FRAMES:
        raise ValueError(f"{nf} frames with {a.shape[0]} affines "
                         f"(need 1..{_MAX_FRAMES} of each)")
    invs = [inverse_coeffs(t) for t in a]
    if frames.device.type == "cpu":
        return warp_frames_plain(frames, invs, out_h, out_w, content)
    wimg, mask, staged = _launch(frames.contiguous(), nf, invs, out_h,
                                 out_w, content)
    _count_launch(warp_frames, content, frames, staged)
    return wimg, mask


def _count_launch(wrapper, content: str, src: torch.Tensor,
                  staged: bool) -> None:
    """One kernel launch by ``wrapper`` (its ``launches``); a content-mode
    launch of either wrapper also counts in the one shared
    ``warp_frame.nonblack_launches``, a float32-source launch in the one
    shared ``warp_frame.f32_launches``, an I420-source launch in the one
    shared ``warp_frame.i420_launches`` and, when it took the staged
    kernel, in ``warp_frame.i420_staged_launches``."""
    wrapper.launches += 1
    if content == "nonblack":
        warp_frame.nonblack_launches += 1
    if src.dtype == torch.float32:
        warp_frame.f32_launches += 1
    if _is_i420(src):
        warp_frame.i420_launches += 1
    if staged:
        warp_frame.i420_staged_launches += 1


warp_frame.launches = 0
warp_frame.nonblack_launches = 0
warp_frame.f32_launches = 0
warp_frame.i420_launches = 0
warp_frame.i420_staged_launches = 0
warp_frames.launches = 0
