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
content mode. The uint8, float32 and per-tap I420 sources share one
gather kernel, whose blocks each take a :data:`TILE` output tile and
pick its route (:data:`ROUTES`) from the tile's corners: zero (no tap in
the frame: the tile's zeros and nothing else, most of a seam batch) or
direct (per-tap loads); an I420 pixel's four taps share their quad's
chroma samples. An I420 launch takes one of
two kernels, as :func:`i420_plan` decides from the host affines: the
staged kernel, which converts each output tile's source box once in
shared memory (the compose feed), or the gather kernel, which converts
each tap where it is read (a downscale such as the seam batch, or a
strong rotation).

:func:`warp_frame` (one frame) and :func:`warp_frames` (a batch, as the
JAX package's ``warp_affine_many``) share one body: it launches the
kernel for CUDA tensors and runs the plain versions for CPU tensors, and
never falls back from one to the other. Every launch takes its frames'
dst->src coefficients from one call of the kernel library's host inverse
(:func:`host_inverse_coeffs`), whatever the batch, which raises on a
singular affine before anything is launched; it passes up to
:data:`BY_VALUE_MAX` frames' coefficients by value, in the kernel's
parameters, and a device table only above that, so it copies nothing to
the card. :func:`warp_planes` warps single float32 planes with no mask
(the JAX package's ``warp_affine_traced`` and ``warp_affine_many``: the
throughput benchmark's 4K gray warps); its kernel takes the src->dst
affines (a tensor where it lies, read through its strides, or host
affines by value) and inverts them itself (``csrc/affine_inverse.cuh``),
so a model computed on the card reaches the kernel with no host round
trip and a call is one launch; its launches count in
``warp_planes.launches`` alone. Every launch counts in its wrapper's
``launches``; content-mode launches also in
``warp_frame.nonblack_launches``, float32-source launches in
``warp_frame.f32_launches``, I420-source launches in
``warp_frame.i420_launches`` and those of them that took the staged
kernel in ``warp_frame.i420_staged_launches`` (all four shared by the
wrappers).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..runtime.kernels import load_kernel, stream_handle
from .color import content_mask, yuv420_to_bgr
from .warp import bilinear_sample, dst_to_src_coords

KERNEL_SOURCE = "warp_affine.cu"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# src, its stride, h, w, device table, host coefficient sets
_HEAD = [_P, _LL, _I, _I, _P, _P]
# out, mask, out_h, out_w, n
_OUT = [_P, _P, _I, _I, _I]
KERNEL_SIGNATURES = {
    # ... content, out .. n, tile counts, stream
    "warp_affine_u8": (_I, _HEAD + [_I] + _OUT + [_P, _P]),
    # ... out .. n, tile counts, stream
    "warp_affine_f32": (_I, _HEAD + _OUT + [_P, _P]),
    # ... out .. n, box rows, box columns, shared memory, tile counts, stream
    "warp_affine_i420": (_I, _HEAD + _OUT + [_I] * 3 + [_P, _P]),
    # src, stride, h, w, device affines and their 3 strides, host affines,
    # out, out_h, out_w, n, direct, staged-tile count, stream
    "warp_affine_plane_f32": (_I, [_P, _LL, _I, _I, _P, _LL, _LL, _LL, _P,
                                   _P, _I, _I, _I, _I, _P, _P]),
    "affine_inverse_f32": (_I, [_P, _P, _I, _P]),
    "affine_inverse_f32_host": (_I, [_P, _P, _I]),
}
CONTENT_MODES = ("ones", "nonblack")
SOURCE_DTYPES = (torch.uint8, torch.float32)
_MAX_FRAMES = 65535          # grid.y (grid.z when staged) of one launch
BY_VALUE_MAX = 160           # coefficient sets a launch passes by value
TILE = (8, 128)              # the gather kernel's output tile (rows,
I420_TILE = (24, 128)        # columns), and the staged I420 kernel's
I420_SMEM_CAP = 96 * 1024    # larger boxes take the per-tap kernel
ROUTES = ("zero", "direct")  # the gather kernel's tile counts
PLANE_TILE = (32, 128)       # the single-plane kernel's output tile


def _lu_inverse(a23s: torch.Tensor):
    """:func:`device_inverse_coeffs`' table and each affine's second pivot
    u (float64 holding a float32 value), which the singular test of
    :func:`_checked_inverse` reads."""
    a = a23s.reshape(-1, 2, 3).to(torch.float32).to(torch.float64)

    def r32(v):
        return v.to(torch.float32).to(torch.float64)

    (a_, b_, tx), (c_, d_, ty) = a[:, 0].unbind(-1), a[:, 1].unbind(-1)
    swap = c_.abs() > a_.abs()
    p, q = torch.where(swap, c_, a_), torch.where(swap, d_, b_)
    r, s = torch.where(swap, a_, c_), torch.where(swap, b_, d_)
    rp = r32(torch.reciprocal(p))
    low = r32(r * rp)
    u = r32(s - r32(low * q))
    ru = r32(torch.reciprocal(u))
    sw = swap.to(torch.float64)
    cols = []
    for y1, y2 in ((1.0 - sw, sw), (sw, 1.0 - sw)):   # columns e1, e2
        x2 = r32(r32(y2 - r32(low * y1)) * ru)
        cols.append((r32(r32(y1 - q * x2) * rp), x2))
    (i00, i10), (i01, i11) = cols
    return torch.stack([i00, i01, -r32(i01 * ty + r32(i00 * tx)),
                        i10, i11, -r32(i11 * ty + r32(i10 * tx))],
                       dim=-1).to(torch.float32), u


def device_inverse_coeffs(a23s: torch.Tensor) -> torch.Tensor:
    """(N, 6) float32 table of the dst->src coefficients (i00, i01, i02,
    i10, i11, i12) of (N, 2, 3) src->dst affines, computed where ``a23s``
    lies, with no host round trip (``torch.linalg.inv`` on a card checks
    its result on the host): the plain version of the kernels' own inverse
    (``csrc/affine_inverse.cuh``, reached through
    :func:`kernel_inverse_coeffs` and :func:`host_inverse_coeffs`), and
    the Python definition of it that every other one is held to.

    A float32 LU solve with partial pivoting in the operation order of the
    JAX package's ``ops/transform.invert_affine`` on the CPU (pivot
    reciprocals, fused back substitution and translation), so the
    coefficients equal JAX's bit for bit. Each step is taken in float64
    from float32 values and rounded to float32, which gives the float32
    result of a basic operation; ``a * b + c`` of float32 values rounded
    once is the fused multiply-add (the product is exact in float64). It
    raises nothing, which on a card would take a sync: a singular affine's
    row is what the arithmetic gives (:func:`inverse_coeffs` raises)."""
    return _lu_inverse(a23s)[0]


def _checked_inverse(a23s) -> torch.Tensor:
    """:func:`device_inverse_coeffs` of host src->dst affines (N x 6
    floats, any shape), on the CPU, raising ValueError on the first
    singular one: a zero pivot or a second pivot u that is zero or not
    finite (a zero pivot makes u NaN). An affine whose inverse merely
    overflows passes with its coefficients that are not finite."""
    a = torch.tensor(np.asarray(a23s, np.float32)).reshape(-1, 2, 3)
    table, u = _lu_inverse(a)
    bad = torch.nonzero(~(torch.isfinite(u) & (u != 0)))
    if len(bad):
        raise ValueError(f"affine {a[bad[0, 0]].tolist()} is singular")
    return table


def inverse_coeffs(a23) -> tuple:
    """dst->src coefficients (i00, i01, i02, i10, i11, i12) of a src->dst
    (2, 3) affine, as Python floats holding float32 values: its row of
    :func:`device_inverse_coeffs`, which the kernel and the plain version
    both take, so they sample the same coordinates. Raises ValueError on a
    singular affine (:func:`_checked_inverse`)."""
    return tuple(_checked_inverse(
        np.asarray(a23, np.float32).reshape(1, 2, 3))[0].tolist())


_FNS = {}


def _fns() -> dict:
    """The kernel library's typed C entries, resolved at the first call."""
    if not _FNS:
        _FNS.update(load_kernel(KERNEL_SOURCE, KERNEL_SIGNATURES).fns)
    return _FNS


def _call(name: str, dev: torch.device, *args) -> None:
    """Entry ``name`` of the kernel library with ``args`` and the current
    stream of ``dev``, on ``dev`` (a ``<<<>>>`` launch binds to the current
    device; switched only when it is another). Raises when the entry
    returns a CUDA error."""
    fn = _fns()[name]
    if dev.index == torch._C._cuda_getDevice():
        err = fn(*args, stream_handle(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream_handle(dev))
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def host_inverse_coeffs(a23s) -> np.ndarray:
    """(N, 6) float32 dst->src coefficients of N src->dst (2, 3) affines,
    row for row bit-equal to :func:`inverse_coeffs`: one call of the host
    entry of K2's kernel library (``affine_inverse_f32_host``, the host
    path of ``csrc/affine_inverse.cuh``), whatever N. Every uint8, float32
    and I420 launch takes its coefficients from it. Raises as
    :func:`inverse_coeffs` does on a singular affine among the rows that
    the entry counts as not finite (a second pivot that overflows to an
    infinity leaves its row finite, with a zero second row, and passes)."""
    a = np.ascontiguousarray(a23s, np.float32)
    k = a.size
    if k == 0 or k % 6:
        raise ValueError(f"affines must be (N, 2, 3), got shape {a.shape}")
    # ctypes arrays, not numpy's .ctypes, keep a call to a few microseconds
    out = (ctypes.c_float * k)()
    bad = _fns()["affine_inverse_f32_host"](
        (ctypes.c_float * k).from_buffer_copy(a), out, k // 6)
    sets = np.frombuffer(out, np.float32).reshape(-1, 6)
    if bad:
        _checked_inverse(a.reshape(-1, 6)[~np.isfinite(sets).all(axis=1)])
    return sets


def kernel_inverse_coeffs(a23s: torch.Tensor) -> torch.Tensor:
    """The single-plane kernel's in-kernel inverse on its own: (N, 6)
    float32 dst->src coefficients of (N, 2, 3) src->dst affines. A CUDA
    tensor launches ``affine_inverse_f32`` (csrc/affine_inverse.cuh, one
    thread an affine; not counted, as no path of the port calls it); a
    CPU tensor runs its plain version, :func:`device_inverse_coeffs`."""
    a = a23s.reshape(-1, 2, 3).to(torch.float32)
    if a.device.type == "cpu":
        return device_inverse_coeffs(a)
    a = a.contiguous()
    out = torch.empty((a.shape[0], 6), dtype=torch.float32, device=a.device)
    _call("affine_inverse_f32", a.device, a.data_ptr(), out.data_ptr(),
          a.shape[0])
    return out


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


def _launch(src: torch.Tensor, nf: int, sets, out_h: int, out_w: int,
            content: str = "ones", table=None, i420_staged=None,
            tiles: torch.Tensor = None):
    """One kernel launch over ``nf`` contiguous frames: (H, W, 3) uint8 or
    float32 BGR, or (H*3/2, W) packed I420 (``src``: one frame, or a batch
    with a leading N); ``sets``: their nf dst->src coefficient sets of six
    floats (a tuple when nf == 1, a list of tuples, or an (nf, 6) float32
    array such as :func:`host_inverse_coeffs` gives), passed by value up
    to :data:`BY_VALUE_MAX` of them, else read from the device (N, 6)
    float32 ``table`` (made here, by a pageable copy, when None; given, it
    is read at any N).
    ``i420_staged`` forces the staged (True) or the per-tap gather (False)
    kernel of an I420 source; None takes :func:`i420_plan`'s choice.
    ``tiles``: a card int32 tensor of 2 to which the gather kernel adds
    its zero and direct tiles (:data:`ROUTES`).
    Returns the warped planes (one allocation: BGR, then the mask from a
    16-byte boundary), shaped with src's leading dimensions, and whether
    the staged I420 kernel ran."""
    shape, dtype = src.shape, src.dtype
    f32 = dtype == torch.float32
    i420 = dtype == torch.uint8 and shape[-1] != 3      # _is_i420
    if i420:
        lead = shape[:-2]
        h, w = shape[-2] * 2 // 3, shape[-1]
        stride = shape[-2] * w
    else:
        lead = shape[:-3]
        h, w = shape[-3], shape[-2]
        stride = h * w * 3
    dev = src.device
    px = out_h * out_w
    off = (3 * nf * px + 3) & ~3
    buf = torch.empty(off + nf * px, dtype=torch.float32, device=dev)
    wimg = buf.as_strided(lead + (out_h, out_w, 3),
                          (3 * px, 3 * out_w, 3, 1)[-3 - len(lead):])
    mask = buf.as_strided(lead + (out_h, out_w), (px, out_w, 1)[-2 - len(
        lead):], off)
    sets = (ctypes.c_float * (6 * nf)).from_buffer_copy(
        np.ascontiguousarray(sets, np.float32))
    if table is None and nf > BY_VALUE_MAX:
        table = torch.frombuffer(sets, dtype=torch.float32).to(dev)
    ptr = table.data_ptr() if table is not None else None
    host = sets if table is None else None
    counter = tiles.data_ptr() if tiles is not None else None
    out = (wimg.data_ptr(), mask.data_ptr(), out_h, out_w, nf)
    if i420:
        frame_invs = np.frombuffer(sets, np.float32).reshape(
            -1, 6).tolist()                          # Python floats
        plan = None
        if i420_staged is None:
            plan = i420_plan(frame_invs, h, w, out_h, out_w)
        elif i420_staged:
            staged_box = i420_box(frame_invs, h, w, out_h, out_w)
            if staged_box is None:
                raise ValueError("no staged box for non-finite coordinates")
            plan = (*staged_box, i420_smem_bytes(staged_box, h, w))
        _call("warp_affine_i420", dev, src.data_ptr(), stride, h, w, ptr,
              host, *out, *(plan or (0, 0, 0)), counter)
        return wimg, mask, plan is not None
    if f32:
        _call("warp_affine_f32", dev, src.data_ptr(), stride, h, w, ptr,
              host, *out, counter)
    else:
        _call("warp_affine_u8", dev, src.data_ptr(), stride, h, w, ptr,
              host, int(content == "nonblack"), *out, counter)
    return wimg, mask, False


def _check(frames: torch.Tensor, ndim: int, out_h: int, out_w: int,
           content: str):
    """``ndim``: the rank of BGR frames here (3 for one, 4 for a batch);
    packed I420 frames have one dimension less."""
    lead = "" if ndim == 3 else "N, "
    shape, dtype = frames.shape, frames.dtype
    i420 = dtype == torch.uint8 and len(shape) == ndim - 1
    if i420:
        rows, w = shape[-2], shape[-1]
        if rows % 6 or w % 2 or rows == 0:
            raise ValueError(f"K2's I420 source takes ({lead}H*3/2, W) uint8 "
                             f"frames with H % 4 == 0 and W % 2 == 0, got "
                             f"{tuple(shape)}")
    elif dtype not in SOURCE_DTYPES or len(shape) != ndim \
            or shape[-1] != 3:
        raise ValueError(f"K2 takes ({lead}H, W, 3) uint8 or float32 BGR or "
                         f"({lead}H*3/2, W) uint8 I420 frames, got "
                         f"{tuple(shape)} {dtype}")
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"empty output window {out_h}x{out_w}")
    if content not in CONTENT_MODES:
        raise ValueError(f"content must be one of {CONTENT_MODES}, got "
                         f"{content!r}")
    if content != "ones" and (dtype == torch.float32 or i420):
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
    ``warp_frame.launches``; see :func:`_warp`); CPU frames run the plain
    version.
    """
    _check(img, 3, out_h, out_w, content)
    return _warp(warp_frame, img, np.asarray(a23, np.float32).reshape(
        1, 2, 3), out_h, out_w, content)


def warp_frames(frames: torch.Tensor, a23s, out_h: int, out_w: int,
                content: str = "ones"):
    """Warp N same-size frames ((N, H, W, 3) uint8 or float32 BGR, or
    (N, H*3/2, W) packed I420), each by its src->dst affine (host
    (N, 2, 3)), into one (out_h, out_w) window size.

    Returns ((N, out_h, out_w, 3), (N, out_h, out_w)) float32, the mask as
    in :func:`warp_frame`. CUDA frames make ONE launch of
    ``csrc/warp_affine.cu`` (counted in ``warp_frames.launches``; see
    :func:`_warp`); CPU frames run :func:`warp_frames_plain`.
    """
    _check(frames, 4, out_h, out_w, content)
    a = np.asarray(a23s, np.float32).reshape(-1, 2, 3)
    nf = frames.shape[0]
    if a.shape[0] != nf or not 0 < nf <= _MAX_FRAMES:
        raise ValueError(f"{nf} frames with {a.shape[0]} affines "
                         f"(need 1..{_MAX_FRAMES} of each)")
    return _warp(warp_frames, frames, a, out_h, out_w, content)


def _warp(wrapper, src: torch.Tensor, a23s: np.ndarray, out_h: int,
          out_w: int, content: str):
    """The body of :func:`warp_frame` (``src`` one frame) and
    :func:`warp_frames` (a batch), ``a23s`` their (N, 2, 3) float32
    src->dst affines. Either raises on a singular affine before it warps
    anything (on a card as :func:`host_inverse_coeffs` does). A CPU
    ``src`` runs the plain version on one
    :func:`device_inverse_coeffs` table. A CUDA ``src`` takes ONE launch
    of the N sets of :func:`host_inverse_coeffs` (in the kernel's
    parameters up to :data:`BY_VALUE_MAX` frames, else a device table),
    counted in ``wrapper.launches``; a content-mode launch of either
    wrapper also counts in the one shared ``warp_frame.nonblack_launches``,
    a float32-source launch in ``warp_frame.f32_launches``, an I420-source
    launch in ``warp_frame.i420_launches`` and, when it took the staged
    kernel, in ``warp_frame.i420_staged_launches``."""
    if src.device.type == "cpu":
        invs = _checked_inverse(a23s).tolist()
        if wrapper is warp_frame:
            return warp_frame_plain(src, invs[0], out_h, out_w, content)
        return warp_frames_plain(src, invs, out_h, out_w, content)
    wimg, mask, staged = _launch(src.contiguous(), len(a23s),
                                 host_inverse_coeffs(a23s), out_h, out_w,
                                 content)
    wrapper.launches += 1
    if content == "nonblack":
        warp_frame.nonblack_launches += 1
    if src.dtype == torch.float32:
        warp_frame.f32_launches += 1
    if _is_i420(src):
        warp_frame.i420_launches += 1
    if staged:
        warp_frame.i420_staged_launches += 1
    return wimg, mask


warp_frame.launches = 0
warp_frame.nonblack_launches = 0
warp_frame.f32_launches = 0
warp_frame.i420_launches = 0
warp_frame.i420_staged_launches = 0
warp_frames.launches = 0


def warp_planes_plain(frames: torch.Tensor, table: torch.Tensor,
                      out_h: int, out_w: int) -> torch.Tensor:
    """Plain version of K2's single-plane form: frame n of the (N, H, W)
    float32 ``frames`` warped by row n of the (N, 6) coefficient ``table``
    (:func:`inverse_coeffs` / :func:`device_inverse_coeffs`), read on the
    frames' device: (N, out_h, out_w) float32, constant-0 border."""
    outs = []
    for n, f in enumerate(frames):
        sx, sy = dst_to_src_coords(table[n].reshape(2, 3), out_h, out_w)
        outs.append(bilinear_sample(f, sx, sy))
    return torch.stack(outs)


def _launch_planes(src: torch.Tensor, a23s, out_h: int, out_w: int,
                   direct: bool = False,
                   staged_tiles: torch.Tensor = None) -> torch.Tensor:
    """One launch of the single-plane kernel over the contiguous (N, H, W)
    float32 ``src``: ``a23s`` the src->dst affines, a float32 (N, 2, 3)
    tensor on src's card (read through its strides) or a host (N, 2, 3)
    float32 array of at most :data:`BY_VALUE_MAX` (passed by value); the
    kernel inverts them. ``direct`` keeps every tile on the direct gather
    (by default a tile whose source box fits the block's shared memory
    stages it: the faster route on the card); ``staged_tiles``, a card
    int32 scalar, adds the tiles that staged."""
    n, h, w = src.shape
    out = torch.empty((n, out_h, out_w), dtype=torch.float32,
                      device=src.device)
    if isinstance(a23s, torch.Tensor):
        dev_a, strides, host = a23s.data_ptr(), a23s.stride(), None
    else:
        dev_a, strides, host = None, (0, 0, 0), a23s.ctypes.data
    counter = None if staged_tiles is None else staged_tiles.data_ptr()
    _call("warp_affine_plane_f32", src.device, src.data_ptr(), h * w, h, w,
          dev_a, *strides, host, out.data_ptr(), out_h, out_w, n,
          int(direct), counter)
    return out


def warp_planes(frames: torch.Tensor, a23s, out_h: int,
                out_w: int) -> torch.Tensor:
    """Warp N single float32 planes ((N, H, W)), each by its src->dst
    affine, into one (out_h, out_w) window: (N, out_h, out_w) float32,
    constant-0 border, no mask. The JAX package's ``warp_affine_traced``
    (one plane, a traced transform; ``bench.py:111``) and
    ``warp_affine_many`` (a batch, host transforms).

    ``a23s``: a (N, 2, 3) tensor or a host (N, 2, 3) array of src->dst
    affines. CUDA frames make ONE launch of ``csrc/warp_affine.cu``'s
    ``warp_affine_plane_f32`` (counted in ``warp_planes.launches``), which
    inverts each affine in the kernel, bit-equal to
    :func:`inverse_coeffs`: a float32 tensor on the frames' card is read
    where it lies, through its strides (a model computed on the card never
    comes to the host, and nothing else is launched); host affines go by
    value (through a device copy above :data:`BY_VALUE_MAX`). CPU frames
    run :func:`warp_planes_plain` on :func:`device_inverse_coeffs` of the
    affines (which raises on a singular one only from a host array, as
    :func:`inverse_coeffs` does).
    """
    if frames.dtype != torch.float32 or frames.ndim != 3:
        raise ValueError(f"warp_planes takes (N, H, W) float32 planes, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"empty output window {out_h}x{out_w}")
    dev = frames.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    nf = frames.shape[0]
    if isinstance(a23s, torch.Tensor):
        if a23s.ndim != 3 or tuple(a23s.shape[1:]) != (2, 3):
            raise ValueError(f"a23s must be (N, 2, 3), got "
                             f"{tuple(a23s.shape)}")
    else:
        a23s = np.ascontiguousarray(a23s, np.float32).reshape(-1, 2, 3)
    na = a23s.shape[0]
    if na != nf or not 0 < nf <= _MAX_FRAMES:
        raise ValueError(f"{nf} planes with {na} affines (need "
                         f"1..{_MAX_FRAMES} of each)")
    if dev.type == "cpu":
        table = (device_inverse_coeffs(a23s.to(dev))
                 if isinstance(a23s, torch.Tensor) else _checked_inverse(a23s))
        return warp_planes_plain(frames, table, out_h, out_w)
    if isinstance(a23s, torch.Tensor):
        a23s = a23s.to(dev, torch.float32)      # no copy when it is already
    elif nf > BY_VALUE_MAX:
        a23s = torch.from_numpy(a23s).to(dev)
    out = _launch_planes(frames.contiguous(), a23s, out_h, out_w)
    warp_planes.launches += 1
    return out


warp_planes.launches = 0
