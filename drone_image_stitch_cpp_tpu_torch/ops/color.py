"""Color-space and radiometric elementwise ops.

Port of ``drone_image_stitch_cpp_tpu/ops/color.py``. Images are float32
in [0, 255], layout (..., H, W, 3) channel-last BGR, as in the JAX
package, so both packages compare like with like. Packed I420 frames are
(..., H*3/2, W) uint8: the Y plane (H rows), then U and then V, each an
(H/2, W/2) plane raveled into H/4 rows of width W (libjpeg's and cv2's
I420 layout; H % 4 == 0, W % 2 == 0).
"""

from __future__ import annotations

import torch

# OpenCV BT.601: gray = 0.299 R + 0.587 G + 0.114 B; channel order is BGR.
_BGR_WEIGHTS = (0.114, 0.587, 0.299)


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR -> (..., H, W) luma, same scale as input."""
    w = torch.tensor(_BGR_WEIGHTS, dtype=torch.float32, device=img.device)
    return img.to(torch.float32) @ w


def apply_channel_gains(img: torch.Tensor, gains: torch.Tensor
                        ) -> torch.Tensor:
    """Multiply (..., H, W, C) by per-channel gains (..., C), clip to
    [0, 255] (applyChannelGainInPlace, stitch_global.cpp:291-305)."""
    out = img.to(torch.float32) * gains[..., None, None, :]
    return out.clamp(0.0, 255.0)


def nonblack_mask(img: torch.Tensor, thresh: float = 2.0) -> torch.Tensor:
    """Bool (..., H, W): gray level above ``thresh`` (stitch_global.cpp:
    109-117 uses > 2 for content masks, stitch_common.cpp:9 > 1)."""
    gray = bgr_to_gray(img) if img.shape[-1] == 3 else img
    return gray > thresh


def content_mask(img: torch.Tensor) -> torch.Tensor:
    """Bool (..., H, W): BT.601 gray of (..., H, W, 3) BGR above 2, the
    strip content test of the global stage (stitch_global.cpp:109-117),
    evaluated as ((b * 0.114) + (g * 0.587)) + (r * 0.299) in float32
    with every product and sum rounded. K2's content mode computes the
    same expression bit for bit (csrc/warp_affine.cu); on 8-bit pixels it
    decides as ``nonblack_mask(img, 2.0)`` does."""
    x = img.to(torch.float32)
    wb, wg, wr = (torch.tensor(v, dtype=torch.float32, device=x.device)
                  for v in _BGR_WEIGHTS)
    gray = (x[..., 0] * wb + x[..., 1] * wg) + x[..., 2] * wr
    return gray > 2.0


def yuv420_luma(packed: torch.Tensor) -> torch.Tensor:
    """Y plane of packed I420 frames: (..., H*3/2, W) -> (..., H, W)
    float32. A JPEG's Y is the full-range BT.601 luma that
    :func:`bgr_to_gray` computes, so detect reads it directly."""
    h = packed.shape[-2] * 2 // 3
    return packed[..., :h, :].to(torch.float32)


def _fancy_up2(c: torch.Tensor, dim: int) -> torch.Tensor:
    """2x chroma upsample along ``dim`` with libjpeg's triangle filter
    (h2v2 fancy upsampling): out[2i] = 0.75 c[i] + 0.25 c[i-1],
    out[2i+1] = 0.75 c[i] + 0.25 c[i+1], edges replicated."""
    c = c.movedim(dim, -1)
    prev = torch.cat([c[..., :1], c[..., :-1]], dim=-1)
    nxt = torch.cat([c[..., 1:], c[..., -1:]], dim=-1)
    even = 0.75 * c + 0.25 * prev
    odd = 0.75 * c + 0.25 * nxt
    out = torch.stack([even, odd], dim=-1).reshape(*c.shape[:-1],
                                                   2 * c.shape[-1])
    return out.movedim(-1, dim)


def yuv420_to_bgr(packed: torch.Tensor) -> torch.Tensor:
    """Packed I420 (..., H*3/2, W) uint8 -> (..., H, W, 3) BGR float32.

    Chroma is upsampled as libjpeg's fancy (triangle) filter does, along
    W and then along H, and converted with the full-range JFIF BT.601
    matrix of libjpeg's YCbCr->RGB, each product and sum rounded to
    float32 in the JAX package's order. This is also the plain version of
    K2's I420 source (``ops/warp_kernel``), which computes every tap's
    BGR with the same operations."""
    h = packed.shape[-2] * 2 // 3
    w = packed.shape[-1]
    lead = packed.shape[:-2]
    y = packed[..., :h, :].to(torch.float32)
    u = packed[..., h:h + h // 4, :].reshape(*lead, h // 2, w // 2)
    v = packed[..., h + h // 4:, :].reshape(*lead, h // 2, w // 2)
    u = _fancy_up2(_fancy_up2(u.to(torch.float32), -1), -2) - 128.0
    v = _fancy_up2(_fancy_up2(v.to(torch.float32), -1), -2) - 128.0
    r = y + 1.402 * v
    g = y - 0.344136286 * u - 0.714136286 * v
    b = y + 1.772 * u
    return torch.stack([b, g, r], dim=-1).clamp(0.0, 255.0)


def bgr_to_yuv420(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) BGR uint8/float32 -> packed I420 (H*3/2, W) uint8;
    H % 4 == 0, W % 2 == 0.

    The video-range BT.601 matrix (Y in [16, 235]) with 2x2-mean chroma,
    the exact inverse of ``cv2.COLOR_YUV2BGR_I420``, which unpacks the
    tiled compose's packed fetch on the host (``ops/blend.
    mb_compose_tiled(fetch_packed=True)``). Not the ingest direction,
    whose peer is libjpeg's full-range JFIF math (:func:`yuv420_to_bgr`).
    """
    h, w = img.shape[0], img.shape[1]
    if h % 4 or w % 2:
        raise ValueError(f"bgr_to_yuv420 needs H % 4 == 0 and W % 2 == 0, "
                         f"got {h}x{w}")
    f = img.to(torch.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 0.256788 * r + 0.504129 * g + 0.097906 * b + 16.0
    cb = -0.148223 * r - 0.290993 * g + 0.439216 * b + 128.0
    cr = 0.439216 * r - 0.367788 * g - 0.071427 * b + 128.0
    # box-average chroma over 2x2 blocks, then ravel each (H/2, W/2) plane
    # into W-wide rows
    cb = cb.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))
    cr = cr.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))

    def to_u8(p):
        return p.round().clamp(0.0, 255.0).to(torch.uint8)

    return torch.cat([to_u8(y), to_u8(cb).reshape(h // 4, w),
                      to_u8(cr).reshape(h // 4, w)], dim=0)
