"""Color-space and radiometric elementwise ops.

Port of ``drone_image_stitch_cpp_tpu/ops/color.py`` (BGR part). Images are
float32 in [0, 255], layout (..., H, W, 3) channel-last BGR, as in the JAX
package, so both packages compare like with like.
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
