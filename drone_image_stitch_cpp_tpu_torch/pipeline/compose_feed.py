"""Per-frame compose feed into the canvas pyramid (strip mode, affine).

Port of ``drone_image_stitch_cpp_tpu/pipeline/compose_feed.py::
_feed_body`` for the strip compose: warp the uint8 frame and its content
footprint into the ROI window (ONE launch of K2, ops/warp_kernel.py),
modulate by the block-gain surface, upsample the seam mask to the window,
weight = seam * (footprint >= 0.5), and accumulate the multiband pyramid.
The seam-scale surfaces are upsampled with two 1-D bilinear-hat matmuls,
the same samples as a gather warp of [[1/s, 0, -gx], [0, 1/s, -gy]].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import blend as B
from ..ops.warp_kernel import warp_frame


def _hat(n_out: int, n_src: int, off: torch.Tensor,
         inv_seam: torch.Tensor) -> torch.Tensor:
    """(n_out, n_src) bilinear hat weights for out index -> src sample
    (i + off) / inv_seam."""
    dev = inv_seam.device
    src = (torch.arange(n_out, dtype=torch.float32, device=dev) + off
           ) / inv_seam
    k = torch.arange(n_src, dtype=torch.float32, device=dev)
    return (1.0 - (src[:, None] - k[None, :]).abs()).clamp(min=0.0)


def _upsample(m: torch.Tensor, rh: int, rw: int, gx: torch.Tensor,
              gy: torch.Tensor, inv_seam: torch.Tensor) -> torch.Tensor:
    m32 = m.to(torch.float32)
    gh, gw = m32.shape
    t = m32 @ _hat(rw, gw, gx, inv_seam).T            # (gh, rw)
    return _hat(rh, gh, gy, inv_seam) @ t             # (rh, rw)


def feed_frame(cv: B.MultiBandCanvas, img_u8: torch.Tensor,
               seam_mask: torch.Tensor, t_full: np.ndarray, tlx: int,
               tly: int, gx: float, gy: float, seam_scale: float, rh: int,
               rw: int, gain_m1: Optional[torch.Tensor] = None
               ) -> B.MultiBandCanvas:
    """Feed one frame's ROI window into ``cv`` (in place).

    ``img_u8``: (H, W, 3) uint8 device frame; ``seam_mask``: (gh, gw) bool
    at seam scale; ``t_full``: host (2, 3) frame->window affine; (tlx, tly)
    the window's canvas offset and (gx, gy) its float offset at full
    resolution; ``gain_m1``: optional (gh, gw) block-gain-minus-1 surface.
    """
    dev = img_u8.device
    wimg, cm = warp_frame(img_u8, t_full, rh, rw)
    cmask = cm >= 0.5
    inv_seam = torch.tensor(1.0 / max(seam_scale, 1e-12),
                            dtype=torch.float32, device=dev)
    gxt = torch.tensor(gx, dtype=torch.float32, device=dev)
    gyt = torch.tensor(gy, dtype=torch.float32, device=dev)
    if gain_m1 is not None:
        wimg = wimg * (1.0 + _upsample(gain_m1, rh, rw, gxt, gyt,
                                       inv_seam))[..., None]
    sroi = _upsample(seam_mask, rh, rw, gxt, gyt, inv_seam)
    weight = sroi * cmask.to(torch.float32)
    return B.mb_feed(cv, wimg, weight, tlx, tly, cmask)
