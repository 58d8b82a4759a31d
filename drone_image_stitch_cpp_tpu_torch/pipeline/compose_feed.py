"""Per-frame compose feed into the canvas pyramid.

Port of ``drone_image_stitch_cpp_tpu/pipeline/compose_feed.py::
_feed_body``: warp the frame (uint8 BGR, packed I420 from a ``yuv420``
frame store, or float32 below full compositing resolution) and its content
mask into the ROI window (ONE launch of K2,
ops/warp_kernel.py; with the perspective warper, ``persp=True``, two
plain ``ops/warp.warp_perspective`` warps instead, as the JAX package
never sends those to its Pallas kernel), apply the gains, upsample the
seam mask to the window, weight it, and accumulate the multiband pyramid.
Two modes mirror the two callers:
  * ``mode="strip"``: the mask is the source rectangle's footprint, kept
    at >= 0.5; a block-gain surface; weight = seam * mask;
  * ``mode="global"``: the mask is the warp of the source's gray > 2
    indicator (K2's content mode), kept at >= 0.999; a per-channel gain
    applied after the warp (warping is linear, so this equals gain-then-
    warp); weight = the sigma-10 Gaussian of the seam mask inside the mask
    (buildSoftBlendMask, stitch_global.cpp:332-351,643-660).
The seam-scale surfaces are upsampled with two 1-D bilinear-hat matmuls,
the same samples as a gather warp of [[1/s, 0, -gx], [0, 1/s, -gy]].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import blend as B
from ..ops.color import yuv420_to_bgr
from ..ops.gaussian import gaussian_blur
from ..ops.warp import warp_perspective
from ..ops.warp_kernel import warp_frame

_SOFT_MASK_SIGMA = 10.0  # reference :345
_MODES = {"strip": ("ones", 0.5), "global": ("nonblack", 0.999)}


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


def feed_frame(cv: B.MultiBandCanvas, img: torch.Tensor,
               seam_mask: torch.Tensor, t_full: np.ndarray, tlx: int,
               tly: int, gx: float, gy: float, seam_scale: float, rh: int,
               rw: int, gain_m1: Optional[torch.Tensor] = None,
               mode: str = "strip", chan_gain=None, persp: bool = False,
               h33: Optional[np.ndarray] = None) -> B.MultiBandCanvas:
    """Feed one frame's ROI window into ``cv`` (in place).

    ``img``: (H, W, 3) uint8 or float32 device frame, or an (H*3/2, W)
    packed I420 one (K2's I420 source; compose_feed.py:77-80);
    ``seam_mask``: (gh, gw) bool at seam scale; ``t_full``: host (2, 3)
    frame->window affine; (tlx, tly) the window's canvas offset (in
    ``cv``) and (gx, gy) its offset on the seam-scale canvas's
    full-resolution grid;
    ``gain_m1``: optional (gh, gw) block-gain-minus-1 surface; ``mode``:
    "strip" or "global" (see the module doc); ``chan_gain``: optional host
    (3,) gains; ``persp`` (strip mode, the perspective warper): warp the
    frame and an all-ones mask with ``warp_perspective`` by the host
    (3, 3) ``h33`` (compose_feed.py:82-88) instead of K2. The frame and
    its surfaces are read on ``cv``'s device (a copy when a tiled compose
    placed the tile on another card).
    """
    dev = cv.wacc[0].device
    img, seam_mask = img.to(dev), seam_mask.to(dev)
    if gain_m1 is not None:
        gain_m1 = gain_m1.to(dev)
    content, cthresh = _MODES[mode]
    if persp:
        if mode != "strip":
            raise ValueError("the perspective route feeds strip mode only")
        if img.ndim == 2:
            img = yuv420_to_bgr(img)
        ones = torch.ones(img.shape[:2], dtype=torch.float32, device=dev)
        wimg = warp_perspective(img, h33, rh, rw)
        cm = warp_perspective(ones, h33, rh, rw)
    else:
        wimg, cm = warp_frame(img, t_full, rh, rw, content=content)
    cmask = cm >= cthresh
    if chan_gain is not None:
        wimg = wimg * torch.as_tensor(np.asarray(chan_gain, np.float32),
                                      device=dev)
    inv_seam = torch.tensor(1.0 / max(seam_scale, 1e-12),
                            dtype=torch.float32, device=dev)
    gxt = torch.tensor(gx, dtype=torch.float32, device=dev)
    gyt = torch.tensor(gy, dtype=torch.float32, device=dev)
    if gain_m1 is not None:
        wimg = wimg * (1.0 + _upsample(gain_m1, rh, rw, gxt, gyt,
                                       inv_seam))[..., None]
    sroi = _upsample(seam_mask, rh, rw, gxt, gyt, inv_seam)
    if mode == "global":
        weight = torch.where(cmask, gaussian_blur(sroi, _SOFT_MASK_SIGMA),
                             torch.zeros((), device=dev))
    else:
        weight = sroi * cmask.to(torch.float32)
    return B.mb_feed(cv, wimg, weight, tlx, tly, cmask)
