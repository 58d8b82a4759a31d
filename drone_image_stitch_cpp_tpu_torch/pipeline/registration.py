"""Shared registration front-end: gray -> downscale -> batched detect.

Port of ``drone_image_stitch_cpp_tpu/pipeline/registration.py``: frames
are converted to BT.601 gray, scaled to the registration resolution
(registration_resol_mpx, stitch_robust.cpp:183) and detected in chunks of
8 frames; keypoints come back in full-resolution frame pixels. Frames come
either as a list of host arrays or from a device ``FrameStore``. Host
frames may differ in size (the sequential fallback registers a growing
mosaic against the next frame): each is scaled by frame 0's work scale and
edge-padded to the batch's largest work size plus a 16-px margin, and the
detect masks each frame by its own size. A store of packed I420 frames
(``fmt="yuv420"``) is detected on its Y plane, the JPEG's own BT.601
luma, as the JAX package's ``_detect_batch_yuv`` does. The JAX package's
shape buckets were a workaround for its remote TPU link's compiles and are
not ported, so same-size frames are detected at the exact work size.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as TF

from ..ops import features as F
from ..ops.color import bgr_to_gray, yuv420_luma
from ..ops.resize import resize_area, scale_for_megapixels

_DETECT_CHUNK = 8  # frames per detect batch
# edge pad beyond the largest frame of a mixed-size batch: 2 px at the
# coarsest of the detector's 4 octaves
_MIXED_PAD = 16


def _detect_batch_u8(frames_u8: torch.Tensor, max_kp: int, wh: int,
                     ww: int) -> F.Features:
    """Gray -> resize -> detect for a (B, H, W, 3) uint8 BGR device batch,
    or the Y plane of a (B, H*3/2, W) packed I420 one."""
    if frames_u8.ndim == 3:
        gray = yuv420_luma(frames_u8)
    else:
        gray = bgr_to_gray(frames_u8.to(torch.float32))
    if (wh, ww) != tuple(gray.shape[1:]):
        gray = resize_area(gray, wh, ww, channels_last=False)
    return F.detect_and_describe_batched(gray, max_kp)


def _detect_mixed(images: List[np.ndarray], n_features: int, scale: float,
                  device: torch.device) -> F.Features:
    """Detect over BGR uint8 frames of different sizes: each frame's gray
    at its own work size (frame 0's scale), edge-padded (no fake gradients
    at the pad frontier) to the largest plus ``_MIXED_PAD``, then batched
    with each frame's true work size; work-pixel coordinates. The margin
    gives every frame, the largest included, a pad beyond its last row
    and column, so each is detected up to its own edge alike (as the JAX
    package's shape bucket does)."""
    work_hw = [(max(1, int(round(im.shape[0] * scale))),
                max(1, int(round(im.shape[1] * scale)))) for im in images]
    bh = max(h for h, _ in work_hw) + _MIXED_PAD
    bw = max(w for _, w in work_hw) + _MIXED_PAD
    grays = []
    for im, (wh, ww) in zip(images, work_hw):
        g = bgr_to_gray(torch.from_numpy(np.ascontiguousarray(im)).to(
            device).to(torch.float32))
        if (wh, ww) != tuple(g.shape):
            g = resize_area(g[None], wh, ww, channels_last=False)[0]
        grays.append(TF.pad(g[None, None], (0, bw - ww, 0, bh - wh),
                            mode="replicate")[0, 0])
    true_hw = torch.tensor(work_hw, dtype=torch.float32, device=device)
    outs = []
    for c0 in range(0, len(images), _DETECT_CHUNK):
        thw = true_hw[c0:c0 + _DETECT_CHUNK]
        fc = F.detect_and_describe_batched(
            torch.stack(grays[c0:c0 + _DETECT_CHUNK]), n_features,
            true_hw=thw)
        # keypoints refined past a frame's true edge are not its own
        outs.append(fc._replace(valid=fc.valid
                                & (fc.xy[..., 0] < thw[:, None, 1])
                                & (fc.xy[..., 1] < thw[:, None, 0])))
    return F.Features(*(torch.cat(fs) for fs in zip(*outs)))


def detect_features(images: Optional[List[np.ndarray]], n_features: int,
                    resol_mpx: float, device: Optional[torch.device] = None,
                    store=None, indices: Optional[List[int]] = None,
                    coord_scale: float = 1.0
                    ) -> tuple[F.Features, float]:
    """Batched feature extraction over BGR uint8 frames.

    The work scale comes from the first frame (cv::Stitcher computes
    work_scale from the first frame and applies it to all). Returns
    (Features with a leading frame axis, work_scale); keypoint coordinates
    and sigmas are in each frame's full-resolution pixels.

    ``store``/``indices``: a ``runtime.feed.FrameStore`` whose frames are
    already on its device (BGR, or packed I420 detected on the Y plane);
    otherwise ``images`` (same-size, or of mixed sizes) are copied to
    ``device`` one chunk at a time.

    ``coord_scale``: how much smaller the store's frames are than the true
    full-resolution frames (2.0 for a store decoded with ``scale_denom=2``).
    Coordinates and sigmas then come back in true full-resolution pixels
    and the returned work scale is relative to full resolution
    (registration.py:145-150 of the JAX package), so RANSAC thresholds and
    transforms are those of a full-resolution detect at the same work
    size.
    """
    mixed = False
    if store is not None:
        indices = list(indices if indices is not None
                       else range(len(store)))
        h0, w0 = store.shape0[:2]
        sizes = [(h0, w0)] * len(indices)

        def chunk_frames(ch):
            return store.batch(ch)
    else:
        if device is None:
            raise ValueError("detect_features: pass a device or a store")
        for im in images:
            if im.ndim != 3 or im.shape[2] != 3 or im.dtype != np.uint8:
                raise ValueError("detect_features takes (H, W, 3) uint8 "
                                 f"BGR frames, got {im.shape} {im.dtype}")
        sizes = [im.shape[:2] for im in images]
        mixed = len(set(sizes)) > 1
        indices = list(range(len(images)))
        h0, w0 = sizes[0]

        def chunk_frames(ch):
            return torch.from_numpy(
                np.stack([images[i] for i in ch])).to(device)

    scale = scale_for_megapixels(h0, w0, resol_mpx)
    if mixed:
        feats = _detect_mixed(images, n_features, scale, device)
    else:
        wh = max(1, int(round(h0 * scale)))
        ww = max(1, int(round(w0 * scale)))
        outs = [_detect_batch_u8(
            chunk_frames(indices[c0:c0 + _DETECT_CHUNK]), n_features, wh, ww)
            for c0 in range(0, len(indices), _DETECT_CHUNK)]
        feats = F.Features(*(torch.cat(fs) for fs in zip(*outs)))
    # back to full-res coordinates with each frame's EXACT per-axis scales
    # of its rounded work size; +-0.5 is the pixel-centre shift of area
    # resampling. Same-size frames divide by a Python scalar, which CUDA
    # evaluates as a multiply by its reciprocal: a per-frame tensor there
    # would move every keypoint by an ulp, and the registration of the
    # 12-frame corridor sortie by up to 2 px
    if mixed:
        dev = feats.xy.device
        sx = torch.tensor([max(1, int(round(w * scale))) / float(w)
                           / coord_scale for _, w in sizes],
                          device=dev)[:, None]
        sy = torch.tensor([max(1, int(round(h * scale))) / float(h)
                           / coord_scale for h, _ in sizes],
                          device=dev)[:, None]
    else:
        sx = max(1, int(round(w0 * scale))) / float(w0) / coord_scale
        sy = max(1, int(round(h0 * scale))) / float(h0) / coord_scale
    eff = scale / coord_scale
    xy = torch.stack([(feats.xy[..., 0] + 0.5) / sx - 0.5,
                      (feats.xy[..., 1] + 0.5) / sy - 0.5], dim=-1)
    return feats._replace(xy=xy, sigma=feats.sigma / eff), eff
