"""Black-border autocrop.

Port of ``drone_image_stitch_cpp_tpu/ops/crop.py::auto_crop_black_border``
(autoCropBlackBorder, stitch_common.cpp:4-27): fixed-point BT.601 gray
> 1, bounding box of all content (for a mosaic the single content region's
box is the reference's largest-contour box), clone crop. Host numpy: the
panorama is already in host memory when it is cropped.
"""

from __future__ import annotations

import numpy as np


def auto_crop_black_border(img_np: np.ndarray, thresh: float = 1.0
                           ) -> np.ndarray:
    """Host-side crop (dynamic output shape => runs after device fetch).

    Pure numpy: the input already lives in host memory.
    """
    def gray_mask(a):
        if a.ndim == 3:
            # fixed-point BT.601 gray (cv::cvtColor uses the same 8-bit
            # fixed-point path), NOT an any-channel test: a (2,0,0) border
            # pixel has gray 0.23 and must be cropped like the reference's
            # gray>thresh does (stitch_common.cpp:9)
            b, g, r = (a[..., 0].astype(np.uint32),
                       a[..., 1].astype(np.uint32),
                       a[..., 2].astype(np.uint32))
            return ((29 * b + 150 * g + 77 * r + 128) >> 8) > thresh
        return a > thresh

    # fast path: every border edge already carries content => the bbox is
    # the full frame; O(perimeter) instead of a full gray pass
    if img_np.shape[0] > 2 and img_np.shape[1] > 2 and \
            gray_mask(img_np[0]).any() and gray_mask(img_np[-1]).any() \
            and gray_mask(img_np[:, 0]).any() \
            and gray_mask(img_np[:, -1]).any():
        return np.ascontiguousarray(img_np)

    mask = gray_mask(img_np)
    rows = mask.any(axis=1)
    cols = mask.any(axis=0)
    if not rows.any():
        return np.ascontiguousarray(img_np)
    y0, y1 = np.argmax(rows), len(rows) - np.argmax(rows[::-1])
    x0, x1 = np.argmax(cols), len(cols) - np.argmax(cols[::-1])
    return np.ascontiguousarray(img_np[y0:y1, x0:x1])
