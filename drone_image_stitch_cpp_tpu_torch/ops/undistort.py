"""Lens undistortion with the 8-coefficient rational model.

Port of ``drone_image_stitch_cpp_tpu/ops/undistort.py`` (cv::undistort
with rational-model coefficients, undistortImagesIfReady,
stitch_app.cpp:38-80): the distortion maps are built in closed form on the
frame's device, in the JAX package's operation order, and sampled with the
bilinear ``ops/warp.remap``.
"""

from __future__ import annotations

import torch

from ..config.tuning import CameraCalibration
from .warp import remap


def distortion_maps(calib: CameraCalibration, h: int, w: int,
                    device=None):
    """Maps (map_x, map_y), each (h, w) float32: for each undistorted
    pixel, its source in the distorted frame.

    Rational model (OpenCV ordering k1 k2 p1 p2 k3 k4 k5 k6):
      x' = x (1 + k1 r^2 + k2 r^4 + k3 r^6) / (1 + k4 r^2 + k5 r^4 + k6 r^6)
           + 2 p1 x y + p2 (r^2 + 2 x^2)
      (y' analogous), in normalized camera coordinates.
    """
    if not calib.is_ready():
        raise ValueError("calibration placeholders not filled")
    fx, fy, cx, cy = calib.fx, calib.fy, calib.cx, calib.cy
    k1, k2, p1, p2, k3, k4, k5, k6 = calib.dist
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    x = ((xs - cx) / fx).expand(h, w)
    y = ((ys - cy) / fy).expand(h, w)
    r2 = x * x + y * y
    num = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    den = 1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
    scale = num / den
    xd = x * scale + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * scale + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd * fx + cx, yd * fy + cy


def undistort(img: torch.Tensor, calib: CameraCalibration) -> torch.Tensor:
    """Undistort one (H, W[, C]) image: float32 of the same shape."""
    h, w = img.shape[0], img.shape[1]
    map_x, map_y = distortion_maps(calib, h, w, img.device)
    return remap(img, map_x, map_y)
