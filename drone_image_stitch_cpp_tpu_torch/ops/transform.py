"""2-D transform algebra: affine/similarity/homography helpers.

Port of ``drone_image_stitch_cpp_tpu/ops/transform.py``. Matrices act on
column vectors ``(x, y, 1)`` with x = column, y = row (OpenCV convention).
"""

from __future__ import annotations

import torch


def affine_to_h3(a23: torch.Tensor) -> torch.Tensor:
    """Lift a (..., 2, 3) affine to a (..., 3, 3) homogeneous matrix."""
    bottom = torch.tensor([0.0, 0.0, 1.0], dtype=a23.dtype,
                          device=a23.device).expand(*a23.shape[:-2], 1, 3)
    return torch.cat([a23, bottom], dim=-2)


def compose_affine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The (2, 3) affine equal to applying ``b`` then ``a``."""
    return (affine_to_h3(a) @ affine_to_h3(b))[..., :2, :]


def invert_affine(a23: torch.Tensor) -> torch.Tensor:
    """Invert a (..., 2, 3) affine transform."""
    inv_lin = torch.linalg.inv(a23[..., :, :2])
    inv_t = -(inv_lin @ a23[..., :, 2:])
    return torch.cat([inv_lin, inv_t], dim=-1)


def similarity_params(a23: torch.Tensor):
    """(tx, ty, scale, rot_deg) of a similarity-ish affine
    (visual_flight_grouper.cpp:190-199)."""
    a, b = a23[..., 0, 0], a23[..., 1, 0]
    c, d = a23[..., 0, 1], a23[..., 1, 1]
    scale = 0.5 * (torch.sqrt(a * a + b * b) + torch.sqrt(c * c + d * d))
    rot = torch.rad2deg(torch.atan2(b, a))
    return a23[..., 0, 2], a23[..., 1, 2], scale, rot


def apply_affine_pts(a23: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (2, 3) affine to (..., N, 2) points (x, y)."""
    return pts @ a23[..., :, :2].transpose(-1, -2) + a23[..., None, :, 2]


def apply_homography_pts(h33: torch.Tensor, pts: torch.Tensor
                         ) -> torch.Tensor:
    """Apply (..., 3, 3) homographies to (..., N, 2) points with the
    perspective divide."""
    ones = torch.ones(pts.shape[:-1] + (1,), dtype=pts.dtype,
                      device=pts.device)
    out = torch.cat([pts, ones], dim=-1) @ h33.transpose(-1, -2)
    w = out[..., 2:]
    return out[..., :2] / torch.clamp(w.abs(), min=1e-12) * torch.sign(w)


def image_corners(h: int, w: int, dtype=torch.float32) -> torch.Tensor:
    """Corner points (4, 2) as (x, y) of an h x w image."""
    return torch.tensor(
        [[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0], [0.0, h - 1.0]],
        dtype=dtype)
