"""Exposure / gain compensation: scalar gains + block gain surfaces.

Port of ``drone_image_stitch_cpp_tpu/ops/exposure.py``: OpenCV's gain
system min sum_ij N_ij [alpha (g_i I_ij - g_j I_ji)^2 + beta (1 - g_i)^2]
with alpha=0.01, beta=100 and similarity threshold 0.95, solved per image
(GainCompensator(1)), per channel (ChannelsCompensator(2), the global
stage, stitch_global.cpp:307-326) or as block gain surfaces toward the
blended consensus from block means, clamped to [0.5, 2] and upsampled
with the triangle filter (BlocksGainCompensator, stitch_robust.cpp:
209-211).
"""

from __future__ import annotations

import torch

from .resize import resize_linear

_ALPHA = 0.01
_BETA = 100.0


def solve_gains(i_mat: torch.Tensor, n_mat: torch.Tensor) -> torch.Tensor:
    """Solve the OpenCV gain system; ``i_mat[i, j]`` = mean intensity of
    image i over overlap(i, j), ``n_mat`` the overlap counts. (N,) gains."""
    n = i_mat.shape[0]
    nf = n_mat.to(torch.float32)
    diag = (nf * (2.0 * _ALPHA * i_mat ** 2 + _BETA)).sum(dim=1)
    off = -2.0 * _ALPHA * nf * i_mat * i_mat.T
    a = torch.diag(diag) + off - torch.diag(torch.diag(off))
    b = (nf * _BETA).sum(dim=1)
    a = a + 1e-6 * torch.eye(n, dtype=a.dtype, device=a.device)
    return torch.linalg.solve(a, b)


def gain_compensate_scalar(intens: torch.Tensor, masks: torch.Tensor,
                           similarity_thresh: float = 0.95) -> torch.Tensor:
    """One gain per image (GainCompensator(1) analog). ``intens``: (N, H, W)
    shared-frame intensities; ``masks``: (N, H, W) bool. Returns (N,)."""
    n = intens.shape[0]
    mi = torch.zeros((n, n), dtype=torch.float32, device=intens.device)
    cnt = torch.zeros((n, n), dtype=torch.float32, device=intens.device)
    for i in range(n):
        both = masks[i][None] & masks
        if similarity_thresh < 1.0:
            denom = torch.maximum(intens[i][None], intens).clamp(min=1.0)
            sim = 1.0 - (intens[i][None] - intens).abs() / denom
            both = both & (sim >= similarity_thresh)
        c = both.sum(dim=(1, 2))
        cf = c.to(torch.float32).clamp(min=1.0)
        mi[i] = torch.where(both, intens[i][None],
                            torch.zeros((), device=intens.device)
                            ).sum(dim=(1, 2)) / cf
        cnt[i] = c.to(torch.float32)
    off_diag = 1.0 - torch.eye(n, dtype=torch.float32, device=intens.device)
    return solve_gains(mi * off_diag, cnt * off_diag)


def channels_compensate(images: torch.Tensor, masks: torch.Tensor,
                        similarity_thresh: float = 0.95) -> torch.Tensor:
    """Per-channel gains (ChannelsCompensator(2) analog) of (N, H, W, C)
    shared-frame images under (N, H, W) bool masks. Returns (N, C)."""
    return torch.stack([gain_compensate_scalar(images[..., c], masks,
                                               similarity_thresh)
                        for c in range(images.shape[-1])], dim=-1)


def block_gain_maps(intens: torch.Tensor, masks: torch.Tensor,
                    block: int = 32,
                    similarity_thresh: float = 0.95) -> torch.Tensor:
    """BlocksGainCompensator analog: (N, H, W) per-pixel gain surfaces
    from (N, H, W) intensities and bool masks."""
    n, h, w = intens.shape
    base = gain_compensate_scalar(intens, masks, similarity_thresh)
    mf = masks.to(torch.float32)
    wsum = mf.sum(dim=0).clamp(min=1e-6)
    consensus = (intens * base[:, None, None] * mf).sum(dim=0) / wsum

    bh = max(1, h // block)
    bw = max(1, w // block)
    ph, pw = bh * block, bw * block

    def pool(x):
        return x[:ph, :pw].reshape(bh, block, bw, block).mean(dim=(1, 3))

    zero = torch.zeros((), device=intens.device)
    maps = []
    for i in range(n):
        num = pool(torch.where(masks[i], consensus, zero))
        den = pool(torch.where(masks[i], intens[i] * base[i], zero))
        cnt = pool(mf[i])
        ratio = torch.where(cnt > 0.05, num / den.clamp(min=1e-6),
                            torch.ones_like(num)).clamp(0.5, 2.0)
        maps.append(base[i] * resize_linear(ratio, h, w))
    return torch.stack(maps)
