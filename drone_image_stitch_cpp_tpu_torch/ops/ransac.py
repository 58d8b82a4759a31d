"""Fixed-iteration RANSAC hypothesis banks, batched over pairs.

Port of the ``similarity`` kind of ``drone_image_stitch_cpp_tpu/ops/
ransac.py`` (cv::estimateAffinePartial2D RANSAC analog,
visual_flight_grouper.cpp:170-171): per pair, a bank of ``n_hyp`` 2-point
samples is solved and scored in one batch, the best hypothesis is refined
by weighted least squares on its inliers a fixed number of times, all in
Hartley-normalised coordinates.

The sample bank is an input: ``raw`` holds (n_hyp, 2) non-negative
integers per pair, reduced modulo the pair's number of good matches (the
JAX package draws the same array with ``jax.random.randint``; the port's
production caller draws it from a seeded ``torch.Generator``). Feeding
both packages one bank makes their results comparable.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .transform import apply_homography_pts

_M = 2   # minimal sample of the similarity model


class RansacResult(NamedTuple):
    model: torch.Tensor      # (P, 3, 3) float32
    inliers: torch.Tensor    # (P, K) bool
    n_inliers: torch.Tensor  # (P,) long
    ok: torch.Tensor         # (P,) bool


def _normalize_stats(pts: torch.Tensor, mask: torch.Tensor):
    """Masked centroid (P, 2) + isotropic scale (P,) (mean |p - c| -> 1)."""
    wsum = mask.sum(dim=-1).clamp(min=1.0)
    c = (pts * mask[..., None]).sum(dim=-2) / wsum[..., None]
    d = torch.sqrt(((pts - c[..., None, :]) ** 2).sum(dim=-1))
    s = ((d * mask).sum(dim=-1) / wsum).clamp(min=1e-6)
    return c, s


def solve_similarity(src: torch.Tensor, dst: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Weighted LS similarity x' = a x - b y + tx, y' = b x + a y + ty over
    the trailing point axis; returns (..., 3, 3), NaN where singular."""
    ws = w.sum(dim=-1).clamp(min=1e-9)
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    sxx = (w * (x * x + y * y)).sum(dim=-1)
    sx = (w * x).sum(dim=-1)
    sy = (w * y).sum(dim=-1)
    sux_vy = (w * (u * x + v * y)).sum(dim=-1)
    svx_uy = (w * (v * x - u * y)).sum(dim=-1)
    su = (w * u).sum(dim=-1)
    sv = (w * v).sum(dim=-1)
    z = torch.zeros_like(sxx)
    mat = torch.stack([
        torch.stack([sxx, z, sx, sy], dim=-1),
        torch.stack([z, sxx, -sy, sx], dim=-1),
        torch.stack([sx, -sy, ws, z], dim=-1),
        torch.stack([sy, sx, z, ws], dim=-1)], dim=-2)
    rhs = torch.stack([sux_vy, svx_uy, su, sv], dim=-1)
    det_ok = torch.linalg.det(mat).abs() > 1e-12
    eye = torch.eye(4, dtype=mat.dtype, device=mat.device)
    mat = torch.where(det_ok[..., None, None], mat, eye)
    a, b, tx, ty = torch.linalg.solve(mat, rhs).unbind(-1)
    one = torch.ones_like(a)
    h = torch.stack([torch.stack([a, -b, tx], dim=-1),
                     torch.stack([b, a, ty], dim=-1),
                     torch.stack([z, z, one], dim=-1)], dim=-2)
    return torch.where(det_ok[..., None, None], h,
                       torch.full_like(h, float("nan")))


def _residual_sq(model: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor) -> torch.Tensor:
    return ((apply_homography_pts(model, src) - dst) ** 2).sum(dim=-1)


def _any_nan(h: torch.Tensor) -> torch.Tensor:
    return torch.isnan(h).flatten(-2).any(dim=-1)


def ransac_similarity(src: torch.Tensor, dst: torch.Tensor,
                      good: torch.Tensor, raw: torch.Tensor,
                      thresh, refine_iters: int = 3,
                      min_inliers: int = 4) -> RansacResult:
    """Robust similarity fit per pair.

    ``src``/``dst``: (P, K, 2); ``good``: (P, K) bool; ``raw``: (P, n_hyp,
    2) non-negative sample integers; ``thresh``: inlier threshold in
    ``src`` units (float or (P,) tensor).
    """
    p, k = good.shape
    dev = src.device
    goodf = good.to(torch.float32)
    n_good = good.sum(dim=-1)
    cs, ss = _normalize_stats(src, goodf)
    cd, sd = _normalize_stats(dst, goodf)
    srcn = (src - cs[:, None]) / ss[:, None, None]
    dstn = (dst - cd[:, None]) / sd[:, None, None]
    thresh_n_sq = ((torch.as_tensor(thresh, dtype=torch.float32, device=dev)
                    / sd) ** 2)[:, None]                          # (P, 1)

    # good matches to the front (stable), sample uniformly among them
    order = torch.argsort((~good).to(torch.int8), dim=-1, stable=True)
    src_s = srcn.gather(1, order[..., None].expand(p, k, 2))
    dst_s = dstn.gather(1, order[..., None].expand(p, k, 2))
    samp = torch.remainder(raw.to(torch.long),
                           n_good.clamp(min=1)[:, None, None])  # (P, H, 2)
    n_hyp = samp.shape[1]

    def pick(a, idx):
        flat = idx.reshape(p, -1)
        out = a.gather(1, flat[..., None].expand(p, flat.shape[1], 2))
        return out.reshape(*idx.shape, 2)

    sp = pick(src_s, samp)                                      # (P, H, 2, 2)
    dp = pick(dst_s, samp)
    ones_m = torch.ones((p, n_hyp, _M), dtype=torch.float32, device=dev)
    h_all = solve_similarity(sp, dp, ones_m)                    # (P, H, 3, 3)
    r = _residual_sq(h_all, srcn[:, None], dstn[:, None])       # (P, H, K)
    inl = (r < thresh_n_sq[..., None]) & good[:, None]
    dup = samp[..., 0] == samp[..., 1]
    scores = torch.where(dup | _any_nan(h_all), -1, inl.sum(dim=-1))
    best = torch.argmax(scores, dim=1)                          # first max
    best_score = scores.gather(1, best[:, None])[:, 0]
    bi = best[:, None, None, None].expand(p, 1, _M, 2)
    h = solve_similarity(sp.gather(1, bi)[:, 0], dp.gather(1, bi)[:, 0],
                         ones_m[:, 0])
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    h = torch.where(_any_nan(h)[:, None, None], eye, h)

    for _ in range(refine_iters):
        r = _residual_sq(h, srcn, dstn)
        w = ((r < thresh_n_sq) & good).to(torch.float32)
        enough = w.sum(dim=-1) >= _M
        hnew = solve_similarity(srcn, dstn, w)
        bad = _any_nan(hnew) | ~enough
        h = torch.where(bad[:, None, None], h, hnew)

    r = _residual_sq(h, srcn, dstn)
    inl = (r < thresh_n_sq) & good
    n_inl = inl.sum(dim=-1)

    # denormalise: H = T_d^-1 @ Hn @ T_s
    z = torch.zeros_like(ss)
    o = torch.ones_like(ss)
    t_s = torch.stack([torch.stack([1.0 / ss, z, -cs[:, 0] / ss], -1),
                       torch.stack([z, 1.0 / ss, -cs[:, 1] / ss], -1),
                       torch.stack([z, z, o], -1)], dim=-2)
    t_d_inv = torch.stack([torch.stack([sd, z, cd[:, 0]], -1),
                           torch.stack([z, sd, cd[:, 1]], -1),
                           torch.stack([z, z, o], -1)], dim=-2)
    model = t_d_inv @ h @ t_s
    m22 = model[:, 2, 2]
    model = model / torch.where(m22.abs() > 1e-12, m22,
                                torch.ones_like(m22))[:, None, None]
    ok = ((n_inl >= min_inliers) & (n_good >= _M) & (best_score > 0)
          & torch.isfinite(model).flatten(1).all(dim=-1))
    return RansacResult(model=model, inliers=inl, n_inliers=n_inl, ok=ok)
