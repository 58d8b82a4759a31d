"""Fixed-iteration RANSAC hypothesis banks, batched over problems.

Port of the ``similarity`` and ``affine`` kinds of ``drone_image_stitch_
cpp_tpu/ops/ransac.py`` (cv::estimateAffinePartial2D RANSAC,
visual_flight_grouper.cpp:170-171, and cv::estimateAffine2D RANSAC,
stitch_global.cpp:184-186): per problem, a bank of ``n_hyp`` minimal
samples (2 points for a similarity, 3 for an affine) is solved and scored
in one batch, the best hypothesis is refined by weighted least squares on
its inliers a fixed number of times, all in Hartley-normalised
coordinates.

The sample bank is an input: ``raw`` holds (n_hyp, m) non-negative
integers per problem, reduced modulo the problem's number of good matches
(the JAX package draws the same array with ``jax.random.randint``; the
port's production callers draw it from a seeded ``torch.Generator``).
Feeding both packages one bank makes their results comparable.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .transform import apply_homography_pts

MIN_SAMPLES = {"similarity": 2, "affine": 3}
# problems x hypotheses x keypoints scored per chunk of problems (bounds
# the (chunk, n_hyp, K) residual temporaries; the result does not depend
# on it)
_SCORE_CHUNK_ELEMS = 1 << 25


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


def solve_affine(src: torch.Tensor, dst: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """Weighted LS full affine (6 dof) over the trailing point axis, exact
    for 3-point samples; returns (..., 3, 3), NaN where singular."""
    ones = torch.ones_like(src[..., :1])
    a = torch.cat([src, ones], dim=-1)                  # (..., K, 3)
    aw = a * w[..., None]
    m = a.transpose(-1, -2) @ aw                        # (..., 3, 3)
    det_ok = torch.linalg.det(m).abs() > 1e-12
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    ms = torch.where(det_ok[..., None, None], m, eye)
    sol = torch.linalg.solve(ms, aw.transpose(-1, -2) @ dst)   # (..., 3, 2)
    last = torch.tensor([0.0, 0.0, 1.0], dtype=sol.dtype,
                        device=sol.device).expand(*sol.shape[:-2], 1, 3)
    h = torch.cat([sol.transpose(-1, -2), last], dim=-2)
    return torch.where(det_ok[..., None, None], h,
                       torch.full_like(h, float("nan")))


_SOLVERS = {"similarity": solve_similarity, "affine": solve_affine}


def _residual_sq(model: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor) -> torch.Tensor:
    return ((apply_homography_pts(model, src) - dst) ** 2).sum(dim=-1)


def _any_nan(h: torch.Tensor) -> torch.Tensor:
    return torch.isnan(h).flatten(-2).any(dim=-1)


def ransac(src: torch.Tensor, dst: torch.Tensor, good: torch.Tensor,
           raw: torch.Tensor, kind: str, thresh, refine_iters: int = 3,
           min_inliers: int = 4) -> RansacResult:
    """Robust ``kind`` ("similarity" or "affine") fit per problem.

    ``src``/``dst``: (P, K, 2); ``good``: (P, K) bool; ``raw``: (P, n_hyp,
    m) non-negative sample integers, m = MIN_SAMPLES[kind]; ``thresh``:
    inlier threshold in ``src`` units (float or (P,) tensor).
    """
    m = MIN_SAMPLES[kind]
    solver = _SOLVERS[kind]
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
                           n_good.clamp(min=1)[:, None, None])  # (P, H, m)
    n_hyp = samp.shape[1]

    def pick(a, idx):
        flat = idx.reshape(p, -1)
        out = a.gather(1, flat[..., None].expand(p, flat.shape[1], 2))
        return out.reshape(*idx.shape, 2)

    sp = pick(src_s, samp)                                      # (P, H, m, 2)
    dp = pick(dst_s, samp)
    ones_m = torch.ones((p, n_hyp, m), dtype=torch.float32, device=dev)
    h_all = solver(sp, dp, ones_m)                              # (P, H, 3, 3)
    dup = (samp[..., :, None] == samp[..., None, :]).sum(dim=(-1, -2)) > m
    chunk = max(1, _SCORE_CHUNK_ELEMS // max(1, n_hyp * k))
    n_inl_h = torch.cat([
        ((_residual_sq(h_all[c0:c0 + chunk], srcn[c0:c0 + chunk, None],
                       dstn[c0:c0 + chunk, None])
          < thresh_n_sq[c0:c0 + chunk, :, None])
         & good[c0:c0 + chunk, None]).sum(dim=-1)
        for c0 in range(0, p, chunk)])                          # (P, H)
    scores = torch.where(dup | _any_nan(h_all), -1, n_inl_h)
    best = torch.argmax(scores, dim=1)                          # first max
    best_score = scores.gather(1, best[:, None])[:, 0]
    bi = best[:, None, None, None].expand(p, 1, m, 2)
    h = solver(sp.gather(1, bi)[:, 0], dp.gather(1, bi)[:, 0], ones_m[:, 0])
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    h = torch.where(_any_nan(h)[:, None, None], eye, h)

    for _ in range(refine_iters):
        r = _residual_sq(h, srcn, dstn)
        w = ((r < thresh_n_sq) & good).to(torch.float32)
        enough = w.sum(dim=-1) >= m
        hnew = solver(srcn, dstn, w)
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
    ok = ((n_inl >= min_inliers) & (n_good >= m) & (best_score > 0)
          & torch.isfinite(model).flatten(1).all(dim=-1))
    return RansacResult(model=model, inliers=inl, n_inliers=n_inl, ok=ok)


def ransac_similarity(src: torch.Tensor, dst: torch.Tensor,
                      good: torch.Tensor, raw: torch.Tensor, thresh,
                      refine_iters: int = 3,
                      min_inliers: int = 4) -> RansacResult:
    """:func:`ransac` of the similarity kind (``raw``: (P, n_hyp, 2))."""
    return ransac(src, dst, good, raw, "similarity", thresh, refine_iters,
                  min_inliers)
