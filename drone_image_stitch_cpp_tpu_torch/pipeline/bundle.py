"""Bundle adjustment over per-frame 4-DoF similarity transforms.

Port of ``drone_image_stitch_cpp_tpu/pipeline/bundle.py``
(BundleAdjusterAffinePartial analog, stitch_robust.cpp:199-201). For the
similarity model the residuals T_i(p) - T_j(q) are linear in the stacked
(a, b, tx, ty) parameters, so the adjust is a weighted linear
least-squares solve of one (4N, 4N) system, gauge-fixed by a strong prior
pinning frame 0 and a weak pull toward the chain initialisation, with
IRLS re-weighting of edges (Cauchy on the per-edge RMS residual), on
Hartley-normalised coordinates. Unlike the JAX package's, the solves
after the first correct the bias that the points' noise puts on the
scales (corrected least squares), which shrinks a long line.
"""

from __future__ import annotations

import torch

_PIN_WEIGHT = 1e8     # frame-0 identity prior
_INIT_WEIGHT = 1e-4   # weak pull toward the chain init


def params_from_affine(t23: torch.Tensor) -> torch.Tensor:
    """(N, 2, 3) similarity transforms -> (N, 4) params (a, b, tx, ty)."""
    return torch.stack([t23[:, 0, 0], t23[:, 1, 0], t23[:, 0, 2],
                        t23[:, 1, 2]], dim=-1)


def affine_from_params(p: torch.Tensor) -> torch.Tensor:
    """(N, 4) params -> (N, 2, 3) transforms."""
    a, b, tx, ty = p.unbind(-1)
    return torch.stack([torch.stack([a, -b, tx], dim=-1),
                        torch.stack([b, a, ty], dim=-1)], dim=1)


def _jac_blocks(pts: torch.Tensor) -> torch.Tensor:
    """Per-point Jacobian wrt (a, b, tx, ty): (..., 2 rows, 4 params)."""
    x, y = pts[..., 0], pts[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    jx = torch.stack([x, -y, one, zero], dim=-1)
    jy = torch.stack([y, x, zero, one], dim=-1)
    return torch.stack([jx, jy], dim=-2)


def normal_equations(pair_idx: torch.Tensor, pts_a: torch.Tensor,
                     pts_b: torch.Tensor, w: torch.Tensor, n: int):
    """(4N, 4N) AtA and (4N,) Atb for a set of pairs (scatter-add of the
    per-pair 4x4 blocks), in the dtype of ``w``."""
    ja = _jac_blocks(pts_a)          # (P, K, 2, 4)
    jb = -_jac_blocks(pts_b)

    def blk(u, v):
        return torch.einsum("pkra,pkrb,pk->pab", u, v, w)

    ata = torch.zeros((n, 4, n, 4), dtype=w.dtype, device=w.device)
    i_idx = pair_idx[:, 0]
    j_idx = pair_idx[:, 1]
    for (r, c), b in (((i_idx, i_idx), blk(ja, ja)),
                      ((i_idx, j_idx), blk(ja, jb)),
                      ((j_idx, i_idx), blk(jb, ja)),
                      ((j_idx, j_idx), blk(jb, jb))):
        # (P, 4, 4) blocks into ata[r, :, c, :]: move the pair axis first
        view = ata.permute(0, 2, 1, 3)            # (n, n, 4, 4)
        view.index_put_((r, c), b, accumulate=True)
    return (ata.reshape(n * 4, n * 4),
            torch.zeros((n * 4,), dtype=w.dtype, device=w.device))


def solve_with_priors(ata: torch.Tensor, atb: torch.Tensor,
                      init_params: torch.Tensor) -> torch.Tensor:
    """Apply the gauge priors and solve; returns (N, 2, 3) transforms."""
    n = init_params.shape[0]
    prior_w = torch.full((n,), _INIT_WEIGHT, dtype=ata.dtype,
                         device=ata.device)
    prior_w[0] = _PIN_WEIGHT
    prior_diag = prior_w.repeat_interleave(4)
    ata = ata + torch.diag(prior_diag)
    atb = atb + prior_diag * init_params.reshape(-1)
    sol = torch.linalg.solve(ata, atb).reshape(n, 4)
    return affine_from_params(sol)


def bundle_adjust_similarity(pair_idx: torch.Tensor, pts_a: torch.Tensor,
                             pts_b: torch.Tensor, w: torch.Tensor,
                             init_params: torch.Tensor,
                             dtype: torch.dtype = torch.float64
                             ) -> torch.Tensor:
    """Per-frame similarity transforms from pairwise matches.

    pair_idx (P, 2) long; pts_a/pts_b (P, K, 2); w (P, K) match weights;
    init_params (N, 4). Returns (N, 2, 3) frame->reference transforms.
    Coordinates are centred/scaled to O(1) before the system is built
    (raw 4K-pixel coordinates give a condition number ~1e7 in float32)
    and the result is conjugated back. The system is built and solved in
    ``dtype``, by default float64 (the JAX package's is float32): the 1e8
    pin on frame 0 against per-pair weights of a few hundred gives it a
    condition number near 1e8, so in float32 the last frames of a
    12-frame 4K line moved by up to 1.8 px with the summation order alone
    (the CPU's thread count, or the card against the CPU, on the same
    matches); ``studies/corridor_gt_rmse.py`` passes float32 to measure
    what that does to the panorama.
    """
    n = init_params.shape[0]
    out_dtype = init_params.dtype
    pts_a, pts_b, w, init_params = (
        a.to(dtype) for a in (pts_a, pts_b, w, init_params))
    wsum = w.sum().clamp(min=1e-6)
    c = ((pts_a * w[..., None]).sum(dim=(0, 1))
         + (pts_b * w[..., None]).sum(dim=(0, 1))) / (2.0 * wsum)
    spread = (((pts_a - c).abs() * w[..., None]).sum()
              + ((pts_b - c).abs() * w[..., None]).sum()) / (4.0 * wsum)
    s = spread.clamp(min=1e-3)
    pa_n = (pts_a - c) / s
    pb_n = (pts_b - c) / s
    # conjugate the init: a, b invariant; t_n = (A c + t - c) / s
    a_, b_, tx, ty = init_params.unbind(-1)
    tnx = (a_ * c[0] - b_ * c[1] + tx - c[0]) / s
    tny = (b_ * c[0] + a_ * c[1] + ty - c[1]) / s
    init_n = torch.stack([a_, b_, tnx, tny], dim=-1)

    # IRLS: per-edge Cauchy weights from the RMS residual, evaluated at
    # the chain init and again at each solution, cut falsely verified
    # pair models while keeping consistent edges at full weight.
    # Errors in variables: noise of variance v per coordinate in the
    # matched points adds 2 v a point to the (a, a) and (b, b) entries
    # of AtA, so the plain solve is paid for shrinking every scale and,
    # with frame 0 pinned, a long line comes out short (0.22% over a
    # 100-frame line of 640 px thermal frames, 8.8 px at its end; the
    # JAX package's formulation reads the same in float64). The two
    # solves after the first subtract that noise (corrected least
    # squares), v the median over the edges of its estimate from the
    # residuals of the solve before (a false edge does not move it).
    tau = 12.0 / s
    wsum_e = w.sum(dim=1).clamp(min=1e-6)

    def edge_residuals(params_n):
        """Per-edge Cauchy weights, and the points' noise variance per
        coordinate (the median of the edges' estimates)."""
        t23 = affine_from_params(params_n)
        ti = t23[pair_idx[:, 0]]
        tj = t23[pair_idx[:, 1]]

        def appl(t, p):
            return (torch.einsum("pab,pkb->pka", t[:, :, :2], p)
                    + t[:, None, :, 2])

        res = appl(ti, pa_n) - appl(tj, pb_n)
        r2 = ((res * res).sum(dim=-1) * w).sum(dim=1)
        we = 1.0 / (1.0 + r2 / wsum_e / tau ** 2)
        # a point's residual has variance 2 v (|A_i|^2 + |A_j|^2)
        s2 = (params_n[:, :2] ** 2).sum(dim=-1)
        gain = 2.0 * (s2[pair_idx[:, 0]] + s2[pair_idx[:, 1]])
        v = r2 / (gain * wsum_e).clamp(min=1e-12)
        return we, v.median()

    t_n = None
    params_cur = init_n
    for it in range(3):
        we, v = edge_residuals(params_cur)
        ww = w * we[:, None]
        ata, atb = normal_equations(pair_idx, pa_n, pb_n, ww, n)
        if it:
            d = 2.0 * v * ww.sum(dim=1)
            noise = torch.zeros((n, 4), dtype=ata.dtype, device=ata.device)
            for col in (0, 1):
                noise[:, col].index_add_(0, pair_idx[:, 0], d)
                noise[:, col].index_add_(0, pair_idx[:, 1], d)
            ata = ata - torch.diag(noise.reshape(-1))
        t_n = solve_with_priors(ata, atb, init_n)
        params_cur = params_from_affine(t_n)

    # denormalise: T = D^-1 T_n D
    an, bn = t_n[:, 0, 0], t_n[:, 1, 0]
    txf = -an * c[0] + bn * c[1] + s * t_n[:, 0, 2] + c[0]
    tyf = -bn * c[0] - an * c[1] + s * t_n[:, 1, 2] + c[1]
    return affine_from_params(torch.stack([an, bn, txf, tyf], dim=-1)
                              ).to(out_dtype)
