"""Batched descriptor matching: L2 kNN(k=2) + Lowe ratio test.

Port of ``drone_image_stitch_cpp_tpu/ops/match.py``: cv::BFMatcher::
knnMatch(k=2) + ratio filtering (stitch_robust.cpp:106-118,
visual_flight_grouper.cpp:137-154) and the BestOf2Nearest confidence
inliers / (8 + 0.3 * matches). The (K, K) distance matrix is one matmul,
d^2 = |a|^2 + |b|^2 - 2 a.b; every function takes a leading pair axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = 1e18


class Matches(NamedTuple):
    idx: torch.Tensor    # (..., K) long — index into B for each A keypoint
    dist: torch.Tensor   # (..., K) float32 — best L2 distance
    dist2: torch.Tensor  # (..., K) float32 — second-best L2 distance
    good: torch.Tensor   # (..., K) bool — passed ratio test (and validity)


def distance_sq(desc_a: torch.Tensor, desc_b: torch.Tensor,
                valid_a: torch.Tensor, valid_b: torch.Tensor
                ) -> torch.Tensor:
    """Pairwise squared L2 distances (..., Ka, Kb); invalid -> 1e18."""
    a = desc_a.to(torch.float32)
    b = desc_b.to(torch.float32)
    na = (a * a).sum(dim=-1, keepdim=True)
    nb = (b * b).sum(dim=-1, keepdim=True)
    d2 = (na + nb.transpose(-1, -2) - 2.0 * (a @ b.transpose(-1, -2))
          ).clamp(min=0.0)
    both = valid_a[..., :, None] & valid_b[..., None, :]
    return torch.where(both, d2, torch.full_like(d2, _BIG))


def knn2_ratio(desc_a: torch.Tensor, valid_a: torch.Tensor,
               desc_b: torch.Tensor, valid_b: torch.Tensor,
               ratio: float) -> Matches:
    """kNN(k=2) from A into B with the Lowe ratio test."""
    d2 = distance_sq(desc_a, desc_b, valid_a, valid_b)
    return knn2_ratio_from_d2(d2, valid_a, valid_b, ratio)


def knn2_ratio_from_d2(d2: torch.Tensor, valid_a: torch.Tensor,
                       valid_b: torch.Tensor, ratio: float) -> Matches:
    """kNN(k=2) + ratio test on a precomputed (..., Ka, Kb) distance
    matrix, under the validity masks (..., Ka) and (..., Kb), so a bank of
    ROI hypotheses shares one distance product. The nearest is the first
    minimum (as jnp.argmin); the second-nearest distance is the second
    smallest value of the row, ties included, which is the minimum of the
    row with the nearest masked out."""
    both = valid_a[..., :, None] & valid_b[..., None, :]
    d2 = torch.where(both, d2, torch.full((), _BIG, dtype=d2.dtype,
                                          device=d2.device))
    best, bidx = torch.min(d2, dim=-1)
    if d2.shape[-1] > 1:
        second = torch.topk(d2, 2, dim=-1, largest=False).values[..., 1]
    else:
        second = torch.full_like(best, _BIG)
    d1 = torch.sqrt(best)
    d2r = torch.sqrt(second)
    good = (d1 < ratio * d2r) & valid_a & (best < _BIG * 0.5)
    return Matches(idx=bidx, dist=d1, dist2=d2r, good=good)


def adaptive_ratio(match_conf: float) -> float:
    """clamp(match_conf + 0.45, 0.65, 0.92) (visual_flight_grouper.cpp:
    141-144), evaluated in float32 like the JAX package."""
    v = torch.tensor(match_conf, dtype=torch.float32) + 0.45
    return float(v.clamp(0.65, 0.92))


def pair_confidence(n_inliers, n_matches):
    """OpenCV BestOf2Nearest confidence: inliers / (8 + 0.3 * matches)."""
    return n_inliers / (8.0 + 0.3 * n_matches)


def gather_correspondences(xy_a: torch.Tensor, xy_b: torch.Tensor,
                           m: Matches):
    """Matched point arrays (..., K, 2) x2 plus the good mask."""
    idx = m.idx[..., None].expand(*m.idx.shape, 2)
    return xy_a, xy_b.gather(-2, idx), m.good
