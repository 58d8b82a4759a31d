"""Batched pairwise registration over a pair schedule.

Port of ``drone_image_stitch_cpp_tpu/pipeline/pairgraph.py``: the banded
schedule |i - j| <= range_width
(stitch_robust.cpp:190-197), the grouper's gaps 1..3 graph
(visual_flight_grouper.cpp:349-377), match + similarity RANSAC for a chunk
of pairs as one batch (chunks spread over a device list), BestOf2Nearest
confidence, and the host-side component / chain-initialisation helpers.
"""

from __future__ import annotations

import heapq
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import match as M
from ..ops import ransac as R
from ..ops.features import Features
from ..runtime.device import placement


class PairGraph(NamedTuple):
    """Per-pair registration results (leading axis = pair)."""

    pairs: np.ndarray       # (P, 2) int frame indices (i, j)
    model: torch.Tensor     # (P, 3, 3) frame_i -> frame_j
    n_good: torch.Tensor    # (P,) ratio-test survivors
    n_inliers: torch.Tensor  # (P,)
    conf: torch.Tensor      # (P,) float32
    ok: torch.Tensor        # (P,) bool RANSAC success
    pts_a: torch.Tensor     # (P, K, 2) matched coords in frame i
    pts_b: torch.Tensor     # (P, K, 2) matched coords in frame j
    w: torch.Tensor         # (P, K) float32 inlier weights


def banded_pairs(n: int, range_width: int) -> List[Tuple[int, int]]:
    """|i - j| <= range_width pair schedule (ordered, j > i)."""
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if j - i <= range_width]


def all_pairs(n: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def gap_pairs(n: int, max_gap: int) -> List[Tuple[int, int]]:
    """The grouper's short-range graph: gaps 1..max_gap."""
    return [(i, i + g) for g in range(1, max_gap + 1) for i in range(n - g)]


def sample_banks(n_pairs: int, n_hyp: int, seed: int) -> torch.Tensor:
    """(P, n_hyp, 2) RANSAC sample integers from a seeded CPU generator
    (device independent, so a run on the card and one on the CPU draw the
    same samples)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return torch.randint(0, 2 ** 31 - 1, (n_pairs, n_hyp, 2), generator=g)


def register_pairs(feats: Features, pairs: List[Tuple[int, int]],
                   ratio: float, thresh: float, n_hyp: int = 1024,
                   chunk: int = 16, seed: int = 0,
                   banks: Optional[torch.Tensor] = None,
                   devices: Optional[Sequence[torch.device]] = None
                   ) -> PairGraph:
    """Match + similarity RANSAC for every (i, j) in ``pairs``.

    ``feats``: batched Features (leading frame axis); ``thresh`` is in
    feats.xy units. ``banks``: optional (P, n_hyp, 2) sample integers
    (default :func:`sample_banks` with ``seed``). Pairs run ``chunk`` at a
    time to bound the (chunk, n_hyp, K) residual bank.

    ``devices`` (pairgraph.py:82-121's mesh): chunk c runs on
    ``devices[c % N]`` and its results come back to ``devices[0]`` in pair
    order. Each chunk keeps ``chunk`` pairs and each pair its own bank, so
    every chunk has the single-device shapes and the results do not
    depend on N. The features live on ``devices[0]`` (default: their
    device alone).
    """
    p = len(pairs)
    if p == 0:
        raise ValueError("register_pairs: empty pair schedule")
    pa = np.asarray(pairs, np.int64)
    devices = placement(devices, feats.desc.device)
    home = devices[0]
    if banks is None:
        banks = sample_banks(p, n_hyp, seed)
    banks = banks.to(home)
    outs = []
    for c, c0 in enumerate(range(0, p, chunk)):
        dev = devices[c % len(devices)]
        ii = torch.from_numpy(pa[c0:c0 + chunk, 0]).to(feats.desc.device)
        jj = torch.from_numpy(pa[c0:c0 + chunk, 1]).to(feats.desc.device)
        da, va, xa, db, vb, xb = (a.to(dev) for a in (
            feats.desc[ii], feats.valid[ii], feats.xy[ii], feats.desc[jj],
            feats.valid[jj], feats.xy[jj]))
        m = M.knn2_ratio(da, va, db, vb, ratio)
        src, dst, good = M.gather_correspondences(xa, xb, m)
        res = R.ransac_similarity(src, dst, good,
                                  banks[c0:c0 + chunk].to(dev), thresh)
        n_good = good.sum(dim=-1)
        conf = M.pair_confidence(res.n_inliers.to(torch.float32),
                                 n_good.to(torch.float32))
        outs.append(tuple(a.to(home) for a in (
            res.model, n_good, res.n_inliers, conf, res.ok, src, dst,
            res.inliers.to(torch.float32))))
    model, n_good, n_inl, conf, ok, src, dst, w = (
        torch.cat([o[f] for o in outs]) for f in range(8))
    return PairGraph(pairs=pa, model=model, n_good=n_good, n_inliers=n_inl,
                     conf=conf, ok=ok, pts_a=src, pts_b=dst, w=w)


def biggest_component(n: int, pairs: np.ndarray,
                      keep: np.ndarray) -> List[int]:
    """Largest connected component of the kept-pair graph (host, tiny N);
    leaveBiggestComponent analog (stitch_robust.cpp:181)."""
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for (i, j), k in zip(pairs, keep):
        if k:
            parent[find(int(i))] = find(int(j))
    comps = {}
    for v in range(n):
        comps.setdefault(find(v), []).append(v)
    return max(comps.values(), key=len)


def chain_init(n: int, pairs: np.ndarray, models: np.ndarray,
               ok: np.ndarray, conf: np.ndarray) -> np.ndarray:
    """Initial frame->frame0 transforms by walking the best spanning edges
    (highest confidence first) from frame 0; unreachable frames get the
    identity. Returns (N, 3, 3) float32."""
    t = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    adj = {}
    for idx, (i, j) in enumerate(pairs):
        if not ok[idx]:
            continue
        adj.setdefault(int(i), []).append((float(conf[idx]), int(j), idx, 0))
        adj.setdefault(int(j), []).append((float(conf[idx]), int(i), idx, 1))
    visited = {0}
    heap = [(-c, 0, nb, idx, rev) for c, nb, idx, rev in adj.get(0, [])]
    heapq.heapify(heap)
    while heap:
        _, src, dst, idx, rev = heapq.heappop(heap)
        if dst in visited:
            continue
        m = models[idx]
        # model maps frame_i -> frame_j; we need dst -> src
        t[dst] = t[src] @ (np.linalg.inv(m) if rev == 0 else m)
        visited.add(dst)
        for c, nb, nidx, nrev in adj.get(dst, []):
            if nb not in visited:
                heapq.heappush(heap, (-c, dst, nb, nidx, nrev))
    return t
