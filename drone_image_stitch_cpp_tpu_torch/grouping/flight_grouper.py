"""Visual flight-line grouping: boustrophedon recovery from pixels alone.

Port of ``drone_image_stitch_cpp_tpu/grouping/flight_grouper.py``
(VisualFlightGrouper::groupBoustrophedon, visual_flight_grouper.cpp:
472-558). Only :func:`estimate_relations` touches the device: one batched
detect at the grouper's work resolution (<= 1800 px, feature budget
clamped to [600, 1800], :104-122) and one batched match + similarity
RANSAC over the gaps 1..3 motion graph (:349-377). The robust motion
statistics, near-duplicate removal, segment score table and strip DP are
host numpy, copied verbatim from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..config.tuning import StitchTuning
from ..ops.match import adaptive_ratio
from ..pipeline.pairgraph import gap_pairs, register_pairs
from ..pipeline.registration import detect_features
from ..runtime.device import device_sync
from ..runtime.logging import get_logger

_MAX_NEIGHBOR_GAP = 3      # reference :43
_MIN_SEGMENT_IMAGES = 2    # reference :44
_MAX_DIM = 1800            # reference :104
_MIN_RATIO = 0.28          # reference :204
_SCALE_RANGE = (0.8, 1.2)  # reference :207-209
_MAX_ROT_DEG = 25.0        # reference :210-213
_CUT_PENALTY = 3.0
_DUP_FRACTION = 0.22       # duplicate when gap-1 motion under this x median


@dataclass
class VisualRelation:
    """Per-edge motion estimate (reference: VisualRelation :14-29)."""

    i: int
    j: int
    ok: bool
    tx: float = 0.0
    ty: float = 0.0
    scale: float = 1.0
    rot: float = 0.0
    ratio: float = 0.0
    matches: int = 0
    inliers: int = 0

    @property
    def score(self) -> float:
        # reference :200-202
        return self.inliers + 20.0 * self.ratio + 0.02 * self.matches


@dataclass
class MotionStats:
    """Robust motion statistics (reference: MotionStats :31-41)."""

    valid: bool
    med_tx: float = 0.0
    med_ty: float = 0.0
    axis: int = 0          # 0: x dominant, 1: y dominant
    dup_thresh: float = 0.0
    step: float = 0.0      # median dominant-axis step


@dataclass
class VisualStripGroup:
    """One recovered flight line (reference hpp:10-13)."""

    indices: List[int] = field(default_factory=list)
    ids: List[str] = field(default_factory=list)


def estimate_relations(images: Optional[List[np.ndarray]],
                       tuning: StitchTuning, seed: int = 0,
                       device: Optional[torch.device] = None, store=None,
                       indices: Optional[List[int]] = None
                       ) -> List[VisualRelation]:
    """Batched short-range motion graph (gaps 1..3) on the device: the
    ``[VisualGroup] detect`` stage (``frames``; the card synchronised at
    its end, so ``register+fetch`` starts clean), ``register+fetch``, and
    the host decomposition as a ``segment`` span."""
    if store is not None:
        indices = list(indices if indices is not None
                       else range(len(store)))
        n = len(indices)
        h, w = store.shape0[:2]
    else:
        n = len(images)
        h, w = images[0].shape[:2]
    n_feats = int(np.clip(tuning.strip_sift_features, 600, 1800))  # :119-122
    mdim = max(h, w)
    mpx = (h * w) * min(1.0, (_MAX_DIM / mdim) ** 2) / 1e6
    log = get_logger()
    dev = store.device if store is not None else device
    end_sync = None if dev is None else device_sync(torch.device(dev))
    with log.timer("VisualGroup", "detect", frames=n):
        feats, scale = detect_features(images, n_feats, mpx, device=device,
                                       store=store, indices=indices)
        if end_sync is not None:
            end_sync()
    pairs = gap_pairs(n, min(_MAX_NEIGHBOR_GAP, n - 1))
    ratio = adaptive_ratio(tuning.match_conf)
    with log.timer("VisualGroup", "register+fetch"):
        graph = register_pairs(feats, pairs, ratio, thresh=4.0 / scale,
                               seed=seed)
        # one fetch of every per-edge scalar
        ok_h, ngood_h, ninl_h, models = (
            t.cpu().numpy() for t in (graph.ok, graph.n_good,
                                      graph.n_inliers, graph.model))
    with log.span("segment", stage="VisualGroup"):
        # decompose on host (visual_flight_grouper.cpp:190-199)
        m = models[:, :2, :]
        a_, b_ = m[:, 0, 0], m[:, 1, 0]
        c_, d_ = m[:, 0, 1], m[:, 1, 1]
        txs, tys = m[:, 0, 2], m[:, 1, 2]
        scs = 0.5 * (np.hypot(a_, b_) + np.hypot(c_, d_))
        rots = np.degrees(np.arctan2(b_, a_))
        rels = []
        for k, (i, j) in enumerate(graph.pairs):
            okk = bool(ok_h[k])
            tx, ty, sc, rot = (float(txs[k]), float(tys[k]), float(scs[k]),
                               float(rots[k]))
            n_good = int(ngood_h[k])
            n_inl = int(ninl_h[k])
            r = n_inl / max(1, n_good)
            sane = (r >= _MIN_RATIO
                    and _SCALE_RANGE[0] <= sc <= _SCALE_RANGE[1]
                    and abs(rot) <= _MAX_ROT_DEG
                    and n_good >= tuning.min_good_matches // 2
                    and n_inl >= tuning.min_inliers // 2)
            rels.append(VisualRelation(
                i=int(i), j=int(j), ok=okk and sane, tx=tx, ty=ty, scale=sc,
                rot=rot, ratio=r, matches=n_good, inliers=n_inl))
        return rels


def summarize_motion(rels: List[VisualRelation]) -> MotionStats:
    """Medians of gap-1 |tx|, |ty| -> dominant axis + thresholds (:233-271)."""
    steps = [(abs(r.tx), abs(r.ty)) for r in rels
             if r.ok and r.j - r.i == 1]
    if len(steps) < 1:
        return MotionStats(valid=False)
    med_tx = float(np.median([s[0] for s in steps]))
    med_ty = float(np.median([s[1] for s in steps]))
    axis = 0 if med_tx >= med_ty else 1
    step = med_tx if axis == 0 else med_ty
    if step < 1e-3:
        return MotionStats(valid=False)
    return MotionStats(valid=True, med_tx=med_tx, med_ty=med_ty, axis=axis,
                       dup_thresh=_DUP_FRACTION * step, step=step)


def find_duplicates(rels: List[VisualRelation], stats: MotionStats,
                    n: int) -> List[int]:
    """Gap-1 edges with near-zero motion mark frame j as duplicate
    (:289-295)."""
    dups = []
    for r in rels:
        if r.j - r.i != 1 or not r.ok:
            continue
        dom = abs(r.tx) if stats.axis == 0 else abs(r.ty)
        other = abs(r.ty) if stats.axis == 0 else abs(r.tx)
        if dom < stats.dup_thresh and other < max(stats.dup_thresh,
                                                  0.5 * stats.step):
            dups.append(r.j)
    return dups


def _segment_score_table(rels: List[VisualRelation], stats: MotionStats,
                         n: int) -> np.ndarray:
    """Score of treating [l, r] as one strip (:379-421).

    Stable in-window relations add their (normalized) score; failed edges
    penalize; direction conflicts on the dominant axis cost min(pos, neg)
    votes (a boustrophedon turn inside one segment flips the sign); edges
    whose off-axis (cross-track) motion dominates are turn/cross-line
    evidence and penalize any window that contains them.

    Every window sums its edges (i, j) in the reference's order, i then j
    ascending; the loops run over an edge's place in its window (i - l,
    j - i) and add it to all windows at once, so each window still takes
    its terms in that order and its float64 sum is the reference's to the
    bit (absent edges add 0.0).
    """
    gap = _MAX_NEIGHBOR_GAP
    by_edge = {(r.i, r.j): r for r in rels}
    # cross-track tolerance ~= 9% of the median along-track step (the
    # reference's logged stable_max_cross is 35 px at median_main 384)
    off_lim = max(8.0, 0.09 * stats.step)
    # term[i, k - 1]: what edge (i, i + k) adds to a window that holds it;
    # vote[i]: the direction vote of edge (i, i + 1)
    term = np.zeros((n, gap), np.float64)
    vote = np.zeros(n, np.int64)
    for (i, j), rel in by_edge.items():
        k = j - i
        if not (0 <= i and j < n and 1 <= k <= gap):
            continue
        if not rel.ok:
            term[i, k - 1] = -2.0
            continue
        dom = rel.tx if stats.axis == 0 else rel.ty
        off = rel.ty if stats.axis == 0 else rel.tx
        if abs(off) > off_lim:
            # cross-track motion inside one strip: turn evidence
            term[i, k - 1] = -4.0
            continue
        term[i, k - 1] = 1.0 + min(rel.score / 100.0, 1.0)
        if k == 1 and abs(dom) > stats.dup_thresh:
            vote[i] = 1 if dom > 0 else -1
    span = np.arange(n)[None, :] - np.arange(n)[:, None]    # [l, r]: r - l
    s = np.zeros((n, n), np.float64)
    pos = np.zeros((n, n), np.int64)
    neg = np.zeros((n, n), np.int64)
    for a in range(n):                     # the edge's i - l
        m = n - a                          # windows with l + a < n
        for k in range(1, min(gap, n - 1 - a) + 1):
            # the windows [l, r] that hold edge (l + a, l + a + k)
            inside = span[:m] >= a + k
            s[:m] += np.where(inside, term[a:, k - 1][:, None], 0.0)
            if k == 1:
                pos[:m] += inside & (vote[a:] > 0)[:, None]
                neg[:m] += inside & (vote[a:] < 0)[:, None]
    s -= 4.0 * np.minimum(pos, neg)        # direction-conflict penalty
    return np.where(span >= _MIN_SEGMENT_IMAGES - 1, s, -np.inf)


def _solve_best_segmentation(score: np.ndarray, n: int
                             ) -> Optional[List[tuple]]:
    """DP over cut positions with per-cut penalty (:423-469)."""
    best = np.full(n + 1, -np.inf)
    prev = np.full(n + 1, -1, np.int64)
    best[0] = 0.0
    for end in range(_MIN_SEGMENT_IMAGES, n + 1):
        for start in range(0, end - _MIN_SEGMENT_IMAGES + 1):
            if not np.isfinite(best[start]):
                continue
            sc = score[start, end - 1]
            if not np.isfinite(sc):
                continue
            cand = best[start] + sc - (_CUT_PENALTY if start > 0 else 0.0)
            if cand > best[end]:
                best[end] = cand
                prev[end] = start
    if not np.isfinite(best[n]):
        return None
    segs = []
    e = n
    while e > 0:
        s = int(prev[e])
        if s < 0:
            return None
        segs.append((s, e - 1))
        e = s
    return list(reversed(segs))


def group_boustrophedon(images: Optional[List[np.ndarray]], ids: List[str],
                        tuning: StitchTuning, seed: int = 0,
                        device: Optional[torch.device] = None, store=None
                        ) -> List[VisualStripGroup]:
    """Full grouping pipeline (reference :472-558).

    ``store``: optional runtime.feed.FrameStore of the same frames; the
    motion-graph detects then read its device-resident copies (``images``
    may be None). Otherwise ``images`` are detected on ``device``. The
    host steps after each motion graph (the motion summary, the near-
    duplicate filter, the segment table and the strip DP) are
    ``[VisualGroup] segment`` spans."""
    log = get_logger()
    n = len(images) if images is not None else len(store)
    if n == 0:
        return []
    if n == 1:
        return [VisualStripGroup(indices=[0], ids=[ids[0]])]

    active = list(range(n))
    for _round in range(4):  # iterative duplicate removal (ref. recursion)
        imgs = None if images is None else [images[k] for k in active]
        rels = estimate_relations(imgs, tuning, seed, device=device,
                                  store=store, indices=active)
        with log.span("segment", stage="VisualGroup"):
            for r in rels:
                log.log("VisualGroup", "edge", i=active[r.i],
                        j=active[r.j], ok=r.ok, tx=round(r.tx, 1),
                        ty=round(r.ty, 1), scale=round(r.scale, 3),
                        rot=round(r.rot, 2), inliers=r.inliers,
                        matches=r.matches, score=round(r.score, 1))
            stats = summarize_motion(rels)
            if not stats.valid:
                log.log("VisualGroup",
                        "invalid motion stats -> single strip")
                return [VisualStripGroup(indices=active,
                                         ids=[ids[k] for k in active])]
            dups = find_duplicates(rels, stats, len(active))
        if not dups or len(active) - len(dups) < 2:
            break
        log.log("VisualGroup", "removing near-duplicates",
                frames=[active[d] for d in dups])
        dup_set = set(dups)
        active = [k for idx, k in enumerate(active) if idx not in dup_set]
    else:
        imgs = None if images is None else [images[k] for k in active]
        rels = estimate_relations(imgs, tuning, seed, device=device,
                                  store=store, indices=active)
        with log.span("segment", stage="VisualGroup"):
            stats = summarize_motion(rels)

    m = len(active)
    if m == 1:
        return [VisualStripGroup(indices=active, ids=[ids[active[0]]])]
    with log.span("segment", stage="VisualGroup"):
        score = _segment_score_table(rels, stats, m)
        segs = _solve_best_segmentation(score, m)
    if segs is None:
        log.log("VisualGroup", "segmentation failed -> single strip")
        return [VisualStripGroup(indices=active,
                                 ids=[ids[k] for k in active])]
    groups = []
    for s, e in segs:
        idxs = [active[k] for k in range(s, e + 1)]
        groups.append(VisualStripGroup(indices=idxs,
                                       ids=[ids[k] for k in idxs]))
    log.log("VisualGroup", "strips",
            segments=[[g.indices[0], g.indices[-1]] for g in groups])
    return groups
