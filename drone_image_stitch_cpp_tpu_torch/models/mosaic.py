"""The registration "model step": detect -> match -> robust fit.

Port of ``drone_image_stitch_cpp_tpu/models/mosaic.py``, whose jitted
``pairwise_register`` ``__graft_entry__.entry()`` compiles as the JAX
repo's model forward. Here both are plain functions on tensors over the
port's detect (K1 on the card), ``ops/match.knn2_ratio`` /
``gather_correspondences`` and ``ops/ransac.ransac``. The JAX package
draws its RANSAC samples from ``jax.random.PRNGKey(0)``; the port draws
them from a ``torch.Generator`` (a CPU one seeded 0 unless given) or
takes an injected bank, as ``pipeline/pairgraph.register_pairs(banks=)``
does, so a test can hand both packages the same samples.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import match as M
from ..ops import ransac as R
from ..ops.features import Features, detect_and_describe_batched


def batched_detect(frames, device, max_kp: int = 512) -> Features:
    """Features of a (B, H, W) float32 gray batch in [0, 255] (numpy or a
    tensor), detected on ``device``; leading frame axis."""
    return detect_and_describe_batched(
        torch.as_tensor(frames, dtype=torch.float32, device=device), max_kp)


def pairwise_register(frames, device, max_kp: int = 512, n_hyp: int = 512,
                      kind: str = "similarity", ratio: float = 0.75,
                      thresh: float = 4.0,
                      generator: Optional[torch.Generator] = None,
                      bank: Optional[torch.Tensor] = None):
    """Register frames[1] onto frames[0].

    ``frames``: (2, H, W) float32 gray in [0, 255]. ``bank``: optional
    (n_hyp, m) non-negative RANSAC sample integers (m the model's minimal
    sample: 2 for a similarity); else drawn from ``generator`` (default a
    CPU generator seeded 0). Returns (model (3, 3), n_good, n_inliers,
    ok) as tensors on ``device``.
    """
    feats = batched_detect(frames, device, max_kp)
    m = M.knn2_ratio(feats.desc[0], feats.valid[0], feats.desc[1],
                     feats.valid[1], ratio)
    src, dst, good = M.gather_correspondences(feats.xy[0], feats.xy[1], m)
    if bank is None:
        if generator is None:
            generator = torch.Generator(device="cpu")
            generator.manual_seed(0)
        bank = torch.randint(0, 2 ** 31 - 1, (n_hyp, R.MIN_SAMPLES[kind]),
                             generator=generator,
                             device=generator.device)
    res = R.ransac(src[None], dst[None], good[None],
                   bank.to(src.device)[None], kind, thresh)
    return res.model[0], good.sum(), res.n_inliers[0], res.ok[0]
