"""The global stage's strip detect at the multi-line smoke's real size.

The port and the JAX package run their align detect on the same padded
strip: line 1 of ``chip_smoke.py``'s 3 x 10 sortie of 2160x3840 frames
(the ortho under the line, 2160 x 14208 in a 2560 x 14336 pad; a 422 x
2775 work image, the content part of a 500 x 2800 resize; the visible
preset's 3600-keypoint budget). The port drops
only the JAX package's shape-bucket pad of the work image, so the two
valid-keypoint counts must agree within 3%; the smoke's floor for K1's
global-detect check is held under 0.9 of the JAX package's count.
"""

import jax.numpy as jnp
import numpy as np
import torch

from torch_port_helpers import CPU

import chip_smoke as SM
from drone_image_stitch_cpp_tpu.pipeline import global_ as JG
from drone_image_stitch_cpp_tpu_torch.config.tuning import load_stitch_tuning
from drone_image_stitch_cpp_tpu_torch.pipeline import global_ as TG
from drone_image_stitch_cpp_tpu_torch.utils.synthetic import (
    fractal_ortho, render_sortie)


def test_global_detect_count_matches_jax_on_the_smoke_strip():
    # positions only: a zero-size ortho makes render_sortie's crops empty
    _, _, pos = render_sortie(np.zeros((0, 0, 3), np.float32), SM.ML_ROWS,
                              SM.ML_COLS, SM.FRAME_H, SM.FRAME_W, SM.OVERLAP,
                              overlap_y=SM.ML_OVERLAP_Y)
    ortho = fractal_ortho(SM.ML_ORTHO_H, SM.ORTHO_W, seed=0)
    padded, true_hw = SM._padded_strip(torch, CPU, ortho, pos, 1)
    del ortho
    assert tuple(padded.shape) == (2560, 14336, 3)
    assert true_hw == (2160, 14208)
    n_feats = load_stitch_tuning("visible").global_sift_features
    assert n_feats == 3600
    ft, _ = TG._detect_strip_dev(padded, true_hw, n_feats)
    fj, _ = JG._detect_strip_dev(jnp.asarray(padded.numpy()), true_hw,
                                 n_feats)
    n_port, n_jax = int(ft.valid.sum()), int(np.asarray(fj.valid).sum())
    assert abs(n_port - n_jax) <= 0.03 * n_jax, (n_port, n_jax)
    assert SM.K1_GLOBAL_MIN_VALID <= 0.9 * n_jax, n_jax
    assert SM.K1_GLOBAL_MIN_VALID <= n_port


def test_global_detect_count_matches_jax_on_a_flagship_strip():
    """The flagship's strips are 25.7k px wide, so the global detect's
    work image is 232 x 2759 (the 3 x 10 strip's: 422 x 2775) and finds
    about a third as many keypoints. A 2160 x 25728 strip of a seed-11
    fractal ortho (the flagship's seed and strip width; its own lines
    would need the 4.6 GB ortho) holds the port's count against JAX's and
    the smoke's floor under 0.9 of JAX's. The counts differ by the known
    detect padding (JAX's edge-mode shape buckets move keypoints near the
    borders, ROADMAP section 3), which weighs more on a 232-row image:
    572 against 591 (3.2%) when this test was written, so it allows 5%."""
    w = SM.FRAME_W + (SM.FLAG_COLS - 1) * int(SM.FRAME_W * (1 - SM.OVERLAP))
    ortho = fractal_ortho(SM.FRAME_H + 40, w + 32, seed=11)
    padded = torch.zeros((2560, 26112, 3), dtype=torch.uint8)
    padded[:SM.FRAME_H, :w] = torch.from_numpy(np.clip(
        ortho[16:16 + SM.FRAME_H, 16:16 + w], 0, 255).astype(np.uint8))
    del ortho
    true_hw = (SM.FRAME_H, w)
    assert true_hw == (2160, 25728)
    n_feats = load_stitch_tuning("visible").global_sift_features
    ft, _ = TG._detect_strip_dev(padded, true_hw, n_feats)
    fj, _ = JG._detect_strip_dev(jnp.asarray(padded.numpy()), true_hw,
                                 n_feats)
    n_port, n_jax = int(ft.valid.sum()), int(np.asarray(fj.valid).sum())
    assert abs(n_port - n_jax) <= 0.05 * n_jax, (n_port, n_jax)
    assert SM.FLAG_K1_GLOBAL_MIN_VALID <= 0.9 * n_jax, n_jax
    assert SM.FLAG_K1_GLOBAL_MIN_VALID <= n_port
