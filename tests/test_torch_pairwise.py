"""The two-frame stitch and the perspective warp: the port vs the JAX
package on the CPU (same numpy inputs).

  * ``warp_perspective`` for a real homography: at most 0.05 levels on
    99.9% of pixels and 1 level anywhere (measured: 0.0046 at the 99.9th
    percentile, 0.0072 at most). The port inverts the 3x3 matrix with
    ``torch.linalg.inv`` in float32, JAX with ``jnp.linalg.inv``: the two
    inverses differ by ulps (up to 2e-6 in the translation), which moves
    samples by ~1e-6 px;
  * ``border_feather_weight`` and ``feather_blend``: equal to JAX's;
  * ``stitch_pair`` on test_pipeline.py's pair (render_sortie(ortho, 1, 2,
    192, 256, 0.5)) in similarity and homography mode, with JAX's RANSAC
    sample banks injected: the same good-match and inlier counts, models
    within 0.05 px at the frame corners, the same panorama shape, and a
    mean absolute difference between the two panoramas below 1 level
    (measured: 0.0016 in similarity and 0.0066 in homography mode, at most
    1 level at any pixel; printed by the test). The keypoint counts agree within
    6% (measured 87 / 79 against JAX's 89 / 83): the JAX package pads the
    192-row frames to its 256-row shape bucket (edge mode), which moves
    keypoints near the bottom border; the port detects at the exact size
    (``ROADMAP.md`` section 3);
  * a non-overlapping pair fails the gates in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import CPU, n, small_tunings, t

from drone_image_stitch_cpp_tpu.ops import blend as JB
from drone_image_stitch_cpp_tpu.ops import ransac as JR
from drone_image_stitch_cpp_tpu.ops.warp import (
    warp_perspective as jwarp_persp)
from drone_image_stitch_cpp_tpu.pipeline import pairwise as JP
from drone_image_stitch_cpp_tpu.utils.synthetic import render_sortie
from drone_image_stitch_cpp_tpu_torch.ops import blend as TB
from drone_image_stitch_cpp_tpu_torch.ops import ransac as TR
from drone_image_stitch_cpp_tpu_torch.ops.transform import (
    affine_to_h3, apply_homography_pts, image_corners)
from drone_image_stitch_cpp_tpu_torch.ops.warp import (
    warp_perspective as twarp_persp)
from drone_image_stitch_cpp_tpu_torch.pipeline import pairwise as TP


def _jax_bank(seed, m):
    """The sample integers JAX's ransac draws from PRNGKey(seed)."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                         (1024, m), 0,
                                         np.iinfo(np.int32).max))


def _banks(seed=0):
    return {kind: _jax_bank(seed, m) for kind, m in TR.MIN_SAMPLES.items()}


def test_warp_perspective_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (97, 131, 3)).astype(np.float32)
    h = np.asarray([[0.98, 0.03, 12.5], [-0.02, 1.01, -7.25],
                    [1e-4, -5e-5, 1.0]], np.float32)
    wj = n(jwarp_persp(jnp.asarray(img), jnp.asarray(h), 120, 150))
    wt = n(twarp_persp(t(img), h, 120, 150))
    d = np.abs(wt - wj)
    assert np.quantile(d, 0.999) <= 0.05 and d.max() <= 1.0, d.max()
    assert (wt > 0).mean() > 0.5          # the frame lands in the window
    # an affine lifted to 3x3 warps like the affine (the lift is exact)
    a = np.asarray([[1.0, 0.0, 3.5], [0.0, 1.0, -2.25]], np.float32)
    h3 = n(affine_to_h3(t(a)))
    np.testing.assert_array_equal(h3, np.vstack([a, [0, 0, 1]]))
    corners = apply_homography_pts(t(h3), image_corners(97, 131))
    np.testing.assert_allclose(n(corners), [[3.5, -2.25], [133.5, -2.25],
                                            [133.5, 93.75], [3.5, 93.75]])


def test_feather_weight_and_blend_match_jax():
    for hw in ((37, 53), (192, 256)):
        np.testing.assert_array_equal(n(TB.border_feather_weight(*hw)),
                                      n(JB.border_feather_weight(*hw)))
    rng = np.random.default_rng(1)
    imgs = [rng.uniform(0, 255, (40, 60, 3)).astype(np.float32)
            for _ in range(2)]
    ws = [rng.uniform(0, 1, (40, 60)).astype(np.float32) for _ in range(2)]
    ws[0][:10] = 0.0
    ws[1][:5] = 0.0                  # rows 0-4 covered by neither
    oj, cj = JB.feather_blend([jnp.asarray(a) for a in imgs],
                              [jnp.asarray(w) for w in ws])
    ot, ct = TB.feather_blend([t(a) for a in imgs], [t(w) for w in ws])
    np.testing.assert_array_equal(n(ot), n(oj))
    np.testing.assert_array_equal(n(ct), n(cj))
    assert not n(ct)[:5].any() and n(ct)[5:].all()


@pytest.fixture(scope="module")
def pair(ortho):
    imgs, _, _ = render_sortie(ortho, 1, 2, frame_h=192, frame_w=256,
                               overlap=0.5)
    return imgs


def _corner_err(mt, mj, h, w):
    c = image_corners(h, w)
    return float(np.abs(n(apply_homography_pts(t(mt), c))
                        - n(apply_homography_pts(t(mj), c))).max())


@pytest.mark.parametrize("kind", ["similarity", "homography"])
def test_stitch_pair_matches_jax(pair, kind):
    a, b = pair
    jt, tt = small_tunings()
    banks = _banks()
    dt, mt, rt, ft, st = TP.compute_pair_diagnostics(a, b, tt, 0, CPU, banks)
    dj, mj, rj, fj, sj = JP.compute_pair_diagnostics(a, b, jt, 0)
    assert (dt.good_matches, dt.inliers) == (dj.good_matches, dj.inliers)
    for kt, kj in ((dt.kp_a, dj.kp_a), (dt.kp_b, dj.kp_b)):
        assert abs(kt - kj) <= 0.06 * kj, (dt, dj)
    assert TP.pair_gates_pass(dt, tt) and JP.pair_gates_pass(dj, jt)
    assert _corner_err(mt, mj, 192, 256) <= 0.05
    if kind != "homography":     # the refit stitch_pair makes
        m_t, src, dst, good = TP._correspondences(ft)
        res_t = TR.ransac(src[None], dst[None], good[None],
                          t(banks[kind])[None], kind, thresh=4.0 / st)
        mj_ = JP.M.knn2_ratio(fj.desc[0], fj.valid[0], fj.desc[1],
                              fj.valid[1], 0.75)
        res_j = JR.ransac(*JP.M.gather_correspondences(fj.xy[0], fj.xy[1],
                                                       mj_),
                          jax.random.PRNGKey(0), kind, thresh=4.0 / sj)
        assert int(res_t.n_inliers[0]) == int(res_j.n_inliers)
        assert _corner_err(n(res_t.model[0]), n(res_j.model), 192, 256) \
            <= 0.05
    pt = TP.stitch_pair(a, b, tt, model_kind=kind, device=CPU, raw=banks)
    pj = JP.stitch_pair(a, b, jt, model_kind=kind)
    assert pt.dtype == np.uint8 and pt.shape == pj.shape
    mad = float(np.abs(pt.astype(np.int16) - pj).mean())
    print(f"stitch_pair {kind}: panorama {pt.shape}, mean |port - JAX| "
          f"{mad:.4f} levels, max {int(np.abs(pt.astype(int) - pj).max())}")
    assert mad < 1.0
    # test_pipeline.py's geometry: 192 x (256 + 128)
    assert abs(pt.shape[0] - 192) <= 3 and abs(pt.shape[1] - 384) <= 4


def test_stitch_pair_seeded_without_banks(pair):
    """Without injected banks the port draws from its own generator: the
    same run twice is identical, and the geometry holds."""
    a, b = pair
    _, tt = small_tunings()
    p1 = TP.stitch_pair(a, b, tt, device=CPU, seed=3)
    p2 = TP.stitch_pair(a, b, tt, device=CPU, seed=3)
    np.testing.assert_array_equal(p1, p2)
    assert abs(p1.shape[0] - 192) <= 3 and abs(p1.shape[1] - 384) <= 4
    uncropped = TP.stitch_pair(a, b, tt, device=CPU, seed=3, autocrop=False)
    assert uncropped.shape[0] >= p1.shape[0]
    assert uncropped.shape[1] >= p1.shape[1]


def test_stitch_pair_gate_failure_matches_jax(ortho):
    a = ortho[0:160, 0:208].astype(np.uint8)
    b = ortho[400:560, 600:808].astype(np.uint8)
    jt, tt = small_tunings()
    with pytest.raises(RuntimeError, match="pair gates failed"):
        JP.stitch_pair(a, b, jt)
    with pytest.raises(RuntimeError, match="pair gates failed"):
        TP.stitch_pair(a, b, tt, device=CPU, raw=_banks())
    dt = TP.compute_pair_diagnostics(a, b, tt, device=CPU)[0]
    assert not TP.pair_gates_pass(dt, tt)
