"""The global inter-strip stage and the multi-line app: the port vs the
JAX package on the CPU (same numpy inputs; JAX runs its XLA paths, as its
own tests do on the CPU).

Tolerances: exact where both packages do the same float32 operations in
the same order (mirror, kNN on a given distance matrix, ROI grids, the
content test, RANSAC decisions on one injected sample bank); 1e-3 on
models and on the global feed's weights, 1e-4 of each level's peak on its
pyramid sums and 1e-2 on its blend (other summation orders);
1e-4 relative on gains; 99.5% label agreement for the graph-cut seam,
whose coarse level is resized without cv2 (area and nearest sampling of
the port's own); +-2 px and a blurred RMSE of 3 between the two packages'
mosaics, and 8 against ground truth (test_pipeline.py's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, n, small_tunings, t

from drone_image_stitch_cpp_tpu.grouping.flight_grouper import (
    group_boustrophedon as jgroup)
from drone_image_stitch_cpp_tpu.ops import blend as JB
from drone_image_stitch_cpp_tpu.ops import color as JC
from drone_image_stitch_cpp_tpu.ops import exposure as JE
from drone_image_stitch_cpp_tpu.ops import features as JF
from drone_image_stitch_cpp_tpu.ops import match as JM
from drone_image_stitch_cpp_tpu.ops import ransac as JR
from drone_image_stitch_cpp_tpu.ops import seam as JS
from drone_image_stitch_cpp_tpu.ops.crop import (
    auto_crop_black_border as jcrop)
from drone_image_stitch_cpp_tpu.ops.warp import warp_affine as jwarp
from drone_image_stitch_cpp_tpu.pipeline import compose_feed as JCF
from drone_image_stitch_cpp_tpu.pipeline import global_ as JG
from drone_image_stitch_cpp_tpu.pipeline import roi_align as JRA
from drone_image_stitch_cpp_tpu.pipeline.strip import (
    estimate_strip_transforms as jestimate)
from drone_image_stitch_cpp_tpu.utils.synthetic import render_sortie
from drone_image_stitch_cpp_tpu_torch.app import stitch_frames
from drone_image_stitch_cpp_tpu_torch.ops import blend as TB
from drone_image_stitch_cpp_tpu_torch.ops import color as TC
from drone_image_stitch_cpp_tpu_torch.ops import exposure as TE
from drone_image_stitch_cpp_tpu_torch.ops import features as TF
from drone_image_stitch_cpp_tpu_torch.ops import match as TM
from drone_image_stitch_cpp_tpu_torch.ops import ransac as TR
from drone_image_stitch_cpp_tpu_torch.ops import seam as TS
from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as TWK
from drone_image_stitch_cpp_tpu_torch.pipeline import compose_feed as TCF
from drone_image_stitch_cpp_tpu_torch.pipeline import global_ as TG
from drone_image_stitch_cpp_tpu_torch.pipeline import roi_align as TRA
from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse


def _rng(seed=0):
    return np.random.default_rng(seed)


def _feats(r, k, width, height, lead=()):
    """Random feature arrays (numpy) with a (lead..., K) layout."""
    return dict(
        xy=np.stack([r.uniform(0, width, lead + (k,)),
                     r.uniform(0, height, lead + (k,))], -1).astype(
            np.float32),
        sigma=r.uniform(1.6, 9.0, lead + (k,)).astype(np.float32),
        angle=r.uniform(0, 2 * np.pi, lead + (k,)).astype(np.float32),
        response=r.uniform(0, 1, lead + (k,)).astype(np.float32),
        desc=r.uniform(0, 120, lead + (k, 128)).astype(np.float32),
        valid=r.random(lead + (k,)) < 0.9)


def _jf(d):
    return JF.Features(**{k: jnp.asarray(v) for k, v in d.items()})


def _tf(d):
    return TF.Features(**{k: t(v) for k, v in d.items()})


# ---- (d) mirror_features, knn2_ratio_from_d2 ------------------------------

def test_mirror_features_matches_jax():
    d = _feats(_rng(1), 300, 777.0, 240.0, lead=(2,))
    mj = JF.mirror_features(_jf(d), 777)
    mt = TF.mirror_features(_tf(d), 777)
    for name in ("xy", "desc", "sigma", "response", "valid"):
        np.testing.assert_array_equal(n(getattr(mt, name)),
                                      n(getattr(mj, name)), err_msg=name)
    np.testing.assert_allclose(n(mt.angle), n(mj.angle), atol=1e-6)


def test_knn2_ratio_from_d2_matches_jax():
    r = _rng(2)
    d2 = r.uniform(0, 1e4, (96, 80)).astype(np.float32)
    d2[5, [3, 17]] = 1.0          # tied nearest
    d2[9, [4, 8, 60]] = 7.0       # tied nearest and second
    va = r.random(96) < 0.9
    vb = r.random(80) < 0.85
    mj = JM.knn2_ratio_from_d2(jnp.asarray(d2), jnp.asarray(va),
                               jnp.asarray(vb), 0.8)
    mt = TM.knn2_ratio_from_d2(t(d2), t(va), t(vb), 0.8)
    np.testing.assert_array_equal(n(mt.good), n(mj.good))
    np.testing.assert_array_equal(n(mt.idx), n(mj.idx))
    np.testing.assert_array_equal(n(mt.dist), n(mj.dist))
    np.testing.assert_array_equal(n(mt.dist2), n(mj.dist2))


# ---- (e) affine RANSAC and the banked ROI alignment -------------------------

def test_affine_ransac_same_bank_same_result():
    from test_ops_ransac import _make_problem
    src, dst, good, _ = _make_problem("affine")
    key = jax.random.PRNGKey(4)
    n_hyp = 512
    res_j = JR.ransac(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(good),
                      key, "affine", thresh=4.0, n_hyp=n_hyp)
    raw = np.asarray(jax.random.randint(key, (n_hyp, 3), 0,
                                        np.iinfo(np.int32).max))
    res_t = TR.ransac(t(src)[None], t(dst)[None], t(good)[None],
                      t(raw)[None], "affine", 4.0)
    assert bool(res_t.ok[0]) and bool(res_j.ok)
    np.testing.assert_array_equal(n(res_t.inliers[0]), n(res_j.inliers))
    assert int(res_t.n_inliers[0]) == int(res_j.n_inliers)
    np.testing.assert_allclose(n(res_t.model[0]), n(res_j.model), atol=1e-3)


def _jax_bank(seed):
    """The sample integers JAX's _banked_align draws for (2 variants) x
    (16 hypotheses) x 1024 samples x 3 points from PRNGKey(seed)."""
    kv = jax.random.split(jax.random.PRNGKey(seed), 2)
    return np.stack([np.stack([
        np.asarray(jax.random.randint(k, (1024, 3), 0,
                                      np.iinfo(np.int32).max))
        for k in jax.random.split(kv[v], JRA.N_HYP_MAX)])
        for v in range(2)])


def _pair_problem(seed, flip=False):
    """Reference and current strip features of one strip pair: 260
    correspondences under a cur -> ref affine (overlap band) plus random
    keypoints, current descriptors = reference ones + noise. ``flip``:
    the current strip is mirrored (its features are a reversed line)."""
    r = _rng(seed)
    ref_shape, cur_shape = (300, 900), (300, 880)
    model = np.asarray([[0.998, 0.012, 11.0], [-0.009, 1.001, 171.0],
                        [0, 0, 1]], np.float64)
    k, m = 400, 260
    ref = _feats(r, k, 900.0, 300.0, lead=(1,))
    ref["valid"][:] = True
    cur = _feats(r, k, 880.0, 300.0, lead=(1,))
    cur["valid"][:] = True
    # correspondences: cur points in the band that lands on ref rows >= 171
    cxy = np.stack([r.uniform(20, 860, m), r.uniform(0, 120, m)], -1)
    rxy = cxy @ model[:2, :2].T + model[:2, 2]
    cur["xy"][0, :m] = cxy
    ref["xy"][0, :m] = rxy
    cur["desc"][0, :m] = ref["desc"][0, :m] + r.normal(0, 2.0, (m, 128))
    if flip:
        cur["xy"][0, :, 0] = 880.0 - 1.0 - cur["xy"][0, :, 0]
        d = cur["desc"].reshape(1, k, 4, 4, 8)[:, :, ::-1]
        d = np.concatenate([d[..., :1], d[..., 1:][..., ::-1]], -1)
        cur["desc"] = np.ascontiguousarray(d.reshape(1, k, 128))
    return ref, cur, ref_shape, cur_shape


@pytest.mark.parametrize("flip", [False, True])
def test_align_pair_banked_same_bank_same_result(flip):
    jt, tt = small_tunings()
    ref, cur, ref_shape, cur_shape = _pair_problem(7, flip)
    seed = 3
    fj, cj = _jf(ref), _jf(cur)
    dj, flj = JRA.align_pair_banked(fj, 1.0, cj,
                                    JF.mirror_features(cj, cur_shape[1]),
                                    ref_shape, cur_shape, jt, seed)
    ft, ct = _tf(ref), _tf(cur)
    dt, flt = TRA.align_pair_banked(ft, 1.0, ct,
                                    TF.mirror_features(ct, cur_shape[1]),
                                    ref_shape, cur_shape, tt, seed,
                                    raw=t(_jax_bank(seed)))
    for ej, et in ((dj, dt), (flj, flt)):
        assert (et.ok, et.inliers, et.matches) == (ej.ok, ej.inliers,
                                                   ej.matches)
        assert et.ratio == pytest.approx(ej.ratio, abs=1e-12)
        if ej.ok:
            np.testing.assert_allclose(et.model, ej.model, atol=1e-3)
    winner = flt if flip else dt
    assert winner.ok and winner.inliers >= 200


# ---- (f) ROI grid -----------------------------------------------------------

def test_roi_candidates_and_hyp_bank_match_jax():
    shapes = [(600, 1000), (150, 150), (119, 500), (2160, 14208),
              (121, 121), (300, 180), (4968, 14208)]
    for s in shapes:
        assert TRA.roi_candidates(s) == JRA.roi_candidates(s)
        for s2 in shapes:
            bt, nt = TRA.build_hyp_bank(s, s2)
            bj, nj = JRA.build_hyp_bank(s, s2)
            assert nt == nj
            np.testing.assert_array_equal(bt, bj)


# ---- (g) gain chain and exposure --------------------------------------------

def _seam_images(seed=5, n_=3, h=90, w=140):
    r = _rng(seed)
    base = r.uniform(20, 230, (h, w, 3)).astype(np.float32)
    imgs, masks = [], []
    for i in range(n_):
        m = np.zeros((h, w), bool)
        m[i * 25:i * 25 + 45, :] = True
        gain = np.asarray([1.0 + 0.07 * i, 1.0 - 0.04 * i, 1.0 + 0.02 * i],
                          np.float32)
        img = np.where(m[..., None], base * gain
                       + r.normal(0, 1.0, base.shape), 0.0)
        imgs.append(img.astype(np.float32))
        masks.append(m)
    return imgs, masks


def test_gain_chain_and_channels_compensate_match_jax():
    imgs, masks = _seam_images()
    for scale in (1.0, 0.05):       # 0.05: every overlap inherits
        gj = JG._gain_chain([jnp.asarray(i) for i in imgs],
                            [jnp.asarray(m) for m in masks], 3, scale)
        gt_ = TG._gain_chain([t(i) for i in imgs], [t(m) for m in masks], 3,
                             scale)
        np.testing.assert_allclose(gt_, np.asarray(gj), rtol=1e-4)
    cj = JE.channels_compensate(jnp.asarray(np.stack(imgs)),
                                jnp.asarray(np.stack(masks)), 0.95)
    ct = TE.channels_compensate(t(np.stack(imgs)), t(np.stack(masks)), 0.95)
    np.testing.assert_allclose(n(ct), np.asarray(cj), rtol=1e-4)


# ---- (h) the cv2-free graph-cut seam ----------------------------------------

def _gc_problems():
    from test_graphcut import _smooth_pair
    r = _rng(1)
    h, w = 64, 96
    base = r.uniform(0, 255, (h, w, 3)).astype(np.float32)
    a, b = base.copy(), base.copy()
    b[:, :40] += 60
    b[:, 56:] -= 60
    ma = np.zeros((h, w), bool)
    mb = np.zeros((h, w), bool)
    ma[:, :88] = True
    mb[:, 8:] = True
    probs = [(a, b, ma, mb)]
    a, b = _smooth_pair(160, 240, 11)
    yy, xx = np.mgrid[:160, :240]
    a[((yy - 80) ** 2 + (xx - 120) ** 2) < 400] = 255.0
    b[((yy - 80) ** 2 + (xx - 132) ** 2) < 400] = 255.0
    ma = np.zeros((160, 240), bool)
    mb = np.zeros((160, 240), bool)
    ma[:, :210] = True
    mb[:, 30:] = True
    probs.append((a, b, ma, mb))
    # above GC_COARSE_NODES: the banded full-resolution re-solve
    h, w = 320, 480
    a, b = _smooth_pair(h, w, 7)
    ma = np.zeros((h, w), bool)
    mb = np.zeros((h, w), bool)
    ma[:, :3 * w // 4] = True
    mb[:, w // 4:] = True
    probs.append((a, b, ma, mb))
    return probs


def test_graphcut_labels_agree_with_jax():
    probs = _gc_problems()
    assert probs[-1][0].shape[0] * probs[-1][0].shape[1] > TS.GC_COARSE_NODES
    for a, b, ma, mb in probs:
        gj = JS.graphcut_pairwise_seam(a, b, ma, mb)
        gt_ = TS.graphcut_pairwise_seam(t(a), t(b), t(ma), t(mb))
        assert gj is not None and gt_ is not None
        gt_ = [n(m) for m in gt_]
        both = ma & mb
        agree = float((gt_[0][both] == gj[0][both]).mean())
        assert agree >= 0.995, agree
        assert not (gt_[0] & gt_[1]).any()
        np.testing.assert_array_equal(gt_[0] | gt_[1], ma | mb)
    img = np.zeros((16, 16, 3), np.float32)
    mask = np.ones((16, 16), bool)
    assert TS.graphcut_pairwise_seam(t(img), t(img), t(mask), t(mask)) \
        is None


def test_find_seams_graphcut_and_dp_fallback():
    a, b, ma, mb = _gc_problems()[1]
    methods = {}
    got = TS.find_seams_sequential([t(a), t(b)], [t(ma), t(mb)],
                                   ["vertical"], method="graphcut",
                                   methods=methods)
    assert methods == {(0, 1): "graphcut"}
    ref = JS.find_seams_sequential([jnp.asarray(a), jnp.asarray(b)],
                                   [jnp.asarray(ma), jnp.asarray(mb)],
                                   ["vertical"], method="graphcut")
    both = ma & mb
    assert float((n(got[0])[both] == np.asarray(ref[0])[both]).mean()) \
        >= 0.995
    # nested masks: no exclusive region anchors a terminal -> the DP seam
    methods = {}
    TS.find_seams_sequential([t(a), t(b)], [t(ma), t(ma.copy())],
                             ["vertical"], method="graphcut",
                             methods=methods)
    assert methods == {(0, 1): "dp"}


# ---- (i) the global compose feed --------------------------------------------

def test_content_mask_decides_like_jax_on_every_pixel():
    v = np.arange(256, dtype=np.uint8)
    b, g, r = np.meshgrid(v, v, v, indexing="ij")
    px = np.stack([b, g, r], -1).reshape(4096, 4096, 3)
    got = n(TC.content_mask(torch.from_numpy(px)))
    want = np.asarray(JC.nonblack_mask(jnp.asarray(px.astype(np.float32)),
                                       2.0))
    np.testing.assert_array_equal(got, want)
    edge = torch.tensor([[[2, 2, 2], [3, 3, 3], [17, 0, 0], [18, 0, 0]]],
                        dtype=torch.uint8)
    assert n(TC.content_mask(edge)).tolist() == [[False, True, False, True]]


def _feed_inputs():
    r = _rng(9)
    img = r.integers(0, 256, (120, 200, 3)).astype(np.uint8)
    img[:, :30] = 0                                   # black wedge
    for k, px in enumerate([(2, 2, 2), (3, 3, 3), (2, 3, 2), (1, 2, 3),
                            (17, 0, 0), (18, 0, 0)]):
        img[10 + 15 * k:22 + 15 * k, 40:120] = px     # gray near 2 and 3
    th = np.radians(1.5)
    t_full = np.asarray([[np.cos(th), -np.sin(th), 21.3],
                         [np.sin(th), np.cos(th), 9.7]], np.float32)
    seam = r.random((70, 110)) < 0.7
    return img, t_full, seam


def test_content_mode_warp_matches_jax():
    img, t_full, _ = _feed_inputs()
    wt, mt = TWK.warp_frame(t(img), t_full, 160, 256, content="nonblack")
    cj = JC.nonblack_mask(jnp.asarray(img.astype(np.float32)), 2.0)
    mj = jwarp(cj.astype(jnp.float32), jnp.asarray(t_full), 160, 256)
    wj = jwarp(jnp.asarray(img.astype(np.float32)), jnp.asarray(t_full),
               160, 256)
    np.testing.assert_allclose(n(mt), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(n(wt), np.asarray(wj), atol=1e-3)
    assert 0.2 < float((n(mt) >= 0.999).mean()) < 0.9


def test_global_feed_matches_jax():
    img, t_full, seam = _feed_inputs()
    gain = np.asarray([1.07, 0.95, 1.02], np.float32)
    args = (t_full, 64, 32, 64.0, 32.0, 0.5, 128, 256)
    cj = JCF.feed_frame(JB.mb_prepare(256, 320, 3), jnp.asarray(img),
                        jnp.asarray(seam), *args, mode="global",
                        chan_gain=gain)
    ct = TCF.feed_frame(TB.mb_prepare(256, 320, 3, CPU), t(img), t(seam),
                        *args, mode="global", chan_gain=gain)
    for lvl in range(4):
        np.testing.assert_allclose(n(ct.wacc[lvl]), np.asarray(cj.wacc[lvl]),
                                   atol=1e-3, err_msg=f"wacc {lvl}")
        # the Laplacian sums divide by the content mask's pyramid, which is
        # small next to the dark bands: two summation orders differ there
        # by ~2e-5 of the level's peak, so hold each level to 1e-4 of it
        want = np.asarray(cj.acc[lvl])
        np.testing.assert_allclose(n(ct.acc[lvl]), want,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"acc {lvl}")
    assert float(n(ct.wacc[0]).max()) > 0.5
    # the blended window in pixel units
    oj, _ = JB.mb_blend(cj, 256, 320)
    ot, _ = TB.mb_blend(ct, 256, 320)
    np.testing.assert_allclose(n(ot), np.asarray(oj), atol=1e-2)


# ---- (j) align_strips and stitch_inter_strips_custom ------------------------

def test_align_strips_flip_hypothesis(ortho):
    _, tt = small_tunings()
    strip_a = ortho[40:200, 40:500].astype(np.uint8)
    strip_b = ortho[120:280, 40:500].astype(np.uint8)[:, ::-1].copy()
    transforms, oriented, flipped = TG.align_strips([strip_a, strip_b], tt,
                                                    CPU)
    assert flipped == [False, True]
    assert np.array_equal(oriented[1],
                          ortho[120:280, 40:500].astype(np.uint8))
    tr = transforms[1]
    assert abs(tr[0, 2]) < 2.0 and abs(tr[1, 2] - 80.0) < 2.0, tr
    assert abs(tr[0, 0] - 1.0) < 0.01, tr


def test_global_compose_two_strips_matches_jax(ortho):
    jt, tt = small_tunings()
    strip_a = ortho[40:200, 40:500].astype(np.uint8)
    strip_b = ortho[120:280, 40:500].astype(np.uint8)
    info = {}
    mt = TG.stitch_inter_strips_custom([strip_a, strip_b], tt, device=CPU,
                                       info=info)
    mj = jcrop(JG.stitch_inter_strips_custom([strip_a, strip_b], jt))
    assert info["seam_methods"] == {(0, 1): "graphcut"}
    assert info["flipped"] == [False, False]
    assert abs(mt.shape[0] - mj.shape[0]) <= 2
    assert abs(mt.shape[1] - mj.shape[1]) <= 2
    assert gt_rmse(mt, mj, search=3)[0] < 3.0
    gt = ortho[40:280, 40:500].astype(np.uint8)
    assert gt_rmse(mt, gt, search=3)[0] < 8.0
    with pytest.raises(TG.GlobalStitchError):
        TG.stitch_inter_strips_custom([strip_a], tt, device=CPU)


# ---- (k) the multi-line app end to end ---------------------------------------

def test_app_two_lines_matches_jax(ortho):
    imgs, ids, pos = render_sortie(ortho, 2, 4, frame_h=160, frame_w=208,
                                   overlap=0.7, overlap_y=0.3)
    jt, tt = small_tunings()
    res = stitch_frames(imgs, ids, tt, "cpu")
    gj = jgroup(imgs, ids, jt)
    assert [g.indices for g in res.groups] == [g.indices for g in gj]
    assert res.strip_kept == [[0, 1, 2, 3], [4, 5, 6, 7]]
    strip_jt = jt.replace(sift_features=jt.strip_sift_features)
    for g, tr in zip(gj, res.strip_transforms):
        _, tj, _ = jestimate([imgs[k] for k in g.indices], strip_jt,
                             jt.range_width)
        np.testing.assert_allclose(tr[:, :, 2], np.asarray(tj)[:, :, 2],
                                   atol=1.0)
    assert res.flipped == [False, False]
    step_y = pos[4][0] - pos[0][0]
    np.testing.assert_allclose(res.global_transforms[1][:2, 2],
                               [0.0, step_y], atol=2.0)
    assert res.seam_methods == {(0, 1): "graphcut"}
    h = step_y + 160
    w = 208 + 3 * (pos[1][1] - pos[0][1])
    assert abs(res.panorama.shape[0] - h) <= 4
    assert abs(res.panorama.shape[1] - w) <= 4
    gt = ortho[40:40 + h, 40:40 + w].astype(np.uint8)
    assert gt_rmse(res.panorama, gt, search=4)[0] < 8.0
