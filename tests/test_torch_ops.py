"""PyTorch port vs the JAX package: leaf ops, matching, RANSAC, bundle
adjustment, exposure, seams, blending, crop — same numpy inputs, CPU.

Tolerances: float32 ops in the same order agree to 1e-5 relative;
matmul-based ones (Toeplitz blur, resize, gray) are allowed a few ulps of
the 0..255 range (1e-3 absolute) for the other summation order.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t

from drone_image_stitch_cpp_tpu.ops import blend as JB
from drone_image_stitch_cpp_tpu.ops import color as JC
from drone_image_stitch_cpp_tpu.ops import crop as JCR
from drone_image_stitch_cpp_tpu.ops import exposure as JE
from drone_image_stitch_cpp_tpu.ops import gaussian as JG
from drone_image_stitch_cpp_tpu.ops import match as JM
from drone_image_stitch_cpp_tpu.ops import ransac as JR
from drone_image_stitch_cpp_tpu.ops import resize as JRS
from drone_image_stitch_cpp_tpu.ops import seam as JS
from drone_image_stitch_cpp_tpu.ops import transform as JT
from drone_image_stitch_cpp_tpu.pipeline import bundle as JBA
from drone_image_stitch_cpp_tpu_torch.ops import blend as TB
from drone_image_stitch_cpp_tpu_torch.ops import color as TC
from drone_image_stitch_cpp_tpu_torch.ops import crop as TCR
from drone_image_stitch_cpp_tpu_torch.ops import exposure as TE
from drone_image_stitch_cpp_tpu_torch.ops import gaussian as TG
from drone_image_stitch_cpp_tpu_torch.ops import match as TM
from drone_image_stitch_cpp_tpu_torch.ops import ransac as TR
from drone_image_stitch_cpp_tpu_torch.ops import resize as TRS
from drone_image_stitch_cpp_tpu_torch.ops import seam as TS
from drone_image_stitch_cpp_tpu_torch.ops import transform as TT
from drone_image_stitch_cpp_tpu_torch.pipeline import bundle as TBA

_PORT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "drone_image_stitch_cpp_tpu_torch")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(n(a), n(b), atol=atol, rtol=rtol)


def test_port_imports_no_jax():
    """No module of the port imports jax (directly, via the JAX package,
    whose __init__ imports jax, or via the repo's top-level ``tools`` /
    ``bench_*`` harness modules, which import the JAX package inside
    their functions)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|drone_image_stitch_cpp_"
                     r"tpu(\.|\s|$)|tools\b|bench_sortie\b|bench_parity\b|"
                     r"bench\b)", re.M)
    offenders = []
    for root, _, files in os.walk(_PORT):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        offenders.append(os.path.relpath(path, _PORT))
    assert not offenders, offenders


def test_tuning_from_jax_dict_matches_presets():
    from drone_image_stitch_cpp_tpu.config.tuning import (
        load_stitch_tuning as jload, tuning_as_dict)
    from drone_image_stitch_cpp_tpu_torch.config.tuning import (
        from_jax_dict, load_stitch_tuning as tload,
        tuning_as_dict as ttuning_as_dict)
    not_carried = {"use_opencl", "try_gpu"}
    for mod in ("visible", "NIR", "thermal", "unknown"):
        jd = tuning_as_dict(jload(mod))
        carried = {k: v for k, v in jd.items() if k not in not_carried}
        assert ttuning_as_dict(from_jax_dict(jd)) == carried
        assert ttuning_as_dict(tload(mod)) == carried
    with pytest.raises(ValueError):
        from_jax_dict({"sift_features": 10})
    jd = tuning_as_dict(jload("visible"))
    for key, value in (("try_gpu", False), ("use_opencl", False),
                       ("no_such_knob", 1)):
        with pytest.raises(ValueError, match=key):
            from_jax_dict({**jd, key: value})
    # the sequential ladder's knobs are carried
    tt = from_jax_dict({**jd, "use_anchor_fallback": True,
                        "anchor_window": 2})
    assert tt.use_anchor_fallback is True and tt.anchor_window == 2


def test_color_ops():
    img = _rng(1).uniform(0, 255, (37, 53, 3)).astype(np.float32)
    _close(TC.bgr_to_gray(t(img)), JC.bgr_to_gray(jnp.asarray(img)), 1e-3)
    np.testing.assert_array_equal(
        n(TC.nonblack_mask(t(img), 120.0)),
        n(JC.nonblack_mask(jnp.asarray(img), 120.0)))
    g = np.asarray([1.2, 0.8, 1.05], np.float32)
    _close(TC.apply_channel_gains(t(img), t(g)),
           JC.apply_channel_gains(jnp.asarray(img), jnp.asarray(g)), 1e-4)


@pytest.mark.parametrize("shape,out", [((60, 90), (30, 45)),
                                       ((67, 93), (31, 40)),
                                       ((67, 93), (131, 200)),
                                       ((67, 93, 3), (29, 41))])
def test_resize(shape, out):
    img = _rng(2).uniform(0, 255, shape).astype(np.float32)
    _close(TRS.resize_linear(t(img), *out),
           JRS.resize_linear(jnp.asarray(img), *out), 2e-3)
    _close(TRS.resize_area(t(img), *out),
           JRS.resize_area(jnp.asarray(img), *out), 2e-3)
    assert TRS.scale_for_megapixels(2160, 3840, 0.45) == \
        JRS.scale_for_megapixels(2160, 3840, 0.45)


def test_transform_helpers():
    a = np.asarray([[1.02, -0.05, 30.5], [0.04, 0.99, -12.25]], np.float32)
    pts = _rng(3).uniform(0, 500, (11, 2)).astype(np.float32)
    _close(TT.invert_affine(t(a)), JT.invert_affine(jnp.asarray(a)), 1e-5)
    _close(TT.apply_affine_pts(t(a), t(pts)),
           JT.apply_affine_pts(jnp.asarray(a), jnp.asarray(pts)), 1e-3)
    h = np.vstack([a, [1e-5, -2e-5, 1.0]]).astype(np.float32)
    _close(TT.apply_homography_pts(t(h), t(pts)),
           JT.apply_homography_pts(jnp.asarray(h), jnp.asarray(pts)), 1e-3)
    for u, v in zip(TT.similarity_params(t(a)),
                    JT.similarity_params(jnp.asarray(a))):
        _close(u, v, 1e-4)


@pytest.mark.parametrize("shape", [(41, 57), (23, 31, 3), (3, 2100)])
def test_gaussian_blur_and_pyramids(shape):
    img = _rng(4).uniform(0, 255, shape).astype(np.float32)
    for sigma in (1.6, 2.5):
        _close(TG.gaussian_blur(t(img), sigma),
               JG.gaussian_blur(jnp.asarray(img), sigma), 1e-3)
    if len(shape) == 3 or shape[0] > 8:
        lj = JG.laplacian_pyramid(jnp.asarray(img), 2)
        lt = TG.laplacian_pyramid(t(img), 2)
        for a, b in zip(lt, lj):
            _close(a, b, 1e-3)
        _close(TG.collapse_laplacian(lt), JG.collapse_laplacian(lj), 1e-3)


def test_knn2_ratio_matches():
    r = _rng(5)
    da = r.uniform(0, 100, (64, 128)).astype(np.float32)
    db = np.concatenate([da[:40] + r.normal(0, 3, (40, 128)),
                         r.uniform(0, 100, (24, 128))]).astype(np.float32)
    va = np.ones(64, bool)
    vb = np.ones(64, bool)
    va[-5:] = False
    vb[:3] = False
    mj = JM.knn2_ratio(jnp.asarray(da), jnp.asarray(va), jnp.asarray(db),
                       jnp.asarray(vb), 0.8)
    mt = TM.knn2_ratio(t(da), t(va), t(db), t(vb), 0.8)
    np.testing.assert_array_equal(n(mt.good), n(mj.good))
    np.testing.assert_array_equal(n(mt.idx)[n(mj.good)],
                                  n(mj.idx)[n(mj.good)])
    _close(mt.dist[mt.good], np.asarray(mj.dist)[n(mj.good)], 1e-2)
    assert TM.adaptive_ratio(0.35) == float(JM.adaptive_ratio(0.35))


def test_ransac_same_bank_same_result():
    """One injected (n_hyp, 2) bank -> identical inlier sets, model within
    1e-4 (the problem of tests/test_ops_ransac.py, similarity kind)."""
    from test_ops_ransac import _make_problem
    src, dst, good, _ = _make_problem("similarity")
    key = jax.random.PRNGKey(0)
    n_hyp = 512
    res_j = JR.ransac(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(good),
                      key, "similarity", thresh=4.0, n_hyp=n_hyp)
    raw = np.asarray(jax.random.randint(key, (n_hyp, 2), 0,
                                        np.iinfo(np.int32).max))
    res_t = TR.ransac_similarity(t(src)[None], t(dst)[None], t(good)[None],
                                 t(raw)[None], 4.0)
    assert bool(res_t.ok[0]) and bool(res_j.ok)
    np.testing.assert_array_equal(n(res_t.inliers[0]), n(res_j.inliers))
    assert int(res_t.n_inliers[0]) == int(res_j.n_inliers)
    # model entries scale with 4-digit pixel coordinates: 1e-4 relative
    np.testing.assert_allclose(n(res_t.model[0]), n(res_j.model), rtol=1e-4,
                               atol=1e-4)


def test_ransac_rejects_garbage_and_empty():
    r = _rng(0)
    src = r.uniform(0, 1000, (1, 128, 2)).astype(np.float32)
    dst = r.uniform(0, 1000, (1, 128, 2)).astype(np.float32)
    raw = r.integers(0, 2 ** 31 - 1, (1, 256, 2))
    res = TR.ransac_similarity(t(src), t(dst), t(np.ones((1, 128), bool)),
                               t(raw), 4.0, min_inliers=20)
    assert not bool(res.ok[0])
    res = TR.ransac_similarity(t(src), t(dst), t(np.zeros((1, 128), bool)),
                               t(raw), 4.0)
    assert not bool(res.ok[0])


def test_bundle_adjust_matches_jax():
    """Five-frame chain plus one poisoned edge (the problem of
    tests/test_ops_ransac.py): same transforms within 1e-2 px."""
    r = _rng(0)
    n_, k = 6, 120
    pairs = [(i, i + 1) for i in range(5)] + [(0, 4)]
    pa, pb = [], []
    for (i, j) in pairs[:5]:
        p = np.stack([r.uniform(1000, 3800, k), r.uniform(0, 2000, k)], -1)
        pa.append(p)
        pb.append(p - [1000.0, 0.3 * j] + r.normal(0, 0.3, p.shape))
    p = np.stack([r.uniform(2000, 3800, k), r.uniform(0, 2000, k)], -1)
    pa.append(p)
    pb.append(p - [1500.0, 0.0])
    pa = np.stack(pa).astype(np.float32)
    pb = np.stack(pb).astype(np.float32)
    w = np.ones((6, k), np.float32)
    w[:, -10:] = 0.0
    init = np.zeros((n_, 2, 3), np.float32)
    for i in range(n_):
        init[i] = [[1, 0, 1000.0 * i], [0, 1, 0]]
    pi = np.asarray(pairs, np.int32)
    out_j = np.asarray(JBA.bundle_adjust_similarity_jit(
        jnp.asarray(pi), jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(w),
        JBA.params_from_affine(jnp.asarray(init))))
    out_t = n(TBA.bundle_adjust_similarity(
        t(pi).long(), t(pa), t(pb), t(w), TBA.params_from_affine(t(init))))
    np.testing.assert_allclose(out_t[:, :, 2], out_j[:, :, 2], atol=1e-2)
    np.testing.assert_allclose(out_t[:, :, :2], out_j[:, :, :2], atol=1e-5)


def _line_of_12_frames(order_seed):
    """A 12-frame 4K flight line (frame k at x = 1152 k, the smoke
    corridor's step) with the registration's banded pairs (gaps 1-3:
    500 / 270 / 60 matches, 0.3 px noise) in a shuffled order, and a
    chain init 2 px off everywhere but frame 0."""
    r = _rng(0)
    n_, k, step = 12, 500, 1152.0
    pairs, pa, pb, w = [], [], [], []
    for g, n_match in ((1, 500), (2, 270), (3, 60)):
        for i in range(n_ - g):
            p = np.stack([r.uniform(step * g, 3839, k),
                          r.uniform(0, 2159, k)], -1)
            pairs.append((i, i + g))
            pa.append(p)
            pb.append(p - [step * g, 0.0] + r.normal(0, 0.3, p.shape))
            w.append(np.arange(k) < n_match)
    init = np.zeros((n_, 2, 3), np.float32)
    for i in range(n_):
        off = r.normal(0, 2.0, 2) if i else (0.0, 0.0)
        init[i] = [[1, 0, step * i + off[0]], [0, 1, off[1]]]
    perm = _rng(order_seed).permutation(len(pairs))
    return (t(np.asarray(pairs)[perm]).long(),
            t(np.stack(pa)[perm], torch.float32),
            t(np.stack(pb)[perm], torch.float32),
            t(np.stack(w)[perm], torch.float32),
            TBA.params_from_affine(t(init)), step)


def test_bundle_adjust_is_independent_of_summation_order():
    """The adjust of a 12-frame 4K line gives the same transforms, within
    1e-3 px, whatever the order of its pairs (the order of its sums), and
    the planted offsets within 0.1 px. A float32 solve of this system
    (the 1e8 pin on frame 0 against per-pair weights of a few hundred)
    moved them by 2.5 px between two orders."""
    outs = []
    for order_seed in (1, 2):
        *args, step = _line_of_12_frames(order_seed)
        outs.append(n(TBA.bundle_adjust_similarity(*args)))
    assert outs[0].dtype == np.float32
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-3)
    exp = np.asarray([[step * i, 0.0] for i in range(12)])
    np.testing.assert_allclose(outs[0][:, :, 2], exp, rtol=0, atol=0.1)


def test_bundle_adjust_keeps_a_long_line_length():
    """A 100-frame line of 640 x 512 frames at 64 px steps, banded pairs
    (gaps 1-4, 120 matches each, 0.3 px of noise on both sides): every
    frame within 5 px of its planted offset and scale 1 within 1e-3. The
    plain least-squares solve, which the points' noise pays for shrinking
    the scales, put the last frame 24 px short here."""
    from drone_image_stitch_cpp_tpu_torch.pipeline.pairgraph import (
        banded_pairs)
    r = _rng(0)
    n_, k, step = 100, 120, 64.0
    pairs = np.asarray(banded_pairs(n_, 4))
    pa, pb = [], []
    for i, j in pairs:
        q = np.stack([r.uniform(0, 640 - step * (j - i), k),
                      r.uniform(0, 512, k)], -1)
        p = q + [step * (j - i), 0.0]
        pa.append(p + r.normal(0, 0.3, p.shape))
        pb.append(q + r.normal(0, 0.3, q.shape))
    init = np.tile(np.eye(3)[:2], (n_, 1, 1))
    init[:, 0, 2] = step * np.arange(n_)
    out = n(TBA.bundle_adjust_similarity(
        t(pairs).long(), t(np.stack(pa)), t(np.stack(pb)),
        torch.ones((len(pairs), k), dtype=torch.float64),
        TBA.params_from_affine(t(init))))
    exp = np.stack([step * np.arange(n_), np.zeros(n_)], -1)
    np.testing.assert_allclose(out[:, :, 2], exp, rtol=0, atol=5.0)
    np.testing.assert_allclose(np.hypot(out[:, 0, 0], out[:, 1, 0]), 1.0,
                               rtol=0, atol=1e-3)


def _two_frame_canvas(seed=6, h=48, w=80):
    r = _rng(seed)
    base = r.uniform(20, 230, (h, w + 40, 3)).astype(np.float32)
    a = np.zeros((h, w, 3), np.float32)
    b = np.zeros((h, w, 3), np.float32)
    ma = np.zeros((h, w), bool)
    mb = np.zeros((h, w), bool)
    a[:, :50] = base[:, :50]
    ma[:, :50] = True
    b[:, 30:] = base[:, 30:w] * 1.1
    mb[:, 30:] = True
    return a, b, ma, mb


def test_block_gain_maps_matches_jax():
    a, b, ma, mb = _two_frame_canvas()
    intens = np.stack([a.mean(-1), b.mean(-1)])
    masks = np.stack([ma, mb])
    gj = JE.block_gain_maps(jnp.asarray(intens), jnp.asarray(masks), block=8)
    gt_ = TE.block_gain_maps(t(intens), t(masks), block=8)
    _close(gt_, gj, 1e-4)


def test_dp_seams_match_jax():
    a, b, ma, mb = _two_frame_canvas()
    for axis in ("vertical", "horizontal"):
        nj = JS.pairwise_seam(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(ma), jnp.asarray(mb), axis=axis)
        nt = TS.pairwise_seam(t(a), t(b), t(ma), t(mb), axis=axis)
        for u, v in zip(nt, nj):
            np.testing.assert_array_equal(n(u), n(v))
    c = np.roll(a, 20, axis=1)
    mc = np.roll(ma, 20, axis=1)
    sj = JS.find_seams_sequential(
        [jnp.asarray(x) for x in (a, b, c)],
        [jnp.asarray(x) for x in (ma, mb, mc)], ["vertical", "vertical"])
    st = TS.find_seams_sequential([t(x) for x in (a, b, c)],
                                  [t(x) for x in (ma, mb, mc)],
                                  ["vertical", "vertical"])
    for u, v in zip(st, sj):
        np.testing.assert_array_equal(n(u), n(v))


def test_multiband_feed_and_blend_match_jax():
    r = _rng(7)
    bands, ch, cw = 3, 72, 120
    cj = JB.mb_prepare(ch, cw, bands)
    ct = TB.mb_prepare(ch, cw, bands, t(0).device)
    feed_j = jax.jit(JB.mb_feed, static_argnums=(3, 4))
    for k, (x0, y0) in enumerate([(0, 0), (40, 8)]):
        tlx, tly, rw, rh = JB.aligned_roi(x0, y0, x0 + 70, y0 + 50, bands,
                                          ch, cw)
        assert (tlx, tly, rw, rh) == TB.aligned_roi(
            x0, y0, x0 + 70, y0 + 50, bands, ch, cw)
        img = r.uniform(0, 255, (rh, rw, 3)).astype(np.float32)
        wgt = r.uniform(0, 1, (rh, rw)).astype(np.float32)
        con = r.uniform(0, 1, (rh, rw)) > 0.2
        cj = feed_j(cj, jnp.asarray(img), jnp.asarray(wgt), tlx, tly,
                    jnp.asarray(con))
        ct = TB.mb_feed(ct, t(img), t(wgt), tlx, tly, t(con))
    for u, v in zip(ct.acc + ct.wacc, list(cj.acc) + list(cj.wacc)):
        _close(u, v, 2e-3)
    oj, vj = jax.jit(JB.mb_blend, static_argnums=(1, 2))(cj, ch - 5, cw - 7)
    ot, vt = TB.mb_blend(ct, ch - 5, cw - 7)
    _close(ot, oj, 2e-3)
    np.testing.assert_array_equal(n(vt), n(vj))
    np.testing.assert_array_equal(n(TB.clip_u8(ot)), n(JB.clip_u8(oj)))
    assert TB.pyramid_bytes(2176, 16512, 5) == JB.pyramid_bytes(2176, 16512,
                                                                5)
    for box in [(3.5, 7.25, 3900.1, 2170.9), (11904.2, -1.3, 15800.0, 2160)]:
        assert TB.bucketed_window(*box, 5, 2176, 16512) == \
            JB.bucketed_window(*box, 5, 2176, 16512)


def test_auto_crop_matches_jax():
    img = np.zeros((40, 60, 3), np.uint8)
    img[5:30, 7:52] = _rng(8).integers(3, 255, (25, 45, 3))
    img[2, 2] = (2, 0, 0)         # gray 0.23: cropped like the reference
    np.testing.assert_array_equal(TCR.auto_crop_black_border(img),
                                  JCR.auto_crop_black_border(img))
