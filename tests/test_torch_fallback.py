"""The strip stage's fallback ladder: the port vs the JAX package on the
CPU (same numpy inputs; JAX runs its XLA paths, as tests/test_fallback.py
does, with joint registration forced to fail the same way).

  * the sequential panorama: shape within 2 px of JAX's, blurred RMSE
    between the two <= 2.0 and each <= 9.0 against ground truth
    (test_fallback.py's bound);
  * the anchor schedule: the (batch length, local range width) of every
    registration call equals JAX's;
  * a matching mask disables the ladder; a non-overlapping pair fails it
    with a diagnostics record of all six fields;
  * mixed-size detect: valid keypoints within 3% per frame of JAX's and
    the pair's similarity transform within 0.3 px on one injected sample
    bank (the port pads to the exact largest work size, JAX to a 256-px
    bucket, which moves keypoints near the right and bottom edges);
  * homography RANSAC on one injected sample bank: model within 1e-3
    (relative for the pixel-scale entries), inlier counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import CPU, n, small_tunings, t

import drone_image_stitch_cpp_tpu.pipeline.strip as JS
import drone_image_stitch_cpp_tpu_torch.pipeline.strip as TS
from drone_image_stitch_cpp_tpu.ops import ransac as JR
from drone_image_stitch_cpp_tpu.ops.crop import (
    auto_crop_black_border as jcrop)
from drone_image_stitch_cpp_tpu.pipeline import pairgraph as JP
from drone_image_stitch_cpp_tpu.pipeline.registration import (
    detect_features as jdetect)
from drone_image_stitch_cpp_tpu.utils.synthetic import render_sortie
from drone_image_stitch_cpp_tpu_torch.ops import ransac as TR
from drone_image_stitch_cpp_tpu_torch.ops.features import Features
from drone_image_stitch_cpp_tpu_torch.pipeline import pairgraph as TP
from drone_image_stitch_cpp_tpu_torch.pipeline.registration import (
    detect_features as tdetect)
from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse


def _fail_joint(monkeypatch, mod, calls=None):
    """Registration of more than two frames raises in ``mod`` until the
    first forced failure, as tests/test_fallback.py forces it; with
    ``calls``, record each later call's (batch length, range width) and
    force only the first (joint) call."""
    real = mod.estimate_strip_transforms
    state = {"failed": False}

    def wrapper(images, tuning, range_width=None, *a, **kw):
        if calls is None:
            if len(images) > 2:
                raise mod.StripStitchError("forced joint failure (test)")
        elif not state["failed"]:
            state["failed"] = True
            raise mod.StripStitchError("forced joint failure (test)")
        else:
            calls.append((len(images), range_width))
        return real(images, tuning, range_width, *a, **kw)

    monkeypatch.setattr(mod, "estimate_strip_transforms", wrapper)


@pytest.fixture(scope="module")
def sequential(ortho):
    """(port, JAX) sequential panoramas of test_fallback.py's 3 frames."""
    imgs, _, _ = render_sortie(ortho, 1, 3, frame_h=160, frame_w=208,
                               overlap=0.5)
    jt, tt = small_tunings()
    info = {}
    with pytest.MonkeyPatch.context() as mp:
        _fail_joint(mp, TS)
        _fail_joint(mp, JS)
        pt = TS.stitch_strip(imgs, tt, stage="T", device=CPU, info=info)
        pj = jcrop(JS.stitch_strip(imgs, jt, stage="T"))
    return pt, pj, info


def test_sequential_fallback_matches_jax(sequential, ortho):
    pt, pj, info = sequential
    assert info["path"] == "sequential" and info["kept"] == [0, 1, 2]
    assert np.isnan(info["transforms"]).all()
    assert abs(pt.shape[0] - pj.shape[0]) <= 2
    assert abs(pt.shape[1] - pj.shape[1]) <= 2
    exp_w = 208 + 2 * 104
    assert abs(pt.shape[0] - 160) <= 6 and abs(pt.shape[1] - exp_w) <= 8
    # best integer alignment: the two ladders' mosaics may start a pixel
    # apart (each crops its own black border)
    assert gt_rmse(pt, pj, search=3)[0] <= 2.0
    gt = ortho[40:200, 40:40 + exp_w].astype(np.uint8)
    for pano in (pt, pj):
        assert gt_rmse(pano, gt, search=3)[0] <= 9.0


def test_anchor_schedule_matches_jax(ortho, monkeypatch):
    """The port's ladder runs for real; JAX's ladder runs on stand-ins
    for its registration and compose that always succeed (its own
    registration of these mixed-size batches costs a minute of XLA
    compiles), which is the schedule the port's successful run takes."""
    imgs, _, _ = render_sortie(ortho, 1, 4, frame_h=160, frame_w=208,
                               overlap=0.5)
    jt, tt = small_tunings()
    knobs = dict(use_anchor_fallback=True, anchor_window=2, range_width=2)
    calls_t, calls_j = [], []
    _fail_joint(monkeypatch, TS, calls_t)
    state = {"failed": False}

    def jax_estimate(images, tuning, range_width=None, *a, **kw):
        if not state["failed"]:
            state["failed"] = True
            raise JS.StripStitchError("forced joint failure (test)")
        calls_j.append((len(images), range_width))
        return list(range(len(images))), None, None

    monkeypatch.setattr(JS, "estimate_strip_transforms", jax_estimate)
    monkeypatch.setattr(JS, "compose_strip", lambda imgs, *a, **kw: imgs[0])
    info = {}
    TS.stitch_strip(imgs, tt.replace(**knobs), stage="T",
                    range_width_override=2, device=CPU, info=info)
    JS.stitch_strip(imgs, jt.replace(**knobs), stage="T",
                    range_width_override=2)
    assert info["path"] == "sequential"
    assert calls_t == calls_j
    batch = [c for c in calls_t if c[0] > 2]
    assert batch and batch[0][0] == 3       # anchors start with frame 0
    assert all(rw == max(2, min(k, 2)) for k, rw in batch)


def test_matching_mask_disables_fallback(ortho, monkeypatch):
    imgs, _, _ = render_sortie(ortho, 1, 3, frame_h=160, frame_w=208,
                               overlap=0.5)
    _, tt = small_tunings()
    _fail_joint(monkeypatch, TS)
    with pytest.raises(TS.StripStitchError, match="forced joint failure"):
        TS.stitch_strip(imgs, tt, stage="T", device=CPU,
                        matching_mask=np.ones((3, 3), bool))


def test_non_overlapping_pair_dumps_diagnostics(ortho):
    a = ortho[0:160, 0:208].astype(np.uint8)
    b = ortho[400:560, 600:808].astype(np.uint8)
    _, tt = small_tunings()
    log = get_logger()
    n0 = len(log._records)
    with pytest.raises(TS.StripStitchError,
                       match="sequential stitch failed"):
        TS.stitch_strip([a, b], tt, stage="T", device=CPU)
    recs = [r for r in log._records[n0:] if r["msg"] == "failure diagnostics"]
    # the joint pair gate's record and the ladder's dump after its step
    assert {r["stage"] for r in recs} == {"T", "T/seq1"}, recs
    for rec in recs:
        for field in ("kp_left", "kp_right", "good_matches", "model",
                      "left", "right"):
            assert field in rec, rec
    assert not any(r["msg"] == "failure diagnostics unavailable"
                   for r in log._records[n0:])


def _jax_banks(seed, n_pairs, n_hyp, m, chunk=16):
    """The sample integers JAX's register_pairs draws for each pair."""
    n_keys = -(-n_pairs // chunk) * chunk
    keys = jax.random.split(jax.random.PRNGKey(seed), n_keys)[:n_pairs]
    return np.stack([np.asarray(jax.random.randint(
        k, (n_hyp, m), 0, np.iinfo(np.int32).max)) for k in keys])


def test_mixed_size_detect_matches_jax(ortho):
    # three overlapping crops of different sizes; frame 1 sits 96 px right
    # and frame 2 40 px down of frame 0
    frames = [ortho[40:200, 40:248], ortho[40:200, 136:448],
              ortho[80:280, 40:456]]
    frames = [f.astype(np.uint8) for f in frames]
    ft, st = tdetect(frames, 400, 0.02, device=CPU)
    fj, sj = jdetect(frames, 400, 0.02)
    assert st == pytest.approx(sj)
    assert st < 1.0     # a real work scale: per-frame sizes and mapping
    vt = n(ft.valid).sum(axis=1)
    vj = np.asarray(fj.valid).sum(axis=1)
    assert (np.abs(vt - vj) <= 0.03 * vj).all(), (vt, vj)
    pairs = [(0, 1), (0, 2)]
    n_hyp = 1024
    gj = JP.register_pairs(fj, pairs, 0.75, thresh=4.0 / sj,
                           kind="similarity", n_hyp=n_hyp, seed=0)
    gt = TP.register_pairs(ft, pairs, 0.75, 4.0 / st, n_hyp=n_hyp,
                           banks=t(_jax_banks(0, len(pairs), n_hyp, 2)))
    assert n(gt.ok).all() and np.asarray(gj.ok).all()
    mt, mj = n(gt.model), np.asarray(gj.model)
    np.testing.assert_allclose(mt[:, :2, 2], mj[:, :2, 2], atol=0.3)
    np.testing.assert_allclose(mt[:, :2, :2], mj[:, :2, :2], atol=1e-3)
    # frame 0 -> frame 1: x - 96; frame 0 -> frame 2: y - 40
    np.testing.assert_allclose(mt[:, :2, 2], [[-96.0, 0.0], [0.0, -40.0]],
                               atol=1.0)


def test_find_homography_matches_jax():
    from test_ops_ransac import _make_problem
    src, dst, good, _ = _make_problem("homography")
    key = jax.random.PRNGKey(3)
    res_j = JR.find_homography(jnp.asarray(src), jnp.asarray(dst),
                               jnp.asarray(good), key, thresh=3.0)
    raw = np.asarray(jax.random.randint(key, (1024, 4), 0,
                                        np.iinfo(np.int32).max))
    res_t = TR.find_homography(t(src)[None], t(dst)[None], t(good)[None],
                               t(raw)[None], thresh=3.0)
    assert bool(res_t.ok[0]) and bool(res_j.ok)
    assert int(res_t.n_inliers[0]) == int(res_j.n_inliers)
    np.testing.assert_allclose(n(res_t.model[0]), n(res_j.model), rtol=1e-3,
                               atol=1e-3)
    # degenerate (collinear) samples give NaN, never a model
    line = np.stack([np.arange(4.0), np.arange(4.0)], -1).astype(np.float32)
    h = TR.solve_homography(t(line), t(line) * 2.0, t(np.ones(4, np.float32)))
    assert bool(np.isnan(n(h)).all())
