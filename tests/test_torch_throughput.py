"""The throughput benchmark (``tools/bench_throughput``, the port of the
JAX repo's ``bench.py``) against the JAX package on the CPU, stage by
stage, with the port's plain kernel versions:

* the frames equal ``bench.make_frames()`` byte for byte at full size;
* prep (area resize + edge pad) within 2e-3 levels of JAX's
  ``resize_area`` + ``jnp.pad`` at the benchmark's own geometry
  (2160x3840 -> 503x894, padded to 512x896): the resizes are matmuls of
  different orders (ROADMAP section 3);
* detect on JAX's prepped frames: equal validity masks, coordinates within
  1e-3 px;
* match + similarity RANSAC on JAX's features with JAX's ``PRNGKey(i)``
  sample banks injected: equal ratio-test and inlier counts and success
  flags, models within 1e-3;
* K2's single-plane form (``warp_planes``) against JAX's exact gather
  ``ops/warp.warp_affine`` at atol 1e-3 on the 0..255 scale (the
  coordinates are float32 in the same order); its device-side inverse
  equal to JAX's ``invert_affine`` bit for bit;
* ``bench_torch`` end to end and ``main``'s JSON line at a cut size (3
  frames of 540x960, work 252x448, 300 features): the planted per-pair
  translation within 0.5 work px.
"""

import functools
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t

import bench
from drone_image_stitch_cpp_tpu.ops import match as JM
from drone_image_stitch_cpp_tpu.ops import ransac as JR
from drone_image_stitch_cpp_tpu.ops.features import (
    detect_and_describe_batched as jdetect)
from drone_image_stitch_cpp_tpu.ops.resize import resize_area as jresize
from drone_image_stitch_cpp_tpu.ops.transform import invert_affine as jinv
from drone_image_stitch_cpp_tpu.ops.warp import warp_affine as jwarp
from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
from drone_image_stitch_cpp_tpu_torch.ops.features import (
    Features, detect_and_describe_batched as tdetect)
from drone_image_stitch_cpp_tpu_torch.runtime.device import (
    DeviceUnavailableError)
from drone_image_stitch_cpp_tpu_torch.tools import bench_throughput as B
from drone_image_stitch_cpp_tpu_torch.utils.plane_affines import bench_affines

CUT_FRAMES, CUT_H, CUT_W = 3, 540, 960
CUT_MPX = 0.1129                # work 252x448, padded 256x512
CUT_FEATURES = 300
INT32_MAX = np.iinfo(np.int32).max


def _jax_prep(frames, geometry):
    """bench.py's ``_prep``."""
    _, wh, ww, bh, bw = geometry
    small = jax.vmap(lambda x: jresize(x, wh, ww))(jnp.asarray(frames))
    return jnp.pad(small, ((0, 0), (0, bh - wh), (0, bw - ww)), mode="edge")


def _planted(scale):
    """The translation of frame i to frame i + 1 in work px."""
    return np.asarray([-256.0 * scale, -64.0 * scale])


@pytest.fixture(scope="module")
def full_frames():
    return B.make_frames()


@pytest.fixture(scope="module")
def cut():
    frames = np.stack(B.make_frames(CUT_FRAMES, CUT_H, CUT_W))
    geometry = B.work_geometry(CUT_H, CUT_W, CUT_MPX)
    small = _jax_prep(frames, geometry)
    return frames, geometry, small, jdetect(small, CUT_FEATURES)


def test_make_frames_equal_bench_py(full_frames):
    ref = bench.make_frames()
    assert len(full_frames) == len(ref) == B.N_FRAMES
    for a, b in zip(full_frames, ref):
        assert a.shape == (B.FRAME_H, B.FRAME_W) and a.dtype == np.float32
        assert a.tobytes() == b.tobytes()


def test_prep_matches_jax(full_frames):
    """The benchmark's geometry and two of its frames."""
    geometry = B.work_geometry(B.FRAME_H, B.FRAME_W)
    assert geometry[1:] == (503, 894, 512, 896)
    frames = np.stack(full_frames[:2])
    got = B.prep(t(frames), geometry)
    ref = np.asarray(_jax_prep(frames, geometry))
    assert got.shape == ref.shape == (2, 512, 896)
    np.testing.assert_allclose(n(got), ref, atol=2e-3)
    # the pad repeats the last row and column
    assert torch.equal(got[:, 503:, :894], got[:, 502:503, :894].expand(
        2, 9, 894))
    assert torch.equal(got[:, :, 894:], got[:, :, 893:894].expand(
        2, 512, 2))


def test_detect_on_jax_prep_matches_jax(cut):
    _, _, small, fj = cut
    ft = tdetect(t(np.asarray(small)), CUT_FEATURES)
    vj = np.asarray(fj.valid)
    np.testing.assert_array_equal(n(ft.valid), vj)
    assert vj.sum(axis=1).min() > 150
    np.testing.assert_allclose(n(ft.xy)[vj], np.asarray(fj.xy)[vj],
                               atol=1e-3)


def test_register_on_jax_features_matches_jax(cut):
    """The port's batched match + RANSAC against bench.py's per-pair loop
    (``PRNGKey(i)``), with those keys' samples injected."""
    _, geometry, _, fj = cut
    banks = np.stack([np.asarray(jax.random.randint(
        jax.random.PRNGKey(i), (B.N_HYP, 2), 0, INT32_MAX))
        for i in range(CUT_FRAMES - 1)])
    res, n_good = B.register(Features(*(t(np.asarray(a)) for a in fj)),
                             t(banks))
    for i in range(CUT_FRAMES - 1):
        m = JM.knn2_ratio(fj.desc[i], fj.valid[i], fj.desc[i + 1],
                          fj.valid[i + 1], B.RATIO)
        src, dst, good = JM.gather_correspondences(fj.xy[i], fj.xy[i + 1],
                                                   m)
        rj = JR.ransac(src, dst, good, jax.random.PRNGKey(i), "similarity",
                       thresh=B.RANSAC_THRESH, n_hyp=B.N_HYP)
        assert int(n_good[i]) == int(good.sum())
        assert int(res.n_inliers[i]) == int(rj.n_inliers) > 40
        assert bool(res.ok[i]) and bool(rj.ok)
        np.testing.assert_allclose(n(res.model[i]), np.asarray(rj.model),
                                   atol=1e-3)
        np.testing.assert_allclose(n(res.model[i, :2, 2]),
                                   _planted(geometry[0]), atol=0.5)


_MODELS = [
    # a pair model as RANSAC returns it at the cut size (work px)
    [[0.99987453, -4.4592799e-04, -119.35640],
     [4.4592799e-04, 0.99987453, -29.987892]],
    [[1.02 * np.cos(0.09), -1.02 * np.sin(0.09), 35.25],
     [1.02 * np.sin(0.09), 1.02 * np.cos(0.09), -60.5]],
]


@pytest.mark.parametrize("a23", _MODELS)
def test_warp_planes_match_jax_gather(cut, a23):
    """A (2, 3) model given as a tensor (inverted where it lies) and as a
    host array (inverted by ``inverse_coeffs``) warp the frames of a batch
    alike, each within 1e-3 of JAX's ``warp_affine``."""
    frames = cut[0][1:]
    a23 = np.asarray(a23, np.float32)
    models = torch.from_numpy(np.stack([a23] * len(frames)))
    got = WK.warp_planes(t(frames), models, CUT_H, CUT_W)
    assert got.shape == (len(frames), CUT_H, CUT_W)
    assert torch.equal(got, WK.warp_planes(t(frames), models.numpy(), CUT_H,
                                           CUT_W))
    for k, f in enumerate(frames):
        ref = np.asarray(jwarp(jnp.asarray(f), jnp.asarray(a23), CUT_H,
                               CUT_W))
        np.testing.assert_allclose(n(got[k]), ref, atol=1e-3)
    assert (n(got) > 0).mean() > 0.7        # most of the window is covered


def test_device_inverse_equals_jax_invert_affine():
    """``device_inverse_coeffs`` on a batch equals ``inverse_coeffs`` and
    the JAX package's float32 ``invert_affine`` bit for bit: any rotation
    (row pivots included), seam to full scales, canvas translations; a
    singular affine gives a row that is not finite."""
    a23s = bench_affines()
    got = n(WK.device_inverse_coeffs(t(a23s)))
    assert got.shape == (200, 6) and got.dtype == np.float32
    for a23, row in zip(a23s, got):
        np.testing.assert_array_equal(
            row, np.asarray(jinv(jnp.asarray(a23))).reshape(-1))
        np.testing.assert_array_equal(
            row, np.asarray(WK.inverse_coeffs(a23), np.float32))
    sing = WK.device_inverse_coeffs(t(np.asarray(
        [[[1, 2, 0], [2, 4, 0]]], np.float32)))
    assert not torch.isfinite(sing).all()


def test_warp_planes_rejects_bad_inputs():
    planes = torch.zeros((2, 8, 8))
    a23s = np.zeros((2, 2, 3), np.float32)
    a23s[:, 0, 0] = a23s[:, 1, 1] = 1.0
    with pytest.raises(ValueError, match="float32"):
        WK.warp_planes(planes.to(torch.uint8), a23s, 8, 8)
    with pytest.raises(ValueError, match="float32"):
        WK.warp_planes(planes[0], a23s[:1], 8, 8)
    with pytest.raises(ValueError, match="affines"):
        WK.warp_planes(planes, a23s[:1], 8, 8)
    with pytest.raises(ValueError, match="affines"):
        WK.warp_planes(planes, t(a23s[:1]), 8, 8)
    with pytest.raises(ValueError, match=r"\(N, 2, 3\)"):
        WK.warp_planes(planes, t(a23s).reshape(2, 6), 8, 8)
    with pytest.raises(ValueError, match="empty"):
        WK.warp_planes(planes, a23s, 0, 8)


def test_bench_torch_recovers_the_planted_translation():
    frames = B.make_frames(CUT_FRAMES, CUT_H, CUT_W)
    before = WK.warp_planes.launches
    r = B.bench_torch(frames, "cpu", n_features=CUT_FEATURES,
                      reg_mpx=CUT_MPX, reps=1, pipe_reps=1)
    assert WK.warp_planes.launches == before      # the CPU runs plain
    assert r["work_hw"] == (252, 448) and r["padded_hw"] == (256, 512)
    assert r["ok"].all() and (r["n_inliers"] > 40).all()
    assert (r["n_good"] >= r["n_inliers"]).all()
    models = r["models"]
    assert models.shape == (CUT_FRAMES - 1, 3, 3)
    np.testing.assert_allclose(models[:, :2, 2],
                               np.stack([_planted(r["scale"])] * 2),
                               atol=0.5)
    np.testing.assert_allclose(models[:, :2, :2],
                               np.stack([np.eye(2)] * 2), atol=0.01)
    ref = n(WK.warp_planes(t(np.stack(frames[1:])), t(models[:, :2, :]),
                           CUT_H, CUT_W).sum(dim=(1, 2)))
    np.testing.assert_allclose(r["warp_sums"], ref, rtol=1e-5)
    assert r["fps"] > 0 and r["syncs"] is None
    assert r["launches"] == {"sift_orient_desc": 0, "warp_affine_plane": 0}
    assert set(r["stages_ms"]) == {"prep", "detect", "register", "warp",
                                   "total", "queued"}


def test_main_prints_one_json_line_with_bench_py_keys(monkeypatch, capsys):
    """``main`` on the CPU with every stage cut to the test's size."""
    monkeypatch.setattr(B, "make_frames", functools.partial(
        B.make_frames, CUT_FRAMES, CUT_H, CUT_W))
    monkeypatch.setattr(B, "bench_torch", functools.partial(
        B.bench_torch, n_features=CUT_FEATURES, reg_mpx=CUT_MPX, reps=1,
        pipe_reps=1))
    monkeypatch.setattr(B, "bench_opencv", functools.partial(
        B.bench_opencv, n_features=CUT_FEATURES, reg_mpx=CUT_MPX))
    assert B.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == B.METRIC and line["unit"] == "frames/s"
    assert f'"{B.METRIC}"' in inspect.getsource(bench.main)
    assert line["value"] > 0 and line["vs_baseline"] > 0


def test_main_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        B.main([])
    assert capsys.readouterr().out == ""
