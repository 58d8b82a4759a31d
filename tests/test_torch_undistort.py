"""Lens undistortion and the calibration: the port vs the JAX package on
the CPU (same numpy inputs; the calibration built in the JAX package and
carried over with ``from_jax_dict(..., calibration=asdict(...))``).

  * ``distortion_maps`` on a 120x160 grid with every rational coefficient
    non-zero: within 1e-4 px of JAX's (measured: bit-equal, the same
    float32 operations in the same order);
  * ``undistort`` of a 3-channel float image: within 1e-3 levels
    (measured: bit-equal);
  * the app's uint8 frames (``app.undistort_frames``) against JAX's
    ``_undistort_if_ready``: equal except where the float value lies
    within 1e-3 of an integer, where truncation may land on either side
    (measured: none on these frames);
  * the port's ``run_stitch_application`` with the calibration in
    ``tuning_overrides`` on a 2-frame PNG folder: rc 0, the frames
    undistorted and ingested eagerly, and a panorama within 2 px in size
    and blurred RMSE 3 of the JAX package's run on the same folder and
    calibration (the strip stitch's RANSAC banks differ between the
    packages, as in tests/test_torch_strip.py).
"""

import dataclasses
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t

from drone_image_stitch_cpp_tpu import app as japp
from drone_image_stitch_cpp_tpu.config.tuning import (
    CameraCalibration as JaxCamera, MultiBandCalibration as JaxCalibration,
    StitchTuning as JaxTuning, tuning_as_dict)
from drone_image_stitch_cpp_tpu.ops import undistort as JU
from drone_image_stitch_cpp_tpu.utils.synthetic import render_sortie
from drone_image_stitch_cpp_tpu_torch import app as tapp
from drone_image_stitch_cpp_tpu_torch.config.tuning import (
    CameraCalibration, MultiBandCalibration, from_jax_dict)
from drone_image_stitch_cpp_tpu_torch.ops import undistort as TU
from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

_RATIONAL = dict(fx=151.5, fy=148.25, cx=80.3, cy=59.7,
                 dist=(-0.12, 0.03, 0.0011, -0.0016, -0.004, 0.021, -0.012,
                       0.0035))
# a mild barrel model of the app runs' 160x208 frames (~1 px at corners)
_BARREL = dict(fx=300.0, fy=300.0, cx=103.5, cy=79.5,
               dist=(-0.05, 0.01, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0))
_OVERRIDES = dict(sift_features=512, strip_sift_features=512,
                  global_sift_features=768, registration_resol_mpx=-1.0,
                  seam_estimation_resol_mpx=-1.0, blend_bands=3)


def _jax_calib(**cam):
    return JaxCalibration(visible=JaxCamera(name="visible", **cam))


def _port_calib(jcal):
    """The port's calibration from the JAX one, as a user carries it."""
    jt = JaxTuning(calibration=jcal)
    return from_jax_dict(tuning_as_dict(jt),
                         calibration=dataclasses.asdict(jcal)).calibration


def test_distortion_maps_match_jax():
    jcal = _jax_calib(**_RATIONAL)
    cam = _port_calib(jcal).visible
    mj = JU.distortion_maps(jcal.visible, 120, 160)
    mt = TU.distortion_maps(cam, 120, 160)
    for a, b in zip(mt, mj):
        assert a.shape == (120, 160) and a.dtype == torch.float32
        np.testing.assert_allclose(n(a), n(b), atol=1e-4, rtol=0)
    # the model moves the corners by whole pixels: a real test
    assert float((mt[0] - torch.arange(160.0)).abs().max()) > 1.0
    with pytest.raises(ValueError):
        TU.distortion_maps(CameraCalibration(fx=1.0), 4, 4)


def test_undistort_matches_jax():
    img = np.random.default_rng(0).uniform(0, 255, (120, 160, 3)).astype(
        np.float32)
    jcal = _jax_calib(**_RATIONAL)
    uj = JU.undistort(jnp.asarray(img), jcal.visible)
    ut = TU.undistort(t(img), _port_calib(jcal).visible)
    assert ut.shape == img.shape
    np.testing.assert_allclose(n(ut), n(uj), atol=1e-3, rtol=0)


def test_app_frames_match_jax_undistort_if_ready(ortho):
    imgs, _, _ = render_sortie(ortho, 1, 3, frame_h=120, frame_w=160,
                               overlap=0.5)
    jcal = _jax_calib(**_RATIONAL)
    jt = JaxTuning(calibration=jcal)
    tt = from_jax_dict(tuning_as_dict(jt),
                       calibration=dataclasses.asdict(jcal))
    fj = japp._undistort_if_ready(imgs, jt, "rgb")     # an alias of visible
    ft = tapp.undistort_frames(imgs, tt, "rgb", "cpu")
    differ = 0
    for a, b, img in zip(ft, fj, imgs):
        assert a.dtype == np.uint8 and a.shape == img.shape
        f = n(TU.undistort(t(img), tt.calibration.visible))
        edge = np.abs(f - np.round(f)) < 1e-3
        differ += int((a != b).sum())
        np.testing.assert_array_equal(a[~edge], b[~edge])
    print(f"undistorted uint8 values that differ from JAX's: {differ}")
    # nir has no calibration: the frames come back as they were
    assert tapp.undistort_frames(imgs, tt, "nir", "cpu") is imgs


def test_calibration_from_jax_dict_round_trip():
    jcal = _jax_calib(**_RATIONAL)
    jcal.lwir = JaxCamera(name="lwir", fx=10.0)     # partial: not ready
    jd = tuning_as_dict(JaxTuning(calibration=jcal))
    assert "calibration" not in jd
    tt = from_jax_dict(jd, calibration=dataclasses.asdict(jcal))
    assert dataclasses.asdict(tt.calibration) == dataclasses.asdict(jcal)
    assert tt.calibration.find("visible").is_ready()
    assert not tt.calibration.find("thermal").is_ready()
    assert tt.calibration.find("nir") == CameraCalibration(name="nir")
    # without one the cameras stay unfilled, as a fresh JAX tuning's
    assert from_jax_dict(jd).calibration == MultiBandCalibration()
    bad = dataclasses.asdict(jcal)
    bad["visible"]["focal"] = 1.0
    with pytest.raises(ValueError, match="focal"):
        from_jax_dict(jd, calibration=bad)


@pytest.fixture(scope="module")
def folder(ortho, tmp_path_factory):
    imgs, _, pos = render_sortie(ortho, 1, 2, frame_h=160, frame_w=208,
                                 overlap=0.5)
    root = tmp_path_factory.mktemp("calibrated")
    d = root / "visible" / "run"
    os.makedirs(d)
    for k, img in enumerate(imgs):
        cv2.imwrite(str(d / f"IMG{k:03d}_x.png"), img)
    return str(root), pos


def test_app_run_with_calibration_matches_jax(folder, tmp_path):
    root, pos = folder
    jcal = _jax_calib(**_BARREL)
    log = get_logger()
    n0 = len(log._records)
    cfg_t = tapp.RunConfig(
        image_folder=root, image_type="visible", group="run",
        output_root=str(tmp_path / "port"), device="cpu",
        tuning_overrides={**_OVERRIDES, "calibration": _port_calib(jcal)})
    assert tapp.run_stitch_application(cfg_t) == 0
    msgs = [(r["stage"], r["msg"]) for r in log._records[n0:]]
    assert ("Main", "undistorted") in msgs
    assert ("Main", "loaded") in msgs                   # eager ingest
    assert ("Main", "streaming ingest") not in msgs
    assert ("Main", "calibration not ready; skipping undistort") not in msgs
    cfg_j = japp.RunConfig(
        image_folder=root, image_type="visible", group="run",
        output_root=str(tmp_path / "jax"),
        tuning_overrides={**_OVERRIDES, "calibration": jcal})
    assert japp.run_stitch_application(cfg_j) == 0
    pt = cv2.imread(cfg_t.output_path)
    pj = cv2.imread(cfg_j.output_path)
    assert abs(pt.shape[0] - pj.shape[0]) <= 2
    assert abs(pt.shape[1] - pj.shape[1]) <= 2
    rmse, _, _ = gt_rmse(pt, pj, search=3)
    print(f"calibrated run: port {pt.shape} JAX {pj.shape} blurred RMSE "
          f"{rmse:.4f}")
    assert rmse < 3.0, rmse
    # undistortion moved pixels: the run is not the uncalibrated one
    cfg_u = tapp.RunConfig(**{**cfg_t.__dict__,
                              "output_root": str(tmp_path / "plain"),
                              "tuning_overrides": _OVERRIDES})
    assert tapp.run_stitch_application(cfg_u) == 0
    pu = cv2.imread(cfg_u.output_path)
    hh, ww = min(pu.shape[0], pt.shape[0]), min(pu.shape[1], pt.shape[1])
    assert np.abs(pu[:hh, :ww].astype(int) - pt[:hh, :ww]).mean() > 0.5
    w = 208 + (pos[1][1] - pos[0][1])
    assert abs(pt.shape[0] - 160) <= 4 and abs(pt.shape[1] - w) <= 4
