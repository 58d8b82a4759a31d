"""The single-flight-line slice: the port vs the JAX package on the CPU.

On tests/test_pipeline.py's four-frame strip (render_sortie(ortho, 1, 4,
160, 208, 0.5), its small tuning, handed to the port through
``from_jax_dict``):
  * grouping returns identical groups;
  * the joint strip stitch keeps the same frames, per-frame translations
    within 0.5 px of JAX's (the RANSAC sample banks differ: the port draws
    from a torch.Generator), panorama shape within +-2 px, and the
    panoramas agree to a blurred RMSE below 3 levels after the best
    integer alignment (sub-pixel transform differences resample texture);
  * both panoramas stay within test_pipeline's bound of 8 against the
    ground-truth ortho crop.
Then the port's own entry points: the app on a 70%-overlap line, a clear
error on a two-line sortie and on a missing card, and the CLI on a
single-row JPEG folder.
"""

import os

import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, small_tunings

from drone_image_stitch_cpp_tpu.grouping.flight_grouper import (
    group_boustrophedon as jgroup)
from drone_image_stitch_cpp_tpu.ops.crop import (
    auto_crop_black_border as jcrop)
from drone_image_stitch_cpp_tpu.pipeline.strip import (
    compose_strip as jcompose, estimate_strip_transforms as jestimate)
from drone_image_stitch_cpp_tpu.utils.synthetic import render_sortie
from drone_image_stitch_cpp_tpu_torch.app import (
    RunConfig, run_stitch_application, stitch_frames)
from drone_image_stitch_cpp_tpu_torch.grouping.flight_grouper import (
    group_boustrophedon as tgroup)
from drone_image_stitch_cpp_tpu_torch.ops.crop import (
    auto_crop_black_border as tcrop)
from drone_image_stitch_cpp_tpu_torch.pipeline.strip import (
    stitch_strip as tstitch)
from drone_image_stitch_cpp_tpu_torch.runtime.device import (
    DeviceUnavailableError, resolve_device)
from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

_EXP_W = 208 + 3 * 104


@pytest.fixture(scope="module")
def strip(ortho):
    imgs, ids, pos = render_sortie(ortho, 1, 4, 160, 208, 0.5)
    return imgs, ids, pos


@pytest.fixture(scope="module")
def jax_strip(strip):
    imgs, _, _ = strip
    jt, _ = small_tunings()
    kept, transforms, _ = jestimate(imgs, jt, stage="T")
    pano = jcrop(jcompose([imgs[i] for i in kept], transforms, jt, "T"))
    return kept, transforms, pano


@pytest.fixture(scope="module")
def port_strip(strip):
    imgs, _, _ = strip
    _, tt = small_tunings()
    info = {}
    pano = tcrop(tstitch(imgs, tt, stage="T", device=CPU, info=info))
    return info["kept"], info["transforms"], pano


def test_grouping_matches_jax(strip):
    imgs, ids, _ = strip
    jt, tt = small_tunings()
    gj = jgroup(imgs, ids, jt)
    gt_ = tgroup(imgs, ids, tt, device=CPU)
    assert [g.indices for g in gt_] == [g.indices for g in gj]
    assert [g.ids for g in gt_] == [g.ids for g in gj]


def test_strip_matches_jax(ortho, jax_strip, port_strip):
    kept_j, tr_j, pano_j = jax_strip
    kept_t, tr_t, pano_t = port_strip
    assert kept_t == kept_j == [0, 1, 2, 3]
    np.testing.assert_allclose(tr_t[:, :, 2], tr_j[:, :, 2], atol=0.5)
    np.testing.assert_allclose(tr_t[:, :, :2], tr_j[:, :, :2], atol=2e-3)
    assert abs(pano_t.shape[0] - pano_j.shape[0]) <= 2
    assert abs(pano_t.shape[1] - pano_j.shape[1]) <= 2
    rmse, dy, dx = gt_rmse(pano_t, pano_j, search=3)
    assert rmse < 3.0, (rmse, dy, dx)
    gt = ortho[40:200, 40:40 + _EXP_W].astype(np.uint8)
    for pano in (pano_t, pano_j):
        assert gt_rmse(pano, gt, search=3)[0] < 8.0


def test_app_single_line(ortho):
    imgs, ids, pos = render_sortie(ortho, 1, 4, 160, 208, 0.7)
    _, tt = small_tunings()
    res = stitch_frames(imgs, ids, tt, "cpu")
    assert [g.indices for g in res.groups] == [[0, 1, 2, 3]]
    assert res.kept == [0, 1, 2, 3]
    exp = np.asarray([(x - pos[0][1], y - pos[0][0]) for y, x in pos])
    np.testing.assert_allclose(res.transforms[:, :, 2], exp, atol=0.5)
    exp_w = 208 + 3 * (pos[1][1] - pos[0][1])
    assert abs(res.panorama.shape[0] - 160) <= 4
    assert abs(res.panorama.shape[1] - exp_w) <= 4
    gt = ortho[40:200, 40:40 + exp_w].astype(np.uint8)
    assert gt_rmse(res.panorama, gt, search=3)[0] < 8.0


def test_cuda_required_when_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(DeviceUnavailableError):
        resolve_device("cuda")
    cfg = RunConfig(image_folder=str(tmp_path), group="none",
                    output_root=str(tmp_path / "out"), device="cuda")
    assert run_stitch_application(cfg) == 1
    assert resolve_device("cpu") == CPU


def test_cli_on_jpeg_folder(ortho, tmp_path):
    import cv2
    from drone_image_stitch_cpp_tpu_torch.cli.main import main

    imgs, _, _ = render_sortie(ortho, 1, 4, 160, 208, 0.7)
    d = tmp_path / "in" / "visible" / "run"
    os.makedirs(d)
    for k, img in enumerate(imgs):
        cv2.imwrite(str(d / f"IMG{k:03d}_x.jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 97])
    out = tmp_path / "out"
    rc = main(["--device", "cpu", "--image-folder", str(tmp_path / "in"),
               "--image-type", "visible", "--group", "run",
               "--output-root", str(out), "--sift-features", "512",
               "--strip-sift-features", "512",
               "--registration-resol-mpx", "-1",
               "--seam-estimation-resol-mpx", "-1", "--blend-bands", "3"])
    assert rc == 0
    pano = cv2.imread(str(out / "visible" / "run"
                          / "visible_run_uav_panorama.jpg"))
    assert pano is not None
    assert abs(pano.shape[0] - 160) <= 4 and pano.shape[1] > 330, pano.shape
