"""The strip compose's two knobs and K2's float32 source: the port vs the
JAX package on the CPU.

On tests/test_fallback.py's 3-frame sortie (render_sortie(ortho, 1, 3,
160, 208, 0.5), its small tuning), both packages compose the JAX
package's registered transforms, so the comparison sees the compose alone:
  * ``compositing_resol_mpx`` set to a quarter of a frame's pixels
    (scale 0.5): the same panorama shape and a blurred RMSE between the
    two panoramas below 1 (measured 0.0008; the port's area resize
    differs from jax.image's by a few 1e-3 levels, tests/test_torch_ops.py);
  * ``use_affine_warper=False``: the same shape and blurred RMSE below 1
    against JAX's (measured 0.0014: the 3x3 inverses differ by ulps,
    tests/test_torch_pairwise.py), and the port's perspective and affine
    panoramas agree as JAX's do (test_fallback.py:167-177: the same shape,
    blurred RMSE < 2; measured 0.0009).
K2's float32 source: its plain version equals the JAX package's exact
gather ``ops/warp.warp_affine`` on a float frame bit for bit (the K2
coefficients equal JAX's inverse bit for bit, tests/test_torch_warp.py),
batched too; a float frame in content mode raises. The port's CLI runs
both knobs on the CPU with rc 0.
"""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, n, small_tunings, t

from drone_image_stitch_cpp_tpu.ops.crop import (
    auto_crop_black_border as jcrop)
from drone_image_stitch_cpp_tpu.ops.warp import warp_affine as jwarp
from drone_image_stitch_cpp_tpu.pipeline.strip import (
    compose_strip as jcompose, estimate_strip_transforms as jestimate)
from drone_image_stitch_cpp_tpu.utils.synthetic import render_sortie
from drone_image_stitch_cpp_tpu_torch.cli.main import main as cli_main
from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
from drone_image_stitch_cpp_tpu_torch.pipeline.strip import (
    compose_strip as tcompose)
from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

_MPX = 160 * 208 / 4 / 1e6          # a quarter of the pixels: scale 0.5


@pytest.fixture(scope="module")
def strip(ortho):
    imgs, _, _ = render_sortie(ortho, 1, 3, frame_h=160, frame_w=208,
                               overlap=0.5)
    jt, _ = small_tunings()
    kept, transforms, _ = jestimate(imgs, jt, stage="T")
    assert kept == [0, 1, 2]
    return imgs, np.asarray(transforms, np.float32)


def _compose_both(imgs, transforms, **knobs):
    jt, tt = small_tunings()
    pj = jcrop(np.asarray(jcompose(imgs, transforms, jt.replace(**knobs),
                                   "T")))
    pt = tcompose(imgs, transforms, tt.replace(**knobs), "T", device=CPU)
    return pt, pj


def test_compositing_scale_matches_jax(strip):
    imgs, transforms = strip
    log = get_logger()
    n0 = len(log._records)
    pt, pj = _compose_both(imgs, transforms, compositing_resol_mpx=_MPX)
    scale = [r["scale"] for r in log._records[n0:]
             if r["msg"] == "compositing scale"]
    assert scale == [0.5]
    assert pt.shape == pj.shape
    rmse, _, _ = gt_rmse(pt, pj, search=1)
    print(f"compositing scale: panorama {pt.shape}, blurred RMSE vs JAX "
          f"{rmse:.4f}")
    assert rmse < 1.0
    # about half the full-resolution mosaic (208 + 2 * 104 wide)
    assert abs(pt.shape[0] - 80) <= 3 and abs(pt.shape[1] - 208) <= 4


def test_perspective_warper_matches_jax(strip):
    imgs, transforms = strip
    pt, pj = _compose_both(imgs, transforms, use_affine_warper=False)
    assert pt.shape == pj.shape
    rmse, _, _ = gt_rmse(pt, pj, search=1)
    _, tt = small_tunings()
    affine = tcompose(imgs, transforms, tt, "T", device=CPU)
    assert affine.shape == pt.shape
    rmse_pa, _, _ = gt_rmse(pt, affine, search=0)
    print(f"perspective warper: panorama {pt.shape}, blurred RMSE vs JAX "
          f"{rmse:.4f}, vs the port's affine compose {rmse_pa:.4f}")
    assert rmse < 1.0 and rmse_pa < 2.0


def test_perspective_warper_with_compositing_scale(strip):
    """Both knobs at once: float32 frames through the perspective route."""
    imgs, transforms = strip
    pt, pj = _compose_both(imgs, transforms, use_affine_warper=False,
                           compositing_resol_mpx=_MPX)
    assert pt.shape == pj.shape
    assert gt_rmse(pt, pj, search=1)[0] < 1.0


@pytest.mark.parametrize("a23", [
    [[1.0, 0.0, 10.25], [0.0, 1.0, -3.5]],
    [[0.97, -0.26, 40.0], [0.26, 0.97, -25.0]],
    [[0.5, 0.01, 3.3], [-0.02, 0.5, 7.9]]])
def test_k2_plain_float32_equals_jax_warp_affine(a23):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (61, 83, 3)).astype(np.float32)
    a23 = np.asarray(a23, np.float32)
    wk, mk = WK.warp_frame(t(img), a23, 70, 90)
    ref = n(jwarp(jnp.asarray(img), jnp.asarray(a23), 70, 90))
    ref_m = n(jwarp(jnp.ones((61, 83), jnp.float32), jnp.asarray(a23), 70,
                    90))
    assert wk.dtype == torch.float32 and wk.shape == (70, 90, 3)
    np.testing.assert_array_equal(n(wk), ref)
    np.testing.assert_array_equal(n(mk), ref_m)
    # the batched entry equals the per-frame one
    frames = t(np.stack([img, img[::-1].copy()]))
    a23s = np.stack([a23, a23])
    wb, mb = WK.warp_frames(frames, a23s, 70, 90)
    for k in range(2):
        wp, mp = WK.warp_frame_plain(frames[k], WK.inverse_coeffs(a23), 70,
                                     90)
        assert torch.equal(wb[k], wp) and torch.equal(mb[k], mp)


def test_k2_float32_content_mode_raises():
    img = torch.zeros((8, 8, 3), dtype=torch.float32)
    a = np.asarray([[1, 0, 0], [0, 1, 0]], np.float32)
    with pytest.raises(ValueError, match="nonblack"):
        WK.warp_frame(img, a, 8, 8, content="nonblack")
    with pytest.raises(ValueError, match="nonblack"):
        WK.warp_frames(img[None], a[None], 8, 8, content="nonblack")


@pytest.mark.parametrize("flags", [
    ["--use-affine-warper", "false"],
    ["--compositing-resol-mpx", "0.015"]])
def test_cli_knobs(ortho, tmp_path, flags):
    imgs, _, _ = render_sortie(ortho, 1, 3, 160, 208, 0.5)
    d = tmp_path / "in" / "visible" / "run"
    os.makedirs(d)
    for k, img in enumerate(imgs):
        cv2.imwrite(str(d / f"IMG{k:03d}_x.png"), img)
    out = tmp_path / "out"
    rc = cli_main(["--device", "cpu", "--image-folder", str(tmp_path / "in"),
                   "--image-type", "visible", "--group", "run",
                   "--output-root", str(out), "--sift-features", "512",
                   "--strip-sift-features", "512",
                   "--registration-resol-mpx", "-1",
                   "--seam-estimation-resol-mpx", "-1", "--blend-bands", "3",
                   *flags])
    assert rc == 0
    pano = cv2.imread(str(out / "visible" / "run"
                          / "visible_run_uav_panorama.jpg"))
    full_w = 208 + 2 * 104
    scale = 1.0 if "--use-affine-warper" in flags else (0.015e6 / (160 * 208)
                                                        ) ** 0.5
    assert abs(pano.shape[0] - 160 * scale) <= 4
    assert abs(pano.shape[1] - full_w * scale) <= 6
