"""K2 (bilinear affine warp of a frame + its content mask): the port's
plain version against the JAX package's exact gather ``ops/warp.
warp_affine`` on the CPU, for near-identity affines and for 15 degree
rotations of a uint8 frame, a near-scale-1 warp of a float32 frame (the
compositing source) and the seam scale's 0.145 downscale of a uint8 and
of a packed I420 frame (converted by each package's
``ops/color.yuv420_to_bgr``), at atol 1e-3 on the 0..255 scale (float32
coordinates computed in the same order; the affine inverse may differ by
an ulp).
The batched entry ``warp_frames`` against the per-frame one and against
the JAX package's seam-scale batch ``pipeline/strip._seam_warp_batch``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t

from drone_image_stitch_cpp_tpu.ops.color import yuv420_to_bgr as bgr_jax
from drone_image_stitch_cpp_tpu.ops.transform import invert_affine as inv_jax
from drone_image_stitch_cpp_tpu.ops.warp import warp_affine as warp_jax
from drone_image_stitch_cpp_tpu.pipeline.strip import _seam_warp_batch
from drone_image_stitch_cpp_tpu_torch.ops import warp as TW
from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK


def _rot(deg, tx, ty, s=1.0):
    th = np.radians(deg)
    return np.asarray([[s * np.cos(th), -s * np.sin(th), tx],
                       [s * np.sin(th), s * np.cos(th), ty]], np.float32)


_AFFINES = [
    np.asarray([[1, 0, 10.0], [0, 1, 5.0]], np.float32),
    np.asarray([[1, 0, -17.25], [0, 1, 33.75]], np.float32),
    np.asarray([[1.02, 0.01, 30.5], [-0.015, 0.99, -12.3]], np.float32),
    _rot(15.0, 40.0, -25.0),
    _rot(-15.0, -20.5, 60.25, 1.05),
]


# (affine, source, window): the five uint8 cases, then the gather
# kernel's new shapes: a near-scale-1 float32 warp (values outside
# 0..255, as area-resized frames have), and the 0.145 downscale of the
# seam batch (a sub-pixel offset) of a uint8 and of a packed I420 frame
_DOWN = np.asarray([[0.145, 0.0, 1.37], [0.0, 0.145, 0.61]], np.float32)
_CASES = [pytest.param(a, "uint8", (120, 150), id=f"a23{i}")
          for i, a in enumerate(_AFFINES)] + [
    pytest.param(_rot(0.4, -3.21, 5.87, 1.003), "float32", (120, 150),
                 id="float32-near-scale-1"),
    pytest.param(_DOWN, "uint8", (18, 24), id="uint8-downscale-0.145"),
    pytest.param(_DOWN, "i420", (18, 24), id="i420-downscale-0.145")]


@pytest.mark.parametrize("a23,source,win", _CASES)
def test_k2_plain_matches_jax_gather(a23, source, win):
    rng = np.random.default_rng(0)
    if source == "i420":       # (H*3/2, W) packed, H % 4 == 0, W even
        img = rng.integers(0, 256, (96 * 3 // 2, 130), dtype=np.uint8)
        ref_src = bgr_jax(jnp.asarray(img))
    elif source == "float32":
        img = rng.uniform(-20.0, 280.0, (97, 131, 3)).astype(np.float32)
        ref_src = jnp.asarray(img)
    else:
        img = rng.integers(0, 256, (97, 131, 3), dtype=np.uint8)
        ref_src = jnp.asarray(img.astype(np.float32))
    oh, ow = win
    wimg, mask = WK.warp_frame(t(img), a23, oh, ow)
    ref = np.asarray(warp_jax(ref_src, jnp.asarray(a23), oh, ow))
    ref_m = np.asarray(warp_jax(jnp.ones(ref_src.shape[:2], jnp.float32),
                                jnp.asarray(a23), oh, ow))
    assert wimg.shape == (oh, ow, 3) and wimg.dtype == torch.float32
    np.testing.assert_allclose(n(wimg), ref, atol=1e-3)
    np.testing.assert_allclose(n(mask), ref_m, atol=1e-5)
    assert (n(mask) >= 0.5).mean() > 0.3   # the frame lands in the window


@pytest.mark.parametrize("a23", _AFFINES[2:4])
def test_port_gather_matches_jax(a23):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (64, 80)).astype(np.float32)
    out = TW.warp_affine(t(img), t(a23), 70, 90)
    ref = warp_jax(jnp.asarray(img), jnp.asarray(a23), 70, 90)
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=1e-3)


def test_k2_wrapper_rejects_bad_inputs():
    a = np.asarray([[1, 0, 0], [0, 1, 0]], np.float32)
    with pytest.raises(ValueError):
        WK.warp_frame(torch.zeros((8, 8, 3), dtype=torch.float64), a, 8,
                      8)                          # neither uint8 nor float32
    with pytest.raises(ValueError):
        WK.warp_frame(torch.zeros((8, 8), dtype=torch.uint8), a, 8, 8)
    with pytest.raises(ValueError):
        WK.warp_frame(torch.zeros((8, 8, 3), dtype=torch.uint8), a, 0, 8)


def _seam_batch():
    """4 seeded noise frames and seam-scale affines (scale 0.3, sub-pixel
    canvas offsets, one slightly rotated) into one 48x64 seam canvas."""
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (4, 61, 83, 3), dtype=np.uint8)
    a23s = np.stack([_rot(0.0, 0.3 * 21.37 * k, 0.3 * 3.11 * k, 0.3)
                     for k in range(3)] + [_rot(2.0, 17.4, 5.3, 0.3)])
    return frames, a23s, 48, 64


def test_k2_batched_plain_equals_per_frame():
    frames, a23s, oh, ow = _seam_batch()
    wimgs, masks = WK.warp_frames(t(frames), a23s, oh, ow)
    assert wimgs.shape == (4, oh, ow, 3) and masks.shape == (4, oh, ow)
    for k in range(4):
        wk, mk = WK.warp_frame_plain(t(frames[k]),
                                     WK.inverse_coeffs(a23s[k]), oh, ow)
        assert torch.equal(wimgs[k], wk) and torch.equal(masks[k], mk)
    p_img, p_mask = WK.warp_frames_plain(
        t(frames), [WK.inverse_coeffs(a) for a in a23s], oh, ow)
    assert torch.equal(p_img, wimgs) and torch.equal(p_mask, masks)


def test_k2_batched_matches_jax_seam_warp_batch():
    """The port's batch equals the JAX package's eager ``warp_affine`` of
    each frame bit for bit, and its ``_seam_warp_batch`` within 1e-2: that
    batch is jit-compiled and XLA fuses its coordinate arithmetic into
    FMAs, which moves a sample by up to an ulp of its coordinate (3e-5 px
    at 280 px) and so, on noise frames with steps of up to 255 levels per
    pixel, differs from JAX's own eager warp by a few 1e-3."""
    frames, a23s, oh, ow = _seam_batch()
    wimgs, masks = WK.warp_frames(t(frames), a23s, oh, ow)
    for k in range(len(frames)):
        ref = warp_jax(jnp.asarray(frames[k].astype(np.float32)),
                       jnp.asarray(a23s[k]), oh, ow)
        np.testing.assert_array_equal(n(wimgs[k]), np.asarray(ref))
    simgs, smasks = _seam_warp_batch(jnp.asarray(frames), jnp.asarray(a23s),
                                     oh, ow, False)
    np.testing.assert_allclose(n(wimgs), np.asarray(simgs), atol=1e-2)
    np.testing.assert_array_equal(n(masks) >= 0.5, np.asarray(smasks))
    assert np.asarray(smasks).mean(axis=(1, 2)).min() > 0.1


def test_k2_batched_wrapper_rejects_bad_inputs():
    frames, a23s, oh, ow = _seam_batch()
    with pytest.raises(ValueError):
        WK.warp_frames(t(frames), a23s[:3], oh, ow)      # 4 frames, 3 affines
    with pytest.raises(ValueError):
        WK.warp_frames(t(frames[0]), a23s[:1], oh, ow)   # not a batch
    with pytest.raises(ValueError):
        WK.warp_frame(t(frames[0]), np.zeros((2, 3), np.float32), oh, ow)


def test_inverse_coeffs_equal_jax_invert_affine():
    """K2's host-side inverse reproduces the JAX package's float32
    ``invert_affine`` bit for bit: any rotation (row pivots included),
    scales from seam to full size, canvas-scale translations."""
    rng = np.random.default_rng(7)
    for k in range(200):
        th = rng.uniform(-np.pi, np.pi)
        s = rng.uniform(0.05, 3.0)
        a23 = np.asarray(
            [[s * np.cos(th) + rng.normal(0, 0.05),
              -s * np.sin(th) * rng.uniform(0.5, 1.5),
              rng.uniform(-2e4, 2e4)],
             [s * np.sin(th), s * np.cos(th) + rng.normal(0, 0.05),
              rng.uniform(-3e3, 3e3)]], np.float32)
        ref = np.asarray(inv_jax(jnp.asarray(a23))).reshape(-1)
        got = np.asarray(WK.inverse_coeffs(a23), np.float32)
        np.testing.assert_array_equal(got, ref, err_msg=str(a23))
    with pytest.raises(ValueError):
        WK.inverse_coeffs(np.asarray([[1, 2, 0], [2, 4, 0]], np.float32))
