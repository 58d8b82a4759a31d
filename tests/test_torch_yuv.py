"""The I420 ingest wire: the port vs the JAX package on the CPU.

  * ``ops/color``: ``yuv420_luma`` equal, ``yuv420_to_bgr`` within 1e-4
    levels, ``bgr_to_yuv420`` equal on >= 99.9% of the bytes and within
    1 level everywhere (float32 sums in another order move a .5 rounding);
  * the raw 4:2:0 decode (``utils/native``) byte-equal to JAX's;
  * ``FrameStore.from_paths`` on a folder of 4:2:0 JPEGs resolves to the
    same format and logical shape as JAX's store, its host frames equal
    the eager loader's, and ``fmt="yuv420"`` raises without the decoder;
  * detect on a packed store (the Y plane) against JAX's
    ``_detect_batch_yuv`` route: equal validity, coordinates within 1e-3
    px (256x256 frames: JAX's shape bucket adds no pad);
  * K2's I420 plain version against JAX's exact gather of
    ``yuv420_to_bgr``, windows crossing all four frame borders: 1e-3;
  * a 4-frame strip from packed stores in both packages: translations
    within 0.5 px, the same panorama shape, blurred RMSE below 3;
Packed frames are made from BGR in numpy with the full-range JFIF forward
transform and 2x2 chroma means, as a camera's encoder does.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, n, small_tunings, t

from drone_image_stitch_cpp_tpu.ops import color as JC
from drone_image_stitch_cpp_tpu.ops.crop import (
    auto_crop_black_border as jcrop)
from drone_image_stitch_cpp_tpu.ops.warp import warp_affine as jwarp
from drone_image_stitch_cpp_tpu.pipeline.registration import (
    detect_features as jdetect)
from drone_image_stitch_cpp_tpu.pipeline.strip import (
    compose_strip as jcompose, estimate_strip_transforms as jestimate)
from drone_image_stitch_cpp_tpu.runtime.feed import FrameStore as JStore
from drone_image_stitch_cpp_tpu.utils import native as JN
from drone_image_stitch_cpp_tpu.utils.synthetic import render_sortie
from drone_image_stitch_cpp_tpu_torch.ops import color as TC
from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
from drone_image_stitch_cpp_tpu_torch.ops.crop import (
    auto_crop_black_border as tcrop)
from drone_image_stitch_cpp_tpu_torch.pipeline.registration import (
    detect_features as tdetect)
from drone_image_stitch_cpp_tpu_torch.pipeline.strip import (
    stitch_strip as tstitch)
from drone_image_stitch_cpp_tpu_torch.runtime import loader as TL
from drone_image_stitch_cpp_tpu_torch.runtime.feed import FrameStore
from drone_image_stitch_cpp_tpu_torch.utils import native as TN
from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse


def jfif_i420(bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (H*3/2, W) packed I420 by the full-range
    JFIF forward transform with 2x2 chroma means (a camera's encoder)."""
    h, w = bgr.shape[:2]
    b, g, r = (bgr[..., c].astype(np.float64) for c in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    cb = cb.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    cr = cr.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    def u8(p):
        return np.clip(np.round(p), 0, 255).astype(np.uint8)

    return np.concatenate([u8(y), u8(cb).reshape(h // 4, w),
                           u8(cr).reshape(h // 4, w)])


@pytest.fixture(scope="module")
def frame(ortho):
    return ortho[100:356, 200:584].astype(np.uint8)       # 256 x 384


def test_yuv420_luma_and_to_bgr_match_jax(frame):
    packed = jfif_i420(frame)
    np.testing.assert_array_equal(
        n(TC.yuv420_luma(t(packed))),
        np.asarray(JC.yuv420_luma(jnp.asarray(packed))))
    tb = n(TC.yuv420_to_bgr(t(packed)))
    jb = np.asarray(JC.yuv420_to_bgr(jnp.asarray(packed)))
    assert tb.shape == jb.shape == frame.shape
    np.testing.assert_allclose(tb, jb, atol=1e-4, rtol=0)


def test_bgr_to_yuv420_matches_jax(frame):
    noisy = np.clip(frame.astype(np.int16) + np.random.default_rng(1)
                    .integers(-20, 21, frame.shape), 0, 255).astype(np.uint8)
    for img in (frame, noisy):
        tp = n(TC.bgr_to_yuv420(t(img)))
        jp = np.asarray(JC.bgr_to_yuv420(jnp.asarray(img)))
        assert tp.shape == jp.shape == (384, 384) and tp.dtype == np.uint8
        d = np.abs(tp.astype(np.int16) - jp.astype(np.int16))
        assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                          (d > 0).sum())
    with pytest.raises(ValueError):
        TC.bgr_to_yuv420(t(frame[:254]))


# ---- the raw 4:2:0 decode and the store -------------------------------------

@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory, ortho):
    """Eleven 4:2:0 JPEGs (two store chunks) and their BGR crops."""
    d = tmp_path_factory.mktemp("yuv")
    for k in range(11):
        crop = ortho[8 * k:8 * k + 48, 16 * k:16 * k + 64]
        cv2.imwrite(str(d / f"IMG{k:03d}_x.jpg"), crop,
                    [cv2.IMWRITE_JPEG_QUALITY, 92])
    return str(d)


def _codec():
    if TN.jpeg_codec_error() is not None:
        pytest.skip(f"JPEG codec not built: {TN.jpeg_codec_error()}")


def test_raw_decode_equals_jax(jpeg_dir, tmp_path, frame):
    _codec()
    assert JN.native_available()
    paths, _ = TL.scan_with_ids(jpeg_dir)
    full444 = str(tmp_path / "f444.jpg")
    cv2.imwrite(full444, frame, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    for p in paths[:2] + [full444]:
        a, b = (TN.decode_image_yuv420_native(p),
                JN.decode_image_yuv420_native(p))
        if p == full444:
            assert a is None and b is None
        else:
            assert a.shape == (72, 64)
            np.testing.assert_array_equal(a, b)
    got = TN.decode_batch_yuv420_native(paths + [full444], 4)
    ref = JN.decode_batch_yuv420_native(paths + [full444], 4)
    assert got[-1] is None and ref[-1] is None
    for a, b in zip(got[:-1], ref[:-1]):
        np.testing.assert_array_equal(a, b)


def test_store_resolves_to_yuv420_as_jax(jpeg_dir):
    _codec()
    paths, _ = TL.scan_with_ids(jpeg_dir)
    st = FrameStore.from_paths(paths, CPU)
    js = JStore.from_paths(paths)
    assert st.fmt == js.fmt == "yuv420"
    assert st.shape0 == tuple(js.shape0) == (48, 64, 3)
    js.wait_all()
    for k in (0, 5, 10):
        np.testing.assert_array_equal(st.frame(k).numpy(), js.images[k])
    eager = TL.load_with_ids(jpeg_dir)
    for a, b in zip(st.host_images(), eager.images):
        np.testing.assert_array_equal(a, b)
    assert st.batch([9, 2, 4]).shape == (3, 72, 64)
    sub = st.subset([3, 4], CPU)
    assert sub.fmt == "yuv420"
    np.testing.assert_array_equal(sub.host_frame(1), eager.images[4])


def test_store_format_without_the_decoder(jpeg_dir, monkeypatch):
    """Without the codec, ``fmt="yuv420"`` raises, ``auto`` stores BGR
    (decoded by cv2), and BGR-only options are refused for I420."""
    paths, _ = TL.scan_with_ids(jpeg_dir)
    with pytest.raises(ValueError):
        FrameStore.from_paths(paths, CPU, fmt="yuv420", scale_denom=2)
    monkeypatch.setitem(TN._CODEC, "lib", None)
    monkeypatch.setitem(TN._CODEC, "path", None)
    monkeypatch.setitem(TN._CODEC, "error", "fatal error: jpeglib.h")
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        FrameStore.from_paths(paths, CPU, fmt="yuv420")
    st = FrameStore.from_paths(paths, CPU)
    assert st.fmt == "bgr" and st.shape0 == (48, 64, 3)
    np.testing.assert_array_equal(st.host_frame(3),
                                  cv2.imread(paths[3], cv2.IMREAD_COLOR))


# ---- detect, K2's I420 source, the strip ------------------------------------

_N_FEAT = 512       # the small tuning's budget: one JAX detect program


@pytest.fixture(scope="module")
def packed_strip(ortho):
    imgs, ids, pos = render_sortie(ortho, 1, 4, 256, 256, 0.5)
    return [jfif_i420(im) for im in imgs], ids, pos


def test_detect_on_y_plane_matches_jax(packed_strip):
    packed, _, _ = packed_strip
    fj, sj = jdetect(None, _N_FEAT, -1.0, store=JStore(packed, fmt="yuv420"))
    ft, st = tdetect(None, _N_FEAT, -1.0,
                     store=FrameStore(packed, CPU, fmt="yuv420"))
    assert st == sj == 1.0
    vj = np.asarray(fj.valid)
    np.testing.assert_array_equal(n(ft.valid), vj)
    assert vj.sum(axis=1).min() > 50
    np.testing.assert_allclose(n(ft.xy)[vj], np.asarray(fj.xy)[vj],
                               atol=1e-3)
    np.testing.assert_allclose(n(ft.sigma)[vj], np.asarray(fj.sigma)[vj],
                               atol=1e-3)


@pytest.mark.parametrize("a23", [
    [[1.1, 0.08, 12.3], [-0.07, 0.95, 9.6]],          # inside the window
    [[0.96, -0.26, 30.7], [0.26, 0.96, -8.45]],       # rotated, clipped
])
def test_k2_i420_plain_matches_jax_gather(frame, a23):
    """The frame lands inside (or across) a larger window, so the output
    crosses all four frame borders, where the chroma edge replication
    and the zero border meet."""
    packed = jfif_i420(frame[:64, :96])
    a23 = np.asarray(a23, np.float32)
    oh, ow = 100, 140
    wt, mt = WK.warp_frame(t(packed), a23, oh, ow)
    bgr = JC.yuv420_to_bgr(jnp.asarray(packed))
    wj = np.asarray(jwarp(bgr, jnp.asarray(a23), oh, ow))
    mj = np.asarray(jwarp(jnp.ones((64, 96), jnp.float32),
                          jnp.asarray(a23), oh, ow))
    assert 0.1 < (n(mt) > 0.5).mean() < 0.9
    np.testing.assert_allclose(n(wt), wj, atol=1e-3, rtol=0)
    np.testing.assert_allclose(n(mt), mj, atol=1e-3, rtol=0)
    wb, mb = WK.warp_frames(t(np.stack([packed, packed])),
                            np.stack([a23, a23]), oh, ow)
    assert torch.equal(wb[1], wt) and torch.equal(mb[1], mt)
    for bad in (packed[:-3], packed[:, :-1]):
        with pytest.raises(ValueError):
            WK.warp_frame(t(bad), a23, oh, ow)
    with pytest.raises(ValueError):
        WK.warp_frame(t(packed), a23, oh, ow, content="nonblack")


def test_strip_from_packed_store_matches_jax(ortho, packed_strip):
    packed, _, _ = packed_strip
    jt, tt = small_tunings()
    js = JStore(packed, fmt="yuv420")
    kept_j, tr_j, _ = jestimate(None, jt, stage="T", store=js,
                                indices=[0, 1, 2, 3])
    pano_j = jcrop(jcompose(None, tr_j, jt, "T", store=js,
                            indices=list(kept_j)))
    info = {}
    pano_t = tcrop(tstitch(None, tt, stage="T", device=CPU,
                           store=FrameStore(packed, CPU, fmt="yuv420"),
                           indices=[0, 1, 2, 3], info=info))
    assert info["kept"] == list(kept_j) == [0, 1, 2, 3]
    np.testing.assert_allclose(info["transforms"][:, :, 2],
                               np.asarray(tr_j)[:, :, 2], atol=0.5)
    assert pano_t.shape == pano_j.shape
    rmse, dy, dx = gt_rmse(pano_t, pano_j, search=3)
    assert rmse < 3.0, (rmse, dy, dx)
    gt = ortho[40:296, 40:40 + 256 + 3 * 128].astype(np.uint8)
    assert gt_rmse(pano_t, gt, search=3)[0] < 8.0
