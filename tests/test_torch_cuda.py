"""The port's CUDA kernels against their plain PyTorch versions on a card.

Imports torch and the port only (no JAX), so it also runs where JAX is not
installed:

    python -m pytest tests/test_torch_cuda.py -q -m gpu

Tests marked ``gpu`` skip where ``torch.cuda.is_available()`` is False;
the unmarked ones check, on any machine, what the wrappers do around the
kernels.
"""

import math
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from drone_image_stitch_cpp_tpu_torch.ops import sift_kernel as SK  # noqa
from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK  # noqa
from drone_image_stitch_cpp_tpu_torch.runtime import kernels  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels run only there)")
    return torch.device("cuda", 0)


def _stack(dev, seed=0, l_=4, h=96, w=160):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((l_, h, w), generator=g) * 255.0
    # smooth a little so gradients have structure
    x = torch.nn.functional.avg_pool2d(x[:, None], 3, 1, 1)[:, 0]
    return x.to(dev)


def _keypoints(dev, n=200, h=96, w=160, seed=1):
    g = torch.Generator().manual_seed(seed)
    layer = torch.randint(0, 4, (n,), generator=g, dtype=torch.int32)
    yf = torch.rand((n,), generator=g) * (h - 1)
    xf = torch.rand((n,), generator=g) * (w - 1)
    sig = 1.6 + torch.rand((n,), generator=g) * 1.99
    th = torch.full((n,), float(h))
    tw = torch.full((n,), float(w))
    th[: n // 4] = h * 0.5              # smaller "octaves" in the same stack
    tw[: n // 4] = w * 0.5
    return [a.to(dev) for a in (layer, yf, xf, sig, th, tw)]


def _launch_counts():
    return (SK.orientation_descriptor_flat.launches, WK.warp_frame.launches,
            WK.warp_frames.launches, WK.warp_frame.nonblack_launches,
            WK.warp_frame.f32_launches, WK.warp_frame.i420_launches,
            WK.warp_frame.i420_staged_launches, WK.warp_planes.launches)


def test_cpu_calls_are_not_counted_as_launches():
    before = _launch_counts()
    SK.orientation_descriptor_flat(_stack("cpu"), *_keypoints("cpu", n=8))
    a23 = np.asarray([[1, 0, 1.5], [0, 1, 0]], np.float32)
    for content in WK.CONTENT_MODES:
        WK.warp_frame(torch.zeros((16, 16, 3), dtype=torch.uint8), a23, 16,
                      16, content=content)
        WK.warp_frames(torch.zeros((2, 16, 16, 3), dtype=torch.uint8),
                       np.stack([a23, a23]), 16, 16, content=content)
    WK.warp_frame(torch.zeros((16, 16, 3)), a23, 16, 16)
    WK.warp_frames(torch.zeros((2, 16, 16, 3)), np.stack([a23, a23]), 16, 16)
    WK.warp_frame(torch.zeros((24, 16), dtype=torch.uint8), a23, 16, 16)
    WK.warp_frames(torch.zeros((2, 24, 16), dtype=torch.uint8),
                   np.stack([a23, a23]), 16, 16)
    WK.warp_planes(torch.zeros((2, 16, 16)), np.stack([a23, a23]), 16, 16)
    WK.warp_planes(torch.zeros((2, 16, 16)), torch.from_numpy(
        np.stack([a23, a23])), 16, 16)
    assert _launch_counts() == before


def test_load_kernels_stops_every_build_when_one_fails(tmp_path,
                                                      monkeypatch):
    """The kernels' compilers start together; when one fails, the error
    comes at once and the other build is stopped and leaves no file (a
    stand-in compiler refuses K1's source and takes 60 s over K2's)."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\ncase "$*" in *sift*) echo refused >&2; '
                    'exit 1;; esac\nsleep 60\n')
    fake.chmod(0o755)
    build = tmp_path / "build"
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build))
    monkeypatch.setattr(kernels, "_BUILT", {})
    t0 = time.perf_counter()
    with pytest.raises(kernels.KernelBuildError, match="refused"):
        kernels.load_kernels({m.KERNEL_SOURCE: m.KERNEL_SIGNATURES
                              for m in (SK, WK)})
    assert time.perf_counter() - t0 < 30
    assert list(build.iterdir()) == []


def test_support_radius_covers_every_detected_scale():
    sig_max = 1.6 * 2.0 ** (3.5 / 3)
    assert SK.support_radius(sig_max) <= SK.SUPPORT_R
    # descriptor support (2.5 * sqrt(2) * 3 sigma) + 0.5 px centre offset
    # + the central-difference ring fits the window
    assert 2.5 * math.sqrt(2) * 3 * sig_max + 0.5 + 1 <= SK.SUPPORT_R
    assert SK.support_radius(1.6) < SK.SUPPORT_R


def test_kernel_sources_present():
    for src in ("sift_orient_desc.cu", "warp_affine.cu"):
        assert os.path.exists(os.path.join(kernels.CSRC_DIR, src))
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


@pytest.mark.gpu
def test_k1_kernel_matches_plain(cuda):
    gauss = _stack(cuda)
    kp = _keypoints(cuda)
    n0 = SK.orientation_descriptor_flat.launches
    ang_k, desc_k = SK.orientation_descriptor_flat(gauss, *kp)
    assert SK.orientation_descriptor_flat.launches == n0 + 1
    ang_p, desc_p = SK.orientation_descriptor_plain(gauss, *kp)
    torch.cuda.synchronize()
    _assert_k1_close(ang_k, desc_k, ang_p, desc_p)


def _assert_k1_close(ang_k, desc_k, ang_p, desc_p, min_same=0.99):
    dang = (torch.remainder(ang_k - ang_p + math.pi, 2 * math.pi)
            - math.pi).abs()
    l2 = torch.linalg.norm(desc_k - desc_p, dim=-1)
    same = dang < 0.02
    # the kernel sums in another (fixed) order than the plain version:
    # near-tied histogram peaks may flip
    assert same.float().mean() >= min_same, dang
    assert float(l2[same].max()) < 2.0, l2


@pytest.mark.gpu
def test_k1_kernel_is_bit_identical_across_launches(cuda):
    gauss = _stack(cuda, h=160, w=256)
    kp = _keypoints(cuda, n=600, h=160, w=256)
    ang_a, desc_a = SK.orientation_descriptor_flat(gauss, *kp)
    ang_b, desc_b = SK.orientation_descriptor_flat(gauss, *kp)
    torch.cuda.synchronize()
    assert torch.equal(ang_a, ang_b) and torch.equal(desc_a, desc_b)


@pytest.mark.gpu
def test_k1_kernel_matches_plain_at_extremes(cuda):
    """sigma at both ends of the detected range (1.6 and 3.59), keypoints
    on and next to every stack border, and keypoints of tiny octaves
    (smaller than their support window) in the same stack."""
    h, w = 96, 160
    gauss = _stack(cuda, seed=3, h=h, w=w)
    ys = [0.0, 0.4, 1.0, 2.6, h / 2 + 0.3, h - 3.2, h - 1.6, h - 1.0]
    xs = [0.0, 0.7, 1.2, 3.4, w / 2 - 0.2, w - 2.5, w - 1.4, w - 1.0]
    pts = [(y_, x_) for y_ in ys for x_ in xs]
    rows = []
    for sig in (1.6, 3.59):
        for th, tw in ((h, w), (12, 20), (6, 9)):
            for y_, x_ in pts:
                rows.append((1, min(y_, th - 1.0), min(x_, tw - 1.0), sig,
                             th, tw))
    cols = list(zip(*rows))
    kp = [torch.tensor(cols[0], dtype=torch.int32, device=cuda)] + [
        torch.tensor(c, dtype=torch.float32, device=cuda) for c in cols[1:]]
    ang_k, desc_k = SK.orientation_descriptor_flat(gauss, *kp)
    ang_p, desc_p = SK.orientation_descriptor_plain(gauss, *kp)
    torch.cuda.synchronize()
    assert torch.isfinite(ang_k).all() and torch.isfinite(desc_k).all()
    _assert_k1_close(ang_k, desc_k, ang_p, desc_p, min_same=0.98)


@pytest.mark.gpu
def test_k2_kernel_bit_equal_to_plain(cuda):
    g = torch.Generator().manual_seed(2)
    img = torch.randint(0, 256, (300, 420, 3), generator=g,
                        dtype=torch.uint8).to(cuda)
    th = math.radians(15.0)
    a23 = np.asarray([[math.cos(th), -math.sin(th), 12000.5 - 11904.0],
                      [math.sin(th), math.cos(th), -30.25]], np.float32)
    n0 = WK.warp_frame.launches
    wk, mk = WK.warp_frame(img, a23, 320, 512)
    assert WK.warp_frame.launches == n0 + 1
    wp, mp = WK.warp_frame_plain(img, WK.inverse_coeffs(a23), 320, 512)
    assert torch.equal(wk, wp) and torch.equal(mk, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("out_hw", [(1, 1), (3, 5), (7, 4099), (320, 512)])
def test_k2_kernel_bit_equal_to_plain_ragged(cuda, out_hw):
    """Output sizes whose pixel count is not a multiple of 4 (the vector
    stores' tail) and rows shorter than the 4 pixels of a thread."""
    g = torch.Generator().manual_seed(4)
    img = torch.randint(0, 256, (37, 53, 3), generator=g,
                        dtype=torch.uint8).to(cuda)
    a23 = np.asarray([[0.9, 0.05, -2.3], [-0.04, 1.1, 1.7]], np.float32)
    oh, ow = out_hw
    wk, mk = WK.warp_frame(img, a23, oh, ow)
    wp, mp = WK.warp_frame_plain(img, WK.inverse_coeffs(a23), oh, ow)
    assert torch.equal(wk, wp) and torch.equal(mk, mp)


@pytest.mark.gpu
def test_k2_kernel_all_out_of_range(cuda):
    img = torch.full((20, 30, 3), 200, dtype=torch.uint8, device=cuda)
    for a23 in ([[1, 0, 500.25], [0, 1, 0]], [[1, 0, 0], [0, 1, -90.5]],
                [[1, 0, -3.0e9], [0, 1, 3.0e9]]):
        a23 = np.asarray(a23, np.float32)
        wk, mk = WK.warp_frame(img, a23, 17, 23)
        wp, mp = WK.warp_frame_plain(img, WK.inverse_coeffs(a23), 17, 23)
        assert torch.equal(wk, wp) and torch.equal(mk, mp)
        assert not wk.any() and not mk.any()


@pytest.mark.gpu
@pytest.mark.parametrize("out_hw", [(64, 128), (37, 53)])
def test_k2_batched_equals_per_frame(cuda, out_hw):
    g = torch.Generator().manual_seed(5)
    frames = torch.randint(0, 256, (5, 120, 200, 3), generator=g,
                           dtype=torch.uint8).to(cuda)
    th = math.radians(3.0)
    a23s = np.stack([np.asarray(
        [[0.3 * math.cos(th * k), -0.3 * math.sin(th * k), 7.31 * k],
         [0.3 * math.sin(th * k), 0.3 * math.cos(th * k), 1.17 * k]],
        np.float32) for k in range(5)])
    oh, ow = out_hw
    n0 = WK.warp_frames.launches
    wimgs, masks = WK.warp_frames(frames, a23s, oh, ow)
    assert WK.warp_frames.launches == n0 + 1
    for k in range(5):
        wk, mk = WK.warp_frame(frames[k], a23s[k], oh, ow)
        assert torch.equal(wimgs[k], wk) and torch.equal(masks[k], mk)
    wp, mp = WK.warp_frames_plain(
        frames, [WK.inverse_coeffs(a) for a in a23s], oh, ow)
    assert torch.equal(wimgs, wp) and torch.equal(masks, mp)


def _near_threshold_frame(dev, h=37, w=53, seed=6):
    """A frame whose pixels sit at and around the content test's gray 2:
    every (b, g, r) in 0..4, the single-channel steps 17/18 (blue alone
    crosses 2 between them), black and random texture."""
    g = torch.Generator().manual_seed(seed)
    img = torch.randint(0, 256, (h, w, 3), generator=g, dtype=torch.uint8)
    v = torch.arange(5, dtype=torch.uint8)
    small = torch.stack(torch.meshgrid(v, v, v, indexing="ij"),
                        -1).reshape(-1, 3)
    img[:5, :25] = small.reshape(5, 25, 3)
    img[5:8, :20] = torch.tensor([17, 0, 0], dtype=torch.uint8)
    img[5:8, 20:40] = torch.tensor([18, 0, 0], dtype=torch.uint8)
    img[8:12, :] = 0
    img[12:15, :] = 2
    return img.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("out_hw", [(1, 1), (3, 5), (7, 4099), (64, 96)])
def test_k2_content_mode_bit_equal_to_plain(cuda, out_hw):
    """K2's gray > 2 content mask against its plain version: ragged output
    sizes, an identity window over the crafted pixels (each tap's decision
    shows unblended) and rotated ones."""
    img = _near_threshold_frame(cuda)
    oh, ow = out_hw
    n0 = WK.warp_frame.nonblack_launches
    for a23 in ([[1, 0, 0], [0, 1, 0]], [[0.9, 0.05, -2.3], [-0.04, 1.1, 1.7]],
                [[0.5, -0.2, 3.25], [0.2, 0.5, -0.75]]):
        a23 = np.asarray(a23, np.float32)
        wk, mk = WK.warp_frame(img, a23, oh, ow, content="nonblack")
        wp, mp = WK.warp_frame_plain(img, WK.inverse_coeffs(a23), oh, ow,
                                     content="nonblack")
        assert torch.equal(wk, wp) and torch.equal(mk, mp)
    assert WK.warp_frame.nonblack_launches == n0 + 3
    if out_hw == (64, 96):
        wk, mk = WK.warp_frame(img, np.asarray([[1, 0, 0], [0, 1, 0]],
                                               np.float32), oh, ow,
                               content="nonblack")
        # the identity window shows each tap's decision: black and gray-2
        # rows are out, the (18, 0, 0) run is in and (17, 0, 0) is out
        assert not mk[8:15, :53].any()
        assert mk[5:8, 20:40].eq(1).all() and not mk[5:8, :20].any()


@pytest.mark.gpu
def test_k2_content_mode_out_of_range_and_batched(cuda):
    img = _near_threshold_frame(cuda)
    for a23 in ([[1, 0, 500.25], [0, 1, 0]], [[1, 0, -3.0e9], [0, 1, 3.0e9]]):
        a23 = np.asarray(a23, np.float32)
        wk, mk = WK.warp_frame(img, a23, 17, 23, content="nonblack")
        assert not wk.any() and not mk.any()
    frames = torch.stack([img, img.flip(1), img.flip(0)])
    a23s = np.stack([np.asarray([[1, 0, k * 1.5], [0, 1, -k * 0.25]],
                                np.float32) for k in range(3)])
    n0 = WK.warp_frame.nonblack_launches
    wimgs, masks = WK.warp_frames(frames, a23s, 40, 60, content="nonblack")
    # the batched content-mode launch counts in the one shared counter
    assert WK.warp_frame.nonblack_launches == n0 + 1
    wp, mp = WK.warp_frames_plain(
        frames, [WK.inverse_coeffs(a) for a in a23s], 40, 60,
        content="nonblack")
    assert torch.equal(wimgs, wp) and torch.equal(masks, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("scale,out_hw", [(0.1433, (147, 509)),
                                          (0.3367, (173, 689))])
def test_seam_fullres_warp_is_one_content_launch(cuda, scale, out_hw):
    """The global stage's full-resolution seam warp
    (``pipeline/global_._to_seam_fullres``): a padded strip (texture,
    near-threshold pixels, black pad) minified into a ragged seam canvas
    by one K2 content-mode launch, bit-equal to the plain version, its
    mask the plain footprint kept at >= 0.999."""
    from drone_image_stitch_cpp_tpu_torch.pipeline import global_ as TG
    strip = torch.zeros((1024, 3584, 3), dtype=torch.uint8, device=cuda)
    strip[:900, :3300] = _near_threshold_frame(cuda, 900, 3300)
    strip[300:420, 1000:2900] = 2           # gray 2: not content
    t_seam = (np.diag([scale, scale]).astype(np.float32) @ np.asarray(
        [[1.0, 0.0004, 11.3], [-0.0004, 1.0, 140.61]], np.float32)
              ).astype(np.float32)
    oh, ow = out_hw
    n0, l0 = WK.warp_frame.nonblack_launches, WK.warp_frame.launches
    simg, smask = TG._to_seam_fullres(strip, t_seam, oh, ow)
    assert WK.warp_frame.nonblack_launches == n0 + 1
    assert WK.warp_frame.launches == l0 + 1
    wp, mp = WK.warp_frame_plain(strip, WK.inverse_coeffs(t_seam), oh, ow,
                                 content="nonblack")
    assert torch.equal(simg, wp) and torch.equal(smask, mp >= 0.999)
    assert 0.1 < float(smask.float().mean()) < 0.9


def _float_frames(dev, n=None, h=37, w=53, seed=7):
    """Float32 BGR frames with fractional values (as area-resized frames
    have), including values above 255 and below 0."""
    g = torch.Generator().manual_seed(seed)
    shape = (h, w, 3) if n is None else (n, h, w, 3)
    return (torch.rand(shape, generator=g) * 300.0 - 20.0).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("out_hw", [(1, 1), (3, 5), (7, 4099), (320, 512)])
def test_k2_float32_bit_equal_to_plain_ragged(cuda, out_hw):
    """K2's float32 source against its plain version: output sizes whose
    pixel count is not a multiple of 4, a rotation at canvas coordinates,
    and a scale-down."""
    img = _float_frames(cuda)
    oh, ow = out_hw
    th = math.radians(15.0)
    n0 = WK.warp_frame.f32_launches
    for a23 in ([[0.9, 0.05, -2.3], [-0.04, 1.1, 1.7]],
                [[math.cos(th), -math.sin(th), 12000.5 - 11990.0],
                 [math.sin(th), math.cos(th), -3.25]],
                [[0.49, 0.0, 0.37], [0.0, 0.49, 1.61]]):
        a23 = np.asarray(a23, np.float32)
        wk, mk = WK.warp_frame(img, a23, oh, ow)
        wp, mp = WK.warp_frame_plain(img, WK.inverse_coeffs(a23), oh, ow)
        assert torch.equal(wk, wp) and torch.equal(mk, mp)
    assert WK.warp_frame.f32_launches == n0 + 3


@pytest.mark.gpu
def test_k2_float32_all_out_of_range(cuda):
    img = _float_frames(cuda, h=20, w=30)
    for a23 in ([[1, 0, 500.25], [0, 1, 0]], [[1, 0, 0], [0, 1, -90.5]],
                [[1, 0, -3.0e9], [0, 1, 3.0e9]]):
        a23 = np.asarray(a23, np.float32)
        wk, mk = WK.warp_frame(img, a23, 17, 23)
        wp, mp = WK.warp_frame_plain(img, WK.inverse_coeffs(a23), 17, 23)
        assert torch.equal(wk, wp) and torch.equal(mk, mp)
        assert not wk.any() and not mk.any()


@pytest.mark.gpu
@pytest.mark.parametrize("out_hw", [(64, 128), (37, 53)])
def test_k2_float32_batched_equals_per_frame(cuda, out_hw):
    frames = _float_frames(cuda, n=5, h=120, w=200)
    a23s = np.stack([np.asarray([[0.3, -0.01 * k, 7.31 * k],
                                 [0.01 * k, 0.3, 1.17 * k]], np.float32)
                     for k in range(5)])
    oh, ow = out_hw
    n0 = (WK.warp_frames.launches, WK.warp_frame.f32_launches)
    wimgs, masks = WK.warp_frames(frames, a23s, oh, ow)
    # one launch, counted by the batched wrapper and the shared f32 count
    assert (WK.warp_frames.launches, WK.warp_frame.f32_launches) == (
        n0[0] + 1, n0[1] + 1)
    for k in range(5):
        wk, mk = WK.warp_frame(frames[k], a23s[k], oh, ow)
        assert torch.equal(wimgs[k], wk) and torch.equal(masks[k], mk)
    wp, mp = WK.warp_frames_plain(
        frames, [WK.inverse_coeffs(a) for a in a23s], oh, ow)
    assert torch.equal(wimgs, wp) and torch.equal(masks, mp)


@pytest.mark.gpu
def test_k2_uint8_unchanged_beside_float32(cuda):
    """A uint8 frame and its float32 copy warp to the same planes, and the
    uint8 launches stay bit-equal to their plain version."""
    g = torch.Generator().manual_seed(8)
    img = torch.randint(0, 256, (300, 420, 3), generator=g,
                        dtype=torch.uint8).to(cuda)
    a23 = np.asarray([[0.97, -0.2, 31.5], [0.2, 0.97, -12.25]], np.float32)
    n0 = WK.warp_frame.f32_launches
    wu, mu = WK.warp_frame(img, a23, 320, 512)
    assert WK.warp_frame.f32_launches == n0
    wf, mf = WK.warp_frame(img.float(), a23, 320, 512)
    assert WK.warp_frame.f32_launches == n0 + 1
    wp, mp = WK.warp_frame_plain(img, WK.inverse_coeffs(a23), 320, 512)
    assert torch.equal(wu, wp) and torch.equal(mu, mp)
    assert torch.equal(wf, wu) and torch.equal(mf, mu)
    with pytest.raises(ValueError):
        WK.warp_frame(img.float(), a23, 32, 32, content="nonblack")


def _i420_frames(dev, n=None, h=36, w=54, seed=9):
    """Random packed I420 frames (N, H*3/2, W) uint8: independent Y, U
    and V bytes, so every chroma neighbour and clip is exercised."""
    g = torch.Generator().manual_seed(seed)
    shape = (h * 3 // 2, w) if n is None else (n, h * 3 // 2, w)
    return torch.randint(0, 256, shape, generator=g,
                         dtype=torch.uint8).to(dev)


def _i420_both_branches(frames, a23s, oh, ow):
    """K2's I420 source on ``frames`` (one packed frame or a batch) through
    its wrapper and with each kernel forced: all three bit-equal to the
    plain version. Returns whether the host plan staged the launch."""
    batched = frames.ndim == 3
    invs = [WK.inverse_coeffs(a) for a in a23s]
    h, w = frames.shape[-2] * 2 // 3, frames.shape[-1]
    plan = WK.i420_plan(invs, h, w, oh, ow)
    n0 = (WK.warp_frame.i420_launches, WK.warp_frame.i420_staged_launches)
    if batched:
        wrapped = WK.warp_frames(frames, a23s, oh, ow)
        wp, mp = WK.warp_frames_plain(frames, invs, oh, ow)
    else:
        wrapped = WK.warp_frame(frames, a23s[0], oh, ow)
        wp, mp = WK.warp_frame_plain(frames, invs[0], oh, ow)
    assert (WK.warp_frame.i420_launches,
            WK.warp_frame.i420_staged_launches) == (n0[0] + 1,
                                                    n0[1] + (plan is not None))
    outs = [wrapped]
    for staged in (True, False):
        wk, mk, took = WK._launch(frames, len(invs), invs if batched
                                  else invs[0], oh, ow, i420_staged=staged)
        assert took == staged
        outs.append((wk, mk))
    torch.cuda.synchronize()
    for wk, mk in outs:
        assert torch.equal(wk, wp) and torch.equal(mk, mp)
    return plan is not None


@pytest.mark.gpu
@pytest.mark.parametrize("out_hw", [(1, 1), (3, 5), (7, 4099), (320, 512)])
def test_k2_i420_bit_equal_to_plain(cuda, out_hw):
    """K2's I420 source, staged and per tap, against its plain version
    (yuv420_to_bgr, then the float warp): windows over all four frame
    borders (chroma edge replication, odd and even taps), a rotation at
    canvas coordinates and a scale-down; each wrapper launch counts as an
    I420 launch, and as a staged one where the host plan says so."""
    img = _i420_frames(cuda)
    th = math.radians(15.0)
    for a23 in ([[1.3, 0.05, 40.3], [-0.04, 1.1, 30.7]],
                [[0.9, 0.05, -2.3], [-0.04, 1.1, 1.7]],
                [[math.cos(th), -math.sin(th), 12000.5 - 11990.0],
                 [math.sin(th), math.cos(th), -3.25]],
                [[0.49, 0.0, 0.37], [0.0, 0.49, 1.61]]):
        _i420_both_branches(img, [np.asarray(a23, np.float32)], *out_hw)


@pytest.mark.gpu
def test_k2_i420_batched_equals_per_frame_and_plain(cuda):
    """A 5-frame batch at scale 0.3: the plan takes the per-tap kernel (a
    tile's box would need ~300 KB of shared memory)."""
    frames = _i420_frames(cuda, n=5, h=120, w=200)
    a23s = np.stack([np.asarray([[0.3, -0.01 * k, 7.31 * k],
                                 [0.01 * k, 0.3, 1.17 * k]], np.float32)
                     for k in range(5)])
    n0 = (WK.warp_frames.launches, WK.warp_frame.i420_launches,
          WK.warp_frame.i420_staged_launches)
    wimgs, masks = WK.warp_frames(frames, a23s, 64, 130)
    assert (WK.warp_frames.launches, WK.warp_frame.i420_launches,
            WK.warp_frame.i420_staged_launches) == (n0[0] + 1, n0[1] + 1,
                                                    n0[2])
    wp, mp = WK.warp_frames_plain(
        frames, [WK.inverse_coeffs(a) for a in a23s], 64, 130)
    assert torch.equal(wimgs, wp) and torch.equal(masks, mp)
    for k in (0, 4):
        wk, mk = WK.warp_frame(frames[k], a23s[k], 64, 130)
        assert torch.equal(wimgs[k], wk) and torch.equal(masks[k], mk)


@pytest.mark.gpu
@pytest.mark.parametrize("out_hw", [(131, 211), (37, 4099)])
def test_k2_i420_staged_batch_of_different_affines(cuda, out_hw):
    """Five near-identity frames, each with its own rotation and offset
    (each block reads its frame's coefficients; the shared memory is sized
    for the worst frame): staged by the plan, both kernels bit-equal."""
    frames = _i420_frames(cuda, n=5, h=120, w=200)
    a23s = np.stack([np.asarray([[1.0, 0.01 * k, 2.3 * k - 3],
                                 [-0.01 * k, 1.0, 1.1 * k - 2]], np.float32)
                     for k in range(5)])
    assert _i420_both_branches(frames, a23s, *out_hw)


@pytest.mark.gpu
def test_k2_i420_window_outside_the_frame(cuda):
    """Every tile's box is empty: zeros from both kernels, as plain."""
    img = _i420_frames(cuda)
    a23 = np.asarray([[1.0, 0.0, 500.0], [0.0, 1.0, 500.0]], np.float32)
    assert _i420_both_branches(img, [a23], 40, 60)
    wk, mk = WK.warp_frame(img, a23, 40, 60)
    assert not wk.any() and not mk.any()


def test_k2_i420_rejects_what_it_cannot_read():
    """Packed frames need H % 4 == 0 (H*3/2 rows a multiple of 6) and an
    even width, and warp in footprint mode only."""
    a23 = np.asarray([[1, 0, 0.5], [0, 1, 0]], np.float32)
    for shape in ((27, 16), (24, 15), (0, 16)):
        with pytest.raises(ValueError):
            WK.warp_frame(torch.zeros(shape, dtype=torch.uint8), a23, 8, 8)
    with pytest.raises(ValueError):
        WK.warp_frame(torch.zeros((24, 16), dtype=torch.uint8), a23, 8, 8,
                      content="nonblack")
    with pytest.raises(ValueError):
        WK.warp_frames(torch.zeros((2, 27, 16), dtype=torch.uint8),
                       np.stack([a23, a23]), 8, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("nf", [1, 2, 12, WK.BY_VALUE_MAX,
                                WK.BY_VALUE_MAX + 1])
def test_k2_batch_coefficients_by_value(cuda, nf):
    """The batched K2 passes up to BY_VALUE_MAX frames' coefficients by
    value (a block of one set for one frame, of BY_VALUE_MAX sets for
    more) and a device table above: the uint8 seam batch and the I420
    seam batch (per tap) at N = 1, 2, 12, the cap and the cap + 1, one
    launch each, every frame bit-equal to plain."""
    g = torch.Generator().manual_seed(nf)
    frames = torch.randint(0, 256, (nf, 160, 240, 3), generator=g,
                           dtype=torch.uint8).to(cuda)
    packed = _i420_frames(cuda, n=nf, h=160, w=240, seed=nf)
    rng = np.random.default_rng(nf)
    a23s = np.stack([np.asarray([[0.2, rng.normal(0, 0.01), 5 * k % 40],
                                 [rng.normal(0, 0.01), 0.2, 2.5]],
                                np.float32) for k in range(nf)])
    invs = [WK.inverse_coeffs(a) for a in a23s]
    assert WK.i420_plan(invs, 160, 240, 16, 48) is None     # per tap
    for src in (frames, packed):
        n0 = WK.warp_frames.launches
        wk, mk = WK.warp_frames(src, a23s, 16, 48)
        assert WK.warp_frames.launches == n0 + 1
        wp, mp = WK.warp_frames_plain(src, invs, 16, 48)
        assert torch.equal(wk, wp) and torch.equal(mk, mp)


def _routes(src, a23s, oh, ow, content="ones", entry=False, **kw):
    """One launch of K2's gather kernel on ``src`` (a frame, or a batch)
    by the host (N, 2, 3) ``a23s`` with its tile counter: the coefficients
    of the kernel library's host inverse (``entry``: host_inverse_coeffs,
    as the wrappers pass them) or of inverse_coeffs, against the plain
    version bit for bit. Returns {route: tiles}."""
    invs = [WK.inverse_coeffs(a) for a in a23s]
    one = len(a23s) == 1 and src.ndim == (2 if WK._is_i420(src) else 3)
    tiles = torch.zeros(len(WK.ROUTES), dtype=torch.int32, device=src.device)
    sets = WK.host_inverse_coeffs(a23s) if entry else (
        invs[0] if one else invs)
    wk, mk, _ = WK._launch(src, len(a23s), sets, oh, ow, content,
                           tiles=tiles, **kw)
    if one:
        wp, mp = WK.warp_frame_plain(src, invs[0], oh, ow, content)
    else:
        wp, mp = WK.warp_frames_plain(src, invs, oh, ow, content)
    torch.cuda.synchronize()
    for got, want in ((wk, wp), (mk, mp)):      # NaN where plain has NaN
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    return dict(zip(WK.ROUTES, tiles.tolist()))


def _n_tiles(nf, oh, ow):
    return nf * -(-oh // WK.TILE[0]) * -(-ow // WK.TILE[1])


def _rot(deg, tx, ty, s=1.0):
    c, sn = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.asarray([[s * c, -s * sn, tx], [s * sn, s * c, ty]],
                      np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("a23", [_rot(0.0, -0.37, 12.6), _rot(2.0, 7.3, -11.6),
                                 _rot(-1.0, 40.25, -3.5, 1.02)])
def test_k2_f32_one_frame_zero_and_direct(cuda, a23):
    """K2's float32 source at one frame (the compositing feed): the
    wrapper passes the coefficients of the kernel library's host inverse;
    the window is larger than the frame, so tiles straddle its edges and
    some are zero, the rest direct. All bit-equal to plain; inverse_coeffs'
    coefficients give the same warp and the same routes."""
    img = _float_frames(cuda, h=300, w=420)
    oh, ow = 331, 517
    n0 = WK.warp_frame.f32_launches
    wk, mk = WK.warp_frame(img, a23, oh, ow)
    assert WK.warp_frame.f32_launches == n0 + 1
    wp, mp = WK.warp_frame_plain(img, WK.inverse_coeffs(a23), oh, ow)
    assert torch.equal(wk, wp) and torch.equal(mk, mp)
    r = _routes(img, a23[None], oh, ow, entry=True)
    assert r["zero"] > 0 and r["direct"] > 0
    assert sum(r.values()) == _n_tiles(1, oh, ow)
    assert _routes(img, a23[None], oh, ow) == r


@pytest.mark.gpu
def test_k2_f32_compositing_shape(cuda):
    """The compositing feed's shape, 1061x1886 into 1088x2048 by a
    near-identity affine: the tiles past the frame's edges are zero, the
    rest direct, bit-equal to plain."""
    img = _float_frames(cuda, h=1061, w=1886, seed=12)
    a23 = _rot(0.01, 3.62, 9.41)
    r = _routes(img, a23[None], 1088, 2048, entry=True)
    assert r["direct"] > r["zero"] > 0
    assert sum(r.values()) == _n_tiles(1, 1088, 2048)


@pytest.mark.gpu
def test_k2_f32_singular_model_raises(cuda):
    """The wrapper's host test is inverse_coeffs' own: a singular affine
    raises in host_inverse_coeffs and launches nothing (the tile counter of
    a bare launch of its coefficients stays 0)."""
    img = _float_frames(cuda, h=20, w=30)
    n0 = WK.warp_frame.launches
    tiles = torch.zeros(len(WK.ROUTES), dtype=torch.int32, device=cuda)
    for a23 in ([[1, 2, 0], [2, 4, 0]], [[0, 0, 1], [0, 0, 2]]):
        a23 = np.asarray(a23, np.float32)
        for src in (img, img.to(torch.uint8)):
            with pytest.raises(ValueError):
                WK.warp_frame(src, a23, 17, 23)
            with pytest.raises(ValueError):
                WK._launch(src, 1, WK.host_inverse_coeffs(a23), 17, 23,
                           tiles=tiles)
    assert WK.warp_frame.launches == n0
    assert tiles.tolist() == [0] * len(WK.ROUTES)


def _seam_batch_affines(nf, scale, step_x=1152.0, step_y=0.0):
    """A flight line's seam-scale warps, ``nf`` frames step_x apart."""
    return np.stack([_rot(0.0, scale * step_x * k, scale * step_y * k,
                          scale) for k in range(nf)])


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [0.1203, 0.1449])
def test_k2_i420_flagship_seam_batch_zero_tiles_and_shared_chroma(cuda,
                                                                  scale):
    """The flagship's seam batch: 20 packed 2160x3840 frames into one
    320-row window at the strips' seam scale (0.1203) and the global
    stage's (0.1449): the plan takes the gather kernel, most tiles are
    zero, the rest gather each quad's shared chroma; the wrapper and the
    counted launch bit-equal to plain."""
    frames = _i420_frames(cuda, n=20, h=2160, w=3840, seed=13)
    a23s = _seam_batch_affines(20, scale)
    oh, ow = 320, 64 * -(-int(round((19 * 1152 + 3840) * scale)) // 64)
    invs = [WK.inverse_coeffs(a) for a in a23s]
    assert WK.i420_plan(invs, 2160, 3840, oh, ow) is None
    n0 = WK.warp_frame.i420_staged_launches
    wk, mk = WK.warp_frames(frames, a23s, oh, ow)
    assert WK.warp_frame.i420_staged_launches == n0
    wp, mp = WK.warp_frames_plain(frames, invs, oh, ow)
    assert torch.equal(wk, wp) and torch.equal(mk, mp)
    del wk, mk, wp, mp
    r = _routes(frames, a23s, oh, ow)
    assert r["zero"] > r["direct"] > 0
    assert sum(r.values()) == _n_tiles(20, oh, ow)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_k2_bgr_seam_batch_zero_and_direct(cuda, dtype):
    """The uint8 seam batch (12 frames of 2160x3840 at 0.1203 into
    320x2048) and the float32 one of the compositing knob (frames area-
    resized to 1061x1886): zero and direct tiles, all bit-equal to
    plain."""
    g = torch.Generator().manual_seed(14)
    if dtype == torch.uint8:
        frames = torch.randint(0, 256, (12, 2160, 3840, 3), generator=g,
                               dtype=torch.uint8).to(cuda)
        a23s, oh, ow = _seam_batch_affines(12, 0.1203), 320, 2048
    else:
        frames = _float_frames(cuda, n=12, h=1061, w=1886, seed=14)
        a23s = _seam_batch_affines(12, 0.2449, step_x=566.0)
        oh, ow = 320, 2048
    invs = [WK.inverse_coeffs(a) for a in a23s]
    r = _routes(frames, a23s, oh, ow)
    assert r["zero"] > 0 and r["direct"] > 0
    wk, mk = WK.warp_frames(frames, a23s, oh, ow)
    wp, mp = WK.warp_frames_plain(frames, invs, oh, ow)
    assert torch.equal(wk, wp) and torch.equal(mk, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("deg", [30.0, 90.0, -135.0])
def test_k2_rotated_frame_every_source(cuda, deg):
    """A frame rotated by 30, 90 and -135 degrees about a canvas point:
    uint8 (both content modes), float32 and packed I420 (per tap), each
    bit-equal to plain, with its routes counted."""
    g = torch.Generator().manual_seed(15)
    u8 = torch.randint(0, 256, (150, 230, 3), generator=g,
                       dtype=torch.uint8).to(cuda)
    a23 = _rot(deg, 12000.5 - 11900.0, 130.25)
    oh, ow = 300, 400
    for content in WK.CONTENT_MODES:
        r = _routes(u8, a23[None], oh, ow, content, entry=True)
        assert r["direct"] > 0
    r = _routes(u8.float(), a23[None], oh, ow, entry=True)
    assert r["direct"] > 0
    r = _routes(_i420_frames(cuda, h=148, w=230), a23[None], oh, ow,
                i420_staged=False)
    assert r["direct"] > 0


@pytest.mark.gpu
def test_k2_window_outside_the_frame_is_all_zero_tiles(cuda):
    """A window wholly outside the frame: every tile zero, for each
    source, and zeros as plain gives them; coordinates that are not finite
    are never zero tiles (plain gives NaN there)."""
    u8 = torch.randint(0, 256, (40, 60, 3), dtype=torch.uint8,
                       device=cuda)
    a23 = np.asarray([[1.0, 0.0, 500.25], [0.0, 1.0, -300.5]], np.float32)
    oh, ow = 61, 300
    for src, kw in ((u8, {"entry": True}), (u8.float(), {"entry": True}),
                    (_i420_frames(cuda, h=40, w=60), {"i420_staged": False})):
        r = _routes(src, a23[None], oh, ow, **kw)
        assert r == {"zero": _n_tiles(1, oh, ow), "direct": 0}
    # 1 / 1e-39 overflows: row 0's coordinates are NaN (inf * 0), the
    # rest infinite, so plain gives NaN, and no tile is zero; the affine is
    # not singular, so the host inverse launches its coefficients
    huge = np.asarray([[1.0, 0.0, 0.0], [0.0, 1e-39, 0.0]], np.float32)
    for src in (u8, u8.float()):
        r = _routes(src, huge[None], 20, 30, entry=True)
        assert r == {"zero": 0, "direct": _n_tiles(1, 20, 30)}


_PLANE_AFFINES = (
    [[0.99987453, -4.4592799e-04, -59.63], [4.4592799e-04, 0.99987453,
                                           -14.9]],
    [[0.9, 0.05, -2.3], [-0.04, 1.1, 1.7]],
    [[math.cos(0.26), -math.sin(0.26), 12000.5 - 11990.0],
     [math.sin(0.26), math.cos(0.26), -3.25]],
    [[0.49, 0.0, 0.37], [0.0, 0.49, 1.61]],
    [[1, 0, 500.25], [0, 1, 0]],
    [[1, 0, -3.0e9], [0, 1, 3.0e9]])


def _plane_routes(planes, a23s, oh, ow):
    """K2's single-plane form on ``planes`` by the host (N, 2, 3) float32
    ``a23s``: the wrapper with the transforms on the card and on the host
    (each call one counted launch) and both routes forced, all bit-equal
    to the plain version; returns the tiles that the staged launch
    staged."""
    dev = planes.device
    dev_a = torch.from_numpy(a23s).to(dev)
    n0 = WK.warp_planes.launches
    got_dev = WK.warp_planes(planes, dev_a, oh, ow)
    got_host = WK.warp_planes(planes, a23s, oh, ow)
    assert WK.warp_planes.launches == n0 + 2
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    staged = WK._launch_planes(planes, dev_a, oh, ow, direct=False,
                               staged_tiles=counts[0])
    direct = WK._launch_planes(planes, dev_a, oh, ow, direct=True,
                               staged_tiles=counts[1])
    plain = WK.warp_planes_plain(planes, WK.device_inverse_coeffs(dev_a),
                                 oh, ow)
    torch.cuda.synchronize()
    assert got_dev.shape == (len(planes), oh, ow)
    for got in (got_dev, got_host, staged, direct):
        assert torch.equal(got, plain)
    n_staged, n_direct = counts.tolist()
    assert n_direct == 0
    return n_staged


@pytest.mark.gpu
@pytest.mark.parametrize("out_hw", [(1, 1), (3, 5), (7, 4099), (320, 512)])
def test_k2_plane_bit_equal_to_plain(cuda, out_hw):
    """K2's single-plane form against its plain version on 37x53 planes
    (smaller than a tile, so every tile straddles the frame's edges):
    output sizes whose pixel count is not a multiple of 4, the bench's
    translation, a rotation at canvas coordinates, a scale-down and windows
    outside the frame, by both routes. Every box fits, so each tile that
    reaches the frame stages (the one pixel of a 1x1 window maps to
    source row -1.45: no tap in range, so its tile takes the direct
    gather)."""
    planes = _float_frames(cuda, n=2)[..., 0].contiguous()
    for a23 in _PLANE_AFFINES:
        a23s = np.stack([np.asarray(a23, np.float32)] * 2)
        n_staged = _plane_routes(planes, a23s, *out_hw)
        if a23 is _PLANE_AFFINES[1]:        # the window meets row 0
            assert (n_staged > 0) == (out_hw != (1, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("out_hw", [(7, 4099), (131, 211), (320, 512)])
def test_k2_plane_direct_route_and_frame_edges(cuda, out_hw):
    """300x420 planes: a scale of 0.05 and a 60-degree rotation at canvas
    coordinates give boxes beyond the block's shared memory (the direct
    gather: no tile stages at 0.05), a near-identity warp tiles that
    straddle the frame's right and bottom edges (staged); all bit-equal
    to plain by both routes."""
    planes = _float_frames(cuda, n=2, h=300, w=420)[..., 1].contiguous()
    th = math.radians(60.0)
    down = np.asarray([[0.05, 0.0, 3.3], [0.0, 0.05, 1.7]], np.float32)
    turn = np.asarray([[math.cos(th), -math.sin(th), 12000.5 - 11800.0],
                       [math.sin(th), math.cos(th), -90.25]], np.float32)
    near = np.asarray([[1.0, 0.002, -7.63], [-0.002, 1.0, -11.9]],
                      np.float32)
    assert _plane_routes(planes, np.stack([down, down]), *out_hw) == 0
    _plane_routes(planes, np.stack([turn, down]), *out_hw)
    assert _plane_routes(planes, np.stack([near, near]), *out_hw) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("out_hw", [(131, 211), (64, 128)])
def test_k2_plane_batched_equals_per_frame(cuda, out_hw):
    """Five planes, each with its own transform, in one launch: each equal
    to its own one-plane launch and to the plain version, by both routes;
    the device affines read through the strides of a (N, 3, 3) slice, as
    the throughput bench passes RANSAC's models."""
    planes = _float_frames(cuda, n=5, h=120, w=200)[..., 1].contiguous()
    models = torch.tensor([[[1.0, 0.01 * k, 2.3 * k - 3],
                            [-0.01 * k, 1.0, 1.1 * k - 2],
                            [0.0, 0.0, 1.0]] for k in range(5)],
                          device=cuda)
    a23s = models[:, :2, :]
    assert not a23s.is_contiguous()
    n0 = WK.warp_planes.launches
    got = WK.warp_planes(planes, a23s, *out_hw)
    assert WK.warp_planes.launches == n0 + 1
    plain = WK.warp_planes_plain(planes, WK.device_inverse_coeffs(a23s),
                                 *out_hw)
    assert torch.equal(got, plain)
    for direct in (False, True):
        assert torch.equal(WK._launch_planes(planes, a23s, *out_hw,
                                             direct=direct), plain)
    for k in range(5):
        one = WK.warp_planes(planes[k:k + 1], a23s[k:k + 1], *out_hw)
        assert torch.equal(one[0], got[k])
    assert _plane_routes(planes, a23s.cpu().numpy(), *out_hw) > 0


@pytest.mark.gpu
def test_k2_plane_host_affines_above_the_by_value_cap(cuda):
    """Host affines go by value up to BY_VALUE_MAX planes (a block of one
    set for one plane) and through a device copy above: each bit-equal to
    plain."""
    rng = np.random.default_rng(4)
    for nf in (1, 2, WK.BY_VALUE_MAX, WK.BY_VALUE_MAX + 1):
        planes = torch.rand((nf, 12, 20), device=cuda) * 255.0
        a23s = np.stack([np.asarray([[1.0, 0.0, rng.uniform(-3, 3)],
                                     [0.0, 1.0, rng.uniform(-3, 3)]],
                                    np.float32) for _ in range(nf)])
        got = WK.warp_planes(planes, a23s, 13, 21)
        plain = WK.warp_planes_plain(planes, torch.tensor(
            [WK.inverse_coeffs(a) for a in a23s], device=cuda), 13, 21)
        assert torch.equal(got, plain)


@pytest.mark.gpu
def test_k2_plane_in_kernel_inverse_bit_equal(cuda):
    """The card's build of csrc/affine_inverse.cuh (the inverse each block
    of the single-plane kernel computes) equals inverse_coeffs and
    device_inverse_coeffs bit for bit on the affines the CPU build is held
    to (tests/test_torch_plane_inverse.py), and is not finite on singular
    affines."""
    from drone_image_stitch_cpp_tpu_torch.utils.plane_affines import (
        bench_affines, singular_affines, wide_affines)
    for a23s in (bench_affines(), wide_affines()):
        got = WK.kernel_inverse_coeffs(torch.from_numpy(a23s).to(cuda))
        ref = np.asarray([WK.inverse_coeffs(a) for a in a23s], np.float32)
        np.testing.assert_array_equal(got.cpu().numpy(), ref)
        assert torch.equal(got, WK.device_inverse_coeffs(
            torch.from_numpy(a23s).to(cuda)))
    sing = torch.from_numpy(singular_affines()).to(cuda)
    got = WK.kernel_inverse_coeffs(sing).cpu().numpy()
    assert not np.isfinite(got).all(axis=1).any()
    np.testing.assert_array_equal(
        got, WK.device_inverse_coeffs(sing).cpu().numpy())


@pytest.mark.gpu
def test_k2_host_inverse_bit_equal(cuda):
    """The kernel library's host entry of the same inverse
    (host_inverse_coeffs, which the uint8, float32 and I420 launches take
    their coefficients from) equals inverse_coeffs bit for bit on those
    affines, and raises as it does on a singular one."""
    from drone_image_stitch_cpp_tpu_torch.utils.plane_affines import (
        bench_affines, singular_affines, wide_affines)
    for a23s in (bench_affines(), wide_affines()):
        np.testing.assert_array_equal(
            WK.host_inverse_coeffs(a23s),
            np.asarray([WK.inverse_coeffs(a) for a in a23s], np.float32))
    for a in singular_affines():
        with pytest.raises(ValueError, match="singular"):
            WK.host_inverse_coeffs(np.stack([bench_affines()[0], a]))
        with pytest.raises(ValueError, match="singular"):
            WK.warp_frame(torch.zeros((8, 8, 3), dtype=torch.uint8,
                                      device=cuda), a, 4, 4)


@pytest.mark.gpu
def test_k2_plane_singular_affine_matches_plain_where_finite(cuda):
    """A singular affine's coefficients are not finite: its warp equals the
    plain version's wherever that one is finite, beside a regular frame."""
    planes = _float_frames(cuda, n=2, h=40, w=60)[..., 0].contiguous()
    a23s = np.stack([np.asarray([[1, 2, 0], [2, 4, 0]], np.float32),
                     np.asarray([[1, 0, 1.5], [0, 1, -2.25]], np.float32)])
    dev_a = torch.from_numpy(a23s).to(cuda)
    plain = WK.warp_planes_plain(planes, WK.device_inverse_coeffs(dev_a),
                                 33, 70)
    for got in (WK.warp_planes(planes, dev_a, 33, 70),
                WK._launch_planes(planes, dev_a, 33, 70, direct=True)):
        fin = torch.isfinite(plain)
        assert torch.equal(got[fin], plain[fin])
        assert torch.equal(got[1], plain[1])


@pytest.mark.gpu
def test_k2_plane_device_transforms_make_no_host_sync(cuda):
    """The device inverse, the table and the launch never wait for the
    card: under sync debug mode "error" a synchronising call raises. The
    inverse on the card equals inverse_coeffs bit for bit."""
    planes = _float_frames(cuda, n=3, h=64, w=96)[..., 2].contiguous()
    rng = np.random.default_rng(3)
    a23s = np.stack([np.asarray([[1.0 + rng.normal(0, 0.02),
                                  rng.normal(0, 0.02), rng.normal(0, 40)],
                                 [rng.normal(0, 0.02),
                                  1.0 + rng.normal(0, 0.02),
                                  rng.normal(0, 40)]], np.float32)
                     for _ in range(3)])
    dev_a = torch.from_numpy(a23s).to(cuda)
    WK.warp_planes(planes, dev_a, 64, 96)           # builds the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = WK.warp_planes(planes, dev_a, 64, 96)
        table = WK.device_inverse_coeffs(dev_a)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref = np.asarray([WK.inverse_coeffs(a) for a in a23s], np.float32)
    np.testing.assert_array_equal(table.cpu().numpy(), ref)
    assert torch.equal(got, WK.warp_planes_plain(planes, table, 64, 96))


@pytest.mark.gpu
def test_tiled_compose_on_card_equals_whole_canvas(cuda, monkeypatch):
    """The strip compose on the card, tiled (threshold forced to 1) and
    whole-canvas, on planted transforms: within 1 level, the same crop,
    and the device handoff holds the tiled result."""
    from drone_image_stitch_cpp_tpu_torch.config.tuning import StitchTuning
    from drone_image_stitch_cpp_tpu_torch.ops import blend as B
    from drone_image_stitch_cpp_tpu_torch.pipeline.strip import compose_strip
    from drone_image_stitch_cpp_tpu_torch.runtime.handoff import DeviceStrip
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import (
        fractal_ortho, render_sortie)
    ortho = fractal_ortho(400, 900, seed=0)
    imgs, _, pos = render_sortie(ortho, 1, 4, 160, 224, 0.6)
    transforms = np.asarray([[[1, 0, x - pos[0][1]], [0, 1, y - pos[0][0]]]
                             for y, x in pos], np.float32)
    tt = StitchTuning(blend_bands=3, seam_estimation_resol_mpx=-1.0)
    whole = compose_strip(imgs, transforms, tt, device=cuda)
    monkeypatch.setattr(B, "TILED_THRESHOLD_BYTES", 1)
    monkeypatch.setattr(B, "TILE", 256)
    tiled = compose_strip(imgs, transforms, tt, device=cuda)
    ds = compose_strip(imgs, transforms, tt, device=cuda, return_device=True)
    assert isinstance(ds, DeviceStrip) and ds.dev.device.type == cuda.type
    assert whole.shape == tiled.shape
    diff = np.abs(whole.astype(np.int16) - tiled.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    np.testing.assert_array_equal(ds.host(), tiled)


@pytest.mark.gpu
def test_wrappers_reject_mixed_devices(cuda):
    kp = _keypoints("cpu", n=4)
    with pytest.raises(ValueError):
        SK.orientation_descriptor_flat(_stack(cuda), *kp)


def _small_sortie():
    from drone_image_stitch_cpp_tpu_torch.utils.synthetic import (
        fractal_ortho, render_sortie)
    ortho = fractal_ortho(400, 900, seed=0)
    return render_sortie(ortho, 1, 4, 160, 224, 0.6)


@pytest.mark.gpu
def test_register_pairs_over_device_list_bit_equal(cuda):
    """Chunks placed over [cuda:0, cuda:0] give the one-device results
    bit for bit (each chunk keeps the single-device shapes)."""
    from drone_image_stitch_cpp_tpu_torch.pipeline import pairgraph as P
    from drone_image_stitch_cpp_tpu_torch.pipeline.registration import (
        detect_features)
    imgs, _, _ = _small_sortie()
    feats, scale = detect_features(imgs, 256, -1.0, device=cuda)
    pairs = P.banded_pairs(4, 3)
    one = P.register_pairs(feats, pairs, 0.75, 4.0 / scale, chunk=2)
    two = P.register_pairs(feats, pairs, 0.75, 4.0 / scale, chunk=2,
                           devices=[cuda, cuda])
    assert int(one.ok.sum()) >= 3
    for a, b in zip(one, two):
        if isinstance(a, torch.Tensor):
            assert a.device == b.device and torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_tiled_compose_over_device_list_bit_equal(cuda, monkeypatch):
    """The host-assembled tiled strip compose with its tiles over
    [cuda:0, cuda:0] (two tiles in flight) equals the one-device run."""
    from drone_image_stitch_cpp_tpu_torch.config.tuning import StitchTuning
    from drone_image_stitch_cpp_tpu_torch.ops import blend as B
    from drone_image_stitch_cpp_tpu_torch.pipeline.strip import compose_strip
    imgs, _, pos = _small_sortie()
    transforms = np.asarray([[[1, 0, x - pos[0][1]], [0, 1, y - pos[0][0]]]
                             for y, x in pos], np.float32)
    tt = StitchTuning(blend_bands=3, seam_estimation_resol_mpx=-1.0)
    monkeypatch.setattr(B, "TILED_THRESHOLD_BYTES", 1)
    monkeypatch.setattr(B, "TILE", 256)
    n0 = WK.warp_frame.launches
    one = compose_strip(imgs, transforms, tt, device=cuda)
    n1 = WK.warp_frame.launches
    two = compose_strip(imgs, transforms, tt, device=[cuda, cuda])
    assert WK.warp_frame.launches - n1 == n1 - n0 > 0
    np.testing.assert_array_equal(one, two)


@pytest.mark.gpu
def test_kernels_launch_on_their_tensors_card(cuda):
    """K1 and K2 called on the last card while cuda:0 is the current
    device equal their plain versions there."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip(f"needs two or more CUDA cards ({count} visible): the "
                    f"launch on a card other than the current one")
    other = torch.device("cuda", count - 1)
    with torch.cuda.device(0):
        gauss = _stack(other)
        kp = _keypoints(other)
        ang_k, desc_k = SK.orientation_descriptor_flat(gauss, *kp)
        ang_p, desc_p = SK.orientation_descriptor_plain(gauss, *kp)
        torch.cuda.synchronize(other)
        assert ang_k.device == other
        _assert_k1_close(ang_k, desc_k, ang_p, desc_p)
        g = torch.Generator().manual_seed(2)
        img = torch.randint(0, 256, (300, 420, 3), generator=g,
                            dtype=torch.uint8).to(other)
        a23 = np.asarray([[0.97, -0.2, 14.5], [0.2, 0.97, -30.25]],
                         np.float32)
        wk, mk = WK.warp_frame(img, a23, 320, 512)
        wp, mp = WK.warp_frame_plain(img, WK.inverse_coeffs(a23), 320, 512)
        assert torch.equal(wk, wp) and torch.equal(mk, mp)
        frames = torch.stack([img, img.flip(0)])
        bk, bm = WK.warp_frames(frames, np.stack([a23, a23]), 64, 128)
        bp, bq = WK.warp_frames_plain(frames, [WK.inverse_coeffs(a23)] * 2,
                                      64, 128)
        assert torch.equal(bk, bp) and torch.equal(bm, bq)
        assert torch.cuda.current_device() == 0
