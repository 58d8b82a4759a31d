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
            WK.warp_frames.launches)


def test_cpu_calls_are_not_counted_as_launches():
    before = _launch_counts()
    SK.orientation_descriptor_flat(_stack("cpu"), *_keypoints("cpu", n=8))
    a23 = np.asarray([[1, 0, 1.5], [0, 1, 0]], np.float32)
    WK.warp_frame(torch.zeros((16, 16, 3), dtype=torch.uint8), a23, 16, 16)
    WK.warp_frames(torch.zeros((2, 16, 16, 3), dtype=torch.uint8),
                   np.stack([a23, a23]), 16, 16)
    assert _launch_counts() == before


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


@pytest.mark.gpu
def test_wrappers_reject_mixed_devices(cuda):
    kp = _keypoints("cpu", n=4)
    with pytest.raises(ValueError):
        SK.orientation_descriptor_flat(_stack(cuda), *kp)
