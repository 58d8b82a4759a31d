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


def test_cpu_calls_are_not_counted_as_launches():
    before = (SK.orientation_descriptor_flat.launches,
              WK.warp_frame.launches)
    SK.orientation_descriptor_flat(_stack("cpu"), *_keypoints("cpu", n=8))
    WK.warp_frame(torch.zeros((16, 16, 3), dtype=torch.uint8),
                  np.asarray([[1, 0, 1.5], [0, 1, 0]], np.float32), 16, 16)
    assert (SK.orientation_descriptor_flat.launches,
            WK.warp_frame.launches) == before


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
    dang = (torch.remainder(ang_k - ang_p + math.pi, 2 * math.pi)
            - math.pi).abs()
    l2 = torch.linalg.norm(desc_k - desc_p, dim=-1)
    same = dang < 0.02
    # atomics sum in another order: near-tied histogram peaks may flip
    assert same.float().mean() >= 0.99
    assert float(l2[same].max()) < 2.0


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
def test_wrappers_reject_mixed_devices(cuda):
    kp = _keypoints("cpu", n=4)
    with pytest.raises(ValueError):
        SK.orientation_descriptor_flat(_stack(cuda), *kp)
