"""K1 (SIFT orientation + descriptor) and the batched detector: the port's
plain version vs the JAX package on the CPU.

The JAX references run as tests/test_pallas_sift.py runs them: the
vmapped per-keypoint path (``_orientation_one``/``_descriptor_one``) and
the Pallas kernel in interpret mode, on the same inputs and with the same
tolerances. The port implements the Pallas kernel's full-support
semantics with an exact atan2 (the Pallas kernel's polynomial atan2 errs
by < 1.2e-4 rad), so it should agree with both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import ang_diff, n, t

from drone_image_stitch_cpp_tpu.ops import features as JF
from drone_image_stitch_cpp_tpu.ops import pallas_sift as PS
from drone_image_stitch_cpp_tpu.ops.color import bgr_to_gray
from drone_image_stitch_cpp_tpu_torch.ops import features as TF
from drone_image_stitch_cpp_tpu_torch.ops import sift_kernel as SK

from test_pallas_sift import _ref_ori_desc, _test_stack

# interior keypoints at several scales + border keypoints on every side
# (tests/test_pallas_sift.py)
_PTS = [(60.0, 190.0, 1.6), (55.3, 122.7, 2.1), (70.9, 301.2, 3.2),
        (64.0, 64.0, 1.8), (90.0, 250.0, 2.6),
        (6.0, 200.0, 1.6), (121.0, 150.0, 1.6),
        (60.0, 5.5, 1.6), (66.0, 377.0, 1.6)]


def _plain_on_stack(gauss):
    """K1's plain version on keypoints of layer 2 of one octave stack."""
    h, w = gauss.shape[1], gauss.shape[2]
    k = len(_PTS)
    col = lambda i: t(np.asarray([p[i] for p in _PTS], np.float32))
    return SK.orientation_descriptor_flat(
        t(np.asarray(gauss)), torch.full((k,), 2, dtype=torch.int32),
        col(0), col(1), col(2), torch.full((k,), float(h)),
        torch.full((k,), float(w)))


@pytest.fixture(scope="module")
def stack():
    return _test_stack()


def test_k1_plain_matches_vmapped_reference(stack):
    ang_t, desc_t = _plain_on_stack(stack)
    yf, xf, sig = (jnp.asarray([p[i] for p in _PTS], jnp.float32)
                   for i in range(3))
    li = jnp.full((len(_PTS),), 2, jnp.int32)
    ang_r, desc_r = _ref_ori_desc(stack, li, yf, xf, sig)
    dang = ang_diff(n(ang_t), ang_r)
    l2 = np.linalg.norm(n(desc_t) - desc_r, axis=-1)
    # the 128x384 octave is larger than the 81-px support: same semantics,
    # float summation order only (test_pallas_sift allows one border flip)
    close = (dang < 0.02) & (l2 < 20.0)
    assert close.sum() >= len(_PTS) - 1, (dang.tolist(), l2.tolist())
    assert close[:5].all(), (dang[:5].tolist(), l2[:5].tolist())
    assert np.median(l2) < 1.0, l2


def test_k1_plain_matches_pallas_interpret(stack):
    ang_t, desc_t = _plain_on_stack(stack)
    yf, xf, sig = (jnp.asarray([p[i] for p in _PTS], jnp.float32)
                   for i in range(3))
    li = jnp.full((len(_PTS),), 2, jnp.int32)
    ang_k, desc_k = PS.orientation_descriptor(stack, li, yf, xf, sig,
                                              interpret=True)
    assert np.isfinite(n(desc_t)).all() and np.isfinite(n(ang_t)).all()
    dang = ang_diff(n(ang_t), np.asarray(ang_k))
    l2 = np.linalg.norm(n(desc_t) - np.asarray(desc_k), axis=-1)
    close = (dang < 0.02) & (l2 < 20.0)
    assert close.sum() >= len(_PTS) - 1, (dang.tolist(), l2.tolist())
    assert close[:5].all(), (dang[:5].tolist(), l2[:5].tolist())


def test_batched_detect_matches_jax(ortho):
    """The port's detector (selection + one K1 call) against JAX's
    vmapped detect on the frame of test_pallas_sift: the same keypoints,
    orientations everywhere within 0.02 rad, and small-sigma descriptors
    within the vmapped path's truncation tolerance."""
    gray = np.asarray(bgr_to_gray(jnp.asarray(ortho[:128, :256])))
    k = 96
    f_ref = JF.detect_and_describe_batched(jnp.asarray(gray[None]), k,
                                           use_pallas=False)
    f_t = TF.detect_and_describe_batched(t(gray[None]), k)
    v_ref = np.asarray(f_ref.valid[0])
    np.testing.assert_array_equal(n(f_t.valid[0]), v_ref)
    np.testing.assert_allclose(n(f_t.xy[0])[v_ref],
                               np.asarray(f_ref.xy[0])[v_ref], atol=1e-3)
    np.testing.assert_allclose(n(f_t.sigma[0])[v_ref],
                               np.asarray(f_ref.sigma[0])[v_ref], atol=1e-3)
    dang = ang_diff(n(f_t.angle[0])[v_ref],
                    np.asarray(f_ref.angle[0])[v_ref])
    assert (dang < 0.02).all(), np.sort(dang)[-5:]
    l2 = np.linalg.norm(n(f_t.desc[0])[v_ref]
                        - np.asarray(f_ref.desc[0])[v_ref], axis=-1)
    small = np.asarray(f_ref.sigma[0])[v_ref] < 6.0
    assert small.sum() > 30, small.sum()
    assert (l2[small] < 25.0).all(), np.sort(l2[small])[-5:]
    assert np.median(l2[small]) < 5.0, np.median(l2[small])


def test_k1_wrapper_rejects_bad_inputs():
    g = torch.zeros((2, 100, 100))
    one = torch.zeros((3,))
    with pytest.raises(ValueError):
        SK.orientation_descriptor_flat(g.double(), one.int(), one, one, one,
                                       one, one)
    with pytest.raises(ValueError):
        SK.orientation_descriptor_flat(g, one.int(), one[:2], one, one, one,
                                       one)


def test_k1_launch_plan_round_trips_and_covers_support():
    """The K1 wrapper's per-keypoint window radius: ``support_radius`` of a
    tensor of scales (int32 on the tensor's device, what the kernel reads)
    equals ``support_radius`` of each scale as a float, and covers the whole
    descriptor and orientation support for every scale up to the largest
    detected one (sigma < 1.6 * 2^(3.5/3) = 3.59)."""
    rng = np.random.default_rng(5)
    sig_max = 1.6 * 2.0 ** (3.5 / 3)
    sig = np.concatenate([rng.uniform(1.6, sig_max, 400),
                          np.linspace(0.4, sig_max, 4001),
                          [1.6, 1.6, sig_max]]).astype(np.float32)
    radius = SK.support_radius(t(sig))
    assert radius.dtype == torch.int32 and radius.shape == sig.shape
    r = n(radius)
    np.testing.assert_array_equal(
        r, [SK.support_radius(float(s)) for s in sig])
    s64 = sig.astype(np.float64)
    # descriptor support (2.5 * sqrt(2) * 3 sigma) + 0.5 px centre offset
    # + the central-difference ring, and the round(4.5 sigma) orientation
    # box, fit the window of half-size r
    assert (2.5 * np.sqrt(2) * 3 * s64 + 0.5 + 1 <= r).all()
    assert (np.round(4.5 * s64) <= r - 1).all()
    assert r.max() <= SK.SUPPORT_R
