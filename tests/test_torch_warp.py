"""K2 (bilinear affine warp of a uint8 frame + its content mask): the
port's plain version against the JAX package's exact gather
``ops/warp.warp_affine`` on the CPU, for near-identity affines and for 15
degree rotations, at atol 1e-3 on the 0..255 scale (float32 coordinates
computed in the same order; the affine inverse may differ by an ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t

from drone_image_stitch_cpp_tpu.ops.warp import warp_affine as warp_jax
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


@pytest.mark.parametrize("a23", _AFFINES)
def test_k2_plain_matches_jax_gather(a23):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (97, 131, 3), dtype=np.uint8)
    oh, ow = 120, 150
    wimg, mask = WK.warp_frame(t(img), a23, oh, ow)
    ref = np.asarray(warp_jax(jnp.asarray(img.astype(np.float32)),
                              jnp.asarray(a23), oh, ow))
    ref_m = np.asarray(warp_jax(jnp.ones((97, 131), jnp.float32),
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
        WK.warp_frame(torch.zeros((8, 8, 3)), a, 8, 8)        # not uint8
    with pytest.raises(ValueError):
        WK.warp_frame(torch.zeros((8, 8), dtype=torch.uint8), a, 8, 8)
    with pytest.raises(ValueError):
        WK.warp_frame(torch.zeros((8, 8, 3), dtype=torch.uint8), a, 0, 8)
