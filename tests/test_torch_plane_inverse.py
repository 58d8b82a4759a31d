"""K2's single-plane kernel inverts each frame's affine itself, from
``csrc/affine_inverse.cuh``; that header also builds for the host, with
g++ and ``-ffp-contract=off`` (``utils/native.affine_inverse_host``, from
``csrc/affine_inverse_host.cpp`` into ``build/native/``). On the CPU this
file holds the host build bit-equal to ``inverse_coeffs``,
``device_inverse_coeffs`` and the JAX package's ``invert_affine`` on the
200 affines of ``test_torch_throughput``, 10^4 more (row pivots, scales
0.05-3, translations up to 3e9) and singular ones (not finite);
``tests/test_torch_cuda.py`` holds the card's build, and the kernel
library's host entry that the other K2 launches invert with, to the same
bits.
The constants the wrappers share with the CUDA source are checked against
it here.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t

from drone_image_stitch_cpp_tpu.ops.transform import invert_affine as jinv
from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
from drone_image_stitch_cpp_tpu_torch.runtime.kernels import CSRC_DIR
from drone_image_stitch_cpp_tpu_torch.utils import native
from drone_image_stitch_cpp_tpu_torch.utils.plane_affines import (
    bench_affines, singular_affines, wide_affines)


def _host(a23s: np.ndarray) -> np.ndarray:
    fn = native.affine_inverse_host()
    if fn is None:
        pytest.fail(f"the host build failed: {native._AFFINE['error']}")
    a = np.ascontiguousarray(a23s, np.float32).reshape(-1, 6)
    out = np.full(a.shape, np.nan, np.float32)
    fn(a, out, a.shape[0])
    return out


@pytest.mark.parametrize("draw", [bench_affines, wide_affines])
def test_host_inverse_bit_equal_to_plain_and_jax(draw):
    a23s = draw()
    got = _host(a23s)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, np.asarray(
        [WK.inverse_coeffs(a) for a in a23s], np.float32))
    np.testing.assert_array_equal(got, n(WK.device_inverse_coeffs(t(a23s))))
    ref = np.asarray(jax.jit(jax.vmap(jinv))(jnp.asarray(a23s)))
    np.testing.assert_array_equal(got, ref.reshape(-1, 6))


def test_wide_affines_pivot_on_both_rows():
    a = wide_affines()
    swap = np.abs(a[:, 1, 0]) > np.abs(a[:, 0, 0])
    assert 0.3 < swap.mean() < 0.7
    assert np.abs(a[:, :, 2]).max() > 1e9


def test_host_inverse_of_singular_affines_is_not_finite():
    a23s = singular_affines()
    got = _host(a23s)
    assert not np.isfinite(got).all(axis=1).any()
    # the same non-finite values (NaN where NaN) as the tensor version
    np.testing.assert_array_equal(got, n(WK.device_inverse_coeffs(t(a23s))))
    for a in a23s:
        with pytest.raises(ValueError, match="singular"):
            WK.inverse_coeffs(a)


_REGULAR = np.asarray([[0.9, 0.05, -2.3], [-0.04, 1.1, 1.7]], np.float32)
_CONTRACT = [(a, True) for a in singular_affines()] + [
    ([[1, 3e38, 0], [1, -3e38, 0]], True),      # u overflows to -inf
    ([[1, 0, 0], [0, np.nan, 0]], True),        # u is NaN
    ([[1e-30, 0, 3e38], [0, 1e-30, -3e38]], False)]   # i02, i12 overflow


@pytest.mark.parametrize("a23,singular", _CONTRACT,
                         ids=["dependent rows", "zero pivot", "u infinite",
                              "u NaN", "translation overflows"])
def test_singular_contract_on_the_cpu(a23, singular):
    """inverse_coeffs, the CPU warp_frame / warp_frames and warp_planes of
    a host array raise on exactly the singular affines (a zero pivot, or a
    second pivot u that is zero or not finite), before any warp; an affine
    whose inverse merely overflows warps with coefficients that are not
    finite."""
    a23 = np.asarray(a23, np.float32)
    pair = np.stack([_REGULAR, a23])
    calls = [lambda: WK.inverse_coeffs(a23),
             lambda: WK.warp_planes(torch.ones((2, 6, 8)), pair, 4, 5)]
    for frame in (torch.full((6, 8, 3), 7, dtype=torch.uint8),
                  torch.full((6, 8, 3), 7.5)):
        calls += [lambda f=frame: WK.warp_frame(f, a23, 4, 5),
                  lambda f=frame: WK.warp_frames(torch.stack([f, f]), pair,
                                                 4, 5)]
    for call in calls:
        if singular:
            with pytest.raises(ValueError, match="singular"):
                call()
        else:
            call()
    if not singular:
        assert not np.isfinite(WK.inverse_coeffs(a23)).all()


def test_kernel_inverse_on_cpu_is_its_plain_version():
    a23s = bench_affines()[:17]
    assert torch.equal(WK.kernel_inverse_coeffs(t(a23s)),
                       WK.device_inverse_coeffs(t(a23s)))


def test_host_build_is_keyed_by_the_header(tmp_path, monkeypatch):
    """An edited header builds a new library (the key holds the header's
    bytes), and the edit is what runs."""
    for f in ("affine_inverse.cuh", "affine_inverse_host.cpp"):
        with open(os.path.join(CSRC_DIR, f)) as src:
            text = src.read()
        if f.endswith(".cuh"):      # a header whose inverse negates i00
            text = text.replace("out[0] = x1[0];", "out[0] = -x1[0];")
        (tmp_path / f).write_text(text)
    old = native.affine_inverse_host()
    assert old is not None
    monkeypatch.setattr(native, "_CSRC", str(tmp_path))
    monkeypatch.setattr(native, "_AFFINE", {})
    fn = native.affine_inverse_host()
    a = bench_affines()[:3].reshape(-1, 6).copy()
    got = np.zeros_like(a)
    fn(a, got, 3)
    want = np.asarray([WK.inverse_coeffs(x) for x in a], np.float32)
    np.testing.assert_array_equal(got[:, 0], -want[:, 0])
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])


def _constant(name: str) -> int:
    with open(os.path.join(CSRC_DIR, WK.KERNEL_SOURCE)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


def test_wrapper_constants_match_the_kernel_source():
    assert WK.BY_VALUE_MAX == _constant("kByValue")
    assert WK.PLANE_TILE == (_constant("kPlaneTileH"), 32 * _constant("kPix"))
    assert WK.I420_TILE[0] == _constant("kTileH")
    # kByValue sets of six floats stay inside 4 KB of kernel parameters
    # beside the ~100 bytes of the other arguments
    assert WK.BY_VALUE_MAX * 24 + 128 <= 4096
