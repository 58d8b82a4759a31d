"""The DP seam's path: ``csrc/dp_seam.cu`` against its plain version.

Imports torch and the port only (no JAX). The plain version is held to a
numpy statement of the recurrence on any machine; the tests marked
``gpu`` hold the kernel to the plain version bit for bit on a card:

    python -m pytest tests/test_torch_dp_seam.py -q -m gpu
"""

import os
import re

import numpy as np
import pytest
import torch

from drone_image_stitch_cpp_tpu_torch.ops import seam_kernel as DK
from drone_image_stitch_cpp_tpu_torch.runtime import kernels

SHAPES = [(1, 1), (1, 7), (9, 1), (2, 2), (37, 129), (253, 320),
          (64, 1500)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels run only there)")
    return torch.device("cuda", 0)


def _cost(shape, seed, ties):
    """A cost with many exact ties (small integers) or a continuous one
    with a band of 1e7 outside an overlap, as the seam's costs have."""
    rng = np.random.default_rng(seed)
    h, w = shape
    if ties:
        return torch.from_numpy(rng.integers(0, 3, (h, w)).astype(np.float32))
    c = (rng.random((h, w)) * 40.0).astype(np.float32)
    c[:, : w // 5] = 1e7
    return torch.from_numpy(c)


def _reference(cost: np.ndarray) -> np.ndarray:
    """The recurrence as the JAX package states it: each row adds the
    least of the three neighbours above (ties to the lower offset), the
    path ends at the last row's first minimum and walks the moves back."""
    h, w = cost.shape
    pad = np.float32(3e38)
    acc = cost[0].copy()
    moves = np.zeros((h, w), np.int64)
    for r in range(1, h):
        cand = np.stack([np.concatenate([[pad], acc[:-1]]), acc,
                         np.concatenate([acc[1:], [pad]])])
        k = np.argmin(cand, axis=0)
        moves[r] = k - 1
        acc = (cost[r] + cand[k, np.arange(w)]).astype(np.float32)
    xs = np.empty(h, np.int64)
    xs[-1] = int(np.argmin(acc))
    for r in range(h - 1, 0, -1):
        xs[r - 1] = min(max(xs[r] + moves[r, xs[r]], 0), w - 1)
    return xs


@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("shape", SHAPES[:5])
def test_plain_path_is_the_recurrence(shape, ties):
    cost = _cost(shape, 3, ties)
    xs = DK.seam_path(cost)
    assert xs.dtype == torch.int64 and xs.shape == (shape[0],)
    np.testing.assert_array_equal(xs.numpy(), _reference(cost.numpy()))


def test_path_rejects_what_the_kernel_does_not_take():
    for bad in (torch.zeros(3, 4, dtype=torch.float64), torch.zeros(4),
                torch.zeros(0, 5)):
        with pytest.raises(ValueError):
            DK.seam_path(bad)


def test_kernel_source_holds_its_entries():
    with open(os.path.join(kernels.CSRC_DIR, DK.KERNEL_SOURCE)) as f:
        src = f.read()
    for name in DK.KERNEL_SIGNATURES:
        assert re.search(rf'extern "C" \w[\w ]* {name}\(', src), name


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("shape", SHAPES + [(40, 7000)])
def test_dp_seam_kernel_bit_equal_to_plain(cuda, shape, ties):
    """Every shape the recurrence can meet: one row, one column, rows
    wider than the block (1500) and rows whose sums leave shared memory
    for the scratch (7000)."""
    cost = _cost(shape, 5, ties).to(cuda)
    n0 = DK.seam_path.launches
    xk = DK.seam_path(cost)
    assert DK.seam_path.launches == n0 + 1
    xp = DK.seam_path_plain(cost)
    torch.cuda.synchronize()
    assert xk.device == cost.device
    assert torch.equal(xk, xp)


@pytest.mark.gpu
def test_dp_seam_kernel_takes_a_transposed_cost(cuda):
    """The horizontal seam hands the scan a transposed view."""
    cost = _cost((320, 253), 7, False).to(cuda).t()
    xk = DK.seam_path(cost)
    xp = DK.seam_path_plain(cost.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(xk, xp)
