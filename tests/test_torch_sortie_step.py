"""The port's sortie step (``parallel/sortie_step.py``) against the JAX
package's ``build_sortie_step`` on ``demo_inputs`` (4 frames of 96x128,
64 keypoints, range width 2, 64 hypotheses, a 128x160 preview canvas:
tests/test_parallel.py's case), on the CPU.

* The demo frames are the same numpy draws: equal bit for bit.
* A mesh of 4 CPU devices against ``[cpu] * 4``, the port given the
  sample banks JAX's step draws from its per-shard keys: inlier counts
  equal; transforms within 1e-3 and the canvas within 0.5 levels, the
  bounds JAX holds its own 1- and 4-device steps to
  (tests/test_parallel.py:56-60). The detects differ by float rounding
  (the port's plain K1 against JAX's vmapped descriptor).
* The port over 1 device against 4 (its own banks): inlier counts
  equal, transforms within 1e-4 and the canvas within 1e-3 levels (only
  the psum's summation order differs).
"""

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, n

from drone_image_stitch_cpp_tpu.parallel.mesh import make_mesh as jmesh
from drone_image_stitch_cpp_tpu.parallel import sortie_step as JS
from drone_image_stitch_cpp_tpu_torch.parallel import sortie_step as TS

_N, _H, _W = 4, 96, 128
_KW = dict(max_kp=64, range_width=2, n_hyp=64, canvas_h=128, canvas_w=160)


def _jax_step_banks(keys, n_dev, range_width, n_hyp):
    """(N, range_width, n_hyp, 2): the banks JAX's step draws for pair
    (i, i + g): shard s = i // b_loc splits its first key into
    b_loc * range_width keys, one per (local frame, gap)."""
    b_loc = _N // n_dev
    out = np.zeros((_N, range_width, n_hyp, 2), np.int64)
    for s in range(n_dev):
        sk = jax.random.split(keys[s * b_loc], b_loc * range_width)
        for li in range(b_loc):
            for g in range(range_width):
                out[s * b_loc + li, g] = np.asarray(jax.random.randint(
                    sk[li * range_width + g], (n_hyp, 2), 0,
                    np.iinfo(np.int32).max))
    return torch.from_numpy(out)


@pytest.fixture(scope="module")
def jax_run():
    mesh = jmesh(4, platform="cpu")
    step = JS.build_sortie_step(mesh, _N, _H, _W, **_KW)
    frames, keys = JS.demo_inputs(mesh, _N, _H, _W)
    t, canvas, ninl = step(frames, keys)
    return (np.asarray(frames), np.asarray(keys), np.asarray(t),
            np.asarray(canvas), np.asarray(ninl))


def _port(n_dev, banks=None):
    devices = [CPU] * n_dev
    shards, seed = TS.demo_inputs(devices, _N, _H, _W)
    step = TS.build_sortie_step(devices, _N, _H, _W, **_KW)
    return shards, step(shards, seed, banks=banks)


def test_sortie_step_matches_jax(jax_run):
    frames, keys, tj, cj, nj = jax_run
    banks = _jax_step_banks(keys, 4, _KW["range_width"], _KW["n_hyp"])
    shards, (tt, ct, nt) = _port(4, banks)
    np.testing.assert_array_equal(n(torch.cat(shards)), frames)
    assert tt.shape == (_N, 2, 3) and ct.shape == (128, 160)
    np.testing.assert_array_equal(n(nt), nj)
    assert (nj[:_N - 1] > 10).all()
    np.testing.assert_allclose(n(tt), tj, atol=1e-3)
    np.testing.assert_allclose(n(ct), cj, atol=0.5)
    # the planted 8 px steps are recovered
    np.testing.assert_allclose(n(tt)[:, :, 2], [[8.0 * k] * 2
                                                for k in range(_N)],
                               atol=0.5)


def test_sortie_step_one_device_equals_four():
    _, (t1, c1, n1) = _port(1)
    _, (t4, c4, n4) = _port(4)
    torch.testing.assert_close(n1, n4, rtol=0, atol=0)
    torch.testing.assert_close(t1, t4, rtol=0, atol=1e-4)
    torch.testing.assert_close(c1, c4, rtol=0, atol=1e-3)
    with pytest.raises(ValueError):
        TS.build_sortie_step([CPU] * 3, _N, _H, _W, **_KW)
