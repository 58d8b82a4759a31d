"""Registration front end and pair graph: the port vs the JAX package on
the CPU.

* ``detect_features`` on 256x256 frames at full resolution, where the
  JAX package's 256-px shape bucket adds no padding (the port does not
  bucket), so both detect the very same images: equal validity masks,
  coordinates within 1e-3 px.
* ``register_pairs`` on the SAME features with the SAME RANSAC sample
  banks (drawn with JAX's per-pair keys and injected into the port):
  equal match/inlier counts, success flags and inlier weights, models
  within 1e-3 (pixel-unit translations, float32).
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, jax_banks, n, t

from drone_image_stitch_cpp_tpu.pipeline import pairgraph as JP
from drone_image_stitch_cpp_tpu.pipeline.registration import (
    detect_features as jdetect)
from drone_image_stitch_cpp_tpu.utils.synthetic import render_sortie
from drone_image_stitch_cpp_tpu_torch.ops.features import Features
from drone_image_stitch_cpp_tpu_torch.pipeline import pairgraph as TP
from drone_image_stitch_cpp_tpu_torch.pipeline.registration import (
    detect_features as tdetect)
from drone_image_stitch_cpp_tpu_torch.runtime.feed import FrameStore

_N_FEAT = 256


@pytest.fixture(scope="module")
def frames(ortho):
    imgs, _, _ = render_sortie(ortho, 1, 4, 256, 256, 0.6)
    return imgs


@pytest.fixture(scope="module")
def jax_feats(frames):
    return jdetect(frames, _N_FEAT, -1.0)


def test_detect_features_matches_jax(frames, jax_feats):
    fj, sj = jax_feats
    ft, st = tdetect(frames, _N_FEAT, -1.0, device=CPU)
    assert st == sj == 1.0
    vj = np.asarray(fj.valid)
    np.testing.assert_array_equal(n(ft.valid), vj)
    assert vj.sum(axis=1).min() > 50
    np.testing.assert_allclose(n(ft.xy)[vj], np.asarray(fj.xy)[vj],
                               atol=1e-3)
    np.testing.assert_allclose(n(ft.sigma)[vj], np.asarray(fj.sigma)[vj],
                               atol=1e-3)


def test_store_path_equals_list_path(frames):
    """FrameStore-served detect == list-served detect, subsets included."""
    store = FrameStore(frames, CPU)
    sub = [1, 3]
    f_list, s_list = tdetect([frames[i] for i in sub], _N_FEAT, 0.04,
                             device=CPU)
    f_store, s_store = tdetect(None, _N_FEAT, 0.04, store=store,
                               indices=sub)
    assert s_list == s_store
    for a, b in zip(f_list, f_store):
        assert torch.equal(a, b)


def test_register_pairs_same_banks_match_jax(jax_feats):
    fj, scale = jax_feats
    pairs = JP.banded_pairs(4, 3)
    n_hyp = 1024
    gj = JP.register_pairs(fj, pairs, 0.75, thresh=4.0 / scale,
                           kind="similarity", n_hyp=n_hyp, seed=0)
    ft = Features(*(t(np.asarray(a)) for a in fj))
    gt = TP.register_pairs(ft, pairs, 0.75, 4.0 / scale, n_hyp=n_hyp,
                           banks=t(jax_banks(0, len(pairs), n_hyp)))
    np.testing.assert_array_equal(gt.pairs, np.asarray(gj.pairs))
    np.testing.assert_array_equal(n(gt.n_good), np.asarray(gj.n_good))
    np.testing.assert_array_equal(n(gt.n_inliers), np.asarray(gj.n_inliers))
    np.testing.assert_array_equal(n(gt.ok), np.asarray(gj.ok))
    np.testing.assert_array_equal(n(gt.w), np.asarray(gj.w))
    assert n(gt.ok).sum() >= 3
    np.testing.assert_allclose(n(gt.model), np.asarray(gj.model), atol=1e-3)
    np.testing.assert_allclose(n(gt.conf), np.asarray(gj.conf), atol=1e-6)


def test_pair_schedules_and_graph_helpers():
    assert TP.banded_pairs(6, 2) == JP.banded_pairs(6, 2)
    assert TP.gap_pairs(7, 3) == JP.gap_pairs(7, 3)
    assert TP.all_pairs(4) == JP.all_pairs(4)
    pairs = np.asarray([(0, 1), (1, 2), (3, 4), (0, 2)])
    keep = np.asarray([True, True, True, False])
    assert TP.biggest_component(5, pairs, keep) == \
        JP.biggest_component(5, pairs, keep)
    models = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    models[:, 0, 2] = [-100.0, -98.0, -50.0, -199.0]
    conf = np.asarray([2.0, 1.5, 1.0, 3.0], np.float32)
    np.testing.assert_allclose(
        TP.chain_init(5, pairs, models, keep, conf),
        JP.chain_init(5, pairs, models, keep, conf))
