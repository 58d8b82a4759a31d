"""The port's multi-device path over a device list, on the CPU (the JAX
package's tests/test_parallel.py:63-164 for the port): work placed on
``[cpu] * N`` runs the same arithmetic as on one device, so every result
must equal the one-device result bit for bit.

* ``make_mesh`` / ``resolve_devices``: too few devices raise;
* ``runtime/device.placement``: a call's device list has one home;
* ``register_pairs`` with its chunks over ``[cpu] * 4``: equal to one
  device, and within tests/test_torch_registration.py's tolerance
  (equal counts, flags and weights; models within 1e-3) of the JAX
  package's ``register_pairs(mesh=make_mesh(4, platform="cpu"))`` on the
  same features with the sample banks JAX draws under that mesh;
* ``mb_compose_tiled`` with its tiles over ``[cpu] * 4``: the mosaic,
  the content box and the row bands equal one device's;
* a two-line ``stitch_frames`` over ``[cpu] * 2`` (strips tiled and
  handed over as ``DeviceStrip``s, the global blend tiled): mosaic,
  strip and global transforms equal one device's.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, jax_banks, n, small_tunings, t

from drone_image_stitch_cpp_tpu.parallel.mesh import make_mesh as jmesh
from drone_image_stitch_cpp_tpu.pipeline import pairgraph as JP
from drone_image_stitch_cpp_tpu.pipeline.registration import (
    detect_features as jdetect)
from drone_image_stitch_cpp_tpu.utils.synthetic import render_sortie
from drone_image_stitch_cpp_tpu_torch.app import stitch_frames
from drone_image_stitch_cpp_tpu_torch.ops import blend as TB
from drone_image_stitch_cpp_tpu_torch.ops.features import Features
from drone_image_stitch_cpp_tpu_torch.parallel.mesh import (
    all_gather, make_mesh, psum)
from drone_image_stitch_cpp_tpu_torch.pipeline import pairgraph as TP
from drone_image_stitch_cpp_tpu_torch.runtime.device import (
    DeviceUnavailableError, placement, resolve_devices)
from drone_image_stitch_cpp_tpu_torch.runtime.feed import FrameStore


def test_make_mesh_raises_on_insufficient_devices():
    assert make_mesh(1, platform="cpu") == [CPU]
    assert make_mesh(platform="cpu") == [CPU]
    with pytest.raises(TypeError):      # the platform is always named
        make_mesh(1)
    with pytest.raises(DeviceUnavailableError):
        make_mesh(2, platform="cpu")
    assert resolve_devices("cpu") == [CPU]
    assert resolve_devices(["cpu", CPU]) == [CPU, CPU]
    with pytest.raises(DeviceUnavailableError):
        resolve_devices([])
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            make_mesh(1, platform="cuda")
        for spec in ("cuda", "cuda:0", ["cpu", "cuda:0"]):
            with pytest.raises(DeviceUnavailableError):
                resolve_devices(spec)


def test_placement_has_one_home():
    """A library call's ``device`` is one device or a list whose first
    entry holds the frames: a store elsewhere, or no device at all, is an
    error, never a silent choice."""
    meta = torch.device("meta")
    assert placement(CPU) == [CPU]
    assert placement(None, CPU) == [CPU]
    assert placement([CPU, "cpu"], CPU) == [CPU, CPU]
    for device, home in ((None, None), ([], None), (meta, CPU),
                         ([meta, CPU], CPU)):
        with pytest.raises(ValueError):
            placement(device, home)
    feats = Features(torch.zeros((2, 4, 2)), None, None, None,
                     torch.zeros((2, 4, 128)), torch.ones((2, 4), dtype=bool))
    with pytest.raises(ValueError):
        TP.register_pairs(feats, [(0, 1)], 0.75, 4.0, devices=[meta, CPU])


def test_collectives_order_and_store_subset():
    shards = [torch.full((2, 3), float(k)) for k in range(3)]
    got = all_gather(shards, [CPU] * 3)
    assert len(got) == 3
    for g in got:
        torch.testing.assert_close(g, torch.cat(shards), rtol=0, atol=0)
    for g in psum(shards, [CPU] * 3):
        torch.testing.assert_close(g, torch.full((2, 3), 3.0), rtol=0,
                                   atol=0)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (8, 12, 3), dtype=np.uint8)
              for _ in range(10)]
    store = FrameStore(frames, CPU)
    sub = store.subset([9, 2, 3], CPU)
    assert len(sub) == 3 and sub.shape0 == (8, 12, 3)
    assert torch.equal(sub.batch([0, 1, 2]), store.batch([9, 2, 3]))
    assert sub.host_frame(0) is frames[9]


@pytest.fixture(scope="module")
def jax_feats(ortho):
    frames, _, _ = render_sortie(ortho, 1, 4, 256, 256, 0.6)
    return jdetect(frames, 256, -1.0)


def test_register_pairs_over_devices(jax_feats):
    fj, scale = jax_feats
    pairs = JP.banded_pairs(4, 3)
    n_hyp, chunk = 1024, 2
    ft = Features(*(t(np.asarray(a)) for a in fj))
    # the banks of JAX's chunk x mesh-size step
    banks = t(jax_banks(0, len(pairs), n_hyp, chunk=chunk * 4))
    one = TP.register_pairs(ft, pairs, 0.75, 4.0 / scale, n_hyp=n_hyp,
                            chunk=chunk, banks=banks)
    four = TP.register_pairs(ft, pairs, 0.75, 4.0 / scale, n_hyp=n_hyp,
                             chunk=chunk, banks=banks, devices=[CPU] * 4)
    for a, b in zip(one, four):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)
    gj = JP.register_pairs(fj, pairs, 0.75, thresh=4.0 / scale,
                           kind="similarity", n_hyp=n_hyp, chunk=chunk,
                           seed=0, mesh=jmesh(4, platform="cpu"))
    np.testing.assert_array_equal(four.pairs, np.asarray(gj.pairs))
    for f in ("n_good", "n_inliers", "ok", "w"):
        np.testing.assert_array_equal(n(getattr(four, f)),
                                      np.asarray(getattr(gj, f)), err_msg=f)
    assert n(four.ok).sum() >= 3
    np.testing.assert_allclose(n(four.model), np.asarray(gj.model),
                               atol=1e-3)


def _tile_feed(frames, boxes):
    def feed(cv, i, ey0, ex0, eh, ew):
        x0, y0 = int(boxes[i][0]) - ex0, int(boxes[i][1]) - ey0
        fh, fw = frames[i].shape[:2]
        img = torch.zeros((eh, ew, 3), device=cv.wacc[0].device)
        m = torch.zeros((eh, ew), device=cv.wacc[0].device)
        ys = slice(max(0, y0), min(eh, y0 + fh))
        xs = slice(max(0, x0), min(ew, x0 + fw))
        if ys.start < ys.stop and xs.start < xs.stop:
            img[ys, xs] = torch.from_numpy(frames[i][
                ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0]
            ).float()
            m[ys, xs] = 1.0
        return TB.mb_feed(cv, img, m, 0, 0, m > 0)
    return feed


def test_mb_compose_tiled_over_devices():
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (40, 70, 3), dtype=np.uint8)
              for _ in range(4)]
    boxes = [(13.0, 9.0, 82.0, 48.0), (70.0, 30.0, 139.0, 69.0),
             (150.0, 5.0, 219.0, 44.0), (60.0, 100.0, 129.0, 139.0)]
    feed = _tile_feed(frames, boxes)
    outs = []
    for devices in (CPU, [CPU] * 4):
        rows = []
        mosaic, box = TB.mb_compose_tiled(
            160, 240, 3, boxes, feed, devices, tile=64,
            on_rows=lambda y0, y1, r: rows.append((y0, y1, r.copy())))
        outs.append((mosaic, box, rows))
    (m1, b1, r1), (m4, b4, r4) = outs
    assert len(TB.mb_tile_grid(160, 240, TB.tiled_bands(160, 240, 3, 64),
                               64)[0]) > 4
    np.testing.assert_array_equal(m1, m4)
    assert b1 == b4 and (m1 > 0).mean() > 0.2
    assert [r[:2] for r in r1] == [r[:2] for r in r4]
    assert [r[0] for r in r4] == sorted(r[0] for r in r4)
    for a, b in zip(r1, r4):
        np.testing.assert_array_equal(a[2], b[2])
    with pytest.raises(ValueError):
        TB.mb_compose_tiled(160, 240, 3, boxes, feed, [CPU] * 2, tile=64,
                            assemble="device")


def test_two_line_stitch_over_devices_equals_one_device(ortho, monkeypatch):
    imgs, ids, _ = render_sortie(ortho, 2, 3, frame_h=160, frame_w=208,
                                 overlap=0.7, overlap_y=0.3)
    _, tt = small_tunings()
    monkeypatch.setattr(TB, "TILED_THRESHOLD_BYTES", 1)
    one = stitch_frames(imgs, ids, tt, "cpu")
    two = stitch_frames(imgs, ids, tt, ["cpu", "cpu"])
    assert [g.indices for g in one.groups] == [[0, 1, 2], [3, 4, 5]]
    assert [g.indices for g in two.groups] == [g.indices for g in
                                               one.groups]
    np.testing.assert_array_equal(one.panorama, two.panorama)
    for a, b in zip(one.strip_transforms + one.global_transforms,
                    two.strip_transforms + two.global_transforms):
        np.testing.assert_array_equal(a, b)
    assert one.flipped == two.flipped
    assert one.seam_methods == two.seam_methods
