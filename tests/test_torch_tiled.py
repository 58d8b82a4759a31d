"""The tiled compose and the device strip handoff: the port vs the JAX
package on the CPU, and the port's import rule.

  * the tile geometry (``mb_tile_grid``, ``tiled_bands``,
    ``num_blend_bands``) equals JAX's for a grid of canvas sizes and band
    counts: it decides the mosaic, so it must match exactly;
  * the port's tiled strip compose equals its whole-canvas compose within
    1 level (``TILED_THRESHOLD_BYTES`` forced to 1, as test_pipeline.py's
    tiled-vs-untiled test does in JAX), and JAX's tiled compose on the
    same transforms within 1 level (float32 sums in another order can
    move a value across a truncation boundary);
  * the device content-flag box equals ``auto_crop_black_border``'s box,
    and the device assembly holds the host assembly's pixels;
  * ``DeviceStrip`` round-trips losslessly and re-pads like numpy;
  * no module of the port, ``chip_smoke.py`` or ``tests/test_torch_cuda.py``
    imports jax or the JAX package.
"""

import ast
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, small_tunings

from drone_image_stitch_cpp_tpu.ops import blend as JB
from drone_image_stitch_cpp_tpu.ops.crop import (
    auto_crop_black_border as jcrop)
from drone_image_stitch_cpp_tpu.pipeline.strip import (
    compose_strip as jcompose, estimate_strip_transforms as jestimate)
from drone_image_stitch_cpp_tpu.utils.synthetic import render_sortie
from drone_image_stitch_cpp_tpu_torch.ops import blend as TB
from drone_image_stitch_cpp_tpu_torch.ops.crop import auto_crop_black_border
from drone_image_stitch_cpp_tpu_torch.pipeline.strip import (
    compose_strip as tcompose)
from drone_image_stitch_cpp_tpu_torch.runtime.handoff import DeviceStrip

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("bands", [3, 5, 8, 12])
def test_tile_geometry_matches_jax(bands):
    for h, w in [(160, 600), (2176, 14208), (2161, 16512), (4968, 14208),
                 (5000, 5000), (9000, 30001), (513, 4097)]:
        for tile in (None, 256):
            assert TB.tiled_bands(h, w, bands, tile) == JB.tiled_bands(
                h, w, bands, tile)
            tb = TB.tiled_bands(h, w, bands, tile)
            assert TB.mb_tile_grid(h, w, tb, tile) == JB.mb_tile_grid(
                h, w, tb, tile)
        assert TB.num_blend_bands(bands, h, w) == JB.num_blend_bands(
            bands, h, w)
    for name in ("TILED_THRESHOLD_BYTES", "TILE", "MAX_TILED_BANDS",
                 "TILE_PYR_BUDGET_BYTES", "EXT_SNAP"):
        assert getattr(TB, name) == getattr(JB, name), name


@pytest.fixture(scope="module")
def strip(ortho):
    """test_pipeline.py's tiled-compose strip with JAX's transforms."""
    imgs, _, _ = render_sortie(ortho, 1, 4, frame_h=160, frame_w=224,
                               overlap=0.6)
    jt, tt = small_tunings()
    kept, transforms, _ = jestimate(imgs, jt)
    return [imgs[i] for i in kept], np.asarray(transforms), jt, tt


@pytest.fixture(scope="module")
def tiled_pair(strip):
    """(port whole canvas, port tiled, JAX tiled) on the same transforms;
    TILED_THRESHOLD_BYTES is forced to 1 in both packages around the
    tiled calls."""
    imgs, transforms, jt, tt = strip
    whole = tcompose(imgs, transforms, tt, device=CPU)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TB, "TILED_THRESHOLD_BYTES", 1)
        mp.setattr(JB, "TILED_THRESHOLD_BYTES", 1)
        tiled = tcompose(imgs, transforms, tt, device=CPU)
        jtiled = jcrop(jcompose(imgs, transforms, jt))
    return whole, tiled, jtiled


def test_tiled_compose_equals_whole_canvas(tiled_pair):
    whole, tiled, _ = tiled_pair
    assert whole.shape == tiled.shape
    diff = np.abs(whole.astype(np.int16) - tiled.astype(np.int16))
    assert diff.max() <= 1, diff.max()


def test_tiled_compose_matches_jax(tiled_pair):
    _, tiled, jtiled = tiled_pair
    assert tiled.shape == jtiled.shape
    diff = np.abs(tiled.astype(np.int16) - jtiled.astype(np.int16))
    assert diff.max() <= 1, diff.max()


def test_device_assembly_and_flag_box(strip, monkeypatch):
    """The device content-flag box of a tiled compose equals the host
    autocrop's box, and the device canvas holds the host mosaic."""
    imgs, transforms, _, tt = strip
    monkeypatch.setattr(TB, "TILED_THRESHOLD_BYTES", 1)
    ds = tcompose(imgs, transforms, tt, device=CPU, return_device=True)
    assert isinstance(ds, DeviceStrip)
    # small tiles: several cores, so the box is assembled across tiles
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (40, 70, 3), dtype=np.uint8)
              for _ in range(3)]
    boxes = [(13.0, 9.0, 82.0, 48.0), (70.0, 30.0, 139.0, 69.0),
             (150.0, 5.0, 219.0, 44.0)]

    def feed(cv, i, ey0, ex0, eh, ew):
        x0, y0 = int(boxes[i][0]) - ex0, int(boxes[i][1]) - ey0
        img = torch.zeros((eh, ew, 3))
        m = torch.zeros((eh, ew))
        ys, xs = slice(max(0, y0), min(eh, y0 + 40)), slice(
            max(0, x0), min(ew, x0 + 70))
        if ys.start < ys.stop and xs.start < xs.stop:
            img[ys, xs] = torch.from_numpy(frames[i][
                ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0]
            ).float()
            m[ys, xs] = 1.0
        return TB.mb_feed(cv, img, m, 0, 0, m > 0)

    host, box = TB.mb_compose_tiled(80, 240, 3, boxes, feed, CPU, tile=64)
    dev, dbox = TB.mb_compose_tiled(80, 240, 3, boxes, feed, CPU, tile=64,
                                    assemble="device")
    assert len(TB.mb_tile_grid(80, 240, TB.tiled_bands(80, 240, 3, 64),
                               64)[0]) > 2
    assert box == dbox
    y0, y1, x0, x1 = box
    np.testing.assert_array_equal(host[y0:y1, x0:x1],
                                  auto_crop_black_border(host))
    np.testing.assert_array_equal(dev[:80, :240].numpy(), host)
    assert not dev[80:].any() and not dev[:, 240:].any()
    whole = tcompose(imgs, transforms, tt, device=CPU)
    np.testing.assert_array_equal(ds.host(), auto_crop_black_border(
        ds.dev.numpy()[:ds.bbox[1], :ds.bbox[3]]))
    assert ds.shape == whole.shape


def test_device_strip_round_trip():
    rng = np.random.default_rng(3)
    canvas = torch.from_numpy(rng.integers(0, 256, (64, 96, 3),
                                           dtype=np.uint8))
    ds = DeviceStrip(canvas, (5, 50, 7, 90))
    assert ds.hw == (45, 83) and ds.shape == (45, 83, 3)
    ref = canvas.numpy()[5:50, 7:90]
    np.testing.assert_array_equal(ds.host(), ref)
    pad = np.zeros((64, 128, 3), np.uint8)
    pad[:45, :83] = ref
    np.testing.assert_array_equal(ds.device_padded(64, 128).numpy(), pad)
    ds.mark_consumed()
    assert ds.dev is None
    np.testing.assert_array_equal(ds.device_padded(64, 128).numpy(), pad)
    with pytest.raises(ValueError):
        ds.device_padded(40, 128)
    # consumed before any host copy: the canvas stays until host() makes
    # one (a writer thread may still need it), then goes
    late = DeviceStrip(canvas, (0, 4, 0, 4))
    late.mark_consumed()
    assert late.dev is not None
    np.testing.assert_array_equal(late.host(), canvas.numpy()[:4, :4])
    assert late.dev is None
    np.testing.assert_array_equal(late.host(), canvas.numpy()[:4, :4])


def _jax_imports(path):
    """Modules imported by ``path`` that are jax or the JAX package."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "drone_image_stitch_cpp_tpu"):
                bad.append(name)
    return bad


def test_port_smoke_and_cuda_tests_import_no_jax():
    paths = [os.path.join(_ROOT, "chip_smoke.py"),
             os.path.join(_ROOT, "tests", "test_torch_cuda.py")]
    for root, _, files in os.walk(os.path.join(
            _ROOT, "drone_image_stitch_cpp_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 30
    offenders = {os.path.relpath(p, _ROOT): _jax_imports(p) for p in paths}
    assert not {k: v for k, v in offenders.items() if v}
    # the parser does flag such an import
    probe = os.path.join(_ROOT, "tests", "torch_port_helpers.py")
    assert "drone_image_stitch_cpp_tpu.config.tuning" in _jax_imports(probe)
