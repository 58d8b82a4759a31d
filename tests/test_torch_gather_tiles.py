"""K2's gather kernel (uint8, float32 and per-tap I420 sources) picks each
output tile's route itself; this file proves the design's argument, not
the kernel: a float32 copy of the kernel's per-tile decision, run on the
CPU, is held against brute force over every pixel of the tile, with the
sample coordinates of the plain version (``ops/warp.dst_to_src_coords``).
The copy can drift from the kernel without this file noticing; the kernel
itself is held bit-equal to its plain version on every route by the
``gpu`` tests of ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.

``warp_affine_tile_kernel`` (``csrc/warp_affine.cu``) maps a TILE output
tile's corners to [floor(min s), floor(max s) + 1] along each source
axis, s = ((a*x) + (b*y)) + c rounded as the kernel rounds it, and takes

  * the zero route when all corners' coordinates are finite and the span
    misses the frame on some axis: every pixel of the tile has no tap in
    the frame (and its plain value is 0, not NaN);
  * else the direct route; *interior* (no bounds tests) only when the
    span lies inside the frame, where every tap is in range.

The source's type does not enter the decision. Affines: hypothesis draws
(rotations up to 90 degrees, scales 0.1-2, canvas-size offsets), the
flagship's seam batch (scale 0.1449 and 0.1203, 20 frames 1152 px
apart), the compositing feed's shape (a near-identity affine, 1061x1886
into 1088x2048, sampled tiles), and affines whose inverse is not
finite.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
from drone_image_stitch_cpp_tpu_torch.ops.warp import dst_to_src_coords

F32 = np.float32


def _coord(a, b, c, x, y):
    """((a*x) + (b*y)) + c, each step rounded to float32."""
    with np.errstate(all="ignore"):
        x, y = np.asarray(x, F32), np.asarray(y, F32)
        return (F32(a) * x + F32(b) * y) + F32(c)


def _tile_route(inv, h, w, tile):
    """The kernel's decision for the tile (tx0, ty0, tx1, ty1): (route,
    interior)."""
    tx0, ty0, tx1, ty1 = tile
    spans, finite = [], True
    for a, b, c in ((inv[0], inv[1], inv[2]), (inv[3], inv[4], inv[5])):
        s = _coord(a, b, c, np.asarray([tx0, tx1, tx0, tx1]),
                   np.asarray([ty0, ty0, ty1, ty1]))
        finite &= bool(np.isfinite(s).all())
        spans.append((math.floor(s.min()), math.floor(s.max()) + 1)
                     if finite else None)
    if finite:
        (lx, ux), (ly, uy) = spans
        if not (lx <= w - 1 and ux >= 0 and ly <= h - 1 and uy >= 0):
            return "zero", False
        return "direct", lx >= 0 and ux <= w - 1 and ly >= 0 and uy <= h - 1
    return "direct", False


def _tiles(out_h, out_w):
    th, tw = WK.TILE
    for ty0 in range(0, out_h, th):
        for tx0 in range(0, out_w, tw):
            yield tx0, ty0, min(tx0 + tw, out_w) - 1, min(ty0 + th, out_h) - 1


def _check_window(inv, h, w, out_h, out_w, tiles=None):
    """Every tile (or the given ones) of the window against brute force
    over the plain version's coordinates: ({route: tiles}, interior
    tiles)."""
    sx, sy = (v.numpy() for v in dst_to_src_coords(
        torch.tensor(inv, dtype=torch.float32).reshape(2, 3), out_h, out_w))
    counts, interiors = {r: 0 for r in WK.ROUTES}, 0
    for tile in (tiles or _tiles(out_h, out_w)):
        tx0, ty0, tx1, ty1 = tile
        route, interior = _tile_route(inv, h, w, tile)
        counts[route] += 1
        interiors += interior
        ts = (slice(ty0, ty1 + 1), slice(tx0, tx1 + 1))
        x, y = sx[ts], sy[ts]
        # the plain version's taps: floor, then +1, in range or not
        with np.errstate(invalid="ignore"):
            xi = np.floor(np.nan_to_num(x, nan=-9e9, posinf=9e9,
                                        neginf=-9e9)).astype(np.int64)
            yi = np.floor(np.nan_to_num(y, nan=-9e9, posinf=9e9,
                                        neginf=-9e9)).astype(np.int64)
        if route == "zero" or interior:
            assert np.isfinite(x).all() and np.isfinite(y).all()
        for dy in (0, 1):
            for dx in (0, 1):
                tx, ty = xi + dx, yi + dy
                inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
                if route == "zero":
                    assert not inside.any()
                if interior:
                    assert inside.all()
    return counts, interiors


def _rot(deg, tx, ty, s=1.0):
    c, sn = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.asarray([[s * c, -s * sn, tx], [s * sn, s * c, ty]],
                      np.float32)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(deg=st.floats(-90.0, 90.0), scale=st.floats(0.1, 2.0),
       tx=st.floats(-400.0, 400.0), ty=st.floats(-300.0, 300.0),
       hw=st.sampled_from([(61, 90), (120, 202), (37, 53), (300, 131)]),
       win=st.sampled_from([(70, 150), (131, 211), (24, 128), (7, 300)]))
def test_drawn_affines_route_every_tile_as_brute_force_says(deg, scale, tx,
                                                            ty, hw, win):
    """Hypothesis affines: every tile's route and interior flag against
    brute force, and every tile counted once."""
    h, w = hw
    inv = WK.inverse_coeffs(_rot(deg, tx, ty, scale))
    c, _ = _check_window(inv, h, w, *win)
    th, tw = WK.TILE
    assert sum(c.values()) == -(-win[0] // th) * -(-win[1] // tw)


@pytest.mark.parametrize("scale,ow", [(0.1449, 3776), (0.1203, 3136)])
def test_flagship_seam_batch_is_mostly_zero_tiles(scale, ow):
    """The flagship's seam batch, 20 frames of 2160x3840 at 1152 px
    steps into one 320-row window: each frame's tiles are zero except the
    ~5 tile columns its footprint crosses, which are direct."""
    h, w, oh = 2160, 3840, 320
    total = {r: 0 for r in WK.ROUTES}
    for k in range(20):
        inv = WK.inverse_coeffs(_rot(0.0, scale * 1152.0 * k, 0.0, scale))
        c, _ = _check_window(inv, h, w, oh, ow)
        assert 0 < c["direct"] < c["zero"]
        for r in WK.ROUTES:
            total[r] += c[r]
    assert total["zero"] > 4 * total["direct"]


def test_compositing_feed_routes_and_interior_tiles():
    """The compositing feed's shape (1061x1886 float32 into 1088x2048 by a
    near-identity affine): of the tiles at the window's corners, edges and
    middle, those that reach the frame are direct and those past its
    edges zero, and the ones whose taps all lie in the frame drop the
    bounds tests (brute force over those tiles; the kernel decides each
    tile alike)."""
    h, w, oh, ow = 1061, 1886, 1088, 2048
    inv = WK.inverse_coeffs(_rot(0.01, 3.62, 9.41))
    th, tw = WK.TILE
    rows = [0, th * 22, th * 44, oh - oh % th]
    cols = [0, tw * 7, tw * 14, ow - tw]
    tiles = [(x, y, min(x + tw, ow) - 1, min(y + th, oh) - 1)
             for y in rows if y < oh for x in cols]
    c, interiors = _check_window(inv, h, w, oh, ow, tiles)
    # row 0 lies above the frame (moved 9.41 rows down), column 1920 past
    # its right edge; the middle column's tiles below row 0 are interior
    assert c == {"zero": 6, "direct": 6} and interiors == 2


@pytest.mark.parametrize("frame,win", [((300, 420), (331, 517)),
                                       ((120, 202), (260, 300))])
def test_rotations_to_90_degrees(frame, win):
    """Rotations of 0-90 degrees about a canvas point: every tile's route
    against brute force; some tiles are zero and some direct at every
    angle."""
    h, w = frame
    for deg in (0.0, 2.0, 10.0, 30.0, 60.0, 90.0):
        a23 = _rot(deg, 12000.5 - 11800.0 + 100.0 * math.sin(deg), -30.25)
        c, _ = _check_window(WK.inverse_coeffs(a23), h, w, *win)
        assert c["zero"] > 0 and c["direct"] > 0


def test_non_finite_coordinates_are_never_zero_tiles():
    """Coefficients whose products overflow or are NaN: no tile is zero
    (the plain version gives NaN there, which a zero tile would not) and
    none is interior."""
    h, w = 40, 60
    for inv in ((1e30, 0.0, 0.0, 0.0, 1e30, 0.0),
                (float("inf"), 0.0, 0.0, 0.0, 1.0, 0.0),
                (1.0, 0.0, float("nan"), 0.0, 1.0, 0.0),
                (1.0, 0.0, -1e38, 0.0, 1.0, 0.0)):
        for tile in _tiles(50, 300):
            route, interior = _tile_route(inv, h, w, tile)
            s = [_coord(inv[0], inv[1], inv[2], x, y)
                 for x in (tile[0], tile[2]) for y in (tile[1], tile[3])]
            if not np.isfinite(s).all():
                assert route == "direct" and not interior
    # an affine whose inverse overflows (1 / 1e-39): every tile is direct,
    # the one that meets row 0 (inf * 0: NaN) and the others (infinite
    # coordinates)
    a23 = np.asarray([[1.0, 0.0, 0.0], [0.0, 1e-39, 0.0]], np.float32)
    inv = WK.inverse_coeffs(a23)
    assert not math.isfinite(inv[4])
    assert {_tile_route(inv, h, w, t) for t in _tiles(50, 300)} == {
        ("direct", False)}


def test_tile_and_routes_match_the_kernel_source():
    """TILE and ROUTES are the kernel's kGatherTileH x kTileW output tile
    and the order of its tile counter (enum Route)."""
    import os
    import re
    from drone_image_stitch_cpp_tpu_torch.runtime.kernels import CSRC_DIR
    with open(os.path.join(CSRC_DIR, WK.KERNEL_SOURCE)) as f:
        src = f.read()

    def const(name):
        return eval(re.search(rf"constexpr int {name} = ([^;]+);",
                              src).group(1), {"kPix": 4})
    assert (const("kGatherTileH"), 32 * const("kPix")) == WK.TILE
    enum = re.search(r"enum Route \{([^}]*)\}", src).group(1)
    order = {int(v): k for k, v in re.findall(r"k(\w+)Tile = (\d+)", enum)}
    assert tuple(order[i].lower() for i in sorted(order)) == WK.ROUTES
