"""K2's single-plane kernel decides each output tile's route itself; this
file proves the design's argument, not the kernel: a float32 copy of the
kernel's per-tile arithmetic, run on the CPU, shows that the monotone
corner box holds every tap and that the staged indexing reads each tap
where the staging loop put it. The copy can drift from the kernel
without this file noticing; the kernel itself is held bit-equal to its
plain version on both routes, at the frame's edges, by the ``gpu`` tests
of ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.

``warp_plane_kernel`` (``csrc/warp_affine.cu``) maps a PLANE_TILE output
tile's corners to [floor(min s), floor(max s) + 1] along each source axis,
s = ((a*x) + (b*y)) + c rounded as the kernel rounds it; the tile is
*interior* when that span lies inside the frame (its taps then skip the
bounds tests), and, clipped to the frame, is staged in shared memory when
its rows fit ``kPlaneSmemFloats``: with w % 4 == 0 as 16-byte chunks from
the aligned one holding the box's first column (``lead`` floats before
it), else float by float; a staged source (y, x) is read at y * pitch + x
+ base. In float32 with the kernel's rounding order (numpy rounds each
float32 operation, as ``__fmul_rn`` / ``__fadd_rn`` do), over every tile:

  * an interior tile's four taps of every pixel lie in the frame;
  * every in-range tap of every pixel lies in its tile's clipped box, and
    a staged tap's index in the tile's staged rows, at the row and column
    the staging loop copied it to;
  * the bench's near-identity model and a small rotation stage every tile
    that reaches the frame (the bench's 4K batch all of them); a 0.05
    scale stages none, and a 60 degree rotation at canvas coordinates
    none of the tiles whose box lies inside the frame.
"""

import math
import os
import re

import numpy as np
import pytest

from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK
from drone_image_stitch_cpp_tpu_torch.runtime.kernels import CSRC_DIR

F32 = np.float32


def _smem_floats() -> int:
    with open(os.path.join(CSRC_DIR, WK.KERNEL_SOURCE)) as f:
        return int(re.search(r"constexpr int kPlaneSmemFloats = (\d+);",
                             f.read()).group(1))


def _coord(a, b, c, x, y):
    """((a*x) + (b*y)) + c, each step rounded to float32."""
    x, y = np.asarray(x, F32), np.asarray(y, F32)
    return (F32(a) * x + F32(b) * y) + F32(c)


def _tile(inv, h, w, tx0, ty0, tx1, ty1, frame_off):
    """The kernel's decision for one tile: (interior, staged, box), box =
    (x0, y0, bw, bh, pitch, lead) or None."""
    spans = []
    for a, b, c in ((inv[0], inv[1], inv[2]), (inv[3], inv[4], inv[5])):
        s = _coord(a, b, c, np.asarray([tx0, tx1, tx0, tx1]),
                   np.asarray([ty0, ty0, ty1, ty1]))
        spans.append((math.floor(s.min()), math.floor(s.max()) + 1))
    (lx, ux), (ly, uy) = spans
    interior = lx >= 0 and ux <= w - 1 and ly >= 0 and uy <= h - 1
    if not (lx <= w - 1 and ux >= 0 and ly <= h - 1 and uy >= 0):
        return interior, False, None
    x0, y0 = max(lx, 0), max(ly, 0)
    bw, bh = min(ux, w - 1) - x0 + 1, min(uy, h - 1) - y0 + 1
    if w % 4 == 0:
        lead = (frame_off + x0) % 4
        pitch = 4 * ((lead + bw + 3) >> 2)
    else:
        lead, pitch = 0, bw
    return interior, bh * pitch <= _smem_floats(), (x0, y0, bw, bh, pitch,
                                                    lead)


def _check_tiles(a23, h, w, out_h, out_w, frame_off=0):
    """Every tile of the window checked as the module says: (tiles staged,
    tiles whose box the frame clips, tiles with a tap in the frame, tiles
    in all)."""
    inv = WK.inverse_coeffs(a23)
    th, tw = WK.PLANE_TILE
    staged = clipped = reach = total = 0
    for ty0 in range(0, out_h, th):
        for tx0 in range(0, out_w, tw):
            tx1, ty1 = min(tx0 + tw, out_w) - 1, min(ty0 + th, out_h) - 1
            interior, st, box = _tile(inv, h, w, tx0, ty0, tx1, ty1,
                                      frame_off)
            total += 1
            staged += st
            xs, ys = np.meshgrid(np.arange(tx0, tx1 + 1),
                                 np.arange(ty0, ty1 + 1))
            sx = _coord(inv[0], inv[1], inv[2], xs, ys)
            sy = _coord(inv[3], inv[4], inv[5], xs, ys)
            xi, yi = np.floor(sx).astype(np.int64), np.floor(sy).astype(
                np.int64)
            for dy in (0, 1):
                for dx in (0, 1):
                    tx, ty = xi + dx, yi + dy
                    inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
                    if interior:
                        assert inside.all()
                    if not inside.any():
                        continue
                    assert box is not None
                    x0, y0, bw, bh, pitch, lead = box
                    tx, ty = tx[inside], ty[inside]
                    assert (tx >= x0).all() and (tx < x0 + bw).all()
                    assert (ty >= y0).all() and (ty < y0 + bh).all()
                    if st:
                        idx = ty * pitch + tx + (lead - y0 * pitch - x0)
                        row, col = np.divmod(idx, pitch)
                        assert (row == ty - y0).all()
                        assert (col == tx - x0 + lead).all()
                        assert (col < pitch).all()
            clipped += box is not None and not interior
            reach += box is not None
    return staged, clipped, reach, total


def _rot(deg, tx, ty, scale=1.0):
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.asarray([[scale * c, -scale * s, tx],
                       [scale * s, scale * c, ty]], np.float32)


BENCH = np.asarray([[0.99987453, -4.4592799e-04, -59.63],
                    [4.4592799e-04, 0.99987453, -14.9]], np.float32)


@pytest.mark.parametrize("frame_off", [0, 1, 3])
@pytest.mark.parametrize("hw", [(300, 420), (301, 421), (37, 53),
                                (120, 202)])
def test_near_identity_tiles_stage_and_cover_their_taps(hw, frame_off):
    """The bench's model and a 2 degree rotation: every tile that reaches
    the frame stages; windows larger than the frame, so tiles straddle
    its edges."""
    h, w = hw
    for a23 in (BENCH, _rot(2.0, 7.3, -11.6)):
        staged, _, reach, _ = _check_tiles(a23, h, w, h + 40, w + 200,
                                           frame_off)
        assert staged == reach
    assert reach > 0


@pytest.mark.parametrize("hw", [(300, 420), (301, 421)])
def test_large_boxes_take_the_direct_gather(hw):
    """A 0.05 scale (the whole frame in one tile: its box is the frame)
    and a 60 degree rotation at canvas coordinates (a tile's box ~127 x
    92): only tiles at the frame's edges, whose box the frame clips, can
    stage."""
    h, w = hw
    staged, _, reach, _ = _check_tiles(np.asarray(
        [[0.05, 0, 3.3], [0, 0.05, 1.7]], np.float32), h, w, 320, 512)
    assert staged == 0 and reach == 1
    staged, clipped, reach, total = _check_tiles(
        _rot(60.0, 12000.5 - 11800.0, -90.25), h, w, 320, 512)
    assert staged <= clipped < reach


def test_the_bench_batch_stages_every_4k_tile():
    """The throughput bench's shape, 2160x3840 -> 2160x3840 by its model:
    every tile stages (its edge tiles' boxes are clipped, not empty)."""
    inv = WK.inverse_coeffs(BENCH)
    th, tw = WK.PLANE_TILE
    h, w = 2160, 3840
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            _, st, _ = _tile(inv, h, w, tx0, ty0, min(tx0 + tw, w) - 1,
                             min(ty0 + th, h) - 1, 0)
            assert st
