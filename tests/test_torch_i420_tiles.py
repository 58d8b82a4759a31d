"""K2's staged I420 source: the host tile plan against the kernel's boxes,
on the CPU (no card needed).

The staged kernel (``csrc/warp_affine.cu``, ``warp_i420_staged_kernel``)
warps each ``I420_TILE`` output tile from a source box it stages in shared
memory: along each source axis [floor(min s), floor(max s) + 1] over the
tile's four corners, s = ((a*x) + (b*y)) + c rounded as the kernel rounds
it, clipped to the frame; the chroma box one sample wider on each side,
clipped to the chroma plane. The wrapper sizes the launch's shared memory
with ``ops/warp_kernel.i420_box`` from the host affines. Here, in float32
with the kernel's rounding order (numpy rounds each float32 operation, as
``__fmul_rn`` / ``__fadd_rn`` do):

  * every tile's box fits the planned box, and its chroma box the chroma
    rows and columns that ``i420_smem_bytes`` lays out;
  * every in-range tap of every output pixel (all four) lies in its tile's
    box, and its chroma sample and clamped neighbour (cx, nx, cy, ny) in
    the tile's chroma box: over every tile of the small windows; of the
    4K windows over every ragged edge tile, every tile whose box the frame
    clips and 64 more drawn from a seed;
  * the compose feed and the identity plan as staged; the seam batch (a
    0.12 downscale: a 24x128 tile's box would need megabytes), a 45 degree
    rotation and a 0.2 scale plan as per-tap.
"""

import math

import numpy as np
import pytest

from drone_image_stitch_cpp_tpu_torch.ops import warp_kernel as WK

F32 = np.float32
FRAME = (2160, 3840)
SEAM_SCALE = math.sqrt(0.12e6 / (FRAME[0] * FRAME[1]))   # visible preset


def _rot(deg, tx, ty, scale=1.0):
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.asarray([[scale * c, -scale * s, tx], [scale * s, scale * c,
                                                     ty]], np.float32)


def _seam_batch():
    """The smoke corridor's seam batch: 12 frames 1152 px apart at the
    seam scale into the 320x2048 canvas."""
    return [np.asarray([[SEAM_SCALE, 0, SEAM_SCALE * 1152 * k],
                        [0, SEAM_SCALE, 0]], np.float32) for k in range(12)]


# (frame h, w), (out_h, out_w), src->dst affines
CASES = {
    "identity": (FRAME, FRAME, [_rot(0.0, 0.0, 0.0)]),
    "compose_feed": (FRAME, (2176, 3904), [_rot(2.0, 12000.37 - 11904.0,
                                                20.61)]),
    "rot15": ((36, 54), (320, 512), [_rot(15.0, 12000.5 - 11990.0, -3.25)]),
    "rot1_canvas_1p6e4": (FRAME, (2176, 16512), [_rot(1.0, 12600.37,
                                                      8.61)]),
    "scale049": (FRAME, (1088, 1920), [np.asarray(
        [[0.49, 0.0, 0.37], [0.0, 0.49, 1.61]], np.float32)]),
    "seam_batch": (FRAME, (320, 2048), _seam_batch()),
    "over_all_borders": ((36, 54), (64, 96), [np.asarray(
        [[1.3, 0.05, 20.3], [-0.04, 1.1, 10.7]], np.float32)]),
}


def _coord(a, b, c, x, y):
    """((a*x) + (b*y)) + c, each float32 operation rounded (src_coord)."""
    return (F32(a) * x.astype(F32) + F32(b) * y.astype(F32)) + F32(c)


def _neighbour(x, n):
    """The chroma neighbour of full-resolution x in n samples (chroma_nb)."""
    c = x >> 1
    return np.where(x & 1, np.minimum(c + 1, n - 1), np.maximum(c - 1, 0))


def _tiles(out_h, out_w):
    """(ty0, tx0, ty1, tx1) of every output tile, inclusive."""
    th, tw = WK.I420_TILE
    ty, tx = np.meshgrid(np.arange(0, out_h, th), np.arange(0, out_w, tw),
                         indexing="ij")
    ty, tx = ty.ravel(), tx.ravel()
    return np.stack([ty, tx, np.minimum(ty + th, out_h) - 1,
                     np.minimum(tx + tw, out_w) - 1], axis=1)


def _boxes(inv, h, w, tiles):
    """The kernel's boxes of ``tiles``: (ok, luma (y0, y1, x0, x1), chroma
    (cy0, cy1, cx0, cx1)), inclusive, as tap_span and the staged kernel
    compute them."""
    ty0, tx0, ty1, tx1 = tiles.T

    def span(a, b, c, n):
        s = np.stack([_coord(a, b, c, x, y) for x, y in
                      ((tx0, ty0), (tx1, ty0), (tx0, ty1), (tx1, ty1))])
        lo = np.floor(s.min(axis=0))
        hi = np.floor(s.max(axis=0)) + F32(1)
        ok = (lo <= n - 1) & (hi >= 0)
        return (ok, np.maximum(lo, 0).astype(np.int64),
                np.minimum(hi, n - 1).astype(np.int64))

    oky, y0, y1 = span(inv[3], inv[4], inv[5], h)
    okx, x0, x1 = span(inv[0], inv[1], inv[2], w)
    ch, cw = h >> 1, w >> 1
    chroma = (np.maximum((y0 >> 1) - 1, 0), np.minimum((y1 >> 1) + 1, ch - 1),
              np.maximum((x0 >> 1) - 1, 0), np.minimum((x1 >> 1) + 1, cw - 1))
    return oky & okx, (y0, y1, x0, x1), chroma


def _pixel_tiles(tiles, ok, luma, h, w, out_h, out_w, seed=0):
    """Indices of the non-empty tiles whose pixels are checked: all of a
    small window; of a large one the ragged edge tiles, the tiles whose
    box the frame clips, and 64 more drawn from ``seed``."""
    idx = np.flatnonzero(ok)
    if len(tiles) <= 512:
        return idx
    th, tw = WK.I420_TILE
    y0, y1, x0, x1 = (v[idx] for v in luma)
    t = tiles[idx]
    edge = (t[:, 2] - t[:, 0] + 1 < th) | (t[:, 3] - t[:, 1] + 1 < tw)
    clipped = (y0 == 0) | (x0 == 0) | (y1 == h - 1) | (x1 == w - 1)
    pick = set(idx[edge | clipped].tolist())
    rng = np.random.default_rng(seed)
    pick |= set(rng.choice(idx, min(64, len(idx)), replace=False).tolist())
    return np.asarray(sorted(pick))


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_tile_box_fits_the_plan(case):
    (h, w), (out_h, out_w), a23s = CASES[case]
    invs = [WK.inverse_coeffs(a) for a in a23s]
    bh, bw = WK.i420_box(invs, h, w, out_h, out_w)
    cbh, cbw = min((bh >> 1) + 3, h >> 1), min((bw >> 1) + 3, w >> 1)
    tiles = _tiles(out_h, out_w)
    for inv in invs:
        ok, (y0, y1, x0, x1), (cy0, cy1, cx0, cx1) = _boxes(inv, h, w, tiles)
        assert ok.any()
        assert (y1 - y0 + 1)[ok].max() <= bh
        assert (x1 - x0 + 1)[ok].max() <= bw
        assert (cy1 - cy0 + 1)[ok].max() <= cbh
        assert (cx1 - cx0 + 1)[ok].max() <= cbw


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_tap_lies_in_its_tile_box(case):
    (h, w), (out_h, out_w), a23s = CASES[case]
    th, tw = WK.I420_TILE
    ch, cw = h >> 1, w >> 1
    tiles = _tiles(out_h, out_w)
    for k, a23 in enumerate(a23s[:3]):
        inv = WK.inverse_coeffs(a23)
        ok, luma, chroma = _boxes(inv, h, w, tiles)
        sel = _pixel_tiles(tiles, ok, luma, h, w, out_h, out_w, seed=k)
        # every pixel of the selected tiles, a ragged tile's outside ones
        # masked
        dy, dx = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
        t = tiles[sel]
        y = t[:, 0, None, None] + dy
        x = t[:, 1, None, None] + dx
        inside = (y <= t[:, 2, None, None]) & (x <= t[:, 3, None, None])
        sx = _coord(inv[0], inv[1], inv[2], x, y)
        sy = _coord(inv[3], inv[4], inv[5], x, y)
        xi = np.floor(sx).astype(np.int64)
        yi = np.floor(sy).astype(np.int64)
        by0, by1, bx0, bx1 = (v[sel, None, None] for v in luma)
        cy0, cy1, cx0, cx1 = (v[sel, None, None] for v in chroma)
        n_taps = 0
        for ty, tx in ((yi, xi), (yi, xi + 1), (yi + 1, xi),
                       (yi + 1, xi + 1)):
            read = inside & (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
            n_taps += int(read.sum())
            assert ((ty >= by0) & (ty <= by1) & (tx >= bx0)
                    & (tx <= bx1))[read].all()
            for c, lo, hi in ((tx >> 1, cx0, cx1),
                              (_neighbour(tx, cw), cx0, cx1),
                              (ty >> 1, cy0, cy1),
                              (_neighbour(ty, ch), cy0, cy1)):
                assert ((c >= lo) & (c <= hi))[read].all()
        assert n_taps > 0


@pytest.mark.parametrize("case,staged", [
    ("identity", True), ("compose_feed", True), ("seam_batch", False),
    ("rot45", False), ("scale02", False)])
def test_plan_picks_the_kernel_by_geometry(case, staged):
    extra = {"rot45": (FRAME, (2176, 3904), [_rot(45.0, 1000.0, -500.0)]),
             "scale02": (FRAME, (432, 768), [_rot(0.0, 0.3, 0.7, 0.2)])}
    (h, w), (out_h, out_w), a23s = {**CASES, **extra}[case]
    invs = [WK.inverse_coeffs(a) for a in a23s]
    plan = WK.i420_plan(invs, h, w, out_h, out_w)
    box = WK.i420_box(invs, h, w, out_h, out_w)
    smem = WK.i420_smem_bytes(box, h, w)
    assert (plan is not None) == staged
    assert (smem <= WK.I420_SMEM_CAP) == staged
    if staged:
        assert plan == (*box, smem)


def test_compose_feed_box_and_shared_memory():
    """The compose feed's 2 degree tile box: 127 sin 2deg + 31 cos 2deg
    rows and 127 cos 2deg + 31 sin 2deg columns of spread, plus the 2 tap
    rows/columns and 1 for the corners' rounding; its shared memory above
    the 48 KB a launch gets without opting in, below the cap."""
    (h, w), (out_h, out_w), a23s = CASES["compose_feed"]
    invs = [WK.inverse_coeffs(a) for a in a23s]
    s, c = math.sin(math.radians(2.0)), math.cos(math.radians(2.0))
    th, tw = (t - 1 for t in WK.I420_TILE)
    bh, bw = WK.i420_box(invs, h, w, out_h, out_w)
    assert bh == math.ceil((tw * s + th * c)) + 2
    assert bw == math.ceil((tw * c + th * s)) + 2
    assert 48 * 1024 < WK.i420_plan(invs, h, w, out_h, out_w)[2] \
        <= WK.I420_SMEM_CAP


def test_non_finite_coordinates_plan_per_tap():
    inv = (1.0, 0.0, math.nan, 0.0, 1.0, 0.0)
    assert WK.i420_box([inv], 36, 54, 8, 8) is None
    assert WK.i420_plan([inv], 36, 54, 8, 8) is None
