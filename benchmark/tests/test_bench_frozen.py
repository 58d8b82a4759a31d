"""The benchmark's frozen copies against the program's current code, on
small seeds: the renderers and the GT-RMSE byte for byte, the busy-share
union and K1's work count against chip_smoke's. A drift on either side
fails here."""

import os

import numpy as np
import pytest
import torch

from mosaicbench import render, score, trace, work


def test_fractal_ortho_equal():
    from drone_image_stitch_cpp_tpu_torch.utils import synthetic
    a = render.fractal_ortho(200, 333, seed=2**33 + 5)
    b = synthetic.fractal_ortho(200, 333, seed=2**33 + 5)
    assert a.tobytes() == b.tobytes()


def test_synthetic_ortho_and_make_frames_equal():
    from drone_image_stitch_cpp_tpu_torch.tools import bench_throughput
    got = render.make_batches(1, 3, 100, 180, seed=9)[0]
    want = bench_throughput.make_frames(3, 100, 180, seed=9)
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))


def test_batches_are_offset_crops():
    b = render.make_batches(3, 2, 40, 50, 4, 8, 2, 3, seed=1)
    assert b.shape == (3, 2, 40, 50)
    # batch 0's frame 1 starts at (4, 8) of the ortho, batch 1's frame 0
    # at (2, 3): they share the ortho from (4, 8) on
    assert np.array_equal(b[1, 0, 2:, 5:], b[0, 1, :38, :45])
    # batch 2's frame 1 at (8, 14) against batch 0's frame 1 at (4, 8)
    assert np.array_equal(b[2, 1, :36, :44], b[0, 1, 4:, 6:])
    assert not np.array_equal(b[0], b[1])


def test_render_sortie_equal_make_sortie(tmp_path):
    from drone_image_stitch_cpp_tpu_torch.tools import sortie_bench
    root, gt_path = sortie_bench.make_sortie(
        str(tmp_path / "port"), 2, 3, 96, 128, seed=77, device="cpu")
    gt = render.render_sortie(str(tmp_path / "ours"), 2, 3, 96, 128,
                              seed=77, device="cpu")
    assert gt.tobytes() == np.load(gt_path).tobytes()
    port = os.path.join(root, "visible", "minfull")
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(tmp_path / "ours"))
    for n in names:
        with open(os.path.join(port, n), "rb") as f, \
                open(tmp_path / "ours" / n, "rb") as g:
            assert f.read() == g.read(), n


def test_render_from_the_terrain_cache_is_the_same(tmp_path):
    """A sortie rendered with the terrain cache, when it makes the cache
    and when it reads it, has the bytes of one rendered without it."""
    kw = dict(rows=2, cols=3, frame_h=96, frame_w=128, seed=77,
              device="cpu", noise_seed=2**33 + 1)
    want = render.render_sortie(str(tmp_path / "plain"), **kw)
    for k in ("made", "read"):
        gt = render.render_sortie(str(tmp_path / k), **kw,
                                  cache_dir=str(tmp_path / "cache"))
        assert gt.tobytes() == want.tobytes()
        for n in os.listdir(tmp_path / "plain"):
            with open(tmp_path / "plain" / n, "rb") as f, \
                    open(tmp_path / k / n, "rb") as g:
                assert f.read() == g.read(), (k, n)
    assert len(os.listdir(tmp_path / "cache")) == 1


def test_gt_rmse_rows_equal():
    from drone_image_stitch_cpp_tpu_torch.tools import sortie_bench
    gt = render.fractal_ortho(300, 400, seed=3).astype(np.uint8)
    mosaic = np.ascontiguousarray(gt[5:290, 7:395])
    rows = [(0, 150), (100, 300)]
    assert score.gt_rmse_rows(mosaic, gt, 200, rows) == \
        sortie_bench.gt_rmse_rows(mosaic, gt, 200, rows)


def test_score_image_reads_blocks_and_coverage():
    gt = render.fractal_ortho(300, 400, seed=4).astype(np.uint8)
    good = score.score_image(gt, gt, (100, 100), 6000)
    assert good["rmse"] == 0.0 and good["size_px"] == 0
    holed = gt.copy()
    holed[100:200, 100:200] = 0
    bad = score.score_image(holed, gt, (100, 100), 6000)
    assert bad["uncovered"] > good["uncovered"] + 5.0
    bad = score.score_image(np.ascontiguousarray(gt[:, :300]), gt,
                            (100, 100), 6000)
    assert bad["size_px"] == 100 and bad["uncovered"] > 20.0


def test_union_equal_smoke():
    import chip_smoke
    r = np.random.default_rng(0)
    iv = [(a, a + d) for a, d in zip(r.uniform(0, 100, 200),
                                     r.uniform(0, 3, 200))]
    assert trace.union_s(iv) == pytest.approx(chip_smoke._union_us(iv),
                                              abs=0, rel=0)


def test_k1_work_is_the_smoke_count_at_angle_zero():
    import chip_smoke
    g = torch.Generator().manual_seed(0)
    gauss = torch.rand((6, 60, 80), generator=g)
    n = 50
    layer = torch.randint(0, 6, (n,), generator=g)
    yf = torch.rand(n, generator=g) * 50 + 5
    xf = torch.rand(n, generator=g) * 70 + 5
    sigma = torch.rand(n, generator=g) * 2.0 + 1.0
    th = torch.full((n,), 60.0)
    tw = torch.full((n,), 80.0)
    ours = work.k1_work(gauss, layer, yf, xf, sigma, th, tw)
    smoke = chip_smoke._k1_work(torch, gauss, layer, yf, xf, sigma, th, tw,
                                torch.zeros(n))
    assert ours == smoke


def test_support_radius_equal():
    from drone_image_stitch_cpp_tpu_torch.ops import sift_kernel
    for s in (0.5, 1.6, 3.2, 7.9, 100.0):
        assert work.support_radius(s) == sift_kernel.support_radius(s)


def test_k2_touched_pixels_equal_smoke_on_a_translation():
    import chip_smoke
    a23 = np.array([[1, 0, -7.25], [0, 1, -3.5]], np.float32)
    ours = work.touched_source_pixels(a23, 40, 60, 40, 60, "cpu")
    inv = [1, 0, 7.25, 0, 1, 3.5]
    smoke = chip_smoke._k2_source_pixels(torch, "cpu", inv, 40, 60, 40, 60)
    assert ours == smoke


def test_noise_seed_draws_only_the_sensor_noise():
    """One terrain under two noise seeds differs by the N(0, 3) noise
    layer alone (clipped at 0 and 255)."""
    a = render.fractal_ortho(120, 160, seed=11, noise_seed=1)
    b = render.fractal_ortho(120, 160, seed=11, noise_seed=2)
    d = (a - b)[(a > 0) & (a < 255) & (b > 0) & (b < 255)]
    assert 3.0 * np.sqrt(2) * 0.9 < d.std() < 3.0 * np.sqrt(2) * 1.1
    assert abs(d.mean()) < 0.2
