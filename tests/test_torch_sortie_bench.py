"""The port's flagship harness (``drone_image_stitch_cpp_tpu_torch/tools``)
against the JAX package's ``tools/sortie_bench.py`` and ``bench_sortie.py``
on the same inputs, on the CPU.

The sortie is ``bench_parity.py``'s ``tiny-8f`` shape (2 x 4 frames of
160x208, overlaps 0.70 / 0.35, seed 11, JPEG quality 92).

Tolerances: ``meta.json`` identical and the frames' decoded pixels within
1 level (the port's ``fractal_ortho`` upsamples with torch's bicubic, the
JAX one with cv2's: a float32 rounding apart, which moves the uint8
truncation of a few pixels by 1); ``gt_rmse`` within 1e-4 with the same
shift (the same cv2 operations in the same order). The end-to-end runs:
the same group sizes, mosaic shapes within 8 px, each GT-RMSE <= 8.0 (the
JAX tests' bound) and the two within 2.0 of each other (they differ by
RANSAC streams and the bundle adjust's float64 solve; 4.76 against 4.80
when this test was written).
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest

from torch_port_helpers import CPU  # noqa: F401  (one torch thread)

from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
from drone_image_stitch_cpp_tpu_torch.tools import bench_sortie as PB
from drone_image_stitch_cpp_tpu_torch.tools import sortie_bench as PS

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import bench_sortie as JB  # noqa: E402
from tools import sortie_bench as JS  # noqa: E402

TINY = dict(rows=2, cols=4, frame_h=160, frame_w=208)   # bench_parity tiny-8f
RMSE_MAX = 8.0
RMSE_DIFF_MAX = 2.0


@pytest.fixture(scope="module")
def sorties(tmp_path_factory):
    """(JAX root, JAX gt path, port root, port gt path)."""
    base = tmp_path_factory.mktemp("sortie")
    j_root, j_gt = JS.make_sortie(str(base / "jax"), **TINY)
    p_root, p_gt = PS.make_sortie(str(base / "port"), **TINY, device="cpu")
    return j_root, j_gt, p_root, p_gt


def _frames(root):
    d = os.path.join(root, "visible", "minfull")
    return sorted(os.listdir(d)), d


def test_make_sortie_matches_jax(sorties):
    j_root, j_gt, p_root, p_gt = sorties
    with open(os.path.join(j_root, "meta.json")) as f:
        j_meta = f.read()
    with open(os.path.join(p_root, "meta.json")) as f:
        assert f.read() == j_meta
    assert json.loads(j_meta) == dict(TINY, overlap=0.7, overlap_y=0.35,
                                      seed=11, jpeg_q=92)
    j_names, j_dir = _frames(j_root)
    p_names, p_dir = _frames(p_root)
    assert p_names == j_names and len(p_names) == 8
    for name in j_names:
        a = cv2.imread(os.path.join(j_dir, name)).astype(np.int16)
        b = cv2.imread(os.path.join(p_dir, name)).astype(np.int16)
        assert a.shape == b.shape == (160, 208, 3), name
        assert np.abs(a - b).max() <= 1, name
    ga, gb = np.load(j_gt), np.load(p_gt)
    assert ga.dtype == gb.dtype == np.uint8 and ga.shape == gb.shape
    assert np.abs(ga.astype(np.int16) - gb).max() <= 1


def test_make_sortie_is_cached(sorties):
    """A second call with the same arguments keeps the folder."""
    _, _, p_root, p_gt = sorties
    path = os.path.join(_frames(p_root)[1], "IMG0000_f0000.jpg")
    mtime = os.stat(path).st_mtime_ns
    assert PS.make_sortie(p_root, **TINY, device="cpu") == (p_root, p_gt)
    assert os.stat(path).st_mtime_ns == mtime


def _mosaics(gt):
    """The ground truth with noise; shifted by (+5, -3) px with a black
    fill; and inside a 12-px black border."""
    rng = np.random.default_rng(3)
    noisy = np.clip(gt.astype(np.float32) + rng.normal(0, 4.0, gt.shape),
                    0, 255).astype(np.uint8)
    shifted = np.zeros_like(noisy)
    shifted[5:, :-3] = noisy[:-5, 3:]
    bordered = np.zeros((gt.shape[0] + 24, gt.shape[1] + 24, 3), np.uint8)
    bordered[12:-12, 12:-12] = noisy
    return {"noisy": noisy, "shifted": shifted, "bordered": bordered}


@pytest.mark.parametrize("kind", ["noisy", "shifted", "bordered"])
def test_gt_rmse_matches_jax(sorties, kind):
    gt = np.load(sorties[1])
    mosaic = _mosaics(gt)[kind]
    for max_dim in (100, 4000):     # the last at full resolution
        rj, dxj, dyj = JS.gt_rmse(mosaic, gt, max_dim=max_dim)
        rp, dxp, dyp = PS.gt_rmse(mosaic, gt, max_dim=max_dim)
        assert np.isfinite(rp) and abs(rp - rj) <= 1e-4, (kind, rp, rj)
        assert (dxp, dyp) == (dxj, dyj), kind
    if kind == "shifted":       # the shift back is found; the RMSE is noise
        assert abs(dxp - 3) < 0.5 and abs(dyp + 5) < 0.5
        assert rp < 4.0


def _jax_flagship_mosaics():
    """Every flagship mosaic (h, w) the JAX package's TPU runs logged."""
    import glob
    import re
    out = []
    for path in sorted(glob.glob(os.path.join(_REPO, "artifacts",
                                              "flagship_r*.log"))):
        with open(path, errors="replace") as f:
            out += [(int(h), int(w)) for h, w in re.findall(
                r"^\[sortie\] ours.*mosaic=\((\d+), (\d+), 3\)", f.read(),
                re.M)]
    return out


def test_smoke_flagship_mosaic_band_is_the_jax_records():
    """chip_smoke's flagship size check holds the mosaic to the band of
    the JAX package's own flagship mosaics across its commits (one
    geometry draw each, as its GT-RMSE band 38.6-49.0), not to one draw:
    BENCH_sortie.json's 14859x25775 lies at the band's top."""
    import chip_smoke as SM
    sizes = _jax_flagship_mosaics()
    assert len(sizes) >= 10
    hs, ws = zip(*sizes)
    assert SM.FLAG_MOSAIC_BAND == ((min(hs), max(hs)), (min(ws), max(ws)))
    with open(os.path.join(_REPO, "BENCH_sortie.json")) as f:
        assert tuple(json.load(f)["mosaic_hw"]) == SM.FLAG_MOSAIC
    assert SM.FLAG_MOSAIC in sizes


def _group_sizes(records):
    return next(r["sizes"] for r in records
                if r["stage"] == "Main" and r["msg"] == "groups")


def _repo_records():
    """The JAX package's flagship records, byte for byte."""
    out = {}
    for rel in ("BENCH_sortie.json",
                os.path.join("artifacts", "BENCH_sortie_partial.json")):
        path = os.path.join(_REPO, rel)
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[rel] = f.read()
    return out


def test_run_ours_and_bench_main_match_jax(sorties, tmp_path, monkeypatch):
    """The JAX package's ``run_ours`` and the port's, the latter through
    ``bench_sortie.main`` (at the tiny frame size; its ``--work`` is the
    JAX-rendered folder, whose ``meta.json`` the port's ``make_sortie``
    takes as its cache) on the same folder. One end-to-end run each: the
    JAX package's compiles take most of this test's time. ``main`` prints
    one JSON line and writes a record only to ``--record``: neither the
    JAX package's records nor the working directory change."""
    import drone_image_stitch_cpp_tpu.runtime.logging as JL
    j_root, j_gt, _, _ = sorties
    gt = np.load(j_gt)
    jlog = JL.get_logger()
    n0 = len(jlog._records)
    _, jm, jrc = JS.run_ours(j_root, str(tmp_path / "jax_out"))
    j_sizes = _group_sizes(jlog._records[n0:])
    assert jrc == 0 and jm is not None

    before = _repo_records()
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(PB, "FRAME_H", TINY["frame_h"])
    monkeypatch.setattr(PB, "FRAME_W", TINY["frame_w"])
    lines = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: lines.append(
        " ".join(map(str, a))))
    plog = get_logger()
    n0 = len(plog._records)
    rec = tmp_path / "rec.json"
    assert PB.main(["--frames-rows", "2", "--frames-cols", "4", "--work",
                    j_root, "--device", "cpu", "--runs", "1", "--record",
                    str(rec)]) == 0
    p_recs = plog._records[n0:]
    monkeypatch.undo()
    out = json.loads(lines[-1])
    assert json.loads(rec.read_text()) == out
    assert _repo_records() == before and "BENCH_sortie.json" in before
    assert os.listdir(cwd) == []
    assert out["frames"] == 8 and out["warm_median"] is None
    run = out["runs"][0]
    assert run["label"] == "cold" and run["secs"] > 0
    assert run["launches"]["sift_orient_desc"] == 0     # plain on the CPU
    assert run["stages"]["Main:grouping"] >= 0

    assert _group_sizes(p_recs) == j_sizes == [4, 4]
    ph, pw = run["mosaic_hw"]
    assert abs(ph - jm.shape[0]) <= 8 and abs(pw - jm.shape[1]) <= 8
    rj, rp = JS.gt_rmse(jm, gt)[0], run["gt_rmse"]
    assert rj <= RMSE_MAX and rp <= RMSE_MAX, (rp, rj)
    assert abs(rp - rj) <= RMSE_DIFF_MAX, (rp, rj)
    # the flagship phase's checks read these records
    assert [r["flipped"] for r in p_recs
            if r["msg"].endswith(" aligned")] == [False]
    seams = next(r for r in p_recs if r["msg"] == "seam methods")
    assert seams["0-1"] == "graphcut"


def test_run_ours_exit_code_on_a_missing_folder(tmp_path):
    secs, mosaic, rc = PS.run_ours(str(tmp_path / "nothing"),
                                   str(tmp_path / "out"), "cpu", retries=1)
    assert rc == 1 and mosaic is None and secs >= 0


def _fake_records():
    recs = [{"stage": "Main", "msg": "scan done", "seconds": 0.01},
            {"stage": "Main", "msg": "grouping done", "seconds": 2.04},
            {"stage": "Main", "msg": "groups", "sizes": [2, 2]}]
    for gi, (reg, blend) in enumerate([(1.26, 0.3), (1.31, 0.27)]):
        recs += [{"stage": f"Strip{gi}", "msg": "register done",
                  "seconds": reg},
                 {"stage": f"Strip{gi}", "msg": "tiled blend done",
                  "seconds": blend}]
    recs += [{"stage": "GlobalCustom", "msg": "seams done", "seconds": 9.08},
             {"stage": "GlobalCustom", "msg": "seam methods", "0-1": "dp"},
             {"stage": "Main", "msg": "global compose done",
              "seconds": 12.2}]
    return recs


def test_stage_split_matches_jax():
    recs = _fake_records()
    got = PB.stage_split(recs)
    assert got == JB._stage_split(recs)
    assert got == {"Main:scan": 0.0, "Main:grouping": 2.0,
                   "strips:register": 2.6, "strips:tiled blend": 0.6,
                   "GlobalCustom:seams": 9.1, "Main:global compose": 12.2}


@pytest.mark.parametrize("secs,labels,median,warm", [
    ([300.0, 90.0, 80.0, 100.0], "cwww", 90.0, 90.0),
    ([300.0, 90.0, 80.0], "cww", 80.0, 80.0),       # lower median
    ([300.0], "c", 300.0, None),                    # no warm run
])
def test_summarize_protocol_v2(secs, labels, median, warm):
    """The median of the warm runs, as the JAX harness's protocol v2."""
    runs = [dict(label="cold" if c == "c" else "warm", secs=s,
                 gt_rmse=40.0 + k, peak_device_gib=16.0 + k)
            for k, (s, c) in enumerate(zip(secs, labels))]
    out = PB.summarize(runs)
    assert out["secs_ours"] == median and out["warm_median"] == warm
    assert out["cold_secs"] == secs[0]
    assert out["secs_ours_runs"] == secs
    assert out["warm_runs"] == labels.count("w")
    k = secs.index(median)
    assert out["gt_rmse_ours"] == runs[k]["gt_rmse"]
    assert out["peak_device_gib"] == runs[k]["peak_device_gib"]
    warm_secs = sorted(s for s, c in zip(secs, labels) if c == "w") \
        or secs
    assert out["warm_spread"] == [warm_secs[0], warm_secs[-1]]
    assert out["protocol_version"] == 2
