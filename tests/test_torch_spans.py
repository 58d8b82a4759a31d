"""The port's span recorder (runtime/logging.StageLogger.timer / span) and
the spans the seam, grouping and tiled-blend steps write. CPU only, no
JAX: ``PYTHONPATH= python -m pytest tests/test_torch_spans.py -q``."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from drone_image_stitch_cpp_tpu_torch.grouping import flight_grouper as FG
from drone_image_stitch_cpp_tpu_torch.ops import blend as B
from drone_image_stitch_cpp_tpu_torch.ops import seam as S
from drone_image_stitch_cpp_tpu_torch.pipeline.pairgraph import PairGraph
from drone_image_stitch_cpp_tpu_torch.runtime import logging as L
from drone_image_stitch_cpp_tpu_torch.utils import native as N
from drone_image_stitch_cpp_tpu_torch.config.tuning import StitchTuning

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture
def log():
    """The program's logger, with the records this test writes."""
    lg = L.get_logger()
    n0 = len(lg._records)
    lg.new = lambda: lg._records[n0:]
    yield lg
    del lg.new


def _by_msg(recs):
    return {r["msg"]: r for r in recs}


def test_nested_spans_carry_stage_and_parent(log, capsys):
    with log.timer("Outer", "stage"):
        with log.span("step", n=3, bytes=7):
            with log.span("inner"):
                pass
        with log.span("other", stage="Given"):
            with log.span("deep"):
                pass
    recs = _by_msg(log.new())
    assert [r["msg"] for r in log.new()] == [
        "inner done", "step done", "deep done", "other done", "stage done"]
    assert recs["stage done"]["stage"] == "Outer"
    assert recs["stage done"]["parent"] is None
    assert (recs["step done"]["stage"], recs["step done"]["parent"]) == (
        "Outer", "stage done")
    assert recs["step done"]["n"] == 3 and recs["step done"]["bytes"] == 7
    assert recs["inner done"]["parent"] == "step done"
    assert (recs["other done"]["stage"], recs["other done"]["parent"]) == (
        "Given", "stage done")
    assert (recs["deep done"]["stage"], recs["deep done"]["parent"]) == (
        "Given", "other done")
    # only the stage prints, with its seconds to 3 decimals; the record
    # keeps them unrounded
    secs = recs["stage done"]["seconds"]
    assert capsys.readouterr().out.splitlines() == [
        f"[Outer] stage done seconds={round(secs, 3):.4g}"]


def test_span_prints_nothing_and_outside_a_stage_has_none(log, capsys):
    with log.span("alone", k=1):
        pass
    rec, = log.new()
    assert capsys.readouterr().out == ""
    assert (rec["stage"], rec["parent"], rec["k"]) == ("", None, 1)


def test_a_failed_block_writes_no_record_and_closes(log):
    with pytest.raises(ValueError):
        with log.timer("T", "fails"):
            raise ValueError("x")
    with log.span("after", stage="T"):
        pass
    rec, = log.new()
    assert rec["msg"] == "after done" and rec["parent"] is None


def test_the_open_spans_are_per_thread(log):
    opened, release = threading.Event(), threading.Event()
    seen = {}

    def worker():
        opened.wait(5)
        with log.span("in thread"):
            pass
        with log.span("given", stage="W"):
            with log.span("below"):
                pass
        seen.update(_by_msg(log.new()))
        release.set()

    th = threading.Thread(target=worker)
    th.start()
    with log.span("main", stage="M"):
        opened.set()
        release.wait(5)
    th.join(5)
    assert (seen["in thread done"]["stage"],
            seen["in thread done"]["parent"]) == ("", None)
    assert (seen["below done"]["stage"], seen["below done"]["parent"]) == (
        "W", "given done")
    assert _by_msg(log.new())["main done"]["parent"] is None


def test_ts_minus_seconds_is_the_start(log):
    """The span's start (ts - seconds) and end (ts) lie between the
    time.time() reads beside them, to 1e-4 s (the two clocks' mix)."""
    for _ in range(5):
        t_before = time.time()
        with log.span("timed", stage="T"):
            t_in = time.time()
            time.sleep(0.002)
            t_last = time.time()
        t_out = time.time()
        rec = log.new()[-1]
        start = rec["ts"] - rec["seconds"]
        assert t_before - 1e-4 <= start <= t_in + 1e-4
        assert t_last - 1e-4 <= rec["ts"] <= t_out + 1e-4
        assert rec["seconds"] >= 0.002


def _pair(h, w, x_split, overlap, seed=0):
    """Two (h, w, 3) float32 images side by side whose masks overlap on
    columns [x_split - overlap, x_split)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    ma = np.zeros((h, w), bool)
    mb = np.zeros((h, w), bool)
    ma[:, :x_split] = True
    mb[:, x_split - overlap:] = True
    a = base * ma[..., None]
    b = (base + rng.normal(0, 8, base.shape).astype(np.float32)) \
        * mb[..., None]
    return a, b, ma, mb


@pytest.mark.parametrize("h,w", [(128, 384), (256, 512)])
def test_graph_cut_spans_count_the_solver_nodes(log, monkeypatch, h, w):
    if N.graphcut_library() is None:
        pytest.skip("the native graph-cut solver did not build")
    grids = []
    solve = N._GC["fn"]

    def counted(gh, gw, *args):
        grids.append(gh * gw)
        return solve(gh, gw, *args)

    monkeypatch.setitem(N._GC, "fn", counted)
    a, b, ma, mb = _pair(h, w, w // 2 + 32, 64)
    imgs = [torch.from_numpy(a), torch.from_numpy(b)]
    masks = [torch.from_numpy(ma), torch.from_numpy(mb)]
    methods = {}
    with log.span("seams", stage="GlobalCustom"):
        S.find_seams_sequential(imgs, masks, method="graphcut",
                                methods=methods)
    assert methods == {(0, 1): "graphcut"}
    recs = log.new()
    solves = [r for r in recs if r["msg"] == "seam solve done"]
    assert grids and len(solves) == len(grids)
    assert sum(r["nodes"] for r in solves) == sum(grids)
    # the coarse path above GC_COARSE_NODES: a coarse and a fine solve
    assert (len(grids) >= 2) == (h * w > S.GC_COARSE_NODES)
    msgs = {r["msg"] for r in recs}
    assert {"seam fetch done", "seam problem done"} <= msgs
    assert ("seam band done" in msgs) == (h * w > S.GC_COARSE_NODES)
    for r in recs[:-1]:
        assert r["stage"] == "GlobalCustom", r
        assert r["parent"] == "seams done", r


def test_dp_scan_rows_are_the_overlap_height(log):
    h, w = 128, 256
    a, b, ma, mb = _pair(h, w, 160, 64)
    with log.span("seams", stage="Strip0"):
        S.find_seams_sequential([torch.from_numpy(a), torch.from_numpy(b)],
                                [torch.from_numpy(ma), torch.from_numpy(mb)],
                                ["vertical"])
    scans = [r for r in log.new() if r["msg"] == "dp scan done"]
    assert len(scans) == 1
    assert (scans[0]["rows"], scans[0]["cols"]) == (h, 64)
    assert (scans[0]["stage"], scans[0]["parent"]) == ("Strip0",
                                                       "seams done")


def _feed(boxes, frames):
    def feed(cv, i, ey0, ex0, eh, ew):
        x0, y0 = int(boxes[i][0]) - ex0, int(boxes[i][1]) - ey0
        img = torch.zeros((eh, ew, 3))
        m = torch.zeros((eh, ew))
        ys = slice(max(0, y0), min(eh, y0 + 40))
        xs = slice(max(0, x0), min(ew, x0 + 70))
        if ys.start < ys.stop and xs.start < xs.stop:
            img[ys, xs] = torch.from_numpy(frames[i][
                ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0]
            ).float()
            m[ys, xs] = 1.0
        return B.mb_feed(cv, img, m, 0, 0, m > 0)
    return feed


@pytest.mark.parametrize("packed", [False, True])
def test_tiled_blend_spans(log, packed):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (40, 70, 3), dtype=np.uint8)
              for _ in range(3)]
    boxes = [(13.0, 9.0, 82.0, 48.0), (70.0, 30.0, 139.0, 69.0),
             (150.0, 5.0, 219.0, 44.0)]
    rows = []
    with log.span("tiled blend", stage="Single"):
        B.mb_compose_tiled(80, 240, 3, boxes, _feed(boxes, frames), CPU,
                           tile=64, on_rows=lambda y0, y1, r: rows.append(
                               (y0, y1)), fetch_packed=packed)
    recs = log.new()
    tiles, _ = B.mb_tile_grid(80, 240, B.tiled_bands(80, 240, 3, 64), 64)
    feeds = [r for r in recs if r["msg"] == "tile feed done"]
    fetches = [r for r in recs if r["msg"] == "tile fetch done"]
    outs = [r for r in recs if r["msg"] == "rows out done"]
    fed = [sum(not (fx1 <= t[6] or fx0 >= t[7] or fy1 <= t[4]
                    or fy0 >= t[5]) for fx0, fy0, fx1, fy1 in boxes)
           for t in tiles]
    assert [r["frames"] for r in feeds] == [k for k in fed if k]
    assert len(fetches) == len(feeds) and len(outs) == len(rows)
    want = 0
    for (cy0, cy1, cx0, cx1, ey0, ey1, ex0, ex1), k in zip(tiles, fed):
        core = (cy0 - ey0, cy1 - ey0, cx0 - ex0, cx1 - ex0)
        pack = B._packed_window(core, ey1 - ey0, ex1 - ex0) \
            if packed and k else None
        want += 0 if not k else (pack[2] * pack[3] * 3 // 2 if pack
                                 else (cy1 - cy0) * (cx1 - cx0) * 3)
    assert sum(r["bytes"] for r in fetches) == want
    for r in recs[:-1]:
        assert (r["stage"], r["parent"]) == ("Single", "tiled blend done")
    # a device-assembled canvas fetches nothing
    n0 = len(log.new())
    B.mb_compose_tiled(80, 240, 3, boxes, _feed(boxes, frames), CPU,
                       tile=64, assemble="device")
    assert not [r for r in log.new()[n0:] if r["msg"] == "tile fetch done"]


def test_grouping_spans(log, monkeypatch):
    """detect (with frames), register+fetch and segment records under the
    VisualGroup stage, children of the caller's grouping stage."""
    n, step = 6, 300.0

    def detect(images, n_feats, mpx, device=None, store=None,
               indices=None):
        return None, 1.0

    def register(feats, pairs, ratio, thresh, seed=0):
        pa = np.asarray(pairs, np.int64)
        model = torch.eye(3).repeat(len(pa), 1, 1)
        model[:, 0, 2] = torch.from_numpy(
            -step * (pa[:, 1] - pa[:, 0])).float()
        k = len(pa)
        return PairGraph(pairs=pa, model=model,
                         n_good=torch.full((k,), 200),
                         n_inliers=torch.full((k,), 180),
                         conf=torch.ones(k), ok=torch.ones(k, dtype=bool),
                         pts_a=None, pts_b=None, w=None)

    monkeypatch.setattr(FG, "detect_features", detect)
    monkeypatch.setattr(FG, "register_pairs", register)
    images = [np.zeros((64, 64, 3), np.uint8)] * n
    with log.span("grouping", stage="Main"):
        groups = FG.group_boustrophedon(images, [str(k) for k in range(n)],
                                        StitchTuning(), device=CPU)
    assert [g.indices for g in groups] == [list(range(n))]
    recs = [r for r in log.new() if "seconds" in r]
    by = {}
    for r in recs:
        by.setdefault(r["msg"], []).append(r)
    assert [r["frames"] for r in by["detect done"]] == [n]
    assert len(by["register+fetch done"]) == 1
    assert len(by["segment done"]) == 3
    for r in recs[:-1]:
        assert (r["stage"], r["parent"]) == ("VisualGroup", "grouping done")


def test_device_trace_holds_the_spans_on_the_profiler_clock(log, tmp_path):
    a = torch.randn(256, 256)
    with L.device_trace(str(tmp_path)):
        with log.span("matmul", stage="T", n=1):
            time.sleep(0.001)
            (a @ a).sum()
    path, = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    events = json.load(open(path))["traceEvents"]
    span, = [e for e in events if e.get("cat") == "program span"]
    assert span["name"] == "T matmul" and span["args"]["n"] == 1
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm
    for e in mm:
        assert span["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= span["ts"] + span["dur"] + 1.0
    # nothing is traced or written without a directory
    with L.device_trace(None):
        pass
    assert len(os.listdir(tmp_path)) == 1
