"""A thermal (LWIR) survey through the port on the CPU: the upstream's
lwir preset (``load_stitch_tuning("lwir")``: match_conf 0.48, range
width 4, 3 blend bands) on a 2 x 10 sortie of 160x128 frames at 90% /
60% overlap, rendered by the benchmark's thermal reference
(``benchmark/mosaicbench/render_thermal.py``: the seeded terrain's luma,
blurred, contrast 0.6, white-hot, sensor noise of 2 DN a frame). The
full-resolution work sizes of ``small_tunings()`` and its feature
budgets, capped at 256 a frame, keep it fast; the preset's other knobs
stay.

One production run (``run_stitch_application(image_type="lwir")`` from
the JPEGs on disk) serves the module; its ``stitch_frames`` call is
watched for the groups, strip transforms and strip panoramas, which the
JAX package's are compared with on the same JPEGs. Tolerances: the strip transforms within 1.0 px
of the JAX package's on the same frames (test_torch_global's
two-line bound) and the mosaic within 8.0 of the planted truth in
blurred RMSE (test_pipeline.py's bound).
"""

import dataclasses
import os
import sys

import cv2
import numpy as np
import pytest

from torch_port_helpers import small_tunings

from drone_image_stitch_cpp_tpu.config.tuning import (
    load_stitch_tuning as jload_tuning)
from drone_image_stitch_cpp_tpu.grouping.flight_grouper import (
    group_boustrophedon as jgroup)
from drone_image_stitch_cpp_tpu.pipeline.strip import (
    estimate_strip_transforms as jestimate)
from drone_image_stitch_cpp_tpu_torch import app as A
from drone_image_stitch_cpp_tpu_torch.app import (RunConfig,
                                                  run_stitch_application)
from drone_image_stitch_cpp_tpu_torch.config.tuning import (
    load_stitch_tuning, tuning_as_dict)
from drone_image_stitch_cpp_tpu_torch.pipeline.pairgraph import banded_pairs
from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark"))
from mosaicbench.render_thermal import (  # noqa: E402
    render_thermal, thermal_layout)

LINES, COLS, FH, FW = 2, 10, 128, 160
OVERLAP, OVERLAP_Y = 0.9, 0.6
FEATURES = 256      # the feature budgets' cap


def _overrides():
    """small_tunings()'s work sizes and its feature budgets capped at
    ``FEATURES``, nothing else."""
    jt, _ = small_tunings()
    over = {k: min(getattr(jt, k), FEATURES) for k in (
        "sift_features", "strip_sift_features", "global_sift_features")}
    over.update({k: getattr(jt, k) for k in (
        "registration_resol_mpx", "seam_estimation_resol_mpx")})
    return over


@pytest.fixture(scope="module")
def thermal(tmp_path_factory):
    """One production run; its ``stitch_frames`` call is watched for the
    groups, the strip transforms and the panoramas it hands on."""
    root = tmp_path_factory.mktemp("thermal")
    d = root / "lwir" / "minfull"
    gt = render_thermal(str(d), LINES, COLS, FH, FW, OVERLAP, OVERLAP_Y,
                        seed=11, noise_seed=2**33 + 5, device="cpu",
                        cache_dir=str(root / "terrain"))
    names = sorted(os.listdir(d))
    seen = {"strips": []}
    real = A.stitch_frames

    def watched(*args, on_strip=None, **kw):
        def on(gi, pano, last):
            seen["strips"].append(pano)
            on_strip(gi, pano, last)
        seen["tuning"] = args[2]
        seen["res"] = real(*args, on_strip=on, **kw)
        return seen["res"]

    log = get_logger()
    n0 = len(log._records)
    mp = pytest.MonkeyPatch()
    mp.setattr(A, "stitch_frames", watched)
    try:
        rc = run_stitch_application(RunConfig(
            image_folder=str(root), image_type="lwir", group="minfull",
            output_root=str(root / "out"), device="cpu",
            tuning_overrides=_overrides()))
    finally:
        mp.undo()
    mosaic = cv2.imread(str(root / "out" / "lwir" / "minfull"
                            / "lwir_minfull_uav_panorama.jpg"))
    return dict(gt=gt, rc=rc, mosaic=mosaic, records=log._records[n0:],
                frames=[cv2.imread(str(d / f), cv2.IMREAD_COLOR)
                        for f in names],
                ids=[os.path.splitext(f)[0] for f in names], **seen)


def test_thermal_run_logs_the_lwir_preset(thermal):
    assert thermal["rc"] == 0
    logged = [r for r in thermal["records"]
              if r["stage"] == "Main" and r["msg"] == "tuning"]
    assert len(logged) == 1
    knobs = {k: v for k, v in logged[0].items()
             if k not in ("ts", "stage", "msg")}
    assert knobs == tuning_as_dict(thermal["tuning"])
    assert thermal["tuning"] == load_stitch_tuning("lwir").replace(
        **_overrides())
    assert (knobs["match_conf"], knobs["range_width"],
            knobs["blend_bands"]) == (0.48, 4, 3)
    # the preset is the JAX package's, knob for knob
    jt = dataclasses.asdict(jload_tuning("lwir").replace(**_overrides()))
    jt.pop("calibration")
    assert {k: jt[k] for k in knobs} == knobs


def test_thermal_strips_blend_untiled_and_come_back_as_host_arrays(thermal):
    assert len(thermal["strips"]) == LINES
    assert all(isinstance(s, np.ndarray) for s in thermal["strips"])
    msgs = {(r["stage"], r["msg"]) for r in thermal["records"]}
    for gi in range(LINES):
        assert (f"Strip{gi}", "blend done") in msgs
        assert (f"Strip{gi}", "tiled blend done") not in msgs
        assert (f"Strip{gi}", "tiled compose") not in msgs


def test_thermal_groups_and_strip_transforms_match_jax(thermal):
    res, frames, ids = thermal["res"], thermal["frames"], thermal["ids"]
    jt = jload_tuning("lwir").replace(**_overrides())
    gj = jgroup(frames, ids, jt)
    assert [g.indices for g in res.groups] == [g.indices for g in gj]
    assert res.strip_kept == [list(range(COLS)),
                              list(range(COLS, 2 * COLS))]
    strip_jt = jt.replace(sift_features=jt.strip_sift_features)
    for g, tr in zip(gj, res.strip_transforms):
        _, tj, _ = jestimate([frames[k] for k in g.indices], strip_jt,
                             jt.range_width)
        np.testing.assert_allclose(tr[:, :, 2], np.asarray(tj)[:, :, 2],
                                   atol=1.0)


def test_thermal_mosaic_against_the_planted_truth(thermal):
    step_y, step_x, gt_h, gt_w, _ = thermal_layout(
        LINES, COLS, FH, FW, OVERLAP, OVERLAP_Y)
    assert (step_y, step_x) == (51, 16)
    gt = thermal["gt"]
    assert gt.shape == (gt_h, gt_w, 3)
    for mosaic in (thermal["mosaic"], thermal["res"].panorama):
        assert abs(mosaic.shape[0] - gt_h) <= 4
        assert abs(mosaic.shape[1] - gt_w) <= 4
        assert gt_rmse(mosaic, gt, search=4)[0] < 8.0


def test_thermal_register_spans_nest_with_counters(thermal):
    recs = thermal["records"]
    for gi in range(LINES):
        stage = f"Strip{gi}"
        own = {r["msg"]: r for r in recs if r["stage"] == stage}
        det, pairs, ba = (own["detect done"], own["pairs done"],
                          own["bundle adjust done"])
        for r in (det, pairs, ba):
            assert r["parent"] == "register done"
        assert det["frames"] == COLS
        assert pairs["pairs"] == len(banded_pairs(COLS, 4))
        assert 0 < pairs["kept"] <= pairs["pairs"]
        assert ba["frames"] == COLS and 0 < ba["pairs"] <= pairs["kept"]
        inner = det["seconds"] + pairs["seconds"] + ba["seconds"]
        assert inner <= own["register done"]["seconds"]
        # in order, inside the register stage
        assert det["ts"] <= pairs["ts"] - pairs["seconds"] + 1e-3
        assert pairs["ts"] <= ba["ts"] - ba["seconds"] + 1e-3
