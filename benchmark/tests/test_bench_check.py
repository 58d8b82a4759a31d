"""The check that decides ``correct``, driven through a whole run of a
cell at a cut size on the CPU (the harness's look for a card skipped, the
kernels' plain versions), with the timed path broken underneath: each
fault the cell can have must read ``correct`` false, and the run
without one true. A fault on one card has no exchange between cards to
leave out, and no state that a step could leave unchanged; what a cell
can have is an answer altered where it is produced, and half of its
work left out.

The cells' own limits are set at their own sizes (``limits/``); at the
cut sizes here the readings differ, so these runs carry limits of their
own, set from a sound run at the cut size."""

import numpy as np
import pytest
import torch

from mosaicbench import harness as H

CPU = torch.device("cpu")
SEED = 2**35 + 11
TRIAGE = {"config": {"frame_h": 540, "frame_w": 960, "frames": 3,
                     "sift_features": 300, "reg_mpx": 0.1129},
          "traffic": {"batches": 2, "warmup_rounds": 1},
          "limits": {"model_px": 0.5, "sum_rel": 1e-6}}
TINY = {"config": {"frame_h": 160, "frame_w": 208, "frames_per_line": 5},
        "traffic": {"warmup": False}}
SORTIE_LIMITS = {"mosaic_rmse": 10.0, "mosaic_block_rmse": 25.0,
                 "mosaic_uncovered": 2.0, "mosaic_size_px": 8}
AREA_LIMITS = {**SORTIE_LIMITS, "lines_off": 0, "strip_rmse": 10.0,
               "strip_block_rmse": 25.0, "strip_uncovered": 2.0,
               "strip_size_px": 8}


def _run(cell, overrides, patch=None):
    ov = dict(overrides)
    if patch is not None:
        ov["patch"] = patch
    res, _ = H.run_cell(cell, SEED, 0.0, 0, CPU, ov)
    # the five keys, then the numbers compared beside their limits
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    return res


def test_triage_sound_run_is_correct():
    res = _run("triage-8x4k", TRIAGE)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"frames_per_s", "batch_p95_ms",
                                   "setup_s"}


def _altered_sum(kind):
    real = kind.warp_sums
    kind.warp_sums = lambda f, m: real(f, m) * 1.001


def _half_left_out(kind):
    real = kind.warp_sums

    def half(f, m):
        k = m.shape[0] // 2 or 1
        return torch.cat([real(f[:k + 1], m[:k]),
                          torch.zeros(m.shape[0] - k, dtype=torch.float32)])
    kind.warp_sums = half


@pytest.mark.parametrize("fault", [_altered_sum, _half_left_out])
def test_triage_faults_read_incorrect(fault):
    assert not _run("triage-8x4k", TRIAGE, fault)["correct"]


def test_triage_altered_model_reads_incorrect(monkeypatch):
    from drone_image_stitch_cpp_tpu_torch.tools import bench_throughput
    real = bench_throughput.register

    def register(feats, banks):
        res, good = real(feats, banks)
        m = res.model.clone()
        m[-1, 0, 2] += 2.0
        return res._replace(model=m), good
    monkeypatch.setattr(bench_throughput, "register", register)
    res = _run("triage-8x4k", TRIAGE)
    assert not res["correct"] and res["checks"]["model_px"]["value"] > 1.9


def test_triage_control_reads_incorrect():
    from mosaicbench.controls import controls_for
    res = _run("triage-8x4k", TRIAGE,
               controls_for("triage-8x4k")["bf16_warp"])
    assert not res["correct"]
    assert res["checks"]["sum_rel"]["value"] > 10 * 1e-7


@pytest.fixture
def app():
    from drone_image_stitch_cpp_tpu_torch import app
    return app


def test_corridor_sound_and_altered(app, monkeypatch):
    ov = {**TINY, "limits": SORTIE_LIMITS}
    assert _run("corridor-1x20-4k", ov)["correct"]
    real = app.write_image

    def altered(path, img):
        img = img.copy()
        h, w = img.shape[:2]
        img[h // 2 - 20:h // 2 + 20, w // 2 - 20:w // 2 + 20] = 255
        real(path, img)
    monkeypatch.setattr(app, "write_image", altered)
    res = _run("corridor-1x20-4k", ov)
    assert not res["correct"]
    assert res["checks"]["mosaic_block_rmse"]["value"] > 25.0


def _first_half(app, monkeypatch):
    real = app.scan_with_ids

    def half(folder):
        paths, ids = real(folder)
        return paths[:len(paths) // 2], ids[:len(ids) // 2]
    monkeypatch.setattr(app, "scan_with_ids", half)


def test_corridor_half_left_out(app, monkeypatch):
    _first_half(app, monkeypatch)
    res = _run("corridor-1x20-4k", {**TINY, "limits": SORTIE_LIMITS})
    assert not res["correct"]
    assert res["checks"]["mosaic_size_px"]["value"] > 8


def test_area_sound_and_half_left_out(app, monkeypatch):
    ov = {**TINY, "traffic": {**TINY["traffic"], "lines": 2},
          "limits": AREA_LIMITS}
    sound = _run("area-3x20-4k", ov)
    assert sound["correct"], sound["checks"]
    _first_half(app, monkeypatch)
    res = _run("area-3x20-4k", ov)
    assert not res["correct"]
    assert res["checks"]["lines_off"]["value"] >= 1


def test_numbers_of_identical_outputs_are_scored_once():
    from mosaicbench import reference as R
    assert R.worst_of([{"a": 1.0, "b": 3.0}, {"a": 2.0, "b": 1.0}]) == {
        "a": 2.0, "b": 3.0}
    assert np.isclose(R.model_error_px(
        [R.planted_model(100, 200, 50, 100, 4, 8)],
        R.planted_model(100, 200, 50, 100, 4, 8), 50, 100), 0.0)
