"""The thermal cell's files: the plain reference ``render_thermal`` (seeded,
its frames crops of the planted truth, nothing of the program or JAX
imported), the ``thermal`` kind, the float32 control applied to it, and
the three readers of strip registration's spans."""

import ast
import os

import cv2
import numpy as np
import pytest

from mosaicbench import controls
from mosaicbench import harness as H
from mosaicbench import render_thermal as RT

KW = dict(rows=2, cols=5, frame_h=64, frame_w=80, overlap=0.9,
          overlap_y=0.6, seed=11, device="cpu")


def _render(tmp_path, name, noise_seed):
    d = tmp_path / name
    gt = RT.render_thermal(str(d), noise_seed=noise_seed,
                           cache_dir=str(tmp_path / "terrain"), **KW)
    return gt, {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def test_render_thermal_is_seeded(tmp_path):
    gt_a, a = _render(tmp_path, "a", 2**33 + 1)
    gt_b, b = _render(tmp_path, "b", 2**33 + 1)
    gt_c, c = _render(tmp_path, "c", 2**33 + 2)
    assert list(a) == [f"IMG{k:04d}_f{k:04d}.jpg" for k in range(10)]
    assert a == b and gt_a.tobytes() == gt_b.tobytes()
    # another seed: the same truth under other sensor noise
    assert gt_c.tobytes() == gt_a.tobytes()
    assert all(a[f] != c[f] for f in a)


def test_noise_free_frames_are_crops_of_the_truth(tmp_path):
    from mosaicbench.render import cached_terrain
    step_y, step_x, gt_h, gt_w, pos = RT.thermal_layout(
        2, 5, 64, 80, 0.9, 0.6)
    assert (step_y, step_x, gt_h, gt_w) == (26, 8, 90, 112)
    assert pos[:2] == [(0, 0), (0, 8)] and pos[5:7] == [(26, 32), (26, 24)]
    truth = RT.thermal_truth(cached_terrain(gt_h, gt_w, 11, "cpu",
                                            str(tmp_path)))
    gt = RT.to_u8(truth)
    assert gt.shape == (gt_h, gt_w, 3)
    assert np.array_equal(gt[..., 0], gt[..., 2])      # white-hot gray
    for y, x in pos:
        f = RT.thermal_frame(truth, y, x, 64, 80)
        assert np.array_equal(f, gt[y:y + 64, x:x + 80])
    noisy = RT.thermal_frame(truth, *pos[3], 64, 80,
                             np.random.default_rng(5))
    d = noisy.astype(float) - gt[pos[3][0]:pos[3][0] + 64,
                                 pos[3][1]:pos[3][1] + 80]
    assert 1.6 < d.std() < 2.4


def test_the_truth_is_the_blurred_scaled_luma():
    terrain = np.random.default_rng(3).uniform(
        0, 255, (40, 50, 3)).astype(np.float32)
    truth = RT.thermal_truth(terrain)
    luma = (0.114 * terrain[..., 0] + 0.587 * terrain[..., 1]
            + 0.299 * terrain[..., 2])
    blurred = cv2.GaussianBlur(luma.astype(np.float32), (0, 0), 1.0)
    want = blurred.mean() + 0.6 * (blurred - blurred.mean())
    np.testing.assert_allclose(truth, want, atol=1e-3)


def test_render_thermal_imports_nothing_of_the_program():
    path = os.path.join(H.BENCH_DIR, "mosaicbench", "render_thermal.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "os", "concurrent", "numpy", "cv2"}
    assert not names & {"drone_image_stitch_cpp_tpu_torch", *H.FORBIDDEN}


def test_thermal_kind_loads_by_name():
    from mosaicbench.kinds.sortie import Sortie
    from mosaicbench.kinds.thermal import Thermal
    assert H.kind_class("thermal") is Thermal
    assert issubclass(Thermal, Sortie)
    cell, config, traffic, *_ = H.load_cell("thermal-3x100-640")
    assert traffic["kind"] == "thermal" and config["image_type"] == "lwir"


def test_float32_control_applies_to_a_thermal_object(monkeypatch):
    from drone_image_stitch_cpp_tpu_torch.pipeline import strip
    from mosaicbench.kinds.thermal import Thermal
    import torch
    monkeypatch.setattr(strip, "bundle_adjust_similarity",
                        strip.bundle_adjust_similarity)
    kind = Thermal.__new__(Thermal)
    controls._sortie_float32_bundle_adjust(kind)
    patched = strip.bundle_adjust_similarity
    assert patched.control and patched.keywords == {"dtype": torch.float32}


def _records(k):
    """One sortie's strip records in the shape the program writes, the
    inner spans' seconds scaled by ``k``."""
    recs = [{"stage": "VisualGroup", "msg": "detect done", "seconds": 9.0,
             "parent": "grouping done", "frames": 60}]
    for stage in ("Strip0", "Strip1", "Strip2"):
        recs += [{"stage": stage, "msg": "detect done", "seconds": 0.5 * k,
                  "parent": "register done", "frames": 20},
                 {"stage": stage, "msg": "pairs done", "seconds": 0.25 * k,
                  "parent": "register done", "pairs": 105, "kept": 100},
                 {"stage": stage, "msg": "bundle adjust done",
                  "seconds": 0.125 * k, "parent": "register done",
                  "frames": 20, "pairs": 100},
                 {"stage": stage, "msg": "register done", "seconds": 1.0}]
    recs += [{"stage": "Strip0/seq1", "msg": "detect done", "seconds": 7.0,
              "frames": 2}]
    return recs


@pytest.mark.parametrize("name,per_k", [
    ("strip_detect_s", 3 * 0.5), ("strip_pairs_s", 3 * 0.25),
    ("strip_bundle_s", 3 * 0.125)])
def test_register_span_metrics_sum_a_sortie(name, per_k):
    read = H.reader(name)
    ctx = H.Context(units=[{"records": _records(1)}])
    assert read(ctx) == pytest.approx(per_k)
    ctx = H.Context(units=[{"records": _records(k)} for k in (1, 3)])
    assert read(ctx) == pytest.approx(2 * per_k)
    single = [dict(r, stage="Single") for r in _records(1)
              if r["stage"] == "Strip0"]
    assert read(H.Context(units=[{"records": single}])) == pytest.approx(
        per_k / 3)


@pytest.mark.parametrize("name", ["strip_detect_s", "strip_pairs_s",
                                  "strip_bundle_s"])
def test_a_program_without_the_register_spans_reads_nothing(name):
    recs = [r for r in _records(1) if r["msg"] == "register done"
            or r["stage"] == "VisualGroup"]
    assert H.reader(name)(H.Context(units=[{"records": recs}])) is None
