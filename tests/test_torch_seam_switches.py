"""The global stage's two seam switches: the port's keywords
(``stitch_inter_strips_custom(seam_warp=, seam_method=)``, the
``RunConfig`` fields, ``stitch_frames`` and ``tools/bench_sortie``'s
flags) against the JAX package's ``TM_SEAM_WARP`` / ``TM_SEAM_METHOD``
on the CPU.

Both packages take the same strips, and the seam canvas's megapixel
budget (``_SEAM_CANVAS_MP``, 8 MP) is lowered in both so that the small
canvas is warped to the seam scale at a minification (about 0.5), where
the two seam warps differ. The port's global alignment runs and is held
near JAX's, then hands on JAX's strip transforms: the two detects differ
(JAX pads its detect image to a shape bucket), and a 0.2 px difference in
the transform can move the canvas origin by a pixel, which moves the seam
canvas by half a seam pixel and every seam label with it.

Tolerances: the two-strip test's (mosaics within 2 px and a blurred RMSE
of 3 between the packages, 8 against ground truth); the seam-scale images
within 0.05 levels (the gains agree to 1e-4 relative), their content
masks on 99.9% of the canvas and the seam labels on
>= 99.5% of the pair's overlap (the graph cut's coarse level is resized
without cv2); the full-resolution seam warp within 1e-3 of JAX's gather
with the thresholded content mask equal.
"""

import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, n, small_tunings, t

from drone_image_stitch_cpp_tpu.ops import color as JC
from drone_image_stitch_cpp_tpu.ops import seam as JS
from drone_image_stitch_cpp_tpu.ops.crop import (
    auto_crop_black_border as jcrop)
from drone_image_stitch_cpp_tpu.ops.warp import (warp_affine as jwarp,
                                                 warp_content_mask as jcmask)
from drone_image_stitch_cpp_tpu.pipeline import global_ as JG
from drone_image_stitch_cpp_tpu.utils.synthetic import render_sortie
from drone_image_stitch_cpp_tpu_torch import app as A
from drone_image_stitch_cpp_tpu_torch.app import RunConfig
from drone_image_stitch_cpp_tpu_torch.ops import seam as TS
from drone_image_stitch_cpp_tpu_torch.pipeline import global_ as TG
from drone_image_stitch_cpp_tpu_torch.runtime.checkpoint import (
    save_strip_checkpoint)
from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
from drone_image_stitch_cpp_tpu_torch.tools import bench_sortie as PB
from drone_image_stitch_cpp_tpu_torch.tools import sortie_bench as PS
from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

SEAM_MP = 0.03      # a seam scale of ~0.52 on the two strips' canvas
OVERRIDES = dict(sift_features=512, strip_sift_features=512,
                 global_sift_features=768, registration_resol_mpx=-1.0,
                 seam_estimation_resol_mpx=-1.0, blend_bands=3)


def _strips(ortho):
    return (ortho[40:200, 40:500].astype(np.uint8),
            ortho[120:280, 40:500].astype(np.uint8))


def _record_seams(monkeypatch):
    """Record both packages' seam inputs and outputs, and the method that
    cut each of JAX's pairs (its graph cut, or the DP seam where the cut
    returned None or was not asked for)."""
    seen = {"jax_methods": []}
    t_real, j_real = TS.find_seams_sequential, JS.find_seams_sequential
    gc_real, dp_real = JS.graphcut_pairwise_seam, JS.pairwise_seam

    def port(imgs, masks, axes, method="dp", methods=None):
        seen["port_in"] = [n(m).copy() for m in masks]
        seen["port_imgs"] = [n(im).copy() for im in imgs]
        out = t_real(imgs, masks, axes, method=method, methods=methods)
        seen["port_out"] = [n(m).copy() for m in out]
        return out

    def jax_(images, masks, axes=None, method="dp"):
        seen["jax_in"] = [np.asarray(m).copy() for m in masks]
        seen["jax_imgs"] = [np.asarray(im).copy() for im in images]
        seen["in_jax_global"] = True
        try:
            out = j_real(images, masks, axes, method=method)
        finally:
            seen["in_jax_global"] = False
        seen["jax_out"] = [np.asarray(m).copy() for m in out]
        return out

    def gc(*a, **k):
        got = gc_real(*a, **k)
        if seen.get("in_jax_global") and got is not None:
            seen["jax_methods"].append("graphcut")
        return got

    def dp(*a, **k):
        # a horizontal seam calls pairwise_seam again, transposed
        if seen.get("in_jax_global") and not seen.get("in_dp"):
            seen["jax_methods"].append("dp")
        seen["in_dp"] = True
        try:
            return dp_real(*a, **k)
        finally:
            seen["in_dp"] = False

    monkeypatch.setattr(TS, "find_seams_sequential", port)
    monkeypatch.setattr(JS, "find_seams_sequential", jax_)
    monkeypatch.setattr(JS, "graphcut_pairwise_seam", gc)
    monkeypatch.setattr(JS, "pairwise_seam", dp)
    return seen


# ---- (1), (2) stitch_inter_strips_custom against JAX's env switches -------

@pytest.mark.parametrize("seam_warp,seam_method,env", [
    ("fullres", "graphcut", {"TM_SEAM_WARP": "fullres"}),
    ("prescaled", "dp", {"TM_SEAM_METHOD": "dp"}),
])
def test_seam_switches_two_strips_match_jax(ortho, monkeypatch, seam_warp,
                                            seam_method, env):
    jt, tt = small_tunings()
    strip_a, strip_b = _strips(ortho)
    monkeypatch.setattr(JG, "_SEAM_CANVAS_MP", SEAM_MP)
    monkeypatch.setattr(TG, "_SEAM_CANVAS_MP", SEAM_MP)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = _record_seams(monkeypatch)
    j_align, t_align = JG._align_strips_dev, TG._align_strips_dev

    def jax_align(*a, **k):
        out = j_align(*a, **k)
        seen["jax_transforms"] = [np.asarray(m) for m in out[0]]
        return out

    def port_align(*a, **k):
        transforms, oriented, flipped = t_align(*a, **k)
        seen["port_transforms"] = transforms
        return list(seen["jax_transforms"]), oriented, flipped

    monkeypatch.setattr(JG, "_align_strips_dev", jax_align)
    monkeypatch.setattr(TG, "_align_strips_dev", port_align)
    mj = jcrop(JG.stitch_inter_strips_custom([strip_a, strip_b], jt))
    log = get_logger()
    n0 = len(log._records)
    info = {}
    mt = TG.stitch_inter_strips_custom([strip_a, strip_b], tt, device=CPU,
                                       info=info, seam_warp=seam_warp,
                                       seam_method=seam_method)
    recs = log._records[n0:]
    own, ref = seen["port_transforms"][1], seen["jax_transforms"][1]
    np.testing.assert_allclose(own[:2, 2], ref[:2, 2], atol=0.5)
    np.testing.assert_allclose(own[:2, :2], ref[:2, :2], atol=5e-3)

    assert [(r["warp"], r["method"]) for r in recs
            if r["msg"] == "seam"] == [(seam_warp, seam_method)]
    scale = next(r for r in recs if r["msg"] == "seam scale")["scale"]
    assert 0.4 < scale < 0.6
    assert info["seam_methods"] == {(0, 1): seam_method}
    assert seen["jax_methods"] == [seam_method]
    assert info["flipped"] == [False, False]
    assert abs(mt.shape[0] - mj.shape[0]) <= 2
    assert abs(mt.shape[1] - mj.shape[1]) <= 2
    assert gt_rmse(mt, mj, search=3)[0] < 3.0
    gt = ortho[40:280, 40:500].astype(np.uint8)
    assert gt_rmse(mt, gt, search=3)[0] < 8.0
    # the seam-scale images (gains applied) and content masks, then strip
    # 0's seam label over the pair's overlap
    (pa, pb), (ja, jb) = seen["port_in"], seen["jax_in"]
    assert pa.shape == ja.shape
    assert float((pa == ja).mean()) >= 0.999
    for pim, jim in zip(seen["port_imgs"], seen["jax_imgs"]):
        np.testing.assert_allclose(pim, jim, atol=0.05)
    overlap = (pa & pb) | (ja & jb)
    assert overlap.sum() > 500
    agree = float((seen["port_out"][0][overlap]
                   == seen["jax_out"][0][overlap]).mean())
    assert agree >= 0.995, agree


# ---- (4) the full-resolution seam warp on the CPU ---------------------------

def _padded_strip(seed=3, h=300, w=1100, hp=512, wp=1536):
    """A textured uint8 strip padded with black to (hp, wp), with runs of
    pixels whose gray is just below, at and above the content threshold."""
    r = np.random.default_rng(seed)
    img = np.zeros((hp, wp, 3), np.uint8)
    img[:h, :w] = r.integers(0, 256, (h, w, 3))
    for k, px in enumerate([(2, 2, 2), (3, 3, 3), (2, 3, 2), (1, 2, 3),
                            (17, 0, 0), (18, 0, 0), (0, 0, 0)]):
        img[20 + 30 * k:40 + 30 * k, 100:700] = px
    return img


@pytest.mark.parametrize("scale,out_hw", [(0.1433, (75, 221)),
                                          (0.52, (157, 571))])
def test_to_seam_fullres_matches_jax(scale, out_hw):
    img = _padded_strip()
    th = np.radians(0.4)
    t_seam = (np.diag([scale, scale]).astype(np.float32) @ np.asarray(
        [[np.cos(th), -np.sin(th), 3.7], [np.sin(th), np.cos(th), 11.2]],
        np.float32)).astype(np.float32)
    sh, sw = out_hw
    simg, smask = TG._to_seam_fullres(t(img), t_seam, sh, sw)
    img32 = jnp.asarray(img.astype(np.float32))
    wj = jwarp(img32, jnp.asarray(t_seam), sh, sw)
    mj = jcmask(JC.nonblack_mask(img32, 2.0), jnp.asarray(t_seam), sh, sw,
                footprint_thresh=0.999)
    assert simg.dtype == torch.float32 and smask.dtype == torch.bool
    np.testing.assert_allclose(n(simg), np.asarray(wj), atol=1e-3)
    np.testing.assert_array_equal(n(smask), np.asarray(mj))
    assert 0.2 < float(n(smask).mean()) < 0.9


# ---- (3) the app: stitch_frames and both branches of the run ----------------

def test_stitch_frames_takes_both_switches(ortho):
    imgs, ids, pos = render_sortie(ortho, 2, 4, frame_h=160, frame_w=208,
                                   overlap=0.7, overlap_y=0.3)
    _, tt = small_tunings()
    log = get_logger()
    n0 = len(log._records)
    res = A.stitch_frames(imgs, ids, tt, "cpu", seam_warp="fullres",
                          seam_method="dp")
    recs = log._records[n0:]
    assert [(r["warp"], r["method"]) for r in recs
            if r["msg"] == "seam"] == [("fullres", "dp")]
    assert res.seam_methods == {(0, 1): "dp"}
    assert res.flipped == [False, False]
    step_y = pos[4][0] - pos[0][0]
    np.testing.assert_allclose(res.global_transforms[1][:2, 2],
                               [0.0, step_y], atol=2.0)
    h = step_y + 160
    w = 208 + 3 * (pos[1][1] - pos[0][1])
    assert abs(res.panorama.shape[0] - h) <= 4
    assert abs(res.panorama.shape[1] - w) <= 4
    gt = ortho[40:40 + h, 40:40 + w].astype(np.uint8)
    assert gt_rmse(res.panorama, gt, search=4)[0] < 8.0


class _Stop(Exception):
    """Ends a run at a stubbed stage."""


@pytest.mark.parametrize("branch", ["stream", "resume"])
def test_run_config_seam_switches_reach_the_global_stage(
        ortho, tmp_path, monkeypatch, branch):
    """``RunConfig.seam_warp`` / ``seam_method`` on both branches of
    ``run_stitch_application``: the straight run hands them to
    ``stitch_frames`` (stubbed here), and ``--resume`` runs the global
    stage from a strip checkpoint with them."""
    root = tmp_path / "in"
    cfg = RunConfig(image_folder=str(root), image_type="visible",
                    group="run", output_root=str(tmp_path / "out"),
                    device="cpu", tuning_overrides=OVERRIDES,
                    resume=branch == "resume", seam_warp="fullres",
                    seam_method="dp")
    log = get_logger()
    n0 = len(log._records)
    if branch == "stream":
        os.makedirs(cfg.input_dir)
        for k, strip in enumerate(_strips(ortho)):
            cv2.imwrite(os.path.join(cfg.input_dir, f"IMG{k:03d}_x.jpg"),
                        strip[:, :208])
        seen = {}

        def frames_stage(images, ids, tuning, devices, **kw):
            seen.update(kw)
            raise _Stop

        monkeypatch.setattr(A, "stitch_frames", frames_stage)
        assert A.run_stitch_application(cfg) == 1
        assert (seen["seam_warp"], seen["seam_method"]) == ("fullres", "dp")
        return
    save_strip_checkpoint(cfg.strips_dir, list(_strips(ortho)))
    assert A.run_stitch_application(cfg) == 0
    recs = log._records[n0:]
    msgs = [(r["stage"], r["msg"]) for r in recs]
    assert ("Main", "resuming global stage from checkpoint") in msgs
    assert [(r["warp"], r["method"]) for r in recs
            if r["msg"] == "seam"] == [("fullres", "dp")]
    assert next(r for r in recs if r["msg"] == "seam methods")["0-1"] \
        == "dp"
    mosaic = cv2.imread(cfg.output_path)
    gt = ortho[40:280, 40:500].astype(np.uint8)
    assert mosaic is not None and gt_rmse(mosaic, gt, search=3)[0] < 8.0


# ---- (5) bad values; bench_sortie's flags; the per-line GT-RMSE ------------

def test_bad_seam_switch_values_raise(ortho):
    _, tt = small_tunings()
    strips = list(_strips(ortho))
    for kw in ({"seam_warp": "full"}, {"seam_method": "graphcut+dp"},
               {"seam_warp": None}):
        with pytest.raises(ValueError):
            TG.stitch_inter_strips_custom(strips, tt, device=CPU, **kw)
        with pytest.raises(ValueError):
            A.stitch_frames(None, [], tt, "cpu", **kw)


def test_bench_sortie_flags_reach_measure_run(tmp_path, monkeypatch):
    meta = {"rows": 3, "cols": 2, "frame_h": 40, "frame_w": 60,
            "overlap": 0.7, "overlap_y": 0.35, "seed": 11, "jpeg_q": 92}
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    np.save(tmp_path / "gt.npy", np.zeros((92, 78, 3), np.uint8))
    monkeypatch.setattr(PB, "make_sortie", lambda root, **kw: (
        root, os.path.join(root, "gt.npy")))
    seen = []

    def measure(root, gt, device, label, **kw):
        seen.append(kw)
        run = dict(label=label, secs=1.0, gt_rmse=2.0, peak_device_gib=None,
                   ru_maxrss_gib=0.1, mosaic_hw=[92, 78])
        return run, np.zeros((92, 78, 3), np.uint8), []

    monkeypatch.setattr(PB, "measure_run", measure)
    lines = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: lines.append(
        " ".join(map(str, a))))
    assert PB.main(["--work", str(tmp_path), "--device", "cpu",
                    "--seam-warp", "fullres", "--seam-method", "dp"]) == 0
    assert PB.main(["--work", str(tmp_path), "--device", "cpu"]) == 0
    monkeypatch.undo()
    rows = [(0, 40), (26, 66), (52, 92)]
    assert seen == [dict(ingest_fmt="auto", fetch_packed=False,
                         seam_warp=w, seam_method=m, lines=rows)
                    for w, m in (("fullres", "dp"),
                                 ("prescaled", "graphcut"))]
    outs = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [(o["seam_warp"], o["seam_method"]) for o in outs] == [
        ("fullres", "dp"), ("prescaled", "graphcut")]
    with pytest.raises(SystemExit):
        PB.main(["--work", str(tmp_path), "--seam-method", "multiband"])


def test_gt_rmse_rows_agree_with_gt_rmse():
    r = np.random.default_rng(4)
    gt = r.integers(20, 236, (120, 160, 3)).astype(np.uint8)
    mosaic = np.clip(gt.astype(np.int16) + r.integers(-6, 7, gt.shape),
                     0, 255).astype(np.uint8)
    mosaic[70:] = np.clip(mosaic[70:].astype(np.int16) + 20, 0, 255)
    whole = PS.gt_rmse(mosaic, gt)
    got = PS.gt_rmse_rows(mosaic, gt, rows=[(0, 120), (0, 60), (80, 120),
                                            (0, 3)])
    assert got[:3] == whole
    assert got[3][0] == whole[0]
    assert got[3][1] < whole[0] < got[3][2]
    assert got[3][3] == float("inf")      # under 1000 common pixels
