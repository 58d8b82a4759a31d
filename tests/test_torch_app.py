"""The port's production run (``app.run_stitch_application``) on the CPU:
streaming ingest, strip JPEGs and the checkpoint from the background
writer, the streamed mosaic write, ``--resume``, the eager-loader
recovery and the exit codes. A 2 x 3 sortie of 160x208 JPEGs (the JAX
package's tests/test_app.py sortie), the tiled compose forced with
``TILED_THRESHOLD_BYTES = 1`` so strips flow as ``DeviceStrip`` and the
global stage streams its row bands.

Tolerances: the resumed mosaic equals the straight run's byte for byte;
the written mosaic is within 10 of the ground-truth ortho in blurred RMSE
(two JPEG generations on a sortie whose two lines align on 13 inliers
with a 1.4% scale: stitch_frames on the raw frames scores 5.35 here).
"""

import os
import shutil

import cv2
import numpy as np
import pytest

from torch_port_helpers import small_tunings  # noqa: F401  (torch threads)

from drone_image_stitch_cpp_tpu.utils.synthetic import render_sortie
from drone_image_stitch_cpp_tpu_torch.app import (RunConfig,
                                                  run_stitch_application)
from drone_image_stitch_cpp_tpu_torch.cli.main import build_parser
from drone_image_stitch_cpp_tpu_torch.ops import blend as TB
from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
from drone_image_stitch_cpp_tpu_torch.utils.synthetic import gt_rmse

_OVERRIDES = dict(sift_features=512, strip_sift_features=512,
                  global_sift_features=768, registration_resol_mpx=-1.0,
                  seam_estimation_resol_mpx=-1.0, blend_bands=3)


@pytest.fixture(scope="module")
def sortie(ortho, tmp_path_factory):
    imgs, _, pos = render_sortie(ortho, 2, 3, frame_h=160, frame_w=208,
                                 overlap=0.7, overlap_y=0.3)
    root = tmp_path_factory.mktemp("sortie")
    d = root / "visible" / "run"
    os.makedirs(d)
    for k, img in enumerate(imgs):
        cv2.imwrite(str(d / f"IMG{k:03d}_x.jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 97])
    return str(root), pos


def _cfg(root, out, **kw):
    return RunConfig(image_folder=root, image_type="visible", group="run",
                     output_root=out, device="cpu",
                     tuning_overrides=_OVERRIDES, **kw)


def _run(cfg):
    """(rc, log records of the run)."""
    log = get_logger()
    n0 = len(log._records)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TB, "TILED_THRESHOLD_BYTES", 1)
        rc = run_stitch_application(cfg)
    return rc, log._records[n0:]


def _msgs(recs):
    return [(r["stage"], r["msg"]) for r in recs]


@pytest.fixture(scope="module")
def straight(sortie, tmp_path_factory):
    root, _ = sortie
    out = str(tmp_path_factory.mktemp("out"))
    cfg = _cfg(root, out)
    rc, recs = _run(cfg)
    with open(cfg.output_path, "rb") as f:
        data = f.read()
    return cfg, rc, recs, data


def test_app_writes_panorama_strips_and_checkpoint(straight, sortie, ortho):
    cfg, rc, recs, _ = straight
    assert rc == 0
    msgs = _msgs(recs)
    assert ("Main", "streaming ingest") in msgs
    assert ("GlobalCustom", "streaming mosaic write") in msgs
    assert ("GlobalCustom", "streamed mosaic written") in msgs
    assert ("Main", "strip-save drain done") in msgs
    wrote = [r for r in recs if r["msg"] == "wrote"]
    assert wrote and wrote[-1].get("streamed") is True
    strips = os.path.join(cfg.output_dir, "strips")
    assert sorted(os.listdir(strips)) == [
        "checkpoint.json", "strip_00.jpg", "strip_00.npy", "strip_01.jpg",
        "strip_01.npy"]
    for k in range(2):
        jpg = cv2.imread(os.path.join(strips, f"strip_{k:02d}.jpg"))
        npy = np.load(os.path.join(strips, f"strip_{k:02d}.npy"))
        assert jpg.shape == npy.shape
    pano = cv2.imread(cfg.output_path)
    _, pos = sortie
    h = pos[3][0] - pos[0][0] + 160
    w = 208 + 2 * (pos[1][1] - pos[0][1])
    # the streamed crop box: the exact autocrop box plus at most a few
    # seam-scale cells of margin, clipped to the canvas
    assert abs(pano.shape[0] - h) <= 8 and abs(pano.shape[1] - w) <= 8
    assert gt_rmse(pano, ortho[40:40 + h, 40:40 + w].astype(np.uint8),
                   search=8)[0] < 10.0


def test_resume_is_byte_identical(straight):
    cfg, rc, _, data = straight
    assert rc == 0
    cfg2 = RunConfig(**{**cfg.__dict__, "resume": True})
    rc2, recs = _run(cfg2)
    assert rc2 == 0
    msgs = _msgs(recs)
    assert ("Main", "resuming global stage from checkpoint") in msgs
    assert ("Main", "grouping done") not in msgs
    with open(cfg.output_path, "rb") as f:
        assert f.read() == data


@pytest.mark.parametrize("bad", [0, 4])
def test_garbage_file_recovers_through_eager_loader(sortie, tmp_path, bad):
    """Frame 0 unreadable: the streaming store is refused at once (here on
    the first line's three files alone: one group); a later frame: the
    stream fails on first touch and the app reloads (the whole 2 x 3
    sortie, strip JPEGs off)."""
    root, _ = sortie
    dirty = str(tmp_path / "dirty")
    d = os.path.join(dirty, "visible", "run")
    shutil.copytree(os.path.join(root, "visible", "run"), d)
    if bad == 0:
        for k in range(3, 6):
            os.remove(os.path.join(d, f"IMG{k:03d}_x.jpg"))
    with open(os.path.join(d, f"IMG{bad:03d}_x.jpg"), "wb") as f:
        f.write(b"not a jpeg at all")
    cfg = _cfg(dirty, str(tmp_path / "out"), save_strips=False)
    rc, recs = _run(cfg)
    assert rc == 0
    msgs = _msgs(recs)
    want = ("streaming ingest unavailable" if bad == 0
            else "streaming ingest failed; reloading")
    assert ("Main", want) in msgs
    assert [r["n"] for r in recs if r["msg"] == "loaded"] == [
        2 if bad == 0 else 5]
    assert os.path.exists(cfg.output_path)
    if bad:
        strips = os.listdir(os.path.join(cfg.output_dir, "strips"))
        assert "checkpoint.json" in strips
        assert not any(s.endswith(".jpg") for s in strips)


@pytest.mark.parametrize("case", ["missing_folder", "no_card"])
def test_app_fault_exits_1(sortie, tmp_path, case):
    root, _ = sortie
    if case == "missing_folder":
        cfg = _cfg(str(tmp_path / "none"), str(tmp_path / "out"))
    else:
        cfg = RunConfig(**{**_cfg(root, str(tmp_path / "out")).__dict__,
                           "device": "cuda"})
    rc, recs = _run(cfg)
    assert rc == 1
    fatal = [r for r in recs if r["msg"] == "FATAL"]
    assert len(fatal) == 1
    if case == "no_card":
        assert fatal[0]["error"].startswith("DeviceUnavailableError")
        # no CPU carry-on: nothing ran after the device check
        assert _msgs(recs) == [("Main", "FATAL")]
    else:
        assert fatal[0]["error"].startswith("FileNotFoundError")


def test_cli_flags():
    args = build_parser().parse_args(["--no-save-strips", "--resume",
                                      "--device", "cpu"])
    assert args.no_save_strips and args.resume and args.device == "cpu"
    args = build_parser().parse_args([])
    assert not args.no_save_strips and not args.resume
