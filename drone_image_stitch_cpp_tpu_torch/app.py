"""Application entry point for a single flight line: load -> group ->
strip -> crop -> write.

Port of the single-group path of ``drone_image_stitch_cpp_tpu/app.py::
run_stitch_application`` (runStitchApplication, stitch_app.cpp:146-271,
single-group flatten path :246-260). The run splits into a host part
(:func:`run_stitch_application`: scan, decode, write) and a device part
(:func:`stitch_frames`: frame store, grouping, strip stitch, autocrop).

Not ported yet: the multi-strip global stage (a sortie that groups into
several flight lines raises NotImplementedError), strip checkpoints and
resume, the streaming decode, undistortion and the degrade-to-CPU ladder
(a fault on the card is an error, never a silent CPU re-run).
"""

from __future__ import annotations

import os
import traceback
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .config.tuning import StitchTuning, load_stitch_tuning, tuning_as_dict
from .grouping.flight_grouper import VisualStripGroup, group_boustrophedon
from .ops.crop import auto_crop_black_border
from .pipeline.strip import stitch_strip
from .runtime.device import describe_device, device_sync, resolve_device
from .runtime.feed import FrameStore
from .runtime.loader import load_with_ids
from .runtime.logging import get_logger


@dataclass
class RunConfig:
    """Run parameters (stitch_app.cpp:149-160) plus the device."""

    image_folder: str = "../images"
    image_type: str = "visible"
    group: str = "minfull"
    output_root: str = "../output"
    device: str = "cuda"
    tuning_overrides: dict = field(default_factory=dict)

    @property
    def input_dir(self) -> str:
        return os.path.join(self.image_folder, self.image_type, self.group)

    @property
    def output_dir(self) -> str:
        return os.path.join(self.output_root, self.image_type, self.group)

    @property
    def output_path(self) -> str:
        return os.path.join(
            self.output_dir,
            f"{self.image_type}_{self.group}_uav_panorama.jpg")


@dataclass
class StitchResult:
    panorama: np.ndarray          # (H, W, 3) uint8 BGR, autocropped
    groups: List[VisualStripGroup]
    kept: List[int]               # input frame indices the strip kept
    transforms: np.ndarray        # (len(kept), 2, 3) frame -> kept[0]


def stitch_frames(images: List[np.ndarray], ids: List[str],
                  tuning: StitchTuning, device) -> StitchResult:
    """Group and stitch same-size BGR uint8 frames on ``device``.

    Raises NotImplementedError when grouping finds more than one flight
    line (the global inter-strip stage is not ported yet) and
    DeviceUnavailableError when ``device`` names a card that is not there.
    """
    dev = resolve_device(device)
    log = get_logger()
    sync = device_sync(dev)
    with log.timer("Main", "frame store", sync=sync):
        store = FrameStore(images, dev)
    with log.timer("Main", "grouping", sync=sync):
        groups = group_boustrophedon(None, ids, tuning, device=dev,
                                     store=store)
    log.log("Main", "groups", n=len(groups),
            sizes=[len(g.indices) for g in groups])
    if len(groups) > 1:
        raise NotImplementedError(
            f"grouping found {len(groups)} flight lines; the multi-strip "
            f"global stage (inter-strip alignment, graph-cut seams, global "
            f"compose) is not ported to the PyTorch package yet")
    flat_idx = [k for g in groups for k in g.indices]
    info: dict = {}
    with log.timer("Main", "single-group stitch", sync=sync):
        pano = stitch_strip(
            None, tuning.replace(sift_features=tuning.strip_sift_features),
            stage="Single", range_width_override=tuning.range_width,
            device=dev, store=store, indices=flat_idx, info=info)
    pano = auto_crop_black_border(pano)
    return StitchResult(panorama=pano, groups=groups,
                        kept=[flat_idx[k] for k in info["kept"]],
                        transforms=np.asarray(info["transforms"]))


def write_image(path: str, img: np.ndarray) -> None:
    """JPEG/PNG write through cv2 when present, else the native libjpeg
    encoder; raises when neither is available."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        if not cv2.imwrite(path, img):
            raise RuntimeError(f"failed to write {path}")
        return
    from .utils.native import NativeJpegEncoder, jpeg_encoder_available
    if not jpeg_encoder_available() or not path.lower().endswith(
            (".jpg", ".jpeg")):
        raise RuntimeError(f"no image encoder available to write {path}")
    enc = NativeJpegEncoder(path, img.shape[1], img.shape[0])
    try:
        enc.write(np.ascontiguousarray(img))
        enc.finish()
    except BaseException:
        enc.abort()
        raise


def run_stitch_application(cfg: Optional[RunConfig] = None) -> int:
    """End-to-end run; returns a process exit code like the reference
    (top-level catch -> 1, stitch_app.cpp:265-268)."""
    cfg = cfg or RunConfig()
    log = get_logger()
    try:
        dev = resolve_device(cfg.device)
        tuning = load_stitch_tuning(cfg.image_type)
        if cfg.tuning_overrides:
            tuning = tuning.replace(**cfg.tuning_overrides)
        log.log("Main", "device", **describe_device(dev))
        log.log("Main", "tuning", **tuning_as_dict(tuning))
        with log.timer("Main", "load+decode"):
            loaded = load_with_ids(cfg.input_dir)
        log.log("Main", "loaded", n=len(loaded.images))
        if len(loaded.images) < 2:
            log.log("Main", "need at least 2 images")
            return 1
        result = stitch_frames(loaded.images, loaded.ids, tuning, dev)
        with log.timer("Main", "write"):
            write_image(cfg.output_path, result.panorama)
        log.log("Main", "wrote", path=cfg.output_path,
                h=result.panorama.shape[0], w=result.panorama.shape[1])
        return 0
    except Exception as err:  # top-level catch (stitch_app.cpp:265-268)
        log.log("Main", "FATAL", error=f"{type(err).__name__}: {err}")
        traceback.print_exc()
        return 1
