"""Application entry point: load -> group -> strips -> global -> crop ->
write.

Port of ``drone_image_stitch_cpp_tpu/app.py::run_stitch_application``
(runStitchApplication, stitch_app.cpp:146-271). The run splits into a host
part (:func:`run_stitch_application`: scan, decode, write) and a device
part (:func:`stitch_frames`: frame store, grouping, one strip stitch per
flight line with each panorama kept on the device, the global inter-strip
stage, and the crop from the blend's device content flags). One group
takes the single-strip path (stitch_app.cpp:246-260).

Not ported yet: strip checkpoints and resume, the per-strip JPEGs and the
background writer, the streamed mosaic write, the streaming decode,
undistortion and the degrade-to-CPU ladder (a fault on the card is an
error, never a silent CPU re-run).
"""

from __future__ import annotations

import os
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config.tuning import StitchTuning, load_stitch_tuning, tuning_as_dict
from .grouping.flight_grouper import VisualStripGroup, group_boustrophedon
from .ops.crop import auto_crop_black_border
from .pipeline.global_ import stitch_inter_strips_custom
from .pipeline.strip import stitch_strip
from .runtime.device import describe_device, device_sync, resolve_device
from .runtime.feed import FrameStore
from .runtime.handoff import DeviceStrip
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
    panorama: np.ndarray                  # (H, W, 3) uint8 BGR, cropped
    groups: List[VisualStripGroup]
    strip_kept: List[List[int]]           # per strip: input frame indices
    strip_transforms: List[np.ndarray]    # per strip: (n_kept, 2, 3)
    #                                       frame -> the strip's first frame
    global_transforms: List[np.ndarray]   # per strip: (3, 3) oriented
    #                                       strip panorama -> strip 0's
    flipped: List[bool]                   # per strip: mirrored to align
    seam_methods: Dict[Tuple[int, int], str] = field(default_factory=dict)

    @property
    def kept(self) -> List[int]:
        """The first strip's kept frames (all of a single-line sortie)."""
        return self.strip_kept[0]

    @property
    def transforms(self) -> np.ndarray:
        return self.strip_transforms[0]


def make_strip_tags(strip_idx: int, ids: List[str]) -> List[str]:
    """Reference: makeStripTags (stitch_app.cpp:131-142)."""
    return [f"S{strip_idx}:{i}" for i in ids]


def global_tuning(tuning: StitchTuning) -> StitchTuning:
    """The global stage's overrides (stitch_app.cpp:227-239)."""
    return tuning.replace(sift_features=tuning.global_sift_features,
                          use_range_matcher=False,
                          blend_bands=max(5, tuning.blend_bands))


def stitch_frames(images: List[np.ndarray], ids: List[str],
                  tuning: StitchTuning, device) -> StitchResult:
    """Group and stitch same-size BGR uint8 frames on ``device``.

    One flight line: one strip stitch. Several: one strip stitch per line
    (each panorama kept on the device when its canvas is tiled), then the
    global inter-strip stage. Raises DeviceUnavailableError when
    ``device`` names a card that is not there, StripStitchError or
    GlobalStitchError when a stage fails.
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
    strip_tuning = tuning.replace(sift_features=tuning.strip_sift_features)
    if len(groups) == 1:
        flat_idx = [k for g in groups for k in g.indices]
        info: dict = {}
        with log.timer("Main", "single-group stitch", sync=sync):
            pano = stitch_strip(
                None, strip_tuning, stage="Single",
                range_width_override=tuning.range_width, device=dev,
                store=store, indices=flat_idx, info=info)
        return StitchResult(
            panorama=auto_crop_black_border(pano), groups=groups,
            strip_kept=[[flat_idx[k] for k in info["kept"]]],
            strip_transforms=[np.asarray(info["transforms"])],
            global_transforms=[np.eye(3, dtype=np.float32)], flipped=[False])

    strips, strip_kept, strip_tf = [], [], []
    for gi, g in enumerate(groups):
        info = {}
        with log.timer(f"Strip{gi}", "stitch", sync=sync):
            pano = stitch_strip(
                None, strip_tuning, stage=f"Strip{gi}",
                range_width_override=tuning.range_width,
                image_tags=make_strip_tags(gi, g.ids), device=dev,
                store=store, indices=list(g.indices), info=info,
                return_device=True)
        if not isinstance(pano, DeviceStrip):
            # a one-frame line comes back as the raw frame (composed host
            # strips are cropped already: the check is then O(perimeter))
            pano = auto_crop_black_border(pano)
        strips.append(pano)
        strip_kept.append([g.indices[k] for k in info["kept"]])
        strip_tf.append(np.asarray(info["transforms"]))
    store.clear()   # frames are done: free the memory for the global canvas
    ginfo: dict = {}
    with log.timer("Main", "global compose", sync=sync):
        mosaic = stitch_inter_strips_custom(strips, global_tuning(tuning),
                                            device=dev, info=ginfo)
    return StitchResult(
        panorama=mosaic, groups=groups, strip_kept=strip_kept,
        strip_transforms=strip_tf, global_transforms=ginfo["transforms"], flipped=ginfo["flipped"],
        seam_methods=ginfo["seam_methods"])


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
