"""Application entry point: load -> group -> strips -> global -> crop ->
write.

Port of ``drone_image_stitch_cpp_tpu/app.py::run_stitch_application``
(runStitchApplication, stitch_app.cpp:146-271). The run splits into a host
part (:func:`run_stitch_application`: scan, streaming decode, strip saves,
checkpoint and resume, the mosaic write) and a device part
(:func:`stitch_frames`: frame store, grouping, one strip stitch per
flight line with each panorama kept on the device, the global inter-strip
stage, and the crop from the blend's device content flags). One group
takes the single-strip path (stitch_app.cpp:246-260).

Ingest streams by default (``runtime/feed.FrameStore.from_paths``: decode
on a background thread while grouping runs); a frame that does not decode
falls back to the eager loader's skip-unreadable path. Each strip's JPEG
(``strips/strip_XX.jpg``) and then the lossless strip checkpoint are
written by a ``BackgroundWriter`` while the device stitches on;
``RunConfig.resume`` restarts the global stage from that checkpoint. The
global stage streams the mosaic's row bands into the incremental JPEG
encoder when the codec is built (``utils/native``), else the mosaic is
written after the blend.

Not ported: undistortion (the port's tuning carries no calibration) and
the JAX package's degrade-to-CPU ladder: a fault on the card ends the run
with exit 1 and a ``[Main] FATAL`` line, never a silent CPU re-run;
``--resume`` is the recovery.
"""

from __future__ import annotations

import os
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .config.tuning import StitchTuning, load_stitch_tuning, tuning_as_dict
from .grouping.flight_grouper import VisualStripGroup, group_boustrophedon
from .ops.crop import auto_crop_black_border
from .pipeline.global_ import stitch_inter_strips_custom
from .pipeline.strip import stitch_strip
from .runtime.checkpoint import load_strip_checkpoint, save_strip_checkpoint
from .runtime.device import describe_device, device_sync, resolve_device
from .runtime.feed import FrameStore, FrameStoreError
from .runtime.handoff import DeviceStrip, as_host_strips
from .runtime.loader import load_with_ids, scan_with_ids
from .runtime.logging import get_logger
from .runtime.writer import BackgroundWriter, StreamedMosaicWriter
from .utils.native import encode_jpeg_native, jpeg_encoder_available


@dataclass
class RunConfig:
    """Run parameters (stitch_app.cpp:149-160) plus the device."""

    image_folder: str = "../images"
    image_type: str = "visible"
    group: str = "minfull"
    output_root: str = "../output"
    device: str = "cuda"
    save_strips: bool = True      # strips/strip_XX.jpg per flight line
    resume: bool = False          # global stage from the strip checkpoint
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

    @property
    def strips_dir(self) -> str:
        return os.path.join(self.output_dir, "strips")


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


def stitch_frames(images: Optional[List[np.ndarray]], ids: List[str],
                  tuning: StitchTuning, device, store=None,
                  on_strip: Optional[Callable] = None,
                  row_sink=None) -> StitchResult:
    """Group and stitch same-size BGR uint8 frames on ``device``.

    One flight line: one strip stitch. Several: one strip stitch per line
    (each panorama kept on the device when its canvas is tiled), then the
    global inter-strip stage. ``store``: a ``FrameStore`` holding the
    frames (e.g. a streaming one; ``images`` is then None), else one is
    made from ``images``. ``on_strip(gi, pano, last)``: called after each
    strip of a multi-line sortie with its cropped panorama (a host array
    or a :class:`DeviceStrip`), ``last`` on the final strip, before the
    global stage. ``row_sink``: passed to the global stage (streamed
    mosaic write). Raises DeviceUnavailableError when ``device`` names a
    card that is not there, FrameStoreError when a streamed frame does
    not decode, StripStitchError or GlobalStitchError when a stage fails.
    """
    dev = resolve_device(device)
    log = get_logger()
    sync = device_sync(dev)
    if store is None:
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
        if on_strip is not None:
            on_strip(gi, pano, gi == len(groups) - 1)
    store.clear()   # frames are done: free the memory for the global canvas
    ginfo: dict = {}
    with log.timer("Main", "global compose", sync=sync):
        mosaic = stitch_inter_strips_custom(strips, global_tuning(tuning),
                                            device=dev, info=ginfo,
                                            row_sink=row_sink)
    return StitchResult(
        panorama=mosaic, groups=groups, strip_kept=strip_kept,
        strip_transforms=strip_tf, global_transforms=ginfo["transforms"],
        flipped=ginfo["flipped"], seam_methods=ginfo["seam_methods"])


def write_image(path: str, img: np.ndarray) -> None:
    """JPEG/PNG write through cv2 when present, else a JPEG through the
    codec built from native/ (raising with the codec's reason when it is
    not built)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        if not cv2.imwrite(path, img):
            raise RuntimeError(f"failed to write {path}")
        return
    if not path.lower().endswith((".jpg", ".jpeg")):
        raise RuntimeError(f"no encoder for {path} without cv2")
    encode_jpeg_native(path, np.ascontiguousarray(img))


def _save_strip(path: str, pano) -> None:
    """Write one strip JPEG; a DeviceStrip is fetched here, on the writer
    thread, overlapping the next strip's device work."""
    write_image(path, pano.host() if isinstance(pano, DeviceStrip) else pano)


def _eager_frames(cfg: RunConfig, log):
    """The eager loader (skip-unreadable, image_loader.cpp:52-59):
    (images, ids), or None when fewer than 2 frames decode."""
    with log.timer("Main", "load+decode"):
        loaded = load_with_ids(cfg.input_dir)
    log.log("Main", "loaded", n=len(loaded.images))
    if len(loaded.images) < 2:
        log.log("Main", "need at least 2 images")
        return None
    return loaded.images, loaded.ids


def run_stitch_application(cfg: Optional[RunConfig] = None) -> int:
    """End-to-end run; returns a process exit code like the reference
    (top-level catch -> 1, stitch_app.cpp:265-268)."""
    cfg = cfg or RunConfig()
    log = get_logger()
    writer = sink = None
    try:
        dev = resolve_device(cfg.device)
        tuning = load_stitch_tuning(cfg.image_type)
        if cfg.tuning_overrides:
            tuning = tuning.replace(**cfg.tuning_overrides)
        if getattr(tuning, "calibration", None) is not None:
            raise NotImplementedError("undistortion (a camera calibration "
                                      "in the tuning) is not ported")
        os.makedirs(cfg.output_dir, exist_ok=True)
        log.log("Main", "device", **describe_device(dev))
        log.log("Main", "tuning", **tuning_as_dict(tuning))
        if jpeg_encoder_available():
            # the mosaic's row bands stream into the incremental encoder
            # while later tiles blend; otherwise it is written after
            sink = StreamedMosaicWriter(cfg.output_path)

        strips = (load_strip_checkpoint(cfg.strips_dir) if cfg.resume
                  else None)
        if strips is not None:
            log.log("Main", "resuming global stage from checkpoint",
                    strips=len(strips))
            with log.timer("Main", "global compose", sync=device_sync(dev)):
                panorama = stitch_inter_strips_custom(
                    strips, global_tuning(tuning), device=dev,
                    row_sink=sink)
        else:
            with log.timer("Main", "scan"):
                paths, ids = scan_with_ids(cfg.input_dir)
            images = store = None
            if len(paths) >= 2:
                try:
                    store = FrameStore.from_paths(paths, dev)
                    store.shape0    # frame 0 decodes, or FrameStoreError
                    log.log("Main", "streaming ingest", n=len(paths))
                except FrameStoreError as e:
                    log.log("Main", "streaming ingest unavailable",
                            error=str(e))
                    store = None
            if store is None:
                eager = _eager_frames(cfg, log)
                if eager is None:
                    return 1
                images, ids = eager

            # strip JPEGs and the resume checkpoint are written on a worker
            # thread while the device stitches the next strip (the
            # reference writes each strip serially, stitch_app.cpp:215-217);
            # errors resurface at join() below
            writer = BackgroundWriter()
            done: List = []

            def on_strip(gi, pano, last):
                done.append(pano)
                if cfg.save_strips:
                    writer.submit(_save_strip, os.path.join(
                        cfg.strips_dir, f"strip_{gi:02d}.jpg"), pano)
                elif isinstance(pano, DeviceStrip):
                    writer.submit(pano.host)     # prefetch the host copy
                if last:
                    writer.submit(lambda: save_strip_checkpoint(
                        cfg.strips_dir, as_host_strips(done)))

            try:
                result = stitch_frames(images, ids, tuning, dev, store=store,
                                       on_strip=on_strip, row_sink=sink)
            except FrameStoreError as e:
                # an unreadable or mismatched frame: recover with the eager
                # loader (skip-unreadable, image_loader.cpp:52-59)
                log.log("Main", "streaming ingest failed; reloading",
                        error=str(e))
                store = None
                eager = _eager_frames(cfg, log)
                if eager is None:
                    return 1
                images, ids = eager
                done.clear()
                result = stitch_frames(images, ids, tuning, dev,
                                       on_strip=on_strip, row_sink=sink)
            panorama = result.panorama
            if store is not None:
                log.log("Main", "streaming decode", n=len(store),
                        decode_seconds=round(store.decode_seconds, 3))

        if writer is not None:
            with log.timer("Main", "strip-save drain"):
                writer.join()
            writer = None
        if sink is not None and sink.done:
            log.log("Main", "wrote", path=cfg.output_path, streamed=True)
            return 0
        with log.timer("Main", "write"):
            write_image(cfg.output_path, panorama)
        log.log("Main", "wrote", path=cfg.output_path,
                h=panorama.shape[0], w=panorama.shape[1])
        return 0
    except Exception as err:  # top-level catch (stitch_app.cpp:265-268)
        log.log("Main", "FATAL", error=f"{type(err).__name__}: {err}")
        traceback.print_exc()
        return 1
    finally:
        if writer is not None:      # a fault ended the run: stop the worker
            try:
                writer.join()
            except Exception:
                pass
        if sink is not None and not sink.done:
            sink.abort()
