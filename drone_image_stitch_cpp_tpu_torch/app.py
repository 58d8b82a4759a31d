"""Application entry point: load -> undistort -> group -> strips ->
global -> crop -> write.

Port of ``drone_image_stitch_cpp_tpu/app.py::run_stitch_application``
(runStitchApplication, stitch_app.cpp:146-271). The run splits into a host
part (:func:`run_stitch_application`: scan, streaming decode, strip saves,
checkpoint and resume, the mosaic write) and a device part
(:func:`stitch_frames`: frame store, grouping, one strip stitch per
flight line with each panorama kept on the device, the global inter-strip
stage, and the crop from the blend's device content flags). One group
takes the single-strip path (stitch_app.cpp:246-260).

Ingest streams by default (``runtime/feed.FrameStore.from_paths``: decode
on a background thread while grouping runs, ``RunConfig.ingest_fmt``,
``"auto"`` by default: a folder of 4:2:0 JPEGs is stored as their own
planes, packed I420, where the JPEG codec builds (``utils/native``: the
system libjpeg or the one in Pillow's wheel), as the JAX package's store
does; BGR elsewhere); a frame that does not decode falls back to the
eager loader's skip-unreadable path. A ready camera calibration for the
run's image type (``StitchTuning.calibration``, set
through ``RunConfig.tuning_overrides``) sends ingest through the eager
loader instead, and :func:`undistort_frames` undistorts every frame on
the device before grouping (undistortImagesIfReady, stitch_app.cpp:
27-80). Each strip's JPEG
(``strips/strip_XX.jpg``) and then the lossless strip checkpoint are
written by a ``BackgroundWriter`` while the device stitches on;
``RunConfig.resume`` restarts the global stage from that checkpoint. The
global stage streams the mosaic's row bands into the incremental JPEG
encoder when the codec is built, else the mosaic is written after the
blend; ``RunConfig.fetch_packed`` sends its tiles to the host as packed
I420. ``ingest_fmt`` and ``fetch_packed`` are the JAX package's
``TM_INGEST_FMT`` and ``TM_FETCH_PACKED`` switches, taken as fields;
``seam_warp`` and ``seam_method`` are its ``TM_SEAM_WARP`` and
``TM_SEAM_METHOD`` (the global stage's seam canvas warped from the
full-resolution strip; DP seams in place of the graph cut).

The run's device spec resolves to a device list
(``runtime/device.resolve_devices``: ``cuda`` is every visible card,
``cuda:N`` one, ``cpu`` the CPU, or a list), the JAX package's mesh over
all chips of a host (app.py:183-195, 270-295): the pair registration's
chunks and the host-assembled compose tiles spread over the list, strip
gi stitches on ``devices[gi % N]``, and the global stage runs on
``devices[0]``. One device runs the single-device path unchanged.

Not ported: the JAX package's degrade-to-CPU ladder: a fault on the card
ends the run with exit 1 and a ``[Main] FATAL`` line, never a silent CPU
re-run; ``--resume`` is the recovery.
"""

from __future__ import annotations

import os
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config.tuning import StitchTuning, load_stitch_tuning, tuning_as_dict
from .grouping.flight_grouper import VisualStripGroup, group_boustrophedon
from .ops.crop import auto_crop_black_border
from .ops.undistort import distortion_maps
from .ops.warp import remap
from .pipeline.global_ import (check_seam_switches,
                               stitch_inter_strips_custom)
from .pipeline.strip import stitch_strip
from .runtime.checkpoint import load_strip_checkpoint, save_strip_checkpoint
from .runtime.device import (describe_device, device_sync, resolve_device,
                             resolve_devices)
from .runtime.feed import FrameStore, FrameStoreError
from .runtime.handoff import DeviceStrip, as_host_strips
from .runtime.loader import load_with_ids, scan_with_ids
from .runtime.logging import get_logger
from .runtime.writer import BackgroundWriter, StreamedMosaicWriter
from .utils.native import (encode_jpeg_native, jpeg_codec_error,
                           jpeg_codec_route, jpeg_encoder_available)


@dataclass
class RunConfig:
    """Run parameters (stitch_app.cpp:149-160) plus the device."""

    image_folder: str = "../images"
    image_type: str = "visible"
    group: str = "minfull"
    output_root: str = "../output"
    device: object = "cuda"       # cuda (every card), cuda:N, cpu, a list
    save_strips: bool = True      # strips/strip_XX.jpg per flight line
    resume: bool = False          # global stage from the strip checkpoint
    tuning_overrides: dict = field(default_factory=dict)
    ingest_fmt: str = "auto"      # the frame store's fmt: auto, bgr, yuv420
    fetch_packed: bool = False    # global tiles leave the card packed I420
    seam_warp: str = "prescaled"  # global seam canvas: prescaled, fullres
    seam_method: str = "graphcut"  # global seams: graphcut, dp

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
                  row_sink=None, fetch_packed: bool = False,
                  seam_warp: str = "prescaled",
                  seam_method: str = "graphcut") -> StitchResult:
    """Group and stitch same-size BGR uint8 frames on ``device``.

    One flight line: one strip stitch. Several: one strip stitch per line
    (each panorama kept on the device when its canvas is tiled), then the
    global inter-strip stage. ``device``: a device spec or list
    (``runtime/device.resolve_devices``); the frames, grouping and the
    global stage live on the first device, strip gi stitches on
    ``devices[gi % N]`` (reading its frames with one device-to-device
    copy when that is another card), and the pair registration and the
    host-assembled compose tiles spread over the list. ``store``: a
    ``FrameStore`` holding the frames on the first device (e.g. a
    streaming one; ``images`` is then None), else one is made from
    ``images``. ``on_strip(gi, pano, last)``: called after each
    strip of a multi-line sortie with its cropped panorama (a host array
    or a :class:`DeviceStrip`), ``last`` on the final strip, before the
    global stage. ``row_sink`` and ``fetch_packed``: passed to the global
    stage (streamed mosaic write; tiles fetched as packed I420), as are
    ``seam_warp`` and ``seam_method`` (checked before any work: a value
    the global stage does not take raises ValueError). Raises
    DeviceUnavailableError when ``device`` names a card that is not there,
    FrameStoreError when a streamed frame does not decode,
    StripStitchError or GlobalStitchError when a stage fails.
    """
    check_seam_switches(seam_warp, seam_method)
    devices = resolve_devices(device)
    dev = devices[0]
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
                range_width_override=tuning.range_width, device=devices,
                store=store, indices=flat_idx, info=info)
        return StitchResult(
            panorama=auto_crop_black_border(pano), groups=groups,
            strip_kept=[[flat_idx[k] for k in info["kept"]]],
            strip_transforms=[np.asarray(info["transforms"])],
            global_transforms=[np.eye(3, dtype=np.float32)], flipped=[False])

    strips, strip_kept, strip_tf = [], [], []
    for gi, g in enumerate(groups):
        # strip gi on devices[gi % N], its registration spread over the
        # list starting there (app.py:270-295)
        k = gi % len(devices)
        own = devices[k:] + devices[:k]
        s_store, s_idx = store, list(g.indices)
        if own[0] != store.device:
            s_store, s_idx = store.subset(s_idx, own[0]), list(
                range(len(s_idx)))
        info = {}
        with log.timer(f"Strip{gi}", "stitch", sync=device_sync(own[0])):
            pano = stitch_strip(
                None, strip_tuning, stage=f"Strip{gi}",
                range_width_override=tuning.range_width,
                image_tags=make_strip_tags(gi, g.ids), device=own,
                store=s_store, indices=s_idx, info=info,
                return_device=True)
        del s_store
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
                                            device=devices, info=ginfo,
                                            row_sink=row_sink,
                                            fetch_packed=fetch_packed,
                                            seam_warp=seam_warp,
                                            seam_method=seam_method)
    return StitchResult(
        panorama=mosaic, groups=groups, strip_kept=strip_kept,
        strip_transforms=strip_tf, global_transforms=ginfo["transforms"],
        flipped=ginfo["flipped"], seam_methods=ginfo["seam_methods"])


def write_image(path: str, img: np.ndarray) -> None:
    """A JPEG through the codec built from native/ where it builds (at
    quality 95 with libjpeg's defaults, the settings of cv2's default
    JPEG write), anything else through cv2; raises when neither can
    write it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.lower().endswith((".jpg", ".jpeg")) and jpeg_encoder_available():
        encode_jpeg_native(path, np.ascontiguousarray(img))
        return
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"no encoder for {path}: no cv2, and the JPEG "
                           f"codec is unavailable ({jpeg_codec_error()})")
    if not cv2.imwrite(path, img):
        raise RuntimeError(f"failed to write {path}")


def _save_strip(path: str, pano) -> None:
    """Write one strip JPEG; a DeviceStrip is fetched here, on the writer
    thread, overlapping the next strip's device work."""
    write_image(path, pano.host() if isinstance(pano, DeviceStrip) else pano)


def _ready_calibration(tuning: StitchTuning, image_type: str):
    """The run's camera calibration when it is filled in, else None
    (findCameraCalibration, stitch_app.cpp:27-36)."""
    calib = tuning.calibration.find(image_type)
    return calib if calib is not None and calib.is_ready() else None


def undistort_frames(images: List[np.ndarray], tuning: StitchTuning,
                     image_type: str, device) -> List[np.ndarray]:
    """Undistort host BGR uint8 frames on ``device`` with the calibration
    of ``image_type`` (undistortImagesIfReady, stitch_app.cpp:38-80): each
    frame is remapped in float32 and truncated back to uint8, as the JAX
    package's ``astype(np.uint8)`` truncates. Without a ready calibration
    the frames come back unchanged."""
    log = get_logger()
    calib = _ready_calibration(tuning, image_type)
    if calib is None:
        log.log("Main", "calibration not ready; skipping undistort")
        return images
    dev = resolve_device(device)
    maps = {}
    out = []
    for img in images:
        hw = img.shape[:2]
        if hw not in maps:      # one pair of maps per frame size
            maps[hw] = distortion_maps(calib, *hw, device=dev)
        src = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
        out.append(remap(src, *maps[hw]).to(torch.uint8).cpu().numpy())
    log.log("Main", "undistorted", n=len(out))
    return out


def _eager_frames(cfg: RunConfig, tuning: StitchTuning, dev, log):
    """The eager loader (skip-unreadable, image_loader.cpp:52-59), then
    :func:`undistort_frames`: (images, ids), or None when fewer than 2
    frames decode."""
    with log.timer("Main", "load+decode"):
        loaded = load_with_ids(cfg.input_dir)
    log.log("Main", "loaded", n=len(loaded.images))
    if len(loaded.images) < 2:
        log.log("Main", "need at least 2 images")
        return None
    with log.timer("Main", "undistort", sync=device_sync(dev)):
        images = undistort_frames(loaded.images, tuning, cfg.image_type, dev)
    return images, loaded.ids


def run_stitch_application(cfg: Optional[RunConfig] = None) -> int:
    """End-to-end run; returns a process exit code like the reference
    (top-level catch -> 1, stitch_app.cpp:265-268)."""
    cfg = cfg or RunConfig()
    log = get_logger()
    writer = sink = None
    try:
        devices = resolve_devices(cfg.device)
        dev = devices[0]
        tuning = load_stitch_tuning(cfg.image_type)
        if cfg.tuning_overrides:
            tuning = tuning.replace(**cfg.tuning_overrides)
        os.makedirs(cfg.output_dir, exist_ok=True)
        log.log("Main", "device", **describe_device(dev))
        log.log("Main", "codec", route=jpeg_codec_route(),
                error=jpeg_codec_error())
        if len(devices) > 1:
            log.log("Main", "mesh", devices=len(devices))
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
                    strips, global_tuning(tuning), device=devices,
                    row_sink=sink, fetch_packed=cfg.fetch_packed,
                    seam_warp=cfg.seam_warp, seam_method=cfg.seam_method)
        else:
            with log.timer("Main", "scan"):
                paths, ids = scan_with_ids(cfg.input_dir)
            images = store = None
            # the streaming store only without a calibration: undistortion
            # rewrites every frame's pixels before grouping
            calibrated = _ready_calibration(tuning, cfg.image_type)
            if calibrated is None:
                log.log("Main", "calibration not ready; skipping undistort")
            if len(paths) >= 2 and calibrated is None:
                try:
                    # fmt="auto": a folder of 4:2:0 JPEGs is stored as its
                    # own planes (packed I420) where the codec builds
                    store = FrameStore.from_paths(paths, dev,
                                                  fmt=cfg.ingest_fmt)
                    store.shape0    # frame 0 decodes, or FrameStoreError
                    log.log("Main", "streaming ingest", fmt=store.fmt,
                            n=len(paths))
                except FrameStoreError as e:
                    log.log("Main", "streaming ingest unavailable",
                            error=str(e))
                    store = None
            if store is None:
                eager = _eager_frames(cfg, tuning, dev, log)
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
                result = stitch_frames(images, ids, tuning, devices,
                                       store=store, on_strip=on_strip,
                                       row_sink=sink,
                                       fetch_packed=cfg.fetch_packed,
                                       seam_warp=cfg.seam_warp,
                                       seam_method=cfg.seam_method)
            except FrameStoreError as e:
                # an unreadable or mismatched frame: recover with the eager
                # loader (skip-unreadable, image_loader.cpp:52-59)
                log.log("Main", "streaming ingest failed; reloading",
                        error=str(e))
                store = None
                eager = _eager_frames(cfg, tuning, dev, log)
                if eager is None:
                    return 1
                images, ids = eager
                done.clear()
                result = stitch_frames(images, ids, tuning, devices,
                                       on_strip=on_strip, row_sink=sink,
                                       fetch_packed=cfg.fetch_packed,
                                       seam_warp=cfg.seam_warp,
                                       seam_method=cfg.seam_method)
            panorama = result.panorama
            if store is not None:
                log.log("Main", "streaming decode", n=len(store),
                        decode_seconds=round(store.decode_seconds, 3),
                        fmt=store.fmt, bytes=store.nbytes)

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
