"""Device frame store: same-shape uint8 frames moved to the device once.

Port of ``drone_image_stitch_cpp_tpu/runtime/feed.py::FrameStore``.
Grouping detect, strip registration and every compose feed read the same
decoded frames; the store copies each frame to the device once, as uint8,
and serves later passes by indexing on the device.

Two storage formats, as in the JAX package:
  * ``"bgr"``: (H, W, 3) uint8 BGR (a 2160x3840 frame is 24.9 MB);
  * ``"yuv420"``: the JPEG's own 4:2:0 planes, packed I420 (H*3/2, W)
    uint8 (1.5 bytes a pixel, ``ops/color``'s layout). Detect reads the Y
    plane (``ops/color.yuv420_luma``); the warps convert with libjpeg's
    fancy upsampling and full-range JFIF matrix (K2's I420 source,
    ``ops/warp_kernel``). These are the numbers the JAX package computes
    from a drone's JPEGs, which libjpeg's BGR decode rounds differently.

Two ways in: ``FrameStore(images, device, fmt)`` copies host frames at
once; ``FrameStore.from_paths(paths, device)`` streams: a daemon thread
decodes 8-frame chunks in the background (the JPEG codec built from
``native/``, else cv2/PIL), so host decode overlaps the grouping stage's
device work, and a chunk crosses to the device on its first touch. A frame
that does not decode, or whose shape differs from frame 0's, raises
:class:`FrameStoreError` on that first touch.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

FORMATS = ("bgr", "yuv420")


class FrameStoreError(RuntimeError):
    """A streaming store hit a frame that does not decode or does not
    match frame 0's shape. Callers fall back to the eager loader, which
    keeps the reference's skip-unreadable semantics
    (image_loader.cpp:52-59)."""


def _bad_frame(img, shape0, fmt: str) -> bool:
    """Whether ``img`` is not a frame of format ``fmt`` (packed I420 must
    have H % 4 == 0 and W % 2 == 0: H*3/2 rows a multiple of 6) or differs
    from ``shape0``."""
    if img is None or img.dtype != np.uint8:
        return True
    if fmt == "yuv420":
        bad = img.ndim != 2 or img.shape[0] % 6 or img.shape[1] % 2
    else:
        bad = img.ndim != 3 or img.shape[2] != 3
    return bool(bad) or (shape0 is not None and img.shape != shape0)


class FrameStore:
    """Device-resident uint8 frames: (N, H, W, 3) BGR or (N, H*3/2, W)
    packed I420 (``fmt``)."""

    CHUNK = 8

    def __init__(self, images: Sequence[np.ndarray], device: torch.device,
                 fmt: str = "bgr"):
        if not images:
            raise ValueError("FrameStore needs at least one frame")
        if fmt not in FORMATS:
            raise ValueError(f"fmt must be one of {FORMATS}, got {fmt!r}")
        shape = images[0].shape
        for i, im in enumerate(images):
            if _bad_frame(im, shape, fmt):
                want = ("(H*3/2, W) uint8 packed I420 with H % 4 == 0 and "
                        "W % 2 == 0" if fmt == "yuv420"
                        else "(H, W, 3) uint8 BGR")
                raise ValueError(
                    f"FrameStore frames must be same-shape {want}; frame "
                    f"{i} is {im.shape} {im.dtype}, frame 0 {shape}")
        self._init(len(images), device, fmt)
        self.images: List[Optional[np.ndarray]] = list(images)
        for c0 in range(0, len(images), self.CHUNK):
            self._chunk(c0)

    def _init(self, n: int, device, fmt: str) -> None:
        self.device = torch.device(device)
        self.n = n
        self.fmt = fmt
        self.images = [None] * n
        self.failed: List[int] = []
        self.frames: Optional[torch.Tensor] = None
        self._loaded: set = set()
        self._events: list = []
        self._paths: Optional[List[str]] = None
        self.decode_seconds = 0.0   # the decode thread's busy time
        self.nbytes = 0             # the device frames' bytes, once stored

    @classmethod
    def from_paths(cls, paths: Sequence[str], device: torch.device,
                   fmt: str = "auto", scale_denom: int = 1,
                   after: Optional["FrameStore"] = None) -> "FrameStore":
        """A streaming store over ``paths`` (decoded by a daemon thread,
        one chunk of 8 frames at a time, each chunk's event set once its
        frames are decoded and checked against frame 0's shape).

        ``fmt="auto"`` probes the first file with the codec's raw 4:2:0
        decoder, as the JAX package does (runtime/feed.py:113-123): a
        4:2:0 YCbCr JPEG (drone cameras write them) is stored as its own
        planes, packed I420; anything else, or a machine where the codec
        builds by neither route (``utils/native``), stores BGR.
        ``fmt="yuv420"`` raises where the codec does not build;
        ``fmt="bgr"`` always decodes to BGR.

        ``scale_denom`` (BGR only): decode at 1/denom resolution (libjpeg's
        DCT scaling, else cv2's area resize); detect such a store with
        ``coord_scale=scale_denom`` to get full-resolution coordinates.
        ``after``: another streaming store whose decode must finish before
        this one's starts."""
        from ..utils.native import (decode_batch_yuv420_native,
                                    decode_image_yuv420_native,
                                    jpeg_codec_error)
        from .loader import decode_all

        paths = list(paths)
        if not paths:
            raise ValueError("FrameStore needs at least one frame")
        if fmt not in FORMATS + ("auto",):
            raise ValueError(f"fmt must be 'auto' or one of {FORMATS}, got "
                             f"{fmt!r}")
        if fmt == "yuv420":
            if scale_denom != 1:
                raise ValueError("fmt='yuv420' decodes at full resolution "
                                 "only (scale_denom=1)")
            if jpeg_codec_error() is not None:
                raise RuntimeError(f"fmt='yuv420' needs the raw 4:2:0 "
                                   f"decoder: JPEG codec unavailable "
                                   f"({jpeg_codec_error()})")
        if fmt == "auto":
            fmt = "bgr"
            if scale_denom == 1:
                probe = decode_image_yuv420_native(paths[0])
                if not _bad_frame(probe, None, "yuv420"):
                    fmt = "yuv420"
        st = cls.__new__(cls)
        st._init(len(paths), device, fmt)
        st._paths = paths
        st._events = [threading.Event()
                      for _ in range(0, len(paths), cls.CHUNK)]
        n_threads = min(8, (os.cpu_count() or 1) * 2)

        def decode(chunk):
            if fmt == "yuv420":
                return decode_batch_yuv420_native(chunk, n_threads)
            return decode_all(chunk, scale_denom)

        def run():
            if after is not None:
                after.wait_all()
            shape0 = None
            for ci, c0 in enumerate(range(0, len(paths), cls.CHUNK)):
                t0 = time.perf_counter()
                chunk = paths[c0:c0 + cls.CHUNK]
                try:
                    imgs = decode(chunk)
                except Exception:           # no decoder at all
                    imgs = [None] * len(chunk)
                st.decode_seconds += time.perf_counter() - t0
                for k, img in enumerate(imgs):
                    if c0 + k == 0 and not _bad_frame(img, None, fmt):
                        shape0 = img.shape
                    if _bad_frame(img, shape0, fmt):
                        st.failed.append(c0 + k)
                    else:
                        st.images[c0 + k] = img
                st._events[ci].set()

        threading.Thread(target=run, name="frame-decode", daemon=True).start()
        return st

    def wait_all(self) -> None:
        for ev in self._events:
            ev.wait()

    def _wait(self, i: int) -> None:
        if self._events:
            self._events[i // self.CHUNK].wait()

    def _stored_shape(self) -> tuple:
        """Shape of every stored frame (blocks on frame 0 when
        streaming)."""
        self._wait(0)
        if self.images[0] is None:
            raise FrameStoreError("frame 0 unreadable")
        return tuple(self.images[0].shape)

    @property
    def shape0(self):
        """The logical (H, W, 3) of every frame, whatever the storage
        format (blocks on frame 0 when streaming)."""
        sh = self._stored_shape()
        if self.fmt == "yuv420":
            return (sh[0] * 2 // 3, sh[1], 3)
        return sh

    def __len__(self) -> int:
        return self.n

    def _chunk(self, c0: int) -> None:
        """Copy the chunk holding frame ``c0`` to the device (once)."""
        c0 -= c0 % self.CHUNK
        if c0 in self._loaded:
            return
        self._wait(c0)
        c1 = min(self.n, c0 + self.CHUNK)
        bad = [i for i in self.failed if c0 <= i < c1]
        if bad:
            raise FrameStoreError(
                f"unreadable or mismatched frames at indices {bad}")
        if self.frames is None:
            self.frames = torch.empty((self.n,) + self._stored_shape(),
                                      dtype=torch.uint8, device=self.device)
            self.nbytes = self.frames.numel()
        for i in range(c0, c1):
            self.frames[i].copy_(torch.from_numpy(
                np.ascontiguousarray(self.images[i])))
        self._loaded.add(c0)

    def batch(self, indices: List[int]) -> torch.Tensor:
        """(len(indices),) + the stored frame shape, uint8 on the device,
        for reading only: a run of consecutive indices is a view of the
        store, any other list a copy, so the result must not be written (a
        write would change the store for some index lists and not for
        others)."""
        indices = list(indices)
        for c0 in sorted({i - i % self.CHUNK for i in indices}):
            self._chunk(c0)
        if indices and indices == list(range(indices[0],
                                             indices[0] + len(indices))):
            return self.frames[indices[0]:indices[0] + len(indices)]
        idx = torch.as_tensor(indices, dtype=torch.long,
                              device=self.device)
        return self.frames.index_select(0, idx)

    def subset(self, indices: List[int], device: torch.device
               ) -> "FrameStore":
        """Frames ``indices`` as a store of their own on ``device`` (same
        format), made with one device-to-device copy (a strip stitched on
        another card reads its frames from there, never through the
        host)."""
        indices = list(indices)
        st = FrameStore.__new__(FrameStore)
        st._init(len(indices), device, self.fmt)
        st.frames = self.batch(indices).to(st.device)
        st.nbytes = st.frames.numel()
        st.images = [self.images[i] for i in indices]
        if self._paths is not None:
            st._paths = [self._paths[i] for i in indices]
        st._loaded = set(range(0, len(indices), self.CHUNK))
        return st

    def frame(self, i: int) -> torch.Tensor:
        """Frame ``i`` on the device: (H, W, 3) BGR or (H*3/2, W) packed
        I420."""
        self._chunk(i)
        return self.frames[i]

    def host_frame(self, i: int) -> np.ndarray:
        """Frame ``i`` as host (H, W, 3) BGR uint8 (blocks on its chunk
        when streaming); raises FrameStoreError if it did not decode.

        A packed frame read from a file is decoded again through the
        loader's BGR path, so it equals the eager loader's frame bit for
        bit (libjpeg's integer colour conversion, not the device's float
        one; runtime/feed.py:175-187 of the JAX package). A packed frame
        given as an array is converted by ``ops/color.yuv420_to_bgr`` and
        rounded."""
        self._wait(i)
        if self.images[i] is None:
            raise FrameStoreError(f"unreadable or mismatched frame at "
                                  f"index {i}")
        if self.fmt == "bgr":
            return self.images[i]
        if self._paths is not None:
            from .loader import decode_all
            img = decode_all([self._paths[i]])[0]
            if img is None:
                raise FrameStoreError(f"frame {i} ({self._paths[i]}) does "
                                      f"not decode to BGR")
            return img
        from ..ops.color import yuv420_to_bgr
        bgr = yuv420_to_bgr(torch.from_numpy(self.images[i]))
        return bgr.round().to(torch.uint8).numpy()

    def host_images(self) -> List[np.ndarray]:
        """Every frame as host BGR uint8 (:meth:`host_frame`; blocks);
        raises FrameStoreError on any failed frame."""
        self.wait_all()
        if self.failed:
            raise FrameStoreError(f"unreadable or mismatched frames at "
                                  f"indices {self.failed}")
        return [self.host_frame(i) for i in range(self.n)]

    def clear(self) -> None:
        """Drop the device frames and the host copies (after the strip
        stage: the global stage needs the memory)."""
        self.wait_all()
        self.frames = None
        self._loaded.clear()
        self.images = [None] * self.n
