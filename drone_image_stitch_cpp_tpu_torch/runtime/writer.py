"""Background output writers: queued host saves and the streamed JPEG write.

Port of ``drone_image_stitch_cpp_tpu/runtime/writer.py``. The reference
writes each strip panorama before starting the next strip
(stitch_app.cpp:215-217) and encodes the mosaic after the blend
(stitch_app.cpp:262-263): host work during which the device waits. Two
pieces move it off the critical path:

* :class:`BackgroundWriter`: one worker thread running queued save
  callables (strip JPEGs, the resume checkpoint) while the device stitches
  the next strip. Errors resurface at :meth:`BackgroundWriter.join`; a
  ``submit`` after an error fails fast.
* :class:`StreamedMosaicWriter`: takes the tiled blend's finished row
  bands (``ops/blend.mb_compose_tiled`` ``on_rows``) and feeds them to the
  incremental JPEG encoder (``utils/native.NativeJpegEncoder``) on a
  worker thread, so the mosaic's encode overlaps the remaining tiles. Its
  crop box comes from content geometry (the union of the seam-scale
  content masks), a few pixels of black margin outside the exact autocrop
  box at most.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np


class BackgroundWriter:
    """Run save callables on a worker thread, in submission order;
    re-raise the first failure on :meth:`join`."""

    def __init__(self, name: str = "bg-writer"):
        self._q: "queue.Queue[Optional[Tuple[Callable, tuple, dict]]]" = \
            queue.Queue()
        self._errors: list = []
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, kwargs = item
            try:
                fn(*args, **kwargs)
            except Exception as err:  # surfaced at join()
                self._errors.append(err)

    def submit(self, fn: Callable, *args, **kwargs) -> None:
        if self._errors:
            # fail fast instead of queueing more work behind a dead write
            self.join()
        self._q.put((fn, args, kwargs))

    def join(self) -> None:
        """Drain the queue, stop the worker, re-raise the first error."""
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        if self._errors:
            err = self._errors[0]
            self._errors = []
            raise err


class StreamedMosaicWriter:
    """Row-band sink for ``mb_compose_tiled``: crop and stream JPEG rows.

    Protocol (driven by ``pipeline/global_.py``):
      begin(canvas_h, canvas_w, crop)  crop = (y0, y1, x0, x1) content box
      on_rows(y0, y1, rows)            canvas row band, fired in order
      finish() -> (h, w)               join and close; sets ``done``
      abort()                          clean up after any failure
    Rows are views into the assembling mosaic; bands already fired are
    never written again, so the worker thread reads them race-free.
    """

    def __init__(self, path: str, quality: int = 95):
        self.path = path
        self.quality = quality
        self.done = False
        self.encode_seconds = 0.0   # the worker's time in the encoder
        self._enc = None
        self._crop = None
        self._writer: Optional[BackgroundWriter] = None

    def begin(self, canvas_h: int, canvas_w: int,
              crop: Tuple[int, int, int, int]) -> None:
        from ..utils.native import NativeJpegEncoder
        y0, y1, x0, x1 = crop
        if not (0 <= y0 < y1 <= canvas_h and 0 <= x0 < x1 <= canvas_w):
            raise ValueError(f"crop {crop} outside the canvas "
                             f"({canvas_h}, {canvas_w})")
        self._crop = crop
        self._enc = NativeJpegEncoder(self.path, x1 - x0, y1 - y0,
                                      self.quality)
        self._writer = BackgroundWriter(name="jpeg-stream")

    def on_rows(self, y0: int, y1: int, rows: np.ndarray) -> None:
        cy0, cy1, cx0, cx1 = self._crop
        lo, hi = max(y0, cy0), min(y1, cy1)
        if lo >= hi:
            return
        self._writer.submit(self._write, rows[lo - y0:hi - y0, cx0:cx1])

    def _write(self, band: np.ndarray) -> None:
        t0 = time.perf_counter()
        self._enc.write(band)
        self.encode_seconds += time.perf_counter() - t0

    def finish(self) -> Tuple[int, int]:
        try:
            self._writer.join()
            self._enc.finish()
        except Exception:
            self.abort()
            raise
        self.done = True
        y0, y1, x0, x1 = self._crop
        return y1 - y0, x1 - x0

    def abort(self) -> None:
        if self._writer is not None:
            try:
                self._writer.join()
            except Exception:
                pass
            self._writer = None
        if self._enc is not None:
            self._enc.abort()
            self._enc = None
