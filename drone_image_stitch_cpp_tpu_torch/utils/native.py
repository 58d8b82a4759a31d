"""ctypes bindings for the native runtime library (native/libtmnative.so).

A copy of ``drone_image_stitch_cpp_tpu/utils/native.py`` trimmed to the
JPEG decode and the incremental JPEG encode. Host-side native components
(the reference's ingest is native C++ via cv::imread). Gracefully absent:
``_load`` returns None when the library is missing or does not load on
this machine (it links libjpeg and is built for the host CPU), and
callers fall back to cv2/PIL.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(here, "native", "libtmnative.so")
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.tm_decode_jpeg.restype = ctypes.POINTER(ctypes.c_ubyte)
        lib.tm_decode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.tm_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        lib.tm_decode_jpeg_batch.restype = ctypes.c_int
        lib.tm_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        uptr = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C")
        if hasattr(lib, "tm_jpeg_enc_start"):
            lib.tm_jpeg_enc_start.restype = ctypes.c_void_p
            lib.tm_jpeg_enc_start.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.tm_jpeg_enc_write_bgr.restype = ctypes.c_int
            lib.tm_jpeg_enc_write_bgr.argtypes = [
                ctypes.c_void_p, uptr, ctypes.c_int]
            lib.tm_jpeg_enc_finish.restype = ctypes.c_int
            lib.tm_jpeg_enc_finish.argtypes = [ctypes.c_void_p]
            lib.tm_jpeg_enc_abort.restype = None
            lib.tm_jpeg_enc_abort.argtypes = [ctypes.c_void_p]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def decode_image_native(path: str) -> Optional[np.ndarray]:
    """Decode one JPEG to HxWx3 uint8 BGR via the native library."""
    if not path.lower().endswith((".jpg", ".jpeg")):
        return None
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    buf = lib.tm_decode_jpeg(path.encode(), ctypes.byref(w),
                             ctypes.byref(h))
    if not buf:
        return None
    try:
        arr = np.ctypeslib.as_array(buf, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.tm_free(buf)
    return arr


class NativeJpegEncoder:
    """Scanline-incremental JPEG encoder (native/encode.cpp).

    Accepts BGR uint8 row bands top-to-bottom; the encode overlaps
    whatever produces the rows (the tiled blender's remaining device
    work). Output is byte-identical to cv2.imwrite at the same quality
    (both are libjpeg at these settings). Raises RuntimeError mid-stream
    on encoder failure.
    """

    def __init__(self, path: str, w: int, h: int, quality: int = 95):
        lib = _load()
        if lib is None or not hasattr(lib, "tm_jpeg_enc_start"):
            raise RuntimeError("native encoder unavailable")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.tm_jpeg_enc_start(
            path.encode(), w, h, quality))
        if not self._h:
            raise RuntimeError(f"tm_jpeg_enc_start failed for {path}")
        self._w = w

    def write(self, rows: np.ndarray) -> None:
        """``rows``: (n, w, 3) uint8 BGR, contiguous."""
        if self._h is None:
            raise RuntimeError("encoder already finished")
        rows = np.ascontiguousarray(rows, np.uint8)
        assert rows.ndim == 3 and rows.shape[1] == self._w \
            and rows.shape[2] == 3, rows.shape
        if self._lib.tm_jpeg_enc_write_bgr(self._h, rows,
                                           rows.shape[0]) != 0:
            self._lib.tm_jpeg_enc_abort(self._h)
            self._h = None
            raise RuntimeError("tm_jpeg_enc_write_bgr failed")

    def finish(self) -> None:
        if self._h is None:
            raise RuntimeError("encoder already finished")
        rc = self._lib.tm_jpeg_enc_finish(self._h)
        self._h = None
        if rc != 0:
            raise RuntimeError("tm_jpeg_enc_finish failed")

    def abort(self) -> None:
        if self._h is not None:
            self._lib.tm_jpeg_enc_abort(self._h)
            self._h = None


def jpeg_encoder_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "tm_jpeg_enc_start")


def decode_batch_native(paths: List[str], n_threads: int = 4
                        ) -> Optional[List[np.ndarray]]:
    """Thread-pool batch decode; None if the library is unavailable or any
    file is not a JPEG (mixed batches fall back to the Python path)."""
    lib = _load()
    if lib is None:
        return None
    if not all(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
        return None
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    bufs = (ctypes.POINTER(ctypes.c_ubyte) * n)()
    ws = (ctypes.c_int * n)()
    hs = (ctypes.c_int * n)()
    lib.tm_decode_jpeg_batch(c_paths, n, bufs, ws, hs, n_threads)
    out: List[np.ndarray] = []
    try:
        for i in range(n):
            if not bufs[i]:
                return None
            out.append(np.ctypeslib.as_array(
                bufs[i], shape=(hs[i], ws[i], 3)).copy())
    finally:
        for i in range(n):
            if bufs[i]:
                lib.tm_free(bufs[i])
    return out
