"""ctypes bindings for the native runtime library (native/libtmnative.so).

A copy of ``drone_image_stitch_cpp_tpu/utils/native.py`` trimmed to the
JPEG decode, the incremental JPEG encode and the graph-cut min-cut
solver (``tm_graphcut``, a Boykov-Kolmogorov max-flow). The JPEG paths
use the committed library, which links libjpeg and is built for one host:
``_load`` returns None where it is missing or does not load, and callers
fall back to cv2/PIL. The solver is always built from
``native/graphcut.cpp`` with the host C++ compiler into ``build/native/``
at first use (keyed by the source and flags; it needs no libjpeg), so
every machine runs the same solver.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

_LIB = None
_TRIED = False
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_GC_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_GC_LOCK = threading.Lock()
_GC = {}        # "fn": the typed tm_graphcut, "path": its library


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(_ROOT, "native", "libtmnative.so")
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


def _build_graphcut() -> Optional[str]:
    """``native/graphcut.cpp`` built into build/native/ (keyed by the
    source and flags); None without a C++ compiler or when it fails."""
    src = os.path.join(_ROOT, "native", "graphcut.cpp")
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(_GC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(_ROOT, "build", "native")
    path = os.path.join(out_dir, f"libtmgraphcut-{digest}.so")
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        proc = subprocess.run([cxx, *_GC_FLAGS, src, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            return None
        os.replace(tmp, path)
    return path


def graphcut_library() -> Optional[str]:
    """Path of the solver library built from ``native/graphcut.cpp`` that
    serves :func:`graphcut_native`, or None without a C++ compiler."""
    with _GC_LOCK:
        if "path" not in _GC:
            path = _build_graphcut()
            if path is not None:
                fptr = np.ctypeslib.ndpointer(dtype=np.float32, flags="C")
                uptr = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C")
                fn = ctypes.CDLL(path).tm_graphcut
                fn.restype = ctypes.c_double
                fn.argtypes = [ctypes.c_int, ctypes.c_int, fptr, fptr, fptr,
                               fptr, uptr]
                _GC["fn"] = fn
            _GC["path"] = path
        return _GC["path"]


def graphcut_native(cap_src: np.ndarray, cap_snk: np.ndarray,
                    cap_h: np.ndarray, cap_v: np.ndarray
                    ) -> Optional[np.ndarray]:
    """Min-cut labels (1 = source side) on a 4-connected (h, w) grid with
    terminal capacities ``cap_src``/``cap_snk`` (h, w), horizontal edges
    ``cap_h`` (h, w-1) and vertical edges ``cap_v`` (h-1, w); None if no
    solver library is available (:func:`graphcut_library`)."""
    if graphcut_library() is None:
        return None
    h, w = cap_src.shape
    labels = np.zeros((h, w), np.uint8)
    _GC["fn"](h, w, np.ascontiguousarray(cap_src, np.float32),
              np.ascontiguousarray(cap_snk, np.float32),
              np.ascontiguousarray(cap_h, np.float32),
              np.ascontiguousarray(cap_v, np.float32), labels)
    return labels


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
