"""ctypes bindings for the native host libraries, built from ``native/``.

A copy of ``drone_image_stitch_cpp_tpu/utils/native.py`` trimmed to the
JPEG decode, the incremental JPEG encode and the graph-cut min-cut solver
(``tm_graphcut``, a Boykov-Kolmogorov max-flow). Both libraries are built
from the repo's sources with the host C++ compiler into ``build/native/``
at first use, keyed by the sources and flags, so every machine runs the
same code (no ``-march=native``; the committed ``native/libtmnative.so``
is not loaded):

* the JPEG codec from ``native/decode.cpp`` + ``native/encode.cpp``,
  linked with the system libjpeg. Where there is no compiler or no
  libjpeg, :func:`jpeg_codec_error` gives the compiler's first error line
  and every codec read or write raises with it;
* the solver from ``native/graphcut.cpp`` (no libjpeg needed).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
_LOCK = threading.Lock()
_GC = {}        # "fn": the typed tm_graphcut, "path": its library
_CODEC = {}     # "lib": the typed codec library, "error": why there is none


def _build(name: str, sources: Sequence[str], libs: Sequence[str] = ()
           ) -> Tuple[Optional[str], Optional[str]]:
    """Build ``native/<sources>`` into build/native/lib<name>-<key>.so
    (key: the sources' bytes and the flags); returns (path, None), or
    (None, reason) without a C++ compiler or when the compile fails (the
    reason is the compiler's first error line)."""
    srcs = [os.path.join(_ROOT, "native", s) for s in sources]
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None, "no C++ compiler (g++ or c++) on PATH"
    missing = [s for s in srcs if not os.path.exists(s)]
    if missing:
        return None, f"missing source {missing[0]}"
    h = hashlib.sha256(" ".join(_FLAGS + tuple(libs)).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(_ROOT, "build", "native")
    path = os.path.join(out_dir, f"lib{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        proc = subprocess.run([cxx, *_FLAGS, *srcs, "-o", tmp, *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            lines = proc.stderr.strip().splitlines() or ["?"]
            first = next((ln for ln in lines if "error" in ln), lines[0])
            return None, first.strip()
        os.replace(tmp, path)
    return path, None


def graphcut_library() -> Optional[str]:
    """Path of the solver library built from ``native/graphcut.cpp`` that
    serves :func:`graphcut_native`, or None without a C++ compiler."""
    with _LOCK:
        if "path" not in _GC:
            path, _ = _build("tmgraphcut", ["graphcut.cpp"])
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


def _codec():
    """The JPEG codec library (typed once), or None; the reason for None
    is in ``_CODEC["error"]``."""
    with _LOCK:
        if "lib" not in _CODEC:
            path, err = _build("tmjpeg", ["decode.cpp", "encode.cpp"],
                               ["-ljpeg"])
            lib = None
            if path is not None:
                try:
                    lib = ctypes.CDLL(path)
                except OSError as e:
                    err = f"{os.path.basename(path)} does not load: {e}"
            if lib is not None:
                u8p = ctypes.POINTER(ctypes.c_ubyte)
                ip = ctypes.POINTER(ctypes.c_int)
                lib.tm_decode_jpeg.restype = u8p
                lib.tm_decode_jpeg.argtypes = [ctypes.c_char_p, ip, ip]
                lib.tm_free.argtypes = [u8p]
                lib.tm_decode_jpeg_batch.restype = ctypes.c_int
                lib.tm_decode_jpeg_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                    ctypes.POINTER(u8p), ip, ip, ctypes.c_int]
                uptr = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C")
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
            _CODEC["lib"] = lib
            _CODEC["path"] = path if lib is not None else None
            _CODEC["error"] = None if lib is not None else err
        return _CODEC["lib"]


def jpeg_codec_error() -> Optional[str]:
    """None when the JPEG codec is built and loaded, else why not (the
    compiler's first error line, e.g. a missing ``jpeglib.h``)."""
    _codec()
    return _CODEC["error"]


def jpeg_codec_library() -> Optional[str]:
    """Path of the built codec library, or None."""
    _codec()
    return _CODEC["path"]


def jpeg_encoder_available() -> bool:
    return _codec() is not None


def _require_codec():
    lib = _codec()
    if lib is None:
        raise RuntimeError(f"JPEG codec unavailable: {_CODEC['error']}")
    return lib


def decode_image_native(path: str) -> Optional[np.ndarray]:
    """Decode one JPEG to HxWx3 uint8 BGR; None when ``path`` is not a
    JPEG or does not decode. Raises when the codec is not built."""
    lib = _require_codec()
    if not path.lower().endswith((".jpg", ".jpeg")):
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    buf = lib.tm_decode_jpeg(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if not buf:
        return None
    try:
        arr = np.ctypeslib.as_array(buf, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.tm_free(buf)
    return arr


def decode_batch_native(paths: List[str], n_threads: int = 4
                        ) -> List[Optional[np.ndarray]]:
    """Thread-pool batch decode of JPEG paths (the codec's pthread pool);
    entries that are not JPEGs or do not decode are None. Raises when the
    codec is not built."""
    lib = _require_codec()
    jpeg = [p.lower().endswith((".jpg", ".jpeg")) for p in paths]
    todo = [p for p, j in zip(paths, jpeg) if j]
    got: List[Optional[np.ndarray]] = []
    if todo:
        n = len(todo)
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in todo])
        bufs = (ctypes.POINTER(ctypes.c_ubyte) * n)()
        ws = (ctypes.c_int * n)()
        hs = (ctypes.c_int * n)()
        lib.tm_decode_jpeg_batch(c_paths, n, bufs, ws, hs, n_threads)
        try:
            for i in range(n):
                got.append(np.ctypeslib.as_array(
                    bufs[i], shape=(hs[i], ws[i], 3)).copy()
                    if bufs[i] else None)
        finally:
            for i in range(n):
                if bufs[i]:
                    lib.tm_free(bufs[i])
    it = iter(got)
    return [next(it) if j else None for j in jpeg]


class NativeJpegEncoder:
    """Scanline-incremental JPEG encoder (native/encode.cpp).

    Accepts BGR uint8 row bands top-to-bottom; the encode overlaps
    whatever produces the rows (the tiled blender's remaining tiles).
    Output equals a one-shot libjpeg encode at the same quality. Raises
    RuntimeError when the codec is not built, and mid-stream on encoder
    failure.
    """

    def __init__(self, path: str, w: int, h: int, quality: int = 95):
        lib = _require_codec()
        self._lib = lib
        self._h = ctypes.c_void_p(lib.tm_jpeg_enc_start(
            path.encode(), w, h, quality))
        if not self._h:
            raise RuntimeError(f"tm_jpeg_enc_start failed for {path}")
        self._w = w

    def write(self, rows: np.ndarray) -> None:
        """``rows``: (n, w, 3) uint8 BGR."""
        if self._h is None:
            raise RuntimeError("encoder already finished")
        rows = np.ascontiguousarray(rows, np.uint8)
        if rows.ndim != 3 or rows.shape[1] != self._w or rows.shape[2] != 3:
            raise ValueError(f"rows must be (n, {self._w}, 3), got "
                             f"{rows.shape}")
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


def encode_jpeg_native(path: str, img: np.ndarray, quality: int = 95
                       ) -> None:
    """One-shot JPEG write of an (H, W, 3) uint8 BGR image."""
    enc = NativeJpegEncoder(path, img.shape[1], img.shape[0], quality)
    try:
        enc.write(img)
        enc.finish()
    except BaseException:
        enc.abort()
        raise
