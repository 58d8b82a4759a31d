"""ctypes bindings for the native host libraries, built from ``native/``.

A copy of ``drone_image_stitch_cpp_tpu/utils/native.py`` trimmed to the
JPEG decode (BGR, BGR at 1/denom by libjpeg's DCT scaling, and the raw
4:2:0 planes as packed I420), the incremental JPEG encode and the
graph-cut min-cut solver (``tm_graphcut``, a Boykov-Kolmogorov
max-flow). Both libraries are built from the repo's sources with the host
C++ compiler into ``build/native/`` at first use, keyed by the sources,
flags and (for the codec) the headers and library it was built against,
so every machine runs the same code (no ``-march=native``; the committed
``native/libtmnative.so`` is not loaded):

* the JPEG codec from ``native/decode.cpp`` + ``native/encode.cpp``, by
  the first of two routes that builds and loads (:func:`jpeg_codec_route`):

  - ``system``: the system ``jpeglib.h`` and ``-ljpeg``;
  - ``pillow``: the jpeg62 headers vendored in ``csrc/libjpeg62/``
    (libjpeg-turbo 2.1.5) and the libjpeg-turbo that Pillow's wheel
    bundles (``<site-packages>/pillow.libs/libjpeg-*.so*``, the jpeg62
    ABI), linked by its path with an rpath to its directory. This is the
    route of a machine with Pillow but no libjpeg development files.

  Where neither builds, :func:`jpeg_codec_error` names both routes'
  failures and every codec read or write raises with it, but the raw
  4:2:0 decodes, which return None there (the frame store's probe then
  stores BGR);
* the solver from ``native/graphcut.cpp`` (no libjpeg needed);
* the host build of K2's in-kernel affine inverse
  (:func:`affine_inverse_host`, from ``csrc/``), which holds that
  inverse to the bits of ``ops/warp_kernel.inverse_coeffs`` on a machine
  with no card (tests/test_torch_plane_inverse.py).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..runtime.logging import get_logger

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
_LOCK = threading.Lock()
_GC = {}        # "fn": the typed tm_graphcut, "path": its library
_CODEC = {}     # "lib": the typed codec library, "path", "route", "error"
_AFFINE = {}    # "fn": the typed affine_inverse_f32_host, "error"
_CSRC = os.path.join(_ROOT, "drone_image_stitch_cpp_tpu_torch", "csrc")
# the jpeg62 headers the pillow route compiles against
_VENDORED = os.path.join(_CSRC, "libjpeg62")
_JPEG_HEADERS = ("jpeglib.h", "jconfig.h", "jmorecfg.h", "jerror.h")
# what the system route's header probe preprocesses
_SYSTEM_PROBE = ("#include <cstdio>\n#include <jpeglib.h>\n"
                 "#include <jerror.h>\n")


def _cxx() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def _first_error(stderr: str) -> str:
    lines = stderr.strip().splitlines() or ["?"]
    return next((ln for ln in lines if "error" in ln), lines[0]).strip()


def _build(name: str, sources: Sequence[str], libs: Sequence[str] = (),
           cflags: Sequence[str] = (), key: bytes = b"",
           src_dir: str = os.path.join(_ROOT, "native")
           ) -> Tuple[Optional[str], Optional[str]]:
    """Build ``<src_dir>/<sources>`` (``native/`` by default) into
    build/native/lib<name>-<key>.so (key: the sources' bytes, the flags
    and libraries, and ``key``: what else the build depends on); returns
    (path, None), or (None, reason) without a C++ compiler or when the
    compile fails (the reason is the compiler's first error line)."""
    srcs = [os.path.join(src_dir, s) for s in sources]
    cxx = _cxx()
    if cxx is None:
        return None, "no C++ compiler (g++ or c++) on PATH"
    missing = [s for s in srcs if not os.path.exists(s)]
    if missing:
        return None, f"missing source {missing[0]}"
    h = hashlib.sha256(" ".join(_FLAGS + tuple(cflags)
                                + tuple(libs)).encode())
    h.update(key)
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(_ROOT, "build", "native")
    path = os.path.join(out_dir, f"lib{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        proc = subprocess.run([cxx, *_FLAGS, *cflags, *srcs, "-o", tmp,
                               *libs], capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            return None, _first_error(proc.stderr)
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
    solver library is available (:func:`graphcut_library`). Each call is
    one ``seam solve`` span of the calling stage, with ``nodes`` = h x w.
    """
    if graphcut_library() is None:
        return None
    h, w = cap_src.shape
    labels = np.zeros((h, w), np.uint8)
    args = [np.ascontiguousarray(c, np.float32)
            for c in (cap_src, cap_snk, cap_h, cap_v)]
    with get_logger().span("seam solve", nodes=h * w):
        _GC["fn"](h, w, *args, labels)
    return labels


def affine_inverse_host():
    """``affine_inverse_f32_host(a23s, out, n)`` (float32 arrays: n
    row-major (2, 3) src->dst affines in, n x 6 dst->src coefficients
    out): the in-kernel inverse of K2's single-plane form,
    ``csrc/affine_inverse.cuh``, built for the host by the C++ compiler
    with ``-ffp-contract=off`` from ``csrc/affine_inverse_host.cpp`` into
    ``build/native/`` at first use, keyed by both files: the header's
    host instantiation, for tests on a machine with no card. None without
    a compiler (the reason is then ``_AFFINE["error"]``)."""
    if "fn" in _AFFINE:
        return _AFFINE["fn"]
    with _LOCK:
        if "fn" not in _AFFINE:
            path, err = _build("tmaffineinv", ["affine_inverse_host.cpp"],
                               cflags=("-ffp-contract=off",),
                               key=_file_key([os.path.join(
                                   _CSRC, "affine_inverse.cuh")]),
                               src_dir=_CSRC)
            fn = None
            if path is not None:
                fptr = np.ctypeslib.ndpointer(dtype=np.float32, flags="C")
                fn = ctypes.CDLL(path).affine_inverse_f32_host
                fn.restype = None
                fn.argtypes = [fptr, fptr, ctypes.c_int]
            _AFFINE.update(fn=fn, error=err)
        return _AFFINE["fn"]


def _file_key(paths: Sequence[str]) -> bytes:
    """The bytes of ``paths``, each after its name."""
    out = b""
    for p in paths:
        with open(p, "rb") as f:
            out += os.path.basename(p).encode() + b"\0" + f.read()
    return out


def _lib_key(path: str) -> bytes:
    """A linked library's path and size (its bytes are not read)."""
    return f"{path}:{os.path.getsize(path)}".encode()


def _route_system(cxx: str):
    """Route ``system``: the compiler's own ``jpeglib.h`` and ``-ljpeg``.
    Returns (cflags, libs, key, route) or raises RuntimeError with why
    not (the header probe's first error line when there is no
    ``jpeglib.h``)."""
    proc = subprocess.run([cxx, "-x", "c++", "-M", "-"], input=_SYSTEM_PROBE,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(_first_error(proc.stderr))
    deps = proc.stdout.replace("\\\n", " ").split()
    heads = sorted({d for d in deps if os.path.basename(d) in _JPEG_HEADERS})
    lib = subprocess.run([cxx, "-print-file-name=libjpeg.so"],
                         capture_output=True, text=True).stdout.strip()
    lib = os.path.realpath(lib) if os.path.isabs(lib) else lib
    key = b"system\0" + _file_key(heads) + (
        _lib_key(lib) if os.path.isfile(lib) else lib.encode())
    return (), ("-ljpeg",), key, "system"


def _pillow_libjpeg() -> Optional[str]:
    """The libjpeg-turbo that Pillow's wheel bundles
    (``<dir of PIL>/../pillow.libs/libjpeg-*.so*``), or None: no PIL, or a
    Pillow built from source (no ``pillow.libs/``). PIL is located, not
    imported."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.origin:
        return None
    site = os.path.dirname(os.path.dirname(os.path.abspath(spec.origin)))
    found = sorted(glob.glob(os.path.join(site, "pillow.libs",
                                          "libjpeg-*.so*")))
    return found[0] if found else None


def _route_pillow(cxx: str):
    """Route ``pillow``: the vendored jpeg62 headers and Pillow's bundled
    libjpeg-turbo, linked by its path with an rpath to its directory.
    Returns (cflags, libs, key, route) or raises RuntimeError with why
    not."""
    lib = _pillow_libjpeg()
    if lib is None:
        raise RuntimeError("no libjpeg-*.so* under Pillow's pillow.libs/ "
                           "(no PIL, or a Pillow built from source)")
    heads = [os.path.join(_VENDORED, h) for h in _JPEG_HEADERS]
    key = b"pillow\0" + _file_key(heads) + _lib_key(lib)
    return (("-I", _VENDORED), (lib, f"-Wl,-rpath,{os.path.dirname(lib)}"),
            key, f"pillow:{lib}")


_ROUTES = {"system": _route_system, "pillow": _route_pillow}


def _type_codec(lib) -> None:
    """Declare the codec's C entry points on a loaded library."""
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.tm_decode_jpeg.restype = u8p
    lib.tm_decode_jpeg.argtypes = [ctypes.c_char_p, ip, ip]
    lib.tm_free.argtypes = [u8p]
    batch = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
             ctypes.POINTER(u8p), ip, ip, ctypes.c_int]
    lib.tm_decode_jpeg_yuv420.restype = u8p
    lib.tm_decode_jpeg_yuv420.argtypes = [ctypes.c_char_p, ip, ip]
    for fn, extra in (("tm_decode_jpeg_batch", []),
                      ("tm_decode_jpeg_batch_yuv420", []),
                      ("tm_decode_jpeg_batch_scaled", [ctypes.c_int])):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = batch + extra
    uptr = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C")
    lib.tm_jpeg_enc_start.restype = ctypes.c_void_p
    lib.tm_jpeg_enc_start.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tm_jpeg_enc_write_bgr.restype = ctypes.c_int
    lib.tm_jpeg_enc_write_bgr.argtypes = [ctypes.c_void_p, uptr, ctypes.c_int]
    lib.tm_jpeg_enc_finish.restype = ctypes.c_int
    lib.tm_jpeg_enc_finish.argtypes = [ctypes.c_void_p]
    lib.tm_jpeg_enc_abort.restype = None
    lib.tm_jpeg_enc_abort.argtypes = [ctypes.c_void_p]


def _build_codec(routes: Sequence[str] = ("system", "pillow")) -> dict:
    """Build and load the codec by the first of ``routes`` that works:
    {"lib", "path", "route", "error"}, with lib, path and route None and
    error naming every route's failure when none does. A library is
    loaded under the key of its route, headers and linked library, so a
    ``build/native/`` entry made on one machine is never loaded against
    another machine's libjpeg."""
    cxx = _cxx()
    if cxx is None:
        return {"lib": None, "path": None, "route": None,
                "error": "no C++ compiler (g++ or c++) on PATH"}
    errors = []
    for name in routes:
        try:
            cflags, libs, key, route = _ROUTES[name](cxx)
        except RuntimeError as e:
            errors.append(f"{name}: {e}")
            continue
        path, err = _build("tmjpeg", ["decode.cpp", "encode.cpp"], libs,
                           cflags, key)
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                err = f"{os.path.basename(path)} does not load: {e}"
            else:
                _type_codec(lib)
                return {"lib": lib, "path": path, "route": route,
                        "error": None}
        errors.append(f"{name}: {err}")
    return {"lib": None, "path": None, "route": None,
            "error": "; ".join(errors)}


def _codec():
    """The JPEG codec library (typed once), or None; the reason for None
    is in ``_CODEC["error"]``."""
    with _LOCK:
        if "lib" not in _CODEC:
            _CODEC.update(_build_codec())
        return _CODEC["lib"]


def jpeg_codec_error() -> Optional[str]:
    """None when the JPEG codec is built and loaded, else why not: each
    route's failure (the compiler's first error line, e.g. a missing
    ``jpeglib.h``, or no libjpeg in Pillow's wheel)."""
    _codec()
    return _CODEC["error"]


def jpeg_codec_library() -> Optional[str]:
    """Path of the built codec library, or None."""
    _codec()
    return _CODEC["path"]


def jpeg_codec_route() -> Optional[str]:
    """How the codec was built: ``"system"``, ``"pillow:<libjpeg path>"``
    or None when it was not."""
    _codec()
    return _CODEC["route"]


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


def _batch(lib, name: str, paths: List[str], n_threads: int, rows,
           extra=()) -> List[Optional[np.ndarray]]:
    """Run the codec's pthread-pool batch entry ``name`` over ``paths``
    (JPEGs only); entry i is the uint8 array of shape ``rows(h, w)`` the
    codec returned for it, or None where it returned none."""
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    bufs = (ctypes.POINTER(ctypes.c_ubyte) * n)()
    ws = (ctypes.c_int * n)()
    hs = (ctypes.c_int * n)()
    getattr(lib, name)(c_paths, n, bufs, ws, hs, n_threads, *extra)
    out: List[Optional[np.ndarray]] = []
    try:
        for i in range(n):
            out.append(np.ctypeslib.as_array(
                bufs[i], shape=rows(hs[i], ws[i])).copy()
                if bufs[i] else None)
    finally:
        for i in range(n):
            if bufs[i]:
                lib.tm_free(bufs[i])
    return out


def _jpeg_only(paths: List[str], decode) -> List[Optional[np.ndarray]]:
    """``decode(jpeg_paths)`` over the JPEG entries of ``paths``; None for
    the others, in order."""
    jpeg = [p.lower().endswith((".jpg", ".jpeg")) for p in paths]
    it = iter(decode([p for p, j in zip(paths, jpeg) if j]))
    return [next(it) if j else None for j in jpeg]


def decode_batch_native(paths: List[str], n_threads: int = 4,
                        scale_denom: int = 1
                        ) -> List[Optional[np.ndarray]]:
    """Thread-pool batch decode of JPEG paths to (H, W, 3) uint8 BGR (the
    codec's pthread pool); entries that are not JPEGs or do not decode are
    None. ``scale_denom`` in {1, 2, 4, 8} decodes at 1/denom resolution by
    libjpeg's DCT scaling (``tm_decode_jpeg_batch_scaled``). Raises when
    the codec is not built."""
    lib = _require_codec()
    if scale_denom not in (1, 2, 4, 8):
        raise ValueError(f"scale_denom must be 1, 2, 4 or 8, got "
                         f"{scale_denom}")

    def rows(h, w):
        return (h, w, 3)

    if scale_denom == 1:
        return _jpeg_only(paths, lambda ps: _batch(
            lib, "tm_decode_jpeg_batch", ps, n_threads, rows))
    return _jpeg_only(paths, lambda ps: _batch(
        lib, "tm_decode_jpeg_batch_scaled", ps, n_threads, rows,
        (scale_denom,)))


def _i420_rows(h, w):
    return (h * 3 // 2, w)


def decode_image_yuv420_native(path: str) -> Optional[np.ndarray]:
    """Decode one 4:2:0 JPEG to its own planes, packed I420: an
    (H*3/2, W) uint8 array (Y, then U, then V, each chroma plane raveled
    into W-wide rows; ``tm_decode_jpeg_yuv420``). None unless ``path`` is
    a 3-component YCbCr JPEG with 2x2/1x1/1x1 sampling and even
    dimensions, and None when the codec is not built (a machine with
    neither route: the store's ``fmt="auto"`` probe then resolves to
    BGR)."""
    lib = _codec()
    if lib is None or not path.lower().endswith((".jpg", ".jpeg")):
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    buf = lib.tm_decode_jpeg_yuv420(path.encode(), ctypes.byref(w),
                                    ctypes.byref(h))
    if not buf:
        return None
    try:
        arr = np.ctypeslib.as_array(
            buf, shape=_i420_rows(h.value, w.value)).copy()
    finally:
        lib.tm_free(buf)
    return arr


def decode_batch_yuv420_native(paths: List[str], n_threads: int = 4
                               ) -> Optional[List[Optional[np.ndarray]]]:
    """Thread-pool batch of :func:`decode_image_yuv420_native`
    (``tm_decode_jpeg_batch_yuv420``); entries that are not 4:2:0 JPEGs
    with even dimensions, or do not decode, are None. None when the codec
    is not built."""
    lib = _codec()
    if lib is None:
        return None
    return _jpeg_only(paths, lambda ps: _batch(
        lib, "tm_decode_jpeg_batch_yuv420", ps, n_threads, _i420_rows))


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
