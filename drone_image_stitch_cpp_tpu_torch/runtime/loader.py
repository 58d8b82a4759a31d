"""Image ingest: directory scan, decode, ID extraction.

Capability parity: ImageLoader::load / loadWithIds (reference:
image_loader.cpp:28-61, 63-95) — case-insensitive extension filter,
lexicographic filename sort, decode-failure skipping, ID = filename prefix
before the first '_' (else the stem), minimum-count guards.

The decode prefers the JPEG codec built from native/decode.cpp (libjpeg,
``utils/native``) and falls back to cv2/PIL per file — decode is host-side
work feeding the device (runtime/feed.FrameStore moves the decoded frames
to the card once). A copy of the JAX package's loader.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

# extension set of the reference's loadWithIds (image_loader.cpp:64)
_EXTS_LOAD_IDS = {".jpg", ".jpeg", ".png", ".bmp", ".tiff"}


@dataclass
class LoadedImages:
    images: List[np.ndarray]  # HxWx3 uint8 BGR
    ids: List[str]
    paths: List[str]


def extract_image_id(filename: str) -> str:
    """Filename prefix before the first '_', else the stem.

    Reference: extract_image_id (image_loader.cpp:13-25).
    """
    stem = os.path.splitext(os.path.basename(filename))[0]
    pos = stem.find("_")
    return stem[:pos] if pos > 0 else stem


def _fallback_decoders() -> bool:
    """Whether cv2 or PIL can decode here (a machine may have neither; the
    JPEG codec built from native/ then decodes alone)."""
    import importlib.util
    return any(importlib.util.find_spec(m) is not None
               for m in ("cv2", "PIL"))


def _decode_bgr(path: str) -> Optional[np.ndarray]:
    """Decode to HxWx3 uint8 BGR; None on failure (loader skips bad
    files). The native codec first, then cv2, then PIL."""
    try:
        from ..utils.native import decode_image_native
        img = decode_image_native(path)
        if img is not None:
            return img
    except Exception:
        pass
    try:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is not None and img.size > 0:
            return img
    except Exception:
        pass
    try:
        from PIL import Image
        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"))
        return rgb[..., ::-1].copy()
    except Exception:
        return None


def _scan(folder: str, exts) -> List[str]:
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"image folder not found: {folder}")
    names = [n for n in os.listdir(folder)
             if os.path.splitext(n)[1].lower() in exts]
    names.sort()  # lexicographic (image_loader.cpp:44,77)
    return [os.path.join(folder, n) for n in names]


def _downscale(img: Optional[np.ndarray], denom: int
               ) -> Optional[np.ndarray]:
    """A full decode brought to 1/denom with cv2's area resize, as the JAX
    package does where libjpeg's DCT scaling is not available
    (runtime/feed.py:21-35: the same low-pass, a slower route)."""
    if img is None or denom == 1:
        return img
    import cv2
    return cv2.resize(img, (max(1, img.shape[1] // denom),
                            max(1, img.shape[0] // denom)),
                      interpolation=cv2.INTER_AREA)


def decode_all(paths: List[str], scale_denom: int = 1
               ) -> List[Optional[np.ndarray]]:
    """Parallel decode preserving per-file failures as None entries.

    The native codec's pthread pool decodes the JPEGs; a file it cannot
    decode (or any file, when the codec is not built) goes through a
    thread pool of per-file decodes (cv2/PIL release the GIL). Per-file
    failure keeps the reference's skip-unreadable semantics
    (image_loader.cpp:52-59). With no codec and neither cv2 nor PIL there
    is no decoder at all: that raises with the codec's reason.
    ``scale_denom`` (1, 2, 4 or 8) decodes at 1/denom resolution: libjpeg's
    DCT scaling in the codec, else a full decode and cv2's area resize.
    """
    import concurrent.futures as cf

    from ..utils.native import decode_batch_native, jpeg_codec_error

    if jpeg_codec_error() is not None and not _fallback_decoders():
        raise RuntimeError(f"no image decoder: JPEG codec unavailable "
                           f"({jpeg_codec_error()}) and neither cv2 nor "
                           f"PIL is installed")
    n_threads = min(8, (os.cpu_count() or 1) * 2)
    out: List[Optional[np.ndarray]] = [None] * len(paths)
    if jpeg_codec_error() is None:
        out = decode_batch_native(list(paths), n_threads=n_threads,
                                  scale_denom=scale_denom)
    redo = [i for i, img in enumerate(out) if img is None]
    if redo:
        with cf.ThreadPoolExecutor(max_workers=n_threads) as ex:
            for i, img in zip(redo, ex.map(_decode_bgr,
                                           [paths[i] for i in redo])):
                out[i] = _downscale(img, scale_denom)
    return out


def scan_with_ids(folder: str) -> Tuple[List[str], List[str]]:
    """Directory scan only: (paths, ids), no decode. The streaming ingest
    (``runtime/feed.FrameStore.from_paths``) decodes in the background;
    same extension set and order as loadWithIds (image_loader.cpp:63-95).
    """
    paths = _scan(folder, _EXTS_LOAD_IDS)
    return paths, [extract_image_id(p) for p in paths]


def load_with_ids(folder: str) -> LoadedImages:
    """Reference ImageLoader::loadWithIds: >= 1 usable image required."""
    paths = _scan(folder, _EXTS_LOAD_IDS)
    images, ids, kept = [], [], []
    for p, img in zip(paths, decode_all(paths)):
        if img is None:
            print(f"[Loader] skipping unreadable file: {p}")
            continue
        images.append(img)
        ids.append(extract_image_id(p))
        kept.append(p)
    if not images:
        raise RuntimeError(f"no readable images in {folder}")
    return LoadedImages(images=images, ids=ids, paths=kept)
