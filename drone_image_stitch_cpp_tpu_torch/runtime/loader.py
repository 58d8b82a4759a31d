"""Image ingest: directory scan, decode, ID extraction.

Capability parity: ImageLoader::load / loadWithIds (reference:
image_loader.cpp:28-61, 63-95) — case-insensitive extension filter,
lexicographic filename sort, decode-failure skipping, ID = filename prefix
before the first '_' (else the stem), minimum-count guards.

The decode itself prefers the native C extension (native/decode.c, built as
a small shared library around libjpeg/stb) and falls back to cv2/PIL —
decode is host-side work feeding the device (runtime/feed.FrameStore moves
the decoded frames to the card once). A copy of the JAX package's loader.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

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


def _decode_bgr(path: str) -> Optional[np.ndarray]:
    """Decode to HxWx3 uint8 BGR; None on failure (loader skips bad files)."""
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


def _decode_all(paths: List[str]) -> List[Optional[np.ndarray]]:
    """Parallel decode preserving per-file failures as None entries.

    Pipeline-parallel ingest: the native libjpeg pool (native/decode.cpp)
    decodes a pure-JPEG folder on host threads; otherwise a thread pool of
    per-file decodes (cv2/PIL release the GIL). Per-file failure keeps the
    reference's skip-unreadable semantics (image_loader.cpp:52-59).
    """
    import concurrent.futures as cf
    import os

    from ..utils.native import decode_batch_native

    n_threads = min(8, (os.cpu_count() or 1) * 2)
    out = decode_batch_native(list(paths), n_threads=n_threads)
    if out is not None:
        return out
    with cf.ThreadPoolExecutor(max_workers=n_threads) as ex:
        return list(ex.map(_decode_bgr, paths))


def load_with_ids(folder: str) -> LoadedImages:
    """Reference ImageLoader::loadWithIds: >= 1 usable image required."""
    paths = _scan(folder, _EXTS_LOAD_IDS)
    images, ids, kept = [], [], []
    for p, img in zip(paths, _decode_all(paths)):
        if img is None:
            print(f"[Loader] skipping unreadable file: {p}")
            continue
        images.append(img)
        ids.append(extract_image_id(p))
        kept.append(p)
    if not images:
        raise RuntimeError(f"no readable images in {folder}")
    return LoadedImages(images=images, ids=ids, paths=kept)
