"""Checkpoint and resume at the strip -> global stage boundary.

Port of ``drone_image_stitch_cpp_tpu/runtime/checkpoint.py``, same format
on disk: ``strip_XX.npy`` (raw BGR uint8, lossless, so a resumed run's
mosaic is byte-identical to a straight run's) plus ``checkpoint.json``
``{"strips": [...], "version": 2}``. A checkpoint written by either
package loads in the other. The JAX package's version-1 PNG checkpoints
need cv2 and are not read: loading one returns None ("recompute").
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

_MANIFEST = "checkpoint.json"


def save_strip_checkpoint(ckpt_dir: str, strips: List[np.ndarray]) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    names = []
    for i, s in enumerate(strips):
        name = f"strip_{i:02d}.npy"
        np.save(os.path.join(ckpt_dir, name), np.ascontiguousarray(s))
        names.append(name)
    with open(os.path.join(ckpt_dir, _MANIFEST), "w") as f:
        json.dump({"strips": names, "version": 2}, f)


def load_strip_checkpoint(ckpt_dir: str) -> Optional[List[np.ndarray]]:
    """The checkpointed strips, or None when there is no complete
    version-2 checkpoint in ``ckpt_dir``."""
    path = os.path.join(ckpt_dir, _MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        manifest = json.load(f)
    strips = []
    for name in manifest.get("strips", []):
        fpath = os.path.join(ckpt_dir, name)
        if not name.endswith(".npy") or not os.path.exists(fpath):
            return None     # version 1 (PNG) or incomplete -> recompute
        strips.append(np.load(fpath))
    return strips if strips else None
