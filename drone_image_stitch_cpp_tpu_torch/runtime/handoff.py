"""Device-resident strip panorama handoff (strip stage -> global compose).

Port of ``DeviceStrip`` from ``drone_image_stitch_cpp_tpu/runtime/
handoff.py``. A strip whose canvas blends through tiles keeps its
panorama on the card as a uint8 canvas plus the exact content box from
the tiles' content flags; the global compose re-lays it into its common
padded layout on the device (:meth:`DeviceStrip.device_padded`), so the
pixels never cross to the host between the two stages. A host copy is
made only on request (:meth:`DeviceStrip.host`), losslessly; the app
calls it on its background writer thread (strip JPEG, checkpoint) while
the main thread stitches the next strip, so the handle is thread-safe:
one lock guards the host copy and the canvas, and the canvas is released
only once the global stage has consumed it AND the host copy exists.

The JAX package's jitted slice programs and the degrade-ladder recovery
are not ported (a device fault ends the run; ``--resume`` restarts it
from the strip checkpoint).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch


class DeviceStrip:
    """A strip panorama on the device.

    ``dev``: (CH, CW, 3) uint8 device canvas; ``bbox``: (y0, y1, x0, x1)
    exact content box inside it (exclusive ends). The panorama is
    ``dev[y0:y1, x0:x1]``.
    """

    def __init__(self, dev: torch.Tensor, bbox: Tuple[int, int, int, int]):
        y0, y1, x0, x1 = (int(v) for v in bbox)
        if not (0 <= y0 < y1 <= dev.shape[0] and 0 <= x0 < x1 <= dev.shape[1]):
            raise ValueError(f"bbox {bbox} outside the canvas "
                             f"{tuple(dev.shape)}")
        self.dev: Optional[torch.Tensor] = dev
        self.device = dev.device
        self.bbox = (y0, y1, x0, x1)
        self.hw = (y1 - y0, x1 - x0)
        self._host: Optional[np.ndarray] = None
        self._consumed = False
        self._lock = threading.Lock()

    @property
    def shape(self):
        """(h, w, 3) of the cropped panorama, like an ndarray's."""
        return (self.hw[0], self.hw[1], 3)

    def host(self) -> np.ndarray:
        """The cropped panorama as host BGR uint8 (copied once, cached)."""
        with self._lock:
            if self._host is None:
                if self.dev is None:
                    raise RuntimeError("DeviceStrip released without a host "
                                       "copy")
                y0, y1, x0, x1 = self.bbox
                self._host = np.ascontiguousarray(
                    self.dev[y0:y1, x0:x1].cpu().numpy())
                self._release_if_done()
            return self._host

    def mark_consumed(self) -> None:
        """The global stage has taken ``device_padded()``'s output: the
        canvas is released as soon as the host copy exists (at once if it
        does; else by the ``host()`` call that makes it)."""
        with self._lock:
            self._consumed = True
            self._release_if_done()

    def _release_if_done(self) -> None:
        # caller holds self._lock
        if self._consumed and self._host is not None:
            self.dev = None

    def device_padded(self, hp: int, wp: int) -> torch.Tensor:
        """The cropped content at the origin of a zero (hp, wp, 3) uint8
        tensor on the strip's device, copied on the device (from the host
        copy once the canvas is released). Needs hp, wp >= the crop."""
        h, w = self.hw
        if hp < h or wp < w:
            raise ValueError(f"pad ({hp}, {wp}) smaller than the strip "
                             f"({h}, {w})")
        out = torch.zeros((hp, wp, 3), dtype=torch.uint8, device=self.device)
        with self._lock:
            src = self.dev
            host = self._host
        if src is not None:
            y0, y1, x0, x1 = self.bbox
            out[:h, :w] = src[y0:y1, x0:x1]
        else:
            out[:h, :w] = torch.from_numpy(host).to(self.device)
        return out


def as_host_strips(strips) -> list:
    """A strips list (np.ndarray or DeviceStrip) as host arrays."""
    return [s.host() if isinstance(s, DeviceStrip) else s for s in strips]
