"""Device-resident strip panorama handoff (strip stage -> global compose).

Port of ``DeviceStrip`` from ``drone_image_stitch_cpp_tpu/runtime/
handoff.py``. A strip whose canvas blends through tiles keeps its
panorama on the card as a uint8 canvas plus the exact content box from
the tiles' content flags; the global compose re-lays it into its common
padded layout on the device (:meth:`DeviceStrip.device_padded`), so the
pixels never cross to the host between the two stages. A host copy is
made only on request (:meth:`DeviceStrip.host`), losslessly.

The JAX package's jitted slice programs, its background-writer thread and
the degrade-ladder recovery are not ported.
"""

from __future__ import annotations

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

    @property
    def shape(self):
        """(h, w, 3) of the cropped panorama, like an ndarray's."""
        return (self.hw[0], self.hw[1], 3)

    def host(self) -> np.ndarray:
        """The cropped panorama as host BGR uint8 (copied once, cached)."""
        if self._host is None:
            if self.dev is None:
                raise RuntimeError("DeviceStrip released without a host copy")
            y0, y1, x0, x1 = self.bbox
            self._host = np.ascontiguousarray(
                self.dev[y0:y1, x0:x1].cpu().numpy())
        return self._host

    def mark_consumed(self) -> None:
        """The caller is done with the device canvas: release it (a host
        copy, if one was made, stays)."""
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
        if self.dev is not None:
            y0, y1, x0, x1 = self.bbox
            out[:h, :w] = self.dev[y0:y1, x0:x1]
        else:
            out[:h, :w] = torch.from_numpy(self.host()).to(self.device)
        return out
