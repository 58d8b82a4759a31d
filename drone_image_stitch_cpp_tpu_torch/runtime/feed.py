"""Device frame store: same-shape BGR uint8 frames moved to the device once.

Port of the eager part of ``drone_image_stitch_cpp_tpu/runtime/feed.py::
FrameStore``. Grouping detect, strip registration and every compose feed
read the same decoded frames; the store copies each frame to the device
once, as uint8 (a 2160x3840 frame is 24.9 MB), and serves later passes by
indexing on the device. The JAX package's streaming decode, I420 wire
format and chunked transfers are not ported.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


class FrameStore:
    """Device-resident (N, H, W, 3) uint8 BGR frames."""

    def __init__(self, images: Sequence[np.ndarray], device: torch.device):
        if not images:
            raise ValueError("FrameStore needs at least one frame")
        shape = images[0].shape
        for i, im in enumerate(images):
            if im.shape != shape or im.dtype != np.uint8 or im.ndim != 3 \
                    or im.shape[2] != 3:
                raise ValueError(
                    f"FrameStore frames must be same-shape (H, W, 3) uint8 "
                    f"BGR; frame {i} is {im.shape} {im.dtype}, frame 0 "
                    f"{shape}")
        self.shape0 = tuple(shape)
        self.device = torch.device(device)
        self.frames = torch.empty((len(images),) + self.shape0,
                                  dtype=torch.uint8, device=self.device)
        for i, im in enumerate(images):
            self.frames[i].copy_(torch.from_numpy(np.ascontiguousarray(im)))

    def __len__(self) -> int:
        return self.frames.shape[0]

    def batch(self, indices: List[int]) -> torch.Tensor:
        """(len(indices), H, W, 3) uint8 on the device, for reading only:
        a run of consecutive indices is a view of the store, any other list
        a copy, so the result must not be written (a write would change
        the store for some index lists and not for others)."""
        indices = list(indices)
        if indices and indices == list(range(indices[0],
                                             indices[0] + len(indices))):
            return self.frames[indices[0]:indices[0] + len(indices)]
        idx = torch.as_tensor(indices, dtype=torch.long,
                              device=self.device)
        return self.frames.index_select(0, idx)

    def frame(self, i: int) -> torch.Tensor:
        return self.frames[i]

    def host_frame(self, i: int) -> np.ndarray:
        return self.frames[i].cpu().numpy()

    def clear(self) -> None:
        """Drop the device frames (the global stage needs the memory)."""
        self.frames = None
