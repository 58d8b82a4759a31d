"""The DP seam's min-cost vertical path: ``csrc/dp_seam.cu`` and its plain
version.

The JAX package's recurrence (``ops/seam._vertical_seam_path``) is a
lax.scan over rows and a backward scan over the move table. The plain
version here runs it as a host loop of a few launches a row, then fetches
the move table and backtracks on the host; CPU tensors take it. CUDA
tensors launch the kernel: one block walks every row on the device and
backtracks there, so a scan is one launch whatever its height. Both give
the same path bit for bit (ties to the lower offset, one float32 add a
row, the last row's first minimum).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..runtime.kernels import load_kernel, stream_handle

KERNEL_SOURCE = "dp_seam.cu"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL_SIGNATURES = {
    # cost, row stride, h, w, scratch, move table, path, stream
    "dp_seam_path": (_I, [_P, _LL, _I, _I, _P, _P, _P, _P]),
    "dp_seam_smem_bytes": (_LL, [_I]),
}
_INF = 3e38


def seam_path_plain(cost: torch.Tensor) -> torch.Tensor:
    """Min-cost top-to-bottom path through an (H, W) float32 cost; per-row
    x index (H,) long. Ties go to the lower offset (-1, 0, +1), as
    jnp.argmin does."""
    h, w = cost.shape
    offs = torch.zeros((h, w), dtype=torch.int8, device=cost.device)
    inf = torch.full((1,), _INF, dtype=torch.float32, device=cost.device)
    prev = cost[0]
    for r in range(1, h):
        stacked = torch.stack([torch.cat([inf, prev[:-1]]), prev,
                               torch.cat([prev[1:], inf])])
        best, arg = torch.min(stacked, dim=0)
        offs[r] = (arg - 1).to(torch.int8)
        prev = cost[r] + best
    offs_h = offs.cpu().numpy()
    xs = np.empty(h, np.int64)
    xs[h - 1] = int(torch.argmin(prev))
    for r in range(h - 1, 0, -1):
        xs[r - 1] = min(max(xs[r] + int(offs_h[r, xs[r]]), 0), w - 1)
    return torch.from_numpy(xs).to(cost.device)


def _launch(cost: torch.Tensor) -> torch.Tensor:
    fns = load_kernel(KERNEL_SOURCE, KERNEL_SIGNATURES).fns
    h, w = cost.shape
    dev = cost.device
    offs = torch.empty((h, w), dtype=torch.int8, device=dev)
    xs = torch.empty((h,), dtype=torch.int64, device=dev)
    scratch = None
    if fns["dp_seam_smem_bytes"](w) == 0:
        scratch = torch.empty((2 * w,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fns["dp_seam_path"](
            cost.data_ptr(), cost.stride(0), h, w,
            None if scratch is None else scratch.data_ptr(),
            offs.data_ptr(), xs.data_ptr(), stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"dp_seam_path launch failed: cudaError {err}")
    return xs


def seam_path(cost: torch.Tensor) -> torch.Tensor:
    """:func:`seam_path_plain`'s path. CUDA tensors launch
    ``csrc/dp_seam.cu`` once (counted in ``seam_path.launches``); CPU
    tensors run the plain version."""
    if cost.ndim != 2 or cost.dtype != torch.float32 or min(cost.shape) < 1:
        raise ValueError("cost must be a non-empty (H, W) float32 tensor, "
                         f"got {tuple(cost.shape)} {cost.dtype}")
    if cost.device.type != "cuda":
        return seam_path_plain(cost)
    if cost.stride(1) != 1:
        cost = cost.contiguous()
    seam_path.launches += 1
    return _launch(cost)


seam_path.launches = 0
