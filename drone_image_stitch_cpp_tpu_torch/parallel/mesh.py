"""Device lists and the two collectives of the sortie step.

Port of ``drone_image_stitch_cpp_tpu/parallel/mesh.py``. The JAX package
drives every chip of a host from one process through a 1-D mesh; the
port does the same with a list of ``torch.device``s: per-pair, per-strip
and per-tile work is placed on ``devices[k % N]``, and results come back
to ``devices[0]``. A list may name one device more than once (``[cpu] *
4`` in the tests, ``[cuda:0] * 2`` on one card): placement then changes
nothing but the schedule, which is what the equality tests check.

The collectives are host-ordered, so their results do not depend on
where the shards ran: :func:`all_gather` concatenates the shards in
shard order, :func:`psum` sums the partials in device order on
``devices[0]``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..runtime.device import DeviceUnavailableError


def make_mesh(n_devices: Optional[int] = None, *,
              platform: str) -> List[torch.device]:
    """The first ``n_devices`` devices of ``platform`` ("cuda" or "cpu"),
    all of them when ``n_devices`` is None. The platform is named, never
    chosen by what is visible (a missing card is an error, not the CPU).
    The CPU is one device. Raises DeviceUnavailableError when fewer than
    asked exist, rather than returning a shorter list (that would make
    every equality test over the list vacuous)."""
    if platform == "cuda":
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.device("cuda", i) for i in range(avail)]
    elif platform == "cpu":
        devs = [torch.device("cpu")]
    else:
        raise DeviceUnavailableError(f"unsupported platform {platform!r}")
    want = len(devs) if n_devices is None else n_devices
    if want < 1 or len(devs) < want:
        raise DeviceUnavailableError(
            f"make_mesh: requested {want} {platform} device(s), "
            f"{len(devs)} available")
    return devs[:want]


def all_gather(shards: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Every device's copy of the shards concatenated along dim 0 in
    shard order (``jax.lax.all_gather(..., tiled=True)``)."""
    return [torch.cat([s.to(d) for s in shards]) for d in devices]


def psum(partials: Sequence[torch.Tensor],
         devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The sum of the partials (one per device), taken in device order on
    ``devices[0]`` and copied back to each device (``jax.lax.psum``)."""
    total = partials[0].to(devices[0])
    for p in partials[1:]:
        total = total + p.to(devices[0])
    return [total.to(d) for d in devices]
