"""Device resolution and description.

The JAX package's runtime/device.py picks a backend and degrades to the
host CPU on accelerator faults. The port does neither: the device is
named explicitly, ``cuda`` without a visible card is an error, and a
fault on the card surfaces as an exception (a CPU re-run would hide that
the card path failed). A run's device spec resolves to a device list
(:func:`resolve_devices`): ``cuda`` is every visible card.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import List, Optional, Union

import torch


class DeviceUnavailableError(RuntimeError):
    """The requested device does not exist on this machine."""


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device`` for ``device``; raises when it names a CUDA card
    that is not there. ``cpu`` is allowed (the tests run the plain
    versions of the kernels there) but is never chosen silently."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                f"device {device!r} requested but torch.cuda.is_available() "
                f"is False (torch {torch.__version__}, "
                f"CUDA {torch.version.cuda})")
        idx = (dev.index if dev.index is not None
               else torch.cuda.current_device())
        if idx >= torch.cuda.device_count():
            raise DeviceUnavailableError(
                f"device {device!r}: only {torch.cuda.device_count()} "
                f"CUDA device(s) visible")
        dev = torch.device("cuda", idx)
    elif dev.type != "cpu":
        raise DeviceUnavailableError(f"unsupported device {device!r}")
    return dev


def resolve_devices(spec) -> List[torch.device]:
    """The device list a run places its work on
    (``parallel/mesh.make_mesh``): ``"cuda"`` is every visible card,
    ``"cuda:N"`` that card alone, ``"cpu"`` the one CPU device, and a list
    or tuple names its devices (repeats allowed). Raises
    DeviceUnavailableError where :func:`resolve_device` does, and for an
    empty list."""
    from ..parallel.mesh import make_mesh

    if isinstance(spec, (list, tuple)):
        if not spec:
            raise DeviceUnavailableError("empty device list")
        return [resolve_device(d) for d in spec]
    dev = torch.device(spec)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)         # the error of a machine without a card
        return make_mesh(platform="cuda")
    return [resolve_device(dev)]


def placement(device, home: Optional[torch.device] = None
              ) -> List[torch.device]:
    """The devices of a library call's ``device`` argument: one device,
    or a list whose first entry is home (the frames live there and the
    results come back there) and over which the call spreads its pair
    chunks or compose tiles. None means ``[home]``. Raises ValueError
    when no device is given, or when ``home`` (the device of a frame
    store the call reads) is not the first."""
    if device is None:
        devs = [] if home is None else [home]
    elif isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
    else:
        devs = [torch.device(device)]
    if not devs:
        raise ValueError("no device given: pass a device or a store")
    if home is not None and devs[0] != home:
        raise ValueError(f"the frames are on {home}, not on the first "
                         f"device {devs[0]}")
    return devs


def device_sync(device: torch.device):
    """A callable that waits for ``device``'s queued work (no-op on CPU)."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return None


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` as the card reports it
    (first card), or a note saying why it could not be read."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    if out.returncode != 0:
        return f"nvidia-smi rc={out.returncode}: {out.stderr.strip()[:200]}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def describe_device(device: torch.device) -> dict:
    """Name, count and (on the card) power limit for logs and results."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
            "nvidia_smi": card_name_and_power_limit()}
