"""Build-at-first-use of the CUDA kernels under ``csrc/``.

Each kernel source is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers: a build
takes seconds, not minutes). Libraries land in ``build/kernels/`` at the
repository root, keyed by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.

The C functions get their ``restype``/``argtypes`` once, when the library
loads; later calls of :func:`load_kernel` return the cached handles without
taking the lock. :func:`load_kernels` starts one ``nvcc`` per source
together and waits for all of them, so several kernels build in the time of
the slowest.

Nothing here runs at import time: the first launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C function name -> (restype, argtypes)
Signatures = Mapping[str, Tuple[type, List[type]]]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


@dataclass
class BuiltKernel:
    lib: ctypes.CDLL
    fns: Dict[str, Callable[..., int]]   # typed C entry points
    path: str
    seconds: float      # 0.0 when the library was already built
    ptxas: str          # nvcc's -Xptxas -v report (registers, smem, spills)


_LOCK = threading.Lock()
_BUILT: Dict[str, BuiltKernel] = {}


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels build only where the CUDA toolkit is "
        "installed")


def stream_handle(device: torch.device) -> int:
    """The cudaStream_t of PyTorch's current stream on ``device`` (a
    tensor's device, so it has an index): the value of
    ``torch.cuda.current_stream(device).cuda_stream``, read without
    building a Stream object, which costs microseconds per launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def load_kernel(source: str, signatures: Signatures) -> BuiltKernel:
    """Build (once per source hash) and load ``csrc/<source>``, typing the
    C functions named in ``signatures``."""
    built = _BUILT.get(source)
    if built is not None and signatures.keys() <= built.fns.keys():
        return built
    with _LOCK:
        if source not in _BUILT:
            _BUILT[source] = _build(source)
        built = _BUILT[source]
        for name, (restype, argtypes) in signatures.items():
            if name not in built.fns:
                fn = getattr(built.lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
                built.fns[name] = fn
        return built


def load_kernels(specs: Mapping[str, Signatures]) -> Dict[str, BuiltKernel]:
    """:func:`load_kernel` for several sources ({source: signatures}); the
    ``nvcc`` runs of the sources still to build are started together."""
    with _LOCK:
        started = []
        try:
            for source in specs:
                if source not in _BUILT:
                    started.append(_start_build(source))
            for job in started:
                _BUILT[job[0]] = _finish_build(job)
        finally:    # a failed build leaves no nvcc running and no output
            for _, _, proc, tmp, _ in started:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
                    os.unlink(tmp)
    return {s: load_kernel(s, sig) for s, sig in specs.items()}


def _build(source: str) -> BuiltKernel:
    return _finish_build(_start_build(source))


def _start_build(source: str):
    """Start ``nvcc`` on ``csrc/<source>`` unless its library exists:
    (source, library path, nvcc process or None, temporary output, t0)."""
    src_path = os.path.join(CSRC_DIR, source)
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if os.path.exists(lib_path):
        return source, lib_path, None, None, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return source, lib_path, proc, tmp, time.perf_counter()


def _finish_build(job) -> BuiltKernel:
    """Wait for a :func:`_start_build` job and load its library."""
    source, lib_path, proc, tmp, t0 = job
    log_path = lib_path + ".ptxas.txt"
    seconds = 0.0
    if proc is not None:
        _, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelBuildError(
                f"nvcc failed on {source} (rc={proc.returncode}):\n"
                f"{stderr[-4000:]}")
        with open(log_path, "w") as f:
            f.write(stderr)
        os.replace(tmp, lib_path)
    ptxas = ""
    if os.path.exists(log_path):
        with open(log_path) as f:
            ptxas = f.read()
    return BuiltKernel(lib=ctypes.CDLL(lib_path), fns={}, path=lib_path,
                       seconds=seconds, ptxas=ptxas)
