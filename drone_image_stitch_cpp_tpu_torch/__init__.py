"""Drone ortho-mosaicking on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of ``drone_image_stitch_cpp_tpu`` (the JAX/Pallas
package, which stays the reference): ingest -> visual flight-line
grouping -> per-strip stitching -> autocrop. Plain tensor code is PyTorch;
the two Pallas kernels of the reference are hand-written CUDA kernels for
``sm_90a`` under ``csrc/`` (SIFT orientation+descriptor, bilinear affine
warp), each with a plain PyTorch version beside it.

This package never imports ``jax``.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry solves (RANSAC refinement, bundle adjustment, gain systems) are
# precision-critical: TF32 products keep ~3 decimal digits and bias
# transform estimates the way bf16-class matmuls did on the TPU (the JAX
# package forces "highest" matmul precision for the same reason).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config.tuning import StitchTuning, load_stitch_tuning  # noqa: E402,F401
