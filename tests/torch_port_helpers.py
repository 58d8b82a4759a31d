"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU (tests/conftest.py) and the port runs its plain kernel
versions on CPU tensors. One intra-op thread per test worker: the suite
runs under several pytest-xdist workers.
"""

import math

import jax
import numpy as np
import torch

torch.set_num_threads(1)

from drone_image_stitch_cpp_tpu.config.tuning import (  # noqa: E402
    StitchTuning as JaxTuning, tuning_as_dict)
from drone_image_stitch_cpp_tpu_torch.config.tuning import (  # noqa: E402
    from_jax_dict)

CPU = torch.device("cpu")


def small_tunings():
    """(JAX tuning, port tuning) with test_pipeline's small knobs; the
    port's copy is built from the JAX one, so both run the same knobs."""
    jt = JaxTuning(
        sift_features=512, strip_sift_features=512, global_sift_features=768,
        registration_resol_mpx=-1.0, seam_estimation_resol_mpx=-1.0,
        blend_bands=3)
    return jt, from_jax_dict(tuning_as_dict(jt))


def t(a, dtype=None):
    """numpy -> CPU tensor (copy)."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def n(a):
    """JAX array / tensor -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def ang_diff(a, b):
    return np.abs(np.mod(a - b + math.pi, 2 * math.pi) - math.pi)



def jax_banks(seed, n_pairs, n_hyp, m=2, chunk=16):
    """The (n_pairs, n_hyp, m) sample integers the JAX package's
    register_pairs draws (its per-pair keys; ``chunk`` is its chunk times
    the mesh size)."""
    n_keys = -(-n_pairs // chunk) * chunk
    keys = jax.random.split(jax.random.PRNGKey(seed), n_keys)[:n_pairs]
    return np.stack([np.asarray(jax.random.randint(
        k, (n_hyp, m), 0, np.iinfo(np.int32).max)) for k in keys])
