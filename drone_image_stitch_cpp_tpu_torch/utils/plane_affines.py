"""The affines that hold K2's single-plane inverse (the float32 LU of
``ops/warp_kernel.inverse_coeffs``, in ``csrc/affine_inverse.cuh``) to its
plain versions: numpy only, so the tests on the CPU, the tests on the card
(run without JAX) and ``chip_smoke.py`` check it on the same ones.
"""

import numpy as np


def bench_affines() -> np.ndarray:
    """200 (2, 3) float32 src->dst affines (seed 11): any rotation (row
    pivots included), scales 0.05-3 with shear noise, canvas
    translations."""
    rng = np.random.default_rng(11)
    th = rng.uniform(-np.pi, np.pi, 200)
    s = rng.uniform(0.05, 3.0, 200)
    return np.stack([np.asarray(
        [[s[k] * np.cos(th[k]) + rng.normal(0, 0.05),
          -s[k] * np.sin(th[k]) * rng.uniform(0.5, 1.5),
          rng.uniform(-2e4, 2e4)],
         [s[k] * np.sin(th[k]), s[k] * np.cos(th[k]) + rng.normal(0, 0.05),
          rng.uniform(-3e3, 3e3)]], np.float32) for k in range(200)])


def wide_affines(n: int = 10000, seed: int = 13) -> np.ndarray:
    """``n`` (2, 3) float32 src->dst affines: rotations over the whole
    circle (about half of them pivot on the second row), scales drawn
    log-uniform in 0.05-3 per axis with shear, translations of either sign
    log-uniform in 0.1-3e9."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, n)
    sx, sy = np.exp(rng.uniform(np.log(0.05), np.log(3.0), (2, n)))
    shear = rng.normal(0.0, 0.1, n)
    c, s = np.cos(th), np.sin(th)
    lin = np.stack([np.stack([sx * c, -sy * s + shear * sx * c], -1),
                    np.stack([sx * s, sy * c + shear * sx * s], -1)], 1)
    t = (np.exp(rng.uniform(np.log(0.1), np.log(3e9), (n, 2)))
         * rng.choice([-1.0, 1.0], (n, 2)))
    return np.concatenate([lin, t[..., None]], -1).astype(np.float32)


def singular_affines() -> np.ndarray:
    """Affines with no inverse: linearly dependent rows, and a first
    column of zeros (a zero pivot)."""
    return np.asarray([[[1, 2, 0], [2, 4, 0]],
                       [[0, 3, 5], [0, 1, 1]]], np.float32)
