"""Stitch tuning configuration: knob surface and modality presets.

A copy of ``drone_image_stitch_cpp_tpu/config/tuning.py`` trimmed to the
knobs the ported path reads (the JAX package cannot be imported here: its
``__init__`` imports jax). The OpenCL/GPU toggles and the camera
calibration are not carried: the device is chosen explicitly
(``--device``), and undistortion is not ported. Reference: the
``StitchTuning`` struct and preset loader of drone_image_stitch_cpp (stitch_config.hpp:50-100,
stitch_config.cpp:17-60,84-103).

The system has no weights; a ``StitchTuning`` is its whole state.
:func:`from_jax_dict` takes ``tuning_as_dict(...)`` output of the JAX
package so both packages run the same knobs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping


@dataclasses.dataclass
class StitchTuning:
    """Knob surface with reference defaults (stitch_config.hpp:50-100)."""

    # --- feature budgets -------------------------------------------------
    sift_features: int = 1500
    strip_sift_features: int = 1500
    global_sift_features: int = 2500

    # --- matching gates --------------------------------------------------
    match_conf: float = 0.35
    min_good_matches: int = 10
    min_inliers: int = 8

    # --- pair schedule ---------------------------------------------------
    use_range_matcher: bool = True
    range_width: int = 6

    # --- sequential fallback (stitch_robust.cpp:273-334) -------------------
    use_anchor_fallback: bool = False
    anchor_window: int = 4

    # --- model / warp selection ------------------------------------------
    use_affine_bundle: bool = True
    use_affine_warper: bool = True
    use_blocks_gain: bool = True

    # --- compose ----------------------------------------------------------
    blend_bands: int = 5
    pano_conf_thresh: float = 0.7

    # --- working resolutions (megapixels; <0 => full resolution) -----------
    registration_resol_mpx: float = 0.40
    seam_estimation_resol_mpx: float = 0.10
    compositing_resol_mpx: float = -1.0

    def replace(self, **kw) -> "StitchTuning":
        return dataclasses.replace(self, **kw)


def normalize_image_type(image_type: str) -> str:
    """Lowercase + strip non-alphanumerics, then alias-match; unknown
    types resolve to "visible" (stitch_config.cpp:6-15,89-99)."""
    norm = "".join(c for c in image_type.lower() if c.isalnum())
    if norm in {"visible", "vis", "rgb", "color", "colour", "eo"}:
        return "visible"
    if norm in {"nir", "nearinfrared", "nearir", "ir"}:
        return "nir"
    if norm in {"lwir", "thermal", "longwaveinfrared", "tir", "flir"}:
        return "lwir"
    return "visible"


_PRESETS = {
    # applyVisiblePreset (stitch_config.cpp:17-30)
    "visible": dict(
        sift_features=2200, strip_sift_features=2200,
        global_sift_features=3600, match_conf=0.35, range_width=6,
        blend_bands=5, registration_resol_mpx=0.45,
        seam_estimation_resol_mpx=0.12),
    # applyNirPreset (stitch_config.cpp:32-45)
    "nir": dict(
        sift_features=2800, strip_sift_features=2800,
        global_sift_features=4200, match_conf=0.40, range_width=7,
        blend_bands=5, registration_resol_mpx=0.55,
        seam_estimation_resol_mpx=0.15),
    # applyLwirPreset (stitch_config.cpp:47-60)
    "lwir": dict(
        sift_features=900, strip_sift_features=900,
        global_sift_features=1400, match_conf=0.48, range_width=4,
        blend_bands=3, registration_resol_mpx=0.30,
        seam_estimation_resol_mpx=0.08),
}


def load_stitch_tuning(image_type: str) -> StitchTuning:
    """Preset loader (stitch_config.cpp:84-103)."""
    preset = _PRESETS[normalize_image_type(image_type)]
    return StitchTuning().replace(
        compositing_resol_mpx=-1.0, use_range_matcher=True,
        use_affine_bundle=True, use_affine_warper=True, **preset)


def tuning_as_dict(t: StitchTuning) -> Dict[str, object]:
    return dataclasses.asdict(t)


# JAX knobs the port does not carry, with the values under which dropping
# them changes nothing: the OpenCL/GPU toggles chose the JAX backend, which
# ``--device`` does here.
_NOT_CARRIED = {
    "use_opencl": True,
    "try_gpu": True,
}


def from_jax_dict(d: Mapping[str, object]) -> StitchTuning:
    """The port's ``StitchTuning`` from the JAX package's
    ``tuning_as_dict`` output (plain Python / numpy scalar values).

    Every knob of the port must be present. Keys the port does not carry
    are accepted only at values under which leaving them out changes
    nothing (``_NOT_CARRIED``); any other value, or an unknown key,
    raises, so a JAX tuning that turns on an unported stage fails loudly.
    """
    fields = {f.name: f for f in dataclasses.fields(StitchTuning)}
    missing = sorted(set(fields) - set(d))
    extra = sorted(set(d) - set(fields) - set(_NOT_CARRIED))
    if missing or extra:
        raise ValueError(
            f"tuning dict mismatch: missing={missing} unknown={extra}")
    for name, need in _NOT_CARRIED.items():
        if name in d and need is not None and d[name] != need:
            raise ValueError(
                f"tuning {name}={d[name]!r} needs a stage the port does not "
                f"carry (only {need!r} is accepted)")
    kw = {}
    for name, f in fields.items():
        v = d[name]
        default = f.default
        if isinstance(default, bool):
            kw[name] = bool(v)
        elif isinstance(default, int):
            kw[name] = int(v)
        else:
            kw[name] = float(v)
    return StitchTuning(**kw)
