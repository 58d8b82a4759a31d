"""The lower-precision control of each traffic kind: what the check must
fail. Each is a patch applied to a kind's object after set-up.

* ``sortie``: the program's own float32 path of its bundle adjust
  (``pipeline/bundle.bundle_adjust_similarity(dtype=torch.float32)``,
  the precision the JAX package solves in), in place of the float64 the
  configuration states. The program has the option, so the control is
  the program with it switched on.
* ``triage``, two, one a layer: ``bf16_warp``, the reference warp put
  in place of the program's warp stage, its planes and results stored in
  bfloat16 (the arithmetic in float32): the next precision below the
  configuration's float32 images and warps, which hold no matrix product
  for TF32 to reach; ``bf16_keypoints``, the keypoint coordinates that
  detection hands to registration (match and RANSAC) rounded to
  bfloat16, the next precision below their float32.
"""

from __future__ import annotations

import functools

import torch

from .reference import warp_plane


def _sortie_float32_bundle_adjust(kind):
    from drone_image_stitch_cpp_tpu_torch.pipeline import strip
    if getattr(strip.bundle_adjust_similarity, "control", False):
        return
    patched = functools.partial(strip.bundle_adjust_similarity,
                                dtype=torch.float32)
    patched.control = True
    strip.bundle_adjust_similarity = patched


def bf16_warp_sums(frames, models):
    """The reference's warp sums of a (N, H, W) batch by the pairs'
    models, its planes and results stored in bfloat16."""
    h, w = frames.shape[1:]
    a23 = models[:, :2, :].cpu().numpy()
    return torch.stack([warp_plane(frames[i + 1], a, h, w,
                                   dtype=torch.float32,
                                   store=torch.bfloat16).sum()
                        for i, a in enumerate(a23)])


def _triage_bf16_warp(kind):
    kind.warp_sums = bf16_warp_sums


def _triage_bf16_keypoints(kind):
    real = kind.register

    def register(feats, banks):
        xy = feats.xy.to(torch.bfloat16).to(feats.xy.dtype)
        return real(feats._replace(xy=xy), banks)
    kind.register = register


CONTROLS = {"sortie": {"f32_bundle_adjust": _sortie_float32_bundle_adjust},
            "triage": {"bf16_warp": _triage_bf16_warp,
                       "bf16_keypoints": _triage_bf16_keypoints}}


def controls_for(cell):
    """{name: control patch} of ``cell``'s traffic kind."""
    from .harness import load_cell
    return CONTROLS[load_cell(cell)[2]["kind"]]
