"""SIFT-class feature detection + 128-d descriptors, batched over frames.

Port of ``drone_image_stitch_cpp_tpu/ops/features.py``, following the
batched kernel path of ``detect_and_describe_batched`` (features.py:
710-811): build the scale space of a (B, H, W) batch, find 3x3x3 DoG
extrema per octave, refine them densely, select the top ``max_kp`` per
frame across octaves, then describe the survivors with ONE launch of K1
(ops/sift_kernel.py) over a flat (L, H, W) Gaussian stack with
per-keypoint octave sizes. OpenCV SIFT constants; a single dominant
orientation per keypoint; fixed-capacity outputs with a validity mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .gaussian import gaussian_blur
from .resize import resize_linear
from .sift_kernel import orientation_descriptor_flat

_SIGMA0 = 1.6                 # base scale of octave layer 0
_INIT_SIGMA = 0.5             # assumed blur of the input image
_MAX_REFINE_ITERS = 5
_MAX_OCTAVES = 4


class Features(NamedTuple):
    """Fixed-capacity keypoint sets; leading axis = frame."""

    xy: torch.Tensor        # (B, K, 2) float32 — x, y in input pixels
    sigma: torch.Tensor     # (B, K) float32
    angle: torch.Tensor     # (B, K) float32 — radians, y-up
    response: torch.Tensor  # (B, K) float32 — |refined DoG contrast|
    desc: torch.Tensor      # (B, K, 128) float32
    valid: torch.Tensor     # (B, K) bool


def num_octaves(h: int, w: int, upsample: bool) -> int:
    """Octave count from image size (OpenCV formula, capped)."""
    m = min(h, w) * (2 if upsample else 1)
    n = int(round(math.log2(max(m, 4)))) - 2
    return max(1, min(n, _MAX_OCTAVES))


def _layer_sigmas(n_layers: int) -> np.ndarray:
    """Incremental blur to go from layer i to layer i+1 within an octave."""
    k = 2.0 ** (1.0 / n_layers)
    out = np.zeros(n_layers + 3, dtype=np.float64)
    for i in range(1, n_layers + 3):
        prev = _SIGMA0 * (k ** (i - 1))
        total = prev * k
        out[i] = math.sqrt(total * total - prev * prev)
    return out


def build_scale_space(grays: torch.Tensor, n_layers: int, n_oct: int,
                      upsample: bool):
    """Per-octave (gauss (B, S, Ho, Wo), dog (B, S-1, Ho, Wo)) of a
    (B, H, W) batch, S = n_layers + 3."""
    b, h, w = grays.shape
    x = grays.to(torch.float32)
    if upsample:
        x = resize_linear(x, h * 2, w * 2, channels_last=False)
        d = math.sqrt(max(_SIGMA0 ** 2 - (2 * _INIT_SIGMA) ** 2, 0.01))
    else:
        d = math.sqrt(max(_SIGMA0 ** 2 - _INIT_SIGMA ** 2, 0.01))
    base = gaussian_blur(x, d, channels_last=False)
    incr = _layer_sigmas(n_layers)
    octaves = []
    for _ in range(n_oct):
        layers = [base]
        for i in range(1, n_layers + 3):
            layers.append(gaussian_blur(layers[-1], float(incr[i]),
                                        channels_last=False))
        g = torch.stack(layers, dim=1)
        octaves.append((g, g[:, 1:] - g[:, :-1]))
        base = layers[n_layers][:, ::2, ::2]
    return octaves


def _extrema_candidates(dog: torch.Tensor, prelim_thresh: float, k: int,
                        lim=None):
    """Top-k 3-D extrema per frame of a (B, S, H, W) DoG stack.

    Returns (idx (B, k, 3) long (layer, y, x), score (B, k), valid (B, k)).
    A pixel qualifies iff it equals its 3x3x3 max (or min), |value|
    exceeds the preliminary threshold, and it is not on the border
    layer/row/col. ``lim``: optional (B, 2) float (h_lim, w_lim) in octave
    pixels; pixels at or beyond a frame's limit are excluded before the
    selection (mixed-size frames padded to one batch). The selection is a
    stable descending sort, so ties keep the lower flat index first
    (jax.lax.top_k's order).
    """
    b, s, h, w = dog.shape
    mx = F.max_pool3d(dog[:, None], 3, stride=1, padding=1)[:, 0]
    mn = -F.max_pool3d(-dog[:, None], 3, stride=1, padding=1)[:, 0]
    is_ext = ((dog >= mx) | (dog <= mn)) & (dog.abs() > prelim_thresh)
    border = torch.zeros((s, h, w), dtype=torch.bool, device=dog.device)
    border[1:s - 1, 1:h - 1, 1:w - 1] = True
    if lim is not None:
        yi = torch.arange(h, device=dog.device, dtype=torch.float32)
        xi = torch.arange(w, device=dog.device, dtype=torch.float32)
        border = (border[None]
                  & (yi[None, None, :, None] < lim[:, 0, None, None, None])
                  & (xi[None, None, None, :] < lim[:, 1, None, None, None]))
    score = torch.where(is_ext & border, dog.abs(),
                        torch.full_like(dog, -1.0))
    flat = score.reshape(b, -1)
    k = min(k, flat.shape[1])
    top, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    ls = idx // (h * w)
    ys = (idx % (h * w)) // w
    xs = idx % w
    return torch.stack([ls, ys, xs], dim=-1), top, top > 0.0


def _dense_refine_fields(dog: torch.Tensor, n_layers: int,
                         contrast_thresh: float, edge_thresh: float):
    """Dense per-pixel Newton-step fields over a (B, S, H, W) DoG stack:
    (jump, done, offx, offy, offl, contrast, gates), each (B, S*H*W).
    ``jump`` is the flat index of the next iterate (self when converged)."""
    b, s, h, w = dog.shape
    padded = F.pad(dog, (1, 1, 1, 1, 1, 1))

    def sh(dl, dy, dx):
        return padded[:, 1 + dl:1 + dl + s, 1 + dy:1 + dy + h,
                      1 + dx:1 + dx + w]

    c = dog
    gx = 0.5 * (sh(0, 0, 1) - sh(0, 0, -1))
    gy = 0.5 * (sh(0, 1, 0) - sh(0, -1, 0))
    gl = 0.5 * (sh(1, 0, 0) - sh(-1, 0, 0))
    dxx = sh(0, 0, 1) + sh(0, 0, -1) - 2 * c
    dyy = sh(0, 1, 0) + sh(0, -1, 0) - 2 * c
    dss = sh(1, 0, 0) + sh(-1, 0, 0) - 2 * c
    dxy = 0.25 * (sh(0, 1, 1) - sh(0, 1, -1) - sh(0, -1, 1) + sh(0, -1, -1))
    dxs = 0.25 * (sh(1, 0, 1) - sh(1, 0, -1) - sh(-1, 0, 1) + sh(-1, 0, -1))
    dys = 0.25 * (sh(1, 1, 0) - sh(1, -1, 0) - sh(-1, 1, 0) + sh(-1, -1, 0))

    # adjugate solve of [dxx dxy dxs; dxy dyy dys; dxs dys dss] off = -g
    co00 = dyy * dss - dys * dys
    co01 = dxs * dys - dxy * dss
    co02 = dxy * dys - dxs * dyy
    co11 = dxx * dss - dxs * dxs
    co12 = dxy * dxs - dxx * dys
    co22 = dxx * dyy - dxy * dxy
    det = dxx * co00 + dxy * co01 + dxs * co02
    safe = det.abs() > 1e-10
    inv_det = -1.0 / torch.where(safe, det, torch.ones_like(det))
    ten = torch.full_like(det, 10.0)
    offx = torch.where(safe, (co00 * gx + co01 * gy + co02 * gl) * inv_det,
                       ten)
    offy = torch.where(safe, (co01 * gx + co11 * gy + co12 * gl) * inv_det,
                       ten)
    offl = torch.where(safe, (co02 * gx + co12 * gy + co22 * gl) * inv_det,
                       ten)
    done = ((offx.abs() < 0.5) & (offy.abs() < 0.5) & (offl.abs() < 0.5)
            & safe)

    dev = dog.device
    li = torch.arange(s, device=dev).view(1, s, 1, 1)
    yi = torch.arange(h, device=dev).view(1, 1, h, 1)
    xi = torch.arange(w, device=dev).view(1, 1, 1, w)

    def step(o):
        # huge steps (near-singular solves) saturate before the clip
        return torch.round(o.clamp(-1e9, 1e9)).long()

    xn = (xi + step(offx)).clamp(1, w - 2)
    yn = (yi + step(offy)).clamp(1, h - 2)
    ln = (li + step(offl)).clamp(1, s - 2)
    jump = torch.where(done, li * (h * w) + yi * w + xi,
                       ln * (h * w) + yn * w + xn).reshape(b, -1)

    contrast = c + 0.5 * (gx * offx + gy * offy + gl * offl)
    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    r = edge_thresh
    gates = ((contrast.abs() * n_layers >= contrast_thresh)
             & (det2 > 0) & (tr * tr * r < (r + 1) * (r + 1) * det2)
             & (offx.abs() < 1.5) & (offy.abs() < 1.5) & (offl.abs() < 1.5))
    flat = [a.reshape(b, -1) for a in (done, offx, offy, offl, contrast,
                                       gates)]
    return (jump, *flat)


def _refine_dense(dog: torch.Tensor, cand: torch.Tensor, n_layers: int,
                  contrast_thresh: float, edge_thresh: float):
    """Refine (B, K, 3) candidates by chasing the dense jump field
    ``_MAX_REFINE_ITERS`` times. Returns (lf, yf, xf, |contrast|, ok)."""
    _, s, h, w = dog.shape
    jump, done, offx, offy, offl, contrast, gates = _dense_refine_fields(
        dog, n_layers, contrast_thresh, edge_thresh)
    p = cand[..., 0] * (h * w) + cand[..., 1] * w + cand[..., 2]
    for _ in range(_MAX_REFINE_ITERS):
        p = jump.gather(1, p)
    ok = done.gather(1, p) & gates.gather(1, p)
    zero = torch.zeros((), dtype=torch.float32, device=dog.device)
    ox = torch.where(ok, offx.gather(1, p), zero)
    oy = torch.where(ok, offy.gather(1, p), zero)
    ol = torch.where(ok, offl.gather(1, p), zero)
    li = p // (h * w)
    yi = (p % (h * w)) // w
    xi = p % w
    return (li.to(torch.float32) + ol, yi.to(torch.float32) + oy,
            xi.to(torch.float32) + ox, contrast.gather(1, p).abs(), ok)


class KeypointSelection(NamedTuple):
    """Survivors of detection, ready for the descriptor kernel (K1)."""

    gauss_flat: torch.Tensor   # (B*NO*S, H0, W0) float32 Gaussian stack
    flat_layer: torch.Tensor   # (B, k) long index into gauss_flat
    yf: torch.Tensor           # (B, k) octave-pixel coordinates
    xf: torch.Tensor
    sigma: torch.Tensor        # (B, k) octave-pixel scale
    true_h: torch.Tensor       # (B, k) the keypoint's own octave size
    true_w: torch.Tensor
    octave: torch.Tensor       # (B, k) long
    response: torch.Tensor     # (B, k)
    valid: torch.Tensor        # (B, k) bool
    scale0: float              # octave-0 pixel size in input pixels


def flat_gauss_stack(octs) -> torch.Tensor:
    """One flat (B*NO*S, H0, W0) stack of the Gaussian layers of
    ``build_scale_space``'s octaves: every octave pads (edge mode) to
    octave 0's dims so one stack serves all keypoints; flat index =
    (b*NO + octave)*S + layer. A keypoint's true size is its own octave's,
    so pad taps never count."""
    b, s_tot, h0, w0 = octs[0][0].shape
    gps = []
    for g, _ in octs:
        ho, wo = g.shape[2], g.shape[3]
        gps.append(g if (ho, wo) == (h0, w0) else
                   F.pad(g, (0, w0 - wo, 0, h0 - ho), mode="replicate"))
    return torch.stack(gps, dim=1).reshape(b * len(octs) * s_tot, h0, w0)


def select_keypoints(grays: torch.Tensor, max_kp: int,
                     contrast_thresh: float = 0.04,
                     edge_thresh: float = 10.0, n_layers: int = 3,
                     upsample: bool = False,
                     true_hw=None) -> KeypointSelection:
    """Scale space, extrema, dense refinement and the per-frame top
    ``max_kp`` by response of a (B, H, W) float gray batch in [0, 255].
    ``true_hw``: optional (B, 2) true (h, w) of frames padded to the
    batch's size: extrema at or beyond a frame's size are excluded, and
    each keypoint's true size (what K1 masks its gradients by) is its own
    frame's size in its octave; without it, the octave's array size."""
    b, h, w = grays.shape
    n_oct = num_octaves(h, w, upsample)
    prelim = 0.5 * contrast_thresh / n_layers * 255.0
    contrast_abs = contrast_thresh * 255.0
    scale0 = 0.5 if upsample else 1.0
    octs = build_scale_space(grays, n_layers, n_oct, upsample)
    dev = grays.device
    if true_hw is not None:
        true_hw = torch.as_tensor(true_hw, dtype=torch.float32, device=dev)

    # phase 1: candidates + dense refinement per octave
    fields = []
    own = []            # per octave: (B, 2) frame sizes in octave pixels
    for o, (g, dog) in enumerate(octs):
        k_oct = max(max_kp >> o, min(128, max_kp))
        lim = None
        size = torch.tensor([[float(g.shape[2]), float(g.shape[3])]],
                            device=dev).expand(b, 2)
        if true_hw is not None:
            lim = true_hw / (scale0 * 2.0 ** o)
            size = torch.minimum(torch.ceil(lim), size)
        own.append(size)
        cand, _, cvalid = _extrema_candidates(dog, prelim, k_oct, lim)
        lf, yf, xf, resp, ok = _refine_dense(dog, cand, n_layers,
                                             contrast_abs, edge_thresh)
        ok = ok & cvalid
        sig = _SIGMA0 * torch.pow(2.0, lf / n_layers)
        li = torch.round(lf).long().clamp(1, n_layers)
        oct_id = torch.full_like(li, o)
        fields.append((yf, xf, resp, ok, li, sig, oct_id))
    yf, xf, resp, ok, li, sig, oct_id = (
        torch.cat([f[i] for f in fields], dim=1) for i in range(7))

    # phase 2: per-frame top-k by refined response (stable, like top_k)
    score = torch.where(ok, resp, torch.full_like(resp, -1.0))
    k_sel = min(max_kp, score.shape[1])
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :k_sel], idx[:, :k_sel]

    def take(a):
        return a.gather(1, idx)

    oct_s = take(oct_id)
    s_tot = n_layers + 3
    frame = torch.arange(b, device=dev)[:, None]
    own_hw = torch.stack(own, dim=1)                    # (B, n_oct, 2)
    kp_hw = own_hw[frame.expand_as(oct_s), oct_s]       # (B, k, 2)
    return KeypointSelection(
        gauss_flat=flat_gauss_stack(octs),
        flat_layer=(frame * n_oct + oct_s) * s_tot + take(li),
        yf=take(yf), xf=take(xf), sigma=take(sig), true_h=kp_hw[..., 0],
        true_w=kp_hw[..., 1], octave=oct_s, response=take(resp),
        valid=take(ok) & (top > 0.0), scale0=scale0)


def detect_and_describe_batched(grays: torch.Tensor, max_kp: int,
                                contrast_thresh: float = 0.04,
                                edge_thresh: float = 10.0,
                                n_layers: int = 3,
                                upsample: bool = False,
                                true_hw=None) -> Features:
    """Detect up to ``max_kp`` keypoints per frame of a (B, H, W) float
    gray batch in [0, 255] and describe them with ONE K1 launch.
    ``true_hw``: optional (B, 2) true sizes of mixed-size frames padded to
    the batch (:func:`select_keypoints`)."""
    sel = select_keypoints(grays, max_kp, contrast_thresh, edge_thresh,
                           n_layers, upsample, true_hw)
    ang, desc = orientation_descriptor_flat(
        sel.gauss_flat, sel.flat_layer, sel.yf, sel.xf, sel.sigma,
        sel.true_h, sel.true_w, mixed=true_hw is not None)
    mult = sel.scale0 * torch.pow(2.0, sel.octave.to(torch.float32))
    feats = Features(
        xy=torch.stack([sel.xf, sel.yf], dim=-1) * mult[..., None],
        sigma=sel.sigma * mult, angle=ang, response=sel.response,
        desc=desc, valid=sel.valid)
    k_sel = sel.valid.shape[1]
    if k_sel < max_kp:  # pad to the static budget with invalid rows
        feats = Features(*(_pad_rows(a, max_kp - k_sel) for a in feats))
    return feats


_DESC_D = 4        # 4x4 spatial bins
_DESC_BINS = 8     # orientation bins


def mirror_features(feats: Features, width) -> Features:
    """Exact horizontal-flip transport of a feature set (the JAX
    package's closed form, features.py:564): under x' = w-1-x the
    keypoints map to (w-1-x, y) with the same sigma and response, the
    dominant angle to pi - angle, and the descriptor bin (row, col, ori)
    to (D-1-row, col, -ori mod 8). ``width``: the true image width in the
    units of ``feats.xy``. Any leading batch dims."""
    xy = torch.stack([float(width) - 1.0 - feats.xy[..., 0],
                      feats.xy[..., 1]], dim=-1)
    angle = torch.remainder(math.pi - feats.angle, 2.0 * math.pi)
    lead = feats.desc.shape[:-1]
    d = feats.desc.reshape(*lead, _DESC_D, _DESC_D, _DESC_BINS).flip(-3)
    d = torch.cat([d[..., :1], d[..., 1:].flip(-1)], dim=-1)
    return feats._replace(xy=xy, angle=angle, desc=d.reshape(
        *lead, _DESC_D * _DESC_D * _DESC_BINS))


def _pad_rows(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Append ``pad`` zero (False) rows along the keypoint axis (dim 1)."""
    z = torch.zeros((a.shape[0], pad) + tuple(a.shape[2:]), dtype=a.dtype,
                    device=a.device)
    return torch.cat([a, z], dim=1)
