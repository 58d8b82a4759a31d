"""What the kernels are given to do, and the card's published peaks.

The counts read only a call's inputs (the Gaussian stack and keypoints
K1 receives; the planes and models K2 receives), never how a kernel does
its work, so a later kernel cannot move its own yardstick.

* :func:`k1_work` is ``_k1_work`` of ``chip_smoke.py`` at commit
  8b7ff0e672e454ed1a7cdb8444acc84ca8d92c55 with the descriptor square
  taken at angle 0 instead of K1's output angle: a square of the same
  area, so the count differs from the angle's only by the lattice points
  on its edge, and reads the inputs alone. ``K1_*_OPS`` and the byte
  count of :func:`k1_bound` are that file's.
* :func:`k2_plane_bound` is the smoke's bound of K2's single-plane form:
  each source pixel that a bilinear tap of an in-frame output touches is
  read once (4 B), each output pixel written once (4 B); 20 operations an
  output pixel.

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
SUPPORT_R = 40                 # K1's largest window half-size

# K1's float32 operations, counted from its plain version on what the
# function needs; a transcendental function counts as one, index
# arithmetic and comparisons as none
K1_GRAD_OPS = 9    # gx, gy (sub, x0.5 each), gx^2 + gy^2 (3), sqrt, atan2
K1_ORI_OPS = 10    # dy^2 + dx^2 (3), / 2 sig^2, exp, x mag, theta / 2pi x 36
#                    (2), round, the histogram add
K1_DESC_OPS = 62   # dx, dy (2); u, v (8); rbin, cbin (2); orientation bin
#                    (4); Gaussian weight (5); x mag; the 2 row, 2 column
#                    and 2 orientation hats that reach bins (3 each);
#                    14 products; 8 histogram adds
K1_KP_OPS = 36 * 7 + 36 + 10 + 128 * 9 + 2   # smoothing, argmax, peak,
#                    angle, sin, cos; two normalisations with clip, x512
K2_PLANE_OPS = 20  # operations an output pixel of the single-plane form


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory's rate and the operations over the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def support_radius(sigma_max: float) -> int:
    """K1's window half-size for keypoints of scale <= ``sigma_max``:
    descriptor support 2.5 * sqrt(2) * 3 sigma from a centre within 0.5
    px, plus the central-difference ring, at most :data:`SUPPORT_R`."""
    return int(min(np.ceil(float(sigma_max) * 10.61 + 0.5) + 1, SUPPORT_R))


def k1_work(gauss, layer, yf, xf, sigma, true_h, true_w):
    """What one K1 call needs on these keypoints (flat tensors): (stack
    pixels read, gradients, orientation-box terms, descriptor terms). A
    gradient is needed where it is valid in its octave and lies in the
    orientation box (|dy|, |dx| <= round(4.5 sigma) around the rounded
    centre) or in the descriptor square (rbin, cbin in (-1, 4), 3 sigma a
    bin, at angle 0); a stack pixel is read when it is one of a needed
    gradient's four central-difference taps, once however many keypoints
    share it."""
    l_, h_, w_ = gauss.shape
    dev = gauss.device
    used = torch.zeros((l_, h_, w_), dtype=torch.bool, device=dev)
    g = support_radius(float(sigma.max())) - 1
    off = torch.arange(-g, g + 1, device=dev)
    n_grad = n_ori = n_desc = 0
    for c0 in range(0, layer.numel(), 1024):
        sl = slice(c0, c0 + 1024)
        li = layer[sl].long().clamp(0, l_ - 1)
        y, x, s = yf[sl], xf[sl], sigma[sl]
        rows = torch.round(y).long()[:, None] + off              # (n, 2g+1)
        cols = torch.round(x).long()[:, None] + off
        rf, cf = rows.float(), cols.float()
        valid = (((rf >= 1) & (rf <= true_h[sl, None] - 2))[:, :, None]
                 & ((cf >= 1) & (cf <= true_w[sl, None] - 2))[:, None, :])
        ro = torch.round(4.5 * s)[:, None]
        near = off.abs()[None, :] <= ro
        obox = near[:, :, None] & near[:, None, :] & valid
        hw = 3.0 * s[:, None, None]
        cbin = (cf[:, None, :] - x[:, None, None]) / hw + 1.5
        rbin = (rf[:, :, None] - y[:, None, None]) / hw + 1.5
        square = ((rbin > -1) & (rbin < 4) & (cbin > -1) & (cbin < 4)
                  & valid)
        need = obox | square
        n_grad += int(need.sum())
        n_ori += int(obox.sum())
        n_desc += int(square.sum())
        flat = ((li[:, None, None] * h_ + rows[:, :, None]) * w_
                + cols[:, None, :])
        used.view(-1)[flat[need]] = True
    reads = torch.zeros_like(used)
    reads[:, :-1] |= used[:, 1:]
    reads[:, 1:] |= used[:, :-1]
    reads[:, :, :-1] |= used[:, :, 1:]
    reads[:, :, 1:] |= used[:, :, :-1]
    return int(reads.sum()), n_grad, n_ori, n_desc


def k1_bound(gauss, layer, yf, xf, sigma, true_h, true_w) -> float:
    """Seconds one K1 call on these keypoints takes at the card's peak:
    bytes are the stack pixels it must read (:func:`k1_work`), the six
    keypoint fields (layer int64) and the outputs."""
    flat = [a.reshape(-1) for a in (layer, yf, xf, sigma, true_h, true_w)]
    pixels, n_grad, n_ori, n_desc = k1_work(gauss, *flat)
    n = flat[0].numel()
    n_bytes = 4.0 * pixels + (8 + 5 * 4.0) * n + 129 * 4.0 * n
    n_ops = float(K1_GRAD_OPS * n_grad + K1_ORI_OPS * n_ori
                  + K1_DESC_OPS * n_desc + K1_KP_OPS * n)
    return bound_s(n_bytes, n_ops)


def touched_source_pixels(a23, h, w, out_h, out_w, device) -> int:
    """Source pixels of an (h, w) plane that the bilinear taps of its
    (out_h, out_w) warp by the src->dst affine ``a23`` touch (its inverse
    taken in float64)."""
    m = np.vstack([np.asarray(a23, np.float64).reshape(2, 3), [0, 0, 1]])
    inv = torch.tensor(np.linalg.inv(m)[:2], dtype=torch.float64,
                       device=device)
    touched = torch.zeros((h, w), dtype=torch.bool, device=device)
    xs = torch.arange(out_w, dtype=torch.float64, device=device)[None, :]
    for y0 in range(0, out_h, 512):
        ys = torch.arange(y0, min(out_h, y0 + 512), dtype=torch.float64,
                          device=device)[:, None]
        sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
        sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
        x0, yy0 = torch.floor(sx).long(), torch.floor(sy).long()
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = yy0 + dy, x0 + dx
                ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                touched[yy[ok], xx[ok]] = True
    return int(touched.sum())


def k2_plane_bound(a23s, h, w, device) -> float:
    """Seconds one launch of K2's single-plane form takes at the card's
    peak for (h, w) planes warped to (h, w) by the (N, 2, 3) ``a23s``."""
    src = sum(touched_source_pixels(a, h, w, h, w, device) for a in a23s)
    n_out = len(a23s) * h * w
    return bound_s(4.0 * src + 4.0 * n_out, float(K2_PLANE_OPS * n_out))
