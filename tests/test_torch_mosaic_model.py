"""The last JAX modules beside the ingest wire: the port vs the JAX
package on the CPU.

  * ``models/mosaic.pairwise_register`` on ``__graft_entry__.entry()``'s
    frames (256x320 crops of ``__graft_entry__._textured(288, 384)``,
    planted (40, 24) shift) with JAX's RANSAC samples injected: the translation
    within 0.1 px of JAX's, ``n_good`` within 2%;
  * the half-resolution store (tests/test_app.py's planted (256, 64)):
    both within 1 px of the planted shift, the port within 0.5 px of JAX;
  * the packed tile fetch (tests/test_handoff.py's frames): gray within
    3 levels and mean within 4 of the plain fetch, within 1 level of
    JAX's packed fetch.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, jax_banks, n, t

import __graft_entry__ as GE
from drone_image_stitch_cpp_tpu.models import mosaic as JM
from drone_image_stitch_cpp_tpu.ops import blend as JB
from drone_image_stitch_cpp_tpu.pipeline import pairgraph as JP
from drone_image_stitch_cpp_tpu.pipeline.registration import (
    detect_features as jdetect)
from drone_image_stitch_cpp_tpu.runtime.feed import FrameStore as JStore
from drone_image_stitch_cpp_tpu.utils.synthetic import synthetic_ortho
from drone_image_stitch_cpp_tpu_torch.models import mosaic as TM
from drone_image_stitch_cpp_tpu_torch.ops import blend as TB
from drone_image_stitch_cpp_tpu_torch.ops.match import adaptive_ratio
from drone_image_stitch_cpp_tpu_torch.pipeline import pairgraph as TP
from drone_image_stitch_cpp_tpu_torch.pipeline.registration import (
    detect_features as tdetect)
from drone_image_stitch_cpp_tpu_torch.runtime.feed import FrameStore


# ---- the model step ---------------------------------------------------------

def test_pairwise_register_matches_jax():
    """``__graft_entry__.entry()``'s call (max_kp=256, n_hyp=256) in both
    packages; the port draws JAX's PRNGKey(0) samples."""
    base = GE._textured(288, 384, seed=0)
    frames = np.stack([base[:256, :320], base[24:280, 40:360]])
    mj, gj, ij, okj = JM.pairwise_register(jnp.asarray(frames), max_kp=256,
                                           n_hyp=256)
    bank = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (256, 2), 0,
                                         np.iinfo(np.int32).max))
    mt, gt_, it, okt = TM.pairwise_register(frames, CPU, max_kp=256,
                                            n_hyp=256,
                                            bank=torch.from_numpy(bank))
    assert bool(okj) and bool(okt)
    mj = np.asarray(mj)
    assert np.abs(mj[:2, 2] - np.asarray([-40.0, -24.0])).max() < 0.5
    assert np.abs(n(mt)[:2, 2] - mj[:2, 2]).max() < 0.1, (n(mt), mj)
    assert abs(int(gt_) - int(gj)) <= 0.02 * int(gj), (int(gt_), int(gj))
    assert int(it) > 0.8 * int(gt_)
    # the port's own generator gives a model as good
    mg, _, _, okg = TM.pairwise_register(
        frames, CPU, max_kp=256, n_hyp=256,
        generator=torch.Generator().manual_seed(3))
    assert bool(okg) and np.abs(n(mg)[:2, 2] - mj[:2, 2]).max() < 0.1


# ---- the half-resolution store ----------------------------------------------

def test_half_res_store_detect_geometry(tmp_path):
    """tests/test_app.py:284-320 in both packages: a store decoded at 1/2
    (libjpeg's DCT scaling) detected with coord_scale=2 recovers the
    planted full-resolution (256, 64)."""
    big = synthetic_ortho(h=1200, w=4300)
    paths = []
    for k, img in enumerate([big[0:1024, 0:3968], big[64:1088, 256:4224]]):
        p = str(tmp_path / f"F{k}.jpg")
        cv2.imwrite(p, img.astype(np.uint8), [cv2.IMWRITE_JPEG_QUALITY, 97])
        paths.append(p)
    ratio = adaptive_ratio(0.35)

    fj, sj = jdetect(None, 400, 0.2, store=JStore.from_paths(
        paths, scale_denom=2), indices=[0, 1], coord_scale=2.0)
    gj = JP.register_pairs(fj, [(0, 1)], ratio, thresh=4.0 / sj,
                           kind="similarity")
    st = FrameStore.from_paths(paths, CPU, scale_denom=2)
    assert st.fmt == "bgr" and st.shape0 == (512, 1984, 3)
    ft, stt = tdetect(None, 400, 0.2, store=st, indices=[0, 1],
                      coord_scale=2.0)
    assert abs(stt - sj) < 1e-6
    gt_ = TP.register_pairs(ft, [(0, 1)], ratio, thresh=4.0 / stt,
                            banks=torch.from_numpy(jax_banks(0, 1, 1024)))
    assert bool(np.asarray(gj.ok)[0]) and bool(gt_.ok[0])
    mj = np.asarray(gj.model)[0][:2, 2]
    mt = n(gt_.model)[0][:2, 2]
    for m in (mj, mt):
        assert abs(m[0] + 256.0) < 1.0 and abs(m[1] + 64.0) < 1.0, m
    assert np.abs(mt - mj).max() < 0.5, (mt, mj)


# ---- the packed tile fetch --------------------------------------------------

def _gray(a):
    return a.astype(np.float32) @ np.asarray([0.114, 0.587, 0.299],
                                             np.float32)


def test_fetch_packed_matches_plain_and_jax(ortho):
    """tests/test_handoff.py::test_fetch_packed_matches_within_chroma: its
    fixture's two frames at integer offsets blended through 128-px tiles,
    fetched as BGR and as packed I420, in both packages. Each feed window
    is cut in numpy (what the fixture's warp of an integer shift gives),
    so both packages blend the same windows and the fetch is what
    differs."""
    bands, ch, cw = 3, 320, 512
    frames = [ortho[40:200, 40:296].astype(np.float32),
              ortho[40:200, 168:424].astype(np.float32)]
    offs = [(0, 0), (128, 40)]
    boxes = [(float(ox), float(oy), float(ox + f.shape[1]),
              float(oy + f.shape[0])) for (ox, oy), f in zip(offs, frames)]

    def window(i, oy, ox, eh, ew):
        fx0, fy0, fx1, fy1 = boxes[i]
        tlx, tly, rw_, rh_ = TB.aligned_roi(fx0 - ox, fy0 - oy, fx1 - ox,
                                            fy1 - oy, bands, eh, ew)
        img = np.zeros((rh_, rw_, 3), np.float32)
        m = np.zeros((rh_, rw_), np.float32)
        y0, x0 = offs[i][1] - (oy + tly), offs[i][0] - (ox + tlx)
        fh, fw = frames[i].shape[:2]
        ys = slice(max(0, y0), min(rh_, y0 + fh))
        xs = slice(max(0, x0), min(rw_, x0 + fw))
        img[ys, xs] = frames[i][ys.start - y0:ys.stop - y0,
                                xs.start - x0:xs.stop - x0]
        m[ys, xs] = 1.0
        return tlx, tly, img, m

    jfeed_prog = jax.jit(JB.mb_feed, donate_argnums=0)

    def jfeed(cv, i, oy, ox, eh, ew):
        tlx, tly, img, m = window(i, oy, ox, eh, ew)
        return jfeed_prog(cv, jnp.asarray(img), jnp.asarray(m), tlx, tly,
                          jnp.asarray(m > 0))

    def feed(cv, i, oy, ox, eh, ew):
        tlx, tly, img, m = window(i, oy, ox, eh, ew)
        return TB.mb_feed(cv, t(img), t(m), tlx, tly, t(m > 0))

    jpacked = JB.mb_compose_tiled(ch, cw, bands, boxes, jfeed, tile=128,
                                  fetch_packed=True)
    plain, box = TB.mb_compose_tiled(ch, cw, bands, boxes, feed, CPU,
                                     tile=128)
    packed, pbox = TB.mb_compose_tiled(ch, cw, bands, boxes, feed, CPU,
                                       tile=128, fetch_packed=True)
    assert pbox == box
    assert np.abs(_gray(plain) - _gray(packed)).max() <= 3.0
    assert np.abs(plain.astype(np.int16)
                  - packed.astype(np.int16)).mean() < 4.0
    d = np.abs(packed.astype(np.int16) - np.asarray(jpacked, np.int16))
    assert d.max() <= 1, d.max()
    with pytest.raises(ValueError):
        TB.mb_compose_tiled(ch, cw, bands, boxes, feed, CPU, tile=128,
                            assemble="device", fetch_packed=True)
