"""The port's host I/O: background writers, the streamed mosaic write, the
strip checkpoint, the JPEG codec built from ``native/``, the streaming
frame store and the thread-safe ``DeviceStrip``, against the JAX package
where it has the same piece (same numpy inputs, on the CPU).

Tolerances: exact everywhere. The codec is the JAX package's source built
with the same libjpeg, so its decode equals the JAX package's bit for bit;
a streamed encode equals a one-shot encode of the same crop byte for
byte; a checkpoint round-trips losslessly in both directions.
"""

import os
import sys
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from torch_port_helpers import CPU

from drone_image_stitch_cpp_tpu.runtime import checkpoint as JCK
from drone_image_stitch_cpp_tpu.utils import native as JN
from drone_image_stitch_cpp_tpu_torch.ops import blend as TB
from drone_image_stitch_cpp_tpu_torch.runtime import checkpoint as TCK
from drone_image_stitch_cpp_tpu_torch.runtime import loader as TL
from drone_image_stitch_cpp_tpu_torch.runtime.feed import (FrameStore,
                                                           FrameStoreError)
from drone_image_stitch_cpp_tpu_torch.runtime.handoff import DeviceStrip
from drone_image_stitch_cpp_tpu_torch.runtime.writer import (
    BackgroundWriter, StreamedMosaicWriter)
from drone_image_stitch_cpp_tpu_torch.utils import native as TN


def _smooth_image(seed, h, w):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 2.0)


# ---- BackgroundWriter ---------------------------------------------------------

def test_background_writer_runs_in_order():
    w = BackgroundWriter()
    seen = []
    for i in range(20):
        w.submit(seen.append, i)
    w.join()
    assert seen == list(range(20))
    w.join()            # a joined writer joins again harmlessly


@pytest.mark.parametrize("then", ["join", "submit"])
def test_background_writer_error_resurfaces(then):
    w = BackgroundWriter()
    ran = []

    def boom():
        raise ValueError("disk on fire")

    w.submit(boom)
    if then == "join":
        with pytest.raises(ValueError, match="disk on fire"):
            w.join()
        return
    # a submit after the error fails fast instead of queueing more work
    for _ in range(500):
        if w._errors:
            break
        time.sleep(0.01)
    with pytest.raises(ValueError, match="disk on fire"):
        w.submit(ran.append, 1)
    assert ran == []


# ---- strip checkpoint: the same format as the JAX package ---------------------

@pytest.mark.parametrize("writer_pkg", ["jax", "port"])
def test_checkpoint_loads_across_packages(tmp_path, writer_pkg):
    strips = [np.random.default_rng(i).integers(0, 256, (20 + i, 30, 3),
                                                np.uint8) for i in range(3)]
    save = JCK.save_strip_checkpoint if writer_pkg == "jax" else \
        TCK.save_strip_checkpoint
    load = TCK.load_strip_checkpoint if writer_pkg == "jax" else \
        JCK.load_strip_checkpoint
    save(str(tmp_path), strips)
    back = load(str(tmp_path))
    assert back is not None and len(back) == 3
    for a, b in zip(strips, back):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_incomplete_or_v1_recomputes(tmp_path):
    TCK.save_strip_checkpoint(str(tmp_path), [np.zeros((8, 8, 3),
                                                       np.uint8)] * 2)
    os.remove(str(tmp_path / "strip_01.npy"))
    assert TCK.load_strip_checkpoint(str(tmp_path)) is None
    assert TCK.load_strip_checkpoint(str(tmp_path / "none")) is None
    v1 = tmp_path / "v1"
    os.makedirs(v1)
    cv2.imwrite(str(v1 / "strip_00.png"), np.zeros((8, 8, 3), np.uint8))
    with open(v1 / "checkpoint.json", "w") as f:
        f.write('{"strips": ["strip_00.png"]}')
    assert TCK.load_strip_checkpoint(str(v1)) is None


# ---- on_rows of the tiled compose --------------------------------------------

def _compose_with_rows(canvas_h, canvas_w, boxes, frames, on_rows):
    """Port tiled compose (64-px tiles) of ``frames`` placed at integer
    ``boxes`` (x0, y0, x1, y1), host assembly."""

    def feed(cv, i, ey0, ex0, eh, ew):
        fh, fw = frames[i].shape[:2]
        x0, y0 = int(boxes[i][0]) - ex0, int(boxes[i][1]) - ey0
        img = torch.zeros((eh, ew, 3))
        m = torch.zeros((eh, ew))
        ys = slice(max(0, y0), min(eh, y0 + fh))
        xs = slice(max(0, x0), min(ew, x0 + fw))
        if ys.start < ys.stop and xs.start < xs.stop:
            img[ys, xs] = torch.from_numpy(frames[i][
                ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0]
            ).float()
            m[ys, xs] = 1.0
        return TB.mb_feed(cv, img, m, 0, 0, m > 0)

    return TB.mb_compose_tiled(canvas_h, canvas_w, 3, boxes, feed, CPU,
                               tile=64, on_rows=on_rows)


_FRAMES = [_smooth_image(k, 40, 70) for k in range(3)]
# content in the upper half only: the lower tile rows are empty
_BOXES = [(13.0, 9.0, 83.0, 49.0), (70.0, 30.0, 140.0, 70.0),
          (150.0, 5.0, 220.0, 45.0)]


def test_on_rows_bands_in_order_equal_mosaic():
    events = []
    out, bbox = _compose_with_rows(
        200, 240, _BOXES, _FRAMES,
        lambda y0, y1, rows: events.append((y0, y1, rows.copy())))
    spans = [(e[0], e[1]) for e in events]
    assert spans == [(y, min(200, y + 64)) for y in range(0, 200, 64)]
    np.testing.assert_array_equal(np.concatenate([e[2] for e in events]),
                                  out)
    assert bbox is not None and out[bbox[0]:bbox[1]].any()
    with pytest.raises(ValueError):
        TB.mb_compose_tiled(64, 64, 3, [], None, CPU, assemble="device",
                            on_rows=lambda *a: None)


# ---- the JPEG codec built from native/ ----------------------------------------

def test_codec_decode_equals_jax_native(tmp_path):
    assert TN.jpeg_codec_error() is None, TN.jpeg_codec_error()
    assert JN.native_available()
    paths = []
    for k, q in enumerate((75, 97, 100)):
        p = str(tmp_path / f"f{k}.jpg")
        cv2.imwrite(p, _smooth_image(k, 61, 93), [cv2.IMWRITE_JPEG_QUALITY,
                                                  q])
        paths.append(p)
    for p in paths:
        np.testing.assert_array_equal(TN.decode_image_native(p),
                                      JN.decode_image_native(p))
    batch = TN.decode_batch_native(paths + [str(tmp_path / "none.jpg")], 2)
    for p, img in zip(paths, batch):
        np.testing.assert_array_equal(img, JN.decode_image_native(p))
    assert batch[-1] is None


def test_codec_unavailable_raises_with_reason(monkeypatch, tmp_path):
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'note: probing' >&2\n"
                    "echo 'd.cpp:21:10: fatal error: jpeglib.h: No such file "
                    "or directory' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    path, reason = TN._build("tmjpegprobe", ["decode.cpp"], ["-ljpeg"])
    assert path is None and reason.endswith("jpeglib.h: No such file or "
                                            "directory")
    monkeypatch.setitem(TN._CODEC, "lib", None)
    monkeypatch.setitem(TN._CODEC, "error", reason)
    monkeypatch.setitem(TN._CODEC, "path", None)
    assert not TN.jpeg_encoder_available()
    assert TN.jpeg_codec_error() == reason
    for call in (lambda: TN.decode_image_native("x.jpg"),
                 lambda: TN.decode_batch_native(["x.jpg"]),
                 lambda: TN.NativeJpegEncoder(str(tmp_path / "o.jpg"), 8, 8)):
        with pytest.raises(RuntimeError, match="jpeglib.h"):
            call()


def test_streamed_mosaic_writer_end_to_end(tmp_path):
    """Row bands of a tiled compose streamed into the encoder give the
    same file as a one-shot libjpeg encode of the crop."""
    path = str(tmp_path / "mosaic.jpg")
    sink = StreamedMosaicWriter(path)
    crop = (3, 150, 8, 229)
    sink.begin(200, 240, crop)
    out, _ = _compose_with_rows(200, 240, _BOXES, _FRAMES, sink.on_rows)
    assert sink.finish() == (147, 221) and sink.done
    ref = str(tmp_path / "ref.jpg")
    TN.encode_jpeg_native(ref, np.ascontiguousarray(
        out[crop[0]:crop[1], crop[2]:crop[3]]))
    with open(path, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    back = TN.decode_image_native(path)
    assert back.shape == (147, 221, 3)
    with pytest.raises(ValueError):
        StreamedMosaicWriter(str(tmp_path / "x.jpg")).begin(10, 10,
                                                           (0, 11, 0, 5))


# ---- the streaming frame store -------------------------------------------------

@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    for k in range(11):     # two chunks of the store
        cv2.imwrite(str(d / f"IMG{k:03d}_x.jpg"), _smooth_image(k, 48, 64),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
    return str(d)


def test_frame_store_from_paths_equals_eager_loader(jpeg_dir):
    """The folder's 4:2:0 JPEGs are stored as their own planes (packed
    I420, as the JAX package's ``fmt="auto"`` store does where the codec
    builds); the host frames equal the eager loader's bit for bit, the
    device frames the codec's raw decode."""
    paths, ids = TL.scan_with_ids(jpeg_dir)
    assert ids == ["IMG%03d" % k for k in range(11)]
    store = FrameStore.from_paths(paths, CPU)
    assert store.fmt == "yuv420"
    assert store.shape0 == (48, 64, 3) and len(store) == 11
    eager = TL.load_with_ids(jpeg_dir)
    assert eager.ids == ids
    raw = [TN.decode_image_yuv420_native(p) for p in paths]
    for k, img in enumerate(eager.images):
        np.testing.assert_array_equal(store.host_frame(k), img)
        np.testing.assert_array_equal(store.frame(k).numpy(), raw[k])
    np.testing.assert_array_equal(store.batch([9, 2, 4]).numpy(),
                                  np.stack([raw[i] for i in (9, 2, 4)]))
    ref = FrameStore(raw, CPU, fmt="yuv420")
    assert torch.equal(ref.batch(list(range(11))),
                       store.batch(list(range(11))))


@pytest.mark.parametrize("bad", ["garbage", "size"])
def test_frame_store_bad_frame_raises(jpeg_dir, tmp_path, bad):
    paths, _ = TL.scan_with_ids(jpeg_dir)
    p = str(tmp_path / "IMG009_x.jpg")
    if bad == "garbage":
        with open(p, "wb") as f:
            f.write(b"not a jpeg at all")
    else:
        cv2.imwrite(p, _smooth_image(9, 48, 66))
    paths[9] = p
    store = FrameStore.from_paths(paths, CPU)
    store.batch(list(range(8)))             # chunk 0 is fine
    with pytest.raises(FrameStoreError, match="9"):
        store.frame(10)
    with pytest.raises(FrameStoreError):
        store.host_frame(9)
    np.testing.assert_array_equal(store.host_frame(10),
                                  TL.decode_all([paths[10]])[0])


# ---- DeviceStrip for a writer thread -----------------------------------------

def test_device_strip_host_on_thread_while_consumed():
    """A writer thread's host() and the main thread's mark_consumed() and
    device_padded() race; both see the same bytes, and the canvas is
    released once the host copy exists."""
    rng = np.random.default_rng(5)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)     # interleave the two threads finely
    try:
        for _ in range(20):
            canvas = torch.from_numpy(rng.integers(0, 256, (96, 128, 3),
                                                   dtype=np.uint8))
            ds = DeviceStrip(canvas, (3, 90, 5, 120))
            ref = canvas.numpy()[3:90, 5:120].copy()
            got = {}
            start = threading.Barrier(2, timeout=30)

            def fetch():
                start.wait()
                got["host"] = ds.host()

            th = threading.Thread(target=fetch)
            th.start()
            start.wait()
            padded = ds.device_padded(128, 128).numpy()
            ds.mark_consumed()
            th.join(timeout=30)
            assert not th.is_alive()
            np.testing.assert_array_equal(got["host"], ref)
            np.testing.assert_array_equal(padded[:87, :115], ref)
            assert not padded[87:].any() and not padded[:, 115:].any()
            assert ds.dev is None
            np.testing.assert_array_equal(
                ds.device_padded(128, 128).numpy(), padded)
    finally:
        sys.setswitchinterval(switch)
