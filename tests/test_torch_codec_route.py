"""The JPEG codec's second build route (``utils/native``): the repo's
``native/decode.cpp`` + ``native/encode.cpp`` compiled against the jpeg62
headers vendored in ``csrc/libjpeg62/`` and linked to the libjpeg-turbo
that Pillow's wheel bundles (``pillow.libs/libjpeg-*.so*``), against the
first route (the system ``jpeglib.h`` and ``-ljpeg``) and the JAX
package's native decode, on the same 4:2:0 quality-92 JPEGs.

Tolerances: exact everywhere. Both libraries are libjpeg-turbo with the
jpeg62 ABI, whose integer DCT, upsampling and colour conversion are the
same code, so decodes (BGR, raw I420, 1/2 by DCT scaling) are equal bit
for bit and the encoder writes the same bytes; ``app.write_image``
writes the bytes of ``cv2.imwrite`` at its defaults by either route.
Skipped, with the reason,
only where Pillow's wheel bundles no libjpeg.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from torch_port_helpers import CPU

from drone_image_stitch_cpp_tpu.utils import native as JN
from drone_image_stitch_cpp_tpu_torch.runtime.feed import FrameStore
from drone_image_stitch_cpp_tpu_torch.utils import native as TN

# (h, w): the second has 323 chroma columns, an odd count
SIZES = [(240, 320), (486, 646)]


@pytest.fixture(scope="module")
def routes():
    """{"system": codec state, "pillow": codec state} (``_build_codec``
    by one route each)."""
    if TN._pillow_libjpeg() is None:
        pytest.skip("Pillow's wheel bundles no libjpeg here (no "
                    "pillow.libs/libjpeg-*.so*)")
    out = {name: TN._build_codec((name,)) for name in ("system", "pillow")}
    for name, st in out.items():
        assert st["error"] is None, (name, st["error"])
    return out


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """One 4:2:0 quality-92 JPEG of each size (cv2's default sampling)."""
    d = tmp_path_factory.mktemp("codec_route")
    paths = []
    for k, (h, w) in enumerate(SIZES):
        img = np.random.default_rng(k).integers(0, 256, (h, w, 3), np.uint8)
        img = cv2.GaussianBlur(img, (5, 5), 1.5)
        paths.append(str(d / f"IMG{k:03d}_x.jpg"))
        assert cv2.imwrite(paths[-1], img, [cv2.IMWRITE_JPEG_QUALITY, 92])
    return paths


def _use(monkeypatch, state):
    monkeypatch.setattr(TN, "_CODEC", dict(state))


def _decode(kind, path):
    if kind == "bgr":
        return TN.decode_image_native(path), JN.decode_image_native(path)
    if kind == "i420":
        return (TN.decode_image_yuv420_native(path),
                JN.decode_image_yuv420_native(path))
    return (TN.decode_batch_native([path], 1, scale_denom=2)[0],
            JN.decode_batch_native([path], 1, scale_denom=2)[0])


@pytest.mark.parametrize("size", range(len(SIZES)))
@pytest.mark.parametrize("kind", ["bgr", "i420", "half"])
def test_pillow_route_decodes_bit_equal(routes, jpegs, monkeypatch, kind,
                                        size):
    """BGR, raw 4:2:0 planes and the 1/2 DCT-scaled decode through the
    pillow route equal the system route's and the JAX package's."""
    got = {}
    for name, st in routes.items():
        _use(monkeypatch, st)
        got[name], jax_ref = _decode(kind, jpegs[size])
    h, w = SIZES[size]
    want = {"bgr": (h, w, 3), "i420": (h * 3 // 2, w),
            "half": (h // 2, w // 2, 3)}[kind]
    assert got["pillow"].shape == want
    np.testing.assert_array_equal(got["pillow"], got["system"])
    np.testing.assert_array_equal(got["pillow"], jax_ref)


def test_pillow_route_encoder_equals_system(routes, tmp_path, monkeypatch):
    """A streamed encode (three row bands) through the pillow route writes
    the system route's bytes, and decodes equal."""
    img = cv2.GaussianBlur(np.random.default_rng(7).integers(
        0, 256, (SIZES[1] + (3,)), np.uint8), (5, 5), 2.0)
    data = {}
    for name, st in routes.items():
        _use(monkeypatch, st)
        path = str(tmp_path / f"{name}.jpg")
        enc = TN.NativeJpegEncoder(path, img.shape[1], img.shape[0], 95)
        for y0 in range(0, img.shape[0], 200):
            enc.write(img[y0:y0 + 200])
        enc.finish()
        with open(path, "rb") as f:
            data[name] = f.read()
        data[name + "_px"] = TN.decode_image_native(path)
    np.testing.assert_array_equal(data["pillow_px"], data["system_px"])
    assert data["pillow"] == data["system"]


def test_auto_store_resolves_to_yuv420_through_pillow_route(
        routes, jpegs, monkeypatch):
    """``FrameStore.from_paths(fmt="auto")`` probes with the pillow
    route's raw decoder and stores a 4:2:0 folder packed I420; a frame
    height of 2 mod 4 (486) stays BGR, as in the JAX package."""
    _use(monkeypatch, routes["pillow"])
    st = FrameStore.from_paths([jpegs[0]] * 3, CPU)
    assert st.fmt == "yuv420" and st.shape0 == SIZES[0] + (3,)
    ref = JN.decode_image_yuv420_native(jpegs[0])
    for k in range(3):
        np.testing.assert_array_equal(st.frame(k).numpy(), ref)
    assert st.nbytes == 3 * ref.size
    assert FrameStore.from_paths([jpegs[1]], CPU).fmt == "bgr"


def test_build_key_route_and_errors(routes, monkeypatch):
    """Each route builds its own library (the key holds the route, the
    headers' bytes and the linked library's path and size); the route is
    reported; with neither route the error names both failures."""
    sysm, pil = routes["system"], routes["pillow"]
    assert sysm["path"] != pil["path"]
    assert sysm["route"] == "system"
    assert pil["route"] == "pillow:" + TN._pillow_libjpeg()
    _use(monkeypatch, pil)
    assert TN.jpeg_codec_route() == pil["route"]
    assert TN.jpeg_codec_library() == pil["path"]
    monkeypatch.setattr(TN, "_SYSTEM_PROBE", "#include <jpeglib_absent.h>\n")
    monkeypatch.setattr(TN, "_pillow_libjpeg", lambda: None)
    none = TN._build_codec()
    assert none["lib"] is None and none["route"] is None
    err = none["error"]
    assert err.startswith("system: ") and "jpeglib_absent.h" in err
    assert "; pillow: no libjpeg-*.so* under Pillow's pillow.libs/" in err
    _use(monkeypatch, none)
    assert TN.jpeg_codec_error() == err and TN.jpeg_codec_route() is None
    assert TN.decode_image_yuv420_native("x.jpg") is None
    with pytest.raises(RuntimeError, match="system: .*; pillow: "):
        TN.decode_image_native("x.jpg")


def test_pillow_route_binds_to_pillows_libjpeg(routes, jpegs):
    """In a process that has loaded cv2's and Pillow's own JPEG code, the
    pillow route's library binds every ``jpeg_*`` call to the libjpeg it
    was linked to (the dynamic loader's own record, ``LD_DEBUG``)."""
    lib = routes["pillow"]["path"]
    code = (
        "import cv2, PIL.Image, sys\n"
        "from drone_image_stitch_cpp_tpu_torch.utils import native as N\n"
        f"PIL.Image.open({jpegs[0]!r}).load()\n"
        "N._CODEC.update(N._build_codec(('pillow',)))\n"
        f"assert N.decode_image_native({jpegs[0]!r}) is not None\n")
    env = {**os.environ, "LD_DEBUG": "bindings",
           "PYTHONPATH": os.pathsep.join(sys.path)}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    targets = set()
    for ln in proc.stderr.splitlines():
        if f"binding file {lib} " in ln and "symbol `jpeg_" in ln:
            targets.add(os.path.realpath(ln.split(" to ")[1].split(" [")[0]))
    assert targets == {os.path.realpath(TN._pillow_libjpeg())}


@pytest.mark.parametrize("route", ["system", "pillow"])
def test_write_image_equals_cv2_default_write(routes, tmp_path, monkeypatch,
                                              route):
    """``app.write_image`` writes a JPEG through the codec (quality 95,
    libjpeg's defaults) with the bytes of ``cv2.imwrite`` at its defaults,
    by either route, on a frame of odd width and height."""
    from drone_image_stitch_cpp_tpu_torch import app
    _use(monkeypatch, routes[route])
    calls = []
    monkeypatch.setattr(app, "encode_jpeg_native", lambda *a: calls.append(
        a) or TN.encode_jpeg_native(*a))
    img = cv2.GaussianBlur(np.random.default_rng(11).integers(
        0, 256, (243, 321, 3), np.uint8), (7, 7), 2.0)
    ours, ref = str(tmp_path / "ours.jpg"), str(tmp_path / "cv2.jpg")
    app.write_image(ours, img)
    assert len(calls) == 1
    assert cv2.imwrite(ref, img)
    with open(ours, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
