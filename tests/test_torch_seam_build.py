"""The global graph cut's problem build (``ops/seam``) in tensor code against
the numpy statement it replaced: the four capacity grids bit for bit, the
band and the widen test, and every problem the whole pairwise path hands
the solver, with its masks, against the numpy path solved by the same host
engine. CPU tensors; the card's grids are held to these in
``tests/test_torch_maxflow.py`` (``-m gpu``).

``studies/gc_engine_ab.py --workload`` uses :func:`pairwise_seam_np` to
hold a benchmark cell's seams to the numpy path."""

import numpy as np
import pytest
import torch

from drone_image_stitch_cpp_tpu_torch.ops import seam as S
from drone_image_stitch_cpp_tpu_torch.ops.resize import resize_area
from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
from drone_image_stitch_cpp_tpu_torch.utils import native as N

import test_torch_graphcut_engine as E


# ---- the numpy statement ----------------------------------------------------

def gc_problem_np(a, b, ma, mb):
    """(cap_src, cap_snk, cap_h, cap_v) float32 of one seam problem on host
    arrays, or None when no exclusive region anchors a terminal."""
    diff = np.sqrt(((a - b) ** 2).sum(-1) + 1e-6)
    gray_a = a.mean(-1)
    gray_b = b.mean(-1)

    def grad(g):
        gx = np.zeros_like(g)
        gy = np.zeros_like(g)
        gx[:, 1:-1] = 0.5 * np.abs(g[:, 2:] - g[:, :-2])
        gy[1:-1, :] = 0.5 * np.abs(g[2:, :] - g[:-2, :])
        return gx + gy

    gsum = grad(gray_a) + grad(gray_b)
    big = np.float32(1e8)
    cap_src = np.where(ma & ~mb, big, 0.0).astype(np.float32)
    cap_snk = np.where(mb & ~ma, big, 0.0).astype(np.float32)
    if cap_src.max() == 0.0 or cap_snk.max() == 0.0:
        return None
    cost = (diff / (1.0 + 0.5 * gsum) + 1e-3).astype(np.float32)
    inb = (ma & mb).astype(np.float32)
    cap_h = ((cost[:, :-1] + cost[:, 1:]) * 0.5
             * np.maximum(inb[:, :-1], inb[:, 1:])).astype(np.float32)
    cap_v = ((cost[:-1, :] + cost[1:, :]) * 0.5
             * np.maximum(inb[:-1, :], inb[1:, :])).astype(np.float32)
    union = (ma | mb).astype(np.float32)
    cap_h *= np.minimum(union[:, :-1], union[:, 1:])
    cap_v *= np.minimum(union[:-1, :], union[1:, :])
    return cap_src, cap_snk, cap_h, cap_v


def resize_nearest_np(a, nh, nw):
    h, w = a.shape[:2]
    ys = np.minimum(np.floor(np.arange(nh) * (h / nh)).astype(np.int64),
                    h - 1)
    xs = np.minimum(np.floor(np.arange(nw) * (w / nw)).astype(np.int64),
                    w - 1)
    return a[ys[:, None], xs[None, :]]


def resize_area_np(a, nh, nw):
    return resize_area(torch.from_numpy(np.ascontiguousarray(a)), nh,
                       nw).numpy()


def dilate_np(mask, band):
    """Dilation by a (2 band + 1)^2 square: window maxima over the padded
    mask, rows then columns."""
    k = 2 * band + 1
    p = np.pad(mask, band)
    win = np.lib.stride_tricks.sliding_window_view
    return win(win(p, k, axis=0).any(-1), k, axis=1).any(-1)


def seam_band_np(lab, band):
    bm = np.zeros(lab.shape, bool)
    dh = lab[:, :-1] != lab[:, 1:]
    bm[:, :-1] |= dh
    bm[:, 1:] |= dh
    dv = lab[:-1, :] != lab[1:, :]
    bm[:-1, :] |= dv
    bm[1:, :] |= dv
    return dilate_np(bm, band)


def cut_touches_np(lab, pinned):
    dh = lab[:, :-1] != lab[:, 1:]
    if (dh & (pinned[:, :-1] | pinned[:, 1:])).any():
        return True
    dv = lab[:-1, :] != lab[1:, :]
    return bool((dv & (pinned[:-1, :] | pinned[1:, :])).any())


def pairwise_seam_np(img_a, img_b, mask_a, mask_b, solve):
    """The graph cut's host path on numpy arrays, each problem solved by
    ``solve`` (labels as uint8 numpy): ((new_mask_a, new_mask_b) or None,
    [every problem handed to ``solve``])."""
    seen = []

    def solve_(prob):
        seen.append(prob)
        return solve(*prob)

    a = np.asarray(img_a, np.float32)
    b = np.asarray(img_b, np.float32)
    ma = np.asarray(mask_a, bool)
    mb = np.asarray(mask_b, bool)
    if not (ma & mb).any():
        return None, seen
    ys, xs = np.where(ma | mb)
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    a_, b_ = a[y0:y1, x0:x1], b[y0:y1, x0:x1]
    ma_, mb_ = ma[y0:y1, x0:x1], mb[y0:y1, x0:x1]
    fh, fw = a_.shape[:2]
    both = ma_ & mb_
    coarse = fh * fw > S.GC_COARSE_NODES
    if coarse:
        sc = (S.GC_COARSE_NODES / float(fh * fw)) ** 0.5
        nh, nw = max(2, int(fh * sc)), max(2, int(fw * sc))
        mac = resize_nearest_np(ma_, nh, nw)
        mbc = resize_nearest_np(mb_, nh, nw)
        if not (mac & mbc).any():
            return None, seen
        prob = gc_problem_np(resize_area_np(a_, nh, nw),
                             resize_area_np(b_, nh, nw), mac, mbc)
    else:
        prob = gc_problem_np(a_, b_, ma_, mb_)
    if prob is None:
        return None, seen
    lab = solve_(prob).astype(bool)
    if coarse:
        lab_up = resize_nearest_np(lab, fh, fw)
        prob_f = gc_problem_np(a_, b_, ma_, mb_)
        if prob_f is None:
            return None, seen
        cap_src, cap_snk, cap_h, cap_v = prob_f
        band = max(32, int(round(3.0 / sc)))
        for attempt in range(2):
            in_band = seam_band_np(lab_up, band)
            pin_a = both & ~in_band & lab_up
            pin_b = both & ~in_band & ~lab_up
            cs2, ck2 = cap_src.copy(), cap_snk.copy()
            cs2[pin_a] = np.float32(1e8)
            ck2[pin_b] = np.float32(1e8)
            lab = solve_((cs2, ck2, cap_h, cap_v)).astype(bool)
            if attempt == 0 and cut_touches_np(lab, pin_a | pin_b):
                band *= 2
                continue
            break
    new_a, new_b = ma.copy(), mb.copy()
    new_a[y0:y1, x0:x1] = (ma_ & ~mb_) | (both & lab)
    new_b[y0:y1, x0:x1] = (mb_ & ~ma_) | (both & ~lab)
    return (new_a, new_b), seen


# ---- the problems -----------------------------------------------------------

def _problem(name):
    """(a, b, ma, mb) host arrays: the global tests' three graph-cut
    problems, the engine tests' two pairs, fully nested masks and masks
    with no overlap."""
    if name.startswith("global"):
        from test_torch_global import _gc_problems
        return _gc_problems()[int(name[-1])]
    if name == "banded":
        return E._banded_pair()
    a, b, ma, mb = E._small_pair()
    if name == "nested":
        return a, b, ma, ma.copy()
    if name == "no overlap":
        return a, b, ma & ~mb, mb & ~ma
    return a, b, ma, mb


PROBLEMS = ["global 0", "global 1", "global 2", "banded", "small",
            "nested", "no overlap"]


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


@pytest.fixture
def engine():
    if N.graphcut_library() is None:
        pytest.skip("no C++ compiler: the host engine does not build")
    return N.graphcut_native


@pytest.mark.parametrize("name", PROBLEMS)
def test_tensor_grids_equal_the_numpy_build(name):
    arrays = _problem(name)
    want = gc_problem_np(*arrays)
    ta = _t(arrays)
    got = S._gc_problem(*ta)
    assert bool(S._anchored(ta[2], ta[3])) == (want is not None)
    if want is None:
        assert name == "nested"
        return
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w_)
        assert g.numpy().tobytes() == w_.tobytes()


@pytest.mark.parametrize("name", PROBLEMS)
def test_every_problem_and_mask_equal_the_numpy_path(engine, monkeypatch,
                                                     name):
    """The tensor path hands the host engine the numpy path's problems, bit
    for bit (coarse, fine and widened), and returns its masks."""
    arrays = _problem(name)
    want, want_probs = pairwise_seam_np(*arrays, engine)
    seen = []

    def recording(*prob):
        seen.append([np.array(c) for c in prob])
        return engine(*prob)

    monkeypatch.setattr(N, "graphcut_native", recording)
    got = S.graphcut_pairwise_seam(*_t(arrays))
    assert (got is None) == (want is None)
    assert len(seen) == len(want_probs)
    for p_got, p_want in zip(seen, want_probs):
        for g, w_ in zip(p_got, p_want):
            assert g.tobytes() == np.ascontiguousarray(w_).tobytes()
    if name == "banded":
        assert len(seen) == 3
    if want is None:
        assert name in ("nested", "no overlap")
        return
    for m_g, m_w in zip(got, want):
        assert m_g.dtype == torch.bool
        np.testing.assert_array_equal(m_g.numpy(), m_w)


def _banded_labels(engine):
    """The banded pair's coarse labels upsampled to its full grid, and
    the fine cut at band 32 with its pins."""
    a, b, ma, mb = E._banded_pair()
    both = ma & mb
    coarse = gc_problem_np(resize_area_np(a, 200, 500),
                           resize_area_np(b, 200, 500),
                           resize_nearest_np(ma, 200, 500),
                           resize_nearest_np(mb, 200, 500))
    lab_up = resize_nearest_np(engine(*coarse).astype(bool), 400, 1000)
    cs, ck, ch, cv = gc_problem_np(a, b, ma, mb)
    fixed = both & ~seam_band_np(lab_up, 32)
    cs[fixed & lab_up] = 1e8
    ck[fixed & ~lab_up] = 1e8
    return lab_up, engine(cs, ck, ch, cv).astype(bool), fixed


@pytest.mark.parametrize("band", [1, 32, 64])
def test_band_equals_its_numpy_statement(engine, band):
    lab_up, lab, _ = _banded_labels(engine)
    for x in (lab_up, lab):
        got = S._seam_band(torch.from_numpy(x), band)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), seam_band_np(x, band))
    # nearest upsampling of the coarse labels, as numpy indexes it
    small = resize_nearest_np(lab_up, 200, 500)
    np.testing.assert_array_equal(
        S._resize_nearest(torch.from_numpy(small), 400, 1000).numpy(),
        resize_nearest_np(small, 400, 1000))


def test_cut_touches_equals_its_numpy_statement(engine):
    lab_up, lab, pinned = _banded_labels(engine)
    # the banded pair's fine cut presses on its band of 32 px
    assert cut_touches_np(lab, pinned)
    for x, pins in ((lab, pinned), (lab_up, pinned),
                    (lab, np.zeros_like(pinned)), (lab, ~pinned)):
        got = S._cut_touches(torch.from_numpy(x), torch.from_numpy(pins))
        assert bool(got) == cut_touches_np(x, pins)


def test_cpu_spans_say_nothing_crossed(engine):
    """On CPU tensors the ``seam problem`` spans carry ``device`` 0 and the
    pair's closing ``seam fetch`` ``bytes`` 0."""
    log = get_logger()
    n0 = len(log._records)
    a, b, ma, mb = E._banded_pair()
    methods = {}
    S.find_seams_sequential(_t((a, b)), _t((ma, mb)), method="graphcut",
                            methods=methods)
    assert methods == {(0, 1): "graphcut"}
    recs = log._records[n0:]
    problems = [r for r in recs if r["msg"] == "seam problem done"]
    assert len(problems) == 2 and all(r["device"] == 0 for r in problems)
    fetch = [r for r in recs if r["msg"] == "seam fetch done"]
    assert [r.get("bytes") for r in fetch] == [None, None, 0]
