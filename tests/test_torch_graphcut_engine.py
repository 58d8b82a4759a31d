"""The port's graph-cut engine (``csrc/graphcut.cpp``) against the JAX
package's reference solver (``native/graphcut.cpp``), both built by
``utils/native._build``: the same labels, bit for bit, on random, degenerate
and banded seam problems; the min-cut value against scipy's max-flow; the
engine's counts on the ``seam solve`` span. CPU only, no JAX."""

import ctypes

import numpy as np
import pytest
import torch

from drone_image_stitch_cpp_tpu_torch.ops import seam as S
from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
from drone_image_stitch_cpp_tpu_torch.utils import native as N

CPU = torch.device("cpu")
_REF = {}


@pytest.fixture(scope="module")
def ref():
    """The reference solver's typed ``tm_graphcut``."""
    if N.graphcut_library() is None:
        pytest.skip("no C++ compiler: the solvers do not build")
    if "fn" not in _REF:
        path, err = N._build("tmgraphcutref", ["graphcut.cpp"])
        assert path is not None, err
        fn = ctypes.CDLL(path).tm_graphcut
        fn.restype = ctypes.c_double
        fptr = np.ctypeslib.ndpointer(dtype=np.float32, flags="C")
        fn.argtypes = [ctypes.c_int, ctypes.c_int, fptr, fptr, fptr, fptr,
                       np.ctypeslib.ndpointer(dtype=np.uint8, flags="C")]
        _REF["fn"] = fn
    return _REF["fn"]


def _grids(*prob):
    return [np.ascontiguousarray(c, np.float32) for c in prob]


def solve_ref(fn, *prob):
    """(labels, flow) of the reference solver."""
    cs, ck, ch, cv = _grids(*prob)
    h, w = cs.shape
    lab = np.zeros((h, w), np.uint8)
    return lab, fn(h, w, cs, ck, ch, cv, lab)


def solve_port(*prob):
    """(labels, flow, counts) of the port's solver."""
    cs, ck, ch, cv = _grids(*prob)
    h, w = cs.shape
    lab = np.zeros((h, w), np.uint8)
    counts = np.zeros(3, np.int64)
    flow = N._GC["fn"](h, w, cs, ck, ch, cv, lab, counts)
    return lab, flow, counts


def _random_grid(rng, h, w, p_term=0.3, cmax=5):
    """Integer capacities: terminals on a share ``p_term`` of the nodes."""
    cs = (rng.integers(0, cmax, (h, w))
          * (rng.random((h, w)) < p_term)).astype(np.float32)
    ck = (rng.integers(0, cmax, (h, w))
          * (rng.random((h, w)) < p_term)).astype(np.float32)
    ch = rng.integers(0, cmax, (h, max(w - 1, 0))).astype(np.float32)
    cv = rng.integers(0, cmax, (max(h - 1, 0), w)).astype(np.float32)
    return cs, ck, ch, cv


def _scipy_flow(cs, ck, ch, cv):
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_flow

    h, w = cs.shape
    n = h * w
    rows, cols, data = [], [], []

    def arc(u, v, c):
        if c > 0:
            rows.append(u), cols.append(v), data.append(int(c))

    for y in range(h):
        for x in range(w):
            i = y * w + x + 1
            arc(0, i, cs[y, x])
            arc(i, n + 1, ck[y, x])
            if x + 1 < w:
                arc(i, i + 1, ch[y, x])
                arc(i + 1, i, ch[y, x])
            if y + 1 < h:
                arc(i, i + w, cv[y, x])
                arc(i + w, i, cv[y, x])
    g = csr_matrix((np.array(data, np.int32), (rows, cols)),
                   shape=(n + 2, n + 2))
    return maximum_flow(g, 0, n + 1).flow_value


def _cut_value(lab, cs, ck, ch, cv):
    labf = lab.astype(bool)
    cut = float(np.where(~labf, cs, 0).sum())
    cut += float(np.where(labf, ck, 0).sum())
    cut += float((ch * (labf[:, :-1] != labf[:, 1:])).sum())
    cut += float((cv * (labf[:-1, :] != labf[1:, :])).sum())
    return cut


@pytest.mark.parametrize("seed", range(6))
def test_random_grids_match_reference_and_scipy(ref, seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        h, w = int(rng.integers(2, 14)), int(rng.integers(2, 14))
        prob = _random_grid(rng, h, w, p_term=float(rng.uniform(0.05, 0.6)))
        lab_r, flow_r = solve_ref(ref, *prob)
        lab_p, flow_p, counts = solve_port(*prob)
        np.testing.assert_array_equal(lab_p, lab_r)
        mf = _scipy_flow(*prob)
        assert flow_p == pytest.approx(mf, abs=1e-3)
        assert _cut_value(lab_p, *prob) == pytest.approx(mf, abs=1e-3)
        roots = int((prob[0] != prob[1]).sum())
        assert 0 <= counts[2] <= roots


def _degenerate(name):
    rng = np.random.default_rng(7)
    if name == "1xN":
        return _random_grid(rng, 1, 37, 0.2)
    if name == "Nx1":
        return _random_grid(rng, 41, 1, 0.2)
    if name == "1x1":
        return _grids(np.full((1, 1), 3), np.full((1, 1), 2),
                      np.zeros((1, 0)), np.zeros((0, 1)))
    if name == "all zero":
        return _grids(np.zeros((9, 13)), np.zeros((9, 13)),
                      np.zeros((9, 12)), np.zeros((8, 13)))
    if name == "no free node":
        cs, ck, ch, cv = _random_grid(rng, 10, 12, 1.0)
        cs = np.where(cs == ck, cs + 1, cs)
        return _grids(cs, ck, ch, cv)
    if name == "equal terminals":
        # cap_src == cap_snk everywhere: every node is free after the
        # terminal collapse
        c = rng.integers(1, 5, (8, 11)).astype(np.float32)
        return _grids(c, c, rng.integers(1, 5, (8, 10)),
                      rng.integers(1, 5, (7, 11)))
    if name == "nested terminals":
        # a source island inside a sink ring inside a source ring
        h, w = 24, 30
        yy, xx = np.mgrid[:h, :w]
        r = np.maximum(abs(yy - h / 2), abs(xx - w / 2))
        cs = np.where((r < 3) | (r > 11), 9.0, 0.0)
        ck = np.where((r > 6) & (r < 8), 9.0, 0.0)
        return _grids(cs, ck, rng.integers(1, 4, (h, w - 1)),
                      rng.integers(1, 4, (h - 1, w)))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["1xN", "Nx1", "1x1", "all zero",
                                  "no free node", "equal terminals",
                                  "nested terminals"])
def test_degenerate_grids_match_reference(ref, name):
    prob = _degenerate(name)
    lab_r, flow_r = solve_ref(ref, *prob)
    lab_p, flow_p, counts = solve_port(*prob)
    np.testing.assert_array_equal(lab_p, lab_r)
    assert flow_p == pytest.approx(flow_r, abs=1e-3)
    assert flow_p == pytest.approx(_scipy_flow(*prob), abs=1e-3)
    if name in ("all zero", "equal terminals"):
        assert counts.tolist() == [0, 0, 0] and not lab_p.any()


def _banded_pair():
    """A 400 x 1000 union box (the coarse scale is exactly 1/2) where B
    differs from A by a mean that is least on row 245 and a +-amplitude
    checkerboard that is largest there: the coarse grid averages the
    checkerboard away and sees the seam on row 245; the full grid sees
    max(mean, amplitude), least on row ~159, 86 px off, so the
    full-resolution cut presses on the band of 32 px and again on the
    widened one. The checkerboard is invisible to the central-difference
    gradient, and nothing else has an edge."""
    h, w = 400, 1000
    a = np.broadcast_to(100.0 + 0.05 * np.arange(w, dtype=np.float32)
                        [None, :, None], (h, w, 3))
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    mean = 0.3 * np.abs(yy - 245.0)
    amp = np.where(yy < 245, np.clip(60.0 - 0.4 * (245.0 - yy), 0, 60), 60.0)
    checker = np.where((yy + xx) % 2 == 0, 1.0, -1.0)
    b = (a + (mean + checker * amp)[..., None]).astype(np.float32)
    return a.astype(np.float32), b, yy < 320, yy >= 80


def _small_pair():
    r = np.random.default_rng(1)
    h, w = 64, 96
    a = r.uniform(0, 255, (h, w, 3)).astype(np.float32)
    b = a.copy()
    b[:, :40] += 60
    b[:, 56:] -= 60
    ma = np.zeros((h, w), bool)
    mb = np.zeros((h, w), bool)
    ma[:, :88] = True
    mb[:, 8:] = True
    return a, b, ma, mb


def _record_problems(monkeypatch, pair):
    """The problems ``graphcut_pairwise_seam`` hands the solver, and its
    masks."""
    seen = []
    real = N.graphcut_native

    def recording(*prob):
        seen.append(_grids(*prob))
        return real(*prob)

    monkeypatch.setattr(N, "graphcut_native", recording)
    masks = S.graphcut_pairwise_seam(*_tensors(pair))
    monkeypatch.setattr(N, "graphcut_native", real)
    return seen, masks


def _tensors(arrays, device=CPU):
    """Host arrays as tensors on ``device``."""
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in arrays]


def test_banded_problem_widens_and_matches_reference(ref, monkeypatch):
    seen, _ = _record_problems(monkeypatch, _banded_pair())
    # coarse, fine at band 32, and the re-solve at band 64
    assert [p[0].shape for p in seen] == [(200, 500), (400, 1000),
                                          (400, 1000)]
    pinned = [int((p[0] == 1e8).sum() + (p[1] == 1e8).sum())
              for p in seen[1:]]
    assert pinned[0] > pinned[1] > 0
    for prob in seen:
        lab_r, flow_r = solve_ref(ref, *prob)
        lab_p, flow_p, counts = solve_port(*prob)
        np.testing.assert_array_equal(lab_p, lab_r)
        assert flow_p == pytest.approx(flow_r, rel=1e-6)
        assert counts[0] > 0 and counts[1] > 0 and counts[2] > 0


@pytest.mark.parametrize("pair", [_small_pair, _banded_pair])
def test_pairwise_seam_masks_equal_with_either_library(ref, monkeypatch,
                                                       pair):
    args = _tensors(pair())
    port = S.graphcut_pairwise_seam(*args)

    def reference(cs, ck, ch, cv):
        return solve_ref(ref, cs, ck, ch, cv)[0]

    monkeypatch.setattr(N, "graphcut_native", reference)
    with_ref = S.graphcut_pairwise_seam(*args)
    assert port is not None and with_ref is not None
    for m_p, m_r in zip(port, with_ref):
        np.testing.assert_array_equal(m_p.numpy(), m_r.numpy())


def test_seam_solve_span_carries_the_engine_counts(ref):
    log = get_logger()
    n0 = len(log._records)
    prob = _random_grid(np.random.default_rng(11), 30, 40, 0.1)
    lab = N.graphcut_native(*prob)
    recs = [r for r in log._records[n0:] if r["msg"] == "seam solve done"]
    assert len(recs) == 1
    rec = recs[0]
    _, _, counts = solve_port(*prob)
    assert rec["nodes"] == 30 * 40
    assert [rec["augments"], rec["orphans"], rec["active_roots"]] == \
        counts.tolist()
    assert all(type(rec[k]) is int
               for k in ("augments", "orphans", "active_roots"))
    np.testing.assert_array_equal(lab, solve_ref(ref, *prob)[0])


def test_engine_ab_study_on_a_small_synthetic_pair(ref):
    """``studies/gc_engine_ab.py`` at a cut size: its counting copy of the
    reference still builds, and both engines agree on its problems."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "studies"))
    import gc_engine_ab as G

    new, ref_fn, counted, ref_counts = G.engines()
    probs, _ = G.synthetic_problems(2, 240, 600)
    assert [n.split()[0] for n, _ in probs] == ["coarse", "fine", "widened"]
    for name, prob in probs:
        rec = G.ab(name, prob, new, ref_fn, counted, ref_counts, 1)
        assert rec["labels_differ"] == 0, rec
        assert rec["flow"]["new"] == pytest.approx(rec["flow"]["ref"],
                                                   rel=1e-6)
        assert rec["ref_counts"]["augments"] > 0
        assert rec["new_counts"]["active_roots"] <= \
            rec["ref_counts"]["active_roots"]


def test_large_banded_grid_matches_reference(ref):
    """Above a million nodes the engine writes its records and labels on
    several threads: a 1100 x 1000 grid pinned above and below a ribbon
    of 40 free rows with random capacities."""
    rng = np.random.default_rng(13)
    h, w = 1100, 1000
    rows = np.arange(h)[:, None]
    cs = np.where(rows < 530, 1e8, 0.0) * np.ones((1, w))
    ck = np.where(rows >= 570, 1e8, 0.0) * np.ones((1, w))
    prob = _grids(cs, ck, rng.uniform(0.1, 5.0, (h, w - 1)),
                  rng.uniform(0.1, 5.0, (h - 1, w)))
    lab_r, flow_r = solve_ref(ref, *prob)
    lab_p, flow_p, counts = solve_port(*prob)
    np.testing.assert_array_equal(lab_p, lab_r)
    assert flow_p == pytest.approx(flow_r, rel=1e-6)
    # the frontier roots: the row next to each side of the ribbon
    assert counts[2] == 2 * w
