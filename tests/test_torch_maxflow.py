"""The card's min-cut (``ops/maxflow_kernel``, ``csrc/maxflow.cu``) against
the host engine (``csrc/graphcut.cpp``, ``utils/native.graphcut_native``).

Imports torch and the port at module level (the JAX package only inside
the one test that compares with it, which runs on the CPU). On any
machine: the plain statement (contraction, integer push-relabel with the
terminals exchanged, reachability) gives the engine's labels bit for bit
on the engine tests' problem families, and its seam masks on the banded
pair are the JAX package's; the contraction rule, the terminal swap and
the fixed-point scale on hand-built grids. The tests marked ``gpu`` hold
the kernel to the plain statement, the engine and the JAX package's solver
(``native/graphcut.cpp``, host C++) on a card:

    python -m pytest tests/test_torch_maxflow.py -q -m gpu
"""

import math

import numpy as np
import pytest
import torch

import test_torch_graphcut_engine as E
from test_torch_graphcut_engine import ref  # noqa: F401  (fixture)
from drone_image_stitch_cpp_tpu_torch.ops import maxflow_kernel as M
from drone_image_stitch_cpp_tpu_torch.ops import seam as S
from drone_image_stitch_cpp_tpu_torch.runtime.logging import get_logger
from drone_image_stitch_cpp_tpu_torch.utils import native as N

CPU = torch.device("cpu")
DEGENERATE = ["1xN", "Nx1", "1x1", "all zero", "no free node",
              "equal terminals", "nested terminals"]
_BANDED = []


@pytest.fixture
def engine():
    """The host engine's labels of a problem."""
    if N.graphcut_library() is None:
        pytest.skip("no C++ compiler: the host engine does not build")
    return lambda *prob: N.graphcut_native(*E._grids(*prob))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels run only there)")
    return torch.device("cuda", 0)


def _tensors(prob, device=CPU):
    return [torch.from_numpy(np.ascontiguousarray(c, np.float32)).to(device)
            for c in prob]


def _cut(prob, device=CPU):
    """(labels as numpy uint8, counts) of :func:`M.min_cut`."""
    lab, counts = M.min_cut(*_tensors(prob, device))
    return lab.cpu().numpy(), counts


def _random_problems(seed, count=12):
    rng = np.random.default_rng(seed)
    return [E._random_grid(rng, int(rng.integers(2, 14)),
                           int(rng.integers(2, 14)),
                           p_term=float(rng.uniform(0.05, 0.6)))
            for _ in range(count)]


def _banded_problems(monkeypatch):
    """The coarse, fine and widened problems of the engine tests' banded
    pair (400 x 1000), recorded once."""
    if not _BANDED:
        seen, _ = E._record_problems(monkeypatch, E._banded_pair())
        _BANDED.extend(seen)
    return _BANDED


@pytest.mark.parametrize("seed", range(6))
def test_plain_matches_engine_on_random_grids(engine, seed):
    for prob in _random_problems(seed):
        lab, counts = _cut(prob)
        np.testing.assert_array_equal(lab, engine(*prob))
        assert counts["free"] <= prob[0].size


@pytest.mark.parametrize("name", DEGENERATE)
def test_plain_matches_engine_on_degenerate_grids(engine, name):
    prob = E._degenerate(name)
    lab, counts = _cut(prob)
    np.testing.assert_array_equal(lab, engine(*prob))
    if name in ("1x1", "all zero"):
        assert counts == {"free": 0, "rounds": 0, "relabels": 0}


def test_plain_matches_engine_on_the_banded_problems(engine, monkeypatch):
    probs = _banded_problems(monkeypatch)
    assert [p[0].shape for p in probs] == [(200, 500), (400, 1000),
                                           (400, 1000)]
    free = []
    for prob in probs:
        lab, counts = _cut(prob)
        np.testing.assert_array_equal(lab, engine(*prob))
        assert counts["rounds"] > 0 and counts["relabels"] >= 2
        free.append(counts["free"])
    # the pins leave a ribbon; the widened band frees more of it
    assert free[1] < free[2] < probs[1][0].size


def test_plain_seam_masks_are_the_jax_packages(monkeypatch):
    """graphcut_pairwise_seam with every solve by the plain statement (the
    card's algorithm) against the JAX package's on the banded pair, as
    tests/test_torch_global.py holds the host engine's masks: the cut
    agrees on the overlap and the masks part the union."""
    JS = pytest.importorskip("drone_image_stitch_cpp_tpu.ops.seam")
    pair = E._banded_pair()
    calls = []

    def plain(prob):
        calls.append(tuple(prob[0].shape))
        return M.min_cut(*prob)[0]

    monkeypatch.setattr(S, "_solve", plain)
    got = S.graphcut_pairwise_seam(*E._tensors(pair))
    monkeypatch.undo()
    assert calls == [(200, 500), (400, 1000), (400, 1000)]
    want = JS.graphcut_pairwise_seam(*pair)
    assert got is not None and want is not None
    got = [m.numpy() for m in got]
    ma, mb = pair[2], pair[3]
    both = ma & mb
    assert float((got[0][both] == want[0][both]).mean()) >= 0.995
    assert not (got[0] & got[1]).any()
    np.testing.assert_array_equal(got[0] | got[1], ma | mb)


def _grid(h, w, cs, ck, ch, cv):
    return E._grids(np.asarray(cs).reshape(h, w), np.asarray(ck).reshape(
        h, w), np.asarray(ch).reshape(h, w - 1), np.asarray(cv).reshape(
        h - 1, w))


def test_contraction_joins_a_node_to_its_terminal(engine):
    """2 x 3, arcs of 1: (0, 0) has source residual 3 > its arc sum 2 and
    joins the source; (1, 2) has sink residual 2 = its arc sum and joins
    the sink; (0, 1) has source residual exactly its arc sum 3 and stays
    free, as do the rest. The free nodes' folded residuals carry the arcs
    to the joined ones, and every label is the engine's."""
    prob = _grid(2, 3, [3, 3, 0, 0, 0, 0], [0, 0, 0, 0, 1, 2],
                 np.ones(4), np.ones(3))
    rib = M.contract(*_tensors(prob))
    src, free = rib.src.numpy(), rib.free.numpy()
    np.testing.assert_array_equal(src, [[1, 0, 0], [0, 0, 0]])
    np.testing.assert_array_equal(free, [[0, 1, 1], [1, 1, 0]])
    # slot (ly, lx) of the one tile; each free node's arcs to the joined
    # nodes are folded: (0, 1) +1 from (0, 0), (1, 0) +1 from (0, 0),
    # (0, 2) -1 and (1, 1) -1 towards (1, 2)
    tr = rib.tr.view(M.TILE_H, M.TILE_W)[:2, :3].numpy() / rib.scale
    np.testing.assert_array_equal(tr, [[0, 4, -1], [1, -2, 0]])
    arcs = rib.arcs.view(4, M.TILE_H, M.TILE_W)[:, :2, :3].numpy()
    assert arcs[0, 0, 0] == 0 and arcs[1, 0, 1] == 0   # to a joined node
    assert arcs[0, 0, 1] == rib.scale and arcs[2, 0, 1] == rib.scale
    lab, counts = _cut(prob)
    np.testing.assert_array_equal(lab, engine(*prob))
    assert counts["free"] == 4
    assert lab[0, 0] == 1 and lab[1, 2] == 0


def test_terminal_swap_returns_the_source_minimal_side(engine):
    """Two minimum cuts of equal value: the source's own arc and the sink's
    own arc (1 each) on a chain whose inner arcs (2) bind nothing. The
    source-minimal side is empty; the nodes that can reach the sink after a
    max-flow from the source would label every node 1."""
    prob = _grid(1, 4, [1, 0, 0, 0], [0, 0, 0, 1], [2, 2, 2],
                 np.zeros((0,)))
    lab, counts = _cut(prob)
    assert counts["free"] == 4
    np.testing.assert_array_equal(lab, [[0, 0, 0, 0]])
    np.testing.assert_array_equal(lab, engine(*prob))
    # a 2-D tie: a source column and a sink column, every arc 1; cutting
    # next to either column costs the same
    h, w = 5, 6
    cs = np.zeros((h, w))
    ck = np.zeros((h, w))
    cs[:, 0] = 2.0
    ck[:, -1] = 2.0
    prob = _grid(h, w, cs, ck, np.ones((h, w - 1)), np.zeros((h - 1, w)))
    lab, _ = _cut(prob)
    np.testing.assert_array_equal(lab, engine(*prob))
    np.testing.assert_array_equal(lab[:, 0], 1)
    assert not lab[:, 1:].any()


def test_fixed_point_scale_holds_the_largest_seam_problem(engine):
    """``_gc_problem`` at its largest costs (black against white: 441.7 +
    1e-3 on every overlap pixel, no gradient), pinned at 1e8 outside a
    band: the pins are contracted away and every residual, and the whole
    supply, fit in 2**62 at a scale fine enough for float32 costs."""
    h, w = 96, 320
    a = np.zeros((h, w, 3), np.float32)
    b = np.full((h, w, 3), 255.0, np.float32)
    rows = np.arange(h)[:, None] * np.ones((1, w), int)
    ma, mb = rows < 70, rows >= 26
    cs, ck, ch, cv = [c.numpy() for c in S._gc_problem(
        *E._tensors((a, b, ma, mb)))]
    assert 441.0 < ch.max() < 443.0
    both = ma & mb
    cs[both & (rows < 40)] = 1e8
    ck[both & (rows >= 56)] = 1e8
    prob = (cs, ck, ch, cv)
    rib = M.contract(*_tensors(prob))
    assert not (rib.free.numpy() & ((cs == 1e8) | (ck == 1e8))).any()
    assert rib.n_free == 16 * w
    supply = int(rib.tr.clamp(min=0).sum()) + int((-rib.tr).clamp(min=0)
                                                  .sum())
    top = max(int(rib.tr.abs().max()), int(rib.arcs.max()) * 2)
    assert 0 < supply < 2 ** 62 and top < 2 ** 62
    assert rib.scale >= 2 ** 30
    # the same rule at the largest ribbon the sorties produce: 5.7 M free
    # nodes, each folding four arcs of 443 into its terminal residual
    bound = 5.7e6 * 8 * 443.0 + 2 * 443.0
    s = M.supply_scale(bound)
    assert 2 ** 61 <= bound * s < 2 ** 62 and s >= 2 ** 23
    lab, counts = _cut(prob)
    np.testing.assert_array_equal(lab, engine(*prob))
    assert counts["free"] == rib.n_free


# ---- on the card ----------------------------------------------------------


def _families(monkeypatch):
    out = [(f"random {s}.{i}", p) for s in range(3)
           for i, p in enumerate(_random_problems(s))]
    out += [(name, E._degenerate(name)) for name in DEGENERATE]
    out += [(f"banded {i}", p)
            for i, p in enumerate(_banded_problems(monkeypatch))]
    return out


@pytest.mark.gpu
def test_kernel_matches_plain_and_engine(cuda, engine, ref, monkeypatch):
    for name, prob in _families(monkeypatch):
        lab_k, counts_k = _cut(prob, cuda)
        lab_p, counts_p = _cut(prob)
        np.testing.assert_array_equal(lab_k, lab_p, err_msg=name)
        np.testing.assert_array_equal(lab_k, engine(*prob), err_msg=name)
        np.testing.assert_array_equal(lab_k, E.solve_ref(ref, *prob)[0],
                                      err_msg=name)
        assert counts_k == counts_p, name
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_kernel_resumes_across_launches(cuda, monkeypatch):
    """Batches of 16 rounds: each solve of the banded pair takes several
    launches, each counted, and ends with the plain statement's labels,
    rounds and relabels."""
    probs = _banded_problems(monkeypatch)
    monkeypatch.setattr(M, "BATCH_ROUNDS", 16)
    for prob in probs:
        n0 = M.min_cut.launches
        lab_k, counts_k = _cut(prob, cuda)
        launches = M.min_cut.launches - n0
        lab_p, counts_p = _cut(prob)
        np.testing.assert_array_equal(lab_k, lab_p)
        assert counts_k == counts_p
        assert launches == math.ceil(counts_k["rounds"] / 16) > 1


@pytest.mark.gpu
def test_kernel_repeats_bit_for_bit(cuda, monkeypatch):
    for prob in _banded_problems(monkeypatch):
        first = _cut(prob, cuda)
        for _ in range(3):
            again = _cut(prob, cuda)
            np.testing.assert_array_equal(again[0], first[0])
            assert again[1] == first[1]


@pytest.mark.gpu
def test_pairwise_seam_masks_equal_on_card_and_host(cuda, engine, ref,
                                                    monkeypatch):
    """The card's masks, built and cut on the card and returned there,
    equal the host engine's on CPU tensors, and those of the CPU path
    solved by the JAX package's solver (native/graphcut.cpp)."""
    pair = E._banded_pair()
    host = S.graphcut_pairwise_seam(*E._tensors(pair))
    card = S.graphcut_pairwise_seam(*E._tensors(pair, cuda))
    monkeypatch.setattr(N, "graphcut_native",
                        lambda *prob: E.solve_ref(ref, *prob)[0])
    with_ref = S.graphcut_pairwise_seam(*E._tensors(pair))
    assert host is not None and card is not None and with_ref is not None
    for m_h, m_c, m_r in zip(host, card, with_ref):
        assert m_c.is_cuda and m_c.dtype == torch.bool
        np.testing.assert_array_equal(m_c.cpu().numpy(), m_h.numpy())
        np.testing.assert_array_equal(m_c.cpu().numpy(), m_r.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("pair", ["small", "banded"])
def test_card_grids_equal_the_cpu_grids(cuda, engine, monkeypatch, pair):
    """The four capacity grids built on the card equal the CPU tensors'
    bit for bit: the whole box's problem, and every fine problem the
    pairwise path hands each solver (the coarse one may differ in its
    last bits: the area resize's sums run in another order)."""
    arrays = (E._small_pair if pair == "small" else E._banded_pair)()
    for c, h in zip(S._gc_problem(*E._tensors(arrays, cuda)),
                    S._gc_problem(*E._tensors(arrays))):
        assert c.is_cuda and c.dtype == torch.float32
        assert c.cpu().numpy().tobytes() == h.numpy().tobytes()
    card, host = [], []
    real_dev, real_host = M.graphcut_device, N.graphcut_native

    def on_card(*prob):
        card.append([c.cpu().numpy() for c in prob])
        return real_dev(*prob)

    def on_host(*prob):
        host.append([np.array(c) for c in prob])
        return real_host(*prob)

    monkeypatch.setattr(M, "graphcut_device", on_card)
    monkeypatch.setattr(N, "graphcut_native", on_host)
    S.graphcut_pairwise_seam(*E._tensors(arrays, cuda))
    S.graphcut_pairwise_seam(*E._tensors(arrays))
    assert [p[0].shape for p in card] == [p[0].shape for p in host]
    assert len(card) == (3 if pair == "banded" else 1)
    fine = card[1:] if pair == "banded" else card
    for p_c, p_h in zip(fine, host[len(host) - len(fine):]):
        for c, h in zip(p_c, p_h):
            assert c.tobytes() == h.tobytes()


@pytest.mark.gpu
def test_seam_spans_say_the_problem_stayed_on_the_card(cuda, engine):
    """On a card the ``seam problem`` spans carry ``device`` 1 and the
    pair's closing ``seam fetch`` under 1 KB of ``bytes`` (a few scalar
    reads); on CPU tensors ``device`` 0 and ``bytes`` 0."""
    log = get_logger()
    a, b, ma, mb = E._banded_pair()
    for dev, flag in ((cuda, 1), (CPU, 0)):
        n0 = len(log._records)
        methods = {}
        S.find_seams_sequential(E._tensors((a, b), dev),
                                E._tensors((ma, mb), dev),
                                method="graphcut", methods=methods)
        assert methods == {(0, 1): "graphcut"}
        recs = log._records[n0:]
        problems = [r for r in recs if r["msg"] == "seam problem done"]
        assert len(problems) == 2
        assert all(r["device"] == flag for r in problems)
        moved = [r["bytes"] for r in recs
                 if r["msg"] == "seam fetch done" and "bytes" in r]
        assert len(moved) == 1
        assert (0 < moved[0] < 1024) if flag else moved[0] == 0


@pytest.mark.gpu
def test_seam_solve_span_and_launch_counter(cuda, engine):
    log = get_logger()
    n0 = len(log._records)
    launches = M.min_cut.launches
    pair = E._banded_pair()
    S.graphcut_pairwise_seam(*E._tensors(pair, cuda))
    recs = [r for r in log._records[n0:] if r["msg"] == "seam solve done"]
    # coarse, fine, widened: each a solve on the card
    assert [r["nodes"] for r in recs] == [200 * 500, 400 * 1000,
                                          400 * 1000]
    # one launch a batch of rounds
    assert M.min_cut.launches - launches == sum(
        math.ceil(r["rounds"] / M.BATCH_ROUNDS) for r in recs) >= 3
    for r in recs:
        assert r["device"] == 1
        assert 0 < r["free"] <= r["nodes"]
        assert r["rounds"] > 0 and r["relabels"] >= 2
        assert all(type(r[k]) is int
                   for k in ("device", "free", "rounds", "relabels"))
    n0 = len(log._records)
    S.graphcut_pairwise_seam(*E._tensors(pair))
    recs = [r for r in log._records[n0:] if r["msg"] == "seam solve done"]
    assert [r["device"] for r in recs] == [0, 0, 0]
    assert all("augments" in r and "rounds" not in r for r in recs)
