"""The global seam's min-cut on the card: ``csrc/maxflow.cu`` and its plain
version.

The problem is the host engine's (``utils/native.graphcut_native``,
``csrc/graphcut.cpp``): a 4-connected (h, w) grid with terminal
capacities ``cap_src`` / ``cap_snk``, symmetric horizontal arcs ``cap_h``
(h, w-1) and vertical arcs ``cap_v`` (h-1, w), all float32; the labels
(1 = source side) are the source-minimal minimum cut, the nodes reachable
from the source in the final residual graph, as the engine returns them.
The solve here keeps that answer in four steps:

1. **Contraction** (float64, on the tensors' device). A node whose
   collapsed terminal residual ``cap_src - cap_snk`` exceeds the sum of its
   four arcs is on the source side of every minimum cut; one whose sink
   residual is at least that sum is on the sink side of the source-minimal
   cut. Both join their terminal: a free node's arcs to them fold into its
   own terminal residual, arcs between two of them are a constant of the
   cut. Every pinned (1e8) and exclusive-region node of a seam problem is
   contracted, so what is left is the free ribbon along the seam.
2. **Integer residuals.** The free problem is quantised to int64 at a
   power-of-two scale chosen so that its whole supply fits in 2**62:
   max-flow is then exact arithmetic, and the source-minimal cut of the
   quantised problem is one set whatever the order of the work.
3. **Terminal swap.** Push-relabel's first phase finds the nodes that can
   reach the sink. Run with source and sink exchanged (the grid arcs are
   symmetric, so only the terminal residuals swap), the nodes that can then
   reach the new sink are the original problem's source-minimal source
   side: no second phase.
4. **Rounds.** Synchronous push-relabel over the free nodes, packed into
   tiles of ``TILE_H`` x ``TILE_W`` that hold at least one: each round a
   push phase (every active node pushes along its admissible arcs, sink
   first, then right, left, down, up, with the heights of the round's
   start) and a relabel phase (incoming excess added, every active node
   left without an admissible arc lifted to one more than its lowest
   residual neighbour). A global relabel (the exact residual distance to
   the new sink, a breadth-first search) runs before the first round and
   every ``RELABEL_ROUNDS`` rounds; the last one, after no node is active,
   gives the labels.

CUDA tensors launch ``csrc/maxflow.cu`` (one cooperative launch runs
batches of rounds and global relabels, the host reads one flag a batch);
CPU tensors run :func:`rounds_plain`, the same rounds in tensor code.
Both give the same labels, rounds and relabels, bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..runtime.kernels import load_kernel, stream_handle
from ..runtime.logging import get_logger

KERNEL_SOURCE = "maxflow.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL_SIGNATURES = {
    # tiles, neighbour tiles, arcs, sink residual, excess, incoming
    # excess, heights (2 buffers), control block, height cap, rounds
    # between global relabels, rounds in this launch, stream
    "maxflow_run": (_I, [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
}
TILE_H, TILE_W = 16, 16         # csrc/maxflow.cu's kTileH, kTileW
TILE = TILE_H * TILE_W
INF = 1 << 30                   # the height of a slot with no path to the sink
RELABEL_ROUNDS = 64             # rounds between global relabels
BATCH_ROUNDS = 4096             # rounds a launch may run before the host looks
MAX_ROUNDS = 1 << 24            # a solve that has not ended by then raises
_SUPPLY_BITS = 62


@dataclass
class Ribbon:
    """A problem contracted to its free nodes, packed in tiles.

    ``src``: (h, w) bool, nodes contracted to the source (label 1);
    ``free``: (h, w) bool, the nodes the rounds solve; ``tiles``: (T,)
    index of each kept tile in the row-major grid of ``th`` x ``tw``
    tiles; ``nbr``: (T, 4) int32, the kept tile to the right, left, below
    and above (-1: none); ``arcs``: (4, T * TILE) int64 residuals of each
    slot's right, left, down and up arcs (0 to any node that is not free);
    ``tr``: (T * TILE,) int64, the folded terminal residual (> 0 towards
    the source; 0, like every arc, on a slot that is not free);
    ``scale``: the quantisation (residual = round(capacity x scale))."""

    h: int
    w: int
    th: int
    tw: int
    src: torch.Tensor
    free: torch.Tensor
    tiles: torch.Tensor
    nbr: torch.Tensor
    arcs: torch.Tensor
    tr: torch.Tensor
    n_free: int
    scale: float


def _node_arcs(cap_h: torch.Tensor, cap_v: torch.Tensor, h: int, w: int):
    """(4, h, w) capacity of each node's right, left, down and up arc."""
    a = torch.zeros((4, h, w), dtype=cap_h.dtype, device=cap_h.device)
    if w > 1:
        a[0, :, :-1] = cap_h
        a[1, :, 1:] = cap_h
    if h > 1:
        a[2, :-1, :] = cap_v
        a[3, 1:, :] = cap_v
    return a


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x at each node's neighbour in direction k (right, left, down, up);
    ``fill`` beyond the grid."""
    out = torch.full_like(x, fill)
    if k == 0:
        out[..., :, :-1] = x[..., :, 1:]
    elif k == 1:
        out[..., :, 1:] = x[..., :, :-1]
    elif k == 2:
        out[..., :-1, :] = x[..., 1:, :]
    else:
        out[..., 1:, :] = x[..., :-1, :]
    return out


def supply_scale(bound: float) -> float:
    """The power of two that maps a free problem whose residuals sum to at
    most ``bound`` (capacity units) into 2**62: every excess, residual and
    their sums then fit in int64."""
    if not bound > 0.0:
        return 1.0
    _, e = math.frexp(bound)        # bound < 2**e
    return math.ldexp(1.0, _SUPPLY_BITS - e)


def contract(cap_src, cap_snk, cap_h, cap_v) -> Ribbon:
    """Contract a problem given as tensors (any one device) to its free
    ribbon and pack it into tiles, on that device."""
    cs = cap_src.to(torch.float64)
    h, w = cs.shape
    dev = cs.device
    arcs = _node_arcs(cap_h.to(torch.float64), cap_v.to(torch.float64), h, w)
    tr = cs - cap_snk.to(torch.float64)
    csum = arcs.sum(0)
    src = tr > csum
    snk = -tr >= csum
    free = ~(src | snk)
    side = src.to(torch.float64) - snk.to(torch.float64)
    for k in range(4):
        nb_side = _shift(side, k, 0.0)
        tr = tr + arcs[k] * nb_side
        arcs[k] = arcs[k] * (_shift(free, k, False) & free)
    tr = tr * free
    n_free = int(free.sum())
    bound = (n_free * float(tr.abs().max()) + 2.0 * float(arcs.max())
             if n_free else 0.0)
    scale = supply_scale(bound)
    qtr = torch.round(tr * scale).to(torch.int64)
    qarcs = torch.round(arcs * scale).to(torch.int64)

    th, tw = -(-h // TILE_H), -(-w // TILE_W)

    def tiled(x):
        """(..., h, w) -> (..., th * tw, TILE), zero-padded."""
        lead = x.shape[:-2]
        p = torch.zeros(lead + (th * TILE_H, tw * TILE_W), dtype=x.dtype,
                        device=dev)
        p[..., :h, :w] = x
        p = p.view(lead + (th, TILE_H, tw, TILE_W))
        p = p.transpose(-3, -2)
        return p.reshape(lead + (th * tw, TILE))

    tfree = tiled(free)
    tiles = torch.nonzero(tfree.any(-1)).squeeze(1)
    t = tiles.numel()
    tid = torch.full((th + 2, tw + 2), -1, dtype=torch.int32, device=dev)
    inner = torch.full((th * tw,), -1, dtype=torch.int32, device=dev)
    inner[tiles] = torch.arange(t, dtype=torch.int32, device=dev)
    tid[1:-1, 1:-1] = inner.view(th, tw)
    ty, tx = tiles // tw + 1, tiles % tw + 1
    nbr = torch.stack([tid[ty, tx + 1], tid[ty, tx - 1], tid[ty + 1, tx],
                       tid[ty - 1, tx]], 1).contiguous()
    return Ribbon(
        h=h, w=w, th=th, tw=tw, src=src, free=free, tiles=tiles, nbr=nbr,
        arcs=tiled(qarcs)[:, tiles].reshape(4, t * TILE).contiguous(),
        tr=tiled(qtr)[tiles].reshape(-1).contiguous(), n_free=n_free,
        scale=scale)


def _slot_neighbours(rib: Ribbon) -> torch.Tensor:
    """(4, T * TILE) long: each slot's neighbour slot to the right, left,
    below and above, T * TILE (a dummy slot) where that tile is not
    kept."""
    t = rib.tiles.numel()
    dev = rib.tr.device
    dummy = t * TILE
    s = torch.arange(t * TILE, device=dev)
    tile, ly, lx = s // TILE, (s % TILE) // TILE_W, s % TILE_W
    nbr = rib.nbr.to(torch.int64)

    def across(k, inside, same, other):
        nt = nbr[tile, k]
        out = torch.where(nt >= 0, nt * TILE + other, dummy)
        return torch.where(inside, same, out)

    return torch.stack([
        across(0, lx < TILE_W - 1, s + 1, ly * TILE_W),
        across(1, lx > 0, s - 1, ly * TILE_W + TILE_W - 1),
        across(2, ly < TILE_H - 1, s + TILE_W, lx),
        across(3, ly > 0, s - TILE_W, (TILE_H - 1) * TILE_W + lx)])


def _bfs_plain(arcs, rt, nb):
    """Exact residual distance of every slot to the sink (1 for a slot
    with sink residual), INF where there is none; ``arcs`` and the
    heights carry the dummy slot last."""
    inf = torch.tensor(INF, dtype=torch.int32, device=rt.device)
    d = torch.where(rt > 0, 1, inf).to(torch.int32)
    d = torch.cat([d, inf.view(1)])
    while True:
        best = d[:-1]
        for k in range(4):
            best = torch.minimum(best, torch.where(
                arcs[k, :-1] > 0, d[nb[k]] + 1, inf))
        if torch.equal(best, d[:-1]):
            return d
        d = torch.cat([best, inf.view(1)])


def rounds_plain(rib: Ribbon):
    """The rounds of ``csrc/maxflow.cu`` in tensor code: (source-side bool
    per slot, rounds, global relabels)."""
    n = rib.tr.numel()
    dev = rib.tr.device
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    nb = _slot_neighbours(rib)
    arcs = torch.cat([rib.arcs, torch.zeros((4, 1), dtype=torch.int64,
                                            device=dev)], 1)
    # source and sink exchanged: the sink's side supplies the excess,
    # the source's side drains it
    e = torch.cat([(-rib.tr).clamp(min=0), zero])
    rt = rib.tr.clamp(min=0)
    dmax = rib.n_free + 1
    inf = torch.tensor(INF, dtype=torch.int32, device=dev)
    rounds = relabels = 0
    while True:
        if rounds % RELABEL_ROUNDS == 0:
            d = _bfs_plain(arcs, rt, nb)
            relabels += 1
        if rounds >= MAX_ROUNDS:
            raise RuntimeError(f"min-cut did not converge in {rounds} rounds")
        dv = d[:-1]
        # push phase: heights fixed, excess of the round's start
        act = (e[:-1] > 0) & (dv < INF)
        rem = torch.where(act, e[:-1], 0)
        dl = torch.minimum(rem, torch.where(dv == 1, rt, 0))
        rt = rt - dl
        rem = rem - dl
        inc = torch.zeros_like(e)
        for k in range(4):
            adm = (arcs[k, :-1] > 0) & (d[nb[k]] == dv - 1)
            dl = torch.minimum(rem, torch.where(adm, arcs[k, :-1], 0))
            rem = rem - dl
            arcs[k, :-1] -= dl
            arcs[k ^ 1].index_add_(0, nb[k], dl)
            inc.index_add_(0, nb[k], dl)
        e = torch.cat([torch.where(act, rem, e[:-1]), zero]) + inc
        e[-1] = 0
        arcs[:, -1] = 0
        # relabel phase: heights of the round's start
        act = (e[:-1] > 0) & (dv < INF)
        adm = (rt > 0) & (dv == 1)
        low = torch.where(rt > 0, 1, inf)
        for k in range(4):
            res = arcs[k, :-1] > 0
            dn = d[nb[k]]
            adm |= res & (dn == dv - 1)
            low = torch.minimum(low, torch.where(res, dn + 1, inf))
        low = torch.where(low >= dmax, inf, low).to(torch.int32)
        dv = torch.where(act & ~adm, low, dv)
        d = torch.cat([dv, inf.view(1)])
        rounds += 1
        if not bool(((e[:-1] > 0) & (dv < INF)).any()):
            break
    d = _bfs_plain(arcs, rt, nb)
    relabels += 1
    return d[:-1] < INF, rounds, relabels


def _labels(rib: Ribbon, side: torch.Tensor) -> torch.Tensor:
    """(h, w) uint8 labels: the source-contracted nodes and the free
    nodes on the source side."""
    t = rib.tiles.numel()
    full = torch.zeros((rib.th * rib.tw, TILE), dtype=torch.bool,
                       device=side.device)
    full[rib.tiles] = side.view(t, TILE)
    full = full.view(rib.th, rib.tw, TILE_H, TILE_W).transpose(1, 2)
    full = full.reshape(rib.th * TILE_H, rib.tw * TILE_W)[:rib.h, :rib.w]
    return (rib.src | (rib.free & full)).to(torch.uint8)


def rounds_kernel(rib: Ribbon):
    """The rounds on the card: (source-side bool per slot, rounds,
    global relabels). One launch of ``maxflow_run`` a batch of up to
    ``BATCH_ROUNDS`` rounds, each counted in ``min_cut.launches``."""
    fns = load_kernel(KERNEL_SOURCE, KERNEL_SIGNATURES).fns
    dev = rib.tr.device
    n = rib.tr.numel()
    arcs = rib.arcs.clone()
    rt = rib.tr.clamp(min=0)
    e = (-rib.tr).clamp(min=0)
    inc = torch.zeros_like(e)
    heights = torch.empty((2, n), dtype=torch.int32, device=dev)
    # rounds, relabels, done, the rounds' two active flags, the search's
    # three changed flags
    ctl = torch.zeros((8,), dtype=torch.int64, device=dev)
    ctl_h = np.zeros(8, np.int64)
    while True:
        with torch.cuda.device(dev):
            err = fns["maxflow_run"](
                rib.tiles.numel(), rib.nbr.data_ptr(), arcs.data_ptr(),
                rt.data_ptr(), e.data_ptr(), inc.data_ptr(),
                heights.data_ptr(), ctl.data_ptr(), rib.n_free + 1,
                RELABEL_ROUNDS, BATCH_ROUNDS, stream_handle(dev))
        if err != 0:
            raise RuntimeError(f"maxflow_run launch failed: cudaError {err}")
        min_cut.launches += 1
        ctl_h[:] = ctl.cpu().numpy()
        if ctl_h[2]:
            break
        if ctl_h[0] >= MAX_ROUNDS:
            raise RuntimeError(f"min-cut did not converge in {ctl_h[0]} "
                               "rounds")
    rounds = int(ctl_h[0])
    return heights[rounds % 2] < INF, rounds, int(ctl_h[1])


def min_cut(cap_src, cap_snk, cap_h, cap_v):
    """Source-minimal min-cut labels (h, w) uint8 of the grid problem given
    as float32 tensors on one device, and the counts {free, rounds,
    relabels}. CUDA tensors launch ``csrc/maxflow.cu`` through
    :func:`rounds_kernel` (each launch counted in ``min_cut.launches``);
    CPU tensors run :func:`rounds_plain`."""
    h, w = cap_src.shape
    shapes = [tuple(c.shape) for c in (cap_snk, cap_h, cap_v)]
    if shapes != [(h, w), (h, max(w - 1, 0)), (max(h - 1, 0), w)] \
            or h < 1 or w < 1:
        raise ValueError(f"capacities of a ({h}, {w}) grid expected, got "
                         f"{[tuple(cap_src.shape)] + shapes}")
    rib = contract(cap_src, cap_snk, cap_h, cap_v)
    if rib.n_free == 0:
        side = torch.zeros_like(rib.tr, dtype=torch.bool)
        rounds = relabels = 0
    elif rib.tr.device.type == "cuda":
        side, rounds, relabels = rounds_kernel(rib)
    else:
        side, rounds, relabels = rounds_plain(rib)
    return _labels(rib, side), {"free": rib.n_free, "rounds": rounds,
                                "relabels": relabels}


min_cut.launches = 0


def graphcut_device(cap_src: torch.Tensor, cap_snk: torch.Tensor,
                    cap_h: torch.Tensor, cap_v: torch.Tensor
                    ) -> torch.Tensor:
    """:func:`utils.native.graphcut_native`'s labels, (h, w) uint8 on the
    grids' device, of the four float32 capacity grids on one card, solved
    there by :func:`min_cut`: one ``seam solve`` span from the
    contraction to the last round, with ``nodes`` = h x w and the counts
    ``device`` (1 on a card), ``free``, ``rounds`` and ``relabels``."""
    h, w = cap_src.shape
    with get_logger().span("seam solve", nodes=h * w) as counters:
        lab, counts = min_cut(cap_src, cap_snk, cap_h, cap_v)
        counters.update(device=int(cap_src.is_cuda), **counts)
    return lab
