// The global seam's min-cut on the card: synchronous push-relabel with
// int64 residuals over the free ribbon of a seam problem, in one
// cooperative launch.
//
// Replaces no TPU kernel: the JAX package solves every graph-cut seam on
// the host (native/graphcut.cpp, a Boykov-Kolmogorov max-flow), and so did
// the port (csrc/graphcut.cpp, called in line by ops/seam.py for the
// coarse, fine and widened solves) while the card sat idle, 0.7-3.8 s a
// solve. ops/maxflow_kernel.py contracts each problem to its free ribbon
// (every pinned and exclusive-region node joins its terminal), quantises it
// to int64 and packs it into 16 x 16 tiles that hold a free node; this file
// runs the max-flow over those tiles with source and sink exchanged, so the
// nodes that can reach the new sink at the end are the host engine's
// source-minimal source side (label 1).
//
// What bounds it: a solve is a few hundred to a few thousand rounds, each
// a pass over the slots (a round reads a slot's excess, incoming excess and
// heights and writes its next height, 36 bytes, and the arcs only of the
// active ones), so it is bound by the bytes of a round times the rounds,
// and by the two device-wide barriers of each round. The design: one
// persistent launch (co-resident blocks, cooperative_groups grid barriers)
// runs a batch of rounds and global relabels with no host in the loop; the
// host reads one flag a batch. The global relabel, the exact residual
// distance to the sink, relaxes each 16 x 16 tile to its own fixed point in
// shared memory before the next barrier, so a search takes about one
// barrier per tile crossed, not one per level. It runs every
// relabel_rounds rounds (64 measured best of 16-256) and also does the gap
// rule's work: a slot cut off from the sink is lifted to kInf there.
//
// A round is synchronous and its answer does not depend on the order of
// threads: in the push phase the heights are those of the round's start, so
// an arc is admissible in at most one direction and every residual has one
// writer; incoming excess is gathered with int64 atomicAdd, which commutes.
// The rounds, the relabels and the labels are those of the plain version
// (ops/maxflow_kernel.rounds_plain) bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileH = 16, kTileW = 16;  // ops/maxflow_kernel TILE_H, TILE_W
constexpr int kTile = kTileH * kTileW;   // one thread a slot
constexpr int kInf = 1 << 30;            // ops/maxflow_kernel INF

// ctl: [0] rounds, [1] global relabels, [2] done, [3..4] the rounds'
// active flags (by parity), [5..7] the search's changed flags (by
// iteration mod 3)
struct Args {
  int tiles;
  const int* nbr;      // (tiles, 4): right, left, down, up; -1 none
  long long* arcs;     // (4, n): residual right, left, down, up
  long long* rt;       // (n,): residual to the sink
  long long* e;        // (n,): excess
  long long* inc;      // (n,): excess pushed in this round
  int* heights;        // (2, n): this round's and the next round's
  long long* ctl;
  int dmax;            // a height this high cannot reach the sink
  int relabel_rounds;  // rounds between global relabels
  int batch;           // rounds this launch may run
};

// the slot next to slot s (tile t, row ly, column lx) in direction k, -1
// where that tile is not kept
__device__ __forceinline__ int neighbour(const int* nbr, int s, int t, int ly,
                                         int lx, int k) {
  int nt;
  switch (k) {
    case 0:
      if (lx < kTileW - 1) return s + 1;
      nt = nbr[4 * t + 0];
      return nt < 0 ? -1 : nt * kTile + ly * kTileW;
    case 1:
      if (lx > 0) return s - 1;
      nt = nbr[4 * t + 1];
      return nt < 0 ? -1 : nt * kTile + ly * kTileW + kTileW - 1;
    case 2:
      if (ly < kTileH - 1) return s + kTileW;
      nt = nbr[4 * t + 2];
      return nt < 0 ? -1 : nt * kTile + lx;
    default:
      if (ly > 0) return s - kTileW;
      nt = nbr[4 * t + 3];
      return nt < 0 ? -1 : nt * kTile + (kTileH - 1) * kTileW + lx;
  }
}

__device__ __forceinline__ long long vload(const long long* p) {
  return *(const volatile long long*)p;
}

// The exact residual distance to the sink into d: 1 on a slot with sink
// residual, one more than the nearest residual neighbour's elsewhere, kInf
// where no residual path leads to the sink. Each block relaxes its tiles to
// their own fixed point in shared memory, with the heights across the
// tile's edge as they were read; the sweeps repeat until one changes
// nothing. Relaxation only lowers a height towards its distance, so the
// fixed point is the distance whatever the order.
__device__ void global_relabel(const Args& a, int* d, size_t n,
                               cg::grid_group& grid) {
  __shared__ int sd[kTile];
  const int tid = threadIdx.x, ly = tid / kTileW, lx = tid % kTileW;
  const bool lead = blockIdx.x == 0 && tid == 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int s = t * kTile + tid;
    d[s] = a.rt[s] > 0 ? 1 : kInf;
  }
  if (lead) a.ctl[5] = 0;
  grid.sync();
  for (int it = 0;; ++it) {
    long long* flag = a.ctl + 5 + it % 3;
    if (lead) a.ctl[5 + (it + 1) % 3] = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const int s = t * kTile + tid;
      // the tile's arcs and the heights beyond its edge, read once
      int inside[4], outside[4];
      for (int k = 0; k < 4; ++k) {
        inside[k] = -1;
        outside[k] = kInf;
        if (a.arcs[k * n + s] <= 0) continue;
        const int w = neighbour(a.nbr, s, t, ly, lx, k);
        if (w < 0) continue;
        if (w / kTile == t)
          inside[k] = w - t * kTile;
        else
          outside[k] = d[w] < kInf ? d[w] + 1 : kInf;
      }
      const int d0 = d[s];
      int mine = d0;
      for (int k = 0; k < 4; ++k) mine = min(mine, outside[k]);
      sd[tid] = mine;
      __syncthreads();
      while (true) {
        int best = mine;
        for (int k = 0; k < 4; ++k)
          if (inside[k] >= 0 && sd[inside[k]] < kInf)
            best = min(best, sd[inside[k]] + 1);
        __syncthreads();
        const bool lower = best < mine;
        if (lower) sd[tid] = mine = best;
        if (!__syncthreads_or(lower)) break;
      }
      if (mine != d0) d[s] = mine;
      if (__syncthreads_or(mine != d0) && tid == 0) *flag = 1;
    }
    grid.sync();
    if (vload(flag) == 0) break;
  }
}

__global__ void __launch_bounds__(kTile)
maxflow_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const size_t n = (size_t)a.tiles * kTile;
  const int tid = threadIdx.x, ly = tid / kTileW, lx = tid % kTileW;
  const bool lead = blockIdx.x == 0 && tid == 0;
  long long round = vload(a.ctl + 0);
  long long relabels = vload(a.ctl + 1);
  if (lead) a.ctl[3] = a.ctl[4] = 0;
  grid.sync();
  bool done = false;
  for (int b = 0; b < a.batch; ++b) {
    int* d = a.heights + (round & 1) * n;
    int* dn = a.heights + ((round + 1) & 1) * n;
    if (round % a.relabel_rounds == 0) {
      global_relabel(a, d, n, grid);
      ++relabels;
    }
    // push phase: the round's heights; sink first, then right, left,
    // down, up, each admissible arc taking what excess is left
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const int s = t * kTile + tid;
      long long ev = a.e[s];
      const int dv = d[s];
      if (ev <= 0 || dv >= kInf) continue;
      if (dv == 1) {
        const long long r = a.rt[s];
        if (r > 0) {
          const long long f = min(ev, r);
          a.rt[s] = r - f;
          ev -= f;
        }
      }
      for (int k = 0; k < 4 && ev > 0; ++k) {
        const long long r = a.arcs[k * n + s];
        if (r <= 0) continue;
        const int w = neighbour(a.nbr, s, t, ly, lx, k);
        if (w < 0 || d[w] != dv - 1) continue;
        const long long f = min(ev, r);
        a.arcs[k * n + s] = r - f;
        a.arcs[(k ^ 1) * n + w] += f;
        atomicAdd((unsigned long long*)(a.inc + w), (unsigned long long)f);
        ev -= f;
      }
      a.e[s] = ev;
    }
    grid.sync();
    // relabel phase: incoming excess added; an active slot with no
    // admissible arc left rises to one above its lowest residual neighbour
    long long* active = a.ctl + 3 + (round & 1);
    if (lead) a.ctl[3 + ((round + 1) & 1)] = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const int s = t * kTile + tid;
      long long ev = a.e[s];
      const long long in = a.inc[s];
      if (in != 0) {
        ev += in;
        a.e[s] = ev;
        a.inc[s] = 0;
      }
      const int dv = d[s];
      int nd = dv;
      if (ev > 0 && dv < kInf) {
        const bool to_sink = a.rt[s] > 0;
        bool adm = to_sink && dv == 1;
        int low = to_sink ? 1 : kInf;
        for (int k = 0; k < 4; ++k) {
          if (a.arcs[k * n + s] <= 0) continue;
          const int w = neighbour(a.nbr, s, t, ly, lx, k);
          if (w < 0) continue;
          const int dw = d[w];
          adm |= dw == dv - 1;
          low = min(low, dw + 1);
        }
        if (!adm) nd = low >= a.dmax ? kInf : low;
      }
      dn[s] = nd;
      if (__syncthreads_or(ev > 0 && nd < kInf) && tid == 0) *active = 1;
    }
    grid.sync();
    ++round;
    if (vload(active) == 0) {
      done = true;
      break;
    }
  }
  if (done) {  // the labels: the heights that reach the sink
    global_relabel(a, a.heights + (round & 1) * n, n, grid);
    ++relabels;
  }
  if (lead) {
    a.ctl[0] = round;
    a.ctl[1] = relabels;
    a.ctl[2] = done;
  }
}

}  // namespace

// One launch of up to `batch` rounds on `stream` (all pointers on the
// card; see Args). The state lives in the arrays and ctl, so the next
// launch goes on where this one stopped; ctl[2] turns 1 when no slot is
// active, and then heights[ctl[0] % 2] holds the final distances: a slot
// below kInf can reach the sink. Returns the launch's cudaError.
extern "C" int maxflow_run(int tiles, const int* nbr, long long* arcs,
                           long long* rt, long long* e, long long* inc,
                           int* heights, long long* ctl, int dmax,
                           int relabel_rounds, int batch, void* stream) {
  if (tiles < 1 || relabel_rounds < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, maxflow_kernel, kTile, 0);
  if (err != cudaSuccess) return (int)err;
  const int resident = per_sm * sms;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int blocks = tiles < resident ? tiles : resident;
  Args a{tiles, nbr, arcs, rt, e, inc, heights, ctl, dmax, relabel_rounds,
         batch};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)maxflow_kernel, blocks,
                                    kTile, params, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
