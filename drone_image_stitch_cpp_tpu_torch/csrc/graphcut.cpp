// The port's host-side graph-cut seam solver (utils/native.graphcut_native).
//
// The same problem, result and C ABI as the JAX package's solver,
// native/graphcut.cpp, which stays unchanged as the reference the tests hold
// this one against: a Boykov-Kolmogorov max-flow on the 4-connected overlap
// grid with implicit grid arcs, float32 residuals and the terminal capacities
// collapsed into one signed residual per node. What differs is the search
// trees' bookkeeping, which decides how fast a solve is on the long, thin
// free ribbons of a banded seam problem, where both trees grow in deep from
// the pinned band edges:
//
//  * orphans are adopted first-in first-out (a queue with a moving head), as
//    in Kolmogorov's maxflow-v3: an orphan close to the saturated arc finds a
//    parent before its subtree is orphaned node by node;
//  * a node's whole state (four residuals, terminal residual, time stamp,
//    distance, tree, parent, active flag and which neighbours exist) is one
//    32-byte record, so a visit touches one cache line, not nine arrays and
//    no division; the records are written once, by blocks of rows on several
//    threads when the grid is large, into memory the operating system is
//    asked to back with huge pages (a step to the row above or below is a
//    stride of w records);
//  * at the start a root is made active only if it has a residual arc to a
//    node outside its own tree. A root whose every residual neighbour is a
//    root of its tree can neither grow nor bridge, and is re-activated by the
//    usual event if a neighbour ever leaves the tree;
//  * an augmentation walks its two tree paths in one interleaved loop, so
//    the two chains of dependent loads overlap their cache misses;
//  * growth re-parents a node of its own tree reached along a residual arc
//    when that shortens the node's last known distance to the terminal, as
//    maxflow-v3 does: shallower trees make shorter augmenting paths and
//    origin walks. (Towards the root, time stamps never fall and, among
//    equal stamps, distances fall, so the new parent is never a
//    descendant.)
//
// None of these changes which cut is found: at termination the source tree is
// the set of nodes reachable from the source in the final residual graph (the
// source-minimal minimum cut); the order of work changes only the route the
// flow takes.
//
// Exported C ABI:
//   tm_graphcut(h, w, cap_src, cap_snk, cap_h, cap_v, labels_out, counts_out)
//       -> flow
//     cap_src/cap_snk: (h*w) terminal capacities (float32)
//     cap_h: (h*(w-1)) symmetric horizontal neighbor capacities
//     cap_v: ((h-1)*w) symmetric vertical neighbor capacities
//     labels_out: (h*w) uint8; 1 = source side (image A), 0 = sink side
//     counts_out: int64[3]: augmentations, orphans processed, roots made
//       active at the start

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <memory>
#include <new>
#include <sys/mman.h>
#include <thread>
#include <vector>

namespace {

constexpr float kEps = 1e-12f;

// parent encodings beyond the 4 grid directions
constexpr uint8_t kParTerminal = 4;
constexpr uint8_t kParNone = 5;

constexpr uint8_t kFree = 0, kTreeS = 1, kTreeT = 2;

// rc[0] = residual i -> i+1 (right), rc[1] = i -> i-1 (left),
// rc[2] = i -> i+w (down), rc[3] = i -> i-w (up); the sister of (i, d) is
// (nbr, d^1). tr > 0 = residual src->i, tr < 0 = residual i->snk.
struct alignas(32) Node {
  float rc[4];
  float tr;
  int ts;
  int dist;
  uint8_t tree, par, act;
  uint8_t nb;  // bit d set: the neighbour in direction d exists
};
static_assert(sizeof(Node) == 32, "a node is half a cache line");

// rows per block of the grid's parallel passes (fixed, so the blocks, and
// the order their partial sums are added in, do not depend on the threads)
constexpr int kBlockRows = 64;
// below this many nodes a pass runs on the calling thread alone
constexpr int kParallelNodes = 1 << 20;

// fn(b) for each block b of kBlockRows rows of an h-row grid of n nodes, on
// up to 8 threads when the grid is large (the passes are bound by memory
// bandwidth, which a few threads fill)
template <class Fn>
void for_blocks(int h, int n, Fn fn) {
  const int blocks = (h + kBlockRows - 1) / kBlockRows;
  const int cores = static_cast<int>(std::thread::hardware_concurrency());
  const int threads =
      n < kParallelNodes ? 1 : std::min({8, blocks, std::max(1, cores)});
  std::atomic<int> next{0};
  auto work = [&] {
    for (int b; (b = next.fetch_add(1)) < blocks;) fn(b);
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
}

class BKGrid {
 public:
  // one pass over the grid writes each node's record once (row blocks in
  // parallel on a large grid); the frontier roots are made active in index
  // order
  BKGrid(int h, int w, const float* cap_src, const float* cap_snk,
         const float* cap_h, const float* cap_v)
      : h_(h), w_(w), n_(h * w), mem_(alloc_nodes(n_)), nd_(mem_.get()) {
    active_.reserve(n_ / 64 + 16);
    orphans_.reserve(1024);
    const int blocks = (h_ + kBlockRows - 1) / kBlockRows;
    std::vector<std::vector<int>> roots(blocks);
    std::vector<double> base(blocks);
    for_blocks(h_, n_, [&](int b) {
      base[b] = build_rows(b * kBlockRows, std::min(h_, (b + 1) * kBlockRows),
                           cap_src, cap_snk, cap_h, cap_v, roots[b]);
    });
    for (int b = 0; b < blocks; ++b) {
      base_flow_ += base[b];
      for (int i : roots[b]) push_active(i);
      active_roots_ += static_cast<int64_t>(roots[b].size());
    }
  }

  double maxflow() {
    double flow = 0.0;
    while (true) {
      // ---- grow: find an augmenting bridge arc between the trees ----
      int sp = -1, tp = -1, bridge_d = -1;
      while (head_ < active_.size()) {
        const int p = active_[head_];
        Node& np = nd_[p];
        if (np.tree == kFree) {  // stale entry
          pop_active();
          continue;
        }
        const bool in_s = np.tree == kTreeS;
        bool found = false;
        for (int d = 0; d < 4; ++d) {
          if (!(np.nb >> d & 1)) continue;
          const int q = nbr(p, d);
          Node& nq = nd_[q];
          // S grows along residual p->q; T grows along residual q->p
          const float r = in_s ? np.rc[d] : nq.rc[d ^ 1];
          if (r <= kEps) continue;
          if (nq.tree == kFree) {
            nq.tree = np.tree;
            nq.par = static_cast<uint8_t>(d ^ 1);
            nq.ts = np.ts;
            nq.dist = np.dist + 1;
            push_active(q);
          } else if (nq.tree == np.tree) {
            if (nq.ts <= np.ts && nq.dist > np.dist) {
              nq.par = static_cast<uint8_t>(d ^ 1);
              nq.ts = np.ts;
              nq.dist = np.dist + 1;
            }
          } else {
            if (in_s) {
              sp = p; tp = q; bridge_d = d;
            } else {
              sp = q; tp = p; bridge_d = d ^ 1;
            }
            found = true;
            break;
          }
        }
        if (found) break;
        pop_active();  // all arcs scanned; reactivated by events
      }
      if (sp < 0) break;  // trees can no longer meet: done

      ++time_;
      ++augments_;
      flow += augment(sp, tp, bridge_d);
      adopt_all();
    }
    return flow + base_flow_;
  }

  bool source_side(int i) const { return nd_[i].tree == kTreeS; }

  void counts(int64_t* out) const {
    out[0] = augments_;
    out[1] = orphans_done_;
    out[2] = active_roots_;
  }

 private:
  inline int nbr(int i, int d) const {
    switch (d) {
      case 0: return i + 1;
      case 1: return i - 1;
      case 2: return i + w_;
      default: return i - w_;
    }
  }

  // rows [y0, y1): each node's residuals, terminal residual and, for a root,
  // its tree; a root goes to ``roots`` only if an arc with capacity leads to
  // a node of another class (a free node or the other tree's root; arcs are
  // symmetric at the start). Returns the rows' share of the base flow.
  double build_rows(int y0, int y1, const float* cap_src,
                    const float* cap_snk, const float* cap_h,
                    const float* cap_v, std::vector<int>& roots) {
    auto cls = [&](int j) -> uint8_t {
      const float t = cap_src[j] - cap_snk[j];
      return t > kEps ? kTreeS : (t < -kEps ? kTreeT : kFree);
    };
    double base = 0.0;
    for (int y = y0, i = y0 * w_; y < y1; ++y)
      for (int x = 0; x < w_; ++x, ++i) {
        Node& a = nd_[i];
        a.rc[0] = x + 1 < w_ ? cap_h[y * (w_ - 1) + x] : 0.0f;
        a.rc[1] = x > 0 ? cap_h[y * (w_ - 1) + x - 1] : 0.0f;
        a.rc[2] = y + 1 < h_ ? cap_v[i] : 0.0f;
        a.rc[3] = y > 0 ? cap_v[i - w_] : 0.0f;
        // terminal collapse: the min(cap_src, cap_snk) component saturates
        // either way and never affects the partition
        a.tr = cap_src[i] - cap_snk[i];
        base += std::min(cap_src[i], cap_snk[i]);
        a.ts = 0;
        a.tree = cls(i);
        a.par = a.tree == kFree ? kParNone : kParTerminal;
        a.dist = a.tree == kFree ? 0 : 1;
        a.act = 0;
        a.nb = (x + 1 < w_ ? 1 : 0) | (x > 0 ? 2 : 0) | (y + 1 < h_ ? 4 : 0) |
               (y > 0 ? 8 : 0);
        if (a.tree == kFree) continue;
        for (int d = 0; d < 4; ++d)
          if ((a.nb >> d & 1) && a.rc[d] > kEps &&
              cls(nbr(i, d)) != a.tree) {
            roots.push_back(i);
            break;
          }
      }
    return base;
  }

  inline void push_active(int i) {
    if (!nd_[i].act) {
      nd_[i].act = 1;
      active_.push_back(i);
    }
  }
  inline void pop_active() {
    nd_[active_[head_]].act = 0;
    ++head_;
    if (head_ > 4096 && head_ * 2 > active_.size()) {
      active_.erase(active_.begin(), active_.begin() + head_);
      head_ = 0;
    }
  }

  inline void orphan(int i) {
    nd_[i].par = kParNone;
    orphans_.push_back(i);
  }

  float augment(int sp, int tp, int d) {
    // bottleneck over bridge + both tree paths + terminal residuals;
    // tree roots are captured here, BEFORE orphaning breaks parent chains
    float bn = nd_[sp].rc[d];
    // the two trees' walks are independent chains of loads: interleaved,
    // their cache misses overlap
    int s_root = sp, t_root = tp;
    bool s_end = nd_[s_root].par == kParTerminal;
    bool t_end = nd_[t_root].par == kParTerminal;
    while (!(s_end && t_end)) {
      if (!s_end) {
        const int pd = nd_[s_root].par;
        const int j = nbr(s_root, pd);
        bn = std::min(bn, nd_[j].rc[pd ^ 1]);  // arc parent -> node
        s_root = j;
        s_end = nd_[j].par == kParTerminal;
      }
      if (!t_end) {
        const int pd = nd_[t_root].par;
        bn = std::min(bn, nd_[t_root].rc[pd]);  // arc node -> parent
        t_root = nbr(t_root, pd);
        t_end = nd_[t_root].par == kParTerminal;
      }
    }
    bn = std::min(bn, nd_[s_root].tr);
    bn = std::min(bn, -nd_[t_root].tr);

    // apply along the bridge
    nd_[sp].rc[d] -= bn;
    nd_[tp].rc[d ^ 1] += bn;
    // S side: saturated parent arcs orphan the CHILD
    for (int i = sp; nd_[i].par != kParTerminal;) {
      const int pd = nd_[i].par;
      const int j = nbr(i, pd);
      nd_[i].rc[pd] += bn;
      float& r = nd_[j].rc[pd ^ 1];
      r -= bn;
      if (r <= kEps) orphan(i);
      i = j;
    }
    Node& s = nd_[s_root];
    s.tr -= bn;
    if (s.tr <= kEps && s.par == kParTerminal) orphan(s_root);
    // T side
    for (int i = tp; nd_[i].par != kParTerminal;) {
      const int pd = nd_[i].par;
      const int j = nbr(i, pd);
      float& r = nd_[i].rc[pd];
      r -= bn;
      nd_[j].rc[pd ^ 1] += bn;
      if (r <= kEps) orphan(i);
      i = j;
    }
    Node& t = nd_[t_root];
    t.tr += bn;
    if (t.tr >= -kEps && t.par == kParTerminal) orphan(t_root);
    return bn;
  }

  // origin check with path marking: distance to the terminal, or -1 when
  // the chain dead-ends in an orphan
  int origin_dist(int start) {
    int d = 0;
    int i = start;
    while (true) {
      const Node& a = nd_[i];
      if (a.ts == time_) { d += a.dist; break; }
      if (a.par == kParTerminal) { d += 1; break; }
      if (a.par == kParNone) return -1;
      ++d;
      i = nbr(i, a.par);
    }
    // mark the walked prefix so later checks are O(1)
    int dd = d;
    i = start;
    while (nd_[i].ts != time_) {
      Node& a = nd_[i];
      a.ts = time_;
      a.dist = dd;
      --dd;
      if (a.par == kParTerminal) break;
      i = nbr(i, a.par);
    }
    return d;
  }

  void adopt_all() {
    for (size_t k = 0; k < orphans_.size(); ++k) {
      const int o = orphans_[k];
      Node& no = nd_[o];
      const uint8_t t = no.tree;
      if (t == kFree) continue;
      ++orphans_done_;
      const bool in_s = t == kTreeS;
      int best_d = -1, best_dist = 1 << 30;
      for (int d = 0; d < 4; ++d) {
        if (!(no.nb >> d & 1)) continue;
        const int q = nbr(o, d);
        if (nd_[q].tree != t) continue;
        // S needs residual q->o (arc from q toward o is (q, d^1));
        // T needs residual o->q
        const float r = in_s ? nd_[q].rc[d ^ 1] : no.rc[d];
        if (r <= kEps) continue;
        const int dd = origin_dist(q);
        if (dd >= 0 && dd < best_dist) {
          best_dist = dd;
          best_d = d;
        }
      }
      if (best_d >= 0) {
        no.par = static_cast<uint8_t>(best_d);
        no.ts = time_;
        no.dist = best_dist + 1;
        continue;
      }
      // no parent: o leaves the tree; neighbors that could reach it get
      // reactivated, children become orphans
      for (int d = 0; d < 4; ++d) {
        if (!(no.nb >> d & 1)) continue;
        const int q = nbr(o, d);
        if (nd_[q].tree != t) continue;
        const float r = in_s ? nd_[q].rc[d ^ 1] : no.rc[d];
        if (r > kEps) push_active(q);
        if (nd_[q].par == (d ^ 1)) orphan(q);  // q's parent is o
      }
      no.tree = kFree;
    }
    orphans_.clear();
  }

  int h_, w_, n_;
  double base_flow_ = 0.0;
  int time_ = 0;
  struct FreeNodes {
    void operator()(Node* p) const { std::free(p); }
  };
  // uninitialised records (the constructor writes each once), 2 MiB aligned
  // and advised as huge pages: fewer page faults in the build and fewer TLB
  // misses on the vertical steps
  static Node* alloc_nodes(int n) {
    const size_t huge = size_t(1) << 21;
    const size_t bytes =
        std::max<size_t>(1, (size_t(n) * sizeof(Node) + huge - 1) / huge) *
        huge;
    void* p = std::aligned_alloc(huge, bytes);
    if (p == nullptr) throw std::bad_alloc();
    madvise(p, bytes, MADV_HUGEPAGE);
    return static_cast<Node*>(p);
  }
  std::unique_ptr<Node, FreeNodes> mem_;
  Node* nd_;
  std::vector<int> active_;
  size_t head_ = 0;
  std::vector<int> orphans_;
  int64_t augments_ = 0, orphans_done_ = 0, active_roots_ = 0;
};

}  // namespace

extern "C" {

double tm_graphcut(int h, int w, const float* cap_src,
                   const float* cap_snk, const float* cap_h,
                   const float* cap_v, unsigned char* labels_out,
                   int64_t* counts_out) {
  BKGrid g(h, w, cap_src, cap_snk, cap_h, cap_v);
  double flow = g.maxflow();
  for_blocks(h, h * w, [&](int b) {
    const int end = std::min(h, (b + 1) * kBlockRows) * w;
    for (int i = b * kBlockRows * w; i < end; ++i)
      labels_out[i] = g.source_side(i) ? 1 : 0;
  });
  g.counts(counts_out);
  return flow;
}

}  // extern "C"
