// Native s-t max-flow / min-cut for graph-cut surface extraction.
//
// The runtime counterpart of the reference's IBFS max-flow
// (ref: frame_main/libs/Math/IBFS/IBFS.h — used by the Delaunay graph-cut
// in frame_main/libs/MVS/SceneReconstruct.cpp:58-101).  Written from
// scratch as a Boykov-Kolmogorov-style dual-tree augmenting-path solver:
// the standard choice for vision min-cut instances (sparse, shallow,
// integer-ish capacities), 1-2 orders of magnitude faster than generic
// preflow/BFS codes (e.g. scipy.sparse.csgraph.maximum_flow) on
// tetrahedralization graphs.
//
// Graph model: n regular nodes; terminal capacities are folded into a
// per-node residual tr_cap (positive = edge from source, negative = edge
// to sink), pairwise edges are arc pairs with independent residuals.
//
// C ABI only — bound from Python via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kNone = -1;
constexpr int32_t kTerminal = -2;  // parent arc marker: parented by tr_cap
constexpr int32_t kOrphan = -3;

struct Solver {
  int32_t n;
  // arcs: 2*m entries, arc a has sister a^1
  std::vector<int32_t> head;     // target node of arc
  std::vector<int32_t> next;     // next arc out of the same node
  std::vector<float> rcap;       // residual capacity of arc
  std::vector<int32_t> first;    // first arc of node
  std::vector<float> tr_cap;     // terminal residual (+src / -snk)
  std::vector<int32_t> parent;   // parent ARC of node (kNone/kTerminal/...)
  std::vector<uint8_t> in_src;   // tree membership: 1 src tree, 0 snk tree
  std::vector<uint8_t> in_tree;  // node is in some tree
  std::vector<uint64_t> ts;      // timestamp for distance caching
  std::vector<uint32_t> dist;    // distance to terminal at timestamp ts
  std::vector<int32_t> q;        // active queue (ring)
  std::vector<uint8_t> in_q;     // dedup flag for the active queue
  size_t q_head = 0;
  std::vector<int32_t> orphans;
  uint64_t time_now = 0;
  double flow = 0.0;

  explicit Solver(int32_t n_nodes, int64_t n_edges) : n(n_nodes) {
    head.reserve(2 * n_edges);
    next.reserve(2 * n_edges);
    rcap.reserve(2 * n_edges);
    first.assign(n, kNone);
    tr_cap.assign(n, 0.0f);
    parent.assign(n, kNone);
    in_src.assign(n, 0);
    in_tree.assign(n, 0);
    ts.assign(n, 0);
    dist.assign(n, 0);
    in_q.assign(n, 0);
  }

  void add_edge(int32_t u, int32_t v, float cap_uv, float cap_vu) {
    int32_t a = static_cast<int32_t>(head.size());
    head.push_back(v);
    next.push_back(first[u]);
    rcap.push_back(cap_uv);
    first[u] = a;
    head.push_back(u);
    next.push_back(first[v]);
    rcap.push_back(cap_vu);
    first[v] = a + 1;
  }

  void activate(int32_t v) {
    if (!in_q[v]) {
      in_q[v] = 1;
      q.push_back(v);
    }
  }

  // grow the tree of node v; returns the contact arc (from src tree to snk
  // tree) or kNone
  int32_t grow(int32_t v) {
    bool src_tree = in_src[v] != 0;
    for (int32_t a = first[v]; a != kNone; a = next[a]) {
      // from the source tree we push along a; from the sink tree along
      // the sister arc (toward us)
      int32_t fwd = src_tree ? a : (a ^ 1);
      if (rcap[fwd] <= 0) continue;
      int32_t u = head[a];
      if (!in_tree[u]) {
        in_tree[u] = 1;
        in_src[u] = src_tree ? 1 : 0;
        parent[u] = a ^ 1;  // arc from u back toward v
        ts[u] = ts[v];
        dist[u] = dist[v] + 1;
        activate(u);
      } else if ((in_src[u] != 0) != src_tree) {
        return src_tree ? fwd : fwd;  // contact arc src->snk direction
      } else if (ts[u] <= ts[v] && dist[u] > dist[v] + 1) {
        // heuristic re-parent for shorter paths
        parent[u] = a ^ 1;
        ts[u] = ts[v];
        dist[u] = dist[v] + 1;
      }
    }
    return kNone;
  }

  void augment(int32_t contact) {
    // bottleneck over: src-side path, contact arc, snk-side path
    float bottleneck = rcap[contact];
    int32_t u = head[contact ^ 1];  // src-side endpoint
    for (int32_t v = u;;) {
      int32_t pa = parent[v];  // arc v -> parent
      if (pa == kTerminal) { if (tr_cap[v] < bottleneck) bottleneck = tr_cap[v]; break; }
      int32_t back = pa ^ 1;   // arc parent -> v (the flow carrier)
      if (rcap[back] < bottleneck) bottleneck = rcap[back];
      v = head[pa];
    }
    int32_t w = head[contact];      // snk-side endpoint
    for (int32_t v = w;;) {
      int32_t pa = parent[v];
      if (pa == kTerminal) { float c = -tr_cap[v]; if (c < bottleneck) bottleneck = c; break; }
      if (rcap[pa] < bottleneck) bottleneck = rcap[pa];
      v = head[pa];
    }

    // apply
    rcap[contact] -= bottleneck;
    rcap[contact ^ 1] += bottleneck;
    for (int32_t v = u;;) {
      int32_t pa = parent[v];
      if (pa == kTerminal) {
        tr_cap[v] -= bottleneck;
        if (tr_cap[v] <= 0) make_orphan(v);
        break;
      }
      rcap[pa] += bottleneck;        // arc v->parent gains
      rcap[pa ^ 1] -= bottleneck;    // parent->v loses
      if (rcap[pa ^ 1] <= 0) make_orphan(v);
      v = head[pa];
    }
    for (int32_t v = w;;) {
      int32_t pa = parent[v];
      if (pa == kTerminal) {
        tr_cap[v] += bottleneck;     // toward 0 (it was negative)
        if (tr_cap[v] >= 0) make_orphan(v);
        break;
      }
      rcap[pa] -= bottleneck;        // arc v->parent (toward sink) loses
      rcap[pa ^ 1] += bottleneck;
      if (rcap[pa] <= 0) make_orphan(v);
      v = head[pa];
    }
    flow += bottleneck;
  }

  void make_orphan(int32_t v) {
    parent[v] = kOrphan;
    orphans.push_back(v);
  }

  // can v reach its terminal through parent chain? (with path compression
  // timestamps)
  bool rooted(int32_t v, uint64_t t) {
    int32_t cur = v;
    uint32_t d = 0;
    while (true) {
      if (ts[cur] == t) { d += dist[cur]; break; }
      int32_t pa = parent[cur];
      if (pa == kTerminal) { ts[cur] = t; dist[cur] = 0; break; }
      if (pa == kOrphan || pa == kNone) return false;
      ++d;
      cur = head[pa];
    }
    // stamp the path
    uint32_t dd = d;
    for (int32_t x = v; ts[x] != t;) {
      ts[x] = t;
      dist[x] = dd;
      --dd;
      x = head[parent[x]];
    }
    return true;
  }

  void adopt() {
    ++time_now;
    while (!orphans.empty()) {
      int32_t v = orphans.back();
      orphans.pop_back();
      bool src_tree = in_src[v] != 0;
      // find a new parent: a tree-neighbor with residual toward v's
      // terminal direction and a valid root
      int32_t best = kNone;
      uint32_t best_d = UINT32_MAX;
      for (int32_t a = first[v]; a != kNone; a = next[a]) {
        int32_t u = head[a];
        if (!in_tree[u] || (in_src[u] != 0) != src_tree) continue;
        int32_t carry = src_tree ? (a ^ 1) : a;  // arc that must carry flow
        if (rcap[carry] <= 0) continue;
        if (parent[u] == kOrphan || parent[u] == kNone) continue;
        if (!rooted(u, time_now)) continue;
        uint32_t d = dist[u] + 1;
        if (d < best_d) { best_d = d; best = a; }
      }
      if (best != kNone) {
        parent[v] = best;
        ts[v] = time_now;
        dist[v] = best_d;
      } else {
        // v leaves the tree; its tree-children become orphans, its
        // potential parents get reactivated
        for (int32_t a = first[v]; a != kNone; a = next[a]) {
          int32_t u = head[a];
          if (!in_tree[u] || (in_src[u] != 0) != src_tree) continue;
          int32_t carry = src_tree ? (a ^ 1) : a;
          if (rcap[carry] > 0) activate(u);
          if (parent[u] != kNone && parent[u] != kTerminal
              && parent[u] != kOrphan && head[parent[u]] == v) {
            make_orphan(u);
          }
        }
        in_tree[v] = 0;
        parent[v] = kNone;
      }
    }
  }

  double run() {
    // init: seed trees from terminal capacities
    for (int32_t v = 0; v < n; ++v) {
      if (tr_cap[v] > 0) {
        in_tree[v] = 1;
        in_src[v] = 1;
        parent[v] = kTerminal;
        ts[v] = 0;
        dist[v] = 0;
        activate(v);
      } else if (tr_cap[v] < 0) {
        in_tree[v] = 1;
        in_src[v] = 0;
        parent[v] = kTerminal;
        ts[v] = 0;
        dist[v] = 0;
        activate(v);
      }
    }
    while (q_head < q.size()) {
      int32_t v = q[q_head];
      // a node may be deactivated (left tree) while queued
      if (!in_tree[v] || parent[v] == kOrphan) {
        in_q[v] = 0;
        ++q_head;
        continue;
      }
      int32_t contact = grow(v);
      if (contact == kNone) {
        in_q[v] = 0;
        ++q_head;
        continue;
      }
      augment(contact);
      adopt();
      // keep v active: it may find more contacts
    }
    return flow;
  }
};

}  // namespace

extern "C" {

// Returns the max-flow value.  source_side[v] = 1 iff v is on the source
// side of the min cut (reachable from source in the residual graph —
// equivalently, in the source search tree at termination).
double hcmvs_maxflow(int32_t n_nodes, int64_t n_edges,
                     const int32_t* eu, const int32_t* ev,
                     const float* cap_uv, const float* cap_vu,
                     const float* cap_src, const float* cap_snk,
                     uint8_t* source_side) {
  Solver s(n_nodes, n_edges);
  double folded = 0.0;
  for (int32_t v = 0; v < n_nodes; ++v) {
    float cs = cap_src ? cap_src[v] : 0.0f;
    float ct = cap_snk ? cap_snk[v] : 0.0f;
    float m = cs < ct ? cs : ct;
    folded += m;
    s.tr_cap[v] = cs - ct;
  }
  for (int64_t e = 0; e < n_edges; ++e) {
    s.add_edge(eu[e], ev[e], cap_uv[e], cap_vu ? cap_vu[e] : cap_uv[e]);
  }
  double f = s.run() + folded;
  for (int32_t v = 0; v < n_nodes; ++v) {
    source_side[v] = (s.in_tree[v] && s.in_src[v]) ? 1 : 0;
  }
  return f;
}

}  // extern "C"
