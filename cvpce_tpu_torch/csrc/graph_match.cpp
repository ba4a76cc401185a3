// Native planogram graph builder + greedy subgraph matcher.
//
// C++ implementation of the host-side graph work on the compliance path
// (semantics of cvpce/planograms.py:12-132 re-expressed over flat arrays):
// - build_graph: per node, connect the nearest neighbor in each of 8
//   cardinal sectors within 0.5*avg(extent), keeping only the shortest
//   opposing-direction edge per node.
// - large_common_subgraph: hypothesis scoring (label-equal node pairs,
//   matching-neighbor count / 8) + greedy region growing with early stop.
//
// Exposed through a C ABI for ctypes (cvpce_tpu/pipeline/native.py).
// Build: g++ -O3 -shared -fPIC -o libgraphmatch.so graph_match.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kDirs = 8;  // E NE N NW W SW S SE
constexpr double kPi = 3.14159265358979323846;

struct Edge {
  int32_t to;
  int32_t dir;
  float weight;
};

// directions[i*n+j]: sector index of j as seen from i, or -1 on diagonal
void compute_sectors(const float* centres, int n, std::vector<int8_t>& sec,
                     std::vector<float>& dist) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      if (i == j) {
        sec[i * n + j] = -1;
        dist[i * n + j] = 0.f;
        continue;
      }
      const float dx = centres[2 * j] - centres[2 * i];
      const float dy = centres[2 * j + 1] - centres[2 * i + 1];
      const float d = std::sqrt(dx * dx + dy * dy);
      dist[i * n + j] = d;
      double ang = std::acos(std::clamp(double(dx) / std::max(double(d), 1e-12), -1.0, 1.0));
      if (dy < 0) ang = 2 * kPi - ang;
      // E: (15pi/8, 2pi] U [0, pi/8]; sector k (k>=1): ((1+2(k-1))pi/8, (1+2k)pi/8]
      int8_t s;
      if (ang > 15 * kPi / 8 || ang <= kPi / 8) {
        s = 0;
      } else {
        s = int8_t(std::min<int>(7, 1 + int((ang - kPi / 8) / (kPi / 4))));
        // exact bin edges: sector k covers ((2k-1)pi/8, (2k+1)pi/8]
        while (s < 7 && ang > (2 * s + 1) * kPi / 8) ++s;
        while (s > 1 && ang <= (2 * s - 1) * kPi / 8) --s;
      }
      sec[i * n + j] = s;
    }
  }
}

}  // namespace

extern "C" {

// Build the planogram adjacency graph.
//  boxes: (n,4) xyxy float32; out_edges: caller buffer (cap, 3) int32 rows
//  (i, j, dir); out_weights: (cap,) float32. Returns edge count (directed;
//  both i->j and j->i rows are emitted) or -1 if cap exceeded.
int32_t build_graph(const float* boxes, int32_t n, float thresh_size,
                    int32_t* out_edges, float* out_weights, int32_t cap) {
  if (n <= 0) return 0;
  std::vector<float> centres(2 * n);
  float minx = boxes[0], miny = boxes[1], maxx = boxes[2], maxy = boxes[3];
  for (int i = 0; i < n; ++i) {
    const float x1 = boxes[4 * i], y1 = boxes[4 * i + 1];
    const float x2 = boxes[4 * i + 2], y2 = boxes[4 * i + 3];
    centres[2 * i] = (x1 + x2) / 2;
    centres[2 * i + 1] = (y1 + y2) / 2;
    minx = std::min(minx, x1);
    miny = std::min(miny, y1);
    maxx = std::max(maxx, x2);
    maxy = std::max(maxy, y2);
  }
  const float avg_dim = ((maxx - minx) + (maxy - miny)) / 2;
  const float thresh = thresh_size * avg_dim;

  std::vector<int8_t> sec(size_t(n) * n);
  std::vector<float> dist(size_t(n) * n);
  compute_sectors(centres.data(), n, sec, dist);

  // adjacency: per node, edges (to, dir, weight)
  std::vector<std::vector<Edge>> adj(n);

  auto find_edge_dir = [&](int node, int dir) -> int {
    for (size_t k = 0; k < adj[node].size(); ++k)
      if (adj[node][k].dir == dir) return int(k);
    return -1;
  };
  auto remove_edge = [&](int a, int b) {
    for (size_t k = 0; k < adj[a].size(); ++k)
      if (adj[a][k].to == b) {
        adj[a].erase(adj[a].begin() + k);
        return;
      }
  };

  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) {
    // sort candidate neighbors by distance (stable, like torch sort)
    for (int k = 0; k < n; ++k) order[k] = k;
    const float* di = &dist[size_t(i) * n];
    std::stable_sort(order.begin(), order.end(),
                     [&](int a, int b) { return di[a] < di[b]; });

    bool found[kDirs];
    for (int d = 0; d < kDirs; ++d) found[d] = false;
    for (const auto& e : adj[i]) found[e.dir] = true;

    for (int oi = 0; oi < n; ++oi) {
      const int j = order[oi];
      const float d = di[j];
      bool all = true;
      for (int dd = 0; dd < kDirs; ++dd) all &= found[dd];
      if (d > thresh || all) break;
      if (j == i) continue;
      // reference iterates the not_found set (python set order is
      // insertion order of CARDINALS) and takes the first dir that
      // passes _check_dir; only the sector test depends on dir, so this
      // equals checking the sector of (i, j) directly.
      const int dir = sec[size_t(i) * n + j];
      if (dir < 0 || found[dir]) continue;
      const int opp = (dir + 4) % kDirs;
      // j side: keep only the shortest opposing edge
      const int existing = find_edge_dir(j, opp);
      if (existing >= 0) {
        if (adj[j][existing].weight <= d) continue;  // shorter edge wins
        const int other = adj[j][existing].to;
        adj[j].erase(adj[j].begin() + existing);
        remove_edge(other, j);
      }
      adj[i].push_back({int32_t(j), int32_t(dir), d});
      adj[j].push_back({int32_t(i), int32_t(opp), d});
      found[dir] = true;
    }
  }

  int32_t cnt = 0;
  for (int i = 0; i < n; ++i)
    for (const auto& e : adj[i]) {
      if (cnt >= cap) return -1;
      out_edges[3 * cnt] = i;
      out_edges[3 * cnt + 1] = e.to;
      out_edges[3 * cnt + 2] = e.dir;
      out_weights[cnt] = e.weight;
      ++cnt;
    }
  return cnt;
}

namespace {

struct Graph {
  int n;
  const int32_t* labels;
  // CSR adjacency with (neighbor, dir)
  std::vector<int32_t> off;
  std::vector<int32_t> nbr;
  std::vector<int32_t> dir;

  void init(int n_, const int32_t* labels_, const int32_t* edges,
            int32_t n_edges) {
    n = n_;
    labels = labels_;
    off.assign(n + 1, 0);
    for (int e = 0; e < n_edges; ++e) ++off[edges[3 * e] + 1];
    for (int i = 0; i < n; ++i) off[i + 1] += off[i];
    nbr.resize(n_edges);
    dir.resize(n_edges);
    std::vector<int32_t> cur(off.begin(), off.end() - 1);
    for (int e = 0; e < n_edges; ++e) {
      const int i = edges[3 * e];
      nbr[cur[i]] = edges[3 * e + 1];
      dir[cur[i]] = edges[3 * e + 2];
      ++cur[i];
    }
  }
};

struct Hypothesis {
  float neg_score;
  int32_t n1, n2;
  bool operator<(const Hypothesis& o) const {
    if (neg_score != o.neg_score) return neg_score < o.neg_score;
    if (n1 != o.n1) return n1 < o.n1;
    return n2 < o.n2;
  }
};

void get_next(const Graph& g1, const Graph& g2, int n1, int n2,
              std::vector<std::pair<int, int>>& out) {
  for (int a = g1.off[n1]; a < g1.off[n1 + 1]; ++a)
    for (int b = g2.off[n2]; b < g2.off[n2 + 1]; ++b)
      if (g1.dir[a] == g2.dir[b] &&
          g1.labels[g1.nbr[a]] == g2.labels[g2.nbr[b]])
        out.emplace_back(g1.nbr[a], g2.nbr[b]);
}

}  // namespace

// Greedy large-common-subgraph. labels are int ids (shared vocabulary).
// out_pairs: (cap, 2) int32. Returns pair count or -1 on cap overflow.
int32_t large_common_subgraph(
    int32_t n1_nodes, const int32_t* labels1, const int32_t* edges1,
    int32_t n_edges1, int32_t n2_nodes, const int32_t* labels2,
    const int32_t* edges2, int32_t n_edges2, float min_score,
    float stop_at_fraction, int32_t* out_pairs, int32_t cap) {
  Graph g1, g2;
  g1.init(n1_nodes, labels1, edges1, n_edges1);
  g2.init(n2_nodes, labels2, edges2, n_edges2);

  // hypotheses: all label-equal pairs, scored by matching neighbors / 8
  std::vector<Hypothesis> hyps;
  for (int a = 0; a < g1.n; ++a)
    for (int b = 0; b < g2.n; ++b) {
      if (labels1[a] != labels2[b]) continue;
      int score = 0;
      for (int ea = g1.off[a]; ea < g1.off[a + 1]; ++ea)
        for (int eb = g2.off[b]; eb < g2.off[b + 1]; ++eb)
          if (g1.dir[ea] == g2.dir[eb]) {
            score += labels1[g1.nbr[ea]] == labels2[g2.nbr[eb]];
            break;  // one neighbor per direction
          }
      hyps.push_back({-float(score) / kDirs, a, b});
    }
  std::sort(hyps.begin(), hyps.end());

  const float stop_at = stop_at_fraction * std::min(g1.n, g2.n);
  std::vector<std::pair<int, int>> best, current, queue;
  std::vector<uint8_t> used1(g1.n), used2(g2.n);

  for (const auto& h : hyps) {
    if (h.neg_score > min_score && !best.empty()) break;
    current.clear();
    queue.clear();
    std::fill(used1.begin(), used1.end(), 0);
    std::fill(used2.begin(), used2.end(), 0);
    current.emplace_back(h.n1, h.n2);
    used1[h.n1] = used2[h.n2] = 1;
    get_next(g1, g2, h.n1, h.n2, queue);
    for (size_t qi = 0; qi < queue.size(); ++qi) {
      const auto [a, b] = queue[qi];
      if (used1[a] || used2[b]) continue;
      used1[a] = used2[b] = 1;
      current.emplace_back(a, b);
      get_next(g1, g2, a, b, queue);
    }
    if (float(current.size()) > stop_at) {
      best = current;
      break;
    }
    if (current.size() > best.size()) best = current;
  }

  if (int32_t(best.size()) > cap) return -1;
  for (size_t k = 0; k < best.size(); ++k) {
    out_pairs[2 * k] = best[k].first;
    out_pairs[2 * k + 1] = best[k].second;
  }
  return int32_t(best.size());
}

}  // extern "C"
