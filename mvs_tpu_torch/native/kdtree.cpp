// mvs_native: threaded 3D KD-tree core for the DTU evaluation protocol.
//
// Native replacement for the compute engine behind the reference MATLAB
// evaluation (Evaluation/dtu/MaxDistCP.m chunked KD-tree NN queries,
// reducePts_haa.m stochastic radius decimation) — exposed to Python via a
// plain C ABI consumed with ctypes (mvs_tpu_torch/native/__init__.py, which
// builds it with the host C++ compiler at first use).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <numeric>
#include <thread>
#include <vector>

namespace {

struct KDTree {
  // Implicit balanced tree over point indices; nodes[i] splits on axis
  // (depth % 3) at the median.
  std::vector<float> pts;      // flat xyz, size 3*n
  std::vector<int32_t> order;  // point index per tree slot (in-order layout)
  int32_t n = 0;

  inline const float* p(int32_t idx) const { return &pts[3 * idx]; }

  void build(const float* data, int32_t count) {
    n = count;
    pts.assign(data, data + 3 * static_cast<size_t>(count));
    order.resize(count);
    std::iota(order.begin(), order.end(), 0);
    build_range(0, count, 0);
  }

  void build_range(int32_t lo, int32_t hi, int axis) {
    if (hi - lo <= 1) return;
    int32_t mid = (lo + hi) / 2;
    std::nth_element(
        order.begin() + lo, order.begin() + mid, order.begin() + hi,
        [&](int32_t a, int32_t b) { return p(a)[axis] < p(b)[axis]; });
    build_range(lo, mid, (axis + 1) % 3);
    build_range(mid + 1, hi, (axis + 1) % 3);
  }

  // Nearest-neighbour squared distance (best-first recursive descent).
  void nn(const float* q, int32_t lo, int32_t hi, int axis, float& best_d2,
          int32_t& best_i) const {
    if (hi <= lo) return;
    int32_t mid = (lo + hi) / 2;
    const float* m = p(order[mid]);
    float dx = q[0] - m[0], dy = q[1] - m[1], dz = q[2] - m[2];
    float d2 = dx * dx + dy * dy + dz * dz;
    if (d2 < best_d2) {
      best_d2 = d2;
      best_i = order[mid];
    }
    float delta = q[axis] - m[axis];
    int next = (axis + 1) % 3;
    if (delta < 0) {
      nn(q, lo, mid, next, best_d2, best_i);
      if (delta * delta < best_d2) nn(q, mid + 1, hi, next, best_d2, best_i);
    } else {
      nn(q, mid + 1, hi, next, best_d2, best_i);
      if (delta * delta < best_d2) nn(q, lo, mid, next, best_d2, best_i);
    }
  }

  // Collect all point indices within radius r of q.
  void radius(const float* q, float r2, int32_t lo, int32_t hi, int axis,
              std::vector<int32_t>& out) const {
    if (hi <= lo) return;
    int32_t mid = (lo + hi) / 2;
    const float* m = p(order[mid]);
    float dx = q[0] - m[0], dy = q[1] - m[1], dz = q[2] - m[2];
    float d2 = dx * dx + dy * dy + dz * dz;
    if (d2 <= r2) out.push_back(order[mid]);
    float delta = q[axis] - m[axis];
    int next = (axis + 1) % 3;
    if (delta < 0) {
      radius(q, r2, lo, mid, next, out);
      if (delta * delta <= r2) radius(q, r2, mid + 1, hi, next, out);
    } else {
      radius(q, r2, mid + 1, hi, next, out);
      if (delta * delta <= r2) radius(q, r2, lo, mid, next, out);
    }
  }
};

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  int64_t chunk = (n + hw - 1) / hw;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < hw; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Nearest-neighbour distances from each query point to the target cloud.
// query: (nq, 3) f32; target: (nt, 3) f32; out_dist: (nq,) f32.
void mvs_nn_distances(const float* query, int64_t nq, const float* target,
                      int64_t nt, float* out_dist) {
  if (nt == 0) {
    for (int64_t i = 0; i < nq; ++i)
      out_dist[i] = std::numeric_limits<float>::infinity();
    return;
  }
  KDTree tree;
  tree.build(target, static_cast<int32_t>(nt));
  parallel_for(nq, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      float best = std::numeric_limits<float>::max();
      int32_t bi = -1;
      tree.nn(&query[3 * i], 0, tree.n, 0, best, bi);
      out_dist[i] = std::sqrt(best);
    }
  });
}

// Stochastic decimation (reducePts_haa semantics): visit points in the given
// order; keep a point iff no already-kept point lies within dst. Sequential
// by construction (order-dependent), but each visit's radius query uses the
// KD-tree. pts: (n, 3); order: (n,) visit order; out_keep: (n,) u8.
void mvs_reduce_points(const float* pts, int64_t n, const int32_t* order,
                       float dst, uint8_t* out_keep) {
  KDTree tree;
  tree.build(pts, static_cast<int32_t>(n));
  std::memset(out_keep, 1, n);
  float r2 = dst * dst;
  std::vector<int32_t> neigh;
  for (int64_t k = 0; k < n; ++k) {
    int32_t i = order[k];
    if (!out_keep[i]) continue;
    neigh.clear();
    tree.radius(&pts[3 * i], r2, 0, tree.n, 0, neigh);
    for (int32_t j : neigh) out_keep[j] = 0;
    out_keep[i] = 1;
  }
}

}  // extern "C"
