// Point-cloud geometry distortion metrics: MPEG-style D1 (point-to-point)
// and D2 (point-to-plane) PSNR, plus symmetric Chamfer mean distance.
// Replaces the reference's prebuilt `utils/pc_error` binary (invoked via
// subprocess at reference data_preproc/pt.py:13-85) with an in-process
// KD-tree implementation.
//
// Conventions (MPEG PCC common test conditions):
//   mse(A->B)  = mean over a in A of min_b ||a-b||^2
//   d2 error for a in A vs nearest b uses the normal at a (cloud A normals)
//   for direction A->B, and the normal at the nearest A point for B->A.
//   PSNR = 10*log10(3*peak^2 / max(mse_ab, mse_ba)).
//
// A copy of the JAX package's scp_tpu/native/src/metrics.cpp: the port
// builds and loads its own library (scp_tpu_torch/native/build.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <functional>
#include <numeric>
#include <utility>
#include <vector>

namespace {

struct KDTree {
  // Compact static KD-tree: nodes stored in the (re-ordered) point array.
  std::vector<double> pts;    // 3 * n, reordered
  std::vector<int64_t> perm;  // reordered index -> original index
  int64_t n = 0;

  void build(const double* data, int64_t count) {
    n = count;
    perm.resize(n);
    std::iota(perm.begin(), perm.end(), 0);
    pts.assign(data, data + 3 * n);
    build_rec(0, n, 0, data);
  }

  void build_rec(int64_t lo, int64_t hi, int axis, const double* data) {
    if (hi - lo <= 1) return;
    int64_t mid = (lo + hi) / 2;
    std::nth_element(
        perm.begin() + lo, perm.begin() + mid, perm.begin() + hi,
        [&](int64_t a, int64_t b) { return data[3 * a + axis] < data[3 * b + axis]; });
    build_rec(lo, mid, (axis + 1) % 3, data);
    build_rec(mid + 1, hi, (axis + 1) % 3, data);
  }

  void finalize(const double* data) {
    for (int64_t i = 0; i < n; ++i)
      for (int k = 0; k < 3; ++k) pts[3 * i + k] = data[3 * perm[i] + k];
  }

  void nn_rec(const double* q, int64_t lo, int64_t hi, int axis,
              double& best, int64_t& best_i) const {
    if (hi <= lo) return;
    const int64_t mid = (lo + hi) / 2;
    const double* p = &pts[3 * mid];
    const double dx = q[0] - p[0], dy = q[1] - p[1], dz = q[2] - p[2];
    const double d = dx * dx + dy * dy + dz * dz;
    if (d < best) {
      best = d;
      best_i = mid;
    }
    const double delta = q[axis] - p[axis];
    const int next = (axis + 1) % 3;
    if (delta < 0) {
      nn_rec(q, lo, mid, next, best, best_i);
      if (delta * delta < best) nn_rec(q, mid + 1, hi, next, best, best_i);
    } else {
      nn_rec(q, mid + 1, hi, next, best, best_i);
      if (delta * delta < best) nn_rec(q, lo, mid, next, best, best_i);
    }
  }

  // Returns squared distance; *idx gets the ORIGINAL index of the NN.
  double nearest(const double* q, int64_t* idx) const {
    double best = 1e300;
    int64_t best_i = -1;
    nn_rec(q, 0, n, 0, best, best_i);
    if (idx) *idx = perm[best_i];
    return best;
  }
};

KDTree make_tree(const double* data, int64_t n) {
  KDTree t;
  t.build(data, n);
  t.finalize(data);
  return t;
}

}  // namespace

extern "C" {

// out[0] = mse d1 (a->b), out[1] = mse d2 (a->b, 0 if no normals),
// normals_a: normals of cloud A (may be null); when `use_nn_normal` != 0 the
// normal of the nearest A-point is used instead (for the B->A pass the
// caller swaps arguments and sets this flag).
void pc_mse_directional(const double* a, int64_t na, const double* b,
                        int64_t nb, const double* normals, int32_t normal_of_nn,
                        double* out) {
  KDTree tb = make_tree(b, nb);
  double s1 = 0.0, s2 = 0.0;
#pragma omp parallel for reduction(+ : s1, s2) schedule(static)
  for (int64_t i = 0; i < na; ++i) {
    int64_t j = -1;
    const double d = tb.nearest(a + 3 * i, &j);
    s1 += d;
    if (normals) {
      const double* nrm = normal_of_nn ? normals + 3 * j : normals + 3 * i;
      double diff[3] = {a[3 * i] - b[3 * j], a[3 * i + 1] - b[3 * j + 1],
                        a[3 * i + 2] - b[3 * j + 2]};
      const double dot =
          diff[0] * nrm[0] + diff[1] * nrm[1] + diff[2] * nrm[2];
      s2 += dot * dot;
    }
  }
  out[0] = s1 / static_cast<double>(na);
  out[1] = normals ? s2 / static_cast<double>(na) : 0.0;
}

// Chamfer building block: mean (not squared) NN distance a->b.
double pc_mean_nn_dist(const double* a, int64_t na, const double* b,
                       int64_t nb) {
  KDTree tb = make_tree(b, nb);
  double s = 0.0;
#pragma omp parallel for reduction(+ : s) schedule(static)
  for (int64_t i = 0; i < na; ++i) {
    s += std::sqrt(tb.nearest(a + 3 * i, nullptr));
  }
  return s / static_cast<double>(na);
}

// K-nearest neighbors (self-exclusion optional) used for normal estimation.
// out_idx: (n, k) original indices.
void pc_knn(const double* pts, int64_t n, const double* queries, int64_t nq,
            int32_t k, int64_t* out_idx) {
  KDTree t = make_tree(pts, n);
#pragma omp parallel for schedule(static)
  for (int64_t qi = 0; qi < nq; ++qi) {
    // Simple repeated-NN with masking is O(k log n) per query via a small
    // max-heap scan over the tree; for the modest k (<=32) used in normal
    // estimation we do a bounded best-k recursion.
    const double* q = queries + 3 * qi;
    std::vector<std::pair<double, int64_t>> best;
    best.reserve(k + 1);
    // recursive lambda over the implicit tree
    std::function<void(int64_t, int64_t, int)> rec;
    double worst = 1e300;
    rec = [&](int64_t lo, int64_t hi, int axis) {
      if (hi <= lo) return;
      const int64_t mid = (lo + hi) / 2;
      const double* p = &t.pts[3 * mid];
      const double dx = q[0] - p[0], dy = q[1] - p[1], dz = q[2] - p[2];
      const double d = dx * dx + dy * dy + dz * dz;
      if (static_cast<int32_t>(best.size()) < k || d < worst) {
        best.emplace_back(d, t.perm[mid]);
        std::push_heap(best.begin(), best.end());
        if (static_cast<int32_t>(best.size()) > k) {
          std::pop_heap(best.begin(), best.end());
          best.pop_back();
        }
        if (static_cast<int32_t>(best.size()) == k) worst = best.front().first;
      }
      const double delta = q[axis] - p[axis];
      const int next = (axis + 1) % 3;
      if (delta < 0) {
        rec(lo, mid, next);
        if (delta * delta < worst || static_cast<int32_t>(best.size()) < k)
          rec(mid + 1, hi, next);
      } else {
        rec(mid + 1, hi, next);
        if (delta * delta < worst || static_cast<int32_t>(best.size()) < k)
          rec(lo, mid, next);
      }
    };
    rec(0, t.n, 0);
    std::sort_heap(best.begin(), best.end());
    for (int32_t j = 0; j < k; ++j)
      out_idx[qi * k + j] =
          j < static_cast<int32_t>(best.size()) ? best[j].second : best.back().second;
  }
}

}  // extern "C"
