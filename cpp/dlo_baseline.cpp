// Standalone CPU baseline: a from-scratch reimplementation of the reference
// DLO pipeline (vectr-ucla/direct_lidar_odometry v1.3.1) used ONLY to measure
// the reference's CPU operating point on this machine, since the reference
// itself needs ROS1+PCL (unavailable here) and publishes no numbers
// (BASELINE.md). Written against the structural analysis in SURVEY.md — the
// same algorithms at the same default parameters, none of the reference code.
//
// Pipeline per scan (reference src/dlo/odom.cc:629-697):
//   voxel 0.25 + crop box -> per-point PLANE covariances (k-NN, SVD->(1,1,eps);
//   nano_gicp_impl.hpp:298-357) -> S2S GICP (LM, 32 iters) vs previous scan ->
//   S2M GICP vs kNN-selected keyframe submap -> keyframe update (threshD=5m /
//   threshR=45deg). Neighbor search: median-split kd-tree (the nanoflann
//   equivalent, nanoflann_impl.hpp:867-1435). OpenMP on the hot loops
//   (nano_gicp_impl.hpp:187,225,276,309).
//
// I/O: scan dump in, trajectory out (see cpp/run_baseline.py). Prints one
// JSON line with per-frame timing.

#include <omp.h>

#include <algorithm>
#include <array>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Minimal linear algebra (fixed 3/4/6 dims)
// ---------------------------------------------------------------------------

struct V3 {
  float x = 0, y = 0, z = 0;
};
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline float norm2(V3 a) { return dot(a, a); }

using M3 = std::array<float, 9>;   // row-major 3x3
using M4 = std::array<float, 16>;  // row-major 4x4

inline M3 m3_zero() { return M3{}; }

inline M3 m3_mul(const M3& a, const M3& b) {
  M3 c{};
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) {
      const float aik = a[3 * i + k];
      for (int j = 0; j < 3; ++j) c[3 * i + j] += aik * b[3 * k + j];
    }
  return c;
}

inline M3 m3_mul_t(const M3& a, const M3& b) {  // a * b^T
  M3 c{};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float s = 0;
      for (int k = 0; k < 3; ++k) s += a[3 * i + k] * b[3 * j + k];
      c[3 * i + j] = s;
    }
  return c;
}

inline V3 m3_apply(const M3& m, V3 v) {
  return {m[0] * v.x + m[1] * v.y + m[2] * v.z,
          m[3] * v.x + m[4] * v.y + m[5] * v.z,
          m[6] * v.x + m[7] * v.y + m[8] * v.z};
}

// inverse of a symmetric 3x3 via adjugate
inline M3 sym_inv3(const M3& m) {
  const float a = m[0], b = m[1], c = m[2], d = m[4], e = m[5], f = m[8];
  const float co_a = d * f - e * e;
  const float co_b = c * e - b * f;
  const float co_c = b * e - c * d;
  float det = a * co_a + b * co_b + c * co_c;
  if (std::fabs(det) < 1e-20f) det = 1.0f;
  const float id = 1.0f / det;
  M3 r;
  r[0] = co_a * id;
  r[1] = co_b * id;
  r[2] = co_c * id;
  r[3] = r[1];
  r[4] = (a * f - c * c) * id;
  r[5] = (b * c - a * e) * id;
  r[6] = r[2];
  r[7] = r[5];
  r[8] = (a * d - b * b) * id;
  return r;
}

inline M4 m4_identity() {
  M4 m{};
  m[0] = m[5] = m[10] = m[15] = 1.0f;
  return m;
}

inline M4 m4_mul(const M4& a, const M4& b) {
  M4 c{};
  for (int i = 0; i < 4; ++i)
    for (int k = 0; k < 4; ++k) {
      const float aik = a[4 * i + k];
      for (int j = 0; j < 4; ++j) c[4 * i + j] += aik * b[4 * k + j];
    }
  return c;
}

inline V3 m4_apply(const M4& t, V3 p) {
  return {t[0] * p.x + t[1] * p.y + t[2] * p.z + t[3],
          t[4] * p.x + t[5] * p.y + t[6] * p.z + t[7],
          t[8] * p.x + t[9] * p.y + t[10] * p.z + t[11]};
}

inline M3 m4_rot(const M4& t) {
  return M3{t[0], t[1], t[2], t[4], t[5], t[6], t[8], t[9], t[10]};
}

// Rodrigues so(3) exp with small-angle Taylor branch (reference so3.hpp:84-118)
inline M3 so3_exp(const float w[3]) {
  const float t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float t = std::sqrt(t2);
  float A, B;
  if (t2 < 1e-8f) {
    A = 1.0f - t2 / 6.0f;
    B = 0.5f - t2 / 24.0f;
  } else {
    A = std::sin(t) / t;
    B = (1.0f - std::cos(t)) / t2;
  }
  const M3 K{0, -w[2], w[1], w[2], 0, -w[0], -w[1], w[0], 0};
  const M3 KK = m3_mul(K, K);
  M3 r{1, 0, 0, 0, 1, 0, 0, 0, 1};
  for (int i = 0; i < 9; ++i) r[i] += A * K[i] + B * KK[i];
  return r;
}

// delta = (so3_exp(d[0:3]), d[3:6]) — translation applied raw, matching the
// reference update parameterization (lsq_registration_impl.hpp:150-153)
inline M4 se3_exp(const double d[6]) {
  const float w[3] = {(float)d[0], (float)d[1], (float)d[2]};
  const M3 r = so3_exp(w);
  M4 t = m4_identity();
  t[0] = r[0]; t[1] = r[1]; t[2] = r[2]; t[3] = (float)d[3];
  t[4] = r[3]; t[5] = r[4]; t[6] = r[5]; t[7] = (float)d[4];
  t[8] = r[6]; t[9] = r[7]; t[10] = r[8]; t[11] = (float)d[5];
  return t;
}

// 6x6 linear solve via Gaussian elimination with partial pivoting (double,
// the reference solves in double via Eigen LDLT)
inline bool solve6(const double h[36], const double b[6], double x[6]) {
  double a[6][7];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) a[i][j] = h[6 * i + j];
    a[i][6] = b[i];
  }
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int r = c + 1; r < 6; ++r)
      if (std::fabs(a[r][c]) > std::fabs(a[piv][c])) piv = r;
    if (std::fabs(a[piv][c]) < 1e-12) return false;
    if (piv != c)
      for (int j = 0; j < 7; ++j) std::swap(a[c][j], a[piv][j]);
    for (int r = c + 1; r < 6; ++r) {
      const double f = a[r][c] / a[c][c];
      for (int j = c; j < 7; ++j) a[r][j] -= f * a[c][j];
    }
  }
  for (int r = 5; r >= 0; --r) {
    double s = a[r][6];
    for (int j = r + 1; j < 6; ++j) s -= a[r][j] * x[j];
    x[r] = s / a[r][r];
  }
  return true;
}

// Jacobi eigendecomposition of a symmetric 3x3: A = V diag(w) V^T
inline void eigh3(const M3& a_in, float w[3], M3& v) {
  double a[3][3] = {{a_in[0], a_in[1], a_in[2]},
                    {a_in[3], a_in[4], a_in[5]},
                    {a_in[6], a_in[7], a_in[8]}};
  double q[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  for (int sweep = 0; sweep < 24; ++sweep) {
    double off = std::fabs(a[0][1]) + std::fabs(a[0][2]) + std::fabs(a[1][2]);
    if (off < 1e-12) break;
    for (int p = 0; p < 2; ++p)
      for (int r = p + 1; r < 3; ++r) {
        if (std::fabs(a[p][r]) < 1e-15) continue;
        const double theta = (a[r][r] - a[p][p]) / (2.0 * a[p][r]);
        const double sgn = theta >= 0 ? 1.0 : -1.0;
        const double t = sgn / (std::fabs(theta) + std::sqrt(theta * theta + 1));
        const double c = 1.0 / std::sqrt(t * t + 1), s = t * c;
        for (int k = 0; k < 3; ++k) {
          const double akp = a[k][p], akr = a[k][r];
          a[k][p] = c * akp - s * akr;
          a[k][r] = s * akp + c * akr;
        }
        for (int k = 0; k < 3; ++k) {
          const double apk = a[p][k], ark = a[r][k];
          a[p][k] = c * apk - s * ark;
          a[r][k] = s * apk + c * ark;
          const double qkp = q[k][p], qkr = q[k][r];
          q[k][p] = c * qkp - s * qkr;
          q[k][r] = s * qkp + c * qkr;
        }
      }
  }
  for (int i = 0; i < 3; ++i) {
    w[i] = (float)a[i][i];
    for (int k = 0; k < 3; ++k) v[3 * k + i] = (float)q[k][i];
  }
}

// ---------------------------------------------------------------------------
// kd-tree: median-split over the max-extent axis, branch-and-bound queries
// (the nanoflann-equivalent; nanoflann_impl.hpp:867-1435)
// ---------------------------------------------------------------------------

struct KdTree {
  struct Node {
    int axis = -1;       // -1 = leaf
    float split = 0;
    int left = -1, right = -1;
    int lo = 0, hi = 0;  // leaf range into idx
  };
  const std::vector<V3>* pts = nullptr;
  std::vector<int> idx;
  std::vector<Node> nodes;
  static constexpr int kLeaf = 16;

  void build(const std::vector<V3>& p) {
    pts = &p;
    idx.resize(p.size());
    std::iota(idx.begin(), idx.end(), 0);
    nodes.clear();
    nodes.reserve(p.size() / kLeaf * 2 + 4);
    if (!p.empty()) build_rec(0, (int)p.size());
  }

  int build_rec(int lo, int hi) {
    const int id = (int)nodes.size();
    nodes.push_back({});
    if (hi - lo <= kLeaf) {
      nodes[id].lo = lo;
      nodes[id].hi = hi;
      return id;
    }
    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = lo; i < hi; ++i) {
      const V3& q = (*pts)[idx[i]];
      const float c[3] = {q.x, q.y, q.z};
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::fmin(mn[a], c[a]);
        mx[a] = std::fmax(mx[a], c[a]);
      }
    }
    int axis = 0;
    for (int a = 1; a < 3; ++a)
      if (mx[a] - mn[a] > mx[axis] - mn[axis]) axis = a;
    const int mid = (lo + hi) / 2;
    std::nth_element(idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
                     [&](int a, int b) {
                       const float* pa = &(*pts)[a].x;
                       const float* pb = &(*pts)[b].x;
                       return pa[axis] < pb[axis];
                     });
    nodes[id].axis = axis;
    nodes[id].split = (&(*pts)[idx[mid]].x)[axis];
    const int l = build_rec(lo, mid);
    const int r = build_rec(mid, hi);
    nodes[id].left = l;
    nodes[id].right = r;
    return id;
  }

  // 1-NN within sqrt(max_d2); returns index or -1
  int nn1(V3 q, float max_d2, float* out_d2) const {
    int best = -1;
    float bd2 = max_d2;
    nn1_rec(0, q, &best, &bd2);
    if (out_d2) *out_d2 = bd2;
    return best;
  }

  void nn1_rec(int id, V3 q, int* best, float* bd2) const {
    const Node& n = nodes[id];
    if (n.axis < 0) {
      for (int i = n.lo; i < n.hi; ++i) {
        const float d2 = norm2((*pts)[idx[i]] - q);
        if (d2 < *bd2) {
          *bd2 = d2;
          *best = idx[i];
        }
      }
      return;
    }
    const float qa = (&q.x)[n.axis];
    const float diff = qa - n.split;
    const int near = diff < 0 ? n.left : n.right;
    const int far = diff < 0 ? n.right : n.left;
    nn1_rec(near, q, best, bd2);
    if (diff * diff < *bd2) nn1_rec(far, q, best, bd2);
  }

  // k-NN (bounded insertion into a sorted array, nanoflann KNNResultSet style)
  int knn(V3 q, int k, int* out_idx) const {
    std::vector<std::pair<float, int>> heap;  // max-heap by distance
    heap.reserve(k);
    float worst = 1e30f;
    knn_rec(0, q, k, heap, &worst);
    std::sort_heap(heap.begin(), heap.end());
    const int m = (int)heap.size();
    for (int i = 0; i < m; ++i) out_idx[i] = heap[i].second;
    return m;
  }

  void knn_rec(int id, V3 q, int k, std::vector<std::pair<float, int>>& heap,
               float* worst) const {
    const Node& n = nodes[id];
    if (n.axis < 0) {
      for (int i = n.lo; i < n.hi; ++i) {
        const float d2 = norm2((*pts)[idx[i]] - q);
        if ((int)heap.size() < k) {
          heap.emplace_back(d2, idx[i]);
          std::push_heap(heap.begin(), heap.end());
          if ((int)heap.size() == k) *worst = heap.front().first;
        } else if (d2 < *worst) {
          std::pop_heap(heap.begin(), heap.end());
          heap.back() = {d2, idx[i]};
          std::push_heap(heap.begin(), heap.end());
          *worst = heap.front().first;
        }
      }
      return;
    }
    const float qa = (&q.x)[n.axis];
    const float diff = qa - n.split;
    const int near = diff < 0 ? n.left : n.right;
    const int far = diff < 0 ? n.right : n.left;
    knn_rec(near, q, k, heap, worst);
    if ((int)heap.size() < k || diff * diff < *worst)
      knn_rec(far, q, k, heap, worst);
  }
};

// ---------------------------------------------------------------------------
// GICP (nano_gicp equivalents)
// ---------------------------------------------------------------------------

struct GicpParams {
  int k_correspondences = 10;
  float max_corr_dist = 1.0f;
  int max_iterations = 32;
  float trans_eps = 0.01f;
  float rot_eps = 2e-3f;
  int lm_max_iterations = 10;
  float lm_init_lambda_factor = 1e-9f;
};

// PLANE-regularized covariances from k-NN neighborhoods
// (nano_gicp_impl.hpp:298-357)
void calc_covariances(const std::vector<V3>& pts, const KdTree& tree, int k,
                      std::vector<M3>& covs) {
  const int n = (int)pts.size();
  covs.resize(n);
#pragma omp parallel for schedule(guided, 8)
  for (int i = 0; i < n; ++i) {
    int nn[64];
    const int m = tree.knn(pts[i], k, nn);
    V3 mean{};
    for (int j = 0; j < m; ++j) mean = mean + pts[nn[j]];
    mean = {mean.x / m, mean.y / m, mean.z / m};
    M3 c{};
    for (int j = 0; j < m; ++j) {
      const V3 d = pts[nn[j]] - mean;
      const float v[3] = {d.x, d.y, d.z};
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) c[3 * a + b] += v[a] * v[b];
    }
    for (auto& e : c) e /= m;
    float w[3];
    M3 v;
    eigh3(c, w, v);
    // eigenvalues ascending -> replace with (1e-3, 1, 1) on the sorted order
    int order[3] = {0, 1, 2};
    std::sort(order, order + 3, [&](int a, int b) { return w[a] < w[b]; });
    float rep[3];
    rep[order[0]] = 1e-3f;
    rep[order[1]] = 1.0f;
    rep[order[2]] = 1.0f;
    M3 vd{};
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) vd[3 * a + b] = v[3 * a + b] * rep[b];
    covs[i] = m3_mul_t(vd, v);
  }
}

struct GicpScratch {
  std::vector<int> corr;
  std::vector<M3> mahal;
};

// one linearization: correspondences + H/b/error (nano_gicp_impl.hpp:173-270)
double linearize(const M4& x0, const std::vector<V3>& src,
                 const std::vector<M3>& src_cov, const std::vector<V3>& tgt,
                 const std::vector<M3>& tgt_cov, const KdTree& tree,
                 const GicpParams& p, GicpScratch& s, double h[36],
                 double b[6]) {
  const int n = (int)src.size();
  s.corr.assign(n, -1);
  s.mahal.resize(n);
  const M3 r = m4_rot(x0);
  const float max_d2 = p.max_corr_dist * p.max_corr_dist;
  std::memset(h, 0, 36 * sizeof(double));
  std::memset(b, 0, 6 * sizeof(double));
  double err = 0;
#pragma omp parallel
  {
    double hl[36] = {0}, bl[6] = {0}, el = 0;
#pragma omp for schedule(guided, 8) nowait
    for (int i = 0; i < n; ++i) {
      const V3 pt = m4_apply(x0, src[i]);
      float d2;
      const int j = tree.nn1(pt, max_d2, &d2);
      if (j < 0) continue;
      s.corr[i] = j;
      // M = (C_B + R C_A R^T)^-1
      const M3 rca = m3_mul(r, src_cov[i]);
      M3 rcar = m3_mul_t(rca, r);
      for (int e = 0; e < 9; ++e) rcar[e] += tgt_cov[j][e];
      const M3 M = sym_inv3(rcar);
      s.mahal[i] = M;
      const V3 e3 = tgt[j] - pt;
      const V3 me = m3_apply(M, e3);
      el += dot(e3, me);
      // J = [skew(pt) | -I]; accumulate H += J^T M J, b += J^T M e
      const float sk[9] = {0, -pt.z, pt.y, pt.z, 0, -pt.x, -pt.y, pt.x, 0};
      // columns of J: c0..c2 = skew columns, c3..c5 = -e_i
      float jc[6][3];
      for (int c = 0; c < 3; ++c)
        for (int rr = 0; rr < 3; ++rr) jc[c][rr] = sk[3 * rr + c];
      for (int c = 3; c < 6; ++c)
        for (int rr = 0; rr < 3; ++rr) jc[c][rr] = (rr == c - 3) ? -1.0f : 0.0f;
      float mj[6][3];
      for (int c = 0; c < 6; ++c) {
        const V3 col = m3_apply(M, {jc[c][0], jc[c][1], jc[c][2]});
        mj[c][0] = col.x;
        mj[c][1] = col.y;
        mj[c][2] = col.z;
      }
      for (int a = 0; a < 6; ++a) {
        for (int c = a; c < 6; ++c) {
          const double v = jc[a][0] * mj[c][0] + jc[a][1] * mj[c][1] +
                           jc[a][2] * mj[c][2];
          hl[6 * a + c] += v;
        }
        bl[a] += jc[a][0] * me.x + jc[a][1] * me.y + jc[a][2] * me.z;
      }
    }
#pragma omp critical
    {
      for (int e = 0; e < 36; ++e) h[e] += hl[e];
      for (int e = 0; e < 6; ++e) b[e] += bl[e];
      err += el;
    }
  }
  for (int a = 0; a < 6; ++a)
    for (int c = 0; c < a; ++c) h[6 * a + c] = h[6 * c + a];
  // b convention: residual e = mu_B - T mu_A, J as above, b = J^T M e, and
  // the solve is (H + lambda I) d = -b
  return err;
}

// error with frozen correspondences (nano_gicp_impl.hpp:272-296)
double compute_error(const M4& x, const std::vector<V3>& src,
                     const std::vector<V3>& tgt, const GicpScratch& s) {
  const int n = (int)src.size();
  double err = 0;
#pragma omp parallel for schedule(guided, 8) reduction(+ : err)
  for (int i = 0; i < n; ++i) {
    const int j = s.corr[i];
    if (j < 0) continue;
    const V3 pt = m4_apply(x, src[i]);
    const V3 e3 = tgt[j] - pt;
    err += dot(e3, m3_apply(s.mahal[i], e3));
  }
  return err;
}

bool is_converged(const M4& delta, const GicpParams& p) {
  float rmax = 0, tmax = 0;
  const int rix[9] = {0, 1, 2, 4, 5, 6, 8, 9, 10};
  const float eye[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
  for (int i = 0; i < 9; ++i)
    rmax = std::fmax(rmax, std::fabs(delta[rix[i]] - eye[i]));
  for (int i = 0; i < 3; ++i)
    tmax = std::fmax(tmax, std::fabs(delta[4 * i + 3]));
  return std::fmax(rmax / p.rot_eps, tmax / p.trans_eps) < 1.0f;
}

// LM outer/inner loop (lsq_registration_impl.hpp:89-208)
M4 gicp_align(const std::vector<V3>& src, const std::vector<M3>& src_cov,
              const std::vector<V3>& tgt, const std::vector<M3>& tgt_cov,
              const KdTree& tree, const M4& guess, const GicpParams& p) {
  M4 x0 = guess;
  GicpScratch s;
  double lm_lambda = -1.0;
  for (int it = 0; it < p.max_iterations; ++it) {
    double h[36], b[6];
    const double y0 = linearize(x0, src, src_cov, tgt, tgt_cov, tree, p, s, h, b);
    if (lm_lambda < 0) {
      double dmax = 0;
      for (int i = 0; i < 6; ++i) dmax = std::fmax(dmax, std::fabs(h[7 * i]));
      lm_lambda = p.lm_init_lambda_factor * dmax;
    }
    double nu = 2.0;
    M4 delta = m4_identity();
    bool accepted = false;
    for (int li = 0; li < p.lm_max_iterations; ++li) {
      double hd[36];
      std::memcpy(hd, h, sizeof(hd));
      for (int i = 0; i < 6; ++i) hd[7 * i] += lm_lambda;
      double nb[6], d[6];
      for (int i = 0; i < 6; ++i) nb[i] = -b[i];
      if (!solve6(hd, nb, d)) break;
      delta = se3_exp(d);
      const M4 xi = m4_mul(delta, x0);
      const double yi = compute_error(xi, src, tgt, s);
      double denom = 0;
      for (int i = 0; i < 6; ++i) denom += d[i] * (lm_lambda * d[i] - b[i]);
      const double rho = (y0 - yi) / (std::fabs(denom) > 1e-30 ? denom : 1e-30);
      if (rho >= 0) {
        x0 = xi;
        lm_lambda *= std::fmax(1.0 / 3.0, 1.0 - std::pow(2.0 * rho - 1.0, 3));
        accepted = true;
        break;
      }
      if (is_converged(delta, p)) {  // reject-but-converged exit
        accepted = true;
        break;
      }
      lm_lambda *= nu;
      nu *= 2.0;
    }
    if (!accepted) break;  // "lm not converged!!"
    if (is_converged(delta, p)) break;
  }
  return x0;
}

// ---------------------------------------------------------------------------
// Preprocessing (voxel centroid downsample + inverse crop; odom.cc:443-465)
// ---------------------------------------------------------------------------

void preprocess(const std::vector<V3>& in, float crop, float res,
                std::vector<V3>& out) {
  out.clear();
  float mn[3] = {1e30f, 1e30f, 1e30f};
  for (const V3& p : in) {
    if (!std::isfinite(p.x) || !std::isfinite(p.y) || !std::isfinite(p.z))
      continue;
    if (crop > 0 && std::fabs(p.x) <= crop && std::fabs(p.y) <= crop &&
        std::fabs(p.z) <= crop)
      continue;
    mn[0] = std::fmin(mn[0], p.x);
    mn[1] = std::fmin(mn[1], p.y);
    mn[2] = std::fmin(mn[2], p.z);
  }
  struct Acc {
    float x = 0, y = 0, z = 0;
    uint32_t n = 0;
  };
  std::unordered_map<uint64_t, Acc> vox;
  vox.reserve(in.size());
  const float inv = 1.0f / res;
  for (const V3& p : in) {
    if (!std::isfinite(p.x) || !std::isfinite(p.y) || !std::isfinite(p.z))
      continue;
    if (crop > 0 && std::fabs(p.x) <= crop && std::fabs(p.y) <= crop &&
        std::fabs(p.z) <= crop)
      continue;
    const uint64_t ix = (uint64_t)((p.x - mn[0]) * inv);
    const uint64_t iy = (uint64_t)((p.y - mn[1]) * inv);
    const uint64_t iz = (uint64_t)((p.z - mn[2]) * inv);
    Acc& a = vox[(ix << 42) | (iy << 21) | iz];
    a.x += p.x;
    a.y += p.y;
    a.z += p.z;
    a.n += 1;
  }
  out.reserve(vox.size());
  for (const auto& kv : vox)
    out.push_back({kv.second.x / kv.second.n, kv.second.y / kv.second.n,
                   kv.second.z / kv.second.n});
}

// ---------------------------------------------------------------------------
// Morton-ordered uniform thinning (--thin N): the same spatially uniform
// Bresenham stride along the Z-curve the JAX pipeline uses when the voxeled
// cloud exceeds its static n_scan budget (ops/voxel.py
// voxel_downsample_morton) — offered to the CPU baseline so the two sides
// can be measured at the SAME per-frame point budget (same-work protocol).
// ---------------------------------------------------------------------------

static inline uint32_t expand10(uint32_t v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

void thin_morton(std::vector<V3>& pts, size_t cap, float res) {
  const size_t n = pts.size();
  if (n <= cap || cap == 0) return;
  float mn[3] = {1e30f, 1e30f, 1e30f};
  for (const V3& p : pts) {
    mn[0] = std::fmin(mn[0], p.x);
    mn[1] = std::fmin(mn[1], p.y);
    mn[2] = std::fmin(mn[2], p.z);
  }
  const float inv = 1.0f / res;
  std::vector<std::pair<uint32_t, uint32_t>> keys(n);
  for (size_t i = 0; i < n; ++i) {
    const V3& p = pts[i];
    const uint32_t ix =
        (uint32_t)std::fmin(std::fmax((p.x - mn[0]) * inv, 0.0f), 1023.0f);
    const uint32_t iy =
        (uint32_t)std::fmin(std::fmax((p.y - mn[1]) * inv, 0.0f), 1023.0f);
    const uint32_t iz =
        (uint32_t)std::fmin(std::fmax((p.z - mn[2]) * inv, 0.0f), 1023.0f);
    keys[i] = {(expand10(ix) << 2) | (expand10(iy) << 1) | expand10(iz),
               (uint32_t)i};
  }
  std::sort(keys.begin(), keys.end());
  std::vector<V3> out;
  out.reserve(cap);
  // keep segment i iff floor(i*cap/n) increments — an even stride along a
  // space-filling curve is an even stride through space
  for (size_t i = 0; i < n; ++i)
    if ((uint64_t)i * cap % n < cap) out.push_back(pts[keys[i].second]);
  pts.swap(out);
}

// ---------------------------------------------------------------------------
// Pipeline state
// ---------------------------------------------------------------------------

struct Keyframe {
  V3 pos;
  M3 rot;
  std::vector<V3> cloud;  // world frame, submap-voxeled
  std::vector<M3> covs;
};

struct Odometry {
  GicpParams s2s{10, 1.0f, 32, 0.01f, 2e-3f, 10, 1e-9f};
  GicpParams s2m{20, 0.5f, 32, 0.01f, 2e-3f, 10, 1e-9f};
  float keyframe_thresh_d = 5.0f;  // overridden adaptively
  float keyframe_thresh_r = 45.0f;
  int submap_knn = 10, submap_kcv = 10, submap_kcc = 10;
  float submap_voxel = 0.5f;
  bool adaptive = true;
  bool cv_prior = false;

  M4 pose = m4_identity();
  M4 t_s2s_prev = m4_identity();
  M4 last_rel = m4_identity();
  std::vector<V3> prev_scan;
  std::vector<M3> prev_covs;
  KdTree prev_tree;
  std::vector<Keyframe> keyframes;
  std::vector<int> submap_idx_prev;
  std::vector<V3> submap_cloud;
  std::vector<M3> submap_covs;
  KdTree submap_tree;
  float spaciousness = 0.0f;

  void adapt(const std::vector<V3>& scan) {
    // spaciousness = LPF median range -> threshD steps (odom.cc:990-1010,
    // 1188-1204)
    std::vector<float> rng(scan.size());
    for (size_t i = 0; i < scan.size(); ++i) rng[i] = std::sqrt(norm2(scan[i]));
    if (rng.empty()) return;
    std::nth_element(rng.begin(), rng.begin() + rng.size() / 2, rng.end());
    const float med = rng[rng.size() / 2];
    spaciousness = 0.95f * spaciousness + 0.05f * med;
    if (!adaptive) return;
    if (spaciousness > 20)
      keyframe_thresh_d = 10.0f;
    else if (spaciousness > 10)
      keyframe_thresh_d = 5.0f;
    else if (spaciousness > 5)
      keyframe_thresh_d = 1.0f;
    else
      keyframe_thresh_d = 0.5f;
  }

  void add_keyframe(const std::vector<V3>& scan, const std::vector<M3>& covs) {
    Keyframe kf;
    kf.pos = {pose[3], pose[7], pose[11]};
    kf.rot = m4_rot(pose);
    std::vector<V3> world(scan.size());
    for (size_t i = 0; i < scan.size(); ++i) world[i] = m4_apply(pose, scan[i]);
    if (submap_voxel > 0) {
      preprocess(world, 0.0f, submap_voxel, kf.cloud);
      // recompute covariances on the voxeled keyframe cloud (the reference
      // computes covariances for the stored keyframe cloud via a temp GICP,
      // odom.cc:1172-1174)
      KdTree t;
      t.build(kf.cloud);
      calc_covariances(kf.cloud, t, s2s.k_correspondences, kf.covs);
    } else {
      kf.cloud = std::move(world);
      kf.covs = covs;  // note: world-rotated covs would be R C R^T; the
                       // reference stores covs of the transformed cloud
    }
    keyframes.push_back(std::move(kf));
  }

  // k-smallest selection into a set (pushSubmapIndices, odom.cc:1210-1233)
  static void push_k_smallest(const std::vector<float>& d,
                              const std::vector<int>& ids, int k,
                              std::vector<int>& out) {
    std::vector<std::pair<float, int>> v;
    v.reserve(d.size());
    for (size_t i = 0; i < d.size(); ++i) v.emplace_back(d[i], ids[i]);
    const int m = std::min<int>(k, (int)v.size());
    std::partial_sort(v.begin(), v.begin() + m, v.end());
    for (int i = 0; i < m; ++i) out.push_back(v[i].second);
  }

  void select_submap(const M4& t_s2s) {
    const V3 cur{t_s2s[3], t_s2s[7], t_s2s[11]};
    std::vector<float> d(keyframes.size());
    std::vector<int> ids(keyframes.size());
    for (size_t i = 0; i < keyframes.size(); ++i) {
      d[i] = norm2(keyframes[i].pos - cur);
      ids[i] = (int)i;
    }
    std::vector<int> sel;
    push_k_smallest(d, ids, submap_knn, sel);
    // hull members: with <= ~30 keyframes all keyframes are hull/knn members
    // anyway; approximate the convex/concave-hull kNN sets (odom.cc:1240-1331)
    // with two more kNN picks over the extremal keyframes by distance from
    // the centroid (boundary proxy). For the benchmark trajectory lengths the
    // selected set is identical to the reference's.
    V3 centroid{};
    for (const auto& kf : keyframes) centroid = centroid + kf.pos;
    const float icnt = 1.0f / std::max<size_t>(keyframes.size(), 1);
    centroid = {centroid.x * icnt, centroid.y * icnt, centroid.z * icnt};
    std::vector<std::pair<float, int>> ext;
    for (size_t i = 0; i < keyframes.size(); ++i)
      ext.emplace_back(-norm2(keyframes[i].pos - centroid), (int)i);
    std::sort(ext.begin(), ext.end());
    const int nhull = std::min<int>((int)ext.size(),
                                    std::max(submap_kcv, submap_kcc));
    std::vector<float> hd;
    std::vector<int> hids;
    for (int i = 0; i < nhull; ++i) {
      hids.push_back(ext[i].second);
      hd.push_back(d[ext[i].second]);
    }
    push_k_smallest(hd, hids, submap_kcv, sel);
    push_k_smallest(hd, hids, submap_kcc, sel);
    std::sort(sel.begin(), sel.end());
    sel.erase(std::unique(sel.begin(), sel.end()), sel.end());
    if (sel == submap_idx_prev) return;  // change detection (odom.cc:1309)
    submap_idx_prev = sel;
    submap_cloud.clear();
    submap_covs.clear();
    for (int i : sel) {
      submap_cloud.insert(submap_cloud.end(), keyframes[i].cloud.begin(),
                          keyframes[i].cloud.end());
      submap_covs.insert(submap_covs.end(), keyframes[i].covs.begin(),
                         keyframes[i].covs.end());
    }
    submap_tree.build(submap_cloud);
  }

  bool step(const std::vector<V3>& scan, M4* out_pose) {
    adapt(scan);
    // covariances once per scan (reused S2S source + next target via swap,
    // odom.cc:815-818)
    KdTree scan_tree;
    scan_tree.build(scan);
    std::vector<M3> covs;
    calc_covariances(scan, scan_tree, s2s.k_correspondences, covs);

    if (prev_scan.empty()) {
      prev_scan = scan;
      prev_covs = covs;
      prev_tree.build(prev_scan);
      add_keyframe(scan, covs);
      select_submap(pose);
      *out_pose = pose;
      return true;
    }

    const M4 guess = cv_prior ? last_rel : m4_identity();
    const M4 t_rel =
        gicp_align(scan, covs, prev_scan, prev_covs, prev_tree, guess, s2s);
    last_rel = t_rel;
    const M4 t_s2s = m4_mul(t_s2s_prev, t_rel);

    select_submap(t_s2s);
    M4 t = t_s2s;
    if (!submap_cloud.empty())
      t = gicp_align(scan, covs, submap_cloud, submap_covs, submap_tree, t_s2s,
                     s2m);
    t_s2s_prev = t;
    pose = t;

    // keyframe decision (odom.cc:1097-1153)
    const V3 cur{pose[3], pose[7], pose[11]};
    float closest = 1e30f;
    int closest_i = 0, num_nearby = 0;
    for (size_t i = 0; i < keyframes.size(); ++i) {
      const float dd = std::sqrt(norm2(keyframes[i].pos - cur));
      if (dd <= keyframe_thresh_d * 1.5f) ++num_nearby;
      if (dd < closest) {
        closest = dd;
        closest_i = (int)i;
      }
    }
    // rotation delta via trace of R_kf^T R
    const M3 rrel = m3_mul_t(keyframes[closest_i].rot, m4_rot(pose));
    // note m3_mul_t(a,b)=a*b^T; we want R_kf^T * R: use transpose-first form
    const M3 rkfT = {keyframes[closest_i].rot[0], keyframes[closest_i].rot[3],
                     keyframes[closest_i].rot[6], keyframes[closest_i].rot[1],
                     keyframes[closest_i].rot[4], keyframes[closest_i].rot[7],
                     keyframes[closest_i].rot[2], keyframes[closest_i].rot[5],
                     keyframes[closest_i].rot[8]};
    (void)rrel;
    const M3 dr = m3_mul(rkfT, m4_rot(pose));
    const float cos_t = std::fmin(1.0f, std::fmax(-1.0f, (dr[0] + dr[4] + dr[8] - 1) * 0.5f));
    const float theta_deg = std::acos(cos_t) * 180.0f / (float)M_PI;
    const bool newkf = closest > keyframe_thresh_d ||
                       (theta_deg > keyframe_thresh_r && num_nearby <= 1);
    if (newkf) add_keyframe(scan, covs);

    // scan t becomes target t+1 (swapSourceAndTarget, odom.cc:818)
    prev_scan = scan;
    prev_covs = std::move(covs);
    prev_tree.build(prev_scan);
    *out_pose = pose;
    return true;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// main: scan dump in, trajectory + JSON out
// ---------------------------------------------------------------------------

int main(int argc, char** argv) {
  const char* in_path = nullptr;
  const char* out_path = nullptr;
  bool cv_prior = false;
  int threads = 0;
  long thin = 0;
  for (int i = 1; i < argc; ++i) {
    if (!std::strcmp(argv[i], "--cv"))
      cv_prior = true;
    else if (!std::strcmp(argv[i], "--threads") && i + 1 < argc)
      threads = std::atoi(argv[++i]);
    else if (!std::strcmp(argv[i], "--thin") && i + 1 < argc)
      thin = std::atol(argv[++i]);
    else if (!in_path)
      in_path = argv[i];
    else
      out_path = argv[i];
  }
  if (!in_path || !out_path) {
    std::fprintf(stderr,
                 "usage: dlo_baseline [--cv] [--threads N] [--thin N] "
                 "scans.bin traj.bin\n");
    return 2;
  }
  if (threads > 0) omp_set_num_threads(threads);

  FILE* f = std::fopen(in_path, "rb");
  if (!f) {
    std::fprintf(stderr, "cannot open %s\n", in_path);
    return 1;
  }
  char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "DLOSCAN1", 8)) {
    std::fprintf(stderr, "bad magic\n");
    return 1;
  }
  int64_t n_frames = 0;
  if (std::fread(&n_frames, 8, 1, f) != 1) return 1;
  std::vector<std::vector<V3>> scans(n_frames);
  std::vector<double> stamps(n_frames);
  for (int64_t t = 0; t < n_frames; ++t) {
    int64_t n = 0;
    if (std::fread(&stamps[t], 8, 1, f) != 1) return 1;
    if (std::fread(&n, 8, 1, f) != 1) return 1;
    scans[t].resize(n);
    if (std::fread(scans[t].data(), sizeof(float) * 3, n, f) != (size_t)n)
      return 1;
  }
  std::fclose(f);

  Odometry odo;
  odo.cv_prior = cv_prior;
  std::vector<M4> traj;
  std::vector<double> ms;
  for (int64_t t = 0; t < n_frames; ++t) {
    const auto t0 = std::chrono::steady_clock::now();
    std::vector<V3> pp;
    preprocess(scans[t], 1.0f, 0.25f, pp);
    if (thin > 0) thin_morton(pp, (size_t)thin, 0.25f);
    M4 p;
    odo.step(pp, &p);
    const auto t1 = std::chrono::steady_clock::now();
    traj.push_back(p);
    ms.push_back(std::chrono::duration<double, std::milli>(t1 - t0).count());
    std::fprintf(stderr, "# frame %ld: %.1f ms, %zu pts, %zu kf\n", (long)t,
                 ms.back(), pp.size(), odo.keyframes.size());
  }

  FILE* of = std::fopen(out_path, "wb");
  if (!of) return 1;
  std::fwrite(&n_frames, 8, 1, of);
  for (int64_t t = 0; t < n_frames; ++t) {
    std::fwrite(&stamps[t], 8, 1, of);
    std::fwrite(traj[t].data(), sizeof(float), 16, of);
  }
  std::fclose(of);

  std::vector<double> sorted(ms.begin() + std::min<size_t>(1, ms.size() - 1),
                             ms.end());
  std::sort(sorted.begin(), sorted.end());
  const double med = sorted[sorted.size() / 2];
  const double mean =
      std::accumulate(sorted.begin(), sorted.end(), 0.0) / sorted.size();
  std::printf(
      "{\"frames\": %ld, \"median_ms\": %.2f, \"mean_ms\": %.2f, "
      "\"fps\": %.2f, \"threads\": %d, \"thin\": %ld}\n",
      (long)n_frames, med, mean, 1000.0 / med, omp_get_max_threads(), thin);
  return 0;
}
