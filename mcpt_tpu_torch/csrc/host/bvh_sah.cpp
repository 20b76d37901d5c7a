// Binned-SAH BVH builder for the host, emitted as flattened skip-link arrays.
//
// The port's own copy of the builder in mcpt_tpu/native/mcpt_native.cpp
// (mcpt_build_bvh): 16 bins on the longest centroid axis, a Lomuto
// partition at the best bin, the median index on a degenerate split, leaves
// of at most `leaf_size` triangles, nodes in DFS preorder. Same output, so
// the triangle order, and with it every triangle id, equals the JAX
// package's. ops/bvh.py documents the layout and builds this file with g++.
//
// Floating point. The file is compiled with -ffp-contract=off, and the two
// places where the JAX package's build (g++ -O3 -march=native) fuses a
// multiply and an add are written as std::fma, in the operand order that
// build uses: the half area of a bin box and the SAH cost. So the result
// does not depend on the host's CPU or on how the compiler contracts.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  double x = 0, y = 0, z = 0;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  Vec3 lo{DBL_MAX, DBL_MAX, DBL_MAX};
  Vec3 hi{-DBL_MAX, -DBL_MAX, -DBL_MAX};
  void grow(const Box& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  // dx*dy + dy*dz + dz*dx, fused as fma(dz, dx, fma(dy, dx, dy*dz))
  double half_area() const {
    double dx = std::max(hi.x - lo.x, 0.0);
    double dy = std::max(hi.y - lo.y, 0.0);
    double dz = std::max(hi.z - lo.z, 0.0);
    return std::fma(dx, dz, std::fma(dy, dx, dy * dz));
  }
};

struct Builder {
  const double *v0, *e1, *e2;
  int64_t T;
  int leaf_size;
  std::vector<Box> tri_box;
  std::vector<Vec3> centroid;
  std::vector<int64_t> order;

  std::vector<float> lo, hi;
  std::vector<int32_t> first, count, skip_end;  // skip_end = preorder end

  void prepare() {
    tri_box.resize(T);
    centroid.resize(T);
    order.resize(T);
    for (int64_t i = 0; i < T; i++) {
      Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
      Vec3 b{a.x + e1[3 * i], a.y + e1[3 * i + 1], a.z + e1[3 * i + 2]};
      Vec3 c{a.x + e2[3 * i], a.y + e2[3 * i + 1], a.z + e2[3 * i + 2]};
      Box bb;
      bb.grow(a);
      bb.grow(b);
      bb.grow(c);
      tri_box[i] = bb;
      centroid[i] = {(a.x + b.x + c.x) / 3.0, (a.y + b.y + c.y) / 3.0,
                     (a.z + b.z + c.z) / 3.0};
      order[i] = i;
    }
  }

  int32_t emit_node(const Box& bb) {
    lo.push_back((float)bb.lo.x);
    lo.push_back((float)bb.lo.y);
    lo.push_back((float)bb.lo.z);
    hi.push_back((float)bb.hi.x);
    hi.push_back((float)bb.hi.y);
    hi.push_back((float)bb.hi.z);
    first.push_back(0);
    count.push_back(0);
    skip_end.push_back(0);
    return (int32_t)(first.size() - 1);
  }

  // Binned SAH split of order[l:r) (partitioned in place); returns the
  // split point m. Called only for r - l > leaf_size.
  int64_t find_split(int64_t l, int64_t r, const Box& node_box) {
    const int NBINS = 16;
    Box cb;
    for (int64_t i = l; i < r; i++) cb.grow(centroid[order[i]]);
    double ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = ext[1] > ext[0] ? 1 : 0;
    if (ext[2] > ext[axis]) axis = 2;
    if (ext[axis] <= 0.0) return (l + r) / 2;  // all centroids equal: median

    auto caxis = [&](int64_t t) {
      const Vec3& c = centroid[t];
      return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
    };
    double c_lo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
    double scale = NBINS / ext[axis];

    Box bin_box[NBINS];
    int64_t bin_cnt[NBINS] = {0};
    for (int64_t i = l; i < r; i++) {
      int64_t t = order[i];
      int bidx = (int)((caxis(t) - c_lo) * scale);
      bidx = std::min(std::max(bidx, 0), NBINS - 1);
      bin_box[bidx].grow(tri_box[t]);
      bin_cnt[bidx]++;
    }
    Box left_acc[NBINS];
    int64_t left_cnt[NBINS];
    Box acc;
    int64_t cnt = 0;
    for (int i = 0; i < NBINS; i++) {
      acc.grow(bin_box[i]);
      cnt += bin_cnt[i];
      left_acc[i] = acc;
      left_cnt[i] = cnt;
    }
    Box racc;
    double best = DBL_MAX;
    int best_bin = -1;
    for (int i = NBINS - 1; i >= 1; i--) {
      racc.grow(bin_box[i]);
      int64_t rc = (r - l) - left_cnt[i - 1];
      if (left_cnt[i - 1] == 0 || rc == 0) continue;
      // left area * left count + right area * right count, fused
      double cost = std::fma(racc.half_area(), (double)rc,
                             left_acc[i - 1].half_area() * (double)left_cnt[i - 1]);
      if (cost < best) {
        best = cost;
        best_bin = i;
      }
    }
    double leaf_cost = node_box.half_area() * (double)(r - l);
    if (best_bin < 0 || ((r - l) <= leaf_size && best >= leaf_cost)) return (l + r) / 2;

    double split_val = c_lo + best_bin / scale;
    int64_t m = l;
    for (int64_t i = l; i < r; i++) {
      if (caxis(order[i]) < split_val) std::swap(order[i], order[m++]);
    }
    if (m == l || m == r) m = (l + r) / 2;
    return m;
  }

  void build() {
    // iterative DFS: frame = (l, r, m, node, phase)
    struct Frame {
      int64_t l, r, m;
      int32_t node;
      int phase;
    };
    std::vector<Frame> st;
    st.push_back({0, T, 0, -1, 0});
    while (!st.empty()) {
      Frame& f = st.back();
      if (f.phase == 0) {
        Box bb;
        for (int64_t i = f.l; i < f.r; i++) bb.grow(tri_box[order[i]]);
        f.node = emit_node(bb);
        if (f.r - f.l <= leaf_size) {
          first[f.node] = (int32_t)f.l;
          count[f.node] = (int32_t)(f.r - f.l);
          skip_end[f.node] = f.node + 1;
          st.pop_back();
          continue;
        }
        f.m = find_split(f.l, f.r, bb);
        f.phase = 1;
        const int64_t l = f.l, m = f.m;
        st.push_back({l, m, 0, -1, 0});  // may reallocate: f is not used after
      } else if (f.phase == 1) {
        f.phase = 2;
        const int64_t m = f.m, r = f.r;
        st.push_back({m, r, 0, -1, 0});
      } else {
        skip_end[f.node] = (int32_t)first.size();
        st.pop_back();
      }
    }
  }
};

}  // namespace

extern "C" {

// Build a flattened skip-link BVH over T triangles (v0, e1, e2: f64[T,3]).
// The output buffers hold 2*T nodes (the most a build can emit) and T
// permutation entries. Returns the node count, or -1 on bad input.
int64_t mcpt_torch_build_bvh(const double* v0, const double* e1, const double* e2, int64_t T,
                             int32_t leaf_size, float* out_lo, float* out_hi,
                             int32_t* out_first, int32_t* out_count, int32_t* out_skip,
                             int64_t* out_perm) {
  if (T <= 0 || T > INT32_MAX / 2 || leaf_size < 1) return -1;
  Builder b;
  b.v0 = v0;
  b.e1 = e1;
  b.e2 = e2;
  b.T = T;
  b.leaf_size = leaf_size;
  b.prepare();
  b.build();
  int64_t n = (int64_t)b.first.size();
  if (n > 2 * T) return -1;
  std::memcpy(out_lo, b.lo.data(), n * 3 * sizeof(float));
  std::memcpy(out_hi, b.hi.data(), n * 3 * sizeof(float));
  std::memcpy(out_first, b.first.data(), n * sizeof(int32_t));
  std::memcpy(out_count, b.count.data(), n * sizeof(int32_t));
  for (int64_t i = 0; i < n; i++) out_skip[i] = (b.skip_end[i] >= n) ? -1 : b.skip_end[i];
  std::memcpy(out_perm, b.order.data(), T * sizeof(int64_t));
  return n;
}

}  // extern "C"
