// Native binned-SAH BVH builder: the port's own copy of the JAX package's
// `rpt_tpu/native/bvh_builder.cpp`. Everything below this comment block is
// that file byte for byte (tests/test_torch_import.py holds it so); only
// this header differs.
//
// It replaces the reference's recursive kd-tree construction
// (`src/kdtree.rs:238-348`) with a binned surface-area-heuristic build (16
// bins) of the FlatBVH arrays that `accel/bvh.py::pack_bvh` packs for the
// traversal kernels K1/K2 (`csrc/bvh_traverse.cu`); it builds ~10x faster
// than the vectorized-numpy LBVH on one host core, and the tree's quality
// sets the traversal's step count.
//
// Exposed as a flat C ABI for ctypes. It is compiled with g++ (not nvcc:
// `ops/_build.py` globs only `*.cu`) by `accel/bvh.py::_load_bvh`.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3f {
  float x, y, z;
};

static inline Vec3f vmin(const Vec3f& a, const Vec3f& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3f vmax(const Vec3f& a, const Vec3f& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3f lo{1e30f, 1e30f, 1e30f};
  Vec3f hi{-1e30f, -1e30f, -1e30f};
  void grow(const AABB& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3f& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Node {
  AABB box;
  int32_t left = -1, right = -1;  // node ids (internal)
  int32_t first = 0, count = 0;   // leaf range into perm
};

struct Builder {
  const float* bb_min;  // (n, 3)
  const float* bb_max;
  int32_t n;
  int32_t leaf_size;
  std::vector<int32_t> perm;
  std::vector<Vec3f> centroid;
  std::vector<AABB> prim_box;
  std::vector<Node> nodes;

  AABB range_box(int32_t first, int32_t count) const {
    AABB b;
    for (int32_t i = first; i < first + count; ++i) b.grow(prim_box[perm[i]]);
    return b;
  }

  int32_t build(int32_t first, int32_t count) {
    Node node;
    node.box = range_box(first, count);
    int32_t id = (int32_t)nodes.size();
    nodes.push_back(node);
    if (count <= leaf_size) {
      nodes[id].first = first;
      nodes[id].count = count;
      return id;
    }

    // centroid bounds
    AABB cb;
    for (int32_t i = first; i < first + count; ++i) cb.grow(centroid[perm[i]]);

    constexpr int BINS = 16;
    float best_cost = 1e30f;
    int best_axis = -1, best_split = -1;
    AABB bin_box[3][BINS];
    int bin_cnt[3][BINS];

    const float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    for (int axis = 0; axis < 3; ++axis) {
      if (ext[axis] <= 1e-12f) continue;
      for (int b = 0; b < BINS; ++b) {
        bin_box[axis][b] = AABB();
        bin_cnt[axis][b] = 0;
      }
      const float scale = BINS / ext[axis];
      const float base = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
      for (int32_t i = first; i < first + count; ++i) {
        const Vec3f& c = centroid[perm[i]];
        float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        int b = std::min(BINS - 1, (int)((v - base) * scale));
        bin_box[axis][b].grow(prim_box[perm[i]]);
        bin_cnt[axis][b]++;
      }
      // sweep: cost(split s) = A_l * n_l + A_r * n_r
      AABB right_acc[BINS];
      AABB acc;
      for (int b = BINS - 1; b >= 1; --b) {
        acc.grow(bin_box[axis][b]);
        right_acc[b] = acc;
      }
      AABB left_acc;
      int left_n = 0;
      for (int s = 1; s < BINS; ++s) {
        left_acc.grow(bin_box[axis][s - 1]);
        left_n += bin_cnt[axis][s - 1];
        int right_n = count - left_n;
        if (left_n == 0 || right_n == 0) continue;
        float cost = left_acc.area() * left_n + right_acc[s].area() * right_n;
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_split = s;
        }
      }
    }

    int32_t mid;
    if (best_axis < 0) {
      mid = first + count / 2;  // degenerate: median split
    } else {
      const float scale =
          BINS / ext[best_axis];
      const float base = best_axis == 0 ? cb.lo.x : (best_axis == 1 ? cb.lo.y : cb.lo.z);
      auto bin_of = [&](int32_t p) {
        const Vec3f& c = centroid[p];
        float v = best_axis == 0 ? c.x : (best_axis == 1 ? c.y : c.z);
        return std::min(15, (int)((v - base) * scale));
      };
      int32_t* lo = perm.data() + first;
      int32_t* hi = lo + count;
      int32_t* pm = std::partition(lo, hi, [&](int32_t p) { return bin_of(p) < best_split; });
      mid = (int32_t)(pm - perm.data());
      if (mid == first || mid == first + count) mid = first + count / 2;
    }

    int32_t l = build(first, mid - first);
    int32_t r = build(mid, first + count - mid);
    nodes[id].left = l;
    nodes[id].right = r;
    return id;
  }
};

}  // namespace

extern "C" {

// Build; returns node count. Caller then calls bvh_export and bvh_free.
// Handle-based to keep the ABI simple for ctypes.
void* bvh_build(const float* bb_min, const float* bb_max, int32_t n, int32_t leaf_size) {
  auto* b = new Builder();
  b->bb_min = bb_min;
  b->bb_max = bb_max;
  b->n = n;
  b->leaf_size = leaf_size;
  b->perm.resize(n);
  b->centroid.resize(n);
  b->prim_box.resize(n);
  for (int32_t i = 0; i < n; ++i) {
    b->perm[i] = i;
    Vec3f lo{bb_min[3 * i], bb_min[3 * i + 1], bb_min[3 * i + 2]};
    Vec3f hi{bb_max[3 * i], bb_max[3 * i + 1], bb_max[3 * i + 2]};
    b->prim_box[i].lo = lo;
    b->prim_box[i].hi = hi;
    b->centroid[i] = {0.5f * (lo.x + hi.x), 0.5f * (lo.y + hi.y), 0.5f * (lo.z + hi.z)};
  }
  b->nodes.reserve(2 * n / leaf_size + 2);
  if (n > 0) b->build(0, n);
  return b;
}

int32_t bvh_num_nodes(void* handle) { return (int32_t)((Builder*)handle)->nodes.size(); }

void bvh_export(void* handle, float* out_bb_min, float* out_bb_max, int32_t* out_left,
                int32_t* out_right, int32_t* out_first, int32_t* out_count,
                int32_t* out_perm) {
  Builder* b = (Builder*)handle;
  const auto& nodes = b->nodes;
  for (size_t i = 0; i < nodes.size(); ++i) {
    out_bb_min[3 * i] = nodes[i].box.lo.x;
    out_bb_min[3 * i + 1] = nodes[i].box.lo.y;
    out_bb_min[3 * i + 2] = nodes[i].box.lo.z;
    out_bb_max[3 * i] = nodes[i].box.hi.x;
    out_bb_max[3 * i + 1] = nodes[i].box.hi.y;
    out_bb_max[3 * i + 2] = nodes[i].box.hi.z;
    out_left[i] = nodes[i].left;
    out_right[i] = nodes[i].right;
    out_first[i] = nodes[i].first;
    out_count[i] = nodes[i].count;
  }
  std::memcpy(out_perm, b->perm.data(), sizeof(int32_t) * b->n);
}

void bvh_free(void* handle) { delete (Builder*)handle; }

}  // extern "C"
