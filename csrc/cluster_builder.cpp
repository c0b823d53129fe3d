// Native scene-build runtime: binned-SAH BVH -> triangle clusters.
//
// The reference delegates acceleration-structure builds to the Vulkan driver
// (src/context.rs:824-911, PREFER_FAST_TRACE); this is our native equivalent:
// a C++ binned-SAH builder whose output is consumed by the bundle tracer
// (raytracer2/ops/traverse_bundle.py). Instead of emitting a node tree,
// it cuts the SAH tree into leaves of <= cluster_size triangles, producing a
// triangle permutation + cluster ranges. SAH-guided clusters have much
// tighter AABBs than fixed Morton chunks, which directly cuts the number of
// candidate clusters per ray bundle.
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment).
//
// Built on first use by raytracer2/ops/native.py (libraytracer2_native.so).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const AABB &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Prim {
  AABB box;
  Vec3 centroid;
  int32_t index;
};

constexpr int kBins = 16;

struct BuildCtx {
  std::vector<Prim> prims;
  int cluster_size;
  // outputs
  std::vector<int32_t> order;           // triangle permutation
  std::vector<int32_t> cluster_start;   // per cluster: offset into order
  std::vector<int32_t> cluster_count;   // per cluster: #triangles
};

// Recursive binned-SAH split; ranges of <= cluster_size (or splits that no
// longer pay off at leaf granularity) become clusters.
static void build_range(BuildCtx &ctx, int begin, int end) {
  int n = end - begin;
  if (n <= ctx.cluster_size) {
    ctx.cluster_start.push_back(begin);
    ctx.cluster_count.push_back(n);
    return;
  }

  AABB cbox;  // centroid bounds
  for (int i = begin; i < end; ++i) cbox.grow(ctx.prims[i].centroid);

  // choose axis with the widest centroid extent
  float ext[3] = {cbox.hi.x - cbox.lo.x, cbox.hi.y - cbox.lo.y,
                  cbox.hi.z - cbox.lo.z};
  int axis = 0;
  if (ext[1] > ext[0]) axis = 1;
  if (ext[2] > ext[axis]) axis = 2;
  float lo = axis == 0 ? cbox.lo.x : (axis == 1 ? cbox.lo.y : cbox.lo.z);
  float extent = ext[axis];

  int mid;
  if (extent < 1e-12f) {
    mid = begin + n / 2;  // degenerate spread: median split
  } else {
    AABB bin_box[kBins];
    int bin_cnt[kBins] = {0};
    float scale = kBins / extent;
    auto bin_of = [&](const Prim &p) {
      float c = axis == 0 ? p.centroid.x
                          : (axis == 1 ? p.centroid.y : p.centroid.z);
      int b = static_cast<int>((c - lo) * scale);
      return std::min(std::max(b, 0), kBins - 1);
    };
    for (int i = begin; i < end; ++i) {
      int b = bin_of(ctx.prims[i]);
      bin_box[b].grow(ctx.prims[i].box);
      bin_cnt[b]++;
    }

    // sweep for the best SAH split between bins
    float right_area[kBins];
    AABB acc;
    int right_cnt[kBins];
    int cnt = 0;
    for (int b = kBins - 1; b > 0; --b) {
      acc.grow(bin_box[b]);
      cnt += bin_cnt[b];
      right_area[b] = acc.half_area();
      right_cnt[b] = cnt;
    }
    float best_cost = FLT_MAX;
    int best_split = -1;
    acc = AABB();
    cnt = 0;
    for (int b = 0; b < kBins - 1; ++b) {
      acc.grow(bin_box[b]);
      cnt += bin_cnt[b];
      if (cnt == 0 || right_cnt[b + 1] == 0) continue;
      float cost = acc.half_area() * cnt + right_area[b + 1] * right_cnt[b + 1];
      if (cost < best_cost) {
        best_cost = cost;
        best_split = b;
      }
    }

    if (best_split < 0) {
      mid = begin + n / 2;
      std::nth_element(
          ctx.prims.begin() + begin, ctx.prims.begin() + mid,
          ctx.prims.begin() + end, [&](const Prim &a, const Prim &b) {
            float ca = axis == 0 ? a.centroid.x
                                 : (axis == 1 ? a.centroid.y : a.centroid.z);
            float cb = axis == 0 ? b.centroid.x
                                 : (axis == 1 ? b.centroid.y : b.centroid.z);
            return ca < cb;
          });
    } else {
      auto it = std::partition(
          ctx.prims.begin() + begin, ctx.prims.begin() + end,
          [&](const Prim &p) { return bin_of(p) <= best_split; });
      mid = static_cast<int>(it - ctx.prims.begin());
      if (mid == begin || mid == end) mid = begin + n / 2;
    }
  }

  build_range(ctx, begin, mid);
  build_range(ctx, mid, end);
}

}  // namespace

extern "C" {

// Builds SAH clusters over a triangle soup.
//   v0/e1/e2:      [n*3] float32 triangle data (base, edge1, edge2)
//   n:             triangle count
//   cluster_size:  max triangles per cluster (output stride)
//   out_order:     [n] int32 — triangle permutation (cluster-major)
//   out_offsets:   [max_clusters] int32 — start of each cluster in out_order
//   out_counts:    [max_clusters] int32 — triangles in each cluster
//   max_clusters:  capacity of out_offsets/out_counts (>= ceil(2n/S) is safe)
// Returns the number of clusters, or -1 on capacity overflow.
int rt2_build_sah_clusters(const float *v0, const float *e1, const float *e2,
                           int32_t n, int32_t cluster_size,
                           int32_t *out_order, int32_t *out_offsets,
                           int32_t *out_counts, int32_t max_clusters) {
  if (n <= 0) return 0;
  BuildCtx ctx;
  ctx.cluster_size = std::max<int>(cluster_size, 1);
  ctx.prims.resize(n);
  for (int32_t i = 0; i < n; ++i) {
    Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    Vec3 b{a.x + e1[3 * i], a.y + e1[3 * i + 1], a.z + e1[3 * i + 2]};
    Vec3 c{a.x + e2[3 * i], a.y + e2[3 * i + 1], a.z + e2[3 * i + 2]};
    AABB box;
    box.grow(a);
    box.grow(b);
    box.grow(c);
    ctx.prims[i].box = box;
    ctx.prims[i].centroid = {(box.lo.x + box.hi.x) * 0.5f,
                             (box.lo.y + box.hi.y) * 0.5f,
                             (box.lo.z + box.hi.z) * 0.5f};
    ctx.prims[i].index = i;
  }

  build_range(ctx, 0, n);

  int32_t n_clusters = static_cast<int32_t>(ctx.cluster_start.size());
  if (n_clusters > max_clusters) return -1;
  for (int32_t i = 0; i < n; ++i) out_order[i] = ctx.prims[i].index;
  std::memcpy(out_offsets, ctx.cluster_start.data(),
              n_clusters * sizeof(int32_t));
  std::memcpy(out_counts, ctx.cluster_count.data(),
              n_clusters * sizeof(int32_t));
  return n_clusters;
}

// Version tag so Python can sanity-check the ABI.
int rt2_native_abi_version() { return 1; }

}  // extern "C"
