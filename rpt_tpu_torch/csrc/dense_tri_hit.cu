// K-dense (closest hit and any hit against a small mesh) on Hopper.
//
// Replaces the JAX package's dense triangle test, an XLA program and not
// Pallas: `rpt_tpu/intersect.py:652` (`dense_tri_hit`: every packed leaf
// row of a mesh of at most DENSE_TRI_ROWS = 8 rows broadcast against the
// wavefront, no traversal; `_leaf_rows_test` :376, `_finish_hit` :674),
// reached from `bvh_closest_hit` (:699) and `bvh_any_hit` (:767). The plain
// PyTorch version is `dense_tri_hit_plain` in `rpt_tpu_torch/intersect.py`,
// a chain of torch ops a leaf row then the shading gather, which the
// wrappers in `rpt_tpu_torch/ops/dense_tri_hit.py` run for CPU tensors.
//
// One thread a ray. The block reads the <= 8 leaf rows (80 floats each:
// v1, e1, e2 and the triangle id, component-major over 8 slots) once and
// keeps each triangle's ray-independent values in shared memory: its
// unit normal pn = normalize(e1 x e2) and d00, d01, d11 and denom, which
// the chain also computes once a row. Each thread walks the rows and
// their slots in order and keeps its running best (t, tri, u, v, w) in
// registers: a slot replaces it only where its t is strictly less, so the
// first slot wins a tie, as `torch.min` (the first minimum) within a row
// and the chain's strict `best < time` across rows do. The closest-hit
// entry starts from the incoming best (K-prim's hit) and, for a lane the
// mesh improves, gathers the winner's shade row once: the normal
// ((n1 u + n2 v) + n3 w), normalised, and the material; other lanes keep
// the incoming hit bit for bit. The any-hit entry returns whether some
// triangle lies at t in [t_min, limit): the chain's `time < limit` over a
// best that starts at inf, which holds exactly where some slot passes its
// tests with t < limit, so a lane stops at its first such slot; a lane
// with limit <= t_min, or one `skip` marks (already occluded), tests
// nothing and reads false. Neither entry synchronises inside its loop.
//
// Rounding: every operation is __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn in
// the chain's order (Vec3.dot sums (x + y) + z; Vec3.cross as written;
// p = o + d * t in two roundings; u = (1 - v) - w; the on-plane guard's L1
// scale (((((|o.x| + |o.y|) + |o.z|) + |v1.x|) + |v1.y|) + |v1.z|), so nvcc
// contracts nothing into an FMA that torch rounds twice; normalize is
// x * rsqrtf(max(len^2, 1e-38)), as torch.rsqrt on CUDA (`csrc/prim_hit.cu`
// holds the same rules). A NaN t fails every test and never wins.
//
// What bounds it: bytes, on the wavefronts the paths make. A (ray,
// triangle) pair costs ~60 float32 operations at most (two dot products
// and a division for t, the guard, the barycentrics' two dot products and
// two divisions), and a mesh has at most 64 triangles; the rows are read
// once a block, so the bytes are the rays and the incoming hits in and the
// hits out.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

constexpr int kLeafTris = 8;
constexpr int kLeafRow = 80;
constexpr int kShadeRow = 12;
constexpr int kMaxRows = 8;

struct DenseParams {
    const float* ray[6];           // ox oy oz dx dy dz, lane i at i * stride
    int64_t stride[6];
    const float* leaves;           // (rows, kLeafRow)
    const float* shade;            // (triangles, kShadeRow)
    const float* best_t;           // closest hit: the incoming hit, lane i at
    const float* best_normal[3];   //   i * best_stride[k] (time, normal x y z,
    const int32_t* best_material;  //   material)
    int64_t best_stride[5];
    const float* limit;            // any hit: lane i's limit at i * limit_stride
    int64_t limit_stride;
    const uint8_t* skip;           // any hit: lanes already occluded, or null
    int64_t skip_stride;
    float* out_t;                  // closest hit: (n,)
    float* out_normal;             // closest hit: (3, n)
    int32_t* out_material;         // closest hit: (n,)
    uint8_t* out_hit;              // any hit: (n,)
    int n;
    int rows;                      // 0 .. kMaxRows
    float t_min;
};

static_assert(offsetof(DenseParams, stride) == 48 && offsetof(DenseParams, leaves) == 96 &&
                  offsetof(DenseParams, best_t) == 112 &&
                  offsetof(DenseParams, best_stride) == 152 &&
                  offsetof(DenseParams, limit) == 192 && offsetof(DenseParams, skip) == 208 &&
                  offsetof(DenseParams, out_t) == 224 && offsetof(DenseParams, out_hit) == 248 &&
                  offsetof(DenseParams, n) == 256 && offsetof(DenseParams, rows) == 260 &&
                  offsetof(DenseParams, t_min) == 264 && sizeof(DenseParams) == 272,
              "DenseParams layout (ops/dense_tri_hit.py _DenseParams)");

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTris = kMaxRows * kLeafTris;
constexpr float kOnPlane = 3.814697265625e-06f;  // 32 * FLT_EPSILON

static_assert(kMaxTris <= kThreads, "one thread a triangle prepares the table");

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// torch.clamp(min=): NaN propagates
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return v != v ? v : fmaxf(v, lo);
}

struct Vec {
    float x, y, z;
};

__device__ __forceinline__ float dot(const Vec& a, const Vec& b) {
    return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}

__device__ __forceinline__ Vec cross(const Vec& a, const Vec& b) {
    return {sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
            sub(mul(a.x, b.y), mul(a.y, b.x))};
}

__device__ __forceinline__ Vec normalize(const Vec& v) {
    const float inv = rsqrtf(clamp_min(dot(v, v), 1e-38f));
    return {mul(v.x, inv), mul(v.y, inv), mul(v.z, inv)};
}

// A triangle's slot and what the chain computes once a row
struct Tri {
    Vec v1, e1, e2, pn;
    float d00, d01, d11, denom;
    int id;
};

// Every thread of the block calls it: one thread a slot fills the table.
__device__ __forceinline__ void load_tris(const DenseParams& p, Tri* tris) {
    const int k = threadIdx.x;
    if (k < p.rows * kLeafTris) {
        const float* leaf = p.leaves + static_cast<size_t>(k / kLeafTris) * kLeafRow;
        const int s = k % kLeafTris;
        auto comp = [&](int c) { return __ldg(leaf + c * kLeafTris + s); };
        Tri t;
        t.v1 = {comp(0), comp(1), comp(2)};
        t.e1 = {comp(3), comp(4), comp(5)};
        t.e2 = {comp(6), comp(7), comp(8)};
        t.id = static_cast<int>(comp(9));
        t.pn = normalize(cross(t.e1, t.e2));
        t.d00 = dot(t.e1, t.e1);
        t.d01 = dot(t.e1, t.e2);
        t.d11 = dot(t.e2, t.e2);
        t.denom = sub(mul(t.d00, t.d11), mul(t.d01, t.d01));
        tris[k] = t;
    }
    __syncthreads();
}

struct Ray {
    Vec o, d;
    float o_l1;  // (|o.x| + |o.y|) + |o.z|, the ray's part of the on-plane scale
};

__device__ __forceinline__ Ray load_ray(const DenseParams& p, int i) {
    Ray r;
    r.o = {p.ray[0][i * p.stride[0]], p.ray[1][i * p.stride[1]], p.ray[2][i * p.stride[2]]};
    r.d = {p.ray[3][i * p.stride[3]], p.ray[4][i * p.stride[4]], p.ray[5][i * p.stride[5]]};
    r.o_l1 = add(add(fabsf(r.o.x), fabsf(r.o.y)), fabsf(r.o.z));
    return r;
}

// `_leaf_rows_test` for one (ray, slot): true where the slot is a triangle
// hit at t in [t_min, bound), with its t and barycentrics.
__device__ __forceinline__ bool slot_hit(const Tri& tri, const Ray& r, float t_min, float bound,
                                         float& t, float& u, float& v, float& w) {
    if (tri.id < 0) return false;
    const float cosine = dot(tri.pn, r.d);
    const float num = dot(tri.pn, {sub(tri.v1.x, r.o.x), sub(tri.v1.y, r.o.y),
                                   sub(tri.v1.z, r.o.z)});
    t = dvd(num, cosine);
    if (!(fabsf(cosine) >= 1e-8f && t >= t_min && t < bound)) return false;
    // `_origin_on_plane`: the origin within float32 rounding of the plane
    const float scale_ = add(add(add(r.o_l1, fabsf(tri.v1.x)), fabsf(tri.v1.y)),
                             fabsf(tri.v1.z));
    if (fabsf(num) <= mul(kOnPlane, scale_)) return false;
    const Vec d2 = {sub(add(r.o.x, mul(r.d.x, t)), tri.v1.x),
                    sub(add(r.o.y, mul(r.d.y, t)), tri.v1.y),
                    sub(add(r.o.z, mul(r.d.z, t)), tri.v1.z)};
    const float d20 = dot(d2, tri.e1);
    const float d21 = dot(d2, tri.e2);
    v = dvd(sub(mul(tri.d11, d20), mul(tri.d01, d21)), tri.denom);
    w = dvd(sub(mul(tri.d00, d21), mul(tri.d01, d20)), tri.denom);
    u = sub(sub(1.f, v), w);
    return u >= 0.f && v >= 0.f && w >= 0.f;
}

__global__ void __launch_bounds__(kThreads) dense_closest_hit_kernel(const DenseParams p) {
    __shared__ Tri tris[kMaxTris];
    load_tris(p, tris);
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= p.n) return;
    const Ray r = load_ray(p, i);
    const float best_in = p.best_t[i * p.best_stride[0]];
    float best = best_in, bu = 0.f, bv = 0.f, bw = 0.f;
    int best_tri = -1;
    const int count = p.rows * kLeafTris;
    for (int k = 0; k < count; ++k) {
        float t, u, v, w;
        if (slot_hit(tris[k], r, p.t_min, best, t, u, v, w)) {
            best = t;
            best_tri = tris[k].id;
            bu = u;
            bv = v;
            bw = w;
        }
    }
    const size_t n = static_cast<size_t>(p.n);
    if (best_tri < 0) {  // `_finish_hit`: the incoming hit, untouched
        p.out_t[i] = best_in;
        for (int c = 0; c < 3; ++c)
            p.out_normal[c * n + i] = p.best_normal[c][i * p.best_stride[1 + c]];
        p.out_material[i] = p.best_material[i * p.best_stride[4]];
        return;
    }
    const float* s = p.shade + static_cast<size_t>(best_tri) * kShadeRow;
    Vec nrm;
    nrm.x = add(add(mul(__ldg(s + 0), bu), mul(__ldg(s + 3), bv)), mul(__ldg(s + 6), bw));
    nrm.y = add(add(mul(__ldg(s + 1), bu), mul(__ldg(s + 4), bv)), mul(__ldg(s + 7), bw));
    nrm.z = add(add(mul(__ldg(s + 2), bu), mul(__ldg(s + 5), bv)), mul(__ldg(s + 8), bw));
    nrm = normalize(nrm);
    p.out_t[i] = best;
    p.out_normal[i] = nrm.x;
    p.out_normal[n + i] = nrm.y;
    p.out_normal[2 * n + i] = nrm.z;
    p.out_material[i] = static_cast<int>(__ldg(s + 9));
}

__global__ void __launch_bounds__(kThreads) dense_any_hit_kernel(const DenseParams p) {
    __shared__ Tri tris[kMaxTris];
    load_tris(p, tris);
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= p.n) return;
    const float limit = p.limit[i * p.limit_stride];
    bool hit = false;
    // a lane whose limit is at or below t_min can hold no hit before it
    if (!(p.skip && p.skip[i * p.skip_stride]) && !(limit <= p.t_min)) {
        const Ray r = load_ray(p, i);
        const int count = p.rows * kLeafTris;
        for (int k = 0; k < count && !hit; ++k) {
            float t, u, v, w;
            hit = slot_hit(tris[k], r, p.t_min, limit, t, u, v, w);
        }
    }
    p.out_hit[i] = hit;
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

bool valid(const DenseParams* params) {
    return params->n > 0 && params->rows >= 0 && params->rows <= kMaxRows;
}

}  // namespace

extern "C" int rpt_dense_closest_hit(const DenseParams* params, void* stream) {
    if (!valid(params)) return params->n > 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
    dense_closest_hit_kernel<<<blocks(params->n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(*params);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_dense_any_hit(const DenseParams* params, void* stream) {
    if (!valid(params)) return params->n > 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
    dense_any_hit_kernel<<<blocks(params->n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        *params);
    return static_cast<int>(cudaGetLastError());
}
