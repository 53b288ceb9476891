// K-prim (analytic-primitive closest hit and any hit) on Hopper.
//
// Replaces the JAX package's prim test, an XLA program and not Pallas:
// `rpt_tpu/intersect.py:832` (`_prim_best`: `intersect_spheres` :139,
// `intersect_cubes` :159, `intersect_planes` :205, `intersect_monomials`
// :248, merged per prim by `closer` in `_foreach_prim` :128, one device
// `fori_loop` above 8 prims), reached from `closest_hit` (:812),
// `prim_occluded` (:846) and `occluded` (:855). The plain PyTorch version
// is the per-type chain of `rpt_tpu_torch/intersect.py`, which the wrappers
// in `rpt_tpu_torch/ops/prim_hit.py` run for CPU tensors; its twin over
// these rows is `prim_hit_flat_plain` there.
//
// One thread a ray. The block stages the row table (`pack_prims`: 24
// floats a prim, spheres, cubes, planes, monomials in `_prim_best`'s
// order) through shared memory in tiles of kTile rows, every thread
// reading every row, and keeps the running best (t, row) in registers: a
// prim replaces it only where its t is strictly less, so the first prim
// wins a tie, as `closer` does. The monomials' feasibility bound uses the
// best entering their batch (after spheres, cubes and planes), as the JAX
// package's `best` captured by its loop body (:287). The world normal is a
// pure function of (prim, ray, t), so it is computed once, for the winner,
// at the end. The any-hit entry returns best < limit: a lane stops at its
// first prim before its limit (the best can only fall, so the answer is
// that of the full scan), and a lane with limit <= t_min, whose best
// (>= t_min) can never be below it, stops at entry; the block leaves the
// row loop once all its lanes have stopped.
//
// Rounding: every operation is __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn/
// __fsqrt_rn in the plain version's order (Vec3.dot and Mat3.apply sum
// (x + y) + z; Affine.apply_point adds the translation last), so nvcc
// contracts nothing into an FMA that torch rounds twice; normalize is
// x * rsqrtf(max(len^2, 1e-38)), as torch.rsqrt on CUDA; Ray.at is
// (float)((double)o + (double)d * (double)t), one rounding to float32;
// torch.minimum/maximum/clamp propagate NaN, and _slab_interval maps a
// NaN bound to -inf/+inf. x ** 2 is x * x (torch's pow by 2).
//
// What bounds it: operations. A sphere costs ~50 float32 operations a
// pair (the inverse transform, the quadratic, one division pair and a
// square root), a cube ~60, a plane ~25; a monomial's 10 Newton steps and
// 60-step bisection ~2,000, but only for lanes inside its box before the
// best. Rows are read once a block into shared memory, so bytes are the
// rays in and the hits out.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

constexpr int kRow = 24;

struct PrimParams {
    const float* ray[6];      // ox oy oz dx dy dz, lane i at i * stride
    int64_t stride[6];
    const float* rows;        // (n_rows, kRow), 16-byte aligned
    const float* limit;       // any hit: lane i's limit at i * limit_stride
    int64_t limit_stride;
    float* out_t;             // closest hit: (n,)
    float* out_normal;        // closest hit: (3, n)
    int32_t* out_material;    // closest hit: (n,)
    uint8_t* out_hit;         // any hit: (n,)
    int n;
    int counts[4];            // spheres, cubes, planes, monomials
    float t_min;
};

static_assert(offsetof(PrimParams, stride) == 48 && offsetof(PrimParams, rows) == 96 &&
                  offsetof(PrimParams, out_hit) == 144 && offsetof(PrimParams, n) == 152 &&
                  offsetof(PrimParams, t_min) == 172 && sizeof(PrimParams) == 176,
              "PrimParams layout (ops/prim_hit.py _PrimParams)");

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;  // rows a tile: 12 KB of shared memory
constexpr float kOnPlane = 3.814697265625e-06f;  // 32 * FLT_EPSILON
constexpr int kMaterial = 21;
constexpr int kParam = 22;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ bool is_nan(float a) { return a != a; }
// torch.minimum / torch.maximum / torch.clamp(min=): NaN propagates
__device__ __forceinline__ float tmin(float a, float b) {
    return is_nan(a) ? a : (is_nan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
    return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return is_nan(v) ? v : fmaxf(v, lo);
}

struct Vec {
    float x, y, z;
};

struct Ray {
    Vec o, d;
};

__device__ __forceinline__ float dot(const Vec& a, const Vec& b) {
    return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}

__device__ __forceinline__ Vec scale(const Vec& a, float s) {
    return {mul(a.x, s), mul(a.y, s), mul(a.z, s)};
}

__device__ __forceinline__ Vec normalize(const Vec& v) {
    return scale(v, rsqrtf(clamp_min(dot(v, v), 1e-38f)));
}

// Mat3.apply of the row-major matrix at m
__device__ __forceinline__ Vec apply(const float* m, const Vec& v) {
    return {dot({m[0], m[1], m[2]}, v), dot({m[3], m[4], m[5]}, v), dot({m[6], m[7], m[8]}, v)};
}

// Ray.at: one rounding of the exact double product and sum
__device__ __forceinline__ float at(float o, float d, float t) {
    const double dt = __dmul_rn(static_cast<double>(d), static_cast<double>(t));
    return __double2float_rn(__dadd_rn(static_cast<double>(o), dt));
}

__device__ __forceinline__ Vec at(const Ray& r, float t) {
    return {at(r.o.x, r.d.x, t), at(r.o.y, r.d.y, t), at(r.o.z, r.d.z, t)};
}

// Ray.transform by the row's world_to_obj (linear [0:9], translation [9:12])
__device__ __forceinline__ Ray to_local(const float* row, const Ray& r) {
    const Vec lo = apply(row, r.o);
    return {{add(lo.x, row[9]), add(lo.y, row[10]), add(lo.z, row[11])}, apply(row, r.d)};
}

// world normal by the row's normal matrix [12:21]
__device__ __forceinline__ Vec to_world(const float* row, const Vec& local_n) {
    return normalize(apply(row + 12, local_n));
}

// ---- spheres (`intersect_spheres`)

__device__ __forceinline__ float sphere_time(const float* row, const Ray& r, float t_min) {
    const Ray l = to_local(row, r);
    const float a = dot(l.d, l.d);
    const float b = dot(l.d, l.o);
    const float c = sub(dot(l.o, l.o), 1.f);
    const float disc = sub(mul(b, b), mul(a, c));
    const float sq = __fsqrt_rn(clamp_min(disc, 0.f));
    const float t_minus = dvd(sub(-b, sq), a);
    const float t_plus = dvd(add(-b, sq), a);
    const float t = t_minus < t_min ? t_plus : t_minus;
    return (disc >= 0.f && t >= t_min) ? t : inf();
}

__device__ Vec sphere_normal(const float* row, const Ray& r, float t) {
    return to_world(row, normalize(at(to_local(row, r), t)));
}

// ---- cubes (`intersect_cubes`, cube.rs:22-74)

struct Slab {
    float lo, hi, s;
};

__device__ __forceinline__ Slab cube_axis(float o, float d) {
    const float x1 = dvd(sub(-0.5f, o), d);
    const float x2 = dvd(sub(0.5f, o), d);
    return {tmin(x1, x2), tmax(x1, x2), x1 > x2 ? 1.f : -1.f};
}

// The cube's hit time; with `normal`, its local normal (entry or exit face
// with the reference's tie-breaking, cube.rs:40-48).
__device__ __forceinline__ float cube_time(const float* row, const Ray& r, float t_min,
                                           Vec* normal = nullptr) {
    const Ray l = to_local(row, r);
    const Slab x = cube_axis(l.o.x, l.d.x), y = cube_axis(l.o.y, l.d.y),
               z = cube_axis(l.o.z, l.d.z);
    const bool x_first = x.lo > y.lo && x.lo > z.lo;
    const bool y_first = !x_first && y.lo > z.lo;
    const bool z_first = !(x_first || y_first);
    const float start = x_first ? x.lo : (y_first ? y.lo : z.lo);
    const bool x_last = x.hi < y.hi && x.hi < z.hi;
    const bool y_last = !x_last && y.hi < z.hi;
    const bool z_last = !(x_last || y_last);
    const float end = x_last ? x.hi : (y_last ? y.hi : z.hi);
    const bool inside = start < t_min;
    if (normal) {
        *normal = inside ? Vec{x_last ? -x.s : 0.f, y_last ? -y.s : 0.f, z_last ? -z.s : 0.f}
                         : Vec{x_first ? x.s : 0.f, y_first ? y.s : 0.f, z_first ? z.s : 0.f};
    }
    return (start <= end && end >= t_min) ? (inside ? end : start) : inf();
}

__device__ Vec cube_normal(const float* row, const Ray& r, float t_min) {
    Vec local_n;
    cube_time(row, r, t_min, &local_n);
    return to_world(row, local_n);
}

// ---- planes (`intersect_planes`, with the f32 on-plane guard)

__device__ __forceinline__ float plane_time(const float* row, const Ray& r, float t_min) {
    const Vec n = {row[0], row[1], row[2]};
    const float value = row[3];
    const float cosine = dot(n, r.d);
    const float num = sub(value, dot(n, r.o));
    const float t = dvd(num, cosine);
    const float n_l1 = add(add(fabsf(n.x), fabsf(n.y)), fabsf(n.z));
    const float o_l1 = add(add(fabsf(r.o.x), fabsf(r.o.y)), fabsf(r.o.z));
    const float scale_ = add(mul(n_l1, o_l1), fabsf(value));
    const bool on_plane = fabsf(num) <= mul(kOnPlane, scale_);
    return (fabsf(cosine) >= 1e-8f && t >= t_min && !on_plane) ? t : inf();
}

__device__ Vec plane_normal(const float* row, const Ray& r) {
    const Vec n = {row[0], row[1], row[2]};
    const float cosine = dot(n, r.d);
    const float sign = cosine > 0.f ? 1.f : (cosine < 0.f ? -1.f : 0.f);
    const Vec u = normalize(n);
    return {mul(-u.x, sign), mul(-u.y, sign), mul(-u.z, sign)};
}

// ---- monomial surfaces y = h (x^2 + z^2)^2 (`intersect_monomials`)

struct Monomial {
    Ray l;
    float h, coef1, coef2, a, p;  // a = 2 coef0 coef1, p = coef1^2 + 2 coef0 coef2

    __device__ Monomial(const float* row, const Ray& r) : l(to_local(row, r)), h(row[kParam]) {
        const float coef0 = add(mul(l.o.x, l.o.x), mul(l.o.z, l.o.z));
        coef1 = mul(2.f, add(mul(l.o.x, l.d.x), mul(l.o.z, l.d.z)));
        coef2 = add(mul(l.d.x, l.d.x), mul(l.d.z, l.d.z));
        a = mul(mul(2.f, coef0), coef1);
        p = add(mul(coef1, coef1), mul(mul(2.f, coef0), coef2));
    }

    __device__ float dist(float t) const {
        const float x = add(l.o.x, mul(t, l.d.x));
        const float y = add(l.o.y, mul(t, l.d.y));
        const float z = add(l.o.z, mul(t, l.d.z));
        const float s = add(mul(x, x), mul(z, z));
        return sub(y, mul(h, mul(s, s)));
    }

    __device__ float deriv(float t) const {
        const float b = mul(mul(2.f, t), p);
        const float c = mul(mul(mul(mul(mul(3.f, t), t), 2.f), coef1), coef2);
        const float d = mul(mul(mul(mul(mul(4.f, t), t), t), coef2), coef2);
        return sub(l.d.y, mul(h, add(add(add(a, b), c), d)));
    }

    __device__ float deriv2(float t) const {
        const float b = mul(mul(mul(mul(6.f, t), 2.f), coef1), coef2);
        const float c = mul(mul(mul(mul(12.f, t), t), coef2), coef2);
        return mul(-h, add(add(mul(2.f, p), b), c));
    }
};

// `entry` is the best time entering the monomial batch.
__device__ float monomial_time(const float* row, const Ray& r, float t_min, float entry) {
    const Monomial m(row, r);
    const float h = m.h;
    // _aabb_interval against [-1, 0, -1] .. [1, h, 1]
    const float lo_plane[3] = {-1.f, 0.f, -1.f}, hi_plane[3] = {1.f, h, 1.f};
    const float o[3] = {m.l.o.x, m.l.o.y, m.l.o.z}, d[3] = {m.l.d.x, m.l.d.y, m.l.d.z};
    float lo[3], hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float inv = __frcp_rn(d[k]);
        const float t1 = mul(sub(lo_plane[k], o[k]), inv);
        const float t2 = mul(sub(hi_plane[k], o[k]), inv);
        lo[k] = (is_nan(t1) || is_nan(t2)) ? -inf() : fminf(t1, t2);
        hi[k] = (is_nan(t1) || is_nan(t2)) ? inf() : fmaxf(t1, t2);
    }
    const float b_min = fmaxf(lo[0], fmaxf(lo[1], lo[2]));
    const float b_max = fminf(hi[0], fminf(hi[1], hi[2]));
    // an infeasible lane's time is inf whatever the search finds
    if (!(clamp_min(b_min, t_min) <= fminf(b_max, entry))) return inf();

    const bool maximize = m.dist(t_min) < 0.f;
    float t_max = 10000.f;
    if (maximize) {
        // Newton ascent toward the maximum of dist (10 steps, frozen once
        // dist > 0)
        float cur = mul(add(b_min, b_max), 0.5f);
        for (int k = 0; k < 10; ++k) {
            if (m.dist(cur) > 0.f) break;
            cur = sub(cur, dvd(m.deriv(cur), m.deriv2(cur)));
        }
        t_max = cur;
        if (t_max < t_min) return inf();
    }
    if (maximize == (m.dist(t_max) < 0.f)) return inf();
    float left = t_min, right = t_max;
    for (int k = 0; k < 60; ++k) {
        const float mid = mul(add(left, right), 0.5f);
        if ((m.dist(mid) >= 0.f) == maximize) {
            right = mid;
        } else {
            left = mid;
        }
    }
    const float px = at(m.l.o.x, m.l.d.x, right), pz = at(m.l.o.z, m.l.d.z, right);
    return add(mul(px, px), mul(pz, pz)) <= 1.f ? right : inf();
}

__device__ Vec monomial_normal(const float* row, const Ray& r, float t) {
    const Ray l = to_local(row, r);
    const Vec pos = at(l, t);
    const float rad2 = add(mul(pos.x, pos.x), mul(pos.z, pos.z));
    const float h4 = mul(row[kParam], 4.f);
    Vec n = normalize({mul(mul(h4, pos.x), rad2), -1.f, mul(mul(h4, pos.z), rad2)});
    if (dot(n, l.d) > 0.f) n = {-n.x, -n.y, -n.z};
    return to_world(row, n);
}

// ---- the scan

struct Kinds {
    int cubes, planes, monomials, end;  // first row of each kind, and the row count
};

__device__ __forceinline__ Kinds kinds_of(const PrimParams& p) {
    Kinds k;
    k.cubes = p.counts[0];
    k.planes = k.cubes + p.counts[1];
    k.monomials = k.planes + p.counts[2];
    k.end = k.monomials + p.counts[3];
    return k;
}

__device__ __forceinline__ Ray load_ray(const PrimParams& p, int i) {
    return {{p.ray[0][i * p.stride[0]], p.ray[1][i * p.stride[1]], p.ray[2][i * p.stride[2]]},
            {p.ray[3][i * p.stride[3]], p.ray[4][i * p.stride[4]], p.ray[5][i * p.stride[5]]}};
}

// The scan over every row for one lane: the best (t, row), or with
// kAnyHit the scan stopped at the first t < limit. Every thread of the
// block calls it: the tiles are loaded by all and `done` lanes only wait.
template <bool kAnyHit>
__device__ void scan(const PrimParams& p, const Kinds& k, const Ray& r, float limit, bool done,
                     float& best_t, int& best_j) {
    __shared__ float4 tile[kTile * kRow / 4];
    const float4* rows = reinterpret_cast<const float4*>(p.rows);
    const float t_min = p.t_min;
    float entry = best_t;
    for (int base = 0; base < k.end; base += kTile) {
        const int count = min(kTile, k.end - base);
        for (int q = threadIdx.x; q < count * (kRow / 4); q += kThreads)
            tile[q] = __ldg(rows + static_cast<size_t>(base) * (kRow / 4) + q);
        __syncthreads();
        if (!done) {
            for (int s = 0; s < count; ++s) {
                const int j = base + s;
                const float* row = reinterpret_cast<const float*>(tile) + s * kRow;
                float t;
                if (j < k.cubes) {
                    t = sphere_time(row, r, t_min);
                } else if (j < k.planes) {
                    t = cube_time(row, r, t_min);
                } else if (j < k.monomials) {
                    t = plane_time(row, r, t_min);
                } else {
                    if (j == k.monomials) entry = best_t;
                    t = monomial_time(row, r, t_min, entry);
                }
                if (t < best_t) {
                    best_t = t;
                    best_j = j;
                }
                if (kAnyHit && best_t < limit) {
                    done = true;
                    break;
                }
            }
        }
        if (kAnyHit) {
            if (__syncthreads_and(done)) break;
        } else {
            __syncthreads();
        }
    }
}

__global__ void __launch_bounds__(kThreads) prim_closest_hit_kernel(const PrimParams p) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    const bool live = i < p.n;
    const Kinds k = kinds_of(p);
    const Ray r = live ? load_ray(p, i) : Ray{};
    float best_t = inf();
    int best_j = -1;
    scan<false>(p, k, r, 0.f, !live, best_t, best_j);
    if (!live) return;
    Vec normal = {0.f, 0.f, 0.f};
    int material = -1;
    if (best_j >= 0) {
        float row[kRow];
        const float4* src = reinterpret_cast<const float4*>(p.rows) +
                            static_cast<size_t>(best_j) * (kRow / 4);
#pragma unroll
        for (int q = 0; q < kRow / 4; ++q) reinterpret_cast<float4*>(row)[q] = __ldg(src + q);
        if (best_j < k.cubes) {
            normal = sphere_normal(row, r, best_t);
        } else if (best_j < k.planes) {
            normal = cube_normal(row, r, p.t_min);
        } else if (best_j < k.monomials) {
            normal = plane_normal(row, r);
        } else {
            normal = monomial_normal(row, r, best_t);
        }
        material = static_cast<int>(row[kMaterial]);
    }
    p.out_t[i] = best_t;
    p.out_normal[i] = normal.x;
    p.out_normal[static_cast<size_t>(p.n) + i] = normal.y;
    p.out_normal[2 * static_cast<size_t>(p.n) + i] = normal.z;
    p.out_material[i] = material;
}

__global__ void __launch_bounds__(kThreads) prim_any_hit_kernel(const PrimParams p) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    const bool live = i < p.n;
    const Ray r = live ? load_ray(p, i) : Ray{};
    const float limit = live ? p.limit[i * p.limit_stride] : 0.f;
    // a lane whose limit is at or below t_min can hold no hit before it
    const bool done = !live || limit <= p.t_min;
    float best_t = inf();
    int best_j = -1;
    scan<true>(p, kinds_of(p), r, limit, done, best_t, best_j);
    if (live) p.out_hit[i] = best_t < limit;
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int rpt_prim_closest_hit(const PrimParams* params, void* stream) {
    if (params->n <= 0) return 0;
    prim_closest_hit_kernel<<<blocks(params->n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(*params);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_prim_any_hit(const PrimParams* params, void* stream) {
    if (params->n <= 0) return 0;
    prim_any_hit_kernel<<<blocks(params->n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        *params);
    return static_cast<int>(cudaGetLastError());
}
