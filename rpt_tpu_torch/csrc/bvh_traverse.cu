// K1 (mesh closest hit) and K2 (mesh any hit) on Hopper.
//
// Replaces the JAX package's mesh traversals, which are XLA programs and
// not Pallas: `rpt_tpu/intersect.py::_traverse` (:457, the exact spec),
// reached from `bvh_closest_hit` (:699) and `bvh_any_hit` (:767), and the
// TPU engines whose results it reproduces, `rpt_tpu/tiled.py:211`
// (`tiled_traverse`) and `rpt_tpu/deferred.py:612` (`deferred_traverse`).
// The plain PyTorch version is `rpt_tpu_torch/intersect.py::_traverse`,
// which the wrappers in `rpt_tpu_torch/ops/bvh_traverse.py` run for CPU
// tensors.
//
// Per ray it computes what `_traverse` computes, lane for lane: ordered
// short-stack descent over `pack_bvh`'s pair-packed node rows (16 floats:
// [Lmin.xyz Rmin.xyz | Lmax.xyz Rmax.xyz | Lptr Rptr Lmeta Rmeta]; meta 0
// = internal child, > 0 = leaf child with that many triangles, < 0 =
// empty) and 8-slot component-major leaf rows (80 floats: v1.x*8 v1.y*8
// v1.z*8 e1.x*8 ... e2.z*8 id*8). One step tests both children's boxes
// against cutoff = min(time, limit), tests the hit leaf children (left,
// then right; within a leaf the first slot of least t wins), descends into
// the nearer hit internal child and pushes the other, or pops. K1 returns
// (t, tri, u, v, w) of the nearest hit before min(best_time, limit); K2
// returns whether any hit lies before limit, retiring a lane after the
// step that finds one. A lane with limit <= t_min or active == 0 never
// enters.
//
// Rounding: the slab test, the plane and the barycentric terms use
// __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn, operation for operation in the
// plain version's order, so nvcc contracts nothing into an FMA that torch
// rounds twice; the normal's rsqrt is rsqrtf, as torch.rsqrt on CUDA. A
// NaN slab bound (0 * inf, an origin on a slab plane) maps to -inf/+inf as
// the plain version's isnan test does; fminf/fmaxf alone would drop it.
//
// What bounds it: dependent gathers. Each step reads one 64-byte node row
// and up to two 320-byte leaf rows whose addresses depend on the previous
// step, and lanes of a warp diverge in depth and order. The 872,520-
// triangle dragon stand-in packs into 144,353 node rows (9.2 MB, in the
// 50 MB L2), 144,354 leaf rows (46 MB, nearly) and a 42 MB shade table
// that only `_finish_hit` reads. The design: one thread per ray (the dragon's 262,144-lane
// wavefronts fill 132 SMs many times over), node rows read as four 16-byte
// loads through the read-only path, the stack in local memory. Wide BVHs,
// ray sorting and persistent warps are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 64;  // the wrappers refuse trees whose stack bound exceeds it
constexpr int kSlots = 8;
constexpr int kNodeRow = 16;
constexpr int kLeafRow = 80;
constexpr float kOnPlane = 3.814697265625e-06f;  // 32 * FLT_EPSILON

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// (a.x*b.x + a.y*b.y) + a.z*b.z, as Vec3.dot
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
    return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

struct Ray {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

struct Best {
    float t;
    int tri;
    float u, v, w;
};

// The first `count` slots of one leaf row, as `_leaf_rows_test`. A slot
// must beat the running best strictly, so the first slot of least t wins.
__device__ void leaf_test(const float* __restrict__ leaf, int count, const Ray& r, float t_min,
                          Best& b) {
    for (int s = 0; s < count; ++s) {
        const int id = static_cast<int>(__ldg(leaf + 9 * kSlots + s));
        if (id < 0) continue;
        const float v1x = __ldg(leaf + s), v1y = __ldg(leaf + kSlots + s),
                    v1z = __ldg(leaf + 2 * kSlots + s);
        const float e1x = __ldg(leaf + 3 * kSlots + s), e1y = __ldg(leaf + 4 * kSlots + s),
                    e1z = __ldg(leaf + 5 * kSlots + s);
        const float e2x = __ldg(leaf + 6 * kSlots + s), e2y = __ldg(leaf + 7 * kSlots + s),
                    e2z = __ldg(leaf + 8 * kSlots + s);
        // pn = normalize(e1 x e2)
        const float cx = sub(mul(e1y, e2z), mul(e1z, e2y));
        const float cy = sub(mul(e1z, e2x), mul(e1x, e2z));
        const float cz = sub(mul(e1x, e2y), mul(e1y, e2x));
        const float len2 = dot3(cx, cy, cz, cx, cy, cz);
        const float inv = rsqrtf(len2 != len2 ? len2 : fmaxf(len2, 1e-38f));
        const float px = mul(cx, inv), py = mul(cy, inv), pz = mul(cz, inv);
        const float cosine = dot3(px, py, pz, r.dx, r.dy, r.dz);
        const float num = dot3(px, py, pz, sub(v1x, r.ox), sub(v1y, r.oy), sub(v1z, r.oz));
        const float t = dvd(num, cosine);
        // _origin_on_plane: |num| within f32 rounding of the points' scale
        const float scale = add(add(add(add(add(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz)),
                                        fabsf(v1x)), fabsf(v1y)), fabsf(v1z));
        const bool on_plane = fabsf(num) <= mul(kOnPlane, scale);
        if (!(fabsf(cosine) >= 1e-8f) || on_plane || !(t >= t_min) || !(t < b.t)) continue;
        // barycentrics of p = o + d t
        const float qx = sub(add(r.ox, mul(r.dx, t)), v1x);
        const float qy = sub(add(r.oy, mul(r.dy, t)), v1y);
        const float qz = sub(add(r.oz, mul(r.dz, t)), v1z);
        const float d00 = dot3(e1x, e1y, e1z, e1x, e1y, e1z);
        const float d01 = dot3(e1x, e1y, e1z, e2x, e2y, e2z);
        const float d11 = dot3(e2x, e2y, e2z, e2x, e2y, e2z);
        const float d20 = dot3(qx, qy, qz, e1x, e1y, e1z);
        const float d21 = dot3(qx, qy, qz, e2x, e2y, e2z);
        const float denom = sub(mul(d00, d11), mul(d01, d01));
        const float v = dvd(sub(mul(d11, d20), mul(d01, d21)), denom);
        const float w = dvd(sub(mul(d00, d21), mul(d01, d20)), denom);
        const float u = sub(sub(1.f, v), w);
        if (u >= 0.f && v >= 0.f && w >= 0.f) {
            b.t = t;
            b.tri = id;
            b.u = u;
            b.v = v;
            b.w = w;
        }
    }
}

// Slab interval bound of one axis: NaN (0 * inf) does not constrain.
__device__ __forceinline__ void slab(float lo_plane, float hi_plane, float o, float inv,
                                     float& enter, float& exit_) {
    const float t1 = mul(sub(lo_plane, o), inv);
    const float t2 = mul(sub(hi_plane, o), inv);
    const bool nan = (t1 != t1) || (t2 != t2);
    enter = fmaxf(enter, nan ? -inf() : fminf(t1, t2));
    exit_ = fminf(exit_, nan ? inf() : fmaxf(t1, t2));
}

template <bool kAnyHit>
__device__ Best traverse(const float* __restrict__ nodes, const float* __restrict__ leaves,
                         const Ray& r, float t_min, float limit, Best b) {
    int stack[kStack];
    int sp = 0;
    int cur = 0;
    while (cur >= 0) {
        const float4* row = reinterpret_cast<const float4*>(nodes + static_cast<size_t>(cur) *
                                                                        kNodeRow);
        const float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2),
                     q3 = __ldg(row + 3);
        // q0 = Lmin.xyz Rmin.x | q1 = Rmin.yz Lmax.xy | q2 = Lmax.z Rmax.xyz
        float l_enter = -inf(), l_exit = inf(), r_enter = -inf(), r_exit = inf();
        slab(q0.x, q1.z, r.ox, r.ix, l_enter, l_exit);
        slab(q0.y, q1.w, r.oy, r.iy, l_enter, l_exit);
        slab(q0.z, q2.x, r.oz, r.iz, l_enter, l_exit);
        slab(q0.w, q2.y, r.ox, r.ix, r_enter, r_exit);
        slab(q1.x, q2.z, r.oy, r.iy, r_enter, r_exit);
        slab(q1.y, q2.w, r.oz, r.iz, r_enter, r_exit);
        const int lptr = static_cast<int>(q3.x), rptr = static_cast<int>(q3.y);
        const int lmeta = static_cast<int>(q3.z), rmeta = static_cast<int>(q3.w);
        const float cutoff = fminf(b.t, limit);
        const bool l_hit = l_enter <= l_exit && l_exit >= t_min && l_enter <= cutoff && lmeta >= 0;
        const bool r_hit = r_enter <= r_exit && r_exit >= t_min && r_enter <= cutoff && rmeta >= 0;

        if (l_hit && lmeta > 0)
            leaf_test(leaves + static_cast<size_t>(lptr) * kLeafRow, lmeta, r, t_min, b);
        if (r_hit && rmeta > 0)
            leaf_test(leaves + static_cast<size_t>(rptr) * kLeafRow, rmeta, r, t_min, b);
        if (kAnyHit && b.t < limit) break;

        const bool want_l = l_hit && lmeta == 0;
        const bool want_r = r_hit && rmeta == 0;
        if (want_l || want_r) {
            const bool l_near = l_enter <= r_enter;
            if (want_l && want_r) {
                if (sp >= kStack) __trap();  // impossible: the wrapper bounds the tree depth
                stack[sp++] = l_near ? rptr : lptr;
            }
            cur = (want_l && (!want_r || l_near)) ? lptr : rptr;
        } else {
            cur = sp > 0 ? stack[--sp] : -1;
        }
    }
    return b;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        int i) {
    Ray r;
    r.ox = o[3 * i];
    r.oy = o[3 * i + 1];
    r.oz = o[3 * i + 2];
    r.dx = d[3 * i];
    r.dy = d[3 * i + 1];
    r.dz = d[3 * i + 2];
    r.ix = __frcp_rn(r.dx);
    r.iy = __frcp_rn(r.dy);
    r.iz = __frcp_rn(r.dz);
    return r;
}

__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d, int n,
                   const float* __restrict__ nodes, const float* __restrict__ leaves, float t_min,
                   const float* __restrict__ limit, const float* __restrict__ best_time,
                   const uint8_t* __restrict__ active, float* __restrict__ out_t,
                   int* __restrict__ out_tri, float* __restrict__ out_u, float* __restrict__ out_v,
                   float* __restrict__ out_w) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    Best b{best_time[i], -1, 0.f, 0.f, 0.f};
    const float lim = limit ? limit[i] : inf();
    if (lim > t_min && (!active || active[i]))
        b = traverse<false>(nodes, leaves, load_ray(o, d, i), t_min, lim, b);
    out_t[i] = b.t;
    out_tri[i] = b.tri;
    out_u[i] = b.u;
    out_v[i] = b.v;
    out_w[i] = b.w;
}

__global__ void __launch_bounds__(kThreads)
any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d, int n,
               const float* __restrict__ nodes, const float* __restrict__ leaves, float t_min,
               const float* __restrict__ limit, const uint8_t* __restrict__ active,
               uint8_t* __restrict__ out_hit) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const float lim = limit[i];
    bool hit = false;
    if (lim > t_min && (!active || active[i])) {
        const Best b = traverse<true>(nodes, leaves, load_ray(o, d, i), t_min, lim,
                                      Best{inf(), -1, 0.f, 0.f, 0.f});
        hit = b.t < lim;
    }
    out_hit[i] = hit;
}

}  // namespace

extern "C" int rpt_bvh_closest_hit(const float* o, const float* d, int n, const float* nodes,
                                   const float* leaves, float t_min, const float* limit,
                                   const float* best_time, const uint8_t* active, float* out_t,
                                   int* out_tri, float* out_u, float* out_v, float* out_w,
                                   void* stream) {
    if (n == 0) return 0;
    closest_hit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        o, d, n, nodes, leaves, t_min, limit, best_time, active, out_t, out_tri, out_u, out_v,
        out_w);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_bvh_any_hit(const float* o, const float* d, int n, const float* nodes,
                               const float* leaves, float t_min, const float* limit,
                               const uint8_t* active, uint8_t* out_hit, void* stream) {
    if (n == 0) return 0;
    any_hit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(o, d, n, nodes, leaves, t_min, limit,
                                                          active, out_hit);
    return static_cast<int>(cudaGetLastError());
}
