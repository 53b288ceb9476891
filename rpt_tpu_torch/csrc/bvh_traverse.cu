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
// enters. A ray's result depends on nothing but the ray, so the order in
// which rays are taken up changes no output.
//
// Rounding: the slab test, the plane and the barycentric terms use
// __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn, operation for operation in the
// plain version's order, so nvcc contracts nothing into an FMA that torch
// rounds twice; the normal's rsqrt is rsqrtf, as torch.rsqrt on CUDA. A
// NaN slab bound (0 * inf, an origin on a slab plane) maps to -inf/+inf as
// the plain version's isnan test does; fminf/fmaxf alone would drop it.
//
// What bounds it: dependent gathers, hidden by threads in flight. Each
// step reads one 64-byte node row and up to two 320-byte leaf rows whose
// addresses depend on the previous step. The 872,520-triangle dragon
// stand-in packs into 144,353 node rows (9.2 MB, in the 50 MB L2), 144,354
// leaf rows (46 MB, nearly) and a 42 MB shade table that only
// `_finish_hit` reads. Measured on the dragon's wavefronts with the
// counting variant and with variants of this kernel: on the level-1
// bounce wavefront a warp's lanes hold a live ray in only 37% of its
// steps, yet persistent warps that refill their idle lanes from a queue
// (61% live) were no faster, a shared-memory stack and 16-byte leaf reads
// (40 more registers) were slower, and rays in any other order than the
// camera's Morton pixel order were slower: what counts is how many rays
// are in flight, so the kernel keeps one ray a thread (48-55 registers)
// with the stack in local memory, which the L1 caches; holding it to 48
// registers at ten blocks an SM gained 1% on camera rays and lost 2-4% on
// bounce rays. What does pay is packing the lanes that enter: where a
// wavefront is gated (a limit or a mask, as every shadow query has), a
// block whose warps are not all full or empty first packs its entering
// lanes, in lane order, into the front of its threads, so its warps are
// full or empty instead of sparse; lanes that never enter get their
// result at once. Results are written by the
// ray's own lane index.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStack = 64;  // the wrappers refuse trees whose stack bound exceeds it
constexpr int kNodeRow = 16;
constexpr int kLeafRow = 80;
constexpr unsigned kFull = 0xffffffffu;
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

// The per-lane inputs of a wavefront.
struct Lanes {
    const float* o;
    const float* d;
    int n;
    float t_min;
    const float* limit;      // null: no limit (K1)
    const float* best_time;  // null for K2
    const uint8_t* active;   // null: every lane
};

// Where the results go: K1 writes t, tri, u, v, w; K2 writes hit.
struct Out {
    float* t;
    int* tri;
    float* u;
    float* v;
    float* w;
    uint8_t* hit;
};

// One slot of a leaf row, as `_leaf_rows_test`. A slot must beat the
// running best strictly, so the first slot of least t wins.
__device__ __forceinline__ void slot_test(float v1x, float v1y, float v1z, float e1x, float e1y,
                                          float e1z, float e2x, float e2y, float e2z, int id,
                                          const Ray& r, float t_min, Best& b) {
    if (id < 0) return;
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
    if (!(fabsf(cosine) >= 1e-8f) || on_plane || !(t >= t_min) || !(t < b.t)) return;
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

// The first `count` slots of one leaf row, in order.
__device__ void leaf_test(const float* __restrict__ leaf, int count, const Ray& r, float t_min,
                          Best& b) {
    for (int s = 0; s < count; ++s)
        slot_test(__ldg(leaf + s), __ldg(leaf + 8 + s), __ldg(leaf + 16 + s), __ldg(leaf + 24 + s),
                  __ldg(leaf + 32 + s), __ldg(leaf + 40 + s), __ldg(leaf + 48 + s),
                  __ldg(leaf + 56 + s), __ldg(leaf + 64 + s),
                  static_cast<int>(__ldg(leaf + 72 + s)), r, t_min, b);
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

// `_traverse` for one ray: (steps, leaf slots tested) go to `counted` in
// the counting variant.
template <bool kAnyHit, bool kCount>
__device__ Best traverse(const float* __restrict__ nodes, const float* __restrict__ leaves,
                         const Ray& r, float t_min, float limit, Best b, int2& counted) {
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
        if (kCount) ++counted.x;

        if (l_hit && lmeta > 0) {
            leaf_test(leaves + static_cast<size_t>(lptr) * kLeafRow, lmeta, r, t_min, b);
            if (kCount) counted.y += lmeta;
        }
        if (r_hit && rmeta > 0) {
            leaf_test(leaves + static_cast<size_t>(rptr) * kLeafRow, rmeta, r, t_min, b);
            if (kCount) counted.y += rmeta;
        }
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

template <bool kAnyHit>
__device__ __forceinline__ void write_result(const Out& out, int i, const Best& b, float limit) {
    if (kAnyHit) {
        out.hit[i] = b.t < limit;
    } else {
        out.t[i] = b.t;
        out.tri[i] = b.tri;
        out.u[i] = b.u;
        out.v[i] = b.v;
        out.w[i] = b.w;
    }
}

// A block takes 128 consecutive lanes of the wavefront, a ray a thread.
// With kGated (the call has a limit or a mask) the lanes that never enter
// get their result at once and the others are packed, in lane order, into
// the block's first threads. With kCount, ray_counts gets (steps, leaf
// slots tested) per lane, and warp_counts the sums over all warps of the
// steps their rays took and of 32 x the steps of their longest ray (what
// a warp in lockstep spends).
template <bool kAnyHit, bool kGated, bool kCount>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(Lanes in, const float* __restrict__ nodes, const float* __restrict__ leaves,
                Out out, int2* __restrict__ ray_counts,
                unsigned long long* __restrict__ warp_counts) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int i = blockIdx.x * kThreads + tid;  // the lane this thread looks at, then the ray it takes
    if (i >= in.n) i = -1;
    if (kGated) {
        __shared__ int s_list[kThreads];
        __shared__ int s_warp[kWarps];
        bool enter = false;
        if (i >= 0) {
            const float lim = in.limit ? in.limit[i] : inf();
            enter = lim > in.t_min && (!in.active || in.active[i]);
            if (!enter)
                write_result<kAnyHit>(
                    out, i, Best{kAnyHit ? inf() : in.best_time[i], -1, 0.f, 0.f, 0.f}, lim);
        }
        const unsigned entering = __ballot_sync(kFull, enter);
        if (lane == 0) s_warp[warp] = __popc(entering);
        // pack only where some warp is neither full nor empty
        if (__syncthreads_or(entering != 0 && entering != kFull)) {
            int before = 0, count = 0;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
                before += w < warp ? s_warp[w] : 0;
                count += s_warp[w];
            }
            if (enter) s_list[before + __popc(entering & ((1u << lane) - 1))] = i;
            __syncthreads();
            i = tid < count ? s_list[tid] : -1;
        } else if (!enter) {
            i = -1;
        }
    }
    int2 counted = make_int2(0, 0);
    if (i >= 0) {
        const float lim = in.limit ? in.limit[i] : inf();
        const Best b = traverse<kAnyHit, kCount>(
            nodes, leaves, load_ray(in.o, in.d, i), in.t_min, lim,
            Best{kAnyHit ? inf() : in.best_time[i], -1, 0.f, 0.f, 0.f}, counted);
        write_result<kAnyHit>(out, i, b, lim);
        if (kCount) ray_counts[i] = counted;
    }
    if (kCount) {
        int sum = counted.x, longest = counted.x;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            sum += __shfl_xor_sync(kFull, sum, o);
            longest = max(longest, __shfl_xor_sync(kFull, longest, o));
        }
        if (lane == 0) {
            atomicAdd(warp_counts, static_cast<unsigned long long>(sum));
            atomicAdd(warp_counts + 1, 32ull * longest);
        }
    }
}

template <bool kAnyHit, bool kCount>
int run(const Lanes& in, const float* nodes, const float* leaves, const Out& out, int* ray_counts,
        unsigned long long* warp_counts, cudaStream_t st) {
    if (in.n == 0) return 0;
    const int blocks = (in.n + kThreads - 1) / kThreads;
    int2* counts = reinterpret_cast<int2*>(ray_counts);
    if (in.limit || in.active)
        traverse_kernel<kAnyHit, true, kCount><<<blocks, kThreads, 0, st>>>(
            in, nodes, leaves, out, counts, warp_counts);
    else
        traverse_kernel<kAnyHit, false, kCount><<<blocks, kThreads, 0, st>>>(
            in, nodes, leaves, out, counts, warp_counts);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ray_counts and warp_counts: null, or (n, 2) int32 zeroed and (2) int64
// zeroed for the counting variant.
extern "C" int rpt_bvh_closest_hit(const float* o, const float* d, int n, const float* nodes,
                                   const float* leaves, float t_min, const float* limit,
                                   const float* best_time, const uint8_t* active, float* out_t,
                                   int* out_tri, float* out_u, float* out_v, float* out_w,
                                   int* ray_counts, unsigned long long* warp_counts,
                                   void* stream) {
    const Lanes in{o, d, n, t_min, limit, best_time, active};
    const Out out{out_t, out_tri, out_u, out_v, out_w, nullptr};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return ray_counts ? run<false, true>(in, nodes, leaves, out, ray_counts, warp_counts, st)
                      : run<false, false>(in, nodes, leaves, out, nullptr, nullptr, st);
}

extern "C" int rpt_bvh_any_hit(const float* o, const float* d, int n, const float* nodes,
                               const float* leaves, float t_min, const float* limit,
                               const uint8_t* active, uint8_t* out_hit, int* ray_counts,
                               unsigned long long* warp_counts, void* stream) {
    const Lanes in{o, d, n, t_min, limit, nullptr, active};
    const Out out{nullptr, nullptr, nullptr, nullptr, nullptr, out_hit};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return ray_counts ? run<true, true>(in, nodes, leaves, out, ray_counts, warp_counts, st)
                      : run<true, false>(in, nodes, leaves, out, nullptr, nullptr, st);
}
