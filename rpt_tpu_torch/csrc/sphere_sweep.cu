// K-sweep: beam-query x point-photon sphere sweep on Hopper.
//
// Replaces the Pallas kernel `rpt_tpu/ops/sphere_sweep.py::sphere_sweep`
// (pallas_call at :111). For every camera ray it sums, over every photon
// sphere the ray pierces before its surface hit (dd > 0, dist2 < r^2,
// sqrt(oc2) <= hit_t, rad > 0),
//     (3/pi) (1 - d^2/r^2)^2 / r^2 * exp(-ext * dd) * phase_const * power
// and multiplies by the medium colour. The plain PyTorch version is
// `rpt_tpu_torch/ops/sphere_sweep.py::sphere_sweep_plain`.
//
// What bounds it: instructions. The TPU kernel tests every (ray, sphere)
// pair, because its grid runs in order over fixed blocks; at 16,384 rays x
// ~2M spheres that is 3.2e10 pair tests a call, ~20 FP32 operations each,
// while the bytes (the sphere table, read once) take microseconds. A ray
// pierces well under 1% of the spheres. So the design does fewer pair
// tests, and fewer instructions per test:
//
// - The table (`build_sphere_table`, once per photon map): spheres in
//   3-D Morton order of their centres, so that a tile of kTile = 256
//   consecutive spheres is spatially compact; each a 32-byte record
//   (px, py, pz, r2' | wx, wy, wz, 0) with r2' = max(rad*rad, 1e-30) for
//   rad > 0 and -1 otherwise (no dist2 >= 0 passes it); each tile a bound,
//   (lo xyz, largest radius | hi xyz, 0) of its centres.
// - The cull (`cull_tiles`): a block of 256 consecutive rays (16x16
//   pixels in the camera's Morton order: a narrow frustum) keeps a tile
//   when one of its rays keeps it; `compact_tiles` lists the kept tiles of
//   each ray block in tile order. The test is conservative for the
//   kernel's ROUNDED pierce test, not only for exact geometry: a pair the
//   pierce test passes has dist2 < r2' in float32, where dist2 = oc2 - dd^2
//   cancels; its error grows like |oc|^2 (up to ~17 ulp of oc2, and |d|^2 -
//   1 of it besides). At |oc| ~ 1,400 scene units (the lampshade's camera)
//   one ulp of oc2 is 0.125, not small against radii of a few units. So a
//   ray keeps a tile when its segment o + t d, t in [-8u |oc|max / |d|,
//   hit_t (1 + 16u) / |d|], meets the box of the tile's centres inflated by
//   R = sqrt(rmax^2 (1 + 8u) + (32u max(1, |d|^2) + max(0, |d|^2 - 1) +
//   8u |d|^2) |oc|max^2) plus 16u (|o|inf + |oc|max + R) for the slab
//   test's own rounding (u = 2^-24, |oc|max the distance to the box's
//   farthest corner; square roots rounded up). A NaN slab bound (0 * inf,
//   an origin on a slab plane) does not constrain, as in K1
//   (`csrc/bvh_traverse.cu`). `tile_keep_plain` is the same test in torch.
// - The sweep (`sweep_tiles`): one persistent block per free slot (132
//   SMs x occupancy) takes an equal share of the (ray block, kept tile)
//   work list, so uneven lists still keep every SM busy. Each kept tile
//   comes into shared memory by a 1-D bulk copy (cp.async.bulk, the TMA,
//   completing on an mbarrier), three in flight; the records are
//   contiguous, so no tensor map is needed. Each thread holds 2 rays in
//   registers, so each 16-byte broadcast load of (px, py, pz, r2') feeds 2
//   pair tests. The decision is dd > 0 && dist2 < r2' && oc2 <= th2, where
//   th2 is the largest float with sqrtf(th2) <= hit_t (found once per ray):
//   it equals sqrtf(oc2) <= hit_t for every oc2, so no square root runs
//   per pair; the power, the divisions and the exponential (IEEE division
//   and the accurate expf, as in the plain version) run only on pierced
//   pairs.
// - Partial sums: a block's sum for one ray block goes to its own slot
//   (block + ray block, unique because both advance together along the
//   list); `sum_slots` adds each ray's slots in block order. No float
//   atomics: two calls give bit-identical output.
//
// Exactness: the pierce test rounds every operation as the plain version
// does (__fsub_rn/__fmul_rn/__fadd_rn, no contraction into FMAs), so both
// decide every pair the same way; the sums are taken in another order
// (and the weights may contract into FMAs), hence rtol 1e-3 against the
// plain version. No tensor
// cores: the reduction is 3 wide, and the pierce test must round each
// operation as the plain version does.
//
// `rpt_sphere_pierced` runs the same cull, list and pierce test but counts
// the pierced pairs of each ray (verification only; the main path never
// calls it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRays = 256;                     // rays per ray block: the cull's unit
constexpr int kTile = 256;                     // spheres per tile (ops/sphere_sweep.py TILE)
constexpr int kPerThread = 2;                  // rays a sweep thread holds in registers
constexpr int kThreads = kRays / kPerThread;   // sweep threads per block
constexpr int kStages = 3;                     // tiles in flight per sweep block
constexpr int kCullThreads = 256;              // tiles per cull block
constexpr int kCompactThreads = 1024;
constexpr float kU = 5.9604645e-8f;            // 2^-24, the unit roundoff of float32
constexpr float kSqrtUp = 1.0f + 1e-5f;        // slack of sqrt.approx, rounded up

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// An upper bound of sqrt(x) (sqrt.approx is within a few ulp).
__device__ __forceinline__ float sqrt_up(float x) {
    float r;
    asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r * kSqrtUp;
}

// ---------------------------------------------------------------------------
// The cull

struct CullRay {
    float4 o;    // origin, |o|inf
    float4 inv;  // 1/d, (1 + 16u) / |d|
    float4 lim;  // t cap, error term of oc2 - dd^2 per |oc|^2, -, -
};

__device__ __forceinline__ CullRay cull_ray(const float* ray_o, const float* ray_d,
                                            const float* hit_t, int i) {
    const float ox = ray_o[3 * i], oy = ray_o[3 * i + 1], oz = ray_o[3 * i + 2];
    const float dx = ray_d[3 * i], dy = ray_d[3 * i + 1], dz = ray_d[3 * i + 2];
    const float th = hit_t[i];
    const float dn2 = dx * dx + dy * dy + dz * dz;
    const float inv_len = (1.f + 16.f * kU) / sqrtf(dn2);
    const float eterm = 32.f * kU * fmaxf(1.f, dn2) + fmaxf(0.f, dn2 - 1.f) + 8.f * kU * dn2;
    // a NaN or negative hit time pierces nothing: keep no tile
    const float tcap = th >= 0.f ? th * (1.f + 16.f * kU) * inv_len : -inf();
    CullRay c;
    c.o = make_float4(ox, oy, oz, fmaxf(fabsf(ox), fmaxf(fabsf(oy), fabsf(oz))));
    c.inv = make_float4(1.f / dx, 1.f / dy, 1.f / dz, inv_len);
    c.lim = make_float4(tcap, eterm, 0.f, 0.f);
    return c;
}

// Slab interval of one axis: NaN (0 * inf) does not constrain.
__device__ __forceinline__ void slab(float lo_plane, float hi_plane, float o, float inv,
                                     float& enter, float& exit_) {
    const float t1 = (lo_plane - o) * inv;
    const float t2 = (hi_plane - o) * inv;
    const bool nan = (t1 != t1) || (t2 != t2);
    enter = fmaxf(enter, nan ? -inf() : fminf(t1, t2));
    exit_ = fminf(exit_, nan ? inf() : fmaxf(t1, t2));
}

// Does the ray keep the tile? lo.w is the tile's largest radius squared,
// grown by (1 + 8u), plus 1e-30; hi.w is unused.
__device__ __forceinline__ bool tile_keeps(const CullRay& r, float4 lo, float4 hi) {
    const float ax = fmaxf(fabsf(lo.x - r.o.x), fabsf(hi.x - r.o.x));
    const float ay = fmaxf(fabsf(lo.y - r.o.y), fabsf(hi.y - r.o.y));
    const float az = fmaxf(fabsf(lo.z - r.o.z), fabsf(hi.z - r.o.z));
    const float om2 = ax * ax + ay * ay + az * az;
    const float om = sqrt_up(om2);
    const float rc = sqrt_up(r.lim.y * om2 + lo.w);
    const float big_r = rc + 16.f * kU * (r.o.w + om + rc);
    float enter = -8.f * kU * om * r.inv.w, exit_ = r.lim.x;
    slab(lo.x - big_r, hi.x + big_r, r.o.x, r.inv.x, enter, exit_);
    slab(lo.y - big_r, hi.y + big_r, r.o.y, r.inv.y, enter, exit_);
    slab(lo.z - big_r, hi.z + big_r, r.o.z, r.inv.z, enter, exit_);
    return enter <= exit_;
}

// keep[rb, tile] = does any ray of ray block rb keep the tile. A thread per
// tile; it stops at the first ray that keeps it.
__global__ void __launch_bounds__(kCullThreads)
cull_tiles(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
           const float* __restrict__ hit_t, int n, const float4* __restrict__ bounds,
           int n_tiles, unsigned char* __restrict__ keep) {
    __shared__ CullRay s_ray[kRays];
    const int rb = blockIdx.x;
    const int live = min(kRays, n - rb * kRays);
    for (int k = threadIdx.x; k < live; k += blockDim.x)
        s_ray[k] = cull_ray(ray_o, ray_d, hit_t, rb * kRays + k);
    __syncthreads();
    const int tile = blockIdx.y * kCullThreads + threadIdx.x;
    if (tile >= n_tiles) return;
    float4 lo = bounds[2 * tile];
    const float4 hi = bounds[2 * tile + 1];
    lo.w = lo.w * lo.w * (1.f + 8.f * kU) + 1e-30f;
    bool kept = false;
    for (int k = 0; k < live && !kept; ++k) kept = tile_keeps(s_ray[k], lo, hi);
    keep[static_cast<size_t>(rb) * n_tiles + tile] = kept;
}

// lists[rb, 0:count) = the kept tiles of ray block rb in tile order.
__global__ void __launch_bounds__(kCompactThreads)
compact_tiles(const unsigned char* __restrict__ keep, int n_tiles, int* __restrict__ lists,
              int* __restrict__ counts) {
    __shared__ int s_warp[32];
    __shared__ int s_base;
    const int rb = blockIdx.x;
    const unsigned char* flags = keep + static_cast<size_t>(rb) * n_tiles;
    int* out = lists + static_cast<size_t>(rb) * n_tiles;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) s_base = 0;
    for (int start = 0; start < n_tiles; start += kCompactThreads) {
        const int t = start + threadIdx.x;
        const bool f = t < n_tiles && flags[t];
        const unsigned mask = __ballot_sync(0xffffffffu, f);
        __syncthreads();  // s_warp and s_base of the previous round are read
        if (lane == 0) s_warp[warp] = __popc(mask);
        __syncthreads();
        if (warp == 0) {  // exclusive scan of the 32 warp counts
            const int v = s_warp[lane];
            int incl = v;
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += y;
            }
            s_warp[lane] = incl - v;
        }
        __syncthreads();
        const int base = s_base;
        const int mine = s_warp[warp] + __popc(mask & ((1u << lane) - 1u));
        if (f) out[base + mine] = t;
        __syncthreads();
        if (threadIdx.x == kCompactThreads - 1) s_base = base + mine + (f ? 1 : 0);
    }
    __syncthreads();
    if (threadIdx.x == 0) counts[rb] = s_base;
}

// offsets[rb] = sum of counts before rb; offsets[n_rb] = the list's length.
__global__ void scan_counts(const int* __restrict__ counts, int n_rb, int* __restrict__ offsets) {
    if (threadIdx.x != 0) return;
    int s = 0;
    for (int i = 0; i < n_rb; ++i) {
        offsets[i] = s;
        s += counts[i];
    }
    offsets[n_rb] = s;
}

// ---------------------------------------------------------------------------
// The sweep

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n\t"
        ".reg .pred P1;\n\t"
        "LAB_WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
        "@P1 bra DONE;\n\t"
        "bra LAB_WAIT;\n\t"
        "DONE:\n\t"
        "}" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// One thread: copy `bytes` contiguous bytes from global to shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// The largest float th2 with sqrtf(th2) <= th, so that oc2 <= th2 decides
// exactly as sqrtf(oc2) <= th (sqrtf is correctly rounded and monotone).
// NaN stays NaN; a negative limit admits no oc2 >= 0.
__device__ float sqrt_threshold(float th) {
    if (!(th >= 0.f)) return th != th ? th : -1.f;
    float x = __fmul_rn(th, th);
    while (__fsqrt_rn(x) > th) x = nextafterf(x, 0.f);
    while (x < inf() && __fsqrt_rn(nextafterf(x, inf())) <= th) x = nextafterf(x, inf());
    return x;
}

struct SweepRay {
    float ox, oy, oz, dx, dy, dz, th2;
};

// The ray block that holds work item w: the last rb with offsets[rb] <= w
// (an empty ray block shares its offset with the next one).
__device__ __forceinline__ int ray_block_of(const int* offsets, int n_rb, int w) {
    int lo = 0, hi = n_rb;
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (offsets[mid] <= w) lo = mid;
        else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ int split_of(long long total, int b, int nb) {
    return static_cast<int>(total * b / nb);
}

template <int kWidth>
__device__ __forceinline__ void load_rays(const float* ray_o, const float* ray_d,
                                          const float* hit_t, int n, int rb,
                                          SweepRay (&ray)[kPerThread],
                                          float (&acc)[kPerThread][kWidth]) {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
        const int i = rb * kRays + r * kThreads + threadIdx.x;
        SweepRay s{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};  // a dead lane pierces nothing
        if (i < n) {
            s.ox = ray_o[3 * i]; s.oy = ray_o[3 * i + 1]; s.oz = ray_o[3 * i + 2];
            s.dx = ray_d[3 * i]; s.dy = ray_d[3 * i + 1]; s.dz = ray_d[3 * i + 2];
            s.th2 = sqrt_threshold(hit_t[i]);
        }
        ray[r] = s;
#pragma unroll
        for (int c = 0; c < kWidth; ++c) acc[r][c] = 0.f;
    }
}

template <int kWidth>
__device__ __forceinline__ void flush(float* partial, int slot,
                                      const float (&acc)[kPerThread][kWidth]) {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
        float* p = partial + (static_cast<size_t>(slot) * kRays + r * kThreads + threadIdx.x) * kWidth;
#pragma unroll
        for (int c = 0; c < kWidth; ++c) p[c] = acc[r][c];
    }
}

// Every pair of the tile's kTile records and this thread's rays.
template <bool kCount, int kWidth>
__device__ __forceinline__ void sweep_tile(const float4* __restrict__ rec,
                                           const SweepRay (&ray)[kPerThread],
                                           float (&acc)[kPerThread][kWidth], float ext,
                                           float scale) {
#pragma unroll 2
    for (int c = 0; c < kTile; ++c) {
        const float4 s = rec[2 * c];  // px py pz r2': one broadcast load for kPerThread tests
#pragma unroll
        for (int r = 0; r < kPerThread; ++r) {
            // rounded as the plain version rounds: no FMA contraction
            const float ocx = __fsub_rn(s.x, ray[r].ox);
            const float ocy = __fsub_rn(s.y, ray[r].oy);
            const float ocz = __fsub_rn(s.z, ray[r].oz);
            const float dd = __fadd_rn(__fadd_rn(__fmul_rn(ocx, ray[r].dx), __fmul_rn(ocy, ray[r].dy)),
                                       __fmul_rn(ocz, ray[r].dz));
            const float oc2 = __fadd_rn(__fadd_rn(__fmul_rn(ocx, ocx), __fmul_rn(ocy, ocy)),
                                        __fmul_rn(ocz, ocz));
            const float dist2 = fmaxf(__fsub_rn(oc2, __fmul_rn(dd, dd)), 0.f);
            if (dd > 0.f && dist2 < s.w && oc2 <= ray[r].th2) {
                if constexpr (kCount) {
                    acc[r][0] += 1.f;
                } else {
                    const float4 p = rec[2 * c + 1];
                    const float x = dist2 / s.w;
                    const float k2 = (1.f - x) * (1.f - x);
                    const float w = k2 / s.w * expf(-ext * dd) * scale;
                    acc[r][0] += w * p.x;
                    acc[r][1] += w * p.y;
                    acc[r][2] += w * p.z;
                }
            }
        }
    }
}

// Persistent: block b takes work items [split(b), split(b + 1)) of the
// list, items in ray-block order, each a (ray block, kept tile) pair.
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
sweep_tiles(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
            const float* __restrict__ hit_t, int n, const float4* __restrict__ records,
            const int* __restrict__ lists, const int* __restrict__ offsets, int n_rb, int n_tiles,
            float ext, float scale, float* __restrict__ partial) {
    constexpr int kWidth = kCount ? 1 : 3;
    constexpr uint32_t kTileBytes = kTile * 2 * sizeof(float4);
    extern __shared__ __align__(128) float4 s_rec[];  // kStages x kTile records
    __shared__ __align__(8) uint64_t s_full[kStages];

    const long long total = offsets[n_rb];
    const int b = blockIdx.x, nb = gridDim.x;
    const int w0 = split_of(total, b, nb), w1 = split_of(total, b + 1, nb);
    if (w0 >= w1) return;

    int rb = ray_block_of(offsets, n_rb, w0);
    int wp = w0, rbp = rb;  // the producer's next item and its ray block (thread 0)
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) mbar_init(&s_full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        for (int s = 0; s < kStages && wp < w1; ++s, ++wp) {
            while (wp >= offsets[rbp + 1]) ++rbp;
            const int tile = lists[static_cast<size_t>(rbp) * n_tiles + (wp - offsets[rbp])];
            bulk_load(s_rec + s * kTile * 2, records + static_cast<size_t>(tile) * kTile * 2, kTileBytes,
                      &s_full[s]);
        }
    }
    __syncthreads();

    SweepRay ray[kPerThread];
    float acc[kPerThread][kWidth];
    load_rays(ray_o, ray_d, hit_t, n, rb, ray, acc);
    int rb_end = offsets[rb + 1];
    for (int w = w0, k = 0; w < w1; ++w, ++k) {
        if (w >= rb_end) {
            flush(partial, b + rb, acc);
            do ++rb; while (w >= offsets[rb + 1]);
            rb_end = offsets[rb + 1];
            load_rays(ray_o, ray_d, hit_t, n, rb, ray, acc);
        }
        const int stage = k % kStages;
        mbar_wait(&s_full[stage], (k / kStages) & 1);
        sweep_tile<kCount>(s_rec + stage * kTile * 2, ray, acc, ext, scale);
        __syncthreads();  // every thread is done with this stage
        if (threadIdx.x == 0 && wp < w1) {
            while (wp >= offsets[rbp + 1]) ++rbp;
            const int tile = lists[static_cast<size_t>(rbp) * n_tiles + (wp - offsets[rbp])];
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            bulk_load(s_rec + stage * kTile * 2, records + static_cast<size_t>(tile) * kTile * 2,
                      kTileBytes, &s_full[stage]);
            ++wp;
        }
    }
    flush(partial, b + rb, acc);
}

// out[i] = sum over the blocks that swept ray i's ray block, in block
// order, of their slot (times the medium colour; or the pierced count).
template <bool kCount>
__global__ void sum_slots(const float* __restrict__ partial, const int* __restrict__ offsets,
                          int n_rb, int nb, int n, const float* __restrict__ med_color,
                          float* __restrict__ out) {
    constexpr int kWidth = kCount ? 1 : 3;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int rb = i / kRays, lane = i % kRays;
    const long long total = offsets[n_rb];
    const int o0 = offsets[rb], o1 = offsets[rb + 1];
    float acc[kWidth] = {};
    if (o0 < o1) {
        int b = static_cast<int>(static_cast<long long>(o0) * nb / total);
        while (b + 1 < nb && split_of(total, b + 1, nb) <= o0) ++b;
        while (b > 0 && split_of(total, b, nb) > o0) --b;
        for (; b < nb && split_of(total, b, nb) < o1; ++b) {
            if (split_of(total, b, nb) == split_of(total, b + 1, nb)) continue;  // no items
            const float* p = partial + (static_cast<size_t>(b + rb) * kRays + lane) * kWidth;
#pragma unroll
            for (int c = 0; c < kWidth; ++c) acc[c] += p[c];
        }
    }
    if constexpr (kCount) {
        reinterpret_cast<int*>(out)[i] = static_cast<int>(acc[0]);
    } else {
#pragma unroll
        for (int c = 0; c < kWidth; ++c) out[kWidth * i + c] = acc[c] * med_color[c];
    }
}

template <bool kCount>
int run(const float* ray_o, const float* ray_d, const float* hit_t, int n, const float* records,
        const float* bounds, int n_tiles, float ext, float scale, const float* med_color,
        unsigned char* keep, int* lists, int* counts, float* partial, int max_blocks, float* out,
        cudaStream_t st) {
    const int n_rb = (n + kRays - 1) / kRays;
    int* offsets = counts + n_rb;
    cull_tiles<<<dim3(n_rb, (n_tiles + kCullThreads - 1) / kCullThreads), kCullThreads, 0, st>>>(
        ray_o, ray_d, hit_t, n, reinterpret_cast<const float4*>(bounds), n_tiles, keep);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    compact_tiles<<<n_rb, kCompactThreads, 0, st>>>(keep, n_tiles, lists, counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    scan_counts<<<1, 32, 0, st>>>(counts, n_rb, offsets);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    constexpr size_t kSmem = static_cast<size_t>(kStages) * kTile * 2 * sizeof(float4);
    static int per_sm = 0;  // resident sweep blocks per SM, asked once
    if (per_sm == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_tiles<kCount>,
                                                            kThreads, kSmem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int nb = max(1, min(per_sm * sms, max_blocks));
    sweep_tiles<kCount><<<nb, kThreads, kSmem, st>>>(
        ray_o, ray_d, hit_t, n, reinterpret_cast<const float4*>(records), lists, offsets, n_rb,
        n_tiles, ext, scale, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sum_slots<kCount><<<(n + 255) / 256, 256, 0, st>>>(partial, offsets, n_rb, nb, n, med_color,
                                                        out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The estimate: out (n, 3) f32.
extern "C" int rpt_sphere_sweep(const float* ray_o, const float* ray_d, const float* hit_t, int n,
                                const float* records, const float* bounds, int n_tiles,
                                float ext, float scale, const float* med_color,
                                unsigned char* keep, int* lists, int* counts, float* partial,
                                int max_blocks, float* out, void* stream) {
    return run<false>(ray_o, ray_d, hit_t, n, records, bounds, n_tiles, ext, scale, med_color,
                      keep, lists, counts, partial, max_blocks, out,
                      static_cast<cudaStream_t>(stream));
}

// Verification only: out_count (n,) int32, the pierced pairs of each ray,
// through the same cull, list and pierce test.
extern "C" int rpt_sphere_pierced(const float* ray_o, const float* ray_d, const float* hit_t,
                                  int n, const float* records, const float* bounds, int n_tiles,
                                  unsigned char* keep, int* lists, int* counts, float* partial,
                                  int max_blocks, int* out_count, void* stream) {
    return run<true>(ray_o, ray_d, hit_t, n, records, bounds, n_tiles, 0.f, 0.f, nullptr, keep,
                     lists, counts, partial, max_blocks, reinterpret_cast<float*>(out_count),
                     static_cast<cudaStream_t>(stream));
}
