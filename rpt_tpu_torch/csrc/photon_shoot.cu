// K-shoot: the interaction of one level of the photon shoot, on Hopper.
//
// Replaces the body of a bounce level of the JAX package's shoot
// (`rpt_tpu/integrators/photon.py:137-294`, `_shoot_launch`: one XLA
// program a level on the TPU) after its closest-hit query: the free
// flight through the medium and the volume event, the phase sampling and
// the scattering roulette, the material's `sample_f` and `bsdf`, the
// cosine rule (photon.rs:846-850), the diffuse roulette p_d = 0.7 and the
// mirror rule for deposits, the deposit rows and the survivors' compaction.
// The plain PyTorch version is `shoot_level_plain` in
// `rpt_tpu_torch/ops/photon_shoot.py`, the chain of torch ops of the level
// (~490 launches on the card and three host syncs a level); the wrapper
// there, `shoot_level`, runs this file for CUDA tensors.
//
// A call is three kernels on the stream, and never synchronises:
// - interact, one thread a photon lane: the lane's keys (the level's fold
//   of its key row, then each draw's tags, in registers: `threefry.cuh`),
//   everything the chain computes for it, and only the branch it takes (a
//   lane evaluates its own material's lobe, not all four). It writes the
//   new position, direction and power (`tmp`, planar), three flags
//   (surface deposit, volume deposit, survivor) and its block's count of
//   each (__syncthreads_count).
// - scan, one block: the exclusive prefix of the blocks' counts, on top of
//   the rows earlier levels wrote (row `level` of `offsets`); it writes
//   each block's first row in place of its counts and row `level + 1`:
//   the surface and volume rows so far and the survivors.
// - scatter, one thread a lane: its rank among its block's lanes of each
//   flag (warp ballots), so deposits and survivors keep lane order within
//   a level and levels follow in sequence, as the chain's boolean-mask
//   gathers and `torch.cat` do. A deposit row [pos, wo, pre-attenuation
//   power, ray origin] lands at its row if that is below the capacity, as
//   `rows[:cap]` keeps them; a survivor's ray, power and key row land at
//   its rank in the next state.
// The host reads one number a level, the survivors (row `level + 1`), to
// size the next level and end the loop.
//
// Rounding: every operation rounds as the chain's torch kernels do on the
// card: __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn in the chain's order
// (Vec3.dot sums (x + y) + z), so nvcc contracts nothing into an FMA that
// torch rounds twice; `Ray.at` in float64, rounded once to float32;
// logf, sqrtf, cosf, sinf, powf and rsqrtf as torch's kernels call them;
// a Python number in a torch op is the float32 it rounds to, `scalar /
// tensor` is `reciprocal(tensor) * scalar` and `tensor / scalar` is
// `tensor * (1 / scalar)` with the reciprocal taken in float32 (torch's
// CUDA division by a CPU scalar); `x ** 2` is x * x; clamps pass NaN on.
// The host rounds the medium's constants as the chain's Python expressions
// do (`ops/photon_shoot.py`, `_medium_constants`).
//
// What bounds it: bytes. A lane reads its ray, power, key row and hit
// (72 bytes) and writes its new state and flags (37 bytes); the scatter
// reads those back and writes 48 bytes a deposit and 52 a survivor. The
// arithmetic, a few hundred float operations and seven threefry hashes a
// lane (~80 integer operations each), is under the bytes' time at 500,000
// lanes. The design keeps a level to three launches and one read by the
// host, in place of the chain's launches and syncs.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "threefry.cuh"

constexpr int kRow = 12;  // a deposit: pos, wo, power, ray origin

// medium kinds: rpt_tpu_torch/medium.py ISOTROPIC, GLOWING, HENYEY_GREENSTEIN
constexpr int kNoMedium = 0;
constexpr int kIsotropic = 1;
constexpr int kGlowing = 2;
constexpr int kHenyeyGreenstein = 3;

struct ShootParams {
    const float* ray;              // (6, stride): ox oy oz dx dy dz of the level's lanes
    const float* power;            // (3, stride)
    const int64_t* keys;           // (stride, 2): the lanes' key rows
    float* ray_out;                // the survivors' next state, same layouts
    float* power_out;
    int64_t* keys_out;
    const float* hit_t;            // the level's closest hit, lane i at
    const float* hit_normal[3];    //   i * hit_stride[k] (time, normal x y z,
    const int32_t* hit_material;   //   material)
    int64_t hit_stride[5];
    float* tmp;                    // (9, stride): new position, direction, power
    uint8_t* flags;                // (stride,)
    int32_t* block_counts;         // (blocks, 3): counts, then each block's first rows
    int32_t* offsets;              // (levels + 1, 4): surface rows, volume rows, survivors
    float* surface;                // (s_cap, kRow)
    float* volume;                 // (v_cap, kRow)
    const int32_t* mat_kind;       // the material table, (materials,) each
    const float* mat_albedo[3];
    const float* mat_shininess;
    const float* mat_ior;
    int64_t stride;
    int n;
    int level;
    int s_cap;
    int v_cap;
    int n_materials;
    int medium;                    // kNoMedium .. kHenyeyGreenstein
    float ext;                     // sigma_a + sigma_s
    float rr;                      // sigma_s / (sigma_a + sigma_s)
    float phase;                   // the isotropic kinds' phase
    float pdf;                     // the uniform sphere's pdf as the preset states it
    float color[3];                // the medium's colour (glowing fog: above split_y)
    float color_below[3];          // glowing fog: below split_y
    float split_y;
    int hg_invert;                 // Henyey-Greenstein: invert its CDF (else |g| < 1e-6)
    float hg_two_g;                // 2 g
    float hg_one_plus_g;           // 1 + g
    float hg_one_minus_g2;         // 1 - g^2
    float hg_one_plus_g2;          // 1 + g^2
    float hg_inv_two_g;            // 1 / (2 g), in float32
    float hg_norm;                 // (1 - g^2) / (4 pi)
};

static_assert(offsetof(ShootParams, hit_t) == 48 && offsetof(ShootParams, hit_stride) == 88 &&
                  offsetof(ShootParams, tmp) == 128 && offsetof(ShootParams, mat_kind) == 176 &&
                  offsetof(ShootParams, stride) == 224 && offsetof(ShootParams, n) == 232 &&
                  offsetof(ShootParams, medium) == 252 && offsetof(ShootParams, ext) == 256 &&
                  offsetof(ShootParams, color) == 272 && offsetof(ShootParams, split_y) == 296 &&
                  offsetof(ShootParams, hg_invert) == 300 &&
                  offsetof(ShootParams, hg_norm) == 324 && sizeof(ShootParams) == 328,
              "ShootParams layout (ops/photon_shoot.py _ShootParams)");

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// flags
constexpr int kSurface = 1;
constexpr int kVolume = 2;
constexpr int kContinue = 4;

// materials.py kinds
constexpr int kLambertian = 0;
constexpr int kPhong = 1;
constexpr int kMirror = 2;
constexpr int kTransmissive = 3;

// Python's numbers as the chain's torch ops round them
constexpr float kTwoPi = static_cast<float>(6.283185307179586);   // sampling.TWO_PI
constexpr float kInvPi = static_cast<float>(0.3183098861837907);  // sampling.INV_PI
constexpr float kPd = static_cast<float>(0.7);                    // photon.rs:821-833
constexpr float kTiny = static_cast<float>(1e-38);  // normalize's and sample_d's clamp
constexpr float kTinyPdf = static_cast<float>(1e-20);
constexpr float kTinyDenom = static_cast<float>(1e-12);  // the HG phase's clamp

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// torch.clamp: NaN passes
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
    return v != v ? v : fminf(fmaxf(v, lo), hi);
}

struct Vec {
    float x, y, z;
};

__device__ __forceinline__ Vec neg(const Vec& v) { return {-v.x, -v.y, -v.z}; }
__device__ __forceinline__ Vec scale(const Vec& v, float s) {
    return {mul(v.x, s), mul(v.y, s), mul(v.z, s)};
}
__device__ __forceinline__ float dot(const Vec& a, const Vec& b) {
    return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
__device__ __forceinline__ Vec normalize(const Vec& v) {
    return scale(v, rsqrtf(clamp_min(dot(v, v), kTiny)));
}
// vec.reflect: v - n * (2 (v . n))
__device__ __forceinline__ Vec reflect(const Vec& v, const Vec& n) {
    const float k = mul(2.f, dot(v, n));
    return {sub(v.x, mul(n.x, k)), sub(v.y, mul(n.y, k)), sub(v.z, mul(n.z, k))};
}

// vec.from_local over vec.orthonormal_basis (Duff et al.): ((t lx) + (n ly)) + (b lz)
__device__ __forceinline__ Vec from_local(const Vec& l, const Vec& n) {
    const float sign = n.z >= 0.f ? 1.f : -1.f;
    const float a = mul(dvd(1.f, add(sign, n.z)), -1.f);
    const float b = mul(mul(n.x, n.y), a);
    const Vec t = {add(mul(mul(mul(sign, n.x), n.x), a), 1.f), mul(sign, b), mul(-sign, n.x)};
    const Vec u = {b, add(sign, mul(mul(n.y, n.y), a)), -n.y};
    return {add(add(mul(t.x, l.x), mul(n.x, l.y)), mul(u.x, l.z)),
            add(add(mul(t.y, l.x), mul(n.y, l.y)), mul(u.y, l.z)),
            add(add(mul(t.z, l.x), mul(n.z, l.y)), mul(u.z, l.z))};
}

// the local direction (sin_t cos phi, cos_t, sin_t sin phi)
__device__ __forceinline__ Vec polar(float cos_t, float sin_t, float phi) {
    return {mul(sin_t, cosf(phi)), cos_t, mul(sin_t, sinf(phi))};
}

// Ray.at: o + d t in float64 (the product is exact), rounded once
__device__ __forceinline__ float at(float o, float d, float t) {
    return __double2float_rn(__dadd_rn(static_cast<double>(o),
                                       __dmul_rn(static_cast<double>(d), static_cast<double>(t))));
}

__device__ __forceinline__ Vec at(const Vec& o, const Vec& d, float t) {
    return {at(o.x, d.x, t), at(o.y, d.y, t), at(o.z, d.z, t)};
}

// A key folded with one or two tags
struct Key {
    uint32_t k1, k2;
    __device__ __forceinline__ Key fold(uint32_t tag) const {
        Key k = *this;
        fold_in(k.k1, k.k2, tag);
        return k;
    }
    // `uniform` of the key: counter c's word in [0, 1)
    __device__ __forceinline__ float draw(uint32_t c) const {
        uint32_t x1 = 0u, x2 = c;
        threefry(k1, k2, x1, x2);
        return unit_float(x1 ^ x2);
    }
};

// sampling.uniform_sphere
__device__ __forceinline__ Vec uniform_sphere(float r1, float r2) {
    const float z = sub(1.f, mul(2.f, r1));
    const float r = sqrtf(clamp_min(sub(1.f, mul(z, z)), 0.f));
    const float phi = mul(kTwoPi, r2);
    return {mul(r, cosf(phi)), z, mul(r, sinf(phi))};
}

// medium.henyey_greenstein's phase(wo, wi)
__device__ __forceinline__ float hg_phase(const ShootParams& p, const Vec& wo, const Vec& wi) {
    const float cos_t = dot(neg(wo), wi);
    const float denom = powf(add(mul(p.hg_two_g, cos_t), p.hg_one_plus_g2), 1.5f);
    return mul(dvd(1.f, clamp_min(denom, kTinyDenom)), p.hg_norm);
}

// medium.henyey_greenstein's sample_ph where it inverts the CDF
__device__ __forceinline__ Vec hg_sample(const ShootParams& p, const Vec& wo, float r1,
                                         float r2) {
    const float den = sub(p.hg_one_plus_g, mul(p.hg_two_g, r1));
    const float sq = mul(dvd(1.f, den), p.hg_one_minus_g2);
    const float cos_t = clamp(mul(-sub(p.hg_one_plus_g2, mul(sq, sq)), p.hg_inv_two_g), -1.f, 1.f);
    const float sin_t = sqrtf(clamp_min(sub(1.f, mul(cos_t, cos_t)), 0.f));
    return normalize(from_local(polar(cos_t, sin_t, mul(kTwoPi, r2)), neg(wo)));
}

// materials.sample_f for the lane's own kind: the direction, its pdf and
// whether it is valid (false on total internal reflection)
__device__ __forceinline__ Vec sample_f(int kind, float shininess, float ior, const Vec& n,
                                        const Vec& wo, float r1, float r2, float rr,
                                        float& pdf, bool& valid) {
    pdf = 1.f;
    valid = true;
    if (kind == kLambertian) {  // sampling.cosine_hemisphere
        const float cos_t = sqrtf(r2);
        const float sin_t = sqrtf(clamp_min(sub(1.f, r2), 0.f));
        pdf = mul(cos_t, kInvPi);
        return normalize(from_local(polar(cos_t, sin_t, mul(kTwoPi, r1)), n));
    }
    if (kind == kPhong) {  // sampling.phong_lobe around -reflect(wo, n)
        const float s1 = add(shininess, 1.f);
        const float cos_t = powf(r2, dvd(1.f, s1));
        const float sin_t = sqrtf(clamp_min(sub(1.f, mul(cos_t, cos_t)), 0.f));
        pdf = mul(mul(s1, dvd(1.f, kTwoPi)), powf(cos_t, shininess));
        return normalize(from_local(polar(cos_t, sin_t, mul(kTwoPi, r1)), neg(reflect(wo, n))));
    }
    if (kind == kMirror) return neg(reflect(wo, normalize(n)));
    const bool inside = dot(n, wo) < 0.f;
    const Vec n_eff = inside ? neg(n) : n;
    const float cos_i = clamp(dot(wo, n_eff), 0.f, 1.f);
    const float ni = inside ? ior : 1.f;
    const float nt = inside ? 1.f : ior;
    // _schlick: r0 + (1 - r0) (1 - cos_i)^5, r0 = ((ni - nt) / (ni + nt))^2
    const float q = dvd(sub(ni, nt), add(ni, nt));
    const float r0 = mul(q, q);
    const float schlick = clamp(add(r0, mul(sub(1.f, r0), powf(sub(1.f, cos_i), 5.f))), 0.f, 1.f);
    const bool reflect_branch = rr < schlick;
    const float eta = dvd(ni, nt);
    const float disc = sub(1.f, mul(mul(eta, eta), sub(1.f, mul(cos_i, cos_i))));
    const float cos_t = sqrtf(clamp_min(disc, 0.f));
    if (kind == kTransmissive) valid = reflect_branch || !(disc < 0.f);
    if (reflect_branch) return neg(reflect(wo, n));
    const float k = sub(mul(eta, cos_i), cos_t);
    return {add(mul(-wo.x, eta), mul(n_eff.x, k)), add(mul(-wo.y, eta), mul(n_eff.y, k)),
            add(mul(-wo.z, eta), mul(n_eff.z, k))};
}

// materials.bsdf for the lane's own kind
__device__ __forceinline__ Vec bsdf(int kind, const Vec& albedo, float shininess, const Vec& n,
                                    const Vec& wo, const Vec& wi) {
    if (!(dot(n, wi) >= 0.f && dot(n, wo) >= 0.f)) return {0.f, 0.f, 0.f};
    if (kind == kLambertian) return scale(albedo, kInvPi);
    if (kind == kPhong) {
        const Vec norm = scale(albedo, mul(add(shininess, 2.f), dvd(1.f, kTwoPi)));
        const Vec reflected = normalize(neg(reflect(wi, n)));
        return scale(norm, powf(clamp(dot(reflected, wo), 0.f, 1.f), shininess));
    }
    return {1.f, 1.f, 1.f};
}

__device__ __forceinline__ Vec load3(const float* base, int64_t stride, int64_t i) {
    return {base[i], base[stride + i], base[2 * stride + i]};
}

__device__ __forceinline__ void store3(float* base, int64_t stride, int64_t i, const Vec& v) {
    base[i] = v.x;
    base[stride + i] = v.y;
    base[2 * stride + i] = v.z;
}

// One lane of the level: its flags, and its new position, direction and
// power in `tmp` where it deposits or survives.
__device__ int interact(const ShootParams& p, int i) {
    const int64_t s = p.stride;
    const Vec o = load3(p.ray, s, i);
    const Vec d = load3(p.ray, s, 3 * s + i);
    const Vec pw = load3(p.power, s, i);
    const longlong2 row = reinterpret_cast<const longlong2*>(p.keys)[i];
    const Key kb = Key{static_cast<uint32_t>(row.x), static_cast<uint32_t>(row.y)}.fold(
        static_cast<uint32_t>(p.level));
    const Vec wo = neg(normalize(d));
    const float t_hit = p.hit_t[i * p.hit_stride[0]];
    const bool valid = isfinite(t_hit);

    bool vol_event = false;
    Vec pos, wi, next;
    int flags = 0;
    if (p.medium != kNoMedium) {
        // medium.sample_d, then the volume interaction (photon.rs:877-915)
        const float u = kb.fold(1).fold(0x5D).draw(0);
        const float dist = dvd(-logf(clamp_min(u, kTiny)), p.ext);
        vol_event = dist < (valid ? t_hit : inf());
        if (vol_event) {
            pos = at(o, d, dist);
            const float u_v = kb.fold(2).draw(0);
            const Key kp = kb.fold(3).fold(0x9A);
            const float r1 = kp.draw(0), r2 = kp.draw(1);
            float ph, ph_p;
            if (p.medium == kHenyeyGreenstein && p.hg_invert) {
                wi = hg_sample(p, wo, r1, r2);
                ph = ph_p = hg_phase(p, wo, wi);
            } else {
                wi = uniform_sphere(r1, r2);
                ph = p.medium == kHenyeyGreenstein ? hg_phase(p, wo, wi) : p.phase;
                ph_p = p.pdf;
            }
            const bool high = p.medium == kGlowing ? pos.y > p.split_y : true;
            const Vec c = high ? Vec{p.color[0], p.color[1], p.color[2]}
                               : Vec{p.color_below[0], p.color_below[1], p.color_below[2]};
            const float k = dvd(mul(p.rr, ph), clamp_min(ph_p, kTinyPdf));
            next = {mul(mul(pw.x, c.x), k), mul(mul(pw.y, c.y), k), mul(mul(pw.z, c.z), k)};
            flags = kVolume | (u_v < p.rr ? kContinue : 0);
        }
    }
    if (valid && !vol_event) {  // the surface interaction (photon.rs:813-874)
        pos = at(o, d, t_hit);
        const int m = max(p.hit_material[i * p.hit_stride[4]], 0);
        const int kind = p.mat_kind[m];
        const Vec albedo = {p.mat_albedo[0][m], p.mat_albedo[1][m], p.mat_albedo[2][m]};
        const float shininess = p.mat_shininess[m];
        const Vec n = {p.hit_normal[0][i * p.hit_stride[1]], p.hit_normal[1][i * p.hit_stride[2]],
                       p.hit_normal[2][i * p.hit_stride[3]]};
        const float u_s = kb.fold(4).draw(0);
        const Key k5 = kb.fold(5);
        const Key kd = k5.fold(0xB5DF);
        const float r1 = kd.draw(0), r2 = kd.draw(1), rr = k5.fold(0xF7E5).draw(0);
        float pdf;
        bool ok;
        wi = sample_f(kind, shininess, p.mat_ior[m], n, wo, r1, r2, rr, pdf, ok);
        const Vec f = bsdf(kind, albedo, shininess, n, wo, wi);
        const float cos_raw = dot(wi, n);
        const float k = dvd(cos_raw > 0.f ? cos_raw : 1.f, mul(clamp_min(pdf, kTinyPdf), kPd));
        next = {mul(mul(pw.x, f.x), k), mul(mul(pw.y, f.y), k), mul(mul(pw.z, f.z), k)};
        if (u_s < kPd && ok)  // deposit only on the survive branch, never on mirrors
            flags = kContinue | (kind < kMirror ? kSurface : 0);
    }
    if (flags) {
        store3(p.tmp, s, i, pos);
        store3(p.tmp, s, 3 * s + i, wi);
        store3(p.tmp, s, 6 * s + i, next);
    }
    return flags;
}

__global__ void __launch_bounds__(kThreads)
shoot_interact_kernel(const __grid_constant__ ShootParams p) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    int flags = 0;
    if (i < p.n) {
        flags = interact(p, i);
        p.flags[i] = static_cast<uint8_t>(flags);
    }
    // every thread of the block reaches the counts
    const int surface = __syncthreads_count(flags & kSurface);
    const int volume = __syncthreads_count(flags & kVolume);
    const int survivors = __syncthreads_count(flags & kContinue);
    if (threadIdx.x == 0) {
        int32_t* c = p.block_counts + 3 * static_cast<int64_t>(blockIdx.x);
        c[0] = surface;
        c[1] = volume;
        c[2] = survivors;
    }
}

// One block: each thread sums a run of blocks' counts, the block scans
// the sums (warp shuffles, then one warp over the warps' totals), and each
// thread writes its blocks' first rows in place of their counts.
__global__ void __launch_bounds__(kScanThreads)
shoot_scan_kernel(const __grid_constant__ ShootParams p) {
    __shared__ int warp_sums[kScanThreads / 32][3];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int blocks = (p.n + kThreads - 1) / kThreads;
    const int per = (blocks + kScanThreads - 1) / kScanThreads;
    const int lo = min(threadIdx.x * per, blocks), hi = min(lo + per, blocks);
    int32_t* base_row = p.offsets + 4 * static_cast<int64_t>(p.level);
    int sum[3], incl[3];
    for (int k = 0; k < 3; ++k) {
        sum[k] = 0;
        for (int b = lo; b < hi; ++b) sum[k] += p.block_counts[3 * b + k];
        int v = sum[k];
        for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(kFull, v, off);
            if (lane >= off) v += y;
        }
        incl[k] = v;
        if (lane == 31) warp_sums[warp][k] = v;
    }
    __syncthreads();
    if (warp == 0) {
        for (int k = 0; k < 3; ++k) {
            const int own = warp_sums[lane][k];
            int v = own;
            for (int off = 1; off < 32; off <<= 1) {
                const int y = __shfl_up_sync(kFull, v, off);
                if (lane >= off) v += y;
            }
            warp_sums[lane][k] = v - own;
        }
    }
    __syncthreads();
    for (int k = 0; k < 3; ++k) {
        // surface and volume rows continue the earlier levels'; survivors start at 0
        int running = (k < 2 ? base_row[k] : 0) + warp_sums[warp][k] + incl[k] - sum[k];
        for (int b = lo; b < hi; ++b) {
            const int c = p.block_counts[3 * b + k];
            p.block_counts[3 * b + k] = running;
            running += c;
        }
        if (threadIdx.x == kScanThreads - 1) base_row[4 + k] = running;
    }
}

__device__ __forceinline__ void deposit(const ShootParams& p, float* rows, int64_t r, int i) {
    const int64_t s = p.stride;
    const Vec pos = load3(p.tmp, s, i);
    const Vec wo = neg(normalize(load3(p.ray, s, 3 * s + i)));
    const Vec pw = load3(p.power, s, i);
    const Vec o = load3(p.ray, s, i);
    float* out = rows + r * kRow;
    const float v[kRow] = {pos.x, pos.y, pos.z, wo.x, wo.y, wo.z,
                           pw.x, pw.y, pw.z, o.x, o.y, o.z};
#pragma unroll
    for (int c = 0; c < kRow; ++c) out[c] = v[c];
}

__global__ void __launch_bounds__(kThreads)
shoot_scatter_kernel(const __grid_constant__ ShootParams p) {
    __shared__ int warp_counts[kWarps][3];
    const int i = blockIdx.x * kThreads + threadIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int flags = i < p.n ? p.flags[i] : 0;
    const unsigned below = (1u << lane) - 1u;
    int rank[3];
    for (int k = 0; k < 3; ++k) {  // every lane of the warp takes the ballots
        const unsigned ballot = __ballot_sync(kFull, flags & (1 << k));
        rank[k] = __popc(ballot & below);
        if (lane == 0) warp_counts[warp][k] = __popc(ballot);
    }
    __syncthreads();
    if (!flags) return;
    for (int k = 0; k < 3; ++k) {
        rank[k] += p.block_counts[3 * static_cast<int64_t>(blockIdx.x) + k];
        for (int w = 0; w < warp; ++w) rank[k] += warp_counts[w][k];
    }
    if ((flags & kSurface) && rank[0] < p.s_cap) deposit(p, p.surface, rank[0], i);
    if ((flags & kVolume) && rank[1] < p.v_cap) deposit(p, p.volume, rank[1], i);
    if (flags & kContinue) {
        const int64_t s = p.stride;
        const int r = rank[2];
        store3(p.ray_out, s, r, load3(p.tmp, s, i));
        store3(p.ray_out, s, 3 * s + r, load3(p.tmp, s, 3 * s + i));
        store3(p.power_out, s, r, load3(p.tmp, s, 6 * s + i));
        reinterpret_cast<longlong2*>(p.keys_out)[r] = reinterpret_cast<const longlong2*>(p.keys)[i];
    }
}

bool valid(const ShootParams* p) {
    return p->n >= 0 && p->n <= p->stride && p->level >= 0 && p->s_cap >= 0 && p->v_cap >= 0 &&
           p->n_materials > 0 && p->medium >= kNoMedium && p->medium <= kHenyeyGreenstein;
}

}  // namespace

extern "C" int rpt_photon_shoot_level(const ShootParams* params, void* stream) {
    if (!valid(params)) return static_cast<int>(cudaErrorInvalidValue);
    if (params->n == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = (params->n + kThreads - 1) / kThreads;
    shoot_interact_kernel<<<blocks, kThreads, 0, st>>>(*params);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    shoot_scan_kernel<<<1, kScanThreads, 0, st>>>(*params);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    shoot_scatter_kernel<<<blocks, kThreads, 0, st>>>(*params);
    return static_cast<int>(cudaGetLastError());
}
