// K-estimate: the photon map's estimates at the camera's hits, on Hopper.
//
// Replaces the chain of torch ops around the k-NN gathers of the camera
// pass's estimates (`rpt_tpu/integrators/photon.py`: `surface_estimate`,
// the disk estimate on surfaces with its occlusion recheck, photon.rs:
// 327-375; `volume_estimate_point`, the point-query estimate in a medium,
// photon.rs:384-437). The plain PyTorch versions are `surface_plain` and
// `point_plain` in `rpt_tpu_torch/ops/photon_estimate.py`, where the
// wrappers `surface` and `point` run this file for CUDA tensors. K-knn
// (`knn.cu`) gathers the photons between the calls, and K-prim and K-dense
// recheck them; this file does everything the chain does around those.
//
// Three entry points, each one kernel on the stream, none synchronising:
// - prep, one thread a lane: for the point query, the free flight (the
//   lane's key folded and drawn in registers, `threefry.cuh`), whether the
//   lane scatters in the medium before its hit, and the collision, the
//   volume gather's query; for both estimates, the hit point, the surface
//   gather's query (zero where a lane takes no part, as the chain's
//   `where` leaves it).
// - pairs, one thread a (lane, photon) pair of the surface gather: the
//   recheck ray from the photon towards the hit point and its limit
//   `dist (1 - shadow_eps)`, planar in the layout `occluded` takes; the
//   limit is -1 where the chain's answer is thrown away (an invalid
//   answer, a lane with no hit, a lane that scatters in the medium), and
//   the any-hit kernels skip such lanes.
// - finish, a warp a lane: only the branch the lane takes. In the medium:
//   the phase times the photon's power and the medium's colour, summed
//   over the volume gather's answers, over the sphere of the farthest, the
//   extinction and the free flight's pdf. On a surface: the bsdf times the
//   photon's power and the clamped cosine, summed over the surface
//   gather's valid and unoccluded answers, plus the emitted term, over the
//   disk of the farthest, attenuated over the chance of getting that far
//   in a medium. A lane writes its colour, (3, n) planar.
// The chain's (n k, 12) row tensors and its n k lanes of bsdf and phase
// are never made.
//
// Rounding: as the chain's torch kernels round on the card
// (`photon_common.cuh`). The k-sums take the order of torch's reduction of
// an (n, k, 3) tensor over k on the card (ATen's `Reduce.cuh`: the reduced
// dimension is not the fastest-moving one, so one thread sums one output
// in `thread_reduce_impl` with four accumulators, element j into
// accumulator j % 4 in order, then ((a0 + a1) + a2) + a3; inputs are not
// split across threads below 16 x the block's height, which holds for
// every k <= 128): here twelve threads of the warp hold the four
// accumulators of the three channels.
//
// What bounds it: bytes. Prep reads a lane's ray, hit and key (~70 bytes)
// and writes its queries and flight (28); pairs read a pair's answer (12
// bytes), its photon's position and the lane's hit point and write the
// recheck ray (28); finish reads a pair's answer, its photon's direction
// and power (36) and the recheck's answer. K-knn's gathers take far longer.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "photon_common.cuh"
#include "threefry.cuh"

constexpr int kRow = 12;    // a photon: pos, wo, power, ray origin
constexpr int kMaxK = 128;  // accel/knn.py MAX_K
constexpr int kMaxTags = 8;  // ops/threefry.py MAX_TAGS

struct EstimateParams {
    const float* lane[10];         // ray ox oy oz dx dy dz, hit time, hit normal x y z:
    const int32_t* hit_material;   //   lane i at i * lane_stride[c]; the hit's material
    int64_t lane_stride[11];
    const int64_t* keys;           // the free flight's key rows (rows, 2), row i * key_stride,
    const int64_t* key_data;       //   folded with data word i * data_stride where given,
    const int32_t* mat_kind;       //   then with the tags; the material table's kind,
    const float* mat[5];           //   albedo x y z, emittance, shininess, row m at
    int64_t mat_stride[6];         //   m * mat_stride[c]
    const float* v_rows;           // the volume photons (V, kRow), grid order
    const float* s_rows;           // the surface photons (S, kRow), grid order
    const int64_t* v_idx;          // the volume gather's answers (n, kv)
    const float* v_d2;
    const int64_t* s_idx;          // the surface gather's answers (n, k)
    const float* s_d2;
    const uint8_t* occluded;       // (n k,) the recheck's answers, where `recheck`
    float* v_query;                // (n, 3) the volume gather's queries
    float* s_query;                // (n, 3) the surface gather's queries
    float* flight;                 // (n,) the free flight's distance
    float* shadow;                 // (7, n k): the recheck rays' origins, directions, limits
    float* out;                    // (3, n): the colour
    int n;
    int k;                         // the surface gather's size
    int kv;                        // the volume gather's size
    int key_stride;
    int data_stride;
    int n_tags;
    uint32_t tags[kMaxTags];
    int point;                     // the point-query estimate (a medium); else the surface's
    int volume;                    // a volume cloud to gather from
    int surface;                   // a surface cloud to gather from
    int recheck;                   // the occlusion recheck
    float shadow_scale;            // 1 - shadow_eps
    // the medium, as ops/photon_shoot.py `_medium_constants` writes it
    int medium;                    // kNoMedium .. kHenyeyGreenstein
    float ext;                     // sigma_a + sigma_s
    float rr;
    float phase;                   // the isotropic kinds' phase
    float pdf;
    float color[3];                // the medium's colour (glowing fog: above split_y)
    float color_below[3];          // glowing fog: below split_y
    float split_y;
    int hg_invert;
    float hg_two_g;                // 2 g
    float hg_one_plus_g;
    float hg_one_minus_g2;
    float hg_one_plus_g2;          // 1 + g^2
    float hg_inv_two_g;
    float hg_norm;                 // (1 - g^2) / (4 pi)
};

static_assert(offsetof(EstimateParams, hit_material) == 80 &&
                  offsetof(EstimateParams, lane_stride) == 88 &&
                  offsetof(EstimateParams, keys) == 176 && offsetof(EstimateParams, mat) == 200 &&
                  offsetof(EstimateParams, mat_stride) == 240 &&
                  offsetof(EstimateParams, v_rows) == 288 &&
                  offsetof(EstimateParams, occluded) == 336 &&
                  offsetof(EstimateParams, out) == 376 && offsetof(EstimateParams, n) == 384 &&
                  offsetof(EstimateParams, tags) == 408 && offsetof(EstimateParams, point) == 440 &&
                  offsetof(EstimateParams, shadow_scale) == 456 &&
                  offsetof(EstimateParams, medium) == 460 &&
                  offsetof(EstimateParams, color) == 480 &&
                  offsetof(EstimateParams, split_y) == 504 &&
                  offsetof(EstimateParams, hg_norm) == 532 && sizeof(EstimateParams) == 536,
              "EstimateParams layout (ops/photon_estimate.py _EstimateParams)");

namespace {

constexpr int kThreads = 256;    // prep and pairs: a block's lanes or pairs
constexpr int kFinishWarps = 4;  // finish: a block's lanes, a warp each
constexpr unsigned kFull = 0xffffffffu;

constexpr float kPi = static_cast<float>(3.141592653589793);                    // math.pi
constexpr float kSphere = static_cast<float>((4.0 / 3.0) * 3.141592653589793);  // (4/3) pi
constexpr float kTinyVolume = static_cast<float>(1e-30);  // the point query's clamps
constexpr float kTinyDist = static_cast<float>(1e-20);    // the recheck's direction

__device__ __forceinline__ float lane_value(const EstimateParams& p, int c, int64_t i) {
    return p.lane[c][i * p.lane_stride[c]];
}

__device__ __forceinline__ Vec lane_vec(const EstimateParams& p, int c, int64_t i) {
    return {lane_value(p, c, i), lane_value(p, c + 1, i), lane_value(p, c + 2, i)};
}

__device__ __forceinline__ Vec row3(const float* rows, int64_t idx, int c) {
    const float* r = rows + idx * kRow + c;
    return {r[0], r[1], r[2]};
}

// Whether the point query's lane scatters in the medium before its hit
// (`~hit.valid | (d < hit.time)`); a surface estimate's lane never does.
__device__ __forceinline__ bool in_volume(const EstimateParams& p, int64_t i, float t_hit) {
    return p.point && (!isfinite(t_hit) || p.flight[i] < t_hit);
}

__global__ void __launch_bounds__(kThreads) estimate_prep_kernel(const __grid_constant__
                                                                 EstimateParams p) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
    if (i >= p.n) return;
    const Vec o = lane_vec(p, 0, i), d = lane_vec(p, 3, i);
    const float t_hit = lane_value(p, 6, i);
    const bool valid = isfinite(t_hit);
    if (p.point) {  // medium.sample_d: the key's fold chain, one uniform
        const longlong2 row = reinterpret_cast<const longlong2*>(p.keys)[i * p.key_stride];
        uint32_t k1 = static_cast<uint32_t>(row.x), k2 = static_cast<uint32_t>(row.y);
        if (p.key_data) fold_in(k1, k2, static_cast<uint32_t>(p.key_data[i * p.data_stride]));
        for (int t = 0; t < p.n_tags; ++t) fold_in(k1, k2, p.tags[t]);
        const float u = Key{k1, k2}.draw(0);
        const float dist = dvd(-logf(clamp_min(u, kTiny)), p.ext);
        p.flight[i] = dist;
        const Vec c = (!valid || dist < t_hit) ? at(o, d, dist) : Vec{0.f, 0.f, 0.f};
        store3(p.v_query, 1, 3 * i, c);
    }
    store3(p.s_query, 1, 3 * i, valid ? at(o, d, t_hit) : Vec{0.f, 0.f, 0.f});
}

__global__ void __launch_bounds__(kThreads) estimate_pairs_kernel(const __grid_constant__
                                                                  EstimateParams p) {
    const int64_t m = static_cast<int64_t>(p.n) * p.k;
    const int64_t e = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
    if (e >= m) return;
    const int64_t i = e / p.k;
    const float t_hit = lane_value(p, 6, i);
    const bool ok = isfinite(t_hit) && !in_volume(p, i, t_hit) && isfinite(p.s_d2[e]);
    const Vec pp = row3(p.s_rows, p.s_idx[e], 0);
    const Vec pos = {p.s_query[3 * i], p.s_query[3 * i + 1], p.s_query[3 * i + 2]};
    const Vec disp = {sub(pos.x, pp.x), sub(pos.y, pp.y), sub(pos.z, pp.z)};
    const float dist = sqrtf(dot(disp, disp));
    const float c = clamp_min(dist, kTinyDist);
    store3(p.shadow, m, e, pp);
    store3(p.shadow, m, 3 * m + e, Vec{dvd(disp.x, c), dvd(disp.y, c), dvd(disp.z, c)});
    p.shadow[6 * m + e] = ok ? mul(dist, p.shadow_scale) : -1.f;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
    return v;
}

// The warp's sum of its lane's k terms c[channel][j], in torch's order
// (see the head of this file). Every thread of the warp takes part.
__device__ __forceinline__ Vec warp_sum(const float (*c)[kMaxK], int k, int lane) {
    float s = 0.f;
    if (lane < 12) {
        for (int j = lane & 3; j < k; j += 4) s = add(s, c[lane >> 2][j]);
    }
    float r[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        const float a0 = __shfl_sync(kFull, s, 4 * ch), a1 = __shfl_sync(kFull, s, 4 * ch + 1);
        const float a2 = __shfl_sync(kFull, s, 4 * ch + 2), a3 = __shfl_sync(kFull, s, 4 * ch + 3);
        r[ch] = add(add(add(a0, a1), a2), a3);
    }
    return {r[0], r[1], r[2]};
}

__device__ __forceinline__ void put(float (*c)[kMaxK], int j, const Vec& v) {
    c[0][j] = v.x;
    c[1][j] = v.y;
    c[2][j] = v.z;
}

// The volume term of lane i (the chain's `vol_color`): the warp's threads
// take the answers j = lane, lane + 32, ...
__device__ Vec volume_term(const EstimateParams& p, int64_t i, int lane, const Vec& wo,
                           float t_d, float d_pdf, float (*c)[kMaxK]) {
    const Vec mc = medium_color(p, Vec{0.f, p.v_query[3 * i + 1], 0.f});
    float far2 = 0.f;
    for (int j = lane; j < p.kv; j += 32) {
        const int64_t e = i * p.kv + j;
        const float d2 = p.v_d2[e];
        Vec v = {0.f, 0.f, 0.f};
        if (isfinite(d2)) {
            far2 = fmaxf(far2, d2);
            const int64_t idx = p.v_idx[e];
            const Vec dir = row3(p.v_rows, idx, 3), pw = row3(p.v_rows, idx, 6);
            const float ph = p.medium == kHenyeyGreenstein ? hg_phase(p, wo, dir) : p.phase;
            v = {mul(mul(pw.x, mc.x), ph), mul(mul(pw.y, mc.y), ph), mul(mul(pw.z, mc.z), ph)};
        }
        put(c, j, v);
    }
    far2 = warp_max(far2);
    __syncwarp();
    const Vec acc = warp_sum(c, p.kv, lane);
    if (!(far2 > 0.f)) return {0.f, 0.f, 0.f};
    const float denom = mul(powf(clamp_min(far2, kTinyVolume), 1.5f), kSphere);
    const float w = dvd(t_d, clamp_min(d_pdf, kTinyVolume));
    return {mul(dvd(dvd(acc.x, denom), p.ext), w), mul(dvd(dvd(acc.y, denom), p.ext), w),
            mul(dvd(dvd(acc.z, denom), p.ext), w)};
}

// The surface estimate of lane i, which hits (the chain's
// `color * inv`): the warp's threads take the answers j = lane, lane + 32, ...
__device__ Vec surface_term(const EstimateParams& p, int64_t i, int lane, const Vec& wo,
                            float (*c)[kMaxK]) {
    const int64_t m = max(p.hit_material[i * p.lane_stride[10]], 0);
    const int kind = p.mat_kind[m * p.mat_stride[0]];
    const Vec albedo = {p.mat[0][m * p.mat_stride[1]], p.mat[1][m * p.mat_stride[2]],
                        p.mat[2][m * p.mat_stride[3]]};
    const float emittance = p.mat[3][m * p.mat_stride[4]];
    const float shininess = p.mat[4][m * p.mat_stride[5]];
    const Vec nrm = lane_vec(p, 7, i);
    float far2 = 0.f;
    for (int j = lane; j < p.k; j += 32) {
        const int64_t e = i * p.k + j;
        const float d2 = p.s_d2[e];
        Vec v = {0.f, 0.f, 0.f};
        if (isfinite(d2)) {
            far2 = fmaxf(far2, d2);
            if (!(p.recheck && p.occluded[e])) {
                const int64_t idx = p.s_idx[e];
                const Vec dir = row3(p.s_rows, idx, 3), pw = row3(p.s_rows, idx, 6);
                const Vec f = bsdf(kind, albedo, shininess, nrm, wo, dir);
                const float cosine = clamp(dot(dir, nrm), 0.f, 1.f);
                v = {mul(mul(f.x, pw.x), cosine), mul(mul(f.y, pw.y), cosine),
                     mul(mul(f.z, pw.z), cosine)};
            }
        }
        put(c, j, v);
    }
    far2 = warp_max(far2);
    __syncwarp();
    const Vec acc = warp_sum(c, p.k, lane);
    // materials' color_query() * emittance_query(): lights' own emission
    const bool lit = kind <= kPhong;
    const Vec glow = lit ? albedo : Vec{0.f, 0.f, 0.f};
    const float e = lit ? emittance : 0.f;
    const float inv = far2 > 0.f ? dvd(1.f, mul(far2, kPi)) : 0.f;
    return {mul(add(mul(glow.x, e), acc.x), inv), mul(add(mul(glow.y, e), acc.y), inv),
            mul(add(mul(glow.z, e), acc.z), inv)};
}

__global__ void __launch_bounds__(kFinishWarps * 32) estimate_finish_kernel(
    const __grid_constant__ EstimateParams p) {
    __shared__ float terms[kFinishWarps][3][kMaxK];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t i = blockIdx.x * static_cast<int64_t>(kFinishWarps) + warp;
    if (i >= p.n) return;  // the whole warp
    float (*c)[kMaxK] = terms[warp];
    const Vec wo = neg(normalize(lane_vec(p, 3, i)));
    const float t_hit = lane_value(p, 6, i);
    const bool valid = isfinite(t_hit);
    Vec color = {0.f, 0.f, 0.f};
    if (p.point) {  // every branch below is the warp's
        const float dist = p.flight[i];
        const float t_d = expf(mul(-p.ext, dist));  // transmittence(ray, d)
        const float d_cdf = sub(1.f, t_d);
        if (!valid || dist < t_hit) {
            if (p.volume) color = volume_term(p, i, lane, wo, t_d, mul(p.ext, t_d), c);
        } else {
            const Vec s = p.surface ? surface_term(p, i, lane, wo, c) : Vec{0.f, 0.f, 0.f};
            const float w = dvd(expf(mul(-p.ext, t_hit)), clamp_min(sub(1.f, d_cdf), kTinyVolume));
            color = scale(s, w);
        }
    } else if (valid) {
        color = surface_term(p, i, lane, wo, c);
    }
    if (lane == 0) store3(p.out, p.n, i, color);
}

int blocks(int64_t n, int per) { return static_cast<int>((n + per - 1) / per); }

bool valid(const EstimateParams* p) {
    const bool gathers = (!p->surface || (p->k >= 1 && p->k <= kMaxK)) &&
                         (!p->volume || (p->kv >= 1 && p->kv <= kMaxK));
    return p->n >= 0 && gathers && p->n_tags >= 0 && p->n_tags <= kMaxTags &&
           p->medium >= kNoMedium && p->medium <= kHenyeyGreenstein &&
           (!p->point || p->medium != kNoMedium);
}

}  // namespace

extern "C" int rpt_estimate_prep(const EstimateParams* params, void* stream) {
    if (!valid(params)) return static_cast<int>(cudaErrorInvalidValue);
    if (params->n == 0) return 0;
    estimate_prep_kernel<<<blocks(params->n, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(*params);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_estimate_pairs(const EstimateParams* params, void* stream) {
    if (!valid(params)) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t m = static_cast<int64_t>(params->n) * params->k;
    if (m == 0) return 0;
    estimate_pairs_kernel<<<blocks(m, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        *params);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_estimate_finish(const EstimateParams* params, void* stream) {
    if (!valid(params)) return static_cast<int>(cudaErrorInvalidValue);
    if (params->n == 0) return 0;
    estimate_finish_kernel<<<blocks(params->n, kFinishWarps), kFinishWarps * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(*params);
    return static_cast<int>(cudaGetLastError());
}
