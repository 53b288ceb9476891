// The device code the photon kernels share: K-shoot (`photon_shoot.cu`,
// a shoot level's interaction) and K-estimate (`photon_estimate.cu`, the
// estimates at the camera's hits). Both are held bit for bit to chains of
// torch ops, so every operation here rounds as the chain's torch kernels
// do on the card: __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn in the chain's
// order (Vec3.dot sums (x + y) + z), so nvcc contracts nothing into an FMA
// that torch rounds twice; `Ray.at` in float64, rounded once to float32;
// logf, expf, sqrtf, cosf, sinf, powf and rsqrtf as torch's kernels call
// them; a Python number in a torch op is the float32 it rounds to,
// `scalar / tensor` is `reciprocal(tensor) * scalar` and `tensor / scalar`
// is `tensor * (1 / scalar)` with the reciprocal taken in float32 (torch's
// CUDA division by a CPU scalar); `x ** 2` is x * x; clamps pass NaN on.
//
// Here: the medium and material kinds, the rounding helpers, `Vec`, the
// key of a lane (`threefry.cuh`'s hash), the uniform sphere, the medium's
// colour and Henyey-Greenstein phase (read from a parameter block that
// holds the medium's constants under the names `ops/photon_shoot.py`
// `_medium_constants` gives them), and `materials.bsdf`.

#pragma once

#include <stdint.h>

#include "threefry.cuh"

namespace {

// medium kinds: rpt_tpu_torch/medium.py ISOTROPIC, GLOWING, HENYEY_GREENSTEIN
constexpr int kNoMedium = 0;
constexpr int kIsotropic = 1;
constexpr int kGlowing = 2;
constexpr int kHenyeyGreenstein = 3;

// materials.py kinds
constexpr int kLambertian = 0;
constexpr int kPhong = 1;
constexpr int kMirror = 2;
constexpr int kTransmissive = 3;

// Python's numbers as the chain's torch ops round them
constexpr float kTwoPi = static_cast<float>(6.283185307179586);   // sampling.TWO_PI
constexpr float kInvPi = static_cast<float>(0.3183098861837907);  // sampling.INV_PI
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

// the medium's colour at a point (the glowing fog's by its height)
template <class P>
__device__ __forceinline__ Vec medium_color(const P& p, const Vec& pos) {
    const bool high = p.medium == kGlowing ? pos.y > p.split_y : true;
    return high ? Vec{p.color[0], p.color[1], p.color[2]}
                : Vec{p.color_below[0], p.color_below[1], p.color_below[2]};
}

// medium.henyey_greenstein's phase(wo, wi)
template <class P>
__device__ __forceinline__ float hg_phase(const P& p, const Vec& wo, const Vec& wi) {
    const float cos_t = dot(neg(wo), wi);
    const float denom = powf(add(mul(p.hg_two_g, cos_t), p.hg_one_plus_g2), 1.5f);
    return mul(dvd(1.f, clamp_min(denom, kTinyDenom)), p.hg_norm);
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

}  // namespace
