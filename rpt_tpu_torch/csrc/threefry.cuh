// threefry2x32, the counter hash of K-rng (`threefry.cu`) and of every
// kernel that draws its own random numbers in registers (K-shoot,
// `photon_shoot.cu`), so all of them derive the same bits from a key.
//
// The hash is `jax._src.prng._threefry2x32_lowering`, 20 rounds: the key
// schedule (k1, k2, k1 ^ k2 ^ 0x1BD11BDA), the rotations (13, 15, 26, 6)
// and (17, 29, 16, 24) in turn, a key injection after every four rounds,
// on native uint32 arithmetic, rotations by __funnelshift_l.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ void mix(uint32_t& x1, uint32_t& x2, int r) {
    x1 += x2;
    x2 = __funnelshift_l(x2, x2, r);
    x2 ^= x1;
}

__device__ __forceinline__ void mix4(uint32_t& x1, uint32_t& x2, int a, int b, int c, int d) {
    mix(x1, x2, a);
    mix(x1, x2, b);
    mix(x1, x2, c);
    mix(x1, x2, d);
}

// threefry2x32 of the counter (x1, x2) under the key (k1, k2), in place
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t& x1, uint32_t& x2) {
    const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
    x1 += k1;
    x2 += k2;
    mix4(x1, x2, 13, 15, 26, 6);
    x1 += k2;
    x2 += k3 + 1u;
    mix4(x1, x2, 17, 29, 16, 24);
    x1 += k3;
    x2 += k1 + 2u;
    mix4(x1, x2, 13, 15, 26, 6);
    x1 += k1;
    x2 += k2 + 3u;
    mix4(x1, x2, 17, 29, 16, 24);
    x1 += k2;
    x2 += k3 + 4u;
    mix4(x1, x2, 13, 15, 26, 6);
    x1 += k3;
    x2 += k1 + 5u;
}

// `jax.random.fold_in`: the key (k1, k2) becomes the hash of the counter
// (0, data) under it
__device__ __forceinline__ void fold_in(uint32_t& k1, uint32_t& k2, uint32_t data) {
    uint32_t x1 = 0u, x2 = data;
    threefry(k1, k2, x1, x2);
    k1 = x1;
    k2 = x2;
}

// 32 random bits to [0, 1) as `jax.random.uniform` maps them: 23 bits of
// mantissa under the exponent of 1.0, minus 1
__device__ __forceinline__ float unit_float(uint32_t bits) {
    return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

}  // namespace
