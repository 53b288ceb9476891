// K-rng: the threefry2x32 counter RNG on Hopper, one launch a call.
//
// Replaces the JAX package's random draws, `rpt_tpu/sampling.py:29-53`
// (`keys_for`, `fold`, `uniform`, `uniform2`, `uniform3`), which call
// `jax.random.split` / `fold_in` / `uniform`. Those are XLA: on the TPU
// each call compiles into one fused program, and on a GPU JAX lowers
// threefry2x32 to a hand-written kernel of its own (`gpu_prng`). The plain
// PyTorch version is `rpt_tpu_torch/ops/threefry.py::threefry2x32` and the
// `*_plain` functions beside it, a chain of int64 torch ops (one launch an
// op on the card, ~180 a call); the wrappers there run them for CPU
// tensors.
//
// The hash is `jax._src.prng._threefry2x32_lowering`, 20 rounds: the key
// schedule (k1, k2, k1 ^ k2 ^ 0x1BD11BDA), the rotations (13, 15, 26, 6)
// and (17, 29, 16, 24) in turn, a key injection after every four rounds.
// It runs on native uint32 arithmetic (wrap-around is the plain version's
// `& 0xFFFFFFFF`), rotations by __funnelshift_l. Keys are int64 words
// holding uint32 values, as the port keeps them; the kernels read the low
// 32 bits of each word and write the outputs zero-extended.
//
// Entry points (one thread an output key, or a key's words):
// - fold: out[i] = hash(key[i * key_stride], (0, data[i * data_stride]
//   mod 2^32)), or (0, data_scalar) where data is null: `fold_in`/`fold`;
//   key_stride 0 is one key for every lane.
// - split: out[i] = hash(key, (0, i)): the partitionable `jax.random.split`.
// - uniform: for counters c < count, the word hash(key[i], (0, c)) xor'd
//   into 32 bits, mapped to [0, 1) as `jax.random.uniform` maps it (23
//   bits of mantissa under the exponent of 1.0, minus 1), then lo + scale
//   * u rounded twice (__fmul_rn, __fadd_rn: torch multiplies and adds in
//   two kernels, so no FMA), written planar (count, n).
// - bits: the same words, unmapped, as int64 (n, count): `random_bits`.
//
// What bounds it: bytes. A hash is ~80 int32 operations (4 a round: add,
// funnel shift, xor; 3 a key injection; the schedule); a fold reads 16
// bytes of key (and 8 of data) and writes 16, so at 3.35 TB/s against the
// int32 rate the memory is the limit, and a call over 262,144 keys is a
// few microseconds of device time. The design does nothing more than read
// each key once, keep the state in registers and store each output once,
// coalesced (planar outputs for uniform).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ void store_key(int64_t* out, int i, uint32_t x1, uint32_t x2) {
    reinterpret_cast<longlong2*>(out)[i] =
        make_longlong2(static_cast<long long>(x1), static_cast<long long>(x2));
}

__global__ void __launch_bounds__(kThreads)
threefry_fold_kernel(const int64_t* __restrict__ keys, int key_stride,
                     const int64_t* __restrict__ data, int data_stride, uint32_t data_scalar,
                     int n, int64_t* __restrict__ out) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const int64_t* k = keys + 2 * static_cast<int64_t>(i) * key_stride;
    uint32_t x1 = 0u;
    uint32_t x2 = data ? static_cast<uint32_t>(data[static_cast<int64_t>(i) * data_stride])
                       : data_scalar;
    threefry(static_cast<uint32_t>(k[0]), static_cast<uint32_t>(k[1]), x1, x2);
    store_key(out, i, x1, x2);
}

__global__ void __launch_bounds__(kThreads)
threefry_split_kernel(const int64_t* __restrict__ key, int n, int64_t* __restrict__ out) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    uint32_t x1 = 0u, x2 = static_cast<uint32_t>(i);
    threefry(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]), x1, x2);
    store_key(out, i, x1, x2);
}

// kBits: the raw words as int64 (n, count); else floats lo + scale * u,
// planar (count, n)
template <bool kBits>
__global__ void __launch_bounds__(kThreads)
threefry_words_kernel(const int64_t* __restrict__ keys, int n, int count, float lo,
                      float scale, void* __restrict__ out) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * static_cast<int64_t>(i)]);
    const uint32_t k2 = static_cast<uint32_t>(keys[2 * static_cast<int64_t>(i) + 1]);
    for (int c = 0; c < count; ++c) {
        uint32_t x1 = 0u, x2 = static_cast<uint32_t>(c);
        threefry(k1, k2, x1, x2);
        const uint32_t bits = x1 ^ x2;
        if constexpr (kBits) {
            static_cast<int64_t*>(out)[static_cast<int64_t>(i) * count + c] =
                static_cast<long long>(bits);
        } else {
            const float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
            static_cast<float*>(out)[static_cast<int64_t>(c) * n + i] =
                __fadd_rn(lo, __fmul_rn(scale, u));
        }
    }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int rpt_threefry_fold(const int64_t* keys, int key_stride, const int64_t* data,
                                 int data_stride, uint32_t data_scalar, int n, int64_t* out,
                                 void* stream) {
    if (n <= 0) return 0;
    threefry_fold_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, key_stride, data, data_stride, data_scalar, n, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_threefry_split(const int64_t* key, int n, int64_t* out, void* stream) {
    if (n <= 0) return 0;
    threefry_split_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        key, n, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_threefry_uniform(const int64_t* keys, int n, int count, float lo,
                                    float scale, float* out, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    threefry_words_kernel<false><<<blocks(n), kThreads, 0, st>>>(keys, n, count, lo, scale, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int rpt_threefry_bits(const int64_t* keys, int n, int count, int64_t* out,
                                 void* stream) {
    if (n <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    threefry_words_kernel<true><<<blocks(n), kThreads, 0, st>>>(keys, n, count, 0.0f, 0.0f, out);
    return static_cast<int>(cudaGetLastError());
}
