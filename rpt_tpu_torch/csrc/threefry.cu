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
// `& 0xFFFFFFFF`), rotations by __funnelshift_l, in `threefry.cuh`, which
// K-shoot (`photon_shoot.cu`) includes too. Keys are int64 words
// holding uint32 values, as the port keeps them; the kernels read the low
// 32 bits of each word and write the outputs zero-extended.
//
// Entry points (one thread an output key, or a key's words, or a lane):
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
// - draw (derive and draw): a lane's key from its key row (one 16-byte
//   load), folded in registers with the lane's data word where there is
//   one, then with a chain of up to kMaxTags static tags; from that key up
//   to kMaxDraws draws, each a suffix of up to kMaxSuffix more tags and
//   `count` words mapped as uniform maps them, all written planar into one
//   (sum of counts, n) float buffer; and, where asked, the key itself. It
//   is `uniform(fold(...fold(fold_in(key, data), t0)..., tN))` of the JAX
//   package's call sites in one launch: the chain of folds, each a launch
//   writing and reading a key tensor before, stays in registers, and
//   several draws of one site share the launch. The chain and the draws
//   arrive by value in the kernel's parameter struct (`__grid_constant__`,
//   read from the constant bank, the same word for every thread): no copy
//   to the device a call.
//
// What bounds it: bytes for fold, split, uniform and bits; for a draw with
// a chain of folds, its hashes (a lane reads 16 bytes of key and 8 of data
// and writes 4 a word, against ~80 int32 operations a hash and several
// hashes a lane). A hash is ~80 int32 operations (4 a round: add,
// funnel shift, xor; 3 a key injection; the schedule); a fold reads 16
// bytes of key (and 8 of data) and writes 16, so at 3.35 TB/s against the
// int32 rate the memory is the limit, and a call over 262,144 keys is a
// few microseconds of device time, most of it the launch's own. The design
// reads each key once, keeps the state in registers and stores each output
// once, coalesced (planar outputs for uniform and draw); the draw form takes
// the launches of a whole fold chain and its draws into one.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

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
            const float u = unit_float(bits);
            static_cast<float*>(out)[static_cast<int64_t>(c) * n + i] =
                __fadd_rn(lo, __fmul_rn(scale, u));
        }
    }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// The draw form's arguments, passed by value (ops/threefry.py mirrors the
// layout in ctypes: `_DrawSpec`, `_DrawParams`).
constexpr int kMaxTags = 8;
constexpr int kMaxDraws = 8;
constexpr int kMaxSuffix = 2;

struct DrawSpec {
    uint32_t tags[kMaxSuffix];  // the suffix, folded after the chain
    int n_tags;
    int count;  // words: out rows row .. row + count - 1
    float lo;
    float scale;
};

struct DrawParams {
    const int64_t* keys;  // key rows (2 int64 words), row i * key_stride
    const int64_t* data;  // the lane's data word, i * data_stride, or null
    float* out;           // (sum of counts, n), planar
    int64_t* key_out;     // (n, 2) the chain's key, or null
    int key_stride;
    int data_stride;
    int n;
    int n_tags;
    int n_draws;
    uint32_t tags[kMaxTags];
    DrawSpec draws[kMaxDraws];
};

static_assert(sizeof(DrawSpec) == 24, "DrawSpec layout (ops/threefry.py _DrawSpec)");
static_assert(offsetof(DrawParams, key_stride) == 32 && offsetof(DrawParams, tags) == 52 &&
                  offsetof(DrawParams, draws) == 84 && sizeof(DrawParams) == 280,
              "DrawParams layout (ops/threefry.py _DrawParams)");

namespace {

// One thread a lane.
__global__ void __launch_bounds__(kThreads)
threefry_draw_kernel(const __grid_constant__ DrawParams p) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= p.n) return;
    const longlong2 key =
        reinterpret_cast<const longlong2*>(p.keys)[static_cast<int64_t>(i) * p.key_stride];
    uint32_t k1 = static_cast<uint32_t>(key.x), k2 = static_cast<uint32_t>(key.y);
    if (p.data) fold_in(k1, k2, static_cast<uint32_t>(p.data[static_cast<int64_t>(i) *
                                                              p.data_stride]));
    for (int t = 0; t < p.n_tags; ++t) fold_in(k1, k2, p.tags[t]);
    if (p.key_out) store_key(p.key_out, i, k1, k2);
    int row = 0;
    for (int d = 0; d < p.n_draws; ++d) {
        const DrawSpec& spec = p.draws[d];
        uint32_t s1 = k1, s2 = k2;
        for (int t = 0; t < spec.n_tags; ++t) fold_in(s1, s2, spec.tags[t]);
        for (int c = 0; c < spec.count; ++c) {
            uint32_t x1 = 0u, x2 = static_cast<uint32_t>(c);
            threefry(s1, s2, x1, x2);
            const float u = unit_float(x1 ^ x2);
            p.out[static_cast<int64_t>(row + c) * p.n + i] =
                __fadd_rn(spec.lo, __fmul_rn(spec.scale, u));
        }
        row += spec.count;
    }
}

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

extern "C" int rpt_threefry_draw(const DrawParams* params, void* stream) {
    if (params->n <= 0) return 0;
    threefry_draw_kernel<<<blocks(params->n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        *params);
    return static_cast<int>(cudaGetLastError());
}
