// K-sweep: beam-query x point-photon sphere sweep on Hopper.
//
// Replaces the Pallas kernel `rpt_tpu/ops/sphere_sweep.py::sphere_sweep`
// (pallas_call at :111). For every camera ray it sums, over every photon
// sphere the ray pierces before its surface hit,
//     (3/pi) (1 - d^2/r^2)^2 / r^2 * exp(-ext * dd) * phase_const * power
// and multiplies by the medium colour. The plain PyTorch version is
// `rpt_tpu_torch/ops/sphere_sweep.py::sphere_sweep_plain`.
//
// What bounds it: arithmetic. Each (ray, sphere) pair costs ~30 FP32
// operations and reads nothing from device memory (the sphere tile is in
// shared memory, the ray in registers), so at 16,384 rays x ~2M spheres a
// sample is ~3.3e10 pair tests. The design keeps full FP32 with one FMA
// accumulator set per thread: the 3-wide reduction is too narrow for the
// tensor cores, and the JAX package measured that reduced precision costs
// 0.4% (sphere_sweep.py:103-104). The exponential is the accurate expf,
// evaluated only for pierced pairs. The pierce test is computed without
// FMA contraction, operation for operation as the plain version computes
// it; only the accumulation order differs.
//
// Layout: one thread per ray, 256 rays per block. The seven used sphere
// fields (px py pz r powx powy powz) stream through shared memory in tiles
// of 256. The TPU grid accumulates sequentially over sphere chunks; blocks
// on the GPU run in parallel and 16,384 rays make only 64 ray blocks, so
// the sphere axis is also split across blockIdx.y into a (S, N, 3)
// partials buffer that a second pass sums in a fixed order: deterministic,
// no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // rays per block == spheres per tile

__global__ void __launch_bounds__(kThreads)
sphere_sweep_partial(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                     const float* __restrict__ hit_t, int n,
                     const float* __restrict__ sph, int p, int p_used, int per_split,
                     float ext, float scale, float* __restrict__ partial) {
    __shared__ float s_px[kThreads], s_py[kThreads], s_pz[kThreads], s_r[kThreads];
    __shared__ float s_wx[kThreads], s_wy[kThreads], s_wz[kThreads];

    const int i = blockIdx.x * kThreads + threadIdx.x;
    const bool live = i < n;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float th = -1.f;  // a dead lane pierces nothing: sqrt(oc2) <= -1 never holds
    if (live) {
        ox = ray_o[3 * i]; oy = ray_o[3 * i + 1]; oz = ray_o[3 * i + 2];
        dx = ray_d[3 * i]; dy = ray_d[3 * i + 1]; dz = ray_d[3 * i + 2];
        th = hit_t[i];
    }
    float ax = 0.f, ay = 0.f, az = 0.f;

    const int s0 = blockIdx.y * per_split;
    const int s1 = min(s0 + per_split, p_used);
    for (int base = s0; base < s1; base += kThreads) {
        const int j = base + threadIdx.x;
        if (j < s1) {
            // spheres_t is field-major (10, p): px py pz r dx dy dz powx powy powz
            s_px[threadIdx.x] = sph[j];
            s_py[threadIdx.x] = sph[p + j];
            s_pz[threadIdx.x] = sph[2 * p + j];
            s_r[threadIdx.x] = sph[3 * p + j];
            s_wx[threadIdx.x] = sph[7 * p + j];
            s_wy[threadIdx.x] = sph[8 * p + j];
            s_wz[threadIdx.x] = sph[9 * p + j];
        }
        __syncthreads();
        const int m = min(kThreads, s1 - base);
        for (int c = 0; c < m; ++c) {
            // the pierce test rounds every operation as the torch version
            // does (no contraction into FMAs): a pair at the sphere's rim
            // or at the ray's hit time is decided the same way by both
            const float ocx = __fsub_rn(s_px[c], ox);
            const float ocy = __fsub_rn(s_py[c], oy);
            const float ocz = __fsub_rn(s_pz[c], oz);
            const float oc2 = __fadd_rn(__fadd_rn(__fmul_rn(ocx, ocx), __fmul_rn(ocy, ocy)),
                                        __fmul_rn(ocz, ocz));
            const float dd = __fadd_rn(__fadd_rn(__fmul_rn(ocx, dx), __fmul_rn(ocy, dy)),
                                       __fmul_rn(ocz, dz));
            const float dist2 = fmaxf(__fsub_rn(oc2, __fmul_rn(dd, dd)), 0.f);
            const float rad = s_r[c];
            const float r2 = fmaxf(__fmul_rn(rad, rad), 1e-30f);
            if (dd > 0.f && dist2 < r2 && rad > 0.f && sqrtf(oc2) <= th) {
                const float x = dist2 / r2;
                const float k2 = (1.f - x) * (1.f - x);
                const float w = k2 / r2 * expf(-ext * dd) * scale;
                ax += w * s_wx[c];
                ay += w * s_wy[c];
                az += w * s_wz[c];
            }
        }
        __syncthreads();
    }
    if (live) {
        float* out = partial + (static_cast<size_t>(blockIdx.y) * n + i) * 3;
        out[0] = ax;
        out[1] = ay;
        out[2] = az;
    }
}

// Second pass: out[i, c] = med_color[c] * sum_s partial[s, i, c], summed
// in split order.
__global__ void sum_partials(const float* __restrict__ partial, int splits, int n3,
                             const float* __restrict__ med_color, float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n3) return;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[static_cast<size_t>(k) * n3 + i];
    out[i] = s * med_color[i % 3];
}

}  // namespace

extern "C" int rpt_sphere_sweep(const float* ray_o, const float* ray_d, const float* hit_t,
                                int n, const float* spheres_t, int p, int p_used,
                                int per_split, int splits, float ext, float scale,
                                const float* med_color, float* partial, float* out,
                                void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((n + kThreads - 1) / kThreads, splits);
    sphere_sweep_partial<<<grid, kThreads, 0, st>>>(ray_o, ray_d, hit_t, n, spheres_t, p,
                                                    p_used, per_split, ext, scale, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n3 = 3 * n;
    sum_partials<<<(n3 + 255) / 256, 256, 0, st>>>(partial, splits, n3, med_color, out);
    return static_cast<int>(cudaGetLastError());
}
