// K-knn: exact k-nearest-neighbour queries over a uniform photon grid.
//
// Replaces the photon k-NN of the JAX package, `rpt_tpu/accel/grid.py::
// knn_query` (:605) with `_packed_topk` (:467) — XLA code shaped by the
// TPU (packed 27-cell windows, lax.top_k, a coarse escalation pass) that
// leaves <0.5% of queries truncated. This kernel is exact. The plain
// PyTorch version is chunked brute force, `rpt_tpu_torch/accel/knn.py::
// knn_plain`, and is the spec.
//
// The grid is built on the device in torch (`knn.py::build_grid`): points
// sorted by linear cell id (x-major, z fastest), `starts[c]..starts[c+1]`
// the run of cell c. Consecutive z cells of one (x, y) column are one
// contiguous run, so the kernel scans a column range in one loop.
//
// One thread per query walks Chebyshev rings of cells outward from the
// query's cell, keeping a sorted top-k list (k <= KMAX, a compile-time
// bound) in local memory. After ring r every point within the covered
// radius R_r has been seen: R_r is the distance from the query to the
// nearest unvisited cell (beyond a face of the visited cell box, on a
// side where the grid goes on, and within the grid on the other axes).
// The walk stops once the k-th distance^2 is <= R_r^2: the result is the
// exact k-NN. Column runs whose box lies farther than the current
// k-th distance are skipped.
//
// What bounds it: memory latency of the candidate reads (12 bytes each,
// scattered by cell) and the insertion into the local-memory list; the
// arithmetic is ~8 operations per candidate. Distances are computed with
// explicitly rounded operations, the same sequence the torch version
// runs, so both give bit-identical d^2.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ int cell_of(float v, float o, float inv_h, int dim) {
    int c = static_cast<int>(floorf((v - o) * inv_h));
    return min(max(c, 0), dim - 1);
}

// squared distance from q to the slab [lo, hi] along one axis, with the
// faces pushed out by `slack` (rounding of the f32 cell assignment)
__device__ __forceinline__ float gap2(float q, float lo, float hi, float slack) {
    float g = fmaxf(fmaxf(lo - slack - q, q - hi - slack), 0.f);
    return g * g;
}

// squared distance to a face `gap` away, shrunk by `slack`
__device__ __forceinline__ float side2(float gap, float slack) {
    float g = fmaxf(gap - slack, 0.f);
    return g * g;
}

template <int KMAX>
__global__ void knn_grid(const float* __restrict__ queries, int nq,
                         const float* __restrict__ pts, const int* __restrict__ starts,
                         int nx, int ny, int nz, float ox, float oy, float oz, float h,
                         float inv_h, int k, int* __restrict__ out_idx,
                         float* __restrict__ out_d2) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nq) return;
    const float qx = queries[3 * i], qy = queries[3 * i + 1], qz = queries[3 * i + 2];
    float bd[KMAX];
    int bi[KMAX];
    for (int j = 0; j < k; ++j) {
        bd[j] = CUDART_INF_F;
        bi[j] = -1;
    }
    const int cx = cell_of(qx, ox, inv_h, nx);
    const int cy = cell_of(qy, oy, inv_h, ny);
    const int cz = cell_of(qz, oz, inv_h, nz);
    const float slack = 1e-3f * h;
    const int max_r = max(nx, max(ny, nz));
    // squared distance from the query to the grid's extent on each axis
    // (0 inside): a query outside the grid is that far from every point
    const float out_x = gap2(qx, ox, ox + nx * h, slack);
    const float out_y = gap2(qy, oy, oy + ny * h, slack);
    const float out_z = gap2(qz, oz, oz + nz * h, slack);

    for (int r = 0; r <= max_r; ++r) {
        const int x0 = max(cx - r, 0), x1 = min(cx + r, nx - 1);
        const int y0 = max(cy - r, 0), y1 = min(cy + r, ny - 1);
        const int z0 = max(cz - r, 0), z1 = min(cz + r, nz - 1);
        for (int x = x0; x <= x1; ++x) {
            const float gx = gap2(qx, ox + x * h, ox + (x + 1) * h, slack);
            for (int y = y0; y <= y1; ++y) {
                const float gxy = gx + gap2(qy, oy + y * h, oy + (y + 1) * h, slack);
                if (gxy > bd[k - 1]) continue;
                const bool edge = (abs(x - cx) == r) || (abs(y - cy) == r);
                // a column on the ring's x/y boundary contributes its whole
                // z range; an interior column only its two z end cells
                for (int part = 0; part < (edge ? 1 : 2); ++part) {
                    int za, zb;
                    if (edge) {
                        za = z0; zb = z1;
                    } else if (part == 0) {
                        za = zb = cz - r;
                    } else {
                        za = zb = cz + r;
                    }
                    if (za < 0 || zb >= nz || za > zb) continue;
                    const float d2min =
                        gxy + gap2(qz, oz + za * h, oz + (zb + 1) * h, slack);
                    if (d2min > bd[k - 1]) continue;
                    const int col = (x * ny + y) * nz;
                    const int a = starts[col + za], b = starts[col + zb + 1];
                    for (int j = a; j < b; ++j) {
                        const float dx = __fsub_rn(pts[3 * j], qx);
                        const float dy = __fsub_rn(pts[3 * j + 1], qy);
                        const float dz = __fsub_rn(pts[3 * j + 2], qz);
                        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                                   __fmul_rn(dz, dz));
                        if (d2 < bd[k - 1]) {
                            int s = k - 1;
                            while (s > 0 && bd[s - 1] > d2) {
                                bd[s] = bd[s - 1];
                                bi[s] = bi[s - 1];
                                --s;
                            }
                            bd[s] = d2;
                            bi[s] = j;
                        }
                    }
                }
            }
        }
        // covered radius^2 after ring r: an unvisited cell lies beyond one
        // face of the visited box (on a side where the grid goes on) and
        // inside the grid on the other two axes
        float cover2 = CUDART_INF_F;
        if (cx - r > 0) cover2 = fminf(cover2, side2(qx - (ox + (cx - r) * h), slack) + out_y + out_z);
        if (cx + r < nx - 1) cover2 = fminf(cover2, side2(ox + (cx + r + 1) * h - qx, slack) + out_y + out_z);
        if (cy - r > 0) cover2 = fminf(cover2, side2(qy - (oy + (cy - r) * h), slack) + out_x + out_z);
        if (cy + r < ny - 1) cover2 = fminf(cover2, side2(oy + (cy + r + 1) * h - qy, slack) + out_x + out_z);
        if (cz - r > 0) cover2 = fminf(cover2, side2(qz - (oz + (cz - r) * h), slack) + out_x + out_y);
        if (cz + r < nz - 1) cover2 = fminf(cover2, side2(oz + (cz + r + 1) * h - qz, slack) + out_x + out_y);
        if (cover2 == CUDART_INF_F) break;  // every cell visited
        if (bd[k - 1] <= cover2) break;
    }
    for (int j = 0; j < k; ++j) {
        out_idx[static_cast<size_t>(i) * k + j] = bi[j];
        out_d2[static_cast<size_t>(i) * k + j] = bd[j];
    }
}

template <int KMAX>
cudaError_t launch(const float* q, int nq, const float* pts, const int* starts, int nx, int ny,
                   int nz, float ox, float oy, float oz, float h, float inv_h, int k,
                   int* out_idx, float* out_d2, cudaStream_t st) {
    constexpr int threads = 128;
    knn_grid<KMAX><<<(nq + threads - 1) / threads, threads, 0, st>>>(
        q, nq, pts, starts, nx, ny, nz, ox, oy, oz, h, inv_h, k, out_idx, out_d2);
    return cudaGetLastError();
}

}  // namespace

extern "C" int rpt_knn_grid(const float* queries, int nq, const float* pts, const int* starts,
                            int nx, int ny, int nz, float ox, float oy, float oz, float h,
                            float inv_h, int k, int* out_idx, float* out_d2, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (k <= 16) {
        err = launch<16>(queries, nq, pts, starts, nx, ny, nz, ox, oy, oz, h, inv_h, k,
                         out_idx, out_d2, st);
    } else if (k <= 32) {
        err = launch<32>(queries, nq, pts, starts, nx, ny, nz, ox, oy, oz, h, inv_h, k,
                         out_idx, out_d2, st);
    } else if (k <= 64) {
        err = launch<64>(queries, nq, pts, starts, nx, ny, nz, ox, oy, oz, h, inv_h, k,
                         out_idx, out_d2, st);
    } else if (k <= 128) {
        err = launch<128>(queries, nq, pts, starts, nx, ny, nz, ox, oy, oz, h, inv_h, k,
                          out_idx, out_d2, st);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err);
}
