// K-knn: exact k-nearest-neighbour queries over a photon cloud cut into
// cells of sixteen levels of detail.
//
// Replaces the photon k-NN of the JAX package, `rpt_tpu/accel/grid.py::
// knn_query` (:605) with `_packed_topk` (:467) — XLA code shaped by the
// TPU (packed 27-cell windows, lax.top_k, a coarse escalation pass) that
// leaves <0.5% of queries truncated — and the radius pass built on it,
// `rpt_tpu/integrators/photon.py::_knn_radius_device` (:459). These
// kernels are exact. The plain PyTorch versions are chunked brute force,
// `rpt_tpu_torch/accel/knn.py::knn_plain` (the spec), and the same walk
// in torch ops, `knn_levels_plain`.
//
// The grid (`knn.py::build_grid`): a cube of 2^16 finest cells an axis
// over the cloud, the points sorted by the 48-bit Morton code of their
// finest cell and stored as 16-byte rows beside the sorted codes. A cell
// of level l (2^l finest cells an axis) is the Morton prefix `code >> 3l`
// and its points are one run of the array, found by two binary searches
// of the codes: no table per level, so empty space costs nothing and the
// cells can be as fine as the cloud is dense.
//
// What bounded the earlier kernel (one thread a query walking Chebyshev
// rings of one uniform grid): the cell size came from the bounding box,
// and a photon cloud is a dense body (the lit box) inside a thin halo two
// orders of magnitude wider (photons that left through the open side), so
// the body fell into a few cells of ~10^5 points and every query scanned
// them serially; the top-k list, indexed by a runtime k, lived in local
// memory; points were three scattered 4-byte loads. What this design does:
//
// * Levels. A query takes the finest level whose own cell holds >= `want`
//   points and gathers the k nearest of the 3x3x3 cells around it there.
//   The result stands once the k-th distance^2 is <= the covered
//   radius^2: the distance to the nearest cell outside the block, beyond a
//   face of it on a side where the grid goes on, and within the grid on
//   the other axes; every face is pulled in by `slack` for the f32 cell
//   assignment. Otherwise the next level up, where the block is twice as
//   wide, repeats it, keeping only what is no farther than the k-th
//   distance just found; at the top level the block is the whole grid.
// * Crowded cells are opened, not scanned. Next to the body a thin cell's
//   neighbours hold 10^5 points: a cell of the block with more than
//   kSmall points goes on a stack and is opened into its eight children
//   (their runs are binary searches inside the parent's), nearest first,
//   and a cell farther than the k-th distance so far is dropped. The
//   result is the exact k-NN whatever the cloud looks like, and a query
//   scans little more than the points about as near as its k-th.
// * A warp to a query (`knn_query`): lanes 0-16 count the own cell at
//   their level (the start level is one ballot), lanes 0-26 search the run
//   of one neighbour cell each, a prefix over the small runs makes them
//   one list that the warp reads 32 rows at a time (coalesced 16-byte
//   loads), a candidate a lane. The k nearest so far are ONE sorted list
//   across the warp's lanes, ceil(k / 32) registers a lane (entry j in
//   lane j & 31, slot j >> 5; k <= 128): a candidate under the k-th
//   distance is inserted by ballots and one shuffle a slot, so the k-th
//   distance is always exact and culls at once. A camera gather of 16,384
//   queries fills the card, and no query waits for one thread's scan.
// * Self-queries by cell (`knn_radius`): the queries are the grid's own
//   points in cell order. A block takes 128 consecutive points and cuts
//   them into units, the coarsest cells that hold at most kUnit (32)
//   points (a finest cell with more is cut into runs). A warp takes a
//   unit, one point a lane, streams the 27 runs of the unit's block
//   through shared memory 32 rows at a time (the next chunk in flight
//   while this one is scanned, every lane reading the same staged row),
//   each lane keeping its own k nearest in registers (k = 10 and 20: a
//   sorted list with fully unrolled, statically indexed insertion), and
//   writes only the k-th distance^2. A lane whose certificate fails, and
//   every lane of a unit whose block holds more than kUnitList rows, is
//   taken by the whole warp as one query of the kind above.
//
// Distances are computed with explicitly rounded operations in the plain
// version's order, so d^2 is bit-identical to `knn_plain`'s.
//
// What bounds it now: the dependent loads of the binary searches (two of
// ~21 steps per neighbour cell, spread over a warp's lanes) and, in the
// radius pass, the instruction rate of ~27 x (points per cell) distance tests per
// point from shared memory.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBits = 16;  // levels 0..16; the finest has 2^16 cells an axis
constexpr unsigned kFull = 0xffffffffu;

struct Grid {
    const float4* rows;      // (n) x, y, z, 0 in code order
    const long long* codes;  // (n) ascending Morton codes of the finest cells
    int n;
    float ox, oy, oz, h, inv_h;  // origin, width of a finest cell
    float slack;                 // bound of the f32 rounding of a cell face against a point
};

// two zero bits after every bit of a 16-bit integer, and back
__device__ __forceinline__ unsigned long long spread(unsigned v) {
    unsigned long long x = v & 0x1fffffull;
    x = (x | x << 32) & 0x1f00000000ffffull;
    x = (x | x << 16) & 0x1f0000ff0000ffull;
    x = (x | x << 8) & 0x100f00f00f00f00full;
    x = (x | x << 4) & 0x10c30c30c30c30c3ull;
    return (x | x << 2) & 0x1249249249249249ull;
}

__device__ __forceinline__ int compact(unsigned long long x) {
    x &= 0x1249249249249249ull;
    x = (x | x >> 2) & 0x10c30c30c30c30c3ull;
    x = (x | x >> 4) & 0x100f00f00f00f00full;
    x = (x | x >> 8) & 0x1f0000ff0000ffull;
    x = (x | x >> 16) & 0x1f00000000ffffull;
    return static_cast<int>((x | x >> 32) & 0x1fffffull);
}

__device__ __forceinline__ long long morton(int x, int y, int z) {
    return static_cast<long long>((spread(x) << 2) | (spread(y) << 1) | spread(z));
}

__device__ __forceinline__ int cell_of(float v, float o, float inv_h) {
    const int c = static_cast<int>(floorf(__fmul_rn(__fsub_rn(v, o), inv_h)));
    return min(max(c, 0), (1 << kBits) - 1);
}

// the first index whose code is >= key
__device__ __forceinline__ int lower_bound(const Grid& g, long long key) {
    int lo = 0, len = g.n;
    while (len > 0) {
        const int half = len >> 1;
        if (__ldg(g.codes + lo + half) < key) {
            lo += half + 1;
            len -= half + 1;
        } else {
            len = half;
        }
    }
    return lo;
}

// the run [a, a + n) of the level-l cell whose Morton prefix is `prefix`
__device__ __forceinline__ void cell_run(const Grid& g, long long prefix, int l, int& a, int& n) {
    a = lower_bound(g, prefix << (3 * l));
    n = lower_bound(g, (prefix + 1) << (3 * l)) - a;
}

// squared distance from q to the slab [lo, hi] along one axis, with the
// faces pushed out by `slack`
__device__ __forceinline__ float gap2(float q, float lo, float hi, float slack) {
    const float g = fmaxf(fmaxf(lo - slack - q, q - hi - slack), 0.f);
    return g * g;
}

// squared distance to a face `gap` away, shrunk by `slack`
__device__ __forceinline__ float side2(float gap, float slack) {
    const float g = fmaxf(gap - slack, 0.f);
    return g * g;
}

__device__ __forceinline__ float dist2(const float4& p, float qx, float qy, float qz) {
    const float dx = __fsub_rn(p.x, qx), dy = __fsub_rn(p.y, qy), dz = __fsub_rn(p.z, qz);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// A lane's own K nearest distances^2 so far, ascending, in registers (the
// self-query needs no indices): every index is a compile-time constant
// after unrolling.
template <int K>
struct RegTopK {
    float d[K];
    __device__ __forceinline__ void reset() {
#pragma unroll
        for (int s = 0; s < K; ++s) d[s] = CUDART_INF_F;
    }
    __device__ __forceinline__ float worst() const { return d[K - 1]; }
    // v < worst(): v sinks to its place, every later entry moves one down
    __device__ __forceinline__ void insert(float v) {
#pragma unroll
        for (int s = 0; s < K; ++s) {
            const float lower = fminf(v, d[s]);
            v = fmaxf(v, d[s]);
            d[s] = lower;
        }
    }
    // the k-th distance^2, or the largest finite one of a smaller cloud
    __device__ __forceinline__ float kth_or_last() const {
        float r = 0.f;
#pragma unroll
        for (int s = 0; s < K; ++s) r = d[s] < CUDART_INF_F ? d[s] : r;
        return r;
    }
};

struct Query {
    float x, y, z;
    int cx, cy, cz;             // finest cell, clamped into the grid
    float out_x, out_y, out_z;  // squared distance to the grid's extent per axis (0 inside)
};

__device__ __forceinline__ Query make_query(const Grid& g, float x, float y, float z, int cx,
                                            int cy, int cz) {
    const float side = g.h * static_cast<float>(1 << kBits);
    return Query{x, y, z, cx, cy, cz, gap2(x, g.ox, g.ox + side, g.slack),
                 gap2(y, g.oy, g.oy + side, g.slack), gap2(z, g.oz, g.oz + side, g.slack)};
}

// Covered radius^2 around q of the 3x3x3 block about cell (cx, cy, cz) of
// level l, cut to the grid: an unscanned cell lies beyond a face of the
// block on a side where the grid goes on, and inside the grid on the
// other two axes. Infinite when the block is the whole grid.
__device__ __forceinline__ float covered2(const Grid& g, const Query& q, int l, int cx, int cy,
                                          int cz) {
    const int dim = 1 << (kBits - l);
    const float hl = g.h * static_cast<float>(1 << l);
    const int x0 = max(cx - 1, 0), x1 = min(cx + 1, dim - 1);
    const int y0 = max(cy - 1, 0), y1 = min(cy + 1, dim - 1);
    const int z0 = max(cz - 1, 0), z1 = min(cz + 1, dim - 1);
    const float s = g.slack;
    float c = CUDART_INF_F;
    if (x0 > 0) c = fminf(c, side2(q.x - (g.ox + x0 * hl), s) + q.out_y + q.out_z);
    if (x1 < dim - 1) c = fminf(c, side2(g.ox + (x1 + 1) * hl - q.x, s) + q.out_y + q.out_z);
    if (y0 > 0) c = fminf(c, side2(q.y - (g.oy + y0 * hl), s) + q.out_x + q.out_z);
    if (y1 < dim - 1) c = fminf(c, side2(g.oy + (y1 + 1) * hl - q.y, s) + q.out_x + q.out_z);
    if (z0 > 0) c = fminf(c, side2(q.z - (g.oz + z0 * hl), s) + q.out_x + q.out_y);
    if (z1 < dim - 1) c = fminf(c, side2(g.oz + (z1 + 1) * hl - q.z, s) + q.out_x + q.out_y);
    return c;
}

// The inclusive prefix over the warp of each lane's n.
__device__ __forceinline__ int warp_prefix(int n, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, n, o);
        if (lane >= o) n += v;
    }
    return n;
}

// The row index of item t of the list that the lanes' runs make up (lane
// r holds run r: its first row run_a, its first item run_first; pre is
// the inclusive prefix of the runs' lengths). All lanes call; a lane past
// the end gets -1.
__device__ __forceinline__ int list_row(int pre, int run_a, int run_first, int total, int t) {
    const bool live = t < total;
    const int tt = live ? t : 0;
    int r = 0;  // the run that holds item tt: the first lane with pre > tt
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
        const int v = __shfl_sync(kFull, pre, r + step - 1);
        if (v <= tt) r += step;
    }
    const int src = __shfl_sync(kFull, run_a, r) + (tt - __shfl_sync(kFull, run_first, r));
    return live ? src : -1;
}

// The run and the Morton prefix of neighbour `lane` (< 27) of cell
// (cx, cy, cz) of level l; an empty run outside the grid or for lane >= 27.
__device__ __forceinline__ void neighbour_run(const Grid& g, int l, int cx, int cy, int cz,
                                              int lane, long long& prefix, int& run_a,
                                              int& run_n) {
    const int dim = 1 << (kBits - l);
    prefix = 0;
    run_a = 0;
    run_n = 0;
    if (lane < 27) {
        const int x = cx + lane / 9 - 1, y = cy + (lane / 3) % 3 - 1, z = cz + lane % 3 - 1;
        if (x >= 0 && x < dim && y >= 0 && y < dim && z >= 0 && z < dim) {
            prefix = morton(x, y, z);
            cell_run(g, prefix, l, run_a, run_n);
        }
    }
}

// squared distance from q to the level-l cell of Morton prefix `prefix`
__device__ __forceinline__ float cell_gap2(const Grid& g, const Query& q, long long prefix,
                                           int l) {
    const float hl = g.h * static_cast<float>(1 << l);
    const unsigned long long p = static_cast<unsigned long long>(prefix);
    const float x = g.ox + compact(p >> 2) * hl, y = g.oy + compact(p >> 1) * hl,
                z = g.oz + compact(p) * hl;
    return gap2(q.x, x, x + hl, g.slack) + gap2(q.y, y, y + hl, g.slack) +
           gap2(q.z, z, z + hl, g.slack);
}

// One query's k nearest so far (k <= 32 R) as one sorted list over the
// warp's lanes: R entries a lane, entry j in lane j & 31, slot j >> 5.
// Slots are compile-time indices after unrolling, so the list stays in
// registers; the k-th distance is exact, so it culls at once. Every call
// is made by the whole warp.
template <int R>
struct WarpListR {
    float d[R];
    int i[R];
    __device__ __forceinline__ void reset(int) {
#pragma unroll
        for (int s = 0; s < R; ++s) {
            d[s] = CUDART_INF_F;
            i[s] = -1;
        }
    }
    // the k-th distance^2 so far: slot (k-1) >> 5 of lane (k-1) & 31
    __device__ __forceinline__ float bound(int k) const {
        const int slot = (k - 1) >> 5;
        float v = d[0];
#pragma unroll
        for (int s = 1; s < R; ++s) v = slot == s ? d[s] : v;
        return __shfl_sync(kFull, v, (k - 1) & 31);
    }
    // each lane offers one candidate (live: it has one); one at a time, a
    // candidate under the bound goes in at the count of entries <= it and
    // every later entry moves one place down
    __device__ __forceinline__ void offer(float v, int vi, bool live, int k, float cap2) {
        const int lane = threadIdx.x & 31;
        const int from = (lane + 31) & 31;
        float b = bound(k);
        unsigned m = __ballot_sync(kFull, live && v < b && v <= cap2);
        while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const float cv = __shfl_sync(kFull, v, src);
            const int ci = __shfl_sync(kFull, vi, src);
            if (!(cv < b)) continue;
            int pos = 0;
#pragma unroll
            for (int s = 0; s < R; ++s) pos += __popc(__ballot_sync(kFull, d[s] <= cv));
            // every old entry is read before any is written: lane l takes
            // lane l - 1's entry of its slot, lane 0 lane 31's of the slot
            // before
            float rd[R];
            int ri[R];
#pragma unroll
            for (int s = 0; s < R; ++s) {
                rd[s] = __shfl_sync(kFull, d[s], from);
                ri[s] = __shfl_sync(kFull, i[s], from);
            }
#pragma unroll
            for (int s = 0; s < R; ++s) {
                const int e = 32 * s + lane;
                const int up = s > 0 ? s - 1 : 0;
                const float pd = lane == 0 ? rd[up] : rd[s];
                const int pi = lane == 0 ? ri[up] : ri[s];
                if (e > pos) {
                    d[s] = pd;
                    i[s] = pi;
                } else if (e == pos) {
                    d[s] = cv;
                    i[s] = ci;
                }
            }
            b = bound(k);
        }
    }
    // the sorted result: entry s * 32 + lane from each slot (coalesced);
    // returns the k-th distance^2
    __device__ __forceinline__ float finish(int k, int* idx, float* d2) {
        const int lane = threadIdx.x & 31;
        if (idx) {
#pragma unroll
            for (int s = 0; s < R; ++s) {
                const int e = 32 * s + lane;
                if (e < k) {
                    idx[e] = i[s];
                    d2[e] = d[s];
                }
            }
        }
        return bound(k);
    }
    // the largest finite distance^2 among the k
    __device__ __forceinline__ float last_finite(int k) const {
        const int lane = threadIdx.x & 31;
        float r = 0.f;
#pragma unroll
        for (int s = 0; s < R; ++s)
            if (32 * s + lane < k && d[s] < CUDART_INF_F) r = fmaxf(r, d[s]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) r = fmaxf(r, __shfl_xor_sync(kFull, r, o));
        return r;
    }
};

// What the counting variants record per query.
struct Counts {
    int levels, cells, candidates;
};

constexpr int kSmall = 256;     // a cell of at most this many points is scanned whole
constexpr int kStackCells = 160;  // 27 + 7 a level of descent
constexpr int kCellInts = 5;    // a stacked cell: first row, points, level, prefix (2)

// One query by a whole warp: the exact k nearest of (x, y, z) into `list`,
// returning the k-th distance^2 (the list's `finish`). From the finest
// level whose own cell holds `want` points upwards: the 3x3x3 block's
// small cells are scanned whole, as one list; a crowded cell is opened
// into its eight children, nearest first, and a cell farther than the
// k-th distance so far is dropped; the result stands once the k-th
// distance^2 is within the block's covered radius^2, else the next level
// up repeats it, keeping only what is nearer than that k-th distance.
// `stack` is this warp's kStackCells * kCellInts ints of shared memory.
template <class List, bool kCount>
__device__ float warp_query(const Grid& g, float x, float y, float z, int k, int want, List& list,
                            int* stack, int* idx, float* d2, Counts& n, int& start_level) {
    const int lane = threadIdx.x & 31;
    const Query q = make_query(g, x, y, z, cell_of(x, g.ox, g.inv_h), cell_of(y, g.oy, g.inv_h),
                               cell_of(z, g.oz, g.inv_h));
    // the finest level whose own cell holds `want` points: lane l counts level l
    const long long code = morton(q.cx, q.cy, q.cz);
    int own = 0, own_a;
    if (lane <= kBits) cell_run(g, code >> (3 * lane), lane, own_a, own);
    const unsigned enough = __ballot_sync(kFull, lane <= kBits && own >= want);
    int l = enough ? __ffs(enough) - 1 : kBits;
    start_level = l;

    float cap2 = CUDART_INF_F, kth;
    for (;; ++l) {
        list.reset(k);
        const int cx = q.cx >> l, cy = q.cy >> l, cz = q.cz >> l;
        long long prefix;
        int run_a, run_n;
        neighbour_run(g, l, cx, cy, cz, lane, prefix, run_a, run_n);
        if (kCount) {
            ++n.levels;
            n.cells += 27;
        }
        // the small cells as one list, 32 rows at a time
        const bool small = run_n <= kSmall;
        const int len = small ? run_n : 0;
        const int pre = warp_prefix(len, lane);
        const int total = __shfl_sync(kFull, pre, 31);
        int row = list_row(pre, run_a, pre - len, total, lane);
        for (int base = 0; base < total; base += 32) {
            const int next = list_row(pre, run_a, pre - len, total, base + 32 + lane);
            const float v = row >= 0 ? dist2(__ldg(g.rows + row), q.x, q.y, q.z) : 0.f;
            list.offer(v, row, row >= 0, k, cap2);
            row = next;
        }
        if (kCount) n.candidates += total;

        // the crowded cells onto the stack, the nearest on top
        int sp = 0;
        {
            const unsigned big = __ballot_sync(kFull, !small);
            const float gap = small ? 0.f : cell_gap2(g, q, prefix, l);
            int rank = 0;  // how many crowded cells are nearer, ties by lane
            for (unsigned m = big; m; m &= m - 1) {
                const int o = __ffs(m) - 1;
                const float og = __shfl_sync(kFull, gap, o);
                rank += (og < gap || (og == gap && o < lane)) ? 1 : 0;
            }
            sp = __popc(big);
            if (!small) {
                int* c = stack + (sp - 1 - rank) * kCellInts;
                c[0] = run_a;
                c[1] = run_n;
                c[2] = l;
                c[3] = static_cast<int>(prefix & 0xffffffffll);
                c[4] = static_cast<int>(prefix >> 32);
            }
            __syncwarp();
        }
        while (sp > 0) {
            --sp;
            const int* c = stack + sp * kCellInts;
            const int a = c[0], cn = c[1], cl = c[2];
            const long long cp = (static_cast<long long>(c[4]) << 32) |
                                 static_cast<unsigned>(c[3]);
            __syncwarp();
            const float reach2 = fminf(list.bound(k), cap2);
            if (cell_gap2(g, q, cp, cl) > reach2) continue;
            if (cn <= kSmall || cl == 0) {
                for (int base = 0; base < cn; base += 32) {
                    const bool live = base + lane < cn;
                    const int r = a + base + lane;
                    const float v = live ? dist2(__ldg(g.rows + r), q.x, q.y, q.z) : 0.f;
                    list.offer(v, r, live, k, cap2);
                }
                if (kCount) n.candidates += cn;
                continue;
            }
            // open it: lanes 0-7 take a child each, whose run lies in [a, a + cn)
            const long long child = (cp << 3) | (lane & 7);
            int lo = a, hi = a + cn;  // the first row whose code is >= the child's first
            const long long key = child << (3 * (cl - 1));
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (__ldg(g.codes + mid) < key) lo = mid + 1; else hi = mid;
            }
            int end = __shfl_down_sync(kFull, lo, 1);
            if ((lane & 7) == 7) end = a + cn;
            const int child_n = end - lo;
            const float gap = cell_gap2(g, q, child, cl - 1);
            const float reach = fminf(list.bound(k), cap2);  // every lane takes part
            const bool keep = lane < 8 && child_n > 0 && gap <= reach;
            const unsigned kept = __ballot_sync(kFull, keep);
            int rank = 0;
            for (unsigned m = kept; m; m &= m - 1) {
                const int o = __ffs(m) - 1;
                const float og = __shfl_sync(kFull, gap, o);
                rank += (og < gap || (og == gap && o < lane)) ? 1 : 0;
            }
            const int count = __popc(kept);
            if (sp + count > kStackCells) __trap();  // impossible: 7 cells a level at most stay
            if (keep) {
                int* w = stack + (sp + count - 1 - rank) * kCellInts;
                w[0] = lo;
                w[1] = child_n;
                w[2] = cl - 1;
                w[3] = static_cast<int>(child & 0xffffffffll);
                w[4] = static_cast<int>(child >> 32);
            }
            sp += count;
            if (kCount) n.cells += 8;
            __syncwarp();
        }
        kth = list.finish(k, idx, d2);
        const float cover2 = covered2(g, q, l, cx, cy, cz);
        if (cover2 == CUDART_INF_F || kth <= cover2) break;
        cap2 = kth;
    }
    return kth;
}

// A warp to a query. counts (the counting variant): levels scanned, cells
// looked up, candidates tested, start level.
template <class List, bool kCount>
__global__ void __launch_bounds__(kThreads, 1)
knn_query_kernel(Grid g, const float* __restrict__ queries, int nq, int k, int want,
                 int* __restrict__ out_idx, float* __restrict__ out_d2, int* __restrict__ counts) {
    __shared__ int s_stack[kWarps][kStackCells * kCellInts];
    const int warp = threadIdx.x >> 5;
    const int qi = blockIdx.x * kWarps + warp;
    if (qi >= nq) return;
    List list;
    Counts n{0, 0, 0};
    int start_level;
    warp_query<List, kCount>(g, queries[3 * qi], queries[3 * qi + 1], queries[3 * qi + 2], k, want,
                             list, s_stack[warp], out_idx + static_cast<size_t>(qi) * k,
                             out_d2 + static_cast<size_t>(qi) * k, n, start_level);
    if (kCount && (threadIdx.x & 31) == 0) {
        counts[4 * qi] = n.levels;
        counts[4 * qi + 1] = n.cells;
        counts[4 * qi + 2] = n.candidates;
        counts[4 * qi + 3] = start_level;
    }
}

constexpr int kUnit = 32;  // most points of a unit: one a lane of a warp (knn.py UNIT)

// The run [a, e) of the level-(shift / 3) cell that holds point i, if it
// has at most kUnit points: both ends lie within kUnit of i.
__device__ __forceinline__ bool bounded_run(const Grid& g, int i, int shift, int& a, int& e) {
    constexpr int unit = kUnit;
    const long long p = __ldg(g.codes + i) >> shift;
    if (i - unit >= 0 && (__ldg(g.codes + i - unit) >> shift) == p) return false;
    int lo = max(i - unit, 0), hi = i;  // the first index whose prefix is p
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((__ldg(g.codes + mid) >> shift) < p) lo = mid + 1; else hi = mid;
    }
    a = lo;
    if (i + unit < g.n && (__ldg(g.codes + i + unit) >> shift) == p) return false;
    lo = i + 1;
    hi = min(i + unit, g.n);  // the first index whose prefix is above p
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((__ldg(g.codes + mid) >> shift) <= p) lo = mid + 1; else hi = mid;
    }
    e = lo;
    return e - a <= unit;
}

constexpr int kUnitList = 2048;  // a unit scans its block together up to this many rows

// The self-query: per point of the grid, the k-th nearest distance^2,
// itself included (of a cloud of fewer than k points, the largest).
// counts (the counting variant): levels scanned, cells looked up,
// candidates tested, the points of its unit. A member's list is TopK; the
// warp's fallback list one register a lane (k <= 32).
template <class TopK, bool kCount>
__global__ void __launch_bounds__(kThreads, 1)
knn_radius_kernel(Grid g, int k, int want, float* __restrict__ out_d2,
                  int* __restrict__ counts) {
    __shared__ int s_units;
    __shared__ int s_start[kThreads];
    __shared__ int s_shape[kThreads];  // level | count << 8
    __shared__ float4 s_stage[kWarps][32];
    __shared__ int s_stack[kWarps][kStackCells * kCellInts];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int i = blockIdx.x * kThreads + tid;
    if (tid == 0) s_units = 0;
    __syncthreads();

    // the units that start among this block's points
    if (i < g.n) {
        int a, e, l = 0, count;
        bool head;
        if (!bounded_run(g, i, 0, a, e)) {  // a crowded finest cell: runs of kUnit
            const long long code = __ldg(g.codes + i);
            a = lower_bound(g, code);
            head = (i - a) % kUnit == 0;
            count = min(kUnit, lower_bound(g, code + 1) - i);
        } else {
            int a2, e2;  // the coarsest cell around it with <= kUnit points
            while (l < kBits && bounded_run(g, i, 3 * (l + 1), a2, e2)) {
                a = a2;
                e = e2;
                ++l;
            }
            head = i == a;
            count = e - a;
        }
        if (head) {
            const int slot = atomicAdd(&s_units, 1);
            s_start[slot] = i;
            s_shape[slot] = l | (count << 8);
        }
    }
    __syncthreads();

    for (int u = warp; u < s_units; u += kWarps) {
        const int start = s_start[u], l = s_shape[u] & 255, count = s_shape[u] >> 8;
        const bool member = lane < count;
        const float4 me = __ldg(g.rows + start + (member ? lane : 0));
        const unsigned long long ucode = static_cast<unsigned long long>(
            __ldg(g.codes + start)) >> (3 * l);
        const int cx = compact(ucode >> 2), cy = compact(ucode >> 1), cz = compact(ucode);
        long long prefix;
        int run_a, run_n;
        neighbour_run(g, l, cx, cy, cz, lane, prefix, run_a, run_n);
        const int pre = warp_prefix(run_n, lane);
        const int total = __shfl_sync(kFull, pre, 31);
        Counts n{0, 0, 0};
        float result = 0.f;
        bool pending = member;
        if (total <= kUnitList) {
            // the block's rows through shared memory, every member scanning all
            TopK top;
            top.reset();
            int row = list_row(pre, run_a, pre - run_n, total, lane);
            float4 next = __ldg(g.rows + max(row, 0));
            for (int base = 0; base < total; base += 32) {
                s_stage[warp][lane] = next;
                __syncwarp();
                row = list_row(pre, run_a, pre - run_n, total, base + 32 + lane);
                next = __ldg(g.rows + max(row, 0));
                const int m = min(32, total - base);
                if (member) {
#pragma unroll 4
                    for (int j = 0; j < m; ++j) {
                        const float v = dist2(s_stage[warp][j], me.x, me.y, me.z);
                        if (v < top.worst()) top.insert(v);
                    }
                }
                __syncwarp();
            }
            if (member) {
                const Query q = make_query(g, me.x, me.y, me.z, 0, 0, 0);
                const float cover2 = covered2(g, q, l, cx, cy, cz);
                pending = !(cover2 == CUDART_INF_F || top.worst() <= cover2);
                result = top.kth_or_last();
                n = Counts{1, 27, total};
            }
        }
        // members not certified (or a block too crowded to scan whole): the
        // warp takes them one at a time
        for (unsigned todo = __ballot_sync(kFull, pending); todo; todo &= todo - 1) {
            const int m = __ffs(todo) - 1;
            WarpListR<1> list;
            Counts one{0, 0, 0};
            int start_level;
            const float kth = warp_query<WarpListR<1>, kCount>(
                g, __shfl_sync(kFull, me.x, m), __shfl_sync(kFull, me.y, m),
                __shfl_sync(kFull, me.z, m), k, want, list, s_stack[warp], nullptr, nullptr, one,
                start_level);
            const float r = kth < CUDART_INF_F ? kth : list.last_finite(k);
            if (lane == m) {
                result = r;
                n = Counts{n.levels + one.levels, n.cells + one.cells,
                           n.candidates + one.candidates};
            }
        }
        if (!member) continue;
        out_d2[start + lane] = result;
        if (kCount) {
            int* c = counts + 4 * static_cast<size_t>(start + lane);
            c[0] = n.levels;
            c[1] = n.cells;
            c[2] = n.candidates;
            c[3] = count;
        }
    }
}

template <class List, bool kCount>
cudaError_t launch_query(const Grid& g, const float* q, int nq, int k, int want, int* out_idx,
                         float* out_d2, int* counts, cudaStream_t st) {
    knn_query_kernel<List, kCount><<<(nq + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        g, q, nq, k, want, out_idx, out_d2, counts);
    return cudaGetLastError();
}

// The warp's one list: ceil(k / 32) registers a lane, rounded up to one,
// two or four.
template <bool kCount>
cudaError_t query_by_k(const Grid& g, const float* q, int nq, int k, int want, int* out_idx,
                       float* out_d2, int* counts, cudaStream_t st) {
    if (k <= 32)
        return launch_query<WarpListR<1>, kCount>(g, q, nq, k, want, out_idx, out_d2, counts, st);
    if (k <= 64)
        return launch_query<WarpListR<2>, kCount>(g, q, nq, k, want, out_idx, out_d2, counts, st);
    return launch_query<WarpListR<4>, kCount>(g, q, nq, k, want, out_idx, out_d2, counts, st);
}

template <class TopK, bool kCount>
cudaError_t launch_radius(const Grid& g, int k, int want, float* out_d2, int* counts,
                          cudaStream_t st) {
    knn_radius_kernel<TopK, kCount><<<(g.n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        g, k, want, out_d2, counts);
    return cudaGetLastError();
}

constexpr int kMaxK = 128;  // knn.py MAX_K

}  // namespace

// The query kernel and its counting variant (counts != nullptr: four ints
// per query) for any k <= 128.
extern "C" int rpt_knn_query(const float* rows, const long long* codes, int n, float ox, float oy,
                             float oz, float h, float inv_h, float slack, const float* queries,
                             int nq, int k, int want, int* out_idx, float* out_d2, int* counts,
                             void* stream) {
    if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
    const Grid g{reinterpret_cast<const float4*>(rows), codes, n, ox, oy, oz, h, inv_h, slack};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return static_cast<int>(counts ? query_by_k<true>(g, queries, nq, k, want, out_idx, out_d2,
                                                      counts, st)
                                   : query_by_k<false>(g, queries, nq, k, want, out_idx, out_d2,
                                                       counts, st));
}

// The self-query and its counting variant for k = 10 and k = 20 (the
// radius pass's k), a member's list in registers.
extern "C" int rpt_knn_radius(const float* rows, const long long* codes, int n, float ox,
                              float oy, float oz, float h, float inv_h, float slack, int k,
                              int want, float* out_d2, int* counts, void* stream) {
    const Grid g{reinterpret_cast<const float4*>(rows), codes, n, ox, oy, oz, h, inv_h, slack};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaErrorInvalidValue;
    if (k == 10)
        e = counts ? launch_radius<RegTopK<10>, true>(g, k, want, out_d2, counts, st)
                   : launch_radius<RegTopK<10>, false>(g, k, want, out_d2, counts, st);
    else if (k == 20)
        e = counts ? launch_radius<RegTopK<20>, true>(g, k, want, out_d2, counts, st)
                   : launch_radius<RegTopK<20>, false>(g, k, want, out_d2, counts, st);
    return static_cast<int>(e);
}
