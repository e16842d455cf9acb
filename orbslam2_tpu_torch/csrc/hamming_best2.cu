// K3: Hamming best and second best candidate per row, with the matchers'
// geometric gates evaluated in the kernel.
//
// Replaces orbslam2_tpu/ops/hamming.py::hamming_matrix (:27-38),
// ::masked_argmin (:41-49), ::masked_two_smallest (:52-64), the
// second-index pass of orbslam2_tpu/ops/matchers.py::
// search_by_projection_points (:464-466), and the [N, M] gates of
// stereo_match (:191-201), search_by_projection_frame (:256-275) and
// search_by_projection_points (:440-456), fuse_match (:384-401) and
// search_by_bow_nodes (:127-157). Neither the distances nor the gate are
// ever written.
//
// One kernel template over a gate functor, six modes:
//   GateMask    a bool [N, M] mask (search_by_bow, epipolar_match): every
//               column is scanned;
//   GateStereo  row band |vR - vL| <= 2 sigma, octave +-1, uL - max_d <= uR <= uL;
//   GateFrame   window |du|, |dv| <= th sigma, forward / backward / +-1 octave;
//   GatePoints  window, octave in [pred - 1, pred], stereo agreement
//               |ur_cur - ur_pt| <= radius where the keypoint has a right u;
//   GateFuse    window, octave in [pred - 1, pred], reprojection chi2
//               ((du du + dv dv) + er er) isig <= 7.8 where the keypoint has a
//               right u, else (du du + dv dv) isig <= 5.99;
//   GateNodes   both features valid and descending to the same vocabulary
//               node (FeatureVector bucketing), the row's node >= 0.
// The matchers (ops/matchers.py) compute the per-row vectors with the
// plain expressions; each pairwise test here is one subtraction,
// one fabsf and one compare, candidate minus row as in the plain gate, or
// an integer compare, so no contraction or reordering can move a gate.
// The fuse chi2 multiplies and adds: it is written with __fmul_rn and
// __fadd_rn in the plain version's order (hamming.py::_gate_fuse), which
// nvcc never contracts into an FMA, so it rounds as the plain version does.
//
// Pruning: in the geometric gated modes every block first sorts the columns by v
// into shared memory, as a counting sort into NB buckets spread over the
// v range of the valid columns (a min/max reduction, a histogram, a scan
// and a scatter: a few barriers, where a bitonic sort of 2048 keys in one
// block took ~28 us on an H100, issue-bound; ties in a bucket fall in any
// order). Only
// columns that can pass a gate (valid, v not NaN) are placed. A valid row
// takes the buckets of [v - r - slack, v + r + slack], slack = 1 + (|v| +
// r) * 2^-16, far above float32's rounding of the band's ends, and scans
// only their columns; the exact gate then decides every pair. The bucket
// of a value is one monotone float expression, the same for columns and
// band ends, so a column inside the band lies in a scanned bucket. An
// invalid row, or one whose band is NaN, is answered before any search.
// In nodes mode the wrapper sorts the column node ids on the device
// (torch.sort: col_node holds them sorted, col_perm the column of each
// slot); every block copies the sorted ids into shared memory, and a row
// binary-searches its node there and scans only that node's slots. The
// gate (column valid) is then decided per candidate.
//
// Semantics reproduced exactly:
//   * keys are (d << 32) | j with j the original column, so ties go to the
//     lowest index whatever the scan order;
//   * the plain version counts an ungated entry as d = 256 at its own
//     index, so whenever the best (or the second) distance is 256 its index
//     is 0: a row with no candidate, or whose only candidate is at 256 (a
//     complement descriptor), answers (0, 256, 0, 256);
//   * the second best is the minimum with position idx1 set to 256, not
//     removed (what jax.nn.one_hot(idx) does at hamming.py:60-62).
//
// Layout and bound: blocks of 1024 threads, one warp per row, at most one
// block per SM with a grid-stride loop over the rows; every block sorts
// the columns itself, so nothing waits on another block. The lanes of a
// row stride over its ~1-100 candidates and a shuffle butterfly merges
// their best two. At ~1200 rows and a few gated pairs per row the work is
// ~0.15 MB and ~0.2 M integer operations: latency, not bytes or
// operations, bounds it (the sort's barriers, then a few dependent loads
// per row), so the layout keeps both chains short.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIST = 256;
constexpr unsigned long long kNone = ~0ull;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;  // rows in flight per block
constexpr int NB = THREADS;          // v buckets of the gated modes' counting sort
constexpr int MAX_COLUMNS = 16384;   // sorted in shared memory: 4 bytes per column
// how a row finds its candidates: every column, the columns of its v band,
// or the columns of its vocabulary node
enum Prune { PRUNE_NONE = 0, PRUNE_V = 1, PRUNE_NODE = 2 };
constexpr unsigned kAll = 0xffffffffu;

enum Mode { MODE_MASK = 0, MODE_STEREO = 1, MODE_FRAME = 2, MODE_POINTS = 3, MODE_FUSE = 4, MODE_NODES = 5 };
enum OctMode { OCT_FORWARD = 0, OCT_BACKWARD = 1, OCT_BOTH = 2 };

// Mirrors ops/hamming.py::_Args. Row and column coordinates are [n, 2]
// (u, v) float32; bool vectors are one byte per entry; a pointer the mode
// does not read is null.
struct Best2Args {
    const int* a;                 // [n, 8] row descriptors, 16-byte aligned
    const int* b;                 // [m, 8] column descriptors, 16-byte aligned
    const unsigned char* mask;    // [n, m] (mask mode)
    const float* row_uv;          // [n, 2]
    const float* row_r;           // [n] band (stereo) or window (frame, points) half-size
    const float* row_umin;        // [n] stereo: uL - max_d
    const float* row_ur;          // [n] points, fuse: predicted right u
    const int* row_oct;           // [n]
    const unsigned char* row_valid;
    const float* col_uv;          // [m, 2]
    const float* col_ur;          // [m] points, fuse: right u, < 0 where none
    const int* col_oct;           // [m]
    const unsigned char* col_valid;
    const float* col_isig;        // [m] fuse: 1 / sigma^2 of the column's octave
    const int* row_node;          // [n] nodes: the row's vocabulary node, -1 for none
    const int* col_node;          // [m] nodes: the columns' node ids, sorted ascending
    const int* col_perm;          // [m] nodes: the column of each sorted slot
    int* out;                     // [4, n]: idx1, d1, idx2, d2
    int n, m, mode, oct_mode;
    int n_blocks;                 // written back by the launcher
};

struct RowAt {
    float u, v, r, aux;  // aux: umin (stereo) or ur (points, fuse)
    int oct;             // octave or predicted level; the vocabulary node (nodes)
};

struct GateMask {
    static constexpr int kPrune = PRUNE_NONE;
    __device__ static bool row(const Best2Args&, int, RowAt&) { return true; }
    __device__ static bool pass(const Best2Args& p, int i, const RowAt&, int j) {
        return p.mask[(size_t)i * p.m + j] != 0;
    }
};

__device__ __forceinline__ bool load_row(const Best2Args& p, int i, RowAt& r) {
    if (!p.row_valid[i]) return false;
    r.u = p.row_uv[2 * i];
    r.v = p.row_uv[2 * i + 1];
    r.r = p.row_r[i];
    r.oct = p.row_oct[i];
    return true;
}

__device__ __forceinline__ bool window(const Best2Args& p, const RowAt& r, int j) {
    return fabsf(p.col_uv[2 * j] - r.u) <= r.r && fabsf(p.col_uv[2 * j + 1] - r.v) <= r.r;
}

struct GateStereo {
    static constexpr int kPrune = PRUNE_V;
    __device__ static bool row(const Best2Args& p, int i, RowAt& r) {
        if (!load_row(p, i, r)) return false;
        r.aux = p.row_umin[i];
        return true;
    }
    __device__ static bool pass(const Best2Args& p, int, const RowAt& r, int j) {
        if (!p.col_valid[j]) return false;
        const float cu = p.col_uv[2 * j];
        return fabsf(p.col_uv[2 * j + 1] - r.v) <= r.r && abs(p.col_oct[j] - r.oct) <= 1 &&
               cu >= r.aux && cu <= r.u;
    }
};

struct GateFrame {
    static constexpr int kPrune = PRUNE_V;
    __device__ static bool row(const Best2Args& p, int i, RowAt& r) { return load_row(p, i, r); }
    __device__ static bool pass(const Best2Args& p, int, const RowAt& r, int j) {
        if (!p.col_valid[j] || !window(p, r, j)) return false;
        const int oc = p.col_oct[j];
        if (p.oct_mode == OCT_FORWARD) return oc >= r.oct;
        if (p.oct_mode == OCT_BACKWARD) return oc <= r.oct;
        return oc >= r.oct - 1 && oc <= r.oct + 1;
    }
};

struct GatePoints {
    static constexpr int kPrune = PRUNE_V;
    __device__ static bool row(const Best2Args& p, int i, RowAt& r) {
        if (!load_row(p, i, r)) return false;
        r.aux = p.row_ur[i];
        return true;
    }
    __device__ static bool pass(const Best2Args& p, int, const RowAt& r, int j) {
        if (!p.col_valid[j] || !window(p, r, j)) return false;
        const int oc = p.col_oct[j];
        if (oc < r.oct - 1 || oc > r.oct) return false;
        const float cur = p.col_ur[j];
        return !(cur >= 0.0f) || fabsf(cur - r.aux) <= r.r;
    }
};

struct GateFuse {
    static constexpr int kPrune = PRUNE_V;
    __device__ static bool row(const Best2Args& p, int i, RowAt& r) {
        if (!load_row(p, i, r)) return false;
        r.aux = p.row_ur[i];
        return true;
    }
    __device__ static bool pass(const Best2Args& p, int, const RowAt& r, int j) {
        if (!p.col_valid[j] || !window(p, r, j)) return false;
        const int oc = p.col_oct[j];
        if (oc < r.oct - 1 || oc > r.oct) return false;
        const float du = p.col_uv[2 * j] - r.u, dv = p.col_uv[2 * j + 1] - r.v;
        const float e2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
        const float isig = p.col_isig[j], cur = p.col_ur[j];
        if (cur >= 0.0f) {
            const float er = r.aux - cur;
            return __fmul_rn(__fadd_rn(e2, __fmul_rn(er, er)), isig) <= 7.8f;
        }
        return __fmul_rn(e2, isig) <= 5.99f;
    }
};

struct GateNodes {
    static constexpr int kPrune = PRUNE_NODE;
    __device__ static bool row(const Best2Args& p, int i, RowAt& r) {
        if (!p.row_valid[i]) return false;
        r.oct = p.row_node[i];
        return r.oct >= 0;
    }
    // the slot range holds the row's node: what is left of the gate
    __device__ static bool pass(const Best2Args& p, int, const RowAt&, int j) {
        return p.col_valid[j] != 0;
    }
};

// First slot in [lo, hi) whose sorted node id is >= key (upper: > key).
__device__ __forceinline__ int lower_slot(const int* ids, int lo, int hi, int key, bool upper) {
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ids[mid] < key || (upper && ids[mid] == key)) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// Bucket of v: floor((v - v0) * scale) clamped to [0, NB - 1], NaN to 0
// (only reached when scale is 0 or infinite, where it keeps the order).
__device__ __forceinline__ int bucket_of(float v, float v0, float scale) {
    return (int)fminf(fmaxf(floorf((v - v0) * scale), 0.0f), (float)(NB - 1));
}

// Counting sort of the columns that can pass a gate (valid, v not NaN) by
// the bucket of their v, into shared memory: start[b] is the first slot of
// bucket b (start[NB] the number placed), perm[slot] the column. Returns
// (in v0, scale) the bucket map, spread over the finite v of those columns.
__device__ void bucket_sort(const Best2Args& p, int* start, int* cursor, int* perm, float& v0,
                            float& scale) {
    __shared__ float wmin[WARPS], wmax[WARPS];
    __shared__ int wsum[WARPS];
    __shared__ float s_v0, s_scale;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    float lo = __int_as_float(0x7f800000), hi = -lo;
    for (int c = t; c < p.m; c += THREADS) {
        const float v = p.col_uv[2 * c + 1];
        if (p.col_valid[c] && isfinite(v)) {
            lo = fminf(lo, v);
            hi = fmaxf(hi, v);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(kAll, lo, off));
        hi = fmaxf(hi, __shfl_xor_sync(kAll, hi, off));
    }
    if (lane == 0) {
        wmin[warp] = lo;
        wmax[warp] = hi;
    }
    start[t] = 0;
    if (t == 0) start[NB] = 0;
    __syncthreads();
    if (warp == 0) {
        lo = wmin[lane];
        hi = wmax[lane];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            lo = fminf(lo, __shfl_xor_sync(kAll, lo, off));
            hi = fmaxf(hi, __shfl_xor_sync(kAll, hi, off));
        }
        if (lane == 0) {
            const float span = hi - lo;  // -inf or NaN when no column is finite
            s_v0 = lo <= hi ? lo : 0.0f;
            s_scale = span > 0.0f && isfinite(span) ? (float)NB / span : 0.0f;
        }
    }
    __syncthreads();
    v0 = s_v0;
    scale = s_scale;
    for (int c = t; c < p.m; c += THREADS) {
        const float v = p.col_uv[2 * c + 1];
        if (p.col_valid[c] && v == v) atomicAdd(&start[bucket_of(v, v0, scale)], 1);
    }
    __syncthreads();
    // exclusive scan of the NB counts, one per thread
    const int x = start[t];
    int incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kAll, incl, off);
        if (lane >= off) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int w = wsum[lane];
        int wi = w;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(kAll, wi, off);
            if (lane >= off) wi += y;
        }
        wsum[lane] = wi - w;
    }
    __syncthreads();
    const int excl = incl - x + wsum[warp];
    start[t] = excl;
    cursor[t] = excl;
    if (t == NB - 1) start[NB] = excl + x;
    __syncthreads();
    for (int c = t; c < p.m; c += THREADS) {
        const float v = p.col_uv[2 * c + 1];
        if (p.col_valid[c] && v == v) perm[atomicAdd(&cursor[bucket_of(v, v0, scale)], 1)] = c;
    }
    __syncthreads();
}

__device__ __forceinline__ int popc8(const int4& a0, const int4& a1, const int4& b0,
                                     const int4& b1) {
    return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
           __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
           __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

template <class Gate>
__global__ void __launch_bounds__(THREADS) hamming_best2_kernel(const Best2Args p) {
    // v pruning: start [NB + 1], cursor [NB], perm [m]; node pruning: the
    // sorted node ids [m]
    extern __shared__ int smem[];
    int* start = smem;
    int* perm = smem + 2 * NB + 1;
    const int lane = threadIdx.x & 31;
    float v0 = 0.0f, scale = 0.0f;
    if constexpr (Gate::kPrune == PRUNE_V) bucket_sort(p, start, smem + NB + 1, perm, v0, scale);
    if constexpr (Gate::kPrune == PRUNE_NODE) {
        for (int c = threadIdx.x; c < p.m; c += THREADS) smem[c] = p.col_node[c];
        __syncthreads();
    }

    for (int i = blockIdx.x * WARPS + (threadIdx.x >> 5); i < p.n; i += gridDim.x * WARPS) {
        // key = (d << 32) | j: unsigned order is the lexicographic (d, j) order
        unsigned long long k1 = kNone, k2 = kNone;
        RowAt r;
        if (Gate::row(p, i, r)) {  // uniform per warp: one row
            int q0 = 0, q1 = p.m;
            if constexpr (Gate::kPrune == PRUNE_V) {
                const float slack = 1.0f + (fabsf(r.v) + r.r) * 0x1p-16f;
                const float lo = r.v - r.r - slack, hi = r.v + r.r + slack;
                q1 = 0;
                if (lo <= hi) {  // false for NaN
                    q0 = start[bucket_of(lo, v0, scale)];
                    q1 = start[bucket_of(hi, v0, scale) + 1];
                }
            }
            if constexpr (Gate::kPrune == PRUNE_NODE) {
                q0 = lower_slot(smem, 0, p.m, r.oct, false);
                q1 = lower_slot(smem, q0, p.m, r.oct, true);
            }
            if (q0 < q1) {
                const int4* a4 = reinterpret_cast<const int4*>(p.a + (size_t)i * 8);
                const int4 a0 = a4[0], a1 = a4[1];
                for (int q = q0 + lane; q < q1; q += 32) {
                    const int j = Gate::kPrune == PRUNE_V ? perm[q]
                                  : Gate::kPrune == PRUNE_NODE ? p.col_perm[q] : q;
                    if (!Gate::pass(p, i, r, j)) continue;
                    const int4* b4 = reinterpret_cast<const int4*>(p.b + (size_t)j * 8);
                    const int d = popc8(a0, a1, b4[0], b4[1]);
                    const unsigned long long key = ((unsigned long long)d << 32) | (unsigned)j;
                    if (key < k1) {
                        k2 = k1;
                        k1 = key;
                    } else if (key < k2) {
                        k2 = key;
                    }
                }
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const unsigned long long o1 = __shfl_xor_sync(kAll, k1, off);
            const unsigned long long o2 = __shfl_xor_sync(kAll, k2, off);
            if (o1 < k1) {
                k2 = k1 < o2 ? k1 : o2;
                k1 = o1;
            } else {
                k2 = k2 < o1 ? k2 : o1;
            }
        }
        if (lane == 0) {
            const int n = p.n;
            const bool none1 = k1 == kNone || (int)(k1 >> 32) >= MAX_DIST;
            const bool none2 = k2 == kNone || (int)(k2 >> 32) >= MAX_DIST;
            p.out[i] = none1 ? 0 : (int)(k1 & 0xffffffffu);
            p.out[n + i] = none1 ? MAX_DIST : (int)(k1 >> 32);
            p.out[2 * n + i] = none2 ? 0 : (int)(k2 & 0xffffffffu);
            p.out[3 * n + i] = none2 ? MAX_DIST : (int)(k2 >> 32);
        }
    }
}

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
}

template <class Gate>
cudaError_t launch(const Best2Args& p, int blocks, cudaStream_t s) {
    const size_t bytes = Gate::kPrune == PRUNE_V      ? (size_t)(2 * NB + 1 + p.m) * sizeof(int)
                         : Gate::kPrune == PRUNE_NODE ? (size_t)p.m * sizeof(int)
                                                      : 0;
    if (bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            hamming_best2_kernel<Gate>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return e;
    }
    hamming_best2_kernel<Gate><<<blocks, THREADS, bytes, s>>>(p);
    return cudaGetLastError();
}

}  // namespace

// args: host pointer to a Best2Args. Launches the mode's instantiation over
// n rows (nothing when n == 0; m == 0 answers every row (0, 256, 0, 256))
// and writes the number of blocks back into `n_blocks`. The gated modes
// take at most MAX_COLUMNS columns.
extern "C" int hamming_best2_launch(void* args, void* stream) {
    Best2Args& p = *static_cast<Best2Args*>(args);
    p.n_blocks = 0;
    if (p.n < 0 || p.m < 0 || p.mode < MODE_MASK || p.mode > MODE_NODES ||
        (p.mode != MODE_MASK && p.m > MAX_COLUMNS))
        return (int)cudaErrorInvalidValue;
    if (p.n == 0) return 0;
    const int wanted = (p.n + WARPS - 1) / WARPS, sms = sm_count();
    const int blocks = wanted < sms ? wanted : sms;
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e;
    switch (p.mode) {
        case MODE_MASK: e = launch<GateMask>(p, blocks, s); break;
        case MODE_STEREO: e = launch<GateStereo>(p, blocks, s); break;
        case MODE_FRAME: e = launch<GateFrame>(p, blocks, s); break;
        case MODE_POINTS: e = launch<GatePoints>(p, blocks, s); break;
        case MODE_FUSE: e = launch<GateFuse>(p, blocks, s); break;
        default: e = launch<GateNodes>(p, blocks, s); break;
    }
    if (e == cudaSuccess) p.n_blocks = blocks;
    return (int)e;
}
