// K4: BoW vocabulary tree descent, the word id and the FeatureVector node
// of every descriptor of a frame.
//
// Replaces orbslam2_tpu/vocab/bow.py::transform_words_nodes (:57-85), the
// XLA program (a vmapped lax.scan of `depth` gather + XOR + popcount +
// argmin steps) that the TPU ran once per keyframe and once per
// relocalization attempt.
//
// Semantics reproduced exactly (bow.py::transform_words_nodes_plain in
// the port holds them in PyTorch):
//   * the descent starts at node 0 and takes `depth` steps; at each step
//     child j's distance is the Hamming distance between the descriptor and
//     children_desc[node, j], and a missing child (children_idx < 0) counts
//     1 << 30;
//   * the step goes to the child of least distance, ties to the lowest
//     child index (jnp.argmin); a node with no child at all stays put for
//     the remaining steps (ragged trees);
//   * the word is node_word[final node]; the FeatureVector node is the node
//     reached after `node_level` steps; an invalid slot answers -1 for both.
//
// Bound on the card. At the size the main path runs (the 78,274-word
// generic vocabulary: k = 10, depth 5, 88,950 nodes; N = 1200 descriptors
// of one keyframe) a call reads the descriptors (38 KB), the valid flags
// and the child rows of the nodes its descriptors visit (~1,900 nodes,
// 36 B per child), and writes 9.6 KB: ~0.2 us at 3.35 TB/s. Its 0.5 M
// integer operations (xor, popcount and add per word) are far below that.
//
// What holds it back is latency: the steps are dependent loads. The first
// design (one warp per descriptor, all from global memory) made a chain of
// thirteen round trips per descriptor: the flag, then the descriptor, five
// steps of a child id and then its row, then node_word.
//
// Design. One warp per descriptor, lane j on child j (two passes when
// k > 32); the warp takes the minimum of the keys (distance << 16 | j) with
// one __reduce_min_sync, which keeps the lowest index on a tie, and the
// lane that read the winner broadcasts its id and word by shuffles.
//   * The top of the tree is staged: vocab/bow.py::stage_table lays the
//     first L levels out breadth-first in a full k-ary numbering (the
//     children of staged node s are staged nodes s * k + 1 + j, holes for
//     missing children), per staged child its 32-byte row, its global id
//     and its word. The generic vocabulary is numbered depth-first, so the
//     table is a remap, not a prefix of the node array. Every block copies
//     it into shared memory with cp.async while its warps load their
//     descriptors, so the first L steps never leave the SM.
//   * The winning child brings its word (children_word [n_nodes, k]), so
//     a step below the staged levels reads child id, word and row in one
//     trip (the row is read whether or not the child exists: loaded only
//     for a present child, it would take a second trip), and node_word is
//     read once, for the root, in the descriptor's trip.
//   * The flag, the descriptor and the root's word load together, before
//     the table's copy is waited for; an invalid slot walks the tree like
//     any other and writes -1.
//   * The grid is sized for the staging: ceil(N / SMs) warps per block, so
//     about one block per SM copies the table.
// vocab/bow.py picks L from k and a shared-memory budget: 2 for k = 10
// (4,400 bytes), where 3 (44,400 bytes) measured slower, its copy into
// every block costing more than the step it saves. At depth 5 and L = 2 a
// descriptor makes four global round trips (its own, then the three steps
// below the staged levels) in place of the first design's thirteen: that
// design loaded each row only after its child id, two trips a step. The
// FeatureVector node may lie inside the staged levels (level 1 at depth
// 5): the walk carries the global id, never the local one.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kMissing = 0xffffu;  // a key's distance part for a missing child (> 256)
constexpr int kMaxWarps = 32;           // warps per block

// Mirrors vocab/bow.py::_K4Args.
struct BowArgs {
    const int* desc;              // [n, 8] descriptor words, 16-byte aligned
    const unsigned char* valid;   // [n] bool
    const int* children_desc;     // [n_nodes, k, 8], 16-byte aligned
    const int* children_idx;      // [n_nodes, k]
    const int* children_word;     // [n_nodes, k]: node_word of each child, -1 when missing
    const int* node_word;         // [n_nodes]: only the root's is read
    const int* stage;             // the staged table (bow.py::stage_table), 16-byte aligned
    int* out;                     // [2, n]: word ids, FeatureVector node ids
    int n, k, depth, node_level, n_nodes;
    int stage_levels;             // L: levels of nodes whose children are staged
    int stage_ints;               // int32 words of `stage`
    int n_blocks;                 // written back by the launcher
};

__device__ __forceinline__ int popc8(const int4 a, const int4 b, const int4 d0, const int4 d1) {
    return __popc(a.x ^ d0.x) + __popc(a.y ^ d0.y) + __popc(a.z ^ d0.z) + __popc(a.w ^ d0.w) +
           __popc(b.x ^ d1.x) + __popc(b.y ^ d1.y) + __popc(b.z ^ d1.z) + __popc(b.w ^ d1.w);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

struct Row {
    int4 lo, hi;  // the two 16-byte halves of a child's 32-byte row
};

// Loads from the read-only path for the descriptor's trip and the steps
// below the staged levels. Volatile, so that the compiler issues them where
// they stand, all of a trip's together: left to itself it loaded a row only
// once the child id said the child exists, and the descriptor only after
// the table's copy had landed, each a second round trip.
__device__ __forceinline__ int4 load_v4(const int4* p) {
    int4 v;
    asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
}

__device__ __forceinline__ int load_s32(const int* p) {
    int v;
    asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

__device__ __forceinline__ unsigned load_u8(const unsigned char* p) {
    unsigned v;
    asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

// One step from the node whose k child slots start at `base`: `load(e, r,
// iw)` reads slot e's row and its (child id, child word), from shared or
// global memory, in one trip. Returns false when the node has no child (the
// walk stays put); else sets `slot` to the winner's child index and `win`
// to its id and word.
template <class LoadFn>
__device__ __forceinline__ bool step(LoadFn load, size_t base, int k, int lane, const int4 d0, const int4 d1,
                                     int& slot, int2& win) {
    unsigned best = kAll;
    for (int j0 = 0; j0 < k; j0 += 32) {
        const int j = j0 + lane;
        unsigned key = kAll;
        int2 e = make_int2(-1, -1);
        if (j < k) {
            Row r;
            load(base + j, r, e);
            const unsigned dist = (unsigned)popc8(r.lo, r.hi, d0, d1);  // read and ignored when missing
            key = ((e.x >= 0 ? dist : kMissing) << 16) | (unsigned)j;
        }
        const unsigned m = __reduce_min_sync(kAll, key);
        const int owner = (int)(m & 31u);  // j0 + owner is the winner when it lies in this pass
        const int2 w = make_int2(__shfl_sync(kAll, e.x, owner), __shfl_sync(kAll, e.y, owner));
        if (m < best) {
            best = m;
            win = w;
        }
    }
    // no child at all: every key is missing (or the node has k == 0)
    if (best == kAll || (best >> 16) == kMissing) return false;
    slot = (int)(best & 0xffffu);
    return true;
}

__global__ void __launch_bounds__(kMaxWarps * 32) bow_transform_kernel(const BowArgs p, const int entries) {
    // [entries] int4 low halves, [entries] int4 high halves, [entries] int2
    // (global id, word), as bow.py::stage_table lays them out
    extern __shared__ int4 staged[];
    // first, in one trip: this warp's descriptor, its flag, the root's
    // word (a warp past the end reads the last descriptor and writes
    // nothing), so that the trip overlaps the table's copy
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    const bool live = i < p.n;
    const int4* d = reinterpret_cast<const int4*>(p.desc + (size_t)min(i, p.n - 1) * 8);
    const int4 d0 = load_v4(d), d1 = load_v4(d + 1);
    const bool ok = load_u8(p.valid + min(i, p.n - 1)) != 0;
    int word = load_s32(p.node_word);
    const int n16 = p.stage_ints / 4;
    const int4* src = reinterpret_cast<const int4*>(p.stage);
    for (int c = threadIdx.x; c < n16; c += blockDim.x) cp_async16(staged + c, src + c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (!live) return;  // a whole warp leaves together

    const int4* s_lo = staged;
    const int4* s_hi = staged + entries;
    const int2* s_iw = reinterpret_cast<const int2*>(staged + 2 * entries);
    const int L = min(p.stage_levels, p.depth);
    int g = 0, level_node = -1, slot = 0;
    int2 win = make_int2(0, 0);
    bool moving = true;
    int st = 0;
    // the staged levels: local node s, its children at s * k + j in the table
    for (int s = 0; st < L; ++st) {
        moving = step(
            [&](size_t e, Row& r, int2& iw) {
                r = Row{s_lo[e], s_hi[e]};
                iw = s_iw[e];
            },
            (size_t)s * p.k, p.k, lane, d0, d1, slot, win);
        if (!moving) break;
        g = win.x;
        word = win.y;
        s = s * p.k + 1 + slot;
        if (st == p.node_level - 1) level_node = g;
    }
    // below them, from global memory: child id, word and row in one trip
    const int4* c_desc = reinterpret_cast<const int4*>(p.children_desc);
    for (; moving && st < p.depth; ++st) {
        const size_t base = (size_t)g * p.k;
        moving = step(
            [&](size_t e, Row& r, int2& iw) {
                r = Row{load_v4(c_desc + 2 * e), load_v4(c_desc + 2 * e + 1)};
                iw = make_int2(load_s32(p.children_idx + e), load_s32(p.children_word + e));
            },
            base, p.k, lane, d0, d1, slot, win);
        if (!moving) break;
        g = win.x;
        word = win.y;
        if (st == p.node_level - 1) level_node = g;
    }
    // a walk that stopped early stays at g for the remaining levels
    if (level_node < 0) level_node = g;
    if (lane == 0) {
        p.out[i] = ok ? word : -1;
        p.out[p.n + i] = ok ? level_node : -1;
    }
}

}  // namespace

// args: host pointer to a BowArgs. Launches one warp per descriptor,
// ceil(n / SMs) warps per block (at most 32), with the staged table in
// dynamic shared memory (nothing when n == 0), and writes the number of
// blocks back into `n_blocks`. Takes 1 <= node_level <= depth, k < 65536,
// 0 <= stage_levels <= depth and a table of at least the staged entries
// that fits the shared memory a block of the current device may opt into.
extern "C" int bow_transform_launch(void* args, void* stream) {
    BowArgs& p = *static_cast<BowArgs*>(args);
    p.n_blocks = 0;
    if (p.n < 0 || p.k < 0 || p.k >= 65536 || p.depth < 1 || p.node_level < 1 ||
        p.node_level > p.depth || p.n_nodes < 1 || p.stage_levels < 0 || p.stage_levels > p.depth)
        return (int)cudaErrorInvalidValue;
    // staged children: k + k^2 + ... + k^L, each 10 int32 words of the
    // table (a 32-byte row, global id and word)
    long long entries = 0, level = 1;
    for (int l = 0; l < p.stage_levels; ++l) {
        entries += level * p.k;
        level *= p.k;
        if (10 * entries > p.stage_ints) return (int)cudaErrorInvalidValue;
    }
    if (p.stage_ints % 4 != 0) return (int)cudaErrorInvalidValue;
    if (p.n == 0) return 0;
    int dev = 0, sms = 0, max_shared = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&max_shared, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    const size_t bytes = (size_t)p.stage_ints * 4;
    if (sms < 1 || bytes > (size_t)max_shared) return (int)cudaErrorInvalidValue;
    if (bytes > 48 * 1024) {
        e = cudaFuncSetAttribute(bow_transform_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const int warps = std::min(kMaxWarps, (p.n + sms - 1) / sms);
    const int blocks = (p.n + warps - 1) / warps;
    bow_transform_kernel<<<blocks, warps * 32, bytes, (cudaStream_t)stream>>>(p, (int)entries);
    p.n_blocks = blocks;
    return (int)cudaGetLastError();
}
