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
// and at most N * depth * k * 36 B of tree rows (2.2 MB: each visited
// node's k child descriptors and ids), and writes 9.6 KB: ~0.65 us at 3.35
// TB/s. Its 0.5 M integer operations (xor, popcount and add per word)
// are far below that. The 28.5 MB children table fits the 50 MB L2, and
// the nodes near the root are shared by every descriptor.
//
// Design. One warp per descriptor: lane j < k reads child j's 32-byte row
// as two int4 loads and computes its distance with __popc; the warp takes
// the minimum of the keys (distance << 16 | j) with one __reduce_min_sync,
// which keeps the lowest index on a tie, and every lane moves to the
// winner's child id, which the lane that read it broadcasts with one
// shuffle. A key above any distance marks a missing child; when every key
// says missing the node has no child and the descent stays put. The five
// steps are dependent loads, so latency, not bytes, sets the time: the
// design keeps each step at one load round trip (row and child id read
// together) and puts 8 descriptors in a block of 256 threads so that
// N / 8 blocks keep every SM busy.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // descriptors per block
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kMissing = 0xffffu;  // a key's distance part for a missing child (> 256)

// Mirrors vocab/bow.py::_K4Args.
struct BowArgs {
    const int* desc;              // [n, 8] descriptor words, 16-byte aligned
    const unsigned char* valid;   // [n] bool
    const int* children_desc;     // [n_nodes, k, 8], 16-byte aligned
    const int* children_idx;      // [n_nodes, k]
    const int* node_word;         // [n_nodes]
    int* out;                     // [2, n]: word ids, FeatureVector node ids
    int n, k, depth, node_level, n_nodes;
    int n_blocks;                 // written back by the launcher
};

__device__ __forceinline__ int popc8(const int4 a, const int4 b, const int4 d0, const int4 d1) {
    return __popc(a.x ^ d0.x) + __popc(a.y ^ d0.y) + __popc(a.z ^ d0.z) + __popc(a.w ^ d0.w) +
           __popc(b.x ^ d1.x) + __popc(b.y ^ d1.y) + __popc(b.z ^ d1.z) + __popc(b.w ^ d1.w);
}

__global__ void __launch_bounds__(THREADS) bow_transform_kernel(const BowArgs p) {
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (i >= p.n) return;  // a whole warp leaves together
    int* words = p.out;
    int* nodes = p.out + p.n;
    if (!p.valid[i]) {
        if (lane == 0) {
            words[i] = -1;
            nodes[i] = -1;
        }
        return;
    }
    const int4* d = reinterpret_cast<const int4*>(p.desc + (size_t)i * 8);
    const int4 d0 = d[0], d1 = d[1];
    int node = 0, level_node = 0;
    for (int step = 0; step < p.depth; ++step) {
        // lanes stride over the children (one pass when k <= 32)
        unsigned best = kAll;
        int best_child = -1;
        for (int j0 = 0; j0 < p.k; j0 += 32) {
            const int j = j0 + lane;
            unsigned key = kAll;
            int child = -1;
            if (j < p.k) {
                const size_t slot = (size_t)node * p.k + j;
                child = p.children_idx[slot];
                const int4* c = reinterpret_cast<const int4*>(p.children_desc + slot * 8);
                const unsigned dist = child >= 0 ? (unsigned)popc8(c[0], c[1], d0, d1) : kMissing;
                key = (dist << 16) | (unsigned)j;
            }
            const unsigned m = __reduce_min_sync(kAll, key);
            const int owner = (int)(m & 31u);  // j0 + owner is the winner when it lies in this pass
            const int c_win = __shfl_sync(kAll, child, owner);
            if (m < best) {
                best = m;
                best_child = c_win;
            }
        }
        // no child at all: every key is missing (or the node has k == 0)
        if (best != kAll && (best >> 16) != kMissing) node = best_child;
        if (step == p.node_level - 1) level_node = node;
    }
    if (lane == 0) {
        words[i] = p.node_word[node];
        nodes[i] = level_node;
    }
}

}  // namespace

// args: host pointer to a BowArgs. Launches one warp per descriptor
// (nothing when n == 0) and writes the number of blocks back into
// `n_blocks`. Takes 1 <= node_level <= depth and k < 65536.
extern "C" int bow_transform_launch(void* args, void* stream) {
    BowArgs& p = *static_cast<BowArgs*>(args);
    p.n_blocks = 0;
    if (p.n < 0 || p.k < 0 || p.k >= 65536 || p.depth < 1 || p.node_level < 1 ||
        p.node_level > p.depth || p.n_nodes < 1)
        return (int)cudaErrorInvalidValue;
    if (p.n == 0) return 0;
    const int blocks = (p.n + WARPS - 1) / WARPS;
    bow_transform_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
    p.n_blocks = blocks;
    return (int)cudaGetLastError();
}
