// K1: per-keypoint 48x48 patch fetch fused with the ORB descriptor math,
// over every keypoint of every pyramid level of a frame in one launch.
//
// Replaces the repo's Pallas kernel orbslam2_tpu/ops/patches.py::
// extract_patches (body _patch_kernel :34-65, pallas_call :103), which the
// TPU ran once per level on a reflect-padded, 8x128-aligned copy of the
// level, together with orbslam2_tpu/ops/orb.py::_features_from_patches
// (:350-393).
//
// Bound on the card. Per keypoint ~56 kFLOP: the row blur 48x42x7 and the
// column blur 42x42x7 multiply-adds (28.2 + 24.7 kFLOP), the two moments
// over the 749-pixel disc (3.0 kFLOP) and 256 comparisons; for the 2400
// keypoints of a 752x480 stereo frame 134 MFLOP, 2.0 us at 67 TFLOP/s.
// Bytes: the pixels of the windows (at most the 2.23 M-pixel stereo
// pyramid, 8.9 MB, 2.7 us at 3.35 TB/s; the union of this frame's windows
// is what a run counts), 8 bytes of coordinates in and 36 bytes of angle
// and descriptor out per keypoint. Both bounds are a few microseconds; the
// kernel's cost is latency: 9 KB loaded per block, three barriers, 2400
// blocks in ~2.3 waves.
//
// Design. One block of 256 threads per keypoint, one launch for all levels
// and both eyes. The wrapper passes one descriptor per level (the
// UNPADDED level image, the keypoint coordinates and their count); the
// launcher adds the level's slot offset in the frame's outputs and its
// first block, and passes the descriptors by value in the
// kernel-parameter struct `PatchArgs`; a block finds its level from the
// descriptors' first blocks and writes angle and descriptor straight into
// the frame's [n_images, n_slots] outputs, so neither a padded copy of the
// level nor a concatenation of per-level outputs exists. The block reads
// its window with coalesced loads, computing `jnp.pad(mode="reflect")`'s
// source indices itself (i < 0 -> -i, i >= n -> 2n - 2 - i) after
// clamping the window start in padded coordinates exactly as the plain
// fetch does; TMA does not fit, since it fills out-of-bounds elements with
// zeros, not reflections. From shared memory it
//   * reduces the intensity-centroid moments m10, m01 over the radius-15
//     disc (the `_W2` weights, given by the disc's row extents umax): warp
//     shuffles, then each warp finishes the 8 warp partials with three more
//     shuffles and every thread takes angle = atan2f(m01, m10) itself;
//   * runs the separable 7-tap sigma=2 blur (the `_BLUR_BAND` taps) into a
//     42x42 tile written over the window, which is dead by then;
//   * takes the rotation bin as rintf(angle * 32 / 2pi) mod 32 (jnp.round
//     rounds half to even, which is rintf);
//   * makes the 256 `<` comparisons at `_BIN_FLAT[bin]` (int16 [32, 512] in
//     global memory: as int32 the table would fill all 64 KB of constant
//     memory), one pair per thread, and packs them with a warp ballot: bit j
//     of word w is pair 32w + j (orb.py:388-392).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int PATCH = 48;
constexpr int BLUR = 42;
constexpr int PATCH_C = 21;  // keypoint offset inside the patch
constexpr int PAD = 24;      // the plain version's reflect padding of the level
constexpr int THREADS = 256;
constexpr float kBinsPerRadian = 5.092958178940651f;  // 32 / (2 pi)

// One pyramid level.
struct PatchLevel {
    const float* img;  // [n_images, h, w] float32, contiguous, h and w > PAD
    const int* xs;     // [n_images, n] int32 level coordinates
    const int* ys;
    int h, w;
    int n;       // keypoints per image
    int offset;  // slot of the level's first keypoint in the outputs
    int first;   // first block of the level in the flat grid
};

struct PatchArgs {
    PatchLevel lv[MAX_LEVELS];
    const short* bin_flat;  // int16 [32, 512]
    const float* g7;        // float32 [7]
    const int* umax;        // int32 [16]
    float* angle;           // float32 [n_images, n_slots]
    int* desc;              // int32 [n_images, n_slots, 8]
    int n_levels;
    int n_slots;
};

// What the wrapper passes (ops/patches.py `_Args`): per level the image,
// the keypoints and their count per image; the launcher fills in the slot
// offsets and the grid.
struct PatchLevelIn {
    const float* img;
    const int* xs;
    const int* ys;
    int h, w;
    int n;
};

struct PatchArgsIn {
    PatchLevelIn lv[MAX_LEVELS];
    const short* bin_flat;
    const float* g7;
    const int* umax;
    float* angle;  // [n_images, sum of n]
    int* desc;     // [n_images, sum of n, 8]
    int n_levels;
    int n_images;
    int n_blocks;  // set by the launcher: blocks launched, 0 if none
};

// `jnp.pad(mode="reflect")`: source index of index i of a padded axis of
// length n (valid for -n < i < 2n - 1)
__device__ __forceinline__ int reflect(int i, int n) {
    return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__global__ void __launch_bounds__(THREADS) orb_patch_desc_kernel(const PatchArgs a) {
    __shared__ float P[PATCH * PATCH];  // the window, then the blurred 42x42 tile
    __shared__ float T[PATCH * BLUR];   // row-blurred window
    __shared__ float red[2][THREADS / 32];
    __shared__ float g[7];
    __shared__ int um[16];

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;

    // the block's level: the last whose first block is <= blockIdx.x
    // (unrolled selects keep the parameter struct out of local memory)
    const int blk = blockIdx.x;
    PatchLevel L = a.lv[0];
#pragma unroll
    for (int i = 1; i < MAX_LEVELS; ++i)
        if (i < a.n_levels && blk >= a.lv[i].first) L = a.lv[i];

    const int local = blk - L.first;  // = image * n + keypoint
    const int image = local / L.n;
    const int slot = image * a.n_slots + L.offset + (local - image * L.n);
    const int h = L.h, w = L.w;
    const float* im = L.img + (size_t)image * h * w;
    // window start clamped into the padded level, as the plain fetch does,
    // then taken back to level coordinates
    const int r0 = min(max(L.ys[local] + PAD - PATCH_C, 0), h + 2 * PAD - PATCH) - PAD;
    const int c0 = min(max(L.xs[local] + PAD - PATCH_C, 0), w + 2 * PAD - PATCH) - PAD;

    if (tid < 7) g[tid] = a.g7[tid];
    if (tid < 16) um[tid] = a.umax[tid];
    for (int i = tid; i < PATCH * PATCH; i += THREADS) {
        const int r = i / PATCH, c = i - r * PATCH;
        P[i] = __ldg(im + (size_t)reflect(r0 + r, h) * w + reflect(c0 + c, w));
    }
    __syncthreads();

    // intensity-centroid moments over the radius-15 disc
    float a10 = 0.0f, a01 = 0.0f;
    for (int i = tid; i < 31 * 31; i += THREADS) {
        const int dy = i / 31 - 15, dx = i % 31 - 15;
        if (abs(dx) <= um[abs(dy)]) {
            const float v = P[(PATCH_C + dy) * PATCH + PATCH_C + dx];
            a10 += (float)dx * v;
            a01 += (float)dy * v;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a10 += __shfl_xor_sync(0xffffffffu, a10, off);
        a01 += __shfl_xor_sync(0xffffffffu, a01, off);
    }
    if (lane == 0) {
        red[0][warp] = a10;
        red[1][warp] = a01;
    }

    // separable 7-tap blur: rows into T ...
    for (int i = tid; i < PATCH * BLUR; i += THREADS) {
        const int r = i / BLUR, c = i - r * BLUR;
        float s = 0.0f;
#pragma unroll
        for (int t = 0; t < 7; ++t) s += g[t] * P[r * PATCH + c + t];
        T[i] = s;
    }
    __syncthreads();
    // ... then columns, over the window (every read of P is done)
    for (int i = tid; i < BLUR * BLUR; i += THREADS) {
        const int r = i / BLUR, c = i - r * BLUR;
        float s = 0.0f;
#pragma unroll
        for (int t = 0; t < 7; ++t) s += g[t] * T[(r + t) * BLUR + c];
        P[i] = s;
    }

    // every warp sums the 8 warp partials by a butterfly over lanes 0-7
    // (pairwise sums commute, so every lane gets the same bits)
    float m10 = red[0][lane & 7], m01 = red[1][lane & 7];
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
        m10 += __shfl_xor_sync(0xffffffffu, m10, off);
        m01 += __shfl_xor_sync(0xffffffffu, m01, off);
    }
    const float ang = atan2f(m01, m10);
    if (tid == 0) a.angle[slot] = ang;
    int bin = (int)rintf(ang * kBinsPerRadian) % 32;
    if (bin < 0) bin += 32;
    __syncthreads();

    const short* idx = a.bin_flat + bin * 512;
    const bool bit = P[idx[tid]] < P[idx[256 + tid]];
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) a.desc[slot * 8 + warp] = (int)word;
}

}  // namespace

// args: host pointer to a PatchArgsIn. Places each level's keypoints at the
// next free slots and one block per keypoint in one grid, launches it if it
// is not empty, and writes the number of blocks back into `n_blocks`.
extern "C" int orb_patch_desc_levels_launch(void* args, void* stream) {
    PatchArgsIn& in = *static_cast<PatchArgsIn*>(args);
    in.n_blocks = 0;
    if (in.n_levels < 1 || in.n_levels > MAX_LEVELS || in.n_images < 0)
        return (int)cudaErrorInvalidValue;
    PatchArgs a = {};
    int offset = 0, first = 0;
    for (int i = 0; i < in.n_levels; ++i) {
        const PatchLevelIn& l = in.lv[i];
        a.lv[i] = PatchLevel{l.img, l.xs, l.ys, l.h, l.w, l.n, offset, first};
        offset += l.n;
        first += in.n_images * l.n;
    }
    a.bin_flat = in.bin_flat;
    a.g7 = in.g7;
    a.umax = in.umax;
    a.angle = in.angle;
    a.desc = in.desc;
    a.n_levels = in.n_levels;
    a.n_slots = offset;
    if (first == 0) return 0;
    orb_patch_desc_kernel<<<first, THREADS, 0, (cudaStream_t)stream>>>(a);
    in.n_blocks = first;
    return (int)cudaGetLastError();
}
