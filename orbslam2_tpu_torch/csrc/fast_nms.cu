// K2: FAST-9/16 corner score fused with 3x3 non-maximum suppression, over
// every pyramid level and image of a frame in one launch.
//
// Replaces orbslam2_tpu/ops/fast.py::fast_score (:25-61) and ::nms3
// (:64-76), the XLA programs the TPU ran once per pyramid level, fused as
// orbslam2_tpu/ops/orb.py:216-217 uses them: each level's output is the
// masked score `s = where(nms3(score), score, 0)`.
//
// Bound on the card. The 752x480 stereo pair at 8 levels (scale 1.2) is a
// pyramid of 2.23 M pixels: 8.9 MB read and 8.9 MB written, 17.9 MB per
// frame (5.3 us at 3.35 TB/s; the level-0 pair alone is 5.8 MB). The score
// takes ~186 fp32 operations per pixel (16 subtractions, 64 min and 64 max
// for the 16 arcs of 9, 32 max for the score, 10 for the NMS), 417 M per
// frame (6.2 us at 67 TFLOP/s): operations set the bound, narrowly.
//
// Design. One launch per frame. The wrapper passes one descriptor per level
// (image and output pointers, height, width); the launcher lays the tiles of
// every level and image out in one flat grid and passes the descriptors,
// with each level's tile counts and first block, by value in the
// kernel-parameter struct `FastLevels`, so nothing is packed or copied to
// the device; a block finds its level from the descriptors' first blocks. A
// block owns a 64x32 output tile and loads a 72x40 halo (4 = 3 for the ring
// + 1 for the NMS), 1.41x its own pixels, replicating edge pixels like
// `jnp.pad(mode="edge")`; scores outside the image are -inf in the NMS
// window, like `reduce_window`'s padding. The 16 ring differences sit in
// registers and the 16 arcs of 9 are taken by log-doubling (2, 4, 8, then
// + 1 = 9), the `win9` scheme of the plain version: 64 min and 64 max per
// pixel where a window-by-window scan takes 256.
//
// Every step is a min, a max or one float subtraction, so the result equals
// the plain version bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int THREADS = 256;
constexpr int TILE_W = 64;
constexpr int TILE_H = 32;
constexpr int HALO = 4;
constexpr int SW = TILE_W + 2 * HALO;  // loaded tile: 72 x 40
constexpr int SH = TILE_H + 2 * HALO;
constexpr int CW = TILE_W + 2;  // scored tile (output + the NMS ring): 66 x 34
constexpr int CH = TILE_H + 2;

// The Bresenham circle of radius 3, clockwise (ops/fast.py CIRCLE), as
// offsets into the loaded tile: dy * SW + dx.
__constant__ int kRing[16] = {
    -3 * SW,     -3 * SW + 1, -2 * SW + 2, -SW + 3, 3,  SW + 3,      2 * SW + 2, 3 * SW + 1,
    3 * SW,      3 * SW - 1,  2 * SW - 2,  SW - 3,  -3, -SW - 3,     -2 * SW - 2, -3 * SW - 1,
};

// One pyramid level: [n_images, h, w] float32 image and output, contiguous.
struct FastLevel {
    const float* img;
    float* out;
    int h, w;
    int tiles_x;  // tiles per row of tiles
    int tiles;    // tiles per image
    int first;    // first block of the level in the flat grid
};

struct FastLevels {
    FastLevel lv[MAX_LEVELS];
    int n_levels;
};

// What the wrapper passes (ops/fast.py `_Levels`): per level the image and
// output and their size; the launcher fills in the tile layout.
struct FastLevelIn {
    const float* img;
    float* out;
    int h, w;
};

struct FastLevelsIn {
    FastLevelIn lv[MAX_LEVELS];
    int n_levels;
    int n_images;  // images per level
    int n_blocks;  // set by the launcher: blocks launched, 0 if none
};

// FAST score of the pixel at `s` in the loaded tile: the largest threshold
// at which 9 contiguous ring pixels are all brighter or all darker.
__device__ __forceinline__ float fast_score_at(const float* s) {
    const float center = s[0];
    float d[16], a[16], b[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = s[kRing[k]] - center;

    float score = 0.0f;
    // darkest of each arc of 9: min over 2, 4, 8, then the 9th pixel
#pragma unroll
    for (int k = 0; k < 16; ++k) a[k] = fminf(d[k], d[(k + 1) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) b[k] = fminf(a[k], a[(k + 2) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) a[k] = fminf(b[k], b[(k + 4) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) score = fmaxf(score, fminf(a[k], d[(k + 8) & 15]));
    // brightest of each arc of 9, negated
#pragma unroll
    for (int k = 0; k < 16; ++k) a[k] = fmaxf(d[k], d[(k + 1) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) b[k] = fmaxf(a[k], a[(k + 2) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) a[k] = fmaxf(b[k], b[(k + 4) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) score = fmaxf(score, -fmaxf(a[k], d[(k + 8) & 15]));
    return score;
}

__global__ void __launch_bounds__(THREADS) fast_nms_kernel(const FastLevels p) {
    __shared__ float s_img[SH * SW];
    __shared__ float s_sc[CH * CW];

    // the block's level: the last whose first block is <= blockIdx.x
    // (unrolled selects keep the parameter struct out of local memory)
    const int blk = blockIdx.x;
    FastLevel L = p.lv[0];
#pragma unroll
    for (int i = 1; i < MAX_LEVELS; ++i)
        if (i < p.n_levels && blk >= p.lv[i].first) L = p.lv[i];

    const int local = blk - L.first;
    const int image = local / L.tiles;
    const int tile = local - image * L.tiles;
    const int ty = tile / L.tiles_x;
    const int x0 = (tile - ty * L.tiles_x) * TILE_W;
    const int y0 = ty * TILE_H;
    const int H = L.h, W = L.w;
    const float* im = L.img + (size_t)image * H * W;
    float* o = L.out + (size_t)image * H * W;
    const int tid = threadIdx.x;

    for (int i = tid; i < SH * SW; i += THREADS) {
        const int r = i / SW, c = i - r * SW;
        const int gy = min(max(y0 - HALO + r, 0), H - 1);
        const int gx = min(max(x0 - HALO + c, 0), W - 1);
        s_img[i] = __ldg(im + (size_t)gy * W + gx);
    }
    __syncthreads();

    // scores of the tile plus a 1-pixel ring (the NMS neighbourhood)
    for (int i = tid; i < CH * CW; i += THREADS) {
        const int r = i / CW, c = i - r * CW;
        const int gy = y0 - 1 + r, gx = x0 - 1 + c;
        s_sc[i] = (gy < 0 || gy >= H || gx < 0 || gx >= W)
                      ? -CUDART_INF_F
                      : fast_score_at(s_img + (r + HALO - 1) * SW + c + HALO - 1);
    }
    __syncthreads();

    for (int i = tid; i < TILE_H * TILE_W; i += THREADS) {
        const int r = i / TILE_W, c = i % TILE_W;
        const int gy = y0 + r, gx = x0 + c;
        if (gy >= H || gx >= W) continue;
        const float* q = s_sc + r * CW + c;
        const float s = q[CW + 1];
        float m = -CUDART_INF_F;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, q[dy * CW + dx]);
        o[(size_t)gy * W + gx] = (s >= m && s > 0.0f) ? s : 0.0f;
    }
}

}  // namespace

// levels: host pointer to a FastLevelsIn. Lays the tiles of every level and
// image out in one grid, launches it if it is not empty, and writes the
// number of blocks back into `n_blocks`.
extern "C" int fast_nms_levels_launch(void* levels, void* stream) {
    FastLevelsIn& in = *static_cast<FastLevelsIn*>(levels);
    in.n_blocks = 0;
    if (in.n_levels < 1 || in.n_levels > MAX_LEVELS || in.n_images < 0)
        return (int)cudaErrorInvalidValue;
    FastLevels p = {};
    p.n_levels = in.n_levels;
    int first = 0;
    for (int i = 0; i < in.n_levels; ++i) {
        const FastLevelIn& l = in.lv[i];
        const int tiles_x = (l.w + TILE_W - 1) / TILE_W;
        const int tiles = tiles_x * ((l.h + TILE_H - 1) / TILE_H);
        p.lv[i] = FastLevel{l.img, l.out, l.h, l.w, tiles_x, tiles, first};
        first += in.n_images * tiles;
    }
    if (first == 0) return 0;
    fast_nms_kernel<<<first, THREADS, 0, (cudaStream_t)stream>>>(p);
    in.n_blocks = first;
    return (int)cudaGetLastError();
}
