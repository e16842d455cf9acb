// K2: FAST-9/16 corner score fused with 3x3 non-maximum suppression.
//
// Replaces orbslam2_tpu/ops/fast.py::fast_score (:25-61) and ::nms3
// (:64-76), fused as orbslam2_tpu/ops/orb.py:216-217 uses them: the output
// is the masked score `s = where(nms3(score), score, 0)` of one pyramid
// level, for every image of the batch in one launch.
//
// Bound on the card: memory. Each pixel is read once from device memory
// and written once (8 bytes per pixel; ~1.4 MB for a 752x480 stereo pair
// at level 0); the 16-pixel ring and the 3x3 neighbourhood are served from
// shared memory. A block owns a TILE_H x TILE_W output tile and loads the
// image with a halo of 4 (3 for the ring, 1 for NMS), replicating edge
// pixels exactly like `jnp.pad(mode="edge")`. Scores outside the image
// take -inf in the NMS window, like `reduce_window` padding.
//
// Min and max are exact, so the result equals the plain version bit for
// bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int HALO = 4;
constexpr int SW = TILE_W + 2 * HALO;
constexpr int SH = TILE_H + 2 * HALO;

// Bresenham circle of radius 3 (dx, dy), clockwise (ops/fast.py CIRCLE).
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ float fast_score_at(float (*s_img)[SW], int r, int c) {
    const float center = s_img[r][c];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = s_img[r + kCircleDy[k]][c + kCircleDx[k]] - center;
    float score = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        float mn = d[k], mx = d[k];
#pragma unroll
        for (int j = 1; j < 9; ++j) {
            const float v = d[(k + j) & 15];
            mn = fminf(mn, v);
            mx = fmaxf(mx, v);
        }
        score = fmaxf(score, mn);
        score = fmaxf(score, -mx);
    }
    return fmaxf(score, 0.0f);
}

__global__ void fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                                int H, int W) {
    __shared__ float s_img[SH][SW];
    __shared__ float s_sc[TILE_H + 2][TILE_W + 2];

    const float* im = img + (size_t)blockIdx.z * H * W;
    float* o = out + (size_t)blockIdx.z * H * W;
    const int x0 = blockIdx.x * TILE_W;
    const int y0 = blockIdx.y * TILE_H;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthr = blockDim.x * blockDim.y;

    for (int i = tid; i < SH * SW; i += nthr) {
        const int r = i / SW, c = i % SW;
        const int gy = min(max(y0 - HALO + r, 0), H - 1);
        const int gx = min(max(x0 - HALO + c, 0), W - 1);
        s_img[r][c] = im[(size_t)gy * W + gx];
    }
    __syncthreads();

    // scores on the tile plus a 1-pixel ring (the NMS neighbourhood)
    for (int i = tid; i < (TILE_H + 2) * (TILE_W + 2); i += nthr) {
        const int r = i / (TILE_W + 2), c = i % (TILE_W + 2);
        const int gy = y0 - 1 + r, gx = x0 - 1 + c;
        s_sc[r][c] = (gy < 0 || gy >= H || gx < 0 || gx >= W)
                         ? -CUDART_INF_F
                         : fast_score_at(s_img, r + HALO - 1, c + HALO - 1);
    }
    __syncthreads();

    for (int i = tid; i < TILE_H * TILE_W; i += nthr) {
        const int r = i / TILE_W, c = i % TILE_W;
        const int gy = y0 + r, gx = x0 + c;
        if (gy >= H || gx >= W) continue;
        const float s = s_sc[r + 1][c + 1];
        float m = -CUDART_INF_F;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, s_sc[r + dy][c + dx]);
        o[(size_t)gy * W + gx] = (s >= m && s > 0.0f) ? s : 0.0f;
    }
}

}  // namespace

// img, out: float32 [B, H, W] contiguous.
extern "C" int fast_nms_launch(const void* img, void* out, int B, int H, int W, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
    fast_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)img, (float*)out, H, W);
    return (int)cudaGetLastError();
}
