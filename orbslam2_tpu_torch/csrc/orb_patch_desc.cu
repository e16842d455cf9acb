// K1: per-keypoint 48x48 patch fetch fused with the ORB descriptor math.
//
// Replaces the repo's Pallas kernel orbslam2_tpu/ops/patches.py::
// extract_patches (body _patch_kernel :34-65, pallas_call :103) together
// with orbslam2_tpu/ops/orb.py::_features_from_patches (:350-393).
//
// One block per keypoint, both eyes in one launch. The block reads its
// 48x48 window straight from the level image (padded by 24 px with reflect
// padding in the wrapper, `F.pad(mode="reflect")` matching
// `jnp.pad(mode="reflect")` at orb.py:442) into shared memory; none of the
// TPU's (8, 128) alignment envelope is kept. From shared memory it
//   * reduces the intensity-centroid moments m10, m01 over the radius-15
//     disc (the `_W2` weights, given here by the disc's row extents umax),
//     then angle = atan2f(m01, m10);
//   * runs the separable 7-tap sigma=2 blur (the `_BLUR_BAND` taps) into a
//     42x42 tile;
//   * takes the rotation bin as rintf(angle * 32 / 2pi) mod 32 (jnp.round
//     rounds half to even, which is rintf);
//   * makes the 256 `<` comparisons at `_BIN_FLAT[bin]` (int16 [32, 512] in
//     global memory: as int32 the table would fill all 64 KB of constant
//     memory), one pair per thread, and packs them with a warp ballot: bit j
//     of word w is pair 32w + j (orb.py:388-392).
//
// Bound on the card: latency of the small per-keypoint working set. Each
// keypoint reads 9 KB of image (mostly from L2: neighbouring keypoints
// overlap) and does ~35 kFLOP, so 2400 keypoints per frame are far from
// either roofline; the block keeps every intermediate in 24 KB of shared
// memory so nothing but the angle and 32 descriptor bytes returns to
// device memory.

#include <cuda_runtime.h>

namespace {

constexpr int PATCH = 48;
constexpr int BLUR = 42;
constexpr int PATCH_C = 21;  // keypoint offset inside the patch
constexpr int PAD = 24;      // reflect padding of the level image
constexpr int THREADS = 256;
constexpr float kBinsPerRadian = 5.092958178940651f;  // 32 / (2 pi)

__global__ void __launch_bounds__(THREADS)
orb_patch_desc_kernel(const float* __restrict__ imp, const int* __restrict__ xs,
                      const int* __restrict__ ys, const short* __restrict__ bin_flat,
                      const float* __restrict__ g7, const int* __restrict__ umax,
                      float* __restrict__ angle_out, int* __restrict__ desc_out,
                      int n_per_image, int Hp, int Wp) {
    __shared__ float P[PATCH][PATCH];
    __shared__ float T[PATCH][BLUR];
    __shared__ float Bl[BLUR * BLUR];
    __shared__ float red[2][THREADS / 32];
    __shared__ float g[7];
    __shared__ int um[16];
    __shared__ float s_ang;

    const int k = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const float* im = imp + (size_t)(k / n_per_image) * Hp * Wp;
    // the window start is clamped into the padded image (as in the plain
    // version): a keypoint outside the extractor's border reads a shifted
    // window, never outside the buffer
    const int r0 = min(max(ys[k] + PAD - PATCH_C, 0), Hp - PATCH);
    const int c0 = min(max(xs[k] + PAD - PATCH_C, 0), Wp - PATCH);

    if (tid < 7) g[tid] = g7[tid];
    if (tid < 16) um[tid] = umax[tid];
    for (int i = tid; i < PATCH * PATCH; i += THREADS) {
        const int r = i / PATCH, c = i % PATCH;
        P[r][c] = im[(size_t)(r0 + r) * Wp + c0 + c];
    }
    __syncthreads();

    // intensity-centroid moments over the radius-15 disc
    float a10 = 0.0f, a01 = 0.0f;
    for (int i = tid; i < 31 * 31; i += THREADS) {
        const int dy = i / 31 - 15, dx = i % 31 - 15;
        if (abs(dx) <= um[abs(dy)]) {
            const float v = P[PATCH_C + dy][PATCH_C + dx];
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

    // separable 7-tap blur: rows, then columns
    for (int i = tid; i < PATCH * BLUR; i += THREADS) {
        const int r = i / BLUR, c = i % BLUR;
        float s = 0.0f;
#pragma unroll
        for (int t = 0; t < 7; ++t) s += g[t] * P[r][c + t];
        T[r][c] = s;
    }
    __syncthreads();
    for (int i = tid; i < BLUR * BLUR; i += THREADS) {
        const int r = i / BLUR, c = i % BLUR;
        float s = 0.0f;
#pragma unroll
        for (int t = 0; t < 7; ++t) s += g[t] * T[r + t][c];
        Bl[i] = s;
    }
    if (tid == 0) {
        float m10 = 0.0f, m01 = 0.0f;
        for (int w = 0; w < THREADS / 32; ++w) {
            m10 += red[0][w];
            m01 += red[1][w];
        }
        const float ang = atan2f(m01, m10);
        s_ang = ang;
        angle_out[k] = ang;
    }
    __syncthreads();

    int bin = (int)rintf(s_ang * kBinsPerRadian) % 32;
    if (bin < 0) bin += 32;
    const short* idx = bin_flat + bin * 512;
    const bool bit = Bl[idx[tid]] < Bl[idx[256 + tid]];
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) desc_out[k * 8 + warp] = (int)word;
}

}  // namespace

// imp: float32 [B, Hp, Wp] reflect-padded level images; xs, ys: int32 [K]
// level coordinates (keypoint k belongs to image k / n_per_image);
// bin_flat: int16 [32, 512]; g7: float32 [7]; umax: int32 [16].
// Out: angle float32 [K], desc int32 [K, 8].
extern "C" int orb_patch_desc_launch(const void* imp, const void* xs, const void* ys,
                                     const void* bin_flat, const void* g7, const void* umax,
                                     void* angle, void* desc, int K, int n_per_image,
                                     int Hp, int Wp, void* stream) {
    orb_patch_desc_kernel<<<K, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)imp, (const int*)xs, (const int*)ys, (const short*)bin_flat,
        (const float*)g7, (const int*)umax, (float*)angle, (int*)desc, n_per_image, Hp, Wp);
    return (int)cudaGetLastError();
}
