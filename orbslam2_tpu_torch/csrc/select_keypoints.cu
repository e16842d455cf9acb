// K6: keypoint selection over every pyramid level and image of a frame, in
// two kernels launched together: a cell pass, then a top-k pass.
//
// Replaces orbslam2_tpu/ops/orb.py::_select_level_keypoints (:206-283) and
// _cell_any (:188-203), the XLA program the TPU ran once per pyramid
// level after the FAST score and its NMS (K2 computes those). The port's
// plain version, ops/orb.py::select_keypoints_levels_plain, calls
// ops/orb.py::_select_level_keypoints per level. For each (image, level)
// of masked scores s [h, w]:
//   * the reference's 20/7 fallback: hi = s > ini_th; a pixel is kept when
//     hi, or when s > min_th and no pixel of its 30x30 cell (cells anchored
//     at (0, 0), taken over the whole level, border included) is hi;
//   * the 16 px border; the kept score's key (q << pos_bits) | (y w + x),
//     q = clamp(int(4 s), 0, 2^(31 - pos_bits) - 1), or -1 where s = 0;
//   * the best and second-best key of each c x c grid cell (the ragged
//     right and bottom cells padded with -1; the 30 px cells and the c px
//     grid do not line up);
//   * the top k = min(n_target, 2 gy gx) of the 2 gy gx candidates, in
//     descending order (the keys >= 0 are unique, so this is what
//     torch.topk(sorted=True) gives); their decode to x, y, response and
//     valid, slots k .. n_target-1 empty; an empty slot's x and y are the
//     extractor's clamp, 16 (ops/orb.py::extract).
// Every step is integer arithmetic, a float comparison or a float times 4
// (exact), so the result equals the plain version bit for bit. The scores
// must stay below 2^29 for the key's clamp to agree (FAST scores are
// intensity differences, <= 255).
//
// Bound on the card. The masked scores of the 752x480 stereo pair's 8
// levels are 2.23 M floats, 8.9 MB read once; the outputs are 2 x 1200 x
// 13 bytes: ~2.7 us at 3.35 TB/s. The integer work (~15 operations a
// pixel) is far below that.
//
// Design. Kernel 1 runs one block per (level, image, band of grid-cell
// rows): the band's rows and those of the 30 px cells that overlap it are
// read once to set the cells' "any hi" flags in shared memory, then the
// band's pixels twice (from L1/L2) for the best key of each grid cell, by
// integer atomicMax in shared memory, then the second best; the two
// candidates of each cell go to a scratch buffer. The level-0 band of a
// 752x480 image is 35 rows, its 30 px cells span up to 90: the flag pass
// reads up to 2.6x the band. Kernel 2 runs one block per (level, image): a
// bitonic sort of the candidates (<= 616 at level 0, padded to 1024) in
// shared memory, then the decode of the first n_target slots. Integer
// maxima give the same result in any order, so both kernels are
// deterministic. One kernel would need a grid-wide step between the cell
// pass and the sort.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int CELL_THREADS = 256;
constexpr int TOPK_THREADS = 512;
constexpr int CELL = 30;      // the threshold fallback's cells (ops/orb.py CELL)
constexpr int KP_BORDER = 16;  // ops/orb.py KP_BORDER

// One level, as the wrapper fills it (ops/orb.py `_SelLevel`).
struct SelLevelIn {
    const float* score;  // [n_images, h, w] masked FAST score
    int h, w, n_target;
    int c, gy, gx, pos_bits;  // the grid and the key's position bits
};

struct SelArgsIn {
    SelLevelIn lv[MAX_LEVELS];
    int* xs;        // outputs, level l's block [n_images, n_target] at n_images * (its first slot)
    int* ys;
    float* resp;
    bool* valid;
    int* cand;      // scratch: per level and image 2 gy gx keys
    float ini_th, min_th;
    int n_levels, n_images;
    int n_blocks;   // set by the launcher: blocks of the cell pass, 0 if none
};

// A level with its layout in the grids and buffers.
struct SelLevel {
    const float* score;
    int h, w, n_target, c, gy, gx, pos_bits;
    int first;      // first block of the level in the cell pass
    int out_off;    // n_images * (the level's first slot)
    int cand_off;   // n_images * (the level's first candidate)
    int flag_rows;  // rows of 30 px cells a band can span
};

struct SelLevels {
    SelLevel lv[MAX_LEVELS];
    int* xs;
    int* ys;
    float* resp;
    bool* valid;
    int* cand;
    float ini_th, min_th;
    int n_levels, n_images;
};

__device__ __forceinline__ SelLevel level_of_block(const SelLevels& p, int blk) {
    // the last level whose first block is <= blk (unrolled selects keep
    // the parameter struct out of local memory)
    SelLevel L = p.lv[0];
#pragma unroll
    for (int i = 1; i < MAX_LEVELS; ++i)
        if (i < p.n_levels && blk >= p.lv[i].first) L = p.lv[i];
    return L;
}

__global__ void __launch_bounds__(CELL_THREADS) select_keypoints_cells_kernel(const SelLevels p) {
    extern __shared__ int smem[];
    const SelLevel L = level_of_block(p, blockIdx.x);
    const int local = blockIdx.x - L.first;
    const int image = local / L.gy, band = local - image * L.gy;
    const int H = L.h, W = L.w, c = L.c, gx = L.gx;
    const float* s = L.score + (size_t)image * H * W;
    const int y0 = band * c, y1 = min(y0 + c, H);
    const int r0 = y0 / CELL;                       // first 30 px cell row of the band
    const int fy0 = r0 * CELL, fy1 = min((((y1 - 1) / CELL) + 1) * CELL, H);
    const int fcols = (W + CELL - 1) / CELL;
    int* flags = smem;                              // [flag_rows, fcols]
    int* best1 = smem + L.flag_rows * fcols;        // [gx]
    int* best2 = best1 + gx;                        // [gx]
    const int tid = threadIdx.x;
    const float ini_th = p.ini_th, min_th = p.min_th;

    for (int i = tid; i < L.flag_rows * fcols; i += CELL_THREADS) flags[i] = 0;
    for (int i = tid; i < gx; i += CELL_THREADS) best1[i] = best2[i] = -1;
    __syncthreads();
    for (int i = tid; i < (fy1 - fy0) * W; i += CELL_THREADS) {
        const int y = fy0 + i / W, x = i % W;
        if (__ldg(s + (size_t)y * W + x) > ini_th) flags[(y / CELL - r0) * fcols + x / CELL] = 1;
    }
    __syncthreads();

    const int qmax = (1 << (31 - L.pos_bits)) - 1;
    auto key_at = [&](int y, int x) -> int {
        const float v = __ldg(s + (size_t)y * W + x);
        const bool keep = v > ini_th || (v > min_th && !flags[(y / CELL - r0) * fcols + x / CELL]);
        const bool border = x >= KP_BORDER && x <= W - 1 - KP_BORDER && y >= KP_BORDER && y <= H - 1 - KP_BORDER;
        const float kept = keep && border ? v : 0.0f;
        const int q = min(max((int)(kept * 4.0f), 0), qmax);
        return kept > 0.0f ? (q << L.pos_bits) | (y * W + x) : -1;
    };
    const int n_px = (y1 - y0) * W;
    for (int i = tid; i < n_px; i += CELL_THREADS) {
        const int y = y0 + i / W, x = i % W;
        const int k = key_at(y, x);
        if (k >= 0) atomicMax(best1 + x / c, k);
    }
    __syncthreads();
    for (int i = tid; i < n_px; i += CELL_THREADS) {
        const int y = y0 + i / W, x = i % W;
        const int k = key_at(y, x);
        if (k >= 0 && k != best1[x / c]) atomicMax(best2 + x / c, k);
    }
    __syncthreads();
    // candidates in the plain version's order: every best, then every second
    int* cand = p.cand + L.cand_off + image * 2 * L.gy * gx;
    for (int j = tid; j < gx; j += CELL_THREADS) {
        cand[band * gx + j] = best1[j];
        cand[L.gy * gx + band * gx + j] = best2[j];
    }
}

__global__ void __launch_bounds__(TOPK_THREADS) select_keypoints_topk_kernel(const SelLevels p) {
    extern __shared__ int v[];  // a power of two >= the candidates
    const int level = blockIdx.x / p.n_images, image = blockIdx.x - level * p.n_images;
    SelLevel L = p.lv[0];
#pragma unroll
    for (int i = 1; i < MAX_LEVELS; ++i)
        if (i == level) L = p.lv[i];
    const int m = 2 * L.gy * L.gx;
    const int* cand = p.cand + L.cand_off + image * m;
    const int tid = threadIdx.x;
    int n = 1;
    while (n < m) n <<= 1;
    for (int i = tid; i < n; i += TOPK_THREADS) v[i] = i < m ? cand[i] : INT_MIN;
    __syncthreads();
    // bitonic sort, descending
    for (int size = 2; size <= n; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = tid; i < n; i += TOPK_THREADS) {
                const int j = i ^ stride;
                if (j > i) {
                    const int a = v[i], b = v[j];
                    if (((i & size) == 0) ? (a < b) : (a > b)) {
                        v[i] = b;
                        v[j] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
    const int k = min(L.n_target, m);
    const int mask = (1 << L.pos_bits) - 1;
    const int base = L.out_off + image * L.n_target;
    for (int i = tid; i < L.n_target; i += TOPK_THREADS) {
        const int key = i < k ? v[i] : -1;
        const bool ok = key >= 0;
        const int pos = ok ? (key & mask) : 0;
        p.xs[base + i] = ok ? pos % L.w : KP_BORDER;
        p.ys[base + i] = ok ? pos / L.w : KP_BORDER;
        p.resp[base + i] = ok ? (float)(key >> L.pos_bits) * 0.25f : 0.0f;
        p.valid[base + i] = ok;
    }
}

}  // namespace

// args: host pointer to a SelArgsIn. Lays the levels out (blocks, output
// slots, candidates), launches the cell pass and the top-k pass if there is
// any work, and writes the cell pass's block count back into `n_blocks`.
extern "C" int select_keypoints_launch(void* args, void* stream) {
    SelArgsIn& in = *static_cast<SelArgsIn*>(args);
    in.n_blocks = 0;
    if (in.n_levels < 1 || in.n_levels > MAX_LEVELS || in.n_images < 0) return (int)cudaErrorInvalidValue;
    SelLevels p = {};
    p.xs = in.xs;
    p.ys = in.ys;
    p.resp = in.resp;
    p.valid = in.valid;
    p.cand = in.cand;
    p.ini_th = in.ini_th;
    p.min_th = in.min_th;
    p.n_levels = in.n_levels;
    p.n_images = in.n_images;
    int first = 0, out_off = 0, cand_off = 0, cell_smem = 0, sort_len = 1;
    for (int i = 0; i < in.n_levels; ++i) {
        const SelLevelIn& l = in.lv[i];
        if (l.h < 1 || l.w < 1 || l.c < 1 || l.gy != (l.h + l.c - 1) / l.c || l.gx != (l.w + l.c - 1) / l.c ||
            l.pos_bits < 1 || l.pos_bits > 30 || l.n_target < 0)
            return (int)cudaErrorInvalidValue;
        const int flag_rows = (l.c + CELL - 2) / CELL + 1;
        p.lv[i] = SelLevel{l.score, l.h, l.w, l.n_target, l.c, l.gy, l.gx, l.pos_bits,
                           first, out_off, cand_off, flag_rows};
        first += in.n_images * l.gy;
        out_off += in.n_images * l.n_target;
        cand_off += in.n_images * 2 * l.gy * l.gx;
        const int fcols = (l.w + CELL - 1) / CELL;
        cell_smem = max(cell_smem, (int)sizeof(int) * (flag_rows * fcols + 2 * l.gx));
        while (sort_len < 2 * l.gy * l.gx) sort_len <<= 1;
    }
    if (first == 0) return 0;
    const int sort_smem = (int)sizeof(int) * sort_len;
    if (cell_smem > 48 * 1024 || sort_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    select_keypoints_cells_kernel<<<first, CELL_THREADS, cell_smem, s>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    select_keypoints_topk_kernel<<<in.n_levels * in.n_images, TOPK_THREADS, sort_smem, s>>>(p);
    in.n_blocks = first;
    return (int)cudaGetLastError();
}
