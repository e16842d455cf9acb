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
// Design. The first design gave a block a band of grid rows: it
// read the rows of every 30 px cell the band overlapped for their flags
// (up to 2.6x the band), then the band twice more, with runtime / and % and
// a shared-memory atomic on every pixel; a 35-row level-0 band carried ~7x
// the pixels of a level-7 band; a bitonic sort of 1024 in 55 barrier
// stages took the top k. 0.088 ms a call. This design:
//   * The cell pass's block owns whole 30 px cells: a band of 30 rows (one
//     row of cells) times a chunk of 240 columns (8 cells), 256 threads,
//     thread t on column x0 + t. Each thread loads its column's 30 rows
//     into registers (the one read of every pixel in the call, coalesced
//     across the warp), sets its cell's flag in shared memory where any is
//     hi, and after one barrier makes its 30 keys from the registers. Its
//     grid column x / c and its 30 px cell are fixed for the column: one
//     division a thread, none a pixel. Blocks carry at most 7,200 pixels
//     whatever the level; a 752x480 pair gives 418 blocks, 3 an SM at
//     once (a few wait for a slot).
//   * The grid's cells straddle the blocks. A block keeps, for each grid
//     cell it overlaps (its band's grid rows times its chunk's grid
//     columns), the best two keys of the pixels it holds: a thread takes
//     its column's best within each grid row, each warp merges the columns
//     of a grid cell with __reduce_max_sync (one per grid cell the warp
//     overlaps), and the cell's leader lane takes an integer atomicMax in
//     shared memory (order-free, one per warp and cell, not per pixel);
//     then the second best the same way against the cell's best. The pair
//     goes to a slot of the scratch buffer that is the block's own: (grid
//     cell, band - the cell's first band, chunk - the cell's first chunk).
//   * The top-k pass runs ceil(2 gy gx / 256) blocks per (image, level).
//     Each merges every grid cell's slots (at most 3 x 2 at c <= 35, their
//     loads issued together) into the cell's best two, the candidates in
//     shared memory, and ranks its own 256 candidates: a valid key's rank
//     is the number of larger candidates (vector loads of 4, broadcast to
//     the warp, 8 in flight); a rank below k is its output slot. The first
//     block of each (image, level) counts the valid candidates and fills
//     the empty slots. No sort, no barrier after the candidates are made.
// Integer maxima and ranks give the same result in any order, so both
// kernels are deterministic. One kernel would need a grid-wide step between
// the cell pass and the top k.
// What now sets the time (a per-block timeline on the H100): the cell
// pass's blocks nearly all start at once and each spends ~7 of its ~9 us waiting
// for its 30 loads: 4-byte loads, one request per warp and row, and the
// SMs' outstanding requests bound the rate, ~1.3 TB/s from L2; wider loads
// (2-4 columns a thread) are the next step. A cap of 64 registers (4
// blocks an SM) measured slower. The top-k pass's level-0 blocks rank 616
// candidates each (~7 us).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int CELL = 30;             // the threshold fallback's cells (ops/orb.py CELL)
constexpr int CHUNK_CELLS = 8;       // 30 px cells across a cell pass block
constexpr int CW = CELL * CHUNK_CELLS;  // its columns
constexpr int CELL_THREADS = 256;
constexpr int TOPK_THREADS = 256;    // candidates ranked per top-k block
constexpr int SLOT_BATCH = 8;        // a grid cell's slots loaded together
constexpr int KP_BORDER = 16;        // ops/orb.py KP_BORDER
constexpr unsigned kAll = 0xffffffffu;

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
    int* part;      // scratch: per level and image, gy gx nb nc pairs (ops/orb.py `_partial_slots`)
    long long part_len;  // its ints
    float ini_th, min_th;
    int n_levels, n_images;
    int n_blocks;   // set by the launcher: blocks of the cell pass, 0 if none
};

// A level with its layout in the grids and buffers.
struct SelLevel {
    const float* score;
    int h, w, n_target, c, gy, gx, pos_bits;
    int bands, chunks;  // the cell pass's blocks per image: 30-row bands x 240-column chunks
    int nb, nc;         // a grid cell's slots: the bands and chunks a c x c cell can overlap
    int rank_blocks;    // the top-k pass's blocks per image
    int first;          // first block of the level in the cell pass
    int first_topk;     // first block of the level in the top-k pass
    int out_off;        // n_images * (the level's first slot)
    int part_off;       // n_images * (the level's first slot pair) * 2
};

struct SelLevels {
    SelLevel lv[MAX_LEVELS];
    int* xs;
    int* ys;
    float* resp;
    bool* valid;
    int* part;
    float ini_th, min_th;
    int n_levels, n_images;
};

// The level of block blk of the cell pass (topk false) or the top-k pass:
// the last level whose first block is <= blk (unrolled selects keep the
// parameter struct out of local memory).
template <bool topk>
__device__ __forceinline__ SelLevel level_of_block(const SelLevels& p, int blk) {
    SelLevel L = p.lv[0];
#pragma unroll
    for (int i = 1; i < MAX_LEVELS; ++i)
        if (i < p.n_levels && blk >= (topk ? p.lv[i].first_topk : p.lv[i].first)) L = p.lv[i];
    return L;
}

// Per grid cell of a warp's lanes (cl, non-decreasing across the lanes),
// the maximum of v over its lanes into dst[cl] by the cell's first lane in
// the warp (leader): one __reduce_max_sync and one atomicMax per cell.
__device__ __forceinline__ void warp_cell_max(int cl, int v, int* dst, bool leader) {
    const int lo = __shfl_sync(kAll, cl, 0), hi = __shfl_sync(kAll, cl, 31);
    for (int k = lo; k <= hi; ++k) {
        const int m = __reduce_max_sync(kAll, cl == k ? v : -1);
        if (leader && cl == k && m >= 0) atomicMax(dst + k, m);
    }
}

__global__ void __launch_bounds__(CELL_THREADS) select_keypoints_cells_kernel(const SelLevels p) {
    extern __shared__ int smem[];
    __shared__ int flag[CHUNK_CELLS];
    const SelLevel L = level_of_block<false>(p, blockIdx.x);
    int local = blockIdx.x - L.first;
    const int per_image = L.bands * L.chunks;
    const int image = local / per_image;
    local -= image * per_image;
    const int band = local / L.chunks, chunk = local - band * L.chunks;
    const int H = L.h, W = L.w, c = L.c;
    const int y0 = band * CELL, x0 = chunk * CW;
    const int nr = min(CELL, H - y0), x_end = min(x0 + CW, W);
    const int tid = threadIdx.x, lane = tid & 31;
    const bool active = x0 + tid < x_end;
    const int x = active ? x0 + tid : x_end - 1;  // an idle thread reads nothing, in the last column's cells
    const float ini_th = p.ini_th, min_th = p.min_th;

    // the band's grid rows (segments) and the chunk's grid columns
    const int g_first = y0 / c, n_seg = (y0 + nr - 1) / c - g_first + 1;
    const int cx0 = x0 / c, n_cx = (x_end - 1) / c - cx0 + 1;
    int* best1 = smem;                 // [n_seg][n_cx]
    int* best2 = smem + n_seg * n_cx;  // [n_seg][n_cx]
    for (int i = tid; i < 2 * n_seg * n_cx; i += CELL_THREADS) smem[i] = -1;
    if (tid < CHUNK_CELLS) flag[tid] = 0;

    // the one read: the column's rows of the band
    const float* col = L.score + ((size_t)image * H + y0) * W + x;
    float v[CELL];
#pragma unroll
    for (int r = 0; r < CELL; ++r) v[r] = active && r < nr ? __ldg(col + (size_t)r * W) : 0.0f;
    __syncthreads();
    bool hi = false;
#pragma unroll
    for (int r = 0; r < CELL; ++r) hi = hi || v[r] > ini_th;
    const int fcell = (x - x0) / CELL;
    if (active && hi) flag[fcell] = 1;
    __syncthreads();
    const bool no_hi = !flag[fcell];

    const int qmax = (1 << (31 - L.pos_bits)) - 1;
    const bool x_in = x >= KP_BORDER && x <= W - 1 - KP_BORDER;
    int key[CELL];
#pragma unroll
    for (int r = 0; r < CELL; ++r) {
        const int y = y0 + r;
        const float s = v[r];  // 0 past the level's edge and on an idle thread: no key
        const bool keep = s > ini_th || (s > min_th && no_hi);
        const bool border = x_in && y >= KP_BORDER && y <= H - 1 - KP_BORDER;
        const float kept = keep && border ? s : 0.0f;
        const int q = min(max((int)(kept * 4.0f), 0), qmax);
        key[r] = kept > 0.0f ? (q << L.pos_bits) | (y * W + x) : -1;
    }

    const int cl = x / c - cx0;  // the column's grid cell within the chunk
    const int cl_prev = __shfl_up_sync(kAll, cl, 1);  // every lane, before the test (lane 0 must join)
    const bool leader = lane == 0 || cl_prev != cl;
    for (int sg = 0; sg < n_seg; ++sg) {
        const int rs = max((g_first + sg) * c - y0, 0), re = min((g_first + sg + 1) * c - y0, nr);
        int b = -1;
#pragma unroll
        for (int r = 0; r < CELL; ++r) b = r >= rs && r < re ? max(b, key[r]) : b;
        warp_cell_max(cl, b, best1 + sg * n_cx, leader);
    }
    __syncthreads();
    for (int sg = 0; sg < n_seg; ++sg) {
        const int rs = max((g_first + sg) * c - y0, 0), re = min((g_first + sg + 1) * c - y0, nr);
        const int t = best1[sg * n_cx + cl];
        int b = -1;
#pragma unroll
        for (int r = 0; r < CELL; ++r) b = r >= rs && r < re && key[r] != t ? max(b, key[r]) : b;
        warp_cell_max(cl, b, best2 + sg * n_cx, leader);
    }
    __syncthreads();
    // the block's pair of each grid cell it overlaps, into the cell's slot
    // (band - the cell's first band, chunk - its first chunk)
    int* part = p.part + L.part_off + (size_t)image * L.gy * L.gx * L.nb * L.nc * 2;
    for (int i = tid; i < n_seg * n_cx; i += CELL_THREADS) {
        const int sg = i / n_cx, k = i - sg * n_cx;
        const int gyi = g_first + sg, gxi = cx0 + k;
        const int jb = band - gyi * c / CELL, jc = chunk - gxi * c / CW;
        reinterpret_cast<int2*>(part)[((size_t)(gyi * L.gx + gxi) * L.nb + jb) * L.nc + jc] =
            make_int2(best1[i], best2[i]);
    }
}

// Output slot `at` of level L: the key's decode, or an empty slot (key < 0).
__device__ __forceinline__ void write_slot(const SelLevels& p, const SelLevel& L, int at, int key) {
    const bool ok = key >= 0;
    const int pos = ok ? key & ((1 << L.pos_bits) - 1) : 0;
    const int y = pos / L.w;
    p.xs[at] = ok ? pos - y * L.w : KP_BORDER;
    p.ys[at] = ok ? y : KP_BORDER;
    p.resp[at] = ok ? (float)(key >> L.pos_bits) * 0.25f : 0.0f;
    p.valid[at] = ok;
}

__global__ void __launch_bounds__(TOPK_THREADS) select_keypoints_topk_kernel(const SelLevels p) {
    extern __shared__ int4 cand4[];  // 2 gy gx candidates, then -1 to a multiple of 4
    int* cand = reinterpret_cast<int*>(cand4);
    const SelLevel L = level_of_block<true>(p, blockIdx.x);
    const int local = blockIdx.x - L.first_topk;
    const int image = local / L.rank_blocks, rank_blk = local - image * L.rank_blocks;
    const int c = L.c, M = L.gy * L.gx, m = 2 * M, m4 = (m + 3) & ~3;
    const int* part = p.part + L.part_off + (size_t)image * M * L.nb * L.nc * 2;
    const int tid = threadIdx.x;
    // every grid cell's best two from the slots of the blocks it overlaps,
    // in the plain version's order: every best, then every second
    for (int i = tid; i < M; i += TOPK_THREADS) {
        const int gyi = i / L.gx, gxi = i - gyi * L.gx;
        const int ys = gyi * c, ye = min(ys + c, L.h), xs = gxi * c, xe = min(xs + c, L.w);
        const int nbi = (ye - 1) / CELL - ys / CELL + 1, nci = (xe - 1) / CW - xs / CW + 1, n = nbi * nci;
        const int2* slot = reinterpret_cast<const int2*>(part) + (size_t)i * L.nb * L.nc;
        int b1 = -1, b2 = -1;
        for (int s0 = 0; s0 < n; s0 += SLOT_BATCH) {
            int2 pr[SLOT_BATCH];  // the batch's loads issued together
#pragma unroll
            for (int k = 0; k < SLOT_BATCH; ++k) {
                const int sk = s0 + k, jb = sk / nci;
                pr[k] = sk < n ? slot[jb * L.nc + sk - jb * nci] : make_int2(-1, -1);
            }
#pragma unroll
            for (int k = 0; k < SLOT_BATCH; ++k) {
                if (pr[k].x > b1) {  // the keys >= 0 are unique
                    b2 = max(b1, pr[k].y);
                    b1 = pr[k].x;
                } else {
                    b2 = max(b2, pr[k].x);
                }
            }
        }
        cand[i] = b1;
        cand[M + i] = b2;
    }
    for (int i = m + tid; i < m4; i += TOPK_THREADS) cand[i] = -1;
    __syncthreads();

    const int k = min(L.n_target, m);
    const int base = L.out_off + image * L.n_target;
    const int i = rank_blk * TOPK_THREADS + tid;
    const int key = i < m ? cand[i] : -1;
    if (key >= 0) {  // its rank: the candidates above it
        int r = 0;
#pragma unroll 8
        for (int j = 0; j < m4 / 4; ++j) {  // unrolled: 8 loads in flight, not one
            const int4 q = cand4[j];
            r += (q.x > key) + (q.y > key) + (q.z > key) + (q.w > key);
        }
        if (r < k) write_slot(p, L, base + r, key);
    }
    if (rank_blk == 0) {  // the empty slots after the valid candidates
        int n_valid = 0;
        for (int j0 = 0; j0 < m; j0 += TOPK_THREADS) n_valid += __syncthreads_count(j0 + tid < m && cand[j0 + tid] >= 0);
        for (int s = min(n_valid, k) + tid; s < L.n_target; s += TOPK_THREADS) write_slot(p, L, base + s, -1);
    }
}

}  // namespace

// args: host pointer to a SelArgsIn. Lays the levels out (blocks, output
// slots, scratch slots), launches the cell pass and the top-k pass if there
// is any work, and writes the cell pass's block count back into `n_blocks`.
extern "C" int select_keypoints_launch(void* args, void* stream) {
    SelArgsIn& in = *static_cast<SelArgsIn*>(args);
    in.n_blocks = 0;
    if (in.n_levels < 1 || in.n_levels > MAX_LEVELS || in.n_images < 0) return (int)cudaErrorInvalidValue;
    SelLevels p = {};
    p.xs = in.xs;
    p.ys = in.ys;
    p.resp = in.resp;
    p.valid = in.valid;
    p.part = in.part;
    p.ini_th = in.ini_th;
    p.min_th = in.min_th;
    p.n_levels = in.n_levels;
    p.n_images = in.n_images;
    int first = 0, first_topk = 0, out_off = 0, cell_smem = 0, topk_smem = 0;
    long long part_off = 0;
    for (int i = 0; i < in.n_levels; ++i) {
        const SelLevelIn& l = in.lv[i];
        if (l.h < 1 || l.w < 1 || l.c < 1 || l.gy != (l.h + l.c - 1) / l.c || l.gx != (l.w + l.c - 1) / l.c ||
            l.pos_bits < 1 || l.pos_bits > 30 || l.n_target < 0)
            return (int)cudaErrorInvalidValue;
        const int bands = (l.h + CELL - 1) / CELL, chunks = (l.w + CW - 1) / CW;
        const int nb = (l.c + CELL - 2) / CELL + 1, nc = (l.c + CW - 2) / CW + 1;
        const int m = 2 * l.gy * l.gx, rank_blocks = (m + TOPK_THREADS - 1) / TOPK_THREADS;
        p.lv[i] = SelLevel{l.score, l.h, l.w, l.n_target, l.c, l.gy, l.gx, l.pos_bits, bands, chunks, nb, nc,
                           rank_blocks, first, first_topk, out_off, (int)part_off};
        first += in.n_images * bands * chunks;
        first_topk += in.n_images * rank_blocks;
        out_off += in.n_images * l.n_target;
        part_off += (long long)in.n_images * l.gy * l.gx * nb * nc * 2;
        // a band's grid rows and a chunk's grid columns, at most
        const int max_seg = (CELL - 2 + l.c) / l.c + 1, max_cx = (CW - 2 + l.c) / l.c + 1;
        cell_smem = max(cell_smem, (int)sizeof(int) * 2 * max_seg * max_cx);
        topk_smem = max(topk_smem, (int)sizeof(int) * ((m + 3) & ~3));
    }
    if (first == 0) return 0;
    if (part_off > in.part_len || part_off > 0x7fffffffLL || cell_smem > 48 * 1024 || topk_smem > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    select_keypoints_cells_kernel<<<first, CELL_THREADS, cell_smem, s>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    select_keypoints_topk_kernel<<<first_topk, TOPK_THREADS, topk_smem, s>>>(p);
    in.n_blocks = first;
    return (int)cudaGetLastError();
}
