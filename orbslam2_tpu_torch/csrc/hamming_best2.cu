// K3: masked XOR-popcount Hamming distance with the best and second best
// candidate per row.
//
// Replaces orbslam2_tpu/ops/hamming.py::hamming_matrix (:27-38),
// ::masked_argmin (:41-49), ::masked_two_smallest (:52-64) and the
// second-index pass of orbslam2_tpu/ops/matchers.py::
// search_by_projection_points (:464-466). The [N, M] distance matrix is
// never written: one warp owns a row, each lane strides over the M
// candidates with __popc on 8 words, keeps its lexicographically smallest
// two (d', j) keys in registers, and a shuffle butterfly merges the lanes.
//
// Semantics reproduced exactly:
//   * a masked-out entry counts as d' = 256 (MAX_DIST) at its own index, so
//     a row with no candidate returns index 0 and distance 256;
//   * the second best is the minimum with position idx1 set to 256, not
//     removed (what jax.nn.one_hot(idx) does at hamming.py:60-62): when it
//     is 256 its index is therefore 0;
//   * ties go to the lowest index.
//
// Bound on the card: the gate mask (N*M bytes) and the candidate
// descriptors (32 bytes per candidate, re-read per row but L2 resident) —
// memory traffic, at ~1.5 M pairs per matcher call.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIST = 256;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ int popc8(const int4& a0, const int4& a1, const int4& b0,
                                     const int4& b1) {
    return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
           __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
           __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__global__ void hamming_best2_kernel(const int* __restrict__ A, const int* __restrict__ B,
                                     const unsigned char* __restrict__ mask,
                                     int* __restrict__ idx1, int* __restrict__ d1,
                                     int* __restrict__ idx2, int* __restrict__ d2, int N,
                                     int M) {
    const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= N) return;  // uniform per warp: blockDim is a multiple of 32

    const int4* a4 = reinterpret_cast<const int4*>(A + (size_t)row * 8);
    const int4 a0 = a4[0], a1 = a4[1];
    const unsigned char* mrow = mask + (size_t)row * M;

    // key = (d' << 32) | j: unsigned order is the lexicographic (d', j) order
    unsigned long long k1 = kNone, k2 = kNone;
    for (int j = lane; j < M; j += 32) {
        int d = MAX_DIST;
        if (mrow[j]) {
            const int4* b4 = reinterpret_cast<const int4*>(B + (size_t)j * 8);
            d = popc8(a0, a1, b4[0], b4[1]);
        }
        const unsigned long long key = ((unsigned long long)d << 32) | (unsigned)j;
        if (key < k1) {
            k2 = k1;
            k1 = key;
        } else if (key < k2) {
            k2 = key;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o1 = __shfl_xor_sync(0xffffffffu, k1, off);
        const unsigned long long o2 = __shfl_xor_sync(0xffffffffu, k2, off);
        if (o1 < k1) {
            k2 = k1 < o2 ? k1 : o2;
            k1 = o1;
        } else {
            k2 = k2 < o1 ? k2 : o1;
        }
    }
    if (lane == 0) {
        idx1[row] = (int)(k1 & 0xffffffffu);
        d1[row] = (int)(k1 >> 32);
        if (k2 == kNone || (int)(k2 >> 32) >= MAX_DIST) {
            idx2[row] = 0;
            d2[row] = MAX_DIST;
        } else {
            idx2[row] = (int)(k2 & 0xffffffffu);
            d2[row] = (int)(k2 >> 32);
        }
    }
}

}  // namespace

// A: int32 [N, 8], B: int32 [M, 8] (16-byte aligned rows), mask: bool
// [N, M]; out: idx1, d1, idx2, d2 int32 [N]. Requires N >= 1 and M >= 1.
extern "C" int hamming_best2_launch(const void* A, const void* B, const void* mask, void* idx1,
                                    void* d1, void* idx2, void* d2, int N, int M,
                                    void* stream) {
    constexpr int threads = 256;
    const int blocks = (int)(((long long)N * 32 + threads - 1) / threads);
    hamming_best2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)A, (const int*)B, (const unsigned char*)mask, (int*)idx1, (int*)d1,
        (int*)idx2, (int*)d2, N, M);
    return (int)cudaGetLastError();
}
