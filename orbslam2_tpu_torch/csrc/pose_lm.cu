// K5: the motion-only pose Levenberg-Marquardt, the whole 4 x 10 schedule
// of one problem in one launch.
//
// Replaces orbslam2_tpu/ops/pose_opt.py::pose_optimize (:193-226) with
// _lm_optimize (:131-190), _residual_jacobian (:47-91) and _solve6
// (:99-128): the XLA program (an unrolled lax.scan of rounds and
// iterations) the TPU ran twice per tracked frame. The port's plain
// version, ops/pose_opt.py::pose_optimize_plain, holds the same steps in
// PyTorch:
//   * every round restarts from T0 over the edges that are valid and not
//     outliers; Huber in rounds 0 .. n_rounds-2; after each round every
//     valid edge is reclassified (chi2 above its threshold, or z <= 0);
//   * per LM pass, per edge: pc = R p + t, 1/z with |z| < 1e-6 clamped to
//     1e-6, r = obs - (fx x/z + cx, fy y/z + cy, u - bf/z), the component
//     mask (1, 1, is_stereo), chi2, the Huber weight, and the Jacobian rows
//     K_c = [pc x a_c, a_c] (J = -K; a_c the row of d(u, v, uR)/dpc); the
//     sums F, H (21 unique entries) and g = sum K^T W (-r);
//   * one thread: lambda = 1e-5 max diag H, the 6x6 Cholesky (x = 0 where
//     a pivot is <= 0 or NaN), the retract exp(dx) @ T (geometry/se3.py
//     with its theta2 < 1e-8 branch), g2o's rho test and the lambda/nu
//     update.
// Everything is float64 from the float32 inputs, as the plain version; the
// Huber widths and chi2 thresholds are float32 constants widened, as there.
//
// Bound on the card. At the main path's size (N = 1200 edges; 44 LM passes
// and 4 reclassifications per call) the call reads its 1200 x 8 floats and
// masks once (~36 KB) and writes the pose and the mask: ~0.01 us at 3.35
// TB/s. Its float64 work is 44 passes x N x ~275 operations and 4
// reclassifications x N x ~45, ~14.7 M operations: ~0.43 us at 34 TFLOP/s
// (float64 outside the tensor cores; chip_smoke.py counts them). Neither bounds
// it: the work is a chain of 44 dependent block reductions, each followed
// by ~1,500 serial float64 operations on one thread (the Cholesky, sin and
// cos, two 3x3 and one 3x4 product), so latency sets its time.
//
// Design. One CTA of 256 threads per problem; edge i belongs to thread
// i mod 256 in every pass, so each thread keeps its edges' outlier flags in
// the output mask between rounds without a barrier. A pass sums each
// thread's edges in index order, then each warp by shuffles in a fixed
// tree, then the 8 warps in warp order: no float atomics, so the same
// arguments give the same bits every launch (chip_smoke.py's
// reproducibility phase replays whole runs). The edges are re-read from
// global memory each pass (they stay in L1). Thread 0 keeps the LM state
// (T, F, H, g, lambda, nu) in shared memory, out of the registers the sums
// take, and publishes the next pose there. Shortening the chain (a warp per pass, or a batch of
// problems per launch) is later work.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NSUM = 28;  // F, H's lower triangle row by row (21), g (6)
constexpr unsigned kAll = 0xffffffffu;

// Mirrors ops/pose_opt.py::_K5Args.
struct PoseLMArgs {
    const float* T0;          // [4, 4]
    const float* pw;          // [n, 3]
    const float* obs;         // [n, 3]
    const float* inv_sigma2;  // [n]
    const bool* is_stereo;    // [n]
    const bool* valid;        // [n]
    float* Tcw;               // [4, 4] out
    bool* inlier;             // [n] out; the outlier flags between rounds
    int* n_inliers;           // [] out
    double fx, fy, cx, cy, bf;
    int n, n_rounds, n_iters;
};

struct Edge {
    double pc[3], iz, r[3], e2;
    bool stereo;
};

// pc, 1/z, the residual and chi2 of edge i under the 3x4 pose T (rows).
__device__ __forceinline__ Edge project(const PoseLMArgs& a, const double* T, int i) {
    Edge e;
    const double p0 = a.pw[3 * i], p1 = a.pw[3 * i + 1], p2 = a.pw[3 * i + 2];
#pragma unroll
    for (int k = 0; k < 3; ++k) e.pc[k] = T[4 * k] * p0 + T[4 * k + 1] * p1 + T[4 * k + 2] * p2 + T[4 * k + 3];
    const double z = e.pc[2];
    e.iz = 1.0 / (fabs(z) < 1e-6 ? 1e-6 : z);
    const double u = a.fx * e.pc[0] * e.iz + a.cx;
    const double v = a.fy * e.pc[1] * e.iz + a.cy;
    e.r[0] = (double)a.obs[3 * i] - u;
    e.r[1] = (double)a.obs[3 * i + 1] - v;
    e.r[2] = (double)a.obs[3 * i + 2] - (u - a.bf * e.iz);
    e.stereo = a.is_stereo[i];
    const double cm2 = e.stereo ? 1.0 : 0.0;
    e.e2 = (e.r[0] * e.r[0] + e.r[1] * e.r[1] + e.r[2] * e.r[2] * cm2) * (double)a.inv_sigma2[i];
    return e;
}

// The widths and thresholds as the plain version holds them: float32.
__device__ __forceinline__ double huber_delta(bool stereo) {
    return (double)(stereo ? 2.795531836f : 2.447864292f);
}
__device__ __forceinline__ double huber_delta2(bool stereo) {
    const float d = stereo ? 2.795531836f : 2.447864292f;
    return (double)(d * d);
}
__device__ __forceinline__ double chi2_th(bool stereo) { return (double)(stereo ? 7.815f : 5.991f); }

// Adds edge i's terms at T to acc (F, H lower, g).
__device__ __forceinline__ void accumulate(const PoseLMArgs& a, const double* T, int i, bool active, bool huber,
                                           double* acc) {
    const Edge e = project(a, T, i);
    const double delta = huber_delta(e.stereo), delta2 = huber_delta2(e.stereo);
    const bool robust = huber && e.e2 > delta2;
    const double sq = sqrt(fmax(e.e2, 1e-12));
    const bool w_act = active && e.pc[2] > 0.0;
    acc[0] += w_act ? (robust ? 2.0 * delta * sq - delta2 : e.e2) : 0.0;
    const double w = w_act ? (robust ? delta / sq : 1.0) * (double)a.inv_sigma2[i] : 0.0;

    const double x = e.pc[0], y = e.pc[1], z = e.pc[2];
    const double fiz = a.fx * e.iz, iz2 = e.iz * e.iz;
    const double A[3][3] = {{fiz, 0.0, -a.fx * x * iz2},
                            {0.0, a.fy * e.iz, -a.fy * y * iz2},
                            {fiz, 0.0, (a.bf - a.fx * x) * iz2}};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const double wc = c < 2 ? w : w * (e.stereo ? 1.0 : 0.0);
        const double k[7] = {y * A[c][2] - z * A[c][1], z * A[c][0] - x * A[c][2], x * A[c][1] - y * A[c][0],
                             A[c][0], A[c][1], A[c][2], -e.r[c]};
        int q = 1;
#pragma unroll
        for (int r = 0; r < 6; ++r) {
            const double kw = k[r] * wc;
#pragma unroll
            for (int s = 0; s <= r; ++s) acc[q++] += kw * k[s];
        }
#pragma unroll
        for (int r = 0; r < 6; ++r) acc[22 + r] += (k[r] * wc) * k[6];
    }
}

// Sums acc over the block in a fixed order into tot (every thread's acc
// is clobbered). Ends with a barrier: tot is readable by every thread.
__device__ void block_sum(double* acc, double* red, double* tot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < NSUM; ++q) {
        double v = acc[q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kAll, v, off);
        if (lane == 0) red[warp * NSUM + q] = v;
    }
    __syncthreads();
    if (threadIdx.x < NSUM) {
        double s = red[threadIdx.x];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += red[w * NSUM + threadIdx.x];
        tot[threadIdx.x] = s;
    }
    __syncthreads();
}

// x with A x = b (A 6x6, lower triangle read); 0 where a pivot is <= 0 or
// NaN, as cholesky_ex's info != 0 in the plain version.
__device__ void solve6(const double A[6][6], const double* b, double* x) {
    double L[6][6];
    for (int j = 0; j < 6; ++j) {
        double s = A[j][j];
        for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
        if (!(s > 0.0)) {
            for (int i = 0; i < 6; ++i) x[i] = 0.0;
            return;
        }
        L[j][j] = sqrt(s);
        for (int i = j + 1; i < 6; ++i) {
            double t = A[i][j];
            for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
            L[i][j] = t / L[j][j];
        }
    }
    double y[6];
    for (int i = 0; i < 6; ++i) {
        double s = b[i];
        for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
        y[i] = s / L[i][i];
    }
    for (int i = 5; i >= 0; --i) {
        double s = y[i];
        for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
        x[i] = s / L[i][i];
    }
}

// out = exp(dx) @ T for the 3x4 pose T (rows), dx = (omega, upsilon).
__device__ void retract(const double* T, const double* dx, double* out) {
    const double w0 = dx[0], w1 = dx[1], w2 = dx[2];
    const double theta2 = w0 * w0 + w1 * w1 + w2 * w2;
    const double theta = sqrt(fmax(theta2, 1e-16));
    double A, B, C;
    if (theta2 < 1e-8) {
        A = 1.0 - theta2 / 6.0;
        B = 0.5 - theta2 / 24.0;
        C = 1.0 / 6.0 - theta2 / 120.0;
    } else {
        const double s = sin(theta);
        A = s / theta;
        B = (1.0 - cos(theta)) / theta2;
        C = (theta - s) / (theta2 * theta);
    }
    const double W[3][3] = {{0.0, -w2, w1}, {w2, 0.0, -w0}, {-w1, w0, 0.0}};
    double R[3][3], t[3];
    for (int i = 0; i < 3; ++i) {
        double V[3];
        for (int j = 0; j < 3; ++j) {
            const double W2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
            const double I = i == j ? 1.0 : 0.0;
            R[i][j] = I + A * W[i][j] + B * W2;
            V[j] = I + B * W[i][j] + C * W2;
        }
        t[i] = V[0] * dx[3] + V[1] * dx[4] + V[2] * dx[5];
    }
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 4; ++j)
            out[4 * i + j] = R[i][0] * T[j] + R[i][1] * T[4 + j] + R[i][2] * T[8 + j] + (j == 3 ? t[i] : 0.0);
}

// Thread 0's LM step: dx from (H + lambda I) dx = -g, sT = exp(dx) @ T.
__device__ void propose(const double* T, const double* H, const double* g, double lam, double* dx, double* sT) {
    double A[6][6];
    int q = 0;
    for (int r = 0; r < 6; ++r)
        for (int s = 0; s <= r; ++s) A[r][s] = H[q++] + (r == s ? lam : 0.0);
    solve6(A, g, dx);
    for (int i = 0; i < 6; ++i) dx[i] = -dx[i];
    retract(T, dx, sT);
}

// Thread 0's LM state, in shared memory (registers are taken by the sums).
struct LMState {
    double T0[12], T[12], H[21], g[6], dx[6], F, lam, ni;
};

__global__ void __launch_bounds__(THREADS) pose_lm_kernel(const PoseLMArgs a) {
    __shared__ double sT[12];  // the pose of the next pass
    __shared__ double red[WARPS * NSUM];
    __shared__ double tot[NSUM];
    __shared__ LMState st;
    __shared__ int s_count;
    const int tid = threadIdx.x;

    if (tid == 0) {
        for (int k = 0; k < 12; ++k) st.T0[k] = (double)a.T0[k];
        s_count = 0;
    }
    for (int i = tid; i < a.n; i += THREADS) a.inlier[i] = false;  // outlier flags

    for (int round = 0; round < a.n_rounds; ++round) {
        const bool huber = round < a.n_rounds - 1;
        if (tid == 0)
            for (int k = 0; k < 12; ++k) sT[k] = st.T0[k];
        __syncthreads();
        for (int it = 0; it <= a.n_iters; ++it) {
            double acc[NSUM];
#pragma unroll
            for (int q = 0; q < NSUM; ++q) acc[q] = 0.0;
            for (int i = tid; i < a.n; i += THREADS) accumulate(a, sT, i, a.valid[i] && !a.inlier[i], huber, acc);
            block_sum(acc, red, tot);
            if (tid == 0) {
                bool take = it == 0;  // the round's start at T0
                if (take) {
                    st.ni = 2.0;
                } else {
                    const double F_new = tot[0];
                    // g2o rho denominator: dx^T (lam dx + b), b = -g
                    double denom = 0.0;
                    for (int q = 0; q < 6; ++q) denom += st.dx[q] * (st.lam * st.dx[q] - st.g[q]);
                    const double rho = (st.F - F_new) / (denom + 1e-12);
                    take = rho > 0.0 && isfinite(F_new);
                    if (take) {
                        const double qq = 2.0 * rho - 1.0;
                        st.lam *= fmax(1.0 - qq * qq * qq, 1.0 / 3.0);
                        st.ni = 2.0;
                    } else {
                        st.lam *= st.ni;
                        st.ni *= 2.0;
                    }
                }
                if (take) {
                    for (int k = 0; k < 12; ++k) st.T[k] = sT[k];
                    st.F = tot[0];
                    for (int q = 0; q < 21; ++q) st.H[q] = tot[1 + q];
                    for (int q = 0; q < 6; ++q) st.g[q] = tot[22 + q];
                }
                if (it == 0) {
                    const double* H = st.H;
                    st.lam = 1e-5 * fmax(fmax(fmax(H[0], H[2]), fmax(H[5], H[9])), fmax(H[14], H[20]));
                }
                if (it < a.n_iters) {
                    double next[12];
                    propose(st.T, st.H, st.g, st.lam, st.dx, next);
                    for (int k = 0; k < 12; ++k) sT[k] = next[k];
                } else {
                    for (int k = 0; k < 12; ++k) sT[k] = st.T[k];
                }
            }
            __syncthreads();
        }
        // reclassify at the round's pose (sT)
        for (int i = tid; i < a.n; i += THREADS) {
            const Edge e = project(a, sT, i);
            a.inlier[i] = a.valid[i] && (e.e2 > chi2_th(e.stereo) || !(e.pc[2] > 0.0));
        }
        __syncthreads();
    }

    int count = 0;
    for (int i = tid; i < a.n; i += THREADS) {
        const bool in = a.valid[i] && !a.inlier[i];
        a.inlier[i] = in;
        count += in;
    }
    count = __reduce_add_sync(kAll, count);
    if ((tid & 31) == 0) atomicAdd(&s_count, count);
    __syncthreads();
    if (tid == 0) {
        const double* Tf = a.n_rounds > 0 ? sT : st.T0;
        for (int k = 0; k < 12; ++k) a.Tcw[k] = (float)Tf[k];
        a.Tcw[12] = 0.0f;
        a.Tcw[13] = 0.0f;
        a.Tcw[14] = 0.0f;
        a.Tcw[15] = 1.0f;
        *a.n_inliers = s_count;
    }
}

}  // namespace

// args: host pointer to a PoseLMArgs. One CTA for the problem.
extern "C" int pose_lm_launch(void* args, void* stream) {
    const PoseLMArgs& a = *static_cast<const PoseLMArgs*>(args);
    if (a.n < 0 || a.n_rounds < 0 || a.n_iters < 0) return (int)cudaErrorInvalidValue;
    pose_lm_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
