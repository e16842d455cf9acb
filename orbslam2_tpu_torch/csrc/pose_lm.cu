// K5: the motion-only pose Levenberg-Marquardt, the whole 4 x 10 schedule
// of one problem in one launch of a thread-block cluster.
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
//   * the LM step: lambda = 1e-5 max diag H, the damped 6x6 solve (x = 0
//     where a pivot is <= 0 or NaN), the retract exp(dx) @ T
//     (geometry/se3.py with its theta2 < 1e-8 branch), g2o's rho test and
//     the lambda/nu update.
// Everything is float64 from the float32 inputs, as the plain version; the
// Huber widths and chi2 thresholds are float32 constants widened, as there.
//
// Bound on the card. At the main path's size (N = 1200 edges; 44 LM passes
// and 4 reclassifications per call) the call reads its 1200 x 8 floats and
// masks once (~36 KB) and writes the pose and the mask: ~0.01 us at 3.35
// TB/s. Its float64 work is 44 passes x N x ~275 operations and 4
// reclassifications x N x ~45, ~14.7 M operations: ~0.43 us at 34 TFLOP/s
// (float64 outside the tensor cores; chip_smoke.py counts them). Neither
// bounds it: the work is a chain of 44 dependent passes, each a reduction
// over every edge followed by the LM step, so latency sets its time.
//
// Design. The first design ran one CTA of 256 threads on one SM:
// per pass ~5 edges a thread on that SM's float64 units, a block sum of 28
// doubles by 5 shuffle rounds each, then ~1,500 dependent float64
// operations on thread 0 out of shared memory while 255 threads waited:
// 0.33 ms, ~7.5 us a pass. This design shortens each part of the pass:
//   * A cluster of `cluster` CTAs (16 by default, with the non-portable
//     cluster size attribute: it measured faster than 8 on the main path's
//     problems; 1-16 are taken) works on one problem, each CTA on its
//     contiguous slice of the edges. In a CTA, warps 0-7 sum edges (thread
//     t on edges begin + t, begin + t + 256, ...: at N = 1200 at most one
//     a thread) and warp 8 runs the LM step. The thread that owns an edge
//     keeps its outlier flag (in the output mask) between rounds and
//     reclassifies it at the start of the next round's first pass, so
//     reclassification needs no exchange and no barrier of its own.
//   * The 28 sums: a butterfly reduce-scatter in each edge warp (31 double
//     shuffles for all 28, lane q ends with the warp's sum q, where one
//     reduction per sum took 140; a warp without edges skips it and gives
//     +0.0), the 8 warps added in warp order by the LM warp, which sends
//     the CTA's 32 values to every CTA of the cluster with st.async into a
//     pass-parity inbox in distributed shared memory; the store's
//     completion counts bytes on the receiving CTA's mbarrier, which the
//     LM warp waits on before it adds the CTAs' sums in rank order. Every
//     order is fixed (a thread's edges in index order, the butterfly, the
//     warps, the ranks), there are no float atomics, and a replay gives the
//     same bits. A CTA writes pass p + 2's sums into an inbox only after it
//     received every CTA's sums of pass p + 1, which each sent after reading
//     pass p's. The pull through one cluster barrier a pass that the first
//     form of this design used cost ~1,900 cycles a pass (the barrier
//     ~1,250, the remote loads ~650; a remote mbarrier arrive per store was
//     slower still, a bulk copy ~3x st.async; clock64 probes on the H100).
//     The FP64 tensor cores (mma.m8n8k4.f64) were not taken for the sums:
//     their fragments spread each row over 8 lanes, so laying one edge's
//     3 x 7 terms into them costs more shuffles than the 81 multiply-adds a
//     lane spends on them.
//   * The LM step runs in the LM warp of every CTA on the same cluster-wide
//     sums, so every CTA holds the same state bit for bit and no broadcast
//     between CTAs is needed. Its state lives in that warp's registers,
//     one value a lane (lane q: accepted sum q; lane k < 12: the accepted
//     pose's entry k and the pass's pose; lane k < 6: the step), with
//     lambda and nu in every lane; shuffles gather H, g and T into every
//     lane, which runs the solve and the retract redundantly and keeps its
//     own entry. The solve is the square-root-free Cholesky (L D L^T: its
//     pivots d_j are the Cholesky's L_jj^2, so "a pivot <= 0 or NaN" is
//     the same test) with one reciprocal a pivot; the retract calls sincos
//     once and multiplies by reciprocals of theta and theta^2.
//   * While the edge warps sum, the LM warp computes the rho test's
//     denominator and the proposal that follows a rejection (the same
//     H, g and pose, lambda * nu): a rejected pass costs the rho test only;
//     an accepted one solves and retracts after its sums arrive.
//   * Every loop has a constant trip count (the triangles as tests, the
//     butterfly's widths as template arguments), so the sums and the
//     solve's factors stay in registers: with a triangular inner loop the
//     28 sums went to local memory and a pass took ~2x longer.
//   * A pass has two CTA barriers and no cluster barrier; the cluster
//     synchronizes once at the start (the mbarriers' initialization) and
//     twice at the end (the inlier count).
// What now sets the time (clock64 probes, a pass of ~6,000 cycles): one
// edge's terms and the butterfly (~2,700), overlapped with the LM warp's
// precomputed rejection; then the CTA sum, the send and the wait (~700),
// the rho test (~350) and, on an accepted pass, the solve and the retract
// (~2,000: six dependent reciprocals, the triangular solves, a square root
// and sincos). chip_smoke.py and kernel_device_ab.py time the kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int EDGE_WARPS = 8;                // warps 0-7 sum the edges
constexpr int EDGE_THREADS = 32 * EDGE_WARPS;
constexpr int LM_WARP = EDGE_WARPS;          // warp 8 runs the LM step
constexpr int THREADS = EDGE_THREADS + 32;
constexpr int NSUM = 28;  // F, H's lower triangle row by row (21), g (6)
constexpr int MAX_CLUSTER = 16;
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
    int cluster;              // CTAs working on the problem
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

// Whether edge i is an outlier at the pose T: valid, and chi2 above its
// threshold or behind the camera.
__device__ __forceinline__ bool outlier_at(const PoseLMArgs& a, const double* T, int i) {
    const Edge e = project(a, T, i);
    return a.valid[i] && (e.e2 > chi2_th(e.stereo) || !(e.pc[2] > 0.0));
}

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
        // constant trip counts (s <= r as a test), so that every loop
        // unrolls and acc stays in registers
#pragma unroll
        for (int r = 0; r < 6; ++r) {
            const double kw = k[r] * wc;
#pragma unroll
            for (int s = 0; s < 6; ++s)
                if (s <= r) acc[1 + r * (r + 1) / 2 + s] += kw * k[s];
        }
#pragma unroll
        for (int r = 0; r < 6; ++r) acc[22 + r] += (k[r] * wc) * k[6];
    }
}

// One step of width H of the butterfly below: a lane keeps the half of
// v[0 .. 2H) that its lane bit H selects and adds its partner's copy of
// that half into v[0 .. H).
template <int H>
__device__ __forceinline__ void butterfly_step(double (&v)[32], int lane) {
    const bool upper = (lane & H) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
        const double send = upper ? v[j] : v[j + H];
        const double keep = upper ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(kAll, send, H);
    }
}

// The warp's sums of v[0..31]: lane l returns the sum of v[l] over the 32
// lanes, by a fixed butterfly (31 shuffles for the 32 sums). The widths
// are template arguments so that every index is a constant and v stays in
// registers.
__device__ __forceinline__ double warp_reduce_scatter(double (&v)[32], int lane) {
    butterfly_step<16>(v, lane);
    butterfly_step<8>(v, lane);
    butterfly_step<4>(v, lane);
    butterfly_step<2>(v, lane);
    butterfly_step<1>(v, lane);
    return v[0];
}

// x with (H + lam I) x = b (H: its lower triangle row by row), by the
// square-root-free Cholesky L D L^T with one reciprocal a pivot; 0 where a
// pivot is <= 0 or NaN, as cholesky_ex's info != 0 in the plain version.
__device__ __forceinline__ void solve6(const double* H, double lam, const double* b, double* x) {
    // every loop has a constant trip count (the triangle as a test), so
    // that all of it unrolls into registers
    double L[6][6], d[6], rd[6];
    bool ok = true;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
        double u[6];  // L_jk d_k
#pragma unroll
        for (int k = 0; k < 6; ++k)
            if (k < j) u[k] = L[j][k] * d[k];
        double s = H[j * (j + 1) / 2 + j] + lam;
#pragma unroll
        for (int k = 0; k < 6; ++k)
            if (k < j) s -= L[j][k] * u[k];
        ok = ok && s > 0.0;
        d[j] = s;
        rd[j] = __drcp_rn(s);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            if (i > j) {
                double t = H[i * (i + 1) / 2 + j];
#pragma unroll
                for (int k = 0; k < 6; ++k)
                    if (k < j) t -= L[i][k] * u[k];
                L[i][j] = t * rd[j];
            }
        }
    }
    double y[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        double s = b[i];
#pragma unroll
        for (int k = 0; k < 6; ++k)
            if (k < i) s -= L[i][k] * y[k];
        y[i] = s;
    }
#pragma unroll
    for (int ii = 0; ii < 6; ++ii) {
        const int i = 5 - ii;
        double s = y[i] * rd[i];
#pragma unroll
        for (int k = 0; k < 6; ++k)
            if (k > i) s -= L[k][i] * x[k];
        x[i] = s;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = ok ? x[i] : 0.0;
}

// out = exp(dx) @ T for the 3x4 pose T (rows), dx = (omega, upsilon).
__device__ __forceinline__ void retract(const double* T, const double* dx, double* out) {
    const double w0 = dx[0], w1 = dx[1], w2 = dx[2];
    const double theta2 = w0 * w0 + w1 * w1 + w2 * w2;
    double A, B, C;
    if (theta2 < 1e-8) {
        A = 1.0 - theta2 / 6.0;
        B = 0.5 - theta2 / 24.0;
        C = 1.0 / 6.0 - theta2 / 120.0;
    } else {
        const double theta = sqrt(theta2);
        double s, c;
        sincos(theta, &s, &c);
        const double rt = __drcp_rn(theta), rt2 = __drcp_rn(theta2);
        A = s * rt;
        B = (1.0 - c) * rt2;
        C = (theta - s) * rt2 * rt;
    }
    const double W[3][3] = {{0.0, -w2, w1}, {w2, 0.0, -w0}, {-w1, w0, 0.0}};
    double R[3][3], t[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        double V[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const double W2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
            const double I = i == j ? 1.0 : 0.0;
            R[i][j] = I + A * W[i][j] + B * W2;
            V[j] = I + B * W[i][j] + C * W2;
        }
        t[i] = V[0] * dx[3] + V[1] * dx[4] + V[2] * dx[5];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            out[4 * i + j] = R[i][0] * T[j] + R[i][1] * T[4 + j] + R[i][2] * T[8 + j] + (j == 3 ? t[i] : 0.0);
}

// v[lane] for a register array v[n] (selects: no local memory).
template <int n>
__device__ __forceinline__ double lane_entry(const double (&v)[n], int lane) {
    double out = v[0];
#pragma unroll
    for (int k = 1; k < n; ++k) out = lane == k ? v[k] : out;
    return out;
}

// The LM step's proposal from the accepted state (sums acc_l and pose T_l,
// one value a lane) at damping lam: dx = -(H + lam I)^-1 g and exp(dx) @ T.
// Every lane computes both; lane k keeps entry k of each.
__device__ __forceinline__ void propose(double acc_l, double T_l, double lam, int lane, double& P_l,
                                        double& dx_l) {
    double H[21], g[6], Tm[12], dx[6], next[12];
#pragma unroll
    for (int q = 0; q < 21; ++q) H[q] = __shfl_sync(kAll, acc_l, 1 + q);
#pragma unroll
    for (int q = 0; q < 6; ++q) g[q] = __shfl_sync(kAll, acc_l, 22 + q);
#pragma unroll
    for (int k = 0; k < 12; ++k) Tm[k] = __shfl_sync(kAll, T_l, k);
    solve6(H, lam, g, dx);
#pragma unroll
    for (int q = 0; q < 6; ++q) dx[q] = -dx[q];
    retract(Tm, dx, next);
    P_l = lane_entry(next, lane);
    dx_l = lane_entry(dx, lane);
}

// g2o's rho denominator dx^T (lam dx + b), b = -g, summed in index order,
// from the state one value a lane (lane k < 6: dx_k; lane 22 + k: g_k).
__device__ __forceinline__ double rho_denominator(double acc_l, double dx_l, double lam, int lane) {
    const double g_l = __shfl_sync(kAll, acc_l, 22 + (lane < 6 ? lane : 0));
    const double term = dx_l * (lam * dx_l - g_l);
    double denom = 0.0;
#pragma unroll
    for (int q = 0; q < 6; ++q) denom += __shfl_sync(kAll, term, q);
    return denom;
}

// The exchange of the CTAs' sums: each CTA's LM warp writes its 32 values
// into every CTA's inbox with st.async, whose completion counts bytes on the
// receiving CTA's mbarrier; a CTA waits on its own mbarrier, then reads its
// inbox. Addresses are 32-bit shared-window addresses.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}
__device__ __forceinline__ void mbar_init(uint32_t mbar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(mbar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t mbar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t mbar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(mbar),
        "r"(parity)
        : "memory");
}
__device__ __forceinline__ void st_async(uint32_t remote, double v, uint32_t remote_mbar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];" ::"r"(remote),
                 "l"(__double_as_longlong(v)), "r"(remote_mbar)
                 : "memory");
}

__global__ void __launch_bounds__(THREADS, 1) pose_lm_kernel(const PoseLMArgs a) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank(), n_cta = (int)cluster.num_blocks();
    __shared__ double sT0[12];                      // T0, widened
    __shared__ double sT[12];                       // the pass's pose; after a round, its final pose
    __shared__ double red[EDGE_WARPS][32];          // the edge warps' sums
    __shared__ double inbox[2][MAX_CLUSTER][32];    // every CTA's sums, by pass parity
    __shared__ unsigned long long mbar[2];          // inbox[parity] complete
    __shared__ int s_count;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool lm = warp == LM_WARP;
    const unsigned inbox_bytes = (unsigned)n_cta * 32 * sizeof(double);
    // this CTA's contiguous slice of the edges
    const int begin = (int)((long long)a.n * rank / n_cta);
    const int end = (int)((long long)a.n * (rank + 1) / n_cta);

    if (tid < 12) sT0[tid] = sT[tid] = (double)a.T0[tid];
    if (tid == 0) {
        s_count = 0;
        mbar_init(smem_addr(&mbar[0]), 1);
        mbar_init(smem_addr(&mbar[1]), 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        mbar_expect_tx(smem_addr(&mbar[0]), inbox_bytes);  // passes 0 and 1
        mbar_expect_tx(smem_addr(&mbar[1]), inbox_bytes);
    }
    if (!lm)
        for (int i = begin + tid; i < end; i += EDGE_THREADS) a.inlier[i] = false;  // outlier flags
    cluster.sync();  // every CTA's mbarriers initialized before any st.async

    // the LM warp's state, one value a lane, the same in every CTA
    double acc_l = 0.0;  // lane q < NSUM: the accepted pass's sum q
    double T_l = 0.0;    // lane k < 12: the accepted pose's entry k
    double P_l = 0.0;    // lane k < 12: the pass's pose's entry k
    double dx_l = 0.0;   // lane k < 6: the step's entry k
    double lam = 0.0, ni = 2.0;
    double PR_l = 0.0, dxR_l = 0.0, denom = 0.0;  // the next proposal if this pass's is rejected

    int pass = 0;
    for (int round = 0; round < a.n_rounds; ++round) {
        const bool huber = round < a.n_rounds - 1;
        if (lm && lane < 12) P_l = sT0[lane];
        for (int it = 0; it <= a.n_iters; ++it, ++pass) {
            const int par = pass & 1;
            if (!lm) {
                double T[12];
#pragma unroll
                for (int k = 0; k < 12; ++k) T[k] = it == 0 ? sT0[k] : sT[k];
                double v[32];
#pragma unroll
                for (int q = 0; q < 32; ++q) v[q] = 0.0;
                for (int i = begin + tid; i < end; i += EDGE_THREADS) {
                    bool out = a.inlier[i];
                    if (it == 0 && round > 0) {  // reclassify at the last round's pose
                        out = outlier_at(a, sT, i);
                        a.inlier[i] = out;
                    }
                    accumulate(a, T, i, a.valid[i] && !out, huber, v);
                }
                // a warp without edges sums zeros: +0.0, as its butterfly would
                red[warp][lane] = begin + 32 * warp < end ? warp_reduce_scatter(v, lane) : 0.0;
            } else if (it > 0) {
                // while the edges are summed: the rho denominator, and the
                // next proposal for the case that this pass is rejected
                denom = rho_denominator(acc_l, dx_l, lam, lane);
                if (it < a.n_iters) propose(acc_l, T_l, lam * ni, lane, PR_l, dxR_l);
            }
            __syncthreads();
            if (lm) {
                double s = red[0][lane];
#pragma unroll
                for (int w = 1; w < EDGE_WARPS; ++w) s += red[w][lane];
                const uint32_t slot = smem_addr(&inbox[par][rank][lane]), mb = smem_addr(&mbar[par]);
                for (int r = 0; r < n_cta; ++r) st_async(cluster_addr(slot, r), s, cluster_addr(mb, r));
                mbar_wait(mb, (unsigned)(pass >> 1) & 1u);
                double tot = inbox[par][0][lane];  // the CTAs' sums in rank order
#pragma unroll
                for (int r = 1; r < MAX_CLUSTER; ++r)
                    if (r < n_cta) tot += inbox[par][r][lane];
                if (lane == 0) mbar_expect_tx(mb, inbox_bytes);  // re-armed for pass + 2
                const double F_new = __shfl_sync(kAll, tot, 0);
                bool take = it == 0;  // the round's start at T0
                if (take) {
                    ni = 2.0;
                } else {
                    const double F = __shfl_sync(kAll, acc_l, 0);
                    const double rho = (F - F_new) / (denom + 1e-12);
                    take = rho > 0.0 && isfinite(F_new);
                    if (take) {
                        const double qq = 2.0 * rho - 1.0;
                        lam *= fmax(1.0 - qq * qq * qq, 1.0 / 3.0);
                        ni = 2.0;
                    } else {
                        lam *= ni;
                        ni *= 2.0;
                    }
                }
                if (take) {
                    acc_l = tot;
                    T_l = P_l;
                }
                if (it == 0) {  // H's diagonal: sums 1, 3, 6, 10, 15, 21
                    const double d0 = __shfl_sync(kAll, acc_l, 1), d1 = __shfl_sync(kAll, acc_l, 3);
                    const double d2 = __shfl_sync(kAll, acc_l, 6), d3 = __shfl_sync(kAll, acc_l, 10);
                    const double d4 = __shfl_sync(kAll, acc_l, 15), d5 = __shfl_sync(kAll, acc_l, 21);
                    lam = 1e-5 * fmax(fmax(fmax(d0, d1), fmax(d2, d3)), fmax(d4, d5));
                }
                if (it < a.n_iters) {
                    if (take) {
                        propose(acc_l, T_l, lam, lane, P_l, dx_l);
                    } else {  // computed above with the same lam * ni
                        P_l = PR_l;
                        dx_l = dxR_l;
                    }
                } else {
                    P_l = T_l;  // the round's result: reclassified at, and the next T0's successor
                }
                if (lane < 12) sT[lane] = P_l;
            }
            __syncthreads();
        }
    }

    int count = 0;
    if (!lm) {
        for (int i = begin + tid; i < end; i += EDGE_THREADS) {
            const bool out = a.n_rounds > 0 ? outlier_at(a, sT, i) : a.inlier[i];
            const bool in = a.valid[i] && !out;
            a.inlier[i] = in;
            count += in;
        }
    }
    count = __reduce_add_sync(kAll, count);
    if (lane == 0) atomicAdd(&s_count, count);
    cluster.sync();
    if (rank == 0 && tid == 0) {
        int total = 0;
        for (int r = 0; r < n_cta; ++r) total += *cluster.map_shared_rank(&s_count, r);
        *a.n_inliers = total;
    }
    if (rank == 0 && tid < 16) a.Tcw[tid] = tid < 12 ? (float)sT[tid] : (tid == 15 ? 1.0f : 0.0f);
    cluster.sync();  // no CTA leaves while rank 0 reads its count
}

}  // namespace

// args: host pointer to a PoseLMArgs. One cluster of `cluster` CTAs for the
// problem; a refused launch (cluster size, attribute) returns its error.
extern "C" int pose_lm_launch(void* args, void* stream) {
    const PoseLMArgs& a = *static_cast<const PoseLMArgs*>(args);
    if (a.n < 0 || a.n_rounds < 0 || a.n_iters < 0 || a.cluster < 1 || a.cluster > MAX_CLUSTER)
        return (int)cudaErrorInvalidValue;
    if (a.cluster > 8) {
        const cudaError_t err = cudaFuncSetAttribute(pose_lm_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.cluster, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, pose_lm_kernel, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
