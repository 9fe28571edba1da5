// Banded SPD Cholesky kernels for Hopper (sm_90a), f64 throughout.
//
// Storage: a lower band is a row-major (d, bw+1) f64 array whose row j,
// column o holds H[j+o, j]; entries with j+o >= d are ignored on input
// and written as zero on output. The factor L uses the same layout, its
// reciprocal pivots 1/L[j,j] go to a (d,) array, and right-hand sides
// are row-major (d, r) arrays with one column per right-hand side.
//
// Every entry point takes the CUDA stream as its last argument, launches
// on it without synchronising, and returns cudaGetLastError() so that a
// refused launch reaches the caller. The library is built with
// -fmad=false: every product is rounded before it is added, as in the
// plain PyTorch versions beside the wrappers, and each kernel sums in the
// same order as its plain version, so the two agree bit for bit.
//
// What these replace, and what bounds them on this card
// ------------------------------------------------------
// K1 band_factor    replaces bayesgp_tpu/linalg/band_kernels.py:factor_fn
//                   (_factor_body): banded Cholesky with the pivot clamp
//                   (|pivot|, 1e-12 floor) and caps (|L| <= 1e3,
//                   |Y| <= 1e8), fused Y = L^{-1} C and the half log-det.
// K2 band_fwd_solve replaces band_kernels.py:fwd_solve_fn (L Y = B).
// K3 band_bwd_solve replaces band_kernels.py:bwd_solve_fn (L^T X = Y); it
//                   loops backwards, where the TPU kernel flipped rows.
// K4 band_takahashi replaces band_kernels.py:takahashi_fn (band of
//                   H^{-1} from L, the backward Takahashi recurrence).
// K5 band_bwd_multi replaces band_kernels.py:bwd_multi_fn (L^T X = Z for
//                   the posterior draws, one column per draw).
// K1c-K5c factor_chunked_fn, fwd_solve_chunked_fn, bwd_solve_chunked_fn,
//                   bwd_multi_chunked_fn, takahashi_chunked_fn
//                   (band_kernels.py:466-634), the same five functions
//                   streamed 1024 rows a call to fit VMEM, are K1-K5 here
//                   at every shape the JAX package sends them (below).
// K8-K11 band_factor_batched, band_fwd_solve_batched,
//                   band_bwd_solve_batched, band_takahashi_batched replace
//                   bayesgp_tpu/linalg/band_batched.py:bfactor_fn, bfwd_fn,
//                   bbwd_fn, btakahashi_fn: NR independent systems of one
//                   shape in one launch, stored one after another
//                   ((NR, d, bw+1) bands, (NR, d) reciprocal pivots,
//                   (NR, d, m) right-hand sides). K8 has no tail block and
//                   writes one half log-det per system.
//
// Bound. Each kernel is a prefix recurrence over the d columns with
// O(bw^2 + bw q) work per column and right-hand side. The roofline
// bound is tiny: at the headline shape (d = 2048, bw = 3, q = 4) K1-K4
// move at most ~0.3 MB each, under 0.1 us at 3.35 TB/s, and their
// flops take less than that at the FP64 peak; K5 moves its (d, M)
// right-hand side and solution, 98 MB at M = 3000, ~29 us. The real
// floor of K1-K4 is the dependency chain: column j needs column j-1,
// so d steps run one after another, each costing the latency of a few
// dependent f64 operations (a multiply-subtract chain; in K1 also a
// sqrt and a divide, each a software sequence of dependent f64
// operations) -- tens of cycles a row in the solves, a few hundred a
// column in K1, i.e. d x ~0.02-0.2 us. K5 has the same chain per
// column of draws, with M / 128 blocks.
//
// Design against that floor. Nothing on a chain waits on device memory
// or on a modulo: blocks stage the next STAGE rows of their inputs into
// shared memory, and ring positions are stepped. For bandwidths up to
// SMALL_BW (the IWP path has bw = p = 3) the kernels are compiled per
// bandwidth and keep the recurrence window in registers:
//   K1  one thread runs the column recurrence (pivot, sqrt, divide, the
//       bw entries) with the last bw columns in registers and no
//       barrier inside a chunk; a second warp computes the tail rows
//       Y[j] = (C[j] - sum L[j, j-t] Y[j-t]) / L_jj of the previous
//       chunk meanwhile, one thread per tail column; the log pivots are
//       taken by the whole block after the loop.
//   K2/K3/K5  one thread per right-hand side with its last bw solution
//       values in registers.
// Wider bands take generic kernels: threads across one column's band
// entries and tail columns (K1) and a shared-memory ring for the window.
// K4 runs once per gradient and keeps the generic form: threads across
// the bw entries of a row of H^{-1}, two barriers a row.
//
// Every shape the JAX package sends to its kernels runs here, those of
// its chunked kernels (K1c-K5c, band_kernels.py:466-634) included:
// bw <= 125 (BW_MAX in the wrapper), any tail width and any d. No buffer
// grows with d. K1's block holds the tail columns bgt_band_factor_tile
// allows (its threads and shared memory); the wrapper computes the
// others with bgt_band_tail_solve, K2 with K1's cap on |Y|, which sums
// each column in K1's order.
//
// The batched kernels. The TPU packed NR systems side by side on the 128
// lanes because one system filled 6% of a vector; here a system is a
// thread block. Every recurrence above is a __device__ function of one
// system's pointers; the K1-K5 kernels call it on their arguments, the
// K8-K11 kernels give the grid a system axis (blockIdx.x for K8 and K11,
// blockIdx.y beside the column tiles for K9 and K10) and call it at that
// system's offset. The chain of one system is as long as before, but up
// to 132 of them run at once, one a multiprocessor, and system r of a
// batched kernel runs the same device code as the one-system kernel: the
// two agree bit for bit. K9/K10 blocks have as many threads as a system
// has right-hand sides (rounded to a warp, at most RHS_THREADS).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int STAGE = 32;            // rows staged per refill
constexpr int SMALL_BW = 8;          // widest band with a register window
constexpr int MAX_TAIL_SMALL = 480;  // tail columns of the small K1 block
constexpr double PIVOT_FLOOR = 1e-12;
constexpr double L_CAP = 1e3;
constexpr double Y_CAP = 1e8;
constexpr int RHS_THREADS = 128;     // threads per block in K2/K3/K5
constexpr int MAX_THREADS = 1024;    // threads a block may have
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 227 * 1024;  // dynamic shared memory a block
                                         // may have on sm_90
constexpr double NO_CAP = HUGE_VAL;  // the solves' cap: none (K2), or Y_CAP
                                     // for the tail tiles K1 leaves to K2

__device__ __forceinline__ double clip(double x, double cap) {
    // NaN propagates (like torch.clamp), unlike fmin/fmax
    return x > cap ? cap : (x < -cap ? -cap : x);
}

__device__ __forceinline__ double clamp_pivot(double p) {
    return p < PIVOT_FLOOR ? fmax(fabs(p), PIVOT_FLOOR) : p;
}

// ring positions: one step back / forward in a ring of W slots
__device__ __forceinline__ int ring_dec(int s, int W) {
    return s == 0 ? W - 1 : s - 1;
}
__device__ __forceinline__ int ring_inc(int s, int W) {
    return s + 1 == W ? 0 : s + 1;
}

int round_threads(int n) {
    int t = ((n + 31) / 32) * 32;
    if (t < 32) t = 32;
    if (t > 1024) t = 1024;
    return t;
}

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
    if (bytes <= DEFAULT_SMEM) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// The half log-det from the clamped pivots in piv[0..d): every thread
// takes the logs of its share, then thread 0 sums them in column order.
// Ends with piv holding log pivots.
__device__ void half_logdet(double* piv, double* hld, int d) {
    __syncthreads();
    for (int j = threadIdx.x; j < d; j += blockDim.x) piv[j] = log(piv[j]);
    __syncthreads();
    if (threadIdx.x == 0) {
        double logdet = 0.0;
        for (int j = 0; j < d; ++j) logdet += piv[j];
        hld[0] = 0.5 * logdet;
    }
}

// ------------------------------------------------------ K1, bw <= 8 --
// Chunk s: warp 0 stages the band rows of chunk s and its lane 0 runs
// their columns; warps 1.. compute the tail rows of chunk s-1 from the
// multipliers L[j, j-t] and 1/L_jj lane 0 left in a double buffer.
template <int BW>
__device__ __forceinline__ void factor_small(const double* __restrict__ band,
                                             const double* __restrict__ C,
                                             double* __restrict__ L,
                                             double* __restrict__ rinv,
                                             double* __restrict__ Y,
                                             double* __restrict__ piv,
                                             double* __restrict__ hld,
                                             int d, int q, double* sm) {
    constexpr int W = BW + 1;
    double* Bs = sm;                      // [STAGE][W] band rows, chunk s
    double* Ms = Bs + STAGE * W;          // [2][STAGE][BW] L[j, j-t]
    double* Rb = Ms + 2 * STAGE * BW;     // [2][STAGE] 1/L_jj
    const int tid = threadIdx.x;
    const int yc = tid - 32;              // tail column of warps 1..
    const int nchunks = (d + STAGE - 1) / STAGE;
    double cols[BW][W];                   // lane 0: columns j-1 .. j-BW
    double yw[BW];                        // tail threads: Y[j-1 .. j-BW]
#pragma unroll
    for (int k = 0; k < BW; ++k) {
        yw[k] = 0.0;
#pragma unroll
        for (int o = 0; o < W; ++o) cols[k][o] = 0.0;
    }
    for (int s = 0; s <= nchunks; ++s) {
        if (tid < 32 && s < nchunks) {
            const int j0 = s * STAGE;
            const int rows = min(STAGE, d - j0);
            for (int i = tid; i < rows * W; i += 32)
                Bs[i] = band[(size_t)j0 * W + i];
            __syncwarp();
            if (tid == 0) {
                double* Mb = Ms + (s & 1) * STAGE * BW;
                double* Rbb = Rb + (s & 1) * STAGE;
                for (int i = 0; i < rows; ++i) {
                    const int j = j0 + i;
                    double p = Bs[i * W];
#pragma unroll
                    for (int t = 1; t <= BW; ++t)
                        if (t <= j) p -= cols[t - 1][t] * cols[t - 1][t];
                    const double pv = clamp_pivot(p);
                    const double rs = 1.0 / sqrt(pv);
                    double e[W];
                    e[0] = clip(pv * rs, L_CAP);
#pragma unroll
                    for (int o = 1; o <= BW; ++o) {
                        double acc = Bs[i * W + o];
#pragma unroll
                        for (int t = 1; t + o <= BW; ++t)
                            if (t <= j)
                                acc -= cols[t - 1][o + t] * cols[t - 1][t];
                        e[o] = clip(j + o < d ? acc * rs : 0.0, L_CAP);
                    }
#pragma unroll
                    for (int t = 1; t <= BW; ++t)
                        Mb[i * BW + t - 1] = cols[t - 1][t];
#pragma unroll
                    for (int o = 0; o < W; ++o) L[(size_t)j * W + o] = e[o];
                    Rbb[i] = rs;
                    rinv[j] = rs;
                    piv[j] = pv;
#pragma unroll
                    for (int k = BW - 1; k > 0; --k)
#pragma unroll
                        for (int o = 0; o < W; ++o) cols[k][o] = cols[k - 1][o];
#pragma unroll
                    for (int o = 0; o < W; ++o) cols[0][o] = e[o];
                }
            }
        }
        if (yc >= 0 && yc < q && s >= 1) {
            const int j0 = (s - 1) * STAGE;
            const int rows = min(STAGE, d - j0);
            const double* Mb = Ms + ((s - 1) & 1) * STAGE * BW;
            const double* Rbb = Rb + ((s - 1) & 1) * STAGE;
            for (int i = 0; i < rows; ++i) {
                const int j = j0 + i;
                double acc = C[(size_t)j * q + yc];
#pragma unroll
                for (int t = 1; t <= BW; ++t)
                    if (t <= j) acc -= yw[t - 1] * Mb[i * BW + t - 1];
                const double v = clip(acc * Rbb[i], Y_CAP);
#pragma unroll
                for (int k = BW - 1; k > 0; --k) yw[k] = yw[k - 1];
                yw[0] = v;
                Y[(size_t)j * q + yc] = v;
            }
        }
        __syncthreads();
    }
    half_logdet(piv, hld, d);
}

template <int BW>
__global__ void band_factor_small(const double* __restrict__ band,
                                  const double* __restrict__ C,
                                  double* __restrict__ L,
                                  double* __restrict__ rinv,
                                  double* __restrict__ Y,
                                  double* __restrict__ piv,
                                  double* __restrict__ hld,
                                  int d, int q) {
    extern __shared__ double sm[];
    factor_small<BW>(band, C, L, rinv, Y, piv, hld, d, q, sm);
}

// K8: block r factors system r; no tail (q = 0: C and Y are never read)
template <int BW>
__global__ void band_factor_batched_small(const double* __restrict__ bands,
                                          double* __restrict__ L,
                                          double* __restrict__ rinv,
                                          double* __restrict__ piv,
                                          double* __restrict__ hld, int d) {
    extern __shared__ double sm[];
    const size_t r = blockIdx.x;
    const size_t ob = r * d * (BW + 1), od = r * d;
    factor_small<BW>(bands + ob, nullptr, L + ob, rinv + od, nullptr,
                     piv + od, hld + r, d, 0, sm);
}

// --------------------------------------------------- K1, generic bw --
// Threads [0, W) compute the band entries L[j+o, j], threads [W, W+q)
// the tail row Y[j, c]; every thread computes the pivot itself.
__device__ __forceinline__ void factor_columns(
        const double* __restrict__ band, const double* __restrict__ C,
        double* __restrict__ L, double* __restrict__ rinv,
        double* __restrict__ Y, double* __restrict__ piv,
        double* __restrict__ hld, int d, int bw, int q, double* sm) {
    const int W = bw + 1;
    double* Lw = sm;                  // [W][W] ring: last W columns of L
    double* Yw = Lw + W * W;          // [W][q] ring: last W rows of Y
    double* Bs = Yw + W * q;          // [STAGE][W] staged band rows
    double* Cs = Bs + STAGE * W;      // [STAGE][q] staged tail rows
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int yc = tid - W;           // tail column of this thread
    int slot = 0;                     // ring slot of column j

    for (int j = 0; j < d; ++j) {
        const int jr = j % STAGE;
        if (jr == 0) {
            const int rows = min(STAGE, d - j);
            for (int i = tid; i < rows * W; i += nt)
                Bs[i] = band[(size_t)j * W + i];
            for (int i = tid; i < rows * q; i += nt)
                Cs[i] = C[(size_t)j * q + i];
            __syncthreads();
        }
        const int nprev = min(j, bw);
        double p = Bs[jr * W];
        for (int t = 1, s = ring_dec(slot, W); t <= nprev;
             ++t, s = ring_dec(s, W)) {
            const double m = Lw[s * W + t];
            p -= m * m;
        }
        const double pv = clamp_pivot(p);
        const double rs = 1.0 / sqrt(pv);

        if (tid < W) {
            const int o = tid;
            double v = 0.0;
            if (j + o < d) {
                if (o == 0) {
                    v = pv * rs;
                } else {
                    double acc = Bs[jr * W + o];
                    for (int t = 1, s = ring_dec(slot, W);
                         t <= nprev && o + t <= bw;
                         ++t, s = ring_dec(s, W))
                        acc -= Lw[s * W + o + t] * Lw[s * W + t];
                    v = acc * rs;
                }
            }
            v = clip(v, L_CAP);
            Lw[slot * W + o] = v;
            L[(size_t)j * W + o] = v;
        } else if (yc < q) {
            double acc = Cs[jr * q + yc];
            for (int t = 1, s = ring_dec(slot, W); t <= nprev;
                 ++t, s = ring_dec(s, W))
                acc -= Yw[s * q + yc] * Lw[s * W + t];
            const double v = clip(acc * rs, Y_CAP);
            Yw[slot * q + yc] = v;
            Y[(size_t)j * q + yc] = v;
        }
        if (tid == 0) {
            rinv[j] = rs;
            piv[j] = pv;
        }
        slot = ring_inc(slot, W);
        __syncthreads();
    }
    half_logdet(piv, hld, d);
}

__global__ void band_factor_kernel(const double* __restrict__ band,
                                   const double* __restrict__ C,
                                   double* __restrict__ L,
                                   double* __restrict__ rinv,
                                   double* __restrict__ Y,
                                   double* __restrict__ piv,
                                   double* __restrict__ hld,
                                   int d, int bw, int q) {
    extern __shared__ double sm[];
    factor_columns(band, C, L, rinv, Y, piv, hld, d, bw, q, sm);
}

__global__ void band_factor_batched_kernel(const double* __restrict__ bands,
                                           double* __restrict__ L,
                                           double* __restrict__ rinv,
                                           double* __restrict__ piv,
                                           double* __restrict__ hld,
                                           int d, int bw) {
    extern __shared__ double sm[];
    const size_t r = blockIdx.x;
    const size_t ob = r * d * (bw + 1), od = r * d;
    factor_columns(bands + ob, nullptr, L + ob, rinv + od, nullptr,
                   piv + od, hld + r, d, bw, 0, sm);
}

// ------------------------------------------------ K2, K3, K5, bw <= 8 --
// One thread per right-hand-side column with its last BW solution values
// in registers; the block stages STAGE rows of the multipliers, 1/L_jj
// and its right-hand sides at a time.
template <int BW>
__device__ __forceinline__ void fwd_small(const double* __restrict__ L,
                                          const double* __restrict__ rinv,
                                          const double* __restrict__ B,
                                          double* __restrict__ X,
                                          int d, int r, double cap,
                                          double* sm) {
    constexpr int W = BW + 1;
    const int nt = blockDim.x;
    const int tx = threadIdx.x;
    const int c = blockIdx.x * nt + tx;
    double* Ls = sm;                  // [STAGE][BW]: L[j, j-t] at t-1
    double* Rs = Ls + STAGE * BW;     // [STAGE] 1/L_jj
    double* Bs = Rs + STAGE;          // [STAGE][nt] right-hand sides
    double w[BW];                     // X[j-1 .. j-BW]
#pragma unroll
    for (int k = 0; k < BW; ++k) w[k] = 0.0;
    for (int j0 = 0; j0 < d; j0 += STAGE) {
        const int rows = min(STAGE, d - j0);
        __syncthreads();
        for (int i = tx; i < rows * BW; i += nt) {
            const int j = j0 + i / BW, t = i % BW + 1;
            Ls[i] = j - t >= 0 ? L[(size_t)(j - t) * W + t] : 0.0;
        }
        for (int i = tx; i < rows; i += nt) Rs[i] = rinv[j0 + i];
        if (c < r)
            for (int i = 0; i < rows; ++i)
                Bs[i * nt + tx] = B[(size_t)(j0 + i) * r + c];
        __syncthreads();
        if (c >= r) continue;
#pragma unroll 4
        for (int i = 0; i < rows; ++i) {
            const int j = j0 + i;
            double acc = Bs[i * nt + tx];
#pragma unroll
            for (int t = 1; t <= BW; ++t)
                if (t <= j) acc -= w[t - 1] * Ls[i * BW + t - 1];
            const double v = clip(acc * Rs[i], cap);
#pragma unroll
            for (int k = BW - 1; k > 0; --k) w[k] = w[k - 1];
            w[0] = v;
            X[(size_t)j * r + c] = v;
        }
    }
}

template <int BW>
__global__ void band_fwd_small(const double* __restrict__ L,
                               const double* __restrict__ rinv,
                               const double* __restrict__ B,
                               double* __restrict__ X, int d, int r,
                               double cap) {
    extern __shared__ double sm[];
    fwd_small<BW>(L, rinv, B, X, d, r, cap, sm);
}

template <int BW>
__device__ __forceinline__ void bwd_small(const double* __restrict__ L,
                                          const double* __restrict__ rinv,
                                          const double* __restrict__ B,
                                          double* __restrict__ X,
                                          int d, int r, double* sm) {
    constexpr int W = BW + 1;
    const int nt = blockDim.x;
    const int tx = threadIdx.x;
    const int c = blockIdx.x * nt + tx;
    double* Ls = sm;                  // [STAGE][W] rows of L
    double* Rs = Ls + STAGE * W;      // [STAGE] 1/L_jj
    double* Bs = Rs + STAGE;          // [STAGE][nt] right-hand sides
    double w[BW];                     // X[j+1 .. j+BW]
#pragma unroll
    for (int k = 0; k < BW; ++k) w[k] = 0.0;
    for (int j1 = d; j1 > 0; j1 -= STAGE) {
        const int j0 = max(0, j1 - STAGE);
        const int rows = j1 - j0;
        __syncthreads();
        for (int i = tx; i < rows * W; i += nt)
            Ls[i] = L[(size_t)j0 * W + i];
        for (int i = tx; i < rows; i += nt) Rs[i] = rinv[j0 + i];
        if (c < r)
            for (int i = 0; i < rows; ++i)
                Bs[i * nt + tx] = B[(size_t)(j0 + i) * r + c];
        __syncthreads();
        if (c >= r) continue;
#pragma unroll 4
        for (int i = rows - 1; i >= 0; --i) {
            const int j = j0 + i;
            double acc = Bs[i * nt + tx];
#pragma unroll
            for (int t = 1; t <= BW; ++t)
                if (j + t < d) acc -= w[t - 1] * Ls[i * W + t];
            const double v = acc * Rs[i];
#pragma unroll
            for (int k = BW - 1; k > 0; --k) w[k] = w[k - 1];
            w[0] = v;
            X[(size_t)j * r + c] = v;
        }
    }
}

template <int BW>
__global__ void band_bwd_small(const double* __restrict__ L,
                               const double* __restrict__ rinv,
                               const double* __restrict__ B,
                               double* __restrict__ X, int d, int r) {
    extern __shared__ double sm[];
    bwd_small<BW>(L, rinv, B, X, d, r, sm);
}

template <int BW>
__global__ void band_bwd_multi_small(const double* __restrict__ L,
                                     const double* __restrict__ rinv,
                                     const double* __restrict__ B,
                                     double* __restrict__ X, int d, int r) {
    extern __shared__ double sm[];
    bwd_small<BW>(L, rinv, B, X, d, r, sm);
}

// K9 / K10: blockIdx.y is the system, blockIdx.x its tile of right-hand
// sides; r right-hand sides a system
template <int BW>
__global__ void band_fwd_batched_small(const double* __restrict__ L,
                                       const double* __restrict__ rinv,
                                       const double* __restrict__ B,
                                       double* __restrict__ X, int d, int r) {
    extern __shared__ double sm[];
    const size_t s = blockIdx.y;
    const size_t ob = s * d * (BW + 1), od = s * d, ox = s * d * r;
    fwd_small<BW>(L + ob, rinv + od, B + ox, X + ox, d, r, NO_CAP, sm);
}

template <int BW>
__global__ void band_bwd_batched_small(const double* __restrict__ L,
                                       const double* __restrict__ rinv,
                                       const double* __restrict__ B,
                                       double* __restrict__ X, int d, int r) {
    extern __shared__ double sm[];
    const size_t s = blockIdx.y;
    const size_t ob = s * d * (BW + 1), od = s * d, ox = s * d * r;
    bwd_small<BW>(L + ob, rinv + od, B + ox, X + ox, d, r, sm);
}

// ---------------------------------------------- K2, K3, K5, generic bw --
// As above with the window in a shared-memory ring, one strip a thread.
__device__ __forceinline__ void fwd_columns(const double* __restrict__ L,
                                            const double* __restrict__ rinv,
                                            const double* __restrict__ B,
                                            double* __restrict__ X,
                                            int d, int bw, int r,
                                            double cap, double* sm) {
    const int W = bw + 1;
    const int nt = blockDim.x;
    const int tx = threadIdx.x;
    const int c = blockIdx.x * nt + tx;
    double* Ls = sm;                  // [STAGE][bw]: L[j, j-t] at t-1
    double* Rs = Ls + STAGE * bw;     // [STAGE] 1/L_jj
    double* Bs = Rs + STAGE;          // [STAGE][nt] right-hand sides
    double* win = Bs + STAGE * nt;    // [W][nt] last W solution rows
    int slot = 0;
    for (int j0 = 0; j0 < d; j0 += STAGE) {
        const int rows = min(STAGE, d - j0);
        __syncthreads();
        for (int i = tx; i < rows * bw; i += nt) {
            const int j = j0 + i / bw, t = i % bw + 1;
            Ls[i] = j - t >= 0 ? L[(size_t)(j - t) * W + t] : 0.0;
        }
        for (int i = tx; i < rows; i += nt) Rs[i] = rinv[j0 + i];
        if (c < r)
            for (int i = 0; i < rows; ++i)
                Bs[i * nt + tx] = B[(size_t)(j0 + i) * r + c];
        __syncthreads();
        if (c >= r) continue;
        for (int i = 0; i < rows; ++i) {
            const int j = j0 + i;
            double acc = Bs[i * nt + tx];
            const int nprev = min(j, bw);
            for (int t = 1, s = ring_dec(slot, W); t <= nprev;
                 ++t, s = ring_dec(s, W))
                acc -= win[s * nt + tx] * Ls[i * bw + t - 1];
            const double v = clip(acc * Rs[i], cap);
            win[slot * nt + tx] = v;
            X[(size_t)j * r + c] = v;
            slot = ring_inc(slot, W);
        }
    }
}

__global__ void band_fwd_kernel(const double* __restrict__ L,
                                const double* __restrict__ rinv,
                                const double* __restrict__ B,
                                double* __restrict__ X,
                                int d, int bw, int r, double cap) {
    extern __shared__ double sm[];
    fwd_columns(L, rinv, B, X, d, bw, r, cap, sm);
}

__device__ __forceinline__ void bwd_columns(const double* __restrict__ L,
                                            const double* __restrict__ rinv,
                                            const double* __restrict__ B,
                                            double* __restrict__ X,
                                            int d, int bw, int r,
                                            double* sm) {
    const int W = bw + 1;
    const int nt = blockDim.x;
    const int tx = threadIdx.x;
    const int c = blockIdx.x * nt + tx;
    double* Ls = sm;                  // [STAGE][W] rows of L
    double* Rs = Ls + STAGE * W;      // [STAGE] 1/L_jj
    double* Bs = Rs + STAGE;          // [STAGE][nt] right-hand sides
    double* win = Bs + STAGE * nt;    // [W][nt] next W solution rows
    int slot = 0;                     // ring slot of row j; j+t at slot+t
    for (int j1 = d; j1 > 0; j1 -= STAGE) {
        const int j0 = max(0, j1 - STAGE);
        const int rows = j1 - j0;
        __syncthreads();
        for (int i = tx; i < rows * W; i += nt)
            Ls[i] = L[(size_t)j0 * W + i];
        for (int i = tx; i < rows; i += nt) Rs[i] = rinv[j0 + i];
        if (c < r)
            for (int i = 0; i < rows; ++i)
                Bs[i * nt + tx] = B[(size_t)(j0 + i) * r + c];
        __syncthreads();
        if (c >= r) continue;
        for (int i = rows - 1; i >= 0; --i) {
            const int j = j0 + i;
            double acc = Bs[i * nt + tx];
            const int nnext = min(d - 1 - j, bw);
            for (int t = 1, s = ring_inc(slot, W); t <= nnext;
                 ++t, s = ring_inc(s, W))
                acc -= win[s * nt + tx] * Ls[i * W + t];
            const double v = acc * Rs[i];
            win[slot * nt + tx] = v;
            X[(size_t)j * r + c] = v;
            slot = ring_dec(slot, W);
        }
    }
}

__global__ void band_bwd_kernel(const double* __restrict__ L,
                                const double* __restrict__ rinv,
                                const double* __restrict__ B,
                                double* __restrict__ X,
                                int d, int bw, int r) {
    extern __shared__ double sm[];
    bwd_columns(L, rinv, B, X, d, bw, r, sm);
}

__global__ void band_bwd_multi_kernel(const double* __restrict__ L,
                                      const double* __restrict__ rinv,
                                      const double* __restrict__ B,
                                      double* __restrict__ X,
                                      int d, int bw, int r) {
    extern __shared__ double sm[];
    bwd_columns(L, rinv, B, X, d, bw, r, sm);
}

__global__ void band_fwd_batched_kernel(const double* __restrict__ L,
                                        const double* __restrict__ rinv,
                                        const double* __restrict__ B,
                                        double* __restrict__ X,
                                        int d, int bw, int r) {
    extern __shared__ double sm[];
    const size_t s = blockIdx.y;
    const size_t ob = s * d * (bw + 1), od = s * d, ox = s * d * r;
    fwd_columns(L + ob, rinv + od, B + ox, X + ox, d, bw, r, NO_CAP, sm);
}

__global__ void band_bwd_batched_kernel(const double* __restrict__ L,
                                        const double* __restrict__ rinv,
                                        const double* __restrict__ B,
                                        double* __restrict__ X,
                                        int d, int bw, int r) {
    extern __shared__ double sm[];
    const size_t s = blockIdx.y;
    const size_t ob = s * d * (bw + 1), od = s * d, ox = s * d * r;
    bwd_columns(L + ob, rinv + od, B + ox, X + ox, d, bw, r, sm);
}

// ---------------------------------------------------------------- K4 --
// Z[j, o] = (H^{-1})[j+o, j], by the backward recurrence
//   Z[j, o] = -sum_t (L[j+t, j] rinv_j) S(j+t, j+o)      (o = 1..bw)
//   Z[j, 0] = rinv_j^2 - sum_t (L[j+t, j] rinv_j) Z[j, t]
// with S the symmetric selected inverse of rows j+1..j+bw (in the ring).
__device__ __forceinline__ void takahashi_rows(
        const double* __restrict__ L, const double* __restrict__ rinv,
        double* __restrict__ Z, int d, int bw, double* sm) {
    const int W = bw + 1;
    double* Zw = sm;                  // [W][W] ring: rows j..j+bw of Z
    double* Ls = Zw + W * W;          // [STAGE][W] staged rows of L
    double* Rs = Ls + STAGE * W;      // [STAGE] 1/L_jj
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    int slot = 0;                     // ring slot of row j; j+k at slot+k
    for (int j1 = d; j1 > 0; j1 -= STAGE) {
        const int j0 = max(0, j1 - STAGE);
        const int rows = j1 - j0;
        __syncthreads();
        for (int i = tid; i < rows * W; i += nt)
            Ls[i] = L[(size_t)j0 * W + i];
        for (int i = tid; i < rows; i += nt) Rs[i] = rinv[j0 + i];
        __syncthreads();
        for (int i = rows - 1; i >= 0; --i) {
            const int j = j0 + i;
            const double rs = Rs[i];
            const double* Lj = Ls + i * W;
            const int o = tid + 1;
            if (o <= bw) {
                double acc = 0.0;
                if (j + o < d) {
                    int sa = ring_inc(slot, W);        // slot of row j+t
                    int sb = slot + o;                 // slot of row j+o
                    if (sb >= W) sb -= W;
                    for (int t = 1; t <= bw && j + t < d;
                         ++t, sa = ring_inc(sa, W)) {
                        const double s = t >= o ? Zw[sb * W + (t - o)]
                                                : Zw[sa * W + (o - t)];
                        acc += (Lj[t] * rs) * s;
                    }
                }
                Zw[slot * W + o] = -acc;
                Z[(size_t)j * W + o] = -acc;
            }
            __syncthreads();
            if (tid == 0) {
                double zjj = rs * rs;
                for (int t = 1; t <= bw && j + t < d; ++t)
                    zjj -= (Lj[t] * rs) * Zw[slot * W + t];
                Zw[slot * W] = zjj;
                Z[(size_t)j * W] = zjj;
            }
            slot = ring_dec(slot, W);
            __syncthreads();
        }
    }
}

__global__ void band_takahashi_kernel(const double* __restrict__ L,
                                      const double* __restrict__ rinv,
                                      double* __restrict__ Z,
                                      int d, int bw) {
    extern __shared__ double sm[];
    takahashi_rows(L, rinv, Z, d, bw, sm);
}

// K11: block r takes system r
__global__ void band_takahashi_batched_kernel(const double* __restrict__ L,
                                              const double* __restrict__ rinv,
                                              double* __restrict__ Z,
                                              int d, int bw) {
    extern __shared__ double sm[];
    const size_t r = blockIdx.x;
    const size_t ob = r * d * (bw + 1);
    takahashi_rows(L + ob, rinv + r * d, Z + ob, d, bw, sm);
}

// shared memory of the right-hand-side kernels with nt threads a block:
// staged multipliers (STAGE x lw), 1/L_jj, right-hand sides, and the
// generic kernels' ring
size_t rhs_smem(int lw, int ring_w, int nt = RHS_THREADS) {
    return sizeof(double) * ((size_t)STAGE * lw + STAGE
                             + (size_t)STAGE * nt + (size_t)ring_w * nt);
}

size_t factor_small_smem(int bw) {
    return sizeof(double) *
        ((size_t)STAGE * (bw + 1) + 2 * (size_t)STAGE * bw + 2 * STAGE);
}

size_t factor_smem(int bw, int q) {
    const int W = bw + 1;
    return sizeof(double) *
        ((size_t)W * W + (size_t)W * q + (size_t)STAGE * (W + q));
}

size_t takahashi_smem(int bw) {
    const int W = bw + 1;
    return sizeof(double) * ((size_t)W * W + (size_t)STAGE * W + STAGE);
}

template <int BW>
cudaError_t launch_factor_small(const double* band, const double* C,
                                double* L, double* rinv, double* Y,
                                double* piv, double* hld, int d, int q,
                                cudaStream_t st) {
    const int nt = 32 + (q > 0 ? round_threads(q) : 0);
    band_factor_small<BW><<<1, nt, factor_small_smem(BW), st>>>(
        band, C, L, rinv, Y, piv, hld, d, q);
    return cudaGetLastError();
}

template <int BW>
cudaError_t launch_factor_batched_small(const double* bands, double* L,
                                        double* rinv, double* piv,
                                        double* hld, int nsys, int d,
                                        cudaStream_t st) {
    band_factor_batched_small<BW><<<nsys, 32, factor_small_smem(BW), st>>>(
        bands, L, rinv, piv, hld, d);
    return cudaGetLastError();
}

template <int BW>
cudaError_t launch_rhs_small(int kind, const double* L, const double* rinv,
                             const double* B, double* X, int d, int r,
                             double cap, cudaStream_t st) {
    const int grid = (r + RHS_THREADS - 1) / RHS_THREADS;
    if (kind == 0) {
        band_fwd_small<BW><<<grid, RHS_THREADS, rhs_smem(BW, 0), st>>>(
            L, rinv, B, X, d, r, cap);
    } else if (kind == 1) {
        band_bwd_small<BW><<<grid, RHS_THREADS, rhs_smem(BW + 1, 0), st>>>(
            L, rinv, B, X, d, r);
    } else {
        band_bwd_multi_small<BW>
            <<<grid, RHS_THREADS, rhs_smem(BW + 1, 0), st>>>(
                L, rinv, B, X, d, r);
    }
    return cudaGetLastError();
}

// threads of a K9/K10 block: one a right-hand side, whole warps
int batched_rhs_threads(int r) {
    return r < RHS_THREADS ? round_threads(r) : RHS_THREADS;
}

template <int BW>
cudaError_t launch_rhs_batched_small(int kind, const double* L,
                                     const double* rinv, const double* B,
                                     double* X, int nsys, int d, int r,
                                     cudaStream_t st) {
    const int nt = batched_rhs_threads(r);
    const dim3 grid((r + nt - 1) / nt, nsys);
    if (kind == 0) {
        band_fwd_batched_small<BW><<<grid, nt, rhs_smem(BW, 0, nt), st>>>(
            L, rinv, B, X, d, r);
    } else {
        band_bwd_batched_small<BW>
            <<<grid, nt, rhs_smem(BW + 1, 0, nt), st>>>(L, rinv, B, X, d, r);
    }
    return cudaGetLastError();
}

using RhsLaunch = cudaError_t (*)(int, const double*, const double*,
                                  const double*, double*, int, int, double,
                                  cudaStream_t);
using FactorLaunch = cudaError_t (*)(const double*, const double*, double*,
                                     double*, double*, double*, double*,
                                     int, int, cudaStream_t);
using RhsBatchedLaunch = cudaError_t (*)(int, const double*, const double*,
                                         const double*, double*, int, int,
                                         int, cudaStream_t);
using FactorBatchedLaunch = cudaError_t (*)(const double*, double*, double*,
                                            double*, double*, int, int,
                                            cudaStream_t);
// the register-window instantiations, indexed by bandwidth
const RhsLaunch kRhsSmall[SMALL_BW + 1] = {
    nullptr, launch_rhs_small<1>, launch_rhs_small<2>, launch_rhs_small<3>,
    launch_rhs_small<4>, launch_rhs_small<5>, launch_rhs_small<6>,
    launch_rhs_small<7>, launch_rhs_small<8>};
const FactorLaunch kFactorSmall[SMALL_BW + 1] = {
    nullptr, launch_factor_small<1>, launch_factor_small<2>,
    launch_factor_small<3>, launch_factor_small<4>, launch_factor_small<5>,
    launch_factor_small<6>, launch_factor_small<7>, launch_factor_small<8>};

const RhsBatchedLaunch kRhsBatchedSmall[SMALL_BW + 1] = {
    nullptr, launch_rhs_batched_small<1>, launch_rhs_batched_small<2>,
    launch_rhs_batched_small<3>, launch_rhs_batched_small<4>,
    launch_rhs_batched_small<5>, launch_rhs_batched_small<6>,
    launch_rhs_batched_small<7>, launch_rhs_batched_small<8>};
const FactorBatchedLaunch kFactorBatchedSmall[SMALL_BW + 1] = {
    nullptr, launch_factor_batched_small<1>, launch_factor_batched_small<2>,
    launch_factor_batched_small<3>, launch_factor_batched_small<4>,
    launch_factor_batched_small<5>, launch_factor_batched_small<6>,
    launch_factor_batched_small<7>, launch_factor_batched_small<8>};

cudaError_t launch_rhs(int kind, const double* L, const double* rinv,
                       const double* B, double* X, int d, int bw, int r,
                       cudaStream_t st, double cap = NO_CAP) {
    if (bw >= 1 && bw <= SMALL_BW)
        return kRhsSmall[bw](kind, L, rinv, B, X, d, r, cap, st);
    const int grid = (r + RHS_THREADS - 1) / RHS_THREADS;
    const size_t smem = rhs_smem(kind == 0 ? bw : bw + 1, bw + 1);
    cudaError_t e;
    if (kind == 0) {
        e = allow_smem(band_fwd_kernel, smem);
        if (e != cudaSuccess) return e;
        band_fwd_kernel<<<grid, RHS_THREADS, smem, st>>>(L, rinv, B, X, d,
                                                         bw, r, cap);
    } else if (kind == 1) {
        e = allow_smem(band_bwd_kernel, smem);
        if (e != cudaSuccess) return e;
        band_bwd_kernel<<<grid, RHS_THREADS, smem, st>>>(L, rinv, B, X, d,
                                                         bw, r);
    } else {
        e = allow_smem(band_bwd_multi_kernel, smem);
        if (e != cudaSuccess) return e;
        band_bwd_multi_kernel<<<grid, RHS_THREADS, smem, st>>>(
            L, rinv, B, X, d, bw, r);
    }
    return cudaGetLastError();
}

cudaError_t launch_rhs_batched(int kind, const double* L, const double* rinv,
                               const double* B, double* X, int nsys, int d,
                               int bw, int r, cudaStream_t st) {
    if (bw >= 1 && bw <= SMALL_BW)
        return kRhsBatchedSmall[bw](kind, L, rinv, B, X, nsys, d, r, st);
    const int nt = batched_rhs_threads(r);
    const dim3 grid((r + nt - 1) / nt, nsys);
    const size_t smem = rhs_smem(kind == 0 ? bw : bw + 1, bw + 1, nt);
    cudaError_t e;
    if (kind == 0) {
        e = allow_smem(band_fwd_batched_kernel, smem);
        if (e != cudaSuccess) return e;
        band_fwd_batched_kernel<<<grid, nt, smem, st>>>(L, rinv, B, X, d, bw,
                                                        r);
    } else {
        e = allow_smem(band_bwd_batched_kernel, smem);
        if (e != cudaSuccess) return e;
        band_bwd_batched_kernel<<<grid, nt, smem, st>>>(L, rinv, B, X, d, bw,
                                                        r);
    }
    return cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------ C interface --
extern "C" {

// Tail columns K1 computes beside the band in one block: all q up to
// what one block holds (threads and shared memory); the caller computes
// the rest with bgt_band_tail_solve on the factor.
int bgt_band_factor_tile(int bw, int q) {
    if (bw >= 1 && bw <= SMALL_BW) return min(q, MAX_TAIL_SMALL);
    const long W = bw + 1;
    const long room = (long)(MAX_SMEM / sizeof(double)) - W * W - STAGE * W;
    long tile = room > 0 ? room / (W + STAGE) : 0;
    tile = min(tile, (long)MAX_THREADS - W);
    return (int)max(0L, min((long)q, tile));
}

int bgt_band_factor(const double* band, const double* C, double* L,
                    double* rinv, double* Y, double* piv, double* hld,
                    int d, int bw, int q, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    // a tail wider than the block takes would leave columns of Y unwritten
    if (q > bgt_band_factor_tile(bw, q)) return (int)cudaErrorInvalidValue;
    if (bw >= 1 && bw <= SMALL_BW)
        return (int)kFactorSmall[bw](band, C, L, rinv, Y, piv, hld, d, q,
                                     st);
    const size_t smem = factor_smem(bw, q);
    cudaError_t e = allow_smem(band_factor_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    band_factor_kernel<<<1, round_threads(bw + 1 + q), smem, st>>>(
        band, C, L, rinv, Y, piv, hld, d, bw, q);
    return (int)cudaGetLastError();
}

// Y = L^{-1} C for the tail columns beyond K1's tile: K2 with K1's cap
// |Y| <= 1e8, so each column equals what K1 would have computed
int bgt_band_tail_solve(const double* L, const double* rinv, const double* C,
                        double* Y, int d, int bw, int r, void* stream) {
    return (int)launch_rhs(0, L, rinv, C, Y, d, bw, r, (cudaStream_t)stream,
                           Y_CAP);
}

int bgt_band_fwd_solve(const double* L, const double* rinv, const double* B,
                       double* X, int d, int bw, int r, void* stream) {
    return (int)launch_rhs(0, L, rinv, B, X, d, bw, r, (cudaStream_t)stream);
}

int bgt_band_bwd_solve(const double* L, const double* rinv, const double* B,
                       double* X, int d, int bw, int r, void* stream) {
    return (int)launch_rhs(1, L, rinv, B, X, d, bw, r, (cudaStream_t)stream);
}

int bgt_band_bwd_multi(const double* L, const double* rinv, const double* B,
                       double* X, int d, int bw, int r, void* stream) {
    return (int)launch_rhs(2, L, rinv, B, X, d, bw, r, (cudaStream_t)stream);
}

int bgt_band_takahashi(const double* L, const double* rinv, double* Z,
                       int d, int bw, void* stream) {
    const size_t smem = takahashi_smem(bw);
    cudaError_t e = allow_smem(band_takahashi_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    band_takahashi_kernel<<<1, round_threads(bw > 1 ? bw : 1), smem,
                            (cudaStream_t)stream>>>(L, rinv, Z, d, bw);
    return (int)cudaGetLastError();
}

// K8-K11: nsys systems of one shape, stored one after another; hld (and
// the scratch piv) hold one entry (one row) per system

int bgt_band_factor_batched(const double* bands, double* L, double* rinv,
                            double* piv, double* hld, int nsys, int d,
                            int bw, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (bw >= 1 && bw <= SMALL_BW)
        return (int)kFactorBatchedSmall[bw](bands, L, rinv, piv, hld, nsys,
                                            d, st);
    const size_t smem = factor_smem(bw, 0);
    cudaError_t e = allow_smem(band_factor_batched_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    band_factor_batched_kernel<<<nsys, round_threads(bw + 1), smem, st>>>(
        bands, L, rinv, piv, hld, d, bw);
    return (int)cudaGetLastError();
}

int bgt_band_fwd_solve_batched(const double* L, const double* rinv,
                               const double* B, double* X, int nsys, int d,
                               int bw, int r, void* stream) {
    return (int)launch_rhs_batched(0, L, rinv, B, X, nsys, d, bw, r,
                                   (cudaStream_t)stream);
}

int bgt_band_bwd_solve_batched(const double* L, const double* rinv,
                               const double* B, double* X, int nsys, int d,
                               int bw, int r, void* stream) {
    return (int)launch_rhs_batched(1, L, rinv, B, X, nsys, d, bw, r,
                                   (cudaStream_t)stream);
}

int bgt_band_takahashi_batched(const double* L, const double* rinv,
                               double* Z, int nsys, int d, int bw,
                               void* stream) {
    const size_t smem = takahashi_smem(bw);
    cudaError_t e = allow_smem(band_takahashi_batched_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    band_takahashi_batched_kernel<<<nsys, round_threads(bw > 1 ? bw : 1),
                                    smem, (cudaStream_t)stream>>>(L, rinv, Z,
                                                                  d, bw);
    return (int)cudaGetLastError();
}

}  // extern "C"
