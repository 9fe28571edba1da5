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
// same order as its plain version, so the two agree bit for bit. Every
// solve sums a row's products in one order, farthest-first, except K1's
// fused tail Y = L^{-1} C and the solve that extends it to wide tails
// (bgt_band_tail_solve), which keep K1's nearest-first order.
//
// What these replace, and what bounds them on this card
// ------------------------------------------------------
// K1 band_factor    replaces bayesgp_tpu/linalg/band_kernels.py:factor_fn
//                   (_factor_body): banded Cholesky with the pivot clamp
//                   (|pivot|, 1e-12 floor) and caps (|L| <= 1e3,
//                   |Y| <= 1e8), fused Y = L^{-1} C and the half log-det;
//                   it also reports whether it clamped a pivot.
// K2 band_fwd_solve replaces band_kernels.py:fwd_solve_fn (L Y = B).
// K3 band_bwd_solve replaces band_kernels.py:bwd_solve_fn (L^T X = Y); it
//                   loops backwards, where the TPU kernel flipped rows.
// K4 band_takahashi replaces band_kernels.py:takahashi_fn (band of
//                   H^{-1} from L, the backward Takahashi recurrence).
// K5 band_bwd_multi replaces band_kernels.py:bwd_multi_fn (L^T X = Z for
//                   the posterior draws, one column per draw): K3's
//                   function, on K3's kernels.
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
// column of draws, the columns spread over the card's multiprocessors.
//
// Design against that floor. Nothing on a chain waits on device memory
// or on a modulo: blocks stage the next rows of their inputs into shared
// memory ahead of the recurrence, and ring positions are stepped.
//   K1  For bandwidths up to SMALL_BW (the IWP path has bw = p = 3) the
//       factor is compiled per bandwidth and keeps the recurrence window
//       in registers: one thread runs the column recurrence (pivot, sqrt,
//       divide, the bw entries) with the last bw columns in registers
//       and no barrier inside a chunk; a second warp computes the tail
//       rows Y[j] = (C[j] - sum L[j, j-t] Y[j-t]) / L_jj of the previous
//       chunk meanwhile, one thread per tail column; the log pivots are
//       taken by the whole block after the loop. Wider bands take a
//       generic kernel: threads across one column's band entries and
//       tail columns.
//   The solves (K2, K3, K5, K9, K10) sum each row farthest-first, so
//       only the last product of a row waits on the row just solved: the
//       chain from one row to the next is one multiply, one subtract and
//       the scale by 1/L_jj. Up to SMALL_BW one thread per right-hand side
//       keeps its last bw solution values in registers, with tiles of
//       rows copied by cp.async one tile ahead (band_fwd_far,
//       band_bwd_far); wider bands take a right-looking warp substitution,
//       one warp a right-hand side (band_solve_warp), whose warps share
//       one staged ring of L where a block holds several columns (K5's
//       draws). K5 is K3 on M columns, and K9/K10 run K2's and K3's code
//       at each system's offset.
//   K1's tail columns past its block (bgt_band_tail_solve) keep K1's
//       nearest-first order and cap, on their own kernels (band_tail_small
//       with the window in registers, band_tail_kernel with a shared ring).
// K4 runs once per gradient and keeps the generic form: threads across
// the bw entries of a row of H^{-1}, two barriers a row.
//
// Every shape the JAX package sends to its kernels runs here, those of
// its chunked kernels (K1c-K5c, band_kernels.py:466-634) included:
// bw <= 125 (BW_MAX in the wrapper), any tail width and any d. No buffer
// grows with d. K1's block holds the tail columns bgt_band_factor_tile
// allows (its threads and shared memory); the wrapper computes the
// others with bgt_band_tail_solve, a forward solve with K1's cap on |Y|
// that sums each column in K1's order.
//
// The batched kernels. The TPU packed NR systems side by side on the 128
// lanes because one system filled 6% of a vector; here a system is a
// thread block (K8, K11: blockIdx.x) or a row of the grid (K9, K10:
// blockIdx.y beside the right-hand-side tiles). Every kernel offsets its
// arrays to its system and runs the one-system code: the chain of one
// system is as long as before, but up to 132 of them run at once, and
// system r of a batched kernel agrees with the one-system kernel bit for
// bit.

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
constexpr int RHS_THREADS = 128;     // threads a block of the solves
constexpr int MAX_THREADS = 1024;    // threads a block may have
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 227 * 1024;  // dynamic shared memory a block
                                         // may have on sm_90

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
                                             int* __restrict__ flag,
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
    bool clamped = false;                 // lane 0: a pivot was clamped
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
                    clamped |= p < PIVOT_FLOOR;
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
    if (tid == 0) flag[0] = clamped;
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
                                  int* __restrict__ flag, int d, int q) {
    extern __shared__ double sm[];
    factor_small<BW>(band, C, L, rinv, Y, piv, hld, flag, d, q, sm);
}

// K8: block r factors system r; no tail (q = 0: C and Y are never read)
template <int BW>
__global__ void band_factor_batched_small(const double* __restrict__ bands,
                                          double* __restrict__ L,
                                          double* __restrict__ rinv,
                                          double* __restrict__ piv,
                                          double* __restrict__ hld,
                                          int* __restrict__ flag, int d) {
    extern __shared__ double sm[];
    const size_t r = blockIdx.x;
    const size_t ob = r * d * (BW + 1), od = r * d;
    factor_small<BW>(bands + ob, nullptr, L + ob, rinv + od, nullptr,
                     piv + od, hld + r, flag + r, d, 0, sm);
}

// --------------------------------------------------- K1, generic bw --
// Threads [0, W) compute the band entries L[j+o, j], threads [W, W+q)
// the tail row Y[j, c]; every thread computes the pivot itself.
__device__ __forceinline__ void factor_columns(
        const double* __restrict__ band, const double* __restrict__ C,
        double* __restrict__ L, double* __restrict__ rinv,
        double* __restrict__ Y, double* __restrict__ piv,
        double* __restrict__ hld, int* __restrict__ flag, int d, int bw,
        int q, double* sm) {
    const int W = bw + 1;
    double* Lw = sm;                  // [W][W] ring: last W columns of L
    double* Yw = Lw + W * W;          // [W][q] ring: last W rows of Y
    double* Bs = Yw + W * q;          // [STAGE][W] staged band rows
    double* Cs = Bs + STAGE * W;      // [STAGE][q] staged tail rows
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int yc = tid - W;           // tail column of this thread
    int slot = 0;                     // ring slot of column j
    bool clamped = false;             // thread 0: a pivot was clamped

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
            clamped |= p < PIVOT_FLOOR;
        }
        slot = ring_inc(slot, W);
        __syncthreads();
    }
    if (tid == 0) flag[0] = clamped;
    half_logdet(piv, hld, d);
}

__global__ void band_factor_kernel(const double* __restrict__ band,
                                   const double* __restrict__ C,
                                   double* __restrict__ L,
                                   double* __restrict__ rinv,
                                   double* __restrict__ Y,
                                   double* __restrict__ piv,
                                   double* __restrict__ hld,
                                   int* __restrict__ flag,
                                   int d, int bw, int q) {
    extern __shared__ double sm[];
    factor_columns(band, C, L, rinv, Y, piv, hld, flag, d, bw, q, sm);
}

__global__ void band_factor_batched_kernel(const double* __restrict__ bands,
                                           double* __restrict__ L,
                                           double* __restrict__ rinv,
                                           double* __restrict__ piv,
                                           double* __restrict__ hld,
                                           int* __restrict__ flag,
                                           int d, int bw) {
    extern __shared__ double sm[];
    const size_t r = blockIdx.x;
    const size_t ob = r * d * (bw + 1), od = r * d;
    factor_columns(bands + ob, nullptr, L + ob, rinv + od, nullptr,
                   piv + od, hld + r, flag + r, d, bw, 0, sm);
}

// ------------------------------------- K1's tail solve (K2 with a cap) --
// Y = L^{-1} C for the tail columns K1's block does not hold, each column
// as K1 computes it: its products subtracted nearest-first (K1's order)
// and |Y| capped at Y_CAP. One thread per column; the block stages STAGE
// rows of the multipliers, 1/L_jj and its right-hand sides at a time.
// bw <= SMALL_BW keeps the last BW solution values in registers, a wider
// band a shared-memory ring.
template <int BW>
__global__ void band_tail_small(const double* __restrict__ L,
                                const double* __restrict__ rinv,
                                const double* __restrict__ B,
                                double* __restrict__ X, int d, int r) {
    extern __shared__ double sm[];
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
            const double v = clip(acc * Rs[i], Y_CAP);
#pragma unroll
            for (int k = BW - 1; k > 0; --k) w[k] = w[k - 1];
            w[0] = v;
            X[(size_t)j * r + c] = v;
        }
    }
}

__global__ void band_tail_kernel(const double* __restrict__ L,
                                 const double* __restrict__ rinv,
                                 const double* __restrict__ B,
                                 double* __restrict__ X,
                                 int d, int bw, int r) {
    extern __shared__ double sm[];
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
            const double v = clip(acc * Rs[i], Y_CAP);
            win[slot * nt + tx] = v;
            X[(size_t)j * r + c] = v;
            slot = ring_inc(slot, W);
        }
    }
}


// ----------------------- K2, K3, K5, K9, K10, bw > SMALL_BW: warp substitution --
// One warp per right-hand-side column runs a right-looking substitution.
// Walked position p = 0..d-1 is row p of the forward solve (L x = b) and
// row d-1-p of the backward one (L^T x = b); in walked positions both
// are one recurrence,
//   x_p = acc_p * rinv_p,   acc_{p+o} -= M[p][o] * x_p   (o = 1..bw),
// with M[p][o] = L[j, o] (forward, j = p) or L[j-o, o] (backward,
// j = d-1-p). The window [p, p + P) of pending rows, P = 32 NS > bw,
// lives in registers: position p' in slot (p' / 32) % NS of lane p' % 32.
// At step p lane p % 32 forms x_p, a shuffle broadcasts it, and every
// lane subtracts its products from the rows of its slots that are 1..bw
// ahead; then the finished slot takes position p + P's right-hand side.
// So each row receives its products in the order the steps make them,
// the farthest (x_{p'-bw}) first, each rounded before it is subtracted,
// and the chain from x_{p-1} to x_p is one multiply, one shuffle, one
// multiply and one subtract; the other bw - 1 updates of a step are off
// it. The steps are unrolled over 4 tiles of 32, so every slot index and
// owner lane is a constant.
//
// The multipliers are staged into shared memory by cp.async, a tile of
// 32 walked positions at a time, several tiles ahead of the step. The
// forward solve's M[p] is row p of L: a tile is 32 contiguous rows, in
// a ring of WS_RING tiles. The backward solve's M[p][o] is L's diagonal
// entry L[j-o, o]; a diagonal gather reads a sector of memory an entry,
// so for bw < 64 the ring holds L's rows instead (WS_ROWS of them,
// copied contiguously) and each step reads M[p][o] where row j-o sits;
// for bw >= 64, whose rows would not fit, a tile is gathered. The rinv
// and right-hand-side entries a lane takes in a tile are loaded into
// registers one tile ahead, and lane u keeps x of the tile's step u for
// one store at the tile's end: a tile's 32 steps have no branch, so the
// compiler schedules across them.
//
// A block holds blockDim.x / 32 warps, one column each (K5's M draws,
// many right-hand sides): every column reads the same multipliers, so
// the warps share one ring, which all of the block's threads stage, and
// a barrier a tile keeps a slot from being restaged while a warp still
// reads it. blockIdx.y is the system of a batched launch (K9, K10): the
// arrays are offset to it and the code is the one-system code.
constexpr int WS_TILE = 32;              // walked positions a staged tile
constexpr int WS_RING = 4;               // tiles in a ring of tiles
constexpr int WS_ROWS = 256;             // rows in the backward row ring
// warps (right-hand sides) a block of the warp kernel holds: one for the
// few right-hand sides of the Newton and gradient solves, WS_WARPS for
// many (K5's draws), sharing one ring. A block of WS_WARPS warps keeps
// the register budget of one warp (255 a thread); at twice as many
// (2 WS_WARPS, timed only) a thread gets 128 and the kernel spills
constexpr int WS_WARPS = 8;

__device__ __forceinline__ unsigned smem_addr(const double* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// 8 bytes, or zeros without reading src where `keep` is false
__device__ __forceinline__ void cp_async8_or_zero(double* dst,
                                                  const double* src,
                                                  bool keep) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(keep ? 8 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy n doubles, thread tid of nth, 16 bytes a thread where both ends
// are aligned.
__device__ __forceinline__ void copy_async(double* dst, const double* src,
                                           int n, int tid, int nth) {
    if (((reinterpret_cast<size_t>(src) | smem_addr(dst)) & 15) == 0) {
        for (int e = 2 * tid; e + 1 < n; e += 2 * nth)
            cp_async16(dst + e, src + e);
        if ((n & 1) && tid == 0) cp_async8(dst + n - 1, src + n - 1);
    } else {
        for (int e = tid; e < n; e += nth) cp_async8(dst + e, src + e);
    }
}

// Start the copies of tile k's multipliers into `tile`, entry u W + o =
// M[32 k + u][o]. Forward: rows 32 k .. of L, one contiguous block.
// Backward: thread o - 1 (mod nth) gathers diagonal o, M[u][o] =
// L[j0 - u - o, o], zeros above row 0.
template <bool BWD>
__device__ __forceinline__ void stage_multipliers(
        const double* __restrict__ L, double* tile, int k, int d, int bw,
        int tid, int nth) {
    const int W = bw + 1;
    const int p0 = k * WS_TILE;
    const int rows = min(WS_TILE, d - p0);
    if (!BWD) {
        copy_async(tile, L + (size_t)p0 * W, rows * W, tid, nth);
    } else {
        const int j0 = d - 1 - p0;
        for (int o = 1 + tid; o <= bw; o += nth)
            for (int u = 0; u < rows; ++u) {
                const int i = j0 - u - o;    // row of L
                cp_async8_or_zero(tile + u * W + o,
                                  L + (size_t)max(i, 0) * W + o, i >= 0);
            }
    }
}

// The backward row ring: walked position q (row d-1-q of L) sits at ring
// row ~q & (WS_ROWS - 1), so a tile's 32 positions are 32 ascending ring
// rows holding 32 ascending rows of L: start their copy for tile k.
__device__ __forceinline__ void stage_rows(const double* __restrict__ L,
                                           double* ring, int k, int d,
                                           int bw, int tid, int nth) {
    const int W = bw + 1;
    const int jb = d - WS_TILE * (k + 1);     // row of position 32 k + 31
    const int r0 = max(jb, 0);
    const int slot = WS_ROWS - WS_TILE * (1 + k % (WS_ROWS / WS_TILE));
    copy_async(ring + (size_t)(slot + r0 - jb) * W, L + (size_t)r0 * W,
               (jb + WS_TILE - r0) * W, tid, nth);
}

template <int NS, bool BWD, int MAXW>
__global__ void __launch_bounds__(32 * MAXW)
band_solve_warp(const double* __restrict__ L,
                const double* __restrict__ rinv,
                const double* __restrict__ B, double* __restrict__ X,
                int d, int bw, int r) {
    extern __shared__ double sm[];       // the ring: NT tiles of W
    constexpr int P = 32 * NS;           // window of pending positions
    constexpr unsigned FULL = 0xffffffffu;
    // the backward solve reads a row ring while its rows fit; a step then
    // reads rows up to bw (< 64) positions ahead, in tiles k .. k + NEED
    constexpr bool ROWS = BWD && NS <= 2;
    constexpr int NT = ROWS ? WS_ROWS / WS_TILE : WS_RING;
    constexpr int NEED = ROWS ? 2 : 0;
    constexpr int AHEAD = NT - 1 - NEED / 2;  // tiles staged ahead of k
    const int W = bw + 1;
    const int tid = threadIdx.x, nth = blockDim.x;
    const int lane = tid & 31;
    const int c = blockIdx.x * (nth >> 5) + (tid >> 5);
    const bool real = c < r;             // a column past r only stages
    const size_t sys = blockIdx.y;
    L += sys * d * W;
    rinv += sys * d;
    B += sys * d * r;
    X += sys * d * r;
    const int ntiles = (d + WS_TILE - 1) / WS_TILE;
    // entry (row, c) of a (d, r) array for walked position p < d
    auto at = [&](int p) {
        return (size_t)(BWD ? d - 1 - p : p) * r + c;
    };
    auto rhs = [&](int p) { return real && p < d ? B[at(p)] : 0.0; };
    auto rec = [&](int p) {
        return p < d ? rinv[BWD ? d - 1 - p : p] : 0.0;
    };
    auto stage = [&](int k) {
        if (k < ntiles) {
            if (ROWS)
                stage_rows(L, sm, k, d, bw, tid, nth);
            else
                stage_multipliers<BWD>(L, sm + (k % NT) * WS_TILE * W, k,
                                       d, bw, tid, nth);
        }
        cp_async_commit();
    };
    for (int k = 0; k < AHEAD; ++k) stage(k);
    double acc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] = rhs(32 * s + lane);
    double rq = rec(lane), bq = rhs(lane + P);
    // whole tiles: the steps past d run on rows past d, which no real row
    // reads, and store nothing
    for (int k0 = 0; k0 < ntiles; k0 += 4) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const int k = k0 + t;
            if (k >= ntiles) break;
            cp_async_wait<AHEAD - 1 - NEED>();   // tiles to k + NEED
            __syncthreads();                     // landed, for every
            stage(k + AHEAD);                    // thread; tile k-1-NEED/2
            const double rc = rq, bc = bq;       // is free: restage it
            rq = rec((k + 1) * WS_TILE + lane);  // this tile's, then the
            bq = rhs((k + 1) * WS_TILE + lane + P);      // next's
            const double* Ms = sm + (k % NT) * WS_TILE * W;
            double xs = 0.0;                 // x of this tile's step lane
#pragma unroll
            for (int u = 0; u < WS_TILE; ++u) {
                // position 32 k + u sits in slot k % NS = t % NS of lane
                // u. No branch in a tile: the steps form one block the
                // compiler schedules across
                const bool own = lane == u;
                const double x = __shfl_sync(FULL, acc[t % NS] * rc, u);
                xs = own ? x : xs;
                acc[t % NS] = own ? bc : acc[t % NS];   // 32k+u+P enters
#pragma unroll
                for (int s = 0; s < NS; ++s) {
                    // offset of the position in slot s from 32 k + u
                    const int o = (32 * (s - t) + lane - u) & (P - 1);
                    const bool hit = o >= 1 && o <= bw;
                    const int oo = hit ? o : 0;
                    // ROWS: row j - oo of L, position 32 k + u + oo
                    const double m = ROWS
                        ? sm[(~(k * WS_TILE + u + oo) & (WS_ROWS - 1)) * W
                             + oo]
                        : Ms[u * W + oo];
                    const double a = acc[s] - m * x;
                    acc[s] = hit ? a : acc[s];
                }
            }
            if (real && k * WS_TILE + lane < d) X[at(k * WS_TILE + lane)] = xs;
        }
    }
    cp_async_wait<0>();
}

// ------------------------------------- K2, K3, K5, K9, K10, bw <= 8 --
// One thread per right-hand-side column with its last BW solution values
// in registers. A row's products are subtracted farthest-first (x_{j-BW}
// first, x_{j-1} or x_{j+1} last): all but the last use values found
// rows ago, so the chain from one row's x to the next's is one multiply,
// one subtract and the scale by 1/L_jj, and the other products of the
// row are made while the row before is solved. Tiles of `ft` rows (the
// multipliers, 1/L_jj and the block's right-hand sides) are copied by
// cp.async into one of two buffers while the other is solved: every
// thread starts the copy of tile k + 1 before tile k is solved, and the
// one barrier a tile comes after the copy has had a whole tile to land,
// so the solving thread never waits on memory. blockIdx.y is the system
// of a batched launch (K9, K10), as in band_solve_warp.
//
// Backward (L^T x = b, band_bwd_far): tile k holds rows [max(0, d - (k +
// 1) ft), d - k ft), and row j's multipliers L[j, t] are its own row;
// entries with j + t >= d are staged as zeros and the rows past d hold x
// = 0, so acc - 0 * 0 is acc and no row needs a bound check. Forward (L x
// = b, band_fwd_far): tile k holds rows [k ft, min(d, (k + 1) ft)) and
// row j's multipliers L[j - t, t] lie on diagonals of L, so the tile's
// buffer holds its rows of L together with the BW rows before them, and
// row j reads L[j - t, t] where row j - t sits; rows before 0 are staged
// as zeros, and x before row 0 is 0.
template <int BW>
__global__ void __launch_bounds__(RHS_THREADS)
band_bwd_far(const double* __restrict__ L, const double* __restrict__ rinv,
             const double* __restrict__ B, double* __restrict__ X, int d,
             int r, int ft) {
    constexpr int W = BW + 1;
    extern __shared__ double sm[];
    const int nt = blockDim.x, tx = threadIdx.x;
    const int c0 = blockIdx.x * nt;
    const int nc = min(nt, r - c0);      // this block's right-hand sides
    const int c = c0 + tx;
    const size_t sys = blockIdx.y;
    L += sys * d * W;
    rinv += sys * d;
    B += sys * d * r;
    X += sys * d * r;
    const int per = ft * (W + 1 + nt);   // doubles in one buffer
    const int ntiles = (d + ft - 1) / ft;
    auto stage = [&](int k) {
        if (k < ntiles) {
            double* Ls = sm + (k & 1) * per;
            double* Rs = Ls + ft * W;
            double* Bs = Rs + ft;
            const int j1 = d - k * ft, j0 = max(0, j1 - ft);
            const int rows = j1 - j0;
            if (k == 0) {                // L[j, t] with j + t >= d: zeros
                for (int i = tx; i < rows * W; i += nt)
                    cp_async8_or_zero(Ls + i, L + (size_t)j0 * W + i,
                                      j0 + i / W + i % W < d);
            } else {
                for (int i = tx; i < rows * W; i += nt)
                    cp_async8(Ls + i, L + (size_t)j0 * W + i);
            }
            for (int i = tx; i < rows; i += nt)
                cp_async8(Rs + i, rinv + j0 + i);
            if (nc == nt) {
                for (int i = 0; i < rows; ++i)
                    cp_async8(Bs + i * nt + tx, B + (size_t)(j0 + i) * r + c);
            } else {
                for (int e = tx; e < rows * nc; e += nt) {
                    const int i = e / nc, cc = e - i * nc;
                    cp_async8(Bs + i * nt + cc,
                              B + (size_t)(j0 + i) * r + c0 + cc);
                }
            }
        }
        cp_async_commit();
    };
    double w[BW];                        // X[j+1 .. j+BW]
#pragma unroll
    for (int k = 0; k < BW; ++k) w[k] = 0.0;
    stage(0);
    for (int k = 0; k < ntiles; ++k) {
        cp_async_wait<0>();              // tile k, this thread's copies
        __syncthreads();                 // every thread's; tile k - 1 done
        stage(k + 1);                    // into tile k - 1's buffer
        if (tx >= nc) continue;
        const double* Ls = sm + (k & 1) * per;
        const double* Rs = Ls + ft * W;
        const double* Bs = Rs + ft;
        const int j1 = d - k * ft, j0 = max(0, j1 - ft);
#pragma unroll 4
        for (int i = j1 - j0 - 1; i >= 0; --i) {
            const int j = j0 + i;
            const double* Lr = Ls + i * W;
            double acc = Bs[i * nt + tx];
#pragma unroll
            for (int t = BW; t >= 1; --t) acc -= Lr[t] * w[t - 1];
            const double v = acc * Rs[i];
#pragma unroll
            for (int t = BW - 1; t > 0; --t) w[t] = w[t - 1];
            w[0] = v;
            X[(size_t)j * r + c] = v;
        }
    }
    cp_async_wait<0>();
}

template <int BW>
__global__ void __launch_bounds__(RHS_THREADS)
band_fwd_far(const double* __restrict__ L, const double* __restrict__ rinv,
             const double* __restrict__ B, double* __restrict__ X, int d,
             int r, int ft) {
    constexpr int W = BW + 1;
    extern __shared__ double sm[];
    const int nt = blockDim.x, tx = threadIdx.x;
    const int c0 = blockIdx.x * nt;
    const int nc = min(nt, r - c0);      // this block's right-hand sides
    const int c = c0 + tx;
    const size_t sys = blockIdx.y;
    L += sys * d * W;
    rinv += sys * d;
    B += sys * d * r;
    X += sys * d * r;
    const int per = (ft + BW) * W + ft * (1 + nt);   // doubles a buffer
    const int ntiles = (d + ft - 1) / ft;
    auto stage = [&](int k) {
        if (k < ntiles) {
            double* Ls = sm + (k & 1) * per;     // rows j0 - BW .. j1 - 1
            double* Rs = Ls + (ft + BW) * W;
            double* Bs = Rs + ft;
            const int j0 = k * ft, j1 = min(d, j0 + ft);
            const int rows = j1 - j0;
            const int lo = j0 - BW;              // first staged row of L
            for (int i = tx; i < (rows + BW) * W; i += nt) {
                const bool keep = lo + i / W >= 0;
                cp_async8_or_zero(Ls + i,
                                  L + (keep ? (long)lo * W + i : 0L),
                                  keep);
            }
            for (int i = tx; i < rows; i += nt)
                cp_async8(Rs + i, rinv + j0 + i);
            if (nc == nt) {
                for (int i = 0; i < rows; ++i)
                    cp_async8(Bs + i * nt + tx, B + (size_t)(j0 + i) * r + c);
            } else {
                for (int e = tx; e < rows * nc; e += nt) {
                    const int i = e / nc, cc = e - i * nc;
                    cp_async8(Bs + i * nt + cc,
                              B + (size_t)(j0 + i) * r + c0 + cc);
                }
            }
        }
        cp_async_commit();
    };
    double w[BW];                        // X[j-1 .. j-BW]
#pragma unroll
    for (int k = 0; k < BW; ++k) w[k] = 0.0;
    stage(0);
    for (int k = 0; k < ntiles; ++k) {
        cp_async_wait<0>();              // tile k, this thread's copies
        __syncthreads();                 // every thread's; tile k - 1 done
        stage(k + 1);                    // into tile k - 1's buffer
        if (tx >= nc) continue;
        const double* Ls = sm + (k & 1) * per;
        const double* Rs = Ls + (ft + BW) * W;
        const double* Bs = Rs + ft;
        const int j0 = k * ft, rows = min(d, j0 + ft) - j0;
#pragma unroll 4
        for (int i = 0; i < rows; ++i) {
            double acc = Bs[i * nt + tx];
            // L[j - t, t] sits in staged row i + BW - t
#pragma unroll
            for (int t = BW; t >= 1; --t)
                acc -= Ls[(i + BW - t) * W + t] * w[t - 1];
            const double v = acc * Rs[i];
#pragma unroll
            for (int t = BW - 1; t > 0; --t) w[t] = w[t - 1];
            w[0] = v;
            X[(size_t)(j0 + i) * r + c] = v;
        }
    }
    cp_async_wait<0>();
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

// shared memory of K1's tail-solve kernels with nt threads a block:
// staged multipliers (STAGE x lw), 1/L_jj, right-hand sides, and the
// generic kernel's ring
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
                                double* piv, double* hld, int* flag, int d,
                                int q, cudaStream_t st) {
    const int nt = 32 + (q > 0 ? round_threads(q) : 0);
    band_factor_small<BW><<<1, nt, factor_small_smem(BW), st>>>(
        band, C, L, rinv, Y, piv, hld, flag, d, q);
    return cudaGetLastError();
}

template <int BW>
cudaError_t launch_factor_batched_small(const double* bands, double* L,
                                        double* rinv, double* piv,
                                        double* hld, int* flag, int nsys,
                                        int d, cudaStream_t st) {
    band_factor_batched_small<BW><<<nsys, 32, factor_small_smem(BW), st>>>(
        bands, L, rinv, piv, hld, flag, d);
    return cudaGetLastError();
}

// threads of a register-window solve block: one a right-hand side, whole
// warps
int rhs_threads(int r) {
    return r < RHS_THREADS ? round_threads(r) : RHS_THREADS;
}

int warp_block(int r) { return r <= 4 ? 1 : WS_WARPS; }

template <int BW>
cudaError_t launch_tail_small(const double* L, const double* rinv,
                              const double* C, double* Y, int d, int r,
                              cudaStream_t st) {
    const int grid = (r + RHS_THREADS - 1) / RHS_THREADS;
    band_tail_small<BW><<<grid, RHS_THREADS, rhs_smem(BW, 0), st>>>(
        L, rinv, C, Y, d, r);
    return cudaGetLastError();
}

// bw <= SMALL_BW: two tiles of ft rows, ft * nt = 4096 (ft <= 128)
template <int BW>
cudaError_t launch_far(bool bwd, const double* L, const double* rinv,
                       const double* B, double* X, int nsys, int d, int r,
                       cudaStream_t st) {
    const int nt = rhs_threads(r);
    const int ft = min(128, 4096 / nt);
    const dim3 grid((r + nt - 1) / nt, nsys);
    cudaError_t e;
    if (bwd) {
        const size_t smem = 2 * sizeof(double) * ft * (BW + 2 + nt);
        e = allow_smem(band_bwd_far<BW>, smem);
        if (e != cudaSuccess) return e;
        band_bwd_far<BW><<<grid, nt, smem, st>>>(L, rinv, B, X, d, r, ft);
    } else {
        const size_t smem = 2 * sizeof(double) *
            ((size_t)(ft + BW) * (BW + 1) + (size_t)ft * (1 + nt));
        e = allow_smem(band_fwd_far<BW>, smem);
        if (e != cudaSuccess) return e;
        band_fwd_far<BW><<<grid, nt, smem, st>>>(L, rinv, B, X, d, r, ft);
    }
    return cudaGetLastError();
}

using TailLaunch = cudaError_t (*)(const double*, const double*,
                                   const double*, double*, int, int,
                                   cudaStream_t);
using FarLaunch = cudaError_t (*)(bool, const double*, const double*,
                                  const double*, double*, int, int, int,
                                  cudaStream_t);
using FactorLaunch = cudaError_t (*)(const double*, const double*, double*,
                                     double*, double*, double*, double*,
                                     int*, int, int, cudaStream_t);
using FactorBatchedLaunch = cudaError_t (*)(const double*, double*, double*,
                                            double*, double*, int*, int, int,
                                            cudaStream_t);
// the register-window instantiations, indexed by bandwidth
const TailLaunch kTailSmall[SMALL_BW + 1] = {
    nullptr, launch_tail_small<1>, launch_tail_small<2>,
    launch_tail_small<3>, launch_tail_small<4>, launch_tail_small<5>,
    launch_tail_small<6>, launch_tail_small<7>, launch_tail_small<8>};
const FarLaunch kFar[SMALL_BW + 1] = {
    nullptr, launch_far<1>, launch_far<2>, launch_far<3>, launch_far<4>,
    launch_far<5>, launch_far<6>, launch_far<7>, launch_far<8>};
const FactorLaunch kFactorSmall[SMALL_BW + 1] = {
    nullptr, launch_factor_small<1>, launch_factor_small<2>,
    launch_factor_small<3>, launch_factor_small<4>, launch_factor_small<5>,
    launch_factor_small<6>, launch_factor_small<7>, launch_factor_small<8>};
const FactorBatchedLaunch kFactorBatchedSmall[SMALL_BW + 1] = {
    nullptr, launch_factor_batched_small<1>, launch_factor_batched_small<2>,
    launch_factor_batched_small<3>, launch_factor_batched_small<4>,
    launch_factor_batched_small<5>, launch_factor_batched_small<6>,
    launch_factor_batched_small<7>, launch_factor_batched_small<8>};

// K1's tail solve: Y = L^{-1} C with K1's order and cap
cudaError_t launch_tail(const double* L, const double* rinv, const double* C,
                        double* Y, int d, int bw, int r, cudaStream_t st) {
    if (bw >= 1 && bw <= SMALL_BW)
        return kTailSmall[bw](L, rinv, C, Y, d, r, st);
    const int grid = (r + RHS_THREADS - 1) / RHS_THREADS;
    const size_t smem = rhs_smem(bw, bw + 1);
    const cudaError_t e = allow_smem(band_tail_kernel, smem);
    if (e != cudaSuccess) return e;
    band_tail_kernel<<<grid, RHS_THREADS, smem, st>>>(L, rinv, C, Y, d, bw,
                                                      r);
    return cudaGetLastError();
}

template <int NS, bool BWD, int MAXW>
cudaError_t launch_solve_warp(const double* L, const double* rinv,
                              const double* B, double* X, int nsys, int d,
                              int bw, int r, int warps, cudaStream_t st) {
    const size_t rows = BWD && NS <= 2 ? WS_ROWS : WS_RING * WS_TILE;
    const size_t smem = sizeof(double) * rows * (size_t)(bw + 1);
    cudaError_t e = allow_smem(band_solve_warp<NS, BWD, MAXW>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((r + warps - 1) / warps, nsys);
    band_solve_warp<NS, BWD, MAXW><<<grid, 32 * warps, smem, st>>>(
        L, rinv, B, X, d, bw, r);
    return cudaGetLastError();
}

// the warp kernel for bw: one, two or four register slots a lane
template <bool BWD, int MAXW>
cudaError_t launch_warp(const double* L, const double* rinv, const double* B,
                        double* X, int nsys, int d, int bw, int r, int warps,
                        cudaStream_t st) {
    if (warps < 1 || warps > MAXW) return cudaErrorInvalidValue;
    if (bw < 32)
        return launch_solve_warp<1, BWD, MAXW>(L, rinv, B, X, nsys, d, bw,
                                               r, warps, st);
    if (bw < 64)
        return launch_solve_warp<2, BWD, MAXW>(L, rinv, B, X, nsys, d, bw,
                                               r, warps, st);
    if (bw < 128)
        return launch_solve_warp<4, BWD, MAXW>(L, rinv, B, X, nsys, d, bw,
                                               r, warps, st);
    return cudaErrorInvalidValue;
}

// Every solve but K1's tail, in one order (farthest-first): forward (K2,
// K9) or backward (K3, K5, K10), nsys systems of r right-hand sides,
// warp_block(r) of them a block of the warp kernel (bw > SMALL_BW)
template <bool BWD>
cudaError_t launch_solve(const double* L, const double* rinv,
                         const double* B, double* X, int nsys, int d,
                         int bw, int r, cudaStream_t st) {
    if (bw >= 1 && bw <= SMALL_BW)
        return kFar[bw](BWD, L, rinv, B, X, nsys, d, r, st);
    return launch_warp<BWD, WS_WARPS>(L, rinv, B, X, nsys, d, bw, r,
                                      warp_block(r), st);
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

// flag[0]: 1 where a raw pivot fell under PIVOT_FLOOR and was clamped
int bgt_band_factor(const double* band, const double* C, double* L,
                    double* rinv, double* Y, double* piv, double* hld,
                    int* flag, int d, int bw, int q, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    // a tail wider than the block takes would leave columns of Y unwritten
    if (q > bgt_band_factor_tile(bw, q)) return (int)cudaErrorInvalidValue;
    if (bw >= 1 && bw <= SMALL_BW)
        return (int)kFactorSmall[bw](band, C, L, rinv, Y, piv, hld, flag, d,
                                     q, st);
    const size_t smem = factor_smem(bw, q);
    cudaError_t e = allow_smem(band_factor_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    band_factor_kernel<<<1, round_threads(bw + 1 + q), smem, st>>>(
        band, C, L, rinv, Y, piv, hld, flag, d, bw, q);
    return (int)cudaGetLastError();
}

// Y = L^{-1} C for the tail columns beyond K1's tile, each column as K1
// computes it (its order, |Y| <= 1e8)
int bgt_band_tail_solve(const double* L, const double* rinv, const double* C,
                        double* Y, int d, int bw, int r, void* stream) {
    return (int)launch_tail(L, rinv, C, Y, d, bw, r, (cudaStream_t)stream);
}

int bgt_band_fwd_solve(const double* L, const double* rinv, const double* B,
                       double* X, int d, int bw, int r, void* stream) {
    return (int)launch_solve<false>(L, rinv, B, X, 1, d, bw, r,
                                    (cudaStream_t)stream);
}

int bgt_band_bwd_solve(const double* L, const double* rinv, const double* B,
                       double* X, int d, int bw, int r, void* stream) {
    return (int)launch_solve<true>(L, rinv, B, X, 1, d, bw, r,
                                   (cudaStream_t)stream);
}

// K5: K3's function and kernels on the M columns of the draws
int bgt_band_bwd_multi(const double* L, const double* rinv, const double* B,
                       double* X, int d, int bw, int r, void* stream) {
    return (int)launch_solve<true>(L, rinv, B, X, 1, d, bw, r,
                                   (cudaStream_t)stream);
}

// K5 for bw > SMALL_BW with `warps` draw columns a block of the warp
// kernel (1 .. 2 WS_WARPS), for timing the block shapes side by side
int bgt_band_bwd_multi_warps(const double* L, const double* rinv,
                             const double* B, double* X, int d, int bw,
                             int r, int warps, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (bw <= SMALL_BW) return (int)cudaErrorInvalidValue;
    if (warps <= WS_WARPS)
        return (int)launch_warp<true, WS_WARPS>(L, rinv, B, X, 1, d, bw, r,
                                                warps, st);
    return (int)launch_warp<true, 2 * WS_WARPS>(L, rinv, B, X, 1, d, bw, r,
                                                warps, st);
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
                            double* piv, double* hld, int* flag, int nsys,
                            int d, int bw, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (bw >= 1 && bw <= SMALL_BW)
        return (int)kFactorBatchedSmall[bw](bands, L, rinv, piv, hld, flag,
                                            nsys, d, st);
    const size_t smem = factor_smem(bw, 0);
    cudaError_t e = allow_smem(band_factor_batched_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    band_factor_batched_kernel<<<nsys, round_threads(bw + 1), smem, st>>>(
        bands, L, rinv, piv, hld, flag, d, bw);
    return (int)cudaGetLastError();
}

int bgt_band_fwd_solve_batched(const double* L, const double* rinv,
                               const double* B, double* X, int nsys, int d,
                               int bw, int r, void* stream) {
    return (int)launch_solve<false>(L, rinv, B, X, nsys, d, bw, r,
                                    (cudaStream_t)stream);
}

int bgt_band_bwd_solve_batched(const double* L, const double* rinv,
                               const double* B, double* X, int nsys, int d,
                               int bw, int r, void* stream) {
    return (int)launch_solve<true>(L, rinv, B, X, nsys, d, bw, r,
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
