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
// kernel sums in one order, farthest-first: a solve subtracts a row's
// products from the solution farthest back first, and the factor an
// entry's products from the column farthest back first, as a right-looking
// factor makes them; K1's tail Y = L^{-1} C is K2's solve with a cap.
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
//                   H^{-1} from L, the backward Takahashi recurrence,
//                   each sum farthest-first: two multiply-subtracts from
//                   one row's diagonal to the next).
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
//   K1  is right-looking at every width: step j scales column j and
//       subtracts its products from the columns after it, so pivot j+1
//       is final one product after step j (the chain from one pivot to
//       the next: a sqrt, a reciprocal, two multiplies, a subtract). For
//       bandwidths up to SMALL_BW (the IWP path has bw = p = 3) the
//       factor is compiled per bandwidth and one thread keeps the W
//       pending columns in registers, while warps 1.. compute the tail
//       rows of the previous chunk, one thread per tail column (factor_
//       small). Wider bands take factor_wide: a chain warp, bulk warps
//       that subtract the other products from a ring of pending columns
//       in shared memory, coupled by one named barrier a step, and tail warps
//       that solve for Y a tile behind (its comment). The log pivots are
//       taken by the whole block after the loop.
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
//   K1's tail columns past its block (bgt_band_tail_solve) run on K2's
//       kernels with |Y| capped at 1e8 (their template flag CAP).
//   K4 sums every entry farthest-first and takes Z[j, 1]'s product last
//       in Z[j, 0], so only Z[j, 1] reads the diagonal the row before
//       left. Up to SMALL_BW one thread keeps the symmetric window of
//       H^{-1} in registers, the row loop unrolled over BW rows so that
//       the window's shift is renaming, with tiles of L copied by
//       cp.async a tile ahead (band_takahashi_small); wider bands run a
//       skewed pipeline, entry (j, o) final o/2 steps ahead of row j's
//       diagonal, each step consuming only the entries the step before
//       made final: thread o (one to four warps) keeps its ~bw/2 entries
//       in progress in registers, one barrier a step
//       (band_takahashi_wide). K11 runs K4's code at each system's
//       offset.
//
// Every shape the JAX package sends to its kernels runs here, those of
// its chunked kernels (K1c-K5c, band_kernels.py:466-634) included:
// bw <= 125 (BW_MAX in the wrapper), any tail width and any d. No buffer
// grows with d. K1's block computes the tail columns bgt_band_factor_tile
// allows; the wrapper computes the others with bgt_band_tail_solve, K2's
// forward solve with K1's cap on |Y|, which sums each column as K1 does.
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
constexpr int MAX_TAIL_SMALL = 224;  // tail columns of the small K1 block
constexpr double PIVOT_FLOOR = 1e-12;
constexpr double L_CAP = 1e3;
constexpr double Y_CAP = 1e8;
constexpr int RHS_THREADS = 128;     // threads a block of the solves
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
// Right-looking, with the band window in registers. Lane 0 of warp 0 holds
// the columns j .. j+BW of the window, pend[b][o] = A[j+b+o, j+b] less the
// products of the columns before j. Step j scales column j and subtracts
// l_a l_b from entry (j+a, j+b) of the columns after it, so every entry
// takes its products in step order, the column farthest back first, and
// pivot j+1 is final once step j has subtracted l_1^2 from it: one
// product on the chain from one pivot to the next. Then the window moves
// a column; the column entering it comes from the raw band rows warp 0
// staged for the chunk. Warps 1.. compute the tail rows Y[j] = (C[j] -
// sum_t L[j, j-t] Y[j-t]) / L_jj of the previous chunk meanwhile, one
// thread per tail column, farthest-first (K2's order), from the
// multipliers lane 0 leaves for each row in a ring of three chunk buffers
// (step j writes L[j+t, j] for row j+t, which may lie in the next chunk);
// the log pivots are taken by the whole block after the loop.
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
    double* Bs = sm;                      // [STAGE][W] columns entering
    double* Ms = Bs + STAGE * W;          // [3][STAGE][BW] L[j, j-t] at t-1
    double* Rb = Ms + 3 * STAGE * BW;     // [3][STAGE] 1/L_jj
    const int tid = threadIdx.x;
    const int yc = tid - 32;              // tail column of warps 1..
    const int nchunks = (d + STAGE - 1) / STAGE;
    double pend[W][W];                    // lane 0: columns j .. j+BW
    double yw[BW];                        // tail threads: Y[j-1 .. j-BW]
    bool clamped = false;                 // lane 0: a pivot was clamped
#pragma unroll
    for (int k = 0; k < BW; ++k) yw[k] = 0.0;
    if (tid == 0) {
#pragma unroll
        for (int b = 0; b < W; ++b)
#pragma unroll
            for (int o = 0; o < W; ++o)
                pend[b][o] = b < d ? band[b * W + o] : 0.0;
    }
    for (int s = 0; s <= nchunks; ++s) {
        if (tid < 32 && s < nchunks) {
            const int j0 = s * STAGE;
            const int rows = min(STAGE, d - j0);
            // band rows j0 + W ..: the columns entering at steps j0 ..
            for (int i = tid; i < rows * W; i += 32)
                Bs[i] = j0 + W + i / W < d ? band[(size_t)(j0 + W) * W + i]
                                           : 0.0;
            __syncwarp();
            if (tid == 0) {
                // this chunk's buffers, and the next chunk's multipliers
                double* M0 = Ms + (s % 3) * STAGE * BW;
                double* M1 = Ms + ((s + 1) % 3) * STAGE * BW;
                double* Rbb = Rb + (s % 3) * STAGE;
                for (int i = 0; i < rows; ++i) {
                    const int j = j0 + i;
                    const double p = pend[0][0];
                    clamped |= p < PIVOT_FLOOR;
                    const double pv = clamp_pivot(p);
                    const double rs = __drcp_rn(sqrt(pv));   // = 1 / sqrt
                    double e[W];
                    e[0] = clip(pv * rs, L_CAP);
#pragma unroll
                    for (int o = 1; o <= BW; ++o)
                        e[o] = clip(j + o < d ? pend[0][o] * rs : 0.0, L_CAP);
#pragma unroll
                    for (int b = 1; b <= BW; ++b)
#pragma unroll
                        for (int o = 0; o + b <= BW; ++o)
                            pend[b][o] = pend[b][o] - e[b + o] * e[b];
#pragma unroll
                    for (int o = 0; o < W; ++o) L[(size_t)j * W + o] = e[o];
                    rinv[j] = rs;
                    piv[j] = pv;
                    if (q) {
                        Rbb[i] = rs;
#pragma unroll
                        for (int t = 1; t <= BW; ++t) {
                            if (i + t < STAGE)
                                M0[(i + t) * BW + t - 1] = e[t];
                            else
                                M1[(i + t - STAGE) * BW + t - 1] = e[t];
                        }
                    }
#pragma unroll
                    for (int b = 0; b < BW; ++b)
#pragma unroll
                        for (int o = 0; o < W; ++o) pend[b][o] = pend[b + 1][o];
#pragma unroll
                    for (int o = 0; o < W; ++o) pend[BW][o] = Bs[i * W + o];
                }
            }
        }
        if (yc >= 0 && yc < q && s >= 1) {
            const int j0 = (s - 1) * STAGE;
            const int rows = min(STAGE, d - j0);
            const double* Mb = Ms + ((s - 1) % 3) * STAGE * BW;
            const double* Rbb = Rb + ((s - 1) % 3) * STAGE;
#pragma unroll 4
            for (int i = 0; i < rows; ++i) {
                const int j = j0 + i;
                double acc = C[(size_t)j * q + yc];
#pragma unroll
                for (int t = BW; t >= 1; --t)
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
__global__ void __launch_bounds__(32 + MAX_TAIL_SMALL)
band_factor_small(const double* __restrict__ band,
                  const double* __restrict__ C, double* __restrict__ L,
                  double* __restrict__ rinv, double* __restrict__ Y,
                  double* __restrict__ piv, double* __restrict__ hld,
                  int* __restrict__ flag, int d, int q) {
    extern __shared__ double sm[];
    factor_small<BW>(band, C, L, rinv, Y, piv, hld, flag, d, q, sm);
}

// K8: block r factors system r; no tail (q = 0: C and Y are never read)
template <int BW>
__global__ void __launch_bounds__(32)
band_factor_batched_small(const double* __restrict__ bands,
                          double* __restrict__ L, double* __restrict__ rinv,
                          double* __restrict__ piv, double* __restrict__ hld,
                          int* __restrict__ flag, int d) {
    extern __shared__ double sm[];
    const size_t r = blockIdx.x;
    const size_t ob = r * d * (BW + 1), od = r * d;
    factor_small<BW>(bands + ob, nullptr, L + ob, rinv + od, nullptr,
                     piv + od, hld + r, flag + r, d, 0, sm);
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

template <int NS, bool BWD, int MAXW, bool CAP>
__global__ void __launch_bounds__(32 * MAXW)
band_solve_warp(const double* __restrict__ L,
                const double* __restrict__ rinv,
                const double* __restrict__ B, double* __restrict__ X,
                int d, int bw, int r,
                const unsigned char* __restrict__ gate) {
    // a gated solve (K1's re-solve) does nothing where the gate is 0
    if (gate != nullptr && *gate == 0) return;
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
                double x = __shfl_sync(FULL, acc[t % NS] * rc, u);
                if (CAP) x = clip(x, Y_CAP);    // K1's tail: |Y| <= 1e8
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

template <int BW, bool CAP>
__global__ void __launch_bounds__(RHS_THREADS)
band_fwd_far(const double* __restrict__ L, const double* __restrict__ rinv,
             const double* __restrict__ B, double* __restrict__ X, int d,
             int r, int ft, const unsigned char* __restrict__ gate) {
    if (gate != nullptr && *gate == 0) return;   // as in band_solve_warp
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
            const double v = CAP ? clip(acc * Rs[i], Y_CAP) : acc * Rs[i];
#pragma unroll
            for (int t = BW - 1; t > 0; --t) w[t] = w[t - 1];
            w[0] = v;
            X[(size_t)(j0 + i) * r + c] = v;
        }
    }
    cp_async_wait<0>();
}

// --------------------------------------------- K1, K8, bw > SMALL_BW --
// A right-looking factor with its warps specialized. Warp 0 (the chain)
// holds column j, final, and column j+1, short of step j's products only,
// in registers (lane o % 32 holds offset o). At step j it forms 1/L_jj and
// column j of L, l_o = A[j+o, j] / L_jj, publishes them in shared memory,
// and takes step j's products itself from the next two columns: l_{o+1}
// l_1 from column j+1 (now final: pivot j+1 is one product after step j)
// and l_{o+2} l_2 from column j+2, read from the window (the multipliers
// by shuffles). The chain from one pivot to the next is a sqrt, a
// reciprocal, two multiplies and a subtract. Warps 1..nb (the bulk)
// subtract step j's other products, l_a l_b from entry (j+a, j+b) for 3
// <= b <= a <= bw, in the window of pending columns, a ring of bw + 65
// columns in shared memory; a table lists those entries column by column,
// the bulk threads share it out, and each issues a batch of loads before
// any of its stores. Every entry so takes its products in step order,
// farthest-first, each rounded before it is subtracted. One named barrier
// a step couples the chain and the bulk: at step j the chain passes it
// once step j's multipliers are written, the bulk once it has finished
// step j-1; so the bulk's step j runs beside the chain's sqrt of step
// j+1, the chain reads column j+2 only after every product of the steps
// before j is in it, and two vectors of multipliers suffice. Every
// FG_TILE steps the block meets at __syncthreads, by which the bulk has
// staged the raw band rows the next tile brings into the window
// (cp.async). The tail warps (one per column of Y, at most FG_TAIL) run a
// tile behind, off the barriers: they copy the tile's rows of L and
// 1/L_jj, which the chain wrote to device memory, and solve L Y = C
// right-looking as K2's warp kernel does: lane o % 32 holds row j+o's
// running sum, step j forms Y[j] = sum / L_jj (capped at |Y| <= 1e8) and
// subtracts L[j+o, j] Y[j] from row j+o, so each row takes its products
// farthest-first. K8 runs the same code for system blockIdx.x, with no
// tail.
constexpr int FG_TILE = 32;          // steps between the block's barriers
constexpr int FG_TAIL = 4;           // tail columns a block computes
constexpr int FG_MAX_BULK = 6;       // bulk warps a block may have
constexpr int FG_BATCH = 8;          // entries a bulk thread loads at once

__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// 1 / sqrt(pv) as the plain versions form it, 1.0 / torch.sqrt(pv): both
// steps correctly rounded, so rcp.rn of the root equals the division
__device__ __forceinline__ double rsqrt_rn(double pv) {
    return __drcp_rn(sqrt(pv));
}

// columns in the window's ring, and entries (b, a), 3 <= b <= a <= bw,
// in the bulk's table
__host__ __device__ inline int fg_ring(int bw) { return bw + 1 + 2 * FG_TILE; }
__host__ __device__ inline int fg_entries(int bw) {
    return (bw - 2) * (bw - 1) / 2;
}

// shared memory of factor_wide in bytes: the ring, the multiplier vectors,
// the table (2 bytes an entry) and, with a tail, a tile of rows of L and
// their 1/L_jj
size_t fg_bytes(int bw, bool tail) {
    const size_t W = bw + 1;
    size_t n = (size_t)fg_ring(bw) * W + 2 * W + (fg_entries(bw) + 3) / 4;
    if (tail) n += FG_TILE * (W + 1);
    return n * sizeof(double);
}

// shared-memory load and store the compiler keeps in program order among
// themselves: a batch's loads go out together, ahead of its stores
__device__ __forceinline__ double lds_ordered(unsigned addr) {
    double v;
    asm volatile("ld.shared.f64 %0, [%1];\n" : "=d"(v) : "r"(addr));
    return v;
}

__device__ __forceinline__ void sts_ordered(unsigned addr, double v) {
    asm volatile("st.shared.f64 [%0], %1;\n" :: "r"(addr), "d"(v));
}

// Step j's products l_a l_b for the entries e = bt, bt + nbt, ... of the
// table (3 <= b <= a <= bw); the window's column j sits at sjW. A batch's
// FG_BATCH loads are issued together, before any of its stores.
__device__ __forceinline__ void fg_bulk_step(double* S, const double* lvb,
                                             const unsigned short* tab,
                                             int T3, int bw, int sjW, int RW,
                                             int bt, int nbt) {
    const unsigned s0 = smem_addr(S);
    for (int e0 = bt; e0 < T3; e0 += FG_BATCH * nbt) {
        unsigned ad[FG_BATCH];
        int ia[FG_BATCH], ib[FG_BATCH];
        double x[FG_BATCH];
#pragma unroll
        for (int u = 0; u < FG_BATCH; ++u) {
            const int t = tab[min(e0 + u * nbt, T3 - 1)];
            ib[u] = t >> 7;
            ia[u] = t & 127;
            const int o = sjW + ib[u] * bw + ia[u];
            ad[u] = s0 + 8u * (unsigned)(o >= RW ? o - RW : o);
        }
#pragma unroll
        for (int u = 0; u < FG_BATCH; ++u) x[u] = lds_ordered(ad[u]);
#pragma unroll
        for (int u = 0; u < FG_BATCH; ++u)
            x[u] = x[u] - lvb[ia[u]] * lvb[ib[u]];
#pragma unroll
        for (int u = 0; u < FG_BATCH; ++u)
            if (e0 + u * nbt < T3) sts_ordered(ad[u], x[u]);
    }
}

template <int NSL>
__device__ __forceinline__ void factor_wide(
        const double* __restrict__ band, const double* __restrict__ C,
        double* __restrict__ L, double* __restrict__ rinv,
        double* __restrict__ Y, double* __restrict__ piv,
        double* __restrict__ hld, int* __restrict__ flag, int d, int bw,
        int qf, int nb, double* sm) {
    constexpr unsigned FULL = 0xffffffffu;
    const int W = bw + 1, R = fg_ring(bw), RW = R * W, T3 = fg_entries(bw);
    double* S = sm;                          // [R][W] the window's columns
    double* lv = S + (size_t)RW;             // [2][W] multipliers
    unsigned short* tab = reinterpret_cast<unsigned short*>(lv + 2 * W);
    double* Ls = lv + 2 * W + (T3 + 3) / 4;  // tail: [FG_TILE][W] rows of L
    double* Rs = Ls + FG_TILE * W;           // [FG_TILE] their 1/L_jj
    const int tid = threadIdx.x, nt = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int ntiles = (d + FG_TILE - 1) / FG_TILE;
    const int n1 = 32 + 32 * nb;             // threads at the step barrier

    // the columns tile 0 reads (column c in slot c), and the table:
    // entry (b, a) as b << 7 | a, for b = 3 .. bw, a = b .. bw
    const int c1 = min(d, FG_TILE + bw);
    for (int e = tid; e < c1 * W; e += nt) S[e] = band[e];
    for (int b = 3 + tid; b <= bw; b += nt) {
        const int n = b - 3;
        const int start = n * (bw - 2) - n * (n - 1) / 2;
        for (int a = b; a <= bw; ++a)
            tab[start + a - b] = (unsigned short)((b << 7) | a);
    }
    __syncthreads();

    if (warp == 0) {
        // v[k]: offset lane + 32 k of column j, final; p, v1, v2 its
        // offsets 0, 1, 2 (every lane). vn[k]: column j+1, short of step
        // j's products only; pn its offset 0 (every lane). sj: column j's
        // ring slot
        double v[NSL], vn[NSL], l[NSL];
        bool clamped = false;
        int sj = 0, lb = 0;
#pragma unroll
        for (int k = 0; k < NSL; ++k) {
            const int o = lane + 32 * k;
            v[k] = o <= bw ? S[o] : 0.0;
            vn[k] = o <= bw ? S[W + o] : 0.0;
        }
        double p = S[0], v1 = S[1], v2 = S[2], pn = S[W];
        for (int s = 0; s <= ntiles; ++s) {
            const int jend = min(d, (s + 1) * FG_TILE);
            for (int j = s * FG_TILE; j < jend; ++j) {
                clamped |= p < PIVOT_FLOOR;
                const double pv = clamp_pivot(p);
                const double rs = rsqrt_rn(pv);
                double* lvb = lv + lb * W;
#pragma unroll
                for (int k = 0; k < NSL; ++k) {
                    const int o = lane + 32 * k;
                    const double x = o == 0 ? pv : v[k];
                    l[k] = clip(j + o < d ? x * rs : 0.0, L_CAP);
                    if (o <= bw) {
                        lvb[o] = l[k];
                        L[(size_t)j * W + o] = l[k];
                    }
                }
                const double l1 = clip(j + 1 < d ? v1 * rs : 0.0, L_CAP);
                const double l2 = clip(j + 2 < d ? v2 * rs : 0.0, L_CAP);
                if (lane == 0) {
                    rinv[j] = rs;
                    piv[j] = pv;
                }
                // step j's vector out; the bulk has finished step j-1, so
                // column j+2 holds every product of the steps before j
                bar_sync(1, n1);
                int s2 = sj + 2;
                if (s2 >= R) s2 -= R;
                const double* S2 = S + (size_t)s2 * W;
                double w[NSL];
#pragma unroll
                for (int k = 0; k < NSL; ++k) {
                    const int o = lane + 32 * k;
                    w[k] = o <= bw ? S2[o] : 0.0;
                }
                p = pn - l1 * l1;                 // pivot j+1
#pragma unroll
                for (int k = 0; k < NSL; ++k) {
                    // l_{o+1} and l_{o+2}: the next lanes', past lane 31
                    // the next slot's first
                    const int o = lane + 32 * k;
                    const double a1 = __shfl_sync(FULL, l[k], (lane + 1) & 31);
                    const double b1 =
                        k + 1 < NSL ? __shfl_sync(FULL, l[k + 1], 0) : 0.0;
                    const double a2 = __shfl_sync(FULL, l[k], (lane + 2) & 31);
                    const double b2 = k + 1 < NSL
                        ? __shfl_sync(FULL, l[k + 1], (lane + 2) & 31) : 0.0;
                    const double m1 = lane == 31 ? b1 : a1;
                    const double m2 = lane >= 30 ? b2 : a2;
                    // column j+1 takes step j's l_{o+1} l_1, column j+2
                    // its l_{o+2} l_2
                    v[k] = o < bw ? vn[k] - m1 * l1 : vn[k];
                    vn[k] = o + 1 < bw ? w[k] - m2 * l2 : w[k];
                }
                v1 = __shfl_sync(FULL, v[0], 1);
                v2 = __shfl_sync(FULL, v[0], 2);
                pn = __shfl_sync(FULL, vn[0], 0);
                sj = sj + 1 == R ? 0 : sj + 1;
                lb ^= 1;
            }
            __syncthreads();
        }
        if (lane == 0) flag[0] = clamped;
    } else if (warp <= nb) {
        // entry (j+a, j+b) sits at sjW + b bw + a in the ring, less RW
        // past its end (column j+b wrapped)
        const int bt = tid - 32, nbt = 32 * nb;
        int sjW = 0, lb = 0;
        for (int s = 0; s <= ntiles; ++s) {
            // stage the columns tile s+1 brings into the window
            const int c0 = (s + 1) * FG_TILE + bw;
            const int ce = min(d, c0 + FG_TILE);
            if (c0 < ce) {
                const int s0 = c0 % R, n0 = min(ce - c0, R - s0);
                copy_async(S + (size_t)s0 * W, band + (size_t)c0 * W, n0 * W,
                           bt, nbt);
                if (n0 < ce - c0)
                    copy_async(S, band + (size_t)(c0 + n0) * W,
                               (ce - c0 - n0) * W, bt, nbt);
            }
            cp_async_commit();
            const int jend = min(d, (s + 1) * FG_TILE);
            for (int j = s * FG_TILE; j < jend; ++j) {
                bar_sync(1, n1);                  // step j's vector
                fg_bulk_step(S, lv + lb * W, tab, T3, bw, sjW, RW, bt, nbt);
                sjW += W;
                if (sjW == RW) sjW = 0;
                lb ^= 1;
            }
            cp_async_wait<0>();
            __syncthreads();
        }
    } else {
        // tail column c, a tile behind the factor: lane t, slot k holds
        // row j + o's running sum (o = t + 32 k), less the products of
        // the rows before j
        const int c = warp - 1 - nb;
        const int tt = tid - 32 * (1 + nb), ntt = 32 * qf;
        double acc[NSL];
#pragma unroll
        for (int k = 0; k < NSL; ++k) {
            const int o = lane + 32 * k;
            acc[k] = o <= bw && o < d ? C[(size_t)o * qf + c] : 0.0;
        }
        for (int s = 0; s <= ntiles; ++s) {
            if (s >= 1) {
                const int j0 = (s - 1) * FG_TILE;
                const int rows = min(FG_TILE, d - j0);
                // the tile's rows of L and 1/L_jj (device memory, from L2)
                // and the rows of C entering the window at its steps
                for (int e = tt; e < rows * W; e += ntt)
                    Ls[e] = __ldcg(L + (size_t)j0 * W + e);
                for (int e = tt; e < rows; e += ntt)
                    Rs[e] = __ldcg(rinv + j0 + e);
                const int re = j0 + W + lane;
                const double cin = re < d ? C[(size_t)re * qf + c] : 0.0;
                bar_sync(3, ntt);
                for (int i = 0; i < rows; ++i) {
                    const double x =
                        clip(__shfl_sync(FULL, acc[0] * Rs[i], 0), Y_CAP);
                    if (lane == 0) Y[(size_t)(j0 + i) * qf + c] = x;
                    const double enter = __shfl_sync(FULL, cin, i);
                    const double* Li = Ls + i * W;
#pragma unroll
                    for (int k = 0; k < NSL; ++k) {
                        const int o = lane + 32 * k;
                        if (o >= 1 && o <= bw) acc[k] = acc[k] - Li[o] * x;
                    }
                    // the window moves a row: offset o takes o + 1's sum,
                    // and row j + W enters at offset bw
#pragma unroll
                    for (int k = 0; k < NSL; ++k) {
                        const double nx =
                            __shfl_sync(FULL, acc[k], (lane + 1) & 31);
                        const double ny = k + 1 < NSL
                            ? __shfl_sync(FULL, acc[k + 1], 0) : 0.0;
                        const int o = lane + 32 * k;
                        acc[k] = o == bw ? enter : (lane == 31 ? ny : nx);
                    }
                }
                bar_sync(3, ntt);                 // Ls, Rs restaged next
            }
            __syncthreads();
        }
    }
    half_logdet(piv, hld, d);
}

template <int NSL>
__global__ void __launch_bounds__(32 * (1 + FG_MAX_BULK + FG_TAIL), 1)
band_factor_wide(const double* __restrict__ band,
                 const double* __restrict__ C, double* __restrict__ L,
                 double* __restrict__ rinv, double* __restrict__ Y,
                 double* __restrict__ piv, double* __restrict__ hld,
                 int* __restrict__ flag, int d, int bw, int qf, int nb) {
    extern __shared__ double sm[];
    factor_wide<NSL>(band, C, L, rinv, Y, piv, hld, flag, d, bw, qf, nb,
                     sm);
}

// K8: block r factors system r
template <int NSL>
__global__ void __launch_bounds__(32 * (1 + FG_MAX_BULK + FG_TAIL), 1)
band_factor_wide_batched(const double* __restrict__ bands,
                         double* __restrict__ L, double* __restrict__ rinv,
                         double* __restrict__ piv, double* __restrict__ hld,
                         int* __restrict__ flag, int d, int bw, int nb) {
    extern __shared__ double sm[];
    const size_t r = blockIdx.x;
    const size_t ob = r * d * (bw + 1), od = r * d;
    factor_wide<NSL>(bands + ob, nullptr, L + ob, rinv + od, nullptr,
                     piv + od, hld + r, flag + r, d, bw, 0, nb, sm);
}

// ---------------------------------------------------------------- K4 --
// Z[j, o] = (H^{-1})[j+o, j] by the backward recurrence, with S the
// symmetric selected inverse of the rows after j and l_t = L[j+t, j] /
// L_jj (0 where j + t >= d):
//   Z[j, o] = 0 - l_bw S(j+bw, j+o) - ... - l_1 S(j+1, j+o)   (o = 1..bw)
//   Z[j, 0] = 1/L_jj^2 - l_bw Z[j, bw] - ... - l_1 Z[j, 1]
// Every sum runs farthest-first, t = bw down to 1. For o >= 2 the
// products before the last read rows j+2.. and the off-diagonal entries
// of row j+1; only Z[j, 1]'s last product reads row j+1's diagonal, and
// Z[j, 0] takes Z[j, 1]'s product last. So the chain from one row's
// diagonal to the next is two multiply-subtracts: Z[j+1, 0] -> Z[j, 1]
// -> Z[j, 0].
//
// bw <= SMALL_BW (band_takahashi_small): lane 0 of one warp holds the
// window S(x, y), x >= y, of rows j+1..j+BW in registers, win[x % BW][y %
// BW]; the row loop is unrolled over BW rows, so every index is a
// constant, row j's entries replace those of row j+BW in place, and the
// window's shift is register renaming. Tiles of rows of L and 1/L_jj
// arrive by cp.async one tile ahead, rows of Z leave through a shared
// tile in coalesced stores by the whole warp; no barrier a row.
constexpr int TK_ROWS = 64;          // least rows a tile of the small kernel

template <int BW>
__global__ void __launch_bounds__(32)
band_takahashi_small(const double* __restrict__ L,
                     const double* __restrict__ rinv,
                     double* __restrict__ Z, int d) {
    constexpr int W = BW + 1;
    constexpr int G = BW > 0 ? BW : 1;               // rows a step
    constexpr int TT = G * ((TK_ROWS + G - 1) / G);  // rows a tile
    constexpr int PER = TT * W + TT;     // a staged tile: L, then 1/L_jj
    extern __shared__ double sm[];
    double* Zs = sm + 2 * PER;           // [TT][W] the tile's rows of Z
    const int lane = threadIdx.x;
    const size_t sys = blockIdx.x;       // K11: system blockIdx.x
    L += sys * d * W;
    rinv += sys * d;
    Z += sys * d * W;
    // tile k: rows [k TT, min(d, (k+1) TT)), in buffer k & 1
    auto stage = [&](int k) {
        if (k >= 0) {
            double* Ls = sm + (k & 1) * PER;
            const int j0 = k * TT, rows = min(TT, d - j0);
            copy_async(Ls, L + (size_t)j0 * W, rows * W, lane, 32);
            copy_async(Ls + TT * W, rinv + j0, rows, lane, 32);
        }
        cp_async_commit();
    };
    double win[G][G];
#pragma unroll
    for (int a = 0; a < G; ++a)
#pragma unroll
        for (int b = 0; b < G; ++b) win[a][b] = 0.0;
    const int ntiles = (d + TT - 1) / TT;
    // steps of G rows from the first whole step past d; rows past d are
    // zero rows (1/L_jj = 0), as the plain version's start
    const int jend = (d + G - 1) / G * G;
    stage(ntiles - 1);
    for (int k = ntiles - 1; k >= 0; --k) {
        cp_async_wait<0>();              // tile k, this lane's copies
        __syncwarp();                    // every lane's; Zs stored
        stage(k - 1);
        const int j0 = k * TT;
        if (lane == 0) {
            const double* Ls = sm + (k & 1) * PER;
            const double* Rs = Ls + TT * W;
            for (int g = min(j0 + TT, jend) - G; g >= j0; g -= G) {
#pragma unroll
                for (int u = G - 1; u >= 0; --u) {
                    const int j = g + u;         // j % G == u
                    const int i = j - j0;
                    const double r = j < d ? Rs[i] : 0.0;
                    double l[W], z[W];
#pragma unroll
                    for (int t = 1; t <= BW; ++t)
                        l[t] = j + t < d ? Ls[i * W + t] * r : 0.0;
#pragma unroll
                    for (int o = 1; o <= BW; ++o) {
                        double acc = 0.0;
#pragma unroll
                        for (int t = BW; t >= 1; --t) {
                            const int hi = t > o ? t : o, lo = t > o ? o : t;
                            acc = acc - l[t] * win[(u + hi) % G][(u + lo) % G];
                        }
                        z[o] = acc;
                    }
                    double z0 = r * r;
#pragma unroll
                    for (int t = BW; t >= 1; --t) z0 = z0 - l[t] * z[t];
                    z[0] = z0;
                    // S(j+c, j) replaces S(j+BW, ...), which leaves
#pragma unroll
                    for (int c = 0; c < BW; ++c) win[(u + c) % G][u] = z[c];
                    if (j < d) {
#pragma unroll
                        for (int o = 0; o < W; ++o) Zs[i * W + o] = z[o];
                    }
                }
            }
        }
        __syncwarp();
        const int rows = min(TT, d - j0);
        for (int e = lane; e < rows * W; e += 32)
            Z[(size_t)j0 * W + e] = Zs[e];
    }
    cp_async_wait<0>();
}

// bw > SMALL_BW (band_takahashi_wide): a skewed pipeline. Entry (i, k)
// of row i = d - 1 - P is final at step P - k/2 (k/2 rounded down), and
// its product t is subtracted at the step after its operand S(i+t, i+k),
// the entry of offset |t - k|, became final: every operand was made final
// in the step before, and each entry takes its products farthest-first,
// two a step over about bw/2 steps. Thread k owns offset k (warp 0 lanes
// 0..30 offsets 0..30; warp w >= 1 lane l offset 32 w - 1 + l, so that
// offsets 2m+1 and 2m+2 share a warp) and keeps its entries in progress
// in registers, acc[lag] for NL lags (NL = (bw + 1) / 2 rounded up to a
// multiple of 4; the lags past (bw + 1) / 2 hold 0, or 1/L_ii^2 for k = 0,
// and take products of zero multipliers, which change no bit). At each
// step lag lag takes products t = 2 lag + 3 - (k & 1) and t - 1: the
// multipliers l_t of its row from a ring of multiplier rows, the operands
// from F, the entries made final in the step before, one per offset,
// mirrored (F[-a] = F[a]) so that every address is a per-thread base and
// a constant, and double-buffered by step parity. The entry at lag 0 is
// then final, but for even k, whose last product (t = 1) takes the entry
// thread k - 1 (k = 0: thread 1) made final in this step, by a shuffle. So
// the chain a step is an odd offset's two multiply-subtracts, a shuffle
// and an even offset's multiply-subtract, then one barrier (a __syncwarp
// up to bw = 30); the ~bw products of a thread a step belong to NL
// independent entries, in straight-line code. Multiplier rows (entry t of
// the row at position p: l_t, 0 past d and past bw; entry 0: 1/L_ii^2)
// are formed a tile at a time (TS = 16 or 32 positions) a tile ahead,
// from rows of L staged by
// cp.async another tile ahead. Steps start OFF positions early on zero
// rows (rows past d), so the first real entries meet the same schedule as
// every other. The entries made final leave through a shared tile, written
// to Z at the tile's end: no store to device memory inside a step.
constexpr int TW_GROUP = 4;          // lags whose operands load together
constexpr int TW_MAX_WARPS = 4;      // offsets 0..125

// the lags a thread keeps for bw: (bw + 1) / 2 rounded up to 4
__host__ __device__ inline int tw_lags(int bw) {
    return 4 * (((bw + 1) / 2 + 3) / 4);
}
// multiplier-row pitch for NL lags: >= 2 NL + 3 (products up to t = 2 NL
// + 2 read zeros) and 2 mod 16, so that the 16 rows a half-warp reads lie
// in distinct banks
__host__ __device__ constexpr int tw_pitch(int nl) {
    return 16 * ((2 * nl + 16) / 16) + 2;
}
// positions a tile of multiplier rows (and steps between the block's
// barriers), as long as the tiles fit beside the ring
__host__ __device__ constexpr int tw_tile(int nl) { return nl <= 32 ? 32 : 16; }
// tiles of multiplier rows ahead of a step's: a step reads positions up
// to 2 NL ahead; the ring holds one more
__host__ __device__ constexpr int tw_ahead(int nl) {
    return (2 * nl + tw_tile(nl) - 1) / tw_tile(nl);
}
__host__ __device__ inline int tw_warps(int bw) {
    return bw <= 30 ? 1 : 1 + (bw - 30 + 31) / 32;
}

// shared memory of the wide kernel in bytes: the ring of multiplier rows,
// the two mirrored F, a staged tile of rows of L and their 1/L_jj, and a
// tile of the entries made final (TS steps, bw + 1 offsets)
size_t takahashi_wide_bytes(int bw) {
    const int nl = tw_lags(bw);
    const size_t PL = tw_pitch(nl), TS = tw_tile(nl);
    const size_t RL = (tw_ahead(nl) + 1) * TS;
    return sizeof(double) * (RL * PL + 2 * (2 * PL + 1) + TS * (2 * bw + 3));
}

template <int NL>
__device__ __forceinline__ void takahashi_wide(
        const double* __restrict__ L, const double* __restrict__ rinv,
        double* __restrict__ Z, int d, int bw, double* sm) {
    constexpr unsigned FULL = 0xffffffffu;
    constexpr int PL = tw_pitch(NL), K = tw_ahead(NL), TS = tw_tile(NL);
    constexpr int RL = (K + 1) * TS, OFF = K * TS;            // >= 2 NL
    constexpr int FL = 2 * PL + 1;           // a mirrored F, centre PL
    const int W = bw + 1;
    double* LR = sm;                         // [RL][PL] multiplier rows
    double* F = LR + RL * PL;                // [2][FL] entries made final
    double* Lt = F + 2 * FL;                 // [TS][W] rows of L
    double* Rt = Lt + TS * W;                // [TS] their 1/L_jj
    double* Zt = Rt + TS;                    // [TS][W] made final
    const int tid = threadIdx.x, nt = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int k0 = warp == 0 ? lane : 32 * warp - 1 + lane;
    const bool act = k0 <= bw && !(warp == 0 && lane == 31);
    const int k = act ? k0 : bw;             // idle lanes repeat offset bw
    const int pi = k & 1, hk = k >> 1;
    const int src = warp == 0 && lane == 0 ? 1 : max(lane - 1, 0);
    // rows [i0, i1) of the positions [m TS, (m+1) TS)
    auto rows = [&](int m, int& i0, int& i1) {
        const int ih = d - 1 + OFF - m * TS;
        i1 = min(d, ih + 1);
        i0 = max(0, ih - TS + 1);
    };
    auto stage = [&](int m) {
        int i0, i1;
        rows(m, i0, i1);
        if (i0 < i1) {
            copy_async(Lt, L + (size_t)i0 * W, (i1 - i0) * W, tid, nt);
            copy_async(Rt, rinv + i0, i1 - i0, tid, nt);
        }
        cp_async_commit();
    };
    // thread c forms column c of the tile's rows, all loads first
    auto build = [&](int m) {
        int i0, i1;
        rows(m, i0, i1);
        double* R0 = LR + (m % (K + 1)) * TS * PL;
        const int ih = d - 1 + OFF - m * TS;
        for (int c = tid; c < PL; c += nt) {
            double r[TS], x[TS];
#pragma unroll
            for (int u = 0; u < TS; ++u) {
                const int i = ih - u;
                const int ii = i >= i0 && i < i1 ? i - i0 : 0;
                r[u] = Rt[ii];
                x[u] = Lt[ii * W + min(c, bw)];
            }
#pragma unroll
            for (int u = 0; u < TS; ++u) {
                const int i = ih - u;
                const bool real = i >= i0 && i < i1;
                const bool in = c >= 1 && c <= bw && i + c < d;
                const double v = c == 0 ? r[u] * r[u] : x[u] * r[u];
                R0[u * PL + c] = real && (c == 0 || in) ? v : 0.0;
            }
        }
    };
    // the tile's entries made final at steps s0 .. s0 + n - 1 to Z: step
    // u's entry of offset k is row d - 1 + OFF - (s0 + u) - k/2's
    auto flush = [&](int s0, int n) {
        if (tid < W) {
            double v[TS];
#pragma unroll
            for (int u = 0; u < TS; ++u) v[u] = Zt[u * W + tid];
#pragma unroll
            for (int u = 0; u < TS; ++u) {
                const int i = d - 1 + OFF - s0 - u - (tid >> 1);
                if (u < n && i >= 0 && i < d) Z[(size_t)i * W + tid] = v[u];
            }
        }
    };
    for (int e = tid; e < 2 * FL; e += nt) F[e] = 0.0;
    for (int m = 0; m <= K; ++m) {
        stage(m);
        cp_async_wait<0>();
        __syncthreads();
        build(m);
        __syncthreads();
    }
    stage(K + 1);
    double acc[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) acc[l] = 0.0;
    const unsigned ls = smem_addr(LR), fs = smem_addr(F);
    int b = hk % RL;                         // ring row of position s + hk
    const int send = d + OFF;                // steps 0 .. send - 1
    for (int s0 = 0; s0 < send; s0 += TS) {
        if (s0 > 0) {
            cp_async_wait<0>();              // rows of tile s0/TS + K
            __syncthreads();                 // landed; its ring rows free
            flush(s0 - TS, TS);
            build(s0 / TS + K);
            __syncthreads();
            stage(s0 / TS + K + 1);
        }
        const int se = min(send, s0 + TS);
        for (int s = s0; s < se; ++s) {
            // F[t - k] for t = 2 lag + 3 - pi at fb + 16 lag (bytes)
            const unsigned fb =
                fs + 8u * (((s + 1) & 1) * FL + PL + 3 - pi - k);
            double* fc = F + (s & 1) * FL + PL;
            // l_t of lag 0's row at off (doubles); the next lag's row PL
            // on, wrapped without a branch (a lane's wrap is its own)
            unsigned off = b * PL + 3 - pi;
            const double l1 = LR[b * PL + 1];
            // the operands of four lags at a time, loaded in order (one
            // group ahead of its products) so that no product waits on
            // the load just before it
            double qa[2][TW_GROUP], qb[2][TW_GROUP];
            double fa[2][TW_GROUP], fm[2][TW_GROUP];
            auto load = [&](int g, int h) {
#pragma unroll
                for (int u = 0; u < TW_GROUP; ++u) {
                    const unsigned l = g * TW_GROUP + u;
                    const unsigned q = ls + 8u * (off + 2 * l);
                    qa[h][u] = lds_ordered(q);
                    qb[h][u] = lds_ordered(q - 8u);
                    fa[h][u] = lds_ordered(fb + 16u * l);
                    fm[h][u] = lds_ordered(fb + 16u * l - 8u);
                    off = min(off + PL, off + PL - RL * PL);
                }
            };
            load(0, 0);
#pragma unroll
            for (int g = 0; g < NL / TW_GROUP; ++g) {
                if (g + 1 < NL / TW_GROUP) load(g + 1, (g + 1) & 1);
#pragma unroll
                for (int u = 0; u < TW_GROUP; ++u) {
                    const int l = g * TW_GROUP + u;
                    acc[l] = acc[l] - qa[g & 1][u] * fa[g & 1][u];
                    acc[l] = acc[l] - qb[g & 1][u] * fm[g & 1][u];
                }
                if (g == 0) {
                    // lag 0 is final for odd k; even k takes t = 1 last,
                    // with the entry offset k - 1 (k = 0: offset 1) made
                    // final just now; beside the other lags' products
                    const double got = __shfl_sync(FULL, acc[0], src);
                    const double z = pi ? acc[0] : acc[0] - l1 * got;
                    if (act) {
                        fc[k] = z;
                        fc[-k] = z;
                        Zt[(s - s0) * W + k] = z;
                    }
                }
            }
            // the lags move down; position s + 1 + NL enters (k = 0:
            // at 1/L_ii^2)
            int se1 = b + NL;
            if (se1 >= RL) se1 -= RL;
            const double enter = k == 0 ? LR[se1 * PL] : 0.0;
#pragma unroll
            for (int l = 0; l + 1 < NL; ++l) acc[l] = acc[l + 1];
            acc[NL - 1] = enter;
            b = b + 1 == RL ? 0 : b + 1;
            // ordered with the ordered loads: asm, with a memory clobber
            if (nt == 32)
                asm volatile("bar.warp.sync -1;\n" ::: "memory");
            else
                bar_sync(0, nt);
        }
    }
    __syncthreads();
    const int last = (send - 1) / TS * TS;
    flush(last, send - last);
    cp_async_wait<0>();
}

// K4 and K11: block r takes system r
template <int NL>
__global__ void __launch_bounds__(32 * TW_MAX_WARPS)
band_takahashi_wide(const double* __restrict__ L,
                    const double* __restrict__ rinv, double* __restrict__ Z,
                    int d, int bw) {
    extern __shared__ double sm[];
    const size_t r = blockIdx.x;
    const size_t ob = r * d * (bw + 1);
    takahashi_wide<NL>(L + ob, rinv + r * d, Z + ob, d, bw, sm);
}

template <int NL>
cudaError_t launch_takahashi_wide(const double* L, const double* rinv,
                                  double* Z, int nsys, int d, int bw,
                                  cudaStream_t st) {
    const size_t smem = takahashi_wide_bytes(bw);
    cudaError_t e = allow_smem(band_takahashi_wide<NL>, smem);
    if (e != cudaSuccess) return e;
    band_takahashi_wide<NL><<<nsys, 32 * tw_warps(bw), smem, st>>>(
        L, rinv, Z, d, bw);
    return cudaGetLastError();
}

using TakahashiWideLaunch = cudaError_t (*)(const double*, const double*,
                                            double*, int, int, int,
                                            cudaStream_t);
// by tw_lags(bw) / 4 - 2: bw = 9..125
const TakahashiWideLaunch kTakahashiWide[15] = {
    launch_takahashi_wide<8>, launch_takahashi_wide<12>,
    launch_takahashi_wide<16>, launch_takahashi_wide<20>,
    launch_takahashi_wide<24>, launch_takahashi_wide<28>,
    launch_takahashi_wide<32>, launch_takahashi_wide<36>,
    launch_takahashi_wide<40>, launch_takahashi_wide<44>,
    launch_takahashi_wide<48>, launch_takahashi_wide<52>,
    launch_takahashi_wide<56>, launch_takahashi_wide<60>,
    launch_takahashi_wide<64>};

size_t factor_small_smem(int bw) {
    return sizeof(double) *
        ((size_t)STAGE * (bw + 1) + 3 * (size_t)STAGE * bw + 3 * STAGE);
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

// bw <= SMALL_BW: two tiles of ft rows, ft * nt = 4096 (ft <= 128)
template <int BW, bool CAP>
cudaError_t launch_far(bool bwd, const double* L, const double* rinv,
                       const double* B, double* X, int nsys, int d, int r,
                       cudaStream_t st, const unsigned char* gate) {
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
        e = allow_smem(band_fwd_far<BW, CAP>, smem);
        if (e != cudaSuccess) return e;
        band_fwd_far<BW, CAP><<<grid, nt, smem, st>>>(L, rinv, B, X, d, r,
                                                      ft, gate);
    }
    return cudaGetLastError();
}

using FarLaunch = cudaError_t (*)(bool, const double*, const double*,
                                  const double*, double*, int, int, int,
                                  cudaStream_t, const unsigned char*);
using FactorLaunch = cudaError_t (*)(const double*, const double*, double*,
                                     double*, double*, double*, double*,
                                     int*, int, int, cudaStream_t);
using FactorBatchedLaunch = cudaError_t (*)(const double*, double*, double*,
                                            double*, double*, int*, int, int,
                                            cudaStream_t);
// the register-window instantiations, indexed by bandwidth; kFarCap
// caps |x| at Y_CAP (K1's tail solve, forward only)
const FarLaunch kFar[SMALL_BW + 1] = {
    nullptr, launch_far<1, false>, launch_far<2, false>,
    launch_far<3, false>, launch_far<4, false>, launch_far<5, false>,
    launch_far<6, false>, launch_far<7, false>, launch_far<8, false>};
const FarLaunch kFarCap[SMALL_BW + 1] = {
    nullptr, launch_far<1, true>, launch_far<2, true>, launch_far<3, true>,
    launch_far<4, true>, launch_far<5, true>, launch_far<6, true>,
    launch_far<7, true>, launch_far<8, true>};
const FactorLaunch kFactorSmall[SMALL_BW + 1] = {
    nullptr, launch_factor_small<1>, launch_factor_small<2>,
    launch_factor_small<3>, launch_factor_small<4>, launch_factor_small<5>,
    launch_factor_small<6>, launch_factor_small<7>, launch_factor_small<8>};
const FactorBatchedLaunch kFactorBatchedSmall[SMALL_BW + 1] = {
    nullptr, launch_factor_batched_small<1>, launch_factor_batched_small<2>,
    launch_factor_batched_small<3>, launch_factor_batched_small<4>,
    launch_factor_batched_small<5>, launch_factor_batched_small<6>,
    launch_factor_batched_small<7>, launch_factor_batched_small<8>};

template <int BW>
cudaError_t launch_takahashi_small(const double* L, const double* rinv,
                                   double* Z, int nsys, int d,
                                   cudaStream_t st) {
    constexpr int G = BW > 0 ? BW : 1;
    constexpr size_t TT = G * ((TK_ROWS + G - 1) / G);
    const size_t smem = sizeof(double) * (3 * TT * (BW + 1) + 2 * TT);
    band_takahashi_small<BW><<<nsys, 32, smem, st>>>(L, rinv, Z, d);
    return cudaGetLastError();
}

using TakahashiLaunch = cudaError_t (*)(const double*, const double*,
                                        double*, int, int, cudaStream_t);
const TakahashiLaunch kTakahashiSmall[SMALL_BW + 1] = {
    launch_takahashi_small<0>, launch_takahashi_small<1>,
    launch_takahashi_small<2>, launch_takahashi_small<3>,
    launch_takahashi_small<4>, launch_takahashi_small<5>,
    launch_takahashi_small<6>, launch_takahashi_small<7>,
    launch_takahashi_small<8>};

// K4 (nsys = 1) and K11: the register window up to SMALL_BW, the skewed
// pipeline above it (bw <= 125: four warps)
cudaError_t launch_takahashi(const double* L, const double* rinv, double* Z,
                             int nsys, int d, int bw, cudaStream_t st) {
    if (bw < 0) return cudaErrorInvalidValue;
    if (bw <= SMALL_BW) return kTakahashiSmall[bw](L, rinv, Z, nsys, d, st);
    if (tw_warps(bw) > TW_MAX_WARPS || takahashi_wide_bytes(bw) > MAX_SMEM)
        return cudaErrorInvalidValue;
    return kTakahashiWide[tw_lags(bw) / 4 - 2](L, rinv, Z, nsys, d, bw, st);
}

template <int NS, bool BWD, int MAXW, bool CAP>
cudaError_t launch_solve_warp(const double* L, const double* rinv,
                              const double* B, double* X, int nsys, int d,
                              int bw, int r, int warps, cudaStream_t st,
                              const unsigned char* gate) {
    const size_t rows = BWD && NS <= 2 ? WS_ROWS : WS_RING * WS_TILE;
    const size_t smem = sizeof(double) * rows * (size_t)(bw + 1);
    cudaError_t e = allow_smem(band_solve_warp<NS, BWD, MAXW, CAP>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((r + warps - 1) / warps, nsys);
    band_solve_warp<NS, BWD, MAXW, CAP><<<grid, 32 * warps, smem, st>>>(
        L, rinv, B, X, d, bw, r, gate);
    return cudaGetLastError();
}

// the warp kernel for bw: one, two or four register slots a lane
template <bool BWD, int MAXW, bool CAP = false>
cudaError_t launch_warp(const double* L, const double* rinv, const double* B,
                        double* X, int nsys, int d, int bw, int r, int warps,
                        cudaStream_t st, const unsigned char* gate = nullptr) {
    if (warps < 1 || warps > MAXW) return cudaErrorInvalidValue;
    if (bw < 32)
        return launch_solve_warp<1, BWD, MAXW, CAP>(L, rinv, B, X, nsys, d,
                                                    bw, r, warps, st, gate);
    if (bw < 64)
        return launch_solve_warp<2, BWD, MAXW, CAP>(L, rinv, B, X, nsys, d,
                                                    bw, r, warps, st, gate);
    if (bw < 128)
        return launch_solve_warp<4, BWD, MAXW, CAP>(L, rinv, B, X, nsys, d,
                                                    bw, r, warps, st, gate);
    return cudaErrorInvalidValue;
}

// Every solve, in one order (farthest-first): forward (K2, K9; with CAP
// K1's tail solve) or backward (K3, K5, K10), nsys systems of r
// right-hand sides, warp_block(r) of them a block of the warp kernel (bw
// > SMALL_BW). A forward solve given a device gate returns at once where
// *gate is 0, leaving X as it was.
template <bool BWD, bool CAP = false>
cudaError_t launch_solve(const double* L, const double* rinv,
                         const double* B, double* X, int nsys, int d,
                         int bw, int r, cudaStream_t st,
                         const unsigned char* gate = nullptr) {
    if (bw >= 1 && bw <= SMALL_BW)
        return (CAP ? kFarCap : kFar)[bw](BWD, L, rinv, B, X, nsys, d, r,
                                          st, gate);
    return launch_warp<BWD, WS_WARPS, CAP>(L, rinv, B, X, nsys, d, bw, r,
                                           warp_block(r), st, gate);
}

// bulk warps of the wide factor: about six table entries a bulk thread a
// step, but below bw = 64 at most 3, so that no bulk warp shares the chain
// warp's scheduler (warp w runs on scheduler w % 4; at bw = 34 three bulk
// warps timed best of 1-6)
int fg_bulk(int bw) {
    const int n = (fg_entries(bw) + 175) / 176;
    return max(1, min(bw < 64 ? 3 : FG_MAX_BULK, n));
}

template <int NSL>
cudaError_t launch_wide_nsl(const double* band, const double* C, double* L,
                            double* rinv, double* Y, double* piv,
                            double* hld, int* flag, int nsys, int d, int bw,
                            int qf, int nb, cudaStream_t st) {
    const size_t smem = fg_bytes(bw, qf > 0);
    const int nt = 32 * (1 + nb + qf);
    cudaError_t e;
    if (nsys == 0) {
        e = allow_smem(band_factor_wide<NSL>, smem);
        if (e != cudaSuccess) return e;
        band_factor_wide<NSL><<<1, nt, smem, st>>>(band, C, L, rinv, Y, piv,
                                                   hld, flag, d, bw, qf, nb);
    } else {
        e = allow_smem(band_factor_wide_batched<NSL>, smem);
        if (e != cudaSuccess) return e;
        band_factor_wide_batched<NSL><<<nsys, nt, smem, st>>>(
            band, L, rinv, piv, hld, flag, d, bw, nb);
    }
    return cudaGetLastError();
}

// the wide factor (bw > SMALL_BW): one system with qf tail columns (nsys
// = 0), or nsys systems without (K8); nb bulk warps
cudaError_t launch_wide(const double* band, const double* C, double* L,
                        double* rinv, double* Y, double* piv, double* hld,
                        int* flag, int nsys, int d, int bw, int qf, int nb,
                        cudaStream_t st) {
    if (bw <= SMALL_BW || bw > 127 || nb < 1 || nb > FG_MAX_BULK
        || qf < 0 || qf > FG_TAIL || (nsys > 0 && qf > 0))
        return cudaErrorInvalidValue;
    if (bw < 32)
        return launch_wide_nsl<1>(band, C, L, rinv, Y, piv, hld, flag, nsys,
                                  d, bw, qf, nb, st);
    if (bw < 64)
        return launch_wide_nsl<2>(band, C, L, rinv, Y, piv, hld, flag, nsys,
                                  d, bw, qf, nb, st);
    return launch_wide_nsl<4>(band, C, L, rinv, Y, piv, hld, flag, nsys, d,
                              bw, qf, nb, st);
}

}  // namespace

// ------------------------------------------------------ C interface --
extern "C" {

// Tail columns K1 computes beside the band in its block: up to
// MAX_TAIL_SMALL for bw <= SMALL_BW (a thread each), FG_TAIL for a wider
// band (a warp each) where their tile of L fits beside the window; the
// caller computes the rest with bgt_band_tail_solve on the factor.
int bgt_band_factor_tile(int bw, int q) {
    if (bw >= 1 && bw <= SMALL_BW) return min(q, MAX_TAIL_SMALL);
    return fg_bytes(bw, true) <= MAX_SMEM ? min(q, FG_TAIL) : 0;
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
    return (int)launch_wide(band, C, L, rinv, Y, piv, hld, flag, 0, d, bw, q,
                            fg_bulk(bw), st);
}

// K1 for bw > SMALL_BW with nb bulk warps (1 .. FG_MAX_BULK), for timing
// the block shapes side by side
int bgt_band_factor_bulk(const double* band, const double* C, double* L,
                         double* rinv, double* Y, double* piv, double* hld,
                         int* flag, int d, int bw, int q, int nb,
                         void* stream) {
    if (q > bgt_band_factor_tile(bw, q)) return (int)cudaErrorInvalidValue;
    return (int)launch_wide(band, C, L, rinv, Y, piv, hld, flag, 0, d, bw, q,
                            nb, (cudaStream_t)stream);
}

// Y = L^{-1} C for the tail columns beyond K1's tile, each column as K1
// computes it: K2's kernels (farthest-first), |Y| capped at 1e8
int bgt_band_tail_solve(const double* L, const double* rinv, const double* C,
                        double* Y, int d, int bw, int r, void* stream) {
    return (int)launch_solve<false, true>(L, rinv, C, Y, 1, d, bw, r,
                                          (cudaStream_t)stream);
}

int bgt_band_fwd_solve(const double* L, const double* rinv, const double* B,
                       double* X, int d, int bw, int r, void* stream) {
    return (int)launch_solve<false>(L, rinv, B, X, 1, d, bw, r,
                                    (cudaStream_t)stream);
}

// K2 where a device flag is set: X = L^{-1} B where *gate != 0 (K1
// clamped a pivot); where it is 0 every block returns at once and X
// keeps what it held (K1's Y)
int bgt_band_fwd_solve_gated(const double* L, const double* rinv,
                             const double* B, double* X,
                             const unsigned char* gate, int d, int bw, int r,
                             void* stream) {
    return (int)launch_solve<false>(L, rinv, B, X, 1, d, bw, r,
                                    (cudaStream_t)stream, gate);
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
    return (int)launch_takahashi(L, rinv, Z, 1, d, bw, (cudaStream_t)stream);
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
    return (int)launch_wide(bands, nullptr, L, rinv, nullptr, piv, hld, flag,
                            nsys, d, bw, 0, fg_bulk(bw), st);
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
    return (int)launch_takahashi(L, rinv, Z, nsys, d, bw,
                                 (cudaStream_t)stream);
}

}  // extern "C"
