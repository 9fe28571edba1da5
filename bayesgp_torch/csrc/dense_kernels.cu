// Dense Cholesky block kernels for Hopper (sm_90a), f64 throughout.
//
// The blocked dense Cholesky of linalg/chol_dense.py cuts a (d, d)
// symmetric matrix into 128 x 128 blocks. These two kernels do its
// sequential work; the O(d^3) trailing updates and the off-diagonal
// propagation of the blocked solves are f64 matrix products outside
// them (torch.matmul).
//
// K6 dense_factor_block replaces bayesgp_tpu/linalg/chol_dd.py:
//                   factor_block_fn (_factor_block_kernel): right-looking
//                   Cholesky of one symmetric (128, 128) block with the
//                   modified-Cholesky pivot clamp (a pivot below 1e-12
//                   becomes max(|pivot|, 1e-12)) and the cap |L| <= 1e3.
//                   It reads the lower triangle and writes L, lower, with
//                   zeros above the diagonal (the TPU kernel wrote the
//                   transposed factor as hi/lo f32 pairs), and sets
//                   flag[0] to 1 where it clamped a pivot.
// K7 dense_solve_lower replaces chol_dd.py:solve_lower_fn
//                   (_solve_lower_kernel): X = L^{-1} B for one 128-row
//                   diagonal block and r right-hand sides; with trans = 1
//                   it solves L^T X = B by looping backwards, where the
//                   TPU code flipped rows and columns outside the kernel.
//                   r is any positive number (the TPU padded it to 128).
//
// Matrices are row-major with a leading dimension (the row stride in
// elements), so a block of a larger matrix is passed without a copy.
// Every entry point takes the CUDA stream as its last argument, launches
// on it without synchronising, and returns cudaGetLastError(). The
// library is built with -fmad=false: every product is rounded before it
// is added, as in the plain PyTorch versions in chol_dense.py, and each
// kernel sums in its plain version's order, so the two agree bit for bit.
//
// Bound. K6 moves 256 KB and does ~0.7 MFLOP: under 0.1 us at 3.35 TB/s
// and 34 TFLOP/s. One block on one SM cannot approach that: its floors are
// the chain of 128 columns, each a pivot (a sqrt and a divide), a scale
// and a broadcast (~15-20 us), and its ~350k products and as many
// subtracts at 64 FP64 lanes a clock, unfused (~6 us).
// K7 moves the 128 KB block, r columns in and r columns out, and does
// 128^2 r flops: at r = 2051 ~4.3 MB and 34 MFLOP, ~1.3 us at the
// memory rate. Its floor is the substitution of one column, 128 steps
// that each wait on the last.
//
// Design. K6: one block of 8 warps holds the triangle in registers, each
// warp 16 contiguous columns, and forms them one after another: the chain
// stays inside one warp but at 7 hand-offs (a flag in shared memory), and
// the other warps take each published column beside it, with no block
// barrier (the kernel's comment). It stages the block through 132 KB of
// dynamic shared memory (above the 48 KB default, so the entry point
// raises the limit with cudaFuncSetAttribute), to read and write it row
// by row. K7: a block
// of SOLVE_WARPS warps stages the lower triangle of L (packed, 66 KB)
// and the reciprocal pivots into shared memory, then each warp solves
// one right-hand column by a right-looking substitution (the kernel's
// comment): the chain from x_{j-1} to x_j is one multiply, one subtract,
// the scale by 1/L_jj and a shuffle, 128 steps in all, where one
// thread a column would run 8,128 dependent multiply-subtracts. Three 66 KB blocks fit an SM, so r = 2051 (257 blocks) runs
// in one wave over the 132 SMs; r = 1 is one warp on one SM.

#include <atomic>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NB = 128;              // block size
constexpr double PIVOT_FLOOR = 1e-12;
constexpr double L_CAP = 1e3;
constexpr int SOLVE_WARPS = 8;       // K7 right-hand sides (warps) a block
constexpr int PACKED = NB * (NB + 1) / 2;

__device__ __forceinline__ double clip(double x, double cap) {
    // NaN propagates (like torch.clamp), unlike fmin/fmax
    return x > cap ? cap : (x < -cap ? -cap : x);
}

__device__ __forceinline__ double clamp_pivot(double p) {
    return p < PIVOT_FLOOR ? fmax(fabs(p), PIVOT_FLOOR) : p;
}

// offset of row i, and of column t, of a packed lower triangle
__device__ __forceinline__ int prow(int i) { return i * (i + 1) / 2; }
__device__ __forceinline__ int pcol(int t) {
    return t * (2 * NB + 1 - t) / 2;
}

// Raise kernel K's dynamic shared memory limit to `bytes` on the current
// device, once per device: the attribute stays set there, and setting it
// at every launch costs host time that K7 at one right-hand side cannot
// spare. Two host threads may both set it; that is harmless.
constexpr int MAX_DEVICES = 64;

template <auto K>
cudaError_t allow_smem(size_t bytes) {
    static std::atomic<size_t> allowed[MAX_DEVICES];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const bool cached = dev >= 0 && dev < MAX_DEVICES;
    if (cached && bytes <= allowed[dev].load(std::memory_order_acquire))
        return cudaSuccess;
    e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e == cudaSuccess && cached) {
        size_t cur = allowed[dev].load(std::memory_order_relaxed);
        while (cur < bytes && !allowed[dev].compare_exchange_weak(
                                  cur, bytes, std::memory_order_release))
            ;
    }
    return e;
}

// K6: one (NB, NB) block, lower triangle of S in, L out, right-looking.
// The block is read into T (row stride TLD) and then held in registers:
// warp w owns the 16 contiguous columns k = 16 w + c, and lane l the rows
// l + 32 m of them, entry (l + 32 m, k) in a[c][m]; the slots under m0 =
// w / 2 lie above every diagonal the warp owns and are skipped (m0 is a
// template argument). A warp first takes the products of the columns
// before its own, column by column as their owners publish them (in step
// order, as the plain version subtracts them), then forms its own columns
// one after another: the pivot by a shuffle, 1/sqrt of the clamped pivot,
// the scale and cap, the column written to row k of T (T ends holding L
// column by column), a flag released, and the column's products taken
// from the warp's later columns. So the chain from one column to the next
// stays inside one warp but at 7 of the 127 steps, and the other warps
// take the published columns beside it. L is written from T row by row
// at the end.
constexpr int K6_WARPS = 8;
constexpr int K6_COLS = NB / K6_WARPS;   // contiguous columns a warp owns
constexpr int TLD = NB + 1;              // row stride of T

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int ld_acquire(const int* f) {
    int v;
    asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
                 : "=r"(v) : "r"(smem_u32(f)) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int* f, int v) {
    asm volatile("st.release.cta.shared.b32 [%0], %1;\n"
                 :: "r"(smem_u32(f)), "r"(v) : "memory");
}

// Wait until *f >= v, sleeping between polls so that the waiting warps
// leave the issue slots to the working ones. A kernel whose flag never
// comes traps instead of hanging the card
__device__ __forceinline__ void wait_geq(const int* f, int v) {
    for (long n = 0; ld_acquire(f) < v; ++n) {
        if (n > (1L << 26)) __trap();
        __nanosleep(20);
    }
}

template <int M0>
__device__ __forceinline__ void k6_warp(double* T, int* formed, int w,
                                        int lane, bool& clamped) {
    const int k0 = K6_COLS * w;
    double a[K6_COLS][4];
#pragma unroll
    for (int c = 0; c < K6_COLS; ++c)
#pragma unroll
        for (int m = M0; m < 4; ++m)
            a[c][m] = T[(lane + 32 * m) * TLD + k0 + c];
    // the columns before this warp's: col_j's products l_i l_k
    for (int j = 0; j < k0; ++j) {
        wait_geq(formed, j + 1);
        const double* cj = T + j * TLD;          // column j of L
        double li[4];
#pragma unroll
        for (int m = M0; m < 4; ++m) li[m] = cj[lane + 32 * m];
#pragma unroll
        for (int c = 0; c < K6_COLS; ++c) {
            const double lk = cj[k0 + c];
#pragma unroll
            for (int m = M0; m < 4; ++m) a[c][m] = a[c][m] - li[m] * lk;
        }
    }
    // this warp's columns
#pragma unroll
    for (int c = 0; c < K6_COLS; ++c) {
        const int k = k0 + c, mk = k >> 5;
        double own = a[c][M0];
#pragma unroll
        for (int m = M0 + 1; m < 4; ++m) own = mk == m ? a[c][m] : own;
        const double p = __shfl_sync(0xffffffffu, own, k & 31);
        clamped |= p < PIVOT_FLOOR;
        // 1 / sqrt: the reciprocal and the division are both correctly
        // rounded
        const double rs = __drcp_rn(sqrt(clamp_pivot(p)));
        double* ck = T + k * TLD;                // column k of L
#pragma unroll
        for (int m = M0; m < 4; ++m) {
            const int i = lane + 32 * m;
            a[c][m] = clip(a[c][m] * rs, L_CAP);
            if (i >= k) ck[i] = a[c][m];
        }
        __syncwarp();
        if (lane == 0) st_release(formed, k + 1);
#pragma unroll
        for (int c2 = c + 1; c2 < K6_COLS; ++c2) {
            const double lk = ck[k0 + c2];
#pragma unroll
            for (int m = M0; m < 4; ++m) a[c2][m] = a[c2][m] - a[c][m] * lk;
        }
    }
}

__global__ void __launch_bounds__(32 * K6_WARPS)
dense_factor_block_kernel(const double* __restrict__ S, int lds,
                          double* __restrict__ L, int ldl,
                          int* __restrict__ flag) {
    extern __shared__ double smem[];
    // T: the lower triangle in, row by row; column k of L out, in row k
    // (at and right of the diagonal, where the input held nothing)
    double* T = smem;
    int* formed = reinterpret_cast<int*>(T + NB * TLD);   // columns formed
    const int tid = threadIdx.x, nt = blockDim.x;
    const int w = tid >> 5, lane = tid & 31;
#pragma unroll 8
    for (int e = tid; e < NB * NB; e += nt) {
        const int i = e / NB, k = e % NB;
        if (k <= i) T[i * TLD + k] = S[(size_t)i * lds + k];
    }
    if (tid == 0) formed[0] = 0;
    __syncthreads();
    bool clamped = false;
    switch (w >> 1) {
        case 0: k6_warp<0>(T, formed, w, lane, clamped); break;
        case 1: k6_warp<1>(T, formed, w, lane, clamped); break;
        case 2: k6_warp<2>(T, formed, w, lane, clamped); break;
        default: k6_warp<3>(T, formed, w, lane, clamped); break;
    }
    __syncthreads();
#pragma unroll 8
    for (int e = tid; e < NB * NB; e += nt) {
        const int i = e / NB, k = e % NB;
        L[(size_t)i * ldl + k] = k <= i ? T[k * TLD + i] : 0.0;
    }
    if (lane == 0 && clamped) flag[0] = 1;
}

// Stage the lower triangle of the (NB, NB) block L (row stride ldl)
// into Lp, packed by rows (ROWS: row i at prow(i)) or by columns (column
// t at pcol(t)), with all of the block's threads. A thread reads two
// neighbouring entries of a row with one 16-byte load where L and ldl
// allow it.
template <bool ROWS>
__device__ __forceinline__ void stage_lower(const double* __restrict__ L,
                                            int ldl, double* Lp) {
    const int tid = threadIdx.x, nt = blockDim.x;
    auto put = [&](int i, int t, double v) {
        Lp[ROWS ? prow(i) + t : pcol(t) + i - t] = v;
    };
    if (((reinterpret_cast<size_t>(L) | ((size_t)ldl * sizeof(double)))
         & 15) == 0) {
#pragma unroll 8
        for (int e = tid; e < NB * NB / 2; e += nt) {
            const int i = e / (NB / 2), t = 2 * (e % (NB / 2));
            if (t <= i) {
                const double2 v = *reinterpret_cast<const double2*>(
                    L + (size_t)i * ldl + t);
                put(i, t, v.x);
                if (t < i) put(i, t + 1, v.y);
            }
        }
    } else {
#pragma unroll 8
        for (int e = tid; e < NB * NB; e += nt) {
            const int i = e / NB, t = e % NB;
            if (t <= i) put(i, t, L[(size_t)i * ldl + t]);
        }
    }
}

// K7: X = L^{-1} B (TRANS false) or L^{-T} B (TRANS true) for one
// (NB, NB) lower block L and (NB, r) right-hand sides, one warp a
// right-hand side. Lane l holds the running sums of rows l, l + 32,
// l + 64 and l + 96 in registers. Step j (ascending, or descending for
// TRANS) forms x_j = acc_j / L_jj on lane j % 32, broadcasts it with a
// shuffle, and every lane subtracts L[i, j] x_j (TRANS: L[j, i] x_j)
// from its rows i still to come: a row takes its products in the order
// of the steps, as the plain version subtracts them. The 128 steps are
// unrolled, so every slot and owner lane is a constant; the diagonal
// slot updates through a select, and no step branches. Row j's sum is
// final once step j has passed, so lane l stores x of its rows at the
// end of each 32-step tile. The staged triangle is packed along the
// steps' reads: by columns for the forward solve (step j reads column
// j), by rows for TRANS (step j reads row j), so the lanes of a step
// read consecutive words.
template <bool TRANS>
__global__ void __launch_bounds__(32 * SOLVE_WARPS)
dense_solve_kernel(const double* __restrict__ L, int ldl,
                   const double* __restrict__ B, int ldb,
                   double* __restrict__ X, int ldx, int r) {
    extern __shared__ double smem[];
    double* Lp = smem;                   // packed lower triangle
    double* rinv = Lp + PACKED;          // 1 / L[i, i]
    constexpr unsigned FULL = 0xffffffffu;
    const int tid = threadIdx.x;
    stage_lower<TRANS>(L, ldl, Lp);
    __syncthreads();
    for (int i = tid; i < NB; i += blockDim.x)
        rinv[i] = 1.0 / Lp[TRANS ? prow(i) + i : pcol(i)];
    __syncthreads();
    const int lane = tid & 31;
    const int c = blockIdx.x * SOLVE_WARPS + (tid >> 5);
    if (c >= r) return;
    double acc[NB / 32];
#pragma unroll
    for (int s = 0; s < NB / 32; ++s)
        acc[s] = B[(size_t)(lane + 32 * s) * ldb + c];
#pragma unroll
    for (int k = 0; k < NB / 32; ++k) {
        const int T = TRANS ? NB / 32 - 1 - k : k;   // tile of the steps
#pragma unroll
        for (int v = 0; v < 32; ++v) {
            const int u = TRANS ? 31 - v : v;          // owner lane
            const int j = 32 * T + u;
            const double x = __shfl_sync(FULL, acc[T] * rinv[j], u);
            // Lj[i] = L[i, j] (forward, i >= j) or L[j, i] (TRANS, i <= j)
            const double* Lj = TRANS ? Lp + prow(j) : Lp + pcol(j) - j;
#pragma unroll
            for (int s = 0; s < NB / 32; ++s) {
                if (TRANS ? s > T : s < T) continue;   // rows already done
                const double a = acc[s] - Lj[lane + 32 * s] * x;
                if (s != T)
                    acc[s] = a;
                else
                    acc[s] = (TRANS ? lane < u : lane > u) ? a : acc[s];
            }
        }
        X[(size_t)(32 * T + lane) * ldx + c] = acc[T] * rinv[32 * T + lane];
    }
}

}  // namespace

extern "C" {

// flag[0] is set to 1 where a raw pivot fell under PIVOT_FLOOR and was
// clamped, and left as it is otherwise (so the blocks of one blocked
// factorization share one flag)
int bgt_dense_factor_block(const double* S, int lds, double* L, int ldl,
                           int* flag, void* stream) {
    const size_t smem = (size_t)NB * TLD * sizeof(double) + sizeof(int);
    cudaError_t e = allow_smem<dense_factor_block_kernel>(smem);
    if (e != cudaSuccess) return (int)e;
    dense_factor_block_kernel<<<1, 32 * K6_WARPS, smem,
                                (cudaStream_t)stream>>>(S, lds, L, ldl, flag);
    return (int)cudaGetLastError();
}

int bgt_dense_solve_lower(const double* L, int ldl, const double* B,
                          int ldb, double* X, int ldx, int r, int trans,
                          void* stream) {
    const size_t smem = (size_t)(PACKED + NB) * sizeof(double);
    const dim3 grid((r + SOLVE_WARPS - 1) / SOLVE_WARPS);
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e;
    if (trans) {
        e = allow_smem<dense_solve_kernel<true>>(smem);
        if (e != cudaSuccess) return (int)e;
        dense_solve_kernel<true><<<grid, 32 * SOLVE_WARPS, smem, st>>>(
            L, ldl, B, ldb, X, ldx, r);
    } else {
        e = allow_smem<dense_solve_kernel<false>>(smem);
        if (e != cudaSuccess) return (int)e;
        dense_solve_kernel<false><<<grid, 32 * SOLVE_WARPS, smem, st>>>(
            L, ldl, B, ldb, X, ldx, r);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
