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
// and 34 TFLOP/s. Its real floor is the chain of 128 columns, each a
// pivot (a sqrt and a divide), a scaled column and a rank-1 update of
// the trailing block, with two barriers a column: one block on one SM.
// K7 moves the 128 KB block, r columns in and r columns out, and does
// 128^2 r flops: at r = 2051 ~4.3 MB and 34 MFLOP, ~1.3 us at the
// memory rate. Its floor is the forward substitution of one column:
// 8,128 dependent multiply-subtracts, each waiting on the last.
//
// Design. K6: one block of 512 threads holds the block in 128 KB of
// dynamic shared memory (above the 48 KB default, so the entry point
// raises the limit with cudaFuncSetAttribute). For each column every
// thread recomputes the clamped pivot from shared memory (no barrier
// for it), the threads scale the column into a shared vector, then a
// 32 x 16 thread grid updates the lower trailing triangle. K7: the lower
// triangle of L (packed, 66 KB) and the reciprocal pivots live in shared
// memory; each thread carries one right-hand column through the
// substitution with its solution column in shared memory, and the grid
// covers the columns in tiles of SOLVE_COLS, so r = 2051 spreads over 33
// multiprocessors.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NB = 128;              // block size
constexpr double PIVOT_FLOOR = 1e-12;
constexpr double L_CAP = 1e3;
constexpr int FACTOR_TX = 32;        // K6 thread grid
constexpr int FACTOR_TY = 16;
constexpr int SOLVE_COLS = 64;       // K7 right-hand sides a block
constexpr int PACKED = NB * (NB + 1) / 2;

__device__ __forceinline__ double clip(double x, double cap) {
    // NaN propagates (like torch.clamp), unlike fmin/fmax
    return x > cap ? cap : (x < -cap ? -cap : x);
}

__device__ __forceinline__ double clamp_pivot(double p) {
    return p < PIVOT_FLOOR ? fmax(fabs(p), PIVOT_FLOOR) : p;
}

// offset of row i of a packed lower triangle
__device__ __forceinline__ int prow(int i) { return i * (i + 1) / 2; }

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// K6: one (NB, NB) block, lower triangle of S in, L out. Column j of L
// goes to the unused upper triangle of A (row j) and its pivot entry to
// dg[j], so the writes of column j never touch what the threads read
// for it (the diagonal and the lower column of A).
__global__ void __launch_bounds__(FACTOR_TX * FACTOR_TY)
dense_factor_block_kernel(const double* __restrict__ S, int lds,
                          double* __restrict__ L, int ldl,
                          int* __restrict__ flag) {
    extern __shared__ double smem[];
    double* A = smem;                 // (NB, NB), row-major
    double* col = smem + NB * NB;     // the scaled column j
    double* dg = col + NB;            // the diagonal of L
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * FACTOR_TX + tx;
    const int nt = FACTOR_TX * FACTOR_TY;
    for (int e = tid; e < NB * NB; e += nt)
        A[e] = S[(size_t)(e / NB) * lds + (e % NB)];
    __syncthreads();
    bool clamped = false;                 // thread 0: a pivot was clamped
    for (int j = 0; j < NB; ++j) {
        const double p = A[j * NB + j];
        clamped |= p < PIVOT_FLOOR;
        const double rs = 1.0 / sqrt(clamp_pivot(p));
        for (int i = j + tid; i < NB; i += nt) {
            const double l = clip(A[i * NB + j] * rs, L_CAP);
            col[i] = l;
            if (i == j)
                dg[j] = l;
            else
                A[j * NB + i] = l;
        }
        __syncthreads();
        // trailing update of the lower triangle: A[i, k] -= l_i l_k
        for (int i = j + 1 + ty; i < NB; i += FACTOR_TY) {
            const double li = col[i];
            for (int k = j + 1 + tx; k <= i; k += FACTOR_TX)
                A[i * NB + k] = A[i * NB + k] - li * col[k];
        }
        __syncthreads();
    }
    for (int e = tid; e < NB * NB; e += nt) {
        const int i = e / NB, k = e % NB;
        L[(size_t)i * ldl + k] = k < i ? A[k * NB + i] : (k == i ? dg[i]
                                                                 : 0.0);
    }
    if (tid == 0 && clamped) flag[0] = 1;
}

// K7: X = L^{-1} B (TRANS false) or L^{-T} B (TRANS true) for one
// (NB, NB) lower block L and (NB, r) right-hand sides.
template <bool TRANS>
__global__ void __launch_bounds__(SOLVE_COLS)
dense_solve_kernel(const double* __restrict__ L, int ldl,
                   const double* __restrict__ B, int ldb,
                   double* __restrict__ X, int ldx, int r) {
    extern __shared__ double smem[];
    double* Lp = smem;                   // packed lower triangle
    double* rinv = Lp + PACKED;          // 1 / L[i, i]
    double* xs = rinv + NB;              // (NB, SOLVE_COLS) solution tile
    const int tid = threadIdx.x;
    // one flat loop over the block (independent loads the compiler can
    // keep in flight), keeping the lower triangle
    for (int e = tid; e < NB * NB; e += SOLVE_COLS) {
        const int i = e / NB, t = e % NB;
        if (t <= i) Lp[prow(i) + t] = L[(size_t)i * ldl + t];
    }
    __syncthreads();
    for (int i = tid; i < NB; i += SOLVE_COLS)
        rinv[i] = 1.0 / Lp[prow(i) + i];
    __syncthreads();
    const int c = blockIdx.x * SOLVE_COLS + tid;
    if (c >= r) return;
    if (!TRANS) {
        for (int i = 0; i < NB; ++i) {
            double acc = B[(size_t)i * ldb + c];
            const double* Li = Lp + prow(i);
            for (int t = 0; t < i; ++t)
                acc = acc - Li[t] * xs[t * SOLVE_COLS + tid];
            const double x = acc * rinv[i];
            xs[i * SOLVE_COLS + tid] = x;
            X[(size_t)i * ldx + c] = x;
        }
    } else {
        for (int i = NB - 1; i >= 0; --i) {
            double acc = B[(size_t)i * ldb + c];
            for (int t = NB - 1; t > i; --t)
                acc = acc - Lp[prow(t) + i] * xs[t * SOLVE_COLS + tid];
            const double x = acc * rinv[i];
            xs[i * SOLVE_COLS + tid] = x;
            X[(size_t)i * ldx + c] = x;
        }
    }
}

}  // namespace

extern "C" {

// flag[0] is set to 1 where a raw pivot fell under PIVOT_FLOOR and was
// clamped, and left as it is otherwise (so the blocks of one blocked
// factorization share one flag)
int bgt_dense_factor_block(const double* S, int lds, double* L, int ldl,
                           int* flag, void* stream) {
    const size_t smem = (size_t)(NB * NB + 2 * NB) * sizeof(double);
    cudaError_t e = allow_smem(dense_factor_block_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    dense_factor_block_kernel<<<1, dim3(FACTOR_TX, FACTOR_TY), smem,
                                (cudaStream_t)stream>>>(S, lds, L, ldl, flag);
    return (int)cudaGetLastError();
}

int bgt_dense_solve_lower(const double* L, int ldl, const double* B,
                          int ldb, double* X, int ldx, int r, int trans,
                          void* stream) {
    const size_t smem =
        (size_t)(PACKED + NB + NB * SOLVE_COLS) * sizeof(double);
    const dim3 grid((r + SOLVE_COLS - 1) / SOLVE_COLS);
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e;
    if (trans) {
        e = allow_smem(dense_solve_kernel<true>, smem);
        if (e != cudaSuccess) return (int)e;
        dense_solve_kernel<true><<<grid, SOLVE_COLS, smem, st>>>(
            L, ldl, B, ldb, X, ldx, r);
    } else {
        e = allow_smem(dense_solve_kernel<false>, smem);
        if (e != cudaSuccess) return (int)e;
        dense_solve_kernel<false><<<grid, SOLVE_COLS, smem, st>>>(
            L, ldl, B, ldb, X, ldx, r);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
