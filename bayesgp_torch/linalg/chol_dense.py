"""Blocked dense Cholesky on hand-written block kernels (K6, K7).

The counterpart of bayesgp_tpu/linalg/chol_dd.py: the dense Schur factor
of the scattered-IID engine (fast/scatter_iid.py) is a blocked
right-looking Cholesky in 128 x 128 blocks. The sequential work runs in
two kernels of csrc/dense_kernels.cu:

  dense_factor_block  (K6)  L of one symmetric (128, 128) block
  dense_solve_lower   (K7)  X = L^{-1} B, or L^{-T} B, for one 128-row
                            diagonal block and any number of columns

and the O(d^3) trailing updates and the off-diagonal propagation of the
blocked solves are f64 matrix products (torch.matmul), as the JAX package
leaves them to XLA.

Each wrapper checks its arguments, then dispatches on the device of its
tensors: on the CPU it runs the plain PyTorch version beside it (a loop
over the 128 columns, vectorized over rows and right-hand sides); on a
CUDA device it launches the kernel, built with nvcc for sm_90a into
_build/ at first use and bound through ctypes, and counts the launch in
`launches`. There is no fallback from one to the other. Inputs may be
blocks of larger row-major matrices (rows contiguous, any row stride).

The block factor keeps the modified-Cholesky guards of the JAX
package's K6: a pivot below 1e-12 becomes max(|pivot|, 1e-12) and |L| is
capped at 1e3. On a healthy equilibrated matrix neither binds; given a
flag, K6 and its plain version set it where they clamped a pivot, which
the band engine's half-log-det backward reads (band_arrow.py). The JAX
package's double-float pairs and its row/column flips (a TPU compiler
limit) are not ported: Hopper computes in f64, and K7 loops backwards
for the transposed solve.

Factors are kept padded: cholesky_blocked returns the (dp, dp) factor of
the matrix padded to a multiple of 128 with an identity block, which the
blocked solves and half_logdet take as it is.
"""
from __future__ import annotations

import ctypes

import torch

from . import band_kernels as bk

B = 128
PIVOT_FLOOR = 1e-12
L_CAP = 1e3
SOURCE = bk._PKG / "csrc" / "dense_kernels.cu"

# kernel launches per wrapper since the last reset_launches()
launches = {"dense_factor_block": 0, "dense_solve_lower": 0}

_lib = None


def reset_launches():
    for k in launches:
        launches[k] = 0


def build():
    """Compile csrc/dense_kernels.cu into _build/ and return the library
    path."""
    return bk.build_library(SOURCE, "dense_kernels")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bgt_dense_factor_block.argtypes = [P, I, P, I, P, P]
        lib.bgt_dense_solve_lower.argtypes = [P, I, P, I, P, I, I, I, P]
        lib.bgt_dense_factor_block.restype = I
        lib.bgt_dense_solve_lower.restype = I
        _lib = lib
    return _lib


def _check(t, name, cols=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != torch.float64:
        raise TypeError(f"{name} must be float64, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != B or (cols and t.shape[1] != cols):
        raise ValueError(f"{name} must be ({B}, {cols or 'r'}), got "
                         f"{tuple(t.shape)}")
    if t.shape[1] and (t.stride(1) != 1 or t.stride(0) < t.shape[1]):
        raise ValueError(f"{name} must have contiguous rows")


# -- K6: one diagonal block ----------------------------------------------

def dense_factor_block_plain(S, flag=None):
    """Plain version of dense_factor_block (same arithmetic, column by
    column, reading the lower triangle)."""
    A = S.clone()
    L = torch.zeros_like(S)
    for j in range(B):
        piv = A[j, j]
        low = piv < PIVOT_FLOOR
        if flag is not None:
            flag |= low
        pv = torch.where(low, torch.clamp(piv.abs(), min=PIVOT_FLOOR), piv)
        rs = 1.0 / torch.sqrt(pv)
        col = torch.clamp(A[j:, j] * rs, -L_CAP, L_CAP)
        L[j:, j] = col
        A[j + 1:, j + 1:] -= torch.outer(col[1:], col[1:])
    return L


def dense_factor_block(S, flag=None):
    """Lower Cholesky factor (128, 128) of the symmetric block S, of
    which only the lower triangle is read (guarded: pivot clamp, cap).
    flag: an optional 0-d int32 tensor on S's device, set to 1 where a
    raw pivot fell under PIVOT_FLOOR and was clamped, else left as it
    is."""
    _check(S, "S", B)
    if flag is not None and (flag.dtype != torch.int32 or flag.dim()
                             or flag.device != S.device):
        raise ValueError("flag must be a 0-d int32 tensor on S's device")
    if not bk._on_cuda(S):
        return dense_factor_block_plain(S, flag)
    L = torch.empty((B, B), dtype=S.dtype, device=S.device)
    if flag is None:
        flag = torch.zeros((), dtype=torch.int32, device=S.device)
    with bk._device(S):
        bk._launch("dense_factor_block", _library().bgt_dense_factor_block,
                   bk._ptr(S), S.stride(0), bk._ptr(L), B, bk._ptr(flag),
                   bk._stream(S), counts=launches)
    return L


# -- K7: triangular solve with one diagonal block -----------------------

def dense_solve_lower_plain(L, Bm, trans=False):
    """Plain version of dense_solve_lower: substitution row by row, each
    row's sum taken in the kernel's order (ascending t, or descending
    for the transposed solve)."""
    X = Bm.clone()
    rinv = 1.0 / torch.diagonal(L)
    steps = range(B - 1, -1, -1) if trans else range(B)
    for t in steps:
        X[t] = X[t] * rinv[t]
        if trans and t:
            X[:t] -= L[t, :t, None] * X[t]
        elif not trans and t + 1 < B:
            X[t + 1:] -= L[t + 1:, t, None] * X[t]
    return X


def dense_solve_lower(L, Bm, trans=False):
    """X with L X = Bm (or L^T X = Bm with trans) for a lower (128, 128)
    block L and (128, r) right-hand sides."""
    _check(L, "L", B)
    _check(Bm, "B")
    if not bk._on_cuda(L, Bm):
        return dense_solve_lower_plain(L, Bm, trans)
    # host time counts at r = 1, where the kernel takes ~13 us: pointers
    # go to ctypes as ints, and new_empty parses fewer arguments
    r = Bm.shape[1]
    X = Bm.new_empty((B, r))
    if r == 0:
        return X
    with bk._device(Bm):
        bk._launch("dense_solve_lower", _library().bgt_dense_solve_lower,
                   L.data_ptr(), L.stride(0), Bm.data_ptr(), Bm.stride(0),
                   X.data_ptr(), r, r, int(trans), bk._stream(Bm),
                   counts=launches)
    return X


class DenseOps:
    """The two block operations of the blocked routines, as one table:
    KERNELS dispatches on the device (the kernels on a card), PLAIN always
    runs the plain versions (for comparison on a card)."""

    def __init__(self, factor_block, solve_lower):
        self.factor_block = factor_block
        self.solve_lower = solve_lower


KERNELS = DenseOps(dense_factor_block, dense_solve_lower)
PLAIN = DenseOps(dense_factor_block_plain, dense_solve_lower_plain)


# -- blocked factorization and solves ---------------------------------------

def padded_dim(d: int) -> int:
    return -(-d // B) * B


def cholesky_blocked(A, ops=KERNELS, flag=None):
    """Padded lower factor (dp, dp) of the symmetric (d, d) matrix A, dp
    = d rounded up to 128, A padded with an identity block. Blocked
    right-looking: K6 on each diagonal block, K7 for the panel below it,
    the trailing update T - X X^T by a matrix product. flag: as for
    dense_factor_block, set where any block clamped a pivot."""
    d = A.shape[0]
    dp = padded_dim(d)
    S = A.new_zeros((dp, dp))
    S[:d, :d] = A
    S.diagonal()[d:] = 1.0
    L = torch.zeros_like(S)
    for lo in range(0, dp, B):
        hi = lo + B
        Lkk = ops.factor_block(S[lo:hi, lo:hi], flag)
        L[lo:hi, lo:hi] = Lkk
        if hi < dp:
            # X Lkk^T = P  <=>  Lkk X^T = P^T
            Xt = ops.solve_lower(Lkk, S[hi:, lo:hi].T.contiguous())
            L[hi:, lo:hi] = Xt.T
            S[hi:, hi:] -= Xt.T @ Xt
    return L


def _rhs(Lp, Bm):
    """Bm (d,) or (d, r) zero-padded to (dp, r)."""
    Bm2 = Bm[:, None] if Bm.dim() == 1 else Bm
    Y = Bm2.new_zeros((Lp.shape[0], Bm2.shape[1]))
    Y[:Bm2.shape[0]] = Bm2
    return Y


def solve_lower_blocked(Lp, Bm, ops=KERNELS):
    """Y with L Y = Bm for a padded factor Lp of cholesky_blocked and Bm
    (d,) or (d, r): K7 on each diagonal block, the blocks above it
    subtracted by a matrix product."""
    Y = _rhs(Lp, Bm)
    for lo in range(0, Lp.shape[0], B):
        hi = lo + B
        rhs = Y[lo:hi]
        if lo:
            rhs = rhs - Lp[lo:hi, :lo] @ Y[:lo]
        Y[lo:hi] = ops.solve_lower(Lp[lo:hi, lo:hi], rhs)
    Y = Y[:Bm.shape[0]]
    return Y[:, 0] if Bm.dim() == 1 else Y


def solve_lower_t_blocked(Lp, Bm, ops=KERNELS):
    """X with L^T X = Bm, the blocks taken from the last to the first."""
    X = _rhs(Lp, Bm)
    dp = Lp.shape[0]
    for lo in range(dp - B, -1, -B):
        hi = lo + B
        rhs = X[lo:hi]
        if hi < dp:
            rhs = rhs - Lp[hi:, lo:hi].T @ X[hi:]
        X[lo:hi] = ops.solve_lower(Lp[lo:hi, lo:hi], rhs, trans=True)
    X = X[:Bm.shape[0]]
    return X[:, 0] if Bm.dim() == 1 else X


def half_logdet(Lp):
    """0.5 log det(L L^T) = sum log |diag L| (floored at 1e-150)."""
    return torch.log(torch.clamp(torch.diagonal(Lp).abs(), min=1e-150)).sum()


class _DenseHalfLogdet(torch.autograd.Function):
    """Half log-det of a symmetric matrix through its blocked factor. The
    backward is ct * 0.5 S^{-1} = ct * 0.5 L^{-T} L^{-1}, formed by two
    blocked solves (K7), the cotangent the Murray pullback of the JAX
    package's factor gives the log-det; nothing differentiates through
    the factorization."""

    @staticmethod
    def forward(ctx, S, ops, Lp):
        if Lp is None:
            Lp = cholesky_blocked(S.detach(), ops)
        ctx.Lp, ctx.ops, ctx.d = Lp, ops, S.shape[0]
        return half_logdet(Lp)

    @staticmethod
    def backward(ctx, ct):
        Lp, ops = ctx.Lp, ctx.ops
        eye = torch.eye(ctx.d, dtype=Lp.dtype, device=Lp.device)
        Sinv = solve_lower_t_blocked(Lp, solve_lower_blocked(Lp, eye, ops),
                                     ops)
        G = (0.5 * ct) * Sinv
        return 0.5 * (G + G.T), None, None


def dense_half_logdet(S, ops=KERNELS, factor=None):
    """Differentiable 0.5 log det S of a symmetric (d, d) S. `factor`: its
    padded factor from cholesky_blocked, which the primal then reuses."""
    return _DenseHalfLogdet.apply(S, ops, factor)
