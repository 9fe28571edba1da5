"""Arrowhead (banded + dense tail) SPD linear algebra on the band kernels.

The conditional Hessian of a single-IWP model has the form

    H = [[Hb (band, bw small), C], [C^T, Hd (dense q x q)]]

BandArrowEngine factors it with the band kernels of band_kernels.py
(K1 factor with the fused Y = L^{-1} C, K2/K3 solves, K5 draws, K4
selected inverse) and the dense Schur tail S = Hd - Y^T Y: with
torch.linalg below DENSE_TAIL_MIN columns, and from there on the blocked
dense Cholesky of chol_dense.py (K6/K7), as the JAX package's
small_chol routes tails of 256 columns and more. Bands are (d, bw+1)
with row j, column o holding Hb[j+o, j].

`arrow_half_logdet` is the differentiable half log-det: a
torch.autograd.Function whose backward is the Takahashi selected inverse
plus the Schur-tail corrections, d(0.5 log|H|)/dH = 0.5 H^{-1} on the
entries that parameterize H -- the backward never differentiates
through the factorization recurrence.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import band_kernels as bk
from . import chol_dense

# relative diagonal jitter of the second factorization attempt
CHOL_JITTER = 1e-4
# tails at least this wide factor on the blocked dense kernels
DENSE_TAIL_MIN = 256
# |H^{-1}| above this on the selected entries marks a sick (pivot-clamped)
# factor, whose log-det cotangents are dropped
SICK_INV = 1e12


def _chol_ok(S):
    L, info = torch.linalg.cholesky_ex(S)
    return (info == 0) & torch.isfinite(
        torch.diagonal(L, dim1=-2, dim2=-1)).all(-1)


def chol_jittered(S):
    """Lower Cholesky of (..., q, q) with failure escalation, matrix by
    matrix: plain -> + jitter * scale * I -> a diagonal surrogate that
    always factors. A healthy matrix factors exactly as it is. Branchless
    (no host synchronisation)."""
    q = S.shape[-1]
    eye = torch.eye(q, dtype=S.dtype, device=S.device)
    Ssg = S.detach()
    diag = torch.diagonal(S, dim1=-2, dim2=-1)
    scale = torch.clamp(diag.detach().abs().mean(-1), min=1e-30)
    jit = torch.where(_chol_ok(Ssg), torch.zeros_like(scale),
                      CHOL_JITTER * scale)[..., None, None]
    ok1 = _chol_ok(Ssg + jit * eye)[..., None, None]
    dsafe = torch.maximum(diag.abs(), 1e-8 * scale[..., None])
    Sfin = torch.where(ok1, S + jit * eye, eye * dsafe[..., None, :])
    return torch.linalg.cholesky_ex(Sfin)[0]


def _solve_L(L, b):
    return torch.linalg.solve_triangular(L, b, upper=False)


def _solve_Lt(L, b):
    return torch.linalg.solve_triangular(L.T, b, upper=True)


class BandFactor(NamedTuple):
    L: torch.Tensor      # (d, bw+1) band of the factor
    rinv: torch.Tensor   # (d,) 1 / L[j, j]
    Y: torch.Tensor      # (d, q) L^{-1} C
    Ls: torch.Tensor     # lower Cholesky of the Schur complement: (q, q),
    #                      or on the dense route the padded blocked factor
    hld_b: torch.Tensor  # () half log-det of the banded part


class BandArrowEngine:
    """Factor / solve / half log-det / precision sampling of one arrowhead
    shape (d, bw, q). `ops` is the table of band operations
    (band_kernels.KERNELS by default; band_kernels.PLAIN runs the plain
    versions on any device, for comparison). A tail of DENSE_TAIL_MIN
    columns or more factors with chol_dense's blocked routines."""

    def __init__(self, d: int, bw: int, q: int, ops=None):
        self.d, self.bw, self.q = d, bw, q
        self.ops = bk.KERNELS if ops is None else ops
        self.dense_tail = q >= DENSE_TAIL_MIN

    def with_ops(self, ops):
        return BandArrowEngine(self.d, self.bw, self.q, ops)

    # -- the Schur tail ----------------------------------------------------
    def _tail_chol(self, S):
        if self.dense_tail:
            return chol_dense.cholesky_blocked(S)
        return chol_jittered(S)

    def _tail_solve_L(self, Ls, b):
        if self.dense_tail:
            return chol_dense.solve_lower_blocked(Ls, b)
        return _solve_L(Ls, b)

    def _tail_solve_Lt(self, Ls, b):
        if self.dense_tail:
            return chol_dense.solve_lower_t_blocked(Ls, b)
        return _solve_Lt(Ls, b)

    def factor(self, band, C, Hd):
        with torch.no_grad():
            band = band.detach().contiguous()
            C = C.detach().contiguous()
            L, rinv, Y, hld_b = self.ops.factor(band, C)
            Ls = (self._tail_chol(Hd.detach() - Y.T @ Y) if self.q
                  else Hd.detach())
        return BandFactor(L, rinv, Y, Ls, hld_b)

    def half_logdet(self, f: BandFactor):
        if self.dense_tail:
            return f.hld_b + chol_dense.half_logdet(f.Ls)
        return f.hld_b + torch.log(torch.diagonal(f.Ls)).sum()

    def solve(self, f: BandFactor, rb, rd):
        """H [zb; zd] = [rb; rd]; rb (d,), rd (q,)."""
        u = self.ops.fwd_solve(f.L, f.rinv, rb.reshape(-1, 1).contiguous())
        u = u[:, 0]
        if self.q:
            zd = self._tail_solve_Lt(
                f.Ls, self._tail_solve_L(f.Ls, (rd - f.Y.T @ u)[:, None]))
            zd = zd[:, 0]
            u = u - f.Y @ zd
        else:
            zd = rd
        zb = self.ops.bwd_solve(f.L, f.rinv, u.reshape(-1, 1).contiguous())
        return zb[:, 0], zd

    def solve_Lt(self, f: BandFactor, B):
        """L^{-T} B for (d, r) B."""
        return self.ops.bwd_solve(f.L, f.rinv, B.contiguous())

    def sample_multi(self, f: BandFactor, zb, zd):
        """x = L_full^{-T} z: each column ~ N(0, H^{-1}).
        zb (d, M), zd (q, M)."""
        if self.q:
            xd = self._tail_solve_Lt(f.Ls, zd)
            rhs = zb - f.Y @ xd
        else:
            xd = zd
            rhs = zb
        xb = self.ops.bwd_multi(f.L, f.rinv, rhs.contiguous())
        return xb, xd

    def _hinv_parts(self, f: BandFactor):
        """The entries of H^{-1} the half-log-det backward reads:
        Hinv_bb|band = Takahashi(Hb) + band(W S^{-1} W^T), A = W S^{-1}
        (Hinv_bd = -A) and Hinv_dd = S^{-1}, with W = Hb^{-1} C (A and
        S^{-1} None when q = 0)."""
        d, bw, q = self.d, self.bw, self.q
        dt, dev = f.L.dtype, f.L.device
        hinv_band = self.ops.takahashi(f.L, f.rinv)          # (d, bw+1)
        if not q:
            return hinv_band, None, None
        Wm = self.solve_Lt(f, f.Y)                             # (d, q)
        Sinv = self._tail_solve_Lt(f.Ls, self._tail_solve_L(
            f.Ls, torch.eye(q, dtype=dt, device=dev)))
        A = Wm @ Sinv                                          # (d, q)
        corr = torch.zeros((d, bw + 1), dtype=dt, device=dev)
        for o in range(bw + 1):
            corr[:d - o, o] = (A[o:] * Wm[:d - o]).sum(1)
        return hinv_band + corr, A, Sinv

    def gate_peak(self, f: BandFactor):
        """The largest |H^{-1}| entry the sick-factor gate tests (inf where
        one is not finite): the band of Hinv_bb and A. The half-log-det
        backward drops its cotangents where this reaches SICK_INV."""
        hinv_band, A, _ = self._hinv_parts(f)
        return _gate_peak(hinv_band, A)

    def hld_backward(self, f: BandFactor, ct):
        """Cotangents of the half log-det for (band, C, Hd): ct times
        0.5 H^{-1} on the band's diagonal, H^{-1} off it, -A for C and
        0.5 S^{-1} for Hd (_hinv_parts)."""
        d, bw, q = self.d, self.bw, self.q
        dt, dev = f.L.dtype, f.L.device
        hinv_band, A, Sinv = self._hinv_parts(f)
        if q:
            ct_C = (-ct) * A
            ct_Hd = (0.5 * ct) * Sinv
        else:
            ct_C = torch.zeros((d, 0), dtype=dt, device=dev)
            ct_Hd = torch.zeros((0, 0), dtype=dt, device=dev)
        w = torch.ones((1, bw + 1), dtype=dt, device=dev)
        w[0, 0] = 0.5
        # sick-factor gate: a healthy equilibrated system has
        # |H^{-1}| <= cond ~ 1e8, so the gate is the identity there; on a
        # pivot-clamped factor the selected inverse overflows and its
        # cotangents are dropped (the value's explicit gradient remains)
        okf = (_gate_peak(hinv_band, A) < SICK_INV).to(dt)

        def san(x):
            return okf * torch.where(torch.isfinite(x), x,
                                     torch.zeros_like(x))
        return san(ct * w * hinv_band), san(ct_C), san(ct_Hd)

    def arrow_half_logdet(self, band, C, Hd):
        """Differentiable half log-det of the arrowhead."""
        return _HalfLogdet.apply(band, C, Hd, self, None)

    def arrow_half_logdet_given(self, band, C, Hd, f: BandFactor):
        """arrow_half_logdet with a precomputed factor of the same system:
        the primal skips the factorization, the backward gives the same
        cotangents from `f`."""
        return _HalfLogdet.apply(band, C, Hd, self, f)


def _gate_peak(hinv_band, A):
    """max |x| over the band of H^{-1} and A, inf where an entry is not
    finite."""
    inf = torch.tensor(float("inf"), dtype=hinv_band.dtype,
                       device=hinv_band.device)
    big = torch.where(torch.isfinite(hinv_band), hinv_band.abs(), inf).max()
    if A is not None:
        big = torch.maximum(big, torch.where(torch.isfinite(A), A.abs(),
                                             inf).max())
    return big


class _HalfLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, band, C, Hd, engine, f):
        if f is None:
            f = engine.factor(band, C, Hd)
        ctx.engine, ctx.f = engine, f
        return engine.half_logdet(f)

    @staticmethod
    def backward(ctx, ct):
        g_band, g_C, g_Hd = ctx.engine.hld_backward(ctx.f, ct)
        return g_band, g_C, g_Hd, None, None
