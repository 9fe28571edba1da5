"""Arrowhead (banded + dense tail) SPD linear algebra on the band kernels.

The conditional Hessian of a single-IWP model has the form

    H = [[Hb (band, bw small), C], [C^T, Hd (dense q x q)]]

BandArrowEngine factors it with the band kernels of band_kernels.py
(K1 factor with the fused Y = L^{-1} C, K2/K3 solves, K5 draws, K4
selected inverse) and does the small dense Schur tail
S = Hd - Y^T Y with torch.linalg. Bands are (d, bw+1) with row j,
column o holding Hb[j+o, j].

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

# relative diagonal jitter of the second factorization attempt
CHOL_JITTER = 1e-4
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
    Ls: torch.Tensor     # (q, q) lower Cholesky of the Schur complement
    hld_b: torch.Tensor  # () half log-det of the banded part


class BandArrowEngine:
    """Factor / solve / half log-det / precision sampling of one arrowhead
    shape (d, bw, q). `ops` is the table of band operations
    (band_kernels.KERNELS by default; band_kernels.PLAIN runs the plain
    versions on any device, for comparison)."""

    def __init__(self, d: int, bw: int, q: int, ops=None):
        self.d, self.bw, self.q = d, bw, q
        self.ops = bk.KERNELS if ops is None else ops

    def with_ops(self, ops):
        return BandArrowEngine(self.d, self.bw, self.q, ops)

    def factor(self, band, C, Hd):
        with torch.no_grad():
            band = band.detach().contiguous()
            C = C.detach().contiguous()
            L, rinv, Y, hld_b = self.ops.factor(band, C)
            Ls = (chol_jittered(Hd.detach() - Y.T @ Y) if self.q
                  else Hd.detach())
        return BandFactor(L, rinv, Y, Ls, hld_b)

    def half_logdet(self, f: BandFactor):
        return f.hld_b + torch.log(torch.diagonal(f.Ls)).sum()

    def solve(self, f: BandFactor, rb, rd):
        """H [zb; zd] = [rb; rd]; rb (d,), rd (q,)."""
        u = self.ops.fwd_solve(f.L, f.rinv, rb.reshape(-1, 1).contiguous())
        u = u[:, 0]
        if self.q:
            zd = _solve_Lt(f.Ls, _solve_L(f.Ls, (rd - f.Y.T @ u)[:, None]))
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
            xd = _solve_Lt(f.Ls, zd)
            rhs = zb - f.Y @ xd
        else:
            xd = zd
            rhs = zb
        xb = self.ops.bwd_multi(f.L, f.rinv, rhs.contiguous())
        return xb, xd

    def hld_backward(self, f: BandFactor, ct):
        """Cotangents of the half log-det for (band, C, Hd):
        Hinv_bb|band = Takahashi(Hb) + band(W S^{-1} W^T),
        Hinv_bd = -W S^{-1}, Hinv_dd = S^{-1}, with W = Hb^{-1} C."""
        d, bw, q = self.d, self.bw, self.q
        dt, dev = f.L.dtype, f.L.device
        hinv_band = self.ops.takahashi(f.L, f.rinv)          # (d, bw+1)
        if q:
            Wm = self.solve_Lt(f, f.Y)                         # (d, q)
            Sinv = _solve_Lt(f.Ls, _solve_L(
                f.Ls, torch.eye(q, dtype=dt, device=dev)))
            A = Wm @ Sinv                                      # (d, q)
            corr = torch.zeros((d, bw + 1), dtype=dt, device=dev)
            for o in range(bw + 1):
                corr[:d - o, o] = (A[o:] * Wm[:d - o]).sum(1)
            hinv_band = hinv_band + corr
            ct_C = (-ct) * A
            ct_Hd = (0.5 * ct) * Sinv
        else:
            A = None
            ct_C = torch.zeros((d, 0), dtype=dt, device=dev)
            ct_Hd = torch.zeros((0, 0), dtype=dt, device=dev)
        w = torch.ones((1, bw + 1), dtype=dt, device=dev)
        w[0, 0] = 0.5
        # sick-factor gate: a healthy equilibrated system has
        # |H^{-1}| <= cond ~ 1e8, so the gate is the identity there; on a
        # pivot-clamped factor the selected inverse overflows and its
        # cotangents are dropped (the value's explicit gradient remains)
        inf = torch.tensor(float("inf"), dtype=dt, device=dev)
        big = torch.where(torch.isfinite(hinv_band), hinv_band.abs(),
                          inf).max()
        if A is not None:
            big = torch.maximum(big, torch.where(
                torch.isfinite(A), A.abs(), inf).max())
        okf = (big < SICK_INV).to(dt)

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
