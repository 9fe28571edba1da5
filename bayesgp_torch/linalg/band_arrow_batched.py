"""NR arrowhead SPD systems factored and solved together on the batched
band kernels.

The batched counterpart of band_arrow.BandArrowEngine: NR independent

    H_r = [[Hb_r (band, bw small), C_r], [C_r^T, Hd_r (dense q x q)]]

of one shape (d, bw, q). The banded parts go through the kernels of
band_batched.py in one launch each (K8 factor, K9 for Y_r = L_r^{-1} C_r
and the forward solves, K10 backward solves, K11 selected inverse); the
small dense Schur tails S_r = Hd_r - Y_r^T Y_r are batched torch.linalg
calls. Bands are (NR, d, bw+1), C (NR, d, q), Hd (NR, q, q), right-hand
sides (NR, d) and (NR, q).

`arrow_half_logdet` is the differentiable (NR,) half log-det: a
torch.autograd.Function whose backward is the batched Takahashi selected
inverse plus the Schur-tail corrections, system r's cotangents scaled by
ct[r]. No operation mixes systems, so the gradient of the sum over r is
each system's own gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import band_batched as bb
from .band_arrow import SICK_INV, chol_jittered


def _solve_L(L, b):
    return torch.linalg.solve_triangular(L, b, upper=False)


def _solve_Lt(L, b):
    return torch.linalg.solve_triangular(L.mT, b, upper=True)


class BatchedFactor(NamedTuple):
    L: torch.Tensor      # (NR, d, bw+1) bands of the factors
    rinv: torch.Tensor   # (NR, d) 1 / L_r[j, j]
    Y: torch.Tensor      # (NR, d, q) L_r^{-1} C_r
    Ls: torch.Tensor     # (NR, q, q) lower Cholesky of the Schur tails
    hld_b: torch.Tensor  # (NR,) half log-det of the banded parts


class BandArrowBatchedEngine:
    """Factor / solve / half log-det of NR arrowheads of one shape
    (d, bw, q). `ops` is the table of batched band operations
    (band_batched.KERNELS by default; band_batched.PLAIN runs the plain
    versions on any device, for comparison)."""

    def __init__(self, d: int, bw: int, q: int, NR: int, ops=None):
        self.d, self.bw, self.q, self.NR = d, bw, q, NR
        self.ops = bb.KERNELS if ops is None else ops

    def with_ops(self, ops):
        return BandArrowBatchedEngine(self.d, self.bw, self.q, self.NR, ops)

    def factor(self, bands, C, Hd):
        with torch.no_grad():
            L, rinv, hld_b = self.ops.factor(bands.detach().contiguous())
            if self.q:
                Y = self.ops.fwd_solve(L, rinv, C.detach().contiguous())
                Ls = chol_jittered(Hd.detach() - Y.mT @ Y)
            else:
                Y, Ls = C.detach(), Hd.detach()
        return BatchedFactor(L, rinv, Y, Ls, hld_b)

    def half_logdet(self, f: BatchedFactor):
        return f.hld_b + torch.log(
            torch.diagonal(f.Ls, dim1=1, dim2=2)).sum(1)

    def solve(self, f: BatchedFactor, rb, rd):
        """H_r [zb_r; zd_r] = [rb_r; rd_r]; rb (NR, d), rd (NR, q)."""
        u = self.ops.fwd_solve(f.L, f.rinv, rb[:, :, None].contiguous())
        if self.q:
            rhs_d = rd[:, :, None] - f.Y.mT @ u
            zd = _solve_Lt(f.Ls, _solve_L(f.Ls, rhs_d))
            u = u - f.Y @ zd
            zd = zd[:, :, 0]
        else:
            zd = rd
        zb = self.ops.bwd_solve(f.L, f.rinv, u.contiguous())
        return zb[:, :, 0], zd

    def hld_backward(self, f: BatchedFactor, ct):
        """Cotangents of the (NR,) half log-dets for (bands, C, Hd) from
        ct (NR,): per system, Hinv_bb|band = Takahashi(Hb) + band(W S^{-1}
        W^T), Hinv_bd = -W S^{-1}, Hinv_dd = S^{-1}, with W = Hb^{-1} C."""
        NR, d, bw, q = self.NR, self.d, self.bw, self.q
        dt, dev = f.L.dtype, f.L.device
        hinv_band = self.ops.takahashi(f.L, f.rinv)         # (NR, d, bw+1)
        ct3 = ct[:, None, None]
        if q:
            Wm = self.ops.bwd_solve(f.L, f.rinv, f.Y.contiguous())
            eye = torch.eye(q, dtype=dt, device=dev).expand(NR, q, q)
            Sinv = _solve_Lt(f.Ls, _solve_L(f.Ls, eye))     # (NR, q, q)
            A = Wm @ Sinv                                    # (NR, d, q)
            corr = torch.zeros((NR, d, bw + 1), dtype=dt, device=dev)
            for o in range(bw + 1):
                corr[:, :d - o, o] = (A[:, o:] * Wm[:, :d - o]).sum(2)
            hinv_band = hinv_band + corr
            ct_C = -ct3 * A
            ct_Hd = (0.5 * ct3) * Sinv
        else:
            A = None
            ct_C = torch.zeros((NR, d, 0), dtype=dt, device=dev)
            ct_Hd = torch.zeros((NR, 0, 0), dtype=dt, device=dev)
        w = torch.ones((1, 1, bw + 1), dtype=dt, device=dev)
        w[0, 0, 0] = 0.5
        # sick-factor gate per system, as BandArrowEngine.hld_backward:
        # the identity on a healthy factor; a pivot-clamped system drops
        # its own cotangents and leaves its neighbours alone
        inf = torch.tensor(float("inf"), dtype=dt, device=dev)

        def biggest(x):
            return torch.where(torch.isfinite(x), x.abs(),
                               inf).flatten(1).max(1).values

        big = biggest(hinv_band)
        if A is not None:
            big = torch.maximum(big, biggest(A))
        okf = (big < SICK_INV).to(dt)[:, None, None]

        def san(x):
            return okf * torch.where(torch.isfinite(x), x,
                                     torch.zeros_like(x))
        return san(ct3 * w * hinv_band), san(ct_C), san(ct_Hd)

    def arrow_half_logdet(self, bands, C, Hd):
        """Differentiable (NR,) half log-dets of the arrowheads."""
        return _HalfLogdetBatched.apply(bands, C, Hd, self, None)

    def arrow_half_logdet_given(self, bands, C, Hd, f: BatchedFactor):
        """arrow_half_logdet with a precomputed factor of the same
        systems: the primal skips the factorization, the backward gives
        the same cotangents from `f`."""
        return _HalfLogdetBatched.apply(bands, C, Hd, self, f)


class _HalfLogdetBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bands, C, Hd, engine, f):
        if f is None:
            f = engine.factor(bands, C, Hd)
        ctx.engine, ctx.f = engine, f
        return engine.half_logdet(f)

    @staticmethod
    def backward(ctx, ct):
        g_band, g_C, g_Hd = ctx.engine.hld_backward(ctx.f, ct)
        return g_band, g_C, g_Hd, None, None
