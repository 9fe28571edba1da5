"""NR arrowhead SPD systems factored and solved together on the batched
band kernels.

The batched counterpart of band_arrow.BandArrowEngine: NR independent

    H_r = [[Hb_r (band, bw small), C_r], [C_r^T, Hd_r (dense q x q)]]

of one shape (d, bw, q). The banded parts go through the kernels of
band_batched.py in one launch each (K8 factor, K9 for Y_r = L_r^{-1} C_r
and the forward solves, K10 backward solves, K11 selected inverse); the
small dense Schur tails are batched torch.linalg calls. The caller forms
each tail S_r itself and passes it to `factor` as `schur` (fast/batched.py
forms it as a Gram of least-squares residuals, as fast/iwp.py does for one
system: Hd_r - Y_r^T Y_r would cancel where the prior pins the driver).
Bands are (NR, d, bw+1), C (NR, d, q), S (NR, q, q), right-hand sides
(NR, d) and (NR, q).

`schur_half_logdet` is the differentiable (NR,) half log-det 0.5 log|Hb_r|
+ 0.5 log|S_r|: a torch.autograd.Function whose backward gives the band
the cotangent 0.5 Takahashi(Hb_r) (the batched selected inverse) and S_r
0.5 S_r^{-1}, system r's scaled by ct[r]; the tails' derivative is taken
through the caller's S. No operation mixes systems, so the gradient of the
sum over r is each system's own gradient. The sick-factor gate is
BandArrowEngine's, system by system.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import band_batched as bb
from .band_arrow import chol_jittered


def _solve_L(L, b):
    return torch.linalg.solve_triangular(L, b, upper=False)


def _solve_Lt(L, b):
    return torch.linalg.solve_triangular(L.mT, b, upper=True)


def _finite(x):
    """(NR,) bool: every entry of system r's slice of x is finite."""
    return torch.isfinite(x).flatten(1).all(1)


class BatchedFactor(NamedTuple):
    L: torch.Tensor      # (NR, d, bw+1) bands of the factors
    rinv: torch.Tensor   # (NR, d) 1 / L_r[j, j]
    Y: torch.Tensor      # (NR, d, q) L_r^{-1} C_r
    Ls: torch.Tensor     # (NR, q, q) lower Cholesky of the Schur tails
    hld_b: torch.Tensor  # (NR,) half log-det of the banded parts
    clamped: torch.Tensor    # (NR,) bool: K8 clamped a pivot of system r
    tail_left: torch.Tensor  # (NR,) bool: system r's tail left the plain
    #                          route of chol_jittered


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

    def factor(self, bands, C, schur):
        """BatchedFactor of the arrowheads whose Schur tails are
        schur(L, rinv, Y) (NR, q, q), with Y = L^{-1} C (not called where
        q = 0)."""
        with torch.no_grad():
            L, rinv, hld_b, clamped = self.ops.factor(
                bands.detach().contiguous())
            if self.q:
                Y = self.ops.fwd_solve(L, rinv, C.detach().contiguous())
                Ls, left = chol_jittered(schur(L, rinv, Y).detach())
            else:
                Y, left = C.detach(), torch.zeros_like(clamped)
                Ls = C.new_zeros((self.NR, 0, 0))
        return BatchedFactor(L, rinv, Y, Ls, hld_b, clamped, left)

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

    def _tail_inverse(self, f: BatchedFactor):
        """(NR, q, q) S_r^{-1} from the tail factors."""
        eye = torch.eye(self.q, dtype=f.L.dtype, device=f.L.device)
        return _solve_Lt(f.Ls, _solve_L(f.Ls, eye.expand(self.NR, -1, -1)))

    def _gated(self, f: BatchedFactor, ct, hinv_band, tail):
        """(ct times 0.5 hinv_band on the bands' diagonals and hinv_band
        off them, then c * ct * x for each (c, x) of `tail`), system r's
        all zero where its factor is sick. The sick-factor gate of
        BandArrowEngine, system by system: the identity on a healthy
        factor; a system whose pivot clamped, whose tail left its plain
        route or whose hinv_band or tail entries are not finite drops its
        own cotangents and leaves its neighbours alone."""
        dt, dev = f.L.dtype, f.L.device
        ct3 = ct[:, None, None]
        finite = _finite(hinv_band)
        for _, x in tail:
            finite = finite & _finite(x)
        w = torch.ones((1, 1, self.bw + 1), dtype=dt, device=dev)
        w[0, 0, 0] = 0.5
        okf = (~(f.clamped | f.tail_left) & finite).to(dt)[:, None, None]

        def san(x):
            return okf * torch.where(torch.isfinite(x), x,
                                     torch.zeros_like(x))
        return (san(ct3 * w * hinv_band),) + tuple(
            san((c * ct3) * x) for c, x in tail)

    def schur_backward(self, f: BatchedFactor, ct):
        """Cotangents of schur_half_logdet for (bands, S): ct times 0.5
        Takahashi(Hb) on the bands' diagonals and Takahashi(Hb) off them,
        and 0.5 ct S^{-1}; _gated."""
        hinv_band = self.ops.takahashi(f.L, f.rinv)
        if not self.q:
            return (self._gated(f, ct, hinv_band, ())[0],
                    hinv_band.new_zeros((self.NR, 0, 0)))
        return self._gated(f, ct, hinv_band,
                           ((0.5, self._tail_inverse(f)),))

    def schur_half_logdet(self, bands, S, f: BatchedFactor):
        """Differentiable (NR,) half log-dets from the bands and the Schur
        tails S (NR, q, q), given their factor f (factor(..., schur=...)):
        0.5 log|Hb_r| + 0.5 log|S_r|, the tails' derivative taken through
        S."""
        return _SchurHalfLogdetBatched.apply(bands, S, self, f)


class _SchurHalfLogdetBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bands, S, engine, f):
        ctx.engine, ctx.f = engine, f
        return engine.half_logdet(f)

    @staticmethod
    def backward(ctx, ct):
        g_band, g_S = ctx.engine.schur_backward(ctx.f, ct)
        return g_band, g_S, None, None

