"""Arrowhead (banded + dense tail) SPD linear algebra on the band kernels.

The conditional Hessian of a single-IWP model has the form

    H = [[Hb (band, bw small), C], [C^T, Hd (dense q x q)]]

BandArrowEngine factors it with the band kernels of band_kernels.py
(K1 factor with the fused Y = L^{-1} C, K2/K3 solves, K5 draws, K4
selected inverse) and the dense Schur tail S = Hd - C^T Hb^{-1} C, which
the caller forms and passes to `factor` as `schur` (fast/iwp.py forms it
as a Gram of least-squares residuals, which no cancellation enters; Hd -
Y^T Y cancels where the prior pins the driver). S factors with
torch.linalg below DENSE_TAIL_MIN columns, and from there on with the
blocked dense Cholesky of chol_dense.py (K6/K7), as the JAX package's
small_chol routes tails of 256 columns and more. Bands are (d, bw+1)
with row j, column o holding Hb[j+o, j].

`schur_half_logdet` is the differentiable half log-det 0.5 log|H| = 0.5
log|Hb| + 0.5 log|S|: a torch.autograd.Function whose backward gives the
band the cotangent 0.5 Takahashi(Hb) (the selected inverse) and S 0.5
S^{-1}; the tail's derivative is taken through the caller's S, and the
backward never differentiates through the factorization recurrence.

The backward's sick-factor gate drops those cotangents only where the
factor is sick: K1 clamped a band pivot, the tail factor left its plain
route (chol_jittered added jitter or took its diagonal surrogate, or K6
clamped a pivot on the dense route), or an entry of H^{-1} that the
backward reads is not finite. On a healthy factor it is the identity,
with no cutoff on |H^{-1}|: the JAX package's CPU-f64 engine
(BlockEngine) has no gate at all.
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


def _chol_ok(S):
    L, info = torch.linalg.cholesky_ex(S)
    return (info == 0) & torch.isfinite(
        torch.diagonal(L, dim1=-2, dim2=-1)).all(-1)


def chol_jittered(S):
    """(L, left) for (..., q, q) S: the lower Cholesky factor with failure
    escalation, matrix by matrix: plain -> + jitter * scale * I -> a
    diagonal surrogate that always factors, and left (...,) bool, whether
    a matrix left the plain route. A healthy matrix factors exactly as it
    is. Branchless (no host synchronisation)."""
    q = S.shape[-1]
    eye = torch.eye(q, dtype=S.dtype, device=S.device)
    Ssg = S.detach()
    diag = torch.diagonal(S, dim1=-2, dim2=-1)
    scale = torch.clamp(diag.detach().abs().mean(-1), min=1e-30)
    ok0 = _chol_ok(Ssg)
    jit = torch.where(ok0, torch.zeros_like(scale),
                      CHOL_JITTER * scale)[..., None, None]
    ok1 = _chol_ok(Ssg + jit * eye)[..., None, None]
    dsafe = torch.maximum(diag.abs(), 1e-8 * scale[..., None])
    Sfin = torch.where(ok1, S + jit * eye, eye * dsafe[..., None, :])
    return torch.linalg.cholesky_ex(Sfin)[0], ~ok0


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
    clamped: torch.Tensor    # () bool: K1 clamped a band pivot
    tail_left: torch.Tensor  # () bool: the tail factor left its plain
    #                          route (jitter, surrogate or a K6 clamp)


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
        """(factor, whether it left its plain route) of the Schur tail."""
        if self.dense_tail:
            flag = torch.zeros((), dtype=torch.int32, device=S.device)
            return chol_dense.cholesky_blocked(S, flag=flag), flag != 0
        return chol_jittered(S)

    def _tail_solve_L(self, Ls, b):
        if self.dense_tail:
            return chol_dense.solve_lower_blocked(Ls, b)
        return _solve_L(Ls, b)

    def _tail_solve_Lt(self, Ls, b):
        if self.dense_tail:
            return chol_dense.solve_lower_t_blocked(Ls, b)
        return _solve_Lt(Ls, b)

    def factor(self, band, C, schur):
        """BandFactor of the arrowhead whose band is `band`, whose cross
        block is C and whose Schur tail is schur(L, rinv, Y) (q, q), with
        Y = L^{-1} C (not called where q = 0). Where K1 clamped a pivot, Y
        is K2's solve, without K1's cap on |Y|: the replicate engine's Y
        (K9) has no cap, and a capped Y gives the tail of another matrix,
        so both engines' tails stay one function of (L, C). On a healthy
        equilibrated factor |Y| <= 1, the cap never binds and the two
        solves are the same bits. On a card K2 reads K1's flag on the
        device (a host read would stall the launch queue) and returns at
        once where it is clear."""
        with torch.no_grad():
            band = band.detach().contiguous()
            C = C.detach().contiguous()
            L, rinv, Y, hld_b, clamped = self.ops.factor(band, C)
            if self.q:
                Y = self.ops.fwd_solve_gated(clamped, L, rinv, C, Y)
                Ls, left = self._tail_chol(schur(L, rinv, Y).detach())
            else:
                Ls = C.new_zeros((0, 0))
                left = torch.zeros_like(clamped)
        return BandFactor(L, rinv, Y, Ls, hld_b, clamped, left)

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

    def _tail_inverse(self, f: BandFactor):
        """S^{-1} from the tail factor; None when q = 0."""
        if not self.q:
            return None
        eye = torch.eye(self.q, dtype=f.L.dtype, device=f.L.device)
        return self._tail_solve_Lt(f.Ls, self._tail_solve_L(f.Ls, eye))

    def gate_reasons(self, f: BandFactor):
        """Why schur_half_logdet's backward would drop its cotangents for
        f, as 0-d bool tensors: (K1 clamped a band pivot, the tail factor
        left its plain route, an entry of Takahashi(Hb) or S^{-1} is not
        finite). The gate is closed where any of them holds."""
        return (f.clamped, f.tail_left,
                ~_finite(self.ops.takahashi(f.L, f.rinv),
                         self._tail_inverse(f)))

    def _gated(self, f: BandFactor, ct, hinv_band, tail):
        """(ct times 0.5 hinv_band on the band's diagonal and hinv_band
        off it, then the `tail` cotangents as given), all zero on a sick
        factor: K1 clamped a pivot, the tail factor left its plain route,
        or an entry of hinv_band or `tail` is not finite. The sick-factor
        gate: the identity on a healthy factor; on a sick one the
        selected inverse is that of another matrix, and the value's
        explicit gradient remains."""
        dt, dev = f.L.dtype, f.L.device
        w = torch.ones((1, self.bw + 1), dtype=dt, device=dev)
        w[0, 0] = 0.5
        okf = (~(f.clamped | f.tail_left)
               & _finite(hinv_band, *tail)).to(dt)

        def san(x):
            return okf * torch.where(torch.isfinite(x), x,
                                     torch.zeros_like(x))
        return (san(ct * w * hinv_band),) + tuple(san(x) for x in tail)

    def schur_backward(self, f: BandFactor, ct):
        """Cotangents of schur_half_logdet for (band, S): ct times 0.5
        Takahashi(Hb) on the band's diagonal and Takahashi(Hb) off it, and
        0.5 ct S^{-1} (_gated)."""
        hinv_band = self.ops.takahashi(f.L, f.rinv)
        if not self.q:
            return (self._gated(f, ct, hinv_band, ())[0],
                    hinv_band.new_zeros((0, 0)))
        return self._gated(f, ct, hinv_band,
                           ((0.5 * ct) * self._tail_inverse(f),))

    def schur_half_logdet(self, band, S, f: BandFactor):
        """Differentiable half log-det of the arrowhead from its band and
        its Schur tail S, given their factor f (factor(..., schur=...)):
        0.5 log|Hb| + 0.5 log|S|. Where S is a differentiable function of
        the model's parameters, the tail's derivative is taken through it
        rather than through the blocks C and Hd."""
        return _SchurHalfLogdet.apply(band, S, self, f)


def _finite(*parts):
    """0-d bool: every entry of the given tensors (None skipped) is
    finite."""
    ok = torch.ones((), dtype=torch.bool, device=parts[0].device)
    for x in parts:
        if x is not None:
            ok = ok & torch.isfinite(x).all()
    return ok


class _SchurHalfLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, band, S, engine, f):
        ctx.engine, ctx.f = engine, f
        return engine.half_logdet(f)

    @staticmethod
    def backward(ctx, ct):
        g_band, g_S = ctx.engine.schur_backward(ctx.f, ct)
        return g_band, g_S, None, None
