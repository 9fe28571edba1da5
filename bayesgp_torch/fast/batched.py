"""Replicate backend for single-IWP models: R fits on one design in lock
step.

The batched counterpart of fast/iwp.FastIWPBackend for R responses on
the same design and one hyperparameter each (Poisson, Binomial). Where
parallel/replicates.replicate_fits runs one fit after another -- each a
chain of small kernels on a card that mostly waits for the host -- this
backend carries a leading replicate axis through every O(n) design
product and factors and solves all R arrowheads in one launch of the
batched band kernels (linalg/band_arrow_batched.BandArrowBatchedEngine on
K8-K11): every host launch is spread over R fits and the R band
recurrences run on R thread blocks at once.

Latent state: V (R, dpad), tail (R, q), theta (R,). The methods mirror
fast/iwp.py one to one, replicate by replicate; the O(n) products go
through the scalar backend's segment sums, which take any leading axes.
Everything is f64. No operation mixes replicates, so the gradient of a
sum over replicates is each replicate's own gradient.

Lock step is part of the result: in the inner Newton every replicate
keeps taking steps while any replicate is live, so a replicate's state
does not depend on a Python branch per replicate, only on (R,) tensors
and torch.where.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DTYPE
from ..linalg import band_batched as bb
from ..linalg.band_arrow_batched import BandArrowBatchedEngine
from .iwp import (LOG2PI, LS_NOISE, MAX_NEWTON, STALL_ITERS, STEPTOL,
                  _finite, design_gram, schur_gram)

# a replicate whose step has not fallen below this share of its best for
# STALL_ITERS iterations leaves the convergence condition
STALL_FACTOR = 0.95
# device memory one group of replicates may fill with O(n) temporaries
GROUP_BYTES = 16 * 2 ** 30


@dataclasses.dataclass
class BatchedFastIWP:
    """R-replicate view of a FastIWPBackend (shared design and prior)."""
    base: Any               # FastIWPBackend
    Y: torch.Tensor         # (R, n) responses, internal row order
    ll_const: torch.Tensor  # (R,) response-only log-likelihood constant
    engine: Any             # BandArrowBatchedEngine
    R: int

    def __post_init__(self):
        fam = self.md.family
        if fam not in (1, 2):
            raise ValueError(f"batched path: family {fam} unsupported")
        base, p = self.base, self.p
        # the design products every replicate shares: the pairs (a, b) of
        # design entries that meet on band offset o = a - b, and each
        # design entry with each tail column
        self._pairs = [(b + o, b) for o in range(p + 1)
                       for b in range(p + 1 - o)]
        a_idx, b_idx = (list(t) for t in zip(*self._pairs))
        self._pair_vals = base.valsT[a_idx] * base.valsT[b_idx]
        self._tail_vals = base.valsT[:, None, :] * base.XFpT[None]

    # -- statics forwarded from the base ---------------------------------
    @property
    def d(self):
        return self.base.d

    @property
    def dpad(self):
        return self.base.dpad

    @property
    def p(self):
        return self.base.p

    @property
    def q(self):
        return self.base.q

    @property
    def md(self):
        return self.base.md

    @property
    def device(self):
        return self.base.device

    @property
    def em_dims(self):
        return self.base.em_dims

    def init_state(self):
        return (torch.zeros((self.R, self.dpad), dtype=DTYPE,
                            device=self.device),
                torch.zeros((self.R, self.q), dtype=DTYPE,
                            device=self.device))

    # -- likelihood, replicate by replicate --------------------------------
    def _loglik(self, e):
        """(..., R, n) eta -> (..., R) log-likelihoods."""
        if self.md.family == 1:
            return (self.Y * e - torch.exp(e)).sum(-1) + self.ll_const
        softplus = torch.logaddexp(e, torch.zeros_like(e))
        return (self.Y * e - self.md.size * softplus).sum(-1) + self.ll_const

    def _dneg(self, e):
        """d(-loglik)/d eta, (R, n)."""
        if self.md.family == 1:
            return torch.exp(e) - self.Y
        return self.md.size * torch.sigmoid(e) - self.Y

    def _wts(self, e):
        if self.md.family == 1:
            return torch.exp(e)
        pr = torch.sigmoid(e)
        return self.md.size * pr * (1.0 - pr)

    # -- O(n) design products ------------------------------------------------
    def eta(self, Vp, tail):
        """(R, n) linear predictors B V'_r + XFp t_r."""
        return _EtaBatched.apply(Vp, tail, self)

    def Bt(self, u):
        """B^T u_r: (R, n) -> (R, dpad)."""
        base = self.base
        sp = base._shifts(base._segsum(base.valsT * u[:, None, :]))
        return sum(base._at(sp[:, a], a) for a in range(self.p + 1))

    def band_H(self, wts, theta):
        """(R, dpad, p+1) lower bands of B^T diag(wts_r) B + e^theta_r P_V,
        identity beyond d."""
        base, p = self.base, self.p
        # (R, pairs, n): only the (p+1)(p+2)/2 products a band needs
        Mp = base._shifts(base._segsum(wts[:, None, :] * self._pair_vals))
        band = torch.stack([sum(base._at(Mp[:, i], b)
                                for i, (a, b) in enumerate(self._pairs)
                                if a - b == o)
                            for o in range(p + 1)], dim=2)
        prior = F.pad(base.P_band.T, (0, 0, 0, self.dpad - self.d))
        return (band + torch.exp(theta)[:, None, None] * prior
                + base._pad_eye)

    def C_block(self, wts, theta):
        """(R, dpad, q) cross blocks B^T diag(wts_r) XFp - e^theta_r P Z0."""
        base = self.base
        if not self.q:
            return wts.new_zeros((self.R, self.dpad, 0))
        Mp = base._shifts(base._segsum(
            wts[:, None, None, :] * self._tail_vals))   # (R, p+1, q, n)
        C = sum(base._at(Mp[:, a], a) for a in range(self.p + 1)).mT
        corr = F.pad(base.PZ0, (0, 0, 0, self.dpad - self.d))
        return C - torch.exp(theta)[:, None, None] * corr

    # -- prior --------------------------------------------------------------
    def _prior_neg(self, Vp, tail, theta):
        """(R,) non-likelihood parts of the joint negative log
        posteriors; the prior quadratics are sums of squares
        (FastIWPBackend.prior_quad)."""
        base = self.base
        lp = -0.5 * torch.exp(theta) * base.prior_quad(base.to_V(Vp, tail))
        lp = lp + 0.5 * (self.d * theta + base._logPdet0)
        if self.q:
            lp = lp - 0.5 * (base.prior_diag_tail
                             * (tail - base.prior_mean_tail) ** 2).sum(1)
        phi = base._phi
        lpT = (torch.log(0.5 * phi).sum() - phi.sum() * torch.exp(-0.5 * theta)
               - 0.5 * theta)
        return -(lp + lpT)

    def grad_W(self, Vp, tail, theta, eta=None):
        base = self.base
        e = self.eta(Vp, tail) if eta is None else eta
        r = self._dneg(e)
        pv = (torch.exp(theta)[:, None]
              * base.prior_grad(base.to_V(Vp, tail)))
        gV = self.Bt(r) + F.pad(pv, (0, self.dpad - self.d))
        if self.q:
            gt = (r @ base.XFpT.T - pv @ base.Z0
                  + base.prior_diag_tail * (tail - base.prior_mean_tail))
        else:
            gt = tail.new_zeros((self.R, 0))
        return gV, gt

    # -- Hessian --------------------------------------------------------------
    def _assemble_scaled(self, V, tail, theta, eta=None):
        """Jacobi-equilibrated arrowheads at (V, tail): (band_s, C_s, Hd_s,
        sc, sd, wts) with H~_r = S_r H_r S_r, S_r = diag(sc_r, sd_r), and
        wts the likelihood weights."""
        base = self.base
        e = self.eta(V, tail) if eta is None else eta
        wts = self._wts(e)
        band = self.band_H(wts, theta)
        C = self.C_block(wts, theta)
        if self.q:
            Hd = (design_gram(base.XFpT, wts)
                  + torch.exp(theta)[:, None, None] * base.Z0PZ0
                  + torch.diag(base.prior_diag_tail))
            sd = torch.rsqrt(torch.diagonal(Hd, dim1=1, dim2=2))
            Hd = Hd * sd[:, :, None] * sd[:, None, :]
        else:
            Hd = V.new_zeros((self.R, 0, 0))
            sd = V.new_zeros((self.R, 0))
        sc = torch.rsqrt(band[:, :, 0])                     # (R, dpad)
        sc_pad = F.pad(sc, (0, self.p), value=1.0)
        sc_off = torch.stack([sc_pad[:, o:o + self.dpad]
                              for o in range(self.p + 1)], dim=2)
        band_s = band * sc[:, :, None] * sc_off
        C_s = C * sc[:, :, None] * sd[:, None, :] if self.q else C
        return band_s, C_s, Hd, sc, sd, wts

    def _tail_schur(self, L, rinv, Y, sc, sd, wts, theta):
        """(R, q, q) Schur tails of the equilibrated arrowheads, sd_r S_r
        sd_r: fast/iwp.schur_gram, the one-response engine's function, on
        all R systems (never Hd - Y^T Y, which cancels where the prior
        pins the driver); differentiable in wts and theta."""
        base = self.base
        with torch.no_grad():
            Wt = (self.engine.ops.bwd_solve(L, rinv, Y.contiguous())
                  * sc[:, :, None] / sd[:, None, :]).mT    # (R, q, dpad)
        S = schur_gram(base, Wt, wts, theta,
                       torch.diag(base.prior_diag_tail))
        return S * sd[:, :, None] * sd[:, None, :]

    def _factor_scaled(self, band_s, C_s, sc, sd, wts, theta):
        def schur(L, rinv, Y):
            return self._tail_schur(L, rinv, Y, sc, sd, wts, theta)
        return self.engine.factor(band_s, C_s, schur)

    def hessian_factor(self, V, tail, theta, eta=None):
        band_s, C_s, Hd, sc, sd, wts = self._assemble_scaled(
            V, tail, theta, eta=eta)
        return (self._factor_scaled(band_s, C_s, sc, sd, wts, theta),
                sc, sd)

    def solve_H(self, factor, gV, gt):
        af, sc, sd = factor
        zb, zd = self.engine.solve(af, gV * sc, gt * sd)
        return zb * sc, zd * sd

    def half_logdet_H(self, factor):
        af, sc, sd = factor
        return (self.engine.half_logdet(af) - torch.log(sc).sum(1)
                - torch.log(sd).sum(1))

    # -- inner Newton ---------------------------------------------------------
    @torch.no_grad()
    def newton_step(self, V, tail, theta, eta_cap=8.0):
        """fast/iwp.newton_step for every replicate at once: a capped step
        per replicate and the backtracking candidates of all replicates on
        one (5, R, n) likelihood pass. Returns (V', tail', max|step| as
        (R,))."""
        e0 = self.eta(V, tail)
        gV, gt = self.grad_W(V, tail, theta, eta=e0)
        factor = self.hessian_factor(V, tail, theta, eta=e0)
        step_V, step_t = self.solve_H(factor, gV, gt)
        # a non-finite step entry would stay in a warm-started chain for
        # good; the raw max below still sees an overflowed direction and
        # drives its alpha to 0
        step_V, step_t = _finite(step_V), _finite(step_t)
        d_eta = self.eta(step_V, step_t)
        max_de = d_eta.abs().amax(1)                        # (R,)
        d_eta = _finite(d_eta)
        alpha0 = torch.clamp(eta_cap / torch.clamp(max_de, min=1e-30),
                             max=1.0)
        cands = alpha0 * torch.tensor([1.0, 0.3, 0.1, 0.03], dtype=DTYPE,
                                      device=self.device)[:, None]  # (4, R)
        alphas = torch.cat([torch.zeros_like(alpha0)[None], cands])  # (5, R)
        etas = e0 - alphas[:, :, None] * d_eta
        lls = self._loglik(etas)                            # (5, R)
        # the prior part is an exact quadratic in alpha
        p_0 = self._prior_neg(V, tail, theta)
        p_p = self._prior_neg(V - step_V, tail - step_t, theta)
        p_m = self._prior_neg(V + step_V, tail + step_t, theta)
        c2 = 0.5 * (p_p + p_m) - p_0
        c1 = 0.5 * (p_p - p_m)
        fall = -lls + (p_0 + c1 * alphas + c2 * alphas ** 2)
        f0 = fall[0]
        fs = torch.where(torch.isnan(fall[1:]),
                         torch.full_like(fall[1:], math.inf), fall[1:])
        fbest = fs.amin(0)
        noise = LS_NOISE * (1.0 + f0.abs())
        # the largest alpha within noise of the best, per replicate
        idx = (fs <= fbest + noise).to(torch.int8).argmax(0)
        cand_alpha = cands.gather(0, idx[None])[0]
        alpha = torch.where(fbest <= f0 + noise, cand_alpha, 0.01 * alpha0)
        smax = step_V.abs().amax(1)
        if self.q:
            smax = torch.maximum(smax, step_t.abs().amax(1))
        return (V - alpha[:, None] * step_V, tail - alpha[:, None] * step_t,
                smax)

    @torch.no_grad()
    def newton_solve(self, theta, max_iter=MAX_NEWTON, warm=None):
        """Inner Newton in lock step: every replicate steps while any is
        live. A replicate is live until its max|H^{-1} g| falls below
        STEPTOL (1 + max|V_r|) or its step has not improved by 5% for
        STALL_ITERS steps. One device-to-host read an iteration."""
        if warm is None:
            V, tail = self.init_state()
        else:
            V, tail = warm
            # a non-finite warm replicate would never recover: cold-start it
            okr = torch.isfinite(V.sum(1) + tail.sum(1))[:, None]
            V = torch.where(okr, V, torch.zeros_like(V))
            tail = torch.where(okr, tail, torch.zeros_like(tail))
        smax = torch.full((self.R,), 1e30, dtype=DTYPE, device=self.device)
        best = smax.clone()
        since = torch.zeros(self.R, dtype=torch.int64, device=self.device)
        for _ in range(max_iter):
            small = smax < STEPTOL * (1.0 + V.abs().amax(1))
            live = ~(small | (since >= STALL_ITERS))
            if not bool(live.any()):
                break
            V, tail, smax = self.newton_step(V, tail, theta)
            improved = smax < STALL_FACTOR * best
            best = torch.minimum(best, smax)
            since = torch.where(improved, torch.zeros_like(since), since + 1)
        return V, tail

    @torch.no_grad()
    def _refine(self, V, tail, theta, eta_cap=8.0):
        e0 = self.eta(V, tail)
        gV, gt = self.grad_W(V, tail, theta, eta=e0)
        factor = self.hessian_factor(V, tail, theta, eta=e0)
        step_V, step_t = self.solve_H(factor, gV, gt)
        step_V, step_t = _finite(step_V), _finite(step_t)
        d_eta = self.eta(step_V, step_t)
        alpha = torch.clamp(
            eta_cap / torch.clamp(d_eta.abs().amax(1), min=1e-30), max=1.0)
        alpha = _finite(alpha)[:, None]
        return V - alpha * step_V, tail - alpha * step_t

    def solve_W_star(self, theta, n_refine=1, warm=None):
        theta = theta.detach()
        V, tail = self.newton_solve(theta, warm=warm)
        for _ in range(n_refine):
            V, tail = self._refine(V, tail, theta)
        return V, tail

    # -- Laplace values ---------------------------------------------------------
    def _laplace_value(self, V, tail, theta, factor=None):
        """(R,) Laplace values F(W_r, theta_r), differentiable in (V, tail,
        theta); see fast/iwp._laplace_value. `factor`: a hessian_factor at
        the same point, whose factorization the primal then reuses."""
        e0 = self.eta(V, tail)
        band_s, C_s, Hd, sc, sd, wts = self._assemble_scaled(
            V, tail, theta, eta=e0)
        # the tails' scale cancels from 0.5 log|sd S sd| - sum log sd
        sd = sd.detach()
        if factor is None:
            af = self._factor_scaled(band_s, C_s, sc.detach(), sd,
                                     wts.detach(), theta.detach())
        else:
            af = factor[0]
        S_s = (self._tail_schur(af.L, af.rinv, af.Y, sc.detach(), sd, wts,
                                theta) if self.q else Hd)
        hld = self.engine.schur_half_logdet(band_s, S_s, af)
        half_logdet = hld - torch.log(sc).sum(1) - torch.log(sd).sum(1)
        f = -self._loglik(e0) + self._prior_neg(V, tail, theta)
        return (f + half_logdet - 0.5 * (self.d + self.q) * LOG2PI
                - self.base.logdetT)

    def _laplace_value_direct(self, V, tail, theta, factor, eta=None):
        """(R,) Laplace values from a precomputed factor (primal only)."""
        e0 = self.eta(V, tail) if eta is None else eta
        f = -self._loglik(e0) + self._prior_neg(V, tail, theta)
        return (f + self.half_logdet_H(factor)
                - 0.5 * (self.d + self.q) * LOG2PI - self.base.logdetT)

    @torch.no_grad()
    def laplace_eval_full(self, theta, warm):
        """((R,) nll, (V, tail), factor) of one quadrature node a
        replicate."""
        V, tail = self.solve_W_star(theta, warm=warm)
        e0 = self.eta(V, tail)
        factor = self.hessian_factor(V, tail, theta, eta=e0)
        val = self._laplace_value_direct(V, tail, theta, factor, eta=e0)
        return val, (V, tail), factor

    def nll_warm(self, theta, warm):
        """((R,) Laplace marginal nlls, (V, tail)), differentiable in
        theta (R,) by the implicit function theorem, warm-started."""
        V0, t0 = warm
        theta = torch.as_tensor(theta, dtype=DTYPE, device=self.device)
        val, V, tail = _BatchedLaplaceNLL.apply(theta, V0, t0, self)
        return val, (V, tail)

    def value_and_grad(self, theta, warm):
        """((R,) nll, (R,) d nll_r / d theta_r, (V, tail)): one batched
        Laplace solve; the gradient of the sum over replicates is the
        vector of per-replicate gradients."""
        th = torch.as_tensor(theta, dtype=DTYPE, device=self.device)
        th = th.detach().clone().requires_grad_(True)
        val, st = self.nll_warm(th, warm)
        (g,) = torch.autograd.grad(val.sum(), th)
        return val.detach(), g, st


class _EtaBatched(torch.autograd.Function):
    """eta_r = B V'_r + XFp t_r by a gather of V'_r at each row's columns;
    its backward is B^T (segment sums) rather than a scatter-add."""

    @staticmethod
    def forward(ctx, Vp, tail, be):
        ctx.be = be
        base = be.base
        e = (base.valsT * Vp[:, base._cols]).sum(1)
        if be.q:
            e = e + tail @ base.XFpT
        return e

    @staticmethod
    def backward(ctx, ct):
        be = ctx.be
        g_t = ct @ be.base.XFpT.T if be.q else ct.new_zeros((be.R, 0))
        return be.Bt(ct), g_t, None


class _BatchedLaplaceNLL(torch.autograd.Function):
    """(R,) Laplace nlls with their implicit-function theta gradients,
    replicate by replicate: dnll/dth = dF/dth - (dg/dth)^T H^{-1} dF/dW at
    the inner mode W*, taken as gradients of sums over replicates."""

    @staticmethod
    def forward(ctx, theta, V0, t0, be):
        V, tail = be.solve_W_star(theta, warm=(V0, t0))
        e0 = be.eta(V, tail)
        factor = be.hessian_factor(V, tail, theta, eta=e0)
        val = be._laplace_value_direct(V, tail, theta, factor, eta=e0)
        ctx.be, ctx.factor = be, factor
        ctx.save_for_backward(theta, V, tail)
        ctx.mark_non_differentiable(V, tail)
        return val, V, tail

    @staticmethod
    def backward(ctx, ct_val, _ct_V, _ct_t):
        be, factor = ctx.be, ctx.factor
        theta, V, tail = ctx.saved_tensors
        with torch.enable_grad():
            V_ = V.detach().requires_grad_(True)
            t_ = tail.detach().requires_grad_(True)
            th_ = theta.detach().requires_grad_(True)
            Fsum = be._laplace_value(V_, t_, th_, factor=factor).sum()
            gF_V, gF_t, gF_th = torch.autograd.grad(
                Fsum, (V_, t_, th_), allow_unused=True)
            gF_t = torch.zeros_like(tail) if gF_t is None else gF_t
            gF_V, gF_t = _finite(gF_V), _finite(gF_t)
            with torch.no_grad():
                vV, vt = be.solve_H(factor, gF_V, gF_t)
            vV, vt = _finite(vV), _finite(vt)
            th2 = theta.detach().requires_grad_(True)
            gV, gt = be.grad_W(V, tail, th2)
            gdotv = (gV * vV).sum()
            if be.q:
                gdotv = gdotv + (gt * vt).sum()
            (term2,) = torch.autograd.grad(gdotv, th2)
        return (gF_th - term2) * ct_val, None, None, None


def ll_const_np(base, ys_internal):
    """(R,) response-only log-likelihood constants as host numpy:
    -sum lgamma(y + 1) (Poisson), sum log C(size, y) (Binomial)."""
    fam = base.md.family
    Y = torch.as_tensor(np.asarray(ys_internal, np.float64))
    if fam == 1:
        return -torch.lgamma(Y + 1.0).sum(1).numpy()
    if fam == 2:
        size = base.md.size.detach().cpu()
        return (torch.lgamma(size + 1.0) - torch.lgamma(Y + 1.0)
                - torch.lgamma(size - Y + 1.0)).sum(1).numpy()
    raise ValueError(f"batched path: family {fam} unsupported")


def make_engine_batched(base, R: int, force_engine: str = None):
    """The arrowhead engine of R replicates. force_engine: None or
    "kernels" (the CUDA kernels on a card, their plain versions on the
    CPU) | "plain" (the plain versions on any device)."""
    if force_engine not in (None, "kernels", "plain"):
        raise ValueError(f"unknown force_engine {force_engine!r}")
    ops = bb.PLAIN if force_engine == "plain" else bb.KERNELS
    return BandArrowBatchedEngine(base.dpad, base.p, base.q, R, ops)


def make_batched(base, Y_internal, ll_const, R: int, engine):
    """BatchedFastIWP from (R, n) internal-order responses and their (R,)
    log-likelihood constants."""
    if base.n_theta != 1:
        raise ValueError("batched path supports 1 hyperparameter "
                         "(elementwise non-Gaussian families)")
    dev = base.device
    return BatchedFastIWP(
        base=base,
        Y=torch.as_tensor(np.asarray(Y_internal, np.float64), dtype=DTYPE,
                          device=dev).contiguous(),
        ll_const=torch.as_tensor(np.asarray(ll_const, np.float64),
                                 dtype=DTYPE, device=dev),
        engine=engine, R=R)


def build_batched(base, ys_raw, force_engine: str = None):
    """BatchedFastIWP from a FastIWPBackend and (R, n) raw-order
    responses. force_engine as make_engine_batched."""
    ys_raw = np.asarray(ys_raw)
    R = ys_raw.shape[0]
    ys_int = ys_raw[:, np.asarray(base.row_order)]
    return make_batched(base, ys_int, ll_const_np(base, ys_int), R,
                        make_engine_batched(base, R, force_engine))


def max_replicates(p: int, n: int, q: int = 0) -> int:
    """Most replicates one batch should hold at IWP order p, n rows and q
    tail columns: a memory cap. (The JAX package's cap is the TPU's lane
    groups, 16 at p <= 3; nothing like it binds here.)

    Reckoned from the batched O(n) f64 temporaries of one Hessian assembly
    under autograd, per replicate: the (p+1)(p+2)/2 weighted design
    products behind band_H, their prefix sum and a third copy for
    autograd (3 (p+1)(p+2)/2 n), the same three for the (p+1) q products
    behind C_block, the (p + 3) q behind the Gram Schur tail (its p + 1
    gathers, the residuals and their copy for autograd), the (5, n)
    line-search etas with their exponentials and products (15 n), and
    about ten (n,) vectors (eta, weights, residual, gathers). The group
    may fill GROUP_BYTES (16 GiB, a fifth of an 80 GB card). At p = 3,
    q = 4, n = 1e5 that is 102 MB a replicate and a cap of 169."""
    per_rep = 8 * n * (3 * (p + 1) * (p + 2) // 2 + 3 * (p + 1) * q
                       + (p + 3) * q + 25)
    return max(1, GROUP_BYTES // per_rep)
