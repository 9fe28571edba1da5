"""Scattered large-q IID backend: diagonal-first Schur elimination.

Model class: one IWP smooth + fixed effects + one IID random effect with
many levels (subjects of a longitudinal study, observation-level
overdispersion), whose levels may scatter over the smooth's axis. The
conditional Hessian in latent order (u | V' | t) is

    H = [[ D (diagonal),  K        ],          K = [C_vu^T  C_ut]
         [ K^T,           M (arrow)]]

with D = diag(per-level weight sums) + e^{theta_iid} I: an IID term's
design is an indicator and its precision the identity. Eliminating u
first is exact and leaves the dense (dpad + q_f) Schur complement

    S = M - K^T D^{-1} K,

factored by the blocked dense Cholesky of linalg/chol_dense (the block
kernels K6/K7 on a card, their plain versions on the CPU; the Schur
product K^T D^{-1} K is one f64 matrix product). Every Laplace quantity
reduces to D and dense (dpad + q_f) operations:

    log det H  = sum log D + 2 sum log diag chol(S)
    H z = g    : z_vt = S^{-1}(g_vt - K^T D^{-1} g_u),
                 z_u  = D^{-1}(g_u - K z_vt)
    x ~ N(0, H^-1): x_vt = L_S^{-T} z_vt, x_u = D^{-1/2} z_u - D^{-1} K x_vt

The smooth and fixed-effect structure (eta, band and cross assembly,
priors, the orthogonalized tail) is fast/iwp.FastIWPBackend's, built on
the model without the IID term. The level products (per-level weight
sums, the cross blocks C_vu (dpad, q) and C_ut (q, q_f), and the per-level
sums of a row vector) are deterministic segment sums: the rows, or the
(row, basis entry) pairs, are sorted once at build by their (column,
level) cell, and each cell's run is summed by a difference of an f64
prefix sum. No atomics and no look-back scan, so every run sums in the
same order; the backward of each is a gather.

theta layout: [theta_IWP, theta_IID]; the core sees [theta_IWP]. The
JAX package's one-hot chunk scan, its split-f32 Schur product and its
fused s>1 programs are TPU devices and are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..linalg import chol_dense
from ..model import families
from . import iwp

LOG2PI = math.log(2.0 * math.pi)


class CellPlan(NamedTuple):
    """Sums of entries into cells, fixed at build: `perm` sorts the
    entries by cell, runs of one cell are [lo, hi) in that order, stored
    as prefix-sum positions (hi - 1, lo - 1) with masks for empty
    prefixes; run_cell is each run's cell, entry_cell each entry's."""
    perm: torch.Tensor
    hi_prev: torch.Tensor
    lo_prev: torch.Tensor
    some_hi: torch.Tensor
    some_lo: torch.Tensor
    run_cell: torch.Tensor
    entry_cell: torch.Tensor
    n_cells: int


def cell_plan(cells: np.ndarray, n_cells: int, device) -> CellPlan:
    """Plan for summing entries (in their given order) into `cells`."""
    cells = np.asarray(cells, np.int64)
    perm = np.argsort(cells, kind="stable")
    sc = cells[perm]
    run_cell, lo, counts = np.unique(sc, return_index=True,
                                     return_counts=True)
    hi = lo + counts

    def t(a):
        return torch.tensor(np.asarray(a, np.int64), device=device)
    return CellPlan(
        perm=t(perm), hi_prev=t(np.maximum(hi - 1, 0)),
        lo_prev=t(np.maximum(lo - 1, 0)),
        some_hi=torch.tensor(hi > 0, device=device),
        some_lo=torch.tensor(lo > 0, device=device),
        run_cell=t(run_cell), entry_cell=t(cells), n_cells=int(n_cells))


class _CellSums(torch.autograd.Function):
    """(..., n_entries) -> (..., n_cells) sums by a CellPlan: an f64 prefix
    sum over the sorted entries differenced at the run boundaries, placed
    at the runs' (distinct) cells. The backward hands each entry its
    cell's cotangent (a gather)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        xs = x[..., plan.perm]
        if xs.numel() == xs.shape[-1]:
            # a single row would take CUB's look-back scan on a card,
            # whose float sums vary from run to run; with a second row
            # the row-wise scan kernel runs, in a fixed order
            flat = xs.reshape(-1)
            cs = torch.cumsum(torch.stack([flat, torch.zeros_like(flat)]),
                              dim=-1)[0].reshape(xs.shape)
        else:
            cs = torch.cumsum(xs, dim=-1)
        zero = cs.new_zeros(())
        runs = (torch.where(plan.some_hi, cs[..., plan.hi_prev], zero)
                - torch.where(plan.some_lo, cs[..., plan.lo_prev], zero))
        out = x.new_zeros(x.shape[:-1] + (plan.n_cells,))
        out[..., plan.run_cell] = runs
        return out

    @staticmethod
    def backward(ctx, ct):
        return ct[..., ctx.plan.entry_cell], None


class _LevelGather(torch.autograd.Function):
    """u[codes] (each row's level effect); the backward is the per-level
    sum of the cotangent by the level plan, not a scatter-add."""

    @staticmethod
    def forward(ctx, u, be):
        ctx.be = be
        return u[be.codes]

    @staticmethod
    def backward(ctx, ct):
        return _CellSums.apply(ct, ctx.be.level_plan), None


def _finite(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


class SchurFactor(NamedTuple):
    L: torch.Tensor      # padded factor of the equilibrated Schur block
    Dvec: torch.Tensor   # (q,) the diagonal IID block
    Ks: torch.Tensor     # (q, dpad + qf) scaled coupling
    su: torch.Tensor     # (q,) 1/sqrt(Dvec)
    svt: torch.Tensor    # (dpad + qf,) Jacobi scales of the arrow block


@dataclasses.dataclass
class ScatterIIDBackend(iwp.HostNodes):
    """FastIWPBackend core + a scattered IID block, with the Laplace
    machinery of one model on one device. Latent state: (V', u, t)."""
    core: Any               # fast/iwp.FastIWPBackend without the IID term
    md: Any                 # the full ModelData (both terms)
    q_iid: int
    codes: torch.Tensor     # (n,) level of each row, core row order
    level_plan: CellPlan    # rows -> levels
    cross_plan: CellPlan    # (basis entry a, row) -> (column, level)
    logPdet_iid: float
    phi_iid: float          # rate of the IID precision's PC prior
    dense_ops: Any = chol_dense.KERNELS

    @property
    def device(self):
        return self.core.device

    @property
    def n_theta(self):
        return self.md.n_theta

    @property
    def w_count(self):
        return self.core.d + self.core.q + self.q_iid

    def init_state(self):
        V, t = self.core.init_state()
        return V, torch.zeros(self.q_iid, dtype=DTYPE, device=self.device), t

    def _theta_core(self, theta):
        return theta[:1]

    # -- linear predictor and level products ---------------------------
    def eta(self, Vp, u, tail):
        return self.core.eta(Vp, tail) + _LevelGather.apply(u, self)

    def level_sums(self, r):
        """(..., n) row values -> (..., q) per-level sums."""
        return _CellSums.apply(r, self.level_plan)

    def iid_products(self, wts):
        """(sw, C_vu, C_ut): per-level weight sums (q,), the smooth's cross
        block (dpad, q) and the tail's (q, qf)."""
        c = self.core
        ls = self.level_sums(torch.cat([wts[None], wts * c.XFpT]))
        C_vu = _CellSums.apply((wts * c.valsT).reshape(-1), self.cross_plan)
        return ls[0], C_vu.reshape(c.dpad, self.q_iid), ls[1:].T

    # -- joint negative log posterior -----------------------------------
    def _prior_neg(self, Vp, u, tail, theta):
        """The core's priors and hyperprior, plus the IID prior and the
        PC hyperprior of its precision."""
        base = self.core._prior_neg(Vp, tail, self._theta_core(theta))
        th = theta[1]
        lp = (0.5 * (self.q_iid * th + self.logPdet_iid)
              - 0.5 * torch.exp(th) * (u * u).sum())
        phi = self.phi_iid
        lpT = math.log(0.5 * phi) - phi * torch.exp(-0.5 * th) - 0.5 * th
        return base - (lp + lpT)

    def neg_log_post(self, Vp, u, tail, theta):
        ll = families.log_lik(self.eta(Vp, u, tail), self.core.md,
                              self._theta_core(theta))
        return -ll + self._prior_neg(Vp, u, tail, theta)

    def grad_W(self, Vp, u, tail, theta, eta=None):
        thc = self._theta_core(theta)
        e = self.eta(Vp, u, tail) if eta is None else eta
        r = families.eta_residual(e, self.core.md, thc)
        gV, gt = self.core.grad_parts(Vp, tail, thc, r)
        gu = self.level_sums(r) + torch.exp(theta[1]) * u
        return gV, gu, gt

    # -- Hessian: diagonal-first Schur ------------------------------------
    def _band_to_dense(self, band):
        """(dpad, p+1) lower band (row j, column o = H[j+o, j]) ->
        symmetric dense (dpad, dpad)."""
        M = torch.diag(band[:, 0])
        for o in range(1, self.core.p + 1):
            lower = torch.diag(band[:self.core.dpad - o, o], -o)
            M = M + lower + lower.T
        return M

    def _schur(self, Vp, u, tail, theta, eta=None):
        """(S, Dvec, Ks, su, svt): the Jacobi-equilibrated Schur block S of
        the arrow part after eliminating u, and what the solves need."""
        c = self.core
        thc = self._theta_core(theta)
        e = self.eta(Vp, u, tail) if eta is None else eta
        wts = families.eta_weights(e, c.md, thc)
        band = c.band_H(wts, thc)
        C_vt = c.C_block(wts, thc)
        Htt = c.tail_gram(wts, thc)
        sw, C_vu, C_ut = self.iid_products(wts)
        Dvec = sw + torch.exp(theta[1])
        su = torch.rsqrt(Dvec)
        sc = torch.rsqrt(band[:, 0])
        sd = torch.rsqrt(torch.diagonal(Htt))
        svt = torch.cat([sc, sd])
        Mvv = self._band_to_dense(band) * sc[:, None] * sc[None, :]
        Mvt = C_vt * sc[:, None] * sd[None, :]
        Mtt = Htt * sd[:, None] * sd[None, :]
        M = torch.cat([torch.cat([Mvv, Mvt], 1), torch.cat([Mvt.T, Mtt], 1)])
        Ks = torch.cat([C_vu.T * sc[None, :], C_ut * sd[None, :]],
                       1) * su[:, None]                     # (q, dpad+qf)
        S = M - Ks.T @ Ks
        return 0.5 * (S + S.T), Dvec, Ks, su, svt

    def hessian_factor(self, Vp, u, tail, theta, eta=None):
        S, Dvec, Ks, su, svt = self._schur(Vp, u, tail, theta, eta=eta)
        return SchurFactor(chol_dense.cholesky_blocked(S, self.dense_ops),
                           Dvec, Ks, su, svt)

    def half_logdet_H(self, factor):
        return (0.5 * torch.log(factor.Dvec).sum()
                + chol_dense.half_logdet(factor.L)
                - torch.log(factor.svt).sum())

    def solve_H(self, factor, gV, gu, gt):
        """H [zV; zu; zt] = [gV; gu; gt]."""
        L, _, Ks, su, svt = factor
        ops = self.dense_ops
        gvt = torch.cat([gV, gt]) * svt
        gus = gu * su
        y = chol_dense.solve_lower_blocked(L, gvt - Ks.T @ gus, ops)
        zvt = chol_dense.solve_lower_t_blocked(L, y, ops)
        zu = (gus - Ks @ zvt) * su
        zvt = zvt * svt
        dpad = self.core.dpad
        return zvt[:dpad], zu, zvt[dpad:]

    def sample_multi_H(self, factor, Zv, Zu, Zt):
        """(dpad, M), (q, M), (qf, M) standard normal noise -> draws with
        covariance H^{-1}."""
        L, _, Ks, su, svt = factor
        Xvt = chol_dense.solve_lower_t_blocked(
            L, torch.cat([Zv, Zt]), self.dense_ops)
        Xu = Zu * su[:, None] - (Ks @ Xvt) * su[:, None]
        Xvt = Xvt * svt[:, None]
        dpad = self.core.dpad
        return Xvt[:dpad], Xu, Xvt[dpad:]

    # -- inner Newton ------------------------------------------------------
    @torch.no_grad()
    def newton_step(self, Vp, u, tail, theta, eta_cap=8.0):
        """Newton step with a linear-predictor cap alpha <= eta_cap /
        max|delta eta| and a 4-candidate backtracking pass on the exact
        objective. Returns (V', u', tail', max|step|)."""
        thc = self._theta_core(theta)
        cmd = self.core.md
        e0 = self.eta(Vp, u, tail)
        gV, gu, gt = self.grad_W(Vp, u, tail, theta, eta=e0)
        factor = self.hessian_factor(Vp, u, tail, theta, eta=e0)
        sV, su_, st = map(_finite, self.solve_H(factor, gV, gu, gt))
        d_eta = self.eta(sV, su_, st)
        max_de = d_eta.abs().max()
        d_eta = _finite(d_eta)
        alpha0 = torch.clamp(eta_cap / torch.clamp(max_de, min=1e-30),
                             max=1.0)
        cands = alpha0 * torch.tensor([1.0, 0.3, 0.1, 0.03], dtype=DTYPE,
                                      device=self.device)
        alphas = torch.cat([alpha0.new_zeros(1), cands])
        lls = families.log_lik(e0[None, :] - alphas[:, None] * d_eta[None, :],
                               cmd, thc)
        # the prior part is an exact quadratic in alpha
        p_0 = self._prior_neg(Vp, u, tail, theta)
        p_p = self._prior_neg(Vp - sV, u - su_, tail - st, theta)
        p_m = self._prior_neg(Vp + sV, u + su_, tail + st, theta)
        c2 = 0.5 * (p_p + p_m) - p_0
        c1 = 0.5 * (p_p - p_m)
        fall = -lls + (p_0 + c1 * alphas + c2 * alphas ** 2)
        f0 = fall[0]
        fs = torch.where(torch.isnan(fall[1:]),
                         torch.full_like(fall[1:], math.inf), fall[1:])
        best = torch.argmin(fs)
        noise = iwp.LS_NOISE * (1.0 + f0.abs())
        idx = (fs <= fs[best] + noise).to(torch.int8).argmax()
        alpha = torch.where(fs[best] <= f0 + noise, cands[idx],
                            0.01 * alpha0)
        smax = torch.stack([sV.abs().max(), su_.abs().max(),
                            st.abs().max()]).max()
        return Vp - alpha * sV, u - alpha * su_, tail - alpha * st, smax

    @torch.no_grad()
    def newton_solve(self, theta, max_iter=iwp.MAX_NEWTON, warm=None):
        """Inner Newton: stops when max|H^{-1} g| falls below STEPTOL (1 +
        max|V|), after STALL_ITERS steps without a 5% improvement of the
        step size, or at max_iter."""
        if warm is None:
            V, u, t = self.init_state()
        else:
            V, u, t = warm
            if not bool(torch.isfinite(V.sum() + u.sum() + t.sum())):
                V, u, t = self.init_state()
        best, since = math.inf, 0
        for _ in range(max_iter):
            if since >= iwp.STALL_ITERS:
                break
            V, u, t, s = self.newton_step(V, u, t, theta)
            smax, vmax = torch.stack([s, V.abs().max()]).tolist()
            since = 0 if smax < 0.95 * best else since + 1
            best = min(best, smax)
            if smax < iwp.STEPTOL * (1.0 + vmax):
                break
        return V, u, t

    @torch.no_grad()
    def _refine(self, Vp, u, tail, theta, eta_cap=8.0):
        e0 = self.eta(Vp, u, tail)
        gV, gu, gt = self.grad_W(Vp, u, tail, theta, eta=e0)
        factor = self.hessian_factor(Vp, u, tail, theta, eta=e0)
        sV, su_, st = map(_finite, self.solve_H(factor, gV, gu, gt))
        d_eta = self.eta(sV, su_, st)
        alpha = _finite(torch.clamp(
            eta_cap / torch.clamp(d_eta.abs().max(), min=1e-30), max=1.0))
        return Vp - alpha * sV, u - alpha * su_, tail - alpha * st

    def solve_W_star(self, theta, n_refine=1, warm=None):
        theta = theta.detach()
        V, u, t = self.newton_solve(theta, warm=warm)
        for _ in range(n_refine):
            V, u, t = self._refine(V, u, t, theta)
        return V, u, t

    # -- Laplace values ----------------------------------------------------
    def _laplace_value(self, Vp, u, tail, theta, factor=None):
        """F(W, theta) = f + 1/2 log|H| - w/2 log(2 pi) - log|det T|,
        differentiable in (V', u, t, theta): the dense half log-det's
        backward is 0.5 S^{-1} by blocked solves. `factor`: a
        hessian_factor at the same point, whose factorization the primal
        then reuses."""
        e0 = self.eta(Vp, u, tail)
        S, Dvec, _, _, svt = self._schur(Vp, u, tail, theta, eta=e0)
        hld = (0.5 * torch.log(Dvec).sum()
               + chol_dense.dense_half_logdet(
                   S, self.dense_ops, None if factor is None else factor.L)
               - torch.log(svt).sum())
        f = (-families.log_lik(e0, self.core.md, self._theta_core(theta))
             + self._prior_neg(Vp, u, tail, theta))
        return f + hld - 0.5 * self.w_count * LOG2PI - self.core.logdetT

    def _laplace_value_direct(self, Vp, u, tail, theta, factor, eta=None):
        e0 = self.eta(Vp, u, tail) if eta is None else eta
        f = (-families.log_lik(e0, self.core.md, self._theta_core(theta))
             + self._prior_neg(Vp, u, tail, theta))
        return (f + self.half_logdet_H(factor)
                - 0.5 * self.w_count * LOG2PI - self.core.logdetT)

    @torch.no_grad()
    def laplace_eval_full(self, theta, warm):
        """(nll, (V, u, t), factor) of one quadrature node."""
        V, u, t = self.solve_W_star(theta, warm=warm)
        e0 = self.eta(V, u, t)
        factor = self.hessian_factor(V, u, t, theta, eta=e0)
        return (self._laplace_value_direct(V, u, t, theta, factor, eta=e0),
                (V, u, t), factor)

    def laplace_nll(self, theta, warm=None):
        """(Laplace marginal nll, (V, u, t)), differentiable in theta by
        the implicit function theorem."""
        V0, u0, t0 = self.init_state() if warm is None else warm
        theta = torch.as_tensor(theta, dtype=DTYPE, device=self.device)
        val, V, u, t = _LaplaceNLL.apply(theta, V0, u0, t0, self)
        return val, (V, u, t)

    def value_and_grad(self, theta, warm):
        """(nll, d nll/d theta, (V, u, t)) at theta, warm-started."""
        th = torch.as_tensor(theta, dtype=DTYPE, device=self.device)
        th = th.detach().clone().requires_grad_(True)
        val, st = self.laplace_nll(th, warm)
        (g,) = torch.autograd.grad(val, th)
        return val.detach(), g, st

    def noise_rows(self):
        """Rows of the standard normal noise `sample` takes, in order."""
        return (self.core.dpad, self.q_iid, self.core.q)

    @torch.no_grad()
    def sample(self, states, idx, Zv, Zu, Zt):
        """(w, M) mixture draws in reference order [U = T V | u | betas |
        fixed]. states: per-node (V, u, t, factor); idx (M,) node of each
        draw; the noise is shared by the nodes."""
        c = self.core
        M = Zv.shape[1]
        Vs = Zv.new_zeros((c.dpad, M))
        us = Zu.new_zeros((self.q_iid, M))
        ts = Zt.new_zeros((c.q, M))
        for j, (V, u, t, factor) in enumerate(states):
            xv, xu, xt = self.sample_multi_H(factor, Zv, Zu, Zt)
            on = idx == j
            Vs = torch.where(on, V[:, None] + xv, Vs)
            us = torch.where(on, u[:, None] + xu, us)
            ts = torch.where(on, t[:, None] + xt, ts)
        U = c.apply_T(c.to_V(Vs.T, ts.T)[:, :c.d]).T
        return torch.cat([U, us, ts])


class _LaplaceNLL(torch.autograd.Function):
    """Laplace nll with its implicit-function theta gradient:
    dnll/dth = dF/dth - (dg/dth)^T H^{-1} dF/dW at the inner mode W*."""

    @staticmethod
    def forward(ctx, theta, V0, u0, t0, be):
        V, u, t = be.solve_W_star(theta, warm=(V0, u0, t0))
        e0 = be.eta(V, u, t)
        factor = be.hessian_factor(V, u, t, theta, eta=e0)
        val = be._laplace_value_direct(V, u, t, theta, factor, eta=e0)
        ctx.be, ctx.factor = be, factor
        ctx.save_for_backward(theta, V, u, t)
        ctx.mark_non_differentiable(V, u, t)
        return val, V, u, t

    @staticmethod
    def backward(ctx, ct_val, _ct_V, _ct_u, _ct_t):
        be, factor = ctx.be, ctx.factor
        theta, V, u, t = ctx.saved_tensors
        with torch.enable_grad():
            args = [x.detach().requires_grad_(True) for x in (V, u, t, theta)]
            F = be._laplace_value(*args, factor=factor)
            gF_V, gF_u, gF_t, gF_th = torch.autograd.grad(F, args)
            with torch.no_grad():
                vV, vu, vt = map(_finite, be.solve_H(
                    factor, _finite(gF_V), _finite(gF_u), _finite(gF_t)))
            th2 = theta.detach().requires_grad_(True)
            gV, gu, gt = be.grad_W(V, u, t, th2)
            gdotv = torch.dot(gV, vV) + torch.dot(gu, vu) + torch.dot(gt, vt)
            (term2,) = torch.autograd.grad(gdotv, th2)
        return (gF_th - term2) * ct_val, None, None, None, None


def build_scatter_iid(instances, md, design_mat_fixed, bf_prec, bf_mean,
                      device="cuda"):
    """ScatterIIDBackend for a model of one IWP smooth followed by one IID
    term, plus fixed columns, on `device`. md: the full ModelData. Raises
    ValueError when the model has another shape."""
    kinds = [t.kind for t in instances]
    if kinds != ["IWP", "IID"]:
        raise ValueError("the scatter_iid engine needs one IWP smooth "
                         "followed by one IID term")
    if md.family == 0:
        raise NotImplementedError(
            "the Gaussian family on the scatter_iid engine (a third "
            "hyperparameter) is not ported yet (ROADMAP Queue 1 item 7)")
    if md.family not in (1, 2):
        raise ValueError("the scatter_iid engine needs the Poisson or "
                         "Binomial family")
    drv, t_iid = instances
    if t_iid.extra is None or "codes" not in t_iid.extra:
        raise ValueError("the IID term carries no level codes")
    if np.asarray(drv.knots).min() < 0:
        raise ValueError("the scatter_iid engine needs nonnegative knots")
    q_iid = len(t_iid.levels)

    # core model: the smooth and the fixed columns, same data
    core_md = dataclasses.replace(
        md, logPdet=np.asarray(md.logPdet)[:1], u=np.asarray(md.u)[:1],
        alpha=np.asarray(md.alpha)[:1],
        P_blocks=(), d_sizes=(drv.num_basis,), x_sizes=(drv.X.shape[1],))
    nb_cols = drv.X.shape[1]
    bp = np.asarray(md.betaprec).reshape(-1)
    bm = np.asarray(md.betamean).reshape(-1)
    prior_diag_tail = np.concatenate([
        np.repeat(bp[:1], nb_cols), np.asarray(bf_prec, np.float64)])
    prior_mean_tail = np.concatenate([
        np.repeat(bm[:1], nb_cols), np.asarray(bf_mean, np.float64)])
    xf_dense = np.concatenate([drv.X] + [np.asarray(c) for c in
                                         design_mat_fixed], axis=1)
    core = iwp.build_fast_iwp(drv, core_md, xf_dense, prior_diag_tail,
                              prior_mean_tail, drv.x_data, device=device)
    codes = np.asarray(t_iid.extra["codes"], np.int64)[core.row_order]
    return from_core(core, md, codes, q_iid,
                     logPdet_iid=float(np.asarray(md.logPdet)[1]))


def from_core(core, md, codes, q_iid, logPdet_iid):
    """ScatterIIDBackend from a built core, the level codes in the core's
    row order and the IID term's constants."""
    dev = core.device
    codes = np.asarray(codes, np.int64)
    n, p = len(codes), core.p
    start = core.start.cpu().numpy()
    # entry (a, row) of valsT, flattened a-major, falls in cell
    # (column start + a, level)
    cols = start[None, :] + np.arange(p + 1)[:, None]
    cross = (cols * q_iid + codes[None, :]).reshape(-1)
    phi = (-math.log(float(np.asarray(md.alpha)[1]))
           / float(np.asarray(md.u)[1]))
    return ScatterIIDBackend(
        core=core, md=md, q_iid=int(q_iid),
        codes=torch.tensor(codes, device=dev),
        level_plan=cell_plan(codes, q_iid, dev),
        cross_plan=cell_plan(cross, core.dpad * q_iid, dev),
        logPdet_iid=float(logPdet_iid), phi_iid=phi)
