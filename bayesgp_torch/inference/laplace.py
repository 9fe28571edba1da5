"""Laplace approximation over the latent block W of the dense model.

The counterpart of the TMB runtime's `MakeADFun(random="W")` inner
machinery (invoked at R/02_model_fit.R:276-284): a Newton solver for
W*(theta), a Cholesky log-determinant, and the Laplace-marginal negative
log likelihood

    nll(theta) = f(W*, theta) + 1/2 log|H(W*, theta)| - d_W/2 log(2 pi).

Differentiability: the Newton loop runs without autograd and is followed
by `n_refine` undamped Newton steps that carry it. The Newton map N(W,
theta) has zero Jacobian in W at the fixed point, so one refine step
gives exact first derivatives of W*(theta) and two give exact second
derivatives: `torch.autograd.grad` of the value in theta is the exact
first derivative.

A Hessian that is not positive definite (torch.linalg.cholesky_ex reports
info > 0) gives a zeroed Newton step, and a half log-det of NaN, which the
outer optimizers reject: the outcome of the NaN factor of the JAX
package's XLA Cholesky. Host syncs: one a Newton iteration (the stopping
test reads |g|_inf and the decrement); the line search picks its step
length on the device.
"""
from __future__ import annotations

import math

import torch

from ..model.objective import grad_W, hessian_W, neg_log_post

LOG2PI = math.log(2.0 * math.pi)
# line search: halvings, and the fp-noise band of its acceptance test
MAX_HALVINGS = 30
LS_FTOL = 1e-10


def _cho_solve(H, g):
    """(H^{-1} g with non-finite entries zeroed, whether H factored)."""
    L, info = torch.linalg.cholesky_ex(H)
    ok = info == 0
    step = torch.cholesky_solve(g[:, None], L)[:, 0]
    return torch.where(ok & torch.isfinite(step), step,
                       torch.zeros_like(step)), ok


def _newton_direction(W, theta, md):
    """(gradient, step, decrement) -- decrement = g^T H^{-1} g is the
    natural function-scale convergence measure (lambda^2). A step on a
    factor that failed, or a non-finite step entry, is zeroed."""
    g = grad_W(W, theta, md)
    step, _ = _cho_solve(hessian_W(W, theta, md), g)
    return g, step, torch.dot(g, step)


def newton_step(W, theta, md, step=None, f0=None):
    """One damped Newton step with a step-halving line search: the step
    length is 2^-j for the least j <= MAX_HALVINGS - 1 whose objective is
    not NaN and within LS_FTOL (1 + |f|) of the current one, else
    2^-MAX_HALVINGS. The tolerance lets full steps continue near the
    optimum, where f is flat to machine precision but the gradient can
    still be driven down (the half-log-det is first-order sensitive to
    the latent-mode error, so the inner gradient must reach ~1e-8). All
    candidates are evaluated at once; no host sync. `step`, `f0`: the
    Newton direction and the objective at W, where the caller has them."""
    if step is None:
        step = _newton_direction(W, theta, md)[1]
    if f0 is None:
        f0 = neg_log_post(W, theta, md)
    alphas = 0.5 ** torch.arange(MAX_HALVINGS + 1, dtype=W.dtype,
                                 device=W.device)
    f_try = neg_log_post(W - alphas[:MAX_HALVINGS, None] * step, theta, md)
    good = ~(torch.isnan(f_try) | (f_try > f0 + LS_FTOL * (1.0 + f0.abs())))
    good = torch.cat([good, good.new_ones(1)])
    return W - alphas[good.to(torch.int8).argmax()] * step


@torch.no_grad()
def newton_solve(theta, md, W0=None, gtol=1e-8, max_iter=100, stats=None):
    """Converge W*(theta) with Newton iterations.

    Stops on |grad|_inf < gtol (TMB's inner criterion) or when the Newton
    decrement falls below fp resolution of f (no further progress
    possible), or at max_iter steps. `stats`: a dict whose "newton" and
    "syncs" counts grow by the steps taken and the host reads made."""
    theta = theta.detach()
    W = (torch.zeros(md.w_count, dtype=md.A.dtype, device=md.A.device)
         if W0 is None else W0.detach())
    it = 0
    while True:
        g, step, dec = _newton_direction(W, theta, md)
        f = neg_log_post(W, theta, md)
        go = (g.abs().max() > gtol) & (dec > 1e-15 * (1.0 + f.abs()))
        if stats is not None:
            stats["syncs"] = stats.get("syncs", 0) + 1
        if not (bool(go) and it < max_iter):
            break
        W = newton_step(W, theta, md, step=step, f0=f)
        it += 1
    if stats is not None:
        stats["newton"] = stats.get("newton", 0) + it
    return W


def _refine(W, theta, md):
    """Undamped Newton step (differentiable polish at the fixed point).
    Non-finite steps are zeroed: bit-identity at healthy fixed points,
    and the polish cannot catapult W on a sick factorization."""
    step, _ = _cho_solve(hessian_W(W, theta, md), grad_W(W, theta, md))
    return W - step


def solve_W_star(theta, md, W0=None, n_refine=2, gtol=1e-8, max_iter=100,
                 stats=None):
    """W*(theta), differentiable in theta (see module docstring)."""
    Wc = newton_solve(theta, md, W0=W0, gtol=gtol, max_iter=max_iter,
                      stats=stats)
    for _ in range(n_refine):
        Wc = _refine(Wc, theta, md)
    return Wc


def _equilibrated_chol(H):
    """(d, chol_lower(H/d/d), half_logdet) via Jacobi-equilibrated
    Cholesky.

    H mixes likelihood curvature (huge) with weak prior precisions, so its
    condition number can reach ~1e8; a raw Cholesky logdet then carries
    fp noise ~ w * eps * kappa (~1e-5) which corrupts the outer
    optimization of the Laplace marginal. Scaling to unit diagonal first
    (log|H| = log|D H D| - 2 sum log D_ii with D = diag(H)^{-1/2}) removes
    the scale disparity; the correction term is smooth. The full factor
    is chol(H) = d[:, None] * chol(Hs). A factorization that fails gives a
    NaN half log-det."""
    d = torch.sqrt(torch.diagonal(H))
    Ls, info = torch.linalg.cholesky_ex(H / d[:, None] / d[None, :])
    half_logdet = (torch.log(torch.diagonal(Ls)).sum()
                   + torch.log(d).sum())
    half_logdet = torch.where(info == 0, half_logdet,
                              torch.full_like(half_logdet, math.nan))
    return d, Ls, half_logdet


def half_logdet_psd(H):
    """1/2 log|H| via Jacobi-equilibrated Cholesky (_equilibrated_chol)."""
    return _equilibrated_chol(H)[2]


def laplace_nll(theta, md, W0=None, n_refine=2, gtol=1e-8, max_iter=100,
                stats=None):
    """(Negative log Laplace-approximate marginal likelihood of theta,
    W*). Matches TMB's `ff$fn(theta)` with random="W" up to solver
    tolerance; differentiable in theta."""
    Ws = solve_W_star(theta, md, W0=W0, n_refine=n_refine, gtol=gtol,
                      max_iter=max_iter, stats=stats)
    H = hessian_W(Ws, theta, md)
    val = (neg_log_post(Ws, theta, md) + half_logdet_psd(H)
           - 0.5 * md.w_count * LOG2PI)
    return val, Ws


def laplace_nll_with_factor(theta, md, W0=None, n_refine=2, gtol=1e-8,
                            max_iter=100, stats=None):
    """(nll, W*, chol_lower(H)) in one pass: the sampling factor is
    recovered from the same equilibrated Cholesky the half log-det uses
    (chol(H) = D chol(Hs)), one Hessian build and factorization."""
    Ws = solve_W_star(theta, md, W0=W0, n_refine=n_refine, gtol=gtol,
                      max_iter=max_iter, stats=stats)
    H = hessian_W(Ws, theta, md)
    d, Ls, half_logdet = _equilibrated_chol(H)
    val = (neg_log_post(Ws, theta, md) + half_logdet
           - 0.5 * md.w_count * LOG2PI)
    return val, Ws, d[:, None] * Ls


@torch.no_grad()
def laplace_mode_hess(theta, md, W0=None, gtol=1e-8, max_iter=100,
                      stats=None):
    """(W*, H, chol_lower(H)) at theta -- for sampling W | theta (the
    nlminb route, theta of length 0)."""
    Ws = newton_solve(theta, md, W0=W0, gtol=gtol, max_iter=max_iter,
                      stats=stats)
    H = hessian_W(Ws, theta, md)
    L, info = torch.linalg.cholesky_ex(H)
    return Ws, H, torch.where(info == 0, L, torch.full_like(L, math.nan))
