"""Likelihood families as torch functions of the linear predictor
(reference family dispatch: src/BayesGP.cpp:155-214).

  - `log_lik(eta, md, theta)`       log likelihood, summed over the last
                                    axis (a batch of etas gives one each)
  - `eta_hessian_kind(fam)`         "diag" (elementwise) or "full"
  - `eta_weights(eta, md, theta)`   diag of d^2(-ll)/d eta^2 ("diag")
  - `eta_residual(eta, md, theta)`  d(-ll)/d eta
  - `eta_hessian_quadform(eta, md, theta, A)`  A^T M A for the "full"
                                    families, M = d^2(-ll)/d eta^2, without
                                    forming the (n, n) M
  - `eta_hessian_full(eta, md, theta)`  that M, the plain version the
                                    quadform is held to

Family codes: 0 Gaussian, 1 Poisson, 2 Binomial, 3 CoxPH, 4
case-crossover, -2 prior only, -1 customized (a log likelihood registered
by `register_family`). `md` carries the data as tensors on the device of
`eta` (objective.to_device), with the host-built structures of the
partial likelihoods: `rank_wts` (CoxPH) and `cc_plan` (case-crossover).

The Cox partial likelihood (the reference's O(n^2) risk-set loops,
BayesGP.cpp:170-194) is a suffix log-sum-exp over the time-sorted rows,
each row's rank term regrouped per rank by `rank_wts`, which leaves no
gather or scatter. The case-crossover likelihood (BayesGP.cpp:196-210) is
a padded log-sum-exp over each case's stratum, seeded with the
reference's implicit exp(0) term; the backward of its gather sums each
row's entries through a host-built table, in a fixed order. Every scan
runs along the last axis with at least two rows: a one-row scan on a card
takes CUB's look-back scan, whose float sums vary from run to run.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# customized families (the reference's family_type -1, a user-compiled TMB
# template named by `customized_template`, R/02_model_fit.R:19-24): name ->
# (loglik, number of extra hyperparameters)
CUSTOM_FAMILIES = {}


def register_family(name: str, loglik, n_theta_extra: int = 0):
    """Register a customized likelihood: loglik(eta, y, theta) -> scalar,
    differentiable torch code for one (n,) eta (theta: the whole
    hyperparameter vector). `n_theta_extra` extra hyperparameters are
    appended to theta, each with the control_family exponential prior."""
    CUSTOM_FAMILIES[name] = (loglik, int(n_theta_extra))


def custom_family(name: str):
    """(loglik, n_theta_extra) of a registered family."""
    if name not in CUSTOM_FAMILIES:
        raise ValueError(f"customized family '{name}' is not registered; "
                         "use bayesgp_torch.register_family first")
    return CUSTOM_FAMILIES[name]


# -- host-built structures --------------------------------------------------
def coxph_rank_wts(ranks, cens):
    """rank_wts[j] = sum of cens_i over the rows i of rank j + 1 (the event
    mass of each rank): sum_i c_i s[r_i] = sum_j rank_wts_j s_j."""
    r0 = np.asarray(ranks, np.int64) - 1
    wts = np.zeros(len(r0))
    np.add.at(wts, r0, np.asarray(cens, np.float64))
    return wts


@dataclasses.dataclass(frozen=True)
class CCPlan:
    """The gathers of the case-crossover likelihood, built on the host.

    pos (nc * K + nc,): the rows of eta read, each case's K stratum days
    (padding reads row 0) and then the case days; mask (nc, K): the real
    stratum days; inv (n, R): for each row the positions of pos that read
    it, in increasing order, padded with nc * K + nc (a zero slot)."""
    pos: torch.Tensor
    mask: torch.Tensor
    inv: torch.Tensor
    nc: int
    K: int


def cc_plan(case_day, control_days, n, device):
    cd = np.asarray(control_days, np.int64)
    case = np.asarray(case_day, np.int64)
    nc, K = cd.shape
    mask = cd > 0
    pos = np.concatenate([np.where(mask, cd - 1, 0).ravel(), case - 1])
    real = np.flatnonzero(np.concatenate([mask.ravel(), np.ones(nc, bool)]))
    rows = pos[real]
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=n)
    inv = np.full((n, max(int(counts.max(initial=0)), 1)), len(pos),
                  np.int64)
    first = np.cumsum(counts) - counts
    slot = np.arange(len(order)) - np.repeat(first, counts)
    inv[rows[order], slot] = real[order]

    def t(a):
        return torch.as_tensor(a, device=device)
    return CCPlan(pos=t(pos), mask=t(mask), inv=t(inv), nc=nc, K=K)


# -- fixed-order scans and gathers ------------------------------------------
def _scan(x, fn):
    """fn(x, dim=-1) (torch.cumsum or torch.logcumsumexp); a single row
    is scanned beside a row of zeros, so a card runs its row-wise scan
    kernel, in a fixed order, forward and backward."""
    if x.numel() == x.shape[-1]:
        flat = x.reshape(-1)
        return fn(torch.stack([flat, torch.zeros_like(flat)]),
                  dim=-1)[0].reshape(x.shape)
    return fn(x, dim=-1)


def _suffix_lse(eta):
    """s[..., i] = logsumexp(eta[..., i:])."""
    return _scan(eta.flip(-1), torch.logcumsumexp).flip(-1)


def _plan_sum(c, plan):
    """(..., n): for each row of eta the sum of c (..., nc * K + nc) over
    the gather positions that read it, in a fixed order."""
    ext = torch.cat([c, c.new_zeros(c.shape[:-1] + (1,))], dim=-1)
    return ext[..., plan.inv].sum(-1)


class _PlanGather(torch.autograd.Function):
    """eta[..., plan.pos]; the backward is _plan_sum, not a scatter-add."""

    @staticmethod
    def forward(ctx, eta, plan):
        ctx.plan = plan
        return eta[..., plan.pos]

    @staticmethod
    def backward(ctx, ct):
        return _plan_sum(ct, ctx.plan), None


def _cc_parts(eta, md):
    """(q (..., nc, K), denom (..., nc)): denom_i = log(1 + sum_k
    exp(z_ik)) over case i's stratum days k (the reference's logspace_add
    chain seeded at 0), z_ik = eta_day - eta_case, q_ik = exp(z_ik -
    denom_i). The shift zmax leaves denom's value and gradient as they
    are, so it carries no gradient."""
    plan = md.cc_plan
    g = _PlanGather.apply(eta, plan)
    nk = plan.nc * plan.K
    days = g[..., :nk].reshape(eta.shape[:-1] + (plan.nc, plan.K))
    z = torch.where(plan.mask, days - g[..., nk:, None], -math.inf)
    zmax = torch.clamp(z.max(-1).values, min=0.0).detach()
    denom = zmax + torch.log(
        torch.exp(-zmax)
        + torch.where(plan.mask, torch.exp(z - zmax[..., None]), 0.0).sum(-1))
    q = torch.where(plan.mask, torch.exp(z - denom[..., None]), 0.0)
    return q, denom


# -- customized families ----------------------------------------------------
def _custom_log_lik(eta, md, theta):
    """The registered loglik, one (n,) eta at a time."""
    fn = custom_family(md.custom_family)[0]
    out = []
    for e in eta.reshape(-1, eta.shape[-1]):
        v = fn(e, md.y, theta)
        if not (isinstance(v, torch.Tensor) and v.numel() == 1):
            raise ValueError(f"customized family '{md.custom_family}': "
                             "loglik must return a scalar tensor")
        if v.device != eta.device:
            raise ValueError(
                f"customized family '{md.custom_family}': loglik returned "
                f"a tensor on {v.device}, eta is on {eta.device}")
        out.append(v.reshape(()))
    return torch.stack(out).reshape(eta.shape[:-1])


def _custom_grad(eta, md, theta):
    """d loglik / d eta by autograd, differentiable where grad mode is
    on."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        e = eta if eta.requires_grad else eta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_custom_log_lik(e, md, theta).sum(), e,
                                   create_graph=create)
    return g


def _custom_hessian(eta, md, theta):
    """The (n, n) d^2 loglik / d eta^2 by autograd, differentiable where
    grad mode is on."""
    return torch.autograd.functional.hessian(
        lambda e: _custom_log_lik(e, md, theta), eta,
        create_graph=torch.is_grad_enabled(), vectorize=True)


# -- the family functions ---------------------------------------------------
def log_lik(eta, md, theta):
    fam, y = md.family, md.y
    if fam == 0:    # sigma = exp(-theta_last / 2) (BayesGP.cpp:159-161)
        sigma = torch.exp(-0.5 * theta[-1])
        return torch.sum(-0.5 * math.log(2 * math.pi) - torch.log(sigma)
                         - 0.5 * ((y - eta) / sigma) ** 2, dim=-1)
    if fam == 1:    # Poisson log link (BayesGP.cpp:163-165)
        return torch.sum(y * eta - torch.exp(eta) - torch.lgamma(y + 1.0),
                         dim=-1)
    if fam == 2:    # Binomial logit, dbinom_robust (BayesGP.cpp:166-168)
        size = md.size
        lchoose = (torch.lgamma(size + 1.0) - torch.lgamma(y + 1.0)
                   - torch.lgamma(size - y + 1.0))
        softplus = torch.logaddexp(eta, torch.zeros_like(eta))
        return torch.sum(lchoose + y * eta - size * softplus, dim=-1)
    if fam == 3:    # Cox PH partial likelihood (BayesGP.cpp:170-194)
        # rows sorted by time: the risk set of rank j is the suffix from j;
        # sum_i c_i (eta_i - s[r_i]) = c . eta - rank_wts . s
        return (torch.sum(md.cens * eta, dim=-1)
                - torch.sum(md.rank_wts * _suffix_lse(eta), dim=-1))
    if fam == 4:    # case-crossover (BayesGP.cpp:196-210)
        return -torch.sum(md.count * _cc_parts(eta, md)[1], dim=-1)
    if fam == -2:   # prior only (BayesGP.cpp:212-214)
        return eta.new_zeros(eta.shape[:-1])
    if fam == -1:
        return _custom_log_lik(eta, md, theta)
    raise ValueError(f"unknown family code {fam}")


def eta_hessian_kind(fam: int) -> str:
    return "diag" if fam in (0, 1, 2, -2) else "full"


def eta_weights(eta, md, theta):
    """Diagonal of d^2(-log_lik)/d eta^2 for the elementwise families."""
    fam = md.family
    if fam == 0:
        return torch.exp(theta[-1]).expand(eta.shape)   # 1/sigma^2
    if fam == 1:
        return torch.exp(eta)
    if fam == 2:
        p = torch.sigmoid(eta)
        return md.size * p * (1.0 - p)
    if fam == -2:
        return torch.zeros_like(eta)
    raise ValueError(f"family {fam} is not elementwise")


def eta_residual(eta, md, theta):
    """d(-log_lik)/d eta."""
    fam = md.family
    if fam == 0:
        return (eta - md.y) * torch.exp(theta[-1])
    if fam == 1:
        return torch.exp(eta) - md.y
    if fam == 2:
        return md.size * torch.sigmoid(eta) - md.y
    if fam == 3:
        # d s_j / d eta_m = 1[m >= j] exp(eta_m - s_j): the rank terms
        # reach row m through u_m = sum_{j <= m} rank_wts_j exp(-s_j)
        u = _scan(md.rank_wts * torch.exp(-_suffix_lse(eta)), torch.cumsum)
        return u * torch.exp(eta) - md.cens
    if fam == 4:
        # d denom_i: +q_ik at day k, -sum_k q_ik at the case day
        q, _ = _cc_parts(eta, md)
        qc = q * md.count[..., None]
        return _plan_sum(torch.cat([qc.flatten(-2), -qc.sum(-1)], dim=-1),
                         md.cc_plan)
    if fam == -2:
        return torch.zeros_like(eta)
    if fam == -1:
        return -_custom_grad(eta, md, theta)
    raise ValueError(f"unknown family code {fam}")


def eta_hessian_quadform(eta, md, theta, A):
    """A^T M A for the structured families without the (n, n) M.

    CoxPH: M = sum_i c_i (diag(p_i) - p_i p_i^T), p_i the softmax over the
    risk set (suffix) of row i; regrouped per rank,
      A^T M A = A^T diag(u e^eta) A - P^T diag(rank_wts) P,
      P[j] = e^{-s_j} sum_{m >= j} e^{eta_m} a_m,  u = cumsum(rank_wts e^-s).
    Case-crossover: M = sum_i cnt_i [sum_k q_ik v_ik v_ik^T - g_i g_i^T],
    v_ik = a_day - a_case, g_i = sum_k q_ik v_ik, from the gathered design
    rows (nc, K, w). Customized: A^T M A with M by autograd."""
    fam = md.family
    if fam == 3:
        es = torch.exp(-_suffix_lse(eta))
        expeta = torch.exp(eta)
        AT = A.T
        # columns of P^T: (w, n) suffix sums along the rows' axis
        PT = _scan((AT * expeta).flip(-1), torch.cumsum).flip(-1) * es
        diagw = _scan(md.rank_wts * es, torch.cumsum) * expeta
        return (AT * diagw) @ A - (PT * md.rank_wts) @ PT.T
    if fam == 4:
        plan = md.cc_plan
        q, _ = _cc_parts(eta, md)
        rows = A[plan.pos]
        nk = plan.nc * plan.K
        V = (rows[:nk].reshape(plan.nc, plan.K, -1)
             - rows[nk:, None, :])                        # (nc, K, w)
        cnt = md.count
        Vf = V.reshape(nk, -1)
        H1 = (Vf * (q * cnt[:, None]).reshape(nk, 1)).T @ Vf
        g = (q[..., None] * V).sum(1)                     # (nc, w)
        return H1 - (g * cnt[:, None]).T @ g
    if fam == -1:
        return -(A.T @ (_custom_hessian(eta, md, theta) @ A))
    raise ValueError(f"family {fam} has no structured quadform path")


def eta_hessian_full(eta, md, theta):
    """The (n, n) Hessian of -log_lik in eta of the structured families,
    formed entry by entry (the plain version of eta_hessian_quadform)."""
    fam = md.family
    n = eta.shape[-1]
    if fam == 3:
        s = _suffix_lse(eta)
        r = md.ranks - 1
        in_risk = torch.arange(n, device=eta.device)[None, :] >= r[:, None]
        P = torch.where(in_risk, torch.exp(eta[None, :] - s[r][:, None]),
                        0.0)
        cP = md.cens[:, None] * P
        return torch.diag(cP.sum(0)) - P.T @ cP
    if fam == 4:
        q, _ = _cc_parts(eta, md)
        plan = md.cc_plan
        nc, K = q.shape
        nk = nc * K
        cd = plan.pos[:nk]
        case = plan.pos[nk:]
        case_k = case.repeat_interleave(K)
        qflat = (q * md.count[:, None]).reshape(-1)
        M = eta.new_zeros((n, n))
        for (a, b), sign in (((cd, cd), 1.0), ((case_k, case_k), 1.0),
                             ((cd, case_k), -1.0), ((case_k, cd), -1.0)):
            M.index_put_((a, b), sign * qflat, accumulate=True)
        G = eta.new_zeros((nc, n))
        ic = torch.arange(nc, device=eta.device)
        G.index_put_((ic.repeat_interleave(K), cd), q.reshape(-1),
                     accumulate=True)
        G.index_put_((ic, case), -q.sum(1), accumulate=True)
        return M - G.T @ (md.count[:, None] * G)
    if fam == -1:
        return -_custom_hessian(eta, md, theta)
    raise ValueError(f"family {fam} has no full-hessian path")
