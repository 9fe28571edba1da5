"""Joint negative log posterior of the dense model -- the torch counterpart
of the TMB template `objective_function<Type>::operator()`
(src/BayesGP.cpp:30-253).

neg_log_post(W, theta, md) = -(log_lik + log_prior_W + log_prior_theta)
with md a ModelData whose arrays are f64 tensors on one device
(`to_device`). W may carry leading batch axes (line-search candidates);
theta is one (s,) vector. Everything is differentiable in W and theta by
autograd; `grad_W` and `hessian_W` give the exact W-derivatives in closed
form (eta is linear in W).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DTYPE
from . import families


def to_device(md, device):
    """md with every array field an f64 (integer fields: int64) tensor on
    `device`; layout fields unchanged."""
    def put(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        a = np.asarray(v)
        dt = torch.int64 if np.issubdtype(a.dtype, np.integer) else DTYPE
        return torch.as_tensor(a, dtype=dt, device=device)

    arrays = {f.name: getattr(md, f.name) for f in dataclasses.fields(md)
              if f.name not in ("family", "d_sizes", "x_sizes", "xf_count",
                                "custom_family")}
    out = {k: (tuple(put(b) for b in v) if k == "P_blocks" else put(v))
           for k, v in arrays.items()}
    return dataclasses.replace(md, **out)


def linear_predictor(W, md):
    return W @ md.A.T


def _prior_mean(md):
    """(w,) means of the Gaussian priors on W: 0 on the spline weights,
    betamean on the boundary betas, bf_mean on the fixed effects."""
    ref = md.A
    parts = [ref.new_zeros(sum(md.d_sizes))]
    parts += [md.betamean[i].expand(b) for i, (_, b)
              in enumerate(md.beta_slices())]
    parts.append(md.bf_mean)
    return torch.cat(parts)


def log_prior_W(W, theta, md):
    """Gaussian priors on W (src/BayesGP.cpp:219-238), over W's last
    axis."""
    lp = W.new_zeros(W.shape[:-1])
    # spline weights: U_r ~ N(0, (exp(theta_r) P_r)^-1), plus log-det term
    for r, (off, d) in enumerate(md.u_slices()):
        U = W[..., off:off + d]
        quad = ((U @ md.P_blocks[r]) * U).sum(-1)
        lp = lp - 0.5 * torch.exp(theta[r]) * quad
        lp = lp + 0.5 * (d * theta[r] + md.logPdet[r])
    # boundary betas: N(betamean, 1/betaprec) per block
    for i, (off, b) in enumerate(md.beta_slices()):
        bb = ((W[..., off:off + b] - md.betamean[i]) ** 2).sum(-1)
        lp = lp - 0.5 * md.betaprec[i] * bb
    # fixed effects: independent normals per column
    off = md.fixed_offset()
    if md.xf_count:
        bf = W[..., off:off + md.xf_count]
        lp = lp - 0.5 * (md.bf_prec * (bf - md.bf_mean) ** 2).sum(-1)
    return lp


def log_prior_theta(theta, md):
    """Exponential (PC) prior on sigma = exp(-theta/2) per variance
    parameter: phi = -log(alpha)/u (src/BayesGP.cpp:241-246)."""
    phi = -torch.log(md.alpha) / md.u
    return torch.sum(torch.log(0.5 * phi) - phi * torch.exp(-0.5 * theta)
                     - 0.5 * theta)


def neg_log_post(W, theta, md):
    eta = linear_predictor(W, md)
    ll = families.log_lik(eta, md, theta)
    return -(ll + log_prior_W(W, theta, md) + log_prior_theta(theta, md))


def prior_precision(theta, md):
    """Q(theta): prior precision of W -- blockdiag(exp(theta_r) P_r,
    betaprec blocks, fixed-effect precs) as a dense (w, w) matrix."""
    blocks = [torch.exp(theta[r]) * md.P_blocks[r]
              for r in range(len(md.d_sizes))]
    diag = [md.betaprec[i].expand(b) for i, (_, b)
            in enumerate(md.beta_slices())]
    diag.append(md.bf_prec)
    blocks.append(torch.diag(torch.cat(diag)))
    return torch.block_diag(*blocks)


def _check_diag(md):
    if md.family not in (0, 1, 2):
        raise NotImplementedError(
            "the structured Hessian of the partial-likelihood families "
            "(families.eta_hessian_quadform) is not ported yet (ROADMAP "
            "Queue 1 item 8)")


def grad_W(W, theta, md):
    """d neg_log_post / dW = A^T r + Q (W - m), r = d(-ll)/d eta and m the
    prior means (_prior_mean)."""
    _check_diag(md)
    r = families.eta_residual(linear_predictor(W, md), md, theta)
    return r @ md.A + (W - _prior_mean(md)) @ prior_precision(theta, md)


def hessian_W(W, theta, md):
    """Exact Hessian of neg_log_post in W for the elementwise ("diag")
    families: A^T diag(w) A + Q(theta), eta being linear in W."""
    _check_diag(md)
    wts = families.eta_weights(linear_predictor(W, md), md, theta)
    return (md.A * wts[:, None]).T @ md.A + prior_precision(theta, md)
