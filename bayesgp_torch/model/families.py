"""Elementwise likelihood families as torch functions of the linear
predictor (reference family dispatch: src/BayesGP.cpp:155-168).

  - `log_lik(eta, md, theta)`     log likelihood, summed over the last
                                  axis (a batch of etas gives one each)
  - `eta_weights(eta, md, theta)` diag of d^2(-ll)/d eta^2
  - `eta_residual(eta, md, theta)` d(-ll)/d eta

`md` carries `family` (0 Gaussian, 1 Poisson, 2 Binomial), `y` and, for
the Binomial, `size`, as tensors on the device of `eta`. The
partial-likelihood families (CoxPH, case-crossover) and customized
families run on the dense route, which is not ported yet.
"""
from __future__ import annotations

import math

import torch

def _unsupported(fam):
    return NotImplementedError(
        f"family code {fam} is not elementwise; its route is not ported "
        "yet (ROADMAP Queue 1 items 3 and 8)")


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
    raise _unsupported(fam)


def eta_weights(eta, md, theta):
    """Diagonal of d^2(-log_lik)/d eta^2."""
    fam = md.family
    if fam == 0:
        return torch.exp(theta[-1]).expand(eta.shape)   # 1/sigma^2
    if fam == 1:
        return torch.exp(eta)
    if fam == 2:
        p = torch.sigmoid(eta)
        return md.size * p * (1.0 - p)
    raise _unsupported(fam)


def eta_residual(eta, md, theta):
    """d(-log_lik)/d eta, elementwise."""
    fam = md.family
    if fam == 0:
        return (eta - md.y) * torch.exp(theta[-1])
    if fam == 1:
        return torch.exp(eta) - md.y
    if fam == 2:
        return md.size * torch.sigmoid(eta) - md.y
    raise _unsupported(fam)
