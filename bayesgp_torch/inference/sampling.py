"""Posterior sampling of the latent field.

- `sample_marginal`: the mixture-over-nodes Gaussian draws of
  aghq::sample_marginal. Draw a node j ~ Categorical(posterior node
  weights), then W ~ N(W*_j, H_j^{-1}) through the backend's solves.
- `sample_mvn_precision`: precision-parameterized Gaussian draws, the
  equivalent of LaplacesDemon::rmvnp for the nlminb route
  (R/02_model_fit.R:691).
"""
from __future__ import annotations

import numpy as np
import torch


def sample_marginal(fit, M: int, generator: torch.Generator):
    """((w, M) latent samples, (M,) node indices, (M, s) theta samples),
    as host numpy.

    The node indices and the standard normal noise, one (rows, M) block
    for each entry of the backend's noise_rows() and shared by the nodes,
    come from `generator`, which must live on the fit's device."""
    be = fit.backend
    dev = be.device
    logits = torch.as_tensor(fit.logpost_nodes + fit.logw,
                             dtype=torch.float64, device=dev)
    idx = torch.multinomial(torch.softmax(logits, dim=0), M,
                            replacement=True, generator=generator)
    noise = [torch.randn((rows, M), dtype=torch.float64, device=dev,
                         generator=generator) for rows in be.noise_rows()]
    samps = be.sample(fit.states, idx, *noise).cpu().numpy()
    idx = idx.cpu().numpy()
    return samps, idx, np.asarray(fit.nodes)[idx]


def sample_mvn_precision(generator: torch.Generator, mean, prec, M: int):
    """(w, M) host numpy draws of N(mean, prec^{-1}): mean + U^{-1} z with
    U the upper Cholesky factor of prec and z standard normal from
    `generator`, which must live on the tensors' device."""
    U = torch.linalg.cholesky(prec, upper=True)
    z = torch.randn((mean.shape[0], M), dtype=mean.dtype,
                    device=mean.device, generator=generator)
    dev = torch.linalg.solve_triangular(U, z, upper=True)
    return (mean[:, None] + dev).cpu().numpy()
