"""Posterior sampling of the latent field: the mixture-over-nodes
Gaussian draws of aghq::sample_marginal. Draw a node j ~ Categorical
(posterior node weights), then W ~ N(W*_j, H_j^{-1}) through the
backend's solves."""
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
