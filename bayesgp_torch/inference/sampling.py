"""Posterior sampling of the latent field: the mixture-over-nodes
Gaussian draws of aghq::sample_marginal. Draw a node j ~ Categorical
(posterior node weights), then W ~ N(W*_j, H_j^{-1}) through the
backend's banded solves."""
from __future__ import annotations

import numpy as np
import torch


def sample_marginal(fit, M: int, generator: torch.Generator):
    """((w, M) latent samples, (M,) node indices, (M, s) theta samples),
    as host numpy.

    The node indices and the (dpad + q, M) standard normal noise, shared
    by the nodes, come from `generator`, which must live on the fit's
    device."""
    be = fit.backend
    dev = be.device
    logits = torch.as_tensor(fit.logpost_nodes + fit.logw,
                             dtype=torch.float64, device=dev)
    idx = torch.multinomial(torch.softmax(logits, dim=0), M,
                            replacement=True, generator=generator)
    zb = torch.randn((be.dpad, M), dtype=torch.float64, device=dev,
                     generator=generator)
    zd = torch.randn((be.q, M), dtype=torch.float64, device=dev,
                     generator=generator)
    samps = be.sample(fit.states, idx, zb, zd).cpu().numpy()
    idx = idx.cpu().numpy()
    return samps, idx, np.asarray(fit.nodes)[idx]
