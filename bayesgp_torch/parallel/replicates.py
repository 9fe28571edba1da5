"""Replicate fits: R responses on one single-IWP design, one GPU.

A simulation study fits the same model to R independent responses.
`replicate_fits` runs the one-response AGHQ fit (inference/aghq.aghq_fit)
on one response after another. `replicate_fits_packed` fits them in lock
step on the batched backend (fast/batched.py): all R band factorizations
and solves of a Newton step are one launch of the batched band kernels
and every O(n) design product carries the replicate axis, so one host
launch serves R fits. Both return (modes (R,), lognormconsts (R,)) as
numpy arrays and agree to optimizer tolerance.

Sharding the replicates over several devices (`mesh=`) is not ported
yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import replicate_responses
from ..fast.batched import (ll_const_np, make_batched, make_engine_batched,
                            max_replicates)
from ..inference import aghq


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "replicate fits sharded over a device mesh are not ported yet "
            "(ROADMAP Queue 1 item 11)")


def replicate_fits(backend, ys, k: int = 4, mesh=None):
    """AGHQ-fit R replicate responses on one design, one after another.

    backend: a FastIWPBackend (fast/iwp.py); ys: (R, n) responses in raw
    data order. Returns (modes (R,), lognormconsts (R,))."""
    _no_mesh(mesh)
    modes, lncs = [], []
    for y in replicate_responses(ys, backend):
        fit = aghq.aghq_fit(backend.with_y(y), k=k)
        modes.append(float(fit.mode[0]))
        lncs.append(fit.lognormconst)
    return np.asarray(modes), np.asarray(lncs)


def replicate_fits_packed(backend, ys, k: int = 4, mesh=None,
                          force_engine: str = None, group_size: int = None):
    """AGHQ-fit R replicates in lock step on the batched backend.

    backend: a FastIWPBackend with one hyperparameter (Poisson,
    Binomial); ys: (R, n) responses in raw data order. The replicates run
    in groups of min(R, group_size); group_size defaults to
    fast/batched.max_replicates, a memory cap. The last group is filled
    up by repeating the last response. force_engine: None | "kernels" |
    "plain" (fast/batched.make_engine_batched).
    Returns (modes (R,), lognormconsts (R,))."""
    _no_mesh(mesh)
    ys = replicate_responses(ys, backend)
    R, n = ys.shape
    if group_size is None:
        group_size = max_replicates(backend.p, n, backend.q)
    if group_size < 1:
        raise ValueError("group_size must be at least 1")
    NRg = min(R, group_size)
    ys_int = ys[:, np.asarray(backend.row_order)]
    llc = ll_const_np(backend, ys_int)
    _, logw_base = aghq.product_grid(k, 1)
    logw_base = torch.as_tensor(logw_base, dtype=torch.float64,
                                device=backend.device)

    def lnc_of(nlls, H):
        """(NRg, k), (NRg,) -> per-replicate lognormconst."""
        Lad = torch.rsqrt(torch.clamp(H.abs(), min=1e-8))
        return torch.logsumexp(-nlls + logw_base + torch.log(Lad)[:, None],
                               dim=1)

    pad = (-R) % NRg
    if pad:
        ys_int = np.concatenate([ys_int, ys_int[-1:].repeat(pad, 0)])
        llc = np.concatenate([llc, llc[-1:].repeat(pad)])
    engine = make_engine_batched(backend, NRg, force_engine)
    modes, lncs = [], []
    for g0 in range(0, ys_int.shape[0], NRg):
        bbg = make_batched(backend, ys_int[g0:g0 + NRg], llc[g0:g0 + NRg],
                           NRg, engine)
        mode, H, _, nlls = aghq.fit_1d_batched(bbg, k)
        modes.append(mode.cpu().numpy())
        lncs.append(lnc_of(nlls, H).cpu().numpy())
    return np.concatenate(modes)[:R], np.concatenate(lncs)[:R]
