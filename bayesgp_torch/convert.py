"""Carry a banded IWP model and its latent states between packages.

A single-IWP backend is a set of host arrays (sorted sparse design rows,
the orthogonalized tail, the prior band, the coordinate change) plus
the likelihood data. `fast_iwp_from_arrays` builds this package's
FastIWPBackend on a device from such arrays, for instance the numpy
arrays of the JAX package's FastIWPBackend, so both packages can run the
same model; `fast_iwp_arrays` gives the arrays of a backend built here.
`latent_state` moves a latent state (V, tail) onto a device: one fit's
(dpad,), (q,) or a replicate batch's (R, dpad), (R, q).
`replicate_responses` checks the (R, n) raw-order responses of a
replicate fit, which both packages take as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from .fast import iwp
from .model.build import ModelData

# backend fields carried as arrays (FastIWPBackend of either package)
ARRAY_FIELDS = ("valsT", "start", "seg_lo", "seg_hi", "XFpT", "Z0", "PZ0",
                "Z0PZ0", "P_band", "Tdiags", "prior_diag_tail",
                "prior_mean_tail")
# ModelData fields the likelihood and the hyperprior read
MODEL_FIELDS = ("y", "size", "logPdet", "u", "alpha")


def fast_iwp_arrays(be) -> dict:
    """Host numpy arrays of a FastIWPBackend: ARRAY_FIELDS, the
    MODEL_FIELDS of its (row-sorted) ModelData, and the scalars p, d,
    dpad, family, logdetT, row_order."""
    out = {f: _host(getattr(be, f)) for f in ARRAY_FIELDS}
    out.update({f: _host(getattr(be.md, f)) for f in MODEL_FIELDS})
    out.update(p=int(be.p), d=int(be.d), dpad=int(be.dpad),
               family=int(be.md.family), logdetT=float(be.logdetT),
               row_order=np.asarray(be.row_order))
    return out


def fast_iwp_from_arrays(arrs: dict, term=None, device="cuda"):
    """FastIWPBackend on `device` from the dict fast_iwp_arrays returns
    (or the same fields read off the JAX package's backend). `term` is
    the IWP TermDesign, kept for post-fit use; it may be None."""
    p, d = int(arrs["p"]), int(arrs["d"])
    y = np.asarray(arrs["y"], np.float64)
    n = len(y)
    md = ModelData(
        A=np.zeros((n, 0)), y=y, P_blocks=(),
        logPdet=np.asarray(arrs["logPdet"], np.float64),
        u=np.asarray(arrs["u"], np.float64),
        alpha=np.asarray(arrs["alpha"], np.float64),
        betaprec=np.zeros(0), betamean=np.zeros(0), bf_prec=np.zeros(0),
        bf_mean=np.zeros(0), size=np.asarray(arrs["size"], np.float64),
        cens=np.zeros(0), ranks=np.zeros(0, np.int64),
        case_day=np.zeros(0, np.int64),
        control_days=np.zeros((0, 0), np.int64), count=np.zeros(0),
        family=int(arrs["family"]), d_sizes=(d,),
        x_sizes=(p - 1,) if p > 1 else (),
        xf_count=int(np.shape(arrs["XFpT"])[0]) - (p - 1))
    return iwp.from_arrays(term, md, p, d, int(arrs["dpad"]),
                           {f: arrs[f] for f in ARRAY_FIELDS},
                           float(arrs["logdetT"]), arrs["row_order"],
                           device)


def latent_state(V, tail, device="cuda"):
    """(V, tail) as f64 tensors on `device`: (dpad,), (q,) of one fit or
    (R, dpad), (R, q) of a replicate batch (the JAX package's batched
    state has the same layout)."""
    V = np.asarray(V, np.float64)
    tail = np.asarray(tail, np.float64)
    if V.ndim != tail.ndim or V.shape[:-1] != tail.shape[:-1]:
        raise ValueError(f"V {V.shape} and tail {tail.shape} do not belong "
                         "to one latent state")
    return (torch.tensor(V, device=device), torch.tensor(tail, device=device))


def replicate_responses(ys, be) -> np.ndarray:
    """(R, n) f64 raw-order responses for backend `be`, checked."""
    ys = np.asarray(ys, np.float64)
    n = len(be.row_order)
    if ys.ndim != 2 or ys.shape[1] != n:
        raise ValueError(f"responses must be (R, {n}), got {ys.shape}")
    return ys


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
