"""Carry a banded IWP model and its latent states between packages.

A single-IWP backend is a set of host arrays (sorted sparse design rows,
the orthogonalized tail, the prior band, the coordinate change) plus
the likelihood data. `fast_iwp_from_arrays` builds this package's
FastIWPBackend on a device from such arrays, for instance the numpy
arrays of the JAX package's FastIWPBackend, so both packages can run the
same model; `fast_iwp_arrays` gives the arrays of a backend built here.
`latent_state` moves a latent state (V, tail) onto a device: one fit's
(dpad,), (q,) or a replicate batch's (R, dpad), (R, q).
A scattered-IID backend is such a core plus level codes and the IID
term's constants: `scatter_iid_arrays` / `scatter_iid_from_arrays` carry
it, and `latent_state_iid` its three-part state (V, u, tail). A
multi-term banded backend is the driver's band arrays plus the tail and
diagonal terms' priors and the reference-order permutation:
`banded_arrays` / `banded_from_arrays` carry it (its latent state is
(V, tail), as a single-IWP backend's).
`replicate_responses` checks the (R, n) raw-order responses of a
replicate fit, which both packages take as numpy.
A dense model is a ModelData: `model_data_arrays` gives its arrays and
layout as host numpy (of either package's ModelData),
`model_data_from_arrays` this package's ModelData with them as tensors on
a device, which the dense objective and Laplace functions take. A
customized family travels by its name, registered in each package with
that package's loglik.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fast import banded, iwp, scatter_iid
from .model.build import ModelData
from .model.objective import to_device

# backend fields carried as arrays (FastIWPBackend of either package)
ARRAY_FIELDS = ("valsT", "start", "seg_lo", "seg_hi", "XFpT", "Z0", "PZ0",
                "Z0PZ0", "P_band", "Tdiags", "prior_w", "prior_diag_tail",
                "prior_mean_tail")
# ModelData fields the likelihood and the hyperprior read
MODEL_FIELDS = ("y", "size", "logPdet", "u", "alpha")
# BandedBackend fields (either package): arrays, optional arrays, scalars
BANDED_FIELDS = ("valsT", "start", "XFpT", "Z0", "PZ0", "Z0PZ0", "P_band",
                 "Tdiags", "prior_w", "prior_diag_tail", "prior_mean_tail",
                 "ref_perm")
BANDED_OPTIONAL = ("prior_diag_band", "Z0PZ0_pad")
BANDED_SCALARS = ("drv_theta", "Wl", "G", "d", "dpad", "d_drv",
                  "logPdet_drv", "logdetT", "w_real")


# ModelData fields carried by model_data_arrays: arrays, then layout
DENSE_FIELDS = ("A", "y", "P_blocks", "logPdet", "u", "alpha", "betaprec",
                "betamean", "bf_prec", "bf_mean", "size", "cens", "ranks",
                "case_day", "control_days", "count")
LAYOUT_FIELDS = ("family", "d_sizes", "x_sizes", "xf_count",
                 "custom_family")


def model_data_arrays(md) -> dict:
    """Host numpy arrays (P_blocks a tuple of them) and the layout of a
    ModelData of either package."""
    out = {f: (tuple(_host(b) for b in md.P_blocks) if f == "P_blocks"
               else _host(getattr(md, f))) for f in DENSE_FIELDS}
    out.update(family=int(md.family),
               d_sizes=tuple(int(x) for x in md.d_sizes),
               x_sizes=tuple(int(x) for x in md.x_sizes),
               xf_count=int(md.xf_count),
               custom_family=str(md.custom_family))
    return out


def model_data_from_arrays(arrays: dict, device="cuda") -> ModelData:
    """This package's ModelData from the dict model_data_arrays returns,
    its arrays f64 (index arrays int64) tensors on `device`."""
    md = ModelData(**{f: arrays[f] for f in DENSE_FIELDS + LAYOUT_FIELDS})
    return to_device(md, device)


def _model_data(arrs, d_sizes, x_sizes, xf_count):
    """ModelData of a backend carried as arrays (no dense design)."""
    y = np.asarray(arrs["y"], np.float64)
    return ModelData(
        A=np.zeros((len(y), 0)), y=y, P_blocks=(),
        logPdet=np.asarray(arrs["logPdet"], np.float64),
        u=np.asarray(arrs["u"], np.float64),
        alpha=np.asarray(arrs["alpha"], np.float64),
        betaprec=np.zeros(0), betamean=np.zeros(0), bf_prec=np.zeros(0),
        bf_mean=np.zeros(0), size=np.asarray(arrs["size"], np.float64),
        cens=np.zeros(0), ranks=np.zeros(0, np.int64),
        case_day=np.zeros(0, np.int64),
        control_days=np.zeros((0, 0), np.int64), count=np.zeros(0),
        family=int(arrs["family"]), d_sizes=tuple(d_sizes),
        x_sizes=tuple(x_sizes), xf_count=int(xf_count))


def fast_iwp_arrays(be) -> dict:
    """Host numpy arrays of a FastIWPBackend: ARRAY_FIELDS, the
    MODEL_FIELDS of its (row-sorted) ModelData, and the scalars p, d,
    dpad, family, logdetT, row_order."""
    out = {f: _field(be, f) for f in ARRAY_FIELDS}
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
    md = _model_data(arrs, (d,), (p - 1,) if p > 1 else (),
                     int(np.shape(arrs["XFpT"])[0]) - (p - 1))
    return iwp.from_arrays(term, md, p, d, int(arrs["dpad"]),
                           {f: arrs[f] for f in ARRAY_FIELDS},
                           float(arrs["logdetT"]), arrs["row_order"],
                           device)


def scatter_iid_arrays(be) -> dict:
    """Host arrays of a ScatterIIDBackend: its core's (fast_iwp_arrays),
    the level codes in the core's row order, and the IID term's
    constants."""
    md = be.md
    return dict(core=fast_iwp_arrays(be.core), codes=_host(be.codes),
                q_iid=int(be.q_iid), logPdet_iid=float(be.logPdet_iid),
                u=np.asarray(md.u, np.float64),
                alpha=np.asarray(md.alpha, np.float64),
                d_sizes=tuple(int(x) for x in md.d_sizes))


def scatter_iid_from_arrays(arrs: dict, term=None, device="cuda"):
    """ScatterIIDBackend on `device` from the dict scatter_iid_arrays
    returns (or the same fields read off the JAX package's backend).
    `term`: the IWP TermDesign."""
    core = fast_iwp_from_arrays(arrs["core"], term=term, device=device)
    md = dataclasses.replace(
        core.md, u=np.asarray(arrs["u"], np.float64),
        alpha=np.asarray(arrs["alpha"], np.float64),
        d_sizes=tuple(arrs["d_sizes"]))
    return scatter_iid.from_core(core, md, arrs["codes"], arrs["q_iid"],
                                 logPdet_iid=arrs["logPdet_iid"])


def banded_arrays(be, knots=None) -> dict:
    """Host arrays of a BandedBackend (either package's): BANDED_FIELDS,
    BANDED_OPTIONAL (None without padded merged slots), BANDED_SCALARS,
    the tail and diagonal terms as dicts of their fields, and the
    MODEL_FIELDS and layout of its (row-sorted) ModelData. `knots`: the
    driver's, for a backend that holds neither prior_w nor its term (the
    JAX package's)."""
    md = be.md
    out = {f: _field(be, f, knots) for f in BANDED_FIELDS}
    for f in BANDED_OPTIONAL:
        v = getattr(be, f)
        out[f] = None if v is None else _host(v)
    out.update({f: getattr(be, f) for f in BANDED_SCALARS})
    out["tail_terms"] = [
        dict(offset=int(t.offset), size=int(t.size),
             theta_idx=int(t.theta_idx), P=_host(t.P),
             logPdet=float(t.logPdet), d_size=int(t.d_size))
        for t in be.tail_terms]
    out["band_terms"] = [
        dict(theta_idx=int(t.theta_idx), mask=_host(t.mask),
             d_size=int(t.d_size), logPdet=float(t.logPdet),
             Z0PZ0=_host(t.Z0PZ0))
        for t in be.band_terms]
    out.update({f: _host(getattr(md, f)) for f in MODEL_FIELDS})
    out.update(family=int(md.family),
               d_sizes=tuple(int(x) for x in md.d_sizes),
               x_sizes=tuple(int(x) for x in md.x_sizes),
               xf_count=int(md.xf_count))
    return out


def banded_from_arrays(arrs: dict, term=None, device="cuda"):
    """BandedBackend on `device` from the dict banded_arrays returns (for
    instance of the JAX package's backend). `term`: the driver's
    TermDesign, kept for post-fit use; it may be None."""
    md = _model_data(arrs, arrs["d_sizes"], arrs["x_sizes"],
                     arrs["xf_count"])
    arrays = {f: arrs[f] for f in BANDED_FIELDS + BANDED_OPTIONAL}
    scalars = {f: arrs[f] for f in BANDED_SCALARS}
    return banded.from_arrays(term, md, arrays, scalars, arrs["tail_terms"],
                              arrs["band_terms"], device=device)


def latent_state_iid(V, u, tail, device="cuda"):
    """(V, u, tail) of a scattered-IID model as f64 tensors on `device`."""
    return tuple(torch.tensor(np.asarray(a, np.float64), device=device)
                 for a in (V, u, tail))


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


def driver_prior_w(be, knots=None) -> np.ndarray:
    """(d,) weights w of the driver prior P = T^T diag(w) T of a
    single-IWP or banded backend of either package: its prior_w, or, for
    the JAX package's (which holds no w), diff of the driver's knots
    (`knots`, else be.term.knots) at stride G, 0 on a merged band's level
    and padded columns."""
    if getattr(be, "prior_w", None) is not None:
        return _host(be.prior_w)
    if knots is None:
        knots = be.term.knots
    w = np.zeros(int(be.d))
    G, d_drv = int(getattr(be, "G", 1)), int(getattr(be, "d_drv", be.d))
    w[np.arange(d_drv) * G] = np.diff(np.asarray(knots, np.float64))
    return w


def _field(be, f, knots=None):
    if f == "prior_w":
        return driver_prior_w(be, knots)
    return _host(getattr(be, f))


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
