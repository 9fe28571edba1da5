"""Model assembly: stack per-term designs into one ModelData pytree.

This replaces the reference's `tmbdat` marshalling
(R/02_model_fit.R:30-252) and SEXP unmarshalling (src/BayesGP.cpp:6-28):
the model is a frozen dataclass of host arrays plus layout metadata.

W layout (identical to the reference, src/BayesGP.cpp:76 and
R/02_model_fit.R:627-675):
    W = [U_1 .. U_r | beta_1 .. beta_rX | beta_fixed (intercept, fixed...)]
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from .families import custom_family as registered_family

FAMILY_CODES = {
    "Gaussian": 0, "Poisson": 1, "Binomial": 2,
    "Coxph": 3, "coxph": 3,
    "casecrossover": 4, "cc": 4, "CaseCrossover": 4,
    "Customized": -1,
    "none": -2,
}


@dataclasses.dataclass(frozen=True)
class ModelData:
    """All arrays the objective needs, plus layout info."""
    # --- data fields ---
    A: Any                      # (n, w) stacked design [B.. | X.. | Xf]
    y: Any                      # (n,)
    P_blocks: Tuple[Any, ...]   # per-RE penalty (d_r, d_r)
    logPdet: Any                # (r,)
    u: Any                      # (r [+1 if Gaussian],) PC-prior u
    alpha: Any                  # same length as u
    betaprec: Any               # (n_boundary_blocks,)
    betamean: Any               # (n_boundary_blocks,)
    bf_prec: Any                # (n_fixed_cols,)
    bf_mean: Any                # (n_fixed_cols,)
    size: Any                   # Binomial size (n,) or ()
    cens: Any                   # Coxph censoring (n,) or ()
    ranks: Any                  # Coxph min-ties ranks (n,) or ()
    case_day: Any               # cc (n_case,) 1-based or ()
    control_days: Any           # cc (n_case, K) 1-based, 0 = padding, or ()
    count: Any                  # cc (n_case,) or ()
    # --- layout metadata ---
    family: int
    d_sizes: Tuple[int, ...]
    x_sizes: Tuple[int, ...]
    xf_count: int
    custom_family: str = ""     # name of a registered customized family
    # made by objective.to_device from the fields above (model/families.py)
    rank_wts: Any = None        # Coxph event mass per rank (n,)
    cc_plan: Any = None         # cc gathers (families.CCPlan)

    @property
    def n(self):
        return self.A.shape[0]

    @property
    def w_count(self):
        return self.A.shape[1]

    @property
    def n_theta(self):
        return len(self.d_sizes) + _n_family_theta(self.family,
                                                   self.custom_family)

    def u_slices(self):
        out, off = [], 0
        for d in self.d_sizes:
            out.append((off, d))
            off += d
        return out

    def beta_slices(self):
        out, off = [], sum(self.d_sizes)
        for b in self.x_sizes:
            out.append((off, b))
            off += b
        return out

    def fixed_offset(self):
        return sum(self.d_sizes) + sum(self.x_sizes)


def _n_family_theta(fam, custom_family):
    """Hyperparameters of the likelihood: the Gaussian's noise, a
    customized family's registered extras."""
    if fam == 0:
        return 1
    if fam == -1 and custom_family:
        return registered_family(custom_family)[1]
    return 0


def _rank_min(y: np.ndarray) -> np.ndarray:
    """R's rank(y, ties.method='min'), 1-based."""
    order = np.argsort(y, kind="stable")
    sorted_y = y[order]
    # first index (0-based) of each value's tie group
    first = np.searchsorted(sorted_y, sorted_y, side="left")
    ranks = np.empty(len(y), dtype=np.int64)
    ranks[order] = first + 1
    return ranks


def build_cc_strata(case: np.ndarray, strata: np.ndarray,
                    weight: Optional[np.ndarray]):
    """Replicates the case-crossover data prep (R/02_model_fit.R:198-247).

    Returns (case_day, control_days, count), 1-based indices with 0 padding.
    The first column of control_days is the case day itself (reference
    behavior — the conditional-likelihood denominator therefore includes
    the case day plus an implicit exp(0)=1 from the logspace_add chain
    seeded at 0, src/BayesGP.cpp:196-209).
    """
    case = np.asarray(case)
    if weight is None:
        weight = case
    case_day = np.where(case > 0)[0] + 1
    count = np.asarray(weight)[case_day - 1]

    # unique strata in order of first appearance (R unique())
    _, idx = np.unique(strata, return_index=True)
    unique_strata = strata[np.sort(idx)]
    max_N = max(int(np.sum((strata == s) & (case == 0))) for s in unique_strata)

    rows = []
    for s in unique_strata:
        case_idx = np.where((strata == s) & (case > 0))[0] + 1
        ctrl_idx = np.where((strata == s) & (case == 0))[0] + 1
        for ci in case_idx:
            row = np.zeros(max_N + 1, dtype=np.int64)
            row[0] = ci
            row[1:1 + len(ctrl_idx)] = ctrl_idx
            rows.append(row)
    control_days = np.stack(rows) if rows else np.zeros((0, max_N + 1), np.int64)
    return case_day.astype(np.int64), control_days, count.astype(np.float64)


def build_model_data(terms, design_mat_fixed, y, family: str, *,
                     control_family=None, control_fixed_prec=None,
                     control_fixed_mean=None, size=None, cens=None,
                     cc_arrays=None, dtype=np.float64,
                     dense_design=True, custom_family: str = "") -> ModelData:
    """Assemble ModelData from constructed TermDesigns and fixed designs.

    `design_mat_fixed`: list of (n, 1) columns ([intercept], fixed...).
    `control_fixed_prec/mean`: arrays aligned with design_mat_fixed columns.
    `cc_arrays`: optional (case_day, control_days, count) for family='cc'.
    `dense_design=False` skips materializing the stacked (n, w) design —
    used by the banded fast backend, which keeps sparse rows instead.
    """
    fam = FAMILY_CODES[family]
    n = len(y)
    if dense_design:
        B_cols = [t.ensure_B() for t in terms]
        X_cols = [t.X for t in terms if t.X.shape[1] > 0]
        parts = B_cols + X_cols + list(design_mat_fixed)
        A = np.concatenate(parts, axis=1) if parts else np.zeros((n, 0))
    else:
        A = np.zeros((n, 0))

    d_sizes = tuple(int(t.num_basis) for t in terms)
    x_sizes = tuple(int(t.X.shape[1]) for t in terms if t.X.shape[1] > 0)
    xf_count = sum(int(np.shape(x)[1]) for x in design_mat_fixed)

    u = [t.sd_prior["param"]["u"] for t in terms]
    alpha = [t.sd_prior["param"]["alpha"] for t in terms]
    for _ in range(_n_family_theta(fam, custom_family)):
        cf = control_family or {"sd_prior": {"param": {"u": 1.0, "alpha": 0.5}}}
        u.append(cf["sd_prior"]["param"]["u"])
        alpha.append(cf["sd_prior"]["param"]["alpha"])

    betaprec = [t.boundary_prior["prec"] for t in terms
                if t.X.shape[1] > 0 and t.boundary_prior is not None]
    betamean = [t.boundary_prior["mean"] for t in terms
                if t.X.shape[1] > 0 and t.boundary_prior is not None]

    logPdet = [t.logPdet for t in terms]

    y = np.asarray(y, dtype=dtype)
    empty = np.zeros((0,), dtype)
    kw = dict(
        A=np.asarray(A, dtype=dtype), y=y,
        # lazy IID terms (P = I implied) carry a (0, 0) sentinel — the
        # banded engine's merged-IID path never reads it
        P_blocks=tuple(np.asarray(t.P, dtype=dtype) if t.P is not None
                       else np.zeros((0, 0), dtype) for t in terms),
        logPdet=np.asarray(logPdet, dtype=dtype),
        u=np.asarray(u, dtype=dtype), alpha=np.asarray(alpha, dtype=dtype),
        betaprec=np.asarray(betaprec, dtype=dtype),
        betamean=np.asarray(betamean, dtype=dtype),
        bf_prec=np.asarray(control_fixed_prec if control_fixed_prec is not None
                           else np.full(xf_count, 0.01), dtype=dtype),
        bf_mean=np.asarray(control_fixed_mean if control_fixed_mean is not None
                           else np.zeros(xf_count), dtype=dtype),
        size=empty, cens=empty, ranks=np.zeros((0,), np.int64),
        case_day=np.zeros((0,), np.int64),
        control_days=np.zeros((0, 0), np.int64), count=empty,
        family=fam, d_sizes=d_sizes, x_sizes=x_sizes, xf_count=xf_count,
        custom_family=custom_family,
    )
    if fam == 2:
        kw["size"] = (np.ones(n, dtype) if size is None
                      else np.asarray(size, dtype=dtype))
    if fam == 3:
        kw["ranks"] = _rank_min(np.asarray(y, dtype=np.float64))
        kw["cens"] = (np.ones(n, dtype) if cens is None
                      else np.asarray(cens, dtype=dtype))
    if fam == 4:
        case_day, control_days, count = cc_arrays
        kw["case_day"] = case_day
        kw["control_days"] = control_days
        kw["count"] = np.asarray(count, dtype=dtype)
    return ModelData(**kw)
