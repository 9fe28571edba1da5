"""Random-effect term specifications and their design/precision builds.

Mirrors the reference's S4 instances (IWP/sGP/IID/Customized,
R/01_utility.R:33-63) and the per-term construction logic inside
`model_fit` (R/02_model_fit.R:358-570): prior normalization, knot
placement, initial_location shift, and X/B/P assembly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from .basis import osplines, sgp as sgp_basis


def normalize_sd_prior(sd_prior) -> dict:
    """Reference prior-normalization (R/02_model_fit.R:373-413).

    Returns {"prior": "exp", "param": {"u":..., "alpha":...}, ["h":...]}.
    """
    if sd_prior is None:
        return {"prior": "exp", "param": {"u": 1.0, "alpha": 0.5}}
    if isinstance(sd_prior, (int, float)):
        return {"prior": "exp", "param": {"u": float(sd_prior), "alpha": 0.5}}
    sd_prior = dict(sd_prior)
    sd_prior.setdefault("prior", "exp")
    if "param" not in sd_prior:
        raise ValueError("sd.prior provided as a dict must contain 'param'")
    param = sd_prior["param"]
    if isinstance(param, (int, float)):
        param = {"u": float(param), "alpha": 0.5}
    else:
        param = dict(param)
        if "u" not in param:
            raise ValueError("sd.prior$param must contain u")
        param.setdefault("alpha", 0.5)
    sd_prior["param"] = param
    ok = {"exp", "Exp", "exponential", "Exponential", "Customized"}
    if sd_prior["prior"] not in ok:
        raise ValueError("sd.prior only supports 'exp' or 'Customized'")
    if not (0.0 <= param["alpha"] <= 1.0) and sd_prior["prior"] != "Customized":
        raise ValueError("sd.prior$param$alpha must be a probability")
    return sd_prior


def normalize_boundary_prior(boundary_prior) -> dict:
    """Default boundary-coefficient prior (R/02_model_fit.R:444-451)."""
    bp = dict(boundary_prior) if boundary_prior else {}
    bp.setdefault("prec", 0.01)
    bp.setdefault("mean", 0.0)
    return bp


@dataclass
class TermDesign:
    """A constructed random-effect term: design matrices + metadata.

    X: (n, n_boundary) global/boundary design (may have 0 columns)
    B: (n, d) local basis design
    P: (d, d) spline-weight precision
    """
    kind: str                      # "IWP" | "sGP" | "IID" | "Customized"
    smoothing_var: str
    X: np.ndarray
    B: Optional[np.ndarray]        # dense local design; None when the
    #                                banded fast path skips materializing it
    P: np.ndarray
    sd_prior: dict
    boundary_prior: Optional[dict] = None
    # IWP / sGP extras used at predict time
    order: int = 0
    knots: Optional[np.ndarray] = None
    initial_location: float = 0.0
    observed_x: Optional[np.ndarray] = None   # sorted shifted x (predict)
    x_data: Optional[np.ndarray] = None       # shifted x in data row order
    a: float = 0.0
    m: int = 1
    k: int = 0
    region: Optional[np.ndarray] = None
    accuracy: float = 0.01
    boundary: bool = True
    # IID extras
    levels: Optional[np.ndarray] = None
    extra: dict = field(default_factory=dict)

    @property
    def logPdet(self) -> float:
        if self.P is None:          # lazy IID: P = I implied
            return 0.0
        # IWP / IID penalties are diagonal — avoid an O(d^3) slogdet
        off_diag = self.P - np.diag(np.diagonal(self.P))
        if not off_diag.any():
            return float(np.sum(np.log(np.diagonal(self.P))))
        sign, logdet = np.linalg.slogdet(self.P)
        return float(logdet)

    @property
    def num_basis(self) -> int:
        """Number of local-basis columns (d_r) without requiring B."""
        if self.B is not None:
            return self.B.shape[1]
        if self.P is not None:
            return self.P.shape[1]
        return len(self.levels)     # lazy IID

    def ensure_B(self):
        """Materialize the dense local design if it was skipped."""
        if self.B is None and self.kind == "IID":
            # lazy IID fallback (small enough to densify after all)
            codes = self.extra["codes"]
            q = len(self.levels)
            B = np.zeros((len(codes), q))
            B[np.arange(len(codes)), codes] = 1.0
            self.B = B
            self.P = np.eye(q)
            return self.B
        if self.B is None:
            if self.x_data is None:
                raise ValueError("cannot materialize B for this term")
            if self.kind == "IWP":
                self.B = osplines.local_poly_helper(self.knots, self.x_data,
                                                    p=self.order)
            elif self.kind == "sGP":
                # fit-time semantics: boundary always True (see
                # build_sgp_term docstring)
                blocks = [sgp_basis.compute_B_sB(self.x_data, self.a * i,
                                                 self.k, self.region,
                                                 boundary=True)
                          for i in range(1, self.m + 1)]
                self.B = np.concatenate(blocks, axis=1)
            else:
                raise ValueError("cannot materialize B for this term")
        return self.B


def build_iwp_term(smoothing_var: str, x: np.ndarray, *, order: int,
                   k: Optional[int] = None, knots=None,
                   sd_prior=None, boundary_prior=None,
                   initial_location=None, materialize_B=True) -> TermDesign:
    """IWP term build (reference R/02_model_fit.R:415-470).

    Knots: `k` (default 5) uniform points over the shifted observed range;
    X = monomials [x, x^2/..., x^{p-1}] (intercept column dropped,
    R/02_model_fit.R:460); B = O-spline local basis; P = diag(diff(knots)).
    """
    sd_prior = normalize_sd_prior(sd_prior)
    boundary_prior = normalize_boundary_prior(boundary_prior)
    x = np.asarray(x, dtype=np.float64)
    if order is None or order < 1:
        raise ValueError("IWP order must be >= 1")
    if k is not None and k < 3:
        raise ValueError("k should be >= 3")
    if initial_location is None:
        initial_location = float(x.min())
    xs = x - initial_location
    if knots is None:
        kk = 5 if k is None else int(k)
        knots = np.unique(np.linspace(xs.min(), xs.max(), kk))
    else:
        knots = np.asarray(knots, dtype=np.float64)
    X = osplines.global_poly_helper(xs, p=order)[:, 1:]
    B = osplines.local_poly_helper(knots, xs, p=order) if materialize_B else None
    P = osplines.compute_weights_precision(knots)
    return TermDesign(
        kind="IWP", smoothing_var=smoothing_var, X=X, B=B, P=P,
        sd_prior=sd_prior, boundary_prior=boundary_prior, order=int(order),
        knots=knots, initial_location=float(initial_location),
        observed_x=np.sort(xs), x_data=xs)


def build_sgp_term(smoothing_var: str, x: np.ndarray, *, a=None, freq=None,
                   period=None, k: Optional[int] = None, m: int = 1,
                   sd_prior=None, boundary_prior=None, initial_location=None,
                   region=None, accuracy: float = 0.01,
                   boundary: bool = True, materialize_B=True) -> TermDesign:
    """sGP term build (reference R/02_model_fit.R:493-569).

    X = cos/sin harmonics; B = sB basis stacked over harmonics; P =
    block-diag of Compute_Q_sB per harmonic. NOTE the reference ignores the
    `boundary` flag at fit time (compute_B sGP method R/01_utility.R:236
    calls Compute_B_sB without it) but honors it at predict — replicated.
    """
    sd_prior = normalize_sd_prior(sd_prior)
    boundary_prior = normalize_boundary_prior(boundary_prior)
    x = np.asarray(x, dtype=np.float64)
    if a is None:
        if freq is not None:
            a = 2.0 * math.pi * freq
        elif period is not None:
            a = 2.0 * math.pi / period
        else:
            raise ValueError("sGP needs one of a=, freq=, period=")
    if a < 0:
        raise ValueError("sGP parameter a must be positive")
    if k is None:
        k = 30
    elif k < 3:
        raise ValueError("k should be >= 3")
    if initial_location is None:
        initial_location = float(x.min())
    xs = x - initial_location
    observed_x = np.sort(xs)
    if region is None:
        region = np.array([observed_x.min(), observed_x.max()])
    else:
        region = np.asarray(region, dtype=np.float64)

    # fit-time harmonics anchor at initial_location with NO further
    # re-centering (reference global_poly sGP method, R/01_utility.R:
    # 301-312 — unlike the predict-time helper's min-recentering)
    X = sgp_basis.global_poly_sgp(xs, a=a, m=m, initial_location=0.0)
    # fit-time B always uses boundary=True (reference quirk, see docstring)
    if materialize_B:
        blocks = [sgp_basis.compute_B_sB(xs, a * i, k, region, boundary=True)
                  for i in range(1, m + 1)]
        B = np.concatenate(blocks, axis=1)
    else:
        B = None   # the banded backend builds sparse windows from x_data
    P = sgp_basis.compute_Q_sgp_stacked(a, k, m, region, accuracy)
    return TermDesign(
        kind="sGP", smoothing_var=smoothing_var, X=X, B=B, P=P,
        sd_prior=sd_prior, boundary_prior=boundary_prior,
        initial_location=float(initial_location), observed_x=observed_x,
        a=float(a), m=int(m), k=int(k), region=region,
        accuracy=float(accuracy), boundary=bool(boundary), x_data=xs)


# above this level count, an IID term under the banded engine is kept
# LAZY (no dense (n, q) indicator, no dense (q, q) identity): the banded
# backend merges its diagonal-precision levels into the smooth's band
# (fast/banded.py merged-IID path) instead of the O(n q + d q^2 + q^3)
# dense tail. The reference handles this regime through CHOLMOD's
# general sparse Cholesky (R/02_model_fit.R:276-284, IID P=I at
# R/01_utility.R:245-250).
IID_LAZY_MIN_LEVELS = 512


def build_iid_term(smoothing_var: str, x: np.ndarray, *,
                   sd_prior=None, materialize_B: bool = True) -> TermDesign:
    """IID term: indicator design over factor levels, P = I
    (reference R/01_utility.R:214-219, 245-250).

    materialize_B=False + more than IID_LAZY_MIN_LEVELS levels: B and P
    stay None (identity precision implied; level codes in extra) for the
    banded engine's merged-IID path."""
    sd_prior = normalize_sd_prior(sd_prior)
    x = np.asarray(x)
    levels = np.unique(x)  # R factor(): sorted unique levels
    q = len(levels)
    codes = np.searchsorted(levels, x)
    if not materialize_B and q > IID_LAZY_MIN_LEVELS:
        return TermDesign(kind="IID", smoothing_var=smoothing_var,
                          X=np.zeros((len(x), 0)), B=None, P=None,
                          sd_prior=sd_prior, levels=levels,
                          extra={"codes": codes})
    B = (x[:, None] == levels[None, :]).astype(np.float64)
    P = np.eye(q)
    return TermDesign(kind="IID", smoothing_var=smoothing_var,
                      X=np.zeros((len(x), 0)), B=B, P=P,
                      sd_prior=sd_prior, levels=levels,
                      extra={"codes": codes})


def build_customized_term(smoothing_var: str, x: np.ndarray, *,
                          compute_B: Callable, compute_P: Callable,
                          sd_prior=None) -> TermDesign:
    """Customized term: user-supplied compute_B/compute_P closures
    (reference R/01_utility.R:220-223, 251-254)."""
    sd_prior = normalize_sd_prior(sd_prior)
    x = np.asarray(x)
    B = np.asarray(compute_B(x), dtype=np.float64)
    P = np.asarray(compute_P(x), dtype=np.float64)
    return TermDesign(kind="Customized", smoothing_var=smoothing_var,
                      X=np.zeros((len(x), 0)), B=B, P=P, sd_prior=sd_prior,
                      extra={"compute_B": compute_B, "compute_P": compute_P})


def build_term_from_call(call, data: dict, env: dict | None = None,
                         customized_re: dict | None = None,
                         materialize_B: bool = True) -> TermDesign:
    """Dispatch a parsed f(...) call to the right term constructor.

    `call` is a formula.RandomEffectCall; `data` maps column name -> array.
    """
    opts = dict(call.options)
    var = call.smoothing_var
    if var not in data:
        raise KeyError(f"smoothing variable '{var}' not found in data")
    x = np.asarray(data[var])
    model = opts.pop("model", None)
    if model is None:
        raise ValueError(f"f({var}, ...) needs model=")
    sd_prior = opts.pop("sd_prior", opts.pop("sd.prior", opts.pop("prior", None)))
    h = None
    if isinstance(sd_prior, dict):
        h = sd_prior.get("h", sd_prior.get("step"))
    if model == "IWP":
        td = build_iwp_term(
            var, x, order=opts.pop("order", None), k=opts.pop("k", None),
            knots=opts.pop("knots", None), sd_prior=sd_prior,
            boundary_prior=opts.pop("boundary_prior", opts.pop("boundary.prior", None)),
            initial_location=opts.pop("initial_location", None),
            materialize_B=materialize_B)
    elif model == "sGP":
        td = build_sgp_term(
            var, x, a=opts.pop("a", None), freq=opts.pop("freq", None),
            period=opts.pop("period", None), k=opts.pop("k", None),
            m=opts.pop("m", 1), sd_prior=sd_prior,
            boundary_prior=opts.pop("boundary_prior", opts.pop("boundary.prior", None)),
            initial_location=opts.pop("initial_location", None),
            region=opts.pop("region", None),
            accuracy=opts.pop("accuracy", 0.01),
            boundary=opts.pop("boundary", True),
            materialize_B=materialize_B)
    elif model == "IID":
        td = build_iid_term(var, x, sd_prior=sd_prior,
                            materialize_B=materialize_B)
    elif model == "Customized":
        cre = customized_re or {}
        td = build_customized_term(
            var, x, compute_B=opts.pop("compute_B", cre.get("compute_B")),
            compute_P=opts.pop("compute_P", cre.get("compute_P")),
            sd_prior=sd_prior)
    else:
        raise ValueError(f"unknown random-effect model '{model}'")
    if h is not None:
        td.sd_prior["h"] = h  # kept for var_density PSD reporting only
    return td
