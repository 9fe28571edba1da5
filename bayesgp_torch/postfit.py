"""Post-fit posterior analysis (reference layer L3, R/03_post_fit.R).

FitResult holds the posterior samples and their index maps; everything
here works off those cached host samples and never re-runs inference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np

from .basis import osplines

# predict summarizes in row blocks past this many (n_pred x M) draw
# elements (~400 MB f64) instead of materializing the full matrix
_PREDICT_CHUNK_ELEMS = 50_000_000


def extract_mean_interval_given_samps(x, samples, level: float = 0.95):
    """Row-wise mean + pointwise quantile envelope (reference
    R/03_post_fit.R:287-296; R type-7 quantiles = numpy default)."""
    alpha = 1.0 - level
    return {
        "x": np.asarray(x),
        "plower": np.quantile(samples, alpha / 2, axis=1),
        "pupper": np.quantile(samples, level + alpha / 2, axis=1),
        "mean": np.mean(samples, axis=1),
    }


def _iwp_global_X(xs, p, degree):
    """Global-polynomial design of the IWP posterior function at
    derivative `degree`: the first p-degree monomials, factorial-rescaled
    (reference R/03_post_fit.R:229-234)."""
    X = osplines.global_poly_helper(xs, p=p)[:, :p - degree]
    return X * np.array([
        math.factorial(i + degree) / math.factorial(i)
        for i in range(p - degree)])[None, :]


def compute_post_fun_iwp(samps, global_samps, knots, refined_x, p,
                         degree: int = 0, intercept_samps=None):
    """Posterior draws of the IWP component (or its derivative) at
    refined_x (reference compute_post_fun_IWP, R/03_post_fit.R:200-241):
    X_global g + B coefs with basis order p - degree."""
    if p <= degree:
        raise ValueError("derivative degree must be < IWP order")
    M = samps.shape[1]
    if global_samps is None:
        global_samps = np.zeros((p - 1, M))
    if global_samps.shape[0] != p - 1:
        raise ValueError("global_samps has wrong number of rows for order p")
    if intercept_samps is None:
        intercept_samps = np.zeros((1, M))
    g = np.vstack([intercept_samps, global_samps])      # (p, M)
    B = osplines.local_poly_helper(knots, refined_x, p=p - degree)
    f = B @ samps + _iwp_global_X(refined_x, p, degree) @ g[degree:p]
    return np.asarray(refined_x), f


@dataclass
class FitResult:
    instances: list
    mod: Any
    md: Any
    method: str
    family: str
    samps: np.ndarray            # (w, M)
    theta_samps: np.ndarray      # (M, s)
    random_samp_indexes: dict
    boundary_samp_indexes: dict
    fixed_samp_indexes: dict
    control_family: dict
    control_fixed: dict
    fixed_names: list
    M: int

    def _instance_for(self, variable):
        hits = [t for t in self.instances if t.smoothing_var == variable]
        if len(hits) >= 2:
            raise ValueError(
                "more than one random effect shares this variable name; "
                "refit with distinct names")
        if not hits:
            raise ValueError(f"variable '{variable}' not in the fitted model")
        return hits[0]

    def predict(self, variable: str, newdata=None, degree: int = 0,
                include_intercept: bool = True, only_samples: bool = False,
                level: float = 0.95):
        """Posterior of an IWP component at new locations (reference
        predict.FitResult, R/03_post_fit.R:53-125), on the host, from the
        draws in reference order (a multi-term fit's too). Output rows
        are in sorted-x order."""
        inst = self._instance_for(variable)
        if inst.kind == "sGP":
            raise NotImplementedError(
                "predict for sGP terms is not ported yet (ROADMAP Queue 1 "
                "item 6)")
        if inst.kind != "IWP":
            raise ValueError(f"predict not defined for {inst.kind} terms")
        gl_idx = self.boundary_samp_indexes.get(variable, np.array([], int))
        global_samps = self.samps[gl_idx, :] if len(gl_idx) else None
        coefsamps = self.samps[self.random_samp_indexes[variable], :]
        if include_intercept and "intercept" in self.fixed_samp_indexes:
            intercept_samps = self.samps[
                self.fixed_samp_indexes["intercept"], :]
        else:
            intercept_samps = None
        if newdata is None:
            refined_x = inst.observed_x
        else:
            col = (newdata[variable] if not hasattr(newdata, "columns")
                   else newdata[variable].values)
            refined_x = np.sort(np.asarray(col, np.float64)
                                - inst.initial_location)

        def post_fun(xs):
            return compute_post_fun_iwp(
                coefsamps, global_samps, inst.knots, xs, inst.order,
                degree=degree, intercept_samps=intercept_samps)

        if only_samples:
            x, f = post_fun(refined_x)
            return x + inst.initial_location, f
        # summarize in row blocks so the (n_pred, M) draws never exceed
        # _PREDICT_CHUNK_ELEMS elements at once
        rows = max(1, _PREDICT_CHUNK_ELEMS // coefsamps.shape[1])
        parts = []
        for i0 in range(0, len(refined_x), rows):
            x_b, f_b = post_fun(refined_x[i0:i0 + rows])
            parts.append(extract_mean_interval_given_samps(
                x_b + inst.initial_location, f_b, level=level))
        out = {key: np.concatenate([p[key] for p in parts])
               for key in parts[0]}
        out[variable] = out.pop("x")
        return out

    def fixed_effects_summary(self):
        """R summary()-style table for the fixed effects (reference
        summary.FitResult, R/03_post_fit.R:30-41)."""
        rows = {}
        for name, idx in self.fixed_samp_indexes.items():
            s = self.samps[idx[0], :]
            rows[name] = {
                "1st Qu.": float(np.quantile(s, 0.25)),
                "Median": float(np.quantile(s, 0.5)),
                "Mean": float(np.mean(s)),
                "3rd Qu.": float(np.quantile(s, 0.75)),
                "sd": float(np.std(s, ddof=1)),
            }
        return rows

    def theta_summary(self):
        """Moments and quantiles of each theta."""
        from .inference.aghq import summarize_marginals
        rows = summarize_marginals(self.mod)
        names = [f"theta({t.smoothing_var})" for t in self.instances]
        if len(rows) > len(names):
            names.append("theta(family)")
        return dict(zip(names, rows))

    def summary(self):
        """Print a summary in the layout of the reference's
        summary.FitResult (R/03_post_fit.R:1-42)."""
        mode = np.atleast_1d(np.asarray(self.mod.mode, float))
        s = mode.shape[0]
        lines = [f"AGHQ on a {s} dimensional posterior with "
                 f" {self.mod.k} quadrature points", "",
                 "The posterior mode is: "
                 + " ".join(f"{v:.6g}" for v in mode) + " ", "",
                 "The log of the normalizing constant/marginal "
                 f"likelihood is: {self.mod.lognormconst:.7g} ", "",
                 "The covariance matrix used for the quadrature is..."]
        L = np.atleast_2d(np.asarray(self.mod.L, float))
        cov = L @ L.T
        cells = [[f"{cov[i, j]:.8g}" for j in range(s)] for i in range(s)]
        widths = [max(len(f"[,{j + 1}]"),
                      max(len(cells[i][j]) for i in range(s)))
                  for j in range(s)]
        rlab = [f"[{i + 1},]" for i in range(s)]
        rw = max(len(r) for r in rlab)
        lines.append(" " * rw + " " + " ".join(
            f"[,{j + 1}]".rjust(widths[j]) for j in range(s)))
        for i in range(s):
            lines.append(rlab[i].ljust(rw) + " " + " ".join(
                cells[i][j].rjust(widths[j]) for j in range(s)))
        lines += ["", "Here are some moments and quantiles for the "
                  "log precision: ",
                  f"{'':>12} {'mean':>10} {'sd':>10} {'2.5%':>10} "
                  f"{'median':>10} {'97.5%':>10}"]
        for name, r in self.theta_summary().items():
            lines.append(f"{name:<12} {r['mean']:>10.6f} {r['sd']:>10.6f} "
                         f"{r['q2.5']:>10.6f} {r['median']:>10.6f} "
                         f"{r['q97.5']:>10.6f}")
        fx = self.fixed_effects_summary()
        if fx:
            lines.append("\nHere are some moments and quantiles for the "
                         "fixed effects: \n")
            lines.append(f"{'':>12} {'1st Qu.':>12} {'Median':>12} "
                         f"{'Mean':>12} {'3rd Qu.':>12} {'sd':>12}")
            for name, r in fx.items():
                lines.append(f"{name:<12} {r['1st Qu.']:>12.8f} "
                             f"{r['Median']:>12.8f} {r['Mean']:>12.8f} "
                             f"{r['3rd Qu.']:>12.8f} {r['sd']:>12.8f}")
        text = "\n".join(lines)
        print(text)
        return text
