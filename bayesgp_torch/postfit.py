"""Post-fit posterior analysis (reference layer L3, R/03_post_fit.R).

FitResult holds the posterior samples and their index maps; everything
here works off those cached host samples and never re-runs inference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np

from .basis import osplines, sgp as sgp_basis
from .basis.priors import compute_d_step_sgp_sd

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


def _sgp_global_X(xs, a, m):
    """[1 | cos/sin harmonics] global design of the sGP posterior function
    (fit coordinate system)."""
    return np.concatenate(
        [np.ones((len(xs), 1)),
         sgp_basis.global_poly_sgp(xs, a=a, m=m, initial_location=0.0)],
        axis=1)


def _sgp_design_parts(samps, global_samps, k, refined_x, a, region,
                      boundary: bool = True, m: int = 1,
                      intercept_samps=None):
    """(B, coefs, X, g) with f_draws = X g + B coefs for the sGP
    component."""
    M = samps.shape[1]
    B = sgp_basis.compute_B_sB_helper(refined_x, a=a, k=k, m=m,
                                      region=region, boundary=boundary,
                                      initial_location=0.0)
    X = _sgp_global_X(refined_x, a, m)
    if intercept_samps is None:
        intercept_samps = np.zeros((1, M))
    if global_samps is None:
        global_samps = np.zeros((2 * m, M))
    g = np.vstack([intercept_samps, global_samps])
    return B, samps, X, g


def compute_post_fun_sgp(samps, global_samps, k, refined_x, a, region,
                         boundary: bool = True, m: int = 1,
                         intercept_samps=None):
    """Posterior draws of the sGP component at refined_x (reference
    compute_post_fun_sGP, R/03_post_fit.R:261-276).

    Deliberate deviation, as in the JAX package: the reference re-centers
    both bases at min(refined_x), which agrees with the fit's coordinate
    system only when the prediction window starts at the training origin.
    Here both bases stay in the fit's coordinates (refined_x is already
    shifted by the term's initial_location), so predictions do not depend
    on the window and equal the reference's whenever min(refined_x) == 0
    (every reference vignette and test)."""
    B, coefs, X, g = _sgp_design_parts(samps, global_samps, k, refined_x,
                                       a, region, boundary, m,
                                       intercept_samps)
    return np.asarray(refined_x), X @ g + B @ coefs


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
    timing: Any = None           # utils.profiling.PhaseTimer of a fit run
    #                              with model_fit(timing=True)
    predictions: Any = None      # model_fit(predict_at=(var, xs)):
    #                              {var: predict-style dict}

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
        """Posterior of an IWP or sGP component at new locations
        (reference predict.FitResult, R/03_post_fit.R:53-125), on the
        host, from the draws in reference order (a multi-term fit's too).
        Output rows are in sorted-x order."""
        inst = self._instance_for(variable)
        if inst.kind not in ("IWP", "sGP"):
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
            if inst.kind == "sGP":
                return compute_post_fun_sgp(
                    coefsamps, global_samps, inst.k, xs, inst.a,
                    inst.region, boundary=inst.boundary, m=inst.m,
                    intercept_samps=intercept_samps)
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

    def sample_fixed_effect(self, variables):
        """(M, len(variables)) samples of named fixed effects (reference
        R/03_post_fit.R:159-165)."""
        if isinstance(variables, str):
            variables = [variables]
        idx = np.concatenate([self.fixed_samp_indexes[v]
                              for v in variables])
        return self.samps[idx, :].T

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
        """Moments and quantiles of each theta (aghq fits; None for an
        nlminb fit, which has no hyperparameter)."""
        from .inference.aghq import AGHQFit, summarize_marginals
        if not isinstance(self.mod, AGHQFit):
            return None
        rows = summarize_marginals(self.mod)
        names = [f"theta({t.smoothing_var})" for t in self.instances]
        if len(rows) > len(names):
            names.append("theta(family)")
        return dict(zip(names, rows))

    def summary(self):
        """Print a summary in the layout of the reference's
        summary.FitResult (R/03_post_fit.R:1-42): for an aghq fit the
        quadrature header, mode, log normalizing constant, the quadrature
        covariance as R prints a matrix and the theta table; then the
        fixed effects' sample moments."""
        from .inference.aghq import AGHQFit
        lines = []
        if isinstance(self.mod, AGHQFit):
            mode = np.atleast_1d(np.asarray(self.mod.mode, float))
            s = mode.shape[0]
            lines += [f"AGHQ on a {s} dimensional posterior with "
                      f" {self.mod.k} quadrature points", "",
                      "The posterior mode is: "
                      + " ".join(f"{v:.6g}" for v in mode) + " ", "",
                      "The log of the normalizing constant/marginal "
                      f"likelihood is: {self.mod.lognormconst:.7g} ", "",
                      "The covariance matrix used for the quadrature "
                      "is..."]
            L = np.atleast_2d(np.asarray(self.mod.L, float))
            cov = L @ L.T
            cells = [[f"{cov[i, j]:.8g}" for j in range(s)]
                     for i in range(s)]
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
                lines.append(f"{name:<12} {r['mean']:>10.6f} "
                             f"{r['sd']:>10.6f} {r['q2.5']:>10.6f} "
                             f"{r['median']:>10.6f} {r['q97.5']:>10.6f}")
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

    def plot(self, variable=None, ax=None):
        """Mean + 95% interval plot per GP component (reference
        plot.FitResult, R/03_post_fit.R:127-151). Imports matplotlib on
        call."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        vars_ = ([variable] if variable else
                 [t.smoothing_var for t in self.instances
                  if t.kind in ("IWP", "sGP")])
        axes = []
        for v in vars_:
            pred = self.predict(v)
            a = ax if ax is not None else plt.subplots()[1]
            a.plot(pred[v], pred["mean"], "k-", lw=2)
            a.plot(pred[v], pred["plower"], "k--", lw=1)
            a.plot(pred[v], pred["pupper"], "k--", lw=1)
            a.set_xlabel(v)
            a.set_ylabel("effect")
            axes.append(a)
        return axes

    def var_density(self, component=None, h=None, theta_logprior=None):
        """Posterior and prior density of an SD parameter (reference
        var_density, R/03_post_fit.R:309-443), from an aghq fit's theta
        marginal on the SD scale; component=None takes the Gaussian
        family's noise SD. With h (or the term's sd_prior h) also the
        h-step predictive SD columns."""
        from .inference.aghq import AGHQFit, compute_pdf_and_cdf
        if not isinstance(self.mod, AGHQFit):
            raise ValueError("var_density needs an aghq fit (MCMC is not "
                             "ported yet: ROADMAP Queue 1 item 10)")
        if theta_logprior is None:
            def theta_logprior(theta, prior_alpha, prior_u):
                lam = -np.log(prior_alpha) / prior_u
                return (np.log(lam / 2) - lam * np.exp(-theta / 2)
                        - theta / 2)

        def priorfuncsigma(x, prior_alpha, prior_u):
            # KDE grids can extend below 0; the prior density there is 0
            xp = np.where(x > 0, x, np.nan)
            with np.errstate(invalid="ignore", divide="ignore"):
                out = (2.0 / xp) * np.exp(
                    theta_logprior(-2 * np.log(xp), prior_alpha, prior_u))
            return np.where(x > 0, out, 0.0)

        transformation = {"totheta": lambda x: -2 * np.log(x),
                          "fromtheta": lambda x: np.exp(-x / 2)}
        if component is None:
            if self.family != "Gaussian":
                raise ValueError(
                    "no family SD in this model; pass component=")
            marg = self.mod.marginals[len(self.instances)]
            param = self.control_family["sd_prior"]["param"]
            inst = None
        else:
            i = [j for j, t in enumerate(self.instances)
                 if t.smoothing_var == component][0]
            inst = self.instances[i]
            marg = self.mod.marginals[i]
            param = inst.sd_prior["param"]
        if len(marg["theta"]) <= 2:
            raise ValueError("use aghq_k >= 3 for var_density")
        pc = compute_pdf_and_cdf(marg, transformation=transformation)
        out = {"SD": pc["transparam"], "post": pc["pdf_transparam"],
               "prior": priorfuncsigma(pc["transparam"], param["alpha"],
                                       param["u"])}
        if inst is not None:
            if h is None and inst.sd_prior.get("h") is not None:
                h = inst.sd_prior["h"]
            if h is not None:
                corr = _psd_correction(inst, h)
                out["PSD"] = out["SD"] * corr
                out["post.PSD"] = out["post"] / corr
                out["prior.PSD"] = out["prior"] / corr
        order = np.argsort(out["SD"])
        return {k: np.asarray(v)[order] for k, v in out.items()}

    def para_density(self):
        """Densities of every parameter (reference R/03_post_fit.R:
        450-467): a KDE of each fixed effect's draws, var_density of each
        term and of the Gaussian noise."""
        out = {}
        for name in self.fixed_samp_indexes:
            xs, ys = _kde(self.sample_fixed_effect(name)[:, 0])
            out[name] = {"effect": xs, "post": ys}
        for t in self.instances:
            out[t.smoothing_var] = self.var_density(
                component=t.smoothing_var)
        if self.family == "Gaussian":
            out["family_var"] = self.var_density()
        return out

    def post_table(self, quantiles=(0.025, 0.975), digits: int = 3):
        """Posterior summary table from numerically integrated CDFs
        (reference post_table, R/03_post_fit.R:474-531)."""
        dens = self.para_density()
        rows = []

        def cdf_quantiles(x, y):
            cdf = np.cumsum(y * np.concatenate([np.diff(x), [0.0]]))

            def q(p):
                below = np.where(cdf <= p)[0]
                return x[below.max()] if len(below) else x[0]
            return q

        def row(name, q, prior, p1, p2):
            r = {"name": name, "median": q(0.5)}
            for p in quantiles:
                r[f"q{p}"] = q(p)
            r.update({"prior": prior, "prior:P1": p1, "prior:P2": p2})
            return r

        for name in self.fixed_samp_indexes:
            d = dens[name]
            rows.append(row(name, cdf_quantiles(d["effect"], d["post"]),
                            "Normal", self.control_fixed[name]["mean"],
                            1.0 / self.control_fixed[name]["prec"]))
        for t in self.instances:
            d = dens[t.smoothing_var]
            if "PSD" in d:
                q = cdf_quantiles(d["PSD"], d["post.PSD"])
                nm = f"{t.smoothing_var} (PSD)"
            else:
                q = cdf_quantiles(d["SD"], d["post"])
                nm = f"{t.smoothing_var} (SD)"
            rows.append(row(nm, q, "Exponential", t.sd_prior["param"]["u"],
                            t.sd_prior["param"]["alpha"]))
        if "family_var" in dens:
            d = dens["family_var"]
            param = self.control_family["sd_prior"]["param"]
            rows.append(row("family_var", cdf_quantiles(d["SD"], d["post"]),
                            "Exponential", param["u"], param["alpha"]))
        for r in rows:
            for k, v in r.items():
                if isinstance(v, (float, np.floating)):
                    r[k] = round(float(v), digits)
        return rows


def _psd_correction(inst, h):
    """h-step predictive-SD correction (reference R/03_post_fit.R:
    353-365)."""
    if inst.kind == "IWP":
        p = inst.order
        return math.sqrt((h ** (2 * p - 1))
                         / ((2 * p - 1) * math.factorial(p - 1) ** 2))
    if inst.kind == "sGP":
        return sum(compute_d_step_sgp_sd(h, j * inst.a)
                   for j in range(1, inst.m + 1))
    raise ValueError("PSD only defined for IWP and sGP terms")


def _kde(samples, n: int = 512, cut: float = 3.0):
    """Gaussian KDE matching R's density() defaults (bw.nrd0, 512 points,
    range extended by 3 bandwidths)."""
    x = np.asarray(samples, np.float64)
    n_s = len(x)
    sd = np.std(x, ddof=1)
    iqr = np.subtract(*np.percentile(x, [75, 25]))
    # R's bw.nrd0 uses IQR/1.34 (not the asymptotic 1.349)
    sigma = min(sd, iqr / 1.34) if iqr > 0 else sd
    bw = 0.9 * sigma * n_s ** (-0.2)
    grid = np.linspace(x.min() - cut * bw, x.max() + cut * bw, n)
    diff = (grid[:, None] - x[None, :]) / bw
    dens = (np.exp(-0.5 * diff ** 2).sum(axis=1)
            / (n_s * bw * math.sqrt(2 * math.pi)))
    return grid, dens
