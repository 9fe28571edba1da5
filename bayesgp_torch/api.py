"""`model_fit`, the main entry point (reference: R/02_model_fit.R:309-701).

Accepts a formula string (the reference's `f()` vocabulary) or pre-built
terms, assembles the model, runs the AGHQ fit on the dense backend (small
models), the banded single-IWP backend, the multi-term banded backend or
the scattered-IID backend, or the nlminb MAP with Gaussian draws, draws M
posterior samples and returns a FitResult with the reference's
sample-index partitions. Routes not ported yet raise NotImplementedError
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from . import formula as formula_mod
from . import terms as terms_mod
from .device import resolve_device
from .model import build as build_mod
from .model.objective import to_device
from .inference import aghq as aghq_mod
from .inference import laplace as laplace_mod
from .inference import sampling as sampling_mod
from .postfit import FitResult
from .utils.profiling import PhaseTimer


def _as_dict_of_arrays(data):
    """Accept dict-of-arrays or pandas DataFrame."""
    if hasattr(data, "columns"):  # pandas
        return {c: np.asarray(data[c]) for c in data.columns}
    return {k: np.asarray(v) for k, v in data.items()}


def _normalize_control_fixed(control_fixed, fixed_names):
    """Per-coefficient N(mean, 1/prec) priors with 0.01/0 defaults
    (reference R/02_model_fit.R:586-616)."""
    cf = dict(control_fixed) if control_fixed else {}
    out = {}
    for name in fixed_names:
        ent = dict(cf.get(name, {}))
        ent.setdefault("prec", 0.01)
        ent.setdefault("mean", 0.0)
        out[name] = ent
    return out


def _normalize_control_family(control_family):
    """Gaussian-noise sd prior defaults (reference R/02_model_fit.R:75-122)."""
    if control_family is None:
        return {"sd_prior": {"prior": "exp",
                             "param": {"u": 1.0, "alpha": 0.5}}}
    cf = dict(control_family)
    sdp = cf.get("sd_prior", cf.get("sd.prior"))
    cf["sd_prior"] = terms_mod.normalize_sd_prior(sdp)
    return cf


def assemble_model(formula=None, data=None, method: str = "aghq",
                   family: str = "Gaussian", control_family=None,
                   control_fixed=None, size=None, cens=None,
                   weight=None, strata=None, env=None,
                   customized_re=None, terms=None, fixed=None,
                   response=None, engine: str = "auto") -> dict:
    """Model assembly only (formula parsing, term construction, priors,
    ModelData): the pre-inference part of `model_fit`. Returns a dict
    with instances, md, design/prior arrays and the banded-path
    decision."""
    data = _as_dict_of_arrays(data)
    if formula is not None:
        parsed = formula_mod.parse_formula(formula, env)
        response = parsed.response
        fixed = parsed.fixed_effects
        re_calls = parsed.rand_effects
    else:
        if response is None:
            raise ValueError("need formula= or response=")
        fixed = list(fixed or [])
        re_calls = list(terms or [])

    family_is_coxph = family in ("Coxph", "coxph")
    family_is_cc = family in ("casecrossover", "cc", "CaseCrossover")
    if family == "Customized":
        raise NotImplementedError(
            "customized families are not ported yet (ROADMAP Queue 1 "
            "item 3)")

    # banded candidacy (decided before the build to skip the dense B)
    fam_elementwise = family in ("Gaussian", "Poisson", "Binomial")

    def _call_model(c):
        if isinstance(c, terms_mod.TermDesign):
            return c.kind
        return c.options.get("model")
    has_banded_smooth = any(_call_model(c) in ("IWP", "sGP")
                            for c in re_calls)
    candidate_banded = (engine in ("auto", "banded", "scatter_iid")
                        and method in ("aghq", "MCMC")
                        and fam_elementwise and has_banded_smooth)
    if engine == "banded" and not candidate_banded:
        raise ValueError(
            "engine='banded' requires method='aghq' or 'MCMC', an "
            "elementwise family (Gaussian/Poisson/Binomial) and at "
            "least one IWP or sGP term")

    if family_is_coxph:
        # reference sorts the data by the response (R/02_model_fit.R:346-350)
        order = np.argsort(data[response], kind="stable")
        data = {k: v[order] for k, v in data.items()}

    instances = []
    for call in re_calls:
        if isinstance(call, terms_mod.TermDesign):
            instances.append(call)
        else:
            mat = not (candidate_banded
                       and _call_model(call) in ("IWP", "sGP", "IID"))
            instances.append(terms_mod.build_term_from_call(
                call, data, env=env, customized_re=customized_re,
                materialize_B=mat))

    def _band_smooth_ok(t):
        if t.kind == "sGP":
            return t.k >= 6
        if t.kind == "IWP":
            return np.asarray(t.knots).min() >= 0
        return False
    smooths = [t for t in instances if t.kind in ("IWP", "sGP")
               and _band_smooth_ok(t)]
    if candidate_banded and not smooths:
        if engine == "banded":
            raise ValueError(
                "engine='banded' needs an eligible smooth term (sGP with "
                "k>=6 or IWP with nonnegative knots)")
        candidate_banded = False
    has_lazy_iid = any(t.kind == "IID" and t.B is None for t in instances)
    if engine == "auto":
        # dense is exact and cheap for small problems; banded wins at scale
        nb = max((t.num_basis for t in smooths), default=0)
        use_banded = candidate_banded and (
            len(data[response]) * nb > 2_000_000 or nb > 300
            or has_lazy_iid)
    else:
        use_banded = candidate_banded and engine in ("banded",
                                                     "scatter_iid")
    if has_lazy_iid and not use_banded:
        for t in instances:
            if t.kind == "IID" and t.B is None:
                t.ensure_B()

    n = len(data[response])
    design_mat_fixed = []
    fixed_names = []
    if not (family_is_coxph or family_is_cc):
        design_mat_fixed.append(np.ones((n, 1)))
        fixed_names.append("intercept")
    for fe in fixed:
        design_mat_fixed.append(
            np.asarray(data[fe], np.float64).reshape(n, 1))
        fixed_names.append(fe)

    control_fixed_n = _normalize_control_fixed(control_fixed, fixed_names)
    control_family_n = _normalize_control_family(control_family)
    bf_prec = np.array([control_fixed_n[nm]["prec"] for nm in fixed_names])
    bf_mean = np.array([control_fixed_n[nm]["mean"] for nm in fixed_names])

    cc_arrays = None
    if family_is_cc:
        if strata is None or strata not in data:
            raise ValueError(
                "case-crossover needs strata= naming a data column")
        w_arr = (data[weight] if (weight is not None and weight in data)
                 else None)
        cc_arrays = build_mod.build_cc_strata(
            np.asarray(data[response]), np.asarray(data[strata]), w_arr)

    md = build_mod.build_model_data(
        instances, design_mat_fixed, np.asarray(data[response], np.float64),
        family, control_family=control_family_n,
        control_fixed_prec=bf_prec, control_fixed_mean=bf_mean,
        size=(data[size] if size else None),
        cens=(data[cens] if (cens and cens in data) else None),
        cc_arrays=cc_arrays, dense_design=not use_banded)

    theta_count = md.n_theta
    if theta_count == 0 and method != "nlminb":
        raise ValueError("For model with no hyper-parameter, the method "
                         "cannot be aghq or MCMC.")
    if method == "nlminb" and theta_count != 0:
        raise ValueError("For model with hyper-parameter, the method "
                         "should be aghq or MCMC.")
    return dict(instances=instances, md=md, use_banded=use_banded,
                design_mat_fixed=design_mat_fixed, fixed_names=fixed_names,
                bf_prec=bf_prec, bf_mean=bf_mean,
                control_family=control_family_n,
                control_fixed=control_fixed_n, family=family)


def _unported(route, item):
    return NotImplementedError(
        f"this model resolves to {route}, which is not ported to "
        f"bayesgp_torch yet (ROADMAP Queue 1 item {item})")


def _backend(asm, engine, device):
    """The backend of an assembled model, as the JAX package picks it: the
    dense backend where the model is not on the banded route; there the
    banded single-IWP backend for one IWP smooth; with engine=
    'scatter_iid' the diagonal-first IID backend; else the multi-term
    banded backend, and the scatter_iid backend where that refuses the
    model (a large IID term whose levels scatter over x). Raise for the
    routes not ported yet."""
    from .fast.iwp import build_fast_iwp
    from .fast.banded import build_banded_backend
    from .fast.scatter_iid import build_scatter_iid
    instances, md = asm["instances"], asm["md"]
    if not asm["use_banded"]:
        return aghq_mod.DenseBackend(md, device=device)
    args = (instances, md, asm["design_mat_fixed"], asm["bf_prec"],
            asm["bf_mean"])
    if engine == "scatter_iid":
        return build_scatter_iid(*args, device=device)
    if len(instances) == 1 and instances[0].kind == "IWP":
        if md.n_theta != 1:
            raise _unported("the Gaussian family's noise hyperparameter on "
                            "the banded backend", 6)
        inst = instances[0]
        xf_dense = np.concatenate(
            [inst.X] + [np.asarray(c) for c in asm["design_mat_fixed"]],
            axis=1)
        p = inst.order
        prior_diag_tail = np.concatenate([
            np.full(p - 1, inst.boundary_prior["prec"]), asm["bf_prec"]])
        prior_mean_tail = np.concatenate([
            np.full(p - 1, inst.boundary_prior["mean"]), asm["bf_mean"]])
        return build_fast_iwp(inst, md, xf_dense, prior_diag_tail,
                              prior_mean_tail, inst.x_data, device=device)
    try:
        return build_banded_backend(*args, device=device)
    except ValueError as e:
        # a large IID term the merge refuses: its levels scatter over x
        try:
            return build_scatter_iid(*args, device=device)
        except ValueError:
            raise e from None


def _warn_sick_gate(backend, mod):
    """Warn when the band engine's sick-factor gate drops the log-det's
    theta gradient at the returned mode (a band pivot clamped, the tail
    factor left its plain route, or H^{-1} is not finite there): the
    optimizer then stopped on the value's explicit gradient alone, and
    the mode and lognormconst can be off."""
    gate_reasons = getattr(backend, "gate_reasons", None)
    if gate_reasons is None or mod.mode_state is None:
        return
    why = [what for what, hit in zip(
        ("a band pivot was clamped", "the tail factor left its plain route",
         "H^-1 is not finite"), gate_reasons(mod.mode, mod.mode_state))
        if hit]
    if why:
        warnings.warn(
            "the sick-factor gate dropped the log-det's theta gradient at "
            f"the mode ({'; '.join(why)}): the mode and lognormconst may "
            "be off", RuntimeWarning, stacklevel=3)


def model_fit(formula=None, data=None, method: str = "aghq",
              family: str = "Gaussian", control_family=None,
              control_fixed=None, aghq_k: int = 4, size=None, cens=None,
              weight=None, strata=None, M: int = 3000, env=None,
              customized_re=None, seed: int = 0, terms=None, fixed=None,
              response=None, engine: str = "auto", theta0=None,
              timing: bool = False, predict_at=None,
              device="cuda") -> FitResult:
    """Fit a Bayesian hierarchical GP model.

    Either pass `formula` (string) + `data`, or `response=`/`fixed=`/
    `terms=` explicitly. Ported routes, for the elementwise families
    (Gaussian, Poisson, Binomial):
    - method='aghq' on the dense backend: every model off the banded
      route, which engine='auto' picks for small models (n * basis size
      <= 2e6, at most 300 basis functions, no lazy IID term) and
      engine='dense' always;
    - method='aghq', with no noise hyperparameter (Poisson, Binomial), on
      the banded routes at scale or with engine='banded': one IWP smooth
      with fixed effects (the banded single-IWP engine); an IWP smooth
      with other terms (the multi-term banded engine: a large IID term
      clustered in x merged into the band, other terms in a dense tail);
      and, where the merge refuses an IID term of more than 4,000 levels,
      or with engine='scatter_iid', one IWP smooth plus one IID term (the
      scattered-IID engine);
    - method='nlminb' for a model with no hyperparameter: the posterior
      mode of W and M draws from the Gaussian at its Hessian.

    device: where the fit runs, "cuda" by default; a missing card
    raises rather than falling back. The posterior draws come from a
    torch.Generator on that device seeded with `seed`.

    timing=True attaches a per-phase wall-clock breakdown (build /
    backend construction / inference and draws) as `fit.timing`
    (utils.profiling.PhaseTimer; print `fit.timing.summary()`).

    predict_at=(var, xs): predict summaries for the named GP component at
    locations xs, computed after the fit (the regular predict) and
    attached as fit.predictions[var].
    """
    dev = resolve_device(device)
    if method not in ("aghq", "nlminb"):
        if method == "MCMC":
            raise _unported("method='MCMC'", 10)
        raise ValueError(f"unknown method '{method}'")
    timer = None
    if timing:
        timer = PhaseTimer(sync=(torch.cuda.synchronize
                                 if dev.type == "cuda" else None))
    tphase = (timer.phase if timer is not None
              else (lambda name: contextlib.nullcontext()))
    with tphase("build (bases, priors, model data)"):
        asm = assemble_model(
            formula=formula, data=data, method=method, family=family,
            control_family=control_family, control_fixed=control_fixed,
            size=size, cens=cens, weight=weight, strata=strata, env=env,
            customized_re=customized_re, terms=terms, fixed=fixed,
            response=response, engine=engine)
    instances, md = asm["instances"], asm["md"]
    fixed_names = asm["fixed_names"]

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    if method == "aghq":
        with tphase("backend construction"):
            backend = _backend(asm, engine, dev)
        with tphase("inference (AGHQ fit + posterior draws)"):
            mod = aghq_mod.aghq_fit(backend, k=aghq_k, theta0=theta0)
            _warn_sick_gate(backend, mod)
            samps, _, theta_samps = sampling_mod.sample_marginal(mod, M, gen)
    else:
        with tphase("inference (MAP + Gaussian draws)"):
            dmd = to_device(md, dev)
            Ws, H, _ = laplace_mod.laplace_mode_hess(
                torch.zeros(0, dtype=torch.float64, device=dev), dmd)
            mod = {"mean": Ws.cpu().numpy(), "prec": H.cpu().numpy()}
            samps = sampling_mod.sample_mvn_precision(gen, Ws, H, M)
            theta_samps = np.zeros((M, 0))

    # sample-index partitions (reference R/02_model_fit.R:627-675)
    sum_col_ins = sum(md.d_sizes)
    random_samp_indexes = {}
    boundary_samp_indexes = {}
    off_coef, off_bdry = 0, sum_col_ins
    for t in instances:
        dcols = t.num_basis
        random_samp_indexes[t.smoothing_var] = np.arange(off_coef,
                                                         off_coef + dcols)
        off_coef += dcols
        xcols = t.X.shape[1]
        if t.kind in ("IWP", "sGP"):
            boundary_samp_indexes[t.smoothing_var] = np.arange(
                off_bdry, off_bdry + xcols)
            off_bdry += xcols
    fixed_samp_indexes = {nm: np.array([md.fixed_offset() + i])
                          for i, nm in enumerate(fixed_names)}
    fit = FitResult(
        instances=instances, mod=mod, md=md, method=method, family=family,
        samps=samps, theta_samps=theta_samps,
        random_samp_indexes=random_samp_indexes,
        boundary_samp_indexes=boundary_samp_indexes,
        fixed_samp_indexes=fixed_samp_indexes,
        control_family=asm["control_family"],
        control_fixed=asm["control_fixed"],
        fixed_names=fixed_names, M=M, timing=timer)
    if predict_at is not None:
        pvar, pxs = predict_at
        fit.predictions = {pvar: fit.predict(pvar, newdata={pvar: pxs})}
    return fit
