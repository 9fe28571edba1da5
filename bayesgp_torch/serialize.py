"""FitResult persistence.

The reference's checkpoint story is R's saveRDS of the fit list: the
samples, the term instances and the index maps are the whole state, and
all post-fit analysis works off the cached samples (R/03_post_fit.R:31,
58). Here a FitResult round-trips through one .npz archive with the JAX
package's fields: posterior samples, quadrature state, index maps, and
the term metadata needed to re-evaluate bases at predict time. Inference
never re-runs after a load.
"""
from __future__ import annotations

import json

import numpy as np

from . import terms as terms_mod
from .inference.aghq import AGHQFit
from .postfit import FitResult

_TERM_FIELDS = ["kind", "smoothing_var", "order", "initial_location",
                "a", "m", "k", "accuracy", "boundary"]


def _jsonable(x):
    """Recursively convert numpy scalars/arrays for json."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return x.item()
    return x


def _term_meta(t):
    meta = {f: _jsonable(getattr(t, f)) for f in _TERM_FIELDS}
    meta["sd_prior"] = _jsonable(t.sd_prior)
    meta["boundary_prior"] = _jsonable(t.boundary_prior)
    return meta


def save_fit(fit: FitResult, path: str) -> None:
    if any(t.kind == "Customized" for t in fit.instances):
        raise ValueError(
            "Customized terms hold user callables and cannot be serialized")
    arrays = {
        "samps": fit.samps,
        "theta_samps": fit.theta_samps,
    }
    meta = {
        "family": fit.family, "method": fit.method, "M": int(fit.M),
        "fixed_names": list(fit.fixed_names),
        "control_family": _jsonable(fit.control_family),
        "control_fixed": _jsonable(fit.control_fixed),
        "terms": [_term_meta(t) for t in fit.instances],
        "index_names": {
            "random": list(fit.random_samp_indexes),
            "boundary": list(fit.boundary_samp_indexes),
            "fixed": list(fit.fixed_samp_indexes),
        },
    }
    for i, t in enumerate(fit.instances):
        if t.knots is not None:
            arrays[f"term{i}_knots"] = np.asarray(t.knots)
        if t.observed_x is not None:
            arrays[f"term{i}_observed_x"] = np.asarray(t.observed_x)
        if t.region is not None:
            arrays[f"term{i}_region"] = np.asarray(t.region)
        if t.levels is not None:
            arrays[f"term{i}_levels"] = np.asarray(t.levels)
        arrays[f"term{i}_P"] = np.asarray(t.P)
        arrays[f"term{i}_X0"] = np.zeros((0, t.X.shape[1]))
    for name, idx in fit.random_samp_indexes.items():
        arrays[f"ridx_{name}"] = np.asarray(idx)
    for name, idx in fit.boundary_samp_indexes.items():
        arrays[f"bidx_{name}"] = np.asarray(idx)
    for name, idx in fit.fixed_samp_indexes.items():
        arrays[f"fidx_{name}"] = np.asarray(idx)
    if isinstance(fit.mod, AGHQFit):
        arrays.update(
            aghq_mode=fit.mod.mode, aghq_hessian=fit.mod.hessian,
            aghq_L=fit.mod.L, aghq_nodes=fit.mod.nodes,
            aghq_logw=fit.mod.logw, aghq_lognll=fit.mod.lognll,
            aghq_lognormconst=np.asarray(fit.mod.lognormconst),
            aghq_k=np.asarray(fit.mod.k))
        for j, marg in enumerate(fit.mod.marginals):
            arrays[f"marg{j}_theta"] = marg["theta"]
            arrays[f"marg{j}_logmargpost"] = marg["logmargpost"]
        meta["n_marginals"] = len(fit.mod.marginals)
        meta["mod_kind"] = "aghq"
    else:
        meta["mod_kind"] = fit.method
    np.savez_compressed(path, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_fit(path: str) -> FitResult:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}

    instances = []
    for i, tmeta in enumerate(meta["terms"]):
        t = terms_mod.TermDesign(
            kind=tmeta["kind"], smoothing_var=tmeta["smoothing_var"],
            X=arrays.get(f"term{i}_X0", np.zeros((0, 0))),
            B=None, P=arrays[f"term{i}_P"],
            sd_prior=tmeta["sd_prior"],
            boundary_prior=tmeta["boundary_prior"],
            order=int(tmeta["order"] or 0),
            knots=arrays.get(f"term{i}_knots"),
            initial_location=float(tmeta["initial_location"]),
            observed_x=arrays.get(f"term{i}_observed_x"),
            a=float(tmeta["a"] or 0.0), m=int(tmeta["m"] or 1),
            k=int(tmeta["k"] or 0),
            region=arrays.get(f"term{i}_region"),
            accuracy=float(tmeta["accuracy"] or 0.01),
            boundary=bool(tmeta["boundary"]),
            levels=arrays.get(f"term{i}_levels"))
        instances.append(t)

    mod = None
    if meta.get("mod_kind") == "aghq":
        mod = AGHQFit(
            mode=arrays["aghq_mode"], hessian=arrays["aghq_hessian"],
            L=arrays["aghq_L"], nodes=arrays["aghq_nodes"],
            logw=arrays["aghq_logw"], lognll=arrays["aghq_lognll"],
            lognormconst=float(arrays["aghq_lognormconst"]),
            states=None, k=int(arrays["aghq_k"]))
        mod.marginals = [
            {"theta": arrays[f"marg{j}_theta"],
             "logmargpost": arrays[f"marg{j}_logmargpost"]}
            for j in range(meta.get("n_marginals", 0))]

    def _idx(prefix, names):
        return {name: arrays[f"{prefix}_{name}"] for name in names}

    return FitResult(
        instances=instances, mod=mod, md=None, method=meta["method"],
        family=meta["family"], samps=arrays["samps"],
        theta_samps=arrays["theta_samps"],
        random_samp_indexes=_idx("ridx", meta["index_names"]["random"]),
        boundary_samp_indexes=_idx("bidx", meta["index_names"]["boundary"]),
        fixed_samp_indexes=_idx("fidx", meta["index_names"]["fixed"]),
        control_family=meta["control_family"],
        control_fixed=meta["control_fixed"],
        fixed_names=meta["fixed_names"], M=int(meta["M"]))
