"""bayesgp_torch's partial-likelihood and user-defined families (CoxPH,
case-crossover, prior only, Customized) on the dense route, on the CPU in
f64, against the JAX package.

1. The family functions (model/families.py) against the JAX package's on
   the models of tests/test_objective.py (CoxPH with a tie and censoring,
   case-crossover, prior only) and a customized negative binomial
   registered in both packages: log_lik, the eta-gradient (against
   jax.grad) and eta_hessian_quadform at rtol 1e-10, the quadform against
   the port's eta_hessian_full, the C++-loop transcriptions of
   tests/test_objective.py, and a (30, n) batch of etas against its rows
   one by one, bit for bit.
2. laplace_nll and its autograd theta gradient at three thetas against
   the JAX package's laplace_nll and jax.grad (value rtol 1e-9, gradient
   rtol 1e-7) on a CoxPH model with an IID frailty, a case-crossover
   model and the customized negative binomial with its extra theta,
   each built by the JAX package and carried across by convert.
3. The entry points on the CPU: the case-crossover vignette's recovery
   checks (tests/test_partial_likelihood.py), CoxPH row-order invariance
   and nlminb with no f() term, a customized Poisson loglik against the
   built-in Poisson fit (mode and lognormconst to 1e-6), a family
   registered by name with two extra thetas and its theta_summary names,
   a Customized random effect, and the missing customized_template.

Three tests (the tier-1 run's file scheduler; ROADMAP constraints). Each
JAX reference of test 2 is compiled once per model with XLA's CPU
optimizations off (_jax_quick.quick_jit); no JAX fit runs here.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.scipy.special import gammaln

import bayesgp_tpu as jbg
from bayesgp_tpu import api as japi
from bayesgp_tpu import terms as jterms
from bayesgp_tpu.inference import laplace as jlap
from bayesgp_tpu.model import build as jbuild
from bayesgp_tpu.model import families as jfam
import bayesgp_torch as tbg
from bayesgp_torch import convert
from bayesgp_torch.inference import aghq as taghq
from bayesgp_torch.inference import laplace as tlap
from bayesgp_torch.model import families as tfam
from bayesgp_torch.model import objective as tobj

from _jax_quick import quick_jit
from test_objective import (cc_loglik_reference, coxph_loglik_reference,
                            make_cc_model)
from test_partial_likelihood import make_survival_data

torch.set_num_threads(1)

NB = "nb_torch_partial_likelihood"


def _nb_jax(eta, y, theta):
    """Negative binomial, mean e^eta, size r = e^theta_last."""
    lr = theta[-1]
    r = jnp.exp(lr)
    return jnp.sum(gammaln(y + r) - gammaln(r) - gammaln(y + 1.0) + r * lr
                   + y * eta - (r + y) * jnp.logaddexp(lr, eta))


def _nb_torch(eta, y, theta):
    lr = theta[-1]
    r = torch.exp(lr)
    return torch.sum(torch.lgamma(y + r) - torch.lgamma(r)
                     - torch.lgamma(y + 1.0) + r * lr + y * eta
                     - (r + y) * torch.logaddexp(lr.expand(eta.shape), eta))


jbg.register_family(NB, _nb_jax, n_theta_extra=1)
tbg.register_family(NB, _nb_torch, n_theta_extra=1)


def _poisson_torch(eta, y, theta):
    return torch.sum(y * eta - torch.exp(eta) - torch.lgamma(y + 1.0))


def _nb_data(n=100, seed=2):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 5, n))
    mu = np.exp(0.5 * np.sin(x) + 1.0)
    return {"y": rng.negative_binomial(3.0, 3.0 / (3.0 + mu)).astype(float),
            "x": x}


def _family_cases():
    """(name, JAX ModelData, theta, eta, C++-loop log likelihood or None)
    of test 1, from the generators of tests/test_objective.py."""
    rng = np.random.default_rng(4)
    n = 30
    y = np.sort(rng.exponential(1, n))
    y[5] = y[4]                                 # a tie
    cens = rng.binomial(1, 0.7, n).astype(float)
    x = np.sort(rng.uniform(0, 5, n))
    inst = jterms.build_iwp_term("x", x, order=2, k=4)
    cox = jbuild.build_model_data([inst], [np.ones((n, 1))], y, "Coxph",
                                  cens=cens)
    eta = rng.normal(0, 0.5, n)
    cases = [("coxph", cox, np.zeros(1), eta,
              coxph_loglik_reference(eta, y, cens))]
    cc, rng = make_cc_model()
    eta = rng.normal(0, 0.5, cc.n)
    cases.append(("cc", cc, np.zeros(1), eta, cc_loglik_reference(
        eta, np.asarray(cc.case_day), np.asarray(cc.control_days),
        np.asarray(cc.count))))
    none = jbuild.build_model_data([inst], [np.ones((n, 1))], np.zeros(n),
                                   "none")
    cases.append(("none", none, np.zeros(1), rng.normal(size=n), 0.0))
    data = _nb_data(n=40, seed=3)
    nb = japi.assemble_model("y ~ f(x, model='IWP', order=2, k=5)",
                             data=data, family="Customized",
                             customized_template=NB)["md"]
    cases.append(("custom", nb, np.array([0.2, 0.7]),
                  rng.normal(0.8, 0.5, nb.n), None))
    return cases


def _jax_family_refs(name, md):
    """(log_lik, d(-ll)/d eta, and for the structured families A^T M A)
    of the JAX package at (eta, theta), one program a case; md closed
    over, so its CoxPH takes the rank-regrouped form the port computes."""
    def refs(eta, theta):
        out = [jfam.log_lik(eta, md, theta),
               -jax.grad(lambda e: jfam.log_lik(e, md, theta))(eta)]
        if jfam.eta_hessian_kind(md.family) == "full":
            out.append(jfam.eta_hessian_quadform(eta, md, theta, md.A))
        return out
    return quick_jit(refs)


def test_families_match_jax():
    for name, jmd, theta, eta, loops in _family_cases():
        tmd = convert.model_data_from_arrays(
            convert.model_data_arrays(jmd), device="cpu")
        assert tmd.custom_family == jmd.custom_family
        assert tmd.n_theta == jmd.n_theta
        jll, jres, *jq = (np.asarray(a) for a in _jax_family_refs(
            name, jmd)(jnp.asarray(eta), jnp.asarray(theta)))
        te, tth = torch.tensor(eta), torch.tensor(theta)
        ll = float(tfam.log_lik(te, tmd, tth))
        np.testing.assert_allclose(ll, jll, rtol=1e-10, atol=1e-300)
        if loops is not None:       # the reference's C++ loops
            np.testing.assert_allclose(ll, loops, rtol=1e-12, atol=1e-300)
        res = tfam.eta_residual(te, tmd, tth).detach().numpy()
        np.testing.assert_allclose(res, jres, rtol=1e-10,
                                   atol=1e-10 * np.abs(jres).max())
        A = tmd.A
        if name == "none":
            assert tfam.eta_hessian_kind(tmd.family) == "diag"
            assert not tfam.eta_weights(te, tmd, tth).any()
        else:
            # the same gradient by autograd through log_lik
            tg = te.clone().requires_grad_(True)
            (ga,) = torch.autograd.grad(tfam.log_lik(tg, tmd, tth), tg)
            np.testing.assert_allclose(-ga.numpy(), jres, rtol=1e-10,
                                       atol=1e-10 * np.abs(jres).max())
            tq = tfam.eta_hessian_quadform(te, tmd, tth, A).detach().numpy()
            tol = 1e-10 * np.abs(jq[0]).max()
            np.testing.assert_allclose(tq, jq[0], rtol=1e-10, atol=tol)
            M = tfam.eta_hessian_full(te, tmd, tth)
            np.testing.assert_allclose((A.T @ (M @ A)).detach().numpy(), tq,
                                       rtol=1e-10, atol=tol)
        # a batch of etas: each row the same bits as alone
        E = torch.tensor(np.random.default_rng(5).normal(
            0.5, 0.7, (30, tmd.n)))
        rows = torch.stack([tfam.log_lik(e, tmd, tth) for e in E])
        assert torch.equal(tfam.log_lik(E, tmd, tth), rows), name


def _laplace_models():
    """(name, JAX ModelData) of test 2."""
    sim = jbg.datasets.sim1data()
    keep = np.isin(sim["subject"], np.unique(sim["subject"])[:100])
    med = float(np.median(sim["exposure"]))
    specs = [
        ("coxph", "time ~ age + sex + f(x=id, model='IID')",
         make_survival_data(), dict(family="coxph", cens="status")),
        ("cc", "case ~ f(x=exposure, model='IWP', order=2, k=10, "
         f"initial_location={med})", {k: v[keep] for k, v in sim.items()},
         dict(family="cc", strata="subject")),
        ("custom", "y ~ f(x, model='IWP', order=2, k=8)", _nb_data(),
         dict(family="Customized", customized_template=NB)),
    ]
    return [(name, japi.assemble_model(f, data=d, engine="dense", **kw)["md"])
            for name, f, d, kw in specs]


def test_laplace_matches_jax():
    for name, jmd in _laplace_models():
        tmd = convert.model_data_from_arrays(
            convert.model_data_arrays(jmd), device="cpu")
        # md closed over: its host arrays keep the JAX CoxPH on the
        # rank-regrouped form the port computes
        ref = quick_jit(lambda th: jax.value_and_grad(
            lambda t: jlap.laplace_nll(t, jmd)[0])(th))
        for th in (-1.0, 0.0, 1.5):
            theta = np.full(jmd.n_theta, th)
            jv, jg = (np.asarray(a) for a in ref(jnp.asarray(theta)))
            thg = torch.tensor(theta).requires_grad_(True)
            tv, _ = tlap.laplace_nll(thg, tmd)
            (tg,) = torch.autograd.grad(tv, thg)
            np.testing.assert_allclose(float(tv.detach()), jv, rtol=1e-9,
                                       err_msg=f"{name} at {th}")
            np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-7,
                                       err_msg=f"{name} at {th}")


def _fit(formula, data, **kw):
    return tbg.model_fit(formula, data=data, device="cpu", **kw)


def test_entry_points_on_cpu():
    # the case-crossover vignette (tests/test_partial_likelihood.py:9-44)
    data = tbg.datasets.sim1data()
    med = float(np.median(data["exposure"]))
    fit = _fit("case ~ f(x=exposure, model='IWP', order=2, k=30, "
               f"initial_location={med}, sd_prior=dict(prior='exp', "
               "param=dict(u=1, alpha=0.5)))", data, family="cc",
               strata="subject", method="aghq", M=1000, seed=7)
    assert isinstance(fit.mod.backend, taghq.DenseBackend)
    grid = np.linspace(0.05, 0.95, 19)
    pred = fit.predict("exposure", newdata={"exposure": grid})
    true_c = 3 * (grid ** 2 - 0.5 ** 2) - 3 * (med ** 2 - 0.5 ** 2)
    rmse = np.sqrt(np.mean((pred["mean"] - true_c) ** 2))
    assert rmse < np.mean(pred["pupper"] - pred["plower"])
    assert np.mean((true_c >= pred["plower"])
                   & (true_c <= pred["pupper"])) > 0.8
    assert "intercept" not in fit.fixed_samp_indexes

    # CoxPH: the rows are sorted by the response (:81-95)
    data = make_survival_data(n=60, seed=9)
    perm = np.random.default_rng(0).permutation(60)
    f1, f2 = (_fit("time ~ age + f(x=id, model='IID')", d, family="coxph",
                   cens="status", M=500, seed=1)
              for d in (data, {k: v[perm] for k, v in data.items()}))
    assert np.isclose(f1.mod.lognormconst, f2.mod.lognormconst, rtol=1e-8)
    assert np.allclose(f1.mod.mode, f2.mod.mode, atol=1e-6)
    # nlminb on a CoxPH model with no f() term: the mode of W (the inner
    # Newton's stopping test) and draws from the Gaussian there
    nf = _fit("time ~ age + sex", data, family="coxph", cens="status",
              method="nlminb", M=2000, seed=2)
    assert nf.fixed_names == ["age", "sex"]
    md = tobj.to_device(nf.md, "cpu")
    mean = torch.tensor(nf.mod["mean"])
    assert float(tobj.grad_W(mean, torch.zeros(0), md).abs().max()) < 1e-6
    assert np.allclose(nf.samps.mean(axis=1), nf.mod["mean"],
                       atol=4 * np.sqrt(np.diag(np.linalg.inv(
                           nf.mod["prec"]))).max() / np.sqrt(2000))

    # a customized Poisson loglik against the built-in Poisson
    # (tests/test_customized.py:38-59)
    rng = np.random.default_rng(2)
    x = np.sort(rng.uniform(0, 5, 100))
    y = rng.poisson(np.exp(0.5 * np.sin(x) + 1.0)).astype(float)
    formula = "y ~ f(x, model='IWP', order=2, k=8)"
    builtin = _fit(formula, {"y": y, "x": x}, family="Poisson", M=200,
                   seed=3)
    custom = _fit(formula, {"y": y, "x": x}, family="Customized",
                  customized_template=_poisson_torch, M=200, seed=3)
    assert custom.mod.backend.em_dims is None
    assert abs(custom.mod.lognormconst - builtin.mod.lognormconst) < 1e-6
    assert np.allclose(custom.mod.mode, builtin.mod.mode, rtol=0, atol=1e-6)

    # a family registered by name, with two extra thetas: a Gaussian
    # whose log precision is theta_1 + theta_2 z
    z = np.linspace(-1.0, 1.0, 60)
    gy = 0.5 + 0.8 * z + np.exp(-0.5 * (1.0 + 0.5 * z)) * (
        np.random.default_rng(4).normal(size=60))

    def hetero(eta, yy, theta):
        lp = theta[-2] + theta[-1] * torch.as_tensor(z)
        return torch.sum(0.5 * lp - 0.5 * torch.exp(lp) * (yy - eta) ** 2
                         - 0.5 * np.log(2 * np.pi))
    tbg.register_family("hetero_torch_partial_likelihood", hetero,
                        n_theta_extra=2)
    hfit = _fit("y ~ z", {"y": gy, "z": z}, family="Customized",
                customized_template="hetero_torch_partial_likelihood",
                aghq_k=3, M=200)
    ts = hfit.theta_summary()
    assert list(ts) == ["theta(family1)", "theta(family2)"]
    assert all(np.isfinite(r["mean"]) for r in ts.values())

    # a Customized random effect (tests/test_customized.py:11-35)
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 1, 80))
    y = rng.poisson(np.exp(1.0 + np.sin(2 * np.pi * x))).astype(float)

    def compute_B(xv):
        return np.stack([np.sin(2 * np.pi * xv), np.cos(2 * np.pi * xv),
                         np.sin(4 * np.pi * xv), np.cos(4 * np.pi * xv)],
                        axis=1)
    rfit = _fit("y ~ f(x, model='Customized')", {"y": y, "x": x},
                family="Poisson", M=500, seed=1,
                customized_re={"compute_B": compute_B,
                               "compute_P": lambda xv: np.eye(4)})
    assert np.isfinite(rfit.mod.lognormconst)
    assert rfit.samps[rfit.random_samp_indexes["x"], :].mean(axis=1)[0] > 0.5

    with pytest.raises(ValueError, match="customized_template"):
        _fit("y ~ f(x, model='IWP', order=2, k=5)",
             {"y": np.ones(10), "x": np.arange(10.0)}, family="Customized")
