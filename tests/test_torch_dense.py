"""bayesgp_torch's dense route (model/objective.py, inference/laplace.py,
aghq.DenseBackend) and the small main path it carries, on the CPU in f64.

1. The objective and the Laplace machinery against the JAX package's, on
   four small dense models built by the JAX package from one numpy seed
   and carried into the port by convert.model_data_arrays /
   model_data_from_arrays: Poisson IWP, Binomial IWP, Gaussian sGP + IID
   (three hyperparameters) and a Poisson model with no hyperparameter
   (laplace_mode_hess at an empty theta, the nlminb route). Tolerances:
   rtol 1e-9 (the W-gradient and the factor also atol 1e-9 of their
   largest entry), the Laplace value's theta gradient rtol 1e-8.
2. The reference README covid fit on the port against the golden
   constants of tests/test_golden_covid.py, at that file's tolerances,
   and the post-fit surface it pins; save_fit/load_fit; predict_at.
3. The sGP lynx vignette fit on the port: its nll at its mode and nodes
   against the JAX package's laplace_nll (1e-8), its mode and
   lognormconst against the JAX package's CPU-f64 fit (1e-3);
   method="nlminb" against the JAX package's laplace_mode_hess (1e-8) and
   its draws against N(mean, prec^-1) at Monte Carlo tolerance; and
   engine="auto" routing both small models to the dense backend.

Three tests (the tier-1 run's file scheduler; ROADMAP constraints). Each
JAX reference is compiled once per module with XLA's CPU optimizations
off (_jax_quick.quick_jit); no JAX fit runs here.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bayesgp_tpu as jbg
from bayesgp_tpu import api as japi
from bayesgp_tpu.model import objective as jobj
from bayesgp_tpu.inference import laplace as jlap
import bayesgp_torch as tbg
from bayesgp_torch import api as tapi
from bayesgp_torch import convert
from bayesgp_torch.model import objective as tobj
from bayesgp_torch.inference import aghq as taghq
from bayesgp_torch.inference import laplace as tlap

from _jax_quick import quick_jit

torch.set_num_threads(1)

COVID = ("new_deaths ~ weekdays1 + weekdays2 + weekdays3 + weekdays4 "
         "+ weekdays5 + weekdays6 + f(t, model='IWP', order=3, k=30)")
# tests/test_golden_covid.py:21-29
GOLDEN = {
    "mode": -3.245926,
    "lognormconst": -4322.531,
    "quad_cov": 0.07936619,
    "mean": -3.271182, "sd": 0.2785344,
    "q2.5": -3.87922, "median": -3.268308, "q97.5": -2.760093,
    "fixed_means": [-5.40445, 0.09375, 0.07922, 0.12672, 0.12547,
                    0.05001, -0.15126],
}
LYNX = ("y ~ f(x=year, model='sGP', a=a_val, k=20, "
        "sd_prior=dict(prior='exp', param=prior_SD, h=2), "
        "boundary_prior=dict(prec=0.001)) "
        "+ f(x=idx, model='IID', "
        "sd_prior=dict(prior='exp', param=dict(u=1, alpha=0.01)))")
# the JAX package's lynx fit (bayesgp_tpu.model_fit with LYNX and
# _lynx_kwargs() below, aghq_k=4, M=500, seed=0, CPU f64: its dense
# backend and fused optimizer), recorded once
LYNX_JAX_MODE = np.array([2.143093002767, 2.581121558894])
LYNX_JAX_LNC = -716.1395570200965


def _small_models():
    """(name, formula, data, family, method) of test 1's models, n = 120,
    from one numpy seed."""
    rng = np.random.default_rng(11)
    n = 120
    x = np.sort(rng.uniform(0.0, 10.0, n))
    z = rng.normal(size=n)
    g = (np.arange(n) % 6).astype(float)
    f = 0.6 * np.sin(x) + 0.3 * z
    pois = rng.poisson(np.exp(0.5 + f)).astype(float)
    binom = rng.binomial(5, 1.0 / (1.0 + np.exp(-f))).astype(float)
    gauss = 1.0 + f + 0.2 * rng.normal(size=6)[g.astype(int)] \
        + 0.3 * rng.normal(size=n)
    data = {"x": x, "z": z, "g": g, "pois": pois, "binom": binom,
            "gauss": gauss, "size": np.full(n, 5.0)}
    return [
        ("poisson_iwp", "pois ~ z + f(x, model='IWP', order=3, k=12)",
         data, "Poisson", "aghq", {}),
        ("binomial_iwp", "binom ~ f(x, model='IWP', order=2, k=10)",
         data, "Binomial", "aghq", {"size": "size"}),
        ("gaussian_sgp_iid", "gauss ~ f(x, model='sGP', period=6.0, k=8) "
         "+ f(g, model='IID')", data, "Gaussian", "aghq", {}),
        ("poisson_nlminb", "pois ~ z", data, "Poisson", "nlminb", {}),
    ]


def _jax_md(formula, data, family, method, extra):
    return japi.assemble_model(formula, data=data, family=family,
                               method=method, engine="dense", **extra)["md"]


def _jax_dense_refs(W, theta, md):
    """Everything test 1 holds the port to, in one JAX program with one
    Newton loop: the factor is laplace_nll_with_factor's, formed at the
    mode laplace_nll returns (the same solve)."""
    g = jax.grad(jobj.neg_log_post)(W, theta, md)
    (val, Ws), gth = jax.value_and_grad(jlap.laplace_nll, has_aux=True)(
        theta, md)
    d, Ls, _ = jlap._equilibrated_chol(jobj.hessian_W(Ws, theta, md))
    return (jobj.neg_log_post(W, theta, md), g,
            jobj.prior_precision(theta, md), jobj.hessian_W(W, theta, md),
            Ws, val, gth, d[:, None] * Ls)


@functools.lru_cache(maxsize=None)
def _nlminb_ref():
    """The JAX package's laplace_mode_hess on the no-hyperparameter
    model: (its data, its (W*, H))."""
    _, formula, data, family, method, extra = _small_models()[3]
    md = _jax_md(formula, data, family, method, extra)
    Ws, H, _ = quick_jit(lambda m: jlap.laplace_mode_hess(
        jnp.zeros((0,)), m))(md)
    return md, (np.asarray(Ws), np.asarray(H))


def test_objective_and_laplace_match_jax():
    for name, formula, data, family, method, extra in _small_models():
        jmd = _jax_md(formula, data, family, method, extra)
        tmd = convert.model_data_from_arrays(
            convert.model_data_arrays(jmd), device="cpu")
        rng = np.random.default_rng(3)
        W = 0.1 * rng.normal(size=jmd.w_count)
        Wt = torch.tensor(W)
        if method == "nlminb":
            jmd, (jW, jH) = _nlminb_ref()
            tW, tH, tL = tlap.laplace_mode_hess(torch.zeros(0), tmd)
            np.testing.assert_allclose(tW.numpy(), jW, rtol=1e-9)
            np.testing.assert_allclose(tH.numpy(), jH, rtol=1e-9)
            np.testing.assert_allclose((tL @ tL.T).numpy(), jH, rtol=1e-9)
            continue
        theta = 0.3 * rng.normal(size=jmd.n_theta)
        refs = [np.asarray(a) for a in quick_jit(_jax_dense_refs)(
            jnp.asarray(W), jnp.asarray(theta), jmd)]
        f, g, Q, H, Wn, val, gth, Lf = refs
        th = torch.tensor(theta)
        np.testing.assert_allclose(
            float(tobj.neg_log_post(Wt, th, tmd)), f, rtol=1e-9)
        np.testing.assert_allclose(
            tobj.grad_W(Wt, th, tmd).numpy(), g, rtol=1e-9,
            atol=1e-9 * np.abs(g).max())
        # the same gradient by autograd through the objective
        Wg = Wt.clone().requires_grad_(True)
        (ga,) = torch.autograd.grad(tobj.neg_log_post(Wg, th, tmd), Wg)
        np.testing.assert_allclose(ga.numpy(), g, rtol=1e-9,
                                   atol=1e-9 * np.abs(g).max())
        np.testing.assert_allclose(tobj.prior_precision(th, tmd).numpy(),
                                   Q, rtol=1e-9)
        np.testing.assert_allclose(tobj.hessian_W(Wt, th, tmd).numpy(), H,
                                   rtol=1e-9)
        thg = th.clone().requires_grad_(True)
        tval, tWs = tlap.laplace_nll(thg, tmd)
        (tgth,) = torch.autograd.grad(tval, thg)
        np.testing.assert_allclose(tWs.detach().numpy(), Wn, rtol=1e-9,
                                   atol=1e-9 * np.abs(Wn).max())
        np.testing.assert_allclose(float(tval.detach()), val, rtol=1e-9)
        np.testing.assert_allclose(tgth.numpy(), gth, rtol=1e-8)
        tval2, _, tLf = tlap.laplace_nll_with_factor(th, tmd)
        np.testing.assert_allclose(float(tval2), val, rtol=1e-9)
        np.testing.assert_allclose(tLf.numpy(), Lf, rtol=1e-9,
                                   atol=1e-9 * np.abs(Lf).max())
        # the backend's value and gradient are the same functions
        be = taghq.DenseBackend(tmd, device="cpu")
        bval, bg, _ = be.value_and_grad(theta, be.init_state())
        assert float(bval) == float(tval.detach())
        np.testing.assert_allclose(bg.numpy(), tgth.numpy(), rtol=1e-12)


@pytest.fixture(scope="module")
def covid_fit():
    return tbg.model_fit(COVID, data=tbg.datasets.covid_canada(),
                         family="Poisson", method="aghq", M=3000, seed=1,
                         predict_at=("t", np.linspace(0.0, 600.0, 50)),
                         device="cpu")


def test_covid_readme_flow_golden(covid_fit, tmp_path):
    fit = covid_fit
    assert isinstance(fit.mod.backend, taghq.DenseBackend)
    # the fit (test_golden_covid.py test_native_fit_golden)
    assert abs(fit.mod.mode[0] - GOLDEN["mode"]) < 5e-4
    assert abs(fit.mod.lognormconst - GOLDEN["lognormconst"]) < 2e-3
    cov = float(np.linalg.inv(fit.mod.hessian)[0, 0])
    assert abs(cov - GOLDEN["quad_cov"]) < 5e-3
    ts = fit.theta_summary()["theta(t)"]
    assert abs(ts["mean"] - GOLDEN["mean"]) < 1e-4
    assert abs(ts["sd"] - GOLDEN["sd"]) < 1e-3
    assert abs(ts["median"] - GOLDEN["median"]) < 5e-3
    assert abs(ts["q2.5"] - GOLDEN["q2.5"]) < 1e-2
    assert abs(ts["q97.5"] - GOLDEN["q97.5"]) < 1e-2
    # fixed-effect means at the Monte Carlo tolerances of test_golden_covid
    fx = fit.fixed_effects_summary()
    names = ["intercept"] + [f"weekdays{i}" for i in range(1, 7)]
    for name, golden, tol in zip(names, GOLDEN["fixed_means"],
                                 [0.15] + [0.004] * 6):
        assert abs(fx[name]["Mean"] - golden) < tol, (name, fx[name])

    # the reference's own adaptation: the port's Laplace nll at the golden
    # nodes reproduces the README summary (test_reference_adaptation_parity)
    mode = np.array([GOLDEN["mode"]])
    H = np.array([[1.0 / GOLDEN["quad_cov"]]])
    Lc = np.linalg.cholesky(np.linalg.inv(H))
    z, logw_base = taghq.product_grid(4, 1)
    nodes = mode[None, :] + z @ Lc.T
    logw = logw_base + np.log(np.diag(Lc)).sum()
    md = fit.mod.backend.md
    nlls = np.array([float(tlap.laplace_nll(torch.tensor(th), md)[0])
                     for th in nodes])
    lognorm = taghq._logsumexp_np(-nlls + logw)
    assert abs(lognorm - GOLDEN["lognormconst"]) < 1e-3
    ref = taghq.AGHQFit(mode=mode, hessian=H, L=Lc, nodes=nodes, logw=logw,
                        lognll=nlls, lognormconst=lognorm, states=None, k=4)
    ref.marginals = [taghq.marginal_posterior(ref, 0)]
    rows = taghq.summarize_marginals(ref)[0]
    for key in ("mean", "sd", "q2.5", "median", "q97.5"):
        assert abs(rows[key] - GOLDEN[key]) < 1e-5, (key, rows[key])

    # the post-fit surface (test_golden_covid.py:99-236)
    text = fit.summary()
    for line in ("AGHQ on a 1 dimensional posterior with  4 quadrature "
                 "points", "The posterior mode is:",
                 "The log of the normalizing constant/marginal likelihood "
                 "is:", "The covariance matrix used for the quadrature "
                 "is...", "[,1]", "[1,]", "theta(t)",
                 "Here are some moments and quantiles for the log "
                 "precision:", "Here are some moments and quantiles for "
                 "the fixed effects:"):
        assert line in text, line
    table = fit.post_table()
    assert "intercept" in [r["name"] for r in table]
    row = [r for r in table if r["name"] == "t (SD)"][0]
    for key, q in (("median", "median"), ("q0.025", "q97.5"),
                   ("q0.975", "q2.5")):
        golden_sd = np.exp(-GOLDEN[q] / 2)
        assert abs(row[key] - golden_sd) / golden_sd < 0.02, (key, row)
    assert row["prior"] == "Exponential"
    assert row["prior:P1"] == 1.0 and row["prior:P2"] == 0.5
    np.testing.assert_allclose(
        [row["median"], row["q0.025"], row["q0.975"]],
        [5.105, 3.943, 6.897], atol=0.02)
    vd = fit.var_density(component="t")
    sd, post, prior = vd["SD"], vd["post"], vd["prior"]
    assert abs(np.trapezoid(post, sd) - 1.0) < 0.01
    sd_mode = sd[np.argmax(post)]
    assert abs(sd_mode - np.exp(-GOLDEN["mode"] / 2)) < 0.15
    lam = np.log(2.0)
    np.testing.assert_allclose(prior, lam * np.exp(-lam * sd), rtol=1e-10)
    np.testing.assert_allclose([sd_mode, post.max()], [4.9808, 0.60777],
                               atol=0.02)
    pred = fit.predict("t")
    assert len(pred["mean"]) == 787
    assert np.all(pred["plower"] <= pred["pupper"])
    for degree in (1, 2):
        assert np.all(np.isfinite(fit.predict("t", degree=degree)["mean"]))
    # the reference's names and function spellings
    assert tbg.compute_post_fun_IWP is tbg.compute_post_fun_iwp
    assert tbg.prior_conversion_IWP is tbg.prior_conversion_iwp
    assert tbg.prior_conversion_sGP is tbg.prior_conversion_sgp
    assert tbg.global_poly_helper_sGP is tbg.global_poly_sgp
    assert tbg.compute_d_step_sGPsd is tbg.compute_d_step_sgp_sd
    assert [r["name"] for r in tbg.post_table(fit)] == [r["name"]
                                                        for r in table]
    assert "prior" in tbg.var_density(fit, component="t")
    assert tbg.sample_fixed_effect(fit, "weekdays1").shape == (3000, 1)
    assert "intercept" in tbg.para_density(fit)
    np.testing.assert_array_equal(tbg.predict(fit, "t")["mean"],
                                  pred["mean"])
    assert tbg.summary(fit) == text
    assert tbg.f("t", model="IWP").smoothing_var == "t"

    # save_fit / load_fit: the same fit, and predict from the loaded one
    path = str(tmp_path / "covid.npz")
    tbg.save_fit(fit, path)
    fit2 = tbg.load_fit(path)
    assert fit2.mod.lognormconst == fit.mod.lognormconst
    np.testing.assert_array_equal(fit2.samps, fit.samps)
    np.testing.assert_array_equal(fit2.mod.nodes, fit.mod.nodes)
    assert fit2.theta_summary() == fit.theta_summary()
    new = {"t": np.linspace(0.0, 700.0, 41)}
    for key in ("t", "mean", "plower", "pupper"):
        np.testing.assert_array_equal(fit2.predict("t", newdata=new)[key],
                                      fit.predict("t", newdata=new)[key])
    assert [r["name"] for r in fit2.post_table()] == [r["name"]
                                                      for r in table]
    # predict_at: the regular predict, attached to the fit
    pa = fit.predictions["t"]
    want = fit.predict("t", newdata={"t": np.linspace(0.0, 600.0, 50)})
    for key in ("t", "mean", "plower", "pupper"):
        np.testing.assert_array_equal(pa[key], want[key])


def _lynx_kwargs():
    lynx = tbg.datasets.lynx()
    prior_SD = tbg.prior_conversion_sgp(d=50, prior={"u": 1.0,
                                                     "alpha": 0.01},
                                        a=2 * np.pi / 10)
    return dict(data={"year": lynx["year"], "y": lynx["count"],
                      "idx": np.arange(len(lynx["year"]), dtype=float)},
                family="Poisson",
                env={"a_val": 2 * np.pi / 10, "prior_SD": prior_SD},
                control_fixed={"intercept": {"prec": 0.001, "mean": 0}})


def test_lynx_nlminb_and_routes(covid_fit):
    kw = _lynx_kwargs()
    fit = tbg.model_fit(LYNX, method="aghq", M=500, device="cpu", **kw)
    be = fit.mod.backend
    assert isinstance(be, taghq.DenseBackend) and be.md.w_count == 171
    # the port's nll at its mode and nodes against the JAX package's
    jmd = japi.assemble_model(LYNX, method="aghq", **kw)["md"]
    thetas = np.concatenate([fit.mod.mode[None, :], fit.mod.nodes])
    jnll = quick_jit(lambda th, m: jlap.laplace_nll(th, m)[0])
    jn = np.array([float(jnll(jnp.asarray(th), jmd)) for th in thetas])
    tn = float(tlap.laplace_nll(torch.tensor(fit.mod.mode), be.md)[0])
    np.testing.assert_allclose(np.concatenate([[tn], fit.mod.lognll]), jn,
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(fit.mod.mode, LYNX_JAX_MODE, atol=1e-3)
    assert abs(fit.mod.lognormconst - LYNX_JAX_LNC) < 1e-3
    pred = fit.predict("year")
    assert pred["mean"].max() - pred["mean"].min() > 1.5
    assert np.all(np.isfinite(fit.var_density(component="year")["post"]))

    # nlminb on the no-hyperparameter model
    jmd, (jW, jH) = _nlminb_ref()
    _, formula, data, family, _, _ = _small_models()[3]
    M = 20000
    nf = tbg.model_fit(formula, data=data, family=family, method="nlminb",
                       M=M, seed=4, device="cpu")
    np.testing.assert_allclose(nf.mod["mean"], jW, rtol=1e-8)
    np.testing.assert_allclose(nf.mod["prec"], jH, rtol=1e-8)
    cov = np.linalg.inv(nf.mod["prec"])
    sd = np.sqrt(np.diag(cov))
    assert nf.samps.shape == (jmd.w_count, M)
    assert np.all(np.abs(nf.samps.mean(1) - jW) < 5 * sd / np.sqrt(M))
    np.testing.assert_allclose(np.cov(nf.samps), cov, rtol=0,
                               atol=5 * np.sqrt(2.0 / M) * sd.max() ** 2)
    assert nf.theta_summary() is None
    assert "intercept" in nf.summary()

    # engine="auto" takes the dense route for both small models
    assert isinstance(covid_fit.mod.backend, taghq.DenseBackend)
    asm = tapi.assemble_model(LYNX, **kw)
    assert not asm["use_banded"]
    assert isinstance(tapi._backend(asm, "auto", torch.device("cpu")),
                      taghq.DenseBackend)
