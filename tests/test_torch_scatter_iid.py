"""bayesgp_torch's scattered-IID engine (fast/scatter_iid.py, s = 2 AGHQ)
against the JAX package's ScatterIIDBackend on the same small Poisson
model: an IWP smooth (order 2, k = 150) plus an IID term with 40
scattered levels and an intercept, n = 2000, both in f64 on the CPU. The
Schur block is (154, 154): two 128-blocks of the port's blocked factor
(plain versions here). The JAX backend is built once, with
prefer_host_opt set so that its aghq_fit takes the host path the port
follows (gradient-only BFGS, FD outer Hessian, per-node evaluations).

Tolerances: build arrays 1e-12 relative to each array's scale; the
objective, its latent gradient, the Newton step, the level products,
solves and half-log-det at a fixed (theta, V, u, t), and the warm-started
Laplace nll and inner mode, rtol 1e-9; the theta-gradient rtol 1e-8 (the
prior quadratic's rounding, see the test); mode, lognormconst, node nlls
and marginals 1e-5 absolute; the outer Hessian 1e-3 relative (central
differences of noisy gradients); draw means within 5 Monte-Carlo
standard errors of the conditional mode. A Gaussian model (IWP order 2, k
= 10, 30 scattered levels, n = 400: three hyperparameters, the noise
last) against the JAX package's backend: em_dims, and the Laplace nll and
its theta gradient at three thetas, rtol 1e-9 and 1e-8 (the prior's
rounding, as above).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayesgp_tpu import api as japi
from bayesgp_tpu.fast.scatter_iid import build_scatter_iid as jbuild
from bayesgp_tpu.inference import aghq as jaghq
import bayesgp_torch as tbg
from bayesgp_torch import api as tapi
from bayesgp_torch import convert

from _jax_quick import quick_jit

torch.set_num_threads(1)

FORMULA = "y ~ f(x, model='IWP', order=2, k=150) + f(g, model='IID')"
GAUSS_FORMULA = "y ~ f(x, model='IWP', order=2, k=10) + f(g, model='IID')"
M_DRAWS = 400


def _data(n=2000, q=40, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    g = rng.integers(0, q, n).astype(float)          # scattered levels
    lin = 0.8 + 0.5 * np.sin(x) + 0.2 * rng.normal(size=q)[g.astype(int)]
    return {"x": x, "g": g, "y": rng.poisson(np.exp(lin)).astype(float)}


def _gauss_data(n=400, q=30, seed=5):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    g = rng.integers(0, q, n)
    u = 0.3 * rng.normal(size=q)
    y = 0.5 * np.sin(x) + u[g] + 0.3 * rng.normal(size=n)
    return {"x": x, "g": g.astype(float), "y": y}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's backend and its host-path aghq_fit (k = 3)."""
    asm = japi.assemble_model(FORMULA, data=_data(), family="Poisson",
                              engine="scatter_iid")
    jbe = jbuild(asm["instances"], asm["md"], asm["design_mat_fixed"],
                 asm["bf_prec"], asm["bf_mean"])
    jbe.prefer_host_opt = True
    return jbe, jaghq.aghq_fit(jbe, k=3)


@pytest.fixture(scope="module")
def port():
    return tbg.model_fit(FORMULA, data=_data(), family="Poisson",
                         engine="scatter_iid", aghq_k=3, M=M_DRAWS, seed=0,
                         device="cpu")


def _jax_core_arrays(be):
    out = {f: np.asarray(getattr(be, f)) for f in convert.ARRAY_FIELDS
           if f != "prior_w"}
    out["prior_w"] = convert.driver_prior_w(be)  # the JAX package has none
    out.update({f: np.asarray(getattr(be.md, f))
                for f in convert.MODEL_FIELDS})
    out.update(p=be.p, d=be.d, dpad=be.dpad, family=be.md.family,
               logdetT=be.logdetT, row_order=be.row_order)
    return out


def _jax_arrays(jbe):
    assert list(jbe.core_theta_idx) == [0] and jbe.iid_theta == 1
    return dict(core=_jax_core_arrays(jbe.core), codes=np.asarray(jbe.codes),
                q_iid=jbe.q_iid, logPdet_iid=jbe.logPdet_iid,
                u=np.asarray(jbe.md.u), alpha=np.asarray(jbe.md.alpha),
                d_sizes=jbe.md.d_sizes)


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(initial=0.0), 1e-300)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rtol * scale, (what, err, scale)


def test_build_and_fixed_point_match_jax(ref, port):
    """Model assembly (a lazy IID term), build arrays, level products, and
    nll, theta-gradient, Newton step, solve and half-log-det at a fixed
    (theta, V, u, t) near the JAX fit's top node. Also a port backend built
    from the JAX backend's arrays."""
    jbe, jfit = ref
    tbe = port.mod.backend
    ja, ta = _jax_arrays(jbe), convert.scatter_iid_arrays(tbe)
    np.testing.assert_array_equal(ja["core"]["row_order"],
                                  ta["core"]["row_order"])
    np.testing.assert_array_equal(ja["codes"], ta["codes"])
    for key in ("q_iid", "d_sizes"):
        assert ja[key] == ta[key], key
    for key in ("logPdet_iid", "u", "alpha"):
        _close(ta[key], ja[key], 1e-12, key)
    for f in convert.ARRAY_FIELDS + convert.MODEL_FIELDS:
        _close(ta["core"][f], ja["core"][f], 1e-12, f)

    # the lazy IID term (more than IID_LAZY_MIN_LEVELS levels: no design
    # or precision matrix, only level codes) and the model arrays the
    # path reads, assembled by both packages
    big = dict(_data(n=1200), g=np.arange(1200) % 600.0)
    ja_, ta_ = (pkg.assemble_model(FORMULA, data=big, family="Poisson",
                                   engine="scatter_iid")
                for pkg in (japi, tapi))
    (_, jiid), (_, tiid) = ja_["instances"], ta_["instances"]
    assert jiid.B is None and tiid.B is None and len(tiid.levels) == 600
    np.testing.assert_array_equal(tiid.levels, jiid.levels)
    np.testing.assert_array_equal(tiid.extra["codes"], jiid.extra["codes"])
    assert tiid.logPdet == jiid.logPdet == 0.0
    for f in ("logPdet", "u", "alpha", "betaprec", "betamean", "bf_prec",
              "bf_mean", "y"):
        _close(getattr(ta_["md"], f), getattr(ja_["md"], f), 1e-12, f)
    assert ta_["md"].d_sizes == ja_["md"].d_sizes and ta_["md"].n_theta == 2

    j = int(np.argmax(jfit.logpost_nodes + jfit.logw))
    th = np.asarray(jfit.nodes[j])
    V, u, t = (np.asarray(a[j]) for a in jfit.states[:3])
    rng = np.random.default_rng(7)
    wts = rng.uniform(0.5, 2.0, tbe.core.md.y.shape[0])
    g3 = [rng.normal(size=a.shape) for a in (V, u, t)]
    # the objective, its gradient, the Newton step and the factor away
    # from the inner mode (where the gradient is rounding noise)
    Vo, uo, to = (a + 0.05 * rng.normal(size=a.shape) for a in (V, u, t))
    Vo[tbe.core.d:] = 0.0

    @quick_jit
    def probe(V, u, t, th, wts, gV, gu, gt):
        factor = jbe.hessian_factor(V, u, t, th)
        return (jbe.neg_log_post(V, u, t, th), jbe.grad_W(V, u, t, th),
                jbe.newton_step(V, u, t, th)[:3], jbe.half_logdet_H(factor),
                jbe.solve_H(factor, gV, gu, gt), jbe._iid_products(wts))

    want = jax.tree_util.tree_map(np.asarray, probe(
        *map(jnp.asarray, (Vo, uo, to, th, wts, *g3))))
    # the Laplace nll and its theta-gradient away from the outer mode,
    # warm-started from the node's inner mode
    th_off = th + np.array([0.4, -0.3])
    vgj = jbe.val_grad_warm_fn()(jnp.asarray(th_off),
                                 tuple(map(jnp.asarray, (V, u, t))))
    cbe = convert.scatter_iid_from_arrays(ja, device="cpu")
    T = lambda a: torch.tensor(np.asarray(a, np.float64))
    for be in (tbe, cbe):
        Vt, ut, tt, tht = map(T, (Vo, uo, to, th))
        with torch.no_grad():
            factor = be.hessian_factor(Vt, ut, tt, tht)
            got = (be.neg_log_post(Vt, ut, tt, tht),
                   be.grad_W(Vt, ut, tt, tht),
                   be.newton_step(Vt, ut, tt, tht)[:3],
                   be.half_logdet_H(factor),
                   be.solve_H(factor, *map(T, g3)),
                   be.iid_products(T(wts)))
        names = ("neg_log_post", "grad_W", "newton_step", "half_logdet_H",
                 "solve_H", "iid_products")
        for name, a, b in zip(names, got, want):
            for i, (x, y) in enumerate(zip(jax.tree_util.tree_leaves(a),
                                           jax.tree_util.tree_leaves(b))):
                _close(x.numpy(), y, 1e-9, f"{name}[{i}]")
        val, g, st = be.value_and_grad(T(th_off), convert.latent_state_iid(
            V, u, t, device="cpu"))
        _close(float(val), float(vgj[0][0]), 1e-9, "nll")
        # the prior's V'P V is a sum of large terms that cancel, which
        # each package rounds in its own summation order; that rounding
        # moves the smooth's theta-gradient by more than 1e-9 of the
        # gradient's scale here (both are exact to within it)
        _close(g.numpy(), vgj[1], 1e-8, "theta gradient")
        for x, y in zip(st, vgj[0][1]):
            _close(x.numpy(), y, 1e-9, "inner mode")

    # a Gaussian response: the noise theta last on both packages
    jasm, tasm = (pkg.assemble_model(GAUSS_FORMULA, data=_gauss_data(),
                                     family="Gaussian", engine="scatter_iid")
                  for pkg in (japi, tapi))
    jga = jbuild(jasm["instances"], jasm["md"], jasm["design_mat_fixed"],
                 jasm["bf_prec"], jasm["bf_mean"])
    tga = tapi._backend(tasm, "scatter_iid", torch.device("cpu"))
    np.testing.assert_array_equal(tga.em_dims, np.asarray(jga.em_dims))
    np.testing.assert_array_equal(tga.em_dims, [9.0, 30.0, 400.0])
    vgg = quick_jit(jax.value_and_grad(lambda th: jga.laplace_nll(th)[0]))
    for th in ([1.0, 2.0, 2.0], [3.0, 0.5, 2.5], [-0.5, 1.0, 0.0]):
        vj, gj = vgg(jnp.asarray(th, jnp.float64))
        val, g, _ = tga.value_and_grad(T(th), tga.init_state())
        _close(float(val), float(vj), 1e-9, "Gaussian nll")
        _close(g.numpy(), np.asarray(gj), 1e-8, "Gaussian theta gradient")


def test_aghq_fit_matches_jax(ref, port):
    """The port's aghq_fit (run by model_fit) against the JAX host-path
    fit: mode, lognormconst, node nlls, outer Hessian and marginals."""
    _, jfit = ref
    tfit = port.mod
    np.testing.assert_allclose(tfit.mode, jfit.mode, rtol=0, atol=1e-5)
    assert abs(tfit.lognormconst - jfit.lognormconst) <= 1e-5
    np.testing.assert_allclose(tfit.hessian, jfit.hessian, rtol=1e-3,
                               atol=1e-3 * np.abs(jfit.hessian).max())
    np.testing.assert_allclose(tfit.nodes, jfit.nodes, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tfit.lognll, jfit.lognll, rtol=0, atol=1e-5)
    assert len(tfit.marginals) == len(jfit.marginals) == 2
    for mt, mj in zip(tfit.marginals, jfit.marginals):
        for key in ("theta", "logmargpost"):
            np.testing.assert_allclose(mt[key], mj[key], rtol=0, atol=1e-5)


def test_model_fit_draws_and_summaries(ref, port):
    """model_fit end to end: draws in reference order with the right
    shape, predict and summary, and draws at the top node centred on the
    JAX package's conditional mode there."""
    jbe, jfit = ref
    fit, be = port, port.mod.backend
    d, q, qf = be.core.d, be.q_iid, be.core.q
    assert fit.samps.shape == (d + q + qf, M_DRAWS)
    assert np.all(np.isfinite(fit.samps))
    assert fit.theta_samps.shape == (M_DRAWS, 2)
    assert np.array_equal(fit.random_samp_indexes["g"], np.arange(d, d + q))
    pred = fit.predict("x")
    assert pred["mean"].shape == pred["x"].shape and np.all(
        pred["plower"] <= pred["pupper"])
    assert "theta(g)" in fit.summary()

    j = int(np.argmax(jfit.logpost_nodes + jfit.logw))
    Vj, uj, tj = (np.asarray(a[j]) for a in jfit.states[:3])
    Vact = np.asarray(jbe.core.to_V(jnp.asarray(Vj), jnp.asarray(tj)))
    mode = np.concatenate([
        np.asarray(jbe.core.apply_T(jnp.asarray(Vact[:d]))), uj, tj])
    M = 2000
    gen = torch.Generator().manual_seed(3)
    Z = [torch.randn((r, M), dtype=torch.float64, generator=gen)
         for r in be.noise_rows()]
    draws = be.sample([fit.mod.states[j]], torch.zeros(M, dtype=torch.long),
                      *Z).numpy()
    se = draws.std(axis=1) / np.sqrt(M)
    assert np.all(np.abs(draws.mean(axis=1) - mode) < 5 * se + 1e-9)
