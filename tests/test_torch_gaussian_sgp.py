"""bayesgp_torch's Gaussian noise hyperparameter and sGP driver on the fast
engines, against the JAX package on CPU f64 and against the port's own
dense route, from the same numpy data.

- The Gaussian single-IWP FastIWPBackend (p = 2, k = 10, n = 120: the
  Gaussian model of tests/test_fast_iwp.py) against the JAX
  FastIWPBackend: Laplace nll and its 2-vector theta gradient.
- The sGP-driver BandedBackend at m = 1 with a Gaussian likelihood and
  at m = 2 with a Poisson one (the problems of tests/test_banded_generic.
  py) against the JAX build_banded_backend: nll and theta gradient.
- model_fit(engine="banded") on a small Gaussian IWP + sGP model (an sGP
  driver, the IWP smooth in the tail, s = 3) against the port's dense
  fit, as tests/test_banded_generic.py holds the JAX package's. (The
  Gaussian scattered-IID and merged-IID backends are held to the JAX
  package in tests/test_torch_scatter_iid.py and
  tests/test_torch_banded.py.)

Tolerances: value 1e-8 relative and gradient 1e-6 relative against the
JAX package (both sides converge an f64 inner Newton to ~1e-9; the port
takes the driver's prior as a sum of squares, the JAX package expanded,
which differ in rounding); the banded fit against the dense fit: mode
1e-4, lognormconst 1e-4 nats, theta means 1e-3 and the predict means
within 0.1 of their scale (different Monte Carlo draws), as
tests/test_banded_generic.py.

Three tests, on purpose (ROADMAP, test-time budget): each JAX reference
is one program compiled with _jax_quick.quick_jit, and the file starts
no threads.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from bayesgp_tpu import terms as jterms
from bayesgp_tpu.model import build as jbuild
from bayesgp_tpu.fast.iwp import build_fast_iwp as jbuild_fast_iwp
from bayesgp_tpu.fast.banded import build_banded_backend as jbuild_banded
import bayesgp_torch as tbg
from bayesgp_torch import api as tapi
from bayesgp_torch import terms as tterms
from bayesgp_torch.model import build as tbuild
from bayesgp_torch.fast.banded import BandedBackend, build_banded_backend
from bayesgp_torch.fast.iwp import FastIWPBackend, build_fast_iwp

from _jax_quick import quick_jit

torch.set_num_threads(1)

VAL_RTOL, GRAD_RTOL = 1e-8, 1e-6


def _close(port, ref, rtol):
    port, ref = np.atleast_1d(np.asarray(port)), np.atleast_1d(ref)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _port_vg(be, theta):
    v, g, _ = be.value_and_grad(torch.tensor(theta), be.init_state())
    return float(v), g.numpy()


def _gaussian_iwp(pkg_terms, pkg_build, make, n=120, k=10, p=2, seed=12,
                  **kw):
    """tests/test_fast_iwp.py's Gaussian problem (seed p + k)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 6.0, n))
    eta = 0.4 * np.sin(x) + 0.8
    y = eta + rng.normal(0, 0.4, n)
    inst = pkg_terms.build_iwp_term("x", x, order=p, k=k)
    dmf = [np.ones((n, 1)), rng.normal(0, 1, (n, 1))]
    md = pkg_build.build_model_data([inst], dmf, y, "Gaussian")
    xf = np.concatenate([inst.X] + dmf, axis=1)
    q_prior = np.full(xf.shape[1], 0.01)
    return make(inst, md, xf, q_prior, np.zeros_like(q_prior), inst.x_data,
                **kw)


def _sgp_problem(pkg_terms, pkg_build, n=150, k=20, m=1, family="Poisson",
                 seed=0):
    """tests/test_banded_generic.py's sGP-driver problem."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 40.0, n))
    eta = 0.6 * np.sin(2 * np.pi * x / 10.0) + 1.2
    y = rng.poisson(np.exp(eta)).astype(np.float64)
    inst = pkg_terms.build_sgp_term("x", x, period=10.0, k=k, m=m)
    dmf = [np.ones((n, 1)), rng.normal(0, 1, (n, 1))]
    bf_prec, bf_mean = np.full(2, 0.01), np.zeros(2)
    md = pkg_build.build_model_data([inst], dmf, y, family,
                                    control_fixed_prec=bf_prec,
                                    control_fixed_mean=bf_mean)
    return [inst], md, dmf, bf_prec, bf_mean


def test_gaussian_single_iwp_matches_jax():
    jbe = _gaussian_iwp(jterms, jbuild, jbuild_fast_iwp)
    tbe = _gaussian_iwp(tterms, tbuild, build_fast_iwp, device="cpu")
    assert tbe.n_theta == 2
    np.testing.assert_array_equal(tbe.em_dims, jbe.em_dims)
    jvg = quick_jit(jax.value_and_grad(lambda th: jbe.laplace_nll(th)[0]))
    for th in ([0.0, 0.0], [1.5, -0.3], [-0.7, 1.2]):
        vj, gj = jvg(jnp.asarray(th))
        v, g = _port_vg(tbe, th)
        _close(v, float(vj), VAL_RTOL)
        _close(g, np.asarray(gj), GRAD_RTOL)


def test_sgp_driver_banded_matches_jax():
    cases = ((dict(family="Gaussian"), ([0.0, 0.0], [2.0, 1.0], [-1.0, 2.0])),
             (dict(k=12, m=2), ([0.0], [2.0])))
    for kw, thetas in cases:
        jbe = jbuild_banded(*_sgp_problem(jterms, jbuild, **kw))
        tbe = build_banded_backend(*_sgp_problem(tterms, tbuild, **kw),
                                   device="cpu")
        m = kw.get("m", 1)
        assert tbe.T_is_root and tbe.Wl == 12 * m and tbe.Wl == jbe.Wl
        assert tbe.d == jbe.d and tbe.dpad == jbe.dpad and tbe.q == jbe.q
        np.testing.assert_array_equal(tbe.em_dims, jbe.em_dims)
        jvg = quick_jit(jax.value_and_grad(jbe.nll))
        for th in thetas:
            vj, gj = jvg(jnp.asarray(th, jnp.float64))
            v, g = _port_vg(tbe, th)
            _close(v, float(vj), VAL_RTOL)
            _close(g, np.asarray(gj), GRAD_RTOL)


def _two_smooth_data(n=200, seed=4):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 40.0, n))
    y = (0.02 * x + 0.4 * np.sin(x / 6.0)
         + 0.6 * np.sin(2 * np.pi * x / 10.0) + 0.3 * rng.normal(size=n))
    return {"x": x, "xs": x.copy(), "y": y}


def test_model_fit_banded_gaussian_matches_dense():
    data = _two_smooth_data()
    fml = ("y ~ f(x=x, model='IWP', order=2, k=8) "
           "+ f(x=xs, model='sGP', period=10, k=10)")
    fits = {eng: tbg.model_fit(fml, data=data, family="Gaussian",
                               engine=eng, aghq_k=2, M=1000, seed=0,
                               device="cpu")
            for eng in ("dense", "banded")}
    fit_d, fit_b = fits["dense"], fits["banded"]
    be = fit_b.mod.backend
    assert isinstance(be, BandedBackend) and be.T_is_root
    assert be.n_theta == 3 and be.drv_theta == 1
    np.testing.assert_allclose(fit_b.mod.mode, fit_d.mod.mode, atol=1e-4)
    assert abs(fit_b.mod.lognormconst - fit_d.mod.lognormconst) < 1e-4
    for var in ("x", "xs"):
        p_d, p_b = fit_d.predict(var), fit_b.predict(var)
        scale = np.abs(p_d["mean"]).max()
        assert np.max(np.abs(p_d["mean"] - p_b["mean"])) < 0.1 * scale
    ts_d, ts_b = fit_d.theta_summary(), fit_b.theta_summary()
    assert set(ts_b) == {"theta(x)", "theta(xs)", "theta(family)"}
    for name in ts_b:
        assert abs(ts_d[name]["mean"] - ts_b[name]["mean"]) < 1e-3

    # a Gaussian single-IWP model at scale takes the banded single-IWP
    # backend
    asm = tapi.assemble_model("y ~ f(x=x, model='IWP', order=2, k=8)",
                              data=data, family="Gaussian", engine="banded")
    assert isinstance(tapi._backend(asm, "banded", torch.device("cpu")),
                      FastIWPBackend)
