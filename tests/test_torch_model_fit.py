"""The bayesgp_torch slice end to end: model_fit with one IWP smooth, a
fixed effect and a Poisson likelihood on the banded engine, against the
JAX package's model_fit on the same data (the headline benchmark's
generator at n=2000, k=40), both in f64 on the CPU.

Tolerances: mode 1e-5, outer Hessian rtol 1e-4, lognormconst and node
nlls 1e-6 absolute; posterior predictions within 0.15 of the spread of
the predicted mean (the two packages draw different random numbers).
"""
import numpy as np
import pytest
import torch

import bayesgp_tpu as jbg
import bayesgp_torch as tbg
from bayesgp_torch import api as tapi

torch.set_num_threads(1)

FORMULA = "y ~ z + f(x, model='IWP', order=3, k=40)"
# CPU-f64 values of the JAX package at this configuration
REF_MODE, REF_H, REF_LNC = 14.064024, 8.8101, -4705.760766


def _data(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 365.0, n))
    f_true = 1.5 + 0.8 * np.sin(2 * np.pi * x / 90.0) + 0.002 * x
    y = rng.poisson(np.exp(f_true)).astype(np.float64)
    z = rng.normal(0, 1, n)
    return {"x": x, "y": y, "z": z}


@pytest.fixture(scope="module")
def fits():
    data = _data()
    kw = dict(data=data, family="Poisson", method="aghq", engine="banded",
              M=3000, seed=0)
    return jbg.model_fit(FORMULA, **kw), tbg.model_fit(FORMULA, device="cpu",
                                                       **kw)


def test_fit_matches_jax(fits):
    fj, ft = fits
    assert abs(fj.mod.mode[0] - REF_MODE) < 1e-6
    assert abs(fj.mod.hessian[0, 0] - REF_H) < 1e-4
    assert abs(fj.mod.lognormconst - REF_LNC) < 1e-6
    assert abs(ft.mod.mode[0] - fj.mod.mode[0]) <= 1e-5
    np.testing.assert_allclose(ft.mod.hessian, fj.mod.hessian, rtol=1e-4)
    assert abs(ft.mod.lognormconst - fj.mod.lognormconst) <= 1e-6
    np.testing.assert_allclose(ft.mod.lognll, fj.mod.lognll, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ft.mod.nodes, fj.mod.nodes, atol=1e-5)


def test_posterior_summaries_match_jax(fits):
    fj, ft = fits
    assert ft.samps.shape == fj.samps.shape
    assert np.all(np.isfinite(ft.samps))
    pj, pt = fj.predict("x"), ft.predict("x")
    np.testing.assert_array_equal(pt["x"], pj["x"])
    scale = np.std(pj["mean"])
    assert np.max(np.abs(pt["mean"] - pj["mean"])) < 0.15 * scale
    tj, tt = (f.theta_summary()["theta(x)"] for f in (fj, ft))
    for key in ("mean", "sd", "median"):
        assert np.isclose(tt[key], tj[key], rtol=1e-4, atol=1e-6), key
    fxj, fxt = fj.fixed_effects_summary(), ft.fixed_effects_summary()
    assert fxt.keys() == fxj.keys()
    for name in fxj:
        sd = fxj[name]["sd"]
        assert abs(fxt[name]["Mean"] - fxj[name]["Mean"]) < 0.15 * sd + 1e-3
    assert "posterior mode" in ft.summary()


def test_unported_routes_raise():
    data = _data(n=200)
    # the dense route is ported: engine="dense" fits on it
    fit = tbg.model_fit(FORMULA, data=data, family="Poisson",
                        engine="dense", M=200, device="cpu")
    assert type(fit.mod.backend).__name__ == "DenseBackend"
    assert np.isfinite(fit.mod.lognormconst)
    assert fit.samps.shape == (fit.md.w_count, 200)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tbg.model_fit(FORMULA, data=data, family="Poisson", method="MCMC",
                      device="cpu")
    # an IWP smooth plus 600 scattered levels: 'auto' takes the multi-term
    # banded engine, whose merge refuses scattered levels, and densifies
    # them into its tail (as the JAX package does; a build, no fit); an
    # sGP driver is the next route to port; the Gaussian family's third
    # theta is not on scatter_iid
    n = 1200
    big = dict(_data(n=n), g=np.arange(n) % 600.0)
    iid = "y ~ f(x, model='IWP', order=3, k=20) + f(g, model='IID')"
    with pytest.warns(UserWarning, match="densifying"):
        be = tapi._backend(tapi.assemble_model(iid, data=big,
                                               family="Poisson"),
                           "auto", torch.device("cpu"))
    assert [t.size for t in be.tail_terms] == [600]
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tbg.model_fit("y ~ f(x, model='sGP', period=50.0, k=10)", data=big,
                      family="Poisson", engine="banded", device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tbg.model_fit(iid, data=big, family="Gaussian",
                      engine="scatter_iid", device="cpu")
