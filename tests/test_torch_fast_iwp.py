"""bayesgp_torch FastIWPBackend against the JAX package's FastIWPBackend
on the same small Poisson IWP model (p=3, k=12, n=120), built by both
packages from the same numpy data.

Tolerances: build arrays rtol 1e-12 (same host numpy arithmetic);
objective rtol 1e-10; Laplace nll rtol 1e-9 and its theta-gradient
rtol 1e-7 (both sides converge an f64 inner Newton to ~1e-9). The JAX
functions are jitted with _jax_quick.quick_jit.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from bayesgp_tpu import terms as jterms
from bayesgp_tpu.model import build as jbuild
from bayesgp_tpu.fast.iwp import build_fast_iwp as jbuild_fast_iwp
from bayesgp_torch import convert
from bayesgp_torch import terms as tterms
from bayesgp_torch.model import build as tbuild
from bayesgp_torch.fast.iwp import build_fast_iwp

from _jax_quick import quick_jit

torch.set_num_threads(1)

THETAS = (0.0, 0.5, -0.7)


def _problem(pkg_terms, pkg_build, make_backend, n=120, k=12, p=3, seed=3,
             **kw):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 6.0, n))
    y = rng.poisson(np.exp(0.4 * np.sin(x) + 0.8)).astype(float)
    z = rng.normal(0, 1, (n, 1))
    inst = pkg_terms.build_iwp_term("x", x, order=p, k=k)
    dmf = [np.ones((n, 1)), z]
    md = pkg_build.build_model_data([inst], dmf, y, "Poisson")
    xf = np.concatenate([inst.X] + dmf, axis=1)
    q_prior = np.full(xf.shape[1], 0.01)
    return make_backend(inst, md, xf, q_prior, np.zeros_like(q_prior),
                   inst.x_data, **kw)


@pytest.fixture(scope="module")
def pair():
    jbe = _problem(jterms, jbuild, jbuild_fast_iwp)
    tbe = _problem(tterms, tbuild, build_fast_iwp, device="cpu")
    return jbe, tbe


def _jax_arrays(be):
    """The JAX backend's arrays in convert's dict format."""
    out = {f: np.asarray(getattr(be, f)) for f in convert.ARRAY_FIELDS
           if f != "prior_w"}
    out["prior_w"] = convert.driver_prior_w(be)  # the JAX package has none
    out.update({f: np.asarray(getattr(be.md, f))
                for f in convert.MODEL_FIELDS})
    out.update(p=be.p, d=be.d, dpad=be.dpad, family=be.md.family,
               logdetT=be.logdetT, row_order=be.row_order)
    return out


def test_build_arrays_match(pair):
    jbe, tbe = pair
    ja, ta = _jax_arrays(jbe), convert.fast_iwp_arrays(tbe)
    assert (ja["p"], ja["d"], ja["dpad"]) == (ta["p"], ta["d"], ta["dpad"])
    np.testing.assert_array_equal(ja["row_order"], ta["row_order"])
    assert abs(ja["logdetT"] - ta["logdetT"]) <= 1e-12 * abs(ja["logdetT"])
    # relative to each array's scale: the tail orthogonalization leaves
    # entries that cancel to ~1e-4 of their neighbours
    for f in convert.ARRAY_FIELDS + convert.MODEL_FIELDS:
        scale = max(np.abs(np.asarray(ja[f], np.float64)).max(initial=0), 1)
        np.testing.assert_allclose(ta[f], ja[f], rtol=1e-12,
                                   atol=1e-12 * scale, err_msg=f)


def test_neg_log_post_matches(pair):
    jbe, tbe = pair
    jax_point = quick_jit(lambda V, t, th: (jbe.neg_log_post(V, t, th),
                                            jbe.grad_W(V, t, th)))
    rng = np.random.default_rng(1)
    for _ in range(3):
        Vp = np.zeros(jbe.dpad)
        Vp[:jbe.d] = rng.normal(0, 0.3, jbe.d)
        tail = rng.normal(0, 0.2, jbe.q)
        theta = rng.normal(0, 0.3, 1)
        fj, gj = jax_point(Vp, tail, theta)
        fj = float(fj)
        ft = float(tbe.neg_log_post(torch.tensor(Vp), torch.tensor(tail),
                                    torch.tensor(theta)))
        assert np.isclose(ft, fj, rtol=1e-10), (ft, fj)
        gt = tbe.grad_W(torch.tensor(Vp), torch.tensor(tail),
                        torch.tensor(theta))
        for a, b in zip(gt, gj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-10, atol=1e-10)
    # the prior quadratic as the sum of squares sum w (T V)^2: the
    # backend's weights are diff(knots), and the form agrees with
    # V^T P_V V from the JAX package's band at the tolerance above
    w = np.diff(np.asarray(tbe.term.knots, np.float64))
    np.testing.assert_allclose(tbe.prior_w.numpy(), w, rtol=1e-13)
    Pb, d = np.asarray(jbe.P_band, np.float64), jbe.d
    PV = np.diag(Pb[0])
    for o in range(1, Pb.shape[0]):
        PV += np.diag(Pb[o, :d - o], -o) + np.diag(Pb[o, :d - o], o)
    V = rng.normal(0, 0.3, d)
    np.testing.assert_allclose(float(tbe.prior_quad(torch.tensor(V))),
                               V @ PV @ V, rtol=1e-10)
    np.testing.assert_allclose(tbe.prior_grad(torch.tensor(V)).numpy(),
                               PV @ V, rtol=1e-10, atol=1e-10)


def test_laplace_nll_and_gradient_match(pair):
    jbe, tbe = pair
    vg = jbe.val_grad_fn()
    for th in THETAS:
        vj, gj = vg(jnp.asarray([th]))
        vt, gt, _ = tbe.value_and_grad(torch.tensor([th], dtype=torch.float64),
                                       tbe.init_state())
        assert np.isclose(float(vt), float(vj), rtol=1e-9), (th, vt, vj)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-7,
                                   atol=1e-9)


def test_convert_backend_gives_same_nll(pair):
    """A port backend built from the JAX backend's numpy arrays gives
    the same Laplace nll, and a converted JAX latent state warm-starts
    it at the same value."""
    jbe, tbe = pair
    cbe = convert.fast_iwp_from_arrays(_jax_arrays(jbe), term=tbe.term,
                                       device="cpu")
    nll = quick_jit(jbe.laplace_nll)
    for th in THETAS:
        vj, (Vj, tj) = nll(np.asarray([th]))
        vc, _ = cbe.laplace_nll(torch.tensor([th], dtype=torch.float64))
        vt, _ = tbe.laplace_nll(torch.tensor([th], dtype=torch.float64))
        assert np.isclose(float(vc), float(vj), rtol=1e-9)
        assert np.isclose(float(vc), float(vt), rtol=1e-12)
        warm = convert.latent_state(np.asarray(Vj), np.asarray(tj), "cpu")
        vw, _ = cbe.laplace_nll(torch.tensor([th], dtype=torch.float64), warm)
        assert np.isclose(float(vw), float(vj), rtol=1e-9)


def test_sample_moments_match_dense(pair):
    """Draws at one node have the conditional covariance H^{-1} of the
    dense Laplace approximation in reference coordinates."""
    jbe, tbe = pair
    theta = torch.tensor([0.2], dtype=torch.float64)
    _, (V, tail), factor = tbe.laplace_eval_full(theta, tbe.init_state())
    M = 4000
    gen = torch.Generator().manual_seed(0)
    zb = torch.randn((tbe.dpad, M), dtype=torch.float64, generator=gen)
    zd = torch.randn((tbe.q, M), dtype=torch.float64, generator=gen)
    samps = tbe.sample([(V, tail, factor)],
                       torch.zeros(M, dtype=torch.long), zb, zd).numpy()
    # dense precision of (V', t) through the solves, mapped to U = T V
    Hinv = np.stack([np.concatenate(
        tbe.solve_H(factor, *torch.split(torch.eye(tbe.dpad + tbe.q)[i],
                                         [tbe.dpad, tbe.q])))
        for i in range(tbe.dpad + tbe.q)])
    J = np.zeros((tbe.d + tbe.q, tbe.dpad + tbe.q))
    T = np.zeros((tbe.d, tbe.d))
    Td = tbe.Tdiags.numpy()
    for o in range(tbe.p + 1):
        T[np.arange(o, tbe.d), np.arange(tbe.d - o)] = Td[o, o:]
    J[:tbe.d, :tbe.d] = T
    J[:tbe.d, tbe.dpad:] = -T @ tbe.Z0.numpy()
    J[tbe.d:, tbe.dpad:] = np.eye(tbe.q)
    cov = J @ Hinv @ J.T
    emp = np.cov(samps)
    scale = np.sqrt(np.outer(np.diag(cov), np.diag(cov)))
    assert np.max(np.abs(emp - cov) / scale) < 0.1
