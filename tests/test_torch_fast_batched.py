"""bayesgp_torch BatchedFastIWP (R replicate fits in lock step) against
the JAX package's BatchedFastIWP on its CPU engine and against the port's
own one-response backend, on one shared small problem per family (n = 160,
k = 10, R = 3), built by both packages from the same numpy data.

Tolerances: Laplace nll 1e-7 absolute, its theta gradient 1e-6, latent
states 1e-7 (both sides converge an f64 inner Newton to ~1e-9); against
the port's one-response backend the same bounds (measured ~1e-13: only
the order of the batched sums differs).

Where the prior pins the driver (theta_IWP = 30 and 40, n = 2000, k =
40) each replicate's half log-det equals the one-response backend's to
1e-6: both form the Schur tail as a Gram of residuals (ROADMAP Queue 3
#5; formed as Hd - Y^T Y the replicate engine was 3e-5 and 6e-5 off at
theta_IWP = 40).

Three tests, on purpose: pytest-xdist's file scheduler hands out files in
order of their test counts, and a file of few tests lands at the end of
the queue, where it cannot delay the long files of the JAX package.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from bayesgp_tpu import terms as jterms
from bayesgp_tpu.model import build as jbuild
from bayesgp_tpu.fast.iwp import build_fast_iwp as jbuild_fast_iwp
from bayesgp_tpu.fast.batched import build_batched as jbuild_batched
from bayesgp_torch import convert
from bayesgp_torch import terms as tterms
from bayesgp_torch.model import build as tbuild
from bayesgp_torch.fast.iwp import build_fast_iwp
from bayesgp_torch.fast.batched import build_batched, max_replicates

from _jax_quick import quick_jit

torch.set_num_threads(1)

N, K, R = 160, 10, 3
THETA = np.array([-0.5, 0.5, 1.5])


def replicate_problem(family, n=N, k=K, R=R, seed=9, order=3):
    """The same single-IWP model in both packages and (R, n) raw-order
    replicate responses: (JAX backend, port backend on the CPU, ys)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 6.0, n))
    f_true = 0.8 * np.sin(x) + (1.0 if family == "Poisson" else 0.0)
    z = rng.normal(size=(n, 1))
    kw, size = {}, None
    if family == "Poisson":
        draw = lambda: rng.poisson(np.exp(f_true)).astype(np.float64)
    else:
        size = np.full(n, 4.0)
        kw = dict(size=size)
        pr = 1.0 / (1.0 + np.exp(-f_true))
        draw = lambda: rng.binomial(4, pr).astype(np.float64)
    y0 = draw()
    ys = np.stack([draw() for _ in range(R)])
    backends = []
    for terms, build, make, extra in (
            (jterms, jbuild, jbuild_fast_iwp, {}),
            (tterms, tbuild, build_fast_iwp, {"device": "cpu"})):
        inst = terms.build_iwp_term("x", x, order=order, k=k)
        dmf = [np.ones((n, 1)), z]
        md = build.build_model_data([inst], dmf, y0, family, **kw)
        xf = np.concatenate([inst.X] + dmf, axis=1)
        pt = np.full(xf.shape[1], 0.01)
        backends.append(make(inst, md, xf, pt, np.zeros_like(pt),
                             inst.x_data, **extra))
    return backends[0], backends[1], ys


FAMILIES = ("Poisson", "Binomial")


@functools.lru_cache(maxsize=None)
def _pair(family):
    """Both packages' batched backends on one problem, each evaluated
    once at THETA from a cold start."""
    jbase, tbase, ys = replicate_problem(family)
    jb = jbuild_batched(jbase, ys, force_engine="block_vmap")
    tb = build_batched(tbase, ys)

    def sum_nll(th, st):
        f, st2 = jb.nll_warm(th, st)
        return jnp.sum(f), (f, st2)

    jvg = quick_jit(jax.value_and_grad(sum_nll, has_aux=True))
    (_, (fj, stj)), gj = jvg(jnp.asarray(THETA), jb.init_state())
    ft, gt, stt = tb.value_and_grad(torch.tensor(THETA), tb.init_state())
    return dict(tbase=tbase, ys=ys, jb=jb, tb=tb, jvg=jvg,
                jax=(np.asarray(fj), np.asarray(gj),
                     [np.asarray(a) for a in stj]),
                port=(ft.numpy(), gt.numpy(), [a.numpy() for a in stt]))


def test_nll_gradient_and_states_match_jax():
    for family in FAMILIES:
        pair = _pair(family)
        _check_nll_gradient_and_states_match_jax(pair)
        _check_warm_start_from_converted_jax_state(pair)


def test_each_replicate_matches_one_response_backend():
    for family in FAMILIES:
        pair = _pair(family)
        _check_each_replicate_matches_one_response_backend(pair)
        _check_laplace_eval_full_and_solve_per_replicate(pair)
    _check_schur_tail_where_the_prior_pins_the_driver()


def _check_nll_gradient_and_states_match_jax(pair):
    (fj, gj, stj), (ft, gt, stt) = pair["jax"], pair["port"]
    assert ft.shape == (R,) and gt.shape == (R,)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-7)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-6)
    for a, b in zip(stt, stj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


def _check_each_replicate_matches_one_response_backend(pair):
    tbase, ys = pair["tbase"], pair["ys"]
    ft, gt, (V, tail) = pair["port"]
    for r in range(R):
        br = tbase.with_y(ys[r])
        v, g, (Vr, tr) = br.value_and_grad(
            torch.tensor(THETA[r:r + 1]), br.init_state())
        assert abs(float(v) - ft[r]) < 1e-7
        assert abs(float(g[0]) - gt[r]) < 1e-6
        np.testing.assert_allclose(V[r], Vr.numpy(), rtol=0, atol=1e-7)
        np.testing.assert_allclose(tail[r], tr.numpy(), rtol=0, atol=1e-7)


def _check_warm_start_from_converted_jax_state(pair):
    """A JAX batched latent state, carried over as numpy, warm-starts the
    port at the same point: both give the same values at a nearby theta."""
    jb, tb = pair["jb"], pair["tb"]
    stj = pair["jax"][2]
    th2 = THETA + 0.1
    (_, (fj, _)), gj = pair["jvg"](jnp.asarray(th2),
                                   tuple(jnp.asarray(a) for a in stj))
    warm = convert.latent_state(*stj, device="cpu")
    ft, gt, _ = tb.value_and_grad(torch.tensor(th2), warm)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-7)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-6)


def _check_laplace_eval_full_and_solve_per_replicate(pair):
    tbase, ys, tb = pair["tbase"], pair["ys"], pair["tb"]
    theta = torch.tensor([0.2, 0.2, 0.2], dtype=torch.float64)
    val, (V, tail), factor = tb.laplace_eval_full(theta, tb.init_state())
    assert len(set(np.round(val.numpy(), 6))) == R
    rng = np.random.default_rng(2)
    gV = torch.tensor(rng.normal(size=tuple(V.shape)))
    gt = torch.tensor(rng.normal(size=tuple(tail.shape)))
    zb, zd = tb.solve_H(factor, gV, gt)
    hld = tb.half_logdet_H(factor)
    for r in range(R):
        br = tbase.with_y(ys[r])
        fr = br.hessian_factor(V[r], tail[r], theta[r:r + 1])
        zbr, zdr = br.solve_H(fr, gV[r], gt[r])
        np.testing.assert_allclose(zb[r].numpy(), zbr.numpy(), rtol=1e-9,
                                   atol=1e-10)
        np.testing.assert_allclose(zd[r].numpy(), zdr.numpy(), rtol=1e-9,
                                   atol=1e-10)
        assert abs(float(hld[r]) - float(br.half_logdet_H(fr))) < 1e-9


def _check_schur_tail_where_the_prior_pins_the_driver(n=2000, k=40):
    """Replicate half log-dets at theta_IWP = 30 and 40, each at its own
    one-response mode, against the one-response backend's."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 365.0, n))
    ys = rng.poisson(np.exp(1.5 + 0.8 * np.sin(2 * np.pi * x / 90.0)),
                     size=(2, n)).astype(np.float64)
    inst = tterms.build_iwp_term("x", x, order=3, k=k)
    dmf = [np.ones((n, 1)), rng.normal(size=(n, 1))]
    md = tbuild.build_model_data([inst], dmf, ys[0], "Poisson",
                                 dense_design=False)
    xf = np.concatenate([inst.X] + dmf, axis=1)
    pt = np.full(xf.shape[1], 0.01)
    base = build_fast_iwp(inst, md, xf, pt, np.zeros_like(pt), inst.x_data,
                          device="cpu")
    tb = build_batched(base, ys)
    for t_iwp in (30.0, 40.0):
        one, states = [], []
        for r in range(2):
            br = base.with_y(ys[r])
            th = torch.tensor([t_iwp])
            st = br.laplace_nll(th)[1]
            one.append(float(br.half_logdet_H(br.hessian_factor(*st, th))))
            states.append(st)
        V, tail = (torch.stack(a) for a in zip(*states))
        f = tb.hessian_factor(V, tail, torch.tensor([t_iwp, t_iwp]))
        assert not bool(f[0].tail_left.any())
        np.testing.assert_allclose(tb.half_logdet_H(f).numpy(), one,
                                   rtol=0, atol=1e-6)


def test_max_replicates_is_a_memory_cap():
    assert max_replicates(3, 100_000, 4) >= 64
    assert max_replicates(3, 100_000, 4) > max_replicates(3, 1_000_000, 4)
    assert max_replicates(3, 10 ** 12, 4) == 1
