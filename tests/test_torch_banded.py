"""bayesgp_torch's multi-term banded engine (fast/banded.py) and its band
engine at the chunked kernels' shapes, against the JAX package on the
CPU in f64.

1. The plain K1-K5 through BandArrowEngine against the JAX package's
   chunked engine in interpret mode (the chunked kernels K1c-K5c), at
   tests/test_band_kernels.py's chunked shape (d = 90, bw = 40, chunk 48,
   q = 5) and at a q = 140 tail on a narrow band; a q = 300 tail, which
   takes the blocked dense route (K6/K7), against dense numpy.
   Tolerances: factor, half-log-det and solves 1e-10 (solutions and
   draws relative to their largest entry); draws and the half-log-det
   gradient against the JAX engine 1e-5 (K5 and K4 compute in f32 on the
   TPU; the port's are held to dense f64 at 1e-10 / 1e-9). The
   sick-factor gate on a system with healthy band pivots and a tail
   Schur complement s0: at s0 = 1e-14 (|H^{-1}| past 1e12) every
   cotangent is zero; at s0 = 1e-6 the gate is the identity (the
   cotangents equal the ungated ones bit for bit, Hd's is 0.5 / s0 to
   1e-6).
2. The merged problem of tests/test_iid_band.py (n = 600, IWP2 k = 12, 30
   x-clustered levels, a lazy IID term merged into the band): the build
   arrays equal the JAX package's to 1e-12 of each array's scale; at a
   fixed (theta, V, tail) neg_log_post, grad_W, the Newton step and the
   warm Laplace nll to rtol 1e-9, the theta gradient to rtol 1e-8 (the
   prior's V'PV, a sum of large terms that cancel, rounds in each
   package's own order: ROADMAP Queue 3, as for the scattered-IID
   engine); the convert pair gives the same backend.
3. The port's s = 2 AGHQ fit (k = 3) of that problem, held to the JAX
   package without a JAX fit: the JAX package's Laplace value and its
   gradient at the port's mode (value rtol 1e-9, |gradient| < 1e-4), its
   nll at every port node (rtol 1e-9), the mode and lognormconst within
   1e-5 of the JAX package's host-path constants, reproduced by

       dataclasses.replace(_problem()[...] IID term, B=None, P=None);
       build_banded_backend([iwp_lazy, iid_lazy], md_lazy, dmf,
                            np.full(1, 0.01), np.zeros(1));
       aghq.aghq_fit(be, k=3)        (bayesgp_tpu, CPU, x64)

   -> mode (0.96162838, 2.72002588), lognormconst -1093.3009974334; draw
   means within 5 Monte-Carlo standard errors of the conditional mode in
   reference order. Then a tail-term model built through model_fit's
   route (IWP k = 15 + a 5-level IID term, n = 200, engine='banded'):
   Laplace nll and gradient at three thetas, rtol 1e-9. The gate is open
   at the fit's mode; with its threshold lowered the fit's warning fires.
   And the routes,
   each a build only: 'auto' merges > 512 clustered levels, densifies
   600 scattered levels into the tail with a warning, and an sGP driver
   and the Gaussian family raise naming their ROADMAP item.

Every JAX program is traced once in the module fixture and compiled with
XLA's CPU optimizations off (_jax_quick.XLA_QUICK), on threads beside the
rest of the module:
each runs a few times, and compiling them is most of the module's
time.
"""
import concurrent.futures
import dataclasses
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayesgp_tpu import api as japi
from bayesgp_tpu import terms as JT
from bayesgp_tpu.fast.banded import build_banded_backend as jbuild
from bayesgp_tpu.linalg import band_arrow as jba
from bayesgp_tpu.model import build as JB
from bayesgp_torch import api as tapi
from bayesgp_torch import convert
from bayesgp_torch import terms as TT
from bayesgp_torch.fast import banded as tbanded
from bayesgp_torch.linalg import band_arrow as tba
from bayesgp_torch.linalg import band_kernels as tbk
from bayesgp_torch.model import build as TB

from _jax_quick import XLA_QUICK

torch.set_num_threads(1)

REF_MODE, REF_LNC = (0.96162838, 2.72002588), -1093.3009974334
M_DRAWS = 400
TAIL_FORMULA = "y ~ f(x, model='IWP', order=2, k=15) + f(g, model='IID')"


def _arrow_problem(rng, d, bw, q):
    """Equilibrated banded SPD block (as the JAX package's tests build
    it), coupling C, dense tail Hd and the full (d+q)^2 matrix."""
    L0 = 0.4 * np.tril(rng.normal(size=(d, d)), -1)
    L0 *= np.abs(np.arange(d)[:, None] - np.arange(d)[None, :]) <= bw
    np.fill_diagonal(L0, 1.5 + rng.uniform(0, 1, d))
    A = L0 @ L0.T
    s = 1.0 / np.sqrt(np.diag(A))
    A = A * s[:, None] * s[None, :]
    band = np.zeros((bw + 1, d))
    for o in range(bw + 1):
        band[o, :d - o] = np.diag(A, -o)
    C = 0.1 * rng.normal(size=(d, q))
    Hq = rng.normal(size=(q, q))
    Hd = Hq @ Hq.T + np.eye(q) + C.T @ np.linalg.solve(A, C)
    return band, C, Hd, np.block([[A, C], [C.T, Hd]])


def _merged_data(n=600, n_lev=30, seed=0):
    """tests/test_iid_band.py::_problem's data."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    g = np.floor(x * (n_lev / 10.0)).astype(float)
    u_true = 0.3 * rng.normal(size=int(g.max()) + 1)
    y = rng.poisson(np.exp(0.5 * np.sin(x) + u_true[g.astype(int)]
                           + 1.0)).astype(float)
    return {"x": x, "g": g, "y": y}


def _merged_terms(T, data):
    iwp = T.build_iwp_term("x", data["x"], order=2, k=12,
                           materialize_B=False)
    iid = dataclasses.replace(T.build_iid_term("g", data["g"]), B=None,
                              P=None)
    return [iwp, iid]


def _tail_data(n=200, seed=3):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    g = rng.integers(0, 5, n).astype(float)
    lin = 1.0 + 0.5 * np.sin(x) + 0.3 * rng.normal(size=5)[g.astype(int)]
    return {"x": x, "g": g, "y": rng.poisson(np.exp(lin)).astype(float)}


# test 1's systems (d, bw, q, chunk of the JAX engine)
ARROW_SHAPES = ((90, 40, 5, 48), (96, 5, 140, 32))
def _build(formula, data, family, engine="auto"):
    """The backend model_fit would fit, built on the CPU without a fit."""
    asm = tapi.assemble_model(formula, data=data, family=family,
                              engine=engine)
    return tapi._backend(asm, engine, torch.device("cpu"))


def _spec(*shapes):
    return [jax.ShapeDtypeStruct(s, jnp.float64) for s in shapes]


def _arrow_program(d, bw, q, chunk):
    """Everything test 1 reads from the JAX chunked engine, in one
    program: Y, the half-log-det and its gradient, a solve, draws."""
    eng = jba.PallasEngine(d, bw, q, interpret=True, chunk=chunk)

    def run(band, C, Hd, rb, rd, zbn, zdn):
        f = eng.factor(band, C, Hd)
        hld, grads = jax.value_and_grad(
            lambda *a: eng.arrow_half_logdet_given(*a, f),
            argnums=(0, 1, 2))(band, C, Hd)
        return (f.Y, hld, grads, eng.solve(f, rb, rd),
                eng.sample_multi(f, zbn, zdn)[0])
    return run, _spec((bw + 1, d), (d, q), (q, q), (d,), (q,), (d, 16),
                      (q, 16))


def _vg_program(jbe):
    """The JAX backend's Laplace nll and theta gradient, warm-started."""
    return (jax.value_and_grad(
        lambda th, V, t: jbe.laplace_nll(th, warm=(V, t))[0]),
        _spec((jbe.n_theta,), (jbe.dpad,), (jbe.q,)))


class _Compiled(dict):
    """name -> compiled program, each waited for at its first use."""

    def __getitem__(self, key):
        return super().__getitem__(key).result()


def _compile_all(programs):
    """{name: (fn, argument specs)} -> _Compiled: each program is traced
    in turn and compiled on a thread of its own (XLA compiles outside the
    GIL), beside the next tracing and the tests' own work."""
    pool = concurrent.futures.ThreadPoolExecutor(len(programs))
    out = _Compiled({k: pool.submit(jax.jit(fn).lower(*spec).compile,
                                    XLA_QUICK)
                     for k, (fn, spec) in programs.items()})
    pool.shutdown(wait=False)
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's backends of the merged and the tail-term model,
    and every JAX program the module runs, compiled once."""
    data = _merged_data()
    dmf = [np.ones((len(data["y"]), 1))]
    jterms = _merged_terms(JT, data)
    jmd = JB.build_model_data(jterms, dmf, data["y"], "Poisson",
                              dense_design=False)
    jbe = jbuild(jterms, jmd, dmf, np.full(1, 0.01), np.zeros(1))
    asm = japi.assemble_model(TAIL_FORMULA, data=_tail_data(),
                              family="Poisson", engine="banded")
    jte = jbuild(asm["instances"], asm["md"], asm["design_mat_fixed"],
                 asm["bf_prec"], asm["bf_mean"])
    programs = {shape: _arrow_program(*shape) for shape in ARROW_SHAPES}
    programs.update(
        vg=_vg_program(jbe), tail_vg=_vg_program(jte),
        point=(lambda V, t, th: (jbe.neg_log_post(V, t, th),
                                 jbe.grad_W(V, t, th),
                                 jbe.newton_step(V, t, th)),
               _spec((jbe.dpad,), (jbe.q,), (2,))))
    return jbe, jte, _compile_all(programs)


@pytest.fixture(scope="module")
def merged():
    """The port's backend of the merged problem and its AGHQ fit."""
    data = _merged_data()
    dmf = [np.ones((len(data["y"]), 1))]
    tterms = _merged_terms(TT, data)
    tmd = TB.build_model_data(tterms, dmf, data["y"], "Poisson",
                              dense_design=False)
    tbe = tbanded.build_banded_backend(tterms, tmd, dmf, np.full(1, 0.01),
                                       np.zeros(1), device="cpu")
    fit = tapi.model_fit(data=data, response="y",
                         terms=_merged_terms(TT, data), family="Poisson",
                         engine="banded", aghq_k=3, M=M_DRAWS, seed=0,
                         device="cpu")
    return tbe, fit


def test_engine_matches_jax_chunked_engine(jax_ref):
    programs = jax_ref[2]
    rng = np.random.default_rng(8)
    for d, bw, q, chunk in ARROW_SHAPES:
        band, C, Hd, Hfull = _arrow_problem(rng, d, bw, q)
        rb, rd = rng.normal(size=d), rng.normal(size=q)
        zbn, zdn = rng.normal(size=(d, 16)), rng.normal(size=(q, 16))
        Yp, hld_p, g_p, (zbp, zdp), xbp = programs[(d, bw, q, chunk)](
            band, C, Hd, rb, rd, zbn, zdn)

        eng = tba.BandArrowEngine(d, bw, q)
        targs = (torch.tensor(band.T.copy()), torch.tensor(C),
                 torch.tensor(Hd))
        f = eng.factor(*targs)
        hld = float(eng.half_logdet(f))
        assert abs(hld - 0.5 * np.linalg.slogdet(Hfull)[1]) < 1e-10
        assert abs(hld - float(hld_p)) < 1e-10
        np.testing.assert_allclose(f.Y.numpy(), np.asarray(Yp),
                                   rtol=1e-10, atol=1e-12)

        zb, zd = eng.solve(f, torch.tensor(rb), torch.tensor(rd))
        zref = np.linalg.solve(Hfull, np.concatenate([rb, rd]))
        tol = 1e-10 * np.abs(zref).max()
        for got, jx, ref in ((zb, zbp, zref[:d]), (zd, zdp, zref[d:])):
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                                       atol=tol)
            np.testing.assert_allclose(got.numpy(), np.asarray(jx),
                                       rtol=1e-10, atol=tol)

        xb, xd = eng.sample_multi(f, torch.tensor(zbn), torch.tensor(zdn))
        xref = np.linalg.solve(np.linalg.cholesky(Hfull).T,
                               np.concatenate([zbn, zdn]))
        np.testing.assert_allclose(np.concatenate([xb.numpy(), xd.numpy()]),
                                   xref, rtol=1e-10,
                                   atol=1e-10 * np.abs(xref).max())
        np.testing.assert_allclose(xb.numpy(), np.asarray(xbp), rtol=1e-5,
                                   atol=1e-5 * np.abs(xref).max())

        leaves = [t.clone().requires_grad_(True) for t in targs]
        g = torch.autograd.grad(eng.arrow_half_logdet(*leaves), leaves)
        Hinv = np.linalg.inv(Hfull)
        for gt, gp, ref in zip(g, g_p, (None, Hinv[:d, d:],
                                        0.5 * Hinv[d:, d:])):
            gp = np.asarray(gp)
            if gp.shape[0] == bw + 1:
                gp = gp.T                # the JAX band layout is (bw+1, d)
            np.testing.assert_allclose(gt.numpy(), gp, rtol=1e-5,
                                       atol=1e-5 * np.abs(gp).max())
            if ref is not None:
                np.testing.assert_allclose(gt.numpy(), ref, rtol=1e-9,
                                           atol=1e-12)

    # a tail of 300 columns factors on the blocked dense route
    d, bw, q = 96, 5, 300
    band, C, Hd, Hfull = _arrow_problem(rng, d, bw, q)
    eng = tba.BandArrowEngine(d, bw, q)
    assert eng.dense_tail
    f = eng.factor(torch.tensor(band.T.copy()), torch.tensor(C),
                   torch.tensor(Hd))
    assert abs(float(eng.half_logdet(f))
               - 0.5 * np.linalg.slogdet(Hfull)[1]) < 1e-9
    rb, rd = rng.normal(size=d), rng.normal(size=q)
    zb, zd = eng.solve(f, torch.tensor(rb), torch.tensor(rd))
    np.testing.assert_allclose(
        np.concatenate([zb.numpy(), zd.numpy()]),
        np.linalg.solve(Hfull, np.concatenate([rb, rd])), rtol=1e-9,
        atol=1e-11)
    # the sick-factor gate: a system with healthy band pivots whose tail
    # Schur complement s0 is tiny has |H^{-1}| ~ 1 / s0; at 1e12 and past
    # it the half-log-det's cotangents are dropped, below it the gate is
    # the identity
    d, bw = 40, 2
    band = np.zeros((d, bw + 1))
    band[:, 0], band[:-1, 1], band[:-2, 2] = 1.0, 0.2, 0.05
    Hb = sum(np.diag(band[:d - o, o], -o) for o in range(bw + 1))
    Hb = Hb + np.tril(Hb, -1).T
    C = 0.3 * rng.normal(size=(d, 1))
    eng = tba.BandArrowEngine(d, bw, 1)
    for s0, closed in ((1e-14, True), (1e-6, False)):
        Hd = C.T @ np.linalg.solve(Hb, C) + s0
        leaves = [torch.tensor(a).requires_grad_(True)
                  for a in (band, C, Hd)]
        f = eng.factor(*(x.detach() for x in leaves))
        assert float((f.rinv ** -2).min()) > 0.5     # healthy band pivots
        assert (float(eng.gate_peak(f)) >= tba.SICK_INV) == closed
        g = torch.autograd.grad(eng.arrow_half_logdet(*leaves), leaves)
        if closed:
            assert all(not x.any() for x in g)
        else:
            assert abs(float(g[2][0, 0]) * 2.0 * s0 - 1.0) < 1e-6
            saved = tba.SICK_INV
            tba.SICK_INV = float("inf")
            try:
                g_off = torch.autograd.grad(eng.arrow_half_logdet(*leaves),
                                            leaves)
            finally:
                tba.SICK_INV = saved
            assert all(torch.equal(a, b) for a, b in zip(g, g_off))

    # a band wider than the kernels take is refused in the wrapper
    with pytest.raises(ValueError, match="outside"):
        tbk.band_factor(torch.ones((8, tbk.BW_MAX + 2), dtype=torch.float64),
                        torch.zeros((8, 1), dtype=torch.float64))


def test_merged_build_and_fixed_point_match_jax(jax_ref, merged):
    jbe, _, fns = jax_ref
    tbe, _ = merged
    assert (tbe.d, tbe.dpad, tbe.Wl, tbe.q) == (44, 48, 12, 2)
    assert (tbe.G, tbe.d_drv, tbe.w_real) == (jbe.G, jbe.d_drv, jbe.w_real)
    ja, ta = convert.banded_arrays(jbe), convert.banded_arrays(tbe)
    for key in (convert.BANDED_FIELDS + convert.BANDED_OPTIONAL
                + convert.MODEL_FIELDS):
        a, b = np.asarray(ja[key], np.float64), np.asarray(ta[key])
        assert a.shape == b.shape, key
        assert (np.abs(a - b).max(initial=0.0)
                <= 1e-12 * np.abs(a).max(initial=1.0)), key
    (jbt,), (tbt,) = ja["band_terms"], ta["band_terms"]
    for key in ("mask", "Z0PZ0"):
        np.testing.assert_allclose(tbt[key], jbt[key], rtol=0, atol=1e-12
                                   * max(np.abs(jbt[key]).max(), 1.0))
    for key in ("theta_idx", "d_size", "logPdet"):
        assert tbt[key] == jbt[key]
    for key in convert.BANDED_SCALARS:
        assert np.isclose(ta[key], ja[key], rtol=1e-12), key
    # iid_cols and pad_cols, as the masks of the level and padded slots
    assert int(tbt["mask"].sum()) == 30
    assert int(ta["prior_diag_band"].sum()) == tbe.d - tbe.d_drv - 30

    rng = np.random.default_rng(1)
    V = 0.1 * rng.normal(size=tbe.dpad)
    t = 0.1 * rng.normal(size=tbe.q)
    th = np.array([0.7, -0.5])
    jv, (jgV, jgt), (jnV, jnt, _) = fns["point"](
        np.asarray(V), np.asarray(t), np.asarray(th))
    Vt, tt, tht = torch.tensor(V), torch.tensor(t), torch.tensor(th)
    np.testing.assert_allclose(float(tbe.neg_log_post(Vt, tt, tht)),
                               float(jv), rtol=1e-9)
    gV, gt = tbe.grad_W(Vt, tt, tht)
    nV, nt, _ = tbe.newton_step(Vt, tt, tht)
    for got, want in ((gV, jgV), (gt, jgt), (nV, jnV), (nt, jnt)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())

    # warm Laplace nll and theta gradient at a point off the mode
    th = np.array([0.3, -0.2])
    val, g, (Vs, ts) = tbe.value_and_grad(th, (nV, nt))
    jval, jg = fns["vg"](np.asarray(th), np.asarray(nV.numpy()),
                         np.asarray(nt.numpy()))
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8)
    # the convert pair carries the JAX backend into the port unchanged
    tbe2 = convert.banded_from_arrays(ja, device="cpu")
    val2 = tbe2.laplace_nll(torch.tensor(th), (nV, nt))[0]
    np.testing.assert_allclose(float(val2), float(jval), rtol=1e-9)


def test_fit_tail_terms_and_routes(jax_ref, merged, monkeypatch):
    _, jte, fns = jax_ref
    _, fit = merged
    mod = fit.mod
    be = mod.backend
    assert isinstance(be, tbanded.BandedBackend) and be.band_terms
    np.testing.assert_allclose(mod.mode, REF_MODE, rtol=0, atol=1e-5)
    assert abs(mod.lognormconst - REF_LNC) < 1e-5

    # the JAX package's Laplace value and gradient at the port's mode
    z = np.zeros
    val, _, _ = be.value_and_grad(mod.mode, be.init_state())
    jval, jg = fns["vg"](np.asarray(mod.mode), z(be.dpad), z(be.q))
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-9)
    assert np.abs(np.asarray(jg)).max() < 1e-4
    # its nll at every node of the port's rule, warm from the node's state
    for th, nll, (V, t, _) in zip(mod.nodes, mod.lognll, mod.states):
        jn, _ = fns["vg"](np.asarray(th), np.asarray(V.numpy()),
                          np.asarray(t.numpy()))
        np.testing.assert_allclose(nll, float(jn), rtol=1e-9)

    # draws in reference order around the conditional modes
    assert fit.samps.shape == (11 + 30 + 1 + 1, M_DRAWS)
    p = np.exp(mod.logpost_nodes + mod.logw)
    zero_b, zero_t = torch.zeros((be.dpad, 1)), torch.zeros((be.q, 1))
    modes = np.stack([
        be.sample(mod.states, torch.tensor([j]), zero_b, zero_t)[:, 0].numpy()
        for j in range(len(p))])
    cond = (p / p.sum()) @ modes
    se = fit.samps.std(axis=1) / np.sqrt(M_DRAWS)
    assert np.all(np.abs(fit.samps.mean(axis=1) - cond) <= 5 * se + 1e-12)
    pred = fit.predict("x")
    assert np.all(np.isfinite(pred["mean"]))
    assert "theta(g)" in fit.summary()
    # the gate is open at this mode, and a fit warns where it is closed
    assert not be.gate_closed(mod.mode, mod.mode_state)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tapi._warn_sick_gate(be, mod)
    monkeypatch.setattr(tba, "SICK_INV", 1.0)
    assert be.gate_closed(mod.mode, mod.mode_state)
    with pytest.warns(RuntimeWarning, match="sick-factor gate"):
        tapi._warn_sick_gate(be, mod)
    monkeypatch.undo()

    # a tail-term model on model_fit's route: the IID term in the tail
    data = _tail_data()
    tte = _build(TAIL_FORMULA, data, "Poisson", engine="banded")
    assert [tb.size for tb in tte.tail_terms] == [5] and tte.q == 7
    assert (tte.dpad, tte.q) == (jte.dpad, jte.q)
    for th in ([0.0, 0.0], [1.0, -0.5], [-0.5, 1.5]):
        val, g, _ = tte.value_and_grad(np.asarray(th), tte.init_state())
        jval, jg = fns["tail_vg"](np.asarray(th), z(tte.dpad), z(tte.q))
        np.testing.assert_allclose(float(val), float(jval), rtol=1e-9)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-9,
                                   atol=1e-9)

    # routes, a build each: many clustered levels merge into the band,
    # scattered ones densify into the tail, an sGP driver is not ported
    n = 1200
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    base = dict(x=x, y=rng.poisson(3.0, n).astype(float))
    fml = "y ~ f(x, model='IWP', order=2, k=20) + f(g, model='IID')"
    g = np.floor(x * 60.0)
    clustered = _build(fml, dict(base, g=g), "Poisson")
    assert len(np.unique(g)) > 512
    assert clustered.band_terms[0].d_size == len(np.unique(g))
    with pytest.warns(UserWarning, match="densifying"):
        scattered = _build(fml, dict(base, g=np.arange(n) % 600.0),
                           "Poisson")
    assert not scattered.band_terms and scattered.engine.dense_tail
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        _build(fml, dict(base, g=g), "Gaussian")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        _build("y ~ f(x, model='sGP', period=2.0, k=10) + f(g, model='IID')",
               dict(base, g=g), "Poisson", engine="banded")
