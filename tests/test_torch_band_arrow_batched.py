"""bayesgp_torch BandArrowBatchedEngine (NR band + dense-tail systems
factored together) on the CPU against dense numpy, against the port's
one-system BandArrowEngine, and against the JAX package's CPU route for
the replicate engine (fast/batched.BlockVmapEngine), on the same numpy
arrowhead systems.

The engine's differentiable half log-det is schur_half_logdet, which
takes the Schur tails' derivative through a tail S the caller forms. Here
S = Hd - C^T Hb^{-1} C is formed densely and differentiably in (bands, C,
Hd), and the tail the factor takes is Hd - Y^T Y from the engine's own Y,
so the chain rule through S turns schur_backward's cotangents into the
arrowhead's (bands, C, Hd) cotangents, which the references give.

Tolerances: half log-det and solves 1e-9 against dense numpy, and
schur_backward's own (band, S) cotangents 1e-9 against the dense inverses;
the three cotangents of the half log-det 1e-10 against the one-system
engine per system (same kernels' plain versions; the small Schur products
are batched there and round differently) and 1e-6 against the JAX block
engine's f64 autodiff. The sick-factor gate per system: in a batch of a
healthy system, one with a clamped band pivot and one with healthy pivots
and max|H^{-1}| past 1e12, only the clamped one loses its cotangents, and
each system's agree with the one-system engine's (the large one's to
cond(H) eps of the largest).

Three tests, on purpose: pytest-xdist's file scheduler hands out files in
order of their test counts, and a file of few tests lands at the end of
the queue, where it cannot delay the long files of the JAX package.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayesgp_tpu.fast.batched import BlockVmapEngine
from bayesgp_torch.linalg.band_arrow import BandArrowEngine
from bayesgp_torch.linalg.band_arrow_batched import BandArrowBatchedEngine

from test_torch_band_arrow import _arrow_problem

from _jax_quick import quick_jit

torch.set_num_threads(1)

D, BW, Q, NR, S = 48, 3, 5, 4, 8


def _schur_from_Y(C, Hd):
    """The factor's tails, Hd - Y^T Y from the engine's Y = L^{-1} C."""
    def schur(L, rinv, Y):
        return Hd.detach() - Y.mT @ Y
    return schur


def _dense_band(bands):
    """(NR, d, d) symmetric matrices of (NR, d, bw+1) lower bands, each
    off-diagonal band entry feeding both of its places."""
    d = bands.shape[1]
    H = torch.diag_embed(bands[:, :, 0])
    for o in range(1, bands.shape[2]):
        low = torch.diag_embed(bands[:, :d - o, o], offset=-o)
        H = H + low + low.mT
    return H


def _half_logdet(eng, bands, C, Hd):
    """Differentiable (NR,) arrowhead half log-dets: schur_half_logdet
    with S = Hd - C^T Hb^{-1} C formed densely in (bands, C, Hd)."""
    f = eng.factor(bands, C, _schur_from_Y(C, Hd))
    if eng.q:
        S = Hd - C.mT @ torch.linalg.solve(_dense_band(bands), C)
    else:
        S = Hd
    return eng.schur_half_logdet(bands, S, f)


@pytest.fixture(scope="module")
def systems():
    rng = np.random.default_rng(3)
    probs = [_arrow_problem(rng, D, BW, Q) for _ in range(NR)]
    bands = np.stack([p[0] for p in probs])             # (NR, bw+1, d)
    Cs = np.stack([p[1] for p in probs])
    Hds = np.stack([p[2] for p in probs])
    Hfull = [p[3] for p in probs]
    targs = (torch.tensor(bands.transpose(0, 2, 1).copy()),
             torch.tensor(Cs), torch.tensor(Hds))
    eng = BandArrowBatchedEngine(D, BW, Q, NR)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    # random cotangents: system r's gradient must scale with ct[r] alone
    ct = torch.tensor(rng.normal(size=NR))
    grads = torch.autograd.grad((ct * _half_logdet(eng, *leaves)).sum(),
                                leaves)
    return dict(bands=bands, Cs=Cs, Hds=Hds, Hfull=Hfull, targs=targs,
                eng=eng, ct=ct, grads=grads, rng=rng)


def test_half_logdet_and_solve_against_dense(systems):
    s = systems
    eng, rng = s["eng"], s["rng"]
    f = eng.factor(s["targs"][0], s["targs"][1],
                   _schur_from_Y(*s["targs"][1:]))
    hld = eng.half_logdet(f).numpy()
    rb, rd = rng.normal(size=(NR, D)), rng.normal(size=(NR, Q))
    zb, zd = eng.solve(f, torch.tensor(rb), torch.tensor(rd))
    assert zb.shape == (NR, D) and zd.shape == (NR, Q)
    for r in range(NR):
        assert abs(hld[r] - 0.5 * np.linalg.slogdet(s["Hfull"][r])[1]) < 1e-9
        zr = np.linalg.solve(s["Hfull"][r], np.concatenate([rb[r], rd[r]]))
        np.testing.assert_allclose(zb[r].numpy(), zr[:D], atol=1e-9)
        np.testing.assert_allclose(zd[r].numpy(), zr[D:], atol=1e-9)
    _check_schur_backward_against_dense(s, f)
    _check_no_tail()


def test_cotangents_match_one_system_engine(systems):
    s = systems
    one = BandArrowEngine(D, BW, Q)
    for r in range(NR):
        leaves = [t[r].clone().requires_grad_(True) for t in s["targs"]]
        g1 = torch.autograd.grad(one.arrow_half_logdet(*leaves), leaves)
        for gb, g in zip(s["grads"], g1):
            np.testing.assert_allclose(gb[r].numpy(),
                                       (s["ct"][r] * g).numpy(),
                                       rtol=0, atol=1e-10)
    _check_gate_per_system()


def test_cotangents_match_jax_block_vmap_engine(systems):
    s = systems
    jeng = BlockVmapEngine(D, BW, Q, S)
    ct = jnp.asarray(s["ct"].numpy())
    jargs = (jnp.asarray(s["bands"]), jnp.asarray(s["Cs"]),
             jnp.asarray(s["Hds"]))
    val, gj = quick_jit(jax.value_and_grad(
        lambda *a: jnp.sum(ct * jeng.arrow_half_logdet(*a)),
        argnums=(0, 1, 2)))(*jargs)
    hld = _half_logdet(s["eng"], *s["targs"])
    assert abs(float((s["ct"] * hld).sum()) - float(val)) < 1e-9
    gband = np.asarray(gj[0]).transpose(0, 2, 1)    # JAX bands: (NR, bw+1, d)
    for gt, gb in zip(s["grads"], (gband, gj[1], gj[2])):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gb), rtol=0,
                                   atol=1e-6)


def _check_schur_backward_against_dense(s, f):
    """schur_backward's own cotangents: ct (0.5 on the diagonal, 1 off it)
    times the band of Hb^{-1}, and 0.5 ct S^{-1}, with the tails S the
    factor took."""
    eng, ct = s["eng"], s["ct"]
    g_band, g_S = eng.schur_backward(f, ct)
    for r in range(NR):
        Hb = s["Hfull"][r][:D, :D]
        Hinv = np.linalg.inv(Hb)
        for o in range(BW + 1):
            w = 0.5 if o == 0 else 1.0
            np.testing.assert_allclose(g_band[r, :D - o, o].numpy(),
                                       float(ct[r]) * w * np.diag(Hinv, -o),
                                       rtol=0, atol=1e-9)
        Sr = s["Hds"][r] - s["Cs"][r].T @ np.linalg.solve(Hb, s["Cs"][r])
        np.testing.assert_allclose(g_S[r].numpy(),
                                   0.5 * float(ct[r]) * np.linalg.inv(Sr),
                                   rtol=0, atol=1e-9)


def _check_gate_per_system():
    rng = np.random.default_rng(6)
    d, bw = 40, 2
    band, C, Hd, Hfull = _arrow_problem(rng, d, bw, 1)
    band = band.T.copy()
    sick = band.copy()
    sick[10, 0] = -0.8
    # healthy pivots, tail Schur complement 5e-13: max|H^{-1}| ~ 2e12
    big_Hd = C.T @ np.linalg.solve(Hfull[:d, :d], C) + 5e-13
    big_full = np.block([[Hfull[:d, :d], C], [C.T, big_Hd]])
    assert np.abs(np.linalg.inv(big_full)).max() >= 1e12
    parts = [(band, C, Hd), (sick, C, Hd), (band, C, big_Hd)]
    targs = [torch.tensor(np.stack(a)) for a in zip(*parts)]
    eng = BandArrowBatchedEngine(d, bw, 1, 3)
    f = eng.factor(targs[0], targs[1], _schur_from_Y(*targs[1:]))
    assert f.clamped.tolist() == [False, True, False]
    assert not f.tail_left.any()
    leaves = [t.clone().requires_grad_(True) for t in targs]
    gb = torch.autograd.grad(_half_logdet(eng, *leaves).sum(), leaves)
    assert all(not g[1].any() for g in gb)
    one = BandArrowEngine(d, bw, 1)
    for r, cond in ((0, 1.0), (2, np.linalg.cond(big_full))):
        tol = max(1e-10, cond * np.finfo(float).eps)
        lv = [torch.tensor(a).requires_grad_(True) for a in parts[r]]
        for a, b in zip(gb, torch.autograd.grad(one.arrow_half_logdet(*lv),
                                                lv)):
            assert b.abs().max() > 0
            np.testing.assert_allclose(a[r].numpy(), b.numpy(), rtol=tol,
                                       atol=tol * float(b.abs().max()))


def _check_no_tail():
    rng = np.random.default_rng(4)
    d, bw, nr = 40, 2, 6
    probs = [_arrow_problem(rng, d, bw, 1) for _ in range(nr)]
    bands = torch.tensor(np.stack([p[0].T for p in probs]))
    As = [p[3][:d, :d] for p in probs]
    eng = BandArrowBatchedEngine(d, bw, 0, nr)
    C = torch.zeros((nr, d, 0), dtype=torch.float64)
    Hd = torch.zeros((nr, 0, 0), dtype=torch.float64)
    f = eng.factor(bands, C, None)
    hld = eng.half_logdet(f).numpy()
    rb = rng.normal(size=(nr, d))
    zb, zd = eng.solve(f, torch.tensor(rb),
                       torch.zeros((nr, 0), dtype=torch.float64))
    assert zd.shape == (nr, 0)
    for r in range(nr):
        assert abs(hld[r] - 0.5 * np.linalg.slogdet(As[r])[1]) < 1e-10
        np.testing.assert_allclose(zb[r].numpy(),
                                   np.linalg.solve(As[r], rb[r]), atol=1e-9)
    leaf = bands.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(_half_logdet(eng, leaf, C, Hd).sum(), leaf)
    for r in range(nr):
        Hinv = np.linalg.inv(As[r])
        for o in range(bw + 1):
            w = 0.5 if o == 0 else 1.0
            np.testing.assert_allclose(g[r, :d - o, o].numpy(),
                                       w * np.diag(Hinv, -o), atol=1e-9)
