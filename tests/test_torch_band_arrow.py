"""bayesgp_torch BandArrowEngine (band + dense tail) on the CPU against
the JAX package's Pallas engine (interpret mode), its f64 block engine
and dense numpy, on the same numpy arrowhead systems.

The engine's differentiable half log-det is schur_half_logdet, which
takes the Schur tail's derivative through a tail S the caller forms. Here
S = Hd - C^T Hb^{-1} C is formed densely and differentiably in (band, C,
Hd) (_half_logdet), and the tail the factor takes is Hd - Y^T Y from the
engine's own Y, so the chain rule through S turns schur_backward's
cotangents into the arrowhead's (band, C, Hd) cotangents, which the
block engine's autodiff gives.

Tolerances: half log-det and solves 1e-10 (both sides f64 or
double-float); draws 1e-10 against dense f64, 1e-4 against the f32
Pallas multi-RHS kernel; the half log-det gradient 1e-9 against the
block engine's f64 autodiff gradient. The JAX values of a case come from
one jitted program (_jax_quick.quick_jit).
"""
import numpy as np
import pytest
import jax
import torch

from bayesgp_tpu.linalg import band_arrow as jba
from bayesgp_torch.linalg.band_arrow import BandArrowEngine

from _jax_quick import quick_jit

torch.set_num_threads(1)


def _arrow_problem(rng, d, bw, q):
    """Equilibrated banded SPD block, coupling C, dense tail Hd and the
    full (d+q)^2 matrix (the construction of the JAX package's tests)."""
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
    Hfull = np.block([[A, C], [C.T, Hd]])
    return band, C, Hd, Hfull


def _schur_from_Y(Hd):
    """The factor's tail, Hd - Y^T Y from the engine's Y = L^{-1} C."""
    def schur(L, rinv, Y):
        return Hd.detach() - Y.mT @ Y
    return schur


def _dense_band(bands):
    """(..., d, d) symmetric matrices of (..., d, bw+1) lower bands, each
    off-diagonal band entry feeding both of its places."""
    d = bands.shape[-2]
    H = torch.diag_embed(bands[..., 0])
    for o in range(1, bands.shape[-1]):
        low = torch.diag_embed(bands[..., :d - o, o], offset=-o)
        H = H + low + low.mT
    return H


def _half_logdet(eng, band, C, Hd, f=None):
    """Differentiable arrowhead half log-det(s) of a one-system or batched
    engine: schur_half_logdet with S = Hd - C^T Hb^{-1} C formed densely
    in (band, C, Hd), from the factor f (factored here when None)."""
    if f is None:
        f = eng.factor(band, C, _schur_from_Y(Hd))
    if eng.q:
        S = Hd - C.mT @ torch.linalg.solve(_dense_band(band), C)
    else:
        S = Hd
    return eng.schur_half_logdet(band, S, f)


@pytest.mark.parametrize("q", [0, 5])
def test_engine_matches_pallas_block_and_dense(q):
    rng = np.random.default_rng(2)
    d, bw, s = 64, 3, 8
    band, C, Hd, Hfull = _arrow_problem(rng, d, bw, max(q, 1))
    if q == 0:
        C, Hd, Hfull = np.zeros((d, 0)), np.zeros((0, 0)), Hfull[:d, :d]
    rb, rd = rng.normal(size=d), rng.normal(size=q)
    M = 32
    zbn, zdn = rng.normal(size=(d, M)), rng.normal(size=(q, M))
    eng = BandArrowEngine(d, bw, q)
    eng_p = jba.make_engine(d, bw, q, s, force="pallas_interpret")
    eng_b = jba.make_engine(d, bw, q, s, force="block")

    def jax_ref(band, C, Hd, rb, rd, zbn, zdn):
        fp = eng_p.factor(band, C, Hd)
        return (eng_p.half_logdet(fp), eng_p.solve(fp, rb, rd)[0],
                eng_p.sample_multi(fp, zbn, zdn)[0],
                jax.grad(lambda *a: eng_b.arrow_half_logdet(*a),
                         argnums=(0, 1, 2))(band, C, Hd))
    hld_p, zbp, xbp, g_b = quick_jit(jax_ref)(band, C, Hd, rb, rd, zbn, zdn)
    targs = (torch.tensor(band.T.copy()), torch.tensor(C), torch.tensor(Hd))
    f = eng.factor(targs[0], targs[1], _schur_from_Y(targs[2]))

    hld = float(eng.half_logdet(f))
    hld_ref = 0.5 * np.linalg.slogdet(Hfull)[1]
    assert abs(hld - hld_ref) < 1e-10 * max(1.0, abs(hld_ref))
    assert abs(hld - float(hld_p)) < 1e-10

    zb, zd = eng.solve(f, torch.tensor(rb), torch.tensor(rd))
    zref = np.linalg.solve(Hfull, np.concatenate([rb, rd]))
    np.testing.assert_allclose(zb.numpy(), zref[:d], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(zd.numpy(), zref[d:], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(zb.numpy(), np.asarray(zbp), rtol=1e-10,
                               atol=1e-12)

    # draws x = L_full^{-T} z with the same numpy noise
    xb, xd = eng.sample_multi(f, torch.tensor(zbn), torch.tensor(zdn))
    Lfull = np.linalg.cholesky(Hfull)
    xref = np.linalg.solve(Lfull.T, np.concatenate([zbn, zdn]))
    np.testing.assert_allclose(xb.numpy(), xref[:d], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(xd.numpy(), xref[d:], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(xb.numpy(), np.asarray(xbp), rtol=1e-4,
                               atol=1e-4 * np.abs(xref).max())

    # Takahashi-based autograd gradient vs f64 autodiff through blocks
    leaves = [t.clone().requires_grad_(True) for t in targs]
    g = torch.autograd.grad(_half_logdet(eng, *leaves), leaves,
                            allow_unused=True)
    for gt, gb, t in zip(g, g_b, targs):
        gt = np.zeros(t.shape) if gt is None else gt.numpy()
        gb = np.asarray(gb)
        if gt.ndim == 2 and gt.shape[1] == bw + 1:
            gb = gb.T                       # JAX band layout is (bw+1, d)
        np.testing.assert_allclose(gt, gb, rtol=1e-9, atol=1e-12)

    # from the factor above: same value, same cotangents
    leaves2 = [t.clone().requires_grad_(True) for t in targs]
    v2 = _half_logdet(eng, *leaves2, f=f)
    assert float(v2.detach()) == hld
    g2 = torch.autograd.grad(v2, leaves2, allow_unused=True)
    for a, b in zip(g, g2):
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
