"""bayesgp_torch band kernels K1-K3: each plain version (the CPU path of
its CUDA wrapper) against the JAX package's Pallas kernel in interpret
mode and against dense numpy, on the same numpy inputs. K4, K5 and the
plain solves' summation orders are in test_torch_band_takahashi.py; the
helpers here serve both files (and test_torch_band_batched.py).

Tolerances: K1-K3 are double-float on the TPU side (~2^-48 relative),
so rtol 1e-10, and 1e-10 against dense f64 numpy.

Four cases in this file and three in the other, on purpose: pytest-xdist's
file scheduler hands out files in order of their case counts, and files
of fewer cases than tests/test_mcmc.py (5) queue behind it.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from bayesgp_tpu.linalg import band_kernels as jbk
from bayesgp_torch.linalg import band_kernels as bk

torch.set_num_threads(1)

Q, R = 3, 5


def _spd_band(rng, d, bw):
    """Equilibrated banded SPD matrix and its (bw+1, d) JAX-layout band."""
    L0 = 0.4 * np.tril(rng.normal(size=(d, d)), -1)
    L0 *= np.abs(np.arange(d)[:, None] - np.arange(d)[None, :]) <= bw
    np.fill_diagonal(L0, 1.5 + rng.uniform(0, 1, d))
    A = L0 @ L0.T
    s = 1.0 / np.sqrt(np.diag(A))
    A = A * s[:, None] * s[None, :]
    return A, _band_of(A, bw)


def _band_of(A, bw):
    d = A.shape[0]
    band = np.zeros((bw + 1, d))
    for o in range(bw + 1):
        band[o, :d - o] = np.diag(A, -o)
    return band


def _jax_factor(band, C, d, bw):
    """(L (d, bw+1) f64, Lh, Ll, Y, hld) from the interpret-mode K1."""
    bh, bl = jbk.pack_band(jnp.asarray(band), d, bw)
    ch, cl = jbk.pack_rhs(jnp.asarray(C), d, bw)
    Lh, Ll, Yh, Yl, misc = jbk.factor_fn(d, bw, interpret=True)(
        bh, bl, ch, cl)
    W, _ = jbk.plan_rows(d, bw)
    L = (np.asarray(Lh, np.float64) + np.asarray(Ll, np.float64))[
        W:W + d, :bw + 1]
    hld = 0.5 * (float(misc[0, 0]) + float(misc[0, 1]))
    Y = np.asarray(jbk.unpack((Yh, Yl), d, bw, C.shape[1]))
    return L, Lh, Ll, Y, hld


def _torch_factor(band, C):
    L, rinv, Y, hld, _ = bk.band_factor(torch.tensor(band.T.copy()),
                                        torch.tensor(C))
    return L.numpy(), rinv, Y.numpy(), float(hld), L


def _dense_band(L, bw):
    """(d, bw+1) port-layout band -> dense lower-triangular matrix."""
    d = L.shape[0]
    out = np.zeros((d, d))
    for o in range(bw + 1):
        out[np.arange(o, d), np.arange(d - o)] = L[:d - o, o]
    return out


def _zero_out_of_band(L):
    d, w = L.shape
    mask = np.arange(d)[:, None] + np.arange(w)[None, :] < d
    return np.where(mask, L, 0.0)


@pytest.mark.parametrize("d,bw", [(64, 3), (40, 2)])
def test_factor_and_solves_match_pallas(d, bw):
    """K1 (L, Y, half log-det), K2 and K3 against the double-float
    Pallas kernels and dense numpy."""
    rng = np.random.default_rng(d + bw)
    A, band = _spd_band(rng, d, bw)
    C = rng.normal(size=(d, Q))
    B = rng.normal(size=(d, R))
    Lj, Lh, Ll, Yj, hldj = _jax_factor(band, C, d, bw)
    L, rinv, Y, hld, Lt = _torch_factor(band, C)

    np.testing.assert_allclose(L, _zero_out_of_band(Lj), rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(rinv.numpy(), 1.0 / L[:, 0], rtol=1e-14)
    np.testing.assert_allclose(Y, Yj, rtol=1e-10, atol=1e-13)
    assert abs(hld - hldj) <= 1e-10 * abs(hldj) + 1e-12
    Lnp = np.linalg.cholesky(A)
    np.testing.assert_allclose(_dense_band(L, bw), Lnp, atol=1e-12)
    assert abs(hld - np.log(np.diag(Lnp)).sum()) < 1e-11

    rh, rl = jbk.pack_rhs(jnp.asarray(B), d, bw)
    yj = np.asarray(jbk.unpack(
        jbk.fwd_solve_fn(d, bw, interpret=True)(Lh, Ll, rh, rl), d, bw, R))
    xj = np.asarray(jbk.unpack(
        jbk.bwd_solve_fn(d, bw, interpret=True)(Lh, Ll, rh, rl), d, bw, R))
    y = bk.band_fwd_solve(Lt, rinv, torch.tensor(B)).numpy()
    x = bk.band_bwd_solve(Lt, rinv, torch.tensor(B)).numpy()
    np.testing.assert_allclose(y, yj, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(x, xj, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(y, np.linalg.solve(Lnp, B), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(x, np.linalg.solve(Lnp.T, B), rtol=1e-10,
                               atol=1e-12)


def _guarded_factor_longdouble(band):
    """The guarded band factor (pivot clamp, cap on |L|) of a JAX-layout
    band in extended precision, and its half log-det: the reference the
    port and the Pallas kernel are both held to on the indefinite bands."""
    W, d = band.shape
    A = band.T.astype(np.longdouble)
    L = np.zeros_like(A)
    logdet = np.longdouble(0)
    for j in range(d):
        acc = A[j].copy()
        for t in range(1, min(j, W - 1) + 1):
            acc[:W - t] -= L[j - t, t:] * L[j - t, t]
        p = acc[0]
        pv = max(abs(p), np.longdouble(bk.PIVOT_FLOOR)) \
            if p < bk.PIVOT_FLOOR else p
        col = acc / np.sqrt(pv)
        col[0] = np.sqrt(pv)
        col[max(d - j, 0):] = 0
        L[j] = np.clip(col, -bk.L_CAP, bk.L_CAP)
        logdet += np.log(pv)
    return L.astype(np.float64), float(logdet / 2)


@pytest.mark.parametrize("kind", ["tiny_negative", "order_one_negative"])
def test_guarded_factor_finite_on_indefinite(kind):
    """The pivot clamp and caps keep K1's outputs finite on the two
    indefinite bands the JAX package's robustness tests pin, and the
    plain version and the Pallas kernel both agree with the guarded
    factor in extended precision there. On the nearly singular band
    ('tiny_negative') a factor's entries carry about 1e-7 of rounding in
    f64 and the double-float Pallas kernel sits close to 1e-6 from the
    extended factor at its worst entry, so each is held to that factor
    (the port at rtol 2e-7, the kernel at 1e-6) and not to the other."""
    rng = np.random.default_rng(0)
    d, bw = 64, 3
    A, _ = _spd_band(rng, d, bw)
    if kind == "tiny_negative":
        A = A - (np.linalg.eigvalsh(A).min() + 5e-7) * np.eye(d)
    else:
        A = A.copy()
        A[10, 10] = -0.8
        A[40, 40] = 1e-14
    band = _band_of(A, bw)
    C = rng.normal(size=(d, Q))
    L, rinv, Y, hld, Lt = _torch_factor(band, C)
    assert np.all(np.isfinite(L)) and np.all(np.isfinite(Y))
    assert np.isfinite(hld)
    assert np.abs(L).max() <= bk.L_CAP
    B = torch.tensor(rng.normal(size=(d, 2)))
    assert torch.isfinite(bk.band_fwd_solve(Lt, rinv, B)).all()
    assert torch.isfinite(bk.band_bwd_solve(Lt, rinv, B)).all()
    Lj, _, _, Yj, hldj = _jax_factor(band, C, d, bw)
    Lx, hldx = _guarded_factor_longdouble(band)
    np.testing.assert_allclose(L, Lx, rtol=2e-7, atol=1e-9)
    np.testing.assert_allclose(_zero_out_of_band(Lj), Lx, rtol=1e-6,
                               atol=1e-9)
    assert abs(hld - hldj) < 1e-6 * max(1.0, abs(hldj))
    assert abs(hld - hldx) < 1e-7 * max(1.0, abs(hldx))
