"""bayesgp_torch band kernels K4 and K5, and the summation orders of the
plain band solves: each plain version (the CPU path of its CUDA wrapper)
against the JAX package's Pallas kernel in interpret mode and against
dense numpy, on the same numpy inputs; and the wrappers' argument
checks.

Tolerances: K4 and K5 run in f32 on the TPU side, so rtol 1e-5 (with an
absolute floor of 1e-5 of the largest entry, for entries near zero), and
1e-10 against dense f64 numpy.

The summation order of the plain solves, at bw = 3 (a register-window
width) and at bw = 12 and 40 (d = 200, past SMALL_BW): K2, K3 and K5
sum a row's products farthest-first at every width, each equal bit for
bit to a numpy loop in that order (and not to one in the other order),
and against scipy.linalg.solve_triangular on the dense factor at rtol
1e-12 (a well-conditioned band, f64 both sides). At the same widths the
plain K4 sums every entry of H^{-1} farthest-first, Z[j, 0] with Z[j,
1]'s product last: bit for bit a numpy loop in that order and not one
nearest-first, the band of the dense inverse at rtol 1e-10, and the
plain K11 equal to it system by system. The factor's order:
the plain K1 at bw = 3 and 12 (with its tail Y) and the plain K8 at
bw = 3, each equal bit for bit to a numpy right-looking factor, which
subtracts every entry's products farthest-first.

Three cases, on purpose (test_torch_band_kernels.py, docstring).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import scipy.linalg
import torch

from bayesgp_tpu.linalg import band_kernels as jbk
from bayesgp_torch.linalg import band_batched as bb
from bayesgp_torch.linalg import band_kernels as bk

from test_torch_band_kernels import (R, _dense_band, _jax_factor,
                                     _spd_band, _torch_factor,
                                     _zero_out_of_band)

torch.set_num_threads(1)


@pytest.mark.parametrize("d,bw", [(64, 3), (40, 2)])
def test_takahashi_and_multi_rhs_match_pallas(d, bw):
    """K4 (band of H^{-1}) and K5 (L^T X = Z for many draws) against the
    f32 Pallas kernels and dense f64 numpy."""
    rng = np.random.default_rng(100 + d + bw)
    A, band = _spd_band(rng, d, bw)
    _, Lh, _, _, _ = _jax_factor(band, np.zeros((d, 0)), d, bw)
    L, rinv, _, _, Lt = _torch_factor(band, np.zeros((d, 0)))
    W, Rows = jbk.plan_rows(d, bw)

    Zj = np.asarray(jbk.takahashi_fn(d, bw, interpret=True)(Lh),
                    np.float64)[W:W + d, :bw + 1]
    Z = bk.band_takahashi(Lt, rinv).numpy()
    Hinv = np.linalg.inv(A)
    np.testing.assert_allclose(Z, _zero_out_of_band(Zj), rtol=1e-5,
                               atol=1e-5 * np.abs(Zj).max())
    np.testing.assert_allclose(_dense_band(Z, bw),
                               np.tril(Hinv) * (np.abs(
                                   np.subtract.outer(np.arange(d),
                                                     np.arange(d))) <= bw),
                               rtol=1e-10, atol=1e-12)

    M = 128
    Zn = rng.normal(size=(d, M))
    Bp = np.zeros((Rows, M), np.float32)
    Bp[W:W + d] = Zn
    Xj = np.asarray(jbk.bwd_multi_fn(d, bw, 1, tile=M, interpret=True)(
        Lh, jnp.asarray(Bp)), np.float64)[W:W + d]
    X = bk.band_bwd_multi(Lt, rinv, torch.tensor(Zn)).numpy()
    Xref = np.linalg.solve(np.linalg.cholesky(A).T, Zn)
    np.testing.assert_allclose(X, Xref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(X, Xj, rtol=1e-5,
                               atol=1e-5 * np.abs(Xref).max())


def _loop_solve(L, rinv, B, trans, farthest):
    """numpy loop of the band substitution, a row's products subtracted
    farthest-first (the plain versions' order) or nearest-first."""
    d, W = L.shape
    X = np.zeros_like(B)
    for j in (range(d - 1, -1, -1) if trans else range(d)):
        ts = range(1, min(W - 1, d - 1 - j if trans else j) + 1)
        acc = B[j].copy()
        for t in (reversed(ts) if farthest else ts):
            acc = acc - ((L[j, t] * X[j + t]) if trans
                         else (L[j - t, t] * X[j - t]))
        X[j] = acc * rinv[j]
    return X


def _loop_factor(band, C):
    """numpy right-looking guarded band factor: step j scales column j,
    then subtracts l_a l_b from every entry of the columns after it and
    Y_j l_t from the tail rows below it, so each entry takes its
    products farthest-first."""
    d, W = band.shape
    A, Yacc = band.copy(), C.copy()
    L, Y, rinv = np.zeros_like(A), np.zeros_like(C), np.zeros(d)
    for j in range(d):
        p = A[j, 0]
        pv = max(abs(p), bk.PIVOT_FLOOR) if p < bk.PIVOT_FLOOR else p
        # torch's CPU sqrt, as the plain versions take it (it is not
        # always numpy's correctly rounded one)
        rs = float(1.0 / torch.sqrt(torch.tensor(pv, dtype=torch.float64)))
        col = A[j] * rs
        col[0] = pv * rs
        col[max(d - j, 0):] = 0.0
        L[j] = np.clip(col, -bk.L_CAP, bk.L_CAP)
        Y[j] = np.clip(Yacc[j] * rs, -bk.Y_CAP, bk.Y_CAP)
        rinv[j] = rs
        for b in range(1, min(W, d - j)):
            A[j + b, :W - b] -= L[j, b:] * L[j, b]
            Yacc[j + b] -= Y[j] * L[j, b]
    return L, rinv, Y


def _check_factor_orders():
    for bw in (3, 12):
        rng = np.random.default_rng(50 + bw)
        d = 120
        _, band = _spd_band(rng, d, bw)
        band = band.T.copy()
        C = rng.normal(size=(d, 2))
        got = bk.band_factor_plain(torch.tensor(band), torch.tensor(C))
        for g, w in zip(got, _loop_factor(band, C)):
            np.testing.assert_array_equal(g.numpy(), w)
        if bw == 3:
            bands = np.stack([band, _spd_band(rng, d, bw)[1].T])
            Lb, rb, _, _ = bb.band_factor_batched_plain(torch.tensor(bands))
            for r in range(2):
                Lw, rw, _ = _loop_factor(bands[r], np.zeros((d, 0)))
                np.testing.assert_array_equal(Lb[r].numpy(), Lw)
                np.testing.assert_array_equal(rb[r].numpy(), rw)


def _loop_takahashi(L, rinv, farthest):
    """numpy loop of the band selected inverse, every sum in one order:
    Z[j, o] = 0 - sum_t l_t S(j+t, j+o), then Z[j, 0] = rinv_j^2 - sum_t
    l_t Z[j, t], t from bw down to 1 (the plain versions' order) or from
    1 up to bw (nearest-first)."""
    d, W = L.shape
    bw = W - 1
    Zp = np.zeros((d + bw, W))          # rows past d: zero
    t = np.arange(1, W)
    rows = np.minimum.outer(t, t)
    cols = np.abs(np.subtract.outer(t, t))
    order = range(bw - 1, -1, -1) if farthest else range(bw)
    for j in range(d - 1, -1, -1):
        lr = np.where(j + t < d, L[j, 1:] * rinv[j], 0.0)
        S = Zp[j + rows, cols]          # S[t-1, o-1] = S(j+t, j+o)
        acc = np.zeros(bw)
        for k in order:
            acc = acc - lr[k] * S[k]
        Zp[j, 1:] = acc
        zjj = rinv[j] * rinv[j]
        for k in order:
            zjj = zjj - lr[k] * acc[k]
        Zp[j, 0] = zjj
    return Zp[:d]


def _check_takahashi_orders(bw, A, L, rinv):
    """K4's plain version in its order, against the dense inverse, and
    K11's system by system."""
    Ln, rn = L.numpy(), rinv.numpy()
    Z = bk.band_takahashi_plain(L, rinv).numpy()
    np.testing.assert_array_equal(Z, _loop_takahashi(Ln, rn, True))
    assert not np.array_equal(Z, _loop_takahashi(Ln, rn, False))
    d = A.shape[0]
    Hinv = np.linalg.inv(A)
    np.testing.assert_allclose(Z, np.stack(
        [np.concatenate([np.diag(Hinv, -o), np.zeros(o)])
         for o in range(bw + 1)], 1), rtol=1e-10,
        atol=1e-10 * np.abs(Hinv).max())
    _, band2 = _spd_band(np.random.default_rng(100 + bw), d, bw)
    L2, r2, _, _, _ = bk.band_factor(torch.tensor(band2.T.copy()),
                                     torch.zeros((d, 0), dtype=torch.float64))
    Zb = bb.band_takahashi_batched_plain(torch.stack([L, L2]),
                                         torch.stack([rinv, r2]))
    assert torch.equal(Zb[0], torch.tensor(Z))
    assert torch.equal(Zb[1], bk.band_takahashi_plain(L2, r2))


def _check_solve_orders():
    _check_factor_orders()
    for bw in (3, 12, 40):
        rng = np.random.default_rng(bw)
        d = 200
        A, band = _spd_band(rng, d, bw)
        L, rinv, _, _, _ = bk.band_factor(torch.tensor(band.T.copy()),
                                          torch.zeros((d, 0),
                                                      dtype=torch.float64))
        _check_takahashi_orders(bw, A, L, rinv)
        B = rng.normal(size=(d, R))
        Ln, rn = L.numpy(), rinv.numpy()
        Ld = _dense_band(Ln, bw)
        for plain, trans in ((bk.band_fwd_solve_plain, False),
                             (bk.band_bwd_solve_plain, True),
                             (bk.PLAIN.bwd_multi, True)):
            X = plain(L, rinv, torch.tensor(B)).numpy()
            np.testing.assert_array_equal(X, _loop_solve(Ln, rn, B, trans,
                                                         True))
            # the two orders round differently here
            assert not np.array_equal(X, _loop_solve(Ln, rn, B, trans,
                                                     False))
            np.testing.assert_allclose(
                X, scipy.linalg.solve_triangular(Ld, B, lower=True,
                                                 trans=trans),
                rtol=1e-12, atol=1e-12 * np.abs(X).max())


def test_wrappers_check_arguments():
    """Wrappers refuse what the kernels do not take; and the plain
    factor's and solves' summation orders (_check_solve_orders)."""
    _check_solve_orders()
    band = torch.ones((8, 4), dtype=torch.float64)
    with pytest.raises(TypeError):
        bk.band_factor(band.float(), torch.zeros((8, 0)))
    with pytest.raises(ValueError):
        bk.band_factor(band, torch.zeros((7, 2), dtype=torch.float64))
    with pytest.raises(ValueError):
        bk.band_fwd_solve(band, band[:, 0].contiguous(), band.T)
