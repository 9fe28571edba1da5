"""bayesgp_torch dense block kernels (K6, K7) and the blocked routines
around them against the JAX package's double-float Pallas kernels
(linalg/chol_dd.py, interpret mode) and LAPACK, on the same numpy
matrices. Here the wrappers run their plain PyTorch versions (CPU
tensors); chip_smoke.py holds the CUDA kernels to those on the card.

Tolerance: 1e-13 relative to each result's scale, the resolution of
the TPU kernels' double-float arithmetic (~2^-48) on these
well-conditioned inputs; 1e-12 for the blocked solves and the
half-log-det gradient, which add three blocks of f64 products.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from bayesgp_tpu.linalg import chol_dd, dd
from bayesgp_torch.linalg import chol_dense as cd

torch.set_num_threads(1)

NB = chol_dd.B


def _spd(d, seed):
    """Jacobi-equilibrated SPD matrix with condition number ~1e2."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    A = (Q * np.logspace(0, -2, d)) @ Q.T
    s = 1.0 / np.sqrt(np.diag(A))
    return A * s[:, None] * s[None, :]


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def test_block_kernels_match_dd_kernels():
    """K6 (healthy and indefinite blocks, with the clamp flag it reports)
    and K7 (forward, and transposed against the JAX package's row/column
    flip) against the interpret-mode double-float kernels."""
    healthy = _spd(NB, seed=1)
    # indefinite: a pivot under the 1e-12 floor, whose column is then
    # capped at 1e3, makes every later pivot negative and clamped
    bad = healthy.copy()
    bad[0, 0] = 1e-14
    factor = chol_dd.factor_block_fn(True)
    for S, clamps in ((healthy, 0), (bad, 1)):
        Lt = factor(*dd.from_f64(jnp.asarray(S)))
        want = np.asarray(dd.to_f64(Lt)).T
        flag = torch.zeros((), dtype=torch.int32)
        got = cd.dense_factor_block(torch.tensor(S), flag).numpy()
        _close(got, want, 1e-13)
        assert np.array_equal(got, np.tril(got))
        assert int(flag) == clamps      # K6 reports the clamp it made
    assert np.abs(got).max() == cd.L_CAP         # the cap bound
    assert (np.diag(got) < 0).any()              # clamped negative pivots

    L = np.linalg.cholesky(healthy)
    rng = np.random.default_rng(2)
    Bm = rng.normal(size=(NB, NB))
    Lt = dd.from_f64(jnp.asarray(L.T))
    solve = chol_dd.solve_lower_fn(NB, True)
    want = np.asarray(dd.to_f64(solve(*Lt, *dd.from_f64(jnp.asarray(Bm)))))
    got = cd.dense_solve_lower(torch.tensor(L), torch.tensor(Bm)).numpy()
    _close(got, want, 1e-13)
    # L^T X = B: the JAX package solves J L^T J (lower) on J B
    Lf = np.ascontiguousarray(np.flip(L.T, (0, 1)))
    Xf = dd.to_f64(solve(*dd.from_f64(jnp.asarray(Lf.T)),
                         *dd.from_f64(jnp.asarray(Bm[::-1].copy()))))
    got = cd.dense_solve_lower(torch.tensor(L), torch.tensor(Bm),
                               trans=True).numpy()
    _close(got, np.asarray(Xf)[::-1], 1e-13)


def test_blocked_factor_and_solves():
    """The blocked factor and solves at d = 300 (two full blocks and a
    ragged one) against chol_dd's blocked routines and LAPACK."""
    d = 300
    A = _spd(d, seed=3)
    Lp = cd.cholesky_blocked(torch.tensor(A))
    assert Lp.shape == (cd.padded_dim(d),) * 2
    L = Lp[:d, :d].numpy()
    Ljax = np.asarray(chol_dd.cholesky_dd_f64(jnp.asarray(A), True))
    _close(L, Ljax, 1e-13)
    _close(L, np.linalg.cholesky(A), 1e-13)
    assert np.allclose(np.asarray(Lp[d:, d:]), np.eye(Lp.shape[0] - d))
    hld = float(cd.half_logdet(Lp))
    assert abs(hld - float(chol_dd.half_logdet(jnp.asarray(Ljax)))) < 1e-11

    rng = np.random.default_rng(4)
    for r in (1, 7, 130):
        Bm = rng.normal(size=(d, r))
        y = cd.solve_lower_blocked(Lp, torch.tensor(Bm)).numpy()
        x = cd.solve_lower_t_blocked(Lp, torch.tensor(Bm)).numpy()
        _close(y, np.linalg.solve(L, Bm), 1e-12)
        _close(x, np.linalg.solve(L.T, Bm), 1e-12)
    # the JAX package's blocked solves (interpret mode) at the widest r
    Lj, Bj = jnp.asarray(Ljax), jnp.asarray(Bm)
    _close(y, chol_dd.solve_lower_blocked(Lj, Bj, True), 1e-12)
    _close(x, chol_dd.solve_lower_t_blocked(Lj, Bj, True), 1e-12)
    b = rng.normal(size=d)
    assert cd.solve_lower_blocked(Lp, torch.tensor(b)).shape == (d,)


def test_half_logdet_gradient_matches_jax():
    """The half-log-det autograd.Function (backward 0.5 S^{-1} by two
    blocked solves) against jax.grad through cholesky_dd_f64's custom VJP
    (the Murray pullback) at d = 300, with a reused factor as well."""
    d = 300
    A = _spd(d, seed=5)
    ct = 1.7

    def f(M):
        return ct * chol_dd.half_logdet(chol_dd.cholesky_dd_f64(M, True))

    val_j, grad_j = jax.value_and_grad(f)(jnp.asarray(A))
    for factor in (None, cd.cholesky_blocked(torch.tensor(A))):
        S = torch.tensor(A, requires_grad=True)
        val = ct * cd.dense_half_logdet(S, factor=factor)
        (grad,) = torch.autograd.grad(val, S)
        val = float(val.detach())
        assert abs(val - float(val_j)) < 1e-12 * abs(float(val_j))
        _close(grad.numpy(), grad_j, 1e-12)
    _close(grad.numpy(), 0.5 * ct * np.linalg.inv(A), 1e-12)
