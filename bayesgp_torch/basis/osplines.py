"""O-spline local basis and global polynomials for the IWP prior.

The order-p Integrated Wiener Process prior is approximated by a
finite-dimensional basis: `k` knots define `k-1` local O-spline basis
functions whose p-th derivatives are the indicator functions of the knot
intervals, plus `p` global monomials carrying the boundary conditions.

Reference behavior reproduced here (cited file:line into the BayesGP R sources):
 - `get_local_poly` / `local_poly_helper`: R/01_utility.R:346-401
 - `global_poly_helper`: R/01_utility.R:413-419
 - `compute_weights_precision` (diag(diff(knots)) with reflection for
   negative knots): R/01_utility.R:325-344

Implementation is vectorized NumPy (host-side, runs once per model build);
all arrays are float64 for downstream numerical parity.
"""
from __future__ import annotations

import math

import numpy as np


def get_local_poly(knots: np.ndarray, refined_x: np.ndarray, p: int) -> np.ndarray:
    """Evaluate the (k-1) O-spline basis functions at `refined_x`.

    Basis j (built on interval (knots[j], knots[j+1]]) evaluates to:
      0                                  for x <= knots[j]
      (x - knots[j])^p / p!              for knots[j] < x <= knots[j+1]
      sum_{m=1..p} d_j^m (x-knots[j+1])^{p-m} / (m! (p-m)!)   beyond
    (the polynomial continuation; reference R/01_utility.R:346-364).
    """
    knots = np.asarray(knots, dtype=np.float64)
    x = np.asarray(refined_x, dtype=np.float64)
    dif = np.diff(knots)
    n = len(knots)
    kl = knots[:-1][None, :]      # (1, k-1) left knots
    kr = knots[1:][None, :]       # (1, k-1) right knots
    xx = x[:, None]               # (n_x, 1)

    inside = (1.0 / math.factorial(p)) * np.power(
        np.clip(xx - kl, 0.0, None), p)

    # tail: sum over m of dif^m (x - kr)^(p-m) / (m! (p-m)!)
    tail = np.zeros((len(x), n - 1), dtype=np.float64)
    dx = xx - kr
    for m in range(1, p + 1):
        tail += (dif[None, :] ** m) * np.power(dx, p - m) / (
            math.factorial(m) * math.factorial(p - m))

    D = np.where(xx <= kl, 0.0, np.where(xx <= kr, inside, tail))
    return D


def _reflect_neg(v: np.ndarray) -> np.ndarray:
    return np.unique(np.sort(np.where(v < 0, -v, 0.0)))


def _reflect_pos(v: np.ndarray) -> np.ndarray:
    return np.unique(np.sort(np.where(v > 0, v, 0.0)))


def local_poly_helper(knots, refined_x, p: int = 2) -> np.ndarray:
    """O-spline design with reflection handling for negative knots.

    Reference: R/01_utility.R:378-401.
    """
    knots = np.asarray(knots, dtype=np.float64)
    x = np.asarray(refined_x, dtype=np.float64)
    if knots.min() >= 0:
        return get_local_poly(knots, x, p)
    if knots.max() <= 0:
        return get_local_poly(_reflect_neg(knots), np.where(x < 0, -x, 0.0), p)
    D1 = get_local_poly(_reflect_neg(knots), np.where(x < 0, -x, 0.0), p)
    D2 = get_local_poly(_reflect_pos(knots), np.where(x > 0, x, 0.0), p)
    return np.concatenate([D1, D2], axis=1)


def global_poly_helper(x, p: int = 2) -> np.ndarray:
    """Monomial design [1, x, ..., x^{p-1}]. Reference: R/01_utility.R:413-419."""
    x = np.asarray(x, dtype=np.float64)
    return np.stack([x ** i for i in range(p)], axis=1)


def compute_weights_precision(knots) -> np.ndarray:
    """Diagonal O-spline weight precision diag(diff(knots)), with the
    negative-knot reflection split. Reference: R/01_utility.R:325-344."""
    knots = np.asarray(knots, dtype=np.float64)
    if knots.min() >= 0:
        return np.diag(np.diff(knots))
    if knots.max() < 0:
        return np.diag(np.diff(_reflect_neg(knots)))
    d1 = np.diff(_reflect_neg(knots))
    d2 = np.diff(_reflect_pos(knots))
    out = np.zeros((len(d1) + len(d2), len(d1) + len(d2)))
    out[:len(d1), :len(d1)] = np.diag(d1)
    out[len(d1):, len(d1):] = np.diag(d2)
    return out


def compute_weights_precision_diag(knots) -> np.ndarray:
    """Diagonal of `compute_weights_precision` (the matrix is diagonal)."""
    knots = np.asarray(knots, dtype=np.float64)
    if knots.min() >= 0:
        return np.diff(knots)
    if knots.max() < 0:
        return np.diff(_reflect_neg(knots))
    return np.concatenate([np.diff(_reflect_neg(knots)),
                           np.diff(_reflect_pos(knots))])
