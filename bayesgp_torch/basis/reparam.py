"""Compact-support reparametrization of the IWP O-spline space.

The order-p O-spline basis functions phi_i (osplines.get_local_poly,
reference R/01_utility.R:346-364) have POLYNOMIAL TAILS: phi_i is the
p-fold integral of the indicator of (kappa_i, kappa_{i+1}], so the design
matrix is dense lower-staircase and the conditional Hessian
B^T D B + e^theta P is dense — this is why the reference leans on TMB's
general sparse Cholesky.

Fix used here: the span of {phi_i} is exactly the space of degree-p
splines on the knot sequence with p vanishing derivatives at 0. The
clamped B-spline basis of that same space (drop the first p B-splines)
has COMPACT support: each design row has <= p+1 nonzeros, the prior
precision becomes banded, and the Newton system becomes
block-tridiagonal + dense arrowhead.

The change of coordinates U = T V (U = O-spline weights, V = B-spline
weights) is exact: U_i = f^(p) on interval i = sum_j V_j psi_j^(p)(mid_i),
giving a banded T. Every posterior quantity in U coordinates is recovered
by the banded product U = T V; the Laplace marginal transforms by the
constant log|det T| which is subtracted for parity with the reference's
U-coordinate normalization.
"""
from __future__ import annotations

import numpy as np
from scipy.interpolate import BSpline


def constrained_bspline_knots(knots: np.ndarray, p: int) -> np.ndarray:
    """Clamped knot vector of degree p over the IWP knot sequence."""
    knots = np.asarray(knots, dtype=np.float64)
    return np.concatenate([
        np.full(p, knots[0]), knots, np.full(p, knots[-1])])


def _basis(knots: np.ndarray, p: int):
    """Full clamped B-spline basis (before dropping boundary functions)."""
    t = constrained_bspline_knots(knots, p)
    nbasis = len(t) - p - 1          # = (k + 2p) - p - 1 = k + p - 1
    return t, nbasis


def eval_constrained_bspline(x, knots, p: int, deriv: int = 0) -> np.ndarray:
    """(len(x), k-1) design of the zero-boundary B-spline basis psi_j
    (first p clamped B-splines dropped). Evaluation at the right endpoint
    takes the left limit; beyond the last knot the O-spline space
    continues polynomially, which BSpline(extrapolate=True) reproduces
    for the last segment."""
    x = np.asarray(x, dtype=np.float64)
    t, nbasis = _basis(knots, p)
    spl = BSpline(t, np.eye(nbasis), p, extrapolate=True)
    if deriv:
        spl = spl.derivative(deriv)
    out = spl(x)
    return np.asarray(out[:, p:], dtype=np.float64)  # drop first p


def transform_T(knots, p: int) -> np.ndarray:
    """(k-1, k-1) matrix with U = T V (O-spline weights from B-spline
    weights): T[i, j] = psi_j^(p)(midpoint of interval i).

    The p-th derivative of a degree-p B-spline is piecewise CONSTANT, so
    T is exactly the composition of p bidiagonal differencing steps
    (the BSpline.derivative coefficient recurrence
    c'[i] = deg * (c[i+1] - c[i]) / (t[i+deg+1] - t[i+1]) applied to the
    identity), kept sparse: O(d p^2) instead of the dense
    (d x nbasis)-coefficient splder path (~2 s at k=2000 -> ~1 ms)."""
    import scipy.sparse as sp

    knots = np.asarray(knots, dtype=np.float64)
    t, nbasis = _basis(knots, p)
    C = sp.identity(nbasis, format="csr")
    tt = t
    for deg in range(p, 0, -1):
        m = C.shape[0]
        dt = tt[deg + 1: deg + m] - tt[1:m]          # (m-1,)
        # zero denominators only occur where the differentiated basis
        # function's support is empty (fully repeated clamp knots):
        # its coefficient is irrelevant — zero it, as scipy does.
        with np.errstate(divide="ignore"):
            fac = np.where(dt > 0, deg / np.where(dt > 0, dt, 1.0), 0.0)
        D = sp.diags_array([-fac, fac], offsets=[0, 1],
                           shape=(m - 1, m), format="csr")
        C = D @ C
        tt = tt[1:-1]
    # C is (nbasis - p, nbasis): degree-0 coefficients = values on the
    # intervals of tt == knots; row i is the value at mid_i. Drop the
    # first p (boundary-constrained) basis columns.
    return np.asarray(C.toarray()[:, p:], dtype=np.float64)


def sparse_rows(x, knots, p: int):
    """Sparse-row representation of the constrained design:
    (vals (n, p+1), start (n,)) with row i of the design equal to
    vals[i] scattered at columns start[i]..start[i]+p.

    Points beyond the last knot land in the final span (polynomial
    continuation); points below the first knot evaluate to 0 rows.
    """
    x = np.asarray(x, dtype=np.float64)
    knots = np.asarray(knots, dtype=np.float64)
    t, nbasis = _basis(knots, p)
    d = nbasis - p
    # span index of each x in the knot sequence (last interval for x at or
    # beyond the final knot; first for x below the first)
    span = np.clip(np.searchsorted(knots, x, side="right") - 1, 0,
                   len(knots) - 2)
    # active full-basis functions on interval i are i..i+p; in dropped
    # indexing (minus p) that is i-p..i -> window start clipped to [0, d-p-1]
    start = np.clip(span - p, 0, max(d - (p + 1), 0))
    vals = np.zeros((len(x), p + 1))
    inside = (x >= knots[0]) & (x <= knots[-1])
    if inside.any():
        from scipy.interpolate import BSpline
        xm = x[inside]
        M = BSpline.design_matrix(xm, t, p, extrapolate=False).tocsr()
        M = M[:, p:]                      # drop the first p basis functions
        rows = np.repeat(np.arange(M.shape[0]), np.diff(M.indptr))
        cols = M.indices
        offs = cols - start[inside][rows]
        ok = (offs >= 0) & (offs <= p)
        ridx = np.where(inside)[0][rows[ok]]
        vals[ridx, offs[ok]] = M.data[ok]
    outside = ~inside
    if outside.any():
        # polynomial continuation / zero region: dense eval of the p+1
        # active columns only (rare points)
        xo = x[outside]
        Bo = eval_constrained_bspline(xo, knots, p)
        so = start[outside]
        for a in range(p + 1):
            col = np.clip(so + a, 0, d - 1)
            vals[np.where(outside)[0], a] = Bo[np.arange(len(xo)), col]
    return vals, start.astype(np.int64)


def prior_band(knots, p: int):
    """Banded prior precision of V: P_V = T^T diag(diff(knots)) T,
    returned as (band (p+1, d), logdetT) with band[o, j] = P_V[j+o, j].

    T is lower-banded with offsets -p..0 BY CONSTRUCTION (transform_T is
    a product of bidiagonal differencing steps), so the P_V band is an
    O(d p^2) diagonal convolution — no dense (d, d) product."""
    knots = np.asarray(knots, dtype=np.float64)
    T = transform_T(knots, p)
    w = np.diff(knots)
    d = T.shape[0]
    # Td[o, i] = T[i, i-o] (zero-padded where i < o)
    Td = np.zeros((p + 1, d))
    for o in range(p + 1):
        Td[o, o:] = np.diagonal(T, -o)
    band = np.zeros((p + 1, d))
    # P_V[j+o, j] = sum_a w[i] T[i, j+o] T[i, j] at i = j + o + a
    for o in range(p + 1):
        for a in range(p + 1 - o):
            i = np.arange(o + a, d)
            band[o, i - o - a] += w[i] * Td[a, i] * Td[o + a, i]
    # T lower triangular with nonzero diagonal: det = prod(diag)
    diagT = np.diagonal(T)
    if np.all(np.abs(diagT) > 0):
        logdetT = float(np.sum(np.log(np.abs(diagT))))
    else:
        _, logdetT = np.linalg.slogdet(T)
    return band, float(logdetT), T
