"""Cubic B-spline basis evaluation matching fda::create.bspline.basis /
fda::eval.basis (used by the reference's sGP machinery at
R/01_utility.R:71-83, 178-189).

fda's basis with `rangeval=c(lo,hi), nbasis=k, norder=4` places
`k - norder + 2` equally spaced breakpoints over [lo, hi]; `dropind=c(1,2)`
removes the first two basis functions (boundary handling). Evaluation at the
right endpoint uses the left-limit polynomial piece, which scipy reproduces
with `extrapolate=True`.
"""
from __future__ import annotations

import numpy as np
from scipy.interpolate import BSpline


def bspline_knots(lo: float, hi: float, nbasis: int, norder: int = 4) -> np.ndarray:
    """Full (clamped) knot vector for fda's equally-spaced break sequence."""
    nbreaks = nbasis - norder + 2
    if nbreaks < 2:
        raise ValueError("nbasis too small for norder")
    breaks = np.linspace(lo, hi, nbreaks)
    return np.concatenate([
        np.full(norder - 1, lo), breaks, np.full(norder - 1, hi)])


def eval_bspline_basis(x, lo: float, hi: float, nbasis: int, norder: int = 4,
                       deriv: int = 0, dropind=()) -> np.ndarray:
    """(len(x), nbasis - len(dropind)) design matrix of the basis (or its
    `deriv`-th derivative). `dropind` is 1-based like fda's."""
    x = np.asarray(x, dtype=np.float64)
    t = bspline_knots(lo, hi, nbasis, norder)
    spl = BSpline(t, np.eye(nbasis), norder - 1, extrapolate=True)
    if deriv > 0:
        spl = spl.derivative(deriv)
    out = spl(x)
    if dropind:
        keep = [i for i in range(nbasis) if (i + 1) not in set(dropind)]
        out = out[:, keep]
    return np.asarray(out, dtype=np.float64)


def deriv_coef_matrix(t: np.ndarray, degree: int, deriv: int):
    """Sparse (nbasis - deriv, nbasis) matrix C with
    f^(deriv) = BSpline(t[deriv:-deriv or None], C @ c, degree - deriv):
    the BSpline.derivative coefficient recurrence
    c'[i] = deg * (c[i+1] - c[i]) / (t[i+deg+1] - t[i+1]) applied `deriv`
    times to the identity, kept sparse (zero denominators — empty-support
    clamped functions — zero the coefficient, as scipy does)."""
    import scipy.sparse as sp

    nbasis = len(t) - degree - 1
    C = sp.identity(nbasis, format="csr")
    tt = t
    for deg in range(degree, degree - deriv, -1):
        m = C.shape[0]
        dt = tt[deg + 1: deg + m] - tt[1:m]
        fac = np.where(dt > 0, deg / np.where(dt > 0, dt, 1.0), 0.0)
        D = sp.diags_array([-fac, fac], offsets=[0, 1],
                           shape=(m - 1, m), format="csr")
        C = D @ C
        tt = tt[1:-1]
    return C


def sparse_design(x, lo: float, hi: float, nbasis: int, norder: int = 4,
                  deriv: int = 0):
    """Sparse CSR (len(x), nbasis) design of the basis's `deriv`-th
    derivative w.r.t. the ORIGINAL coefficients — <= norder nonzeros per
    row, O(len(x)) build. Requires lo <= x <= hi (no extrapolation);
    x = hi takes the left-limit piece (fda convention)."""
    x = np.asarray(x, dtype=np.float64)
    if len(x) and (x.min() < lo or x.max() > hi):
        raise ValueError("sparse_design requires x within [lo, hi]")
    t = bspline_knots(lo, hi, nbasis, norder)
    degree = norder - 1
    td = t[deriv:len(t) - deriv] if deriv else t
    S = BSpline.design_matrix(x, td, degree - deriv,
                              extrapolate=False).tocsr()
    if deriv:
        S = S @ deriv_coef_matrix(t, degree, deriv)
    return S
