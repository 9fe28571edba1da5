"""Seasonal GP (sGP) sB-basis and precision construction.

The sGP(a, sigma) prior solves f'' + a^2 f = sigma * xi(t); it is
approximated with the sB basis: cubic B-splines multiplied by cos(a x) and
sin(a x), plus the plain B-splines, harmonically stacked over i = 1..m.

Reference behavior reproduced (cited file:line into the BayesGP R sources):
 - `Compute_B_sB`:        R/01_utility.R:177-195
 - `Compute_B_sB_helper`: R/01_utility.R:198-208
 - `Compute_Q_sB` (Gram-matrix precision Q = a^4 G + C + a^2 (M + M^T)
   assembled from numerically integrated inner products on a grid of step
   `accuracy`): R/01_utility.R:67-174
 - `global_poly_helper_sGP` (cos/sin harmonics): R/01_utility.R:430-440

All host-side NumPy, float64, einsum-based (the reference loops over ~30
sparse-matrix triple products; here each Gram block is one weighted matmul).
"""
from __future__ import annotations

import numpy as np

from .bsplines import eval_bspline_basis


def compute_B_sB(x, a: float, k: int, region, boundary: bool = True) -> np.ndarray:
    """[B*cos(ax) | B*sin(ax) | B] design columns. Reference R/01_utility.R:177-195."""
    x = np.asarray(x, dtype=np.float64)
    lo, hi = float(np.min(region)), float(np.max(region))
    dropind = (1, 2) if boundary else ()
    B = eval_bspline_basis(x, lo, hi, nbasis=k, norder=4, deriv=0, dropind=dropind)
    c = np.cos(a * x)[:, None]
    s = np.sin(a * x)[:, None]
    return np.concatenate([B * c, B * s, B], axis=1)


def compute_B_sB_helper(refined_x, a: float, k: int, m: int, region,
                        boundary: bool = True, initial_location=None) -> np.ndarray:
    """Harmonic stacking over i=1..m. Reference R/01_utility.R:198-208."""
    refined_x = np.asarray(refined_x, dtype=np.float64)
    if initial_location is None:
        initial_location = refined_x.min()
    xs = refined_x - initial_location
    blocks = [compute_B_sB(xs, a * i, k, region, boundary) for i in range(1, m + 1)]
    return np.concatenate(blocks, axis=1)


def global_poly_sgp(refined_x, a: float, m: int, initial_location=None) -> np.ndarray:
    """[cos(i a x), sin(i a x)]_{i=1..m} harmonics. Reference
    global_poly_helper_sGP, R/01_utility.R:430-440: initial_location=None
    re-centers at min(refined_x), matching the reference's NULL default
    (and compute_B_sB_helper's convention); pass 0.0 for no shift."""
    refined_x = np.asarray(refined_x, dtype=np.float64)
    if initial_location is None:
        initial_location = refined_x.min()
    refined_x = refined_x - initial_location
    cols = []
    for i in range(1, m + 1):
        cols.append(np.cos(i * a * refined_x))
        cols.append(np.sin(i * a * refined_x))
    return np.stack(cols, axis=1)


def compute_Q_sB(a: float, k: int, region, accuracy: float = 0.01,
                 boundary: bool = True) -> np.ndarray:
    """Precision of one sB harmonic block: Q = a^4 G + C + a^2 (M + M^T).

    G, C, M are Gram matrices of the sB basis (phi), its second derivative,
    and their cross products, numerically integrated with left-Riemann
    weights diff(c(0, x)) on the `accuracy` grid — replicated exactly from
    the reference (R/01_utility.R:67-174), including the first weight being
    min(region) - 0.
    """
    lo, hi = float(np.min(region)), float(np.max(region))
    # R's seq(lo, hi, by=accuracy) — stops at the last point <= hi (+ fp slop)
    nsteps = int(np.floor((hi - lo) / accuracy + 1e-10))
    x = lo + accuracy * np.arange(nsteps + 1)

    # Every Gram block is S_dx^T diag(w * mult) S_dy with S_d the SPARSE
    # (N, k) design of the d-th derivative (<= 4 nonzeros/row) and
    # mult in {1, c, s, c^2, s^2, cs}: banded O(N) products instead of
    # 33 dense (k, N)(N, k) matmuls (~100x at k=400, accuracy grids 1e4+).
    from .bsplines import sparse_design
    # the seq endpoint can overshoot hi by an ulp (fp accuracy steps);
    # clip the basis coordinates only (trig/weights keep the exact grid)
    xb = np.clip(x, lo, hi)
    S = [sparse_design(xb, lo, hi, k, 4, deriv=r).tocsr() for r in range(3)]
    ST = [Sd.T.tocsr() for Sd in S]
    # grid-row index of each stored nonzero (for O(nnz) row scaling)
    Srows = [np.repeat(np.arange(Sd.shape[0]), np.diff(Sd.indptr))
             for Sd in S]
    keep = None
    if boundary:
        # dropind=(1, 2) is 1-based (fda): drop basis functions 0 and 1
        keep = np.arange(2, k)

    c = np.cos(a * x)
    s = np.sin(a * x)
    w = np.diff(np.concatenate([[0.0], x]))  # left-Riemann weights, first = lo

    def gram(dx, dy, mult):
        Sy = S[dy].copy()
        Sy.data = S[dy].data * (w * mult)[Srows[dy]]
        G = (ST[dx] @ Sy).toarray()
        return G[np.ix_(keep, keep)] if keep is not None else G

    one = np.ones_like(x)
    cc, ss_, cs = c * c, s * s, c * s

    def ss(Mm):
        return Mm + Mm.T

    # T blocks (cos-cos), L (sin-sin), I (sin-cos)
    T00, T10, T11 = gram(0, 0, cc), gram(1, 0, cc), gram(1, 1, cc)
    T20, T21, T22 = gram(2, 0, cc), gram(2, 1, cc), gram(2, 2, cc)
    L00, L10, L11 = gram(0, 0, ss_), gram(1, 0, ss_), gram(1, 1, ss_)
    L20, L21, L22 = gram(2, 0, ss_), gram(2, 1, ss_), gram(2, 2, ss_)
    I00, I10, I11 = gram(0, 0, cs), gram(1, 0, cs), gram(1, 1, cs)
    I20, I21, I22 = gram(2, 0, cs), gram(2, 1, cs), gram(2, 2, cs)

    BB, B2B2, BB2 = gram(0, 0, one), gram(2, 2, one), gram(0, 2, one)
    BS, BC = gram(0, 0, s), gram(0, 0, c)
    BS1, BC1 = gram(0, 1, s), gram(0, 1, c)
    BS2, BC2 = gram(0, 2, s), gram(0, 2, c)
    B2S, B2C = gram(2, 0, s), gram(2, 0, c)
    B2S1, B2C1 = gram(2, 1, s), gram(2, 1, c)
    B2S2, B2C2 = gram(2, 2, s), gram(2, 2, c)

    a2, a3, a4 = a ** 2, a ** 3, a ** 4

    G = np.block([[T00, I00.T, BC.T],
                  [I00, L00, BS.T],
                  [BC, BS, BB]])

    C11 = T22 - 2 * a * ss(I21) - a2 * ss(T20) + 2 * a3 * ss(I10) + 4 * a2 * L11 + a4 * T00
    C22 = L22 + 2 * a * ss(I21) - a2 * ss(L20) - 2 * a3 * ss(I10) + 4 * a2 * T11 + a4 * L00
    C12 = (I22 + 2 * a * T21 - a2 * ss(I20) - 2 * a * L21.T - 4 * a2 * I11
           + 2 * a3 * L10 - 2 * a3 * T10.T + a4 * I00)
    C13 = B2C2.T - 2 * a * B2S1.T - a2 * B2C.T
    C23 = B2S2.T + 2 * a * B2C1.T - a2 * B2S.T
    C33 = B2B2
    C = np.block([[C11, C12, C13],
                  [C12.T, C22, C23],
                  [C13.T, C23.T, C33]])

    M11 = T20.T - 2 * a * I10.T - a2 * T00
    M12 = I20.T + 2 * a * T10.T - a2 * I00
    M21 = I20.T - 2 * a * L10.T - a2 * I00
    M22 = L20.T + 2 * a * I10.T - a2 * L00
    M13 = B2C.T
    M23 = B2S.T
    M31 = BC2 - 2 * a * BS1 - a2 * BC
    M32 = BS2 + 2 * a * BC1 - a2 * BS
    M33 = BB2
    M = np.block([[M11, M12, M13],
                  [M21, M22, M23],
                  [M31, M32, M33]])

    Q = a4 * G + C + a2 * ss(M)
    # Matrix::forceSymmetric uses the upper triangle (R/01_utility.R:173)
    return np.triu(Q) + np.triu(Q, 1).T


def compute_Q_sgp_stacked(a: float, k: int, m: int, region,
                          accuracy: float = 0.01, boundary: bool = True) -> np.ndarray:
    """Block-diagonal stack of harmonic precisions (reference
    `compute_P` sGP method, R/01_utility.R:255-272).

    Note the reference calls Compute_Q_sB there WITHOUT forwarding
    `boundary` (always its default TRUE) — replicated via default arg.
    """
    blocks = [compute_Q_sB(a * i, k, region, accuracy, boundary)
              for i in range(1, m + 1)]
    size = sum(b.shape[0] for b in blocks)
    Q = np.zeros((size, size))
    off = 0
    for b in blocks:
        Q[off:off + b.shape[0], off:off + b.shape[0]] = b
        off += b.shape[0]
    return Q
