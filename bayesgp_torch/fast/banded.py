"""Multi-term banded backend: one IWP or sGP driver term in a band, the
other terms in a dense tail.

The counterpart of bayesgp_tpu/fast/banded.py. The
latent is split as

    [ V (driver coefficients, banded coupling) | tail t ]
    tail t = [ other terms' U blocks | boundary betas | fixed effects ]

and the conditional Hessian is an arrowhead

    H = [[ Bd^T D Bd + e^{th_drv} P_drv (+ diagonal terms)   (band W),  C ],
         [ C^T,                                          Hd(theta)     ]]

factored by linalg/band_arrow's engine: the CUDA band kernels on a card
(K1-K5 at any band up to 125 and any tail), the blocked dense kernels
(K6/K7) for a tail of 256 columns or more, and their plain versions on
the CPU.

Merged IID. An IID term with many levels (a lazy term: no dense design)
whose levels cluster in x, such as an observation-bin random effect, is
interleaved into the driver band (_merge_iid_into_band): period Pm = 1 +
Gi columns, the driver column b at b*Pm and its levels after it, unused
slots padded with a unit-precision empty coordinate. The IID precision
e^{theta} I then enters the band's diagonal (BandDiagTerm), the band
widens to Wl = span * Pm, and no (q, q) tail forms. Levels that scatter
over x are refused there; up to 4,000 of them are then densified into the
tail with a warning, and above that the model goes to the scatter_iid
engine (api.py).

sGP driver. The sB design [B cos | B sin | B] x m harmonics is reordered
by interleaving its G = 3m groups per B-spline index (_sgp_interleave_perm):
every data row then touches one contiguous window of Wl = 4G columns and
the precision Q, block-diagonal over harmonics, becomes banded with the
same width. There is no coordinate change (U = V in interleaved order,
logdetT = 0); the samples return to the reference order through the
permutation. The prior's quadratic is a sum of squares as for an IWP
driver: Tdiags holds the band of a root T of Q (T^T T = Q, T lower,
prior_w = 1), taken from a banded Cholesky of the reversed Q, and
`T_is_root` keeps `sample` from applying it.

The O(n) products, the prior, the inner Newton and the implicit-function
theta gradient are fast/iwp.FastIWPBackend's, which this class extends
with the driver's theta index, the diagonal band terms and the tail
terms' priors. Its `p` is the band's width less one (Wl - 1), not the
IWP order. The likelihood is any elementwise family; the Gaussian's
noise theta comes last. The TPU package's MXU chunk design, mixed
compute dtype, data sharding and fused s > 1 programs are not ported.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..basis import reparam
from ..device import DTYPE
from ..linalg.band_arrow import BandArrowEngine
from .iwp import FastIWPBackend

# a refused merge densifies the IID term into the tail up to this many
# levels; above it the model needs the scatter_iid engine
DENSIFY_MAX = 4000


def _choose_block(d: int, bw: int) -> int:
    """Block size >= bandwidth + 1 (the JAX package's latent padding)."""
    lo = bw + 1
    if d >= 1024:
        return max(128, lo)
    if d >= 256:
        return max(32, lo)
    return max(8, lo)


@dataclasses.dataclass
class TailTermBlock:
    """A non-driver smooth or random effect living in the dense tail."""
    offset: int          # offset of its U block within the tail vector
    size: int
    theta_idx: int       # index into theta
    P: Any               # (size, size) penalty
    logPdet: float
    d_size: int          # = size (the 0.5 * d * theta term)


@dataclasses.dataclass
class BandDiagTerm:
    """A theta-scaled diagonal prior component inside the band: the
    merged IID levels at band columns mask == 1, precision e^theta I."""
    theta_idx: int
    mask: Any            # (d,) 1.0 at this term's band columns
    d_size: int          # number of real levels (excludes padding)
    logPdet: float       # log det of P = I -> 0.0
    Z0PZ0: Any           # (q, q) Z0^T diag(mask) Z0


@dataclasses.dataclass
class BandedBackend(FastIWPBackend):
    """Multi-term banded arrowhead backend on one device. Latent state
    (V', t); draws come back in the reference order [U_1.. | betas |
    fixed] (ref_perm), padded merged slots dropped."""
    drv_theta: int = 0          # the driver's theta index
    G: int = 1                  # column stride of the window starts
    d_drv: int = 0              # rank entering 0.5 * d * theta_drv
    logPdet_drv: float = 0.0
    tail_terms: tuple = ()      # TailTermBlock
    band_terms: tuple = ()      # BandDiagTerm
    prior_diag_band: Any = None  # (d,) unit prior of padded slots, or None
    Z0PZ0_pad: Any = None       # (q, q) Z0^T diag(prior_diag_band) Z0
    w_real: Optional[int] = None  # real latent coordinates (no padding)
    ref_perm: Any = None        # (w_ref,) backend -> reference rows
    T_is_root: bool = False     # Tdiags is the prior's root only (sGP)

    def __post_init__(self):
        super().__post_init__()
        W, dev = self.p + 1, self.device
        # the lower pairs (a, b), a = b + o, of the band's outer products,
        # offset by offset: pair (b + o, b) adds its segment sum at band
        # row b + j to band[j, o], i.e. column p - b + j of its shifted row
        pa, pb = zip(*[(b + o, b) for o in range(W) for b in range(W - o)])
        self._pa = torch.tensor(pa, device=dev)
        self._pb = torch.tensor(pb, device=dev)
        self._pair_cols = (self.p - self._pb[:, None]
                           + torch.arange(self.dpad, device=dev)[None, :])
        ends = np.cumsum([W - o for o in range(W)])
        self._offset_rows = list(zip(ends - np.arange(W, 0, -1), ends))

    @property
    def Wl(self):
        return self.p + 1

    @property
    def em_dims(self):
        """Per-theta penalized dimensions (see FastIWPBackend.em_dims):
        the driver's d_drv, each tail or band term's size at its theta
        index, and n for the Gaussian noise theta."""
        dims = np.zeros(self.n_theta)
        dims[self.drv_theta] = self.d_drv
        for t in self.tail_terms + self.band_terms:
            dims[t.theta_idx] = t.d_size
        dims[dims == 0] = self.md.n
        return dims

    @property
    def w_count(self):
        return self.w_real if self.w_real is not None else self.d + self.q

    def _band_extra_diag(self, theta):
        """Diagonal prior inside the band: the theta-scaled level masks
        plus the unit diagonal of padded slots; None without them."""
        if not self.band_terms and self.prior_diag_band is None:
            return None
        diag = self.valsT.new_zeros(self.d)
        for bt in self.band_terms:
            diag = diag + torch.exp(theta[bt.theta_idx]) * bt.mask
        if self.prior_diag_band is not None:
            diag = diag + self.prior_diag_band
        return diag

    def _pad_d(self, v):
        """(d,) or (d, r) -> zero rows up to dpad."""
        pad = self.dpad - self.d
        return F.pad(v, (0, pad)) if v.dim() == 1 else F.pad(v, (0, 0, 0, pad))

    # -- Hessian blocks -------------------------------------------------
    def band_H(self, wts, theta):
        """(dpad, Wl) lower band of B^T diag(wts) B + e^th P_drv + the
        diagonal terms, row j column o = H[j+o, j], identity beyond d."""
        W = self.Wl
        outers = wts * self.valsT[self._pa] * self.valsT[self._pb]
        Mp = self._shifts(self._segsum(outers))   # (pairs, p + dpad)
        G = Mp.gather(1, self._pair_cols)         # (pairs, dpad)
        band = torch.stack([G[lo:hi].sum(0) for lo, hi in self._offset_rows],
                           dim=1)
        prior = torch.exp(theta[self.drv_theta]) * self.P_band.T  # (d, Wl)
        extra = self._band_extra_diag(theta)
        if extra is not None:
            prior = prior + F.pad(extra[:, None], (0, W - 1))
        return band + self._pad_d(prior) + self._pad_eye

    def C_block(self, wts, theta):
        """Cross block B^T diag(wts) XFp - e^th P Z0 - diag(extra) Z0."""
        if not self.q:
            return self.valsT.new_zeros((self.dpad, 0))
        Mp = self._shifts(self._segsum(self.valsT[:, None, :]
                                       * (wts * self.XFpT)[None]))
        C = sum(self._at(Mp[a], a) for a in range(self.Wl)).T
        corr = torch.exp(theta[self.drv_theta]) * self.PZ0
        extra = self._band_extra_diag(theta)
        if extra is not None:
            corr = corr + extra[:, None] * self.Z0
        return C - self._pad_d(corr)

    def _tail_prior_mat(self, theta):
        """diag(prior_diag_tail) + sum_r e^{th_r} P_r, (q, q)."""
        Hd = torch.diag(self.prior_diag_tail)
        for tb in self.tail_terms:
            lo, hi = tb.offset, self.q - tb.offset - tb.size
            Hd = Hd + F.pad(torch.exp(theta[tb.theta_idx]) * tb.P,
                            (lo, hi, lo, hi))
        return Hd

    def tail_gram(self, wts, theta):
        """Tail block Hd(theta) of the Hessian, (q, q)."""
        Hd = ((self.XFpT * wts) @ self.XFpT.T
              + torch.exp(theta[self.drv_theta]) * self.Z0PZ0
              + self._tail_prior_mat(theta))
        for bt in self.band_terms:
            Hd = Hd + torch.exp(theta[bt.theta_idx]) * bt.Z0PZ0
        if self.prior_diag_band is not None:
            Hd = Hd + self.Z0PZ0_pad
        return Hd

    # -- prior ------------------------------------------------------------
    def _tail_prior_quad(self, tail, theta):
        quad = (self.prior_diag_tail
                * (tail - self.prior_mean_tail) ** 2).sum()
        for tb in self.tail_terms:
            tr = tail[tb.offset:tb.offset + tb.size]
            quad = quad + torch.exp(theta[tb.theta_idx]) * (tr @ (tb.P @ tr))
        return quad

    def _tail_prior_grad(self, tail, theta):
        g = self.prior_diag_tail * (tail - self.prior_mean_tail)
        for tb in self.tail_terms:
            tr = tail[tb.offset:tb.offset + tb.size]
            gr = torch.exp(theta[tb.theta_idx]) * (tb.P @ tr)
            g = g + F.pad(gr, (tb.offset, self.q - tb.offset - tb.size))
        return g

    def _band_diag_terms(self, theta):
        """(precision scale or None, diagonal) of each diagonal prior term
        in the band: the merged levels, then the padded slots."""
        terms = [(torch.exp(theta[bt.theta_idx]), bt.mask)
                 for bt in self.band_terms]
        if self.prior_diag_band is not None:
            terms.append((None, self.prior_diag_band))
        return terms

    def _prior_neg(self, Vp, tail, theta):
        """Non-likelihood part of the joint negative log posterior. The
        driver's quadratic is a sum of squares (FastIWPBackend), and so
        is each diagonal term's, sum dvec (V' - Z0 t)^2."""
        V = self.to_V(Vp, tail)
        th_d = theta[self.drv_theta]
        lp = -0.5 * torch.exp(th_d) * self.prior_quad(V)
        lp = lp + 0.5 * (self.d_drv * th_d + self.logPdet_drv)
        for lr, dvec in self._band_diag_terms(theta):
            qr = (dvec * V * V).sum()
            lp = lp - 0.5 * (qr if lr is None else lr * qr)
        for bt in self.band_terms:
            lp = lp + 0.5 * (bt.d_size * theta[bt.theta_idx] + bt.logPdet)
        if self.q:
            lp = lp - 0.5 * self._tail_prior_quad(tail, theta)
            for tb in self.tail_terms:
                lp = lp + 0.5 * (tb.d_size * theta[tb.theta_idx]
                                 + tb.logPdet)
        phi = self._phi
        lpT = (torch.log(0.5 * phi) - phi * torch.exp(-0.5 * theta)
               - 0.5 * theta).sum()
        return -(lp + lpT)

    def grad_parts(self, Vp, tail, theta, r):
        """Gradient of neg_log_post in primed coordinates given the
        likelihood residual r = d(-ll)/d eta: the prior's part on V is
        g = e^th P V + sum dvec V (V = V' - Z0 t), and -Z0^T g on t."""
        V = self.to_V(Vp, tail)
        g = torch.exp(theta[self.drv_theta]) * self.prior_grad(V)
        for lr, dvec in self._band_diag_terms(theta):
            g = g + (dvec * V if lr is None else lr * (dvec * V))
        if self.q:
            gt = (self.XFpT @ r - self.Z0.T @ g
                  + self._tail_prior_grad(tail, theta))
        else:
            gt = tail.new_zeros(0)
        return self.Bt(r) + self._pad_d(g), gt

    # -- posterior draws --------------------------------------------------
    def to_U(self, V):
        """Reference coefficients of the driver: T V, or V itself where T
        is only the prior's root (an sGP driver)."""
        return V if self.T_is_root else self.apply_T(V)

    def sample(self, states, idx, zb, zd):
        """(w_ref, M) mixture draws in reference order (padded merged
        slots dropped); see FastIWPBackend.sample."""
        return super().sample(states, idx, zb, zd)[self.ref_perm]


# ---------------------------------------------------------------------------
# host build (numpy, f64)
# ---------------------------------------------------------------------------

def _sgp_interleave_perm(kb: int, G: int) -> np.ndarray:
    """perm[j_inter] = j_group for the group -> interleaved reorder. Group
    order (the reference's layout): column g*kb + b (g = 3*(i-1) + {cos,
    sin, plain} of harmonic i, b the B-spline index); interleaved: column
    b*G + g."""
    j_group = np.arange(kb * G).reshape(G, kb)      # [g, b]
    return j_group.T.reshape(-1)                    # [b*G + g]


def _band_from_dense(P: np.ndarray, bw: int) -> np.ndarray:
    """(bw+1, d) lower band storage of P; asserts bandedness."""
    d = P.shape[0]
    band = np.zeros((bw + 1, d))
    for o in range(bw + 1):
        band[o, :d - o] = np.diagonal(P, -o)
    if d > bw + 1:
        tail = np.tril(P, -(bw + 1))
        assert np.abs(tail).max() <= 1e-9 * max(1.0, np.abs(P).max()), \
            "driver precision is not banded at the declared bandwidth"
    return band


def _band_root(P_band: np.ndarray) -> np.ndarray:
    """(W, d) band of the lower root T of the banded SPD P (T^T T = P),
    as FastIWPBackend.Tdiags stores it ([o, j] = T[j, j-o]): the Cholesky
    factor L' of the reversed matrix J P J gives T = J L'^T J."""
    from scipy.linalg import cholesky_banded

    W, d = P_band.shape
    rev = np.zeros_like(P_band)
    for o in range(W):
        rev[o, :d - o] = P_band[o, :d - o][::-1]
    Lr = cholesky_banded(rev, lower=True)
    T = np.zeros_like(P_band)
    for o in range(W):
        T[o, o:] = Lr[o, :d - o][::-1]
    return T


def _sgp_sparse_rows(term):
    """Sparse-window rows of the interleaved sB design: (vals (n, W),
    start (n,), kb, G), row i of the interleaved design equal to vals[i]
    at columns start[i]..start[i]+W-1. All 3m groups share the 4-wide
    B-spline support, so interleaving makes it one contiguous 4G window.
    A term built without its dense design (materialize_B=False) takes
    its windows from x (_sgp_sparse_rows_from_x); otherwise they are cut
    from term.B."""
    if term.B is None and term.x_data is not None:
        return _sgp_sparse_rows_from_x(term)
    Bg = np.asarray(term.ensure_B(), np.float64)   # (n, 3m*kb), group order
    G = 3 * term.m
    kb = Bg.shape[1] // G
    if kb < 4:
        raise ValueError("an sGP banded driver needs k >= 6 (kb >= 4)")
    Bi = Bg[:, _sgp_interleave_perm(kb, G)]
    W, n = 4 * G, Bi.shape[0]
    # first active B-spline index of each row, from the plain block
    nz = Bg[:, 2 * kb:3 * kb] != 0.0
    first = np.where(nz.any(axis=1), nz.argmax(axis=1), 0)
    start = (np.clip(first, 0, kb - 4) * G).astype(np.int64)
    vals = Bi[np.arange(n)[:, None], start[:, None] + np.arange(W)[None, :]]
    total, covered = np.abs(Bi).sum(), np.abs(vals).sum()
    assert abs(total - covered) <= 1e-9 * max(total, 1.0), \
        "sGP window extraction missed design mass"
    return vals, start, kb, G


def _sgp_sparse_rows_from_x(term):
    """_sgp_sparse_rows from the (shifted) x values in O(n), never forming
    the dense (n, 3m kb) design: each sB group column is a B-spline column
    times a row's cos/sin/1 multiplier, so row i's 4G window is the outer
    product of its 4 B-spline values with its G multipliers."""
    from ..basis.bsplines import eval_bspline_basis, sparse_design

    xs = np.asarray(term.x_data, np.float64)
    k, m = term.k, term.m
    lo, hi = float(np.min(term.region)), float(np.max(term.region))
    kb = k - 2                       # the fit's boundary=True drops two
    if kb < 4:
        raise ValueError("an sGP banded driver needs k >= 6 (kb >= 4)")
    G, n = 3 * m, len(xs)
    vals4 = np.zeros((n, 4))
    start_b = np.zeros(n, np.int64)
    inside = (xs >= lo) & (xs <= hi)
    if inside.any():
        S = sparse_design(xs[inside], lo, hi, k, 4, deriv=0).tocsr()
        # BSpline.design_matrix stores 4 contiguous columns a row
        data4 = S.data.reshape(-1, 4)
        cold = S.indices.reshape(-1, 4).astype(np.int64) - 2  # dropped
        sb = np.clip(cold[:, 0], 0, kb - 4)
        off = cold - sb[:, None]
        ok = (cold >= 0) & (off >= 0) & (off <= 3)
        ridx = np.broadcast_to(np.arange(len(sb))[:, None], off.shape)
        v_in = np.zeros((len(sb), 4))
        v_in[ridx[ok], off[ok]] = data4[ok]
        vals4[inside] = v_in
        start_b[inside] = sb
    if (~inside).any():
        # outside the region: the boundary-dropped basis evaluated
        # densely at those rows, windowed
        xo = xs[~inside]
        Bo = eval_bspline_basis(xo, lo, hi, k, 4, deriv=0, dropind=(1, 2))
        so = np.where(xo > hi, kb - 4, 0).astype(np.int64)
        vals4[~inside] = Bo[np.arange(len(xo))[:, None],
                            so[:, None] + np.arange(4)[None, :]]
        start_b[~inside] = so
        outside_mass = np.abs(Bo).sum() - np.abs(vals4[~inside]).sum()
        assert outside_mass <= 1e-9 * max(np.abs(Bo).sum(), 1.0), \
            "sGP window extraction missed design mass (outside region)"
    # group multipliers in group order: per harmonic i, [cos, sin, 1]
    mults = np.empty((n, G))
    for i in range(1, m + 1):
        mults[:, 3 * (i - 1)] = np.cos(term.a * i * xs)
        mults[:, 3 * (i - 1) + 1] = np.sin(term.a * i * xs)
        mults[:, 3 * (i - 1) + 2] = 1.0
    vals = (vals4[:, :, None] * mults[:, None, :]).reshape(n, 4 * G)
    return vals, (start_b * G).astype(np.int64), kb, G


def _merge_iid_into_band(vals_d, start_d, p1, d_drv, P_band_d, Tdiags_d,
                         codes, q):
    """Interleave q IID level coefficients into the IWP driver band.

    Layout: periods of Pm = 1 + Gi merged columns, driver column b at
    b*Pm, its levels at b*Pm + 1 + g (g < Gi; unused slots are padded
    with a unit-precision empty coordinate). Level j maps to the period
    of the median driver window start among its rows, spilling past a
    capacity of ceil(q / d_drv) levels a period. The merge is refused
    (ValueError) when a row's level lies more than a few periods from
    its driver window: levels that scatter over x.

    Returns (vals_m, start_m, P_band_m, Tdiags_m, Pm, Wl, d_m, iid_cols,
    pad_cols); P_band_m holds only the driver's entries (the IID
    diagonal enters theta-scaled through BandDiagTerm.mask)."""
    n = len(start_d)
    counts = np.bincount(codes, minlength=q)
    order_lv = np.argsort(codes, kind="stable")
    sorted_starts = start_d[order_lv]
    ends = np.cumsum(counts)
    med_idx = np.minimum(ends - counts + counts // 2, n - 1)
    lev_period = np.clip(sorted_starts[med_idx], 0, d_drv - 1)

    # capacity-capped rebalancing: spill overflow to later periods
    cap = max(1, -(-q // d_drv))
    cnt_nat = np.zeros(d_drv, np.int64)
    for j in np.argsort(lev_period, kind="stable"):
        t = int(lev_period[j])
        while cnt_nat[t] >= cap and t < d_drv - 1:
            t += 1
        lev_period[j] = t
        cnt_nat[t] += 1

    row_lev = lev_period[codes]
    row_off = row_lev - start_d
    span = int(max(int(row_off.max(initial=0)), p1 - 1)
               - min(int(row_off.min(initial=0)), 0) + 1)
    limit = p1 + 8
    if span > d_drv:
        raise ValueError(
            f"merged-IID window span {span} exceeds the driver dimension "
            f"{d_drv}; the driver term is too small to band-merge")
    if span > limit:
        raise ValueError(
            f"merged-IID band span {span} knot intervals exceeds {limit}: "
            "the IID levels are not x-clustered against the driver")

    percnt = np.bincount(lev_period, minlength=d_drv)
    Pm = 1 + int(percnt.max())
    d_m = d_drv * Pm
    slot = np.zeros(q, np.int64)
    seen = np.zeros(d_drv, np.int64)
    for j in np.argsort(lev_period, kind="stable"):
        t = lev_period[j]
        slot[j] = seen[t]
        seen[t] += 1
    iid_cols = lev_period * Pm + 1 + slot
    used = np.zeros(d_m, bool)
    used[np.arange(d_drv) * Pm] = True
    used[iid_cols] = True
    pad_cols = np.nonzero(~used)[0]

    Wl = span * Pm
    base = np.minimum(start_d, row_lev)
    base = np.minimum(base, d_drv - span)      # keep the window inside d_m
    base = np.maximum(base, 0)
    vals_m = np.zeros((n, Wl), vals_d.dtype)
    rows = np.arange(n)
    for a in range(p1):
        vals_m[rows, (start_d - base + a) * Pm] = vals_d[:, a]
    lev_rel = (row_lev - base) * Pm + 1 + slot[codes]
    vals_m[rows, lev_rel] += 1.0
    start_m = base * Pm

    P_band_m = np.zeros((Wl, d_m))
    for o in range(min(P_band_d.shape[0], span)):
        P_band_m[o * Pm, np.arange(d_drv - o) * Pm] = P_band_d[o, :d_drv - o]

    # driver T at stride Pm; identity on level and padded columns
    Tdiags_m = np.zeros(((p1 - 1) * Pm + 1, d_m))
    for o in range(p1):
        cols = np.arange(o, d_drv)
        Tdiags_m[o * Pm, cols * Pm] = Tdiags_d[o, o:]
    Tdiags_m[0, iid_cols] = 1.0
    if len(pad_cols):
        Tdiags_m[0, pad_cols] = 1.0
    return (vals_m, start_m, P_band_m, Tdiags_m, Pm, Wl, d_m, iid_cols,
            pad_cols)


def build_banded_backend(instances, md, design_mat_fixed, bf_prec, bf_mean,
                         device="cuda", driver_idx=None):
    """BandedBackend of a multi-term model with an IWP or sGP driver on
    `device`.

    instances: the TermDesigns (IWP, sGP, IID, Customized); the driver is
    the largest sGP or IWP term with nonnegative knots (or `driver_idx`).
    A lazy IID term (no dense design) is merged into an IWP driver's band
    when its levels cluster in x; otherwise, with at most DENSIFY_MAX
    levels, it is densified into the tail with a warning, and above that
    ValueError is raised (the caller may take the scatter_iid engine)."""
    from scipy.linalg import solveh_banded

    if md.family not in (0, 1, 2):
        raise ValueError("the banded backend needs the Gaussian, Poisson "
                         "or Binomial family")
    if driver_idx is None:
        eligible = [i for i, t in enumerate(instances)
                    if t.kind in ("IWP", "sGP")
                    and (t.kind != "IWP" or np.asarray(t.knots).min() >= 0)]
        if not eligible:
            raise ValueError("banded backend needs an IWP or sGP term")
        driver_idx = max(eligible, key=lambda i: instances[i].num_basis)
    drv = instances[driver_idx]

    # ---- driver banded structures ----
    if drv.kind == "IWP":
        p = drv.order
        knots = np.asarray(drv.knots, np.float64)
        if knots.min() < 0:
            raise ValueError("banded IWP driver requires nonnegative knots")
        d = len(knots) - 1
        G, Wl = 1, p + 1
        vals, start = reparam.sparse_rows(drv.x_data, knots, p)
        P_band_d, logdetT, T = reparam.prior_band(knots, p)
        P_band = np.zeros((Wl, d))
        P_band[:P_band_d.shape[0]] = P_band_d
        Tdiags = np.zeros((p + 1, d))
        for o in range(p + 1):
            Tdiags[o, o:] = np.diagonal(T, -o)
        drv_ref = np.arange(d)       # reference column of driver column j
    else:                            # sGP: interleaved, no coordinate change
        vals, start, kb, G = _sgp_sparse_rows(drv)
        Wl, d = 4 * G, kb * G
        drv_ref = _sgp_interleave_perm(kb, G)
        Qi = np.asarray(drv.P, np.float64)[np.ix_(drv_ref, drv_ref)]
        P_band = _band_from_dense(Qi, Wl - 1)
        Tdiags = _band_root(P_band)
        logdetT = 0.0
    logPdet_drv = float(np.asarray(md.logPdet)[driver_idx])
    d_drv = d

    # ---- merged-IID detection (lazy terms: B is None, P = I implied) --
    lazy_iid = [i for i, t in enumerate(instances)
                if i != driver_idx and t.kind == "IID" and t.B is None]
    iid_cols = pad_cols = None
    merged_iid_idx = None
    q_lazy = sum(len(instances[i].levels) for i in lazy_iid)

    def _densify_or_raise(msg):
        if q_lazy <= DENSIFY_MAX:
            warnings.warn(msg + " -- densifying the IID term into the "
                          "tail (O(q^2) memory, fine at this size)")
            for i in lazy_iid:
                instances[i].ensure_B()
            return
        raise ValueError(msg + f" (q={q_lazy} is too large for the "
                         "dense-tail fallback)")

    if len(lazy_iid) > 1:
        _densify_or_raise("merged-IID supports one large IID term")
        lazy_iid = []
    elif lazy_iid and drv.kind != "IWP":
        _densify_or_raise("merged-IID needs an IWP driver term")
        lazy_iid = []
    if lazy_iid:
        i_iid = lazy_iid[0]
        t_iid = instances[i_iid]
        try:
            (vals, start, P_band, Tdiags, G, Wl, d, iid_cols,
             pad_cols) = _merge_iid_into_band(
                vals, start, p + 1, d, P_band_d, Tdiags,
                np.asarray(t_iid.extra["codes"]), len(t_iid.levels))
            merged_iid_idx = i_iid
        except ValueError as e:
            _densify_or_raise(str(e))

    # w of the driver prior P = T^T diag(w) T: diff(knots), at stride G in
    # a merged band (0 on the level and padded columns); 1 for an sGP
    # driver's root
    if drv.kind == "IWP":
        prior_w = np.zeros(d)
        prior_w[np.arange(d_drv) * G] = np.diff(knots)
    else:
        prior_w = np.ones(d)

    bw = Wl - 1
    s = _choose_block(d, bw)
    s = -(-s // G) * G           # a multiple of G, as the JAX package's
    dpad = -(-d // s) * s

    # ---- sort rows by window start ----
    order = np.argsort(start, kind="stable")
    vals = vals[order]
    start = start[order]
    n = len(start)

    # ---- tail assembly: [other U blocks | boundary betas | fixed] ----
    tail_cols, tail_terms, off = [], [], 0
    for i, t in enumerate(instances):
        if i in (driver_idx, merged_iid_idx):
            continue
        Bt_ = t.ensure_B()
        tail_cols.append(np.asarray(Bt_, np.float64))
        tail_terms.append(TailTermBlock(
            offset=off, size=Bt_.shape[1], theta_idx=i,
            P=np.asarray(t.P, np.float64),
            logPdet=float(np.asarray(md.logPdet)[i]), d_size=Bt_.shape[1]))
        off += Bt_.shape[1]
    diag_list, mean_list = [np.zeros(off)], [np.zeros(off)]
    for t in instances:
        if t.X.shape[1] > 0:
            tail_cols.append(np.asarray(t.X, np.float64))
            diag_list.append(np.full(t.X.shape[1], t.boundary_prior["prec"]))
            mean_list.append(np.full(t.X.shape[1], t.boundary_prior["mean"]))
    for c in design_mat_fixed:
        tail_cols.append(np.asarray(c, np.float64).reshape(n, -1))
    diag_list.append(np.asarray(bf_prec, np.float64))
    mean_list.append(np.asarray(bf_mean, np.float64))
    xf_dense = (np.concatenate(tail_cols, axis=1) if tail_cols
                else np.zeros((n, 0)))[order]
    prior_diag_tail = np.concatenate(diag_list)
    prior_mean_tail = np.concatenate(mean_list)
    q = xf_dense.shape[1]

    y = np.asarray(md.y, np.float64)[order]
    size = (np.asarray(md.size, np.float64)[order]
            if np.ndim(md.size) and np.shape(md.size)[0] == n
            else np.asarray(md.size, np.float64))
    md_perm = dataclasses.replace(md, y=y, size=size)

    # ---- penalized tail orthogonalization ----
    if q:
        Gband = np.zeros((Wl, d))
        for o in range(Wl):
            for b in range(Wl - o):
                w_ = vals[:, b + o] * vals[:, b]
                Gband[o] += np.bincount(start + b, weights=w_,
                                        minlength=d)[:d]
        BX = np.zeros((d, q))
        for a in range(Wl):
            cols = np.clip(start + a, 0, d - 1)
            for c in range(q):
                BX[:, c] += np.bincount(cols, weights=vals[:, a]
                                        * xf_dense[:, c], minlength=d)[:d]
        tau = 1e2 * (Gband[0].mean() / max(P_band[0].mean(), 1e-30))
        Gb = Gband + tau * P_band
        Gb[0] += 1e-9 * max(Gband[0].max(), 1.0)
        if pad_cols is not None and len(pad_cols):
            # padded merged slots carry no data or prior mass in Gb
            Gb[0, pad_cols] += 1.0
        Z0 = solveh_banded(Gb, BX, lower=True)
        XFp = xf_dense.copy()
        for a in range(Wl):
            XFp -= vals[:, a, None] * Z0[np.clip(start + a, 0, d - 1), :]
        # P = T' diag(w) T: P Z0 and Z0' P Z0 through G0 = T Z0
        nTo = Tdiags.shape[0]
        G0 = Tdiags[0][:, None] * Z0
        for o in range(1, nTo):
            G0[o:] += Tdiags[o, o:, None] * Z0[:-o]
        wG0 = prior_w[:, None] * G0
        PZ0 = Tdiags[0][:, None] * wG0
        for o in range(1, nTo):
            PZ0[:-o] += Tdiags[o, o:, None] * wG0[o:]
        Z0PZ0 = ((np.sqrt(prior_w)[:, None] * G0).T
                 @ (np.sqrt(prior_w)[:, None] * G0))
    else:
        Z0, PZ0, Z0PZ0 = np.zeros((d, 0)), np.zeros((d, 0)), np.zeros((0, 0))
        XFp = xf_dense

    # ---- reference-order permutation ----
    # backend order [driver U (d) | other U blocks | betas | fixed];
    # reference order [U_1..U_r | beta_1..beta_rX | fixed]
    d_sizes = np.asarray(md.d_sizes)
    w_ref = int(d_sizes.sum() + sum(md.x_sizes) + md.xf_count)
    ref_of_backend = np.zeros(d + q, dtype=np.int64)
    drv_off = int(d_sizes[:driver_idx].sum())
    if merged_iid_idx is not None:
        # driver column b at b*G, level j at iid_cols[j]; padded slots
        # sort past w_ref and are dropped
        ref_of_backend[np.arange(d_drv) * G] = drv_off + np.arange(d_drv)
        iid_off = int(d_sizes[:merged_iid_idx].sum())
        ref_of_backend[iid_cols] = iid_off + np.arange(len(iid_cols))
        ref_of_backend[pad_cols] = w_ref + np.arange(len(pad_cols))
    else:
        ref_of_backend[:d] = drv_off + drv_ref
    pos = d
    for i, t in enumerate(instances):
        if i in (driver_idx, merged_iid_idx):
            continue
        off_r = int(d_sizes[:i].sum())
        ref_of_backend[pos:pos + t.num_basis] = off_r + np.arange(t.num_basis)
        pos += t.num_basis
    beta_off = int(d_sizes.sum())
    for t in instances:
        xc = t.X.shape[1]
        if xc > 0:
            ref_of_backend[pos:pos + xc] = beta_off + np.arange(xc)
            beta_off += xc
            pos += xc
    fix_off = int(d_sizes.sum() + sum(md.x_sizes))
    ref_of_backend[pos:pos + md.xf_count] = fix_off + np.arange(md.xf_count)
    pos += md.xf_count
    n_pad = len(pad_cols) if pad_cols is not None else 0
    assert pos == d + q and pos - n_pad == w_ref
    ref_perm = np.argsort(ref_of_backend)[:w_ref]

    # ---- merged-IID prior components ----
    arrays = dict(
        valsT=np.ascontiguousarray(vals.T), start=start,
        XFpT=np.ascontiguousarray(XFp.T), Z0=Z0, PZ0=PZ0, Z0PZ0=Z0PZ0,
        P_band=P_band, Tdiags=Tdiags, prior_w=prior_w,
        prior_diag_tail=prior_diag_tail, prior_mean_tail=prior_mean_tail,
        ref_perm=ref_perm)
    band_terms = []
    w_real = None
    if merged_iid_idx is not None:
        mask = np.zeros(d)
        mask[iid_cols] = 1.0
        band_terms.append(dict(
            theta_idx=merged_iid_idx, mask=mask, d_size=len(iid_cols),
            logPdet=0.0, Z0PZ0=Z0.T @ (mask[:, None] * Z0)))
        if len(pad_cols):
            pd = np.zeros(d)
            pd[pad_cols] = 1.0
            arrays["prior_diag_band"] = pd
            arrays["Z0PZ0_pad"] = Z0.T @ (pd[:, None] * Z0)
        w_real = w_ref
    scalars = dict(drv_theta=driver_idx, Wl=Wl, G=G, d=d, dpad=dpad,
                   d_drv=d_drv, logPdet_drv=logPdet_drv,
                   logdetT=float(logdetT), w_real=w_real,
                   T_is_root=drv.kind != "IWP")
    tails = [dataclasses.asdict(tb) for tb in tail_terms]
    return from_arrays(drv, md_perm, arrays, scalars, tails, band_terms,
                       row_order=order, device=device)


def from_arrays(term, md, arrays, scalars, tail_terms, band_terms,
                row_order=None, device="cuda"):
    """BandedBackend on `device` from host arrays: rows already sorted by
    window start (md's y and size in that order). arrays: valsT, start,
    XFpT, Z0, PZ0, Z0PZ0, P_band, Tdiags, prior_w, prior_diag_tail,
    prior_mean_tail, ref_perm and, with padded merged slots,
    prior_diag_band and Z0PZ0_pad; scalars: drv_theta, Wl, G, d, dpad,
    d_drv, logPdet_drv, logdetT, w_real and T_is_root; tail_terms /
    band_terms: dicts of the TailTermBlock / BandDiagTerm fields.
    row_order: the build's row sort (raw -> internal), identity when
    None."""
    dev = torch.device(device)

    def f64(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=DTYPE,
                            device=dev).contiguous()

    def i64(a):
        return torch.tensor(np.asarray(a, np.int64), device=dev)

    d, dpad, Wl = int(scalars["d"]), int(scalars["dpad"]), int(scalars["Wl"])
    start = np.asarray(arrays["start"], np.int64)
    counts = np.bincount(start, minlength=d)[:d]
    seg_hi = np.cumsum(counts)
    q = int(np.shape(arrays["XFpT"])[0])
    md_dev = dataclasses.replace(md, y=f64(md.y), size=f64(md.size))
    if row_order is None:
        row_order = np.arange(len(start))
    w_real = scalars.get("w_real")
    return BandedBackend(
        term=term, md=md_dev, p=Wl - 1, d=d, dpad=dpad, q=q,
        valsT=f64(arrays["valsT"]), start=i64(start),
        seg_lo=i64(seg_hi - counts), seg_hi=i64(seg_hi),
        XFpT=f64(arrays["XFpT"]), Z0=f64(arrays["Z0"]),
        PZ0=f64(arrays["PZ0"]), Z0PZ0=f64(arrays["Z0PZ0"]),
        P_band=f64(arrays["P_band"]), Tdiags=f64(arrays["Tdiags"]),
        prior_w=f64(arrays["prior_w"]), logdetT=float(scalars["logdetT"]),
        prior_diag_tail=f64(arrays["prior_diag_tail"]),
        prior_mean_tail=f64(arrays["prior_mean_tail"]),
        engine=BandArrowEngine(dpad, Wl - 1, q),
        row_order=np.asarray(row_order),
        drv_theta=int(scalars["drv_theta"]), G=int(scalars["G"]),
        d_drv=int(scalars["d_drv"]),
        logPdet_drv=float(scalars["logPdet_drv"]),
        tail_terms=tuple(TailTermBlock(**{**tb, "P": f64(tb["P"])})
                         for tb in tail_terms),
        band_terms=tuple(BandDiagTerm(**{**bt, "mask": f64(bt["mask"]),
                                         "Z0PZ0": f64(bt["Z0PZ0"])})
                         for bt in band_terms),
        prior_diag_band=(f64(arrays["prior_diag_band"])
                         if arrays.get("prior_diag_band") is not None
                         else None),
        Z0PZ0_pad=(f64(arrays["Z0PZ0_pad"])
                   if arrays.get("Z0PZ0_pad") is not None else None),
        w_real=None if w_real is None else int(w_real),
        ref_perm=i64(arrays["ref_perm"]),
        T_is_root=bool(scalars.get("T_is_root", False)))
