"""Multi-term banded backend: one IWP driver term in a band, the other
terms in a dense tail.

The counterpart of bayesgp_tpu/fast/banded.py for an IWP driver. The
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

The O(n) products, the prior, the inner Newton and the implicit-function
theta gradient are fast/iwp.FastIWPBackend's, which this class extends
with the driver's theta index, the diagonal band terms and the tail
terms' priors. Its `p` is the band's width less one (Wl - 1), not the
IWP order. The TPU package's MXU chunk design, mixed compute dtype, data
sharding and fused s > 1 programs are not ported; an sGP driver and the
Gaussian family's noise hyperparameter are not ported yet.
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


def _unported(what):
    return NotImplementedError(
        f"{what} on the multi-term banded backend is not ported to "
        "bayesgp_torch yet (ROADMAP Queue 1 item 6)")


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

    def _diag_quad(self, dvec, Z0PZ0_d, Vd, tail):
        """(V - Z0 t)^T diag(dvec) (V - Z0 t) in primed coordinates."""
        mv = dvec * Vd
        qr = (mv * Vd).sum()
        if self.q:
            qr = qr - 2.0 * torch.dot(tail, self.Z0.T @ mv)
            qr = qr + tail @ (Z0PZ0_d @ tail)
        return qr

    def _prior_neg(self, Vp, tail, theta):
        """Non-likelihood part of the joint negative log posterior."""
        Vd = Vp[:self.d]
        th_d = theta[self.drv_theta]
        quad = self.prior_quad_V(Vp)
        if self.q:
            quad = quad - 2.0 * torch.dot(tail, self.PZ0.T @ Vd)
            quad = quad + tail @ (self.Z0PZ0 @ tail)
        lp = -0.5 * torch.exp(th_d) * quad
        lp = lp + 0.5 * (self.d_drv * th_d + self.logPdet_drv)
        for bt in self.band_terms:
            th = theta[bt.theta_idx]
            lp = lp - 0.5 * torch.exp(th) * self._diag_quad(
                bt.mask, bt.Z0PZ0, Vd, tail)
            lp = lp + 0.5 * (bt.d_size * th + bt.logPdet)
        if self.prior_diag_band is not None:
            lp = lp - 0.5 * self._diag_quad(self.prior_diag_band,
                                            self.Z0PZ0_pad, Vd, tail)
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
        likelihood residual r = d(-ll)/d eta."""
        lam = torch.exp(theta[self.drv_theta])
        Vd = Vp[:self.d]
        pv = self._applyP(Vd)
        if self.q:
            pv = pv - self.PZ0 @ tail
        gVd = lam * pv
        if self.q:
            gt = (self.XFpT @ r + lam * (self.Z0PZ0 @ tail - self.PZ0.T @ Vd)
                  + self._tail_prior_grad(tail, theta))
        else:
            gt = tail.new_zeros(0)
        diag_terms = [(torch.exp(theta[bt.theta_idx]), bt.mask, bt.Z0PZ0)
                      for bt in self.band_terms]
        if self.prior_diag_band is not None:
            diag_terms.append((None, self.prior_diag_band, self.Z0PZ0_pad))
        for lr, dvec, Z0PZ0_d in diag_terms:
            pr = dvec * Vd
            if self.q:
                pr = pr - dvec * (self.Z0 @ tail)
                gr = Z0PZ0_d @ tail - self.Z0.T @ (dvec * Vd)
                gt = gt + (gr if lr is None else lr * gr)
            gVd = gVd + (pr if lr is None else lr * pr)
        return self.Bt(r) + self._pad_d(gVd), gt

    # -- posterior draws --------------------------------------------------
    def sample(self, states, idx, zb, zd):
        """(w_ref, M) mixture draws in reference order (padded merged
        slots dropped); see FastIWPBackend.sample."""
        return super().sample(states, idx, zb, zd)[self.ref_perm]


# ---------------------------------------------------------------------------
# host build (numpy, f64)
# ---------------------------------------------------------------------------

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
    """BandedBackend of a multi-term model with an IWP driver on `device`.

    instances: the TermDesigns (IWP, IID, Customized); the driver is the
    largest IWP term with nonnegative knots (or `driver_idx`). A lazy IID
    term (no dense design) is merged into the band when its levels
    cluster in x; otherwise, with at most DENSIFY_MAX levels, it is
    densified into the tail with a warning, and above that ValueError is
    raised (the caller may take the scatter_iid engine)."""
    from scipy.linalg import solveh_banded

    if md.family == 0:
        raise _unported("the Gaussian family's noise hyperparameter")
    if md.family not in (1, 2):
        raise ValueError("the banded backend needs the Poisson or "
                         "Binomial family")
    if driver_idx is None:
        eligible = [i for i, t in enumerate(instances)
                    if t.kind in ("IWP", "sGP")
                    and (t.kind != "IWP" or np.asarray(t.knots).min() >= 0)]
        if not eligible:
            raise ValueError("banded backend needs an IWP or sGP term")
        driver_idx = max(eligible, key=lambda i: instances[i].num_basis)
    drv = instances[driver_idx]
    if drv.kind != "IWP":
        raise _unported("an sGP driver term")

    # ---- driver banded structures ----
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
        wk = np.diff(knots)
        if merged_iid_idx is not None:
            # driver weights at stride G; level and padded columns none
            wk_m = np.zeros(d)
            wk_m[np.arange(d_drv) * G] = wk
            wk = wk_m
        nTo = Tdiags.shape[0]
        G0 = Tdiags[0][:, None] * Z0
        for o in range(1, nTo):
            G0[o:] += Tdiags[o, o:, None] * Z0[:-o]
        wG0 = wk[:, None] * G0
        PZ0 = Tdiags[0][:, None] * wG0
        for o in range(1, nTo):
            PZ0[:-o] += Tdiags[o, o:, None] * wG0[o:]
        Z0PZ0 = ((np.sqrt(wk)[:, None] * G0).T
                 @ (np.sqrt(wk)[:, None] * G0))
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
        ref_of_backend[:d] = drv_off + np.arange(d)
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
        P_band=P_band, Tdiags=Tdiags, prior_diag_tail=prior_diag_tail,
        prior_mean_tail=prior_mean_tail, ref_perm=ref_perm)
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
                   logdetT=float(logdetT), w_real=w_real)
    tails = [dataclasses.asdict(tb) for tb in tail_terms]
    return from_arrays(drv, md_perm, arrays, scalars, tails, band_terms,
                       row_order=order, device=device)


def from_arrays(term, md, arrays, scalars, tail_terms, band_terms,
                row_order=None, device="cuda"):
    """BandedBackend on `device` from host arrays: rows already sorted by
    window start (md's y and size in that order). arrays: valsT, start,
    XFpT, Z0, PZ0, Z0PZ0, P_band, Tdiags, prior_diag_tail,
    prior_mean_tail, ref_perm and, with padded merged slots,
    prior_diag_band and Z0PZ0_pad; scalars: drv_theta, Wl, G, d, dpad,
    d_drv, logPdet_drv, logdetT, w_real; tail_terms / band_terms: dicts
    of the TailTermBlock / BandDiagTerm fields. row_order: the build's
    row sort (raw -> internal), identity when None."""
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
        logdetT=float(scalars["logdetT"]),
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
        ref_perm=i64(arrays["ref_perm"]))
