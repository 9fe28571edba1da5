"""Banded backend for single-IWP models with elementwise families.

The B-spline reparametrization (basis/reparam.py) turns the IWP design
into sparse rows and its prior into a band:

  latent = [V (banded, d = k-1, padded to dpad) | tail (q)]
  eta    = sparse-row design (p+1 nonzeros a row) + dense tail columns
  H      = [[B^T D B + e^th P_V  (band p+1),   C ],
            [C^T,                            Hd  ]]   (arrowhead)

The O(n) design products are gathers of V at the rows' first active
column plus segment sums over the rows, which are sorted by that column.
A segment sum is an f64 prefix sum over the sorted rows differenced at
the segment boundaries: no atomics, so every run sums in the same order.
The factorization and solves go through linalg/band_arrow's engine (the
CUDA band kernels on a card, their plain versions on the CPU).

Everything is f64. The Laplace value equals the dense reference value
minus the constant log|det T| of the coordinate change, which is
subtracted for parity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..basis import reparam
from ..device import DTYPE
from ..linalg.band_arrow import BandArrowEngine
from ..model import families

LOG2PI = math.log(2.0 * math.pi)
# inner Newton: step floor (relative to max|V|), stall cutoff, iteration cap
STEPTOL = 1e-9
STALL_ITERS = 10
MAX_NEWTON = 100
# a line-search candidate within this relative margin of the best counts
# as tied with it
LS_NOISE = 1e-12
# outer Hessian: central-difference step of the implicit gradient
H_FD = 1e-4


def pad_dim(d: int, p: int) -> int:
    """Latent band length: d rounded up to the block size the JAX package
    uses (128 from d = 1024, 32 from d = 256, else max(8, p+1)), so the
    two packages' latent states line up entry for entry."""
    s = 128 if d >= 1024 else 32 if d >= 256 else max(8, p + 1)
    return -(-d // s) * s


def _finite(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


class HostNodes:
    """The node evaluations and the outer Hessian of the s > 1 host AGHQ
    path (inference/aghq.optimize_theta, _aghq_fit_nd), for a backend
    with laplace_eval_full, value_and_grad and device."""

    def node_eval(self, thetas, warm, keep_states=True):
        """(nlls (J,) numpy, per-node latent state + (factor,), or None):
        each node of the (J, s) thetas evaluated from the same warm
        state."""
        nlls, states = [], []
        for th in np.asarray(thetas, np.float64):
            val, st, factor = self.laplace_eval_full(
                torch.tensor(th, dtype=DTYPE, device=self.device), warm)
            nlls.append(val)
            if keep_states:
                states.append(self.node_pack(st, factor))
        return torch.stack(nlls).cpu().numpy(), (states or None)

    @staticmethod
    def node_pack(st, factor):
        """A node's sampling state, as `sample` reads it: the latent
        state's parts, then the factor."""
        return st + (factor,)

    def hess(self, theta, state):
        """Outer Hessian by central differences (step H_FD) of the
        implicit gradient, every evaluation warm-started from `state`."""
        s = len(theta)
        cols = []
        for i in range(s):
            e = np.zeros(s)
            e[i] = H_FD
            gp = self.value_and_grad(np.asarray(theta) + e, state)[1]
            gm = self.value_and_grad(np.asarray(theta) - e, state)[1]
            cols.append(((gp - gm) / (2 * H_FD)).cpu().numpy())
        H = np.stack(cols)
        return 0.5 * (H + H.T)


@dataclasses.dataclass
class FastIWPBackend(HostNodes):
    """Arrays and Laplace machinery of one single-IWP model on one device.

    Rows are sorted by `start` (the first active V column of each design
    row); `seg_lo`/`seg_hi` bound the rows of each segment. The tail
    design is orthogonalized against the spline basis: internally the
    latent is (V', t) with V = V' - Z0 t, a unit-determinant change of
    coordinates that keeps the Schur complement well scaled."""
    term: Any
    md: Any                 # ModelData, rows permuted, y/size as tensors
    p: int
    d: int                  # k - 1 V coordinates
    dpad: int
    q: int                  # tail size = (p-1) + fixed columns
    valsT: torch.Tensor     # (p+1, n) sparse design rows
    start: torch.Tensor     # (n,) first active column, nondecreasing
    seg_lo: torch.Tensor    # (d,) first row of each segment
    seg_hi: torch.Tensor    # (d,) one past its last row
    XFpT: torch.Tensor      # (q, n) orthogonalized tail design
    Z0: torch.Tensor        # (d, q)
    PZ0: torch.Tensor       # (d, q) P_V Z0
    Z0PZ0: torch.Tensor     # (q, q) Z0' P_V Z0
    P_band: torch.Tensor    # (p+1, d) prior band, [o, j] = P_V[j+o, j]
    Tdiags: torch.Tensor    # (p+1, d) band of U = T V
    prior_w: torch.Tensor   # (d,) w of P_V = T^T diag(w) T: diff(knots)
    logdetT: float
    prior_diag_tail: torch.Tensor  # (q,)
    prior_mean_tail: torch.Tensor  # (q,)
    engine: Any
    row_order: np.ndarray   # (n,) build-time row sort (raw -> internal)

    # the driver's theta index (a multi-term backend's field)
    drv_theta = 0

    def __post_init__(self):
        dev = self.valsT.device
        ar = torch.arange(self.p + 1, device=dev)[:, None]
        # (p+1, n) V column of each design entry
        self._cols = self.start[None, :] + ar
        # the identity block of the padding coordinates V[d:dpad]
        self._pad_eye = torch.zeros((self.dpad, self.p + 1), dtype=DTYPE,
                                    device=dev)
        self._pad_eye[self.d:, 0] = 1.0
        # segment bounds as positions in the rows' inclusive prefix sum:
        # the sum of rows [lo, hi) is cs[hi - 1] - cs[lo - 1], with
        # cs[-1] = 0 (the mask)
        self._seg_prev = (torch.clamp(self.seg_hi - 1, min=0),
                          torch.clamp(self.seg_lo - 1, min=0))
        self._seg_some = (self.seg_hi > 0, self.seg_lo > 0)
        # T's nonzero off-diagonals (all p of one IWP term)
        self._t_offsets = [o for o in range(1, self.Tdiags.shape[0])
                           if bool(self.Tdiags[o].any())]
        self._sqrt_w = torch.sqrt(self.prior_w)
        self._logPdet0 = float(np.asarray(self.md.logPdet)[0])
        self._phi = (-torch.log(torch.as_tensor(self.md.alpha, dtype=DTYPE))
                     / torch.as_tensor(self.md.u, dtype=DTYPE)).to(dev)

    @property
    def device(self):
        return self.valsT.device

    def with_y(self, y):
        """Backend for another response on the same design (replicate
        fits). `y` is in raw data order; it is permuted to the internal
        row sort."""
        y = torch.as_tensor(np.asarray(y, np.float64)[self.row_order],
                            dtype=DTYPE, device=self.device)
        return dataclasses.replace(
            self, md=dataclasses.replace(self.md, y=y))

    @property
    def n_theta(self):
        return self.md.n_theta

    @property
    def em_dims(self):
        """Per-theta penalized dimensions (the coefficient of theta/2 in
        the prior, and n for a Gaussian noise theta) used by the fit's
        EM-style jump."""
        dims = [float(self.d)]
        if self.n_theta > 1:
            dims.append(float(self.md.n))
        return np.asarray(dims)

    @property
    def w_count(self):
        """Latent coordinates counted in the Laplace value's log(2 pi)."""
        return self.d + self.q

    def init_state(self):
        return (torch.zeros(self.dpad, dtype=DTYPE, device=self.device),
                torch.zeros(self.q, dtype=DTYPE, device=self.device))

    # -- O(n) design products ------------------------------------------
    def _segsum(self, rows):
        """(..., n) -> (..., d) sums over each segment's rows."""
        return _SegSum.apply(rows, self)

    def _shifts(self, seg):
        """seg (..., d) zero-padded to (..., p + dpad): the view
        out[..., p - a : p - a + dpad] holds seg[..., j - a] at j."""
        return F.pad(seg, (self.p, self.dpad - self.d))

    def _at(self, padded, a):
        return padded[..., self.p - a:self.p - a + self.dpad]

    def eta(self, Vp, tail):
        """Linear predictor from primed coordinates: B V' + XFp t."""
        return _Eta.apply(Vp, tail, self)

    def Bt(self, u):
        """B^T u -> (dpad,)."""
        sp = self._shifts(self._segsum(self.valsT * u))  # (p+1, p+dpad)
        return sum(self._at(sp[a], a) for a in range(self.p + 1))

    def band_H(self, wts, theta):
        """(dpad, p+1) lower band of B^T diag(wts) B + e^theta P_V, row j
        column o = H[j+o, j], identity beyond d."""
        p = self.p
        outers = wts * self.valsT[:, None, :] * self.valsT[None, :, :]
        Mp = self._shifts(self._segsum(outers))         # (p+1, p+1, p+dpad)
        # band[j, o] = sum_{a-b=o} M[a, b, g] at j = g + b
        band = torch.stack([sum(self._at(Mp[b + o, b], b)
                                for b in range(p + 1 - o))
                            for o in range(p + 1)], dim=1)
        prior = torch.exp(theta[0]) * self.P_band.T     # (d, p+1)
        return band + F.pad(prior, (0, 0, 0, self.dpad - self.d)) \
            + self._pad_eye

    def C_block(self, wts, theta):
        """Cross block B^T diag(wts) XFp - e^theta P Z0 -> (dpad, q)."""
        if not self.q:
            return self.valsT.new_zeros((self.dpad, 0))
        Mp = self._shifts(self._segsum(self.valsT[:, None, :]
                                       * (wts * self.XFpT)[None]))
        C = sum(self._at(Mp[a], a) for a in range(self.p + 1)).T
        corr = torch.exp(theta[0]) * self.PZ0
        return C - F.pad(corr, (0, 0, 0, self.dpad - self.d))

    def tail_gram(self, wts, theta):
        """Tail block XFp^T diag(wts) XFp + e^theta Z0' P_V Z0 + diag(prior)
        of the Hessian -> (q, q)."""
        return (design_gram(self.XFpT, wts[None])[0]
                + torch.exp(theta[0]) * self.Z0PZ0
                + self._tail_prior_mat(theta))

    def _tail_prior_mat(self, theta):
        """The tail's own prior precision, (q, q)."""
        return torch.diag(self.prior_diag_tail)

    def _band_extra_diag(self, theta):
        """Diagonal prior terms inside the band besides the driver's (a
        merged band's levels and padded slots): none here."""
        return None

    # -- the Schur tail as a Gram ------------------------------------------
    # The tail's Schur complement S = Hd - C^T Hb^{-1} C is, column by
    # column, the least-squares residual of the tail's design against the
    # band's (schur_gram below); taken as the difference Hd - Y^T Y it
    # cancels where the prior pins the driver.
    def _tail_schur(self, L, rinv, Y, sc, sd, wts, theta):
        """(q, q) Schur tail of the equilibrated arrowhead, sd S sd, as
        schur_gram's R = 1 case; L, rinv, Y: the band factor of the
        equilibrated band and Y = L^{-1} C_s. Differentiable in wts and
        theta."""
        with torch.no_grad():
            Wt = (self.engine.ops.bwd_solve(L, rinv, Y.contiguous())
                  * sc[:, None] / sd[None, :]).T          # (q, dpad): W'^T
        S = schur_gram(self, Wt[None], wts[None],
                       theta[self.drv_theta][None],
                       self._tail_prior_mat(theta),
                       self._band_extra_diag(theta))[0]
        return S * sd[:, None] * sd[None, :]

    # -- prior ------------------------------------------------------------
    # The driver's prior quadratic r^T P_V r, r = V' - Z0 t, is taken as
    # the sum of squares sum_i w_i ((T r)_i)^2 (P_V = T^T diag(w) T, how
    # basis/reparam.prior_band builds it), never from the expanded
    # V'^T P V' - 2 t^T PZ0^T V' + t^T Z0PZ0 t: on V' = Z0 t the expanded
    # form is rounding of either sign, which e^theta multiplies, and the
    # inner objective is then unbounded below at large theta. PZ0 and
    # Z0PZ0 still enter the Hessian blocks.
    def apply_T(self, V):
        """U = T V over the band of T. V: (..., d)."""
        U = self.Tdiags[0] * V
        for o in self._t_offsets:
            U = U + F.pad(self.Tdiags[o, o:] * V[..., :-o], (o, 0))
        return U

    def apply_Tt(self, U):
        """T^T U over the band of T. U: (..., d)."""
        V = self.Tdiags[0] * U
        for o in self._t_offsets:
            V = V + F.pad(self.Tdiags[o, o:] * U[..., o:], (0, o))
        return V

    def to_U(self, V):
        """Reference coefficients U = T V of the spline. V: (..., d)."""
        return self.apply_T(V)

    def to_V(self, Vp, tail):
        """Spline coefficients V = V' - Z0 t, (..., d) (rows of Vp/tail for
        2-D)."""
        Vd = Vp[..., :self.d]
        return Vd - tail @ self.Z0.T if self.q else Vd

    def prior_quad(self, V):
        """V^T P_V V as sum_i w_i ((T V)_i)^2 over the last axis."""
        U = self.apply_T(V)
        return (self.prior_w * U * U).sum(-1)

    def prior_grad(self, V):
        """P_V V as T^T (w * T V) over the last axis."""
        return self.apply_Tt(self.prior_w * self.apply_T(V))

    def _prior_neg(self, Vp, tail, theta):
        """Non-likelihood part of the joint negative log posterior."""
        lp = -0.5 * torch.exp(theta[0]) * self.prior_quad(self.to_V(Vp, tail))
        lp = lp + 0.5 * (self.d * theta[0] + self._logPdet0)
        if self.q:
            lp = lp - 0.5 * (self.prior_diag_tail
                             * (tail - self.prior_mean_tail) ** 2).sum()
        phi = self._phi
        lpT = (torch.log(0.5 * phi) - phi * torch.exp(-0.5 * theta)
               - 0.5 * theta).sum()
        return -(lp + lpT)

    def neg_log_post(self, Vp, tail, theta):
        """Joint negative log posterior at primed coordinates; equals the
        reference objective at W = [T(V' - Z0 t), t]."""
        ll = families.log_lik(self.eta(Vp, tail), self.md, theta)
        return -ll + self._prior_neg(Vp, tail, theta)

    def grad_W(self, Vp, tail, theta, eta=None):
        """Gradient of neg_log_post in primed coordinates."""
        e = self.eta(Vp, tail) if eta is None else eta
        return self.grad_parts(Vp, tail, theta,
                               families.eta_residual(e, self.md, theta))

    def grad_parts(self, Vp, tail, theta, r):
        """grad_W given the likelihood residual r = d(-ll)/d eta, which a
        model with more latent terms computes on its own eta."""
        pv = torch.exp(theta[0]) * self.prior_grad(self.to_V(Vp, tail))
        gV = self.Bt(r) + F.pad(pv, (0, self.dpad - self.d))
        if self.q:
            gt = (self.XFpT @ r - self.Z0.T @ pv
                  + self.prior_diag_tail * (tail - self.prior_mean_tail))
        else:
            gt = tail.new_zeros(0)
        return gV, gt

    # -- Hessian --------------------------------------------------------
    def _assemble_scaled(self, V, tail, theta, eta=None):
        """Jacobi-equilibrated arrowhead at (V, tail): (band_s, C_s, Hd_s,
        sc, sd, wts) with H~ = S H S, S = diag(sc, sd), and wts the
        likelihood weights."""
        e = self.eta(V, tail) if eta is None else eta
        wts = families.eta_weights(e, self.md, theta)
        band = self.band_H(wts, theta)
        C = self.C_block(wts, theta)
        if self.q:
            Hd = self.tail_gram(wts, theta)
            sd = torch.rsqrt(torch.diagonal(Hd))
            Hd = Hd * sd[:, None] * sd[None, :]
        else:
            Hd = V.new_zeros((0, 0))
            sd = V.new_zeros(0)
        sc = torch.rsqrt(band[:, 0])
        # band[j, o] = H[j+o, j] -> scaled by sc[j] sc[j+o]
        sc_pad = F.pad(sc, (0, self.p), value=1.0)
        sc_off = torch.stack([sc_pad[o:o + self.dpad]
                              for o in range(self.p + 1)], dim=1)
        band_s = band * sc[:, None] * sc_off
        C_s = C * sc[:, None] * sd[None, :] if self.q else C
        return band_s, C_s, Hd, sc, sd, wts

    def _factor_scaled(self, band_s, C_s, sc, sd, wts, theta):
        """Engine factor of the equilibrated Hessian, its Schur tail
        formed by _tail_schur."""
        def schur(L, rinv, Y):
            return self._tail_schur(L, rinv, Y, sc, sd, wts, theta)
        return self.engine.factor(band_s, C_s, schur)

    def hessian_factor(self, V, tail, theta, eta=None):
        """(engine factor, sc, sd) of the equilibrated Hessian."""
        band_s, C_s, Hd, sc, sd, wts = self._assemble_scaled(V, tail, theta,
                                                             eta=eta)
        return (self._factor_scaled(band_s, C_s, sc, sd, wts, theta),
                sc, sd)

    def solve_H(self, factor, gV, gt):
        """H [zV; zt] = [gV; gt] through the equilibrated factor."""
        af, sc, sd = factor
        zb, zd = self.engine.solve(af, gV * sc, gt * sd)
        return zb * sc, zd * sd

    def half_logdet_H(self, factor):
        af, sc, sd = factor
        return (self.engine.half_logdet(af) - torch.log(sc).sum()
                - torch.log(sd).sum())

    @torch.no_grad()
    def gate_reasons(self, theta, state):
        """Why the half-log-det backward's sick-factor gate would drop the
        log-det's cotangents at theta with the latent state `state` (V,
        tail, ...): (a band pivot clamped, the tail factor left its
        plain route, an entry of H^{-1} it reads is not finite), as
        Python bools (BandArrowEngine.gate_reasons). Where any holds the
        theta gradient there is the value's explicit part alone."""
        th = torch.as_tensor(theta, dtype=DTYPE, device=self.device)
        af = self.hessian_factor(state[0], state[1], th)[0]
        return tuple(bool(x) for x in self.engine.gate_reasons(af))

    # -- inner Newton ---------------------------------------------------
    @torch.no_grad()
    def newton_step(self, V, tail, theta, eta_cap=8.0):
        """Newton step with a linear-predictor cap alpha <= eta_cap /
        max|delta eta| and a 4-candidate backtracking pass on the exact
        objective. Returns (V', tail', max|step|)."""
        e0 = self.eta(V, tail)
        gV, gt = self.grad_W(V, tail, theta, eta=e0)
        factor = self.hessian_factor(V, tail, theta, eta=e0)
        step_V, step_t = self.solve_H(factor, gV, gt)
        step_V, step_t = _finite(step_V), _finite(step_t)
        d_eta = self.eta(step_V, step_t)
        max_de = d_eta.abs().max()
        d_eta = _finite(d_eta)
        alpha0 = torch.clamp(eta_cap / torch.clamp(max_de, min=1e-30),
                             max=1.0)
        cands = alpha0 * torch.tensor([1.0, 0.3, 0.1, 0.03], dtype=DTYPE,
                                      device=self.device)
        alphas = torch.cat([alpha0.new_zeros(1), cands])
        etas = e0[None, :] - alphas[:, None] * d_eta[None, :]
        lls = families.log_lik(etas, self.md, theta)
        # the prior part is an exact quadratic in alpha
        p_0 = self._prior_neg(V, tail, theta)
        p_p = self._prior_neg(V - step_V, tail - step_t, theta)
        p_m = self._prior_neg(V + step_V, tail + step_t, theta)
        c2 = 0.5 * (p_p + p_m) - p_0
        c1 = 0.5 * (p_p - p_m)
        fall = -lls + (p_0 + c1 * alphas + c2 * alphas ** 2)
        f0 = fall[0]
        fs = torch.where(torch.isnan(fall[1:]),
                         torch.full_like(fall[1:], math.inf), fall[1:])
        best = torch.argmin(fs)
        # the largest alpha within noise of the best (plain backtracking
        # far from the optimum, no creep near it)
        noise = LS_NOISE * (1.0 + f0.abs())
        idx = (fs <= fs[best] + noise).to(torch.int8).argmax()
        alpha = torch.where(fs[best] <= f0 + noise, cands[idx],
                            0.01 * alpha0)
        smax = step_V.abs().max()
        if self.q:
            smax = torch.maximum(smax, step_t.abs().max())
        return V - alpha * step_V, tail - alpha * step_t, smax

    @torch.no_grad()
    def newton_solve(self, theta, max_iter=MAX_NEWTON, warm=None):
        """Inner Newton: stops when max|H^{-1} g| falls below STEPTOL (1 +
        max|V|), after STALL_ITERS steps without a 5% improvement of the
        step size, or at max_iter."""
        if warm is None:
            V, tail = self.init_state()
        else:
            V, tail = warm
            if not bool(torch.isfinite(V.sum() + tail.sum())):
                V, tail = self.init_state()
        smax, best, since = math.inf, math.inf, 0
        for _ in range(max_iter):
            if since >= STALL_ITERS:
                break
            V, tail, s = self.newton_step(V, tail, theta)
            smax, vmax = torch.stack([s, V.abs().max()]).tolist()
            if smax < 0.95 * best:
                since = 0
            else:
                since += 1
            best = min(best, smax)
            if smax < STEPTOL * (1.0 + vmax):
                break
        return V, tail

    @torch.no_grad()
    def _refine(self, V, tail, theta, eta_cap=8.0):
        e0 = self.eta(V, tail)
        gV, gt = self.grad_W(V, tail, theta, eta=e0)
        factor = self.hessian_factor(V, tail, theta, eta=e0)
        step_V, step_t = self.solve_H(factor, gV, gt)
        step_V, step_t = _finite(step_V), _finite(step_t)
        d_eta = self.eta(step_V, step_t)
        alpha = torch.clamp(
            eta_cap / torch.clamp(d_eta.abs().max(), min=1e-30), max=1.0)
        alpha = _finite(alpha)
        return V - alpha * step_V, tail - alpha * step_t

    def solve_W_star(self, theta, n_refine=1, warm=None):
        theta = theta.detach()
        V, tail = self.newton_solve(theta, warm=warm)
        for _ in range(n_refine):
            V, tail = self._refine(V, tail, theta)
        return V, tail

    # -- Laplace values -------------------------------------------------
    def _laplace_value(self, V, tail, theta, factor=None):
        """F(W, theta) = f + 1/2 log|H| - w/2 log(2 pi) - log|det T|,
        differentiable in (V, tail, theta): the half log-det's backward
        is the Takahashi selected inverse (never the factorization
        recurrence). `factor`: a hessian_factor at the same point, whose
        factorization the primal then reuses."""
        e0 = self.eta(V, tail)
        band_s, C_s, Hd, sc, sd, wts = self._assemble_scaled(V, tail, theta,
                                                             eta=e0)
        # the tail's scale cancels from 0.5 log|sd S sd| - sum log sd
        sd = sd.detach()
        if factor is None:
            af = self._factor_scaled(band_s, C_s, sc.detach(), sd,
                                     wts.detach(), theta.detach())
        else:
            af = factor[0]
        S_s = (self._tail_schur(af.L, af.rinv, af.Y, sc.detach(), sd, wts,
                                theta) if self.q else Hd)
        hld = self.engine.schur_half_logdet(band_s, S_s, af)
        half_logdet = hld - torch.log(sc).sum() - torch.log(sd).sum()
        f = (-families.log_lik(e0, self.md, theta)
             + self._prior_neg(V, tail, theta))
        return (f + half_logdet - 0.5 * self.w_count * LOG2PI
                - self.logdetT)

    def _laplace_value_direct(self, V, tail, theta, factor, eta=None):
        """Laplace value from a precomputed factor (primal only)."""
        e0 = self.eta(V, tail) if eta is None else eta
        f = (-families.log_lik(e0, self.md, theta)
             + self._prior_neg(V, tail, theta))
        return (f + self.half_logdet_H(factor)
                - 0.5 * self.w_count * LOG2PI - self.logdetT)

    @torch.no_grad()
    def laplace_eval_full(self, theta, warm):
        """(nll, (V, tail), factor) of one quadrature node."""
        V, tail = self.solve_W_star(theta, warm=warm)
        e0 = self.eta(V, tail)
        factor = self.hessian_factor(V, tail, theta, eta=e0)
        val = self._laplace_value_direct(V, tail, theta, factor, eta=e0)
        return val, (V, tail), factor

    def laplace_nll(self, theta, warm=None):
        """(Laplace marginal nll, (V, tail)), equal to the dense reference
        value and differentiable in theta by the implicit function
        theorem (nothing is differentiated through the Newton solve)."""
        V0, t0 = self.init_state() if warm is None else warm
        theta = torch.as_tensor(theta, dtype=DTYPE, device=self.device)
        val, V, tail = _LaplaceNLL.apply(theta, V0, t0, self)
        return val, (V, tail)

    def value_and_grad(self, theta, warm):
        """(nll, d nll/d theta, (V, tail)) at theta, warm-started."""
        th = torch.as_tensor(theta, dtype=DTYPE, device=self.device)
        th = th.detach().clone().requires_grad_(True)
        val, st = self.laplace_nll(th, warm)
        (g,) = torch.autograd.grad(val, th)
        return val.detach(), g, st

    # -- posterior draws -------------------------------------------------
    def noise_rows(self):
        """Rows of the standard normal noise `sample` takes, in order."""
        return (self.dpad, self.q)

    @torch.no_grad()
    def sample(self, states, idx, zb, zd):
        """(w_ref, M) mixture draws in reference coordinates [U = T V |
        tail]. states: per-node (V, tail, factor); idx (M,) node of each
        draw; zb (dpad, M), zd (q, M) standard normal noise shared by the
        nodes. One multi-RHS solve (K5) per node, then per-draw node
        selection."""
        M = zb.shape[1]
        devs = []
        for V, tail, (af, sc, sd) in states:
            xb, xd = self.engine.sample_multi(af, zb, zd)
            devs.append((xb * sc[:, None], xd * sd[:, None]))
        m_ar = torch.arange(M, device=self.device)
        xbs = torch.stack([d_[0] for d_ in devs])      # (J, dpad, M)
        xds = torch.stack([d_[1] for d_ in devs])      # (J, q, M)
        Vn = torch.stack([s[0] for s in states])
        tn = torch.stack([s[1] for s in states])
        Vs = Vn[idx] + xbs[idx, :, m_ar]               # (M, dpad)
        ts = tn[idx] + xds[idx, :, m_ar]               # (M, q)
        U = self.to_U(self.to_V(Vs, ts)[:, :self.d])
        return torch.cat([U, ts], dim=1).T             # (w_ref, M)


def design_gram(XT, wts):
    """(R, q, q) X^T diag(wts_r) X for XT (q, n) and weights (R, n): one
    2-D product a system, so a system's Gram rounds alike whatever R (a
    batched product may run another cuBLAS kernel than a single one)."""
    return torch.stack([(XT * w) @ XT.T for w in wts])


# The Schur tail as a Gram. With F the prior's factor (F^T F = e^theta
# P_V) and W' = Hb^{-1} C,
#     S = E1^T E1 + E2^T E2 + P_t (+ Wc^T D Wc),
#     E1 = sqrt(wts) (XFp - B W'),   E2 = F Wc,   Wc = Z0 + W',
# D the band's other diagonal prior terms: a sum of squares, and an
# error in W' moves it only to second order (S is the minimum over W'),
# so its derivative is taken with W' fixed. One function forms it for
# the one-response engine (R = 1) and the replicate engine
# (fast/batched.py): every reduction runs over one system's own entries
# (the design sum over a within each system, one 2-D product a system for
# each Gram), so on the same inputs a system's S is the same bits
# whatever R.
def schur_gram(be, Wt, wts, th_drv, prior, extra=None):
    """(R, q, q) unscaled Schur tails of R systems on be's design: Wt (R,
    q, dpad) = (Hb_r^{-1} C_r)^T, wts (R, n) the likelihood weights,
    th_drv (R,) the driver's theta, prior (q, q) or (R, q, q) the tail's
    own prior precision, extra (d,) the band's other diagonal prior terms
    or None. Differentiable in wts, th_drv, prior and extra."""
    BW = (be.valsT * Wt[:, :, be._cols]).sum(2)             # (R, q, n)
    E1 = torch.sqrt(wts)[:, None, :] * (be.XFpT - BW)
    Wc = be.Z0.T + Wt[:, :, :be.d]                          # (R, q, d)
    E2 = (be.apply_T(Wc) * be._sqrt_w
          * torch.exp(0.5 * th_drv)[:, None, None])
    S = torch.stack([a @ a.T + b @ b.T for a, b in zip(E1, E2)]) + prior
    if extra is not None:
        S = S + torch.stack([(w * extra) @ w.T for w in Wc])
    return S


class _SegSum(torch.autograd.Function):
    """Segment sums over the sorted rows as an f64 prefix sum differenced
    at the segment boundaries. The backward hands each row its
    segment's cotangent (a gather): neither direction adds with atomics,
    so results do not depend on the run."""

    @staticmethod
    def forward(ctx, rows, be):
        ctx.be = be
        cs = torch.cumsum(rows, dim=-1)
        zero = cs.new_zeros(())
        (hi, lo), (some_hi, some_lo) = be._seg_prev, be._seg_some
        return (torch.where(some_hi, cs[..., hi], zero)
                - torch.where(some_lo, cs[..., lo], zero))

    @staticmethod
    def backward(ctx, ct):
        return ct[..., ctx.be.start], None


class _Eta(torch.autograd.Function):
    """eta = B V' + XFp t by a gather of V' at each row's columns; its
    backward is B^T (segment sums) rather than a scatter-add."""

    @staticmethod
    def forward(ctx, Vp, tail, be):
        ctx.be = be
        e = (be.valsT * Vp[be._cols]).sum(0)
        if be.q:
            e = e + tail @ be.XFpT
        return e

    @staticmethod
    def backward(ctx, ct):
        be = ctx.be
        g_t = be.XFpT @ ct if be.q else ct.new_zeros(0)
        return be.Bt(ct), g_t, None


class _LaplaceNLL(torch.autograd.Function):
    """Laplace nll with its implicit-function theta gradient:
    dnll/dth = dF/dth - (dg/dth)^T H^{-1} dF/dW at the inner mode W*."""

    @staticmethod
    def forward(ctx, theta, V0, t0, be):
        V, tail = be.solve_W_star(theta, warm=(V0, t0))
        e0 = be.eta(V, tail)
        factor = be.hessian_factor(V, tail, theta, eta=e0)
        val = be._laplace_value_direct(V, tail, theta, factor, eta=e0)
        ctx.be, ctx.factor = be, factor
        ctx.save_for_backward(theta, V, tail)
        ctx.mark_non_differentiable(V, tail)
        return val, V, tail

    @staticmethod
    def backward(ctx, ct_val, _ct_V, _ct_t):
        be, factor = ctx.be, ctx.factor
        theta, V, tail = ctx.saved_tensors
        with torch.enable_grad():
            V_ = V.detach().requires_grad_(True)
            t_ = tail.detach().requires_grad_(True)
            th_ = theta.detach().requires_grad_(True)
            F = be._laplace_value(V_, t_, th_, factor=factor)
            gF_V, gF_t, gF_th = torch.autograd.grad(
                F, (V_, t_, th_), allow_unused=True)
            gF_t = torch.zeros_like(tail) if gF_t is None else gF_t
            gF_V, gF_t = _finite(gF_V), _finite(gF_t)
            with torch.no_grad():
                vV, vt = be.solve_H(factor, gF_V, gF_t)
            vV, vt = _finite(vV), _finite(vt)
            th2 = theta.detach().requires_grad_(True)
            gV, gt = be.grad_W(V, tail, th2)
            gdotv = torch.dot(gV, vV)
            if be.q:
                gdotv = gdotv + torch.dot(gt, vt)
            (term2,) = torch.autograd.grad(gdotv, th2)
        return (gF_th - term2) * ct_val, None, None, None


def build_fast_iwp(term, md, xf_dense, prior_diag_tail, prior_mean_tail,
                   x_data, device="cuda"):
    """FastIWPBackend for one IWP term on `device`.

    term: the IWP TermDesign; md: ModelData (family data and priors);
    xf_dense: (n, q) dense tail design [X_global | fixed columns];
    x_data: the term's (shifted) smoothing-variable values."""
    p = term.order
    knots = np.asarray(term.knots, np.float64)
    if knots.min() < 0:
        raise ValueError("the banded IWP backend needs nonnegative knots")
    d = len(knots) - 1
    dpad = pad_dim(d, p)

    vals, start = reparam.sparse_rows(x_data, knots, p)
    order = np.argsort(start, kind="stable")
    vals = vals[order]
    start = start[order]
    xf_dense = np.asarray(xf_dense, np.float64)[order]
    counts = np.bincount(start, minlength=d)
    seg_hi = np.cumsum(counts)
    seg_lo = seg_hi - counts
    y = np.asarray(md.y, np.float64)[order]
    size = (np.asarray(md.size, np.float64)[order]
            if np.ndim(md.size) and np.shape(md.size)[0] == len(order)
            else np.asarray(md.size, np.float64))
    md_perm = dataclasses.replace(md, y=y, size=size)

    P_band, logdetT, T = reparam.prior_band(knots, p)
    Tdiags = np.zeros((p + 1, d))
    for o in range(p + 1):
        Tdiags[o, o:] = np.diagonal(T, -o)
    prior_w = np.diff(knots)

    # tail orthogonalization: Z0 = argmin ||B Z - XF||^2 + tau Z' P_V Z
    # (any Z0 keeps the Laplace value exact; this one keeps the Schur
    # complement well scaled and Z0 smooth)
    q = xf_dense.shape[1]
    if q:
        from scipy.linalg import solveh_banded
        Gband = np.zeros((p + 1, d))
        for o in range(p + 1):
            for b in range(p + 1 - o):
                a = b + o
                w = vals[:, a] * vals[:, b]
                Gband[o] += np.bincount(start + b, weights=w,
                                        minlength=d)[:d]
        BX = np.zeros((d, q))
        for a in range(p + 1):
            for c in range(q):
                BX[:, c] += np.bincount(
                    start + a, weights=vals[:, a] * xf_dense[:, c],
                    minlength=d)[:d]
        tau = 1e2 * (Gband[0].mean() / max(P_band[0].mean(), 1e-30))
        Gb = Gband + tau * P_band
        Gb[0] += 1e-9 * max(Gband[0].max(), 1.0)
        Z0 = solveh_banded(Gb, BX, lower=True)
        XFp = xf_dense.copy()
        for a in range(p + 1):
            XFp -= vals[:, a, None] * Z0[np.clip(start + a, 0, d - 1), :]
        # P = T' diag(w) T: P Z0 and Z0' P Z0 through G0 = T Z0, which
        # keeps Z0' P Z0 positive semi-definite by construction
        G0 = Tdiags[0][:, None] * Z0
        for o in range(1, p + 1):
            G0[o:] += Tdiags[o, o:, None] * Z0[:-o]
        wG0 = prior_w[:, None] * G0
        PZ0 = Tdiags[0][:, None] * wG0
        for o in range(1, p + 1):
            PZ0[:-o] += Tdiags[o, o:, None] * wG0[o:]
        sw = np.sqrt(prior_w)[:, None]
        Z0PZ0 = (sw * G0).T @ (sw * G0)
    else:
        Z0 = np.zeros((d, 0))
        PZ0 = np.zeros((d, 0))
        Z0PZ0 = np.zeros((0, 0))
        XFp = xf_dense

    arrays = dict(
        valsT=np.ascontiguousarray(vals.T), start=start,
        seg_lo=seg_lo, seg_hi=seg_hi, XFpT=np.ascontiguousarray(XFp.T),
        Z0=Z0, PZ0=PZ0, Z0PZ0=Z0PZ0, P_band=P_band, Tdiags=Tdiags,
        prior_w=prior_w,
        prior_diag_tail=np.asarray(prior_diag_tail, np.float64),
        prior_mean_tail=np.asarray(prior_mean_tail, np.float64))
    return from_arrays(term, md_perm, p, d, dpad, arrays, float(logdetT),
                       np.asarray(order), device)


def from_arrays(term, md, p, d, dpad, arrays, logdetT, row_order, device):
    """FastIWPBackend from host arrays (rows already sorted; md's y and
    size in that order) on `device`."""
    dev = torch.device(device)

    def f64(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=DTYPE,
                            device=dev).contiguous()

    def i64(a):
        return torch.tensor(np.asarray(a, np.int64), device=dev)

    md_dev = dataclasses.replace(md, y=f64(md.y), size=f64(md.size))
    q = int(np.shape(arrays["XFpT"])[0])
    return FastIWPBackend(
        term=term, md=md_dev, p=p, d=d, dpad=dpad, q=q,
        valsT=f64(arrays["valsT"]), start=i64(arrays["start"]),
        seg_lo=i64(arrays["seg_lo"]), seg_hi=i64(arrays["seg_hi"]),
        XFpT=f64(arrays["XFpT"]), Z0=f64(arrays["Z0"]),
        PZ0=f64(arrays["PZ0"]), Z0PZ0=f64(arrays["Z0PZ0"]),
        P_band=f64(arrays["P_band"]), Tdiags=f64(arrays["Tdiags"]),
        prior_w=f64(arrays["prior_w"]), logdetT=float(logdetT),
        prior_diag_tail=f64(arrays["prior_diag_tail"]),
        prior_mean_tail=f64(arrays["prior_mean_tail"]),
        engine=BandArrowEngine(dpad, p, q),
        row_order=np.asarray(row_order))
