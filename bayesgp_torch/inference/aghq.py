"""Adaptive Gauss-Hermite quadrature over the hyperparameters theta.

The counterpart of the `aghq` R package machinery (aghq::
marginal_laplace_tmb, k = 4 by default): find the mode of the Laplace
marginal nll(theta), adapt a Gauss-Hermite rule with the mode and the
outer curvature, and form the log normalizing constant and the theta
marginals. The fit is a host loop over warm-started Laplace evaluations
of the backend (DenseBackend below for small models of any structure,
fast/iwp.FastIWPBackend and the other fast backends at scale); each
evaluation runs its linear algebra on the backend's device. One theta
takes the secant-Newton of optimize_1d; more take the gradient-only BFGS
of optimize_theta, the JAX package's host path for heavy evaluations.

Conventions match aghq/mvQuad 'GHe': nodes are probabilists' Hermite
roots; weights integrate f against Lebesgue measure for f ~ poly x
exp(-z^2/2), i.e. w_i = hermegauss_w_i * exp(z_i^2 / 2); adapted nodes
theta_j = mode + L z_j with weight multiplier det(L).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..fast.iwp import HostNodes
from ..model.objective import to_device
from .laplace import laplace_nll, laplace_nll_with_factor

# outer optimizer: gradient tolerance, iteration cap, the f64 noise level
# of the nll value, and the central-difference step of the outer Hessian
TOL = 1e-9
MAX_ITER = 40
F_NOISE = 1e-9
H_FD = 1e-4


def ghe_rule(k: int):
    """Probabilists' Gauss-Hermite: integrates g(z) ~ poly * e^{-z^2/2}.

    Returns (nodes, weights) with sum_i w_i g(z_i) ~= int g(z) dz.
    """
    z, w = np.polynomial.hermite_e.hermegauss(k)
    return z, w * np.exp(z ** 2 / 2.0)


def product_grid(k: int, s: int):
    """(k^s, s) node matrix and (k^s,) log-weights of the product rule."""
    z1, w1 = ghe_rule(k)
    nodes = np.array(list(itertools.product(z1, repeat=s)))
    logw = np.sum(np.log(w1)[
        np.array(list(itertools.product(range(k), repeat=s)))], axis=1)
    return nodes, logw


def _logsumexp_np(lw):
    lw = np.asarray(lw)
    m = lw.max()
    return float(m + np.log(np.sum(np.exp(lw - m))))


class DenseBackend(HostNodes):
    """The dense route: dense design, dense Hessian, torch.linalg Cholesky
    (inference/laplace.py); exact for every model structure, and the
    route engine="auto" takes for small models. The model's arrays live
    on `device` as f64 tensors. The latent state is W* (w,); a node's
    sampling state is (W*, lower Cholesky factor of H).

    `stats` counts Laplace evaluations ("evals"), inner Newton steps
    ("newton") and host syncs ("syncs": the inner loop's stopping tests
    and the optimizers' reads of each value_and_grad; the node values are
    read together, at the end of the fit)."""

    def __init__(self, md, device="cuda"):
        self.device = torch.device(device)
        self.md = to_device(md, self.device)
        self.stats = {"evals": 0, "newton": 0, "syncs": 0}

    @property
    def n_theta(self):
        return self.md.n_theta

    @property
    def em_dims(self):
        """Per-theta penalized dimensions for optimize_1d's EM-style jump:
        the prior contributes -0.5 d_r theta_r per random effect (d_r
        spline coefficients, src/BayesGP.cpp:227-232), and the Gaussian
        noise theta gets d = n from the likelihood."""
        dims = [float(d) for d in self.md.d_sizes]
        if self.md.family == 0:
            dims.append(float(self.md.n))
        return np.asarray(dims)

    def init_state(self):
        return torch.zeros(self.md.w_count, dtype=torch.float64,
                           device=self.device)

    def _theta(self, theta):
        return torch.as_tensor(theta, dtype=torch.float64,
                               device=self.device)

    def value_and_grad(self, theta, warm):
        """(nll, d nll / d theta, W*) at theta (a tensor or numpy),
        warm-started from W* `warm`."""
        th = self._theta(theta).detach().clone().requires_grad_(True)
        val, Ws = laplace_nll(th, self.md, W0=warm, stats=self.stats)
        (g,) = torch.autograd.grad(val, th)
        self.stats["evals"] += 1
        self.stats["syncs"] += 1
        return val.detach(), g, Ws.detach()

    @torch.no_grad()
    def laplace_eval_full(self, theta, warm):
        """(nll, W*, lower Cholesky factor of H) of one quadrature node:
        the factor is the half log-det's (laplace_nll_with_factor)."""
        val, Ws, L = laplace_nll_with_factor(self._theta(theta), self.md,
                                             W0=warm, stats=self.stats)
        self.stats["evals"] += 1
        return val, Ws, L

    @staticmethod
    def node_pack(st, factor):
        return (st, factor)

    def noise_rows(self):
        """Rows of the standard normal noise `sample` takes."""
        return (self.md.w_count,)

    @torch.no_grad()
    def sample(self, states, idx, z):
        """(w, M) mixture draws W*_j + L_j^{-T} z_m, j = idx[m]: one
        triangular solve a node over the draws that picked it (never an
        (M, w, w) stack of factors). states: per-node (W*, L); z (w, M)."""
        out = torch.empty_like(z)
        for j, (Ws, L) in enumerate(states):
            pick = idx == j
            zj = z[:, pick]
            out[:, pick] = Ws[:, None] + torch.linalg.solve_triangular(
                L.T, zj, upper=True)
        return out


@dataclass
class AGHQFit:
    """Everything downstream code needs (mirrors aghq's fit object)."""
    mode: np.ndarray              # theta mode (s,)
    hessian: np.ndarray           # outer Hessian at mode (s, s)
    L: np.ndarray                 # lower chol of H^{-1} (adaptation)
    nodes: np.ndarray             # (J, s) adapted theta nodes
    logw: np.ndarray              # (J,) adapted log weights (incl. det L)
    lognll: np.ndarray            # (J,) laplace nll at nodes
    lognormconst: float
    states: Any                   # per-node latent state and factor
    k: int
    backend: Any = None
    marginals: list = field(default_factory=list)  # per-dim (theta, logpdf)
    mode_state: Any = None        # the latent state at the mode

    @property
    def logpost_nodes(self):
        """Normalized log posterior at the nodes."""
        return -self.lognll - self.lognormconst


def optimize_1d(backend, theta0: float = 0.0, tol: float = TOL,
                max_iter: int = MAX_ITER):
    """(mode, H, latent state at the mode) for one hyperparameter.

    Secant-Newton on the root of the implicit-function gradient, in the
    order the JAX package's single-program fit runs it: a boot
    evaluation at theta0; EM-style jumps th + log(d / (2(g - hp') + d))
    while far from the mode (d = em_dims[0], hp' the slope of the
    exponential hyperprior); secant steps under a trust cap that doubles
    (to 16) on consecutive full steps in one direction and shrinks 4x on
    a rejected step; a sign flip of the gradient within a short step
    triggers one final secant interpolation and stops. Then the outer
    curvature by central differences of the gradient at mode +/- H_FD,
    both warm-started from the mode's latent state."""
    dev = backend.device
    em_dim = float(backend.em_dims[0])
    em_phi = float(-math.log(float(backend.md.alpha[0]))
                   / float(backend.md.u[0]))

    def vg(th, state):
        val, g, st = backend.value_and_grad(
            torch.tensor([th], dtype=torch.float64, device=dev), state)
        return float(val), float(g[0]), st

    th, f, g, state = float(theta0), math.inf, 0.0, backend.init_state()
    h_est, cap, last_dir = 0.0, 2.0, 0.0
    final, th_root = False, 0.0
    for it in range(max_iter):
        boot = it == 0
        h = h_est if h_est > 0 else max(abs(g), 1.0)
        step = float(np.clip(g / h, -cap, cap))
        hp = 0.5 - 0.5 * em_phi * math.exp(-0.5 * th)
        A = 2.0 * (g - hp) + em_dim
        em = float(np.clip(math.log(em_dim) - math.log(max(A, 1e-4 * em_dim)),
                           -8.0, 8.0))
        # far from the mode and not recovering from a rejection
        use_em = abs(em) > 0.5 and cap >= 2.0 and not boot
        if use_em:
            step = -em
        if boot:
            step = 0.0
        full = (not use_em) and abs(step) >= cap * 0.999
        if full and np.sign(step) == last_dir:
            cap2 = min(cap * 2.0, 16.0)
        else:
            cap2 = cap if full else 2.0
        ldir2 = float(np.sign(step)) if full else 0.0
        cand = th_root if final else th - step
        f_t, g_t, st_t = vg(cand, state)
        guard = max(1e3 * F_NOISE * (1.0 + abs(f)), 1e-8)
        ok = math.isfinite(f_t) and f_t <= f + guard
        # the final secant evaluation is accepted unless it is not finite
        acc = ok or (final and math.isfinite(f_t))
        dth = cand - th
        h_new = (g_t - g) / dth if acc and abs(dth) > 1e-12 else h_est
        if not (math.isfinite(h_new) and h_new > 0):
            h_new = h_est
        flip = (acc and not final and not boot
                and np.sign(g_t) != np.sign(g)
                and abs(dth) < 0.05 * (1.0 + abs(cand)))
        denom = g_t - g
        th_root = cand - g_t * dth / denom if abs(denom) > 1e-300 else cand
        if acc:
            th, f, g, state = cand, f_t, g_t, st_t
        small = h_new > 0 and abs(g / max(h_new, 1e-12)) < 1e-4
        done = final or abs(g) < tol or (not flip and acc and small)
        cap = cap2 if acc else cap * 0.25
        last_dir = ldir2 if acc else last_dir
        final, h_est = flip, h_new
        if done:
            break
    g_plus = vg(th + H_FD, state)[1]
    g_minus = vg(th - H_FD, state)[1]
    H = (g_plus - g_minus) / (2 * H_FD)
    return th, H, state


def fit_1d_batched(backend, k: int, tol: float = TOL,
                   max_iter: int = MAX_ITER):
    """R one-hyperparameter AGHQ fits in lock step on a replicate backend
    (fast/batched.BatchedFastIWP): (mode (R,), H (R,), nodes (R, k),
    nlls (R, k)) as tensors on the backend's device.

    The (R,)-vector twin of optimize_1d and the node evaluations of
    aghq_fit, after the JAX package's batched single-program fit: every
    optimizer quantity is an (R,) tensor and every Laplace evaluation
    factors all replicates in one pass. It evaluates at theta = 0 before
    the loop (optimize_1d spends its first iteration on that), then applies
    the same secant-Newton, EM jump, trust cap and accept guard per
    replicate. The loop runs until every replicate is done; a replicate
    that is done is frozen -- it is still evaluated, in lock step, but
    never moves again. Then the central-difference pair at mode +/- H_FD
    and the k nodes, the negative and the positive side each as a chain
    warm-started in order of |z| from the mode's latent state. One
    device-to-host read per outer iteration."""
    dev = backend.device
    R = backend.R
    em_dim = float(backend.em_dims[0])
    em_phi = float(-math.log(float(np.asarray(backend.md.alpha)[0]))
                   / float(np.asarray(backend.md.u)[0]))
    z1, _ = ghe_rule(k)

    def vec(x):
        return torch.full((R,), float(x), dtype=torch.float64, device=dev)

    def vg(th, state):
        return backend.value_and_grad(th, state)

    th = vec(0.0)
    f, g, state = vg(th, backend.init_state())
    h_est, cap, last_dir, th_root = vec(0.0), vec(2.0), vec(0.0), vec(0.0)
    final = torch.zeros(R, dtype=torch.bool, device=dev)
    done = g.abs() < tol
    for _ in range(max_iter):
        if bool(done.all()):
            break
        h = torch.where(h_est > 0, h_est, torch.clamp(g.abs(), min=1.0))
        step = torch.maximum(torch.minimum(g / h, cap), -cap)
        hp = 0.5 - 0.5 * em_phi * torch.exp(-0.5 * th)
        A = 2.0 * (g - hp) + em_dim
        em = torch.clamp(math.log(em_dim)
                         - torch.log(torch.clamp(A, min=1e-4 * em_dim)),
                         -8.0, 8.0)
        # far from the mode and not recovering from a rejection
        use_em = (em.abs() > 0.5) & (cap >= 2.0)
        step = torch.where(use_em, -em, step)
        full = ~use_em & (step.abs() >= cap * 0.999)
        same_dir = torch.sign(step) == last_dir
        cap2 = torch.where(full & same_dir, torch.clamp(cap * 2.0, max=16.0),
                           torch.where(full, cap, vec(2.0)))
        ldir2 = torch.where(full, torch.sign(step), vec(0.0))
        cand = torch.where(final, th_root, th - step)
        f_t, g_t, st_t = vg(cand, state)
        guard = torch.clamp(1e3 * F_NOISE * (1.0 + f.abs()), min=1e-8)
        ok = torch.isfinite(f_t) & (f_t <= f + guard)
        # done replicates are frozen; the final secant evaluation is
        # accepted unless it is not finite
        acc = (ok | (final & torch.isfinite(f_t))) & ~done
        dth = cand - th
        h_new = torch.where(acc & (dth.abs() > 1e-12), (g_t - g) / dth, h_est)
        h_new = torch.where(torch.isfinite(h_new) & (h_new > 0), h_new,
                            h_est)
        flip = (acc & ~final & (torch.sign(g_t) != torch.sign(g))
                & (dth.abs() < 0.05 * (1.0 + cand.abs())))
        denom = g_t - g
        th_root = torch.where(denom.abs() > 1e-300,
                              cand - g_t * dth / denom, cand)
        th = torch.where(acc, cand, th)
        f = torch.where(acc, f_t, f)
        g = torch.where(acc, g_t, g)
        state = tuple(torch.where(acc[:, None], new, old)
                      for new, old in zip(st_t, state))
        small = (h_new > 0) & ((g / torch.clamp(h_new, min=1e-12)).abs()
                               < 1e-4)
        now_done = final | (g.abs() < tol) | (~flip & acc & small)
        rej = ~acc & ~done
        cap = torch.where(acc, cap2, torch.where(rej, cap * 0.25, cap))
        last_dir = torch.where(acc, ldir2, last_dir)
        final, h_est = flip, h_new
        done = done | now_done
    mode = th
    g_plus = vg(mode + H_FD, state)[1]
    g_minus = vg(mode - H_FD, state)[1]
    H = (g_plus - g_minus) / (2 * H_FD)
    Lad = torch.rsqrt(torch.clamp(H.abs(), min=1e-8))
    nodes = mode[:, None] + Lad[:, None] * torch.as_tensor(
        z1, dtype=torch.float64, device=dev)                   # (R, k)
    order = [int(j) for j in np.argsort(np.abs(z1))]
    nlls = [None] * k
    for side in ([j for j in order if z1[j] < 0],
                 [j for j in order if z1[j] >= 0]):
        warm = state
        for j in side:
            nlls[j], warm, _ = backend.laplace_eval_full(nodes[:, j], warm)
    return mode, H, nodes, torch.stack(nlls, dim=1)


def optimize_theta(backend, s: int, theta0=None, tol: float = TOL,
                   max_iter: int = 100):
    """(mode, H, nll at the mode, latent state there) for s > 1
    hyperparameters: gradient-only BFGS on the implicit-function gradient
    (the reference's optim(method="BFGS")), each evaluation warm-started
    from the last accepted latent state, backtracking from a unit step
    under a 1e-12 relative acceptance margin, stopping on a small
    gradient, a non-descent direction, a failed line search or two
    consecutive steps within the F_NOISE floor. Then the outer Hessian
    by central differences of the gradient (backend.hess)."""
    theta = np.zeros(s) if theta0 is None else np.asarray(theta0, np.float64)

    def vg(th, state):
        val, g, st = backend.value_and_grad(th, state)
        return float(val), g.cpu().numpy().astype(np.float64), st

    f, g, state = vg(theta, backend.init_state())
    Hinv = np.eye(s) / max(float(np.abs(g).max()), 1.0)
    stall = 0
    for _ in range(max_iter):
        gmax = float(np.abs(g).max())
        if gmax < tol:
            break
        step = Hinv @ g
        dec = float(np.dot(step, g))
        if not np.isfinite(dec) or dec <= 0:
            # the update lost positive-definiteness: restart the curvature
            Hinv = np.eye(s) / max(gmax, 1.0)
            step = Hinv @ g
            dec = float(np.dot(step, g))
        if dec < 1e-13 * (1.0 + abs(f)):
            break
        alpha, accepted = 1.0, False
        for _ in range(25):
            cand = theta - alpha * step
            f_try, g_try, st_try = vg(cand, state)
            if np.isfinite(f_try) and f_try <= f + 1e-12 * (1.0 + abs(f)):
                improved = (f - f_try) > F_NOISE * (1.0 + abs(f))
                sk, yk = -alpha * step, g_try - g
                sy = float(np.dot(sk, yk))
                if sy > 1e-12 * float(np.linalg.norm(sk) * np.linalg.norm(yk)
                                      + 1e-300):
                    # BFGS inverse update (Sherman-Morrison form)
                    rho = 1.0 / sy
                    V = np.eye(s) - rho * np.outer(sk, yk)
                    Hinv = V @ Hinv @ V.T + rho * np.outer(sk, sk)
                theta, f, g, state = cand, f_try, g_try, st_try
                accepted = True
                break
            alpha *= 0.5
        if not accepted:
            break
        stall = 0 if improved else stall + 1
        if stall >= 2:
            break
    return theta, backend.hess(theta, state), f, state


def _adapt(H):
    """Lower Cholesky factor of the adapted covariance H^{-1}, clipped to
    positive definite when the outer Hessian is not."""
    cov = np.linalg.inv(H)
    cov = 0.5 * (cov + cov.T)
    try:
        return np.linalg.cholesky(cov)
    except np.linalg.LinAlgError:
        evals, evecs = np.linalg.eigh(cov)
        evals = np.clip(np.abs(evals),
                        1e-8 * max(np.abs(evals).max(), 1e-8), None)
        return np.linalg.cholesky((evecs * evals) @ evecs.T)


def _aghq_fit_nd(backend, s: int, k: int, theta0) -> AGHQFit:
    """The s > 1 host path: optimize, adapt (PD clip), evaluate the k^s
    product-grid nodes from the mode's latent state, then each
    marginal's re-adapted grid."""
    mode, H, _, warm = optimize_theta(backend, s, theta0=theta0)
    L = _adapt(H)
    z, logw_base = product_grid(k, s)
    nodes = mode[None, :] + z @ L.T
    logw = logw_base + np.log(np.diag(L)).sum()
    nlls, states = backend.node_eval(nodes, warm)
    fit = AGHQFit(mode=mode, hessian=H, L=L, nodes=nodes, logw=logw,
                  lognll=nlls, lognormconst=_logsumexp_np(-nlls + logw),
                  states=states, k=k, backend=backend, mode_state=warm)
    fit.marginals = [marginal_posterior(fit, j, warm=warm) for j in range(s)]
    return fit


def aghq_fit(backend, k: int = 4, theta0=None) -> AGHQFit:
    """Full AGHQ pipeline: optimize, adapt, evaluate the nodes (each
    warm-started from the mode's latent state) and form the marginals.
    The posterior draws are sampling.sample_marginal's."""
    if backend.n_theta > 1:
        return _aghq_fit_nd(backend, backend.n_theta, k, theta0)
    th0 = 0.0 if theta0 is None else float(np.atleast_1d(theta0)[0])
    mode, H, st = optimize_1d(backend, th0)
    z1, _ = ghe_rule(k)
    Lad = 1.0 / math.sqrt(max(abs(H), 1e-8))
    nodes = mode + Lad * z1
    nlls, states = [], []
    for th_j in nodes:
        th_t = torch.tensor([th_j], dtype=torch.float64,
                            device=backend.device)
        val, st_j, factor = backend.laplace_eval_full(th_t, st)
        nlls.append(val)
        states.append(backend.node_pack(st_j, factor))
    nlls = torch.stack(nlls).cpu().numpy()
    _, logw_base = product_grid(k, 1)
    logw = logw_base + math.log(Lad)
    lognormconst = _logsumexp_np(-nlls + logw)
    fit = AGHQFit(mode=np.asarray([mode]), hessian=np.asarray([[H]]),
                  L=np.asarray([[Lad]]), nodes=nodes.reshape(k, 1),
                  logw=logw, lognll=nlls, lognormconst=lognormconst,
                  states=states, k=k, backend=backend, mode_state=st)
    fit.marginals = [marginal_posterior(fit, 0)]
    return fit


def marginal_posterior(fit: AGHQFit, j: int = 0, warm=None):
    """AGHQ marginal of theta_j (aghq::marginal_posterior): for s = 1 the
    node values themselves; for s > 1 the grid re-adapted with theta_j
    first, its nodes evaluated from `warm`, the other dimensions
    integrated by the adapted quadrature.
    Returns dict(theta=(k,), logmargpost=(k,)) sorted by theta."""
    if len(fit.mode) == 1:
        order = np.argsort(fit.nodes[:, 0])
        return {"theta": fit.nodes[order, 0],
                "logmargpost": (-fit.lognll - fit.lognormconst)[order]}
    nodes, mode_p, Lp = _marginal_nodes(fit, j)
    nlls, _ = fit.backend.node_eval(nodes, warm, keep_states=False)
    return _marginal_table(fit, nlls, mode_p, Lp)


def _marginal_nodes(fit: AGHQFit, j: int):
    """Re-adapted grid for the marginal of theta_j, dim j ordered first so
    its node values collapse to k points: (nodes (J, s) in the original
    theta order, permuted mode, permuted Cholesky factor). The covariance
    is the fit's (PD-clipped) L L^T, whose principal permutation stays
    positive definite."""
    s, k = len(fit.mode), fit.k
    idx = [j] + [i for i in range(s) if i != j]
    cov = fit.L @ fit.L.T
    Lp = np.linalg.cholesky(cov[np.ix_(idx, idx)])
    mode_p = fit.mode[idx]
    z, _ = product_grid(k, s)
    nodes_p = mode_p[None, :] + z @ Lp.T
    return nodes_p[:, np.argsort(idx)], mode_p, Lp


def _marginal_table(fit: AGHQFit, nlls, mode_p, Lp):
    """logmargpost of theta_j from its re-adapted grid's nlls: the
    product grid's first dimension varies slowest, in blocks of k^(s-1)
    nodes, each block summed over the other dimensions."""
    s, k = len(fit.mode), fit.k
    _, logw_base = product_grid(k, s)
    z1, w1 = ghe_rule(k)
    block = k ** (s - 1)
    theta_vals = mode_p[0] + Lp[0, 0] * z1
    logw_other = logw_base.reshape(k, block) - np.log(w1)[:, None]
    det_other = np.sum(np.log(np.diag(Lp)[1:]))
    logpdf = np.array([
        _logsumexp_np(-np.asarray(nlls).reshape(k, block)[i]
                      + logw_other[i] + det_other) - fit.lognormconst
        for i in range(k)])
    order = np.argsort(theta_vals)
    return {"theta": theta_vals[order], "logmargpost": logpdf[order]}


def compute_moment(fit: AGHQFit, fn: Callable = None):
    """E[fn(theta)] under the AGHQ posterior (aghq::compute_moment)."""
    if fn is None:
        fn = lambda x: x
    vals = np.array([fn(th) for th in fit.nodes])
    w = np.exp(fit.logpost_nodes + fit.logw)
    return (vals * w[:, None] if vals.ndim > 1 else vals * w).sum(axis=0)


def interpolate_log_marginal(marg, method: str = "spline"):
    """Interpolant of logmargpost on the log scale: R's natural cubic
    spline (splinefun method='natural'), extrapolated linearly."""
    from scipy.interpolate import CubicSpline
    theta, lp = marg["theta"], marg["logmargpost"]
    if len(theta) < 3 or method == "polynomial":
        coef = np.polyfit(theta, lp, deg=len(theta) - 1)
        return lambda x: np.polyval(coef, x)
    cs = CubicSpline(theta, lp, bc_type="natural", extrapolate=True)
    dleft = float(cs.derivative()(theta[0]))
    dright = float(cs.derivative()(theta[-1]))

    def interp(x):
        x = np.asarray(x, np.float64)
        y = cs(x)
        y = np.where(x < theta[0], lp[0] + dleft * (x - theta[0]), y)
        y = np.where(x > theta[-1], lp[-1] + dright * (x - theta[-1]), y)
        return y

    return interp


def compute_pdf_and_cdf(marg, transformation=None, finegrid=None):
    """Fine-grid pdf/cdf of one theta marginal (aghq::compute_pdf_and_cdf:
    range extended by half its width on each side, 1000 points, cdf by
    left-Riemann cumsum)."""
    interp = interpolate_log_marginal(marg)
    theta = marg["theta"]
    if finegrid is None:
        rn = theta.max() - theta.min()
        finegrid = np.linspace(theta.min() - rn / 2, theta.max() + rn / 2,
                               1000)
    pdf = np.exp(interp(finegrid))
    cdf = np.cumsum(pdf * np.concatenate([[0.0], np.diff(finegrid)]))
    out = {"theta": finegrid, "pdf": pdf, "cdf": cdf}
    if transformation is not None:
        tp = transformation["fromtheta"](finegrid)
        totheta = transformation["totheta"]
        eps = 1e-6
        dtheta = np.abs((totheta(tp + eps) - totheta(tp - eps)) / (2 * eps))
        out["transparam"] = tp
        out["pdf_transparam"] = pdf * dtheta
    return out


def compute_quantiles(marg, q=(0.025, 0.5, 0.975)):
    """Quantiles from the interpolated cdf (aghq::compute_quantiles)."""
    pc = compute_pdf_and_cdf(marg)
    grid, cdf = pc["theta"], pc["cdf"]
    out = []
    for p in q:
        below = np.where(cdf < p)[0]
        out.append(grid[below.max()] if len(below) else grid[0])
    return np.array(out)


def summarize_marginals(fit: AGHQFit):
    """Per-theta mean/sd/quantiles (aghq::summary.aghq moments table)."""
    rows = []
    mean = compute_moment(fit)
    second = compute_moment(fit, lambda th: th ** 2)
    sd = np.sqrt(np.maximum(second - mean ** 2, 0.0))
    for jdim, marg in enumerate(fit.marginals):
        qs = compute_quantiles(marg)
        rows.append({"mean": float(np.atleast_1d(mean)[jdim]),
                     "sd": float(np.atleast_1d(sd)[jdim]),
                     "q2.5": float(qs[0]), "median": float(qs[1]),
                     "q97.5": float(qs[2])})
    return rows
