#!/usr/bin/env python3
"""Measure apart the merged-IID Laplace value's noise on one CUDA card.

Builds the merged-IID headline model of chip_smoke.py phase 14 (the JAX
package's bench_bigiid generator, seed 0: n = 1e5, IWP3 k = 2000, 1e4
levels clustered in x merged into the band: d = 13,993, bw = 34, q = 3)
with bayesgp_torch on the card, and at theta* (default: phase 9's
scattered-IID mode) and theta* +- h e_i (h = 0.01) logs

  (a) the Schur tail two ways at the inner mode: as the engines form it,
      a Gram of least-squares residuals (fast/iwp.FastIWPBackend.
      _tail_schur), and as the difference Hd - Y^T Y of the equilibrated
      blocks: eigenvalues, the largest entries of Hd, Y^T Y and S, and
      whether chol_jittered leaves its plain route on the difference;
  (b) a dense arbiter: the whole (dpad + q)^2 Hessian assembled unscaled
      from band_H, C_block and tail_gram, its half log-determinant by
      torch.linalg.cholesky_ex on the card (a diagnostic only), beside
      the engine's half_logdet_H and the difference form's;
  (c) the Laplace value and theta gradient with the inner Newton's
      defaults (fast/iwp.py STEPTOL, MAX_NEWTON) from a cold start, and
      run tight (STEPTOL = 0, STALL_ITERS = 30, MAX_NEWTON = 400) warm
      from the centre's inner mode;
  (d) the smallest equilibrated band pivot, max |Y| against K1's cap and
      whether K1 clamped a pivot;

then the central differences of the value at theta* with the inner
Newton tight, for the Gram tail (the engine's value) and for the
difference form (the same inner modes, the value's half log-det taken
from Hd - Y^T Y), beside the theta gradient; and one model_fit of the
model (engine='auto') with its outer Hessian and Newton steps.

    python3 tools/torch_merged_value_probe.py [--theta T_IWP T_IID]

(`--device cpu --n 6000 --k 120 --q 600` rehearses it on the CPU at a
small size, with the plain band versions.)

Prints one line per point and a JSON summary as its last line, also
written to chiprun_out/merged_value_probe.json. Needs a card; imports
nothing of JAX.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

THETA_STAR = (14.496458, 3.769636)   # phase 9's mode (chip_smoke.py)
H_STEP = 1e-2
FORMULA = "y ~ f(x, model='IWP', order=3, k={k}) + f(g, model='IID')"


def bigiid_data(n=100_000, q=10_000, seed=0):
    """The JAX package's bench_bigiid generator (chip_smoke.py's copy)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 365.0, n))
    g = np.minimum(np.floor(x * (q / 365.0)), q - 1)
    u_true = 0.15 * rng.normal(size=int(g.max()) + 1)
    f_true = 1.5 + 0.8 * np.sin(2 * np.pi * x / 90.0) + 0.002 * x
    y = rng.poisson(np.exp(f_true + u_true[g.astype(int)])).astype(float)
    return {"y": y, "x": x, "g": g}


class Tight:
    """The inner Newton run tight for a block: fast/iwp.py's STEPTOL and
    STALL_ITERS set, and the backend's newton_solve given MAX_ITER."""
    STEPTOL, STALL_ITERS, MAX_ITER = 0.0, 30, 400

    def __init__(self, iwp, be):
        self.iwp, self.be = iwp, be

    def __enter__(self):
        self.saved = self.iwp.STEPTOL, self.iwp.STALL_ITERS
        self.iwp.STEPTOL, self.iwp.STALL_ITERS = self.STEPTOL, self.STALL_ITERS
        solve = type(self.be).newton_solve
        self.be.newton_solve = lambda theta, warm=None: solve(
            self.be, theta, max_iter=self.MAX_ITER, warm=warm)

    def __exit__(self, *exc):
        self.iwp.STEPTOL, self.iwp.STALL_ITERS = self.saved
        del self.be.newton_solve


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def dense_hessian(be, wts, th):
    """The unscaled (dpad + q)^2 Hessian in the engine's coordinates."""
    band = be.band_H(wts, th)
    C = be.C_block(wts, th)
    Hd = be.tail_gram(wts, th)
    dp, W = band.shape
    H = torch.zeros((dp + be.q, dp + be.q), dtype=torch.float64,
                    device=band.device)
    idx = torch.arange(dp, device=band.device)
    for o in range(W):
        H[idx[:dp - o] + o, idx[:dp - o]] = band[:dp - o, o]
    H[dp:, :dp] = C.T
    H[dp:, dp:] = torch.tril(Hd)
    return H + torch.tril(H, -1).T


def point_report(be, ba, th, state):
    """(a), (b), (d) at the inner mode `state` of theta `th`."""
    tht = torch.as_tensor(th, dtype=torch.float64, device=be.device)
    V, t = state
    out = {}
    with torch.no_grad():
        e0 = be.eta(V, t)
        band_s, C_s, Hd_s, sc, sd, wts = be._assemble_scaled(V, t, tht,
                                                             eta=e0)
        f = be._factor_scaled(band_s, C_s, sc, sd, wts, tht)
        S_gram = be._tail_schur(f.L, f.rinv, f.Y, sc, sd, wts, tht)
        YtY = f.Y.T @ f.Y
        S_diff = Hd_s - YtY
        Ls_diff, left_diff = ba.chol_jittered(S_diff)
        base = float(f.hld_b - torch.log(sc).sum() - torch.log(sd).sum())
        hld_gram = float(be.half_logdet_H((f, sc, sd)))
        hld_diff = base + float(torch.log(torch.diagonal(Ls_diff)).sum())
        H = dense_hessian(be, wts, tht)
        Lf, info = torch.linalg.cholesky_ex(H)
        dense = (float(torch.log(torch.diagonal(Lf)).sum())
                 if int(info) == 0 else float("nan"))
        dp = be.dpad
        S_dense = Lf[dp:, dp:] @ Lf[dp:, dp:].T * sd[:, None] * sd[None, :]
        del H, Lf
        out.update(
            eig_gram=torch.linalg.eigvalsh(S_gram).tolist(),
            eig_diff=torch.linalg.eigvalsh(S_diff).tolist(),
            eig_dense=torch.linalg.eigvalsh(S_dense).tolist(),
            max_Hd=float(Hd_s.abs().max()), max_YtY=float(YtY.abs().max()),
            max_S_diff=float(S_diff.abs().max()),
            gram_left=bool(f.tail_left), diff_left=bool(left_diff),
            hld_gram=hld_gram, hld_diff=hld_diff, hld_dense=dense,
            dense_info=int(info),
            min_pivot=float((f.rinv ** -2).min()),
            max_abs_Y=float(f.Y.abs().max()), y_cap=1e8,
            clamped=bool(f.clamped))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--theta", type=float, nargs=2, default=THETA_STAR)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=2000)
    ap.add_argument("--q", type=int, default=10_000)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    import bayesgp_torch as tbg
    from bayesgp_torch import api as tapi
    from bayesgp_torch.fast import banded, iwp
    from bayesgp_torch.linalg import band_arrow as ba

    th0 = np.asarray(args.theta, np.float64)
    dev = torch.device(args.device)
    t_start = time.perf_counter()
    data = bigiid_data(args.n, args.q)
    fml = FORMULA.format(k=args.k)
    asm = tapi.assemble_model(fml, data=data, family="Poisson",
                              engine="auto")
    be = tapi._backend(asm, "auto", dev)
    print(f"backend {type(be).__name__}: d={be.d} dpad={be.dpad} "
          f"bw={be.Wl - 1} q={be.q}; theta* {th0.tolist()}", flush=True)

    points = [("centre", th0)]
    for i in range(len(th0)):
        for sgn in (1, -1):
            e = np.zeros(len(th0))
            e[i] = sgn * H_STEP
            points.append((f"{'+' if sgn > 0 else '-'}h e{i}", th0 + e))
    rep = {}
    centre = None
    for name, th in points:
        t0 = time.perf_counter()
        v_def, g_def, st_def = be.value_and_grad(th, be.init_state())
        with Tight(iwp, be):
            v, g, st = be.value_and_grad(
                th, centre if centre is not None else be.init_state())
        if centre is None:
            centre = st
        r = point_report(be, ba, th, st)
        r.update(theta=th.tolist(), value=float(v),
                 grad=g.cpu().numpy().tolist(), value_default=float(v_def),
                 grad_default=g_def.cpu().numpy().tolist(),
                 value_diff=float(v) - r["hld_gram"] + r["hld_diff"],
                 seconds=time.perf_counter() - t0)
        rep[name] = r
        print(f"{name} theta {np.round(th, 6).tolist()} "
              f"({r['seconds']:.1f} s): value tight {r['value']:.6f} "
              f"(defaults {r['value_default']:.6f}), grad tight "
              f"{np.round(r['grad'], 4).tolist()} (defaults "
              f"{np.round(r['grad_default'], 4).tolist()})", flush=True)
        print(f"  (a) S eigenvalues: Gram {r['eig_gram']}, difference "
              f"{r['eig_diff']}, dense arbiter {r['eig_dense']}; max |Hd| "
              f"{r['max_Hd']:.3e}, |Y^T Y| {r['max_YtY']:.3e}, |S diff| "
              f"{r['max_S_diff']:.3e}; left its plain route: Gram "
              f"{r['gram_left']}, difference {r['diff_left']}", flush=True)
        print(f"  (b) half log-det: Gram {r['hld_gram']:.6f}, difference "
              f"{r['hld_diff']:.6f}, dense arbiter {r['hld_dense']:.6f} "
              f"(cholesky_ex info {r['dense_info']})", flush=True)
        print(f"  (d) min pivot {r['min_pivot']:.3e}, max |Y| "
              f"{r['max_abs_Y']:.3e} (cap 1e8), clamped {r['clamped']}",
              flush=True)
    cd = {}
    for key in ("value", "value_diff", "value_default"):
        cd[key] = [(rep[f"+h e{i}"][key] - rep[f"-h e{i}"][key])
                   / (2 * H_STEP) for i in range(len(th0))]
    print(f"central differences (step {H_STEP}): Gram tight "
          f"{np.round(cd['value'], 4).tolist()}, difference tight "
          f"{np.round(cd['value_diff'], 4).tolist()}, Gram defaults "
          f"{np.round(cd['value_default'], 4).tolist()}; gradient tight "
          f"{np.round(rep['centre']['grad'], 4).tolist()}", flush=True)

    calls = {"newton_step": 0, "value_and_grad": 0, "laplace_eval_full": 0}
    originals = {k: getattr(banded.BandedBackend, k) for k in calls}

    def counted(k):
        def f(self, *a, **kw):
            calls[k] += 1
            return originals[k](self, *a, **kw)
        return f
    for k in calls:
        setattr(banded.BandedBackend, k, counted(k))
    try:
        sync(dev)
        t0 = time.perf_counter()
        fit = tbg.model_fit(fml, data=data, family="Poisson",
                            engine="auto", aghq_k=3, M=1000, seed=0,
                            device=dev)
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        for k, f in originals.items():
            setattr(banded.BandedBackend, k, f)
    m = fit.mod
    ev = np.linalg.eigvalsh(np.asarray(m.hessian, np.float64))
    fit_rep = dict(wall=wall, mode=np.asarray(m.mode).tolist(),
                   hessian=np.asarray(m.hessian).tolist(),
                   eigenvalues=ev.tolist(),
                   lognormconst=float(m.lognormconst), calls=calls)
    print(f"model_fit (engine='auto'): {wall:.3f} s, mode "
          f"{np.round(m.mode, 6).tolist()}, outer Hessian eigenvalues "
          f"{ev.tolist()}, lognormconst {m.lognormconst:.6f}, calls {calls}",
          flush=True)
    card = (torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "cpu")
    summary = dict(card=card, theta_star=th0.tolist(), step=H_STEP,
                   points=rep, central_differences=cd, fit=fit_rep,
                   seconds=time.perf_counter() - t_start)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "merged_value_probe.json"),
              "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps({"central_differences": cd,
                      "gradient": rep["centre"]["grad"], "fit": fit_rep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
