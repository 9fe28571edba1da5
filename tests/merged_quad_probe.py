"""Where the merged-IID Laplace value leaves the reference at large
theta_IWP: the driver's prior quadratic.

Both port engines (the merged-IID BandedBackend and the scattered-IID
backend) and, on the CPU, the JAX package's merged backend (its CPU-f64
BlockEngine, which has no sick-factor gate and no pivot clamp) evaluate
the Laplace nll and its theta gradient, cold, at a sweep of thetas of
the bench_bigiid model (an IWP3 smooth plus an IID term whose levels are
clustered in x, Poisson). At each theta the script prints, for the
merged engines' inner modes, the smallest band pivot and the gate's
reasons, and the driver's prior quadratic r^T P r, r = V' - Z0 t, three
ways: expanded from the host-built arrays, as the JAX package evaluates
it,

  V'^T P V' - 2 t^T Z0^T P V' + t^T Z0^T P Z0 t,

as the port's engines take it, the sum of squares sum_i w_i ((T r)_i)^2
(P = T^T diag(w) T), and that sum in numpy.longdouble from the same f64
arrays, the arbiter neither form supplies. It also prints the
eigenvalues of the inner Hessian on the directions V' = Z0 t. Once, it
prints the eigenvalues of the (q, q) matrix N that the expanded form
takes on those directions, its null space in exact arithmetic:
N = Z0^T P Z0 - PZ0^T Z0 - Z0^T PZ0 + Z0PZ0, with P_band, PZ0 and
Z0PZ0 as the host builds them (apart from each other). The value
carries 0.5 e^theta_IWP times the quadratic: where the expanded form is
rounding of either sign, the value is unbounded below in theta_IWP.

    python tests/merged_quad_probe.py               # CPU f64, n = 1e4,
        # IWP3 k = 200, 1,000 levels merged (bw = 34, q = 3, as at full
        # size), with the JAX package's merged backend beside the port's
    python tests/merged_quad_probe.py --full --device cuda
        # the bench_bigiid size (n = 1e5, k = 2000, 1e4 levels) on a
        # card, the port's engines only (no JAX)

Not collected by pytest; it asserts nothing and prints what it finds.
"""
import argparse
import math
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

FORMULA = "y ~ f(x, model='IWP', order=3, k={k}) + f(g, model='IID')"
THETAS = ((14.519049, 3.770622), (20.0, 3.77), (25.0, 3.77), (30.0, 4.36),
          (40.0, 4.36), (51.240565, 4.359255))


def bigiid_data(n, q, seed=0):
    """The JAX package's bench_bigiid generator (levels clustered in x)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 365.0, n))
    g = np.minimum(np.floor(x * (q / 365.0)), q - 1)
    u_true = 0.15 * rng.normal(size=int(g.max()) + 1)
    f_true = 1.5 + 0.8 * np.sin(2 * np.pi * x / 90.0) + 0.002 * x
    y = rng.poisson(np.exp(f_true + u_true[g.astype(int)])).astype(float)
    return {"y": y, "x": x, "g": g}


def _host(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                      np.float64)


def band_apply(Pb, X):
    """P X for the symmetric band Pb[o, j] = P[j+o, j] and X (d,) or (d, m),
    in the array's own type."""
    d = Pb.shape[1]
    Pb = Pb.reshape(Pb.shape + (1,) * (X.ndim - 1))
    out = Pb[0] * X
    for o in range(1, Pb.shape[0]):
        out[o:] += Pb[o, :d - o] * X[:-o]
        out[:-o] += Pb[o, :d - o] * X[o:]
    return out


def quad_forms(be, V, t, w):
    """The driver's prior quadratic at (V', t), from either package's
    backend arrays and the port's weights w of P = T^T diag(w) T: (the
    expanded form's three terms and value in f64, the sum of squares in
    f64, the sum of squares in longdouble)."""
    d = be.d
    Vd, t = _host(V)[:d], _host(t)
    Pb, Td, Z0 = _host(be.P_band), _host(be.Tdiags), _host(be.Z0)
    terms = [float(Vd @ band_apply(Pb, Vd)),
             float(2.0 * t @ (_host(be.PZ0).T @ Vd)),
             float(t @ (_host(be.Z0PZ0) @ t))]
    w = _host(w)
    out = []
    for typ in (np.float64, np.longdouble):
        r = Vd.astype(typ) - Z0.astype(typ) @ t.astype(typ)
        Tt = Td.astype(typ)
        U = Tt[0] * r
        for o in range(1, Tt.shape[0]):
            U[o:] += Tt[o, o:] * r[:-o]
        out.append((w.astype(typ) * U * U).sum())
    return terms, terms[0] - terms[1] + terms[2], out[0], out[1]


def show_quad(name, forms, th):
    terms, expanded, sos, arbiter = forms
    half = 0.5 * math.exp(th[0])
    print(f"    {name} prior quadratic: expanded {expanded:.6e} (terms "
          f"{terms}), sum of squares {float(sos):.6e}, longdouble arbiter "
          f"{float(arbiter):.6e}; times 0.5 e^theta: {half * expanded:.6e}, "
          f"{half * float(sos):.6e}, {half * float(arbiter):.6e} nats",
          flush=True)


def null_form(be):
    """Eigenvalues of N, the expanded prior form on V' = Z0 t."""
    Z0, PZ0, Z0PZ0 = _host(be.Z0), _host(be.PZ0), _host(be.Z0PZ0)
    N = (Z0.T @ band_apply(_host(be.P_band), Z0) - PZ0.T @ Z0 - Z0.T @ PZ0
         + Z0PZ0)
    ev = np.linalg.eigvalsh(0.5 * (N + N.T))
    print(f"  the expanded prior form on V' = Z0 t: eigenvalues of N {ev} "
          f"(largest |entry| of Z0PZ0 {np.abs(Z0PZ0).max():.3e})",
          flush=True)


def restricted_hessian(be, V, t, th):
    """Eigenvalues of J^T H J, J = [Z0; I]: the inner Hessian at the inner
    mode (V, t) of theta on the directions V' = Z0 t."""
    from bayesgp_torch.model import families
    tht = torch.as_tensor(th, dtype=torch.float64, device=V.device)
    wts = families.eta_weights(be.eta(V, t), be.md, tht)
    band = be.band_H(wts, tht)        # band[j, o] = H[j + o, j]
    C = be.C_block(wts, tht)
    X = be._pad_d(be.Z0)
    HX = band[:, :1] * X
    for o in range(1, band.shape[1]):
        HX[o:] += band[:-o, o:o + 1] * X[:-o]
        HX[:-o] += band[:-o, o:o + 1] * X[o:]
    R = X.T @ HX + X.T @ C + C.T @ X + be.tail_gram(wts, tht)
    return torch.linalg.eigvalsh(0.5 * (R + R.T)).cpu().numpy()


def jax_reference(data, fml):
    """(value_and_grad, inner mode) programs of the JAX package's merged
    backend on the CPU in f64."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from bayesgp_tpu import api as japi
    from bayesgp_tpu.fast.banded import build_banded_backend
    from _jax_quick import quick_jit
    asm = japi.assemble_model(fml, data=data, family="Poisson",
                              engine="banded")
    jb = build_banded_backend(asm["instances"], asm["md"],
                              asm["design_mat_fixed"], asm["bf_prec"],
                              asm["bf_mean"])
    print(f"  JAX merged backend: engine {type(jb.engine).__name__}, "
          f"d={jb.d}, q={jb.q}", flush=True)
    vg = quick_jit(jax.value_and_grad(lambda th: jb.laplace_nll(th)[0]))
    mode = quick_jit(jb.solve_W_star)
    return jb, vg, mode, jnp


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the bench_bigiid size (n=1e5, k=2000, q=1e4)")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--no-jax", action="store_true",
                    help="skip the JAX package's merged backend")
    args = ap.parse_args()
    from bayesgp_torch import api as tapi
    n, k, q = (100_000, 2000, 10_000) if args.full else (10_000, 200, 1000)
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(2)
    data = bigiid_data(n, q)
    fml = FORMULA.format(k=k)
    engine = "auto" if args.full else "banded"
    bm = tapi._backend(tapi.assemble_model(fml, data=data, family="Poisson",
                                           engine=engine), engine, dev)
    bs = tapi._backend(tapi.assemble_model(fml, data=data, family="Poisson",
                                           engine="scatter_iid"),
                       "scatter_iid", dev)
    print(f"n={n}, IWP3 k={k}, {q} levels; merged d={bm.d}, bw={bm.Wl - 1}"
          f", q={bm.q}; {args.device}", flush=True)
    ref = None
    if not (args.no_jax or args.full or dev.type != "cpu"):
        ref = jax_reference(data, fml)
    null_form(bm)
    for th in map(np.asarray, THETAS):
        t0 = time.perf_counter()
        vm, gm, (V, t) = bm.value_and_grad(th, bm.init_state())
        vs, gs, _ = bs.value_and_grad(th, bs.init_state())
        print(f"theta {th.tolist()}", flush=True)
        print(f"  port merged {float(vm):.6f} {gm.cpu().numpy()}; port "
              f"scatter_iid {float(vs):.6f} {gs.cpu().numpy()}", flush=True)
        with torch.no_grad():
            tht = torch.as_tensor(th, dtype=torch.float64, device=dev)
            af = bm.hessian_factor(V, t, tht)[0]
            reasons = [bool(x) for x in bm.engine.gate_reasons(af)]
            print(f"    port merged: smallest pivot "
                  f"{float((af.rinv ** -2).min()):.3e}, gate reasons "
                  f"(pivot clamped, tail left, not finite) {reasons}")
            show_quad("port merged", quad_forms(bm, V, t, bm.prior_w), th)
            print(f"    port merged: inner Hessian on V' = Z0 t, eigenvalues "
                  f"{restricted_hessian(bm, V, t, th)}", flush=True)
        if ref is not None:
            jb, vg, mode, jnp = ref
            vj, gj = vg(jnp.asarray(th))
            Vj, tj = mode(jnp.asarray(th))
            print(f"  JAX merged (BlockEngine) {float(vj):.6f} "
                  f"{np.asarray(gj)}", flush=True)
            show_quad("JAX merged", quad_forms(jb, Vj, tj, bm.prior_w), th)
        print(f"  {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
