#!/usr/bin/env python3
"""Time the headline fit of chip_smoke.py phase 4, its packed replicate
fits (phase 6, R = 64) or its merged-IID fit (phase 14) on one CUDA card
with the bayesgp_torch of a given checkout.

    python3 tools/torch_headline_time.py [--root DIR] [--fits N]
                                         [--cell headline|replicates|merged]

Imports DIR/bayesgp_torch (default: this checkout; its kernels are built
into DIR/bayesgp_torch/_build/ at first use), fits the cell once to warm
up and then N times (default 3), and prints one JSON line: the card, the
root, the cell, each timed fit's wall seconds (host clock, ended by
torch.cuda.synchronize()), the K1 launches of one fit, the mode and the
lognormconst. The headline cell is the bench.py problem (n = 1e5, IWP3 k
= 2000, Poisson, AGHQ k = 4, M = 3000); the merged cell the
bench_bigiid problem (the same x with an IID term of 1e4 levels
clustered in x, engine "auto", which merges them into the band; AGHQ k =
3, M = 1000); the replicates cell 64 Poisson responses around the
headline's (chip_smoke.replicate_ys) fitted by replicate_fits_packed
(AGHQ k = 4), its walls per fit; chip_smoke.py's generators, seed 0.
Two checkouts
compare only within one call, run in turns (parent, change, change,
parent). Imports nothing of JAX.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

FORMULA = "y ~ z + f(x, model='IWP', order=3, k=2000)"
MERGED_FORMULA = "y ~ f(x, model='IWP', order=3, k=2000) + f(g, model='IID')"


def bench_data(n=100_000, seed=0):
    """The headline benchmark's generator (chip_smoke.py's copy)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 365.0, n))
    f_true = 1.5 + 0.8 * np.sin(2 * np.pi * x / 90.0) + 0.002 * x
    y = rng.poisson(np.exp(f_true)).astype(np.float64)
    z = rng.normal(0, 1, n)
    return {"x": x, "y": y, "z": z}


def bigiid_data(n=100_000, q=10_000, seed=0):
    """The bench_bigiid generator (chip_smoke.py's copy)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 365.0, n))
    g = np.minimum(np.floor(x * (q / 365.0)), q - 1)
    u_true = 0.15 * rng.normal(size=int(g.max()) + 1)
    f_true = 1.5 + 0.8 * np.sin(2 * np.pi * x / 90.0) + 0.002 * x
    y = rng.poisson(np.exp(f_true + u_true[g.astype(int)])).astype(float)
    return {"y": y, "x": x, "g": g}


def time_replicates(tbg, fits, root, R=64):
    """Packed replicate fits of R responses on the headline design."""
    from bayesgp_torch.parallel.replicates import replicate_fits_packed
    fit = tbg.model_fit(FORMULA, data=bench_data(), family="Poisson",
                        method="aghq", engine="banded", M=10, seed=0,
                        device="cuda")
    be = fit.mod.backend
    rng = np.random.default_rng(1)
    base = be.md.y.cpu().numpy()
    inv = np.argsort(np.asarray(be.row_order))
    lam = np.maximum(base, 0.5)
    ys = np.stack([rng.poisson(lam)[inv].astype(np.float64)
                   for _ in range(R)])
    replicate_fits_packed(be, ys, k=4)
    walls = []
    for _ in range(fits):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        modes, lncs = replicate_fits_packed(be, ys, k=4)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / R)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "root": root,
        "cell": "replicates", "R": R, "walls_per_fit": walls,
        "mode_mean": float(np.mean(modes)),
        "lognormconst_sum": float(np.sum(lncs))}))
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--fits", type=int, default=3)
    ap.add_argument("--cell", choices=("headline", "replicates", "merged"),
                    default="headline")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import bayesgp_torch as tbg
    from bayesgp_torch.linalg import band_kernels as bk
    if args.cell == "replicates":
        return time_replicates(tbg, args.fits, root)
    if args.cell == "headline":
        formula = FORMULA
        kw = dict(data=bench_data(), family="Poisson", method="aghq",
                  engine="banded", M=3000, seed=0, device="cuda")
    else:
        formula = MERGED_FORMULA
        kw = dict(data=bigiid_data(), family="Poisson", aghq_k=3, M=1000,
                  seed=0, device="cuda")
    fit = tbg.model_fit(formula, **kw)
    walls = []
    for _ in range(args.fits):
        bk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = tbg.model_fit(formula, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "root": root,
        "cell": args.cell,
        "package": os.path.dirname(tbg.__file__), "walls": walls,
        "k1_launches": bk.launches["band_factor"],
        "mode": np.asarray(fit.mod.mode, float).tolist(),
        "lognormconst": float(fit.mod.lognormconst)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
