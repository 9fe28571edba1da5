#!/usr/bin/env python3
"""Time the headline fit of chip_smoke.py phase 4 on one CUDA card with
the bayesgp_torch of a given checkout.

    python3 tools/torch_headline_time.py [--root DIR] [--fits N]

Imports DIR/bayesgp_torch (default: this checkout; its kernels are built
into DIR/bayesgp_torch/_build/ at first use), fits the bench.py problem
(n = 1e5, IWP3 k = 2000, Poisson, AGHQ k = 4, M = 3000; chip_smoke.py's
generator, seed 0) once to warm up and then N times (default 3), and
prints one JSON line: the card, the root, each timed fit's wall seconds
(host clock, ended by torch.cuda.synchronize()), the K1 launches of one
fit, the mode and the lognormconst. Two checkouts compare only within
one call, run in turns (parent, change, change, parent). Imports nothing
of JAX.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

FORMULA = "y ~ z + f(x, model='IWP', order=3, k=2000)"


def bench_data(n=100_000, seed=0):
    """The headline benchmark's generator (chip_smoke.py's copy)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 365.0, n))
    f_true = 1.5 + 0.8 * np.sin(2 * np.pi * x / 90.0) + 0.002 * x
    y = rng.poisson(np.exp(f_true)).astype(np.float64)
    z = rng.normal(0, 1, n)
    return {"x": x, "y": y, "z": z}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--fits", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import bayesgp_torch as tbg
    from bayesgp_torch.linalg import band_kernels as bk
    kw = dict(data=bench_data(), family="Poisson", method="aghq",
              engine="banded", M=3000, seed=0, device="cuda")
    fit = tbg.model_fit(FORMULA, **kw)
    walls = []
    for _ in range(args.fits):
        bk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = tbg.model_fit(FORMULA, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "root": root,
        "package": os.path.dirname(tbg.__file__), "walls": walls,
        "k1_launches": bk.launches["band_factor"],
        "mode": float(fit.mod.mode[0]),
        "lognormconst": float(fit.mod.lognormconst)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
