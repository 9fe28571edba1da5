"""The port's CPU-f64 fits that chip_smoke.py holds its dense-route
phases to: the sGP lynx vignette (phase 19, LYNX_CPU) and the three fits
of the dense route's largest cell (phase 20, DENSE_CPU). It runs the
same model_fit calls as those phases, with device="cpu":

    python tools/torch_dense_reference.py

and prints the values as the two constants' JSON, with each fit's wall
time. It checks nothing.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bayesgp_torch as tbg  # noqa: E402
import chip_smoke  # noqa: E402


def timed_fit(formula, **kw):
    t0 = time.perf_counter()
    fit = tbg.model_fit(formula, device="cpu", **kw)
    return fit, time.perf_counter() - t0


def main():
    torch.set_num_threads(max(1, min(8, torch.get_num_threads())))
    lynx, wall = timed_fit(chip_smoke.LYNX_FORMULA,
                           **chip_smoke.lynx_kwargs(tbg))
    print(f"lynx: {wall:.1f} s", flush=True)
    dense = {}
    for label, formula, kw in chip_smoke.dense_boundary_cases():
        fit, wall = timed_fit(formula, **kw)
        dense[label] = chip_smoke.dense_result(fit)
        print(f"{label}: {wall:.1f} s", flush=True)
    print("LYNX_CPU = " + json.dumps(
        {"mode": np.asarray(lynx.mod.mode, float).tolist(),
         "lognormconst": float(lynx.mod.lognormconst)}))
    print("DENSE_CPU = " + json.dumps(dense))


if __name__ == "__main__":
    main()
