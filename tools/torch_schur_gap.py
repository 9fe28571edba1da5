"""The replicate engine's half log-det against the one-response engine's
on one single-IWP design, theta by theta, with the factors' health flags.

Both engines form the Schur tail as a Gram of least-squares residuals
(fast/iwp.FastIWPBackend._tail_schur, fast/batched.BatchedFastIWP.
_tail_schur). This script takes R Poisson responses on the design of
chip_smoke.py's headline (or a smaller one), finds each response's mode
of the latent field with the one-response engine at each theta_IWP, and
factors the Hessian there with both engines: the one-response engine (K1
and its solves, one system at a time) and the replicate engine (K8 and
its solves, all systems at once), each on its kernels and on their plain
versions. For every system it prints the half log-det, its band part
(0.5 log|Hb|), its tail part (0.5 log|S|), the Jacobi scalings' part, and
whether a band pivot clamped or the tail factor left its plain route
(chol_jittered's jitter). So a gap between the engines shows where it
arises:

    python tools/torch_schur_gap.py                    # n = 1e5, k = 2000
    python tools/torch_schur_gap.py --n 2000 --k 40 --device cpu

It writes one JSON line per (theta, system) to chiprun_out/schur_gap.jsonl
and exits 0; it checks nothing.
"""
import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bayesgp_torch as tbg  # noqa: E402
from bayesgp_torch import api  # noqa: E402
from bayesgp_torch.fast import batched  # noqa: E402
from bayesgp_torch.linalg import band_kernels as bk  # noqa: E402
from chip_smoke import FORMULA, bench_data, replicate_ys  # noqa: E402


def parts(af, sc, sd, r=None):
    """(band part, tail part, scalings' part, clamped, tail_left) of one
    system's factor (r: its index in a batched factor)."""
    pick = (lambda x: x) if r is None else (lambda x: x[r])
    tail = float(torch.log(torch.diagonal(pick(af.Ls), dim1=-2,
                                          dim2=-1)).sum())
    scal = -float(torch.log(pick(sc)).sum() + torch.log(pick(sd)).sum())
    return (float(pick(af.hld_b)), tail, scal, bool(pick(af.clamped)),
            bool(pick(af.tail_left)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=2000)
    ap.add_argument("--R", type=int, default=2)
    ap.add_argument("--thetas", default="20,25,30,35,40")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dev = torch.device(a.device)
    asm = tbg.assemble_model(FORMULA.format(k=a.k), data=bench_data(a.n),
                             family="Poisson", engine="banded")
    be = api._backend(asm, "banded", dev)
    ys = replicate_ys(be, a.R)
    engines = {}
    for ops in ("kernels", "plain"):
        one_ops = bk.KERNELS if ops == "kernels" else bk.PLAIN
        engines[ops] = (
            [be.with_y(y) for y in ys],
            batched.build_batched(be, ys, force_engine=ops), one_ops)
    out = ROOT / "chiprun_out"
    os.makedirs(out, exist_ok=True)
    lines = []
    for t_iwp in (float(t) for t in a.thetas.split(",")):
        th = torch.tensor([t_iwp], dtype=torch.float64, device=dev)
        with torch.no_grad():
            states = [br.laplace_nll(th)[1] for br in engines["kernels"][0]]
            V, tail = (torch.stack(x) for x in zip(*states))
            for ops, (ones, tb, one_ops) in engines.items():
                f = tb.hessian_factor(V, tail, th.expand(a.R).contiguous())
                hb = tb.half_logdet_H(f).cpu().numpy()
                for r, br in enumerate(ones):
                    br = dataclasses.replace(
                        br, engine=br.engine.with_ops(one_ops))
                    fr = br.hessian_factor(*states[r], th)
                    h1 = float(br.half_logdet_H(fr))
                    rec = {"theta_IWP": t_iwp, "system": r, "ops": ops,
                           "one": {"hld": h1},
                           "replicate": {"hld": float(hb[r])}}
                    for key, p in (("one", parts(*fr)),
                                   ("replicate", parts(*f, r=r))):
                        rec[key].update(zip(("band", "tail", "scalings",
                                             "clamped", "tail_left"), p))
                    rec["gap"] = float(hb[r]) - h1
                    lines.append(rec)
                    print(json.dumps(rec), flush=True)
    with open(out / "schur_gap.jsonl", "w") as fh:
        fh.writelines(json.dumps(r) + "\n" for r in lines)


if __name__ == "__main__":
    main()
