#!/usr/bin/env python3
"""Check and time the band selected inverse (K4) and its batched twin
(K11) of this checkout on one CUDA card, beside those built from another
checkout's source.

    python3 tools/torch_takahashi_time.py [--other PATH/band_kernels.cu]

Builds bayesgp_torch/csrc/band_kernels.cu into bayesgp_torch/_build/ (and,
with --other, that source beside it under another name; both bind
bgt_band_takahashi and bgt_band_takahashi_batched with the same C
interface), then:
  - holds K4 to its plain version bit for bit at bw = 0..8 (d = 700) and
    bw = 12, 34, 70, 125 (d = 600), and K11 on 3 systems to K4 system by
    system, bit for bit; the other source's K4 to this one's at rtol
    1e-10 (its summation order may differ);
  - times K4 at (2048, 3) and at the (d, bw) of every shape chip_smoke.py
    sends to the chunked kernels, and K11 at 16 and 64 systems of (2048,
    3): ms a launch by CUDA events over back-to-back launches, in turns
    other, this, this, other; device ms from a CUDA graph of the launches
    where a launch takes under 2 ms (the host shows there).
Prints the card's name and power limit, then one JSON line of the
times. Imports nothing of JAX.
"""
import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import cuda_ms, dominant_band, graph_ms, require  # noqa: E402
K4_SHAPES = ((2048, 3), (16000, 13), (12000, 48), (14098, 34),
             (16384, 125), (16384, 8), (16384, 34))
K11_SHAPES = ((16, 2048, 3), (64, 2048, 3))


def factor(bk, dev, nr, d, bw, seed):
    """nr factors (nr, d, bw+1) of chip_smoke.py's seeded diagonally
    dominant bands, on the card."""
    Ls, rs = [], []
    for r in range(nr):
        band, _ = dominant_band(dev, d, bw, 0, seed + r)
        # K1 takes bw >= 1; its plain version any width
        fac = bk.band_factor if bw else bk.band_factor_plain
        L, rinv, _, _, _ = fac(band, band.new_zeros((d, 0)))
        Ls.append(L)
        rs.append(rinv)
    return torch.stack(Ls), torch.stack(rs)


def bind(path):
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bgt_band_takahashi.argtypes = [P, P, P, I, I, P]
    lib.bgt_band_takahashi_batched.argtypes = [P, P, P, I, I, I, P]
    lib.bgt_band_takahashi.restype = I
    lib.bgt_band_takahashi_batched.restype = I
    return lib


def call(bk, lib, L, rinv):
    """K4 (2-D L) or K11 (3-D L) of `lib` on the current stream."""
    Z = torch.empty_like(L)
    if L.dim() == 2:
        err = lib.bgt_band_takahashi(bk._ptr(L), bk._ptr(rinv), bk._ptr(Z),
                                     L.shape[0], L.shape[1] - 1,
                                     bk._stream(L))
    else:
        err = lib.bgt_band_takahashi_batched(
            bk._ptr(L), bk._ptr(rinv), bk._ptr(Z), L.shape[0], L.shape[1],
            L.shape[2] - 1, bk._stream(L))
    if err != 0:
        raise RuntimeError(f"takahashi launch: CUDA error {err}")
    return Z


def check(bk, bb, lib, other, dev):
    """Bit for bit with the plain versions; K11 with K4; the other
    source's K4 close."""
    for i, (d, bw) in enumerate([(700, b) for b in range(9)]
                                + [(600, b) for b in (12, 34, 70, 125)]):
        Lb, rb = factor(bk, dev, 3, d, bw, seed=40 + i)
        L, rinv = Lb[0], rb[0]
        Z = call(bk, lib, L, rinv)
        require(torch.equal(Z, bk.band_takahashi_plain(L, rinv)),
                f"K4 d={d} bw={bw} equals its plain version bit for bit")
        Zb = call(bk, lib, Lb, rb)
        require(all(torch.equal(Zb[r], call(bk, lib, Lb[r], rb[r]))
                    for r in range(3)),
                f"K11 d={d} bw={bw} equals K4 system by system")
        if bw in (3, 34):
            require(torch.equal(Zb, bb.band_takahashi_batched_plain(Lb, rb)),
                    f"K11 d={d} bw={bw} equals its plain version")
        if other is not None:
            Zo = call(bk, other, L, rinv)
            err = float((Zo - Z).abs().max()) / float(Z.abs().max())
            require(err <= 1e-10, f"the other K4 at d={d} bw={bw}: {err}")
    print("K4 bit for bit with its plain version at bw = 0..8 (d=700) and "
          "12, 34, 70, 125 (d=600); K11 with K4 system by system: ok",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", default=None,
                    help="band_kernels.cu of another checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    from bayesgp_torch.linalg import band_batched as bb
    from bayesgp_torch.linalg import band_kernels as bk
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(bk.build)]
        if args.other:
            jobs.append(pool.submit(bk.build_library, Path(args.other),
                                    "band_kernels_other"))
        paths = [j.result() for j in jobs]
    lib = bind(paths[0])
    other = bind(paths[1]) if args.other else None
    check(bk, bb, lib, other, dev)

    libs = {"this": lib}
    if other is not None:
        libs["other"] = other
    turns = ["other", "this", "this", "other"] if other else ["this"]
    out = {"card": card, "k4": {}, "k11": {}}
    cases = [("k4", f"{d}x{bw}", (1, d, bw)) for d, bw in K4_SHAPES]
    cases += [("k11", f"{nr}x{d}x{bw}", (nr, d, bw))
              for nr, d, bw in K11_SHAPES]
    for i, (kind, key, (nr, d, bw)) in enumerate(cases):
        L, rinv = factor(bk, dev, nr, d, bw, seed=60 + i)
        if kind == "k4":
            L, rinv = L[0], rinv[0]
        first = cuda_ms(lambda: call(bk, lib, L, rinv), n=1, warm=1)
        n = 3 if first > 20 else (10 if first > 2 else 50)
        row = {}
        for who in turns:
            f = (lambda lb=libs[who]: call(bk, lb, L, rinv))
            row.setdefault(who, []).append(cuda_ms(f, n=n))
            if first < 2:
                row.setdefault(who + "_device", []).append(graph_ms(f))
        out[kind][key] = row
        print(f"  {kind} {key}: " + ", ".join(
            f"{k} " + " / ".join(f"{v:.4f}" for v in vs)
            for k, vs in row.items()) + " ms", flush=True)
        del L, rinv
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
