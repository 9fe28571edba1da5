"""Whether one strided-batched product forms R systems' Grams with the
same bits whatever R, as fast/iwp.design_gram and schur_gram need.

For each tail width q and row count n, E (R, q, n) holds seeded normal
rows. The per-system loop ([E_r @ E_r^T for r]) and one torch.bmm (E @
E^T) are run at R = 1, 4, 16 and 64; the script prints, for each, whether
every system's Gram equals its R = 1 Gram bit for bit, and the time of
one call by CUDA events (median of 20 after 3 warm calls).

    python3 tools/torch_gram_bits.py            (a card, ~20 s)
    python3 tools/torch_gram_bits.py --device cpu --n 2000
"""
import argparse
import json
import statistics

import torch


def timed(fn, dev, n=20, warm=3):
    for _ in range(warm):
        fn()
    if dev.type != "cuda":
        return None
    out = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=100_000)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no card: pass --device cpu")
    g = torch.Generator(device=dev).manual_seed(0)
    ways = {"loop": lambda E: torch.stack([a @ a.T for a in E]),
            "bmm": lambda E: torch.bmm(E, E.mT)}
    for q in (2, 4, 16, 40):
        E = torch.randn((64, q, args.n), generator=g, device=dev,
                        dtype=torch.float64)
        for way, fn in ways.items():
            one = torch.stack([fn(E[r:r + 1])[0] for r in range(64)])
            for R in (1, 4, 16, 64):
                got = fn(E[:R])
                print(json.dumps(dict(
                    q=q, n=args.n, way=way, R=R,
                    same_as_R1=bool(torch.equal(got, one[:R])),
                    loop_equal=bool(torch.equal(got, ways["loop"](E[:R]))),
                    ms=timed(lambda: fn(E[:R]), dev))), flush=True)


if __name__ == "__main__":
    main()
