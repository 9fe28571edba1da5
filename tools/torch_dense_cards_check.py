"""K6 and K7 of bayesgp_torch on every visible CUDA card in turn.

The dense kernels raise their dynamic shared-memory limit once per card
(csrc/dense_kernels.cu, allow_smem): a launch on a second card after one
on the first must still get its 128 KB (K6) and 66 KB (K7). This script
launches `dense_factor_block` and `dense_solve_lower` (both ways, r = 1
and r = 2051) on card 0, then on every other card, then on card 0 again,
and holds each result against the plain version on the same card: K7 bit
for bit, K6 to 1e-12 of the block's largest entry (chip_smoke.py's
DENSE_RTOL). It needs two or more cards:

    python tools/torch_dense_cards_check.py

It prints one line per card and exits non-zero on any disagreement or
launch error.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bayesgp_torch.linalg import chol_dense as cd  # noqa: E402


def check_card(i, gen):
    dev = torch.device("cuda", i)
    A = torch.randn((cd.B, cd.B), generator=gen, dtype=torch.float64)
    S = (A @ A.T / cd.B + torch.eye(cd.B, dtype=torch.float64)).to(dev)
    L = cd.dense_factor_block(S)
    Lp = cd.dense_factor_block_plain(S)
    ok = bool((L - Lp).abs().max() <= 1e-12 * Lp.abs().max())
    for r in (1, 2051):
        Bm = torch.randn((cd.B, r), generator=gen,
                         dtype=torch.float64).to(dev)
        for trans in (False, True):
            got = cd.dense_solve_lower(L, Bm, trans=trans)
            ok &= torch.equal(got, cd.dense_solve_lower_plain(L, Bm, trans))
    torch.cuda.synchronize(dev)
    print(f"card {i} ({torch.cuda.get_device_name(i)}): K6, K7 r=1, 2051 "
          f"both ways {'equal' if ok else 'DIFFER'} to their plain versions",
          flush=True)
    return ok


def main():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("needs two or more CUDA cards", file=sys.stderr)
        return 2
    gen = torch.Generator().manual_seed(0)
    cards = list(range(torch.cuda.device_count())) + [0]
    ok = all([check_card(i, gen) for i in cards])
    print(f"launches {cd.launches}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
