#!/usr/bin/env python3
"""Drive the bayesgp_torch port on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card, the toolkit, and the build of the CUDA band kernels
     (csrc/band_kernels.cu, nvcc for sm_90a into bayesgp_torch/_build/);
  2. each kernel K1-K5 against its plain PyTorch version on the card at
     the shapes the headline fit gives it (d = 2048, bw = 3, q = 4,
     M = 3000 draws), with kernel / plain / library timings; then the
     batched kernels K8-K11 at the shapes the replicate fits give them
     (NR = 16 and 64 systems of d = 2048, bw = 3; 1 and 4 right-hand
     sides) against their plain versions and, system by system, against
     K1-K4 bit for bit;
  3. a small fit on the card against the CPU-f64 reference values, and
     small replicate fits (R = 5 in groups of 2) packed against
     sequential;
  4. the headline fit: model_fit at n = 1e5, IWP order 3, k = 2000,
     Poisson, AGHQ k = 4, M = 3000, counting every kernel launch;
  5. the kernel engine against the plain engine at a fixed (theta, V,
     tail) point of that fit;
  6. replicate fits on the headline design: replicate_fits_packed at
     R = 16 and R = 64 (twice each), a profiled Laplace evaluation at
     R = 64, replicate_fits at R = 4, counting the launches of K8-K11;
  7. the batched kernel engine against the batched plain engine at a
     fixed point of the R = 16 run.
A line near the end is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP64_FLOPS_PER_S = 34e12       # H100 SXM FP64 outside the tensor cores
N_OBS, K_KNOTS = 100_000, 2000
D, BW, Q, M_DRAWS = 2048, 3, 4, 3000
RTOL = 1e-10
SOURCE = "bayesgp_torch/csrc/band_kernels.cu"
REPLACES = {
    "band_factor": "bayesgp_tpu/linalg/band_kernels.py:182",
    "band_fwd_solve": "bayesgp_tpu/linalg/band_kernels.py:230",
    "band_bwd_solve": "bayesgp_tpu/linalg/band_kernels.py:281",
    "band_takahashi": "bayesgp_tpu/linalg/band_kernels.py:405",
    "band_bwd_multi": "bayesgp_tpu/linalg/band_kernels.py:328",
    "band_factor_batched": "bayesgp_tpu/linalg/band_batched.py:140",
    "band_fwd_solve_batched": "bayesgp_tpu/linalg/band_batched.py:186",
    "band_bwd_solve_batched": "bayesgp_tpu/linalg/band_batched.py:230",
    "band_takahashi_batched": "bayesgp_tpu/linalg/band_batched.py:293",
}
# systems a launch in the batched kernel checks; the kernels line reports
# the last
BATCH_SIZES = (16, 64)
REPLICATE_TOL = 2e-5
FORMULA = "y ~ z + f(x, model='IWP', order=3, k={k})"
# CPU-f64 values of the JAX package on the same generator (seed 0)
SMALL_REF = {"mode": 14.064024, "lognormconst": -4705.760766}
HEADLINE_CPU_REF = {"mode": 14.670086, "H": -1038.38,
                    "lognormconst": -231831.516962}


T_START = time.perf_counter()


def log(*a):
    """Print a line; phase headers carry the seconds since the start."""
    if a and str(a[0]).startswith("=="):
        a = (*a, f"[{time.perf_counter() - T_START:.0f} s]")
    print(*a, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def nvcc_version(bk):
    out = subprocess.run([bk.nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[-1]


def cuda_ms(fn, n=20, warm=2):
    """Mean milliseconds per call over n warm calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def bench_data(n, seed=0):
    """The headline benchmark's generator (daily series, Poisson)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 365.0, n))
    f_true = 1.5 + 0.8 * np.sin(2 * np.pi * x / 90.0) + 0.002 * x
    y = rng.poisson(np.exp(f_true)).astype(np.float64)
    z = rng.normal(0, 1, n)
    return {"x": x, "y": y, "z": z}


def spd_problem(dev, d, bw, q, seed=0):
    """Seeded equilibrated SPD band (d, bw+1), tail block C (d, q), dense
    tail Hd and the dense (d+q)^2 arrowhead, on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    i = torch.arange(d, device=dev)
    near = (i[:, None] - i[None, :]).abs() <= bw
    L0 = 0.4 * torch.randn((d, d), generator=g, device=dev,
                           dtype=torch.float64).tril(-1) * near
    L0 = L0 + torch.diag(1.5 + torch.rand(d, generator=g, device=dev,
                                          dtype=torch.float64))
    A = L0 @ L0.T
    s = torch.rsqrt(torch.diagonal(A))
    A = A * s[:, None] * s[None, :]
    band = torch.stack([torch.cat([torch.diagonal(A, -o),
                                   A.new_zeros(o)]) for o in range(bw + 1)],
                       dim=1).contiguous()
    C = 0.1 * torch.randn((d, q), generator=g, device=dev,
                          dtype=torch.float64)
    Hq = torch.randn((q, q), generator=g, device=dev, dtype=torch.float64)
    Hd = Hq @ Hq.T + torch.eye(q, device=dev, dtype=torch.float64) \
        + C.T @ torch.linalg.solve(A, C)
    Hfull = torch.cat([torch.cat([A, C], 1), torch.cat([C.T, Hd], 1)], 0)
    return A, band, C, Hfull


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def check_close(name, got, want, rtol=RTOL):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= rtol * max(scale, 1e-300)
    log(f"  {name}: max|kernel - plain| = {err:.3e} (scale {scale:.3e}, "
        f"rtol {rtol:g}) {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel agrees with plain version")
    return err


def bound(nbytes, flops):
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / FP64_FLOPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def phase_kernels(bk, dev):
    """K1-K5 against their plain versions at the headline shapes."""
    log("== phase 2: kernels against their plain versions "
        f"(d={D}, bw={BW}, q={Q}, M={M_DRAWS})")
    A, band, C, Hfull = spd_problem(dev, D, BW, Q)
    W = BW + 1
    rows = {}

    L, rinv, Y, hld = bk.band_factor(band, C)
    Lp, rinvp, Yp, hldp = bk.band_factor_plain(band, C)
    err = max(check_close("K1 L", L, Lp), check_close("K1 rinv", rinv, rinvp),
              check_close("K1 Y", Y, Yp), check_close("K1 hld", hld, hldp))
    f8 = 8
    rows["band_factor"] = dict(
        err=err, ms=cuda_ms(lambda: bk.band_factor(band, C)),
        plain_ms=cuda_ms(lambda: bk.band_factor_plain(band, C), n=3, warm=1),
        library_ms=cuda_ms(lambda: torch.linalg.cholesky(Hfull)),
        nbytes=f8 * D * (2 * W + 2 * Q + 1) + f8,
        flops=D * (2 * BW + 3 + BW * (BW - 1) + BW + Q * (2 * BW + 1)))

    # an indefinite band: the pivot clamp and caps must agree and stay finite
    bad = band.clone()
    bad[10, 0] = -0.8
    bad[40, 0] = 1e-14
    Lb, _, Yb, hb = bk.band_factor(bad, C)
    Lbp, _, Ybp, hbp = bk.band_factor_plain(bad, C)
    check_close("K1 indefinite L", Lb, Lbp)
    check_close("K1 indefinite Y", Yb, Ybp)
    check_close("K1 indefinite hld", hb, hbp)

    Ld = torch.zeros((D, D), dtype=torch.float64, device=dev)
    for o in range(W):
        Ld += torch.diag(L[:D - o, o], -o)
    g = torch.Generator(device=dev).manual_seed(1)
    for name, fn, plain, upper in (
            ("band_fwd_solve", bk.band_fwd_solve, bk.band_fwd_solve_plain,
             False),
            ("band_bwd_solve", bk.band_bwd_solve, bk.band_bwd_solve_plain,
             True)):
        errs = []
        for r in (1, Q, 128):
            B = torch.randn((D, r), generator=g, device=dev,
                            dtype=torch.float64)
            errs.append(check_close(f"{name} r={r}", fn(L, rinv, B),
                                    plain(L, rinv, B)))
        B = torch.randn((D, 1), generator=g, device=dev, dtype=torch.float64)
        Lib = Ld.T if upper else Ld
        rows[name] = dict(
            err=max(errs), ms=cuda_ms(lambda: fn(L, rinv, B)),
            plain_ms=cuda_ms(lambda: plain(L, rinv, B), n=3, warm=1),
            library_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
                Lib, B, upper=upper)),
            nbytes=f8 * (D * W + D + 2 * D), flops=D * (2 * BW + 1))
        for r in (Q, 128):
            Br = torch.randn((D, r), generator=g, device=dev,
                             dtype=torch.float64)
            log(f"  {name} r={r}: {cuda_ms(lambda: fn(L, rinv, Br)):.4f} ms")

    Z = bk.band_takahashi(L, rinv)
    Zp = bk.band_takahashi_plain(L, rinv)
    err = check_close("K4 band of H^-1", Z, Zp)
    Hinv = torch.linalg.inv(A)
    ref = torch.stack([torch.cat([torch.diagonal(Hinv, -o), A.new_zeros(o)])
                       for o in range(W)], dim=1)
    check_close("K4 against dense inverse", Z, ref, rtol=1e-8)
    rows["band_takahashi"] = dict(
        err=err, ms=cuda_ms(lambda: bk.band_takahashi(L, rinv)),
        plain_ms=cuda_ms(lambda: bk.band_takahashi_plain(L, rinv), n=3,
                         warm=1),
        library_ms=cuda_ms(lambda: torch.cholesky_inverse(Ld)),
        nbytes=f8 * (2 * D * W + D), flops=D * (2 * BW * BW + 2 * BW + 2))

    Zn = torch.randn((D, M_DRAWS), generator=g, device=dev,
                     dtype=torch.float64)
    X = bk.band_bwd_multi(L, rinv, Zn)
    err = check_close("K5 draws", X, bk.band_bwd_multi_plain(L, rinv, Zn))
    rows["band_bwd_multi"] = dict(
        err=err, ms=cuda_ms(lambda: bk.band_bwd_multi(L, rinv, Zn)),
        plain_ms=cuda_ms(lambda: bk.band_bwd_multi_plain(L, rinv, Zn), n=3,
                         warm=1),
        library_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
            Ld.T, Zn, upper=True)),
        nbytes=f8 * (D * W + D + 2 * D * M_DRAWS),
        flops=D * M_DRAWS * (2 * BW + 1))
    check_other_shapes(bk, dev)
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r["nbytes"], r["flops"])
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.2f} "
            f"ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}), "
            f"{r['ms'] / D * 1e3:.3f} us per column")
    return rows


def check_other_shapes(bk, dev):
    """Shapes off the headline path, for the kernels' other code paths:
    a band wider than the register-window kernels take (bw = 12), and a
    factor with no tail (q = 0)."""
    for d, bw, q in ((300, 12, 4), (300, BW, 0)):
        _, band, C, _ = spd_problem(dev, d, bw, q, seed=2)
        tag = f"d={d} bw={bw} q={q}"
        L, rinv, Y, hld = bk.band_factor(band, C)
        Lp, rinvp, Yp, hldp = bk.band_factor_plain(band, C)
        for name, a, b in (("L", L, Lp), ("rinv", rinv, rinvp),
                           ("hld", hld, hldp)):
            check_close(f"K1 {name} {tag}", a, b)
        if q:
            check_close(f"K1 Y {tag}", Y, Yp)
        B = torch.randn((d, 5), device=dev, dtype=torch.float64)
        for name, fn, plain in (
                ("K2", bk.band_fwd_solve, bk.band_fwd_solve_plain),
                ("K3", bk.band_bwd_solve, bk.band_bwd_solve_plain),
                ("K5", bk.band_bwd_multi, bk.band_bwd_multi_plain)):
            check_close(f"{name} {tag}", fn(L, rinv, B), plain(L, rinv, B))
        check_close(f"K4 {tag}", bk.band_takahashi(L, rinv),
                    bk.band_takahashi_plain(L, rinv))


def spd_batch(dev, nr, d, bw, seed=0):
    """nr seeded equilibrated SPD band systems on the card: the dense
    (nr, d, d) matrices and their (nr, d, bw+1) bands."""
    g = torch.Generator(device=dev).manual_seed(seed)
    i = torch.arange(d, device=dev)
    near = (i[:, None] - i[None, :]).abs() <= bw
    A = 0.4 * torch.randn((nr, d, d), generator=g, device=dev,
                          dtype=torch.float64).tril(-1) * near
    A = A + torch.diag_embed(1.5 + torch.rand(
        (nr, d), generator=g, device=dev, dtype=torch.float64))
    A = A @ A.mT
    s = torch.rsqrt(torch.diagonal(A, dim1=1, dim2=2))
    A = A * s[:, :, None] * s[:, None, :]
    bands = torch.stack(
        [torch.cat([torch.diagonal(A, -o, 1, 2), A.new_zeros((nr, o))], 1)
         for o in range(bw + 1)], dim=2).contiguous()
    return A, bands


def dense_lower(L):
    """(nr, d, bw+1) factor bands -> dense (nr, d, d) lower factors."""
    nr, d, W = L.shape
    out = L.new_zeros((nr, d, d))
    for o in range(W):
        out += torch.diag_embed(L[:, :d - o, o], -o)
    return out


def check_equal(name, got, want):
    ok = torch.equal(got, want)
    if not ok:
        log(f"  {name}: max|diff| = {float((got - want).abs().max()):.3e}")
    require(ok, f"{name}: equal bit for bit")


def check_batched_against_one_system(bk, bb, tag, bands, Bs):
    """K8-K11 on a batch against their plain versions (RTOL) and, system
    by system, against K1 (no tail), K2, K3 and K4 bit for bit. Returns
    the factor and the largest kernel-plain difference per kernel."""
    nr, d, _ = bands.shape
    L, rinv, hld = bb.band_factor_batched(bands)
    Lp, rinvp, hldp = bb.band_factor_batched_plain(bands)
    errs = {"band_factor_batched": max(
        check_close(f"K8 L {tag}", L, Lp),
        check_close(f"K8 rinv {tag}", rinv, rinvp),
        check_close(f"K8 hld {tag}", hld, hldp))}
    Z = bb.band_takahashi_batched(L, rinv)
    errs["band_takahashi_batched"] = check_close(
        f"K11 {tag}", Z, bb.band_takahashi_batched_plain(L, rinv))
    sols = []
    for B in Bs:
        m = B.shape[2]
        Y = bb.band_fwd_solve_batched(L, rinv, B)
        X = bb.band_bwd_solve_batched(L, rinv, B)
        for key, nm, got, plain in (
                ("band_fwd_solve_batched", "K9", Y,
                 bb.band_fwd_solve_batched_plain),
                ("band_bwd_solve_batched", "K10", X,
                 bb.band_bwd_solve_batched_plain)):
            e = check_close(f"{nm} m={m} {tag}", got, plain(L, rinv, B))
            errs[key] = max(errs.get(key, 0.0), e)
        sols.append((B, Y, X))
    none = bands.new_zeros((d, 0))
    same = True
    for r in range(nr):
        L1, rinv1, _, hld1 = bk.band_factor(bands[r].contiguous(), none)
        same &= (torch.equal(L[r], L1) and torch.equal(rinv[r], rinv1)
                 and torch.equal(hld[r], hld1)
                 and torch.equal(Z[r], bk.band_takahashi(L1, rinv1)))
        for B, Y, X in sols:
            Br = B[r].contiguous()
            same &= torch.equal(Y[r], bk.band_fwd_solve(L1, rinv1, Br))
            same &= torch.equal(X[r], bk.band_bwd_solve(L1, rinv1, Br))
    log(f"  K8-K11 {tag}: every system against K1 (q=0), K2, K3, K4 bit "
        f"for bit {'ok' if same else 'FAIL'}")
    require(same, f"{tag}: batched kernels equal the one-system kernels")
    return (L, rinv), errs


def phase_batched_kernels(bk, bb, dev):
    """K8-K11 at the replicate fits' shapes; rows of the last batch size."""
    log(f"== phase 2 (batched): K8-K11 (d={D}, bw={BW}, systems "
        f"{BATCH_SIZES}, 1 and {Q} right-hand sides)")
    W, f8 = BW + 1, 8
    g = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    for nr in BATCH_SIZES:
        A, bands = spd_batch(dev, nr, D, BW)
        B1, B4 = (torch.randn((nr, D, m), generator=g, device=dev,
                              dtype=torch.float64) for m in (1, Q))
        (L, rinv), errs = check_batched_against_one_system(
            bk, bb, f"NR={nr}", bands, (B1, B4))
        Ld = dense_lower(L)
        spec = {
            "band_factor_batched": (
                lambda: bb.band_factor_batched(bands),
                lambda: bb.band_factor_batched_plain(bands),
                lambda: torch.linalg.cholesky(A),
                f8 * D * (2 * W + 1) + f8,
                D * (2 * BW + 3 + BW * (BW - 1) + BW)),
            "band_fwd_solve_batched": (
                lambda: bb.band_fwd_solve_batched(L, rinv, B1),
                lambda: bb.band_fwd_solve_batched_plain(L, rinv, B1),
                lambda: torch.linalg.solve_triangular(Ld, B1, upper=False),
                f8 * (D * W + D + 2 * D), D * (2 * BW + 1)),
            "band_bwd_solve_batched": (
                lambda: bb.band_bwd_solve_batched(L, rinv, B1),
                lambda: bb.band_bwd_solve_batched_plain(L, rinv, B1),
                lambda: torch.linalg.solve_triangular(Ld.mT, B1, upper=True),
                f8 * (D * W + D + 2 * D), D * (2 * BW + 1)),
            "band_takahashi_batched": (
                lambda: bb.band_takahashi_batched(L, rinv),
                lambda: bb.band_takahashi_batched_plain(L, rinv),
                lambda: torch.cholesky_inverse(Ld),
                f8 * (2 * D * W + D), D * (2 * BW * BW + 2 * BW + 2)),
        }
        for name, (kern, plain, library, nbytes, flops) in spec.items():
            r = dict(err=errs[name], ms=cuda_ms(kern),
                     plain_ms=cuda_ms(plain, n=2, warm=1),
                     library_ms=cuda_ms(library, n=5, warm=1), systems=nr)
            # per system: each input read once, each output written once
            r["bound_ms"], r["bound_by"] = bound(nr * nbytes, nr * flops)
            log(f"  {name} NR={nr}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.2f} ms, library {r['library_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
                f"{r['ms'] / nr * 1e3:.2f} us per system")
            if name in rows:
                r["ms_by_systems"] = {**rows[name]["ms_by_systems"],
                                      nr: r["ms"]}
            else:
                r["ms_by_systems"] = {nr: r["ms"]}
            rows[name] = r
        for nm, fn in (("K9", bb.band_fwd_solve_batched),
                       ("K10", bb.band_bwd_solve_batched)):
            log(f"  {nm} NR={nr} m={Q}: "
                f"{cuda_ms(lambda: fn(L, rinv, B4)):.4f} ms")
        del A, Ld
    check_one_bad_slot(bb, dev)
    # off the register-window path (bw = 12), one system and a few
    for nr in (1, 3):
        _, bands = spd_batch(dev, nr, 300, 12, seed=2)
        Bs = [torch.randn((nr, 300, m), generator=g, device=dev,
                          dtype=torch.float64) for m in (1, 5)]
        check_batched_against_one_system(bk, bb, f"d=300 bw=12 NR={nr}",
                                         bands, Bs)
    return rows


def check_one_bad_slot(bb, dev):
    """The indefinite band of phase 2 in one slot of a healthy batch: that
    slot agrees with the plain version, its neighbours are untouched."""
    nr, slot = 4, 2
    _, bands = spd_batch(dev, nr, D, BW, seed=4)
    bad = bands.clone()
    bad[slot, 10, 0] = -0.8
    bad[slot, 40, 0] = 1e-14
    L0, _, hld0 = bb.band_factor_batched(bands)
    L, rinv, hld = bb.band_factor_batched(bad)
    Lp, _, hldp = bb.band_factor_batched_plain(bad)
    check_close("K8 indefinite slot L", L, Lp)
    check_close("K8 indefinite slot hld", hld, hldp)
    require(not torch.equal(L[slot], L0[slot]), "the bad slot was clamped")
    keep = [r for r in range(nr) if r != slot]
    check_equal("K8 neighbours of the indefinite slot, L", L[keep], L0[keep])
    check_equal("K8 neighbours of the indefinite slot, hld", hld[keep],
                hld0[keep])


def phase_small_fit(tbg, dev):
    log("== phase 3: small fit (n=2000, k=40) against the CPU-f64 values")
    t0 = time.perf_counter()
    fit = tbg.model_fit(FORMULA.format(k=40), data=bench_data(2000),
                        family="Poisson", method="aghq", engine="banded",
                        M=3000, seed=0, device=dev)
    mode, lnc = float(fit.mod.mode[0]), float(fit.mod.lognormconst)
    log(f"  {time.perf_counter() - t0:.2f} s: mode {mode:.6f} "
        f"(ref {SMALL_REF['mode']}), lognormconst {lnc:.6f} "
        f"(ref {SMALL_REF['lognormconst']})")
    require(abs(mode - SMALL_REF["mode"]) < 1e-5, f"small mode {mode}")
    require(abs(lnc - SMALL_REF["lognormconst"]) < 1e-5,
            f"small lognormconst {lnc}")
    require(fit.samps.shape == (39 + 2 + 2, 3000)
            and np.all(np.isfinite(fit.samps)), "small-fit draws")
    return fit


def replicate_ys(be, R, seed=1):
    """R Poisson responses around the backend's own response, in raw data
    order (the JAX package's replicate benchmark generator)."""
    rng = np.random.default_rng(seed)
    base = be.md.y.cpu().numpy()
    inv = np.argsort(np.asarray(be.row_order))
    lam = np.maximum(base, 0.5)
    return np.stack([rng.poisson(lam)[inv].astype(np.float64)
                     for _ in range(R)])


def phase_small_replicates(reps, fit):
    log("== phase 3 (replicates): n=2000, k=40, R=5 in groups of 2, packed "
        "against sequential")
    be = fit.mod.backend
    ys = replicate_ys(be, 5)
    mp, lp = reps.replicate_fits_packed(be, ys, k=4, group_size=2)
    ms, ls = reps.replicate_fits(be, ys, k=4)
    dm, dl = np.abs(mp - ms).max(), np.abs(lp - ls).max()
    log(f"  modes {np.round(mp, 6).tolist()}, max|packed - sequential| "
        f"mode {dm:.3e}, lognormconst {dl:.3e} (tolerance {REPLICATE_TOL:g})")
    require(np.all(np.isfinite(mp)) and np.all(np.isfinite(lp)),
            "finite small replicate fits")
    require(dm < REPLICATE_TOL and dl < REPLICATE_TOL,
            "small replicate fits: packed agrees with sequential")


def phase_headline(tbg, bk, dev):
    log("== phase 4: headline fit (n=1e5, IWP3, k=2000, Poisson, "
        f"AGHQ k=4, M={M_DRAWS})")
    data = bench_data(N_OBS)
    kw = dict(data=data, family="Poisson", method="aghq", engine="banded",
              M=M_DRAWS, seed=0, device=dev)
    torch.cuda.synchronize()
    bk.reset_launches()
    t0 = time.perf_counter()
    fit = tbg.model_fit(FORMULA.format(k=K_KNOTS), **kw)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    launches = dict(bk.launches)
    t0 = time.perf_counter()
    fit2 = tbg.model_fit(FORMULA.format(k=K_KNOTS), **kw)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    mode, H = float(fit.mod.mode[0]), float(fit.mod.hessian[0, 0])
    lnc = float(fit.mod.lognormconst)
    log(f"  fit 1: {wall1:.3f} s, fit 2: {wall2:.3f} s (wall, host clock)")
    profile_run("fit 3", lambda: tbg.model_fit(FORMULA.format(k=K_KNOTS),
                                               **kw))
    log(f"  mode {mode:.6f}, H {H:.4f}, lognormconst {lnc:.6f}, "
        f"node nlls {np.round(fit.mod.lognll, 4).tolist()}")
    log(f"  fit 2: mode {float(fit2.mod.mode[0]):.6f}, lognormconst "
        f"{float(fit2.mod.lognormconst):.6f}")
    log(f"  CPU-f64 reference (JAX package): {HEADLINE_CPU_REF}")
    log(f"  launches in fit 1: {launches}")
    require(math.isfinite(mode) and math.isfinite(lnc),
            "finite headline mode and lognormconst")
    require(fit.samps.shape == (K_KNOTS - 1 + 2 + 2, M_DRAWS)
            and np.all(np.isfinite(fit.samps)), "headline draws")
    missing = [k for k, v in launches.items() if v <= 0]
    require(not missing, f"every kernel launched by the fit: {missing}")
    return fit, launches, wall1, wall2


def profile_run(label, run):
    """`run` once on the host clock, then once more under torch.profiler:
    the card's busy share of the call's wall time and the device time by
    kernel. The profiler slows the host, so the share is taken of the
    unprofiled wall time as well."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall0 = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): the host ops that
    # launched them carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if not events:
        log("  profile: no device time recorded (busy share not measured)")
        return
    log(f"  profiled {label}: {wall0:.3f} s wall, {wall:.3f} s under the "
        f"profiler; device busy {busy:.3f} s ({100 * busy / wall0:.1f}% of "
        f"the wall time, {100 * busy / wall:.1f}% under the profiler), "
        f"{sum(e.count for e in events)} device ops; top device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
            f"{e.key[:80]}")


def phase_fixed_point(bk, fit):
    log("== phase 5: kernel engine against plain engine at a fixed point")
    be = fit.mod.backend
    mode = float(fit.mod.mode[0])
    j = int(np.argmin(np.abs(fit.mod.nodes[:, 0] - mode)))
    V0, t0, _ = fit.mod.states[j]
    theta = torch.tensor([mode], dtype=torch.float64, device=be.device)
    plain = dataclasses.replace(be, engine=be.engine.with_ops(bk.PLAIN))
    out = {}
    for name, b in (("kernels", be), ("plain", plain)):
        V = V0.clone().requires_grad_(True)
        tail = t0.clone().requires_grad_(True)
        th = theta.clone().requires_grad_(True)
        F = b._laplace_value(V, tail, th)
        gV, gt, gth = torch.autograd.grad(F, (V, tail, th))
        with torch.no_grad():
            factor = b.hessian_factor(V0, t0, theta)
            hld = b.half_logdet_H(factor)
            zV, zt = b.solve_H(factor, *b.grad_W(V0, t0, theta))
            nll = b.laplace_nll(theta, (V0, t0))[0]
        out[name] = dict(F=F.detach(), gV=gV, gt=gt, gth=gth, hld=hld,
                         zV=zV, zt=zt, nll=float(nll))
    k, p = out["kernels"], out["plain"]
    for key in ("F", "gV", "gt", "gth", "hld", "zV", "zt"):
        check_close(f"fixed point {key}", k[key], p[key], rtol=1e-9)
    log(f"  laplace_nll warm from the node state (information only): "
        f"kernels {k['nll']:.6f}, plain {p['nll']:.6f}, CPU-f64 reference "
        f"at its own mode {HEADLINE_CPU_REF['lognormconst']}")


def phase_replicates(reps, batched, bb, be, dev):
    """Replicate fits on the headline design. Returns the launch counts
    of K8-K11 in the first packed R = 64 run, the results of the first
    R = 16 run with its responses, and the seconds per fit."""
    log(f"== phase 6: replicate fits on the headline design (n={N_OBS}, "
        f"k={K_KNOTS}, Poisson, AGHQ k=4)")
    ys = replicate_ys(be, 64)
    torch.cuda.reset_peak_memory_stats()

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    per_fit, launches, first16 = {}, None, None
    for R in (16, 64):
        bb.reset_launches()
        (modes, lncs), w1 = timed(reps.replicate_fits_packed, be, ys[:R], k=4)
        counts = dict(bb.launches)
        (modes2, lncs2), w2 = timed(reps.replicate_fits_packed, be, ys[:R],
                                    k=4)
        per_fit[f"packed R={R}"] = w2 / R
        log(f"  packed R={R}: call 1 {w1:.3f} s, call 2 {w2:.3f} s (wall, "
            f"host clock), {w2 / R:.4f} s per fit; launches {counts}")
        log(f"    modes: first 4 {np.round(modes[:4], 4).tolist()}, range "
            f"[{modes.min():.4f}, {modes.max():.4f}]")
        require(np.all(np.isfinite(modes)) and np.all(np.isfinite(lncs)),
                f"finite modes and lognormconsts, packed R={R}")
        require(np.array_equal(modes, modes2) and np.array_equal(lncs, lncs2),
                f"packed R={R}: the second call repeats the first")
        missing = [k for k, v in counts.items() if v <= 0]
        require(not missing, f"packed R={R} launched every batched kernel: "
                             f"{missing}")
        if R == 16:
            first16 = (modes, lncs)
        launches = counts
    log(f"  peak device memory of the packed runs: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    # a window of the R = 64 run, not the whole of it: the trace of a
    # whole run (~850,000 device operations) takes minutes to read back
    b64 = batched.build_batched(be, ys)
    theta = torch.tensor(modes, dtype=torch.float64, device=dev)
    profile_run("one Laplace evaluation with its gradient, cold start, "
                "R=64", lambda: b64.value_and_grad(theta, b64.init_state()))
    (ms, ls), ws = timed(reps.replicate_fits, be, ys[:4], k=4)
    per_fit["sequential R=4"] = ws / 4
    log(f"  sequential R=4: {ws:.3f} s, {ws / 4:.4f} s per fit")
    dm = np.abs(first16[0][:4] - ms).max()
    dl = np.abs(first16[1][:4] - ls).max()
    log(f"  packed R=16 against sequential on the first 4 responses "
        f"(information only, the fit is noisy at this size): max|mode "
        f"diff| {dm:.3e}, max|lognormconst diff| {dl:.3e}")
    require(np.all(np.isfinite(ms)) and np.all(np.isfinite(ls)),
            "finite sequential replicate fits")
    log(f"  seconds per fit: {per_fit}")
    return launches, (ys[:16], first16[0]), per_fit


def phase_batched_fixed_point(batched, bb, be, ys, modes):
    log("== phase 7: batched kernel engine against batched plain engine at "
        "a fixed point (R=16)")
    bkern = batched.build_batched(be, ys)
    theta = torch.tensor(modes, dtype=torch.float64, device=be.device)
    with torch.no_grad():
        V0, t0 = bkern.solve_W_star(theta, warm=bkern.init_state())
    plain = dataclasses.replace(bkern, engine=bkern.engine.with_ops(bb.PLAIN))
    out = {}
    for name, b in (("kernels", bkern), ("plain", plain)):
        V = V0.clone().requires_grad_(True)
        tail = t0.clone().requires_grad_(True)
        th = theta.clone().requires_grad_(True)
        F = b._laplace_value(V, tail, th)
        gV, gt, gth = torch.autograd.grad(F.sum(), (V, tail, th))
        with torch.no_grad():
            factor = b.hessian_factor(V0, t0, theta)
            hld = b.half_logdet_H(factor)
            zV, zt = b.solve_H(factor, *b.grad_W(V0, t0, theta))
        out[name] = dict(F=F.detach(), gV=gV, gt=gt, gth=gth, hld=hld,
                         zV=zV, zt=zt)
    for key in ("F", "gV", "gt", "gth", "hld", "zV", "zt"):
        check_close(f"batched fixed point {key}", out["kernels"][key],
                    out["plain"][key], rtol=1e-9)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "bayesgp_torch")):
        print("chip_smoke: run from a checkout holding bayesgp_torch/",
              file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    import bayesgp_torch as tbg
    from bayesgp_torch.fast import batched
    from bayesgp_torch.linalg import band_batched as bb
    from bayesgp_torch.linalg import band_kernels as bk
    from bayesgp_torch.parallel import replicates as reps

    dev = torch.device("cuda:0")
    card = gpu_line()
    log("== phase 1: card and build")
    log(f"  {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{nvcc_version(bk)}, devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = bk.build()
    log(f"  built {lib.name} in {time.perf_counter() - t0:.2f} s (K1-K5 "
        "and K8-K11, one source)")

    rows = phase_kernels(bk, dev)
    rows.update(phase_batched_kernels(bk, bb, dev))
    small = phase_small_fit(tbg, dev)
    phase_small_replicates(reps, small)
    fit, launches, wall1, wall2 = phase_headline(tbg, bk, dev)
    phase_fixed_point(bk, fit)
    be = fit.mod.backend
    rep_launches, (ys16, modes16), per_fit = phase_replicates(
        reps, batched, bb, be, dev)
    phase_batched_fixed_point(batched, bb, be, ys16, modes16)
    launches.update(rep_launches)

    kernels = []
    for name, r in rows.items():
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if "systems" in r:      # a batched kernel: timed at this many
            row["systems"] = r["systems"]
            row["ms_by_systems"] = r["ms_by_systems"]
        kernels.append(row)
    log(f"headline fit wall s: first {wall1:.3f}, second {wall2:.3f}")
    log(f"replicate fits, wall s per fit: {per_fit}")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
