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
     sequential, and on that design each replicate's half log-det at
     theta_IWP = 30 and 40 against the one-response engine's;
  4. the headline fit: model_fit at n = 1e5, IWP order 3, k = 2000,
     Poisson, AGHQ k = 4, M = 3000, counting every kernel launch, its
     outer FD Hessian from several warm starts, and a profiled Laplace
     evaluation of it;
  5. the kernel engine against the plain engine at a fixed (theta, V,
     tail) point of that fit;
  6. replicate fits on the headline design: replicate_fits_packed at
     R = 16 (twice) and R = 64, a profiled Laplace evaluation at
     R = 64, replicate_fits at R = 4, counting the launches of K8-K11;
     then, after phase 7, the one Schur tail of both band engines: at
     theta_IWP = 20, 25, 30, 35 and 40, each of two responses at its
     one-response mode, the replicate engine's tail on the one-response
     engine's factor the same bits, both tails on the same route, and
     the two half log-dets equal (SCHUR_RTOL);
  7. the batched kernel engine against the batched plain engine at a
     fixed point of the R = 16 run;
  8. a small scattered-IID fit (engine='scatter_iid', IWP order 2, k = 150,
     q = 40, n = 2000, AGHQ k = 3) on the card against the CPU-f64 values
     of the JAX package's host path;
  9. the scattered-IID headline fit: model_fit(..., engine='scatter_iid')
     at n = 1e5, IWP order 3, k = 2000, an x-clustered IID term with
     q = 1e4 levels, Poisson, AGHQ k = 3, M = 1000 (the JAX package's
     bench_bigiid generator), twice, counting the launches of K6/K7 (K7
     by right-hand sides: r = 1 or more) and refusing any torch.linalg
     factorization or triangular solve on the path; its outer FD Hessian
     from several warm starts;
 10. one fit of the scattered q = 1e4 generator (bench_scattered_iid) at
     n = 5e4, k = 500, M = 500;
 11. the dense kernel engine against the dense plain engine at a fixed
     (theta, V, u, t) of the phase 9 fit, and the kernel engine's outer
     FD Hessian at its mode;
 12. a profiled scattered-IID Laplace evaluation with its gradient;
 13. a small merged-IID fit (tests/test_iid_band.py's problem: n = 600,
     IWP2 k = 12, 30 levels merged into the band, AGHQ k = 3) against the
     CPU-f64 values of the JAX package's host path;
 14. the merged-IID headline: model_fit with engine='auto' on the
     bench_bigiid generator (n = 1e5, IWP3 k = 2000, q = 1e4 levels
     clustered in x, merged into the band: d = 13993, bw = 34, q = 3),
     twice, counting K1-K5 launches, beside phase 9's scatter_iid fit of
     the same data: its mode held to phase 9's within MERGED_MODE_TOL,
     its lognormconst within MERGED_LNC_TOL, its outer Hessian positive
     definite with each eigenvalue within MERGED_EIG_RTOL of phase 9's,
     at phase 9's mode (the inner Newton run tight) its central
     difference within MERGED_FD_TOL of its gradient and the tail factor
     on its plain route there and at its own mode; its value at
     theta_IWP = 40 and at RUNAWAY_MODE above its value at the mode, no
     sick-factor gate warning; the two engines' theta gradients held to
     each other at MERGED_GATE_THETA; the driver's prior quadratic
     logged expanded, as a sum of squares and in longdouble;
 15. the kernel engine against the plain engine at a fixed point of a
     reduced merged model (n = 5000, k = 100, q = 600);
 16. the tail-term cell: bench_scattered_iid's engine='banded' q = 512
     point (n = 5e4, k = 500, a 515-wide tail on K6/K7);
 17. a profiled merged-IID Laplace evaluation with its gradient at
     MERGED_GATE_THETA, with K4's device time in it;
 18. the dense route: the reference README covid fit (n = 787, IWP3
     k = 30, Poisson, AGHQ k = 4, M = 3000, seed 1) twice, held to the
     golden constants of tests/test_golden_covid.py at that file's
     tolerances and the two fits held equal bit for bit; the post-fit
     pins (summary, the t (SD) row of post_table, var_density) and a
     save_fit/load_fit round trip; its wall, Laplace evaluations,
     Newton steps, host syncs and peak device memory;
 19. the sGP lynx vignette fit (sGP k = 20 + IID, Poisson, two
     hyperparameters, w = 171) against the port's CPU-f64 values, and
     its predict spread; then the same fit with engine='banded' (the sGP
     term drives a band of width 12, K1-K5 launched) against it;
 20. the dense route at its largest size: the bench.py generator at
     n = 6,000, IWP3 k = 300, Poisson (n * basis ~ 1.8e6, just under the
     2e6 at which engine='auto' leaves the dense route) fitted twice, a
     Gaussian s = 2 variant and an nlminb fit of its fixed effects, each
     held to the port's CPU-f64 fit of it (DENSE_CPU), and a profiled
     cold Laplace evaluation;
 21. gauss2 (bench_extra.py:35-100, uncut): the headline design with a
     Gaussian response, s = 2, AGHQ k = 4 and M = 3000 draws, twice, the
     fits equal bit for bit; the kernel engine against the plain engine
     at the mode; the Laplace value at the mode from a cold state and
     from the states of theta +- 0.5, +- 1, one coordinate at a time
     (its spread in nats); fit wall, Laplace evaluations, Newton steps,
     K1-K5 launches and peak memory;
 22. two_smooths (bench_extra.py:279-308, BASELINE config 4, uncut: IWP2
     k = 100 + sGP period 10 k = 100, Gaussian, s = 3, AGHQ k = 3): the
     mode, the nll at it and its gradient held to
     tests/test_two_smooth_golden.py; the backend and its (d, bw, q);
     K1-K5 at the sGP driver's (dpad, bw, q) against their plain versions,
     with bound and library times;
 23. CoxPH, BASELINE config 3 (bench_extra.py:217-247, uncut: n = 4000,
     seed 0, time ~ sex + IWP2 k = 30 in age, cens, AGHQ k = 4, M = 1000)
     twice, the fits equal bit for bit, held to the JAX package's CPU-f64
     model_fit of the same call (PARTIAL_JAX, from
     tools/torch_partial_reference.py: mode within PARTIAL_MODE_TOL =
     1e-5, lognormconst within PARTIAL_LNC_TOL = 1e-4 nats), no intercept,
     the sex effect near its simulated -0.8; fit wall, Laplace
     evaluations, Newton steps, host syncs, peak memory; a profiled cold
     Laplace evaluation with its busy share;
 24. the case-crossover vignette (tests/test_partial_likelihood.py:9-22:
     sim1data, IWP2 k = 30 at the median exposure, strata='subject',
     M = 1000, seed 7) twice, bit for bit, held to PARTIAL_JAX at the
     same tolerances and to that file's checks (rmse below the band's
     width, more than 80% of the truth inside the band, no intercept);
 25. the covid fit of phase 18 with family='Customized' and a torch
     Poisson loglik (poisson_loglik), held to the golden constants and to
     phase 18's fit (mode within 1e-5, lognormconst within 1e-4 nats); a
     negative binomial loglik (nb_loglik) registered by name with one
     extra theta (NB_N = 200 rows, IWP2 k = 10, s = 2) held to
     PARTIAL_JAX; a family='none' fit whose Laplace value at
     PRIOR_ONLY_THETA equals the JAX package's within PRIOR_ONLY_RTOL =
     1e-10.
No kernel of K1-K11 is on the dense route (torch.linalg carries it, as
XLA's Cholesky carries the JAX package's): phases 18-20 log the kernel
launch counts, set to 0 before each and read after it; phases 23-25 also
require them to read 0.
Phase 1 builds csrc/band_kernels.cu (K1-K5, K8-K11) and
csrc/dense_kernels.cu (K6, K7) with two nvcc processes started together;
phase 2 also checks K1 bit for bit with its one (farthest-first) plain
version at bw = 1..8, 12, 34, 70 and 125, with tails inside its block
and past it (K1's tail solve, a column at the |Y| cap), and the wide K1
at every number of bulk warps, K2, K3 and K5 bit for bit with their one
(farthest-first) plain version at every register-window width (bw =
1..8), K4 bit for bit with its one (farthest-first) plain version at
bw = 1..8, 12, 34, 70 and 125, its device time and cholesky_inverse's
from a CUDA graph, K8-K11 system by system against K1-K5 bit for bit at
bw = 3, 12, 34 and 70 (K11's device time from a CUDA graph), K6/K7 against their plain versions on healthy and
indefinite blocks, K7 bit for bit at r = 1, 2, 32, 33, 128, 1000 and 2051
right-hand sides both ways and timed against solve_triangular at r = 1
and 2051, the blocked factor and solves at the headline dimension 2051,
and K1-K5 at
the shapes the JAX package sends to its chunked kernels K1c-K5c
(CHUNKED_SHAPES), the corners of bw <= 125 and of the tail width
included, against their plain versions (on the whole system, on the
first PREFIX columns at PREFIX_SHAPES) and against the band, with K5 at
the merged shape timed with 1, 4, 8 and 16 draw columns a block of its
warp kernel and K1 there with 1-6 bulk warps and with its tail solved
after the factor.
A line near the end is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.
"""
import concurrent.futures
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP64_FLOPS_PER_S = 34e12       # H100 SXM FP64 outside the tensor cores
N_OBS, K_KNOTS = 100_000, 2000
D, BW, Q, M_DRAWS = 2048, 3, 4, 3000
RTOL = 1e-10
SOURCE = "bayesgp_torch/csrc/band_kernels.cu"
DENSE_SOURCE = "bayesgp_torch/csrc/dense_kernels.cu"
REPLACES = {
    "dense_factor_block": "bayesgp_tpu/linalg/chol_dd.py:144",
    "dense_solve_lower": "bayesgp_tpu/linalg/chol_dd.py:213",
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
# the scattered-IID slice: Schur dimension of the headline (dpad 2048 + 3
# tail columns), K7's right-hand-side counts on its path, the dense
# tolerance (kernel against plain: bit for bit expected)
DENSE_DIM = 2051
DENSE_R = (1, 2, 32, 33, 128, 1000, 2051)
DENSE_RTOL = 1e-12
IID_FORMULA = "y ~ f(x, model='IWP', order={p}, k={k}) + f(g, model='IID')"
IID_K, IID_Q, IID_M = 2000, 10_000, 1000
# CPU-f64 values of the JAX package's host path (prefer_host_opt) on the
# small scattered-IID model of phase 8
SCATTER_SMALL_REF = {"mode": (1.8031526021, 3.6902232481),
                     "lognormconst": -3539.5858495984}
# the multi-term banded slice: K1-K5 at the shapes the JAX package sends
# to its chunked kernels K1c-K5c, (d, bw, q): tools/chunked_onchip_check.py's
# two, the merged headline's, and the corners of the domain (bw <= 125,
# q <= 512, and a tail past 1024 threads). The plain versions run on the
# whole system, except at PREFIX_SHAPES, where one of them would take more
# than ~30 s on the card (there the plain K4 takes ~8.6 s on 4,096
# columns on an H100's host): there they run on the first PREFIX columns
# (a Cholesky prefix depends only on its prefix)
CHUNKED_SHAPES = ((16000, 13, 300), (12000, 48, 300), (14098, 34, 3),
                  (16384, 125, 512), (16384, 8, 481), (16384, 34, 1100))
MERGED_SHAPE = (14098, 34, 3)
PREFIX_SHAPES = ((16384, 125, 512),)
PREFIX = 4096
CHUNKED = {                      # port kernel -> its chunked TPU kernel
    "band_factor": ("band_factor_chunked",
                    "bayesgp_tpu/linalg/band_kernels.py:466"),
    "band_fwd_solve": ("band_fwd_solve_chunked",
                       "bayesgp_tpu/linalg/band_kernels.py:508"),
    "band_bwd_solve": ("band_bwd_solve_chunked",
                       "bayesgp_tpu/linalg/band_kernels.py:541"),
    "band_bwd_multi": ("band_bwd_multi_chunked",
                       "bayesgp_tpu/linalg/band_kernels.py:575"),
    "band_takahashi": ("band_takahashi_chunked",
                       "bayesgp_tpu/linalg/band_kernels.py:612"),
}
REPLACES.update(CHUNKED.values())
# the merged problem of tests/test_iid_band.py (n = 600, IWP2 k = 12, 30
# x-clustered levels, a lazy IID term), AGHQ k = 3: CPU-f64 values of the
# JAX package's host path
MERGED_SMALL_REF = {"mode": (0.96162838, 2.72002588),
                    "lognormconst": -1093.3009974334}
# a theta of the merged headline whose factor is healthy (smallest pivot
# ~1e-3) while max|H^{-1}| ~ 1e13, where a gate on |H^{-1}| >= 1e12
# dropped the log-det's gradient: the merged fit's mode under that gate.
# The theta gradient there is large (~150), well above the Laplace
# value's noise, so the two engines' gradients can be held to each other
MERGED_GATE_THETA = (-0.298, 3.843)
# where the merged fit ran away to before the prior quadratic became a sum
# of squares, and how close the merged mode is held to phase 9's
RUNAWAY_MODE = (51.240565, 4.359255)
MERGED_MODE_TOL = 0.02
# the merged fit against phase 9's of the same data: lognormconst (nats),
# each outer-Hessian eigenvalue (relative), and at phase 9's mode the
# merged value's central difference against its gradient, per coordinate
MERGED_LNC_TOL = 0.05
MERGED_EIG_RTOL = 0.25
MERGED_FD_TOL = 0.05
# phase 14's check at phase 9's mode: the inner Newton with no step floor,
# stopping after this many steps without a 5% smaller step (or at its
# cap), and the central-difference step of the Laplace values there
TIGHT_STALL = 30
FD_STEP = 1e-2

# the dense route: the reference README covid fit and its golden values
# (tests/test_golden_covid.py:18-29)
COVID_FORMULA = ("new_deaths ~ weekdays1 + weekdays2 + weekdays3 + "
                 "weekdays4 + weekdays5 + weekdays6 + "
                 "f(t, model='IWP', order=3, k=30)")
COVID_GOLDEN = {"mode": -3.245926, "lognormconst": -4322.531,
                "quad_cov": 0.07936619, "mean": -3.271182,
                "sd": 0.2785344, "q2.5": -3.87922, "median": -3.268308,
                "q97.5": -2.760093,
                "fixed_means": [-5.40445, 0.09375, 0.07922, 0.12672,
                                0.12547, 0.05001, -0.15126]}
# the sGP lynx vignette (tests/test_lynx.py) and the port's CPU-f64 fit
# of it (tools/torch_dense_reference.py on an H100 host's CPU)
LYNX_FORMULA = ("y ~ f(x=year, model='sGP', a=a_val, k=20, "
                "sd_prior=dict(prior='exp', param=prior_SD, h=2), "
                "boundary_prior=dict(prec=0.001)) + f(x=idx, model='IID', "
                "sd_prior=dict(prior='exp', param=dict(u=1, alpha=0.01)))")
LYNX_CPU = {"mode": [2.1430910976941253, 2.5811232633158716],
            "lognormconst": -716.1395570242041}
# the dense route's largest cell: n * (k - 1) just under 2e6, and the
# port's CPU-f64 fits of phase 20's cases (tools/torch_dense_reference.py
# on an H100 host's CPU)
DENSE_N, DENSE_K = 6000, 300
DENSE_CPU = {
    "poisson": {"mode": [14.199925547526059],
                "lognormconst": -13920.665911317137},
    "gaussian": {"mode": [14.389798478906146, 1.826869652284661],
                 "lognormconst": -2855.332805204258},
    "nlminb": {"mean": [2.035771543892731, -0.003377647653748773]}}
DENSE_MODE_TOL, DENSE_LNC_TOL, DENSE_MEAN_TOL = 1e-4, 1e-5, 1e-8
# phase 19's lynx fit on the banded route against its dense fit
# (tests/test_banded_generic.py:134-143): lognormconst, theta means
LYNX_BANDED_LNC_TOL, LYNX_BANDED_THETA_TOL = 1e-4, 1e-3
# the one Schur tail of both band engines (ROADMAP Queue 3 #6): thetas of
# the headline design at which their half log-dets are held equal, to this
# relative gap (the engines' linear predictors may round apart)
SCHUR_THETAS = (20.0, 25.0, 30.0, 35.0, 40.0)
SCHUR_RTOL = 1e-12
# gauss2 (bench_extra.py:35-100): the headline design with a Gaussian
# response, AGHQ k = 4; the Laplace value's noise at the mode from warm
# states at these steps of one coordinate at a time
GAUSS2_STEPS = (0.5, -0.5, 1.0, -1.0)
# two_smooths (bench_extra.py:279-308, BASELINE config 4) and its golden
# mode (tests/test_two_smooth_golden.py:19-55)
TWO_SMOOTHS_N, TWO_SMOOTHS_K = 20_000, 100
TWO_SMOOTHS_FORMULA = ("y ~ f(x=x, model='IWP', order=2, k=k_iwp) "
                       "+ f(x=xs, model='sGP', period=10, k=k_sgp)")
TWO_SMOOTHS_MODE = (11.07, 14.09, 2.42)
TWO_SMOOTHS_MODE_TOL = 0.15
TWO_SMOOTHS_NLL, TWO_SMOOTHS_NLL_TOL, TWO_SMOOTHS_GRAD_MAX = 3883.0, 5.0, 5.0
# the partial-likelihood and customized families (dense route): CoxPH,
# BASELINE config 3 (bench_extra.py:217-247, uncut); the case-crossover
# vignette (tests/test_partial_likelihood.py:9-22); a customized negative
# binomial with one extra theta and a prior-only model on NB_N rows. The
# JAX package's model_fit of each (laplace_nll at PRIOR_ONLY_THETA for the
# prior-only model) on the CPU in f64, from
# tools/torch_partial_reference.py; the card's fits are held to them
# within PARTIAL_MODE_TOL in the mode and PARTIAL_LNC_TOL nats
COXPH_N = 4000
COXPH_FORMULA = "time ~ sex + f(x=age, model='IWP', order=2, k=30)"
NB_N = 200
NB_FORMULA = "y ~ f(x, model='IWP', order=2, k=10)"
NB_FAMILY = "chip_smoke_negative_binomial"
PRIOR_ONLY_THETA = 1.0
PARTIAL_JAX = {
    "coxph": {"mode": [8.548743111965951],
              "lognormconst": -18864.02537795463},
    "cc": {"mode": [-2.0842996958679554],
           "lognormconst": -1242.030668642676},
    "nb": {"mode": [0.09162073042090493, 1.495531125573509],
           "lognormconst": -421.03584171152},
    "prior_only": {"nll": -12.733418933394905}}
PARTIAL_MODE_TOL, PARTIAL_LNC_TOL, PRIOR_ONLY_RTOL = 1e-5, 1e-4, 1e-10


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


def graph_ms(fn, n=50):
    """Device milliseconds per call: n calls captured in one CUDA graph,
    replayed once, by CUDA events (no host time between the launches)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
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

    L, rinv, Y, hld, clamped = bk.band_factor(band, C)
    Lp, rinvp, Yp, hldp, clampedp = bk.band_factor_plain(band, C)
    err = max(check_close("K1 L", L, Lp), check_close("K1 rinv", rinv, rinvp),
              check_close("K1 Y", Y, Yp), check_close("K1 hld", hld, hldp))
    require(not bool(clamped) and not bool(clampedp),
            "K1 reports no clamped pivot on a healthy band")
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
    Lb, rinvb, Yb, hb, cb = bk.band_factor(bad, C)
    Lbp, _, Ybp, hbp, cbp = bk.band_factor_plain(bad, C)
    log(f"  K1 indefinite band: clamped pivot reported by the kernel "
        f"{bool(cb)}, by the plain version {bool(cbp)}")
    require(bool(cb) and bool(cbp), "K1 reports the clamped pivot")
    check_close("K1 indefinite L", Lb, Lbp)
    check_close("K1 indefinite Y", Yb, Ybp)
    check_close("K1 indefinite hld", hb, hbp)
    check_gated(bk, Lb, rinvb, C, Yb, cb, f"bw={BW} q={Q} clamped")
    check_gated(bk, L, rinv, C, Y, clamped, f"bw={BW} q={Q} healthy")
    check_factor_orders(bk, dev)

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
        rows[name]["device_ms"] = graph_ms(lambda: fn(L, rinv, B))
        rows[name]["library_device_ms"] = graph_ms(
            lambda: torch.linalg.solve_triangular(Lib, B, upper=upper))
        log(f"  {name} r=1 device time (CUDA graph): kernel "
            f"{rows[name]['device_ms']:.4f} ms, solve_triangular "
            f"{rows[name]['library_device_ms']:.4f} ms")
        for r in (Q, 128):
            Br = torch.randn((D, r), generator=g, device=dev,
                             dtype=torch.float64)
            log(f"  {name} r={r}: {cuda_ms(lambda: fn(L, rinv, Br)):.4f} ms")
    check_solve_orders(bk, dev, g)

    Z = bk.band_takahashi(L, rinv)
    Zp = bk.band_takahashi_plain(L, rinv)
    err = check_close("K4 band of H^-1", Z, Zp)
    Hinv = torch.linalg.inv(A)
    ref = torch.stack([torch.cat([torch.diagonal(Hinv, -o), A.new_zeros(o)])
                       for o in range(W)], dim=1)
    check_close("K4 against dense inverse", Z, ref, rtol=1e-8)
    check_equal("K4 against its plain version", Z, Zp)
    rows["band_takahashi"] = dict(
        err=err, ms=cuda_ms(lambda: bk.band_takahashi(L, rinv)),
        plain_ms=cuda_ms(lambda: bk.band_takahashi_plain(L, rinv), n=3,
                         warm=1),
        library_ms=cuda_ms(lambda: torch.cholesky_inverse(Ld)),
        device_ms=graph_ms(lambda: bk.band_takahashi(L, rinv)),
        library_device_ms=graph_ms(lambda: torch.cholesky_inverse(Ld),
                                   n=10),
        nbytes=f8 * (2 * D * W + D), flops=D * (2 * BW * BW + 2 * BW + 2))
    log(f"  band_takahashi device time (CUDA graph): kernel "
        f"{rows['band_takahashi']['device_ms']:.4f} ms, cholesky_inverse "
        f"{rows['band_takahashi']['library_device_ms']:.4f} ms")
    check_takahashi_orders(bk, dev)

    Zn = torch.randn((D, M_DRAWS), generator=g, device=dev,
                     dtype=torch.float64)
    X = bk.band_bwd_multi(L, rinv, Zn)
    Xp = bk.band_bwd_solve_plain(L, rinv, Zn)
    err = check_close("K5 draws", X, Xp)
    check_equal(f"K5 draws (r = {M_DRAWS}) against the plain solve", X, Xp)
    rows["band_bwd_multi"] = dict(
        err=err, ms=cuda_ms(lambda: bk.band_bwd_multi(L, rinv, Zn)),
        plain_ms=cuda_ms(lambda: bk.band_bwd_solve_plain(L, rinv, Zn), n=3,
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


def check_factor_orders(bk, dev):
    """K1 bit for bit with its one (farthest-first) plain version at every
    register-window width (bw = 1..8, d = D) and at bw = 12, 34, 70 and
    125 (d = 600), with a tail inside the block and one past it (K1's
    tail solve, with a column at the |Y| cap); the wide kernel with every
    number of bulk warps bit for bit with the wrapper's choice."""
    cases = [(D, bw, q) for bw in range(1, bk.SMALL_BW + 1)
             for q in (Q, 300)]
    cases += [(600, bw, q) for bw in (12, 34, 70, 125) for q in (3, 40)]
    for d, bw, q in cases:
        _, band, C, _ = spd_problem(dev, d, bw, q, seed=30 + bw + q)
        C[:, -1] *= 1e10                 # a column that meets the cap
        tag = f"K1 d={d} bw={bw} q={q}"
        got = bk.band_factor(band, C)
        want = bk.band_factor_plain(band, C)
        for name, a, b in zip(("L", "rinv", "Y", "hld", "clamped"), got,
                              want):
            check_equal(f"{tag} {name}", a, b)
        require(bool((got[2].abs() == bk.Y_CAP).any()),
                f"{tag}: a tail entry met the cap")
        if bw > bk.SMALL_BW:
            tile = bk._library().bgt_band_factor_tile(bw, q)
            C0 = C[:, :tile].contiguous()
            for nb in range(1, 7):
                L, rinv, Y, hld, _ = bk.band_factor_bulk(band, C0, nb)
                check_equal(f"{tag} with {nb} bulk warps", torch.cat(
                    [L.reshape(-1), rinv, Y.reshape(-1), hld.reshape(1)]),
                    torch.cat([got[0].reshape(-1), got[1],
                               got[2][:, :tile].reshape(-1),
                               got[3].reshape(1)]))
    log(f"  K1 bit for bit with its farthest-first plain version at bw = "
        f"1..{bk.SMALL_BW} (d={D}, q = {Q} and 300) and bw = 12, 34, 70, "
        f"125 (d=600, q = 3 and 40), the tail past the block on K2's "
        f"kernels with the cap, and the wide kernel at 1-6 bulk warps: ok")


def check_gated(bk, L, rinv, B, X0, gate, tag):
    """K2 on a device gate (K1's re-solve of Y) against its plain version,
    bit for bit: X0 kept on a clear gate, L^{-1} B on a set one (on a
    clamped factor the uncapped solve may overflow: NaNs must sit where
    the plain version has them)."""
    def nan0(x):
        return torch.where(torch.isnan(x), torch.zeros_like(x), x)

    def same(name, a, b):
        require(torch.equal(torch.isnan(a), torch.isnan(b)),
                f"{name}: NaNs in the same places")
        check_equal(name, nan0(a), nan0(b))

    got = bk.band_fwd_solve_gated(gate, L, rinv, B, X0.clone())
    want = bk.band_fwd_solve_gated_plain(gate, L, rinv, B, X0.clone())
    same(f"K2 gated ({bool(gate)}) {tag}", got, want)
    if bool(gate):
        same(f"K2 gated {tag} against K2", got,
             bk.band_fwd_solve(L, rinv, B))


def check_solve_orders(bk, dev, g):
    """K2, K3 and K5 at every register-window width (bw = 1..8, d = D,
    r = 1 and 3) against the one plain version of each, which sums a
    row's products farthest-first: bit for bit."""
    for bw in range(1, bk.SMALL_BW + 1):
        _, band, _, _ = spd_problem(dev, D, bw, 0, seed=10 + bw)
        L, rinv, _, _, _ = bk.band_factor(band, band.new_zeros((D, 0)))
        for r in (1, 3):
            B = torch.randn((D, r), generator=g, device=dev,
                            dtype=torch.float64)
            for name, fn, plain in (
                    ("K2", bk.band_fwd_solve, bk.band_fwd_solve_plain),
                    ("K3", bk.band_bwd_solve, bk.band_bwd_solve_plain),
                    ("K5", bk.band_bwd_multi, bk.band_bwd_solve_plain)):
                check_equal(f"{name} bw={bw} r={r}", fn(L, rinv, B),
                            plain(L, rinv, B))
    log(f"  K2, K3 and K5 bit for bit with their farthest-first plain "
        f"versions at d={D}, bw = 1..{bk.SMALL_BW}, r = 1 and 3: ok")


def check_takahashi_orders(bk, dev):
    """K4 at every register-window width (bw = 1..8, d = D) and at bw =
    12, 34, 70 and 125 (d = 600, the ring kernel with one to four warps)
    against its one plain version, which sums every entry farthest-first
    and Z[j, 0] with Z[j, 1]'s product last: bit for bit."""
    cases = [(D, bw) for bw in range(1, bk.SMALL_BW + 1)]
    cases += [(600, bw) for bw in (12, 34, 70, 125)]
    for d, bw in cases:
        _, band, _, _ = spd_problem(dev, d, bw, 0, seed=50 + bw)
        L, rinv, _, _, _ = bk.band_factor(band, band.new_zeros((d, 0)))
        check_equal(f"K4 d={d} bw={bw}", bk.band_takahashi(L, rinv),
                    bk.band_takahashi_plain(L, rinv))
    log(f"  K4 bit for bit with its farthest-first plain version at "
        f"d={D}, bw = 1..{bk.SMALL_BW} and d=600, bw = 12, 34, 70, 125: ok")


def check_other_shapes(bk, dev):
    """Shapes off the headline path, for the kernels' other code paths:
    a band wider than the register-window kernels take (bw = 12), and a
    factor with no tail (q = 0)."""
    for d, bw, q in ((300, 12, 4), (300, BW, 0)):
        _, band, C, _ = spd_problem(dev, d, bw, q, seed=2)
        tag = f"d={d} bw={bw} q={q}"
        L, rinv, Y, hld, _ = bk.band_factor(band, C)
        Lp, rinvp, Yp, hldp, _ = bk.band_factor_plain(band, C)
        for name, a, b in (("L", L, Lp), ("rinv", rinv, rinvp),
                           ("hld", hld, hldp)):
            check_close(f"K1 {name} {tag}", a, b)
        if q:
            check_close(f"K1 Y {tag}", Y, Yp)
            for gate in (False, True):
                check_gated(bk, L, rinv, C, Y,
                            torch.tensor(gate, device=dev), tag)
        B = torch.randn((d, 5), device=dev, dtype=torch.float64)
        for name, fn, plain in (
                ("K2", bk.band_fwd_solve, bk.band_fwd_solve_plain),
                ("K3", bk.band_bwd_solve, bk.band_bwd_solve_plain),
                ("K5", bk.band_bwd_multi, bk.band_bwd_solve_plain)):
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
    by system, against K1 (no tail), K2, K3, K5 and K4 bit for bit: every
    solve sums farthest-first, and K9/K10 run K2's and K3's code at the
    system's offset. Returns the factor and the largest kernel-plain
    difference per kernel."""
    nr, d, _ = bands.shape
    L, rinv, hld, _ = bb.band_factor_batched(bands)
    Lp, rinvp, hldp, _ = bb.band_factor_batched_plain(bands)
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
        L1, rinv1, _, hld1, _ = bk.band_factor(bands[r].contiguous(), none)
        same &= (torch.equal(L[r], L1) and torch.equal(rinv[r], rinv1)
                 and torch.equal(hld[r], hld1)
                 and torch.equal(Z[r], bk.band_takahashi(L1, rinv1)))
        for B, Y, X in sols:
            Br = B[r].contiguous()
            same &= (torch.equal(Y[r], bk.band_fwd_solve(L1, rinv1, Br))
                     and torch.equal(X[r], bk.band_bwd_solve(L1, rinv1, Br))
                     and torch.equal(X[r], bk.band_bwd_multi(L1, rinv1, Br)))
    log(f"  K8-K11 {tag}: every system against K1 (q=0), K2, K3, K5 and "
        f"K4 bit for bit {'ok' if same else 'FAIL'}")
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
            if name == "band_takahashi_batched":
                r["device_ms"] = graph_ms(kern)
                log(f"  {name} NR={nr} device time (CUDA graph): "
                    f"{r['device_ms']:.4f} ms")
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
    # off the register-window path: the warp kernels with one, two and
    # four register slots (bw = 12, 34, 70), one right-hand side and a
    # block of several
    for d, bw, nr in ((300, 12, 1), (300, 12, 3), (600, 34, 2),
                      (600, 70, 2)):
        _, bands = spd_batch(dev, nr, d, bw, seed=2)
        Bs = [torch.randn((nr, d, m), generator=g, device=dev,
                          dtype=torch.float64) for m in (1, 5, 40)]
        check_batched_against_one_system(bk, bb, f"d={d} bw={bw} NR={nr}",
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
    L0, _, hld0, c0 = bb.band_factor_batched(bands)
    L, rinv, hld, c = bb.band_factor_batched(bad)
    Lp, _, hldp, cp = bb.band_factor_batched_plain(bad)
    want = [r == slot for r in range(nr)]
    log(f"  K8 clamped pivots reported per system: kernel {c.tolist()}, "
        f"plain {cp.tolist()}")
    require(c.tolist() == want == cp.tolist() and not c0.any(),
            "K8 reports the clamped system alone")
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


def phase_small_replicates(reps, batched, fit):
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
    check_pinned_schur(batched, be, ys)


def check_pinned_schur(batched, be, ys):
    """Where the prior pins the driver (theta_IWP = 30 and 40), each
    replicate's half log-det equals the one-response engine's to 1e-6:
    both form the Schur tail as a Gram of residuals (ROADMAP Queue 3 #5;
    tests/test_torch_fast_batched.py's check at n = 2000, k = 40)."""
    b2 = batched.build_batched(be, ys[:2])
    for t_iwp in (30.0, 40.0):
        one, states, clamped = [], [], False
        with torch.no_grad():
            for r in range(2):
                br = be.with_y(ys[r])
                th = torch.tensor([t_iwp], dtype=torch.float64,
                                  device=be.device)
                st = br.laplace_nll(th)[1]
                fr = br.hessian_factor(*st, th)
                clamped |= bool(fr[0].clamped) or bool(fr[0].tail_left)
                one.append(float(br.half_logdet_H(fr)))
                states.append(st)
            V, tail = (torch.stack(a) for a in zip(*states))
            f = b2.hessian_factor(V, tail, torch.full(
                (2,), t_iwp, dtype=torch.float64, device=be.device))
            got = b2.half_logdet_H(f).cpu().numpy()
        clamped |= bool((f[0].clamped | f[0].tail_left).any())
        gap = float(np.abs(got - np.asarray(one)).max())
        log(f"  theta_IWP = {t_iwp:g}: replicate half log-dets "
            f"{np.round(got, 6).tolist()}, one-response "
            f"{np.round(one, 6).tolist()}, max gap {gap:.3e} (tolerance "
            f"1e-6); a pivot clamped or a tail off its plain route: "
            f"{clamped}")
        require(gap < 1e-6 and not clamped,
                f"replicate half log-det at theta_IWP = {t_iwp:g}")


def check_one_schur_tail(batched, be, ys, thetas=SCHUR_THETAS):
    """Both band engines form the Schur tail by one function (ROADMAP
    Queue 3 #6): at the headline design, each system at its one-response
    mode, the replicate engine's tail S on the one-response engine's
    factor, scalings and weights is the same bits, each system's tail
    takes the same route (plain or chol_jittered's jitter) in both
    engines, and the half log-dets agree to SCHUR_RTOL."""
    log("== phase 6 (one Schur tail): the replicate and one-response "
        f"engines' half log-dets at theta_IWP = {list(thetas)}")
    R = len(ys)
    b2 = batched.build_batched(be, ys)
    for t_iwp in thetas:
        th = torch.tensor([t_iwp], dtype=torch.float64, device=be.device)
        thR = th.expand(R).contiguous()
        one, states, parts = [], [], []
        with torch.no_grad():
            for r in range(R):
                br = be.with_y(ys[r])
                st = br.laplace_nll(th)[1]
                band_s, C_s, _, sc, sd, wts = br._assemble_scaled(*st, th)
                f = br._factor_scaled(band_s, C_s, sc, sd, wts, th)
                S = br._tail_schur(f.L, f.rinv, f.Y, sc, sd, wts, th)
                one.append(float(br.half_logdet_H((f, sc, sd))))
                states.append(st)
                parts.append((f, sc, sd, wts, S))
            S_b = b2._tail_schur(
                torch.stack([p[0].L for p in parts]),
                torch.stack([p[0].rinv for p in parts]),
                torch.stack([p[0].Y for p in parts]),
                *(torch.stack([p[i] for p in parts]) for i in (1, 2, 3)),
                thR)
            V, tail = (torch.stack(a) for a in zip(*states))
            fb = b2.hessian_factor(V, tail, thR)
            got = b2.half_logdet_H(fb).cpu().numpy()
        same_S = all(torch.equal(S_b[r], parts[r][4]) for r in range(R))
        left_one = [bool(p[0].tail_left) for p in parts]
        left_b = fb[0].tail_left.tolist()
        clamped = [bool(p[0].clamped) for p in parts]
        gap = np.abs(got - np.asarray(one))
        log(f"  theta_IWP = {t_iwp:g}: replicate {np.round(got, 6).tolist()}"
            f", one-response {np.round(one, 6).tolist()}, gap "
            f"{gap.max():.3e} (bit for bit: {bool(np.all(gap == 0))}); S "
            f"on the same inputs bit for bit: {same_S}; pivots clamped "
            f"{clamped}, tail off its plain route: one-response {left_one},"
            f" replicate {left_b}")
        require(same_S, f"one Schur tail at theta_IWP = {t_iwp:g}")
        require(left_one == left_b,
                f"the tails' route at theta_IWP = {t_iwp:g}")
        require(np.all(gap <= SCHUR_RTOL * np.abs(np.asarray(one))),
                f"replicate half log-det at theta_IWP = {t_iwp:g}")


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
    # one evaluation, not a whole fit: a fit's trace (~130,000 device
    # operations) took over a minute of the script's time limit to read
    be = fit.mod.backend
    th = torch.tensor(fit.mod.mode, dtype=torch.float64, device=dev)
    profile_run("one Laplace evaluation with its gradient, cold start, "
                "headline", lambda: be.value_and_grad(th, be.init_state()))
    log(f"  mode {mode:.6f}, H {H:.4f}, lognormconst {lnc:.6f}, "
        f"node nlls {np.round(fit.mod.lognll, 4).tolist()}")
    log(f"  fit 2: mode {float(fit2.mod.mode[0]):.6f}, H "
        f"{float(fit2.mod.hessian[0, 0]):.4f}, lognormconst "
        f"{float(fit2.mod.lognormconst):.6f}")
    log(f"  CPU-f64 reference (JAX package): {HEADLINE_CPU_REF}")
    log_fd_spread("headline", be, fit.mod, lambda st: (st[0], st[1]))
    # the driver's prior quadratic at the port's mode and at the JAX
    # package's: the expanded form the JAX package evaluates, the sum of
    # squares the port evaluates, and the longdouble arbiter
    for th in (mode, HEADLINE_CPU_REF["mode"]):
        th = np.asarray([th])
        val, _, (V, t) = be.value_and_grad(th, be.init_state())
        log(f"  Laplace nll at theta {th[0]:.6f}, cold: {float(val):.6f}")
        log_prior_quad("headline", be, V, t, th)
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
    unprofiled wall time as well. Returns {device op: (ms, count)} and the
    busy seconds, or None where the profiler recorded no device time."""
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
        return None
    log(f"  profiled {label}: {wall0:.3f} s wall, {wall:.3f} s under the "
        f"profiler; device busy {busy:.3f} s ({100 * busy / wall0:.1f}% of "
        f"the wall time, {100 * busy / wall:.1f}% under the profiler), "
        f"{sum(e.count for e in events)} device ops; top device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
            f"{e.key[:80]}")
    return {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in events}, busy


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
        if R == 16:
            # the repeat check at R = 16 only: a second R = 64 call took
            # ~25 s of the script's time limit
            (modes2, lncs2), w2 = timed(reps.replicate_fits_packed, be,
                                        ys[:R], k=4)
            require(np.array_equal(modes, modes2)
                    and np.array_equal(lncs, lncs2),
                    f"packed R={R}: the second call repeats the first")
            per_fit[f"packed R={R}"] = w2 / R
            log(f"  packed R={R}: call 1 {w1:.3f} s, call 2 {w2:.3f} s "
                f"(wall, host clock), {w2 / R:.4f} s per fit (call 2); "
                f"launches {counts}")
        else:
            # one call only: its rate includes the first call's set-up
            per_fit[f"packed R={R} (first call)"] = w1 / R
            log(f"  packed R={R}: one call {w1:.3f} s (wall, host clock), "
                f"{w1 / R:.4f} s per fit (first call, set-up included); "
                f"launches {counts}")
        log(f"    modes: first 4 {np.round(modes[:4], 4).tolist()}, range "
            f"[{modes.min():.4f}, {modes.max():.4f}]")
        require(np.all(np.isfinite(modes)) and np.all(np.isfinite(lncs)),
                f"finite modes and lognormconsts, packed R={R}")
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


def dense_spd(dev, d, seed):
    """Seeded Jacobi-equilibrated SPD (d, d) matrix on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn((d, d), generator=g, device=dev, dtype=torch.float64)
    A = G @ G.T / d + torch.eye(d, device=dev, dtype=torch.float64)
    s = torch.rsqrt(torch.diagonal(A))
    return A * s[:, None] * s[None, :]


def log_equal(name, got, want):
    log(f"  {name}: bit for bit {'yes' if torch.equal(got, want) else 'no'}")


def phase_dense_kernels(cd, dev):
    """K6/K7 against their plain versions on the card; the blocked
    factorization at the headline dimension, kernel route against plain
    route."""
    log(f"== phase 2 (dense): K6/K7 (blocks of {cd.B}; r = {DENSE_R}; "
        f"blocked factor at dim {DENSE_DIM}), rtol {DENSE_RTOL:g}")
    A = dense_spd(dev, DENSE_DIM, seed=5)
    blk = A[:cd.B, :cd.B]              # a block of a larger matrix (strided)
    bad = blk.clone()
    bad[0, 0] = 1e-14                  # under the pivot floor: clamp and cap
    err6 = 0.0
    for tag, S, clamps in (("healthy", blk, 0), ("indefinite", bad, 1)):
        flags = torch.zeros(2, dtype=torch.int32, device=dev)
        L = cd.dense_factor_block(S, flags[0])
        Lp = cd.dense_factor_block_plain(S, flags[1])
        err6 = max(err6, check_close(f"K6 {tag}", L, Lp, rtol=DENSE_RTOL))
        log_equal(f"K6 {tag}", L, Lp)
        require(flags.tolist() == [clamps] * 2, f"K6's clamp flag on the "
                f"{tag} block is its plain version's ({clamps}): "
                f"{flags.tolist()}")
    require(float(L.abs().max()) == cd.L_CAP
            and bool((torch.diagonal(L) < 0).any()),
            "the indefinite block met the cap and the clamp")
    Lkk = cd.dense_factor_block(blk)
    g = torch.Generator(device=dev).manual_seed(6)
    err7, rhs = 0.0, {}
    for r in DENSE_R:
        rhs[r] = torch.randn((cd.B, r), generator=g, device=dev,
                             dtype=torch.float64)
        for trans in (False, True):
            X = cd.dense_solve_lower(Lkk, rhs[r], trans)
            Xp = cd.dense_solve_lower_plain(Lkk, rhs[r], trans)
            tag = f"K7 r={r}{' trans' if trans else ''}"
            err7 = max(err7, check_close(tag, X, Xp, rtol=DENSE_RTOL))
            check_equal(tag, X, Xp)
    # a block of a larger matrix whose rows are not 16-byte aligned (the
    # kernel's 8-byte staging path)
    wide = torch.zeros((cd.B, cd.B + 1), dtype=torch.float64, device=dev)
    wide[:, 1:] = Lkk
    for trans in (False, True):
        check_equal(f"K7 unaligned block r=33{' trans' if trans else ''}",
                    cd.dense_solve_lower(wide[:, 1:], rhs[33], trans),
                    cd.dense_solve_lower_plain(Lkk, rhs[33], trans))
    log(f"  K7 bit for bit with its plain version at r = {DENSE_R}, "
        "forward and transposed: ok")
    Lk, Lpl = cd.cholesky_blocked(A), cd.cholesky_blocked(A, cd.PLAIN)
    check_close(f"blocked factor dim {DENSE_DIM}", Lk, Lpl, rtol=DENSE_RTOL)
    log_equal("blocked factor", Lk, Lpl)
    # a pivot under the floor in the last block: the flag of the blocked
    # factor, kernels and plain
    Abad = A.clone()
    Abad[-1, -1] = -1.0
    flags = torch.zeros(4, dtype=torch.int32, device=dev)
    cd.cholesky_blocked(A, flag=flags[0])
    cd.cholesky_blocked(Abad, flag=flags[1])
    cd.cholesky_blocked(A, cd.PLAIN, flag=flags[2])
    cd.cholesky_blocked(Abad, cd.PLAIN, flag=flags[3])
    require(flags.tolist() == [0, 1, 0, 1], f"the blocked factor's clamp "
            f"flag, kernels and plain, healthy and clamped: {flags.tolist()}")
    for r in (1, DENSE_DIM):
        B = torch.randn((DENSE_DIM, r), generator=g, device=dev,
                        dtype=torch.float64)
        for name, fn in (("solve_lower_blocked", cd.solve_lower_blocked),
                         ("solve_lower_t_blocked", cd.solve_lower_t_blocked)):
            check_close(f"{name} r={r}", fn(Lk, B), fn(Lk, B, cd.PLAIN),
                        rtol=DENSE_RTOL)
    res = (A @ cd.solve_lower_t_blocked(Lk, cd.solve_lower_blocked(Lk, B))
           - B).abs().max()
    log(f"  residual |A (L L^T)^-1 B - B| at r={DENSE_DIM}: {float(res):.3e}")
    kern = cuda_ms(lambda: cd.cholesky_blocked(A), n=5, warm=1)
    plain = cuda_ms(lambda: cd.cholesky_blocked(A, cd.PLAIN), n=1, warm=0)
    lib = cuda_ms(lambda: torch.linalg.cholesky(A), n=5, warm=1)
    log(f"  blocked factor dim {DENSE_DIM}: kernels {kern:.3f} ms, plain "
        f"{plain:.1f} ms, torch.linalg.cholesky {lib:.3f} ms")

    f8, nb, tri = 8, cd.B, cd.B * (cd.B + 1) // 2
    rows = {"dense_factor_block": dict(
        err=err6, ms=cuda_ms(lambda: cd.dense_factor_block(blk)),
        plain_ms=cuda_ms(lambda: cd.dense_factor_block_plain(blk), n=3,
                         warm=1),
        library_ms=cuda_ms(lambda: torch.linalg.cholesky(blk)),
        # the kernel alone, from a CUDA graph (the wrapper's host time is
        # near the kernel's; torch.linalg.cholesky does not capture)
        device_ms=graph_ms(lambda: cd.dense_factor_block(blk)),
        # the lower triangle read, the whole factor written; B^3/3 flops
        nbytes=f8 * (tri + nb * nb), flops=nb ** 3 / 3)}
    for r in DENSE_R:
        Br = rhs[r]
        r_ms = cuda_ms(lambda: cd.dense_solve_lower(Lkk, Br))
        r_t = cuda_ms(lambda: cd.dense_solve_lower(Lkk, Br, True))
        log(f"  K7 r={r}: {r_ms:.4f} ms, transposed {r_t:.4f} ms, "
            f"{r_ms / max(r, 1) * 1e3:.3f} us per column")
    # K7 against solve_triangular at the path's two widths (r = 1: the
    # Newton and gradient solves; r = 2051: the log-det backward), both
    # directions: by CUDA events around back-to-back calls (host and
    # device, as the fit calls them) and from a CUDA graph (device only)
    k7 = {}
    for r in (1, DENSE_R[-1]):
        Br = rhs[r]
        for trans in (False, True):
            Lt = Lkk.T if trans else Lkk
            kern = lambda: cd.dense_solve_lower(Lkk, Br, trans)
            lib = lambda: torch.linalg.solve_triangular(Lt, Br, upper=trans)
            t = dict(ms=cuda_ms(kern), library_ms=cuda_ms(lib),
                     device_ms=graph_ms(kern),
                     library_device_ms=graph_ms(lib))
            k7[(r, trans)] = t
            log(f"  K7 r={r}{' trans' if trans else ''}: kernel "
                f"{t['ms']:.4f} ms, solve_triangular {t['library_ms']:.4f} "
                f"ms (events); device {t['device_ms']:.4f} ms against "
                f"{t['library_device_ms']:.4f} ms (CUDA graph)")
    r = DENSE_R[-1]                    # the log-det backward's width
    Br = rhs[r]
    rows["dense_solve_lower"] = dict(
        err=err7, ms=k7[(r, False)]["ms"],
        plain_ms=cuda_ms(lambda: cd.dense_solve_lower_plain(Lkk, Br), n=3,
                         warm=1),
        library_ms=k7[(r, False)]["library_ms"],
        nbytes=f8 * (tri + 2 * nb * r), flops=nb * nb * r, r=r,
        device_ms=k7[(r, False)]["device_ms"],
        library_device_ms=k7[(r, False)]["library_device_ms"],
        ms_r1=k7[(1, False)]["ms"], library_ms_r1=k7[(1, False)]["library_ms"],
        device_ms_r1=k7[(1, False)]["device_ms"],
        library_device_ms_r1=k7[(1, False)]["library_device_ms"],
        bound_ms_r1=bound(f8 * (tri + 2 * nb), nb * nb)[0],
        plain_ms_r1=cuda_ms(lambda: cd.dense_solve_lower_plain(Lkk, rhs[1]),
                            n=3, warm=1))
    log(f"  K6 device time (CUDA graph): "
        f"{rows['dense_factor_block']['device_ms']:.4f} ms")
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = bound(row["nbytes"], row["flops"])
        log(f"  {name}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.2f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
    return rows


def scatter_small_data(n=2000, q=40, seed=0):
    """Scattered levels over a smooth (the port's CPU test model)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    g = rng.integers(0, q, n).astype(float)
    lin = 0.8 + 0.5 * np.sin(x) + 0.2 * rng.normal(size=q)[g.astype(int)]
    return {"x": x, "g": g, "y": rng.poisson(np.exp(lin)).astype(float)}


def bigiid_data(n=N_OBS, q=IID_Q, seed=0):
    """The JAX package's bench_bigiid generator: levels clustered in x
    (an observation-bin random effect, the overdispersion pattern)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 365.0, n))
    g = np.minimum(np.floor(x * (q / 365.0)), q - 1)
    u_true = 0.15 * rng.normal(size=int(g.max()) + 1)
    f_true = 1.5 + 0.8 * np.sin(2 * np.pi * x / 90.0) + 0.002 * x
    y = rng.poisson(np.exp(f_true + u_true[g.astype(int)])).astype(float)
    return {"y": y, "x": x, "g": g}


def scattered_data(n=50_000, q=IID_Q, seed=0):
    """The JAX package's bench_scattered_iid generator: every level spans
    the whole x range (subject effects in a longitudinal smooth)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 365.0, n))
    g = rng.integers(0, q, n).astype(float)
    u_true = 0.1 * rng.normal(size=q)
    f_true = 1.2 + 0.6 * np.sin(2 * np.pi * x / 90.0)
    y = rng.poisson(np.exp(f_true + u_true[g.astype(int)])).astype(float)
    return {"y": y, "x": x, "g": g}


def phase_scatter_small(tbg, dev):
    log("== phase 8: small scattered-IID fit (n=2000, IWP2 k=150, q=40) "
        "against the JAX package's CPU-f64 host path")
    t0 = time.perf_counter()
    fit = tbg.model_fit(IID_FORMULA.format(p=2, k=150),
                        data=scatter_small_data(), family="Poisson",
                        engine="scatter_iid", aghq_k=3, M=IID_M, seed=0,
                        device=dev)
    mode, lnc = np.asarray(fit.mod.mode), float(fit.mod.lognormconst)
    ref = SCATTER_SMALL_REF
    dm = float(np.abs(mode - np.asarray(ref["mode"])).max())
    dl = abs(lnc - ref["lognormconst"])
    log(f"  {time.perf_counter() - t0:.2f} s: mode {np.round(mode, 8)} "
        f"(ref {ref['mode']}), lognormconst {lnc:.8f} (ref "
        f"{ref['lognormconst']}); max|diff| mode {dm:.2e}, lognormconst "
        f"{dl:.2e} (tolerance 1e-5)")
    require(dm < 1e-5 and dl < 1e-5, "small scattered-IID fit matches the "
            "CPU-f64 reference")
    require(fit.samps.shape == (149 + 40 + 2, IID_M)
            and np.all(np.isfinite(fit.samps)), "small scattered-IID draws")


class CountCalls:
    """Counts calls of attributes of a class or module while it is active
    (the calls still run)."""

    def __init__(self, cls, *names):
        self.cls, self.names = cls, names

    def __enter__(self):
        self.calls = {k: 0 for k in self.names}
        self.saved = {k: getattr(self.cls, k) for k in self.names}
        for k in self.names:
            def wrapped(*a, _k=k, **kw):
                self.calls[_k] += 1
                return self.saved[_k](*a, **kw)
            setattr(self.cls, k, wrapped)
        return self

    def __exit__(self, *exc):
        for k, f in self.saved.items():
            setattr(self.cls, k, f)


def phase_scatter_headline(tbg, si, cd, bk, dev):
    log(f"== phase 9: scattered-IID headline fit (n={N_OBS}, IWP3 "
        f"k={IID_K}, q={IID_Q} x-clustered levels, Poisson, AGHQ k=3, "
        f"M={IID_M})")
    kw = dict(data=bigiid_data(), family="Poisson", engine="scatter_iid",
              aghq_k=3, M=IID_M, seed=0, device=dev)
    fml = IID_FORMULA.format(p=3, k=IID_K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cd.reset_launches()
    bk.reset_launches()
    by_r = {"r=1": 0, "r>1": 0}     # K7 launches by right-hand sides
    solve = cd.KERNELS.solve_lower

    def counted(L, Bm, trans=False):
        by_r["r=1" if Bm.shape[1] == 1 else "r>1"] += 1
        return solve(L, Bm, trans)

    cd.KERNELS.solve_lower = counted
    try:
        with CountCalls(torch.linalg, "cholesky", "cholesky_ex",
                        "solve_triangular") as lib, CountCalls(
                si.ScatterIIDBackend, "value_and_grad", "laplace_eval_full",
                "newton_step") as calls:
            t0 = time.perf_counter()
            fit = tbg.model_fit(fml, **kw)
            torch.cuda.synchronize()
            wall1 = time.perf_counter() - t0
    finally:
        cd.KERNELS.solve_lower = solve
    launches = dict(cd.launches)
    band = dict(bk.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    fit2 = tbg.model_fit(fml, **kw)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    m = fit.mod
    be = m.backend
    nfac = launches["dense_factor_block"] // -(-(be.core.dpad + be.core.q)
                                                // cd.B)
    log(f"  fit 1: {wall1:.3f} s, fit 2: {wall2:.3f} s (wall, host clock); "
        f"peak device memory {peak:.2f} GiB")
    log(f"  mode {np.round(m.mode, 6).tolist()}, H "
        f"{np.round(m.hessian, 4).tolist()}, lognormconst "
        f"{m.lognormconst:.6f}")
    log(f"  node nlls {np.round(m.lognll, 4).tolist()}")
    grids = [np.round(g["theta"], 4).tolist() for g in m.marginals]
    log(f"  marginal theta grids {grids}")
    log(f"  fit 2: mode {np.round(fit2.mod.mode, 6).tolist()}, lognormconst "
        f"{fit2.mod.lognormconst:.6f}")
    log(f"  launches in fit 1: {launches} ({nfac} dense factors; K7 by "
        f"right-hand sides {by_r}), band kernels {band}, torch.linalg calls "
        f"{lib.calls}; Laplace evaluations and Newton steps {calls.calls}")
    log_fd_spread("scattered-IID headline", be, m,
                  lambda st: (st[0], st[1], st[2]))
    require(np.all(np.isfinite(m.mode)) and math.isfinite(m.lognormconst),
            "finite scattered-IID mode and lognormconst")
    require(fit.samps.shape == (IID_K - 1 + IID_Q + 3, IID_M)
            and np.all(np.isfinite(fit.samps)), "scattered-IID draws")
    require(all(v > 0 for v in launches.values()),
            f"K6 and K7 launched by the fit: {launches}")
    require(not any(lib.calls.values()),
            f"no torch.linalg factorization on the path: {lib.calls}")
    require(np.array_equal(m.mode, fit2.mod.mode)
            and m.lognormconst == fit2.mod.lognormconst
            and np.array_equal(fit.samps, fit2.samps),
            "the second scattered-IID fit repeats the first")
    require(by_r["r=1"] + by_r["r>1"] == launches["dense_solve_lower"],
            f"K7 launches counted by width: {by_r}")
    return fit, launches, wall1, wall2, by_r


def log_fd_spread(label, be, m, latent):
    """The outer FD Hessian (h = 1e-4) at the fit's mode, warm-started
    from a cold state and from three of the fit's node states (the first,
    the middle and the last): its spread is the value's noise there
    (ROADMAP Queue 3 #2)."""
    J = len(m.states)
    starts = [("cold", be.init_state())] + [
        (f"node {j}", latent(m.states[j])) for j in sorted({0, J // 2, J - 1})]
    Hs = []
    for tag, st in starts:
        H = be.hess(np.asarray(m.mode), st)
        Hs.append(H)
        log(f"    {label}: FD Hessian at the mode, warm from {tag}: "
            f"{np.round(H, 4).tolist()}")
    Hs = np.stack(Hs)
    log(f"  {label}: FD Hessian across {len(Hs)} warm starts: min "
        f"{np.round(Hs.min(0), 4).tolist()}, max "
        f"{np.round(Hs.max(0), 4).tolist()}; the fit's "
        f"{np.round(m.hessian, 4).tolist()}")


def phase_scattered(tbg, cd, dev):
    log("== phase 10: scattered q=1e4 fit (n=5e4, IWP3 k=500, levels "
        "spanning x, Poisson, AGHQ k=3, M=500)")
    cd.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = tbg.model_fit(IID_FORMULA.format(p=3, k=500), data=scattered_data(),
                        family="Poisson", engine="scatter_iid", aghq_k=3,
                        M=500, seed=0, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = fit.mod
    q = fit.mod.backend.q_iid          # levels that occur in the data
    log(f"  {wall:.3f} s (wall): {q} levels, mode "
        f"{np.round(m.mode, 6).tolist()}, H {np.round(m.hessian, 4).tolist()}"
        f", lognormconst {m.lognormconst:.6f}; launches {dict(cd.launches)}")
    require(np.all(np.isfinite(m.mode)) and np.all(np.isfinite(fit.samps))
            and fit.samps.shape == (499 + q + 3, 500),
            "finite scattered fit and draws")
    return wall


def phase_scatter_fixed_point(cd, fit):
    log("== phase 11: dense kernel engine against dense plain engine at a "
        "fixed point of the scattered-IID headline fit")
    be = fit.mod.backend
    j = int(np.argmax(fit.mod.logpost_nodes + fit.mod.logw))
    V0, u0, t0, _ = fit.mod.states[j]
    theta = torch.tensor(fit.mod.nodes[j], dtype=torch.float64,
                         device=be.device)
    plain = dataclasses.replace(be, dense_ops=cd.PLAIN)
    out = {}
    for name, b in (("kernels", be), ("plain", plain)):
        args = [x.clone().requires_grad_(True) for x in (V0, u0, t0, theta)]
        F = b._laplace_value(*args)
        gV, gu, gt, gth = torch.autograd.grad(F, args)
        with torch.no_grad():
            factor = b.hessian_factor(V0, u0, t0, theta)
            zV, zu, zt = b.solve_H(factor, *b.grad_W(V0, u0, t0, theta))
            nV, nu, nt, _ = b.newton_step(V0, u0, t0, theta)
        nll, g, _ = b.value_and_grad(theta, (V0, u0, t0))
        out[name] = dict(F=F.detach(), gV=gV, gu=gu, gt=gt, gth=gth,
                         hld=b.half_logdet_H(factor), zV=zV, zu=zu, zt=zt,
                         nV=nV, nu=nu, nt=nt, nll=nll, g=g)
    for key in out["kernels"]:
        check_close(f"fixed point {key}", out["kernels"][key],
                    out["plain"][key], rtol=1e-9)
    # the kernel engine's outer FD Hessian only: the plain engine's took
    # two minutes of the script's time limit, and the two engines' agree
    # bit for bit at the fixed point above
    Hk = be.hess(np.asarray(fit.mod.mode), (V0, u0, t0))
    log(f"  outer FD Hessian at the mode (h=1e-4, warm from the top node, "
        f"kernel engine): {np.round(Hk, 6).tolist()}; the fit's own "
        f"{np.round(fit.mod.hessian, 6).tolist()}")
    return be, theta


# -- the multi-term banded slice ----------------------------------------

def dominant_band(dev, d, bw, q, seed):
    """Seeded diagonally dominant SPD band (d, bw+1) with unit diagonal
    (off-diagonals c / o * U(-1, 1), rows summing under 0.9) and a tail
    block C (d, q), on the card: a factor at any size without a dense
    matrix."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = 0.45 / sum(1.0 / o for o in range(1, bw + 1)) if bw else 0.0
    o = torch.arange(bw + 1, device=dev, dtype=torch.float64)
    band = (c / torch.clamp(o, min=1.0)) * (
        2.0 * torch.rand((d, bw + 1), generator=g, device=dev,
                         dtype=torch.float64) - 1.0)
    band[:, 0] = 1.0
    for k in range(1, bw + 1):
        band[d - k:, k] = 0.0
    C = 0.1 * torch.randn((d, q), generator=g, device=dev,
                          dtype=torch.float64)
    return band.contiguous(), C


def band_sym_mv(band, X):
    """A X for the symmetric matrix of a (d, bw+1) lower band."""
    d, W = band.shape
    Y = band[:, :1] * X
    for o in range(1, W):
        Y[o:] += band[:d - o, o:o + 1] * X[:d - o]
        Y[:d - o] += band[:d - o, o:o + 1] * X[o:]
    return Y


def lower_mv(L, X, trans=False):
    """L X (or L^T X) for a (d, bw+1) lower band factor L."""
    d, W = L.shape
    Y = L[:, :1] * X
    for o in range(1, W):
        if trans:
            Y[:d - o] += L[:d - o, o:o + 1] * X[o:]
        else:
            Y[o:] += L[:d - o, o:o + 1] * X[:d - o]
    return Y


def rel_residual(name, got, want, tol=1e-10):
    err = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                1e-300)
    log(f"  {name}: relative residual {err:.3e} (tolerance {tol:g})")
    require(err <= tol, f"{name}: residual")


def timed_call(fn):
    """(result, milliseconds) of one call, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def band_work(d, bw, q, M):
    """(bytes, flops) of K1-K5 at (d, bw, q) with M draws: each input read
    once, each output written once; a column of K1 takes its pivot (2 bw
    flops), its band entries (bw (bw + 1)) and its q tail entries (2 bw
    each)."""
    W, f8 = bw + 1, 8
    return {
        "band_factor": (f8 * d * (2 * W + 2 * q + 1) + f8,
                        d * (2 * bw + 3 + bw * (bw + 1) + q * (2 * bw + 1))),
        "band_fwd_solve": (f8 * (d * W + d + 2 * d), d * (2 * bw + 1)),
        "band_bwd_solve": (f8 * (d * W + d + 2 * d), d * (2 * bw + 1)),
        "band_takahashi": (f8 * (2 * d * W + d),
                           d * (2 * bw * bw + 2 * bw + 2)),
        "band_bwd_multi": (f8 * (d * W + d + 2 * d * M),
                           d * M * (2 * bw + 1)),
    }


def check_band_shape(bk, dev, d, bw, q, seed, m):
    """K1-K5 at (d, bw, q) on the card: the full-size outputs held to
    residuals against the band, the kernels against their plain versions
    bit for bit on the first m columns (all d at m = d), and the
    full-size forward outputs' first rows equal to the prefix's; K2 and K3
    at 3 right-hand sides too. Returns per-kernel rows (err, ms, plain_ms,
    rows the plain version ran on; ms_r3 for K2/K3)."""
    tag = f"d={d} bw={bw} q={q}"
    band, C = dominant_band(dev, d, bw, q, seed)
    if q > 1:                        # a column past K1's tile meets the cap
        C[:, -1] *= 1e10
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    M = 1000
    B3 = torch.randn((d, 3), generator=g, device=dev, dtype=torch.float64)
    B = B3[:, :1].contiguous()
    Z = torch.randn((d, M), generator=g, device=dev, dtype=torch.float64)
    tile = bk._library().bgt_band_factor_tile(bw, q)
    (L, rinv, Y, hld, _), k1_ms = timed_call(lambda: bk.band_factor(band,
                                                                     C))
    log(f"  {tag}: K1 computes {tile} tail columns in its block, K2 the "
        f"other {q - tile}")
    v = torch.randn((d, 2), generator=g, device=dev, dtype=torch.float64)
    rel_residual(f"K1 L L^T v = A v, {tag}",
                 lower_mv(L, lower_mv(L, v, trans=True)), band_sym_mv(band, v))
    if q:
        big = Y.abs() >= bk.Y_CAP
        log(f"  K1 Y at the cap |Y| = 1e8: {int(big.sum())} entries")
        keep = ~big.any(0)
        rel_residual(f"K1 L Y = C, {tag}", lower_mv(L, Y[:, keep]),
                     C[:, keep])
    X2 = bk.band_fwd_solve(L, rinv, B)
    X3 = bk.band_bwd_solve(L, rinv, B)
    X5 = bk.band_bwd_multi(L, rinv, Z)
    Zt = bk.band_takahashi(L, rinv)
    rel_residual(f"K2 L x = b, {tag}", lower_mv(L, X2), B)
    rel_residual(f"K3 L^T x = b, {tag}", lower_mv(L, X3, trans=True), B)
    rel_residual(f"K5 L^T X = Z, {tag}", lower_mv(L, X5, trans=True), Z)
    for j in (0, d // 2, d - 1):     # columns of A^{-1} by two solves
        e = torch.zeros((d, 1), device=dev, dtype=torch.float64)
        e[j] = 1.0
        col = bk.band_bwd_solve(L, rinv, bk.band_fwd_solve(L, rinv, e))[:, 0]
        n_o = min(bw, d - 1 - j)
        rel_residual(f"K4 column {j} of A^-1, {tag}",
                     Zt[j, :n_o + 1], col[j:j + n_o + 1], tol=1e-9)

    bp, Cp = band[:m].contiguous(), C[:m].contiguous()
    Bp, Zp = B[:m].contiguous(), Z[:m].contiguous()
    B3p = B3[:m].contiguous()
    Lk, rk, Yk, hk, _ = bk.band_factor(bp, Cp)
    (Lp, rp, Yp, hp, _), t1 = timed_call(lambda: bk.band_factor_plain(bp,
                                                                      Cp))
    rows = {"band_factor": dict(err=max(
        check_close(f"K1 L {tag} rows {m}", Lk, Lp),
        check_close(f"K1 rinv {tag} rows {m}", rk, rp),
        check_close(f"K1 Y {tag} rows {m}", Yk, Yp),
        check_close(f"K1 hld {tag} rows {m}", hk, hp)), plain_ms=t1)}
    same = torch.equal(Lk, Lp) and torch.equal(rk, rp) and torch.equal(Yk, Yp)
    log(f"  K1 {tag} rows {m}: bit for bit {'yes' if same else 'no'}")
    require(same, f"K1 {tag}: kernel equals plain bit for bit")
    # a row of L past m - bw reaches columns the prefix does not hold
    check_equal(f"K1 {tag}: the full factor's first rows equal the "
                "prefix's", torch.cat([L[:m - bw].reshape(-1), rinv[:m],
                                       Y[:m].reshape(-1)]),
                torch.cat([Lk[:m - bw].reshape(-1), rk, Yk.reshape(-1)]))
    for name, fn, plain, rhs in (
            ("band_fwd_solve", bk.band_fwd_solve, bk.band_fwd_solve_plain,
             B3p),
            ("band_bwd_solve", bk.band_bwd_solve, bk.band_bwd_solve_plain,
             B3p),
            ("band_bwd_multi", bk.band_bwd_multi, bk.band_bwd_solve_plain,
             Zp)):
        got = fn(Lk, rk, rhs)
        want, tp = timed_call(lambda: plain(Lk, rk, rhs))
        rows[name] = dict(err=check_close(f"{name} {tag} rows {m}", got,
                                          want), plain_ms=tp)
        check_equal(f"{name} {tag} rows {m}", got, want)
        if rhs is B3p:               # one right-hand side: column 0's bits
            check_equal(f"{name} {tag} rows {m}, r = 1",
                        fn(Lk, rk, Bp)[:, 0], want[:, 0])
    check_equal(f"K2 {tag}: the full solve's first {m} rows equal the "
                "prefix's", X2[:m], bk.band_fwd_solve(Lk, rk, Bp))
    got = bk.band_takahashi(Lk, rk)
    want, tp = timed_call(lambda: bk.band_takahashi_plain(Lk, rk))
    rows["band_takahashi"] = dict(
        err=check_close(f"band_takahashi {tag} rows {m}", got, want),
        plain_ms=tp)
    check_equal(f"band_takahashi {tag} rows {m}", got, want)

    n = 3 if d * bw > 1e6 else 10
    ms = {"band_factor": cuda_ms(lambda: bk.band_factor(band, C), n=n),
          "band_fwd_solve": cuda_ms(lambda: bk.band_fwd_solve(L, rinv, B),
                                    n=n),
          "band_bwd_solve": cuda_ms(lambda: bk.band_bwd_solve(L, rinv, B),
                                    n=n),
          "band_bwd_multi": cuda_ms(lambda: bk.band_bwd_multi(L, rinv, Z),
                                    n=n),
          "band_takahashi": cuda_ms(lambda: bk.band_takahashi(L, rinv), n=n)}
    for name, fn in (("band_fwd_solve", bk.band_fwd_solve),
                     ("band_bwd_solve", bk.band_bwd_solve)):
        rows[name]["ms_r3"] = cuda_ms(lambda: fn(L, rinv, B3), n=n)
    work = band_work(d, bw, q, M)
    for name, r in rows.items():
        r.update(ms=ms[name], plain_rows=m, shape=(d, bw, q))
        r["bound_ms"], r["bound_by"] = bound(*work[name])
    log(f"  {tag}: ms a launch " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items()) + ", at r = 3: " + ", ".join(
        f"{k} {rows[k]['ms_r3']:.3f}" for k in ("band_fwd_solve",
                                                 "band_bwd_solve"))
        + f" (K1 first call {k1_ms:.1f} ms); plain versions on {m} rows, "
        "ms: " + ", ".join(f"{k} {r['plain_ms']:.0f}"
                           for k, r in rows.items()))
    return rows, (band, C, L, rinv, B, Z)


def library_times(dev, band, C, L, B, Z):
    """One PyTorch call on the dense equivalent of each band operation:
    torch.linalg.cholesky of the arrowhead [[A, C], [C^T, I + C^T C]],
    solve_triangular on the dense factor, cholesky_inverse."""
    d, W = band.shape
    q = C.shape[1]
    A = torch.zeros((d, d), dtype=torch.float64, device=dev)
    Ld = torch.zeros_like(A)
    for o in range(W):
        A += torch.diag(band[:d - o, o], -o)
        Ld += torch.diag(L[:d - o, o], -o)
    A = A + A.tril(-1).T
    Cs = 1e-3 * C / torch.clamp(C.abs().max(0).values, min=1.0)
    H = torch.cat([torch.cat([A, Cs], 1), torch.cat(
        [Cs.T, torch.eye(q, dtype=torch.float64, device=dev)
         + Cs.T @ Cs], 1)], 0)
    del A
    out = {"band_factor": cuda_ms(lambda: torch.linalg.cholesky(H), n=3),
           "band_fwd_solve": cuda_ms(lambda: torch.linalg.solve_triangular(
               Ld, B, upper=False), n=3),
           "band_bwd_solve": cuda_ms(lambda: torch.linalg.solve_triangular(
               Ld.T, B, upper=True), n=3),
           "band_bwd_multi": cuda_ms(lambda: torch.linalg.solve_triangular(
               Ld.T, Z, upper=True), n=3),
           "band_takahashi": cuda_ms(lambda: torch.cholesky_inverse(Ld),
                                     n=3)}
    del H, Ld
    torch.cuda.empty_cache()
    return out


def time_k1_variants(bk, band, C):
    """K1 (bw > SMALL_BW) with 1, 2, 3, 4 and 6 bulk warps, and with its tail
    computed by K1's tail solve after the factor instead of by the block's
    tail warp, timed side by side, each bit for bit with the wrapper's
    choice: {variant: ms}."""
    L, rinv, Y, hld, _ = bk.band_factor(band, C)
    out = {}
    for nb in (1, 2, 3, 4, 6):
        check_equal(f"K1 with {nb} bulk warps", bk.band_factor_bulk(
            band, C, nb)[0], L)
        out[f"bulk {nb}"] = cuda_ms(lambda: bk.band_factor_bulk(band, C, nb),
                                    n=5)
    none = C[:, :0]
    lib = bk._library()
    d, W = band.shape

    def unfused():
        L1, r1, _, _, _ = bk.band_factor(band, none)
        Y1 = torch.empty_like(C)
        err = lib.bgt_band_tail_solve(bk._ptr(L1), bk._ptr(r1), bk._ptr(C),
                                      bk._ptr(Y1), d, W - 1, C.shape[1],
                                      bk._stream(C))
        require(err == 0, "K1's tail solve launches")
        return Y1
    check_equal("K1's tail by the tail solve", unfused(), Y)
    out["tail solve after the factor"] = cuda_ms(unfused, n=5)
    tile = lib.bgt_band_factor_tile(W - 1, C.shape[1])
    log(f"  K1 at {tuple(band.shape)} + {C.shape[1]} tail columns, ms by "
        f"variant: {out} (the wrapper takes {tile} tail columns in the "
        "block)")
    return out


def time_k5_blocks(bk, L, rinv, Z):
    """K5 (bw > SMALL_BW) with 1, 4, 8 and 16 draw columns a block of the
    warp kernel, timed side by side, each bit for bit with the wrapper's
    choice: {warps: ms}."""
    X = bk.band_bwd_multi(L, rinv, Z)
    out = {}
    for w in (1, 4, 8, 16):
        check_equal(f"K5 with {w} warps a block", bk.band_bwd_multi_warps(
            L, rinv, Z, w), X)
        out[w] = cuda_ms(lambda: bk.band_bwd_multi_warps(L, rinv, Z, w), n=5)
    log(f"  K5 at {tuple(L.shape)} x {Z.shape[1]} draws, ms by draw columns "
        f"a block of the warp kernel: {out} (the wrapper takes "
        f"{bk.WS_WARPS})")
    return out


def phase_chunked_kernels(bk, dev):
    """K1-K5 at the chunked kernels' shapes; rows at the merged shape."""
    log("== phase 2 (chunked shapes): K1-K5 at (d, bw, q) in "
        f"{CHUNKED_SHAPES}, plain versions on the whole system, on the "
        f"first {PREFIX} columns at {PREFIX_SHAPES}")
    by_shape = {}
    merged = None
    for i, (d, bw, q) in enumerate(CHUNKED_SHAPES):
        m = min(d, PREFIX) if (d, bw, q) in PREFIX_SHAPES else d
        rows, arrays = check_band_shape(bk, dev, d, bw, q, seed=20 + i, m=m)
        for name, r in rows.items():
            by_shape.setdefault(name, {})[f"{d}x{bw}x{q}"] = r["ms"]
            if "ms_r3" in r:
                by_shape.setdefault(name + " r=3", {})[f"{d}x{bw}x{q}"] = (
                    r["ms_r3"])
        if (d, bw, q) == MERGED_SHAPE:
            merged = rows
            band, C, L, rinv, B, Z = arrays
            lib = library_times(dev, band, C, L, B, Z)
            rows["band_bwd_multi"]["ms_by_warps"] = time_k5_blocks(
                bk, L, rinv, Z)
            rows["band_factor"]["ms_by_variant"] = time_k1_variants(
                bk, band, C)
            del band, C, L, rinv, B, Z
        del arrays
    for name, r in merged.items():
        r["library_ms"] = lib[name]
        r["ms_by_shape"] = by_shape[name]
        if name + " r=3" in by_shape:
            r["ms_r3_by_shape"] = by_shape[name + " r=3"]
        log(f"  {CHUNKED[name][0]} at {MERGED_SHAPE}: kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.1f} ms, library "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")
    # a band wider than the kernels take raises in the wrapper
    try:
        bk.band_factor(torch.ones((8, bk.BW_MAX + 2), dtype=torch.float64,
                                  device=dev),
                       torch.zeros((8, 1), dtype=torch.float64, device=dev))
    except ValueError as e:
        log(f"  bw = {bk.BW_MAX + 1} refused: {e}")
    else:
        require(False, "a band wider than BW_MAX is refused")
    return {CHUNKED[name][0]: r for name, r in merged.items()}


def merged_small_data(n=600, n_lev=30, seed=0):
    """tests/test_iid_band.py's merged problem (levels clustered in x)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    g = np.floor(x * (n_lev / 10.0)).astype(float)
    u_true = 0.3 * rng.normal(size=int(g.max()) + 1)
    y = rng.poisson(np.exp(0.5 * np.sin(x) + u_true[g.astype(int)]
                           + 1.0)).astype(float)
    return {"x": x, "g": g, "y": y}


def merged_small_terms(terms, data):
    """An IWP2 k = 12 smooth and the 30-level IID term kept lazy (no dense
    design), as the banded engine keeps an IID term of many levels."""
    iwp = terms.build_iwp_term("x", data["x"], order=2, k=12,
                               materialize_B=False)
    iid = dataclasses.replace(terms.build_iid_term("g", data["g"]), B=None,
                              P=None)
    return [iwp, iid]


def phase_merged_small(tbg, terms, dev):
    log("== phase 13: small merged-IID fit (n=600, IWP2 k=12, 30 levels in "
        "the band, AGHQ k=3) against the JAX package's CPU-f64 host path")
    data = merged_small_data()
    t0 = time.perf_counter()
    fit = tbg.model_fit(data=data, response="y",
                        terms=merged_small_terms(terms, data),
                        family="Poisson", engine="banded", aghq_k=3, M=500,
                        seed=0, device=dev)
    be = fit.mod.backend
    mode, lnc = np.asarray(fit.mod.mode), float(fit.mod.lognormconst)
    ref = MERGED_SMALL_REF
    dm = float(np.abs(mode - np.asarray(ref["mode"])).max())
    dl = abs(lnc - ref["lognormconst"])
    log(f"  {time.perf_counter() - t0:.2f} s: d={be.d} dpad={be.dpad} "
        f"bw={be.Wl - 1} q={be.q}; mode {np.round(mode, 8)} (ref "
        f"{ref['mode']}), lognormconst {lnc:.10f} (ref "
        f"{ref['lognormconst']}); max|diff| mode {dm:.2e}, lognormconst "
        f"{dl:.2e} (tolerance 1e-5)")
    require(dm < 1e-5 and dl < 1e-5, "small merged fit matches the CPU-f64 "
            "reference")
    require(fit.samps.shape == (11 + 30 + 1 + 1, 500)
            and np.all(np.isfinite(fit.samps)), "small merged draws")


def phase_merged_headline(tbg, bk, cd, dev, scatter_fit):
    log(f"== phase 14: merged-IID headline fit (n={N_OBS}, IWP3 k={IID_K}, "
        f"q={IID_Q} x-clustered levels merged into the band, Poisson, AGHQ "
        f"k=3, M={IID_M}, engine='auto')")
    from bayesgp_torch.fast import banded
    kw = dict(data=bigiid_data(), family="Poisson", aghq_k=3, M=IID_M,
              seed=0, device=dev)
    fml = IID_FORMULA.format(p=3, k=IID_K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bk.reset_launches()
    cd.reset_launches()
    with CountCalls(banded.BandedBackend, "value_and_grad",
                    "laplace_eval_full", "newton_step") as calls, \
            warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        fit = tbg.model_fit(fml, **kw)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
    launches = dict(bk.launches)
    dense = dict(cd.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    fit2 = tbg.model_fit(fml, **kw)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    m, be = fit.mod, fit.mod.backend
    log(f"  backend {type(be).__name__}: d={be.d} (driver {be.d_drv}, "
        f"period {be.G}), dpad={be.dpad}, bw={be.Wl - 1}, q={be.q}")
    log(f"  fit 1: {wall1:.3f} s, fit 2: {wall2:.3f} s (wall, host clock); "
        f"peak device memory {peak:.2f} GiB")
    log(f"  mode {np.round(m.mode, 6).tolist()}, H "
        f"{np.round(m.hessian, 4).tolist()}, lognormconst "
        f"{m.lognormconst:.6f}; node nlls {np.round(m.lognll, 4).tolist()}")
    log(f"  launches in fit 1: {launches}, dense {dense}; Laplace "
        f"evaluations and Newton steps {calls.calls}")
    log(f"  warnings of fit 1: {[str(w.message) for w in warned]}")
    sm = scatter_fit.mod
    dmode = np.abs(np.asarray(m.mode) - np.asarray(sm.mode))
    dlnc = m.lognormconst - sm.lognormconst
    log(f"  against phase 9's scatter_iid fit of the same data: mode "
        f"{np.round(sm.mode, 6).tolist()}, lognormconst "
        f"{sm.lognormconst:.6f}; |diff| mode {np.round(dmode, 6).tolist()} "
        f"(held to {MERGED_MODE_TOL}), lognormconst merged - scatter_iid "
        f"{dlnc:.6f} (held to {MERGED_LNC_TOL})")
    # the outer Hessian AGHQ's rule is built on
    eig = {}
    for name, H in (("merged", m.hessian), ("scatter_iid", sm.hessian)):
        eig[name] = np.linalg.eigvalsh(np.asarray(H, np.float64))
        log(f"  {name} outer Hessian eigenvalues {eig[name].tolist()}: "
            f"positive definite {bool(eig[name].min() > 0)}")
    sbe = sm.backend
    rel, vals, left = [], {}, {}
    for th in (np.asarray(MERGED_GATE_THETA), np.asarray(sm.mode),
               np.asarray(m.mode)):
        vm, gm, stm = be.value_and_grad(th, be.init_state())
        vs, gs, sts = sbe.value_and_grad(th, sbe.init_state())
        gm, gs = gm.cpu().numpy(), gs.cpu().numpy()
        rel.append(float(np.abs(gm - gs).max() / np.abs(gs).max()))
        vals[tuple(th)] = float(vm)
        log(f"  Laplace nll and gradient at {np.round(th, 6).tolist()}, "
            f"cold: merged {float(vm):.6f} {np.round(gm, 4)}, scatter_iid "
            f"{float(vs):.6f} {np.round(gs, 4)}; gradients differ by "
            f"{rel[-1]:.3e} of the largest")
        left[tuple(th)] = gate_diagnostic(be, th)[1]
        log_prior_quad("merged", be, stm[0], stm[1], th)
        log_prior_quad("scatter_iid", sbe.core, sts[0], sts[2], th)
    # far out in theta_IWP, where the expanded prior quadratic let the
    # earlier fits run away, the value is above its value at the mode
    v_mode = vals[tuple(np.asarray(m.mode))]
    far = {}
    for th in ((40.0, float(m.mode[1])), RUNAWAY_MODE):
        far[th] = float(be.laplace_nll(np.asarray(th), be.init_state())[0])
        log(f"  merged Laplace nll at {th}, cold: {far[th]:.6f} (at the "
            f"mode {v_mode:.6f})")
    fd = tight_fd(be, sbe, np.asarray(sm.mode))
    # the merged engine's theta gradient at MERGED_GATE_THETA is the
    # scattered-IID engine's: the half-log-det backward keeps the log-det's
    # cotangents on this healthy factor
    require(rel[0] <= 1e-3, f"the merged theta gradient at "
            f"{MERGED_GATE_THETA} within 1e-3 of the scattered-IID engine's")
    require(dmode.max() <= MERGED_MODE_TOL, f"the merged mode within "
            f"{MERGED_MODE_TOL} of the scattered-IID mode: {dmode.tolist()}")
    require(abs(dlnc) <= MERGED_LNC_TOL, f"the merged lognormconst within "
            f"{MERGED_LNC_TOL} nats of the scattered-IID one: {dlnc}")
    require(eig["merged"].min() > 0 and np.all(
        np.abs(eig["merged"] - eig["scatter_iid"])
        <= MERGED_EIG_RTOL * np.abs(eig["scatter_iid"])),
        f"the merged outer Hessian positive definite, each eigenvalue "
        f"within {MERGED_EIG_RTOL:.0%} of the scattered-IID one's: {eig}")
    _, g_tight, cd = fd["merged"]
    require(np.all(np.abs(cd - g_tight) <= MERGED_FD_TOL), f"the merged "
            f"value's central difference at phase 9's mode within "
            f"{MERGED_FD_TOL} of its gradient: {cd} against {g_tight}")
    require(not any(left[tuple(np.asarray(th))] for th in (sm.mode, m.mode)),
            f"the tail factor on its plain route at both modes: {left}")
    require(all(v > v_mode for v in far.values()), "the merged value at "
            f"theta_IWP = 40 and at {RUNAWAY_MODE} above its value at the "
            f"mode: {far} against {v_mode}")
    gate_warned = [str(w.message) for w in warned
                   if issubclass(w.category, RuntimeWarning)
                   and "sick-factor gate" in str(w.message)]
    require(not gate_warned, f"no sick-factor gate warning at the merged "
            f"mode: {gate_warned}")
    require((be.d, be.Wl - 1, be.q) == (13993, 34, 3)
            and be.dpad == MERGED_SHAPE[0], "the merged layout")
    require(np.all(np.isfinite(m.mode)) and math.isfinite(m.lognormconst),
            "finite merged mode and lognormconst")
    require(fit.samps.shape == (IID_K - 1 + IID_Q + 3, IID_M)
            and np.all(np.isfinite(fit.samps)), "merged draws")
    missing = [k for k, v in launches.items() if v <= 0]
    require(not missing, f"every band kernel launched by the fit: {missing}")
    require(np.array_equal(m.mode, fit2.mod.mode)
            and m.lognormconst == fit2.mod.lognormconst
            and np.array_equal(fit.samps, fit2.samps),
            "the second merged fit repeats the first bit for bit")
    return fit, launches, wall1, wall2


def log_prior_quad(name, be, V, t, th):
    """The driver's prior quadratic r^T P r, r = V' - Z0 t, at an inner
    mode, three ways: expanded from the host-built arrays (V'^T P V' -
    2 t^T PZ0^T V' + t^T Z0PZ0 t, over P's band: how the JAX package
    evaluates it), as the engines take it (the sum of squares
    sum w (T r)^2, f64 on the card), and, as the arbiter neither form
    supplies, that sum of squares in numpy.longdouble on the host from
    the same f64 arrays. The value carries half of it times
    e^theta_IWP."""
    with torch.no_grad():
        Vd = V[:be.d]
        Pb = be.P_band
        vpv = (Pb[0] * Vd * Vd).sum()
        for o in range(1, Pb.shape[0]):
            vpv = vpv + 2.0 * (Pb[o, :be.d - o] * Vd[o:] * Vd[:-o]).sum()
        terms = [float(vpv), float(2.0 * torch.dot(t, be.PZ0.T @ Vd)),
                 float(t @ (be.Z0PZ0 @ t))]
        sos = float(be.prior_quad(be.to_V(V, t)))
    ld = np.longdouble
    r = (Vd.cpu().numpy().astype(ld)
         - be.Z0.cpu().numpy().astype(ld) @ t.cpu().numpy().astype(ld))
    Td = be.Tdiags.cpu().numpy().astype(ld)
    U = Td[0] * r
    for o in range(1, Td.shape[0]):
        U[o:] += Td[o, o:] * r[:-o]
    arbiter = (be.prior_w.cpu().numpy().astype(ld) * U * U).sum()
    expanded = terms[0] - terms[1] + terms[2]
    half = 0.5 * math.exp(th[0])
    log(f"    {name} prior quadratic: expanded {expanded:.6e} (terms "
        f"{terms}), sum of squares {sos:.6e}, longdouble arbiter "
        f"{float(arbiter):.6e}; times 0.5 e^theta: {half * expanded:.6e}, "
        f"{half * sos:.6e}, {half * float(arbiter):.6e} nats")


def tight_fd(be, sbe, th):
    """Both engines at theta (phase 9's mode) with the inner Newton run
    tight (no step floor, TIGHT_STALL stalled steps): the Laplace value,
    its theta gradient and a central difference of the value with step
    FD_STEP, warm-started from the centre's inner mode; logged."""
    from bayesgp_torch.fast import iwp
    saved = iwp.STEPTOL, iwp.STALL_ITERS
    iwp.STEPTOL, iwp.STALL_ITERS = 0.0, TIGHT_STALL
    out = {}
    try:
        for name, b in (("merged", be), ("scatter_iid", sbe)):
            v, g, st = b.value_and_grad(th, b.init_state())
            fd = []
            for i in range(len(th)):
                e = np.zeros(len(th))
                e[i] = FD_STEP
                vp = float(b.laplace_nll(th + e, st)[0])
                vm = float(b.laplace_nll(th - e, st)[0])
                fd.append((vp - vm) / (2 * FD_STEP))
            out[name] = (float(v), g.cpu().numpy(), np.asarray(fd))
    finally:
        iwp.STEPTOL, iwp.STALL_ITERS = saved
    log(f"  at phase 9's mode {np.round(th, 6).tolist()}, the inner Newton "
        f"run tight (no step floor, stop after {TIGHT_STALL} stalled steps "
        f"or {iwp.MAX_NEWTON}), cold; central difference step {FD_STEP:g}:")
    for name, (v, g, fd) in out.items():
        log(f"    {name}: nll {v:.6f}, gradient {np.round(g, 4)}, central "
            f"difference {np.round(fd, 4)}")
    (vm_, gm_, fm_), (vs_, gs_, fs_) = out["merged"], out["scatter_iid"]
    log(f"    merged - scatter_iid: nll {vm_ - vs_:.6f}, gradient "
        f"{np.round(gm_ - gs_, 4)}, central difference "
        f"{np.round(fm_ - fs_, 4)}")
    return out


def gate_diagnostic(be, th):
    """The half-log-det backward's sick-factor gate at the cold inner mode
    of theta: the smallest pivot and whether K1 clamped a pivot, the tail
    factor left its plain route, or an entry of H^{-1} the backward reads
    is not finite (the gate drops the log-det's cotangents where any
    holds). Returns the three reasons as bools."""
    _, _, (V, t) = be.value_and_grad(th, be.init_state())
    tht = torch.tensor(th, dtype=torch.float64, device=be.device)
    with torch.no_grad():
        af = be.hessian_factor(V, t, tht)[0]
        clamped, left, nonfinite = (bool(x)
                                    for x in be.engine.gate_reasons(af))
    state = "closed" if clamped or left or nonfinite else "open"
    log(f"    gate: min pivot {float((af.rinv ** -2).min()):.3e}; a pivot "
        f"clamped {clamped}, the tail left its plain route {left}, H^-1 not "
        f"finite {nonfinite}: the gate is {state}")
    return clamped, left, nonfinite


def phase_merged_fixed_point(tbg, bk, dev):
    log("== phase 15: kernel engine against plain engine at a fixed point "
        "of a reduced merged model (n=5000, IWP3 k=100, q=600)")
    fit = tbg.model_fit(IID_FORMULA.format(p=3, k=100),
                        data=bigiid_data(n=5000, q=600), family="Poisson",
                        aghq_k=3, M=10, seed=0, device=dev)
    be = fit.mod.backend
    j = int(np.argmax(fit.mod.logpost_nodes + fit.mod.logw))
    V0, t0, _ = fit.mod.states[j]
    theta = torch.tensor(fit.mod.nodes[j], dtype=torch.float64,
                         device=be.device)
    log(f"  d={be.d} dpad={be.dpad} bw={be.Wl - 1} q={be.q}; top node "
        f"{np.round(fit.mod.nodes[j], 6).tolist()}")
    plain = dataclasses.replace(be, engine=be.engine.with_ops(bk.PLAIN))
    out = {}
    for name, b in (("kernels", be), ("plain", plain)):
        tt = time.perf_counter()
        args = [x.clone().requires_grad_(True) for x in (V0, t0, theta)]
        F = b._laplace_value(*args)
        gV, gt, gth = torch.autograd.grad(F, args)
        with torch.no_grad():
            factor = b.hessian_factor(V0, t0, theta)
            zV, zt = b.solve_H(factor, *b.grad_W(V0, t0, theta))
            nV, nt, _ = b.newton_step(V0, t0, theta)
        nll, g, _ = b.value_and_grad(theta + 0.05, (V0, t0))
        out[name] = dict(F=F.detach(), gV=gV, gt=gt, gth=gth,
                         hld=b.half_logdet_H(factor), zV=zV, zt=zt, nV=nV,
                         nt=nt, nll=nll, g=g)
        log(f"  {name}: {time.perf_counter() - tt:.2f} s")
    for key in out["kernels"]:
        check_close(f"fixed point {key}", out["kernels"][key],
                    out["plain"][key], rtol=1e-9)
    return be, theta


def phase_tail_cell(tbg, bk, cd, dev):
    log("== phase 16: tail-term cell: bench_scattered_iid's engine='banded' "
        "q=512 point (n=5e4, IWP3 k=500, 512 scattered levels in a 515-wide "
        "dense tail, Poisson, AGHQ k=3, M=500)")
    from bayesgp_torch.fast import banded
    bk.reset_launches()
    cd.reset_launches()
    torch.cuda.synchronize()
    with CountCalls(banded.BandedBackend, "value_and_grad",
                    "laplace_eval_full", "newton_step") as calls:
        t0 = time.perf_counter()
        fit = tbg.model_fit(IID_FORMULA.format(p=3, k=500),
                            data=scattered_data(q=512), family="Poisson",
                            engine="banded", aghq_k=3, M=500, seed=0,
                            device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    m, be = fit.mod, fit.mod.backend
    launches = {**bk.launches, **cd.launches}
    log(f"  {wall:.3f} s (wall): {type(be).__name__} d={be.d} bw="
        f"{be.Wl - 1} q={be.q} (dense tail route: {be.engine.dense_tail}); "
        f"mode {np.round(m.mode, 6).tolist()}, lognormconst "
        f"{m.lognormconst:.6f}; launches {launches}; Laplace evaluations "
        f"and Newton steps {calls.calls}")
    require(be.q == 515 and be.engine.dense_tail, "the 515-wide dense tail")
    require(np.all(np.isfinite(m.mode)) and np.all(np.isfinite(fit.samps))
            and fit.samps.shape == (499 + 512 + 3, 500),
            "finite tail-term fit and draws")
    require(all(v > 0 for v in cd.launches.values()),
            f"K6 and K7 launched by the tail-term fit: {cd.launches}")
    return wall, launches


# -- the dense route --------------------------------------------------------
def reset_all_launches(bk, bb, cd):
    for mod in (bk, bb, cd):
        mod.reset_launches()


def kernel_launches(bk, bb, cd):
    return {k: v for mod in (bk, bb, cd) for k, v in mod.launches.items()}


def dense_fit(tbg, formula, **kw):
    """(fit, wall s, the backend's counts, peak device MiB) of one
    model_fit on the card; the peak is the allocator's above what earlier
    phases still hold when the fit starts."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fit = tbg.model_fit(formula, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = dict(getattr(getattr(fit.mod, "backend", None), "stats", {}))
    return fit, wall, stats, (torch.cuda.max_memory_allocated()
                              - held) / 2 ** 20


def log_dense_fit(label, wall, stats, peak):
    log(f"  {label}: {wall:.3f} s wall; {stats.get('evals', 0)} Laplace "
        f"evaluations, {stats.get('newton', 0)} Newton steps, "
        f"{stats.get('syncs', 0)} host syncs; peak device memory "
        f"{peak:.1f} MiB")


def require_same_fit(label, a, b):
    same = (np.array_equal(a.mod.mode, b.mod.mode)
            and a.mod.lognormconst == b.mod.lognormconst
            and np.array_equal(a.mod.lognll, b.mod.lognll)
            and np.array_equal(a.samps, b.samps))
    log(f"  {label}: the two fits equal bit for bit: {same}")
    require(same, f"{label}: two fits on the card agree bit for bit")


def require_covid_golden(label, fit):
    """Hold a covid fit to the golden constants of
    tests/test_golden_covid.py at that file's tolerances."""
    g = COVID_GOLDEN
    mode, lnc = float(fit.mod.mode[0]), float(fit.mod.lognormconst)
    cov = float(np.linalg.inv(fit.mod.hessian)[0, 0])
    ts = fit.theta_summary()["theta(t)"]
    fx = fit.fixed_effects_summary()
    log(f"  {label}: mode {mode:.6f} (golden {g['mode']}), lognormconst "
        f"{lnc:.6f} (golden {g['lognormconst']}), quadrature cov {cov:.6f} "
        f"(golden {g['quad_cov']})")
    log(f"  theta(t): {ts}")
    require(abs(mode - g["mode"]) < 5e-4, f"{label} mode {mode}")
    require(abs(lnc - g["lognormconst"]) < 2e-3, f"{label} lnc {lnc}")
    require(abs(cov - g["quad_cov"]) < 5e-3, f"{label} quad cov {cov}")
    for key, tol in (("mean", 1e-4), ("sd", 1e-3), ("median", 5e-3),
                     ("q2.5", 1e-2), ("q97.5", 1e-2)):
        require(abs(ts[key] - g[key]) < tol, f"{label} theta {key}")
    names = ["intercept"] + [f"weekdays{i}" for i in range(1, 7)]
    for name, want, tol in zip(names, g["fixed_means"],
                               [0.15] + [0.004] * 6):
        require(abs(fx[name]["Mean"] - want) < tol,
                f"{label} fixed mean {name}: {fx[name]['Mean']}")


def phase_covid(tbg, dense_backend, kernels, dev):
    log("== phase 18: the README covid fit on the dense route (n=787, "
        "IWP3 k=30, Poisson, AGHQ k=4, M=3000)")
    kernels[0]()
    kw = dict(data=tbg.datasets.covid_canada(), family="Poisson",
              method="aghq", M=3000, seed=1, device=dev, timing=True)
    fit, wall1, st1, peak1 = dense_fit(tbg, COVID_FORMULA, **kw)
    fit2, wall2, st2, peak2 = dense_fit(tbg, COVID_FORMULA, **kw)
    log(f"  launches of K1-K11 in the two fits: {kernels[1]()}")
    require(isinstance(fit.mod.backend, dense_backend),
            "the covid fit takes the dense route")
    log_dense_fit("fit 1", wall1, st1, peak1)
    log_dense_fit("fit 2", wall2, st2, peak2)
    log("  phases of fit 2:\n" + fit2.timing.summary())
    require_same_fit("covid", fit, fit2)
    require_covid_golden("covid", fit)
    # the post-fit pins of tests/test_golden_covid.py
    text = fit.summary()
    require("AGHQ on a 1 dimensional posterior with  4 quadrature points"
            in text and "theta(t)" in text, "covid summary text")
    row = [r for r in fit.post_table() if r["name"] == "t (SD)"][0]
    log(f"  post_table t (SD): {row}")
    require(np.allclose([row["median"], row["q0.025"], row["q0.975"]],
                        [5.105, 3.943, 6.897], atol=0.02),
            "covid post_table t (SD) row")
    vd = fit.var_density(component="t")
    sd_mode = float(vd["SD"][np.argmax(vd["post"])])
    mass = float(np.trapezoid(vd["post"], vd["SD"]))
    log(f"  var_density: mass {mass:.5f}, SD mode {sd_mode:.4f}, peak "
        f"{float(vd['post'].max()):.5f}")
    require(abs(mass - 1.0) < 0.01 and np.allclose(
        [sd_mode, float(vd["post"].max())], [4.9808, 0.60777], atol=0.02),
        "covid var_density pins")
    for degree in (0, 1, 2):
        pr = fit.predict("t", degree=degree)
        require(len(pr["mean"]) == 787 and np.all(np.isfinite(pr["mean"])),
                f"covid predict degree {degree}")
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "bayesgp_torch", "_build")
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, "covid_fit.npz")
    tbg.save_fit(fit, path)
    back = tbg.load_fit(path)
    os.remove(path)
    new = {"t": np.linspace(0.0, 700.0, 41)}
    same = (back.mod.lognormconst == fit.mod.lognormconst
            and np.array_equal(back.samps, fit.samps)
            and np.array_equal(back.predict("t", newdata=new)["mean"],
                               fit.predict("t", newdata=new)["mean"]))
    log(f"  save_fit/load_fit round trip, predict after the load equal: "
        f"{same}")
    require(same, "covid save/load round trip")
    return fit, wall1, wall2, st1


def lynx_kwargs(tbg):
    lynx = tbg.datasets.lynx()
    prior_SD = tbg.prior_conversion_sgp(d=50, prior={"u": 1.0,
                                                     "alpha": 0.01},
                                        a=2 * np.pi / 10)
    return dict(data={"year": lynx["year"], "y": lynx["count"],
                      "idx": np.arange(len(lynx["year"]), dtype=float)},
                family="Poisson", method="aghq", M=500,
                env={"a_val": 2 * np.pi / 10, "prior_SD": prior_SD},
                control_fixed={"intercept": {"prec": 0.001, "mean": 0}})


def phase_lynx(tbg, dense_backend, kernels, dev):
    log("== phase 19: the sGP lynx vignette on the dense route (sGP k=20 "
        "+ IID, Poisson, w=171, two hyperparameters)")
    kernels[0]()
    fit, wall, stats, peak = dense_fit(tbg, LYNX_FORMULA, device=dev,
                                       **lynx_kwargs(tbg))
    log(f"  launches of K1-K11 in the fit: {kernels[1]()}")
    require(isinstance(fit.mod.backend, dense_backend),
            "the lynx fit takes the dense route")
    log_dense_fit("fit", wall, stats, peak)
    gap_mode = np.abs(fit.mod.mode - LYNX_CPU["mode"]).max()
    gap_lnc = abs(fit.mod.lognormconst - LYNX_CPU["lognormconst"])
    log(f"  mode {np.round(fit.mod.mode, 9).tolist()}, lognormconst "
        f"{fit.mod.lognormconst:.9f}; against the port's CPU-f64 fit: "
        f"mode {gap_mode:.3e} (tolerance 1e-4), lognormconst {gap_lnc:.3e} "
        "(tolerance 1e-5)")
    require(gap_mode < 1e-4 and gap_lnc < 1e-5, "lynx against the CPU fit")
    pred = fit.predict("year")
    spread = float(pred["mean"].max() - pred["mean"].min())
    log(f"  predict('year') spread {spread:.4f} (> 1.5)")
    require(spread > 1.5, "lynx predict spread")
    require(np.all(np.isfinite(fit.var_density(component="year")["post"])),
            "lynx var_density finite")
    # the same vignette on the banded route: the sGP driver interleaved
    # into a band, the IID term in the tail
    kernels[0]()
    bfit, bwall, _, bpeak = dense_fit(tbg, LYNX_FORMULA, device=dev,
                                      engine="banded", **lynx_kwargs(tbg))
    launches = kernels[1]()
    be = bfit.mod.backend
    log(f"  banded route: {type(be).__name__} d={be.d} dpad={be.dpad} "
        f"bw={be.Wl - 1} q={be.q}; {bwall:.3f} s wall, peak "
        f"{bpeak:.1f} MiB; launches {launches}")
    require(getattr(be, "T_is_root", False),
            "the banded lynx fit drives its band with the sGP term")
    gap_lnc = abs(bfit.mod.lognormconst - fit.mod.lognormconst)
    ts, tsb = fit.theta_summary(), bfit.theta_summary()
    gap_th = max(abs(ts[k]["mean"] - tsb[k]["mean"]) for k in ts)
    log(f"  banded: mode {np.round(bfit.mod.mode, 9).tolist()}, "
        f"lognormconst {bfit.mod.lognormconst:.9f}; against the dense fit: "
        f"lognormconst {gap_lnc:.3e} (tolerance {LYNX_BANDED_LNC_TOL:g}), "
        f"theta means {gap_th:.3e} (tolerance {LYNX_BANDED_THETA_TOL:g})")
    require(gap_lnc < LYNX_BANDED_LNC_TOL and gap_th < LYNX_BANDED_THETA_TOL,
            "banded lynx against the dense lynx fit")
    require(all(launches[k] > 0 for k in ("band_factor", "band_fwd_solve",
                                          "band_bwd_solve", "band_takahashi",
                                          "band_bwd_multi")),
            "K1-K5 launched by the banded lynx fit")
    require(np.all(np.isfinite(bfit.samps)), "banded lynx draws")
    return wall, bwall


def dense_boundary_cases():
    """(label, formula, model_fit keywords but the device) of phase 20's
    fits: the Poisson s = 1 cell, a Gaussian response on its design (the
    noise theta makes s = 2) and an nlminb fit of its fixed effects.
    tools/torch_dense_reference.py runs the same on the CPU."""
    data = bench_data(DENSE_N)
    rng = np.random.default_rng(1)
    gdata = dict(data, y=np.log1p(data["y"]) + 0.1 * rng.normal(
        size=DENSE_N))
    formula = FORMULA.format(k=DENSE_K)
    kw = dict(method="aghq", M=M_DRAWS, seed=0)
    return (("poisson", formula, dict(kw, data=data, family="Poisson")),
            ("gaussian", formula, dict(kw, data=gdata, family="Gaussian")),
            ("nlminb", "y ~ z", dict(kw, data=data, family="Poisson",
                                     method="nlminb")))


def dense_result(fit):
    """The numbers phase 20 holds to the CPU: the mode and lognormconst
    of an AGHQ fit, the mean of an nlminb fit."""
    if isinstance(fit.mod, dict):
        return {"mean": np.asarray(fit.mod["mean"], float).tolist()}
    return {"mode": np.asarray(fit.mod.mode, float).tolist(),
            "lognormconst": float(fit.mod.lognormconst)}


def require_dense_cpu(label, fit):
    """Hold one of phase 20's card fits to the port's CPU-f64 fit
    (DENSE_CPU): modes DENSE_MODE_TOL, lognormconsts DENSE_LNC_TOL, the
    nlminb mean DENSE_MEAN_TOL, all absolute."""
    got, want = dense_result(fit), DENSE_CPU[label]
    tols = {"mode": DENSE_MODE_TOL, "lognormconst": DENSE_LNC_TOL,
            "mean": DENSE_MEAN_TOL}
    for key, ref in want.items():
        gap = float(np.abs(np.asarray(got[key]) - np.asarray(ref)).max())
        log(f"  {label} {key}: {np.round(got[key], 9).tolist()}, CPU-f64 "
            f"{np.round(ref, 9).tolist()}, gap {gap:.3e} (tolerance "
            f"{tols[key]:g})")
        require(gap < tols[key], f"boundary {label} {key} against the CPU")


def phase_dense_boundary(tbg, dense_backend, kernels, dev):
    log(f"== phase 20: the dense route at its largest size (n={DENSE_N}, "
        f"IWP3 k={DENSE_K}, Poisson; n*(k-1) = {DENSE_N * (DENSE_K - 1)})")
    (_, formula, pkw), (_, _, gkw), (_, nform, nkw) = dense_boundary_cases()
    kernels[0]()
    fit, wall1, st1, peak1 = dense_fit(tbg, formula, device=dev, **pkw)
    fit2, wall2, st2, peak2 = dense_fit(tbg, formula, device=dev, **pkw)
    log(f"  launches of K1-K11 in the two fits: {kernels[1]()}")
    be = fit.mod.backend
    require(isinstance(be, dense_backend), "the boundary cell takes the "
            "dense route under engine='auto'")
    log_dense_fit("Poisson s=1 fit 1", wall1, st1, peak1)
    log_dense_fit("Poisson s=1 fit 2", wall2, st2, peak2)
    log(f"  w = {be.md.w_count}")
    require_same_fit("boundary Poisson", fit, fit2)
    require(np.all(np.isfinite(fit.samps)), "boundary Poisson draws")
    require_dense_cpu("poisson", fit)
    gfit, gwall, gst, gpeak = dense_fit(tbg, formula, device=dev, **gkw)
    log_dense_fit("Gaussian s=2 fit", gwall, gst, gpeak)
    require(np.all(np.isfinite(gfit.samps)), "boundary Gaussian draws")
    require_dense_cpu("gaussian", gfit)
    nfit, nwall, _, npeak = dense_fit(tbg, nform, device=dev, **nkw)
    log(f"  nlminb fit of the fixed effects: {nwall:.3f} s wall, peak "
        f"{npeak:.1f} MiB")
    require(np.all(np.isfinite(nfit.samps)), "boundary nlminb draws")
    require_dense_cpu("nlminb", nfit)
    th = torch.tensor(fit.mod.mode, dtype=torch.float64, device=dev)
    profile_run("one Laplace evaluation with its gradient, cold start, "
                "dense boundary cell",
                lambda: be.value_and_grad(th, be.init_state()))
    return wall1, wall2, gwall, nwall


BAND_KERNELS = ("band_factor", "band_fwd_solve", "band_bwd_solve",
                "band_takahashi", "band_bwd_multi")


def gauss2_backend(dev, n=N_OBS, k=K_KNOTS):
    """bench_extra.py's _build_iwp(n, k, "Gaussian") on the port: the
    headline generator's x with a Gaussian response, IWP3 with no dense
    design, an intercept, tail priors 0.01."""
    from bayesgp_torch import terms
    from bayesgp_torch.fast.iwp import build_fast_iwp
    from bayesgp_torch.model import build
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 365.0, n))
    f_true = 1.5 + 0.8 * np.sin(2 * np.pi * x / 90.0) + 0.002 * x
    y = f_true + 0.3 * rng.normal(size=n)
    inst = terms.build_iwp_term("x", x, order=3, k=k, materialize_B=False)
    dmf = [np.ones((n, 1))]
    md = build.build_model_data([inst], dmf, y, "Gaussian",
                                dense_design=False)
    xf = np.concatenate([inst.X] + dmf, axis=1)
    pt = np.full(xf.shape[1], 0.01)
    return build_fast_iwp(inst, md, xf, pt, np.zeros_like(pt), inst.x_data,
                          device=dev)


def timed_aghq(aghq, sampling, be, k, M, gen):
    """(fit, draws, fit wall s, draws wall s, Laplace evaluations and
    Newton steps, peak device MiB above what was held) of one AGHQ fit of
    a fast backend and its M posterior draws."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with CountCalls(type(be), "value_and_grad", "laplace_eval_full",
                    "newton_step") as calls:
        t0 = time.perf_counter()
        fit = aghq.aghq_fit(be, k=k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        draws = sampling.sample_marginal(fit, M, gen)[0]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return (fit, draws, t1 - t0, t2 - t1, dict(calls.calls),
            (torch.cuda.max_memory_allocated() - held) / 2 ** 20)


def phase_gauss2(bk, dev):
    """gauss2: the headline design with a Gaussian response (two
    hyperparameters), fitted twice, the fits equal bit for bit; the
    kernel engine against the plain engine at the mode; the Laplace
    value's noise at the mode from warm states."""
    from bayesgp_torch.inference import aghq, sampling
    log(f"== phase 21: gauss2 (bench_extra.py: n={N_OBS}, IWP3 "
        f"k={K_KNOTS}, Gaussian, s=2, AGHQ k=4, M={M_DRAWS})")
    be = gauss2_backend(dev)
    gen = torch.Generator(device=dev)
    out = []
    for i in range(2):
        gen.manual_seed(0)
        bk.reset_launches()
        fit, draws, wall, dwall, calls, peak = timed_aghq(
            aghq, sampling, be, 4, M_DRAWS, gen)
        launches = dict(bk.launches)
        out.append((fit, draws))
        log(f"  fit {i + 1}: {wall:.3f} s wall, draws {dwall:.3f} s; "
            f"value_and_grad {calls['value_and_grad']}, node evaluations "
            f"{calls['laplace_eval_full']}, Newton steps "
            f"{calls['newton_step']}; launches {launches}; peak device "
            f"memory {peak:.1f} MiB")
        if i == 0:
            first = (wall, calls, launches, peak)
    (m, draws), (m2, draws2) = out
    same = (np.array_equal(m.mode, m2.mode)
            and m.lognormconst == m2.lognormconst
            and np.array_equal(m.lognll, m2.lognll)
            and np.array_equal(draws, draws2))
    log(f"  mode {np.round(m.mode, 6).tolist()}, lognormconst "
        f"{m.lognormconst:.6f}, Hessian {np.round(m.hessian, 4).tolist()}; "
        f"the two fits equal bit for bit: {same}")
    require(same, "gauss2: two fits on the card agree bit for bit")
    require(np.all(np.isfinite(m.mode)) and np.all(np.isfinite(draws)),
            "finite gauss2 mode and draws")
    missing = [k for k in BAND_KERNELS if first[2][k] <= 0]
    require(not missing, f"K1-K5 launched by the gauss2 fit: {missing}")
    # the kernel engine against the plain engine at the mode, from the
    # node state nearest it
    j = int(np.argmin(np.linalg.norm(m.nodes - m.mode, axis=1)))
    check_engines_at(bk, be, m.mode, m.states[j][:2], "gauss2")
    # the Laplace value's noise: the mode evaluated from a cold state and
    # from the states of theta +- 0.5, +- 1, one coordinate at a time
    th = torch.tensor(m.mode, dtype=torch.float64, device=dev)
    with torch.no_grad():
        vals = [float(be.laplace_eval_full(th, be.init_state())[0])]
        for i in range(len(m.mode)):
            for step in GAUSS2_STEPS:
                e = torch.zeros_like(th)
                e[i] = step
                st = be.laplace_eval_full(th + e, be.init_state())[1]
                vals.append(float(be.laplace_eval_full(th, st)[0]))
    spread = max(vals) - min(vals)
    log(f"  Laplace nll at the mode from {len(vals)} warm states: "
        f"{[round(v, 9) for v in vals]}; spread {spread:.3e} nats")
    require(math.isfinite(spread), "finite gauss2 Laplace values")
    return first, spread


def check_engines_at(bk, be, mode, state, label):
    """The kernel engine against the plain engine (bk.PLAIN) at (theta,
    V, tail): the Laplace value and its gradients, the half log-det, a
    Newton solve, and the Laplace nll with its theta gradient at theta +
    0.05 warm from the state, to 1e-9 (phases 5 and 15)."""
    V0, t0 = state
    theta = torch.tensor(mode, dtype=torch.float64, device=be.device)
    plain = dataclasses.replace(be, engine=be.engine.with_ops(bk.PLAIN))
    out = {}
    for name, b in (("kernels", be), ("plain", plain)):
        args = [x.clone().requires_grad_(True) for x in (V0, t0, theta)]
        F = b._laplace_value(*args)
        gV, gt, gth = torch.autograd.grad(F, args)
        with torch.no_grad():
            factor = b.hessian_factor(V0, t0, theta)
            zV, zt = b.solve_H(factor, *b.grad_W(V0, t0, theta))
        nll, g, _ = b.value_and_grad(theta + 0.05, (V0, t0))
        out[name] = dict(F=F.detach(), gV=gV, gt=gt, gth=gth,
                         hld=b.half_logdet_H(factor), zV=zV, zt=zt, nll=nll,
                         g=g)
    for key in out["kernels"]:
        check_close(f"{label} at the mode: {key}", out["kernels"][key],
                    out["plain"][key], rtol=1e-9)
    log(f"  {label}: Laplace nll at theta + 0.05 "
        f"{float(out['kernels']['nll']):.9f}, theta gradient "
        f"{out['kernels']['g'].cpu().numpy().tolist()} (kernels), "
        f"{out['plain']['g'].cpu().numpy().tolist()} (plain)")


def two_smooths_data(n=TWO_SMOOTHS_N):
    """bench_extra.py's bench_two_smooths generator."""
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(0.0, 100.0, n))
    season = 0.6 * np.sin(2 * np.pi * x / 10.0)
    trend = 0.02 * x + 0.4 * np.sin(x / 15.0)
    y = trend + season + 0.3 * rng.normal(size=n)
    return {"x": x, "xs": x.copy(), "y": y}


def phase_two_smooths(tbg, bk, dev):
    """two_smooths: an IWP2 and an sGP smooth with a Gaussian response
    (s = 3), held to the golden mode, nll and stationarity of
    tests/test_two_smooth_golden.py; then K1-K5 at the sGP driver's band
    against their plain versions, with bound and library times."""
    log(f"== phase 22: two_smooths (bench_extra.py, BASELINE config 4: "
        f"n={TWO_SMOOTHS_N}, IWP2 k={TWO_SMOOTHS_K} + sGP period 10 "
        f"k={TWO_SMOOTHS_K}, Gaussian, s=3, AGHQ k=3, M=1000)")
    bk.reset_launches()
    fit, wall, _, peak = dense_fit(
        tbg, TWO_SMOOTHS_FORMULA, data=two_smooths_data(),
        family="Gaussian", M=1000, seed=0, aghq_k=3, device=dev,
        env={"k_iwp": TWO_SMOOTHS_K, "k_sgp": TWO_SMOOTHS_K})
    launches = dict(bk.launches)
    be, m = fit.mod.backend, fit.mod
    shape = (be.dpad, be.Wl - 1, be.q)
    log(f"  {wall:.3f} s wall, peak {peak:.1f} MiB: {type(be).__name__}, "
        f"sGP driver {bool(getattr(be, 'T_is_root', False))}, (d, bw, q) = "
        f"({be.d}, {be.Wl - 1}, {be.q}), dpad {be.dpad}; launches "
        f"{launches}")
    require(getattr(be, "T_is_root", False), "two_smooths drives its band "
            "with the sGP term")
    gap = float(np.abs(m.mode - np.asarray(TWO_SMOOTHS_MODE)).max())
    th = torch.tensor(m.mode, dtype=torch.float64, device=dev)
    nll, g, _ = be.value_and_grad(th, be.init_state())
    nll, gmax = float(nll), float(g.abs().max())
    log(f"  mode {np.round(m.mode, 6).tolist()} (golden {TWO_SMOOTHS_MODE},"
        f" gap {gap:.4f}, tolerance {TWO_SMOOTHS_MODE_TOL}); nll at the "
        f"mode {nll:.4f} (golden {TWO_SMOOTHS_NLL} +- "
        f"{TWO_SMOOTHS_NLL_TOL}), max|gradient| {gmax:.3e} (< "
        f"{TWO_SMOOTHS_GRAD_MAX}); lognormconst {m.lognormconst:.6f}")
    require(gap < TWO_SMOOTHS_MODE_TOL, "two_smooths mode")
    require(abs(nll - TWO_SMOOTHS_NLL) < TWO_SMOOTHS_NLL_TOL,
            "two_smooths nll at the mode")
    require(gmax < TWO_SMOOTHS_GRAD_MAX, "two_smooths stationarity")
    require(np.all(np.isfinite(fit.samps)), "two_smooths draws")
    missing = [k for k in BAND_KERNELS if launches[k] <= 0]
    require(not missing, f"K1-K5 launched by two_smooths: {missing}")
    rows, arrays = check_band_shape(bk, dev, *shape, seed=40, m=shape[0])
    lib = library_times(dev, *(arrays[i] for i in (0, 1, 2, 4, 5)))
    for name, r in rows.items():
        r.update(library_ms=lib[name], launches=launches[name])
        log(f"  {name} at the sGP driver's {shape}: kernel {r['ms']:.4f} "
            f"ms, plain {r['plain_ms']:.1f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}), {launches[name]} launches in the fit")
    return wall, rows


# -- the partial-likelihood and customized families -------------------------
def coxph_data(n=COXPH_N, seed=0):
    """bench_extra.py's bench_coxph generator (BASELINE config 3)."""
    rng = np.random.default_rng(seed)
    age = rng.uniform(20, 80, n)
    sex = rng.integers(0, 2, n).astype(float)
    lam = np.exp(0.3 * np.sin(age / 8.0) - 0.8 * sex)
    t_ev = rng.exponential(1.0 / lam)
    t_c = rng.exponential(2.0 / lam.mean(), n)
    return {"time": np.minimum(t_ev, t_c), "age": age, "sex": sex,
            "cens": (t_ev <= t_c).astype(float)}


def cc_call(tbg):
    """(formula, model_fit keywords but the device) of the case-crossover
    vignette, tests/test_partial_likelihood.py:9-22."""
    data = tbg.datasets.sim1data()
    med = float(np.median(data["exposure"]))
    return (f"case ~ f(x=exposure, model='IWP', order=2, k=30, "
            f"initial_location={med}, sd_prior=dict(prior='exp', "
            "param=dict(u=1, alpha=0.5)))",
            dict(data=data, family="cc", strata="subject", method="aghq",
                 M=1000, seed=7))


def nb_data(n=NB_N, seed=2):
    """Counts with a smooth log mean, negative binomial of size 3."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 5, n))
    mu = np.exp(0.5 * np.sin(x) + 1.0)
    return {"y": rng.negative_binomial(3.0, 3.0 / (3.0 + mu)).astype(float),
            "x": x}


def nb_loglik(eta, y, theta):
    """Negative binomial log likelihood, mean e^eta, size e^theta_last."""
    lr = theta[-1]
    r = torch.exp(lr)
    return torch.sum(torch.lgamma(y + r) - torch.lgamma(r)
                     - torch.lgamma(y + 1.0) + r * lr + y * eta
                     - (r + y) * torch.logaddexp(lr.expand(eta.shape), eta))


def poisson_loglik(eta, y, theta):
    """The built-in Poisson family's log likelihood as a user writes it."""
    return torch.sum(y * eta - torch.exp(eta) - torch.lgamma(y + 1.0))


def partial_cases(tbg):
    """(label, formula, model_fit keywords but the device) of the fits
    phases 23-25 hold to PARTIAL_JAX; tools/torch_partial_reference.py
    makes the same calls on the CPU."""
    tbg.register_family(NB_FAMILY, nb_loglik, n_theta_extra=1)
    formula, kw = cc_call(tbg)
    return (("coxph", COXPH_FORMULA,
             dict(data=coxph_data(), family="Coxph", cens="cens", M=1000,
                  seed=0)),
            ("cc", formula, kw),
            ("nb", NB_FORMULA,
             dict(data=nb_data(), family="Customized",
                  customized_template=NB_FAMILY, M=1000, seed=0)),
            ("prior_only", NB_FORMULA,
             dict(data=nb_data(), family="none", M=500, seed=0)))


def require_jax_fit(label, fit):
    """Hold one fit's mode and lognormconst to PARTIAL_JAX[label]."""
    ref = PARTIAL_JAX[label]
    mode = np.asarray(fit.mod.mode, float)
    gap_mode = float(np.abs(mode - np.asarray(ref["mode"])).max())
    gap_lnc = abs(float(fit.mod.lognormconst) - ref["lognormconst"])
    log(f"  {label}: mode {np.round(mode, 9).tolist()}, lognormconst "
        f"{float(fit.mod.lognormconst):.9f}; against the JAX package's "
        f"CPU-f64 fit: mode {gap_mode:.3e} (tolerance {PARTIAL_MODE_TOL:g}),"
        f" lognormconst {gap_lnc:.3e} (tolerance {PARTIAL_LNC_TOL:g})")
    require(gap_mode < PARTIAL_MODE_TOL and gap_lnc < PARTIAL_LNC_TOL,
            f"{label} against the JAX package's CPU fit")


def require_no_launches(label, kernels):
    launches = kernels[1]()
    log(f"  launches of K1-K11 in the {label} fits: {launches}")
    require(not any(launches.values()), f"no kernel launch in {label}")


def phase_coxph(tbg, dense_backend, kernels, dev):
    log(f"== phase 23: CoxPH, BASELINE config 3 (n={COXPH_N}, IWP2 k=30 + "
        "sex, AGHQ k=4, M=1000) on the dense route")
    (_, formula, kw), *_ = partial_cases(tbg)
    kernels[0]()
    fit, wall1, st1, peak1 = dense_fit(tbg, formula, device=dev, **kw)
    fit2, wall2, st2, peak2 = dense_fit(tbg, formula, device=dev, **kw)
    require_no_launches("CoxPH", kernels)
    be = fit.mod.backend
    require(isinstance(be, dense_backend), "the CoxPH fit takes the dense "
            "route")
    log_dense_fit("fit 1", wall1, st1, peak1)
    log_dense_fit("fit 2", wall2, st2, peak2)
    log(f"  w = {be.md.w_count}, fixed effects {fit.fixed_names}")
    require_same_fit("CoxPH", fit, fit2)
    require_jax_fit("coxph", fit)
    require(fit.fixed_names == ["sex"] and np.all(np.isfinite(fit.samps)),
            "CoxPH: no intercept, finite draws")
    sex = float(fit.sample_fixed_effect("sex").mean())
    log(f"  posterior mean of the sex effect {sex:.4f} (simulated -0.8)")
    require(abs(sex + 0.8) < 0.2, "CoxPH sex effect")
    th = torch.tensor(fit.mod.mode, dtype=torch.float64, device=dev)
    profile_run("one Laplace evaluation with its gradient, cold start, "
                "CoxPH n=4000", lambda: be.value_and_grad(th, be.init_state()))
    return wall1, wall2


def phase_cc(tbg, dense_backend, kernels, dev):
    log("== phase 24: the case-crossover vignette on sim1data (3,596 rows, "
        "899 strata, IWP2 k=30, AGHQ k=4, M=1000) on the dense route")
    _, (_, formula, kw), *_ = partial_cases(tbg)
    kernels[0]()
    fit, wall1, st1, peak1 = dense_fit(tbg, formula, device=dev, **kw)
    fit2, wall2, st2, peak2 = dense_fit(tbg, formula, device=dev, **kw)
    require_no_launches("case-crossover", kernels)
    require(isinstance(fit.mod.backend, dense_backend),
            "the case-crossover fit takes the dense route")
    log_dense_fit("fit 1", wall1, st1, peak1)
    log_dense_fit("fit 2", wall2, st2, peak2)
    require_same_fit("case-crossover", fit, fit2)
    require_jax_fit("cc", fit)
    # tests/test_partial_likelihood.py:25-44
    med = float(np.median(kw["data"]["exposure"]))
    grid = np.linspace(0.05, 0.95, 19)
    pred = fit.predict("exposure", newdata={"exposure": grid})
    true_c = 3 * (grid ** 2 - 0.5 ** 2) - 3 * (med ** 2 - 0.5 ** 2)
    rmse = float(np.sqrt(np.mean((pred["mean"] - true_c) ** 2)))
    spread = float(np.mean(pred["pupper"] - pred["plower"]))
    inside = float(np.mean((true_c >= pred["plower"])
                           & (true_c <= pred["pupper"])))
    log(f"  recovery: rmse {rmse:.4f} < band width {spread:.4f}; truth "
        f"inside the band at {100 * inside:.0f}% of the grid (> 80%)")
    require(rmse < spread and inside > 0.8, "cc recovers the true effect")
    require("intercept" not in fit.fixed_samp_indexes, "cc: no intercept")
    return wall1, wall2


def phase_custom(tbg, dense_backend, kernels, dev, covid):
    log("== phase 25: customized families and prior only on the dense "
        "route: the covid fit with a user Poisson loglik, a negative "
        "binomial with one extra theta (s=2), family='none'")
    *_, (_, nb_formula, nb_kw), (_, po_formula, po_kw) = partial_cases(tbg)
    kernels[0]()
    kw = dict(data=tbg.datasets.covid_canada(), family="Customized",
              customized_template=poisson_loglik, method="aghq", M=3000,
              seed=1, device=dev)
    fit, cwall, cst, cpeak = dense_fit(tbg, COVID_FORMULA, **kw)
    log_dense_fit("covid, customized Poisson", cwall, cst, cpeak)
    require(isinstance(fit.mod.backend, dense_backend)
            and fit.mod.backend.em_dims is None,
            "the customized covid fit: dense route, no EM jump")
    require_covid_golden("covid, customized Poisson", fit)
    gap_mode = float(np.abs(fit.mod.mode - covid.mod.mode).max())
    gap_lnc = abs(fit.mod.lognormconst - covid.mod.lognormconst)
    log(f"  against phase 18's built-in Poisson fit: mode {gap_mode:.3e} "
        f"(tolerance {PARTIAL_MODE_TOL:g}), lognormconst {gap_lnc:.3e} "
        f"(tolerance {PARTIAL_LNC_TOL:g})")
    require(gap_mode < PARTIAL_MODE_TOL and gap_lnc < PARTIAL_LNC_TOL,
            "the customized covid fit against the built-in Poisson fit")
    nb, nwall, nst, npeak = dense_fit(tbg, nb_formula, device=dev, **nb_kw)
    log_dense_fit("negative binomial, s=2", nwall, nst, npeak)
    require_jax_fit("nb", nb)
    log(f"  theta_summary keys {list(nb.theta_summary())}")
    require(list(nb.theta_summary()) == ["theta(x)", "theta(family)"]
            and np.all(np.isfinite(nb.samps)), "negative binomial fit")
    po, pwall, pst, ppeak = dense_fit(tbg, po_formula, device=dev, **po_kw)
    log_dense_fit("prior only", pwall, pst, ppeak)
    be = po.mod.backend
    val = float(be.value_and_grad(
        torch.tensor([PRIOR_ONLY_THETA], dtype=torch.float64, device=dev),
        be.init_state())[0])
    want = PARTIAL_JAX["prior_only"]["nll"]
    log(f"  prior only: Laplace value at theta {PRIOR_ONLY_THETA} "
        f"{val:.12f}, the JAX package's {want:.12f} (rtol "
        f"{PRIOR_ONLY_RTOL:g}); mode {po.mod.mode.tolist()}")
    require(abs(val - want) <= PRIOR_ONLY_RTOL * abs(want)
            and np.all(np.isfinite(po.samps)), "prior-only fit")
    require_no_launches("customized and prior-only", kernels)
    return cwall, nwall, pwall


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
    from bayesgp_torch.fast import scatter_iid as si
    from bayesgp_torch.linalg import chol_dense as cd
    from bayesgp_torch.parallel import replicates as reps
    from bayesgp_torch import terms
    from bayesgp_torch.inference.aghq import DenseBackend

    dev = torch.device("cuda:0")
    card = gpu_line()
    log("== phase 1: card and build")
    log(f"  {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{nvcc_version(bk)}, devices {torch.cuda.device_count()}")
    # one nvcc process for each source, started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = [f.result() for f in [pool.submit(bk.build),
                                     pool.submit(cd.build)]]
    log(f"  built {libs[0].name} (K1-K5, K8-K11) and {libs[1].name} (K6, "
        f"K7) in {time.perf_counter() - t0:.2f} s")

    rows = phase_kernels(bk, dev)
    rows.update(phase_batched_kernels(bk, bb, dev))
    rows.update(phase_dense_kernels(cd, dev))
    rows.update(phase_chunked_kernels(bk, dev))
    small = phase_small_fit(tbg, dev)
    phase_small_replicates(reps, batched, small)
    fit, launches, wall1, wall2 = phase_headline(tbg, bk, dev)
    phase_fixed_point(bk, fit)
    be = fit.mod.backend
    rep_launches, (ys16, modes16), per_fit = phase_replicates(
        reps, batched, bb, be, dev)
    phase_batched_fixed_point(batched, bb, be, ys16, modes16)
    check_one_schur_tail(batched, be, ys16[:2])
    launches.update(rep_launches)
    phase_scatter_small(tbg, dev)
    ifit, iid_launches, iwall1, iwall2, k7_by_r = phase_scatter_headline(
        tbg, si, cd, bk, dev)
    launches.update(iid_launches)
    rows["dense_solve_lower"]["launches_by_r"] = k7_by_r
    swall = phase_scattered(tbg, cd, dev)
    ibe, itheta = phase_scatter_fixed_point(cd, ifit)
    log("== phase 12: profiled scattered-IID Laplace evaluation")
    profile_run("one Laplace evaluation with its gradient, cold start, "
                "scattered-IID headline",
                lambda: ibe.value_and_grad(itheta, ibe.init_state()))
    phase_merged_small(tbg, terms, dev)
    mfit, mlaunches, mwall1, mwall2 = phase_merged_headline(tbg, bk, cd, dev,
                                                            ifit)
    launches.update({CHUNKED[k][0]: v for k, v in mlaunches.items()})
    phase_merged_fixed_point(tbg, bk, dev)
    twall, tail_launches = phase_tail_cell(tbg, bk, cd, dev)
    log("== phase 17: profiled merged-IID Laplace evaluation at "
        f"{MERGED_GATE_THETA} (a fixed theta: fixed work across runs)")
    mbe = mfit.mod.backend
    mtheta = torch.tensor(MERGED_GATE_THETA, dtype=torch.float64, device=dev)
    prof = profile_run("one Laplace evaluation with its gradient, cold "
                       "start, merged-IID headline",
                       lambda: mbe.value_and_grad(mtheta, mbe.init_state()))
    if prof is None:
        log("  K4 device time in the merged evaluation: not measured")
    else:
        k4 = [v for k, v in prof[0].items() if "takahashi" in k]
        k4_ms, k4_n = sum(v[0] for v in k4), sum(v[1] for v in k4)
        log(f"  K4 device time in the merged evaluation: {k4_ms:.3f} ms in "
            f"{k4_n} launches ({100 * k4_ms / 1e3 / prof[1]:.1f}% of "
            f"{prof[1] * 1e3:.1f} ms busy)")
        require(k4_n > 0, "K4 ran in the merged evaluation")
    counts = (lambda: reset_all_launches(bk, bb, cd),
              lambda: kernel_launches(bk, bb, cd))
    covid, cwall1, cwall2, cstats = phase_covid(tbg, DenseBackend, counts,
                                                dev)
    lwall, lbwall = phase_lynx(tbg, DenseBackend, counts, dev)
    dwalls = phase_dense_boundary(tbg, DenseBackend, counts, dev)
    (gwall, gcalls, glaunches, gpeak), gspread = phase_gauss2(bk, dev)
    two_wall, sgp_rows = phase_two_smooths(tbg, bk, dev)
    xwalls = phase_coxph(tbg, DenseBackend, counts, dev)
    ccwalls = phase_cc(tbg, DenseBackend, counts, dev)
    uwalls = phase_custom(tbg, DenseBackend, counts, dev, covid)

    kernels = []
    for name, r in rows.items():
        row = {"name": name, "route": "cuda",
               "source": DENSE_SOURCE if name in cd.launches else SOURCE,
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if "systems" in r:      # a batched kernel: timed at this many
            row["systems"] = r["systems"]
            row["ms_by_systems"] = r["ms_by_systems"]
        if "r" in r:            # K7: timed at this many right-hand sides
            row["r"] = r["r"]
        for key in ("device_ms", "library_device_ms", "ms_r1",
                    "library_ms_r1", "device_ms_r1", "library_device_ms_r1",
                    "bound_ms_r1", "plain_ms_r1", "launches_by_r"):
            if key in r:        # K2/K3/K7: device times; K7 at r = 1
                row[key] = r[key]
        if name in glaunches:   # K1-K5: launches in the gauss2 fit
            row["launches_gauss2"] = glaunches[name]
        base = [k for k, v in CHUNKED.items() if v[0] == name]
        if base:                # K1c-K5c: K1-K5 at the sGP driver's band
            sr = sgp_rows[base[0]]
            row["sgp_driver"] = {k: sr[k] for k in (
                "shape", "launches", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "err")}
        if "shape" in r:        # K1c-K5c: K1-K5 at the merged shape
            row.update(shape=r["shape"], plain_rows=r["plain_rows"],
                       ms_by_shape=r["ms_by_shape"])
            if "ms_r3_by_shape" in r:   # K2c/K3c at 3 right-hand sides
                row["ms_r3_by_shape"] = r["ms_r3_by_shape"]
            if "ms_by_warps" in r:      # K5c by warps a block
                row["ms_by_warps"] = r["ms_by_warps"]
            if "ms_by_variant" in r:    # K1c by bulk warps and tail route
                row["ms_by_variant"] = r["ms_by_variant"]
        kernels.append(row)
    log(f"headline fit wall s: first {wall1:.3f}, second {wall2:.3f}")
    log(f"replicate fits, wall s per fit: {per_fit}")
    log(f"scattered-IID headline fit wall s: first {iwall1:.3f}, second "
        f"{iwall2:.3f}; scattered q=1e4 fit {swall:.3f}")
    log(f"merged-IID headline fit wall s: first {mwall1:.3f}, second "
        f"{mwall2:.3f}; tail-term cell {twall:.3f} (launches "
        f"{tail_launches})")
    log(f"dense route wall s: covid first {cwall1:.3f}, second "
        f"{cwall2:.3f} ({cstats}); lynx {lwall:.3f}; boundary cell Poisson "
        f"first {dwalls[0]:.3f}, second {dwalls[1]:.3f}, Gaussian s=2 "
        f"{dwalls[2]:.3f}, nlminb {dwalls[3]:.3f}")
    log(f"banded lynx wall s: {lbwall:.3f}; gauss2 fit wall s {gwall:.3f} "
        f"({gcalls}, peak {gpeak:.1f} MiB), Laplace value spread at its "
        f"mode {gspread:.3e} nats; two_smooths fit wall s {two_wall:.3f}")
    log(f"partial-likelihood and customized fit wall s: CoxPH first "
        f"{xwalls[0]:.3f}, second {xwalls[1]:.3f}; case-crossover first "
        f"{ccwalls[0]:.3f}, second {ccwalls[1]:.3f}; customized covid "
        f"{uwalls[0]:.3f}, negative binomial {uwalls[1]:.3f}, prior only "
        f"{uwalls[2]:.3f}")
    log(f"script wall s: {time.perf_counter() - T_START:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
