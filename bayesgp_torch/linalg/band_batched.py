"""Batched banded SPD Cholesky kernels (K8-K11): NR systems in one launch.

Replicate fits factor and solve NR independent band systems of one shape
at every Newton step. These four functions do each of those in one kernel
launch, one thread block a system:

  band_factor_batched     (K8)   L_r L_r^T = band_r, half log-det per system
  band_fwd_solve_batched  (K9)   L_r X_r = B_r
  band_bwd_solve_batched  (K10)  L_r^T X_r = B_r
  band_takahashi_batched  (K11)  band of H_r^{-1} from L_r

Storage: the per-system convention of band_kernels.py under a leading
system axis, all f64 and contiguous: bands and factors (NR, d, bw+1) with
[r, j, o] = H_r[j+o, j], reciprocal pivots (NR, d), right-hand sides
(NR, d, m) with any number m of columns a system.

They are the counterparts of the JAX package's lane-packed kernels
(linalg/band_batched.py: bfactor_fn, bfwd_fn, bbwd_fn, btakahashi_fn).
That layout -- groups of lanes, broadcasts by rolls, packing and unpacking
-- belongs to the TPU's vector unit and is not carried over. As there, K8
has no tail block: an engine gets Y = L^{-1} C from K9.

Each wrapper checks its arguments, then dispatches on the device of its
tensors as band_kernels.py does: the plain PyTorch version on the CPU
(a loop over columns, vectorized over systems, band entries and
right-hand sides), the CUDA kernel in csrc/band_kernels.cu on a card,
counted in `launches`, and no fallback from one to the other. Every
plain version computes system r with the arithmetic and order of the
one-system plain version in band_kernels.py, and every kernel runs the
device code of the one-system kernel at system r's offset: system r of a
batched result equals the one-system result bit for bit. K8 keeps K1's
guards (pivot floor 1e-12, |L| <= 1e3).
"""
from __future__ import annotations

import torch

from . import band_kernels as bk
from .band_kernels import L_CAP, PIVOT_FLOOR, _check, _on_cuda, _ptr, _stream

# the grid's system axis of K9/K10 (blockIdx.y)
MAX_SYSTEMS = 65535

# kernel launches per wrapper since the last reset_launches()
launches = {"band_factor_batched": 0, "band_fwd_solve_batched": 0,
            "band_bwd_solve_batched": 0, "band_takahashi_batched": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _launch(name, *args):
    bk._launch(name, getattr(bk._library(), "bgt_" + name), *args,
               counts=launches)


def _check_factor(L, rinv):
    _check(L, "L", 3)
    _check(rinv, "rinv", 2)
    if rinv.shape != L.shape[:2]:
        raise ValueError("rinv must have one entry per system and band row")
    if L.shape[0] > MAX_SYSTEMS:
        raise ValueError(f"at most {MAX_SYSTEMS} systems a call")


def _check_rhs(L, B):
    _check(B, "B", 3)
    if B.shape[:2] != L.shape[:2]:
        raise ValueError(f"B has shape {tuple(B.shape)}, the bands "
                         f"{tuple(L.shape)}")


# -- K8: factor -------------------------------------------------------------

def band_factor_batched_plain(bands):
    """Plain version of band_factor_batched (band_factor_plain's
    arithmetic on every system at once, without the tail rows)."""
    NR, d, W = bands.shape
    bw = W - 1
    L = torch.zeros_like(bands)
    rinv = bands.new_zeros((NR, d))
    logdet = bands.new_zeros(NR)
    for j in range(d):
        nprev = min(j, bw)
        piv = bands[:, j, 0]
        for t in range(1, nprev + 1):
            m = L[:, j - t, t]
            piv = piv - m * m
        pv = torch.where(piv < PIVOT_FLOOR,
                         torch.clamp(piv.abs(), min=PIVOT_FLOOR), piv)
        rs = 1.0 / torch.sqrt(pv)
        logdet = logdet + torch.log(pv)
        acc = bands[:, j].clone()
        for t in range(1, nprev + 1):
            acc[:, 1:W - t] = (acc[:, 1:W - t]
                               - L[:, j - t, 1 + t:] * L[:, j - t, t, None])
        col = acc * rs[:, None]
        col[:, 0] = pv * rs
        if j + W > d:
            col[:, d - j:] = 0.0
        L[:, j] = torch.clamp(col, -L_CAP, L_CAP)
        rinv[:, j] = rs
    return L, rinv, 0.5 * logdet


def band_factor_batched(bands):
    """(L, rinv, hld) for (NR, d, bw+1) lower bands: L_r L_r^T = band_r
    (guarded as band_factor), rinv = 1/diag(L_r) as (NR, d), and hld (NR,)
    = 0.5 * sum(log pivots) of each system."""
    _check(bands, "bands", 3)
    if bands.shape[0] > MAX_SYSTEMS:
        raise ValueError(f"at most {MAX_SYSTEMS} systems a call")
    if not _on_cuda(bands):
        return band_factor_batched_plain(bands)
    NR, d, W = bands.shape
    L = torch.empty_like(bands)
    rinv = bands.new_empty((NR, d))
    piv = bands.new_empty((NR, d))      # scratch: the clamped pivots
    hld = bands.new_empty(NR)
    if NR:
        with torch.cuda.device(bands.device):
            _launch("band_factor_batched", _ptr(bands), _ptr(L), _ptr(rinv),
                    _ptr(piv), _ptr(hld), NR, d, W - 1, _stream(bands))
    return L, rinv, hld


# -- K9 / K10: solves -----------------------------------------------------

def band_fwd_solve_batched_plain(L, rinv, B):
    d, W = L.shape[1:]
    X = torch.zeros_like(B)
    for j in range(d):
        acc = B[:, j].clone()
        for t in range(1, min(j, W - 1) + 1):
            acc = acc - X[:, j - t] * L[:, j - t, t, None]
        X[:, j] = acc * rinv[:, j, None]
    return X


def band_bwd_solve_batched_plain(L, rinv, B):
    d, W = L.shape[1:]
    X = torch.zeros_like(B)
    for j in range(d - 1, -1, -1):
        acc = B[:, j].clone()
        for t in range(1, min(d - 1 - j, W - 1) + 1):
            acc = acc - X[:, j + t] * L[:, j, t, None]
        X[:, j] = acc * rinv[:, j, None]
    return X


def _solve(name, plain, L, rinv, B):
    _check_factor(L, rinv)
    _check_rhs(L, B)
    if not _on_cuda(L, rinv, B):
        return plain(L, rinv, B)
    X = torch.empty_like(B)
    NR, d, W = L.shape
    if X.numel():
        with torch.cuda.device(L.device):
            _launch(name, _ptr(L), _ptr(rinv), _ptr(B), _ptr(X), NR, d,
                    W - 1, B.shape[2], _stream(L))
    return X


def band_fwd_solve_batched(L, rinv, B):
    """X with L_r X_r = B_r, for (NR, d, m) right-hand sides B."""
    return _solve("band_fwd_solve_batched", band_fwd_solve_batched_plain,
                  L, rinv, B)


def band_bwd_solve_batched(L, rinv, B):
    """X with L_r^T X_r = B_r, for (NR, d, m) right-hand sides B."""
    return _solve("band_bwd_solve_batched", band_bwd_solve_batched_plain,
                  L, rinv, B)


# -- K11: Takahashi selected inverse --------------------------------------

def band_takahashi_batched_plain(L, rinv):
    NR, d, W = L.shape
    bw = W - 1
    Z = torch.zeros_like(L)
    # blk[r, t-1, o-1] = (H_r^{-1})[j+t, j+o] for the rows below the
    # current j; sums run over t in order, as in the kernel
    blk = L.new_zeros((NR, bw, bw))
    for j in range(d - 1, -1, -1):
        rs = rinv[:, j]
        lr = L[:, j, 1:] * rs[:, None]
        acc = L.new_zeros((NR, bw))
        for t in range(bw):
            acc = acc + lr[:, t, None] * blk[:, t]
        Z[:, j, 1:] = -acc
        zjj = rs * rs
        for t in range(bw):
            zjj = zjj - lr[:, t] * Z[:, j, t + 1]
        Z[:, j, 0] = zjj
        if bw:
            new = L.new_zeros((NR, bw, bw))
            new[:, 0, :] = Z[:, j, :bw]
            new[:, 1:, 0] = Z[:, j, 1:bw]
            new[:, 1:, 1:] = blk[:, :-1, :-1]
            blk = new
    return Z


def band_takahashi_batched(L, rinv):
    """(NR, d, bw+1) bands of H_r^{-1} ([r, j, o] = H_r^{-1}[j+o, j])
    from the factors of the H_r."""
    _check_factor(L, rinv)
    if not _on_cuda(L, rinv):
        return band_takahashi_batched_plain(L, rinv)
    Z = torch.empty_like(L)
    NR, d, W = L.shape
    if NR:
        with torch.cuda.device(L.device):
            _launch("band_takahashi_batched", _ptr(L), _ptr(rinv), _ptr(Z),
                    NR, d, W - 1, _stream(L))
    return Z


class BandBatchedOps:
    """The four batched band operations an engine runs, as one table:
    KERNELS dispatches on the device (the kernels on a card), PLAIN always
    runs the plain versions (the comparison engine)."""

    def __init__(self, factor, fwd_solve, bwd_solve, takahashi):
        self.factor = factor
        self.fwd_solve = fwd_solve
        self.bwd_solve = bwd_solve
        self.takahashi = takahashi


KERNELS = BandBatchedOps(band_factor_batched, band_fwd_solve_batched,
                         band_bwd_solve_batched, band_takahashi_batched)
PLAIN = BandBatchedOps(band_factor_batched_plain,
                       band_fwd_solve_batched_plain,
                       band_bwd_solve_batched_plain,
                       band_takahashi_batched_plain)
