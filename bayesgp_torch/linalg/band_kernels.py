"""Banded SPD Cholesky kernels (K1-K5): CUDA wrappers and plain versions.

The conditional Hessian of an IWP model is a narrow band plus a dense
tail. These five functions carry its factorization and every solve of
the banded Laplace fit:

  band_factor     (K1)  L L^T = band, Y = L^{-1} C, half log-det
  band_fwd_solve  (K2)  L X = B
  band_bwd_solve  (K3)  L^T X = B
  band_bwd_multi  (K5)  L^T X = Z for the posterior draws
  band_takahashi  (K4)  band of H^{-1} from L (selected inverse)

Storage: a lower band is a (d, bw+1) f64 tensor whose row j, column o
holds H[j+o, j] (entries with j+o >= d are ignored). The factor comes
back in the same layout with its reciprocal pivots 1/L[j, j] as a (d,)
tensor; right-hand sides are (d, r).

Each wrapper checks its arguments, then dispatches on the device of its
tensors: on the CPU it runs the plain PyTorch version beside it (a loop
over columns, vectorized over the band entries and right-hand sides);
on a CUDA device it launches the hand-written kernel in
csrc/band_kernels.cu, built with nvcc for sm_90a into _build/ at first
use and bound through ctypes, and counts the launch in `launches`.
There is no fallback from one to the other. The same library holds the
batched kernels K8-K11, whose wrappers are in band_batched.py.

The factor keeps the modified-Cholesky guards of the JAX package's K1:
a pivot below 1e-12 becomes max(|pivot|, 1e-12), |L| is capped at 1e3
and |Y| at 1e8. On a healthy equilibrated system none of them binds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PIVOT_FLOOR = 1e-12
L_CAP = 1e3
Y_CAP = 1e8

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "band_kernels.cu"
BUILD_DIR = _PKG / "_build"
# -fmad=false: no multiply-add contraction, so the kernels round like
# their plain versions and the two agree bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

# kernel launches per wrapper since the last reset_launches()
launches = {"band_factor": 0, "band_fwd_solve": 0, "band_bwd_solve": 0,
            "band_bwd_multi": 0, "band_takahashi": 0}

_lib = None


def reset_launches():
    for k in launches:
        launches[k] = 0


def nvcc():
    """Path of nvcc: on PATH, else under CUDA_HOME (default
    /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                       "built here")


def build_library(source: Path, stem: str) -> Path:
    """Compile one CUDA source into _build/lib{stem}_{tag}.so (the tag is
    the hash of the source and the flags, so an edited source rebuilds)
    and return the library path."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{stem}_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed:\n{e.stdout}\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def build() -> Path:
    """Compile csrc/band_kernels.cu into _build/ and return the library
    path."""
    return build_library(SOURCE, "band_kernels")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bgt_band_factor.argtypes = [P, P, P, P, P, P, P, I, I, I, P]
        for name in ("bgt_band_fwd_solve", "bgt_band_bwd_solve",
                     "bgt_band_bwd_multi"):
            getattr(lib, name).argtypes = [P, P, P, P, I, I, I, P]
        lib.bgt_band_takahashi.argtypes = [P, P, P, I, I, P]
        # the batched entry points (wrappers in band_batched.py)
        lib.bgt_band_factor_batched.argtypes = [P, P, P, P, P, I, I, I, P]
        for name in ("bgt_band_fwd_solve_batched",
                     "bgt_band_bwd_solve_batched"):
            getattr(lib, name).argtypes = [P, P, P, P, I, I, I, I, P]
        lib.bgt_band_takahashi_batched.argtypes = [P, P, P, I, I, I, P]
        for name in ("bgt_band_factor", "bgt_band_fwd_solve",
                     "bgt_band_bwd_solve", "bgt_band_bwd_multi",
                     "bgt_band_takahashi", "bgt_band_factor_batched",
                     "bgt_band_fwd_solve_batched",
                     "bgt_band_bwd_solve_batched",
                     "bgt_band_takahashi_batched"):
            getattr(lib, name).restype = I
        _lib = lib
    return _lib


# -- argument checks ----------------------------------------------------

def _check(t, name, ndim):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != torch.float64:
        raise TypeError(f"{name} must be float64, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(*ts):
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("all tensors must lie on one device")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"unsupported device {dev}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch(name, fn, *args, counts=launches):
    """Call a C entry point, raise if the launch was refused, count it."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    counts[name] += 1


def _check_factor(L, rinv):
    _check(L, "L", 2)
    _check(rinv, "rinv", 1)
    if rinv.shape[0] != L.shape[0]:
        raise ValueError("rinv must have one entry per band row")


def _check_rhs(L, B):
    _check(B, "B", 2)
    if B.shape[0] != L.shape[0]:
        raise ValueError(f"B has {B.shape[0]} rows, the band {L.shape[0]}")


# -- K1: factor -----------------------------------------------------------

def band_factor_plain(band, C):
    """Plain version of band_factor (same arithmetic, column by column)."""
    d, W = band.shape
    bw = W - 1
    L = torch.zeros_like(band)
    Y = torch.zeros_like(C)
    rinv = band.new_zeros(d)
    logdet = band.new_zeros(())
    for j in range(d):
        nprev = min(j, bw)
        piv = band[j, 0]
        for t in range(1, nprev + 1):
            m = L[j - t, t]
            piv = piv - m * m
        pv = torch.where(piv < PIVOT_FLOOR,
                         torch.clamp(piv.abs(), min=PIVOT_FLOOR), piv)
        rs = 1.0 / torch.sqrt(pv)
        logdet = logdet + torch.log(pv)
        acc = band[j].clone()
        for t in range(1, nprev + 1):
            acc[1:W - t] = acc[1:W - t] - L[j - t, 1 + t:] * L[j - t, t]
        col = acc * rs
        col[0] = pv * rs
        if j + W > d:
            col[d - j:] = 0.0
        L[j] = torch.clamp(col, -L_CAP, L_CAP)
        yacc = C[j].clone()
        for t in range(1, nprev + 1):
            yacc = yacc - Y[j - t] * L[j - t, t]
        Y[j] = torch.clamp(yacc * rs, -Y_CAP, Y_CAP)
        rinv[j] = rs
    return L, rinv, Y, 0.5 * logdet


def band_factor(band, C):
    """(L, rinv, Y, hld) for a (d, bw+1) lower band and a (d, q) tail
    block C: L L^T = band (guarded), rinv = 1/diag(L), Y = L^{-1} C and
    hld = 0.5 * sum(log pivots), a 0-d tensor."""
    _check(band, "band", 2)
    _check(C, "C", 2)
    if C.shape[0] != band.shape[0]:
        raise ValueError("C must have one row per band row")
    if not _on_cuda(band, C):
        return band_factor_plain(band, C)
    d, W = band.shape
    q = C.shape[1]
    L = torch.empty_like(band)
    rinv = band.new_empty(d)
    Y = torch.empty_like(C)
    piv = band.new_empty(d)          # scratch: the clamped pivots
    hld = band.new_empty(())
    with torch.cuda.device(band.device):
        _launch("band_factor", _library().bgt_band_factor,
                _ptr(band), _ptr(C), _ptr(L), _ptr(rinv), _ptr(Y),
                _ptr(piv), _ptr(hld), d, W - 1, q, _stream(band))
    return L, rinv, Y, hld


# -- K2: forward solve ------------------------------------------------------

def band_fwd_solve_plain(L, rinv, B):
    d, W = L.shape
    X = torch.zeros_like(B)
    for j in range(d):
        acc = B[j].clone()
        for t in range(1, min(j, W - 1) + 1):
            acc = acc - X[j - t] * L[j - t, t]
        X[j] = acc * rinv[j]
    return X


def band_fwd_solve(L, rinv, B):
    """X with L X = B, for (d, r) right-hand sides B."""
    _check_factor(L, rinv)
    _check_rhs(L, B)
    if not _on_cuda(L, rinv, B):
        return band_fwd_solve_plain(L, rinv, B)
    X = torch.empty_like(B)
    with torch.cuda.device(L.device):
        _launch("band_fwd_solve", _library().bgt_band_fwd_solve,
                _ptr(L), _ptr(rinv), _ptr(B), _ptr(X), L.shape[0],
                L.shape[1] - 1, B.shape[1], _stream(L))
    return X


# -- K3 / K5: backward solves -------------------------------------------------

def band_bwd_solve_plain(L, rinv, B):
    d, W = L.shape
    X = torch.zeros_like(B)
    for j in range(d - 1, -1, -1):
        acc = B[j].clone()
        for t in range(1, min(d - 1 - j, W - 1) + 1):
            acc = acc - X[j + t] * L[j, t]
        X[j] = acc * rinv[j]
    return X


def _bwd(name, fn_name, L, rinv, B):
    _check_factor(L, rinv)
    _check_rhs(L, B)
    if not _on_cuda(L, rinv, B):
        return band_bwd_solve_plain(L, rinv, B)
    X = torch.empty_like(B)
    with torch.cuda.device(L.device):
        _launch(name, getattr(_library(), fn_name),
                _ptr(L), _ptr(rinv), _ptr(B), _ptr(X), L.shape[0],
                L.shape[1] - 1, B.shape[1], _stream(L))
    return X


def band_bwd_solve(L, rinv, B):
    """X with L^T X = B, for (d, r) right-hand sides B (the Newton and
    gradient solves)."""
    return _bwd("band_bwd_solve", "bgt_band_bwd_solve", L, rinv, B)


band_bwd_multi_plain = band_bwd_solve_plain


def band_bwd_multi(L, rinv, Z):
    """X with L^T X = Z for the (d, M) noise of M posterior draws (the
    same recurrence as band_bwd_solve, kept as its own kernel entry)."""
    return _bwd("band_bwd_multi", "bgt_band_bwd_multi", L, rinv, Z)


# -- K4: Takahashi selected inverse -----------------------------------------

def band_takahashi_plain(L, rinv):
    d, W = L.shape
    bw = W - 1
    Z = torch.zeros_like(L)
    # blk[t-1, o-1] = (H^{-1})[j+t, j+o] for the rows below the current j;
    # sums run over t in order, as in the kernel
    blk = L.new_zeros((bw, bw))
    for j in range(d - 1, -1, -1):
        rs = rinv[j]
        lr = L[j, 1:] * rs
        acc = L.new_zeros(bw)
        for t in range(bw):
            acc = acc + lr[t] * blk[t]
        Z[j, 1:] = -acc
        zjj = rs * rs
        for t in range(bw):
            zjj = zjj - lr[t] * Z[j, t + 1]
        Z[j, 0] = zjj
        if bw:
            new = L.new_zeros((bw, bw))
            new[0, :] = Z[j, :bw]
            new[1:, 0] = Z[j, 1:bw]
            new[1:, 1:] = blk[:-1, :-1]
            blk = new
    return Z


def band_takahashi(L, rinv):
    """(d, bw+1) band of H^{-1} (row j, column o = H^{-1}[j+o, j]) from
    the factor of H."""
    _check_factor(L, rinv)
    if not _on_cuda(L, rinv):
        return band_takahashi_plain(L, rinv)
    Z = torch.empty_like(L)
    with torch.cuda.device(L.device):
        _launch("band_takahashi", _library().bgt_band_takahashi,
                _ptr(L), _ptr(rinv), _ptr(Z), L.shape[0], L.shape[1] - 1,
                _stream(L))
    return Z


class BandOps:
    """The five band operations an engine runs, as one table: KERNELS
    dispatches on the device (the kernels on a card), PLAIN always runs
    the plain versions (the comparison engine)."""

    def __init__(self, factor, fwd_solve, bwd_solve, bwd_multi, takahashi):
        self.factor = factor
        self.fwd_solve = fwd_solve
        self.bwd_solve = bwd_solve
        self.bwd_multi = bwd_multi
        self.takahashi = takahashi


KERNELS = BandOps(band_factor, band_fwd_solve, band_bwd_solve,
                  band_bwd_multi, band_takahashi)
PLAIN = BandOps(band_factor_plain, band_fwd_solve_plain, band_bwd_solve_plain,
                band_bwd_multi_plain, band_takahashi_plain)
