"""Banded SPD Cholesky kernels (K1-K5): CUDA wrappers and plain versions.

The conditional Hessian of an IWP model is a narrow band plus a dense
tail. These five functions carry its factorization and every solve of
the banded Laplace fit:

  band_factor     (K1)  L L^T = band, Y = L^{-1} C, half log-det
  band_fwd_solve  (K2)  L X = B (band_fwd_solve_gated: where a device
                        flag is set, in place)
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

They serve every shape the JAX package sends to its kernels, those of
its chunked kernels K1c-K5c included: a band up to BW_MAX = 125 wide
(every wrapper refuses a wider one), any tail width and any d.

The factor keeps the modified-Cholesky guards of the JAX package's K1:
a pivot below 1e-12 becomes max(|pivot|, 1e-12), |L| is capped at 1e3
and |Y| at 1e8. On a healthy equilibrated system none of them binds;
the factor reports whether it clamped a pivot, which the half-log-det
backward reads (band_arrow.py).

Every kernel sums in one order, farthest-first: a solve (K2, K3, K5)
subtracts a row's products from the x farthest from the row first and
the nearest last, so that one product of a row waits on the row just
solved; the factor (K1) subtracts each entry's products from the column
farthest back first, as a right-looking factor makes them, so that one
product of a pivot waits on the column just factored, and its tail Y =
L^{-1} C is K2's solve with the cap on |Y|; the selected inverse (K4)
subtracts each entry's products farthest-first and takes Z[j, 1]'s
product last in Z[j, 0], so that two multiply-subtracts lie between one
row's diagonal and the next. The plain versions sum in the same order.
K5 is K3's function on the M columns of the draws, on K3's kernels.
"""
from __future__ import annotations

import contextlib
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
# widest band the kernels take: the JAX package sends bands up to 125 to
# its kernels, and every kernel's shared memory holds that width
BW_MAX = 125
# widest band the register-window kernels serve (csrc/band_kernels.cu);
# wider bands take the warp kernels, whose blocks hold one right-hand side
# for up to 4 of them and WS_WARPS for more (K5's draws): the C constants
SMALL_BW = 8
WS_WARPS = 8

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
        lib.bgt_band_factor.argtypes = [P, P, P, P, P, P, P, P, I, I, I, P]
        lib.bgt_band_factor_tile.argtypes = [I, I]
        lib.bgt_band_factor_bulk.argtypes = [P, P, P, P, P, P, P, P, I, I, I,
                                             I, P]
        lib.bgt_band_tail_solve.argtypes = [P, P, P, P, I, I, I, P]
        lib.bgt_band_fwd_solve_gated.argtypes = [P, P, P, P, P, I, I, I, P]
        for name in ("bgt_band_fwd_solve", "bgt_band_bwd_solve",
                     "bgt_band_bwd_multi"):
            getattr(lib, name).argtypes = [P, P, P, P, I, I, I, P]
        lib.bgt_band_bwd_multi_warps.argtypes = [P, P, P, P, I, I, I, I, P]
        lib.bgt_band_takahashi.argtypes = [P, P, P, I, I, P]
        # the batched entry points (wrappers in band_batched.py)
        lib.bgt_band_factor_batched.argtypes = [P, P, P, P, P, P, I, I, I,
                                                P]
        for name in ("bgt_band_fwd_solve_batched",
                     "bgt_band_bwd_solve_batched"):
            getattr(lib, name).argtypes = [P, P, P, P, I, I, I, I, P]
        lib.bgt_band_takahashi_batched.argtypes = [P, P, P, I, I, I, P]
        for name in ("bgt_band_factor", "bgt_band_factor_tile",
                     "bgt_band_factor_bulk", "bgt_band_tail_solve",
                     "bgt_band_fwd_solve", "bgt_band_fwd_solve_gated",
                     "bgt_band_bwd_solve",
                     "bgt_band_bwd_multi",
                     "bgt_band_bwd_multi_warps",
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
    """The raw handle of the current stream of t's device."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))


_NO_SWITCH = contextlib.nullcontext()


def _device(t):
    """Context in which a launch goes to t's device: nothing to do where
    it is the current device (a device switch costs microseconds of host
    time, as much as some kernels take)."""
    if t.device.index == torch._C._cuda_getDevice():
        return _NO_SWITCH
    return torch.cuda.device(t.device)


def _launch(name, fn, *args, counts=launches):
    """Call a C entry point, raise if the launch was refused, count it."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    counts[name] += 1


def _check_bw(W):
    if not 1 <= W <= BW_MAX + 1:
        raise ValueError(f"band width {W - 1} is outside 0..{BW_MAX}")


def _check_factor(L, rinv):
    _check(L, "L", 2)
    _check(rinv, "rinv", 1)
    _check_bw(L.shape[1])
    if rinv.shape[0] != L.shape[0]:
        raise ValueError("rinv must have one entry per band row")


def _check_rhs(L, B):
    _check(B, "B", 2)
    if B.shape[0] != L.shape[0]:
        raise ValueError(f"B has {B.shape[0]} rows, the band {L.shape[0]}")


# -- K1: factor -----------------------------------------------------------

def _prev_rows(A, j, n):
    """Rows j-1, j-2, ..., j-n of A (the t-th at t-1)."""
    return A[j - n:j].flip(0)


def _subtract_in_order(acc, prods):
    """acc - prods[0] - prods[1] - ..., one row at a time: the kernels'
    order of sums."""
    for t in range(prods.shape[0]):
        acc = acc - prods[t]
    return acc


def _multipliers(L):
    """(d, bw) multipliers of the forward recurrences, [j, t-1] =
    L[j-t, t] (zero where j < t)."""
    d, W = L.shape
    j = torch.arange(d, device=L.device)[:, None]
    t = torch.arange(1, W, device=L.device)[None, :]
    rows = torch.clamp(j - t, min=0)
    return torch.where(j >= t, L[rows, t], L.new_zeros(()))


def band_factor_plain(band, C):
    """Plain version of band_factor (same arithmetic, column by column:
    the products of a column are formed at once, then subtracted in the
    kernels' order, farthest-first: the product from column j - bw
    first, the one from column j - 1 last)."""
    d, W = band.shape
    bw = W - 1
    L = torch.zeros_like(band)
    Y = torch.zeros_like(C)
    rinv = band.new_zeros(d)
    logdet = band.new_zeros(())
    # shifted[t-1, o] = o + t: the entry of row j-t that meets entry o of
    # column j (o = 0 gives the pivot's L[j-t, t] itself)
    ar = torch.arange(W, device=band.device)
    shifted = ar[None, :] + ar[1:, None]
    inside = shifted <= bw
    shifted = torch.clamp(shifted, max=bw)
    zero = band.new_zeros(())
    lows = []                        # per row: the raw pivot was clamped
    for j in range(d):
        nprev = min(j, bw)
        acc = torch.cat([band[j], C[j]])
        if nprev:
            P = _prev_rows(L, j, nprev)                 # row t-1 = L[j-t]
            m = P[ar[:nprev], ar[1:nprev + 1]][:, None]  # L[j-t, t]
            S = torch.where(inside[:nprev],
                            P.gather(1, shifted[:nprev]) * m, zero)
            acc = _subtract_in_order(acc, torch.cat(
                [S, _prev_rows(Y, j, nprev) * m], dim=1).flip(0))
        piv = acc[0]
        low = piv < PIVOT_FLOOR
        lows.append(low)
        pv = torch.where(low, torch.clamp(piv.abs(), min=PIVOT_FLOOR), piv)
        rs = 1.0 / torch.sqrt(pv)
        logdet = logdet + torch.log(pv)
        col = acc[:W] * rs
        col[0] = pv * rs
        if j + W > d:
            col[d - j:] = 0.0
        L[j] = torch.clamp(col, -L_CAP, L_CAP)
        Y[j] = torch.clamp(acc[W:] * rs, -Y_CAP, Y_CAP)
        rinv[j] = rs
    clamped = (torch.stack(lows).any() if lows else
               torch.zeros((), dtype=torch.bool, device=band.device))
    return L, rinv, Y, 0.5 * logdet, clamped


def band_factor(band, C):
    """(L, rinv, Y, hld, clamped) for a (d, bw+1) lower band and a (d, q)
    tail block C: L L^T = band (guarded), rinv = 1/diag(L), Y = L^{-1} C,
    hld = 0.5 * sum(log pivots), a 0-d tensor, and clamped, a 0-d bool
    tensor: whether a raw pivot fell under PIVOT_FLOOR and was clamped.

    On a card K1 computes the first columns of Y beside the band, as many
    as its block takes (bgt_band_factor_tile); the others are one launch
    of K1's tail solve on the new factor (bgt_band_tail_solve: K2's
    kernels with the cap on |Y|, counted as a band_factor launch), which
    computes each column as K1 does."""
    _check(band, "band", 2)
    _check(C, "C", 2)
    _check_bw(band.shape[1])
    if C.shape[0] != band.shape[0]:
        raise ValueError("C must have one row per band row")
    if not _on_cuda(band, C):
        return band_factor_plain(band, C)
    d, W = band.shape
    q = C.shape[1]
    lib = _library()
    tile = lib.bgt_band_factor_tile(W - 1, q)
    C0 = C if tile == q else C[:, :tile].contiguous()
    L = torch.empty_like(band)
    rinv = band.new_empty(d)
    Y0 = torch.empty_like(C0)
    piv = band.new_empty(d)          # scratch: the clamped pivots
    hld = band.new_empty(())
    flag = torch.empty((), dtype=torch.int32, device=band.device)
    with _device(band):
        _launch("band_factor", lib.bgt_band_factor,
                _ptr(band), _ptr(C0), _ptr(L), _ptr(rinv), _ptr(Y0),
                _ptr(piv), _ptr(hld), _ptr(flag), d, W - 1, tile,
                _stream(band))
        if tile == q:
            return L, rinv, Y0, hld, flag != 0
        C1 = C[:, tile:].contiguous()
        Y1 = torch.empty_like(C1)
        _launch("band_factor", lib.bgt_band_tail_solve,
                _ptr(L), _ptr(rinv), _ptr(C1), _ptr(Y1), d, W - 1,
                q - tile, _stream(band))
    return L, rinv, torch.cat([Y0, Y1], dim=1), hld, flag != 0


def band_factor_bulk(band, C, bulk):
    """band_factor on a card (bw > SMALL_BW, C no wider than the block's
    tail) with `bulk` warps subtracting the products off the pivot chain
    (1 .. FG_MAX_BULK in csrc/band_kernels.cu), the block shapes timed side
    by side in chip_smoke.py. Not on any fit's path, and not counted."""
    _check(band, "band", 2)
    _check(C, "C", 2)
    if not _on_cuda(band, C):
        raise ValueError("band_factor_bulk times the CUDA kernel: its "
                         "tensors must lie on a card")
    d, W = band.shape
    L = torch.empty_like(band)
    rinv = band.new_empty(d)
    Y = torch.empty_like(C)
    piv = band.new_empty(d)
    hld = band.new_empty(())
    flag = torch.empty((), dtype=torch.int32, device=band.device)
    with _device(band):
        err = _library().bgt_band_factor_bulk(
            _ptr(band), _ptr(C), _ptr(L), _ptr(rinv), _ptr(Y), _ptr(piv),
            _ptr(hld), _ptr(flag), d, W - 1, C.shape[1], bulk, _stream(band))
    if err != 0:
        raise RuntimeError(f"band_factor_bulk: CUDA error {err} at launch")
    return L, rinv, Y, hld, flag != 0


# -- K2: forward solve ------------------------------------------------------

def band_fwd_solve_plain(L, rinv, B):
    """Plain version of band_fwd_solve: row j is B[j] less the products
    L[j-t, t] x_{j-t}, farthest-first (t = bw first), times rinv[j]."""
    d, W = L.shape
    X = torch.zeros_like(B)
    mult = _multipliers(L)[:, :, None]
    for j in range(d):
        n = min(j, W - 1)
        prods = _prev_rows(X, j, n) * mult[j, :n]
        X[j] = _subtract_in_order(B[j], prods.flip(0)) * rinv[j]
    return X


def band_fwd_solve(L, rinv, B):
    """X with L X = B, for (d, r) right-hand sides B."""
    _check_factor(L, rinv)
    _check_rhs(L, B)
    if not _on_cuda(L, rinv, B):
        return band_fwd_solve_plain(L, rinv, B)
    X = torch.empty_like(B)
    with _device(L):
        _launch("band_fwd_solve", _library().bgt_band_fwd_solve,
                _ptr(L), _ptr(rinv), _ptr(B), _ptr(X), L.shape[0],
                L.shape[1] - 1, B.shape[1], _stream(L))
    return X


def band_fwd_solve_gated_plain(gate, L, rinv, B, X):
    """Plain version of band_fwd_solve_gated (reads the gate on the
    host)."""
    if bool(gate):
        X.copy_(band_fwd_solve_plain(L, rinv, B))
    return X


def band_fwd_solve_gated(gate, L, rinv, B, X):
    """X, overwritten in place with L^{-1} B where the 0-d bool tensor
    `gate` is set and kept where it is clear: K1's re-solve of Y where it
    clamped a pivot (band_arrow.BandArrowEngine.factor). On a card K2's
    kernel reads the gate on the device, so no host read waits on the
    factor, and on a clear gate every block returns at once."""
    _check_factor(L, rinv)
    _check_rhs(L, B)
    _check(X, "X", 2)
    if X.shape != B.shape:
        raise ValueError("X must have the shape of B")
    if gate.dtype != torch.bool or gate.dim() != 0:
        raise TypeError("gate must be a 0-d bool tensor")
    if not _on_cuda(L, rinv, B, X, gate):
        return band_fwd_solve_gated_plain(gate, L, rinv, B, X)
    with _device(L):
        _launch("band_fwd_solve", _library().bgt_band_fwd_solve_gated,
                _ptr(L), _ptr(rinv), _ptr(B), _ptr(X), _ptr(gate),
                L.shape[0], L.shape[1] - 1, B.shape[1], _stream(L))
    return X


# -- K3 / K5: backward solves -------------------------------------------------

def band_bwd_solve_plain(L, rinv, B):
    """Plain version of band_bwd_solve and band_bwd_multi: row j is B[j]
    less the products L[j, t] x_{j+t}, farthest-first (t = bw first),
    times rinv[j]."""
    d, W = L.shape
    X = torch.zeros_like(B)
    for j in range(d - 1, -1, -1):
        n = min(d - 1 - j, W - 1)
        prods = X[j + 1:j + 1 + n] * L[j, 1:1 + n, None]
        X[j] = _subtract_in_order(B[j], prods.flip(0)) * rinv[j]
    return X


def _bwd(name, fn_name, plain, L, rinv, B):
    _check_factor(L, rinv)
    _check_rhs(L, B)
    if not _on_cuda(L, rinv, B):
        return plain(L, rinv, B)
    X = torch.empty_like(B)
    with _device(L):
        _launch(name, getattr(_library(), fn_name),
                _ptr(L), _ptr(rinv), _ptr(B), _ptr(X), L.shape[0],
                L.shape[1] - 1, B.shape[1], _stream(L))
    return X


def band_bwd_solve(L, rinv, B):
    """X with L^T X = B, for (d, r) right-hand sides B (the Newton and
    gradient solves)."""
    return _bwd("band_bwd_solve", "bgt_band_bwd_solve",
                band_bwd_solve_plain, L, rinv, B)


def band_bwd_multi(L, rinv, Z):
    """X with L^T X = Z for the (d, M) noise of M posterior draws:
    band_bwd_solve's function and kernels, counted as its own entry."""
    return _bwd("band_bwd_multi", "bgt_band_bwd_multi",
                band_bwd_solve_plain, L, rinv, Z)


def band_bwd_multi_warps(L, rinv, Z, warps):
    """band_bwd_multi on a card with `warps` draw columns a block of the
    warp kernel (bw > SMALL_BW; 1 .. 2 WS_WARPS), the block shapes timed
    side by side in chip_smoke.py. Not on any fit's path, and not
    counted."""
    _check_factor(L, rinv)
    _check_rhs(L, Z)
    if not _on_cuda(L, rinv, Z):
        raise ValueError("band_bwd_multi_warps times the CUDA kernel: "
                         "its tensors must lie on a card")
    X = torch.empty_like(Z)
    with _device(L):
        err = _library().bgt_band_bwd_multi_warps(
            _ptr(L), _ptr(rinv), _ptr(Z), _ptr(X), L.shape[0],
            L.shape[1] - 1, Z.shape[1], warps, _stream(L))
    if err != 0:
        raise RuntimeError(f"band_bwd_multi_warps: CUDA error {err} at "
                           "launch")
    return X


# -- K4: Takahashi selected inverse -----------------------------------------

def _takahashi_setup(L, rinv):
    """(multipliers, window index) of the plain K4 and K11 for (..., d,
    bw+1) factors: lr[..., j, t-1] = L[j, t] rinv[j], 0 where j + t >= d,
    and win, a (bw, bw) index into the flattened rows j.. of a padded
    (d + bw, bw+1) band with S(j+t, j+o) at j (bw+1) + win[t-1, o-1]
    (entry |t-o| of row j + min(t, o))."""
    d, W = L.shape[-2:]
    t = torch.arange(1, W, device=L.device)
    lr = L[..., 1:] * rinv[..., None]
    lr = torch.where(torch.arange(d, device=L.device)[:, None] + t < d, lr,
                     lr.new_zeros(()))
    win = torch.minimum(t[:, None], t[None, :]) * W + (t[:, None]
                                                       - t[None, :]).abs()
    return lr, win


def band_takahashi_plain(L, rinv):
    """Plain version of band_takahashi, row by row from the last:
    Z[j, o] = 0 - sum_t l_t S(j+t, j+o) for o = 1..bw, then Z[j, 0] =
    rinv_j^2 - sum_t l_t Z[j, t], with l_t = L[j, t] rinv_j and S the
    band of H^{-1} below row j; every sum subtracts its products
    farthest-first (t = bw first, t = 1 last), each rounded, as the
    kernels do."""
    d, W = L.shape
    bw = W - 1
    lr, win = _takahashi_setup(L, rinv)
    Zp = L.new_zeros((d + bw, W))         # rows past d: zero
    flat = Zp.view(-1)
    for j in range(d - 1, -1, -1):
        lj = lr[j]
        acc = L.new_zeros(bw)
        for prod in reversed((lj[:, None] * flat[j * W + win]).unbind(0)):
            acc = acc - prod                  # t = bw first: S(j+t, .)
        Zp[j, 1:] = acc
        zjj = rinv[j] * rinv[j]
        for prod in reversed((lj * acc).unbind(0)):
            zjj = zjj - prod
        Zp[j, 0] = zjj
    return Zp[:d].clone()


def band_takahashi(L, rinv):
    """(d, bw+1) band of H^{-1} (row j, column o = H^{-1}[j+o, j]) from
    the factor of H."""
    _check_factor(L, rinv)
    if not _on_cuda(L, rinv):
        return band_takahashi_plain(L, rinv)
    Z = torch.empty_like(L)
    with _device(L):
        _launch("band_takahashi", _library().bgt_band_takahashi,
                _ptr(L), _ptr(rinv), _ptr(Z), L.shape[0], L.shape[1] - 1,
                _stream(L))
    return Z


class BandOps:
    """The band operations an engine runs, as one table: KERNELS
    dispatches on the device (the kernels on a card), PLAIN always runs
    the plain versions (the comparison engine)."""

    def __init__(self, factor, fwd_solve, fwd_solve_gated, bwd_solve,
                 bwd_multi, takahashi):
        self.factor = factor
        self.fwd_solve = fwd_solve
        self.fwd_solve_gated = fwd_solve_gated
        self.bwd_solve = bwd_solve
        self.bwd_multi = bwd_multi
        self.takahashi = takahashi


KERNELS = BandOps(band_factor, band_fwd_solve, band_fwd_solve_gated,
                  band_bwd_solve, band_bwd_multi, band_takahashi)
PLAIN = BandOps(band_factor_plain, band_fwd_solve_plain,
                band_fwd_solve_gated_plain, band_bwd_solve_plain,
                band_bwd_solve_plain, band_takahashi_plain)
