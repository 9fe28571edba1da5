"""The weights w of the driver prior P = T^T diag(w) T that every fast
engine of bayesgp_torch takes its prior quadratic from, as a sum of
squares sum_i w_i ((T r)_i)^2.

The host builders pass w = diff(knots) to the backend as `prior_w`: on
the single-IWP backend, and on the multi-term banded backend at stride G
of a merged band with 0 on its level and padded columns, or at stride 1
beside a dense tail. `P_band` is held to the JAX package's elsewhere
(test_torch_fast_iwp.py, test_torch_banded.py); here each backend's
T^T diag(prior_w) T is held to its own P_band, and prior_quad and
prior_grad to V^T P V and P V, at 1e-12 relative. `convert` carries w
between backends, and derives it from the driver's knots for a backend
that holds none (the JAX package's).

Port-only and small (no JAX program runs): few cases, so the file queues
behind the long files of the tier-1 run.
"""
import types

import numpy as np
import pytest
import torch

from bayesgp_torch import api as tapi
from bayesgp_torch import convert
from bayesgp_torch.fast import banded as tbanded

torch.set_num_threads(1)

RTOL = 1e-12


def _data(n, levels, clustered, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    g = (np.floor(x * (levels / 10.0)) if clustered
         else rng.integers(0, levels, n)).astype(float)
    u = 0.3 * rng.normal(size=levels)
    y = rng.poisson(np.exp(1.0 + 0.5 * np.sin(x) + u[g.astype(int)]))
    return {"x": x, "g": g, "y": y.astype(float)}


# (formula, data): one IWP smooth; a smooth with 600 levels clustered in
# x, which merge into the band (more than IID_LAZY_MIN_LEVELS, kept
# lazy); a smooth with 5 scattered levels in a dense tail
TWO_TERMS = "y ~ f(x, model='IWP', order=2, k={k}) + f(g, model='IID')"
MODELS = {
    "single_iwp": ("y ~ f(x, model='IWP', order=3, k=30)",
                   dict(n=300, levels=1, clustered=True)),
    "merged_iid": (TWO_TERMS.format(k=20),
                   dict(n=1800, levels=600, clustered=True)),
    "tail_term": (TWO_TERMS.format(k=15),
                  dict(n=200, levels=5, clustered=False)),
}


def _backend(name):
    formula, kw = MODELS[name]
    asm = tapi.assemble_model(formula, data=_data(**kw), family="Poisson",
                              engine="banded")
    return tapi._backend(asm, "banded", torch.device("cpu"))


def _dense_T(be):
    Td = be.Tdiags.numpy()
    T = np.diag(Td[0])
    for o in range(1, Td.shape[0]):
        T += np.diag(Td[o, o:], -o)
    return T


def _dense_P(be):
    Pb, d = be.P_band.numpy(), be.d
    P = np.diag(Pb[0])
    for o in range(1, Pb.shape[0]):
        P += np.diag(Pb[o, :d - o], -o) + np.diag(Pb[o, :d - o], o)
    return P


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prior_weights_rebuild_the_prior_band(name):
    be = _backend(name)
    w = be.prior_w.numpy()
    knots = np.asarray(be.term.knots, np.float64)
    G = getattr(be, "G", 1)
    d_drv = getattr(be, "d_drv", be.d)
    assert w.shape == (be.d,)
    np.testing.assert_array_equal(w[np.arange(d_drv) * G], np.diff(knots))
    off = np.ones(be.d, bool)
    off[np.arange(d_drv) * G] = False
    assert not w[off].any()
    if name == "merged_iid":
        assert isinstance(be, tbanded.BandedBackend) and G > 1 and off.any()
    T, P = _dense_T(be), _dense_P(be)
    scale = np.abs(P).max()
    np.testing.assert_allclose(T.T @ (w[:, None] * T), P, rtol=0,
                               atol=RTOL * scale)
    rng = np.random.default_rng(1)
    V = rng.normal(size=(3, be.d))
    quad = be.prior_quad(torch.tensor(V)).numpy()
    np.testing.assert_allclose(quad, np.einsum("ri,ij,rj->r", V, P, V),
                               rtol=RTOL)
    assert np.all(quad >= 0.0)
    grad = be.prior_grad(torch.tensor(V)).numpy()
    assert np.all(np.abs(grad - V @ P) <= RTOL * (np.abs(V) @ np.abs(P)))


def test_convert_carries_the_prior_weights():
    for name, to_arrays, from_arrays in (
            ("single_iwp", convert.fast_iwp_arrays,
             convert.fast_iwp_from_arrays),
            ("merged_iid", convert.banded_arrays,
             convert.banded_from_arrays)):
        be = _backend(name)
        arrs = to_arrays(be)
        np.testing.assert_array_equal(arrs["prior_w"], be.prior_w.numpy())
        be2 = from_arrays(arrs, device="cpu")
        np.testing.assert_array_equal(be2.prior_w.numpy(),
                                      be.prior_w.numpy())
        # a backend without prior_w (the JAX package's): from the knots,
        # its own term's or given
        bare = types.SimpleNamespace(
            d=be.d, G=getattr(be, "G", 1), d_drv=getattr(be, "d_drv", be.d),
            term=be.term)
        np.testing.assert_array_equal(convert.driver_prior_w(bare),
                                      be.prior_w.numpy())
        bare.term = None
        np.testing.assert_array_equal(
            convert.driver_prior_w(bare, knots=be.term.knots),
            be.prior_w.numpy())
