"""bayesgp_torch BandArrowBatchedEngine (NR band + dense-tail systems
factored together) on the CPU against dense numpy, against the port's
one-system BandArrowEngine, and against the JAX package's CPU route for
the replicate engine (fast/batched.BlockVmapEngine), on the same numpy
arrowhead systems.

Tolerances: half log-det and solves 1e-9 against dense numpy; the three
cotangents of the half log-det 1e-10 against the one-system engine per
system (same kernels' plain versions; the small Schur products are
batched there and round differently) and 1e-6 against the JAX block
engine's f64 autodiff; the given-factor variant equals the plain one
bit for bit.

Three tests, on purpose: pytest-xdist's file scheduler hands out files in
order of their test counts, and a file of few tests lands at the end of
the queue, where it cannot delay the long files of the JAX package.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bayesgp_tpu.fast.batched import BlockVmapEngine
from bayesgp_torch.linalg.band_arrow import BandArrowEngine
from bayesgp_torch.linalg.band_arrow_batched import BandArrowBatchedEngine

from test_torch_band_arrow import _arrow_problem

torch.set_num_threads(1)

D, BW, Q, NR, S = 48, 3, 5, 4, 8


@pytest.fixture(scope="module")
def systems():
    rng = np.random.default_rng(3)
    probs = [_arrow_problem(rng, D, BW, Q) for _ in range(NR)]
    bands = np.stack([p[0] for p in probs])             # (NR, bw+1, d)
    Cs = np.stack([p[1] for p in probs])
    Hds = np.stack([p[2] for p in probs])
    Hfull = [p[3] for p in probs]
    targs = (torch.tensor(bands.transpose(0, 2, 1).copy()),
             torch.tensor(Cs), torch.tensor(Hds))
    eng = BandArrowBatchedEngine(D, BW, Q, NR)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    # random cotangents: system r's gradient must scale with ct[r] alone
    ct = torch.tensor(rng.normal(size=NR))
    grads = torch.autograd.grad((ct * eng.arrow_half_logdet(*leaves)).sum(),
                                leaves)
    return dict(bands=bands, Cs=Cs, Hds=Hds, Hfull=Hfull, targs=targs,
                eng=eng, ct=ct, grads=grads, rng=rng)


def test_half_logdet_and_solve_against_dense(systems):
    s = systems
    eng, rng = s["eng"], s["rng"]
    f = eng.factor(*s["targs"])
    hld = eng.half_logdet(f).numpy()
    rb, rd = rng.normal(size=(NR, D)), rng.normal(size=(NR, Q))
    zb, zd = eng.solve(f, torch.tensor(rb), torch.tensor(rd))
    assert zb.shape == (NR, D) and zd.shape == (NR, Q)
    for r in range(NR):
        assert abs(hld[r] - 0.5 * np.linalg.slogdet(s["Hfull"][r])[1]) < 1e-9
        zr = np.linalg.solve(s["Hfull"][r], np.concatenate([rb[r], rd[r]]))
        np.testing.assert_allclose(zb[r].numpy(), zr[:D], atol=1e-9)
        np.testing.assert_allclose(zd[r].numpy(), zr[D:], atol=1e-9)
    _check_no_tail()


def test_cotangents_match_one_system_engine(systems):
    s = systems
    one = BandArrowEngine(D, BW, Q)
    for r in range(NR):
        leaves = [t[r].clone().requires_grad_(True) for t in s["targs"]]
        g1 = torch.autograd.grad(one.arrow_half_logdet(*leaves), leaves)
        for gb, g in zip(s["grads"], g1):
            np.testing.assert_allclose(gb[r].numpy(),
                                       (s["ct"][r] * g).numpy(),
                                       rtol=0, atol=1e-10)
    _check_given_factor_variant_equals_plain(s)


def test_cotangents_match_jax_block_vmap_engine(systems):
    s = systems
    jeng = BlockVmapEngine(D, BW, Q, S)
    ct = jnp.asarray(s["ct"].numpy())
    jargs = (jnp.asarray(s["bands"]), jnp.asarray(s["Cs"]),
             jnp.asarray(s["Hds"]))
    val, gj = jax.jit(jax.value_and_grad(
        lambda *a: jnp.sum(ct * jeng.arrow_half_logdet(*a)),
        argnums=(0, 1, 2)))(*jargs)
    hld = s["eng"].half_logdet(s["eng"].factor(*s["targs"]))
    assert abs(float((s["ct"] * hld).sum()) - float(val)) < 1e-9
    gband = np.asarray(gj[0]).transpose(0, 2, 1)    # JAX bands: (NR, bw+1, d)
    for gt, gb in zip(s["grads"], (gband, gj[1], gj[2])):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gb), rtol=0,
                                   atol=1e-6)


def _check_given_factor_variant_equals_plain(s):
    eng = s["eng"]
    f = eng.factor(*s["targs"])
    leaves = [t.clone().requires_grad_(True) for t in s["targs"]]
    v = eng.arrow_half_logdet_given(*leaves, f)
    assert torch.equal(v.detach(), eng.half_logdet(f))
    assert torch.equal(v.detach(),
                       eng.arrow_half_logdet(*s["targs"]).detach())
    g = torch.autograd.grad((s["ct"] * v).sum(), leaves)
    for a, b in zip(g, s["grads"]):
        assert torch.equal(a, b)


def _check_no_tail():
    rng = np.random.default_rng(4)
    d, bw, nr = 40, 2, 6
    probs = [_arrow_problem(rng, d, bw, 1) for _ in range(nr)]
    bands = torch.tensor(np.stack([p[0].T for p in probs]))
    As = [p[3][:d, :d] for p in probs]
    eng = BandArrowBatchedEngine(d, bw, 0, nr)
    C = torch.zeros((nr, d, 0), dtype=torch.float64)
    Hd = torch.zeros((nr, 0, 0), dtype=torch.float64)
    f = eng.factor(bands, C, Hd)
    hld = eng.half_logdet(f).numpy()
    rb = rng.normal(size=(nr, d))
    zb, zd = eng.solve(f, torch.tensor(rb),
                       torch.zeros((nr, 0), dtype=torch.float64))
    assert zd.shape == (nr, 0)
    for r in range(nr):
        assert abs(hld[r] - 0.5 * np.linalg.slogdet(As[r])[1]) < 1e-10
        np.testing.assert_allclose(zb[r].numpy(),
                                   np.linalg.solve(As[r], rb[r]), atol=1e-9)
    leaf = bands.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(eng.arrow_half_logdet(leaf, C, Hd).sum(), leaf)
    for r in range(nr):
        Hinv = np.linalg.inv(As[r])
        for o in range(bw + 1):
            w = 0.5 if o == 0 else 1.0
            np.testing.assert_allclose(g[r, :d - o, o].numpy(),
                                       w * np.diag(Hinv, -o), atol=1e-9)
