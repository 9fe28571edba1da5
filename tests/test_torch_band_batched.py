"""bayesgp_torch batched band kernels K8-K11: each plain version (the CPU
path of its CUDA wrapper) against dense numpy per system, against the
port's one-system plain versions, and against the JAX package's
lane-packed Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances. Against numpy per system (f64 both sides): band of the
Cholesky factor atol 1e-12, half log-det 1e-11, solves 1e-10, band of
the inverse 1e-10. Against the one-system plain versions: equal bit for
bit (the same elementwise arithmetic in the same order). Against the
Pallas kernels at d = 24, bw = 2, NR = 3: factor and solves atol 1e-10
(double-float there, ~2^-48 relative), the band of the inverse atol 3e-5
(f32 there).

Three tests, on purpose: pytest-xdist's file scheduler hands out files in
order of their test counts, and a file of few tests lands at the end of
the queue, where it cannot delay the long files of the JAX package.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from bayesgp_tpu.linalg import band_batched as jbb
from bayesgp_torch.linalg import band_batched as bb
from bayesgp_torch.linalg import band_kernels as bk

from test_torch_band_kernels import _band_of, _dense_band, _spd_band

torch.set_num_threads(1)


def _problems(rng, NR, d, bw):
    """NR SPD band systems: dense (NR, d, d), JAX-layout bands
    (NR, bw+1, d) and the port's (NR, d, bw+1) tensor."""
    As, bands = zip(*(_spd_band(rng, d, bw) for _ in range(NR)))
    As, bands = np.stack(As), np.stack(bands)
    return As, bands, torch.tensor(bands.transpose(0, 2, 1).copy())


def _inverse_band(A, bw):
    return _band_of(np.linalg.inv(A), bw).T


def test_plain_versions_against_numpy_and_argument_checks():
    for d, bw, NR in ((64, 3, 16), (40, 2, 3), (30, 9, 1)):
        _check_against_numpy(d, bw, NR)
    _check_arguments()


def _check_against_numpy(d, bw, NR):
    rng = np.random.default_rng(d + bw + NR)
    As, _, tb = _problems(rng, NR, d, bw)
    L, rinv, hld = bb.band_factor_batched(tb)
    assert L.shape == (NR, d, bw + 1) and rinv.shape == (NR, d)
    assert hld.shape == (NR,)
    Z = bb.band_takahashi_batched(L, rinv).numpy()
    sols = {}
    for m in (1, 4):
        B = rng.normal(size=(NR, d, m))
        sols[m] = (B, bb.band_fwd_solve_batched(L, rinv, torch.tensor(B)),
                   bb.band_bwd_solve_batched(L, rinv, torch.tensor(B)))
    for r in range(NR):
        Lnp = np.linalg.cholesky(As[r])
        np.testing.assert_allclose(_dense_band(L[r].numpy(), bw), Lnp,
                                   atol=1e-12)
        np.testing.assert_allclose(rinv[r].numpy(), 1.0 / np.diag(Lnp),
                                   rtol=1e-13)
        assert abs(float(hld[r]) - np.log(np.diag(Lnp)).sum()) < 1e-11
        for B, y, x in sols.values():
            np.testing.assert_allclose(y[r].numpy(),
                                       np.linalg.solve(Lnp, B[r]),
                                       atol=1e-10)
            np.testing.assert_allclose(x[r].numpy(),
                                       np.linalg.solve(Lnp.T, B[r]),
                                       atol=1e-10)
        mask = np.arange(d)[:, None] + np.arange(bw + 1)[None, :] < d
        np.testing.assert_allclose(np.where(mask, Z[r], 0.0),
                                   _inverse_band(As[r], bw), atol=1e-10)


def test_system_r_equals_one_system_plain_bit_for_bit():
    rng = np.random.default_rng(7)
    d, bw, NR, m = 48, 3, 5, 3
    _, _, tb = _problems(rng, NR, d, bw)
    B = torch.tensor(rng.normal(size=(NR, d, m)))
    L, rinv, hld = bb.band_factor_batched(tb)
    Y = bb.band_fwd_solve_batched(L, rinv, B)
    X = bb.band_bwd_solve_batched(L, rinv, B)
    Z = bb.band_takahashi_batched(L, rinv)
    none = torch.zeros((d, 0), dtype=torch.float64)
    for r in range(NR):
        L1, rinv1, _, hld1 = bk.band_factor(tb[r].contiguous(), none)
        assert torch.equal(L[r], L1) and torch.equal(rinv[r], rinv1)
        assert torch.equal(hld[r], hld1)
        assert torch.equal(Y[r], bk.band_fwd_solve(L1, rinv1,
                                                   B[r].contiguous()))
        assert torch.equal(X[r], bk.band_bwd_solve(L1, rinv1,
                                                   B[r].contiguous()))
        assert torch.equal(Z[r], bk.band_takahashi(L1, rinv1))
    _check_clamp_in_one_slot()


def _check_clamp_in_one_slot():
    """An indefinite band in one slot of a healthy batch: that slot is
    guarded as the one-system factor guards it, and the other slots'
    results are the healthy batch's bit for bit."""
    rng = np.random.default_rng(0)
    d, bw, NR, slot = 64, 3, 4, 2
    _, _, tb = _problems(rng, NR, d, bw)
    bad = tb.clone()
    bad[slot, 10, 0] = -0.8
    bad[slot, 40, 0] = 1e-14
    L0, rinv0, hld0 = bb.band_factor_batched(tb)
    L, rinv, hld = bb.band_factor_batched(bad)
    assert torch.isfinite(L).all() and torch.isfinite(hld).all()
    assert float(L.abs().max()) <= bk.L_CAP
    for r in range(NR):
        if r != slot:
            assert torch.equal(L[r], L0[r]) and torch.equal(hld[r], hld0[r])
    L1, rinv1, _, hld1 = bk.band_factor(
        bad[slot].contiguous(), torch.zeros((d, 0), dtype=torch.float64))
    assert torch.equal(L[slot], L1) and torch.equal(hld[slot], hld1)
    assert not torch.equal(L[slot], L0[slot])
    B = torch.tensor(rng.normal(size=(NR, d, 2)))
    assert torch.isfinite(bb.band_fwd_solve_batched(L, rinv, B)).all()
    assert torch.isfinite(bb.band_bwd_solve_batched(L, rinv, B)).all()


def _pallas_and_port():
    """The JAX package's lane-packed kernels in interpret mode on one tiny
    batch, and the port's plain versions on the same numpy inputs."""
    rng = np.random.default_rng(5)
    d, bw, NR, m = 24, 2, 3, 2
    As, bands, tb = _problems(rng, NR, d, bw)
    B = rng.normal(size=(NR, d, m))
    G = jbb.group_size(bw)
    bh, bl = jbb.pack_band_batched(jnp.asarray(bands), d, bw, G)
    Lh, Ll, misc = jbb.bfactor_fn(d, bw, G, interpret=True)(bh, bl)
    rh, rl = jbb.pack_rhs_batched(jnp.asarray(B), d, bw, G)
    W, _ = jbb.plan_rows(d, bw)
    misc = np.asarray(misc, np.float64)
    jx = dict(
        L=np.asarray(jbb.unpack_batched((Lh, Ll), d, bw, G, NR, bw + 1)),
        hld=np.array([0.5 * (misc[0, r * G] + misc[1, r * G])
                      for r in range(NR)]),
        y=np.asarray(jbb.unpack_batched(
            jbb.bfwd_fn(d, bw, G, interpret=True)(Lh, Ll, rh, rl),
            d, bw, G, NR, m)),
        x=np.asarray(jbb.unpack_batched(
            jbb.bbwd_fn(d, bw, G, interpret=True)(Lh, Ll, rh, rl),
            d, bw, G, NR, m)),
        Z=np.asarray(jbb.btakahashi_fn(d, bw, G, interpret=True)(Lh),
                     np.float64)[W:W + d, :NR * G].reshape(d, NR, G)
        .transpose(1, 0, 2)[:, :, :bw + 1])
    L, rinv, hld = bb.band_factor_batched(tb)
    tB = torch.tensor(B)
    port = dict(L=L.numpy(), hld=hld.numpy(),
                y=bb.band_fwd_solve_batched(L, rinv, tB).numpy(),
                x=bb.band_bwd_solve_batched(L, rinv, tB).numpy(),
                Z=bb.band_takahashi_batched(L, rinv).numpy())
    mask = np.arange(d)[:, None] + np.arange(bw + 1)[None, :] < d
    return jx, port, mask


def test_plain_versions_match_pallas_interpret():
    jx, port, mask = _pallas_and_port()
    for key, atol in (("L", 1e-10), ("hld", 1e-10), ("y", 1e-10),
                      ("x", 1e-10), ("Z", 3e-5)):
        a, b = port[key], jx[key]
        if key in ("L", "Z"):
            a, b = np.where(mask, a, 0.0), np.where(mask, b, 0.0)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=key)


def _check_arguments():
    """Wrappers refuse what the kernels do not take."""
    tb = torch.ones((2, 8, 4), dtype=torch.float64)
    L, rinv, _ = bb.band_factor_batched(tb)
    with pytest.raises(TypeError):
        bb.band_factor_batched(tb.float())
    with pytest.raises(ValueError):
        bb.band_factor_batched(tb[0])
    with pytest.raises(ValueError):
        bb.band_fwd_solve_batched(L, rinv[:1].contiguous(),
                                  torch.zeros((2, 8, 1),
                                              dtype=torch.float64))
    with pytest.raises(ValueError):
        bb.band_bwd_solve_batched(L, rinv, torch.zeros((2, 7, 1),
                                                       dtype=torch.float64))
    with pytest.raises(ValueError):
        bb.band_takahashi_batched(L.transpose(1, 2), rinv)
    empty = bb.band_fwd_solve_batched(
        L, rinv, torch.zeros((2, 8, 0), dtype=torch.float64))
    assert empty.shape == (2, 8, 0)
