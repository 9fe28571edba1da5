"""bayesgp_torch replicate fits end to end: replicate_fits_packed (R fits
in lock step on the batched backend) against the JAX package's
replicate_fits_packed on its CPU engine, and against the port's own
sequential replicate_fits, on the same numpy responses.

Tolerances: against the JAX package (R = 3, n = 160, k = 10, AGHQ k = 3)
modes 2e-5 and lognormconsts 1e-5; packed against sequential in the port
(R = 5 in groups of 2, so grouping and padding run) modes and
lognormconsts 2e-5, the JAX package's own bound for that pair. Both are
optimizer tolerances: the outer secant-Newton stops at |g/h| < 1e-4.

Three tests, on purpose: pytest-xdist's file scheduler hands out files in
order of their test counts, and a file of few tests lands at the end of
the queue, where it cannot delay the long files of the JAX package.
"""
import numpy as np
import pytest
import torch

from bayesgp_tpu.parallel.replicates import (
    replicate_fits_packed as jreplicate_fits_packed)
from bayesgp_torch.parallel.replicates import (replicate_fits,
                                               replicate_fits_packed)

from test_torch_fast_batched import replicate_problem

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def poisson3():
    jbase, tbase, ys = replicate_problem("Poisson")
    return (tbase, ys,
            jreplicate_fits_packed(jbase, ys, k=3, force_engine="block_vmap"))


def test_packed_matches_jax_packed(poisson3):
    tbase, ys, (mj, lj) = poisson3
    mt, lt = replicate_fits_packed(tbase, ys, k=3)
    assert mt.shape == (3,) and lt.shape == (3,)
    np.testing.assert_allclose(mt, mj, rtol=0, atol=2e-5)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)
    # on the CPU both engines run the plain versions; a group size of 1
    # runs every replicate as its own batch
    mp, lp = replicate_fits_packed(tbase, ys, k=3, force_engine="plain",
                                   group_size=1)
    np.testing.assert_allclose(mp, mj, rtol=0, atol=2e-5)
    np.testing.assert_allclose(lp, lj, rtol=0, atol=1e-5)


def test_packed_groups_match_sequential():
    for family in ("Poisson", "Binomial"):
        _check_packed_groups_match_sequential(family)


def _check_packed_groups_match_sequential(family):
    _, tbase, ys = replicate_problem(family, n=200, k=10, R=5, seed=11)
    mp, lp = replicate_fits_packed(tbase, ys, k=3, group_size=2)
    ms, ls = replicate_fits(tbase, ys, k=3)
    assert mp.shape == (5,) and np.all(np.isfinite(lp))
    np.testing.assert_allclose(mp, ms, rtol=0, atol=2e-5)
    np.testing.assert_allclose(lp, ls, rtol=0, atol=2e-5)
    # the group boundaries do not matter beyond optimizer tolerance
    m1, l1 = replicate_fits_packed(tbase, ys, k=3)
    np.testing.assert_allclose(m1, mp, rtol=0, atol=2e-5)
    np.testing.assert_allclose(l1, lp, rtol=0, atol=2e-5)


def test_arguments_are_checked(poisson3):
    tbase, ys, _ = poisson3
    for fn in (replicate_fits, replicate_fits_packed):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            fn(tbase, ys, mesh=object())
        with pytest.raises(ValueError, match="responses must be"):
            fn(tbase, ys[:, :-1])
    with pytest.raises(ValueError, match="force_engine"):
        replicate_fits_packed(tbase, ys, force_engine="pallas")
    with pytest.raises(ValueError, match="group_size"):
        replicate_fits_packed(tbase, ys, group_size=0)
