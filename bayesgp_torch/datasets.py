"""Bundled datasets (converted from the reference's data/*.rda payloads;
reference docs R/data.R:1-25). The .npz files under bayesgp_torch/data/
are byte-for-byte copies of the JAX package's, so this package reads
nothing outside itself.

- covid_canada: 787 rows — Date (days since 1970-01-01), new_deaths, t,
  weekdays1-6, index.
- sim1data: 3596 rows — exposure, eta, prob, case, subject,
  exposure_binned.
"""
from __future__ import annotations

import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def _load(name: str) -> dict:
    with np.load(os.path.join(_DATA_DIR, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def covid_canada() -> dict:
    return _load("covid_canada")


def sim1data() -> dict:
    return _load("sim1data")


# Annual Canadian lynx trappings 1821-1934 (Elton & Nicholson 1942; the
# classic public-domain series shipped as R's `datasets::lynx`). The
# reference's sGP vignette fits it with a ~10-year-period seasonal GP
# (vignettes/BayesGP-sGP.Rmd:72-108) via R's built-in copy; bundled here
# so the same workflow runs self-contained.
_LYNX = np.array([
    269, 321, 585, 871, 1475, 2821, 3928, 5943, 4950, 2577,
    523, 98, 184, 279, 409, 2285, 2685, 3409, 1824, 409,
    151, 45, 68, 213, 546, 1033, 2129, 2536, 957, 361,
    377, 225, 360, 731, 1638, 2725, 2871, 2119, 684, 299,
    236, 245, 552, 1623, 3311, 6721, 4254, 687, 255, 473,
    358, 784, 1594, 1676, 2251, 1426, 756, 299, 201, 229,
    469, 736, 2042, 2811, 4431, 2511, 389, 73, 39, 49,
    59, 188, 377, 1292, 4031, 3495, 587, 105, 153, 387,
    758, 1307, 3465, 6991, 6313, 3794, 1836, 345, 382, 808,
    1388, 2713, 3800, 3091, 2985, 3790, 674, 81, 80, 108,
    229, 399, 1132, 2432, 3574, 2935, 1537, 529, 485, 662,
    1000, 1590, 2657, 3396], dtype=np.float64)


def lynx() -> dict:
    """dict(year (1821..1934), count) — 114 annual observations."""
    return {"year": np.arange(1821, 1935, dtype=np.float64),
            "count": _LYNX.copy()}
