"""Predictive-SD ("PSD") prior elicitation helpers.

Reference: prior_conversion_IWP (R/01_utility.R:449-453),
compute_d_step_sGPsd (R/01_utility.R:460-462),
prior_conversion_sGP (R/01_utility.R:473-480).
"""
from __future__ import annotations

import math


def prior_conversion_iwp(d: float, prior: dict, p: int) -> dict:
    """Map a prior on the d-step predictive SD to a prior on sigma (IWP_p)."""
    Cp = (d ** (2 * p - 1)) / ((2 * p - 1) * math.factorial(p - 1) ** 2)
    return {"alpha": prior["alpha"], "u": prior["u"] / math.sqrt(Cp)}


def compute_d_step_sgp_sd(d: float, a: float) -> float:
    """sqrt((1/a^2)(d/2 - sin(2 a d)/(4 a))) correction factor."""
    return math.sqrt((1.0 / a ** 2) * (d / 2.0 - math.sin(2 * a * d) / (4 * a)))


def prior_conversion_sgp(d: float, prior: dict, a: float, m: int = 1) -> dict:
    """Map a prior on the d-step predictive SD to a prior on sigma (sGP)."""
    correction = sum(compute_d_step_sgp_sd(d, i * a) for i in range(1, m + 1))
    return {"u": prior["u"] / correction, "alpha": prior["alpha"]}
