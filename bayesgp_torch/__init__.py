"""bayesgp_torch: the PyTorch/CUDA port of the BayesGP AGHQ fit.

Policy: float64 throughout; entry points take `device=`, "cuda" by
default, and raise when no card is present rather than falling back
(pass device="cpu" to run on the CPU). The banded linear algebra runs
hand-written CUDA kernels (csrc/band_kernels.cu) on a card and their
plain PyTorch versions on the CPU; the dense route of small models runs
torch.linalg.

The public names are the JAX package's where their route is ported, so a
user script changes only its import.
"""
from .device import DTYPE, resolve_device
from .api import assemble_model, model_fit
from .formula import parse_formula, parse_f_call, f
from .terms import (build_iwp_term, build_sgp_term, build_iid_term,
                    build_customized_term, normalize_sd_prior)
from .postfit import (FitResult, compute_post_fun_iwp, compute_post_fun_sgp,
                      extract_mean_interval_given_samps)
from .basis.priors import (prior_conversion_iwp, prior_conversion_sgp,
                           compute_d_step_sgp_sd)
from .basis.osplines import (local_poly_helper, global_poly_helper,
                             compute_weights_precision)
from .basis.sgp import (compute_B_sB, compute_B_sB_helper, compute_Q_sB,
                        global_poly_sgp)
from .serialize import save_fit, load_fit
from . import datasets

# reference-cased aliases (BayesGP NAMESPACE:3-23 names)
compute_post_fun_IWP = compute_post_fun_iwp
compute_post_fun_sGP = compute_post_fun_sgp
prior_conversion_IWP = prior_conversion_iwp
prior_conversion_sGP = prior_conversion_sgp
global_poly_helper_sGP = global_poly_sgp
compute_d_step_sGPsd = compute_d_step_sgp_sd


# the reference's function spellings of the post-fit API (NAMESPACE:
# var_density, para_density, post_table, sample_fixed_effect and the
# predict/plot/summary generics), delegating to the FitResult methods
def var_density(fit, *args, **kwargs):
    """Posterior/prior density of an SD parameter (R/03_post_fit.R:
    301-443): FitResult.var_density."""
    return fit.var_density(*args, **kwargs)


def para_density(fit, *args, **kwargs):
    """Densities of all parameters (R/03_post_fit.R:446-467):
    FitResult.para_density."""
    return fit.para_density(*args, **kwargs)


def post_table(fit, *args, **kwargs):
    """Posterior summary table (R/03_post_fit.R:474-531):
    FitResult.post_table."""
    return fit.post_table(*args, **kwargs)


def sample_fixed_effect(fit, variables):
    """Fixed-effect sample rows (R/03_post_fit.R:159-165):
    FitResult.sample_fixed_effect."""
    return fit.sample_fixed_effect(variables)


def predict(fit, *args, **kwargs):
    """Posterior prediction (R/03_post_fit.R:44-125): FitResult.predict."""
    return fit.predict(*args, **kwargs)


def plot(fit, *args, **kwargs):
    """Per-term posterior plot (R/03_post_fit.R:127-151): FitResult.plot."""
    return fit.plot(*args, **kwargs)


def summary(fit):
    """Fit summary (R/03_post_fit.R:1-42): FitResult.summary."""
    return fit.summary()


__all__ = [
    "DTYPE", "assemble_model", "resolve_device",
    "model_fit", "parse_formula", "parse_f_call",
    "build_iwp_term", "build_sgp_term", "build_iid_term",
    "build_customized_term", "normalize_sd_prior", "FitResult",
    "compute_post_fun_iwp", "compute_post_fun_sgp",
    "extract_mean_interval_given_samps", "prior_conversion_iwp",
    "prior_conversion_sgp", "compute_d_step_sgp_sd", "local_poly_helper",
    "global_poly_helper", "compute_weights_precision", "compute_B_sB",
    "compute_B_sB_helper", "compute_Q_sB", "global_poly_sgp", "datasets",
    "save_fit", "load_fit",
    "compute_post_fun_IWP", "compute_post_fun_sGP", "prior_conversion_IWP",
    "prior_conversion_sGP", "global_poly_helper_sGP", "compute_d_step_sGPsd",
    "var_density", "para_density", "post_table", "sample_fixed_effect",
    "f", "predict", "plot", "summary",
]
