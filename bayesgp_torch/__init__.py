"""bayesgp_torch: the PyTorch/CUDA port of the BayesGP AGHQ fit.

Policy: float64 throughout; entry points take `device=`, "cuda" by
default, and raise when no card is present rather than falling back
(pass device="cpu" to run on the CPU). The banded linear algebra runs
hand-written CUDA kernels (csrc/band_kernels.cu) on a card and their
plain PyTorch versions on the CPU.
"""
from .device import DTYPE, resolve_device
from .api import assemble_model, model_fit
from .postfit import FitResult

__all__ = ["DTYPE", "FitResult", "assemble_model", "model_fit",
           "resolve_device"]
