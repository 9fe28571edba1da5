"""The JAX package's CPU-f64 values that chip_smoke.py holds phases 23-25
to (PARTIAL_JAX): model_fit of CoxPH (BASELINE config 3), of the
case-crossover vignette and of the customized negative binomial, and the
Laplace value of the prior-only model at PRIOR_ONLY_THETA, each the same
call as chip_smoke.partial_cases() makes. The negative binomial's JAX
loglik is the twin of chip_smoke.nb_loglik. Then the port's fits of the
same calls on the CPU, beside them:

    python tools/torch_partial_reference.py      # CPU, ~2 min

It prints PARTIAL_JAX as JSON, each fit's wall time and the port's gaps
from the JAX values, and checks nothing.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.scipy.special import gammaln  # noqa: E402

import bayesgp_tpu as jbg  # noqa: E402
from bayesgp_tpu import api as japi  # noqa: E402
from bayesgp_tpu.inference import laplace as jlap  # noqa: E402
import bayesgp_torch as tbg  # noqa: E402
import chip_smoke  # noqa: E402


def nb_loglik_jax(eta, y, theta):
    """chip_smoke.nb_loglik in JAX."""
    lr = theta[-1]
    r = jnp.exp(lr)
    return jnp.sum(gammaln(y + r) - gammaln(r) - gammaln(y + 1.0) + r * lr
                   + y * eta - (r + y) * jnp.logaddexp(lr, eta))


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def main():
    torch.set_num_threads(max(1, min(8, torch.get_num_threads())))
    jbg.register_family(chip_smoke.NB_FAMILY, nb_loglik_jax, n_theta_extra=1)
    ref, port = {}, {}
    for label, formula, kw in chip_smoke.partial_cases(tbg):
        if label == "prior_only":
            md = japi.assemble_model(formula, engine="dense", **{
                k: v for k, v in kw.items() if k not in ("M", "seed")})["md"]
            th = jnp.asarray([chip_smoke.PRIOR_ONLY_THETA])
            ref[label] = {"nll": float(jlap.laplace_nll(th, md)[0])}
            fit = tbg.model_fit(formula, device="cpu", **kw)
            be = fit.mod.backend
            port[label] = {"nll": float(be.value_and_grad(
                torch.tensor([chip_smoke.PRIOR_ONLY_THETA],
                             dtype=torch.float64), be.init_state())[0])}
            continue
        jfit, jwall = timed(lambda: jbg.model_fit(formula, **kw))
        tfit, twall = timed(lambda: tbg.model_fit(formula, device="cpu",
                                                  **kw))
        ref[label] = {"mode": np.asarray(jfit.mod.mode, float).tolist(),
                      "lognormconst": float(jfit.mod.lognormconst)}
        port[label] = {"mode": np.asarray(tfit.mod.mode, float).tolist(),
                       "lognormconst": float(tfit.mod.lognormconst)}
        print(f"{label}: JAX fit {jwall:.1f} s, port CPU fit {twall:.1f} s",
              flush=True)
    for label in ref:
        gaps = {k: float(np.abs(np.asarray(port[label][k])
                                - np.asarray(ref[label][k])).max())
                for k in ref[label]}
        print(f"{label}: port CPU {json.dumps(port[label])}, gaps {gaps}")
    print("PARTIAL_JAX = " + json.dumps(ref))


if __name__ == "__main__":
    main()
