"""The half log-det of a single-IWP Hessian whose Schur tail leaves its
plain Cholesky route, in the port's two band engines and in the JAX
package's FastIWPBackend on CPU f64, with the route each takes.

The design: tests/test_torch_fast_batched.py's jittered-tail check (n =
2000, IWP3 k = 40, Poisson, two responses; a fixed column twice with a
flat prior, so the tail's Schur complement S is singular and its smallest
pivot is rounding). At each theta_IWP every response is taken to its
one-response mode in the port, and the Hessian there is factored by the
port's one-response engine (fast/iwp.py), its replicate engine
(fast/batched.py) and the JAX package's engine (its S = Hd - Y^T Y and
chol_guarded: plain, then jitter, then a diagonal surrogate). The port's
tail is a Gram of residuals (fast/iwp.schur_gram) factored by
chol_jittered, the same escalation.

    python tools/torch_jitter_branch.py          # CPU, ~1 min

It prints one line per (theta, response) and checks nothing.
"""
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from bayesgp_tpu import terms as jterms  # noqa: E402
from bayesgp_tpu.fast.iwp import build_fast_iwp as jbuild_fast_iwp  # noqa
from bayesgp_tpu.model import build as jbuild  # noqa: E402
from bayesgp_torch import terms as tterms  # noqa: E402
from bayesgp_torch.fast.batched import build_batched  # noqa: E402
from bayesgp_torch.fast.iwp import build_fast_iwp  # noqa: E402
from bayesgp_torch.model import build as tbuild  # noqa: E402


def problem(pkg_terms, pkg_build, make, n=2000, k=40, **kw):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 365.0, n))
    ys = rng.poisson(np.exp(1.5 + 0.8 * np.sin(2 * np.pi * x / 90.0)),
                     size=(2, n)).astype(np.float64)
    inst = pkg_terms.build_iwp_term("x", x, order=3, k=k)
    z = rng.normal(size=(n, 1))
    dmf = [np.ones((n, 1)), z, z]
    md = pkg_build.build_model_data([inst], dmf, ys[0], "Poisson",
                                    dense_design=False)
    xf = np.concatenate([inst.X] + dmf, axis=1)
    pt = np.full(xf.shape[1], 0.01)
    pt[-2:] = 0.0
    return make(inst, md, xf, pt, np.zeros_like(pt), inst.x_data, **kw), ys


def jax_half_logdet(jbe, V, t, theta):
    """(half log-det, whether the JAX tail left its plain route)."""
    V, t, th = jnp.asarray(V), jnp.asarray(t), jnp.asarray(theta)
    af, sc, sd = jbe.hessian_factor(V, t, th)
    _, _, Hd, _, _ = jbe._assemble_scaled(V, t, th)
    Y = af.Y.reshape(-1, af.Y.shape[-1])
    S = np.asarray(Hd - Y.T @ Y)
    plain = bool(np.all(np.isfinite(np.diag(np.asarray(
        jnp.linalg.cholesky(jnp.asarray(S)))))))
    return float(jbe.half_logdet_H((af, sc, sd))), not plain


def main():
    torch.set_num_threads(1)
    base, ys = problem(tterms, tbuild, build_fast_iwp, device="cpu")
    jbase, _ = problem(jterms, jbuild, jbuild_fast_iwp)
    tb = build_batched(base, ys)
    for t_iwp in (0.0, 10.0, 30.0):
        th = torch.tensor([t_iwp], dtype=torch.float64)
        states = [base.with_y(y).laplace_nll(th)[1] for y in ys]
        V, tail = (torch.stack(a) for a in zip(*states))
        fb = tb.hessian_factor(V, tail, th.expand(2).contiguous())
        hb = tb.half_logdet_H(fb).numpy()
        for r, y in enumerate(ys):
            br = base.with_y(y)
            f = br.hessian_factor(*states[r], th)
            h1 = float(br.half_logdet_H(f))
            jbe = jbase.with_y(y)
            hj, jleft = jax_half_logdet(jbe, states[r][0].numpy(),
                                        states[r][1].numpy(), [t_iwp])
            print(f"theta_IWP {t_iwp:g} response {r}: one-response "
                  f"{h1:.9f} (jitter {bool(f[0].tail_left)}), replicate "
                  f"{float(hb[r]):.9f} (jitter "
                  f"{bool(fb[0].tail_left[r])}), JAX CPU-f64 {hj:.9f} "
                  f"(left its plain route {jleft}); port - JAX "
                  f"{h1 - hj:.6f}", flush=True)


if __name__ == "__main__":
    main()
