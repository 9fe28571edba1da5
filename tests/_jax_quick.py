"""jax.jit for the port's tests' JAX references: programs that run once or
a few times, compiled with XLA's CPU optimizations off (they cost more
than they save there)."""
import jax
import numpy as np

XLA_QUICK = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}


def quick_jit(fn):
    """jax.jit of fn, compiled with XLA_QUICK at its first call for each
    structure and shape of its arguments."""
    compiled = {}

    def run(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(a), np.result_type(a))
                           for a in leaves))
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(XLA_QUICK)
        return compiled[key](*args)
    return run
