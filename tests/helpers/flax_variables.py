"""Seeded variables for a flax module without running its initialisers.

``random_variables(module, *args, seed=s)`` traces ``module.init`` for the
variables' shapes only (``jax.eval_shape``, nothing compiled) and fills
them from numpy: kernels normal with std 1 / sqrt(fan-in), biases and
batch means normal(0.1), norm scales 1 + normal(0.1), batch variances
uniform in [1, 1.2], the ICNN's ``wz_*`` normal(0.05). The parity tests
hold the port against JAX on such weights; compiling flax's truncated-normal
initialisers costs a second or more a module on the CPU.

``fast_jit(f)`` is ``jax.jit`` with XLA's CPU backend at its cheapest
optimisation level: the parity tests run each JAX reference once, on small
inputs, so compiling it costs far more than running it (about half of the
compile time goes).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np


FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def fast_jit(f, **kw):
    return jax.jit(f, compiler_options=FAST_COMPILE, **kw)


def random_variables(module, *args, seed=0):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(s.shape) / math.sqrt(math.prod(s.shape[:-1]))
        elif name in ("bias", "mean"):
            v = 0.1 * rng.standard_normal(s.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "var":
            v = rng.uniform(1.0, 1.2, s.shape)
        elif name.startswith("wz"):
            v = 0.05 * rng.standard_normal(s.shape)
        else:
            raise ValueError(f"no rule for flax variable {name!r}")
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)
