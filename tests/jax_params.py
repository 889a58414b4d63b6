"""The JAX package's parameters for the port's parity tests, drawn once a
process.

`tests/conftest.py` drops JAX's compiled executables at every module
boundary, so a test module that calls `init_params` compiles its random
number generation again: about 2 s for `tiny` on a CPU, paid by each of
the port's modules that holds an engine against JAX's. The draw depends
only on the configuration and the seed, so one process keeps it as numpy
arrays and hands every module a copy of the same tree. The draw stays
the eager one, bit for bit: compiled as one program, a few leaves come
out an ulp off, which moves the JAX search's margins that
`test_torch_beam_search.py` asserts.
"""

import functools

import jax
import numpy as np

from shellac_tpu.models import transformer as jt


@functools.lru_cache(maxsize=None)
def _drawn(cfg, seed: int):
    return jax.tree.map(np.asarray,
                        jt.init_params(cfg, jax.random.PRNGKey(seed)))


def init_params(cfg, seed: int = 0):
    """`jt.init_params(cfg, jax.random.PRNGKey(seed))` as numpy arrays,
    bit for bit: a fresh tree of fresh arrays, which the caller may
    change."""
    return jax.tree.map(np.array, _drawn(cfg, seed))
