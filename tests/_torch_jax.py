"""The JAX side of the port's tests: compiled with most of XLA's
optimisation passes off.

The port's tests hold it against the JAX package on small shapes, where
XLA's compile takes most of a JAX oracle's time and its optimisations buy
nothing. A module imports :func:`quick_jax_compiles` (autouse, module
scope) to compile its JAX programs under ``jax_disable_most_optimizations``
while its tests run; the flag is put back after the module, so other
modules' programs compile as they always do. The programs compute the
same functions: every comparison a module makes holds as before.
"""

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)
