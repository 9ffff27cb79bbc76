"""JAX's persistent compilation cache for the port's test modules that
compile the JAX package's programs as their references.

Many of those modules compile the same JAX programs: the tiny model's
`init_frozen`, `llama_forward` and `generate`, each JAX `ServingEngine`'s
jitted closures (a new engine jits them again). `jax_compile_cache`, an
autouse module-scope fixture that such a module imports, points JAX at one
cache directory for the worker process while the module runs and restores
JAX's settings after it, so a program compiled
once in the worker is loaded, not compiled, the next time: the same
executable, so no comparison changes. The JAX package's own test modules
run with JAX's settings untouched.

The test below checks that the fixture leaves JAX's settings as it found
them and that a cached program gives the first compile's result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax._src import compilation_cache as _cc

_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
         "jax_persistent_cache_min_entry_size_bytes")


def _settings():
    return {k: getattr(jax.config, k) for k in _KEYS}


def _compile_cache(tmp_path_factory):
    """The worker's cache directory for the module's run (under pytest's
    base temporary directory of this worker); JAX's settings restored after."""
    saved = _settings()
    path = tmp_path_factory.getbasetemp() / "jax_compile_cache"
    path.mkdir(exist_ok=True)
    for k, v in zip(_KEYS, (str(path), 0.0, 0)):
        jax.config.update(k, v)
    _cc.reset_cache()
    yield path
    for k, v in saved.items():
        jax.config.update(k, v)
    _cc.reset_cache()


# autouse: a module that imports it under this name runs with the cache
jax_compile_cache = pytest.fixture(scope="module", autouse=True)(_compile_cache)


def test_cached_programs_give_the_first_compiles_result(tmp_path_factory):
    before = _settings()
    gen = _compile_cache(tmp_path_factory)
    path = next(gen)
    x = jnp.asarray(np.arange(12, dtype=np.float32).reshape(3, 4))
    first = np.asarray(jax.jit(lambda a: jnp.tanh(a) @ a.T + 1.0)(x))
    assert any(path.iterdir())  # the program went into the cache
    again = np.asarray(jax.jit(lambda a: jnp.tanh(a) @ a.T + 1.0)(x))  # a new closure
    np.testing.assert_array_equal(again, first)
    with pytest.raises(StopIteration):
        next(gen)
    assert _settings() == before
